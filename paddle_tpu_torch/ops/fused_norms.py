"""Fused RMSNorm / LayerNorm forward: the hand-written CUDA kernel, its
plain PyTorch versions and the autograd Functions that tie them
(counterpart of paddle_tpu/ops/pallas/fused_norms.py).

x is normalised over its last axis, as ``[R, H]`` rows, in f32, and the
result is written in x's dtype; the weight and bias may be float32 or
bfloat16 apart from x's dtype (f32 master weights against bf16
activations).  ``rms_ref`` and ``ln_ref`` are the JAX package's
``_rms_ref`` / ``_ln_ref`` term for term; they are the plain versions the
kernel is held to.

``rms_norm`` and ``layer_norm`` apply ``RmsNorm`` / ``LayerNorm``.  On CUDA
tensors the forward launches the kernel of
``paddle_tpu_torch/csrc/fused_norms.cu`` (and raises on an operand outside
its contract: ``supports``' shapes, f32/bf16 operands, contiguous,
16-byte aligned); on CPU tensors it computes the plain version.  The
backward is autograd of the plain version, as the JAX package's
``_rms_bwd`` / ``_ln_bwd`` take the VJP of ``_rms_ref`` / ``_ln_ref``.
``rms_launch_count`` and ``ln_launch_count`` count kernel launches.

``_norm_plan`` (cached by shape and types) sizes the launch on the host:
the row walk's team width, teams a block, ring stages, grid and shared
bytes, or, for rows wider than a shared-memory slot, the one-block-a-row
kernel.  The team width and the stages come from the tuning cache where
it has an entry for the shape (``tune/``), else from the plan's rule.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build

__all__ = ["rms_ref", "ln_ref", "supports", "rms_norm", "layer_norm",
           "RmsNorm", "LayerNorm", "rms_launch_count", "ln_launch_count"]

rms_launch_count = 0
ln_launch_count = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def rms_ref(x, w, eps):
    """RMSNorm in f32, cast to x's dtype (the JAX ``_rms_ref``)."""
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + eps)
    return (y * w.float()).to(x.dtype)


def ln_ref(x, w, b, eps):
    """Two-pass LayerNorm in f32, cast to x's dtype (the JAX ``_ln_ref``)."""
    xf = x.float()
    mu = torch.mean(xf, -1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, -1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(x.dtype)


def supports(shape, dtype, w_dtype=None) -> bool:
    """The JAX package's ``_supports`` (without its TPU-backend check and
    lowering probe): x float32 or bfloat16, H = shape[-1] a multiple of
    128, the rows a multiple of 8 (the JAX rule's row-block pick, a power
    of two from 8 dividing the rows, then always exists).  The weight (and
    bias) must be float32 or bfloat16 too, x's dtype or not.  Where it
    holds, the fused ops take the kernel."""
    if dtype not in _DTYPES or (w_dtype is not None and w_dtype not in
                                _DTYPES):
        return False
    H = shape[-1]
    rows = 1
    for s in shape[:-1]:
        rows *= s
    return H % 128 == 0 and rows % 8 == 0


def _check_operands(x, vectors, kind):
    """The kernel's contract; raises ValueError on anything it does not
    take."""
    def need(ok, what):
        if not ok:
            raise ValueError(f"fused {kind} kernel: {what}")

    need(x.dim() >= 1 and supports(x.shape, x.dtype),
         f"x {x.dtype} {tuple(x.shape)} outside the rule (float32 or "
         "bfloat16, last axis a multiple of 128, rows a multiple of 8)")
    H = x.shape[-1]
    for name, v in vectors:
        need(v.dtype in _DTYPES and v.shape == (H,),
             f"{name} must be float32 or bfloat16 [{H}], got {v.dtype} "
             f"{tuple(v.shape)}")
    named = [("x", x), *vectors]
    for name, v in named:
        need(v.is_contiguous(), f"{name} must be contiguous")
    devs = {v.device for _, v in named}
    need(len(devs) == 1, f"operands on several devices: {devs}")
    need(x.device.type != "cuda" or not any(v.data_ptr() % 16
                                            for _, v in named),
         "operands must be 16-byte aligned")


# the card's limits the plan sizes against (sm_90): a block's dynamic
# shared memory, an SM's (each resident block also takes 1 KB), its threads
# and registers
SMEM_BLOCK = 232_448
SMEM_SM = 233_472
_SM_THREADS = 2048
_SM_REGS = 65_536
# the walk kernel (csrc/fused_norms.cu): threads a block, registers a
# thread (``__launch_bounds__(256, 4)``), shared bytes before the ring,
# teams * stages at most, stages at most
WALK_THREADS = 256
_WALK_REGS = 64
WALK_HEAD = 1024
_MAX_SLOTS = 64
MAX_STAGES = 4
# warps an SM the team width aims at: at few rows each row is split over
# up to 8 warps until about this many run on every SM
_WARPS_SM = 16
# row bytes an SM keeps in flight beyond which more slots buy nothing and
# more teams (warps working) come first
_INFLIGHT_SM = 65_536
_ROW_THREADS = 512

_PATHS = {"row": 0, "walk_global": 1, "walk": 2}


class NormPlan(NamedTuple):
    """One launch.  ``path``: ``"walk"`` (the row walk, the weight and
    bias staged in shared memory once a block), ``"walk_global"`` (the
    walk, the vectors read from device memory where slots and vectors do
    not fit one block together) or ``"row"`` (one block a row, for rows
    wider than a slot).  The walk's blocks hold ``threads // (32 *
    team_warps)`` teams of ``team_warps`` warps, each a ring of ``stages``
    row slots; ``grid`` blocks, ``smem`` dynamic shared bytes a block."""
    path: str
    threads: int
    team_warps: int
    stages: int
    grid: int
    smem: int

    @property
    def teams(self) -> int:
        return self.threads // (32 * self.team_warps) if self.team_warps \
            else 1

    @property
    def rows_a_block(self) -> int:
        """Rows a block holds at once (the JAX tuner's ``block_r``)."""
        return self.teams * self.stages if self.team_warps else 1


def _size(dtype) -> int:
    return 4 if dtype == torch.float32 else 2


@functools.lru_cache(maxsize=1024)
def _norm_plan(R, H, x_dtype, w_dtype, kind, b_dtype=None, sms=132,
               team_warps=None, stages=None):
    """The launch for ``R`` rows of ``H`` (``kind`` ``"rms"`` or ``"ln"``)
    on a card of ``sms`` SMs.  ``team_warps`` and ``stages`` (the tuning
    cache's answer; None: the rule below) fix the team width and the ring
    depth, snapped to what the shape allows -- a power of two from 1 to 8
    warps with a vector for every lane, a stage that some row fills, a
    ring that fits shared memory -- and the plan is the rule's where they
    fit nothing.  A row that fits a shared-memory slot takes
    the walk, the weight and bias staged where they fit beside one slot.
    The team width doubles from one warp while every lane keeps two
    vectors or more and the rows an SM holds at once would keep fewer than
    ``_WARPS_SM`` warps busy.  Then, over teams a block and stages, the
    plan that holds the most rows in shared memory at once (up to
    ``_INFLIGHT_SM`` bytes an SM); then one whose teams never wait for a
    row's copy after the first (one row a team, or a second stage in
    flight while a team works); then the most teams, the fewest blocks
    (each copies the vectors) and the fewest stages."""
    R = max(R, 1)                  # no rows: the C entry launches nothing
    xs = _size(x_dtype)
    slot = H * xs
    n_vec = H * xs // 16
    if WALK_HEAD + slot > SMEM_BLOCK:
        return NormPlan("row", min(_ROW_THREADS, -(-n_vec // 32) * 32), 0,
                        0, R, 0)
    vec = H * _size(w_dtype)
    if kind == "ln":
        vec += H * _size(w_dtype if b_dtype is None else b_dtype)
    staged = WALK_HEAD + slot + vec <= SMEM_BLOCK
    fixed = WALK_HEAD + (vec if staged else 0)
    # rows an SM works on at once: its share of R, as far as its shared
    # memory holds them
    rows_sm = min(-(-R // sms), max(1, (SMEM_SM - 1024 - fixed) // slot))
    if team_warps:
        wpr = 1 << (min(int(team_warps), 8).bit_length() - 1)
        while wpr > 1 and n_vec < 32 * wpr:
            wpr //= 2
    else:
        wpr = 1
        while wpr < 8 and n_vec >= 64 * 2 * wpr and \
                2 * wpr * rows_sm <= _WARPS_SM:
            wpr *= 2
    enough = min(R, sms * max(1, _INFLIGHT_SM // slot))
    best = None
    for teams in range(WALK_THREADS // (32 * wpr), 0, -1):
        threads = teams * wpr * 32
        for st in range(1, MAX_STAGES + 1):
            smem = fixed + teams * st * slot
            if smem > SMEM_BLOCK or teams * st > _MAX_SLOTS:
                break
            per_sm = min(SMEM_SM // (smem + 1024), _SM_THREADS // threads,
                         _SM_REGS // (threads * _WALK_REGS))
            grid = min(-(-R // teams), sms * per_sm)
            rows = -(-R // (grid * teams))     # the most rows a team walks
            if st > rows:
                break                      # a stage that no row fills
            if stages and st != min(int(stages), MAX_STAGES):
                continue
            key = (min(enough, grid * teams * st),
                   st > 1 or rows == 1, min(R, grid * teams), -grid, -st)
            if best is None or key > best[0]:
                best = (key, NormPlan("walk" if staged else "walk_global",
                                      threads, wpr, st, grid, smem))
    if best is None:                       # the asked plan fits nothing
        return _norm_plan(R, H, x_dtype, w_dtype, kind, b_dtype, sms)
    return best[1]


@functools.lru_cache(maxsize=1024)
def _tuned_knobs(epoch, R, H, x_dtype):
    """(team_warps, stages) for one launch shape: the tuning cache's
    answer (the JAX package's shape key; ``epoch`` is
    ``tune.config_epoch()``, so no launch reads a file), or (None, None)
    -- the plan's rule -- without one.  The team width changes the order
    of a row's sums (its lanes split the row differently); the stages do
    not."""
    from ..tune import kernel_config_with_meta
    cfg, meta = kernel_config_with_meta(
        "fused_norms",
        {"rows": R, "hidden": H, "dtype": str(x_dtype).split(".")[-1]})
    if meta["source"] == "default":
        return None, None
    return cfg.get("team_warps"), cfg.get("stages")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    """The SMs of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch(entry, x, vectors, eps):
    """Launch one entry on PyTorch's current stream with its plan; raises
    on CPU tensors and on a refused launch (the C entry returns
    ``cudaGetLastError()``)."""
    if x.device.type != "cuda":
        raise RuntimeError(
            "the fused norm kernel runs on CUDA tensors only; got "
            f"{x.device} (the plain versions serve CPU tensors)")
    fn = getattr(_build.library("fused_norms"), entry)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * (2 + len(vectors)) + \
            [ctypes.c_int] * (3 + len(vectors)) + [ctypes.c_float] + \
            [ctypes.c_int] * 6 + [ctypes.c_void_p]
    from ..tune import config_epoch
    H = x.shape[-1]
    R = x.numel() // H
    plan = _norm_plan(R, H, x.dtype, vectors[0].dtype,
                      "ln" if len(vectors) == 2 else "rms",
                      vectors[-1].dtype, _sm_count(x.device.index),
                      *_tuned_knobs(config_epoch(), R, H, x.dtype))
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), *[v.data_ptr() for v in vectors],
                 y.data_ptr(), R, H, _DTYPES[x.dtype],
                 *[_DTYPES[v.dtype] for v in vectors], float(eps),
                 _PATHS[plan.path], plan.threads, plan.team_warps,
                 plan.stages, plan.grid, plan.smem, stream)
    if err != 0:
        raise RuntimeError(f"fused norm kernel {entry} launch failed: "
                           f"CUDA error {err}")
    return y


def _launch_rms(x, w, eps):
    """The kernel's RMSNorm entry: ``rms_ref(x, w, eps)`` on the card."""
    global rms_launch_count
    _check_operands(x, [("weight", w)], "rms_norm")
    y = _launch("paddle_fused_rms_norm", x, (w,), eps)
    rms_launch_count += 1
    return y


def _launch_ln(x, w, b, eps):
    """The kernel's LayerNorm entry: ``ln_ref(x, w, b, eps)`` on the
    card."""
    global ln_launch_count
    _check_operands(x, [("weight", w), ("bias", b)], "layer_norm")
    y = _launch("paddle_fused_layer_norm", x, (w, b), eps)
    ln_launch_count += 1
    return y


def _rms_forward(x, w, eps):
    """The kernel on CUDA tensors, the plain version on CPU tensors."""
    if x.device.type == "cuda":
        return _launch_rms(x, w, eps)
    return rms_ref(x, w, eps)


def _ln_forward(x, w, b, eps):
    if x.device.type == "cuda":
        return _launch_ln(x, w, b, eps)
    return ln_ref(x, w, b, eps)


def _vjp(fn, inputs, needs, g):
    """Gradients of ``fn`` at ``inputs`` against ``g``: autograd of the
    plain version, the JAX package's ``jax.vjp`` of its ref."""
    with torch.enable_grad():
        xs = [t.detach().requires_grad_(n) for t, n in zip(inputs, needs)]
        y = fn(*xs)
        wrt = [t for t in xs if t.requires_grad]
        got = iter(torch.autograd.grad(y, wrt, g))
    return tuple(next(got) if n else None for n in needs)


class RmsNorm(torch.autograd.Function):
    """Counterpart of the JAX ``_rms_pallas`` custom VJP: the forward is
    the kernel (plain version on the CPU), the backward the VJP of
    ``rms_ref``."""

    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return _rms_forward(x, w, eps)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        eps = ctx.eps
        dx, dw = _vjp(lambda x, w: rms_ref(x, w, eps), (x, w),
                      ctx.needs_input_grad[:2], g)
        return dx, dw, None


class LayerNorm(torch.autograd.Function):
    """Counterpart of the JAX ``_ln_pallas`` custom VJP."""

    @staticmethod
    def forward(ctx, x, w, b, eps):
        ctx.save_for_backward(x, w, b)
        ctx.eps = eps
        return _ln_forward(x, w, b, eps)

    @staticmethod
    def backward(ctx, g):
        x, w, b = ctx.saved_tensors
        eps = ctx.eps
        return _vjp(lambda x, w, b: ln_ref(x, w, b, eps), (x, w, b),
                    ctx.needs_input_grad[:3], g) + (None,)


def rms_norm(x, w, eps):
    """RMSNorm of x over its last axis with weight w, in x's dtype,
    differentiable in x and w."""
    return RmsNorm.apply(x.contiguous(), w.contiguous(), float(eps))


def layer_norm(x, w, b, eps):
    """LayerNorm of x over its last axis with weight w and bias b, in x's
    dtype, differentiable in x, w and b."""
    return LayerNorm.apply(x.contiguous(), w.contiguous(), b.contiguous(),
                           float(eps))
