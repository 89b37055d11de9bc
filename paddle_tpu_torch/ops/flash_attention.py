"""Flash attention, forward and backward: three hand-written CUDA kernels,
their plain PyTorch versions and the autograd Function that ties them
(counterpart of paddle_tpu/ops/pallas/flash_attention.py).

Layout (the JAX package's, kept at every public function): q
``[B, Sq, H, D]``; k and v ``[B, Sk, Hk, D]``; out ``[B, Sq, H, D]``.
GQA: query head ``j`` reads kv head ``j // (H // Hk)``.  The logsumexp
``lse`` is ``[B, H, Sq]`` float32 in the scaled domain (``log sum exp(q *
sm_scale . k)``); the JAX package keeps it ``[B*H, 1, Sq]``.

The plain versions repeat the TPU kernels' arithmetic, rounding point for
rounding point: q * sm_scale is rounded to the storage type, scores and
products sum in f32, p is rounded to v's type before the PV product (the
row sum l takes the unrounded p), and ``lse = m + log l``.  The backward
recomputes p from lse, takes ``delta = rowsum(dO * O)`` in f32, rounds p to
dO's type for dV, dS to q's (k's) type for dK (dQ), and uses k * sm_scale
rounded to k's type for dQ; dK and dV are summed over each GQA group.

``attention(q, k, v, causal)`` applies ``FlashAttention``.  On CUDA
tensors its forward launches the forward kernel and its backward the dK/dV
and dQ kernels of ``paddle_tpu_torch/csrc/flash_attention.cu`` (float32,
and bfloat16 at head dim 256, on the CUDA cores; bfloat16 at 64 and 128 on
the tensor cores, the backward pair on ``wgmma`` fed by TMA; every other
multiple of 128 on CUDA-core kernels that walk the head dim in chunks; it
raises on what they do not take); on CPU tensors both run the plain
versions.
``fwd_launch_count``, ``dkdv_launch_count`` and ``dq_launch_count`` count
kernel launches, one per launch.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build

__all__ = ["attention", "FlashAttention", "flash_fwd_reference",
           "flash_bwd_reference", "flash_bwd_dkdv_reference",
           "flash_bwd_dq_reference", "attention_delta", "fwd_launch_count",
           "dkdv_launch_count", "dq_launch_count"]

fwd_launch_count = 0
dkdv_launch_count = 0
dq_launch_count = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _repeat_kv(x, group):
    """[B, S, Hk, D] -> [B, S, Hk * group, D], kv head h serving query
    heads h * group .. h * group + group - 1."""
    if group == 1:
        return x
    b, s, hk, d = x.shape
    return x[:, :, :, None, :].expand(b, s, hk, group, d).reshape(
        b, s, hk * group, d)


def _ref_attention(q, k, v, causal):
    """The O(S^2) oracle in f32 (the JAX package's ``_ref_attention``): a
    causal mask aligned bottom-right when Sq != Sk.  Returns q.dtype."""
    group = q.shape[2] // k.shape[2]
    k, v = _repeat_kv(k, group), _repeat_kv(v, group)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        * (1.0 / math.sqrt(q.shape[-1]))
    if causal:
        ql, kl = scores.shape[-2], scores.shape[-1]
        mask = torch.ones((ql, kl), dtype=torch.bool,
                          device=q.device).tril(kl - ql)
        scores = torch.where(mask, scores, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(q.dtype)


def _round(x, dtype):
    """x (f32) rounded to ``dtype`` and back: a rounding point of the
    kernels."""
    return x.to(dtype).float()


def _scores(q, k, causal):
    """f32 scores of (q * sm_scale rounded to q's type) against k,
    ``[B, H, Sq, Sk]``, -inf above the diagonal under ``causal`` (the
    kernels' top-left mask, key position <= query position)."""
    sm_scale = 1.0 / math.sqrt(q.shape[-1])
    qs = _round(q.float() * sm_scale, q.dtype)
    kf = _repeat_kv(k, q.shape[2] // k.shape[2]).float()
    s = torch.einsum("bqhd,bkhd->bhqk", qs, kf)
    if causal:
        sq, sk = s.shape[-2:]
        keep = torch.arange(sk, device=q.device)[None, :] <= \
            torch.arange(sq, device=q.device)[:, None]
        s = torch.where(keep, s, float("-inf"))
    return s, qs


def flash_fwd_reference(q, k, v, causal):
    """Plain version of the forward kernel: ``(out [B, Sq, H, D] in
    q.dtype, lse [B, H, Sq] f32)``."""
    s, _ = _scores(q, k, causal)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    vf = _repeat_kv(v, q.shape[2] // k.shape[2]).float()
    acc = torch.einsum("bhqk,bkhd->bhqd", _round(p, v.dtype), vf)
    out = (acc / l).permute(0, 2, 1, 3).to(q.dtype)
    return out, (m + torch.log(l))[..., 0]


def attention_delta(out, do):
    """delta = rowsum(dO * O) in f32, ``[B, H, Sq]`` (computed outside
    the kernels, as the JAX package does)."""
    return (do.float() * out).sum(-1).permute(0, 2, 1).contiguous()


def _probs_and_ds(q, k, v, lse, delta, do, causal):
    """Recomputed p and dS = p * (dP - delta), ``[B, H, Sq, Sk]`` f32, and
    the rounded scaled q."""
    s, qs = _scores(q, k, causal)
    p = torch.exp(s - lse[..., None])
    vf = _repeat_kv(v, q.shape[2] // k.shape[2]).float()
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), vf)
    return p, p * (dp - delta[..., None]), qs


def _group_sum(x, hk):
    """[B, Sk, H, D] per query head -> [B, Sk, Hk, D] summed over each
    group of H // Hk consecutive heads."""
    b, s, h, d = x.shape
    return x.reshape(b, s, hk, h // hk, d).sum(3)


def flash_bwd_dkdv_reference(q, k, v, do, lse, delta, causal):
    """Plain version of the dK/dV kernel: ``(dk, dv)`` in k's and v's
    types, ``[B, Sk, Hk, D]``."""
    p, ds, qs = _probs_and_ds(q, k, v, lse, delta, do, causal)
    dv = torch.einsum("bhqk,bqhd->bkhd", _round(p, do.dtype), do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", _round(ds, q.dtype), qs)
    hk = k.shape[2]
    return _group_sum(dk, hk).to(k.dtype), _group_sum(dv, hk).to(v.dtype)


def flash_bwd_dq_reference(q, k, v, do, lse, delta, causal):
    """Plain version of the dQ kernel: dq ``[B, Sq, H, D]`` in q.dtype."""
    _, ds, _ = _probs_and_ds(q, k, v, lse, delta, do, causal)
    sm_scale = 1.0 / math.sqrt(q.shape[-1])
    ks = _repeat_kv(_round(k.float() * sm_scale, k.dtype),
                    q.shape[2] // k.shape[2])
    return torch.einsum("bhqk,bkhd->bqhd", _round(ds, k.dtype),
                        ks).to(q.dtype)


def flash_bwd_reference(q, k, v, out, lse, do, causal):
    """Plain version of the whole backward: ``(dq, dk, dv)``."""
    delta = attention_delta(out, do)
    dk, dv = flash_bwd_dkdv_reference(q, k, v, do, lse, delta, causal)
    return flash_bwd_dq_reference(q, k, v, do, lse, delta, causal), dk, dv


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------

def _check_operands(q, k, v, causal, do=None, lse=None, delta=None):
    """The kernels' contract; raises ValueError on anything they do not
    take."""
    def need(ok, what):
        if not ok:
            raise ValueError(f"flash attention kernel: {what}")

    need(q.dim() == 4 and k.dim() == 4 and v.shape == k.shape,
         f"q must be [B, Sq, H, D] and k, v [B, Sk, Hk, D], got "
         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, D = q.shape
    _, Sk, Hk, Dk = k.shape
    need(k.shape[0] == B and Dk == D, f"k/v batch or head dim differ from "
         f"q's: {tuple(k.shape)} vs {tuple(q.shape)}")
    need(q.dtype in _DTYPES, f"dtype {q.dtype} not in float32/bfloat16")
    need(k.dtype == q.dtype and v.dtype == q.dtype,
         f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    need(D == 64 or (D >= 128 and D % 128 == 0),
         f"head dim {D} is neither 64 nor a multiple of 128")
    need(Hk >= 1 and H % Hk == 0, f"H={H} not a multiple of Hk={Hk}")
    need(Sq >= 1 and Sk >= 1, f"empty sequence (Sq={Sq}, Sk={Sk})")
    need(not causal or Sq == Sk,
         f"causal attention needs Sq == Sk (got {Sq}, {Sk}): the kernels' "
         "mask is aligned top-left")
    named = [("q", q), ("k", k), ("v", v)]
    if do is not None:
        need(do.shape == q.shape and do.dtype == q.dtype,
             f"dout must match q: {do.dtype} {tuple(do.shape)}")
        for name, x in (("lse", lse), ("delta", delta)):
            need(x.dtype == torch.float32 and x.shape == (B, H, Sq),
                 f"{name} must be float32 [{B}, {H}, {Sq}], got {x.dtype} "
                 f"{tuple(x.shape)}")
        named += [("dout", do), ("lse", lse), ("delta", delta)]
    for name, x in named:
        need(x.is_contiguous(), f"{name} must be contiguous")
    devs = {x.device for _, x in named}
    need(len(devs) == 1, f"operands on several devices: {devs}")
    need(q.device.type != "cuda" or not any(
        x.data_ptr() % 16 for _, x in named[:4]),
        "q, k, v and dout must be 16-byte aligned")


def _entry(name, n_ptrs):
    """A C entry of the kernel library, with its argtypes set."""
    fn = getattr(_build.library("flash_attention"), name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 8 + \
            [ctypes.c_float, ctypes.c_void_p]
    return fn


@functools.lru_cache(maxsize=1024)
def _tuned_block_q(epoch, Sq, Sk, D, dtype):
    """The forward's rows a block: one instantiation a (dtype, head dim)
    -- 128 for bf16 at D 64 and 128 (wgmma), 64 elsewhere -- so the tuning
    cache's ``block_q`` (``tune/``, a one-value space at every shape) can
    only confirm it; the C entry picks the instantiation."""
    from ..tune import kernel_config
    kernel_config("flash_attention",
                  {"seq_q": Sq, "seq_k": Sk, "head_dim": D,
                   "dtype": str(dtype).split(".")[-1]})
    return 128 if dtype == torch.bfloat16 and D <= 128 else 64


def _launch(name, ptrs, q, k, causal):
    """Launch one kernel on PyTorch's current stream; raises on CPU
    tensors and on a refused launch (the C entry returns
    ``cudaGetLastError()``, or the error of raising the block's
    shared-memory limit)."""
    from ..tune import config_epoch
    if q.device.type != "cuda":
        raise RuntimeError(
            "the flash attention kernels run on CUDA tensors only; got "
            f"{q.device} (the plain versions serve CPU tensors)")
    B, Sq, H, D = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    _tuned_block_q(config_epoch(), Sq, Sk, D, q.dtype)
    fn = _entry(name, len(ptrs))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*ptrs, B, Sq, Sk, H, Hk, D, int(bool(causal)),
                 _DTYPES[q.dtype], 1.0 / math.sqrt(D), stream)
    if err != 0:
        raise RuntimeError(f"flash attention kernel {name} launch failed: "
                           f"CUDA error {err}")


def _launch_fwd(q, k, v, causal):
    """The forward kernel: ``(out, lse)``."""
    global fwd_launch_count
    _check_operands(q, k, v, causal)
    B, Sq, H, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    _launch("paddle_flash_attention_fwd",
            [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr()], q, k, causal)
    fwd_launch_count += 1
    return out, lse


def _launch_dkdv(q, k, v, do, lse, delta, causal):
    """The dK/dV kernel: ``(dk, dv)``, summed over each GQA group."""
    global dkdv_launch_count
    _check_operands(q, k, v, causal, do, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("paddle_flash_attention_bwd_dkdv",
            [q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr()],
            q, k, causal)
    dkdv_launch_count += 1
    return dk, dv


def _launch_dq(q, k, v, do, lse, delta, causal):
    """The dQ kernel: dq."""
    global dq_launch_count
    _check_operands(q, k, v, causal, do, lse, delta)
    dq = torch.empty_like(q)
    _launch("paddle_flash_attention_bwd_dq",
            [q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dq.data_ptr()], q, k, causal)
    dq_launch_count += 1
    return dq


# ---------------------------------------------------------------------------
# dispatch by device, and the autograd Function
# ---------------------------------------------------------------------------

def _forward(q, k, v, causal):
    """``(out, lse)``: the forward kernel on CUDA tensors, the plain
    version on CPU tensors."""
    if q.device.type == "cuda":
        return _launch_fwd(q, k, v, causal)
    return flash_fwd_reference(q, k, v, causal)


def _backward(q, k, v, out, lse, do, causal):
    """``(dq, dk, dv)``: the dK/dV and dQ kernels on CUDA tensors, the
    plain version on CPU tensors."""
    if q.device.type == "cuda":
        delta = attention_delta(out, do)
        dk, dv = _launch_dkdv(q, k, v, do, lse, delta, causal)
        return _launch_dq(q, k, v, do, lse, delta, causal), dk, dv
    return flash_bwd_reference(q, k, v, out, lse, do, causal)


class FlashAttention(torch.autograd.Function):
    """Counterpart of the JAX package's ``_flash_attention`` custom VJP:
    the forward saves ``(q, k, v, out, lse)``, O(S * D), never the
    scores; the backward recomputes the probabilities from lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = _forward(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, out, lse, do.contiguous(),
                               ctx.causal)
        return dq, dk, dv, None


def attention(q, k, v, causal=True):
    """Flash attention over q ``[B, Sq, H, D]``, k and v ``[B, Sk, Hk,
    D]``; returns ``[B, Sq, H, D]`` in q.dtype, differentiable in q, k and
    v.  CUDA tensors go through the kernels, CPU tensors through the plain
    versions; there is no other fallback.  Causal attention needs Sq ==
    Sk on every device: the kernels' mask is aligned top-left, the JAX
    oracle's bottom-right, and the two differ elsewhere."""
    if causal and q.shape[1] != k.shape[1]:
        raise ValueError(f"causal attention needs Sq == Sk, got "
                         f"{q.shape[1]} and {k.shape[1]}")
    return FlashAttention.apply(q.contiguous(), k.contiguous(),
                                v.contiguous(), bool(causal))
