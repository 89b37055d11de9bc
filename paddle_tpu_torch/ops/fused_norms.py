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
"""
from __future__ import annotations

import ctypes

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


def _launch(entry, x, vectors, eps):
    """Launch one entry on PyTorch's current stream; raises on CPU tensors
    and on a refused launch (the C entry returns ``cudaGetLastError()``)."""
    if x.device.type != "cuda":
        raise RuntimeError(
            "the fused norm kernel runs on CUDA tensors only; got "
            f"{x.device} (the plain versions serve CPU tensors)")
    fn = getattr(_build.library("fused_norms"), entry)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * (2 + len(vectors)) + \
            [ctypes.c_int] * (3 + len(vectors)) + [ctypes.c_float,
                                                   ctypes.c_void_p]
    H = x.shape[-1]
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), *[v.data_ptr() for v in vectors],
                 y.data_ptr(), x.numel() // H, H, _DTYPES[x.dtype],
                 *[_DTYPES[v.dtype] for v in vectors], float(eps), stream)
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
