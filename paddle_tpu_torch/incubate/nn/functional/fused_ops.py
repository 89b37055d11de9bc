"""Fused-op functional surface of the PyTorch port (counterpart of
paddle_tpu/incubate/nn/functional/fused_ops.py): ``fused_rms_norm``,
``fused_layer_norm``, ``fused_rotary_position_embedding``, ``swiglu``,
``fused_matmul_bias`` and ``fused_linear``, on torch tensors.

The norms route by the JAX package's ``_norm_core`` shape rules (the
port has no lowering probe, and ``FLAGS_use_pallas_kernels`` routes
nothing): RMSNorm takes the fused-norm kernel (``ops.fused_norms``) only
with a weight, LayerNorm only with both weight and bias, and each only
where the shape rule holds (float32/bfloat16 x, last axis a multiple of
128, rows a multiple of 8; the weight's dtype may differ from x's).
Elsewhere they compute the JAX package's compositions.  On CUDA tensors the kernel launches; on CPU
tensors its plain version runs.  The other ops are plain torch, as they
are plain jnp in the JAX package: the products are ``torch.matmul``.

``fused_dropout_add`` and ``fused_bias_dropout_residual_layer_norm`` are
not ported yet (they draw from the JAX package's global random state).
The ``quant_*`` arguments of the norms are accepted and ignored, as in the
JAX package.
"""
from __future__ import annotations

import functools
import inspect

import torch

from ....core import dispatch as _D
from ....core.tensor import Tensor
from ....ops import fused_norms as _fn

__all__ = [
    "fused_rms_norm", "fused_layer_norm", "fused_rotary_position_embedding",
    "swiglu", "fused_matmul_bias", "fused_linear",
]


def _eager(op_name):
    """Run the torch function through the dispatcher when its first
    argument is a ``Tensor``: the other ``Tensor`` arguments become its
    inputs, the rest its attributes."""
    def deco(fn):
        sig = inspect.signature(fn)

        @functools.wraps(fn)
        def wrapper(x, *args, **kwargs):
            if not isinstance(x, Tensor):
                return fn(x, *args, **kwargs)
            bound = sig.bind(x, *args, **kwargs)
            names = list(bound.arguments)
            tensors = [n for n in names
                       if isinstance(bound.arguments[n], Tensor)]
            attrs = {n: bound.arguments[n] for n in names
                     if n not in tensors}

            def run(*datas):
                kw = dict(attrs, **dict(zip(tensors, datas)))
                return fn(**kw)
            return _D.apply(op_name, run,
                            tuple(bound.arguments[n] for n in tensors))
        return wrapper
    return deco


def _check_norm_axis(x, begin_norm_axis):
    """Only the trailing-axis case is supported; other values raise
    rather than normalise the wrong axes."""
    if begin_norm_axis not in (-1, x.dim() - 1):
        raise NotImplementedError(
            f"begin_norm_axis={begin_norm_axis} normalizes over multiple "
            f"dims; only the last axis (begin_norm_axis={x.dim() - 1} or -1) "
            f"is supported")


def _add_bias_residual(x, bias, residual):
    """x [+ bias] [+ residual], in that order."""
    out = x
    if bias is not None:
        out = out + bias
    if residual is not None:
        out = out + residual
    return out


def _norm_core(x, weight, bias, eps, kind):
    """One RMS or layer norm, through the kernel where the JAX package
    would take its Pallas kernel."""
    w_dtype = None if weight is None else weight.dtype
    if kind == "rms":
        if weight is not None and _fn.supports(x.shape, x.dtype, w_dtype):
            return _fn.rms_norm(x, weight, eps)
        w = weight if weight is not None else torch.ones(
            x.shape[-1], dtype=torch.float32, device=x.device)
        return _fn.rms_ref(x, w, eps)
    if weight is not None and bias is not None and \
            _fn.supports(x.shape, x.dtype, w_dtype) and \
            bias.dtype in _fn._DTYPES:
        return _fn.layer_norm(x, weight, bias, eps)
    H = x.shape[-1]
    w = weight if weight is not None else torch.ones(
        H, dtype=torch.float32, device=x.device)
    b = bias if bias is not None else torch.zeros(
        H, dtype=torch.float32, device=x.device)
    return _fn.ln_ref(x, w, b, eps)


@_eager('fused_rms_norm')
def fused_rms_norm(x, norm_weight, norm_bias=None, epsilon=1e-6,
                   begin_norm_axis=-1, bias=None, residual=None,
                   quant_scale=-1, quant_round_type=0, quant_max_bound=0,
                   quant_min_bound=0):
    """y = rms_norm(x [+ bias] [+ residual]) * w [+ norm_bias].  Returns
    ``(out, residual_out)``: the pre-norm sum is the next block's residual
    stream."""
    _check_norm_axis(x, begin_norm_axis)
    residual_out = _add_bias_residual(x, bias, residual)
    out = _norm_core(residual_out, norm_weight, None, epsilon, "rms")
    if norm_bias is not None:
        out = out + norm_bias
    return out, residual_out


@_eager('fused_layer_norm')
def fused_layer_norm(x, norm_weight, norm_bias, epsilon=1e-5,
                     begin_norm_axis=-1, bias=None, residual=None,
                     quant_scale=-1, quant_round_type=0, quant_max_bound=0,
                     quant_min_bound=0):
    """y = layer_norm(x [+ bias] [+ residual]) * w + b; returns ``(out,
    residual_out)``."""
    _check_norm_axis(x, begin_norm_axis)
    residual_out = _add_bias_residual(x, bias, residual)
    out = _norm_core(residual_out, norm_weight, norm_bias, epsilon, "layer")
    return out, residual_out


def _rope_tables(q, sin, cos, position_ids, use_neox, theta):
    """sin and cos, [B or 1, S, 1, D] in f32: from the given tables
    ([1, S, 1, D], [S, D] or a longer [S_max, D], rows gathered at
    ``position_ids`` when given) or computed from ``position_ids`` (or 0 ..
    S - 1) and the base ``theta``."""
    if sin is not None and cos is not None:
        sin, cos = sin.float(), cos.float()
        if sin.dim() == 4:
            sin, cos = sin[:, :, 0, :], cos[:, :, 0, :]
        if sin.dim() == 2:
            sin, cos = sin[None], cos[None]
        if position_ids is not None:
            pos = position_ids.long()
            sin, cos = sin[0][pos], cos[0][pos]
        return sin[:, :, None, :], cos[:, :, None, :]
    S, Dh = q.shape[1], q.shape[3]
    pos = (position_ids.float() if position_ids is not None else
           torch.arange(S, dtype=torch.float32, device=q.device)[None, :])
    inv = theta ** (-torch.arange(0, Dh, 2, dtype=torch.float32,
                                  device=q.device) / Dh)
    freqs = pos[..., None] * inv[None, None, :]
    emb = torch.repeat_interleave(freqs, 2, -1) if use_neox else \
        torch.cat([freqs, freqs], -1)
    return torch.sin(emb)[:, :, None, :], torch.cos(emb)[:, :, None, :]


def _rotate(x, sin, cos, use_neox):
    xf = x.float()
    if use_neox:
        x1, x2 = xf[..., 0::2], xf[..., 1::2]
        rotated = torch.stack([-x2, x1], -1).reshape(xf.shape)
    else:
        half = xf.shape[-1] // 2
        rotated = torch.cat([-xf[..., half:], xf[..., :half]], -1)
    return (xf * cos + rotated * sin).to(x.dtype)


@_eager('fused_rotary_position_embedding')
def fused_rotary_position_embedding(q, k=None, v=None, sin=None, cos=None,
                                    position_ids=None,
                                    use_neox_rotary_style=True,
                                    rotary_emb_base=10000.0, name=None):
    """RoPE on q (and k, v when given), each ``[B, S, H, D]``:
    interleaved pairs (``use_neox_rotary_style=True``, LLaMA's rotary) or
    half-split.  Returns ``(q_out, k_out, v_out)`` with None in place of
    an absent input."""
    sin, cos = _rope_tables(q, sin, cos, position_ids,
                            bool(use_neox_rotary_style),
                            float(rotary_emb_base))
    return tuple(None if t is None else
                 _rotate(t, sin, cos, bool(use_neox_rotary_style))
                 for t in (q, k, v))


@_eager('swiglu')
def swiglu(x, y=None, name=None):
    """silu(x) * y; with y None, x is split in half on the last axis."""
    if y is None:
        x, y = torch.chunk(x, 2, dim=-1)
    return torch.nn.functional.silu(x.float()).to(x.dtype) * y


@_eager('fused_matmul_bias')
def fused_matmul_bias(x, y, bias=None, transpose_x=False, transpose_y=False,
                      name=None):
    """matmul(x, y) [+ bias], either operand optionally transposed on its
    last two axes."""
    a = x.transpose(-1, -2) if transpose_x else x
    b = y.transpose(-1, -2) if transpose_y else y
    out = torch.matmul(a, b)
    return out + bias if bias is not None else out


@_eager('fused_linear')
def fused_linear(x, weight, bias=None, transpose_weight=False, name=None):
    """x @ weight [+ bias] (the fused_gemm_epilogue op)."""
    return fused_matmul_bias(x, weight, bias, False, transpose_weight)
