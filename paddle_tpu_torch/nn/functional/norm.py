"""Normalization functionals: layer_norm, rms_norm, batch_norm
(counterpart of the ported part of paddle_tpu/nn/functional/norm.py).

These are the JAX package's compositions (its Pallas norm kernel is
reached through ``incubate.nn.functional.fused_rms_norm`` /
``fused_layer_norm``, as here).  BatchNorm's running statistics are updated in place, so a captured CUDA
graph updates the same buffers every replay.
"""
from __future__ import annotations

import torch

from ...core import dispatch as D

__all__ = ["layer_norm", "rms_norm", "batch_norm"]


def _ln(a, *wb, n_axes, eps, has_w, has_b):
    dims = tuple(range(a.dim() - n_axes, a.dim()))
    af = a.float() if a.dtype in (torch.float16, torch.bfloat16) else a
    mean = torch.mean(af, dim=dims, keepdim=True)
    var = torch.mean(torch.square(af - mean), dim=dims, keepdim=True)
    out = (af - mean) * torch.rsqrt(var + eps)
    i = 0
    if has_w:
        out = out * wb[i].to(out.dtype)
        i += 1
    if has_b:
        out = out + wb[i].to(out.dtype)
    return out.to(a.dtype)


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-05,
               name=None):
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    n_axes = len(tuple(normalized_shape))
    args = [x] + [t for t in (weight, bias) if t is not None]
    return D.apply("layer_norm", _ln, tuple(args),
                   {"n_axes": n_axes, "eps": float(epsilon),
                    "has_w": weight is not None, "has_b": bias is not None})


def _rms(a, *w, eps, has_w):
    af = a.float() if a.dtype in (torch.float16, torch.bfloat16) else a
    ms = torch.mean(torch.square(af), dim=-1, keepdim=True)
    out = af * torch.rsqrt(ms + eps)
    if has_w:
        out = out * w[0].to(out.dtype)
    return out.to(a.dtype)


def rms_norm(x, weight=None, epsilon=1e-6, name=None):
    args = (x, weight) if weight is not None else (x,)
    return D.apply("rms_norm", _rms, args,
                   {"eps": float(epsilon), "has_w": weight is not None})


def _bn_axes(ndim, data_format):
    ch_axis = 1 if data_format.startswith("NC") else ndim - 1
    return ch_axis, tuple(i for i in range(ndim) if i != ch_axis)


def _affine(out, wb, ch_axis, has_w, has_b):
    shape = [1] * out.dim()
    shape[ch_axis] = out.shape[ch_axis]
    i = 0
    if has_w:
        out = out * wb[i].reshape(shape)
        i += 1
    if has_b:
        out = out + wb[i].reshape(shape)
    return out


def _bn_train(a, *wb, axes, ch_axis, eps, has_w, has_b):
    m = torch.mean(a, dim=axes, keepdim=True)
    v = torch.var(a, dim=axes, keepdim=True, correction=0)
    return _affine((a - m) * torch.rsqrt(v + eps), wb, ch_axis, has_w, has_b)


def _bn_eval(a, rm, rv, *wb, ch_axis, eps, has_w, has_b):
    shape = [1] * a.dim()
    shape[ch_axis] = a.shape[ch_axis]
    out = (a - rm.reshape(shape)) * torch.rsqrt(rv.reshape(shape) + eps)
    return _affine(out, wb, ch_axis, has_w, has_b)


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-05,
               data_format="NCHW", use_global_stats=None, name=None):
    ch_axis, axes = _bn_axes(x.ndim, data_format)
    wb = tuple(t for t in (weight, bias) if t is not None)
    flags = {"ch_axis": ch_axis, "eps": float(epsilon),
             "has_w": weight is not None, "has_b": bias is not None}
    if training and not use_global_stats:
        if running_mean is not None:
            with torch.no_grad():
                a = x._data
                bm = torch.mean(a, dim=axes)
                bv = torch.var(a, dim=axes, correction=0)
                rm, rv = running_mean._data, running_var._data
                rm.copy_(momentum * rm + (1.0 - momentum) * bm.to(rm.dtype))
                rv.copy_(momentum * rv + (1.0 - momentum) * bv.to(rv.dtype))
        return D.apply("batch_norm_train", _bn_train, (x,) + wb,
                       dict(flags, axes=axes))
    return D.apply("batch_norm_eval", _bn_eval,
                   (x, running_mean, running_var) + wb, flags)
