"""Convolution functionals (counterpart of the ported part of
paddle_tpu/nn/functional/conv.py).  The product is
``torch.nn.functional.conv{1,2,3}d``, as the JAX package's is XLA's
``conv_general_dilated`` outside any Pallas kernel; padding takes the JAX
package's forms (an int, one a spatial axis, a (lo, hi) pair an axis, or
'SAME' / 'VALID')."""
from __future__ import annotations

import torch
import torch.nn.functional as _F

from ...core import dispatch as D

__all__ = ["conv1d", "conv2d", "conv3d"]

_CONV = {1: _F.conv1d, 2: _F.conv2d, 3: _F.conv3d}


def _tup(v, n):
    if isinstance(v, int):
        return (v,) * n
    return tuple(int(x) for x in v)


def _padding(padding, n):
    """'SAME' / 'VALID', or one (lo, hi) pair a spatial axis."""
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, int):
        return tuple((padding, padding) for _ in range(n))
    padding = list(padding)
    if len(padding) == n and all(isinstance(p, int) for p in padding):
        return tuple((p, p) for p in padding)
    if len(padding) == 2 * n:
        return tuple((padding[2 * i], padding[2 * i + 1]) for i in range(n))
    flat = [p for p in padding
            if not (isinstance(p, (list, tuple)) and tuple(p) == (0, 0))]
    return tuple(tuple(p) for p in flat)


def _conv(x, w, *b, strides, padding, dilation, groups, nd, channels_last):
    if channels_last:
        x = torch.movedim(x, -1, 1)
    if isinstance(padding, str):
        pad = padding.lower()
    elif all(lo == hi for lo, hi in padding):
        pad = tuple(lo for lo, _ in padding)
    else:
        flat = []
        for lo, hi in reversed(padding):
            flat += [lo, hi]
        x = _F.pad(x, flat)
        pad = 0
    out = _CONV[nd](x, w, b[0] if b else None, strides, pad, dilation,
                    groups)
    return torch.movedim(out, 1, -1) if channels_last else out


def _conv_nd(op_name, nd):
    def op(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format=None, name=None):
        df = data_format or ("NCL" if nd == 1 else
                             "NCHW" if nd == 2 else "NCDHW")
        args = (x, weight) if bias is None else (x, weight, bias)
        return D.apply(op_name, _conv, args,
                       {"strides": _tup(stride, nd),
                        "padding": _padding(padding, nd),
                        "dilation": _tup(dilation, nd),
                        "groups": int(groups), "nd": nd,
                        "channels_last": df.endswith("C")})
    op.__name__ = op_name
    return op


conv1d = _conv_nd("conv1d", 1)
conv2d = _conv_nd("conv2d", 2)
conv3d = _conv_nd("conv3d", 3)
