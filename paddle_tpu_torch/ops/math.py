"""Math ops written by hand (counterpart of the ported part of
paddle_tpu/ops/math.py), beside the kernel-driven ones the generator
writes (re-exported here under the JAX package's names)."""
from __future__ import annotations

import builtins

import torch

from ..core import dispatch as D
from ..core.tensor import Tensor
from ._inplace import apply_inplace
from .generated.op_wrappers import (  # noqa: F401
    abs, acos, acosh, add, addmm, all, amax, amin, angle, any, argmax,
    argmin, asin, asinh, atan, atan2, atanh, bitwise_left_shift,
    bitwise_right_shift, bmm, ceil, clip, combinations, conj, copysign, cos,
    cosh, count_nonzero, cummax, cummin, cumprod, cumsum, deg2rad, diagonal,
    diff, digamma, divide, dot, erf, erfinv, exp, expm1, float_power, floor,
    floor_divide, fmax, fmin, frac, gammaln, gcd, heaviside, histogram,
    hypot, i0, i1, imag, inner, isfinite, isinf, isnan, isneginf, isposinf,
    isreal, kron, kthvalue, lcm, ldexp, lerp, lgamma, log, log10, log1p,
    log2, log_normalize, logaddexp, logcumsumexp, logit, logsumexp, matmul,
    max, maximum, mean, median, min, minimum, mm, mod, mode, multiply,
    nan_to_num, nanmean, nanmedian, nanquantile, nansum, neg, nextafter,
    numel, outer, pow, prod, quantile, rad2deg, real, reciprocal,
    reduce_as, remainder, renorm, rot90, round, rsqrt, scale, sgn, sign,
    signbit, sin, sinh, sqrt, square, stanh, std, subtract, sum, take, tan,
    tanh, trace, trunc, vander, var,
)

__all__ = [
    "add", "subtract", "multiply", "divide", "floor_divide", "mod",
    "remainder", "pow", "float_power", "matmul", "dot", "mm", "bmm",
    "inner", "outer", "kron", "scale", "abs", "neg", "exp", "expm1", "log",
    "log2", "log10", "log1p", "sqrt", "rsqrt", "square", "sin", "cos",
    "tan", "asin", "acos", "atan", "sinh", "cosh", "asinh", "acosh",
    "atanh", "atan2", "tanh", "floor", "ceil", "round", "trunc", "frac",
    "sign", "sgn", "reciprocal", "clip", "maximum", "minimum", "fmax",
    "fmin", "sum", "nansum", "mean", "nanmean", "prod", "max", "min",
    "amax", "amin", "argmax", "argmin", "cumsum", "cumprod", "cummax",
    "cummin", "logsumexp", "logcumsumexp", "all", "any", "erf", "erfinv",
    "isnan", "isinf", "isfinite", "nan_to_num", "add_n", "addmm", "lerp",
    "deg2rad", "rad2deg", "gcd", "lcm", "diff", "angle", "conj", "real",
    "imag", "trace", "diagonal", "heaviside", "rot90", "histogram",
    "bincount", "multiply_", "stanh", "logaddexp", "logit", "i0", "i1",
    "digamma", "lgamma", "gammaln", "hypot", "copysign", "ldexp",
    "count_nonzero", "broadcast_shape", "increment", "einsum", "renorm",
    "log_normalize", "reduce_as", "isposinf", "isneginf", "isreal",
    "signbit", "nextafter", "take", "vander", "combinations",
    "bitwise_left_shift", "bitwise_right_shift", "std", "var", "median",
    "nanmedian", "quantile", "nanquantile", "mode", "kthvalue", "numel",
]


def _add_n(*arrs):
    out = arrs[0]
    for a in arrs[1:]:
        out = out + a
    return out


def add_n(inputs, name=None):
    if isinstance(inputs, Tensor):
        return inputs
    return D.apply("add_n", _add_n, tuple(inputs))


def _einsum(*arrs, equation):
    return torch.einsum(equation, *arrs)


def einsum(equation, *operands):
    ops = operands[0] if len(operands) == 1 and \
        isinstance(operands[0], (list, tuple)) else operands
    return D.apply("einsum", _einsum, tuple(ops), {"equation": equation})


def increment(x, value=1.0, name=None):
    return apply_inplace(x, lambda s: add(s, value))


def multiply_(x, y, name=None):
    return apply_inplace(x, lambda s: multiply(s, y))


def _bincount(a, length):
    return torch.zeros(length, dtype=torch.int64, device=a.device) \
        .index_add(0, a.long(), torch.ones_like(a, dtype=torch.int64))


def _bincount_w(a, w, length):
    return torch.zeros(length, dtype=w.dtype, device=a.device) \
        .index_add(0, a.long(), w)


def bincount(x, weights=None, minlength=0, name=None):
    # the output's length is read on the host, as the JAX package does
    D.check_host_read()
    xa = x._data if isinstance(x, Tensor) else torch.as_tensor(x)
    length = builtins.max(int(xa.max()) + 1 if xa.numel() else 0,
                          int(minlength))
    if weights is None:
        return D.apply("bincount", _bincount, (x,), {"length": length})
    return D.apply("bincount_w", _bincount_w, (x, weights),
                   {"length": length})


def broadcast_shape(x_shape, y_shape):
    return list(torch.broadcast_shapes(tuple(x_shape), tuple(y_shape)))
