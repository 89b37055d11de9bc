"""Math ops written by hand (counterpart of the ported part of
paddle_tpu/ops/math.py), beside the kernel-driven ones the generator
writes (re-exported here under the JAX package's names)."""
from __future__ import annotations

import torch

from ..core import dispatch as D
from ..core.tensor import Tensor
from .generated.op_wrappers import (  # noqa: F401
    abs, add, amax, amin, any, all, argmax, argmin, bmm, ceil, clip, cos,
    cumsum, divide, erf, exp, expm1, floor, floor_divide, isfinite, isinf,
    isnan, log, log10, log1p, log2, logsumexp, matmul, max, maximum, mean,
    min, minimum, mod, multiply, neg, pow, prod, reciprocal, round, rsqrt,
    scale, sign, sin, sqrt, square, std, subtract, sum, tan, tanh, trunc,
    var,
)

__all__ = [
    "add", "subtract", "multiply", "divide", "floor_divide", "mod", "pow",
    "matmul", "bmm", "scale", "abs", "neg", "exp", "expm1", "log", "log2",
    "log10", "log1p", "sqrt", "rsqrt", "square", "sin", "cos", "tan", "tanh",
    "floor", "ceil", "round", "trunc", "sign", "reciprocal", "clip",
    "maximum", "minimum", "sum", "mean", "prod", "max", "min", "amax",
    "amin", "argmax", "argmin", "cumsum", "logsumexp", "all", "any", "erf",
    "isnan", "isinf", "isfinite", "std", "var", "add_n", "einsum",
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
