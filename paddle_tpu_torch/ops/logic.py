"""Comparison / logical ops (counterpart of paddle_tpu/ops/logic.py): the
predicates here, the kernel-driven comparisons from the generated
wrappers."""
from __future__ import annotations

from ..core.tensor import Tensor
from .generated.op_wrappers import (  # noqa: F401
    allclose, bitwise_and, bitwise_not, bitwise_or, bitwise_xor, equal,
    equal_all, greater_equal, greater_than, isclose, isfinite, isinf,
    isnan, less_equal, less_than, logical_and, logical_not, logical_or,
    logical_xor, not_equal,
)

__all__ = [
    "equal", "not_equal", "less_than", "less_equal", "greater_than",
    "greater_equal", "logical_and", "logical_or", "logical_not",
    "logical_xor", "bitwise_and", "bitwise_or", "bitwise_not",
    "bitwise_xor", "bitwise_invert", "isclose", "allclose", "equal_all",
    "is_tensor", "is_empty", "is_complex", "is_floating_point", "is_integer",
]

bitwise_invert = bitwise_not


def is_tensor(x):
    return isinstance(x, Tensor)


def is_empty(x, name=None):
    from .creation import full
    return full([], x.size == 0, "bool")


def is_complex(x):
    return x.dtype.is_complex


def is_floating_point(x):
    return x.dtype.is_floating_point


def is_integer(x):
    return x.dtype.is_integer
