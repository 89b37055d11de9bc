"""Data types (counterpart of paddle_tpu/core/dtype.py).

One interned ``dtype`` object a type, backed by a torch dtype and, where
numpy has one, a numpy dtype.  numpy has no bfloat16 or float8: those
dtypes carry ``np_dtype = None``, and ``Tensor.numpy()`` returns their
values as float32 (exact).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "dtype", "bool_", "uint8", "int8", "int16", "int32", "int64",
    "float16", "bfloat16", "float32", "float64", "complex64", "complex128",
    "float8_e4m3fn", "float8_e5m2",
    "convert_dtype", "to_torch_dtype", "is_floating_point_dtype",
    "is_integer_dtype",
]


class dtype:
    """A framework dtype: thin, interned wrapper over a torch dtype."""

    _registry: dict[str, "dtype"] = {}
    _by_torch: dict = {}

    def __init__(self, name: str, torch_dtype, np_dtype):
        self.name = name
        self.torch_dtype = torch_dtype
        self.np_dtype = None if np_dtype is None else np.dtype(np_dtype)
        dtype._registry[name] = self
        dtype._by_torch[torch_dtype] = self

    def __repr__(self):
        return f"paddle_tpu_torch.{self.name}"

    def __eq__(self, other):
        if isinstance(other, dtype):
            return self.name == other.name
        if isinstance(other, torch.dtype):
            return self.torch_dtype == other
        try:
            return self is convert_dtype(other)
        except TypeError:
            return NotImplemented

    def __hash__(self):
        return hash(self.name)

    @property
    def is_floating_point(self):
        return self.name in ("float16", "bfloat16", "float32", "float64")

    @property
    def is_complex(self):
        return self.name in ("complex64", "complex128")

    @property
    def is_integer(self):
        return self.name in ("bool", "uint8", "int8", "int16", "int32",
                             "int64")

    @property
    def itemsize(self):
        return torch.empty((), dtype=self.torch_dtype).element_size()


bool_ = dtype("bool", torch.bool, np.bool_)
uint8 = dtype("uint8", torch.uint8, np.uint8)
int8 = dtype("int8", torch.int8, np.int8)
int16 = dtype("int16", torch.int16, np.int16)
int32 = dtype("int32", torch.int32, np.int32)
int64 = dtype("int64", torch.int64, np.int64)
float16 = dtype("float16", torch.float16, np.float16)
bfloat16 = dtype("bfloat16", torch.bfloat16, None)
float32 = dtype("float32", torch.float32, np.float32)
float64 = dtype("float64", torch.float64, np.float64)
complex64 = dtype("complex64", torch.complex64, np.complex64)
complex128 = dtype("complex128", torch.complex128, np.complex128)
float8_e4m3fn = dtype("float8_e4m3fn", torch.float8_e4m3fn, None)
float8_e5m2 = dtype("float8_e5m2", torch.float8_e5m2, None)

_ALIASES = {
    "bool": bool_, "float": float32, "double": float64, "half": float16,
    "int": int32, "long": int64, "bfloat": bfloat16,
}


def convert_dtype(d) -> dtype:
    """Normalize any dtype-like (str, numpy dtype, torch dtype, dtype) to
    a dtype."""
    if d is None:
        return None
    if isinstance(d, dtype):
        return d
    if isinstance(d, torch.dtype):
        if d in dtype._by_torch:
            return dtype._by_torch[d]
        raise TypeError(f"Unsupported dtype: {d!r}")
    if isinstance(d, str):
        if d in dtype._registry:
            return dtype._registry[d]
        if d in _ALIASES:
            return _ALIASES[d]
    try:
        name = np.dtype(d).name
    except TypeError:
        raise TypeError(f"Unsupported dtype: {d!r}") from None
    if name in dtype._registry:
        return dtype._registry[name]
    raise TypeError(f"Unsupported dtype: {d!r}")


def to_torch_dtype(d):
    d = convert_dtype(d)
    return None if d is None else d.torch_dtype


def is_floating_point_dtype(d) -> bool:
    return convert_dtype(d).is_floating_point


def is_integer_dtype(d) -> bool:
    return convert_dtype(d).is_integer
