"""Tensor creation ops (counterpart of paddle_tpu/ops/creation.py).

Factories build on the default place (``paddle_tpu_torch.set_device``),
``*_like`` ops on their input's device; none requires grad at creation.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import dispatch as D
from ..core.dtype import to_torch_dtype
from ..core.place import current_torch_device
from ..core.tensor import Tensor, to_tensor

__all__ = [
    "to_tensor", "zeros", "ones", "full", "empty", "zeros_like", "ones_like",
    "full_like", "empty_like", "arange", "linspace", "eye", "tril", "triu",
    "assign", "clone",
]


def _shape_tuple(shape):
    if isinstance(shape, Tensor):
        shape = shape.tolist()
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(s.item()) if isinstance(s, Tensor) else int(s)
                 for s in shape)


def _dt(dtype, default="float32"):
    return to_torch_dtype(dtype if dtype is not None else default)


def zeros(shape, dtype=None, name=None):
    return Tensor(torch.zeros(_shape_tuple(shape), dtype=_dt(dtype),
                              device=current_torch_device()))


def ones(shape, dtype=None, name=None):
    return Tensor(torch.ones(_shape_tuple(shape), dtype=_dt(dtype),
                             device=current_torch_device()))


def _fill_dtype(fill_value, dtype):
    if dtype is not None:
        return dtype
    if isinstance(fill_value, bool):
        return "bool"
    if isinstance(fill_value, int):
        return "int64"
    return "float32"


def full(shape, fill_value, dtype=None, name=None):
    if isinstance(fill_value, Tensor):
        fill_value = fill_value.item()
    return Tensor(torch.full(_shape_tuple(shape), fill_value,
                             dtype=_dt(_fill_dtype(fill_value, dtype)),
                             device=current_torch_device()))


def empty(shape, dtype=None, name=None):
    return zeros(shape, dtype)


def _like(x, dtype):
    return to_torch_dtype(dtype) if dtype is not None else x._data.dtype


def zeros_like(x, dtype=None, name=None):
    return Tensor(torch.zeros_like(x._data, dtype=_like(x, dtype)))


def ones_like(x, dtype=None, name=None):
    return Tensor(torch.ones_like(x._data, dtype=_like(x, dtype)))


def full_like(x, fill_value, dtype=None, name=None):
    if isinstance(fill_value, Tensor):
        fill_value = fill_value.item()
    return Tensor(torch.full_like(x._data, fill_value,
                                  dtype=_like(x, dtype)))


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype)


def arange(start=0, end=None, step=1, dtype=None, name=None):
    def val(v):
        return v.item() if isinstance(v, Tensor) else v
    start, end, step = val(start), val(end), val(step)
    if end is None:
        start, end = 0, start
    if dtype is None:
        dtype = ("int64" if all(isinstance(v, (int, np.integer))
                                for v in (start, end, step)) else "float32")
    return Tensor(torch.arange(start, end, step, dtype=_dt(dtype),
                               device=current_torch_device()))


def linspace(start, stop, num, dtype=None, name=None):
    def val(v):
        return v.item() if isinstance(v, Tensor) else v
    return Tensor(torch.linspace(val(start), val(stop), int(val(num)),
                                 dtype=_dt(dtype),
                                 device=current_torch_device()))


def eye(num_rows, num_columns=None, dtype=None, name=None):
    n = int(num_rows)
    m = int(num_columns) if num_columns is not None else n
    return Tensor(torch.eye(n, m, dtype=_dt(dtype),
                            device=current_torch_device()))


def _tril(x, diagonal):
    return torch.tril(x, diagonal)


def _triu(x, diagonal):
    return torch.triu(x, diagonal)


def tril(x, diagonal=0, name=None):
    return D.apply("tril", _tril, (x,), {"diagonal": int(diagonal)})


def triu(x, diagonal=0, name=None):
    return D.apply("triu", _triu, (x,), {"diagonal": int(diagonal)})


def _assign(a):
    return a.clone()


def assign(x, output=None):
    if not isinstance(x, Tensor):
        x = to_tensor(np.asarray(x))
    out = D.apply("assign", _assign, (x,))
    if output is not None:
        output._data, output._sg = out._data, out._sg
        return output
    return out


def clone(x, name=None):
    return assign(x)
