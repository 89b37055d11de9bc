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
    "full_like", "empty_like", "arange", "linspace", "logspace", "eye",
    "tril", "triu", "diag", "diagflat", "meshgrid", "assign", "clone",
    "complex_", "polar", "tril_indices", "triu_indices",
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


def logspace(start, stop, num, base=10.0, dtype=None, name=None):
    def val(v):
        return v.item() if isinstance(v, Tensor) else v
    lin = linspace(start, stop, num, "float32")._data
    return Tensor(torch.pow(float(val(base)), lin).to(_dt(dtype)))


def _diag(x, offset, padding_value):
    d = torch.diag(x, offset)
    if x.dim() == 1 and padding_value != 0:
        mask = torch.ones_like(d, dtype=torch.bool).diagonal(offset)
        keep = torch.zeros_like(d, dtype=torch.bool)
        keep.diagonal(offset).copy_(mask)
        return torch.where(keep, d, torch.full_like(d, padding_value))
    return d


def diag(x, offset=0, padding_value=0, name=None):
    return D.apply("diag", _diag, (x,), {"offset": int(offset),
                                         "padding_value": padding_value})


def _diagflat(a, offset):
    return torch.diagflat(a, offset)


def diagflat(x, offset=0, name=None):
    return D.apply("diagflat", _diagflat, (x,), {"offset": int(offset)})


def _meshgrid(*arrs):
    return tuple(torch.meshgrid(*arrs, indexing="ij"))


def meshgrid(*args, **kwargs):
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        args = tuple(args[0])
    return list(D.apply("meshgrid", _meshgrid, tuple(args)))


def _complex(real, imag):
    return torch.complex(real, imag)


def complex_(real, imag, name=None):
    return D.apply("complex", _complex, (real, imag))


def _polar(a, b):
    return torch.complex(a * torch.cos(b), a * torch.sin(b))


def polar(abs_t, angle, name=None):
    return D.apply("polar", _polar, (abs_t, angle))


def _indices(rc, dtype):
    return Tensor(torch.as_tensor(np.stack(rc)).to(
        dtype=_dt(dtype), device=current_torch_device()))


def tril_indices(row, col, offset=0, dtype="int64"):
    return _indices(np.tril_indices(row, offset, col), dtype)


def triu_indices(row, col=None, offset=0, dtype="int64"):
    return _indices(np.triu_indices(row, offset,
                                    col if col is not None else row), dtype)
