"""Random ops (counterpart of paddle_tpu/ops/random.py).  Every draw
names its device's generator (``core.random_state.generator``); nothing
draws from torch's global generator."""
from __future__ import annotations

import torch

from ..core import dispatch as D
from ..core import random_state
from ..core.place import current_torch_device
from ..core.tensor import Tensor
from .creation import _dt, _shape_tuple

__all__ = ["uniform", "rand", "randn", "standard_normal", "normal",
           "randint", "uniform_", "normal_"]


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None):
    dev = current_torch_device()
    out = torch.empty(_shape_tuple(shape), dtype=_dt(dtype), device=dev)
    out.uniform_(float(min), float(max),
                 generator=random_state.generator(dev))
    return Tensor(out)


def rand(shape, dtype=None, name=None):
    return uniform(shape, dtype, 0.0, 1.0)


def randn(shape, dtype=None, name=None):
    return standard_normal(shape, dtype)


def standard_normal(shape, dtype=None, name=None):
    dev = current_torch_device()
    return Tensor(torch.randn(_shape_tuple(shape), dtype=_dt(dtype),
                              device=dev,
                              generator=random_state.generator(dev)))


def normal(mean=0.0, std=1.0, shape=None, name=None):
    if isinstance(mean, Tensor) or isinstance(std, Tensor):
        ref = mean if isinstance(mean, Tensor) else std
        gen = random_state.generator(ref._data.device)

        def _normal(m, s):
            shp = torch.broadcast_shapes(m.shape, s.shape)
            dt = torch.result_type(m, s)
            dt = dt if dt.is_floating_point else torch.float32
            z = torch.randn(shp, dtype=dt, device=ref._data.device,
                            generator=gen)
            return m + s * z
        return D.apply("normal_t", _normal, (mean, std))
    out = standard_normal(shape if shape is not None else [1])
    from . import math as _m
    return _m.add(_m.scale(out, float(std)), float(mean))


def randint(low=0, high=None, shape=(1,), dtype="int64", name=None):
    if high is None:
        low, high = 0, low
    dev = current_torch_device()
    return Tensor(torch.randint(int(low), int(high), _shape_tuple(shape),
                                dtype=_dt(dtype, "int64"), device=dev,
                                generator=random_state.generator(dev)))


def uniform_(x, min=-1.0, max=1.0, seed=0, name=None):
    with torch.no_grad():
        x._data.uniform_(float(min), float(max),
                         generator=random_state.generator(x._data.device))
    return x


def normal_(x, mean=0.0, std=1.0, name=None):
    with torch.no_grad():
        x._data.normal_(float(mean), float(std),
                        generator=random_state.generator(x._data.device))
    return x
