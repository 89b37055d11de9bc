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

__all__ = [
    "seed", "get_rng_state", "set_rng_state", "rand", "randn", "randint",
    "randint_like", "uniform", "normal", "standard_normal", "gaussian",
    "randperm", "bernoulli", "poisson", "multinomial", "exponential_",
    "binomial", "standard_gamma", "log_normal", "cauchy_", "geometric_",
    "uniform_", "normal_",
]


def seed(value):
    random_state.seed(value)
    return value


def get_rng_state():
    return random_state.get_rng_state()


def set_rng_state(state):
    random_state.set_rng_state(state)


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


def gaussian(shape, mean=0.0, std=1.0, seed=0, dtype=None, name=None):
    dev = current_torch_device()
    z = torch.randn(_shape_tuple(shape), dtype=_dt(dtype), device=dev,
                    generator=random_state.generator(dev))
    return Tensor(float(mean) + float(std) * z)


def log_normal(mean=1.0, std=2.0, shape=None, name=None):
    g = gaussian(shape if shape is not None else [1], float(mean),
                 float(std))
    from . import math as _m
    return _m.exp(g)


def randint_like(x, low=0, high=None, dtype=None, name=None):
    # the output dtype follows x (may be float): integer draws, then a cast
    dt = str(dtype or x.dtype.name)
    if dt.startswith(("int", "uint")):
        return randint(low, high, x.shape, dt)
    return randint(low, high, x.shape, "int64").astype(dt)


def randperm(n, dtype="int64", name=None):
    dev = current_torch_device()
    return Tensor(torch.randperm(int(n), dtype=_dt(dtype, "int64"),
                                 device=dev,
                                 generator=random_state.generator(dev)))


def _draw(name, fn, tensors, **attrs):
    """A draw from the generator of the inputs' device, through the
    dispatcher (its output never requires grad)."""
    gen = random_state.generator(tensors[0]._data.device)
    with D.no_grad():
        return D.apply(name, fn, tensors, {"gen": gen, **attrs})


def _bernoulli(p, gen):
    return torch.bernoulli(p, generator=gen)


def bernoulli(x, p=None, name=None):
    return _draw("bernoulli", _bernoulli, (x,))


def _poisson(lam, gen):
    return torch.poisson(lam, generator=gen)


def poisson(x, name=None):
    return _draw("poisson", _poisson, (x,))


def _binomial(n, p, gen):
    return torch.binomial(n.to(torch.float32), p.to(torch.float32),
                          generator=gen).to(torch.int64)


def binomial(count, prob, name=None):
    return _draw("binomial", _binomial, (count, prob))


def _standard_gamma(alpha, gen):
    return torch._standard_gamma(alpha, generator=gen)


def standard_gamma(x, name=None):
    return _draw("standard_gamma", _standard_gamma, (x,))


def _multinomial(probs, gen, n, replace):
    return torch.multinomial(probs, n, replace, generator=gen)


def multinomial(x, num_samples=1, replacement=False, name=None):
    return _draw("multinomial", _multinomial, (x,), n=int(num_samples),
                 replace=bool(replacement))


def exponential_(x, lam=1.0, name=None):
    with torch.no_grad():
        x._data.exponential_(float(lam),
                             generator=random_state.generator(
                                 x._data.device))
    return x


def cauchy_(x, loc=0, scale=1, name=None):
    with torch.no_grad():
        x._data.cauchy_(float(loc), float(scale),
                        generator=random_state.generator(x._data.device))
    return x


def geometric_(x, probs, name=None):
    with torch.no_grad():
        x._data.geometric_(float(probs),
                           generator=random_state.generator(x._data.device))
    return x
