"""Parameter initializers (counterpart of paddle_tpu/nn/initializer/).

Each returns a torch tensor of the shape and dtype asked for, on the
default place, drawn from that device's generator
(``core.random_state``).  The draws are torch's, not the JAX package's
threefry bits: weights cross between the packages by state dict.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ...core import random_state
from ...core.dtype import to_torch_dtype
from ...core.place import current_torch_device
from .attr import ParamAttr

__all__ = [
    "Initializer", "Constant", "Normal", "TruncatedNormal", "Uniform",
    "XavierNormal", "XavierUniform", "KaimingNormal", "KaimingUniform",
    "Assign", "Orthogonal", "Dirac", "calculate_gain",
    "set_global_initializer", "ParamAttr",
]

_global_weight_init = None
_global_bias_init = None


def set_global_initializer(weight_init, bias_init=None):
    global _global_weight_init, _global_bias_init
    _global_weight_init, _global_bias_init = weight_init, bias_init


def _fans(shape):
    shape = tuple(shape)
    if len(shape) < 2:
        fan_in = fan_out = int(np.prod(shape)) if shape else 1
    else:
        receptive = int(np.prod(shape[2:])) if len(shape) > 2 else 1
        # paddle convention for Linear: shape [in, out]
        fan_in, fan_out = shape[0] * receptive, shape[1] * receptive
        if len(shape) > 2:
            # conv kernels: [out_c, in_c, *k]
            fan_in, fan_out = shape[1] * receptive, shape[0] * receptive
    return fan_in, fan_out


def calculate_gain(nonlinearity, param=None):
    table = {
        "sigmoid": 1.0, "linear": 1.0, "conv1d": 1.0, "conv2d": 1.0,
        "conv3d": 1.0, "conv1d_transpose": 1.0, "conv2d_transpose": 1.0,
        "conv3d_transpose": 1.0, "tanh": 5.0 / 3, "relu": math.sqrt(2.0),
        "leaky_relu": math.sqrt(
            2.0 / (1 + (param if param is not None else 0.01) ** 2)),
        "selu": 3.0 / 4,
    }
    if nonlinearity not in table:
        raise ValueError(f"unsupported nonlinearity: {nonlinearity}")
    return table[nonlinearity]


def _empty(shape, dtype):
    return torch.empty(tuple(int(s) for s in shape),
                       dtype=to_torch_dtype(dtype),
                       device=current_torch_device())


def _gen(t):
    return random_state.generator(t.device)


class Initializer:
    def __call__(self, shape, dtype="float32"):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype="float32"):
        return _empty(shape, dtype).fill_(self.value)


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0, name=None):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype="float32"):
        t = _empty(shape, dtype)
        return t.normal_(self.mean, self.std, generator=_gen(t))


class TruncatedNormal(Initializer):
    def __init__(self, mean=0.0, std=1.0, a=-2.0, b=2.0, name=None):
        self.mean, self.std, self.a, self.b = mean, std, a, b

    def __call__(self, shape, dtype="float32"):
        # inverse-CDF draw of the truncated standard normal, then scaled
        t = _empty(shape, dtype)
        lo = (self.a - self.mean) / self.std if self.std else self.a
        hi = (self.b - self.mean) / self.std if self.std else self.b
        cdf = [0.5 * (1 + math.erf(v / math.sqrt(2))) for v in (lo, hi)]
        u = torch.empty_like(t, dtype=torch.float32).uniform_(
            cdf[0], cdf[1], generator=_gen(t))
        z = torch.erfinv(2 * u - 1) * math.sqrt(2)
        return (self.mean + self.std * z.clamp(lo, hi)).to(t.dtype)


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0, name=None):
        self.low, self.high = low, high

    def __call__(self, shape, dtype="float32"):
        t = _empty(shape, dtype)
        return t.uniform_(self.low, self.high, generator=_gen(t))


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0, name=None):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype="float32"):
        fi, fo = _fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        t = _empty(shape, dtype)
        return t.normal_(0.0, std, generator=_gen(t))


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0, name=None):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype="float32"):
        fi, fo = _fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        t = _empty(shape, dtype)
        return t.uniform_(-limit, limit, generator=_gen(t))


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu",
                 name=None):
        self.fan_in, self.slope = fan_in, negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype="float32"):
        fi, _ = _fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        std = calculate_gain(self.nonlinearity, self.slope) / math.sqrt(fi)
        t = _empty(shape, dtype)
        return t.normal_(0.0, std, generator=_gen(t))


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu",
                 name=None):
        self.fan_in, self.slope = fan_in, negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype="float32"):
        fi, _ = _fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        limit = calculate_gain(self.nonlinearity, self.slope) * \
            math.sqrt(3.0 / fi)
        t = _empty(shape, dtype)
        return t.uniform_(-limit, limit, generator=_gen(t))


class Assign(Initializer):
    def __init__(self, value, name=None):
        self.value = value

    def __call__(self, shape, dtype="float32"):
        from ...core.tensor import Tensor
        v = self.value
        if isinstance(v, Tensor):
            v = v.numpy()
        arr = torch.from_numpy(np.array(np.asarray(v)))
        return arr.to(device=current_torch_device(),
                      dtype=to_torch_dtype(dtype)).reshape(tuple(shape))


class Orthogonal(Initializer):
    def __init__(self, gain=1.0, name=None):
        self.gain = gain

    def __call__(self, shape, dtype="float32"):
        t = _empty(shape, "float32")
        rows = t.shape[0]
        cols = t.numel() // rows
        flat = torch.empty(rows, cols, dtype=torch.float32,
                           device=t.device).normal_(generator=_gen(t))
        if rows < cols:
            flat = flat.T
        q, r = torch.linalg.qr(flat)
        q = q * torch.sign(torch.diagonal(r))
        if rows < cols:
            q = q.T
        return (self.gain * q).reshape(t.shape).to(to_torch_dtype(dtype))


class Dirac(Initializer):
    def __init__(self, groups=1, name=None):
        self.groups = groups

    def __call__(self, shape, dtype="float32"):
        shape = tuple(shape)
        arr = np.zeros(shape, np.float32)
        out_c, in_c = shape[0], shape[1]
        mins = min(out_c // self.groups, in_c)
        centers = [s // 2 for s in shape[2:]]
        for g in range(self.groups):
            for i in range(mins):
                arr[(g * (out_c // self.groups) + i, i) + tuple(centers)] = 1
        return torch.from_numpy(arr).to(device=current_torch_device(),
                                        dtype=to_torch_dtype(dtype))
