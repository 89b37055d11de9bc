"""Activation layers (counterpart of the ported part of
paddle_tpu/nn/layer/activation.py)."""
from __future__ import annotations

from .. import functional as F
from .layers import Layer

__all__ = ["ELU", "GELU", "Hardswish", "LeakyReLU", "LogSigmoid",
           "LogSoftmax", "Mish", "ReLU", "ReLU6", "Sigmoid", "Silu",
           "Softmax", "Softplus", "Softsign", "Swish", "Tanh"]


def _mk(name, fn):
    def __init__(self, *args, **kwargs):
        Layer.__init__(self)
        self._args = args
        self._kwargs = {k: v for k, v in kwargs.items() if k != "name"}

    def forward(self, x):
        return fn(x, *self._args, **self._kwargs)

    return type(name, (Layer,), {"__init__": __init__, "forward": forward})


ELU = _mk("ELU", F.elu)
GELU = _mk("GELU", F.gelu)
Hardswish = _mk("Hardswish", F.hardswish)
LeakyReLU = _mk("LeakyReLU", F.leaky_relu)
LogSigmoid = _mk("LogSigmoid", F.log_sigmoid)
LogSoftmax = _mk("LogSoftmax", F.log_softmax)
Mish = _mk("Mish", F.mish)
ReLU = _mk("ReLU", F.relu)
ReLU6 = _mk("ReLU6", F.relu6)
Sigmoid = _mk("Sigmoid", F.sigmoid)
Silu = _mk("Silu", F.silu)
Softmax = _mk("Softmax", F.softmax)
Softplus = _mk("Softplus", F.softplus)
Softsign = _mk("Softsign", F.softsign)
Swish = _mk("Swish", F.swish)
Tanh = _mk("Tanh", F.tanh)
