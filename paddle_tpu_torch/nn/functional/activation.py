"""Activation functionals (counterpart of the ported part of
paddle_tpu/nn/functional/activation.py): the kernel-driven ones from the
generated wrappers, and their inplace twins."""
from __future__ import annotations

from ...ops._inplace import apply_inplace
from ...ops.generated.op_wrappers import (  # noqa: F401
    elu, gelu, hardswish, leaky_relu, log_sigmoid, log_softmax, mish, relu,
    relu6, sigmoid, silu, softmax, softplus, softsign, swish, tanh,
)

__all__ = [
    "relu", "relu_", "relu6", "elu", "gelu", "silu", "swish", "sigmoid",
    "hardswish", "leaky_relu", "log_sigmoid", "log_softmax", "softmax",
    "softmax_", "softplus", "softsign", "mish", "tanh", "tanh_",
]


def relu_(x, name=None):
    return apply_inplace(x, relu)


def tanh_(x, name=None):
    return apply_inplace(x, tanh)


def softmax_(x, axis=-1, dtype=None, name=None):
    return apply_inplace(x, lambda s: softmax(s, axis, dtype))
