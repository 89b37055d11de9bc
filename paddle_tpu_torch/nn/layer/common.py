"""Common layers: Linear, Identity, Embedding, Dropout, Flatten
(counterpart of the ported part of paddle_tpu/nn/layer/common.py)."""
from __future__ import annotations

import torch

from .. import functional as F
from ..initializer import Normal, XavierNormal
from ..initializer.attr import ParamAttr
from .layers import Layer

__all__ = ["Linear", "Identity", "Embedding", "Dropout", "Flatten"]


class Identity(Layer):
    def forward(self, x):
        return x


class Linear(Layer):
    """y = xW + b with W laid out [in_features, out_features]."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = self.create_parameter(
            [in_features, out_features], attr=ParamAttr._to_attr(weight_attr),
            default_initializer=XavierNormal())
        self.bias = (None if bias_attr is False else self.create_parameter(
            [out_features], attr=ParamAttr._to_attr(bias_attr), is_bias=True))

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return (f"in_features={self.in_features}, "
                f"out_features={self.out_features}")


class Embedding(Layer):
    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None):
        super().__init__()
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self._padding_idx = (None if padding_idx is None else
                             padding_idx if padding_idx >= 0
                             else num_embeddings + padding_idx)
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim],
            attr=ParamAttr._to_attr(weight_attr),
            default_initializer=Normal(0.0, 1.0))
        if self._padding_idx is not None:
            with torch.no_grad():
                self.weight._data[self._padding_idx] = 0.0

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self._padding_idx)

    def extra_repr(self):
        return f"{self._num_embeddings}, {self._embedding_dim}"


class Dropout(Layer):
    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode

    def forward(self, x):
        return F.dropout(x, self.p, axis=self.axis, training=self.training,
                         mode=self.mode)

    def extra_repr(self):
        return f"p={self.p}"


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, x):
        from ...ops.manipulation import flatten
        return flatten(x, self.start_axis, self.stop_axis)
