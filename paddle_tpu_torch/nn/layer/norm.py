"""Normalization layers: LayerNorm, RMSNorm, BatchNorm* (counterpart of
the ported part of paddle_tpu/nn/layer/norm.py)."""
from __future__ import annotations

import torch

from ...core.place import current_torch_device
from ...core.tensor import Tensor
from .. import functional as F
from ..initializer import Constant
from ..initializer.attr import ParamAttr
from .layers import Layer

__all__ = ["LayerNorm", "RMSNorm", "BatchNorm", "BatchNorm1D", "BatchNorm2D",
           "BatchNorm3D"]


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-05, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        self.weight = (None if weight_attr is False else self.create_parameter(
            self._normalized_shape, attr=ParamAttr._to_attr(weight_attr),
            default_initializer=Constant(1.0)))
        self.bias = (None if bias_attr is False else self.create_parameter(
            self._normalized_shape, attr=ParamAttr._to_attr(bias_attr), is_bias=True))

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight, self.bias,
                            self._epsilon)

    def extra_repr(self):
        return f"normalized_shape={self._normalized_shape}, epsilon={self._epsilon}"


class RMSNorm(Layer):
    def __init__(self, hidden_size, epsilon=1e-6, weight_attr=None, name=None):
        super().__init__()
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            [hidden_size], attr=ParamAttr._to_attr(weight_attr),
            default_initializer=Constant(1.0))

    def forward(self, x):
        return F.rms_norm(x, self.weight, self._epsilon)


class _BatchNormBase(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05, weight_attr=None,
                 bias_attr=None, data_format="NCHW", use_global_stats=None, name=None):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        self.weight = (None if weight_attr is False else self.create_parameter(
            [num_features], attr=ParamAttr._to_attr(weight_attr),
            default_initializer=Constant(1.0)))
        self.bias = (None if bias_attr is False else self.create_parameter(
            [num_features], attr=ParamAttr._to_attr(bias_attr), is_bias=True))
        dev = current_torch_device()
        self.register_buffer("_mean", Tensor(
            torch.zeros([num_features], dtype=torch.float32, device=dev)))
        self.register_buffer("_variance", Tensor(
            torch.ones([num_features], dtype=torch.float32, device=dev)))

    def forward(self, x):
        return F.batch_norm(x, self._mean, self._variance, self.weight, self.bias,
                            training=self.training, momentum=self._momentum,
                            epsilon=self._epsilon, data_format=self._data_format,
                            use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return f"num_features={self._num_features}, momentum={self._momentum}"


class BatchNorm(_BatchNormBase):
    pass


class BatchNorm1D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05, weight_attr=None,
                 bias_attr=None, data_format="NCL", use_global_stats=None, name=None):
        super().__init__(num_features, momentum, epsilon, weight_attr, bias_attr,
                         data_format, use_global_stats)


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05, weight_attr=None,
                 bias_attr=None, data_format="NCDHW", use_global_stats=None, name=None):
        super().__init__(num_features, momentum, epsilon, weight_attr, bias_attr,
                         data_format, use_global_stats)
