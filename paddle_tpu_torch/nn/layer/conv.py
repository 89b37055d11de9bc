"""Conv layers: Conv1D, Conv2D, Conv3D (counterpart of the ported part
of paddle_tpu/nn/layer/conv.py)."""
from __future__ import annotations

import numpy as np

from .. import functional as F
from ..initializer import KaimingUniform, Uniform
from ..initializer.attr import ParamAttr
from .layers import Layer

__all__ = ["Conv1D", "Conv2D", "Conv3D"]


def _tup(v, n):
    return (v,) * n if isinstance(v, int) else tuple(v)


class _ConvNd(Layer):
    def __init__(self, nd, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format=None,
                 transpose=False, output_padding=0):
        super().__init__()
        self._nd = nd
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._kernel_size = _tup(kernel_size, nd)
        self._stride = stride
        self._padding = padding
        self._dilation = dilation
        self._groups = groups
        self._padding_mode = padding_mode
        self._data_format = data_format
        self._transpose = transpose
        self._output_padding = output_padding
        if transpose:
            shape = [in_channels, out_channels // groups, *self._kernel_size]
        else:
            shape = [out_channels, in_channels // groups, *self._kernel_size]
        fan_in = in_channels * int(np.prod(self._kernel_size)) // groups
        self.weight = self.create_parameter(
            shape, attr=ParamAttr._to_attr(weight_attr),
            default_initializer=KaimingUniform(fan_in=fan_in))
        bound = 1.0 / np.sqrt(fan_in)
        self.bias = (None if bias_attr is False else self.create_parameter(
            [out_channels], attr=ParamAttr._to_attr(bias_attr), is_bias=True,
            default_initializer=Uniform(-bound, bound)))

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={self._kernel_size}, stride={self._stride}")


class Conv1D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 dilation=1, groups=1, padding_mode="zeros", weight_attr=None,
                 bias_attr=None, data_format="NCL"):
        super().__init__(1, in_channels, out_channels, kernel_size, stride, padding,
                         dilation, groups, padding_mode, weight_attr, bias_attr,
                         data_format)

    def forward(self, x):
        return F.conv1d(x, self.weight, self.bias, self._stride, self._padding,
                        self._dilation, self._groups, self._data_format)


class Conv2D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 dilation=1, groups=1, padding_mode="zeros", weight_attr=None,
                 bias_attr=None, data_format="NCHW"):
        super().__init__(2, in_channels, out_channels, kernel_size, stride, padding,
                         dilation, groups, padding_mode, weight_attr, bias_attr,
                         data_format)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self._stride, self._padding,
                        self._dilation, self._groups, self._data_format)


class Conv3D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 dilation=1, groups=1, padding_mode="zeros", weight_attr=None,
                 bias_attr=None, data_format="NCDHW"):
        super().__init__(3, in_channels, out_channels, kernel_size, stride, padding,
                         dilation, groups, padding_mode, weight_attr, bias_attr,
                         data_format)

    def forward(self, x):
        return F.conv3d(x, self.weight, self.bias, self._stride, self._padding,
                        self._dilation, self._groups, self._data_format)
