"""AUTO-GENERATED by `python -m paddle_tpu_torch.codegen` — DO NOT EDIT.
Source of truth: paddle_tpu_torch/ops/ops.yaml
"""

import numpy as _np

from paddle_tpu_torch.core import dispatch as _D
from paddle_tpu_torch.core.tensor import Tensor as _Tensor


def _resolve(path):
    import importlib
    mod, _, fn = path.partition(':')
    return getattr(importlib.import_module(mod), fn)


_k_abs = _resolve('paddle_tpu_torch.ops.kernels:abs')


def abs(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:abs)."""
    return _D.apply('abs', _k_abs, (x,), {})


_k_add = _resolve('paddle_tpu_torch.ops.kernels:add')


def add(x, y, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:add)."""
    return _D.apply('add', _k_add, (x, y), {})


_k_all = _resolve('paddle_tpu_torch.ops.kernels:all')


def all(x, axis=None, keepdim=False, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:all)."""
    return _D.apply('all', _k_all, (x,), {'axis': _attr(axis), 'keepdim': _attr(keepdim)})


_k_amax = _resolve('paddle_tpu_torch.ops.kernels:amax')


def amax(x, axis=None, keepdim=False, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:amax)."""
    return _D.apply('amax', _k_amax, (x,), {'axis': _attr(axis), 'keepdim': _attr(keepdim)})


_k_amin = _resolve('paddle_tpu_torch.ops.kernels:amin')


def amin(x, axis=None, keepdim=False, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:amin)."""
    return _D.apply('amin', _k_amin, (x,), {'axis': _attr(axis), 'keepdim': _attr(keepdim)})


_k_any = _resolve('paddle_tpu_torch.ops.kernels:any')


def any(x, axis=None, keepdim=False, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:any)."""
    return _D.apply('any', _k_any, (x,), {'axis': _attr(axis), 'keepdim': _attr(keepdim)})


_k_argmax = _resolve('paddle_tpu_torch.ops.kernels:argmax')


def argmax(x, axis=None, keepdim=False, dtype='int64', name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:argmax)."""
    return _D.apply('argmax', _k_argmax, (x,), {'axis': _attr(axis), 'keepdim': _attr(keepdim), 'dtype': _attr(dtype)})


_k_argmin = _resolve('paddle_tpu_torch.ops.kernels:argmin')


def argmin(x, axis=None, keepdim=False, dtype='int64', name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:argmin)."""
    return _D.apply('argmin', _k_argmin, (x,), {'axis': _attr(axis), 'keepdim': _attr(keepdim), 'dtype': _attr(dtype)})


_k_binary_cross_entropy = _resolve('paddle_tpu_torch.ops.kernels:binary_cross_entropy')


def binary_cross_entropy(input, label, weight=None, reduction='mean', name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:binary_cross_entropy)."""
    _t = (input, label) + tuple(t for t in (weight,) if t is not None)
    return _D.apply('binary_cross_entropy', _k_binary_cross_entropy, _t, {'reduction': _attr(reduction), '_has_weight': weight is not None})


_k_binary_cross_entropy_with_logits = _resolve('paddle_tpu_torch.ops.kernels:binary_cross_entropy_with_logits')


def binary_cross_entropy_with_logits(logit, label, weight=None, reduction='mean', pos_weight=None, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:binary_cross_entropy_with_logits)."""
    _t = (logit, label) + tuple(t for t in (weight, pos_weight) if t is not None)
    return _D.apply('binary_cross_entropy_with_logits', _k_binary_cross_entropy_with_logits, _t, {'reduction': _attr(reduction), '_has_weight': weight is not None, '_has_pos_weight': pos_weight is not None})


_k_bmm = _resolve('paddle_tpu_torch.ops.kernels:bmm')


def bmm(input, mat2, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:bmm)."""
    return _D.apply('bmm', _k_bmm, (input, mat2), {})


_k_broadcast_to = _resolve('paddle_tpu_torch.ops.kernels:broadcast_to')


def broadcast_to(x, shape, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:broadcast_to)."""
    return _D.apply('broadcast_to', _k_broadcast_to, (x,), {'shape': _attr(shape)})


_k_cast = _resolve('paddle_tpu_torch.ops.kernels:cast')


def cast(x, dtype):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:cast)."""
    return _D.apply('cast', _k_cast, (x,), {'dtype': _attr(dtype)})


_k_ceil = _resolve('paddle_tpu_torch.ops.kernels:ceil')


def ceil(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:ceil)."""
    return _D.apply('ceil', _k_ceil, (x,), {})


_k_clip = _resolve('paddle_tpu_torch.ops.kernels:clip')


def clip(x, min=None, max=None, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:clip)."""
    return _D.apply('clip', _k_clip, (x,), {'min': _attr(min), 'max': _attr(max)})


_k_concat = _resolve('paddle_tpu_torch.ops.kernels:concat')


def concat(x, axis=0, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:concat)."""
    return _D.apply('concat', _k_concat, tuple(x), {'axis': _attr(axis)})


_k_cos = _resolve('paddle_tpu_torch.ops.kernels:cos')


def cos(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:cos)."""
    return _D.apply('cos', _k_cos, (x,), {})


_k_cross_entropy = _resolve('paddle_tpu_torch.ops.kernels:cross_entropy')


def cross_entropy(input, label, weight=None, ignore_index=-100, reduction='mean', soft_label=False, axis=-1, use_softmax=True, label_smoothing=0.0, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:cross_entropy)."""
    _t = (input, label) + tuple(t for t in (weight,) if t is not None)
    return _D.apply('cross_entropy', _k_cross_entropy, _t, {'ignore_index': _attr(ignore_index), 'reduction': _attr(reduction), 'soft_label': _attr(soft_label), 'axis': _attr(axis), 'use_softmax': _attr(use_softmax), 'label_smoothing': _attr(label_smoothing), '_has_weight': weight is not None})


_k_cumsum = _resolve('paddle_tpu_torch.ops.kernels:cumsum')


def cumsum(x, axis=None, dtype=None, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:cumsum)."""
    return _D.apply('cumsum', _k_cumsum, (x,), {'axis': _attr(axis), 'dtype': _attr(dtype)})


_k_divide = _resolve('paddle_tpu_torch.ops.kernels:divide')


def divide(x, y, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:divide)."""
    return _D.apply('divide', _k_divide, (x, y), {})


_k_elu = _resolve('paddle_tpu_torch.ops.kernels:elu')


def elu(x, alpha=1.0, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:elu)."""
    return _D.apply('elu', _k_elu, (x,), {'alpha': _attr(alpha)})


_k_equal = _resolve('paddle_tpu_torch.ops.kernels:equal')


def equal(x, y, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:equal)."""
    return _D.apply('equal', _k_equal, (x, y), {})


_k_erf = _resolve('paddle_tpu_torch.ops.kernels:erf')


def erf(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:erf)."""
    return _D.apply('erf', _k_erf, (x,), {})


_k_exp = _resolve('paddle_tpu_torch.ops.kernels:exp')


def exp(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:exp)."""
    return _D.apply('exp', _k_exp, (x,), {})


_k_expand = _resolve('paddle_tpu_torch.ops.kernels:expand')


def expand(x, shape, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:expand)."""
    return _D.apply('expand', _k_expand, (x,), {'shape': _attr(shape)})


_k_expand_as = _resolve('paddle_tpu_torch.ops.kernels:expand_as')


def expand_as(x, y, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:expand_as)."""
    return _D.apply('expand_as', _k_expand_as, (x, y), {})


_k_expm1 = _resolve('paddle_tpu_torch.ops.kernels:expm1')


def expm1(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:expm1)."""
    return _D.apply('expm1', _k_expm1, (x,), {})


_k_flatten = _resolve('paddle_tpu_torch.ops.kernels:flatten')


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:flatten)."""
    return _D.apply('flatten', _k_flatten, (x,), {'start_axis': _attr(start_axis), 'stop_axis': _attr(stop_axis)})


_k_floor = _resolve('paddle_tpu_torch.ops.kernels:floor')


def floor(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:floor)."""
    return _D.apply('floor', _k_floor, (x,), {})


_k_floor_divide = _resolve('paddle_tpu_torch.ops.kernels:floor_divide')


def floor_divide(x, y, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:floor_divide)."""
    return _D.apply('floor_divide', _k_floor_divide, (x, y), {})


_k_gather = _resolve('paddle_tpu_torch.ops.kernels:gather')


def gather(x, index, axis=0, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:gather)."""
    return _D.apply('gather', _k_gather, (x, index), {'axis': _attr(axis)})


_k_gelu = _resolve('paddle_tpu_torch.ops.kernels:gelu')


def gelu(x, approximate=False, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:gelu)."""
    return _D.apply('gelu', _k_gelu, (x,), {'approximate': _attr(approximate)})


_k_greater_equal = _resolve('paddle_tpu_torch.ops.kernels:greater_equal')


def greater_equal(x, y, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:greater_equal)."""
    return _D.apply('greater_equal', _k_greater_equal, (x, y), {})


_k_greater_than = _resolve('paddle_tpu_torch.ops.kernels:greater_than')


def greater_than(x, y, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:greater_than)."""
    return _D.apply('greater_than', _k_greater_than, (x, y), {})


_k_hardswish = _resolve('paddle_tpu_torch.ops.kernels:hardswish')


def hardswish(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:hardswish)."""
    return _D.apply('hardswish', _k_hardswish, (x,), {})


_k_index_select = _resolve('paddle_tpu_torch.ops.kernels:index_select')


def index_select(x, index, axis=0, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:index_select)."""
    return _D.apply('index_select', _k_index_select, (x, index), {'axis': _attr(axis)})


_k_isfinite = _resolve('paddle_tpu_torch.ops.kernels:isfinite')


def isfinite(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:isfinite)."""
    return _D.apply('isfinite', _k_isfinite, (x,), {})


_k_isinf = _resolve('paddle_tpu_torch.ops.kernels:isinf')


def isinf(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:isinf)."""
    return _D.apply('isinf', _k_isinf, (x,), {})


_k_isnan = _resolve('paddle_tpu_torch.ops.kernels:isnan')


def isnan(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:isnan)."""
    return _D.apply('isnan', _k_isnan, (x,), {})


_k_kl_div = _resolve('paddle_tpu_torch.ops.kernels:kl_div')


def kl_div(input, label, reduction='mean', log_target=False, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:kl_div)."""
    return _D.apply('kl_div', _k_kl_div, (input, label), {'reduction': _attr(reduction), 'log_target': _attr(log_target)})


_k_l1_loss = _resolve('paddle_tpu_torch.ops.kernels:l1_loss')


def l1_loss(input, label, reduction='mean', name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:l1_loss)."""
    return _D.apply('l1_loss', _k_l1_loss, (input, label), {'reduction': _attr(reduction)})


_k_leaky_relu = _resolve('paddle_tpu_torch.ops.kernels:leaky_relu')


def leaky_relu(x, negative_slope=0.01, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:leaky_relu)."""
    return _D.apply('leaky_relu', _k_leaky_relu, (x,), {'negative_slope': _attr(negative_slope)})


_k_less_equal = _resolve('paddle_tpu_torch.ops.kernels:less_equal')


def less_equal(x, y, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:less_equal)."""
    return _D.apply('less_equal', _k_less_equal, (x, y), {})


_k_less_than = _resolve('paddle_tpu_torch.ops.kernels:less_than')


def less_than(x, y, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:less_than)."""
    return _D.apply('less_than', _k_less_than, (x, y), {})


_k_log = _resolve('paddle_tpu_torch.ops.kernels:log')


def log(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:log)."""
    return _D.apply('log', _k_log, (x,), {})


_k_log10 = _resolve('paddle_tpu_torch.ops.kernels:log10')


def log10(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:log10)."""
    return _D.apply('log10', _k_log10, (x,), {})


_k_log1p = _resolve('paddle_tpu_torch.ops.kernels:log1p')


def log1p(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:log1p)."""
    return _D.apply('log1p', _k_log1p, (x,), {})


_k_log2 = _resolve('paddle_tpu_torch.ops.kernels:log2')


def log2(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:log2)."""
    return _D.apply('log2', _k_log2, (x,), {})


_k_log_sigmoid = _resolve('paddle_tpu_torch.ops.kernels:log_sigmoid')


def log_sigmoid(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:log_sigmoid)."""
    return _D.apply('log_sigmoid', _k_log_sigmoid, (x,), {})


_k_log_softmax = _resolve('paddle_tpu_torch.ops.kernels:log_softmax')


def log_softmax(x, axis=-1, dtype=None, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:log_softmax)."""
    return _D.apply('log_softmax', _k_log_softmax, (x,), {'axis': _attr(axis), 'dtype': _attr(dtype)})


_k_logical_and = _resolve('paddle_tpu_torch.ops.kernels:logical_and')


def logical_and(x, y, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:logical_and)."""
    return _D.apply('logical_and', _k_logical_and, (x, y), {})


_k_logical_not = _resolve('paddle_tpu_torch.ops.kernels:logical_not')


def logical_not(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:logical_not)."""
    return _D.apply('logical_not', _k_logical_not, (x,), {})


_k_logical_or = _resolve('paddle_tpu_torch.ops.kernels:logical_or')


def logical_or(x, y, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:logical_or)."""
    return _D.apply('logical_or', _k_logical_or, (x, y), {})


_k_logsumexp = _resolve('paddle_tpu_torch.ops.kernels:logsumexp')


def logsumexp(x, axis=None, keepdim=False, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:logsumexp)."""
    return _D.apply('logsumexp', _k_logsumexp, (x,), {'axis': _attr(axis), 'keepdim': _attr(keepdim)})


_k_masked_fill = _resolve('paddle_tpu_torch.ops.kernels:masked_fill')


def masked_fill(x, mask, value, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:masked_fill)."""
    return _D.apply('masked_fill', _k_masked_fill, (x, mask, value), {})


_k_matmul = _resolve('paddle_tpu_torch.ops.kernels:matmul')


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:matmul)."""
    return _D.apply('matmul', _k_matmul, (x, y), {'transpose_x': _attr(transpose_x), 'transpose_y': _attr(transpose_y)})


_k_max = _resolve('paddle_tpu_torch.ops.kernels:max')


def max(x, axis=None, keepdim=False, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:max)."""
    return _D.apply('max', _k_max, (x,), {'axis': _attr(axis), 'keepdim': _attr(keepdim)})


_k_maximum = _resolve('paddle_tpu_torch.ops.kernels:maximum')


def maximum(x, y, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:maximum)."""
    return _D.apply('maximum', _k_maximum, (x, y), {})


_k_mean = _resolve('paddle_tpu_torch.ops.kernels:mean')


def mean(x, axis=None, keepdim=False, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:mean)."""
    return _D.apply('mean', _k_mean, (x,), {'axis': _attr(axis), 'keepdim': _attr(keepdim)})


_k_min = _resolve('paddle_tpu_torch.ops.kernels:min')


def min(x, axis=None, keepdim=False, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:min)."""
    return _D.apply('min', _k_min, (x,), {'axis': _attr(axis), 'keepdim': _attr(keepdim)})


_k_minimum = _resolve('paddle_tpu_torch.ops.kernels:minimum')


def minimum(x, y, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:minimum)."""
    return _D.apply('minimum', _k_minimum, (x, y), {})


_k_mish = _resolve('paddle_tpu_torch.ops.kernels:mish')


def mish(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:mish)."""
    return _D.apply('mish', _k_mish, (x,), {})


_k_mod = _resolve('paddle_tpu_torch.ops.kernels:mod')


def mod(x, y, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:mod)."""
    return _D.apply('mod', _k_mod, (x, y), {})


_k_mse_loss = _resolve('paddle_tpu_torch.ops.kernels:mse_loss')


def mse_loss(input, label, reduction='mean', name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:mse_loss)."""
    return _D.apply('mse_loss', _k_mse_loss, (input, label), {'reduction': _attr(reduction)})


_k_multiply = _resolve('paddle_tpu_torch.ops.kernels:multiply')


def multiply(x, y, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:multiply)."""
    return _D.apply('multiply', _k_multiply, (x, y), {})


_k_neg = _resolve('paddle_tpu_torch.ops.kernels:neg')


def neg(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:neg)."""
    return _D.apply('neg', _k_neg, (x,), {})


_k_nll_loss = _resolve('paddle_tpu_torch.ops.kernels:nll_loss')


def nll_loss(input, label, weight=None, ignore_index=-100, reduction='mean', name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:nll_loss)."""
    _t = (input, label) + tuple(t for t in (weight,) if t is not None)
    return _D.apply('nll_loss', _k_nll_loss, _t, {'ignore_index': _attr(ignore_index), 'reduction': _attr(reduction), '_has_weight': weight is not None})


_k_not_equal = _resolve('paddle_tpu_torch.ops.kernels:not_equal')


def not_equal(x, y, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:not_equal)."""
    return _D.apply('not_equal', _k_not_equal, (x, y), {})


_k_one_hot = _resolve('paddle_tpu_torch.ops.kernels:one_hot')


def one_hot(x, num_classes, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:one_hot)."""
    return _D.apply('one_hot', _k_one_hot, (x,), {'num_classes': _attr(num_classes)})


_k_pow = _resolve('paddle_tpu_torch.ops.kernels:pow')


def pow(x, y, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:pow)."""
    return _D.apply('pow', _k_pow, (x, y), {})


_k_prod = _resolve('paddle_tpu_torch.ops.kernels:prod')


def prod(x, axis=None, keepdim=False, dtype=None, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:prod)."""
    return _D.apply('prod', _k_prod, (x,), {'axis': _attr(axis), 'keepdim': _attr(keepdim), 'dtype': _attr(dtype)})


_k_reciprocal = _resolve('paddle_tpu_torch.ops.kernels:reciprocal')


def reciprocal(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:reciprocal)."""
    return _D.apply('reciprocal', _k_reciprocal, (x,), {})


_k_relu = _resolve('paddle_tpu_torch.ops.kernels:relu')


def relu(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:relu)."""
    return _D.apply('relu', _k_relu, (x,), {})


_k_relu6 = _resolve('paddle_tpu_torch.ops.kernels:relu6')


def relu6(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:relu6)."""
    return _D.apply('relu6', _k_relu6, (x,), {})


_k_reshape = _resolve('paddle_tpu_torch.ops.kernels:reshape')


def reshape(x, shape, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:reshape)."""
    return _D.apply('reshape', _k_reshape, (x,), {'shape': _attr(shape)})


_k_round = _resolve('paddle_tpu_torch.ops.kernels:round')


def round(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:round)."""
    return _D.apply('round', _k_round, (x,), {})


_k_rsqrt = _resolve('paddle_tpu_torch.ops.kernels:rsqrt')


def rsqrt(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:rsqrt)."""
    return _D.apply('rsqrt', _k_rsqrt, (x,), {})


_k_scale = _resolve('paddle_tpu_torch.ops.kernels:scale')


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:scale)."""
    return _D.apply('scale', _k_scale, (x,), {'scale': _attr(scale), 'bias': _attr(bias), 'bias_after_scale': _attr(bias_after_scale), 'act': _attr(act)})


_k_sigmoid = _resolve('paddle_tpu_torch.ops.kernels:sigmoid')


def sigmoid(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:sigmoid)."""
    return _D.apply('sigmoid', _k_sigmoid, (x,), {})


_k_sign = _resolve('paddle_tpu_torch.ops.kernels:sign')


def sign(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:sign)."""
    return _D.apply('sign', _k_sign, (x,), {})


_k_silu = _resolve('paddle_tpu_torch.ops.kernels:silu')


def silu(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:silu)."""
    return _D.apply('silu', _k_silu, (x,), {})


_k_sin = _resolve('paddle_tpu_torch.ops.kernels:sin')


def sin(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:sin)."""
    return _D.apply('sin', _k_sin, (x,), {})


_k_smooth_l1_loss = _resolve('paddle_tpu_torch.ops.kernels:smooth_l1_loss')


def smooth_l1_loss(input, label, reduction='mean', delta=1.0, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:smooth_l1_loss)."""
    return _D.apply('smooth_l1_loss', _k_smooth_l1_loss, (input, label), {'reduction': _attr(reduction), 'delta': _attr(delta)})


_k_softmax = _resolve('paddle_tpu_torch.ops.kernels:softmax')


def softmax(x, axis=-1, dtype=None, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:softmax)."""
    return _D.apply('softmax', _k_softmax, (x,), {'axis': _attr(axis), 'dtype': _attr(dtype)})


_k_softplus = _resolve('paddle_tpu_torch.ops.kernels:softplus')


def softplus(x, beta=1.0, threshold=20.0, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:softplus)."""
    return _D.apply('softplus', _k_softplus, (x,), {'beta': _attr(beta), 'threshold': _attr(threshold)})


_k_softsign = _resolve('paddle_tpu_torch.ops.kernels:softsign')


def softsign(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:softsign)."""
    return _D.apply('softsign', _k_softsign, (x,), {})


_k_sqrt = _resolve('paddle_tpu_torch.ops.kernels:sqrt')


def sqrt(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:sqrt)."""
    return _D.apply('sqrt', _k_sqrt, (x,), {})


_k_square = _resolve('paddle_tpu_torch.ops.kernels:square')


def square(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:square)."""
    return _D.apply('square', _k_square, (x,), {})


_k_squeeze = _resolve('paddle_tpu_torch.ops.kernels:squeeze')


def squeeze(x, axis=None, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:squeeze)."""
    return _D.apply('squeeze', _k_squeeze, (x,), {'axis': _attr(axis)})


_k_stack = _resolve('paddle_tpu_torch.ops.kernels:stack')


def stack(x, axis=0, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:stack)."""
    return _D.apply('stack', _k_stack, tuple(x), {'axis': _attr(axis)})


_k_std = _resolve('paddle_tpu_torch.ops.kernels:std')


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:std)."""
    return _D.apply('std', _k_std, (x,), {'axis': _attr(axis), 'unbiased': _attr(unbiased), 'keepdim': _attr(keepdim)})


_k_subtract = _resolve('paddle_tpu_torch.ops.kernels:subtract')


def subtract(x, y, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:subtract)."""
    return _D.apply('subtract', _k_subtract, (x, y), {})


_k_sum = _resolve('paddle_tpu_torch.ops.kernels:sum')


def sum(x, axis=None, dtype=None, keepdim=False, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:sum)."""
    return _D.apply('sum', _k_sum, (x,), {'axis': _attr(axis), 'dtype': _attr(dtype), 'keepdim': _attr(keepdim)})


_k_swish = _resolve('paddle_tpu_torch.ops.kernels:swish')


def swish(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:swish)."""
    return _D.apply('swish', _k_swish, (x,), {})


_k_tan = _resolve('paddle_tpu_torch.ops.kernels:tan')


def tan(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:tan)."""
    return _D.apply('tan', _k_tan, (x,), {})


_k_tanh = _resolve('paddle_tpu_torch.ops.kernels:tanh')


def tanh(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:tanh)."""
    return _D.apply('tanh', _k_tanh, (x,), {})


_k_tile = _resolve('paddle_tpu_torch.ops.kernels:tile')


def tile(x, repeat_times, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:tile)."""
    return _D.apply('tile', _k_tile, (x,), {'repeat_times': _attr(repeat_times)})


_k_transpose = _resolve('paddle_tpu_torch.ops.kernels:transpose')


def transpose(x, perm=None, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:transpose)."""
    return _D.apply('transpose', _k_transpose, (x,), {'perm': _attr(perm)})


_k_trunc = _resolve('paddle_tpu_torch.ops.kernels:trunc')


def trunc(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:trunc)."""
    return _D.apply('trunc', _k_trunc, (x,), {})


_k_unsqueeze = _resolve('paddle_tpu_torch.ops.kernels:unsqueeze')


def unsqueeze(x, axis, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:unsqueeze)."""
    return _D.apply('unsqueeze', _k_unsqueeze, (x,), {'axis': _attr(axis)})


_k_var = _resolve('paddle_tpu_torch.ops.kernels:var')


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:var)."""
    return _D.apply('var', _k_var, (x,), {'axis': _attr(axis), 'unbiased': _attr(unbiased), 'keepdim': _attr(keepdim)})


def _attr(v):
    # lists become tuples; Tensor-valued shape/axis attrs
    # (legal in the reference API) are read back to host
    if isinstance(v, (list, tuple)):
        return tuple(_attr(e) for e in v)
    if isinstance(v, (_Tensor, _np.ndarray)):
        return _attr(v.tolist())
    return v


__all__ = ['abs', 'add', 'all', 'amax', 'amin', 'any', 'argmax', 'argmin', 'binary_cross_entropy', 'binary_cross_entropy_with_logits', 'bmm', 'broadcast_to', 'cast', 'ceil', 'clip', 'concat', 'cos', 'cross_entropy', 'cumsum', 'divide', 'elu', 'equal', 'erf', 'exp', 'expand', 'expand_as', 'expm1', 'flatten', 'floor', 'floor_divide', 'gather', 'gelu', 'greater_equal', 'greater_than', 'hardswish', 'index_select', 'isfinite', 'isinf', 'isnan', 'kl_div', 'l1_loss', 'leaky_relu', 'less_equal', 'less_than', 'log', 'log10', 'log1p', 'log2', 'log_sigmoid', 'log_softmax', 'logical_and', 'logical_not', 'logical_or', 'logsumexp', 'masked_fill', 'matmul', 'max', 'maximum', 'mean', 'min', 'minimum', 'mish', 'mod', 'mse_loss', 'multiply', 'neg', 'nll_loss', 'not_equal', 'one_hot', 'pow', 'prod', 'reciprocal', 'relu', 'relu6', 'reshape', 'round', 'rsqrt', 'scale', 'sigmoid', 'sign', 'silu', 'sin', 'smooth_l1_loss', 'softmax', 'softplus', 'softsign', 'sqrt', 'square', 'squeeze', 'stack', 'std', 'subtract', 'sum', 'swish', 'tan', 'tanh', 'tile', 'transpose', 'trunc', 'unsqueeze', 'var']
