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


_k_acos = _resolve('paddle_tpu_torch.ops.kernels:acos')


def acos(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:acos)."""
    return _D.apply('acos', _k_acos, (x,), {})


_k_acosh = _resolve('paddle_tpu_torch.ops.kernels:acosh')


def acosh(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:acosh)."""
    return _D.apply('acosh', _k_acosh, (x,), {})


_k_add = _resolve('paddle_tpu_torch.ops.kernels:add')


def add(x, y, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:add)."""
    return _D.apply('add', _k_add, (x, y), {})


_k_addmm = _resolve('paddle_tpu_torch.ops.kernels:addmm')


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:addmm)."""
    return _D.apply('addmm', _k_addmm, (input, x, y), {'beta': _attr(beta), 'alpha': _attr(alpha)})


_k_all = _resolve('paddle_tpu_torch.ops.kernels:all')


def all(x, axis=None, keepdim=False, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:all)."""
    return _D.apply('all', _k_all, (x,), {'axis': _attr(axis), 'keepdim': _attr(keepdim)})


_k_allclose = _resolve('paddle_tpu_torch.ops.kernels:allclose')


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:allclose)."""
    return _D.apply('allclose', _k_allclose, (x, y), {'rtol': _attr(rtol), 'atol': _attr(atol), 'equal_nan': _attr(equal_nan)})


_k_amax = _resolve('paddle_tpu_torch.ops.kernels:amax')


def amax(x, axis=None, keepdim=False, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:amax)."""
    return _D.apply('amax', _k_amax, (x,), {'axis': _attr(axis), 'keepdim': _attr(keepdim)})


_k_amin = _resolve('paddle_tpu_torch.ops.kernels:amin')


def amin(x, axis=None, keepdim=False, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:amin)."""
    return _D.apply('amin', _k_amin, (x,), {'axis': _attr(axis), 'keepdim': _attr(keepdim)})


_k_angle = _resolve('paddle_tpu_torch.ops.kernels:angle')


def angle(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:angle)."""
    return _D.apply('angle', _k_angle, (x,), {})


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


_k_argsort = _resolve('paddle_tpu_torch.ops.kernels:argsort')


def argsort(x, axis=-1, descending=False, stable=False, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:argsort)."""
    return _D.apply('argsort', _k_argsort, (x,), {'axis': _attr(axis), 'descending': _attr(descending), 'stable': _attr(stable)})


_k_as_complex = _resolve('paddle_tpu_torch.ops.kernels:as_complex')


def as_complex(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:as_complex)."""
    return _D.apply('as_complex', _k_as_complex, (x,), {})


_k_as_real = _resolve('paddle_tpu_torch.ops.kernels:as_real')


def as_real(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:as_real)."""
    return _D.apply('as_real', _k_as_real, (x,), {})


_k_asin = _resolve('paddle_tpu_torch.ops.kernels:asin')


def asin(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:asin)."""
    return _D.apply('asin', _k_asin, (x,), {})


_k_asinh = _resolve('paddle_tpu_torch.ops.kernels:asinh')


def asinh(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:asinh)."""
    return _D.apply('asinh', _k_asinh, (x,), {})


_k_atan = _resolve('paddle_tpu_torch.ops.kernels:atan')


def atan(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:atan)."""
    return _D.apply('atan', _k_atan, (x,), {})


_k_atan2 = _resolve('paddle_tpu_torch.ops.kernels:atan2')


def atan2(x, y, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:atan2)."""
    return _D.apply('atan2', _k_atan2, (x, y), {})


_k_atanh = _resolve('paddle_tpu_torch.ops.kernels:atanh')


def atanh(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:atanh)."""
    return _D.apply('atanh', _k_atanh, (x,), {})


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


_k_bitwise_and = _resolve('paddle_tpu_torch.ops.kernels:bitwise_and')


def bitwise_and(x, y, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:bitwise_and)."""
    return _D.apply('bitwise_and', _k_bitwise_and, (x, y), {})


_k_bitwise_left_shift = _resolve('paddle_tpu_torch.ops.kernels:bitwise_left_shift')


def bitwise_left_shift(x, y, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:bitwise_left_shift)."""
    return _D.apply('bitwise_left_shift', _k_bitwise_left_shift, (x, y), {})


_k_bitwise_not = _resolve('paddle_tpu_torch.ops.kernels:bitwise_not')


def bitwise_not(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:bitwise_not)."""
    return _D.apply('bitwise_not', _k_bitwise_not, (x,), {})


_k_bitwise_or = _resolve('paddle_tpu_torch.ops.kernels:bitwise_or')


def bitwise_or(x, y, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:bitwise_or)."""
    return _D.apply('bitwise_or', _k_bitwise_or, (x, y), {})


_k_bitwise_right_shift = _resolve('paddle_tpu_torch.ops.kernels:bitwise_right_shift')


def bitwise_right_shift(x, y, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:bitwise_right_shift)."""
    return _D.apply('bitwise_right_shift', _k_bitwise_right_shift, (x, y), {})


_k_bitwise_xor = _resolve('paddle_tpu_torch.ops.kernels:bitwise_xor')


def bitwise_xor(x, y, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:bitwise_xor)."""
    return _D.apply('bitwise_xor', _k_bitwise_xor, (x, y), {})


_k_bmm = _resolve('paddle_tpu_torch.ops.kernels:bmm')


def bmm(input, mat2, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:bmm)."""
    return _D.apply('bmm', _k_bmm, (input, mat2), {})


_k_broadcast_to = _resolve('paddle_tpu_torch.ops.kernels:broadcast_to')


def broadcast_to(x, shape, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:broadcast_to)."""
    return _D.apply('broadcast_to', _k_broadcast_to, (x,), {'shape': _attr(shape)})


_k_bucketize = _resolve('paddle_tpu_torch.ops.kernels:bucketize')


def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:bucketize)."""
    return _D.apply('bucketize', _k_bucketize, (x, sorted_sequence), {'out_int32': _attr(out_int32), 'right': _attr(right)})


_k_cast = _resolve('paddle_tpu_torch.ops.kernels:cast')


def cast(x, dtype):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:cast)."""
    return _D.apply('cast', _k_cast, (x,), {'dtype': _attr(dtype)})


_k_cdist = _resolve('paddle_tpu_torch.ops.kernels:cdist')


def cdist(x, y, p=2.0, compute_mode='use_mm_for_euclid_dist_if_necessary', name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:cdist)."""
    return _D.apply('cdist', _k_cdist, (x, y), {'p': _attr(p), 'compute_mode': _attr(compute_mode)})


_k_ceil = _resolve('paddle_tpu_torch.ops.kernels:ceil')


def ceil(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:ceil)."""
    return _D.apply('ceil', _k_ceil, (x,), {})


_k_celu = _resolve('paddle_tpu_torch.ops.kernels:celu')


def celu(x, alpha=1.0, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:celu)."""
    return _D.apply('celu', _k_celu, (x,), {'alpha': _attr(alpha)})


_k_cholesky = _resolve('paddle_tpu_torch.ops.kernels:cholesky')


def cholesky(x, upper=False, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:cholesky)."""
    return _D.apply('cholesky', _k_cholesky, (x,), {'upper': _attr(upper)})


_k_cholesky_inverse = _resolve('paddle_tpu_torch.ops.kernels:cholesky_inverse')


def cholesky_inverse(x, upper=False, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:cholesky_inverse)."""
    return _D.apply('cholesky_inverse', _k_cholesky_inverse, (x,), {'upper': _attr(upper)})


_k_cholesky_solve = _resolve('paddle_tpu_torch.ops.kernels:cholesky_solve')


def cholesky_solve(x, y, upper=False, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:cholesky_solve)."""
    return _D.apply('cholesky_solve', _k_cholesky_solve, (x, y), {'upper': _attr(upper)})


_k_clip = _resolve('paddle_tpu_torch.ops.kernels:clip')


def clip(x, min=None, max=None, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:clip)."""
    return _D.apply('clip', _k_clip, (x,), {'min': _attr(min), 'max': _attr(max)})


_k_clip_by_norm = _resolve('paddle_tpu_torch.ops.kernels:clip_by_norm')


def clip_by_norm(x, max_norm, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:clip_by_norm)."""
    return _D.apply('clip_by_norm', _k_clip_by_norm, (x,), {'max_norm': _attr(max_norm)})


_k_combinations = _resolve('paddle_tpu_torch.ops.kernels:combinations')


def combinations(x, r=2, with_replacement=False, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:combinations)."""
    return _D.apply('combinations', _k_combinations, (x,), {'r': _attr(r), 'with_replacement': _attr(with_replacement)})


_k_concat = _resolve('paddle_tpu_torch.ops.kernels:concat')


def concat(x, axis=0, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:concat)."""
    return _D.apply('concat', _k_concat, tuple(x), {'axis': _attr(axis)})


_k_conj = _resolve('paddle_tpu_torch.ops.kernels:conj')


def conj(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:conj)."""
    return _D.apply('conj', _k_conj, (x,), {})


_k_copysign = _resolve('paddle_tpu_torch.ops.kernels:copysign')


def copysign(x, y, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:copysign)."""
    return _D.apply('copysign', _k_copysign, (x, y), {})


_k_corrcoef = _resolve('paddle_tpu_torch.ops.kernels:corrcoef')


def corrcoef(x, rowvar=True, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:corrcoef)."""
    return _D.apply('corrcoef', _k_corrcoef, (x,), {'rowvar': _attr(rowvar)})


_k_cos = _resolve('paddle_tpu_torch.ops.kernels:cos')


def cos(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:cos)."""
    return _D.apply('cos', _k_cos, (x,), {})


_k_cosh = _resolve('paddle_tpu_torch.ops.kernels:cosh')


def cosh(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:cosh)."""
    return _D.apply('cosh', _k_cosh, (x,), {})


_k_cosine_embedding_loss = _resolve('paddle_tpu_torch.ops.kernels:cosine_embedding_loss')


def cosine_embedding_loss(input1, input2, label, margin=0, reduction='mean', name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:cosine_embedding_loss)."""
    return _D.apply('cosine_embedding_loss', _k_cosine_embedding_loss, (input1, input2, label), {'margin': _attr(margin), 'reduction': _attr(reduction)})


_k_count_nonzero = _resolve('paddle_tpu_torch.ops.kernels:count_nonzero')


def count_nonzero(x, axis=None, keepdim=False, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:count_nonzero)."""
    return _D.apply('count_nonzero', _k_count_nonzero, (x,), {'axis': _attr(axis), 'keepdim': _attr(keepdim)})


_k_cov = _resolve('paddle_tpu_torch.ops.kernels:cov')


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:cov)."""
    _t = (x,) + tuple(t for t in (fweights, aweights) if t is not None)
    return _D.apply('cov', _k_cov, _t, {'rowvar': _attr(rowvar), 'ddof': _attr(ddof), '_has_fweights': fweights is not None, '_has_aweights': aweights is not None})


_k_crop = _resolve('paddle_tpu_torch.ops.kernels:crop')


def crop(x, shape=None, offsets=None, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:crop)."""
    return _D.apply('crop', _k_crop, (x,), {'shape': _attr(shape), 'offsets': _attr(offsets)})


_k_cross = _resolve('paddle_tpu_torch.ops.kernels:cross')


def cross(x, y, axis=9, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:cross)."""
    return _D.apply('cross', _k_cross, (x, y), {'axis': _attr(axis)})


_k_cross_entropy = _resolve('paddle_tpu_torch.ops.kernels:cross_entropy')


def cross_entropy(input, label, weight=None, ignore_index=-100, reduction='mean', soft_label=False, axis=-1, use_softmax=True, label_smoothing=0.0, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:cross_entropy)."""
    _t = (input, label) + tuple(t for t in (weight,) if t is not None)
    return _D.apply('cross_entropy', _k_cross_entropy, _t, {'ignore_index': _attr(ignore_index), 'reduction': _attr(reduction), 'soft_label': _attr(soft_label), 'axis': _attr(axis), 'use_softmax': _attr(use_softmax), 'label_smoothing': _attr(label_smoothing), '_has_weight': weight is not None})


_k_cummax = _resolve('paddle_tpu_torch.ops.kernels:cummax')


def cummax(x, axis=None, dtype='int64', name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:cummax)."""
    return _D.apply('cummax', _k_cummax, (x,), {'axis': _attr(axis), 'dtype': _attr(dtype)})


_k_cummin = _resolve('paddle_tpu_torch.ops.kernels:cummin')


def cummin(x, axis=None, dtype='int64', name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:cummin)."""
    return _D.apply('cummin', _k_cummin, (x,), {'axis': _attr(axis), 'dtype': _attr(dtype)})


_k_cumprod = _resolve('paddle_tpu_torch.ops.kernels:cumprod')


def cumprod(x, dim=None, dtype=None, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:cumprod)."""
    return _D.apply('cumprod', _k_cumprod, (x,), {'dim': _attr(dim), 'dtype': _attr(dtype)})


_k_cumsum = _resolve('paddle_tpu_torch.ops.kernels:cumsum')


def cumsum(x, axis=None, dtype=None, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:cumsum)."""
    return _D.apply('cumsum', _k_cumsum, (x,), {'axis': _attr(axis), 'dtype': _attr(dtype)})


_k_cumulative_trapezoid = _resolve('paddle_tpu_torch.ops.kernels:cumulative_trapezoid')


def cumulative_trapezoid(y, x=None, dx=1.0, axis=-1, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:cumulative_trapezoid)."""
    _t = (y,) + tuple(t for t in (x,) if t is not None)
    return _D.apply('cumulative_trapezoid', _k_cumulative_trapezoid, _t, {'dx': _attr(dx), 'axis': _attr(axis), '_has_x': x is not None})


_k_deg2rad = _resolve('paddle_tpu_torch.ops.kernels:deg2rad')


def deg2rad(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:deg2rad)."""
    return _D.apply('deg2rad', _k_deg2rad, (x,), {})


_k_det = _resolve('paddle_tpu_torch.ops.kernels:det')


def det(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:det)."""
    return _D.apply('det', _k_det, (x,), {})


_k_diag_embed = _resolve('paddle_tpu_torch.ops.kernels:diag_embed')


def diag_embed(x, offset=0, dim1=-2, dim2=-1, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:diag_embed)."""
    return _D.apply('diag_embed', _k_diag_embed, (x,), {'offset': _attr(offset), 'dim1': _attr(dim1), 'dim2': _attr(dim2)})


_k_diagonal = _resolve('paddle_tpu_torch.ops.kernels:diagonal')


def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:diagonal)."""
    return _D.apply('diagonal', _k_diagonal, (x,), {'offset': _attr(offset), 'axis1': _attr(axis1), 'axis2': _attr(axis2)})


_k_diagonal_scatter = _resolve('paddle_tpu_torch.ops.kernels:diagonal_scatter')


def diagonal_scatter(x, y, offset=0, axis1=0, axis2=1, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:diagonal_scatter)."""
    return _D.apply('diagonal_scatter', _k_diagonal_scatter, (x, y), {'offset': _attr(offset), 'axis1': _attr(axis1), 'axis2': _attr(axis2)})


_k_dice_loss = _resolve('paddle_tpu_torch.ops.kernels:dice_loss')


def dice_loss(input, label, epsilon=1e-05, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:dice_loss)."""
    return _D.apply('dice_loss', _k_dice_loss, (input, label), {'epsilon': _attr(epsilon)})


_k_diff = _resolve('paddle_tpu_torch.ops.kernels:diff')


def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:diff)."""
    _t = (x,) + tuple(t for t in (prepend, append) if t is not None)
    return _D.apply('diff', _k_diff, _t, {'n': _attr(n), 'axis': _attr(axis), '_has_prepend': prepend is not None, '_has_append': append is not None})


_k_digamma = _resolve('paddle_tpu_torch.ops.kernels:digamma')


def digamma(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:digamma)."""
    return _D.apply('digamma', _k_digamma, (x,), {})


_k_dist = _resolve('paddle_tpu_torch.ops.kernels:dist')


def dist(x, y, p=2, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:dist)."""
    return _D.apply('dist', _k_dist, (x, y), {'p': _attr(p)})


_k_divide = _resolve('paddle_tpu_torch.ops.kernels:divide')


def divide(x, y, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:divide)."""
    return _D.apply('divide', _k_divide, (x, y), {})


_k_dot = _resolve('paddle_tpu_torch.ops.kernels:dot')


def dot(x, y, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:dot)."""
    return _D.apply('dot', _k_dot, (x, y), {})


_k_dstack = _resolve('paddle_tpu_torch.ops.kernels:dstack')


def dstack(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:dstack)."""
    return _D.apply('dstack', _k_dstack, tuple(x), {})


_k_eigh = _resolve('paddle_tpu_torch.ops.kernels:eigh')


def eigh(x, UPLO='L', name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:eigh)."""
    return _D.apply('eigh', _k_eigh, (x,), {'UPLO': _attr(UPLO)})


_k_eigvalsh = _resolve('paddle_tpu_torch.ops.kernels:eigvalsh')


def eigvalsh(x, UPLO='L', name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:eigvalsh)."""
    return _D.apply('eigvalsh', _k_eigvalsh, (x,), {'UPLO': _attr(UPLO)})


_k_elu = _resolve('paddle_tpu_torch.ops.kernels:elu')


def elu(x, alpha=1.0, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:elu)."""
    return _D.apply('elu', _k_elu, (x,), {'alpha': _attr(alpha)})


_k_equal = _resolve('paddle_tpu_torch.ops.kernels:equal')


def equal(x, y, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:equal)."""
    return _D.apply('equal', _k_equal, (x, y), {})


_k_equal_all = _resolve('paddle_tpu_torch.ops.kernels:equal_all')


def equal_all(x, y, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:equal_all)."""
    return _D.apply('equal_all', _k_equal_all, (x, y), {})


_k_erf = _resolve('paddle_tpu_torch.ops.kernels:erf')


def erf(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:erf)."""
    return _D.apply('erf', _k_erf, (x,), {})


_k_erfinv = _resolve('paddle_tpu_torch.ops.kernels:erfinv')


def erfinv(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:erfinv)."""
    return _D.apply('erfinv', _k_erfinv, (x,), {})


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


_k_fill_diagonal = _resolve('paddle_tpu_torch.ops.kernels:fill_diagonal')


def fill_diagonal(x, value, offset=0, wrap=False, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:fill_diagonal)."""
    return _D.apply('fill_diagonal', _k_fill_diagonal, (x,), {'value': _attr(value), 'offset': _attr(offset), 'wrap': _attr(wrap)})


_k_fill_diagonal_tensor = _resolve('paddle_tpu_torch.ops.kernels:fill_diagonal_tensor')


def fill_diagonal_tensor(x, y, offset=0, dim1=0, dim2=1, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:fill_diagonal_tensor)."""
    return _D.apply('fill_diagonal_tensor', _k_fill_diagonal_tensor, (x, y), {'offset': _attr(offset), 'dim1': _attr(dim1), 'dim2': _attr(dim2)})


_k_flatten = _resolve('paddle_tpu_torch.ops.kernels:flatten')


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:flatten)."""
    return _D.apply('flatten', _k_flatten, (x,), {'start_axis': _attr(start_axis), 'stop_axis': _attr(stop_axis)})


_k_flip = _resolve('paddle_tpu_torch.ops.kernels:flip')


def flip(x, axis, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:flip)."""
    return _D.apply('flip', _k_flip, (x,), {'axis': _attr(axis)})


_k_fliplr = _resolve('paddle_tpu_torch.ops.kernels:fliplr')


def fliplr(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:fliplr)."""
    return _D.apply('fliplr', _k_fliplr, (x,), {})


_k_flipud = _resolve('paddle_tpu_torch.ops.kernels:flipud')


def flipud(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:flipud)."""
    return _D.apply('flipud', _k_flipud, (x,), {})


_k_float_power = _resolve('paddle_tpu_torch.ops.kernels:float_power')


def float_power(x, y, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:float_power)."""
    return _D.apply('float_power', _k_float_power, (x, y), {})


_k_floor = _resolve('paddle_tpu_torch.ops.kernels:floor')


def floor(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:floor)."""
    return _D.apply('floor', _k_floor, (x,), {})


_k_floor_divide = _resolve('paddle_tpu_torch.ops.kernels:floor_divide')


def floor_divide(x, y, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:floor_divide)."""
    return _D.apply('floor_divide', _k_floor_divide, (x, y), {})


_k_fmax = _resolve('paddle_tpu_torch.ops.kernels:fmax')


def fmax(x, y, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:fmax)."""
    return _D.apply('fmax', _k_fmax, (x, y), {})


_k_fmin = _resolve('paddle_tpu_torch.ops.kernels:fmin')


def fmin(x, y, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:fmin)."""
    return _D.apply('fmin', _k_fmin, (x, y), {})


_k_frac = _resolve('paddle_tpu_torch.ops.kernels:frac')


def frac(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:frac)."""
    return _D.apply('frac', _k_frac, (x,), {})


_k_frobenius_norm = _resolve('paddle_tpu_torch.ops.kernels:frobenius_norm')


def frobenius_norm(x, axis=None, keepdim=False, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:frobenius_norm)."""
    return _D.apply('frobenius_norm', _k_frobenius_norm, (x,), {'axis': _attr(axis), 'keepdim': _attr(keepdim)})


_k_gammainc = _resolve('paddle_tpu_torch.ops.kernels:gammainc')


def gammainc(x, y, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:gammainc)."""
    return _D.apply('gammainc', _k_gammainc, (x, y), {})


_k_gammaincc = _resolve('paddle_tpu_torch.ops.kernels:gammaincc')


def gammaincc(x, y, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:gammaincc)."""
    return _D.apply('gammaincc', _k_gammaincc, (x, y), {})


_k_gammaln = _resolve('paddle_tpu_torch.ops.kernels:gammaln')


def gammaln(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:gammaln)."""
    return _D.apply('gammaln', _k_gammaln, (x,), {})


_k_gather = _resolve('paddle_tpu_torch.ops.kernels:gather')


def gather(x, index, axis=0, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:gather)."""
    return _D.apply('gather', _k_gather, (x, index), {'axis': _attr(axis)})


_k_gather_nd = _resolve('paddle_tpu_torch.ops.kernels:gather_nd')


def gather_nd(x, index, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:gather_nd)."""
    return _D.apply('gather_nd', _k_gather_nd, (x, index), {})


_k_gaussian_nll_loss = _resolve('paddle_tpu_torch.ops.kernels:gaussian_nll_loss')


def gaussian_nll_loss(input, label, variance, full=False, epsilon=1e-06, reduction='mean', name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:gaussian_nll_loss)."""
    return _D.apply('gaussian_nll_loss', _k_gaussian_nll_loss, (input, label, variance), {'full': _attr(full), 'epsilon': _attr(epsilon), 'reduction': _attr(reduction)})


_k_gcd = _resolve('paddle_tpu_torch.ops.kernels:gcd')


def gcd(x, y, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:gcd)."""
    return _D.apply('gcd', _k_gcd, (x, y), {})


_k_gelu = _resolve('paddle_tpu_torch.ops.kernels:gelu')


def gelu(x, approximate=False, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:gelu)."""
    return _D.apply('gelu', _k_gelu, (x,), {'approximate': _attr(approximate)})


_k_glu = _resolve('paddle_tpu_torch.ops.kernels:glu')


def glu(x, axis=-1, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:glu)."""
    return _D.apply('glu', _k_glu, (x,), {'axis': _attr(axis)})


_k_greater_equal = _resolve('paddle_tpu_torch.ops.kernels:greater_equal')


def greater_equal(x, y, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:greater_equal)."""
    return _D.apply('greater_equal', _k_greater_equal, (x, y), {})


_k_greater_than = _resolve('paddle_tpu_torch.ops.kernels:greater_than')


def greater_than(x, y, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:greater_than)."""
    return _D.apply('greater_than', _k_greater_than, (x, y), {})


_k_hardshrink = _resolve('paddle_tpu_torch.ops.kernels:hardshrink')


def hardshrink(x, threshold=0.5, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:hardshrink)."""
    return _D.apply('hardshrink', _k_hardshrink, (x,), {'threshold': _attr(threshold)})


_k_hardsigmoid = _resolve('paddle_tpu_torch.ops.kernels:hardsigmoid')


def hardsigmoid(x, slope=0.1666667, offset=0.5, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:hardsigmoid)."""
    return _D.apply('hardsigmoid', _k_hardsigmoid, (x,), {'slope': _attr(slope), 'offset': _attr(offset)})


_k_hardswish = _resolve('paddle_tpu_torch.ops.kernels:hardswish')


def hardswish(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:hardswish)."""
    return _D.apply('hardswish', _k_hardswish, (x,), {})


_k_hardtanh = _resolve('paddle_tpu_torch.ops.kernels:hardtanh')


def hardtanh(x, min=-1.0, max=1.0, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:hardtanh)."""
    return _D.apply('hardtanh', _k_hardtanh, (x,), {'min': _attr(min), 'max': _attr(max)})


_k_heaviside = _resolve('paddle_tpu_torch.ops.kernels:heaviside')


def heaviside(x, y, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:heaviside)."""
    return _D.apply('heaviside', _k_heaviside, (x, y), {})


_k_hinge_embedding_loss = _resolve('paddle_tpu_torch.ops.kernels:hinge_embedding_loss')


def hinge_embedding_loss(input, label, margin=1.0, reduction='mean', name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:hinge_embedding_loss)."""
    return _D.apply('hinge_embedding_loss', _k_hinge_embedding_loss, (input, label), {'margin': _attr(margin), 'reduction': _attr(reduction)})


_k_histogram = _resolve('paddle_tpu_torch.ops.kernels:histogram')


def histogram(input, bins=100, min=0, max=0, weight=None, density=False, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:histogram)."""
    _t = (input,) + tuple(t for t in (weight,) if t is not None)
    return _D.apply('histogram', _k_histogram, _t, {'bins': _attr(bins), 'min': _attr(min), 'max': _attr(max), 'density': _attr(density), '_has_weight': weight is not None})


_k_hstack = _resolve('paddle_tpu_torch.ops.kernels:hstack')


def hstack(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:hstack)."""
    return _D.apply('hstack', _k_hstack, tuple(x), {})


_k_hypot = _resolve('paddle_tpu_torch.ops.kernels:hypot')


def hypot(x, y, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:hypot)."""
    return _D.apply('hypot', _k_hypot, (x, y), {})


_k_i0 = _resolve('paddle_tpu_torch.ops.kernels:i0')


def i0(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:i0)."""
    return _D.apply('i0', _k_i0, (x,), {})


_k_i0e = _resolve('paddle_tpu_torch.ops.kernels:i0e')


def i0e(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:i0e)."""
    return _D.apply('i0e', _k_i0e, (x,), {})


_k_i1 = _resolve('paddle_tpu_torch.ops.kernels:i1')


def i1(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:i1)."""
    return _D.apply('i1', _k_i1, (x,), {})


_k_i1e = _resolve('paddle_tpu_torch.ops.kernels:i1e')


def i1e(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:i1e)."""
    return _D.apply('i1e', _k_i1e, (x,), {})


_k_imag = _resolve('paddle_tpu_torch.ops.kernels:imag')


def imag(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:imag)."""
    return _D.apply('imag', _k_imag, (x,), {})


_k_index_add = _resolve('paddle_tpu_torch.ops.kernels:index_add')


def index_add(x, index, axis, value, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:index_add)."""
    return _D.apply('index_add', _k_index_add, (x, index, value), {'axis': _attr(axis)})


_k_index_fill = _resolve('paddle_tpu_torch.ops.kernels:index_fill')


def index_fill(x, index, axis, value, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:index_fill)."""
    return _D.apply('index_fill', _k_index_fill, (x, index, value), {'axis': _attr(axis)})


_k_index_sample = _resolve('paddle_tpu_torch.ops.kernels:index_sample')


def index_sample(x, index, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:index_sample)."""
    return _D.apply('index_sample', _k_index_sample, (x, index), {})


_k_index_select = _resolve('paddle_tpu_torch.ops.kernels:index_select')


def index_select(x, index, axis=0, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:index_select)."""
    return _D.apply('index_select', _k_index_select, (x, index), {'axis': _attr(axis)})


_k_inner = _resolve('paddle_tpu_torch.ops.kernels:inner')


def inner(x, y, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:inner)."""
    return _D.apply('inner', _k_inner, (x, y), {})


_k_inv = _resolve('paddle_tpu_torch.ops.kernels:inv')


def inv(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:inv)."""
    return _D.apply('inv', _k_inv, (x,), {})


_k_inverse = _resolve('paddle_tpu_torch.ops.kernels:inverse')


def inverse(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:inverse)."""
    return _D.apply('inverse', _k_inverse, (x,), {})


_k_isclose = _resolve('paddle_tpu_torch.ops.kernels:isclose')


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:isclose)."""
    return _D.apply('isclose', _k_isclose, (x, y), {'rtol': _attr(rtol), 'atol': _attr(atol), 'equal_nan': _attr(equal_nan)})


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


_k_isneginf = _resolve('paddle_tpu_torch.ops.kernels:isneginf')


def isneginf(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:isneginf)."""
    return _D.apply('isneginf', _k_isneginf, (x,), {})


_k_isposinf = _resolve('paddle_tpu_torch.ops.kernels:isposinf')


def isposinf(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:isposinf)."""
    return _D.apply('isposinf', _k_isposinf, (x,), {})


_k_isreal = _resolve('paddle_tpu_torch.ops.kernels:isreal')


def isreal(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:isreal)."""
    return _D.apply('isreal', _k_isreal, (x,), {})


_k_kl_div = _resolve('paddle_tpu_torch.ops.kernels:kl_div')


def kl_div(input, label, reduction='mean', log_target=False, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:kl_div)."""
    return _D.apply('kl_div', _k_kl_div, (input, label), {'reduction': _attr(reduction), 'log_target': _attr(log_target)})


_k_kron = _resolve('paddle_tpu_torch.ops.kernels:kron')


def kron(x, y, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:kron)."""
    return _D.apply('kron', _k_kron, (x, y), {})


_k_kthvalue = _resolve('paddle_tpu_torch.ops.kernels:kthvalue')


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:kthvalue)."""
    return _D.apply('kthvalue', _k_kthvalue, (x,), {'k': _attr(k), 'axis': _attr(axis), 'keepdim': _attr(keepdim)})


_k_l1_loss = _resolve('paddle_tpu_torch.ops.kernels:l1_loss')


def l1_loss(input, label, reduction='mean', name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:l1_loss)."""
    return _D.apply('l1_loss', _k_l1_loss, (input, label), {'reduction': _attr(reduction)})


_k_lcm = _resolve('paddle_tpu_torch.ops.kernels:lcm')


def lcm(x, y, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:lcm)."""
    return _D.apply('lcm', _k_lcm, (x, y), {})


_k_ldexp = _resolve('paddle_tpu_torch.ops.kernels:ldexp')


def ldexp(x, y, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:ldexp)."""
    return _D.apply('ldexp', _k_ldexp, (x, y), {})


_k_leaky_relu = _resolve('paddle_tpu_torch.ops.kernels:leaky_relu')


def leaky_relu(x, negative_slope=0.01, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:leaky_relu)."""
    return _D.apply('leaky_relu', _k_leaky_relu, (x,), {'negative_slope': _attr(negative_slope)})


_k_lerp = _resolve('paddle_tpu_torch.ops.kernels:lerp')


def lerp(x, y, weight, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:lerp)."""
    return _D.apply('lerp', _k_lerp, (x, y, weight), {})


_k_less_equal = _resolve('paddle_tpu_torch.ops.kernels:less_equal')


def less_equal(x, y, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:less_equal)."""
    return _D.apply('less_equal', _k_less_equal, (x, y), {})


_k_less_than = _resolve('paddle_tpu_torch.ops.kernels:less_than')


def less_than(x, y, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:less_than)."""
    return _D.apply('less_than', _k_less_than, (x, y), {})


_k_lgamma = _resolve('paddle_tpu_torch.ops.kernels:lgamma')


def lgamma(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:lgamma)."""
    return _D.apply('lgamma', _k_lgamma, (x,), {})


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


_k_log_loss = _resolve('paddle_tpu_torch.ops.kernels:log_loss')


def log_loss(input, label, epsilon=0.0001, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:log_loss)."""
    return _D.apply('log_loss', _k_log_loss, (input, label), {'epsilon': _attr(epsilon)})


_k_log_normalize = _resolve('paddle_tpu_torch.ops.kernels:log_normalize')


def log_normalize(x, axis=-1, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:log_normalize)."""
    return _D.apply('log_normalize', _k_log_normalize, (x,), {'axis': _attr(axis)})


_k_log_sigmoid = _resolve('paddle_tpu_torch.ops.kernels:log_sigmoid')


def log_sigmoid(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:log_sigmoid)."""
    return _D.apply('log_sigmoid', _k_log_sigmoid, (x,), {})


_k_log_softmax = _resolve('paddle_tpu_torch.ops.kernels:log_softmax')


def log_softmax(x, axis=-1, dtype=None, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:log_softmax)."""
    return _D.apply('log_softmax', _k_log_softmax, (x,), {'axis': _attr(axis), 'dtype': _attr(dtype)})


_k_logaddexp = _resolve('paddle_tpu_torch.ops.kernels:logaddexp')


def logaddexp(x, y, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:logaddexp)."""
    return _D.apply('logaddexp', _k_logaddexp, (x, y), {})


_k_logcumsumexp = _resolve('paddle_tpu_torch.ops.kernels:logcumsumexp')


def logcumsumexp(x, axis=None, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:logcumsumexp)."""
    return _D.apply('logcumsumexp', _k_logcumsumexp, (x,), {'axis': _attr(axis)})


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


_k_logical_xor = _resolve('paddle_tpu_torch.ops.kernels:logical_xor')


def logical_xor(x, y, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:logical_xor)."""
    return _D.apply('logical_xor', _k_logical_xor, (x, y), {})


_k_logit = _resolve('paddle_tpu_torch.ops.kernels:logit')


def logit(x, eps=None, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:logit)."""
    return _D.apply('logit', _k_logit, (x,), {'eps': _attr(eps)})


_k_logsumexp = _resolve('paddle_tpu_torch.ops.kernels:logsumexp')


def logsumexp(x, axis=None, keepdim=False, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:logsumexp)."""
    return _D.apply('logsumexp', _k_logsumexp, (x,), {'axis': _attr(axis), 'keepdim': _attr(keepdim)})


_k_margin_ranking_loss = _resolve('paddle_tpu_torch.ops.kernels:margin_ranking_loss')


def margin_ranking_loss(input, other, label, margin=0.0, reduction='mean', name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:margin_ranking_loss)."""
    return _D.apply('margin_ranking_loss', _k_margin_ranking_loss, (input, other, label), {'margin': _attr(margin), 'reduction': _attr(reduction)})


_k_masked_fill = _resolve('paddle_tpu_torch.ops.kernels:masked_fill')


def masked_fill(x, mask, value, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:masked_fill)."""
    return _D.apply('masked_fill', _k_masked_fill, (x, mask, value), {})


_k_masked_scatter = _resolve('paddle_tpu_torch.ops.kernels:masked_scatter')


def masked_scatter(x, mask, value, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:masked_scatter)."""
    return _D.apply('masked_scatter', _k_masked_scatter, (x, mask, value), {})


_k_matmul = _resolve('paddle_tpu_torch.ops.kernels:matmul')


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:matmul)."""
    return _D.apply('matmul', _k_matmul, (x, y), {'transpose_x': _attr(transpose_x), 'transpose_y': _attr(transpose_y)})


_k_matrix_exp = _resolve('paddle_tpu_torch.ops.kernels:matrix_exp')


def matrix_exp(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:matrix_exp)."""
    return _D.apply('matrix_exp', _k_matrix_exp, (x,), {})


_k_matrix_power = _resolve('paddle_tpu_torch.ops.kernels:matrix_power')


def matrix_power(x, n, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:matrix_power)."""
    return _D.apply('matrix_power', _k_matrix_power, (x,), {'n': _attr(n)})


_k_max = _resolve('paddle_tpu_torch.ops.kernels:max')


def max(x, axis=None, keepdim=False, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:max)."""
    return _D.apply('max', _k_max, (x,), {'axis': _attr(axis), 'keepdim': _attr(keepdim)})


_k_maximum = _resolve('paddle_tpu_torch.ops.kernels:maximum')


def maximum(x, y, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:maximum)."""
    return _D.apply('maximum', _k_maximum, (x, y), {})


_k_maxout = _resolve('paddle_tpu_torch.ops.kernels:maxout')


def maxout(x, groups, axis=1, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:maxout)."""
    return _D.apply('maxout', _k_maxout, (x,), {'groups': _attr(groups), 'axis': _attr(axis)})


_k_mean = _resolve('paddle_tpu_torch.ops.kernels:mean')


def mean(x, axis=None, keepdim=False, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:mean)."""
    return _D.apply('mean', _k_mean, (x,), {'axis': _attr(axis), 'keepdim': _attr(keepdim)})


_k_mean_all = _resolve('paddle_tpu_torch.ops.kernels:mean_all')


def mean_all(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:mean_all)."""
    return _D.apply('mean_all', _k_mean_all, (x,), {})


_k_median = _resolve('paddle_tpu_torch.ops.kernels:median')


def median(x, axis=None, keepdim=False, mode='avg', name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:median)."""
    return _D.apply('median', _k_median, (x,), {'axis': _attr(axis), 'keepdim': _attr(keepdim), 'mode': _attr(mode)})


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


_k_mm = _resolve('paddle_tpu_torch.ops.kernels:mm')


def mm(input, mat2, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:mm)."""
    return _D.apply('mm', _k_mm, (input, mat2), {})


_k_mod = _resolve('paddle_tpu_torch.ops.kernels:mod')


def mod(x, y, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:mod)."""
    return _D.apply('mod', _k_mod, (x, y), {})


_k_mode = _resolve('paddle_tpu_torch.ops.kernels:mode')


def mode(x, axis=-1, keepdim=False, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:mode)."""
    return _D.apply('mode', _k_mode, (x,), {'axis': _attr(axis), 'keepdim': _attr(keepdim)})


_k_moveaxis = _resolve('paddle_tpu_torch.ops.kernels:moveaxis')


def moveaxis(x, source, destination, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:moveaxis)."""
    return _D.apply('moveaxis', _k_moveaxis, (x,), {'source': _attr(source), 'destination': _attr(destination)})


_k_mse_loss = _resolve('paddle_tpu_torch.ops.kernels:mse_loss')


def mse_loss(input, label, reduction='mean', name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:mse_loss)."""
    return _D.apply('mse_loss', _k_mse_loss, (input, label), {'reduction': _attr(reduction)})


_k_multi_dot = _resolve('paddle_tpu_torch.ops.kernels:multi_dot')


def multi_dot(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:multi_dot)."""
    return _D.apply('multi_dot', _k_multi_dot, tuple(x), {})


_k_multi_label_soft_margin_loss = _resolve('paddle_tpu_torch.ops.kernels:multi_label_soft_margin_loss')


def multi_label_soft_margin_loss(input, label, weight=None, reduction='mean', name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:multi_label_soft_margin_loss)."""
    _t = (input, label) + tuple(t for t in (weight,) if t is not None)
    return _D.apply('multi_label_soft_margin_loss', _k_multi_label_soft_margin_loss, _t, {'reduction': _attr(reduction), '_has_weight': weight is not None})


_k_multi_margin_loss = _resolve('paddle_tpu_torch.ops.kernels:multi_margin_loss')


def multi_margin_loss(input, label, p=1, margin=1.0, weight=None, reduction='mean', name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:multi_margin_loss)."""
    _t = (input, label) + tuple(t for t in (weight,) if t is not None)
    return _D.apply('multi_margin_loss', _k_multi_margin_loss, _t, {'p': _attr(p), 'margin': _attr(margin), 'reduction': _attr(reduction), '_has_weight': weight is not None})


_k_multigammaln = _resolve('paddle_tpu_torch.ops.kernels:multigammaln')


def multigammaln(x, p, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:multigammaln)."""
    return _D.apply('multigammaln', _k_multigammaln, (x,), {'p': _attr(p)})


_k_multiply = _resolve('paddle_tpu_torch.ops.kernels:multiply')


def multiply(x, y, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:multiply)."""
    return _D.apply('multiply', _k_multiply, (x, y), {})


_k_mv = _resolve('paddle_tpu_torch.ops.kernels:mv')


def mv(x, vec, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:mv)."""
    return _D.apply('mv', _k_mv, (x, vec), {})


_k_nan_to_num = _resolve('paddle_tpu_torch.ops.kernels:nan_to_num')


def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:nan_to_num)."""
    return _D.apply('nan_to_num', _k_nan_to_num, (x,), {'nan': _attr(nan), 'posinf': _attr(posinf), 'neginf': _attr(neginf)})


_k_nanmean = _resolve('paddle_tpu_torch.ops.kernels:nanmean')


def nanmean(x, axis=None, keepdim=False, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:nanmean)."""
    return _D.apply('nanmean', _k_nanmean, (x,), {'axis': _attr(axis), 'keepdim': _attr(keepdim)})


_k_nanmedian = _resolve('paddle_tpu_torch.ops.kernels:nanmedian')


def nanmedian(x, axis=None, keepdim=False, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:nanmedian)."""
    return _D.apply('nanmedian', _k_nanmedian, (x,), {'axis': _attr(axis), 'keepdim': _attr(keepdim)})


_k_nanquantile = _resolve('paddle_tpu_torch.ops.kernels:nanquantile')


def nanquantile(x, q, axis=None, keepdim=False, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:nanquantile)."""
    return _D.apply('nanquantile', _k_nanquantile, (x,), {'q': _attr(q), 'axis': _attr(axis), 'keepdim': _attr(keepdim)})


_k_nansum = _resolve('paddle_tpu_torch.ops.kernels:nansum')


def nansum(x, axis=None, dtype=None, keepdim=False, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:nansum)."""
    return _D.apply('nansum', _k_nansum, (x,), {'axis': _attr(axis), 'dtype': _attr(dtype), 'keepdim': _attr(keepdim)})


_k_neg = _resolve('paddle_tpu_torch.ops.kernels:neg')


def neg(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:neg)."""
    return _D.apply('neg', _k_neg, (x,), {})


_k_nextafter = _resolve('paddle_tpu_torch.ops.kernels:nextafter')


def nextafter(x, y, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:nextafter)."""
    return _D.apply('nextafter', _k_nextafter, (x, y), {})


_k_nll_loss = _resolve('paddle_tpu_torch.ops.kernels:nll_loss')


def nll_loss(input, label, weight=None, ignore_index=-100, reduction='mean', name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:nll_loss)."""
    _t = (input, label) + tuple(t for t in (weight,) if t is not None)
    return _D.apply('nll_loss', _k_nll_loss, _t, {'ignore_index': _attr(ignore_index), 'reduction': _attr(reduction), '_has_weight': weight is not None})


_k_not_equal = _resolve('paddle_tpu_torch.ops.kernels:not_equal')


def not_equal(x, y, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:not_equal)."""
    return _D.apply('not_equal', _k_not_equal, (x, y), {})


_k_numel = _resolve('paddle_tpu_torch.ops.kernels:numel')


def numel(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:numel)."""
    return _D.apply('numel', _k_numel, (x,), {})


_k_one_hot = _resolve('paddle_tpu_torch.ops.kernels:one_hot')


def one_hot(x, num_classes, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:one_hot)."""
    return _D.apply('one_hot', _k_one_hot, (x,), {'num_classes': _attr(num_classes)})


_k_outer = _resolve('paddle_tpu_torch.ops.kernels:outer')


def outer(x, y, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:outer)."""
    return _D.apply('outer', _k_outer, (x, y), {})


_k_pad = _resolve('paddle_tpu_torch.ops.kernels:pad')


def pad(x, pad, mode='constant', value=0.0, data_format='NCHW', pad_from_left_axis=True, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:pad)."""
    return _D.apply('pad', _k_pad, (x,), {'pad': _attr(pad), 'mode': _attr(mode), 'value': _attr(value), 'data_format': _attr(data_format), 'pad_from_left_axis': _attr(pad_from_left_axis)})


_k_pdist = _resolve('paddle_tpu_torch.ops.kernels:pdist')


def pdist(x, p=2.0, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:pdist)."""
    return _D.apply('pdist', _k_pdist, (x,), {'p': _attr(p)})


_k_pinv = _resolve('paddle_tpu_torch.ops.kernels:pinv')


def pinv(x, rcond=1e-15, hermitian=False, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:pinv)."""
    return _D.apply('pinv', _k_pinv, (x,), {'rcond': _attr(rcond), 'hermitian': _attr(hermitian)})


_k_poisson_nll_loss = _resolve('paddle_tpu_torch.ops.kernels:poisson_nll_loss')


def poisson_nll_loss(input, label, log_input=True, full=False, epsilon=1e-08, reduction='mean', name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:poisson_nll_loss)."""
    return _D.apply('poisson_nll_loss', _k_poisson_nll_loss, (input, label), {'log_input': _attr(log_input), 'full': _attr(full), 'epsilon': _attr(epsilon), 'reduction': _attr(reduction)})


_k_polygamma = _resolve('paddle_tpu_torch.ops.kernels:polygamma')


def polygamma(x, n=1, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:polygamma)."""
    return _D.apply('polygamma', _k_polygamma, (x,), {'n': _attr(n)})


_k_pow = _resolve('paddle_tpu_torch.ops.kernels:pow')


def pow(x, y, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:pow)."""
    return _D.apply('pow', _k_pow, (x, y), {})


_k_prelu = _resolve('paddle_tpu_torch.ops.kernels:prelu')


def prelu(x, weight, data_format='NCHW', name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:prelu)."""
    return _D.apply('prelu', _k_prelu, (x, weight), {'data_format': _attr(data_format)})


_k_prod = _resolve('paddle_tpu_torch.ops.kernels:prod')


def prod(x, axis=None, keepdim=False, dtype=None, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:prod)."""
    return _D.apply('prod', _k_prod, (x,), {'axis': _attr(axis), 'keepdim': _attr(keepdim), 'dtype': _attr(dtype)})


_k_put_along_axis = _resolve('paddle_tpu_torch.ops.kernels:put_along_axis')


def put_along_axis(arr, indices, values, axis, reduce='assign', include_self=True, broadcast=True, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:put_along_axis)."""
    return _D.apply('put_along_axis', _k_put_along_axis, (arr, indices, values), {'axis': _attr(axis), 'reduce': _attr(reduce), 'include_self': _attr(include_self), 'broadcast': _attr(broadcast)})


_k_qr = _resolve('paddle_tpu_torch.ops.kernels:qr')


def qr(x, mode='reduced', name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:qr)."""
    return _D.apply('qr', _k_qr, (x,), {'mode': _attr(mode)})


_k_quantile = _resolve('paddle_tpu_torch.ops.kernels:quantile')


def quantile(x, q, axis=None, keepdim=False, interpolation='linear', name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:quantile)."""
    return _D.apply('quantile', _k_quantile, (x,), {'q': _attr(q), 'axis': _attr(axis), 'keepdim': _attr(keepdim), 'interpolation': _attr(interpolation)})


_k_rad2deg = _resolve('paddle_tpu_torch.ops.kernels:rad2deg')


def rad2deg(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:rad2deg)."""
    return _D.apply('rad2deg', _k_rad2deg, (x,), {})


_k_real = _resolve('paddle_tpu_torch.ops.kernels:real')


def real(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:real)."""
    return _D.apply('real', _k_real, (x,), {})


_k_reciprocal = _resolve('paddle_tpu_torch.ops.kernels:reciprocal')


def reciprocal(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:reciprocal)."""
    return _D.apply('reciprocal', _k_reciprocal, (x,), {})


_k_reduce_as = _resolve('paddle_tpu_torch.ops.kernels:reduce_as')


def reduce_as(x, target, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:reduce_as)."""
    return _D.apply('reduce_as', _k_reduce_as, (x, target), {})


_k_relu = _resolve('paddle_tpu_torch.ops.kernels:relu')


def relu(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:relu)."""
    return _D.apply('relu', _k_relu, (x,), {})


_k_relu6 = _resolve('paddle_tpu_torch.ops.kernels:relu6')


def relu6(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:relu6)."""
    return _D.apply('relu6', _k_relu6, (x,), {})


_k_remainder = _resolve('paddle_tpu_torch.ops.kernels:remainder')


def remainder(x, y, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:remainder)."""
    return _D.apply('remainder', _k_remainder, (x, y), {})


_k_renorm = _resolve('paddle_tpu_torch.ops.kernels:renorm')


def renorm(x, p, axis, max_norm, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:renorm)."""
    return _D.apply('renorm', _k_renorm, (x,), {'p': _attr(p), 'axis': _attr(axis), 'max_norm': _attr(max_norm)})


_k_repeat_interleave = _resolve('paddle_tpu_torch.ops.kernels:repeat_interleave')


def repeat_interleave(x, repeats, axis=None, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:repeat_interleave)."""
    return _D.apply('repeat_interleave', _k_repeat_interleave, (x,), {'repeats': _attr(repeats), 'axis': _attr(axis)})


_k_reshape = _resolve('paddle_tpu_torch.ops.kernels:reshape')


def reshape(x, shape, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:reshape)."""
    return _D.apply('reshape', _k_reshape, (x,), {'shape': _attr(shape)})


_k_reverse = _resolve('paddle_tpu_torch.ops.kernels:reverse')


def reverse(x, axis, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:reverse)."""
    return _D.apply('reverse', _k_reverse, (x,), {'axis': _attr(axis)})


_k_roll = _resolve('paddle_tpu_torch.ops.kernels:roll')


def roll(x, shifts, axis=None, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:roll)."""
    return _D.apply('roll', _k_roll, (x,), {'shifts': _attr(shifts), 'axis': _attr(axis)})


_k_rot90 = _resolve('paddle_tpu_torch.ops.kernels:rot90')


def rot90(x, k=1, axes=(0, 1), name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:rot90)."""
    return _D.apply('rot90', _k_rot90, (x,), {'k': _attr(k), 'axes': _attr(axes)})


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


_k_scatter = _resolve('paddle_tpu_torch.ops.kernels:scatter')


def scatter(x, index, updates, overwrite=True, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:scatter)."""
    return _D.apply('scatter', _k_scatter, (x, index, updates), {'overwrite': _attr(overwrite)})


_k_scatter_nd = _resolve('paddle_tpu_torch.ops.kernels:scatter_nd')


def scatter_nd(index, updates, shape, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:scatter_nd)."""
    return _D.apply('scatter_nd', _k_scatter_nd, (index, updates), {'shape': _attr(shape)})


_k_scatter_nd_add = _resolve('paddle_tpu_torch.ops.kernels:scatter_nd_add')


def scatter_nd_add(x, index, updates, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:scatter_nd_add)."""
    return _D.apply('scatter_nd_add', _k_scatter_nd_add, (x, index, updates), {})


_k_searchsorted = _resolve('paddle_tpu_torch.ops.kernels:searchsorted')


def searchsorted(sorted_sequence, values, out_int32=False, right=False, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:searchsorted)."""
    return _D.apply('searchsorted', _k_searchsorted, (sorted_sequence, values), {'out_int32': _attr(out_int32), 'right': _attr(right)})


_k_select_scatter = _resolve('paddle_tpu_torch.ops.kernels:select_scatter')


def select_scatter(x, values, axis, index, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:select_scatter)."""
    return _D.apply('select_scatter', _k_select_scatter, (x, values), {'axis': _attr(axis), 'index': _attr(index)})


_k_selu = _resolve('paddle_tpu_torch.ops.kernels:selu')


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:selu)."""
    return _D.apply('selu', _k_selu, (x,), {'scale': _attr(scale), 'alpha': _attr(alpha)})


_k_sgn = _resolve('paddle_tpu_torch.ops.kernels:sgn')


def sgn(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:sgn)."""
    return _D.apply('sgn', _k_sgn, (x,), {})


_k_shard_index = _resolve('paddle_tpu_torch.ops.kernels:shard_index')


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:shard_index)."""
    return _D.apply('shard_index', _k_shard_index, (input,), {'index_num': _attr(index_num), 'nshards': _attr(nshards), 'shard_id': _attr(shard_id), 'ignore_value': _attr(ignore_value)})


_k_sigmoid = _resolve('paddle_tpu_torch.ops.kernels:sigmoid')


def sigmoid(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:sigmoid)."""
    return _D.apply('sigmoid', _k_sigmoid, (x,), {})


_k_sigmoid_focal_loss = _resolve('paddle_tpu_torch.ops.kernels:sigmoid_focal_loss')


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0, reduction='sum', name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:sigmoid_focal_loss)."""
    _t = (logit, label) + tuple(t for t in (normalizer,) if t is not None)
    return _D.apply('sigmoid_focal_loss', _k_sigmoid_focal_loss, _t, {'alpha': _attr(alpha), 'gamma': _attr(gamma), 'reduction': _attr(reduction), '_has_normalizer': normalizer is not None})


_k_sign = _resolve('paddle_tpu_torch.ops.kernels:sign')


def sign(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:sign)."""
    return _D.apply('sign', _k_sign, (x,), {})


_k_signbit = _resolve('paddle_tpu_torch.ops.kernels:signbit')


def signbit(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:signbit)."""
    return _D.apply('signbit', _k_signbit, (x,), {})


_k_silu = _resolve('paddle_tpu_torch.ops.kernels:silu')


def silu(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:silu)."""
    return _D.apply('silu', _k_silu, (x,), {})


_k_sin = _resolve('paddle_tpu_torch.ops.kernels:sin')


def sin(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:sin)."""
    return _D.apply('sin', _k_sin, (x,), {})


_k_sinc = _resolve('paddle_tpu_torch.ops.kernels:sinc')


def sinc(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:sinc)."""
    return _D.apply('sinc', _k_sinc, (x,), {})


_k_sinh = _resolve('paddle_tpu_torch.ops.kernels:sinh')


def sinh(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:sinh)."""
    return _D.apply('sinh', _k_sinh, (x,), {})


_k_slice_scatter = _resolve('paddle_tpu_torch.ops.kernels:slice_scatter')


def slice_scatter(x, value, axes, starts, ends, strides, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:slice_scatter)."""
    return _D.apply('slice_scatter', _k_slice_scatter, (x, value), {'axes': _attr(axes), 'starts': _attr(starts), 'ends': _attr(ends), 'strides': _attr(strides)})


_k_slogdet = _resolve('paddle_tpu_torch.ops.kernels:slogdet')


def slogdet(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:slogdet)."""
    return _D.apply('slogdet', _k_slogdet, (x,), {})


_k_smooth_l1_loss = _resolve('paddle_tpu_torch.ops.kernels:smooth_l1_loss')


def smooth_l1_loss(input, label, reduction='mean', delta=1.0, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:smooth_l1_loss)."""
    return _D.apply('smooth_l1_loss', _k_smooth_l1_loss, (input, label), {'reduction': _attr(reduction), 'delta': _attr(delta)})


_k_soft_margin_loss = _resolve('paddle_tpu_torch.ops.kernels:soft_margin_loss')


def soft_margin_loss(input, label, reduction='mean', name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:soft_margin_loss)."""
    return _D.apply('soft_margin_loss', _k_soft_margin_loss, (input, label), {'reduction': _attr(reduction)})


_k_softmax = _resolve('paddle_tpu_torch.ops.kernels:softmax')


def softmax(x, axis=-1, dtype=None, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:softmax)."""
    return _D.apply('softmax', _k_softmax, (x,), {'axis': _attr(axis), 'dtype': _attr(dtype)})


_k_softplus = _resolve('paddle_tpu_torch.ops.kernels:softplus')


def softplus(x, beta=1.0, threshold=20.0, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:softplus)."""
    return _D.apply('softplus', _k_softplus, (x,), {'beta': _attr(beta), 'threshold': _attr(threshold)})


_k_softshrink = _resolve('paddle_tpu_torch.ops.kernels:softshrink')


def softshrink(x, threshold=0.5, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:softshrink)."""
    return _D.apply('softshrink', _k_softshrink, (x,), {'threshold': _attr(threshold)})


_k_softsign = _resolve('paddle_tpu_torch.ops.kernels:softsign')


def softsign(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:softsign)."""
    return _D.apply('softsign', _k_softsign, (x,), {})


_k_solve = _resolve('paddle_tpu_torch.ops.kernels:solve')


def solve(x, y, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:solve)."""
    return _D.apply('solve', _k_solve, (x, y), {})


_k_sort = _resolve('paddle_tpu_torch.ops.kernels:sort')


def sort(x, axis=-1, descending=False, stable=False, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:sort)."""
    return _D.apply('sort', _k_sort, (x,), {'axis': _attr(axis), 'descending': _attr(descending), 'stable': _attr(stable)})


_k_sqrt = _resolve('paddle_tpu_torch.ops.kernels:sqrt')


def sqrt(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:sqrt)."""
    return _D.apply('sqrt', _k_sqrt, (x,), {})


_k_square = _resolve('paddle_tpu_torch.ops.kernels:square')


def square(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:square)."""
    return _D.apply('square', _k_square, (x,), {})


_k_square_error_cost = _resolve('paddle_tpu_torch.ops.kernels:square_error_cost')


def square_error_cost(input, label):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:square_error_cost)."""
    return _D.apply('square_error_cost', _k_square_error_cost, (input, label), {})


_k_squared_l2_norm = _resolve('paddle_tpu_torch.ops.kernels:squared_l2_norm')


def squared_l2_norm(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:squared_l2_norm)."""
    return _D.apply('squared_l2_norm', _k_squared_l2_norm, (x,), {})


_k_squeeze = _resolve('paddle_tpu_torch.ops.kernels:squeeze')


def squeeze(x, axis=None, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:squeeze)."""
    return _D.apply('squeeze', _k_squeeze, (x,), {'axis': _attr(axis)})


_k_stack = _resolve('paddle_tpu_torch.ops.kernels:stack')


def stack(x, axis=0, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:stack)."""
    return _D.apply('stack', _k_stack, tuple(x), {'axis': _attr(axis)})


_k_stanh = _resolve('paddle_tpu_torch.ops.kernels:stanh')


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:stanh)."""
    return _D.apply('stanh', _k_stanh, (x,), {'scale_a': _attr(scale_a), 'scale_b': _attr(scale_b)})


_k_std = _resolve('paddle_tpu_torch.ops.kernels:std')


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:std)."""
    return _D.apply('std', _k_std, (x,), {'axis': _attr(axis), 'unbiased': _attr(unbiased), 'keepdim': _attr(keepdim)})


_k_strided_slice = _resolve('paddle_tpu_torch.ops.kernels:strided_slice')


def strided_slice(x, axes, starts, ends, strides, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:strided_slice)."""
    return _D.apply('strided_slice', _k_strided_slice, (x,), {'axes': _attr(axes), 'starts': _attr(starts), 'ends': _attr(ends), 'strides': _attr(strides)})


_k_subtract = _resolve('paddle_tpu_torch.ops.kernels:subtract')


def subtract(x, y, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:subtract)."""
    return _D.apply('subtract', _k_subtract, (x, y), {})


_k_sum = _resolve('paddle_tpu_torch.ops.kernels:sum')


def sum(x, axis=None, dtype=None, keepdim=False, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:sum)."""
    return _D.apply('sum', _k_sum, (x,), {'axis': _attr(axis), 'dtype': _attr(dtype), 'keepdim': _attr(keepdim)})


_k_svd = _resolve('paddle_tpu_torch.ops.kernels:svd')


def svd(x, full_matrices=False, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:svd)."""
    return _D.apply('svd', _k_svd, (x,), {'full_matrices': _attr(full_matrices)})


_k_svdvals = _resolve('paddle_tpu_torch.ops.kernels:svdvals')


def svdvals(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:svdvals)."""
    return _D.apply('svdvals', _k_svdvals, (x,), {})


_k_swapaxes = _resolve('paddle_tpu_torch.ops.kernels:swapaxes')


def swapaxes(x, axis1, axis2, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:swapaxes)."""
    return _D.apply('swapaxes', _k_swapaxes, (x,), {'axis1': _attr(axis1), 'axis2': _attr(axis2)})


_k_swish = _resolve('paddle_tpu_torch.ops.kernels:swish')


def swish(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:swish)."""
    return _D.apply('swish', _k_swish, (x,), {})


_k_take = _resolve('paddle_tpu_torch.ops.kernels:take')


def take(x, index, mode='raise', name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:take)."""
    return _D.apply('take', _k_take, (x, index), {'mode': _attr(mode)})


_k_take_along_axis = _resolve('paddle_tpu_torch.ops.kernels:take_along_axis')


def take_along_axis(arr, indices, axis, broadcast=True, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:take_along_axis)."""
    return _D.apply('take_along_axis', _k_take_along_axis, (arr, indices), {'axis': _attr(axis), 'broadcast': _attr(broadcast)})


_k_tan = _resolve('paddle_tpu_torch.ops.kernels:tan')


def tan(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:tan)."""
    return _D.apply('tan', _k_tan, (x,), {})


_k_tanh = _resolve('paddle_tpu_torch.ops.kernels:tanh')


def tanh(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:tanh)."""
    return _D.apply('tanh', _k_tanh, (x,), {})


_k_tanhshrink = _resolve('paddle_tpu_torch.ops.kernels:tanhshrink')


def tanhshrink(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:tanhshrink)."""
    return _D.apply('tanhshrink', _k_tanhshrink, (x,), {})


_k_temporal_shift = _resolve('paddle_tpu_torch.ops.kernels:temporal_shift')


def temporal_shift(x, seg_num, shift_ratio=0.25, data_format='NCHW', name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:temporal_shift)."""
    return _D.apply('temporal_shift', _k_temporal_shift, (x,), {'seg_num': _attr(seg_num), 'shift_ratio': _attr(shift_ratio), 'data_format': _attr(data_format)})


_k_tensordot = _resolve('paddle_tpu_torch.ops.kernels:tensordot')


def tensordot(x, y, axes=2, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:tensordot)."""
    return _D.apply('tensordot', _k_tensordot, (x, y), {'axes': _attr(axes)})


_k_thresholded_relu = _resolve('paddle_tpu_torch.ops.kernels:thresholded_relu')


def thresholded_relu(x, threshold=1.0, value=0.0, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:thresholded_relu)."""
    return _D.apply('thresholded_relu', _k_thresholded_relu, (x,), {'threshold': _attr(threshold), 'value': _attr(value)})


_k_tile = _resolve('paddle_tpu_torch.ops.kernels:tile')


def tile(x, repeat_times, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:tile)."""
    return _D.apply('tile', _k_tile, (x,), {'repeat_times': _attr(repeat_times)})


_k_topk = _resolve('paddle_tpu_torch.ops.kernels:topk')


def topk(x, k, axis=-1, largest=True, sorted=True, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:topk)."""
    return _D.apply('topk', _k_topk, (x,), {'k': _attr(k), 'axis': _attr(axis), 'largest': _attr(largest), 'sorted': _attr(sorted)})


_k_trace = _resolve('paddle_tpu_torch.ops.kernels:trace')


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:trace)."""
    return _D.apply('trace', _k_trace, (x,), {'offset': _attr(offset), 'axis1': _attr(axis1), 'axis2': _attr(axis2)})


_k_transpose = _resolve('paddle_tpu_torch.ops.kernels:transpose')


def transpose(x, perm=None, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:transpose)."""
    return _D.apply('transpose', _k_transpose, (x,), {'perm': _attr(perm)})


_k_trapezoid = _resolve('paddle_tpu_torch.ops.kernels:trapezoid')


def trapezoid(y, x=None, dx=1.0, axis=-1, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:trapezoid)."""
    _t = (y,) + tuple(t for t in (x,) if t is not None)
    return _D.apply('trapezoid', _k_trapezoid, _t, {'dx': _attr(dx), 'axis': _attr(axis), '_has_x': x is not None})


_k_triangular_solve = _resolve('paddle_tpu_torch.ops.kernels:triangular_solve')


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:triangular_solve)."""
    return _D.apply('triangular_solve', _k_triangular_solve, (x, y), {'upper': _attr(upper), 'transpose': _attr(transpose), 'unitriangular': _attr(unitriangular)})


_k_triplet_margin_loss = _resolve('paddle_tpu_torch.ops.kernels:triplet_margin_loss')


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0, epsilon=1e-06, swap=False, reduction='mean', name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:triplet_margin_loss)."""
    return _D.apply('triplet_margin_loss', _k_triplet_margin_loss, (input, positive, negative), {'margin': _attr(margin), 'p': _attr(p), 'epsilon': _attr(epsilon), 'swap': _attr(swap), 'reduction': _attr(reduction)})


_k_trunc = _resolve('paddle_tpu_torch.ops.kernels:trunc')


def trunc(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:trunc)."""
    return _D.apply('trunc', _k_trunc, (x,), {})


_k_unflatten = _resolve('paddle_tpu_torch.ops.kernels:unflatten')


def unflatten(x, axis, shape, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:unflatten)."""
    return _D.apply('unflatten', _k_unflatten, (x,), {'axis': _attr(axis), 'shape': _attr(shape)})


_k_unsqueeze = _resolve('paddle_tpu_torch.ops.kernels:unsqueeze')


def unsqueeze(x, axis, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:unsqueeze)."""
    return _D.apply('unsqueeze', _k_unsqueeze, (x,), {'axis': _attr(axis)})


_k_vander = _resolve('paddle_tpu_torch.ops.kernels:vander')


def vander(x, n=None, increasing=False, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:vander)."""
    return _D.apply('vander', _k_vander, (x,), {'n': _attr(n), 'increasing': _attr(increasing)})


_k_var = _resolve('paddle_tpu_torch.ops.kernels:var')


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:var)."""
    return _D.apply('var', _k_var, (x,), {'axis': _attr(axis), 'unbiased': _attr(unbiased), 'keepdim': _attr(keepdim)})


_k_vstack = _resolve('paddle_tpu_torch.ops.kernels:vstack')


def vstack(x, name=None):
    """Generated from ops.yaml (kernel paddle_tpu_torch.ops.kernels:vstack)."""
    return _D.apply('vstack', _k_vstack, tuple(x), {})


def _attr(v):
    # lists become tuples; Tensor-valued shape/axis attrs
    # (legal in the reference API) are read back to host
    if isinstance(v, (list, tuple)):
        return tuple(_attr(e) for e in v)
    if isinstance(v, (_Tensor, _np.ndarray)):
        return _attr(v.tolist())
    return v


__all__ = ['abs', 'acos', 'acosh', 'add', 'addmm', 'all', 'allclose', 'amax', 'amin', 'angle', 'any', 'argmax', 'argmin', 'argsort', 'as_complex', 'as_real', 'asin', 'asinh', 'atan', 'atan2', 'atanh', 'binary_cross_entropy', 'binary_cross_entropy_with_logits', 'bitwise_and', 'bitwise_left_shift', 'bitwise_not', 'bitwise_or', 'bitwise_right_shift', 'bitwise_xor', 'bmm', 'broadcast_to', 'bucketize', 'cast', 'cdist', 'ceil', 'celu', 'cholesky', 'cholesky_inverse', 'cholesky_solve', 'clip', 'clip_by_norm', 'combinations', 'concat', 'conj', 'copysign', 'corrcoef', 'cos', 'cosh', 'cosine_embedding_loss', 'count_nonzero', 'cov', 'crop', 'cross', 'cross_entropy', 'cummax', 'cummin', 'cumprod', 'cumsum', 'cumulative_trapezoid', 'deg2rad', 'det', 'diag_embed', 'diagonal', 'diagonal_scatter', 'dice_loss', 'diff', 'digamma', 'dist', 'divide', 'dot', 'dstack', 'eigh', 'eigvalsh', 'elu', 'equal', 'equal_all', 'erf', 'erfinv', 'exp', 'expand', 'expand_as', 'expm1', 'fill_diagonal', 'fill_diagonal_tensor', 'flatten', 'flip', 'fliplr', 'flipud', 'float_power', 'floor', 'floor_divide', 'fmax', 'fmin', 'frac', 'frobenius_norm', 'gammainc', 'gammaincc', 'gammaln', 'gather', 'gather_nd', 'gaussian_nll_loss', 'gcd', 'gelu', 'glu', 'greater_equal', 'greater_than', 'hardshrink', 'hardsigmoid', 'hardswish', 'hardtanh', 'heaviside', 'hinge_embedding_loss', 'histogram', 'hstack', 'hypot', 'i0', 'i0e', 'i1', 'i1e', 'imag', 'index_add', 'index_fill', 'index_sample', 'index_select', 'inner', 'inv', 'inverse', 'isclose', 'isfinite', 'isinf', 'isnan', 'isneginf', 'isposinf', 'isreal', 'kl_div', 'kron', 'kthvalue', 'l1_loss', 'lcm', 'ldexp', 'leaky_relu', 'lerp', 'less_equal', 'less_than', 'lgamma', 'log', 'log10', 'log1p', 'log2', 'log_loss', 'log_normalize', 'log_sigmoid', 'log_softmax', 'logaddexp', 'logcumsumexp', 'logical_and', 'logical_not', 'logical_or', 'logical_xor', 'logit', 'logsumexp', 'margin_ranking_loss', 'masked_fill', 'masked_scatter', 'matmul', 'matrix_exp', 'matrix_power', 'max', 'maximum', 'maxout', 'mean', 'mean_all', 'median', 'min', 'minimum', 'mish', 'mm', 'mod', 'mode', 'moveaxis', 'mse_loss', 'multi_dot', 'multi_label_soft_margin_loss', 'multi_margin_loss', 'multigammaln', 'multiply', 'mv', 'nan_to_num', 'nanmean', 'nanmedian', 'nanquantile', 'nansum', 'neg', 'nextafter', 'nll_loss', 'not_equal', 'numel', 'one_hot', 'outer', 'pad', 'pdist', 'pinv', 'poisson_nll_loss', 'polygamma', 'pow', 'prelu', 'prod', 'put_along_axis', 'qr', 'quantile', 'rad2deg', 'real', 'reciprocal', 'reduce_as', 'relu', 'relu6', 'remainder', 'renorm', 'repeat_interleave', 'reshape', 'reverse', 'roll', 'rot90', 'round', 'rsqrt', 'scale', 'scatter', 'scatter_nd', 'scatter_nd_add', 'searchsorted', 'select_scatter', 'selu', 'sgn', 'shard_index', 'sigmoid', 'sigmoid_focal_loss', 'sign', 'signbit', 'silu', 'sin', 'sinc', 'sinh', 'slice_scatter', 'slogdet', 'smooth_l1_loss', 'soft_margin_loss', 'softmax', 'softplus', 'softshrink', 'softsign', 'solve', 'sort', 'sqrt', 'square', 'square_error_cost', 'squared_l2_norm', 'squeeze', 'stack', 'stanh', 'std', 'strided_slice', 'subtract', 'sum', 'svd', 'svdvals', 'swapaxes', 'swish', 'take', 'take_along_axis', 'tan', 'tanh', 'tanhshrink', 'temporal_shift', 'tensordot', 'thresholded_relu', 'tile', 'topk', 'trace', 'transpose', 'trapezoid', 'triangular_solve', 'triplet_margin_loss', 'trunc', 'unflatten', 'unsqueeze', 'vander', 'var', 'vstack']
