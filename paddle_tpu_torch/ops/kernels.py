"""torch kernels for the kernel-driven schema ops the port has so far
(counterpart of paddle_tpu/ops/kernels.py).

Adding an op = its ``ops.yaml`` entry (already there, copied from the JAX
package) + its torch function here; then ``python -m
paddle_tpu_torch.codegen`` regenerates the public wrapper, the registry,
the Tensor-method binding and the typing stub.  The generator emits only
the ops whose kernel this module defines.

Kernels take torch tensors (the dispatcher unwraps Tensors; Python
scalars arrive as 0-d CPU tensors) plus the schema's other arguments as
keywords, and return torch tensors.  Each repeats its JAX kernel's
algebra term for term; promotion follows torch, which matches JAX's for
the weak-typed scalars the JAX package passes.
"""
from __future__ import annotations

import builtins as _b   # sum / max / min / abs / round are ops here
import itertools as _it
import math as _math

import torch
import torch.nn.functional as _F


def _axis_t(axis):
    if axis is None:
        return None
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def _dims(x, axis):
    """torch's dim argument for a reduction over ``axis`` (all when None)."""
    a = _axis_t(axis)
    if a is None:
        return tuple(range(x.dim()))
    return a


def _maybe_cast(x, dtype):
    return x if dtype is None else cast(x, dtype)


def _expand_shape(cur, tgt):
    full, pad = [], len(tgt) - len(cur)
    for i, s in enumerate(tgt):
        if s == -1:
            full.append(cur[i - pad] if i >= pad else 1)
        else:
            full.append(int(s))
    return tuple(full)


def _reduce_loss(out, reduction):
    if reduction == "mean":
        return torch.mean(out)
    if reduction == "sum":
        return torch.sum(out)
    return out


def _float(x):
    return x if x.is_floating_point() or x.is_complex() else x.float()


# -- unary elementwise ------------------------------------------------------
def abs(x): return torch.abs(x)                                 # noqa: E704
def neg(x): return torch.neg(x)                                 # noqa: E704
def exp(x): return torch.exp(_float(x))                         # noqa: E704
def expm1(x): return torch.expm1(_float(x))                     # noqa: E704
def log(x): return torch.log(_float(x))                         # noqa: E704
def log2(x): return torch.log2(_float(x))                       # noqa: E704
def log10(x): return torch.log10(_float(x))                     # noqa: E704
def log1p(x): return torch.log1p(_float(x))                     # noqa: E704
def sqrt(x): return torch.sqrt(_float(x))                       # noqa: E704
def rsqrt(x): return torch.rsqrt(_float(x))                     # noqa: E704
def square(x): return torch.square(x)                           # noqa: E704
def sin(x): return torch.sin(_float(x))                         # noqa: E704
def cos(x): return torch.cos(_float(x))                         # noqa: E704
def tan(x): return torch.tan(_float(x))                         # noqa: E704
def tanh(x): return torch.tanh(_float(x))                       # noqa: E704
def floor(x): return torch.floor(x)                             # noqa: E704
def ceil(x): return torch.ceil(x)                               # noqa: E704
def round(x, decimals=0):                                       # noqa: E704
    return torch.round(x, decimals=int(decimals))
def trunc(x): return torch.trunc(x)                             # noqa: E704
def sign(x): return torch.sign(x)                               # noqa: E704
def reciprocal(x): return torch.reciprocal(_float(x))           # noqa: E704
def erf(x): return torch.erf(_float(x))                         # noqa: E704
def isnan(x): return torch.isnan(x)                             # noqa: E704
def isinf(x): return torch.isinf(x)                             # noqa: E704
def isfinite(x): return torch.isfinite(x)                       # noqa: E704
def logical_not(x): return torch.logical_not(x)                 # noqa: E704


# -- binary elementwise -----------------------------------------------------
def add(x, y): return torch.add(x, y)                           # noqa: E704
def subtract(x, y): return torch.sub(x, y)                      # noqa: E704
def multiply(x, y): return torch.mul(x, y)                      # noqa: E704
def divide(x, y): return torch.true_divide(x, y)                # noqa: E704
def pow(x, y): return torch.pow(x, y)                           # noqa: E704
def floor_divide(x, y): return _FloorDivide.apply(x, y)          # noqa: E704
def mod(x, y): return torch.remainder(x, y)                     # noqa: E704
def maximum(x, y): return torch.maximum(*_same_dev(x, y))       # noqa: E704
def minimum(x, y): return torch.minimum(*_same_dev(x, y))       # noqa: E704
def greater_than(x, y): return torch.gt(x, y)                   # noqa: E704
def less_than(x, y): return torch.lt(x, y)                      # noqa: E704
def greater_equal(x, y): return torch.ge(x, y)                  # noqa: E704
def less_equal(x, y): return torch.le(x, y)                     # noqa: E704
def equal(x, y): return torch.eq(x, y)                          # noqa: E704
def not_equal(x, y): return torch.ne(x, y)                      # noqa: E704
def logical_and(x, y): return torch.logical_and(x, y)           # noqa: E704
def logical_or(x, y): return torch.logical_or(x, y)             # noqa: E704


class _FloorDivide(torch.autograd.Function):
    """floor_divide with the JAX package's zero gradient (ATen has none)."""

    @staticmethod
    def forward(ctx, x, y):
        ctx.metas = [(t.shape, t.dtype, t.device) for t in (x, y)]
        return torch.floor_divide(x, y)

    @staticmethod
    def backward(ctx, g):
        return tuple(torch.zeros(s, dtype=d, device=v) if d.is_floating_point
                     else None for s, d, v in ctx.metas)


def _same_dev(x, y):
    """maximum/minimum take no CPU scalar beside a CUDA tensor: the 0-d
    one (a Python scalar) becomes a filled tensor on the other's device
    (a fill kernel, no copy, so a CUDA graph can capture it)."""
    if x.device != y.device:
        dt = torch.result_type(x, y)
        if y.dim() == 0 and y.device.type == "cpu":
            y = torch.full_like(x, y.item(), dtype=dt)
        elif x.dim() == 0 and x.device.type == "cpu":
            x = torch.full_like(y, x.item(), dtype=dt)
    return x, y


def host_scalar(t, like):
    """A 0-d CPU tensor (a Python scalar the dispatcher wrapped) beside
    device tensors, as its Python value: ``torch.where`` and indexed
    stores take scalars, but would copy a CPU tensor (no copy may run
    inside a CUDA graph capture)."""
    if t.dim() == 0 and t.device.type == "cpu" and like.device.type != "cpu":
        return t.item()
    return t


def clip(x, min=None, max=None):
    return torch.clamp(x, min, max)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None):
    s, b = float(scale), float(bias)
    return x * s + b if bias_after_scale else (x + b) * s


def cast(x, dtype):
    from ..core.dtype import to_torch_dtype
    return x.to(to_torch_dtype(dtype))


# -- reductions -------------------------------------------------------------
def sum(x, axis=None, dtype=None, keepdim=False):
    if dtype is not None:
        from ..core.dtype import to_torch_dtype
        dt = to_torch_dtype(dtype)
    elif x.dtype == torch.bool:
        dt = torch.int64
    else:
        dt = None
    return torch.sum(x, dim=_dims(x, axis), keepdim=keepdim, dtype=dt)


def mean(x, axis=None, keepdim=False):
    return torch.mean(_float(x), dim=_dims(x, axis), keepdim=keepdim)


def max(x, axis=None, keepdim=False):
    return torch.amax(x, dim=_dims(x, axis), keepdim=keepdim)


def min(x, axis=None, keepdim=False):
    return torch.amin(x, dim=_dims(x, axis), keepdim=keepdim)


amax = max
amin = min


def prod(x, axis=None, keepdim=False, dtype=None):
    a = _axis_t(axis)
    if a is None:
        out = torch.prod(x)
        return out.reshape((1,) * x.dim()) if keepdim else out
    for d in sorted((a,) if isinstance(a, int) else a,
                    key=lambda d: -(d % x.dim())):
        x = torch.prod(x, dim=d, keepdim=keepdim)
    return x


def argmax(x, axis=None, keepdim=False, dtype="int64"):
    a = None if axis is None else int(axis)
    return torch.argmax(x, dim=a, keepdim=keepdim).to(torch.int64)


def argmin(x, axis=None, keepdim=False, dtype="int64"):
    a = None if axis is None else int(axis)
    return torch.argmin(x, dim=a, keepdim=keepdim).to(torch.int64)


def any(x, axis=None, keepdim=False):
    return torch.any(x.bool(), dim=_dims(x, axis), keepdim=keepdim)


def all(x, axis=None, keepdim=False):
    return torch.all(x.bool(), dim=_dims(x, axis), keepdim=keepdim)


def logsumexp(x, axis=None, keepdim=False):
    return torch.logsumexp(x, dim=_dims(x, axis), keepdim=keepdim)


def var(x, axis=None, unbiased=True, keepdim=False):
    return torch.var(x, dim=_dims(x, axis), correction=1 if unbiased else 0,
                     keepdim=bool(keepdim))


def std(x, axis=None, unbiased=True, keepdim=False):
    return torch.std(x, dim=_dims(x, axis), correction=1 if unbiased else 0,
                     keepdim=bool(keepdim))


def cumsum(x, axis=None, dtype=None):
    if axis is None:
        return torch.cumsum(x.reshape(-1), dim=0)
    return torch.cumsum(x, dim=int(axis))


# -- shape ------------------------------------------------------------------
def reshape(x, shape):
    return torch.reshape(x, tuple(int(s) for s in shape))


def transpose(x, perm=None):
    if perm is None:
        perm = tuple(reversed(range(x.dim())))
    return x.permute(tuple(int(p) for p in perm))


def concat(*xs, axis=0):
    return torch.cat(xs, dim=int(axis))


def stack(*xs, axis=0):
    return torch.stack(xs, dim=int(axis))


def flatten(x, start_axis=0, stop_axis=-1):
    if x.dim() == 0:
        return torch.reshape(x, (1,))
    start, stop = start_axis % x.dim(), stop_axis % x.dim()
    shape = tuple(x.shape)
    return torch.reshape(x, shape[:start] + (-1,) + shape[stop + 1:])


def unsqueeze(x, axis):
    ax = axis if isinstance(axis, tuple) else (int(axis),)
    nd = x.dim() + len(ax)
    for a in sorted(int(a) % nd for a in ax):
        x = torch.unsqueeze(x, a)
    return x


def squeeze(x, axis=None):
    if axis is None:
        return torch.squeeze(x)
    ax = axis if isinstance(axis, tuple) else (axis,)
    ax = tuple(int(a) % x.dim() for a in ax if x.shape[int(a)] == 1)
    if not ax:
        # no squeezable dim: an identity that still records on the graph
        return x * 1 if x.dtype != torch.bool else x.clone()
    return torch.squeeze(x, dim=ax)


def expand(x, shape):
    return torch.broadcast_to(x, _expand_shape(tuple(x.shape), shape))


def expand_as(x, y):
    return torch.broadcast_to(x, y.shape)


def broadcast_to(x, shape):
    return expand(x, shape)


def tile(x, repeat_times):
    return torch.tile(x, tuple(int(r) for r in repeat_times))


# -- indexing ---------------------------------------------------------------
def _take(x, index, axis):
    axis = int(axis) % x.dim()
    flat = torch.index_select(x, axis, index.reshape(-1).long())
    return flat.reshape(tuple(x.shape[:axis]) + tuple(index.shape)
                        + tuple(x.shape[axis + 1:]))


def gather(x, index, axis=0):
    if index.dim() == 0:
        index = index[None]
    return _take(x, index, axis)


def index_select(x, index, axis=0):
    return _take(x, index, axis)


def masked_fill(x, mask, value):
    v = host_scalar(value, x)
    return torch.where(mask, v.to(x.dtype) if torch.is_tensor(v) else v, x)


def one_hot(x, num_classes):
    return _F.one_hot(x.long(), int(num_classes)).to(torch.float32)


# -- matmul -----------------------------------------------------------------
def matmul(x, y, transpose_x=False, transpose_y=False):
    if transpose_x:
        x = x.transpose(-1, -2) if x.dim() > 1 else x
    if transpose_y:
        y = y.transpose(-1, -2) if y.dim() > 1 else y
    return torch.matmul(x, y)


def bmm(x, y): return torch.matmul(x, y)                        # noqa: E704


# -- activations ------------------------------------------------------------
def relu(x): return torch.relu(x)                               # noqa: E704
def relu6(x): return _F.relu6(x)                                # noqa: E704
def sigmoid(x): return torch.sigmoid(x)                         # noqa: E704
def silu(x): return _F.silu(x)                                  # noqa: E704
def swish(x): return _F.silu(x)                                 # noqa: E704
def log_sigmoid(x): return _F.logsigmoid(x)                     # noqa: E704
def softsign(x): return _F.softsign(x)                          # noqa: E704


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def mish(x):
    return x * torch.tanh(_softplus(x))


def gelu(x, approximate=False):
    return _F.gelu(x, approximate="tanh" if approximate else "none")


def softmax(x, axis=-1, dtype=None):
    # the reference casts to `dtype` BEFORE the op when given
    return torch.softmax(_maybe_cast(x, dtype), dim=int(axis))


def log_softmax(x, axis=-1, dtype=None):
    return torch.log_softmax(_maybe_cast(x, dtype), dim=int(axis))


def leaky_relu(x, negative_slope=0.01):
    return _F.leaky_relu(x, float(negative_slope))


def elu(x, alpha=1.0):
    return _F.elu(x, float(alpha))


def softplus(x, beta=1.0, threshold=20.0):
    beta, threshold = float(beta), float(threshold)
    return torch.where(beta * x > threshold, x, _softplus(beta * x) / beta)


def hardswish(x):
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


# -- losses -----------------------------------------------------------------
def mse_loss(input, label, reduction="mean"):
    return _reduce_loss(torch.square(input - label), reduction)


def l1_loss(input, label, reduction="mean"):
    return _reduce_loss(torch.abs(input - label), reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0):
    d = input - label
    abs_d = torch.abs(d)
    loss = torch.where(abs_d < delta, 0.5 * d * d / delta,
                       abs_d - 0.5 * delta)
    return _reduce_loss(loss * delta, reduction)   # paddle scales by delta


def cross_entropy(input, label, *maybe_w, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, _has_weight=False):
    axis = int(axis) % input.dim()
    if use_softmax:
        logp = torch.log_softmax(input.to(torch.float32), dim=axis)
    else:
        logp = torch.log(torch.clamp(input.to(torch.float32), min=1e-12))
    n_class = input.shape[axis]
    if soft_label or (label.dim() == input.dim()
                      and label.shape[axis] == n_class
                      and label.is_floating_point()):
        soft = label.to(logp.dtype)
        if label_smoothing > 0:
            soft = soft * (1 - label_smoothing) + label_smoothing / n_class
        loss = -torch.sum(soft * logp, dim=axis)
        if _has_weight:
            wvec = maybe_w[0].to(logp.dtype)
            shape = [1] * logp.dim()
            shape[axis] = n_class
            loss = loss * torch.sum(soft * wvec.reshape(shape), dim=axis)
        return _reduce_loss(loss, reduction)
    lbl = label
    if lbl.dim() == input.dim():
        lbl = torch.squeeze(lbl, dim=axis)
    lbl = lbl.to(torch.int64)
    valid = lbl != ignore_index
    safe = torch.where(valid, lbl, 0)
    picked = torch.gather(logp, axis, torch.unsqueeze(safe, axis))
    loss = -torch.squeeze(picked, axis)
    if label_smoothing > 0:
        smooth_loss = -torch.mean(logp, dim=axis)
        loss = (1 - label_smoothing) * loss + label_smoothing * smooth_loss
    if _has_weight:
        wvec = maybe_w[0].to(logp.dtype)
        sample_w = wvec[safe]
        loss = torch.where(valid, loss * sample_w, 0.0)
        if reduction == "mean":
            return torch.sum(loss) / torch.clamp(
                torch.sum(torch.where(valid, sample_w, 0.0)), min=1e-12)
        return _reduce_loss(loss, reduction)
    loss = torch.where(valid, loss, 0.0)
    if reduction == "mean":
        return torch.sum(loss) / torch.clamp(
            torch.sum(valid.to(logp.dtype)), min=1.0)
    return _reduce_loss(loss, reduction)


def nll_loss(input, label, *maybe_w, ignore_index=-100, reduction="mean",
             _has_weight=False):
    lbl = label.to(torch.int64)
    valid = lbl != ignore_index
    safe = torch.where(valid, lbl, 0)
    lp = torch.movedim(input, 1, -1) if input.dim() > 2 else input
    loss = -torch.gather(lp, -1, safe[..., None])[..., 0]
    if _has_weight:
        sw = maybe_w[0][safe]
        loss = torch.where(valid, loss * sw, 0.0)
        if reduction == "mean":
            return torch.sum(loss) / torch.clamp(
                torch.sum(torch.where(valid, sw, 0.0)), min=1e-12)
        return _reduce_loss(loss, reduction)
    loss = torch.where(valid, loss, 0.0)
    if reduction == "mean":
        return torch.sum(loss) / torch.clamp(
            torch.sum(valid.to(loss.dtype)), min=1.0)
    return _reduce_loss(loss, reduction)


def binary_cross_entropy(input, label, *maybe_w, reduction="mean",
                         _has_weight=False):
    p = torch.clamp(input, 1e-12, 1.0 - 1e-7)
    loss = -(label * torch.log(p) + (1 - label) * torch.log(1 - p))
    if _has_weight:
        loss = loss * maybe_w[0]
    return _reduce_loss(loss, reduction)


def binary_cross_entropy_with_logits(logit, label, *maybe, reduction="mean",
                                     _has_weight=False,
                                     _has_pos_weight=False):
    i = 0
    w = pw = None
    if _has_weight:
        w = maybe[i]
        i += 1
    if _has_pos_weight:
        pw = maybe[i]
    max_val = torch.clamp(-logit, min=0)
    if pw is not None:
        log_w = (pw - 1.0) * label + 1.0
        loss = ((1.0 - label) * logit
                + log_w * (torch.log1p(torch.exp(-torch.abs(logit)))
                           + max_val))
    else:
        loss = (torch.clamp(logit, min=0) - logit * label
                + torch.log1p(torch.exp(-torch.abs(logit))))
    if w is not None:
        loss = loss * w
    return _reduce_loss(loss, reduction)


def kl_div(input, label, reduction="mean", log_target=False):
    if log_target:
        loss = torch.exp(label) * (label - input)
    else:
        loss = label * (torch.log(torch.clamp(label, min=1e-12)) - input)
    if reduction == "batchmean":
        return torch.sum(loss) / input.shape[0]
    return _reduce_loss(loss, reduction)



# ---------------------------------------------------------------------------
# The rest of the reference's kernel-driven ops.  Every tensor a kernel
# makes (aranges, identities, masks, index tensors) is made on its input's
# device; index math that depends only on shapes is done on the host.
# ---------------------------------------------------------------------------
def _arange(n, like, dtype=torch.int64):
    return torch.arange(n, dtype=dtype, device=like.device)


def _long(t):
    return t if t.dtype == torch.int64 else t.long()


def _dev(t, like):
    """A 0-d CPU tensor (a wrapped Python scalar) on like's device."""
    return t.to(like.device) if t.device != like.device else t


# -- unary elementwise ------------------------------------------------------
def asin(x): return torch.asin(_float(x))                       # noqa: E704
def acos(x): return torch.acos(_float(x))                       # noqa: E704
def atan(x): return torch.atan(_float(x))                       # noqa: E704
def sinh(x): return torch.sinh(_float(x))                       # noqa: E704
def cosh(x): return torch.cosh(_float(x))                       # noqa: E704
def asinh(x): return torch.asinh(_float(x))                     # noqa: E704
def acosh(x): return torch.acosh(_float(x))                     # noqa: E704
def atanh(x): return torch.atanh(_float(x))                     # noqa: E704
def frac(x): return x - torch.trunc(x)                          # noqa: E704
def sgn(x): return torch.sgn(x)                                 # noqa: E704
def erfinv(x): return torch.erfinv(_float(x))                   # noqa: E704
def isposinf(x): return torch.isposinf(x)                       # noqa: E704
def isneginf(x): return torch.isneginf(x)                       # noqa: E704
def isreal(x): return torch.isreal(x)                           # noqa: E704
def signbit(x): return torch.signbit(x)                         # noqa: E704
def deg2rad(x): return torch.deg2rad(_float(x))                 # noqa: E704
def rad2deg(x): return torch.rad2deg(_float(x))                 # noqa: E704
def angle(x): return torch.angle(_float(x))                     # noqa: E704
def conj(x): return torch.conj_physical(x)                      # noqa: E704
def real(x): return torch.real(x).clone()                       # noqa: E704
def i0(x): return torch.i0(_float(x))                           # noqa: E704
def i1(x): return torch.special.i1(_float(x))                   # noqa: E704
def i0e(x): return torch.special.i0e(_float(x))                 # noqa: E704
def i1e(x): return torch.special.i1e(_float(x))                 # noqa: E704
def digamma(x): return torch.digamma(_float(x))                 # noqa: E704
def lgamma(x): return torch.lgamma(_float(x))                   # noqa: E704
def gammaln(x): return torch.lgamma(_float(x))                  # noqa: E704
def sinc(x): return torch.sinc(_float(x))                       # noqa: E704
def polygamma(x, n=1): return torch.polygamma(int(n), _float(x))  # noqa: E704


def imag(x):
    return torch.imag(x).clone() if x.is_complex() else torch.zeros_like(x)


# -- binary elementwise -----------------------------------------------------
def remainder(x, y): return torch.remainder(x, y)               # noqa: E704
def fmax(x, y): return torch.fmax(*_same_dev(x, y))             # noqa: E704
def fmin(x, y): return torch.fmin(*_same_dev(x, y))             # noqa: E704
def atan2(x, y): return torch.atan2(*_same_dev(x, y))           # noqa: E704
def logaddexp(x, y): return torch.logaddexp(*_same_dev(x, y))   # noqa: E704
def hypot(x, y): return torch.hypot(*_same_dev(x, y))           # noqa: E704
def copysign(x, y): return torch.copysign(x, y)                 # noqa: E704


def heaviside(x, y):
    x, y = _same_dev(x, y)
    dt = torch.promote_types(x.dtype, y.dtype)
    if not dt.is_floating_point:
        dt = torch.get_default_dtype()
    x, y = x.to(dt), y.to(dt)
    zero = torch.zeros((), dtype=dt, device=x.device)
    return torch.where(x < zero, zero,
                       torch.where(x > zero, torch.ones_like(zero), y))


def gcd(x, y): return torch.gcd(*_same_dev(x, y))               # noqa: E704
def lcm(x, y): return torch.lcm(*_same_dev(x, y))               # noqa: E704
def logical_xor(x, y): return torch.logical_xor(x, y)           # noqa: E704
def bitwise_and(x, y): return torch.bitwise_and(x, y)           # noqa: E704
def bitwise_or(x, y): return torch.bitwise_or(x, y)             # noqa: E704
def bitwise_xor(x, y): return torch.bitwise_xor(x, y)           # noqa: E704
def bitwise_not(x): return torch.bitwise_not(x)                 # noqa: E704


def nextafter(x, y):
    x, y = _same_dev(x, y)
    return torch.nextafter(x, y.to(x.dtype))


def ldexp(x, y):
    return _float(x) * torch.pow(2.0, _dev(y, x).to(torch.int32)
                                 .to(_float(x).dtype))


def bitwise_left_shift(x, y, is_arithmetic=True):
    return torch.bitwise_left_shift(x, y)


def bitwise_right_shift(x, y, is_arithmetic=True):
    return torch.bitwise_right_shift(x, y)


# -- matmul family ----------------------------------------------------------
def mm(input, mat2): return torch.matmul(input, mat2)           # noqa: E704
def dot(x, y): return torch.sum(x * y, dim=-1)                  # noqa: E704
def inner(x, y): return torch.inner(x, y)                       # noqa: E704
def kron(x, y): return torch.kron(x, y)                         # noqa: E704
def mv(x, vec): return torch.matmul(x, vec)                     # noqa: E704


def outer(x, y):
    return x.reshape(-1)[:, None] * y.reshape(-1)[None, :]


def addmm(input, x, y, beta=1.0, alpha=1.0):
    return beta * input + alpha * torch.matmul(x, y)


def multi_dot(*xs):
    return torch.linalg.multi_dot(xs)


def tensordot(x, y, axes=2):
    if isinstance(axes, (tuple, list)):
        axes = [list(a) if isinstance(a, (tuple, list)) else [int(a)]
                for a in axes]
    return torch.tensordot(x, y, dims=axes)


# -- small attr ops ---------------------------------------------------------
def stanh(x, scale_a=0.67, scale_b=1.7159):
    return scale_b * torch.tanh(scale_a * x)


def logit(x, eps=None):
    if eps is not None:
        x = torch.clamp(x, eps, 1.0 - eps)
    return torch.log(x / (1.0 - x))


def nan_to_num(x, nan=0.0, posinf=None, neginf=None):
    return torch.nan_to_num(x, nan=nan, posinf=posinf, neginf=neginf)


def trace(x, offset=0, axis1=0, axis2=1):
    return torch.sum(torch.diagonal(x, int(offset), int(axis1), int(axis2)),
                     dim=-1)


def diagonal(x, offset=0, axis1=0, axis2=1):
    return torch.diagonal(x, int(offset), int(axis1), int(axis2))


def rot90(x, k=1, axes=(0, 1)):
    return torch.rot90(x, int(k), [int(a) for a in axes])


def log_normalize(x, axis=-1):
    return x - torch.logsumexp(x, dim=int(axis), keepdim=True)


def reduce_as(x, target):
    if x.shape == target.shape:
        return x
    nlead = x.dim() - target.dim()
    axes = tuple(range(nlead)) + tuple(
        nlead + i for i, d in enumerate(target.shape)
        if x.shape[nlead + i] != d)
    return torch.sum(x, dim=axes).reshape(target.shape)


# -- reductions / scans -----------------------------------------------------
def nansum(x, axis=None, dtype=None, keepdim=False):
    return torch.nansum(x, dim=_dims(x, axis), keepdim=keepdim)


def nanmean(x, axis=None, keepdim=False):
    x = _float(x)
    nan = torch.isnan(x)
    dims = _dims(x, axis)
    total = torch.sum(torch.where(nan, torch.zeros_like(x), x), dim=dims,
                      keepdim=keepdim)
    return total / torch.sum(~nan, dim=dims, keepdim=keepdim).to(x.dtype)


def cumprod(x, dim=None, dtype=None):
    if dim is None:
        return torch.cumprod(x.reshape(-1), dim=0)
    return torch.cumprod(x, dim=int(dim))


def count_nonzero(x, axis=None, keepdim=False):
    return torch.sum(x != 0, dim=_dims(x, axis), keepdim=keepdim,
                     dtype=torch.int64)


def logcumsumexp(x, axis=None):
    if axis is None:
        x, axis = x.reshape(-1), 0
    return torch.logcumsumexp(x, dim=int(axis))


def _cum_extreme(x, axis, op):
    if axis is None:
        x, axis = x.reshape(-1), 0
    axis = int(axis) % x.dim()
    vals = op(x, dim=axis).values
    shape = [-1 if i == axis else 1 for i in range(x.dim())]
    ar = _arange(x.shape[axis], x).reshape(shape)
    idx = torch.cummax(torch.where(x == vals, ar, -1), dim=axis).values
    return vals, idx


def cummax(x, axis=None, dtype="int64"):
    return _cum_extreme(x, axis, torch.cummax)


def cummin(x, axis=None, dtype="int64"):
    return _cum_extreme(x, axis, torch.cummin)


def _quantile(a, q, axis, method, keepdims, squash_nans):
    """jnp's quantile: the sorted slice read at floor and ceil of
    q * (n - 1), over the non-NaN count with ``squash_nans``."""
    if method not in ("linear", "lower", "higher", "midpoint", "nearest"):
        raise ValueError("method can only be 'linear', 'lower', 'higher', "
                         "'midpoint', or 'nearest'")
    a = _float(a)
    shape, nd = list(a.shape), a.dim()
    if axis is None:
        work = a.reshape(-1)
        keep = [1] * nd
    elif isinstance(axis, (tuple, list)):
        axes = [int(d) % nd for d in axis]
        if len(set(axes)) != len(axes):
            raise ValueError("repeated axis")
        rest = [d for d in range(nd) if d not in axes]
        work = a.permute(rest + axes).reshape(
            [shape[d] for d in rest] + [-1])
        keep = [1 if d in axes else s for d, s in enumerate(shape)]
    else:
        ax = int(axis) % nd
        work = torch.movedim(a, ax, -1)
        keep = [1 if d == ax else s for d, s in enumerate(shape)]
    qdt = torch.promote_types(a.dtype, torch.float32)
    qt = torch.as_tensor(q, dtype=qdt, device=a.device)
    if qt.dim() > 1:
        raise ValueError(f"q must be have rank <= 1, got shape "
                         f"{tuple(qt.shape)}")
    batch = tuple(work.shape[:-1])
    qb = qt.reshape(tuple(qt.shape) + (1,) * len(batch))
    if squash_nans:
        srt = torch.sort(work, dim=-1).values
        counts = torch.sum(~torch.isnan(srt), dim=-1).to(qdt)
        qq = qb * (counts - 1)
        lo = torch.floor(qq)
        hi = torch.ceil(qq)
        hw = qq - lo
        lo = torch.maximum(torch.zeros_like(lo), torch.minimum(lo, counts - 1))
        hi = torch.maximum(torch.zeros_like(hi), torch.minimum(hi, counts - 1))
        full = srt.expand(tuple(qt.shape) + srt.shape)
        lv = torch.gather(full, -1, lo.long()[..., None])[..., 0]
        hv = torch.gather(full, -1, hi.long()[..., None])[..., 0]
    else:
        nan_row = torch.isnan(work).any(dim=-1, keepdim=True)
        work = torch.where(nan_row, torch.full_like(work, float("nan")),
                           work)
        srt = torch.sort(work, dim=-1).values
        n = work.shape[-1]
        qq = qt * (n - 1)
        lo = torch.clamp(torch.floor(qq), 0, n - 1)
        hi = torch.clamp(torch.ceil(qq), 0, n - 1)
        hw = (qq - torch.floor(qq)).reshape(qb.shape)
        lv = torch.movedim(srt.index_select(-1, lo.long().reshape(-1)),
                           -1, 0).reshape(tuple(qt.shape) + batch)
        hv = torch.movedim(srt.index_select(-1, hi.long().reshape(-1)),
                           -1, 0).reshape(tuple(qt.shape) + batch)
    lw = 1 - hw
    if method == "linear":
        out = lv.to(qdt) * lw + hv.to(qdt) * hw
    elif method == "lower":
        out = lv
    elif method == "higher":
        out = hv
    elif method == "nearest":
        out = torch.where(hw <= 0.5, lv, hv)
    else:
        out = (lv + hv) * 0.5
    if keepdims:
        out = out.reshape(tuple(qt.shape) + tuple(keep))
    return out.to(a.dtype)


def _q_axis(axis):
    if isinstance(axis, (tuple, list)):
        return tuple(int(a) for a in axis)
    return None if axis is None else int(axis)


def quantile(x, q, axis=None, keepdim=False, interpolation="linear"):
    return _quantile(x, q, _q_axis(axis), interpolation, bool(keepdim),
                     False)


def nanquantile(x, q, axis=None, keepdim=False):
    return _quantile(x, q, _q_axis(axis), "linear", bool(keepdim), True)


def median(x, axis=None, keepdim=False, mode="avg"):
    ax = None if axis is None else int(axis)
    if mode == "avg":
        return _quantile(x, 0.5, ax, "midpoint", bool(keepdim), False)
    n = x.shape[ax] if ax is not None else x.numel()
    k = (n - 1) // 2
    srt = torch.sort(x, dim=ax).values if ax is not None \
        else torch.sort(x.reshape(-1)).values
    out = torch.narrow(srt, ax if ax is not None else 0, k, 1)
    if not keepdim or ax is None:
        out = torch.squeeze(out, ax if ax is not None else 0)
    return out


def nanmedian(x, axis=None, keepdim=False, mode="avg"):
    return _quantile(x, 0.5, _q_axis(axis), "midpoint", bool(keepdim), True)


def kthvalue(x, k, axis=-1, keepdim=False):
    k, axis = int(k), int(axis)
    srt, idx = torch.sort(x, dim=axis, stable=True)
    vals = torch.narrow(srt, axis, k - 1, 1)
    idxs = torch.narrow(idx, axis, k - 1, 1)
    if not keepdim:
        vals, idxs = vals.squeeze(axis), idxs.squeeze(axis)
    return vals, idxs


def mode(x, axis=-1, keepdim=False):
    ax = int(axis) % x.dim()
    srt, idx = torch.sort(x, dim=ax, stable=True)
    n = x.shape[ax]
    shape = [n if i == ax else 1 for i in range(x.dim())]
    pos = _arange(n, x).reshape(shape)
    first = torch.ones_like(torch.narrow(srt, ax, 0, 1), dtype=torch.bool)
    is_start = torch.cat([first, torch.diff(srt, dim=ax) != 0], dim=ax)
    last_start = torch.cummax(torch.where(is_start, pos, -1), dim=ax).values
    run_len = pos - last_start + 1
    best = torch.argmax(run_len, dim=ax, keepdim=True)
    vals = torch.gather(srt, ax, best)
    idxs = torch.gather(idx, ax, best)
    if not keepdim:
        vals, idxs = vals.squeeze(ax), idxs.squeeze(ax)
    return vals, idxs


def renorm(x, p, axis, max_norm):
    p, max_norm = float(p), float(max_norm)
    axis = int(axis) % x.dim()
    dims = tuple(i for i in range(x.dim()) if i != axis)
    norms = torch.sum(torch.abs(x) ** p, dim=dims, keepdim=True) ** (1.0 / p)
    factor = torch.where(norms > max_norm, max_norm / (norms + 1e-7),
                         torch.ones_like(norms))
    return x * factor


def combinations(x, r=2, with_replacement=False):
    n, r = x.shape[0], int(r)
    it = (_it.combinations_with_replacement(range(n), r)
          if with_replacement else _it.combinations(range(n), r))
    idx = [i for c in it for i in c]
    if not idx:
        return torch.zeros((0, r), dtype=x.dtype, device=x.device)
    return torch.index_select(x, 0, torch.tensor(idx, device=x.device)) \
        .reshape(-1, r)


def numel(x):
    return torch.tensor(x.numel(), dtype=torch.int64, device=x.device)


def mean_all(x):
    return torch.mean(_float(x))


def squared_l2_norm(x):
    return torch.sum(x.to(torch.float32) ** 2)


def frobenius_norm(x, axis=None, keepdim=False):
    af = x.to(torch.float32)
    return torch.sqrt(torch.sum(af * af, dim=_dims(x, axis),
                                keepdim=keepdim)).to(x.dtype)


def clip_by_norm(x, max_norm):
    xf = x.to(torch.float32)
    norm = torch.sqrt(torch.sum(xf ** 2))
    s = torch.where(norm > max_norm,
                    max_norm / torch.clamp(norm, min=1e-12),
                    torch.ones_like(norm))
    return (xf * s).to(x.dtype)


def trapezoid(y, *maybe_x, dx=1.0, axis=-1, _has_x=False):
    if _has_x:
        return torch.trapezoid(y, maybe_x[0], dim=int(axis))
    return torch.trapezoid(y, dx=float(dx), dim=int(axis))


def cumulative_trapezoid(y, *maybe_x, dx=1.0, axis=-1, _has_x=False):
    x = maybe_x[0] if _has_x else None
    ya = torch.movedim(y, int(axis), -1)
    mids = (ya[..., 1:] + ya[..., :-1]) * 0.5
    if x is not None:
        xa = torch.movedim(torch.broadcast_to(x, y.shape), int(axis), -1) \
            if x.dim() == y.dim() else x
        d = xa[..., 1:] - xa[..., :-1]
        out = torch.cumsum(mids * d, dim=-1)
    else:
        out = torch.cumsum(mids * dx, dim=-1)
    return torch.movedim(out, -1, int(axis))


def float_power(x, y):
    return torch.pow(x.to(torch.float64), y)


def lerp(x, y, weight):
    return x + weight * (y - x)


def take(x, index, mode="raise"):
    flat = x.reshape(-1)
    n = flat.shape[0]
    index = _long(index)
    if mode == "wrap":
        index = torch.remainder(index, n)
    elif mode == "clip":
        index = torch.clamp(index, -n, n - 1)
    index = torch.where(index < 0, index + n, index)
    # a gather clamps an index out of range, as XLA's does
    return flat[torch.clamp(index, 0, n - 1)]


def vander(x, n=None, increasing=False):
    if x.dim() != 1:
        raise ValueError("x must be a one-dimensional array")
    m = x.shape[0] if n is None else int(n)
    p = torch.arange(m, dtype=x.dtype, device=x.device)
    if not increasing:
        p = (m - 1) - p
    return torch.pow(x.unsqueeze(-1), p)


def diff(x, *maybe, n=1, axis=-1, _has_prepend=False, _has_append=False):
    it = iter(maybe)
    pre = next(it) if _has_prepend else None
    app = next(it) if _has_append else None
    return torch.diff(x, n=int(n), dim=int(axis), prepend=pre, append=app)


def histogram(input, *maybe_w, bins=100, min=0, max=0, density=False,
              _has_weight=False):
    a = _float(input)
    w = maybe_w[0].to(a.dtype) if _has_weight else torch.ones_like(a)
    bins = int(bins)
    if min == 0 and max == 0:
        lo, hi = torch.min(a), torch.max(a)
    else:
        lo = torch.tensor(float(min), dtype=a.dtype, device=a.device)
        hi = torch.tensor(float(max), dtype=a.dtype, device=a.device)
    flat = lo == hi
    lo, hi = torch.where(flat, lo - 0.5, lo), torch.where(flat, hi + 0.5, hi)
    step = _arange(bins, a, a.dtype) / bins
    edges = torch.cat([lo * (1 - step) + hi * step, hi[None]])
    idx = torch.searchsorted(edges, a.reshape(-1), right=True)
    idx = torch.where(a.reshape(-1) == edges[-1], bins, idx)
    counts = torch.zeros(bins + 2, dtype=a.dtype, device=a.device) \
        .index_add(0, idx, w.reshape(-1))[1:bins + 1]
    if density:
        counts = counts / torch.diff(edges) / counts.sum()
    return counts if (density or _has_weight) else counts.to(torch.int64)


# -- shape and indexing -----------------------------------------------------
def moveaxis(x, source, destination):
    s = tuple(source) if isinstance(source, tuple) else (int(source),)
    d = tuple(destination) if isinstance(destination, tuple) \
        else (int(destination),)
    return torch.movedim(x, s, d)


def swapaxes(x, axis1, axis2):
    return torch.swapaxes(x, int(axis1), int(axis2))


def unflatten(x, axis, shape):
    axis = int(axis) % x.dim()
    cur = tuple(x.shape)
    return torch.reshape(x, cur[:axis] + tuple(int(s) for s in shape)
                         + cur[axis + 1:])


def flip(x, axis):
    ax = axis if isinstance(axis, tuple) else (int(axis),)
    return torch.flip(x, tuple(int(a) for a in ax))


def fliplr(x): return torch.flip(x, (1,))                       # noqa: E704
def flipud(x): return torch.flip(x, (0,))                       # noqa: E704


def reverse(x, axis):
    return flip(x, tuple(axis) if isinstance(axis, (tuple, list)) else axis)


def roll(x, shifts, axis=None):
    sh = shifts if isinstance(shifts, tuple) else int(shifts)
    if axis is None:
        return torch.roll(x, sh)
    return torch.roll(x, sh, axis if isinstance(axis, tuple) else int(axis))


def vstack(*xs): return torch.vstack(xs)                        # noqa: E704
def hstack(*xs): return torch.hstack(xs)                        # noqa: E704
def dstack(*xs): return torch.dstack(xs)                        # noqa: E704


def gather_nd(x, index):
    return x[tuple(_long(index).movedim(-1, 0))]


def index_sample(x, index):
    return torch.gather(x, 1, _long(index))


def index_add(x, index, value, axis):
    return torch.index_add(x, int(axis), _long(index), value.to(x.dtype))


def index_fill(x, index, value, axis):
    v = host_scalar(value, x)
    v = v.to(x.dtype) if torch.is_tensor(v) else v
    return torch.index_fill(x, int(axis), _long(index), v)


def masked_scatter(x, mask, value):
    flat_m = torch.broadcast_to(mask, x.shape).reshape(-1)
    pos = torch.cumsum(flat_m.to(torch.int32), dim=0) - 1
    vf = value.reshape(-1)
    gathered = vf[torch.clamp(pos, 0, vf.numel() - 1).long()]
    return torch.where(flat_m, gathered.to(x.dtype), x.reshape(-1)) \
        .reshape(x.shape)


def take_along_axis(arr, indices, axis, broadcast=True):
    return torch.take_along_dim(arr, _long(indices), int(axis))


def put_along_axis(arr, indices, values, axis, reduce="assign",
                   include_self=True, broadcast=True):
    axis = int(axis)
    idx = _long(indices)
    v = values.to(arr.device) if values.device != arr.device else values
    v = torch.broadcast_to(v.to(arr.dtype), idx.shape)
    if reduce == "assign":
        return torch.scatter(arr, axis, idx, v)
    how = {"add": "sum", "sum": "sum", "mul": "prod", "multiply": "prod",
           "amax": "amax", "amin": "amin", "mean": "mean"}.get(reduce)
    if how is None:
        raise ValueError(f"unknown reduce {reduce}")
    return torch.scatter_reduce(arr, axis, idx, v, how,
                                include_self=bool(include_self))


def scatter(x, index, updates, overwrite=True):
    if index.dim() == 2 and index.shape[1] == 1:
        index = index[:, 0]
    index = _long(index)
    if overwrite:
        return torch.index_copy(x, 0, index, updates.to(x.dtype))
    return torch.index_add(torch.index_fill(x, 0, index, 0), 0, index,
                           updates.to(x.dtype))


def scatter_nd(index, updates, shape):
    zeros = torch.zeros(tuple(int(s) for s in shape), dtype=updates.dtype,
                        device=updates.device)
    return zeros.index_put(tuple(_long(index).movedim(-1, 0)), updates,
                           accumulate=True)


def scatter_nd_add(x, index, updates):
    return x.index_put(tuple(_long(index).movedim(-1, 0)),
                       updates.to(x.dtype), accumulate=True)


def repeat_interleave(x, repeats, axis=None):
    ax = None if axis is None else int(axis)
    if isinstance(repeats, tuple):
        reps = torch.tensor([int(r) for r in repeats], device=x.device)
        return torch.repeat_interleave(x, reps, dim=ax,
                                       output_size=_b.sum(repeats))
    return torch.repeat_interleave(x, int(repeats), dim=ax)


def sort(x, axis=-1, descending=False, stable=False):
    return torch.sort(x, dim=int(axis), descending=bool(descending),
                      stable=True).values


def argsort(x, axis=-1, descending=False, stable=False):
    return torch.sort(x, dim=int(axis), descending=bool(descending),
                      stable=True).indices


def topk(x, k, axis=-1, largest=True, sorted=True):
    # a stable sort: ties keep the lower index first, as lax.top_k does
    k, axis = int(k), int(axis)
    vals, idx = torch.sort(x, dim=axis, descending=bool(largest),
                           stable=True)
    return torch.narrow(vals, axis, 0, k), torch.narrow(idx, axis, 0, k)


def cross(x, y, axis=9):
    ax = 9 if axis is None else int(axis)
    if ax == 9:     # reference sentinel: first dim of size 3
        ax = next((i for i, s in enumerate(x.shape) if s == 3), None)
        if ax is None:
            raise ValueError(
                f"cross: no dimension of size 3 in shape {tuple(x.shape)}; "
                "pass axis explicitly")
    return torch.linalg.cross(x, y, dim=ax)


def searchsorted(sorted_sequence, values, out_int32=False, right=False):
    return torch.searchsorted(sorted_sequence, values,
                              out_int32=bool(out_int32), right=bool(right))


def bucketize(x, sorted_sequence, out_int32=False, right=False):
    return searchsorted(sorted_sequence, x, out_int32, right)


def crop(x, shape=None, offsets=None):
    shape = tuple(x.shape) if shape is None else tuple(int(s) for s in shape)
    full = tuple(x.shape[i] if s == -1 else s for i, s in enumerate(shape))
    offs = (0,) * x.dim() if offsets is None \
        else tuple(int(o) for o in offsets)
    for d, (o, n) in enumerate(zip(offs, full)):
        # dynamic_slice clamps the start so the window fits
        x = torch.narrow(x, d, _b.min(_b.max(o, 0), x.shape[d] - n), n)
    return x


_NP_PAD = {"reflect": "reflect", "replicate": "edge", "circular": "wrap"}


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW",
        pad_from_left_axis=True):
    import numpy as np
    p = tuple(int(v) for v in pad)
    nd = x.dim()
    if len(p) == 2 * nd:
        width = [(p[2 * i], p[2 * i + 1]) for i in range(nd)]
        if not pad_from_left_axis:
            width = width[::-1]
    else:
        k = len(p) // 2
        width = [(0, 0)] * nd
        spatial = list(range(1, 1 + k)) if data_format.endswith("C") \
            else list(range(nd - k, nd))
        for i, dim in enumerate(reversed(spatial)):
            width[dim] = (p[2 * i], p[2 * i + 1])
    if mode == "constant":
        flat = [v for lr in reversed(width) for v in lr]
        return _F.pad(x, flat, mode="constant", value=float(value))
    for d, (lo, hi) in enumerate(width):
        if lo or hi:
            idx = np.pad(np.arange(x.shape[d]), (lo, hi),
                         mode=_NP_PAD[mode])
            x = torch.index_select(x, d, torch.tensor(idx, device=x.device))
    return x


def as_complex(x):
    return torch.complex(x[..., 0], x[..., 1])


def as_real(x):
    return torch.stack([torch.real(x), torch.imag(x)], dim=-1)


def diagonal_scatter(x, y, offset=0, axis1=0, axis2=1):
    return torch.diagonal_scatter(x, y.to(x.dtype), int(offset), int(axis1),
                                  int(axis2))


def select_scatter(x, values, axis, index):
    return torch.select_scatter(x, values.to(x.dtype), int(axis), int(index))


def _slices(x, axes, starts, ends, strides):
    """Basic indexing for positive strides; negative ones (torch slices
    take none) become index lists."""
    idx, picks = [_b.slice(None)] * x.dim(), []
    for ax, st, en, sd in zip(axes, starts, ends, strides):
        ax, sl = int(ax), _b.slice(int(st), int(en), int(sd))
        if int(sd) > 0:
            idx[ax] = sl
        else:
            picks.append((ax, list(range(*sl.indices(x.shape[ax])))))
    return tuple(idx), picks


def strided_slice(x, axes, starts, ends, strides):
    idx, picks = _slices(x, axes, starts, ends, strides)
    out = x[idx]
    for ax, rows in picks:
        out = torch.index_select(out, ax, torch.tensor(rows, dtype=torch.long,
                                                       device=x.device))
    return out


def slice_scatter(x, value, axes, starts, ends, strides):
    idx, picks = _slices(x, axes, starts, ends, strides)
    out = x.clone()
    v = value.to(x.dtype)
    if not picks:
        out[idx] = v
        return out
    full = [torch.arange(s, device=x.device) for s in x.shape]
    for d, sl in enumerate(idx):
        full[d] = full[d][sl]
    for ax, rows in picks:
        full[ax] = torch.tensor(rows, dtype=torch.long, device=x.device)
    grids = torch.meshgrid(*full, indexing="ij")
    return out.index_put(grids, torch.broadcast_to(v, grids[0].shape))


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    size = (int(index_num) + int(nshards) - 1) // int(nshards)
    lo, hi = int(shard_id) * size, (int(shard_id) + 1) * size
    in_range = (input >= lo) & (input < hi)
    return torch.where(in_range, input - lo,
                       torch.full_like(input, int(ignore_value)))


def diag_embed(input, offset=0, dim1=-2, dim2=-1):
    return torch.diag_embed(input, int(offset), int(dim1), int(dim2))


def fill_diagonal(x, value, offset=0, wrap=False):
    n, m = x.shape[-2], x.shape[-1]
    i = _arange(n, x)[:, None]
    j = _arange(m, x)[None, :]
    diag = (j - i) == int(offset)
    if wrap and n > m and offset == 0:
        diag = (i * m + j) % (m + 1) == 0
    return torch.where(diag, torch.tensor(value, dtype=x.dtype,
                                          device=x.device), x)


def fill_diagonal_tensor(x, y, offset=0, dim1=0, dim2=1):
    nd = x.dim()
    d1, d2 = int(dim1) % nd, int(dim2) % nd
    perm = [d for d in range(nd) if d not in (d1, d2)] + [d1, d2]
    ap = x.permute(perm)
    n, m = ap.shape[-2], ap.shape[-1]
    offset = int(offset)
    i = _arange(n, x)[:, None]
    j = _arange(m, x)[None, :]
    mask = (j - i) == offset
    dlen = _b.min(n, m - offset) if offset >= 0 else _b.min(n + offset, m)
    di = _arange(dlen, x)
    rows = di if offset >= 0 else di - offset
    cols = di + _b.max(0, offset)
    carrier = torch.zeros_like(ap)
    carrier[..., rows, cols] = y.to(x.dtype)
    out = torch.where(mask, carrier, ap)
    inv = [perm.index(d) for d in range(nd)]
    return out.permute(inv)


def temporal_shift(x, seg_num, shift_ratio=0.25, data_format="NCHW"):
    a = x.permute(0, 3, 1, 2) if data_format == "NHWC" else x
    nt, c, h, w = a.shape
    n = nt // int(seg_num)
    v = a.reshape(n, int(seg_num), c, h, w)
    c1 = int(c * shift_ratio)
    c2 = int(c * 2 * shift_ratio)
    back = _F.pad(v[:, 1:, :c1], (0, 0, 0, 0, 0, 0, 0, 1))
    fwd = _F.pad(v[:, :-1, c1:c2], (0, 0, 0, 0, 0, 0, 1, 0))
    out = torch.cat([back, fwd, v[:, :, c2:]], dim=2).reshape(nt, c, h, w)
    return out.permute(0, 2, 3, 1) if data_format == "NHWC" else out


# -- activations ------------------------------------------------------------
def tanhshrink(x): return x - torch.tanh(x)                     # noqa: E704


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772):
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


def celu(x, alpha=1.0):
    return _F.celu(x, float(alpha))


def hardsigmoid(x, slope=0.1666667, offset=0.5):
    return torch.clamp(float(slope) * x + float(offset), 0.0, 1.0)


def hardtanh(x, min=-1.0, max=1.0):
    return torch.clamp(x, float(min), float(max))


def hardshrink(x, threshold=0.5):
    t = float(threshold)
    return torch.where(torch.abs(x) > t, x, torch.zeros_like(x))


def softshrink(x, threshold=0.5):
    t = float(threshold)
    zero = torch.zeros_like(x)
    return torch.where(x > t, x - t, torch.where(x < -t, x + t, zero))


def thresholded_relu(x, threshold=1.0, value=0.0):
    return torch.where(x > float(threshold), x,
                       torch.full_like(x, float(value)))


def maxout(x, groups, axis=1):
    groups, axis = int(groups), int(axis)
    shape = list(x.shape)
    shape[axis] = shape[axis] // groups
    shape.insert(axis + 1, groups)
    return torch.amax(x.reshape(shape), dim=axis + 1)


def prelu(x, weight, data_format="NCHW"):
    if weight.numel() == 1:
        w_b = weight.reshape(())
    else:
        shape = [1] * x.dim()
        ch_axis = 1 if data_format[1] == "C" else x.dim() - 1
        shape[ch_axis] = weight.numel()
        w_b = weight.reshape(shape)
    return torch.where(x > 0, x, w_b * x)


def glu(x, axis=-1):
    return _F.glu(x, int(axis))


# -- linalg -----------------------------------------------------------------
def _sym(x):
    return (x + x.mT.conj()) / 2


def cholesky(x, upper=False):
    return torch.linalg.cholesky(x, upper=bool(upper))


def cholesky_solve(x, y, upper=False):
    y = torch.triu(y) if upper else torch.tril(y)
    return torch.cholesky_solve(x, y, upper=bool(upper))


def cholesky_inverse(x, upper=False):
    # only the factor's own triangle is read, as cho_solve reads it
    xf = x.to(torch.float32)
    xf = torch.triu(xf) if upper else torch.tril(xf)
    return torch.cholesky_inverse(xf, upper=bool(upper))


def _cov(x, rowvar, ddof, fw, aw):
    X = torch.atleast_2d(x)
    if not rowvar and X.shape[0] != 1:
        X = X.mT
    return torch.cov(X, correction=ddof, fweights=fw, aweights=aw)


def cov(x, *maybe_w, rowvar=True, ddof=True, _has_fweights=False,
        _has_aweights=False):
    it = iter(maybe_w)
    fw = next(it) if _has_fweights else None
    aw = next(it) if _has_aweights else None
    if fw is not None:
        if fw.is_floating_point() or fw.is_complex() or fw.dtype == torch.bool:
            raise TypeError("cov: fweights must be an integer tensor")
        fw = fw.long()
    return _cov(_float(x), bool(rowvar), 1 if ddof else 0, fw, aw)


def corrcoef(x, rowvar=True):
    c = _cov(_float(x), bool(rowvar), 1, None, None)
    if c.dim() == 0:
        return c / c
    d = torch.diagonal(c)
    std = torch.sqrt(torch.real(d))
    c = c / std[:, None]
    c = c / std[None, :]
    return torch.clamp(c, -1, 1)


def det(x): return torch.linalg.det(x)                          # noqa: E704
def inv(x): return torch.linalg.inv(x)                          # noqa: E704
def inverse(x): return torch.linalg.inv(x)                      # noqa: E704
def matrix_exp(x): return torch.linalg.matrix_exp(x)            # noqa: E704
def svdvals(x): return torch.linalg.svdvals(x)                  # noqa: E704


def dist(x, y, p=2):
    d = torch.abs(x - y)
    if p == _math.inf:
        return torch.amax(d)
    if p == -_math.inf:
        return torch.amin(d)
    if p == 0:
        return torch.sum((d != 0).to(d.dtype))
    p = float(p)
    return torch.sum(d ** p) ** (1.0 / p)


def eigh(x, UPLO="L"):
    return tuple(torch.linalg.eigh(_sym(x), UPLO=UPLO))


def eigvalsh(x, UPLO="L"):
    return torch.linalg.eigvalsh(_sym(x), UPLO=UPLO)


def matrix_power(x, n):
    return torch.linalg.matrix_power(x, int(n))


def pinv(x, rcond=1e-15, hermitian=False):
    return torch.linalg.pinv(x, rtol=float(rcond), hermitian=bool(hermitian))


def slogdet(x):
    sign, logabs = torch.linalg.slogdet(x)
    return torch.stack([sign, logabs])


def solve(x, y):
    return torch.linalg.solve(x, y)


def svd(x, full_matrices=False):
    return tuple(torch.linalg.svd(x, full_matrices=bool(full_matrices)))


def qr(x, mode="reduced"):
    q, r = torch.linalg.qr(x, mode=mode)
    return r if mode == "r" else (q, r)


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False):
    a, up = (x.mT, not upper) if transpose else (x, bool(upper))
    vec = y.dim() == x.dim() - 1
    b = y[..., None] if vec else y
    out = torch.linalg.solve_triangular(a, b, upper=up,
                                        unitriangular=bool(unitriangular))
    return out[..., 0] if vec else out


def cdist(x, y, p=2.0, compute_mode="use_mm_for_euclid_dist_if_necessary"):
    diff = x[..., :, None, :] - y[..., None, :, :]
    if float(p) == 2.0:
        return torch.sqrt(torch.sum(diff * diff, dim=-1) + 0.0)
    return torch.sum(torch.abs(diff) ** float(p), dim=-1) ** (1.0 / float(p))


def pdist(x, p=2.0):
    # the strict upper triangle is taken before the root, so the zero
    # diagonal never feeds sqrt's gradient
    n = x.shape[0]
    diff = x[:, None, :] - x[None, :, :]
    iu = torch.triu_indices(n, n, 1, device=x.device)
    if p == 2.0:
        return torch.sqrt(torch.sum(diff * diff, dim=-1)[iu[0], iu[1]])
    ab = torch.sum(torch.abs(diff) ** p, dim=-1)[iu[0], iu[1]]
    return ab ** (1.0 / p)


# -- special functions ------------------------------------------------------
def gammainc(x, y):
    return torch.special.gammainc(x.to(torch.float32), y.to(torch.float32))


def gammaincc(x, y):
    return torch.special.gammaincc(x.to(torch.float32), y.to(torch.float32))


def multigammaln(x, p):
    af = x.to(torch.float32)
    p = int(p)
    out = p * (p - 1) / 4.0 * torch.log(torch.tensor(
        _math.pi, dtype=torch.float32, device=x.device))
    for i in range(p):
        out = out + torch.lgamma(af - i / 2.0)
    return out


# -- logic ------------------------------------------------------------------
def _promoted(x, y):
    x, y = _same_dev(x, y)
    dt = torch.result_type(x, y)
    return x.to(dt), _dev(y, x).to(dt)


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False):
    return torch.isclose(*_promoted(x, y), rtol=float(rtol),
                         atol=float(atol), equal_nan=bool(equal_nan))


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False):
    return torch.all(isclose(x, y, rtol, atol, equal_nan))


def equal_all(x, y):
    if x.shape != y.shape:
        return torch.tensor(False, device=x.device)
    return torch.all(x == y)


# -- losses -----------------------------------------------------------------
def square_error_cost(input, label):
    return torch.square(input - label)


def log_loss(input, label, epsilon=1e-4):
    return (-label * torch.log(input + epsilon)
            - (1 - label) * torch.log(1 - input + epsilon))


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean"):
    return _reduce_loss(
        torch.clamp(-label * (input - other) + margin, min=0), reduction)


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean"):
    return _reduce_loss(
        torch.where(label == 1, input, torch.clamp(margin - input, min=0)),
        reduction)


def cosine_embedding_loss(input1, input2, label, margin=0, reduction="mean"):
    cos = torch.sum(input1 * input2, dim=-1) / (
        torch.linalg.vector_norm(input1, dim=-1)
        * torch.linalg.vector_norm(input2, dim=-1) + 1e-12)
    loss = torch.where(label == 1, 1 - cos, torch.clamp(cos - margin, min=0))
    return _reduce_loss(loss, reduction)


def soft_margin_loss(input, label, reduction="mean"):
    return _reduce_loss(torch.log1p(torch.exp(-label * input)), reduction)


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction="mean"):
    def d(u, v):
        return torch.sum(torch.abs(u - v + epsilon) ** p, dim=-1) ** (1.0 / p)
    d_pos = d(input, positive)
    d_neg = d(input, negative)
    if swap:
        d_neg = torch.minimum(d_neg, d(positive, negative))
    return _reduce_loss(torch.clamp(d_pos - d_neg + margin, min=0),
                        reduction)


def poisson_nll_loss(input, label, log_input=True, full=False,
                     epsilon=1e-8, reduction="mean"):
    if log_input:
        loss = torch.exp(input) - label * input
    else:
        loss = input - label * torch.log(input + epsilon)
    if full:
        stirling = (label * torch.log(label) - label
                    + 0.5 * torch.log(2 * _math.pi * label))
        loss = loss + torch.where(label > 1, stirling,
                                  torch.zeros_like(stirling))
    return _reduce_loss(loss, reduction)


def gaussian_nll_loss(input, label, variance, full=False, epsilon=1e-6,
                      reduction="mean"):
    var = torch.clamp(variance, min=epsilon)
    loss = 0.5 * (torch.log(var) + torch.square(input - label) / var)
    if full:
        loss = loss + 0.5 * torch.log(torch.tensor(
            2 * _math.pi, dtype=input.dtype, device=input.device))
    return _reduce_loss(loss, reduction)


def dice_loss(input, label, epsilon=1e-5):
    # per-sample dice averaged over the batch
    oh = _F.one_hot(torch.squeeze(label, -1).long(),
                    input.shape[-1]).to(input.dtype)
    dims = tuple(range(1, input.dim()))
    inter = torch.sum(input * oh, dim=dims)
    union = torch.sum(input, dim=dims) + torch.sum(oh, dim=dims)
    return torch.mean(1 - (2 * inter + epsilon) / (union + epsilon))


def multi_label_soft_margin_loss(input, label, *maybe_w, reduction="mean",
                                 _has_weight=False):
    loss = -(label * _F.logsigmoid(input)
             + (1 - label) * _F.logsigmoid(-input))
    if _has_weight:
        loss = loss * maybe_w[0]
    return _reduce_loss(torch.mean(loss, dim=-1), reduction)


def multi_margin_loss(input, label, *maybe_w, p=1, margin=1.0,
                      reduction="mean", _has_weight=False):
    n, c = input.shape
    lbl = label.long()
    correct = torch.gather(input, 1, lbl[:, None])
    diff = torch.clamp(margin - correct + input, min=0) ** p
    if _has_weight:
        diff = diff * maybe_w[0][lbl][:, None]
    mask = 1.0 - _F.one_hot(lbl, c).to(input.dtype)
    loss = torch.sum(diff * mask, dim=1) / c
    return _reduce_loss(loss, reduction)


def sigmoid_focal_loss(logit, label, *maybe_norm, alpha=0.25, gamma=2.0,
                       reduction="sum", _has_normalizer=False):
    p = torch.sigmoid(logit)
    ce = -(label * _F.logsigmoid(logit)
           + (1 - label) * _F.logsigmoid(-logit))
    a_t = alpha * label + (1 - alpha) * (1 - label)
    p_t = p * label + (1 - p) * (1 - label)
    loss = a_t * (1 - p_t) ** gamma * ce
    if _has_normalizer:
        loss = loss / maybe_norm[0]
    return _reduce_loss(loss, reduction)
