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

