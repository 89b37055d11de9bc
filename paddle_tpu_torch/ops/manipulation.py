"""Shape and selection ops written by hand (counterpart of
paddle_tpu/ops/manipulation.py); the kernel-driven ones (reshape,
transpose, concat, ...) are generated and re-exported here.

Ops whose output shape depends on values (``nonzero``, ``unique``,
``unique_consecutive``, ``masked_select``) read the host where the JAX
package does, and return tensors on their input's device."""
from __future__ import annotations

import builtins

import numpy as np
import torch

from ..core import dispatch as D
from ..core.tensor import Tensor
from ._inplace import apply_inplace, rebind
from .generated.op_wrappers import (  # noqa: F401
    argsort, as_complex, as_real, broadcast_to, bucketize, concat, crop,
    diagonal_scatter, dstack, expand, expand_as, flatten, flip, fliplr,
    flipud, gather, gather_nd, hstack, index_add, index_fill, index_sample,
    index_select, masked_fill, masked_scatter, moveaxis, one_hot, pad,
    put_along_axis, repeat_interleave, reshape, roll, scatter, scatter_nd,
    scatter_nd_add, searchsorted, select_scatter, shard_index, sort,
    squeeze, stack, strided_slice, swapaxes, take_along_axis, tile, topk,
    transpose, unflatten, unsqueeze, vstack,
)

__all__ = [
    "reshape", "reshape_", "transpose", "moveaxis", "swapaxes", "concat",
    "stack", "vstack", "hstack", "dstack", "split", "vsplit", "hsplit",
    "dsplit", "tensor_split", "chunk", "squeeze", "squeeze_", "unsqueeze",
    "unsqueeze_", "flatten", "flip", "fliplr", "flipud", "roll", "tile",
    "expand", "expand_as", "broadcast_to", "broadcast_tensors", "gather",
    "gather_nd", "scatter", "scatter_", "scatter_nd", "scatter_nd_add",
    "index_select", "index_sample", "index_add", "index_put", "index_fill",
    "masked_select", "masked_fill", "masked_scatter", "take_along_axis",
    "put_along_axis", "unbind", "repeat_interleave", "unique",
    "unique_consecutive", "topk", "sort", "argsort", "searchsorted", "where",
    "nonzero", "one_hot", "unstack", "strided_slice", "slice", "crop",
    "pad", "shard_index", "as_complex", "as_real", "view", "view_as",
    "atleast_1d", "atleast_2d", "atleast_3d", "select_scatter",
    "diagonal_scatter", "flatten_", "tolist", "unflatten", "bucketize",
]


def _where(c, a, b):
    from .kernels import host_scalar
    return torch.where(c, host_scalar(a, c), host_scalar(b, c))


def where(condition, x=None, y=None, name=None):
    if x is None and y is None:
        return nonzero(condition, as_tuple=True)
    return D.apply("where", _where, (condition, x, y))


def _split_sections(shape, num_or_sections, axis):
    axis = int(axis) % len(shape)
    n = shape[axis]
    if isinstance(num_or_sections, int):
        if n % num_or_sections:
            raise AssertionError(
                f"dim {n} not divisible into {num_or_sections} sections")
        sizes = [n // num_or_sections] * num_or_sections
    else:
        sizes = [int(s.item()) if isinstance(s, Tensor) else int(s)
                 for s in num_or_sections]
        if -1 in sizes:
            i = sizes.index(-1)
            sizes[i] = n - (sum(sizes) + 1)
    offsets, o = [], 0
    for s in sizes:
        offsets.append(o)
        o += s
    return sizes, offsets, axis


def _split(a, sizes, offsets, axis):
    return tuple(torch.narrow(a, axis, o, s) for s, o in zip(sizes, offsets))


def split(x, num_or_sections, axis=0, name=None):
    if isinstance(axis, Tensor):
        axis = int(axis.item())
    sizes, offsets, axis = _split_sections(tuple(x.shape), num_or_sections,
                                           axis)
    out = D.apply("split", _split, (x,),
                  {"sizes": tuple(sizes), "offsets": tuple(offsets),
                   "axis": axis})
    return list(out) if isinstance(out, tuple) else [out]


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis)


def host_values(x):
    """x's values as numpy (a host read, refused inside capture_step)."""
    D.check_host_read()
    if not isinstance(x, Tensor):
        return np.asarray(x)
    return x.numpy()


def device_of(x):
    """The device of a Tensor (the CPU for anything else)."""
    return x._data.device if isinstance(x, Tensor) else \
        torch.device("cpu")


def _on(arr, device):
    return Tensor(torch.as_tensor(np.ascontiguousarray(arr)).to(device))


def nonzero(x, as_tuple=False, name=None):
    nz = np.nonzero(host_values(x))
    dev = device_of(x)
    if as_tuple:
        return tuple(_on(i[:, None].astype(np.int64), dev) for i in nz)
    return _on(np.stack(nz, axis=1).astype(np.int64), dev)


def _masked_select(a, m):
    return a[torch.broadcast_to(m, a.shape)]


def masked_select(x, mask, name=None):
    D.check_host_read()
    return D.apply("masked_select", _masked_select, (x, mask))


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    res = np.unique(host_values(x), return_index=return_index,
                    return_inverse=return_inverse,
                    return_counts=return_counts, axis=axis)
    dev = device_of(x)
    if not isinstance(res, tuple):
        return _on(res, dev)
    return tuple(_on(r, dev) for r in res)


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, dtype="int64", name=None):
    a = host_values(x)
    if axis is None:
        a = a.ravel()
        axis = 0
    mask = np.ones(a.shape[axis], dtype=bool)
    sl = [builtins.slice(None)] * a.ndim
    if a.shape[axis] > 1:
        d = np.diff(a, axis=axis)
        other = tuple(i for i in range(a.ndim) if i != axis)
        mask[1:] = np.any(d != 0, axis=other) if a.ndim > 1 else (d != 0)
    sl[axis] = mask
    dev = device_of(x)
    outs = [_on(a[tuple(sl)], dev)]
    if return_inverse:
        outs.append(_on((np.cumsum(mask) - 1).astype(np.int64), dev))
    if return_counts:
        idx = np.nonzero(mask)[0]
        counts = np.diff(np.concatenate([idx, [a.shape[axis]]]))
        outs.append(_on(counts.astype(np.int64), dev))
    return outs[0] if len(outs) == 1 else tuple(outs)


def _slice(a, axes, starts, ends):
    idx = [builtins.slice(None)] * a.dim()
    for ax, st, en in zip(axes, starts, ends):
        idx[ax] = builtins.slice(st, en)
    return a[tuple(idx)]


def slice(input, axes, starts, ends, name=None):
    def norm(v):
        if isinstance(v, Tensor):
            return [int(i) for i in v.tolist()]
        return [int(i.item()) if isinstance(i, Tensor) else int(i)
                for i in v]
    return D.apply("slice", _slice, (input,),
                   {"axes": tuple(int(a) for a in axes),
                    "starts": tuple(norm(starts)),
                    "ends": tuple(norm(ends))})


def view(x, shape_or_dtype, name=None):
    if isinstance(shape_or_dtype, (list, tuple)):
        return reshape(x, shape_or_dtype)
    return x.astype(shape_or_dtype)


def view_as(x, other, name=None):
    return reshape(x, other.shape)


def tensor_split(x, num_or_indices, axis=0, name=None):
    n = x.shape[axis % x.ndim]
    if isinstance(num_or_indices, int):
        base, extra = divmod(n, num_or_indices)
        sizes = [base + (1 if i < extra else 0)
                 for i in range(num_or_indices)]
    else:
        idx = [0] + [int(i) for i in num_or_indices] + [n]
        sizes = [idx[i + 1] - idx[i] for i in range(len(idx) - 1)]
    return split(x, sizes, axis)


def vsplit(x, num_or_indices, name=None):
    return tensor_split(x, num_or_indices, axis=0)


def hsplit(x, num_or_indices, name=None):
    return tensor_split(x, num_or_indices, axis=1)


def dsplit(x, num_or_indices, name=None):
    return tensor_split(x, num_or_indices, axis=2)


def reshape_(x, shape, name=None):
    return rebind(x, reshape(x, shape))


def squeeze_(x, axis=None, name=None):
    return rebind(x, squeeze(x, axis))


def unsqueeze_(x, axis, name=None):
    return rebind(x, unsqueeze(x, axis))


def flatten_(x, start_axis=0, stop_axis=-1, name=None):
    return rebind(x, flatten(x, start_axis, stop_axis))


def scatter_(x, index, updates, overwrite=True, name=None):
    return apply_inplace(x, lambda s: scatter(s, index, updates, overwrite))


def broadcast_tensors(inputs, name=None):
    shape = torch.broadcast_shapes(*[tuple(t.shape) for t in inputs])
    return [broadcast_to(t, list(shape)) for t in inputs]


def _index_put(a, v, *idx, accumulate):
    v = v.to(a.device) if v.device != a.device else v
    return a.index_put(tuple(i.long() if not i.dtype == torch.bool else i
                             for i in idx), v.to(a.dtype),
                       accumulate=accumulate)


def index_put(x, indices, value, accumulate=False, name=None):
    return D.apply("index_put", _index_put, (x, value) + tuple(indices),
                   {"accumulate": bool(accumulate)})


def _unbind(a, axis):
    return tuple(torch.unbind(a, dim=axis))


def unbind(input, axis=0, name=None):
    return list(D.apply("unbind", _unbind, (input,), {"axis": int(axis)}))


unstack = unbind


def atleast_1d(*inputs, name=None):
    outs = [reshape(t, [1]) if t.ndim == 0 else t for t in inputs]
    return outs[0] if len(outs) == 1 else outs


def atleast_2d(*inputs, name=None):
    outs = []
    for t in inputs:
        if t.ndim == 0:
            outs.append(reshape(t, [1, 1]))
        elif t.ndim == 1:
            outs.append(reshape(t, [1, -1]))
        else:
            outs.append(t)
    return outs[0] if len(outs) == 1 else outs


def atleast_3d(*inputs, name=None):
    outs = []
    for t in inputs:
        t2 = atleast_2d(t)
        outs.append(unsqueeze(t2, -1) if t2.ndim == 2 else t2)
    return outs[0] if len(outs) == 1 else outs


def tolist(x):
    return x.tolist()
