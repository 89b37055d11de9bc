"""Shape and selection ops written by hand (counterpart of the ported part
of paddle_tpu/ops/manipulation.py): where, split, chunk.  The
kernel-driven ones (reshape, transpose, concat, ...) are generated."""
from __future__ import annotations

import torch

from ..core import dispatch as D
from ..core.tensor import Tensor
from .generated.op_wrappers import (  # noqa: F401
    broadcast_to, concat, expand, expand_as, flatten, gather, index_select,
    reshape, squeeze, stack, tile, transpose, unsqueeze,
)

__all__ = ["where", "split", "chunk", "reshape", "transpose", "concat",
           "stack", "flatten", "unsqueeze", "squeeze", "expand", "expand_as",
           "broadcast_to", "tile", "gather", "index_select"]


def _where(c, a, b):
    from .kernels import host_scalar
    return torch.where(c, host_scalar(a, c), host_scalar(b, c))


def where(condition, x=None, y=None, name=None):
    if x is None and y is None:
        raise NotImplementedError(
            "where(condition) (nonzero) is not ported yet (ROADMAP.md "
            "Queue 1 item 13)")
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
