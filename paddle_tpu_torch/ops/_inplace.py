"""In-place twins (``x.exp_()``, ``paddle.scatter_(x, ...)``): the op's
result written into x's own storage.  The JAX package rebinds x to a new
buffer (XLA buffers are immutable); here x keeps its storage, so views
and CUDA graphs that hold it see the write.

The op runs on a copy of x when autograd records, so the tensors its
backward saved are not the ones overwritten, and x's gradient flows
through the copy.  A result of another shape or dtype (``reshape_``,
``cast_``, a comparison) cannot go into x's storage: x is then rebound
to it, as in the JAX package.  A leaf that requires grad refuses an
in-place write while autograd records, with Paddle's error."""
from __future__ import annotations

import torch

from ..core.tensor import Tensor

__all__ = ["apply_inplace", "rebind"]

LEAF_MSG = ("Leaf Tensor ({}) that doesn't stop gradient can't use "
            "inplace strategy.")


def rebind(x, out):
    """x takes out's storage and autograd history."""
    x._data, x._sg = out._data, out._sg
    return x


def apply_inplace(x, compute):
    """x updated to ``compute(x')``, where x' holds x's values."""
    d = x._data
    if torch.is_grad_enabled() and d.requires_grad and d.grad_fn is None:
        raise RuntimeError(LEAF_MSG.format(x.name))
    src = Tensor._wrap(d.clone()) if torch.is_grad_enabled() else x
    out = compute(src)
    o = out._data
    if o.shape != d.shape or o.dtype != d.dtype:
        return rebind(x, out)
    if o.requires_grad:
        d.copy_(o)
    else:
        with torch.no_grad():
            d.copy_(o)
    x._sg = not d.requires_grad
    return x
