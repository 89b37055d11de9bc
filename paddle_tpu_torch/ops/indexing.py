"""``__getitem__`` / ``__setitem__`` (counterpart of
paddle_tpu/ops/indexing.py).  torch indexes natively: ints and slices,
integer tensors, and boolean masks (a mask's result shape is read from
the card, as the JAX package reads it on the host).  ``setitem`` writes
into a copy and rebinds the tensor, as the JAX package does, so the
gradient flows to both the old value and the written one."""
from __future__ import annotations

import builtins

import numpy as np
import torch

from ..core import dispatch as D
from ..core.tensor import Tensor

__all__ = ["getitem", "setitem"]


def _normalize_index(x, index):
    """(dynamic index tensors, static spec) for the dispatcher."""
    if not isinstance(index, tuple):
        index = (index,)
    dynamic, spec = [], []
    dev = x._data.device
    for e in index:
        if isinstance(e, Tensor):
            if e.ndim == 0 and e.dtype.name != "bool":
                spec.append(("I", int(e.item())))
            else:
                dynamic.append(e)
                spec.append(("T",))
        elif isinstance(e, (np.ndarray, list)) or (
                isinstance(e, tuple) and not builtins.any(
                    isinstance(v, builtins.slice) for v in e)):
            dynamic.append(torch.as_tensor(np.asarray(e), device=dev))
            spec.append(("T",))
        elif isinstance(e, builtins.slice):
            def iv(v):
                if v is None:
                    return None
                return int(v.item()) if isinstance(v, Tensor) else int(v)
            spec.append(("S", iv(e.start), iv(e.stop), iv(e.step)))
        elif e is Ellipsis:
            spec.append(("E",))
        elif e is None:
            spec.append(("N",))
        elif isinstance(e, bool):
            spec.append(("B", e))
        elif isinstance(e, (int, np.integer)):
            spec.append(("I", int(e)))
        else:
            raise TypeError(f"Unsupported index element: {e!r}")
    return dynamic, tuple(spec)


def _rebuild(idx, spec):
    out = []
    it = iter(idx)
    for s in spec:
        kind = s[0]
        if kind == "T":
            t = next(it)
            out.append(t.long() if t.dtype not in (torch.bool, torch.int64)
                       else t)
        elif kind == "S":
            out.append(builtins.slice(s[1], s[2], s[3]))
        elif kind == "E":
            out.append(Ellipsis)
        elif kind == "N":
            out.append(None)
        else:
            out.append(s[1])
    return tuple(out)


def _getitem(a, *idx, spec):
    return a[_rebuild(idx, spec)]


def getitem(x, index):
    dynamic, spec = _normalize_index(x, index)
    return D.apply("getitem", _getitem, (x, *dynamic), {"spec": spec})


def _setitem(a, v, *idx, spec):
    out = a.clone()
    from .kernels import host_scalar
    v = host_scalar(v, a)
    out[_rebuild(idx, spec)] = v.to(dtype=a.dtype) if torch.is_tensor(v) \
        else v
    return out


def setitem(x, index, value):
    dynamic, spec = _normalize_index(x, index)
    out = D.apply("setitem", _setitem, (x, value, *dynamic), {"spec": spec})
    x._data, x._sg = out._data, out._sg
    return x
