"""Operators of the PyTorch port: hand-written CUDA kernels with their
plain PyTorch versions (``flash_attention``, ``fused_norms``, ...), and the
eager op surface over ``Tensor`` (counterpart of paddle_tpu/ops/): the
kernel-driven ops generated from ``ops.yaml`` and the hand-written op
modules.  ``monkey_patch_tensor()`` binds the Tensor methods and
operators."""
from __future__ import annotations

import torch

from . import (array, creation, indexing, linalg, logic, manipulation,
               math, misc, random)
from ._inplace import apply_inplace
from .generated import op_wrappers

_MODULES = (math, manipulation, logic, linalg, creation, random, array,
            misc, op_wrappers)


def _collect():
    ns = {}
    for mod in _MODULES:
        for name in getattr(mod, "__all__", ()):
            fn = getattr(mod, name, None)
            if callable(fn):
                ns.setdefault(name, fn)
    return ns


PUBLIC_OPS = _collect()

# the root surface's in-place twins, small extra ops, aliases and
# constants, derived from the ops above (ops/inplace_aliases.py)
from . import inplace_aliases as _ia  # noqa: E402

PUBLIC_OPS.update(_ia.EXTRA_OPS)
PUBLIC_OPS.update(_ia.derive_inplace(PUBLIC_OPS))
for _alias, _target in _ia.ALIASES.items():
    if _target in PUBLIC_OPS:
        PUBLIC_OPS.setdefault(_alias, PUBLIC_OPS[_target])
PUBLIC_OPS.update(_ia.CONSTANTS)


def monkey_patch_tensor():
    from ..core.tensor import Tensor
    from .generated import bind_tensor_methods

    bind_tensor_methods(Tensor)

    alias = {
        "mod": math.mod, "floor_mod": math.mod, "pow": math.pow,
        "abs": math.abs, "t": manipulation.transpose,
        "add": math.add, "subtract": math.subtract,
        "multiply": math.multiply, "divide": math.divide,
        "matmul": math.matmul, "dot": math.dot,
        "unflatten": manipulation.unflatten,
    }
    for name, fn in alias.items():
        setattr(Tensor, name, fn)

    def _rbin(fn):
        def op(self, other):
            return fn(other, self)
        return op

    Tensor.__add__ = math.add
    Tensor.__radd__ = math.add
    Tensor.__sub__ = math.subtract
    Tensor.__rsub__ = _rbin(math.subtract)
    Tensor.__mul__ = math.multiply
    Tensor.__rmul__ = math.multiply
    Tensor.__truediv__ = math.divide
    Tensor.__rtruediv__ = _rbin(math.divide)
    Tensor.__floordiv__ = math.floor_divide
    Tensor.__rfloordiv__ = _rbin(math.floor_divide)
    Tensor.__mod__ = math.mod
    Tensor.__rmod__ = _rbin(math.mod)
    Tensor.__pow__ = math.pow
    Tensor.__rpow__ = _rbin(math.pow)
    Tensor.__matmul__ = math.matmul
    Tensor.__rmatmul__ = _rbin(math.matmul)
    Tensor.__neg__ = math.neg
    Tensor.__abs__ = math.abs
    Tensor.__invert__ = logic.logical_not
    Tensor.__and__ = logic.logical_and
    Tensor.__or__ = logic.logical_or
    Tensor.__eq__ = logic.equal
    Tensor.__ne__ = logic.not_equal
    Tensor.__lt__ = logic.less_than
    Tensor.__le__ = logic.less_equal
    Tensor.__gt__ = logic.greater_than
    Tensor.__ge__ = logic.greater_equal
    Tensor.__getitem__ = indexing.getitem
    Tensor.__setitem__ = indexing.setitem

    # one in-place path for methods, operators and the root twins: the
    # result goes into self's storage (ops/_inplace.py)
    def _iop(fn):
        def op(self, *args, **kwargs):
            return apply_inplace(self, lambda s: fn(s, *args, **kwargs))
        return op

    Tensor.__iadd__ = Tensor.add_ = _iop(math.add)
    Tensor.__isub__ = _iop(math.subtract)
    Tensor.__imul__ = _iop(math.multiply)
    Tensor.__itruediv__ = _iop(math.divide)
    Tensor.zero_ = _iop(creation.zeros_like)
    Tensor.uniform_ = random.uniform_
    Tensor.normal_ = random.normal_
    Tensor.exponential_ = random.exponential_
    Tensor.sigmoid = lambda self, name=None: op_wrappers.sigmoid(self)

    # the rest of the reference's method surface: every derived in-place
    # twin, and the free functions it also binds as methods
    extra_methods = tuple(n for n in PUBLIC_OPS if n.endswith("_")) + (
        "block_diag", "add_n", "inverse", "isin", "broadcast_shape",
        "is_tensor", "reverse", "scatter_nd", "slice_scatter",
        "top_p_sampling", "broadcast_tensors", "multi_dot", "frexp",
        "trapezoid", "cumulative_trapezoid", "polar", "sigmoid",
        "as_strided", "unfold", "diag_embed", "negative", "less",
        "gammainc", "gammaincc", "cast", "mv", "matrix_transpose",
        "multiplex", "multigammaln", "histogram_bin_edges", "histogramdd",
        "cond", "cholesky_inverse", "ormqr", "svd_lowrank",
    )
    for name in extra_methods:
        fn = PUBLIC_OPS.get(name)
        if fn is not None and callable(fn) and (
                name.endswith("_") or not hasattr(Tensor, name)):
            setattr(Tensor, name, fn)

    def _set(self, source=None, shape=None, **kw):
        """Storage swap (Tensor.set_): source's values, or zeros of
        shape."""
        if source is not None:
            src = source._data if isinstance(source, Tensor) else \
                torch.as_tensor(source, device=self._data.device)
            self._data = src
        elif shape is not None:
            self._data = torch.zeros(tuple(int(s) for s in shape),
                                     dtype=self._data.dtype,
                                     device=self._data.device)
        return self

    def _resize(self, shape, fill_zero=False):
        """Tensor.resize_: the flat values cut or zero-padded to shape."""
        n_new = 1
        for s in shape:
            n_new *= int(s)
        flat = self._data.reshape(-1)
        if n_new <= flat.shape[0]:
            out = flat[:n_new]
        else:
            out = torch.cat([flat, torch.zeros(n_new - flat.shape[0],
                                               dtype=flat.dtype,
                                               device=flat.device)])
        self._data = out.reshape(tuple(int(s) for s in shape))
        return self

    Tensor.set_ = _set
    Tensor.resize_ = _resize
