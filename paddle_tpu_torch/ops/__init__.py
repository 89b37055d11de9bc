"""Operators of the PyTorch port: hand-written CUDA kernels with their
plain PyTorch versions (``flash_attention``, ``fused_norms``, ...), and the
eager op surface over ``Tensor`` (counterpart of paddle_tpu/ops/): the
kernel-driven ops generated from ``ops.yaml`` and the hand-written op
modules.  ``monkey_patch_tensor()`` binds the Tensor methods and
operators."""
from __future__ import annotations

from . import creation, indexing, logic, manipulation, math, random
from .generated import op_wrappers

_MODULES = (math, manipulation, logic, creation, random, op_wrappers)


def _collect():
    ns = {}
    for mod in _MODULES:
        for name in getattr(mod, "__all__", ()):
            fn = getattr(mod, name, None)
            if callable(fn):
                ns.setdefault(name, fn)
    return ns


PUBLIC_OPS = _collect()


def _inplace(t, out):
    t._data, t._sg = out._data, out._sg
    return t


def monkey_patch_tensor():
    from ..core.tensor import Tensor
    from .generated import bind_tensor_methods

    bind_tensor_methods(Tensor)

    alias = {
        "mod": math.mod, "floor_mod": math.mod, "pow": math.pow,
        "abs": math.abs, "t": manipulation.transpose,
        "add": math.add, "subtract": math.subtract,
        "multiply": math.multiply, "divide": math.divide,
        "matmul": math.matmul,
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

    def _iop(fn):
        def op(self, other):
            return _inplace(self, fn(self, other))
        return op

    Tensor.__iadd__ = _iop(math.add)
    Tensor.__isub__ = _iop(math.subtract)
    Tensor.__imul__ = _iop(math.multiply)
    Tensor.__itruediv__ = _iop(math.divide)
    Tensor.add_ = _iop(math.add)
    Tensor.subtract_ = _iop(math.subtract)
    Tensor.multiply_ = _iop(math.multiply)
    Tensor.divide_ = _iop(math.divide)
    Tensor.clip_ = lambda self, min=None, max=None, name=None: \
        _inplace(self, math.clip(self, min, max))
    Tensor.scale_ = lambda self, scale=1.0, bias=0.0, \
        bias_after_scale=True, act=None, name=None: \
        _inplace(self, math.scale(self, scale, bias, bias_after_scale))
    Tensor.zero_ = lambda self: _inplace(self, creation.zeros_like(self))
    Tensor.fill_ = lambda self, value: \
        _inplace(self, creation.full_like(self, value))
    Tensor.uniform_ = random.uniform_
    Tensor.normal_ = random.normal_
    Tensor.sigmoid = lambda self, name=None: op_wrappers.sigmoid(self)
