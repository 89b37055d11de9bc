"""PyLayer: user-defined forward/backward (counterpart of
paddle_tpu/autograd/py_layer.py), on ``torch.autograd.Function``.

The user's static ``forward`` runs with gradients off on ``Tensor``
arguments; its ``backward`` gets one ``Tensor`` a forward output and
returns one gradient a forward ``Tensor`` input (None at stop-gradient
positions).
"""
from __future__ import annotations

import torch

from ..core import dispatch
from ..core.tensor import Tensor

__all__ = ["PyLayer", "PyLayerContext"]


class PyLayerContext:
    def __init__(self):
        self.container = ()
        self._non_differentiable = set()
        self._materialize_grads = True

    def save_for_backward(self, *tensors):
        self.container = tensors

    def saved_tensor(self):
        """A method (not a property), as in the reference API."""
        return self.container

    def saved_tensor_list(self):
        return list(self.container)

    def mark_non_differentiable(self, *tensors):
        self._non_differentiable.update(id(t) for t in tensors)

    def set_materialize_grads(self, value):
        self._materialize_grads = bool(value)


class _Function(torch.autograd.Function):
    @staticmethod
    def forward(fctx, layer, ctx, args, kwargs, positions, *datas):
        args = list(args)
        for i, d in zip(positions, datas):
            args[i] = Tensor._wrap(d.detach())
        outputs = layer.forward(ctx, *args, **kwargs)
        multi = isinstance(outputs, (tuple, list))
        outs = tuple(outputs) if multi else (outputs,)
        fctx.layer, fctx.ctx = layer, ctx
        ctx._multi = multi
        fctx.n_in = len(datas)
        fctx.set_materialize_grads(ctx._materialize_grads)
        datas_out = []
        for o in outs:
            d = o._data if isinstance(o, Tensor) else torch.as_tensor(o)
            datas_out.append(d)
        nd = [d for o, d in zip(outs, datas_out)
              if id(o) in ctx._non_differentiable]
        if nd:
            fctx.mark_non_differentiable(*nd)
        return tuple(datas_out)

    @staticmethod
    def backward(fctx, *grads):
        gin = tuple(None if g is None else Tensor._wrap(g) for g in grads)
        with dispatch.no_grad():
            out = fctx.layer.backward(fctx.ctx, *gin)
        if not isinstance(out, (tuple, list)):
            out = (out,)
        out = tuple(None if g is None else
                    (g._data if isinstance(g, Tensor) else torch.as_tensor(g))
                    for g in out)
        if len(out) != fctx.n_in:
            raise ValueError(
                f"PyLayer backward returned {len(out)} gradients for "
                f"{fctx.n_in} tensor inputs")
        return (None, None, None, None, None) + out


class PyLayer:
    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *args):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        ctx = PyLayerContext()
        positions = tuple(i for i, a in enumerate(args)
                          if isinstance(a, Tensor))
        datas = tuple(args[i]._data for i in positions)
        shell = tuple(None if isinstance(a, Tensor) else a for a in args)
        outs = _Function.apply(cls, ctx, shell, kwargs, positions, *datas)
        wrapped = tuple(Tensor._wrap(o) for o in outs)
        return wrapped if ctx._multi else wrapped[0]
