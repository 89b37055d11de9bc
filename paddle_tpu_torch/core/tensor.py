"""Eager Tensor (counterpart of paddle_tpu/core/tensor.py).

A ``Tensor`` wraps a ``torch.Tensor`` (``_data``); torch's autograd holds
the graph.  ``stop_gradient`` is Paddle's flag over torch's
``requires_grad``: ``to_tensor`` gives True, a ``Parameter`` False, an op
output ``not any input requires grad``.  A leaf's ``.grad`` is torch's,
accumulating across backward calls until ``clear_grad``.  The op-method
surface (``reshape``, ``sum``, the arithmetic dunders, ...) is attached by
``paddle_tpu_torch.ops.monkey_patch_tensor()``.
"""
from __future__ import annotations

import numpy as np
import torch

from . import dispatch as _D
from . import place as place_mod
from .dtype import convert_dtype, dtype as _dtype_cls

__all__ = ["Tensor", "Parameter", "to_tensor"]

_tensor_counter = [0]
_DIFF_KINDS = (torch.float16, torch.bfloat16, torch.float32, torch.float64,
               torch.complex64, torch.complex128)


def _new_name():
    _tensor_counter[0] += 1
    return f"generated_tensor_{_tensor_counter[0]}"


def _differentiable(t: torch.Tensor) -> bool:
    return t.dtype in _DIFF_KINDS


class Tensor:
    __slots__ = (
        "_data", "_sg", "name", "persistable", "trainable", "_backward_hooks",
        "_grad_w", "_dist_attr", "__weakref__", "__dict__",
    )

    def __init__(self, data, stop_gradient: bool = True, name: str | None = None):
        if isinstance(data, Tensor):
            data = data._data
        elif not isinstance(data, torch.Tensor):
            data = _D.to_torch(data)
            if data.device.type == "cpu" and data.dim() == 0:
                data = data.to(_D._default_device())
        if stop_gradient and data.requires_grad:
            data = data.detach()
        self._init(data, name)
        self.stop_gradient = stop_gradient

    def _init(self, data, name):
        self._data = data
        self._sg = not data.requires_grad
        self.persistable = False
        self.trainable = data.requires_grad
        self._backward_hooks = []
        self._grad_w = None
        self._dist_attr = None
        self.name = name if name is not None else _new_name()

    @classmethod
    def _wrap(cls, data: torch.Tensor) -> "Tensor":
        """An op output as a Tensor; stop_gradient follows torch."""
        t = cls.__new__(cls)
        t._init(data, None)
        return t

    # ---- metadata ----
    @property
    def shape(self):
        return list(self._data.shape)

    @property
    def dtype(self) -> _dtype_cls:
        return convert_dtype(self._data.dtype)

    @property
    def ndim(self):
        return self._data.dim()

    @property
    def size(self):
        return int(self._data.numel())

    @property
    def place(self):
        d = self._data.device
        if d.type == "cpu":
            return place_mod.CPUPlace()
        return place_mod.CUDAPlace(d.index or 0)

    @property
    def is_leaf(self):
        return self._data.grad_fn is None

    def numel(self):
        return self.size

    def dim(self):
        return self.ndim

    def rank(self):
        return self.ndim

    def element_size(self):
        return self._data.element_size()

    # ---- autograd ----
    @property
    def stop_gradient(self):
        return self._sg

    @stop_gradient.setter
    def stop_gradient(self, value):
        value = bool(value)
        d = self._data
        if _differentiable(d):
            if value and d.requires_grad:
                if d.grad_fn is None:
                    d.requires_grad_(False)
                else:
                    self._data = d.detach()
            elif not value and not d.requires_grad:
                if d.grad_fn is not None:
                    self._data = d = d.detach()
                d.requires_grad_(True)
                for h in self._backward_hooks:
                    self._attach_hook(h)
        self._sg = value

    def _rebind(self, data: torch.Tensor):
        """Swap storage (Layer.to / astype): keeps stop_gradient and
        re-attaches the gradient hooks."""
        data = data.detach()
        self._data = data
        if not self._sg and _differentiable(data):
            data.requires_grad_(True)
            for h in self._backward_hooks:
                self._attach_hook(h)

    @property
    def grad(self):
        g = self._data.grad
        if g is None:
            self._grad_w = None
            return None
        if g._is_zerotensor():
            # a backward that knows its gradient is zero (sgn) leaves a
            # ZeroTensor, which has no storage to read: give it one
            g = self._data.grad = torch.zeros(g.shape, dtype=g.dtype,
                                              device=g.device)
        w = self._grad_w
        if w is None or w._data is not g:
            w = self._grad_w = Tensor._wrap(g)
        return w

    @grad.setter
    def grad(self, value):
        if value is None:
            self._data.grad = None
        else:
            if not isinstance(value, Tensor):
                value = Tensor(value)
            g = value._data
            if g.dtype != self._data.dtype:
                # a gradient in another type (an f32 gradient for a bf16
                # O2 parameter), as the JAX package accepts
                if hasattr(self._data, "grad_dtype"):
                    self._data.grad_dtype = None
                else:
                    g = g.to(self._data.dtype)
            self._data.grad = g
        self._grad_w = None

    _grad = grad

    def backward(self, grad_tensor=None, retain_graph=False):
        from .tape import backward as _backward
        _backward([self], [grad_tensor] if grad_tensor is not None else None,
                  retain_graph=retain_graph)

    def clear_grad(self, set_to_zero=False):
        g = self._data.grad
        if set_to_zero and g is not None:
            g.zero_()
        else:
            self._data.grad = None
            self._grad_w = None

    clear_gradient = clear_grad

    def _attach_hook(self, hook):
        def run(g):
            res = hook(Tensor._wrap(g))
            if res is None:
                return None
            return res._data if isinstance(res, Tensor) else res
        hook._torch_handle = self._data.register_hook(run)

    def register_hook(self, hook):
        """Hook on this tensor's gradient; it fires once a backward, with
        the full gradient, and may return a replacement."""
        self._backward_hooks.append(hook)
        if self._data.requires_grad:
            self._attach_hook(hook)
        owner = self

        class _Handle:
            def remove(handle_self):
                try:
                    owner._backward_hooks.remove(hook)
                except ValueError:
                    pass
                h = getattr(hook, "_torch_handle", None)
                if h is not None:
                    h.remove()
        return _Handle()

    def detach(self) -> "Tensor":
        return Tensor(self._data.detach(), stop_gradient=True,
                      name=self.name + "_detached")

    def detach_(self):
        self._data = self._data.detach()
        self._sg = True
        return self

    def clone(self) -> "Tensor":
        from ..ops.creation import assign
        return assign(self)

    # ---- conversion / host reads ----
    def numpy(self) -> np.ndarray:
        _D.check_host_read()
        d = self._data.detach()
        if d.dtype in (torch.bfloat16, torch.float8_e4m3fn,
                       torch.float8_e5m2):
            d = d.float()
        if d.device.type == "cpu":
            return d.numpy().copy()
        return d.cpu().numpy()

    def item(self, *args):
        _D.check_host_read()
        if args:
            return self.numpy().item(*args)
        return self._data.detach().item()

    def tolist(self):
        return self.numpy().tolist()

    def astype(self, dt) -> "Tensor":
        target = convert_dtype(dt).torch_dtype
        return _D.apply("cast", _cast_impl, (self,), {"target": target})

    cast = astype

    def to(self, *args, **kwargs):
        device = kwargs.get("device")
        dt = kwargs.get("dtype")
        for a in args:
            if isinstance(a, (str, place_mod.Place, torch.device)):
                try:
                    dt_try = convert_dtype(a) if isinstance(a, str) else None
                except (TypeError, ValueError):
                    dt_try = None
                if dt_try is not None:
                    dt = a
                else:
                    device = a
            elif isinstance(a, (_dtype_cls, torch.dtype)):
                dt = a
        out = self
        if device is not None:
            p = place_mod._parse_device(device)
            out = _D.apply("to_device", _to_device_impl, (out,),
                           {"device": p.torch_device()})
        if dt is not None:
            out = out.astype(dt)
        return out

    def cpu(self):
        return self.to(device="cpu")

    def cuda(self, device_id=0, blocking=True):
        return self.to(device=f"gpu:{device_id}")

    def pin_memory(self):
        return self.cpu()

    # ---- mutation ----
    def set_value(self, value):
        if isinstance(value, Tensor):
            value = value._data
        src = _D.to_torch(value, self._data.device) \
            if not isinstance(value, torch.Tensor) else value
        if tuple(src.shape) != tuple(self._data.shape):
            raise ValueError(
                f"set_value shape mismatch: {tuple(src.shape)} vs "
                f"{tuple(self._data.shape)}")
        with torch.no_grad():
            self._data.copy_(src)

    def copy_(self, other, blocking=True):
        self.set_value(other)
        return self

    # ---- python protocol ----
    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of a 0-d tensor")
        return self._data.shape[0]

    def __bool__(self):
        _D.check_host_read()
        return bool(self._data.detach())

    def __float__(self):
        _D.check_host_read()
        return float(self._data.detach())

    def __int__(self):
        _D.check_host_read()
        return int(self._data.detach())

    def __index__(self):
        _D.check_host_read()
        return int(self._data.detach())

    def __repr__(self):
        grad_str = "" if self.stop_gradient else ", stop_gradient=False"
        return (f"Tensor(shape={self.shape}, dtype={self.dtype.name}, "
                f"place={self.place}{grad_str},\n"
                f"       {np.array2string(self.numpy(), prefix='       ')})")

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __hash__(self):
        return id(self)

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a.astype(dtype) if dtype is not None else a

    def __dlpack__(self, *a, **k):
        return self._data.__dlpack__(*a, **k)


def _cast_impl(x, target):
    return x.to(target)


def _to_device_impl(x, device):
    return x.to(device)


class Parameter(Tensor):
    """Trainable tensor: stop_gradient=False, persistable."""

    def __init__(self, data, name=None, trainable=True):
        if isinstance(data, Tensor):
            data = data._data
        if isinstance(data, torch.Tensor):
            data = data.detach()
        super().__init__(data, stop_gradient=not trainable, name=name)
        self.persistable = True
        self.trainable = trainable

    def __repr__(self):
        return "Parameter containing:\n" + super().__repr__()


def _infer_dtype(data):
    probe = data
    while isinstance(probe, (list, tuple)) and len(probe):
        probe = probe[0]
    if isinstance(probe, Tensor):
        return probe._data.dtype
    if isinstance(probe, (bool, np.bool_)):
        return torch.bool
    if isinstance(probe, (int, np.integer)) and not isinstance(
            probe, np.ndarray):
        return torch.int64
    if isinstance(probe, float):
        return torch.float32
    if isinstance(probe, complex):
        return torch.complex64
    return None


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    """paddle.to_tensor: a tensor on ``place`` (the default place when
    None) from Python, numpy or Tensor data.  Python ints become int64,
    floats float32, bools bool; numpy arrays keep their dtype."""
    dev = (place_mod._parse_device(place) if place is not None
           else place_mod._current_place()).torch_device()
    tdt = convert_dtype(dtype).torch_dtype if dtype is not None else None
    if isinstance(data, Tensor):
        arr = data._data.detach()
    elif isinstance(data, torch.Tensor):
        arr = data.detach()
    elif isinstance(data, (list, tuple)) and data and \
            isinstance(data[0], Tensor):
        arr = torch.stack([d._data.detach() for d in data])
    else:
        if not isinstance(data, np.ndarray) and tdt is None:
            tdt = _infer_dtype(data)
        arr = _D.to_torch(np.asarray(data), torch.device("cpu"))
    arr = arr.to(device=dev, dtype=tdt if tdt is not None else arr.dtype,
                 copy=True)
    return Tensor(arr, stop_gradient=stop_gradient)
