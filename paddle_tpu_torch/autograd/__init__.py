"""autograd namespace (counterpart of paddle_tpu/autograd/): backward,
grad, PyLayer and the grad-mode switches.  ``autograd.functional``
(jacobian, hessian, vjp, jvp) is not ported yet (ROADMAP.md Queue 1
item 13)."""
from __future__ import annotations

from ..core.dispatch import (enable_grad, is_grad_enabled,  # noqa: F401
                             no_grad, set_grad_enabled)
from ..core.tape import backward as _tape_backward
from ..core.tape import grad  # noqa: F401
from .py_layer import PyLayer, PyLayerContext  # noqa: F401

__all__ = ["backward", "grad", "no_grad", "enable_grad", "set_grad_enabled",
           "is_grad_enabled", "PyLayer", "PyLayerContext"]


def backward(tensors, grad_tensors=None, retain_graph=False):
    gt = list(grad_tensors) if grad_tensors is not None else None
    _tape_backward(list(tensors), gt, retain_graph=retain_graph)
