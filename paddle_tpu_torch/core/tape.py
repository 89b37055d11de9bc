"""Autograd surface over torch.autograd (counterpart of
paddle_tpu/core/tape.py).

The JAX package records its own tape because JAX has no eager autograd;
here torch's autograd records the graph, and this module keeps Paddle's
semantics at the boundary: the initial gradient is ones for a root of any
shape, a second ``backward`` through a graph without ``retain_graph``
raises, leaf hooks fire once a backward with the leaf's full gradient
(torch sums a leaf's contributions before its hooks run), ``grad`` leaves
``.grad`` untouched, and callbacks run after every backward.
"""
from __future__ import annotations

import torch

__all__ = ["backward", "grad", "register_post_backward_callback",
           "backward_serial"]

_RELEASED = "paddle_tpu_torch.released"
_backward_serial = 0
_post_backward_callbacks: list = []


def backward_serial() -> int:
    """Monotonic id of the current/most-recent backward pass."""
    return _backward_serial


def register_post_backward_callback(cb):
    """cb() runs after every backward() completes; returns a remover."""
    _post_backward_callbacks.append(cb)

    def remove():
        try:
            _post_backward_callbacks.remove(cb)
        except ValueError:
            pass
    return remove


def _run_post_backward():
    for cb in list(_post_backward_callbacks):
        cb()


def _seed(t, g):
    from .tensor import Tensor
    if g is None:
        return torch.ones_like(t._data)
    if isinstance(g, Tensor):
        return g._data
    from .dispatch import to_torch
    return to_torch(g, t._data.device).to(t._data.dtype)


def _check_not_released(datas):
    for d in datas:
        fn = d.grad_fn
        if fn is not None and fn.metadata.get(_RELEASED):
            raise RuntimeError(
                f"Trying to backward through node '{fn.name()}' a second "
                "time; set retain_graph=True on the first backward.")


def backward(tensors, grad_tensors=None, retain_graph=False):
    """Reverse accumulation from ``tensors`` into the leaves' ``.grad``."""
    from .tensor import Tensor

    global _backward_serial
    if isinstance(tensors, Tensor):
        tensors = [tensors]
    if grad_tensors is None:
        grad_tensors = [None] * len(tensors)
    elif isinstance(grad_tensors, Tensor):
        grad_tensors = [grad_tensors]
    _backward_serial += 1
    roots, seeds = [], []
    for t, g in zip(tensors, grad_tensors):
        if t.stop_gradient:
            continue
        roots.append(t._data)
        seeds.append(_seed(t, g))
    if roots:
        _check_not_released(roots)
        torch.autograd.backward(roots, seeds, retain_graph=bool(retain_graph))
        if not retain_graph:
            for d in roots:
                if d.grad_fn is not None:
                    d.grad_fn.metadata[_RELEASED] = True
    _run_post_backward()


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None):
    """Gradients of outputs w.r.t. inputs, without touching ``.grad``
    (paddle.grad).  With ``create_graph`` the results are differentiable
    tensors, to any order."""
    from .tensor import Tensor

    if isinstance(outputs, Tensor):
        outputs = [outputs]
    if isinstance(inputs, Tensor):
        inputs = [inputs]
    if grad_outputs is None:
        gos = [None] * len(outputs)
    else:
        gos = list(grad_outputs) if isinstance(grad_outputs, (list, tuple)) \
            else [grad_outputs]
    outs = [t._data for t in outputs]
    seeds = [_seed(t, g) for t, g in zip(outputs, gos)]
    _check_not_released(outs)
    keep = bool(retain_graph) or bool(create_graph)
    gs = torch.autograd.grad(outs, [t._data for t in inputs], seeds,
                             retain_graph=keep, create_graph=create_graph,
                             allow_unused=True)
    if not keep:
        for d in outs:
            if d.grad_fn is not None:
                d.grad_fn.metadata[_RELEASED] = True
    results = []
    for g in gs:
        if g is None:
            if not allow_unused:
                raise RuntimeError(
                    "One of the differentiated tensors appears to not have "
                    "been used in the graph (set allow_unused=True to allow "
                    "this).")
            results.append(None)
        else:
            results.append(Tensor._wrap(g))
    return results
