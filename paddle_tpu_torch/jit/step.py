"""Whole-train-step capture (counterpart of paddle_tpu/jit/step.py).

    step = paddle.jit.capture_step(train_step, models=model,
                                   optimizers=opt, scalers=scaler)
    for batch in loader:
        loss = step(batch_x, batch_y)      # one CUDA graph replay

On the card the user's whole step -- forward, ``loss.backward()``, grad
clip, optimizer and GradScaler -- is captured as a ``torch.cuda.CUDAGraph``
and replayed.  Captures are keyed by the call's signature, as ``jax.jit``
keeps one executable a signature: the tree's structure, each Tensor leaf's
shape, dtype and device, and each leaf that is neither a Tensor nor a
number by value.  A new signature is captured again; a repeated one
replays its graph.  Python ``bool`` / ``int`` / ``float`` leaves (a loss
weight, a flag) are not part of the key: they reach the step as 0-d
Tensors on the step's device, filled before each replay, as the JAX
package passes them to its jitted step as dynamic scalars; a step that
branches on one on the host fails as a host read does.  Every key's
graph reads and writes the same state: parameters and master weights,
buffers (BatchNorm's running statistics), optimizer slots, the
optimizers' lr and step scalars, the scalers' scale and counters all keep
their storage and are updated in place; the graphs share one memory pool.
The card's generator is registered with each graph, so dropout draws
advance across replays.  Before each replay the call copies the batch
into the key's static inputs and writes the host learning rate and step
count into the optimizers' device scalars, so an LR scheduler stepped
between calls takes effect.

Warm-up runs the step once eagerly on a side stream before each capture,
so every library is built and every lazily made buffer exists; the state
it changed is then put back, so the call is one step.  A capture
failure raises: there is no eager fallback on the card.  Drop what keeps
an earlier eager step's autograd graph alive (its loss, a clone of a
parameter that requires grad) before the first call: torch's
gradient-accumulation nodes remember the stream they were made on.

On the CPU, ``capture_step`` runs the step eagerly under the same
contract, number leaves lifted to 0-d Tensors as on the card.  The
contract (the JAX package's errors, word for word):

- the step must not read tensors on the host (``.numpy()``, ``item()``,
  ``float()``, ``if tensor:``);
- gradients must be cleared inside the step (``opt.clear_grad()``),
  unless ``grad_accumulation=True``: gradients are then static buffers
  that ``clear_grad`` zeroes in place, so an accumulate-only step and an
  update step (two captured steps over the same objects) implement the
  every-k pattern;
- optimizers with host per-step state (NAdam, RAdam) are refused.

Kernel launch counters are Python-side and count warm-up and capture, not
replays: count a replay's launches from a ``torch.profiler`` trace.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import dispatch as _D
from ..core import random_state
from ..core.tensor import Tensor

__all__ = ["capture_step", "CapturedStep", "signature", "lift_scalars"]

_UNCLEARED_MSG = (
    "capture_step: gradients still set after the step for {} — call "
    "optimizer.clear_grad() inside the captured function — or pass "
    "grad_accumulation=True to capture_step to thread accumulated "
    "gradients through the program")


def _as_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _map(tree, fn):
    if isinstance(tree, Tensor):
        return fn(tree)
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(t, fn) for t in tree)
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return tree


_SCALAR_DTYPES = {"bool": torch.bool, "int": torch.int64,
                  "float": torch.float32}


def _scalar_kind(x):
    """'bool' / 'int' / 'float' for a Python or numpy number leaf, else
    None."""
    if isinstance(x, (bool, np.bool_)):
        return "bool"
    if isinstance(x, (int, np.integer)):
        return "int"
    if isinstance(x, (float, np.floating)):
        return "float"
    return None


def signature(tree):
    """The capture key of a call's ``(args, kwargs)`` tree: its structure,
    each Tensor leaf's shape, dtype and device, each number leaf's kind
    (its value rides in a device scalar) and every other leaf's value."""
    if isinstance(tree, Tensor):
        d = tree._data
        return ("tensor", tuple(d.shape), d.dtype, d.device)
    kind = _scalar_kind(tree)
    if kind is not None:
        return ("scalar", kind)
    if isinstance(tree, (list, tuple)):
        return (type(tree), tuple(signature(t) for t in tree))
    if isinstance(tree, dict):
        return (dict, tuple((k, signature(v)) for k, v in tree.items()))
    try:
        hash(tree)
        return ("value", type(tree), tree)
    except TypeError:
        return ("value", type(tree), repr(tree))


def lift_scalars(tree, device, clone=False):
    """The tree with each number leaf as a 0-d Tensor on ``device`` (and,
    with ``clone``, each Tensor leaf as a copy): what the step receives."""
    def go(t):
        if isinstance(t, Tensor):
            return Tensor(t._data.clone()) if clone else t
        kind = _scalar_kind(t)
        if kind is not None:
            return Tensor(torch.tensor(t.item() if isinstance(t, np.generic)
                                       else t, dtype=_SCALAR_DTYPES[kind],
                                       device=device))
        if isinstance(t, (list, tuple)):
            return type(t)(go(e) for e in t)
        if isinstance(t, dict):
            return {k: go(v) for k, v in t.items()}
        return t
    return go(tree)


def _feeds(tree):
    """The Tensor and number leaves of a tree, in order."""
    if isinstance(tree, Tensor) or _scalar_kind(tree) is not None:
        yield tree
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _feeds(t)
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _feeds(v)


class _Capture:
    """One signature's graph, static inputs and static outputs."""
    __slots__ = ("graph", "static_in", "static_out")

    def __init__(self, graph, static_in, static_out):
        self.graph, self.static_in, self.static_out = \
            graph, static_in, static_out


class CapturedStep:
    """A user train-step function, replayed as one CUDA graph on the card
    (run eagerly under the same contract on the CPU)."""

    def __init__(self, fn, models=None, optimizers=None, scalers=None,
                 donate=True, grad_accumulation=False):
        self._fn = fn
        self._models = _as_list(models)
        self._optimizers = _as_list(optimizers)
        self._scalers = _as_list(scalers)
        self._grad_accum = bool(grad_accumulation)
        self._captures: dict = {}
        self._pool = None
        # one side stream for every capture: the gradient-accumulation
        # nodes a warm-up makes remember the stream they were made on
        self._side = None

        seen = set()
        self._params = []
        for m in self._models:
            for _, p in m.named_parameters():
                if id(p) not in seen:
                    seen.add(id(p))
                    self._params.append(p)
        for opt in self._optimizers:
            for p in (opt._parameter_list or []):
                if id(p) not in seen:
                    seen.add(id(p))
                    self._params.append(p)
        self._buffers = []
        bseen = set()
        for m in self._models:
            for _, b in m.named_buffers():
                if b is not None and id(b) not in bseen:
                    bseen.add(id(b))
                    self._buffers.append(b)
        # every optimizer slot and device scalar exists before the first
        # step, so the captured graph's buffers are the live ones
        for opt in self._optimizers:
            for p in (opt._parameter_list or []):
                if not p.stop_gradient:
                    opt._state_for(p)
            opt._device_scalars()
        self._device = self._params[0]._data.device if self._params \
            else torch.device("cpu")
        for s in self._scalers:
            s._dev_state(self._device)

    # -- the contract ---------------------------------------------------------
    def _enter(self):
        for opt in self._optimizers:
            opt._captured = True
            opt._zero_grads = self._grad_accum
        return _D.set_host_reads_forbidden(True)

    def _exit(self, prev):
        _D.set_host_reads_forbidden(prev)
        for opt in self._optimizers:
            opt._captured = False
            opt._zero_grads = False

    def _fill_scalars(self):
        for opt in self._optimizers:
            opt._fill_scalars(opt._global_step + 1)

    def _run_fn(self, args, kwargs):
        """One eager run of the step under the contract; the optimizers'
        host step counts end one higher, as after a captured call."""
        steps = [opt._global_step for opt in self._optimizers]
        prev = self._enter()
        try:
            out = self._fn(*args, **kwargs)
        finally:
            self._exit(prev)
            for opt, st in zip(self._optimizers, steps):
                opt._global_step = st + 1
        if not self._grad_accum:
            dirty = [p.name for p in self._params if p._data.grad is not None]
            if dirty:
                raise RuntimeError(_UNCLEARED_MSG.format(
                    f"{dirty[:3]}{'...' if len(dirty) > 3 else ''}"))
        return out

    # -- state snapshot (undoes the warm-up) ----------------------------------
    def _state_tensors(self):
        ts = [p._data for p in self._params]
        ts += [p._master_weight for p in self._params
               if getattr(p, "_master_weight", None) is not None]
        ts += [b._data for b in self._buffers]
        for opt in self._optimizers:
            for st in opt._accumulators.values():
                ts += list(st.values())
        for s in self._scalers:
            ts += list(s._dev_state())
        if self._grad_accum:
            ts += [p._data.grad for p in self._params]
        return ts

    def _snapshot(self):
        gen = random_state.generator(self._device)
        return ([(t, t.detach().clone()) for t in self._state_tensors()],
                gen.get_state(),
                [opt._global_step for opt in self._optimizers],
                [p._data.grad for p in self._params])

    def _restore(self, snap):
        pairs, gen_state, steps, grads = snap
        with torch.no_grad():
            for t, saved in pairs:
                t.copy_(saved)
        random_state.generator(self._device).set_state(gen_state)
        for opt, st in zip(self._optimizers, steps):
            opt._global_step = st
        for p, g in zip(self._params, grads):
            p._data.grad = g

    # -- the CUDA graphs -------------------------------------------------------
    def _capture(self, args, kwargs):
        if self._grad_accum:
            for p in self._params:
                if p._data.grad is None and not p.stop_gradient:
                    p._data.grad = torch.zeros_like(p._data)
        static_in = lift_scalars((args, kwargs), self._device, clone=True)
        s_args, s_kwargs = static_in
        snap = self._snapshot()
        if self._side is None:
            self._side = torch.cuda.Stream(device=self._device)
        side = self._side
        side.wait_stream(torch.cuda.current_stream(self._device))
        with torch.cuda.stream(side):
            self._fill_scalars()
            self._run_fn(s_args, s_kwargs)
        torch.cuda.current_stream(self._device).wait_stream(side)
        torch.cuda.synchronize(self._device)
        self._restore(snap)
        graph = torch.cuda.CUDAGraph()
        if hasattr(graph, "register_generator_state"):
            graph.register_generator_state(
                random_state.generator(self._device))
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        steps = [opt._global_step for opt in self._optimizers]
        with torch.cuda.graph(graph, pool=self._pool, stream=side):
            out = self._run_fn(s_args, s_kwargs)
        for opt, st in zip(self._optimizers, steps):
            opt._global_step = st
        return _Capture(graph, static_in, out)

    @property
    def num_captures(self):
        """How many signatures have been captured (0 on the CPU)."""
        return len(self._captures)

    # -- call -----------------------------------------------------------------
    def __call__(self, *args, **kwargs):
        if self._device.type != "cuda":
            self._fill_scalars()
            s_args, s_kwargs = lift_scalars((args, kwargs), self._device)
            out = self._run_fn(s_args, s_kwargs)
            return _map(out, lambda t: t.detach())
        key = signature((args, kwargs))
        cap = self._captures.get(key)
        if cap is None:
            cap = self._captures[key] = self._capture(args, kwargs)
        with torch.no_grad():
            for dst, src in zip(_feeds(cap.static_in),
                                _feeds((args, kwargs))):
                if isinstance(src, Tensor):
                    dst._data.copy_(src._data, non_blocking=True)
                else:
                    dst._data.fill_(src.item() if isinstance(src, np.generic)
                                    else src)
        self._fill_scalars()
        cap.graph.replay()
        for opt in self._optimizers:
            opt._global_step += 1
        return _map(cap.static_out, lambda t: Tensor(t._data.clone()))


def capture_step(fn=None, *, models=None, optimizers=None, scalers=None,
                 donate=True, grad_accumulation=False):
    """Capture a dygraph train-step function (decorator or direct form).
    ``donate`` is the JAX signature's: the port always updates the state's
    storage in place::

        step = capture_step(train_step, models=m, optimizers=o, scalers=s)

        @capture_step(models=m, optimizers=o)
        def train_step(x, y): ...
    """
    if fn is None:
        def deco(f):
            return CapturedStep(f, models, optimizers, scalers, donate,
                                grad_accumulation)
        return deco
    return CapturedStep(fn, models, optimizers, scalers, donate,
                        grad_accumulation)
