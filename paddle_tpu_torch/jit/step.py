"""Whole-train-step capture (counterpart of paddle_tpu/jit/step.py).

    step = paddle.jit.capture_step(train_step, models=model,
                                   optimizers=opt, scalers=scaler)
    for batch in loader:
        loss = step(batch_x, batch_y)      # one CUDA graph replay

On the card the user's whole step -- forward, ``loss.backward()``, grad
clip, optimizer and GradScaler -- is captured once as a
``torch.cuda.CUDAGraph`` and replayed on every call.  The mutable state is
threaded through static buffers: parameters and master weights, buffers
(BatchNorm's running statistics), optimizer slots, the optimizers' lr and
step scalars, the scalers' scale and counters all keep their storage and
are updated in place by the graph; the card's generator is registered
with the graph, so dropout draws advance across replays.  Before each
replay the call copies the batch into the static inputs and writes the
host learning rate and step count into the optimizers' device scalars, so
an LR scheduler stepped between calls takes effect.

Warm-up runs the step once eagerly on a side stream, so every library is
built and every lazily made buffer exists before capture; the state it
changed is then put back, so the first call is the first step.  A capture
failure raises: there is no eager fallback on the card.  Drop what keeps
an earlier eager step's autograd graph alive (its loss, a clone of a
parameter that requires grad) before the first call: torch's
gradient-accumulation nodes remember the stream they were made on.

On the CPU, ``capture_step`` runs the step eagerly under the same
contract.  The contract (the JAX package's errors, word for word):

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

import torch

from ..core import dispatch as _D
from ..core import random_state
from ..core.tensor import Tensor

__all__ = ["capture_step", "CapturedStep"]

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


def _leaves(tree):
    out = []
    _map(tree, out.append)
    return out


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
        self._graph = None
        self._static_in = None
        self._static_out = None

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

    # -- the CUDA graph -------------------------------------------------------
    def _capture(self, args, kwargs):
        if self._grad_accum:
            for p in self._params:
                if p._data.grad is None and not p.stop_gradient:
                    p._data.grad = torch.zeros_like(p._data)
        self._static_in = _map((args, kwargs),
                               lambda t: Tensor(t._data.clone()))
        s_args, s_kwargs = self._static_in
        snap = self._snapshot()
        side = torch.cuda.Stream(device=self._device)
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
        steps = [opt._global_step for opt in self._optimizers]
        with torch.cuda.graph(graph, stream=side):
            out = self._run_fn(s_args, s_kwargs)
        for opt, st in zip(self._optimizers, steps):
            opt._global_step = st
        self._graph, self._static_out = graph, out

    # -- call -----------------------------------------------------------------
    def __call__(self, *args, **kwargs):
        if self._device.type != "cuda":
            self._fill_scalars()
            out = self._run_fn(args, kwargs)
            return _map(out, lambda t: t.detach())
        if self._graph is None:
            self._capture(args, kwargs)
        with torch.no_grad():
            for dst, src in zip(_leaves(self._static_in),
                                _leaves((args, kwargs))):
                dst._data.copy_(src._data, non_blocking=True)
        self._fill_scalars()
        self._graph.replay()
        for opt in self._optimizers:
            opt._global_step += 1
        return _map(self._static_out, lambda t: Tensor(t._data.clone()))


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
