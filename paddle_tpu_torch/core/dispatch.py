"""Eager op dispatch (counterpart of paddle_tpu/core/dispatch.py).

Every op is a torch function over torch tensors.  ``apply`` unwraps the
``Tensor`` arguments, applies autocast's per-op input casts, runs the
function, and wraps its outputs; torch's autograd records the graph as the
function runs (the JAX package compiles a forward + VJP program per op and
keeps its own tape, because JAX has no eager autograd).  An output's
``stop_gradient`` is ``not any input requires grad``; integer inputs are
never differentiated (torch cannot).

Python scalars become 0-d CPU tensors, which torch's promotion treats as
the JAX package treats its weak-typed scalars (``f32 tensor * 2.0`` stays
f32, ``bf16 tensor + 1`` stays bf16) and which a CUDA graph bakes in as
launch arguments.
"""
from __future__ import annotations

import functools
import threading
import time
from typing import Any, Callable, Sequence

import numpy as np
import torch

from . import amp_state
from .flags import get_flag

__all__ = ["apply", "no_grad", "is_grad_enabled", "set_grad_enabled",
           "enable_grad", "set_op_observer", "get_op_observer",
           "set_tensor_checker"]

_tls = threading.local()


def is_grad_enabled() -> bool:
    return torch.is_grad_enabled()


def set_grad_enabled(mode: bool):
    torch._C._set_grad_enabled(bool(mode))


class no_grad:
    """Context manager / decorator disabling autograd recording."""

    def __enter__(self):
        self._prev = is_grad_enabled()
        set_grad_enabled(False)
        return self

    def __exit__(self, *exc):
        set_grad_enabled(self._prev)
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with no_grad():
                return fn(*args, **kwargs)
        return wrapper


class enable_grad:
    def __enter__(self):
        self._prev = is_grad_enabled()
        set_grad_enabled(True)
        return self

    def __exit__(self, *exc):
        set_grad_enabled(self._prev)
        return False


# callable(op_name, start_ns, dur_ns) or None: the per-op host observer
# (a profiler's RecordEvent analog).
_op_observer = None
# callable(op_name, out_tensors) or None: the per-op numeric checker hook.
_tensor_checker = None


def set_op_observer(obs):
    global _op_observer
    _op_observer = obs


def get_op_observer():
    return _op_observer


def set_tensor_checker(cb):
    global _tensor_checker
    _tensor_checker = cb


# --- host-read guard: jit.capture_step forbids host reads in the step ----

_HOST_SYNC_MSG = (
    "capture_step: the step function forced a host sync on a traced value "
    "(float()/bool()/.numpy()/if-on-tensor). Keep the step device-pure; "
    "read metrics from the returned tensors instead.")


def host_reads_forbidden() -> bool:
    return getattr(_tls, "no_host_reads", False)


def set_host_reads_forbidden(flag: bool) -> bool:
    prev = host_reads_forbidden()
    _tls.no_host_reads = bool(flag)
    return prev


def check_host_read():
    if host_reads_forbidden():
        raise RuntimeError(_HOST_SYNC_MSG)


def _default_device():
    from .place import current_torch_device
    return current_torch_device()


def to_torch(x, device=None):
    """A non-Tensor op argument as torch: Python scalars as 0-d CPU
    tensors, numpy arrays and lists on ``device`` (the default place when
    None)."""
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, (bool, int, float, complex)):
        return torch.tensor(x)
    if isinstance(x, (np.ndarray, np.generic, list, tuple)):
        arr = np.asarray(x)
        if arr.dtype.name == "bfloat16":
            t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr))
        return t.to(device if device is not None else _default_device())
    raise TypeError(f"Cannot convert {type(x)} to tensor input")


def _check_nan_inf(op_name, arrays):
    check_host_read()
    for a in arrays:
        if torch.is_tensor(a) and (a.is_floating_point() or a.is_complex()):
            if not bool(torch.isfinite(a).all()):
                raise FloatingPointError(
                    f"Operator '{op_name}' output contains NaN or Inf "
                    f"(shape={tuple(a.shape)}, dtype={a.dtype}). "
                    f"Set FLAGS_check_nan_inf=0 to disable this check.")


def apply(op_name: str, fn: Callable, tensor_args: Sequence[Any],
          static_kwargs: dict | None = None):
    """Run op ``fn`` over mixed Tensor / scalar / array arguments.

    ``static_kwargs`` are the op's attributes, passed as keywords.
    Returns a Tensor, or a tuple of Tensors when ``fn`` returns a tuple
    (None where ``fn`` returned None).
    """
    from .tensor import Tensor

    device = None
    for a in tensor_args:
        if isinstance(a, Tensor):
            device = a._data.device
            break
    arrays = [a._data if isinstance(a, Tensor)
              else (a if a is None else to_torch(a, device))
              for a in tensor_args]

    cast_to = amp_state.autocast_dtype_for(op_name)
    if cast_to is not None:
        arrays = [a.to(cast_to) if (a is not None and a.is_floating_point()
                                    and a.dtype != cast_to) else a
                  for a in arrays]

    obs = _op_observer
    if obs is not None:
        t0 = time.perf_counter_ns()
    try:
        out = fn(*arrays, **(static_kwargs or {}))
    except RuntimeError as e:
        from .enforce import explain_runtime_error
        hint = explain_runtime_error(e)
        if hint:
            raise RuntimeError(
                f"[operator < {op_name} > error] {e} [Hint: {hint}]") from e
        raise
    if obs is not None:
        obs(op_name, t0, time.perf_counter_ns() - t0)

    multi = isinstance(out, (tuple, list))
    outs = tuple(out) if multi else (out,)
    if get_flag("check_nan_inf"):
        _check_nan_inf(op_name, outs)
    if _tensor_checker is not None:
        _tensor_checker(op_name, outs)
    wrapped = tuple(None if o is None else Tensor._wrap(o) for o in outs)
    return wrapped if multi else wrapped[0]
