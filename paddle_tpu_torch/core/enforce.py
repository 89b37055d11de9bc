"""Error/enforce utilities (counterpart of paddle_tpu/core/enforce.py):
typed framework errors, the operator-context stack that prefixes kernel
failures (``[operator < conv2d > error]``), and ``explain_runtime_error``,
which decodes CUDA / cuBLAS / NCCL status text into a hint (the JAX
package decodes XLA/PJRT status strings there)."""
from __future__ import annotations

import contextlib
import threading

__all__ = [
    "EnforceError", "InvalidArgumentError", "NotFoundError", "OutOfRangeError",
    "AlreadyExistsError", "PreconditionNotMetError", "UnimplementedError",
    "UnavailableError", "ExecutionTimeoutError", "AnalysisError", "enforce",
    "enforce_eq", "enforce_shape", "error_context", "current_error_context",
    "explain_runtime_error",
]


class EnforceError(RuntimeError):
    pass


class InvalidArgumentError(EnforceError, ValueError):
    pass


class NotFoundError(EnforceError, KeyError):
    pass


class OutOfRangeError(EnforceError, IndexError):
    pass


class AlreadyExistsError(EnforceError):
    pass


class PreconditionNotMetError(EnforceError):
    pass


class UnimplementedError(EnforceError, NotImplementedError):
    pass


class UnavailableError(EnforceError):
    pass


class ExecutionTimeoutError(EnforceError, TimeoutError):
    pass


class AnalysisError(PreconditionNotMetError):
    pass


_ctx = threading.local()


def current_error_context() -> tuple:
    return tuple(getattr(_ctx, "stack", ()))


@contextlib.contextmanager
def error_context(name: str):
    """Push an operator/frame name; any EnforceError raised inside is
    prefixed ``[operator < name > error]``."""
    stack = getattr(_ctx, "stack", None)
    if stack is None:
        stack = _ctx.stack = []
    stack.append(name)
    try:
        yield
    except EnforceError as e:
        prefix = " ".join(f"[operator < {n} > error]" for n in stack)
        if e.args and isinstance(e.args[0], str) \
                and not e.args[0].startswith("[operator"):
            e.args = (f"{prefix} {e.args[0]}",) + e.args[1:]
        raise
    finally:
        stack.pop()


_CUDA_HINTS = (
    ("out of memory", "the program does not fit in device memory -- "
     "reduce batch or sequence length, or shard the optimizer state"),
    ("CUBLAS_STATUS", "a cuBLAS call failed -- check the operands' dtypes "
     "and shapes; an earlier asynchronous error may be reported here"),
    ("illegal memory access", "a kernel read or wrote out of bounds -- "
     "rerun with CUDA_LAUNCH_BLOCKING=1 to find the launch"),
    ("device-side assert", "a kernel assertion fired (often an index out "
     "of range) -- rerun with CUDA_LAUNCH_BLOCKING=1"),
    ("NCCL", "a collective failed -- suspect a desynchronized collective "
     "(see FLAGS_comm_watchdog_timeout)"),
    ("operation not permitted when stream is capturing", "a host sync or "
     "a host-to-device copy ran inside a CUDA graph capture -- keep the "
     "captured step device-pure"),
)


def explain_runtime_error(e: BaseException) -> str:
    """Best-known hint for a CUDA runtime error, or '' if unknown."""
    text = str(e)
    for code, hint in _CUDA_HINTS:
        if code in text:
            return hint
    return ""


def enforce(cond, msg: str, exc=InvalidArgumentError):
    if not cond:
        raise exc(msg)


def enforce_eq(a, b, msg: str = "", exc=InvalidArgumentError):
    if a != b:
        raise exc(f"Expected {a!r} == {b!r}. {msg}")


def enforce_shape(t, expected_rank=None, msg: str = ""):
    if expected_rank is not None and len(t.shape) != expected_rank:
        raise InvalidArgumentError(
            f"Expected rank-{expected_rank} tensor, got shape "
            f"{tuple(t.shape)}. {msg}")
