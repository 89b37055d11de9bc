"""Communication watchdog: hang detection for in-flight collectives
(counterpart of paddle_tpu/distributed/watchdog.py).

Every eager collective registers its task; a daemon thread watches
readiness and, past the timeout (``FLAGS_comm_watchdog_timeout`` seconds,
0 disables), logs a CRITICAL dump of every pending task (op, group,
shape, elapsed): the signal a hung multi-host job needs.

Readiness is read without blocking from a ``torch.distributed`` work's
``is_completed()`` or a CUDA event's ``query()`` (the reference reads
``jax.Array.is_ready()``, which is also accepted).  The timeout is the
port's flag ``comm_watchdog_timeout`` (``core.flags``), read at every
check as the reference reads its own: ``FLAGS_comm_watchdog_timeout`` in
the environment sets it at import, ``paddle_tpu_torch.set_flags`` after.
"""
from __future__ import annotations

import functools
import logging
import threading
import time

import torch
from torch.utils._pytree import tree_leaves

__all__ = ["CommTaskManager", "comm_task_manager", "watch", "watch_step"]

_log = logging.getLogger("paddle_tpu_torch.distributed.watchdog")


def _ready(obj) -> bool:
    for name in ("is_completed", "query", "is_ready"):
        fn = getattr(obj, name, None)
        if fn is not None:
            return bool(fn())
    return True


class _Task:
    __slots__ = ("desc", "ranks", "shape", "start", "array", "reported")

    def __init__(self, desc, ranks, array):
        self.desc = desc
        self.ranks = tuple(ranks)
        self.shape = tuple(getattr(array, "shape", ()))
        self.start = time.monotonic()
        self.array = array
        self.reported = False


class CommTaskManager:
    """Background watcher over registered collective tasks."""

    def __init__(self, poll_interval=1.0):
        self._tasks: list[_Task] = []
        self._lock = threading.Lock()
        self._thread = None
        self._poll = poll_interval
        self._stop = threading.Event()

    def _timeout(self) -> float:
        from ..core.flags import get_flag
        return float(get_flag("comm_watchdog_timeout"))

    def register(self, desc, ranks, array):
        if self._timeout() <= 0:
            return array
        with self._lock:
            self._tasks.append(_Task(desc, ranks, array))
            if self._thread is None or not self._thread.is_alive():
                self._stop.clear()
                self._thread = threading.Thread(target=self._loop,
                                                daemon=True,
                                                name="comm-watchdog")
                self._thread.start()
        return array

    def _loop(self):
        while not self._stop.is_set():
            time.sleep(self._poll)
            timeout = self._timeout()
            now = time.monotonic()
            with self._lock:
                still = []
                overdue = []
                for t in self._tasks:
                    try:
                        ready = _ready(t.array)
                    except Exception:
                        ready = True  # a task that cannot tell: stop watching
                    if ready:
                        continue
                    still.append(t)
                    if timeout > 0 and now - t.start > timeout \
                            and not t.reported:
                        t.reported = True
                        overdue.append(t)
                self._tasks = still
                empty = not still
            for t in overdue:
                self._dump(t, now)
            if empty:
                # the exit decision is atomic with register()'s alive-check:
                # a task registered after the drain above is not orphaned on
                # a thread about to return
                with self._lock:
                    if self._tasks:
                        continue
                    self._thread = None
                    return

    def _dump(self, task, now):
        with self._lock:
            pending = [(t.desc, t.ranks, t.shape,
                        round(now - t.start, 1)) for t in self._tasks]
        _log.critical(
            "[comm watchdog] collective %r over ranks %s (shape %s) has "
            "been in flight for %.1fs (> FLAGS_comm_watchdog_timeout). "
            "Pending comm tasks: %s — likely a rank mismatch or a peer "
            "process hang.",
            task.desc, task.ranks, task.shape,
            now - task.start, pending)

    def pending(self):
        with self._lock:
            return [(t.desc, t.ranks, t.shape) for t in self._tasks]

    def shutdown(self):
        self._stop.set()


comm_task_manager = CommTaskManager()


def watch(desc, ranks, array):
    """Register an in-flight collective task with the watchdog."""
    return comm_task_manager.register(desc, ranks, array)


def watch_step(fn, desc="compiled_step"):
    """Host-side heartbeat around a step function whose work runs on the
    card after it returns (a hybrid step's NCCL calls included): a CUDA
    event recorded after the call, or the first output that reports its
    own readiness, is watched, so a stuck step gives the same CRITICAL
    dump as an eager collective.

    Usage::

        step = watch_step(build_train_step(cfg, hp, mesh), "hybrid_step")
        params, opt, loss = step(params, opt, tokens)

    No work when FLAGS_comm_watchdog_timeout is 0 (the default).
    """

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        if comm_task_manager._timeout() > 0:
            for x in tree_leaves(out):
                if isinstance(x, torch.Tensor):
                    if x.is_cuda:
                        ev = torch.cuda.Event()
                        ev.record()
                        watch(desc, (), ev)
                        break
                elif any(hasattr(x, n) for n in ("is_completed", "query",
                                                 "is_ready")):
                    watch(desc, (), x)
                    break
        return out
    return wrapped
