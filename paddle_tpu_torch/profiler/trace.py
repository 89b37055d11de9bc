"""Step-timeline tracing: a bounded ring buffer of serving-tier spans.

``ServingStats`` (profiler/serving.py) answers "how fast is the stream";
this module answers "where did one step's time go".  A ``Tracer`` is a
fixed-capacity ring buffer of event TUPLES — span begin/duration pairs,
instant markers, and async request-lifecycle begin/end — stamped with
``time.perf_counter_ns`` and a logical TRACK (one per serving tier:
engine, runner, router, http), exported as Chrome trace-event JSON that
Perfetto (https://ui.perfetto.dev) loads directly.

Design rules, in the order they constrain the code:

* **Disabled means free.**  The tracer is opt-in; every instrumentation
  site guards on ``tracer is None`` FIRST (mirroring FaultPlan's seam
  contract), so an engine without a tracer pays one attribute check per
  phase and allocates nothing — pinned by test via tracemalloc filtering
  on this file.
* **Bounded forever.**  Events land in a deque capped at ``capacity``;
  when full the OLDEST event is dropped and ``dropped`` counts it, so a
  server tracing for days holds the most recent window and reports
  exactly how much history it shed.  ``serve_bench`` records the drop
  counter next to its perf numbers.
* **Cheap hot path.**  An event is one tuple append under one small
  lock.  Timestamps are integer nanoseconds from ``perf_counter_ns``
  (monotonic, never wall-clock — see the ``wallclock-in-timing-path``
  lint rule); conversion to chrome's microsecond floats happens only at
  export.
* **Spans nest per thread.**  ``span()`` is a context manager that
  pushes/pops a per-thread stack; exits must match enters (violations
  are counted in ``unbalanced``, never raised mid-serve).  Code that
  yields mid-section (asyncio handlers) uses the stackless
  ``now()``/``complete()`` pair instead, so one coroutine's section
  cannot corrupt another's stack.

Export shape: ``chrome_trace()`` returns a JSON-ready dict whose
``traceEvents`` hold "X" (complete) events for spans, "i" for instants,
"b"/"e" async pairs (cat="request") for request lifecycles — the async
id carries the engine track + rid, and runner delivery instants carry
both the engine rid and the frontend request id, so one request is
followable across all four tiers.  Thread-name metadata maps each track
to its own row in the viewer.
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque

__all__ = ["Tracer"]


class _Span:
    """One ``with tracer.span(...)`` section.  Captures t0 as late as
    possible on enter and emits a single "X" event on exit."""

    __slots__ = ("_tr", "_name", "_track", "_args", "_t0")

    def __init__(self, tr, name, track, args):
        self._tr = tr
        self._name = name
        self._track = track
        self._args = args

    def __enter__(self):
        self._tr._stack().append(self._name)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter_ns()
        tr = self._tr
        stack = tr._stack()
        if not stack or stack.pop() != self._name:
            tr.unbalanced += 1
        tr._push(("X", self._name, self._t0, t1 - self._t0,
                  tr._tid(self._track), self._args, None))
        return False


class Tracer:
    """Bounded ring buffer of serving spans, Perfetto-exportable.

    Parameters
    ----------
    capacity: maximum events held.  The buffer keeps the most RECENT
        window; older events drop oldest-first into ``dropped``.
    """

    def __init__(self, capacity: int = 65536):
        self.capacity = max(1, int(capacity))
        self._events: deque = deque()
        self.dropped = 0              # events shed by the ring bound
        self.unbalanced = 0           # span exits that missed their enter
        self._lock = threading.Lock()
        self._tracks: dict = {}       # track name -> tid (viewer row)
        self._local = threading.local()
        self.t0_ns = time.perf_counter_ns()   # trace epoch

    # -- clock + tracks -----------------------------------------------------

    @staticmethod
    def now() -> int:
        """Integer-nanosecond monotonic timestamp (pair with
        ``complete()`` for sections that yield mid-way)."""
        return time.perf_counter_ns()

    def register(self, base: str) -> str:
        """Reserve a unique track name ("engine", "engine-2", ...).
        Each tier registers once and stamps its events with the result,
        so two replicas' engines land on separate viewer rows."""
        with self._lock:
            name = base
            n = 2
            while name in self._tracks:
                name = f"{base}-{n}"
                n += 1
            self._tracks[name] = len(self._tracks) + 1
        return name

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _tid(self, track) -> int:
        if track is None:
            track = getattr(self._local, "track", None)
            if track is None:
                track = self.register(
                    f"host:{threading.current_thread().name}")
                self._local.track = track
        tid = self._tracks.get(track)
        if tid is None:
            with self._lock:
                tid = self._tracks.setdefault(track,
                                              len(self._tracks) + 1)
        return tid

    # -- recording ----------------------------------------------------------

    def _push(self, ev: tuple) -> None:
        with self._lock:
            if len(self._events) >= self.capacity:
                self._events.popleft()
                self.dropped += 1
            self._events.append(ev)

    def span(self, name: str, track: str | None = None, **args) -> _Span:
        """Context manager for one duration span on this thread's stack.
        Do NOT hold one across an ``await`` — use ``now()``/``complete()``
        there instead."""
        return _Span(self, name, track, args or None)

    def complete(self, name: str, t0_ns: int, track: str | None = None,
                 args: dict | None = None) -> None:
        """Record a span that started at ``t0_ns`` (from ``now()``) and
        ends now.  Stackless: safe from coroutines and guarded hot
        loops."""
        t1 = time.perf_counter_ns()
        self._push(("X", name, t0_ns, t1 - t0_ns, self._tid(track),
                    args, None))

    def instant(self, name: str, track: str | None = None,
                args: dict | None = None) -> None:
        self._push(("i", name, time.perf_counter_ns(), 0,
                    self._tid(track), args, None))

    def async_begin(self, name: str, ev_id: str,
                    args: dict | None = None) -> None:
        """Open one request-lifecycle track (chrome "b" event, matched
        to its "e" by (cat, name, id))."""
        self._push(("b", name, time.perf_counter_ns(), 0,
                    self._tid(None), args, str(ev_id)))

    def async_end(self, name: str, ev_id: str,
                  args: dict | None = None) -> None:
        self._push(("e", name, time.perf_counter_ns(), 0,
                    self._tid(None), args, str(ev_id)))

    # -- reading ------------------------------------------------------------

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def events(self) -> list:
        """Snapshot of the raw event tuples
        (ph, name, ts_ns, dur_ns, tid, args, id), oldest first."""
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped = 0
            self.unbalanced = 0

    def chrome_trace(self) -> dict:
        """The trace as a Chrome trace-event JSON object (Perfetto's
        "open file" format): thread-name metadata per track, events
        sorted by timestamp, microsecond floats relative to the trace
        epoch.  Drop accounting rides in ``otherData``."""
        with self._lock:
            events = sorted(self._events, key=lambda e: e[2])
            tracks = dict(self._tracks)
            dropped = self.dropped
            unbalanced = self.unbalanced
        te = [{"ph": "M", "name": "process_name", "pid": 1, "tid": 0,
               "args": {"name": "paddle_tpu.serving"}}]
        for name, tid in sorted(tracks.items(), key=lambda kv: kv[1]):
            te.append({"ph": "M", "name": "thread_name", "pid": 1,
                       "tid": tid, "args": {"name": name}})
            te.append({"ph": "M", "name": "thread_sort_index", "pid": 1,
                       "tid": tid, "args": {"sort_index": tid}})
        t0 = self.t0_ns
        for ph, name, ts, dur, tid, args, ev_id in events:
            ev = {"ph": ph, "name": name, "pid": 1, "tid": tid,
                  "ts": (ts - t0) / 1e3}
            if ph == "X":
                ev["dur"] = dur / 1e3
            elif ph == "i":
                ev["s"] = "t"
            elif ph in ("b", "e"):
                ev["cat"] = "request"
                ev["id"] = ev_id
            if args:
                ev["args"] = args
            te.append(ev)
        return {"traceEvents": te, "displayTimeUnit": "ms",
                "otherData": {"dropped_events": dropped,
                              "unbalanced_spans": unbalanced,
                              "clock": "perf_counter_ns"}}

    def dump(self, path) -> int:
        """Write ``chrome_trace()`` to ``path``; returns the number of
        non-metadata events written."""
        with self._lock:
            n = len(self._events)
        doc = self.chrome_trace()
        with open(path, "w", encoding="utf-8") as f:
            json.dump(doc, f)
        return n
