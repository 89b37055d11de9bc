"""Virtual-time discrete-event loop.

The whole simulator hangs off this ~60-line class, so its contract is
strict:

* **Virtual time only.**  ``now`` starts at 0.0 and advances ONLY by
  popping scheduled events.  Nothing here (or anywhere under
  ``paddle_tpu_torch/sim/``) reads a wall clock — graft-lint's
  ``nondeterministic-sim`` rule fails the tree if one sneaks in.
* **Deterministic ordering.**  The heap key is ``(time, seq)`` where
  ``seq`` is a monotone admission counter, so simultaneous events fire
  in the exact order they were scheduled regardless of heap internals
  or callback identity.  Same inputs -> same event order -> same
  output, byte for byte.
* **No cancellation API.**  Model code that wants to cancel (e.g. a
  replica's idle wake-up racing a new arrival) marks its own state and
  lets the stale event no-op — simpler than tombstone bookkeeping and
  just as deterministic.
"""
from __future__ import annotations

import heapq

__all__ = ["EventLoop"]


class EventLoop:
    """Min-heap event loop over virtual seconds."""

    def __init__(self) -> None:
        self.now = 0.0
        self._heap: list = []
        self._seq = 0
        self.events_fired = 0

    def at(self, when: float, fn, *args) -> None:
        """Schedule ``fn(*args)`` at absolute virtual time ``when``
        (clamped to ``now``: the past is not addressable)."""
        heapq.heappush(self._heap,
                       (max(float(when), self.now), self._seq, fn, args))
        self._seq += 1

    def after(self, delay: float, fn, *args) -> None:
        """Schedule ``fn(*args)`` ``delay`` virtual seconds from now."""
        self.at(self.now + float(delay), fn, *args)

    def run(self, until: float | None = None,
            max_events: int | None = None) -> int:
        """Drain the heap in (time, seq) order; returns events fired.

        ``until`` stops BEFORE the first event past that virtual time
        (the event stays queued); ``max_events`` bounds runaway models.
        """
        fired = 0
        while self._heap:
            when, _, fn, args = self._heap[0]
            if until is not None and when > until:
                break
            if max_events is not None and fired >= max_events:
                break
            heapq.heappop(self._heap)
            self.now = when
            fn(*args)
            fired += 1
        self.events_fired += fired
        return fired

    def pending(self) -> int:
        return len(self._heap)
