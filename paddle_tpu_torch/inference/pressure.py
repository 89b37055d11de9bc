"""Graceful degradation under KV-page pressure.

The engine's only built-in answer to pool exhaustion is
preempt-and-recompute: evict a whole running sequence and replay its
prefill later.  That is correct but expensive — and it punishes a
sequence that was making progress.  The ``DegradationController``
interposes cheaper levers *before* preemption becomes necessary, in
escalating tiers keyed on the live free-page fraction:

    NORMAL       full service
    SPEC_SHRINK  halve speculative draft length (verify rows are the
                 biggest transient page consumers)
    ADMIT_PAUSE  stop admitting new sequences; the frontend sheds with
                 429 + a Retry-After derived from the free-page trend
    EVICT_PARKED proactively evict LRU parked (refcount-0 cached)
                 pages a few per step, trading future prefix-cache
                 hits for headroom now.  With a host spill tier
                 attached (inference/kv_tier.py) this lever is
                 SPILL-FIRST: registered pages quarantine for the
                 engine's step-boundary drain and live on host-side
                 instead of dying, so the trade becomes
                 hit-latency-for-headroom rather than hits-for-headroom

Escalation is immediate — a pressure spike engages the right tier the
same step.  De-escalation is hysteretic: the controller steps *one*
tier back toward NORMAL only after ``cooldown_steps`` consecutive
steps above the current tier's exit threshold, and the exit thresholds
sit strictly above the entry thresholds, so the engine cannot flap
between tiers on a noisy free-page signal.
"""
from __future__ import annotations

import time
from collections import deque

__all__ = ["DegradationController", "NORMAL", "SPEC_SHRINK",
           "ADMIT_PAUSE", "EVICT_PARKED", "STATE_NAMES"]

NORMAL = 0
SPEC_SHRINK = 1
ADMIT_PAUSE = 2
EVICT_PARKED = 3

STATE_NAMES = {NORMAL: "normal", SPEC_SHRINK: "spec_shrink",
               ADMIT_PAUSE: "admit_pause", EVICT_PARKED: "evict_parked"}


class DegradationController:
    """Tiered load-shedding state machine over the free-page fraction.

    ``enter[i]`` is the free fraction at or below which tier ``i+1``
    engages; ``exit[i]`` (strictly greater) is the fraction the pool
    must sustain for ``cooldown_steps`` consecutive steps before the
    controller steps back down from tier ``i+1``.
    """

    def __init__(self, *, enter=(0.30, 0.18, 0.10),
                 exit=(0.40, 0.28, 0.20), cooldown_steps: int = 8,
                 evict_batch: int = 4, history: int = 64):
        if len(enter) != 3 or len(exit) != 3:
            raise ValueError("enter/exit must each name 3 tier thresholds")
        for i, (lo, hi) in enumerate(zip(enter, exit)):
            if not hi > lo:
                raise ValueError(
                    f"exit[{i}]={hi} must exceed enter[{i}]={lo} "
                    "(hysteresis gap)")
        self.enter = tuple(float(x) for x in enter)
        self.exit = tuple(float(x) for x in exit)
        self.cooldown_steps = int(cooldown_steps)
        self.evict_batch = int(evict_batch)
        self.state = NORMAL
        self.transitions: list[tuple[int, int, int]] = []  # (step, frm, to)
        self._step = 0
        self._calm = 0
        self._total = 0
        self._history: deque[tuple[float, int]] = deque(maxlen=int(history))

    # -- per-step update ---------------------------------------------------

    def update(self, blocks, spec_reserved: int = 0) -> int:
        """Observe the pool and move the state machine.  Returns the
        (possibly new) state.  Called once per engine step.

        ``spec_reserved`` credits back pages the async engine's
        prestage took SPECULATIVELY for the next launch: at this point
        of a synchronous step they would still be free, so counting
        them as used would skew the free-page fraction (and the
        retry-after trend) against the overlap engine for pages that
        are not real demand yet.

        Parked (refcount-0 cached) pages count as headroom too,
        mirroring ``BlockManager.can_allocate``: the allocator evicts
        them on demand, so they are reclaimable supply, not demand.
        Counting them as used deadlocks a long prefix-caching run —
        retirement parks pages instead of freeing them, the strict
        free fraction ratchets below the ADMIT_PAUSE exit threshold,
        and admission never resumes even though nearly the whole pool
        is evictable on demand.  (Found by replaying sustained traffic
        through the fleet simulator, which shares this controller.)"""
        self._step += 1
        total = blocks.num_blocks - 1  # slot 0 is the null block
        self._total = total
        reclaimable = int(getattr(blocks, "num_cached", 0))
        # spill-quarantined pages are headroom too: they free
        # unconditionally at the next step-boundary drain, so counting
        # them as used would double-escalate the very lever (spill-first
        # EVICT_PARKED) that created them
        reclaimable += int(getattr(blocks, "num_spill_pending", 0))
        free = min(blocks.num_free + reclaimable + int(spec_reserved), total)
        f = free / total if total > 0 else 1.0
        self._history.append((time.monotonic(), free))

        # deepest tier whose entry threshold the pool has breached
        target = NORMAL
        for tier in (EVICT_PARKED, ADMIT_PAUSE, SPEC_SHRINK):
            if f <= self.enter[tier - 1]:
                target = tier
                break

        if target > self.state:
            self._move(target)
            self._calm = 0
        elif self.state > NORMAL:
            # one tier back only after a full calm cooldown above the
            # CURRENT tier's exit threshold
            if f > self.exit[self.state - 1]:
                self._calm += 1
                if self._calm >= self.cooldown_steps:
                    self._move(self.state - 1)
                    self._calm = 0
            else:
                self._calm = 0
        return self.state

    def _move(self, to: int) -> None:
        self.transitions.append((self._step, self.state, to))
        self.state = to

    # -- levers the engine/frontend consult --------------------------------

    @property
    def tier_entries(self) -> int:
        """Escalating transitions so far (NORMAL->worse or worse->worse):
        how many times pressure forced the controller UP a tier.  The
        serve_bench memory-pressure A/B reports this next to preemptions
        — quantized pages must show strictly fewer of both at matched
        traffic."""
        return sum(1 for _, frm, to in self.transitions if to > frm)

    @property
    def admission_paused(self) -> bool:
        return self.state >= ADMIT_PAUSE

    @property
    def evict_now(self) -> bool:
        return self.state >= EVICT_PARKED

    def spec_k_cap(self, max_spec_k: int) -> int:
        """Cap on per-request draft length under the current tier."""
        if self.state == NORMAL:
            return max_spec_k
        if self.state == SPEC_SHRINK:
            return max(1, max_spec_k // 2)
        return 0

    def retry_after_s(self, *, floor: float = 1.0,
                      ceil: float = 30.0) -> float:
        """Estimate seconds until admission resumes, from the live
        free-page trend.  Non-recovering trend → the ceiling."""
        if len(self._history) < 2:
            return ceil
        (t0, p0), (t1, p1) = self._history[0], self._history[-1]
        dt = t1 - t0
        if dt <= 0.0:
            return ceil
        slope = (p1 - p0) / dt  # pages freed per second
        if slope <= 0.0:
            return ceil
        # pages still needed to clear the admission-pause exit threshold
        need = self.exit[ADMIT_PAUSE - 1] * self._total - p1
        if need <= 0.0:
            return floor
        return max(floor, min(ceil, need / slope))
