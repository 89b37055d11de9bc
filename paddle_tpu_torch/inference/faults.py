"""Deterministic fault injection for the serving tier.

A ``FaultPlan`` is a seeded, step-indexed schedule of failures the chaos
harness drives through the engine: raised step exceptions, artificially
slow steps, NaN-corrupted logit rows, a simulated pool-exhaustion
window, and injected client disconnects at the frontend.  The plan owns
a single global step counter that the engine advances exactly once per
``LLMEngine.step`` call; because the plan object is carried across an
engine rebuild (the runner re-installs it on the replacement engine)
and consumed faults never re-fire, a schedule like "crash at step 5,
NaN at step 12" means what it says even when steps 6-8 were lost to the
restart that crash 5 triggered.

Fault firing is "current step >= scheduled step and not yet consumed"
rather than strict equality — a fault scheduled inside a window the
engine never reaches exactly (because a restart skipped it, or because
no launch happened that step) stays armed until the next opportunity.

Every engine seam guards on ``self.fault_plan is None`` first, so an
engine without a plan pays a single attribute check per step and
nothing else.
"""
from __future__ import annotations

import random

__all__ = ["FaultPlan", "InjectedFault"]


class InjectedFault(RuntimeError):
    """Raised by a FaultPlan crash fault inside LLMEngine.step."""


class FaultPlan:
    """A deterministic schedule of injected serving faults.

    Parameters
    ----------
    seed:
        Seeds the internal RNG used to pick NaN row indices.
    crash_steps:
        Plan steps at which ``take_crash`` fires (raise inside step).
    slow_steps:
        ``{step: seconds}`` — ``take_slow`` returns the sleep duration
        once per scheduled entry.
    nan_steps:
        Plan steps at which one live logit row is corrupted.  The fault
        stays armed across steps with no launch (a step may admit work
        without launching the program) and fires at the next launch.
    pool_window:
        ``(start, end)`` inclusive plan-step window during which the
        BlockManager reports the pool exhausted (allocation pressure
        without actually shrinking the pool).
    conn_drop_requests:
        Ordinals (0-based) of *streaming* frontend requests whose
        connection is dropped server-side after the first token frame.
    inflight_crash_steps / inflight_slow_steps:
        Like ``crash_steps``/``slow_steps`` but fired from the engine's
        COMPLETION seam, while the scheduled step's launch is genuinely
        in flight on-device (overlap mode only — a synchronous engine
        never leaves a launch in flight, so these seams never fire
        there).  Step indices are keyed on completion order, which the
        depth-1 pipeline keeps equal to dispatch order: "in-flight
        crash at step 5" dies between step 5's launch and its
        materialization, after step 4's outputs were delivered.
    """

    def __init__(self, *, seed: int = 0, crash_steps=(), slow_steps=None,
                 nan_steps=(), pool_window=None, conn_drop_requests=(),
                 inflight_crash_steps=(), inflight_slow_steps=None):
        self.seed = int(seed)
        self._rng = random.Random(self.seed)
        self.step = 0
        self._crash = sorted(int(s) for s in crash_steps)
        self._slow = sorted((int(s), float(d))
                            for s, d in (slow_steps or {}).items())
        self._inflight_crash = sorted(int(s) for s in inflight_crash_steps)
        self._inflight_slow = sorted(
            (int(s), float(d))
            for s, d in (inflight_slow_steps or {}).items())
        self._nan = sorted(int(s) for s in nan_steps)
        self.pool_window = (None if pool_window is None
                            else (int(pool_window[0]), int(pool_window[1])))
        self._pool_entered = False
        self._conn_drop = frozenset(int(i) for i in conn_drop_requests)
        self._stream_ordinal = 0
        # step-timeline hook: the owning engine's set_tracer/set_fault_plan
        # install these so every fired fault lands in the trace as an
        # instant; None keeps each take_* at one extra attribute check
        self.tracer = None
        self.trace_track = "engine"

    def _trace(self, kind: str, **args) -> None:
        tr = self.tracer
        if tr is not None:
            args["step"] = self.step
            tr.instant("fault." + kind, track=self.trace_track, args=args)

    @classmethod
    def seeded(cls, seed: int, *, n_crash: int = 1, n_nan: int = 1,
               n_slow: int = 1, slow_s: float = 1.0,
               pool_window_len: int = 4, horizon: int = 40,
               n_conn_drop: int = 0, n_requests: int = 0) -> "FaultPlan":
        """Derive a full chaos schedule from one seed.

        Faults are spread over ``[2, horizon)`` so step 0/1 (first
        compiles) stay clean and the schedule is reproducible for a
        given (seed, horizon).
        """
        rng = random.Random(seed)
        steps = list(range(2, max(horizon, 10)))
        rng.shuffle(steps)
        it = iter(steps)
        crash = sorted(next(it) for _ in range(n_crash))
        nan = sorted(next(it) for _ in range(n_nan))
        slow = {next(it): slow_s for _ in range(n_slow)}
        pool = None
        if pool_window_len > 0:
            start = next(it)
            pool = (start, start + pool_window_len - 1)
        drops = ()
        if n_conn_drop and n_requests:
            drops = rng.sample(range(n_requests),
                               min(n_conn_drop, n_requests))
        return cls(seed=seed, crash_steps=crash, slow_steps=slow,
                   nan_steps=nan, pool_window=pool,
                   conn_drop_requests=drops)

    # -- engine-step seams -------------------------------------------------

    def advance(self) -> None:
        """Advance the global plan step.  Called once per engine step,
        by whichever engine currently holds the plan."""
        self.step += 1

    def take_crash(self) -> bool:
        """True once per scheduled crash whose step has been reached."""
        if self._crash and self.step >= self._crash[0]:
            self._crash.pop(0)
            self._trace("crash")
            return True
        return False

    def take_slow(self) -> float:
        """Sleep seconds for a due slow-step fault, else 0.0."""
        if self._slow and self.step >= self._slow[0][0]:
            dur = self._slow.pop(0)[1]
            self._trace("slow", seconds=dur)
            return dur
        return 0.0

    def take_inflight_crash(self) -> bool:
        """True once per scheduled in-flight crash whose step has been
        reached.  The engine consults this at the top of its completion
        seam, only when the ticket it is about to block on genuinely
        crossed a step boundary in flight."""
        if self._inflight_crash and self.step >= self._inflight_crash[0]:
            self._inflight_crash.pop(0)
            self._trace("inflight_crash")
            return True
        return False

    def take_inflight_slow(self) -> float:
        """Sleep seconds for a due in-flight hang fault, else 0.0.
        Fired from the completion seam like ``take_inflight_crash`` —
        the hang sits between a launch and its materialization, where
        the runner's step-deadline watchdog must still catch it."""
        if self._inflight_slow and self.step >= self._inflight_slow[0][0]:
            dur = self._inflight_slow.pop(0)[1]
            self._trace("inflight_slow", seconds=dur)
            return dur
        return 0.0

    def take_nan_row(self, n_rows: int) -> int | None:
        """Row index to corrupt in the current launch, or None.

        Armed once the plan step reaches the next scheduled NaN step;
        fires at the first launch with at least one live row after
        that, so a no-launch step cannot silently swallow the fault.
        """
        if n_rows > 0 and self._nan and self.step >= self._nan[0]:
            self._nan.pop(0)
            row = self._rng.randrange(n_rows)
            self._trace("nan", row=row)
            return row
        return None

    # -- pool seam ---------------------------------------------------------

    def pool_exhausted(self) -> bool:
        """True while the plan step is inside the exhaustion window.
        Installed as ``BlockManager._fault_hook``."""
        if self.pool_window is None:
            return False
        lo, hi = self.pool_window
        return lo <= self.step <= hi

    def take_pool_entry(self) -> bool:
        """True exactly once, the first step the pool window is active
        (for fault-injection accounting)."""
        if not self._pool_entered and self.pool_exhausted():
            self._pool_entered = True
            self._trace("pool", window=list(self.pool_window))
            return True
        return False

    # -- frontend seam -----------------------------------------------------

    def take_conn_drop(self) -> bool:
        """True when the current streaming request's ordinal is in the
        drop set.  Called once per streaming request, in arrival
        order."""
        i = self._stream_ordinal
        self._stream_ordinal += 1
        if i in self._conn_drop:
            self._trace("conn", ordinal=i)
            return True
        return False

    # -- introspection -----------------------------------------------------

    def exhausted(self) -> bool:
        """True once every scheduled engine-side fault has fired."""
        return not (self._crash or self._slow or self._nan
                    or self._inflight_crash or self._inflight_slow)

    def __repr__(self):
        return (f"FaultPlan(step={self.step}, crash={self._crash}, "
                f"slow={self._slow}, nan={self._nan}, "
                f"pool={self.pool_window}, "
                f"inflight_crash={self._inflight_crash}, "
                f"inflight_slow={self._inflight_slow})")
