"""EngineRunner: the thread bridge between the async frontend and the
single-threaded LLMEngine.

The engine (inference/serving.py) is deliberately single-threaded — its
scheduler, page pool, and host-side batch buffers are mutated with no
locks.  The frontend, meanwhile, is an asyncio event loop serving many
sockets.  This module owns the seam: ONE dedicated thread steps the
engine forever, and every cross-thread interaction goes through queues
that the stepping thread drains at step boundaries (the only moments the
engine's state is consistent):

    HTTP thread                     engine thread
    -----------                     -------------
    submit()  ──▶ inbox deque  ──▶  engine.add_request(...)
    abort()   ──▶ abort deque  ──▶  engine.abort(rid, reason)
                                    engine.step()
    deliver(ev) ◀── on_token/on_finish callbacks (engine thread) ◀──┘

Tokens flow OUT through each request's ``deliver`` callable — invoked on
the engine thread with ("token", tok) / ("finish", RequestOutput)
events; the HTTP layer passes a closure that trampolines onto its event
loop (``loop.call_soon_threadsafe``), a sync caller can pass
``queue.Queue.put_nowait`` directly.  Backpressure is enforced HERE (not
in the engine): ``submit`` refuses work past ``max_pending``
(RunnerSaturated → the HTTP layer's 429) and while draining
(RunnerDraining → 503).

Deadlines are runner-owned: each handle carries an absolute monotonic
deadline covering queue wait AND generation; the stepping thread sweeps
expired handles every iteration and aborts them with reason
``"deadline"`` — so a deadline fires even for a request still sitting in
the admission queue.

``drain()`` is the graceful-shutdown half: stop admitting (submit
refuses), let the engine finish or deadline-out everything in flight,
then park the thread.  ``close(abort_inflight=True)`` is the impatient
variant that aborts the in-flight set instead of finishing it.

Supervised recovery (``engine_factory`` + ``step_deadline_s``): the
runner journals every token a handle has been delivered
(``StreamHandle.emitted``).  When a step CRASHES, the stepping thread
rebuilds the engine via the factory and replays every admitted handle
as a continuation (``add_request(generated=journal)``) — the prefix
cache makes the re-prefill cheap, and because sampling keys derive from
(seed, position) the continuation is byte-identical to the
uninterrupted run.  When a step HANGS past ``step_deadline_s``, a
watchdog thread performs the same recovery and spawns a replacement
stepping thread; the wedged thread becomes a zombie that exits at its
next generation check.  Every token/finish callback is GENERATION-
guarded under the runner lock — a zombie's late deliveries are dropped
before they can duplicate or reorder what the client sees — and the
journal append + guard + delivery happen under that one lock, so the
recovery snapshot is race-free by construction.  The engine's
ServingStats object (and any FaultPlan / DegradationController) carries
over to the rebuilt engine, so uptime and counters describe the
SERVICE, not one engine incarnation.

The async engine pipeline (``LLMEngine(overlap=True)``) needs NOTHING
new here, by construction: ``engine.step()`` still contains the
blocking completion of whatever launch it materializes, so the
watchdog's per-call deadline naturally spans dispatch→completion of a
ticket, and ``on_token`` fires from ``step()``'s returned outputs —
i.e. only at COMPLETION boundaries, never for a launch still in
flight.  A crash mid-pipeline therefore leaves the journal holding
exactly the tokens of fully completed steps, which is precisely the
state the replay continuation rebuilds; the in-flight launch and any
speculatively pre-staged next step die with the old engine.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass, field

__all__ = ["EngineRunner", "RunnerSaturated", "RunnerDraining",
           "StreamHandle"]


class RunnerSaturated(RuntimeError):
    """Admission queue full — shed the request (HTTP 429)."""


class RunnerDraining(RuntimeError):
    """Server is draining — no new work (HTTP 503)."""


@dataclass
class StreamHandle:
    """One submitted request as the frontend sees it."""
    request_id: str                   # runner-scoped id (assigned here)
    deliver: object                   # callable(event) on the engine thread
    deadline: float | None            # absolute time.monotonic() deadline
    params: dict                      # add_request kwargs
    rid: int = -1                     # engine rid once admitted
    done: bool = False
    t_submit: float = field(default_factory=time.monotonic)
    # recovery journal: every token delivered so far.  Appended under
    # the runner lock by the generation-guarded on_token closure; a
    # rebuilt engine replays the request as a continuation of exactly
    # this list.
    emitted: list = field(default_factory=list)


class EngineRunner:
    """Owns the engine's stepping thread and the cross-thread queues.

    Parameters
    ----------
    engine: an LLMEngine (ideally built with ``retain_outputs=False`` so
        a long-running server does not accumulate finished outputs).
    max_pending: admission bound — submitted-but-unfinished requests the
        runner will hold before shedding (queued + running).  Sized a
        few times ``engine.max_num_seqs`` so a burst queues instead of
        shedding, but an overload sheds instead of growing without
        bound.
    idle_wait_s: how long the stepping thread parks when there is no
        work (woken early by submit/abort/drain).
    engine_factory: nullary callable building a replacement engine after
        a crashed or hung step.  None (the default) disables recovery —
        a step exception fails the in-flight set and stops the runner.
    step_deadline_s: watchdog per-step wall budget.  A step running
        longer is treated as hung: the watchdog thread rebuilds the
        engine and spawns a replacement stepping thread.  Must sit above
        the engine's worst-case honest step (first-step kernel builds
        included).  Under the async pipeline one ``step()`` call spans
        the completion block of the in-flight launch plus the next
        dispatch, so the budget covers dispatch→completion of a ticket
        with no watchdog change.  None disables the watchdog (crash
        recovery still works when a factory is set).
    max_restarts: recovery budget; exceeding it fails the in-flight set
        instead of rebuilding again (a deterministic crash must not loop
        forever).
    name: optional runner name, prefixed onto every request id
        ("r0-req-3") — a replica router recovers the owning runner from
        the id alone, so aborts route without a shared table.
    """

    def __init__(self, engine, *, max_pending: int | None = None,
                 idle_wait_s: float = 0.05, engine_factory=None,
                 step_deadline_s: float | None = None,
                 max_restarts: int = 8, name: str = ""):
        self.engine = engine
        self.name = str(name)
        self._id_prefix = f"{self.name}-" if self.name else ""
        self.max_pending = int(max_pending
                               if max_pending is not None
                               else 4 * engine.max_num_seqs)
        self.idle_wait_s = float(idle_wait_s)
        self._engine_factory = engine_factory
        self.step_deadline_s = None if step_deadline_s is None \
            else float(step_deadline_s)
        self.max_restarts = int(max_restarts)
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._inbox: deque = deque()          # StreamHandle, FIFO
        self._aborts: deque = deque()         # (request_id, reason)
        self._handles: dict = {}              # request_id -> StreamHandle
        self._by_rid: dict = {}               # engine rid -> StreamHandle
        self._inflight = 0                    # submitted, not yet finished
        self._draining = False
        self._stopped = False
        self._seq = itertools.count()
        # recovery generation: bumped (under _lock) on every engine
        # rebuild.  Callbacks and loop iterations carry the generation
        # they were created under; a mismatch means "your engine is
        # dead — drop everything and exit".
        self._gen = 0
        self._restarts = 0
        # (generation, t_start) of the step currently executing, or None
        # between steps.  Generation-tagged so a zombie's cleanup cannot
        # clear the replacement thread's timer.
        self._step_started = None
        tname = f"llm-engine-{self.name}" if self.name else "llm-engine"
        self._thread = threading.Thread(target=self._loop, args=(0,),
                                        name=tname, daemon=True)
        self._watchdog = None
        self._started = False
        # step-timeline track, registered lazily on first traced event
        # (the engine owns the Tracer; a rebuilt engine keeps it via the
        # factory, so delivery/restart events survive recovery)
        self._trace_track = None

    def _tracer(self):
        """The live engine's Tracer, or None (the zero-cost default)."""
        tr = getattr(self.engine, "tracer", None)
        if tr is not None and self._trace_track is None:
            base = f"runner-{self.name}" if self.name else "runner"
            self._trace_track = tr.register(base)
        return tr

    @property
    def restarts(self) -> int:
        with self._lock:
            return self._restarts

    # ------------------------------------------------------------------
    # any-thread API
    # ------------------------------------------------------------------

    def start(self) -> "EngineRunner":
        if not self._started:
            self._started = True
            self._thread.start()
            if self.step_deadline_s is not None \
                    and self._engine_factory is not None:
                self._watchdog = threading.Thread(
                    target=self._watch, name="llm-watchdog", daemon=True)
                self._watchdog.start()
        return self

    def submit(self, prompt, *, deliver, deadline_s: float | None = None,
               **params) -> str:
        """Queue one generation request.  ``deliver`` receives
        ("token", int) events and exactly one terminal
        ("finish", RequestOutput) event, all on the engine thread.
        ``deadline_s`` is a relative budget from now (queue wait
        included).  Returns the runner request id (the abort() handle).
        Raises RunnerSaturated / RunnerDraining instead of queuing."""
        with self._lock:
            if self._draining or self._stopped:
                raise RunnerDraining("runner is draining")
            if self._inflight >= self.max_pending:
                raise RunnerSaturated(
                    f"{self._inflight} requests in flight >= max_pending "
                    f"{self.max_pending}")
            request_id = f"{self._id_prefix}req-{next(self._seq)}"
            deadline = None if deadline_s is None \
                else time.monotonic() + float(deadline_s)
            h = StreamHandle(request_id=request_id, deliver=deliver,
                             deadline=deadline, params=dict(params))
            h.params["prompt"] = prompt
            self._handles[request_id] = h
            self._inbox.append(h)
            self._inflight += 1
        self._wake.set()
        return request_id

    def abort(self, request_id: str, reason: str = "aborted") -> None:
        """Request cancellation; applied at the next step boundary.  The
        stream still receives its terminal ("finish", output) event (with
        the abort reason) unless it already finished — aborting a
        finished/unknown id is a no-op."""
        with self._lock:
            self._aborts.append((request_id, reason))
        self._wake.set()

    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    @property
    def draining(self) -> bool:
        with self._lock:
            return self._draining

    def drain(self, timeout_s: float | None = None) -> bool:
        """Graceful shutdown: stop admitting, finish (or deadline-out)
        everything in flight, park the thread.  True when the engine
        drained fully inside the timeout."""
        with self._lock:
            self._draining = True
        self._wake.set()
        t0 = time.monotonic()
        while True:
            with self._lock:
                if self._inflight == 0:
                    break
            if timeout_s is not None \
                    and time.monotonic() - t0 > float(timeout_s):
                break
            time.sleep(0.005)
        with self._lock:
            drained = self._inflight == 0
            self._stopped = True
        self._wake.set()
        if self._started:
            self._thread.join(timeout=5.0)
        return drained

    def abort_all(self, reason: str = "shutdown") -> int:
        """Queue an abort for every request still in flight (applied at
        the next step boundary); returns how many were queued.  The CLI's
        second-SIGINT escalation: a graceful drain already in progress
        completes as soon as these aborts land."""
        with self._lock:
            ids = [h.request_id for h in self._handles.values()
                   if not h.done]
        for request_id in ids:
            self.abort(request_id, reason)
        return len(ids)

    def close(self, *, abort_inflight: bool = True) -> None:
        """Impatient shutdown: abort whatever is still in flight (reason
        "shutdown"), then stop the thread."""
        if abort_inflight:
            with self._lock:
                self._draining = True
            self.abort_all("shutdown")
        self.drain(timeout_s=30.0)

    # ------------------------------------------------------------------
    # engine thread
    # ------------------------------------------------------------------

    def _finish_handle(self, h, out, gen: int | None = None) -> None:
        # engine thread only.  ``gen`` guards a stale engine's finish:
        # after a rebuild the replacement owns the handle, so the old
        # engine's terminal event must be dropped, not delivered.
        with self._lock:
            if gen is not None and gen != self._gen:
                return
            if h.done:
                return
            h.done = True
            self._handles.pop(h.request_id, None)
            if h.rid >= 0:
                self._by_rid.pop(h.rid, None)
            self._inflight -= 1
        if h.deadline is not None:
            # deadline attainment: only deadline-carrying requests vote
            self.engine.stats.record_deadline(
                getattr(out, "finish_reason", None) != "deadline"
                and time.monotonic() <= h.deadline)
        try:
            h.deliver(("finish", out))
        except Exception:
            pass                      # a dead consumer must not kill the loop
        tr = self._tracer()
        if tr is not None:
            tr.instant("runner.finish", track=self._trace_track,
                       args={"request_id": h.request_id, "rid": h.rid,
                             "finish_reason": getattr(
                                 out, "finish_reason", None)})

    def _admit_one(self, eng, h, gen: int, generated=None) -> bool:
        """Admit one handle into ``eng`` with generation-guarded
        callbacks.  ``generated`` is the recovery journal (continuation
        replay); None for a first admission."""

        def _on_token(rid, tok, h=h, g=gen):
            # guard + journal append + delivery under ONE lock hold:
            # the recovery snapshot (which bumps _gen under the same
            # lock before reading h.emitted) can therefore never miss a
            # delivered token or race a zombie into a duplicate
            with self._lock:
                if g != self._gen or h.done:
                    return
                h.emitted.append(tok)
                try:
                    h.deliver(("token", tok))
                except Exception:
                    pass
            tr = self._tracer()
            if tr is not None:
                # the cross-tier join point: engine rid <-> frontend id
                tr.instant("runner.deliver", track=self._trace_track,
                           args={"request_id": h.request_id, "rid": rid,
                                 "tokens": len(h.emitted)})

        def _on_finish(out, h=h, g=gen):
            self._finish_handle(h, out, gen=g)

        params = dict(h.params)
        prompt = params.pop("prompt")
        if generated is not None:
            params["generated"] = list(generated)
        try:
            rid = eng.add_request(prompt, on_token=_on_token,
                                  on_finish=_on_finish, **params)
        except Exception as e:
            from ..serving import RequestOutput
            self._finish_handle(h, RequestOutput(
                rid=-1, prompt=list(prompt), generated=list(h.emitted),
                finish_reason=f"error: {type(e).__name__}: {e}"))
            return False
        h.rid = rid
        fl = getattr(eng, "flight", None)
        if fl is not None:
            # the same cross-tier join the tracer instants carry:
            # engine rid <-> frontend request id, plus the remaining
            # deadline budget measured at engine admission (the flight
            # record's t_submit) so slack fields line up
            fl.annotate(rid, request_id=h.request_id,
                        replica=self.name or None,
                        deadline_s=None if h.deadline is None
                        else h.deadline - time.monotonic())
        with self._lock:
            self._by_rid[rid] = h
        return True

    def _admit_inbox(self, gen: int) -> None:
        eng = self.engine
        while True:
            with self._lock:
                if gen != self._gen or not self._inbox:
                    return
                h = self._inbox.popleft()
            if h.done:                # aborted while still queued
                continue
            self._admit_one(eng, h, gen)

    def _apply_aborts(self, gen: int) -> None:
        while True:
            with self._lock:
                if gen != self._gen or not self._aborts:
                    return
                request_id, reason = self._aborts.popleft()
                h = self._handles.get(request_id)
            if h is None or h.done:
                continue
            if h.rid >= 0:
                # engine.abort fires on_finish -> _finish_handle
                self.engine.abort(h.rid, finish_reason=reason)
            else:
                # never reached the engine: synthesize the terminal event
                from ..serving import RequestOutput
                self._finish_handle(h, RequestOutput(
                    rid=-1, prompt=[], generated=[], finish_reason=reason))
                self.engine.stats.record_abort(reason)

    def _sweep_deadlines(self, gen: int) -> None:
        now = time.monotonic()
        with self._lock:
            expired = [h.request_id for h in self._handles.values()
                       if h.deadline is not None and now > h.deadline
                       and not h.done]
        for request_id in expired:
            with self._lock:
                self._aborts.append((request_id, "deadline"))
        if expired:
            self._apply_aborts(gen)

    # -- supervised recovery -----------------------------------------------

    def _recover(self, gen: int):
        """Rebuild the engine after a crashed/hung step and replay the
        in-flight set from the journal.  Returns the new generation, or
        None when recovery is off/raced/exhausted (the runner stops).
        Called from the stepping thread (crash) or the watchdog (hang);
        the generation check under the lock makes the two racers safe —
        exactly one wins."""
        with self._lock:
            if gen != self._gen:
                return None           # someone else already recovered
            self._gen += 1
            newgen = self._gen
            self._restarts += 1
            restarts = self._restarts
            live = [h for h in self._handles.values() if not h.done]
            # the journal snapshot: taken AFTER the generation bump, so
            # no old-generation callback can append past this point
            replay = [(h, list(h.emitted)) for h in live if h.rid >= 0]
            requeue = [h for h in live
                       if h.rid < 0 and h not in self._inbox]
        old = self.engine
        tr = self._tracer()
        if tr is not None:
            t_rec = tr.now()
        if self._engine_factory is None or restarts > self.max_restarts:
            from ..serving import RequestOutput
            for h in live:
                self._finish_handle(h, RequestOutput(
                    rid=-1, prompt=list(h.params.get("prompt", [])),
                    generated=list(h.emitted),
                    finish_reason="engine_error"))
            with self._lock:
                self._stopped = True
            self._wake.set()
            return None
        # detach the shared fault plan / pressure controller from the
        # dead engine FIRST: a hung step finishing on the zombie thread
        # must not consume scheduled faults or feed the controller stale
        # pool readings while the replacement runs
        plan = getattr(old, "fault_plan", None)
        pressure = getattr(old, "pressure", None)
        if plan is not None:
            old.set_fault_plan(None)
        if pressure is not None:
            old.pressure = None
        # the retired engine gives its device state back before its
        # replacement allocates: a wedged step going on in it then raises
        # at its next use of the pools and its thread exits
        close = getattr(old, "close", None)
        if close is not None:
            close()
        eng = self._engine_factory()
        # metric continuity: the service's stats (and the flight
        # recorder's forensic window) survive the engine
        eng.stats = old.stats
        eng.stats.record_restart()
        eng.flight = getattr(old, "flight", None)
        if plan is not None:
            eng.set_fault_plan(plan)
        eng.pressure = pressure
        self.engine = eng
        # replay admitted requests in submission order (dict order) as
        # continuations of their journals; failures fail only that handle
        for h, emitted in replay:
            h.rid = -1
            cap = int(h.params.get("max_new_tokens", 32))
            if len(emitted) >= cap:
                # the crash lost only the terminal event — the journal
                # already holds the whole budget
                from ..serving import RequestOutput
                self._finish_handle(h, RequestOutput(
                    rid=-1, prompt=list(h.params.get("prompt", [])),
                    generated=list(emitted), finish_reason="length"))
                continue
            self._admit_one(eng, h, newgen,
                            generated=emitted if emitted else None)
        with self._lock:
            for h in requeue:        # popped from the inbox mid-crash
                self._inbox.append(h)
        self._wake.set()
        if tr is not None:
            tr.complete("runner.restart", t_rec, track=self._trace_track,
                        args={"gen": newgen, "restarts": restarts,
                              "replayed": len(replay)})
        return newgen

    def _watch(self) -> None:
        """Watchdog thread: when the current step has run past
        step_deadline_s, recover and spawn a replacement stepping
        thread.  The wedged thread exits at its next generation check;
        its late callbacks are dropped by the generation guard."""
        poll = min(self.step_deadline_s / 4.0, 0.05)
        while True:
            with self._lock:
                if self._stopped:
                    return
                gen = self._gen
            ss = self._step_started
            if ss is not None and ss[0] == gen \
                    and time.monotonic() - ss[1] > self.step_deadline_s:
                tr = self._tracer()
                if tr is not None:
                    tr.instant("runner.watchdog_fired",
                               track=self._trace_track,
                               args={"gen": gen, "stuck_s": round(
                                   time.monotonic() - ss[1], 3)})
                newgen = self._recover(gen)
                if newgen is not None:
                    t = threading.Thread(target=self._loop, args=(newgen,),
                                         name=f"llm-engine-g{newgen}",
                                         daemon=True)
                    self._thread = t
                    t.start()
            time.sleep(poll)

    def _loop(self, gen: int) -> None:
        while True:
            with self._lock:
                if self._stopped or gen != self._gen:
                    return
            eng = self.engine
            try:
                self._apply_aborts(gen)
                self._sweep_deadlines(gen)
                self._admit_inbox(gen)
                if eng.has_unfinished():
                    self._step_started = (gen, time.monotonic())
                    try:
                        eng.step()
                    finally:
                        ss = self._step_started
                        if ss is not None and ss[0] == gen:
                            self._step_started = None
                    continue
            except Exception:
                newgen = self._recover(gen)
                if newgen is None:
                    return
                gen = newgen
                continue
            with self._lock:
                idle = not self._inbox and not self._aborts \
                    and not self._stopped
            if idle:
                self._wake.wait(self.idle_wait_s)
                self._wake.clear()
