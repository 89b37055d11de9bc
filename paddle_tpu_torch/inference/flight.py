"""Per-request flight recorder: a bounded LRU of request forensics.

``ServingStats`` tells you the stream was slow; the flight recorder
tells you what happened to request ``r2-req-5`` specifically: when it
arrived, how long it queued, how its prompt prefilled (chunks, tokens
the prefix cache already held), how speculation treated it (accepted
vs rolled-back drafts), whether it was preempted or quarantined, what
degradation tier the engine was in when it was admitted vs when it
finished, which replica ran it, why it ended, and how much deadline
slack it had left at each phase.  The frontend serves individual
records at ``GET /debug/requests/<id>`` and ranked lists at
``GET /debug/requests?finished=slowest``.

Design rules, inherited from the tracer (profiler/trace.py):

* **Disabled means free.**  The engine holds ``self.flight = None``
  unless a recorder is installed; every seam guards on that FIRST, so
  an engine without one executes no line of this file (pinned by
  tracemalloc test, like the tracer's).
* **Bounded forever.**  Records live in an insertion-ordered dict
  capped at ``capacity``; opening a record past the cap evicts the
  OLDEST and counts it in ``evicted`` — a server fielding millions of
  requests holds the most recent window and says how much it shed.
* **Engine-keyed, frontend-joined.**  The engine keys records by rid
  (all it knows); the runner ``annotate()``s the frontend request id,
  replica name, and deadline onto the record at admission — the same
  cross-tier join the tracer's ``runner.deliver`` instants carry.
  After a crash recovery the runner re-admits live requests into a
  fresh engine whose rids restart at 0, so a re-opened rid replaces
  the older record: the recorder describes the LATEST attempt.

All timestamps are ``time.perf_counter()`` seconds (monotonic, never
wall clock); only durations and slacks are exposed.
"""
from __future__ import annotations

import threading
import time

__all__ = ["FlightRecorder", "FlightRecord"]


class FlightRecord:
    """One request's structured forensic record.  Plain attributes +
    ``to_dict()``; mutated only under the owning recorder's lock."""

    __slots__ = (
        "rid", "request_id", "replica",
        "t_submit", "t_admit", "t_first_token", "t_finish",
        "prompt_tokens", "generated_tokens",
        "queue_wait_s", "cache_hit_tokens", "prefill_chunks",
        "spec_rounds", "spec_accepted", "spec_rollback",
        "preemptions", "quarantined",
        "tier_admit", "tier_finish",
        "finish_reason", "deadline_s",
        "slack_admit_s", "slack_first_token_s", "slack_finish_s",
        "ttft_s", "latency_s",
    )

    def __init__(self, rid: int, prompt_tokens: int, t_submit: float):
        self.rid = rid
        self.request_id = None
        self.replica = None
        self.t_submit = t_submit
        self.t_admit = None
        self.t_first_token = None
        self.t_finish = None
        self.prompt_tokens = prompt_tokens
        self.generated_tokens = 0
        self.queue_wait_s = None
        self.cache_hit_tokens = 0
        self.prefill_chunks = 0
        self.spec_rounds = 0
        self.spec_accepted = 0
        self.spec_rollback = 0
        self.preemptions = 0
        self.quarantined = False
        self.tier_admit = None
        self.tier_finish = None
        self.finish_reason = None
        self.deadline_s = None
        self.slack_admit_s = None
        self.slack_first_token_s = None
        self.slack_finish_s = None
        self.ttft_s = None
        self.latency_s = None

    @property
    def finished(self) -> bool:
        return self.finish_reason is not None

    def _slack(self, t: float):
        """Deadline slack at elapsed time ``t - t_submit``: positive
        means budget remained, negative means the phase happened past
        the deadline.  None when the request carried no deadline."""
        if self.deadline_s is None:
            return None
        return round(self.deadline_s - (t - self.t_submit), 6)

    def to_dict(self) -> dict:
        r6 = lambda v: None if v is None else round(v, 6)  # noqa: E731
        return {
            "rid": self.rid,
            "request_id": self.request_id,
            "replica": self.replica,
            "prompt_tokens": self.prompt_tokens,
            "generated_tokens": self.generated_tokens,
            "queue_wait_s": r6(self.queue_wait_s),
            "cache_hit_tokens": self.cache_hit_tokens,
            "prefill_chunks": self.prefill_chunks,
            "spec_rounds": self.spec_rounds,
            "spec_accepted": self.spec_accepted,
            "spec_rollback": self.spec_rollback,
            "preemptions": self.preemptions,
            "quarantined": self.quarantined,
            "tier_admit": self.tier_admit,
            "tier_finish": self.tier_finish,
            "finished": self.finished,
            "finish_reason": self.finish_reason,
            "deadline_s": r6(self.deadline_s),
            "slack_admit_s": r6(self.slack_admit_s),
            "slack_first_token_s": r6(self.slack_first_token_s),
            "slack_finish_s": r6(self.slack_finish_s),
            "ttft_s": r6(self.ttft_s),
            "latency_s": r6(self.latency_s),
        }


class FlightRecorder:
    """Bounded LRU of :class:`FlightRecord`, keyed by engine rid with
    a frontend request-id join index.  Every mutator is a dict lookup
    plus attribute writes under one small lock; a seam called with an
    evicted/unknown rid is a silent no-op (the record was shed, the
    request must not pay for forensics)."""

    def __init__(self, capacity: int = 512):
        self.capacity = max(1, int(capacity))
        self._records: dict = {}          # rid -> record, insertion order
        self._by_request_id: dict = {}    # request_id -> rid
        self.evicted = 0                  # records shed by the LRU bound
        self._lock = threading.Lock()

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)

    # -- engine seams -------------------------------------------------------

    def open(self, rid: int, *, prompt_tokens: int,
             t_submit: float | None = None) -> None:
        """One request entered the engine queue (add_request)."""
        rec = FlightRecord(int(rid), int(prompt_tokens),
                           time.perf_counter()
                           if t_submit is None else float(t_submit))
        with self._lock:
            old = self._records.pop(rid, None)   # recovery re-admit
            if old is not None and old.request_id is not None:
                self._by_request_id.pop(old.request_id, None)
            while len(self._records) >= self.capacity:
                oldest = next(iter(self._records))
                victim = self._records.pop(oldest)
                if victim.request_id is not None:
                    self._by_request_id.pop(victim.request_id, None)
                self.evicted += 1
            self._records[rid] = rec

    def admitted(self, rid: int, *, queue_wait_s: float,
                 cache_hit_tokens: int = 0, tier: int = 0) -> None:
        with self._lock:
            rec = self._records.get(rid)
            if rec is None:
                return
            rec.t_admit = rec.t_submit + queue_wait_s
            rec.queue_wait_s = queue_wait_s
            rec.cache_hit_tokens = int(cache_hit_tokens)
            rec.tier_admit = int(tier)
            rec.slack_admit_s = rec._slack(rec.t_admit)

    def annotate(self, rid: int, *, request_id=None, replica=None,
                 deadline_s=None) -> None:
        """Runner-tier join: frontend request id, replica name, and
        the deadline budget (seconds from submit) if any."""
        with self._lock:
            rec = self._records.get(rid)
            if rec is None:
                return
            if request_id is not None:
                rec.request_id = str(request_id)
                self._by_request_id[rec.request_id] = rid
            if replica is not None:
                rec.replica = str(replica)
            if deadline_s is not None:
                rec.deadline_s = float(deadline_s)

    def prefill_chunk(self, rid: int, n_tokens: int) -> None:
        with self._lock:
            rec = self._records.get(rid)
            if rec is not None:
                rec.prefill_chunks += 1

    def first_token(self, rid: int, ttft_s: float) -> None:
        with self._lock:
            rec = self._records.get(rid)
            if rec is None:
                return
            rec.ttft_s = ttft_s
            rec.t_first_token = rec.t_submit + ttft_s
            rec.slack_first_token_s = rec._slack(rec.t_first_token)

    def spec_round(self, rid: int, accepted: int, rollback: int) -> None:
        with self._lock:
            rec = self._records.get(rid)
            if rec is None:
                return
            rec.spec_rounds += 1
            rec.spec_accepted += int(accepted)
            rec.spec_rollback += int(rollback)

    def preempted(self, rid: int) -> None:
        with self._lock:
            rec = self._records.get(rid)
            if rec is not None:
                rec.preemptions += 1

    def finished(self, rid: int, *, reason: str, generated: int,
                 tier: int = 0, quarantined: bool = False) -> None:
        t = time.perf_counter()
        with self._lock:
            rec = self._records.get(rid)
            if rec is None:
                return
            rec.t_finish = t
            rec.finish_reason = str(reason)
            rec.generated_tokens = int(generated)
            rec.tier_finish = int(tier)
            rec.quarantined = bool(quarantined)
            rec.latency_s = t - rec.t_submit
            rec.slack_finish_s = rec._slack(t)

    # -- read surface (frontend /debug/requests) ----------------------------

    def get(self, key) -> dict | None:
        """Record by frontend request id (string) or engine rid."""
        with self._lock:
            rid = self._by_request_id.get(key, key)
            rec = self._records.get(rid)
            return rec.to_dict() if rec is not None else None

    def list(self, *, finished: bool | None = None,
             sort: str = "slowest", limit: int = 32) -> list:
        """Ranked records: ``sort="slowest"`` by total latency (live
        requests rank by elapsed-so-far), ``"recent"`` by insertion."""
        t = time.perf_counter()
        with self._lock:
            recs = list(self._records.values())
        if finished is not None:
            recs = [r for r in recs if r.finished == finished]
        if sort == "slowest":
            recs.sort(key=lambda r: (r.latency_s if r.latency_s is not None
                                     else t - r.t_submit),
                      reverse=True)
        else:
            recs.reverse()                # newest (insertion order) first
        out = []
        for r in recs[:max(0, int(limit))]:
            d = r.to_dict()
            # total latency for finished records, elapsed-so-far for
            # live ones — the cross-replica merge key for "slowest"
            d["elapsed_s"] = round(r.latency_s if r.latency_s is not None
                                   else t - r.t_submit, 6)
            out.append(d)
        return out
