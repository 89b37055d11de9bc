"""ReplicaRouter: load-aware request routing over D engine replicas.

One ``LLMEngine`` (even TP-sharded) is one continuous batch; scaling a
serving deployment past one batch means DATA parallelism — D independent
engine replicas, each with its own ``EngineRunner`` thread, its own page
pool, and its own prefix cache.  The router is the seam: it presents the
EngineRunner surface the asyncio frontend already speaks (submit / abort
/ inflight / draining / drain / abort_all / close), so
``ServingFrontend`` and the CLI's drain path work unchanged whether
``self.runner`` is one runner or this fan-out.

Routing policies (``policy=``):

    least      least-outstanding-tokens: each replica's load is the sum
               of ``len(prompt) + max_new_tokens`` over its unfinished
               requests (the page/compute cost a request can still
               incur); ties break to the LOWEST replica index, so a
               drained fleet fills deterministically.
    affinity   (default) prefix-affinity first, least-outstanding as the
               fallback: the incoming prompt is chain-hashed page by
               page with the SAME rolling hash ``BlockManager`` uses
               (kv_cache.prefix_chain_hashes), and each replica keeps a
               bounded registry of the page hashes routed to it.  The
               replica matching the LONGEST leading run of the prompt's
               page hashes already holds those pages in its prefix
               cache — landing there turns the prompt's shared prefix
               into cache hits instead of recomputed prefill.  No match
               anywhere -> least-outstanding.
    random     seeded uniform choice — the control arm serve_bench's
               router A/B measures against.

The router tracks affinity with its OWN per-replica hash registries
rather than reading engine pool state: ``BlockManager`` belongs to the
engine thread and is lock-free by design, so the router predicts cache
residency from what it routed (an upper bound that decays with
evictions — the registry is LRU-capped to stay honest about recency).
Outstanding-token accounting is exact: credited at submit, released by a
wrapped ``deliver`` when the terminal ("finish", out) event passes
through.

Per-replica counters (``router_counters()``): ``outstanding_tokens``,
``routed_requests``, ``affinity_hits`` — surfaced as labeled gauges on
``/metrics`` and in ``serve_bench --replicas`` records.
"""
from __future__ import annotations

import random
import threading
from collections import OrderedDict

from ...analysis.lock_check import install as _install_lock_check
from ..kv_cache import prefix_chain_hashes
from ..policy import pick_replica
from .runner import EngineRunner

__all__ = ["ReplicaRouter", "build_replicas"]

_POLICIES = ("affinity", "least", "random")


@_install_lock_check
class ReplicaRouter:
    """EngineRunner-shaped facade over D replica runners.

    Parameters
    ----------
    runners: list of started-or-startable ``EngineRunner``s, one per
        replica, each constructed with ``name="r{i}"`` matching its
        index (request ids then self-describe their owner: "r2-req-5").
    policy: "affinity" (default) | "least" | "random".
    registry_cap: per-replica bound on remembered page hashes (LRU) —
        keeps the affinity memory aligned with what a replica's pool
        can actually still hold.
    seed: RNG seed for the random policy (deterministic benches).
    """

    def __init__(self, runners, *, policy: str = "affinity",
                 registry_cap: int = 8192, seed: int = 0, tracer=None):
        if not runners:
            raise ValueError("need at least one replica runner")
        if policy not in _POLICIES:
            raise ValueError(
                f"policy must be one of {_POLICIES}, got {policy!r}")
        for i, r in enumerate(runners):
            if r.name != f"r{i}":
                raise ValueError(
                    f"runner {i} must be named 'r{i}' (got {r.name!r}) "
                    "so request ids route aborts back to it")
        self.runners = list(runners)
        self.policy = policy
        self.registry_cap = int(registry_cap)
        self._rng = random.Random(0xB10C ^ int(seed))
        self._lock = threading.Lock()
        n = len(self.runners)
        self._outstanding = [0] * n       # tokens credited, not yet done
        self._routed = [0] * n            # requests landed per replica
        self._affinity_hits = [0] * n     # routed by a registry match
        # per-replica LRU of page chain hashes routed there
        self._registry = [OrderedDict() for _ in range(n)]
        self._block_size = self.runners[0].engine.block_size
        # step-timeline hook: pick latency + affinity outcome per route
        self.tracer = tracer
        self._trace_track = tracer.register("router") \
            if tracer is not None else "router"

    # ------------------------------------------------------------------
    # EngineRunner surface
    # ------------------------------------------------------------------

    @property
    def engine(self):
        """Replica 0's live engine — the representative the frontend
        reads config/pressure/fault surfaces from.  Per-replica engines
        are reachable via ``engines``."""
        return self.runners[0].engine

    @property
    def engines(self) -> list:
        return [r.engine for r in self.runners]

    @property
    def max_pending(self) -> int:
        return sum(r.max_pending for r in self.runners)

    @property
    def draining(self) -> bool:
        return any(r.draining for r in self.runners)

    @property
    def restarts(self) -> int:
        return sum(r.restarts for r in self.runners)

    def start(self) -> "ReplicaRouter":
        for r in self.runners:
            r.start()
        return self

    def submit(self, prompt, *, deliver, deadline_s: float | None = None,
               **params) -> str:
        """Route one request to a replica and submit it there.  The
        terminal event passing through ``deliver`` releases the
        replica's outstanding-token credit.  Raises whatever the chosen
        replica's submit raises (RunnerSaturated / RunnerDraining)."""
        toks = [int(t) for t in prompt]
        cost = len(toks) + int(params.get("max_new_tokens", 32))
        hashes = prefix_chain_hashes(toks, self._block_size) \
            if self.policy == "affinity" else []
        tr = self.tracer
        with self._lock:
            t_pick = tr.now() if tr is not None else 0
            idx, hit = self._pick(hashes)
            if tr is not None:
                tr.complete("router.pick", t_pick, track=self._trace_track,
                            args={"replica": idx, "policy": self.policy,
                                  "prefix_pages": len(hashes)})
            # credit BEFORE the replica's submit: the engine thread can
            # deliver the terminal event (and settle) before submit
            # returns, and later _pick calls must see this request's
            # load either way
            self._outstanding[idx] += cost
            self._routed[idx] += 1
            if hit:
                self._affinity_hits[idx] += 1
            reg = self._registry[idx]
            for h in hashes:
                reg.pop(h, None)              # refresh recency
                reg[h] = None
            while len(reg) > self.registry_cap:
                reg.popitem(last=False)

        if hit:
            # a registry match means this replica served the prefix
            # before — if pressure has since spilled those pages to its
            # host tier, the hint lets the engine pre-stage them at the
            # next step boundary, ahead of this request's admission
            hint = getattr(self.runners[idx].engine, "prefetch_hint", None)
            if hint is not None:
                hint(hashes)

        settled = [False]

        def deliver_wrapped(ev, _deliver=deliver):
            # runners deliver exactly one terminal event per request
            # (generation-guarded), so this one-shot is belt-and-braces
            if ev[0] == "finish" and not settled[0]:
                settled[0] = True
                with self._lock:
                    self._outstanding[idx] -= cost
            _deliver(ev)

        try:
            rid = self.runners[idx].submit(
                toks, deliver=deliver_wrapped, deadline_s=deadline_s,
                **params)
            if tr is not None:
                tr.instant(
                    "router.affinity_hit" if hit
                    else "router.affinity_miss",
                    track=self._trace_track,
                    args={"replica": idx, "request_id": rid})
                tr.instant("router.routed", track=self._trace_track,
                           args={"replica": idx, "request_id": rid,
                                 "cost_tokens": cost})
            return rid
        except Exception:
            with self._lock:
                self._outstanding[idx] -= cost
                self._routed[idx] -= 1
                if hit:
                    self._affinity_hits[idx] -= 1
            raise

    def abort(self, request_id: str, reason: str = "aborted") -> None:
        idx = self._owner(request_id)
        if idx is not None:
            self.runners[idx].abort(request_id, reason)

    def inflight(self) -> int:
        return sum(r.inflight() for r in self.runners)

    def drain(self, timeout_s: float | None = None) -> bool:
        """Drain every replica concurrently (each runner's drain is a
        blocking wait; serializing them would stack timeouts)."""
        results = [False] * len(self.runners)

        def one(i, r):
            results[i] = r.drain(timeout_s=timeout_s)

        threads = [threading.Thread(target=one, args=(i, r), daemon=True)
                   for i, r in enumerate(self.runners)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return all(results)

    def abort_all(self, reason: str = "shutdown") -> int:
        return sum(r.abort_all(reason) for r in self.runners)

    def close(self, *, abort_inflight: bool = True) -> None:
        threads = [threading.Thread(
            target=r.close, kwargs={"abort_inflight": abort_inflight},
            daemon=True) for r in self.runners]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

    # ------------------------------------------------------------------
    # routing internals
    # ------------------------------------------------------------------

    def _pick(self, hashes) -> tuple:  # guarded-by: _lock
        """(replica index, was-affinity-hit).  Caller holds the lock.
        The decision itself is ``policy.pick_replica`` — pure, shared
        with the fleet simulator so simulated routing uses the SAME
        leading-run/tie-break semantics as the live router."""
        return pick_replica(self.policy, hashes, self._registry,
                            self._outstanding, rng=self._rng)

    def _owner(self, request_id: str):
        """Replica index encoded in the id ("r3-req-7" -> 3)."""
        if request_id.startswith("r"):
            head = request_id.split("-", 1)[0][1:]
            if head.isdigit() and int(head) < len(self.runners):
                return int(head)
        return None

    # ------------------------------------------------------------------
    # observability
    # ------------------------------------------------------------------

    def router_counters(self) -> dict:
        with self._lock:
            return {
                "policy": self.policy,
                "replicas": len(self.runners),
                "outstanding_tokens": list(self._outstanding),
                "routed_requests": list(self._routed),
                "affinity_hits": list(self._affinity_hits),
                "affinity_hit_total": sum(self._affinity_hits),
                "routed_total": sum(self._routed),
            }

    def affinity_hit_rate(self) -> float:
        with self._lock:
            total = sum(self._routed)
            return sum(self._affinity_hits) / total if total else 0.0

    def load_imbalance(self) -> float:
        """max/mean outstanding tokens across replicas (1.0 = perfectly
        even; 0.0 when the fleet is idle)."""
        with self._lock:
            vals = list(self._outstanding)
        mean = sum(vals) / len(vals)
        return max(vals) / mean if mean > 0 else 0.0

    def stats_snapshot(self) -> dict:
        """Aggregated ServingStats snapshot across every replica.
        Snapshots carry their reservoir samples so the fleet's latency
        percentiles are recomputed over the pooled union rather than
        reported as a max-of-quantiles bound."""
        from ...profiler import ServingStats
        return ServingStats.aggregate(
            [r.engine.stats.snapshot(include_samples=True)
             for r in self.runners])


def build_replicas(engine, engine_factory, n: int, *,
                   max_pending: int | None = None,
                   step_deadline_s: float | None = None) -> list:
    """Construct n replica runners: replica 0 wraps ``engine`` (the one
    the caller already built), replicas 1..n-1 come fresh from
    ``engine_factory`` — the same factory contract supervised recovery
    uses, so every replica shares model weights and recovery works per
    replica."""
    if n > 1 and engine_factory is None:
        raise ValueError(
            f"replicas={n} needs an engine_factory to build the extra "
            "engine replicas")
    engines = [engine] + [engine_factory() for _ in range(n - 1)]
    return [EngineRunner(e, max_pending=max_pending,
                         engine_factory=engine_factory,
                         step_deadline_s=step_deadline_s, name=f"r{i}")
            for i, e in enumerate(engines)]
