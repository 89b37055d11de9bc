"""Model tiers of the serving fleet: ``SimReplica`` and ``SimFleet``.

The fidelity contract (the table in ARCHITECTURE.md renders this):
every pure host-side DECISION runs the real code, every device-side
COST is a calibrated model.

    real, imported      prefill chunk packing (``policy.pack_prefill_
                        chunks`` — the same call ``LLMEngine._schedule_
                        prefill_chunks`` makes), replica choice
                        (``policy.pick_replica`` — the same call
                        ``ReplicaRouter._pick`` makes), decode-window
                        slicing (``policy.window_chunks``), pressure
                        tiers (``pressure.DegradationController`` — the
                        instance itself, fed a pool view), page chain
                        identity (hash tuples with BlockManager's
                        leading-run hit semantics)
    modeled             step wall time (``CostModel``), speculative
                        emission (calibrated tokens-per-row-step with a
                        deterministic fractional accumulator), the page
                        pool (content-addressed refcount model with
                        parked-LRU reuse and preempt-and-recompute)

A replica steps exactly like the engine: admit FCFS while slots and
pages allow -> pack prefill chunks under the token budget -> decode
every KV-complete row (or run a K-step device window when the pack is
pure steady decode) -> commit emissions at step end.  TTFT is
first-token commit time minus submit time; ITL samples are the step
duration each emitted token observed, apportioned to that token's
phase share of the pack — the same accounting ``ServingStats`` does,
so simulated percentiles are comparable to recorded ones.

Two drivers share that step core: ``run_replay`` reproduces
``serve_bench``'s ``_drive`` loop (step-INDEXED arrivals, closed loop —
what validation needs), and ``SimFleet`` schedules open-loop arrivals
in virtual seconds on the event loop, routes them with the real router
policy, and optionally sheds at admission when the predicted TTFT blows
the deadline (the sweep's admission-threshold axis).
"""
from __future__ import annotations

from collections import OrderedDict, deque
from dataclasses import dataclass, field

from ..inference.policy import (pack_prefill_chunks, pick_replica,
                                window_chunks)
from ..inference.pressure import SPEC_SHRINK, DegradationController
from .cost import CostModel
from .events import EventLoop

__all__ = ["ReplicaConfig", "FleetConfig", "SimReplica", "SimFleet"]


def _percentile(sorted_vals, q: float) -> float:
    """Nearest-rank percentile — bit-identical to profiler.serving's."""
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1,
              max(0, int(round(q / 100.0 * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


@dataclass
class ReplicaConfig:
    """One model replica's knobs — field-for-field the ``LLMEngine``
    construction surface the bench uses, plus the two calibrated
    speculation scalars the simulator needs in place of a drafter:

    ``spec_emit_per_row_step``: mean tokens a decode row-step emits
    (1.0 = no speculation; a verify round emitting 1 + accepted pushes
    it up).  ``spec_pack_tokens_per_row``: mean ragged tokens a decode
    row contributes to the pack (a verify row packs k+1).  Both are
    derivable from any mixed bench record — see validate.py.

    ``pipeline_lag_steps``: emission-visibility latency of the async
    step pipeline.  The overlap engine commits launch N's tokens under
    launch N+1's completion block, so every token becomes visible one
    step-active-window after its own step's cadence boundary — latency
    shifts while throughput (the virtual clock) is untouched.  1
    mirrors the engine default (``overlap=on``); validation sets it
    from the record's own ``overlap`` arm.

    ``host_kv_pages``: capacity of the modeled host spill tier, in
    pages (0 = no tier, the engine default).  Mirrors
    ``inference/kv_tier.HostSpillPool`` at the simulator's granularity:
    pressure-driven parked evictions spill their chain hash there
    instead of dying, admission consults the tier on an HBM prefix
    miss, and every restored page charges ``CostModel.restore_page_s``
    to the step that admitted it — so a sweep over this axis trades
    restore latency against re-prefill compute.
    """
    max_num_seqs: int = 8
    block_size: int = 8
    max_model_len: int = 256
    max_prefill_tokens: int = 64
    num_blocks: int | None = None
    enable_prefix_caching: bool = True
    decode_window: int = 1
    spec_emit_per_row_step: float = 1.0
    spec_pack_tokens_per_row: float = 1.0
    pipeline_lag_steps: int = 1
    host_kv_pages: int = 0

    def resolved_num_blocks(self) -> int:
        if self.num_blocks is not None:
            return int(self.num_blocks)
        nblk = -(-self.max_model_len // self.block_size)
        return 1 + self.max_num_seqs * nblk     # the engine's default


@dataclass
class FleetConfig:
    """Fleet-tier knobs: the four sweep axes plus the SLO the sweep
    scores against.  ``admission_ttft_ms`` is the shed threshold: an
    arrival whose PREDICTED TTFT on its routed replica exceeds it is
    rejected at the door (and scored as an SLO miss — shedding is not
    free, it is a controlled way to fail)."""
    replicas: int = 1
    policy: str = "affinity"            # affinity | least | random
    registry_cap: int = 8192
    seed: int = 0
    admission_ttft_ms: float | None = None
    slo_ttft_ms: float = 500.0
    slo_itl_ms: float = 100.0


class _Seq:
    """One in-flight request on a replica.  ``cached`` counts
    KV-resident tokens (prompt hits + prefilled + decoded), exactly the
    engine's ``req.cached`` invariant: decode-ready iff
    ``cached >= prompt_len + generated``."""
    __slots__ = ("req", "t_submit", "arrival", "cached", "generated",
                 "credit", "first_t", "hash_pages", "anon_pages",
                 "done_t")

    def __init__(self, req, t_submit: float):
        self.req = req
        self.t_submit = t_submit
        self.arrival = 0                # admission order (FCFS key)
        self.cached = 0
        self.generated = 0
        self.credit = 0.0               # fractional spec emission carry
        self.first_t = None
        self.hash_pages = 0             # content-addressed refs held
        self.anon_pages = 0             # tail + generated pages held
        self.done_t = None

    @property
    def total_tokens(self) -> int:
        return self.req.prompt_len + self.generated

    @property
    def decode_ready(self) -> bool:
        return self.cached >= self.total_tokens

    @property
    def finished(self) -> bool:
        return self.generated >= self.req.max_new


class _PoolView:
    """The attributes ``DegradationController.update`` reads.  Parked
    pages ride along as ``num_cached`` so the controller credits them
    as reclaimable headroom, exactly as it does against the real
    ``BlockManager``."""
    __slots__ = ("num_blocks", "num_free", "num_cached")

    def __init__(self, num_blocks: int, num_free: int, num_cached: int):
        self.num_blocks = num_blocks
        self.num_free = num_free
        self.num_cached = num_cached


@dataclass
class _Stats:
    """Per-replica sample sink; everything a report needs, exact (the
    simulator can afford to keep every sample — no reservoir)."""
    ttft_s: list = field(default_factory=list)
    itl_s: list = field(default_factory=list)
    req_lat_s: list = field(default_factory=list)
    finished: int = 0
    emitted: int = 0
    prefill_tokens: int = 0
    steps: int = 0
    empty_steps: int = 0
    window_launches: int = 0
    preemptions: int = 0
    cache_hit_tokens: int = 0
    cache_lookup_tokens: int = 0
    busy_s: float = 0.0
    slo_met: int = 0
    spilled_pages: int = 0
    restored_pages: int = 0
    spill_hits: int = 0
    spill_lookups: int = 0

    def reset(self) -> None:
        self.__init__()


class SimReplica:
    """Engine-step-granularity model of one ``LLMEngine`` replica."""

    def __init__(self, cfg: ReplicaConfig, cost: CostModel,
                 name: str = "r0"):
        self.cfg = cfg
        self.cost = cost
        self.name = name
        self.bs = int(cfg.block_size)
        self.num_blocks = cfg.resolved_num_blocks()
        self.capacity = self.num_blocks - 1     # slot 0 is the null block
        self.ctrl = DegradationController()
        self.stats = _Stats()
        self._waiting: deque = deque()
        self._running: list = []
        self._arrival = 0
        # page pool: content-addressed refcounts + parked LRU + anon
        self._refs: dict = {}
        self._parked: OrderedDict = OrderedDict()
        self._anon = 0
        # modeled host spill tier: chain-hash LRU, host_kv_pages deep.
        # Only pressure evictions feed it (demand evictions die, like
        # the real BlockManager); restores are charged in step()
        self._spill: OrderedDict = OrderedDict()
        self._restored_this_step = 0
        self.on_finish = None           # fleet hook: seq -> None
        self._idle = True               # event-mode: no step scheduled
        # SLO bounds stamped by the owner (fleet/validator) so requests
        # score as they retire, single pass
        self.slo_ttft_ms = float("inf")
        self.slo_itl_ms = float("inf")

    # ------------------------------------------------------------------
    # pool model
    # ------------------------------------------------------------------

    def _used(self) -> int:
        return len(self._refs) + len(self._parked) + self._anon

    def _free(self) -> int:
        return self.capacity - self._used()

    def pool_view(self) -> _PoolView:
        return _PoolView(self.num_blocks, self._free(), len(self._parked))

    def _reserve(self, n: int) -> bool:
        """Make ``n`` pages allocatable, evicting parked LRU pages on
        demand (acquire-time eviction, like BlockManager)."""
        while self._free() < n and self._parked:
            self._parked.popitem(last=False)
        return self._free() >= n

    def _pages(self, tokens: int) -> int:
        return -(-int(tokens) // self.bs)

    def _spill_insert(self, h) -> None:
        """Spill one pressure-evicted parked page's chain hash to the
        modeled host tier (LRU, ``host_kv_pages`` deep)."""
        cap = int(self.cfg.host_kv_pages)
        if cap <= 0:
            return
        self._spill.pop(h, None)
        while len(self._spill) >= cap:
            self._spill.popitem(last=False)
        self._spill[h] = None
        self.stats.spilled_pages += 1

    # ------------------------------------------------------------------
    # request intake
    # ------------------------------------------------------------------

    def submit(self, req, t_submit: float) -> None:
        self._waiting.append(_Seq(req, t_submit))

    def has_unfinished(self) -> bool:
        return bool(self._waiting or self._running)

    def queued_prefill_tokens(self) -> int:
        """Prefill work ahead of a NEW arrival: every waiting prompt
        plus the unprefilled remainder of every running row."""
        w = sum(s.total_tokens for s in self._waiting)
        r = sum(max(s.total_tokens - s.cached, 0) for s in self._running)
        return w + r

    def predicted_ttft_s(self, prompt_len: int) -> float:
        """Feasibility estimate for admission shedding: steps to chew
        through the queued prefill tokens plus this prompt at the
        per-step budget, each at the budget-full step cost.  Coarse by
        design — it is a POLICY input, and the sweep measures how the
        policy built on it behaves."""
        tokens = self.queued_prefill_tokens() + int(prompt_len)
        steps = -(-tokens // max(self.cfg.max_prefill_tokens, 1))
        return steps * self.cost.step_cost(self.cfg.max_prefill_tokens)

    def _admit(self) -> None:
        """FCFS admission, the engine's rule: stop at the first request
        the pool cannot hold (head-of-line).  ADMIT_PAUSE does NOT gate
        this loop — in the real stack that tier sheds at the FRONTEND
        (retry_after), while the engine's own waiting queue stays
        purely pool-gated; ``SimFleet._route`` models the shed."""
        while (self._waiting
               and len(self._running) < self.cfg.max_num_seqs):
            s = self._waiting[0]
            total = s.total_tokens
            hashable = s.req.prompt_len // self.bs
            hit_pages = hit_tokens = 0
            if self.cfg.enable_prefix_caching:
                for h in s.req.chain_hashes[:hashable]:
                    if h in self._refs or h in self._parked:
                        hit_pages += 1
                    elif self.cfg.host_kv_pages > 0:
                        # HBM miss: consult the spill tier (counted,
                        # like HostSpillPool.lookup); a hit restores
                        # the page into the parked set — it needs a
                        # free HBM slot and charges restore_page_s in
                        # this step's cost
                        self.stats.spill_lookups += 1
                        if h not in self._spill or self._free() < 1:
                            break
                        del self._spill[h]
                        self._parked[h] = None
                        self._restored_this_step += 1
                        self.stats.restored_pages += 1
                        self.stats.spill_hits += 1
                        hit_pages += 1
                    else:
                        break
                # at least one token must prefill (the engine never
                # admits a fully-cached prompt with nothing to run)
                hit_tokens = min(hit_pages * self.bs, total - 1)
                hit_pages = hit_tokens // self.bs
            pages_total = self._pages(total)
            if not self._reserve(pages_total - hit_pages):
                break
            self._waiting.popleft()
            # take refs: shared leading pages revive/ref++, the rest of
            # the prompt's full pages become fresh content-addressed
            # pages, tail + generated pages are anonymous
            for j, h in enumerate(s.req.chain_hashes[:hashable]):
                if j < hit_pages and h in self._parked:
                    del self._parked[h]
                    self._refs[h] = 1
                else:
                    self._refs[h] = self._refs.get(h, 0) + 1
            s.hash_pages = hashable
            s.anon_pages = pages_total - hashable
            self._anon += s.anon_pages
            s.cached = hit_tokens
            s.arrival = self._arrival
            self._arrival += 1
            self._running.append(s)
            self.stats.cache_hit_tokens += hit_tokens
            self.stats.cache_lookup_tokens += total

    def _release(self, s: _Seq, *, park: bool) -> None:
        """Give back every page ``s`` holds; refcount-0 content pages
        park (stay resident for future hits) when caching is on."""
        for h in s.req.chain_hashes[:s.hash_pages]:
            n = self._refs.get(h)
            if n is None:
                continue
            if n > 1:
                self._refs[h] = n - 1
            else:
                del self._refs[h]
                if park and self.cfg.enable_prefix_caching:
                    self._parked[h] = None
        self._anon -= s.anon_pages
        s.hash_pages = 0
        s.anon_pages = 0

    def _preempt_one(self, protect: _Seq) -> bool:
        """Preempt-and-recompute the LATEST-arrival victim (the
        engine's choice): pages released, generated tokens kept, back
        to the head of the waiting queue."""
        cands = [s for s in self._running
                 if s is not protect and not s.finished]
        if not cands:
            return False
        victim = max(cands, key=lambda s: s.arrival)
        self._running.remove(victim)
        self._release(victim, park=True)
        victim.cached = 0
        self._waiting.appendleft(victim)
        self.stats.preemptions += 1
        return True

    # ------------------------------------------------------------------
    # the step core
    # ------------------------------------------------------------------

    def _spec_eff(self) -> tuple:
        """(emit per row-step, pack tokens per row) under the current
        degradation tier — SPEC_SHRINK halves the speculative surplus,
        mirroring the engine halving draft length."""
        emit = self.cfg.spec_emit_per_row_step
        pack = self.cfg.spec_pack_tokens_per_row
        if self.ctrl.state >= SPEC_SHRINK:
            emit = 1.0 + (emit - 1.0) / 2.0
            pack = 1.0 + (pack - 1.0) / 2.0
        return emit, pack

    def step(self, now: float) -> float:
        """One engine step starting at virtual time ``now``; returns
        its cost (seconds).  Effects commit with end-of-step
        timestamps; nothing outside this replica reads its state
        mid-step, so eager commit is safe."""
        self.ctrl.update(self.pool_view())
        if self.ctrl.evict_now:
            # proactive parked eviction, the engine's per-step batch —
            # spill-first when a host tier is configured
            for _ in range(self.ctrl.evict_batch):
                if not self._parked:
                    break
                h, _ = self._parked.popitem(last=False)
                self._spill_insert(h)
        self._admit()
        # restores the admit pass pulled back from the host tier are
        # step-boundary device writes; they ride this step's wall time
        restore_s = self._restored_this_step * self.cost.restore_page_s
        self._restored_this_step = 0

        ordered = sorted(self._running, key=lambda s: s.arrival)
        chunks = pack_prefill_chunks(
            ((s, s.total_tokens - s.cached) for s in ordered),
            self.cfg.max_prefill_tokens)
        decode_rows = [s for s in ordered if s.decode_ready]
        self.stats.steps += 1
        if not chunks and not decode_rows:
            # nothing packable (idle, or waiting blocked on the pool):
            # the engine still burns a host-side step
            self.stats.empty_steps += 1
            return self.cost.host_per_step_s + restore_s

        emit_eff, pack_eff = self._spec_eff()
        prefill_tokens = sum(n for _, n in chunks)

        # -- device-resident window: pure steady decode only (mirrors
        # _window_eligible: no chunks, nobody waiting on a slot)
        k = 1
        if (self.cfg.decode_window > 1 and not chunks and decode_rows
                and not self._waiting
                and len(decode_rows) == len(self._running)):
            remaining = min(s.req.max_new - s.generated
                            for s in decode_rows)
            k = window_chunks(remaining, self.cfg.decode_window)[0]

        if k > 1:
            cost = self.cost.window_cost(len(decode_rows), k) + restore_s
            self.stats.window_launches += 1
            # the pipeline drains this launch while the next dispatches:
            # tokens become VISIBLE when the next launch's completion
            # block ends (the end of ITS active window), the clock
            # still advances by the launch cost alone
            t_end = now + cost * (
                1 + self.cfg.pipeline_lag_steps * self.cost.active_frac)
            for s in list(decode_rows):
                # window ITL accounting mirrors the engine's: every
                # token in the drain observed the whole launch wall
                self._commit_decode(
                    s, min(k, s.req.max_new - s.generated),
                    cost * self.cost.active_frac, t_end)
            self.stats.busy_s += cost
            return cost

        packed = prefill_tokens + int(len(decode_rows) * pack_eff + 0.5)
        cost = self.cost.step_cost(
            packed,
            pure_decode_rows=len(decode_rows) if not chunks else 0) \
            + restore_s
        # emission-visibility: the async engine commits this launch's
        # tokens when the NEXT step's completion block returns — one
        # lag step's ACTIVE window past the cadence boundary
        t_end = now + cost * (
            1 + self.cfg.pipeline_lag_steps * self.cost.active_frac)
        # ITL samples observe the engine-ACTIVE duration (dispatch +
        # completion block — what record_prefill/record_decode stamp),
        # not the full cadence; active_frac is the calibrated ratio
        active = cost * self.cost.active_frac
        prefill_share = active * prefill_tokens / packed if packed else 0.0
        decode_share = (active * (packed - prefill_tokens) / packed
                        if packed else 0.0)
        for s, n in chunks:
            if s not in self._running:
                continue            # preempted mid-step by page growth
            s.cached += n
            self.stats.prefill_tokens += n
            if s.decode_ready and s.first_t is None:
                # the final chunk emits the first token (the engine
                # samples it from the prefill logits); its latency
                # sample is the step's prefill share, like
                # record_prefill's
                s.first_t = t_end
                self.stats.ttft_s.append(t_end - s.t_submit)
                self.stats.itl_s.append(prefill_share)
                self._emit(s, 1, t_end)
        for s in decode_rows:
            if s not in self._running or s.finished:
                continue
            s.credit += emit_eff
            n = max(1, int(s.credit))
            s.credit -= n
            self._commit_decode(
                s, min(n, s.req.max_new - s.generated), decode_share,
                t_end)
        self.stats.busy_s += cost
        return cost

    def _commit_decode(self, s: _Seq, n: int, itl_sample: float,
                       t_end: float) -> None:
        """Emit ``n`` tokens on row ``s`` at ``t_end``: ITL samples
        (one per token, valued at the step duration it observed — the
        ServingStats convention), page growth, then retirement."""
        if n <= 0:
            return
        self.stats.itl_s.extend([itl_sample] * n)
        grow = self._pages(s.cached + n) - self._pages(s.cached)
        if grow > 0:
            while not self._reserve(grow):
                if not self._preempt_one(s):
                    break           # pool exhausted: model proceeds
            s.anon_pages += grow
            self._anon += grow
        self._emit(s, n, t_end)

    def _emit(self, s: _Seq, n: int, t_end: float) -> None:
        s.generated += n
        s.cached += n
        self.stats.emitted += n
        if s.finished:
            s.done_t = t_end
            self._retire(s, t_end)

    def _retire(self, s: _Seq, t_end: float) -> None:
        self._running.remove(s)
        self._release(s, park=True)
        self.stats.finished += 1
        self.stats.req_lat_s.append(t_end - s.t_submit)
        ttft = (s.first_t - s.t_submit) if s.first_t is not None else 0.0
        itl_ok = True
        if s.generated > 1 and s.first_t is not None:
            mean_itl = (t_end - s.first_t) / (s.generated - 1)
            itl_ok = mean_itl * 1e3 <= self.slo_itl_ms
        if ttft * 1e3 <= self.slo_ttft_ms and itl_ok:
            self.stats.slo_met += 1
        if self.on_finish is not None:
            self.on_finish(s)

    # ------------------------------------------------------------------
    # drivers
    # ------------------------------------------------------------------

    def run_replay(self, requests: list, *, clock0: float = 0.0) -> float:
        """The bench's ``_drive`` loop, virtualized: step-indexed
        arrivals, run to completion, return elapsed virtual seconds."""
        pending = deque(sorted(requests,
                               key=lambda r: (r.arrival_step or 0)))
        clock, step_no = clock0, 0
        while pending or self.has_unfinished():
            while pending and (pending[0].arrival_step or 0) <= step_no:
                self.submit(pending.popleft(), clock)
            clock += self.step(clock)
            step_no += 1
        return clock - clock0

    # event-mode: SimFleet schedules arrivals; the replica self-steps
    # while it has work and goes idle when it runs dry

    def kick(self, loop: EventLoop) -> None:
        if self._idle:
            self._idle = False
            loop.at(loop.now, self._tick, loop)

    def _tick(self, loop: EventLoop) -> None:
        if not self.has_unfinished():
            self._idle = True
            return
        loop.after(self.step(loop.now), self._tick, loop)


class SimFleet:
    """Router + admission over N model replicas on one event loop."""

    def __init__(self, fleet_cfg: FleetConfig, replica_cfg: ReplicaConfig,
                 cost: CostModel):
        import random
        self.cfg = fleet_cfg
        n = int(fleet_cfg.replicas)
        self.replicas = [SimReplica(replica_cfg, cost, name=f"r{i}")
                         for i in range(n)]
        # the router's own mirrors, seeded exactly like ReplicaRouter
        self._rng = random.Random(0xB10C ^ int(fleet_cfg.seed))
        self._outstanding = [0] * n
        self._registry = [OrderedDict() for _ in range(n)]
        self._routed = [0] * n
        self._affinity_hits = 0
        self._credit: dict = {}         # rid -> (replica idx, cost)
        self.shed = 0
        self.submitted = 0
        self.loop = EventLoop()
        for i, rep in enumerate(self.replicas):
            rep.slo_ttft_ms = fleet_cfg.slo_ttft_ms
            rep.slo_itl_ms = fleet_cfg.slo_itl_ms
            rep.on_finish = self._settle

    def _settle(self, seq) -> None:
        """Terminal event: release the routed request's outstanding-
        token credit (the router wraps ``deliver`` the same way)."""
        idx, cost = self._credit.pop(seq.req.rid, (None, 0))
        if idx is not None:
            self._outstanding[idx] -= cost

    def _route(self, req) -> None:
        idx, hit = pick_replica(self.cfg.policy, list(req.chain_hashes),
                                self._registry, self._outstanding,
                                rng=self._rng)
        rep = self.replicas[idx]
        self.submitted += 1
        # frontend sheds: ADMIT_PAUSE on the routed replica (the
        # pressure tier's retry_after contract), or a predicted TTFT
        # past the admission threshold when one is set
        if rep.ctrl.admission_paused:
            self.shed += 1
            return
        if self.cfg.admission_ttft_ms is not None:
            pred = rep.predicted_ttft_s(req.prompt_len) * 1e3
            if pred > self.cfg.admission_ttft_ms:
                self.shed += 1
                return
        cost = req.prompt_len + req.max_new
        self._outstanding[idx] += cost
        self._routed[idx] += 1
        if hit:
            self._affinity_hits += 1
        self._credit[req.rid] = (idx, cost)
        reg = self._registry[idx]
        for h in req.chain_hashes:
            reg.pop(h, None)              # refresh recency
            reg[h] = None
        while len(reg) > self.cfg.registry_cap:
            reg.popitem(last=False)
        rep.submit(req, self.loop.now)
        rep.kick(self.loop)

    def run(self, workload: list) -> dict:
        """Schedule every arrival, drain the loop, report."""
        for req in workload:
            self.loop.at(req.arrival_s or 0.0, self._route, req)
        self.loop.run()
        return self.report()

    # ------------------------------------------------------------------

    def report(self) -> dict:
        ttft = sorted(x for r in self.replicas for x in r.stats.ttft_s)
        itl = sorted(x for r in self.replicas for x in r.stats.itl_s)
        emitted = sum(r.stats.emitted for r in self.replicas)
        finished = sum(r.stats.finished for r in self.replicas)
        met = sum(r.stats.slo_met for r in self.replicas)
        elapsed = self.loop.now
        routed = sum(self._routed)
        lookups = sum(r.stats.cache_lookup_tokens for r in self.replicas)
        return {
            "requests": self.submitted,
            "finished": finished,
            "shed": self.shed,
            "elapsed_s": round(elapsed, 6),
            "tokens_out": emitted,
            "tokens_per_s": round(emitted / elapsed, 3) if elapsed else 0.0,
            "ttft_p50_ms": round(1e3 * _percentile(ttft, 50), 3),
            "ttft_p95_ms": round(1e3 * _percentile(ttft, 95), 3),
            "ttft_p99_ms": round(1e3 * _percentile(ttft, 99), 3),
            "itl_p50_ms": round(1e3 * _percentile(itl, 50), 3),
            "itl_p95_ms": round(1e3 * _percentile(itl, 95), 3),
            "itl_p99_ms": round(1e3 * _percentile(itl, 99), 3),
            # shed requests are SLO misses by definition
            "slo_attainment": round(met / self.submitted, 4)
            if self.submitted else 0.0,
            "affinity_hit_rate": round(self._affinity_hits / routed, 4)
            if routed else 0.0,
            "cache_hit_rate": round(
                sum(r.stats.cache_hit_tokens for r in self.replicas)
                / lookups, 4) if lookups else 0.0,
            "preemptions": sum(r.stats.preemptions for r in self.replicas),
            "kv_spilled_pages": sum(
                r.stats.spilled_pages for r in self.replicas),
            "kv_restored_pages": sum(
                r.stats.restored_pages for r in self.replicas),
            "spill_tier_hit_rate": round(
                sum(r.stats.spill_hits for r in self.replicas)
                / max(sum(r.stats.spill_lookups
                          for r in self.replicas), 1), 4),
            "degradation_tier_entries": sum(
                r.ctrl.tier_entries for r in self.replicas),
            "steps": sum(r.stats.steps for r in self.replicas),
            "empty_steps": sum(r.stats.empty_steps for r in self.replicas),
            "window_launches": sum(
                r.stats.window_launches for r in self.replicas),
            "routed_per_replica": list(self._routed),
        }
