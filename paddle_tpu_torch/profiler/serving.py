"""Serving-side profiling: per-step timing + scheduler counters
(counterpart of paddle_tpu/profiler/serving.py, copied).

What matters for serving performance is not one op's latency but the
shape of the whole stream: per-token latency percentiles, how full the
decode batch ran, how often the page pool forced a preemption.
``ServingStats`` aggregates exactly that; the engine additionally brackets
each step in ``torch.profiler.record_function`` so engine steps land in a
profiler trace next to the device kernels.

A server that stays up for days must not let its stats surface grow with
traffic: every distribution (per-token latency, TTFT, batch occupancy,
prefill queue depth) lives in a bounded RESERVOIR -- counters and sums are
exact, percentiles are computed on demand from a uniform sample of fixed
size (Vitter's Algorithm R, deterministic replacement) -- so memory is
O(reservoir) no matter how many requests pass through.
``ServingStats.snapshot()`` is the one read surface.  Reservoir mutation
and sampling take a tiny per-reservoir lock, so another thread can
snapshot while the engine thread records.
"""
from __future__ import annotations

import bisect
import random
import threading
import time

__all__ = ["ServingStats"]


def _percentile(sorted_vals, q: float) -> float:
    """Nearest-rank percentile over an already-sorted list."""
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1,
              max(0, int(round(q / 100.0 * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


class _Reservoir:
    """Bounded uniform sample of a value stream (Vitter's Algorithm R).

    The first ``capacity`` values are kept verbatim (small runs — every
    test and bench below capacity — get EXACT percentiles); after that
    each new value replaces a uniformly-chosen slot with probability
    capacity/n, keeping the sample uniform over the whole stream.  The
    RNG is seeded per reservoir, so a rerun of the same stream reproduces
    the same sample.  count/total/vmin/vmax stay exact regardless.
    """

    __slots__ = ("capacity", "count", "total", "vmin", "vmax",
                 "_sample", "_rng", "_lock")

    def __init__(self, capacity: int = 2048, seed: int = 0):
        self.capacity = int(capacity)
        self._rng = random.Random(0x5EED ^ seed)
        self._lock = threading.Lock()
        self.count = 0
        self.total = 0.0
        self.vmin = 0.0
        self.vmax = 0.0
        self._sample = []

    def add(self, value: float) -> None:
        v = float(value)
        with self._lock:
            if self.count == 0:
                self.vmin = self.vmax = v
            else:
                self.vmin = min(self.vmin, v)
                self.vmax = max(self.vmax, v)
            self.count += 1
            self.total += v
            if len(self._sample) < self.capacity:
                self._sample.append(v)
            else:
                j = self._rng.randrange(self.count)
                if j < self.capacity:
                    self._sample[j] = v

    def extend(self, value: float, n: int) -> None:
        for _ in range(int(n)):
            self.add(value)

    def percentile(self, q: float) -> float:
        with self._lock:
            vals = sorted(self._sample)
        return _percentile(vals, q)

    def samples(self) -> list:
        """Copy of the current sample — the fleet aggregator pools these
        across replicas and recomputes percentiles over the union."""
        with self._lock:
            return list(self._sample)

    def mean(self) -> float:
        with self._lock:
            return self.total / self.count if self.count else 0.0

    def __len__(self) -> int:
        with self._lock:
            return self.count


# Prometheus-style latency bucket bounds in SECONDS — one shared ladder
# for TTFT/ITL/step-duration so fleet aggregation can sum bucket counts
# replica-by-replica (cumulative counts with identical bounds add).
_HIST_BOUNDS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


class _Hist:
    """Fixed-bound latency histogram (exact counts, unlike the
    reservoirs): per-bucket tallies plus total sum/count, rendered on
    ``/metrics`` as a real Prometheus histogram series (``_bucket{le=}``
    cumulative counts + ``_sum`` + ``_count``) next to the quantile
    gauges.  ``le`` is inclusive, matching Prometheus semantics."""

    __slots__ = ("bounds", "_counts", "total", "count", "_lock")

    def __init__(self, bounds=_HIST_BOUNDS):
        self.bounds = tuple(float(b) for b in bounds)
        self._counts = [0] * (len(self.bounds) + 1)   # last = +Inf
        self.total = 0.0
        self.count = 0
        self._lock = threading.Lock()

    def add(self, value: float, n: int = 1) -> None:
        v = float(value)
        n = int(n)
        i = bisect.bisect_left(self.bounds, v)   # v <= bounds[i] -> bucket i
        with self._lock:
            self._counts[i] += n
            self.count += n
            self.total += v * n

    def buckets(self) -> dict:
        """Cumulative counts keyed by upper bound ("0.005" ... "+Inf")."""
        with self._lock:
            counts = list(self._counts)
        out: dict = {}
        c = 0
        for b, n in zip(self.bounds, counts):
            c += n
            out[f"{b:g}"] = c
        out["+Inf"] = c + counts[-1]
        return out


class ServingStats:
    """Aggregates one serving run's step timings and scheduler events.

    Times arrive from the engine as wall-clock seconds per STEP together
    with how many sequences' tokens that step produced; per-token latency
    is the step duration each of those tokens observed (every sequence in
    a batched step waits for the whole step) — the stream's inter-token
    latency (ITL).  TTFT is recorded per request at its first emitted
    token.  All distributions are reservoir-bounded; ``snapshot()``
    (aliased ``summary()``) is the canonical read surface.
    """

    RESERVOIR = 2048

    def __init__(self, reservoir: int = RESERVOIR):
        self._reservoir = int(reservoir)
        self.reset()

    def reset(self):
        r = self._reservoir
        self.prefill_steps = 0
        self.prefill_tokens = 0          # prompt tokens processed
        self.prefill_time = 0.0
        self.decode_steps = 0
        self.decode_tokens = 0           # tokens emitted by decode steps
        self.decode_time = 0.0
        self._token_lat = _Reservoir(r, seed=1)   # ITL: per-token step dur
        self._occupancy = _Reservoir(r, seed=2)   # running/max per decode
        self.preemptions = 0
        self.admitted = 0
        self.retired = 0
        # prefix-cache + chunked-prefill surface
        self.cache_hit_tokens = 0        # prompt tokens served from cache
        self.cache_miss_tokens = 0       # prompt tokens prefilled fresh
        self.cow_copies = 0              # copy-on-write page copies
        self.cache_evictions = 0         # cached pages reclaimed under pressure
        self._prefill_queue = _Reservoir(r, seed=3)  # pending-prefill depth
        self._ttft = _Reservoir(r, seed=4)   # arrival -> first token (s)
        # speculative decoding surface
        self.verify_steps = 0            # verify program launches
        self.verify_tokens = 0           # tokens emitted by verify steps
        self.verify_time = 0.0
        self.spec_rounds = 0             # (sequence, verify) acceptance rounds
        self.draft_proposed = 0          # draft tokens sent to verify
        self.draft_accepted = 0          # draft tokens that survived (hits)
        self.spec_emitted_tokens = 0     # tokens emitted by verify steps
        self.rollback_tokens = 0         # draft tokens rolled back
        self.rollback_pages = 0          # pages released by truncate
        self.spec_disables = 0           # requests whose speculation tripped off
        # request-lifecycle surface: the HTTP frontend
        self.aborts = 0                  # aborted before finishing (any reason)
        self.abort_reasons: dict = {}    # finish_reason -> count
        self.abort_noops = 0             # aborts of finished/unknown rids
        # fault-tolerance surface: recovery/quarantine/degradation
        self.engine_restarts = 0         # supervised engine rebuilds
        self.quarantined = 0             # sequences retired for NaN logits
        self.fault_injections: dict = {} # injected fault kind -> count
        self.degradation_state = 0       # current pressure tier (gauge)
        self.degradation_transitions = 0 # tier changes (counter)
        self.parked_evictions = 0        # pages evicted by tier-3 pressure
        # kernel-autotuning surface: per-kernel tuning-cache
        # lookup outcomes at engine build (dict-of-int — aggregate()
        # merges dict values by int addition)
        self.tuning_hits: dict = {}      # kernel -> cache-hit lookups
        self.tuning_misses: dict = {}    # kernel -> default/env fallbacks
        # observability surface: exact-count histograms beside
        # the reservoir quantiles, and whole-step wall-clock accounting
        self._ttft_hist = _Hist()
        self._itl_hist = _Hist()
        self._step_hist = _Hist()
        self.engine_steps = 0            # LLMEngine.step launch cycles
        self.step_time = 0.0
        # async-pipeline surface: each launch cycle's wall time
        # split into the host dispatch section (pack/stage/enqueue) vs
        # the completion block (waiting on device results) — under
        # overlap the block shrinks toward zero while dispatch stays
        self.dispatch_time = 0.0
        self.block_time = 0.0
        self._dispatch_lat = _Reservoir(r, seed=5)
        self._block_lat = _Reservoir(r, seed=6)
        # device-resident decode-window surface: how often the
        # host actually blocked on the device, and how many tokens each
        # block drained — the round-trip amortization the K-step window
        # exists to buy.  decode_window_k is a gauge (the largest window
        # this engine ran); fallbacks count windows the page pool
        # couldn't cover that ran per-step instead
        self.host_round_trips = 0
        self.decode_rounds = 0           # per-row decode positions advanced
        self.decode_window_k = 1
        self.decode_window_fallbacks = 0
        # windows that ran device-resident but at a SHRUNK K' < K
        # because the pool could only pre-reserve K' tokens of slack
        self.decode_window_shrinks = 0
        # weight residency: engine-build-time gauges, so they
        # SURVIVE reset like _windows — benches reset between passes
        # without rebuilding the engine, and the pools don't move
        self.weight_dtype = getattr(self, "weight_dtype", "float32")
        self.weight_bytes_resident = getattr(
            self, "weight_bytes_resident", 0)
        self.weight_bytes_resident_per_shard = getattr(
            self, "weight_bytes_resident_per_shard", 0)
        # hierarchical-KV spill tier: counters for pages crossing
        # the HBM<->host boundary plus tier gauges the engine pushes at
        # each step-boundary drain.  The gauges SURVIVE reset like the
        # weight gauges — benches reset between passes and the attached
        # tier object (with its cumulative consult counters) doesn't move
        self.kv_pages_spilled = 0        # pages stored into the host tier
        self.kv_pages_restored = 0       # pages restored back into HBM
        self.kv_spill_dropped = 0        # quarantined pages the tier refused
        self.kv_prefetch_hit_pages = 0   # restored pages admission hits used
        self.spill_tier_hits = getattr(self, "spill_tier_hits", 0)
        self.spill_tier_misses = getattr(self, "spill_tier_misses", 0)
        self.host_kv_bytes_resident = getattr(
            self, "host_kv_bytes_resident", 0)
        self.host_kv_bytes_capacity = getattr(
            self, "host_kv_bytes_capacity", 0)
        # SLO-observatory surface: queue wait (arrival ->
        # admission) joins the lifetime reservoirs, and an OPT-IN
        # windowed layer (profiler/slo.py) rides beside them — None
        # means every record path below pays one attribute check and
        # never executes a line of slo.py (pinned by tracemalloc test)
        self._queue_wait = _Reservoir(r, seed=7)
        # enablement SURVIVES reset (benches reset between passes, the
        # runner resets nothing but shares stats across rebuilds): the
        # rings are rolling, stale samples age out on their own
        self._windows = getattr(self, "_windows", None)
        self._t_start = time.monotonic() # process-lifetime uptime anchor

    def enable_windows(self, slo=None, *, windows=(10.0, 60.0, 300.0),
                       tracer=None, clock=None):
        """Attach the windowed-telemetry layer (rolling TTFT/ITL/step/
        queue-wait/accept-rate windows + SLO burn-rate state -- see
        profiler/slo.py).  Idempotent: the first call builds it from
        ``slo`` (an SLOConfig or None for defaults); later calls return
        the existing layer so engine and frontend can both ask for it."""
        if self._windows is None:
            from .slo import WindowedTelemetry
            kw = {} if clock is None else {"clock": clock}
            self._windows = WindowedTelemetry(slo, windows=windows,
                                              tracer=tracer, **kw)
        return self._windows

    @property
    def windows(self):
        """The windowed-telemetry layer, or None when never enabled."""
        return self._windows

    # -- recording (engine-facing) ------------------------------------------

    def record_prefill(self, duration_s: float, n_prompt_tokens: int,
                       n_seqs: int) -> None:
        self.prefill_steps += 1
        self.prefill_tokens += int(n_prompt_tokens)
        self.prefill_time += float(duration_s)
        # each sequence's first token comes out of the prefill step
        self._token_lat.extend(float(duration_s), int(n_seqs))
        self._itl_hist.add(float(duration_s), int(n_seqs))
        w = self._windows
        if w is not None and n_seqs:
            w.record_itl(float(duration_s), int(n_seqs))

    def record_decode(self, duration_s: float, n_tokens: int,
                      occupancy: float, rounds: int = 1) -> None:
        """``rounds`` is how many per-row decode POSITIONS this launch
        advanced: 1 for a per-step launch (however wide its batch), the
        iteration count for a K-step window drain.  host_round_trips /
        decode_rounds is the sync count on one request's critical path
        — ~1.0 per-step, falling toward 1/K with the window engaged."""
        self.decode_steps += 1
        self.decode_rounds += int(rounds)
        self.decode_tokens += int(n_tokens)
        self.decode_time += float(duration_s)
        self._token_lat.extend(float(duration_s), int(n_tokens))
        self._itl_hist.add(float(duration_s), int(n_tokens))
        self._occupancy.add(float(occupancy))
        w = self._windows
        if w is not None and n_tokens:
            w.record_itl(float(duration_s), int(n_tokens))

    def record_step(self, duration_s: float, dispatch_s: float = 0.0,
                    block_s: float = 0.0) -> None:
        """One launch cycle's wall-clock duration — the whole
        pack/stage/launch/sync section regardless of phase mix.

        ``dispatch_s``/``block_s`` split that duration into the host
        dispatch section (admit/schedule/pack/stage/enqueue, which the
        async engine runs while the previous launch is still on-device)
        and the completion block (materializing device results).  A
        caller that can't attribute the split leaves both at 0; the
        fused total stays authoritative either way."""
        d = float(duration_s)
        self.engine_steps += 1
        self.step_time += d
        self._step_hist.add(d)
        self.dispatch_time += float(dispatch_s)
        self.block_time += float(block_s)
        self._dispatch_lat.add(float(dispatch_s))
        self._block_lat.add(float(block_s))
        w = self._windows
        if w is not None:
            w.record_step(d)

    def record_round_trip(self, n: int = 1) -> None:
        """One host<->device completion block: the host materialized a
        launch's results.  Per-step decode pays one per token; a K-step
        window pays one per K tokens."""
        self.host_round_trips += int(n)

    def set_decode_window(self, k: int) -> None:
        """Largest decode window this engine ran (gauge, monotone)."""
        self.decode_window_k = max(self.decode_window_k, int(k))

    def record_window_fallback(self, n: int = 1) -> None:
        """One eligible decode window that fell back to the per-step
        path because the pool couldn't pre-reserve K tokens of slack."""
        self.decode_window_fallbacks += int(n)

    def record_window_shrink(self, n: int = 1) -> None:
        """One eligible decode window that ran device-resident at a
        shrunk K' < decode_window (the pool covered K' tokens of slack
        but not K) instead of falling back to per-step."""
        self.decode_window_shrinks += int(n)

    def set_weight_residency(self, dtype: str, total_bytes: int,
                             per_shard_bytes: int | None = None) -> None:
        """Engine-build gauges: the weight pools' storage dtype and
        resident bytes (mesh-wide total and the largest single shard —
        equal at tp=1)."""
        self.weight_dtype = str(dtype)
        self.weight_bytes_resident = int(total_bytes)
        self.weight_bytes_resident_per_shard = int(
            total_bytes if per_shard_bytes is None else per_shard_bytes)

    def record_admission(self, n: int = 1) -> None:
        self.admitted += int(n)

    def record_retirement(self, n: int = 1) -> None:
        self.retired += int(n)

    def record_preemption(self, n: int = 1) -> None:
        self.preemptions += int(n)

    def record_abort(self, reason: str = "aborted") -> None:
        """One request retired before finishing (client disconnect,
        deadline, shutdown drain, explicit cancel)."""
        self.aborts += 1
        self.abort_reasons[reason] = self.abort_reasons.get(reason, 0) + 1

    def record_cache_lookup(self, hit_tokens: int, miss_tokens: int) -> None:
        """One admission's prefix-cache match: how many prompt tokens the
        cache already held vs how many must be prefilled."""
        self.cache_hit_tokens += int(hit_tokens)
        self.cache_miss_tokens += int(miss_tokens)

    def record_cow(self, n: int = 1) -> None:
        self.cow_copies += int(n)

    def record_evictions(self, n: int = 1) -> None:
        self.cache_evictions += int(n)

    def record_prefill_queue(self, depth: int) -> None:
        """Requests (running or waiting) with prompt tokens still to
        prefill at this step — the chunked-prefill backlog."""
        self._prefill_queue.add(int(depth))

    def record_ttft(self, duration_s: float) -> None:
        self._ttft.add(float(duration_s))
        self._ttft_hist.add(float(duration_s))
        w = self._windows
        if w is not None:
            w.record_ttft(float(duration_s))

    def record_queue_wait(self, duration_s: float) -> None:
        """Seconds one request sat queued between arrival and engine
        admission — the scheduler-pressure signal the future SLO-aware
        admission predictor consumes."""
        self._queue_wait.add(float(duration_s))
        w = self._windows
        if w is not None:
            w.record_queue_wait(float(duration_s))

    def record_request_latency(self, duration_s: float) -> None:
        """One finished request's arrival-to-last-token latency; feeds
        the windowed slow-request anomaly detector (windowed layer
        only — lifetime latency already decomposes into TTFT + ITL)."""
        w = self._windows
        if w is not None:
            w.record_request(float(duration_s))

    def record_deadline(self, met: bool) -> None:
        """One deadline-bearing request finished: did it beat its
        deadline?  (Windowed layer only; recorded by the runner.)"""
        w = self._windows
        if w is not None:
            w.record_deadline(bool(met))

    def record_finish_quality(self, ok: bool) -> None:
        """One finished request, natural (True) or errored (False) —
        the availability objective's windowed sample."""
        w = self._windows
        if w is not None:
            w.record_finish(bool(ok))

    def record_verify(self, duration_s: float, n_tokens: int,
                      occupancy: float) -> None:
        """One verify-program launch that emitted n_tokens across its
        speculative sequences.  Verify output stays in its OWN channel:
        folding it into decode_tokens/decode_time (as this method once
        did) made the on/off "speedup" ratio compare verify throughput
        against decode throughput of a different token mix — a
        bookkeeping artifact, not a measurement.  Cross-phase
        comparisons use wall-clock emitted tok/s per phase instead.
        The tokens still feed the stream-wide ITL reservoir (they are
        real emitted tokens and each observed this step's latency)."""
        self.verify_steps += 1
        self.verify_time += float(duration_s)
        self.verify_tokens += int(n_tokens)
        self._token_lat.extend(float(duration_s), int(n_tokens))
        self._itl_hist.add(float(duration_s), int(n_tokens))
        self._occupancy.add(float(occupancy))
        w = self._windows
        if w is not None and n_tokens:
            w.record_itl(float(duration_s), int(n_tokens))

    def record_spec(self, *, proposed: int, accepted: int, emitted: int,
                    rollback: int, pages_rolled: int = 0) -> None:
        """One sequence's acceptance round inside a verify step."""
        self.spec_rounds += 1
        self.draft_proposed += int(proposed)
        self.draft_accepted += int(accepted)
        self.spec_emitted_tokens += int(emitted)
        self.rollback_tokens += int(rollback)
        self.rollback_pages += int(pages_rolled)
        w = self._windows
        if w is not None and proposed:
            w.record_accept(int(accepted), int(proposed))

    def record_spec_disable(self, n: int = 1) -> None:
        self.spec_disables += int(n)

    def record_abort_noop(self, n: int = 1) -> None:
        """Abort of an unknown/already-finished request id — benign
        (an abort racing natural retirement), but counted so a frontend
        bug that aborts wildly is visible."""
        self.abort_noops += int(n)

    def record_restart(self, n: int = 1) -> None:
        """One supervised engine rebuild (crash or hung-step watchdog)."""
        self.engine_restarts += int(n)

    def record_quarantine(self, n: int = 1) -> None:
        """One sequence retired with finish_reason='numerical_error'."""
        self.quarantined += int(n)

    def record_fault(self, kind: str, n: int = 1) -> None:
        """One injected fault fired (kind: crash/slow/nan/pool/conn)."""
        self.fault_injections[kind] = \
            self.fault_injections.get(kind, 0) + int(n)

    def set_degradation_state(self, state: int) -> None:
        """Current pressure tier; transitions are counted."""
        state = int(state)
        if state != self.degradation_state:
            self.degradation_transitions += 1
            self.degradation_state = state

    def record_parked_evictions(self, n: int = 1) -> None:
        self.parked_evictions += int(n)

    def record_kv_spill(self, quarantined: int, stored: int) -> None:
        """One step-boundary spill drain: ``quarantined`` pages left the
        HBM pool, ``stored`` of them landed in the host tier (the rest
        were counted drops — tier full of bigger pages, or disabled)."""
        self.kv_pages_spilled += int(stored)
        self.kv_spill_dropped += int(quarantined) - int(stored)

    def record_kv_restore(self, n: int = 1) -> None:
        """Pages restored from the host tier into free HBM blocks and
        re-registered in the prefix cache."""
        self.kv_pages_restored += int(n)

    def record_prefetch_hits(self, n_pages: int = 1) -> None:
        """Restored pages a later admission's prefix-cache hit actually
        used (attributed by chain hash) — the tier's payoff counter."""
        self.kv_prefetch_hit_pages += int(n_pages)

    def set_spill_tier(self, tier_stats: dict) -> None:
        """Absorb the attached HostSpillPool's gauge snapshot (its
        ``stats()`` dict): cumulative consult hits/misses and resident/
        capacity bytes.  Pushed by the engine after every drain."""
        self.spill_tier_hits = int(tier_stats.get("hits", 0))
        self.spill_tier_misses = int(tier_stats.get("misses", 0))
        self.host_kv_bytes_resident = int(
            tier_stats.get("bytes_resident", 0))
        self.host_kv_bytes_capacity = int(
            tier_stats.get("capacity_bytes", 0))

    def record_tuning(self, kernel: str, hit: bool) -> None:
        """One tuning-cache lookup for a kernel's launch geometry (the
        engine resolves each registered kernel once at build)."""
        slot = self.tuning_hits if hit else self.tuning_misses
        slot[kernel] = slot.get(kernel, 0) + 1

    def uptime_seconds(self) -> float:
        """Seconds since these stats were created/reset.  The runner
        carries one ServingStats across engine rebuilds, so this is the
        SERVICE uptime, not the current engine's."""
        return time.monotonic() - self._t_start

    # -- derived metrics ----------------------------------------------------

    def decode_tokens_per_s(self) -> float:
        return self.decode_tokens / self.decode_time if self.decode_time \
            else 0.0

    def verify_tokens_per_s(self) -> float:
        return self.verify_tokens / self.verify_time if self.verify_time \
            else 0.0

    def prefill_tokens_per_s(self) -> float:
        return self.prefill_tokens / self.prefill_time \
            if self.prefill_time else 0.0

    def emitted_tokens_per_s(self) -> float:
        """Wall-clock emitted throughput across decode AND verify — the
        honest cross-phase number for spec on/off comparisons."""
        t = self.decode_time + self.verify_time
        return (self.decode_tokens + self.verify_tokens) / t if t else 0.0

    def tokens_per_launch(self) -> float:
        """Emitted tokens (decode + verify) per host round-trip — 1.0
        for the per-step engine, approaching K with the decode window
        engaged (prefill round-trips emit via TTFT, not here, so a
        prefill-heavy stream honestly drags this below 1)."""
        return (self.decode_tokens + self.verify_tokens) \
            / self.host_round_trips if self.host_round_trips else 0.0

    def token_latency_ms(self, q: float) -> float:
        return 1e3 * self._token_lat.percentile(q)

    def mean_occupancy(self) -> float:
        return self._occupancy.mean()

    def prefix_hit_rate(self) -> float:
        total = self.cache_hit_tokens + self.cache_miss_tokens
        return self.cache_hit_tokens / total if total else 0.0

    def ttft_ms(self, q: float) -> float:
        return 1e3 * self._ttft.percentile(q)

    def accept_rate(self) -> float:
        return self.draft_accepted / self.draft_proposed \
            if self.draft_proposed else 0.0

    def spill_tier_hit_rate(self) -> float:
        """Fraction of spill-tier consults (admission chain walks +
        router prefetch hints) that found a resident page."""
        total = self.spill_tier_hits + self.spill_tier_misses
        return self.spill_tier_hits / total if total else 0.0

    def snapshot(self, include_samples: bool = False) -> dict:
        """Point-in-time view of every counter and on-demand percentile.
        The ONE read surface: the frontend's ``/metrics`` endpoint and
        serve_bench both render this dict.  Safe to call from a thread
        other than the recording one (reservoirs lock internally;
        counters are plain ints read atomically under the GIL).

        ``include_samples=True`` additionally attaches the raw latency
        reservoir samples under ``"_samples"`` so ``aggregate()`` can
        recompute fleet percentiles over the pooled union instead of
        falling back to the worst replica's quantile.  The key is
        underscore-prefixed and stripped by the metrics renderer."""
        out = {
            "prefill_steps": self.prefill_steps,
            "prefill_tokens": self.prefill_tokens,
            "decode_steps": self.decode_steps,
            "decode_tokens": self.decode_tokens,
            "decode_tokens_per_s": round(self.decode_tokens_per_s(), 2),
            "prefill_tokens_per_s": round(self.prefill_tokens_per_s(), 2),
            "verify_tokens": self.verify_tokens,
            "verify_tokens_per_s": round(self.verify_tokens_per_s(), 2),
            "emitted_tokens_per_s": round(self.emitted_tokens_per_s(), 2),
            "p50_token_ms": round(self.token_latency_ms(50), 3),
            "p99_token_ms": round(self.token_latency_ms(99), 3),
            "itl_p50_ms": round(self.token_latency_ms(50), 3),
            "itl_p99_ms": round(self.token_latency_ms(99), 3),
            "mean_batch_occupancy": round(self.mean_occupancy(), 4),
            "admitted": self.admitted,
            "retired": self.retired,
            "preemptions": self.preemptions,
            "aborts": self.aborts,
            "abort_reasons": dict(self.abort_reasons),
            "cache_hit_tokens": self.cache_hit_tokens,
            "cache_miss_tokens": self.cache_miss_tokens,
            "prefix_hit_rate": round(self.prefix_hit_rate(), 4),
            "prefill_tokens_saved": self.cache_hit_tokens,
            "cow_copies": self.cow_copies,
            "cache_evictions": self.cache_evictions,
            "mean_prefill_queue_depth": round(self._prefill_queue.mean(), 3),
            "max_prefill_queue_depth": int(self._prefill_queue.vmax),
            "ttft_p50_ms": round(self.ttft_ms(50), 3),
            "ttft_p99_ms": round(self.ttft_ms(99), 3),
            "verify_steps": self.verify_steps,
            "spec_rounds": self.spec_rounds,
            "draft_proposed": self.draft_proposed,
            "draft_accepted": self.draft_accepted,
            "accept_rate": round(self.accept_rate(), 4),
            "spec_emitted_tokens": self.spec_emitted_tokens,
            "rollback_tokens": self.rollback_tokens,
            "rollback_pages": self.rollback_pages,
            "spec_disables": self.spec_disables,
            "abort_noops": self.abort_noops,
            "engine_restarts": self.engine_restarts,
            "uptime_seconds": round(self.uptime_seconds(), 3),
            "quarantined": self.quarantined,
            "fault_injections": dict(self.fault_injections),
            "faults_injected_total": sum(self.fault_injections.values()),
            "degradation_state": self.degradation_state,
            "degradation_transitions": self.degradation_transitions,
            "parked_evictions": self.parked_evictions,
            "tuning_cache_hits": dict(self.tuning_hits),
            "tuning_cache_misses": dict(self.tuning_misses),
            "host_round_trips": self.host_round_trips,
            "decode_rounds": self.decode_rounds,
            "tokens_per_launch": round(self.tokens_per_launch(), 3),
            "decode_window_k": self.decode_window_k,
            "decode_window_fallbacks": self.decode_window_fallbacks,
            "decode_window_shrinks": self.decode_window_shrinks,
            "weight_dtype": self.weight_dtype,
            "weight_bytes_resident": self.weight_bytes_resident,
            "weight_bytes_resident_per_shard":
                self.weight_bytes_resident_per_shard,
            "kv_pages_spilled": self.kv_pages_spilled,
            "kv_pages_restored": self.kv_pages_restored,
            "kv_spill_dropped": self.kv_spill_dropped,
            "kv_prefetch_hit_pages": self.kv_prefetch_hit_pages,
            "spill_tier_hits": self.spill_tier_hits,
            "spill_tier_misses": self.spill_tier_misses,
            "spill_tier_hit_rate": round(self.spill_tier_hit_rate(), 4),
            "host_kv_bytes_resident": self.host_kv_bytes_resident,
            "host_kv_bytes_capacity": self.host_kv_bytes_capacity,
            "engine_steps": self.engine_steps,
            "step_time_s": round(self.step_time, 6),
            "dispatch_time_s": round(self.dispatch_time, 6),
            "block_time_s": round(self.block_time, 6),
            "dispatch_ms_p50": round(1e3 * self._dispatch_lat.percentile(50), 3),
            "dispatch_ms_p99": round(1e3 * self._dispatch_lat.percentile(99), 3),
            "block_ms_p50": round(1e3 * self._block_lat.percentile(50), 3),
            "block_ms_p99": round(1e3 * self._block_lat.percentile(99), 3),
            "ttft_hist_buckets": self._ttft_hist.buckets(),
            "ttft_hist_sum": self._ttft_hist.total,
            "ttft_hist_count": self._ttft_hist.count,
            "itl_hist_buckets": self._itl_hist.buckets(),
            "itl_hist_sum": self._itl_hist.total,
            "itl_hist_count": self._itl_hist.count,
            "step_hist_buckets": self._step_hist.buckets(),
            "step_hist_sum": self._step_hist.total,
            "step_hist_count": self._step_hist.count,
            "queue_wait_p50_ms": round(
                1e3 * self._queue_wait.percentile(50), 3),
            "queue_wait_p99_ms": round(
                1e3 * self._queue_wait.percentile(99), 3),
        }
        if self._windows is not None:
            out.update(self._windows.snapshot_keys())
        if include_samples:
            out["_samples"] = {"token_lat": self._token_lat.samples(),
                               "ttft": self._ttft.samples()}
        return out

    # summary() predates snapshot() and is the name the engine/benches
    # grew up with; both return the same dict
    summary = snapshot

    # ------------------------------------------------------------------
    # fleet aggregation
    # ------------------------------------------------------------------

    # snapshot keys that are NOT plain summable counters, by how a
    # D-replica fleet combines them:
    #   _RATE     recomputed from the summed numerator/denominator —
    #             summing or averaging ratios of unequal denominators
    #             would misweight replicas
    #   _THROUGH  summed: replicas run in parallel, fleet tokens/s is
    #             the sum of per-replica tokens/s
    #   _MAX      worst replica wins — the FALLBACK for latency
    #             percentiles when snapshots carry no reservoir samples
    #             (when every snapshot was taken with
    #             include_samples=True the percentiles are instead
    #             recomputed over the pooled sample union — honest
    #             fleet quantiles, not a max-of-quantiles bound);
    #             degradation_state and uptime always describe the
    #             worst/oldest member
    #   _MEAN     unweighted mean across replicas (occupancy/queue depth
    #             are already per-engine means)
    _RATE = ("prefix_hit_rate", "accept_rate", "tokens_per_launch",
             "spill_tier_hit_rate")
    _THROUGH = ("decode_tokens_per_s", "prefill_tokens_per_s",
                "verify_tokens_per_s", "emitted_tokens_per_s")
    _MAX = ("p50_token_ms", "p99_token_ms", "itl_p50_ms", "itl_p99_ms",
            "ttft_p50_ms", "ttft_p99_ms", "max_prefill_queue_depth",
            "uptime_seconds", "degradation_state", "decode_window_k",
            "dispatch_ms_p50", "dispatch_ms_p99",
            "block_ms_p50", "block_ms_p99",
            "queue_wait_p50_ms", "queue_wait_p99_ms",
            "weight_bytes_resident_per_shard")
    _MEAN = ("mean_batch_occupancy", "mean_prefill_queue_depth")
    # windowed-telemetry keys (present only when enable_windows() ran)
    # are pooled structurally after the generic pass: bucket counts sum
    # per window index across replicas (identical ladders), windowed
    # percentiles and burn rates recompute from the POOLED distribution,
    # and the fleet SLO state is the worst replica's (a page anywhere
    # pages the fleet)
    _WINDOWED = ("windows", "slo", "slo_state", "slo_state_name",
                 "ttft_p95_w60s", "itl_p99_w60s", "queue_wait_p95_w60s",
                 "anomalies_detected", "anomalies_captured",
                 "anomaly_spool_dropped")

    @staticmethod
    def aggregate(snapshots) -> dict:
        """Combine per-replica ``snapshot()`` dicts into one fleet view
        (the dict a replicated frontend's ``/metrics`` renders).  Plain
        counters sum; see the class-level key tables for everything
        else.  A single snapshot passes through semantically unchanged
        (max == mean == sum-of-one)."""
        snaps = list(snapshots)
        if not snaps:
            raise ValueError("aggregate() needs at least one snapshot")
        out: dict = {}
        for key in snaps[0]:
            if key == "_samples" or key in ServingStats._WINDOWED:
                continue                         # pooled below, never summed
            vals = [s[key] for s in snaps]
            if isinstance(vals[0], dict):        # abort_reasons, fault_injections
                merged: dict = {}
                for v in vals:
                    for k, n in v.items():
                        merged[k] = merged.get(k, 0) + n
                out[key] = merged
            elif isinstance(vals[0], str):       # weight_dtype, ...
                out[key] = vals[0] \
                    if all(v == vals[0] for v in vals) else "mixed"
            elif key in ServingStats._RATE:
                pass                             # recomputed below
            elif key in ServingStats._THROUGH:
                out[key] = round(sum(vals), 2)
            elif key in ServingStats._MAX:
                out[key] = max(vals)
            elif key in ServingStats._MEAN:
                out[key] = round(sum(vals) / len(vals), 4)
            else:
                out[key] = sum(vals)
        hit, miss = out["cache_hit_tokens"], out["cache_miss_tokens"]
        out["prefix_hit_rate"] = round(hit / (hit + miss), 4) \
            if hit + miss else 0.0
        out["accept_rate"] = round(
            out["draft_accepted"] / out["draft_proposed"], 4) \
            if out["draft_proposed"] else 0.0
        trips = out.get("host_round_trips", 0)
        out["tokens_per_launch"] = round(
            (out["decode_tokens"] + out["verify_tokens"]) / trips, 3) \
            if trips else 0.0
        consults = out.get("spill_tier_hits", 0) \
            + out.get("spill_tier_misses", 0)
        out["spill_tier_hit_rate"] = round(
            out["spill_tier_hits"] / consults, 4) if consults else 0.0
        if all("_samples" in s for s in snaps):
            # honest fleet quantiles: pool every replica's reservoir
            # sample and recompute, replacing the max-of-quantiles
            # fallback written by the _MAX pass above
            tok = sorted(v for s in snaps
                         for v in s["_samples"]["token_lat"])
            ttft = sorted(v for s in snaps for v in s["_samples"]["ttft"])
            for q in (50, 99):
                out[f"p{q}_token_ms"] = round(
                    1e3 * _percentile(tok, q), 3)
                out[f"itl_p{q}_ms"] = out[f"p{q}_token_ms"]
                out[f"ttft_p{q}_ms"] = round(
                    1e3 * _percentile(ttft, q), 3)
        windowed = [s for s in snaps if "windows" in s]
        if windowed:
            from .slo import (SLO_STATE_NAMES, aggregate_windows,
                              evaluate_slo)
            ws = aggregate_windows([s["windows"] for s in windowed])
            out["windows"] = ws
            ev = evaluate_slo(windowed[0]["slo"]["config"], ws)
            # worst replica wins over the fleet-level evaluation: one
            # paging replica must not be averaged away by healthy peers
            state = max([ev["state"]]
                        + [s.get("slo_state", 0) for s in windowed])
            ev["state"] = state
            ev["state_name"] = SLO_STATE_NAMES[state]
            out["slo"] = ev
            out["slo_state"] = state
            out["slo_state_name"] = SLO_STATE_NAMES[state]
            mid = sorted((k for k in ws if k != "bounds"),
                         key=lambda s: float(s[:-1]))
            mid = mid[min(1, len(mid) - 1)] if mid else None
            if mid is not None:
                out["ttft_p95_w60s"] = ws[mid]["ttft"]["p95_ms"]
                out["itl_p99_w60s"] = ws[mid]["itl"]["p99_ms"]
                out["queue_wait_p95_w60s"] = \
                    ws[mid]["queue_wait"]["p95_ms"]
            for key in ("anomalies_detected", "anomalies_captured",
                        "anomaly_spool_dropped"):
                out[key] = sum(s.get(key, 0) for s in windowed)
        out["replicas"] = len(snaps)
        return out
