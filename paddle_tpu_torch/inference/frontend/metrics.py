"""Prometheus text exposition for the serving frontend.

One function renders everything a scrape needs: the engine's
``ServingStats.snapshot()`` (latency quantiles, throughput, cache and
speculation counters — reservoir-backed, so snapshotting from the HTTP
thread is cheap and safe), the KV page pool gauges, and the frontend's
own request-lifecycle counters.  Format is the Prometheus text
exposition format v0.0.4: ``# HELP`` / ``# TYPE`` preambles, one sample
per line, labels in ``{}``; quantiles are exported as gauges under the
conventional ``{quantile="0.5"}`` labels (a true summary type needs
+Inf buckets we don't track).
"""
from __future__ import annotations

__all__ = ["render_metrics"]

_PREFIX = "paddle_tpu"


def _esc(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


class _Doc:
    def __init__(self):
        self.lines = []

    def metric(self, name, kind, help_text, samples):
        """samples: iterable of (labels-dict-or-None, value)."""
        full = f"{_PREFIX}_{name}"
        self.lines.append(f"# HELP {full} {help_text}")
        self.lines.append(f"# TYPE {full} {kind}")
        for labels, value in samples:
            if value is None:
                continue
            lbl = ""
            if labels:
                inner = ",".join(f'{k}="{_esc(v)}"'
                                 for k, v in sorted(labels.items()))
                lbl = "{" + inner + "}"
            v = float(value)
            sval = repr(int(v)) if v == int(v) else repr(v)
            self.lines.append(f"{full}{lbl} {sval}")

    def histogram(self, name, help_text, buckets, total, count):
        """One true Prometheus histogram: cumulative ``_bucket{le=}``
        samples (ascending, ending at +Inf) plus ``_sum``/``_count``.
        ``buckets`` is the ``_Hist.buckets()`` dict — already cumulative
        and insertion-ordered by upper bound."""
        full = f"{_PREFIX}_{name}"
        self.lines.append(f"# HELP {full} {help_text}")
        self.lines.append(f"# TYPE {full} histogram")
        for le, n in buckets.items():
            self.lines.append(f'{full}_bucket{{le="{_esc(le)}"}} {int(n)}')
        v = float(total)
        sval = repr(int(v)) if v == int(v) else repr(v)
        self.lines.append(f"{full}_sum {sval}")
        self.lines.append(f"{full}_count {int(count)}")

    def render(self) -> str:
        return "\n".join(self.lines) + "\n"


def render_metrics(snapshot: dict, *, engine=None,
                   frontend: dict | None = None,
                   router: dict | None = None) -> str:
    """Render one /metrics scrape.

    snapshot: ServingStats.snapshot() dict (or the fleet aggregate from
        ``ServingStats.aggregate`` when a router is attached).
    engine: the live LLMEngine for pool/queue gauges (optional so the
        renderer stays unit-testable with a bare snapshot).  Under a
        replica router this is replica 0 — the fleet-wide counters come
        from the aggregated snapshot, the pool gauges are one replica's.
    frontend: the frontend's own counters —
        {"requests_total": {(route, code): n}, "shed_total": n,
         "active_streams": n, "queue_depth": n, "draining": bool}.
    router: ReplicaRouter.router_counters() — per-replica routing gauges
        labeled {replica="i"}; None for a single-runner frontend.
    """
    d = _Doc()
    s = snapshot
    fe = frontend or {}

    # -- request lifecycle ------------------------------------------------
    d.metric("http_requests_total", "counter",
             "HTTP requests served, by route and status code.",
             [({"route": r, "code": str(c)}, n)
              for (r, c), n in sorted(fe.get("requests_total", {}).items())])
    d.metric("requests_admitted_total", "counter",
             "Generation requests admitted into the engine.",
             [(None, s.get("admitted"))])
    d.metric("requests_finished_total", "counter",
             "Generation requests retired by the engine.",
             [(None, s.get("retired"))])
    d.metric("aborts_total", "counter",
             "Generation requests aborted, by reason.",
             [({"reason": r}, n)
              for r, n in sorted((s.get("abort_reasons") or {}).items())]
             or [({"reason": "aborted"}, 0)])
    d.metric("shed_total", "counter",
             "Requests refused with 429 because the admission queue "
             "was full.", [(None, fe.get("shed_total", 0))])
    d.metric("active_streams", "gauge",
             "HTTP connections currently streaming tokens.",
             [(None, fe.get("active_streams", 0))])
    d.metric("queue_depth", "gauge",
             "Requests submitted to the runner and not yet finished.",
             [(None, fe.get("queue_depth", 0))])
    d.metric("draining", "gauge",
             "1 while the server is draining (rejecting new work).",
             [(None, 1 if fe.get("draining") else 0)])

    # -- latency ----------------------------------------------------------
    d.metric("ttft_seconds", "gauge",
             "Time to first token (queue wait included).",
             [({"quantile": "0.5"}, _ms(s.get("ttft_p50_ms"))),
              ({"quantile": "0.99"}, _ms(s.get("ttft_p99_ms")))])
    d.metric("itl_seconds", "gauge",
             "Inter-token latency (per-token decode interval).",
             [({"quantile": "0.5"}, _ms(s.get("itl_p50_ms"))),
              ({"quantile": "0.99"}, _ms(s.get("itl_p99_ms")))])
    d.metric("queue_wait_seconds", "gauge",
             "Admission queue wait (arrival to engine admission).",
             [({"quantile": "0.5"}, _ms(s.get("queue_wait_p50_ms"))),
              ({"quantile": "0.99"}, _ms(s.get("queue_wait_p99_ms")))])
    d.metric("throughput_tokens_per_second", "gauge",
             "Generated-token throughput over the stats window.",
             [(None, s.get("decode_tokens_per_s"))])
    d.metric("generated_tokens_total", "counter",
             "Tokens emitted by the engine.",
             [(None, s.get("decode_tokens"))])

    # -- latency histograms ----------------------------------------------
    # exact-count cumulative-bucket series next to the quantile gauges
    # above: buckets with identical bounds SUM across replicas/scrapes,
    # so these aggregate honestly where max-of-quantile gauges cannot
    for key, name, help_text in (
            ("ttft_hist", "ttft_hist_seconds",
             "Time to first token, as cumulative histogram buckets."),
            ("itl_hist", "itl_hist_seconds",
             "Inter-token latency, as cumulative histogram buckets."),
            ("step_hist", "step_duration_seconds",
             "Engine launch-cycle wall-clock duration, as cumulative "
             "histogram buckets.")):
        buckets = s.get(f"{key}_buckets")
        if buckets:
            d.histogram(name, help_text, buckets,
                        s.get(f"{key}_sum", 0.0), s.get(f"{key}_count", 0))

    # -- windowed telemetry + SLO -----------------------------------------
    # rolling-window quantiles labeled {window=,quantile=} — unlike the
    # lifetime gauges above these answer "how are we doing RIGHT NOW"
    w = s.get("windows")
    if w:
        lat_samples, rate_samples = [], []
        for wl in sorted((k for k in w if k != "bounds"),
                         key=lambda k: float(k[:-1])):
            for ch, st in sorted(w[wl].items()):
                if "p95_ms" in st:
                    for key, q in (("p50_ms", "0.5"), ("p95_ms", "0.95"),
                                   ("p99_ms", "0.99")):
                        lat_samples.append((
                            {"channel": ch, "window": wl, "quantile": q},
                            _ms(st.get(key))))
                elif "rate" in st:
                    rate_samples.append((
                        {"channel": ch, "window": wl}, st.get("rate")))
        d.metric("windowed_latency_seconds", "gauge",
                 "Rolling-window latency quantiles by channel (ttft, "
                 "itl, step, queue_wait, request).", lat_samples)
        d.metric("windowed_rate", "gauge",
                 "Rolling-window rates by channel (accept, deadline, "
                 "availability).", rate_samples)
        d.metric("slo_state", "gauge",
                 "SLO burn-rate state: 0 normal, 1 warn, 2 page.",
                 [(None, s.get("slo_state"))])
        burns = (s.get("slo") or {}).get("burn_rates") or {}
        d.metric("slo_burn_rate", "gauge",
                 "Error-budget burn rate per objective and window "
                 "(1.0 = consuming exactly the budget).",
                 [({"objective": obj, "window": wl}, v)
                  for wl, objs in sorted(burns.items())
                  for obj, v in sorted(objs.items()) if obj != "max"])
        d.metric("anomalies_detected_total", "counter",
                 "Slow-step/slow-request outliers flagged by the MAD "
                 "detector.", [(None, s.get("anomalies_detected"))])
        d.metric("anomalies_captured_total", "counter",
                 "Anomaly trace snapshots written to the spool.",
                 [(None, s.get("anomalies_captured"))])
        d.metric("anomaly_spool_dropped_total", "counter",
                 "Anomaly snapshots dropped by the spool bound.",
                 [(None, s.get("anomaly_spool_dropped"))])

    # -- async step pipeline ---------------------------------------------
    # each launch cycle split into the host dispatch section vs the
    # completion block on device results (overlap hides the latter)
    d.metric("step_dispatch_seconds_total", "counter",
             "Cumulative host dispatch time (pack/stage/launch enqueue).",
             [(None, s.get("dispatch_time_s"))])
    d.metric("step_block_seconds_total", "counter",
             "Cumulative completion-block time (waiting on device "
             "results).", [(None, s.get("block_time_s"))])
    d.metric("step_dispatch_seconds", "gauge",
             "Per-step host dispatch duration.",
             [({"quantile": "0.5"}, _ms(s.get("dispatch_ms_p50"))),
              ({"quantile": "0.99"}, _ms(s.get("dispatch_ms_p99")))])
    d.metric("step_block_seconds", "gauge",
             "Per-step completion-block duration.",
             [({"quantile": "0.5"}, _ms(s.get("block_ms_p50"))),
              ({"quantile": "0.99"}, _ms(s.get("block_ms_p99")))])

    # -- device-resident decode window ------------------------------------
    # how often the host blocked on the device, and how many emitted
    # tokens each block drained (1.0 per-step; -> K with the window on)
    d.metric("host_round_trips_total", "counter",
             "Host<->device completion blocks (one per launch drained).",
             [(None, s.get("host_round_trips"))])
    d.metric("tokens_per_launch", "gauge",
             "Emitted tokens (decode+verify) per host round-trip.",
             [(None, s.get("tokens_per_launch"))])
    d.metric("decode_window_k", "gauge",
             "Largest on-device decode window this engine ran (1 = "
             "per-step).", [(None, s.get("decode_window_k"))])
    d.metric("decode_window_fallbacks_total", "counter",
             "Eligible decode windows that ran per-step because the "
             "page pool could not pre-reserve K tokens of slack.",
             [(None, s.get("decode_window_fallbacks"))])
    d.metric("decode_window_shrinks_total", "counter",
             "Eligible decode windows that ran device-resident at a "
             "shrunk K' < K (largest slack the page pool covered).",
             [(None, s.get("decode_window_shrinks"))])

    # -- weight residency --------------------------------------------------
    # quantized weight pools shrink resident weight bytes 4x/8x vs f32;
    # the gauge sits next to kv_bytes_resident so HBM budgeting reads
    # both halves of the residency story from one scrape
    d.metric("weight_bytes_resident", "gauge",
             "Bytes of model weights resident on device (pools + "
             "scales), labeled by storage dtype.",
             [({"dtype": s.get("weight_dtype") or "float32"},
               s.get("weight_bytes_resident"))])
    d.metric("weight_bytes_resident_per_shard", "gauge",
             "Largest single shard's resident weight bytes (equals "
             "the total at tp=1).",
             [(None, s.get("weight_bytes_resident_per_shard"))])

    # -- fault tolerance --------------------------------------------------
    d.metric("engine_restarts_total", "counter",
             "Supervised engine rebuilds (crashed or hung steps).",
             [(None, s.get("engine_restarts"))])
    d.metric("uptime_seconds", "gauge",
             "Service uptime (survives engine rebuilds).",
             [(None, s.get("uptime_seconds"))])
    d.metric("quarantined_total", "counter",
             "Sequences retired with finish_reason=numerical_error.",
             [(None, s.get("quarantined"))])
    d.metric("faults_injected_total", "counter",
             "Injected faults fired, by kind (chaos testing).",
             [({"kind": k}, n)
              for k, n in sorted((s.get("fault_injections")
                                  or {}).items())]
             or [(None, 0)])
    d.metric("degradation_state", "gauge",
             "Pressure tier: 0 normal, 1 spec-shrink, 2 admit-pause, "
             "3 evict-parked.", [(None, s.get("degradation_state"))])
    d.metric("degradation_transitions_total", "counter",
             "Degradation tier changes.",
             [(None, s.get("degradation_transitions"))])
    d.metric("parked_evictions_total", "counter",
             "Parked pages proactively evicted under pressure.",
             [(None, s.get("parked_evictions"))])
    d.metric("abort_noops_total", "counter",
             "Aborts of already-finished/unknown request ids (benign).",
             [(None, s.get("abort_noops"))])

    # -- prefix cache and speculation ------------------------------------
    d.metric("prefix_cache_hit_rate", "gauge",
             "Fraction of prompt tokens served from cached KV pages.",
             [(None, s.get("prefix_hit_rate"))])
    d.metric("spec_accept_rate", "gauge",
             "Fraction of speculated draft tokens accepted by verify.",
             [(None, s.get("accept_rate"))])

    # -- hierarchical KV (host spill tier) ---------------------------------
    d.metric("kv_pages_spilled_total", "counter",
             "Pressure-evicted KV pages spilled to the host tier "
             "instead of destroyed.",
             [(None, s.get("kv_pages_spilled"))])
    d.metric("kv_pages_restored_total", "counter",
             "Spilled pages restored HBM-side for returning prefixes.",
             [(None, s.get("kv_pages_restored"))])
    d.metric("kv_spill_dropped_total", "counter",
             "Spill candidates the host tier refused (tier disabled, "
             "page oversized, or unregistered).",
             [(None, s.get("kv_spill_dropped"))])
    d.metric("kv_prefetch_hit_pages_total", "counter",
             "Restored pages that went on to serve a prefix-cache hit.",
             [(None, s.get("kv_prefetch_hit_pages"))])
    d.metric("spill_tier_hit_rate", "gauge",
             "Fraction of spill-tier consults that found the requested "
             "chain hash resident.",
             [(None, s.get("spill_tier_hit_rate"))])
    d.metric("host_kv_bytes", "gauge",
             "Host spill-tier bytes, by kind (resident vs capacity).",
             [({"kind": "resident"}, s.get("host_kv_bytes_resident")),
              ({"kind": "capacity"}, s.get("host_kv_bytes_capacity"))])

    # -- replica routing --------------------------------------------------
    if router is not None:
        d.metric("replicas", "gauge",
                 "Data-parallel engine replicas behind the router.",
                 [(None, router.get("replicas"))])
        d.metric("replica_outstanding_tokens", "gauge",
                 "Routing load estimate per replica: prompt + budget "
                 "tokens submitted and not yet finished.",
                 [({"replica": str(i)}, v) for i, v in
                  enumerate(router.get("outstanding_tokens", []))])
        d.metric("replica_routed_requests_total", "counter",
                 "Requests landed on each replica.",
                 [({"replica": str(i)}, v) for i, v in
                  enumerate(router.get("routed_requests", []))])
        d.metric("replica_affinity_hits_total", "counter",
                 "Requests routed by a prefix-affinity match, per "
                 "replica.",
                 [({"replica": str(i)}, v) for i, v in
                  enumerate(router.get("affinity_hits", []))])

    # -- engine gauges ----------------------------------------------------
    if engine is not None:
        pool = engine.blocks
        d.metric("kv_pages", "gauge",
                 "KV page pool occupancy, by state.",
                 [({"state": "used"}, pool.num_used),
                  ({"state": "free"}, pool.num_free),
                  ({"state": "cached"}, pool.num_cached),
                  ({"state": "spill_pending"},
                   getattr(pool, "num_spill_pending", 0))])
        d.metric("engine_running_seqs", "gauge",
                 "Sequences in the decode batch.",
                 [(None, len(engine._running))])
        d.metric("engine_waiting_seqs", "gauge",
                 "Sequences queued inside the engine for admission.",
                 [(None, len(engine._waiting))])
        d.metric("engine_compiles_total", "counter",
                 "Step programs built (launch buckets warmed), by kind.",
                 [({"kind": k}, n)
                  for k, n in sorted(engine.compile_counts.items())])
    return d.render()


def _ms(v):
    return None if v is None else float(v) / 1000.0
