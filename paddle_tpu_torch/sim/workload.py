"""Workloads for the fleet simulator: replayed or synthesized.

Two sources, one shape:

* ``replay_workload`` loads a ``serve_bench --dump-workload`` capture —
  the EXACT request stream (step-indexed arrivals, real token ids) that
  produced a bench record, keyed by the record's
  ``workload_fingerprint`` so validation provably joins the right pair.
  Token ids are chain-hashed with the engine's own rolling page hash
  (``kv_cache.prefix_chain_hashes``), so the simulator's prefix-cache
  model sees the same page identity the real ``BlockManager`` sees.

* ``synthesize_workload`` builds streams from distributions, seeded and
  wall-clock-free: steady Poisson arrivals, bursty (two-state
  modulated Poisson: an on/off square wave of arrival intensity —
  the shape that breaks static admission thresholds), heavy-tailed
  (Pareto prompt/output lengths: the p99-dominating long requests),
  and multi-tenant (per-tenant shared system-prompt prefix pages, the
  shape router affinity exists for).  Synthetic requests never
  materialize token ids — prefix identity is synthesized directly as
  page-hash tuples, which is what lets a 50k-request sweep cell run in
  seconds.

Arrival encoding differs by source and the fields say which: replayed
requests carry ``arrival_step`` (the bench's ``_drive`` adds requests
when the engine's step counter reaches that index — closed-loop, so
validation must reproduce it exactly), synthetic requests carry
``arrival_s`` in open-loop virtual seconds.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

from ..inference.kv_cache import prefix_chain_hashes

__all__ = ["SimRequest", "replay_workload", "synthesize_workload",
           "PROFILES"]

PROFILES = ("steady", "bursty", "heavy_tail", "multi_tenant")


@dataclass
class SimRequest:
    """One request as the simulator sees it.  ``chain_hashes`` is the
    prompt's full-page chain-hash sequence — page IDENTITY only; the
    simulator never needs the tokens themselves (``tokens`` rides along
    for replayed streams so dumps stay joinable)."""
    rid: str
    prompt_len: int
    max_new: int
    chain_hashes: tuple = ()
    arrival_step: int | None = None     # replay: engine-step index
    arrival_s: float | None = None      # synthetic: virtual seconds
    tenant: int = 0
    tokens: list | None = field(default=None, repr=False)


def replay_workload(dump: dict) -> list:
    """Requests from a ``--dump-workload`` capture (see serve_bench):
    ``{"stream": [[arrival_step, [token...], max_new], ...],
    "engine_kw": {...}, ...}``."""
    block_size = int(dump["engine_kw"]["block_size"])
    out = []
    for i, (step, tokens, max_new) in enumerate(dump["stream"]):
        toks = [int(t) for t in tokens]
        out.append(SimRequest(
            rid=f"req-{i}", prompt_len=len(toks), max_new=int(max_new),
            chain_hashes=tuple(prefix_chain_hashes(toks, block_size)),
            arrival_step=int(step), tokens=toks))
    return out


def _length(rng, mean: int, lo: int, hi: int, *, heavy: bool) -> int:
    """One prompt/output length draw.  Light tail: lognormal around
    ``mean`` (sigma 0.5).  Heavy tail: Pareto(alpha=1.6) scaled so the
    MEDIAN sits near ``mean`` — the mean is tail-dominated, which is
    the point."""
    if heavy:
        x = mean * 0.65 * rng.paretovariate(1.6)
    else:
        x = rng.lognormvariate(math.log(max(mean, 2)) - 0.125, 0.5)
    return max(lo, min(hi, int(x)))


def synthesize_workload(n_requests: int, *, seed: int,
                        profile: str = "steady", rate_rps: float = 64.0,
                        mean_prompt: int = 96, mean_new: int = 48,
                        max_model_len: int = 1024, block_size: int = 16,
                        tenants: int = 4, prefix_pages: int = 4,
                        prefix_share: float = 0.7,
                        burst_factor: float = 8.0, burst_on_s: float = 2.0,
                        burst_off_s: float = 8.0, rng=None) -> list:
    """Seeded synthetic stream of ``n_requests`` (sorted by arrival).

    ``profile`` selects the arrival process and length tail:

        steady        Poisson(rate_rps); lognormal lengths
        bursty        two-state modulated Poisson: ``burst_on_s``-long
                      bursts at ``rate_rps * burst_factor`` separated
                      by ``burst_off_s`` lulls at ``rate_rps / 4``
        heavy_tail    Poisson arrivals, Pareto lengths
        multi_tenant  steady arrivals; each request belongs to one of
                      ``tenants`` tenants and with probability
                      ``prefix_share`` opens with its tenant's shared
                      ``prefix_pages``-page system prompt (identical
                      leading chain hashes -> cache hits + affinity)

    ``rng`` lets a caller thread one ``random.Random`` through several
    streams; by default a fresh ``Random(seed)`` keeps the stream a
    pure function of its arguments.
    """
    import random
    if profile not in PROFILES:
        raise ValueError(f"profile must be one of {PROFILES}, "
                         f"got {profile!r}")
    rng = rng if rng is not None else random.Random(seed)
    heavy = profile == "heavy_tail"
    shared = profile == "multi_tenant"
    # bursty state machine: (in_burst, state_ends_at)
    t, in_burst, state_end = 0.0, False, 0.0
    out = []
    for i in range(n_requests):
        if profile == "bursty":
            while t >= state_end:
                in_burst = not in_burst
                state_end = t + rng.expovariate(
                    1.0 / (burst_on_s if in_burst else burst_off_s))
            rate = rate_rps * (burst_factor if in_burst else 0.25)
        else:
            rate = rate_rps
        t += rng.expovariate(rate)
        tenant = rng.randrange(tenants) if shared else 0
        prompt = _length(rng, mean_prompt, 4, max_model_len // 2,
                         heavy=heavy)
        max_new = _length(rng, mean_new, 4,
                          max_model_len - prompt, heavy=heavy)
        full_pages = prompt // block_size
        lead = min(prefix_pages, full_pages) \
            if shared and rng.random() < prefix_share else 0
        # page identity without tokens: shared leading pages hash by
        # (tenant, position); the unique remainder hashes by (rid,
        # position) — disjoint namespaces, so synthetic hashes can
        # never alias real chain hashes or each other
        hashes = tuple(("t", tenant, j) for j in range(lead)) + \
            tuple(("u", i, j) for j in range(lead, full_pages))
        out.append(SimRequest(
            rid=f"req-{i}", prompt_len=prompt, max_new=max_new,
            chain_hashes=hashes, arrival_s=t, tenant=tenant))
    return out
