"""PyTorch port, the serving host tiers on the CPU, held against the JAX
package (tests/test_kv_tier.py, test_chaos.py, test_slo.py and
test_trace.py's unit cases, and the spill tier through the engine).

- Unit parity: ``HostSpillPool``, ``FaultPlan.seeded``,
  ``DegradationController`` (scripted free-page signals),
  ``FlightRecorder``, the SLO rings, percentiles and burn states (an
  injected clock), ``Tracer``'s Chrome export (names, phases, tracks and
  nesting, not timestamps) and the ``# guarded-by:`` validator: the same
  calls give the same results as the JAX package's objects.
- The spill tier through the engine, float and int8 pages: the
  returning-user stream on a starved pool under a degradation controller
  gives the JAX engine's greedy tokens and its spill, restore, hit-rate
  and cache-miss counters, tier on equal to tier off, compile counts
  unmoved; ``prefetch_hint`` pre-stages a spilled chain, whose restored
  pool rows equal the bytes the tier held, scales included.
Every count and token is held exactly; no time is compared."""
import jax
import numpy as np
import pytest
import torch

from paddle_tpu.analysis import lock_check as jax_lock_check
from paddle_tpu.core import random_state
from paddle_tpu.inference import LLMEngine as JaxEngine
from paddle_tpu.inference import faults as jax_faults
from paddle_tpu.inference import flight as jax_flight
from paddle_tpu.inference import kv_tier as jax_kv_tier
from paddle_tpu.inference import pressure as jax_pressure
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxModel
from paddle_tpu.profiler import slo as jax_slo
from paddle_tpu.profiler import trace as jax_trace
from paddle_tpu_torch.analysis import lock_check
from paddle_tpu_torch.inference import (DegradationController, FaultPlan,
                                        HostSpillPool, LLMEngine)
from paddle_tpu_torch.inference import flight
from paddle_tpu_torch.inference.kv_cache import prefix_chain_hashes
from paddle_tpu_torch.models.llama import (LlamaConfig,
                                           from_jax_decode_params)
from paddle_tpu_torch.profiler import Tracer, slo
from _torch_threads import torch_threads  # noqa: F401

VOCAB = 97
CFG = JaxConfig.tiny(vocab=VOCAB, hidden=32, layers=2, heads=4, ffn=64,
                     seq=128)


class Pair:
    """One JAX model and its weights carried into the port."""

    def __init__(self, jcfg):
        self.jm = JaxModel(jcfg)
        params = jax.tree.map(np.asarray, self.jm.decode_params())
        cfg = LlamaConfig(**{k: getattr(jcfg, k)
                             for k in LlamaConfig.__dataclass_fields__})
        self.tm = from_jax_decode_params(cfg, params, device="cpu")


@pytest.fixture(scope="module")
def pair():
    """The model, drawn from the JAX package's global random state seeded
    to 0 and restored afterwards."""
    saved = dict(random_state._state)
    random_state.seed(0)
    try:
        return Pair(CFG)
    finally:
        random_state._state.update(saved)


# ---------------------------------------------------------------------------
# unit parity
# ---------------------------------------------------------------------------

def _page(nbytes, seed):
    rng = np.random.RandomState(seed)
    half = nbytes // 2
    return {"kc": rng.randint(-128, 127, half).astype(np.int8),
            "vc": rng.randint(-128, 127, half).astype(np.int8)}


def _pool_script(pool):
    """A fixed run of every HostSpillPool operation; returns what each
    step observed."""
    seen = []
    for h in range(6):
        seen.append(pool.insert([h, 100 + h], _page(64, h)))
    seen.append(pool.insert([], _page(16, 9)))
    seen.append(pool.insert([50], _page(512, 9)))        # oversized
    seen += [pool.lookup(h) for h in (0, 3, 4, 104, 77)]
    seen.append(pool.insert([3], _page(64, 11)))         # displaces
    seen.append(pool.insert([60], _page(64, 12)))        # LRU-evicts
    for h in (4, 104, 5, 3):
        e = pool.take(h)
        seen.append(None if e is None else
                    (e["hashes"], {k: v.tobytes()
                                   for k, v in e["arrays"].items()}))
    for hint in ([1, 2], [3], [], [4, 5], [6]):
        pool.hint(hint)
    seen += [pool.drain_hints(), pool.drain_hints(), pool.gen, len(pool),
             pool.bytes_resident, sorted(h for h in range(200) if h in pool),
             pool.stats()]
    return seen


def test_spill_pool_matches_reference():
    assert _pool_script(HostSpillPool(256, max_hints=3)) == \
        _pool_script(jax_kv_tier.HostSpillPool(256, max_hints=3))


def _plan_script(plan):
    out = [repr(plan), plan.pool_window]
    for _ in range(40):
        plan.advance()
        out.append((plan.step, plan.take_pool_entry(), plan.take_slow(),
                    plan.take_crash(), plan.pool_exhausted(),
                    plan.take_nan_row(5), plan.take_conn_drop()))
    return out + [plan.exhausted(), repr(plan)]


@pytest.mark.parametrize("seed", [0, 5, 123])
def test_fault_plan_seeded_matches_reference(seed):
    kw = dict(n_crash=2, n_nan=2, n_slow=1, slow_s=0.0, pool_window_len=3,
              n_conn_drop=2, n_requests=8)
    assert _plan_script(FaultPlan.seeded(seed, **kw)) == \
        _plan_script(jax_faults.FaultPlan.seeded(seed, **kw))


def test_fault_plan_inflight_seams_match_reference():
    def run(mod):
        plan = mod.FaultPlan(seed=3, inflight_crash_steps=(2, 5),
                             inflight_slow_steps={4: 0.0},
                             nan_steps=(3,), crash_steps=(6,))
        out = []
        for _ in range(8):
            plan.advance()
            out.append((plan.take_inflight_crash(),
                        plan.take_inflight_slow(), plan.take_crash(),
                        plan.take_nan_row(3)))
        return out + [plan.exhausted()]
    assert run(jax_faults) == run(__import__(
        "paddle_tpu_torch.inference.faults", fromlist=["FaultPlan"]))


class _StubBlocks:
    def __init__(self, total, free):
        self.num_blocks = total + 1      # slot 0 is the null block
        self.num_free = free


FREE_SCRIPT = (90, 9, 50, 50, 50, 20, 50, 50, 50, 50, 28, 16, 12, 40, 8,
               60, 60, 60, 60, 60, 60, 60)


def _pressure_script(ctrl):
    out = []
    for free in FREE_SCRIPT:
        st = ctrl.update(_StubBlocks(100, free), spec_reserved=free % 3)
        out.append((st, ctrl.evict_now, ctrl.admission_paused,
                    ctrl.spec_k_cap(8), ctrl.tier_entries))
    return out + [[(f, t) for _, f, t in ctrl.transitions]]


def test_degradation_controller_matches_reference():
    kw = dict(cooldown_steps=2, evict_batch=3)
    assert _pressure_script(DegradationController(**kw)) == \
        _pressure_script(jax_pressure.DegradationController(**kw))
    assert jax_pressure.STATE_NAMES == \
        __import__("paddle_tpu_torch.inference.pressure",
                   fromlist=["STATE_NAMES"]).STATE_NAMES


_TIMES = ("queue_wait_s", "slack_admit_s", "slack_first_token_s",
          "slack_finish_s", "ttft_s", "latency_s", "elapsed_s")


def _flight_script(rec):
    for rid in range(5):
        rec.open(rid, prompt_tokens=3 + rid, t_submit=10.0 + rid)
    rec.annotate(1, request_id="r-1", replica="r0", deadline_s=5.0)
    rec.admitted(1, queue_wait_s=0.25, cache_hit_tokens=8, tier=1)
    rec.prefill_chunk(1, 16)
    rec.prefill_chunk(1, 4)
    rec.first_token(1, 0.5)
    rec.spec_round(1, 3, 1)
    rec.preempted(1)
    rec.finished(1, reason="length", generated=7, tier=2)
    rec.finished(3, reason="numerical_error", generated=2,
                 quarantined=True)
    rec.open(6, prompt_tokens=9)                 # evicts rid 0
    strip = lambda d: {k: v for k, v in d.items()  # noqa: E731
                       if k not in _TIMES}
    return ([strip(d) for d in rec.list(sort="recent", limit=10)],
            strip(rec.get("r-1")), rec.get(0), len(rec), rec.evicted,
            [d["rid"] for d in rec.list(finished=True)])


def test_flight_recorder_matches_reference():
    assert _flight_script(flight.FlightRecorder(5)) == \
        _flight_script(jax_flight.FlightRecorder(5))


class _Clock:
    def __init__(self, t):
        self.t = t

    def __call__(self):
        return self.t


def _slo_script(mod):
    clk = _Clock(1.0)
    cfg = mod.SLOConfig(ttft_p95_ms=100.0, itl_p99_ms=100.0)
    tele = mod.WindowedTelemetry(cfg, clock=clk)
    out = []
    for i in range(40):
        clk.t += 0.7
        tele.record_ttft(0.002 if i % 7 else 0.9)
        tele.record_itl(0.004 * (1 + i % 5), n=1 + i % 3)
        tele.record_step(0.008)
        tele.record_queue_wait(0.001 * i)
        tele.record_request(0.2)
        tele.record_accept(i % 4, 4)
        tele.record_deadline(i % 9 != 0)
        tele.record_finish(i % 13 != 0)
        if i % 10 == 9:
            snap = tele.snapshot()
            out.append((snap, mod.evaluate_slo(cfg, snap),
                        tele.snapshot_keys()))
    out.append(mod.bucket_percentile([0, 3, 5, 0, 2] + [0] * 20, 0.95))
    return out


def test_slo_windows_and_burn_states_match_reference():
    assert _slo_script(slo) == _slo_script(jax_slo)


def _trace_script(mod):
    tr = mod.Tracer(capacity=64)
    eng = tr.register("engine")
    eng2 = tr.register("engine")
    tr.async_begin("req", "engine:0", args={"rid": 0})
    with tr.span("engine.step", track=eng, step=1):
        with tr.span("engine.pack", track=eng, rows=2):
            tr.instant("request.first_token", track=eng2, args={"rid": 0})
        t0 = tr.now()
        tr.complete("engine.device_launch", t0, track=eng,
                    args={"bucket": 8})
    tr.async_end("req", "engine:0", args={"finish_reason": "length"})
    doc = tr.chrome_trace()
    evs = sorted(((e["name"], e["ph"], e["tid"], e.get("cat"), e.get("id"),
                   e.get("args")) for e in doc["traceEvents"]),
                 key=repr)
    spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    # nesting: each span lies inside the one that encloses it
    step = next(e for e in spans if e["name"] == "engine.step")
    inner = [e for e in spans if e["name"] != "engine.step"]
    nested = all(step["ts"] <= e["ts"] and e["ts"] + e["dur"]
                 <= step["ts"] + step["dur"] for e in inner)
    return (eng, eng2, evs, nested, len(tr), tr.dropped, tr.unbalanced,
            doc["otherData"])


def test_tracer_export_matches_reference():
    ours, ref = _trace_script(__import__(
        "paddle_tpu_torch.profiler.trace", fromlist=["Tracer"])), \
        _trace_script(jax_trace)
    assert ours == ref
    assert ours[3]


def test_lock_check_matches_reference(monkeypatch):
    """The ``# guarded-by:`` validator: the same annotated methods found,
    and in strict mode entering one without its lock raises, in both
    packages."""
    import threading

    class Guarded:
        def __init__(self):
            self._lock = threading.Lock()

        def bump(self):  # guarded-by: _lock
            return 1

    assert lock_check.guards_of(Guarded) == \
        jax_lock_check.guards_of(Guarded) == {"bump": {"_lock"}}
    lock_check.install(Guarded)
    g = Guarded()
    assert g.bump() == 1                   # mode off: no check
    monkeypatch.setenv("PT_ANALYSIS", "strict")
    with pytest.raises(lock_check.GuardViolation):
        g.bump()
    with g._lock:
        assert g.bump() == 1


# ---------------------------------------------------------------------------
# the spill tier through the engine
# ---------------------------------------------------------------------------

def _kw(**kw):
    kw.setdefault("max_num_seqs", 4)
    kw.setdefault("block_size", 8)
    kw.setdefault("max_model_len", 128)
    kw.setdefault("max_prefill_tokens", 64)
    kw.setdefault("prefill_token_bucket", 32)
    return kw


def _drive(engine, stream):
    """stream: [(submit_step, prompt, max_new)] -> {rid: tokens}."""
    outs = {}
    step_no = 0
    pending = list(stream)
    while pending or engine.has_unfinished():
        while pending and pending[0][0] <= step_no:
            _, prompt, max_new = pending.pop(0)
            engine.add_request(prompt, max_new_tokens=max_new)
        for fo in engine.step():
            outs[fo.rid] = tuple(fo.generated)
        step_no += 1
    return outs


def _returning_stream(n=32, n_users=4, plen=32, max_new=8):
    rng = np.random.RandomState(7)
    users = [rng.randint(0, VOCAB, plen).tolist() for _ in range(n_users)]
    return [(i, users[int(rng.randint(0, n_users))], max_new)
            for i in range(n)]


TIER_KEYS = ("kv_pages_spilled", "kv_pages_restored", "kv_spill_dropped",
             "spill_tier_hit_rate", "cache_miss_tokens", "cache_hit_tokens",
             "preemptions", "kv_prefetch_hit_pages", "cache_evictions",
             "parked_evictions", "degradation_state")


def _tier_run(engine_cls, model, cap, pressure_cls, **kw):
    tier = None
    if cap:
        tier = (HostSpillPool if engine_cls is LLMEngine
                else jax_kv_tier.HostSpillPool)(cap)
    extra = {"device": "cpu"} if engine_cls is LLMEngine else {}
    eng = engine_cls(model, **_kw(num_blocks=18, pressure=pressure_cls(),
                                  kv_tier=tier, **kw), **extra)
    eng.precompile_buckets()
    compiles = dict(eng.compile_counts)
    outs = _drive(eng, _returning_stream())
    snap = eng.stats.snapshot()
    eng.blocks.check_invariants()
    return {"outs": outs, "snap": {k: snap[k] for k in TIER_KEYS},
            "compiles_moved": eng.compile_counts != compiles,
            "tier": None if tier is None else tier.stats(),
            "entries": eng.degradation_tier_entries}


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_spill_tier_matches_reference(pair, kv_dtype):
    """The returning-user stream on a starved pool, tier on and off: the
    port's tokens and tier counters equal the JAX engine's with the tier
    on, tier on equals tier off, no bucket is added by a restore, and the
    tier turned re-prefill work into restores."""
    cap = 64 << 20
    on = _tier_run(LLMEngine, pair.tm, cap, DegradationController,
                   kv_dtype=kv_dtype)
    ref = _tier_run(JaxEngine, pair.jm, cap,
                    jax_pressure.DegradationController, kv_dtype=kv_dtype)
    off = _tier_run(LLMEngine, pair.tm, 0, DegradationController,
                    kv_dtype=kv_dtype)
    assert on["snap"]["kv_pages_spilled"] > 0
    assert on["snap"]["kv_pages_restored"] > 0
    assert on["snap"]["spill_tier_hit_rate"] > 0.0
    assert on["outs"] == ref["outs"]
    assert on["snap"] == ref["snap"]
    assert on["tier"] == ref["tier"]          # byte counts included
    assert on["entries"] == ref["entries"] > 0
    assert off["snap"]["kv_pages_spilled"] == 0
    assert on["outs"] == off["outs"]
    assert not on["compiles_moved"] and not off["compiles_moved"]
    assert on["snap"]["cache_miss_tokens"] < off["snap"]["cache_miss_tokens"]


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_prefetch_hint_restores_the_spilled_bytes(pair, kv_dtype):
    """A finished request's pages spill at the drain; its hinted chain is
    restored before the request returns, into the pool rows in place
    (the pools keep their storage), byte for byte what the tier held,
    scales included; the returning request hits them, the prefetch is
    credited, and its tokens equal the first run's and the JAX engine's."""
    tier = HostSpillPool(64 << 20)
    eng = LLMEngine(pair.tm, device="cpu",
                    **_kw(num_blocks=24, kv_tier=tier, kv_dtype=kv_dtype))
    ptrs = [t.data_ptr() for t in (eng._kc, eng._vc)]
    prompt = list(range(32))
    first = _drive(eng, [(0, prompt, 4)])
    chain = prefix_chain_hashes(prompt, eng.block_size)
    assert eng.blocks.evict_parked(eng.blocks.num_cached) >= len(chain)
    eng.step()                                        # the drain spills
    assert not any(eng.blocks.has_hash(h) for h in chain)
    assert all(h in tier for h in chain)
    held = {h: {k: v.clone() for k, v in
                tier._entries[tier._by_hash[h]]["arrays"].items()}
            for h in chain}
    eng.prefetch_hint(chain)
    eng.step()                                        # the drain restores
    pools = {"kc": eng._kc, "vc": eng._vc}
    if kv_dtype == "int8":
        pools.update(ks=eng._ks, vs=eng._vs)
    for h in chain:
        blk = eng.blocks._hash_to_block[h]
        for k, pool in pools.items():
            assert torch.equal(pool[:, blk], held[h][k]), (h, k)
    assert [t.data_ptr() for t in (eng._kc, eng._vc)] == ptrs
    again = _drive(eng, [(0, prompt, 4)])
    assert eng.stats.snapshot()["kv_prefetch_hit_pages"] > 0
    assert list(again.values()) == list(first.values())
    ref = _drive(JaxEngine(pair.jm, **_kw(num_blocks=24,
                                          kv_dtype=kv_dtype)),
                 [(0, prompt, 4)])
    assert list(ref.values()) == list(first.values())
    eng.blocks.check_invariants()
