"""PyTorch port, the engine's fault, pressure, tracer and flight seams on
the CPU, held against the JAX engine with the same options on the same
weights (tests/test_chaos.py, test_trace.py and test_slo.py's engine
cases).

- The NaN seam quarantines only the poisoned row, as in the JAX engine.
- A continuation (``add_request(generated=)``) equals the uninterrupted
  run, greedy and at temperature 0.8, and the JAX engine's run.
- The degradation controller engages before preemption: the port walks
  the JAX engine's tiers with its transitions, tier entries and
  preemptions.
- An in-flight crash under the supervised runner recovers with every
  stream byte-identical to the fault-free run (and to the JAX engine's),
  per step and with the decode window on, no page leaked; the dead
  engine's pools are dropped.
- Tracer on and off give identical tokens; the span names equal the JAX
  engine's; flight records and windows carry the JAX engine's counts;
  with no tracer or recorder the step loop allocates nothing in the
  tracer, flight or slo modules.
Tokens, finish reasons and counters are held exactly; no time is
compared."""
import os
import queue
import tracemalloc

import jax
import numpy as np
import pytest

from paddle_tpu.core import random_state
from paddle_tpu.inference import LLMEngine as JaxEngine
from paddle_tpu.inference import faults as jax_faults
from paddle_tpu.inference import flight as jax_flight
from paddle_tpu.inference import pressure as jax_pressure
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxModel
from paddle_tpu.profiler import Tracer as JaxTracer
from paddle_tpu_torch.inference import (DegradationController, FaultPlan,
                                        LLMEngine)
from paddle_tpu_torch.inference.flight import FlightRecorder
from paddle_tpu_torch.inference.frontend import EngineRunner
from paddle_tpu_torch.inference.pressure import (ADMIT_PAUSE, NORMAL,
                                                 SPEC_SHRINK)
from paddle_tpu_torch.models.llama import (LlamaConfig,
                                           from_jax_decode_params)
from paddle_tpu_torch.profiler import Tracer
from _torch_threads import torch_threads  # noqa: F401

VOCAB = 97
CFG = JaxConfig.tiny(vocab=VOCAB, hidden=32, layers=2, heads=4, ffn=64,
                     seq=64)
JOIN_S = 120.0                   # bound on every wait for a runner


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


def _kw(**kw):
    # a prefill bucket above max_prefill_tokens + max_num_seqs keeps every
    # run on two buckets (mixed 128, decode 8)
    kw.setdefault("max_num_seqs", 8)
    kw.setdefault("block_size", 8)
    kw.setdefault("max_model_len", 64)
    kw.setdefault("max_prefill_tokens", 64)
    kw.setdefault("prefill_token_bucket", 128)
    kw.setdefault("retain_outputs", False)
    return kw


def _port(pair, **kw):
    return LLMEngine(pair.tm, device="cpu", **_kw(**kw))


def _jax(pair, **kw):
    return JaxEngine(pair.jm, **_kw(**kw))


def _requests(n, seed=7):
    """A mixed stream: ragged prompt lengths, every fourth sampled."""
    rng = np.random.RandomState(seed)
    reqs = []
    for i in range(n):
        r = {"prompt": rng.randint(0, VOCAB, [4, 9, 13, 20][i % 4]).tolist(),
             "max_new_tokens": int(rng.randint(4, 13)),
             "temperature": 0.0, "seed": 0}
        if i % 4 == 3:
            r["temperature"] = 0.8
            r["seed"] = i
        reqs.append(r)
    return reqs


def _run_direct(eng, reqs):
    """Step one engine to completion; outputs by request index."""
    outs = {}
    for i, r in enumerate(reqs):
        eng.add_request(r["prompt"], max_new_tokens=r["max_new_tokens"],
                        temperature=r["temperature"], seed=r["seed"],
                        on_finish=lambda o, i=i: outs.__setitem__(i, o))
    while eng.has_unfinished():
        eng.step()
    assert len(outs) == len(reqs)
    return {i: (tuple(o.generated), o.finish_reason)
            for i, o in outs.items()}


def _collect(q):
    toks = []
    while True:
        kind, val = q.get(timeout=JOIN_S)
        if kind == "finish":
            return toks, val
        toks.append(val)


# ---------------------------------------------------------------------------
# quarantine, continuation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_quarantine_retires_only_poisoned_row(pair, kv_dtype):
    reqs = _requests(3, seed=11)
    base = _run_direct(_port(pair, kv_dtype=kv_dtype), reqs)
    eng = _port(pair, kv_dtype=kv_dtype,
                fault_plan=FaultPlan(seed=2, nan_steps=(3,)))
    ref = _jax(pair, kv_dtype=kv_dtype,
               fault_plan=jax_faults.FaultPlan(seed=2, nan_steps=(3,)))
    outs, ref_outs = _run_direct(eng, reqs), _run_direct(ref, reqs)
    assert outs == ref_outs
    bad = [i for i, o in outs.items() if o[1] == "numerical_error"]
    assert len(bad) == 1
    assert eng.stats.quarantined == 1
    assert eng.stats.fault_injections == {"nan": 1}
    assert all(outs[i] == base[i] for i in outs if i not in bad)
    assert eng.blocks.num_used == 0
    eng.blocks.check_invariants()


@pytest.mark.parametrize("temperature,seed", [(0.0, 0), (0.8, 7)])
def test_continuation_replay_matches_uninterrupted(pair, temperature,
                                                   seed):
    rng = np.random.RandomState(17)
    prompt = rng.randint(0, VOCAB, 10).tolist()
    req = [{"prompt": prompt, "max_new_tokens": 12,
            "temperature": temperature, "seed": seed}]
    full = _run_direct(_port(pair), req)[0][0]
    assert full == _run_direct(_jax(pair), req)[0][0]
    assert len(full) == 12
    for split in (1, 5, 11):
        eng = _port(pair)
        new_tokens, out = [], {}
        eng.add_request(prompt, max_new_tokens=12, temperature=temperature,
                        seed=seed, generated=list(full[:split]),
                        on_token=lambda rid, t: new_tokens.append(t),
                        on_finish=lambda o: out.setdefault("o", o))
        while eng.has_unfinished():
            eng.step()
        assert tuple(out["o"].generated) == full
        assert tuple(new_tokens) == full[split:]
        assert eng.blocks.num_used == 0
    with pytest.raises(ValueError):
        _port(pair).add_request([1, 2, 3], max_new_tokens=4,
                                generated=[5, 6, 7, 8])


# ---------------------------------------------------------------------------
# degradation before preemption
# ---------------------------------------------------------------------------

def _squeeze_walk(eng, ctrl):
    """test_chaos.py's walk: squeeze the pool from outside, then release
    it; the state after every step, and the run's counters."""
    rng = np.random.RandomState(23)
    states = []

    def step():
        eng.step()
        states.append((ctrl.state, eng.stats.preemptions,
                       eng.stats.degradation_state))

    eng.add_request(rng.randint(0, VOCAB, 8).tolist(), max_new_tokens=40)
    step()
    step()
    assert eng.blocks.allocate("ghost-0", (eng.blocks.num_free - 8) * 8)
    step()
    assert eng.blocks.allocate("ghost-1", (eng.blocks.num_free - 5) * 8)
    rid_b = eng.add_request(rng.randint(0, VOCAB, 6).tolist(),
                            max_new_tokens=4)
    step()
    admitted_in_pause = eng.blocks.has(rid_b)
    eng.blocks.release("ghost-0")
    eng.blocks.release("ghost-1")
    for _ in range(5):
        step()
    while eng.has_unfinished():
        eng.step()
    eng.blocks.check_invariants()
    return {"states": states, "paused_admit": admitted_in_pause,
            "transitions": [(f, t) for _, f, t in ctrl.transitions],
            "entries": eng.degradation_tier_entries,
            "preemptions": eng.stats.preemptions,
            "used": eng.blocks.num_used, "outs": dict(eng._finished)}


def test_degradation_engages_before_preemption(pair):
    kw = dict(max_num_seqs=4, drafter="ngram", spec_k=4, max_spec_k=4,
              retain_outputs=True)
    ctrl = DegradationController(cooldown_steps=3, evict_batch=2)
    ours = _squeeze_walk(_port(pair, pressure=ctrl, **kw), ctrl)
    jctrl = jax_pressure.DegradationController(cooldown_steps=3,
                                               evict_batch=2)
    ref = _squeeze_walk(_jax(pair, pressure=jctrl, **kw), jctrl)
    assert ours["transitions"] == [(NORMAL, SPEC_SHRINK),
                                   (SPEC_SHRINK, ADMIT_PAUSE),
                                   (ADMIT_PAUSE, SPEC_SHRINK),
                                   (SPEC_SHRINK, NORMAL)]
    assert not ours["paused_admit"]
    assert ours["preemptions"] == 0 and ours["used"] == 0
    assert ours["entries"] == 2
    outs = {r: (o.generated, o.finish_reason)
            for r, o in ours.pop("outs").items()}
    ref_outs = {r: (o.generated, o.finish_reason)
                for r, o in ref.pop("outs").items()}
    assert outs == ref_outs
    assert ours == ref


# ---------------------------------------------------------------------------
# in-flight crash recovery under the supervised runner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("decode_window", [1, 4])
def test_inflight_crash_recovery_discards_prestaged_pack(pair,
                                                         decode_window):
    """A crash injected while a launch is in flight (the pipeline's
    completion seam; with K 4 often a window): the launch and the
    prestaged next pack die with the old engine, which is closed (its
    pools dropped); the journal replay gives every stream the fault-free
    run's tokens, which are the JAX engine's, and no page leaks."""
    reqs = _requests(16, seed=7)
    base = _run_direct(_port(pair, decode_window=decode_window), reqs)
    assert base == _run_direct(_jax(pair), reqs)
    plan = FaultPlan(seed=13, inflight_crash_steps=(5,))

    def factory():
        return _port(pair, decode_window=decode_window)

    eng = factory()
    assert eng.overlap
    eng.set_fault_plan(plan)
    runner = EngineRunner(eng, max_pending=32,
                          engine_factory=factory).start()
    queues = []
    try:
        for r in reqs:
            q = queue.Queue()
            queues.append(q)
            runner.submit(r["prompt"], deliver=q.put_nowait,
                          max_new_tokens=r["max_new_tokens"],
                          temperature=r["temperature"], seed=r["seed"])
        streams = [_collect(q) for q in queues]
    finally:
        assert runner.drain(timeout_s=JOIN_S)
    fin = runner.engine
    assert fin is not eng
    assert eng._kc is None and eng._inflight is None   # closed
    assert fin.stats.fault_injections == {"inflight_crash": 1}
    assert fin.stats.engine_restarts == runner.restarts == 1
    assert plan.exhausted()
    for i, (toks, out) in enumerate(streams):
        assert toks == list(out.generated)
        assert (tuple(out.generated), out.finish_reason) == base[i], i
    assert fin.blocks.num_used == 0 and fin._spec_pages == {}
    fin.blocks.check_invariants()


# ---------------------------------------------------------------------------
# tracer and flight recorder
# ---------------------------------------------------------------------------

def _audit(eng, tracer=None):
    if tracer is not None:
        eng.set_tracer(tracer)
    rng = np.random.RandomState(7)
    shapes = [(4, 8), (9, 8), (13, 6)]
    rids = [eng.add_request(rng.randint(0, VOCAB, n).tolist(),
                            max_new_tokens=mx)
            for n, mx in (shapes[i % 3] for i in range(16))]
    outs = eng.run()
    return [outs[r].generated for r in rids], dict(eng.compile_counts)


@pytest.mark.parametrize("opts", [{}, {"kv_dtype": "int8"},
                                  {"decode_window": 4},
                                  {"drafter": "ngram", "spec_k": 3}],
                         ids=["f32", "int8", "window", "spec"])
def test_tracer_on_off_identical_and_span_names_match_reference(pair,
                                                                 opts):
    kw = dict(max_prefill_tokens=256, prefill_token_bucket=64,
              retain_outputs=True, **opts)
    base = _audit(_port(pair, **kw))
    tr = Tracer()
    traced = _audit(_port(pair, **kw), tr)
    assert traced == base
    assert tr.unbalanced == 0 and tr.dropped == 0
    jtr = JaxTracer()
    _audit(_jax(pair, **kw), jtr)
    names = {(e[0], e[1]) for e in tr.events()}
    assert names == {(e[0], e[1]) for e in jtr.events()}
    assert ("X", "engine.device_inflight") in names
    assert sum(1 for e in tr.events() if e[0] == "b") == 16
    assert sum(1 for e in tr.events() if e[0] == "e") == 16


def test_flight_and_windows_match_reference(pair):
    """Flight records (every count, tier and finish field) and the windowed
    telemetry's counts equal the JAX engine's over a stream with a
    quarantine and a preemption-prone pool."""
    def run(eng, rec):
        eng.set_flight(rec)
        eng.stats.enable_windows()
        _run_direct(eng, _requests(12, seed=3))
        recs = sorted(rec.list(sort="recent", limit=64),
                      key=lambda d: d["rid"])
        keep = ("rid", "prompt_tokens", "generated_tokens",
                "cache_hit_tokens", "prefill_chunks", "preemptions",
                "quarantined", "tier_admit", "tier_finish", "finished",
                "finish_reason")
        w = eng.stats.windows.snapshot()["60s"]
        return ([{k: d[k] for k in keep} for d in recs],
                {ch: w[ch]["count"] for ch in
                 ("ttft", "itl", "step", "queue_wait", "request")},
                w["availability"])
    kw = dict(num_blocks=20, max_num_seqs=6)
    ours = run(_port(pair, fault_plan=FaultPlan(seed=1, nan_steps=(4,)),
                     **kw), FlightRecorder(64))
    ref = run(_jax(pair, fault_plan=jax_faults.FaultPlan(seed=1,
                                                         nan_steps=(4,)),
                   **kw), jax_flight.FlightRecorder(64))
    assert ours == ref
    assert any(d["quarantined"] for d in ours[0])


def test_disabled_seams_allocate_nothing_in_step_loop(pair):
    """With no tracer, recorder or windows the step loop never runs a line
    of profiler/trace.py, inference/flight.py or profiler/slo.py."""
    eng = _port(pair, max_num_seqs=4, retain_outputs=True)
    rng = np.random.RandomState(11)
    eng.add_request(rng.randint(0, VOCAB, 8).tolist(), max_new_tokens=4)
    eng.run()
    for _ in range(3):
        eng.add_request(rng.randint(0, VOCAB, 8).tolist(), max_new_tokens=6)
    files = [os.path.join("*", "paddle_tpu_torch", *p) for p in
             (("profiler", "trace.py"), ("inference", "flight.py"),
              ("profiler", "slo.py"))]
    tracemalloc.start()
    try:
        while eng.has_unfinished():
            eng.step()
        snap = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    for f in files:
        assert snap.filter_traces(
            [tracemalloc.Filter(True, f)]).statistics("lineno") == [], f
