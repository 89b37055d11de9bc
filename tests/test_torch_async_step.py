"""PyTorch port, the async step pipeline (``overlap=True``, the default) on
the CPU, held against the JAX engine with the same options on the same
weights (tests/test_async_step.py's cases, minus tp2 and the tracer:
ROADMAP Queue 1 items 10 and 9).

- The 16-request ragged audit stream: greedy tokens, finish reasons, pool
  and speculation counters and padding identical to the JAX engine with
  overlap on and off (f32, prefix cache off, int8 pages, and speculation
  with the n-gram drafter over float and int8 pages), and the port's
  overlap on equal to its overlap off, compile counts included, with no
  prestage page credit left over.
- Pipeline shape: outputs surface one ``step()`` later, ``run()`` drains
  the in-flight ticket, ``has_unfinished()`` covers it.
- abort() while a ticket is in flight drops the victim's rows unapplied
  and keeps its batchmates; a batchmate finishing in the flush surfaces
  from the next ``step()``.
- The prestage stages the idle decode buffer set, and the dispatch uses
  it; ``precompile_buckets`` warms the JAX engine's ladder and writes only
  the null page."""
import jax
import numpy as np
import pytest
import torch

from paddle_tpu.core import random_state
from paddle_tpu.inference import LLMEngine as JaxEngine
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxModel
from paddle_tpu_torch.inference import LLMEngine
from paddle_tpu_torch.inference.kv_cache import NULL_BLOCK
from paddle_tpu_torch.models.llama import (LlamaConfig,
                                           from_jax_decode_params)
from _torch_threads import torch_threads  # noqa: F401

VOCAB = 97
CFG = JaxConfig.tiny(vocab=VOCAB, hidden=32, layers=2, heads=4, ffn=64,
                     seq=64)
VARIANTS = {"f32": {}, "cache-off": {"enable_prefix_caching": False},
            "int8": {"kv_dtype": "int8"},
            "spec": {"drafter": "ngram", "spec_k": 3},
            "int8-spec": {"kv_dtype": "int8", "drafter": "ngram",
                          "spec_k": 3}}
COUNTERS = ("preemptions", "admitted", "retired", "cache_hit_tokens",
            "cow_copies", "prefill_tokens", "decode_tokens", "engine_steps",
            "host_round_trips", "verify_steps", "verify_tokens",
            "draft_proposed", "draft_accepted", "rollback_tokens",
            "rollback_pages")


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
    to 0 and restored afterwards (a fixed draw keeps the int8 comparison
    repeatable: see tests/test_torch_kv_quant.py)."""
    saved = dict(random_state._state)
    random_state.seed(0)
    try:
        return Pair(CFG)
    finally:
        random_state._state.update(saved)


def _kw(**kw):
    kw.setdefault("max_num_seqs", 8)
    kw.setdefault("block_size", 8)
    kw.setdefault("max_model_len", 64)
    kw.setdefault("max_prefill_tokens", 256)
    kw.setdefault("prefill_token_bucket", 64)
    return kw


def _port(pair, **kw):
    return LLMEngine(pair.tm, device="cpu", **_kw(**kw))


def _jax(pair, **kw):
    return JaxEngine(pair.jm, **_kw(**kw))


def _audit_stream(n=16):
    rng = np.random.RandomState(7)
    shapes = [(4, 8), (9, 8), (13, 6)]
    return [(rng.randint(0, VOCAB, shapes[i % 3][0]).tolist(),
             shapes[i % 3][1]) for i in range(n)]


def _drive(eng, reqs):
    rids = [eng.add_request(p, max_new_tokens=mx) for p, mx in reqs]
    outs = eng.run()
    assert sorted(outs) == sorted(rids)
    return [(tuple(outs[r].generated), outs[r].finish_reason) for r in rids]


@pytest.fixture(scope="module")
def audit(pair):
    """(engine, outputs) of the audit stream by (package, variant,
    overlap), each run once."""
    cache = {}

    def get(pkg, variant, overlap):
        key = (pkg, variant, overlap)
        if key not in cache:
            make = _port if pkg == "port" else _jax
            eng = make(pair, overlap=overlap, **VARIANTS[variant])
            cache[key] = (eng, _drive(eng, _audit_stream()))
        return cache[key]

    return get


def _counters(eng):
    return {k: getattr(eng.stats, k) for k in COUNTERS}


# ---------------------------------------------------------------------------
# the audit stream: the port against the JAX engine, overlap on and off
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("overlap", [True, False], ids=["on", "off"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_audit_stream_equals_jax_with_the_same_options(audit, variant,
                                                       overlap):
    te, to = audit("port", variant, overlap)
    je, jo = audit("jax", variant, overlap)
    assert to == jo
    # the same scheduling decisions, prestage reservations included
    assert te.blocks.stats() == je.blocks.stats()
    assert _counters(te) == _counters(je)
    assert te.pad_stats == je.pad_stats
    assert te.blocks.num_used == 0
    te.blocks.check_invariants()
    assert te._spec_pages == {} and te._inflight is None
    if "spec" in variant:
        assert te.stats.verify_steps > 0


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_overlap_on_equals_overlap_off(audit, variant):
    """Dispatch order equals completion order (a depth-1 queue), the
    prestage reserves only what the next dispatch would, and sampling keys
    depend on positions: the pipelined engine's stream is the synchronous
    one, with the same warmed buckets."""
    e_on, o_on = audit("port", variant, True)
    e_off, o_off = audit("port", variant, False)
    assert o_on == o_off
    assert e_on.compile_counts == e_off.compile_counts
    assert set(e_on.compile_counts) == {"ragged"}
    assert e_on.num_decode_programs == e_off.num_decode_programs == 1
    assert e_on.num_prefill_programs == e_off.num_prefill_programs
    assert e_on.stats.host_round_trips == e_off.stats.host_round_trips
    assert e_on.pad_stats == e_off.pad_stats
    for eng in (e_on, e_off):
        assert eng.blocks.num_used == 0
        eng.blocks.check_invariants()
    assert e_on._spec_pages == {}


def test_overlap_is_the_default_as_in_the_jax_engine(pair):
    assert _port(pair).overlap is True
    assert _jax(pair).overlap is True
    assert _port(pair, overlap=False).overlap is False
    assert _port(pair).summary()["overlap"] is True


def test_preemption_under_a_tight_pool_equals_jax(pair):
    """Pool pressure: the prestage never preempts (a short pool abandons
    it); preemptions and recomputation follow the JAX engine's."""
    rng = np.random.RandomState(1)
    reqs = [(rng.randint(0, VOCAB, rng.randint(4, 12)).tolist(), 20)
            for _ in range(8)]
    kw = dict(num_blocks=12, max_num_seqs=4, max_prefill_tokens=128,
              prefill_token_bucket=32)
    te, je = _port(pair, **kw), _jax(pair, **kw)
    assert _drive(te, reqs) == _drive(je, reqs)
    assert te.stats.preemptions == je.stats.preemptions > 0
    assert te.blocks.stats() == je.blocks.stats()
    assert te.blocks.num_used == 0 and te._spec_pages == {}


# ---------------------------------------------------------------------------
# pipeline shape: depth-1 queue, one extra draining step
# ---------------------------------------------------------------------------

def test_outputs_surface_one_step_later_and_run_drains(pair):
    prompt = np.random.RandomState(7).randint(0, VOCAB, 6).tolist()

    def steps_to_finish(make, overlap):
        eng = make(pair, overlap=overlap)
        eng.add_request(prompt, max_new_tokens=4)
        first_returns, n = [], 0
        while eng.has_unfinished():
            outs = eng.step()
            n += 1
            if n == 1:
                first_returns.extend(outs)
        assert eng.blocks.num_used == 0
        return [o.rid for o in first_returns], n

    sync_first, sync_n = steps_to_finish(_port, False)
    async_first, async_n = steps_to_finish(_port, True)
    # the first step() only fills the pipeline; the run takes exactly one
    # extra draining call, as the JAX engine's does
    assert async_first == []
    assert async_n == sync_n + 1
    assert (async_n, sync_n) == (steps_to_finish(_jax, True)[1],
                                 steps_to_finish(_jax, False)[1])


def test_has_unfinished_covers_inflight_ticket(pair):
    eng = _port(pair, overlap=True)
    eng.add_request([3, 1, 4, 1, 5], max_new_tokens=1)
    assert eng.step() == []             # dispatched, nothing completed
    assert eng._inflight is not None and eng._inflight.inflight
    assert eng.has_unfinished()
    outs = eng.step()                   # completes, dispatches nothing
    assert [o.finish_reason for o in outs] in (["length"], ["eos"])
    assert eng._inflight is None
    assert not eng.has_unfinished()


def test_overlap_off_completes_in_the_dispatching_call(pair):
    eng = _port(pair, overlap=False)
    eng.add_request([3, 1, 4, 1, 5], max_new_tokens=1)
    outs = eng.step()
    assert len(outs) == 1 and eng._inflight is None
    assert not eng.has_unfinished()


# ---------------------------------------------------------------------------
# abort while in flight: flush, drop, nothing else disturbed
# ---------------------------------------------------------------------------

def test_abort_while_inflight_drops_victim_keeps_batchmates(pair):
    rng = np.random.RandomState(19)
    pa = rng.randint(0, VOCAB, 8).tolist()
    pb = rng.randint(0, VOCAB, 11).tolist()
    base = _port(pair, overlap=False)
    base.add_request(pb, max_new_tokens=8)
    b_full = tuple(base.run().popitem()[1].generated)

    def drive(make):
        eng = make(pair, overlap=True)
        ra = eng.add_request(pa, max_new_tokens=8)
        rb = eng.add_request(pb, max_new_tokens=8)
        for _ in range(4):
            eng.step()
        assert eng._inflight is not None    # a decode launch in flight
        observed = list(next(r for r in eng._running
                             if r.rid == ra).generated)
        out_a = eng.abort(ra)
        assert out_a.finish_reason == "aborted"
        assert eng._inflight is None
        # the flush dropped the in-flight row of the victim: its output is
        # exactly the prefix the caller had observed
        assert list(out_a.generated) == observed and len(observed) < 8
        outs = eng.run()
        assert eng.blocks.num_used == 0
        eng.blocks.check_invariants()
        return list(out_a.generated), tuple(outs[rb].generated), eng

    a_port, b_port, eng = drive(_port)
    assert b_port == b_full             # as if it never shared a batch
    assert eng._spec_pages == {}
    assert (a_port, b_port) == drive(_jax)[:2]


def test_abort_flush_buffers_batchmate_finishes(pair):
    """A batchmate that finishes inside the abort's pipeline flush comes
    out of the next step() (buffered), and has_unfinished() keeps the
    driving loop alive until it does."""
    rng = np.random.RandomState(23)
    pa = rng.randint(0, VOCAB, 5).tolist()
    pb = rng.randint(0, VOCAB, 7).tolist()
    eng = _port(pair, overlap=True)
    ra = eng.add_request(pa, max_new_tokens=8)
    rb = eng.add_request(pb, max_new_tokens=1)   # done at its first token
    assert eng.step() == []                       # both prefills in flight
    out_a = eng.abort(ra)
    assert out_a.finish_reason == "aborted" and out_a.generated == []
    assert [o.rid for o in eng._pending_finished] == [rb]
    assert eng.has_unfinished()
    finishes = []
    while eng.has_unfinished():
        finishes.extend(eng.step())
    by_rid = {o.rid: o for o in finishes}
    assert len(by_rid[rb].generated) == 1
    assert by_rid[rb].finish_reason in ("length", "eos")
    assert not eng.has_unfinished()
    assert eng.blocks.num_used == 0
    eng.blocks.check_invariants()


# ---------------------------------------------------------------------------
# prestage and the two decode buffer sets
# ---------------------------------------------------------------------------

def test_prestage_stages_the_idle_buffer_set(pair):
    """While a pure-decode ticket is in flight the prestage reserves the
    next write's page and stages kv lengths and tables into the buffer
    set NOT in flight; the dispatch then launches from that set."""
    eng = _port(pair, overlap=True)
    rng = np.random.RandomState(5)
    for n in (6, 7):
        eng.add_request(rng.randint(0, VOCAB, n).tolist(), max_new_tokens=9)
    eng.step()                          # prefill in flight
    eng.step()                          # first decode launch in flight
    ticket = eng._inflight
    assert ticket.batch and not ticket.chunks
    cur = eng._d_cur
    eng._prestage()
    bi, layout = eng._prestaged
    assert bi == 1 - cur and layout == tuple(r.rid for r in ticket.batch)
    buf = eng._dbufs[bi]
    for s, req in enumerate(ticket.batch):
        assert buf.kvl[s] == req.cached + 2
        assert eng.blocks.blocks_for(req.cached + 2) <= \
            len(eng.blocks.block_table(req.rid))
        np.testing.assert_array_equal(
            buf.bt[s], eng.blocks.padded_table(req.rid, eng.nblk))
    eng._complete([])
    eng._dispatch()                     # launches from the prestaged set
    assert eng._d_cur == bi and eng._prestaged is None
    assert eng._spec_pages == {}
    eng.run()
    assert eng.blocks.num_used == 0
    eng.blocks.check_invariants()


def test_prestage_does_nothing_with_overlap_off(pair):
    eng = _port(pair, overlap=False)
    eng.add_request([5, 6, 7, 8], max_new_tokens=6)
    for _ in range(3):
        eng.step()
        assert eng._prestaged is None and eng._d_cur == 0


# ---------------------------------------------------------------------------
# precompile_buckets: the warmed ladder
# ---------------------------------------------------------------------------

def test_precompile_buckets_warms_the_jax_ladder(pair):
    te, je = _port(pair), _jax(pair)
    ladder = te.precompile_buckets()
    assert ladder == je.precompile_buckets()
    assert te.compile_counts == {"ragged": len(ladder)}
    assert te.num_decode_programs == 1
    assert te.num_prefill_programs == len(ladder) - 1
    assert te.precompile_buckets() == ladder        # idempotent
    assert te.compile_counts == {"ragged": len(ladder)}
    # every later launch lands on a warmed bucket, and the stream is the
    # one a cold engine serves
    out = _drive(te, _audit_stream())
    assert te.compile_counts == {"ragged": len(ladder)}
    cold = _port(pair)
    assert out == _drive(cold, _audit_stream())
    assert te.pad_stats == cold.pad_stats


@pytest.mark.parametrize("variant", ["f32", "int8"])
def test_precompile_writes_only_the_null_page(pair, variant):
    eng = _port(pair, **VARIANTS[variant])
    pools = [eng._kc, eng._vc] + ([eng._ks, eng._vs]
                                  if variant == "int8" else [])
    before = [t.clone() for t in pools]
    eng.precompile_buckets()
    for b, a in zip(before, pools):
        keep = torch.ones(a.shape[1], dtype=torch.bool)
        keep[NULL_BLOCK] = False
        assert torch.equal(b[:, keep], a[:, keep])
    assert eng.stats.engine_steps == 0 and eng.pad_stats["padded"] == 0
    assert eng.blocks.num_used == 0 and not eng.blocks._fresh
