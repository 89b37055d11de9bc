"""PyTorch port, the device-resident decode window (``decode_window=K``) on
the CPU, held against the JAX engine with the same options on the same
weights (tests/test_decode_window.py's cases; the window at tp=2 is in
tests/test_torch_tp_engine.py).

- Greedy K in {2, 4} x {float, int8 pages}: tokens identical to the
  synchronous K=1 engine and to the JAX engine with the same options,
  pool counters and padding equal to the JAX engine's, one "scan" key in
  ``compile_counts`` and fewer host round trips; K=1 runs no window.
- Sampled rows (plain, and with top-k and a repetition penalty, whose
  ``seen`` mask the window updates on the card) reproduce the per-step
  stream token for token; ``advance_keys`` is bit-equal to
  ``prng.request_key`` and to ``jax.random.fold_in``.
- Scheduling seams: eos mid-window, the pool squeeze that shrinks K', the
  fallback to the per-step path, abort mid-window, round-trip accounting,
  and a row that may speculate keeping the window off (the JAX engine's
  gate), while requests with speculation off still run windows.
- The trap of the walk: every window iteration calls attention with a
  non-decreasing seg, also with a row frozen in the middle of the batch,
  and frozen rows write their K/V only to the null page.  A window whose
  launch fails raises; it does not fall back."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core import random_state
from paddle_tpu.inference import LLMEngine as JaxEngine
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxModel
from paddle_tpu_torch.inference import LLMEngine, prng, sampling
from paddle_tpu_torch.inference.kv_cache import NULL_BLOCK
from paddle_tpu_torch.models.llama import (LlamaConfig,
                                           from_jax_decode_params)
from paddle_tpu_torch.ops import paged_attention as tpa
from _torch_threads import torch_threads  # noqa: F401

VOCAB = 97
CFG = JaxConfig.tiny(vocab=VOCAB, hidden=32, layers=2, heads=4, ffn=64,
                     seq=64)
VARIANTS = {"f32": {}, "int8": {"kv_dtype": "int8"}}
ATTENTION = {"f32": "ragged_paged_attention_segrel_packed",
             "int8": "ragged_paged_attention_quant_segrel_packed"}


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
    to 0 and restored afterwards (see tests/test_torch_kv_quant.py)."""
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


def _drive(eng, reqs, **req_kw):
    rids = [eng.add_request(p, max_new_tokens=mx, **req_kw)
            for p, mx in reqs]
    outs = eng.run()
    return [outs[r] for r in rids]


def _tokens(outs):
    return [(o.generated, o.finish_reason) for o in outs]


def _oracle(pair, prompt, max_new):
    out = pair.jm.generate(jnp.asarray([prompt], jnp.int32),
                           max_new_tokens=max_new, temperature=0.0)
    return np.asarray(out._data)[0, len(prompt):].tolist()


@pytest.fixture(scope="module")
def sync_ref(pair):
    """The synchronous (overlap off, K=1) port engine over the audit
    stream, by variant, run once."""
    cache = {}

    def get(variant):
        if variant not in cache:
            eng = _port(pair, overlap=False, **VARIANTS[variant])
            cache[variant] = (eng, _drive(eng, _audit_stream()))
        return cache[variant]

    return get


# ---------------------------------------------------------------------------
# greedy K in {2, 4} x {f32, int8}: K=1 and the JAX engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("k", [2, 4])
def test_window_greedy_equals_sync_and_jax(pair, sync_ref, variant, k):
    sync_eng, sync_out = sync_ref(variant)
    eng = _port(pair, decode_window=k, **VARIANTS[variant])
    out = _drive(eng, _audit_stream())
    assert _tokens(out) == _tokens(sync_out)
    je = _jax(pair, decode_window=k, **VARIANTS[variant])
    assert _tokens(_drive(je, _audit_stream())) == _tokens(out)
    # the same scheduling as the JAX engine: reservations, retirements,
    # window shrinks and drains, padding
    assert eng.blocks.stats() == je.blocks.stats()
    assert eng.pad_stats == je.pad_stats
    for key in ("host_round_trips", "decode_rounds", "decode_tokens",
                "decode_window_shrinks", "decode_window_fallbacks",
                "engine_steps"):
        assert getattr(eng.stats, key) == getattr(je.stats, key), key
    # one extra key for the window, the buckets of the K=1 engine
    counts = dict(eng.compile_counts)
    assert counts.pop("scan") == 1
    assert counts == sync_eng.compile_counts
    # fewer blocking round trips for the same tokens
    assert eng.stats.host_round_trips < sync_eng.stats.host_round_trips
    assert eng.stats.decode_window_k == k
    assert eng.blocks.num_used == 0
    eng.blocks.check_invariants()
    assert eng._spec_pages == {}


def test_k1_engine_runs_no_window(pair, sync_ref):
    sync_eng, _ = sync_ref("f32")
    assert set(sync_eng.compile_counts) == {"ragged"}
    assert sync_eng.stats.decode_window_k == 1
    eng = _port(pair)                       # overlap on, K=1
    _drive(eng, _audit_stream(4))
    assert "scan" not in eng.compile_counts


@pytest.mark.parametrize("spec_k", [4, 0], ids=["speculating", "spec-off"])
def test_speculating_rows_keep_the_window_off(pair, sync_ref, spec_k):
    """With a drafter, a row that may speculate next step keeps the window
    off (verify rows ride the per-step launch), as in the JAX engine;
    requests that ask spec_k=0 run windows again.  Greedy tokens equal the
    synchronous K=1 stream either way."""
    _, sync_out = sync_ref("f32")
    opts = dict(decode_window=4, drafter="ngram", spec_k=spec_k)
    eng, je = _port(pair, **opts), _jax(pair, **opts)
    windows = []
    launch = eng._launch_window
    eng._launch_window = lambda iters, *a: windows.append(iters) \
        or launch(iters, *a)
    out = _drive(eng, _audit_stream())
    assert _tokens(out) == _tokens(sync_out)
    assert _tokens(_drive(je, _audit_stream())) == _tokens(out)
    for key in ("host_round_trips", "decode_rounds", "verify_steps",
                "draft_proposed", "engine_steps"):
        assert getattr(eng.stats, key) == getattr(je.stats, key), key
    if spec_k:
        assert windows == [] and "scan" not in eng.compile_counts
        assert eng.stats.verify_steps > 0
    else:
        assert windows and eng.compile_counts["scan"] == 1
        assert eng.stats.verify_steps == 0
    assert eng.blocks.num_used == 0 and eng._spec_pages == {}


def test_window_with_overlap_off_equals_overlap_on(pair, sync_ref):
    _, sync_out = sync_ref("f32")
    off = _port(pair, decode_window=4, overlap=False)
    on = _port(pair, decode_window=4)
    assert _tokens(_drive(off, _audit_stream())) == _tokens(sync_out) \
        == _tokens(_drive(on, _audit_stream()))
    assert off.stats.host_round_trips == on.stats.host_round_trips


# ---------------------------------------------------------------------------
# sampled rows: keys and penalty masks carried on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("opts", [
    {"temperature": 0.8, "seed": 3},
    {"temperature": 0.9, "seed": 11, "top_k": 5, "top_p": 0.9,
     "repetition_penalty": 1.3}], ids=["plain", "topk_penalty"])
def test_window_sampled_rows_reproduce_per_step_stream(pair, opts):
    reqs = _audit_stream(6)
    sync = _port(pair, overlap=False)
    s_out = _drive(sync, reqs, **opts)
    eng = _port(pair, decode_window=4)
    w_out = _drive(eng, reqs, **opts)
    assert [o.generated for o in w_out] == [o.generated for o in s_out]
    assert eng.compile_counts.get("scan") == 1
    je = _jax(pair, decode_window=4)
    assert [o.generated for o in _drive(je, reqs, **opts)] == \
        [o.generated for o in w_out]


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 - 1, 2 ** 32 - 1])
def test_advance_keys_bit_equal_to_request_key(seed):
    rng = np.random.RandomState(seed % 1000)
    seeds = np.append(rng.randint(0, 2 ** 32, 7, dtype=np.uint64), seed)
    counters = rng.randint(0, 5000, len(seeds))
    base = torch.stack([prng.prng_key(int(s)) for s in seeds])
    keys = sampling.advance_keys(base, torch.from_numpy(counters))
    want = np.stack([prng.request_key(int(s), int(c))
                     for s, c in zip(seeds, counters)])
    np.testing.assert_array_equal(keys.numpy(), want.astype(np.int64))


def test_advance_keys_equal_jax():
    seeds = [0, 3, 2 ** 31 - 1]
    counters = np.asarray([0, 17, 4095], np.int32)
    base = np.stack([np.asarray(jax.random.PRNGKey(s)) for s in seeds])
    want = np.asarray(jax.vmap(jax.random.fold_in)(
        jnp.asarray(base), jnp.asarray(counters)))
    got = sampling.advance_keys(torch.from_numpy(base.astype(np.int64)),
                                torch.from_numpy(counters))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


# ---------------------------------------------------------------------------
# scheduling seams
# ---------------------------------------------------------------------------

def test_window_eos_retirement_mid_window(pair):
    """A row whose eos comes inside a K=4 window freezes at the eos token
    while its batchmates decode on, each equal to the dense oracle."""
    rng = np.random.RandomState(3)
    vic = rng.randint(0, VOCAB, 6).tolist()
    base = _oracle(pair, vic, 12)
    eos = base[4]
    mates = [rng.randint(0, VOCAB, n).tolist() for n in (5, 9)]
    eng = _port(pair, decode_window=4)
    rid_v = eng.add_request(vic, max_new_tokens=12, eos_token_id=eos)
    rid_m = [eng.add_request(p, max_new_tokens=12) for p in mates]
    outs = eng.run()
    got = outs[rid_v].generated
    assert outs[rid_v].finish_reason == "eos"
    assert got[-1] == eos and eos not in got[:-1]
    assert got == base[:got.index(eos) + 1]
    for rid, p in zip(rid_m, mates):
        assert outs[rid].generated == _oracle(pair, p, 12)
    assert eng.blocks.num_used == 0
    eng.blocks.check_invariants()


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_window_pool_squeeze_shrinks_kprime(pair, variant):
    """When the pool cannot cover K tokens of slack a row, the dispatch
    runs the largest K' it covers (counted), with the same tokens."""
    kw = dict(num_blocks=13, max_num_seqs=4, max_prefill_tokens=128,
              prefill_token_bucket=32, **VARIANTS[variant])
    rng = np.random.RandomState(1)
    reqs = [(rng.randint(0, VOCAB, int(rng.randint(4, 12))).tolist(), 20)
            for _ in range(4)]
    s_out = _drive(_port(pair, overlap=False, **kw), reqs)
    eng = _port(pair, decode_window=4, **kw)
    w_out = _drive(eng, reqs)
    assert _tokens(w_out) == _tokens(s_out)
    assert eng.stats.decode_window_shrinks > 0
    assert eng.stats.snapshot()["decode_window_shrinks"] > 0
    je = _jax(pair, decode_window=4, **kw)
    assert _tokens(_drive(je, reqs)) == _tokens(w_out)
    assert eng.stats.decode_window_shrinks == je.stats.decode_window_shrinks
    assert eng.compile_counts.get("scan") == 1
    assert eng.blocks.num_used == 0
    eng.blocks.check_invariants()


def test_window_pool_exhaustion_falls_back_per_step(pair):
    """When not even a 2-token window fits (2-token pages make every row's
    slack a fresh page) the step runs per-step, counted, with the same
    tokens, a preemption included."""
    kw = dict(num_blocks=35, block_size=2, max_num_seqs=4,
              max_prefill_tokens=128, prefill_token_bucket=32)
    rng = np.random.RandomState(1)
    reqs = [(rng.randint(0, VOCAB, int(rng.randint(4, 12))).tolist(), 20)
            for _ in range(4)]
    s_out = _drive(_port(pair, overlap=False, **kw), reqs)
    eng = _port(pair, decode_window=4, **kw)
    w_out = _drive(eng, reqs)
    assert _tokens(w_out) == _tokens(s_out)
    assert eng.stats.decode_window_fallbacks > 0
    assert eng.stats.snapshot()["decode_window_fallbacks"] > 0
    je = _jax(pair, decode_window=4, **kw)
    assert _tokens(_drive(je, reqs)) == _tokens(w_out)
    assert eng.stats.decode_window_fallbacks == \
        je.stats.decode_window_fallbacks
    assert eng.blocks.num_used == 0
    eng.blocks.check_invariants()


def test_abort_mid_window_drops_uncommitted_tokens(pair):
    """abort() of a row inside an in-flight window reports the tokens
    observable at the last completed step; the survivors finish as in the
    synchronous run."""
    reqs = _audit_stream(4)
    s_out = _drive(_port(pair, overlap=False), reqs)
    eng = _port(pair, decode_window=4)
    rids = [eng.add_request(p, max_new_tokens=mx) for p, mx in reqs]
    outs = {}
    for _ in range(3):                  # prefill, then windows in flight
        for fo in eng.step():
            outs[fo.rid] = fo
    assert eng._inflight is not None and eng._inflight.window > 1
    victim = next(r for r in eng._running if r.rid == rids[0])
    observed = list(victim.generated)
    aborted = eng.abort(rids[0])
    assert aborted.finish_reason == "aborted"
    assert list(aborted.generated) == observed
    while eng.has_unfinished():
        for fo in eng.step():
            outs[fo.rid] = fo
    for rid, ref in list(zip(rids, s_out))[1:]:
        assert outs[rid].generated == ref.generated
        assert outs[rid].finish_reason == ref.finish_reason
    assert eng.blocks.num_used == 0
    eng.blocks.check_invariants()


def test_window_stats_round_trip_accounting(pair):
    """host_round_trips counts completions and decode_rounds per-row decode
    positions: about one trip a round per-step, about 1/K in windows."""
    reqs = _audit_stream(8)
    eng = _port(pair, decode_window=4)
    _drive(eng, reqs)
    s = eng.stats.snapshot()
    assert 0 < s["host_round_trips"] < s["decode_rounds"]
    assert s["tokens_per_launch"] > 1.0
    assert s["decode_window_k"] == 4
    sync = _port(pair, overlap=False)
    _drive(sync, reqs)
    assert sync.stats.host_round_trips >= sync.stats.decode_rounds


# ---------------------------------------------------------------------------
# the walk's trap: seg non-decreasing, frozen rows' writes on the null page
# ---------------------------------------------------------------------------

def test_decode_window_segments():
    active = torch.tensor([True, False, True, False])
    kvl = torch.tensor([9, 4, 17, 0], dtype=torch.int32)
    seg, rel = tpa.decode_window_segments(active, kvl)
    assert seg.dtype == rel.dtype == torch.int32
    assert seg.tolist() == [0, 1, 2, 3]
    assert rel.tolist() == [8, 0, 16, 0]


def _staggered(pair, variant, overlap=True, k=4):
    """An engine holding three rows whose middle one freezes mid-window
    (its budget runs out two tokens into a K=4 window)."""
    eng = _port(pair, decode_window=k, max_num_seqs=4, overlap=overlap,
                enable_prefix_caching=False, **VARIANTS[variant])
    rng = np.random.RandomState(12)
    for n, mx in ((5, 11), (7, 3), (6, 11)):
        eng.add_request(rng.randint(0, VOCAB, n).tolist(), max_new_tokens=mx)
    return eng


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_window_seg_never_falls_with_a_frozen_middle_row(pair, variant,
                                                          monkeypatch):
    """The walk writes NaN over its whole output where seg falls; the
    JAX window sends a frozen row to seg = B (e.g. [0, 8, 2]).  The port
    keeps seg = row index at every window iteration."""
    seen_active, segs = [], []
    segments = tpa.decode_window_segments
    attention = getattr(tpa, ATTENTION[variant])

    def record_segments(active, kv_lens):
        seen_active.append(active.clone())
        return segments(active, kv_lens)

    def checked(q, *rest):
        seg = rest[-2]
        segs.append(seg.clone())
        assert bool((seg[1:] >= seg[:-1]).all()), seg
        return attention(q, *rest)

    monkeypatch.setattr(tpa, "decode_window_segments", record_segments)
    monkeypatch.setattr(tpa, ATTENTION[variant], checked)
    eng = _staggered(pair, variant)
    outs = eng.run()
    ref = _staggered(pair, variant, overlap=False, k=1)
    assert [o.generated for o in outs.values()] == \
        [o.generated for o in ref.run().values()]
    assert segs and eng.stats.quarantined == 0
    # some iteration ran with the middle row frozen between live ones
    assert any(a[:3].tolist() == [True, False, True] for a in seen_active)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_frozen_rows_write_only_the_null_page(pair, variant):
    """Each window launch changes the pools only at the positions its live
    rows committed (float pages: those slots; int8 pages: the pages
    holding them, which re-encode when their scale grows) and on the null
    page: a frozen row or an empty slot writes nowhere else."""
    eng = _staggered(pair, variant, overlap=False)
    bs = eng.block_size
    launch, launched = eng._launch_window, []

    def counted(iters, *args):
        # the tables as launched: the window reserved its slack already
        launched.append((iters, {r.rid: list(eng.blocks.block_table(r.rid))
                                 for r in eng._running}))
        return launch(iters, *args)

    eng._launch_window = counted
    windows = frozen = 0
    while eng.has_unfinished():
        rows = [(r, r.cached, len(r.generated)) for r in eng._running]
        before = (eng._kc.clone(), eng._vc.clone())
        n_launched = len(launched)
        eng.step()                      # overlap off: launch and drain
        if len(launched) == n_launched:
            continue
        windows += 1
        allowed = set()
        iters, tables = launched[-1]
        for req, cached, n_gen in rows:
            m = len(req.generated) - n_gen
            frozen += m < iters
            for pos in range(cached, cached + m):
                page = tables[req.rid][pos // bs]
                if variant == "int8":
                    allowed.update((page, s) for s in range(bs))
                else:
                    allowed.add((page, pos % bs))
        for old, new in zip(before, (eng._kc, eng._vc)):
            # [L, NB, H_kv, bs, D] -> changed (page, slot) pairs
            changed = (old != new).any(-1).any(2).any(0)
            pairs = {(int(p), int(s))
                     for p, s in torch.nonzero(changed).tolist()}
            assert {x for x in pairs if x[0] != NULL_BLOCK} <= allowed
    assert windows > 0 and frozen > 0
    assert eng.blocks.num_used == 0


def test_window_launch_failure_raises(pair, monkeypatch):
    """No fallback hides a failed window: the error reaches the caller."""
    eng = _port(pair, decode_window=4)
    eng.add_request([1, 2, 3, 4, 5], max_new_tokens=10)
    eng.step()                          # prefill in flight
    eng.step()                          # first token; a window launches

    def broken(*args):
        raise RuntimeError("paged attention kernel launch failed")

    monkeypatch.setattr(tpa, "ragged_paged_attention_segrel_packed", broken)
    with pytest.raises(RuntimeError, match="launch failed"):
        for _ in range(4):
            eng.step()
