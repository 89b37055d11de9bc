"""PyTorch port, speculative decoding on the CPU, held against the JAX
package on the same weights (tests/test_spec_decode.py's cases).

- ``BlockManager.truncate``'s rollback: tail pages, errors, hash scrubbing,
  shared pages, and the randomized pool fuzz with verify rounds.
- The drafters and the host acceptance: ``NGramDrafter`` and
  ``verify_and_accept`` as the reference's, and equal to the JAX
  package's on random inputs; ``sampling.target_dist`` bit-equal to the
  JAX function on random rows with penalty, top-k and top-p.
- The engine: ``drafter="ngram"`` at spec_k 4 and a ``DraftModelDrafter``
  (self-draft), each with the prefix cache on and off and with float and
  int8 pages, and under a tight pool that preempts: generated tokens,
  finish reasons, the spec counters, ``pad_stats`` and the bucket ladder
  equal to the JAX engine's with the same options, the verify logits
  within 1e-5 relative of its, and greedy spec on equal to spec off.  A
  sampled request equals the JAX engine's token for token.
- eos inside a draft window, auto-disable on a hopeless drafter, the
  logit chain through add_request."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core import random_state
from paddle_tpu.inference import DraftModelDrafter as JaxDraftModelDrafter
from paddle_tpu.inference import LLMEngine as JaxEngine
from paddle_tpu.inference import NGramDrafter as JaxNGramDrafter
from paddle_tpu.inference import sampling as jax_sampling
from paddle_tpu.inference.spec_decode import \
    verify_and_accept as jax_verify_and_accept
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxModel
from paddle_tpu_torch.inference import (BlockManager, DraftModelDrafter,
                                        LLMEngine, NGramDrafter, sampling)
from paddle_tpu_torch.inference.kv_cache import BlockPoolExhausted
from paddle_tpu_torch.inference.spec_decode import (Drafter,
                                                    verify_and_accept)
from paddle_tpu_torch.models.llama import (LlamaConfig,
                                           from_jax_decode_params)
from _torch_threads import torch_threads  # noqa: F401

VOCAB = 97
CFG = JaxConfig.tiny(vocab=VOCAB, hidden=32, layers=2, heads=4, ffn=64,
                     seq=64)
SPEC_COUNTERS = ("draft_proposed", "draft_accepted", "rollback_tokens",
                 "rollback_pages", "verify_steps", "spec_disables",
                 "preemptions")


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
    kw.setdefault("max_num_seqs", 4)
    kw.setdefault("block_size", 8)
    kw.setdefault("max_model_len", 64)
    kw.setdefault("max_prefill_tokens", 128)
    kw.setdefault("prefill_token_bucket", 32)
    return kw


def _port(pair, **kw):
    return LLMEngine(pair.tm, device="cpu", **_kw(**kw))


def _jax(pair, **kw):
    return JaxEngine(pair.jm, **_kw(**kw))


def _oracle(pair, prompt, max_new, **kw):
    out = pair.jm.generate(jnp.asarray([prompt], jnp.int32),
                           max_new_tokens=max_new, temperature=0.0, **kw)
    return np.asarray(out._data)[0, len(prompt):].tolist()


def _spec_stream(rng, n=16):
    """Ragged requests; half repetitive (prompt lookup wins), half random
    (drafts mostly rejected: rollbacks)."""
    reqs = []
    for i in range(n):
        if i % 2 == 0:
            motif = rng.randint(0, VOCAB, rng.randint(2, 4)).tolist()
            p = (motif * 8)[: rng.randint(6, 14)]
        else:
            p = rng.randint(0, VOCAB, rng.randint(4, 12)).tolist()
        reqs.append((p, int(rng.randint(8, 24))))
    return reqs


def _run_stream(eng, reqs):
    rids = [eng.add_request(p, max_new_tokens=mn) for p, mn in reqs]
    outs = eng.run()
    eng.blocks.check_invariants()
    return [(outs[r].generated, outs[r].finish_reason) for r in rids]


def _counters(eng):
    return {k: getattr(eng.stats, k) for k in SPEC_COUNTERS}


# ---------------------------------------------------------------------------
# BlockManager.truncate: pages, refcounts, hash scrubbing
# ---------------------------------------------------------------------------

def test_truncate_releases_tail_pages():
    bm = BlockManager(10, 4, enable_prefix_caching=False)
    assert bm.allocate("a", 14)                   # 4 pages
    assert bm.truncate("a", 6) == 2               # back to 2 pages
    assert len(bm.block_table("a")) == 2
    assert bm.truncate("a", 6) == 0               # no-op
    assert bm.ensure("a", 14)                     # regrow after rollback
    assert len(bm.block_table("a")) == 4
    bm.check_invariants()


def test_truncate_errors():
    bm = BlockManager(10, 4, enable_prefix_caching=True)
    with pytest.raises(ValueError, match="unknown"):
        bm.truncate("ghost", 0)
    bm.acquire("a", [1, 2, 3, 4, 5])
    with pytest.raises(ValueError, match="-1"):
        bm.truncate("a", -1)
    with pytest.raises(ValueError):
        bm.truncate("a", 99)                      # beyond the table
    bm.check_invariants()


def test_truncate_scrubs_private_page_hashes():
    """A committed full page rolled back and rewritten: its original
    content hash is gone, so match_prefix never serves rolled-back K/V."""
    bm = BlockManager(12, 4, enable_prefix_caching=True)
    ids = list(range(8))
    bm.acquire("a", ids)
    bm.commit_prefill("a", 8)                     # pages [0:4), [4:8)
    assert bm.truncate("a", 6) == 0               # mid page 2: no page drop
    bm.commit_decode_token("a", 60)               # rewrite slot 6
    bm.commit_decode_token("a", 61)               # rewrite slot 7 -> full
    bm.free("a")
    assert bm.match_prefix(ids + [99]) == 4
    assert bm.match_prefix(ids[:6] + [60, 61, 99]) == 8
    bm.check_invariants()


def test_truncate_shared_page_never_serves_rolled_back_kv():
    """Truncating into a SHARED page keeps the other owner's content
    registered; the truncating sequence's rewrites go through
    copy-on-write."""
    bm = BlockManager(12, 4, enable_prefix_caching=True)
    ids = list(range(8))
    bm.acquire("a", ids)
    bm.commit_prefill("a", 8)
    bm.free("a")                                  # park both pages
    assert bm.acquire("b", ids + [50]) == 8       # shares both pages
    assert bm.acquire("c", ids + [70]) == 8
    shared = bm.block_table("b")[1]
    assert shared == bm.block_table("c")[1]
    bm.truncate("b", 6)
    assert bm.match_prefix(ids + [99]) >= 8 or bm.match_prefix(ids) == 4
    cw = bm.cow_if_shared("b", 6)
    assert cw is not None and cw[0] == shared
    assert bm.block_table("b")[1] != shared
    bm.commit_decode_token("b", 60)
    bm.commit_decode_token("b", 61)
    bm.free("c")
    bm.free("b")
    assert bm.match_prefix(ids + [99]) == 8
    assert bm.match_prefix(ids[:6] + [60, 61, 99]) == 8
    bm.check_invariants()


def test_truncate_random_interleavings_hold_invariants():
    """The randomized pool fuzz with verify rounds (ensure for k drafts,
    truncate to a random point) in the op mix."""
    for seed in range(4):
        rng = np.random.RandomState(200 + seed)
        bm = BlockManager(num_blocks=17, block_size=4,
                          enable_prefix_caching=True)
        prefixes = [rng.randint(0, 50, rng.randint(4, 13)).tolist()
                    for _ in range(3)]
        live = {}                     # sid -> [ids, valid]
        sid_next = 0
        for _ in range(400):
            op = rng.randint(0, 5)
            if op == 0 and len(live) < 6:               # admit
                ids = list(prefixes[rng.randint(3)]) \
                    + rng.randint(0, 50, rng.randint(1, 6)).tolist()
                sid = sid_next
                sid_next += 1
                hit = bm.acquire(sid, ids)
                if hit is None:
                    if live:
                        victim = next(iter(live))
                        bm.free(victim)
                        live.pop(victim)
                else:
                    live[sid] = [list(ids), hit]
            elif op == 1 and live:                      # prefill chunk
                sid = list(live)[rng.randint(len(live))]
                ids, valid = live[sid]
                if valid < len(ids):
                    k = rng.randint(1, len(ids) - valid + 1)
                    try:
                        bm.cow_if_shared(sid, valid)
                        bm.commit_prefill(sid, k)
                        live[sid][1] = valid + k
                    except BlockPoolExhausted:
                        pass
            elif op == 2 and live:                      # decode token
                sid = list(live)[rng.randint(len(live))]
                ids, valid = live[sid]
                if valid == len(ids) and bm.ensure(sid, valid + 1):
                    try:
                        bm.cow_if_shared(sid, valid)
                    except BlockPoolExhausted:
                        continue
                    tok = int(rng.randint(0, 50))
                    bm.commit_decode_token(sid, tok)
                    live[sid][0] = ids + [tok]
                    live[sid][1] = valid + 1
            elif op == 3 and live:                      # verify round
                sid = list(live)[rng.randint(len(live))]
                ids, valid = live[sid]
                if valid == len(ids):
                    k = rng.randint(1, 5)
                    if bm.ensure(sid, valid + k + 1):
                        bm.truncate(sid, valid + rng.randint(0, k + 1))
            elif op == 4 and live:                      # retire/preempt
                sid = list(live)[rng.randint(len(live))]
                bm.free(sid)
                live.pop(sid)
            bm.check_invariants()
        for sid in list(live):
            bm.free(sid)
        bm.check_invariants()
        assert bm.num_used == 0


# ---------------------------------------------------------------------------
# drafters
# ---------------------------------------------------------------------------

def test_ngram_drafter_prompt_lookup():
    d = NGramDrafter(max_ngram=3, min_ngram=1)
    drafts, q = d.propose(0, [1, 2, 3, 4, 2, 3], k=2)
    assert drafts == [4, 2] and q is None
    drafts, _ = d.propose(0, [9, 2, 3, 4, 7, 1, 2, 3, 4], k=3)
    assert drafts == [7, 1, 2]                    # longest n-gram wins
    assert d.propose(0, [1, 2, 3, 4, 5], k=4) == ([], None)
    drafts, _ = d.propose(0, [5, 6, 7, 8, 5, 6], k=1)
    assert drafts == [7]


def test_ngram_drafter_is_stateless_hooks_are_noops():
    d = NGramDrafter()
    d.commit(0, 10)
    d.release(0)                                  # never raises
    with pytest.raises(ValueError):
        NGramDrafter(max_ngram=1, min_ngram=2)


@pytest.mark.parametrize("seed", range(4))
def test_ngram_drafter_equals_jax(seed):
    rng = np.random.RandomState(seed)
    for _ in range(50):
        motif = rng.randint(0, 6, rng.randint(2, 5)).tolist()
        ctx = (motif * 6)[: rng.randint(2, 24)] \
            + rng.randint(0, 6, rng.randint(0, 4)).tolist()
        k = int(rng.randint(1, 9))
        n = int(rng.randint(1, 4))
        assert NGramDrafter(max_ngram=n).propose(0, ctx, k) == \
            JaxNGramDrafter(max_ngram=n).propose(0, ctx, k)


# ---------------------------------------------------------------------------
# rejection-sampling acceptance and the target distribution (host math)
# ---------------------------------------------------------------------------

def _rows(*argmaxes, V=7):
    lg = np.full((len(argmaxes), V), -2.0, np.float32)
    for i, a in enumerate(argmaxes):
        lg[i, a] = 3.0
    return lg


def test_accept_greedy_all_and_bonus():
    n, emitted = verify_and_accept(_rows(4, 1, 6, 2), [4, 1, 6])
    assert n == 3 and emitted == [4, 1, 6, 2]


def test_accept_greedy_first_rejection_emits_argmax():
    n, emitted = verify_and_accept(_rows(4, 1, 6, 2), [4, 5, 6])
    assert n == 1 and emitted == [4, 1]


def test_accept_sampled_matches_target_distribution():
    """One-hot q: each emitted token is distributed as the target's
    softmax whatever the draft."""
    rng0 = np.random.RandomState(0)
    V = 5
    lg = rng0.randn(2, V).astype(np.float32) * 1.5
    e = np.exp(lg[0] - lg[0].max())
    p = e / e.sum()
    counts = np.zeros(V)
    N = 4000
    for t in range(N):
        rng = np.random.Generator(np.random.Philox(key=[7, t]))
        _, emitted = verify_and_accept(lg, [2], temperature=1.0, rng=rng)
        counts[emitted[0]] += 1
    tol = 4 * np.sqrt(p * (1 - p) / N) + 1e-3    # 4-sigma binomial
    assert np.all(np.abs(counts / N - p) <= tol), (counts / N, p)


def test_accept_sampled_respects_q_distribution():
    """Explicit q: a draft the proposer was sure of but the target
    dislikes is mostly rejected, and the resample avoids it."""
    V = 4
    lg = np.zeros((2, V), np.float32)
    lg[0] = [3.0, 0.0, 0.0, 0.0]
    q = np.zeros((1, V), np.float32)
    q[0, 3] = 1.0
    rejects = 0
    N = 800
    for t in range(N):
        rng = np.random.Generator(np.random.Philox(key=[9, t]))
        n, emitted = verify_and_accept(lg, [3], q_dists=q,
                                       temperature=1.0, rng=rng)
        if n == 0:
            rejects += 1
            assert emitted[0] != 3
    e = np.exp(lg[0] - lg[0].max())
    assert rejects / N == pytest.approx(1 - (e / e.sum())[3], abs=0.05)


@pytest.mark.parametrize("opts", [
    {},
    {"temperature": 0.8},
    {"temperature": 0.7, "top_k": 5},
    {"temperature": 1.3, "top_p": 0.6},
    {"temperature": 0.9, "top_k": 20, "top_p": 0.8, "penalty": 1.7},
    {"penalty": 1.5},
], ids=["greedy", "temp", "top_k", "top_p", "all", "greedy_penalty"])
def test_target_dist_bit_equal_to_jax(opts):
    rng = np.random.RandomState(len(str(opts)))
    for _ in range(8):
        row = (rng.randn(VOCAB) * 3).astype(np.float32)
        row[rng.randint(VOCAB)] = row.max()       # a tie at the top
        seen = rng.rand(VOCAB) < 0.3
        got = sampling.target_dist(row, seen=seen, **opts)
        want = jax_sampling.target_dist(row, seen=seen, **opts)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("temperature", [0.0, 0.9])
def test_verify_and_accept_equals_jax(temperature):
    rng = np.random.RandomState(5)
    for t in range(40):
        k = int(rng.randint(1, 6))
        lg = (rng.randn(k + 1, VOCAB) * 2).astype(np.float32)
        drafts = [int(np.argmax(lg[i])) if rng.rand() < 0.6
                  else int(rng.randint(VOCAB)) for i in range(k)]
        seen_t = rng.rand(VOCAB) < 0.2
        seen_j = seen_t.copy()
        opts = dict(temperature=temperature, top_k=10, top_p=0.9,
                    penalty=1.3)
        got = verify_and_accept(
            lg, drafts, seen=seen_t, **opts,
            rng=np.random.Generator(np.random.Philox(key=[3, t])))
        want = jax_verify_and_accept(
            lg, drafts, seen=seen_j, **opts,
            rng=np.random.Generator(np.random.Philox(key=[3, t])))
        assert got == want
        np.testing.assert_array_equal(seen_t, seen_j)


# ---------------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------------

def _drafter(kind, which, pair):
    """Engine options for a drafter kind, built for the port or JAX."""
    if kind == "ngram":
        return {"drafter": "ngram", "spec_k": 4}
    make = DraftModelDrafter if which == "port" else JaxDraftModelDrafter
    model = pair.tm if which == "port" else pair.jm
    return {"drafter": make(model, block_size=8, max_model_len=64,
                            capacity=4), "spec_k": 3}


def _logit_log(eng, log):
    """Record every verify round's logits (rid, generated so far, rows)."""
    apply = eng._apply_spec_result

    def recorded(req, drafts, qd, lg, finished):
        log.append((req.rid, len(req.generated), np.array(lg)))
        return apply(req, drafts, qd, lg, finished)
    eng._apply_spec_result = recorded


@pytest.mark.parametrize("pages", ["float", "int8"])
@pytest.mark.parametrize("cache", ["cache-on", "cache-off"])
@pytest.mark.parametrize("kind", ["ngram", "self-draft"])
def test_spec_stream_equals_jax(pair, kind, cache, pages):
    """The 16-request stream (8 with a draft model): tokens, finish
    reasons, spec counters, padding and the bucket ladder equal to the
    JAX engine's with the same options; verify logits within 1e-5 of its
    relative to each row's largest; greedy spec on equals spec off."""
    reqs = _spec_stream(np.random.RandomState(21))
    if kind == "self-draft":
        reqs = reqs[:8]
    opts = {"enable_prefix_caching": cache == "cache-on"}
    if pages == "int8":
        opts["kv_dtype"] = "int8"
    te = _port(pair, **opts, **_drafter(kind, "port", pair))
    je = _jax(pair, **opts, **_drafter(kind, "jax", pair))
    t_log, j_log = [], []
    _logit_log(te, t_log)
    _logit_log(je, j_log)
    got = _run_stream(te, reqs)
    assert got == _run_stream(je, reqs)
    assert _counters(te) == _counters(je)
    assert te.stats.draft_proposed > 0 and te.stats.verify_steps > 0
    assert te.pad_stats == je.pad_stats
    assert te.precompile_buckets() == je.precompile_buckets()
    assert te.blocks.num_used == 0 and te._spec_pages == {}
    assert [(r, n) for r, n, _ in t_log] == [(r, n) for r, n, _ in j_log]
    for (_, _, a), (_, _, b) in zip(t_log, j_log):
        scale = np.abs(b).max(-1, keepdims=True)
        assert (np.abs(a - b) / scale).max() <= 1e-5
    if pages == "float":
        off = _run_stream(_port(pair, **opts), reqs)
        assert got == off
    if kind == "self-draft":
        assert te.drafter.engine.blocks.num_used == 0


def test_spec_stream_byte_identical_greedy(pair):
    """spec on vs off vs generate(): byte-identical greedy output, with
    real acceptances and real rollbacks in the stream."""
    reqs = _spec_stream(np.random.RandomState(21))
    off = _run_stream(_port(pair), reqs)
    eng = _port(pair, drafter="ngram", spec_k=4)
    on = _run_stream(eng, reqs)
    assert on == off
    s = eng.stats
    assert s.draft_accepted > 0 and s.rollback_tokens > 0
    assert s.verify_steps > 0
    for (p, mn), (got, _) in zip(reqs[:6], on[:6]):
        assert got == _oracle(pair, p, mn)


@pytest.mark.parametrize("kind", ["ngram", "self-draft"])
def test_spec_stream_with_preemption_equals_jax(pair, kind):
    """Tight pool: speculation's extra pages and decode growth preempt;
    rolled-back and recomputed sequences match spec off and the JAX
    engine, counters included."""
    reqs = _spec_stream(np.random.RandomState(33))[:8]
    off = _run_stream(_port(pair, num_blocks=12), reqs)
    te = _port(pair, num_blocks=12, **_drafter(kind, "port", pair))
    je = _jax(pair, num_blocks=12, **_drafter(kind, "jax", pair))
    on = _run_stream(te, reqs)
    assert on == off == _run_stream(je, reqs)
    assert te.stats.preemptions > 0
    assert _counters(te) == _counters(je)
    assert te.pad_stats == je.pad_stats
    assert te.blocks.num_used == 0


def test_spec_with_prefix_cache_off_stays_exact(pair):
    reqs = _spec_stream(np.random.RandomState(5))[:8]
    off = _run_stream(_port(pair, enable_prefix_caching=False), reqs)
    eng = _port(pair, enable_prefix_caching=False, drafter="ngram",
                spec_k=4)
    assert _run_stream(eng, reqs) == off
    assert eng.stats.draft_proposed > 0


def test_spec_respects_eos_inside_draft_window(pair):
    """eos emitted mid-window cuts the emission as plain decode would."""
    rng = np.random.RandomState(3)
    motif = rng.randint(0, VOCAB, 3).tolist()
    p = (motif * 4)[:10]
    base = _oracle(pair, p, 16)
    eos = base[5]
    eng = _port(pair, drafter="ngram", spec_k=4)
    rid = eng.add_request(p, max_new_tokens=16, eos_token_id=eos)
    outs = eng.run()
    got = outs[rid].generated
    assert outs[rid].finish_reason == "eos"
    assert got[-1] == eos and eos not in got[:-1]
    assert got == base[:base.index(eos) + 1]


@pytest.mark.parametrize("opts", [
    {"temperature": 0.8},
    {"temperature": 0.9, "top_k": 12, "top_p": 0.9,
     "repetition_penalty": 1.2}], ids=["temp", "chain"])
def test_spec_sampled_equals_jax_and_reproduces(pair, opts):
    """Sampled speculation: the host acceptance RNG is keyed by (seed,
    position) as the JAX engine's is, so the stream equals its token for
    token, and a rerun reproduces it."""
    rng = np.random.RandomState(13)
    motif = rng.randint(0, VOCAB, 3).tolist()
    p = (motif * 5)[:12]

    def once(make):
        eng = make(pair, drafter="ngram", spec_k=4)
        rid = eng.add_request(p, max_new_tokens=12, seed=11, **opts)
        return eng.run()[rid].generated, eng.stats.draft_proposed

    first, proposed = once(_port)
    assert len(first) == 12 and proposed > 0
    assert (first, proposed) == once(_port) == once(_jax)


def test_spec_auto_disable_on_hopeless_drafter(pair):
    """A drafter that proposes garbage trips the acceptance floor: the
    request flips to plain decode and the output stays exact."""

    class WrongDrafter(Drafter):
        def propose(self, rid, context, k):
            return [(context[-1] + 1) % VOCAB] * k, None

    reqs = [(np.random.RandomState(9).randint(0, VOCAB, 8).tolist(), 24)]
    off = _run_stream(_port(pair), reqs)
    eng = _port(pair, drafter=WrongDrafter(), spec_k=4,
                spec_accept_floor=0.9, spec_window=8)
    assert _run_stream(eng, reqs) == off
    assert eng.stats.spec_disables >= 1
    assert eng.stats.accept_rate() < 0.9


def test_draft_model_drafter_self_draft(pair):
    """Draft model == target: every draft is the target's own argmax, so
    nearly all are accepted and the output matches plain decode."""
    drafter = DraftModelDrafter(pair.tm, block_size=8, max_model_len=64,
                                capacity=4)
    assert drafter.engine.device == torch.device("cpu")
    reqs = _spec_stream(np.random.RandomState(17))[:4]
    off = _run_stream(_port(pair), reqs)
    eng = _port(pair, drafter=drafter, spec_k=3)
    assert _run_stream(eng, reqs) == off
    s = eng.stats
    assert s.draft_proposed > 0
    assert s.draft_accepted / s.draft_proposed > 0.9
    assert drafter.engine.blocks.num_used == 0


def test_spec_options_and_request_clamp(pair):
    """spec_k clamps to max_spec_k, and to 0 without a drafter; the logit
    rows are B (max_spec_k + 1) with a drafter, and the speculation tier
    joins the ladder when it sits below the prefill bucket."""
    plain = _port(pair, spec_k=5)
    rid = plain.add_request([1, 2, 3], max_new_tokens=2)
    assert plain._waiting[-1].rid == rid and plain._waiting[-1].spec_k == 0
    assert plain._Lq == 4 and not plain._with_logits
    eng = _port(pair, drafter="ngram", spec_k=9, max_spec_k=4,
                prefill_token_bucket=64)
    eng.add_request([1, 2, 3], max_new_tokens=2)
    eng.add_request([1, 2, 3], max_new_tokens=2, spec_k=2)
    assert [r.spec_k for r in eng._waiting] == [4, 2]
    assert eng._Lq == 20 and eng._dbufs[0].samp["temps"].shape == (20,)
    assert eng._ragged_bucket(9) == 20 and eng._ragged_bucket(21) == 64
    ladder = eng.precompile_buckets()
    assert 20 in ladder
    assert ladder == _jax(pair, drafter="ngram", spec_k=9, max_spec_k=4,
                          prefill_token_bucket=64).precompile_buckets()


# ---------------------------------------------------------------------------
# the logit chain through add_request
# ---------------------------------------------------------------------------

def test_top_k1_is_greedy(pair):
    p = np.random.RandomState(41).randint(0, VOCAB, 9).tolist()
    eng = _port(pair)
    rid = eng.add_request(p, max_new_tokens=8, temperature=1.0, top_k=1)
    assert eng.run()[rid].generated == _oracle(pair, p, 8)


def test_tiny_top_p_is_greedy(pair):
    p = np.random.RandomState(43).randint(0, VOCAB, 9).tolist()
    eng = _port(pair)
    rid = eng.add_request(p, max_new_tokens=8, temperature=1.0,
                          top_p=1e-6)
    assert eng.run()[rid].generated == _oracle(pair, p, 8)


def test_repetition_penalty_matches_generate(pair):
    p = np.random.RandomState(47).randint(0, VOCAB, 9).tolist()
    want = _oracle(pair, p, 10, repetition_penalty=1.8)
    eng = _port(pair)
    rid = eng.add_request(p, max_new_tokens=10, repetition_penalty=1.8)
    assert eng.run()[rid].generated == want
    assert want != _oracle(pair, p, 10)


def test_repetition_penalty_with_speculation_matches_generate(pair):
    """The verify path applies the penalty through the host chain with an
    incrementally updated seen mask: the bytes of generate()."""
    rng = np.random.RandomState(53)
    motif = rng.randint(0, VOCAB, 3).tolist()
    p = (motif * 4)[:10]
    want = _oracle(pair, p, 12, repetition_penalty=1.5)
    eng = _port(pair, drafter="ngram", spec_k=4)
    rid = eng.add_request(p, max_new_tokens=12, repetition_penalty=1.5)
    assert eng.run()[rid].generated == want


def test_sampling_params_validated(pair):
    eng = _port(pair)
    with pytest.raises(ValueError):
        eng.add_request([1, 2], top_p=0.0)
    with pytest.raises(ValueError):
        eng.add_request([1, 2], top_k=-1)
    with pytest.raises(ValueError):
        eng.add_request([1, 2], repetition_penalty=0.0)


def test_spec_engine_without_device_raises_without_cuda(pair):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LLMEngine(pair.tm, drafter="ngram")
