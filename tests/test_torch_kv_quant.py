"""PyTorch port, quantized serving on the CPU: the int8-page attention's
plain version against the JAX package (its XLA reference and its Pallas
``_ragged_quant_kernel`` run in interpret mode), and the port's int8-KV and
int8/int4-weight engines against the JAX engine with the same options --
greedy tokens and pool counters identical on the 16-request ragged stream
(prefix cache on and off, preemption, GQA), int8 pages equal and scale
pools allclose after the run, quantized weight pools bit-identical, page
and weight bytes equal -- plus the int8 copy-on-write and fresh-page
bookkeeping.

Tolerances: attention atol = rtol = 1e-5 in float32 (the same dequantized
pages, sums in another order); scale pools rtol 1e-6 (a scale is
amax / 127 of K/V values that the two frameworks compute with f32 sums in
another order, so it may differ in its last bit; the int8 codes
quantized against it agree exactly on these streams)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.ops.pallas.paged_attention as jpa
from paddle_tpu.core import random_state
import paddle_tpu_torch.ops.paged_attention as tpa
from paddle_tpu.inference import LLMEngine as JaxEngine
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxModel
from paddle_tpu_torch.inference import LLMEngine
from paddle_tpu_torch.inference.kv_cache import NULL_BLOCK
from paddle_tpu_torch.models.llama import (LlamaConfig,
                                           from_jax_decode_params)
from _torch_threads import torch_threads  # noqa: F401

TOL = dict(atol=1e-5, rtol=1e-5)
VOCAB = 97
CFGS = {
    "mha": JaxConfig.tiny(vocab=VOCAB, hidden=32, layers=2, heads=4,
                          ffn=64, seq=64),
    "gqa": JaxConfig(vocab_size=VOCAB, hidden_size=32, intermediate_size=64,
                     num_hidden_layers=2, num_attention_heads=4,
                     num_key_value_heads=2, max_position_embeddings=64),
}
OPTIONS = {"kv8": {"kv_dtype": "int8"}, "w8": {"weight_dtype": "int8"},
           "w4": {"weight_dtype": "int4"},
           "kv8w4": {"kv_dtype": "int8", "weight_dtype": "int4"}}


# ---------------------------------------------------------------------------
# int8-page attention: plain version against the JAX package
# ---------------------------------------------------------------------------

def _quant_case(seed, H, Hkv, D, bs, rows, Tq, nblk):
    """An engine-shaped ragged launch over int8 pages: B rows of (query
    tokens, kv length after the launch), a [B+1]-row table whose last row
    is the null row, pages quantized per page and head as the engine
    would (scale = amax / 127)."""
    rng = np.random.RandomState(seed)
    B = len(rows)
    num_blocks = 1 + B * nblk
    cu = np.zeros(B + 1, np.int32)
    cu[1:] = np.cumsum([q for q, _ in rows])
    kvl = np.asarray([kv for _, kv in rows], np.int32)
    bt = np.zeros((B + 1, nblk), np.int32)
    pages = rng.permutation(np.arange(1, num_blocks))
    used = 0
    for r, (_, kv) in enumerate(rows):
        n = -(-kv // bs)
        bt[r, :n] = pages[used:used + n]
        used += n

    def pool():
        x = rng.randn(num_blocks, Hkv, bs, D).astype(np.float32)
        s = np.abs(x).max(axis=(2, 3)) / 127.0
        q8 = np.clip(np.round(x / s[:, :, None, None]), -127, 127)
        return q8.astype(np.int8), s.astype(np.float32)

    kc, ks = pool()
    vc, vs = pool()
    q = rng.randn(Tq, H, D).astype(np.float32)
    return q, kc, vc, ks, vs, bt, cu, kvl


LAYOUTS = {
    "mixed": ([(6, 6), (3, 11), (1, 9), (1, 1)], 16, 3),
    "decode": ([(1, 5), (1, 17), (1, 24), (1, 2)], 4, 3),
    "empty_rows": ([(2, 10), (0, 0), (1, 3)], 8, 2),
}


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("shape", [(4, 4, 64, 8), (4, 2, 64, 8),
                                   (8, 2, 128, 16)],
                         ids=lambda s: "H%dKV%dD%dbs%d" % s)
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_quant_plain_version_matches_jax_reference(layout, shape):
    H, Hkv, D, bs = shape
    rows, Tq, nblk = LAYOUTS[layout]
    q, kc, vc, ks, vs, bt, cu, kvl = _quant_case(
        1, H, Hkv, D, bs, rows, Tq, max(nblk, -(-24 // bs)))
    seg, rel = jpa.ragged_segments(jnp.asarray(cu), jnp.asarray(kvl), Tq)
    ref = jpa.ragged_paged_reference_quant_segrel(
        *map(jnp.asarray, (q, kc, vc, ks, vs, bt)), seg, rel)
    tq, tkc, tvc, tks, tvs, tbt, tcu, tkvl = _torch(q, kc, vc, ks, vs, bt,
                                                    cu, kvl)
    tseg, trel = tpa.ragged_segments(tcu, tkvl, Tq)
    out = tpa.ragged_paged_attention_quant_segrel_packed(
        tq, tkc, tvc, tks, tvs, tbt, tseg, trel)
    assert out.shape == (Tq, H, D) and out.dtype == torch.float32
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.fixture
def _interpret():
    old = jpa.INTERPRET
    jpa.INTERPRET = True
    yield
    jpa.INTERPRET = old


@pytest.mark.parametrize("layout", ["mixed", "empty_rows"])
@pytest.mark.parametrize("shape", [(4, 2, 64, 8), (4, 4, 64, 8)],
                         ids=["gqa", "mha"])
def test_quant_plain_version_matches_pallas_kernel_interpreted(
        _interpret, layout, shape):
    H, Hkv, D, bs = shape
    rows, Tq, nblk = LAYOUTS[layout]
    q, kc, vc, ks, vs, bt, cu, kvl = _quant_case(2, H, Hkv, D, bs, rows,
                                                 Tq, nblk)
    seg, rel = jpa.ragged_segments(jnp.asarray(cu), jnp.asarray(kvl), Tq)
    kern = jpa.ragged_paged_attention_quant_segrel_packed(
        *map(jnp.asarray, (q, kc, vc, ks, vs, bt)), seg, rel)
    tq, tkc, tvc, tks, tvs, tbt, tcu, tkvl = _torch(q, kc, vc, ks, vs, bt,
                                                    cu, kvl)
    tseg, trel = tpa.ragged_segments(tcu, tkvl, Tq)
    out = tpa.ragged_paged_attention_quant_segrel(tq, tkc, tvc, tks, tvs,
                                                  tbt, tseg, trel)
    live = np.arange(Tq) < cu[-1]          # pad rows: garbage on both sides
    np.testing.assert_allclose(out.numpy()[live], np.asarray(kern)[live],
                               **TOL)


def test_quant_plain_version_with_bf16_q_computes_in_f32():
    """bf16 q: the plain version dequantizes to f32, computes in f32 and
    rounds only its output, so it is the f32 result rounded once."""
    rows, Tq, nblk = LAYOUTS["mixed"]
    ops = _torch(*_quant_case(3, 4, 2, 64, 8, rows, Tq, nblk))
    seg, rel = tpa.ragged_segments(ops[6], ops[7], Tq)
    q16 = ops[0].to(torch.bfloat16)
    out16 = tpa.ragged_paged_attention_quant_segrel_packed(
        q16, *ops[1:6], seg, rel)
    out32 = tpa.ragged_paged_attention_quant_segrel_packed(
        q16.float(), *ops[1:6], seg, rel)
    assert out16.dtype == torch.bfloat16
    np.testing.assert_array_equal(out16.float().numpy(),
                                  out32.to(torch.bfloat16).float().numpy())


def _quant_operands():
    rows, Tq, nblk = LAYOUTS["mixed"]
    q, kc, vc, ks, vs, bt, cu, kvl = _torch(
        *_quant_case(4, 4, 2, 64, 8, rows, Tq, nblk))
    seg, rel = tpa.ragged_segments(cu, kvl, Tq)
    return [q, kc, vc, ks, vs, bt, seg, rel]


def test_quant_cpu_tensors_never_count_and_kernel_refuses_them():
    tpa.quant_launch_count = tpa.launch_count = 0
    ops = _quant_operands()
    np.testing.assert_array_equal(
        tpa.ragged_paged_attention_quant_segrel_packed(*ops).numpy(),
        tpa.ragged_paged_reference_quant_segrel(*ops).numpy())
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        tpa._launch_quant_kernel(*ops)
    assert tpa.quant_launch_count == tpa.launch_count == 0


@pytest.mark.parametrize("name", [
    "float_caches", "int8_q", "scales_f16", "scales_shape",
    "noncontiguous_scales", "int64_table"])
def test_quant_kernel_wrapper_rejects_bad_operands(name):
    ops = _quant_operands()
    if name == "float_caches":
        ops[1], ops[2] = ops[1].float(), ops[2].float()
    elif name == "int8_q":
        ops[0] = ops[0].to(torch.int8)
    elif name == "scales_f16":
        ops[3] = ops[3].half()
    elif name == "scales_shape":
        ops[3] = ops[3][:-1]
    elif name == "noncontiguous_scales":
        ops[4] = ops[4].t().contiguous().t()
    elif name == "int64_table":
        ops[5] = ops[5].long()
    with pytest.raises(ValueError,
                       match="int8-page ragged paged attention kernel"):
        tpa._launch_quant_kernel(*ops)


# ---------------------------------------------------------------------------
# the quantized engines against the JAX engine
# ---------------------------------------------------------------------------

class Pair:
    """One JAX model and its weights carried into the port."""

    def __init__(self, jcfg):
        self.jm = JaxModel(jcfg)
        params = jax.tree.map(np.asarray, self.jm.decode_params())
        cfg = LlamaConfig(**{k: getattr(jcfg, k)
                             for k in LlamaConfig.__dataclass_fields__})
        self.tm = from_jax_decode_params(cfg, params, device="cpu")


@pytest.fixture(scope="module")
def pairs():
    """The models, drawn from the JAX package's global random state seeded
    to 0 and restored afterwards.  Unseeded, that state takes its root key
    from numpy's entropy, so every process tested other weights; torch and
    XLA round their f32 norms, matmuls, rotary sin/cos and exp apart by an
    ulp or two, and on some weight draws a K/V value sat within those ulps
    of a .5 tie of round(x / scale), flipping one int8 code.  A fixed draw
    makes the exact comparison repeatable."""
    saved = dict(random_state._state)
    random_state.seed(0)
    try:
        return {k: Pair(c) for k, c in CFGS.items()}
    finally:
        random_state._state.update(saved)


def _kw(**kw):
    kw.setdefault("max_num_seqs", 4)
    kw.setdefault("block_size", 8)
    kw.setdefault("max_model_len", 64)
    kw.setdefault("max_prefill_tokens", 128)
    kw.setdefault("prefill_token_bucket", 32)
    return kw


def _serve_both(pair, requests, **kw):
    """The same requests through the JAX engine and the port, both
    synchronous (overlap=False), with the same options."""
    je = JaxEngine(pair.jm, overlap=False, **_kw(**kw))
    te = LLMEngine(pair.tm, device="cpu", overlap=False, **_kw(**kw))
    for p, mx in requests:
        assert je.add_request(p, max_new_tokens=mx) == \
            te.add_request(p, max_new_tokens=mx)
    return je, te, je.run(), te.run()


def _ragged_stream(seed=7, n=16):
    rng = np.random.RandomState(seed)
    shapes = [(4, 8), (9, 8), (13, 6)]
    return [(rng.randint(0, VOCAB, shapes[i % 3][0]).tolist(),
             shapes[i % 3][1]) for i in range(n)]


def _assert_identical(requests, je, te, jo, to):
    assert sorted(jo) == sorted(to) == list(range(len(requests)))
    for rid in range(len(requests)):
        assert to[rid].generated == jo[rid].generated, rid
        assert to[rid].finish_reason == jo[rid].finish_reason
    assert te.blocks.stats() == je.blocks.stats()
    for k in ("preemptions", "admitted", "retired", "cache_hit_tokens",
              "cow_copies", "prefill_tokens", "decode_tokens"):
        assert getattr(te.stats, k) == getattr(je.stats, k), k
    assert te.blocks.num_used == 0
    assert te.pad_stats == je.pad_stats
    assert te.kv_page_bytes() == je.kv_page_bytes()
    assert te.weight_bytes_resident() == je.weight_bytes_resident()
    if te.kv_dtype == "int8":
        _assert_kv_pools_match(je, te)
    if te.weight_dtype != "float32":
        _assert_weight_pools_identical(je, te)


def _assert_kv_pools_match(je, te):
    """int8 pages equal on every page but the null page (pad tokens race
    on its slot 0), scale pools allclose on every page."""
    for jp, tp in ((je._kc, te._kc), (je._vc, te._vc)):
        jp, tp = np.asarray(jp), tp.numpy()
        assert tp.dtype == np.int8
        live = np.arange(jp.shape[1]) != NULL_BLOCK
        np.testing.assert_array_equal(tp[:, live], jp[:, live])
    for js, ts in ((je._ks, te._ks), (je._vs, te._vs)):
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6,
                                   atol=0)


def _assert_weight_pools_identical(je, te):
    jl, tl = je.params["layers"], te.params["layers"]
    assert sorted(jl) == sorted(tl)
    for k in jl:
        np.testing.assert_array_equal(tl[k].numpy(), np.asarray(jl[k]), k)
    assert sorted(je.params) == sorted(te.params)
    for k in ("embed_q", "embed_s", "norm_f", "head_q", "head_s"):
        np.testing.assert_array_equal(te.params[k].numpy(),
                                      np.asarray(je.params[k]), k)


@pytest.mark.parametrize("caching", [True, False], ids=["cache", "nocache"])
@pytest.mark.parametrize("opts", list(OPTIONS))
def test_ragged_stream_identical_to_jax(pairs, opts, caching):
    """The 16-request ragged stream through 8 slots."""
    reqs = _ragged_stream()
    out = _serve_both(pairs["mha"], reqs, max_num_seqs=8,
                      max_prefill_tokens=256, prefill_token_bucket=64,
                      enable_prefix_caching=caching, **OPTIONS[opts])
    _assert_identical(reqs, *out)


@pytest.mark.parametrize("opts", ["kv8", "w8", "kv8w4"])
def test_gqa_stream_identical_to_jax(pairs, opts):
    reqs = _ragged_stream(seed=3, n=10)
    _assert_identical(reqs, *_serve_both(pairs["gqa"], reqs,
                                         **OPTIONS[opts]))


@pytest.mark.parametrize("opts", ["kv8", "w4"])
def test_preemption_and_shared_prefixes_stay_identical(pairs, opts):
    """A tight pool (preemption, recompute over parked pages) and a
    shared system prompt (prefix-cache hits, copy-on-write)."""
    rng = np.random.RandomState(11)
    system = rng.randint(0, VOCAB, 20).tolist()
    reqs = [(system + rng.randint(0, VOCAB, int(n)).tolist(), 12)
            for n in rng.randint(1, 8, 6)]
    reqs += [(rng.randint(0, VOCAB, rng.randint(4, 12)).tolist(), 20)
             for _ in range(4)]
    je, te, jo, to = _serve_both(pairs["mha"], reqs, num_blocks=12,
                                 **OPTIONS[opts])
    _assert_identical(reqs, je, te, jo, to)
    assert te.stats.preemptions > 0 and te.stats.cache_hit_tokens > 0


def test_engines_without_a_run_agree_on_bytes(pairs):
    for opts in OPTIONS.values():
        je = JaxEngine(pairs["gqa"].jm, overlap=False, **_kw(**opts))
        te = LLMEngine(pairs["gqa"].tm, device="cpu", overlap=False,
                       **_kw(**opts))
        assert te.kv_page_bytes() == je.kv_page_bytes(), opts
        assert te.weight_bytes_resident() == je.weight_bytes_resident()
        assert te.summary()["kv_dtype"] == opts.get("kv_dtype", "float32")
        assert te.summary()["weight_dtype"] == \
            opts.get("weight_dtype", "float32")


# ---------------------------------------------------------------------------
# int8 copy-on-write and fresh pages
# ---------------------------------------------------------------------------

def test_cow_copies_the_scale_rows(pairs):
    eng = LLMEngine(pairs["mha"].tm, device="cpu", kv_dtype="int8", **_kw())
    eng._kc[:, 3] = 7
    eng._vc[:, 3] = -5
    eng._ks[:, 3] = 0.25
    eng._vs[:, 3] = 0.5
    eng._apply_cow(3, 4)
    assert (eng._kc[:, 4] == 7).all() and (eng._vc[:, 4] == -5).all()
    assert (eng._ks[:, 4] == 0.25).all() and (eng._vs[:, 4] == 0.5).all()
    assert (eng._ks[:, 5] == 0).all()


def test_cow_destination_is_not_fresh_and_reused_pages_are(pairs):
    """A shared page written by one sharer is copied (with its scales) to
    a page that must not have its scales reset; a page freed and handed
    out again must."""
    eng = LLMEngine(pairs["mha"].tm, device="cpu", kv_dtype="int8",
                    **_kw(max_num_seqs=2))
    bm = eng.blocks
    ids = list(range(8))
    bm.acquire("a", ids)
    bm.commit_prefill("a", 8)
    bm.free("a")                                 # park the full page
    assert bm.acquire("b", ids + [50]) == 8
    assert bm.acquire("c", ids + [70]) == 8
    eng._consume_fresh()
    bm.truncate("b", 6)                          # roll back into the page
    src, dst = bm.cow_if_shared("b", 6)
    eng._apply_cow(src, dst)
    assert dst not in eng._consume_fresh()
    assert len(eng._consume_fresh()) == 0        # draining consumes
    taken = set(bm.block_table("c"))
    bm.free("b")
    bm.free("c")
    bm.evict_parked(bm.num_cached)
    bm.allocate("d", 4 * len(taken))
    assert taken & set(eng._consume_fresh().tolist())


def test_int8_launch_zeroes_fresh_scale_rows_only(pairs):
    """The fresh pages' scale rows reset at the launch that consumes
    them; other pages' rows are untouched, and a decode-only launch
    drains the fresh set too."""
    eng = LLMEngine(pairs["mha"].tm, device="cpu", kv_dtype="int8", **_kw())
    eng._ks[:] = 3.0
    eng._vs[:] = 3.0
    eng.add_request(list(range(5)), max_new_tokens=12)
    eng.step()                                   # prefill
    (page,) = eng.blocks.block_table(0)
    assert 0 < float(eng._ks[0, page].max()) < 3.0
    assert float(eng._ks[0, page + 1].min()) == 3.0
    eng.blocks.ensure(0, 9)                      # a page taken between
    assert eng.blocks.block_table(0)[1] in eng.blocks._fresh
    eng.step()                                   # a pure-decode launch
    assert not eng.blocks._fresh
    new = eng.blocks.block_table(0)[1]
    assert (eng._ks[:, new] == 0).all() and (eng._vs[:, new] == 0).all()
