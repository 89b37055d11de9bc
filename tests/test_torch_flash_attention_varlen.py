"""PyTorch port, varlen flash attention: the segment metadata, the block
bounds, the plain versions of the three varlen kernels (what the port runs
on CPU tensors and what the CUDA kernels are held to on the card) and
``flash_attn_unpadded`` against the JAX package.  The JAX side runs its
Pallas varlen kernels through the interpreter (``flash_attention.INTERPRET
= True``, as tests/test_paged_attention.py runs them) or, for shapes its
rule refuses, its segment-masked composition ``_unpadded_impl``.

Same inputs (numpy, from a seed) through both.  Tolerances (rtol and atol):
float32 2e-5 for outputs and lse, 2e-4 for gradients (the same f32 sums in
another order; the backward takes differences of them).  bfloat16 8e-3 for
outputs and gradients, one bf16 ulp at magnitude 1: both sides round p and
dS to bf16 at the same points, but the JAX kernel rounds p relative to its
running max of a 128-key block and the plain version relative to the row's
max, so single elements may differ by an ulp.  ``_segment_meta`` and the
block bounds must agree exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.nn.functional import attention as JA
from paddle_tpu.ops.pallas import flash_attention as FA
from paddle_tpu.ops.pallas import flash_attention_varlen as JV
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.functional import attention as TA
from paddle_tpu_torch.ops import flash_attention_varlen as fav
from _torch_threads import torch_threads  # noqa: F401

TOL = {"float32": (2e-5, 2e-4), "bfloat16": (8e-3, 8e-3)}   # out, grads
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def _interpret():
    prev = FA.INTERPRET
    FA.INTERPRET = True
    yield
    FA.INTERPRET = prev


def _cu(lens):
    return np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)


def _inputs(lens_q, lens_k, H, D, Hk=None, seed=0):
    """q [Tq, H, D], k/v [Tk, Hk, D], dout like q, and the two offset
    vectors, from a seed."""
    rng = np.random.RandomState(seed)
    cq, ck = _cu(lens_q), _cu(lens_k)
    Hk = H if Hk is None else Hk
    return (rng.randn(cq[-1], H, D).astype(np.float32),
            rng.randn(ck[-1], Hk, D).astype(np.float32),
            rng.randn(ck[-1], Hk, D).astype(np.float32),
            rng.randn(cq[-1], H, D).astype(np.float32), cq, ck)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


# (lens_q, lens_k, H, D): self attention where lens_k is None
CASES = {
    "packed_d64": ([7, 130, 0, 55, 64], None, 2, 64),
    "one_seq_d128": ([96], None, 2, 128),
    "d256": ([100, 28], None, 1, 256),
    "cross_keyless": ([30, 40, 50, 5], [100, 0, 60, 1], 2, 64),
}


def _case(name):
    lens_q, lens_k, H, D = CASES[name]
    return _inputs(lens_q, lens_q if lens_k is None else lens_k, H, D)


def _with_causal(cases):
    """(name, causal) pairs: causal attention pairs a query with its own
    sequence, so cross-attention cases run non-causal only."""
    return [pytest.param(n, c, id=f"{n}-{'causal' if c else 'full'}")
            for n, case in cases.items() for c in (True, False)
            if c is False or case[1] is None]


# ---------------------------------------------------------------------------
# segment metadata and block bounds: exact
# ---------------------------------------------------------------------------

META = {  # offsets, total tokens, padded length
    "packed": ([0, 7, 137, 137, 192, 256], 256, 320),
    "exact_fit": ([0, 64, 128], 128, 128),
    "tail_past_cu": ([0, 5, 9], 12, 64),
    "empty_first": ([0, 0, 70, 71], 71, 128),
}


@pytest.mark.parametrize("name", list(META))
def test_segment_meta_matches_jax(name):
    cu, total, pad = META[name]
    nseq = len(cu) - 1
    js, jr = JV._segment_meta(jnp.asarray(cu, jnp.int32), total, pad,
                              nseq + 1)
    ts, tr = fav._segment_meta(torch.tensor(cu, dtype=torch.int32), total,
                               pad, nseq + 1)
    assert ts.dtype == torch.int32 and tr.dtype == torch.int32
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


@pytest.mark.parametrize("name", list(META))
def test_segments_is_the_jax_composition_rule(name):
    """``segments``, which the port's composition and blha's prefill
    share, is the rule of the JAX ``_unpadded_impl`` and blha prefill:
    searchsorted from the right, tokens past cu[-1] in segment nseq."""
    cu, total, _ = META[name]
    jcu = jnp.asarray(cu, jnp.int32)
    pos = jnp.arange(total)
    js = jnp.searchsorted(jcu, pos, side="right") - 1
    ts, tr = fav.segments(torch.tensor(cu, dtype=torch.int32), total)
    assert ts.dtype == torch.int32 and tr.dtype == torch.int32
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(pos - jcu[js]))


BOUNDS = {  # cu_q, cu_k (Tq = cu_q[-1], Tk = cu_k[-1])
    "self": ([0, 7, 137, 137, 192, 256], [0, 7, 137, 137, 192, 256]),
    "cross": ([0, 30, 70, 120, 125], [0, 100, 100, 160, 161]),
    "one": ([0, 200], [0, 200]),
}


@pytest.mark.parametrize("blocks", [(64, 64), (64, 32), (32, 64), (128, 64),
                                    (64, 128)],
                         ids=["64x64", "64x32", "32x64", "128x64", "64x128"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("name", list(BOUNDS))
def test_block_bounds_match_jax_at_equal_block_sizes(name, causal, blocks):
    """(128, 64) is the bf16 wgmma forward's and dQ's pair: 128 queries a
    block (its metadata padded to whole blocks), 64-key tiles; (64, 128)
    the wgmma dK/dV's: 128 keys a block over 64-query tiles."""
    cu_q, cu_k = BOUNDS[name]
    block_q, block_k = blocks
    tq, tk, nseq = cu_q[-1], cu_k[-1], len(cu_q) - 1
    pad_q = -(-tq // max(64, block_q)) * max(64, block_q)
    pad_k = -(-tk // max(64, block_k)) * max(64, block_k)
    nqb, nkb = pad_q // block_q, pad_k // block_k
    jcq, jck = jnp.asarray(cu_q, jnp.int32), jnp.asarray(cu_k, jnp.int32)
    tcq = torch.tensor(cu_q, dtype=torch.int32)
    tck = torch.tensor(cu_k, dtype=torch.int32)
    jsq, jrq = JV._segment_meta(jcq, tq, pad_q, nseq)
    jsk, jrk = JV._segment_meta(jck, tk, pad_k, nseq + 1)
    tsq, trq = fav._segment_meta(tcq, tq, pad_q, nseq)
    tsk, trk = fav._segment_meta(tck, tk, pad_k, nseq + 1)
    want = (JV._block_bounds_q(jsq, jrq, jck, block_q, block_k, nkb, causal)
            + JV._block_bounds_k(jsk, jrk, jcq, block_q, block_k, nqb,
                                 causal))
    got = (fav._block_bounds_q(tsq, trq, tck, block_q, block_k, nkb, causal)
           + fav._block_bounds_k(tsk, trk, tcq, block_q, block_k, nqb,
                                 causal))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("weights", [
    [3, 1, 4, 1, 5, 9, 2, 6], [2, 2, 2, 2], [0], [0, 7, 0, 7, 1],
    list(range(40)), [5, 0, 5, 5, 0, 12, 1, 5]],
    ids=["mixed", "all_tied", "one", "ties_and_zeros", "ascending",
         "runs"])
def test_launch_order_is_heaviest_first_ties_by_index(weights):
    """``launch_order`` gives a permutation of the blocks, most key tiles
    first, equal counts in block order."""
    order = fav.launch_order(torch.tensor(weights, dtype=torch.int32))
    assert order.dtype == torch.int32 and order.shape == (len(weights),)
    assert order.tolist() == sorted(range(len(weights)),
                                    key=lambda i: (-weights[i], i))


PAIR_CASES = dict(BOUNDS, keyless=([0, 30, 70, 200], [0, 64, 64, 300]))


@pytest.mark.parametrize("name,causal", [
    pytest.param(n, c, id=f"{n}-{'causal' if c else 'full'}")
    for n, (cq, ck) in PAIR_CASES.items() for c in (True, False)
    if cq == ck or not c])
def test_pair_tiles_span_the_halves_within_the_jax_block_bounds(name,
                                                                causal):
    """A 128-query block of the wgmma forward walks the union of its two
    64-query tiles' ranges: ``pair_tiles`` counts it (brute force here),
    and the union lies inside the JAX package's bounds for 128-query
    blocks, so the kernel walks no tile the JAX kernel at that block size
    would skip."""
    cu_q, cu_k = PAIR_CASES[name]
    tq, tk, nseq = cu_q[-1], cu_k[-1], len(cu_q) - 1
    pad_q, pad_k = -(-tq // 128) * 128, -(-tk // 64) * 64
    tcq = torch.tensor(cu_q, dtype=torch.int32)
    tck = torch.tensor(cu_k, dtype=torch.int32)
    sq, rq = fav._segment_meta(tcq, tq, pad_q, nseq)
    lo, hi = fav._block_bounds_q(sq, rq, tck, 64, 64, pad_k // 64, causal)
    jsq, jrq = JV._segment_meta(jnp.asarray(cu_q, jnp.int32), tq, pad_q,
                                nseq)
    jlo, jhi = (np.asarray(x) for x in JV._block_bounds_q(
        jsq, jrq, jnp.asarray(cu_k, jnp.int32), 128, 64, pad_k // 64,
        causal))
    tiles = fav.pair_tiles(lo, hi)
    assert tiles.dtype == torch.int32 and tiles.shape == (pad_q // 128,)
    for b in range(pad_q // 128):
        walked = set()
        for w in (2 * b, 2 * b + 1):
            walked |= set(range(int(lo[w]), int(hi[w])))
        span = range(min(walked), max(walked) + 1) if walked else range(0)
        assert int(tiles[b]) == len(span)
        assert all(jlo[b] <= kt < jhi[b] for kt in span)


@pytest.mark.parametrize("name,causal", [
    pytest.param(n, c, id=f"{n}-{'causal' if c else 'full'}")
    for n, (cq, ck) in PAIR_CASES.items() for c in (True, False)
    if cq == ck or not c])
def test_pair_tiles_span_the_key_halves_within_the_jax_block_bounds(name,
                                                                    causal):
    """A 128-key block of the wgmma dK/dV walks the union of its two
    64-key tiles' query ranges (``_block_bounds_k`` at 64-query tiles):
    ``pair_tiles`` counts it (brute force here), and the union lies inside
    the JAX package's ``_block_bounds_k`` for 128-key blocks."""
    cu_q, cu_k = PAIR_CASES[name]
    tq, tk, nseq = cu_q[-1], cu_k[-1], len(cu_q) - 1
    pad_q, pad_k = -(-tq // 128) * 128, -(-tk // 128) * 128
    tcq = torch.tensor(cu_q, dtype=torch.int32)
    tck = torch.tensor(cu_k, dtype=torch.int32)
    sk, rk = fav._segment_meta(tck, tk, pad_k, nseq + 1)
    lo, hi = fav._block_bounds_k(sk, rk, tcq, 64, 64, pad_q // 64, causal)
    jsk, jrk = JV._segment_meta(jnp.asarray(cu_k, jnp.int32), tk, pad_k,
                                nseq + 1)
    jlo, jhi = (np.asarray(x) for x in JV._block_bounds_k(
        jsk, jrk, jnp.asarray(cu_q, jnp.int32), 64, 128, pad_q // 64,
        causal))
    tiles = fav.pair_tiles(lo, hi)
    assert tiles.dtype == torch.int32 and tiles.shape == (pad_k // 128,)
    for b in range(pad_k // 128):
        walked = set()
        for w in (2 * b, 2 * b + 1):
            walked |= set(range(int(lo[w]), int(hi[w])))
        span = range(min(walked), max(walked) + 1) if walked else range(0)
        assert int(tiles[b]) == len(span)
        assert all(jlo[b] <= qt < jhi[b] for qt in span)


# the backward's kernel routes: (dtype, D) -> rows a block (128: wgmma)
BWD_ROUTES = {"bf16_d64": (torch.bfloat16, 64, 128),
              "bf16_d128": (torch.bfloat16, 128, 128),
              "f32_d64": (torch.float32, 64, 64),
              "bf16_d256": (torch.bfloat16, 256, 64)}


def _heaviest_first(lo, hi):
    """Blocks of two tiles by the span of their non-empty ranges, most
    first, ties by index (brute force over numpy bounds)."""
    spans = []
    for b in range(len(lo) // 2):
        walked = set()
        for w in (2 * b, 2 * b + 1):
            walked |= set(range(int(lo[w]), int(hi[w])))
        spans.append(max(walked) - min(walked) + 1 if walked else 0)
    return sorted(range(len(spans)), key=lambda b: (-spans[b], b))


@pytest.mark.parametrize("route", list(BWD_ROUTES))
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("name", list(BOUNDS))
def test_backward_metadata_matches_jax(name, causal, route):
    """``_bwd_meta``, computed once a backward and passed to both
    launches: seg/rel padded to the route's block on both sides (as the
    JAX ``_segment_meta``), the dK/dV and dQ bounds at 64-row tiles (32-row
    walked tiles at D 256) as the JAX ``_block_bounds_k`` /
    ``_block_bounds_q``, and on the wgmma route each ``lo`` followed by
    its blocks' launch order, heaviest first."""
    cu_q, cu_k = BOUNDS[name]
    dtype, D, blk = BWD_ROUTES[route]
    tq, tk, nseq = cu_q[-1], cu_k[-1], len(cu_q) - 1
    tcq = torch.tensor(cu_q, dtype=torch.int32)
    tck = torch.tensor(cu_k, dtype=torch.int32)
    q = torch.empty((tq, 2, D), dtype=dtype)
    k = torch.empty((tk, 2, D), dtype=dtype)
    sq, rq, sk, rk, lo_k, hi_k, lo_q, hi_q = fav._bwd_meta(q, k, tcq, tck,
                                                           causal)
    pad_q, pad_k = -(-tq // blk) * blk, -(-tk // blk) * blk
    jcq, jck = jnp.asarray(cu_q, jnp.int32), jnp.asarray(cu_k, jnp.int32)
    jsq, jrq = JV._segment_meta(jcq, tq, pad_q, nseq)
    jsk, jrk = JV._segment_meta(jck, tk, pad_k, nseq + 1)
    for got, want in ((sq, jsq), (rq, jrq), (sk, jsk), (rk, jrk)):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    bt = 32 if D == 256 else 64
    jlo_k, jhi_k = (np.asarray(x) for x in JV._block_bounds_k(
        jsk, jrk, jcq, bt, 64, pad_q // bt, causal))
    jlo_q, jhi_q = (np.asarray(x) for x in JV._block_bounds_q(
        jsq, jrq, jck, 64, bt, pad_k // bt, causal))
    for lo, hi, jlo, jhi in ((lo_k, hi_k, jlo_k, jhi_k),
                             (lo_q, hi_q, jlo_q, jhi_q)):
        assert lo.dtype == torch.int32 and hi.dtype == torch.int32
        np.testing.assert_array_equal(hi.numpy(), jhi)
        np.testing.assert_array_equal(lo.numpy()[:len(jhi)], jlo)
        order = lo.numpy()[len(jhi):].tolist()
        assert order == (_heaviest_first(jlo, jhi) if blk == 128 else [])


def test_dkdv_stats_follow_the_plain_versions_rules():
    """The wgmma dK/dV kernel's copies of lse and delta: lse times log2 e
    where finite and 0 where not (a key-less row reads lse 0), +inf past
    Tq (a padded query's p is 0), delta as given and 0 past Tq."""
    lse = torch.tensor([[0.5, float("-inf"), 3.0], [float("inf"), 1.0, 2.0]])
    delta = torch.tensor([[0.25, -1.0, 2.0], [0.0, 3.0, -0.5]])
    l2, d = fav._dkdv_stats(lse, delta, 128)
    assert l2.shape == d.shape == (2, 128)
    assert l2.dtype == d.dtype == torch.float32
    want = torch.where(torch.isfinite(lse), lse * float(np.log2(np.e)), 0.0)
    torch.testing.assert_close(l2[:, :3], want, rtol=1e-7, atol=0)
    assert torch.isposinf(l2[:, 3:]).all()
    assert torch.equal(d[:, :3], delta) and (d[:, 3:] == 0).all()


def test_backward_launches_share_one_metadata(monkeypatch):
    """Each backward launch computes ``_bwd_meta`` itself when called
    alone, and takes the one it is given (no device op of its own):
    dK/dV reads seg/rel and the key tiles' bounds, dQ the same seg/rel and
    the query tiles' bounds.  The C entries are replaced by a recorder."""
    q, k, v, g, cq, ck = _inputs([70, 0, 90], [70, 0, 90], 2, 64)
    t = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v, g)]
    cu = torch.from_numpy(cq)
    lse = torch.zeros((2, q.shape[0]))
    calls, made = [], []
    real = fav._bwd_meta
    monkeypatch.setattr(fav, "_launch",
                        lambda name, ptrs, *a: calls.append((name, ptrs)))
    monkeypatch.setattr(fav, "_bwd_meta",
                        lambda *a: made.append(real(*a)) or made[-1])
    args = (*t[:3], t[3], lse, lse, cu, cu, True, 0.125)
    counts = (fav.dkdv_launch_count, fav.dq_launch_count)
    fav._launch_dkdv(*args)
    fav._launch_dq(*args)
    assert len(made) == 2
    for a, b in zip(*made):
        assert torch.equal(a, b)
    meta = real(t[0], t[1], cu, cu, True)
    fav._launch_dkdv(*args, meta=meta)
    fav._launch_dq(*args, meta=meta)
    assert len(made) == 2
    assert (fav.dkdv_launch_count, fav.dq_launch_count) == \
        (counts[0] + 2, counts[1] + 2)
    ptrs = [x.data_ptr() for x in meta]
    (n_kv, kv), (n_q, qq) = calls[2:]
    assert n_kv.endswith("dkdv") and n_q.endswith("dq")
    assert kv[6:12] == ptrs[:4] + ptrs[4:6]
    assert qq[6:12] == ptrs[:4] + ptrs[6:8]


def test_forward_pads_query_metadata_to_its_block():
    """The bf16 forward at D 64 and 128 owns 128 queries a block, so its
    query metadata is padded to a multiple of 128 (sentinel segment nseq);
    its warpgroups' bounds (64 rows each) over the padding are the JAX
    ``_block_bounds_q``'s; every other forward keeps 64-row blocks."""
    cu = torch.tensor([0, 50, 51, 180], dtype=torch.int32)
    for dtype, D, want in ((torch.bfloat16, 64, 128),
                           (torch.bfloat16, 128, 128),
                           (torch.bfloat16, 256, 64),
                           (torch.float32, 64, 64)):
        assert fav.fwd_block_q(torch.empty((180, 2, D), dtype=dtype)) == want
    seg, rel, seg_k, _ = fav._prep(180, 180, cu, cu, 128)
    assert seg.shape == (256,) and seg_k.shape == (192,)
    assert (seg[180:] == 3).all() and (seg_k[180:] == 4).all()
    jsq, jrq = JV._segment_meta(jnp.asarray(cu.numpy()), 180, 256, 3)
    np.testing.assert_array_equal(seg.numpy(), np.asarray(jsq))
    np.testing.assert_array_equal(rel.numpy(), np.asarray(jrq))
    lo, hi = fav._block_bounds_q(seg, rel, cu, 64, 64, 3, True)
    jlo, jhi = JV._block_bounds_q(jsq, jrq, jnp.asarray(cu.numpy()), 64,
                                  64, 3, True)
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))


@pytest.mark.parametrize("shape,rule", [
    (((64, 4, 64), (64, 4, 64), "float32"), True),
    (((64, 4, 128), (64, 4, 128), "bfloat16"), True),
    (((64, 4, 256), (64, 4, 256), "float32"), True),
    (((64, 4, 64), (64, 2, 64), "float32"), False),     # GQA
    (((64, 4, 32), (64, 4, 32), "float32"), False),     # head dim
    (((64, 4, 64), (64, 4, 64), "float16"), False),
    (((2, 64, 4, 64), (2, 64, 4, 64), "float32"), False),   # 4-D
], ids=["d64", "d128_bf16", "d256", "gqa", "d32", "f16", "4d"])
def test_kernel_rule_matches_jax(_interpret, shape, rule):
    qs, ks, dt = shape
    jq = jax.ShapeDtypeStruct(qs, jnp.dtype(dt))
    jk = jax.ShapeDtypeStruct(ks, jnp.dtype(dt))
    tdt = getattr(torch, dt)
    tq, tk = torch.empty(qs, dtype=tdt), torch.empty(ks, dtype=tdt)
    assert JV.use_varlen_flash(jq, jk, True) is rule
    assert fav.use_varlen_kernel(tq, tk) is rule


# ---------------------------------------------------------------------------
# plain versions against the interpreted Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,causal", _with_causal(CASES))
def test_plain_versions_match_pallas_kernels(_interpret, name, causal, dtype):
    q, k, v, g, cq, ck = _case(name)
    D = q.shape[-1]
    scale = D ** -0.5
    jx = [jnp.asarray(x, JDT[dtype]) for x in (q, k, v, g)]
    out_j, lse_j = JV._varlen_fwd(*jx[:3], jnp.asarray(cq), jnp.asarray(ck),
                                  causal, scale)
    grads_j = JV._varlen_bwd(*jx[:3], out_j, lse_j, jx[3], jnp.asarray(cq),
                             jnp.asarray(ck), causal, scale)
    tx = [torch.from_numpy(x).to(TDT[dtype]) for x in (q, k, v, g)]
    tcq, tck = torch.from_numpy(cq), torch.from_numpy(ck)
    out, lse = fav.varlen_fwd_reference(*tx[:3], tcq, tck, causal, scale)
    grads = fav.varlen_bwd_reference(*tx[:3], out, lse, tx[3], tcq, tck,
                                     causal, scale)
    tol_out, tol_grad = TOL[dtype]
    assert out.dtype == TDT[dtype] and lse.dtype == torch.float32
    assert lse.shape == (q.shape[1], q.shape[0])
    _close(out, out_j, tol_out)
    lse_j = np.asarray(lse_j)[:, 0, :q.shape[0]]
    fin = np.isfinite(lse_j)
    np.testing.assert_array_equal(np.isfinite(lse.numpy()), fin)
    assert (lse.numpy()[~fin] == -np.inf).all()
    _close(lse.numpy()[fin], lse_j[fin], 2e-5)
    for got, want, x in zip(grads, grads_j, tx[:3]):
        assert got.dtype == x.dtype and got.shape == x.shape
        _close(got, want, tol_grad)
    if not fin.all():                   # key-less rows: 0 out, 0 dq
        rows = ~fin.any(0)
        assert (out.float().numpy()[rows] == 0).all()
        assert (grads[0].float().numpy()[rows] == 0).all()


# ---------------------------------------------------------------------------
# flash_attn_unpadded: values and autograd gradients
# ---------------------------------------------------------------------------

def _jax_unpadded(q, k, v, g, cq, ck, causal, scale, dtype):
    """out and (dq, dk, dv) through the JAX package's routing, with
    jax.vjp over the function it picks."""
    jx = [jnp.asarray(x, JDT[dtype]) for x in (q, k, v)]
    jcq, jck = jnp.asarray(cq), jnp.asarray(ck)
    if JV.use_varlen_flash(jx[0], jx[1], causal):
        def fn(q_, k_, v_):
            return JV._varlen_attention(causal, scale, q_, k_, v_, jcq, jck)
    else:
        def fn(q_, k_, v_):
            return JA._unpadded_impl(q_, k_, v_, jcq, jck, scale=scale,
                                     causal=causal)
    out, vjp = jax.vjp(fn, *jx)
    return out, vjp(jnp.asarray(g, JDT[dtype]))


def _torch_unpadded(q, k, v, g, cq, ck, causal, scale, dtype):
    leaves = [torch.from_numpy(x).to(TDT[dtype]).requires_grad_(True)
              for x in (q, k, v)]
    out, soft = F.flash_attn_unpadded(*leaves, torch.from_numpy(cq),
                                      torch.from_numpy(ck), 0, 0, scale,
                                      causal=causal)
    assert soft is None
    out.backward(torch.from_numpy(g).to(TDT[dtype]))
    return out, [x.grad for x in leaves]


UNPADDED = {  # lens_q, lens_k, H, Hk, D
    "packed": ([7, 130, 0, 55, 64], None, 2, 2, 64),
    "gqa": ([40, 0, 25], None, 4, 2, 64),
    "cross": ([30, 40, 5], [60, 0, 9], 2, 2, 64),
    "d128": ([50, 14], None, 1, 1, 128),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,causal", _with_causal(UNPADDED))
def test_flash_attn_unpadded_matches_jax(_interpret, name, causal, dtype):
    lens_q, lens_k, H, Hk, D = UNPADDED[name]
    args = _inputs(lens_q, lens_q if lens_k is None else lens_k, H, D, Hk,
                   seed=3)
    scale = 0.5 / np.sqrt(D)
    out_j, grads_j = _jax_unpadded(*args, causal, scale, dtype)
    out, grads = _torch_unpadded(*args, causal, scale, dtype)
    tol_out, tol_grad = TOL[dtype]
    assert out.shape == args[0].shape and out.dtype == TDT[dtype]
    _close(out, out_j, tol_out)
    for got, want in zip(grads, grads_j):
        _close(got, want, tol_grad)


@pytest.mark.parametrize("name", ["packed", "cross"])
def test_kernel_route_matches_the_composition(name):
    """The port's varlen route (plain versions on the CPU) against the JAX
    composition, the function both packages fall back to: f32, outputs at
    2e-5 and gradients at 2e-4."""
    lens_q, lens_k, H, _, D = UNPADDED[name]
    causal = lens_k is None
    q, k, v, g, cq, ck = _inputs(lens_q, lens_q if causal else lens_k, H, D,
                                 seed=5)
    jx = [jnp.asarray(x) for x in (q, k, v)]
    out_j, vjp = jax.vjp(lambda *a: JA._unpadded_impl(
        *a, jnp.asarray(cq), jnp.asarray(ck), scale=D ** -0.5,
        causal=causal), *jx)
    out, grads = _torch_unpadded(q, k, v, g, cq, ck, causal, D ** -0.5,
                                 "float32")
    _close(out, out_j, 2e-5)
    for got, want in zip(grads, vjp(jnp.asarray(g))):
        _close(got, want, 2e-4)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_unpadded_impl_matches_jax(causal):
    """The composition alone, GQA at D 32 over offsets that differ between
    queries and keys (a key-less sequence among them)."""
    q, k, v, _, cq, ck = _inputs([9, 0, 20], [12, 3, 0], 4, 32, 2, seed=7)
    want = JA._unpadded_impl(*(jnp.asarray(x) for x in (q, k, v)),
                             jnp.asarray(cq), jnp.asarray(ck), scale=0.3,
                             causal=causal)
    got = TA._unpadded_impl(*(torch.from_numpy(x) for x in (q, k, v)),
                            torch.from_numpy(cq), torch.from_numpy(ck),
                            scale=0.3, causal=causal)
    _close(got, want, 2e-5)


def test_flash_attn_unpadded_refuses_dropout():
    q, k, v, _, cq, ck = _inputs([5, 3], [5, 3], 2, 64)
    with pytest.raises(NotImplementedError, match="dropout"):
        JA.flash_attn_unpadded(*(jnp.asarray(x) for x in (q, k, v)), cq, ck,
                               5, 5, 0.125, dropout=0.1)
    with pytest.raises(NotImplementedError, match="dropout"):
        F.flash_attn_unpadded(*(torch.from_numpy(x) for x in (q, k, v)), cq,
                              ck, 5, 5, 0.125, dropout=0.1)
    # not in training: dropout is ignored, as in the JAX package
    out, _ = F.flash_attn_unpadded(*(torch.from_numpy(x) for x in (q, k, v)),
                                   cq, ck, 5, 5, 0.125, dropout=0.1,
                                   training=False)
    assert out.shape == q.shape


# ---------------------------------------------------------------------------
# the wrappers on CPU tensors
# ---------------------------------------------------------------------------

def test_kernel_wrappers_refuse_cpu_tensors():
    q, k, v, _, cq, ck = _inputs([5, 3], [5, 3], 2, 64)
    t = [torch.from_numpy(x) for x in (q, k, v, cq, ck)]
    before = fav.fwd_launch_count
    with pytest.raises(RuntimeError, match="CUDA tensors only"):
        fav._launch_fwd(*t, True, 0.125)
    with pytest.raises(ValueError, match="head dim"):
        fav._launch_fwd(*(x[..., :32].contiguous() for x in t[:3]), *t[3:],
                        True, 0.125)
    assert fav.fwd_launch_count == before


def test_cpu_tensors_launch_nothing():
    q, k, v, g, cq, ck = _inputs([50, 14], [50, 14], 2, 64)
    counts = (fav.fwd_launch_count, fav.dkdv_launch_count,
              fav.dq_launch_count)
    _torch_unpadded(q, k, v, g, cq, ck, True, 0.125, "float32")
    assert (fav.fwd_launch_count, fav.dkdv_launch_count,
            fav.dq_launch_count) == counts
