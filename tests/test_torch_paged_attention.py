"""PyTorch port, ragged paged attention: the plain version and the
segment map against the JAX package (its XLA reference and its Pallas
kernel run in interpret mode), and the CUDA wrapper's refusals on the CPU.

Tolerance: atol = rtol = 1e-5 in float32 -- the same math, with the f32
sums taken in another order (and, for the Pallas kernel, an online
softmax over pages instead of one full softmax).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.ops.pallas.paged_attention as jpa
import paddle_tpu_torch.ops.paged_attention as tpa
from _torch_threads import torch_threads  # noqa: F401

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture
def _interpret():
    old = jpa.INTERPRET
    jpa.INTERPRET = True
    yield
    jpa.INTERPRET = old


def _case(seed, H, Hkv, D, bs, rows, Tq, nblk):
    """An engine-shaped ragged launch: B = len(rows) rows of (query
    tokens, kv length after the launch), a [B+1]-row block table whose
    last row is the null row, tail padding up to Tq flat tokens."""
    rng = np.random.RandomState(seed)
    B = len(rows)
    num_blocks = 1 + B * nblk
    cu = np.zeros(B + 1, np.int32)
    cu[1:] = np.cumsum([q for q, _ in rows])
    kvl = np.asarray([kv for _, kv in rows], np.int32)
    bt = np.zeros((B + 1, nblk), np.int32)        # NULL_BLOCK == 0
    pages = rng.permutation(np.arange(1, num_blocks))
    used = 0
    for r, (_, kv) in enumerate(rows):
        n = -(-kv // bs)
        bt[r, :n] = pages[used:used + n]
        used += n
    q = rng.randn(Tq, H, D).astype(np.float32)
    kc = rng.randn(num_blocks, Hkv, bs, D).astype(np.float32)
    vc = rng.randn(num_blocks, Hkv, bs, D).astype(np.float32)
    return q, kc, vc, bt, cu, kvl


# (rows of (q tokens, kv len after the launch), Tq, nblk)
LAYOUTS = {
    "prefill": ([(7, 7)], 8, 2),
    "mixed": ([(6, 6), (3, 11), (1, 9), (1, 1)], 16, 3),
    "decode": ([(1, 5), (1, 17), (1, 24), (1, 2)], 4, 3),
    "empty_rows": ([(2, 10), (0, 0), (1, 3)], 8, 2),
}
SHAPES = [(4, 4, 64, 8), (4, 2, 64, 8), (8, 2, 128, 16)]   # H, Hkv, D, bs


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_ragged_segments_match_jax(layout):
    rows, Tq, nblk = LAYOUTS[layout]
    _, _, _, _, cu, kvl = _case(0, 4, 4, 64, 8, rows, Tq, nblk)
    jseg, jrel = jpa.ragged_segments(jnp.asarray(cu), jnp.asarray(kvl), Tq)
    tseg, trel = tpa.ragged_segments(*_torch(cu, kvl), Tq)
    assert tseg.dtype == torch.int32 and trel.dtype == torch.int32
    np.testing.assert_array_equal(tseg.numpy(), np.asarray(jseg))
    np.testing.assert_array_equal(trel.numpy(), np.asarray(jrel))
    # padding tokens resolve to the null row at position 0
    pad = np.arange(Tq) >= cu[-1]
    assert (tseg.numpy()[pad] == len(rows)).all()
    assert (trel.numpy()[pad] == 0).all()


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "H%dKV%dD%dbs%d" % s)
@pytest.mark.parametrize("layout", ["prefill", "mixed", "decode"])
def test_plain_version_matches_jax_reference(layout, shape):
    H, Hkv, D, bs = shape
    rows, Tq, nblk = LAYOUTS[layout]
    q, kc, vc, bt, cu, kvl = _case(1, H, Hkv, D, bs, rows, Tq,
                                   max(nblk, -(-24 // bs)))
    seg, rel = jpa.ragged_segments(jnp.asarray(cu), jnp.asarray(kvl), Tq)
    ref = jpa.ragged_paged_reference_segrel(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(bt),
        seg, rel)
    tq, tkc, tvc, tbt, tcu, tkvl = _torch(q, kc, vc, bt, cu, kvl)
    tseg, trel = tpa.ragged_segments(tcu, tkvl, Tq)
    out = tpa.ragged_paged_attention_segrel_packed(tq, tkc, tvc, tbt, tseg,
                                                   trel)
    assert out.shape == (Tq, H, D) and out.dtype == torch.float32
    assert torch.isfinite(out).all()           # pad rows too
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("layout", ["mixed", "empty_rows"])
@pytest.mark.parametrize("shape", [(4, 2, 64, 8), (4, 4, 64, 8)],
                         ids=["gqa", "mha"])
def test_plain_version_matches_pallas_kernel_interpreted(_interpret, layout,
                                                         shape):
    H, Hkv, D, bs = shape
    rows, Tq, nblk = LAYOUTS[layout]
    q, kc, vc, bt, cu, kvl = _case(2, H, Hkv, D, bs, rows, Tq, nblk)
    seg, rel = jpa.ragged_segments(jnp.asarray(cu), jnp.asarray(kvl), Tq)
    kern = jpa.ragged_paged_attention_segrel_packed(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(bt),
        seg, rel)
    tq, tkc, tvc, tbt, tcu, tkvl = _torch(q, kc, vc, bt, cu, kvl)
    out = tpa.ragged_paged_attention(tq, tkc, tvc, tbt, tcu, tkvl)
    live = np.arange(Tq) < cu[-1]          # pad rows: garbage on both sides
    np.testing.assert_allclose(out.numpy()[live], np.asarray(kern)[live],
                               **TOL)


def test_public_segrel_clamps_blha_padding():
    """-1 table padding and the seg == R sentinel clamp into range, as
    the JAX entry's do."""
    H, Hkv, D, bs = 4, 2, 64, 8
    rows, Tq, nblk = LAYOUTS["mixed"]
    q, kc, vc, bt, cu, kvl = _case(3, H, Hkv, D, bs, rows, Tq, nblk)
    bt = bt[:-1].copy()                        # drop the null row: R = B
    bt[bt == 0] = -1
    seg, rel = jpa.ragged_segments(jnp.asarray(cu), jnp.asarray(kvl), Tq)
    ref = jpa.ragged_paged_reference_segrel(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(bt),
        seg, rel)
    tq, tkc, tvc, tbt, tcu, tkvl = _torch(q, kc, vc, bt.astype(np.int64),
                                          cu, kvl)
    tseg, trel = tpa.ragged_segments(tcu, tkvl, Tq)
    out = tpa.ragged_paged_attention_segrel(tq, tkc, tvc, tbt, tseg.long(),
                                            trel)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def _operands(H=4, Hkv=2, D=64, bs=8, dtype=torch.float32):
    rows, Tq, nblk = LAYOUTS["mixed"]
    q, kc, vc, bt, cu, kvl = _case(4, H, Hkv, D, bs, rows, Tq, nblk)
    tq, tkc, tvc, tbt, tcu, tkvl = _torch(q, kc, vc, bt, cu, kvl)
    seg, rel = tpa.ragged_segments(tcu, tkvl, Tq)
    return [tq.to(dtype), tkc.to(dtype), tvc.to(dtype), tbt, seg, rel]


def test_cpu_tensors_take_the_plain_version_and_never_count():
    tpa.launch_count = 0
    ops = _operands()
    out = tpa.ragged_paged_attention_segrel_packed(*ops)
    np.testing.assert_array_equal(
        out.numpy(), tpa.ragged_paged_reference_segrel(*ops).numpy())
    assert tpa.launch_count == 0


def test_kernel_refuses_cpu_tensors():
    tpa.launch_count = 0
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        tpa._launch_kernel(*_operands())
    assert tpa.launch_count == 0


def _bad(name):
    ops = _operands()
    if name == "noncontiguous_q":
        ops[0] = ops[0].transpose(0, 1).contiguous().transpose(0, 1)
    elif name == "int64_table":
        ops[3] = ops[3].long()
    elif name == "group_above_8":
        ops = _operands(H=18, Hkv=2)
    elif name == "head_dim_32":
        ops = _operands(D=32)
    elif name == "block_size_12":
        ops = _operands(bs=12)
    elif name == "float16":
        ops = _operands(dtype=torch.float16)
    elif name == "cache_dtype_mismatch":
        ops[1] = ops[1].to(torch.bfloat16)
    elif name == "seg_length":
        ops[4] = ops[4][:-1]
    return ops


@pytest.mark.parametrize("name", [
    "noncontiguous_q", "int64_table", "group_above_8", "head_dim_32",
    "block_size_12", "float16", "cache_dtype_mismatch", "seg_length"])
def test_kernel_wrapper_rejects_bad_operands(name):
    """Every operand outside the contract is refused before any launch.  A
    query group above 8 is inside it (the JAX rule takes any G), so there
    only the CPU device is refused."""
    ops = _bad(name)
    if name == "group_above_8":
        with pytest.raises(RuntimeError, match="CUDA tensors"):
            tpa._launch_kernel(*ops)
        return
    with pytest.raises(ValueError, match="ragged paged attention kernel"):
        tpa._launch_kernel(*ops)


def test_bf16_plain_version_tracks_f32():
    """bf16 operands: the plain version computes in f32 and rounds the
    output once, so it sits within bf16 input rounding of the f32 run."""
    ops32 = _operands()
    ops16 = [x.to(torch.bfloat16) if x.is_floating_point() else x
             for x in ops32]
    out32 = tpa.ragged_paged_reference_segrel(*ops32)
    out16 = tpa.ragged_paged_reference_segrel(*ops16)
    assert out16.dtype == torch.bfloat16
    np.testing.assert_allclose(out16.float().numpy(), out32.numpy(),
                               atol=5e-2)


# ---------------------------------------------------------------------------
# paged decode (block_multihead_attention's decode): the plain version, which
# repeats the TPU decode kernel's rounding points, against that kernel run by
# the Pallas interpreter (tests/test_paged_attention.py's parameter sets),
# and the dense-gather reference against the JAX one.  float32 at TOL;
# bfloat16 at 8e-3, one bf16 ulp at magnitude 1 (q * scale and p rounded at
# the same points, p from per-page running maxima in the kernel and the
# row's maximum in the plain version).
# ---------------------------------------------------------------------------

DECODE_SHAPES = [(8, 4, 64, 16, 5), (4, 4, 64, 8, 3), (10, 5, 128, 16, 4)]
DECODE_IDS = ["gqa", "mha", "d128_gqa"]


def _decode(seed, H, Hkv, D, bs, nblk, B=3, num_blocks=64):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, D).astype(np.float32)
    kc = rng.randn(num_blocks, Hkv, bs, D).astype(np.float32)
    vc = rng.randn(num_blocks, Hkv, bs, D).astype(np.float32)
    bt = rng.choice(num_blocks, B * nblk, replace=False).reshape(
        B, nblk).astype(np.int32)
    lengths = rng.randint(1, nblk * bs + 1, B).astype(np.int32)
    return q, kc, vc, bt, lengths


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", DECODE_SHAPES, ids=DECODE_IDS)
def test_decode_plain_version_matches_pallas_kernel_interpreted(
        _interpret, shape, dtype):
    q, kc, vc, bt, lengths = _decode(0, *shape)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = jpa.paged_decode_attention(
        *(jnp.asarray(x, jd) for x in (q, kc, vc)), jnp.asarray(bt),
        jnp.asarray(lengths))
    td = getattr(torch, dtype)
    tq, tkc, tvc, tbt, tln = _torch(q, kc, vc, bt, lengths)
    got = tpa.paged_decode_attention(tq.to(td), tkc.to(td), tvc.to(td), tbt,
                                     tln)
    assert got.shape == q.shape and got.dtype == td
    tol = TOL if dtype == "float32" else dict(atol=8e-3, rtol=8e-3)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               **tol)


@pytest.mark.parametrize("shape", DECODE_SHAPES, ids=DECODE_IDS)
def test_decode_reference_matches_jax(shape):
    q, kc, vc, bt, lengths = _decode(1, *shape)
    want = jpa.paged_decode_reference(
        *(jnp.asarray(x) for x in (q, kc, vc, bt, lengths)))
    got = tpa.paged_decode_reference(*_torch(q, kc, vc, bt, lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_decode_minus_one_padded_block_tables(_interpret):
    """-1 table padding past each row's pages clamps into range on both
    sides (tests/test_paged_attention.py's case)."""
    q, kc, vc, _, _ = _decode(7, 4, 4, 64, 8, 4, B=2, num_blocks=16)
    bt = np.full((2, 4), -1, np.int32)
    bt[0, :2] = [3, 7]
    bt[1, :1] = [5]
    lengths = np.asarray([11, 6], np.int32)
    want = jpa.paged_decode_attention(
        *(jnp.asarray(x) for x in (q, kc, vc, bt, lengths)))
    got = tpa.paged_decode_attention(*_torch(q, kc, vc, bt, lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("args", [
    (2, 8, 4, 64, 16), (2, 4, 4, 128, 8), (2, 4, 4, 256, 8),
    (2, 6, 4, 64, 16), (2, 4, 4, 96, 16), (2, 4, 4, 64, 12)],
    ids=["gqa", "d128", "d256", "group_not_dividing", "d96", "bs12"])
def test_decode_rule_matches_jax(args):
    assert tpa.supports(*args) is jpa.supports(*args)


def test_decode_cpu_tensors_never_count_and_kernel_refuses_them():
    ops = _torch(*_decode(2, 4, 4, 64, 8, 3))
    tpa.decode_launch_count = 0
    out = tpa.paged_decode_attention_packed(*ops)
    np.testing.assert_array_equal(out.numpy(),
                                  tpa.paged_decode_plain(*ops).numpy())
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        tpa._launch_decode_kernel(*ops)
    with pytest.raises(ValueError, match="paged decode kernel"):
        tpa._launch_decode_kernel(ops[0], *ops[1:3], ops[3][:1], ops[4])
    assert tpa.decode_launch_count == 0


# the repaired rules: every D and G the JAX rules take reaches the kernels

RULE_DIMS = [64, 96, 128, 256, 384, 512]
RULE_GROUPS = [1, 4, 8, 16, 32]


@pytest.mark.parametrize("bs", [8, 12, 16])
@pytest.mark.parametrize("G", RULE_GROUPS)
@pytest.mark.parametrize("D", RULE_DIMS)
def test_rules_and_kernel_contracts_equal_jax(D, G, bs):
    """The port's decode and ragged rules equal the JAX package's shape
    rules (without their lowering probes), and each of the three kernel
    wrappers takes an operand set exactly where the rule holds: there only
    the CPU device is refused."""
    for Hkv in (1, 2):
        H = G * Hkv
        assert tpa.supports(1, H, Hkv, D, bs) is jpa.supports(1, H, Hkv, D,
                                                              bs)
        rule = jpa.ragged_supports(4, H, Hkv, D, bs)
        assert tpa.ragged_supports(H, Hkv, D, bs) is rule
        q = torch.zeros((4, H, D))
        kc = torch.zeros((3, Hkv, bs, D))
        bt = torch.zeros((4, 2), dtype=torch.int32)
        v4 = torch.zeros(4, dtype=torch.int32)
        k8 = kc.to(torch.int8)
        sc = torch.ones((3, Hkv))
        for launch in (
                lambda: tpa._launch_kernel(q, kc, kc, bt, v4, v4),
                lambda: tpa._launch_quant_kernel(q, k8, k8, sc, sc, bt, v4,
                                                 v4),
                lambda: tpa._launch_decode_kernel(q, kc, kc, bt, v4)):
            with pytest.raises(RuntimeError if rule else ValueError,
                               match="CUDA tensors" if rule else "rule"):
                launch()


def test_group_not_dividing_heads_is_refused_everywhere():
    assert not tpa.ragged_supports(6, 4, 128, 16)
    assert not jpa.ragged_supports(4, 6, 4, 128, 16)
    with pytest.raises(ValueError, match="rule"):
        tpa._launch_kernel(*_operands(H=6, Hkv=4))


# ---------------------------------------------------------------------------
# the layouts the walk's work split cares about (csrc/ragged_paged_attention.cu
# cuts a launch into query tiles of TT tokens and key splits): chunks that
# start mid-page and are not a multiple of a tile, rows longer than a split,
# one-key rows, decode rows beside a chunk, pad tokens; G 1/4/8, bs 16/64.
# The plain version against the JAX reference (f32, TOL) and against the
# Pallas kernel run by the interpreter; then the host plan (_walk_plan) and
# the kernel's work list (_walk_items, below) cover every (token, kv head,
# key) exactly once.
# ---------------------------------------------------------------------------

WALK_LAYOUTS = {
    # a 37-token chunk resuming at position 27 (mid-page, off every tile
    # edge), two decode rows, a one-key row, pad tokens
    "chunk_mid_page": ([(37, 64), (1, 90), (1, 1), (1, 33)], 48),
    # one row of 600 keys (longer than a split of 512) and short rows
    "long_row": ([(1, 600), (1, 17), (2, 40)], 8),
    # a whole prefill chunk of 70 tokens (one more than a 64-token tile)
    "prefill_70": ([(70, 70)], 72),
    # decode only, one of them a single key
    "decode": ([(1, 1), (1, 130), (1, 513), (1, 64)], 4),
}
WALK_SHAPES = [(4, 4, 64, 16), (8, 2, 64, 16), (8, 1, 64, 64),
               (16, 2, 128, 16)]                      # H, Hkv, D, bs


def _walk_case(seed, layout, shape):
    rows, Tq = WALK_LAYOUTS[layout]
    H, Hkv, D, bs = shape
    nblk = -(-max(kv for _, kv in rows) // bs)
    q, kc, vc, bt, cu, kvl = _case(seed, H, Hkv, D, bs, rows, Tq, nblk)
    return q, kc, vc, bt, cu, kvl, Tq


@pytest.mark.parametrize("shape", WALK_SHAPES,
                         ids=lambda s: "H%dKV%dD%dbs%d" % s)
@pytest.mark.parametrize("layout", list(WALK_LAYOUTS))
def test_plain_version_matches_jax_reference_at_walk_layouts(layout, shape):
    q, kc, vc, bt, cu, kvl, Tq = _walk_case(5, layout, shape)
    seg, rel = jpa.ragged_segments(jnp.asarray(cu), jnp.asarray(kvl), Tq)
    ref = jpa.ragged_paged_reference_segrel(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(bt),
        seg, rel)
    tq, tkc, tvc, tbt, tcu, tkvl = _torch(q, kc, vc, bt, cu, kvl)
    tseg, trel = tpa.ragged_segments(tcu, tkvl, Tq)
    out = tpa.ragged_paged_attention_segrel_packed(tq, tkc, tvc, tbt, tseg,
                                                   trel)
    assert torch.isfinite(out).all()           # pad rows too
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("shape", [(4, 4, 64, 16), (8, 1, 64, 64)],
                         ids=["G1bs16", "G8bs64"])
@pytest.mark.parametrize("layout", ["chunk_mid_page", "decode"])
def test_plain_version_matches_pallas_kernel_at_walk_layouts(
        _interpret, layout, shape):
    q, kc, vc, bt, cu, kvl, Tq = _walk_case(6, layout, shape)
    seg, rel = jpa.ragged_segments(jnp.asarray(cu), jnp.asarray(kvl), Tq)
    kern = jpa.ragged_paged_attention_segrel_packed(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(bt),
        seg, rel)
    tq, tkc, tvc, tbt, tcu, tkvl = _torch(q, kc, vc, bt, cu, kvl)
    out = tpa.ragged_paged_attention(tq, tkc, tvc, tbt, tcu, tkvl)
    live = np.arange(Tq) < cu[-1]
    np.testing.assert_allclose(out.numpy()[live], np.asarray(kern)[live],
                               **TOL)


@pytest.mark.parametrize("shape", [(8, 2, 64, 16), (8, 1, 128, 64)],
                         ids=["G4bs16", "G8bs64"])
@pytest.mark.parametrize("layout", ["chunk_mid_page", "long_row"])
def test_quant_plain_version_matches_pallas_kernel_at_walk_layouts(
        _interpret, layout, shape):
    """int8 pages: the plain version against the interpreted int8-page
    Pallas kernel (scales amax / 127 per page and head)."""
    q, kc, vc, bt, cu, kvl, Tq = _walk_case(7, layout, shape)
    ks = np.abs(kc).max((2, 3)) / 127.0
    vs = np.abs(vc).max((2, 3)) / 127.0
    k8 = np.clip(np.round(kc / ks[:, :, None, None]), -127, 127).astype(
        np.int8)
    v8 = np.clip(np.round(vc / vs[:, :, None, None]), -127, 127).astype(
        np.int8)
    ks, vs = ks.astype(np.float32), vs.astype(np.float32)
    seg, rel = jpa.ragged_segments(jnp.asarray(cu), jnp.asarray(kvl), Tq)
    kern = jpa.ragged_paged_attention_quant_segrel_packed(
        *(jnp.asarray(x) for x in (q, k8, v8, ks, vs, bt)), seg, rel)
    tq, tk8, tv8, tks, tvs, tbt, tcu, tkvl = _torch(q, k8, v8, ks, vs, bt,
                                                    cu, kvl)
    tseg, trel = tpa.ragged_segments(tcu, tkvl, Tq)
    out = tpa.ragged_paged_attention_quant_segrel_packed(
        tq, tk8, tv8, tks, tvs, tbt, tseg, trel)
    live = np.arange(Tq) < cu[-1]
    np.testing.assert_allclose(out.numpy()[live], np.asarray(kern)[live],
                               **TOL)


def _walk_items(seg, rel, H, Hkv, bs, nblk, plan, decode=False):
    """The kernel's work list for one launch, as the walk's tile and split
    scan finds it on the card (csrc/ragged_paged_attention.cu):
    ``[(tokens, kv head, (k0, k1))]`` where ``tokens`` is the tile's token
    range and keys k0 .. k1 - 1 are the item's.  seg / rel are host int
    sequences (decode: rel holds the lengths, seg is ignored)."""
    tt, split, _, _ = plan
    G = H // Hkv
    cap = nblk * bs
    Tq = len(rel)

    def limit(t):
        n = int(rel[t]) if decode else int(rel[t]) + 1
        return min(max(n, 1), cap)

    if decode:
        starts = list(range(Tq))
    else:
        starts, rs = [], 0
        for t in range(Tq):
            if t == 0 or seg[t] != seg[t - 1]:
                rs = t
            if (t - rs) % tt == 0:
                starts.append(t)
    items = []
    for i, t0 in enumerate(starts):
        t1 = starts[i + 1] if i + 1 < len(starts) else Tq
        nkeys = max(limit(t) for t in range(t0, t1))
        ns = -(-nkeys // split) if (t1 - t0) * G <= 8 else 1
        for z in range(ns):
            k0 = z * split
            k1 = min(k0 + split, nkeys) if ns > 1 else nkeys
            items += [(range(t0, t1), h, (k0, k1)) for h in range(Hkv)]
    return items


def _coverage(items, limits, Hkv):
    """How often each (token, kv head, key) is an item's, for the keys
    below each token's limit (any key at or past it must be unclaimed by
    that token's items except as masked work inside its tile)."""
    counts = {}
    for tokens, h, (k0, k1) in items:
        assert 0 <= k0 < k1
        for t in tokens:
            for key in range(k0, min(k1, limits[t])):
                counts[t, h, key] = counts.get((t, h, key), 0) + 1
    want = {(t, h, key) for t in range(len(limits)) for h in range(Hkv)
            for key in range(limits[t])}
    return counts, want


KINDS = {"f32": (torch.float32, False), "bf16": (torch.bfloat16, False),
         "int8": (torch.bfloat16, True)}


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("shape", WALK_SHAPES,
                         ids=lambda s: "H%dKV%dD%dbs%d" % s)
@pytest.mark.parametrize("layout", list(WALK_LAYOUTS) + ["engine_mixed"])
def test_walk_plan_covers_every_token_head_and_key_once(layout, shape,
                                                        kind):
    """The kernel's work list at the host plan: each (token, kv head, key
    <= rel) in exactly one item, tiles of one row and at most TT tokens,
    at most ntiles_max tiles, splits only on tiles of at most 8 rows, and
    the split scratch under its budget."""
    H, Hkv, D, bs = shape
    dtype, quant = KINDS[kind]
    if layout == "engine_mixed":            # chip_smoke.py's mixed launch
        rows = [(512, 700)] + [(1, kv) for kv in
                               (2000, 731, 1290, 5, 16, 17, 1999)]
        Tq = 576
    else:
        rows, Tq = WALK_LAYOUTS[layout]
    nblk = -(-2048 // bs)
    B = len(rows)
    cu = np.zeros(B + 1, np.int32)
    cu[1:] = np.cumsum([n for n, _ in rows])
    kvl = np.asarray([kv for _, kv in rows], np.int32)
    seg, rel = (x.numpy() for x in tpa.ragged_segments(
        torch.from_numpy(cu), torch.from_numpy(kvl), Tq))
    plan = tpa._walk_plan(Tq, H, Hkv, D, bs, B + 1, nblk, dtype, quant)
    tt, split, nsplit, ntiles = plan
    kt = 128 if quant else (32 if dtype == torch.float32 else 64)
    assert split % kt == 0 and split * nsplit >= nblk * bs
    assert ntiles * Hkv * nsplit * 8 * (D + 2) * 4 <= max(
        tpa._SCRATCH_BYTES, ntiles * Hkv * 8 * (D + 2) * 4)
    items = _walk_items(seg, rel, H, Hkv, bs, nblk, plan)
    tiles = {(it[0].start, it[0].stop) for it in items}
    assert len(tiles) <= ntiles
    G = H // Hkv
    for t0, t1 in tiles:
        assert 1 <= t1 - t0 <= tt and len(set(seg[t0:t1])) == 1
    for tokens, _, (k0, k1) in items:
        if len(tokens) * G > 8:
            assert k0 == 0                   # unsplit: the tensor cores
    limits = [min(int(r) + 1, nblk * bs) for r in rel]
    counts, want = _coverage(items, limits, Hkv)
    assert set(counts) == want and set(counts.values()) == {1}


@pytest.mark.parametrize("lens", [[1, 130, 513, 64], [2048, 1, 511, 512,
                                                      513, 1024]])
@pytest.mark.parametrize("bs", [16, 64])
def test_decode_walk_plan_covers_every_row_head_and_key_once(lens, bs):
    H, Hkv, D = 32, 8, 128
    nblk = -(-2048 // bs)
    plan = tpa._walk_plan(len(lens), H, Hkv, D, bs, len(lens), nblk,
                          torch.bfloat16, decode=True)
    assert plan[0] == 1 and plan[3] == len(lens)
    items = _walk_items(None, lens, H, Hkv, bs, nblk, plan, decode=True)
    counts, want = _coverage(items, lens, Hkv)
    assert set(counts) == want and set(counts.values()) == {1}
    # a row longer than a split runs on several items
    assert sum(1 for it in items if it[0].start == lens.index(max(lens))
               and it[1] == 0) == -(-max(lens) // plan[1])


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_public_segrel_takes_tokens_in_any_order(quant):
    """The walk wants seg non-decreasing; the public (unpacked) entries
    order the tokens by seg and hand the outputs back in the caller's
    order, so a shuffled launch gives each token its own row."""
    ops = _operands()
    perm = torch.from_numpy(np.random.RandomState(8).permutation(
        ops[0].shape[0]))
    q, kc, vc, bt, seg, rel = ops
    if quant:
        ks = kc.abs().amax((2, 3)) / 127.0
        vs = vc.abs().amax((2, 3)) / 127.0
        kc = torch.round(kc / ks[:, :, None, None]).to(torch.int8)
        vc = torch.round(vc / vs[:, :, None, None]).to(torch.int8)
        want = tpa.ragged_paged_reference_quant_segrel(q, kc, vc, ks, vs, bt,
                                                       seg, rel)
        got = tpa.ragged_paged_attention_quant_segrel(
            q[perm], kc, vc, ks, vs, bt, seg[perm], rel[perm])
    else:
        want = tpa.ragged_paged_reference_segrel(q, kc, vc, bt, seg, rel)
        got = tpa.ragged_paged_attention_segrel(q[perm], kc, vc, bt,
                                                seg[perm], rel[perm])
    np.testing.assert_allclose(got.numpy(), want[perm].numpy(), **TOL)
