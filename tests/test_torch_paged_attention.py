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
