"""PyTorch port, ``incubate.nn.functional.block_multihead_attention``
against the JAX package's, in each of its modes: decode, prefill (the
segment-masked composition, and the varlen route with the JAX kernel run
by the Pallas interpreter), the mixed batch, ``qkv_bias``, ``-1``-padded
block tables, float32 qkv over bfloat16 pages, block sizes 16 and 64, a
serving trace that threads the caches through several steps, and the
refusals.  Mirrors tests/test_paged_attention.py and the blha tests of
tests/test_fused_ops.py.

Same inputs (numpy, from a seed) through both.  Off the TPU the JAX
decode runs its Pallas decode kernel through the interpreter, which is
what the port's plain decode version repeats.  Tolerances (rtol and
atol): float32 outputs 2e-5 (the same f32 math, sums in another order);
outputs over bfloat16 pages 8e-3, one bf16 ulp at magnitude 1 (both sides
round q * scale and p to bf16 at the same points, from per-page and
whole-row maxima).  Returned caches hold the fresh K/V, cast to the cache
type, and must be equal bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.ops.pallas.flash_attention as FA
import paddle_tpu.ops.pallas.paged_attention as JPA
from paddle_tpu.incubate.nn import functional as JIF
from paddle_tpu_torch.incubate.nn import functional as TIF
from paddle_tpu_torch.ops import flash_attention_varlen as fav
from paddle_tpu_torch.ops import paged_attention as tpa
from _torch_threads import torch_threads  # noqa: F401

F32_TOL = 2e-5
BF16_TOL = 8e-3


@pytest.fixture(autouse=True)
def _interpret():
    """The JAX decode kernel through the interpreter (its default off the
    TPU, set here explicitly), the varlen kernel only where a test asks."""
    old = JPA.INTERPRET, FA.INTERPRET
    JPA.INTERPRET = True
    yield
    JPA.INTERPRET, FA.INTERPRET = old


def _caches(rng, num_blocks, H, bs, D, dtype="float32"):
    kc = rng.randn(num_blocks, H, bs, D).astype(np.float32)
    vc = rng.randn(num_blocks, H, bs, D).astype(np.float32)
    return kc, vc, dtype


def _jax_call(qkv, kc, vc, dtype, enc, dec, this, bt, bs, **kw):
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    out, _, kc2, vc2 = JIF.block_multihead_attention(
        paddle.to_tensor(qkv), paddle.to_tensor(jnp.asarray(kc, jd)),
        paddle.to_tensor(jnp.asarray(vc, jd)), seq_lens_encoder=enc,
        seq_lens_decoder=dec, seq_lens_this_time=this,
        block_tables=paddle.to_tensor(bt), block_size=bs, **kw)
    return [np.asarray(jnp.asarray(x._data if hasattr(x, "_data") else x,
                                   jnp.float32)) for x in (out, kc2, vc2)]


def _torch_call(qkv, kc, vc, dtype, enc, dec, this, bt, bs, **kw):
    td = getattr(torch, dtype)
    kc_t = torch.from_numpy(kc.copy()).to(td)   # the port writes in place
    vc_t = torch.from_numpy(vc.copy()).to(td)
    out, qkv_out, kc2, vc2 = TIF.block_multihead_attention(
        torch.from_numpy(qkv), kc_t, vc_t, seq_lens_encoder=enc,
        seq_lens_decoder=dec, seq_lens_this_time=this,
        block_tables=torch.from_numpy(bt), block_size=bs, **kw)
    assert kc2 is kc_t and vc2 is vc_t           # updated in place
    assert out.dtype == torch.float32
    return [x.float().numpy() for x in (out, kc2, vc2)]


def _compare(args, tol, **kw):
    got = _torch_call(*args, **kw)
    want = _jax_call(*args, **kw)
    np.testing.assert_allclose(got[0], want[0], rtol=tol, atol=tol)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    return got


def _decode_args(seed, B, H, D, bs, nblk, dec, dtype="float32",
                 minus_one=False):
    rng = np.random.RandomState(seed)
    num_blocks = B * nblk + 2
    qkv = rng.randn(B, 3 * H * D).astype(np.float32)
    bt = rng.choice(num_blocks, B * nblk, replace=False).reshape(
        B, nblk).astype(np.int32)
    if minus_one:                     # -1 past each row's live pages
        for b, t in enumerate(dec):
            bt[b, t // bs + 1:] = -1
    kc, vc, dtype = _caches(rng, num_blocks, H, bs, D, dtype)
    return (qkv, kc, vc, dtype, np.zeros(B, np.int32),
            np.asarray(dec, np.int32), np.ones(B, np.int32), bt, bs)


@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("bs,dec", [(16, [5, 37, 70]), (64, [5, 63, 130])],
                         ids=["bs16", "bs64"])
def test_decode_matches_jax(bs, dec, bias):
    args = _decode_args(1, 3, 4, 64, bs, max(dec) // bs + 1, dec)
    kw = {}
    if bias:
        kw["qkv_bias"] = np.random.RandomState(2).randn(3 * 4 * 64).astype(
            np.float32)
    got = _compare(args, F32_TOL, **kw)
    # the fresh key landed in page bt[b, t // bs], slot t % bs
    qkv, bt = args[0], args[7]
    k_new = qkv.reshape(3, 3, 4, 64)[:, 1] + (
        kw["qkv_bias"].reshape(3, 4, 64)[1] if bias else 0)
    for b, t in enumerate(dec):
        np.testing.assert_array_equal(got[1][bt[b, t // bs], :, t % bs],
                                      k_new[b])


def test_decode_minus_one_padded_tables():
    _compare(_decode_args(3, 2, 4, 64, 16, 4, [11, 20], minus_one=True),
             F32_TOL)


def test_decode_f32_qkv_over_bf16_pages():
    """q joins the cache type before the kernel on both sides."""
    _compare(_decode_args(4, 2, 4, 64, 16, 3, [5, 9], dtype="bfloat16"),
             BF16_TOL)


def test_decode_unsupported_block_size_takes_the_reference():
    """A block size the decode kernel's rule refuses (not a multiple of 8)
    takes the dense-gather reference on both sides."""
    args = _decode_args(5, 2, 2, 64, 4, 6, [6, 13])
    assert not tpa.supports(2, 2, 2, 64, 4)
    _compare(args, F32_TOL)


def _prefill_args(seed, lens, H, D, bs, dtype="float32"):
    rng = np.random.RandomState(seed)
    nblk = -(-max(lens) // bs) + 1
    B = len(lens)
    num_blocks = B * nblk + 1
    qkv = rng.randn(int(sum(lens)), 3 * H * D).astype(np.float32)
    bt = rng.choice(num_blocks, B * nblk, replace=False).reshape(
        B, nblk).astype(np.int32)
    kc, vc, dtype = _caches(rng, num_blocks, H, bs, D, dtype)
    lens = np.asarray(lens, np.int32)
    return (qkv, kc, vc, dtype, lens, np.zeros(B, np.int32), lens, bt, bs)


@pytest.mark.parametrize("name,lens,D,interp,dtype,tol", [
    ("composition_d32", [6, 0, 3, 17], 32, False, "float32", F32_TOL),
    ("varlen_interpreted", [6, 0, 3, 17], 64, True, "float32", F32_TOL),
    ("varlen_vs_jax_composition", [40, 9], 64, False, "float32", F32_TOL),
    ("varlen_bs64", [70, 1, 30], 64, True, "float32", F32_TOL),
    ("bf16_pages", [6, 3, 17], 64, True, "bfloat16", F32_TOL),
], ids=["composition_d32", "varlen_interpreted", "varlen_vs_jax_composition",
        "varlen_bs64", "bf16_pages"])
def test_prefill_matches_jax(name, lens, D, interp, dtype, tol):
    """The port's prefill takes the varlen route (the plain versions on
    the CPU) wherever the JAX package's shape rule would take its kernel;
    JAX runs that kernel through the interpreter, or (without it) its
    composition, which the varlen route must match as well."""
    FA.INTERPRET = interp
    bs = 64 if "bs64" in name else 8
    args = _prefill_args(7, lens, 4, D, bs, dtype)
    q = torch.empty(1, 4, D)
    assert fav.use_varlen_kernel(q, q) is (D != 32)
    _compare(args, tol)


def test_prefill_with_bias_and_pages_filled():
    FA.INTERPRET = True
    args = _prefill_args(8, [5, 11], 2, 64, 8)
    bias = np.random.RandomState(9).randn(3 * 2 * 64).astype(np.float32)
    got = _compare(args, F32_TOL, qkv_bias=bias)
    qkv, bt = args[0], args[7]
    k = qkv.reshape(-1, 3, 2, 64)[:, 1] + bias.reshape(3, 2, 64)[1]
    off = 0
    for b, n in enumerate([5, 11]):
        for r in range(n):
            np.testing.assert_array_equal(got[1][bt[b, r // 8], :, r % 8],
                                          k[off + r])
        off += n


@pytest.mark.parametrize("interp", [False, True],
                         ids=["jax_composition", "jax_interpreted"])
def test_mixed_batch_matches_jax(interp):
    """Prefill sequences and decode sequences in one call: prefill first,
    then decode over the caches it updated, outputs in token order."""
    FA.INTERPRET = interp
    rng = np.random.RandomState(10)
    H, D, bs, nblk = 4, 64, 8, 4
    num_blocks = 4 * nblk
    this = np.array([6, 1, 9, 1], np.int32)
    enc = np.array([6, 0, 9, 0], np.int32)
    dec = np.array([0, 13, 0, 4], np.int32)
    qkv = rng.randn(int(this.sum()), 3 * H * D).astype(np.float32)
    bt = rng.choice(num_blocks, 4 * nblk, replace=False).reshape(
        4, nblk).astype(np.int32)
    kc, vc, dtype = _caches(rng, num_blocks, H, bs, D)
    _compare((qkv, kc, vc, dtype, enc, dec, this, bt, bs), F32_TOL)


@pytest.mark.parametrize("bs,dtype,tol", [(16, "float32", F32_TOL),
                                          (64, "float32", F32_TOL),
                                          (16, "bfloat16", BF16_TOL)],
                         ids=["bs16", "bs64", "bs16_bf16_pages"])
def test_serving_trace_threads_the_caches(bs, dtype, tol):
    """A prefill step, a mixed step and two decode steps over 4 slots,
    each side threading its own caches: every step's output and the final
    caches agree."""
    FA.INTERPRET = True
    rng = np.random.RandomState(11)
    H, D = 2, 64
    prompts = [9, 20, 3, 14]
    nblk = -(-(max(prompts) + 3) // bs)
    bt = rng.permutation(4 * nblk).reshape(4, nblk).astype(np.int32)
    kc0 = np.zeros((4 * nblk, H, bs, D), np.float32)
    steps = [([9, 20, 0, 0], [0, 0, 0, 0], [9, 20, 0, 0]),
             ([0, 0, 3, 14], [9, 20, 0, 0], [1, 1, 3, 14]),
             ([0] * 4, [10, 21, 3, 14], [1] * 4),
             ([0] * 4, [11, 22, 4, 15], [1] * 4)]
    td = getattr(torch, dtype)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    t_caches = [torch.from_numpy(kc0.copy()).to(td) for _ in range(2)]
    j_caches = [paddle.to_tensor(jnp.asarray(kc0, jd)) for _ in range(2)]
    for enc, dec, this in steps:
        enc, dec, this = (np.asarray(x, np.int32) for x in (enc, dec, this))
        qkv = rng.randn(int(this.sum()), 3 * H * D).astype(np.float32)
        t_out, _, *t_caches = TIF.block_multihead_attention(
            torch.from_numpy(qkv), *t_caches, enc, dec, this,
            block_tables=torch.from_numpy(bt), block_size=bs)
        j_out, _, *j_caches = JIF.block_multihead_attention(
            paddle.to_tensor(qkv), *j_caches, enc, dec, this,
            block_tables=paddle.to_tensor(bt), block_size=bs)
        np.testing.assert_allclose(t_out.numpy(), j_out.numpy(), rtol=tol,
                                   atol=tol)
    for t, j in zip(t_caches, j_caches):
        np.testing.assert_array_equal(
            t.float().numpy(), np.asarray(jnp.asarray(j._data, jnp.float32)))


def test_blha_get_max_len_matches_jax():
    enc = np.array([3, 0, 17], np.int32)
    dec = np.array([0, 40, 2], np.int32)
    got = TIF.blha_get_max_len(torch.from_numpy(enc), dec, 3)
    want = JIF.blha_get_max_len(paddle.to_tensor(enc), dec, 3)
    for g, w in zip(got, want):
        assert tuple(g.shape) == (1,)
        np.testing.assert_array_equal(g.numpy(), w.numpy())


@pytest.mark.parametrize("kw,exc", [
    ({"cache_k_quant_scales": np.ones(4, np.float32)}, NotImplementedError),
    ({"out_shift": np.zeros(4, np.float32)}, NotImplementedError),
    ({"pre_key_cache": np.zeros((1, 4, 8, 64), np.float32)},
     NotImplementedError),
    ({"block_tables": None}, ValueError),
    ({"seq_lens_this_time": np.array([2, 1], np.int32)},
     NotImplementedError),
], ids=["quant_scales", "out_shift", "pre_cache", "no_tables",
        "neither_mode"])
def test_refusals_match_jax(kw, exc):
    """The same exception types on both sides: quantized caches and
    pre-caches, missing block tables, and a sequence that is neither a
    pure prefill nor a single-token decode (2 tokens over a cache)."""
    qkv, kc, vc, dtype, enc, dec, this, bt, bs = _decode_args(
        12, 2, 4, 64, 8, 3, [5, 9])
    call = dict(seq_lens_encoder=enc, seq_lens_decoder=dec,
                seq_lens_this_time=this, block_tables=bt, block_size=bs)
    call.update(kw)
    if "seq_lens_this_time" in kw:
        qkv = np.concatenate([qkv, qkv[:1]])
    with pytest.raises(exc):
        TIF.block_multihead_attention(
            torch.from_numpy(qkv), torch.from_numpy(kc),
            torch.from_numpy(vc), **{k: (torch.from_numpy(v) if k ==
                                         "block_tables" and v is not None
                                         else v) for k, v in call.items()})
    with pytest.raises(exc):
        JIF.block_multihead_attention(
            paddle.to_tensor(qkv), paddle.to_tensor(kc),
            paddle.to_tensor(vc), **{k: (paddle.to_tensor(v) if k ==
                                         "block_tables" and v is not None
                                         else v) for k, v in call.items()})


def test_cpu_tensors_launch_no_kernel():
    FA.INTERPRET = True
    counts = (tpa.decode_launch_count, fav.fwd_launch_count)
    _torch_call(*_prefill_args(13, [5, 7], 2, 64, 8))
    _torch_call(*_decode_args(13, 2, 2, 64, 8, 3, [5, 9]))
    assert (tpa.decode_launch_count, fav.fwd_launch_count) == counts
