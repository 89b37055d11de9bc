"""PyTorch port, quantized weight pools and the dequant matmul: the host
transforms against the JAX package's (bit-identical quantization, exact
unpacking and row dequantization), the plain version against JAX's
``reference_matmul`` and its Pallas ``_qmm_kernel`` run in interpret mode,
and the CUDA wrapper's refusals on the CPU.

Tolerance for the products: atol = rtol = 1e-5 in float32 -- the same
dequantized weight and the same f32 products, summed in another order.
The CUDA kernel's algebra (``grouped_reference``: integer codes times x,
f32 x split into three exact bf16 terms by ``split_bf16x3``, scales after
the sums) is held to both references within the card's gate,
QMM_TOLERANCE: ||out - ref|| / ||ref|| <= 1e-5 and max|out - ref| /
max|ref| <= 1e-4 (chip_smoke.py), unchanged from the kernel's."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.ops.pallas.quant_matmul as jqm
import paddle_tpu_torch.ops.quant_matmul as tqm
from _torch_threads import torch_threads  # noqa: F401

TOL = dict(atol=1e-5, rtol=1e-5)
QMM_TOLERANCE = {"l2_rel": 1e-5, "max_rel": 1e-4}
WDTS = ["int8", "int4"]
# K: whole 128-row groups, a partial last group, and the tiny engine
# configs' widths (one partial group); N: lane-aligned and ragged
SHAPES = [(256, 128), (200, 97), (64, 32), (32, 64)]


def _weight(K, N, seed=0, zero_col=True):
    w = np.random.RandomState(seed).randn(K, N).astype(np.float32)
    if zero_col:
        w[:, 3] = 0.0                 # an all-zero channel quantizes at 1.0
    return w


@pytest.mark.parametrize("K,N", SHAPES, ids=lambda v: str(v))
@pytest.mark.parametrize("wdt", WDTS)
def test_quantize_weight_bit_identical_to_jax(wdt, K, N):
    w = _weight(K, N)
    jq, js = jqm.quantize_weight(w, wdt)
    tq, ts = tqm.quantize_weight(torch.from_numpy(w), wdt)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # and the dense dequantization agrees exactly
    np.testing.assert_array_equal(
        tqm.dequantize_weight(tq, ts, wdt).numpy(),
        np.asarray(jqm.dequantize_weight(jq, js, wdt)))


@pytest.mark.parametrize("wdt", WDTS)
def test_quantize_embedding_and_row_dequant_match_jax(wdt):
    table = _weight(53, 64, seed=2)
    table[5] = 0.0                    # an all-zero row
    jq, js = jqm.quantize_embedding(table, wdt)
    tq, ts = tqm.quantize_embedding(torch.from_numpy(table), wdt)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    toks = np.asarray([0, 7, 51, 7, 5], np.int32)
    ref = jqm.dequantize_rows(jnp.take(jq, toks, axis=0),
                              jnp.take(js, toks, axis=0), wdt)
    got = tqm.dequantize_rows(tq[torch.from_numpy(toks).long()],
                              ts[torch.from_numpy(toks).long()], wdt)
    assert got.dtype == torch.float32 and got.shape == (5, 64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_unpack_int4_is_exact_on_every_byte():
    b = np.arange(-128, 128, dtype=np.int8)
    packed = np.stack([b, b[::-1]], axis=1)             # [256, 2]
    got = tqm.unpack_int4(torch.from_numpy(packed))
    assert got.dtype == torch.int32 and got.shape == (512, 2)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jqm.unpack_int4(jnp.asarray(packed))))
    # low nibble first, both sign-extended into [-8, 7]
    u = b.view(np.uint8).astype(np.int32)
    lo = np.where(u & 0xF >= 8, (u & 0xF) - 16, u & 0xF)
    hi = np.where(u >> 4 >= 8, (u >> 4) - 16, u >> 4)
    np.testing.assert_array_equal(got.numpy()[0::2, 0], lo)
    np.testing.assert_array_equal(got.numpy()[1::2, 0], hi)


@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("K,N", SHAPES, ids=lambda v: str(v))
@pytest.mark.parametrize("wdt", WDTS)
def test_plain_matmul_matches_jax_reference(wdt, K, N, xdt):
    w = _weight(K, N, seed=3)
    x = torch.from_numpy(np.random.RandomState(4).randn(8, K)
                         .astype(np.float32)).to(xdt)
    jq, js = jqm.quantize_weight(w, wdt)
    ref = jqm.reference_matmul(jnp.asarray(x.float().numpy()).astype(
        jnp.bfloat16 if xdt == torch.bfloat16 else jnp.float32), jq, js, wdt)
    tq, ts = tqm.quantize_weight(torch.from_numpy(w), wdt)
    out = tqm.matmul(x, tq, ts, wdt)
    assert out.dtype == torch.float32 and out.shape == (8, N)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_array_equal(
        out.numpy(), tqm.reference_matmul(x, tq, ts, wdt).numpy())


def _qmm_within(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    d = out - ref
    errs = {"l2_rel": np.linalg.norm(d) / np.linalg.norm(ref),
            "max_rel": np.abs(d).max() / np.abs(ref).max()}
    assert all(errs[k] <= v for k, v in QMM_TOLERANCE.items()), errs


@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("K,N", SHAPES + [(384, 160)], ids=lambda v: str(v))
@pytest.mark.parametrize("wdt", WDTS)
def test_kernel_algebra_matches_references(wdt, K, N, xdt):
    """grouped_reference (the kernel's order: codes times x, scales after
    the sums, int4 group by group) against the plain version and JAX's
    reference_matmul, within QMM_TOLERANCE."""
    w = _weight(K, N, seed=7)
    x = torch.from_numpy(np.random.RandomState(8).randn(16, K)
                         .astype(np.float32)).to(xdt)
    tq, ts = tqm.quantize_weight(torch.from_numpy(w), wdt)
    got = tqm.grouped_reference(x, tq, ts, wdt)
    assert got.dtype == torch.float32 and got.shape == (16, N)
    _qmm_within(got.numpy(), tqm.reference_matmul(x, tq, ts, wdt).numpy())
    jq, js = jqm.quantize_weight(w, wdt)
    ref = jqm.reference_matmul(jnp.asarray(x.float().numpy()).astype(
        jnp.bfloat16 if xdt == torch.bfloat16 else jnp.float32), jq, js, wdt)
    _qmm_within(got.numpy(), np.asarray(ref))


def _straddling():
    """f32 values that need all three bf16 terms, or sit at the edges of
    the exponent range: +-max, +-tiny (the least normal), 2**-110 (the
    least magnitude the split is exact for), powers of two one ulp above
    and below, values rounding up across a power of two in bf16, and
    1 + 2**-8 + 2**-16 + 2**-23 at many exponents."""
    f = np.finfo(np.float32)
    v = [f.max, f.tiny, np.float32(2.0 ** -110), np.float32(1.0),
         np.float32(65504.1), np.float32(3.0e38)]
    for e in range(-100, 128, 7):
        p = np.float32(2.0) ** np.float32(e)
        v += [np.nextafter(p, np.float32(0)), np.nextafter(p, np.float32(np.inf)),
              p * np.float32(1 + 2 ** -8 + 2 ** -16 + 2 ** -23),
              p * np.float32(2 - 2 ** -9), p * np.float32(1.5 + 2 ** -23)]
    v = np.asarray(v, np.float32)
    v = v[np.isfinite(v)]
    return np.concatenate([v, -v, [np.float32(0)]])


@pytest.mark.parametrize("kind", ["random", "straddling"])
def test_split_bf16x3_is_exact(kind):
    if kind == "random":
        rng = np.random.RandomState(9)
        x = (rng.randn(4096) * np.exp(rng.uniform(-70, 80, 4096))) \
            .astype(np.float32)
        x = x[np.isfinite(x) & (np.abs(x) >= 2.0 ** -110)]
    else:
        x = _straddling()
    h, m, l = tqm.split_bf16x3(torch.from_numpy(x))
    assert h.dtype == m.dtype == l.dtype == torch.bfloat16
    total = h.double() + m.double() + l.double()
    np.testing.assert_array_equal(total.numpy(), x.astype(np.float64))
    # h keeps x's top bits: never rounds up, never overflows to inf
    assert torch.isfinite(h).all()
    assert (h.double().abs() <= torch.from_numpy(x).double().abs()).all()


@pytest.fixture
def _interpret():
    old = jqm.INTERPRET
    jqm.INTERPRET = True
    yield
    jqm.INTERPRET = old


@pytest.mark.parametrize("wdt", WDTS)
def test_plain_matmul_matches_pallas_kernel_interpreted(_interpret, wdt):
    rng = np.random.RandomState(3)
    x = rng.randn(8, 256).astype(np.float32)
    w = rng.randn(256, 384).astype(np.float32)
    jq, js = jqm.quantize_weight(w, wdt)
    kern = jqm.matmul(jnp.asarray(x), jq, js, weight_dtype=wdt)
    tq, ts = tqm.quantize_weight(torch.from_numpy(w), wdt)
    out = tqm.matmul(torch.from_numpy(x), tq, ts, wdt)
    np.testing.assert_allclose(out.numpy(), np.asarray(kern), **TOL)


@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("wdt", WDTS)
def test_kernel_algebra_matches_pallas_kernel_interpreted(_interpret, wdt,
                                                          xdt):
    """grouped_reference against the Pallas kernel run in interpret mode,
    within QMM_TOLERANCE (K 320: two whole groups and a partial one)."""
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(8, 320).astype(np.float32)).to(xdt)
    w = rng.randn(320, 384).astype(np.float32)
    jq, js = jqm.quantize_weight(w, wdt)
    kern = jqm.matmul(jnp.asarray(x.float().numpy()).astype(
        jnp.bfloat16 if xdt == torch.bfloat16 else jnp.float32), jq, js,
        weight_dtype=wdt)
    tq, ts = tqm.quantize_weight(torch.from_numpy(w), wdt)
    _qmm_within(tqm.grouped_reference(x, tq, ts, wdt).numpy(),
                np.asarray(kern))


def _operands(wdt="int8", M=8, K=64, N=32, xdt=torch.float32):
    w = torch.from_numpy(_weight(K, N, seed=5))
    q, s = tqm.quantize_weight(w, wdt)
    x = torch.from_numpy(np.random.RandomState(6).randn(M, K)
                         .astype(np.float32)).to(xdt)
    return [x, q, s, wdt]


@pytest.mark.parametrize("wdt", WDTS)
def test_cpu_tensors_take_the_plain_version_and_never_count(wdt):
    tqm.launch_count = 0
    ops = _operands(wdt)
    np.testing.assert_array_equal(tqm.matmul(*ops).numpy(),
                                  tqm.reference_matmul(*ops).numpy())
    assert tqm.launch_count == 0


def test_kernel_refuses_cpu_tensors():
    tqm.launch_count = 0
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        tqm._launch_kernel(*_operands())
    assert tqm.launch_count == 0


def _bad(name):
    ops = _operands("int4" if name.startswith("int4") else "int8")
    if name == "float16_x":
        ops[0] = ops[0].half()
    elif name == "noncontiguous_x":
        ops[0] = ops[0].t().contiguous().t()
    elif name == "int32_q":
        ops[1] = ops[1].int()
    elif name == "k_mismatch":
        ops[0] = ops[0][:, :-2].contiguous()
    elif name == "int8_scales_2d":
        ops[2] = ops[2][None, :]
    elif name == "int4_odd_k":
        ops[0] = torch.zeros((8, 63))
    elif name == "int4_scale_rows":
        ops[2] = torch.cat([ops[2], ops[2]])
    elif name == "unknown_dtype":
        ops[3] = "int2"
    elif name == "x_1d":
        ops[0] = ops[0][0]
    return ops


@pytest.mark.parametrize("name", [
    "float16_x", "noncontiguous_x", "int32_q", "k_mismatch",
    "int8_scales_2d", "int4_odd_k", "int4_scale_rows", "unknown_dtype",
    "x_1d"])
def test_kernel_wrapper_rejects_bad_operands(name):
    with pytest.raises(ValueError, match="dequant matmul kernel"):
        tqm._launch_kernel(*_bad(name))


def test_quantize_rejects_bad_inputs():
    with pytest.raises(ValueError, match="even K"):
        tqm.quantize_weight(torch.zeros(7, 4), "int4")
    with pytest.raises(ValueError, match="even H"):
        tqm.quantize_embedding(torch.zeros(4, 7), "int4")
    with pytest.raises(ValueError, match="weight_dtype"):
        tqm.quantize_weight(torch.zeros(8, 4), "fp8")
    with pytest.raises(ValueError, match=r"\[K, N\]"):
        tqm.quantize_weight(torch.zeros(8), "int8")
