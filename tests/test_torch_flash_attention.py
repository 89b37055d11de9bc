"""PyTorch port, flash attention: the plain versions (what the port runs on
CPU tensors and what the CUDA kernels are held to on the card) against the
JAX package's Pallas kernels, run through the Pallas interpreter on the
CPU as tests/test_flash_attention.py runs them.

Same inputs (numpy, from a seed) through both.  float32, tolerances as in
tests/test_flash_attention.py: forward out and lse 2e-5 (rtol and atol:
both sides compute the same f32 scores and sums, in another order), the
gradients 2e-4 (the backward takes differences of f32 sums, delta and dP,
and multiplies them by p).  The JAX lse is [B*H, 1, S]; the port's is
[B, H, S] and is reshaped for the comparison.
"""
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from paddle_tpu.ops.pallas import flash_attention as FA
from paddle_tpu_torch.ops import flash_attention as fa
from _torch_threads import torch_threads  # noqa: F401

FWD_TOL = 2e-5
BWD_TOL = 2e-4
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _interpret():
    prev = FA.INTERPRET
    FA.INTERPRET = True
    yield
    FA.INTERPRET = prev


def _inputs(B, S, H, Hk, D, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, S, H, D).astype(np.float32),
            rng.randn(B, S, Hk, D).astype(np.float32),
            rng.randn(B, S, Hk, D).astype(np.float32),
            rng.randn(B, S, H, D).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


SHAPES = [  # B, S, H, Hk, D
    (2, 128, 4, 4, 64), (2, 128, 4, 2, 64), (1, 128, 8, 2, 64),
    (1, 128, 4, 1, 64), (1, 128, 2, 2, 128), (1, 128, 4, 2, 128),
    (1, 128, 2, 1, 256)]
IDS = ["mha", "gqa4_2", "gqa8_2", "mqa4_1", "d128", "d128_gqa", "d256_mqa"]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("B,S,H,Hk,D", SHAPES, ids=IDS)
def test_plain_forward_matches_pallas_kernel(B, S, H, Hk, D, causal):
    q, k, v, _ = _inputs(B, S, H, Hk, D)
    out_j, lse_j = FA._flash_fwd_pallas(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), causal)
    out, lse = fa.flash_fwd_reference(*_t(q, k, v), causal)
    assert out.shape == (B, S, H, D) and lse.shape == (B, H, S)
    assert out.dtype == torch.float32 and lse.dtype == torch.float32
    _close(out, out_j, FWD_TOL)
    _close(lse, np.asarray(lse_j).reshape(B, H, S), FWD_TOL)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("B,S,H,Hk,D", SHAPES, ids=IDS)
def test_plain_backward_matches_pallas_vjp(B, S, H, Hk, D, causal):
    q, k, v, g = _inputs(B, S, H, Hk, D, seed=1)
    _, vjp = jax.vjp(lambda a, b, c: FA._flash_attention(causal, a, b, c),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(g))
    qt, kt, vt, gt = _t(q, k, v, g)
    out, lse = fa.flash_fwd_reference(qt, kt, vt, causal)
    got = fa.flash_bwd_reference(qt, kt, vt, out, lse, gt, causal)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        _close(a, b, BWD_TOL)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("B,S,H,Hk,D", SHAPES[:4], ids=IDS[:4])
def test_autograd_function_on_cpu_is_the_plain_version(B, S, H, Hk, D,
                                                       causal):
    """``attention`` on CPU tensors: its output and gradients are the
    plain versions', bit for bit, and it launches no kernel."""
    q, k, v, g = _inputs(B, S, H, Hk, D, seed=2)
    qt, kt, vt, gt = _t(q, k, v, g)
    for x in (qt, kt, vt):
        x.requires_grad_(True)
    counts = (fa.fwd_launch_count, fa.dkdv_launch_count, fa.dq_launch_count)
    out = fa.attention(qt, kt, vt, causal)
    out.backward(gt)
    assert (fa.fwd_launch_count, fa.dkdv_launch_count,
            fa.dq_launch_count) == counts
    with torch.no_grad():
        ref, lse = fa.flash_fwd_reference(qt, kt, vt, causal)
        want = fa.flash_bwd_reference(qt, kt, vt, ref, lse, gt, causal)
    assert torch.equal(out.detach(), ref)
    for x, w in zip((qt, kt, vt), want):
        assert torch.equal(x.grad, w)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_split_backward_equals_whole(causal):
    """The dK/dV and dQ plain versions, called apart with delta computed
    outside (as the kernels are), give the whole backward's gradients."""
    q, k, v, g = _t(*_inputs(1, 96, 4, 2, 64, seed=3))
    out, lse = fa.flash_fwd_reference(q, k, v, causal)
    dq, dk, dv = fa.flash_bwd_reference(q, k, v, out, lse, g, causal)
    delta = fa.attention_delta(out, g)
    assert delta.shape == (1, 4, 96)
    dk2, dv2 = fa.flash_bwd_dkdv_reference(q, k, v, g, lse, delta, causal)
    dq2 = fa.flash_bwd_dq_reference(q, k, v, g, lse, delta, causal)
    for a, b in ((dq, dq2), (dk, dk2), (dv, dv2)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("S", [100, 65, 1], ids=["S100", "S65", "S1"])
def test_plain_version_at_ragged_lengths_matches_the_oracle(S):
    """S need not be a multiple of 64 or 128: the plain versions against
    the JAX package's O(S^2) oracle and its autodiff (Sq == Sk, where the
    kernels' top-left causal mask and the oracle's bottom-right agree)."""
    q, k, v, g = _inputs(1, S, 4, 2, 64, seed=4)
    ref_fn = lambda a, b, c: FA._ref_attention(a, b, c, True)  # noqa: E731
    want, vjp = jax.vjp(ref_fn, jnp.asarray(q), jnp.asarray(k),
                        jnp.asarray(v))
    qt, kt, vt, gt = _t(q, k, v, g)
    out, lse = fa.flash_fwd_reference(qt, kt, vt, True)
    _close(out, want, FWD_TOL)
    _close(fa._ref_attention(qt, kt, vt, True), want, FWD_TOL)
    for a, b in zip(fa.flash_bwd_reference(qt, kt, vt, out, lse, gt, True),
                    vjp(jnp.asarray(g))):
        _close(a, b, BWD_TOL)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_ref_attention_oracle_matches_jax_across_lengths(causal):
    """The oracle keeps the JAX oracle's bottom-right causal mask when
    Sq != Sk (the case the kernels refuse)."""
    rng = np.random.RandomState(5)
    q = rng.randn(1, 48, 4, 64).astype(np.float32)
    k = rng.randn(1, 80, 2, 64).astype(np.float32)
    v = rng.randn(1, 80, 2, 64).astype(np.float32)
    want = FA._ref_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal)
    _close(fa._ref_attention(*_t(q, k, v), causal), want, FWD_TOL)


def test_wrong_gqa_head_map_is_caught():
    """A control that must fail: query head j reading kv head j % Hk
    instead of j // G gives plausible numbers that the comparison with
    the Pallas kernel rejects."""
    B, S, H, Hk, D = 1, 128, 8, 2, 64
    q, k, v, _ = _inputs(B, S, H, Hk, D, seed=6)
    want, _ = FA._flash_fwd_pallas(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), True)
    qt, kt, vt = _t(q, k, v)
    G = H // Hk
    tiled = lambda x: x.repeat(1, 1, G, 1)  # noqa: E731  head j -> j % Hk
    wrong = fa._ref_attention(qt, tiled(kt), tiled(vt), True)
    assert not np.allclose(wrong.numpy(), np.asarray(want), atol=1e-2)
    right = fa._ref_attention(qt, fa._repeat_kv(kt, G), fa._repeat_kv(vt, G),
                              True)
    _close(right, want, FWD_TOL)


def test_bf16_plain_version_rounds_where_the_kernel_does():
    """bf16 at D = 128 (sm_scale not a power of two): the plain forward
    rounds q * sm_scale and p to bf16, and so agrees with the Pallas
    kernel in bf16 far closer than with the unrounded f32 oracle."""
    B, S, H, Hk, D = 1, 128, 2, 2, 128
    q, k, v, _ = _inputs(B, S, H, Hk, D, seed=7)
    bf = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
    out_j, lse_j = FA._flash_fwd_pallas(*bf, True)
    tq, tk, tv = (torch.from_numpy(np.asarray(x, np.float32)).to(
        torch.bfloat16) for x in bf)
    out, lse = fa.flash_fwd_reference(tq, tk, tv, True)
    assert out.dtype == torch.bfloat16
    d = np.abs(out.float().numpy() - np.asarray(out_j, np.float32))
    # one bf16 ulp of outputs up to ~2 is 2^-7; only summation order differs
    assert d.max() <= 2 ** -7
    _close(lse, np.asarray(lse_j).reshape(B, H, S), 1e-4)


# The bf16 backward kernels at D 64 read q and k unscaled and multiply the
# f32 scores, dK and dQ by sm_scale = 2^-3 instead of rounding q * sm_scale
# and k * sm_scale to bf16 first (csrc/flash_attention.cu).  Both are the
# same bits: a bf16 value times 2^-3 is a bf16 value (outside the subnormal
# range), bf16 x bf16 products are exact in f32, and scaling every addend
# of an f32 sum by a power of two scales each partial sum exactly, in any
# fixed summation order.

def _bf16_values(bits):
    """bf16 numbers from their 16-bit patterns, as f32 tensors."""
    return torch.tensor(np.asarray(bits, np.uint16).view(np.int16)).view(
        torch.bfloat16).float()


def _sequential_sum(x):
    """f32 sum, left to right (numpy float32 additions)."""
    acc = np.float32(0)
    for v in x.numpy():
        acc = np.float32(acc + v)
    return acc


# normal bf16 values with exponents in [-60, 60]: q * 2^-3 stays normal and
# no product or 64-term sum leaves the f32 range
_BF16_NORMAL = st.builds(lambda sgn, e, m: (sgn << 15) | ((e + 127) << 7) | m,
                         st.integers(0, 1), st.integers(-60, 60),
                         st.integers(0, 127))


@settings(max_examples=300, deadline=None)
@given(st.lists(st.tuples(_BF16_NORMAL, _BF16_NORMAL), min_size=1,
                max_size=64))
def test_d64_scale_fold_is_bit_exact(pairs):
    """sum_i bf16(q_i * 2^-3) * k_i == 2^-3 * sum_i q_i * k_i, bit for bit,
    summed left to right and in torch's own order."""
    q = _bf16_values([a for a, _ in pairs])
    k = _bf16_values([b for _, b in pairs])
    qs = (q * 0.125).to(torch.bfloat16).float()     # the rounding point
    assert torch.equal(qs, q * 0.125)
    folded = np.float32(0.125) * _sequential_sum(q * k)
    assert _sequential_sum(qs * k).tobytes() == folded.tobytes()
    assert torch.equal((qs * k).sum(), 0.125 * (q * k).sum())


def test_d64_scale_fold_fails_only_below_the_normal_range():
    """The named exception: where q * 2^-3 falls below 2^-126, bf16 keeps
    fewer significant bits, so rounding q * sm_scale to bf16 loses one the
    fold keeps.  Here q = 2^-126 (1 + 2^-7), q * 2^-3 = 2^-129 (1 + 2^-7)
    rounds to 2^-129.  Attention activations that small do not occur; the
    random inputs of the card tests are N(0, 1)."""
    q = _bf16_values([(1 << 7) | 1])                # 2^-126 (1 + 2^-7)
    assert q.item() == 2.0 ** -126 * (1 + 2.0 ** -7)
    qs = (q * 0.125).to(torch.bfloat16).float()
    assert qs.item() == 2.0 ** -129
    assert not torch.equal(qs, q * 0.125)


def _folded_backward(q, k, v, do, lse, delta, causal):
    """The plain backward computed as the D 64 kernels compute it: scores
    of the unscaled q, times sm_scale in f32; dK and dQ from the unscaled q
    and k, times sm_scale at the end."""
    sm_scale = 1.0 / np.sqrt(q.shape[-1])
    G = q.shape[2] // k.shape[2]
    kf, vf = fa._repeat_kv(k, G).float(), fa._repeat_kv(v, G).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * sm_scale
    if causal:
        keep = torch.ones(s.shape[-2:], dtype=torch.bool).tril()
        s = torch.where(keep, s, float("-inf"))
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), vf)
    ds = fa._round(p * (dp - delta[..., None]), q.dtype)
    dv = torch.einsum("bhqk,bqhd->bkhd", fa._round(p, do.dtype), do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * sm_scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * sm_scale
    hk = k.shape[2]
    return (dq.to(q.dtype), fa._group_sum(dk, hk).to(k.dtype),
            fa._group_sum(dv, hk).to(v.dtype))


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("D", [64, 128])
def test_folded_backward_equals_plain_version_at_d64_only(D, causal):
    """bf16 inputs: the folded backward gives the plain versions' dQ, dK
    and dV bit for bit at D 64; at D 128 (sm_scale 2^-3.5) it does not,
    which is why the D 128 kernels round the scaled tiles in shared
    memory."""
    q, k, v, g = (torch.from_numpy(x).to(torch.bfloat16)
                  for x in _inputs(1, 96, 8, 2, D, seed=8))
    out, lse = fa.flash_fwd_reference(q, k, v, causal)
    delta = fa.attention_delta(out, g)
    dk, dv = fa.flash_bwd_dkdv_reference(q, k, v, g, lse, delta, causal)
    dq = fa.flash_bwd_dq_reference(q, k, v, g, lse, delta, causal)
    got = _folded_backward(q, k, v, g, lse, delta, causal)
    same = [torch.equal(a, b) for a, b in zip(got, (dq, dk, dv))]
    if D == 64:
        assert all(same)
    else:
        assert not any(same)                    # p moves, so dV does too


# the CUDA wrapper's refusals: checked before any launch, so they show on
# CPU tensors too; an acceptable CPU operand is refused for its device


def _ops(shape=(1, 64, 4, 64), kv=(1, 64, 2, 64), dtype=torch.float32):
    return (torch.zeros(shape, dtype=dtype), torch.zeros(kv, dtype=dtype),
            torch.zeros(kv, dtype=dtype))


@pytest.mark.parametrize("ops,causal,match", [
    (_ops(dtype=torch.float16), True, "dtype"),
    (_ops((1, 64, 4, 32), (1, 64, 2, 32)), True, "head dim"),
    (_ops((1, 64, 4, 96), (1, 64, 2, 96)), True, "head dim"),
    (_ops((1, 64, 2, 384), (1, 64, 1, 384)), True, "head dim"),
    (_ops((1, 64, 6, 64), (1, 64, 4, 64)), True, "multiple"),
    (_ops((1, 64, 4, 64), (1, 80, 2, 64)), True, "Sq == Sk"),
    (_ops((1, 0, 4, 64), (1, 0, 2, 64)), False, "empty"),
], ids=["f16", "d32", "d96", "d384", "h6_hk4", "causal_sq_ne_sk",
        "empty"])
def test_cuda_wrapper_refuses_what_the_kernels_do_not_take(ops, causal,
                                                          match):
    """Head dim 384 is inside the contract (the JAX rule takes every
    multiple of 128), so there only the CPU device is refused."""
    if ops[0].shape[-1] == 384:
        with pytest.raises(RuntimeError, match="CUDA tensors only"):
            fa._launch_fwd(*ops, causal)
        return
    with pytest.raises(ValueError, match=match):
        fa._launch_fwd(*ops, causal)


def test_cuda_wrapper_refuses_bad_backward_operands():
    q, k, v = _ops()
    lse = torch.zeros((1, 4, 64))
    with pytest.raises(ValueError, match="lse"):
        fa._launch_dkdv(q, k, v, q, lse[:, :, :32], lse, True)
    with pytest.raises(ValueError, match="dout"):
        fa._launch_dq(q, k, v, q.to(torch.bfloat16), lse, lse, True)


def test_cuda_wrapper_runs_on_cuda_tensors_only():
    q, k, v = _ops()
    lse = torch.zeros((1, 4, 64))
    with pytest.raises(RuntimeError, match="CUDA tensors only"):
        fa._launch_fwd(q, k, v, True)
    with pytest.raises(RuntimeError, match="CUDA tensors only"):
        fa._launch_dkdv(q, k, v, q, lse, lse, True)
    with pytest.raises(RuntimeError, match="CUDA tensors only"):
        fa._launch_dq(q, k, v, q, lse, lse, True)


def test_attention_refuses_causal_across_lengths_on_every_device():
    q, k, v = _ops((1, 64, 4, 64), (1, 80, 2, 64))
    with pytest.raises(ValueError, match="Sq == Sk"):
        fa.attention(q, k, v, causal=True)
    out = fa.attention(q, k, v, causal=False)
    assert out.shape == q.shape


@pytest.mark.parametrize("G", [1, 4, 8, 16, 32])
@pytest.mark.parametrize("D", [64, 96, 128, 256, 384, 512])
def test_kernel_contract_head_dims_equal_jax_rule(D, G):
    """The kernels take every head dim and group the JAX ``_shapes_eligible``
    sends to its kernels (64, 128, 256 and every multiple of 128): there
    only the CPU device is refused."""
    H, Hk = G, 1
    rule = FA._shapes_eligible((1, 128, H, D), "float32", (1, 128, Hk, D),
                               causal=True)
    q, k, v = _ops((1, 128, H, D), (1, 128, Hk, D))
    with pytest.raises(RuntimeError if rule else ValueError,
                       match="CUDA tensors only" if rule else "head dim"):
        fa._launch_fwd(q, k, v, True)
    lse = torch.zeros((1, H, 128))
    for launch in (fa._launch_dkdv, fa._launch_dq):
        with pytest.raises(RuntimeError if rule else ValueError,
                           match="CUDA tensors only" if rule else "head dim"):
            launch(q, k, v, q, lse, lse, True)


def test_profile_split_names_every_flash_kernel():
    """chip_smoke.py splits the train step's flash time by launch through
    FLASH_KERNEL_NAMES: the list holds every kernel that
    csrc/flash_attention.cu defines, each profiled symbol goes to its own
    launch by whole name (flash_fwd_kernel is not flash_fwd_wgmma_kernel),
    and cuBLAS and CUTLASS GEMM symbols go to none."""
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    src = (REPO / "paddle_tpu_torch/csrc/flash_attention.cu").read_text()
    defined = set(re.findall(r"__global__ void[^\n]*\n(\w+)\(", src))
    named = {n for names in cs.FLASH_KERNEL_NAMES.values() for n in names}
    assert defined == named
    for kern, names in cs.FLASH_KERNEL_NAMES.items():
        for n in names:
            sym = f"void (anonymous namespace)::{n}<64>(CUtensorMap_st, int)"
            assert cs.flash_kernel(sym) == kern
    for sym in ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64",
                "cutlass_80_tensorop_bf16_s16816gemm_bf16_64x64_64x4_tn",
                "nvjet_tst_128x256_64x4_2x1_v_bz_coopA_TNT",
                "void (anonymous namespace)::vbwd_dkdv_kernel<float, 64>()"):
        assert cs.flash_kernel(sym) is None
