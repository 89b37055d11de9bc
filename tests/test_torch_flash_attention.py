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
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import flash_attention as FA
from paddle_tpu_torch.ops import flash_attention as fa

FWD_TOL = 2e-5
BWD_TOL = 2e-4


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
