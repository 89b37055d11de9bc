"""PyTorch port, ``nn.functional``'s fixed-length attention:
``scaled_dot_product_attention`` and ``flash_attention`` against the JAX
package's.  Both route the same way from shapes: the flash kernels (the
JAX ones run by the Pallas interpreter, the port's plain versions on CPU
tensors) where the JAX ``_shapes_eligible`` holds and there is no mask,
the composition ``_sdpa_ref`` otherwise.  float32, rtol and atol 2e-5:
the same f32 math, sums in another order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nn.functional import attention as JA
from paddle_tpu.ops.pallas import flash_attention as FA
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.functional import attention as TA
from _torch_threads import torch_threads  # noqa: F401

TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(autouse=True)
def _interpret():
    prev = FA.INTERPRET
    FA.INTERPRET = True
    yield
    FA.INTERPRET = prev


def _qkv(B, Sq, Sk, H, Hk, D, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, Sq, H, D).astype(np.float32),
            rng.randn(B, Sk, Hk, D).astype(np.float32),
            rng.randn(B, Sk, Hk, D).astype(np.float32))


def _np(x):
    x = x._data if hasattr(x, "_data") else x
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


CASES = {  # B, Sq, Sk, H, Hk, D, causal, mask, takes the flash route
    "flash_causal": (1, 128, 128, 2, 2, 64, True, None, True),
    "flash_gqa_full": (2, 128, 128, 4, 2, 64, False, None, True),
    "flash_cross_full": (1, 128, 256, 2, 2, 128, False, None, True),
    "flash_d256_gqa": (1, 128, 128, 4, 2, 256, True, None, True),
    "flash_d384": (1, 128, 128, 2, 2, 384, False, None, True),
    "seq_not_128": (1, 96, 96, 2, 2, 64, True, None, False),
    "causal_cross": (1, 128, 256, 2, 2, 64, True, None, False),
    "bool_mask": (1, 64, 64, 2, 2, 32, False, "bool", False),
    "float_mask": (1, 64, 80, 2, 1, 32, False, "float", False),
}


@pytest.mark.parametrize("name", list(CASES))
def test_sdpa_matches_jax(name):
    B, Sq, Sk, H, Hk, D, causal, mask, flash = CASES[name]
    q, k, v = _qkv(B, Sq, Sk, H, Hk, D)
    m = None
    if mask == "bool":
        m = np.random.RandomState(1).rand(B, H, Sq, Sk) > 0.3
        m[..., 0] = True                      # every row sees a key
    elif mask == "float":
        m = np.random.RandomState(1).randn(B, 1, Sq, Sk).astype(np.float32)
    tq = torch.from_numpy(q)
    tk = torch.from_numpy(k)
    assert TA._flash_eligible(tq, tk, causal) is flash
    assert JA.get_flag("use_pallas_kernels")
    want = JA.scaled_dot_product_attention(
        *(paddle.to_tensor(x) for x in (q, k, v)),
        attn_mask=None if m is None else paddle.to_tensor(jnp.asarray(m)),
        is_causal=causal)
    got = F.scaled_dot_product_attention(
        tq, tk, torch.from_numpy(v),
        attn_mask=None if m is None else torch.from_numpy(m),
        is_causal=causal)
    assert got.shape == (B, Sq, H, D)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("D", [256, 384])
def test_flash_route_reaches_the_flash_attention_function(D, monkeypatch):
    """Every head dim the JAX rule takes (64, 128, 256, multiples of 128)
    goes to ``ops.flash_attention.attention``; on CUDA tensors that
    launches the kernels at every one of them."""
    calls = []
    real = TA._fa.attention

    def spy(q, k, v, causal=True):
        calls.append(q.shape[-1])
        return real(q, k, v, causal=causal)
    monkeypatch.setattr(TA._fa, "attention", spy)
    q, k, v = _qkv(1, 128, 128, 2, 2, D, seed=3)
    F.scaled_dot_product_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                   is_causal=False)
    assert calls == [D]


def test_flash_attention_returns_no_softmax():
    q, k, v = _qkv(1, 128, 128, 2, 2, 64, seed=2)
    out, soft = F.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                  causal=True)
    jout, jsoft = JA.flash_attention(*(paddle.to_tensor(x)
                                       for x in (q, k, v)), causal=True)
    assert soft is None and jsoft is None
    np.testing.assert_allclose(_np(out), _np(jout), **TOL)
