"""PyTorch port, logit chain and sampler: each processor and the greedy
path against the JAX package on the same logits, and the sampled path's
reproducibility and distribution against ``target_dist`` (the JAX
package's host-side distribution of the same chain).  Sampled rows draw
from the JAX engine's threefry keys, so mixed launches also equal JAX's
``sample_tokens`` token for token (tests/test_torch_sampling_keys.py
holds the keys and draws bit for bit)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.inference import sampling as js
from paddle_tpu_torch.inference import prng
from paddle_tpu_torch.inference import sampling as ts
from _torch_threads import torch_threads  # noqa: F401

V = 50


def _samp(rng, B):
    samp = ts.make_samp(B, V)
    samp["temps"][:] = rng.choice([0.0, 0.7, 1.3], B)
    samp["top_k"][:] = rng.choice([0, 1, 5, 20], B)
    samp["top_p"][:] = rng.choice([1.0, 0.9, 0.5], B)
    samp["penalty"][:] = rng.choice([1.0, 1.3, 0.8], B)
    samp["seen"][:] = rng.rand(B, V) < 0.3
    samp["keys"][:] = [prng.request_key(s, i) for s, i in
                       zip(rng.randint(0, 1000, B), rng.randint(0, 100, B))]
    return samp


def _logits(rng, B):
    lg = rng.randn(B, V).astype(np.float32) * 2
    lg[:, 3] = lg[:, 4]                        # an exact tie per row
    return lg


def _jax_samp(samp):
    return {k: jnp.asarray(v) for k, v in samp.items()}


@pytest.mark.parametrize("proc", ["RepetitionPenaltyProcessor",
                                  "TemperatureProcessor", "TopKProcessor",
                                  "TopPProcessor"])
def test_processor_matches_jax(proc):
    rng = np.random.RandomState(0)
    B = 12
    lg, samp = _logits(rng, B), _samp(rng, B)
    ref = getattr(js, proc)()(jnp.asarray(lg), _jax_samp(samp), jnp)
    st = {k: torch.from_numpy(v) for k, v in samp.items()}
    out = getattr(ts, proc)()(torch.from_numpy(lg), st)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6)


@pytest.mark.parametrize("penalty", [False, True])
def test_greedy_rows_match_jax_exactly(penalty):
    rng = np.random.RandomState(1)
    B = 16
    lg, samp = _logits(rng, B), _samp(rng, B)
    samp["temps"][:] = 0.0
    if not penalty:
        samp["penalty"][:] = 1.0
    ref = js.sample_tokens(jnp.asarray(lg), _jax_samp(samp))
    out = ts.sample_tokens(torch.from_numpy(lg), samp)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_mixed_launch_greedy_rows_unaffected_by_sampled_rows():
    rng = np.random.RandomState(2)
    B = 16
    lg, samp = _logits(rng, B), _samp(rng, B)
    ref = js.sample_tokens(jnp.asarray(lg), _jax_samp(samp))
    out = ts.sample_tokens(torch.from_numpy(lg), samp)
    greedy = samp["temps"] <= 0
    assert greedy.any() and (~greedy).any()
    np.testing.assert_array_equal(out.numpy()[greedy],
                                  np.asarray(ref)[greedy])


@pytest.mark.parametrize("seed", [2, 5, 8])
def test_mixed_launch_equals_jax_token_for_token(seed):
    """Every row, greedy and sampled, equals JAX's sample_tokens on the
    same logits and keys (the sampled rows through the full chain)."""
    rng = np.random.RandomState(seed)
    B = 16
    lg, samp = _logits(rng, B), _samp(rng, B)
    ref = js.sample_tokens(jnp.asarray(lg), _jax_samp(samp))
    out = ts.sample_tokens(torch.from_numpy(lg), samp)
    assert (samp["temps"] > 0).sum() >= 4
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_sampled_draw_depends_only_on_seed_and_index():
    rng = np.random.RandomState(3)
    lg = _logits(rng, 1)[0]
    samp = ts.make_samp(4, V)
    samp["temps"][:] = 1.0
    pairs = [(5, 9), (6, 9), (5, 9), (5, 10)]
    samp["keys"][:] = [prng.request_key(*p) for p in pairs]
    logits = torch.from_numpy(np.stack([lg] * 4))
    a = ts.sample_tokens(logits, samp).numpy()
    assert a[0] == a[2]                        # same (seed, index), any row
    assert np.array_equal(a, ts.sample_tokens(logits, samp).numpy())
    # the same pair in a differently shaped launch draws the same token
    one = ts.make_samp(1, V)
    one["temps"][:] = 1.0
    one["keys"][:] = [prng.request_key(5, 9)]
    assert ts.sample_tokens(logits[:1], one).numpy()[0] == a[0]
    # a key is a function of the pair alone: the JAX engine's
    # fold_in(PRNGKey(seed), index), distinct for distinct pairs
    keys = [prng.request_key(*p) for p in ((5, 9), (5, 10), (6, 9))]
    assert len({k.tobytes() for k in keys}) == 3
    for (s, i), k in zip(((5, 9), (5, 10), (6, 9)), keys):
        np.testing.assert_array_equal(
            k, np.asarray(jax.random.fold_in(jax.random.PRNGKey(s), i)))


@pytest.mark.parametrize("temp,top_k,top_p,penalty", [
    (1.0, 0, 1.0, 1.0), (0.7, 8, 1.0, 1.0), (1.2, 0, 0.8, 1.3)])
def test_sampled_distribution_matches_target_dist(temp, top_k, top_p,
                                                  penalty):
    """4,000 draws at distinct token indices: every token's frequency sits
    within 4.5 standard errors of target_dist's probability, and the
    total-variation distance is below 0.04."""
    rng = np.random.RandomState(4)
    row = rng.randn(V).astype(np.float32)
    seen = rng.rand(V) < 0.3
    N = 4000
    samp = ts.make_samp(N, V)
    samp["temps"][:] = temp
    samp["top_k"][:] = top_k
    samp["top_p"][:] = top_p
    samp["penalty"][:] = penalty
    samp["seen"][:] = seen
    samp["keys"][:] = [prng.request_key(11, i) for i in range(N)]
    toks = ts.sample_tokens(torch.from_numpy(np.tile(row, (N, 1))),
                            samp).numpy()
    p = js.target_dist(row, temperature=temp, top_k=top_k, top_p=top_p,
                       penalty=penalty, seen=seen)
    freq = np.bincount(toks, minlength=V) / N
    se = np.sqrt(p * (1 - p) / N) + 1e-12
    assert (np.abs(freq - p) <= 4.5 * se + 1e-9).all()
    assert 0.5 * np.abs(freq - p).sum() < 0.04
    assert (freq[p == 0] == 0).all()           # truncated tokens never drawn
