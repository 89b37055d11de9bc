"""ops/random.py of the port (and the ops elsewhere that draw: dropout,
top_p_sampling, svd_lowrank) on the CPU, as tests/test_random_ops.py
holds the JAX package's.  The port's draws come from one
torch.Generator a device (core/random_state.py), the JAX package's from
a threefry key chain, so no value is compared across the packages.
Each draw is held to properties (tests/_torch_sweep_cases.py RANDOM):
dtype, support, the same draw from the same seed and another draw from
another seed, and the sample mean
within 6 standard errors of the distribution's mean for 20,000 draws
(the median for Cauchy).  Every test seeds the generator it draws from
first, so nothing depends on the order the tests run in."""
import numpy as np
import pytest

from _torch_eager import eager_state  # noqa: F401
from _torch_sweep import cases, hold
from _torch_threads import torch_threads  # noqa: F401

import paddle_tpu_torch as pp
import _torch_sweep_cases as S


@pytest.mark.parametrize("name", sorted(S.RANDOM))
def test_draw_properties(name):
    assert S.check_random(pp, name, "cpu") == []


@pytest.mark.parametrize("name", cases("random"))
def test_rng_state_ops_match_the_jax_package(name):
    hold(name)


def test_seeds_and_devices_are_separate_streams():
    pp.seed(3)
    a = pp.rand([8]).numpy()
    b = pp.rand([8]).numpy()
    assert not np.array_equal(a, b)
    pp.seed(3)
    np.testing.assert_array_equal(pp.rand([8]).numpy(), a)
    pp.seed(4)
    assert not np.array_equal(pp.rand([8]).numpy(), a)


def test_in_place_draws_keep_the_storage():
    pp.seed(6)
    x = pp.zeros([64])
    data = x._data
    for op, args in (("exponential_", (1.0,)), ("cauchy_", (0.0, 1.0)),
                     ("geometric_", (0.5,)), ("uniform_", ()),
                     ("normal_", ())):
        out = getattr(pp.ops.random, op)(x, *args)
        assert out is x and x._data is data, op


def test_multinomial_without_replacement_draws_distinct():
    pp.seed(8)
    probs = pp.to_tensor(np.full((5, 10), 0.1, np.float32))
    idx = pp.ops.random.multinomial(probs, 10, False).numpy()
    for row in idx:
        np.testing.assert_array_equal(np.sort(row), np.arange(10))


def test_top_p_sampling_seed_fixes_the_draw():
    probs = pp.to_tensor(np.tile(np.array([[0.4, 0.3, 0.2, 0.1]],
                                          np.float32), (64, 1)))
    ps = pp.to_tensor(np.full((64,), 0.8, np.float32))
    a = pp.ops.misc.top_p_sampling(probs, ps, seed=5)
    b = pp.ops.misc.top_p_sampling(probs, ps, seed=5)
    np.testing.assert_array_equal(a[1].numpy(), b[1].numpy())
    ids = a[1].numpy()
    assert set(np.unique(ids)) <= {0, 1, 2}      # the nucleus of p = 0.8
    np.testing.assert_allclose(a[0].numpy()[:, 0],
                               probs.numpy()[np.arange(64), ids[:, 0]])


def test_randint_like_follows_the_input_dtype():
    pp.seed(9)
    for dt in ("int32", "int64", "float32"):
        x = pp.zeros([100]).astype(dt)
        a = pp.ops.random.randint_like(x, 0, 5)
        assert a.dtype.name == dt
        assert ((a.numpy() >= 0) & (a.numpy() < 5)).all()


def test_multinomial_frequencies():
    """A zero-probability category is never drawn; each frequency of
    20,000 draws within 6 standard errors sqrt(p (1 - p) / n)."""
    pp.seed(10)
    p = np.asarray([0.1, 0.0, 0.6, 0.3], np.float32)
    n = 20000
    draws = pp.ops.random.multinomial(pp.to_tensor(p), num_samples=n,
                                      replacement=True).numpy()
    freq = np.bincount(draws, minlength=4) / n
    assert freq[1] == 0.0
    bound = 6 * np.sqrt(p * (1 - p) / n)
    assert (np.abs(freq - p) <= bound).all(), (freq, bound)
