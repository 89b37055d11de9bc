"""PyTorch port, logit processors written to the JAX package's interface
(``proc(lg, samp, xp)``, no ``host`` method) in a ``chain=``: the port's
``sample_tokens`` (CPU tensors) and ``target_dist`` against the JAX
package's two functions on the same seeded logits and ``samp``; the
device sampler refuses such a stage; the port's own stages keep their
form and results."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.inference import sampling as js
from paddle_tpu_torch.inference import prng
from paddle_tpu_torch.inference import sampling as ts
from _torch_threads import torch_threads  # noqa: F401

V = 50
BANNED = (3, 7, 11, 19, 42)


def _ban_class(base, greedy_visible):
    """A stage that sends a fixed token set to -inf through ``xp.where``
    over ``xp.arange``: the JAX package's interface on any base class."""

    class BanTokens(base):
        def __call__(self, lg, samp, xp):
            ids = xp.arange(lg.shape[-1])
            banned = xp.zeros(lg.shape[-1], dtype=bool)
            for t in BANNED:
                banned = banned | (ids == t)
            return xp.where(banned[None, :], float("-inf"), lg)

    BanTokens.greedy_visible = greedy_visible
    return BanTokens


BASES = {"object": object, "jax_LogitProcessor": js.LogitProcessor,
         "port_LogitProcessor": ts.LogitProcessor}


def _chains(base, greedy_visible):
    ban = _ban_class(BASES[base], greedy_visible)()
    # the ban between the penalty and temperature, as a user would insert
    return ((ts.DEFAULT_CHAIN[0], ban) + ts.DEFAULT_CHAIN[1:],
            (js.DEFAULT_CHAIN[0], ban) + js.DEFAULT_CHAIN[1:])


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
    lg[:, BANNED[0]] += 6.0                    # the banned tokens lead
    lg[:, 5] = lg[:, 6]                        # an exact tie per row
    return lg


def _jax_samp(samp):
    return {k: jnp.asarray(v) for k, v in samp.items()}


@pytest.mark.parametrize("base", list(BASES))
@pytest.mark.parametrize("greedy_visible", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_reference_stage_sample_tokens_equals_jax(base, greedy_visible,
                                                  seed):
    """Greedy and sampled rows, token for token the JAX package's
    ``sample_tokens`` through the same chain."""
    rng = np.random.RandomState(seed)
    B = 16
    lg, samp = _logits(rng, B), _samp(rng, B)
    port_chain, jax_chain = _chains(base, greedy_visible)
    assert ts.is_reference_stage(port_chain[1])
    ref = np.asarray(js.sample_tokens(jnp.asarray(lg), _jax_samp(samp),
                                      chain=jax_chain))
    out = ts.sample_tokens(torch.from_numpy(lg), samp, chain=port_chain)
    assert out.dtype == torch.int32 and out.shape == (B,)
    greedy = samp["temps"] <= 0
    assert greedy.any() and (~greedy).any()
    np.testing.assert_array_equal(out.numpy(), ref)
    # the stage bites: no sampled row draws a banned token, and greedy rows
    # avoid them exactly when the stage is greedy-visible
    assert not np.isin(out.numpy()[~greedy], BANNED).any()
    assert np.isin(out.numpy()[greedy], BANNED).any() != greedy_visible


@pytest.mark.parametrize("base", list(BASES))
@pytest.mark.parametrize("greedy_visible", [True, False])
@pytest.mark.parametrize("kw", [
    dict(temperature=0.0, penalty=1.3),
    dict(temperature=1.0),
    dict(temperature=0.7, top_k=8, penalty=0.8),
    dict(temperature=1.2, top_p=0.8, penalty=1.3)])
def test_reference_stage_target_dist_equals_jax(base, greedy_visible, kw):
    """The host distribution through a chain with the stage, within 1e-6
    of the JAX package's ``target_dist``."""
    rng = np.random.RandomState(7)
    row = _logits(rng, 1)[0]
    seen = rng.rand(V) < 0.3
    port_chain, jax_chain = _chains(base, greedy_visible)
    ref = js.target_dist(row, seen=seen, chain=jax_chain, **kw)
    out = ts.target_dist(row, seen=seen, chain=port_chain, **kw)
    assert out.dtype == np.float32 and out.shape == (V,)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
    if greedy_visible or kw["temperature"] > 0:
        assert out[list(BANNED)].sum() == 0.0


@pytest.mark.parametrize("base", list(BASES))
def test_sample_tokens_device_refuses_reference_stage(base):
    """The device sampler (the decode window's, every iteration) never
    runs a reference-style stage on the host: it refuses by name."""
    rng = np.random.RandomState(3)
    lg, samp = _logits(rng, 4), _samp(rng, 4)
    port_chain, _ = _chains(base, True)
    rows, needs_penalty = ts.sampling_plan(samp)
    st = ts.samp_to_device(samp, "cpu", needs_penalty)
    keys = torch.from_numpy(samp["keys"][rows].astype(np.int64))
    with pytest.raises(NotImplementedError,
                       match=r"BanTokens.*ROADMAP Queue 3 item 1"):
        ts.sample_tokens_device(torch.from_numpy(lg), st,
                                torch.from_numpy(rows), keys,
                                needs_penalty, chain=port_chain)


class _HostAdapter:
    """A port stage behind the JAX package's interface (its numpy form)."""

    def __init__(self, proc):
        self.proc, self.greedy_visible = proc, proc.greedy_visible

    def __call__(self, lg, samp, xp):
        assert xp is np
        return self.proc.host(lg, samp)


@pytest.mark.parametrize("seed", [2, 5])
def test_builtin_processors_unchanged(seed):
    """The port's own stages keep the ``(lg, samp)`` + ``host`` form; the
    default chain gives the JAX package's tokens and distributions, and
    the host route a reference-style chain takes gives the same tokens as
    the device route for the same stages."""
    assert not any(ts.is_reference_stage(p) for p in ts.DEFAULT_CHAIN)
    assert ts.is_reference_stage(js.DEFAULT_CHAIN[0])
    rng = np.random.RandomState(seed)
    B = 16
    lg, samp = _logits(rng, B), _samp(rng, B)
    ref = np.asarray(js.sample_tokens(jnp.asarray(lg), _jax_samp(samp)))
    out = ts.sample_tokens(torch.from_numpy(lg), samp).numpy()
    np.testing.assert_array_equal(out, ref)
    host = ts.sample_tokens(torch.from_numpy(lg), samp,
                            chain=tuple(map(_HostAdapter, ts.DEFAULT_CHAIN)))
    np.testing.assert_array_equal(host.numpy(), out)
    for b in range(4):
        kw = dict(temperature=float(samp["temps"][b]),
                  top_k=int(samp["top_k"][b]),
                  top_p=float(samp["top_p"][b]),
                  penalty=float(samp["penalty"][b]), seen=samp["seen"][b])
        np.testing.assert_array_equal(ts.target_dist(lg[b], **kw),
                                      js.target_dist(lg[b], **kw))
