"""PyTorch port, threefry keys and sampled draws against ``jax.random``:
``PRNGKey``/``fold_in``/``split`` and the raw 32-bit draws bit for bit
over a grid of seeds, token indices and vocabulary sizes; the uniform
floats bit for bit; the Gumbel noise within 2 ulp; and, end to end, the
port's engine and ``generate()`` sampling the JAX package's tokens token
for token on the same weights.

Gumbel tolerance: torch and XLA each round ``log`` to within an ulp of
the exact value, but not to the same ulp.  ``-log(-log(u))`` near ``g =
0`` (u near 1/e) takes the log of a value near 1, so an ulp of the inner
log (at magnitude 1) becomes an absolute error of about 1.2e-7 around a
result that may be far smaller.  The bound is therefore 2 ulp at the
magnitude ``max(|g|, 1)``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core import random_state
from paddle_tpu.inference import LLMEngine as JaxEngine
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxModel
from paddle_tpu_torch.inference import LLMEngine, prng
from paddle_tpu_torch.models.llama import (LlamaConfig,
                                           from_jax_decode_params)
from _torch_threads import torch_threads  # noqa: F401

SEEDS = [0, 1, 2 ** 31 - 1, 2 ** 32 - 1]
INDICES = np.arange(301)
CHUNK = 64                       # indices a draw covers at once (memory)
TINY = np.finfo(np.float32).tiny
ULP1 = np.spacing(np.float32(1.0))


def _jax_keys(seed):
    root = jax.random.PRNGKey(seed)
    return np.asarray(jax.vmap(lambda d: jax.random.fold_in(root, d))(
        jnp.asarray(INDICES, jnp.uint32)))


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_equal_jax(seed):
    root = prng.prng_key(seed)
    np.testing.assert_array_equal(root.numpy(),
                                  np.asarray(jax.random.PRNGKey(seed)))
    keys = prng.fold_in(root, torch.from_numpy(INDICES))
    want = _jax_keys(seed)
    np.testing.assert_array_equal(keys.numpy(), want)
    # the host form the engine uses
    for i in (0, 1, 150, 300):
        np.testing.assert_array_equal(prng.request_key(seed, i), want[i])
    for n in (2, 3, 7):
        np.testing.assert_array_equal(
            prng.split(root, n).numpy(),
            np.asarray(jax.random.split(jax.random.PRNGKey(seed), n)))
    # a split of a folded key, as generate() chains them
    np.testing.assert_array_equal(
        prng.split(keys[17]).numpy(),
        np.asarray(jax.random.split(jnp.asarray(want[17]))))


@pytest.mark.parametrize("V", [7, 1000, 32000])
@pytest.mark.parametrize("seed", SEEDS)
def test_bits_uniform_gumbel_equal_jax(seed, V):
    want_keys = _jax_keys(seed)
    keys = torch.from_numpy(want_keys.astype(np.int64))
    bits_j = jax.jit(jax.vmap(lambda k: jax.random.bits(k, (V,))))
    unif_j = jax.jit(jax.vmap(lambda k: jax.random.uniform(
        k, (V,), minval=TINY, maxval=1.0)))
    gum_j = jax.jit(jax.vmap(lambda k: jax.random.gumbel(k, (V,))))
    for c in range(0, len(INDICES), CHUNK):
        kj = jnp.asarray(want_keys[c:c + CHUNK])
        kt = keys[c:c + CHUNK]
        np.testing.assert_array_equal(prng.random_bits(kt, V).numpy(),
                                      np.asarray(bits_j(kj)))
        u = prng.uniform(kt, V).numpy()
        np.testing.assert_array_equal(u.view(np.int32),
                                      np.asarray(unif_j(kj)).view(np.int32))
        g, gj = prng.gumbel(kt, V).numpy(), np.asarray(gum_j(kj))
        assert np.isfinite(g).all()
        ulp = np.spacing(np.maximum(np.abs(gj), 1.0).astype(np.float32))
        assert (np.abs(g - gj) <= 2 * ulp).all(), float(
            (np.abs(g - gj) / ulp).max())


@pytest.mark.parametrize("shape", [(1, 50), (3, 97)])
def test_categorical_equals_jax(shape):
    rng = np.random.RandomState(shape[1])
    for seed in range(20):
        lg = (rng.randn(*shape) * 3).astype(np.float32)
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jax.random.categorical(key, jnp.asarray(lg)))
        got = prng.categorical(prng.prng_key(seed), torch.from_numpy(lg))
        np.testing.assert_array_equal(got.numpy(), want)
        # one key per row, as the engine's vmapped draw
        keys = np.asarray(jax.random.split(key, shape[0]))
        want = np.asarray(jax.vmap(jax.random.categorical)(
            jnp.asarray(keys), jnp.asarray(lg)))
        got = prng.categorical(torch.from_numpy(keys.astype(np.int64)),
                               torch.from_numpy(lg))
        np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# end to end: the engine and generate() on the JAX model's weights
# ---------------------------------------------------------------------------

VOCAB = 97
JCFG = JaxConfig.tiny(vocab=VOCAB, hidden=32, layers=2, heads=4, ffn=64,
                      seq=64)


@pytest.fixture(scope="module")
def pair():
    """The JAX model drawn from the JAX package's global random state
    seeded to 0 (restored afterwards), and its weights in the port."""
    saved = dict(random_state._state)
    random_state.seed(0)
    try:
        jm = JaxModel(JCFG)
    finally:
        random_state._state.update(saved)
    params = jax.tree.map(np.asarray, jm.decode_params())
    cfg = LlamaConfig(**{k: getattr(JCFG, k)
                         for k in LlamaConfig.__dataclass_fields__})
    return jm, from_jax_decode_params(cfg, params, device="cpu")


SAMPLED = [dict(temperature=0.8, seed=3, top_p=0.9, repetition_penalty=1.1),
           dict(temperature=1.0, seed=2 ** 32 - 1),
           dict(temperature=0.7, seed=11, top_k=5),
           dict(temperature=1.3, seed=0, top_p=0.5),
           dict(temperature=0.0)]


def test_engine_sampled_streams_equal_jax(pair):
    jm, tm = pair
    rng = np.random.RandomState(11)
    reqs = [(rng.randint(0, VOCAB, n).tolist(), 10, kw)
            for n, kw in zip((7, 12, 5, 9, 6), SAMPLED)]
    kw = dict(max_num_seqs=4, block_size=8, max_model_len=64,
              max_prefill_tokens=128, prefill_token_bucket=32)
    je = JaxEngine(jm, overlap=False, **kw)
    te = LLMEngine(tm, device="cpu", overlap=False, **kw)
    for p, mx, o in reqs:
        assert je.add_request(p, max_new_tokens=mx, **o) == \
            te.add_request(p, max_new_tokens=mx, **o)
    jo, to = je.run(), te.run()
    for rid in range(len(reqs)):
        assert to[rid].generated == jo[rid].generated, rid
        assert len(to[rid].generated) == 10


@pytest.mark.parametrize("kw", [
    dict(temperature=1.0), dict(temperature=0.8, top_k=7),
    dict(temperature=1.2, top_p=0.8),
    dict(temperature=0.9, top_p=0.9, repetition_penalty=1.3)],
    ids=["temperature", "top_k", "top_p", "top_p_penalty"])
def test_sampled_generate_equals_jax(pair, kw):
    jm, tm = pair
    ids = np.random.RandomState(5).randint(0, VOCAB, (2, 6)).astype(np.int32)
    for seed in (0, 7):
        want = np.asarray(jm.generate(jnp.asarray(ids), max_new_tokens=8,
                                      seed=seed, **kw)._data)
        got = tm.generate(torch.from_numpy(ids), max_new_tokens=8, seed=seed,
                          **kw)
        np.testing.assert_array_equal(got.numpy(), want)
