"""PyTorch port, LLaMA decode math: the building blocks and the dense
decode forward against the JAX package on the same weights, and greedy
``generate()`` token-identical to the JAX ``generate()``.

Tolerance: atol = rtol = 1e-5 in float32 (the same math; XLA and PyTorch
take their sums and transcendentals in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models import llama as jl
from paddle_tpu_torch.models import llama as tl
from _torch_threads import torch_threads  # noqa: F401

TOL = dict(atol=1e-5, rtol=1e-5)
VOCAB = 97
CFGS = {
    "mha": jl.LlamaConfig.tiny(vocab=VOCAB, hidden=32, layers=2, heads=4,
                               ffn=64, seq=64),
    "gqa": jl.LlamaConfig(vocab_size=VOCAB, hidden_size=32,
                          intermediate_size=64, num_hidden_layers=2,
                          num_attention_heads=4, num_key_value_heads=2,
                          max_position_embeddings=64),
}


def port_config(jcfg):
    return tl.LlamaConfig(**{k: getattr(jcfg, k)
                             for k in tl.LlamaConfig.__dataclass_fields__})


@pytest.fixture(scope="module", params=list(CFGS))
def models(request):
    jm = jl.LlamaForCausalLM(CFGS[request.param])
    params = jax.tree.map(np.asarray, jm.decode_params())
    tm = tl.from_jax_decode_params(port_config(jm.config), params,
                                   device="cpu")
    return jm, tm, params


def test_rms_weight_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(5, 32).astype(np.float32) * 3
    w = rng.randn(32).astype(np.float32)
    ref = jl._rms_weight(jnp.asarray(x), jnp.asarray(w), 1e-6)
    out = tl._rms_weight(torch.from_numpy(x), torch.from_numpy(w), 1e-6)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("shape", [(6, 4, 8), (3, 5, 2, 16)])
def test_rope_positions_matches_jax(shape):
    rng = np.random.RandomState(1)
    x = rng.randn(*shape).astype(np.float32)
    pos = rng.randint(0, 60, shape[:-2]).astype(np.int32)
    ref = jl._rope_positions(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    out = tl._rope_positions(torch.from_numpy(x), torch.from_numpy(pos),
                             10000.0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_rope_is_interleaved_pairs():
    """Pairs (2i, 2i+1) rotate together: position 0 is the identity and a
    vector living on one pair stays on that pair."""
    x = torch.zeros(1, 1, 8)
    x[..., 2] = 1.0
    out = tl._rope_positions(x, torch.tensor([5]), 10000.0)
    assert torch.count_nonzero(out[..., [0, 1, 4, 5, 6, 7]]) == 0
    np.testing.assert_allclose(
        tl._rope_positions(x, torch.tensor([0]), 10000.0).numpy(),
        x.numpy())


def test_from_jax_decode_params_round_trip(models):
    _, tm, params = models
    back = tm.decode_params()
    for k in tl.LAYER_KEYS:
        np.testing.assert_array_equal(back["layers"][k].numpy(),
                                      params["layers"][k])
    for k in ("embed", "norm_f", "head"):
        np.testing.assert_array_equal(back[k].numpy(), params[k])


@pytest.mark.parametrize("all_logits", [False, True])
def test_decode_forward_matches_jax(models, all_logits):
    jm, tm, params = models
    cfg = jm.config
    L, d = cfg.num_hidden_layers, cfg.hidden_size // cfg.num_attention_heads
    rng = np.random.RandomState(2)
    B, S, T = 2, 5, 12
    toks = rng.randint(0, VOCAB, (B, S)).astype(np.int32)
    shape = (L, B, T, cfg.num_key_value_heads, d)
    pos = np.arange(S)
    mask = np.arange(T)[None, :] <= pos[:, None]
    jf = jl._make_decode_fwd(cfg, all_logits=all_logits)
    jlog, jck, _ = jf(jm.decode_params(), jnp.asarray(toks),
                      jnp.zeros(shape), jnp.zeros(shape), jnp.asarray(pos),
                      jnp.asarray(mask))
    tf = tl._make_decode_fwd(tm.config, all_logits=all_logits)
    tlog, tck, _ = tf(tm.decode_params(), torch.from_numpy(toks).long(),
                      torch.zeros(shape), torch.zeros(shape),
                      torch.from_numpy(pos), torch.from_numpy(mask))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    np.testing.assert_allclose(tck.numpy(), np.asarray(jck), **TOL)


@pytest.mark.parametrize("plen,max_new", [(4, 8), (9, 6), (13, 5)])
def test_greedy_generate_matches_jax(models, plen, max_new):
    jm, tm, _ = models
    rng = np.random.RandomState(plen)
    ids = rng.randint(0, VOCAB, (2, plen)).astype(np.int32)
    ref = np.asarray(jm.generate(jnp.asarray(ids), max_new_tokens=max_new,
                                 temperature=0.0)._data)
    out = tm.generate(torch.from_numpy(ids), max_new_tokens=max_new,
                      temperature=0.0)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_greedy_generate_eos_freeze_matches_jax(models):
    jm, tm, _ = models
    ids = np.random.RandomState(5).randint(0, VOCAB, (2, 6)).astype(np.int32)
    base = np.asarray(jm.generate(jnp.asarray(ids), max_new_tokens=10,
                                  temperature=0.0)._data)
    eos = int(base[0, 6 + 3])                # row 0 hits eos mid-stream
    ref = np.asarray(jm.generate(jnp.asarray(ids), max_new_tokens=10,
                                 temperature=0.0,
                                 eos_token_id=eos)._data)
    out = tm.generate(torch.from_numpy(ids), max_new_tokens=10,
                      temperature=0.0, eos_token_id=eos)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_forward_logits_match_incremental_decode(models):
    """Teacher-forced logits over a whole sequence equal the logits the
    incremental generate loop saw at each step (the chip check's oracle)."""
    _, tm, _ = models
    ids = torch.from_numpy(
        np.random.RandomState(6).randint(0, VOCAB, (1, 7)))
    full = tm.generate(ids, max_new_tokens=5, temperature=0.0)
    logits = tm.forward_logits(full[:, :-1])
    assert logits.shape == (1, 11, VOCAB)
    np.testing.assert_array_equal(
        torch.argmax(logits[0, 6:], -1).numpy(), full[0, 7:].numpy())


def test_sampled_generate_is_seeded(models):
    _, tm, _ = models
    ids = torch.from_numpy(
        np.random.RandomState(8).randint(0, VOCAB, (2, 5)))
    kw = dict(max_new_tokens=6, temperature=0.9, top_k=20, top_p=0.9,
              repetition_penalty=1.2)
    a = tm.generate(ids, seed=3, **kw)
    assert torch.equal(a, tm.generate(ids, seed=3, **kw))
    assert a.shape == (2, 11) and int(a.max()) < VOCAB


def test_random_init_is_seeded():
    cfg = port_config(CFGS["gqa"])
    a = tl.LlamaForCausalLM(cfg, device="cpu", generator=4)
    b = tl.LlamaForCausalLM(cfg, device="cpu", generator=4)
    assert torch.equal(a.layers["wk"], b.layers["wk"])
    assert a.layers["wk"].shape == (2, 32, 16)
    assert torch.equal(a.layers["ln1"], torch.ones(2, 32))


def test_model_without_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tl.LlamaForCausalLM(port_config(CFGS["mha"]))
