"""PyTorch port, Hugging Face weight bridge (models/llama.py
``convert_hf_state_dict`` / ``from_hf``): a randomly initialised
``transformers.LlamaForCausalLM`` built from a config in memory (nothing
is downloaded) gives the port's model its logits and greedy tokens, and
the conversions equal the JAX package's bit for bit."""
import numpy as np
import pytest
import torch
from _torch_threads import torch_threads  # noqa: F401

transformers = pytest.importorskip("transformers")

from paddle_tpu.core import random_state  # noqa: E402
from paddle_tpu.models import llama as jl  # noqa: E402
from paddle_tpu_torch.models import llama as tl  # noqa: E402

HF_KW = dict(vocab_size=64, hidden_size=32, intermediate_size=48,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=64,
             rms_norm_eps=1e-6, attn_implementation="eager")


def _hf_model(tie=False, seed=0):
    from transformers import LlamaConfig as HFCfg
    from transformers import LlamaForCausalLM as HFLlama
    torch.manual_seed(seed)
    return HFLlama(HFCfg(tie_word_embeddings=tie, **HF_KW)).eval()


@pytest.fixture(scope="module")
def hf():
    return _hf_model()


@pytest.fixture(scope="module")
def ours(hf):
    return tl.from_hf(hf, device="cpu")


@pytest.fixture
def jax_seeded():
    """The JAX model draws its initial weights from the global random
    state; seed it here and restore it after."""
    saved = dict(random_state._state)
    random_state.seed(0)
    try:
        yield
    finally:
        random_state._state.clear()
        random_state._state.update(saved)


def test_config_taken_from_hf(hf, ours):
    cfg = ours.config
    assert (cfg.vocab_size, cfg.hidden_size, cfg.intermediate_size,
            cfg.num_hidden_layers, cfg.num_attention_heads,
            cfg.num_key_value_heads, cfg.max_position_embeddings) \
        == (64, 32, 48, 2, 4, 2, 64)
    assert cfg.rms_norm_eps == 1e-6 and not cfg.tie_word_embeddings
    assert ours.device.type == "cpu" and ours.embed.dtype == torch.float32


def test_logits_match_hf(hf, ours):
    rng = np.random.RandomState(1)
    ids = rng.randint(0, 64, (2, 9)).astype(np.int64)
    with torch.no_grad():
        want = hf(torch.tensor(ids)).logits.float().numpy()
    got = ours.forward_logits(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_generate_matches_hf_greedy(hf, ours):
    ids = np.asarray([[3, 17, 42, 8], [9, 1, 60, 33]], np.int64)
    with torch.no_grad():
        hf_out = hf.generate(torch.tensor(ids), max_new_tokens=6,
                             do_sample=False).numpy()
    got = ours.generate(torch.from_numpy(ids), max_new_tokens=6,
                        temperature=0.0).numpy()
    np.testing.assert_array_equal(got, hf_out)


@pytest.mark.parametrize("src", ["torch_f32", "torch_bf16", "numpy_f32"])
def test_convert_equals_reference_bit_for_bit(hf, src):
    state = hf.state_dict()
    if src == "torch_bf16":
        state = {k: v.to(torch.bfloat16) for k, v in state.items()}
    elif src == "numpy_f32":
        state = {k: v.numpy() for k, v in state.items()}
    cfg = tl.LlamaConfig(**{k: getattr(hf.config, k) for k in (
        "vocab_size", "hidden_size", "intermediate_size",
        "num_hidden_layers", "num_attention_heads", "num_key_value_heads",
        "max_position_embeddings", "rms_norm_eps")})
    jcfg = jl.LlamaConfig(**vars(cfg))
    ref = jl.convert_hf_state_dict(state, jcfg)
    out = tl.convert_hf_state_dict(state, cfg)
    assert sorted(out) == sorted(ref)
    for k in ref:
        assert out[k].dtype == np.float32
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)


@pytest.mark.parametrize("tie", [False, True])
def test_decode_params_equal_reference_from_hf(jax_seeded, tie):
    hf = _hf_model(tie=tie, seed=3)
    ref = jl.from_hf(hf).decode_params()
    out = tl.from_hf(hf, device="cpu")
    assert (out.head is None) == tie
    got = out.decode_params()
    for k in tl.LAYER_KEYS:
        np.testing.assert_array_equal(got["layers"][k].numpy(),
                                      np.asarray(ref["layers"][k]),
                                      err_msg=k)
    for k in ("embed", "norm_f", "head"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)


def test_bf16_state_into_bf16_model(hf):
    """A bf16 HF state into a bf16 port model equals the f32 conversion
    cast to bf16; an f32 state into a bf16 model rounds the same way."""
    cfg = tl.from_hf(hf, device="cpu").config
    state16 = {k: v.to(torch.bfloat16) for k, v in hf.state_dict().items()}
    conv = tl.convert_hf_state_dict(state16, cfg)
    for state in (state16, hf.state_dict()):
        m = tl.from_hf(state, config=cfg, device="cpu",
                       dtype=torch.bfloat16)
        assert m.embed.dtype == torch.bfloat16
        for i in range(cfg.num_hidden_layers):
            for name, key in (("self_attn.q_proj.weight", "wq"),
                              ("self_attn.k_proj.weight", "wk"),
                              ("mlp.down_proj.weight", "down"),
                              ("input_layernorm.weight", "ln1")):
                want = torch.from_numpy(np.ascontiguousarray(
                    conv[f"model.layers.{i}.{name}"])).to(torch.bfloat16)
                assert torch.equal(m.layers[key][i], want), (i, name)
        assert torch.equal(m.head, torch.from_numpy(np.ascontiguousarray(
            conv["lm_head.weight"])).to(torch.bfloat16))
        assert torch.equal(m.embed, torch.from_numpy(
            conv["model.embed_tokens.weight"]).to(torch.bfloat16))


@pytest.mark.parametrize("convert", ["port", "reference"])
def test_gqa_kv_permutation_roundtrip(convert):
    """k_proj permutation uses num_key_value_heads, not
    num_attention_heads (GQA checkpoints would silently scramble
    otherwise)."""
    mod = tl if convert == "port" else jl
    cfg = mod.LlamaConfig.tiny(vocab=32, hidden=16, layers=1, heads=4,
                               ffn=16, seq=16)
    cfg.num_key_value_heads = 2
    d, kv_dim = 16 // 4, 2 * (16 // 4)
    orig = np.arange(kv_dim * 16, dtype=np.float32).reshape(kv_dim, 16)
    state = {"model.layers.0.self_attn.k_proj.weight": orig,
             "model.rotary_emb.inv_freq": np.ones(2, np.float32)}
    out = mod.convert_hf_state_dict(state, cfg)
    assert list(out) == ["model.layers.0.self_attn.k_proj.weight"]
    w = out["model.layers.0.self_attn.k_proj.weight"]
    assert w.shape == (16, kv_dim)            # transposed
    perm = tl._unrotate_perm(d)
    for h in range(2):                        # each head's rows, permuted
        np.testing.assert_array_equal(w.T[h * d:(h + 1) * d],
                                      orig[h * d:(h + 1) * d][perm])
    np.testing.assert_array_equal(tl._unrotate_perm(8),
                                  jl._unrotate_perm(8))


def test_bare_state_needs_config():
    with pytest.raises(ValueError, match="config"):
        tl.from_hf({"model.embed_tokens.weight": np.zeros((4, 4))})


def test_from_hf_rejects_unknown_and_missing(hf, ours):
    state = dict(hf.state_dict())
    state["model.layers.0.self_attn.q_proj.bias"] = torch.zeros(32)
    with pytest.raises(ValueError, match="q_proj.bias"):
        tl.from_hf(state, config=ours.config, device="cpu")
    state = dict(hf.state_dict())
    del state["model.layers.1.mlp.up_proj.weight"]
    with pytest.raises(ValueError, match="lacks 1"):
        tl.from_hf(state, config=ours.config, device="cpu")


def test_default_device_is_the_card(hf):
    """``device=None`` means CUDA: with no card it raises, never falls
    back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tl.from_hf(hf)
