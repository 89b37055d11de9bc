"""PyTorch port, ``models.llama.speculative_generate`` on the CPU, held
against the JAX package's on the same weights (tests/test_generate.py's
speculative cases): greedy output equals the port's ``generate()`` with a
weak draft, a self-draft accepts everything, eos freezes as ``generate()``
does, and greedy and sampled tokens equal the JAX function's at the same
seed."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from paddle_tpu.core import random_state
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxModel
from paddle_tpu.models.llama import \
    speculative_generate as jax_speculative_generate
from paddle_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                           from_jax_decode_params,
                                           speculative_generate)
from _torch_threads import torch_threads  # noqa: F401

VOCAB = 97
CFG = JaxConfig.tiny(vocab=VOCAB, hidden=32, layers=2, heads=4, ffn=64,
                     seq=64)
DRAFT_CFG = JaxConfig.tiny(vocab=VOCAB, hidden=32, layers=1, heads=4,
                           ffn=64, seq=64)


class Pair:
    """One JAX model and its weights carried into the port."""

    def __init__(self, jcfg):
        self.jm = JaxModel(jcfg)
        params = jax.tree.map(np.asarray, self.jm.decode_params())
        cfg = LlamaConfig(**{k: getattr(jcfg, k)
                             for k in LlamaConfig.__dataclass_fields__})
        self.tm = from_jax_decode_params(cfg, params, device="cpu")


@pytest.fixture(scope="module")
def models():
    """Target and a weak 1-layer draft, drawn from the JAX package's
    global random state seeded to 0 and 123 and restored afterwards."""
    saved = dict(random_state._state)
    try:
        random_state.seed(0)
        target = Pair(CFG)
        random_state.seed(123)
        draft = Pair(DRAFT_CFG)
        return target, draft
    finally:
        random_state._state.update(saved)


def _jax(target, draft, ids, **kw):
    out = jax_speculative_generate(target.jm, draft.jm,
                                   jnp.asarray(ids, jnp.int32), **kw)
    return np.asarray(out._data)


def _port(target, draft, ids, **kw):
    return speculative_generate(target.tm, draft.tm, ids, **kw).numpy()


def test_speculative_generate_matches_target_greedy(models):
    """At temperature 0 the accept/resample rule reduces to target
    greedy: the output EQUALS the port's generate() with a weak draft."""
    target, draft = models
    ids = np.asarray([[5, 9, 2, 7]])
    ref = target.tm.generate(ids, max_new_tokens=12,
                             temperature=0.0).numpy()
    spec = _port(target, draft, ids, max_new_tokens=12, gamma=3,
                 temperature=0.0)
    assert spec.shape == (1, 16)
    np.testing.assert_array_equal(spec, ref)


def test_speculative_generate_self_draft_accepts_everything(models):
    target, _ = models
    ids = np.asarray([[3, 1, 4]])
    ref = target.tm.generate(ids, max_new_tokens=10,
                             temperature=0.0).numpy()
    spec = _port(target, target, ids, max_new_tokens=10, gamma=4,
                 temperature=0.0)
    np.testing.assert_array_equal(spec, ref)


def test_speculative_generate_eos_freeze_matches_generate(models):
    target, _ = models
    ids = np.asarray([[3, 1]])
    ref = target.tm.generate(ids, max_new_tokens=12,
                             temperature=0.0).numpy()
    eos = int(ref[0, -4])              # a token greedy emits late
    ref_eos = target.tm.generate(ids, max_new_tokens=12, temperature=0.0,
                                 eos_token_id=eos).numpy()
    spec = _port(target, target, ids, max_new_tokens=12, gamma=3,
                 temperature=0.0, eos_token_id=eos)
    np.testing.assert_array_equal(spec, ref_eos)
    assert (spec[0, 2:] == eos).any()


@pytest.mark.parametrize("draft_kind", ["weak", "self"])
@pytest.mark.parametrize("temperature,seed", [(0.0, 0), (0.8, 3), (1.0, 11),
                                              (1.5, 5)])
def test_speculative_generate_equals_jax(models, draft_kind, temperature,
                                         seed):
    """Greedy and sampled tokens equal the JAX function's at the same
    seed: the same key stream (split before each draw), the same
    acceptance rule."""
    target, weak = models
    draft = weak if draft_kind == "weak" else target
    ids = np.asarray([[5, 9, 2, 7, 11]])
    kw = dict(max_new_tokens=14, gamma=4, temperature=temperature,
              seed=seed)
    np.testing.assert_array_equal(_port(target, draft, ids, **kw),
                                  _jax(target, draft, ids, **kw))


@pytest.mark.parametrize("temperature", [0.0, 0.9])
def test_speculative_generate_eos_equals_jax(models, temperature):
    target, weak = models
    ids = np.asarray([[3, 1, 8]])
    ref = target.tm.generate(ids, max_new_tokens=12,
                             temperature=0.0).numpy()
    kw = dict(max_new_tokens=12, gamma=3, temperature=temperature, seed=2,
              eos_token_id=int(ref[0, 8]))
    np.testing.assert_array_equal(_port(target, weak, ids, **kw),
                                  _jax(target, weak, ids, **kw))


def test_speculative_generate_rejects_bad_inputs(models):
    target, weak = models
    with pytest.raises(ValueError, match="batch-1"):
        _port(target, weak, np.asarray([[1, 2], [3, 4]]))
    other = LlamaForCausalLM(LlamaConfig.tiny(vocab=64, hidden=32,
                                              layers=1), device="cpu")
    with pytest.raises(ValueError, match="vocabulary"):
        speculative_generate(target.tm, other, np.asarray([[1, 2]]))
