"""PyTorch port, serving engine on the CPU: greedy output byte-identical
to the JAX ``LLMEngine`` and to JAX ``generate()`` on the same weights
(the 16-request ragged stream of tests/test_llm_engine.py, prefix cache on
and off, preemption, chunked prefill, GQA), abort, sampling
reproducibility, the refusal of unported options, and import hygiene of
the port and of chip_smoke.py.  The quantized options (int8 KV pages,
int8/int4 weight pools) are held in tests/test_torch_kv_quant.py."""
import ast
import os
import pathlib
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.inference import LLMEngine as JaxEngine
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxModel
from paddle_tpu_torch.inference import LLMEngine
from paddle_tpu_torch.models.llama import (LlamaConfig,
                                           from_jax_decode_params)
from _torch_threads import torch_threads  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parents[1]
VOCAB = 97
CFGS = {
    "mha": JaxConfig.tiny(vocab=VOCAB, hidden=32, layers=2, heads=4,
                          ffn=64, seq=64),
    "gqa": JaxConfig(vocab_size=VOCAB, hidden_size=32, intermediate_size=64,
                     num_hidden_layers=2, num_attention_heads=4,
                     num_key_value_heads=2, max_position_embeddings=64),
}


class Pair:
    """One JAX model, its weights carried into the port, and a cache of
    JAX generate() oracles."""

    def __init__(self, jcfg):
        self.jm = JaxModel(jcfg)
        params = jax.tree.map(np.asarray, self.jm.decode_params())
        cfg = LlamaConfig(**{k: getattr(jcfg, k)
                             for k in LlamaConfig.__dataclass_fields__})
        self.tm = from_jax_decode_params(cfg, params, device="cpu")
        self._oracle = {}

    def oracle(self, prompt, max_new):
        key = (tuple(prompt), max_new)
        if key not in self._oracle:
            out = self.jm.generate(jnp.asarray([prompt], jnp.int32),
                                   max_new_tokens=max_new, temperature=0.0)
            self._oracle[key] = np.asarray(out._data)[0, len(prompt):] \
                .tolist()
        return self._oracle[key]


@pytest.fixture(scope="module")
def pairs():
    return {k: Pair(c) for k, c in CFGS.items()}


def _kw(**kw):
    kw.setdefault("max_num_seqs", 4)
    kw.setdefault("block_size", 8)
    kw.setdefault("max_model_len", 64)
    kw.setdefault("max_prefill_tokens", 128)
    kw.setdefault("prefill_token_bucket", 32)
    return kw


def _serve_both(pair, requests, **kw):
    """Run the same requests through the JAX engine and the port; return
    both engines and both outputs.  Both run synchronously
    (overlap=False): the default pipeline reserves the next step's pages
    early, so its pool counters would differ from the synchronous run's.
    tests/test_torch_async_step.py holds the pipelines of both packages."""
    je = JaxEngine(pair.jm, overlap=False, **_kw(**kw))
    te = LLMEngine(pair.tm, device="cpu", overlap=False, **_kw(**kw))
    for p, mx in requests:
        assert je.add_request(p, max_new_tokens=mx) == \
            te.add_request(p, max_new_tokens=mx)
    return je, te, je.run(), te.run()


def _ragged_stream(seed=7, n=16):
    rng = np.random.RandomState(seed)
    shapes = [(4, 8), (9, 8), (13, 6)]
    return [(rng.randint(0, VOCAB, shapes[i % 3][0]).tolist(),
             shapes[i % 3][1]) for i in range(n)]


def _assert_identical(pair, requests, je, te, jo, to):
    assert sorted(jo) == sorted(to) == list(range(len(requests)))
    for rid, (p, mx) in enumerate(requests):
        assert to[rid].generated == jo[rid].generated, rid
        assert to[rid].generated == pair.oracle(p, mx), rid
        assert to[rid].finish_reason == jo[rid].finish_reason
    # the same scheduling decisions: pool counters agree
    assert te.blocks.stats() == je.blocks.stats()
    for k in ("preemptions", "admitted", "retired", "cache_hit_tokens",
              "cow_copies", "prefill_tokens", "decode_tokens"):
        assert getattr(te.stats, k) == getattr(je.stats, k), k
    assert te.blocks.num_used == 0


@pytest.mark.parametrize("caching", [True, False], ids=["cache", "nocache"])
def test_ragged_stream_byte_identical_to_jax(pairs, caching):
    """tests/test_llm_engine.py's acceptance stream: 16 requests with
    ragged prompts and budgets through 8 slots."""
    pair = pairs["mha"]
    reqs = _ragged_stream()
    kw = dict(max_num_seqs=8, max_prefill_tokens=256,
              prefill_token_bucket=64, enable_prefix_caching=caching)
    out = _serve_both(pair, reqs, **kw)
    _assert_identical(pair, reqs, *out)
    assert out[1].pad_stats == out[0].pad_stats
    # and the JAX engine's default pipelined step emits the same tokens
    je = JaxEngine(pair.jm, **_kw(**kw))
    for p, mx in reqs:
        je.add_request(p, max_new_tokens=mx)
    jo = je.run()
    assert all(jo[r].generated == out[3][r].generated for r in jo)


def test_gqa_stream_byte_identical_to_jax(pairs):
    pair = pairs["gqa"]
    reqs = _ragged_stream(seed=3, n=10)
    _assert_identical(pair, reqs, *_serve_both(pair, reqs))


def test_shared_prefixes_hit_the_cache_identically(pairs):
    pair = pairs["mha"]
    rng = np.random.RandomState(11)
    system = rng.randint(0, VOCAB, 20).tolist()
    reqs = [(system + rng.randint(0, VOCAB, int(n)).tolist(), 6)
            for n in rng.randint(1, 8, 8)]
    out = _serve_both(pair, reqs, max_num_seqs=2)
    _assert_identical(pair, reqs, *out)
    assert out[1].stats.cache_hit_tokens > 0


def test_preemption_under_a_tight_pool_stays_exact(pairs):
    pair = pairs["mha"]
    rng = np.random.RandomState(1)
    reqs = [(rng.randint(0, VOCAB, rng.randint(4, 12)).tolist(), 20)
            for _ in range(8)]
    out = _serve_both(pair, reqs, num_blocks=10)
    _assert_identical(pair, reqs, *out)
    assert out[1].stats.preemptions > 0


def test_chunked_prefill_of_a_long_prompt(pairs):
    pair = pairs["mha"]
    rng = np.random.RandomState(5)
    reqs = [(rng.randint(0, VOCAB, 40).tolist(), 8),
            (rng.randint(0, VOCAB, 5).tolist(), 12),
            (rng.randint(0, VOCAB, 23).tolist(), 6)]
    out = _serve_both(pair, reqs, max_prefill_tokens=16,
                      prefill_token_bucket=16)
    _assert_identical(pair, reqs, *out)
    assert out[1].stats.prefill_steps > 3     # the 40-token prompt chunked


def test_abort_mid_run(pairs):
    pair = pairs["mha"]
    rng = np.random.RandomState(9)
    reqs = [(rng.randint(0, VOCAB, 6 + i).tolist(), 12) for i in range(4)]
    eng = LLMEngine(pair.tm, device="cpu", **_kw())
    for p, mx in reqs:
        eng.add_request(p, max_new_tokens=mx)
    for _ in range(4):
        eng.step()
    out = eng.abort(1)
    assert out.finish_reason == "aborted" and 0 < len(out.generated) < 12
    assert out.generated == pair.oracle(*reqs[1])[:len(out.generated)]
    assert eng.abort(1) is None and eng.stats.abort_noops == 1
    outs = eng.run()
    for rid in (0, 2, 3):
        assert outs[rid].generated == pair.oracle(*reqs[rid])
    assert outs[1].finish_reason == "aborted"
    assert eng.blocks.num_used == 0
    eng.blocks.check_invariants()


def test_eos_retires_like_jax(pairs):
    pair = pairs["mha"]
    p = np.random.RandomState(3).randint(0, VOCAB, 6).tolist()
    eos = pair.oracle(p, 12)[4]
    eng = LLMEngine(pair.tm, device="cpu", **_kw())
    rid = eng.add_request(p, max_new_tokens=12, eos_token_id=eos)
    got = eng.run()[rid]
    assert got.finish_reason == "eos"
    assert got.generated == pair.oracle(p, 12)[:got.generated.index(eos) + 1]


def test_sampling_reproducible_across_scheduling(pairs):
    pair = pairs["mha"]
    rng = np.random.RandomState(11)
    p = rng.randint(0, VOCAB, 7).tolist()

    def run_once(extra_load):
        eng = LLMEngine(pair.tm, device="cpu", **_kw())
        rid = eng.add_request(p, max_new_tokens=8, temperature=0.8, seed=3,
                              top_p=0.9, repetition_penalty=1.1)
        for _ in range(extra_load):
            eng.add_request(rng.randint(0, VOCAB, 5).tolist(),
                            max_new_tokens=4)
        return eng.run()[rid].generated

    first = run_once(0)
    assert first == run_once(0) == run_once(3)
    assert len(first) == 8


@pytest.mark.parametrize("kw,item", [({"tp": 3}, 10)])
def test_unported_options_raise_naming_their_roadmap_item(pairs, kw, item):
    """Tensor parallelism (item 10) is ported; a degree that does not
    divide the heads raises as the JAX engine does
    (tests/test_torch_tp_engine.py holds tp=2)."""
    with pytest.raises(ValueError, match="tp=3"):
        LLMEngine(pairs["mha"].tm, device="cpu", **kw)


def test_engine_without_device_raises_without_cuda(pairs):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LLMEngine(pairs["mha"].tm)


def test_engine_rejects_bad_requests(pairs):
    eng = LLMEngine(pairs["mha"].tm, device="cpu", **_kw())
    with pytest.raises(ValueError):
        eng.add_request(list(range(30)), max_new_tokens=60)
    with pytest.raises(ValueError):
        eng.add_request([], max_new_tokens=4)
    with pytest.raises(ValueError):
        LLMEngine(pairs["mha"].tm, device="cpu", kv_dtype="fp8")


def _imports(path):
    tree = ast.parse(pathlib.Path(path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _foreign(name):
    return name == "jax" or name.startswith("jax.") or \
        name == "paddle_tpu" or name.startswith("paddle_tpu.")


def test_port_and_chip_smoke_never_import_jax_or_the_jax_package():
    files = sorted((REPO / "paddle_tpu_torch").rglob("*.py")) + \
        [REPO / "chip_smoke.py"]
    for f in files:
        bad = [m for m in _imports(f) if _foreign(m)]
        assert not bad, (f, bad)
    code = (
        "import importlib, pkgutil, sys\n"
        "import paddle_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'paddle_tpu' or m.startswith('paddle_tpu.')]\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_chip_smoke_refuses_without_cuda_or_the_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(REPO / "chip_smoke.py", lone)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for cwd, script in ((REPO, REPO / "chip_smoke.py"), (tmp_path, lone)):
        r = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode != 0
        assert '"ok": true' not in r.stdout
