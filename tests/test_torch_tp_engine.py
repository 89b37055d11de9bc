"""PyTorch port, tensor-parallel serving (``tp=N``) on the CPU, held
against tp=1 and against the JAX engine at tp=2 (tests/test_tp_engine.py's
cases, plus the port's options):

- Greedy tokens at tp=2 equal tp=1's over the 16-request ragged stream in
  the reference's six configs, and equal the JAX engine's tp=2 tokens for
  float pages, int8 pages and the n-gram drafter; the same holds for the
  decode window, overlap off, int8 and int4 weight pools, and a vocabulary
  the head splits over.
- Each shard holds kvh/tp heads of every page (and of the int8 scale
  pools) on its device; per-shard residency is the total over tp, and the
  totals equal the JAX engine's.
- The spill tier at tp=2 spills the same bytes as at tp=1 (a host entry
  holds the full head axis) and restores them into each shard's pools in
  place.
- tp=3 and tp=0 raise; device=None needs tp cards; ``--tp 2`` builds
  through the CLI; ``summary()`` has the JAX engine's keys.
"""
import numpy as np
import pytest
import torch

import jax

from paddle_tpu.core import random_state
from paddle_tpu.inference import LLMEngine as JaxEngine
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxModel
from paddle_tpu_torch.inference import HostSpillPool, LLMEngine
from paddle_tpu_torch.inference.kv_cache import prefix_chain_hashes
from paddle_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                           from_jax_decode_params)
from _torch_threads import torch_threads  # noqa: F401

VOCAB = 97
CFG = JaxConfig.tiny(vocab=VOCAB, hidden=32, layers=2, heads=4, ffn=64,
                     seq=64)


class Pair:
    """One JAX model and its weights carried into the port."""

    def __init__(self, jcfg):
        self.jm = JaxModel(jcfg)
        params = jax.tree.map(np.asarray, self.jm.decode_params())
        cfg = LlamaConfig(**{k: getattr(jcfg, k)
                             for k in LlamaConfig.__dataclass_fields__})
        self.tm = from_jax_decode_params(cfg, params, device="cpu")


@pytest.fixture(scope="module")
def pair():
    """The model, drawn from the JAX package's global random state seeded
    to 0 and restored afterwards."""
    saved = dict(random_state._state)
    random_state.seed(0)
    try:
        return Pair(CFG)
    finally:
        random_state._state.update(saved)


@pytest.fixture(scope="module")
def even_vocab():
    """A port-only model whose vocabulary (96) tp=2 divides, so the head
    splits over the shards."""
    cfg = LlamaConfig.tiny(vocab=96, hidden=32, layers=2, heads=4, ffn=64,
                           seq=64)
    return LlamaForCausalLM(cfg, device="cpu", generator=5)


def _kw(**kw):
    kw.setdefault("max_num_seqs", 4)
    kw.setdefault("block_size", 8)
    kw.setdefault("max_model_len", 64)
    kw.setdefault("max_prefill_tokens", 128)
    kw.setdefault("prefill_token_bucket", 32)
    return kw


def _engine(model, tp, **kw):
    kw.setdefault("device", "cpu")
    return LLMEngine(model, tp=tp, **_kw(**kw))


def _stream(eng, vocab=VOCAB):
    """The reference's 16-request ragged audit stream; {rid: (tokens,
    finish reason)}."""
    rng = np.random.RandomState(3)
    for i in range(16):
        n = [4, 9, 13, 21][i % 4]
        eng.add_request(rng.randint(0, vocab, n).tolist(), max_new_tokens=4)
    return {rid: (list(o.generated), o.finish_reason)
            for rid, o in eng.run().items()}


def _drive(model, tp, **kw):
    eng = _engine(model, tp, **kw)
    return eng, _stream(eng, model.config.vocab_size)


# ---------------------------------------------------------------------------
# greedy tokens: tp=2 == tp=1 == the JAX engine at tp=2
# ---------------------------------------------------------------------------

REFERENCE_CONFIGS = [
    ({}, True),                                            # baseline f32
    ({"enable_prefix_caching": False}, False),             # cache off
    ({"drafter": "ngram", "spec_k": 3}, True),             # speculation on
    ({"kv_dtype": "int8"}, True),                          # quantized pages
    ({"kv_dtype": "int8", "drafter": "ngram", "spec_k": 3}, False),
    ({"kv_dtype": "int8", "enable_prefix_caching": False}, False),
]


@pytest.mark.parametrize(
    "kw,against_jax", REFERENCE_CONFIGS,
    ids=["f32", "cache-off", "spec", "int8", "int8-spec", "int8-cache-off"])
def test_tp2_tokens_identical_to_tp1(pair, kw, against_jax):
    e1, o1 = _drive(pair.tm, 1, **kw)
    e2, o2 = _drive(pair.tm, 2, **kw)
    assert o1 == o2
    assert e2.compile_counts == e1.compile_counts
    if against_jax:
        je = JaxEngine(pair.jm, tp=2, **_kw(**kw))
        assert _stream(je) == o2


@pytest.mark.parametrize("kw", [
    {"decode_window": 4},
    {"decode_window": 4, "kv_dtype": "int8"},
    {"overlap": False},
    {"weight_dtype": "int8"},
    {"weight_dtype": "int8", "kv_dtype": "int8"},
    {"weight_dtype": "int4"},
], ids=["window4", "window4-int8", "overlap-off", "w8", "w8kv8", "w4"])
def test_tp2_tokens_identical_to_tp1_across_options(pair, kw):
    e1, o1 = _drive(pair.tm, 1, **kw)
    e2, o2 = _drive(pair.tm, 2, **kw)
    assert o1 == o2
    assert e2.pad_stats == e1.pad_stats
    assert e2.summary()["block_pool"] == e1.summary()["block_pool"]


# ---------------------------------------------------------------------------
# the sharded layout and residency accounting
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_tp_pools_sharded_over_kv_heads(pair, kv_dtype):
    """Each shard holds kvh/tp heads of every page (and of the int8 scale
    pools) on its own device; the q/k/v weights are split by contiguous
    head blocks, the rest lives once, on the lead device."""
    eng = _engine(pair.tm, 2, kv_dtype=kv_dtype, device=["cpu", "cpu"])
    kvh, L = CFG.num_key_value_heads, CFG.num_hidden_layers
    assert len(eng._shards) == 2 and eng.devices == [torch.device("cpu")] * 2
    names = ("kc", "vc", "ks", "vs") if kv_dtype == "int8" else ("kc", "vc")
    for sh in eng._shards:
        for k in names:
            pool = getattr(sh, k)
            assert pool.shape[:3] == (L, eng.blocks.num_blocks, kvh // 2)
        assert sh.layers["wq"].shape[-1] == CFG.hidden_size // 2
    assert eng._kc is eng._shards[0].kc
    assert not {"wq", "wk", "wv"} & set(eng.params["layers"])
    wq = pair.tm.layers["wq"]
    torch.testing.assert_close(
        torch.cat([sh.layers["wq"] for sh in eng._shards], -1), wq,
        rtol=0, atol=0)


@pytest.mark.parametrize("weight_dtype", ["float32", "int8", "int4"])
def test_tp_residency_reports_per_shard_and_total(pair, weight_dtype):
    eng = _engine(pair.tm, 2, weight_dtype=weight_dtype)
    eng.add_request(list(range(20)), max_new_tokens=4)
    eng.run()
    assert eng.kv_page_bytes_per_shard() * 2 == eng.kv_page_bytes()
    assert eng.kv_bytes_resident_per_shard() * 2 == eng.kv_bytes_resident()
    s = eng.summary()
    assert s["tp"] == 2
    assert s["kv_bytes_resident"] == eng.kv_bytes_resident() > 0
    assert s["kv_bytes_resident_per_shard"] * 2 == s["kv_bytes_resident"]
    assert s["weight_bytes_resident_per_shard"] \
        < s["weight_bytes_resident"]
    e1 = _engine(pair.tm, 1, weight_dtype=weight_dtype)
    assert e1.kv_bytes_resident_per_shard() == e1.kv_bytes_resident()
    assert e1.weight_bytes_resident_per_shard() == \
        e1.weight_bytes_resident() == eng.weight_bytes_resident()
    # the JAX engine's formulas give the same figures
    je = JaxEngine(pair.jm, tp=2, weight_dtype=weight_dtype, **_kw())
    assert je.kv_page_bytes() == eng.kv_page_bytes()
    assert je.kv_page_bytes_per_shard() == eng.kv_page_bytes_per_shard()
    assert je.weight_bytes_resident() == eng.weight_bytes_resident()
    assert je.weight_bytes_resident_per_shard() == \
        eng.weight_bytes_resident_per_shard()
    snap = eng.stats.snapshot()
    assert snap["weight_bytes_resident_per_shard"] == \
        eng.weight_bytes_resident_per_shard()


def test_tp_head_sharding_gated_on_vocab_divisibility(pair, even_vocab):
    """vocab 97 is odd, so the head stays replicated, as in the JAX
    engine; vocab 96 splits over the two shards."""
    eng = _engine(pair.tm, 2)
    assert eng._shard_head is False
    assert all(sh.head is None for sh in eng._shards)
    assert JaxEngine(pair.jm, tp=2, **_kw())._shard_head is False
    even = _engine(even_vocab, 2)
    assert even._shard_head is True
    assert [sh.head["head"].shape[-1] for sh in even._shards] == [48, 48]
    assert "head" not in even.params


@pytest.mark.parametrize("kw", [{}, {"kv_dtype": "int8"},
                                {"weight_dtype": "int8"},
                                {"weight_dtype": "int4"}],
                         ids=["f32", "int8-pages", "w8", "w4"])
def test_tp2_split_head_tokens_identical_to_tp1(even_vocab, kw):
    e1, o1 = _drive(even_vocab, 1, **kw)
    e2, o2 = _drive(even_vocab, 2, **kw)
    assert e2._shard_head
    assert o1 == o2
    assert e2.weight_bytes_resident() == e1.weight_bytes_resident()


def test_tp_must_divide_heads(pair):
    with pytest.raises(ValueError, match="tp=3"):
        _engine(pair.tm, 3)                       # 4 heads % 3 != 0
    with pytest.raises(ValueError, match="tp must be"):
        _engine(pair.tm, 0)
    with pytest.raises(ValueError, match="devices for tp=2"):
        _engine(pair.tm, 2, device=["cpu"])


def test_tp_without_device_needs_tp_cards(pair):
    """device=None puts one shard a card; with fewer cards than tp it
    raises instead of sharing one."""
    if torch.cuda.is_available() and torch.cuda.device_count() >= 2:
        pytest.skip("two CUDA devices are present")
    with pytest.raises(RuntimeError, match="tp=2"):
        LLMEngine(pair.tm, tp=2, **_kw())


# ---------------------------------------------------------------------------
# the spill tier under tp
# ---------------------------------------------------------------------------

def _spill_and_restore(model, tp, kv_dtype):
    """Serve a prompt, spill its parked pages, restore them by a hint and
    serve it again; (engine, first tokens, again tokens, the tier's bytes
    of each chain page, the pools' bytes after the restore, pool
    addresses before and after)."""
    tier = HostSpillPool(64 << 20)
    eng = _engine(model, tp, num_blocks=24, kv_tier=tier, kv_dtype=kv_dtype,
                  max_model_len=128, max_prefill_tokens=64)
    names = ("kc", "vc", "ks", "vs") if kv_dtype == "int8" else ("kc", "vc")
    ptrs = [getattr(sh, k).data_ptr() for sh in eng._shards for k in names]
    prompt = list(range(32))

    def serve():
        rid = eng.add_request(prompt, max_new_tokens=4)
        return list(eng.run()[rid].generated)

    first = serve()
    chain = prefix_chain_hashes(prompt, eng.block_size)
    assert eng.blocks.evict_parked(eng.blocks.num_cached) >= len(chain)
    eng.step()                                        # the drain spills
    assert all(h in tier for h in chain)
    held = {h: {k: v.clone() for k, v in
                tier._entries[tier._by_hash[h]]["arrays"].items()}
            for h in chain}
    eng.prefetch_hint(chain)
    eng.step()                                        # the drain restores
    restored = {}
    for h in chain:
        blk = eng.blocks._hash_to_block[h]
        restored[h] = {k: torch.cat([getattr(sh, k)[:, blk]
                                     for sh in eng._shards], 1)
                       for k in names}
    after = [getattr(sh, k).data_ptr() for sh in eng._shards for k in names]
    again = serve()
    return eng, first, again, held, restored, ptrs, after


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_tp2_spill_restores_tp1_bytes_in_place(pair, kv_dtype):
    _, f1, a1, held1, _, _, _ = _spill_and_restore(pair.tm, 1, kv_dtype)
    eng, f2, a2, held2, restored, ptrs, after = _spill_and_restore(
        pair.tm, 2, kv_dtype)
    assert f2 == f1 and a2 == a1 and a2 == f2
    assert held2.keys() == held1.keys()
    for h in held1:
        for k, v in held1[h].items():
            assert torch.equal(held2[h][k], v), (h, k)      # same bytes
            assert torch.equal(restored[h][k], v), (h, k)   # restored
    assert after == ptrs                                     # in place
    assert eng.stats.snapshot()["kv_prefetch_hit_pages"] > 0


# ---------------------------------------------------------------------------
# the CLI and the summary
# ---------------------------------------------------------------------------

def test_cli_builds_tp2_engine():
    from paddle_tpu_torch.inference.frontend import __main__ as cli
    args = cli.argparse.Namespace(
        model="tiny", device="cpu", max_num_seqs=3, block_size=8,
        max_model_len=96, max_prefill_tokens=40, no_prefix_caching=False,
        kv_dtype="int8", weight_dtype="float32", host_kv_bytes=0,
        spec_k=0, tp=2)
    eng = cli._build_engine(args)()
    assert eng.tp == 2 and len(eng._shards) == 2
    eng.add_request([1, 2, 3, 4, 5], max_new_tokens=3)
    done = []
    while eng.has_unfinished():                # retain_outputs=False
        done += eng.step()
    assert [len(o.generated) for o in done] == [3]
    assert eng.summary()["kv_bytes_resident_per_shard"] * 2 == \
        eng.summary()["kv_bytes_resident"]


# keys of the port's summary that the JAX engine's lacks: the device, the
# padding accounting and the two step options
PORT_ONLY_KEYS = {"device", "pad_stats", "overlap", "decode_window"}


@pytest.mark.parametrize("tp,kw", [(1, {}), (2, {}),
                                   (2, {"weight_dtype": "int8"})],
                         ids=["tp1", "tp2", "tp2-w8"])
def test_summary_keys_match_reference(pair, tp, kw):
    eng = _engine(pair.tm, tp, **kw)
    je = JaxEngine(pair.jm, tp=tp, **_kw(**kw))
    for e in (eng, je):
        e.add_request(list(range(12)), max_new_tokens=3)
        e.run()
    mine, theirs = eng.summary(), je.summary()
    assert set(mine) - PORT_ONLY_KEYS == set(theirs)
    assert set(mine["tuning_cache"]) == set(theirs["tuning_cache"])
    assert set(mine["tuning_cache"]["kernels"]) == \
        set(theirs["tuning_cache"]["kernels"])
    for name, rec in mine["tuning_cache"]["kernels"].items():
        assert set(rec) == set(theirs["tuning_cache"]["kernels"][name])
    for k in ("tp", "kv_bytes_resident", "kv_bytes_resident_per_shard",
              "weight_bytes_resident", "weight_bytes_resident_per_shard"):
        assert mine[k] == theirs[k], k
    assert mine["tuning_cache_hits"].keys() | \
        mine["tuning_cache_misses"].keys() == \
        set(mine["tuning_cache"]["kernels"])
