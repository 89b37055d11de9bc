"""PyTorch port, the kernel autotuner (``paddle_tpu_torch.tune``) on the
CPU, held against the JAX package's (tests/test_tune.py's cases, plus
cross-package checks):

- The cache: round trip, corrupt and missing files, pow2 bucket
  signatures, device isolation, the nearest bucket never crossing dtype,
  the deprecated env lever and the forced config -- and the same file
  format as the JAX package's, both ways, with signatures and nearest
  lookups that agree on shared keys.
- The wrappers' plans: each kernel's forced candidate reaches its plan
  (keys a split, the dequant matmul's tile and splits, the norm walk's
  warps and stages, snapped to what the shape allows), and with no entry
  the plan is the rule's.
- The engine: ``summary()["tuning_cache"]`` has the JAX engine's keys and
  kernel names for the same config; greedy tokens are equal under every
  forced candidate and across caches.
- The CLI's cost-model path end to end, ``run_sweep`` in process, and no
  untuned launch in paddle_tpu_torch/ops.

The kernels themselves at each candidate are held on the card by
tests/test_torch_cuda_kernels.py (``-k tuned``)."""
import importlib.util
import json
import math
import os
import warnings

import numpy as np
import pytest
import torch

import jax

from paddle_tpu import tune as jax_tune
from paddle_tpu.core import random_state
from paddle_tpu.inference import LLMEngine as JaxEngine
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxModel
from paddle_tpu.tune import cache as jax_tune_cache
from paddle_tpu_torch import tune
from paddle_tpu_torch.inference import LLMEngine
from paddle_tpu_torch.models.llama import (LlamaConfig,
                                           from_jax_decode_params)
from paddle_tpu_torch.ops import fused_norms as fn
from paddle_tpu_torch.ops import paged_attention as pa
from paddle_tpu_torch.ops import quant_matmul as qm
from paddle_tpu_torch.tune import (TuningCache, bucket_signature, cache_path,
                                   current_cache, kernel_config,
                                   kernel_config_with_meta, reset_provenance,
                                   set_cache_path)
from paddle_tpu_torch.tune import cache as tune_cache
from _torch_threads import torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = 97
CFG = JaxConfig.tiny(vocab=VOCAB, hidden=32, layers=2, heads=4, ffn=64,
                     seq=64)
FIVE = {"flash_attention", "flash_attention_varlen", "fused_norms",
        "paged_attention", "quant_matmul"}
ENV = ("PADDLE_TPU_TUNE_CACHE", "PADDLE_TPU_TUNE_FORCE",
       "PADDLE_TPU_FA_BLOCK_Q", "PADDLE_TPU_FA_BLOCK_K")


@pytest.fixture
def clean_tune(tmp_path, monkeypatch):
    """Isolated cache file for both packages + no env levers; restores
    global state."""
    for var in ENV:
        monkeypatch.delenv(var, raising=False)
    path = str(tmp_path / "tuning_cache.json")
    set_cache_path(path)
    jax_tune.set_cache_path(path)
    reset_provenance()
    yield path
    set_cache_path(None)
    jax_tune.set_cache_path(None)
    reset_provenance()


@pytest.fixture(scope="module")
def pair():
    """A JAX model drawn from the JAX package's global random state
    seeded to 0 (restored afterwards) and its weights in the port."""
    saved = dict(random_state._state)
    random_state.seed(0)
    try:
        jm = JaxModel(CFG)
    finally:
        random_state._state.update(saved)
    params = jax.tree.map(np.asarray, jm.decode_params())
    cfg = LlamaConfig(**{k: getattr(CFG, k)
                         for k in LlamaConfig.__dataclass_fields__})
    return jm, from_jax_decode_params(cfg, params, device="cpu")


def _kw(**kw):
    kw.setdefault("max_num_seqs", 4)
    kw.setdefault("block_size", 8)
    kw.setdefault("max_model_len", 64)
    kw.setdefault("max_prefill_tokens", 128)
    kw.setdefault("prefill_token_bucket", 32)
    return kw


def _stream_tokens(eng):
    rng = np.random.RandomState(3)
    for i in range(16):
        n = [4, 9, 13, 21][i % 4]
        eng.add_request(rng.randint(0, VOCAB, n).tolist(), max_new_tokens=4)
    return {rid: tuple(o.token_ids) for rid, o in eng.run().items()}


# ---------------------------------------------------------------------------
# cache persistence
# ---------------------------------------------------------------------------

def test_cache_round_trip(tmp_path):
    path = str(tmp_path / "c.json")
    c = TuningCache(path)
    c.put("cpu", "paged_attention", "head_dim=128,tq=64",
          {"split_keys": 1024}, score_s=1e-4, measure="cost-model")
    saved = c.save()
    assert saved == path and os.path.exists(path)
    c2 = TuningCache(path)
    assert c2.lookup("cpu", "paged_attention", "head_dim=128,tq=64") \
        == {"split_keys": 1024}
    assert len(c2) == 1
    assert c2.kernels("cpu") == {"paged_attention"}
    doc = json.load(open(path))
    assert doc["version"] == 1
    rec = doc["entries"]["cpu|paged_attention|head_dim=128,tq=64"]
    assert rec["measure"] == "cost-model" and rec["score_s"] == 1e-4


def test_corrupt_cache_degrades_to_defaults(clean_tune):
    with open(clean_tune, "w") as f:
        f.write("{not json at all")
    with pytest.warns(RuntimeWarning, match="unreadable"):
        cfg = kernel_config("paged_attention",
                            {"tq": 8, "kv_heads": 2, "head_dim": 64,
                             "page": 16, "nblk": 8, "dtype": "float32"})
    assert cfg == {"split_keys": 512}            # the rule, not a crash
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        kernel_config("paged_attention",
                      {"tq": 16, "kv_heads": 2, "head_dim": 64, "page": 16,
                       "nblk": 8, "dtype": "float32"})


def test_missing_cache_is_empty_not_warning(clean_tune):
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        cfg, meta = kernel_config_with_meta(
            "fused_norms", {"rows": 32, "hidden": 4096, "dtype": "float32"})
    assert meta["source"] == "default" and meta["hit"] is False
    plan = fn._norm_plan(32, 4096, torch.float32, torch.float32, "rms",
                         torch.float32)
    # the default is the plan's own rule at this shape
    assert cfg == {"team_warps": plan.team_warps, "stages": plan.stages}


# ---------------------------------------------------------------------------
# resolution chain: device key, exact, bucket, defaults
# ---------------------------------------------------------------------------

def test_bucket_signature_pow2_and_sorted():
    assert bucket_signature({"seq_q": 1000, "dtype": "bf16", "b": 1}) \
        == "b=1,dtype=bf16,seq_q=1024"


def test_device_kind_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert tune.device_kind() == "cpu"


def test_device_key_isolates_entries(clean_tune, monkeypatch):
    shape = {"tq": 64, "kv_heads": 32, "head_dim": 128, "page": 16,
             "nblk": 128, "dtype": "bfloat16"}
    c = current_cache()
    c.put("nvidia-h100-80gb-hbm3", "paged_attention",
          bucket_signature(shape), {"split_keys": 2048})
    c.save()
    monkeypatch.setattr(tune_cache, "device_kind", lambda: "cpu")
    cfg, meta = kernel_config_with_meta("paged_attention", shape)
    assert meta["source"] == "default" and cfg["split_keys"] == 512
    monkeypatch.setattr(tune_cache, "device_kind",
                        lambda: "nvidia-h100-80gb-hbm3")
    cfg, meta = kernel_config_with_meta("paged_attention", shape)
    assert meta["source"] == "exact" and meta["hit"] is True
    assert cfg == {"split_keys": 2048}


def test_bucket_fallback_nearest_numeric(clean_tune, monkeypatch):
    monkeypatch.setattr(tune_cache, "device_kind", lambda: "cpu")
    c = current_cache()
    near = {"m": 8, "k": 4096, "n": 4096, "dtype": "int8"}
    far = {"m": 8, "k": 4096, "n": 65536, "dtype": "int8"}
    c.put("cpu", "quant_matmul", bucket_signature(near),
          {"tile": 1, "split_slabs": 8})
    c.put("cpu", "quant_matmul", bucket_signature(far),
          {"tile": -1, "split_slabs": 2})
    c.save()
    cfg, meta = kernel_config_with_meta(
        "quant_matmul", {"m": 8, "k": 4096, "n": 11008, "dtype": "int8"})
    assert meta["source"] == "bucket" and meta["hit"] is True
    assert meta["matched"] == bucket_signature(near)
    assert cfg == {"tile": 1, "split_slabs": 8}


def test_bucket_fallback_never_crosses_dtype(clean_tune, monkeypatch):
    monkeypatch.setattr(tune_cache, "device_kind", lambda: "cpu")
    c = current_cache()
    c.put("cpu", "paged_attention",
          bucket_signature({"tq": 64, "kv_heads": 32, "head_dim": 128,
                            "page": 16, "nblk": 128, "dtype": "bfloat16"}),
          {"split_keys": 2048})
    c.save()
    cfg, meta = kernel_config_with_meta(
        "paged_attention", {"tq": 64, "kv_heads": 32, "head_dim": 128,
                            "page": 16, "nblk": 128, "dtype": "int8"})
    assert meta["source"] == "default"
    assert cfg == {"split_keys": 512}


def test_fa_env_override_wins_and_warns(clean_tune, monkeypatch):
    monkeypatch.setattr(tune_cache, "device_kind", lambda: "cpu")
    shape = {"seq_q": 2048, "seq_k": 2048, "head_dim": 128,
             "dtype": "bfloat16"}
    c = current_cache()
    c.put("cpu", "flash_attention", bucket_signature(shape),
          {"block_q": 128})
    c.save()
    monkeypatch.setenv("PADDLE_TPU_FA_BLOCK_Q", "64")
    tune_cache._ENV_WARNED.clear()
    with pytest.warns(DeprecationWarning, match="PADDLE_TPU_FA_BLOCK_Q"):
        cfg, meta = kernel_config_with_meta("flash_attention", shape)
    assert meta["source"] == "env"
    assert cfg == {"block_q": 64}
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert kernel_config("flash_attention", shape)["block_q"] == 64


def test_forced_config_beats_everything(clean_tune, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_TUNE_FORCE",
                       json.dumps({"paged_attention": {"split_keys": 256}}))
    cfg, meta = kernel_config_with_meta(
        "paged_attention", {"tq": 8, "kv_heads": 2, "head_dim": 64,
                            "page": 16, "nblk": 8, "dtype": "float32"})
    assert meta["source"] == "forced"
    assert cfg == {"split_keys": 256}


# ---------------------------------------------------------------------------
# one file format for both packages
# ---------------------------------------------------------------------------

def _entries():
    return [
        ("cpu", "paged_attention",
         {"tq": 64, "kv_heads": 32, "head_dim": 128, "page": 16,
          "nblk": 128, "dtype": "bfloat16"}, {"split_keys": 1024}),
        ("nvidia-h100-80gb-hbm3", "quant_matmul",
         {"m": 8, "k": 4096, "n": 11008, "dtype": "int8"},
         {"tile": 1, "split_slabs": 8}),
        ("cpu", "fused_norms", {"rows": 2048, "hidden": 4096,
                                "dtype": "float32"},
         {"team_warps": 2, "stages": 1}),
    ]


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_cache_file_loads_in_the_other_package(tmp_path, writer):
    path = str(tmp_path / "shared.json")
    w, r = (jax_tune.TuningCache, TuningCache) if writer == "reference" \
        else (TuningCache, jax_tune.TuningCache)
    c = w(path)
    for dev, kern, shape, cfg in _entries():
        c.put(dev, kern, bucket_signature(shape), cfg, score_s=2e-5,
              measure="wall-clock")
    c.save()
    got = r(path)
    assert len(got) == 3
    for dev, kern, shape, cfg in _entries():
        assert got.lookup(dev, kern, jax_tune.bucket_signature(shape)) == cfg
    assert got.kernels("cpu") == {"paged_attention", "fused_norms"}
    mine, theirs = TuningCache(path), jax_tune.TuningCache(path)
    assert mine._entries == theirs._entries


@pytest.mark.parametrize("seed", range(4))
def test_signatures_and_nearest_agree_with_reference(tmp_path, seed):
    rng = np.random.RandomState(seed)
    path = str(tmp_path / "n.json")
    mine, theirs = TuningCache(path), jax_tune.TuningCache(path)
    dtypes = ["float32", "bfloat16", "int8"]
    for i in range(12):
        shape = {"tq": int(rng.randint(1, 4096)),
                 "kv_heads": int(rng.choice([2, 8, 32])),
                 "head_dim": 128, "page": 16,
                 "nblk": int(rng.randint(1, 512)),
                 "dtype": dtypes[i % 3]}
        assert bucket_signature(shape) == jax_tune.bucket_signature(shape)
        for c in (mine, theirs):
            c.put("cpu", "paged_attention", bucket_signature(shape),
                  {"split_keys": 256 << (i % 4)})
    for _ in range(20):
        q = {"tq": int(rng.randint(1, 8192)),
             "kv_heads": int(rng.choice([1, 4, 16, 64])),
             "head_dim": 128, "page": 16, "nblk": int(rng.randint(1, 1024)),
             "dtype": dtypes[int(rng.randint(0, 3))]}
        sig = bucket_signature(q)
        assert mine.nearest("cpu", "paged_attention", sig) == \
            theirs.nearest("cpu", "paged_attention", sig)


# ---------------------------------------------------------------------------
# the wrappers' plans follow the cache (the rule without an entry)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("split", [256, 512, 1024, 2048])
def test_forced_split_reaches_the_walk_plan(clean_tune, monkeypatch, split):
    args = (64, 32, 128, 16, 128, torch.bfloat16, False)
    assert pa._split_keys(*args) == pa._SPLIT_KEYS           # no entry
    monkeypatch.setenv("PADDLE_TPU_TUNE_FORCE", json.dumps(
        {"paged_attention": {"split_keys": split}}))
    assert pa._split_keys(*args) == split
    plan = pa._walk_plan(64, 32, 32, 128, 16, 9, 128, torch.bfloat16,
                         False, False, split)
    assert plan[1] % 64 == 0 and plan[1] * plan[2] >= 128 * 16


@pytest.mark.parametrize("tile,slabs", [(-1, 0), (0, 4), (1, 1), (2, 32),
                                        (7, -3)])
def test_forced_qmm_plan_reaches_the_c_arguments(clean_tune, monkeypatch,
                                                 tile, slabs):
    assert qm._plan(8, 4096, 11008, "int8") == (-1, 0)       # the rule
    monkeypatch.setenv("PADDLE_TPU_TUNE_FORCE", json.dumps(
        {"quant_matmul": {"tile": tile, "split_slabs": slabs}}))
    want_tile = tile if tile in (0, 1, 2) else -1
    assert qm._plan(8, 4096, 11008, "int8") == (want_tile, max(0, slabs))


@pytest.mark.parametrize("warps,stages", [(1, 1), (2, 2), (4, 1), (8, 2),
                                          (8, 4)])
def test_forced_norm_knobs_reach_the_plan(clean_tune, monkeypatch, warps,
                                          stages):
    R, H = 2048, 4096
    rule = fn._norm_plan(R, H, torch.bfloat16, torch.bfloat16, "rms",
                         torch.bfloat16)
    assert fn._tuned_knobs(tune.config_epoch(), R, H, torch.bfloat16) == \
        (None, None)
    monkeypatch.setenv("PADDLE_TPU_TUNE_FORCE", json.dumps(
        {"fused_norms": {"team_warps": warps, "stages": stages}}))
    knobs = fn._tuned_knobs(tune.config_epoch(), R, H, torch.bfloat16)
    assert knobs == (warps, stages)
    plan = fn._norm_plan(R, H, torch.bfloat16, torch.bfloat16, "rms",
                         torch.bfloat16, 132, *knobs)
    assert plan.path == rule.path == "walk"
    assert plan.team_warps == warps and plan.stages == stages
    assert plan.teams * plan.team_warps * 32 == plan.threads
    assert plan.grid * plan.teams * plan.stages >= 1


def test_forced_norm_knobs_snap_to_the_shape():
    """What the shape cannot take falls back: more warps than vectors for
    their lanes halve, a stage no row fills takes the rule's plan."""
    rule8 = fn._norm_plan(8, 4096, torch.bfloat16, torch.bfloat16, "rms",
                          torch.bfloat16)
    snapped = fn._norm_plan(8, 1024, torch.bfloat16, torch.bfloat16, "rms",
                            torch.bfloat16, 132, 8, 1)
    assert snapped.team_warps * 32 <= 1024 * 2 // 16
    assert fn._norm_plan(8, 4096, torch.bfloat16, torch.bfloat16, "rms",
                         torch.bfloat16, 132, 1, 4) == rule8


def test_wrapper_lookup_kept_until_the_cache_changes(clean_tune):
    """The wrappers keep a shape's answer (no launch reads a file) and
    look again when an entry is added or the path changes."""
    args = (8, 4, 128, 16, 128, torch.float32, False)
    sig = bucket_signature({"tq": 8, "kv_heads": 4, "head_dim": 128,
                            "page": 16, "nblk": 128, "dtype": "float32"})
    before = pa._tuned_split_keys.cache_info().misses
    assert pa._split_keys(*args) == 512
    assert pa._split_keys(*args) == 512
    assert pa._tuned_split_keys.cache_info().misses == before + 1
    current_cache().put(tune.device_kind(), "paged_attention", sig,
                        {"split_keys": 2048})
    assert pa._split_keys(*args) == 2048
    set_cache_path(clean_tune + ".other")
    assert pa._split_keys(*args) == 512


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, {"weight_dtype": "int8"},
                                {"tp": 2, "weight_dtype": "int4"}],
                         ids=["f32", "w8", "tp2-w4"])
def test_engine_tuning_report_matches_reference(clean_tune, pair, kw):
    jm, tm = pair
    mine = LLMEngine(tm, device="cpu", **_kw(**kw)).summary()["tuning_cache"]
    theirs = JaxEngine(jm, **_kw(**kw)).summary()["tuning_cache"]
    assert mine["path"] == theirs["path"] == clean_tune
    assert mine["device"] == "cpu"
    assert set(mine["kernels"]) == set(theirs["kernels"])
    for name, rec in mine["kernels"].items():
        ref = theirs["kernels"][name]
        assert set(rec) == set(ref)
        assert rec["key"] == ref["key"], name        # the same shape keys
        assert rec["hit"] is ref["hit"] is False
        assert rec["source"] == ref["source"] == "default"


PAGED_CANDIDATES = [{"split_keys": s} for s in (256, 512, 1024, 2048)]
QMM_CANDIDATES = [{"tile": t, "split_slabs": s} for t in (-1, 1)
                  for s in (0, 2, 8, 32)]


@pytest.mark.parametrize(
    "kernel,config",
    [("paged_attention", c) for c in PAGED_CANDIDATES]
    + [("quant_matmul", c) for c in QMM_CANDIDATES],
    ids=lambda v: v if isinstance(v, str) else "-".join(
        f"{k}{x}" for k, x in v.items()))
def test_greedy_tokens_equal_under_each_forced_candidate(
        clean_tune, pair, monkeypatch, kernel, config):
    _, tm = pair
    kw = _kw(weight_dtype="int8")
    base = _stream_tokens(LLMEngine(tm, device="cpu", **kw))
    monkeypatch.setenv("PADDLE_TPU_TUNE_FORCE", json.dumps({kernel: config}))
    eng = LLMEngine(tm, device="cpu", **kw)
    assert _stream_tokens(eng) == base
    rep = eng.summary()["tuning_cache"]["kernels"][kernel]
    assert rep["source"] == "forced" and rep["config"] == config


def test_engine_outputs_identical_across_tuned_caches(clean_tune, pair,
                                                      tmp_path):
    """Three caches with three distinct tuned configs: identical greedy
    tokens and compile footprint; each engine's report names the config
    its cache carried."""
    _, tm = pair
    dev = tune.device_kind()
    pa_shape = {"tq": 32, "kv_heads": 4, "head_dim": 8, "page": 8,
                "nblk": 8, "dtype": "float32"}
    results = []
    for i, split in enumerate((256, 1024, 2048)):
        path = str(tmp_path / f"cache_{i}.json")
        c = TuningCache(path)
        c.put(dev, "paged_attention", bucket_signature(pa_shape),
              {"split_keys": split})
        c.save()
        set_cache_path(path)
        eng = LLMEngine(tm, device="cpu", **_kw())
        results.append((_stream_tokens(eng), dict(eng.compile_counts),
                        eng.summary()["tuning_cache"]))
        assert results[-1][2]["kernels"]["paged_attention"]["config"] == \
            {"split_keys": split}
        assert results[-1][2]["kernels"]["paged_attention"]["hit"] is True
    for toks, compiles, _ in results[1:]:
        assert toks == results[0][0]
        assert compiles == results[0][1]


# ---------------------------------------------------------------------------
# the CPU end-to-end path: sweep -> cache file -> engine reports hits
# ---------------------------------------------------------------------------

def _autotune_main():
    spec = importlib.util.spec_from_file_location(
        "torch_autotune", os.path.join(REPO, "tools", "perf",
                                       "torch_autotune.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


def test_autotune_cli_cost_model_end_to_end(clean_tune, tmp_path, capsys,
                                            pair):
    cache_file = str(tmp_path / "swept.json")
    assert _autotune_main()(["--cost-model", "--cache", cache_file]) == 0
    lines = [ln for ln in capsys.readouterr().out.strip().splitlines()
             if ln.strip()]
    record = json.loads(lines[-1])
    assert set(record) == {"metric", "value", "unit", "device", "cache",
                           "measure", "results", "untuned_launches"}
    assert record["metric"] == "autotune_cache_entries"
    assert record["measure"] == "cost-model"
    assert record["value"] > 0
    assert record["untuned_launches"] == []
    assert all(math.isfinite(r["score_s"]) for r in record["results"])
    c = TuningCache(cache_file)
    assert c.kernels() == FIVE
    _, tm = pair
    set_cache_path(cache_file)
    report = LLMEngine(tm, device="cpu", **_kw()).summary()["tuning_cache"]
    assert report["path"] == cache_file
    for name in FIVE - {"quant_matmul"}:
        assert report["kernels"][name]["hit"] is True, report["kernels"]
    assert "quant_matmul" not in report["kernels"]
    report8 = LLMEngine(tm, device="cpu", **_kw(weight_dtype="int8")) \
        .summary()["tuning_cache"]
    assert report8["kernels"]["quant_matmul"]["source"] in ("exact",
                                                           "bucket")


def test_run_sweep_cost_model_in_process(clean_tune, tmp_path, monkeypatch):
    monkeypatch.setattr(tune_cache, "device_kind", lambda: "cpu")
    cache_file = str(tmp_path / "sweep.json")
    report = tune.run_sweep(tune.CostModelMeasurer(), cache_file,
                            kernels=["fused_norms"])
    assert report["measure"] == "cost-model"
    assert report["entries"] == 2                 # f32 + bf16 sweep shapes
    for row in report["results"]:
        assert row["kernel"] == "fused_norms"
        assert "error" not in row and row["failed"] == []
        assert row["score_s"] <= row["default_s"]
    c = TuningCache(cache_file)
    assert c.kernels("cpu") == {"fused_norms"}


def test_run_sweep_takes_other_shapes(clean_tune, tmp_path):
    shape = {"tq": 8, "kv_heads": 16, "head_dim": 128, "page": 16,
             "nblk": 128, "dtype": "bfloat16"}
    report = tune.run_sweep(tune.CostModelMeasurer(),
                            str(tmp_path / "s.json"),
                            kernels=["paged_attention"],
                            shapes={"paged_attention": [shape]})
    assert [r["sig"] for r in report["results"]] == [bucket_signature(shape)]


def test_sweep_reports_failed_candidates(tmp_path):
    class Failing:
        kind = "wall-clock"
        last_error = None

        def measure(self, kernel, shape, config):
            if config["split_keys"] == 1024:
                self.last_error = "launch refused"
                return math.inf
            self.last_error = None
            return config["split_keys"] * 1e-9

    rows = tune.sweep_kernel(tune.get_kernel("paged_attention"), Failing(),
                             TuningCache(str(tmp_path / "f.json")), "cpu")
    for row in rows:
        assert row["config"] == {"split_keys": 256}
        assert row["failed"] == [{"config": {"split_keys": 1024},
                                  "error": "launch refused"}]


@pytest.mark.parametrize("name", sorted(FIVE))
def test_cost_model_scores_every_candidate(name):
    kern = tune.get_kernel(name)
    for shape in kern.sweep:
        for cfg in tune.candidate_configs(kern, shape):
            s = tune.cost.estimate(name, shape, cfg)
            assert math.isfinite(s) and s > 0, (shape, cfg)


def test_untuned_launch_report_clean_on_shipped_tree():
    assert tune.untuned_launch_report() == []


def test_registry_has_the_reference_names_and_keys():
    assert {k.name for k in tune.all_kernels()} == FIVE == \
        {k.name for k in jax_tune.all_kernels()}
    for k in tune.all_kernels():
        ref = jax_tune.get_kernel(k.name)
        assert [set(s) for s in k.sweep] == \
            [set(ref.sweep[0])] * len(k.sweep)
        for shape in k.sweep:
            cands = tune.candidate_configs(k, shape)
            assert cands[0] == tune.defaults_for(k, shape)
            assert len({json.dumps(c, sort_keys=True) for c in cands}) == \
                len(cands)


def test_cache_path_resolution_matches_reference(clean_tune, monkeypatch):
    assert cache_path() == jax_tune_cache.cache_path() == clean_tune
    set_cache_path(None)
    jax_tune.set_cache_path(None)
    monkeypatch.setenv("PADDLE_TPU_TUNE_CACHE", clean_tune + ".env")
    assert cache_path() == jax_tune_cache.cache_path() == clean_tune + ".env"
    monkeypatch.delenv("PADDLE_TPU_TUNE_CACHE")
    assert cache_path() == jax_tune_cache.cache_path()
