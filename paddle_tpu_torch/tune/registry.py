"""TunableKernel registry: the search space each CUDA kernel exposes
(counterpart of paddle_tpu/tune/registry.py).

A registration declares, per kernel: the tunable plan options and their
candidate values (``space``), the defaults the fallback chain bottoms out
at, any deprecated env-var levers that still override the cache, and a
``sweep`` of representative shape keys the autotuner measures.  The five
names and their shape keys are the JAX package's, so a tuning cache and an
engine's ``summary()["tuning_cache"]`` read the same in both packages; the
spaces are the plan options of the port's kernels, and every default is
the rule the kernel's wrapper applied before tuning existed, so a launch
with no cache entry is bit for bit what it was.

Where the options a kernel really has depend on the shape (the flash
forward has one instantiation per dtype and head dim; the norm plan's
default is its rule for the row width), ``options`` gives the space and
defaults of one shape key; ``space`` and ``defaults`` are then the union
and the registry-wide fallbacks.  The registry is data: it imports no
kernel module at import time.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field

__all__ = ["TunableKernel", "register", "get_kernel", "all_kernels",
           "candidate_configs", "defaults_for"]


@dataclass(frozen=True)
class TunableKernel:
    """Search-space declaration for one CUDA kernel.

    name           cache key component ("paged_attention", ...)
    space          param -> tuple of candidate values
    defaults       param -> built-in value (end of the fallback chain)
    env_overrides  param -> deprecated env var that still wins over the
                   cache (with a DeprecationWarning)
    sweep          representative shape keys measured by the autotuner;
                   launch-time lookups resolve to these via the bucket
                   fallback when their own bucket has no entry
    describe       one-line human summary for reports
    options        None, or shape key -> (space, defaults) of that shape
    """
    name: str
    space: dict = field(default_factory=dict)
    defaults: dict = field(default_factory=dict)
    env_overrides: dict = field(default_factory=dict)
    sweep: tuple = ()
    describe: str = ""
    options: object = None


_REGISTRY: dict = {}


def register(kernel: TunableKernel) -> TunableKernel:
    _REGISTRY[kernel.name] = kernel
    return kernel


def get_kernel(name: str):
    return _REGISTRY.get(name)


def all_kernels() -> tuple:
    return tuple(_REGISTRY[k] for k in sorted(_REGISTRY))


def _space_and_defaults(kernel: TunableKernel, shape=None):
    if shape is not None and kernel.options is not None:
        return kernel.options(shape)
    return kernel.space, kernel.defaults


def defaults_for(kernel: TunableKernel, shape=None) -> dict:
    """The kernel's defaults at ``shape`` (its registry defaults when it
    has no per-shape options or no shape is given)."""
    return dict(_space_and_defaults(kernel, shape)[1])


def candidate_configs(kernel: TunableKernel, shape=None):
    """Cartesian product of the kernel's search space (at ``shape`` when
    it has per-shape options), defaults first."""
    space, defaults = _space_and_defaults(kernel, shape)
    names = sorted(space)
    seen = [{k: defaults[k] for k in names}]
    for combo in itertools.product(*(space[k] for k in names)):
        cfg = dict(zip(names, combo))
        if cfg not in seen:
            seen.append(cfg)
    return seen


# ---------------------------------------------------------------------------
# the five kernels (the JAX package's names and shape keys)
# ---------------------------------------------------------------------------

def _flash_options(shape):
    """The forward's rows a block: one instantiation a (dtype, head dim)
    -- 128 (two wgmma warpgroups) for bf16 at D 64 and 128, 64 (the CUDA
    cores) elsewhere -- so one value a shape."""
    bq = 128 if shape.get("dtype") == "bfloat16" and \
        shape.get("head_dim", 0) <= 128 else 64
    return {"block_q": (bq,)}, {"block_q": bq}


# dense flash attention: one forward instantiation per (dtype, head dim),
# so every shape has a one-value space; registered so the cache and the
# engine's report carry the JAX package's five names
register(TunableKernel(
    name="flash_attention",
    space={"block_q": (64, 128)},
    defaults={"block_q": 128},
    env_overrides={"block_q": "PADDLE_TPU_FA_BLOCK_Q"},
    sweep=(
        {"seq_q": 2048, "seq_k": 2048, "head_dim": 128, "dtype": "float32"},
        {"seq_q": 2048, "seq_k": 2048, "head_dim": 128, "dtype": "bfloat16"},
    ),
    describe="flash attention forward rows a block (one instantiation a "
             "dtype and head dim: a one-value space)",
    options=_flash_options,
))

# varlen flash attention: the same rule (``fwd_block_q``); its q extent is
# the prefill token bucket, not seq_len
register(TunableKernel(
    name="flash_attention_varlen",
    space={"block_q": (64, 128)},
    defaults={"block_q": 128},
    env_overrides={"block_q": "PADDLE_TPU_FA_BLOCK_Q"},
    sweep=(
        {"seq_q": 512, "seq_k": 2048, "head_dim": 128, "dtype": "float32"},
        {"seq_q": 512, "seq_k": 2048, "head_dim": 128, "dtype": "bfloat16"},
    ),
    describe="varlen flash attention forward rows a block (one "
             "instantiation a dtype and head dim: a one-value space)",
    options=_flash_options,
))

NORM_WARPS = (1, 2, 4, 8)
NORM_STAGES = (1, 2)


def _norm_options(shape):
    """The norm walk's warps a row and ring stages; the default is the
    plan's rule for the shape (RMSNorm, weights of x's dtype).  Rows wider
    than a slot take the one-block-a-row kernel, which has neither knob:
    then one value, 0."""
    import torch
    from ..ops import fused_norms as fn
    dt = torch.bfloat16 if shape.get("dtype") == "bfloat16" \
        else torch.float32
    plan = fn._norm_plan(shape["rows"], shape["hidden"], dt, dt, "rms", dt)
    rule = {"team_warps": plan.team_warps, "stages": plan.stages}
    if plan.path == "row":
        return {"team_warps": (0,), "stages": (0,)}, rule
    return {"team_warps": NORM_WARPS, "stages": NORM_STAGES}, rule


# fused RMS/LayerNorm: the row walk's team width (it changes the order of
# a row's sums) and ring depth (it does not)
register(TunableKernel(
    name="fused_norms",
    space={"team_warps": NORM_WARPS, "stages": NORM_STAGES},
    defaults={"team_warps": 1, "stages": 1},
    sweep=(
        {"rows": 2048, "hidden": 4096, "dtype": "float32"},
        {"rows": 2048, "hidden": 4096, "dtype": "bfloat16"},
    ),
    describe="fused RMS/LayerNorm row walk: warps a row, ring stages",
    options=_norm_options,
))

# ragged paged attention: keys a split of a tile's row.  A different split
# merges the online-softmax partials at other points, so it changes the
# order of the sums (not the bytes read): the per-launch gate holds it.
register(TunableKernel(
    name="paged_attention",
    space={"split_keys": (256, 512, 1024, 2048)},
    defaults={"split_keys": 512},
    sweep=(
        {"tq": 8, "kv_heads": 4, "head_dim": 128, "page": 16, "nblk": 128,
         "dtype": "float32"},
        {"tq": 64, "kv_heads": 32, "head_dim": 128, "page": 16, "nblk": 128,
         "dtype": "bfloat16"},
        {"tq": 64, "kv_heads": 32, "head_dim": 128, "page": 16, "nblk": 128,
         "dtype": "int8"},
    ),
    describe="ragged paged attention keys a split",
))

QMM_TILES = (-1, 0, 1)
QMM_SLABS = (0, 2, 8, 32)


def _qmm_options(shape):
    """Up to 16 rows the rule's tile is the 16-row one, so naming it
    again adds no plan: the tiles are the rule and the 64-row tile."""
    tiles = (-1, 1) if shape["m"] <= 16 else QMM_TILES
    return ({"tile": tiles, "split_slabs": QMM_SLABS},
            {"tile": -1, "split_slabs": 0})


# fused dequant matmul: the row tile (-1: the kernel's rule; 0: 16 rows on
# mma.sync; 1: 64 rows on mma.sync) and the 128-row K slabs a split sums
# (0: the rule; the split count follows from K).  The wgmma tile (bf16 x
# above 16 rows) stays the rule's: the shape key has no x dtype, and f32 x
# cannot take it.  The slabs change the order of the f32 sums, the tile
# does not.  Slabs, not a split count, because a winner travels through
# the nearest-bucket fallback: one split chosen at K 4,096 would leave an
# 86-slab f32 chain at K 11,008, past the dequant matmul's 1e-5 gate;
# slabs bound the chain at every K.
register(TunableKernel(
    name="quant_matmul",
    space={"tile": QMM_TILES, "split_slabs": QMM_SLABS},
    defaults={"tile": -1, "split_slabs": 0},
    sweep=(
        {"m": 8, "k": 4096, "n": 4096, "dtype": "int8"},
        {"m": 8, "k": 4096, "n": 11008, "dtype": "int8"},
        {"m": 8, "k": 4096, "n": 4096, "dtype": "int4"},
        {"m": 8, "k": 4096, "n": 11008, "dtype": "int4"},
    ),
    describe="fused dequant-matmul row tile and K slabs a split "
             "(int8/int4)",
    options=_qmm_options,
))
