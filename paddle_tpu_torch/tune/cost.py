"""A roofline cost model of the port's kernels on an NVIDIA H100 SXM:
scores candidates without a card (counterpart of paddle_tpu/tune/cost.py).

It is a model, not a measurement.  Each launch is priced as the larger of
the bytes it must move over HBM's rate and the operations it does over
the tensor cores' (or, in f32, the CUDA cores') peak -- the bound that
``chip_smoke.py`` reports beside each kernel's time -- plus what a plan
adds: the split partials a plan writes and reads back, the rate lost when
a launch has fewer blocks than the card has SMs, and a fixed cost a wave
of blocks.  The constants are data-sheet peaks; the RANKING is what the
sweep persists, and on the card ``SubprocessMeasurer`` times real
launches instead.
"""
from __future__ import annotations

import math

__all__ = ["estimate", "PEAK_BW", "PEAK_FLOPS", "SMS"]

PEAK_BW = 3.35e12                       # byte/s HBM3
PEAK_FLOPS = {"bfloat16": 989e12,       # flop/s dense, tensor cores
              "float32": 67e12,         # CUDA cores
              "int8": 989e12}           # codes converted to bf16
SMS = 132
PER_WAVE_S = 2e-6                       # a wave of blocks: launch, prologue

_DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2, "int8": 1}


def _bytes(dtype: str) -> int:
    return _DTYPE_BYTES.get(dtype, 4)


def _roofline(flops, peak, traffic, blocks, per_sm=1):
    """max(compute, memory) with the rate scaled by the share of SMs the
    blocks occupy, plus one PER_WAVE_S a wave."""
    slots = SMS * per_sm
    share = min(1.0, blocks / slots) if blocks else 1.0
    waves = math.ceil(blocks / slots) if blocks else 1
    return max(flops / peak, traffic / PEAK_BW) / share + waves * PER_WAVE_S


def _flash(shape: dict, config: dict) -> float:
    sq, sk, d = shape["seq_q"], shape["seq_k"], shape["head_dim"]
    dt = shape.get("dtype", "float32")
    eb = _bytes(dt)
    heads = shape.get("heads", 8)
    bq = config["block_q"]
    blocks = heads * math.ceil(sq / bq)
    flops = 4.0 * heads * sq * sk * d
    traffic = eb * heads * (2 * sq * d + 2 * sk * d) + 4 * heads * sq
    return _roofline(flops, PEAK_FLOPS.get(dt, PEAK_FLOPS["float32"]),
                     traffic, blocks)


def _norms(shape: dict, config: dict) -> float:
    rows, hidden = shape["rows"], shape["hidden"]
    eb = _bytes(shape.get("dtype", "float32"))
    wpr, stages = config["team_warps"], config["stages"]
    traffic = eb * (2 * rows * hidden + hidden)
    if not wpr:                                # the row kernel
        return _roofline(8.0 * rows * hidden, PEAK_FLOPS["float32"],
                         traffic, rows)
    teams = max(1, 8 // wpr)                   # 256-thread blocks
    blocks = math.ceil(rows / (teams * stages))
    # rows in flight beyond 64 KB an SM buy nothing (the plan's rule)
    per_sm = max(1, min(4, 65_536 // max(1, teams * stages * hidden * eb)))
    return _roofline(8.0 * rows * hidden, PEAK_FLOPS["float32"], traffic,
                     blocks, per_sm)


def _paged(shape: dict, config: dict) -> float:
    tq, kvh, d = shape["tq"], shape["kv_heads"], shape["head_dim"]
    page, nblk = shape["page"], shape["nblk"]
    dt = shape.get("dtype", "float32")
    eb = _bytes(dt)
    cap = nblk * page
    tt = 64 if dt == "bfloat16" else 8         # tokens a tile, G = 1
    tiles = math.ceil(tq / tt)
    nsplit = max(1, math.ceil(cap / config["split_keys"]))
    items = tiles * kvh * nsplit
    kv = eb * tiles * kvh * cap * d * 2        # each tile streams its row
    qo = 2 * 4 * tq * kvh * d
    partial = (nsplit > 1) * 2 * items * 8 * (d + 2) * 4
    flops = 4.0 * tq * kvh * cap * d
    peak = PEAK_FLOPS["bfloat16"] if dt != "float32" \
        else PEAK_FLOPS["float32"]
    return _roofline(flops, peak, kv + qo + partial, items, 2)


def _weight_bytes_per_elem(dtype: str) -> float:
    return 0.5 if dtype == "int4" else float(_bytes(dtype))


def _quant_matmul(shape: dict, config: dict) -> float:
    """x [M, K] bf16 against a quantized [K, N] pool; the rule's tile for
    tile -1 (16 rows up to M 16, else the 64-row wgmma tile of 256
    columns), the rule's splits for split_slabs 0 (enough blocks to fill
    the SMs twice, at most 16), else as many splits as the slabs take."""
    m, k, n = shape["m"], shape["k"], shape["n"]
    dtype = shape.get("dtype", "int8")
    tile = config["tile"]
    if tile < 0:
        tile = 0 if m <= 16 else 2
    bm, bn = (16, 128) if tile == 0 else (64, 128) if tile == 1 \
        else (64, 256)
    tiles = math.ceil(m / bm) * math.ceil(n / bn)
    slabs = math.ceil(k / 128)
    per = config["split_slabs"]
    splits = math.ceil(slabs / per) if per else 2 * SMS // tiles
    splits = max(1, min(16, slabs, splits))
    flops = 2.0 * math.ceil(m / bm) * bm * k * n
    scale_rows = math.ceil(k / 128) if dtype == "int4" else 1
    traffic = (2.0 * m * k + _weight_bytes_per_elem(dtype) * k * n
               + 4.0 * scale_rows * n + 4.0 * m * n
               + (splits > 1) * 2 * 4.0 * splits * m * n)
    return _roofline(flops, PEAK_FLOPS["bfloat16"], traffic, tiles * splits,
                     2)


_MODELS = {
    "flash_attention": _flash,
    "flash_attention_varlen": _flash,
    "fused_norms": _norms,
    "paged_attention": _paged,
    "quant_matmul": _quant_matmul,
}


def estimate(kernel: str, shape: dict, config: dict) -> float:
    """Modeled seconds for one launch; math.inf when infeasible."""
    fn = _MODELS.get(kernel)
    if fn is None:
        raise KeyError(f"no cost model for kernel {kernel!r}")
    return fn(shape, config)
