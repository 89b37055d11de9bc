"""Paged attention on the card: the walk's key split swept.

    python tools/perf/torch_paged_sweep.py [--splits 256 512 ...] [--out FILE]

Times this checkout's three paged entries at ``torch_ab.py``'s ``paged``
cases (bf16 unless named: the float and int8-page entries at chip_smoke's
``decode``, ``mixed`` and ``mixed_gqa``, the decode entry at ``mha``,
``gqa`` and ``gqa_float32``; LLaMA-7B's H 32, D 128) with the walk's split
(``_SPLIT_KEYS``, keys a split of a tile of at most 8 rows) set to each
value in turn, then once more at the first value.  Each case reports
``time_ms`` and the profiler's kernel-only time at each split.  Prints one
JSON object with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools" / "perf"))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--splits", type=int, nargs="+",
                    default=[512, 256, 1024, 2048])
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import torch_ab
    from paddle_tpu_torch.ops import paged_attention as pa
    names = ("paged_walk_kernel",)
    res = {"device": cs.nvidia_smi(), "cases": {}}
    own = pa._SPLIT_KEYS
    try:
        for case, fns in torch_ab.paged_cases(cs):
            fn = fns["attention"]
            res["cases"][case] = []
            for split in args.splits + args.splits[:1]:
                pa._SPLIT_KEYS = split
                res["cases"][case].append({
                    "split_keys": split, "ms": cs.time_ms(fn),
                    "kernel_ms": cs.profiled_kernel_ms(fn, names)})
    finally:
        pa._SPLIT_KEYS = own
    text = json.dumps(res)
    print(text)
    if args.out:
        args.out.write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
