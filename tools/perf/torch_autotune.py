"""CUDA kernel autotuner CLI for the PyTorch port: sweep the registered
search spaces, write the persistent tuning cache, and report untuned
launches (counterpart of tools/perf/autotune.py: the same flags and the
same final record).

Two measurement modes share one search loop (paddle_tpu_torch.tune.search):

* default (wall-clock): each candidate runs in its own child process on
  the card, held against the kernel's plain version, then timed with CUDA
  events; a candidate that fails to build, launch or match fails only its
  child.
* ``--cost-model``: candidates are ranked in-process by the H100 roofline
  model; no card needed, so the CPU runs the whole search -> persist ->
  lookup pipeline.

Prints one report line per (kernel, shape) sweep row, a section listing
the CUDA launches in paddle_tpu_torch/ops whose plan does NOT flow from
the tuning-cache lookup helper, then ONE final JSON record line:

  {"metric": "autotune_cache_entries", "value": ..., "unit": "entries",
   "device": ..., "cache": ..., "measure": ..., "results": [...],
   "untuned_launches": [...]}

Usage:
  python tools/perf/torch_autotune.py --cost-model        # CPU path
  python tools/perf/torch_autotune.py                     # on the card
  python tools/perf/torch_autotune.py --kernel paged_attention --cache t.json
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cost-model", action="store_true",
                    help="rank candidates with the roofline cost model "
                         "in-process (no card; the CPU path)")
    ap.add_argument("--cache", default=None,
                    help="cache file to write (default: the resolved "
                         "runtime path -- PADDLE_TPU_TUNE_CACHE or "
                         "~/.cache/paddle_tpu/tuning_cache.json)")
    ap.add_argument("--kernel", action="append", default=None,
                    help="restrict the sweep to this kernel (repeatable)")
    ap.add_argument("--device", default=None,
                    help="override the device key (default: the CUDA "
                         "card's name, 'cpu' without one)")
    ap.add_argument("--iters", type=int, default=5,
                    help="timing iterations per candidate (wall-clock)")
    ap.add_argument("--timeout", type=int, default=900,
                    help="per-candidate subprocess timeout seconds")
    ap.add_argument("--verbose", action="store_true",
                    help="log every candidate's score, not just winners")
    args = ap.parse_args(argv)

    from paddle_tpu_torch.tune import (CostModelMeasurer, SubprocessMeasurer,
                                       all_kernels, cache_path, run_sweep,
                                       untuned_launch_report)

    known = {k.name for k in all_kernels()}
    if args.kernel and set(args.kernel) - known:
        ap.error(f"unknown kernel(s) {sorted(set(args.kernel) - known)}; "
                 f"choose from {sorted(known)}")

    if args.cost_model:
        measurer = CostModelMeasurer()
    else:
        measurer = SubprocessMeasurer(timeout=args.timeout,
                                      iters=args.iters)
    cache_file = args.cache or cache_path()
    log = (lambda s: print(s, flush=True)) if args.verbose else None
    report = run_sweep(measurer, cache_file, kernels=args.kernel,
                       device=args.device, log=log)

    for row in report["results"]:
        if "error" in row:
            print(f"{row['kernel']:24s} {row['sig']:48s} {row['error']}",
                  flush=True)
            continue
        sp = row["speedup"]
        print(f"{row['kernel']:24s} {row['sig']:48s} "
              f"winner={json.dumps(row['config'])} "
              f"score={row['score_s'] * 1e6:.2f}us "
              f"vs-default={'n/a' if sp is None else f'{sp:.2f}x'}",
              flush=True)
        for f in row.get("failed", ()):
            print(f"  failed {json.dumps(f['config'])}: {f['error']}",
                  flush=True)

    # launches the tuner cannot reach
    untuned = untuned_launch_report()
    if untuned:
        print(f"-- {len(untuned)} untuned CUDA launch(es):", flush=True)
        for row in untuned:
            print(f"WARNING untuned-cuda-launch "
                  f"{row['file']}:{row['line']} ({row['func']})",
                  flush=True)
    else:
        print("-- all CUDA launches flow from the tuning cache", flush=True)

    print(json.dumps({
        "metric": "autotune_cache_entries", "value": report["entries"],
        "unit": "entries", "device": report["device"],
        "cache": report["cache"], "measure": report["measure"],
        "results": report["results"], "untuned_launches": untuned,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
