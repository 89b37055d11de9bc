"""Varlen flash attention backward on the card: this checkout's dK/dV and
dQ kernels against another checkout's, in turns.

    python tools/perf/torch_varlen_bwd_ab.py --other DIR [--out FILE]

DIR is another tree of this repository (for example the parent commit,
unpacked with ``git archive``).  Each turn runs in a child process whose
``paddle_tpu_torch`` is one tree's (its wrappers, segment metadata and
kernels, built from its own ``csrc/`` into its own ``build/``), in the
order other, this, this, other; the timing code is this checkout's
``chip_smoke.py`` in every turn, and the inputs are made from the same
seed.  At the varlen phase's ``7b`` and ``trainer_d64`` cases (8 packed
causal sequences, 8,192 tokens; H 32, D 128 and H 16, D 64; bf16), each
turn reports ``time_ms`` of ``_launch_dkdv`` and ``_launch_dq`` (the
wrapper's device ops included), the profiler's kernel-only time of each,
and ``bwd_total_ms``: ``_backward`` whole (delta, metadata, both
launches).

Prints one JSON object with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
CASES = ("7b", "trainer_d64")
# the kernels' names in either tree (wgmma since the redesign, mma.sync
# before it; the CUDA-core kernels take no bf16 case here)
NAMES = {"dkdv": ("varlen_bwd_dkdv_wgmma_kernel",
                  "varlen_bwd_dkdv_mma_kernel"),
         "dq": ("varlen_bwd_dq_wgmma_kernel", "varlen_bwd_dq_mma_kernel")}


def smoke():
    """This checkout's chip_smoke.py as a module (its functions import the
    port lazily, so they take whichever tree is first on sys.path)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def child(tree: Path) -> dict:
    sys.path.insert(0, str(tree))
    import torch
    from paddle_tpu_torch.ops import flash_attention_varlen as fav
    assert Path(fav.__file__).resolve().is_relative_to(tree)
    cs = smoke()
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 10)
    res = {}
    for name in CASES:
        c = cs.varlen_case(name, torch.bfloat16, gen)
        q, k, v, do = c["q"], c["k"], c["v"], c["do"]
        args = cs.varlen_args(c)
        out, lse = cs.varlen_plain_fwd(q, k, v, *args)
        delta = fav.varlen_delta(out, do)
        fns = {"dkdv": lambda: fav._launch_dkdv(q, k, v, do, lse, delta,
                                                *args),
               "dq": lambda: fav._launch_dq(q, k, v, do, lse, delta, *args)}
        res[name] = {
            "ms": {kern: cs.time_ms(f) for kern, f in fns.items()},
            "kernel_ms": {kern: cs.profiled_kernel_ms(f, NAMES[kern])
                          for kern, f in fns.items()},
            "bwd_total_ms": cs.time_ms(lambda: fav._backward(
                q, k, v, out, lse, do, *args))}
        del c, q, k, v, do, out, lse, delta
        torch.cuda.empty_cache()
    return res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", type=Path)
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.child.resolve())))
        return 0
    if args.other is None:
        ap.error("--other is required")
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    trees = {"this": ROOT, "other": args.other.resolve()}
    res = {"device": smoke().nvidia_smi(), "turns": []}
    for tree in ("other", "this", "this", "other"):
        run = subprocess.run([sys.executable, __file__, "--child",
                              str(trees[tree])], capture_output=True,
                             text=True, cwd=trees[tree])
        if run.returncode != 0:
            print(run.stderr[-4000:], file=sys.stderr)
            return 1
        res["turns"].append({"tree": tree,
                             **json.loads(run.stdout.splitlines()[-1])})
    text = json.dumps(res)
    print(text)
    if args.out:
        args.out.write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
