"""Flash attention forwards on the card: this checkout's kernels against
another checkout's, fixed-length and varlen.

    python tools/perf/torch_flash_fwd_ab.py --other DIR [--out FILE]

DIR is another tree of this repository (for example the parent commit,
unpacked with ``git archive``); its ``csrc/flash_attention.cu`` and
``csrc/flash_attention_varlen.cu`` are built with the same nvcc flags and
their C entries are called through this checkout's wrappers, whose C
interfaces the two trees share (where the other tree's varlen forward is
not the wgmma kernel, the wrapper's blocks are 64 queries,
``fwd_block_q`` patched, as that kernel takes).  bf16, causal: the fixed-length forward at the trainer's attention
(B 2, S 2048, H 16, Hk 4, D 64) and LLaMA-7B's (B 1, S 2048, H 32, Hk 32,
D 128); the varlen forward at ``chip_smoke.py``'s ``7b`` and
``trainer_d64`` cases (8 packed sequences, 8,192 tokens).  Each is timed
in turns other, this, this, other: ``ms`` is ``chip_smoke.time_ms`` (median
CUDA-event time of 30 calls, the wrapper's small device ops included),
``kernel_ms`` the kernel's own device time from torch.profiler
(``chip_smoke.profiled_kernel_ms``).

Prints one JSON object with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

FIXED = {"trainer": (2, 2048, 16, 4, 64), "7b": (1, 2048, 32, 32, 128)}
VARLEN = ("7b", "trainer_d64")
# the forward kernels of both trees, by family
NAMES = {"fixed": ("flash_fwd_wgmma_kernel", "flash_fwd_mma_kernel"),
         "varlen": ("varlen_fwd_wgmma_kernel", "varlen_fwd_mma_kernel")}


def build_other(other: Path, name: str) -> ctypes.CDLL:
    from paddle_tpu_torch.ops import _build
    csrc = other / "paddle_tpu_torch" / "csrc"
    out = _build.BUILD_DIR / f"ab_other_{name}.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc),
                    "-o", str(out), str(csrc / f"{name}.cu")],
                   check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(out))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True, type=Path)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    import torch
    import chip_smoke as cs
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import flash_attention_varlen as fav
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    libs = {"this": {n: _build.library(n) for n in
                     ("flash_attention", "flash_attention_varlen")},
            "other": {n: build_other(args.other.resolve(), n) for n in
                      ("flash_attention", "flash_attention_varlen")}}
    own_library, own_block = _build.library, fav.fwd_block_q
    other_wgmma = "varlen_fwd_wgmma_kernel" in (
        args.other / "paddle_tpu_torch/csrc/flash_attention_varlen.cu"
    ).read_text()

    def use(tree):
        _build.library = lambda n, t=libs[tree]: t[n]
        fav.fwd_block_q = own_block if tree == "this" or other_wgmma else \
            (lambda q: fav.TILE)

    def turns(fn, names):
        out = []
        for tree in ("other", "this", "this", "other"):
            use(tree)
            out.append({"tree": tree, "ms": cs.time_ms(fn),
                        "kernel_ms": cs.profiled_kernel_ms(fn, names)})
        _build.library, fav.fwd_block_q = own_library, own_block
        return out

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 6)
    res = {"device": cs.nvidia_smi(), "fixed": {}, "varlen": {}}
    for name, shape in FIXED.items():
        c = cs.flash_case(shape, torch.bfloat16, gen)
        q, k, v = c["q"], c["k"], c["v"]
        res["fixed"][name] = {
            "shape": dict(zip(("B", "S", "H", "Hk", "D"), shape)),
            "bound_ms": cs.flash_bound(shape, "bfloat16", "fwd")[0],
            "turns": turns(lambda: fa._launch_fwd(q, k, v, True),
                           NAMES["fixed"])}
        del c, q, k, v
    for name in VARLEN:
        c = cs.varlen_case(name, torch.bfloat16, gen)
        q, k, v = c["q"], c["k"], c["v"]
        a = cs.varlen_args(c)
        res["varlen"][name] = {
            "lens": c["lens_q"], "H": q.shape[1], "D": q.shape[2],
            "bound_ms": cs.varlen_bound(c, "bfloat16", "fwd")[0],
            "turns": turns(lambda: fav._launch_fwd(q, k, v, *a),
                           NAMES["varlen"])}
        del c, q, k, v
    torch.cuda.empty_cache()
    text = json.dumps(res)
    print(text)
    if args.out:
        args.out.write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
