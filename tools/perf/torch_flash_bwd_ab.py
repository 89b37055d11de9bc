"""Flash attention backward on the card: this checkout's kernels against
another checkout's, and the GQA group sum done in the block against
per-head partials.

    python tools/perf/torch_flash_bwd_ab.py --other DIR [--out FILE]

DIR is another tree of this repository (for example the parent commit,
unpacked with ``git archive``); its ``csrc/flash_attention.cu`` is built
with the same nvcc flags and its C entries are called through this
checkout's wrappers (``paddle_tpu_torch.ops.flash_attention``), whose C
interface the two trees share.  At the trainer's attention (B 2, S 2048,
H 16, Hk 4, D 64) and LLaMA-7B's (B 1, S 2048, H 32, Hk 32, D 128), bf16,
causal, it times dK/dV, dQ and the whole backward (delta, dK/dV, dQ) in
turns other, this, this, other (``chip_smoke.time_ms``: median CUDA-event
time of 30 calls).

The group-sum comparison, at the trainer's shape on this checkout: the
dK/dV kernel as run (the group's heads summed inside each block) against
what per-head partials would cost at least, which is the same kernel on
the per-head grid (Hk = H, one block per query head and key tile, the
JAX package's grid) plus the fixed-order f32 sum of the G partials of dK
and dV (``x.view(B, S, Hk, G, D).sum(3)`` and the cast, timed apart).  The
bound is low by the partials' extra f32 write, 16.8 MB at this shape.

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

SHAPES = {"trainer": (2, 2048, 16, 4, 64), "7b": (1, 2048, 32, 32, 128)}


def build_other(other: Path) -> ctypes.CDLL:
    from paddle_tpu_torch.ops import _build
    csrc = other / "paddle_tpu_torch" / "csrc"
    out = _build.BUILD_DIR / "ab_other_flash_attention.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc),
                    "-o", str(out), str(csrc / "flash_attention.cu")],
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
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    libs = {"this": _build.library("flash_attention"),
            "other": build_other(args.other.resolve())}
    own = _build.library
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 6)
    res = {"device": cs.nvidia_smi(), "shapes": {}}
    for name, shape in SHAPES.items():
        c = cs.flash_case(shape, torch.bfloat16, gen)
        q, k, v, do = c["q"], c["k"], c["v"], c["do"]
        out, lse = fa.flash_fwd_reference(q, k, v, True)
        delta = fa.attention_delta(out, do)
        fns = {"dkdv": lambda: fa._launch_dkdv(q, k, v, do, lse, delta, True),
               "dq": lambda: fa._launch_dq(q, k, v, do, lse, delta, True),
               "bwd_total": lambda: fa._backward(q, k, v, out, lse, do,
                                                 True)}
        turns = []
        for tree in ("other", "this", "this", "other"):
            _build.library = lambda _n, lib=libs[tree]: lib
            turns.append({"tree": tree, **{k_: cs.time_ms(f)
                                            for k_, f in fns.items()}})
        _build.library = own
        res["shapes"][name] = {"shape": dict(zip(("B", "S", "H", "Hk", "D"),
                                                 shape)), "turns": turns}
        del c, q, k, v, do, out, lse, delta
        torch.cuda.empty_cache()

    # the group sum: in the block (as run) against per-head partials
    B, S, H, Hk, D = SHAPES["trainer"]
    G = H // Hk
    c = cs.flash_case((B, S, H, H, D), torch.bfloat16, gen)
    q, k, v, do = c["q"], c["k"], c["v"], c["do"]
    out, lse = fa.flash_fwd_reference(q, k, v, True)
    delta = fa.attention_delta(out, do)
    kg, vg = k[:, :, ::G].contiguous(), v[:, :, ::G].contiguous()
    part = torch.randn((B, S, H, D), device="cuda", generator=gen)
    in_block = cs.time_ms(lambda: fa._launch_dkdv(q, kg, vg, do, lse, delta,
                                                  True))
    per_head = cs.time_ms(lambda: fa._launch_dkdv(q, k, v, do, lse, delta,
                                                  True))
    group_sum = cs.time_ms(lambda: [part.view(B, S, Hk, G, D).sum(3).to(
        torch.bfloat16) for _ in range(2)])
    res["gqa_sum"] = {"in_block_ms": in_block,
                      "partials_kernel_ms": per_head,
                      "partials_group_sum_ms": group_sum,
                      "partials_at_least_ms": per_head + group_sum}
    text = json.dumps(res)
    print(text)
    if args.out:
        args.out.write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
