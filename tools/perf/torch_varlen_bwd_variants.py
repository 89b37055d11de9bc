"""The varlen backward pair's block layout on the card: this checkout's
kernels (two warpgroups, 256 threads, no producer warp) against the same
source rewritten to the warp-specialised layout of the other wgmma
kernels (a producer warp filling the ring, `setmaxnreg` 240 / 24, 384
threads).

    python tools/perf/torch_varlen_bwd_variants.py [--out FILE]

Both variants are built from ``paddle_tpu_torch/csrc/flash_attention_varlen
.cu`` with the package's nvcc flags into ``build/`` (the second by a text
rewrite of the first: the ring's release becomes an arrival on an empty
barrier that the producer waits for), and their C entries are called
through this checkout's wrappers, whose interface they share.  Reports
each variant's ptxas lines for the two kernels (registers, spills, C75xx
warnings) and, at the varlen phase's ``7b`` and ``trainer_d64`` cases of
``chip_smoke.py`` (bf16), whether dK, dV and dQ hold the plain versions
at its tolerance, ``time_ms`` and the profiler's kernel-only time of each
launch, in turns kept, producer, producer, kept.

Prints one JSON object with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

SRC = ROOT / "paddle_tpu_torch" / "csrc" / "flash_attention_varlen.cu"
NAMES = {"dkdv": ("varlen_bwd_dkdv_wgmma_kernel",),
         "dq": ("varlen_bwd_dq_wgmma_kernel",)}


def swap(text: str, old: str, new: str, count: int = 1) -> str:
    if text.count(old) != count:
        raise ValueError(f"expected {count} of {old!r} in the source")
    return text.replace(old, new)


def producer_warp(src: str) -> str:
    """The kept source with a producer warp: 384 threads, `setmaxnreg`,
    thread 256 filling every ring stage once all 256 consumer threads
    have arrived on its empty barrier (in the counters' place)."""
    src = swap(src, "constexpr int kBwdThreads = 256;",
               "constexpr int kBwdThreads = 384;")
    body = src[src.index("__device__ __forceinline__ void ring_release("):]
    body = body[:body.index("\n}\n") + 3]
    src = swap(src, body, """__device__ __forceinline__ void ring_release(int* cnt, int i, int n,
                                             int stages, Fill fill) {
  mbar_arrive(reinterpret_cast<uint64_t*>(cnt) + i % stages);
}
""")
    src = swap(src, "      cnt[s] = 0;\n",
               "      mbar_init(reinterpret_cast<uint64_t*>(cnt) + s, 256);\n",
               2)
    for res, fill in (("qdo_full", "vdq_fill"), ("kv_full", "vdkdv_fill")):
        src = swap(src, f"  if (threadIdx.x == 0) {{\n    mbar_expect({res},",
                   f"  if (wg == 2) {{\n    regs_dec<kProducerRegs>();\n"
                   f"    if (threadIdx.x == 256) {{\n    mbar_expect({res},")
        src = swap(
            src,
            f"    for (int i = 0; i < min(L::kStages, c.n); ++i) "
            f"{fill}<D>(c, i);\n  }}\n",
            f"""    for (int i = 0; i < c.n; ++i) {{
      if (i >= L::kStages)
        mbar_wait(reinterpret_cast<uint64_t*>(cnt) + i % L::kStages,
                  (i / L::kStages - 1) & 1);
      {fill}<D>(c, i);
    }}
    }}
    return;
  }}
  regs_inc<kConsumerRegs>();
""")
    return src


VARIANTS = {"kept": lambda s: s, "producer_warp": producer_warp}


def build(name: str, text: str):
    from paddle_tpu_torch.ops import _build
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _build.BUILD_DIR / f"variant_{name}_flash_attention_varlen.cu"
    src.write_text(text)
    out = src.with_suffix(".so")
    return subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(SRC.parent), "-o",
         str(out), str(src)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True), out


def ptxas(log: str) -> list:
    """The two kernels' register, spill and C75xx lines."""
    keep, cur = [], None
    for ln in log.splitlines():
        m = re.search(r"entry function '(\S+)'", ln)
        if m:
            cur = m.group(1)
            continue
        k = re.search(r"(varlen_bwd_\w+?_wgmma_kernelILi\d+)", cur or "")
        if k and ("registers" in ln or "spill" in ln):
            keep.append(f"{k.group(1)}: {ln.strip()}")
        if "C75" in ln and "varlen_bwd" in ln:
            keep.append(re.sub(r".*\((C75\d+)\).*(varlen_bwd_\w+?_kernelILi\d+)"
                               r".*", r"\1 \2", ln.strip()))
    return keep


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    import torch
    import chip_smoke as cs
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import flash_attention_varlen as fav
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    text = SRC.read_text()
    jobs = {n: build(n, f(text)) for n, f in VARIANTS.items()}
    res, libs = {"device": cs.nvidia_smi(), "variants": {}}, {}
    for n, (proc, out) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(log[-4000:], file=sys.stderr)
            return 1
        res["variants"][n] = {"ptxas": ptxas(log)}
        libs[n] = ctypes.CDLL(str(out))
    own = _build.library
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 10)
    for case in ("7b", "trainer_d64"):
        c = cs.varlen_case(case, torch.bfloat16, gen)
        q, k, v, do = c["q"], c["k"], c["v"], c["do"]
        args_ = cs.varlen_args(c)
        out, lse = cs.varlen_plain_fwd(q, k, v, *args_)
        delta = fav.varlen_delta(out, do)
        want = cs.varlen_plain_grads(q, k, v, do, lse, delta, *args_)
        meta = fav._bwd_meta(q, k, c["cu_q"], c["cu_k"], c["causal"])
        fns = {"dkdv": lambda: fav._launch_dkdv(q, k, v, do, lse, delta,
                                                *args_, meta=meta),
               "dq": lambda: fav._launch_dq(q, k, v, do, lse, delta, *args_,
                                            meta=meta)}
        for n in ("kept", "producer_warp", "producer_warp", "kept"):
            _build.library = lambda _name, lib=libs[n]: lib
            dk, dv = fns["dkdv"]()
            got = (fns["dq"](), dk, dv)
            torch.cuda.synchronize()
            errs = [cs.grad_errors(a, b) for a, b in zip(got, want)]
            res["variants"][n].setdefault(case, []).append({
                "held": all(cs.grad_within(e, "bfloat16") for e in errs),
                "ms": {kern: cs.time_ms(f) for kern, f in fns.items()},
                "kernel_ms": {kern: cs.profiled_kernel_ms(f, NAMES[kern])
                              for kern, f in fns.items()}})
        _build.library = own
        del c, q, k, v, do, out, lse, delta, want, got
        torch.cuda.empty_cache()
    text = json.dumps(res)
    print(text)
    if args.out:
        args.out.write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
