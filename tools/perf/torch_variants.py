"""Kernel variants on the card: text variants of one CUDA source side by
side, at one family of ``torch_ab.py``'s cases.

    python tools/perf/torch_variants.py SOURCE FAMILY [NAME=EDITS ...]
        [--out FILE]

SOURCE is a file of ``paddle_tpu_torch/csrc/`` (``ragged_paged_attention.cu``
for example) and FAMILY one of ``torch_ab.FAMILIES``, whose cases and
kernel names are used.  EDITS is ``OLD=>NEW`` (several separated by
``;;``: each OLD must occur in the source, and every occurrence is
replaced; there is no ``::`` separator because the sources are full of
``L::k...``) or ``@NAME`` for one of the rewrites in ``REWRITES`` below.
Every variant, and the checkout's own source (the variant ``base``), is
built with ``_build.NVCC_FLAGS`` and the package's headers into
``build/variants/``, all at once, and loaded with ctypes; the wrappers are
pointed at each in turn (the C interface is the same), in the order base,
the variants, the variants reversed, base.  Each turn reports, for each
case and launch, ``ms`` and the profiler's kernel-only ``kernel_ms``
(``chip_smoke.time_ms`` / ``profiled_kernel_ms``) and ``max_abs_diff``,
the largest difference of its outputs from the first base turn's (or the
error of a launch the variant refused); each variant reports ptxas's
register, spill and C75xx lines by kernel.

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
CSRC = ROOT / "paddle_tpu_torch" / "csrc"
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools" / "perf"))


def swap(text: str, old: str, new: str, count: int = 1) -> str:
    if text.count(old) != count:
        raise ValueError(f"expected {count} of {old!r} in the source")
    return text.replace(old, new)


def producer_warp(src: str) -> str:
    """flash_attention_varlen.cu's backward pair with a producer warp: 384
    threads, `setmaxnreg`, thread 256 filling every ring stage once all
    256 consumer threads have arrived on its empty barrier (in the
    counters' place)."""
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


# rewrites too long for the command line, by name
def bulk_store(src: str) -> str:
    """fused_norms.cu's row walk with the output staged in the row's slot
    (each thread overwrites the vectors it read) and stored by one bulk
    copy shared -> global a row, issued by the team's leader, who waits
    for the copy to have read the slot before refilling it (and for every
    copy before the kernel ends), in place of 16-byte stores from
    registers."""
    src = swap(src, """                                      yr + (size_t)i * kVec);
    }

    // the slot is free: refill it with the team's row k + stages
    tm.sync();
    if (leader && k + stages < n_rows) {
      fence_async_smem();
""", """                                      const_cast<XT*>(xs) + (size_t)i * kVec);
    }
    fence_async_smem();
    tm.sync();
    if (leader) {
      asm volatile(
          "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\\n"
          ::"l"(yr), "r"(smem_u32(xs)), "r"(row_bytes) : "memory");
      asm volatile("cp.async.bulk.commit_group;\\n" ::: "memory");
    }
    if (leader && k + stages < n_rows) {
      asm volatile("cp.async.bulk.wait_group.read 0;\\n" ::: "memory");
      fence_async_smem();
""")
    return swap(src, """                x + (row + (size_t)stages * G) * H, row_bytes, full + s);
    }
  }
}
""", """                x + (row + (size_t)stages * G) * H, row_bytes, full + s);
    }
  }
  if (leader) asm volatile("cp.async.bulk.wait_group 0;\\n" ::: "memory");
}
""")


def early_issue(src: str) -> str:
    """fused_norms.cu's row walk with each team's leader initialising its
    own slots' barriers and issuing its first rows' copies before the
    block barrier (thread 0 the vectors' after its rows), in place of
    thread 0 initialising every barrier, a block barrier, then the
    copies."""
    start = src.index("  if (tid == 0) {\n    mbar_init(vbar, 1);")
    end = src.index("  for (int k = 0; k < n_rows; ++k) {\n    const int s")
    return src[:start] + """  if (leader) {
    for (int k = 0; k < stages; ++k) mbar_init(full + k, 1);
    if (tid == 0) mbar_init(vbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\\n" ::: "memory");
    for (int k = 0; k < min(stages, n_rows); ++k) {
      mbar_expect(full + k, row_bytes);
      bulk_copy(ring + (size_t)k * row_bytes,
                x + (size_t)(g + (size_t)k * G) * H, row_bytes, full + k);
    }
    if (kStaged && tid == 0) {
      const uint32_t wb = (uint32_t)H * sizeof(WT);
      const uint32_t bb = kLN ? (uint32_t)H * sizeof(BT) : 0u;
      mbar_expect(vbar, wb + bb);
      bulk_copy((void*)ws, w, wb, vbar);
      if (kLN) bulk_copy((void*)bs, b, bb, vbar);
    }
  }
  __syncthreads();

""" + src[end:]


REWRITES = {"producer_warp": producer_warp, "bulk_store": bulk_store,
            "early_issue": early_issue}


def edited(src: str, edits: str) -> str:
    if edits.startswith("@"):
        return REWRITES[edits[1:]](src)
    for edit in edits.split(";;"):
        old, _, new = edit.partition("=>")
        if old not in src:
            raise SystemExit(f"text not found: {old!r}")
        src = src.replace(old, new)
    return src


def build(name: str, text: str, stem: str):
    from paddle_tpu_torch.ops import _build
    out = ROOT / "build" / "variants"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / f"{name}_{stem}.cu"
    cu.write_text(text)
    so = cu.with_suffix(".so")
    return subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(CSRC), "-o", str(so),
         str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True), so


def kernel_name(mangled: str) -> str:
    """A mangled kernel's name (the length-prefixed identifier ending in
    ``_kernel``) and the start of its template arguments."""
    for m in re.finditer(r"(\d+)[A-Za-z_]", mangled):
        at, n = m.end(1), int(m.group(1))
        if mangled[at:at + n].endswith("_kernel"):
            return mangled[at:at + n + 40]
    return mangled[:72]


def ptxas(log: str) -> list:
    """ptxas's register, spill and C75xx lines, each after its kernel."""
    keep, cur = [], "?"
    for ln in log.splitlines():
        m = re.search(r"(?:entry function|Function properties for) '?(\w+)",
                      ln)
        if m:
            cur = kernel_name(m.group(1))
            continue
        if "registers" in ln or "spill" in ln:
            keep.append(f"{cur}: {ln.strip()}")
        elif "C75" in ln:
            keep.append(ln.strip()[:300])
    return keep


def outputs(x) -> list:
    import torch
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for y in x for t in outputs(y)] if isinstance(
        x, (tuple, list)) else []


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("source")
    ap.add_argument("family")
    ap.add_argument("variants", nargs="*")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import torch_ab
    from paddle_tpu_torch.ops import _build
    cases, _, names = torch_ab.FAMILIES[args.family]
    stem = Path(args.source).stem
    text = (CSRC / args.source).read_text()
    jobs = {"base": build("base", text, stem)}
    for spec in args.variants:
        name, _, edits = spec.partition("=")
        jobs[name] = build(name, edited(text, edits), stem)
    res = {"device": cs.nvidia_smi(), "source": args.source,
           "family": args.family, "ptxas": {}, "turns": {}}
    libs = {}
    for name, (proc, so) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(f"variant {name}: nvcc failed\n{log[-4000:]}",
                  file=sys.stderr)
            return 1
        res["ptxas"][name] = ptxas(log)
        libs[name] = ctypes.CDLL(str(so))
    others = [n for n in libs if n != "base"]
    order = ["base"] + others + others[::-1] + ["base"]
    res["turns"] = [{"variant": n, "cases": {}} for n in order]
    own = _build.library
    try:
        for case, fns in cases(cs):
            base_out = {}
            for turn in res["turns"]:
                lib = libs[turn["variant"]]
                _build.library = lambda n, lib=lib: lib if n == stem \
                    else own(n)
                got = turn["cases"][case] = {}
                for launch, fn in fns.items():
                    try:
                        out = outputs(fn())
                        torch.cuda.synchronize()
                    except RuntimeError as e:     # a variant may not launch
                        got[launch] = {"error": str(e)[:200]}
                        continue
                    want = base_out.setdefault(launch, out)
                    r = {"ms": cs.time_ms(fn), "max_abs_diff": max(
                        (float((a.float() - b.float()).abs().max())
                         for a, b in zip(out, want)), default=0.0)}
                    if names[launch]:
                        r["kernel_ms"] = cs.profiled_kernel_ms(
                            fn, names[launch])
                    got[launch] = r
    finally:
        _build.library = own
    text = json.dumps(res)
    print(text)
    if args.out:
        args.out.write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
