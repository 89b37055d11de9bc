"""Kernels on the card: this checkout's against another checkout's, in turns.

    python tools/perf/torch_ab.py FAMILY --other DIR [--set NAME=VALUE ...]
        [--out FILE]

FAMILY is one of ``FAMILIES`` (below): ``paged``, ``varlen_bwd``,
``flash_fwd``, ``flash_bwd`` or ``norms``.  DIR is another tree of this
repository (for example the parent commit, unpacked with ``git
archive``).  Each turn runs in a child process whose ``paddle_tpu_torch`` is one tree's (its
wrappers, metadata and kernels, built from its own ``csrc/`` into its own
``build/``), in the order other, this, this, other; the timing code and the
inputs are this checkout's ``chip_smoke.py``, made from the same seeds in
every turn.  ``--set NAME=VALUE`` (a Python literal; repeatable) sets an
attribute of the family's module in this checkout's turns only, and
clears the module's ``functools`` caches: with ``--other .`` it times one
setting of a host plan's knob against the checkout's own (``norms
--other . --set _WARPS_SM=32``).  For each case and launch a turn reports
``ms``
(``chip_smoke.time_ms``: the median CUDA-event time of 30 calls, the
wrapper's device ops included) and, where the family names the kernels,
``kernel_ms``, the kernels' own device time from torch.profiler
(``chip_smoke.profiled_kernel_ms``).

The families, bf16 unless named:

- ``paged``: the float entry (``ragged_paged_attention_segrel_packed``) at
  chip_smoke's ``decode``, ``mixed`` and ``mixed_gqa`` launches (LLaMA-7B's
  H 32, D 128, bs 16; H_kv 8 for gqa), the int8-page entry at the same
  three, and the decode entry (``paged_decode_attention_packed``) at the
  ``decode`` phase's ``mha`` and ``gqa`` (bs 64), gqa also in float32.
  Also ``host_us``: the host's time a call (checks, plan, allocation, the C
  entry with its tensor maps and the launch), the median and the tenth
  percentile of 1,000 calls, made 200 at a time back to back without a
  synchronisation; ``host_us_busy``, the same behind a spin kernel, so
  that every launch finds the card busy; ``wrapper_us`` and
  ``c_entry_us``, the two parts of a call, each idle and busy
  (``host_split``).  Once a turn, ``host_parts``: the walk's plan
  (``_walk_plan``) computed afresh and from its cache, and one
  ``cuTensorMapEncodeTiled`` of the decode case's K map called through
  ctypes (``encode_ctypes_us``, ctypes' own cost included; the same call
  refused at once for a wrong rank, ``refused_ctypes_us``, is no lower
  bound: it took longer); a tree without the walk reports none of
  them.
- ``varlen_bwd``: ``_launch_dkdv`` and ``_launch_dq`` at the varlen phase's
  ``7b`` and ``trainer_d64`` cases (8 packed causal sequences, 8,192
  tokens; H 32, D 128 and H 16, D 64), and ``bwd_total``: ``_backward``
  whole (delta, metadata, both launches).
- ``flash_fwd``: the fixed-length forward at the trainer's attention (B 2,
  S 2048, H 16, Hk 4, D 64) and LLaMA-7B's (B 1, S 2048, H 32, Hk 32, D
  128), causal, and the varlen forward at the ``7b`` and ``trainer_d64``
  cases.
- ``flash_bwd``: dK/dV, dQ and the whole backward (delta, dK/dV, dQ) at the
  same two fixed-length shapes.
- ``norms``: the fused RMSNorm and LayerNorm entries (``_launch_rms``,
  ``_launch_ln``) at R 8, 616, 2,048 and 2,984 rows of 4,096 (LLaMA-7B's
  decode and prefill steps), bf16 x with bf16 and with f32 weights, and
  f32 x with f32 weights at 2,048; at chip_smoke's ``NORM_COLD`` shapes
  also with x cold in L2 (``rms_l2_cold``, ``ln_l2_cold``: each call takes
  the next of enough copies of x to pass twice the L2).

Prints one JSON object with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FLASH_SHAPES = {"trainer": (2, 2048, 16, 4, 64), "7b": (1, 2048, 32, 32, 128)}
VARLEN_CASES = ("7b", "trainer_d64")


def smoke():
    """This checkout's chip_smoke.py as a module (its functions import the
    port lazily, so they take whichever tree is first on sys.path)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# the families' cases: generators of (case, {launch: thunk}); the inputs of
# a case are freed once the next one is asked for
# ---------------------------------------------------------------------------

def paged_cases(cs):
    import numpy as np
    import torch
    for entry, make, launch in (("float", cs.attention_case, cs.kernel),
                                ("q8", cs.q8_case, cs.kernel_q8)):
        gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
        for kind, Hkv in (("decode", cs.H), ("mixed", cs.H),
                          ("mixed_gqa", cs.H // 4)):
            c = make("decode" if kind == "decode" else "mixed", Hkv,
                     torch.bfloat16, np.random.default_rng(cs.SEED), gen)
            yield f"{entry}_{kind}", {"attention": lambda: launch(c)}
            del c
            torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 9)
    for kind, Hkv, dtype in (("mha", cs.H, torch.bfloat16),
                             ("gqa", cs.H // 4, torch.bfloat16),
                             ("gqa_float32", cs.H // 4, torch.float32)):
        c = cs.decode_case(Hkv, dtype, np.random.default_rng(cs.SEED + 9),
                           gen)
        yield f"decode_{kind}", {"attention": lambda: cs.decode_kernel(c)}
        del c
        torch.cuda.empty_cache()


def varlen_bwd_cases(cs):
    import torch
    from paddle_tpu_torch.ops import flash_attention_varlen as fav
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 10)
    for name in VARLEN_CASES:
        c = cs.varlen_case(name, torch.bfloat16, gen)
        q, k, v, do = c["q"], c["k"], c["v"], c["do"]
        args = cs.varlen_args(c)
        out, lse = cs.varlen_plain_fwd(q, k, v, *args)
        delta = fav.varlen_delta(out, do)
        yield name, {
            "dkdv": lambda: fav._launch_dkdv(q, k, v, do, lse, delta, *args),
            "dq": lambda: fav._launch_dq(q, k, v, do, lse, delta, *args),
            "bwd_total": lambda: fav._backward(q, k, v, out, lse, do,
                                               *args)}
        del c, q, k, v, do, out, lse, delta
        torch.cuda.empty_cache()


def flash_fwd_cases(cs):
    import torch
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import flash_attention_varlen as fav
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 6)
    for name, shape in FLASH_SHAPES.items():
        c = cs.flash_case(shape, torch.bfloat16, gen)
        q, k, v = c["q"], c["k"], c["v"]
        yield f"fixed_{name}", {"fwd": lambda: fa._launch_fwd(q, k, v, True)}
        del c, q, k, v
    for name in VARLEN_CASES:
        c = cs.varlen_case(name, torch.bfloat16, gen)
        q, k, v = c["q"], c["k"], c["v"]
        a = cs.varlen_args(c)
        yield f"varlen_{name}", {"varlen_fwd": lambda: fav._launch_fwd(
            q, k, v, *a)}
        del c, q, k, v
    torch.cuda.empty_cache()


def flash_bwd_cases(cs):
    import torch
    from paddle_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 6)
    for name, shape in FLASH_SHAPES.items():
        c = cs.flash_case(shape, torch.bfloat16, gen)
        q, k, v, do = c["q"], c["k"], c["v"], c["do"]
        out, lse = fa.flash_fwd_reference(q, k, v, True)
        delta = fa.attention_delta(out, do)
        yield name, {
            "dkdv": lambda: fa._launch_dkdv(q, k, v, do, lse, delta, True),
            "dq": lambda: fa._launch_dq(q, k, v, do, lse, delta, True),
            "bwd_total": lambda: fa._backward(q, k, v, out, lse, do, True)}
        del c, q, k, v, do, out, lse, delta
        torch.cuda.empty_cache()


NORM_AB = [(R, "bfloat16", w) for R in (8, 616, 2048, 2984)
           for w in ("bfloat16", "float32")] + [(2048, "float32", "float32")]


def norms_cases(cs):
    import torch
    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 31)
    for R, xn, wn in NORM_AB:
        c = cs.norm_case(R, 4096, dts[xn], dts[wn], gen)
        launches = {}
        for kind in ("rms", "ln"):
            launches[kind] = lambda k=kind: cs.norm_kernel(k, c)
            if (R, 4096) in cs.NORM_COLD:
                nxt = cs.rotating(c["x"].clone,
                                  c["x"].numel() * c["x"].element_size())
                launches[f"{kind}_l2_cold"] = \
                    lambda k=kind, n=nxt: cs.norm_kernel(k, dict(c, x=n()))
        yield f"R{R}_x{xn}_w{wn}", launches
        del c, launches
        torch.cuda.empty_cache()


NORM_KERNELS = ("fused_norm_walk_kernel", "fused_norm_kernel")

# per family: its cases, the module whose file must lie in the turn's tree,
# and each launch's kernel names in either tree (the redesigned kernel and
# the one it replaced; None: no kernel-only time)
FAMILIES = {
    "paged": (paged_cases, "paged_attention", {"attention": (
        "paged_walk_kernel", "ragged_paged_attention_kernel",
        "ragged_paged_attention_q8_kernel")}),
    "varlen_bwd": (varlen_bwd_cases, "flash_attention_varlen", {
        "dkdv": ("varlen_bwd_dkdv_wgmma_kernel", "varlen_bwd_dkdv_mma_kernel"),
        "dq": ("varlen_bwd_dq_wgmma_kernel", "varlen_bwd_dq_mma_kernel"),
        "bwd_total": None}),
    "flash_fwd": (flash_fwd_cases, "flash_attention", {
        "fwd": ("flash_fwd_wgmma_kernel", "flash_fwd_mma_kernel"),
        "varlen_fwd": ("varlen_fwd_wgmma_kernel", "varlen_fwd_mma_kernel")}),
    "flash_bwd": (flash_bwd_cases, "flash_attention", {
        "dkdv": ("flash_bwd_dkdv_wgmma_kernel", "flash_bwd_dkdv_kernel"),
        "dq": ("flash_bwd_dq_wgmma_kernel", "flash_bwd_dq_kernel"),
        "bwd_total": None}),
    "norms": (norms_cases, "fused_norms", {
        launch: NORM_KERNELS for launch in (
            "rms", "ln", "rms_l2_cold", "ln_l2_cold")}),
}


# ---------------------------------------------------------------------------
# host time (paged)
# ---------------------------------------------------------------------------

def host_us(fn, busy=False, rounds=5, n=200) -> dict:
    """Host time a call: ``rounds`` of ``n`` calls back to back, each round
    synchronised before it starts; ``busy``: behind a 50 ms spin kernel
    (``torch.cuda._sleep``), so every launch finds the card busy."""
    import torch
    fn()
    times = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        if busy:
            torch.cuda._sleep(100_000_000)
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    times.sort()
    return {"median": statistics.median(times),
            "p10": times[len(times) // 10]}


class _Lib:
    """Stands in for a kernel library: each entry calls the real one and
    records its function and arguments in ``rec`` or, with ``stub``,
    returns 0 at once."""

    def __init__(self, lib, stub, rec):
        self._lib, self._stub, self._rec = lib, stub, rec

    def __getattr__(self, entry):
        real = getattr(self._lib, entry)

        def call(*args):
            if self._stub:
                return 0
            self._rec[:] = [real, args]
            return real(*args)
        call.argtypes, call.restype = real.argtypes, real.restype
        return call


def host_split(fn, build, name) -> dict:
    """The host time of a call in two parts, the card idle between calls
    and kept busy (``host_us``): ``wrapper_us``, the call with the C entry
    a stub that returns 0 (checks, plan, allocation, the ctypes argument
    list), and ``c_entry_us``, the C entry alone with one real call's
    arguments (tensor maps, launch set-up, the launch)."""
    import torch
    own = build.library
    lib, rec = own(name), []
    try:
        build.library = lambda n: _Lib(lib, False, rec) if n == name \
            else own(n)
        keep = fn()            # its output stays alive while rec's args run
        torch.cuda.synchronize()
        build.library = lambda n: _Lib(lib, True, rec) if n == name \
            else own(n)
        wrapper = {"idle": host_us(fn), "busy": host_us(fn, busy=True)}
    finally:
        build.library = own
    real, args = rec
    res = {"wrapper_us": wrapper, "c_entry_us": {
        "idle": host_us(lambda: real(*args)),
        "busy": host_us(lambda: real(*args), busy=True)}}
    del keep
    return res


def per_call_us(fn, n=2000) -> float:
    """Median host time of one call of fn, in batches of 100."""
    batches = []
    for _ in range(n // 100):
        t0 = time.perf_counter()
        for _ in range(100):
            fn()
        batches.append((time.perf_counter() - t0) * 1e4)
    return statistics.median(batches)


def host_parts(cs, pa) -> dict:
    """The walk's plan, fresh and cached, at the float entry's decode
    launch, and one tensor-map encode as the walk makes it for that
    launch's K cache (bf16 rows of 128, box 64 x 16, 128-byte swizzle);
    none where the tree has no walk."""
    import torch
    plan = getattr(pa, "_walk_plan", None)
    if plan is None:
        return {}
    args = (8, cs.H, cs.H, cs.D, cs.BS, 9, cs.NBLK, torch.bfloat16, False,
            False, 512)
    fresh = getattr(plan, "__wrapped__", plan)
    lib = ctypes.CDLL("libcuda.so.1")
    enc = lib.cuTensorMapEncodeTiled
    enc.restype = ctypes.c_int
    enc.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32] + \
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
    buf = ctypes.create_string_buffer(128 + 64)
    at = (ctypes.addressof(buf) + 63) & ~63
    rows = 1 + 8 * cs.NBLK
    x = torch.empty((rows * cs.H * cs.BS, cs.D), dtype=torch.bfloat16,
                    device="cuda")
    dims = (ctypes.c_uint64 * 2)(cs.D, x.shape[0])
    strides = (ctypes.c_uint64 * 1)(cs.D * 2)
    box = (ctypes.c_uint32 * 2)(64, 16)
    step = (ctypes.c_uint32 * 2)(1, 1)
    # bfloat16 9, no interleave 0, 128-byte swizzle 3, L2 256 B 3, no fill 0

    def encode(rank=2):
        return enc(at, 9, rank, x.data_ptr(), dims, strides, box, step, 0, 3,
                   3, 0)
    assert encode() == 0 and encode(0) != 0
    good, refused = per_call_us(encode), per_call_us(lambda: encode(0))
    return {"plan_fresh_us": per_call_us(lambda: fresh(*args)),
            "plan_cached_us": per_call_us(lambda: plan(*args)),
            "encode_ctypes_us": good, "refused_ctypes_us": refused}


def child(family: str, tree: Path, settings=()) -> dict:
    sys.path.insert(0, str(tree))
    import ast
    import importlib
    cases, module, names = FAMILIES[family]
    mod = importlib.import_module(f"paddle_tpu_torch.ops.{module}")
    build = importlib.import_module("paddle_tpu_torch.ops._build")
    assert Path(mod.__file__).resolve().is_relative_to(tree)
    for item in settings:
        name, _, value = item.partition("=")
        assert hasattr(mod, name), f"{module} has no {name}"
        setattr(mod, name, ast.literal_eval(value))
    for v in vars(mod).values():
        if callable(getattr(v, "cache_clear", None)):
            v.cache_clear()
    cs = smoke()
    res = {}
    for case, fns in cases(cs):
        res[case] = {}
        for launch, fn in fns.items():
            r = {"ms": cs.time_ms(fn)}
            if names[launch]:
                r["kernel_ms"] = cs.profiled_kernel_ms(fn, names[launch])
            if family == "paged":
                r["host_us"] = host_us(fn)
                r["host_us_busy"] = host_us(fn, busy=True)
                r.update(host_split(fn, build, "ragged_paged_attention"))
            res[case][launch] = r
    if family == "paged":
        res["host_parts"] = host_parts(cs, mod)
    return res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("family", choices=list(FAMILIES))
    ap.add_argument("--other", type=Path)
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--set", action="append", default=[],
                    metavar="NAME=VALUE")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.family, args.child.resolve(),
                               args.set)))
        return 0
    if args.other is None:
        ap.error("--other is required")
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    trees = {"this": ROOT, "other": args.other.resolve()}
    res = {"device": smoke().nvidia_smi(), "family": args.family,
           "set_in_this": args.set, "turns": []}
    for tree in ("other", "this", "this", "other"):
        sets = [f"--set={v}" for v in args.set] if tree == "this" else []
        run = subprocess.run([sys.executable, __file__, args.family,
                              "--child", str(trees[tree]), *sets],
                             capture_output=True, text=True, cwd=trees[tree])
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
