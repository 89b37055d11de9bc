"""Candidate search: enumerate, measure, pick winners, write the cache
(counterpart of paddle_tpu/tune/search.py).

Two measurers share one search loop:

* ``CostModelMeasurer`` scores candidates in-process with the H100
  roofline model (:mod:`paddle_tpu_torch.tune.cost`) -- the CPU path,
  exercising the whole search/persist/lookup pipeline with no card.
* ``SubprocessMeasurer`` times real launches, one candidate per child
  process: a candidate that fails to build, to launch or to match its
  plain version fails only its child and scores ``inf``, and the sweep
  reports why.  Children may start together; a lock file gives the card
  to one of them at a time.  The child forces the candidate through the normal lookup
  (``PADDLE_TPU_TUNE_FORCE``), so the measured path is the production
  path, holds the output against the kernel's plain version on the same
  inputs, then times it with CUDA events.
"""
from __future__ import annotations

import ast
import json
import math
import os
import subprocess
import sys
import tempfile
import time

from . import cost
from .cache import TuningCache, bucket_signature, device_kind
from .registry import (TunableKernel, all_kernels, candidate_configs,
                       defaults_for)

__all__ = ["CostModelMeasurer", "SubprocessMeasurer", "sweep_kernel",
           "run_sweep", "untuned_launch_report"]

_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class CostModelMeasurer:
    """Rank candidates with the roofline model; no card."""

    kind = "cost-model"
    last_error = None

    def measure(self, kernel: TunableKernel, shape: dict,
                config: dict) -> float:
        return cost.estimate(kernel.name, shape, config)


# Child source for measurement on the card.  It builds a launch of the
# named kernel from the shape key, runs it through the wrapper the engine
# calls (the candidate forced through the normal lookup), holds the output
# against the plain version on the same inputs (the tolerances of
# chip_smoke.py's gates), and prints the median of CUDA-event times as
# JSON.  Off the card the wrappers take their plain versions, so every
# candidate times the same code and the winner degrades to the defaults.
_WORKER = r"""
import json, math, sys, time
spec = json.loads(sys.argv[1])
import torch
torch.backends.cuda.matmul.allow_tf32 = False
dev = "cuda" if torch.cuda.is_available() else "cpu"
gen = torch.Generator(device=dev).manual_seed(0)
TOL = {"float32": {"l2_rel": 1e-5, "max_rel": 1e-4},
       "bfloat16": {"l2_rel": 6e-3, "max_rel": 2e-2}}

def randn(*shape, dtype=torch.float32):
    return torch.randn(shape, generator=gen, device=dev).to(dtype)

def build(name, s):
    dt = torch.bfloat16 if s.get("dtype") == "bfloat16" else torch.float32
    if name == "flash_attention":
        from paddle_tpu_torch.ops import flash_attention as fa
        q, k, v = (randn(1, n, 8, s["head_dim"], dtype=dt)
                   for n in (s["seq_q"], s["seq_k"], s["seq_k"]))
        return (lambda: fa._forward(q, k, v, True)[0],
                lambda: fa.flash_fwd_reference(q, k, v, True)[0], dt)
    if name == "flash_attention_varlen":
        from paddle_tpu_torch.ops import flash_attention_varlen as fav
        tq, tk, d = s["seq_q"], s["seq_k"], s["head_dim"]
        q = randn(tq, 8, d, dtype=dt)
        k, v = randn(tk, 8, d, dtype=dt), randn(tk, 8, d, dtype=dt)
        cu_q = torch.tensor([0, tq // 2, tq], dtype=torch.int32, device=dev)
        cu_k = torch.tensor([0, tk // 2, tk], dtype=torch.int32, device=dev)
        sm = 1.0 / math.sqrt(d)
        return (lambda: fav._forward(q, k, v, cu_q, cu_k, True, sm)[0],
                lambda: fav.varlen_fwd_reference(q, k, v, cu_q, cu_k, True,
                                                 sm)[0], dt)
    if name == "fused_norms":
        from paddle_tpu_torch.ops import fused_norms as fn
        x = randn(s["rows"], s["hidden"], dtype=dt)
        w = (1.0 + 0.1 * randn(s["hidden"])).to(dt)
        return (lambda: fn._rms_forward(x, w, 1e-6),
                lambda: fn.rms_ref(x, w, 1e-6), dt)
    if name == "paged_attention":
        from paddle_tpu_torch.ops import paged_attention as pa
        tq, kvh, d = s["tq"], s["kv_heads"], s["head_dim"]
        page, nblk, R = s["page"], s["nblk"], 4
        q8 = s.get("dtype") == "int8"
        qdt = torch.bfloat16 if (q8 and dev == "cuda") else dt
        kc, vc = (randn(R * nblk, kvh, page, d) for _ in range(2))
        # R rows over distinct pages, and the null row the pads resolve to
        perm = torch.randperm(R * nblk, generator=gen, device=dev) \
            .to(torch.int32)
        bt = torch.cat([perm, perm[:nblk]]).view(R + 1, nblk)
        seg = torch.sort(torch.randint(0, R, (tq,), generator=gen,
                                       device=dev))[0].to(torch.int32)
        rel = torch.randint(0, nblk * page, (tq,), generator=gen,
                            device=dev).to(torch.int32)
        q = randn(tq, kvh, d, dtype=qdt)
        if q8:
            ks = kc.abs().amax((2, 3)) / 127.0
            vs = vc.abs().amax((2, 3)) / 127.0
            kq = torch.round(kc / ks[:, :, None, None]).to(torch.int8)
            vq = torch.round(vc / vs[:, :, None, None]).to(torch.int8)
            return (lambda: pa.ragged_paged_attention_quant_segrel_packed(
                        q, kq, vq, ks, vs, bt, seg, rel),
                    lambda: pa.ragged_paged_reference_quant_segrel(
                        q, kq, vq, ks, vs, bt, seg, rel), qdt)
        kc, vc = kc.to(dt), vc.to(dt)
        return (lambda: pa.ragged_paged_attention_segrel_packed(
                    q, kc, vc, bt, seg, rel),
                lambda: pa.ragged_paged_reference_segrel(
                    q, kc, vc, bt, seg, rel), dt)
    if name == "quant_matmul":
        from paddle_tpu_torch.ops import quant_matmul as qm
        m, k, n = s["m"], s["k"], s["n"]
        wdt = s.get("dtype", "int8")
        x = randn(m, k, dtype=torch.bfloat16 if dev == "cuda"
                  else torch.float32)
        q, sc = qm.quantize_weight(randn(k, n), wdt)
        return (lambda: qm.matmul(x, q, sc, wdt),
                lambda: qm.reference_matmul(x, q, sc, wdt), torch.float32)
    raise SystemExit(f"unknown kernel {name}")

if dev == "cuda":
    torch.zeros(1, device=dev)        # the context, before the card is held
lock = None
if spec.get("lock"):
    # siblings start together; the card's work runs one child at a time
    import fcntl
    lock = open(spec["lock"], "a")
    fcntl.flock(lock, fcntl.LOCK_EX)
run, plain, odt = build(spec["kernel"], spec["shape"])
out, ref = run().float(), plain().float()
d = out - ref
errs = {"l2_rel": float(d.norm() / ref.norm().clamp_min(1e-30)),
        "max_rel": float(d.abs().max() / ref.abs().max().clamp_min(1e-30))}
tol = TOL["bfloat16" if odt == torch.bfloat16 else "float32"]
if not bool(torch.isfinite(out).all()) or any(
        errs[k] > v for k, v in tol.items()):
    print(json.dumps({"error": "output against the plain version",
                      "errors": errs, "tolerance": tol}))
    sys.exit(3)
reps = spec.get("reps", 10)
for _ in range(3):
    run()
times = []
for i in range(spec.get("iters", 5)):
    if dev == "cuda":
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(reps):
            run()
        b.record()
        b.synchronize()
        t = a.elapsed_time(b) / 1e3 / reps
    else:
        t0 = time.perf_counter()
        for _ in range(reps):
            run()
        t = (time.perf_counter() - t0) / reps
    times.append(t)
times.sort()
print(json.dumps({"seconds": times[len(times) // 2]}))
"""


class SubprocessMeasurer:
    """Time one candidate per child process on the card.  With
    ``parallel`` > 1, ``measure_many`` starts up to that many children at
    once: their imports and CUDA contexts overlap, and a lock file lets
    one child at a time build its inputs, check and time its launches, so
    no two measurements share the card.  ``last_error`` holds why the
    last ``measure`` scored ``inf`` (None when it ran)."""

    kind = "wall-clock"

    def __init__(self, timeout: int = 900, iters: int = 5, reps: int = 10,
                 parallel: int = 1):
        self.timeout = timeout
        self.iters = iters
        self.reps = reps
        self.parallel = max(1, int(parallel))
        self.last_error = None

    def measure(self, kernel: TunableKernel, shape: dict,
                config: dict) -> float:
        score, self.last_error = self.measure_many(kernel, shape,
                                                   [config])[0]
        return score

    def _spawn(self, kernel, shape, config, lock, out, err):
        spec = {"kernel": kernel.name, "shape": shape, "iters": self.iters,
                "reps": self.reps, "lock": lock}
        env = dict(os.environ)
        env["PADDLE_TPU_TUNE_FORCE"] = json.dumps({kernel.name: config})
        # the candidate, not a stale cache, must decide geometry
        env.pop("PADDLE_TPU_TUNE_CACHE", None)
        for var in kernel.env_overrides.values():
            env.pop(var, None)
        root = os.path.dirname(_PACKAGE)
        env["PYTHONPATH"] = os.pathsep.join(
            [root] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
        return subprocess.Popen(
            [sys.executable, "-c", _WORKER, json.dumps(spec)], stdout=out,
            stderr=err, env=env, cwd=root)

    @staticmethod
    def _result(code, out: str, err: str):
        lines = out.strip().splitlines()
        if code != 0:
            return math.inf, (lines[-1] if lines else "") + err.strip()[-600:]
        try:
            return float(json.loads(lines[-1])["seconds"]), None
        except Exception as e:
            return math.inf, f"unreadable child output: {e}"

    def measure_many(self, kernel: TunableKernel, shape: dict,
                     configs: list) -> list:
        """[(seconds or inf, error or None)] for each config, in order."""
        results = [None] * len(configs)
        pending = list(enumerate(configs))
        running = []
        with tempfile.TemporaryDirectory() as tmp:
            lock = os.path.join(tmp, "card.lock") if self.parallel > 1 \
                else None
            while pending or running:
                while pending and len(running) < self.parallel:
                    i, cfg = pending.pop(0)
                    out, err = (tempfile.TemporaryFile("w+") for _ in "oe")
                    running.append((i, self._spawn(kernel, shape, cfg, lock,
                                                   out, err),
                                    time.monotonic(), out, err))
                for entry in list(running):
                    i, proc, t0, out, err = entry
                    if proc.poll() is None:
                        if time.monotonic() - t0 <= self.timeout:
                            continue
                        proc.kill()
                        proc.wait()
                        results[i] = (math.inf,
                                      f"timed out after {self.timeout} s")
                    else:
                        out.seek(0)
                        err.seek(0)
                        results[i] = self._result(proc.returncode,
                                                  out.read(), err.read())
                    out.close()
                    err.close()
                    running.remove(entry)
                time.sleep(0.02)
        return results


def sweep_kernel(kernel: TunableKernel, measurer, cache: TuningCache,
                 device: str | None = None, log=None, shapes=None) -> list:
    """Measure every candidate on every sweep shape (``shapes``, default
    the registry's); persist winners.

    Returns report rows: one dict per sweep shape with the winner, the
    default's score, the speedup, and the candidates that failed."""
    device = device or device_kind()
    rows = []
    for shape in kernel.sweep if shapes is None else shapes:
        sig = bucket_signature(shape)
        default = defaults_for(kernel, shape)
        best_cfg, best_s, default_s = None, math.inf, math.inf
        failed = []
        cands = candidate_configs(kernel, shape)
        if hasattr(measurer, "measure_many"):
            scores = measurer.measure_many(kernel, shape, cands)
        else:
            scores = [(measurer.measure(kernel, shape, cfg),
                       getattr(measurer, "last_error", None))
                      for cfg in cands]
        for cfg, (s, error) in zip(cands, scores):
            if cfg == {k: default[k] for k in cfg}:
                default_s = s
            if math.isinf(s):
                failed.append({"config": cfg, "error": error})
            if s < best_s:
                best_cfg, best_s = cfg, s
            if log:
                log(f"  {kernel.name} {sig} {cfg} -> "
                    f"{'inf' if math.isinf(s) else f'{s * 1e6:.2f}us'}")
        if best_cfg is None or math.isinf(best_s):
            rows.append({"kernel": kernel.name, "sig": sig,
                         "error": "no feasible candidate", "failed": failed})
            continue
        cache.put(device, kernel.name, sig, best_cfg,
                  score_s=best_s, measure=measurer.kind)
        rows.append({
            "kernel": kernel.name, "sig": sig, "config": best_cfg,
            "score_s": best_s, "default_s": default_s,
            "speedup": (default_s / best_s
                        if best_s > 0 and not math.isinf(default_s)
                        else None),
            "measure": measurer.kind, "failed": failed,
        })
    return rows


def run_sweep(measurer, cache_file: str, kernels=None,
              device: str | None = None, log=None, shapes=None) -> dict:
    """Sweep (a subset of) the registry, save the cache, return a report.
    ``shapes`` maps a kernel name to the shape keys to sweep in place of
    the registry's."""
    cache = TuningCache(cache_file)
    device = device or device_kind()
    names = set(kernels) if kernels else None
    rows = []
    for kern in all_kernels():
        if names is not None and kern.name not in names:
            continue
        rows.extend(sweep_kernel(kern, measurer, cache, device, log=log,
                                 shapes=(shapes or {}).get(kern.name)))
    path = cache.save()
    return {"device": device, "cache": path, "measure": measurer.kind,
            "entries": len(cache), "results": rows}


_LOOKUPS = {"kernel_config", "kernel_config_with_meta"}


def _called(node) -> set:
    """Names of the functions a function body calls (``f(...)`` and
    ``x.f(...)`` alike)."""
    out = set()
    for n in ast.walk(node):
        if isinstance(n, ast.Call):
            f = n.func
            if isinstance(f, ast.Name):
                out.add(f.id)
            elif isinstance(f, ast.Attribute):
                out.add(f.attr)
    return out


def _resolves_entry(node) -> bool:
    """The body resolves a C entry: ``_build.library(...)``."""
    return any(isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
               and n.func.attr == "library"
               and isinstance(n.func.value, ast.Name)
               and n.func.value.id == "_build" for n in ast.walk(node))


def untuned_launch_report(root: str | None = None) -> list:
    """A row for every function of ``paddle_tpu_torch/ops/*.py`` that
    resolves a CUDA kernel's C entry while no plan from the tuning cache
    reaches it: neither it (through the functions it calls) nor every
    function of its module that calls it consults ``kernel_config``."""
    if root is None:
        root = os.path.dirname(_PACKAGE)
    ops = os.path.join(root, "paddle_tpu_torch", "ops")
    rows = []
    for fname in sorted(os.listdir(ops)):
        if not fname.endswith(".py") or fname == "_build.py":
            continue
        path = os.path.join(ops, fname)
        tree = ast.parse(open(path).read(), path)
        funcs = {n.name: n for n in ast.walk(tree)
                 if isinstance(n, ast.FunctionDef)}
        calls = {k: _called(f) & set(funcs) for k, f in funcs.items()}
        direct = {k for k, f in funcs.items() if _called(f) & _LOOKUPS}

        def looks_up(name, seen=()):
            return name in direct or any(
                looks_up(c, seen + (name,)) for c in calls[name]
                if c not in seen)

        def tuned(name, seen=()):
            if looks_up(name):
                return True
            callers = [k for k, c in calls.items()
                       if name in c and k not in seen and k != name]
            return bool(callers) and all(tuned(k, seen + (name,))
                                         for k in callers)

        for name, f in funcs.items():
            if _resolves_entry(f) and not tuned(name):
                rows.append({
                    "rule": "untuned-cuda-launch",
                    "file": os.path.relpath(path, root), "line": f.lineno,
                    "func": name,
                    "message": "a CUDA kernel launch whose plan does not "
                               "flow from tune.kernel_config"})
    return rows
