#!/usr/bin/env python
"""Fleet-simulator CLI for the PyTorch port: policy-grid sweeps and replay
validation (counterpart of tools/perf/fleet_sim.py, with the same
arguments and record keys).

Three modes over ``paddle_tpu_torch.sim``:

* **Sweep** (default): run the discrete-event fleet model over a
  synthetic workload for every cell of the policy grid

      router policy x admission threshold x replica count x window K

  and emit ONE JSON record per cell with the simulated SLO attainment
  as its headline ``value`` (``metric: sim_slo_attainment``).  Records
  are bench_history.json-shaped — ``backend: "sim"`` keeps them in
  their own gate group — so a smoke cell can feed the same MAD-banded
  regression gate the real benches use: a scheduling change that
  silently tanks simulated attainment fails CI before it ever reaches
  hardware.

* **--smoke**: one fixed small cell (the CI shape), single record.

* **--validate REC --dump DUMP**: score a recorded ``serve_bench
  --mixed`` run against its simulation (``sim.validate_record``) and
  exit nonzero when the gated relative error exceeds ``--tolerance``.

Everything here is deterministic by construction: the simulator runs
on virtual time with seeded randomness, and the emitted records carry
no wall-clock stamps — rerunning a cell with the same arguments must
produce byte-identical JSON, equal to tools/perf/fleet_sim.py's
(asserted in tests/test_torch_fleet_sim.py).
Wall-clock progress goes to stderr only.

Usage:
  python tools/perf/torch_fleet_sim.py --requests 2000 --profile bursty \\
      --policies affinity,least --replicas 1,2,4 --window-k 1,4
  python tools/perf/torch_fleet_sim.py --smoke | \\
      python tools/perf/bench_history.py append -
  python tools/perf/torch_fleet_sim.py --validate rec.json --dump dump.json \\
      --calibration sim_calibration.json
"""
from __future__ import annotations

import argparse
import hashlib
import itertools
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from paddle_tpu_torch.sim import (CostModel, FleetConfig,            # noqa: E402
                                  ReplicaConfig, SimFleet,
                                  synthesize_workload, validate_record)
from paddle_tpu_torch.sim.workload import PROFILES                   # noqa: E402


def _fingerprint(payload: dict) -> str:
    blob = json.dumps(payload, sort_keys=True, separators=(",", ":"))
    return hashlib.sha1(blob.encode()).hexdigest()[:16]


def _cost_model(path: str | None) -> CostModel:
    return CostModel.from_json(path) if path else CostModel.default()


def _floats_or_none(spec: str) -> list:
    """Parse "none,500,250" -> [None, 500.0, 250.0]."""
    out = []
    for tok in spec.split(","):
        tok = tok.strip().lower()
        out.append(None if tok in ("none", "off", "") else float(tok))
    return out


def run_cell(workload, *, policy: str, admission_ttft_ms, replicas: int,
             window_k: int, host_kv_bytes: int, cost: CostModel,
             args) -> dict:
    # the host spill tier is sized in BYTES at the CLI (matching the
    # engine's --host-kv-bytes) but the simulator tracks pages; the
    # conversion estimate is a knob because the sim carries no model
    # dims of its own
    host_kv_pages = int(host_kv_bytes) // max(int(args.kv_page_bytes), 1)
    rep_cfg = ReplicaConfig(
        max_num_seqs=args.max_num_seqs, block_size=args.block_size,
        max_model_len=args.max_model_len,
        max_prefill_tokens=args.max_prefill_tokens,
        num_blocks=args.num_blocks,
        decode_window=window_k, host_kv_pages=host_kv_pages)
    fleet_cfg = FleetConfig(
        replicas=replicas, policy=policy, seed=args.seed,
        admission_ttft_ms=admission_ttft_ms,
        slo_ttft_ms=args.slo_ttft_ms, slo_itl_ms=args.slo_itl_ms)
    fleet = SimFleet(fleet_cfg, rep_cfg, cost)
    report = fleet.run(workload)
    cell = {
        "metric": "sim_slo_attainment",
        "value": report["slo_attainment"],
        "unit": "frac",
        "backend": "sim",
        "tp": 1,
        "replicas": replicas,
        "policy": policy,
        "admission_ttft_ms": admission_ttft_ms,
        "decode_window_k": window_k,
        "host_kv_bytes": int(host_kv_bytes),
        "host_kv_pages": host_kv_pages,
        "profile": args.profile,
        "n_requests": args.requests,
        "seed": args.seed,
        "rate_rps": args.rate_rps,
        "slo_ttft_ms": args.slo_ttft_ms,
        "slo_itl_ms": args.slo_itl_ms,
        "cost_source": cost.meta.get("source", "default"),
    }
    cell["sim_config_fingerprint"] = _fingerprint(
        {k: cell[k] for k in ("replicas", "policy", "admission_ttft_ms",
                              "decode_window_k", "host_kv_pages",
                              "profile", "n_requests", "seed",
                              "rate_rps")})
    cell.update(report)
    return cell


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python tools/perf/torch_fleet_sim.py",
        description="Discrete-event fleet simulator: policy-grid sweep "
                    "and recorded-run validation.")
    # grid axes (comma lists)
    ap.add_argument("--policies", default="affinity,least",
                    help="router policies to sweep (affinity,least,random)")
    ap.add_argument("--admission", default="none",
                    help="admission TTFT thresholds in ms; 'none' = no shed "
                         "(e.g. 'none,500,250')")
    ap.add_argument("--replicas", default="1",
                    help="replica counts to sweep (e.g. '1,2,4,8')")
    ap.add_argument("--window-k", default="1",
                    help="decode-window K values to sweep (e.g. '1,4,8')")
    ap.add_argument("--host-kv-bytes", default="0",
                    help="host KV spill-tier capacities in bytes to sweep "
                         "(e.g. '0,268435456'); 0 = no tier.  Bytes are "
                         "converted to simulator pages via "
                         "--kv-page-bytes, mirroring the engine's "
                         "--host-kv-bytes knob")
    # workload
    ap.add_argument("--requests", type=int, default=2000)
    ap.add_argument("--profile", default="bursty", choices=PROFILES)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rate-rps", type=float, default=64.0)
    ap.add_argument("--mean-prompt", type=int, default=96)
    ap.add_argument("--mean-new", type=int, default=48)
    ap.add_argument("--tenants", type=int, default=4,
                    help="multi_tenant profile: distinct shared prefixes")
    ap.add_argument("--prefix-pages", type=int, default=4,
                    help="multi_tenant profile: shared prefix depth, pages")
    ap.add_argument("--prefix-share", type=float, default=0.7,
                    help="multi_tenant profile: P(request opens with its "
                         "tenant prefix)")
    # replica shape
    ap.add_argument("--max-num-seqs", type=int, default=8)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--max-model-len", type=int, default=1024)
    ap.add_argument("--max-prefill-tokens", type=int, default=256)
    ap.add_argument("--num-blocks", type=int, default=None,
                    help="HBM KV pool size in pages (default: the "
                         "engine's derived sizing).  Shrink it to put "
                         "the pool under pressure — the regime where a "
                         "--host-kv-bytes sweep is informative")
    ap.add_argument("--kv-page-bytes", type=int, default=1 << 18,
                    help="estimated bytes of ONE KV page on the real "
                         "model, used only to convert --host-kv-bytes "
                         "to simulator pages (2 * layers * kv_heads * "
                         "head_dim * block_size * dtype_bytes)")
    # scoring
    ap.add_argument("--slo-ttft-ms", type=float, default=500.0)
    ap.add_argument("--slo-itl-ms", type=float, default=100.0)
    ap.add_argument("--calibration", default=None,
                    help="sim_calibration.json from step_timeline.py --fit "
                         "(default: the built-in coarse model)")
    ap.add_argument("--out", default=None,
                    help="write JSONL records here instead of stdout")
    ap.add_argument("--smoke", action="store_true",
                    help="one fixed small cell, bench-history shaped")
    # validation mode
    ap.add_argument("--validate", default=None, metavar="RECORD.json",
                    help="score this serve_bench --mixed record against "
                         "its simulation (needs --dump)")
    ap.add_argument("--dump", default=None, metavar="DUMP.json",
                    help="the --dump-workload capture joined to --validate")
    ap.add_argument("--tolerance", type=float, default=0.25,
                    help="validate: max gated |rel err| before exit 1")
    args = ap.parse_args(argv)

    if args.validate:
        if not args.dump:
            ap.error("--validate needs --dump")
        with open(args.validate) as f:
            record = json.load(f)
        with open(args.dump) as f:
            dump = json.load(f)
        rep = validate_record(record, dump, _cost_model(args.calibration))
        rep["metric"] = "sim_validation_max_abs_rel_err"
        rep["value"] = rep["max_abs_rel_err"]
        rep["tolerance"] = args.tolerance
        rep["ok"] = rep["max_abs_rel_err"] <= args.tolerance
        print(json.dumps(rep))
        return 0 if rep["ok"] else 1

    if args.smoke:
        # the CI cell: small, multi-tenant, two replicas, window on —
        # touches router affinity, prefix-cache hits (~40% hit rate)
        # and the decode window in one deterministic run.  34 rps sits
        # just under the knee: TTFT p95 lands ~70% of the SLO bound,
        # so a scheduling regression moves attainment and the watched
        # tail percentiles instead of saturating at 1.0
        args.requests = 400
        args.profile = "multi_tenant"
        args.rate_rps = 34.0
        policies = ["affinity"]
        admissions = [None]
        replica_counts = [2]
        ks = [4]
        host_kv = [0]
    else:
        policies = [p.strip() for p in args.policies.split(",") if p.strip()]
        admissions = _floats_or_none(args.admission)
        replica_counts = [int(r) for r in args.replicas.split(",")]
        ks = [int(k) for k in args.window_k.split(",")]
        host_kv = [int(b) for b in args.host_kv_bytes.split(",")]

    cost = _cost_model(args.calibration)
    workload = synthesize_workload(
        args.requests, seed=args.seed, profile=args.profile,
        rate_rps=args.rate_rps, mean_prompt=args.mean_prompt,
        mean_new=args.mean_new, max_model_len=args.max_model_len,
        block_size=args.block_size, tenants=args.tenants,
        prefix_pages=args.prefix_pages, prefix_share=args.prefix_share)

    sink = open(args.out, "w") if args.out else sys.stdout
    t0 = time.perf_counter()
    cells = 0
    try:
        for policy, adm, n_rep, k, hkv in itertools.product(
                policies, admissions, replica_counts, ks, host_kv):
            cell = run_cell(workload, policy=policy, admission_ttft_ms=adm,
                            replicas=n_rep, window_k=k,
                            host_kv_bytes=hkv, cost=cost, args=args)
            sink.write(json.dumps(cell) + "\n")
            cells += 1
            spill = (f" spill={cell['kv_spilled_pages']}/"
                     f"{cell['kv_restored_pages']} "
                     f"hit={cell['spill_tier_hit_rate']:.3f}"
                     if cell["host_kv_pages"] else "")
            print(f"[torch_fleet_sim] {policy} adm={adm} replicas={n_rep} "
                  f"K={k} hostkv={hkv}: attainment={cell['value']:.4f} "
                  f"shed={cell['shed']} "
                  f"ttft_p95={cell['ttft_p95_ms']:.1f}ms{spill}",
                  file=sys.stderr)
    finally:
        if args.out:
            sink.close()
    print(f"[torch_fleet_sim] {cells} cell(s) in "
          f"{time.perf_counter() - t0:.2f}s wall", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
