"""Validation: replay a recorded ``serve_bench --mixed`` run through
the simulator and report predicted vs actual.

This is the simulator's honesty check, and it is only possible because
the three artifacts it joins are fingerprint-linked:

    bench record        the JSON line serve_bench printed (carries
                        ``workload_fingerprint`` + the measured
                        TTFT/ITL percentiles and tok/s)
    workload dump       ``--dump-workload OUT.json`` (the exact
                        step-indexed stream + engine config, carrying
                        the SAME fingerprint)
    calibration         ``step_timeline.py --fit`` over the run's trace
                        (per-step cost model)

``validate_record`` refuses mismatched fingerprints, replays the dump
through a single model replica with the bench's own warm-then-timed
discipline (warm pass populates the prefix-cache model and is
discarded; the timed pass is measured), and reports relative error per
headline metric.  The speculation scalars are derived from the record
itself via the row-step identity: every decoded token came from either
a plain decode row-step (1 token) or a verify round, so

    plain_row_steps  = new_tokens - spec_emitted_tokens
    row_steps        = plain_row_steps + spec_rounds
    emit_per_rowstep = new_tokens / row_steps
    pack_per_row     = (plain_row_steps + spec_rounds*(k+1)) / row_steps

No fitting freedom hides in those — they are bookkeeping identities on
recorded counters, which is what makes the ±25% acceptance bound a real
test of the MODEL (scheduling + cost), not of curve-fitting slack.
"""
from __future__ import annotations

from .cost import CostModel
from .fleet import ReplicaConfig, SimReplica, _percentile
from .workload import replay_workload

__all__ = ["validate_record", "spec_scalars", "METRICS", "GATED_METRICS"]

#: the headline metrics validation scores, (predicted key, record key)
METRICS = (
    ("ttft_p50_ms", "ttft_p50_ms"),
    ("ttft_p95_ms", "ttft_p95_ms"),
    ("itl_p50_ms", "p50_token_ms"),
    ("tokens_per_s", "value"),
)

#: the subset ``max_abs_rel_err`` (the +-25% acceptance gate) covers.
#: ITL is REPORTED but not gated: the engine stamps ITL samples with
#: its active duration (dispatch + completion block) while the
#: simulator's clock is launch cadence — active_frac calibrates the
#: scale, but how mixed steps slice that duration across phases is
#: workload-shape-dependent in a way percentiles amplify.  TTFT and
#: tok/s are cadence-side quantities the model owns end to end.
GATED_METRICS = ("ttft_p50_ms", "ttft_p95_ms", "tokens_per_s")


def spec_scalars(record: dict) -> tuple:
    """(emit_per_row_step, pack_tokens_per_row) from a mixed record's
    speculation counters; (1.0, 1.0) when the record predates them or
    speculation never engaged."""
    new = float(record.get("new_tokens", 0))
    emitted = float(record.get("spec_emitted_tokens", 0))
    rounds = float(record.get("spec_rounds", 0))
    k = int(record.get("spec_k", 0))
    plain = max(new - emitted, 0.0)
    row_steps = plain + rounds
    if not rounds or not row_steps or not new:
        return 1.0, 1.0
    return (new / row_steps,
            (plain + rounds * (k + 1)) / row_steps)


def replica_config_from_dump(dump: dict, record: dict) -> ReplicaConfig:
    kw = dump["engine_kw"]
    emit, pack = spec_scalars(record)
    return ReplicaConfig(
        max_num_seqs=int(kw["max_num_seqs"]),
        block_size=int(kw["block_size"]),
        max_model_len=int(kw["max_model_len"]),
        max_prefill_tokens=int(kw["max_prefill_tokens"]),
        enable_prefix_caching=True,      # the mixed bench always caches
        spec_emit_per_row_step=emit,
        spec_pack_tokens_per_row=pack,
        # the record names its async-pipeline arm: overlap on commits
        # each launch's tokens under the next dispatch (one step of
        # emission latency), overlap off is synchronous
        pipeline_lag_steps=0 if record.get("overlap") == "off" else 1)


def validate_record(record: dict, dump: dict, calibration) -> dict:
    """Predicted-vs-actual report for one (record, dump, calibration)
    triple.  ``calibration`` is a CostModel, its dict form, or a path.

    Returns ``{"predicted": {...}, "actual": {...}, "rel_err": {...},
    "max_abs_rel_err": float, "workload_fingerprint": ...}``; rel_err
    is signed (predicted/actual - 1) and covers every METRICS pair;
    ``max_abs_rel_err`` is taken over GATED_METRICS only (see the note
    there).  Raises ValueError when record and dump carry different
    fingerprints — a prediction scored against the wrong workload is
    worse than no prediction.
    """
    fp_rec = record.get("workload_fingerprint")
    fp_dump = dump.get("workload_fingerprint")
    if fp_rec and fp_dump and fp_rec != fp_dump:
        raise ValueError(
            f"workload fingerprint mismatch: record {fp_rec!r} vs "
            f"dump {fp_dump!r} — this dump did not produce this record")
    cost = calibration
    if isinstance(cost, str):
        cost = CostModel.from_json(cost)
    elif isinstance(cost, dict):
        cost = CostModel.from_dict(cost)

    reqs = replay_workload(dump)
    rep = SimReplica(replica_config_from_dump(dump, record), cost)
    rep.run_replay(reqs)                 # warm pass: populate the cache
    rep.stats.reset()
    elapsed = rep.run_replay(reqs)       # timed pass, warm cache

    ttft = sorted(rep.stats.ttft_s)
    itl = sorted(rep.stats.itl_s)
    predicted = {
        "ttft_p50_ms": round(1e3 * _percentile(ttft, 50), 3),
        "ttft_p95_ms": round(1e3 * _percentile(ttft, 95), 3),
        "ttft_p99_ms": round(1e3 * _percentile(ttft, 99), 3),
        "itl_p50_ms": round(1e3 * _percentile(itl, 50), 3),
        "itl_p99_ms": round(1e3 * _percentile(itl, 99), 3),
        "tokens_per_s": round(rep.stats.emitted / elapsed, 2)
        if elapsed else 0.0,
        "elapsed_s": round(elapsed, 4),
        "steps": rep.stats.steps,
        "preemptions": rep.stats.preemptions,
    }
    actual, rel = {}, {}
    for pk, rk in METRICS:
        a = record.get(rk)
        if a is None:
            continue
        actual[pk] = a
        rel[pk] = round(predicted[pk] / a - 1.0, 4) if a else 0.0
    return {
        "predicted": predicted,
        "actual": actual,
        "rel_err": rel,
        "max_abs_rel_err": round(max(
            (abs(v) for k, v in rel.items() if k in GATED_METRICS),
            default=0.0), 4),
        "workload_fingerprint": fp_rec or fp_dump,
        "cost_model": cost.to_dict(),
    }
