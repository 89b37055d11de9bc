"""PyTorch port, fleet simulator (paddle_tpu_torch/sim and
tools/perf/torch_fleet_sim.py) against the JAX package's (paddle_tpu/sim
and tools/perf/fleet_sim.py): tests/test_fleet_sim.py's scenarios run in
process through both packages, with equal results asserted -- event
order, seeded workloads, fleet reports (exact dict equality), the
committed recorded-run triple through both ``validate_record``s, the
pressure semantics and both CLIs' standard output byte for byte.  No
subprocess and no wall clock: the simulator runs on virtual time."""
import contextlib
import dataclasses
import importlib.util
import io
import json
import os

import pytest

import paddle_tpu.sim as jsim
import paddle_tpu_torch.sim as tsim
from paddle_tpu.inference import pressure as jpressure
from paddle_tpu_torch.inference import pressure as tpressure
from _torch_threads import torch_threads  # noqa: F401

_HERE = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(_HERE)
_FIX = os.path.join(_HERE, "fixtures", "sim")
_REC = os.path.join(_FIX, "mixed_record.json")
_DUMP = os.path.join(_FIX, "mixed_workload.json")
_CAL = os.path.join(_FIX, "sim_calibration.json")

PACKAGES = (jsim, tsim)


def _fixture(path):
    with open(path) as f:
        return json.load(f)


def _both(fn):
    """``fn(sim package)`` through the JAX package's and the port's sim;
    asserts the two results equal and returns the port's."""
    ref, out = (fn(pkg) for pkg in PACKAGES)
    assert out == ref
    return out


def _load_tool(name):
    path = os.path.join(_REPO, "tools", "perf", name + ".py")
    spec = importlib.util.spec_from_file_location("_tool_" + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tools():
    return _load_tool("fleet_sim"), _load_tool("torch_fleet_sim")


def _run_main(mod, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = mod.main(list(argv))
    return rc, out.getvalue()


def test_port_imports_no_jax_package():
    """The port's sim names its own policy and pressure modules."""
    from paddle_tpu_torch.sim import fleet, workload
    assert fleet.pick_replica.__module__ == "paddle_tpu_torch.inference.policy"
    assert fleet.DegradationController.__module__ \
        == "paddle_tpu_torch.inference.pressure"
    assert workload.prefix_chain_hashes.__module__ \
        == "paddle_tpu_torch.inference.kv_cache"
    assert tsim.__all__ == jsim.__all__


def test_event_loop_orders_by_virtual_time():
    def run(pkg):
        loop = pkg.EventLoop()
        seen = []
        loop.at(2.0, lambda: seen.append("b"))
        loop.at(1.0, lambda: seen.append("a"))
        loop.after(3.0, lambda: seen.append("c"))
        loop.at(1.0, lambda: seen.append("a2"))     # same time: FIFO
        loop.run(until=2.5)
        mid = (list(seen), loop.pending())
        loop.run()
        return mid, seen, loop.now, loop.events_fired
    assert _both(run) == ((["a", "a2", "b"], 1), ["a", "a2", "b", "c"],
                          3.0, 4)


@pytest.mark.parametrize("profile", ["steady", "bursty", "heavy_tail",
                                     "multi_tenant"])
def test_synthesized_workload_equal_and_seeded(profile):
    def run(pkg, seed=5):
        return [dataclasses.astuple(r) for r in pkg.synthesize_workload(
            64, seed=seed, profile=profile, rate_rps=32.0)]
    a = _both(run)
    assert a == run(tsim)
    assert a != run(tsim, seed=6)
    with pytest.raises(ValueError, match="profile"):
        tsim.synthesize_workload(4, seed=0, profile="nope")


def test_replayed_workload_equal():
    dump = _fixture(_DUMP)
    reqs = _both(lambda pkg: [dataclasses.astuple(r)
                              for r in pkg.replay_workload(dump)])
    assert len(reqs) == len(dump["stream"])


# (workload kwargs, FleetConfig kwargs, ReplicaConfig kwargs)
FLEET_CASES = {
    "bursty_2rep_k4": (dict(n_requests=200, seed=3, profile="bursty",
                            rate_rps=8.0),
                       dict(replicas=2, policy="affinity", seed=3),
                       dict(decode_window=4)),
    "multi_tenant_2000x8": (dict(n_requests=2000, seed=7,
                                 profile="multi_tenant", rate_rps=140.0,
                                 max_model_len=1024, block_size=16),
                            dict(replicas=8, policy="affinity", seed=7),
                            dict(decode_window=4, max_num_seqs=8,
                                 block_size=16, max_model_len=1024,
                                 max_prefill_tokens=256)),
    "least_admission": (dict(n_requests=300, seed=1, profile="heavy_tail",
                             rate_rps=40.0),
                        dict(replicas=3, policy="least", seed=1,
                             admission_ttft_ms=250.0),
                        dict()),
    "random_spill_tier": (dict(n_requests=300, seed=2,
                               profile="multi_tenant", rate_rps=30.0),
                          dict(replicas=2, policy="random", seed=2),
                          dict(num_blocks=48, host_kv_pages=64,
                               spec_emit_per_row_step=1.6,
                               spec_pack_tokens_per_row=3.0)),
}


@pytest.mark.parametrize("case", list(FLEET_CASES))
def test_fleet_report_equal(case):
    wl_kw, fleet_kw, rep_kw = FLEET_CASES[case]

    def run(pkg):
        wl_kw2 = dict(wl_kw)
        n = wl_kw2.pop("n_requests")
        wl = pkg.synthesize_workload(n, **wl_kw2)
        fleet = pkg.SimFleet(pkg.FleetConfig(**fleet_kw),
                             pkg.ReplicaConfig(**rep_kw),
                             pkg.CostModel.default())
        report = fleet.run(wl)
        return report, fleet.loop.events_fired

    report, fired = _both(run)
    assert report["requests"] == wl_kw["n_requests"]
    assert report["finished"] + report["shed"] == report["requests"]
    assert fired > report["requests"]
    if case == "least_admission":
        assert report["shed"] > 0
    if case == "random_spill_tier":
        assert report["kv_spilled_pages"] > 0


def test_committed_recording_validates_equal_within_25pct():
    """The committed triple through both ``validate_record``s: equal
    reports, and the port's within the gated +-25%."""
    record, dump = _fixture(_REC), _fixture(_DUMP)
    cal = _fixture(_CAL)
    rep = _both(lambda pkg: pkg.validate_record(
        record, dump, pkg.CostModel.from_dict(cal)))
    assert rep["workload_fingerprint"] == record["workload_fingerprint"]
    assert rep["max_abs_rel_err"] <= 0.25, rep["rel_err"]
    for key in ("ttft_p50_ms", "ttft_p95_ms", "tokens_per_s",
                "itl_p50_ms"):
        assert key in rep["rel_err"]
    # the path and dict forms of the calibration give the same report
    assert tsim.validate_record(record, dump, _CAL) == rep
    assert tsim.validate_record(record, dump, cal) == rep


def test_validation_rejects_fingerprint_mismatch():
    record = _fixture(_REC)
    dump = _fixture(_DUMP)
    dump["workload_fingerprint"] = "0000000000000000"
    for pkg in PACKAGES:
        with pytest.raises(ValueError, match="fingerprint"):
            pkg.validate_record(record, dump, pkg.CostModel.default())


def test_cost_model_round_trip_equal():
    cal = _fixture(_CAL)

    def run(pkg):
        cost = pkg.CostModel.from_dict(cal)
        rows = sorted(cost.decode_table)
        return (cost.to_dict(),
                [cost.step_cost(t, pure_decode_rows=r)
                 for t in (1, 8, 100) for r in (0, 1, 8)],
                [cost.window_cost(r, k) for r in rows[:3] for k in (1, 4)],
                cost.prefill_tokens_per_s(),
                pkg.CostModel.default().to_dict())
    _both(run)


class _PoolStub:
    def __init__(self, total, free, cached=None):
        self.num_blocks = total + 1          # slot 0 is the null block
        self.num_free = free
        if cached is not None:
            self.num_cached = cached


@pytest.mark.parametrize("mod", [jpressure, tpressure],
                         ids=["jax", "port"])
def test_controller_counts_parked_pages_as_headroom(mod):
    ctrl = mod.DegradationController()
    assert ctrl.update(_PoolStub(100, 10, cached=60)) == mod.NORMAL
    assert mod.DegradationController().update(_PoolStub(100, 10)) \
        == mod.EVICT_PARKED


def test_sim_replica_does_not_deadlock_on_saturated_cache():
    def run(pkg):
        wl = pkg.synthesize_workload(600, seed=11, profile="multi_tenant",
                                     rate_rps=20.0)
        fleet = pkg.SimFleet(pkg.FleetConfig(replicas=2, seed=11),
                             pkg.ReplicaConfig(decode_window=4),
                             pkg.CostModel.default())
        return fleet.run(wl), [r.ctrl.state for r in fleet.replicas]
    report, states = _both(run)
    assert report["finished"] == 600
    assert report["shed"] == 0
    assert all(s < tpressure.ADMIT_PAUSE for s in states)


def test_pipeline_lag_shifts_latency_not_throughput():
    dump = _fixture(_DUMP)
    cal = _fixture(_CAL)

    def run(pkg):
        cost = pkg.CostModel.from_dict(cal)
        kw = dump["engine_kw"]
        outs = {}
        for lag in (0, 1):
            rep = pkg.SimReplica(pkg.ReplicaConfig(
                max_num_seqs=kw["max_num_seqs"],
                block_size=kw["block_size"],
                max_model_len=kw["max_model_len"],
                max_prefill_tokens=kw["max_prefill_tokens"],
                pipeline_lag_steps=lag), cost)
            elapsed = rep.run_replay(pkg.replay_workload(dump))
            outs[lag] = (elapsed, sorted(rep.stats.ttft_s),
                         sorted(rep.stats.itl_s))
        return outs
    outs = _both(run)
    assert outs[0][0] == outs[1][0]                  # same cadence
    assert all(b > a for a, b in zip(outs[0][1], outs[1][1]))


@pytest.mark.parametrize("argv", [
    ("--smoke",),
    ("--requests", "200", "--profile", "steady", "--rate-rps", "20",
     "--policies", "affinity,least", "--replicas", "1,2",
     "--window-k", "1,4"),
    ("--requests", "150", "--profile", "multi_tenant", "--num-blocks", "40",
     "--host-kv-bytes", "0,16777216", "--admission", "none,300"),
    ("--validate", _REC, "--dump", _DUMP, "--calibration", _CAL,
     "--tolerance", "0.25"),
    ("--validate", _REC, "--dump", _DUMP, "--calibration", _CAL,
     "--tolerance", "0.0001"),
], ids=["smoke", "sweep", "spill_admission", "validate", "validate_tight"])
def test_cli_stdout_equal_byte_for_byte(tools, argv):
    ref_tool, port_tool = tools
    rc_ref, out_ref = _run_main(ref_tool, argv)
    rc, out = _run_main(port_tool, argv)
    assert (rc, out) == (rc_ref, out_ref)
    recs = [json.loads(line) for line in out.splitlines()]
    if argv[0] == "--validate":
        assert len(recs) == 1
        rep = recs[0]
        assert rep["metric"] == "sim_validation_max_abs_rel_err"
        assert rep["ok"] is (rc == 0)
        assert rc == (0 if argv[-1] == "0.25" else 1)
    else:
        assert rc == 0
        assert all(r["metric"] == "sim_slo_attainment" for r in recs)
        assert len({r["sim_config_fingerprint"] for r in recs}) == len(recs)
    if argv == ("--smoke",):
        rec = recs[0]
        assert rec["cache_hit_rate"] > 0.2
        assert rec["window_launches"] > 0
        assert rec["finished"] + rec["shed"] == rec["requests"]


# ---------------------------------------------------------------------------
# the port's own recorded run: tools/perf/torch_mixed_bench.py's workload
# (serve_bench's mixed stream, transcribed) -> the tracer -> the stdlib
# step_timeline.py --fit -> validate_record; chip_smoke.py's sim_fit_bf16
# phase runs this chain at LLaMA-7B width on the card
# ---------------------------------------------------------------------------

def _foreign_imports(path):
    import ast
    bad = []
    for node in ast.walk(ast.parse(open(path).read())):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        bad += [n for n in names if n.split(".")[0] in ("jax", "paddle_tpu")]
    return bad


def test_port_tools_import_no_jax():
    import glob
    tools = sorted(glob.glob(os.path.join(_REPO, "tools", "perf",
                                          "torch_*.py")))
    assert any(t.endswith("torch_fleet_sim.py") for t in tools)
    assert any(t.endswith("torch_mixed_bench.py") for t in tools)
    for t in tools:
        assert not _foreign_imports(t), t


@pytest.fixture(scope="module")
def mixed_tools():
    return _load_tool("serve_bench"), _load_tool("torch_mixed_bench")


@pytest.mark.parametrize("smoke,vocab", [(True, 64), (False, 32000)])
def test_mixed_stream_and_fingerprint_equal_serve_bench(mixed_tools, smoke,
                                                        vocab):
    """The transcribed recipe gives serve_bench's stream and fingerprint
    for the same seed and configuration."""
    import numpy as np
    sb, mb = mixed_tools
    stream, engine_kw, spec_k, dump = mb.mixed_workload(32, 0, vocab, smoke)
    ref = sb._mixed_request_stream(np.random.RandomState(0), 32, vocab,
                                   engine_kw["max_model_len"],
                                   engine_kw["max_prefill_tokens"])
    assert stream == ref
    assert dump["stream"] == [[s, p, m] for s, p, m in ref]
    assert dump["workload_fingerprint"] == sb._workload_fingerprint({
        "mode": "mixed", "seed": 0, "requests": 32, "smoke": smoke,
        "kv_dtype": "float32", "weight_dtype": "float32", "tp": 1,
        "engine_kw": engine_kw, "spec_k": spec_k, "vocab": vocab})
    assert (engine_kw["max_num_seqs"], spec_k) == ((8, 3) if smoke
                                                   else (16, 4))
    assert sum(len(p) > engine_kw["max_prefill_tokens"]
               for _, p, _ in stream) == 8


def test_port_mixed_run_fits_and_validates(mixed_tools, tmp_path):
    """A tiny port engine on the CPU serves the mixed stream traced; the
    stdlib fit joins its engine.step and engine.pack spans; both
    packages' validate_record score the triple alike."""
    import math

    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.profiler import Tracer
    _, mb = mixed_tools
    step_timeline = _load_tool("step_timeline")
    cfg = LlamaConfig.tiny(vocab=64, hidden=32, layers=2, heads=4, ffn=64,
                           seq=256)
    model = LlamaForCausalLM(cfg, device="cpu", generator=0)
    tracer = Tracer()
    record, dump, engine = mb.run_mixed(model, 16, 0, True, device="cpu",
                                        tracer=tracer)
    assert record["new_tokens"] == sum(m for _, _, m in dump["stream"])
    assert record["spec_rounds"] > 0 and record["overlap"] == "on"
    trace, cal = str(tmp_path / "trace.json"), str(tmp_path / "cal.json")
    assert tracer.dump(trace) > 0
    rc, out = _run_main(step_timeline, [trace, "--fit", cal, "--json-only"])
    assert rc == 0
    fit = json.loads(out.splitlines()[-1])["fit"]
    cost = tsim.CostModel.from_json(cal)
    assert cost.meta["source"] == "fit"
    assert fit["steps_fit"] == cost.meta["steps_fit"] > 0
    assert cost.meta["steps_fit"] + cost.meta["outlier_steps_dropped"] \
        <= record["engine_steps"]
    rep = _both(lambda pkg: pkg.validate_record(record, dump, cal))
    assert rep["workload_fingerprint"] == dump["workload_fingerprint"]
    for key in ("ttft_p50_ms", "ttft_p95_ms", "itl_p50_ms", "tokens_per_s"):
        v = rep["predicted"][key]
        assert math.isfinite(v) and v > 0, (key, v)
        assert key in rep["rel_err"]
