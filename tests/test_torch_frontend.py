"""PyTorch port, the serving frontend on the CPU: the EngineRunner, the
replica router, the HTTP app and the CLI's engine builder, held against
the port's own engine and the JAX package's frontend
(tests/test_frontend.py, test_router.py, test_slo.py and test_trace.py's
frontend cases).

- Runner: submit, stream and drain; saturation and abort; a deadline
  already past when submitted; supervised recovery from an injected step
  crash with byte-identical streams.
- HTTP: the SSE stream equals the unary response and the engine's direct
  output, speculation off and on; 429 when saturated and 503 while
  draining; /healthz, /slo, /debug/requests and /debug/trace (404
  without a tracer); the /metrics names and label names equal the JAX
  frontend's over the JAX engine.
- Router: the replica chosen for each request of one sequence equals the
  JAX router's under ``affinity``, ``least`` and a seeded ``random``.
- CLI: ``_build_engine`` maps every flag; ``--host-kv-bytes`` gives each
  engine a HostSpillPool.
Every socket has a timeout and every wait a bound."""
import http.client
import json
import queue
import re
import threading

import jax
import numpy as np
import pytest

from paddle_tpu.core import random_state
from paddle_tpu.inference import LLMEngine as JaxEngine
from paddle_tpu.inference.frontend import ReplicaRouter as JaxRouter
from paddle_tpu.inference.frontend import build_replicas as jax_replicas
from paddle_tpu.inference.frontend import serve_background as jax_serve
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxModel
from paddle_tpu.profiler import Tracer as JaxTracer
from paddle_tpu_torch.inference import FaultPlan, HostSpillPool, LLMEngine
from paddle_tpu_torch.inference.frontend import (EngineRunner, ReplicaRouter,
                                                 RunnerDraining,
                                                 RunnerSaturated,
                                                 build_replicas,
                                                 serve_background)
from paddle_tpu_torch.inference.frontend.__main__ import _build_engine
from paddle_tpu_torch.models.llama import (LlamaConfig,
                                           from_jax_decode_params)
from paddle_tpu_torch.profiler import Tracer
from _torch_threads import torch_threads  # noqa: F401

VOCAB = 97
CFG = JaxConfig.tiny(vocab=VOCAB, hidden=32, layers=2, heads=4, ffn=64,
                     seq=64)
TIMEOUT = 120.0                  # every socket and every wait


class Pair:
    """One JAX model and its weights carried into the port."""

    def __init__(self, jcfg):
        self.jm = JaxModel(jcfg)
        params = jax.tree.map(np.asarray, self.jm.decode_params())
        cfg = LlamaConfig(**{k: getattr(jcfg, k)
                             for k in LlamaConfig.__dataclass_fields__})
        self.tm = from_jax_decode_params(cfg, params, device="cpu")


@pytest.fixture(scope="module")
def pair():
    saved = dict(random_state._state)
    random_state.seed(0)
    try:
        return Pair(CFG)
    finally:
        random_state._state.update(saved)


def _kw(**kw):
    kw.setdefault("max_num_seqs", 4)
    kw.setdefault("block_size", 8)
    kw.setdefault("max_model_len", 64)
    kw.setdefault("max_prefill_tokens", 128)
    kw.setdefault("prefill_token_bucket", 32)
    kw.setdefault("retain_outputs", False)
    return kw


def _engine(pair, **kw):
    return LLMEngine(pair.tm, device="cpu", **_kw(**kw))


def _direct(pair, prompts, **kw):
    """The engine's own output for each (prompt, max_new, temperature)."""
    eng = _engine(pair, retain_outputs=True, **kw)
    rids = [eng.add_request(p, max_new_tokens=mx, temperature=t, seed=i)
            for i, (p, mx, t) in enumerate(prompts)]
    outs = eng.run()
    return [outs[r].generated for r in rids]


def _prompts(n, seed=3, sampled=False):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, VOCAB, [4, 9, 13, 21][i % 4]).tolist(),
             int(rng.randint(4, 12)), 0.8 if sampled and i % 2 else 0.0)
            for i in range(n)]


def _collect(q):
    toks = []
    while True:
        kind, val = q.get(timeout=TIMEOUT)
        if kind == "finish":
            return toks, val
        toks.append(val)


def _post(port, obj, path="/v1/completions"):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    conn.request("POST", path, body=json.dumps(obj).encode(),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    body = resp.read()
    conn.close()
    return resp.status, (json.loads(body) if body else None)


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    conn.request("GET", path)
    resp = conn.getresponse()
    status, body = resp.status, resp.read()
    conn.close()
    return status, body


def _stream(port, obj):
    """One streaming completion; returns (status, tokens, finish)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    conn.request("POST", "/v1/completions",
                 body=json.dumps(dict(obj, stream=True)).encode(),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    if resp.status != 200:
        body = resp.read()
        conn.close()
        return resp.status, [], json.loads(body)
    toks, finish, buf, done = [], None, b"", False
    while not done:
        chunk = resp.read(64)
        if not chunk:
            break
        buf += chunk
        while b"\n\n" in buf:
            frame, buf = buf.split(b"\n\n", 1)
            data = frame.partition(b"data: ")[2].decode()
            if data == "[DONE]":
                done = True
                continue
            ch = json.loads(data)["choices"][0]
            if ch["finish_reason"] is None:
                toks.append(ch["token"])
            else:
                finish = ch["finish_reason"]
    conn.close()
    return 200, toks, finish


# ---------------------------------------------------------------------------
# the runner
# ---------------------------------------------------------------------------

def test_runner_submit_stream_and_drain(pair):
    prompts = _prompts(6)
    want = _direct(pair, prompts)
    eng = _engine(pair)
    runner = EngineRunner(eng).start()
    qs = []
    for p, mx, t in prompts:
        q = queue.Queue()
        runner.submit(p, deliver=q.put_nowait, max_new_tokens=mx)
        qs.append(q)
    for q, w in zip(qs, want):
        toks, out = _collect(q)
        assert toks == out.generated == w
    assert runner.drain(timeout_s=TIMEOUT)
    assert eng.blocks.num_used == 0
    with pytest.raises(RunnerDraining):
        runner.submit([1, 2], deliver=lambda ev: None)


def test_runner_saturation_abort_and_past_deadline(pair):
    eng = _engine(pair)
    runner = EngineRunner(eng, max_pending=3).start()
    q1, q2, q3 = queue.Queue(), queue.Queue(), queue.Queue()
    r1 = runner.submit([1, 2, 3], deliver=q1.put_nowait, max_new_tokens=40)
    runner.submit([4, 5, 6], deliver=q2.put_nowait, max_new_tokens=40)
    runner.submit([5, 6, 7], deliver=q3.put_nowait, max_new_tokens=4,
                  deadline_s=-1.0)             # already past
    with pytest.raises(RunnerSaturated):
        runner.submit([7, 8], deliver=lambda ev: None)
    runner.abort(r1, reason="aborted")
    toks1, out1 = _collect(q1)
    assert out1.finish_reason == "aborted" and toks1 == out1.generated
    toks3, out3 = _collect(q3)
    assert out3.finish_reason == "deadline"
    assert _collect(q2)[1].finish_reason == "length"
    assert runner.drain(timeout_s=TIMEOUT)
    assert eng.blocks.num_used == 0
    assert eng.stats.abort_reasons == {"aborted": 1, "deadline": 1}


@pytest.mark.parametrize("crash", ["step", "inflight"])
def test_supervised_recovery_streams_byte_identical(pair, crash):
    """An injected step crash under the runner with an engine factory: the
    engine is rebuilt (the dead one closed), every stream is replayed from
    its journal, and each equals the engine's own fault-free output,
    sampled rows included."""
    prompts = _prompts(8, seed=5, sampled=True)
    want = _direct(pair, prompts)
    plan = FaultPlan(seed=1, **({"crash_steps": (4,)} if crash == "step"
                                else {"inflight_crash_steps": (4,)}))

    def factory():
        return _engine(pair)

    eng = factory()
    eng.set_fault_plan(plan)
    runner = EngineRunner(eng, engine_factory=factory).start()
    qs = []
    for i, (p, mx, t) in enumerate(prompts):
        q = queue.Queue()
        runner.submit(p, deliver=q.put_nowait, max_new_tokens=mx,
                      temperature=t, seed=i)
        qs.append(q)
    streams = [_collect(q) for q in qs]
    assert runner.drain(timeout_s=TIMEOUT)
    assert runner.restarts == 1 and runner.engine is not eng
    assert eng._kc is None                     # the dead engine was closed
    for (toks, out), w in zip(streams, want):
        assert toks == out.generated == w
    assert runner.engine.blocks.num_used == 0


# ---------------------------------------------------------------------------
# HTTP
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [False, True], ids=["spec_off", "spec_on"])
def test_http_stream_equals_unary_and_engine(pair, spec):
    kw = {"drafter": "ngram", "spec_k": 4} if spec else {}
    rng = np.random.RandomState(5)
    prompts = []
    for i in range(8):
        motif = rng.randint(0, VOCAB, 3).tolist()
        prompts.append(((motif * 8)[:[6, 9, 12, 15][i % 4]],
                        int(rng.randint(4, 12)), 0.8 if i % 3 == 2 else 0.0))
    want = _direct(pair, prompts, **kw)
    eng = _engine(pair, **kw)
    srv = serve_background(eng, model_name="tiny")
    try:
        results = [None] * len(prompts)

        def one(i):
            p, mx, t = prompts[i]
            results[i] = _stream(srv.port, {"prompt": p, "max_tokens": mx,
                                            "temperature": t, "seed": i})

        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(len(prompts))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(TIMEOUT)
            assert not th.is_alive()
        for (status, toks, finish), w in zip(results, want):
            assert status == 200 and finish == "length"
            assert toks == w
        p, mx, t = prompts[0]
        status, body = _post(srv.port, {"prompt": p, "max_tokens": mx})
        assert status == 200
        assert body["choices"][0]["token_ids"] == results[0][1]
        assert body["usage"]["completion_tokens"] == mx
    finally:
        assert srv.stop()
    if spec:
        assert eng.stats.draft_proposed > 0
    assert eng.blocks.num_used == 0


def test_http_429_when_saturated_and_503_while_draining(pair):
    eng = _engine(pair, max_num_seqs=2)
    srv = serve_background(eng, model_name="tiny", max_pending=2)
    conns = []
    try:
        for _ in range(2):
            conn = http.client.HTTPConnection("127.0.0.1", srv.port,
                                              timeout=TIMEOUT)
            conn.request("POST", "/v1/completions",
                         body=json.dumps({"prompt": [1, 2, 3],
                                          "max_tokens": 50,
                                          "stream": True}).encode(),
                         headers={"Content-Type": "application/json"})
            assert conn.getresponse().status == 200
            conns.append(conn)
        status, body = _post(srv.port, {"prompt": [9, 9], "max_tokens": 4})
        assert status == 429 and body["error"]["type"] == "overloaded"
        srv.frontend.runner._draining = True   # the drain's admission gate
        status, body = _post(srv.port, {"prompt": [9, 9], "max_tokens": 4})
        assert status == 503
    finally:
        for conn in conns:
            conn.close()
        srv.frontend.runner._draining = False
        assert srv.stop()
    assert eng.blocks.num_used == 0


def test_http_observability_routes(pair):
    eng = _engine(pair)
    tr = Tracer()
    srv = serve_background(eng, model_name="tiny", tracer=tr,
                           slo_config={"ttft_p95_ms": 250.0},
                           flight_capacity=32)
    try:
        status, body = _get(srv.port, "/healthz")
        assert status == 200 and json.loads(body)["status"] == "ok"
        ids = []
        for i in range(2):
            status, body = _post(srv.port, {"prompt": list(range(4 + i)),
                                            "max_tokens": 4})
            assert status == 200
            ids.append(body["id"])
        status, raw = _get(srv.port, "/slo")
        doc = json.loads(raw)
        assert status == 200 and doc["slo"]["config"]["ttft_p95_ms"] == 250.0
        assert doc["windows"]["60s"]["ttft"]["count"] >= 2
        status, raw = _get(srv.port, "/debug/requests?finished=true")
        listing = json.loads(raw)
        assert status == 200
        assert set(ids) <= {r["request_id"] for r in listing["requests"]}
        status, raw = _get(srv.port, f"/debug/requests/{ids[0]}")
        assert status == 200 and json.loads(raw)["generated_tokens"] == 4
        status, raw = _get(srv.port, "/debug/trace")
        assert status == 200
        names = {e["name"] for e in json.loads(raw)["traceEvents"]}
        assert {"engine.step", "engine.device_launch", "runner.deliver",
                "http.request"} <= names
    finally:
        assert srv.stop()
    bare = serve_background(_engine(pair), model_name="tiny",
                            flight_capacity=0)
    try:
        assert _get(bare.port, "/debug/trace")[0] == 404
        assert _get(bare.port, "/debug/requests")[0] == 404
    finally:
        assert bare.stop()


_SAMPLE = re.compile(r"^([a-z_]+)(?:\{([^}]*)\})? ")


def _metric_shapes(text):
    """{(metric name, label names)} of every sample line."""
    out = set()
    for line in text.splitlines():
        m = _SAMPLE.match(line)
        if m:
            labels = tuple(sorted(kv.split("=")[0] for kv in
                                  (m.group(2) or "").split(",") if kv))
            out.add((m.group(1), labels))
    return out


def test_metrics_names_equal_reference(pair):
    """The port's /metrics over its engine carries the JAX frontend's
    metric names and label names over the JAX engine, with two replicas,
    a tracer, the flight recorder and a host tier on both."""
    def scrape(serve, engine_cls, model, tier_cls, tracer, extra):
        def factory():
            return engine_cls(model, kv_tier=tier_cls(1 << 20),
                              **_kw(), **extra)
        srv = serve(factory(), model_name="tiny", engine_factory=factory,
                    replicas=2, tracer=tracer, flight_capacity=16)
        try:
            assert _post(srv.port, {"prompt": [3, 1, 4, 1, 5],
                                    "max_tokens": 3})[0] == 200
            status, raw = _get(srv.port, "/metrics")
            assert status == 200
            return _metric_shapes(raw.decode())
        finally:
            assert srv.stop()

    from paddle_tpu.inference.kv_tier import HostSpillPool as JaxPool
    ours = scrape(serve_background, LLMEngine, pair.tm, HostSpillPool,
                  Tracer(), {"device": "cpu"})
    ref = scrape(jax_serve, JaxEngine, pair.jm, JaxPool, JaxTracer(), {})
    assert ours == ref
    assert len(ours) > 40


# ---------------------------------------------------------------------------
# the router
# ---------------------------------------------------------------------------

def _routes(router, prompts):
    """The replica index each prompt lands on, submitted in order (the
    runners are not started: only the router's own state moves)."""
    out = [int(router.submit(p, deliver=lambda ev: None,
                             max_new_tokens=mx).split("-", 1)[0][1:])
           for p, mx, _ in prompts]
    for r in router.runners:
        r.drain(timeout_s=0.0)
    return out


@pytest.mark.parametrize("policy", ["affinity", "least", "random"])
def test_router_choices_equal_reference(pair, policy):
    rng = np.random.RandomState(9)
    shared = [rng.randint(0, VOCAB, 16).tolist() for _ in range(3)]
    prompts = [(shared[i % 3] + rng.randint(0, VOCAB, 1 + i % 5).tolist(),
                4 + i % 7, 0.0) for i in range(24)]

    def ours():
        return _engine(pair, max_num_seqs=8)

    def ref():
        return JaxEngine(pair.jm, **_kw(max_num_seqs=8))

    mine = _routes(ReplicaRouter(build_replicas(ours(), ours, 3),
                                 policy=policy, seed=4), prompts)
    theirs = _routes(JaxRouter(jax_replicas(ref(), ref, 3), policy=policy,
                               seed=4), prompts)
    assert mine == theirs
    assert len(set(mine)) > 1


# ---------------------------------------------------------------------------
# the CLI's engine builder
# ---------------------------------------------------------------------------

def test_cli_build_engine_maps_every_flag():
    from paddle_tpu_torch.inference.frontend import __main__ as cli
    args = cli.argparse.Namespace(
        model="tiny", device="cpu", max_num_seqs=3, block_size=8,
        max_model_len=96, max_prefill_tokens=40, no_prefix_caching=True,
        kv_dtype="int8", weight_dtype="int8", host_kv_bytes=1 << 20,
        spec_k=2, tp=1)
    make = _build_engine(args)
    eng, eng2 = make(), make()
    assert eng.device.type == "cpu" and eng.max_num_seqs == 3
    assert eng.block_size == 8 and eng.max_model_len == 96
    assert eng.max_prefill_tokens == 40
    assert not eng.enable_prefix_caching
    assert eng.kv_dtype == "int8" and eng.weight_dtype == "int8"
    assert eng.spec_k == 2 and eng.drafter is not None
    assert not eng.retain_outputs
    assert isinstance(eng.kv_tier, HostSpillPool)
    assert eng.kv_tier.capacity_bytes == 1 << 20
    assert eng2.kv_tier is not eng.kv_tier          # one tier an engine
    args.host_kv_bytes, args.spec_k, args.kv_dtype = 0, 0, "float32"
    args.weight_dtype = "float32"
    plain = _build_engine(args)()
    assert plain.kv_tier is None and plain.drafter is None
    args.tp = 2
    assert _build_engine(args)().tp == 2
    args.tp = 3
    with pytest.raises(ValueError, match="tp=3"):
        _build_engine(args)()


def test_cli_parses_the_reference_flags(monkeypatch):
    """Every flag of the reference CLI parses, plus --device; the parsed
    namespace reaches ServingFrontend (stubbed: nothing is served)."""
    from paddle_tpu_torch.inference.frontend import __main__ as cli
    seen = {}

    class Stop(Exception):
        pass

    def fake_build(args):
        seen["args"] = args
        raise Stop
    monkeypatch.setattr(cli, "_build_engine", fake_build)
    with pytest.raises(Stop):
        cli.main(["--model", "llama-sm", "--device", "cpu", "--port", "0",
                  "--max-num-seqs", "2", "--replicas", "2",
                  "--router-policy", "least", "--host-kv-bytes", "4096",
                  "--step-deadline-s", "9", "--flight-capacity", "8",
                  "--slo-ttft-p95-ms", "300", "--deadline-ms", "50",
                  "--kv-dtype", "int8", "--weight-dtype", "int4",
                  "--spec-k", "3", "--no-prefix-caching"])
    a = seen["args"]
    assert (a.model, a.device, a.replicas, a.router_policy,
            a.host_kv_bytes, a.step_deadline_s, a.kv_dtype,
            a.weight_dtype, a.spec_k, a.no_prefix_caching) == (
        "llama-sm", "cpu", 2, "least", 4096, 9.0, "int8", "int4", 3, True)
