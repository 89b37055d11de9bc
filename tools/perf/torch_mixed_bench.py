"""The mixed serving workload of ``tools/perf/serve_bench.py``
(``run_mixed_bench``) for the PyTorch port's ``LLMEngine``.

Transcribed from serve_bench, which imports the JAX package: the stream
recipe (``mixed_request_stream``: every 4th prompt longer than the
per-step prefill budget, the rest short, all motif-tiled so the n-gram
drafter proposes), the workload fingerprint, the step-indexed arrival
drive, the ``--dump-workload`` capture and the record keys the fleet
simulator's ``validate_record`` reads (``workload_fingerprint``,
``ttft_p50_ms``, ``ttft_p95_ms``, ``p50_token_ms``, ``value``,
``new_tokens``, ``spec_emitted_tokens``, ``spec_rounds``, ``spec_k``,
``overlap``).  ``run_mixed`` serves the stream twice on one engine --
a warm pass, then the timed pass, traced when a tracer is given -- as
the bench does; it runs the headline overlap arm only.

Used by ``chip_smoke.py``'s ``sim_fit_bf16`` phase: the trace it records
goes through ``tools/perf/step_timeline.py --fit`` and the record, dump
and fit through ``paddle_tpu_torch.sim.validate_record``.
"""
from __future__ import annotations

import hashlib
import json
import time

import numpy as np

# run_mixed_bench's two engine configurations and speculation depths
SMOKE_ENGINE_KW = dict(max_num_seqs=8, block_size=8, max_model_len=256,
                       max_prefill_tokens=64, prefill_token_bucket=32)
SMOKE_SPEC_K = 3
ENGINE_KW = dict(max_num_seqs=16, block_size=16, max_model_len=1024,
                 max_prefill_tokens=256, prefill_token_bucket=128)
SPEC_K = 4


def workload_fingerprint(payload: dict) -> str:
    """Stable id of (seed + workload-shaping config): sha1 over the
    canonical JSON of ``payload`` (serve_bench's ``_workload_fingerprint``).
    The same fingerprint goes into the record and into the workload
    dump, so the simulator's validation joins the right pair."""
    blob = json.dumps(payload, sort_keys=True, separators=(",", ":"))
    return hashlib.sha1(blob.encode("utf-8")).hexdigest()[:16]


def mixed_request_stream(rng, n_requests, vocab, max_len,
                         max_prefill_tokens):
    """[(arrival step, prompt, max_new)]: every 4th request a LONG prompt
    (over the per-step prefill budget, so it resumes across chunked steps
    while other rows decode), the rest short; prompts are motif-tiled so
    the n-gram drafter keeps proposing."""
    stream, step = [], 0
    for i in range(n_requests):
        step += int(rng.poisson(1.0))
        motif = rng.randint(0, vocab, int(rng.randint(2, 5))).tolist()
        if i % 4 == 0:
            n = int(rng.randint(max_prefill_tokens + 4,
                                max_prefill_tokens * 2))
        else:
            n = int(rng.randint(4, 17))
        prompt = (motif * (n // len(motif) + 1))[:n]
        max_new = int(rng.randint(12, min(41, max_len - n)))
        stream.append((step, prompt, max_new))
    return stream


def drive(engine, stream):
    """Run the arrival-scheduled stream to completion: a request joins
    when the engine's step counter reaches its arrival step.  Wall
    seconds."""
    t0 = time.perf_counter()
    step_no = 0
    pending = list(stream)
    while pending or engine.has_unfinished():
        while pending and pending[0][0] <= step_no:
            _, prompt, max_new = pending.pop(0)
            engine.add_request(prompt, max_new_tokens=max_new)
        engine.step()
        step_no += 1
    return time.perf_counter() - t0


def mixed_workload(n_requests: int, seed: int, vocab: int, smoke: bool):
    """(stream, engine_kw, spec_k, dump) of run_mixed_bench's workload on
    the engine's default pages and weights at tp 1; ``dump`` is its
    ``--dump-workload`` capture, fingerprint included."""
    engine_kw = dict(SMOKE_ENGINE_KW if smoke else ENGINE_KW)
    spec_k = SMOKE_SPEC_K if smoke else SPEC_K
    rng = np.random.RandomState(seed)
    stream = mixed_request_stream(rng, n_requests, vocab,
                                  engine_kw["max_model_len"],
                                  engine_kw["max_prefill_tokens"])
    fingerprint = workload_fingerprint({
        "mode": "mixed", "seed": int(seed), "requests": int(n_requests),
        "smoke": bool(smoke), "kv_dtype": "float32",
        "weight_dtype": "float32", "tp": 1,
        "engine_kw": engine_kw, "spec_k": spec_k, "vocab": int(vocab)})
    dump = {
        "workload_fingerprint": fingerprint,
        "mode": "mixed",
        "seed": int(seed),
        "requests": int(n_requests),
        "engine_kw": engine_kw,
        "spec_k": spec_k,
        "vocab": int(vocab),
        "stream": [[step, list(map(int, prompt)), int(mn)]
                   for step, prompt, mn in stream],
    }
    return stream, engine_kw, spec_k, dump


def run_mixed(model, n_requests: int, seed: int, smoke: bool, *,
              device=None, tracer=None, before_timed=None):
    """Serve the mixed workload on ``model`` with prefix caching, the
    n-gram drafter (max_ngram 6, min_ngram 1) at spec_k, accept floor 0,
    and the engine's default async pipeline (overlap on): a warm pass,
    stats reset, then the timed pass (traced by ``tracer`` when given;
    ``before_timed()`` runs just before it).  Returns (record, dump,
    engine)."""
    from paddle_tpu_torch.inference import LLMEngine, NGramDrafter
    stream, engine_kw, spec_k, dump = mixed_workload(
        n_requests, seed, model.config.vocab_size, smoke)
    engine = LLMEngine(model, device=device, enable_prefix_caching=True,
                       drafter=NGramDrafter(max_ngram=6, min_ngram=1),
                       spec_k=spec_k, max_spec_k=spec_k,
                       spec_accept_floor=0.0, **engine_kw)
    engine.stats.enable_windows()
    total_new = sum(mn for _, _, mn in stream)
    drive(engine, stream)                # warm pass
    engine.stats.reset()
    for k in engine.pad_stats:           # ratio is for the timed pass only
        engine.pad_stats[k] = 0
    if tracer is not None:
        engine.set_tracer(tracer)
    if before_timed is not None:
        before_timed()
    elapsed = drive(engine, stream)
    s = engine.stats.summary()
    ps = dict(engine.pad_stats)
    real = max(ps["real"], 1)
    record = {
        "metric": "serve_mixed_tokens_per_s",
        "value": round(total_new / elapsed, 2) if elapsed else 0.0,
        "unit": "tok/s",
        "backend": engine.device.type,
        "requests": n_requests,
        "long_prompts": (n_requests + 3) // 4,
        "spec_k": spec_k,
        "new_tokens": total_new,
        "decode_tokens_per_s": s["decode_tokens_per_s"],
        "real_tokens": ps["real"],
        "padded_tokens": ps["padded"],
        "padding_waste_ratio": round(ps["padded"] / real, 3),
        "accept_rate": s["accept_rate"],
        "verify_steps": s["verify_steps"],
        "spec_rounds": s["spec_rounds"],
        "draft_proposed": s["draft_proposed"],
        "spec_emitted_tokens": s["spec_emitted_tokens"],
        "prefill_tokens": s["prefill_tokens"],
        "p50_token_ms": s["p50_token_ms"],
        "p99_token_ms": s["p99_token_ms"],
        "ttft_p50_ms": s["ttft_p50_ms"],
        "ttft_p95_ms": round(engine.stats.ttft_ms(95.0), 3),
        "ttft_p99_ms": s["ttft_p99_ms"],
        "preempted": s["preemptions"],
        "workload_fingerprint": dump["workload_fingerprint"],
        "overlap": "on" if engine.overlap else "off",
        "overlap_wall_s": round(elapsed, 3),
        "dispatch_ms_p50": s["dispatch_ms_p50"],
        "block_ms_p50": s["block_ms_p50"],
        "engine_steps": s["engine_steps"],
    }
    return record, dump, engine
