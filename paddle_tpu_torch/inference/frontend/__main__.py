"""CLI: serve a model over HTTP.

    python -m paddle_tpu_torch.inference.frontend --model llama-sm
    curl -N http://127.0.0.1:8000/v1/completions \\
      -d '{"prompt": [1, 17, 29], "max_tokens": 32, "stream": true}'

Model presets (randomly-initialised weights — this CLI demonstrates and
load-tests the serving stack; checkpoint loading arrives with the HF
bridge):

    tiny       2-layer toy (vocab 256) — starts in seconds, CPU-friendly
    llama-sm   ~8-layer small config — a realistic serving shape
    llama-7b   the full 7B config — sized for one H100

The engine runs on the CUDA card unless ``--device`` names another
(``--device cpu`` runs the kernels' plain PyTorch versions).

SIGINT/SIGTERM trigger a graceful drain: admissions stop (503),
in-flight streams finish, the engine thread parks, then the process
exits.  A second SIGINT aborts in-flight work instead of finishing it.
"""
from __future__ import annotations

import argparse
import asyncio
import signal
import sys


def _build_engine(args):
    from paddle_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                               resolve_device)
    from ..serving import LLMEngine

    if args.model == "tiny":
        cfg = LlamaConfig.tiny(vocab=256, hidden=64, layers=2, heads=4,
                               ffn=128, seq=args.max_model_len or 256)
    elif args.model == "llama-sm":
        cfg = LlamaConfig(vocab_size=8192, hidden_size=512,
                          intermediate_size=1408, num_hidden_layers=8,
                          num_attention_heads=8, num_key_value_heads=8,
                          max_position_embeddings=args.max_model_len or 2048)
    elif args.model == "llama-7b":
        cfg = LlamaConfig.llama_7b()
        if args.max_model_len:
            cfg.max_position_embeddings = args.max_model_len
    else:
        raise SystemExit(f"unknown --model {args.model!r}")

    device = resolve_device(args.device)
    model = LlamaForCausalLM(cfg, device=device)
    # with no --device, --tp N takes one card a shard (cuda:0 .. N-1; the
    # engine raises when fewer are visible); a named device holds them all
    engine_device = device if args.device is not None or args.tp == 1 \
        else None
    drafter = "ngram" if args.spec_k > 0 else None

    def make_engine():
        # shares the model (same weights!) so supervised recovery can
        # rebuild the engine and replay journals byte-identically
        kv_tier = None
        if args.host_kv_bytes > 0:
            # per-engine tier: each replica spills to its own host pool
            # (chain hashes are replica-local residency claims).  A
            # supervised rebuild gets a fresh tier — spilled pages are
            # a cache, not state recovery depends on.
            from ..kv_tier import HostSpillPool
            kv_tier = HostSpillPool(args.host_kv_bytes)
        return LLMEngine(
            model, device=engine_device, max_num_seqs=args.max_num_seqs,
            block_size=args.block_size,
            max_model_len=cfg.max_position_embeddings,
            max_prefill_tokens=args.max_prefill_tokens,
            enable_prefix_caching=not args.no_prefix_caching,
            drafter=drafter, spec_k=args.spec_k,
            kv_dtype=args.kv_dtype, weight_dtype=args.weight_dtype,
            tp=args.tp, retain_outputs=False, kv_tier=kv_tier)

    return make_engine


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.inference.frontend",
        description="Serve an LLM over HTTP (OpenAI-style /v1/completions "
                    "with SSE streaming, /healthz, /metrics).")
    ap.add_argument("--model", default="tiny",
                    choices=["tiny", "llama-sm", "llama-7b"])
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--max-num-seqs", type=int, default=8)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--max-model-len", type=int, default=0,
                    help="0 = the preset's max_position_embeddings")
    ap.add_argument("--max-prefill-tokens", type=int, default=512)
    ap.add_argument("--no-prefix-caching", action="store_true")
    ap.add_argument("--kv-dtype", default="float32",
                    choices=["float32", "int8"],
                    help="KV page storage dtype; int8 quarters the page "
                         "pool's HBM cost (per-page scales, in-kernel "
                         "dequant) for 2x+ resident sequences")
    ap.add_argument("--weight-dtype", default="float32",
                    choices=["float32", "int8", "int4"],
                    help="weight pool storage dtype; int8/int4 cut "
                         "resident weight bytes 4x/8x (per-channel "
                         "scales, fused dequant-matmul kernel)")
    ap.add_argument("--host-kv-bytes", type=int, default=0,
                    help="host-DRAM KV spill tier capacity per engine "
                         "replica, in bytes: pressure-evicted parked "
                         "pages spill there instead of dying and are "
                         "restored HBM-side when their prefix returns "
                         "(0 disables the tier)")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative draft length (0 disables; >0 enables "
                         "the n-gram drafter)")
    ap.add_argument("--max-pending", type=int, default=0,
                    help="admission bound before shedding 429s "
                         "(0 = 4 x max-num-seqs)")
    ap.add_argument("--deadline-ms", type=float, default=0,
                    help="default per-request deadline (0 = none)")
    ap.add_argument("--drain-timeout-s", type=float, default=30.0)
    ap.add_argument("--step-deadline-s", type=float, default=0,
                    help="supervised recovery: rebuild the engine and "
                         "replay in-flight requests when a step crashes "
                         "or runs past this wall budget (0 = off)")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel shards per engine: heads and KV "
                         "pages split over tp shards in one process "
                         "(token-identical to --tp 1); one card a shard "
                         "unless --device names one for all of them")
    ap.add_argument("--replicas", type=int, default=1,
                    help="data-parallel engine replicas behind one "
                         "listener, fed by the replica router")
    ap.add_argument("--router-policy", default="affinity",
                    choices=["affinity", "least", "random"],
                    help="replica routing: prefix-affinity (shared "
                         "prompts land on the replica already holding "
                         "their KV pages), least-outstanding-tokens, or "
                         "random (ignored with --replicas 1)")
    ap.add_argument("--device", default=None,
                    help="where the engines run: the CUDA card by default "
                         "(fails when there is none), 'cpu' for the "
                         "kernels' plain PyTorch versions")
    ap.add_argument("--flight-capacity", type=int, default=512,
                    help="per-replica flight-recorder bound for "
                         "GET /debug/requests (0 disables)")
    ap.add_argument("--anomaly-spool", default=None, metavar="DIR",
                    help="directory for anomaly-triggered trace "
                         "captures: slow-step/slow-request outliers "
                         "snapshot the trace window + slowest flight "
                         "records there (bounded; drops are counted)")
    ap.add_argument("--slo-ttft-p95-ms", type=float, default=500.0,
                    help="SLO objective: 95%% of first tokens under "
                         "this many ms")
    ap.add_argument("--slo-itl-p99-ms", type=float, default=200.0,
                    help="SLO objective: 99%% of inter-token intervals "
                         "under this many ms")
    ap.add_argument("--slo-deadline-attainment", type=float, default=0.99,
                    help="SLO objective: fraction of deadline-carrying "
                         "requests that must finish in budget")
    ap.add_argument("--slo-availability", type=float, default=0.999,
                    help="SLO objective: fraction of requests that must "
                         "finish without error/quarantine")
    args = ap.parse_args(argv)

    print(f"[frontend] building {args.model} engine"
          + (f" x{args.replicas}" if args.replicas > 1 else "")
          + (f" (tp={args.tp})" if args.tp > 1 else "")
          + " ...", flush=True)
    make_engine = _build_engine(args)
    engine = make_engine()

    from .app import ServingFrontend
    frontend = ServingFrontend(
        engine, model_name=args.model, host=args.host, port=args.port,
        max_pending=args.max_pending or None,
        default_deadline_s=(args.deadline_ms / 1e3
                            if args.deadline_ms else None),
        engine_factory=(make_engine if args.step_deadline_s
                        or args.replicas > 1 else None),
        step_deadline_s=args.step_deadline_s or None,
        replicas=args.replicas, router_policy=args.router_policy,
        slo_config={"ttft_p95_ms": args.slo_ttft_p95_ms,
                    "itl_p99_ms": args.slo_itl_p99_ms,
                    "deadline_attainment": args.slo_deadline_attainment,
                    "availability": args.slo_availability},
        flight_capacity=args.flight_capacity,
        anomaly_spool=args.anomaly_spool)

    async def run():
        await frontend.start()
        print(f"[frontend] listening on http://{frontend.host}:"
              f"{frontend.port}  (model={args.model}, "
              f"max_num_seqs={engine.max_num_seqs})", flush=True)
        stop = asyncio.Event()
        second = asyncio.Event()
        hits = {"n": 0}

        def on_signal():
            hits["n"] += 1
            stop.set()
            if hits["n"] > 1:
                second.set()

        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                loop.add_signal_handler(sig, on_signal)
            except NotImplementedError:
                pass
        serve = asyncio.ensure_future(frontend.serve_forever())
        await stop.wait()
        impatient = hits["n"] > 1
        print("[frontend] draining "
              f"({frontend.runner.inflight()} in flight"
              f"{', aborting' if impatient else ''}) ...", flush=True)
        drain = asyncio.ensure_future(frontend.shutdown(
            drain_timeout_s=args.drain_timeout_s,
            abort_inflight=impatient))
        if not impatient:
            # a second signal at ANY point during the drain escalates:
            # abort the in-flight set so the drain completes now
            escalate = asyncio.ensure_future(second.wait())
            done, _ = await asyncio.wait(
                {drain, escalate}, return_when=asyncio.FIRST_COMPLETED)
            if drain not in done:
                n = frontend.runner.abort_all("shutdown")
                print(f"[frontend] second signal: aborting {n} in-flight "
                      "request(s) ...", flush=True)
            escalate.cancel()
        drained = await drain
        serve.cancel()
        print(f"[frontend] {'drained' if drained else 'DRAIN TIMED OUT'}; "
              "bye", flush=True)
        return 0 if drained else 1

    return asyncio.run(run())


if __name__ == "__main__":
    sys.exit(main())
