"""HTTP serving frontend for the LLM engine (stdlib-only).

The package that turns ``LLMEngine`` into a server:

- ``app.ServingFrontend`` — asyncio HTTP/1.1 tier: POST /v1/completions
  (SSE token streaming), GET /healthz, GET /metrics (Prometheus text),
  backpressure (429 shed / 503 drain), per-request deadlines,
  disconnect-abort, graceful drain.
- ``runner.EngineRunner`` — the thread bridge: one dedicated thread
  steps the single-threaded engine; submit/abort cross over via queues
  drained at step boundaries; tokens stream out through per-request
  deliver callbacks.
- ``router.ReplicaRouter`` — data-parallel fan-out: D engine replicas
  (each its own runner thread) behind one EngineRunner-shaped facade,
  with prefix-affinity / least-outstanding-tokens / random routing.
- ``protocol`` — the OpenAI-completions-shaped wire schema (token-id
  native), ``http`` — the minimal hand-rolled HTTP/1.1 + SSE layer,
  ``metrics`` — Prometheus rendering of ``ServingStats.snapshot()``.

Run a server:  ``python -m paddle_tpu_torch.inference.frontend --model llama-sm``

Everything is stdlib (asyncio + sockets); there is no web-framework
dependency anywhere under this package.
"""
from .app import BackgroundServer, ServingFrontend, serve_background
from .router import ReplicaRouter, build_replicas
from .runner import (EngineRunner, RunnerDraining, RunnerSaturated,
                     StreamHandle)

__all__ = ["ServingFrontend", "BackgroundServer", "serve_background",
           "EngineRunner", "RunnerSaturated", "RunnerDraining",
           "StreamHandle", "ReplicaRouter", "build_replicas"]
