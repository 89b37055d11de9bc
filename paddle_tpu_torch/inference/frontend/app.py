"""ServingFrontend: the asyncio HTTP tier over one EngineRunner.

These routes own the whole serving surface:

    POST /v1/completions       generate (JSON body; SSE stream or one JSON)
    GET  /healthz              liveness + drain state
    GET  /metrics              Prometheus text (ServingStats + pool gauges)
    GET  /slo                  windowed percentiles + SLO burn-rate state
    GET  /debug/requests       flight-recorder list (?finished=&sort=&limit=)
    GET  /debug/requests/<id>  one request's flight record
    GET  /debug/trace          Chrome trace JSON (404 unless tracing on)

The request lifecycle the frontend guarantees, end to end:

    queued ──▶ prefilling ──▶ running ──▶ finished
      │            │             │
      └────────────┴─────────────┴─────▶ aborted   (disconnect, deadline,
      │                                             shutdown)
      └▶ shed (429)                      — admission queue full

* Backpressure: the runner bounds submitted-but-unfinished work; past
  the bound a request is SHED with 429 before it costs any engine state.
  While draining, new work gets 503.
* Deadlines: ``deadline_ms`` in the body (or the server-wide default)
  covers queue wait AND generation; the runner's stepping thread aborts
  expired requests with finish_reason "deadline" — the stream still gets
  its terminal frame.
* Disconnects: while streaming, the handler watches the socket for EOF
  concurrently with the token queue; a client that goes away mid-stream
  aborts its request in the engine, which retires the sequence and
  releases its KV pages at the next step boundary.
* Drain: ``shutdown()`` stops admissions (503), lets in-flight streams
  run to completion (or their deadlines), then stops the engine thread
  and closes lingering keep-alive sockets.

Token flow: the engine thread calls each request's deliver closure,
which trampolines events onto the asyncio loop via
``loop.call_soon_threadsafe`` into a per-request asyncio.Queue; the
route coroutine consumes the queue and writes SSE frames.  The HTTP
thread never touches engine state directly — snapshots and pool gauges
are the only cross-thread reads, and those surfaces lock internally.
"""
from __future__ import annotations

import asyncio
import json
import math
import threading

from .http import (HTTPError, SSEWriter, read_request, response_bytes)
from .metrics import render_metrics
from .protocol import (ProtocolError, completion_response, error_body,
                       parse_completion_request, stream_finish_frame,
                       stream_token_frame)
from .router import ReplicaRouter, build_replicas
from .runner import EngineRunner, RunnerDraining, RunnerSaturated

__all__ = ["ServingFrontend", "BackgroundServer", "serve_background"]

_ABORT_REASONS = ("aborted", "deadline", "shutdown")


class ServingFrontend:
    """One engine, one runner, one asyncio server.

    Parameters
    ----------
    engine: LLMEngine (build with ``retain_outputs=False`` for a
        long-running server; ``__main__`` does).
    model_name: echoed in response bodies as ``model``.
    host/port: bind address; port 0 picks a free port (``self.port``
        holds the real one after ``start()``).
    max_pending: admission bound forwarded to EngineRunner (per replica
        when ``replicas > 1``).
    default_deadline_s: applied when a request carries no deadline_ms;
        None means no deadline.
    engine_factory/step_deadline_s: forwarded to EngineRunner; together
        they arm the supervised-recovery watchdog (see runner docs).
    replicas: data-parallel engine replicas behind one listener.  1 (the
        default) keeps the single EngineRunner.  D > 1 builds D engines
        — the passed ``engine`` plus D-1 from ``engine_factory`` (then
        REQUIRED) — each with its own stepping thread, and routes
        requests across them with a ReplicaRouter; ``self.runner`` keeps
        the same surface either way.
    router_policy: "affinity" (default) | "least" | "random" — see
        router.py.  Ignored when replicas == 1.
    tracer: optional ``profiler.Tracer`` for the step timeline; falls
        back to the engine's own tracer so one ``set_tracer()`` on the
        engine lights up all four tiers.  When set, ``GET /debug/trace``
        serves the Chrome trace-event JSON.
    slo_config: optional ``profiler.SLOConfig`` (or dict of its fields)
        evaluated by the windowed-telemetry layer; None uses defaults.
        The frontend always enables windowed telemetry on its engines —
        ``GET /slo`` serves the rolling percentiles and burn-rate state.
    flight_capacity: per-replica flight-recorder bound (records kept for
        ``GET /debug/requests``); 0 disables the recorder entirely and
        the debug routes 404.
    anomaly_spool: directory for anomaly-triggered trace captures.  When
        set, slow-step/slow-request outliers snapshot the trace window
        plus the slowest flight records to bounded JSON files there; if
        no tracer was passed a small always-on ring is armed so there is
        a window to snapshot.
    """

    def __init__(self, engine, *, model_name: str = "model",
                 host: str = "127.0.0.1", port: int = 8000,
                 max_pending: int | None = None,
                 default_deadline_s: float | None = None,
                 engine_factory=None, step_deadline_s: float | None = None,
                 replicas: int = 1, router_policy: str = "affinity",
                 tracer=None, slo_config=None, flight_capacity: int = 512,
                 anomaly_spool: str | None = None):
        self.model_name = str(model_name)
        self.host = host
        self.port = int(port)
        self.default_deadline_s = default_deadline_s
        self.tracer = tracer if tracer is not None \
            else getattr(engine, "tracer", None)
        if anomaly_spool is not None and self.tracer is None:
            # anomaly capture needs a window to snapshot: arm a small
            # always-on ring (bounded; evicts itself) when the operator
            # asked for a spool but not for full tracing
            from ...profiler.trace import Tracer
            self.tracer = Tracer(capacity=4096)
        self._http_track = self.tracer.register("http") \
            if self.tracer is not None else "http"
        if int(replicas) > 1:
            self.runner = ReplicaRouter(
                build_replicas(engine, engine_factory, int(replicas),
                               max_pending=max_pending,
                               step_deadline_s=step_deadline_s),
                policy=router_policy, tracer=self.tracer)
        else:
            self.runner = EngineRunner(engine, max_pending=max_pending,
                                       engine_factory=engine_factory,
                                       step_deadline_s=step_deadline_s)
        if self.tracer is not None:
            # every replica engine records onto the SAME ring so one
            # trace shows a request crossing http -> router -> runner ->
            # engine with correlated ids
            for e in getattr(self.runner, "engines", [self.runner.engine]):
                if getattr(e, "tracer", None) is None:
                    e.set_tracer(self.tracer)
        # SLO observatory: windowed telemetry on every replica engine
        # (the per-engine ``enable_windows`` is what makes /slo render),
        # a bounded flight recorder per replica, and — when a spool
        # directory is given — anomaly-triggered trace capture.
        self.anomaly_spool = None
        if anomaly_spool is not None:
            from ...profiler.slo import AnomalySpool
            self.anomaly_spool = AnomalySpool(anomaly_spool)
        for e in getattr(self.runner, "engines", [self.runner.engine]):
            e.stats.enable_windows(slo_config, tracer=self.tracer)
            if int(flight_capacity) > 0 and getattr(e, "flight", None) is None:
                from ..flight import FlightRecorder
                e.set_flight(FlightRecorder(int(flight_capacity)))
            if self.anomaly_spool is not None:
                e.stats.windows.arm_anomaly(
                    spool=self.anomaly_spool, tracer=self.tracer,
                    flight=getattr(e, "flight", None))
        self._server = None
        self._writers: set = set()        # open connections, for shutdown
        self._lock = threading.Lock()
        self._closing = False
        # frontend-owned counters for /metrics
        self._requests_total: dict = {}   # (route, code) -> n
        self._shed_total = 0
        self._active_streams = 0

    @property
    def engine(self):
        # always the LIVE engine: supervised recovery may have replaced
        # the one this frontend was constructed with
        return self.runner.engine

    def _retry_after(self) -> str:
        """Retry-After seconds for 429s, from the live free-page trend
        when a DegradationController is attached (else a flat 1)."""
        pressure = getattr(self.engine, "pressure", None)
        if pressure is None:
            return "1"
        try:
            return str(max(1, int(math.ceil(pressure.retry_after_s()))))
        except Exception:
            return "1"

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    async def start(self) -> None:
        self.runner.start()
        self._server = await asyncio.start_server(
            self._handle_conn, host=self.host, port=self.port)
        self.port = self._server.sockets[0].getsockname()[1]

    async def serve_forever(self) -> None:
        if self._server is None:
            await self.start()
        async with self._server:
            await self._server.serve_forever()

    async def shutdown(self, *, drain_timeout_s: float = 30.0,
                       abort_inflight: bool = False) -> bool:
        """Graceful drain: refuse new work, finish what's running, stop.
        With ``abort_inflight`` every running request is aborted (reason
        "shutdown") instead of finished — the impatient variant.  True
        when the engine drained fully inside the timeout."""
        self._closing = True
        if self._server is not None:
            self._server.close()          # stop accepting sockets
        loop = asyncio.get_running_loop()
        if abort_inflight:
            drained = await loop.run_in_executor(
                None, lambda: (self.runner.close(abort_inflight=True), True)[1])
        else:
            drained = await loop.run_in_executor(
                None, lambda: self.runner.drain(timeout_s=drain_timeout_s))
        # in-flight streams have now written their terminal frames; close
        # whatever keep-alive sockets are still parked in read_request
        with self._lock:
            writers = list(self._writers)
        for w in writers:
            try:
                w.close()
            except Exception:
                pass
        if self._server is not None:
            await self._server.wait_closed()
        return drained

    # ------------------------------------------------------------------
    # connection handling
    # ------------------------------------------------------------------

    def _count(self, route: str, code: int) -> None:
        with self._lock:
            key = (route, int(code))
            self._requests_total[key] = self._requests_total.get(key, 0) + 1

    async def _handle_conn(self, reader, writer) -> None:
        with self._lock:
            self._writers.add(writer)
        try:
            while not self._closing:
                try:
                    req = await read_request(reader)
                except HTTPError as e:
                    self._count("bad", e.status)
                    writer.write(response_bytes(
                        e.status, error_body(e.status, e.message),
                        keep_alive=False))
                    await writer.drain()
                    return
                if req is None:
                    return                # clean EOF between requests
                keep = await self._dispatch(req, reader, writer)
                if not keep:
                    return
        except (ConnectionError, asyncio.IncompleteReadError):
            pass                          # client went away; nothing to do
        finally:
            with self._lock:
                self._writers.discard(writer)
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                pass

    async def _dispatch(self, req, reader, writer) -> bool:
        """Route one request.  Returns False to close the connection."""
        route = (req.method, req.path)
        if route == ("POST", "/v1/completions"):
            return await self._completions(req, reader, writer)
        if route == ("GET", "/healthz"):
            body = (b'{"status": "draining"}'
                    if self._closing or self.runner.draining
                    else b'{"status": "ok"}')
            self._count("/healthz", 200)
            writer.write(response_bytes(200, body))
            await writer.drain()
            return True
        if route == ("GET", "/metrics"):
            # a ReplicaRouter aggregates stats across its fleet and adds
            # per-replica routing gauges; a plain runner reads one engine
            if hasattr(self.runner, "stats_snapshot"):
                snap = self.runner.stats_snapshot()
                router = self.runner.router_counters()
            else:
                snap = self.engine.stats.snapshot()
                router = None
            text = render_metrics(
                snap, engine=self.engine,
                frontend=self._frontend_counters(), router=router)
            self._count("/metrics", 200)
            writer.write(response_bytes(
                200, text.encode("utf-8"),
                content_type="text/plain; version=0.0.4; charset=utf-8"))
            await writer.drain()
            return True
        if route == ("GET", "/slo"):
            # same snapshot surface as /metrics: fleet-pooled when a
            # router is in front, single-engine otherwise
            if hasattr(self.runner, "stats_snapshot"):
                snap = self.runner.stats_snapshot()
            else:
                snap = self.engine.stats.snapshot()
            if "windows" not in snap:
                self._count("/slo", 404)
                writer.write(response_bytes(404, error_body(
                    404, "windowed telemetry is not enabled")))
                await writer.drain()
                return True
            out = {k: snap.get(k) for k in (
                "slo_state", "slo_state_name", "ttft_p95_w60s",
                "itl_p99_w60s", "queue_wait_p95_w60s",
                "anomalies_detected", "anomalies_captured",
                "anomaly_spool_dropped")}
            out["slo"] = snap.get("slo")
            out["windows"] = snap["windows"]
            self._count("/slo", 200)
            writer.write(response_bytes(
                200, json.dumps(out).encode("utf-8"),
                content_type="application/json"))
            await writer.drain()
            return True
        if req.method == "GET" and (req.path == "/debug/requests"
                                    or req.path.startswith(
                                        "/debug/requests/")):
            return await self._debug_requests(req, writer)
        if route == ("GET", "/debug/trace"):
            tr = self.tracer
            if tr is None:
                self._count("/debug/trace", 404)
                writer.write(response_bytes(404, error_body(
                    404, "tracing is not enabled on this server")))
                await writer.drain()
                return True
            body = json.dumps(tr.chrome_trace()).encode("utf-8")
            self._count("/debug/trace", 200)
            writer.write(response_bytes(
                200, body, content_type="application/json"))
            await writer.drain()
            return True
        status = 405 if req.path in ("/v1/completions", "/healthz",
                                     "/metrics", "/debug/trace", "/slo",
                                     "/debug/requests") else 404
        self._count(req.path, status)
        writer.write(response_bytes(
            status, error_body(status, f"no route {req.method} {req.path}"),
            keep_alive=False))
        await writer.drain()
        return False

    def _flight_recorders(self) -> list:
        return [fl for fl in (
            getattr(e, "flight", None)
            for e in getattr(self.runner, "engines", [self.runner.engine]))
            if fl is not None]

    async def _debug_requests(self, req, writer) -> bool:
        """GET /debug/requests (ranked list) and /debug/requests/<id>
        (one flight record).  404 when flight recording is disabled."""
        recorders = self._flight_recorders()
        if not recorders:
            self._count("/debug/requests", 404)
            writer.write(response_bytes(404, error_body(
                404, "flight recording is not enabled")))
            await writer.drain()
            return True
        rest = req.path[len("/debug/requests"):].strip("/")
        if rest:                          # one record, by frontend id
            rec = None
            for fl in recorders:
                rec = fl.get(rest)
                if rec is None and rest.isdigit():
                    rec = fl.get(int(rest))   # raw engine rid fallback
                if rec is not None:
                    break
            if rec is None:
                self._count("/debug/requests", 404)
                writer.write(response_bytes(404, error_body(
                    404, f"no flight record for {rest!r} (evicted or "
                    "never admitted)")))
                await writer.drain()
                return True
            self._count("/debug/requests", 200)
            writer.write(response_bytes(
                200, json.dumps(rec).encode("utf-8"),
                content_type="application/json"))
            await writer.drain()
            return True
        fq = req.query.get("finished")
        sort = req.query.get("sort", "slowest")
        finished = None
        if fq in ("true", "1", "yes"):
            finished = True
        elif fq in ("false", "0", "no"):
            finished = False
        elif fq == "slowest":             # ?finished=slowest shorthand
            finished, sort = True, "slowest"
        try:
            limit = max(1, min(512, int(req.query.get("limit", 32))))
        except ValueError:
            limit = 32
        merged: list = []
        for fl in recorders:
            merged.extend(fl.list(finished=finished, sort=sort,
                                  limit=limit))
        if sort == "slowest":             # re-rank across replicas
            merged.sort(key=lambda r: r.get("elapsed_s") or 0.0,
                        reverse=True)
        merged = merged[:limit]
        body = {"count": len(merged),
                "evicted": sum(fl.evicted for fl in recorders),
                "requests": merged}
        self._count("/debug/requests", 200)
        writer.write(response_bytes(
            200, json.dumps(body).encode("utf-8"),
            content_type="application/json"))
        await writer.drain()
        return True

    def _frontend_counters(self) -> dict:
        with self._lock:
            return {
                "requests_total": dict(self._requests_total),
                "shed_total": self._shed_total,
                "active_streams": self._active_streams,
                "queue_depth": self.runner.inflight(),
                "draining": self._closing or self.runner.draining,
            }

    # ------------------------------------------------------------------
    # POST /v1/completions
    # ------------------------------------------------------------------

    async def _completions(self, req, reader, writer) -> bool:
        route = "/v1/completions"
        # stackless now()/complete() here and below: an asyncio handler
        # must never hold a span() across an await (coroutines interleave
        # on one thread and would corrupt the per-thread span stack)
        tr = self.tracer
        try:
            t_parse = tr.now() if tr is not None else 0
            kwargs, stream, deadline_ms = parse_completion_request(req.body)
            if tr is not None:
                tr.complete("http.parse", t_parse, track=self._http_track,
                            args={"bytes": len(req.body or b"")})
        except ProtocolError as e:
            self._count(route, 400)
            writer.write(response_bytes(400, error_body(400, str(e))))
            await writer.drain()
            return True

        pressure = getattr(self.engine, "pressure", None)
        if pressure is not None and pressure.admission_paused:
            # graceful degradation: shed before the request costs any
            # runner/engine state; Retry-After from the free-page trend
            with self._lock:
                self._shed_total += 1
            self._count(route, 429)
            writer.write(response_bytes(
                429, error_body(429, "admission paused under memory "
                                "pressure", kind="overloaded"),
                extra_headers={"Retry-After": self._retry_after()}))
            await writer.drain()
            return True

        deadline_s = (deadline_ms / 1e3 if deadline_ms is not None
                      else self.default_deadline_s)
        loop = asyncio.get_running_loop()
        q: asyncio.Queue = asyncio.Queue()

        def deliver(ev, _loop=loop, _q=q):
            # engine thread -> event loop; a loop torn down mid-flight
            # (server stopped) must not kill the engine thread
            try:
                _loop.call_soon_threadsafe(_q.put_nowait, ev)
            except RuntimeError:
                pass

        prompt = kwargs.pop("prompt")
        try:
            request_id = self.runner.submit(
                prompt, deliver=deliver, deadline_s=deadline_s, **kwargs)
        except RunnerSaturated as e:
            with self._lock:
                self._shed_total += 1
            self._count(route, 429)
            writer.write(response_bytes(
                429, error_body(429, str(e), kind="overloaded"),
                extra_headers={"Retry-After": self._retry_after()}))
            await writer.drain()
            return True
        except RunnerDraining as e:
            self._count(route, 503)
            writer.write(response_bytes(
                503, error_body(503, str(e), kind="shutting_down"),
                keep_alive=False))
            await writer.drain()
            return False

        if tr is not None:
            tr.instant("http.request", track=self._http_track,
                       args={"request_id": request_id, "stream": stream})
        if stream:
            plan = getattr(self.engine, "fault_plan", None)
            inject_drop = plan is not None and plan.take_conn_drop()
            return await self._stream_response(
                request_id, q, reader, writer, inject_drop=inject_drop)
        return await self._unary_response(request_id, q, reader, writer)

    @staticmethod
    async def _reap(task) -> None:
        """Cancel a pending read/get task and WAIT for it to unwind —
        returning to the keep-alive loop while a cancelled read is still
        registered on the stream trips asyncio's one-reader guard."""
        if task is None or task.done():
            return
        task.cancel()
        try:
            await task
        except (asyncio.CancelledError, Exception):
            pass

    async def _watch_eof(self, reader):
        """Resolves when the client half-closes or drops the socket.
        Pipelined garbage before EOF also lands here — treating it as a
        disconnect is the safe reading for a streaming endpoint."""
        try:
            await reader.read(1)
        except Exception:
            pass

    async def _stream_response(self, request_id, q, reader, writer,
                               inject_drop: bool = False) -> bool:
        route = "/v1/completions"
        tr = self.tracer
        sse = SSEWriter(writer)
        with self._lock:
            self._active_streams += 1
        eof = asyncio.ensure_future(self._watch_eof(reader))
        getter = None
        try:
            await sse.start()
            self._count(route, 200)
            while True:
                if q.empty():
                    getter = asyncio.ensure_future(q.get())
                    done, _ = await asyncio.wait(
                        {getter, eof}, return_when=asyncio.FIRST_COMPLETED)
                    if getter not in done:
                        await self._reap(getter)
                        self.runner.abort(request_id, reason="aborted")
                        return False      # socket is gone; just close
                    kind, payload = getter.result()
                else:
                    kind, payload = q.get_nowait()
                if kind == "token":
                    t_w = tr.now() if tr is not None else 0
                    await sse.event(stream_token_frame(
                        request_id, self.model_name, payload))
                    if tr is not None:
                        tr.complete("http.sse_write", t_w,
                                    track=self._http_track,
                                    args={"request_id": request_id,
                                          "kind": "token"})
                    if inject_drop:
                        # injected mid-stream disconnect: behave exactly
                        # like the client vanished after this frame
                        self.engine.stats.record_fault("conn")
                        self.runner.abort(request_id, reason="aborted")
                        return False
                else:
                    t_w = tr.now() if tr is not None else 0
                    await sse.event(stream_finish_frame(
                        request_id, self.model_name, payload))
                    await sse.done()
                    if tr is not None:
                        tr.complete("http.sse_write", t_w,
                                    track=self._http_track,
                                    args={"request_id": request_id,
                                          "kind": "finish"})
                    return True
        except (ConnectionError, asyncio.IncompleteReadError):
            self.runner.abort(request_id, reason="aborted")
            return False
        finally:
            await self._reap(eof)
            await self._reap(getter)
            with self._lock:
                self._active_streams -= 1

    async def _unary_response(self, request_id, q, reader, writer) -> bool:
        route = "/v1/completions"
        eof = asyncio.ensure_future(self._watch_eof(reader))
        getter = None
        try:
            while True:
                if q.empty():
                    getter = asyncio.ensure_future(q.get())
                    done, _ = await asyncio.wait(
                        {getter, eof}, return_when=asyncio.FIRST_COMPLETED)
                    if getter not in done:
                        await self._reap(getter)
                        self.runner.abort(request_id, reason="aborted")
                        return False
                    kind, payload = getter.result()
                else:
                    kind, payload = q.get_nowait()
                if kind != "finish":
                    continue              # tokens accumulate engine-side
                self._count(route, 200)
                writer.write(response_bytes(200, completion_response(
                    request_id, self.model_name, payload)))
                await writer.drain()
                return True
        except (ConnectionError, asyncio.IncompleteReadError):
            self.runner.abort(request_id, reason="aborted")
            return False
        finally:
            await self._reap(eof)
            await self._reap(getter)


# ----------------------------------------------------------------------
# background server: the handle tests and serve_bench drive
# ----------------------------------------------------------------------

class BackgroundServer:
    """A ServingFrontend running its own event loop in a daemon thread.

    ``port`` is live after construction returns; ``stop()`` performs the
    graceful drain and joins the thread.  Usable as a context manager.
    """

    def __init__(self, frontend: ServingFrontend):
        self.frontend = frontend
        self.port = None
        self._ready = threading.Event()
        self._stop_ev = None              # asyncio.Event on the loop
        self._loop = None
        self._error = None
        self._stop_kwargs = {}
        self.drained = None
        self._thread = threading.Thread(target=self._run, name="llm-http",
                                        daemon=True)
        self._thread.start()
        self._ready.wait(timeout=30.0)
        if self._error is not None:
            raise self._error

    def _run(self) -> None:
        async def main():
            self._loop = asyncio.get_running_loop()
            self._stop_ev = asyncio.Event()
            try:
                await self.frontend.start()
                self.port = self.frontend.port
            except Exception as e:
                self._error = e
                self._ready.set()
                return
            self._ready.set()
            await self._stop_ev.wait()
            self.drained = await self.frontend.shutdown(**self._stop_kwargs)
        asyncio.run(main())

    def stop(self, *, drain_timeout_s: float = 30.0,
             abort_inflight: bool = False):
        """Drain + stop; returns whether the drain completed cleanly."""
        if self._loop is not None and self._thread.is_alive():
            self._stop_kwargs = {"drain_timeout_s": drain_timeout_s,
                                 "abort_inflight": abort_inflight}
            self._loop.call_soon_threadsafe(self._stop_ev.set)
        self._thread.join(timeout=drain_timeout_s + 30.0)
        return self.drained

    def __enter__(self) -> "BackgroundServer":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


def serve_background(engine, **frontend_kwargs) -> BackgroundServer:
    """Spin up a frontend on a free localhost port in a background
    thread.  The one-liner tests and serve_bench use:

        srv = serve_background(engine, model_name="tiny")
        ... http.client against 127.0.0.1:srv.port ...
        srv.stop()
    """
    frontend_kwargs.setdefault("port", 0)
    return BackgroundServer(ServingFrontend(engine, **frontend_kwargs))
