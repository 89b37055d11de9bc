"""SLO observatory: windowed telemetry, burn-rate state, anomaly capture.

``ServingStats`` (profiler/serving.py) keeps LIFETIME aggregates — exact
counters plus bounded reservoirs — which answer "how did this run do"
but not "how is the service doing RIGHT NOW".  This module adds the
windowed side of the story, attached to a ``ServingStats`` via
``enable_windows()`` and surfaced through ``snapshot()``, ``/metrics``
and the frontend's ``GET /slo`` endpoint:

* **Ring-of-buckets rolling windows.**  Each latency channel (TTFT,
  ITL, step duration, queue wait, request latency) holds one ``_Ring``
  per window length (10s/60s/300s by default): a fixed array of time
  buckets, each a fixed-bound histogram on the same ladder as
  ``_HIST_BOUNDS``, rotated in place by ``time.perf_counter`` (never
  wall clock — see the ``wallclock-in-timing-path`` lint rule).  A
  bucket is reused when its generation stamp goes stale, so memory is
  O(windows x buckets x bounds) forever and a reader always sees the
  trailing window to one-bucket granularity.  Because every replica
  shares the ladder, fleet aggregation SUMS bucket counts index-by-
  index (``aggregate_windows``) and recomputes honest fleet
  percentiles — no max-of-quantiles bound.
* **Declarative SLOs with multi-window burn rates.**  ``SLOConfig``
  names the objectives (ttft_p95_ms, itl_p99_ms, deadline_attainment,
  availability); ``evaluate_slo`` turns each window into a BURN RATE —
  observed error fraction over the error budget the objective leaves
  (the SRE convention: burn 1.0 consumes exactly the budget, 2.0
  consumes it twice as fast) — and ``SLOMonitor`` folds the windows
  into one state: PAGE when the short AND medium windows both burn
  past ``page_burn`` (sustained, fast burn), WARN when the medium or
  long window burns past ``warn_burn``, NORMAL otherwise.  Transitions
  land as tracer instants (``slo.transition``) and in a bounded deque.
* **Anomaly-triggered capture.**  ``AnomalyDetector`` flags outliers
  with a robust median + k*MAD threshold over a bounded rolling sample
  (immune to the outliers it hunts, unlike mean/stddev); when armed
  with a Tracer ring and a flight recorder, ``WindowedTelemetry``
  snapshots the trace window plus the offending flight records into an
  ``AnomalySpool`` — a bounded on-disk directory that counts what it
  drops instead of growing without bound.

Everything here is opt-in and bounded: a ``ServingStats`` that never
called ``enable_windows()`` never executes a line of this file (pinned
by tracemalloc test), and every buffer is a ring, a reservoir, or a
capped deque (see the ``unbounded-observability-buffer`` lint rule).
"""
from __future__ import annotations

import bisect
import json
import os
import threading
import time
from collections import deque
from dataclasses import dataclass

from ..analysis.lock_check import install as _install_lock_check

__all__ = ["SLOConfig", "SLOMonitor", "WindowedTelemetry",
           "AnomalyDetector", "AnomalySpool", "evaluate_slo",
           "aggregate_windows", "SLO_STATE_NAMES",
           "NORMAL", "WARN", "PAGE"]

# shared with profiler/serving.py's _Hist: identical ladders are what
# make bucket counts summable across replicas
_BOUNDS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
           0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

_WINDOWS = (10.0, 60.0, 300.0)

NORMAL, WARN, PAGE = 0, 1, 2
SLO_STATE_NAMES = {NORMAL: "NORMAL", WARN: "WARN", PAGE: "PAGE"}

_LATENCY_CHANNELS = ("ttft", "itl", "step", "queue_wait", "request")
_RATE_CHANNELS = ("accept", "deadline", "availability")


def _wlabel(seconds: float) -> str:
    return f"{seconds:g}s"


def bucket_percentile(counts, q: float, bounds=_BOUNDS) -> float:
    """Percentile (seconds) from non-cumulative bucket counts on the
    shared ladder, with Prometheus-style linear interpolation inside
    the bucket; the +Inf bucket clamps to the highest finite bound."""
    total = sum(counts)
    if total <= 0:
        return 0.0
    target = q / 100.0 * total
    cum = 0.0
    lo = 0.0
    for i, c in enumerate(counts):
        if c and cum + c >= target:
            if i >= len(bounds):
                return bounds[-1]
            hi = bounds[i]
            return lo + (target - cum) / c * (hi - lo)
        cum += c
        if i < len(bounds):
            lo = bounds[i]
    return bounds[-1]


def _frac_over(counts, threshold_s: float, bounds=_BOUNDS) -> float:
    """Fraction of samples above ``threshold_s``, bucket-approximated:
    a sample is "good" when its whole bucket sits at or under the
    threshold (conservative for thresholds between bucket edges)."""
    total = sum(counts)
    if total <= 0:
        return 0.0
    good = sum(c for i, c in enumerate(counts)
               if i < len(bounds) and bounds[i] <= threshold_s)
    return (total - good) / total


@_install_lock_check
class _Ring:
    """One rolling window over one latency channel: a fixed ring of
    time buckets, each a fixed-bound histogram.  ``n_buckets`` bounds
    the memory; generation stamps recycle stale buckets in place, so
    the ring never allocates after construction."""

    __slots__ = ("window_s", "span", "n_buckets", "_counts", "_sums",
                 "_ns", "_gen", "_lock")

    def __init__(self, window_s: float, n_buckets: int = 12):
        self.window_s = float(window_s)
        self.n_buckets = int(n_buckets)
        self.span = self.window_s / self.n_buckets
        nb = len(_BOUNDS) + 1
        self._counts = [[0] * nb for _ in range(self.n_buckets)]
        self._sums = [0.0] * self.n_buckets
        self._ns = [0] * self.n_buckets
        self._gen = [-1] * self.n_buckets     # absolute bucket index
        self._lock = threading.Lock()

    def _slot(self, now: float) -> int:  # guarded-by: _lock
        g = int(now / self.span)
        i = g % self.n_buckets
        if self._gen[i] != g:
            self._gen[i] = g
            c = self._counts[i]
            for j in range(len(c)):
                c[j] = 0
            self._sums[i] = 0.0
            self._ns[i] = 0
        return i

    def add(self, now: float, v: float, n: int = 1) -> None:
        b = bisect.bisect_left(_BOUNDS, v)
        with self._lock:
            i = self._slot(now)
            self._counts[i][b] += n
            self._sums[i] += v * n
            self._ns[i] += n

    def merged(self, now: float):
        """(counts, sum, count) over the buckets still inside the
        window at ``now`` — the read surface snapshots render."""
        g_now = int(now / self.span)
        out = [0] * (len(_BOUNDS) + 1)
        total = 0.0
        n = 0
        with self._lock:
            for i in range(self.n_buckets):
                g = self._gen[i]
                if g < 0 or g_now - g >= self.n_buckets:
                    continue
                c = self._counts[i]
                for j, cj in enumerate(c):
                    out[j] += cj
                total += self._sums[i]
                n += self._ns[i]
        return out, total, n


class _RateRing:
    """Rolling numerator/denominator window (accept rate, deadline
    attainment, availability) on the same generation-stamped ring as
    ``_Ring`` — bounded to n_buckets pairs forever."""

    __slots__ = ("window_s", "span", "n_buckets", "_num", "_den",
                 "_gen", "_lock")

    def __init__(self, window_s: float, n_buckets: int = 12):
        self.window_s = float(window_s)
        self.n_buckets = int(n_buckets)
        self.span = self.window_s / self.n_buckets
        self._num = [0] * self.n_buckets
        self._den = [0] * self.n_buckets
        self._gen = [-1] * self.n_buckets
        self._lock = threading.Lock()

    def add(self, now: float, num: int, den: int) -> None:
        g = int(now / self.span)
        i = g % self.n_buckets
        with self._lock:
            if self._gen[i] != g:
                self._gen[i] = g
                self._num[i] = 0
                self._den[i] = 0
            self._num[i] += num
            self._den[i] += den

    def merged(self, now: float):
        g_now = int(now / self.span)
        num = den = 0
        with self._lock:
            for i in range(self.n_buckets):
                g = self._gen[i]
                if g < 0 or g_now - g >= self.n_buckets:
                    continue
                num += self._num[i]
                den += self._den[i]
        return num, den


@dataclass(frozen=True)
class SLOConfig:
    """Declarative service-level objectives.

    ``ttft_p95_ms``/``itl_p99_ms`` are latency thresholds: the
    objective is "at most 5% (resp. 1%) of samples above the
    threshold", so the error budget is that tail fraction.
    ``deadline_attainment``/``availability`` are success-fraction
    floors over finished requests.  ``warn_burn``/``page_burn`` are
    the burn-rate trip points for the WARN and PAGE states."""

    ttft_p95_ms: float = 500.0
    itl_p99_ms: float = 200.0
    deadline_attainment: float = 0.99
    availability: float = 0.999
    warn_burn: float = 1.0
    page_burn: float = 2.0

    def to_dict(self) -> dict:
        return {"ttft_p95_ms": self.ttft_p95_ms,
                "itl_p99_ms": self.itl_p99_ms,
                "deadline_attainment": self.deadline_attainment,
                "availability": self.availability,
                "warn_burn": self.warn_burn,
                "page_burn": self.page_burn}


def evaluate_slo(config, windows: dict) -> dict:
    """Stateless SLO evaluation of one ``windows`` snapshot (the dict
    ``WindowedTelemetry.snapshot()`` builds, or the fleet-pooled one
    from ``aggregate_windows``).  Returns burn rates per objective per
    window plus the folded state — shared by the live ``SLOMonitor``
    and the fleet aggregation path so one replica and a router agree
    on semantics."""
    if not isinstance(config, SLOConfig):
        config = SLOConfig(**{k: v for k, v in dict(config).items()
                              if k in SLOConfig.__dataclass_fields__})
    labels = [k for k in windows if k != "bounds"]
    labels.sort(key=lambda s: float(s[:-1]))
    burn: dict = {}
    for label in labels:
        w = windows[label]
        b: dict = {}
        b["ttft"] = _frac_over(w["ttft"]["buckets"],
                               config.ttft_p95_ms / 1e3) / 0.05
        b["itl"] = _frac_over(w["itl"]["buckets"],
                              config.itl_p99_ms / 1e3) / 0.01
        d = w["deadline"]
        if d["den"]:
            budget = max(1e-9, 1.0 - config.deadline_attainment)
            b["deadline"] = (1.0 - d["num"] / d["den"]) / budget
        a = w["availability"]
        if a["den"]:
            budget = max(1e-9, 1.0 - config.availability)
            b["availability"] = (1.0 - a["num"] / a["den"]) / budget
        b["max"] = max(b.values()) if b else 0.0
        burn[label] = {k: round(v, 4) for k, v in b.items()}
    state = NORMAL
    if labels:
        short = burn[labels[0]]["max"]
        mid = burn[labels[min(1, len(labels) - 1)]]["max"]
        long_ = burn[labels[-1]]["max"]
        if short >= config.page_burn and mid >= config.page_burn:
            state = PAGE
        elif mid >= config.warn_burn or long_ >= config.warn_burn:
            state = WARN
    return {"state": state, "state_name": SLO_STATE_NAMES[state],
            "burn_rates": burn, "config": config.to_dict()}


class SLOMonitor:
    """Stateful wrapper over ``evaluate_slo``: remembers the current
    state, records every transition into a bounded deque, and emits a
    ``slo.transition`` tracer instant when a tracer is armed."""

    TRANSITIONS = 64   # bounded transition history (deque maxlen)

    def __init__(self, config: SLOConfig | None = None, *,
                 tracer=None, track: str | None = None):
        self.config = config or SLOConfig()
        self.state = NORMAL
        self.transitions: deque = deque(maxlen=self.TRANSITIONS)
        self._tracer = tracer
        self._track = track

    def arm_tracer(self, tracer, track: str | None = None) -> None:
        self._tracer = tracer
        self._track = track

    def evaluate(self, windows: dict) -> dict:
        out = evaluate_slo(self.config, windows)
        new = out["state"]
        if new != self.state:
            self.transitions.append((self.state, new))
            tr = self._tracer
            if tr is not None:
                tr.instant("slo.transition", track=self._track,
                           args={"from": SLO_STATE_NAMES[self.state],
                                 "to": SLO_STATE_NAMES[new]})
            self.state = new
        out["transitions"] = len(self.transitions)
        return out


class AnomalyDetector:
    """Robust outlier detector over a rolling sample: a value is
    anomalous when it exceeds median + k*MAD of the recent window
    (median absolute deviation — the estimator outliers cannot drag,
    unlike mean/stddev).  The sample deque is bounded (maxlen), a
    minimum sample count gates cold starts, an absolute floor keeps a
    near-constant stream (MAD ~ 0) from flagging noise, and a cooldown
    bounds the capture rate under sustained misbehaviour."""

    def __init__(self, *, window: int = 256, k: float = 8.0,
                 min_samples: int = 24, floor_s: float = 1e-4,
                 cooldown_s: float = 2.0,
                 clock=time.perf_counter):
        self._recent: deque = deque(maxlen=int(window))
        self.k = float(k)
        self.min_samples = int(min_samples)
        self.floor_s = float(floor_s)
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._last_fire = -1e18
        self.detected = 0          # anomalies seen (incl. cooldown-muted)
        self.last: dict = {}       # forensics of the latest detection

    def observe(self, v: float) -> bool:
        """Feed one value; True when it is an actionable anomaly (past
        threshold AND outside the cooldown)."""
        v = float(v)
        rec = self._recent
        fire = False
        if len(rec) >= self.min_samples:
            s = sorted(rec)
            n = len(s)
            med = s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])
            dev = sorted(abs(x - med) for x in s)
            mad = dev[n // 2] if n % 2 else 0.5 * (dev[n // 2 - 1]
                                                   + dev[n // 2])
            thresh = med + self.k * max(mad, self.floor_s)
            if v > thresh:
                self.detected += 1
                self.last = {"value_s": v, "median_s": med, "mad_s": mad,
                             "threshold_s": thresh}
                now = self._clock()
                if now - self._last_fire >= self.cooldown_s:
                    self._last_fire = now
                    fire = True
        rec.append(v)
        return fire


class AnomalySpool:
    """Bounded on-disk spool of anomaly snapshots.  At most
    ``max_files`` JSON files ever live under ``path``; captures past
    the bound are DROPPED and counted (``dropped``) — the spool tells
    you how much it shed rather than eating the disk."""

    def __init__(self, path, *, max_files: int = 32):
        self.path = os.fspath(path)
        self.max_files = int(max_files)
        os.makedirs(self.path, exist_ok=True)
        self._lock = threading.Lock()
        self._seq = len([f for f in os.listdir(self.path)
                         if f.startswith("anomaly-")])
        self.captured = 0
        self.dropped = 0

    def capture(self, payload: dict) -> str | None:
        """Write one snapshot; returns its path, or None (counted in
        ``dropped``) when the spool is full."""
        with self._lock:
            if self._seq >= self.max_files:
                self.dropped += 1
                return None
            seq = self._seq
            self._seq += 1
        fname = os.path.join(self.path, f"anomaly-{seq:06d}.json")
        with open(fname, "w", encoding="utf-8") as f:
            json.dump(payload, f)
        with self._lock:
            self.captured += 1
        return fname


class WindowedTelemetry:
    """The windowed surface a ``ServingStats`` grows when
    ``enable_windows()`` is called: one ring per (channel, window),
    the SLO monitor, and (when armed) the anomaly capture pipeline.
    Recording is a bisect plus a few list writes under one small lock
    per ring; nothing here allocates per event after construction
    except an anomaly capture itself."""

    def __init__(self, slo: SLOConfig | None = None, *,
                 windows=_WINDOWS, n_buckets: int = 12,
                 tracer=None, track: str | None = None,
                 clock=time.perf_counter):
        self.windows = tuple(float(w) for w in windows)
        self._clock = clock
        self._lat = {ch: {_wlabel(w): _Ring(w, n_buckets)
                          for w in self.windows}
                     for ch in _LATENCY_CHANNELS}
        self._rate = {ch: {_wlabel(w): _RateRing(w, n_buckets)
                           for w in self.windows}
                      for ch in _RATE_CHANNELS}
        self.slo = SLOMonitor(slo, tracer=tracer, track=track)
        # anomaly capture (armed separately; all refs optional)
        self._step_detector: AnomalyDetector | None = None
        self._request_detector: AnomalyDetector | None = None
        self.spool: AnomalySpool | None = None
        self._tracer = tracer
        self._flight = None

    # -- arming -------------------------------------------------------------

    def arm_tracer(self, tracer, track: str | None = None) -> None:
        """Route SLO transitions (and anomaly trace capture) through
        ``tracer`` — typically the small always-on ring the frontend
        keeps when an anomaly spool is configured."""
        self._tracer = tracer
        self.slo.arm_tracer(tracer, track)

    def arm_anomaly(self, *, spool: AnomalySpool | None = None,
                    tracer=None, flight=None,
                    step_detector: AnomalyDetector | None = None,
                    request_detector: AnomalyDetector | None = None,
                    ) -> None:
        """Turn on outlier detection over step durations and request
        latencies; with a spool, each actionable anomaly snapshots the
        current trace window plus the slowest flight records."""
        self._step_detector = step_detector or AnomalyDetector()
        self._request_detector = request_detector or AnomalyDetector()
        self.spool = spool
        if tracer is not None:
            self.arm_tracer(tracer)
        self._flight = flight

    # -- recording ----------------------------------------------------------

    def _add(self, ch: str, v: float, n: int = 1) -> None:
        now = self._clock()
        for ring in self._lat[ch].values():
            ring.add(now, v, n)

    def _add_rate(self, ch: str, num: int, den: int) -> None:
        now = self._clock()
        for ring in self._rate[ch].values():
            ring.add(now, num, den)

    def record_ttft(self, v: float) -> None:
        self._add("ttft", v)

    def record_itl(self, v: float, n: int = 1) -> None:
        self._add("itl", v, n)

    def record_queue_wait(self, v: float) -> None:
        self._add("queue_wait", v)

    def record_accept(self, accepted: int, proposed: int) -> None:
        self._add_rate("accept", int(accepted), int(proposed))

    def record_deadline(self, met: bool) -> None:
        self._add_rate("deadline", 1 if met else 0, 1)

    def record_finish(self, ok: bool) -> None:
        """One finished request: ok=True for natural finishes
        (eos/length), False for errors (quarantine, deadline, abort) —
        the availability objective's sample."""
        self._add_rate("availability", 1 if ok else 0, 1)

    def record_step(self, v: float) -> None:
        self._add("step", v)
        det = self._step_detector
        if det is not None and det.observe(v):
            self._capture("slow_step", det)

    def record_request(self, v: float) -> None:
        """One finished request's total latency (admission to last
        token) — the slow-request anomaly signal."""
        self._add("request", v)
        det = self._request_detector
        if det is not None and det.observe(v):
            self._capture("slow_request", det)

    # -- anomaly capture ----------------------------------------------------

    def anomalies_detected(self) -> int:
        n = 0
        for det in (self._step_detector, self._request_detector):
            if det is not None:
                n += det.detected
        return n

    def _capture(self, kind: str, det: AnomalyDetector) -> None:
        spool = self.spool
        if spool is None:
            return
        payload = {"kind": kind, **det.last}
        tr = self._tracer
        if tr is not None:
            payload["trace"] = tr.chrome_trace()
        fl = self._flight
        if fl is not None:
            payload["flight"] = fl.list(sort="slowest", limit=8)
        spool.capture(payload)

    # -- reading ------------------------------------------------------------

    def snapshot(self, now: float | None = None) -> dict:
        """Per-window view: for each window label, non-cumulative
        bucket counts (on the shared ladder, summable across
        replicas), sum/count, p50/p95/p99 per latency channel, and
        num/den/rate per rate channel."""
        if now is None:
            now = self._clock()
        out: dict = {"bounds": list(_BOUNDS)}
        for w in self.windows:
            label = _wlabel(w)
            wd: dict = {}
            for ch in _LATENCY_CHANNELS:
                counts, total, n = self._lat[ch][label].merged(now)
                wd[ch] = {
                    "buckets": counts, "sum": round(total, 6), "count": n,
                    "p50_ms": round(1e3 * bucket_percentile(counts, 50), 3),
                    "p95_ms": round(1e3 * bucket_percentile(counts, 95), 3),
                    "p99_ms": round(1e3 * bucket_percentile(counts, 99), 3),
                }
            for ch in _RATE_CHANNELS:
                num, den = self._rate[ch][label].merged(now)
                wd[ch] = {"num": num, "den": den,
                          "rate": round(num / den, 4) if den else 0.0}
            out[label] = wd
        return out

    def snapshot_keys(self) -> dict:
        """The keys ``ServingStats.snapshot()`` merges in when windows
        are enabled: the nested per-window dict, the SLO evaluation,
        headline flat scalars, and the anomaly counters."""
        ws = self.snapshot()
        ev = self.slo.evaluate(ws)
        mid = _wlabel(self.windows[min(1, len(self.windows) - 1)])
        spool = self.spool
        return {
            "windows": ws,
            "slo": ev,
            "slo_state": ev["state"],
            "slo_state_name": ev["state_name"],
            "ttft_p95_w60s": ws[mid]["ttft"]["p95_ms"],
            "itl_p99_w60s": ws[mid]["itl"]["p99_ms"],
            "queue_wait_p95_w60s": ws[mid]["queue_wait"]["p95_ms"],
            "anomalies_detected": self.anomalies_detected(),
            "anomalies_captured": spool.captured if spool else 0,
            "anomaly_spool_dropped": spool.dropped if spool else 0,
        }


def aggregate_windows(window_snapshots) -> dict:
    """Pool per-replica ``WindowedTelemetry.snapshot()`` dicts into one
    fleet view: bucket counts sum index-by-index per (window, channel)
    — identical ladders make this exact — sums/counts add, rate
    channels add num/den, and percentiles are recomputed from the
    POOLED distribution (honest fleet quantiles, not max-of-replicas).
    """
    snaps = [w for w in window_snapshots if w]
    if not snaps:
        return {}
    out: dict = {"bounds": list(snaps[0]["bounds"])}
    labels = [k for k in snaps[0] if k != "bounds"]
    for label in labels:
        wd: dict = {}
        for ch in _LATENCY_CHANNELS:
            nb = len(snaps[0]["bounds"]) + 1
            counts = [0] * nb
            total = 0.0
            n = 0
            for s in snaps:
                c = s.get(label, {}).get(ch)
                if not c:
                    continue
                for j, cj in enumerate(c["buckets"]):
                    counts[j] += cj
                total += c["sum"]
                n += c["count"]
            wd[ch] = {
                "buckets": counts, "sum": round(total, 6), "count": n,
                "p50_ms": round(1e3 * bucket_percentile(counts, 50), 3),
                "p95_ms": round(1e3 * bucket_percentile(counts, 95), 3),
                "p99_ms": round(1e3 * bucket_percentile(counts, 99), 3),
            }
        for ch in _RATE_CHANNELS:
            num = den = 0
            for s in snaps:
                c = s.get(label, {}).get(ch)
                if not c:
                    continue
                num += c["num"]
                den += c["den"]
            wd[ch] = {"num": num, "den": den,
                      "rate": round(num / den, 4) if den else 0.0}
        out[label] = wd
    return out
