"""Persistent kernel-tuning cache + the launch-time lookup helper
(counterpart of paddle_tpu/tune/cache.py; the same file format, keys and
environment variables, so a cache written by either package loads in the
other).

The cache is one JSON file of winners keyed by
``device kind | kernel name | shape-bucket signature``.  Kernel wrappers
consult it through :func:`kernel_config` at the first launch of a shape
and keep the answer (``config_epoch`` says when to look again), so no
launch reads a file.  Resolution walks a fixed fallback chain:

1. forced config (``PADDLE_TPU_TUNE_FORCE`` -- the sweep worker's lever);
2. deprecated env overrides registered for the kernel (e.g. the old
   ``PADDLE_TPU_FA_BLOCK_Q`` lever -- honored, with a DeprecationWarning);
3. exact cache key for this device + kernel + shape bucket;
4. nearest bucket for this device + kernel (numeric fields may differ,
   non-numeric fields -- dtype -- must match);
5. the kernel's built-in defaults (its rule at this shape).

A corrupt or missing cache file degrades to an empty cache (warn once):
tuning must never be able to take serving down.
"""
from __future__ import annotations

import json
import math
import os
import threading
import warnings

__all__ = [
    "TuningCache", "bucket_signature", "device_kind", "cache_path",
    "set_cache_path", "current_cache", "kernel_config",
    "kernel_config_with_meta", "provenance_snapshot", "reset_provenance",
    "config_epoch",
]

_ENV_CACHE_PATH = "PADDLE_TPU_TUNE_CACHE"
_ENV_FORCE = "PADDLE_TPU_TUNE_FORCE"


def _default_path() -> str:
    return os.path.join(os.path.expanduser("~"), ".cache", "paddle_tpu",
                        "tuning_cache.json")


def device_kind() -> str:
    """Canonical device key for cache entries: the CUDA card's name
    lower-cased with spaces as dashes ('nvidia-h100-80gb-hbm3'), 'cpu'
    without CUDA."""
    try:
        import torch
        kind = torch.cuda.get_device_name() if torch.cuda.is_available() \
            else "cpu"
    except Exception:
        kind = "cpu"
    return str(kind).strip().lower().replace(" ", "-")


def _bucket(v):
    """Pow2 bucket for ints (shape dims); everything else verbatim."""
    if isinstance(v, bool) or not isinstance(v, int):
        return v
    if v <= 1:
        return v
    return 1 << (v - 1).bit_length()


def bucket_signature(shape_key: dict) -> str:
    """Canonical bucketed signature: sorted ``field=value`` pairs with
    integer fields rounded up to a power of two, so near-identical shapes
    share one tuning entry instead of fragmenting the cache."""
    parts = []
    for k in sorted(shape_key):
        parts.append(f"{k}={_bucket(shape_key[k])}")
    return ",".join(parts)


def _parse_sig(sig: str) -> dict:
    out = {}
    for part in sig.split(","):
        if "=" not in part:
            continue
        k, v = part.split("=", 1)
        try:
            out[k] = int(v)
        except ValueError:
            out[k] = v
    return out


def _sig_distance(a: str, b: str):
    """Bucket distance between two signatures, or None when incomparable
    (different field sets or mismatched non-numeric fields)."""
    da, db = _parse_sig(a), _parse_sig(b)
    if set(da) != set(db):
        return None
    dist = 0.0
    for k, va in da.items():
        vb = db[k]
        if isinstance(va, int) and isinstance(vb, int):
            dist += abs(math.log2(va + 1) - math.log2(vb + 1))
        elif va != vb:
            return None
    return dist


class TuningCache:
    """One JSON file of tuning winners; loads lazily, saves atomically."""

    VERSION = 1

    def __init__(self, path: str | None = None):
        self.path = path or _default_path()
        self._entries: dict = {}
        self._loaded = False
        self._load_error: str | None = None
        self._lock = threading.Lock()

    # -- persistence --------------------------------------------------------

    def _ensure_loaded(self) -> None:
        if self._loaded:
            return
        with self._lock:
            if self._loaded:
                return
            self._entries = {}
            if os.path.exists(self.path):
                try:
                    doc = json.load(open(self.path))
                    entries = doc["entries"]
                    if not isinstance(entries, dict):
                        raise TypeError("entries must be a dict")
                    for key, rec in entries.items():
                        if isinstance(rec, dict) and \
                                isinstance(rec.get("config"), dict):
                            self._entries[str(key)] = rec
                except Exception as e:
                    # corrupt cache == empty cache: every lookup falls
                    # back to defaults rather than failing a launch
                    self._load_error = f"{type(e).__name__}: {e}"
                    warnings.warn(
                        f"tuning cache {self.path!r} is unreadable "
                        f"({self._load_error}); using built-in defaults",
                        RuntimeWarning, stacklevel=3)
            self._loaded = True

    def save(self, path: str | None = None) -> str:
        """Atomic write (tmp + os.replace): a mid-write crash must not
        truncate a cache other processes consult."""
        self._ensure_loaded()
        path = path or self.path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        doc = {"version": self.VERSION, "entries": self._entries}
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
        return path

    # -- entries ------------------------------------------------------------

    @staticmethod
    def key(device: str, kernel: str, sig: str) -> str:
        return f"{device}|{kernel}|{sig}"

    def put(self, device: str, kernel: str, sig: str, config: dict, *,
            score_s: float | None = None, measure: str = "") -> None:
        global _EPOCH
        self._ensure_loaded()
        _EPOCH += 1               # launches look their shapes up again
        rec = {"config": dict(config)}
        if score_s is not None:
            rec["score_s"] = float(score_s)
        if measure:
            rec["measure"] = measure
        self._entries[self.key(device, kernel, sig)] = rec

    def lookup(self, device: str, kernel: str, sig: str):
        """Exact entry for this (device, kernel, bucket) or None."""
        self._ensure_loaded()
        rec = self._entries.get(self.key(device, kernel, sig))
        return dict(rec["config"]) if rec else None

    def nearest(self, device: str, kernel: str, sig: str):
        """Closest same-device same-kernel bucket: (config, sig) or None.
        Numeric fields compare by log2 distance; non-numeric fields
        (dtype) must match exactly — a bf16 winner never configures an
        f32 launch."""
        self._ensure_loaded()
        prefix = f"{device}|{kernel}|"
        best = None
        for key, rec in self._entries.items():
            if not key.startswith(prefix):
                continue
            cand_sig = key[len(prefix):]
            d = _sig_distance(sig, cand_sig)
            if d is None:
                continue
            if best is None or (d, cand_sig) < (best[0], best[2]):
                best = (d, dict(rec["config"]), cand_sig)
        if best is None:
            return None
        return best[1], best[2]

    def kernels(self, device: str | None = None) -> set:
        """Kernel names with at least one entry (optionally per device)."""
        self._ensure_loaded()
        out = set()
        for key in self._entries:
            dev, kern, _ = key.split("|", 2)
            if device is None or dev == device:
                out.add(kern)
        return out

    def __len__(self) -> int:
        self._ensure_loaded()
        return len(self._entries)


# ---------------------------------------------------------------------------
# process-wide cache singleton + provenance ledger
# ---------------------------------------------------------------------------

_EXPLICIT_PATH: str | None = None
_CACHE: TuningCache | None = None
_CACHE_LOCK = threading.Lock()

# kernel -> {"hits", "misses", "source", "config", "key"}; the autotuner
# and LLMEngine.summary() render snapshots of this
_PROVENANCE: dict = {}

# bumped whenever a lookup may answer differently (a new path, a new
# entry); part of ``config_epoch``
_EPOCH = 0

# deprecated env vars already warned about (tests clear this to re-arm)
_ENV_WARNED: set = set()


def cache_path() -> str:
    """Resolved cache path: explicit set_cache_path() wins, then the
    PADDLE_TPU_TUNE_CACHE env var, then the per-user default."""
    if _EXPLICIT_PATH is not None:
        return _EXPLICIT_PATH
    return os.environ.get(_ENV_CACHE_PATH) or _default_path()


def set_cache_path(path: str | None) -> None:
    """Point the process at a different tuning cache (None = back to the
    env/default resolution).  Resets the loaded singleton so the next
    lookup reads the new file."""
    global _EXPLICIT_PATH, _CACHE, _EPOCH
    with _CACHE_LOCK:
        _EXPLICIT_PATH = path
        _CACHE = None
        _EPOCH += 1


def current_cache() -> TuningCache:
    """The process-wide cache for the currently-resolved path.  A path
    change (set_cache_path or env var) swaps in a fresh instance."""
    global _CACHE
    path = cache_path()
    with _CACHE_LOCK:
        if _CACHE is None or _CACHE.path != path:
            _CACHE = TuningCache(path)
        return _CACHE


def reset_provenance() -> None:
    _PROVENANCE.clear()


def config_epoch() -> tuple:
    """What a lookup's answer depends on besides its kernel and shape: the
    cache path, the forced config, the registered env levers and a counter
    of new paths and entries.  Wrappers key their kept answers on it, so
    a launch reads no file and still sees a changed cache or lever."""
    from .registry import all_kernels
    env = os.environ
    return (_EPOCH, _EXPLICIT_PATH, env.get(_ENV_CACHE_PATH),
            env.get(_ENV_FORCE),
            tuple(env.get(v) for k in all_kernels()
                  for v in k.env_overrides.values()))


def provenance_snapshot() -> dict:
    """Copy of the process-wide lookup ledger: which cache was consulted
    and, per kernel, hit/miss counts plus the config last chosen."""
    return {
        "path": cache_path(),
        "device": device_kind(),
        "kernels": {k: dict(v) for k, v in _PROVENANCE.items()},
    }


def _record(kernel: str, source: str, config: dict, sig: str) -> None:
    slot = _PROVENANCE.setdefault(
        kernel, {"hits": 0, "misses": 0, "source": "", "config": {},
                 "key": ""})
    if source in ("exact", "bucket"):
        slot["hits"] += 1
    else:
        slot["misses"] += 1
    slot["source"] = source
    slot["config"] = dict(config)
    slot["key"] = sig


def _forced_config(kernel: str):
    raw = os.environ.get(_ENV_FORCE)
    if not raw:
        return None
    try:
        doc = json.loads(raw)
        cfg = doc.get(kernel)
        return dict(cfg) if isinstance(cfg, dict) else None
    except Exception:
        return None


def _env_overrides(kernel: str) -> dict:
    """Deprecated per-kernel env levers (registry-declared).  Still win
    over the cache so existing sweep scripts keep steering geometry, but
    each variable warns once per process."""
    from .registry import get_kernel
    reg = get_kernel(kernel)
    if reg is None or not reg.env_overrides:
        return {}
    out = {}
    for param, var in reg.env_overrides.items():
        raw = os.environ.get(var)
        if raw is None:
            continue
        try:
            out[param] = int(raw)
        except ValueError:
            continue
        if var not in _ENV_WARNED:
            _ENV_WARNED.add(var)
            warnings.warn(
                f"{var} is deprecated; write a tuning-cache entry instead "
                "(tools/perf/torch_autotune.py) or set PADDLE_TPU_TUNE_FORCE",
                DeprecationWarning, stacklevel=4)
    return out


def kernel_config_with_meta(name: str, shape_key: dict,
                            defaults: dict | None = None):
    """Resolve a kernel's launch geometry and say where it came from.

    Returns ``(config, meta)`` where meta carries ``source`` (forced /
    env / exact / bucket / default), ``hit`` (source was a cache entry),
    ``key`` (the bucket signature queried) and ``matched`` (the entry's
    signature when a bucket fallback answered).
    """
    from .registry import defaults_for, get_kernel
    reg = get_kernel(name)
    base = defaults_for(reg, shape_key) if reg is not None else {}
    if defaults:
        base.update(defaults)
    sig = bucket_signature(shape_key)
    dev = device_kind()

    forced = _forced_config(name)
    env = _env_overrides(name)
    source, matched = "default", sig
    config = dict(base)
    if forced is not None:
        config.update(forced)
        source = "forced"
    else:
        cache = current_cache()
        found = cache.lookup(dev, name, sig)
        if found is not None:
            config.update(found)
            source = "exact"
        else:
            near = cache.nearest(dev, name, sig)
            if near is not None:
                config.update(near[0])
                source, matched = "bucket", near[1]
        if env:
            config.update(env)
            source = "env"
    meta = {"source": source, "hit": source in ("exact", "bucket"),
            "key": sig, "matched": matched, "device": dev}
    _record(name, source, config, sig)
    return config, meta


def kernel_config(name: str, shape_key: dict,
                  defaults: dict | None = None) -> dict:
    """THE lookup helper every CUDA launch's plan must flow from
    (``search.untuned_launch_report`` checks paddle_tpu_torch/ops for
    it).  A host-side dict read; wrappers keep its answer per shape."""
    config, _ = kernel_config_with_meta(name, shape_key, defaults)
    return config
