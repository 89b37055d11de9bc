"""Runtime flag registry (counterpart of paddle_tpu/core/flags.py).

Flags are typed, documented, overridable from the environment
(``FLAGS_<name>``, read when the flag is defined) and introspectable.  The
defaults are the JAX package's.  The JAX package mirrors its registry into
a native store (its ``csrc/``); the port keeps the Python registry only.
"""
from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Any, Callable

__all__ = ["define_flag", "set_flags", "get_flags", "get_flag", "flag_names"]

_lock = threading.Lock()


@dataclass
class _Flag:
    name: str
    default: Any
    type: type
    help: str
    value: Any
    on_change: Callable[[Any], None] | None = None


_registry: dict[str, _Flag] = {}


def _coerce(value, typ):
    if typ is bool and isinstance(value, str):
        return value.lower() in ("1", "true", "yes", "on")
    return typ(value)


def define_flag(name: str, default, help: str = "", type_: type | None = None,
                on_change: Callable[[Any], None] | None = None):
    typ = type_ or type(default)
    env = os.environ.get(f"FLAGS_{name}")
    value = _coerce(env, typ) if env is not None else default
    with _lock:
        _registry[name] = _Flag(name, default, typ, help, value, on_change)
    return value


def _key(name):
    return name[len("FLAGS_"):] if name.startswith("FLAGS_") else name


def set_flags(flags: dict):
    with _lock:
        for name, value in flags.items():
            key = _key(name)
            if key not in _registry:
                raise ValueError(f"Unknown flag: {name}")
            f = _registry[key]
            f.value = _coerce(value, f.type)
            if f.on_change is not None:
                f.on_change(f.value)


def get_flags(flags=None) -> dict:
    with _lock:
        if flags is None:
            names = list(_registry)
        elif isinstance(flags, str):
            names = [flags]
        else:
            names = list(flags)
        out = {}
        for name in names:
            key = _key(name)
            if key not in _registry:
                raise ValueError(f"Unknown flag: {name}")
            out[name] = _registry[key].value
        return out


def get_flag(name: str):
    with _lock:
        return _registry[name].value


def flag_names():
    with _lock:
        return sorted(_registry)


define_flag("v", 0, "GLOG-style verbosity for framework vlog messages "
            "(higher = chattier; GLOG_v env also honored).")
define_flag("check_nan_inf", False,
            "Check outputs of every op for NaN/Inf (debug).")
define_flag("check_nan_inf_level", 0,
            "0: error on nan/inf; >0 softer reporting levels.")
define_flag("eager_compile_cache_size", 4096,
            "Max cached compiled single-op executables (kept for parity; "
            "eager torch ops compile nothing).")
define_flag("benchmark", False, "Synchronize after each op for timing "
            "(debug).")
define_flag("use_pallas_kernels", True,
            "Kept for parity with the JAX package, where it stands in for a "
            "lowering probe; the port's routing does not read it (the "
            "Hopper kernels take every shape their rules admit).")
define_flag("log_compiles", False, "Log kernel builds.")
define_flag("comm_watchdog_timeout", 0.0,
            "Seconds before an in-flight eager collective is reported as "
            "hung by the comm watchdog (0 disables).")
define_flag("analysis_mode", os.environ.get("PT_ANALYSIS", "off"),
            "static-analysis enforcement: 'off', 'warn' or 'strict'. "
            "Default comes from the PT_ANALYSIS env var; "
            "FLAGS_analysis_mode / set_flags override it.")
