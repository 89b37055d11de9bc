"""Global random state (counterpart of paddle_tpu/core/random_state.py).

One explicit ``torch.Generator`` a device, all seeded by ``seed``; every
draw of the port names its generator, and nothing draws from torch's
global generator.  The JAX package keeps a threefry key chain instead, so
draws differ between the packages: weights cross over by state dict.
``jit.capture_step`` registers the card's generator with its CUDA graph,
so draws inside a captured step advance across replays.
"""
from __future__ import annotations

import os
import threading

import torch

__all__ = ["seed", "get_seed", "generator", "get_rng_state",
           "set_rng_state"]

_lock = threading.Lock()
_state = {"seed": None}
_gens: dict[str, torch.Generator] = {}


def _dev_key(device) -> str:
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return str(d)


def seed(value: int):
    """Seed every device's generator (present and future) with value."""
    with _lock:
        _state["seed"] = int(value)
        for g in _gens.values():
            g.manual_seed(int(value))
    return value


def get_seed():
    return _state["seed"]


def generator(device) -> torch.Generator:
    """The generator of ``device``, made (and seeded) on first use."""
    key = _dev_key(device)
    g = _gens.get(key)
    if g is None:
        with _lock:
            g = _gens.get(key)
            if g is None:
                g = torch.Generator(device=key)
                s = _state["seed"]
                g.manual_seed(s if s is not None else
                              int.from_bytes(os.urandom(4), "little"))
                _gens[key] = g
    return g


def get_rng_state():
    with _lock:
        return ({k: g.get_state() for k, g in _gens.items()},
                _state["seed"])


def set_rng_state(state):
    """Put back a get_rng_state() result.  A generator made after it was
    taken starts again from the seed it was made from."""
    states, sd = state
    with _lock:
        _state["seed"] = sd
        later = [g for k, g in _gens.items() if k not in states]
    for k, st in states.items():
        generator(k).set_state(st)
    if sd is not None:
        for g in later:
            g.manual_seed(sd)
