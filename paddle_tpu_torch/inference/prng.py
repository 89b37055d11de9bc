"""Threefry-2x32 keys and draws in torch integer ops, bit-equal to
``jax.random``'s default generator (``threefry2x32`` with
``jax_threefry_partitionable`` on, 32-bit mode).

A key is a pair of 32-bit words ``(k1, k2)``; here it is an int64 tensor
of shape ``[..., 2]`` holding values in ``[0, 2**32)``, on any device.
Every word is kept in int64 and masked to 32 bits after each add and
shift, so the arithmetic is exact on every backend torch has.

* ``prng_key(seed)``: ``jax.random.PRNGKey(seed)``, i.e. ``(0, seed mod
  2**32)`` (the 32-bit mode drops a seed's high word).
* ``fold_in(key, data)``: ``threefry2x32(key, (0, data))``.
* ``split(key, num)``: key ``i`` is ``threefry2x32(key, (0, i))``.
* ``random_bits(key, n)``: element ``i`` of a draw of ``n`` words is
  ``x1 ^ x2`` of ``threefry2x32(key, (0, i))`` -- the partitionable
  counter layout, in which a ``[B, V]`` draw counts its flat index.
* ``uniform(key, n)``: the mantissa of ``bits >> 9`` ORed with the bits of
  1.0, minus 1.0, mapped to ``[tiny, 1)`` as ``jax.random.uniform(minval=
  tiny, maxval=1)`` does (``minval=0.0``: ``jax.random.uniform``'s
  default range ``[0, 1)``).
* ``gumbel(key, n)``: ``-log(-log(uniform))``, and ``categorical(key,
  logits)`` the argmax of ``gumbel + logits`` over the last axis.

The integer stages and the uniform floats are bit-equal to JAX's; the
Gumbel noise is within 2 ulp of it at the magnitude ``max(|g|, 1)``,
since torch and XLA round ``log`` apart (each within an ulp of exact).
"""
from __future__ import annotations

import threading

import numpy as np
import torch

__all__ = ["threefry2x32", "prng_key", "fold_in", "split", "request_key",
           "random_bits", "uniform", "gumbel", "categorical"]

_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = float(np.finfo(np.float32).tiny)


def _rotl(x, r):
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of the counter words ``(x1,
    x2)`` under key ``(k1, k2)``; all four broadcast together, int64
    tensors (or Python ints) of 32-bit values.  Returns the two output
    words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x1, x2


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` as an int64 ``[2]`` tensor."""
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64,
                        device=device)


def _words(key):
    key = torch.as_tensor(key).to(torch.int64)
    return key[..., 0], key[..., 1]


def fold_in(key, data) -> torch.Tensor:
    """``jax.random.fold_in``: key(s) ``[..., 2]`` with the 32-bit
    ``data`` (an int or a tensor broadcasting against the keys)."""
    k1, k2 = _words(key)
    d = torch.as_tensor(data, dtype=torch.int64, device=k1.device) & _MASK
    y1, y2 = threefry2x32(k1, k2, torch.zeros_like(d), d)
    return torch.stack([y1, y2], -1)


def split(key, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: ``[num, 2]`` keys."""
    k1, k2 = _words(key)
    i = torch.arange(num, dtype=torch.int64, device=k1.device)
    y1, y2 = threefry2x32(k1, k2, torch.zeros_like(i), i)
    return torch.stack([y1, y2], -1)


def request_key(seed: int, index: int) -> np.ndarray:
    """``fold_in(PRNGKey(seed), index)`` as a host ``[2]`` uint32 array,
    computed on Python ints (the engine makes one per sampled row and
    step, so no tensor is involved)."""
    y = threefry2x32(0, int(seed) & _MASK, 0, int(index) & _MASK)
    return np.asarray(y, np.uint32)


def random_bits(key, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,))`` as int64 values in ``[0, 2**32)``;
    keys ``[..., 2]`` give ``[..., n]``, one draw per key."""
    k1, k2 = _words(key)
    i = torch.arange(n, dtype=torch.int64, device=k1.device)
    y1, y2 = threefry2x32(k1[..., None], k2[..., None], torch.zeros_like(i),
                          i)
    return y1 ^ y2


def uniform(key, n: int, minval: float = _TINY) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), minval=minval, maxval=1)`` in f32,
    for ``minval`` tiny (the Gumbel draw's) or 0.0."""
    bits = (random_bits(key, n) >> 9) | 0x3F800000
    f = bits.to(torch.int32).view(torch.float32) - 1.0
    # maxval - minval is 1.0 in f32 for both, so this is f + minval,
    # clamped to minval
    return torch.clamp_min(f + minval, minval)


def gumbel(key, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,))`` (low-dynamic-range mode) in f32."""
    return -torch.log(-torch.log(uniform(key, n)))


# gumbel(key, n) as a CUDA graph, by (key shape, n, device): the hash is
# about 170 elementwise ops, whose launches would cost the host more than
# the card's work.  One graph, key buffer and output buffer serve every
# thread: the lock holds the key copy, the replay and the caller's use of
# the output together, and each replay waits on the card for the last
# use of that output (``_GRAPHS`` entry [3]), so two stepping threads (a
# router's replicas) never read each other's noise.
_GRAPHS: dict = {}
_GRAPHS_LOCK = threading.Lock()


def _gumbel_graphed(key, n: int) -> tuple:
    """``gumbel(key, n)`` for a key on a CUDA device, replayed from a graph
    captured at its first call: one launch for the host, the same kernels
    on the card.  Call with ``_GRAPHS_LOCK`` held.  Returns (the graph's
    output buffer, overwritten by the next replay of the same signature,
    and the signature), for ``categorical`` to mark the buffer used."""
    sig = (tuple(key.shape), n, key.device)
    if sig not in _GRAPHS:
        static = torch.zeros_like(key)
        with torch.cuda.device(key.device):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                gumbel(static, n)            # warm up outside the capture
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                out = gumbel(static, n)
        _GRAPHS[sig] = [graph, static, out, None]
    graph, static, out, used = _GRAPHS[sig]
    if used is not None:
        # the previous caller may have used the output on another stream
        torch.cuda.current_stream(key.device).wait_event(used)
    static.copy_(key)
    graph.replay()
    return out, sig


def categorical(key, logits) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis=-1)``: one draw per row
    of ``logits [..., V]`` by the Gumbel-max rule.  One key draws noise
    over the whole array in flat order (as JAX does for a ``[B, V]``
    call); keys ``[B, 2]`` with ``logits [B, V]`` draw row ``b`` from key
    ``b`` (as ``vmap`` of the single-row call does)."""
    key = torch.as_tensor(key).to(logits.device, torch.int64)
    shape = logits.shape
    n = int(np.prod(shape)) if key.dim() == 1 else shape[-1]
    if not logits.is_cuda:
        return torch.argmax(gumbel(key, n).view(shape) + logits.float(),
                            dim=-1)
    with _GRAPHS_LOCK:
        g, sig = _gumbel_graphed(key, n)
        pick = torch.argmax(g.view(shape) + logits.float(), dim=-1)
        used = torch.cuda.Event()
        used.record(torch.cuda.current_stream(logits.device))
        _GRAPHS[sig][3] = used
    return pick
