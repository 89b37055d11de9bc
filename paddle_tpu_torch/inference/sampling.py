"""Logit-processor chain and per-row sampling for the serving step
(counterpart of paddle_tpu/inference/sampling.py).

The chain order mirrors ``LlamaForCausalLM.generate``:

    repetition penalty (CTRL rule) -> [greedy rows: argmax here]
    -> temperature -> top-k -> top-p -> categorical

Per-sequence parameters ride in a ``samp`` dict of batch-wide host
arrays (``make_samp``), so one step serves any mix of greedy and sampled
requests:

    temps   [B] f32   (<= 0 -> greedy argmax, generate()-compatible)
    top_k   [B] i32   (0 -> off)
    top_p   [B] f32   (1.0 -> off; top token always kept)
    penalty [B] f32   (1.0 -> off)
    seen    [B,V] bool (prompt + generated token mask for the penalty)
    keys    [B,2] u32  threefry key of each sampled row's draw

A sampled row draws with ``jax.random.categorical``'s Gumbel-max rule
from its key (``prng.py``), which the engine makes as the JAX package's
does: ``fold_in(PRNGKey(seed), token index)``.  So a request's stream
depends on (seed, index) alone -- reproducible across scheduling orders
and preemptions -- and equals the JAX engine's token for token.

Two entries share one sampler body.  ``sample_tokens`` takes the host
``samp`` of a per-step launch: it decides on the host which rows sample
and whether any row has a penalty, and uploads only what the launch
needs.  The device-resident decode window takes those decisions once at
dispatch, uploads ``samp`` once (``samp_to_device``) and calls
``sample_tokens_device`` every iteration with keys from ``advance_keys``
and a ``seen`` mask it updates on the card.  Both give the same bits.

A chain may also hold stages written to the JAX package's interface,
``proc(lg, samp, xp)`` over numpy or ``jnp`` arrays (``is_reference_stage``
says which).  ``target_dist`` calls them as ``proc(lg, samp, np)``, as the
reference's host path does; ``sample_tokens`` runs a chain that holds one
on the host through numpy (the logits copied out, the processed ones in);
``sample_tokens_device`` refuses one, since the window calls it every
iteration and must not read the host.
"""
from __future__ import annotations

import numpy as np
import torch

from . import prng

__all__ = [
    "LogitProcessor", "RepetitionPenaltyProcessor", "TemperatureProcessor",
    "TopKProcessor", "TopPProcessor", "DEFAULT_CHAIN", "make_samp",
    "sampling_plan", "samp_to_device", "advance_keys", "sample_tokens",
    "sample_tokens_device", "target_dist", "is_reference_stage",
]

_NEG_INF = float("-inf")


def _softmax(lg):
    """Softmax over the last axis of a host array (``target_dist``'s)."""
    m = np.max(lg, axis=-1, keepdims=True)
    e = np.exp(lg - m)
    return e / np.sum(e, axis=-1, keepdims=True)


class LogitProcessor:
    """One stage of the chain: ``(lg [B,V] f32, samp) -> lg``, with samp
    holding tensors on lg's device; ``host(lg, samp)`` is the same stage
    over numpy arrays (``target_dist``).

    ``greedy_visible`` stages apply before the greedy/sampled split --
    greedy rows argmax their output; the rest only shape the sampled
    distribution.

    The rule that tells a stage of this form from one written to the JAX
    package's interface (``__call__(self, lg, samp, xp)``, no ``host``):
    a stage is of this form exactly when its class defines ``host`` other
    than as this base class does (``is_reference_stage`` is the negation).
    """

    greedy_visible = False

    def __call__(self, lg, samp):  # pragma: no cover - interface
        raise NotImplementedError

    def host(self, lg, samp):  # pragma: no cover - interface
        raise NotImplementedError


class RepetitionPenaltyProcessor(LogitProcessor):
    """CTRL rule: logits of seen tokens divide by the penalty when
    positive, multiply when negative.  penalty == 1.0 is the identity."""

    greedy_visible = True

    def __call__(self, lg, samp):
        pen = samp["penalty"][:, None]
        pl = torch.where(lg > 0, lg / pen, lg * pen)
        return torch.where(samp["seen"] & (pen != 1.0), pl, lg)

    def host(self, lg, samp):
        pen = samp["penalty"][:, None]
        pl = np.where(lg > 0, lg / pen, lg * pen)
        return np.where(samp["seen"] & (pen != 1.0), pl, lg)


class TemperatureProcessor(LogitProcessor):
    def __call__(self, lg, samp):
        return lg / torch.clamp(samp["temps"], min=1e-6)[:, None]

    def host(self, lg, samp):
        return lg / np.maximum(samp["temps"], 1e-6)[:, None]


class TopKProcessor(LogitProcessor):
    """Keep each row's top_k logits (ties at the k-th value survive);
    top_k == 0 disables the stage for the row."""

    def __call__(self, lg, samp):
        k = samp["top_k"].long()
        V = lg.shape[-1]
        srt = torch.sort(lg, dim=-1, descending=True).values
        idx = torch.clamp(k - 1, 0, V - 1)
        kth = torch.gather(srt, -1, idx[:, None])
        return torch.where((k > 0)[:, None] & (lg < kth), _NEG_INF, lg)

    def host(self, lg, samp):
        k = samp["top_k"]
        V = lg.shape[-1]
        srt = -np.sort(-lg, axis=-1)                       # descending
        idx = np.clip(k - 1, 0, V - 1).astype(np.int32)
        kth = np.take_along_axis(srt, idx[:, None], axis=-1)
        return np.where((k > 0)[:, None] & (lg < kth), _NEG_INF, lg)


class TopPProcessor(LogitProcessor):
    """Nucleus sampling: smallest prefix of the sorted distribution with
    mass >= top_p (the top token is always kept); top_p >= 1.0 keeps
    every token, disabling the stage for the row."""

    def __call__(self, lg, samp):
        p = samp["top_p"]
        order = torch.argsort(-lg, dim=-1, stable=True)
        srt = torch.gather(lg, -1, order)
        m = torch.max(srt, dim=-1, keepdim=True).values
        e = torch.exp(srt - m)
        sp = e / torch.sum(e, dim=-1, keepdim=True)
        cum = torch.cumsum(sp, dim=-1)
        keep_sorted = cum - sp <= p[:, None]               # top always kept
        keep = torch.empty_like(keep_sorted).scatter_(-1, order, keep_sorted)
        return torch.where(keep, lg, _NEG_INF)

    def host(self, lg, samp):
        p = samp["top_p"]
        order = np.argsort(-lg, axis=-1, kind="stable")
        srt = np.take_along_axis(lg, order, axis=-1)
        sp = _softmax(srt)
        cum = np.cumsum(sp, axis=-1)
        keep_sorted = cum - sp <= p[:, None]               # top always kept
        inv = np.argsort(order, axis=-1, kind="stable")
        keep = np.take_along_axis(keep_sorted, inv, axis=-1)
        return np.where(keep, lg, _NEG_INF)


DEFAULT_CHAIN = (RepetitionPenaltyProcessor(), TemperatureProcessor(),
                 TopKProcessor(), TopPProcessor())


def is_reference_stage(proc) -> bool:
    """True when ``proc`` is written to the JAX package's interface,
    ``proc(lg, samp, xp)``: its class defines no ``host`` of its own
    (none at all, or ``LogitProcessor``'s)."""
    host = getattr(type(proc), "host", None)
    return host is None or host is LogitProcessor.host


def _host_stage(proc, lg, samp):
    """One stage over numpy arrays, in the form its interface takes."""
    if is_reference_stage(proc):
        return proc(lg, samp, np)
    return proc.host(lg, samp)


def make_samp(B: int, V: int) -> dict:
    """Host-side samp arrays at their 'off' defaults (greedy, no
    penalty/truncation) -- the engine mutates rows in place per slot."""
    return {
        "temps": np.zeros((B,), np.float32),
        "top_k": np.zeros((B,), np.int32),
        "top_p": np.ones((B,), np.float32),
        "penalty": np.ones((B,), np.float32),
        "seen": np.zeros((B, V), bool),
        "keys": np.zeros((B, 2), np.uint32),
    }


def _to_device(a, device) -> torch.Tensor:
    """A host array on ``device``: on a CUDA device through pinned memory
    and a non-blocking copy (a copy from pageable memory would make the
    host wait for the stream to reach it); on the CPU, the array itself."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def sampling_plan(samp):
    """The host's two decisions for a launch: the rows that sample (int64
    indices, temps > 0) and whether any row has a repetition penalty
    (else the penalty stage, an identity at 1.0, is left out)."""
    rows = np.nonzero(np.asarray(samp["temps"]) > 0.0)[0]
    return rows, bool((np.asarray(samp["penalty"]) != 1.0).any())


def samp_to_device(samp, device, needs_penalty: bool) -> dict:
    """The stage parameters of ``samp`` on ``device`` (``seen`` only when a
    penalty applies).  Keys are not among them: the caller passes the
    sampled rows' keys to ``sample_tokens_device``."""
    names = ("temps", "top_k", "top_p", "penalty") \
        + (("seen",) if needs_penalty else ())
    return {k: _to_device(samp[k], device) for k in names}


def advance_keys(base_keys, offsets):
    """Sampler keys carried through the device-resident decode window:
    ``fold_in(base, offset)`` row by row, base_keys ``[B, 2]`` (each row's
    ``PRNGKey(seed)``) and offsets ``[B]`` (its generated-token count) on
    the card.  The per-step path makes the same key on the host
    (``prng.request_key(seed, index)``), so any K-window slicing of a
    stream draws from the same keys."""
    return prng.fold_in(base_keys, offsets)


def sample_tokens_device(logits, st, rows=None, keys=None,
                         needs_penalty: bool = False, chain=DEFAULT_CHAIN):
    """The sampler over ``logits [B, V]`` with its parameters ``st``
    already on logits' device (``samp_to_device``): greedy rows argmax
    after the greedy-visible stages (the penalty, run when
    ``needs_penalty``), and ``rows`` (an int64 index tensor, or None when
    no row samples) draw by the Gumbel-max rule from ``keys [len(rows),
    2]`` after the whole chain.  No host read: a window calls it every
    iteration, so a chain holding a stage of the JAX package's interface
    (``is_reference_stage``) is refused rather than run on the host.
    Returns [B] int32."""
    for proc in chain:
        if is_reference_stage(proc):
            raise NotImplementedError(
                f"sample_tokens_device: {type(proc).__name__} is a logit "
                "processor of the JAX package's interface (proc(lg, samp, "
                "xp)); it runs on the host through sample_tokens or "
                "target_dist, not in the device sampler (ROADMAP Queue 3 "
                "item 1)")
    lg = logits.float()
    if needs_penalty:
        for proc in chain:
            if proc.greedy_visible:
                lg = proc(lg, st)
    greedy_tok = torch.argmax(lg, -1).to(torch.int32)
    if rows is None:
        return greedy_tok
    for proc in chain:
        if not proc.greedy_visible:
            lg = proc(lg, st)
    out = greedy_tok.clone()
    out[rows] = prng.categorical(keys, lg[rows]).to(torch.int32)
    return out


def sample_tokens(logits, samp, chain=DEFAULT_CHAIN):
    """Per-row sampling over [B, V] logits with the host ``samp`` dict.

    Greedy rows (temps <= 0) argmax after the greedy-visible stages --
    byte-compatible with generate()'s greedy branch -- while sampled rows
    run the full chain into a Gumbel-max draw from their own key.
    Only what the launch needs crosses to the device: the greedy-visible
    stages (the penalty, an identity at 1.0) run when some row has a
    penalty, the sampled stages when some row samples.  A chain holding a
    stage of the JAX package's interface (``is_reference_stage``) runs on
    the host through numpy instead: every stage over every row, as the
    reference does, with the logits copied out once and the greedy tokens
    and sampled rows' logits copied in.  Returns [B] int32 on logits'
    device."""
    dev = logits.device
    if any(is_reference_stage(proc) for proc in chain):
        return _sample_tokens_host(logits, samp, chain)
    sampled_rows, needs_penalty = sampling_plan(samp)
    st = samp_to_device(samp, dev, needs_penalty) \
        if needs_penalty or len(sampled_rows) else {}
    rows = keys = None
    if len(sampled_rows):
        rows = _to_device(sampled_rows, dev)
        keys = _to_device(np.asarray(samp["keys"])[sampled_rows]
                         .astype(np.int64), dev)
    return sample_tokens_device(logits, st, rows, keys, needs_penalty, chain)


def _sample_tokens_host(logits, samp, chain):
    """``sample_tokens`` for a chain with a stage of the JAX package's
    interface: the stages run over numpy (each in its own form,
    ``_host_stage``), the draw on logits' device."""
    dev = logits.device
    lg = logits.detach().float().cpu().numpy()
    hs = {k: np.asarray(v) for k, v in samp.items()}
    with np.errstate(invalid="ignore", over="ignore"):
        for proc in chain:
            if proc.greedy_visible:
                lg = _host_stage(proc, lg, hs)
        greedy_tok = np.argmax(lg, -1).astype(np.int32)
        sampled_rows, _ = sampling_plan(samp)
        out = _to_device(greedy_tok, dev)
        if not len(sampled_rows):
            return out
        for proc in chain:
            if not proc.greedy_visible:
                lg = _host_stage(proc, lg, hs)
    rows = _to_device(sampled_rows, dev)
    keys = _to_device(hs["keys"][sampled_rows].astype(np.int64), dev)
    lg_rows = _to_device(np.asarray(lg, np.float32)[sampled_rows], dev)
    out[rows] = prng.categorical(keys, lg_rows).to(torch.int32)
    return out


def target_dist(logits_row, *, temperature=0.0, top_k=0, top_p=1.0,
                penalty=1.0, seen=None, chain=DEFAULT_CHAIN):
    """Host-side target distribution for ONE position: the probabilities
    the sampler would draw from (one-hot argmax for greedy rows), through
    each stage's numpy path in the chain's order: ``host(lg, samp)``, or
    ``proc(lg, samp, np)`` for a stage of the JAX package's interface.  Speculative
    decoding's rejection sampling is exact only because this is the very
    chain the device runs.  Returns [V] float32."""
    lg = np.asarray(logits_row, np.float32)[None]
    V = lg.shape[-1]
    samp = {
        "temps": np.asarray([temperature], np.float32),
        "top_k": np.asarray([top_k], np.int32),
        "top_p": np.asarray([top_p], np.float32),
        "penalty": np.asarray([penalty], np.float32),
        "seen": (np.zeros((1, V), bool) if seen is None
                 else np.asarray(seen, bool).reshape(1, V)),
    }
    with np.errstate(invalid="ignore", over="ignore"):
        for proc in chain:
            if proc.greedy_visible:
                lg = _host_stage(proc, lg, samp)
        if temperature <= 0.0:
            out = np.zeros((V,), np.float32)
            out[int(np.argmax(lg[0]))] = 1.0
            return out
        for proc in chain:
            if not proc.greedy_visible:
                lg = _host_stage(proc, lg, samp)
        return _softmax(lg)[0]
