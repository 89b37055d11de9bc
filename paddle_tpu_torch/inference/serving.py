"""Continuous-batching LLaMA serving engine in PyTorch (counterpart of
paddle_tpu/inference/serving.py).

- ``BlockManager`` (inference/kv_cache.py) owns a fixed pool of KV pages
  with per-sequence block tables.  With prefix caching on (the default)
  the pool is content-addressed: admission reuses pages other sequences
  already computed and prefills only the miss suffix; writes into a
  shared page copy it first (copy-on-write).

- A continuous-batching scheduler: every ``step()`` admits waiting
  requests, packs at most ``max_prefill_tokens`` prompt tokens (long
  prompts prefill in chunks across steps), grows every decoding
  sequence's table by the token it writes, and preempts the youngest
  sequence when the pool runs out (it requeues and recomputes, hitting
  the prefix cache its own pages populated).

- ONE ragged step per launch: the step's whole mix -- prefill chunks,
  resumed chunks, single decode tokens -- is packed as rows of flat
  query tokens described by ``(cu_seqlens, kv_lens, block_tables)`` and
  padded to a token bucket.  Each layer writes the packed tokens' K/V into
  the page pool, then one ragged paged-attention call
  (ops/paged_attention.py) lets every token attend to its row's pages at
  its absolute position: the hand-written CUDA kernel on the card, its
  plain PyTorch version on the CPU.

- Quantized modes.  ``kv_dtype="int8"`` stores int8 pages with
  per-page-per-head f32 scale pools, quantized at commit time inside the
  step (scales only grow while a page is live) and dequantized by the
  int8-page attention kernel.  ``weight_dtype="int8"|"int4"`` quantizes
  the weights once, at build, into pools every projection, the MLP and
  the unembedding stream through the fused dequant matmul
  (ops/quant_matmul.py); the embedding dequantizes only the rows it
  gathers.

The decode math is term for term the JAX engine's (itself the math of
``generate()``), so greedy output is token-identical to the JAX engine and
to the port's dense ``generate()``, with the prefix cache on or off.

- A dispatch/completion pipeline (``overlap=True``, the default):
  ``step()`` pre-stages the next pure-decode pack and completes the
  launch the previous call left on the card, then dispatches this call's
  launch without waiting for it.  A launch's sampled tokens stay on the
  card; their read-back is a non-blocking copy into pinned host memory
  followed by a CUDA event, which the completion waits on.  Every kernel
  runs on the current stream; the packed host buffers reach the card
  through pinned memory by non-blocking copies.  Outputs surface one
  ``step()`` later; greedy output is byte-identical on or off.

- A device-resident decode window (``decode_window=K``): steady
  pure-decode packs run up to K decode steps in one launch -- K eager
  iterations of the per-step body at Tq = max_num_seqs whose state
  (tokens, KV lengths, sampler keys, penalty masks, the active mask)
  stays on the card -- and the host reads the [K, B] token grid back
  once.  Rows that hit eos or their budget freeze; their K/V writes go to
  the null page.  Page slack is reserved before launch (K shrinks to what
  the pool covers; below 2 the step runs per-step, counted).

- Speculative decoding (inference/spec_decode.py): a host-side
  ``Drafter`` proposes up to k tokens per decode-ready sequence, the step
  packs each speculative sequence's [last_token, d_1..d_k] window as one
  ragged row (the step returns the f32 logits of every packed position
  beside the sampled tokens, read back into pinned memory behind the same
  event), and host-side rejection sampling accepts a prefix: greedy output
  is byte-identical to plain decode, sampled output follows the target
  distribution.  Rejected drafts roll back through
  ``BlockManager.truncate``.  Per-request ``spec_k`` opts in, and a low
  acceptance rate turns speculation off for that request.

- The host tiers: a ``HostSpillPool`` (inference/kv_tier.py) below the
  page pool, which the step-boundary drain spills parked pages to and
  restores returning prefixes from in place; a ``FaultPlan``
  (inference/faults.py) firing deterministic faults at the step seams; a
  ``DegradationController`` (inference/pressure.py) shedding load in
  tiers before preemption; a ``Tracer`` (profiler/trace.py) and a
  ``FlightRecorder`` (inference/flight.py) recording the step timeline
  and each request's lifecycle.  With none installed each seam is one
  attribute check.

- Tensor parallelism (``tp=N``): the query and KV heads split into N
  contiguous blocks (so a GQA group never straddles shards), each shard
  with its block's q/k/v weights and its own page pools [L, N, kvh/N,
  bs, d] on its device; wo, the MLP, the embedding and the norms are
  replicated on the lead device.  Each layer's shard outputs are
  concatenated in shard order on the lead device before the replicated
  wo, and the unembedding splits by vocabulary when N divides it, so
  greedy output is token-identical to tp=1.  Host bookkeeping (pages,
  scheduler, sampling) does not know about the shards.

- Kernel tuning: the engine consults the tuning cache (``tune/``) once
  at construction for its launch geometry and reports the answer in
  ``summary()["tuning_cache"]``; the kernel wrappers read the same
  cache, by shape, at their first launch of a shape.

The engine is single-threaded: add_request/step/abort are called from one
thread (the frontend's EngineRunner owns it), apart from
``prefetch_hint``.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch
from torch.profiler import record_function

from ..models.llama import _rms_weight, _rope_positions, resolve_device
from ..ops import paged_attention as _pa
from ..ops import quant_matmul as _qm
from ..profiler.serving import ServingStats
from . import prng
from .faults import InjectedFault
from .kv_cache import (NULL_BLOCK, BlockManager, BlockPoolExhausted,
                       prefix_chain_hashes)
from .policy import pack_prefill_chunks
from .pressure import STATE_NAMES as _TIER_NAMES
from .sampling import (advance_keys, make_samp, samp_to_device,
                       sample_tokens, sample_tokens_device, sampling_plan)
from .spec_decode import NGramDrafter, verify_and_accept

__all__ = ["LLMEngine", "Request", "RequestOutput"]

_INV127 = float(np.float32(1.0) / np.float32(127.0))
_NO_PAGES = np.zeros((0,), np.int32)


@dataclass
class Request:
    """One generation request in the engine's queues."""
    rid: int
    prompt: list                      # original prompt token ids
    max_new_tokens: int
    temperature: float
    eos_token_id: object              # int | None
    seed: int
    top_k: int = 0                    # 0 -> off
    top_p: float = 1.0                # 1.0 -> off
    repetition_penalty: float = 1.0   # 1.0 -> off
    spec_k: int = 0                   # max draft tokens per verify round
    # scheduler state
    tokens: list = field(default_factory=list)   # tokens to (re)prefill
    generated: list = field(default_factory=list)
    cached: int = 0                   # positions whose KV is in the pool
    arrival: int = 0                  # admission priority (FCFS)
    slot: int = -1                    # stable decode-batch slot
    t_arrival: float = 0.0            # wall clock at add_request (TTFT)
    seen: object = None               # [V] bool penalty mask (lazy)
    spec_proposed: int = 0            # drafts sent to verify (lifetime)
    spec_accepted: int = 0            # drafts accepted (lifetime)
    spec_disabled: bool = False       # acceptance fell below the floor
    tier_checked: int = -1            # spill-tier generation last consulted
    # streaming hooks (both called from the engine's stepping thread)
    on_token: object = None           # callable(rid, token) per emission
    on_finish: object = None          # callable(RequestOutput) at the end


@dataclass
class RequestOutput:
    rid: int
    prompt: list
    generated: list                   # includes the eos token when hit
    finish_reason: str                # "eos" | "length" | abort reason

    @property
    def token_ids(self):
        return list(self.prompt) + list(self.generated)


@dataclass
class _StepTicket:
    """One dispatched launch awaiting its completion: the packed-row
    layout and the launch's result, read back without blocking.

    ``result`` is the host copy of the device result -- [2, Lq] int32
    (sampled tokens, finite flags) for a per-step launch, [2, K', B] for
    a window -- ``logits`` the host copy of the [Lq, V] f32 logits of a
    launch that carries verify rows (else None), and ``ready`` the CUDA
    event recorded after the copies (None on the CPU, where the copy is
    done when the launch returns).  The pipeline is depth-1: the next
    dispatch needs this ticket's tokens (a decode row's input is the
    previous step's output)."""
    chunks: list
    spec: list                        # (req, drafts, q_dists) verify rows
    batch: list
    result: torch.Tensor
    logits: object                    # host [Lq, V] f32 | None
    ready: object                     # torch.cuda.Event | None
    spec_slices: list                 # (first logit row, rows) per spec row
    chunk_slots: list
    batch_slots: list
    dispatch_s: float                 # host seconds packing + launching
    launch_ns: int = 0                # tracer clock at launch (0 untraced)
    inflight: bool = False            # crossed a step() boundary in flight
    window: int = 0                   # K' of a decode-window launch (0 =
                                      # per-step)


class _DecodeBufs:
    """One set of persistent host-side pack buffers for the pure-decode
    fast path.  With overlap on the engine holds two and alternates
    launches between them, so the prestage of the next pack never
    rewrites the buffers of the launch in flight.  ``bt_ver`` maps rid ->
    the block-table version staged into THIS buffer's ``bt``; ``layout``
    is the rid order last packed."""

    __slots__ = ("toks", "cu", "kvl", "bt", "samp", "layout", "bt_ver")

    def __init__(self, B, nblk, Lq, vocab_size):
        self.toks = np.zeros((B,), np.int32)
        self.cu = np.zeros((B + 1,), np.int32)
        self.kvl = np.zeros((B,), np.int32)
        self.bt = np.full((B + 1, nblk), NULL_BLOCK, np.int32)
        self.samp = make_samp(Lq, vocab_size)
        self.layout: tuple = ()
        self.bt_ver: dict = {}


class _Shard:
    """One tensor-parallel shard of the engine (the whole engine at
    tp=1): its device; ``layers``, the q/k/v weights of its contiguous
    block of heads (wq/wk/wv, or their quantized pools and scales, sliced
    along the output columns; at tp=1 the engine's own tensors); ``head``,
    its vocabulary block of the unembedding when the vocabulary splits
    (else None); and its page pools [L, N, kvh/tp, bs, d], with the
    [L, N, kvh/tp] f32 scale pools of int8 pages."""

    __slots__ = ("device", "layers", "head", "kc", "vc", "ks", "vs")

    def __init__(self, device, layers, head=None):
        self.device = device
        self.layers = layers
        self.head = head
        self.kc = self.vc = self.ks = self.vs = None

    def tensors(self):
        """Every weight tensor the shard holds (pools excluded)."""
        return list(self.layers.values()) + list((self.head or {}).values())


def _to(t, device):
    """``t`` on ``device``: itself when it is there, else a copy queued
    without blocking the host."""
    return t if t.device == device else t.to(device, non_blocking=True)


class LLMEngine:
    """Continuous-batching serving loop over one LlamaForCausalLM.

    Parameters (as the JAX engine's, where ported)
    ----------------------------------------------
    model: paddle_tpu_torch LlamaForCausalLM; its weights are used in
        place (``decode_params()`` views, no copy) and must live on
        ``device``.
    device: where the engine runs; None means CUDA (raises when no GPU is
        present).  Pass "cpu" for the plain PyTorch path.  With tp > 1 it
        may also be a list of tp devices, one a shard.
    max_num_seqs: decode-batch capacity.
    block_size: KV page size in tokens.
    num_blocks: page-pool size; default lets every batch slot reach
        max_model_len.
    max_model_len: longest prompt+generation accepted.
    max_prefill_tokens: per-step prompt-token budget (longer prompts
        prefill in chunks).
    prefill_token_bucket: launches above max_num_seqs tokens pad to a
        multiple of this.
    enable_prefix_caching: content-addressed page reuse; greedy output
        is byte-identical on or off.

    kv_dtype: "float32" (full-width pages in the model dtype) or "int8"
        (int8 pages + f32 per-page-per-head scales).
    weight_dtype: "float32" (the model's weights as they are), "int8" or
        "int4" (quantized pools streamed through the dequant matmul).
    overlap: run the step loop as a dispatch/completion pipeline (the
        default).  ``step()`` pre-stages the next pack and completes the
        launch the previous call left in flight, then dispatches this
        call's launch without waiting for it, so the card works across
        the step boundary while the host admits, schedules and packs.
        Outputs surface one ``step()`` later and ``run()`` takes one extra
        draining call; greedy output is byte-identical on or off.  False
        completes each launch in the call that dispatched it.
    decode_window: K > 1 runs steady pure-decode packs (every runner
        decode-ready, nobody waiting) as one K-step window whose state
        stays on the card: one host round trip per K tokens instead of
        one per token.  K tokens of page slack are reserved per row before
        launch; when the pool covers fewer, K shrinks, and below 2 the
        step runs per-step (``decode_window_fallbacks``), never
        preempting for a window.  Greedy output is byte-identical to
        decode_window=1; ``compile_counts`` gains a "scan" key when a
        window first runs.  Mixed packs (prefill chunks, verify rows) and
        rows that may speculate take the per-step path.
    drafter: a spec_decode.Drafter (or the string "ngram" for the
        prompt-lookup drafter) proposing draft tokens; None disables
        speculative decoding engine-wide.
    spec_k: default per-request draft length (requests may override via
        add_request(spec_k=); 0 means plain decode).
    max_spec_k: hard per-round draft ceiling; fixes the step's logit-row
        width max_num_seqs * (max_spec_k + 1).
    spec_accept_floor / spec_window: once a request has sent spec_window
        drafts to verify, speculation turns off for it if its lifetime
        acceptance rate sits below the floor.
    retain_outputs: keep every finished RequestOutput in the dict that
        ``run()`` returns.  A long-running server (the HTTP frontend)
        passes False: outputs are delivered through each request's
        ``on_finish`` callback instead, so finished requests cost no
        memory once their stream closes.
    fault_plan: a faults.FaultPlan firing deterministic faults (step
        crashes and stalls, in-flight crashes and stalls, NaN rows, pool
        exhaustion) at the step seams; None: one attribute check a step.
    pressure: a pressure.DegradationController shedding load in tiers
        (draft shrink, admission pause, parked-page eviction) before
        preemption becomes necessary.
    tracer: a profiler.trace ``Tracer`` recording every step phase and
        each request's lifetime; ``dump_trace`` writes it as Chrome
        trace-event JSON.
    kv_tier: a kv_tier.HostSpillPool.  Parked pages the pressure tier
        evicts spill to host memory at the step-boundary drain instead of
        dying, and a returning prefix is restored into free pages in
        place before its admission (``prefetch_hint`` pre-stages one).
    tp: tensor-parallel degree; must divide num_attention_heads and
        num_key_value_heads.  The shards run in this one process, each on
        its device (``device`` above: one device holds every shard, a
        list gives each its own, None takes cuda:0 .. cuda:tp-1 and raises
        when fewer cards are visible).  Each shard holds its contiguous
        block of query and KV heads -- the q/k/v weights of those heads
        and its own page and scale pools -- and, when tp divides the
        vocabulary, its block of the unembedding; everything else is
        replicated on the lead device (``device``'s first), where each
        layer's shard outputs are concatenated in shard order.  Greedy
        output is token-identical to tp=1.
    """

    def __init__(self, model, *, device=None, max_num_seqs: int = 8,
                 block_size: int = 16, num_blocks: int | None = None,
                 max_model_len: int | None = None,
                 max_prefill_tokens: int = 512,
                 prefill_token_bucket: int = 64,
                 enable_prefix_caching: bool = True,
                 drafter=None, spec_k: int = 0, max_spec_k: int = 8,
                 spec_accept_floor: float = 0.35, spec_window: int = 32,
                 retain_outputs: bool = True,
                 fault_plan=None, pressure=None,
                 kv_dtype: str = "float32", tp: int = 1,
                 tracer=None, overlap: bool = True,
                 decode_window: int = 1,
                 weight_dtype: str = "float32",
                 kv_tier=None):
        if kv_dtype not in ("float32", "int8"):
            raise ValueError(
                f"kv_dtype must be 'float32' or 'int8', got {kv_dtype!r}")
        if weight_dtype not in ("float32", "int8", "int4"):
            raise ValueError(
                "weight_dtype must be 'float32', 'int8' or 'int4', "
                f"got {weight_dtype!r}")
        if int(decode_window) < 1:
            raise ValueError(
                f"decode_window must be >= 1, got {decode_window}")
        cfg = model.config
        self.tp = int(tp)
        if self.tp < 1:
            raise ValueError(f"tp must be >= 1, got {tp}")
        if self.tp > 1 and (cfg.num_attention_heads % self.tp
                            or cfg.num_key_value_heads % self.tp):
            raise ValueError(
                f"tp={self.tp} must divide num_attention_heads="
                f"{cfg.num_attention_heads} and num_key_value_heads="
                f"{cfg.num_key_value_heads} (contiguous head "
                "partition keeps GQA groups on one shard)")
        self.devices = self._shard_devices(device, self.tp)
        self.device = self.devices[0]
        if model.device != self.device:
            raise ValueError(f"model weights live on {model.device}, the "
                             f"engine runs on {self.device}")
        self.config = cfg
        self.params = model.decode_params()
        self.kv_dtype = kv_dtype
        self.weight_dtype = weight_dtype
        # the step's activations keep the model's float dtype even when
        # the embed table is about to become a quantized pool + scales
        self._act_dtype = self.params["embed"].dtype
        if weight_dtype != "float32":
            self.params = self._quantize_params(self.params)
            self._head_f32 = None
        else:
            # the unembedding runs in f32 as the JAX step's does; keep one
            # f32 copy instead of casting [H, V] every step (no copy for
            # f32)
            self._head_f32 = self.params["head"].float()
        # the unembedding splits over vocabulary only when tp divides it;
        # otherwise it is replicated on the lead device
        self._shard_head = self.tp > 1 and cfg.vocab_size % self.tp == 0
        self._shards = self._make_shards()
        self._mm, self._embed, self._head_logits = self._weight_ops()
        self.max_num_seqs = int(max_num_seqs)
        self.block_size = int(block_size)
        self.max_model_len = int(max_model_len or cfg.max_position_embeddings)
        self.max_prefill_tokens = int(max_prefill_tokens)
        self.prefill_token_bucket = int(prefill_token_bucket)
        self.enable_prefix_caching = bool(enable_prefix_caching)

        # static block-table width: pages needed by a max-length sequence
        self.nblk = -(-self.max_model_len // self.block_size)
        if num_blocks is None:
            num_blocks = 1 + self.max_num_seqs * self.nblk
        self.blocks = BlockManager(
            num_blocks, self.block_size,
            enable_prefix_caching=self.enable_prefix_caching)
        if self.blocks.num_free < self.nblk:
            raise ValueError(
                f"num_blocks={num_blocks} cannot hold even one "
                f"max_model_len={self.max_model_len} sequence "
                f"({self.nblk} pages needed)")
        # the host spill tier turns EVICT_PARKED from kill into spill:
        # pages quarantine in the pool and move host-side at the
        # step-boundary drain, and admission gets them back as ordinary
        # prefix-cache content
        self.kv_tier = kv_tier
        if kv_tier is not None:
            self.blocks.spill_on_evict = True
        # chain hashes restored from the tier and not yet claimed by an
        # admission hit (prefetch-hit attribution is by hash)
        self._staged_hashes: set = set()

        self._nh = cfg.num_attention_heads
        self._kvh = cfg.num_key_value_heads
        self._hd = cfg.hidden_size // self._nh
        L = cfg.num_hidden_layers
        kvh = self._kvh // self.tp
        # each shard's pools hold its block of KV heads; they are updated
        # in place, layer by layer, every step, and never change address
        shape = (L, num_blocks, kvh, self.block_size, self._hd)
        for sh in self._shards:
            if kv_dtype == "int8":
                # int8 pages + a parallel per-page-per-head f32 scale pool
                # (float = int8 * scale), written at commit time inside
                # the step; every host-side page structure is dtype-blind
                sh.kc = torch.zeros(shape, dtype=torch.int8,
                                    device=sh.device)
                sh.ks = torch.zeros((L, num_blocks, kvh),
                                    dtype=torch.float32, device=sh.device)
                sh.vs = torch.zeros_like(sh.ks)
            else:
                # "float32" means full-width model dtype (f32/bf16) pages
                sh.kc = torch.zeros(shape, dtype=self._act_dtype,
                                    device=sh.device)
            sh.vc = torch.zeros_like(sh.kc)

        self._waiting: deque = deque()
        self._running: list = []
        self._finished: dict = {}
        self._next_rid = 0
        self._arrival = 0
        self.retain_outputs = bool(retain_outputs)

        # stable batch slots (pure-decode steps pack rows in slot order)
        # plus persistent host buffers for the decode fast path: two
        # sets, alternated under overlap (overlap off uses set 0 only)
        B = self.max_num_seqs
        self._slot_used = [False] * B

        # speculative decoding: a host-side drafter proposes up to
        # max_spec_k tokens per decode-ready sequence; each speculative
        # sequence rides the step's single ragged launch as one
        # [last_token, drafts...] row
        if drafter == "ngram":
            drafter = NGramDrafter()
        self.drafter = drafter
        self.spec_k = int(spec_k)
        self.max_spec_k = int(max_spec_k)
        self.spec_accept_floor = float(spec_accept_floor)
        self.spec_window = int(spec_window)
        # logit rows of the step: spec rows need k+1 scored positions
        # each; without a drafter one row is one logit.  The step returns
        # the f32 logits (for host-side acceptance) only with a drafter.
        self._with_logits = drafter is not None
        self._Lq = B * (self.max_spec_k + 1) if self._with_logits else B
        self._logits_host = None          # pinned [Lq, V] f32 read-back
        self.overlap = bool(overlap)
        self._dbufs = (_DecodeBufs(B, self.nblk, self._Lq, cfg.vocab_size),
                       _DecodeBufs(B, self.nblk, self._Lq, cfg.vocab_size))
        self._d_cur = 0                   # buffer set of the latest launch
        self._d_lidx = np.minimum(np.arange(self._Lq), B - 1) \
            .astype(np.int32)
        # dispatch/completion pipeline state (a depth-1 queue)
        self._inflight: _StepTicket | None = None
        self._prestaged = None            # (buffer set, layout) when valid
        self._pending_finished: list = []  # finishes from an abort() flush
        self._spec_pages: dict = {}       # rid -> pages the prestage took
        # two pinned staging buffers for the packed int32 upload (CUDA
        # only), alternated launch by launch
        self._stages = [None, None]
        self._stage_i = 0
        # "programs": the Tq buckets a launch has warmed (walk plans,
        # tensor maps, workspaces, allocator blocks), and the window
        self._buckets: set = set()
        self.compile_counts = {"ragged": 0}
        self.decode_window = int(decode_window)
        # padding accounting: real packed tokens vs bucket width, plus
        # what a per-phase (prefill bucket + decode bucket) step would pad
        self.pad_stats = {"real": 0, "padded": 0, "legacy_padded": 0}
        self._evictions_seen = 0
        self.peak_resident_seqs = 0
        self.stats = ServingStats()
        self.stats.set_decode_window(self.decode_window)
        self.stats.set_weight_residency(
            self.weight_dtype, self.weight_bytes_resident(),
            self.weight_bytes_resident_per_shard())
        # the launch geometry the tuning cache gives this engine's shapes
        self._tuning_report = self._resolve_tuning()
        # per-request flight recorder and step-timeline tracer: None means
        # every seam is one attribute check and nothing else
        self.flight = None
        self.tracer = None
        self._trace_track = "engine"
        self._trace_steps = 0
        self.fault_plan = None
        self.set_fault_plan(fault_plan)
        self.pressure = pressure
        self.set_tracer(tracer)

    def set_fault_plan(self, plan) -> None:
        """Install (or clear) a FaultPlan on this engine and its pool.
        The runner re-installs the same plan on a rebuilt engine, so a
        schedule survives recovery with its consumed faults consumed."""
        self.fault_plan = plan
        self.blocks._fault_hook = plan.pool_exhausted \
            if plan is not None else None
        if plan is not None:
            plan.tracer = self.tracer
            plan.trace_track = self._trace_track

    def set_tracer(self, tracer) -> None:
        """Install (or clear) a step-timeline Tracer on this engine (and
        on its fault plan, so injected faults land in the trace).  With
        None installed the step loop performs no trace work at all."""
        self.tracer = tracer
        if tracer is not None:
            self._trace_track = tracer.register("engine")
        if self.fault_plan is not None:
            self.fault_plan.tracer = tracer
            self.fault_plan.trace_track = self._trace_track

    def set_flight(self, recorder) -> None:
        """Install (or clear) a per-request FlightRecorder
        (inference/flight.py).  With None installed the request
        lifecycle seams perform no forensic work at all."""
        self.flight = recorder

    def _tier(self) -> int:
        """Current degradation tier (0 when no pressure controller)."""
        return 0 if self.pressure is None else self.pressure.state

    def dump_trace(self, path) -> int:
        """Write this engine's step timeline as Chrome trace-event JSON
        (Perfetto-loadable); returns the number of events written.
        Raises when tracing was never enabled."""
        if self.tracer is None:
            raise RuntimeError(
                "tracing is not enabled: build the engine with tracer= "
                "or call set_tracer() first")
        return self.tracer.dump(path)

    def close(self) -> None:
        """Drop this engine's device state -- the page and scale pools,
        the weights it holds, the pinned read-back and staging buffers and
        the in-flight ticket -- so the card's memory returns once no
        frame still uses them.  The supervised runner closes an engine
        whose generation it retired: a wedged step going on later on
        that engine raises instead of touching the pools."""
        self._shards = None
        self.params = self._head_f32 = None
        self._mm = self._embed = self._head_logits = None
        self._inflight = None
        self._prestaged = None
        self._logits_host = None
        self._stages = [None, None]

    # ------------------------------------------------------------------
    # tensor-parallel shards (tp > 1)
    # ------------------------------------------------------------------

    @staticmethod
    def _shard_devices(device, tp: int) -> list:
        """The device of each shard: one ``device`` for all of them, a
        list of tp devices, or with None cuda:0 .. cuda:tp-1 (one card a
        shard, raising when fewer are visible; shards never share a card
        unless the caller says so).  CUDA devices get their index pinned,
        so a stepping thread can set them."""
        if isinstance(device, (list, tuple)):
            if len(device) != tp:
                raise ValueError(f"device lists {len(device)} devices for "
                                 f"tp={tp}")
            devs = [resolve_device(d) for d in device]
        elif device is None and tp > 1:
            n = torch.cuda.device_count() if torch.cuda.is_available() \
                else 0
            if n < tp:
                raise RuntimeError(
                    f"tp={tp} puts one shard a CUDA device and {n} are "
                    "visible; pass device= (one device for every shard, "
                    "or a list of tp devices; 'cpu' for the plain path)")
            devs = [torch.device("cuda", i) for i in range(tp)]
        else:
            devs = [resolve_device(device)] * tp
        return [torch.device("cuda", torch.cuda.current_device())
                if d.type == "cuda" and d.index is None else d
                for d in devs]

    def _make_shards(self) -> list:
        """Split the q/k/v weights (quantized pools and scales alike)
        into contiguous head blocks along their output columns, one
        contiguous copy a shard on its device, and the unembedding into
        vocabulary blocks when it splits; the rest stays in
        ``self.params`` on the lead device.  At tp=1 the one shard holds
        the engine's own tensors (no copy)."""
        layers = self.params["layers"]
        keys = ("wq", "wk", "wv") if self.weight_dtype == "float32" else \
            ("wq_q", "wq_s", "wk_q", "wk_s", "wv_q", "wv_s")
        if self.tp == 1:
            return [_Shard(self.device, {k: layers[k] for k in keys})]

        def block(t, s):
            # the last axis is the output columns of every sliced leaf:
            # float [L, H, N], pools [L, K or K/2, N], int8 scales [L, N],
            # int4 scales [L, G, N], the head [H, V] / [K, V] / [V] /
            # [G, V]
            w = t.shape[-1] // self.tp
            return t[..., s * w:(s + 1) * w].to(self.devices[s]) \
                .contiguous()

        head_keys = ()
        if self._shard_head:
            if self.weight_dtype == "float32":
                head_keys = ("head",)
                heads = {"head": self._head_f32}
                self._head_f32 = None
            else:
                head_keys = ("head_q", "head_s")
                heads = {k: self.params[k] for k in head_keys}
        shards = [_Shard(dev, {k: block(layers[k], s) for k in keys},
                         {k: block(v, s) for k, v in heads.items()}
                         if head_keys else None)
                  for s, dev in enumerate(self.devices)]
        self.params = {k: v for k, v in self.params.items()
                       if k not in head_keys}
        self.params["layers"] = {k: v for k, v in layers.items()
                                 if k not in keys}
        return shards

    # the lead shard's pools (every page of every head at tp=1); the other
    # shards' are in ``_shards``
    @property
    def _kc(self):
        return None if self._shards is None else self._shards[0].kc

    @property
    def _vc(self):
        return None if self._shards is None else self._shards[0].vc

    @property
    def _ks(self):
        return None if self._shards is None else self._shards[0].ks

    @property
    def _vs(self):
        return None if self._shards is None else self._shards[0].vs

    def _pool_names(self) -> tuple:
        return ("kc", "vc", "ks", "vs") if self.kv_dtype == "int8" \
            else ("kc", "vc")

    # ------------------------------------------------------------------
    # request API
    # ------------------------------------------------------------------

    def add_request(self, prompt, max_new_tokens: int = 32,
                    temperature: float = 0.0, eos_token_id=None,
                    seed: int = 0, top_k: int = 0, top_p: float = 1.0,
                    repetition_penalty: float = 1.0,
                    spec_k: int | None = None, generated=None,
                    on_token=None, on_finish=None) -> int:
        """Queue one generation request; returns its rid.  ``spec_k``
        (default: the engine's) is clamped to max_spec_k, and to 0
        without a drafter.

        ``generated`` re-admits a request that already emitted tokens
        (the runner's crash-recovery replay): the request enters exactly
        as a preempted sequence would -- prefill covers prompt+generated,
        ``max_new_tokens`` still counts from the original prompt -- so
        with the same seed the continuation equals the uninterrupted run
        (sampling keys derive from (seed, len(generated))).  ``on_token``
        (rid, token) and ``on_finish`` (RequestOutput) are called from the
        stepping thread as tokens commit and when the request ends."""
        prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        if not prompt:
            raise ValueError("empty prompt")
        if int(max_new_tokens) < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        generated = [int(t) for t in (generated or [])]
        if len(generated) >= int(max_new_tokens):
            raise ValueError(
                f"continuation already holds {len(generated)} of "
                f"max_new_tokens={max_new_tokens} tokens")
        if len(prompt) + int(max_new_tokens) > self.max_model_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens "
                f"({max_new_tokens}) exceeds max_model_len "
                f"({self.max_model_len})")
        if not 0.0 < float(top_p) <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        if int(top_k) < 0:
            raise ValueError(f"top_k must be >= 0, got {top_k}")
        if float(repetition_penalty) <= 0.0:
            raise ValueError(
                f"repetition_penalty must be > 0, got {repetition_penalty}")
        if spec_k is None:
            spec_k = self.spec_k
        spec_k = min(int(spec_k), self.max_spec_k) \
            if self.drafter is not None else 0
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid=rid, prompt=prompt,
                      tokens=list(prompt) + generated,
                      generated=list(generated),
                      max_new_tokens=int(max_new_tokens),
                      temperature=float(temperature),
                      eos_token_id=eos_token_id, seed=int(seed),
                      top_k=int(top_k), top_p=float(top_p),
                      repetition_penalty=float(repetition_penalty),
                      spec_k=spec_k, t_arrival=time.perf_counter(),
                      on_token=on_token, on_finish=on_finish)
        if req.repetition_penalty != 1.0:
            req.seen = np.zeros((self.config.vocab_size,), bool)
            req.seen[prompt] = True
            req.seen[generated] = True
        self._waiting.append(req)
        fl = self.flight
        if fl is not None:
            fl.open(rid, prompt_tokens=len(prompt), t_submit=req.t_arrival)
        tr = self.tracer
        if tr is not None:
            tr.async_begin("req", f"{self._trace_track}:{rid}",
                           args={"rid": rid,
                                 "prompt_tokens": len(prompt),
                                 "replayed": len(generated),
                                 "max_new_tokens": int(max_new_tokens)})
            tr.instant("request.queued", track=self._trace_track,
                       args={"rid": rid})
        return rid

    def has_unfinished(self) -> bool:
        # an in-flight launch still owes its completion when every queue
        # is empty (run() drains the pipeline through it), and so do the
        # outputs an abort() flush buffered for the next step()
        return bool(self._waiting or self._running
                    or self._inflight is not None
                    or self._pending_finished)

    def abort(self, request_id: int, finish_reason: str = "aborted"):
        """Retire a request before it finishes, at any point of its
        lifetime as observed between steps (queued, mid-chunked-prefill,
        mid-decode).  Pages return through ``BlockManager.release`` -- the
        abort path that only decrefs pages shared with live neighbours
        and never registers the aborted tail.  Returns the partial
        RequestOutput, or None when request_id is unknown or already
        finished (counted in ``stats.abort_noops``).

        A launch in flight is completed first, with the victim's rows
        dropped unapplied: the abort reports exactly the tokens the
        caller could observe, as a synchronous abort does.  Batchmates
        commit as usual; those that finish there surface from the next
        ``step()``."""
        if self._inflight is not None:
            self._complete(self._pending_finished, drop_rid=request_id)
        self._spec_pages.pop(request_id, None)
        req = None
        for r in self._running:
            if r.rid == request_id:
                req = r
                self._running.remove(r)
                self._release_slot(r)
                break
        else:
            for r in self._waiting:
                if r.rid == request_id:
                    req = r
                    self._waiting.remove(r)
                    break
        if req is None:
            self.stats.record_abort_noop()
            return None
        if self.blocks.has(req.rid):
            self.blocks.release(req.rid)
        if self.drafter is not None:
            self.drafter.release(req.rid)
        out = RequestOutput(rid=req.rid, prompt=list(req.prompt),
                            generated=list(req.generated),
                            finish_reason=finish_reason)
        if self.retain_outputs:
            self._finished[req.rid] = out
        self.stats.record_abort(finish_reason)
        if self.stats.windows is not None:
            self.stats.record_finish_quality(False)
            self.stats.record_request_latency(
                time.perf_counter() - req.t_arrival)
        fl = self.flight
        if fl is not None:
            fl.finished(req.rid, reason=finish_reason,
                        generated=len(req.generated), tier=self._tier())
        tr = self.tracer
        if tr is not None:
            tr.async_end("req", f"{self._trace_track}:{req.rid}",
                         args={"finish_reason": finish_reason,
                               "generated": len(req.generated)})
        if req.on_finish is not None:
            req.on_finish(out)
        return out

    def _notify_tokens(self, req, toks) -> None:
        if req.on_token is not None:
            for t in toks:
                req.on_token(req.rid, int(t))

    def run(self) -> dict:
        """Drive step() until every queued request finishes.  Outputs by
        rid; the run's metrics are in ``summary()``."""
        while self.has_unfinished():
            self.step()
        return dict(self._finished)

    @property
    def num_decode_programs(self) -> int:
        """Warmed launch buckets of decode size (Tq == max_num_seqs)."""
        return sum(1 for Tq in self._buckets if Tq <= self.max_num_seqs)

    @property
    def num_prefill_programs(self) -> int:
        """Warmed launch buckets of prefill size (Tq > max_num_seqs)."""
        return sum(1 for Tq in self._buckets if Tq > self.max_num_seqs)

    def _warm_bucket(self, Tq: int) -> None:
        if Tq not in self._buckets:
            self._buckets.add(Tq)
            self.compile_counts["ragged"] += 1

    def precompile_buckets(self) -> tuple:
        """Run one all-padding launch at every reachable flat-token bucket
        -- the decode-sized bucket, the speculation tier when a drafter is
        attached, and every prefill_token_bucket multiple up to the
        largest packable launch (a full max_prefill_tokens budget plus
        every row's tokens) -- so the walk plans,
        tensor maps, workspaces and allocator blocks of every bucket exist
        before the first request.  A padding launch writes only the null
        page and samples nothing anyone reads.  Idempotent; returns the
        ladder, after which ``compile_counts["ragged"]`` stays at its
        size."""
        tb = self.prefill_token_bucket
        ceiling = self.max_prefill_tokens + self._Lq
        ladder = {self.max_num_seqs}
        if self._with_logits and self.max_num_seqs < self._Lq < tb:
            ladder.add(self._Lq)
        ladder.update(range(tb, (-(-ceiling // tb) + 1) * tb, tb))
        ladder = sorted(ladder)
        B = self.max_num_seqs
        cu = np.zeros((B + 1,), np.int32)
        kvl = np.zeros((B,), np.int32)
        bt = np.full((B + 1, self.nblk), NULL_BLOCK, np.int32)
        lidx = np.zeros((self._Lq,), np.int32)
        samp = make_samp(self._Lq, self.config.vocab_size)
        for Tq in ladder:
            if Tq in self._buckets:
                continue
            self._warm_bucket(Tq)
            self._ragged_step(Tq, np.zeros((Tq,), np.int32), cu, kvl, bt,
                              lidx, samp, _NO_PAGES)[0].cpu()
        return tuple(ladder)

    def _resolve_tuning(self) -> dict:
        """Consult the kernel tuning cache once for this engine's launch
        geometry (the JAX engine's shape keys; the paged key's kv_heads
        are a shard's): per registered kernel, the bucket key queried, the
        config chosen and whether a cache entry (exact or nearest bucket)
        answered.  The kernel wrappers resolve their own launches' keys
        the same way, so this is the provenance of the geometry they run.
        One difference: the paged key's dtype is the pools' (the JAX
        engine writes its kv_dtype, "float32", for bf16 pages too), the
        type the paged wrapper keys its own lookups on."""
        from ..tune import cache_path, device_kind, kernel_config_with_meta
        dt = str(self._act_dtype).split(".")[-1]
        d = self._hd
        shapes = {
            "flash_attention": {
                "seq_q": self.max_model_len, "seq_k": self.max_model_len,
                "head_dim": d, "dtype": dt},
            "flash_attention_varlen": {
                "seq_q": self.max_prefill_tokens,
                "seq_k": self.max_model_len, "head_dim": d, "dtype": dt},
            "fused_norms": {
                "rows": self.max_prefill_tokens,
                "hidden": self.config.hidden_size, "dtype": dt},
            "paged_attention": {
                "tq": self.prefill_token_bucket,
                "kv_heads": self._kvh // self.tp, "head_dim": d,
                "page": self.block_size, "nblk": self.nblk,
                "dtype": str(self._kc.dtype).split(".")[-1]},
        }
        if self.weight_dtype != "float32":
            # the decode-shaped MLP projection: the step's biggest weight
            # stream
            shapes["quant_matmul"] = {
                "m": self.max_num_seqs, "k": self.config.hidden_size,
                "n": self.config.intermediate_size,
                "dtype": self.weight_dtype}
        kernels = {}
        for name, shape in shapes.items():
            config, meta = kernel_config_with_meta(name, shape)
            self.stats.record_tuning(name, bool(meta["hit"]))
            kernels[name] = {"hit": bool(meta["hit"]),
                             "source": meta["source"], "config": config,
                             "key": meta["key"]}
        return {"path": cache_path(), "device": device_kind(),
                "kernels": kernels}

    def summary(self) -> dict:
        """One dict of serving metrics + block-pool state for this run."""
        out = self.stats.summary()
        out["block_pool"] = self.blocks.stats()
        if self.kv_tier is not None:
            out["kv_tier"] = self.kv_tier.stats()
        out["device"] = str(self.device)
        out["kv_dtype"] = self.kv_dtype
        out["tp"] = self.tp
        out["kv_bytes_resident"] = self.kv_bytes_resident()
        out["kv_bytes_resident_per_shard"] = \
            self.kv_bytes_resident_per_shard()
        out["weight_dtype"] = self.weight_dtype
        out["weight_bytes_resident"] = self.weight_bytes_resident()
        out["weight_bytes_resident_per_shard"] = \
            self.weight_bytes_resident_per_shard()
        out["peak_resident_seqs"] = self.peak_resident_seqs
        out["pad_stats"] = dict(self.pad_stats)
        out["overlap"] = self.overlap
        out["decode_window"] = self.decode_window
        out["tuning_cache"] = {
            "path": self._tuning_report["path"],
            "device": self._tuning_report["device"],
            "kernels": {k: dict(v) for k, v in
                        self._tuning_report["kernels"].items()},
        }
        return out

    def kv_page_bytes(self) -> int:
        """Device bytes one KV page costs over every shard: K and V slabs
        across layers, plus the page's scale-pool rows in int8 mode."""
        L = self.config.num_hidden_layers
        per = (2 * L * self._kvh * self.block_size * self._hd
               * self._kc.element_size())
        if self.kv_dtype == "int8":
            per += 2 * L * self._kvh * self._ks.element_size()
        return per

    def kv_page_bytes_per_shard(self) -> int:
        """Bytes one KV page costs on one shard's device: the pools split
        along H_kv (tp divides it), so page and scale slabs split
        exactly.  Pool sizing and pressure thresholds compare against
        this figure under tp, not the total."""
        return self.kv_page_bytes() // self.tp

    def kv_bytes_resident(self) -> int:
        """Device bytes holding real KV content over every shard: pages
        backing live sequences plus parked prefix pages."""
        return ((self.blocks.num_used + self.blocks.num_cached)
                * self.kv_page_bytes())

    def kv_bytes_resident_per_shard(self) -> int:
        """Resident KV bytes on one shard's device (the total at tp=1)."""
        return ((self.blocks.num_used + self.blocks.num_cached)
                * self.kv_page_bytes_per_shard())

    def _weight_tensors(self) -> tuple:
        """(replicated, sharded): the weight tensors on the lead device
        and those every shard holds a block of, each tensor once."""
        p = self.params
        rep = list(p["layers"].values()) + \
            [v for k, v in p.items() if k != "layers"]
        if self._head_f32 is not None and self._head_f32 is not p["head"]:
            rep.append(self._head_f32)
        if self.tp == 1:              # the shard holds params' own tensors
            return rep, []
        return rep, [t for sh in self._shards for t in sh.tensors()]

    def weight_bytes_resident(self) -> int:
        """Device bytes of the decode weights over every shard: the
        quantized pools, their f32 scales and the norms (or the model's
        weights, plus the f32 head copy of a bf16 model)."""
        rep, shd = self._weight_tensors()
        return sum(t.numel() * t.element_size() for t in rep + shd)

    def weight_bytes_resident_per_shard(self) -> int:
        """Resident weight bytes on one shard's device: the sharded
        tensors (q/k/v and their scales, and the head when the vocabulary
        splits) count 1/tp of their total, replicated ones in full (the
        total at tp=1)."""
        rep, shd = self._weight_tensors()
        return sum(t.numel() * t.element_size() for t in rep) + \
            sum(t.numel() * t.element_size() for t in shd) // self.tp

    @property
    def degradation_tier_entries(self) -> int:
        """Escalating degradation-controller transitions (0 when no
        pressure controller is installed)."""
        return 0 if self.pressure is None else self.pressure.tier_entries

    # ------------------------------------------------------------------
    # quantized weight pools (weight_dtype != "float32")
    # ------------------------------------------------------------------

    @torch.no_grad()
    def _quantize_params(self, params) -> dict:
        """Quantize decode_params ONCE at engine build into the pool
        layout the dequant matmul streams: every projection/MLP weight
        ``name`` becomes ``name_q`` + ``name_s`` f32 scales, the embedding
        a per-vocab-row pool, the head a pool; norms stay as they are.
        Quantizes layer by layer in f32 on the weights' device, so a
        large model never has a whole f32 copy of its weights."""
        wdt = self.weight_dtype
        layers = params["layers"]
        out_layers = {"ln1": layers["ln1"], "ln2": layers["ln2"]}
        for name in ("wq", "wk", "wv", "wo", "gate", "up", "down"):
            w = layers[name]
            for i in range(w.shape[0]):
                q, s = _qm.quantize_weight(w[i], wdt)
                if i == 0:
                    pool = torch.empty((w.shape[0], *q.shape),
                                       dtype=q.dtype, device=q.device)
                    scales = torch.empty((w.shape[0], *s.shape),
                                         dtype=s.dtype, device=s.device)
                pool[i] = q
                scales[i] = s
            out_layers[name + "_q"] = pool
            out_layers[name + "_s"] = scales
        eq, es = _qm.quantize_embedding(params["embed"], wdt)
        hq, hs = _qm.quantize_weight(params["head"], wdt)
        return {"layers": out_layers, "embed_q": eq, "embed_s": es,
                "norm_f": params["norm_f"], "head_q": hq, "head_s": hs}

    def _weight_ops(self):
        """(mm, embed, head_logits) for the step: the dense expressions
        for weight_dtype="float32"; otherwise every projection/MLP/head
        product through ``ops.quant_matmul.matmul`` (the CUDA kernel on
        the card, its plain version on the CPU) and the embedding
        dequantized at gather.  With the vocabulary split, head_logits
        runs each shard's block on its device."""
        dt = self._act_dtype
        wdt = self.weight_dtype
        params = self.params
        if wdt != "float32":
            def mm(h, p, name):
                return _qm.matmul(h, p[name + "_q"], p[name + "_s"],
                                  wdt).to(h.dtype)

            def embed(toks):
                return _qm.dequantize_rows(params["embed_q"][toks],
                                           params["embed_s"][toks],
                                           wdt).to(dt)

            def head_block(hsel, hp):
                return _qm.matmul(hsel.float(), hp["head_q"], hp["head_s"],
                                  wdt)
        else:
            def mm(h, p, name):
                return h @ p[name]

            def embed(toks):
                return params["embed"][toks]

            def head_block(hsel, hp):
                return hsel.float() @ hp["head"]
        if not self._shard_head:
            hp = params if wdt != "float32" else {"head": self._head_f32}

            def head_logits(hsel):
                return head_block(hsel, hp)
        else:
            lead = self.device

            def head_logits(hsel):
                # each shard's vocabulary block, concatenated in shard
                # order on the lead device
                return torch.cat([
                    _to(head_block(_to(hsel, sh.device), sh.head), lead)
                    for sh in self._shards], 1)
        return mm, embed, head_logits

    # ------------------------------------------------------------------
    # scheduler
    # ------------------------------------------------------------------

    def _decode_ready(self, req) -> bool:
        """Prefill complete and exactly the last generated token's KV is
        still unwritten (the decode step writes it and samples the next)."""
        return (req.cached >= len(req.tokens)
                and req.cached == len(req.prompt) + len(req.generated) - 1)

    def step(self) -> list:
        """One engine iteration.  With ``overlap`` on (the default) this is
        one turn of the dispatch/completion pipeline: pre-stage the next
        pure-decode pack while the previous call's launch is still on the
        card, wait for and commit that launch, then dispatch this call's
        launch without waiting for it -- so the requests returned are the
        completions of the PREVIOUS call's dispatch.  With ``overlap`` off
        the dispatch completes in the same call: admit -> schedule ->
        launch -> read back -> apply -> retire.  Returns the requests that
        finished.

        With a tracer installed every phase lands in the step timeline
        (dispatch: admit / schedule / pack / block-table stage / device
        launch; complete: block-on-result / sample-commit / retire; plus
        prestage and the device in-flight window); with none the phase
        seams are single attribute checks."""
        if self.device.type == "cuda" \
                and torch.cuda.current_device() != self.device.index:
            # a stepping thread other than the one that built the engine
            # starts on the default device
            torch.cuda.set_device(self.device)
        tr = self.tracer
        if tr is None:
            return self._step()
        self._trace_steps += 1
        t0 = tr.now()
        finished = self._step()
        tr.complete("engine.step", t0, track=self._trace_track,
                    args={"step": self._trace_steps,
                          "finished": len(finished)})
        return finished

    def _step(self) -> list:
        # outputs that finished inside an abort()'s pipeline flush surface
        # here, so the step()-return channel never drops one
        finished = self._pending_finished
        self._pending_finished = []
        if self._inflight is not None:
            self._prestage()
            self._complete(finished)
        if self.kv_tier is not None:
            # step boundary: no launch is in flight, and restores land
            # before this step's admission packs only the residual prefill
            self._drain_kv_tier()
        self._dispatch()
        if not self.overlap and self._inflight is not None:
            self._complete(finished)
        ev = self.blocks.eviction_count
        if ev != self._evictions_seen:
            self.stats.record_evictions(ev - self._evictions_seen)
            self._evictions_seen = ev
        return finished

    def _dispatch(self) -> None:
        """Admission + scheduling + packing + the launch (a K-step window
        when the pack is eligible, else one ragged step).  The launch's
        result stays on the card, its read-back queued behind it, in
        ``self._inflight`` until ``_complete`` waits for it."""
        tr = self.tracer
        plan = self.fault_plan
        if plan is not None:
            # fault seams fire BEFORE any scheduler mutation, so a crash
            # leaves queues and pool in the consistent between-steps state
            # recovery replays from.  advance() keys the plan step on
            # dispatch order, which equals completion order (the depth-1
            # pipeline completes ticket N before dispatching N+1).
            plan.advance()
            if plan.take_pool_entry():
                self.stats.record_fault("pool")
            slow = plan.take_slow()
            if slow > 0.0:
                self.stats.record_fault("slow")
                time.sleep(slow)
            if plan.take_crash():
                self.stats.record_fault("crash")
                raise InjectedFault(
                    f"injected step crash at plan step {plan.step}")

        if self.pressure is not None:
            # pages the prestage reserved for rows still alive are
            # credited back: the synchronous engine would not have taken
            # them yet at this point, so every tier decision sees the
            # same per-step timeline
            prev_tier = self.pressure.state
            self.pressure.update(
                self.blocks, spec_reserved=sum(self._spec_pages.values()))
            self.stats.set_degradation_state(self.pressure.state)
            if tr is not None and self.pressure.state != prev_tier:
                tr.instant("pressure.tier", track=self._trace_track,
                           args={"from": prev_tier,
                                 "to": self.pressure.state,
                                 "name": _TIER_NAMES.get(
                                     self.pressure.state,
                                     str(self.pressure.state))})
            if self.pressure.evict_now:
                n = self.blocks.evict_parked(self.pressure.evict_batch)
                if n:
                    self.stats.record_parked_evictions(n)

        if tr is not None:
            t_d = t = tr.now()
        admitted = self._admit()
        if admitted:
            self.stats.record_admission(len(admitted))
        if tr is not None:
            tr.complete("engine.admit", t, track=self._trace_track,
                        args={"admitted": len(admitted),
                              "running": len(self._running),
                              "waiting": len(self._waiting)})
        self.peak_resident_seqs = max(self.peak_resident_seqs,
                                      len(self._running))
        self.stats.record_prefill_queue(
            sum(1 for r in self._running if r.cached < len(r.tokens))
            + len(self._waiting))

        if tr is not None:
            t = tr.now()
        chunks = self._schedule_prefill_chunks()
        # decode-ready set (chunk owners are still mid-prefill, so the
        # row classes are disjoint by construction)
        batch = [r for r in self._running if self._decode_ready(r)]
        # speculative sequences pack a [last_token, drafts...] window;
        # everything else packs a single decode token in the same launch
        spec, batch = self._split_spec(batch)
        spec, demoted = self._reserve_verify_pages(spec)
        batch.extend(demoted)
        # verify reservation/CoW may have preempted plain-decode members
        batch = [r for r in batch
                 if r in self._running and self._decode_ready(r)]
        batch = self._reserve_decode_pages(batch)
        # every reservation above can preempt a chunk owner or an
        # already-reserved row: re-filter each class against the
        # surviving running set
        chunks = [(r, n) for r, n in chunks if r in self._running]
        spec = [(r, d, q) for r, d, q in spec if r in self._running]
        batch = [r for r in batch if r in self._running]
        batch.sort(key=lambda r: r.slot)
        if tr is not None:
            tr.complete("engine.schedule", t, track=self._trace_track,
                        args={"chunks": len(chunks), "spec": len(spec),
                              "decode": len(batch)})

        if chunks or spec or batch:
            t0 = time.perf_counter()
            if not (self.decode_window > 1 and not chunks and not spec
                    and self._window_eligible(batch)
                    and self._dispatch_window(batch, t0)):
                with record_function("llm_engine.ragged_step"):
                    (result, logits), spec_slices, chunk_slots, \
                        batch_slots = self._run_ragged(chunks, spec, batch)
                    host, host_logits, ready = self._read_back(
                        result, logits if spec else None)
                self._inflight = _StepTicket(
                    chunks=chunks, spec=spec, batch=batch, result=host,
                    logits=host_logits, ready=ready,
                    spec_slices=spec_slices, chunk_slots=chunk_slots,
                    batch_slots=batch_slots,
                    dispatch_s=time.perf_counter() - t0,
                    launch_ns=tr.now() if tr is not None else 0,
                    inflight=self.overlap)
        # the prestage's page credit expires: every page it reserved is
        # now owned by a row this dispatch packed (its ensure() found the
        # page in place) or went back with a retired row
        self._spec_pages.clear()
        if tr is not None:
            tr.complete("engine.dispatch", t_d, track=self._trace_track,
                        args={"chunks": len(chunks), "spec": len(spec),
                              "decode": len(batch),
                              "launched": self._inflight is not None})

    def _read_back(self, result, logits=None):
        """Queue the device result's copy (and the verify logits', for a
        launch that carries spec rows) to host memory behind the launch:
        on a CUDA device non-blocking copies into pinned memory and an
        event after them (the completion waits on the event, not on the
        stream); on the CPU the tensors themselves.  The logits land in
        one pinned [Lq, V] buffer, reused launch after launch: a
        completion consumes them before the next dispatch queues its
        copy.  Returns (result, logits or None, event or None)."""
        if result.device.type != "cuda":
            return result, logits, None
        host = torch.empty(result.shape, dtype=result.dtype,
                           pin_memory=True)
        host.copy_(result, non_blocking=True)
        if logits is not None:
            if self._logits_host is None:
                self._logits_host = torch.empty(
                    logits.shape, dtype=logits.dtype, pin_memory=True)
            logits = self._logits_host.copy_(logits, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record()
        return host, logits, ready

    def _complete(self, finished: list, drop_rid=None) -> None:
        """Wait for the in-flight ticket's read-back, then apply and
        retire.  ``drop_rid`` (abort while in flight) discards that
        request's rows unapplied: no token commit, no retirement.  The
        fault plan's in-flight seams fire first (a crash here drops the
        launch, and the prestaged pack with it), and its NaN seam flips
        one live row's finiteness flag."""
        ticket = self._inflight
        self._inflight = None
        plan = self.fault_plan
        if plan is not None and ticket.inflight:
            # completion-order seams: fire while the ticket is in flight
            # (overlap on), between launch and read-back -- the window a
            # device fault or a host stall would hit
            slow = plan.take_inflight_slow()
            if slow > 0.0:
                self.stats.record_fault("inflight_slow")
                time.sleep(slow)
            if plan.take_inflight_crash():
                self.stats.record_fault("inflight_crash")
                raise InjectedFault(
                    f"injected in-flight crash at plan step {plan.step}")
        tr = self.tracer
        if tr is not None:
            t_c = t = tr.now()
        t0 = time.perf_counter()
        if ticket.ready is not None:
            ticket.ready.synchronize()
        res = ticket.result.numpy()
        block_s = time.perf_counter() - t0
        # ONE host round trip a completion, whether the launch carried one
        # step or a whole K-token window
        self.stats.record_round_trip()
        if tr is not None:
            tr.complete("engine.block_on_result", t, track=self._trace_track)
            if ticket.launch_ns and ticket.inflight:
                # launch -> read back: the window host work hides inside
                # (synchronous tickets emit none: nothing ran meanwhile)
                tr.complete("engine.device_inflight", ticket.launch_ns,
                            track=self._trace_track,
                            args={"rows": len(ticket.chunks)
                                  + len(ticket.spec) + len(ticket.batch)})
        sampled, ok = res[0], res[1].astype(bool)
        if ticket.window:
            # the NaN seam poisons one live row's FIRST window iteration;
            # the drain quarantines it there and drops its later columns
            ok[0] = self._inject_nan(ok[0], list(ticket.batch_slots))
        else:
            ok = self._inject_nan(ok, ticket.chunk_slots + ticket.batch_slots
                                  + [o for o, _ in ticket.spec_slices])
        logits = ticket.logits.numpy() if ticket.spec else None
        chunks, spec, batch = ticket.chunks, ticket.spec, ticket.batch
        chunk_slots, batch_slots = ticket.chunk_slots, ticket.batch_slots
        spec_slices = ticket.spec_slices
        if drop_rid is not None:
            kc = [i for i, (r, _) in enumerate(chunks) if r.rid != drop_rid]
            chunks = [chunks[i] for i in kc]
            chunk_slots = [chunk_slots[i] for i in kc]
            ks = [i for i, (r, _, _) in enumerate(spec)
                  if r.rid != drop_rid]
            spec = [spec[i] for i in ks]
            spec_slices = [spec_slices[i] for i in ks]
            kb = [i for i, r in enumerate(batch) if r.rid != drop_rid]
            batch = [batch[i] for i in kb]
            batch_slots = [batch_slots[i] for i in kb]
        spec_ok = [bool(ok[o:o + n].all()) for o, n in spec_slices]
        spec_logits = [logits[o:o + n] for o, n in spec_slices] \
            if spec else None
        # the engine's active time on this launch (packing + the residual
        # wait); the device time hidden under the prestage and the gap
        # between calls is what the overlap buys
        dur = ticket.dispatch_s + block_s
        self.stats.record_step(dur, dispatch_s=ticket.dispatch_s,
                               block_s=block_s)
        if tr is not None:
            t = tr.now()
        if ticket.window:
            self._apply_window(batch, batch_slots, sampled, ok, dur,
                               finished, ticket.window)
        else:
            self._apply_ragged(chunks, spec, batch, sampled, ok, spec_ok,
                               spec_logits, chunk_slots, batch_slots, dur,
                               finished)
        if tr is not None:
            tr.complete("engine.sample_commit", t, track=self._trace_track,
                        args={"finished": len(finished)})
            tr.complete("engine.complete", t_c, track=self._trace_track,
                        args={"finished": len(finished)})

    def _prestage(self) -> None:
        """Stage the NEXT dispatch's pure-decode pack while the in-flight
        ticket runs on the card.

        A surviving decode row's next position is known before the
        ticket's sampled token is: it packs kv_len + 1 next step.  So the
        page reservation (``ensure``), the block-table rows, the kv-length
        column and the sampling keys are staged into the idle decode
        buffer set; the dispatch patches in only the token column and the
        penalty masks.  The prestage never preempts -- a short pool
        abandons it, and its row-local writes are redone by the normal
        path.  A row the completion retires or quarantines returns its
        reserved page with the rest of its table, and the layout check at
        dispatch discards a stale pack."""
        if not self.overlap:
            return
        ticket = self._inflight
        if ticket.window or ticket.chunks or ticket.spec \
                or not ticket.batch:
            return              # only after per-step pure-decode launches
        if self._waiting:
            return              # the next step admits: a mixed pack
        if any(r.cached < len(r.tokens) for r in self._running):
            return              # a mid-prefill row: a mixed pack
        if self._may_speculate(ticket.batch):
            return              # the next step may pack verify rows
        batch = ticket.batch    # slot-sorted at dispatch
        self._prestaged = None
        tr = self.tracer
        if tr is not None:
            t_p = tr.now()
        # reserve each row's next write: pre-apply cached + 2 is the
        # post-apply cached + 1 the dispatch's ensure() asks for
        for req in batch:
            before = self.blocks.num_free
            try:
                grown = self.blocks.ensure(req.rid, req.cached + 2)
            except BlockPoolExhausted:
                grown = False
            if not grown:
                if tr is not None:
                    tr.complete("engine.prestage", t_p,
                                track=self._trace_track,
                                args={"abandoned": "pool"})
                return
            took = before - self.blocks.num_free
            if took > 0:
                self._spec_pages[req.rid] = \
                    self._spec_pages.get(req.rid, 0) + took
        bi = 1 - self._d_cur            # the set NOT in flight
        buf = self._dbufs[bi]
        layout = tuple(r.rid for r in batch)
        if layout != buf.layout:
            self._restage(buf, batch, layout)
        if tr is not None:
            t = tr.now()
        for s, req in enumerate(batch):
            buf.kvl[s] = req.cached + 2      # post-apply cached + 1
            if req.temperature > 0.0:
                # len(generated) will have grown by one at dispatch
                buf.samp["keys"][s] = self._req_key(req, ahead=1)
        if tr is not None:
            tr.complete("engine.pack", t, track=self._trace_track,
                        args={"rows": len(batch), "prestage": True})
            t = tr.now()
        self._stage_tables(buf, batch)
        if tr is not None:
            tr.complete("engine.block_table_stage", t,
                        track=self._trace_track,
                        args={"rows": len(batch), "prestage": True})
        self._prestaged = (bi, layout)
        if tr is not None:
            tr.complete("engine.prestage", t_p, track=self._trace_track,
                        args={"rows": len(batch)})

    def _invalidate_bt(self, rid: int) -> None:
        """Drop both decode buffer sets' staged block-table rows for rid
        (its table can go stale without a version bump on re-admission
        and is freed outright on preemption)."""
        for buf in self._dbufs:
            buf.bt_ver.pop(rid, None)

    def _break_decode_layout(self) -> None:
        """A mixed launch or a window rewrites tables and row order: both
        decode buffer sets fully restage at their next pure-decode launch,
        and a prestaged pack is discarded."""
        for buf in self._dbufs:
            buf.layout = ()
            buf.bt_ver.clear()
        self._prestaged = None

    def _apply_ragged(self, chunks, spec, batch, sampled, ok, spec_ok,
                      spec_logits, chunk_slots, batch_slots, dur, finished):
        """Advance every packed row from the launch's outputs: chunk rows
        commit their prefix (emitting a first token when the prompt
        completes), spec rows run host-side draft acceptance, decode rows
        emit one token.  A row whose logits came back non-finite is
        QUARANTINED before any of its state commits.  The launch duration
        splits across the stats channels pro-rata by packed tokens."""
        chunk_tokens = sum(n for _, n in chunks)
        spec_tokens = sum(len(d) + 1 for _, d, _ in spec)
        total = max(chunk_tokens + spec_tokens + len(batch), 1)
        occ = len(self._running) / self.max_num_seqs
        tr = self.tracer

        done = 0
        for (req, n), s in zip(chunks, chunk_slots):
            if not ok[s]:
                self._quarantine(req, finished)
                continue
            req.cached += n
            if self.enable_prefix_caching:
                self.blocks.commit_prefill(req.rid, n)
            if tr is not None:
                tr.instant("request.prefill_chunk", track=self._trace_track,
                           args={"rid": req.rid, "tokens": n,
                                 "done": req.cached >= len(req.tokens)})
            fl = self.flight
            if fl is not None:
                fl.prefill_chunk(req.rid, n)
            if req.cached == len(req.tokens):
                done += 1
                tok = int(sampled[s])
                req.generated.append(tok)
                if req.seen is not None:
                    req.seen[tok] = True
                if len(req.generated) == 1:
                    ttft = time.perf_counter() - req.t_arrival
                    self.stats.record_ttft(ttft)
                    if fl is not None:
                        fl.first_token(req.rid, ttft)
                    if tr is not None:
                        tr.instant("request.first_token",
                                   track=self._trace_track,
                                   args={"rid": req.rid})
                self._notify_tokens(req, (tok,))
                self._maybe_retire(req, finished)
        if chunks:
            self.stats.record_prefill(dur * chunk_tokens / total,
                                      chunk_tokens, done)

        if spec:
            n_emitted = 0
            for i, ((req, drafts, qd), lg) in enumerate(
                    zip(spec, spec_logits)):
                if not spec_ok[i]:
                    self._quarantine(req, finished)
                    continue
                n_emitted += self._apply_spec_result(req, drafts, qd, lg,
                                                     finished)
            self.stats.record_verify(dur * spec_tokens / total,
                                     n_emitted, occ)

        for req, s in zip(batch, batch_slots):
            if not ok[s]:
                self._quarantine(req, finished)
                continue
            if self.enable_prefix_caching:
                self.blocks.commit_decode_token(req.rid,
                                                req.generated[-1])
            req.cached += 1
            tok = int(sampled[s])
            req.generated.append(tok)
            if req.seen is not None:
                req.seen[tok] = True
            self._notify_tokens(req, (tok,))
            self._maybe_retire(req, finished)
        if batch:
            self.stats.record_decode(dur * len(batch) / total,
                                     len(batch), occ)

    # ------------------------------------------------------------------
    # device-resident decode window (decode_window > 1)
    # ------------------------------------------------------------------

    def _window_eligible(self, batch: list) -> bool:
        """True when this step's pack may run as a K-step window: a steady
        pure-decode state -- every runner decode-ready, nobody waiting
        for a slot (a window would delay their admission by up to K
        steps), and no row about to carry a verify window.  The caller
        has established that no chunk or spec rows are packed; the
        per-step path remains the fallback."""
        return bool(batch) and not self._waiting \
            and len(batch) == len(self._running) \
            and not self._may_speculate(batch)

    def _may_speculate(self, rows) -> bool:
        """True when one of ``rows`` may pack a verify window next step
        (speculation on for it, and a drafter to propose)."""
        return self.drafter is not None and any(
            not r.spec_disabled and r.spec_k > 0 for r in rows)

    def _reserve_window_pages(self, batch: list, k: int):
        """Reserve each row's k tokens of page slack before the window
        launches (clamped to the row's remaining budget: a row frozen
        after m < k tokens writes m positions).  All or nothing at this
        k: None, with the pool as found, when it cannot cover the window.
        No copy-on-write here: the per-step reservation of this dispatch
        privatized the page of the first write, and every page the window
        crosses into past it is freshly allocated."""
        return self.blocks.reserve_window(
            [(req.rid, req.cached + min(k, req.max_new_tokens
                                        - len(req.generated)))
             for req in batch])

    def _dispatch_window(self, batch: list, t0: float) -> bool:
        """Reserve, pack and launch one window over ``batch`` (slot-sorted,
        first-write pages ensured).  When K tokens of slack do not fit the
        reservation retries at K-1, K-2, ... and runs the largest K' that
        fits (counted as a shrink); the per-row budgets freeze every row
        after K' tokens.  Returns False, counted as a fallback, when not
        even 2 tokens fit: the caller runs the per-step path."""
        K = self.decode_window
        kp = next((k for k in range(K, 1, -1)
                   if self._reserve_window_pages(batch, k) is not None), 0)
        tr = self.tracer
        if kp == 0:
            self.stats.record_window_fallback()
            if tr is not None:
                tr.instant("engine.window_fallback", track=self._trace_track,
                           args={"rows": len(batch), "k": K})
            return False
        if kp < K:
            self.stats.record_window_shrink()
            if tr is not None:
                tr.instant("engine.window_shrink", track=self._trace_track,
                           args={"rows": len(batch), "k": K, "kp": kp})
        B = self.max_num_seqs
        n = len(batch)
        toks = np.zeros((B,), np.int32)
        kvl = np.zeros((B,), np.int32)
        gen = np.zeros((B,), np.int32)
        budgets = np.zeros((B,), np.int32)
        eos_ids = np.full((B,), -1, np.int32)     # -1: no eos (ids >= 0)
        base_keys = np.zeros((B, 2), np.uint32)
        bt = np.full((B + 1, self.nblk), NULL_BLOCK, np.int32)
        samp = make_samp(B, self.config.vocab_size)
        if tr is not None:
            t = tr.now()
        for s, req in enumerate(batch):
            toks[s] = req.generated[-1]
            kvl[s] = req.cached + 1
            gen[s] = len(req.generated)
            budgets[s] = min(req.max_new_tokens, len(req.generated) + kp)
            if req.eos_token_id is not None:
                eos_ids[s] = int(req.eos_token_id)
            self._fill_samp(samp, s, req, key=False)
            if req.temperature > 0.0:
                # the body re-derives fold_in(PRNGKey(seed), generated)
                # every iteration: the key _req_key makes on the host
                base_keys[s] = (0, req.seed & prng._MASK)
        if tr is not None:
            tr.complete("engine.pack", t, track=self._trace_track,
                        args={"rows": n, "window": kp})
            t = tr.now()
        for s, req in enumerate(batch):
            bt[s] = self.blocks.padded_table(req.rid, self.nblk)
        if tr is not None:
            tr.complete("engine.block_table_stage", t,
                        track=self._trace_track,
                        args={"rows": n, "window": kp})
        # the window grows tables past what the per-step buffers staged
        self._break_decode_layout()
        # every row is frozen by its budget after this many iterations
        # (an eos may freeze it sooner; its later columns are not read)
        iters = int((budgets[:n] - gen[:n]).max())
        if tr is not None:
            t = tr.now()
        with record_function("llm_engine.window_step"):
            result = self._launch_window(iters, n, toks, kvl, gen, budgets,
                                         eos_ids, base_keys, bt, samp)
            host, _, ready = self._read_back(result)
        if tr is not None:
            tr.complete("engine.device_launch", t, track=self._trace_track,
                        args={"rows": n, "window": kp})
        self._inflight = _StepTicket(
            chunks=[], spec=[], batch=list(batch), result=host, logits=None,
            ready=ready, spec_slices=[], chunk_slots=[],
            batch_slots=list(range(n)),
            dispatch_s=time.perf_counter() - t0,
            launch_ns=tr.now() if tr is not None else 0,
            inflight=self.overlap, window=iters)
        return True

    def _apply_window(self, batch, batch_slots, sampled, ok, dur, finished,
                      window):
        """Drain one completed window: the [K', B] token and finiteness
        grids commit as up to K' per-token steps per row, in
        iteration-major order -- the per-step path's sequence (cache
        commit of the previous token, append, penalty mask, retire check),
        so the prefix cache and retirement are those of K=1.  A row
        leaves the walk when it retires (eos/length, the predicates that
        froze it on the card) or quarantines on a non-finite iteration;
        its later columns are frozen filler and never committed.  The
        drain stops at the launched K'."""
        K = min(int(sampled.shape[0]), int(window))
        occ = len(self._running) / self.max_num_seqs
        alive = {req.rid for req in batch}
        committed = iters = 0
        for i in range(K):
            if not alive:
                break
            iters += 1
            for req, s in zip(batch, batch_slots):
                if req.rid not in alive:
                    continue
                if not ok[i, s]:
                    alive.discard(req.rid)
                    self._quarantine(req, finished)
                    continue
                if self.enable_prefix_caching:
                    self.blocks.commit_decode_token(req.rid,
                                                    req.generated[-1])
                req.cached += 1
                tok = int(sampled[i, s])
                req.generated.append(tok)
                if req.seen is not None:
                    req.seen[tok] = True
                committed += 1
                self._notify_tokens(req, (tok,))
                self._maybe_retire(req, finished)
                if req not in self._running:
                    alive.discard(req.rid)
        self.pad_stats["real"] += committed
        self.pad_stats["padded"] += iters * self.max_num_seqs
        self.pad_stats["legacy_padded"] += iters * self.max_num_seqs
        if committed:
            self.stats.record_decode(dur, committed, occ, rounds=iters)

    def _quarantine(self, req, finished: list) -> None:
        """Retire one sequence whose step logits came back non-finite.
        Its pages leave through ``release`` (decref-only, the unshared
        tail never registers in the prefix cache, so corrupt K/V never
        becomes a future hit); finish_reason is "numerical_error"."""
        self.blocks.release(req.rid)
        self._spec_pages.pop(req.rid, None)
        self._running.remove(req)
        self._release_slot(req)
        if self.drafter is not None:
            self.drafter.release(req.rid)
        out = RequestOutput(rid=req.rid, prompt=list(req.prompt),
                            generated=list(req.generated),
                            finish_reason="numerical_error")
        if self.retain_outputs:
            self._finished[req.rid] = out
        finished.append(out)
        self.stats.record_quarantine()
        self.stats.record_abort("numerical_error")
        if self.stats.windows is not None:
            self.stats.record_finish_quality(False)
            self.stats.record_request_latency(
                time.perf_counter() - req.t_arrival)
        fl = self.flight
        if fl is not None:
            fl.finished(req.rid, reason="numerical_error",
                        generated=len(req.generated), tier=self._tier(),
                        quarantined=True)
        tr = self.tracer
        if tr is not None:
            tr.instant("engine.quarantine", track=self._trace_track,
                       args={"rid": req.rid})
            tr.async_end("req", f"{self._trace_track}:{req.rid}",
                         args={"finish_reason": "numerical_error"})
        if req.on_finish is not None:
            req.on_finish(out)

    # ------------------------------------------------------------------
    # hierarchical KV tier (host-memory spill pool, inference/kv_tier.py)
    # ------------------------------------------------------------------

    def prefetch_hint(self, hashes) -> None:
        """Pre-stage a returning user's spilled pages: queue the prefix
        chain hashes of a prompt about to be submitted so the next
        step-boundary drain restores them before the prefill is packed.
        Thread-safe (the tier's hint deque is locked): the one engine
        entry point the frontend router may call off-thread.  No-op
        without a tier."""
        tier = self.kv_tier
        if tier is not None:
            tier.hint(hashes)

    @torch.no_grad()
    def _drain_kv_tier(self) -> None:
        """Step-boundary tier drain: the only place spill/restore bytes
        cross between the card and host memory, and the one place the
        step may wait for the card (no launch is in flight here; nothing
        of it sits in ``_dispatch`` or ``_prestage``).  Spill: the pages
        evict_parked quarantined are gathered with one indexed read per
        pool, copied to the host once, and their blocks free.  Restore:
        router prefetch hints, then the waiting queue's prompt chains,
        pull tier-resident pages back into free blocks, written in place
        into the existing pools (their addresses never change; under tp
        each shard's block of heads into its own pools) and re-registered
        content-addressed -- from admission's point of view they are
        ordinary prefix-cache content.  Restored bytes are the exact
        spilled bytes, scales included for int8 pages."""
        tier = self.kv_tier
        tr = self.tracer
        names = self._pool_names()
        pending = self.blocks.take_spill_pending()
        if pending:
            # a host entry holds the page's full head axis, the shards'
            # blocks concatenated in shard order: the same page spills to
            # the same bytes at any tp
            blocks = [b for b, _ in pending]
            host = {}
            for k in names:
                parts = [getattr(sh, k).index_select(1, torch.as_tensor(
                    blocks, device=sh.device)).cpu() for sh in self._shards]
                host[k] = parts[0] if len(parts) == 1 \
                    else torch.cat(parts, 2)
            stored = 0
            for i, (_blk, hashes) in enumerate(pending):
                if tier.insert(hashes, {k: h[:, i].clone()
                                        for k, h in host.items()}):
                    stored += 1
                # these hashes left the card: a past restore no longer
                # backs a future admission hit
                self._staged_hashes.difference_update(hashes)
            self.stats.record_kv_spill(len(pending), stored)
            if tr is not None:
                tr.instant("kv_tier.spill", track=self._trace_track,
                           args={"pages": len(pending), "stored": stored})

        restored = []                     # [(block, tier entry)]
        for h in self._tier_wanted_hashes(tier):
            if not self.blocks.num_free:
                break                     # opportunistic: never evict
            if self.blocks.has_hash(h):
                continue                  # covered earlier this drain
            entry = tier.take(h)
            if entry is None:
                continue
            blk = self.blocks.adopt_restored(entry["hashes"])
            if blk is None:               # unreachable given the guards
                tier.insert(entry["hashes"], entry["arrays"])
                break
            restored.append((blk, entry))
            self._staged_hashes.update(entry["hashes"])
        if restored:
            # restored int8 blocks are not fresh (adopt_restored discarded
            # them), so the launch's fresh-page reset keeps their scales
            blocks = [b for b, _ in restored]
            for k in names:
                pages = torch.stack([e["arrays"][k] for _, e in restored], 1)
                w = pages.shape[2] // self.tp
                for s, sh in enumerate(self._shards):
                    pool = getattr(sh, k)
                    pool.index_copy_(1, torch.as_tensor(
                        blocks, device=sh.device),
                        pages[:, :, s * w:(s + 1) * w].to(pool.device))
            self.stats.record_kv_restore(len(restored))
            if tr is not None:
                tr.instant("kv_tier.restore", track=self._trace_track,
                           args={"pages": len(restored)})
        self.stats.set_spill_tier(tier.stats())

    def _tier_wanted_hashes(self, tier) -> list:
        """Chain hashes worth restoring this drain, in chain order,
        deduped: router prefetch hints first (pre-staging a returning
        user), then the waiting queue's front prompts (admission's tier
        consult on a prefix-cache miss, one-shot per waiting episode).
        Each chain walks while its prefix stays servable -- resident
        hashes skip, tier-resident ones restore, and the walk stops at
        the first hash neither holds (a contiguous prefix match can never
        reach later pages)."""
        chains = tier.drain_hints()
        n = 0
        for req in self._waiting:
            if n >= self.max_num_seqs:
                break
            n += 1
            if req.tier_checked == tier.gen:
                continue          # nothing new spilled since last consult
            req.tier_checked = tier.gen
            chains.append(prefix_chain_hashes(req.tokens, self.block_size))
        wanted: list = []
        seen: set = set()
        for chain in chains:
            for h in chain:
                if self.blocks.has_hash(h) or h in seen:
                    continue
                if tier.lookup(h):
                    seen.add(h)
                    wanted.append(h)
                else:
                    break
        return wanted

    def _claim_slot(self, req) -> None:
        req.slot = self._slot_used.index(False)
        self._slot_used[req.slot] = True

    def _release_slot(self, req) -> None:
        if req.slot >= 0:
            self._slot_used[req.slot] = False
            req.slot = -1

    def _admit(self) -> list:
        """Pull waiting requests into the running set while batch slots
        and pool pages allow.  With prefix caching, admission matches the
        prompt's token chain against the cache and allocates only the
        miss suffix.  A pressure controller's admission pause admits
        nobody."""
        if self.pressure is not None and self.pressure.admission_paused:
            return []
        admitted = []
        while self._waiting and len(self._running) < self.max_num_seqs:
            req = self._waiting[0]
            if self.enable_prefix_caching:
                hit = self.blocks.acquire(req.rid, req.tokens)
                if hit is None:
                    break
                req.cached = hit
                self.stats.record_cache_lookup(hit, len(req.tokens) - hit)
                if hit and self._staged_hashes:
                    # prefetch-hit attribution: hit pages whose chain
                    # hashes a tier restore staged (by hash, so block
                    # reuse cannot misattribute); each pays out once
                    used = [h for h in self.blocks.chain_hashes(req.rid)
                            if h in self._staged_hashes]
                    if used:
                        self._staged_hashes.difference_update(used)
                        self.stats.record_prefetch_hits(len(used))
            else:
                if not self.blocks.allocate(req.rid, len(req.tokens)):
                    break
                req.cached = 0
            self._waiting.popleft()
            req.arrival = self._arrival
            self._arrival += 1
            self._invalidate_bt(req.rid)
            self._claim_slot(req)
            self._running.append(req)
            admitted.append(req)
            qw = time.perf_counter() - req.t_arrival
            self.stats.record_queue_wait(qw)
            fl = self.flight
            if fl is not None:
                fl.admitted(req.rid, queue_wait_s=qw,
                            cache_hit_tokens=req.cached, tier=self._tier())
        return admitted

    def _schedule_prefill_chunks(self) -> list:
        """Pack at most max_prefill_tokens pending prompt tokens into this
        step, FCFS, resuming partially-prefilled requests first
        (``policy.pack_prefill_chunks``).  Copy-on-write of each chunk's
        first write position hangs on the admit hook, so a CoW preemption
        skips the victim without consuming budget."""
        chunks: list = []

        def admit(req):
            if req not in self._running:
                return False
            if self.enable_prefix_caching:
                return self._resolve_cow(req, req.cached, drop_from=chunks)
            return True

        ordered = sorted(list(self._running), key=lambda r: r.arrival)
        return pack_prefill_chunks(
            ((r, len(r.tokens) - r.cached) for r in ordered),
            self.max_prefill_tokens, admit=admit, out=chunks)

    def _resolve_cow(self, req, pos: int, drop_from: list | None = None) \
            -> bool:
        """Privatize the page holding ``pos`` if it is shared, preempting
        victims while the pool has no page for the copy.  False when req
        itself had to be preempted."""
        while True:
            try:
                cw = self.blocks.cow_if_shared(req.rid, pos)
            except BlockPoolExhausted:
                victim = self._pick_victim(exclude=req)
                if victim is None:
                    self._preempt(req)
                    return False
                self._preempt(victim)
                if drop_from is not None:
                    drop_from[:] = [c for c in drop_from
                                    if c[0] is not victim]
                continue
            if cw is not None:
                self._apply_cow(*cw)
                self.stats.record_cow()
            return True

    def _reserve_decode_pages(self, batch: list) -> list:
        """Grow each sequence's table for the token this step will write
        (plus a private copy of a still-shared tail page); preempt the
        youngest runner whenever the pool comes up short."""
        ok = []
        for req in sorted(batch, key=lambda r: r.arrival):
            if req not in self._running:   # evicted as a victim earlier
                continue
            while req is not None:
                if not self.blocks.ensure(req.rid, req.cached + 1):
                    victim = self._pick_victim(exclude=req)
                    if victim is None:
                        self._preempt(req)
                        req = None
                        break
                    self._preempt(victim)
                    ok = [r for r in ok if r is not victim]
                    continue
                if self.enable_prefix_caching:
                    if not self._resolve_cow(req, req.cached):
                        req = None
                        break
                    ok = [r for r in ok if r in self._running]
                break
            if req is not None:
                ok.append(req)
        return ok

    def _pick_victim(self, exclude):
        """Youngest-arrival running sequence other than ``exclude``."""
        cands = [r for r in self._running if r is not exclude]
        if not cands:
            return None
        return max(cands, key=lambda r: r.arrival)

    def _preempt(self, req) -> None:
        """Return req's pages and requeue it (front of the line) for
        recomputation over prompt + tokens generated so far, which
        rebuilds the exact KV state: greedy decoding resumes
        token-identically, and with prefix caching the recompute hits the
        pages this preemption just parked."""
        self.blocks.free(req.rid)
        self._spec_pages.pop(req.rid, None)
        self._running.remove(req)
        self._release_slot(req)
        req.tokens = list(req.prompt) + list(req.generated)
        req.cached = 0
        # its freed pages may spill while it waits: re-consult the tier
        req.tier_checked = -1
        self._invalidate_bt(req.rid)
        self._waiting.appendleft(req)
        if self.drafter is not None:
            self.drafter.release(req.rid)
        self.stats.record_preemption()
        fl = self.flight
        if fl is not None:
            fl.preempted(req.rid)
        if self.tracer is not None:
            self.tracer.instant("request.preempted", track=self._trace_track,
                                args={"rid": req.rid})

    def _maybe_retire(self, req, finished: list) -> None:
        eos = req.eos_token_id
        if eos is not None and req.generated[-1] == int(eos):
            reason = "eos"
        elif len(req.generated) >= req.max_new_tokens:
            reason = "length"
        else:
            return
        tr = self.tracer
        if tr is not None:
            t = tr.now()
        self.blocks.free(req.rid)
        self._spec_pages.pop(req.rid, None)
        self._running.remove(req)
        self._release_slot(req)
        if self.drafter is not None:
            self.drafter.release(req.rid)
        out = RequestOutput(rid=req.rid, prompt=list(req.prompt),
                            generated=list(req.generated),
                            finish_reason=reason)
        if self.retain_outputs:
            self._finished[req.rid] = out
        finished.append(out)
        self.stats.record_retirement()
        if self.stats.windows is not None:
            self.stats.record_finish_quality(True)
            self.stats.record_request_latency(
                time.perf_counter() - req.t_arrival)
        fl = self.flight
        if fl is not None:
            fl.finished(req.rid, reason=reason,
                        generated=len(req.generated), tier=self._tier())
        if tr is not None:
            tr.complete("engine.retire", t, track=self._trace_track,
                        args={"rid": req.rid, "finish_reason": reason})
            tr.async_end("req", f"{self._trace_track}:{req.rid}",
                         args={"finish_reason": reason,
                               "generated": len(req.generated)})
        if req.on_finish is not None:
            req.on_finish(out)

    # ------------------------------------------------------------------
    # speculative decoding: propose -> verify -> accept/rollback
    # ------------------------------------------------------------------

    def _split_spec(self, batch: list):
        """Ask the drafter for up to spec_k tokens per eligible sequence.
        Sequences with no proposal (or speculation off/disabled/cut to
        zero by length limits) fall through to plain decode."""
        if self.drafter is None:
            return [], batch
        spec, plain = [], []
        cap = self.max_spec_k
        if self.pressure is not None:
            # under pressure, shrinking drafts is the cheapest lever:
            # verify windows are the largest transient page consumers
            cap = self.pressure.spec_k_cap(self.max_spec_k)
        for req in batch:
            k = 0 if req.spec_disabled else min(req.spec_k, cap)
            # the verify step writes K/V at cached..cached+k, so the
            # sequence may hold at most max_model_len tokens afterwards;
            # drafting past max_new_tokens (plus the bonus token) is waste
            k = min(k,
                    self.max_model_len - len(req.prompt) - len(req.generated),
                    req.max_new_tokens - len(req.generated) - 1)
            if k <= 0:
                plain.append(req)
                continue
            context = list(req.prompt) + list(req.generated)
            drafts, qd = self.drafter.propose(req.rid, context, k)
            if not drafts:
                plain.append(req)
                continue
            spec.append((req, [int(t) for t in drafts[:k]], qd))
        return spec, plain

    def _page_starts(self, a: int, b: int) -> list:
        """First written position in each page the write window [a, b]
        (inclusive) touches -- the positions _resolve_cow must
        privatize."""
        bs = self.block_size
        out = [a]
        p = (a // bs + 1) * bs
        while p <= b:
            out.append(p)
            p += bs
        return out

    def _reserve_verify_pages(self, spec: list):
        """Grow each speculative sequence's table for its k+1 writes and
        privatize every shared page in the window.  The pool is never
        preempted FOR speculation: when ensure() comes up short the draft
        shrinks (k -> k-1 -> ... -> plain decode) instead.  CoW of the
        first write position is required for plain decode too, so that
        path keeps the usual victim-preemption behaviour.  Returns (spec
        rows kept, rows demoted to plain decode)."""
        ok, demoted = [], []
        for req, drafts, qd in spec:
            if req not in self._running:
                continue
            k = len(drafts)
            while k > 0 and not self.blocks.ensure(req.rid,
                                                   req.cached + k + 1):
                k -= 1
            if k == 0:
                demoted.append(req)
                continue
            drafts = drafts[:k]
            if self.enable_prefix_caching:
                alive = True
                for pos in self._page_starts(req.cached, req.cached + k):
                    if not self._resolve_cow(req, pos):
                        alive = False           # req itself was preempted
                        break
                ok = [it for it in ok if it[0] in self._running]
                if not alive:
                    continue
            ok.append((req, drafts, qd))
        return ok, demoted

    def _apply_spec_result(self, req, drafts, qd, lg, finished) -> int:
        """Turn one sequence's verify logits into emitted tokens: run
        rejection-sampling acceptance, commit the accepted prefix's K/V,
        truncate the rejected tail out of the page table (scrubbing its
        content hashes), and advance the request exactly as that many
        plain decode steps would have.  Returns tokens emitted."""
        k = len(drafts)
        rng = None
        if req.temperature > 0.0:
            # keyed by (seed, position): reproducible across scheduling
            # orders and preemptions, like _req_key on the device path
            rng = np.random.Generator(np.random.Philox(
                key=[req.seed & 0xFFFFFFFF, len(req.generated)]))
        n_acc, emitted = verify_and_accept(
            lg, drafts, q_dists=qd, temperature=req.temperature,
            top_k=req.top_k, top_p=req.top_p,
            penalty=req.repetition_penalty, seen=req.seen, rng=rng)
        # cut to the generation budget, and at the first eos token
        room = req.max_new_tokens - len(req.generated)
        emitted = emitted[:room]
        if req.eos_token_id is not None:
            eos = int(req.eos_token_id)
            if eos in emitted:
                emitted = emitted[:emitted.index(eos) + 1]
        m = len(emitted)                              # >= 1: room >= 1
        # K/V validity: positions cached..cached+n_acc hold
        # [generated[-1], accepted drafts]; m <= n_acc + 1 tokens advance
        # the clock, and when the m-th is the bonus/resample its K/V is
        # written by the NEXT step (decode invariant), not this one.
        if self.enable_prefix_caching:
            for tok in [req.generated[-1]] + emitted[:m - 1]:
                self.blocks.commit_decode_token(req.rid, tok)
        req.cached += m
        # roll the speculative tail (rejected drafts + over-reserved
        # pages) back out of the table; prefix-cache hashes covering
        # rolled-back K/V are scrubbed inside truncate
        rolled = self.blocks.truncate(req.rid, req.cached)
        req.generated.extend(emitted)
        if req.seen is not None:
            req.seen[emitted] = True
        self._notify_tokens(req, emitted)
        j = m - 1 if m == n_acc + 1 else m            # emitted draft count
        if k:                                         # zero-draft rows are
            req.spec_proposed += k                    # plain decode riding
            req.spec_accepted += min(j, n_acc)        # the verify launch
            self.stats.record_spec(proposed=k, accepted=min(j, n_acc),
                                   emitted=m, rollback=k - j,
                                   pages_rolled=rolled)
            fl = self.flight
            if fl is not None:
                fl.spec_round(req.rid, min(j, n_acc), k - j)
            if (not req.spec_disabled
                    and req.spec_proposed >= self.spec_window
                    and req.spec_accepted
                    < self.spec_accept_floor * req.spec_proposed):
                req.spec_disabled = True
                self.stats.record_spec_disable()
            self.drafter.commit(
                req.rid, len(req.prompt) + len(req.generated) - (m - j))
        self._maybe_retire(req, finished)
        return m

    # ------------------------------------------------------------------
    # device side: copy-on-write and the ragged step
    # ------------------------------------------------------------------

    @torch.no_grad()
    def _apply_cow(self, src: int, dst: int) -> None:
        """Copy page src -> dst across every layer's K and V pool of every
        shard (queued on the stream ahead of any later write into dst).  In int8 mode
        the page's scale rows travel with it: dst is a live replica, which
        BlockManager keeps out of the fresh set."""
        for sh in self._shards:
            for name in self._pool_names():
                pool = getattr(sh, name)
                pool[:, dst] = pool[:, src]

    def _ragged_bucket(self, n_tokens: int) -> int:
        """Flat-token bucket for a launch: decode-sized launches pad to
        max_num_seqs; with a drafter, speculation-sized launches stop at
        the logit-row width max_num_seqs * (max_spec_k + 1) when that sits
        below the prefill bucket; anything larger rounds up to a multiple
        of prefill_token_bucket (the JAX engine's ladder, kept so padding
        accounting -- and a later CUDA-graph capture per bucket -- match)."""
        if n_tokens <= self.max_num_seqs:
            return self.max_num_seqs
        if self._with_logits and \
                n_tokens <= self._Lq < self.prefill_token_bucket:
            return self._Lq
        tb = self.prefill_token_bucket
        return -(-n_tokens // tb) * tb

    def _upload(self, parts: list) -> list:
        """One host-to-device copy for several int32 host arrays; returns
        their device views (1-D, in order).  On a CUDA device the arrays
        are concatenated into a pinned staging buffer (two, alternated
        launch by launch) and copied without blocking: a copy from
        pageable memory would make the host wait for the stream to drain,
        undoing the overlap.  On the CPU the views alias one new array."""
        sizes = [p.size for p in parts]
        n = sum(sizes)
        flat = [p.reshape(-1) for p in parts]
        if self.device.type == "cuda":
            i = self._stage_i
            self._stage_i ^= 1
            stage = self._stages[i]
            if stage is None or stage.numel() < n:
                stage = torch.empty(max(n, 1024), dtype=torch.int32,
                                    pin_memory=True)
                self._stages[i] = stage
            np.concatenate(flat, out=stage.numpy()[:n])
            packed = stage[:n].to(self.device, non_blocking=True)
        else:
            packed = torch.from_numpy(np.concatenate(flat))
        return list(torch.split(packed, sizes))

    def _reset_fresh(self, fresh_d) -> None:
        """Zero the scale rows of the pages handed out since the last
        launch (int8 pages): their old scales are dead (step 1 of the
        quantize-at-commit, every layer).  ``index_fill_``: an indexed
        assignment of a Python scalar synchronizes the host with the
        card."""
        if fresh_d.numel():
            fresh_d = fresh_d.long()
            for sh in self._shards:
                f = _to(fresh_d, sh.device)
                sh.ks.index_fill_(1, f, 0.0)
                sh.vs.index_fill_(1, f, 0.0)

    @torch.no_grad()
    def _logits(self, toks, blk, slot, bt, seg, rel, lidx=None):
        """The decoder over Tq packed tokens, on the card: each layer
        writes the tokens' K/V into page ``blk`` at ``slot`` (quantized at
        commit for int8 pages), then ragged paged attention lets every
        token attend to table row ``seg[t]`` causally up to position
        ``rel[t]``.  Returns the f32 logits [Lq, V] of the rows ``lidx``
        (every token when None).  The per-step launch and every window
        iteration run this body, so their bits agree.

        Under tp each shard, in shard order, projects its block of heads
        from the layer's normed activations, commits its K/V into its own
        pools and attends over them with the same kernel entries at
        nh/tp and kvh/tp heads; the blocks are concatenated along heads
        on the lead device before the replicated wo."""
        Tq = toks.shape[0]
        nh, kvh, d = self._nh // self.tp, self._kvh // self.tp, self._hd
        eps = self.config.rms_norm_eps
        theta = self.config.rope_theta
        mm = self._mm
        layers = self.params["layers"]
        lead = self.device
        # each shard's copy of the launch's page addressing (the lead's
        # own tensors on the lead device)
        addr = [tuple(_to(t, sh.device) for t in (blk, slot, bt, seg, rel))
                for sh in self._shards]
        x = self._embed(toks.long())                            # [Tq, H]
        for i in range(self.config.num_hidden_layers):
            p = {k: v[i] for k, v in layers.items()}
            h = _rms_weight(x, p["ln1"], eps)
            heads = []
            for sh, (blk_s, slot_s, bt_s, seg_s, rel_s) in zip(self._shards,
                                                               addr):
                hs = _to(h, sh.device)
                ps = {k: v[i] for k, v in sh.layers.items()}
                q = _rope_positions(mm(hs, ps, "wq").view(Tq, nh, d), rel_s,
                                    theta)
                k = _rope_positions(mm(hs, ps, "wk").view(Tq, kvh, d), rel_s,
                                    theta)
                v = mm(hs, ps, "wv").view(Tq, kvh, d)
                if self.kv_dtype == "int8":
                    att = self._commit_q8_and_attend(
                        sh, i, q, k, v, blk_s, slot_s, bt_s, seg_s,
                        rel_s).to(x.dtype)
                else:
                    kcl, vcl = sh.kc[i], sh.vc[i]
                    # K/V of this layer land in the pages BEFORE attention
                    # reads them; pad tokens all write the null page's
                    # slot 0 (a benign race: nothing real reads it)
                    kcl[blk_s, :, slot_s, :] = k.to(kcl.dtype)
                    vcl[blk_s, :, slot_s, :] = v.to(vcl.dtype)
                    att = _pa.ragged_paged_attention_segrel_packed(
                        q, kcl, vcl, bt_s, seg_s, rel_s)
                heads.append(_to(att, lead))
            att = heads[0] if len(heads) == 1 else torch.cat(heads, 1)
            x = x + mm(att.reshape(Tq, self._nh * d), p, "wo")
            h2 = _rms_weight(x, p["ln2"], eps)
            a = torch.nn.functional.silu(mm(h2, p, "gate").float()) \
                .to(h2.dtype) * mm(h2, p, "up")
            x = x + mm(a, p, "down")
        h = _rms_weight(x, self.params["norm_f"], eps)
        return self._head_logits(h if lidx is None else h[lidx.long()])

    @torch.no_grad()
    def _ragged_step(self, Tq, toks, cu, kvl, bt, lidx, samp, fresh):
        """The one serving step: Tq flat query tokens from up to
        max_num_seqs ragged rows through ``_logits``, then the sampler.
        The result is [2, Lq] int32 on the device: the sampled token and
        the all-finite flag of each logit row.

        toks [Tq] (tail padding maps to the sentinel row B); cu [B+1] row
        offsets; kvl [B] valid KV per row AFTER this launch's writes; bt
        [B+1, nblk] (row B: the null row pads resolve to); lidx [Lq] flat
        index of each logit row; samp the host ``make_samp`` dict; fresh
        the pages whose scale rows reset this launch (int8 pages only,
        else empty).  Returns (result, the [Lq, V] f32 logits on the
        device with a drafter, else None)."""
        bs = self.block_size
        B = self.max_num_seqs
        toks_d, cu_d, kvl_d, bt_d, lidx_d, fresh_d = self._upload(
            [toks, cu, kvl, bt, lidx, fresh])
        bt_d = bt_d.view(B + 1, self.nblk)
        self._reset_fresh(fresh_d)
        seg, rel = _pa.ragged_segments(cu_d, kvl_d, Tq)
        blk = bt_d[seg.long(), (rel // bs).long()]              # [Tq]
        slot = (rel % bs).long()
        logits = self._logits(toks_d, blk, slot, bt_d, seg, rel, lidx_d)
        sampled = sample_tokens(logits, samp)
        # per-row finiteness flag: a poisoned row is quarantined host-side
        # without touching its batchmates (padded rows may be non-finite;
        # the host only consults live slots)
        fin = torch.isfinite(logits).all(-1)
        return (torch.stack([sampled, fin.to(torch.int32)]),
                logits if self._with_logits else None)

    @torch.no_grad()
    def _launch_window(self, iters, n, toks, kvl, gen, budgets, eos_ids,
                       base_keys, bt, samp):
        """The device-resident decode window: ``iters`` iterations of the
        per-step body at Tq = max_num_seqs (``_logits``), each followed by
        the bookkeeping the host does between per-step launches -- advance
        the KV lengths, re-derive the sampler keys (``advance_keys``),
        mark the sampled token in the penalty mask, freeze rows whose
        token is their eos or whose budget is full -- all on the card,
        with no host read in between.  Rows 0..n-1 are live; the others,
        and rows as they freeze, keep seg = their row (non-decreasing, as
        the walk requires), read position 0 of their own table row and
        write their K/V to the null page's slot 0.  Int8 pages reset the
        fresh pages' scales once, before iteration 0 (every page of the
        window was handed out at dispatch; a reset inside the loop would
        wipe scales grown by earlier iterations).  Returns [2, iters, B]
        int32 on the device: each iteration's tokens (a frozen row repeats
        its last committed token) and finite flags (true where frozen)."""
        B = self.max_num_seqs
        bs = self.block_size
        dev = self.device
        if "scan" not in self.compile_counts:
            self.compile_counts["scan"] = 1
        fresh = self._consume_fresh() if self.kv_dtype == "int8" \
            else _NO_PAGES
        rows_np, needs_penalty = sampling_plan(samp)
        (tok, kvl_d, gen_d, budgets_d, eos_d, bt_d, rows_d, keys_d,
         fresh_d) = self._upload(
            [toks, kvl, gen, budgets, eos_ids, bt, rows_np.astype(np.int32),
             base_keys[rows_np].view(np.int32), fresh])
        bt_d = bt_d.view(B + 1, self.nblk)
        st = samp_to_device(samp, dev, needs_penalty)
        rows = base = None
        if len(rows_np):
            rows = rows_d.long()
            base = keys_d.view(-1, 2).long() & prng._MASK
        self._reset_fresh(fresh_d)
        active = torch.arange(B, device=dev) < n
        row_ids = torch.arange(B, device=dev)
        null = torch.full_like(tok, NULL_BLOCK)
        out = torch.empty((2, iters, B), dtype=torch.int32, device=dev)
        for i in range(iters):
            seg, rel = _pa.decode_window_segments(active, kvl_d)
            blk = torch.where(active, bt_d[seg.long(), (rel // bs).long()],
                              null)
            slot = (rel % bs).long()        # rel is 0 where frozen
            logits = self._logits(tok, blk, slot, bt_d, seg, rel)
            keys = advance_keys(base, gen_d[rows]) if rows is not None \
                else None
            sampled = sample_tokens_device(logits, st, rows, keys,
                                           needs_penalty)
            fin = torch.isfinite(logits).all(-1)
            sampled = torch.where(active, sampled, tok)
            out[0, i] = sampled
            out[1, i] = (fin | ~active).to(torch.int32)
            if needs_penalty:
                idx = (row_ids, sampled.long())
                st["seen"][idx] = st["seen"][idx] | active
            adv = active.to(torch.int32)
            active = active & (sampled != eos_d) & (gen_d + 1 < budgets_d)
            tok, kvl_d, gen_d = sampled, kvl_d + adv, gen_d + adv
        return out

    def _commit_q8_and_attend(self, sh, i, q, k, v, blk, slot, bt, seg,
                              rel):
        """Layer i of the int8-page step on shard ``sh``: quantize this
        launch's K/V into its pages at commit time, then attend over the
        int8 pages.

        The JAX q8 step's order, term for term (its step 1, zeroing the
        fresh pages' scale rows, ran once for all layers before the layer
        loop): read the touched pages' scales; grow them by scatter-max
        with each token's per-head amax/127 (scales only grow while a page
        is live, so committed int8 never overflows); re-encode the touched
        pages' int8 content from a gathered copy at the ratio old/new;
        then quantize the new tokens at the settled scale and scatter them
        into their slots.  Duplicate pages across tokens are safe: every
        duplicate sees the same settled scale and re-encodes identical
        bytes.  Pad tokens land on the null page's slot 0 and grow its
        scale, harmlessly, as in JAX."""
        kcl, vcl, ksl, vsl = sh.kc[i], sh.vc[i], sh.ks[i], sh.vs[i]
        for cache, scales, t in ((kcl, ksl, k), (vcl, vsl, v)):
            tf = t.float()                                    # [Tq, kvh, d]
            old = scales[blk]                                 # [Tq, kvh]
            # the compiled JAX step multiplies by the f32 reciprocal of
            # 127 (XLA's rewrite of a division by a constant)
            scales.index_reduce_(0, blk, tf.abs().amax(-1) * _INV127,
                                 "amax", include_self=True)
            new = scales[blk]
            safe = new.clamp_min(1e-30)
            ratio = torch.where(new > 0.0, old / safe, 0.0)
            page = torch.round(cache[blk].float() * ratio[:, :, None, None])
            cache[blk] = page.clamp(-127, 127).to(torch.int8)
            tq = torch.round(tf / safe[:, :, None])
            cache[blk, :, slot, :] = tq.clamp(-127, 127).to(torch.int8)
        return _pa.ragged_paged_attention_quant_segrel_packed(
            q, kcl, vcl, ksl, vsl, bt, seg, rel)

    def _consume_fresh(self) -> np.ndarray:
        """Pages BlockManager handed out since the last launch (sorted
        int32): the launch zeroes their scale rows.  CoW destinations are
        not among them -- their scale rows arrived with the copy."""
        return np.asarray(self.blocks.drain_fresh(), np.int32)

    def _launch_ragged(self, Tq, toks, cu, kvl, bt, lidx, samp,
                       real_tokens):
        """The one place a per-step pack launches (mixed and pure-decode
        alike), so int8 mode drains the fresh pages at every launch (the
        window drains them at its own).  Returns ``_ragged_step``'s
        (result, logits)."""
        self.pad_stats["real"] += int(real_tokens)
        self.pad_stats["padded"] += int(Tq)
        self._warm_bucket(Tq)
        fresh = self._consume_fresh() if self.kv_dtype == "int8" \
            else _NO_PAGES
        return self._ragged_step(Tq, toks, cu, kvl, bt, lidx, samp, fresh)

    def _fill_samp(self, samp, s, req, key: bool = True):
        samp["temps"][s] = req.temperature
        samp["top_k"][s] = req.top_k
        samp["top_p"][s] = req.top_p
        samp["penalty"][s] = req.repetition_penalty
        if req.seen is not None:
            np.copyto(samp["seen"][s], req.seen)
        if key and req.temperature > 0.0:
            samp["keys"][s] = self._req_key(req)

    def _run_ragged(self, chunks: list, spec: list, batch: list):
        """Pack this step's whole mix as ONE ragged launch.

        Row order: prefill chunks (scheduler order), speculative
        [last_token, drafts...] windows, plain decode tokens (slot
        order).  Every position of a spec row is a logit row; its sampler
        slots keep their defaults (acceptance runs on the host).  Returns
        (``_launch_ragged``'s (result, logits), spec row slices (first
        logit row, rows), chunk logit slots, decode logit slots)."""
        total = sum(n for _, n in chunks) \
            + sum(len(d) + 1 for _, d, _ in spec) + len(batch)
        Tq = self._ragged_bucket(total)

        # decode fast path: steady pure-decode steps reuse the
        # persistent host buffers instead of repacking from scratch
        if not chunks and not spec:
            return self._run_ragged_decode(batch, Tq)

        rows = [(req, req.tokens[req.cached:req.cached + n], "c")
                for req, n in chunks]
        rows += [(req, [req.generated[-1]] + list(d), "s")
                 for req, d, _ in spec]
        rows += [(req, [req.generated[-1]], "d") for req in batch]

        B = self.max_num_seqs
        toks = np.zeros((Tq,), np.int32)
        cu = np.zeros((B + 1,), np.int32)
        kvl = np.zeros((B,), np.int32)
        bt = np.full((B + 1, self.nblk), NULL_BLOCK, np.int32)
        lidx = np.zeros((self._Lq,), np.int32)
        samp = make_samp(self._Lq, self.config.vocab_size)
        spec_slices, chunk_slots, batch_slots = [], [], []

        tr = self.tracer
        if tr is not None:
            t = tr.now()
        off = 0      # flat-token cursor
        ls = 0       # logit-row cursor
        for i, (req, window, kind) in enumerate(rows):
            n = len(window)
            toks[off:off + n] = window
            cu[i + 1] = off + n
            kvl[i] = req.cached + n
            if kind == "s":
                lidx[ls:ls + n] = np.arange(off, off + n)
                spec_slices.append((ls, n))
                ls += n
            else:
                lidx[ls] = off + n - 1
                self._fill_samp(samp, ls, req)
                (chunk_slots if kind == "c" else batch_slots).append(ls)
                ls += 1
            off += n
        cu[len(rows) + 1:] = off
        if tr is not None:
            tr.complete("engine.pack", t, track=self._trace_track,
                        args={"rows": len(rows), "tokens": total,
                              "bucket": int(Tq)})
            t = tr.now()
        for i, (req, _w, _k) in enumerate(rows):
            bt[i] = self.blocks.padded_table(req.rid, self.nblk)
        if tr is not None:
            tr.complete("engine.block_table_stage", t,
                        track=self._trace_track, args={"rows": len(rows)})

        # padding a per-phase step would have cost: a token-bucketed chunk
        # launch, plus the full-width verify launch when anything
        # speculates (folding decode rows), else the decode bucket
        tb = self.prefill_token_bucket
        ct = sum(n for _, n in chunks)
        legacy = max(tb, -(-ct // tb) * tb) if ct else 0
        if spec:
            legacy += B * (self.max_spec_k + 1)
        elif batch:
            legacy += B
        self.pad_stats["legacy_padded"] += legacy
        # the launch packed every row's table fresh, and a post-verify
        # truncate changes tables again: full restages next time
        self._break_decode_layout()

        if tr is not None:
            t = tr.now()
        out = self._launch_ragged(Tq, toks, cu, kvl, bt, lidx, samp, total)
        if tr is not None:
            tr.complete("engine.device_launch", t, track=self._trace_track,
                        args={"bucket": int(Tq)})
        return out, spec_slices, chunk_slots, batch_slots

    def _restage(self, buf, batch, layout) -> None:
        """Full repack of one decode buffer set for a new row order."""
        n = len(batch)
        samp = buf.samp
        buf.layout = layout
        buf.bt[:] = NULL_BLOCK
        buf.kvl[:] = 0
        buf.cu[:n + 1] = np.arange(n + 1)
        buf.cu[n + 1:] = n
        samp["temps"][:] = 0.0
        samp["top_k"][:] = 0
        samp["top_p"][:] = 1.0
        samp["penalty"][:] = 1.0
        samp["seen"][:] = False
        for s, req in enumerate(batch):
            samp["temps"][s] = req.temperature
            samp["top_k"][s] = req.top_k
            samp["top_p"][s] = req.top_p
            samp["penalty"][s] = req.repetition_penalty
        buf.bt_ver.clear()               # force table repacks

    def _stage_tables(self, buf, batch) -> None:
        """Refresh the block-table rows whose table version moved (page
        growth, CoW) since this buffer set staged them."""
        for s, req in enumerate(batch):
            ver = self.blocks.table_version(req.rid)
            if buf.bt_ver.get(req.rid) != ver:
                buf.bt[s] = self.blocks.padded_table(req.rid, self.nblk)
                buf.bt_ver[req.rid] = ver

    def _run_ragged_decode(self, batch: list, Tq: int):
        """Pure-decode launch over a persistent decode buffer set.  Rows
        repack incrementally ONLY while the layout signature -- the rid
        order of the packed rows -- is unchanged since the last
        pure-decode launch through THIS set; retirement, admission,
        preemption, a mixed launch or a window in between forces a full
        repack.  Within a stable layout, block-table rows refresh whenever
        the sequence's table version bumped (page growth/CoW).  With
        overlap on, launches alternate between the two sets, and a valid
        ``_prestage`` of this set and layout leaves only the token column
        and the penalty masks to patch."""
        n = len(batch)
        bi = (1 - self._d_cur) if self.overlap else 0
        buf = self._dbufs[bi]
        samp = buf.samp
        layout = tuple(r.rid for r in batch)
        pre = self._prestaged == (bi, layout)
        self._prestaged = None                # single use
        if layout != buf.layout:
            pre = False
            self._restage(buf, batch, layout)
        tr = self.tracer
        if tr is not None:
            t = tr.now()
        for s, req in enumerate(batch):
            buf.toks[s] = req.generated[-1]
            if req.seen is not None:
                np.copyto(samp["seen"][s], req.seen)
            if not pre:
                buf.kvl[s] = req.cached + 1
                if req.temperature > 0.0:
                    samp["keys"][s] = self._req_key(req)
        if tr is not None:
            tr.complete("engine.pack", t, track=self._trace_track,
                        args={"rows": n, "tokens": n, "bucket": int(Tq),
                              "fast_path": True, "prestaged": pre})
            t = tr.now()
        self._stage_tables(buf, batch)
        if tr is not None:
            tr.complete("engine.block_table_stage", t,
                        track=self._trace_track, args={"rows": n})
        self.pad_stats["legacy_padded"] += self.max_num_seqs
        if tr is not None:
            t = tr.now()
        out = self._launch_ragged(Tq, buf.toks, buf.cu, buf.kvl, buf.bt,
                                  self._d_lidx, samp, n)
        if tr is not None:
            tr.complete("engine.device_launch", t, track=self._trace_track,
                        args={"bucket": int(Tq)})
        self._d_cur = bi
        return out, [], [], list(range(n))

    def _inject_nan(self, ok, live_slots: list):
        """FaultPlan NaN seam: clear one live logit row's finiteness flag,
        as if the card had produced a non-finite row there.  Flipping the
        host-side flag (rather than the logits) keeps the injection exact
        and free when no plan is set; ``_quarantine`` downstream is the
        same either way."""
        plan = self.fault_plan
        if plan is None or not live_slots:
            return ok
        j = plan.take_nan_row(len(live_slots))
        if j is None:
            return ok
        ok = ok.copy()
        ok[live_slots[j]] = False
        self.stats.record_fault("nan")
        return ok

    def _req_key(self, req, ahead: int = 0):
        # the key for token i of request r depends only on (seed, i):
        # sampling is reproducible across scheduling orders and
        # preemptions, and equals the JAX engine's fold_in(PRNGKey(seed),
        # i).  ahead=1 makes the NEXT position's key (the prestage:
        # len(generated) will have grown by one at dispatch)
        return prng.request_key(req.seed, len(req.generated) + ahead)
