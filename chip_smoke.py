"""Drive the PyTorch port's serving and training paths on one NVIDIA GPU.

Run from the repository root, with one CUDA card visible:

    python3 chip_smoke.py

It builds the port's CUDA kernels from the sources in the checkout, holds
each kernel against its plain PyTorch version at the shapes its main path
gives it (phases ``kernel``, ``kernel_q8``, ``qmm`` at the LLaMA-7B
serving path's, also at speculative verify launches;
``flash`` at the trainer's attention and LLaMA-7B's, with
controls that must fail), serves requests through ``LLMEngine`` at
LLaMA-7B width (random weights from a seed): ``engine_f32`` (2 layers in
float32, tokens checked against the dense ``generate()`` forward),
``engine_bf16`` (32 layers in bfloat16), ``engine_w8kv8`` (8 layers, int8
weight pools and int8 KV pages) and ``engine_w4`` (8 layers, int4 weight
pools, bfloat16 pages), all with the engine's default async step pipeline;
``engine_window_bf16`` (8 layers: overlap off, on, and the K=4 decode
window, greedy tokens identical, a gate run holding every attention launch
of the window to its plain version, the profile rows at K 4 and with
overlap off) and ``engine_window_w8kv8`` (the int8 window against K 1),
``engine_spec_f32`` (2 layers in float32: greedy tokens identical with
speculation off, the n-gram drafter, a self-draft model and the dense
``generate()``; a quantized n-gram run and its gate run, holding every
int8-page attention and dequant matmul launch to its plain version;
``speculative_generate``) and
``engine_spec_bf16`` (8 layers, the n-gram drafter at spec_k 4 and 8: a
gate run holding every attention launch that carries verify rows to its
plain version, controls, no dispatch synchronizing, a profile),
``engine_tiers_f32`` (2 layers in float32: the host KV spill tier on and
off over float and int8 pages, restored pages equal to the bytes the tier
held, the tracer's Chrome JSON, an in-flight crash recovered under
``EngineRunner`` with no leaked pools, two sampled replicas equal to one
engine, no dispatch synchronizing), ``frontend_bf16`` (8 layers in
bfloat16 served over HTTP by ``serve_background`` with two replicas, the
tracer, the flight recorder and host tiers: 16 requests, SSE and unary,
greedy and sampled, a gate holding every attention launch to its plain
version, TTFT/ITL and the idle share as readings) and ``frontend_cli``
(``python -m paddle_tpu_torch.inference.frontend --model llama-sm`` as a
subprocess: one streamed request, then SIGINT drains it to exit 0),
``sim_fit_bf16`` (32 layers in bfloat16 serving ``serve_bench``'s mixed
workload, 32 requests with the n-gram drafter, traced; the trace fitted
by ``tools/perf/step_timeline.py --fit`` and the fleet simulator's
``validate_record`` run on the fit, the record and the workload dump) and
``hf_bridge_bf16`` (8 layers in bfloat16: a Hugging Face layout state
dict through ``from_hf``, parameters bit-equal, the same tokens, a gate
run and controls), ``engine_tp2_f32`` (2 layers in float32 at tp=2, both
shards on the one card: greedy tokens equal tp=1's, every attention launch
of both shards held to its plain version, controls, per-shard bytes half
the totals, and an int8-weight int8-page run with a copy-on-write and a
spill and restore whose pages equal tp=1's bytes under one forced plan),
``engine_tp2_bf16`` (32 layers in bfloat16 at tp=2: a gate run, the main
path's walk launches at 16 heads a shard, dispatch_ms and ITL; an int4
run at 2 layers for the sliced int4 scales) and ``tune_sweep_bf16``
(``tune.run_sweep`` with child processes over one LLaMA-7B shape for each
of the five tuned kernels into a temporary cache, then engine_bf16's
requests through an int8-weight engine that reads it: a hit for every
kernel, every launch held), and trains through ``build_train_step`` at the
350M GQA LLaMA bench configuration: ``train_f32`` (2 layers in float32,
three steps on the kernels against three on the plain versions),
``train_bf16`` (24 layers in bfloat16: a gate run holding every kernel
launch to its plain version, then 20 timed steps on the kernels alone and
2 with remat) and ``train_hybrid_bf16`` (the hybrid trainer's per-rank
step at world 1, every mesh axis an NCCL group of size 1: 8 layers, two
microbatches against the single-card step, with a gate run; the 1F1B
driver against the GPipe driver that a pipeline of one stage takes; remat
"attn" against "full" with the flash forward's launches; MoE
with 8 local experts at 8 layers; MoE in float32 at 2 layers against the
same step on the CPU) and ``launch_train_bf16`` (the hybrid trainer's rank
started by ``python -m paddle_tpu_torch.distributed.launch``: NCCL from
``init_parallel_env``, every eager collective at world 1, a 25 MB
all_reduce's host time through ``collective.all_reduce`` and the raw
call, ``build_mesh`` from the launcher's environment, 3 steps at
LLaMA-7B's widths and 8 layers with every flash launch held to its plain
version, their losses and parameters bit-equal to the in-process world-1
mesh step's; a worker that exits 1 fails the launch).  ``decode`` and ``varlen`` hold the paged decode kernel and
the three varlen flash attention kernels against their plain versions at
LLaMA-7B's attention width (with controls that must fail, and
``flash_attn_unpadded``'s autograd through the varlen kernels), and
``blha_f32`` (2 layers) and ``blha_bf16`` (32 layers: a gate run, then
the kernels alone) serve a prefill, a mixed and 16 or 32 decode steps
through ``block_multihead_attention``.  ``paged_repair`` holds the three
paged entries at the head dims and query groups their specialised
kernels do not serve (D 256 and 384, G 16 and 32; decode also D 512 and
1024), ``norms`` the fused RMSNorm / LayerNorm kernel over rows, widths
and dtypes (controls, repeats bit for bit), and ``fused_decoder_f32`` (2
layers, against the dense forward) and ``fused_decoder_bf16`` (32 layers:
a gate run, then the kernels alone) serve a fused LLaMA-7B decoder built
from ``incubate.nn.functional`` ops over ``block_multihead_attention``.
``eager_capture_bf16`` trains through the eager surface (``import
paddle_tpu_torch as paddle``: ``Tensor``, ``nn.Layer``, AdamW, AMP): the
f32 MLP of the capture tests captured against eager, then a 2-layer
decoder at LLaMA-7B's widths built from ``nn`` layers, ``fused_rms_norm``
and causal SDPA on ``Tensor``, bf16 under ``amp.decorate`` O2 with AdamW
and the global-norm clip: one eager step with every flash and norm launch
held to its plain version, then eager steps and ``jit.capture_step``'s
CUDA graph replays from the same state, compared, timed and profiled;
its part (a) also calls one captured step with a second batch shape, a
broadcastable ``[1, L]`` batch after ``[B, L]``, another dtype and a
changed Python loss weight, each held to eager bit for bit, and counts
one capture a signature.  ``ops_sweep`` runs every op of the port's
registry on the card against the same call on the CPU, both through the
port (``tests/_torch_sweep_cases.py``: forward and gradient with the
parity tests' tolerances, every output on the card; the ops that draw by
their properties), and fails the run if any op fails.
Each 32- and 24-layer phase shows through the kernels' launch counters
that a run on the kernels alone went through them.  Each
phase prints one JSON line, and a ``run`` line the whole run's seconds
beside the card; the line before the last two is the kernel record, then
the card's name and power limit as nvidia-smi gives them, then ``{"ok":
true, ...}``.

It exits non-zero, and prints no result, when no CUDA device is present,
when the port cannot be imported (the script alone, outside the
repository), or when any phase fails.  It imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
import traceback

SEED = 0
DEV = "cuda"
H, D, BS = 32, 128, 16                   # LLaMA-7B attention, engine pages
MAX_MODEL_LEN = 2048
NBLK = MAX_MODEL_LEN // BS
# kernel against plain version, three measures of out - ref: the largest
# absolute error; the largest over tokens of max|out_t - ref_t| over
# max|ref_t| (a long decode row's outputs are ~0.04, so an absolute bound
# alone would be loose there); and ||out - ref|| / ||ref||.  bf16: both
# sides round the output to bf16 (one ulp is 2^-7 of the binade), and the
# kernel also rounds q * scale and p to bf16, so single elements may differ
# by an ulp or two; the norm ratio averages that out (<= 4e-3 measured,
# kernel phase and engine launches) and catches a fault that shifts every
# output by 1% (1.05e-2).
TOLERANCE = {"float32": {"abs": 1e-4, "token_rel": 1e-4, "l2_rel": 1e-5},
             "bfloat16": {"abs": 2e-2, "token_rel": 2e-2, "l2_rel": 6e-3}}
# dequant matmul against its plain version: both compute in f32 from
# exactly upcast operands and differ only in summation order, so
# ||out - ref|| / ||ref|| <= 1e-5 and max|out - ref| / max|ref| <= 1e-4
QMM_TOLERANCE = {"l2_rel": 1e-5, "max_rel": 1e-4}
# H100 SXM data-sheet peaks (dense): HBM bytes/s; f32 off the tensor cores
# and bf16 on them, flop/s
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> list:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return [ln.strip() for ln in r.stdout.splitlines() if ln.strip()]


def errors(out, ref) -> dict:
    """The three measures of TOLERANCE for one [Tq, H, D] output."""
    d = (out.float() - ref.float()).flatten(1)
    r = ref.float().flatten(1)
    tok = d.abs().amax(1) / r.abs().amax(1).clamp_min(1e-12)
    return {"abs": float(d.abs().max()), "token_rel": float(tok.max()),
            "l2_rel": float(d.norm() / r.norm().clamp_min(1e-12))}


def within(errs: dict, dtype_name: str, keys=None) -> bool:
    tol = TOLERANCE[dtype_name]
    return all(errs[k] <= tol[k] for k in keys or tol)


# cycles of the spin kernel queued ahead of each timed call (about 2.5 ms
# on an H100): the host enqueues the call while the card spins, so the
# events bracket the call's device time, not the host's enqueue time
SPIN_CYCLES = 5_000_000


def time_ms(fn, reps=30, warm=3) -> float:
    """Median CUDA-event time of one call on the card, after warm-up.
    The card is kept busy with a spin kernel while the host enqueues the
    start event, the call and the end event, so a call whose host side
    (argument checks, ctypes, allocation) outlasts its kernels is timed
    by its kernels."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# kernel phase: ragged paged attention against its plain version
# ---------------------------------------------------------------------------

def decode_lens(rng):
    return [100, 2000] + [int(x) for x in rng.integers(100, 2001, 6)]


# speculative verify launches: (bucket Tq, drafts k of each of the 8 rows),
# a row being [last token, d1..dk] (k + 1 query tokens).  Tq 40 is the
# speculation tier at max_spec_k 4 (k from {1, 4}); 128 the prefill bucket
# a launch at the default max_spec_k 8 takes (k from {1, 4, 8}): runs of
# 2, 5 and 9 tokens, which the walk serves with CUDA-core tiles and, for
# bf16, 9 live rows of a 64-row wgmma tile
VERIFY_KS = {"verify_tq40": (40, (4, 1, 4, 4, 1, 4, 1, 4)),
             "verify_tq128": (128, (8, 1, 4, 8, 8, 1, 4, 8))}


def attention_case(kind, Hkv, dtype, rng, gen, Hq=H, Dh=D):
    """An engine-shaped launch on the card: 8 rows, a [9, NBLK] table whose
    last row is the null row.  ``decode``: one token per row at kv lengths
    100..2000.  ``mixed``: a 512-token prefill chunk resuming at position
    188 (kv length 700) plus 7 decode rows, padded to the 576-token bucket
    the engine would launch.  ``verify_tq40`` / ``verify_tq128``: each row
    a verify run of k + 1 tokens (``VERIFY_KS``) ending at the decode kv
    lengths, padded to the bucket.  Hq query heads of Dh (LLaMA-7B's by
    default)."""
    import numpy as np
    import torch
    from paddle_tpu_torch.ops import paged_attention as pa
    lens = decode_lens(rng)
    if kind == "decode":
        rows = [(1, kv) for kv in lens]
        Tq = 8
    elif kind in VERIFY_KS:
        Tq, ks = VERIFY_KS[kind]
        rows = [(k + 1, kv) for k, kv in zip(ks, lens)]
    else:
        rows = [(512, 700)] + [(1, kv) for kv in lens[1:]]
        Tq = 576
    B = len(rows)
    num_blocks = 1 + B * NBLK
    cu = np.zeros(B + 1, np.int32)
    cu[1:] = np.cumsum([q for q, _ in rows])
    kvl = np.asarray([kv for _, kv in rows], np.int32)
    bt = np.zeros((B + 1, NBLK), np.int32)
    pages = rng.permutation(np.arange(1, num_blocks))
    used = 0
    for r, (_, kv) in enumerate(rows):
        n = -(-kv // BS)
        bt[r, :n] = pages[used:used + n]
        used += n
    dev = torch.device(DEV)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    q = randn(Tq, Hq, Dh)
    kc = randn(num_blocks, Hkv, BS, Dh)
    vc = randn(num_blocks, Hkv, BS, Dh)
    bt_d = torch.from_numpy(bt).to(dev)
    seg, rel = pa.ragged_segments(torch.from_numpy(cu).to(dev),
                                  torch.from_numpy(kvl).to(dev), Tq)
    return dict(q=q, kc=kc, vc=vc, bt=bt_d, seg=seg, rel=rel, kvl=kvl,
                rows=rows, Tq=Tq)


def plain(c, chunk=64):
    """The plain version, a few tokens at a time (each token's row of the
    output depends on its own (seg, rel) only; one dense gather of a whole
    576-token launch would not fit the card)."""
    import torch
    from paddle_tpu_torch.ops import paged_attention as pa
    return torch.cat([pa.ragged_paged_reference_segrel(
        c["q"][i:i + chunk], c["kc"], c["vc"], c["bt"],
        c["seg"][i:i + chunk], c["rel"][i:i + chunk])
        for i in range(0, c["Tq"], chunk)])


def kernel(c):
    from paddle_tpu_torch.ops import paged_attention as pa
    return pa._launch_kernel(c["q"], c["kc"], c["vc"], c["bt"], c["seg"],
                             c["rel"])


def bound(c, dtype_name):
    """Least time for this launch: the bytes it must move (each row's live
    keys' K and V once, q, out, the table entries of the live pages,
    seg/rel) over HBM bandwidth, and its flops (QK and PV over each
    token's keys) over the dtype's peak."""
    import numpy as np
    isz = c["q"].element_size()
    _, Hq, Dh = c["q"].shape
    Hkv = c["kc"].shape[1]
    live_keys = int(sum(kv for _, kv in c["rows"]))
    pages = int(sum(-(-kv // BS) for _, kv in c["rows"]))
    nbytes = (2 * live_keys * Hkv * Dh * isz + 2 * c["q"].numel() * isz
              + pages * 4 + 8 * c["Tq"])
    keys_per_token = c["rel"].cpu().numpy().astype(np.int64) + 1
    flops = 4 * int(keys_per_token.sum()) * Hq * Dh
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nbytes, flops, live_keys)


def library(c):
    """Yardstick only (the port never calls it): PyTorch's
    scaled_dot_product_attention on the decode launch, K/V already gathered
    dense per row with a length mask."""
    import torch
    import torch.nn.functional as F
    B = len(c["rows"])
    Smax = NBLK * BS
    Dh = c["q"].shape[-1]
    pages = c["bt"][:B].long()
    k = c["kc"][pages].permute(0, 2, 1, 3, 4).reshape(B, -1, Smax, Dh)
    v = c["vc"][pages].permute(0, 2, 1, 3, 4).reshape(B, -1, Smax, Dh)
    kvl = torch.as_tensor(c["kvl"], device=k.device)
    mask = (torch.arange(Smax, device=k.device)[None, :]
            < kvl[:, None])[:, None, None, :]
    q = c["q"][:B, :, None, :]
    fn = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q, k, v, attn_mask=mask, enable_gqa=k.shape[1] != q.shape[1])
    return fn, fn()[:, :, 0, :]


def library_mixed(c):
    """Yardstick of a ``mixed`` launch, two PyTorch calls (the port never
    makes them): scaled_dot_product_attention of the chunk's row (queries
    at positions 188..699 over keys 0..699, keypos <= rel) over its pages
    gathered dense, plus ``library``'s decode yardstick on the 7 decode
    rows.  Returns the function making both calls and its outputs for the
    live tokens, in token order."""
    import torch
    import torch.nn.functional as F
    n_chunk, kv = c["rows"][0]
    B = len(c["rows"])
    Dh = c["q"].shape[-1]
    Hkv = c["kc"].shape[1]
    pages = c["bt"][0, :-(-kv // BS)].long()
    k0 = c["kc"][pages].permute(1, 0, 2, 3).reshape(1, Hkv, -1, Dh)[:, :, :kv]
    v0 = c["vc"][pages].permute(1, 0, 2, 3).reshape(1, Hkv, -1, Dh)[:, :, :kv]
    q0 = c["q"][:n_chunk].permute(1, 0, 2)[None]
    rel0 = c["rel"][:n_chunk].long()
    mask0 = (torch.arange(kv, device=k0.device)[None, :]
             <= rel0[:, None])[None, None]
    dec = dict(c, q=c["q"][n_chunk:n_chunk + B - 1],
               bt=c["bt"][1:].contiguous(), rows=c["rows"][1:],
               kvl=c["kvl"][1:])
    dec_fn, _ = library(dec)

    def fn():
        return F.scaled_dot_product_attention(
            q0, k0, v0, attn_mask=mask0,
            enable_gqa=Hkv != q0.shape[1]), dec_fn()
    a, b = fn()
    return fn, torch.cat([a[0].permute(1, 0, 2), b[:, :, 0, :]])


# the bf16 (unless named) times of the one-block-a-token kernels the walk
# replaced, at the same cases (PERF.md section 6, "was"; NVIDIA H100 80GB
# HBM3, 700.00 W): the kernel, kernel_q8 and decode phases' records carry
# them beside this run's (the kernels line holds only this run's numbers)
PAGED_WAS_MS = {"kernel_decode": 0.2516, "kernel_q8_decode": 0.3166,
                "decode_mha": 0.2517, "decode_gqa": 0.4036,
                "decode_gqa_float32": 0.4958}
# the paged attention kernels in a trace
PAGED_KERNEL_NAMES = ("paged_walk_kernel", "paged_attention_any_kernel")


def library_verify(c):
    """Yardstick of a verify launch, one PyTorch call (the port never makes
    it): scaled_dot_product_attention of every row's k + 1 queries, padded
    to the longest row, over the row's pages gathered dense beforehand,
    each query masked to the keys at positions <= its own.  Returns the
    function and its outputs for the live tokens, in token order."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    B = len(c["rows"])
    Smax = NBLK * BS
    Dh = c["q"].shape[-1]
    Hkv = c["kc"].shape[1]
    n = [q for q, _ in c["rows"]]
    first = np.concatenate([[0], np.cumsum(n)[:-1]])
    lmax = max(n)
    # each row's query slots; pad slots repeat the row's last token
    idx = torch.as_tensor(first[:, None] + np.minimum(
        np.arange(lmax)[None, :], np.asarray(n)[:, None] - 1),
        device=c["q"].device)
    live = torch.as_tensor(np.arange(lmax)[None, :] < np.asarray(n)[:, None],
                           device=c["q"].device)
    pages = c["bt"][:B].long()
    k = c["kc"][pages].permute(0, 2, 1, 3, 4).reshape(B, Hkv, Smax, Dh)
    v = c["vc"][pages].permute(0, 2, 1, 3, 4).reshape(B, Hkv, Smax, Dh)
    q = c["q"][idx].permute(0, 2, 1, 3)                  # [B, Hq, lmax, Dh]
    mask = (torch.arange(Smax, device=k.device)[None, None, :]
            <= c["rel"][idx].long()[:, :, None])[:, None]
    fn = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q, k, v, attn_mask=mask, enable_gqa=Hkv != q.shape[1])
    return fn, fn().permute(0, 2, 1, 3)[live]


def verify_timing(c, run, run_plain, lib, b, ref):
    """Times of a verify launch: kernel, plain version, the library call
    (``library_verify``) and the bound ``b``; the library's error on the
    live tokens against ``ref``."""
    lib_fn, lib_out = lib
    live = sum(n for n, _ in c["rows"])
    return {"Tq": c["Tq"], "live_tokens": live,
            "run_lengths": [n for n, _ in c["rows"]],
            "ms": time_ms(run), "plain_ms": time_ms(run_plain, reps=5,
                                                    warm=1),
            "library_ms": time_ms(lib_fn),
            "library": "one scaled_dot_product_attention call over the "
                       "rows' queries padded to the longest run, K/V "
                       "gathered dense, keypos <= rel",
            "library_max_abs_err": float(
                (lib_out.float() - ref[:live].float()).abs().max()),
            "bound_ms": b[0], "bound_by": b[1], "bytes": b[2],
            "flops": b[3]}


def mixed_timing(c, run, run_plain, lib, b, ref):
    """Times of a ``mixed`` launch: kernel, plain version, the two library
    calls, and the bound ``b`` (``bound``'s or ``bound_q8``'s tuple); the
    library's error on the live tokens against ``ref``."""
    lib_fn, lib_out = lib
    live = sum(n for n, _ in c["rows"])
    return {"ms": time_ms(run), "plain_ms": time_ms(run_plain, reps=5,
                                                    warm=1),
            "library_ms": time_ms(lib_fn),
            "library": "two calls: scaled_dot_product_attention of the "
                       "chunk's row over its gathered pages (keypos <= rel), "
                       "plus the decode yardstick on the 7 decode rows",
            "library_max_abs_err": float(
                (lib_out.float() - ref[:live].float()).abs().max()),
            "bound_ms": b[0], "bound_by": b[1], "bytes": b[2],
            "flops": b[3]}


def phase_kernel(state):
    import numpy as np
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    errs, timing, mixed, verify, controls, ok = {}, {}, {}, {}, {}, True
    for kind, Hkv in (("decode", H), ("mixed", H), ("mixed_gqa", H // 4),
                      ("verify_tq40", H), ("verify_tq128", H)):
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            c = attention_case("mixed" if kind == "mixed_gqa" else kind,
                               Hkv, dtype, np.random.default_rng(SEED), gen)
            out = kernel(c)
            ref = plain(c)
            err = errors(out, ref)
            finite = bool(torch.isfinite(out).all())
            errs[f"{kind}_{name}"] = err
            ok &= finite and within(err, name)
            if kind in VERIFY_KS:
                args = (c["q"], c["kc"], c["vc"], c["bt"], c["seg"],
                        c["rel"])
                for cname, control in CONTROLS.items():
                    c_err = errors(control(*args), ref)
                    fails = not within(c_err, name)
                    controls[f"{cname}_{kind}_{name}"] = dict(c_err,
                                                              fails=fails)
                    ok &= fails
                verify[f"{kind}_{name}"] = verify_timing(
                    c, lambda: kernel(c), lambda: plain(c),
                    library_verify(c), bound(c, name), ref)
            elif kind == "decode":
                lib_fn, lib_out = library(c)
                b_ms, b_by, nbytes, flops, keys = bound(c, name)
                timing[name] = {
                    "ms": time_ms(lambda: kernel(c)),
                    "plain_ms": time_ms(lambda: plain(c), reps=20),
                    "library_ms": time_ms(lib_fn),
                    "library_max_abs_err": float(
                        (lib_out.float() - ref.float()).abs().max()),
                    "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
                    "flops": flops, "live_keys": keys}
                if name == "bfloat16":
                    timing[name]["was_ms"] = PAGED_WAS_MS["kernel_decode"]
            else:
                mixed[f"{kind}_{name}"] = mixed_timing(
                    c, lambda: kernel(c), lambda: plain(c),
                    library_mixed(c), bound(c, name), ref)
            del c, out, ref
            torch.cuda.empty_cache()
    state["kernel"] = {"errors": errs, "timing": timing, "mixed": mixed,
                       "verify": verify}
    emit({"phase": "kernel", "ok": ok, "tolerance": TOLERANCE,
          "shapes": {"H": H, "D": D, "bs": BS, "nblk": NBLK,
                     "decode": "Tq=8, kv lens 100..2000",
                     "mixed": "Tq=576: 512-token chunk at kv 700 + 7 "
                              "decode rows + 57 pad tokens",
                     "mixed_gqa": "mixed with H_kv=8",
                     "verify": {k: {"Tq": tq, "drafts": list(ks)}
                                for k, (tq, ks) in VERIFY_KS.items()}},
          "errors": errs, "controls": controls, "decode_timing": timing,
          "mixed_timing": mixed, "verify_timing": verify,
          "bound_peaks": {"bytes_per_s": PEAK_BYTES,
                          "flops_per_s": PEAK_FLOPS}})
    return ok


# ---------------------------------------------------------------------------
# kernel_q8 phase: int8-page ragged attention against its plain version
# ---------------------------------------------------------------------------

def quantize_pages(pages):
    """Float pages [NB, H_kv, bs, D] -> int8 pages and f32 scales
    [NB, H_kv], per page and head, as the engine commits them (scale =
    amax / 127, codes rounded half to even and clipped to +-127)."""
    import torch
    s = pages.float().abs().amax((2, 3)) / 127.0
    q8 = torch.round(pages.float() / s.clamp_min(1e-30)[:, :, None, None])
    return q8.clamp(-127, 127).to(torch.int8), s


def q8_case(kind, Hkv, dtype, rng, gen, Hq=H, Dh=D):
    """``attention_case``'s pack with its N(0, 1) pages quantized and q in
    ``dtype``."""
    import torch
    c = attention_case(kind, Hkv, torch.float32, rng, gen, Hq, Dh)
    (kq, ks), (vq, vs) = quantize_pages(c["kc"]), quantize_pages(c["vc"])
    c.update(q=c["q"].to(dtype), kc=kq, vc=vq, ks=ks, vs=vs)
    return c


def plain_q8(c, chunk=64):
    """The int8-page plain version in f32 (q upcast, pages dequantized
    densely), a few tokens at a time as ``plain`` does."""
    import torch
    from paddle_tpu_torch.ops import paged_attention as pa
    return torch.cat([pa.ragged_paged_reference_quant_segrel(
        c["q"][i:i + chunk].float(), c["kc"], c["vc"], c["ks"], c["vs"],
        c["bt"], c["seg"][i:i + chunk], c["rel"][i:i + chunk])
        for i in range(0, c["Tq"], chunk)])


def kernel_q8(c):
    from paddle_tpu_torch.ops import paged_attention as pa
    return pa._launch_quant_kernel(c["q"], c["kc"], c["vc"], c["ks"],
                                   c["vs"], c["bt"], c["seg"], c["rel"])


def bound_q8(c):
    """Least time for an int8-page launch: each row's live keys' int8 K
    and V and their pages' scales, q, out, the table entries and seg/rel
    once over HBM bandwidth, and the QK and PV flops at the rate of the
    units the kernel runs them on.  f32 q: every product on the CUDA cores
    in f32.  bf16 q: the tiles of more than 8 (token, head) rows (a
    prefill chunk's) on the tensor cores at the bf16 rate, each product
    taken twice (q * scale and p * vscale as two bf16 terms), the others
    (decode tokens) on the CUDA cores in f32; the two times add."""
    import numpy as np
    import torch
    isz = c["q"].element_size()
    _, Hq, Dh = c["q"].shape
    Hkv = c["kc"].shape[1]
    live_keys = int(sum(kv for _, kv in c["rows"]))
    pages = int(sum(-(-kv // BS) for _, kv in c["rows"]))
    nbytes = (2 * live_keys * Hkv * Dh + 2 * pages * Hkv * 4
              + 2 * c["q"].numel() * isz + pages * 4 + 8 * c["Tq"])
    keys = c["rel"].cpu().numpy().astype(np.int64) + 1
    flops = 4 * int(keys.sum()) * Hq * Dh
    t_ops = flops / PEAK_FLOPS["float32"] * 1e3
    if c["q"].dtype != torch.float32:
        seg = c["seg"].cpu().numpy()
        n_tok = np.bincount(seg, minlength=seg.max() + 1)[seg]
        tc = n_tok * (Hq // Hkv) > 8               # tokens on the tensor cores
        f_tc = 4 * int(keys[tc].sum()) * Hq * Dh
        t_ops = (2 * f_tc / PEAK_FLOPS["bfloat16"]
                 + (flops - f_tc) / PEAK_FLOPS["float32"]) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nbytes, flops)



def dequantized(c, dtype):
    """``c`` with its int8 pages dequantized to float pages in ``dtype``
    (the library yardstick's operands)."""
    kd = c["kc"].float() * c["ks"][:, :, None, None]
    vd = c["vc"].float() * c["vs"][:, :, None, None]
    return dict(c, kc=kd.to(dtype), vc=vd.to(dtype))


def scaled_scales(c):
    """A subtle control: every scale 1% too large."""
    return kernel_q8(dict(c, ks=c["ks"] * 1.01, vs=c["vs"] * 1.01))


def wrong_page_scales(c):
    """A gross control: each page read with its neighbour's scales."""
    return kernel_q8(dict(c, ks=c["ks"].roll(1, 0).contiguous(),
                          vs=c["vs"].roll(1, 0).contiguous()))


CONTROLS_Q8 = {"scales_1pct": scaled_scales,
               "wrong_page_scale": wrong_page_scales}


def phase_kernel_q8(state):
    import numpy as np
    import torch
    gen = torch.Generator(device=DEV).manual_seed(SEED + 4)
    errs, timing, mixed, verify, controls, ok = {}, {}, {}, {}, {}, True
    for kind, Hkv in (("decode", H), ("mixed", H), ("mixed_gqa", H // 4),
                      ("verify_tq40", H), ("verify_tq128", H)):
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            c = q8_case("mixed" if kind == "mixed_gqa" else kind, Hkv,
                        dtype, np.random.default_rng(SEED), gen)
            out = kernel_q8(c)
            ref = plain_q8(c)                   # f32, whatever q's type
            err = errors(out, ref)
            errs[f"{kind}_{name}"] = err
            ok &= bool(torch.isfinite(out).all()) and within(err, name)
            for cname, control in CONTROLS_Q8.items():
                c_err = errors(control(c), ref)
                fails = not within(c_err, name)
                controls[f"{cname}_{kind}_{name}"] = dict(c_err,
                                                          fails=fails)
                ok &= fails
            if kind == "decode":
                lib_fn, lib_out = library(dequantized(c, dtype))
                b_ms, b_by, nbytes, flops = bound_q8(c)
                timing[name] = {
                    "ms": time_ms(lambda: kernel_q8(c)),
                    "plain_ms": time_ms(lambda: plain_q8(c), reps=20),
                    "library_ms": time_ms(lib_fn),
                    "library_max_abs_err": float(
                        (lib_out.float() - ref).abs().max()),
                    "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
                    "flops": flops}
                if name == "bfloat16":
                    timing[name]["was_ms"] = PAGED_WAS_MS["kernel_q8_decode"]
                del lib_fn, lib_out
            elif kind in VERIFY_KS:
                verify[f"{kind}_{name}"] = verify_timing(
                    c, lambda: kernel_q8(c), lambda: plain_q8(c),
                    library_verify(dequantized(c, dtype)), bound_q8(c), ref)
            else:
                mixed[f"{kind}_{name}"] = mixed_timing(
                    c, lambda: kernel_q8(c), lambda: plain_q8(c),
                    library_mixed(dequantized(c, dtype)), bound_q8(c), ref)
            del c, out, ref
            torch.cuda.empty_cache()
    state["kernel_q8"] = {"errors": errs, "timing": timing, "mixed": mixed,
                          "verify": verify}
    emit({"phase": "kernel_q8", "ok": ok, "tolerance": TOLERANCE,
          "reference": "plain version in f32 (q upcast), pages int8 with "
                       "per-page-per-head scales amax/127 from N(0, 1)",
          "errors": errs, "controls": controls, "decode_timing": timing,
          "mixed_timing": mixed, "verify_timing": verify,
          "bound_peaks": {"bytes_per_s": PEAK_BYTES,
                          "flops_per_s": PEAK_FLOPS["float32"]}})
    return ok


# ---------------------------------------------------------------------------
# qmm phase: the dequant matmul against its plain version
# ---------------------------------------------------------------------------

# LLaMA-7B's (K, N): wq/wk/wv/wo, gate/up, down, the logit head
QMM_SHAPES = {"qkvo": (4096, 4096), "gate_up": (4096, 11008),
              "down": (11008, 4096), "head": (4096, 32000)}


def qmm_errors(out, ref) -> dict:
    """QMM_TOLERANCE's two measures, plus the largest absolute error."""
    d = (out - ref).float()
    return {"l2_rel": float(d.norm() / ref.norm().clamp_min(1e-30)),
            "max_rel": float(d.abs().max()
                             / ref.abs().max().clamp_min(1e-30)),
            "abs": float(d.abs().max())}


def qmm_within(errs: dict) -> bool:
    return all(errs[k] <= v for k, v in QMM_TOLERANCE.items())


def swap_nibbles(q):
    """A control: every int4 byte with its two nibbles exchanged."""
    import torch
    b = q.to(torch.int32) & 0xFF
    return (((b & 0xF) << 4) | (b >> 4)).to(torch.uint8).view(torch.int8)


# the same cases' times on the CUDA-core kernel that the tensor-core one
# replaced (PERF.md section 6, "was"; NVIDIA H100 80GB HBM3, 700.00 W; bf16
# x, M 8 timed with the weights warm in L2), for the comparison the phase
# prints
QMM_WAS_MS = {
    "qkvo_int8_M8": 0.0551, "qkvo_int8_M512": 0.8815,
    "qkvo_int4_M8": 0.0517, "qkvo_int4_M512": 0.7769,
    "gate_up_int8_M8": 0.1514, "gate_up_int8_M512": 2.1969,
    "gate_up_int4_M8": 0.1208, "gate_up_int4_M512": 2.0106,
    "down_int8_M8": 0.1504, "down_int8_M512": 2.3822,
    "down_int4_M8": 0.1248, "down_int4_M512": 2.1468,
    "head_int8_M8": 0.344, "head_int8_M512": 5.918,
    "head_int4_M8": 0.311, "head_int4_M512": 5.513}
# f32 x: the logit head at the engine's decode M, and a projection at a
# prefill's (the f32 engine, engine_quant_f32)
QMM_F32_CASES = (("head", 8), ("qkvo", 512))
# M of a verify launch with 8 slots, by x type: the speculation tier's Tq
# and Lq 40 at max_spec_k 4, Lq 72 at the default 8 (the logit head), and
# the bf16 buckets 64 and 128 (the projections).  40 and 72 end on a
# partial row tile (f32 x: BM 64; bf16 x: the 64-token wgmma tile), where
# each case's control, the kernel on x with its last row zeroed, must fail
QMM_VERIFY_M = {"float32": (40, 72), "bfloat16": (40, 64, 72, 128)}
# the M 8 cases are timed with the weights cold in L2 (50 MB), as the
# engine, which streams 6.7 GB of weights a step, finds them: each call
# takes the next of enough copies to pass twice the L2
L2_BYTES = 50 * 2 ** 20


def rotating(make, nbytes):
    """A call that cycles over enough copies made by ``make()`` (each
    ``nbytes`` bytes) to pass twice the L2, so each call reads its
    operands from device memory."""
    copies = [make() for _ in range(max(2, -(-2 * L2_BYTES // nbytes)))]
    state = {"i": 0}

    def nxt():
        state["i"] = (state["i"] + 1) % len(copies)
        return copies[state["i"]]
    return nxt


def qmm_case(qm, x, q, s, wdt, w_lib, name):
    """One case of the qmm phase: the kernel held to its plain version,
    its time (L2-cold at M <= 16, and warm too), the plain version's, the
    library's (bf16 x @ the weight dequantized to bf16 beforehand, cold
    and warm alike) and the bound."""
    import torch
    M, K = x.shape
    N = q.shape[1]
    out = qm._launch_kernel(x, q, s, wdt)
    ref = qm.reference_matmul(x, q, s, wdt)
    err = qmm_errors(out, ref)
    ok = bool(torch.isfinite(out).all()) and qmm_within(err)
    xb = x.element_size()
    nbytes = q.numel() + s.numel() * 4 + x.numel() * xb + M * N * 4
    flops = 2 * M * K * N
    t_bytes = nbytes / PEAK_BYTES * 1e3
    # bf16 x: one bf16 tensor-core product.  f32 x: the exact product
    # on the tensor cores is three bf16 ones (x split into h + m + l,
    # 24 bits; TF32's 10 would not be exact), so 3 x the flops at the bf16
    # rate
    t_ops = (1 if x.dtype == torch.bfloat16 else 3) * flops \
        / PEAK_FLOPS["bfloat16"] * 1e3
    xl = x.to(torch.bfloat16)
    warm = time_ms(lambda: qm._launch_kernel(x, q, s, wdt))
    lib_warm = time_ms(lambda: xl @ w_lib)
    rec = dict(err, M=M, K=K, N=N, weight_dtype=wdt,
               x_dtype=str(x.dtype).replace("torch.", ""),
               plain_ms=time_ms(lambda: qm.reference_matmul(x, q, s, wdt),
                                reps=20),
               bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               bytes=nbytes, flops=flops,
               was_ms=QMM_WAS_MS.get(name) if x.dtype == torch.bfloat16
               else None)
    if M <= 16:
        wq = rotating(lambda: (q.clone(), s.clone()), q.numel())
        wl = rotating(lambda: w_lib.clone(), w_lib.numel() * 2)
        rec.update(ms=time_ms(lambda: qm._launch_kernel(x, *wq(), wdt)),
                   library_ms=time_ms(lambda: xl @ wl()), ms_l2_warm=warm,
                   library_ms_l2_warm=lib_warm, l2="cold")
        del wq, wl
    else:
        rec.update(ms=warm, library_ms=lib_warm, l2="warm")
    return ok, rec


def phase_qmm(state):
    import torch
    from paddle_tpu_torch.ops import quant_matmul as qm
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=DEV).manual_seed(SEED + 5)
    vgen = torch.Generator(device=DEV).manual_seed(SEED + 15)
    cases, ok, control = {}, True, None
    verify_controls_fail = True
    for shape, (K, N) in QMM_SHAPES.items():
        w = torch.randn((K, N), generator=gen, device=DEV) * 0.02
        for wdt in ("int8", "int4"):
            q, s = qm.quantize_weight(w, wdt)
            w_lib = qm.dequantize_weight(q, s, wdt).to(torch.bfloat16)
            for M in (8, 512):
                x = torch.randn((M, K), generator=gen,
                                device=DEV).to(torch.bfloat16)
                name = f"{shape}_{wdt}_M{M}"
                passed, cases[name] = qmm_case(qm, x, q, s, wdt, w_lib, name)
                ok &= passed
                if shape == "qkvo" and wdt == "int4" and M == 8:
                    control = qmm_errors(
                        qm._launch_kernel(x, swap_nibbles(q), s, wdt),
                        qm.reference_matmul(x, q, s, wdt))
                    control["fails"] = not qmm_within(control)
                    ok &= control["fails"]
                if (shape, M) in QMM_F32_CASES:
                    x = torch.randn((M, K), generator=gen, device=DEV)
                    name = f"{shape}_{wdt}_M{M}_xf32"
                    passed, cases[name] = qmm_case(qm, x, q, s, wdt, w_lib,
                                                   name)
                    ok &= passed
                del x
            for xname, Ms in QMM_VERIFY_M.items():
                for M in Ms:
                    x = torch.randn((M, K), generator=vgen,
                                    device=DEV).to(getattr(torch, xname))
                    name = f"{shape}_{wdt}_M{M}" + (
                        "_xf32" if xname == "float32" else "")
                    passed, cases[name] = qmm_case(qm, x, q, s, wdt, w_lib,
                                                   name)
                    ctl = qmm_errors(
                        qm._launch_kernel(last_row_zeroed(x), q, s, wdt),
                        qm.reference_matmul(x, q, s, wdt))
                    cases[name]["control_last_row_zeroed"] = dict(
                        ctl, fails=not qmm_within(ctl))
                    verify_controls_fail &= not qmm_within(ctl)
                    ok &= passed
                    del x
            del q, s, w_lib
        del w
    torch.cuda.empty_cache()
    # repeats bit for bit where K is split (qkvo at M 8: 8 splits)
    w = torch.randn((4096, 4096), generator=gen, device=DEV) * 0.02
    repeats = {}
    for wdt in ("int8", "int4"):
        q, s = qm.quantize_weight(w, wdt)
        x = torch.randn((8, 4096), generator=gen, device=DEV).bfloat16()
        first = qm._launch_kernel(x, q, s, wdt)
        repeats[wdt] = all(torch.equal(qm._launch_kernel(x, q, s, wdt),
                                       first) for _ in range(10))
    ok &= all(repeats.values()) and verify_controls_fail
    del w, q, s, x, first
    torch.cuda.empty_cache()
    state["qmm"] = cases
    emit({"phase": "qmm", "ok": ok, "tolerance": QMM_TOLERANCE,
          "control_int4_nibbles_swapped": control,
          "verify_M": QMM_VERIFY_M,
          "verify_controls_last_row_zeroed_fail": verify_controls_fail,
          "repeats_bit_for_bit_qkvo_M8": repeats,
          "was": "was_ms: the CUDA-core kernel this one replaced, bf16 x, "
                 "L2 warm (compare ms_l2_warm at M 8)",
          "cases": cases,
          "bound_peaks": {"bytes_per_s": PEAK_BYTES,
                          "flops_per_s": PEAK_FLOPS["bfloat16"],
                          "flops_peak": "bf16 dense tensor cores; f32 x "
                                        "counts 3 x the flops (three exact "
                                        "bf16 products)"}})
    print("chip_smoke: qmm ms (L2 cold at M 8; warm) | was | library:",
          file=sys.stderr)
    for name, c in cases.items():
        print(f"  {name:24s} {c['ms']:.4f} ({c.get('ms_l2_warm', c['ms']):.4f})"
              f" | {c['was_ms']} | {c['library_ms']:.4f}", file=sys.stderr)
    return ok


# ---------------------------------------------------------------------------
# engine phases: the main path through LLMEngine
# ---------------------------------------------------------------------------

def launch_counts() -> dict:
    """Every kernel's launch counter, by kernel."""
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.ops import quant_matmul as qm
    return {"attention": pa.launch_count,
            "attention_q8": pa.quant_launch_count, "qmm": qm.launch_count}


def reset_launch_counts() -> None:
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.ops import quant_matmul as qm
    pa.launch_count = pa.quant_launch_count = qm.launch_count = 0


def serve(model, requests, attention=None, sampler=None, patch=None,
          setup=None, **engine_opts):
    """Serve the requests through a fresh engine (``engine_opts`` such as
    kv_dtype, weight_dtype, overlap and decode_window go to it), counting
    every kernel's launches over exactly that run.  ``attention`` swaps
    another function in for the engine's float attention entry during the
    run, ``patch`` ({(module, name): function}) others for any module
    function the engine calls, and ``sampler`` another for its sampler
    (the gates' reference and control runs); ``setup(engine)`` runs before
    the requests are served (the window phases' counters).  Returns
    (engine, outputs, seconds, launches by kernel, peak device memory of
    the run, weights included)."""
    import numpy as np
    import torch
    from paddle_tpu_torch.inference import LLMEngine, serving
    from paddle_tpu_torch.ops import paged_attention as pa
    torch.cuda.reset_peak_memory_stats()
    eng = LLMEngine(model, device=DEV, max_num_seqs=8, block_size=BS,
                    max_model_len=MAX_MODEL_LEN, max_prefill_tokens=512,
                    prefill_token_bucket=64, **engine_opts)
    rids = [eng.add_request(p, max_new_tokens=mx, **opts)
            for p, mx, opts in requests]
    assert rids == list(range(len(requests)))
    patch = dict(patch or {})
    if attention is not None:
        patch[(pa, "ragged_paged_attention_segrel_packed")] = attention
    if sampler is not None:
        patch[(serving, "sample_tokens")] = sampler
        step = eng._ragged_step

        def counted_step(Tq, toks, cu, *rest):
            # live rows lead the launch; the rest are padding whose logits
            # come from pad tokens that race on the null page
            sampler.live = int((np.diff(cu) > 0).sum())
            return step(Tq, toks, cu, *rest)
        eng._ragged_step = counted_step
    if setup is not None:
        setup(eng)
    saved = {key: getattr(*key) for key in patch}
    try:
        for (mod, name), fn in patch.items():
            setattr(mod, name, fn)
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        outs = eng.run()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = launch_counts()
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)
    return eng, outs, seconds, launches, torch.cuda.max_memory_allocated()


def plain_attention(q, kc, vc, bt, seg, rel):
    """The engine's attention through the plain version (chunked)."""
    return plain(dict(q=q, kc=kc, vc=vc, bt=bt, seg=seg, rel=rel,
                      Tq=q.shape[0]))


def held_to_plain(attention, log, run_on_plain=True):
    """The engine's attention for a gate run: ``attention`` and the plain
    version are called on the same inputs at every call, and the errors of
    the one against the other are logged -- the kernel held to the plain
    version on the engine's own activations, pages and tables.  The engine
    goes on with the plain version's output, or with ``attention``'s when
    ``run_on_plain`` is false (a control)."""
    def fn(q, kc, vc, bt, seg, rel):
        ref = plain_attention(q, kc, vc, bt, seg, rel)
        out = attention(q, kc, vc, bt, seg, rel)
        log.append(errors(out, ref))
        return ref if run_on_plain else out
    return fn


def kernel_attention(q, kc, vc, bt, seg, rel):
    from paddle_tpu_torch.ops import paged_attention as pa
    return pa._launch_kernel(q, kc, vc, bt, seg, rel)


def blind_attention(q, kc, vc, bt, seg, rel):
    """A gross control: the kernel with every token (past position 0)
    blind to its own key."""
    import torch
    rel = torch.clamp(rel - 1, min=0).to(torch.int32)
    return kernel_attention(q, kc, vc, bt, seg, rel)


def scaled_attention(q, kc, vc, bt, seg, rel):
    """A subtle control: the kernel's output 1% too large, as a
    normalisation fault would make it."""
    return kernel_attention(q, kc, vc, bt, seg, rel) * 1.01


CONTROLS = {"blind": blind_attention, "scaled_1pct": scaled_attention}


def recording_sampler(log):
    """The engine's sampler, logging each step's live logit rows, its
    tokens and which live rows are greedy (``serve`` sets ``fn.live``)."""
    from paddle_tpu_torch.inference import sampling

    def fn(logits, samp):
        tokens = sampling.sample_tokens(logits, samp)
        log.append((logits[:fn.live].clone(), tokens.clone(),
                    samp["temps"][:fn.live] <= 0.0))
        return tokens
    return fn


def forced_sampler(script, log):
    """Emit a recorded run's tokens step by step, logging this run's live
    logit rows: the run then follows the recorded run's schedule, shapes
    and GEMMs exactly, and differs from it only where its attention
    does."""
    steps = iter(script)

    def fn(logits, samp):
        _, tokens, greedy = next(steps)
        log.append((logits[:fn.live].clone(), tokens, greedy))
        return tokens
    return fn


def forced_gap(ref_log, log):
    """Two runs forced along one recorded token stream: the largest gap,
    over every step's live greedy rows, between the reference run's best
    logit and its logit of the token the other run would pick there; the
    largest live logit difference between the runs, over all steps and on
    the first step alone (one forward from the same prompts); and the
    largest reference logit, for scale."""
    import torch
    assert len(log) == len(ref_log), (len(log), len(ref_log))
    gap = diff = 0.0
    for (lg_ref, _, greedy), (lg, _, _) in zip(ref_log, log):
        y = lg.argmax(-1)
        rows = lg_ref.max(-1).values - lg_ref.gather(1, y[:, None])[:, 0]
        g = torch.as_tensor(greedy, device=lg.device)
        if bool(g.any()):
            gap = max(gap, float(rows[g].max()))
        diff = max(diff, float((lg_ref - lg).abs().max()))
    return {"gap": gap, "max_logit_diff": diff,
            "first_step_logit_diff": float(
                (ref_log[0][0] - log[0][0]).abs().max()),
            "max_abs_logit": max(float(lg.abs().max()) for lg, _, _ in
                                 ref_log)}


def worst(errs: list) -> dict:
    return {k: max(e[k] for e in errs) for k in errs[0]}


def teacher_forced(model, requests, outs):
    """Largest gap, over every greedy token y the engine emitted, between
    the dense forward's best logit and its logit of y at that position
    (0 when the engine picked the dense argmax everywhere)."""
    import torch
    worst_gap, agree, total = 0.0, 0, 0
    for rid, (prompt, _, opts) in enumerate(requests):
        if opts.get("temperature", 0.0) > 0.0:
            continue
        gen = outs[rid].generated
        seq = torch.tensor([prompt + gen[:-1]], device=model.device)
        lg = model.forward_logits(seq)[0, len(prompt) - 1:]
        y = torch.tensor(gen, device=lg.device)
        gap = lg.max(-1).values - lg[torch.arange(len(gen),
                                                  device=lg.device), y]
        worst_gap = max(worst_gap, float(gap.max()))
        agree += int((lg.argmax(-1) == y).sum())
        total += len(gen)
    return worst_gap, agree, total


def expected_launches(eng, steps) -> dict:
    """Launches per kernel a run of ``steps`` steps must show: the
    attention kernel the pages call for once per layer per shard per step
    (the other none), and in a quantized-weight engine the dequant matmul
    for q, k and v once per shard, for wo, gate, up and down once, per
    layer, plus the logit head once (once per shard where the vocabulary
    splits), per step: 7 L + 1 at tp=1."""
    L = eng.config.num_hidden_layers
    tp = eng.tp
    q8 = eng.kv_dtype == "int8"
    heads = tp if eng._shard_head else 1
    return {"attention": 0 if q8 else tp * L * steps,
            "attention_q8": tp * L * steps if q8 else 0,
            "qmm": ((3 * tp + 4) * L + heads) * steps
            if eng.weight_dtype != "float32" else 0}


def engine_record(name, run, requests, checks: dict, rounds=None, **extra):
    """One engine phase's JSON line; it passes when every request finished
    with its count, none was quarantined, every kernel was launched as
    ``expected_launches`` says, and every entry of ``checks`` holds.
    ``rounds``: forward passes the run launched, where a decode window
    made more than one a step (else the engine's steps)."""
    eng, outs, seconds, launches, peak = run
    s = eng.summary()
    steps = s["engine_steps"] if rounds is None else rounds
    layers = eng.config.num_hidden_layers
    want = expected_launches(eng, steps)
    att = "attention_q8" if eng.kv_dtype == "int8" else "attention"
    counts_ok = all(len(outs[r].generated) == requests[r][1]
                    and outs[r].finish_reason == "length"
                    for r in range(len(requests)))
    gen_tokens = sum(len(o.generated) for o in outs.values())
    checks = {"finished_with_right_count": counts_ok,
              "none_quarantined": s["quarantined"] == 0,
              "launches_equal_layers_x_steps":
                  launches[att] == want[att] == layers * steps * eng.tp,
              "launches_as_expected_for_every_kernel": launches == want,
              **checks}
    rec = {"phase": name, "ok": all(checks.values()), "checks": checks,
           "requests": len(requests), "layers": layers,
           "dtype": str(eng._act_dtype).split(".")[-1],
           "kv_dtype": eng.kv_dtype, "weight_dtype": eng.weight_dtype,
           "quarantined": s["quarantined"], "steps": steps,
           "engine_steps": s["engine_steps"],
           "kernel_launches": launches[att], "launches": launches,
           "expected_launches": want, "launches_per_step": layers * eng.tp,
           "tp": eng.tp,
           "generated_tokens": gen_tokens, "wall_s": seconds,
           "tokens_per_s": gen_tokens / seconds,
           "prefill_tokens": s["prefill_tokens"],
           "decode_tokens_per_s": s["decode_tokens_per_s"],
           "ttft_p50_ms": s["ttft_p50_ms"], "ttft_p99_ms": s["ttft_p99_ms"],
           "itl_p50_ms": s["itl_p50_ms"], "itl_p99_ms": s["itl_p99_ms"],
           "dispatch_ms_p50": s["dispatch_ms_p50"],
           "block_ms_p50": s["block_ms_p50"],
           "cache_hit_tokens": s["cache_hit_tokens"],
           "preemptions": s["preemptions"],
           "peak_memory_bytes": peak,
           "weight_bytes_resident": eng.weight_bytes_resident(),
           "kv_page_bytes": eng.kv_page_bytes(), **extra}
    emit(rec)
    return rec


def phase_engine_f32(state):
    import numpy as np
    import torch
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    cfg = LlamaConfig.llama_7b()
    cfg.num_hidden_layers = 2
    model = LlamaForCausalLM(cfg, device=DEV, dtype=torch.float32,
                             generator=SEED)
    rng = np.random.default_rng(SEED + 1)
    lens = [5, 300] + [int(x) for x in rng.integers(5, 301, 6)]
    requests = [(rng.integers(0, cfg.vocab_size, n).tolist(), 16, {})
                for n in lens]
    run = serve(model, requests)
    gap, agree, total = teacher_forced(model, requests, run[1])
    rec = engine_record("engine_f32", run, requests,
                        {"teacher_forced_gap_le_1e-3": gap <= 1e-3},
                        teacher_forced_max_gap=gap,
                        greedy_argmax_agreement=f"{agree}/{total}")
    state["engine_f32"] = rec
    del run, model
    torch.cuda.empty_cache()
    return rec["ok"]


def plain_patch(int8_kv):
    """Patches that put the plain versions where the engine calls its
    kernels (the quantized engines' reference runs)."""
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.ops import quant_matmul as qm

    def attention_q8(q, kc, vc, ks, vs, bt, seg, rel):
        return plain_q8(dict(q=q, kc=kc, vc=vc, ks=ks, vs=vs, bt=bt,
                             seg=seg, rel=rel, Tq=q.shape[0])).to(q.dtype)
    patch = {(qm, "matmul"): qm.reference_matmul}
    if int8_kv:
        patch[(pa, "ragged_paged_attention_quant_segrel_packed")] = \
            attention_q8
    else:
        patch[(pa, "ragged_paged_attention_segrel_packed")] = plain_attention
    return patch


def phase_engine_quant_f32(state):
    """The quantized engines' tokens at float32, where the kernels agree
    with their plain versions to f32 rounding: 2 of 32 layers (as
    engine_f32), engine_f32's requests.  A run on the plain versions
    records its logits; a run on the kernels, forced along the same
    tokens, must pick the reference run's argmax at every greedy step up
    to a 1e-3 logit gap (a near-tie may flip), once with int8 weights and
    int8 pages, once with int4 weights."""
    import numpy as np
    import torch
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    cfg = LlamaConfig.llama_7b()
    cfg.num_hidden_layers = 2
    model = LlamaForCausalLM(cfg, device=DEV, dtype=torch.float32,
                             generator=SEED)
    rng = np.random.default_rng(SEED + 1)
    lens = [5, 300] + [int(x) for x in rng.integers(5, 301, 6)]
    requests = [(rng.integers(0, cfg.vocab_size, n).tolist(), 16, {})
                for n in lens]
    ok, runs = True, {}
    for name, opts in (("w8kv8", {"weight_dtype": "int8",
                                  "kv_dtype": "int8"}),
                       ("w4", {"weight_dtype": "int4"})):
        script, log = [], []
        serve(model, requests, sampler=recording_sampler(script),
              patch=plain_patch(opts.get("kv_dtype") == "int8"), **opts)
        run = serve(model, requests, sampler=forced_sampler(script, log),
                    **opts)
        gap = forced_gap(script, log)
        steps = run[0].summary()["engine_steps"]
        launches_ok = run[3] == expected_launches(run[0], steps)
        runs[name] = dict(gap, steps=steps, launches=run[3],
                          launches_as_expected=launches_ok)
        ok &= gap["gap"] <= 1e-3 and launches_ok
        del run, script, log
    emit({"phase": "engine_quant_f32", "ok": ok, "layers": 2,
          "requests": len(requests), "gap_tolerance": 1e-3, "runs": runs})
    state["engine_quant_f32"] = runs
    del model
    torch.cuda.empty_cache()
    return ok


# the engine-level check takes the scale-free measures only: the engine's
# activations are not N(0, 1), and an absolute bound means nothing there
ENGINE_MEASURES = ("token_rel", "l2_rel")


# the depth of the phases cut to keep the whole run inside its time limit
# (engine_w8kv8, engine_w4, the two window phases, engine_spec_bf16,
# frontend_bf16, hf_bridge_bf16 and tune_sweep_bf16's engine): 8 of
# LLaMA-7B's 32 layers at its published widths; engine_bf16,
# sim_fit_bf16, engine_tp2_bf16, blha_bf16 and fused_decoder_bf16 keep
# all 32
CUT_LAYERS = 8


def llama_7b_bf16(layers=None):
    """LLaMA-7B at its published widths, all 32 layers (or ``layers``),
    bf16, random weights from the seed."""
    import torch
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    cfg = LlamaConfig.llama_7b()
    if layers is not None:
        cfg.num_hidden_layers = layers
    return LlamaForCausalLM(cfg, device=DEV, dtype=torch.bfloat16,
                            generator=SEED)


def bf16_requests(V):
    """The 32-layer phases' request mix: 12 requests, prompts 17-700
    tokens (one chunked over two steps), two sharing a 256-token prefix,
    one sampled at T=0.8 / top-p 0.9, 16-64 new tokens."""
    import numpy as np
    rng = np.random.default_rng(SEED + 2)
    shared = rng.integers(0, V, 256).tolist()
    lens = [17, 700] + [int(x) for x in rng.integers(17, 701, 8)]
    requests = [(rng.integers(0, V, n).tolist(),
                 int(rng.integers(16, 65)), {}) for n in lens]
    requests[5] = (requests[5][0], requests[5][1],
                   {"temperature": 0.8, "top_p": 0.9, "seed": 7})
    requests.insert(2, (shared + rng.integers(0, V, 40).tolist(), 64, {}))
    # the second sharer queues behind the 8 slots, so it is admitted after
    # the first has committed the shared pages: a prefix-cache hit
    requests.append((shared + rng.integers(0, V, 90).tolist(), 32, {}))
    return requests


def phase_engine_bf16(state):
    """32 layers in bf16, gated at the attention itself.  A second run
    takes the plain version as its attention and launches the kernel beside
    it at every call, so the kernel is held to the plain version, launch by
    launch, on the engine's own activations, pages and tables, at the
    kernel phase's scale-free tolerances.  Controls (wrong attentions run
    the same way) must fail that check.

    Token-level comparisons are reported, not gated: through 32 layers in
    bf16 the kernel's TPU rounding (q * scale and p rounded to bf16) moves
    the logits about as far as an attention output 1% too large does, so
    no logit tolerance tells the two apart.  They are the dense generate()
    forward's teacher-forced gap, and the plain attention forced along the
    kernel run's tokens (same schedule, shapes and GEMMs; only the
    attention differs).  The kernel run replayed along its own tokens must
    give the same live logits bit for bit, which shows that the forced
    runs differ from it only where their attention does."""
    import torch
    model = llama_7b_bf16()
    requests = bf16_requests(model.config.vocab_size)
    script = []
    run = serve(model, requests, sampler=recording_sampler(script))
    dense_gap, agree, total = teacher_forced(model, requests, run[1])

    def forced(attention=None, run_on_plain=True):
        errs, log = [], []
        serve(model, requests, attention and held_to_plain(
            attention, errs, run_on_plain), forced_sampler(script, log))
        return errs and worst(errs), log

    _, replay = forced()
    replay = forced_gap(script, replay)
    per_launch, plain_log = forced(kernel_attention)
    vs_plain = forced_gap(plain_log, script)
    controls = {}
    for name, attention in CONTROLS.items():
        c_err, c_log = forced(attention, run_on_plain=False)
        controls[name] = {"per_launch": c_err,
                          "fails_gate": not within(c_err, "bfloat16",
                                                   ENGINE_MEASURES),
                          "forced_vs_plain": forced_gap(plain_log, c_log)}
    rec = engine_record(
        "engine_bf16", run, requests,
        {"prefix_cache_hit": run[0].summary()["cache_hit_tokens"] >= 256,
         "per_launch_kernel_vs_plain": within(per_launch, "bfloat16",
                                              ENGINE_MEASURES),
         "controls_fail": all(c["fails_gate"] for c in controls.values()),
         "replay_bit_exact": replay["max_logit_diff"] == 0.0},
        per_launch_errors=per_launch, per_launch_tolerance={
            k: TOLERANCE["bfloat16"][k] for k in ENGINE_MEASURES},
        controls=controls, replay=replay, forced_vs_plain=vs_plain,
        dense_teacher_forced_gap=dense_gap,
        dense_argmax_agreement=f"{agree}/{total}")
    state["engine_bf16"] = rec
    del run, script, plain_log
    state["profile"] = profile_decode(model)
    state["sampling_cost"] = sampling_cost(model)
    del model
    torch.cuda.empty_cache()
    return rec["ok"] and state["sampling_cost"]["ok"]


# the dequant matmul's kernels in a trace: decode tiles, prefill tiles
# (bf16 x above 16 rows) and the ordered sum of the K splits
QMM_KERNEL_NAMES = ("qmm_kernel", "qmm_wgmma_kernel", "sum_splits_kernel")


def profile_decode(model, name="profile", requests=None, **engine_opts):
    """Where a step's time goes: 8 requests (128-token prompts, 32 new
    tokens; or ``requests``) served once unprofiled (wall time) and once
    under torch.profiler (device time by kernel; the profiler slows the
    host, so the idle share divides the kernels' sum by the unprofiled
    wall).  ``engine_opts`` (overlap, decode_window, the quantized
    options, a drafter) go to the engine; the record carries the host
    round trips a decode round and the decode time a round beside the
    per-step figures (a window's ITL sample is its whole launch, as in the
    JAX engine's stats)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    if requests is None:
        rng = np.random.default_rng(SEED + 3)
        requests = [(rng.integers(0, model.config.vocab_size, 128).tolist(),
                     32, {}) for _ in range(8)]
    serve(model, requests[:2], **engine_opts)       # warm the allocator
    eng, _, seconds, _, _ = serve(model, requests, **engine_opts)
    s = eng.summary()
    eng_decode_s = eng.stats.decode_time
    eng_tokens_per_trip = eng.stats.tokens_per_launch()
    del eng
    # the card's kernels only: the host's op events (about five a launch)
    # are not read, and collecting them costs more than the run
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        serve(model, requests, **engine_opts)
    kernels = [e for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")
               and not e.key.startswith("llm_engine.")]

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    qmm_ms = sum(dev_us(e) for e in kernels
                 if any(k in e.key for k in QMM_KERNEL_NAMES)) / 1e3
    att = [e for e in kernels if any(k in e.key for k in PAGED_KERNEL_NAMES)]
    att_ms = sum(dev_us(e) for e in att) / 1e3
    top = sorted(kernels, key=dev_us, reverse=True)[:10]
    rec = {"phase": name, **engine_opts, "requests": len(requests),
           "prompt_tokens": sum(len(p) for p, _, _ in requests),
           "new_tokens": sum(mx for _, mx, _ in requests),
           "steps": s["engine_steps"],
           "wall_ms": seconds * 1e3, "device_busy_ms": busy_ms,
           "device_idle_share": (1 - busy_ms / (seconds * 1e3))
           if busy_ms else "not measured",
           "kernel_launches_per_step": sum(e.count for e in kernels)
           / s["engine_steps"],
           "dispatch_ms_p50": s["dispatch_ms_p50"],
           "block_ms_p50": s["block_ms_p50"], "itl_p50_ms": s["itl_p50_ms"],
           "overlap": s["overlap"], "decode_window": s["decode_window"],
           "host_round_trips": s["host_round_trips"],
           "decode_rounds": s["decode_rounds"],
           "round_trips_per_decode_round": s["host_round_trips"]
           / max(s["decode_rounds"], 1),
           "decode_ms_per_round": 1e3 * eng_decode_s
           / max(s["decode_rounds"], 1),
           "attention_device_ms": att_ms,
           "attention_share_of_busy": att_ms / busy_ms if busy_ms
           else "not measured",
           "attention_launches": sum(e.count for e in att),
           "verify_steps": s.get("verify_steps", 0),
           "tokens_per_round_trip": eng_tokens_per_trip,
           "profile_s": time.perf_counter() - t0,
           "top_kernels": [{"name": e.key[:90], "ms": dev_us(e) / 1e3,
                            "calls": e.count} for e in top]}
    if engine_opts.get("weight_dtype"):
        rec.update(qmm_device_ms=qmm_ms, qmm_share_of_busy=qmm_ms / busy_ms
                   if busy_ms else "not measured")
    emit(rec)
    return rec


def generator_draw(lg, keys):
    """The sampled draw that threefry keys replaced, for its cost alone:
    per row, a torch.Generator seeded from (seed, index) and a Gumbel-max
    pick over its torch.rand noise."""
    import torch
    out = []
    for i, (seed, index) in enumerate(keys):
        gen = torch.Generator(device=lg.device).manual_seed(
            (int(seed) << 32) | int(index))
        u = torch.rand(lg[i:i + 1].shape, generator=gen, device=lg.device)
        g = -torch.log(-torch.log(u.clamp_min(
            torch.finfo(torch.float32).tiny)))
        out.append(torch.argmax(lg[i:i + 1] + g, dim=-1))
    return torch.cat(out)


def wall_ms(fn, reps=30, warm=3) -> float:
    """Median host wall time of one call to a synchronized result: the
    host's dispatch and the card's work, as the engine's step sees them."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def sampling_cost(model) -> dict:
    """What sampling costs a step: the engine's sampler over 8 sampled
    rows (T 0.8, top-p 0.9) at the model's vocabulary, and its draw alone
    (threefry over the [8, V] counters, replayed from a CUDA graph, and
    the same ops launched one by one) against the per-row torch.Generator
    draw it replaced, on the card (time_ms) and on the host's clock
    (wall_ms); then the profile's 8 requests served greedy and sampled,
    twice each in turn, ITL p50 of each run.  Checks: the graph's noise
    equals the eager ops' bit for bit, and the card's threefry bits the
    CPU's."""
    import numpy as np
    import torch
    from paddle_tpu_torch.inference import prng, sampling
    B, V = 8, model.config.vocab_size
    gen = torch.Generator(device=DEV).manual_seed(SEED + 16)
    logits = torch.randn((B, V), generator=gen, device=DEV) * 3
    samp = sampling.make_samp(B, V)
    samp["temps"][:] = 0.8
    samp["top_p"][:] = 0.9
    samp["keys"][:] = np.stack([prng.request_key(7, i) for i in range(B)])
    keys = [(7, i) for i in range(B)]

    def dev_keys():
        return torch.from_numpy(samp["keys"].astype(np.int64)).to(DEV)
    k = dev_keys()
    checks = {"graph_equals_eager": torch.equal(
        prng._gumbel_graphed(k, V)[0].clone(), prng.gumbel(k, V)),
        "bits_equal_cpu": torch.equal(prng.random_bits(k, V).cpu(),
                                      prng.random_bits(k.cpu(), V))}
    calls = {"sample_tokens": lambda: sampling.sample_tokens(logits, samp),
             "threefry_draw": lambda: prng.categorical(dev_keys(), logits),
             "threefry_draw_eager": lambda: torch.argmax(
                 prng.gumbel(dev_keys(), V) + logits, dim=-1),
             "generator_draw": lambda: generator_draw(logits, keys)}
    rec = {"phase": "sampling_cost", "ok": all(checks.values()), **checks,
           "rows": B, "vocab": V,
           **{f"{k}_ms": time_ms(fn) for k, fn in calls.items()},
           **{f"{k}_wall_ms": wall_ms(fn) for k, fn in calls.items()}}
    rng = np.random.default_rng(SEED + 3)
    prompts = [rng.integers(0, V, 128).tolist() for _ in range(8)]
    itl = {"greedy": [], "sampled": []}
    for _ in range(2):
        for kind, opts in (("greedy", {}), ("sampled", {
                "temperature": 0.8, "top_p": 0.9})):
            eng = serve(model, [(p, 32, dict(opts, seed=i))
                                for i, p in enumerate(prompts)])[0]
            itl[kind].append(eng.summary()["itl_p50_ms"])
            del eng
    rec.update(itl_p50_ms=itl)
    emit(rec)
    return rec


def held_q8(log, control_log=None):
    """The int8-KV engine's attention for a gate run: the kernel and the
    plain version (in f32) on the same inputs at every call, errors
    logged; the engine goes on with the plain version's output.  With
    ``control_log``, the kernel on every scale 1% too large
    (``scaled_scales``) is measured against the same plain output too."""
    def fn(q, kc, vc, ks, vs, bt, seg, rel):
        c = dict(q=q, kc=kc, vc=vc, ks=ks, vs=vs, bt=bt, seg=seg, rel=rel,
                 Tq=q.shape[0])
        ref = plain_q8(c)
        log.append(errors(kernel_q8(c), ref))
        if control_log is not None:
            control_log.append(errors(scaled_scales(c), ref))
        return ref.to(q.dtype)
    return fn


def last_row_zeroed(x):
    """A control for a partial M tile: ``x`` with its last row zeroed (a
    kernel that dropped the tile's last row)."""
    x = x.clone()
    x[-1] = 0
    return x


def qmm_measures(out, ref):
    """QMM_TOLERANCE's two measures as one device tensor (no sync)."""
    import torch
    d = out - ref
    return torch.stack([d.norm() / ref.norm().clamp_min(1e-30),
                        d.abs().max() / ref.abs().max().clamp_min(1e-30)])


def qmm_worst(log) -> dict:
    import torch
    return dict(zip(QMM_TOLERANCE, (float(v) for v in
                                    torch.stack(log).amax(0).cpu())))


def held_qmm(log, control_log=None):
    """The engine's dequant matmul for a gate run: the kernel and the
    plain version on the same inputs at every call, QMM_TOLERANCE's
    measures logged on the device; the engine goes on with the plain
    version's output.  With ``control_log``, the kernel on x with its
    last row zeroed (``last_row_zeroed``) is measured against the same
    plain output too."""
    from paddle_tpu_torch.ops import quant_matmul as qm

    def fn(x, q, s, weight_dtype):
        ref = qm.reference_matmul(x, q, s, weight_dtype)
        log.append(qmm_measures(qm._launch_kernel(x, q, s, weight_dtype),
                                ref))
        if control_log is not None:
            control_log.append(qmm_measures(qm._launch_kernel(
                last_row_zeroed(x), q, s, weight_dtype), ref))
        return ref
    return fn


def quantized_engine_phase(name, state, **engine_opts):
    """CUT_LAYERS in bf16 with quantized weights (and int8 pages where
    asked), the request mix of engine_bf16.  A gate run takes the plain
    versions of the dequant matmul and of the attention the pages call
    for, and launches each kernel beside every call, so each kernel is held
    to its plain version, launch by launch, on the engine's own inputs.  A
    second run, on the kernels alone, is the main path: its wall time,
    latencies and launch counts are the phase's."""
    import torch
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.ops import quant_matmul as qm
    model = llama_7b_bf16(CUT_LAYERS)
    requests = bf16_requests(model.config.vocab_size)
    att_log, qmm_log = [], []
    patch = {(qm, "matmul"): held_qmm(qmm_log)}
    if engine_opts.get("kv_dtype") == "int8":
        patch[(pa, "ragged_paged_attention_quant_segrel_packed")] = \
            held_q8(att_log)
    else:
        patch[(pa, "ragged_paged_attention_segrel_packed")] = \
            held_to_plain(kernel_attention, att_log)
    gate = serve(model, requests, patch=patch, **engine_opts)
    gate_steps = gate[0].summary()["engine_steps"]
    gate_calls = {"attention": len(att_log), "qmm": len(qmm_log)}
    gate_want = expected_launches(gate[0], gate_steps)
    gate_tokens = {r: o.generated for r, o in gate[1].items()}
    gate_wall = gate[2]
    att_err = worst(att_log)
    qmm_err = qmm_worst(qmm_log)
    del gate, att_log, qmm_log
    torch.cuda.empty_cache()

    run = serve(model, requests, **engine_opts)
    greedy = [r for r, (_, _, o) in enumerate(requests)
              if o.get("temperature", 0.0) == 0.0]
    same = sum(run[1][r].generated == gate_tokens[r] for r in greedy)
    rec = engine_record(
        name, run, requests,
        {"prefix_cache_hit": run[0].summary()["cache_hit_tokens"] >= 256,
         "gate_held_every_call": gate_calls == {
             "attention": max(gate_want["attention"],
                              gate_want["attention_q8"]),
             "qmm": gate_want["qmm"]},
         "per_launch_attention_vs_plain": within(att_err, "bfloat16",
                                                 ENGINE_MEASURES),
         "per_launch_qmm_vs_plain": qmm_within(qmm_err)},
        per_launch_attention_errors=att_err,
        per_launch_attention_tolerance={
            k: TOLERANCE["bfloat16"][k] for k in ENGINE_MEASURES},
        per_launch_qmm_errors=qmm_err, per_launch_qmm_tolerance=QMM_TOLERANCE,
        gate_calls=gate_calls, gate_steps=gate_steps, gate_wall_s=gate_wall,
        greedy_requests_equal_to_gate_run=f"{same}/{len(greedy)}")
    state[name] = rec
    del run
    state["profile_" + name] = profile_decode(model, "profile_" + name,
                                              **engine_opts)
    del model
    torch.cuda.empty_cache()
    return rec["ok"]


def phase_engine_w8kv8(state):
    return quantized_engine_phase("engine_w8kv8", state, weight_dtype="int8",
                                  kv_dtype="int8")


def phase_engine_w4(state):
    return quantized_engine_phase("engine_w4", state, weight_dtype="int4")


# ---------------------------------------------------------------------------
# window phases: the async step pipeline and the K-step decode window
# ---------------------------------------------------------------------------

WINDOW_K = 4
# new tokens of the window phases' requests, in turn: rows freeze in the
# middle of a window as their budgets run out
WINDOW_BUDGETS = (5, 9, 13, 18, 32)
# host round trips a decode round over the steady decode at K 4 (the JAX
# engine measured 0.277 on the CPU; the tail of each stream's windows is
# shorter than K)
WINDOW_TRIPS_MAX = 0.30
# rows of a decode-sized launch (``serve``'s max_num_seqs): every window
# iteration, and a per-step pure-decode launch
DECODE_ROWS = 8


def window_requests(V):
    """bf16_requests' prompts with staggered budgets (WINDOW_BUDGETS)."""
    return [(p, WINDOW_BUDGETS[i % len(WINDOW_BUDGETS)], o)
            for i, (p, _, o) in enumerate(bf16_requests(V))]


def window_counters(log):
    """A ``serve`` setup that counts, in ``log``, the forward passes the
    engine launches (a ragged step is one, a window its iterations), the
    steady decode's round trips and rounds (tickets of decode rows only,
    dispatched with nobody waiting), and the synchronizing CUDA calls made
    inside the dispatch (torch's sync debug mode, "warn": the host must
    never wait for the card there)."""
    import warnings
    import torch
    log.update(passes=0, decode_passes=0, steady_trips=0, steady_rounds=0,
               windows=0, dispatch_syncs=0, sync_messages=[])

    def setup(eng):
        step, launch, dispatch = (eng._ragged_step, eng._launch_window,
                                  eng._dispatch)

        def ragged_step(Tq, *args):
            log["passes"] += 1
            log["decode_passes"] += Tq == DECODE_ROWS
            return step(Tq, *args)

        def launch_window(iters, *args):
            log["passes"] += iters
            log["decode_passes"] += iters
            log["windows"] += 1
            return launch(iters, *args)

        def checked_dispatch():
            before = eng._inflight
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    dispatch()
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            syncs = [str(w.message) for w in caught
                     if "called a synchronizing" in str(w.message)]
            log["dispatch_syncs"] += len(syncs)
            log["sync_messages"] = (log["sync_messages"] + syncs)[:4]
            t = eng._inflight
            if t is not None and t is not before and not t.chunks \
                    and not eng._waiting:
                log["steady_trips"] += 1
                log["steady_rounds"] += t.window or 1

        eng._ragged_step = ragged_step
        eng._launch_window = launch_window
        eng._dispatch = checked_dispatch
    return setup


def window_run(model, requests, **engine_opts):
    """One counted run (``window_counters``): (run, counters)."""
    log = {}
    run = serve(model, requests, setup=window_counters(log), **engine_opts)
    return run, log


def free_engines() -> None:
    """Give the card back the pages of engines no longer referenced (the
    counters' wrappers make reference cycles, which only the collector
    breaks)."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def run_summary(run, log) -> dict:
    s = run[0].summary()
    return {f: s[f] for f in (
        "engine_steps", "host_round_trips", "decode_rounds", "itl_p50_ms",
        "dispatch_ms_p50", "block_ms_p50", "decode_window_shrinks",
        "decode_window_fallbacks", "quarantined")} | {
        "wall_s": run[2], "launches": run[3],
        "launches_as_expected": run[3] == expected_launches(
            run[0], log["passes"])}


def tokens_of(run, rids):
    return {r: run[1][r].generated for r in rids}


def phase_engine_window_bf16(state):
    """CUT_LAYERS in bf16, 8 slots, the pipeline and the window.  The
    requests (bf16_requests' prompts with staggered budgets) are served
    with overlap off at K 1, with overlap on at K 1 and at K 4, on the
    kernels alone; greedy tokens must be identical across the three, no
    row quarantined, no dispatch synchronizing with the card, the launch
    counts those of the passes run, and the steady decode at K 4 at most
    WINDOW_TRIPS_MAX round trips a decode round.  A gate run at K 4 takes
    the plain attention and launches the kernel beside it at every
    decode-sized call -- every window iteration, and per-step decode --
    where every kernel output must be finite and within the per-launch
    tolerance (the prefill launches run the kernel alone: engine_bf16's
    gate holds those); the controls, run the same way on the first four
    requests, must fail it.  Then the profile rows at K 4 and with overlap
    off on this machine."""
    import torch
    model = llama_7b_bf16(CUT_LAYERS)
    requests = window_requests(model.config.vocab_size)
    greedy = [r for r, (_, _, o) in enumerate(requests)
              if o.get("temperature", 0.0) == 0.0]
    summaries, logs, toks = {}, {}, {}
    for key, opts in (("off_k1", {"overlap": False}), ("on_k1", {}),
                      ("on_k4", {"decode_window": WINDOW_K})):
        run, logs[key] = window_run(model, requests, **opts)
        summaries[key] = run_summary(run, logs[key])
        toks[key] = tokens_of(run, range(len(requests)))
        scan = run[0].compile_counts.get("scan")
        if key != "on_k4":
            del run
            free_engines()
    same = {k: sum(toks[k][r] == toks["off_k1"][r] for r in greedy)
            for k in toks}
    sampled_same = {k: all(toks[k][r] == toks["off_k1"][r]
                           for r in range(len(requests)) if r not in greedy)
                    for k in toks}

    def held_decode(attention, log, finite, run_on_plain=True):
        """``held_to_plain`` at the decode-sized launches (the window's
        iterations, per-step decode), every output checked finite; the
        kernel alone at prefill-sized ones (engine_bf16's gate holds
        those)."""
        def fn(q, kc, vc, bt, seg, rel):
            if q.shape[0] != DECODE_ROWS:
                return kernel_attention(q, kc, vc, bt, seg, rel)
            ref = plain_attention(q, kc, vc, bt, seg, rel)
            out = attention(q, kc, vc, bt, seg, rel)
            finite.append(bool(torch.isfinite(out).all()))
            log.append(errors(out, ref))
            return ref if run_on_plain else out
        return fn

    gate_errs, finite, gate_log = [], [], {}
    gate = serve(model, requests,
                 held_decode(kernel_attention, gate_errs, finite),
                 setup=window_counters(gate_log), decode_window=WINDOW_K)
    gate_err = worst(gate_errs)
    gate_calls_ok = len(gate_errs) == \
        model.config.num_hidden_layers * gate_log["decode_passes"]
    gate_quarantined = gate[0].summary()["quarantined"]
    del gate
    free_engines()
    controls = {}
    for name, attention in CONTROLS.items():
        errs = []
        serve(model, requests[:4], held_decode(attention, errs, [], False),
              decode_window=WINDOW_K)
        controls[name] = {"per_launch": worst(errs),
                          "fails_gate": not within(worst(errs), "bfloat16",
                                                   ENGINE_MEASURES)}
    steady = logs["on_k4"]["steady_trips"] / max(
        logs["on_k4"]["steady_rounds"], 1)
    rec = engine_record(
        "engine_window_bf16", run, requests,
        {"greedy_tokens_identical_off_k1_on_k1_on_k4": all(
            same[k] == len(greedy) for k in same),
         "none_quarantined_any_run": all(
             r["quarantined"] == 0 for r in summaries.values())
         and gate_quarantined == 0,
         "windows_ran": logs["on_k4"]["windows"] > 0 and scan == 1,
         "launches_as_expected_every_run": all(
             r["launches_as_expected"] for r in summaries.values()),
         "dispatch_never_synchronizes": all(
             logs[k]["dispatch_syncs"] == 0 for k in logs),
         "steady_round_trips_per_round_le_0.30": steady <= WINDOW_TRIPS_MAX,
         "gate_held_every_call": gate_calls_ok,
         "gate_outputs_finite": all(finite),
         "per_launch_kernel_vs_plain": within(gate_err, "bfloat16",
                                              ENGINE_MEASURES),
         "controls_fail": all(c["fails_gate"] for c in controls.values())},
        rounds=logs["on_k4"]["passes"],
        window=WINDOW_K, budgets=list(WINDOW_BUDGETS),
        greedy_requests_equal_to_off_k1={k: f"{v}/{len(greedy)}"
                                         for k, v in same.items()},
        sampled_request_equal_to_off_k1=sampled_same,
        steady_round_trips_per_decode_round=steady,
        counters={k: {f: v for f, v in lg.items() if f != "sync_messages"}
                  for k, lg in logs.items()},
        sync_messages=[m for lg in logs.values()
                       for m in lg["sync_messages"]][:4],
        runs=summaries, per_launch_errors=gate_err, per_launch_tolerance={
            k: TOLERANCE["bfloat16"][k] for k in ENGINE_MEASURES},
        gate_calls=len(gate_errs),
        gate_decode_passes=gate_log["decode_passes"],
        gate_windows=gate_log["windows"],
        controls=controls)
    state["engine_window_bf16"] = rec
    del run
    free_engines()
    state["profile_k4"] = profile_decode(model, "profile_k4",
                                         decode_window=WINDOW_K)
    state["profile_sync"] = profile_decode(model, "profile_sync",
                                           overlap=False)
    del model
    free_engines()
    return rec["ok"]


def phase_engine_window_w8kv8(state):
    """CUT_LAYERS in bf16 with int8 weight pools and int8 pages: the window
    requests at K 4 and at K 1 (overlap on), on the kernels alone; greedy
    tokens identical, no row quarantined, no dispatch synchronizing, the
    launch counts those of the passes run (attention L a pass, dequant
    matmul 7 L + 1), and the steady decode's round trips a round."""
    import torch
    model = llama_7b_bf16(CUT_LAYERS)
    requests = window_requests(model.config.vocab_size)
    greedy = [r for r, (_, _, o) in enumerate(requests)
              if o.get("temperature", 0.0) == 0.0]
    opts = {"weight_dtype": "int8", "kv_dtype": "int8"}
    k1, log1 = window_run(model, requests, **opts)
    k1_tokens = tokens_of(k1, greedy)
    k1_summary = run_summary(k1, log1)
    del k1
    free_engines()
    run, log = window_run(model, requests, decode_window=WINDOW_K, **opts)
    same = sum(run[1][r].generated == k1_tokens[r] for r in greedy)
    steady = log["steady_trips"] / max(log["steady_rounds"], 1)
    rec = engine_record(
        "engine_window_w8kv8", run, requests,
        {"greedy_tokens_identical_k4_k1": same == len(greedy),
         "k1_run_launches_and_quarantine":
             k1_summary["launches_as_expected"]
             and k1_summary["quarantined"] == 0,
         "windows_ran": log["windows"] > 0,
         "dispatch_never_synchronizes": log["dispatch_syncs"] == 0
         and log1["dispatch_syncs"] == 0,
         "steady_round_trips_per_round_le_0.30": steady <= WINDOW_TRIPS_MAX},
        rounds=log["passes"], window=WINDOW_K,
        greedy_requests_equal_to_k1=f"{same}/{len(greedy)}",
        steady_round_trips_per_decode_round=steady,
        runs={"k1": k1_summary, "k4": run_summary(run, log)},
        counters={"k1": {f: v for f, v in log1.items()
                         if f != "sync_messages"},
                  "k4": {f: v for f, v in log.items()
                         if f != "sync_messages"}},
        sync_messages=(log1["sync_messages"] + log["sync_messages"])[:4])
    state["engine_window_w8kv8"] = rec
    del run, model
    free_engines()
    return rec["ok"]


# ---------------------------------------------------------------------------
# spec phases: speculative decoding, verify rows in the ragged step
# ---------------------------------------------------------------------------

# max_spec_k of engine_spec_f32's n-gram runs: B (4 + 1) = 40 logit rows,
# the speculation tier below the 64-token prefill bucket
SPEC_TIER_K = 4
# gamma of speculative_generate
SPEC_GAMMA = 4


def motif_requests(V, lens, budgets, seed, spec_ks=None):
    """Requests whose prompts repeat a random motif of 2-5 tokens (as
    tests/test_kv_quant.py's speculative case builds them), so the n-gram
    drafter has something to look up; ``spec_ks`` gives each request's
    spec_k in turn (else the engine's default)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    out = []
    for i, n in enumerate(lens):
        motif = rng.integers(0, V, int(rng.integers(2, 6))).tolist()
        prompt = (motif * (n // len(motif) + 1))[:n]
        opts = {} if spec_ks is None else {"spec_k": spec_ks[i % len(spec_ks)]}
        out.append((prompt, budgets[i % len(budgets)], opts))
    return out


def spec_summary(run, passes=None) -> dict:
    """A speculating run's readings: the spec counters, acceptance, tokens
    emitted a host round trip, ITL and tokens/s, the pool after the run."""
    eng, outs, seconds, launches, _ = run
    st, s = eng.stats, eng.summary()
    gen = sum(len(o.generated) for o in outs.values())
    rec = {f: getattr(st, f) for f in (
        "verify_steps", "draft_proposed", "draft_accepted",
        "rollback_tokens", "rollback_pages", "spec_disables",
        "host_round_trips")}
    rec.update(accept_rate=st.accept_rate(),
               tokens_per_round_trip=st.tokens_per_launch(),
               engine_steps=s["engine_steps"], itl_p50_ms=s["itl_p50_ms"],
               tokens_per_s=gen / seconds, wall_s=seconds,
               quarantined=s["quarantined"], preemptions=s["preemptions"],
               pool_empty=eng.blocks.num_used == 0, launches=launches,
               pad_stats=dict(eng.pad_stats), buckets=sorted(eng._buckets))
    try:
        eng.blocks.check_invariants()
        rec["invariants_hold"] = True
    except AssertionError:
        rec["invariants_hold"] = False
    if passes is not None:
        rec["launches_as_expected"] = launches == expected_launches(eng,
                                                                    passes)
    return rec


def finished_at_length(run, requests) -> bool:
    outs = run[1]
    return all(len(outs[r].generated) == requests[r][1]
               and outs[r].finish_reason == "length"
               for r in range(len(requests)))


def phase_engine_spec_f32(state):
    """2 of LLaMA-7B's 32 layers in f32 (TF32 off), 8 motif requests.
    Greedy tokens must be identical across four runs: speculation off, the
    n-gram drafter at max_spec_k 4 (40 logit rows: the speculation tier),
    a DraftModelDrafter over the model itself, and the dense generate().
    Each run's launches are those of its passes (the draft model's
    single-row launches added to its run's).  A quantized run (int8
    weights and int8 pages, n-gram) puts the int8-page attention and the
    dequant matmul on the verify path: every request must finish at its
    length with the pool back to empty.  A gate run of it takes the plain
    versions of both and launches each kernel beside every call, each
    within its tolerance (f32 attention, QMM_TOLERANCE), with a control at
    every call that must fail.  ``speculative_generate`` (gamma 4) must
    equal generate() greedy with a self-draft and with a 1-layer draft."""
    import torch
    from paddle_tpu_torch.inference import DraftModelDrafter
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.ops import quant_matmul as qm
    from paddle_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                               speculative_generate)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = LlamaConfig.llama_7b()
    cfg.num_hidden_layers = 2
    model = LlamaForCausalLM(cfg, device=DEV, dtype=torch.float32,
                             generator=SEED)
    L = cfg.num_hidden_layers
    requests = motif_requests(cfg.vocab_size, [12, 300, 40, 97, 23, 160,
                                               64, 9], (32, 24, 40),
                              SEED + 5)
    rids = range(len(requests))
    spec = {"drafter": "ngram", "spec_k": SPEC_TIER_K,
            "max_spec_k": SPEC_TIER_K}
    off = serve(model, requests)
    ngram, log = window_run(model, requests, **spec)
    drafter = DraftModelDrafter(model, block_size=BS,
                                max_model_len=MAX_MODEL_LEN, capacity=8)
    draft_passes = []
    step = drafter.engine._ragged_step
    drafter.engine._ragged_step = \
        lambda *a: draft_passes.append(1) or step(*a)
    self_draft = serve(model, requests, drafter=drafter,
                       spec_k=SPEC_TIER_K, max_spec_k=SPEC_TIER_K)
    dense = {r: model.generate([p], max_new_tokens=mx, temperature=0.0)
             [0, len(p):].tolist() for r, (p, mx, _) in enumerate(requests)}
    toks = {name: tokens_of(run, rids) for name, run in (
        ("off", off), ("ngram", ngram), ("self_draft", self_draft))}
    toks["generate"] = dense
    same = {k: sum(toks[k][r] == dense[r] for r in rids) for k in toks}
    self_steps = self_draft[0].summary()["engine_steps"]
    self_want = {"attention": L * (self_steps + len(draft_passes)),
                 "attention_q8": 0, "qmm": 0}
    free_engines()
    quant_opts = dict(spec, weight_dtype="int8", kv_dtype="int8")
    quant = serve(model, requests, **quant_opts)
    q_steps = quant[0].summary()["engine_steps"]
    quant_tokens = tokens_of(quant, rids)
    quant_summary = spec_summary(quant, q_steps)
    quant_at_length = finished_at_length(quant, requests)
    del quant
    free_engines()
    # the quantized run's gate: the plain versions on the path, each kernel
    # launched beside every call and held to it, and a control on the same
    # inputs at every call that must fail (int8 page scales after a
    # rollback differ from speculation off's, so no token comparison holds
    # these launches)
    att_log, att_ctl, qmm_log, qmm_ctl = [], [], [], []
    qgate = serve(model, requests, patch={
        (qm, "matmul"): held_qmm(qmm_log, qmm_ctl),
        (pa, "ragged_paged_attention_quant_segrel_packed"):
            held_q8(att_log, att_ctl)}, **quant_opts)
    qgate_want = expected_launches(qgate[0],
                                   qgate[0].summary()["engine_steps"])
    qgate_rec = {
        "calls": {"attention_q8": len(att_log), "qmm": len(qmm_log)},
        "expected_calls": {"attention_q8": qgate_want["attention_q8"],
                           "qmm": qgate_want["qmm"]},
        "verify_steps": qgate[0].stats.verify_steps,
        "buckets": sorted(qgate[0]._buckets),
        "attention_errors": worst(att_log),
        "attention_tolerance": {k: TOLERANCE["float32"][k]
                                for k in ENGINE_MEASURES},
        "attention_control_scales_1pct": worst(att_ctl),
        "qmm_errors": qmm_worst(qmm_log), "qmm_tolerance": QMM_TOLERANCE,
        "qmm_control_last_row_zeroed": qmm_worst(qmm_ctl),
        "greedy_requests_equal_to_kernel_run": sum(
            qgate[1][r].generated == quant_tokens[r] for r in rids)}
    qgate_ok = {
        "held_every_call": qgate_rec["calls"] == qgate_rec["expected_calls"]
        and qgate_rec["verify_steps"] > 0,
        "attention_vs_plain": within(qgate_rec["attention_errors"],
                                     "float32", ENGINE_MEASURES),
        "qmm_vs_plain": qmm_within(qgate_rec["qmm_errors"]),
        "attention_control_fails": not within(
            qgate_rec["attention_control_scales_1pct"], "float32",
            ENGINE_MEASURES),
        "qmm_control_fails": not qmm_within(
            qgate_rec["qmm_control_last_row_zeroed"])}
    qgate_rec["checks"] = qgate_ok
    del qgate, att_log, att_ctl, qmm_log, qmm_ctl
    free_engines()

    first = requests[0][0]
    ids = torch.tensor([first], device=DEV)
    want = model.generate(ids, max_new_tokens=32, temperature=0.0)
    dcfg = LlamaConfig.llama_7b()
    dcfg.num_hidden_layers = 1
    small = LlamaForCausalLM(dcfg, device=DEV, dtype=torch.float32,
                             generator=SEED + 9)
    sg = {name: bool(torch.equal(speculative_generate(
        model, draft, ids, max_new_tokens=32, gamma=SPEC_GAMMA,
        temperature=0.0), want))
        for name, draft in (("self_draft", model), ("one_layer", small))}
    runs = {"off": spec_summary(off, off[0].summary()["engine_steps"]),
            "ngram": spec_summary(ngram, log["passes"]),
            "self_draft": dict(spec_summary(self_draft),
                               draft_model_passes=len(draft_passes),
                               launches_as_expected=self_draft[3]
                               == self_want),
            "w8kv8_ngram": quant_summary}
    rec = engine_record(
        "engine_spec_f32", ngram, requests,
        {"greedy_tokens_identical_off_ngram_self_draft_generate": all(
            v == len(requests) for v in same.values()),
         "speculation_ran": all(runs[k]["verify_steps"] > 0 for k in (
             "ngram", "self_draft", "w8kv8_ngram")),
         "speculation_tier_bucket": DECODE_ROWS * (SPEC_TIER_K + 1)
         in runs["ngram"]["buckets"],
         "launches_as_expected_every_run": all(
             r["launches_as_expected"] for r in runs.values()),
         "pools_empty_and_invariants": all(
             r["pool_empty"] and r["invariants_hold"]
             for r in runs.values()),
         "none_quarantined_any_run": all(
             r["quarantined"] == 0 for r in runs.values()),
         "w8kv8_finished_at_length": quant_at_length,
         "w8kv8_kernels_launched": quant_summary["launches"]["attention_q8"]
         > 0 and quant_summary["launches"]["qmm"] > 0,
         "w8kv8_gate_every_kernel_call_held_controls_fail": all(
             qgate_ok.values()),
         "speculative_generate_equals_generate": all(sg.values())},
        rounds=log["passes"], max_spec_k=SPEC_TIER_K,
        tokens_equal_to_generate={k: f"{v}/{len(requests)}"
                                  for k, v in same.items()},
        speculative_generate=sg, gamma=SPEC_GAMMA, runs=runs,
        quant_launches=quant_summary["launches"], w8kv8_gate=qgate_rec)
    state["engine_spec_f32"] = rec
    del off, ngram, self_draft, drafter, model, small
    free_engines()
    return rec["ok"]


def spec_launch_flag(flag):
    """A ``serve`` setup that marks, in ``flag["spec"]``, whether the launch
    being packed carries verify rows, and counts such launches with their
    buckets and longest verify run (``flag["shapes"]``: bucket -> run
    lengths)."""
    flag.update(spec=False, launches=0, shapes={})

    def setup(eng):
        run = eng._run_ragged

        def flagged(chunks, spec, batch):
            flag["spec"] = bool(spec)
            if spec:
                flag["launches"] += 1
                Tq = eng._ragged_bucket(
                    sum(n for _, n in chunks) + len(batch)
                    + sum(len(d) + 1 for _, d, _ in spec))
                flag["shapes"].setdefault(Tq, set()).update(
                    len(d) + 1 for _, d, _ in spec)
            return run(chunks, spec, batch)
        eng._run_ragged = flagged
    return setup


def setups(*fns):
    """Several ``serve`` setups run in turn."""
    def setup(eng):
        for fn in fns:
            fn(eng)
    return setup


def held_spec(attention, log, finite, flag, run_on_plain=True):
    """``held_to_plain`` at the launches that carry verify rows, every
    output checked finite; the kernel alone at the others."""
    import torch

    def fn(q, kc, vc, bt, seg, rel):
        if not flag["spec"]:
            return kernel_attention(q, kc, vc, bt, seg, rel)
        ref = plain_attention(q, kc, vc, bt, seg, rel)
        out = attention(q, kc, vc, bt, seg, rel)
        finite.append(bool(torch.isfinite(out).all()))
        log.append(errors(out, ref))
        return ref if run_on_plain else out
    return fn


# a greedy divergence whose dense logit gap is below this is bf16 noise:
# through 32 bf16 layers the engine's streams part from the dense
# forward's at gaps up to 0.23 (engine_bf16's teacher-forced gap)
NEAR_TIE = 0.3


def first_divergence(model, requests, a, b) -> dict:
    """Greedy streams ``a`` and ``b`` (by rid) against each other: the
    requests equal, and for every request where they part, the dense
    forward's logit gap between the two tokens at the first position
    where they do (through 32 bf16 layers, a near-tie decides which one a
    run picks): the first divergence, the largest gap, and how many of
    the gaps are below NEAR_TIE."""
    import torch
    equal, parts = 0, []
    for r, (p, _, _) in enumerate(requests):
        x, y = a[r], b[r]
        if x == y:
            equal += 1
            continue
        i = next(j for j in range(min(len(x), len(y))) if x[j] != y[j])
        lg = model.forward_logits(torch.tensor(
            [p + x[:i]], device=model.device))[0, -1].float()
        parts.append({"rid": r, "position": i, "tokens": [x[i], y[i]],
                      "logit_gap": float((lg[x[i]] - lg[y[i]]).abs()),
                      "max_logit": float(lg.max())})
    return {"equal": f"{equal}/{len(requests)}",
            "first_divergence": parts[0] if parts else None,
            "largest_gap": max(parts, key=lambda d: d["logit_gap"])
            if parts else None,
            "near_ties": f"{sum(d['logit_gap'] < NEAR_TIE for d in parts)}"
                         f"/{len(parts)}", "near_tie_below": NEAR_TIE,
            "divergences": parts}


def phase_engine_spec_bf16(state):
    """LLaMA-7B, CUT_LAYERS in bf16, the n-gram drafter at the default
    max_spec_k 8 with requests asking spec_k 4 and 8 (verify runs of up to
    5 and 9 tokens), 16 motif requests on 8 slots; the buckets and run
    lengths the verify launches took are recorded (random weights continue
    few motifs, so which shapes occur is the model's doing; the kernel
    phases' ``verify_*`` cases hold every shape).  Speculation off and
    on, on the kernels alone: the spec-on run must accept and roll back
    drafts, leave the pool empty
    with its invariants holding, quarantine nothing, launch attention L
    times a pass, and never synchronize with the card inside a dispatch.
    A gate run takes the plain attention at every launch that carries
    verify rows and launches the kernel beside it, each output finite and
    within the per-launch tolerance; the controls, run the same way on the
    first four requests, must fail it.  Reported, not gated: greedy tokens
    against speculation off with the dense logit gap at every divergence
    (the largest, and how many are near-ties), the acceptance rate, tokens a round trip, ITL and tokens/s on and off, and
    a profile of the spec-on run on the first 8 requests (launches a
    step)."""
    import torch
    model = llama_7b_bf16(CUT_LAYERS)
    V = model.config.vocab_size
    L = model.config.num_hidden_layers
    # 8 long-running requests, then 8 short prompts that queue for their
    # slots: their prefill chunks pack beside running verify rows (the
    # 128-token bucket) as budgets run out in turn
    requests = motif_requests(V, [17, 300, 64, 130, 33, 520, 90, 211, 24,
                                  40, 31, 56, 20, 48, 36, 60],
                              (48, 24, 64, 32, 40), SEED + 6, (4, 8))
    rids = range(len(requests))
    off, off_log = window_run(model, requests)
    off_tokens = tokens_of(off, rids)
    off_rec = spec_summary(off, off_log["passes"])
    del off
    free_engines()
    log, on_flag = {}, {}
    run = serve(model, requests, setup=setups(window_counters(log),
                                              spec_launch_flag(on_flag)),
                drafter="ngram")
    runs = {"off": off_rec, "on": spec_summary(run, log["passes"])}
    divergence = first_divergence(model, requests, off_tokens,
                                  tokens_of(run, rids))
    free_engines()

    gate_errs, finite, flag = [], [], {}
    gate = serve(model, requests, held_spec(kernel_attention, gate_errs,
                                            finite, flag),
                 setup=spec_launch_flag(flag), drafter="ngram")
    gate_err = worst(gate_errs) if gate_errs else {}
    gate_calls_ok = bool(gate_errs) and len(gate_errs) == L * flag[
        "launches"]
    gate_summary = spec_summary(gate)
    del gate
    free_engines()
    controls = {}
    for name, attention in CONTROLS.items():
        errs, c_flag = [], {}
        serve(model, requests[:4], held_spec(attention, errs, [], c_flag,
                                             False),
              setup=spec_launch_flag(c_flag), drafter="ngram")
        controls[name] = {"per_launch": worst(errs) if errs else None,
                          "spec_launches": c_flag["launches"],
                          "fails_gate": bool(errs) and not within(
                              worst(errs), "bfloat16", ENGINE_MEASURES)}
        free_engines()
    on = runs["on"]
    rec = engine_record(
        "engine_spec_bf16", run, requests,
        {"drafts_accepted": on["draft_accepted"] > 0,
         "drafts_rolled_back": on["rollback_tokens"] > 0,
         "pool_empty_and_invariants": on["pool_empty"]
         and on["invariants_hold"],
         "none_quarantined_any_run": all(
             r["quarantined"] == 0 for r in (off_rec, on, gate_summary)),
         "launches_as_expected_every_run": off_rec["launches_as_expected"]
         and on["launches_as_expected"],
         "dispatch_never_synchronizes": log["dispatch_syncs"] == 0,
         "gate_held_every_spec_call": gate_calls_ok,
         "gate_outputs_finite": bool(finite) and all(finite),
         "per_launch_kernel_vs_plain": bool(gate_err) and within(
             gate_err, "bfloat16", ENGINE_MEASURES),
         "controls_fail": all(c["fails_gate"] for c in controls.values())},
        rounds=log["passes"], max_spec_k=8, spec_ks=[4, 8],
        spec_launches=on_flag["launches"],
        spec_launch_runs_by_bucket={
            str(k): sorted(v) for k, v in sorted(on_flag["shapes"].items())},
        gate_spec_launch_runs_by_bucket={
            str(k): sorted(v) for k, v in sorted(flag["shapes"].items())},
        greedy_vs_spec_off=divergence, runs=runs,
        dispatch_syncs=log["dispatch_syncs"],
        sync_messages=log["sync_messages"], per_launch_errors=gate_err,
        per_launch_tolerance={k: TOLERANCE["bfloat16"][k]
                              for k in ENGINE_MEASURES},
        gate_calls=len(gate_errs), gate_spec_launches=flag["launches"],
        gate_run=gate_summary, controls=controls)
    state["engine_spec_bf16"] = rec
    del run
    free_engines()
    # the first 8 requests at 32 new tokens: the other profiles' size
    state["profile_spec"] = profile_decode(
        model, "profile_spec", requests=[(p, 32, o) for p, _, o in
                                         requests[:8]], drafter="ngram")
    del model
    free_engines()
    return rec["ok"]


# the host tiers' phases: the spill tier's returning-user stream (4 users'
# 64-token prompts, 8 new tokens each, one request a step) on a pool of
# 17 usable pages, the size of test_kv_tier.py's starved pool at page 16
TIER_USERS, TIER_PROMPT, TIER_NEW, TIER_REQUESTS = 4, 64, 8, 32
TIER_OPTS = dict(max_num_seqs=4, max_model_len=256, num_blocks=18,
                 max_prefill_tokens=128, prefill_token_bucket=64)
# the recovery check's slack on the card's allocated bytes: a share of one
# engine's page pools
LEAK_SHARE = 0.05
# bound on every wait for a request, a server or a subprocess
WAIT_S = 300.0


def tier_stream(V):
    """[(submit step, prompt, new tokens)]: returning users, in turn."""
    import numpy as np
    rng = np.random.default_rng(SEED + 5)
    users = [rng.integers(0, V, TIER_PROMPT).tolist()
             for _ in range(TIER_USERS)]
    return [(i, users[int(u)], TIER_NEW)
            for i, u in enumerate(rng.integers(0, TIER_USERS,
                                               TIER_REQUESTS))]


def drive_stream(eng, stream):
    """Step ``eng`` through ``stream`` from this thread, submitting each
    request at its step; returns {rid: generated} and the wall seconds."""
    import torch
    outs, step_no, pending = {}, 0, list(stream)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while pending or eng.has_unfinished():
        while pending and pending[0][0] <= step_no:
            _, prompt, new = pending.pop(0)
            eng.add_request(prompt, max_new_tokens=new)
        for out in eng.step():
            outs[out.rid] = out.generated
        step_no += 1
    torch.cuda.synchronize()
    return outs, time.perf_counter() - t0


@contextlib.contextmanager
def syncs_counted(log, key):
    """Count into ``log[key]`` the synchronizing CUDA calls made inside the
    block (torch's sync debug mode, "warn")."""
    import warnings
    import torch
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message) for w in caught
             if "called a synchronizing" in str(w.message)]
    log[key] = log.get(key, 0) + len(syncs)
    log["sync_messages"] = (log.get("sync_messages", []) + syncs)[:4]


def tier_counters(log):
    """Wrap an engine for the tier runs: syncs counted inside every
    ``_dispatch`` and ``_prestage`` and, apart, inside the drain; after
    every drain, each page restored in it read back from the pools and
    held to the bytes the tier gave up for it, scales included."""
    import torch
    log.update(dispatch_syncs=0, prestage_syncs=0, drain_syncs=0,
               restored_checked=0, restored_mismatched=0, drains=0)

    def setup(eng):
        dispatch, prestage, drain = (eng._dispatch, eng._prestage,
                                     eng._drain_kv_tier)
        taken = []
        if eng.kv_tier is not None:
            take = eng.kv_tier.take

            def counted_take(h):
                entry = take(h)
                if entry is not None:
                    taken.append(entry)
                return entry
            eng.kv_tier.take = counted_take

        def checked_dispatch():
            with syncs_counted(log, "dispatch_syncs"):
                dispatch()

        def checked_prestage():
            with syncs_counted(log, "prestage_syncs"):
                prestage()

        def checked_drain():
            taken.clear()
            with syncs_counted(log, "drain_syncs"):
                drain()
            log["drains"] += 1
            pools = {"kc": eng._kc, "vc": eng._vc}
            if eng.kv_dtype == "int8":
                pools.update(ks=eng._ks, vs=eng._vs)
            for entry in taken:
                blk = eng.blocks._hash_to_block[entry["hashes"][0]]
                log["restored_checked"] += 1
                log["restored_mismatched"] += not all(
                    torch.equal(p[:, blk].cpu(), entry["arrays"][k])
                    for k, p in pools.items())

        eng._dispatch = checked_dispatch
        eng._prestage = checked_prestage
        eng._drain_kv_tier = checked_drain
    return setup


def tier_run(model, stream, kv_dtype, tier_bytes, tracer=None,
             trace_path=None):
    """One run of the tier stream on a fresh engine stepped from this
    thread, under a degradation controller, with a host tier of
    ``tier_bytes`` (0: none); a traced run dumps its trace to
    ``trace_path``: (record, tokens by rid)."""
    from paddle_tpu_torch.inference import (DegradationController,
                                            HostSpillPool, LLMEngine)
    log = {}
    eng = LLMEngine(model, device=DEV, block_size=BS, kv_dtype=kv_dtype,
                    pressure=DegradationController(), tracer=tracer,
                    kv_tier=HostSpillPool(tier_bytes) if tier_bytes
                    else None, **TIER_OPTS)
    tier_counters(log)(eng)
    ladder = eng.precompile_buckets()
    compiles = dict(eng.compile_counts)
    reset_launch_counts()
    outs, seconds = drive_stream(eng, stream)
    launches = launch_counts()
    s = eng.stats.snapshot()
    eng.blocks.check_invariants()
    rec = {"kv_dtype": kv_dtype, "tier_bytes": tier_bytes,
           "traced": tracer is not None, "wall_s": seconds,
           "ladder": list(ladder),
           "compiles_unmoved": eng.compile_counts == compiles,
           "launches": launches,
           "launches_as_expected": launches == expected_launches(
               eng, s["engine_steps"]),
           "finished_with_right_count": len(outs) == len(stream) and all(
               len(g) == TIER_NEW for g in outs.values()),
           **{k: s[k] for k in (
               "engine_steps", "kv_pages_spilled", "kv_pages_restored",
               "kv_spill_dropped", "spill_tier_hit_rate",
               "cache_miss_tokens", "cache_hit_tokens", "preemptions",
               "parked_evictions", "quarantined")},
           "degradation_tier_entries": eng.degradation_tier_entries,
           "pool_used_after": eng.blocks.num_used,
           **{k: v for k, v in log.items()}}
    if tracer is not None:
        rec["trace_events"] = eng.dump_trace(trace_path)
    del eng
    free_engines()
    return rec, outs


def recovery_requests(V, n, sampled_every, new):
    """n requests, prompts 20-200 tokens; every ``sampled_every``-th at
    T=0.8 with its own seed (all when 1)."""
    import numpy as np
    rng = np.random.default_rng(SEED + 6)
    return [(rng.integers(0, V, int(rng.integers(20, 201))).tolist(), new,
             {"temperature": 0.8, "seed": 100 + i}
             if i % sampled_every == sampled_every - 1 else {})
            for i in range(n)]


def direct_tokens(eng, requests):
    """Serve ``requests`` through ``eng`` from this thread: tokens by
    request index."""
    import torch
    rids = [eng.add_request(p, max_new_tokens=mx, **o)
            for p, mx, o in requests]
    outs = {}
    while eng.has_unfinished():
        for out in eng.step():
            outs[out.rid] = out.generated
    torch.cuda.synchronize()
    return [outs[r] for r in rids]


def submit_all(runner, requests):
    """Submit through a runner or a router and collect every stream:
    [(streamed tokens, finish output)] in request order."""
    import queue
    qs = []
    for p, mx, o in requests:
        q = queue.Queue()
        runner.submit(p, deliver=q.put_nowait, max_new_tokens=mx, **o)
        qs.append(q)
    streams = []
    for q in qs:
        toks = []
        while True:
            kind, val = q.get(timeout=WAIT_S)
            if kind == "finish":
                streams.append((toks, val))
                break
            toks.append(val)
    return streams


def phase_engine_tiers_f32(state):
    """2 of LLaMA-7B's 32 layers in f32 (TF32 off), the serving host tiers
    on the card.  Tier: the returning-user stream on a 17-page pool under
    a degradation controller, float and int8 pages, host tier off and on
    (and on with a tracer for float pages), each engine stepped from this
    thread: greedy tokens identical across the runs, pages spilled and
    restored, every restored page read back from the pools equal to the
    bytes the tier held (scales included), no bucket added, the launches
    those of the steps, no synchronizing call inside any dispatch or
    prestage (the drain's are counted apart); the traced run's
    ``dump_trace`` is Chrome JSON with ``engine.device_inflight`` and the
    tier's spill and restore instants.  Recovery: an in-flight crash
    under ``EngineRunner`` with an engine factory, 8 requests (every
    second sampled), gives the streams one engine gives from this thread,
    and the card's allocated bytes (cuBLAS's per-thread workspaces
    cleared on both sides) come back to within LEAK_SHARE of one engine's
    pools of their value before the crash (the dead engine dropped its
    pools).  Replicas: two replicas through
    ``build_replicas`` behind a ``least`` router, 8 sampled requests,
    give the tokens one engine gives from this thread (two stepping
    threads sharing the sampler's graphed draw)."""
    import gc
    import json as _json
    import os
    import tempfile
    import torch
    from paddle_tpu_torch.inference import FaultPlan, LLMEngine
    from paddle_tpu_torch.inference.frontend import (EngineRunner,
                                                     ReplicaRouter,
                                                     build_replicas)
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.profiler import Tracer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = LlamaConfig.llama_7b()
    cfg.num_hidden_layers = 2
    model = LlamaForCausalLM(cfg, device=DEV, dtype=torch.float32,
                             generator=SEED)
    V = cfg.vocab_size
    stream = tier_stream(V)
    tiers, toks = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        trace_path = os.path.join(tmp, "engine_tiers_trace.json")
        for dt in ("float32", "int8"):
            for name, nbytes, tracer in (("off", 0, None),
                                         ("on", 1 << 30, None),
                                         ("traced", 1 << 30, Tracer())):
                if name == "traced" and dt == "int8":
                    continue
                key = f"{dt}_{name}"
                tiers[key], toks[key] = tier_run(model, stream, dt, nbytes,
                                                 tracer, trace_path)
        with open(trace_path) as f:
            trace = _json.load(f)
    names = {e["name"] for e in trace["traceEvents"]}

    def factory():
        return LLMEngine(model, device=DEV, max_num_seqs=8, block_size=BS,
                         max_model_len=MAX_MODEL_LEN,
                         max_prefill_tokens=512, prefill_token_bucket=64,
                         retain_outputs=False)

    requests = recovery_requests(V, 8, 2, 24)
    want = direct_tokens(factory(), requests)
    free_engines()
    plan = FaultPlan(seed=SEED, inflight_crash_steps=(6,))
    eng = factory()
    eng.set_fault_plan(plan)
    pool_bytes = eng._kc.nbytes + eng._vc.nbytes
    # cuBLAS keeps a workspace per host thread in the caching allocator;
    # the runner's thread adds one, so the comparison drops them
    clear_workspaces = getattr(torch._C, "_cuda_clearCublasWorkspaces",
                               lambda: None)
    torch.cuda.synchronize()
    clear_workspaces()
    mem_before = torch.cuda.memory_allocated()
    runner = EngineRunner(eng, engine_factory=factory).start()
    try:
        streams = submit_all(runner, requests)
    finally:
        drained = runner.drain(timeout_s=WAIT_S)
    fin = runner.engine
    recovered = {"restarts": runner.restarts,
                 "faults": dict(fin.stats.fault_injections),
                 "plan_exhausted": plan.exhausted(),
                 "dead_engine_closed": eng._kc is None,
                 "drained": drained, "pool_used_after": fin.blocks.num_used}
    del eng
    gc.collect()
    torch.cuda.synchronize()
    mem_with_workspaces = torch.cuda.memory_allocated()
    clear_workspaces()
    mem_after = torch.cuda.memory_allocated()
    recovered.update(
        pool_bytes=pool_bytes, allocated_before=mem_before,
        allocated_after=mem_after,
        allocated_after_with_workspaces=mem_with_workspaces,
        streams_equal_direct=[t == w and out.generated == w
                              for (t, out), w in zip(streams, want)])
    del fin, runner
    free_engines()

    sampled = recovery_requests(V, 8, 1, 16)
    want_sampled = direct_tokens(factory(), sampled)
    free_engines()
    router = ReplicaRouter(build_replicas(factory(), factory, 2),
                           policy="least").start()
    try:
        rep_streams = submit_all(router, sampled)
    finally:
        rep_drained = router.drain(timeout_s=WAIT_S)
    replicas = {"drained": rep_drained,
                "per_replica": [e.stats.retired for e in router.engines],
                "equal_one_engine": [t == w and out.generated == w
                                     for (t, out), w in
                                     zip(rep_streams, want_sampled)]}
    del router
    free_engines()

    base = toks["float32_off"]
    checks = {
        "tier_greedy_identical_off_on_traced": all(
            toks[k] == base for k in toks if k.startswith("float32")),
        "tier_int8_identical_off_on": toks["int8_on"] == toks["int8_off"],
        "tier_spilled_and_restored": all(
            tiers[k]["kv_pages_spilled"] > 0
            and tiers[k]["kv_pages_restored"] > 0
            for k in tiers if not k.endswith("off")),
        "tier_off_never_spills": all(
            tiers[k]["kv_pages_spilled"] == 0
            for k in tiers if k.endswith("off")),
        "restored_bytes_equal_held": all(
            t["restored_mismatched"] == 0 for t in tiers.values())
        and all(tiers[k]["restored_checked"] == tiers[k]["kv_pages_restored"]
                for k in tiers),
        "tier_runs_clean": all(
            t["finished_with_right_count"] and t["compiles_unmoved"]
            and t["launches_as_expected"] and t["quarantined"] == 0
            and t["pool_used_after"] == 0 for t in tiers.values()),
        "no_sync_in_dispatch_or_prestage": all(
            t["dispatch_syncs"] == 0 and t["prestage_syncs"] == 0
            for t in tiers.values()),
        "trace_json_has_inflight_spill_restore": {
            "engine.device_inflight", "kv_tier.spill",
            "kv_tier.restore"} <= names,
        "recovery_restarted_once": recovered["restarts"] == 1
        and recovered["faults"] == {"inflight_crash": 1}
        and recovered["plan_exhausted"] and recovered["dead_engine_closed"]
        and recovered["drained"] and recovered["pool_used_after"] == 0,
        "recovery_streams_byte_identical": all(
            recovered["streams_equal_direct"]),
        "recovery_no_leaked_pools": abs(mem_after - mem_before)
        <= LEAK_SHARE * pool_bytes,
        "replicas_sampled_equal_one_engine": replicas["drained"]
        and all(replicas["equal_one_engine"])
        and min(replicas["per_replica"]) > 0}
    rec = {"phase": "engine_tiers_f32", "ok": all(checks.values()),
           "checks": checks, "layers": cfg.num_hidden_layers,
           "tier_runs": tiers, "trace_names": sorted(names),
           "recovery": recovered,
           "replicas": replicas,
           "attention_launches": sum(
               t["launches"]["attention"] for t in tiers.values()),
           "attention_q8_launches": sum(
               t["launches"]["attention_q8"] for t in tiers.values())}
    emit(rec)
    state["engine_tiers_f32"] = rec
    del model
    free_engines()
    return rec["ok"]


# the frontend phase's load: 16 requests over HTTP, prompts 17-300 tokens,
# 8-24 new tokens; even ones streamed (SSE), odd ones unary; the last two
# of every four sampled at T=0.8
FRONTEND_REQUESTS = 16


def frontend_requests(V):
    import numpy as np
    rng = np.random.default_rng(SEED + 7)
    return [{"prompt": rng.integers(0, V, int(rng.integers(17, 301)))
             .tolist(), "max_tokens": int(rng.integers(8, 25)),
             "stream": i % 2 == 0,
             **({"temperature": 0.8, "seed": 200 + i} if i % 4 >= 2
                else {})} for i in range(FRONTEND_REQUESTS)]


def http_call(port, body):
    """One completion over HTTP: (status, tokens, finish reason)."""
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=WAIT_S)
    try:
        conn.request("POST", "/v1/completions",
                     body=json.dumps(body).encode(),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        if not body.get("stream") or resp.status != 200:
            doc = json.loads(resp.read())
            if resp.status != 200:
                return resp.status, [], None
            ch = doc["choices"][0]
            return 200, ch["token_ids"], ch["finish_reason"]
        toks, finish, buf = [], None, b""
        while True:
            chunk = resp.read(256)
            if not chunk:
                break
            buf += chunk
            while b"\n\n" in buf:
                frame, buf = buf.split(b"\n\n", 1)
                data = frame.partition(b"data: ")[2].decode()
                if data == "[DONE]":
                    return 200, toks, finish
                ch = json.loads(data)["choices"][0]
                if ch["finish_reason"] is None:
                    toks.append(ch["token"])
                else:
                    finish = ch["finish_reason"]
        return 200, toks, finish
    finally:
        conn.close()


def http_get(port, path):
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=WAIT_S)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def http_load(port, bodies):
    """Send every request at once, one client thread each; results in
    order and the wall seconds."""
    import threading
    out = [None] * len(bodies)

    def one(i):
        out[i] = http_call(port, bodies[i])

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(bodies))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT_S)
    seconds = time.perf_counter() - t0
    assert not any(t.is_alive() for t in threads), "a client hung"
    return out, seconds


def metric_samples(text, name):
    """{label string: value} of one metric's samples."""
    out = {}
    for line in text.splitlines():
        if line.startswith(f"paddle_tpu_{name}{{"):
            labels, _, value = line[len(f"paddle_tpu_{name}"):] \
                .rpartition(" ")
            out[labels] = float(value)
    return out


def phase_frontend_bf16(state):
    """LLaMA-7B, CUT_LAYERS in bf16, served over HTTP: ``serve_background``
    on 127.0.0.1 (port 0) with two replicas (one engine factory over the
    shared weights), the tracer, the flight recorder, windowed telemetry
    and a host tier on each.  After two warm-up requests, the 16 requests
    of ``frontend_requests`` (8 SSE, 8 unary, half greedy, half sampled)
    run on the kernels alone under torch.profiler (the card's kernels
    only): every request must finish with its length, and the float
    attention kernel's launches must be the layers times the steps the two
    engines took.  The readings: TTFT and ITL p50/p95 as /metrics reports
    them (the 60 s window, warm-up included), the wall time and the
    device's idle share.  Then the same load again with every attention
    call held to the plain version on the same inputs (the server goes on
    with the kernel's output): every call within the per-launch
    tolerance, its output finite.  /metrics, /slo and /debug/trace must
    parse."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.inference import HostSpillPool, LLMEngine
    from paddle_tpu_torch.inference.frontend import serve_background
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.profiler import Tracer
    free_engines()
    model = llama_7b_bf16(CUT_LAYERS)
    L = model.config.num_hidden_layers

    def factory():
        return LLMEngine(model, device=DEV, max_num_seqs=8, block_size=BS,
                         max_model_len=MAX_MODEL_LEN,
                         max_prefill_tokens=512, prefill_token_bucket=64,
                         retain_outputs=False,
                         kv_tier=HostSpillPool(1 << 30))

    bodies = frontend_requests(model.config.vocab_size)
    srv = serve_background(factory(), model_name="llama-7b",
                           host="127.0.0.1", engine_factory=factory,
                           replicas=2, tracer=Tracer(), flight_capacity=64,
                           slo_config={"ttft_p95_ms": 500.0})
    engines = srv.frontend.runner.engines
    try:
        warm, _ = http_load(srv.port, bodies[:2])
        for e in engines:
            e.stats.reset()
        torch.cuda.synchronize()
        reset_launch_counts()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            served, seconds = http_load(srv.port, bodies)
            torch.cuda.synchronize()
        launches = launch_counts()
        steps = [e.summary()["engine_steps"] for e in engines]
        status_m, metrics = http_get(srv.port, "/metrics")
        status_s, slo = http_get(srv.port, "/slo")
        status_t, trace = http_get(srv.port, "/debug/trace")
        metrics = metrics.decode()
        slo_doc, trace_doc = json.loads(slo), json.loads(trace)

        errs, finite = [], []

        def held(q, kc, vc, bt, seg, rel):
            ref = plain_attention(q, kc, vc, bt, seg, rel)
            out = kernel_attention(q, kc, vc, bt, seg, rel)
            finite.append(bool(torch.isfinite(out).all()))
            errs.append(errors(out, ref))
            return out

        for e in engines:
            e.stats.reset()
        entry = pa.ragged_paged_attention_segrel_packed
        pa.ragged_paged_attention_segrel_packed = held
        try:
            gated, gate_seconds = http_load(srv.port, bodies)
        finally:
            pa.ragged_paged_attention_segrel_packed = entry
        gate_steps = [e.summary()["engine_steps"] for e in engines]
    finally:
        stopped = srv.stop()
    kernels = [e for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")
               and not e.key.startswith("llm_engine.")]
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    lat = metric_samples(metrics, "windowed_latency_seconds")

    def q(channel, quantile):
        key = f'{{channel="{channel}",quantile="{quantile}",window="60s"}}'
        return None if lat.get(key) is None else lat[key] * 1e3

    def right(results):
        return [r[0] == 200 and r[2] == "length"
                and len(r[1]) == b["max_tokens"]
                for r, b in zip(results, bodies)]

    gate_err = worst(errs) if errs else {}
    checks = {
        "warmup_served": all(r[0] == 200 for r in warm),
        "every_request_finished_with_its_length": all(right(served)),
        "gated_requests_finished_with_their_length": all(right(gated)),
        "launches_equal_layers_x_steps":
            launches["attention"] == L * sum(steps) > 0
            and launches["attention_q8"] == launches["qmm"] == 0,
        "both_replicas_served": min(steps) > 0,
        "gate_held_every_call": len(errs) == L * sum(gate_steps) > 0,
        "gate_outputs_finite": all(finite),
        "per_launch_kernel_vs_plain": within(gate_err, "bfloat16",
                                             ENGINE_MEASURES),
        "metrics_slo_trace_parse": status_m == status_s == status_t == 200
        and "paddle_tpu_requests_finished_total" in metrics
        and "slo" in slo_doc and bool(trace_doc["traceEvents"]),
        "server_drained": stopped}
    rec = {"phase": "frontend_bf16", "ok": all(checks.values()),
           "checks": checks, "layers": L, "replicas": len(engines),
           "requests": len(bodies),
           "streamed": sum(1 for b in bodies if b["stream"]),
           "sampled": sum(1 for b in bodies if "temperature" in b),
           "new_tokens": sum(b["max_tokens"] for b in bodies),
           "wall_s": seconds, "steps_by_replica": steps,
           "launches": launches, "kernel_launches": launches["attention"],
           "ttft_p50_ms": q("ttft", "0.5"), "ttft_p95_ms": q("ttft", "0.95"),
           "itl_p50_ms": q("itl", "0.5"), "itl_p95_ms": q("itl", "0.95"),
           "device_busy_ms": busy_ms,
           "device_idle_share": 1 - busy_ms / (seconds * 1e3)
           if busy_ms else "not measured",
           "gate_wall_s": gate_seconds, "gate_calls": len(errs),
           "per_launch_errors": gate_err, "per_launch_tolerance": {
               k: TOLERANCE["bfloat16"][k] for k in ENGINE_MEASURES},
           "slo_state": slo_doc.get("slo_state_name"),
           "trace_events": len(trace_doc["traceEvents"]),
           "nvidia_smi": nvidia_smi()}
    emit(rec)
    state["frontend_bf16"] = rec
    del srv, engines, model
    free_engines()
    return rec["ok"]


def phase_frontend_cli(state):
    """``python -m paddle_tpu_torch.inference.frontend --model llama-sm``
    on a free port as a subprocess on its default device (the card): it
    must say it listens, answer one streamed request through http.client
    with its length, and on SIGINT drain and exit 0."""
    import os
    import queue
    import signal
    import socket
    import threading
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.inference.frontend",
         "--model", "llama-sm", "--port", str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    lines = queue.Queue()
    reader = threading.Thread(
        target=lambda: [lines.put(ln) for ln in proc.stdout], daemon=True)
    reader.start()
    out, listening, result, rc = [], False, None, None
    t0 = time.perf_counter()
    try:
        while time.perf_counter() - t0 < WAIT_S and proc.poll() is None:
            try:
                ln = lines.get(timeout=1.0)
            except queue.Empty:
                continue
            out.append(ln.rstrip())
            if "listening on" in ln:
                listening = True
                break
        if listening:
            result = http_call(port, {"prompt": list(range(1, 9)),
                                      "max_tokens": 8, "stream": True})
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=WAIT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    reader.join(10.0)
    while not lines.empty():
        out.append(lines.get().rstrip())
    checks = {"listening": listening,
              "streamed_its_length": result is not None
              and result[0] == 200 and len(result[1]) == 8
              and result[2] == "length",
              "sigint_drained_exit_0": rc == 0
              and any("drained" in ln for ln in out)}
    rec = {"phase": "frontend_cli", "ok": all(checks.values()),
           "checks": checks, "tokens": result and result[1],
           "exit_code": rc, "output": out[-8:],
           "seconds": time.perf_counter() - t0}
    emit(rec)
    state["frontend_cli"] = rec
    return rec["ok"]


# ---------------------------------------------------------------------------
# sim_fit_bf16: the fleet simulator's cost model fitted from the port's own
# trace; hf_bridge_bf16: a Hugging Face layout state dict through from_hf
# ---------------------------------------------------------------------------

SIM_REQUESTS = 32            # run_mixed_bench's stream (non-smoke branch)
SIM_MIN_JOINED_STEPS = 50    # engine.step spans joined with an engine.pack
SIM_METRICS = ("ttft_p50_ms", "ttft_p95_ms", "itl_p50_ms", "tokens_per_s")


def phase_sim_fit_bf16(state):
    """LLaMA-7B, 32 layers in bf16, serving ``tools/perf/serve_bench.py``'s
    mixed workload as ``run_mixed_bench`` does at its full size
    (``tools/perf/torch_mixed_bench.py``, a transcription: 32 requests,
    seed 0, every 4th prompt over the 256-token prefill budget; 16 slots,
    pages of 16, prefix caching, the n-gram drafter at spec_k 4, the async
    pipeline on), on the kernels alone with the tracer on over the timed
    pass (after a warm pass).  The trace goes through the stdlib
    ``tools/perf/step_timeline.py --fit`` unchanged; the fit, loaded with
    ``paddle_tpu_torch.sim.CostModel.from_json``, and the run's record and
    workload dump go through ``paddle_tpu_torch.sim.validate_record``.
    Gates: every request served, the attention kernel launched once a
    layer a step, at least SIM_MIN_JOINED_STEPS engine.step spans joined
    with an engine.pack, the fit written, the validation's fingerprint
    the dump's and its four predictions finite and positive.  The
    prediction's error against the run is reported, not gated: whether
    the model holds for the port on the card is the reading."""
    import os
    import tempfile
    import torch
    from paddle_tpu_torch.profiler import Tracer
    from paddle_tpu_torch.sim import CostModel, validate_record
    tools = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "tools", "perf")
    sys.path.insert(0, tools)
    import torch_mixed_bench
    free_engines()
    model = llama_7b_bf16()
    L = model.config.num_hidden_layers
    tracer = Tracer()

    def before_timed():
        torch.cuda.synchronize()
        reset_launch_counts()

    t0 = time.perf_counter()
    record, dump, eng = torch_mixed_bench.run_mixed(
        model, SIM_REQUESTS, SEED, False, device=DEV, tracer=tracer,
        before_timed=before_timed)
    torch.cuda.synchronize()
    launches = launch_counts()
    serve_s = time.perf_counter() - t0
    s = eng.summary()
    with tempfile.TemporaryDirectory() as tmp:
        path = {k: os.path.join(tmp, f"sim_fit_{k}.json")
                for k in ("trace", "workload", "record", "calibration")}
        events = tracer.dump(path["trace"])
        for k, obj in (("workload", dump), ("record", record)):
            with open(path[k], "w") as f:
                json.dump(obj, f, sort_keys=True)
        fit = subprocess.run(
            [sys.executable, os.path.join(tools, "step_timeline.py"),
             path["trace"], "--fit", path["calibration"], "--json-only"],
            capture_output=True, text=True, timeout=600)
        fitted = fit.returncode == 0 and os.path.exists(path["calibration"])
        timeline = json.loads(fit.stdout.strip().splitlines()[-1]) \
            if fit.stdout.strip() else {}
        cost = CostModel.from_json(path["calibration"]) if fitted else None
    report = validate_record(record, dump, cost) if fitted else {}
    # a reading beside it, not a gate: the same record scored with no
    # pipeline lag (the simulator's overlap-off arm), since the port's
    # host-bound step commits a launch's tokens before it dispatches the
    # next, where the lag the simulator models is a whole active step
    lag0 = validate_record(dict(record, overlap="off"), dump, cost) \
        if fitted else {}
    meta = cost.meta if fitted else {}
    joined = meta.get("steps_fit", 0) + meta.get("outlier_steps_dropped", 0)
    predicted = report.get("predicted", {})
    checks = {
        "every_request_served": not eng.has_unfinished()
        and s["quarantined"] == 0 and s["engine_steps"] > 0,
        "launches_equal_layers_x_steps":
            launches["attention"] == L * s["engine_steps"]
            and launches["attention_q8"] == launches["qmm"] == 0,
        "joined_steps_at_least_50": joined >= SIM_MIN_JOINED_STEPS,
        "fit_succeeded": fitted and meta.get("source") == "fit",
        "validation_fingerprint_is_the_dump's":
            report.get("workload_fingerprint")
            == dump["workload_fingerprint"],
        "predictions_finite_positive": all(
            isinstance(predicted.get(k), (int, float))
            and math.isfinite(predicted[k]) and predicted[k] > 0
            for k in SIM_METRICS)}
    step_p50_ms = timeline.get("step_p50_ms")
    rec = {"phase": "sim_fit_bf16", "ok": all(checks.values()),
           "checks": checks, "layers": L, "requests": SIM_REQUESTS,
           "engine_kw": dump["engine_kw"], "spec_k": dump["spec_k"],
           "workload_fingerprint": dump["workload_fingerprint"],
           "seconds": serve_s, "engine_steps": s["engine_steps"],
           "launches": launches, "kernel_launches": launches["attention"],
           "trace_events": events, "joined_steps": joined,
           "fit_stderr": fit.stderr[-2000:] if not fitted else "",
           "fit": None if cost is None else {
               "steps_fit": meta["steps_fit"], "r2": meta["r2"],
               "outlier_steps_dropped": meta["outlier_steps_dropped"],
               "empty_steps": meta["empty_steps"],
               "step_base_s": cost.step_base_s,
               "step_per_token_s": cost.step_per_token_s,
               "host_per_step_s": cost.host_per_step_s,
               "active_frac": cost.active_frac,
               "decode_table": {str(k): v for k, v in
                                sorted(cost.decode_table.items())}},
           "timeline": {k: timeline.get(k) for k in (
               "steps", "step_p50_ms", "step_p95_ms", "value",
               "device_frac", "overlap_achieved_frac", "phases")},
           "host": {"dispatch_ms_p50": record["dispatch_ms_p50"],
                    "block_ms_p50": record["block_ms_p50"],
                    "fitted_host_per_step_ms": None if cost is None
                    else cost.host_per_step_s * 1e3,
                    "fitted_host_share_of_step_p50":
                        cost.host_per_step_s * 1e3 / step_p50_ms
                        if cost is not None and step_p50_ms else None},
           "record": record,
           "validation": {k: report.get(k) for k in (
               "predicted", "actual", "rel_err", "max_abs_rel_err")},
           "validation_no_pipeline_lag": {k: lag0.get(k) for k in (
               "predicted", "rel_err", "max_abs_rel_err")},
           "nvidia_smi": nvidia_smi()}
    emit(rec)
    state["sim_fit_bf16"] = rec
    del eng, model
    free_engines()
    return rec["ok"]


def hf_layout_state(model) -> dict:
    """A Hugging Face layout state dict of ``model`` on its device in its
    dtype: HF names, q/k rows taken back from the interleaved to the
    rotate-half RoPE layout (the inverse of ``from_hf``'s permutation),
    projections ``[out, in]``, ``lm_head.weight`` ``[V, H]``, and each
    layer's ``rotary_emb.inv_freq``, which ``from_hf`` must skip."""
    import numpy as np
    import torch
    from paddle_tpu_torch.models.llama import _unrotate_perm
    cfg = model.config
    d = cfg.hidden_size // cfg.num_attention_heads
    dev = model.device
    inv = torch.from_numpy(np.argsort(_unrotate_perm(d))).to(dev)
    inv_freq = 1.0 / cfg.rope_theta ** (
        torch.arange(0, d, 2, dtype=torch.float32, device=dev) / d)

    def rotate_half(w, n):                 # [in, n * d] -> [n * d, in]
        return w.T.reshape(n, d, -1).index_select(1, inv) \
            .reshape(n * d, -1).contiguous()

    lay = model.layers
    out = {"model.embed_tokens.weight": model.embed.clone()}
    with torch.no_grad():
        for i in range(cfg.num_hidden_layers):
            p = f"model.layers.{i}."
            out[p + "input_layernorm.weight"] = lay["ln1"][i].clone()
            out[p + "self_attn.q_proj.weight"] = rotate_half(
                lay["wq"][i], cfg.num_attention_heads)
            out[p + "self_attn.k_proj.weight"] = rotate_half(
                lay["wk"][i], cfg.num_key_value_heads)
            for name, key in (("self_attn.v_proj", "wv"),
                              ("self_attn.o_proj", "wo"),
                              ("mlp.gate_proj", "gate"),
                              ("mlp.up_proj", "up"),
                              ("mlp.down_proj", "down")):
                out[p + name + ".weight"] = lay[key][i].T.contiguous()
            out[p + "post_attention_layernorm.weight"] = \
                lay["ln2"][i].clone()
            out[p + "self_attn.rotary_emb.inv_freq"] = inv_freq.clone()
        out["model.norm.weight"] = model.norm_f.clone()
        out["lm_head.weight"] = model.head.T.contiguous()
    return out


def phase_hf_bridge_bf16(state):
    """LLaMA-7B, CUT_LAYERS in bf16: the port's model serves
    ``bf16_requests`` on the kernels alone; a Hugging Face layout bf16
    state dict derived from it on the card (``hf_layout_state``, inv_freq
    entries included) goes through ``from_hf(state, config=cfg,
    dtype=torch.bfloat16)``, timed, with the card's peak memory over the
    conversion.  Gates: every decode parameter of the converted model
    bit-equal to the original's; the converted model serves the same
    requests to the same tokens on the kernels alone; a gate run on the
    converted model holds every attention launch to its plain version on
    the same inputs (the engine goes on with the plain output) within the
    per-launch tolerance, and the controls held the same way fail it; the
    conversion never held more than the converted model and 1 GiB of
    temporaries on the card."""
    import torch
    from paddle_tpu_torch.models.llama import LAYER_KEYS, from_hf
    free_engines()
    model = llama_7b_bf16(CUT_LAYERS)
    cfg = model.config
    L = cfg.num_hidden_layers
    requests = bf16_requests(cfg.vocab_size)
    rids = range(len(requests))

    def served(run):
        eng, outs, seconds, launches, _ = run
        steps = eng.summary()["engine_steps"]
        return {"tokens": tokens_of(run, rids), "seconds": seconds,
                "steps": steps, "launches": launches,
                "finished": all(len(outs[r].generated) == requests[r][1]
                                and outs[r].finish_reason == "length"
                                for r in rids),
                "launches_ok": launches["attention"] == L * steps > 0}

    original = served(serve(model, requests))
    free_engines()
    hf_state = hf_layout_state(model)
    skipped = sum(k.endswith("rotary_emb.inv_freq") for k in hf_state)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    conv = from_hf(hf_state, config=cfg, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    convert_s = time.perf_counter() - t0
    peak_over_base = torch.cuda.max_memory_allocated() - base
    model_bytes = sum(p.numel() * p.element_size()
                      for p in conv.parameters())
    a, b = model.decode_params(), conv.decode_params()
    unequal = [k for k in LAYER_KEYS
               if not torch.equal(a["layers"][k], b["layers"][k])] + \
        [k for k in ("embed", "norm_f", "head") if not torch.equal(a[k], b[k])]
    del hf_state, model, a, b
    free_engines()
    converted = served(serve(conv, requests))
    free_engines()
    errs = []
    gate = served(serve(conv, requests,
                        held_to_plain(kernel_attention, errs)))
    free_engines()
    controls = {}
    for name, attention in CONTROLS.items():
        c_errs = []
        serve(conv, requests, held_to_plain(attention, c_errs))
        free_engines()
        c_err = worst(c_errs)
        controls[name] = {"per_launch": c_err, "calls": len(c_errs),
                          "fails_gate": not within(c_err, "bfloat16",
                                                   ENGINE_MEASURES)}
    gate_err = worst(errs) if errs else {}
    checks = {
        "decode_params_bit_equal": not unequal,
        "inv_freq_entries_skipped": skipped == L,
        "served_every_request_with_its_count":
            original["finished"] and converted["finished"]
            and gate["finished"],
        "launches_equal_layers_x_steps":
            original["launches_ok"] and converted["launches_ok"],
        "tokens_equal_the_original": converted["tokens"]
        == original["tokens"],
        "gate_held_every_call": len(errs) == L * gate["steps"] > 0,
        "per_launch_kernel_vs_plain": within(gate_err, "bfloat16",
                                             ENGINE_MEASURES),
        "controls_fail": all(c["fails_gate"] for c in controls.values()),
        "no_whole_model_staging": peak_over_base <= model_bytes + (1 << 30)}
    rec = {"phase": "hf_bridge_bf16", "ok": all(checks.values()),
           "checks": checks, "layers": L, "requests": len(requests),
           "hf_tensors": 9 * L + 3 + skipped, "inv_freq_entries": skipped,
           "unequal_params": unequal, "convert_s": convert_s,
           "convert_peak_bytes_over_start": peak_over_base,
           "model_bytes": model_bytes,
           "original": {k: v for k, v in original.items() if k != "tokens"},
           "converted": {k: v for k, v in converted.items()
                         if k != "tokens"},
           "gate": {k: v for k, v in gate.items() if k != "tokens"},
           "gate_tokens_equal_the_original": gate["tokens"]
           == original["tokens"],
           "kernel_launches": original["launches"]["attention"]
           + converted["launches"]["attention"],
           "gate_calls": len(errs), "per_launch_errors": gate_err,
           "per_launch_tolerance": {k: TOLERANCE["bfloat16"][k]
                                    for k in ENGINE_MEASURES},
           "controls": controls, "nvidia_smi": nvidia_smi()}
    emit(rec)
    state["hf_bridge_bf16"] = rec
    del conv
    free_engines()
    return rec["ok"]


# ---------------------------------------------------------------------------
# tensor-parallel serving (tp=2, both shards on the one card) and the tuner
# ---------------------------------------------------------------------------

TP = 2
# the w8kv8 tier run's plan, forced on both degrees: with K slabs a split
# fixed for every dequant matmul and one key split for every walk, each
# output column and each head sums in one order at any N and any H_kv, so
# tp=2 commits the very bytes tp=1 does (without it the rules pick their
# splits from N and H_kv, and the sums' order follows)
TP_FORCED = {"quant_matmul": {"tile": -1, "split_slabs": 4},
             "paged_attention": {"split_keys": 1024}}
TP_TIER_PROMPT = 3 * BS + 8            # three full pages and a partial


@contextlib.contextmanager
def forced_tuning(configs):
    """Force tuned configs through the lookup (PADDLE_TPU_TUNE_FORCE)."""
    import os
    saved = os.environ.get("PADDLE_TPU_TUNE_FORCE")
    os.environ["PADDLE_TPU_TUNE_FORCE"] = json.dumps(configs)
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("PADDLE_TPU_TUNE_FORCE", None)
        else:
            os.environ["PADDLE_TPU_TUNE_FORCE"] = saved


def shard_residency(eng) -> dict:
    """Per-shard against total bytes: pages, resident pages, pools and
    weights (replicated tensors count in full on a shard, sharded ones
    their block)."""
    pools = [sum(getattr(sh, k).nbytes for k in eng._pool_names())
             for sh in eng._shards]
    rep, shd = eng._weight_tensors()
    nbytes = sum(t.nbytes for t in shd)
    return {
        "kv_page_bytes": eng.kv_page_bytes(),
        "kv_page_bytes_per_shard": eng.kv_page_bytes_per_shard(),
        "kv_bytes_resident": eng.kv_bytes_resident(),
        "kv_bytes_resident_per_shard": eng.kv_bytes_resident_per_shard(),
        "pool_bytes_by_shard": pools,
        "weight_bytes_resident": eng.weight_bytes_resident(),
        "weight_bytes_resident_per_shard":
            eng.weight_bytes_resident_per_shard(),
        "sharded_weight_bytes": nbytes,
        "checks": {
            "page_bytes_half": eng.kv_page_bytes_per_shard() * eng.tp
            == eng.kv_page_bytes(),
            "resident_bytes_half": eng.kv_bytes_resident_per_shard()
            * eng.tp == eng.kv_bytes_resident() > 0,
            "pools_split_evenly": len(set(pools)) == 1
            and sum(pools) == eng.kv_page_bytes()
            * eng.blocks.num_blocks,
            "weights_per_shard": eng.weight_bytes_resident_per_shard()
            == eng.weight_bytes_resident() - nbytes + nbytes // eng.tp}}


def shapes_counted(log):
    """Patches that count the engine's attention and dequant matmul calls
    by operand shape (q heads / KV heads; N) and call through."""
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.ops import quant_matmul as qm
    att, att_q8, mm = (pa.ragged_paged_attention_segrel_packed,
                       pa.ragged_paged_attention_quant_segrel_packed,
                       qm.matmul)

    def count(kind, key):
        log.setdefault(kind, {})
        log[kind][key] = log[kind].get(key, 0) + 1

    def attention(q, kc, *rest):
        count("attention", f"H{q.shape[1]}_Hkv{kc.shape[1]}")
        return att(q, kc, *rest)

    def attention_q8(q, kc, *rest):
        count("attention_q8", f"H{q.shape[1]}_Hkv{kc.shape[1]}")
        return att_q8(q, kc, *rest)

    def matmul(x, q, s, wdt):
        count("qmm", f"N{q.shape[1]}")
        return mm(x, q, s, wdt)
    return {(pa, "ragged_paged_attention_segrel_packed"): attention,
            (pa, "ragged_paged_attention_quant_segrel_packed"): attention_q8,
            (qm, "matmul"): matmul}


def tier_pages(model, tp, prompt):
    """int8 weights and pages at ``tp`` with a host spill tier: A serves
    ``prompt``; B and C extend A's conversation and part inside its cached
    partial tail page (a copy-on-write: the JAX package's
    test_engine_cow_on_diverging_followups); then the parked pages spill
    at a drain, a hint restores the prompt's chain at the next, and D
    serves the prompt again from the restored pages.  Returns the tokens,
    the copies, the tier's bytes of each chain page, the pools' bytes
    there after the restore (the shards' heads concatenated), and whether
    every pool kept its address."""
    import torch
    from paddle_tpu_torch.inference import HostSpillPool, LLMEngine
    from paddle_tpu_torch.inference.kv_cache import prefix_chain_hashes
    tier = HostSpillPool(1 << 30)
    eng = LLMEngine(model, device=DEV, tp=tp, max_num_seqs=8, block_size=BS,
                    max_model_len=MAX_MODEL_LEN, max_prefill_tokens=512,
                    prefill_token_bucket=64, weight_dtype="int8",
                    kv_dtype="int8", kv_tier=tier)
    names = eng._pool_names()
    ptrs = [getattr(sh, k).data_ptr() for sh in eng._shards for k in names]
    a = eng.add_request(prompt, max_new_tokens=5)
    gen_a = eng.run()[a].generated
    base = prompt + gen_a[:4]
    b = eng.add_request(base + [3], max_new_tokens=8)
    c = eng.add_request(base + [7], max_new_tokens=8)
    outs = eng.run()
    chain = prefix_chain_hashes(prompt, eng.block_size)
    evicted = eng.blocks.evict_parked(eng.blocks.num_cached)
    eng.step()                                     # the drain spills
    held = {h: {k: v.clone() for k, v in
                tier._entries[tier._by_hash[h]]["arrays"].items()}
            for h in chain if h in tier}
    eng.prefetch_hint(chain)
    eng.step()                                     # the drain restores
    restored = {}
    for h in chain:
        blk = eng.blocks._hash_to_block.get(h)
        if blk is not None:
            restored[h] = {k: torch.cat([getattr(sh, k)[:, blk].cpu()
                                         for sh in eng._shards], 1)
                           for k in names}
    d = eng.add_request(prompt, max_new_tokens=5)
    again = eng.run()[d].generated
    s = eng.summary()
    moved = ptrs != [getattr(sh, k).data_ptr() for sh in eng._shards
                     for k in names]
    res = {"tokens": {"a": gen_a, "b": outs[b].generated,
                      "c": outs[c].generated, "d": again},
           "cow": s["block_pool"]["cow_count"], "evicted": evicted,
           "chain_pages": len(chain), "spilled": s["kv_pages_spilled"],
           "restored_pages": s["kv_pages_restored"],
           "prefetch_hit_pages": s["kv_prefetch_hit_pages"],
           "held": held, "restored": restored, "pools_moved": moved}
    eng.close()
    return res


def phase_engine_tp2_f32(state):
    """engine_f32's model (LLaMA-7B widths, 2 layers, f32) and requests at
    tp=2, both shards on the one card: a correctness path (the walk at 16
    heads and 16 KV heads a shard, the q/k/v products at N 2,048).  The
    tp=1 run records its tokens and logits; the tp=2 run on the kernels
    alone must give the same greedy tokens, and a tp=2 run forced along
    tp=1's tokens reports the logit gap; a gate run holds every attention
    launch of both shards to the plain version, controls failing;
    per-shard bytes are half the totals.  Then int8 weights and pages at
    tp 1 and 2 under one forced plan (TP_FORCED), with a copy-on-write and
    a spill and restore: the tier holds, and the pools get back, the same
    bytes at both degrees, in place."""
    import numpy as np
    import torch
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = LlamaConfig.llama_7b()
    cfg.num_hidden_layers = 2
    model = LlamaForCausalLM(cfg, device=DEV, dtype=torch.float32,
                             generator=SEED)
    rng = np.random.default_rng(SEED + 1)
    lens = [5, 300] + [int(x) for x in rng.integers(5, 301, 6)]
    requests = [(rng.integers(0, cfg.vocab_size, n).tolist(), 16, {})
                for n in lens]
    script1, script2, log = [], [], []
    run1 = serve(model, requests, sampler=recording_sampler(script1))
    run2 = serve(model, requests, sampler=recording_sampler(script2), tp=TP)
    same = all(run1[1][r].generated == run2[1][r].generated
               for r in range(len(requests)))
    serve(model, requests, sampler=forced_sampler(script1, log), tp=TP)
    gap = forced_gap(script1, log)
    errs = []
    gate = serve(model, requests,
                 attention=held_to_plain(kernel_attention, errs), tp=TP)
    gate_want = expected_launches(gate[0],
                                  gate[0].summary()["engine_steps"])
    per_launch = worst(errs)
    controls = {}
    for name, attention in CONTROLS.items():
        c_errs = []
        serve(model, requests[:4], attention=held_to_plain(
            attention, c_errs, run_on_plain=False), tp=TP)
        controls[name] = {"per_launch": worst(c_errs),
                          "fails_gate": not within(worst(c_errs), "float32",
                                                   ENGINE_MEASURES)}
    bytes_ = shard_residency(run2[0])
    del gate, script1, script2, log
    free_engines()

    qcfg = LlamaConfig.llama_7b()
    qcfg.num_hidden_layers = 2
    prompt = [int(x) for x in np.random.default_rng(SEED + 17).integers(
        0, qcfg.vocab_size, TP_TIER_PROMPT)]
    with forced_tuning(TP_FORCED):
        tiers = {tp: tier_pages(model, tp, prompt) for tp in (1, TP)}
    t1, t2 = tiers[1], tiers[TP]
    same_held = t1["held"].keys() == t2["held"].keys() and all(
        torch.equal(t1["held"][h][k], t2["held"][h][k])
        for h in t1["held"] for k in t1["held"][h])
    back = all(torch.equal(t2["restored"][h][k], v)
               for h, page in t2["held"].items() for k, v in page.items())
    tier_rec = {k: t2[k] for k in ("tokens", "cow", "evicted", "spilled",
                                   "chain_pages", "restored_pages",
                                   "prefetch_hit_pages", "pools_moved")}
    tier_rec["pages_held"] = len(t2["held"])
    tier_rec["forced_plan"] = TP_FORCED
    tier_checks = {
        "tier_tokens_equal_tp1": t1["tokens"] == t2["tokens"],
        "tier_cow_happened": t2["cow"] > 0 and t2["cow"] == t1["cow"],
        "tier_spilled_and_restored":
            len(t2["held"]) == t2["chain_pages"] == TP_TIER_PROMPT // BS
            and t2["restored_pages"] >= t2["chain_pages"]
            and t2["prefetch_hit_pages"] > 0,
        "tier_restored_prompt_repeats": t2["tokens"]["d"]
        == t2["tokens"]["a"],
        "tier_spilled_bytes_equal_tp1": same_held,
        "tier_restored_bytes_equal_held": back,
        "tier_pools_in_place": not t2["pools_moved"]}
    rec = engine_record(
        "engine_tp2_f32", run2, requests,
        {"tokens_equal_tp1": same,
         "gate_held_every_call": len(errs) == gate_want["attention"],
         "per_launch_kernel_vs_plain": within(per_launch, "float32",
                                              ENGINE_MEASURES),
         "controls_fail": all(c["fails_gate"] for c in controls.values()),
         **bytes_.pop("checks"), **tier_checks},
        tp1_kernel_launches=run1[3], logit_gap_vs_tp1=gap,
        per_launch_errors=per_launch, per_launch_tolerance={
            k: TOLERANCE["float32"][k] for k in ENGINE_MEASURES},
        gate_calls=len(errs), controls=controls, residency=bytes_,
        w8kv8_tier=tier_rec, card=nvidia_smi())
    state["engine_tp2_f32"] = rec
    del run1, run2, tiers, model
    free_engines()
    return rec["ok"]


# 2 layers for the int4 run: the scale slicing, not depth
TP_W4_LAYERS = 2


def phase_engine_tp2_bf16(state):
    """LLaMA-7B (32 layers) in bf16 at tp=2 on the one card, engine_bf16's
    requests.  A gate run takes the plain attention and launches the
    kernel beside every call of both shards, held to the scale-free bf16
    tolerances; the main path, on the kernels alone, counts its walk
    launches by per-shard shape and reads dispatch_ms and ITL (reported,
    not gated); controls on four requests must fail the gate.  Then int4
    weights at 2 layers, tp 2 (the int4 scales sliced along their last
    axis): a gate run holding every dequant matmul and walk launch to its
    plain version, and a run on the kernels alone whose launches are
    counted by shape."""
    import torch
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.ops import quant_matmul as qm
    model = llama_7b_bf16()
    heads = model.config.num_attention_heads // TP
    kv_heads = model.config.num_key_value_heads // TP
    requests = bf16_requests(model.config.vocab_size)
    errs = []
    gate = serve(model, requests,
                 attention=held_to_plain(kernel_attention, errs), tp=TP)
    gate_want = expected_launches(gate[0],
                                  gate[0].summary()["engine_steps"])
    gate_tokens = {r: o.generated for r, o in gate[1].items()}
    del gate
    free_engines()
    shapes = {}
    run = serve(model, requests, patch=shapes_counted(shapes), tp=TP)
    per_launch = worst(errs)
    controls = {}
    for name, attention in CONTROLS.items():
        c_errs = []
        serve(model, requests[:4], attention=held_to_plain(
            attention, c_errs, run_on_plain=False), tp=TP)
        controls[name] = {"per_launch": worst(c_errs),
                          "fails_gate": not within(worst(c_errs), "bfloat16",
                                                   ENGINE_MEASURES)}
    greedy = [r for r, (_, _, o) in enumerate(requests)
              if o.get("temperature", 0.0) == 0.0]
    agree = sum(run[1][r].generated == gate_tokens[r] for r in greedy)
    bytes_ = shard_residency(run[0])
    del model
    free_engines()

    cfg = LlamaConfig.llama_7b()
    cfg.num_hidden_layers = TP_W4_LAYERS
    small = LlamaForCausalLM(cfg, device=DEV, dtype=torch.bfloat16,
                             generator=SEED)
    att_log, qmm_log, qmm_control = [], [], []
    w4_gate = serve(small, requests, tp=TP, weight_dtype="int4", patch={
        (qm, "matmul"): held_qmm(qmm_log, qmm_control),
        (pa, "ragged_paged_attention_segrel_packed"):
            held_to_plain(kernel_attention, att_log)})
    w4_want = expected_launches(w4_gate[0],
                                w4_gate[0].summary()["engine_steps"])
    qmm_err, qmm_ctl = qmm_worst(qmm_log), qmm_worst(qmm_control)
    w4_calls = {"attention": len(att_log), "qmm": len(qmm_log)}
    del w4_gate, att_log, qmm_log, qmm_control
    w4_shapes = {}
    w4 = serve(small, requests, tp=TP, weight_dtype="int4",
               patch=shapes_counted(w4_shapes))
    w4_tp1 = serve(small, requests, weight_dtype="int4")
    w4_same = sum(w4[1][r].generated == w4_tp1[1][r].generated
                  for r in greedy)
    w4_s = w4[0]
    w4_rec = {"layers": TP_W4_LAYERS, "launches": w4[3],
              "expected_launches": expected_launches(
                  w4_s, w4_s.summary()["engine_steps"]),
              "launches_by_shape": w4_shapes, "gate_calls": w4_calls,
              "gate_expected": {"attention": w4_want["attention"],
                                "qmm": w4_want["qmm"]},
              "per_launch_qmm_errors": qmm_err,
              "control_last_row_zeroed": qmm_ctl,
              "head_split": w4_s._shard_head,
              "int4_scale_blocks": list(w4_s._shards[0].layers["wq_s"].shape),
              "greedy_requests_equal_to_tp1": f"{w4_same}/{len(greedy)}",
              "weight_bytes_resident": w4_s.weight_bytes_resident(),
              "weight_bytes_resident_per_shard":
                  w4_s.weight_bytes_resident_per_shard(),
              "wall_s": w4[2]}
    w4_checks = {
        "w4_launches_as_expected": w4[3] == w4_rec["expected_launches"],
        "w4_gate_held_every_call": w4_calls == w4_rec["gate_expected"],
        "w4_per_launch_qmm_vs_plain": qmm_within(qmm_err),
        "w4_qmm_control_fails": not qmm_within(qmm_ctl),
        "w4_q_products_at_shard_width": w4_shapes["qmm"].get(
            f"N{cfg.hidden_size // TP}", 0) == 3 * TP * TP_W4_LAYERS
        * w4_s.summary()["engine_steps"]}
    rec = engine_record(
        "engine_tp2_bf16", run, requests,
        {"prefix_cache_hit": run[0].summary()["cache_hit_tokens"] >= 256,
         "gate_held_every_call": len(errs) == gate_want["attention"],
         "per_launch_kernel_vs_plain": within(per_launch, "bfloat16",
                                              ENGINE_MEASURES),
         "controls_fail": all(c["fails_gate"] for c in controls.values()),
         "walk_at_shard_heads": set(shapes["attention"]) == {
             f"H{heads}_Hkv{kv_heads}"},
         **bytes_.pop("checks"), **w4_checks},
        launches_by_shape=shapes, per_launch_errors=per_launch,
        per_launch_tolerance={k: TOLERANCE["bfloat16"][k]
                              for k in ENGINE_MEASURES},
        gate_calls=len(errs), controls=controls, residency=bytes_,
        greedy_requests_equal_to_gate_run=f"{agree}/{len(greedy)}",
        w4=w4_rec, card=nvidia_smi())
    state["engine_tp2_bf16"] = rec
    del run, w4, w4_tp1, small
    free_engines()
    return rec["ok"]


# one sweep shape a kernel at LLaMA-7B widths: the keys the engine below
# asks (tq = its prefill bucket, rows = its prefill budget, m = its slots)
TUNE_SHAPES = {
    "flash_attention": [{"seq_q": MAX_MODEL_LEN, "seq_k": MAX_MODEL_LEN,
                         "head_dim": D, "dtype": "bfloat16"}],
    "flash_attention_varlen": [{"seq_q": 512, "seq_k": MAX_MODEL_LEN,
                                "head_dim": D, "dtype": "bfloat16"}],
    "fused_norms": [{"rows": 512, "hidden": 4096, "dtype": "bfloat16"}],
    "paged_attention": [{"tq": 64, "kv_heads": H, "head_dim": D, "page": BS,
                         "nblk": NBLK, "dtype": "bfloat16"}],
    "quant_matmul": [{"m": 8, "k": 4096, "n": 11008, "dtype": "int8"}],
}
TUNE_LAYERS = CUT_LAYERS
# children a sweep starts at once (their imports and CUDA contexts overlap;
# a lock gives the card to one at a time)
TUNE_PARALLEL = 6


def phase_tune_sweep_bf16(state):
    """``run_sweep`` with ``SubprocessMeasurer`` over TUNE_SHAPES into a
    temporary cache file: each candidate in a child process that launches
    the kernel through the wrapper the engine calls (the candidate forced
    through the normal lookup), holds its output to the plain version and
    times it with CUDA events.  Then engine_bf16's requests through an
    engine with int8 weights (bf16 pages, all five lookups) that reads the
    cache: its report must show a hit for every kernel, a gate run holds
    every walk and dequant matmul launch to its plain version, and a run on
    the kernels alone counts its launches."""
    import os
    import tempfile
    import torch
    from paddle_tpu_torch import tune
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.ops import quant_matmul as qm
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "tuning_cache.json")
        t0 = time.perf_counter()
        report = tune.run_sweep(tune.SubprocessMeasurer(
            timeout=300, iters=10, reps=10, parallel=TUNE_PARALLEL), path,
            shapes=TUNE_SHAPES)
        sweep_s = time.perf_counter() - t0
        rows = {r["kernel"]: r for r in report["results"]}
        kernels = {name: {
            "sig": r["sig"], "default": tune.defaults_for(
                tune.get_kernel(name), TUNE_SHAPES[name][0]),
            "winner": r.get("config"), "default_ms": r.get("default_s", 0)
            * 1e3, "winner_ms": r.get("score_s", 0) * 1e3,
            "speedup": r.get("speedup"), "candidates": len(
                tune.candidate_configs(tune.get_kernel(name),
                                       TUNE_SHAPES[name][0])),
            "failed": r.get("failed"), "error": r.get("error")}
            for name, r in rows.items()}
        tune.set_cache_path(path)
        try:
            model = llama_7b_bf16(TUNE_LAYERS)
            requests = bf16_requests(model.config.vocab_size)
            att_log, qmm_log = [], []
            gate = serve(model, requests, weight_dtype="int8", patch={
                (qm, "matmul"): held_qmm(qmm_log),
                (pa, "ragged_paged_attention_segrel_packed"):
                    held_to_plain(kernel_attention, att_log)})
            gate_want = expected_launches(gate[0],
                                          gate[0].summary()["engine_steps"])
            gate_calls = {"attention": len(att_log), "qmm": len(qmm_log)}
            att_err, qmm_err = worst(att_log), qmm_worst(qmm_log)
            del gate, att_log, qmm_log
            free_engines()
            run = serve(model, requests, weight_dtype="int8")
            report_engine = run[0].summary()["tuning_cache"]
        finally:
            tune.set_cache_path(None)
    hits = {k: v["hit"] for k, v in report_engine["kernels"].items()}
    rec = engine_record(
        "tune_sweep_bf16", run, requests,
        {"sweep_row_for_every_kernel": set(rows) == set(TUNE_SHAPES)
         and all("error" not in r for r in rows.values()),
         "no_candidate_failed": all(not r.get("failed")
                                    for r in rows.values()),
         "engine_hits_every_kernel": set(hits) == set(TUNE_SHAPES)
         and all(hits.values()),
         "gate_held_every_call": gate_calls == {
             "attention": gate_want["attention"], "qmm": gate_want["qmm"]},
         "per_launch_attention_vs_plain": within(att_err, "bfloat16",
                                                 ENGINE_MEASURES),
         "per_launch_qmm_vs_plain": qmm_within(qmm_err)},
        sweep_seconds=sweep_s, sweep_entries=report["entries"],
        sweep_device=report["device"], sweep=kernels,
        engine_tuning_cache=report_engine,
        per_launch_attention_errors=att_err, per_launch_qmm_errors=qmm_err,
        gate_calls=gate_calls, card=nvidia_smi())
    state["tune_sweep_bf16"] = rec
    del run, model
    free_engines()
    return rec["ok"]


# ---------------------------------------------------------------------------
# flash phase: the three flash attention kernels against their plain versions
# ---------------------------------------------------------------------------

# (B, S, H, Hk, D): the trainer's attention at the bench configuration
# (GQA group 4), LLaMA-7B's (D = 128, where sm_scale is not a power of two
# and the rounding of q * sm_scale shows), and D 256 at a small size (the
# CUDA-core kernels in both types, reached by scaled_dot_product_attention)
FLASH_SHAPES = {"trainer": (2, 2048, 16, 4, 64), "7b": (1, 2048, 32, 32, 128),
                "d256": (1, 512, 8, 2, 256), "d384": (1, 512, 8, 2, 384),
                "d512": (1, 512, 8, 2, 512)}
# lse, f32 on both sides and summed in another order: absolute (values up
# to ~20).  Gradients are held by two scale-free measures, max|d| / max|ref|
# over the whole tensor (at TOLERANCE's token_rel) and ||d|| / ||ref||
# (l2_rel): their magnitude grows with S, and some rows are zero
# analytically (query 0 sees one key), so neither an absolute nor a
# per-row bound fits.
LSE_ABS = 1e-3
# the three kernels' times at the trainer's attention in bf16 on the
# mma.sync kernels the wgmma ones replaced (PERF.md section 6, "was";
# NVIDIA H100 80GB HBM3, 700.00 W): the flash phase's record carries them
# beside this run's (the kernels line holds only this run's numbers)
FLASH_WAS_MS = {"trainer_bfloat16": {"fwd": 0.2349, "dkdv": 0.6572,
                                     "dq": 0.2721}}


def rows(x):
    """[B, S, ...] -> [B * S, ...]: one row per sequence position."""
    return x.reshape(x.shape[0] * x.shape[1], -1)


def grad_errors(got, want) -> dict:
    d = got.float() - want.float()
    w = want.float()
    return {"abs": float(d.abs().max()),
            "max_rel": float(d.abs().max() / w.abs().max().clamp_min(1e-12)),
            "l2_rel": float(d.norm() / w.norm().clamp_min(1e-12))}


def grad_within(errs: dict, dtype_name: str) -> bool:
    tol = TOLERANCE[dtype_name]
    return errs["max_rel"] <= tol["token_rel"] and \
        errs["l2_rel"] <= tol["l2_rel"]


def flash_bound(shape, dtype_name, kernel):
    """Least time of one causal launch: the bytes it must move (each
    operand once) over HBM bandwidth, and its products over the causal
    triangle (S (S + 1) / 2 query-key pairs a head; the forward runs 2
    products, dK/dV 4, dQ 3, each 2 D flops a pair) over the dtype's
    peak.  Returns (ms, bound_by, bytes, flops)."""
    B, S, H, Hk, D = shape
    isz = 4 if dtype_name == "float32" else 2
    pairs = S * (S + 1) // 2
    qb, kb, vec = B * S * H * D * isz, B * S * Hk * D * isz, B * H * S * 4
    nbytes, products = {
        "fwd": (2 * qb + 2 * kb + vec, 2),
        "dkdv": (2 * qb + 4 * kb + 2 * vec, 4),
        "dq": (3 * qb + 2 * kb + 2 * vec, 3)}[kernel]
    flops = products * 2 * B * H * pairs * D
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nbytes, flops)


def flash_case(shape, dtype, gen) -> dict:
    import torch
    B, S, H, Hk, D = shape

    def randn(*s):
        return torch.randn(s, generator=gen, device=DEV).to(dtype)
    return dict(q=randn(B, S, H, D), k=randn(B, S, Hk, D),
                v=randn(B, S, Hk, D), do=randn(B, S, H, D))


def flash_controls(c, ref, lse_ref, delta, name) -> dict:
    """Kernel runs that must fail the holds: query head j reading kv head
    j % Hk (GQA only), the diagonal excluded (the kernel on q one position
    ahead of k, so query i sees keys < i), and lse + log 2 fed to both
    backward kernels."""
    from paddle_tpu_torch.ops import flash_attention as fa
    q, k, v, do = c["q"], c["k"], c["v"], c["do"]
    G = q.shape[2] // k.shape[2]
    out = {}
    if G > 1:
        o, _ = fa._launch_fwd(q, k.repeat(1, 1, G, 1), v.repeat(1, 1, G, 1),
                              True)
        e = errors(rows(o), rows(ref))
        out["gqa_j_mod_hk"] = dict(e, fails=not within(e, name))
    o, _ = fa._launch_fwd(q[:, 1:].contiguous(), k[:, :-1].contiguous(),
                          v[:, :-1].contiguous(), True)
    e = errors(rows(o), rows(ref[:, 1:]))
    out["diagonal_excluded"] = dict(e, fails=not within(e, name))
    lse2 = lse_ref + math.log(2.0)
    dk2, dv2 = fa._launch_dkdv(q, k, v, do, lse2, delta, True)
    dq2 = fa._launch_dq(q, k, v, do, lse2, delta, True)
    dk_r, dv_r = fa.flash_bwd_dkdv_reference(q, k, v, do, lse_ref, delta,
                                             True)
    dq_r = fa.flash_bwd_dq_reference(q, k, v, do, lse_ref, delta, True)
    for g, got, want in (("dk", dk2, dk_r), ("dv", dv2, dv_r),
                         ("dq", dq2, dq_r)):
        e = grad_errors(got, want)
        out[f"lse_plus_log2_{g}"] = dict(e, fails=not grad_within(e, name))
    return out


def flash_repeats_identical(c, first, lse_ref, delta, n=10) -> bool:
    """Each kernel launched n more times on the same inputs gives its
    first outputs bit for bit (no atomics, a fixed summation order)."""
    import torch
    from paddle_tpu_torch.ops import flash_attention as fa
    q, k, v, do = c["q"], c["k"], c["v"], c["do"]
    same = True
    for _ in range(n):
        again = (*fa._launch_fwd(q, k, v, True),
                 *fa._launch_dkdv(q, k, v, do, lse_ref, delta, True),
                 fa._launch_dq(q, k, v, do, lse_ref, delta, True))
        same &= all(torch.equal(a, b) for a, b in zip(again, first))
    return bool(same)


def dev_us(e):
    """A profiler event's own device time in microseconds."""
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def named(key: str, names) -> bool:
    """Does a profiled kernel name hold one of ``names`` as a whole word?"""
    import re
    return any(re.search(rf"\b{n}\b", key) for n in names)


def profiled_kernel_ms(fn, names, reps=10):
    """The kernel's own device time a call (kernels named one of
    ``names``), under torch.profiler over ``reps`` calls after one warm-up:
    time_ms also counts the wrapper's small device ops and any gap the
    host leaves between them."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")
            and named(e.key, names)]
    if sum(e.count for e in hits) != reps:
        return "not measured"
    return sum(dev_us(e) for e in hits) / 1e3 / reps


def flash_library(c):
    """Yardstick only (the port never calls it): PyTorch's
    scaled_dot_product_attention, causal with GQA, on the same inputs in
    [B, H, S, D]; returns (forward fn, backward fn, its output)."""
    import torch
    import torch.nn.functional as F
    qh, kh, vh = (c[n].transpose(1, 2).detach().requires_grad_(True)
                  for n in ("q", "k", "v"))
    doh = c["do"].transpose(1, 2)

    def fwd():
        return F.scaled_dot_product_attention(qh, kh, vh, is_causal=True,
                                              enable_gqa=True)
    o = fwd()
    return (fwd, lambda: torch.autograd.grad(o, (qh, kh, vh), doh,
                                             retain_graph=True),
            o.detach().transpose(1, 2))


def phase_flash(state):
    import torch
    from paddle_tpu_torch.ops import flash_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=DEV).manual_seed(SEED + 6)
    cases, ok = {}, True
    for sname, shape in FLASH_SHAPES.items():
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            c = flash_case(shape, dtype, gen)
            q, k, v, do = c["q"], c["k"], c["v"], c["do"]
            out, lse = fa._launch_fwd(q, k, v, True)
            ref, lse_ref = fa.flash_fwd_reference(q, k, v, True)
            delta = fa.attention_delta(ref, do)
            dk, dv = fa._launch_dkdv(q, k, v, do, lse_ref, delta, True)
            dq = fa._launch_dq(q, k, v, do, lse_ref, delta, True)
            dk_r, dv_r = fa.flash_bwd_dkdv_reference(q, k, v, do, lse_ref,
                                                     delta, True)
            dq_r = fa.flash_bwd_dq_reference(q, k, v, do, lse_ref, delta,
                                             True)
            errs = {"out": errors(rows(out), rows(ref)),
                    "lse_abs": float((lse - lse_ref).abs().max()),
                    "dk": grad_errors(dk, dk_r), "dv": grad_errors(dv, dv_r),
                    "dq": grad_errors(dq, dq_r)}
            finite = all(bool(torch.isfinite(x).all())
                         for x in (out, lse, dk, dv, dq))
            held = (finite and within(errs["out"], name)
                    and errs["lse_abs"] <= LSE_ABS
                    and all(grad_within(errs[g], name)
                            for g in ("dk", "dv", "dq")))
            repeats = flash_repeats_identical(c, (out, lse, dk, dv, dq),
                                              lse_ref, delta)
            del dk, dv, dq, dk_r, dv_r, dq_r
            controls = flash_controls(c, ref, lse_ref, delta, name)
            ok &= held and repeats and all(x["fails"]
                                           for x in controls.values())
            lib_fwd, lib_bwd, lib_out = flash_library(c)
            timing = {
                "ms": {"fwd": time_ms(lambda: fa._launch_fwd(q, k, v, True)),
                       "dkdv": time_ms(lambda: fa._launch_dkdv(
                           q, k, v, do, lse_ref, delta, True)),
                       "dq": time_ms(lambda: fa._launch_dq(
                           q, k, v, do, lse_ref, delta, True))},
                "plain_ms": {
                    "fwd": time_ms(lambda: fa.flash_fwd_reference(
                        q, k, v, True)),
                    "dkdv": time_ms(lambda: fa.flash_bwd_dkdv_reference(
                        q, k, v, do, lse_ref, delta, True)),
                    "dq": time_ms(lambda: fa.flash_bwd_dq_reference(
                        q, k, v, do, lse_ref, delta, True))},
                # the port's whole backward: delta, dK/dV and dQ
                "bwd_total_ms": time_ms(lambda: fa._backward(
                    q, k, v, ref, lse_ref, do, True)),
                "library_ms": {"fwd": time_ms(lib_fwd),
                               "bwd_dq_dk_dv": time_ms(lib_bwd)},
                "library_max_abs_err": float(
                    (lib_out.float() - ref.float()).abs().max())}
            timing["bound"] = {
                kern: dict(zip(("ms", "by", "bytes", "flops"),
                               flash_bound(shape, name, kern)))
                for kern in ("fwd", "dkdv", "dq")}
            if dtype == torch.bfloat16 and shape[4] <= 128:   # wgmma
                timing["kernel_ms"] = {"fwd": profiled_kernel_ms(
                    lambda: fa._launch_fwd(q, k, v, True),
                    FLASH_KERNEL_NAMES["fwd"])}
            if f"{sname}_{name}" in FLASH_WAS_MS:
                timing["was_ms"] = FLASH_WAS_MS[f"{sname}_{name}"]
            cases[f"{sname}_{name}"] = {"shape": dict(zip(
                ("B", "S", "H", "Hk", "D"), shape)), "held": held,
                "repeats_bit_identical": repeats,
                "errors": errs, "controls": controls, "timing": timing}
            del c, q, k, v, do, out, lse, ref, lse_ref, delta
            del lib_fwd, lib_bwd, lib_out
            torch.cuda.empty_cache()
    state["flash"] = cases
    emit({"phase": "flash", "ok": ok, "causal": True,
          "tolerance": {"out": TOLERANCE, "lse_abs": LSE_ABS,
                        "grads": {k: {"max_rel": t["token_rel"],
                                      "l2_rel": t["l2_rel"]}
                                  for k, t in TOLERANCE.items()}},
          "cases": cases,
          "bound_peaks": {"bytes_per_s": PEAK_BYTES,
                          "flops_per_s": PEAK_FLOPS}})
    return ok


# ---------------------------------------------------------------------------
# training phases: the train step (build_train_step) at the bench's 350M
# GQA LLaMA widths
# ---------------------------------------------------------------------------

# bench.py's configuration: vocab 32000, hidden 1024, ffn 2816, 16 heads,
# 4 kv heads (D = 64), 24 layers; batch 2 x seq 2048; AdamW lr 1e-3, betas
# (0.9, 0.95), clip 1.0
TRAIN_DIMS = dict(vocab_size=32000, hidden_size=1024, intermediate_size=2816,
                  num_attention_heads=16, num_key_value_heads=4,
                  max_position_embeddings=2048)
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ = 24, 2, 2048
TRAIN_STEPS = 20
# train_f32: f32 on both sides, the kernels' attention within ~1e-6 of the
# plain version's (flash phase): losses of three steps to rtol 1e-4 (Adam
# moves the few parameters whose gradient is zero up to rounding by up to
# 2 lr), the first step's gradients to ||g - g_plain|| / ||g_plain|| <=
# 1e-4 per leaf
TRAIN_F32_TOL = {"loss_rtol": 1e-4, "grad_l2_rel": 1e-4}


def train_config(layers):
    from paddle_tpu_torch.models.llama import LlamaConfig
    return LlamaConfig(num_hidden_layers=layers, **TRAIN_DIMS)


def train_tokens(cfg, n, seed):
    """n token batches [TRAIN_BATCH, TRAIN_SEQ] from a numpy seed."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                          (TRAIN_BATCH, TRAIN_SEQ))).to(DEV)
            for _ in range(n)]


def flash_counts() -> dict:
    from paddle_tpu_torch.ops import flash_attention as fa
    return {"fwd": fa.fwd_launch_count, "dkdv": fa.dkdv_launch_count,
            "dq": fa.dq_launch_count}


def reset_flash_counts() -> None:
    from paddle_tpu_torch.ops import flash_attention as fa
    fa.fwd_launch_count = fa.dkdv_launch_count = fa.dq_launch_count = 0


class flash_patched:
    """Within the block, the attention Function's forward and backward are
    ``fwd`` and ``bwd`` in place of the device dispatch (the plain
    versions, or the gate's held pair)."""

    def __init__(self, fwd, bwd):
        self.fns = (fwd, bwd)

    def __enter__(self):
        from paddle_tpu_torch.ops import flash_attention as fa
        self.saved = (fa._forward, fa._backward)
        fa._forward, fa._backward = self.fns

    def __exit__(self, *exc):
        from paddle_tpu_torch.ops import flash_attention as fa
        fa._forward, fa._backward = self.saved


def plain_flash():
    from paddle_tpu_torch.ops import flash_attention as fa
    return flash_patched(fa.flash_fwd_reference, fa.flash_bwd_reference)


def phase_train_f32(state):
    """The bench's widths at 2 of 24 layers in f32 (cut so that the f32
    plain attention's scores and the f32 Adam state stay small): three
    steps on the kernels against three on the plain versions, from the
    same seeded parameters and tokens."""
    import torch
    from paddle_tpu_torch.parallel import transformer as pt
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = train_config(2)
    hp = pt.HybridParallelConfig(dtype=torch.float32, remat=False, lr=1e-3,
                                 betas=(0.9, 0.95), grad_clip_norm=1.0)
    tokens = train_tokens(cfg, 3, SEED + 7)
    runs = {}
    for mode in ("plain", "kernels"):
        params = pt.init_params(cfg, hp, seed=SEED, device=DEV)
        opt = pt.init_opt_state(params)
        step = pt.build_train_step(cfg, hp, device=DEV)
        reset_flash_counts()
        with plain_flash() if mode == "plain" else \
                contextlib.nullcontext():
            _, grads = pt.loss_and_grads(params, tokens[0], cfg, hp)
            losses = [float(step(params, opt, t)[2]) for t in tokens]
        runs[mode] = {"losses": losses, "grads": grads,
                      "launches": flash_counts()}
        del params, opt
    g_rel = {n: float((g.float() - gp.float()).norm()
                      / gp.float().norm().clamp_min(1e-30))
             for (n, g), (_, gp) in zip(pt._leaves(runs["kernels"]["grads"]),
                                        pt._leaves(runs["plain"]["grads"]))}
    kl, pl_ = runs["kernels"]["losses"], runs["plain"]["losses"]
    L = cfg.num_hidden_layers
    want = {k: L * (1 + len(tokens)) for k in ("fwd", "dkdv", "dq")}
    checks = {
        "losses_finite": all(map(math.isfinite, kl)),
        "losses_match_plain": all(
            abs(a - b) <= TRAIN_F32_TOL["loss_rtol"] * abs(b)
            for a, b in zip(kl, pl_)),
        "grads_match_plain": max(g_rel.values())
        <= TRAIN_F32_TOL["grad_l2_rel"],
        "launches_equal_layers_x_passes":
            runs["kernels"]["launches"] == want,
        "plain_run_launched_nothing": runs["plain"]["launches"] == {
            "fwd": 0, "dkdv": 0, "dq": 0}}
    rec = {"phase": "train_f32", "ok": all(checks.values()),
           "checks": checks, "layers": L, "tolerance": TRAIN_F32_TOL,
           "losses_kernels": kl, "losses_plain": pl_,
           "grad_l2_rel_by_leaf": g_rel,
           "launches": runs["kernels"]["launches"], "expected": want}
    emit(rec)
    state["train_f32"] = rec
    del runs
    torch.cuda.empty_cache()
    return rec["ok"]


def held_flash(log, keep_kernels=False):
    """The gate's attention: at every call the plain versions run and the
    kernels are launched beside them on the same inputs, their errors
    logged; the step goes on with the plain versions' results (with
    ``keep_kernels``, the kernels', so the step is the main path's and
    the launch counters count it).  Each call also logs two controls that
    must fail: the forward's output 1% too large, and the dQ kernel fed
    lse + log 2 (a launch the counters do not keep)."""
    from paddle_tpu_torch.ops import flash_attention as fa

    def fwd(q, k, v, causal):
        ref, lse_ref = fa.flash_fwd_reference(q, k, v, causal)
        out, lse = fa._launch_fwd(q, k, v, causal)
        log["fwd"].append(dict(errors(rows(out), rows(ref)),
                               lse_abs=float((lse - lse_ref).abs().max())))
        log["ctl_out_1pct"].append(errors(rows(out * 1.01), rows(ref)))
        return (out, lse) if keep_kernels else (ref, lse_ref)

    def bwd(q, k, v, out, lse, do, causal):
        delta = fa.attention_delta(out, do)
        dk_r, dv_r = fa.flash_bwd_dkdv_reference(q, k, v, do, lse, delta,
                                                 causal)
        dq_r = fa.flash_bwd_dq_reference(q, k, v, do, lse, delta, causal)
        dk, dv = fa._launch_dkdv(q, k, v, do, lse, delta, causal)
        dq = fa._launch_dq(q, k, v, do, lse, delta, causal)
        log["dkdv"].append({"dk": grad_errors(dk, dk_r),
                            "dv": grad_errors(dv, dv_r)})
        log["dq"].append(grad_errors(dq, dq_r))
        n = fa.dq_launch_count
        log["ctl_lse_log2"].append(grad_errors(fa._launch_dq(
            q, k, v, do, lse + math.log(2.0), delta, causal), dq_r))
        fa.dq_launch_count = n
        return (dq, dk, dv) if keep_kernels else (dq_r, dk_r, dv_r)
    return fwd, bwd


def flash_gate(log, calls):
    """The gate record of a held run and its checks: every kernel held
    ``calls`` times, each within the bf16 tolerance of its plain version,
    every control failing."""
    fwd_err = worst(log["fwd"])
    dk_err = worst([e["dk"] for e in log["dkdv"]])
    dv_err = worst([e["dv"] for e in log["dkdv"]])
    dq_err = worst(log["dq"])
    ctl_out = [not within(e, "bfloat16", ENGINE_MEASURES)
               for e in log["ctl_out_1pct"]]
    ctl_lse = [not grad_within(e, "bfloat16") for e in log["ctl_lse_log2"]]
    gate = {"calls": {k: len(log[k]) for k in ("fwd", "dkdv", "dq")},
            "fwd": fwd_err, "dk": dk_err, "dv": dv_err, "dq": dq_err,
            "controls_failing": {
                "out_1pct": f"{sum(ctl_out)}/{len(ctl_out)}",
                "dq_lse_plus_log2": f"{sum(ctl_lse)}/{len(ctl_lse)}"}}
    checks = {
        "gate_held_every_call": gate["calls"] == {
            k: calls for k in ("fwd", "dkdv", "dq")},
        "gate_fwd_vs_plain": within(fwd_err, "bfloat16", ENGINE_MEASURES)
        and fwd_err["lse_abs"] <= LSE_ABS,
        "gate_dkdv_vs_plain": grad_within(dk_err, "bfloat16")
        and grad_within(dv_err, "bfloat16"),
        "gate_dq_vs_plain": grad_within(dq_err, "bfloat16"),
        "gate_controls_fail": all(ctl_out) and all(ctl_lse)}
    return gate, checks


# cuBLAS's kernel names hold one of these (CUDA 12.8's bf16 GEMMs: nvjet)
GEMM_NAMES = ("gemm", "nvjet", "xmma", "cutlass")
# every kernel of csrc/flash_attention.cu, by the launch it serves (bf16 D
# 64/128: wgmma; f32 and bf16 D 256: CUDA-core; D > 256: chunked)
FLASH_KERNEL_NAMES = {
    "fwd": ("flash_fwd_wgmma_kernel", "flash_fwd_kernel",
            "flash_fwd_chunked_kernel"),
    "dkdv": ("flash_bwd_dkdv_wgmma_kernel", "flash_bwd_dkdv_kernel",
             "flash_bwd_dkdv_chunked_kernel"),
    "dq": ("flash_bwd_dq_wgmma_kernel", "flash_bwd_dq_kernel",
           "flash_bwd_dq_chunked_kernel")}


def flash_kernel(key: str):
    """The launch ("fwd", "dkdv", "dq") a profiled kernel name serves, or
    None: the name must hold one of FLASH_KERNEL_NAMES as a whole word."""
    for kern, names in FLASH_KERNEL_NAMES.items():
        if named(key, names):
            return kern
    return None


def profile_train_step(step, params, opt, batch, step_ms):
    """Device time of one train step by kernel under torch.profiler; the
    idle share divides the kernels' sum by the unprofiled step time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(params, opt, batch)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")]
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    flash_split = {kern: sum(dev_us(e) for e in kernels
                             if flash_kernel(e.key) == kern) / 1e3
                   for kern in FLASH_KERNEL_NAMES}
    flash_calls = {kern: sum(e.count for e in kernels
                             if flash_kernel(e.key) == kern)
                   for kern in FLASH_KERNEL_NAMES}
    gemm_ms = sum(dev_us(e) for e in kernels if flash_kernel(e.key) is None
                  and any(w in e.key.lower() for w in GEMM_NAMES)) / 1e3
    top = sorted(kernels, key=dev_us, reverse=True)[:12]
    return {"device_busy_ms": busy_ms,
            "device_idle_share": (1 - busy_ms / step_ms) if busy_ms
            else "not measured",
            "flash_kernels_ms": sum(flash_split.values()),
            "flash_kernels_ms_by_launch": flash_split,
            "flash_launches": flash_calls,
            "flash_ms_per_launch": {
                kern: flash_split[kern] / n if n else "not measured"
                for kern, n in flash_calls.items()},
            "gemm_ms": gemm_ms,
            "kernel_launches": sum(e.count for e in kernels),
            "top_kernels": [{"name": e.key[:90], "ms": dev_us(e) / 1e3,
                             "calls": e.count} for e in top]}


def phase_train_bf16(state):
    """The bench configuration, all 24 layers in bf16 (remat off, as the
    bench runs it).  A gate run of TRAIN_STEPS steps takes the plain
    attention and launches the three kernels beside every call, holding
    each launch to the plain version on the step's own activations
    (controls must fail that hold); its losses are the plain attention's
    trajectory.  Then the main path: TRAIN_STEPS steps on the kernels
    alone from the same parameters on the same fixed batch (the loss must
    stay finite and fall; each kernel's launches must be layers x steps),
    timed, with one profiled step; then 2 steps with remat, where the
    forward runs twice a layer."""
    import dataclasses
    import statistics as st
    import torch
    from paddle_tpu_torch.parallel import transformer as pt
    cfg = train_config(TRAIN_LAYERS)
    hp = pt.HybridParallelConfig(dtype=torch.bfloat16, remat=False, lr=1e-3,
                                 betas=(0.9, 0.95), grad_clip_norm=1.0)
    N = pt.param_count(cfg)
    L = cfg.num_hidden_layers
    batch = train_tokens(cfg, 1, SEED + 8)[0]
    step = pt.build_train_step(cfg, hp, device=DEV)

    # gate: the plain attention, each kernel launch held beside it
    log = {k: [] for k in ("fwd", "dkdv", "dq", "ctl_out_1pct",
                           "ctl_lse_log2")}
    params = pt.init_params(cfg, hp, seed=SEED, device=DEV)
    opt = pt.init_opt_state(params)
    with flash_patched(*held_flash(log)):
        gate_losses = [float(step(params, opt, batch)[2])
                       for _ in range(TRAIN_STEPS)]
    del params, opt
    torch.cuda.empty_cache()
    fwd_err = worst(log["fwd"])
    dk_err = worst([e["dk"] for e in log["dkdv"]])
    dv_err = worst([e["dv"] for e in log["dkdv"]])
    dq_err = worst(log["dq"])
    ctl_out = [not within(e, "bfloat16", ENGINE_MEASURES)
               for e in log["ctl_out_1pct"]]
    ctl_lse = [not grad_within(e, "bfloat16") for e in log["ctl_lse_log2"]]
    gate = {"calls": {k: len(log[k]) for k in ("fwd", "dkdv", "dq")},
            "losses": gate_losses, "fwd": fwd_err, "dk": dk_err,
            "dv": dv_err, "dq": dq_err,
            "controls_failing": {"out_1pct": f"{sum(ctl_out)}/{len(ctl_out)}",
                                 "dq_lse_plus_log2":
                                     f"{sum(ctl_lse)}/{len(ctl_lse)}"}}

    # the main path: the kernels alone, one fixed batch
    params = pt.init_params(cfg, hp, seed=SEED, device=DEV)
    opt = pt.init_opt_state(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_flash_counts()
    losses, times = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        _, _, loss = step(params, opt, batch)
        losses.append(float(loss))          # waits for the step
        times.append((time.perf_counter() - t0) * 1e3)
    launches = flash_counts()
    peak = torch.cuda.max_memory_allocated()
    step_ms = st.median(times[1:])
    tokens_per_s = TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3)
    profile = profile_train_step(step, params, opt, batch, step_ms)
    # the cost of f32 logits: the head product with an f32 result (the
    # JAX einsum's preferred_element_type) against one rounded to bf16
    h = torch.randn((TRAIN_BATCH * TRAIN_SEQ, cfg.hidden_size), device=DEV,
                    generator=torch.Generator(device=DEV).manual_seed(SEED))
    h = h.to(torch.bfloat16)
    logits_ms = {"f32_out": time_ms(lambda: pt._mm_f32(h, params["head"])),
                 "bf16_out": time_ms(lambda: h @ params["head"])}
    del h

    # remat: the forward kernel runs again inside each block's backward
    hp_r = dataclasses.replace(hp, remat=True)
    step_r = pt.build_train_step(cfg, hp_r, device=DEV)
    reset_flash_counts()
    remat_losses = [float(step_r(params, opt, batch)[2]) for _ in range(2)]
    remat_launches = flash_counts()
    del params, opt
    torch.cuda.empty_cache()

    want = {k: L * TRAIN_STEPS for k in ("fwd", "dkdv", "dq")}
    want_r = {"fwd": 2 * L * 2, "dkdv": L * 2, "dq": L * 2}
    checks = {
        "gate_held_every_call": gate["calls"] == {
            k: TRAIN_STEPS * L for k in ("fwd", "dkdv", "dq")},
        "gate_fwd_vs_plain": within(fwd_err, "bfloat16", ENGINE_MEASURES)
        and fwd_err["lse_abs"] <= LSE_ABS,
        "gate_dkdv_vs_plain": grad_within(dk_err, "bfloat16")
        and grad_within(dv_err, "bfloat16"),
        "gate_dq_vs_plain": grad_within(dq_err, "bfloat16"),
        "gate_controls_fail": all(ctl_out) and all(ctl_lse),
        "losses_finite": all(map(math.isfinite, losses + remat_losses)),
        "loss_falls": losses[-1] < losses[0],
        "launches_equal_layers_x_steps": launches == want,
        "remat_launches": remat_launches == want_r}
    rec = {"phase": "train_bf16", "ok": all(checks.values()),
           "checks": checks, "layers": L, "params": N,
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": TRAIN_STEPS,
           "gate": gate, "gate_tolerance": {
               "out": {k: TOLERANCE["bfloat16"][k] for k in ENGINE_MEASURES},
               "lse_abs": LSE_ABS,
               "grads": {"max_rel": TOLERANCE["bfloat16"]["token_rel"],
                         "l2_rel": TOLERANCE["bfloat16"]["l2_rel"]}},
           "losses": losses, "step_ms": times, "step_ms_p50": step_ms,
           "first_step_ms": times[0], "tokens_per_s": tokens_per_s,
           "mfu": 6 * N * tokens_per_s / PEAK_FLOPS["bfloat16"],
           "mfu_formula": "6 * params * tokens/s / 989e12",
           "peak_memory_bytes": peak, "launches": launches,
           "expected_launches": want, "remat_losses": remat_losses,
           "remat_launches": remat_launches,
           "remat_expected_launches": want_r, "profile": profile,
           "logits_product_ms": logits_ms}
    emit(rec)
    state["train_bf16"] = rec
    return rec["ok"]


# ---------------------------------------------------------------------------
# train_hybrid_bf16: the hybrid trainer's per-rank step at world 1, every
# axis a real NCCL group of size 1
# ---------------------------------------------------------------------------

# (a) the mesh step against the single-card step, both on the kernels:
# the losses to rtol 2e-3, the parameters after step 1 within 2 lr (Adam
# moves a parameter whose gradient is zero up to rounding by up to 2 lr);
# the 1F1B driver against the GPipe driver: the loss to rtol 2e-3, each
# leaf's gradient to ||d|| / ||gpipe|| <= 2^-8 (the same microbatch
# gradients, summed in f32 against in bf16: one bf16 rounding apart);
# (b) remat "attn" against "full": the losses to rtol 2e-3; (d) MoE in f32
# on the card against the CPU: the loss to rtol 1e-4, each leaf's
# first-step gradient to ||g - g_cpu|| / ||g_cpu|| <= 1e-4
HYBRID_TOL = {"loss_rtol_bf16": 2e-3, "param_atol_lr": 2.0,
              "grad_l2_rel_1f1b_bf16": 2.0 ** -8,
              "loss_rtol_f32": 1e-4, "grad_l2_rel_f32": 1e-4}
HYBRID_M, HYBRID_STEPS, HYBRID_TIMED = 2, 3, 8
# (a) and (b) run 8 of the bench's 24 layers, so that the whole run,
# launch_train_bf16 included, stays inside its limit
HYBRID_LAYERS = 8
MOE_LAYERS, MOE_EXPERTS, MOE_STEPS = 8, 8, 10


def hybrid_mesh(hp, device):
    """A world-1 mesh: NCCL groups on a card, gloo on the CPU."""
    import torch
    from paddle_tpu_torch.parallel import transformer as pt
    cuda = torch.device(device).type == "cuda"
    return pt.build_mesh(hp, rank=0, world_size=1,
                         backend="nccl" if cuda else "gloo", device=device)


def timed_steps(step, params, opt, batch, n):
    """n steps; each step's ms (the loss read back ends it) and losses."""
    times, losses = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        losses.append(float(step(params, opt, batch)[2]))
        times.append((time.perf_counter() - t0) * 1e3)
    return times, losses


def collective_cost(mesh, x) -> dict:
    """Each sequence-parallel collective of the block on x [m, S, H] over
    the tp group: the host's time to return from one call (the mean of
    100 calls in a row), the same behind a spin kernel of SPIN_CYCLES
    (long only if the call waits for the card on the host) and its card
    time (``time_ms``)."""
    import torch
    from paddle_tpu_torch.parallel import collectives as C
    g = mesh.group("tp")
    out = {}
    for name, fn in (("all_gather", lambda: C._all_gather(x, g, 1)),
                     ("psum_scatter", lambda: C._psum_scatter(x, g, 1)),
                     ("psum", lambda: C._psum(x, g))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(100):
            fn()
        host_us = (time.perf_counter() - t0) / 100 * 1e6
        torch.cuda.synchronize()
        # behind a spin kernel: a call that waits for the card on the host
        # returns only after the spin
        torch.cuda._sleep(SPIN_CYCLES)
        t0 = time.perf_counter()
        fn()
        behind_us = (time.perf_counter() - t0) * 1e6
        torch.cuda.synchronize()
        out[name] = {"host_us": host_us, "host_us_behind_spin": behind_us,
                     "ms": time_ms(fn)}
    return out


def driver_grads(driver, init, tokens, cfg, hp, mesh) -> dict:
    """One pipeline driver's loss and gradients on the world-1 mesh from
    the full tree ``init`` (left as it is), tokens [M, m, S]: with its
    flash launches (counted from 0) and its wall ms."""
    import torch
    from paddle_tpu_torch.parallel import transformer as pt
    leaves = pt._leaves(init)
    live = [t.detach().requires_grad_(True) for _, t in leaves]
    ptree = pt._tree((n, t) for (n, _), t in zip(leaves, live))
    torch.cuda.synchronize()
    reset_flash_counts()
    t0 = time.perf_counter()
    loss, g = driver(ptree, live, tokens, cfg, hp, mesh)
    torch.cuda.synchronize()
    return {"loss": float(loss) / hp.num_microbatches,
            "grads": {n: x for (n, _), x in zip(leaves, g)},
            "launches": flash_counts(),
            "ms": (time.perf_counter() - t0) * 1e3}


def hybrid_moe_grads(cfg, hp, device, tokens, init):
    """Loss and reduced first-step gradients of the world-1 mesh step on
    ``device`` from the parameters ``init`` (CPU f32 tensors)."""
    from paddle_tpu_torch.parallel import transformer as pt
    mesh = hybrid_mesh(hp, device)
    try:
        params = pt.shard_params(init, hp, mesh)
        toks = tokens.to(device).reshape(hp.num_microbatches, -1,
                                         tokens.shape[1])
        loss, g = pt._sharded_loss_and_grads(params, toks, cfg, hp, mesh)
        names = [n for n, _ in pt._leaves(params)]
        zd = dict(pt._leaves(pt.zero_dims(hp, pt._shapes(cfg))))
        g = pt._reduce_grads(g, names, hp, mesh, zd)
        return float(loss), {n: x.float().cpu() for n, x in zip(names, g)}
    finally:
        mesh.close()


def phase_train_hybrid_bf16(state):
    """The hybrid trainer's per-rank step at world 1 over NCCL groups of
    size 1 (every collective of the world-N path runs), at the bench's
    350M widths in bf16, batch 2 x 2,048 as 2 microbatches of 1.
    (a) 8 of 24 layers, 2 microbatches: a gate run holding every flash launch
    to its plain version (controls must fail), then the main path on the
    kernels (counts from 0: each kernel L x M a step) against the
    single-card step from the same parameters, and both timed.  The step
    is built with pp_schedule "1f1b" and zero_stage 1, but a pipeline of
    one stage takes the GPipe driver and ZeRO at dp 1 shards nothing, as
    in the reference; so (a) also runs the 1F1B driver itself (its no-grad
    forward, the recompute from the saved stage input, the f32 sums)
    against the GPipe driver on the same parameters and batch: the loss
    and each leaf's gradient, and the forward launched 2 L M times against
    L M.  ZeRO's reduce-scatter and all-gather run at dp > 1 only
    (tests/test_torch_hybrid_nccl.py, four cards).  (b) remat
    "attn" against "full": equal losses, the forward launched L x M a
    step under "attn" and L x M more under "full".  (c) MoE, 8 experts
    top 2 at 8 of 24 layers: 10 steps on one batch, the loss falls.  (d)
    MoE in f32 at 2 layers, 1 x 512 tokens: the card's loss and
    first-step gradients against the same step on the CPU (gloo, the
    plain attention)."""
    import dataclasses
    import statistics as st
    import torch
    from paddle_tpu_torch.parallel import transformer as pt
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = train_config(HYBRID_LAYERS)
    L, M = cfg.num_hidden_layers, HYBRID_M
    hp = pt.HybridParallelConfig(
        dtype=torch.bfloat16, remat=False, lr=1e-3, betas=(0.9, 0.95),
        grad_clip_norm=1.0, num_microbatches=M, pp_schedule="1f1b",
        zero_stage=1)
    batch = train_tokens(cfg, 1, SEED + 9)[0]
    mesh = hybrid_mesh(hp, DEV)
    rec = {"phase": "train_hybrid_bf16", "layers": L, "microbatches": M,
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "tolerance": HYBRID_TOL,
           "groups": {a: [mesh.group(a).size(), type(mesh.group(a)).__name__]
                      for a in pt.AXES}, "card": nvidia_smi()}
    checks = {}
    try:
        step = pt.build_train_step(cfg, hp, mesh)
        single = pt.build_train_step(cfg, dataclasses.replace(
            hp, zero_stage=0), device=DEV)

        # (a) gate: the plain attention, each kernel launch held beside it
        log = {k: [] for k in ("fwd", "dkdv", "dq", "ctl_out_1pct",
                               "ctl_lse_log2")}
        params = pt.shard_params(pt.init_params(cfg, hp, seed=SEED,
                                                device=DEV), hp, mesh)
        opt = pt.init_opt_state(params, hp, mesh)
        with flash_patched(*held_flash(log)):
            gate_losses = [float(step(params, opt, batch)[2])
                           for _ in range(2)]
        del params, opt
        rec["gate"], gate_checks = flash_gate(log, 2 * L * M)
        rec["gate"]["losses"] = gate_losses
        checks.update(gate_checks)

        # (a) the main path on the kernels against the single-card step
        init = pt.init_params(cfg, hp, seed=SEED, device=DEV)
        params = pt.shard_params(init, hp, mesh)
        opt = pt.init_opt_state(params, hp, mesh)
        p1 = pt.shard_params(init, dataclasses.replace(hp, zero_stage=0),
                             mesh)       # world 1: a copy of the whole tree
        o1 = pt.init_opt_state(p1)
        torch.cuda.synchronize()
        reset_flash_counts()
        mesh_losses = [float(step(params, opt, batch)[2])]
        after1 = dict(pt._leaves(pt.to_numpy(params)))
        mesh_losses += [float(step(params, opt, batch)[2])
                        for _ in range(HYBRID_STEPS - 1)]
        launches = flash_counts()
        single_losses = [float(single(p1, o1, batch)[2])]
        single1 = dict(pt._leaves(pt.to_numpy(p1)))
        single_losses += [float(single(p1, o1, batch)[2])
                          for _ in range(HYBRID_STEPS - 1)]
        param_diff = max(float(abs(after1[n] - single1[n]).max())
                         for n in after1)
        want = {k: L * M * HYBRID_STEPS for k in ("fwd", "dkdv", "dq")}
        # both steps timed, in turns, on the same card
        t_single, _ = timed_steps(single, p1, o1, batch, HYBRID_TIMED)
        t_mesh, _ = timed_steps(step, params, opt, batch, HYBRID_TIMED)
        t_single2, _ = timed_steps(single, p1, o1, batch, HYBRID_TIMED)
        t_mesh2, _ = timed_steps(step, params, opt, batch, HYBRID_TIMED)
        mesh_ms = st.median(t_mesh[1:] + t_mesh2[1:])
        single_ms = st.median(t_single[1:] + t_single2[1:])
        profiles = {
            "mesh": profile_train_step(step, params, opt, batch, mesh_ms),
            "single": profile_train_step(single, p1, o1, batch, single_ms)}
        cost = collective_cost(mesh, torch.randn(
            (1, TRAIN_SEQ, cfg.hidden_size), device=DEV,
            generator=torch.Generator(device=DEV).manual_seed(SEED)).to(
                torch.bfloat16))
        del params, opt, p1, o1
        torch.cuda.empty_cache()

        # (a) the 1F1B driver against the GPipe driver, one step's
        # gradients from the initial parameters
        toks = batch.reshape(M, -1, batch.shape[1])
        drv = {name: driver_grads(fn, init, toks, cfg, hp, mesh)
               for name, fn in (("gpipe", pt._grads_gpipe),
                                ("1f1b", pt._grads_1f1b))}
        del init
        g_rel = {n: float((drv["1f1b"]["grads"][n].float()
                           - g.float()).norm()
                          / g.float().norm().clamp_min(1e-30))
                 for n, g in drv["gpipe"]["grads"].items()}
        one_f1b_gap = abs(drv["1f1b"]["loss"] - drv["gpipe"]["loss"]) \
            / abs(drv["gpipe"]["loss"])
        rec["drivers"] = {
            name: {"loss": d["loss"], "launches": d["launches"],
                   "ms_one_call": d["ms"]} for name, d in drv.items()}
        rec["drivers"]["loss_rel_gap"] = one_f1b_gap
        rec["drivers"]["grad_l2_rel_by_leaf"] = g_rel
        del drv
        torch.cuda.empty_cache()
        checks["1f1b_loss_matches_gpipe"] = \
            one_f1b_gap <= HYBRID_TOL["loss_rtol_bf16"]
        checks["1f1b_grads_match_gpipe"] = \
            max(g_rel.values()) <= HYBRID_TOL["grad_l2_rel_1f1b_bf16"]
        lm = L * M
        checks["1f1b_forward_twice_gpipe_once"] = \
            rec["drivers"]["1f1b"]["launches"] == {
                "fwd": 2 * lm, "dkdv": lm, "dq": lm} and \
            rec["drivers"]["gpipe"]["launches"] == {
                "fwd": lm, "dkdv": lm, "dq": lm}
        loss_gap = max(abs(a - b) / abs(b)
                       for a, b in zip(mesh_losses, single_losses))
        rec["dense"] = {
            "mesh_losses": mesh_losses, "single_losses": single_losses,
            "loss_rel_gap_max": loss_gap,
            "param_max_abs_diff_step1": param_diff,
            "launches": launches, "expected_launches": want,
            "mesh_step_ms": t_mesh + t_mesh2,
            "single_step_ms": t_single + t_single2,
            "mesh_step_ms_p50": mesh_ms, "single_step_ms_p50": single_ms,
            "profile": profiles, "collective_cost": cost,
            "train_bf16_step_ms_p50": state.get("train_bf16", {}).get(
                "step_ms_p50")}
        checks["mesh_losses_match_single"] = \
            loss_gap <= HYBRID_TOL["loss_rtol_bf16"]
        checks["mesh_params_match_single"] = \
            param_diff <= HYBRID_TOL["param_atol_lr"] * hp.lr
        checks["mesh_launches_equal_layers_x_microbatches"] = \
            launches == want

        # (b) remat "attn" against "full"
        remat = {}
        for policy in ("attn", "full"):
            hp_r = dataclasses.replace(hp, remat=True, remat_policy=policy)
            step_r = pt.build_train_step(cfg, hp_r, mesh)
            params = pt.shard_params(pt.init_params(cfg, hp, seed=SEED,
                                                    device=DEV), hp_r, mesh)
            opt = pt.init_opt_state(params, hp_r, mesh)
            reset_flash_counts()
            losses = [float(step_r(params, opt, batch)[2])
                      for _ in range(2)]
            counts = flash_counts()
            times, _ = timed_steps(step_r, params, opt, batch, 6)
            remat[policy] = {"losses": losses, "launches_2_steps": counts,
                             "step_ms": times,
                             "step_ms_p50": st.median(times[1:])}
            del params, opt
            torch.cuda.empty_cache()
        rec["remat"] = remat
        checks["remat_losses_equal"] = all(
            abs(a - b) <= HYBRID_TOL["loss_rtol_bf16"] * abs(b)
            for a, b in zip(remat["attn"]["losses"],
                            remat["full"]["losses"]))
        lm2 = 2 * L * M
        checks["remat_attn_forward_once"] = \
            remat["attn"]["launches_2_steps"] == {
                "fwd": lm2, "dkdv": lm2, "dq": lm2}
        checks["remat_full_forward_twice"] = \
            remat["full"]["launches_2_steps"] == {
                "fwd": 2 * lm2, "dkdv": lm2, "dq": lm2}
    finally:
        mesh.close()

    # (c) MoE with local experts, bf16, one fixed batch
    cfg_m = dataclasses.replace(train_config(MOE_LAYERS),
                                moe_experts=MOE_EXPERTS, moe_top_k=2,
                                moe_capacity_factor=2.0)
    hp_m = dataclasses.replace(hp, zero_stage=0)
    mesh = hybrid_mesh(hp_m, DEV)
    try:
        step = pt.build_train_step(cfg_m, hp_m, mesh)
        params = pt.shard_params(pt.init_params(cfg_m, hp_m, seed=SEED,
                                                device=DEV), hp_m, mesh)
        opt = pt.init_opt_state(params, hp_m, mesh)
        reset_flash_counts()
        times, losses = timed_steps(step, params, opt, batch, MOE_STEPS)
        rec["moe_bf16"] = {
            "layers": MOE_LAYERS, "experts": MOE_EXPERTS, "top_k": 2,
            "capacity_factor": 2.0, "params": pt.param_count(cfg_m),
            "losses": losses, "step_ms": times,
            "step_ms_p50": st.median(times[1:]),
            "launches": flash_counts()}
        checks["moe_losses_finite"] = all(map(math.isfinite, losses))
        checks["moe_loss_falls"] = losses[-1] < losses[0]
        del params, opt
        torch.cuda.empty_cache()
    finally:
        mesh.close()

    # (d) MoE in f32: the card against the CPU
    cfg_f = dataclasses.replace(cfg_m, num_hidden_layers=2)
    hp_f = dataclasses.replace(hp_m, dtype=torch.float32, num_microbatches=1)
    toks = train_tokens(cfg_f, 1, SEED + 10)[0][:1, :512].cpu()
    init = pt.init_params(cfg_f, hp_f, seed=SEED, device="cpu")
    loss_gpu, g_gpu = hybrid_moe_grads(cfg_f, hp_f, DEV, toks, init)
    loss_cpu, g_cpu = hybrid_moe_grads(cfg_f, hp_f, "cpu", toks, init)
    g_rel = {n: float((g_gpu[n] - g_cpu[n]).norm()
                      / g_cpu[n].norm().clamp_min(1e-30)) for n in g_cpu}
    rec["moe_f32_vs_cpu"] = {"loss_card": loss_gpu, "loss_cpu": loss_cpu,
                             "grad_l2_rel_by_leaf": g_rel}
    checks["moe_f32_loss_matches_cpu"] = \
        abs(loss_gpu - loss_cpu) <= HYBRID_TOL["loss_rtol_f32"] * abs(loss_cpu)
    checks["moe_f32_grads_match_cpu"] = \
        max(g_rel.values()) <= HYBRID_TOL["grad_l2_rel_f32"]

    rec["checks"] = checks
    rec["ok"] = all(checks.values())
    emit(rec)
    state["train_hybrid_bf16"] = rec
    torch.cuda.empty_cache()
    return rec["ok"]


# ---------------------------------------------------------------------------
# launch_train_bf16: the hybrid trainer started by the port's launcher
# ---------------------------------------------------------------------------

LAUNCH_TIMEOUT_S = 300
LAUNCH_STEPS = 3
BUCKET_BYTES = 25 * 2 ** 20            # DataParallel's default bucket
ALL_REDUCE_CALLS = 100


def launch_config():
    """LLaMA-7B's published widths at CUT_LAYERS of its 32 layers, and
    train_hybrid_bf16's step: bf16, 2 microbatches of 1 x 2,048, 1F1B and
    ZeRO-1 (GPipe and no sharding at world 1, as in the reference)."""
    import dataclasses
    import torch
    from paddle_tpu_torch.models.llama import LlamaConfig
    from paddle_tpu_torch.parallel import transformer as pt
    cfg = dataclasses.replace(LlamaConfig.llama_7b(),
                              num_hidden_layers=CUT_LAYERS)
    hp = pt.HybridParallelConfig(
        dtype=torch.bfloat16, remat=False, lr=1e-3, betas=(0.9, 0.95),
        grad_clip_norm=1.0, num_microbatches=HYBRID_M, pp_schedule="1f1b",
        zero_stage=1)
    return cfg, hp, train_tokens(cfg, 1, SEED + 11)[0]


def launch_steps(step, params, opt, batch):
    """LAUNCH_STEPS steps: the losses and a checksum of the parameters
    after them (the f64 sum of every leaf's f32 values)."""
    from paddle_tpu_torch.parallel import transformer as pt
    losses = [float(step(params, opt, batch)[2])
              for _ in range(LAUNCH_STEPS)]
    return losses, float(sum(t.double().sum() for _, t in pt._leaves(params)))


def world1_collectives() -> dict:
    """Every collective of paddle_tpu_torch.distributed on CUDA tensors at
    world 1: each result equal, bit for bit, to what the reference's
    world-1 path gives (its input, or the list of it)."""
    import torch
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import collective as C
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    x = torch.randn((4, 1024), device=DEV, generator=gen)
    y = torch.randn((4, 1024), device=DEV, generator=gen)

    def same(a, b):
        return a.is_cuda and bool(torch.equal(a, b))
    checks = {}
    for op in ("SUM", "AVG", "MAX", "MIN", "PROD"):
        t = x.clone()
        dist.all_reduce(t, getattr(dist.ReduceOp, op))
        checks[f"all_reduce_{op}"] = same(t, x)
    t = x.clone()
    task = dist.all_reduce(t, sync_op=False)
    checks["all_reduce_task"] = task.wait() is t and task.is_completed() \
        and same(t, x)
    outs = []
    dist.all_gather(outs, x)
    checks["all_gather"] = len(outs) == 1 and same(outs[0], x)
    checks["all_gather_stacked"] = same(dist.all_gather(None, x), x)
    objs = []
    dist.all_gather_object(objs, {"rank": 0, "x": [1, 2]})
    checks["all_gather_object"] = objs == [{"rank": 0, "x": [1, 2]}]
    for name, fn in (("broadcast", lambda t: dist.broadcast(t, src=0)),
                     ("reduce", lambda t: dist.reduce(t, dst=0))):
        t = x.clone()
        fn(t)
        checks[name] = same(t, x)
    t = torch.zeros_like(x)
    dist.scatter(t, [y], src=0)
    checks["scatter"] = same(t, y)
    t = torch.zeros_like(x)
    dist.reduce_scatter(t, [y])
    checks["reduce_scatter"] = same(t, y)
    outs = []
    dist.alltoall(outs, [y])
    checks["alltoall"] = len(outs) == 1 and same(outs[0], y)
    got = dist.gather(x, [], dst=0)
    checks["gather"] = len(got) == 1 and same(got[0], x)
    dist.send(y, dst=0)
    t = torch.zeros_like(y)
    dist.recv(t, src=0)
    checks["send_recv"] = same(t, y)
    t = torch.zeros_like(y)
    for task in dist.batch_isend_irecv([dist.P2POp(dist.isend, y, 0),
                                        dist.P2POp(dist.irecv, t, 0)]):
        task.wait()
    checks["batch_isend_irecv"] = same(t, y)
    g = dist.new_group([0])
    t = x.clone()
    dist.all_reduce(t, group=g)
    checks["new_group_all_reduce"] = g.nranks == 1 and g.rank == 0 \
        and "NCCL" in type(g.process_group).__name__ and same(t, x)
    dist.barrier()
    dist.barrier(group=g)
    torch.cuda.synchronize()
    checks["world_group_is_nccl"] = \
        "NCCL" in type(C.get_group(0).process_group).__name__
    return checks


def all_reduce_cost() -> dict:
    """The host's time to return from an all_reduce of one 25 MB f32
    bucket at world 1 over NCCL, through collective.all_reduce and through
    a raw torch.distributed.all_reduce (the mean of ALL_REDUCE_CALLS calls
    in a row, each way twice, in turns) and the card's time of each."""
    import torch
    import torch.distributed as tdist
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import collective as C
    x = torch.ones(BUCKET_BYTES // 4, device=DEV)
    opts = tdist.AllreduceOptions()
    wrapper = tdist.distributed_c10d._get_default_group()
    backend = C.get_group(0).process_group
    # the two calls beneath them: the default group's ProcessGroup and the
    # backend object collective.py calls
    ways = {"collective": lambda: dist.all_reduce(x),
            "raw": lambda: tdist.all_reduce(x),
            "process_group": lambda: wrapper.allreduce([x], opts).wait(),
            "backend": lambda: backend.allreduce([x], opts).wait()}
    out = {k: {"host_us": []} for k in ways}
    for fn in ways.values():
        fn()
    for _ in range(2):
        for name, fn in ways.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(ALL_REDUCE_CALLS):
                fn()
            out[name]["host_us"].append(
                (time.perf_counter() - t0) / ALL_REDUCE_CALLS * 1e6)
            torch.cuda.synchronize()
    for name, fn in ways.items():
        out[name]["ms"] = time_ms(fn)
    out["bytes"] = BUCKET_BYTES
    return out


def launch_worker(out_path) -> int:
    """The rank that launch_train_bf16 starts through ``python -m
    paddle_tpu_torch.distributed.launch``: init_parallel_env (NCCL on
    cuda:0), every collective at world 1, the 25 MB all_reduce's host
    time, ``build_mesh(hp)`` from the launcher's environment, then
    LAUNCH_STEPS hybrid steps at LLaMA-7B's widths with every flash launch
    held against its plain version (the step goes on with the kernels'
    results, so the counters count the main path); writes its record as
    JSON to out_path."""
    import torch
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.parallel import transformer as pt
    torch.backends.cuda.matmul.allow_tf32 = False
    marks, t0 = {}, time.perf_counter()

    def mark(name):
        marks[name] = time.perf_counter() - t0
    rec, checks = {"card": nvidia_smi(), "seconds": marks}, {}
    env = dist.init_parallel_env()
    mark("init_parallel_env")
    checks["nccl_world1_on_cuda0"] = (
        dist.get_backend(), env.rank, env.world_size,
        torch.cuda.current_device()) == ("nccl", 0, 1, 0)
    rec["collectives"] = world1_collectives()
    checks["collectives_world1_identity"] = all(rec["collectives"].values())
    mark("collectives")
    rec["all_reduce_25mb"] = all_reduce_cost()
    mark("all_reduce_cost")
    cfg, hp, batch = launch_config()
    mesh = pt.build_mesh(hp)
    mark("build_mesh")
    try:
        rec["mesh"] = {"device": str(mesh.device), "backend": mesh.backend,
                       "groups": {a: type(mesh.group(a)).__name__
                                  for a in pt.AXES}}
        checks["mesh_from_launcher_env"] = (
            mesh.rank, mesh.backend, str(mesh.device)) == (0, "nccl",
                                                           "cuda:0")
        step = pt.build_train_step(cfg, hp, mesh)
        params = pt.shard_params(pt.init_params(cfg, hp, seed=SEED,
                                                device=mesh.device), hp, mesh)
        opt = pt.init_opt_state(params, hp, mesh)
        mark("init_params")
        log = {k: [] for k in ("fwd", "dkdv", "dq", "ctl_out_1pct",
                               "ctl_lse_log2")}
        reset_flash_counts()
        with flash_patched(*held_flash(log, keep_kernels=True)):
            rec["losses"], rec["param_checksum"] = launch_steps(
                step, params, opt, batch)
        rec["launches"] = flash_counts()
        mark("steps")
        L, M = cfg.num_hidden_layers, hp.num_microbatches
        rec["gate"], gate_checks = flash_gate(log, L * M * LAUNCH_STEPS)
        checks.update(gate_checks)
        del params, opt
    finally:
        mesh.close()
        dist.destroy_process_group()
    mark("closed")
    rec["checks"] = checks
    with open(out_path, "w") as f:
        json.dump(rec, f)
    return 0 if all(checks.values()) else 1


def run_launcher(log_dir, script, *args):
    """``python -m paddle_tpu_torch.distributed.launch --nproc_per_node 1``
    of script from the repository root, in a session of its own: past
    LAUNCH_TIMEOUT_S the launcher and its workers are killed together.
    Returns (exit code, stderr)."""
    import os
    import signal
    root = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PADDLE_")}
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    p = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node", "1", "--log_dir", log_dir, script, *args],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, start_new_session=True)
    try:
        _, err = p.communicate(timeout=LAUNCH_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        _, err = p.communicate()
        return None, err + f"\nkilled after {LAUNCH_TIMEOUT_S} s"
    return p.returncode, err


def phase_launch_train_bf16(state):
    """The hybrid trainer's ranks started by the port's launcher: one rank
    over NCCL (launch_worker) against the in-process world-1 mesh step at
    the same seed (hybrid_mesh, no launcher), whose losses and parameter
    checksum it must equal bit for bit; its collectives at world 1; the
    launcher's exit code 0, and nonzero for a worker that exits 1."""
    import os
    import tempfile
    import torch
    from paddle_tpu_torch.parallel import transformer as pt
    t0 = time.perf_counter()
    rec = {"phase": "launch_train_bf16", "card": nvidia_smi(),
           "layers": CUT_LAYERS, "steps": LAUNCH_STEPS}
    checks = {}
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rank0.json")
        rc, err = run_launcher(tmp, os.path.abspath(__file__),
                               "--launch-worker", out)
        rec["launch_s"] = time.perf_counter() - t0
        rec["launcher_rc"] = rc
        checks["launcher_returns_0"] = rc == 0
        worker = {}
        if os.path.exists(out):
            with open(out) as f:
                worker = json.load(f)
        if rc != 0:
            log = os.path.join(tmp, "workerlog.0")
            rec["worker_log_tail"] = open(log).read()[-4000:] \
                if os.path.exists(log) else err[-4000:]
        fail = os.path.join(tmp, "fail.py")
        with open(fail, "w") as f:
            f.write("import sys\nsys.exit(1)\n")
        t1 = time.perf_counter()
        rc_fail, _ = run_launcher(os.path.join(tmp, "fail"), fail)
        rec["failing_launch_s"] = time.perf_counter() - t1
        rec["failing_worker_launcher_rc"] = rc_fail
        checks["failing_worker_fails_the_launch"] = rc_fail not in (0, None)
    rec["worker"] = worker
    checks.update({f"worker_{k}": v
                   for k, v in worker.get("checks", {"ran": False}).items()})

    # the in-process world-1 mesh step at the same seed, on the kernels
    t1 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, hp, batch = launch_config()
    mesh = hybrid_mesh(hp, DEV)
    try:
        step = pt.build_train_step(cfg, hp, mesh)
        params = pt.shard_params(pt.init_params(cfg, hp, seed=SEED,
                                                device=DEV), hp, mesh)
        opt = pt.init_opt_state(params, hp, mesh)
        losses, checksum = launch_steps(step, params, opt, batch)
        del params, opt
    finally:
        mesh.close()
    torch.cuda.empty_cache()
    rec["in_process_s"] = time.perf_counter() - t1
    want = {k: cfg.num_hidden_layers * hp.num_microbatches * LAUNCH_STEPS
            for k in ("fwd", "dkdv", "dq")}
    rec["in_process"] = {"losses": losses, "param_checksum": checksum}
    rec["expected_launches"] = want
    checks["losses_bit_equal_in_process"] = worker.get("losses") == losses
    checks["params_bit_equal_in_process"] = \
        worker.get("param_checksum") == checksum
    checks["losses_finite"] = all(map(math.isfinite, losses))
    checks["launches_equal_layers_x_microbatches_x_steps"] = \
        worker.get("launches") == want
    ar = worker.get("all_reduce_25mb", {})
    rec["all_reduce_25mb_host_us"] = {k: v["host_us"] for k, v in ar.items()
                                      if isinstance(v, dict)}
    rec["seconds"] = time.perf_counter() - t0
    rec["checks"] = checks
    rec["ok"] = all(checks.values())
    emit(rec)
    state["launch_train_bf16"] = rec
    return rec["ok"]


# ---------------------------------------------------------------------------
# decode phase: the paged decode kernel (block_multihead_attention's decode)
# against its plain version
# ---------------------------------------------------------------------------

BLHA_BS = 64                             # block_multihead_attention's default
BLHA_SLOTS = 8
BLHA_NBLK = MAX_MODEL_LEN // BLHA_BS


def blha_tables(need, rng):
    """Block tables [len(need), BLHA_NBLK] int32: row b lists need[b] pages
    drawn from a shuffled pool (page 0 stays unused, as the engine's null
    page), then -1 padding, the blha convention; and the pool's size."""
    import numpy as np
    num_blocks = 1 + BLHA_SLOTS * BLHA_NBLK
    bt = np.full((len(need), BLHA_NBLK), -1, np.int32)
    pages = rng.permutation(np.arange(1, num_blocks))
    used = 0
    for b, n in enumerate(need):
        bt[b, :n] = pages[used:used + n]
        used += n
    return bt, num_blocks


def decode_case(Hkv, dtype, rng, gen, Hq=H, Dh=D) -> dict:
    """One blha decode launch at LLaMA-7B's attention width (Hq query
    heads of Dh by default): 8 rows at kv lengths 100..2000 (the fresh
    token included), bs 64, -1-padded tables."""
    import torch
    lens = decode_lens(rng)
    need = [-(-n // BLHA_BS) for n in lens]
    bt, num_blocks = blha_tables(need, rng)
    dev = torch.device(DEV)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)
    bt_d = torch.from_numpy(bt).to(dev)
    return dict(q=randn(len(lens), Hq, Dh),
                kc=randn(num_blocks, Hkv, BLHA_BS, Dh),
                vc=randn(num_blocks, Hkv, BLHA_BS, Dh), bt=bt_d,
                btc=bt_d.clamp(0, num_blocks - 1).contiguous(),
                lens=torch.tensor(lens, dtype=torch.int32, device=dev),
                pages=sum(need), keys=sum(lens))


def decode_kernel(c, lens=None):
    from paddle_tpu_torch.ops import paged_attention as pa
    return pa._launch_decode_kernel(c["q"], c["kc"], c["vc"], c["btc"],
                                    c["lens"] if lens is None else lens)


def decode_plain(c):
    from paddle_tpu_torch.ops import paged_attention as pa
    return pa.paged_decode_plain(c["q"], c["kc"], c["vc"], c["bt"],
                                 c["lens"])


DECODE_CONTROLS = {
    # each row reads one key fewer
    "one_key_fewer": lambda c: decode_kernel(c, c["lens"] - 1),
    # a normalisation fault: every output 1% too large
    "scaled_1pct": lambda c: decode_kernel(c) * 1.01}


def decode_bound(c, dtype_name):
    """Least time of one decode launch: each row's keys' K and V (its
    length, not its pages in full), q, out, the table entries of the live
    pages and the lengths once over HBM bandwidth, and QK and PV over
    every row's keys (4 D flops a key and query head) over the dtype's
    peak."""
    isz = c["q"].element_size()
    B, Hq, Dh = c["q"].shape
    Hkv = c["kc"].shape[1]
    nbytes = (2 * c["keys"] * Hkv * Dh * isz
              + 2 * c["q"].numel() * isz + 4 * c["pages"] + 4 * B)
    flops = 4 * c["keys"] * Hq * Dh
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nbytes, flops)


def decode_library(c):
    """Yardstick only (the port never calls it): scaled_dot_product_attention
    over each row's pages gathered dense beforehand, a length mask."""
    import torch
    import torch.nn.functional as F
    B, Hq, Dh = c["q"].shape
    Hkv = c["kc"].shape[1]
    S = BLHA_NBLK * BLHA_BS
    pages = c["btc"].long()
    k = c["kc"][pages].permute(0, 2, 1, 3, 4).reshape(B, Hkv, S, Dh)
    v = c["vc"][pages].permute(0, 2, 1, 3, 4).reshape(B, Hkv, S, Dh)
    mask = (torch.arange(S, device=k.device)[None, :]
            < c["lens"][:, None])[:, None, None, :]
    q = c["q"][:, :, None, :]
    fn = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q, k, v, attn_mask=mask, enable_gqa=Hkv != Hq)
    return fn, fn()[:, :, 0, :]


def phase_decode(state):
    import numpy as np
    import torch
    gen = torch.Generator(device=DEV).manual_seed(SEED + 9)
    cases, ok = {}, True
    for kind, Hkv in (("mha", H), ("gqa", H // 4)):
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            c = decode_case(Hkv, dtype, np.random.default_rng(SEED + 9), gen)
            out = decode_kernel(c)
            ref = decode_plain(c)
            err = errors(out, ref)
            held = bool(torch.isfinite(out).all()) and within(err, name)
            controls = {}
            for cname, control in DECODE_CONTROLS.items():
                c_err = errors(control(c), ref)
                controls[cname] = dict(c_err, fails=not within(c_err, name))
            ok &= held and all(x["fails"] for x in controls.values())
            lib_fn, lib_out = decode_library(c)
            b_ms, b_by, nbytes, flops = decode_bound(c, name)
            cases[f"{kind}_{name}"] = {
                "H_kv": Hkv, "held": held, "errors": err,
                "controls": controls, "ms": time_ms(lambda: decode_kernel(c)),
                "plain_ms": time_ms(lambda: decode_plain(c), reps=20),
                "library_ms": time_ms(lib_fn),
                "library_max_abs_err": float(
                    (lib_out.float() - ref.float()).abs().max()),
                "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
                "flops": flops, "live_pages": c["pages"],
                "live_keys": c["keys"],
                "was_ms": PAGED_WAS_MS.get(
                    f"decode_{kind}" + ("" if name == "bfloat16"
                                        else f"_{name}"))}
            del c, out, ref, lib_fn, lib_out
            torch.cuda.empty_cache()
    state["decode"] = cases
    emit({"phase": "decode", "ok": ok, "tolerance": TOLERANCE,
          "shapes": {"B": BLHA_SLOTS, "H": H, "D": D, "bs": BLHA_BS,
                     "nblk": BLHA_NBLK, "kv_lens": "100..2000",
                     "gqa": f"H_kv={H // 4}", "tables": "-1 padded"},
          "cases": cases,
          "bound_peaks": {"bytes_per_s": PEAK_BYTES,
                          "flops_per_s": PEAK_FLOPS}})
    return ok


# ---------------------------------------------------------------------------
# varlen phase: the three varlen flash attention kernels against their plain
# versions, and flash_attn_unpadded's autograd through them
# ---------------------------------------------------------------------------

PACKED = [2048, 1536, 1200, 1024, 900, 700, 500, 284]     # 8,192 tokens
# name: (query lengths, key lengths or None for self attention, H, D,
# causal): LLaMA-7B's attention and the trainer's head dim over 8 packed
# sequences, a cross case (1,024 queries over 4,096 keys), D 256 at a small
# size, and an empty sequence among others
VARLEN_CASES = {
    "7b": (PACKED, None, 32, 128, True),
    "trainer_d64": (PACKED, None, 16, 64, True),
    "cross": ([400, 300, 200, 124], [1500, 1000, 1096, 500], 32, 128, False),
    "d256": ([300, 200, 57], None, 4, 256, True),
    "empty_seq": ([500, 0, 300, 1], None, 8, 64, True),
}
VARLEN_TIMED = ("7b", "trainer_d64")    # plain and library times too
# the bf16 kernels' times on the mma.sync kernels the wgmma ones replaced
# (PERF.md section 6, "was": the 7B case from chip_smoke.py runs, the
# trainer's backward from tools/perf/torch_ab.py varlen_bwd on the parent
# tree; NVIDIA H100 80GB HBM3, 700.00 W): the varlen phase's records carry
# them
VARLEN_WAS_MS = {"7b_bfloat16": {"fwd": 1.6082, "dkdv": 2.8326,
                                 "dq": 1.8123},
                 "trainer_d64_bfloat16": {"dkdv": 0.6250, "dq": 0.4255}}
# the varlen kernels by launch (bf16 D 64/128: wgmma; else CUDA-core)
VARLEN_NAMES = {
    "fwd": ("varlen_fwd_wgmma_kernel", "varlen_fwd_kernel"),
    "dkdv": ("varlen_bwd_dkdv_wgmma_kernel", "varlen_bwd_dkdv_kernel"),
    "dq": ("varlen_bwd_dq_wgmma_kernel", "varlen_bwd_dq_kernel")}
# the plain versions' [H, Tq, Tk] f32 scores, at most this many elements at
# once: sequences are taken in runs that fit (the 7B case's whole [32,
# 8192, 8192] would be 8.6 GB a tensor)
VARLEN_CHUNK = 2 ** 28


def varlen_groups(cu_q, cu_k, heads):
    """Runs of whole sequences [a, b) whose scores fit VARLEN_CHUNK: (q0,
    q1, k0, k1, cu_q, cu_k) with the run's offsets rebased to 0."""
    cq, ck = cu_q.tolist(), cu_k.tolist()
    n, a, groups = len(cq) - 1, 0, []
    while a < n:
        b = a + 1
        while b < n and heads * (cq[b + 1] - cq[a]) * (ck[b + 1] - ck[a]) \
                <= VARLEN_CHUNK:
            b += 1
        groups.append((cq[a], cq[b], ck[a], ck[b],
                       (cu_q[a:b + 1] - cq[a]).contiguous(),
                       (cu_k[a:b + 1] - ck[a]).contiguous()))
        a = b
    return groups


def varlen_plain_fwd(q, k, v, cu_q, cu_k, causal, scale):
    """The forward's plain version over runs of sequences (each query sees
    keys of its own sequence only, so the runs are independent)."""
    import torch
    from paddle_tpu_torch.ops import flash_attention_varlen as fav
    outs, lses = [], []
    for q0, q1, k0, k1, gq, gk in varlen_groups(cu_q, cu_k, q.shape[1]):
        if q1 == q0:
            continue
        if k1 == k0:                     # key-less rows: 0 and -inf
            outs.append(torch.zeros_like(q[q0:q1]))
            lses.append(torch.full((q.shape[1], q1 - q0), float("-inf"),
                                   device=q.device))
            continue
        o, lse = fav.varlen_fwd_reference(q[q0:q1], k[k0:k1], v[k0:k1], gq,
                                          gk, causal, scale)
        outs.append(o)
        lses.append(lse)
    return torch.cat(outs), torch.cat(lses, 1).contiguous()


def varlen_plain_grads(q, k, v, do, lse, delta, cu_q, cu_k, causal, scale,
                       want=("dq", "dk", "dv")):
    """The dK/dV and dQ plain versions over runs of sequences."""
    import torch
    from paddle_tpu_torch.ops import flash_attention_varlen as fav
    dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    for q0, q1, k0, k1, gq, gk in varlen_groups(cu_q, cu_k, q.shape[1]):
        if q1 == q0 or k1 == k0:         # nothing to attend: zero gradients
            continue
        args = (q[q0:q1], k[k0:k1], v[k0:k1], do[q0:q1],
                lse[:, q0:q1].contiguous(), delta[:, q0:q1].contiguous(), gq,
                gk, causal, scale)
        if "dk" in want:
            dk[k0:k1], dv[k0:k1] = fav.varlen_bwd_dkdv_reference(*args)
        if "dq" in want:
            dq[q0:q1] = fav.varlen_bwd_dq_reference(*args)
    return dq, dk, dv


def varlen_plain_bwd(q, k, v, out, lse, do, cu_q, cu_k, causal, scale):
    from paddle_tpu_torch.ops import flash_attention_varlen as fav
    return varlen_plain_grads(q, k, v, do, lse, fav.varlen_delta(out, do),
                              cu_q, cu_k, causal, scale)


class varlen_patched:
    """Within the block, the varlen autograd Function's forward and
    backward are ``fwd`` and ``bwd`` in place of the device dispatch."""

    def __init__(self, fwd, bwd):
        self.fns = (fwd, bwd)

    def __enter__(self):
        from paddle_tpu_torch.ops import flash_attention_varlen as fav
        self.saved = (fav._forward, fav._backward)
        fav._forward, fav._backward = self.fns

    def __exit__(self, *exc):
        from paddle_tpu_torch.ops import flash_attention_varlen as fav
        fav._forward, fav._backward = self.saved


def varlen_case(name, dtype, gen) -> dict:
    import numpy as np
    import torch
    lens_q, lens_k, heads, dh, causal = VARLEN_CASES[name]
    lens_k = lens_q if lens_k is None else lens_k
    cu_q = np.concatenate([[0], np.cumsum(lens_q)]).astype(np.int32)
    cu_k = np.concatenate([[0], np.cumsum(lens_k)]).astype(np.int32)

    def randn(*s):
        return torch.randn(s, generator=gen, device=DEV).to(dtype)
    tq, tk = int(cu_q[-1]), int(cu_k[-1])
    return dict(q=randn(tq, heads, dh), k=randn(tk, heads, dh),
                v=randn(tk, heads, dh), do=randn(tq, heads, dh),
                cu_q=torch.from_numpy(cu_q).to(DEV),
                cu_k=torch.from_numpy(cu_k).to(DEV), lens_q=list(lens_q),
                lens_k=list(lens_k), causal=causal, scale=dh ** -0.5)


def varlen_args(c):
    return c["cu_q"], c["cu_k"], c["causal"], c["scale"]


def varlen_kernels(c, lse, delta):
    """The three kernels on the case's inputs, the backward fed ``lse``
    and ``delta``: (out, lse, dq, dk, dv)."""
    from paddle_tpu_torch.ops import flash_attention_varlen as fav
    q, k, v, do = c["q"], c["k"], c["v"], c["do"]
    out, lse_k = fav._launch_fwd(q, k, v, *varlen_args(c))
    dk, dv = fav._launch_dkdv(q, k, v, do, lse, delta, *varlen_args(c))
    dq = fav._launch_dq(q, k, v, do, lse, delta, *varlen_args(c))
    return out, lse_k, dq, dk, dv


def lse_error(lse, ref) -> float:
    """Largest |lse - ref| where ref is finite; inf when the -inf rows (no
    key) differ."""
    import torch
    fin = torch.isfinite(ref)
    if not torch.equal(fin, torch.isfinite(lse)) or \
            not bool((lse[~fin] == float("-inf")).all()):
        return float("inf")
    return float((lse[fin] - ref[fin]).abs().max()) if bool(fin.any()) \
        else 0.0


def varlen_bound(c, dtype_name, kernel):
    """Least time of one launch: each operand once over HBM bandwidth, and
    its products over the per-sequence pairs (s (s + 1) / 2 a head causal,
    s_q s_k otherwise; the forward runs 2 products, dK/dV 4, dQ 3, each 2 D
    flops a pair) over the dtype's peak.  Returns (ms, by, bytes, flops)."""
    tq, heads, dh = c["q"].shape
    tk = c["k"].shape[0]
    isz = 4 if dtype_name == "float32" else 2
    pairs = sum(s * (s + 1) // 2 if c["causal"] else s * t
                for s, t in zip(c["lens_q"], c["lens_k"]))
    qb, kb, vec = tq * heads * dh * isz, tk * heads * dh * isz, 4 * heads * tq
    nbytes, products = {"fwd": (2 * qb + 2 * kb + vec, 2),
                        "dkdv": (2 * qb + 4 * kb + 2 * vec, 4),
                        "dq": (3 * qb + 2 * kb + 2 * vec, 3)}[kernel]
    nbytes += 8 * (len(c["lens_q"]) + 1)
    flops = products * 2 * heads * pairs * dh
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nbytes, flops)


def varlen_library(c):
    """Yardstick only (the port never calls it): PyTorch's varlen flash
    attention (``aten._flash_attention_forward`` / ``_backward`` with
    cumulative lengths) where the card's torch runs it (bf16), else
    scaled_dot_product_attention once per sequence.  Returns (which,
    forward fn, backward fn, its output)."""
    import torch
    import torch.nn.functional as F
    q, k, v, do = c["q"], c["k"], c["v"], c["do"]
    causal, scale = c["causal"], c["scale"]
    mq, mk = max(c["lens_q"]), max(c["lens_k"])
    if q.dtype == torch.bfloat16:
        try:
            def fwd():
                return torch.ops.aten._flash_attention_forward(
                    q, k, v, c["cu_q"], c["cu_k"], mq, mk, 0.0, causal,
                    False, scale=scale)
            out, lse, rng_state, unused, _ = fwd()

            def bwd():
                return torch.ops.aten._flash_attention_backward(
                    do, q, k, v, out, lse, c["cu_q"], c["cu_k"], mq, mk, 0.0,
                    causal, rng_state, unused, scale=scale)
            bwd()
            return "aten._flash_attention_forward/_backward (varlen)", fwd, \
                bwd, out
        except (RuntimeError, NotImplementedError) as e:   # yardstick only
            print(f"chip_smoke: varlen flash yardstick unavailable ({e!r:.200})"
                  "; timing SDPA per sequence", file=sys.stderr)
    cq, ck = c["cu_q"].tolist(), c["cu_k"].tolist()
    spans = [(cq[i], cq[i + 1], ck[i], ck[i + 1]) for i in range(len(cq) - 1)
             if cq[i + 1] > cq[i] and ck[i + 1] > ck[i]]
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]

    def fwd():
        return [F.scaled_dot_product_attention(
            leaves[0][a:b].transpose(0, 1), leaves[1][e:f].transpose(0, 1),
            leaves[2][e:f].transpose(0, 1), is_causal=causal, scale=scale)
            for a, b, e, f in spans]
    outs = fwd()
    grads = [do[a:b].transpose(0, 1) for a, b, _, _ in spans]

    def bwd():
        return torch.autograd.grad(outs, leaves, grads, retain_graph=True)
    out = torch.zeros_like(q)
    for (a, b, _, _), o in zip(spans, outs):
        out[a:b] = o.detach().transpose(0, 1)
    return "scaled_dot_product_attention per sequence", fwd, bwd, out


def varlen_controls(c, ref, lse_ref, delta, name) -> dict:
    """Kernel runs that must fail the holds: one cu boundary dropped (two
    sequences merged), the diagonal excluded (each sequence's queries one
    position ahead of its keys, so query i sees keys < i; causal only), and
    lse + log 2 fed to both backward kernels."""
    import numpy as np
    import torch
    from paddle_tpu_torch.ops import flash_attention_varlen as fav
    q, k, v, do = c["q"], c["k"], c["v"], c["do"]
    lq, lk = c["lens_q"], c["lens_k"]
    causal, scale = c["causal"], c["scale"]
    out = {}
    i = max(range(1, len(lq)), key=lambda j: min(lq[j - 1], lq[j], lk[j - 1],
                                                 lk[j]))
    keep = [j for j in range(len(lq) + 1) if j != i]
    o, _ = fav._launch_fwd(q, k, v, c["cu_q"][keep].contiguous(),
                           c["cu_k"][keep].contiguous(), causal, scale)
    e = errors(o.flatten(1), ref.flatten(1))
    out["boundary_dropped"] = dict(e, fails=not within(e, name))
    if causal:
        cq = np.asarray(c["cu_q"].tolist())
        nz = np.asarray(lq) > 0
        first = np.ones(cq[-1], bool)
        first[cq[:-1][nz]] = False               # each sequence's first query
        last = np.ones(cq[-1], bool)
        last[cq[1:][nz] - 1] = False             # and its last key
        iq = torch.from_numpy(np.nonzero(first)[0]).to(q.device)
        ik = torch.from_numpy(np.nonzero(last)[0]).to(q.device)
        cs = torch.from_numpy(np.concatenate(
            [[0], np.cumsum(np.maximum(np.asarray(lq) - 1, 0))]).astype(
                np.int32)).to(q.device)
        o, _ = fav._launch_fwd(q[iq].contiguous(), k[ik].contiguous(),
                               v[ik].contiguous(), cs, cs, True, scale)
        e = errors(o.flatten(1), ref[iq].flatten(1))
        out["diagonal_excluded"] = dict(e, fails=not within(e, name))
    lse2 = lse_ref + math.log(2.0)
    dk2, dv2 = fav._launch_dkdv(q, k, v, do, lse2, delta, *varlen_args(c))
    dq2 = fav._launch_dq(q, k, v, do, lse2, delta, *varlen_args(c))
    dq_r, dk_r, dv_r = varlen_plain_grads(q, k, v, do, lse_ref, delta,
                                          *varlen_args(c))
    for g, got, want in (("dk", dk2, dk_r), ("dv", dv2, dv_r),
                         ("dq", dq2, dq_r)):
        e = grad_errors(got, want)
        out[f"lse_plus_log2_{g}"] = dict(e, fails=not grad_within(e, name))
    return out


def varlen_counts() -> dict:
    from paddle_tpu_torch.ops import flash_attention_varlen as fav
    from paddle_tpu_torch.ops import paged_attention as pa
    return {"varlen_fwd": fav.fwd_launch_count,
            "varlen_dkdv": fav.dkdv_launch_count,
            "varlen_dq": fav.dq_launch_count,
            "decode": pa.decode_launch_count}


def reset_varlen_counts() -> None:
    from paddle_tpu_torch.ops import flash_attention_varlen as fav
    from paddle_tpu_torch.ops import paged_attention as pa
    fav.fwd_launch_count = fav.dkdv_launch_count = fav.dq_launch_count = 0
    pa.decode_launch_count = 0


UNPADDED_STEPS = 2


def unpadded_autograd(c, plain_run):
    """``flash_attn_unpadded`` forward and backward, ``(out * g).sum()``,
    UNPADDED_STEPS times from fresh leaves: through the kernels, or (the
    reference) with the autograd Function's forward and backward swapped
    for the plain versions.  Returns (out, (dq, dk, dv), launches of the
    run by kernel)."""
    import torch
    from paddle_tpu_torch.nn.functional import flash_attn_unpadded
    ctx = varlen_patched(varlen_plain_fwd, varlen_plain_bwd) if plain_run \
        else contextlib.nullcontext()
    with ctx:
        torch.cuda.synchronize()
        reset_varlen_counts()
        for _ in range(UNPADDED_STEPS):
            leaves = [c[n].detach().clone().requires_grad_(True)
                      for n in ("q", "k", "v")]
            out, _ = flash_attn_unpadded(
                *leaves, c["cu_q"], c["cu_k"], max(c["lens_q"]),
                max(c["lens_k"]), c["scale"], causal=c["causal"])
            (out.float() * c["do"].float()).sum().backward()
        torch.cuda.synchronize()
        launches = varlen_counts()
    return out.detach(), tuple(x.grad for x in leaves), launches


def phase_varlen(state):
    import torch
    from paddle_tpu_torch.ops import flash_attention_varlen as fav
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=DEV).manual_seed(SEED + 10)
    cases, ok = {}, True
    for cname in VARLEN_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            c = varlen_case(cname, dtype, gen)
            q, k, v, do = c["q"], c["k"], c["v"], c["do"]
            ref, lse_ref = varlen_plain_fwd(q, k, v, *varlen_args(c))
            delta = fav.varlen_delta(ref, do)
            first = varlen_kernels(c, lse_ref, delta)
            out, lse, dq, dk, dv = first
            dq_r, dk_r, dv_r = varlen_plain_grads(q, k, v, do, lse_ref, delta,
                                                  *varlen_args(c))
            errs = {"out": errors(out.flatten(1), ref.flatten(1)),
                    "lse_abs": lse_error(lse, lse_ref),
                    "dk": grad_errors(dk, dk_r), "dv": grad_errors(dv, dv_r),
                    "dq": grad_errors(dq, dq_r)}
            finite = all(bool(torch.isfinite(x).all())
                         for x in (out, dk, dv, dq))
            held = (finite and within(errs["out"], name)
                    and errs["lse_abs"] <= LSE_ABS
                    and all(grad_within(errs[g], name)
                            for g in ("dk", "dv", "dq")))
            repeats = all(all(torch.equal(a, b) for a, b in zip(
                varlen_kernels(c, lse_ref, delta), first)) for _ in range(10))
            del dq_r, dk_r, dv_r
            controls = varlen_controls(c, ref, lse_ref, delta, name)
            rec = {"shape": {"lens_q": c["lens_q"], "lens_k": c["lens_k"],
                             "H": q.shape[1], "D": q.shape[2],
                             "causal": c["causal"]},
                   "held": held, "repeats_bit_identical": repeats,
                   "errors": errs, "controls": controls}
            ok &= held and repeats and all(x["fails"]
                                           for x in controls.values())
            args = (*varlen_args(c),)
            rec["ms"] = {
                "fwd": time_ms(lambda: fav._launch_fwd(q, k, v, *args)),
                "dkdv": time_ms(lambda: fav._launch_dkdv(
                    q, k, v, do, lse_ref, delta, *args)),
                "dq": time_ms(lambda: fav._launch_dq(
                    q, k, v, do, lse_ref, delta, *args))}
            rec["bound"] = {kern: dict(zip(("ms", "by", "bytes", "flops"),
                                           varlen_bound(c, name, kern)))
                            for kern in ("fwd", "dkdv", "dq")}
            if cname in VARLEN_TIMED:
                rec["plain_ms"] = {
                    "fwd": time_ms(lambda: varlen_plain_fwd(q, k, v, *args),
                                   reps=10, warm=1),
                    "dkdv": time_ms(lambda: varlen_plain_grads(
                        q, k, v, do, lse_ref, delta, *args, want=("dk",)),
                        reps=10, warm=1),
                    "dq": time_ms(lambda: varlen_plain_grads(
                        q, k, v, do, lse_ref, delta, *args, want=("dq",)),
                        reps=10, warm=1)}
                which, lib_fwd, lib_bwd, lib_out = varlen_library(c)
                rec["library"] = which
                rec["library_ms"] = {"fwd": time_ms(lib_fwd),
                                     "bwd_dq_dk_dv": time_ms(lib_bwd)}
                rec["library_max_abs_err"] = float(
                    (lib_out.float() - ref.float()).abs().max())
                rec["kernel_ms"] = {
                    kern: profiled_kernel_ms(fn, VARLEN_NAMES[kern])
                    for kern, fn in (
                        ("fwd", lambda: fav._launch_fwd(q, k, v, *args)),
                        ("dkdv", lambda: fav._launch_dkdv(
                            q, k, v, do, lse_ref, delta, *args)),
                        ("dq", lambda: fav._launch_dq(
                            q, k, v, do, lse_ref, delta, *args)))}
                # the whole backward (delta, metadata, both launches),
                # beside the library's, which also computes its own delta,
                # and its two parts besides the kernels
                rec["bwd_total_ms"] = time_ms(lambda: fav._backward(
                    q, k, v, ref, lse_ref, do, *args))
                rec["bwd_parts_ms"] = {
                    "delta": time_ms(lambda: fav.varlen_delta(ref, do)),
                    "metadata": time_ms(lambda: fav._bwd_meta(
                        q, k, c["cu_q"], c["cu_k"], c["causal"]))}
                del lib_fwd, lib_bwd, lib_out
            if f"{cname}_{name}" in VARLEN_WAS_MS:
                rec["was_ms"] = VARLEN_WAS_MS[f"{cname}_{name}"]
            cases[f"{cname}_{name}"] = rec
            del c, q, k, v, do, ref, lse_ref, delta, first, out, lse, dq, dk
            del dv
            torch.cuda.empty_cache()

    # the main path: flash_attn_unpadded's forward and backward at the 7B
    # case, through the kernels, against autograd of the plain versions
    auto = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        c = varlen_case("7b", dtype, gen)
        ref, ref_grads, plain_launches = unpadded_autograd(c, plain_run=True)
        out, grads, launches = unpadded_autograd(c, plain_run=False)
        errs = {"out": errors(out.flatten(1), ref.flatten(1)),
                **{g: grad_errors(a, b) for g, a, b in
                   zip(("dq", "dk", "dv"), grads, ref_grads)}}
        want = {"varlen_fwd": UNPADDED_STEPS, "varlen_dkdv": UNPADDED_STEPS,
                "varlen_dq": UNPADDED_STEPS, "decode": 0}
        checks = {"out": within(errs["out"], name),
                  "grads": all(grad_within(errs[g], name)
                               for g in ("dq", "dk", "dv")),
                  "one_launch_of_each_kernel_a_step": launches == want,
                  "plain_run_launched_nothing": not any(
                      plain_launches.values())}
        ok &= all(checks.values())
        auto[name] = {"checks": checks, "errors": errs, "launches": launches,
                      "expected_launches": want}
        del c, ref, ref_grads, out, grads
        torch.cuda.empty_cache()
    state["varlen"] = {"cases": cases, "unpadded": auto}
    emit({"phase": "varlen", "ok": ok,
          "tolerance": {"out": TOLERANCE, "lse_abs": LSE_ABS,
                        "grads": {k: {"max_rel": t["token_rel"],
                                      "l2_rel": t["l2_rel"]}
                                  for k, t in TOLERANCE.items()}},
          "cases": cases, "flash_attn_unpadded_autograd": auto,
          "unpadded_steps": UNPADDED_STEPS,
          "bound_peaks": {"bytes_per_s": PEAK_BYTES,
                          "flops_per_s": PEAK_FLOPS}})
    return ok


# ---------------------------------------------------------------------------
# blha phases: block_multihead_attention through a serving trace at
# LLaMA-7B's attention width (its prefill runs the varlen forward kernel,
# its decode the paged decode kernel)
# ---------------------------------------------------------------------------

def blha_trace(n_decode):
    """A serving trace over 8 slots: (seq_lens_encoder, seq_lens_decoder,
    seq_lens_this_time) a step.  Step 0 prefills slots 0-5 (prompts of
    17..700 tokens from the seed), step 1 prefills slots 6-7 and decodes
    0-5 (a mixed batch), then ``n_decode`` steps decode all 8.  Returns
    (steps, pages each slot needs, prompt lengths)."""
    import numpy as np
    rng = np.random.default_rng(SEED + 11)
    prompts = [17, 700] + [int(x) for x in rng.integers(17, 701, 6)]
    n = BLHA_SLOTS
    pos = [0] * n
    steps = []

    def step(enc, this):
        dec = [p if t == 1 and e == 0 else 0 for p, t, e in
               zip(pos, this, enc)]
        steps.append(tuple(np.asarray(x, np.int32) for x in (enc, dec, this)))
        for b in range(n):
            pos[b] += this[b]
    step([p if b < 6 else 0 for b, p in enumerate(prompts)],
         [p if b < 6 else 0 for b, p in enumerate(prompts)])
    step([0] * 6 + prompts[6:], [1] * 6 + prompts[6:])
    for _ in range(n_decode):
        step([0] * n, [1] * n)
    return steps, [-(-p // BLHA_BS) for p in pos], prompts


def blha_run(layers, dtype, n_decode, gen_seed, caches=None, on_call=None):
    """Serve the trace through ``block_multihead_attention``, layer after
    layer every step, each layer with its own cache pair; qkv ``[T, 3 H
    D]`` from a seeded generator.  Returns (outputs [step][layer], caches,
    ms of each step with the card synchronised, launches by kernel)."""
    import numpy as np
    import torch
    from paddle_tpu_torch.incubate.nn.functional import \
        block_multihead_attention
    steps, need, _ = blha_trace(n_decode)
    bt_np, num_blocks = blha_tables(need, np.random.default_rng(SEED + 12))
    bt = torch.from_numpy(bt_np).to(DEV)
    if caches is None:
        caches = [tuple(torch.zeros((num_blocks, H, BLHA_BS, D), dtype=dtype,
                                    device=DEV) for _ in range(2))
                  for _ in range(layers)]
    else:
        for kc, vc in caches:
            kc.zero_()
            vc.zero_()
    gen = torch.Generator(device=DEV).manual_seed(gen_seed)
    outs, ms = [], []
    torch.cuda.synchronize()
    reset_varlen_counts()
    for enc, dec, this in steps:
        T = int(this.sum())
        t0 = time.perf_counter()
        row = []
        for layer in range(layers):
            qkv = torch.randn((T, 3 * H * D), generator=gen,
                              device=DEV).to(dtype)
            kc, vc = caches[layer]
            out, _, kc2, vc2 = block_multihead_attention(
                qkv, kc, vc, enc, dec, this, block_tables=bt,
                block_size=BLHA_BS)
            assert kc2 is kc and vc2 is vc
            row.append(out if on_call is None else on_call(out))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        outs.append(row)
    return outs, caches, ms, varlen_counts()


class blha_plain:
    """Within the block, blha's kernels are their plain versions: the
    varlen autograd Function's forward, and the packed decode entry."""

    def __init__(self, varlen_fwd=None, decode=None):
        from paddle_tpu_torch.ops import paged_attention as pa
        self.varlen = varlen_patched(varlen_fwd or varlen_plain_fwd,
                                     varlen_plain_bwd)
        self.decode = decode or pa.paged_decode_plain

    def __enter__(self):
        from paddle_tpu_torch.ops import paged_attention as pa
        self.varlen.__enter__()
        self.saved = pa.paged_decode_attention_packed
        pa.paged_decode_attention_packed = self.decode

    def __exit__(self, *exc):
        from paddle_tpu_torch.ops import paged_attention as pa
        self.varlen.__exit__()
        pa.paged_decode_attention_packed = self.saved


def blha_expected(layers, n_decode) -> dict:
    """Launches of the trace on the kernels: the varlen forward once a
    layer in each step with a prefill (steps 0 and 1), the decode kernel
    once a layer in each step with decodes (1 + n_decode)."""
    return {"varlen_fwd": 2 * layers, "varlen_dkdv": 0, "varlen_dq": 0,
            "decode": (1 + n_decode) * layers}


BLHA_F32_LAYERS, BLHA_F32_DECODE = 2, 16
BLHA_LAYERS, BLHA_DECODE = 32, 32


def phase_blha_f32(state):
    """2 layers in f32: the trace on the plain versions, then on the
    kernels; every call's output within f32 TOLERANCE of the plain run's,
    the caches equal bit for bit."""
    import torch
    L, n = BLHA_F32_LAYERS, BLHA_F32_DECODE
    with blha_plain():
        ref, ref_caches, _, plain_launches = blha_run(L, torch.float32, n,
                                                      SEED + 13)
    ref_caches = [(kc.clone(), vc.clone()) for kc, vc in ref_caches]
    outs, caches, ms, launches = blha_run(L, torch.float32, n, SEED + 13)
    errs = [errors(o, r) for row, rrow in zip(outs, ref) for o, r in
            zip(row, rrow) if o.shape[0]]
    want = blha_expected(L, n)
    checks = {"outputs_within_f32_tolerance": all(within(e, "float32")
                                                  for e in errs),
              "outputs_finite": all(bool(torch.isfinite(o).all())
                                    for row in outs for o in row),
              "caches_bit_equal": all(
                  torch.equal(a, b) for pair, rpair in zip(caches, ref_caches)
                  for a, b in zip(pair, rpair)),
              "launches_as_expected": launches == want,
              "plain_run_launched_nothing": not any(plain_launches.values())}
    rec = {"phase": "blha_f32", "ok": all(checks.values()), "checks": checks,
           "layers": L, "steps": len(outs), "decode_steps": n,
           "worst_errors": worst(errs), "tolerance": TOLERANCE["float32"],
           "launches": launches, "expected_launches": want,
           "step_ms": ms}
    emit(rec)
    state["blha_f32"] = rec
    del outs, ref, caches, ref_caches
    torch.cuda.empty_cache()
    return rec["ok"]


def held_blha(log):
    """The gate's kernels: at every call the plain version runs and the
    kernel is launched beside it on the same inputs, errors logged, with
    two controls a kernel that must fail (decode: each row one key fewer,
    the output 1% too large; varlen forward: one cu boundary dropped where
    two sequences meet, the output 1% too large); blha goes on with the
    plain versions' results."""
    from paddle_tpu_torch.ops import flash_attention_varlen as fav
    from paddle_tpu_torch.ops import paged_attention as pa

    def varlen_fwd(q, k, v, cu_q, cu_k, causal, scale):
        ref, lse = varlen_plain_fwd(q, k, v, cu_q, cu_k, causal, scale)
        out, _ = fav._launch_fwd(q, k, v, cu_q, cu_k, causal, scale)
        log["varlen"].append(errors(out.flatten(1), ref.flatten(1)))
        log["varlen_ctl_1pct"].append(errors((out * 1.01).flatten(1),
                                             ref.flatten(1)))
        lens = (cu_q[1:] - cu_q[:-1]).tolist()
        meet = [i for i in range(1, len(lens)) if lens[i - 1] and lens[i]]
        if meet:
            keep = [j for j in range(len(lens) + 1) if j != meet[0]]
            o, _ = fav._launch_fwd(q, k, v, cu_q[keep].contiguous(),
                                   cu_k[keep].contiguous(), causal, scale)
            log["varlen_ctl_merged"].append(errors(o.flatten(1),
                                                   ref.flatten(1)))
        return ref, lse

    def decode(q, kc, vc, bt, lens):
        ref = pa.paged_decode_plain(q, kc, vc, bt, lens)
        out = pa._launch_decode_kernel(q, kc, vc, bt, lens)
        log["decode"].append(errors(out, ref))
        log["decode_ctl_1pct"].append(errors(out * 1.01, ref))
        log["decode_ctl_short"].append(errors(
            pa._launch_decode_kernel(q, kc, vc, bt, lens - 1), ref))
        return ref
    return blha_plain(varlen_fwd, decode)


def profile_blha(caches, layers, n_decode, wall_ms) -> dict:
    """Device time of the kernels-alone trace under torch.profiler, by
    kernel; the idle share divides the kernels' sum by the unprofiled
    run's wall time (``wall_ms``: its step times summed)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        blha_run(layers, torch.bfloat16, n_decode, SEED + 14, caches)
    kernels = [e for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")]

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    att_ms = sum(dev_us(e) for e in kernels
                 if any(k in e.key for k in PAGED_KERNEL_NAMES)) / 1e3
    top = sorted(kernels, key=dev_us, reverse=True)[:10]
    return {"device_busy_ms": busy_ms, "wall_ms": wall_ms,
            "device_idle_share": (1 - busy_ms / wall_ms) if busy_ms
            else "not measured",
            "attention_device_ms": att_ms,
            "attention_share_of_busy": att_ms / busy_ms if busy_ms
            else "not measured",
            "kernel_launches": sum(e.count for e in kernels),
            "top_kernels": [{"name": e.key[:90], "ms": dev_us(e) / 1e3,
                             "calls": e.count} for e in top]}


def phase_blha_bf16(state):
    """32 layers in bf16 (≈ 8.6 GB of pages).  A gate run on the plain
    versions launches each kernel beside every call and holds it to the
    bf16 TOLERANCE, its controls failing; then the main path, the trace on
    the kernels alone: launch counts, prefill- and decode-step times, and
    every output against the gate's (the plain versions' on the same
    qkv); then the trace once more under the profiler."""
    import statistics as st
    import torch
    L, n = BLHA_LAYERS, BLHA_DECODE
    log = {k: [] for k in ("varlen", "varlen_ctl_1pct", "varlen_ctl_merged",
                           "decode", "decode_ctl_1pct", "decode_ctl_short")}
    with held_blha(log):
        ref, caches, gate_ms, _ = blha_run(L, torch.bfloat16, n, SEED + 14)
    ctl = {k: f"{sum(not within(e, 'bfloat16') for e in log[k])}"
              f"/{len(log[k])}" for k in log if "_ctl_" in k}
    gate = {"calls": {k: len(log[k]) for k in ("varlen", "decode")},
            "varlen": worst(log["varlen"]), "decode": worst(log["decode"]),
            "controls_failing": ctl}
    del log
    torch.cuda.reset_peak_memory_stats()
    errs = []
    outs, caches, ms, launches = blha_run(L, torch.bfloat16, n, SEED + 14,
                                          caches)
    for row, rrow in zip(outs, ref):
        errs += [errors(o, r) for o, r in zip(row, rrow) if o.shape[0]]
    peak = torch.cuda.max_memory_allocated()
    want = blha_expected(L, n)
    steps, _, prompts = blha_trace(n)
    prof = profile_blha(caches, L, n, sum(ms))
    checks = {
        "gate_held_every_call": gate["calls"] == {
            "varlen": want["varlen_fwd"], "decode": want["decode"]},
        "gate_varlen_vs_plain": within(gate["varlen"], "bfloat16"),
        "gate_decode_vs_plain": within(gate["decode"], "bfloat16"),
        "gate_controls_fail": all(
            v.split("/")[0] == v.split("/")[1] and v != "0/0"
            for v in ctl.values()),
        "kernel_run_vs_gate": within(worst(errs), "bfloat16"),
        "outputs_finite": all(bool(torch.isfinite(o).all())
                              for row in outs for o in row),
        "launches_as_expected": launches == want}
    page_bytes = sum(x.numel() * x.element_size() for pair in caches
                     for x in pair)
    rec = {"phase": "blha_bf16", "ok": all(checks.values()),
           "checks": checks, "layers": L, "steps": len(steps),
           "decode_steps": n, "slots": BLHA_SLOTS,
           "prompt_tokens": prompts,
           "gate": gate, "gate_tolerance": TOLERANCE["bfloat16"],
           "kernel_run_vs_gate": worst(errs), "launches": launches,
           "expected_launches": want, "prefill_step_ms": ms[0],
           "mixed_step_ms": ms[1], "decode_step_ms_p50": st.median(ms[2:]),
           "decode_step_ms": ms[2:], "gate_step_ms_p50": st.median(gate_ms),
           "page_bytes": page_bytes, "peak_memory_bytes": peak,
           "profile": prof}
    emit(rec)
    state["blha_bf16"] = rec
    del outs, ref, caches
    torch.cuda.empty_cache()
    return rec["ok"]


# ---------------------------------------------------------------------------
# repaired head dims and query groups: the paged kernels at every D and G the
# JAX rules take (the specialised kernels serve D 64/128 with G <= 8, the
# split kernel the rest), against their plain versions, timed in bf16
# ---------------------------------------------------------------------------

REPAIR_PAGED = {"d256": (16, 16, 256), "d384": (8, 8, 384),
                "g16": (32, 2, 128), "g32": (32, 1, 128)}   # Hq, Hkv, D
REPAIR_DECODE = dict(REPAIR_PAGED, d512=(8, 8, 512), d1024=(4, 4, 1024))


def phase_paged_repair(state):
    """Each paged entry (float ragged, int8-page ragged, decode) at the
    repaired shapes, decode rows at kv lengths 100..2000: held to its
    plain version at TOLERANCE in both dtypes; bf16 timed beside its plain
    version, its bound and scaled_dot_product_attention on the pages
    gathered dense."""
    import numpy as np
    import torch
    gen = torch.Generator(device=DEV).manual_seed(SEED + 21)
    cases, ok = {"ragged": {}, "ragged_q8": {}, "decode": {}}, True
    for entry, shapes in (("ragged", REPAIR_PAGED),
                          ("ragged_q8", REPAIR_PAGED),
                          ("decode", REPAIR_DECODE)):
        for sname, (Hq, Hkv, Dh) in shapes.items():
            for dtype in (torch.float32, torch.bfloat16):
                name = str(dtype).split(".")[-1]
                rng = np.random.default_rng(SEED + 21)
                if entry == "ragged":
                    c = attention_case("decode", Hkv, dtype, rng, gen, Hq, Dh)
                    run, ref = (lambda: kernel(c)), plain(c)
                    plain_fn = lambda: plain(c)          # noqa: E731
                    lib_c, bnd = c, bound(c, name)[:2]
                elif entry == "ragged_q8":
                    c = q8_case("decode", Hkv, dtype, rng, gen, Hq, Dh)
                    run, ref = (lambda: kernel_q8(c)), plain_q8(c)
                    plain_fn = lambda: plain_q8(c)       # noqa: E731
                    lib_c, bnd = dequantized(c, dtype), bound_q8(c)[:2]
                else:
                    c = decode_case(Hkv, dtype, rng, gen, Hq, Dh)
                    run, ref = (lambda: decode_kernel(c)), decode_plain(c)
                    plain_fn = lambda: decode_plain(c)   # noqa: E731
                    lib_c, bnd = c, decode_bound(c, name)[:2]
                err = errors(run(), ref)
                held = within(err, name)
                ok &= held
                rec = {"H": Hq, "H_kv": Hkv, "D": Dh, "held": held,
                       "errors": err}
                if dtype == torch.bfloat16:
                    lib_fn, _ = (decode_library if entry == "decode"
                                 else library)(lib_c)
                    rec.update(ms=time_ms(run, reps=10),
                               plain_ms=time_ms(plain_fn, reps=5),
                               library_ms=time_ms(lib_fn, reps=10),
                               bound_ms=bnd[0], bound_by=bnd[1])
                    del lib_fn
                cases[entry][f"{sname}_{name}"] = rec
                del c, lib_c, ref
                torch.cuda.empty_cache()
    state["paged_repair"] = cases
    emit({"phase": "paged_repair", "ok": ok, "tolerance": TOLERANCE,
          "rows": "decode launch: 8 rows, kv lens 100..2000 (ragged: bs 16; "
                  "decode: bs 64, -1 padded tables)", "cases": cases})
    return ok


# ---------------------------------------------------------------------------
# norms phase: the fused RMSNorm / LayerNorm kernel against its plain
# version.  float32 x: each row's max |out - ref| / max |ref| <= 1e-5 (the
# row sums in another order, the card's rsqrt within 2 ulp).  bfloat16 x:
# every element within max(1e-2, one bf16 ulp of the reference) -- 1e-2 is
# the JAX package's own hardware bound (tests/test_tpu_hardware.py), and
# above 2 in magnitude a single rounding of two f32 values an ulp apart
# exceeds it -- and ||out - ref|| / ||ref|| <= 1e-3, which a 0.5% shift
# fails.
# ---------------------------------------------------------------------------

NORM_ROWS = (8, 616, 2048, 2984)
NORM_HIDDEN = (4096, 1024)
# rows wider than the walk's shared-memory slot in float32 (the
# one-block-a-row kernel; bf16 x there takes the walk, the vectors read
# from device memory)
NORM_WIDE = ((8, 65536),)
# the prefill steps' shapes, also timed with x cold in L2 (a warm repeat of
# a 16.8 MB x sits in the 50 MB L2)
NORM_COLD = ((2048, 4096), (2984, 4096))
NORM_TOL = {"float32": {"row_rel": 1e-5},
            "bfloat16": {"abs_or_ulp": 1.0, "l2_rel": 1e-3}}
NORM_EPS = {"rms": 1e-6, "ln": 1e-5}


def norm_errors(out, ref) -> dict:
    """max abs; each row's max |d| / max |ref| (worst row); the worst
    |d| / max(1e-2, ulp_bf16(ref)); ||d|| / ||ref||."""
    import torch
    d = (out.float() - ref.float()).abs()
    r = ref.float()
    row = d.reshape(-1, d.shape[-1]).amax(1) / \
        r.reshape(-1, r.shape[-1]).abs().amax(1).clamp_min(1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(r.abs().clamp_min(2.0 ** -126)))
                     - 7).clamp_min(1e-2)
    return {"abs": float(d.max()), "row_rel": float(row.max()),
            "abs_or_ulp": float((d / ulp).max()),
            "l2_rel": float(d.norm() / r.norm().clamp_min(1e-30))}


def norm_within(errs, dtype_name) -> bool:
    return all(errs[k] <= v for k, v in NORM_TOL[dtype_name].items())


def norm_case(R, Hd, xdt, wdt, gen) -> dict:
    import torch
    return dict(x=torch.randn((R, Hd), generator=gen, device=DEV).to(xdt),
                w=(1 + 0.1 * torch.randn(Hd, generator=gen, device=DEV))
                .to(wdt),
                b=(0.1 * torch.randn(Hd, generator=gen, device=DEV)).to(wdt))


def norm_kernel(kind, c, eps=None, w=None):
    from paddle_tpu_torch.ops import fused_norms as fn
    eps = NORM_EPS[kind] if eps is None else eps
    w = c["w"] if w is None else w
    return fn._launch_rms(c["x"], w, eps) if kind == "rms" else \
        fn._launch_ln(c["x"], w, c["b"], eps)


def norm_plain(kind, c):
    from paddle_tpu_torch.ops import fused_norms as fn
    return fn.rms_ref(c["x"], c["w"], NORM_EPS[kind]) if kind == "rms" \
        else fn.ln_ref(c["x"], c["w"], c["b"], NORM_EPS[kind])


def norm_library(kind, c, x_of=None):
    """Yardstick only (the port never calls it): torch.nn.functional's
    rms_norm / layer_norm with the vectors cast to x's dtype beforehand,
    on c's x or, each call, on ``x_of()``; None where this PyTorch has no
    rms_norm."""
    import torch.nn.functional as F
    x = c["x"]
    w, b = c["w"].to(x.dtype), c["b"].to(x.dtype)
    get = x_of or (lambda: x)
    if kind == "rms":
        if not hasattr(F, "rms_norm"):
            return None
        return lambda: F.rms_norm(get(), (x.shape[-1],), w, NORM_EPS[kind])
    return lambda: F.layer_norm(get(), (x.shape[-1],), w, b, NORM_EPS[kind])


def norm_bound(kind, c) -> tuple:
    """Least time: x read and y written once, the weight (and bias) read
    once, over HBM bandwidth (a few flops an element: far below the
    card's ridge, so bytes bound it)."""
    x = c["x"]
    nbytes = 2 * x.numel() * x.element_size() + \
        (1 if kind == "rms" else 2) * c["w"].numel() * c["w"].element_size()
    return nbytes / PEAK_BYTES * 1e3, "bytes", nbytes


NORM_CONTROLS = {
    # the epsilon 1e-2 instead of 1e-6 / 1e-5: on these N(0, 1) rows every
    # output ~0.5% smaller (on rows whose mean square is large, as deep in
    # a decoder's residual stream, it moves nothing: the gate there uses
    # the other two)
    "eps_1e-2": lambda kind, c: norm_kernel(kind, c, eps=1e-2),
    # the weight read one element off
    "weight_rolled": lambda kind, c: norm_kernel(
        kind, c, w=c["w"].roll(1).contiguous()),
    # a normalisation fault: every output 0.5% too large
    "scaled_0.5pct": lambda kind, c: norm_kernel(kind, c) * 1.005}
GATE_CONTROLS = ("weight_rolled", "scaled_0.5pct")


def norm_cold_ms(kind, c) -> dict:
    """The kernel's and the library's time with x cold in L2: each call
    takes the next of enough copies of x to pass twice the L2."""
    x = c["x"]
    nxt = rotating(x.clone, x.numel() * x.element_size())
    cold = {"ms_l2_cold": time_ms(
        lambda: norm_kernel(kind, dict(c, x=nxt())))}
    lib = norm_library(kind, c, nxt)
    if lib is not None:
        cold["library_ms_l2_cold"] = time_ms(lib)
    return cold


def phase_norms(state):
    """Every (rows, hidden, x dtype, weight dtype) of the grid, and the
    wide rows, through both entries: held to the plain version, ten
    repeats bit for bit, the controls failing, the launch plan, and the
    kernel, plain, library and bound times; the prefill shapes also with
    x cold in L2; the launch floor (an empty kernel's time).  Then the
    public functionals at the grid's bf16 shapes with f32 weights, the
    launches counted (LayerNorm's main path: the LLaMA decoder below runs
    RMSNorm only)."""
    import torch
    from paddle_tpu_torch.incubate.nn import functional as F
    from paddle_tpu_torch.ops import fused_norms as fn
    gen = torch.Generator(device=DEV).manual_seed(SEED + 31)
    cases, ok = {}, True
    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    shapes = [(R, Hd) for R in NORM_ROWS for Hd in NORM_HIDDEN] + \
        list(NORM_WIDE)
    for R, Hd in shapes:
        for xn, xdt in dts.items():
            for wn, wdt in dts.items():
                c = norm_case(R, Hd, xdt, wdt, gen)
                for kind in ("rms", "ln"):
                    out = norm_kernel(kind, c)
                    ref = norm_plain(kind, c)
                    err = norm_errors(out, ref)
                    held = bool(torch.isfinite(out).all()) and \
                        out.dtype == xdt and norm_within(err, xn)
                    same = all(torch.equal(norm_kernel(kind, c), out)
                               for _ in range(10))
                    ctl = {}
                    for cname, control in NORM_CONTROLS.items():
                        e = norm_errors(control(kind, c), ref)
                        ctl[cname] = dict(e, fails=not norm_within(e, xn))
                    ok &= held and same and all(
                        v["fails"] for v in ctl.values())
                    lib = norm_library(kind, c)
                    b_ms, b_by, nbytes = norm_bound(kind, c)
                    plan = fn._norm_plan(R, Hd, xdt, wdt, kind, wdt,
                                         fn._sm_count(c["x"].device.index))
                    rec = cases[f"{kind}_R{R}_H{Hd}_x{xn}_w{wn}"] = {
                        "held": held, "repeats_bit_identical": same,
                        "errors": err, "controls": ctl,
                        "plan": plan._asdict(),
                        "ms": time_ms(lambda: norm_kernel(kind, c)),
                        "plain_ms": time_ms(lambda: norm_plain(kind, c)),
                        "library_ms": None if lib is None
                        else time_ms(lib),
                        "bound_ms": b_ms, "bound_by": b_by,
                        "bytes": nbytes}
                    if (R, Hd) in NORM_COLD:
                        rec.update(norm_cold_ms(kind, c))
                del c
    torch.cuda.empty_cache()
    floor_ms = time_ms(lambda: torch.cuda._sleep(1))
    # the functionals, launches counted
    fn.rms_launch_count = fn.ln_launch_count = 0
    calls = 0
    for R in NORM_ROWS:
        for Hd in NORM_HIDDEN:
            c = norm_case(R, Hd, torch.bfloat16, torch.float32, gen)
            res = torch.randn_like(c["x"])
            F.fused_rms_norm(c["x"], c["w"], residual=res)
            F.fused_layer_norm(c["x"], c["w"], c["b"], residual=res)
            calls += 1
    torch.cuda.synchronize()
    launches = {"rms": fn.rms_launch_count, "ln": fn.ln_launch_count}
    ok &= launches == {"rms": calls, "ln": calls}
    state["norms"] = {"cases": cases, "functional_launches": launches,
                      "launch_floor_ms": floor_ms}
    emit({"phase": "norms", "ok": ok, "tolerance": NORM_TOL,
          "controls": list(NORM_CONTROLS), "cases": cases,
          "launch_floor_ms": floor_ms,
          "functional_launches": launches, "functional_calls": calls,
          "bound_peaks": {"bytes_per_s": PEAK_BYTES}})
    return ok


# ---------------------------------------------------------------------------
# fused decoder phases: the LLaMA decoder Paddle's fused inference models
# compose from incubate.nn.functional ops, served greedily over
# block_multihead_attention.  Per layer: fused_rms_norm (residual in),
# fused_linear qkv, fused_rotary_position_embedding on q and k at each
# token's position, block_multihead_attention, fused_linear out,
# fused_rms_norm (residual in), fused_linear gate and up, swiglu,
# fused_linear down; then a final fused_rms_norm and the LM head.
# ---------------------------------------------------------------------------

FUSED_LAYERS, FUSED_DECODE = 32, 16
FUSED_F32_LAYERS, FUSED_F32_DECODE = 2, 4
# the f32 decoder against the dense forward: the same f32 math with other
# kernels (varlen and decode attention, the norm kernel) and other product
# shapes (fused qkv and gate/up), so sums in another order
FUSED_F32_TOL = {"abs": 1e-3, "l2_rel": 1e-4}


def fused_weights(cfg, dtype, gen, model=None) -> dict:
    """The decoder's weights, qkv and gate/up fused on the output axis:
    ``model``'s (a LlamaForCausalLM) when given, else N(0, 0.02) from
    ``gen`` layer by layer, norm scales 1 + N(0, 0.1)."""
    import torch
    dev = torch.device(DEV)
    Hd, f = cfg.hidden_size, cfg.intermediate_size

    def rnd(*shape, std=0.02):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    if model is not None:
        p = model.decode_params()
        lay = p["layers"]
        layers = [{"ln1": lay["ln1"][i], "ln2": lay["ln2"][i],
                   "wqkv": torch.cat([lay["wq"][i], lay["wk"][i],
                                      lay["wv"][i]], 1),
                   "wo": lay["wo"][i],
                   "gate_up": torch.cat([lay["gate"][i], lay["up"][i]], 1),
                   "down": lay["down"][i]}
                  for i in range(cfg.num_hidden_layers)]
        return {"embed": p["embed"], "norm_f": p["norm_f"],
                "head": p["head"], "layers": layers}
    layers = [{"ln1": (1 + rnd(Hd, std=0.1).float()).to(dtype),
               "ln2": (1 + rnd(Hd, std=0.1).float()).to(dtype),
               "wqkv": rnd(Hd, 3 * Hd), "wo": rnd(Hd, Hd),
               "gate_up": rnd(Hd, 2 * f), "down": rnd(f, Hd)}
              for _ in range(cfg.num_hidden_layers)]
    return {"embed": rnd(cfg.vocab_size, Hd), "head": rnd(Hd, cfg.vocab_size),
            "norm_f": (1 + rnd(Hd, std=0.1).float()).to(dtype),
            "layers": layers}


def fused_trace(n_decode):
    """8 slots: step 0 prefills slots 0-5 and step 1 slots 6-7 beside 6
    decodes (prompt lengths from the seed, adjusted so both steps' token
    counts are multiples of 8, where the norms' rule holds), ``n_decode``
    steps decode all 8, and a last step decodes slots 0-6 only (7 rows,
    off the rule: the norms there take the composition).  Returns (the
    active slots of each step, prompt lengths)."""
    import numpy as np
    rng = np.random.default_rng(SEED + 41)
    p = [17, 700] + [int(x) for x in rng.integers(17, 701, 6)]
    p[5] += -sum(p[:6]) % 8
    p[7] += -(p[6] + p[7] + 6) % 8
    plan = [list(range(6)), list(range(8))] + [list(range(8))] * n_decode \
        + [list(range(7))]
    return plan, p


def fused_expected(layers, n_decode) -> dict:
    """Launches of the trace on the kernels: the norm kernel 2 a layer +
    1 a step in the steps whose token count is a multiple of 8 (all but
    the last), the varlen forward a layer in the two prefill steps, the
    decode kernel a layer in every step with decodes."""
    return {"rms_norm": (2 * layers + 1) * (2 + n_decode), "layer_norm": 0,
            "varlen_fwd": 2 * layers, "varlen_dkdv": 0, "varlen_dq": 0,
            "decode": (2 + n_decode) * layers}


def fused_counts() -> dict:
    from paddle_tpu_torch.ops import fused_norms as fn
    return dict(varlen_counts(), rms_norm=fn.rms_launch_count,
                layer_norm=fn.ln_launch_count)


def reset_fused_counts() -> None:
    from paddle_tpu_torch.ops import fused_norms as fn
    reset_varlen_counts()
    fn.rms_launch_count = fn.ln_launch_count = 0


def fused_step(W, cfg, caches, toks, pos, enc, dec, this, bt, last):
    """One step of the decoder: tokens ``toks`` [T] at positions ``pos``
    [T]; the logits (f32) of the rows ``last``."""
    import torch
    from paddle_tpu_torch.incubate.nn import functional as F
    T = toks.shape[0]
    Hh = cfg.num_attention_heads
    Dh = cfg.hidden_size // Hh
    eps = cfg.rms_norm_eps
    x = W["embed"][toks]
    pos_ids = pos[None]
    res = None
    for lw, (kc, vc) in zip(W["layers"], caches):
        h, res = F.fused_rms_norm(x, lw["ln1"], epsilon=eps, residual=res)
        qkv = F.fused_linear(h, lw["wqkv"]).view(T, 3, Hh, Dh)
        q, k, _ = F.fused_rotary_position_embedding(
            qkv[None, :, 0], qkv[None, :, 1], position_ids=pos_ids,
            use_neox_rotary_style=True, rotary_emb_base=cfg.rope_theta)
        qkv = torch.cat([q[0], k[0], qkv[:, 2]], 1).reshape(T, 3 * Hh * Dh)
        out, _, _, _ = F.block_multihead_attention(
            qkv, kc, vc, enc, dec, this, block_tables=bt,
            block_size=BLHA_BS)
        h, res = F.fused_rms_norm(F.fused_linear(out, lw["wo"]), lw["ln2"],
                                  epsilon=eps, residual=res)
        x = F.fused_linear(F.swiglu(F.fused_linear(h, lw["gate_up"])),
                           lw["down"])
    h, _ = F.fused_rms_norm(x, W["norm_f"], epsilon=eps, residual=res)
    return F.fused_linear(h[last], W["head"]).float()


def fused_serve(W, cfg, dtype, n_decode, caches=None):
    """Serve ``fused_trace`` greedily.  Returns (each slot's tokens, the
    logits of each step's sampled rows, their (slot, position), each
    step's ms with the card synchronised, launches by kernel, caches,
    each step's token count)."""
    import numpy as np
    import torch
    plan, prompts = fused_trace(n_decode)
    n = len(prompts)
    Hh = cfg.num_attention_heads
    Dh = cfg.hidden_size // Hh
    rng = np.random.default_rng(SEED + 42)
    seqs = [[int(t) for t in rng.integers(0, cfg.vocab_size, m)]
            for m in prompts]
    need = [-(-(m + n_decode + 3) // BLHA_BS) for m in prompts]
    bt_np, num_blocks = blha_tables(need, np.random.default_rng(SEED + 43))
    if caches is None:
        caches = [tuple(torch.zeros((num_blocks, Hh, BLHA_BS, Dh),
                                    dtype=dtype, device=DEV)
                        for _ in range(2))
                  for _ in range(cfg.num_hidden_layers)]
    else:
        for kc, vc in caches:
            kc.zero_()
            vc.zero_()
    done = [0] * n
    logits, rows, ms, counts = [], [], [], []
    torch.cuda.synchronize()
    reset_fused_counts()
    for active in plan:
        enc, dec, this = (np.zeros(n, np.int32) for _ in range(3))
        toks, pos, last = [], [], []
        for b in active:
            new = seqs[b][done[b]:]
            enc[b] = len(new) if done[b] == 0 else 0
            dec[b] = done[b]
            this[b] = len(new)
            toks += new
            pos += range(done[b], done[b] + len(new))
            last.append(len(toks) - 1)
        sel = [b for b in range(n) if this[b]]
        counts.append(len(toks))
        t0 = time.perf_counter()
        lg = fused_step(
            W, cfg, caches, torch.tensor(toks, device=DEV),
            torch.tensor(pos, dtype=torch.int32, device=DEV),
            enc[sel], dec[sel], this[sel],
            torch.from_numpy(bt_np[sel]).to(DEV),
            torch.tensor(last, device=DEV))
        nxt = lg.argmax(-1).tolist()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        logits.append(lg)
        for b, r, t in zip(active, last, nxt):
            rows.append((b, pos[r]))
            done[b] += int(this[b])
            seqs[b].append(int(t))
    return seqs, logits, rows, ms, fused_counts(), caches, counts


def phase_fused_decoder_f32(state):
    """2 layers at LLaMA-7B widths in f32, on the kernels: the logits of
    every sampled row within FUSED_F32_TOL of the port's dense
    LlamaForCausalLM forward on the same tokens (teacher-forced), the
    launch counts exact."""
    import torch
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = LlamaConfig.llama_7b()
    cfg.num_hidden_layers = FUSED_F32_LAYERS
    model = LlamaForCausalLM(cfg, device=DEV, generator=SEED + 44)
    gen = torch.Generator(device=DEV).manual_seed(SEED + 45)
    with torch.no_grad():                   # norm scales off one
        for k in ("ln1", "ln2"):
            model.layers[k].add_(0.1 * torch.randn(
                model.layers[k].shape, generator=gen, device=DEV))
        model.norm_f.add_(0.1 * torch.randn(
            model.norm_f.shape, generator=gen, device=DEV))
    W = fused_weights(cfg, torch.float32, gen, model)
    n = FUSED_F32_DECODE
    seqs, logits, rows, ms, launches, _, _ = fused_serve(
        W, cfg, torch.float32, n)
    flat = torch.cat(logits)
    dense = {}
    with torch.no_grad():
        for b in sorted({b for b, _ in rows}):
            dense[b] = model.forward_logits(
                torch.tensor([seqs[b][:-1]], device=DEV))[0]
    want = torch.stack([dense[b][p] for b, p in rows]).float()
    d = (flat - want)
    errs = {"abs": float(d.abs().max()),
            "l2_rel": float(d.norm() / want.norm())}
    expect = fused_expected(FUSED_F32_LAYERS, n)
    checks = {"logits_within_f32_tolerance": all(
                  errs[k] <= v for k, v in FUSED_F32_TOL.items()),
              "logits_finite": bool(torch.isfinite(flat).all()),
              "launches_as_expected": launches == expect}
    rec = {"phase": "fused_decoder_f32", "ok": all(checks.values()),
           "checks": checks, "layers": FUSED_F32_LAYERS,
           "steps": len(ms), "decode_steps": n, "rows_compared": len(rows),
           "errors_vs_dense": errs, "tolerance": FUSED_F32_TOL,
           "launches": launches, "expected_launches": expect, "step_ms": ms}
    emit(rec)
    state["fused_decoder_f32"] = rec
    del model, W, logits, dense
    torch.cuda.empty_cache()
    return rec["ok"]


class norms_held:
    """The gate's norms: at every kernel route the plain version runs and
    the kernel is launched beside it on the same inputs, its errors and
    its controls' logged; the decoder goes on with the plain results."""

    def __init__(self, log):
        self.log = log

    def __enter__(self):
        from paddle_tpu_torch.ops import fused_norms as fn
        self.saved = fn._rms_forward
        log = self.log

        def rms(x, w, eps):
            ref = fn.rms_ref(x, w, eps)
            name = str(x.dtype).split(".")[-1]
            c = {"x": x, "w": w}
            log["rms"].append(norm_errors(fn._launch_rms(x, w, eps), ref))
            for cname in GATE_CONTROLS:
                e = norm_errors(NORM_CONTROLS[cname]("rms", c), ref)
                log[cname].append(not norm_within(e, name))
            return ref
        fn._rms_forward = rms
        return self

    def __exit__(self, *exc):
        from paddle_tpu_torch.ops import fused_norms as fn
        fn._rms_forward = self.saved


def profile_fused(W, cfg, caches, n_decode, wall_ms) -> dict:
    """Device time of the kernels-alone trace under torch.profiler, by
    kernel; the idle share divides the kernels' sum by the unprofiled
    run's wall time; the norms' share of the busy time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fused_serve(W, cfg, torch.bfloat16, n_decode, caches)
    kernels = [e for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")]

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    norm_ms = sum(dev_us(e) for e in kernels
                  if "fused_norm" in e.key) / 1e3     # walk and row kernels
    top = sorted(kernels, key=dev_us, reverse=True)[:12]
    return {"device_busy_ms": busy_ms, "wall_ms": wall_ms,
            "device_idle_share": (1 - busy_ms / wall_ms) if busy_ms
            else "not measured",
            "norm_kernel_ms": norm_ms,
            "norm_share_of_busy": norm_ms / busy_ms if busy_ms
            else "not measured",
            "kernel_launches": sum(e.count for e in kernels),
            "top_kernels": [{"name": e.key[:90], "ms": dev_us(e) / 1e3,
                             "calls": e.count} for e in top]}


def phase_fused_decoder_bf16(state):
    """LLaMA-7B (32 layers) in bf16, weights from the seed (~13 GB).  A
    gate run on the plain norms launches the norm kernel beside every
    call and holds it to NORM_TOL, its controls failing; then the main
    path, the trace on the kernels alone: launch counts by kernel, the
    prefill- and decode-step times; then the trace once more under the
    profiler."""
    import statistics as st
    import torch
    from paddle_tpu_torch.models.llama import LlamaConfig
    cfg = LlamaConfig.llama_7b()
    cfg.num_hidden_layers = FUSED_LAYERS
    gen = torch.Generator(device=DEV).manual_seed(SEED + 46)
    W = fused_weights(cfg, torch.bfloat16, gen)
    n = FUSED_DECODE
    log = {k: [] for k in ("rms", *GATE_CONTROLS)}
    with norms_held(log):
        _, _, _, gate_ms, _, caches, _ = fused_serve(
            W, cfg, torch.bfloat16, n)
    gate = {"calls": len(log["rms"]), "rms": {
        k: max(e[k] for e in log["rms"]) for k in log["rms"][0]},
        "controls_failing": {k: f"{sum(log[k])}/{len(log[k])}"
                             for k in GATE_CONTROLS}}
    del log
    torch.cuda.reset_peak_memory_stats()
    _, logits, _, ms, launches, caches, tokens = fused_serve(
        W, cfg, torch.bfloat16, n, caches)
    peak = torch.cuda.max_memory_allocated()
    expect = fused_expected(FUSED_LAYERS, n)
    _, prompts = fused_trace(n)
    prof = profile_fused(W, cfg, caches, n, sum(ms))
    checks = {
        "gate_held_every_call": gate["calls"] == expect["rms_norm"],
        "gate_norm_vs_plain": norm_within(gate["rms"], "bfloat16"),
        "gate_controls_fail": all(
            v.split("/")[0] == v.split("/")[1] and v != "0/0"
            for v in gate["controls_failing"].values()),
        "logits_finite": all(bool(torch.isfinite(x).all()) for x in logits),
        "launches_as_expected": launches == expect}
    weight_bytes = sum(t.numel() * t.element_size()
                       for lw in W["layers"] for t in lw.values()) + sum(
        W[k].numel() * W[k].element_size()
        for k in ("embed", "head", "norm_f"))
    rec = {"phase": "fused_decoder_bf16", "ok": all(checks.values()),
           "checks": checks, "layers": FUSED_LAYERS,
           "steps": len(ms), "decode_steps": n, "slots": len(prompts),
           "prompt_tokens": prompts,
           "tokens_per_step": tokens,
           "gate": gate, "gate_tolerance": NORM_TOL["bfloat16"],
           "launches": launches, "expected_launches": expect,
           "prefill_step_ms": ms[0], "mixed_step_ms": ms[1],
           "decode_step_ms_p50": st.median(ms[2:-1]),
           "off_rule_step_ms": ms[-1], "step_ms": ms,
           "gate_step_ms_p50": st.median(gate_ms[2:-1]),
           "weight_bytes": weight_bytes, "peak_memory_bytes": peak,
           "profile": prof}
    emit(rec)
    state["fused_decoder_bf16"] = rec
    del W, caches, logits
    torch.cuda.empty_cache()
    return rec["ok"]


# ---------------------------------------------------------------------------
# eager_capture_bf16: the eager training surface (Tensor, nn.Layer, AdamW,
# AMP) at LLaMA-7B width, eager and as a CUDA graph (jit.capture_step)
# ---------------------------------------------------------------------------

EAGER_LAYERS, EAGER_SEQ, EAGER_STEPS, EAGER_TIMED = 2, 2048, 3, 10
EAGER_MLP_STEPS = 4
# captured against eager is held bit for bit: losses, parameters and
# master weights equal, with no tolerance
EAGER_LR = 1e-4


def eager_decoder(pp, cfg, layers):
    """A LLaMA decoder built only from the port's eager surface: Embedding,
    Linear q/k/v/o, fused_rms_norm on Tensor, causal SDPA, SwiGLU and a
    Linear head (no rotary embedding)."""
    from paddle_tpu_torch.incubate.nn.functional import (fused_rms_norm,
                                                          swiglu)
    nn, F = pp.nn, pp.nn.functional
    hsz, nh = cfg.hidden_size, cfg.num_attention_heads
    hd, ffn, V = hsz // nh, cfg.intermediate_size, cfg.vocab_size
    eps = cfg.rms_norm_eps

    def norm_weight(layer):
        # around 1, not 1: the gate's rolled-weight control must move
        return layer.create_parameter(
            [hsz], default_initializer=nn.initializer.Normal(1.0, 0.1))

    class Block(nn.Layer):
        def __init__(self):
            super().__init__()
            self.ln1, self.ln2 = norm_weight(self), norm_weight(self)
            for name in ("q", "k", "v", "o"):
                setattr(self, name, nn.Linear(hsz, hsz, bias_attr=False))
            self.gate = nn.Linear(hsz, ffn, bias_attr=False)
            self.up = nn.Linear(hsz, ffn, bias_attr=False)
            self.down = nn.Linear(ffn, hsz, bias_attr=False)

        def forward(self, x):
            B, S = x.shape[0], x.shape[1]
            h = fused_rms_norm(x, self.ln1, epsilon=eps)[0]
            q, k, v = (getattr(self, n)(h).reshape([B, S, nh, hd])
                       for n in ("q", "k", "v"))
            a = F.scaled_dot_product_attention(q, k, v, is_causal=True)
            x = x + self.o(a.reshape([B, S, hsz]))
            h = fused_rms_norm(x, self.ln2, epsilon=eps)[0]
            return x + self.down(swiglu(self.gate(h), self.up(h)))

    class Decoder(nn.Layer):
        def __init__(self):
            super().__init__()
            self.embed = nn.Embedding(V, hsz)
            self.blocks = nn.LayerList([Block() for _ in range(layers)])
            self.norm = norm_weight(self)
            self.head = nn.Linear(hsz, V, bias_attr=False)

        def forward(self, ids):
            x = self.embed(ids)
            for b in self.blocks:
                x = b(x)
            return self.head(fused_rms_norm(x, self.norm, epsilon=eps)[0])
    return Decoder()


def eager_train_step(pp, net, opt, V, o2):
    F = pp.nn.functional

    def step(ids, labels):
        if o2:
            with pp.amp.auto_cast(level="O2"):
                logits = net(ids)
                loss = F.cross_entropy(logits.reshape([-1, V]),
                                       labels.reshape([-1]))
        else:
            loss = F.mse_loss(net(ids), labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss
    return step


def eager_state(net, opt):
    """Clones of everything a step changes (for running eager and
    captured from one state)."""
    ts = [p._data for p in net.parameters()]
    ts += [p._master_weight for p in net.parameters()
           if getattr(p, "_master_weight", None) is not None]
    ts += [v for st in opt._accumulators.values() for v in st.values()]
    return [(t, t.detach().clone()) for t in ts], opt._global_step


def eager_restore(saved, opt):
    import torch
    pairs, step = saved
    with torch.no_grad():
        for t, c in pairs:
            t.copy_(c)
    opt._global_step = step


def timed_calls(fn, n):
    """Losses (one host read each, after the step) and wall ms a call."""
    import torch
    losses, times = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss.numpy()))
    return losses, times


PROFILED_CALLS = 3


def on_device(e) -> bool:
    """Is a profiler event a device event (a kernel, a copy, a range)?"""
    return str(getattr(e, "device_type", "")).endswith("CUDA")


def profile_eager(fn, wall_ms) -> dict:
    """PROFILED_CALLS calls under one torch.profiler session, each
    synchronized inside its own record_function range, 5 ms of host sleep
    between them; a device event belongs to the call before the middle of
    the gap that follows it (so a skew between the host's and the card's
    clocks under 2.5 ms moves none), and the last call is the one counted
    (a profiler's first moments can miss a call's first kernels, eager or
    replayed).  Kernel launches of every call, and
    of the last: all, flash by launch, fused norm; its device busy ms and
    the idle share against the unprofiled p50 wall time."""
    import bisect
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(PROFILED_CALLS):
            with record_function(f"profiled_call_{i}"):
                fn()
                torch.cuda.synchronize()
            time.sleep(0.005)
    events = list(prof.events())
    ranges = sorted((e.time_range.start, e.time_range.end) for e in events
                    if e.name.startswith("profiled_call_")
                    and not on_device(e))
    cuts = [(a[1] + b[0]) / 2 for a, b in zip(ranges, ranges[1:])]
    calls = [[] for _ in ranges]
    for e in events:
        if on_device(e) and not e.name.startswith("profiled_call_"):
            calls[bisect.bisect_right(cuts, e.time_range.start)].append(e)
    kernels = calls[-1] if calls else []
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    by_name = {}
    for e in kernels:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    return {"kernel_launches": len(kernels),
            "kernel_launches_by_call": [len(c) for c in calls],
            "flash_launches": {kern: sum(1 for e in kernels
                                         if flash_kernel(e.name) == kern)
                               for kern in FLASH_KERNEL_NAMES},
            "norm_launches": sum(1 for e in kernels
                                 if "fused_norm" in e.name),
            "device_busy_ms": busy_ms,
            "device_idle_share": (1 - busy_ms / wall_ms) if busy_ms
            else "not measured",
            "top_kernels": [{"name": k[:90], "ms": ms, "calls": n}
                            for k, (ms, n) in sorted(
                                by_name.items(), key=lambda kv: kv[1][0],
                                reverse=True)[:8]]}


def eager_mlp(pp):
    """(a) The JAX capture tests' MLP in f32: captured against eager over
    EAGER_MLP_STEPS steps from one seed."""
    import torch
    gen = torch.Generator(device=DEV).manual_seed(SEED + 60)
    x = pp.Tensor(torch.randn((8, 16), generator=gen, device=DEV))
    y = pp.Tensor(torch.randn((8, 4), generator=gen, device=DEV))
    runs = {}
    for tag in ("eager", "captured"):
        pp.seed(7)
        net = pp.nn.Sequential(pp.nn.Linear(16, 32), pp.nn.ReLU(),
                               pp.nn.Linear(32, 4))
        opt = pp.optimizer.AdamW(learning_rate=0.01,
                                 parameters=net.parameters())
        step = eager_train_step(pp, net, opt, None, False)
        if tag == "captured":
            step = pp.jit.capture_step(step, models=net, optimizers=opt)
        losses = [float(step(x, y).numpy()) for _ in range(EAGER_MLP_STEPS)]
        runs[tag] = (losses, [p._data.detach().clone()
                              for p in net.parameters()])
    (le, pe), (lc, pc) = runs["eager"], runs["captured"]
    bit = le == lc and all(bool(torch.equal(a, b)) for a, b in zip(pe, pc))
    diff = max(float((a - b).abs().max()) for a, b in zip(pe, pc))
    sig = capture_signatures(pp)
    return {"losses_eager": le, "losses_captured": lc, "bit_equal": bit,
            "param_max_abs_diff": diff, "signatures": sig,
            "ok": bit and all(c["ok"] for c in sig.values())}


def signature_run(pp, calls, captured):
    """Losses (host arrays, dtypes kept), parameters, captures and traces
    after the calls (x, y, w) of one SGD step of the f32 MLP from one
    seed, eagerly or through one capture_step."""
    pp.seed(29)
    net = pp.nn.Sequential(pp.nn.Linear(16, 32), pp.nn.ReLU(),
                           pp.nn.Linear(32, 4))
    opt = pp.optimizer.SGD(learning_rate=0.1, parameters=net.parameters())
    traces = []

    def step(x, y, w):
        traces.append(1)
        loss = pp.nn.functional.mse_loss(net(x), y) * w
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss
    fn = pp.jit.capture_step(step, models=net, optimizers=opt) \
        if captured else step
    losses = [fn(x, y, w).numpy() for x, y, w in calls]
    return (losses, [p._data.detach().clone() for p in net.parameters()],
            getattr(fn, "num_captures", 0), len(traces))


def capture_signatures(pp):
    """(a)'s signature cases: each a sequence of calls of one captured
    step, held to the same calls run eagerly, bit for bit (loss values and
    dtypes, parameters after the last call)."""
    import torch

    def batch(seed, rows, dtype=torch.float32):
        gen = torch.Generator(device=DEV).manual_seed(SEED + seed)
        return (pp.Tensor(torch.randn((rows, 16), generator=gen,
                                      device=DEV)),
                pp.Tensor(torch.randn((rows, 4), generator=gen, device=DEV)
                          .to(dtype)))
    b8, b5, b1 = batch(70, 8), batch(71, 5), batch(72, 1)
    b64 = batch(70, 8, torch.float64)
    cases = {
        "second_batch_shape": ([(*b8, 1.0), (*b5, 1.0), (*b8, 1.0),
                                (*b5, 1.0)], (2, 4)),
        "broadcastable_batch": ([(*b8, 1.0), (*b1, 1.0), (*b8, 1.0)],
                                (2, 4)),
        "other_dtype": ([(*b8, 1.0), (*b64, 1.0), (*b8, 1.0)], (2, 4)),
        "python_loss_weight": ([(*b8, 1.0), (*b8, 0.5), (*b8, 2.0),
                                (*b8, 0.25)], (1, 2)),
    }
    out = {}
    for name, (calls, want) in cases.items():
        le, pe, _, _ = signature_run(pp, calls, False)
        lc, pc, n, traces = signature_run(pp, calls, True)
        bit = [a.dtype for a in le] == [a.dtype for a in lc] and all(
            a.tobytes() == b.tobytes() for a, b in zip(le, lc)) and all(
            bool(torch.equal(a, b)) for a, b in zip(pe, pc))
        out[name] = {"losses_eager": [float(a) for a in le],
                     "losses_captured": [float(a) for a in lc],
                     "loss_dtypes": [str(a.dtype) for a in lc],
                     "captures": n, "traces": traces,
                     "expected_captures_traces": list(want),
                     "bit_equal": bit,
                     "ok": bit and (n, traces) == want}
    return out


def phase_eager_capture_bf16(state):
    """(a) eager_mlp; (b) a 2-layer decoder at LLaMA-7B's widths from the
    eager surface, bf16 under amp.decorate O2, AdamW with
    ClipGradByGlobalNorm: one eager step with every flash and norm launch
    held to its plain version (controls failing), then EAGER_TIMED eager
    steps and EAGER_TIMED captured replays from the same state; the first
    EAGER_STEPS of each compared, one of each profiled."""
    import statistics as st
    import torch
    import paddle_tpu_torch as pp
    from paddle_tpu_torch.models.llama import LlamaConfig
    from paddle_tpu_torch.ops import fused_norms as fn
    torch.backends.cuda.matmul.allow_tf32 = False
    mlp = eager_mlp(pp)

    cfg = LlamaConfig.llama_7b()
    L, V = EAGER_LAYERS, cfg.vocab_size
    pp.seed(SEED)
    net = pp.amp.decorate(eager_decoder(pp, cfg, L), level="O2",
                          dtype="bfloat16")
    opt = pp.optimizer.AdamW(learning_rate=EAGER_LR,
                             parameters=net.parameters(),
                             grad_clip=pp.nn.ClipGradByGlobalNorm(1.0))
    gen = torch.Generator(device=DEV).manual_seed(SEED + 61)
    toks = torch.randint(0, V, (1, EAGER_SEQ + 1), generator=gen,
                         device=DEV)
    ids, labels = pp.Tensor(toks[:, :-1]), pp.Tensor(toks[:, 1:])
    step = eager_train_step(pp, net, opt, V, True)
    n_params = sum(p.size for p in net.parameters())

    # the held eager step
    flog = {k: [] for k in ("fwd", "dkdv", "dq", "ctl_out_1pct",
                            "ctl_lse_log2")}
    nlog = {k: [] for k in ("rms", *GATE_CONTROLS)}
    with flash_patched(*held_flash(flog)), norms_held(nlog):
        held_loss = float(step(ids, labels).numpy())
    fgate, fchecks = flash_gate(flog, L)
    ngate = {"calls": len(nlog["rms"]),
             "rms": {k: max(e[k] for e in nlog["rms"])
                     for k in nlog["rms"][0]},
             "controls_failing": {k: f"{sum(nlog[k])}/{len(nlog[k])}"
                                  for k in GATE_CONTROLS}}

    # eager from S, then captured from S; the first EAGER_STEPS of each
    # compared, EAGER_TIMED of each timed, one of each profiled
    saved = eager_state(net, opt)
    reset_flash_counts()
    fn.rms_launch_count = 0
    e_losses, e_ms = timed_calls(lambda: step(ids, labels), EAGER_STEPS)
    e3_masters = [p._master_weight.clone() for p in net.parameters()]
    e3_bf16 = [p._data.detach().clone() for p in net.parameters()]
    more, more_ms = timed_calls(lambda: step(ids, labels),
                                EAGER_TIMED - EAGER_STEPS)
    e_losses, e_ms = e_losses + more, e_ms + more_ms
    e_launch = dict(flash_counts(), rms=fn.rms_launch_count)
    e_prof = profile_eager(lambda: step(ids, labels), st.median(e_ms[1:]))
    eager_restore(saved, opt)
    cap = pp.jit.capture_step(step, models=net, optimizers=opt)
    reset_flash_counts()
    fn.rms_launch_count = 0
    t0 = time.perf_counter()
    first = float(cap(ids, labels).numpy())
    capture_s = time.perf_counter() - t0
    c_launch_capture = dict(flash_counts(), rms=fn.rms_launch_count)
    c_losses, c_ms = timed_calls(lambda: cap(ids, labels), EAGER_STEPS - 1)
    c_losses = [first] + c_losses
    c3_masters = [p._master_weight.clone() for p in net.parameters()]
    c3_bf16 = [p._data.detach().clone() for p in net.parameters()]
    more, more_ms = timed_calls(lambda: cap(ids, labels),
                                EAGER_TIMED - EAGER_STEPS)
    c_ms = c_ms + more_ms
    c_prof = profile_eager(lambda: cap(ids, labels), st.median(c_ms))
    c_launch_after = dict(flash_counts(), rms=fn.rms_launch_count)

    bit = c_losses == e_losses[:EAGER_STEPS] and all(
        bool(torch.equal(a, b)) for a, b in zip(e3_masters, c3_masters)) \
        and all(bool(torch.equal(a, b)) for a, b in zip(e3_bf16, c3_bf16))
    master_diff = max(float((a - b).abs().max())
                      for a, b in zip(e3_masters, c3_masters))
    loss_rel = max(abs(a - b) / abs(a)
                   for a, b in zip(e_losses[:EAGER_STEPS], c_losses))
    per_step = {"fwd": L, "dkdv": L, "dq": L, "rms": 2 * L + 1}
    checks = {
        "mlp_captured_vs_eager": mlp["ok"],
        "capture_signatures": all(c["ok"]
                                  for c in mlp["signatures"].values()),
        "gate_held_every_call": fgate["calls"] == {
            k: L for k in ("fwd", "dkdv", "dq")}
        and ngate["calls"] == 2 * L + 1,
        **fchecks,
        "gate_norm_vs_plain": norm_within(ngate["rms"], "bfloat16"),
        "gate_norm_controls_fail": all(
            v.split("/")[0] == v.split("/")[1] and v != "0/0"
            for v in ngate["controls_failing"].values()),
        "losses_finite": all(map(math.isfinite,
                                 [held_loss] + e_losses + c_losses + more)),
        "eager_launches": e_launch == {k: v * EAGER_TIMED
                                       for k, v in per_step.items()},
        "eager_profiled_launches": e_prof["flash_launches"] == {
            k: L for k in FLASH_KERNEL_NAMES}
        and e_prof["norm_launches"] == per_step["rms"],
        "replay_profiled_launches": c_prof["flash_launches"] == {
            k: L for k in FLASH_KERNEL_NAMES}
        and c_prof["norm_launches"] == per_step["rms"],
        "replays_launch_nothing_from_python":
            c_launch_after == c_launch_capture,
        "captured_vs_eager_bit_equal": bit}
    rec = {"phase": "eager_capture_bf16", "ok": all(checks.values()),
           "checks": checks, "layers": L, "seq": EAGER_SEQ,
           "params": n_params, "mlp_f32": mlp,
           "gate": {"flash": fgate, "norm": ngate, "loss": held_loss},
           "losses_eager": e_losses, "losses_captured": c_losses + more,
           "bit_equal": bit, "master_max_abs_diff": master_diff,
           "loss_max_rel_diff": loss_rel,
           "eager_step_ms": e_ms, "eager_step_ms_p50": st.median(e_ms[1:]),
           "captured_step_ms": c_ms, "captured_step_ms_p50": st.median(c_ms),
           "capture_s": capture_s,
           "launches_a_step": per_step,
           "eager_launches": e_launch,
           "capture_launches_warmup_and_capture": c_launch_capture,
           "profile_eager": e_prof, "profile_captured": c_prof,
           "register_generator_state": hasattr(torch.cuda.CUDAGraph,
                                               "register_generator_state"),
           "card": nvidia_smi()}
    emit(rec)
    state["eager_capture_bf16"] = rec
    del net, opt, cap, saved, e3_masters, c3_masters, e3_bf16, c3_bf16
    torch.cuda.empty_cache()
    return rec["ok"]


def phase_ops_sweep(state):
    """Every op of the port's registry on the card against the same call
    on the CPU, both through the port (tests/_torch_sweep_cases.py):
    forward and gradient within the parity tests' tolerances, every
    output Tensor on the card; the ops that draw held to their properties
    on the card."""
    import os
    import torch
    import paddle_tpu_torch as pp
    # the case table lives beside the parity tests that share it
    sys.path.insert(0, os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "tests"))
    import _torch_sweep_cases as S
    # IEEE f32 on the card, as on the CPU: no TF32 in matmuls or cuDNN
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    failures, seconds = {}, {}
    t0 = time.perf_counter()
    for name in sorted(S.CASES):
        t = time.perf_counter()
        try:
            ref = S.run(pp, name, "cpu")
            got = S.run(pp, name, "gpu")
            bad = S.compare(name, ref, got)
            off = [d for d in got.devices if d != "cuda"]
            if off:
                bad.append(f"outputs on {off}")
        except Exception as e:
            bad = [f"{type(e).__name__}: {e}"[:300]]
        seconds[name] = time.perf_counter() - t
        if bad:
            failures[name] = bad
    for name in sorted(S.RANDOM):
        t = time.perf_counter()
        try:
            bad = S.check_random(pp, name, "gpu")
        except Exception as e:
            bad = [f"{type(e).__name__}: {e}"[:300]]
        seconds["random:" + name] = time.perf_counter() - t
        if bad:
            failures["random:" + name] = bad
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    n = len(S.CASES) + len(S.RANDOM)
    print(f"ops_sweep: {n} ops checked ({len(S.CASES)} against the CPU, "
          f"{len(S.RANDOM)} draws by their properties) in {total:.1f} s",
          flush=True)
    print(f"ops_sweep: failures: {json.dumps(failures)}", flush=True)
    slow = sorted(seconds.items(), key=lambda kv: -kv[1])[:10]
    rec = {"phase": "ops_sweep", "ok": not failures,
           "registry": len(S.registry(pp)), "checked": n,
           "against_cpu": len(S.CASES), "by_properties": len(S.RANDOM),
           "failures": failures, "seconds": total,
           "slowest": [{"op": k, "s": v} for k, v in slow],
           "card": nvidia_smi()}
    emit(rec)
    state["ops_sweep"] = rec
    return rec["ok"]


def blha_records(state) -> list:
    """The kernels line's entries of this slice's four kernels: the decode
    kernel timed at the decode phase's bf16 MHA case, the varlen kernels at
    the varlen phase's 7B bf16 case; launches from the main-path runs
    (blha_bf16 on the kernels alone, and flash_attn_unpadded's autograd
    run in bf16)."""
    dec = state["decode"]
    dt = dec["mha_bfloat16"]
    vcases = state["varlen"]["cases"]
    vt = vcases["7b_bfloat16"]
    bl = state["blha_bf16"]["launches"]
    auto = state["varlen"]["unpadded"]["bfloat16"]["launches"]
    recs = [{
        "name": "paged_decode_attention", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/ragged_paged_attention.cu",
        "replaces": "paddle_tpu/ops/pallas/paged_attention.py:77",
        "tpu_kernel": "paged_attention.py::_decode_kernel",
        "launches": bl["decode"],
        "launches_by_phase": {
            "blha_bf16": bl["decode"],
            "blha_f32": state["blha_f32"]["launches"]["decode"]},
        "max_abs_err": max(c["errors"]["abs"] for c in dec.values()),
        "ms": dt["ms"], "plain_ms": dt["plain_ms"], "bound_ms": dt["bound_ms"],
        "bound_by": dt["bound_by"], "library_ms": dt["library_ms"],
        "library": "scaled_dot_product_attention over the pages gathered "
                   "dense beforehand, a length mask",
        "timed_shape": "B=8 H=H_kv=32 D=128 bs=64, kv lens 100..2000, "
                       "bfloat16",
        "by_case": {k: {f: c[f] for f in ("ms", "plain_ms", "bound_ms",
                                          "library_ms")}
                    for k, c in dec.items()},
        "repaired_shapes": repaired(state, "decode")}]
    for kern, line, fn, err_keys, lib in (
            ("fwd", 101, "_vfwd_kernel", ("out",), "fwd"),
            ("dkdv", 143, "_vbwd_dkdv_kernel", ("dk", "dv"), "bwd_dq_dk_dv"),
            ("dq", 183, "_vbwd_dq_kernel", ("dq",), "bwd_dq_dk_dv")):
        b = vt["bound"][kern]
        launches = auto[f"varlen_{kern}"] + (bl["varlen_fwd"] if kern == "fwd"
                                             else 0)
        recs.append({
            "name": "flash_attention_varlen_" + (
                "fwd" if kern == "fwd" else f"bwd_{kern}"),
            "route": "cuda",
            "source": "paddle_tpu_torch/csrc/flash_attention_varlen.cu",
            "replaces": f"paddle_tpu/ops/pallas/flash_attention_varlen.py:"
                        f"{line}",
            "tpu_kernel": f"flash_attention_varlen.py::{fn}",
            "launches": launches,
            "launches_by_phase": {
                "flash_attn_unpadded_bf16": auto[f"varlen_{kern}"],
                "blha_bf16": bl[f"varlen_{kern}"],
                "blha_f32": state["blha_f32"]["launches"][f"varlen_{kern}"]},
            "max_abs_err": max(c["errors"][e]["abs"] for c in vcases.values()
                               for e in err_keys),
            "ms": vt["ms"][kern], "plain_ms": vt["plain_ms"][kern],
            "kernel_ms": vt["kernel_ms"].get(kern),
            "bound_ms": b["ms"], "bound_by": b["by"],
            "library_ms": vt["library_ms"][lib],
            "library": vt["library"] + (" forward" if kern == "fwd" else
                                        " backward (dq, dk and dv together)"),
            **({} if kern == "fwd" else {"bwd_total_ms": vt["bwd_total_ms"]}),
            "timed_shape": "8 packed causal sequences, 8,192 tokens, H=32 "
                           "D=128, bfloat16",
            "by_case": {name: {"ms": c["ms"][kern],
                               "bound_ms": c["bound"][kern]["ms"]}
                        for name, c in vcases.items()}})
    return recs


def flash_records(state) -> list:
    """The kernels line's flash attention entries, timed at the trainer's
    attention in bf16 (flash phase), with launches from train_bf16's run
    on the kernels alone and train_hybrid_bf16's main path."""
    cases = state["flash"]
    t = cases["trainer_bfloat16"]["timing"]
    tb = state["train_bf16"]
    th = state["train_hybrid_bf16"]
    tl = state["launch_train_bf16"]["worker"]
    ec = state["eager_capture_bf16"]
    recs = []
    for kern, line, fn, err_keys in (
            ("fwd", 97, "_fwd_kernel", ("out",)),
            ("dkdv", 214, "_bwd_dkdv_kernel", ("dk", "dv")),
            ("dq", 277, "_bwd_dq_kernel", ("dq",))):
        b = t["bound"][kern]
        recs.append({
            "name": f"flash_attention_{'bwd_' if kern != 'fwd' else ''}"
                    f"{kern}",
            "route": "cuda", "source": "paddle_tpu_torch/csrc/"
                                       "flash_attention.cu",
            "replaces": f"paddle_tpu/ops/pallas/flash_attention.py:{line}",
            "tpu_kernel": f"flash_attention.py::{fn}",
            "launches": tb["launches"][kern] + th["dense"]["launches"][kern]
            + tl["launches"][kern] + ec["eager_launches"][kern],
            "launches_by_phase": {
                "train_bf16": tb["launches"][kern],
                "train_hybrid_bf16": th["dense"]["launches"][kern],
                "launch_train_bf16": tl["launches"][kern],
                "train_hybrid_bf16_remat_attn_2_steps":
                    th["remat"]["attn"]["launches_2_steps"][kern],
                "train_hybrid_bf16_remat_full_2_steps":
                    th["remat"]["full"]["launches_2_steps"][kern],
                "train_hybrid_bf16_moe": th["moe_bf16"]["launches"][kern],
                "train_hybrid_bf16_1f1b_driver":
                    th["drivers"]["1f1b"]["launches"][kern],
                "train_bf16_remat": tb["remat_launches"][kern],
                "train_f32": state["train_f32"]["launches"][kern],
                "eager_capture_bf16": ec["eager_launches"][kern],
                "eager_capture_bf16_a_replay_profiled":
                    ec["profile_captured"]["flash_launches"][kern]},
            "max_abs_err": max(c["errors"][e]["abs"] for c in cases.values()
                               for e in err_keys),
            "max_rel_err": max(c["errors"][e].get(
                "max_rel", c["errors"][e].get("token_rel"))
                for c in cases.values() for e in err_keys),
            "ms": t["ms"][kern], "plain_ms": t["plain_ms"][kern],
            "kernel_ms": t["kernel_ms"].get(kern),
            "bound_ms": b["ms"], "bound_by": b["by"],
            "library_ms": t["library_ms"]["fwd" if kern == "fwd"
                                          else "bwd_dq_dk_dv"],
            "library": "scaled_dot_product_attention(is_causal=True, "
                       "enable_gqa=True) " + (
                           "forward" if kern == "fwd" else
                           "backward (dq, dk and dv in one call)"),
            "timed_shape": "B=2 S=2048 H=16 Hk=4 D=64 causal, bfloat16",
            "by_case": {name: {"ms": c["timing"]["ms"][kern],
                               "plain_ms": c["timing"]["plain_ms"][kern],
                               "bound_ms": c["timing"]["bound"][kern]["ms"]}
                        for name, c in cases.items()}})
    return recs


def norm_records(state) -> list:
    """The kernels line's two fused-norm entries (one source, two C
    entries), timed at the decode step's shape (8 rows of 4,096 in bf16,
    bf16 weights) beside the launch floor, and at the 2,048-row step
    (warm and with x cold in L2); launches from the main path: RMSNorm's
    from fused_decoder_bf16 on the kernels alone, LayerNorm's from the
    functional run of the norms phase (the LLaMA decoder has none)."""
    cases = state["norms"]["cases"]
    fl = state["norms"]["functional_launches"]
    recs = []
    for kind, entry, line, fn in (
            ("rms", "fused_rms_norm", 42, "_rms_kernel"),
            ("ln", "fused_layer_norm", 49, "_ln_kernel")):
        t = cases[f"{kind}_R{NORM_ROWS[0]}_H{NORM_HIDDEN[0]}_xbfloat16_"
                  "wbfloat16"]
        t2 = cases[f"{kind}_R2048_H{NORM_HIDDEN[0]}_xbfloat16_wbfloat16"]
        ec = state["eager_capture_bf16"]
        launches = (state["fused_decoder_bf16"]["launches"]["rms_norm"]
                    + ec["eager_launches"]["rms"]
                    if kind == "rms" else fl["ln"])
        by_phase = {"norms_functional": fl[kind]}
        if kind == "rms":
            by_phase.update(
                fused_decoder_bf16=state["fused_decoder_bf16"]["launches"][
                    "rms_norm"],
                fused_decoder_f32=state["fused_decoder_f32"]["launches"][
                    "rms_norm"],
                eager_capture_bf16=ec["eager_launches"]["rms"],
                eager_capture_bf16_a_replay_profiled=ec[
                    "profile_captured"]["norm_launches"])
        recs.append({
            "name": entry, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/fused_norms.cu",
            "replaces": f"paddle_tpu/ops/pallas/fused_norms.py:{line}",
            "tpu_kernel": f"fused_norms.py::{fn}",
            "launches": launches, "launches_by_phase": by_phase,
            "max_abs_err": max(c["errors"]["abs"] for k, c in cases.items()
                               if k.startswith(kind + "_")),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "library": "torch.nn.functional." + (
                "rms_norm" if kind == "rms" else "layer_norm") +
                " with the vectors cast to x's dtype",
            "timed_shape": f"R={NORM_ROWS[0]} H={NORM_HIDDEN[0]}, bfloat16 "
                           "x and weights",
            "launch_floor_ms": state["norms"]["launch_floor_ms"],
            "R2048": {f: t2.get(f) for f in (
                "ms", "ms_l2_cold", "library_ms", "library_ms_l2_cold",
                "bound_ms", "plan")},
            "by_case": {k[len(kind) + 1:]: {f: c[f] for f in (
                "ms", "ms_l2_cold", "plain_ms", "bound_ms", "library_ms",
                "library_ms_l2_cold") if f in c}
                for k, c in cases.items() if k.startswith(kind + "_")}})
    return recs


def repaired(state, entry) -> dict:
    """A paged entry's numbers at the repaired head dims and groups."""
    return {k: {f: c.get(f) for f in ("H", "H_kv", "D", "ms", "plain_ms",
                                       "bound_ms", "library_ms")}
            for k, c in state["paged_repair"][entry].items()
            if k.endswith("bfloat16")}


def kernel_records(state) -> list:
    """The kernels line: each kernel with its TPU original, its launches
    on the main path (the runs on the kernels alone) and its numbers from
    this run."""
    timing = state["kernel"]["timing"]["bfloat16"]
    errs = state["kernel"]["errors"]
    t_q8 = state["kernel_q8"]["timing"]["bfloat16"]
    errs_q8 = state["kernel_q8"]["errors"]
    qmm = state["qmm"]
    qmm_timed = "gate_up_int8_M8"
    return [{
        "name": "ragged_paged_attention", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/ragged_paged_attention.cu",
        "replaces": "paddle_tpu/ops/pallas/paged_attention.py:225",
        "tpu_kernel": "paged_attention.py::_ragged_kernel",
        "launches": state["engine_bf16"]["kernel_launches"]
        + state["engine_w4"]["launches"]["attention"]
        + state["engine_window_bf16"]["kernel_launches"]
        + state["engine_spec_bf16"]["kernel_launches"]
        + state["frontend_bf16"]["kernel_launches"]
        + state["sim_fit_bf16"]["kernel_launches"]
        + state["hf_bridge_bf16"]["kernel_launches"]
        + state["engine_tp2_bf16"]["kernel_launches"]
        + state["engine_tp2_bf16"]["w4"]["launches"]["attention"]
        + state["tune_sweep_bf16"]["kernel_launches"],
        "launches_by_phase": {
            "engine_bf16": state["engine_bf16"]["kernel_launches"],
            "engine_w4": state["engine_w4"]["launches"]["attention"],
            "engine_window_bf16":
                state["engine_window_bf16"]["kernel_launches"],
            "engine_spec_bf16": state["engine_spec_bf16"]["kernel_launches"],
            "frontend_bf16": state["frontend_bf16"]["kernel_launches"],
            "sim_fit_bf16": state["sim_fit_bf16"]["kernel_launches"],
            "hf_bridge_bf16": state["hf_bridge_bf16"]["kernel_launches"],
            "engine_tp2_bf16": state["engine_tp2_bf16"]["kernel_launches"],
            "engine_tp2_bf16_w4":
                state["engine_tp2_bf16"]["w4"]["launches"]["attention"],
            "tune_sweep_bf16": state["tune_sweep_bf16"]["kernel_launches"],
            "engine_f32": state["engine_f32"]["kernel_launches"],
            "engine_tp2_f32": state["engine_tp2_f32"]["kernel_launches"],
            "engine_spec_f32": state["engine_spec_f32"]["kernel_launches"],
            "engine_tiers_f32":
                state["engine_tiers_f32"]["attention_launches"]},
        "max_abs_err": max(e["abs"] for e in errs.values()),
        "errors_by_case": errs,
        "ms": timing["ms"], "kernel_ms": timing["ms"],
        "plain_ms": timing["plain_ms"], "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"], "library_ms": timing["library_ms"],
        "timed_shape": "decode Tq=8 H=32 H_kv=32 D=128 bs=16, bfloat16",
        "mixed": state["kernel"]["mixed"],
        "verify": state["kernel"]["verify"],
        "float32": state["kernel"]["timing"]["float32"],
        "repaired_shapes": repaired(state, "ragged")}, {
        "name": "ragged_paged_attention_q8", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/ragged_paged_attention.cu",
        "replaces": "paddle_tpu/ops/pallas/paged_attention.py:283",
        "tpu_kernel": "paged_attention.py::_ragged_quant_kernel",
        "launches": state["engine_w8kv8"]["launches"]["attention_q8"]
        + state["engine_window_w8kv8"]["launches"]["attention_q8"]
        + state["engine_spec_f32"]["quant_launches"]["attention_q8"]
        + state["engine_tiers_f32"]["attention_q8_launches"],
        "launches_by_phase": {
            "engine_w8kv8": state["engine_w8kv8"]["launches"]["attention_q8"],
            "engine_window_w8kv8":
                state["engine_window_w8kv8"]["launches"]["attention_q8"],
            "engine_spec_f32":
                state["engine_spec_f32"]["quant_launches"]["attention_q8"],
            "engine_tiers_f32":
                state["engine_tiers_f32"]["attention_q8_launches"]},
        "max_abs_err": max(e["abs"] for e in errs_q8.values()),
        "errors_by_case": errs_q8,
        "ms": t_q8["ms"], "plain_ms": t_q8["plain_ms"],
        "bound_ms": t_q8["bound_ms"], "bound_by": t_q8["bound_by"],
        "library_ms": t_q8["library_ms"],
        "library": "scaled_dot_product_attention on K/V dequantized and "
                   "gathered dense beforehand",
        "timed_shape": "decode Tq=8 H=32 H_kv=32 D=128 bs=16, int8 pages, "
                       "bfloat16 q",
        "mixed": state["kernel_q8"]["mixed"],
        "verify": state["kernel_q8"]["verify"],
        "float32_q": state["kernel_q8"]["timing"]["float32"],
        "repaired_shapes": repaired(state, "ragged_q8")}, {
        "name": "quant_matmul", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/quant_matmul.cu",
        "replaces": "paddle_tpu/ops/pallas/quant_matmul.py:227",
        "tpu_kernel": "quant_matmul.py::_qmm_kernel",
        "launches": state["engine_w8kv8"]["launches"]["qmm"]
        + state["engine_w4"]["launches"]["qmm"]
        + state["engine_window_w8kv8"]["launches"]["qmm"]
        + state["engine_spec_f32"]["quant_launches"]["qmm"]
        + state["engine_tp2_bf16"]["w4"]["launches"]["qmm"]
        + state["tune_sweep_bf16"]["launches"]["qmm"],
        "launches_by_phase": {
            "engine_tp2_bf16_w4":
                state["engine_tp2_bf16"]["w4"]["launches"]["qmm"],
            "tune_sweep_bf16": state["tune_sweep_bf16"]["launches"]["qmm"],
            "engine_w8kv8": state["engine_w8kv8"]["launches"]["qmm"],
            "engine_w4": state["engine_w4"]["launches"]["qmm"],
            "engine_window_w8kv8":
                state["engine_window_w8kv8"]["launches"]["qmm"],
            "engine_spec_f32":
                state["engine_spec_f32"]["quant_launches"]["qmm"]},
        "max_abs_err": max(c["abs"] for c in qmm.values()),
        "ms": qmm[qmm_timed]["ms"], "plain_ms": qmm[qmm_timed]["plain_ms"],
        "bound_ms": qmm[qmm_timed]["bound_ms"],
        "bound_by": qmm[qmm_timed]["bound_by"],
        "library_ms": qmm[qmm_timed]["library_ms"],
        "library": "torch.matmul against the weight dequantized to bf16 "
                   "beforehand",
        "timed_shape": "M=8 K=4096 N=11008 int8, bfloat16 x, L2 cold",
        "prefill": {f: qmm["gate_up_int8_M512"][f] for f in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
        | {"timed_shape": "M=512 K=4096 N=11008 int8, bfloat16 x"},
        "by_shape": {k: {f: c.get(f) for f in (
            "ms", "ms_l2_warm", "plain_ms", "bound_ms", "bound_by",
            "library_ms")} for k, c in qmm.items()}}] + \
        flash_records(state) + \
        blha_records(state) + norm_records(state)


def main() -> int:
    if sys.argv[1:2] == ["--launch-worker"]:
        return launch_worker(sys.argv[2])
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing measured", file=sys.stderr)
        return 2
    try:
        from paddle_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the port is not importable ({e}); run from the "
              "repository root", file=sys.stderr)
        return 3

    smi = nvidia_smi()
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})
    state, ok = {}, True
    t0 = time.perf_counter()
    try:
        report = _build.build()
        emit({"phase": "build", "ok": True,
              "seconds": time.perf_counter() - t0,
              "built": {k: {"seconds": s, "ptxas": [
                  ln.strip() for ln in log.splitlines()
                  if "registers" in ln or "Compiling entry" in ln
                  or "spill" in ln or "C75" in ln]}
                  for k, (s, log) in report.items()}})
    except Exception:
        traceback.print_exc()
        emit({"phase": "build", "ok": False})
        return 1
    for name, fn in (("kernel", phase_kernel),
                     ("kernel_q8", phase_kernel_q8),
                     ("qmm", phase_qmm),
                     ("flash", phase_flash),
                     ("decode", phase_decode),
                     ("paged_repair", phase_paged_repair),
                     ("varlen", phase_varlen),
                     ("norms", phase_norms),
                     ("engine_f32", phase_engine_f32),
                     ("engine_quant_f32", phase_engine_quant_f32),
                     ("engine_bf16", phase_engine_bf16),
                     ("engine_w8kv8", phase_engine_w8kv8),
                     ("engine_w4", phase_engine_w4),
                     ("engine_window_bf16", phase_engine_window_bf16),
                     ("engine_window_w8kv8", phase_engine_window_w8kv8),
                     ("engine_spec_f32", phase_engine_spec_f32),
                     ("engine_tiers_f32", phase_engine_tiers_f32),
                     ("engine_spec_bf16", phase_engine_spec_bf16),
                     ("frontend_bf16", phase_frontend_bf16),
                     ("frontend_cli", phase_frontend_cli),
                     ("sim_fit_bf16", phase_sim_fit_bf16),
                     ("hf_bridge_bf16", phase_hf_bridge_bf16),
                     ("engine_tp2_f32", phase_engine_tp2_f32),
                     ("engine_tp2_bf16", phase_engine_tp2_bf16),
                     ("tune_sweep_bf16", phase_tune_sweep_bf16),
                     ("train_f32", phase_train_f32),
                     ("train_bf16", phase_train_bf16),
                     ("train_hybrid_bf16", phase_train_hybrid_bf16),
                     ("launch_train_bf16", phase_launch_train_bf16),
                     ("blha_f32", phase_blha_f32),
                     ("blha_bf16", phase_blha_bf16),
                     ("fused_decoder_f32", phase_fused_decoder_f32),
                     ("fused_decoder_bf16", phase_fused_decoder_bf16),
                     ("eager_capture_bf16", phase_eager_capture_bf16),
                     ("ops_sweep", phase_ops_sweep)):
        t = time.perf_counter()
        try:
            passed = fn(state)
        except Exception:
            traceback.print_exc()
            emit({"phase": name, "ok": False, "error": "exception"})
            passed = False
        print(f"chip_smoke: {name} {'passed' if passed else 'FAILED'} in "
              f"{time.perf_counter() - t:.1f} s", file=sys.stderr)
        ok &= passed
    emit({"phase": "run", "ok": ok, "seconds": time.perf_counter() - t0,
          "card": smi})
    if not ok:
        return 1

    emit({"kernels": kernel_records(state)})
    for ln in smi:
        print(ln, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
