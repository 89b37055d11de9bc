"""Ragged paged-KV attention: the hand-written CUDA kernel and its plain
PyTorch version (counterpart of paddle_tpu/ops/pallas/paged_attention.py,
ragged part).

The serving step packs every row of a launch -- prefill chunks, resumed
chunks, single decode tokens -- as FLAT query tokens.  Each token ``t``
owns a block-table row ``seg[t]`` and sits at absolute position
``rel[t]`` within that row's KV, so causality is ``keypos <= rel[t]`` for
every kind of row, and one launch serves the whole mix.

Layout (the JAX package's, kept at every public function): q
``[Tq, H, D]``; caches ``[num_blocks, H_kv, bs, D]``; block tables
``[R, nblk]`` int32; seg/rel ``[Tq]`` int32.  GQA is native: query head
``h * G + g`` reads kv head ``h`` (G = H / H_kv).

``ragged_paged_attention_segrel_packed`` is the entry the engine calls.
On CUDA tensors it launches the kernel in
``paddle_tpu_torch/csrc/ragged_paged_attention.cu`` (or raises); on CPU
tensors it computes ``ragged_paged_reference_segrel``, the plain version.
``launch_count`` counts kernel launches, so a run can show that its
attention went through the kernel.

int8 pages (``kv_dtype="int8"``): caches ``[num_blocks, H_kv, bs, D]``
int8 with per-page-per-head f32 scales ``[num_blocks, H_kv]`` (float =
int8 * scale).  ``ragged_paged_attention_quant_segrel_packed`` launches
the int8-page kernel of the same ``.cu`` on CUDA tensors and computes
``ragged_paged_reference_quant_segrel`` on CPU tensors; its launches are
counted apart, in ``quant_launch_count``.

Paged decode (``block_multihead_attention``'s decode): one query token per
row, q ``[B, H, D]``, block tables ``[B, nblk]`` and per-row lengths ``[B]``
(valid positions including the fresh token).  ``paged_decode_attention``
clamps the blha convention's -1 table padding into range;
``paged_decode_attention_packed`` launches the decode kernel (the third C
entry of the same ``.cu``) on CUDA tensors and computes
``paged_decode_plain`` on CPU tensors.  Unlike the ragged plain version,
``paged_decode_plain`` repeats the TPU decode kernel's rounding points (q *
scale rounded to q's type, p to the values' type), because that kernel, run
by the Pallas interpreter, is what the JAX package's blha decode runs off
the TPU.  ``paged_decode_reference`` is the JAX package's dense-gather f32
oracle, blha's path for shapes ``supports`` refuses.  Decode launches are
counted in ``decode_launch_count``.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build

__all__ = ["ragged_segments", "decode_window_segments",
           "ragged_paged_reference_segrel",
           "ragged_paged_attention_segrel",
           "ragged_paged_attention_segrel_packed", "ragged_paged_attention",
           "ragged_paged_reference_quant_segrel",
           "ragged_paged_attention_quant_segrel",
           "ragged_paged_attention_quant_segrel_packed",
           "paged_decode_plain", "paged_decode_reference",
           "paged_decode_attention", "paged_decode_attention_packed",
           "supports", "ragged_supports", "launch_count",
           "quant_launch_count",
           "decode_launch_count"]

# kernel launches made by the CUDA route, one count per kernel (plain-
# version calls never count)
launch_count = 0
quant_launch_count = 0
decode_launch_count = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def ragged_segments(cu_seqlens, kv_lens, n_tokens):
    """Derive per-flat-token (seg, rel) from the ragged row layout.

    cu_seqlens [R+1] int32 (row r owns flat tokens cu[r]..cu[r+1]);
    kv_lens [R] int32 (valid KV positions per row AFTER this launch's
    inserts).  Padding tokens past cu[R] get seg == R and rel == 0 so the
    kernel computes a finite garbage row the caller discards.
    """
    cu = cu_seqlens.to(torch.int32)
    kvl = kv_lens.to(torch.int32)
    R = kvl.shape[0]
    tpos = torch.arange(n_tokens, dtype=torch.int32, device=cu.device)
    seg = torch.searchsorted(cu[1:].contiguous(), tpos, right=True,
                             out_int32=True)
    segc = torch.clamp(seg, max=R - 1).long()
    qlen = cu[1:] - cu[:-1]
    rel = torch.where(seg < R, kvl[segc] - qlen[segc] + tpos - cu[segc],
                      torch.zeros_like(tpos))
    return seg, rel.to(torch.int32)


def decode_window_segments(active, kv_lens):
    """Per-iteration (seg, rel) of the device-resident decode window: one
    flat token per batch row, token s in row s.

    active [B] bool (row still decoding); kv_lens [B] int32 (valid KV
    positions AFTER this iteration's insert).  seg is the row index for
    EVERY row, so it never falls (the walk requires a non-decreasing seg
    and writes NaN over the whole output where it falls); a row frozen
    mid-window (eos or budget reached) and an empty slot read position 0
    of their own table row -- in bounds, their outputs discarded.  The
    caller sends only their K/V writes to the null page.  Returns (seg,
    rel) int32 [B] for the packed segrel entries."""
    B = active.shape[0]
    seg = torch.arange(B, dtype=torch.int32, device=active.device)
    rel = torch.where(active, kv_lens.to(torch.int32) - 1,
                      torch.zeros_like(seg))
    return seg, rel


def ragged_paged_reference_segrel(q, key_cache, value_cache, block_tables,
                                  seg, rel):
    """Dense-gather plain version of the kernel (the JAX package's XLA
    oracle, term for term): gather each row's pages, full masked softmax
    in f32, cast to q.dtype."""
    Tq, H, D = q.shape
    _, Hkv, bs, _ = key_cache.shape
    R, nblk = block_tables.shape
    bt = torch.clamp(block_tables.long(), 0, key_cache.shape[0] - 1)
    seg = torch.clamp(seg.long(), 0, R - 1)
    kg = key_cache[bt].permute(0, 1, 3, 2, 4).reshape(
        R, nblk * bs, Hkv, D)                  # [R, S, Hkv, D]
    vg = value_cache[bt].permute(0, 1, 3, 2, 4).reshape(
        R, nblk * bs, Hkv, D)
    kq = kg[seg]                               # [Tq, S, Hkv, D]
    vq = vg[seg]
    if Hkv != H:
        g = H // Hkv
        kq = torch.repeat_interleave(kq, g, dim=2)
        vq = torch.repeat_interleave(vq, g, dim=2)
    sm_scale = 1.0 / (D ** 0.5)
    scores = torch.einsum("qhd,qshd->qhs", q.float(), kq.float()) * sm_scale
    keypos = torch.arange(nblk * bs, dtype=torch.int32, device=q.device)
    mask = keypos[None, None, :] <= rel.to(torch.int32)[:, None, None]
    scores = torch.where(mask, scores, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("qhs,qshd->qhd", probs, vq.float())
    return out.to(q.dtype)


def _check_operands(q, key_cache, value_cache, block_tables, vectors,
                    key_scales=None, value_scales=None,
                    kind="ragged paged attention kernel"):
    """Shape/dtype/contiguity contract of the kernels; raises ValueError
    on anything they do not take.  ``vectors`` names the int32 [q.shape[0]]
    operands (seg and rel, or the decode kernel's lengths).  With scales
    given, the contract of the int8-page kernel: int8 caches and f32
    [num_blocks, H_kv] scales."""
    quant = key_scales is not None
    if quant:
        kind = "int8-page " + kind

    def need(ok, what):
        if not ok:
            raise ValueError(f"{kind}: {what}")

    need(q.dim() == 3, f"q must be [Tq, H, D], got {tuple(q.shape)}")
    need(key_cache.dim() == 4 and key_cache.shape == value_cache.shape,
         "caches must both be [num_blocks, H_kv, bs, D], got "
         f"{tuple(key_cache.shape)} and {tuple(value_cache.shape)}")
    Tq, H, D = q.shape
    NB, Hkv, bs, Dc = key_cache.shape
    need(q.dtype in _DTYPES, f"q dtype {q.dtype} not in float32/bfloat16")
    cache_dtype = torch.int8 if quant else q.dtype
    need(key_cache.dtype == cache_dtype and value_cache.dtype == cache_dtype,
         f"cache dtypes {key_cache.dtype}/{value_cache.dtype} must be "
         f"{cache_dtype}")
    need(Dc == D, f"cache head dim {Dc} differs from q's {D}")
    need(D >= 1 and bs >= 1, f"empty head dim or page (D={D}, bs={bs})")
    need(H >= 1 and Hkv >= 1 and ragged_supports(H, Hkv, D, bs),
         f"H={H}, H_kv={Hkv}, D={D}, bs={bs} outside the rule: H a multiple "
         "of H_kv, D 64 or a multiple of 128, bs a multiple of 8")
    need(block_tables.dim() == 2 and block_tables.dtype == torch.int32,
         f"block_tables must be int32 [R, nblk], got {block_tables.dtype} "
         f"{tuple(block_tables.shape)}")
    for name, x in vectors.items():
        need(x.dtype == torch.int32 and x.shape == (Tq,),
             f"{name} must be int32 [{Tq}], got {x.dtype} {tuple(x.shape)}")
    named = [("q", q), ("key_cache", key_cache), ("value_cache", value_cache),
             ("block_tables", block_tables), *vectors.items()]
    if quant:
        for name, x in (("key_scales", key_scales),
                        ("value_scales", value_scales)):
            need(x.dtype == torch.float32 and x.shape == (NB, Hkv),
                 f"{name} must be float32 [{NB}, {Hkv}], got {x.dtype} "
                 f"{tuple(x.shape)}")
        named += [("key_scales", key_scales), ("value_scales", value_scales)]
    for name, x in named:
        need(x.is_contiguous(), f"{name} must be contiguous")
    devs = {x.device for _, x in named}
    need(len(devs) == 1, f"operands on several devices: {devs}")
    need(q.device.type != "cuda" or not any(
        x.data_ptr() % 16 for x in (key_cache, value_cache)),
        "caches must be 16-byte aligned")


# The walk's plan (csrc/ragged_paged_attention.cu, paged_walk_kernel): a
# tile of at most 8 rows splits its keys in pieces of about split_keys --
# the tuning cache's "paged_attention" entry for the shape, _SPLIT_KEYS
# without one -- and a launch's f32 split scratch stays under
# _SCRATCH_BYTES
_SPLIT_KEYS = 512
_SCRATCH_BYTES = 32 << 20

# per (device, stream): the walk's int32 counters (the splits' [tiles,
# H_kv], then the item queue's two), zeroed when allocated or grown --
# every launch leaves them at zero -- and its f32 split scratch.  Launches
# on one stream run in order, so no two launches share them at once.
_workspace: dict = {}


def _specialised(H, Hkv, D) -> bool:
    """The shapes the walk takes (the C entries' ``specialised``): D 64 or
    128 and G = H / H_kv <= 8; paged_attention_any_kernel takes the rest."""
    return D in (64, 128) and H // Hkv <= 8


@functools.lru_cache(maxsize=1024)
def _walk_plan(Tq, H, Hkv, D, bs, R, nblk, dtype, quant=False,
               decode=False, split_keys=_SPLIT_KEYS):
    """The walk's launch plan, computed on the host from shapes alone (no
    device op; cached, as a step's layers repeat one shape):
    ``(TT, split, nsplit, ntiles_max)``.

    TT: tokens of a query tile -- 64 / G for bfloat16 q (tiles of more
    than 8 rows run on the tensor cores), 8 / G for float32 (at least 1),
    1 for the decode entry.  split: keys of a split, a multiple of the
    kernel's stage (64 keys, 128 for int8 pages, 32 for float32), about
    ``split_keys``.  nsplit: splits of the longest row (nblk * bs keys).
    ntiles_max: a bound on the tiles of a launch whose seg is
    non-decreasing: each run of equal seg (at most min(R + 1, Tq) of them)
    gives ceil(run / TT) tiles.  The split scratch [ntiles_max, H_kv,
    nsplit, 8, D + 2] f32 stays under _SCRATCH_BYTES (fewer, longer splits
    where it would not)."""
    G = H // Hkv
    kt = 128 if quant else (32 if dtype == torch.float32 else 64)
    if decode:
        tt, ntiles = 1, Tq
    else:
        tt = 64 // G if dtype == torch.bfloat16 else max(1, 8 // G)
        ntiles = min(Tq, -(-Tq // tt) + min(R + 1, Tq))
    ntiles = max(ntiles, 1)
    cap = nblk * bs
    per_split = ntiles * Hkv * 8 * (D + 2) * 4
    nsplit = max(1, min(-(-cap // split_keys), _SCRATCH_BYTES // per_split))
    split = -(-(-(-cap // nsplit)) // kt) * kt
    return tt, split, -(-cap // split), ntiles


@functools.lru_cache(maxsize=1024)
def _tuned_split_keys(epoch, tq, kv_heads, head_dim, page, nblk, dtype,
                      default):
    """keys a split for one launch shape: the tuning cache's answer (the
    JAX package's shape key; ``epoch`` is ``tune.config_epoch()``, so a
    changed cache or lever is looked up again, and no launch reads a
    file), ``default`` without one.  A split changes where the walk
    merges its online-softmax partials, so the order of the sums."""
    from ..tune import kernel_config
    cfg = kernel_config("paged_attention",
                        {"tq": tq, "kv_heads": kv_heads,
                         "head_dim": head_dim, "page": page, "nblk": nblk,
                         "dtype": dtype}, {"split_keys": default})
    return max(1, int(cfg["split_keys"]))


def _split_keys(Tq, Hkv, D, bs, nblk, dtype, quant):
    from ..tune import config_epoch
    name = "int8" if quant else str(dtype).split(".")[-1]
    return _tuned_split_keys(config_epoch(), Tq, Hkv, D, bs, nblk, name,
                             _SPLIT_KEYS)


def _walk_workspace(device, stream, n_cnt, n_part):
    """The walk's (counters, scratch) on ``stream`` of ``device``: at least
    n_cnt int32 counters, zero between launches, and n_part f32."""
    cnt, part = _workspace.get((device, stream), (None, None))
    if cnt is None or cnt.numel() < n_cnt:
        cnt = torch.zeros(max(n_cnt, 1024), dtype=torch.int32,
                          device=device)
    if part is None or part.numel() < n_part:
        part = torch.empty(n_part, dtype=torch.float32, device=device)
    _workspace[device, stream] = cnt, part
    return cnt, part


def _launch(entry, q, key_cache, value_cache, block_tables, vectors,
            scales=()):
    """Launch one of the three CUDA entries on PyTorch's current stream:
    ``vectors`` are the int32 operands after the block table (seg and
    rel, or lengths).  Allocates the output with ``torch.empty`` and takes
    the walk's counters and split scratch from the stream's workspace (no
    device op but the counters' one zeroing).  Raises on CPU tensors and
    on a refused launch (the C entry returns ``cudaGetLastError()``, or
    the error of encoding a tensor map or of raising the block's
    shared-memory limit)."""
    if q.device.type != "cuda":
        raise RuntimeError(
            "the paged attention kernels run on CUDA tensors only; "
            f"got {q.device} (the plain version serves CPU tensors)")
    decode = len(vectors) == 1
    fn = getattr(_build.library("ragged_paged_attention"), entry)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * (7 + len(scales) + len(vectors)) \
            + [ctypes.c_int] * (10 if decode else 13) + \
            [ctypes.c_float, ctypes.c_void_p]
    Tq, H, D = q.shape
    NB, Hkv, bs, _ = key_cache.shape
    R, nblk = block_tables.shape
    out = torch.empty_like(q)
    tt, split, nsplit, ntiles = _walk_plan(
        Tq, H, Hkv, D, bs, R, nblk, q.dtype, bool(scales), decode,
        _split_keys(Tq, Hkv, D, bs, nblk, q.dtype, bool(scales)))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        cnt = part = 0
        if _specialised(H, Hkv, D):
            c, p = _walk_workspace(q.device, stream, ntiles * Hkv + 2,
                                   ntiles * Hkv * nsplit * 8 * (D + 2)
                                   if nsplit > 1 else 1)
            cnt, part = c.data_ptr(), p.data_ptr()
        ptrs = [q.data_ptr(), key_cache.data_ptr(),
                value_cache.data_ptr()] + [x.data_ptr() for x in scales] + \
            [block_tables.data_ptr()] + [x.data_ptr() for x in vectors] + \
            [out.data_ptr(), part, cnt]
        if decode:
            dims = [Tq, H, Hkv, D, bs, NB, nblk, split, nsplit]
        else:
            dims = [Tq, H, Hkv, D, bs, NB, R, nblk, tt, split, nsplit,
                    ntiles]
        err = fn(*ptrs, *dims, _DTYPES[q.dtype], 1.0 / (D ** 0.5), stream)
    if err != 0:
        raise RuntimeError(f"paged attention kernel {entry} launch failed: "
                           f"CUDA error {err}")
    return out


def _launch_kernel(q, key_cache, value_cache, block_tables, seg, rel):
    """Launch the float CUDA kernel.  Raises on an operand it does not
    take, on CPU tensors, on a failed build and on a refused launch."""
    global launch_count
    _check_operands(q, key_cache, value_cache, block_tables,
                    {"seg": seg, "rel": rel})
    out = _launch("paddle_ragged_paged_attention", q, key_cache,
                  value_cache, block_tables, (seg, rel))
    launch_count += 1
    return out


def _launch_quant_kernel(q, key_cache, value_cache, key_scales,
                         value_scales, block_tables, seg, rel):
    """Launch the int8-page CUDA kernel (same refusals as
    ``_launch_kernel``, plus int8 caches and f32 scales)."""
    global quant_launch_count
    _check_operands(q, key_cache, value_cache, block_tables,
                    {"seg": seg, "rel": rel}, key_scales, value_scales)
    out = _launch("paddle_ragged_paged_attention_q8", q, key_cache,
                  value_cache, block_tables, (seg, rel),
                  (key_scales, value_scales))
    quant_launch_count += 1
    return out


def _launch_decode_kernel(q, key_cache, value_cache, block_tables, lengths):
    """Launch the paged decode CUDA kernel: the ragged kernel's refusals,
    with one table row per query row and int32 lengths in place of
    seg/rel."""
    global decode_launch_count
    _check_operands(q, key_cache, value_cache, block_tables,
                    {"lengths": lengths}, kind="paged decode kernel")
    if block_tables.shape[0] != q.shape[0]:
        raise ValueError(f"paged decode kernel: block_tables has "
                         f"{block_tables.shape[0]} rows for {q.shape[0]} "
                         "queries")
    out = _launch("paddle_paged_decode_attention", q, key_cache, value_cache,
                  block_tables, (lengths,))
    decode_launch_count += 1
    return out


def ragged_paged_attention_segrel_packed(q, key_cache, value_cache,
                                         block_tables, seg, rel):
    """The engine's entry: ragged attention with precomputed (seg, rel),
    for callers that guarantee the packing invariant (int32 operands,
    table entries in [0, num_blocks), seg naming a real table row and
    non-decreasing, as ``ragged_segments`` gives it -- the engine's
    [B+1]-row table makes the pad sentinel B its null row, last).  Where
    seg falls, the walk writes NaN over the whole output.

    CUDA tensors go through the CUDA kernel (which raises on an operand it
    does not take); CPU tensors take the plain version.  Returns
    [Tq, H, D] in q.dtype."""
    if q.device.type == "cuda":
        return _launch_kernel(q, key_cache, value_cache, block_tables, seg,
                              rel)
    return ragged_paged_reference_segrel(q, key_cache, value_cache,
                                         block_tables, seg, rel)


def _segrel(packed, q, key_cache, value_cache, block_tables, seg, rel,
            scales=(), ordered=False):
    """The unpacked entries' common part: clamp the table entries (blha -1
    padding) and seg into range, cast to int32, order the tokens by seg
    (unless ``ordered``: seg is non-decreasing already, as
    ``ragged_segments`` gives it), call ``packed`` and hand the outputs
    back in the caller's order."""
    R = block_tables.shape[0]
    block_tables = torch.clamp(block_tables.to(torch.int32), 0,
                               key_cache.shape[0] - 1).contiguous()
    seg = torch.clamp(seg.to(torch.int32), 0, R - 1)
    rel = rel.to(torch.int32)
    scales = tuple(x.float().contiguous() for x in scales)
    if ordered:
        return packed(q.contiguous(), key_cache, value_cache, *scales,
                      block_tables, seg.contiguous(), rel.contiguous())
    order = torch.argsort(seg, stable=True)
    out = packed(q[order].contiguous(), key_cache, value_cache, *scales,
                 block_tables, seg[order].contiguous(),
                 rel[order].contiguous())
    res = torch.empty_like(out)
    res[order] = out
    return res


def ragged_paged_attention_segrel(q, key_cache, value_cache, block_tables,
                                  seg, rel):
    """Ragged attention with precomputed (seg, rel) per flat token.

    q [Tq, H, D]; caches [num_blocks, H_kv, bs, D]; block_tables [R, nblk];
    seg [Tq] in [0, R] (R == padding sentinel), in any order; rel [Tq].
    Clamps table entries (blha -1 padding) and seg into range, casts to
    int32 and orders the tokens by seg before the packed entry.  Returns
    [Tq, H, D]."""
    return _segrel(ragged_paged_attention_segrel_packed, q, key_cache,
                   value_cache, block_tables, seg, rel)


def ragged_paged_attention(q, key_cache, value_cache, block_tables,
                           cu_seqlens, kv_lens):
    """One ragged launch over flat query tokens from mixed-phase rows.

    q [Tq, H, D] (rows packed back-to-back, tail padding allowed);
    cu_seqlens [R+1]; kv_lens [R] (valid KV per row AFTER this launch's
    inserts -- a row's queries sit at its LAST kv_lens positions).
    Returns [Tq, H, D]; padding rows are finite garbage."""
    seg, rel = ragged_segments(cu_seqlens, kv_lens, q.shape[0])
    return _segrel(ragged_paged_attention_segrel_packed, q, key_cache,
                   value_cache, block_tables, seg, rel, ordered=True)


def ragged_paged_reference_quant_segrel(q, key_cache, value_cache,
                                        key_scales, value_scales,
                                        block_tables, seg, rel):
    """Plain version of the int8-page kernel: dequantize the whole pool
    densely (float = int8 * scale, the math the kernel applies per page)
    and call the float plain version."""
    kd = key_cache.float() * key_scales.float()[:, :, None, None]
    vd = value_cache.float() * value_scales.float()[:, :, None, None]
    return ragged_paged_reference_segrel(q, kd, vd, block_tables, seg, rel)


def ragged_paged_attention_quant_segrel_packed(q, key_cache, value_cache,
                                               key_scales, value_scales,
                                               block_tables, seg, rel):
    """The int8-KV engine's entry, under the packing invariant of
    ``ragged_paged_attention_segrel_packed`` plus f32 scale pools.  CUDA
    tensors go through the int8-page kernel (which raises on an operand it
    does not take); CPU tensors take the plain version.  Returns
    [Tq, H, D] in q.dtype."""
    if q.device.type == "cuda":
        return _launch_quant_kernel(q, key_cache, value_cache, key_scales,
                                    value_scales, block_tables, seg, rel)
    return ragged_paged_reference_quant_segrel(
        q, key_cache, value_cache, key_scales, value_scales, block_tables,
        seg, rel)


def ragged_paged_attention_quant_segrel(q, key_cache, value_cache,
                                        key_scales, value_scales,
                                        block_tables, seg, rel):
    """Ragged attention over int8 KV pages with per-page-per-head scales.

    q [Tq, H, D] float; caches [num_blocks, H_kv, bs, D] int8;
    key_scales/value_scales [num_blocks, H_kv] (float = int8 * scale);
    block_tables [R, nblk]; seg/rel as in ``ragged_paged_attention_segrel``
    (clamped, cast and ordered the same way).  Returns [Tq, H, D] in
    q.dtype."""
    return _segrel(ragged_paged_attention_quant_segrel_packed, q,
                   key_cache, value_cache, block_tables, seg, rel,
                   (key_scales, value_scales))


# ---------------------------------------------------------------------------
# paged decode (blha)
# ---------------------------------------------------------------------------

def _gather_pages(cache, block_tables):
    """The pages [num_blocks, H_kv, bs, D] of each row's table, in table
    order -> [B, H_kv, nblk * bs, D]."""
    B, nblk = block_tables.shape
    _, Hkv, bs, D = cache.shape
    return cache[block_tables.long()].permute(0, 2, 1, 3, 4).reshape(
        B, Hkv, nblk * bs, D)


def paged_decode_plain(q, key_cache, value_cache, block_tables, lengths):
    """Plain version of the decode kernel, with the TPU decode kernel's
    rounding points: q * (1 / sqrt(D)) rounded to q's type, scores and the
    PV product in f32, p rounded to the values' type before the PV product
    (the row sum takes the unrounded p), output acc / l in q's type.
    Returns [B, H, D]."""
    B, H, D = q.shape
    Hkv = key_cache.shape[1]
    bt = torch.clamp(block_tables.long(), 0, key_cache.shape[0] - 1)
    k = _gather_pages(key_cache, bt).float()      # the kernel clamps too
    v = _gather_pages(value_cache, bt)
    qs = (q.float() * (1.0 / (D ** 0.5))).to(q.dtype).float()
    s = torch.einsum("bhgd,bhsd->bhgs", qs.reshape(B, Hkv, H // Hkv, D), k)
    pos = torch.arange(k.shape[2], device=q.device)
    keep = pos[None, :] < lengths.to(q.device).long()[:, None]
    s = torch.where(keep[:, None, None, :], s, float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    acc = torch.einsum("bhgs,bhsd->bhgd", p.to(v.dtype).float(), v.float())
    return (acc / p.sum(-1, keepdim=True)).reshape(B, H, D).to(q.dtype)


def paged_decode_reference(q, key_cache, value_cache, block_tables,
                           lengths):
    """The JAX package's dense-gather oracle, term for term: gather each
    row's pages, one masked softmax in f32, output in q's type."""
    B, H, D = q.shape
    Hkv = key_cache.shape[1]
    ks = _gather_pages(key_cache, block_tables)
    vs = _gather_pages(value_cache, block_tables)
    if Hkv != H:
        ks = torch.repeat_interleave(ks, H // Hkv, dim=1)
        vs = torch.repeat_interleave(vs, H // Hkv, dim=1)
    scores = torch.einsum("bhd,bhmd->bhm", q.float(), ks.float()) / \
        math.sqrt(D)
    pos = torch.arange(ks.shape[2], device=q.device)[None, None, :]
    scores = torch.where(pos < lengths.to(q.device)[:, None, None], scores,
                         float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhm,bhmd->bhd", probs, vs.float()).to(q.dtype)


def paged_decode_attention_packed(q, key_cache, value_cache, block_tables,
                                  lengths):
    """Decode without the table clamp and casts, for callers that pass
    int32 operands with every table entry in [0, num_blocks).  CUDA
    tensors go through the decode kernel (which raises on an operand it
    does not take); CPU tensors take ``paged_decode_plain``.  Returns
    [B, H, D] in q.dtype."""
    if q.device.type == "cuda":
        return _launch_decode_kernel(q, key_cache, value_cache, block_tables,
                                     lengths)
    return paged_decode_plain(q, key_cache, value_cache, block_tables,
                              lengths)


def paged_decode_attention(q, key_cache, value_cache, block_tables,
                           lengths):
    """One-token-per-sequence decode over paged KV.

    q [B, H, D]; caches [num_blocks, H_kv, bs, D]; block_tables [B, nblk];
    lengths [B] (valid positions including the fresh token).  Clamps the
    blha convention's -1 table padding into range and casts the tables
    and lengths to int32 before the packed entry.  Returns [B, H, D]."""
    block_tables = torch.clamp(block_tables.to(torch.int32), 0,
                               key_cache.shape[0] - 1).contiguous()
    return paged_decode_attention_packed(
        q.contiguous(), key_cache, value_cache, block_tables,
        lengths.to(torch.int32).contiguous())


def supports(B, H, Hkv, D, bs) -> bool:
    """The JAX package's shape rule for its decode kernel (without its
    lowering probe): H a multiple of H_kv, D 64 or a multiple of 128, bs a
    multiple of 8.  Where it holds, blha decodes through
    ``paged_decode_attention`` (whose CUDA kernel takes every such shape in
    float32/bfloat16); elsewhere through ``paged_decode_reference``."""
    return H % Hkv == 0 and (D % 128 == 0 or D == 64) and bs % 8 == 0


def ragged_supports(H, Hkv, D, bs) -> bool:
    """The JAX package's shape rule for its ragged kernels, float and
    int8-page (without the lowering probe): H and H_kv at least 1, H a
    multiple of H_kv, D 64 or a multiple of 128, bs a multiple of 8.  The
    three CUDA kernels take exactly these shapes (``_check_operands``):
    D in {64, 128} with G = H / H_kv <= 8 on their specialised kernels,
    every other shape on the kernel that splits G and D over blocks."""
    if H < 1 or Hkv < 1 or H % Hkv != 0:
        return False
    return (D % 128 == 0 or D == 64) and bs % 8 == 0
