"""Varlen (unpadded) flash attention, forward and backward: three
hand-written CUDA kernels, their plain PyTorch versions and the autograd
Function that ties them (counterpart of
paddle_tpu/ops/pallas/flash_attention_varlen.py).

Layout (the JAX package's, kept at every public function): sequences
concatenated along the token axis, q ``[Tq, H, D]``, k and v ``[Tk, H,
D]``, delimited by cumulative offsets ``cu_q`` / ``cu_k`` (``[nseq + 1]``
int32).  Every token carries (segment, position in segment); query i sees
key j when their segments are equal (and, under ``causal``, rel_i >=
rel_j).  Tokens past ``cu[-1]`` of a side keep the segment ``nseq``;
tile padding past T takes the sentinel ``nseq`` (queries) or ``nseq + 1``
(keys), so padding never matches padding.  ``lse`` is ``[H, Tq]`` float32
(the JAX package keeps ``[H, 1, pad_q]``).

The rounding points are those of the varlen TPU kernels, which differ from
the fixed-length ones: the scale multiplies the f32 score (q is never
pre-scaled or rounded), p is rounded to v's type before the PV product (the
row sum l takes the unrounded p), dS = p * (dP - delta) * scale is rounded
to q's (k's) type for dK (dQ), and delta = rowsum(dO * O) is f32.  A query
row with no key gives output 0 and lse -inf; the backward reads such an
lse as 0 (its p is 0 wherever it is masked).

``varlen_attention`` applies ``VarlenAttention``.  On CUDA tensors its
forward launches the forward kernel and its backward the dK/dV and dQ
kernels of ``paddle_tpu_torch/csrc/flash_attention_varlen.cu`` (bf16 at D
64 and 128 on ``wgmma`` fed by TMA, 128 rows a block, launched in
``launch_order``; it raises on what they do not take); on CPU tensors both
run the plain versions.
``use_varlen_kernel`` is the JAX package's shape rule (``use_varlen_flash``
without its flag, probe and interpreter branch): shapes it refuses take the
segment-masked composition, as the JAX package routes them.
``fwd_launch_count``, ``dkdv_launch_count`` and ``dq_launch_count`` count
kernel launches, one per launch.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

__all__ = ["varlen_attention", "VarlenAttention", "use_varlen_kernel",
           "segments",
           "varlen_fwd_reference", "varlen_bwd_reference",
           "varlen_bwd_dkdv_reference", "varlen_bwd_dq_reference",
           "varlen_delta", "pair_tiles", "launch_order", "fwd_launch_count",
           "dkdv_launch_count", "dq_launch_count"]

fwd_launch_count = 0
dkdv_launch_count = 0
dq_launch_count = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128, 256)
# rows of the tile a block owns (queries in the forward and dQ, keys in
# dK/dV); the tiles it walks are 64 rows too, 32 at D = 256 (the CUDA-core
# kernels' shared memory)
TILE = 64
# rows a block of the wgmma kernels (bf16 at D 64 and 128: queries in the
# forward and dQ, keys in dK/dV): two warpgroups of 64 rows
WGMMA_BLOCK_Q = 128
LOG2E = 1.4426950408889634


def walk_tile(head_dim: int) -> int:
    return 32 if head_dim == 256 else TILE


def fwd_block_q(q, k=None) -> int:
    """Rows a block of the kernels that take q (queries in the forward and
    dQ, keys in dK/dV): one instantiation a (dtype, head dim), so the
    tuning cache's ``block_q`` (``tune/``, a one-value space at every
    shape) can only confirm it."""
    from ..tune import config_epoch
    return _tuned_block_q(config_epoch(), q.shape[0],
                          q.shape[0] if k is None else k.shape[0],
                          q.shape[2], q.dtype)


@functools.lru_cache(maxsize=1024)
def _tuned_block_q(epoch, Tq, Tk, D, dtype):
    from ..tune import kernel_config
    kernel_config("flash_attention_varlen",
                  {"seq_q": Tq, "seq_k": Tk, "head_dim": D,
                   "dtype": str(dtype).split(".")[-1]})
    return WGMMA_BLOCK_Q if dtype == torch.bfloat16 and D <= 128 else TILE


# ---------------------------------------------------------------------------
# segment metadata and block bounds (torch ops on the tensors' device)
# ---------------------------------------------------------------------------

def _segment_ids(cu, pos):
    """Index of the ``[cu[i], cu[i + 1])`` interval holding each position
    (``nseq`` past ``cu[-1]``), int32: the one segment rule of the varlen
    kernels' metadata, the segment-masked composition and blha's
    prefill."""
    return torch.searchsorted(cu, pos, right=True, out_int32=True) - 1


def segments(cu, n):
    """Segment id (``_segment_ids``) and position within it of each of n
    tokens, both int32."""
    cu = cu.to(torch.int32)
    pos = torch.arange(n, dtype=torch.int32, device=cu.device)
    seg = _segment_ids(cu, pos)
    return seg, pos - cu[seg.long()]


def _segment_meta(cu, total, pad_to, pad_seg):
    """seg[pad_to] (rows at or past ``total`` get ``pad_seg``) and
    rel[pad_to], both int32; rel counts from the last sequence's start
    past ``cu[-1]``, as the JAX package's.  Few device ops: the forward
    kernel's wrapper runs this on every call."""
    cu = cu.to(torch.int32)
    pos = torch.arange(pad_to, dtype=torch.int32, device=cu.device)
    seg = _segment_ids(cu, pos)
    if pad_to > total:
        seg = torch.where(pos < total, seg, pad_seg)
    return seg, pos - cu.index_select(0, seg.clamp(0, cu.shape[0] - 2))


def _clip_bounds(lo, hi, n):
    lo = torch.clamp(lo, 0, n)
    return lo.to(torch.int32), torch.maximum(hi, lo).clamp(max=n).to(
        torch.int32)


def _block_bounds_q(seg_q, rel_q, cu_k, block_q, block_k, nkb, causal):
    """Per query block, the range [lo, hi) of key blocks it must walk
    (int32 [nqb])."""
    cu_k = cu_k.to(torch.int32)
    nseq = cu_k.shape[0] - 1
    valid = seg_q < nseq                       # pad rows contribute nothing
    seg_c = torch.clamp(seg_q, 0, nseq - 1)
    start = cu_k.index_select(0, seg_c)
    row_lo = torch.where(valid, start, 2 ** 30)
    if causal:
        row_hi = torch.where(valid, start + rel_q + 1, 0)
    else:
        row_hi = torch.where(valid, cu_k.index_select(0, seg_c + 1), 0)
    nqb = seg_q.shape[0] // block_q
    lo = row_lo.reshape(nqb, block_q).amin(1) // block_k
    hi = (row_hi.reshape(nqb, block_q).amax(1) + block_k - 1) // block_k
    return _clip_bounds(lo, hi, nkb)


def _block_bounds_k(seg_k, rel_k, cu_q, block_q, block_k, nqb, causal):
    """Per key block, the range [lo, hi) of query blocks it must walk
    (int32 [nkb])."""
    cu_q = cu_q.to(torch.int32)
    nseq = cu_q.shape[0] - 1
    valid = seg_k < nseq
    seg_c = torch.clamp(seg_k, 0, nseq - 1).long()
    if causal:
        row_lo = torch.where(valid, cu_q[seg_c] + rel_k, 2 ** 30)
    else:
        row_lo = torch.where(valid, cu_q[seg_c], 2 ** 30)
    row_hi = torch.where(valid, cu_q[seg_c + 1], 0)
    nkb = seg_k.shape[0] // block_k
    lo = row_lo.reshape(nkb, block_k).amin(1) // block_q
    hi = -(-row_hi.reshape(nkb, block_k).amax(1) // block_q)
    return _clip_bounds(lo, hi, nqb)


def pair_tiles(lo, hi):
    """Tiles each block of two 64-row tiles walks, from the tiles' ranges
    [lo, hi): the span of the union of its non-empty ones (0 when both are
    empty).  The wgmma kernels' blocks, 128 rows each (key tiles of 128
    queries in the forward and dQ, query tiles of 128 keys in dK/dV)."""
    lo2, hi2 = lo.view(-1, 2), hi.view(-1, 2)
    some = hi2 > lo2
    top = torch.where(some, hi2, 0).amax(1)
    return top - torch.where(some, lo2, top[:, None]).amin(1)


def launch_order(tiles):
    """The order in which a wgmma kernel launches its blocks: most tiles
    first, ties by block index (an int32 permutation, computed on the
    device of ``tiles``)."""
    return torch.argsort(tiles, descending=True, stable=True).to(
        torch.int32)


def _prep(tq, tk, cu_q, cu_k, block_q=TILE, block_k=TILE):
    """The kernels' segment metadata: seg/rel of queries and keys, padded
    to multiples of ``block_q`` and ``block_k`` rows with the sentinel
    segments (queries ``nseq``, keys ``nseq + 1``).  The kernels read q, k
    and v unpadded and treat rows past T as zeros, so no token is copied
    (the JAX package's ``_pad_tokens`` has no counterpart)."""
    nseq = cu_q.shape[0] - 1
    pad_q = -(-tq // block_q) * block_q
    pad_k = -(-tk // block_k) * block_k
    return (*_segment_meta(cu_q, tq, pad_q, nseq),
            *_segment_meta(cu_k, tk, pad_k, nseq + 1))


def _bwd_meta(q, k, cu_q, cu_k, causal):
    """What both backward kernels read, computed once a backward: ``(seg_q,
    rel_q, seg_k, rel_k, lo_k, hi_k, lo_q, hi_q)``.  ``lo_k``/``hi_k``:
    the query tiles each 64-key tile walks (dK/dV), ``lo_q``/``hi_q``: the
    key tiles each 64-query tile walks (dQ); tiles of 64 rows, walked tiles
    of 32 at D 256.  The wgmma kernels (bf16 at D 64 and 128) own 128 rows
    a block, so their metadata is padded to whole 128-row blocks on both
    sides and each ``lo`` carries after the ranges the launch order of its
    blocks (``launch_order`` over ``pair_tiles``)."""
    blk = fwd_block_q(q, k)
    meta = _prep(q.shape[0], k.shape[0], cu_q, cu_k, blk, blk)
    bt = walk_tile(q.shape[2])
    lo_k, hi_k = _block_bounds_k(meta[2], meta[3], cu_q, bt, TILE,
                                 meta[0].shape[0] // bt, causal)
    lo_q, hi_q = _block_bounds_q(meta[0], meta[1], cu_k, TILE, bt,
                                 meta[2].shape[0] // bt, causal)
    if blk == WGMMA_BLOCK_Q:
        lo_k = torch.cat([lo_k, launch_order(pair_tiles(lo_k, hi_k))])
        lo_q = torch.cat([lo_q, launch_order(pair_tiles(lo_q, hi_q))])
    return (*meta, lo_k, hi_k, lo_q, hi_q)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _round(x, dtype):
    """x (f32) rounded to ``dtype`` and back: a rounding point of the
    kernels."""
    return x.to(dtype).float()


def _scores(q, k, cu_q, cu_k, causal, scale):
    """f32 scores ``[H, Tq, Tk]`` = (q . k) * scale, -inf where a query
    may not see a key."""
    nseq = cu_q.shape[0] - 1
    seg_q, rel_q = _segment_meta(cu_q, q.shape[0], q.shape[0], nseq)
    seg_k, rel_k = _segment_meta(cu_k, k.shape[0], k.shape[0], nseq + 1)
    keep = seg_q[:, None] == seg_k[None, :]
    if causal:
        keep &= rel_q[:, None] >= rel_k[None, :]
    s = torch.einsum("qhd,khd->hqk", q.float(), k.float()) * scale
    return torch.where(keep[None], s, float("-inf"))


def varlen_fwd_reference(q, k, v, cu_q, cu_k, causal, scale):
    """Plain version of the forward kernel: ``(out [Tq, H, D] in q.dtype,
    lse [H, Tq] f32)``."""
    s = _scores(q, k, cu_q, cu_k, causal, scale)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - torch.where(torch.isneginf(m), 0.0, m))
    l = p.sum(-1, keepdim=True)
    acc = torch.einsum("hqk,khd->hqd", _round(p, v.dtype), v.float())
    has = l > 0
    l1 = torch.where(has, l, 1.0)
    out = torch.where(has, acc / l1, 0.0).permute(1, 0, 2).to(q.dtype)
    lse = torch.where(has, m + torch.log(l1), float("-inf"))[..., 0]
    return out, lse


def varlen_delta(out, do):
    """delta = rowsum(dO * O) in f32, ``[H, Tq]`` (computed outside the
    kernels, as the JAX package does)."""
    return (do * out.float()).sum(-1).t().contiguous()


def _probs_and_ds(q, k, v, lse, delta, do, cu_q, cu_k, causal, scale):
    """Recomputed p and dS = p * (dP - delta) * scale, ``[H, Tq, Tk]``
    f32; a row whose lse is not finite (no key) reads it as 0."""
    s = _scores(q, k, cu_q, cu_k, causal, scale)
    lse_safe = torch.where(torch.isfinite(lse), lse, 0.0)
    p = torch.exp(s - lse_safe[..., None])
    dp = torch.einsum("qhd,khd->hqk", do.float(), v.float())
    return p, p * (dp - delta[..., None]) * scale


def varlen_bwd_dkdv_reference(q, k, v, do, lse, delta, cu_q, cu_k, causal,
                              scale):
    """Plain version of the dK/dV kernel: ``(dk, dv)`` in k's and v's
    types."""
    p, ds = _probs_and_ds(q, k, v, lse, delta, do, cu_q, cu_k, causal,
                          scale)
    dv = torch.einsum("hqk,qhd->khd", _round(p, do.dtype), do.float())
    dk = torch.einsum("hqk,qhd->khd", _round(ds, q.dtype), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def varlen_bwd_dq_reference(q, k, v, do, lse, delta, cu_q, cu_k, causal,
                            scale):
    """Plain version of the dQ kernel: dq in q.dtype."""
    _, ds = _probs_and_ds(q, k, v, lse, delta, do, cu_q, cu_k, causal,
                          scale)
    return torch.einsum("hqk,khd->qhd", _round(ds, k.dtype),
                        k.float()).to(q.dtype)


def varlen_bwd_reference(q, k, v, out, lse, do, cu_q, cu_k, causal, scale):
    """Plain version of the whole backward: ``(dq, dk, dv)``."""
    delta = varlen_delta(out, do)
    dk, dv = varlen_bwd_dkdv_reference(q, k, v, do, lse, delta, cu_q, cu_k,
                                       causal, scale)
    return (varlen_bwd_dq_reference(q, k, v, do, lse, delta, cu_q, cu_k,
                                    causal, scale), dk, dv)


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------

def use_varlen_kernel(q, k) -> bool:
    """The JAX package's shape rule for its varlen kernels: 3-D inputs,
    equal head dims and head counts (GQA takes the composition), D in
    {64, 128, 256}, float32 or bfloat16.  Decided from shapes alone."""
    return (q.dim() == 3 and k.dim() == 3 and q.shape[2] == k.shape[2]
            and q.shape[1] == k.shape[1] and q.shape[2] in HEAD_DIMS
            and q.dtype in _DTYPES)


def _check_operands(q, k, v, cu_q, cu_k, do=None, lse=None, delta=None):
    """The kernels' contract; raises ValueError on anything they do not
    take."""
    def need(ok, what):
        if not ok:
            raise ValueError(f"varlen flash attention kernel: {what}")

    need(q.dim() == 3 and k.dim() == 3 and v.shape == k.shape,
         f"q must be [Tq, H, D] and k, v [Tk, H, D], got {tuple(q.shape)}, "
         f"{tuple(k.shape)}, {tuple(v.shape)}")
    Tq, H, D = q.shape
    Tk = k.shape[0]
    need(k.shape[1:] == (H, D), f"k/v heads or head dim differ from q's: "
         f"{tuple(k.shape)} vs {tuple(q.shape)}")
    need(q.dtype in _DTYPES, f"dtype {q.dtype} not in float32/bfloat16")
    need(k.dtype == q.dtype and v.dtype == q.dtype,
         f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    need(D in HEAD_DIMS, f"head dim {D} not in {HEAD_DIMS}")
    need(Tq >= 1 and Tk >= 1, f"no tokens (Tq={Tq}, Tk={Tk})")
    need(cu_q.dtype == torch.int32 and cu_k.dtype == torch.int32
         and cu_q.dim() == 1 and cu_q.shape == cu_k.shape
         and cu_q.shape[0] >= 2,
         f"cu_seqlens must be int32 [nseq + 1] on both sides, got "
         f"{cu_q.dtype} {tuple(cu_q.shape)} and {cu_k.dtype} "
         f"{tuple(cu_k.shape)}")
    named = [("q", q), ("k", k), ("v", v), ("cu_q", cu_q), ("cu_k", cu_k)]
    if do is not None:
        need(do.shape == q.shape and do.dtype == q.dtype,
             f"dout must match q: {do.dtype} {tuple(do.shape)}")
        for name, x in (("lse", lse), ("delta", delta)):
            need(x.dtype == torch.float32 and x.shape == (H, Tq),
                 f"{name} must be float32 [{H}, {Tq}], got {x.dtype} "
                 f"{tuple(x.shape)}")
        named += [("dout", do), ("lse", lse), ("delta", delta)]
    for name, x in named:
        need(x.is_contiguous(), f"{name} must be contiguous")
    devs = {x.device for _, x in named}
    need(len(devs) == 1, f"operands on several devices: {devs}")
    need(q.device.type != "cuda" or not any(
        x.data_ptr() % 16 for _, x in named[:3] + named[5:6]),
        "q, k, v and dout must be 16-byte aligned")


def _launch(name, ptrs, q, k, causal, scale):
    """Launch one kernel on PyTorch's current stream; raises on CPU
    tensors and on a refused launch (the C entry returns
    ``cudaGetLastError()``, or the error of raising the block's
    shared-memory limit)."""
    if q.device.type != "cuda":
        raise RuntimeError(
            "the varlen flash attention kernels run on CUDA tensors only; "
            f"got {q.device} (the plain versions serve CPU tensors)")
    fn = getattr(_build.library("flash_attention_varlen"), name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] * 6 + \
            [ctypes.c_float, ctypes.c_void_p]
    Tq, H, D = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*ptrs, Tq, k.shape[0], H, D, int(bool(causal)),
                 _DTYPES[q.dtype], float(scale), stream)
    if err != 0:
        raise RuntimeError(f"varlen flash attention kernel {name} launch "
                           f"failed: CUDA error {err}")


def _meta_ptrs(meta, lo, hi):
    return [x.data_ptr() for x in meta] + [lo.data_ptr(), hi.data_ptr()]


def _launch_fwd(q, k, v, cu_q, cu_k, causal, scale):
    """The forward kernel: ``(out, lse)``.  Bounds are per 64-query tile
    (a warpgroup's rows in the wgmma kernel, whose ``lo`` carries the
    launch order of its 128-query blocks after them)."""
    global fwd_launch_count
    _check_operands(q, k, v, cu_q, cu_k)
    bq = fwd_block_q(q, k)
    meta = _prep(q.shape[0], k.shape[0], cu_q, cu_k, bq)
    bk = walk_tile(q.shape[2])
    lo, hi = _block_bounds_q(meta[0], meta[1], cu_k, TILE, bk,
                             meta[2].shape[0] // bk, causal)
    if bq == WGMMA_BLOCK_Q:
        lo = torch.cat([lo, launch_order(pair_tiles(lo, hi))])
    out = torch.empty_like(q)
    lse = torch.empty((q.shape[1], q.shape[0]), dtype=torch.float32,
                      device=q.device)
    _launch("paddle_varlen_attention_fwd",
            [q.data_ptr(), k.data_ptr(), v.data_ptr()] +
            _meta_ptrs(meta, lo, hi) + [out.data_ptr(), lse.data_ptr()],
            q, k, causal, scale)
    fwd_launch_count += 1
    return out, lse


def _dkdv_stats(lse, delta, pad):
    """lse and delta as the wgmma dK/dV kernel copies them beside each
    query tile: ``[H, pad]`` f32, lse times log2 e (0 where not finite, so
    a key-less row reads lse 0 as in the plain version; +inf past Tq, so a
    padded query gets p = 0) and delta 0 past Tq."""
    tail = (0, pad - lse.shape[1])
    lse2 = torch.where(torch.isfinite(lse), lse * LOG2E, 0.0)
    return (torch.nn.functional.pad(lse2, tail, value=float("inf")),
            torch.nn.functional.pad(delta, tail))


def _launch_dkdv(q, k, v, do, lse, delta, cu_q, cu_k, causal, scale,
                 meta=None):
    """The dK/dV kernel: ``(dk, dv)``.  ``meta``: ``_bwd_meta``'s tuple,
    computed here when not given."""
    global dkdv_launch_count
    _check_operands(q, k, v, cu_q, cu_k, do, lse, delta)
    if meta is None:
        meta = _bwd_meta(q, k, cu_q, cu_k, causal)
    if fwd_block_q(q, k) == WGMMA_BLOCK_Q:
        lse, delta = _dkdv_stats(lse, delta, meta[0].shape[0])
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("paddle_varlen_attention_bwd_dkdv",
            [q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr()] +
            _meta_ptrs(meta[:4], *meta[4:6]) + [dk.data_ptr(), dv.data_ptr()],
            q, k, causal, scale)
    dkdv_launch_count += 1
    return dk, dv


def _launch_dq(q, k, v, do, lse, delta, cu_q, cu_k, causal, scale,
               meta=None):
    """The dQ kernel: dq.  ``meta``: ``_bwd_meta``'s tuple, computed here
    when not given."""
    global dq_launch_count
    _check_operands(q, k, v, cu_q, cu_k, do, lse, delta)
    if meta is None:
        meta = _bwd_meta(q, k, cu_q, cu_k, causal)
    dq = torch.empty_like(q)
    _launch("paddle_varlen_attention_bwd_dq",
            [q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr()] +
            _meta_ptrs(meta[:4], *meta[6:8]) + [dq.data_ptr()],
            q, k, causal, scale)
    dq_launch_count += 1
    return dq


# ---------------------------------------------------------------------------
# dispatch by device, and the autograd Function
# ---------------------------------------------------------------------------

def _forward(q, k, v, cu_q, cu_k, causal, scale):
    """``(out, lse)``: the forward kernel on CUDA tensors, the plain
    version on CPU tensors."""
    if q.device.type == "cuda":
        return _launch_fwd(q, k, v, cu_q, cu_k, causal, scale)
    return varlen_fwd_reference(q, k, v, cu_q, cu_k, causal, scale)


def _backward(q, k, v, out, lse, do, cu_q, cu_k, causal, scale):
    """``(dq, dk, dv)``: the dK/dV and dQ kernels on CUDA tensors (one
    ``_bwd_meta`` for both), the plain version on CPU tensors."""
    if q.device.type == "cuda":
        delta = varlen_delta(out, do)
        meta = _bwd_meta(q, k, cu_q, cu_k, causal)
        dk, dv = _launch_dkdv(q, k, v, do, lse, delta, cu_q, cu_k, causal,
                              scale, meta)
        return (_launch_dq(q, k, v, do, lse, delta, cu_q, cu_k, causal,
                           scale, meta), dk, dv)
    return varlen_bwd_reference(q, k, v, out, lse, do, cu_q, cu_k, causal,
                                scale)


class VarlenAttention(torch.autograd.Function):
    """Counterpart of the JAX package's ``_varlen_attention`` custom VJP:
    the forward saves ``(q, k, v, out, lse)`` and the offsets, never the
    scores; the backward recomputes the probabilities from lse."""

    @staticmethod
    def forward(ctx, q, k, v, cu_q, cu_k, causal, scale):
        out, lse = _forward(q, k, v, cu_q, cu_k, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse, cu_q, cu_k)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, cu_q, cu_k = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, out, lse, do.contiguous(), cu_q,
                               cu_k, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None, None, None


def varlen_attention(q, k, v, cu_q, cu_k, causal, scale):
    """Varlen attention over q ``[Tq, H, D]``, k and v ``[Tk, H, D]`` with
    offsets ``cu_q``/``cu_k`` (``[nseq + 1]``); returns ``[Tq, H, D]`` in
    q.dtype, differentiable in q, k and v.  CUDA tensors go through the
    kernels, CPU tensors through the plain versions."""
    cu_q = torch.as_tensor(cu_q, device=q.device).to(torch.int32)
    cu_k = torch.as_tensor(cu_k, device=q.device).to(torch.int32)
    return VarlenAttention.apply(q.contiguous(), k.contiguous(),
                                 v.contiguous(), cu_q.contiguous(),
                                 cu_k.contiguous(), bool(causal),
                                 float(scale))
