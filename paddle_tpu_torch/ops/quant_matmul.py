"""Fused dequant matmul for int8/int4 weight pools: the hand-written CUDA
kernel and its plain PyTorch version (counterpart of
paddle_tpu/ops/pallas/quant_matmul.py).

Decode streams every weight once per step, so weight bytes set its floor.
The serving engine stores its projections as quantized pools and this
module's ``matmul`` dequantizes them inline: ``x @ dequant(q, s)`` -> f32
``[M, N]``, activations upcast exactly and every product summed in f32.

Layout contract (the JAX package's, shared with ``LLMEngine``'s pools):

* int8: ``q`` is [K, N] int8, ``s`` is [N] f32 -- symmetric
  per-output-channel scales, float = int8 * s[n].
* int4: ``q`` is [K//2, N] int8 with two signed nibbles per byte --
  packed row r holds rows 2r (low nibble) and 2r+1 (high nibble) of
  column n; ``s`` is [ceil(K/128), N] f32 -- one scale per 128
  consecutive K rows per output column, float = nibble * s[k//128, n].
  K must be even.

``reference_matmul`` (dense dequantize, then one f32 product) is the
plain version.  ``matmul`` launches the kernel in
``paddle_tpu_torch/csrc/quant_matmul.cu`` on CUDA tensors (or raises) and
computes ``reference_matmul`` on CPU tensors; ``launch_count`` counts the
kernel's launches.  The launch's row tile and K slabs a split come from
the tuning cache (``tune/``; the kernel's rule without an entry).  The JAX
package's lowering probe (``supports``) has no counterpart: the CUDA
kernel takes every M, N and K (even K for int4) and raises on anything
else.

The kernel feeds the tensor cores the integer codes themselves (exact in
bf16) and applies the scales after the sums; f32 x goes in as three exact
bf16 terms.  ``split_bf16x3`` and ``grouped_reference`` state that
algebra on the CPU, for the tests: the kernel's order of operations in
plain PyTorch.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

__all__ = ["GROUP", "quantize_weight", "unpack_int4", "dequantize_weight",
           "quantize_embedding", "dequantize_rows", "reference_matmul",
           "split_bf16x3", "grouped_reference", "matmul", "launch_count"]

GROUP = 128             # int4 scale-group length along K

# kernel launches made by the CUDA route (plain-version calls never count)
launch_count = 0

_X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_WEIGHT_DTYPES = ("int8", "int4")


def _bad_dtype(weight_dtype) -> ValueError:
    return ValueError(
        f"weight_dtype must be 'int8' or 'int4', got {weight_dtype!r}")


def _pack_nibbles(lo, hi):
    """Two int32 tensors of values in [-8, 7] -> one int8 tensor, ``lo``
    in the low nibble and ``hi`` in the high nibble of each byte."""
    packed = ((hi << 4) | (lo & 0xF)) & 0xFF
    return packed.to(torch.uint8).view(torch.int8)


def _unpack_nibbles(p):
    """int8 bytes -> (low, high) nibbles as sign-extended int32."""
    p = p.to(torch.int32)
    return (p << 28) >> 28, p >> 4


# ---------------------------------------------------------------------------
# quantize / dequantize (build-time host transforms + the plain version)
# ---------------------------------------------------------------------------

def quantize_weight(w, weight_dtype: str):
    """Quantize one [K, N] weight to ``(q, s)`` in the pool layout, in f32
    on ``w``'s device.

    int8: per-output-channel symmetric, s[n] = amax(w[:, n]) / 127.
    int4: per-128-row-group per-output-channel, s[g, n] = amax(group) / 7,
    nibbles packed two-per-byte along K.  All-zero channels/groups
    quantize against scale 1.0 (q == 0 regardless)."""
    w = torch.as_tensor(w).float()
    if w.dim() != 2:
        raise ValueError(f"expected a [K, N] weight, got shape "
                         f"{tuple(w.shape)}")
    K, N = w.shape
    if weight_dtype == "int8":
        amax = w.abs().amax(0)                                   # [N]
        s = torch.where(amax > 0.0, amax / 127.0, 1.0)
        q = torch.clamp(torch.round(w / s[None, :]), -127, 127) \
            .to(torch.int8)
        return q, s
    if weight_dtype == "int4":
        if K % 2:
            raise ValueError(f"int4 packing needs even K, got K={K}")
        G = -(-K // GROUP)
        wp = torch.nn.functional.pad(w, (0, 0, 0, G * GROUP - K))
        gmax = wp.reshape(G, GROUP, N).abs().amax(1)             # [G, N]
        s = torch.where(gmax > 0.0, gmax / 7.0, 1.0)
        srow = torch.repeat_interleave(s, GROUP, dim=0)[:K]      # [K, N]
        q = torch.clamp(torch.round(w / srow), -8, 7).to(torch.int32)
        return _pack_nibbles(q[0::2], q[1::2]), s
    raise _bad_dtype(weight_dtype)


def unpack_int4(packed):
    """[K//2, N] nibble-packed int8 -> [K, N] int32 in [-8, 7]; packed
    row r expands to rows 2r (low nibble) and 2r+1 (high nibble)."""
    lo, hi = _unpack_nibbles(packed)
    Kh, N = packed.shape
    return torch.stack([lo, hi], dim=1).reshape(2 * Kh, N)


def dequantize_weight(q, s, weight_dtype: str):
    """Dense f32 [K, N] weight from a quantized pool entry -- the dense
    half of the plain version."""
    if weight_dtype == "int8":
        return q.float() * s[None, :]
    if weight_dtype == "int4":
        w = unpack_int4(q).float()
        srow = torch.repeat_interleave(s, GROUP, dim=0)[:w.shape[0]]
        return w * srow
    raise _bad_dtype(weight_dtype)


def quantize_embedding(embed, weight_dtype: str):
    """Quantize a [V, H] embedding table with per-vocab-row symmetric
    scales (the gather axis, so a token lookup dequantizes exactly the
    rows it reads).  int4 packs column PAIRS two-per-byte along H (byte
    column c holds columns 2c low / 2c+1 high); H must be even."""
    embed = torch.as_tensor(embed).float()
    V, H = embed.shape
    amax = embed.abs().amax(1)                                   # [V]
    if weight_dtype == "int8":
        s = torch.where(amax > 0.0, amax / 127.0, 1.0)
        q = torch.clamp(torch.round(embed / s[:, None]), -127, 127) \
            .to(torch.int8)
        return q, s
    if weight_dtype == "int4":
        if H % 2:
            raise ValueError(f"int4 packing needs even H, got H={H}")
        s = torch.where(amax > 0.0, amax / 7.0, 1.0)
        q = torch.clamp(torch.round(embed / s[:, None]), -8, 7) \
            .to(torch.int32)
        return _pack_nibbles(q[:, 0::2], q[:, 1::2]), s
    raise _bad_dtype(weight_dtype)


def dequantize_rows(q_rows, s_rows, weight_dtype: str):
    """Gathered embedding rows ``q_rows`` [T, H or H//2] with their
    per-row scales ``s_rows`` [T] -> [T, H] f32: only the rows a launch
    reads are ever upcast."""
    if weight_dtype == "int8":
        return q_rows.float() * s_rows[:, None]
    if weight_dtype == "int4":
        lo, hi = _unpack_nibbles(q_rows)
        T, Hh = q_rows.shape
        rows = torch.stack([lo, hi], dim=2).reshape(T, 2 * Hh)
        return rows.float() * s_rows[:, None]
    raise _bad_dtype(weight_dtype)


def reference_matmul(x, q, s, weight_dtype: str):
    """The plain version: dense dequantize, then one f32 product.  ``x``
    [M, K] (any float dtype); result [M, N] f32."""
    return x.float() @ dequantize_weight(q, s, weight_dtype)


def split_bf16x3(x):
    """f32 ``x`` as three bfloat16 tensors ``(h, m, l)`` with ``h + m + l
    == x`` exactly for zero and every finite |x| >= 2**-110: ``h`` keeps
    the top 16 bits of x (its sign, exponent and 7 mantissa bits:
    truncation, so +-FLT_MAX does not round to inf), ``m`` the top 16 bits
    of ``x - h`` (exact in f32) and ``l`` those of ``x - h - m``, which has
    at most 8 significant bits left.  Below 2**-110 that rest is subnormal
    and ``l`` may drop bits worth less than 2**-133.  The kernel's split
    of f32 x before its bf16 products."""
    x = x.float()

    def top(v):
        return (v.view(torch.int32) & -65536).view(torch.float32)

    h = top(x)
    r1 = x - h
    m = top(r1)
    r2 = r1 - m
    return h.bfloat16(), m.bfloat16(), r2.bfloat16()


def grouped_reference(x, q, s, weight_dtype: str):
    """The kernel's algebra in plain PyTorch: integer codes times x (f32 x
    split by ``split_bf16x3``, one product per term, summed in order),
    the scales applied after the sums -- int8 ``s[n] * sum_k x q``, int4
    per 128-row group ``acc += s[g, n] * (x_g @ q_g)`` in group order.
    Differs from ``reference_matmul`` only by f32 rounding order."""
    terms = split_bf16x3(x) if x.dtype == torch.float32 else (x,)
    terms = [v.float() for v in terms]
    if weight_dtype == "int8":
        codes = q.float()
        return sum(v @ codes for v in terms) * s[None, :]
    if weight_dtype == "int4":
        codes = unpack_int4(q).float()
        acc = torch.zeros((x.shape[0], q.shape[1]), dtype=torch.float32,
                          device=x.device)
        for g in range(s.shape[0]):
            rows = slice(g * GROUP, (g + 1) * GROUP)
            part = sum(v[:, rows] @ codes[rows] for v in terms)
            acc = acc + s[g][None, :] * part
        return acc
    raise _bad_dtype(weight_dtype)


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------

def _check_operands(x, q, s, weight_dtype):
    """Shape/dtype/contiguity contract of the kernel; raises ValueError on
    anything it does not take."""
    def need(ok, what):
        if not ok:
            raise ValueError(f"dequant matmul kernel: {what}")

    need(weight_dtype in _WEIGHT_DTYPES,
         f"weight_dtype {weight_dtype!r} not in {_WEIGHT_DTYPES}")
    need(x.dim() == 2, f"x must be [M, K], got {tuple(x.shape)}")
    need(x.dtype in _X_DTYPES, f"x dtype {x.dtype} not in float32/bfloat16")
    need(q.dim() == 2 and q.dtype == torch.int8,
         f"q must be int8 [K or K/2, N], got {q.dtype} {tuple(q.shape)}")
    need(s.dtype == torch.float32, f"scales must be float32, got {s.dtype}")
    M, K = x.shape
    N = q.shape[1]
    need(M >= 1 and N >= 1 and K >= 1, f"empty product M={M} K={K} N={N}")
    if weight_dtype == "int8":
        need(q.shape[0] == K, f"int8 q rows {q.shape[0]} != K={K}")
        need(tuple(s.shape) == (N,), f"int8 scales must be [{N}], got "
             f"{tuple(s.shape)}")
    else:
        need(K % 2 == 0, f"int4 needs even K, got K={K}")
        need(q.shape[0] == K // 2, f"int4 q rows {q.shape[0]} != K/2="
             f"{K // 2}")
        G = -(-K // GROUP)
        need(tuple(s.shape) == (G, N), f"int4 scales must be [{G}, {N}], "
             f"got {tuple(s.shape)}")
    for name, t in (("x", x), ("q", q), ("scales", s)):
        need(t.is_contiguous(), f"{name} must be contiguous")
    devs = {t.device for t in (x, q, s)}
    need(len(devs) == 1, f"operands on several devices: {devs}")


@functools.lru_cache(maxsize=1024)
def _tuned_plan(epoch, m, k, n, weight_dtype):
    """(tile, K slabs a split) for one launch shape: the tuning cache's
    answer (the JAX package's shape key; ``epoch`` is
    ``tune.config_epoch()``, so no launch reads a file), or (-1, 0) -- the
    C side's rule -- without one.  The row tile keeps the order of the
    sums; the slabs a split change it (each split's partial is summed in
    split order), within a bound on a split's f32 chain at any K."""
    from ..tune import kernel_config
    cfg = kernel_config("quant_matmul",
                        {"m": m, "k": k, "n": n, "dtype": weight_dtype})
    tile = int(cfg["tile"])
    return (tile if tile in (0, 1, 2) else -1), \
        max(0, int(cfg["split_slabs"]))


def _plan(M, K, N, weight_dtype):
    from ..tune import config_epoch
    return _tuned_plan(config_epoch(), M, K, N, weight_dtype)


def _launch_kernel(x, q, s, weight_dtype):
    """Launch the CUDA kernel on PyTorch's current stream.  Raises on an
    operand it does not take, on CPU tensors, on a failed build and on a
    refused launch (the C entry returns ``cudaGetLastError()``).  For a
    small output the kernel splits K over several blocks and a second
    kernel sums the partial products in a fixed order; the scratch comes
    from here, sized by the C side (``paddle_quant_matmul_scratch``, by
    shape, x type, pool type and plan).  The row tile and the K slabs a
    split come from the tuning cache (``_plan``); without an entry, the C
    side's rule."""
    global launch_count
    _check_operands(x, q, s, weight_dtype)
    if x.device.type != "cuda":
        raise RuntimeError(
            "the dequant matmul kernel runs on CUDA tensors only; got "
            f"{x.device} (the plain version serves CPU tensors)")
    lib = _build.library("quant_matmul")
    fn, scratch_fn = lib.paddle_quant_matmul, lib.paddle_quant_matmul_scratch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + \
            [ctypes.c_void_p]
        scratch_fn.restype = ctypes.c_longlong
        scratch_fn.argtypes = [ctypes.c_int] * 7
    M, K = x.shape
    N = q.shape[1]
    tile, slabs = _plan(M, K, N, weight_dtype)
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    n_scratch = scratch_fn(M, N, K, _X_DTYPES[x.dtype],
                           int(weight_dtype == "int4"), tile, slabs)
    scratch = torch.empty((max(n_scratch, 1),), dtype=torch.float32,
                          device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(),
                 scratch.data_ptr(), M, N, K, _X_DTYPES[x.dtype],
                 int(weight_dtype == "int4"), tile, slabs, stream)
    if err != 0:
        raise RuntimeError(f"dequant matmul kernel launch failed: CUDA "
                           f"error {err}")
    launch_count += 1
    return out


def matmul(x, q, s, weight_dtype: str):
    """``x @ dequant(q, s)`` -> [M, N] f32.  ``x`` [M, K] float32 or
    bfloat16; ``q``/``s`` in the pool layout of the module header.  CUDA
    tensors go through the CUDA kernel (which raises on an operand it does
    not take); CPU tensors take ``reference_matmul``."""
    if x.device.type == "cuda":
        return _launch_kernel(x, q, s, weight_dtype)
    return reference_matmul(x, q, s, weight_dtype)
