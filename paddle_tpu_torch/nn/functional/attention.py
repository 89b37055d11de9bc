"""Attention functionals (counterpart of
paddle_tpu/nn/functional/attention.py).

Layouts are Paddle's, as in the JAX package: ``[batch, seq, heads,
head_dim]`` for ``scaled_dot_product_attention`` and ``flash_attention``,
``[total_tokens, heads, head_dim]`` with cumulative offsets for
``flash_attn_unpadded``.  Routing follows the JAX package's shape rules,
decided from the inputs alone: the port has no lowering probe, and
``FLAGS_use_pallas_kernels`` (kept in the registry for parity) routes
nothing, so no setting hands a CUDA tensor to a plain version.  With no
mask and no dropout, fixed-length attention goes to the port's flash
attention (``ops.flash_attention.attention``) wherever the JAX package
would take its Pallas flash kernel, else to the composition
``_sdpa_ref``; varlen
attention to ``ops.flash_attention_varlen.varlen_attention`` where
``use_varlen_kernel`` holds, else to the segment-masked composition
``_unpadded_impl``.  Inputs are ``Tensor`` (then the result is a
``Tensor`` recorded on the autograd graph through the dispatcher) or raw
torch tensors; the kernel routes run on the card for CUDA tensors and
through the plain versions for CPU tensors.  ``sdp_kernel`` is not ported
yet (ROADMAP.md Queue 1 item 13).
"""
from __future__ import annotations

import math

import torch

from ...core import dispatch as _D
from ...core.tensor import Tensor
from ...ops import flash_attention as _fa
from ...ops import flash_attention_varlen as _fav
from ...ops.flash_attention import _repeat_kv

__all__ = ["scaled_dot_product_attention", "flash_attention",
           "flash_attn_unpadded"]


def _sdpa_ref(q, k, v, mask=None, *, causal, scale=None):
    """The JAX package's composition, term for term: scores in the inputs'
    type then f32, a causal mask aligned bottom-right, a boolean mask as
    -inf or a float mask added, softmax in f32, probabilities cast back to
    q's type for the PV product.  q/k/v ``[B, S, H, D]``, GQA when k/v
    carry fewer heads."""
    group = q.shape[2] // k.shape[2]
    k, v = _repeat_kv(k, group), _repeat_kv(v, group)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    scores = (torch.einsum("bhqd,bhkd->bhqk", qt, kt) * s).float()
    if causal:
        ql, kl = scores.shape[-2], scores.shape[-1]
        keep = torch.ones((ql, kl), dtype=torch.bool,
                          device=q.device).tril(kl - ql)
        scores = torch.where(keep, scores, float("-inf"))
    if mask is not None:
        if mask.dtype == torch.bool:
            scores = torch.where(mask, scores, float("-inf"))
        else:
            scores = scores + mask.float()
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, vt).transpose(1, 2)


def _flash_eligible(q, k, causal) -> bool:
    """The JAX package's ``_shapes_eligible``, its backend check and
    lowering probe aside: 4-D inputs, head dim 64, 128, 256 or a multiple
    of 128, sequence lengths multiples of 128, the GQA group dividing the
    heads, Sq == Sk under causal, float32 or bfloat16.  On CUDA tensors the
    flash kernels take every such shape."""
    if q.dim() != 4 or k.dim() != 4:
        return False
    b, s, h, d = q.shape
    kb, sk, hk, kd = k.shape
    return ((d % 128 == 0 or d in (64, 128, 256)) and kb == b and kd == d
            and hk > 0 and h % hk == 0 and sk % 128 == 0
            and (not causal or sk == s) and s % 128 == 0
            and q.dtype in _fa._DTYPES)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None):
    """Inputs ``[batch, seq, num_heads, head_dim]``.  Without a mask or
    dropout, shapes the flash kernels take go through
    ``ops.flash_attention.attention``; everything else through the
    composition, which (as in the JAX package) applies no dropout.  The
    route is chosen once, on the inputs as given, as the JAX package
    chooses it."""
    causal = bool(is_causal)
    q, k = (t._data if isinstance(t, Tensor) else t for t in (query, key))
    if attn_mask is None and dropout_p == 0.0 and \
            _flash_eligible(q, k, causal):
        op, fn, args = "flash_attention", _fa.attention, (query, key, value)
    else:
        op, fn, args = "sdpa", _sdpa_ref, (query, key, value, attn_mask)
    if isinstance(query, Tensor):
        return _D.apply(op, fn, args, {"causal": causal})
    return fn(*args, causal=causal)


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, fixed_seed_offset=None, rng_name="",
                    training=True, name=None):
    """``(scaled_dot_product_attention(...), None)``, as in the JAX
    package (no softmax is returned)."""
    return scaled_dot_product_attention(query, key, value, None, dropout,
                                        causal, training), None


def _unpadded_impl(q, k, v, cu_q, cu_k, *, scale, causal):
    """The JAX package's segment-masked composition: q/k/v ``[T, H, D]``
    (k/v may carry fewer heads), f32 scores times ``scale``, a softmax
    over each query's visible keys, rows of empty sequences zero.  Returns
    q's type."""
    group = q.shape[1] // k.shape[1]
    if group > 1:
        k = _repeat_kv(k[None], group)[0]
        v = _repeat_kv(v[None], group)[0]
    seg_q, rel_q = _fav.segments(cu_q, q.shape[0])
    seg_k, rel_k = _fav.segments(cu_k, k.shape[0])
    keep = seg_q[:, None] == seg_k[None, :]
    if causal:
        keep &= rel_q[:, None] >= rel_k[None, :]
    scores = torch.einsum("qhd,khd->hqk", q.float(), k.float()) * scale
    scores = torch.where(keep[None], scores, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    probs = torch.where(keep[None], probs, 0.0)   # empty rows: nan -> 0
    return torch.einsum("hqk,khd->qhd", probs, v.float()).to(q.dtype)


def flash_attn_unpadded(query, key, value, cu_seqlens_q, cu_seqlens_k,
                        max_seqlen_q, max_seqlen_k, scale, dropout=0.0,
                        causal=False, return_softmax=False,
                        fixed_seed_offset=None, rng_name="", training=True,
                        name=None):
    """Varlen attention over concatenated sequences, ``[total_tokens,
    num_heads, head_dim]`` with ``cu_seqlens_*`` holding cumulative
    offsets (batch + 1 of them).  Returns ``(out, None)``; ``out`` is
    differentiable in query, key and value.  Shapes ``use_varlen_kernel``
    takes go through the varlen kernels (the plain versions on CPU
    tensors), the rest (GQA among them) through the composition.
    Attention dropout is refused, as in the JAX package."""
    if dropout and training:
        raise NotImplementedError(
            "flash_attn_unpadded: attention dropout is not implemented; "
            "pass dropout=0.0")
    cu_q = torch.as_tensor(cu_seqlens_q, device=query.device).to(
        torch.int32)
    cu_k = torch.as_tensor(cu_seqlens_k, device=query.device).to(
        torch.int32)
    if _fav.use_varlen_kernel(query, key):
        out = _fav.varlen_attention(query, key, value, cu_q, cu_k,
                                    bool(causal), float(scale))
    else:
        out = _unpadded_impl(query, key, value, cu_q, cu_k,
                             scale=float(scale), causal=bool(causal))
    return out, None
