"""``paddle.incubate.nn.functional`` surface of the PyTorch port: paged-KV
block attention (counterpart of block_multihead_attention and
blha_get_max_len in paddle_tpu/incubate/nn/functional/__init__.py) and
the fused ops of ``fused_ops`` (fused_rms_norm, fused_layer_norm,
fused_rotary_position_embedding, swiglu, fused_matmul_bias, fused_linear).

``block_multihead_attention`` serves a batch of sequences whose K/V live in
pages ``[max_blocks, H, block_size, D]`` addressed by block tables.  Its
decode runs the paged decode kernel (``ops.paged_attention.
paged_decode_attention``), its prefill the varlen attention
(``ops.flash_attention_varlen.varlen_attention``), each where the JAX
package's shape rule would take its Pallas kernel, and the JAX package's
compositions elsewhere.  CUDA tensors go through the kernels, CPU tensors
through their plain versions.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ....nn.functional.attention import _unpadded_impl
from ....ops import flash_attention_varlen as _fav
from ....ops import paged_attention as _pa
from .fused_ops import (fused_layer_norm, fused_linear, fused_matmul_bias,
                        fused_rms_norm, fused_rotary_position_embedding,
                        swiglu)

__all__ = ["block_multihead_attention", "blha_get_max_len",
           "fused_rms_norm", "fused_layer_norm",
           "fused_rotary_position_embedding", "swiglu", "fused_matmul_bias",
           "fused_linear"]


def _host(x):
    """A sequence-length argument as a flat numpy array (a host read)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x).reshape(-1)


def blha_get_max_len(seq_lens_encoder, seq_lens_decoder, batch_size):
    """Max encoder and decoder lengths, each as a one-element tensor."""
    return (torch.as_tensor(seq_lens_encoder).max().reshape(1),
            torch.as_tensor(seq_lens_decoder).max().reshape(1))


def _split_qkv(qkv, H, D, qkv_bias):
    x = qkv.reshape(qkv.shape[0], 3, H, D)
    if qkv_bias is not None:
        bias = torch.as_tensor(qkv_bias, device=qkv.device)
        if bias.dtype == torch.float64:   # the JAX package runs without x64
            bias = bias.float()
        x = x + bias.reshape(3, H, D)[None]
    return x[:, 0], x[:, 1], x[:, 2]


def _decode(qkv, kc, vc, bt, dec, qkv_bias):
    """One token per sequence at position ``dec[b]``: its K/V go to page
    ``bt[b, dec // bs]``, slot ``dec % bs``, then it attends over its
    dec + 1 positions."""
    B = qkv.shape[0]
    _, H, bs, D = kc.shape
    q, k, v = _split_qkv(qkv, H, D, qkv_bias)
    t = torch.as_tensor(dec, device=qkv.device).reshape(B).to(torch.int32)
    bt = torch.as_tensor(bt, device=qkv.device)
    blk = bt.gather(1, (t // bs).long()[:, None])[:, 0].long()
    slot = (t % bs).long()
    kc[blk, :, slot, :] = k.to(kc.dtype)
    vc[blk, :, slot, :] = v.to(vc.dtype)
    if _pa.supports(B, H, H, D, bs):
        # q joins the cache dtype, as the JAX package casts it for its kernel
        out = _pa.paged_decode_attention(q.to(kc.dtype), kc, vc, bt, t + 1)
    else:
        out = _pa.paged_decode_reference(q, kc, vc, bt, t + 1)
    return out.reshape(B, H * D).to(qkv.dtype)


def _prefill(qkv, kc, vc, bt, lens, qkv_bias):
    """Causal self-attention within each sequence's fresh tokens (packed
    back to back, ``lens[b]`` of them), whose K/V then fill the sequence's
    pages from position 0."""
    _, H, bs, D = kc.shape
    q, k, v = _split_qkv(qkv, H, D, qkv_bias)
    T = q.shape[0]
    cu = torch.as_tensor(np.concatenate([[0], np.cumsum(lens)]),
                         dtype=torch.int32, device=qkv.device)
    seg, rel = _fav.segments(cu, T)
    attend = _fav.varlen_attention if _fav.use_varlen_kernel(q, k) else \
        _unpadded_impl
    out = attend(q, k, v, cu, cu, causal=True, scale=1.0 / math.sqrt(D))
    blk = torch.as_tensor(bt, device=qkv.device)[seg.long(),
                                                 (rel // bs).long()].long()
    slot = (rel % bs).long()
    kc[blk, :, slot, :] = k.to(kc.dtype)
    vc[blk, :, slot, :] = v.to(vc.dtype)
    return out.reshape(T, H * D).to(qkv.dtype)


def block_multihead_attention(qkv, key_cache, value_cache, seq_lens_encoder,
                              seq_lens_decoder, seq_lens_this_time,
                              padding_offsets=None, cum_offsets=None,
                              cu_seqlens_q=None, cu_seqlens_k=None,
                              block_tables=None, pre_key_cache=None,
                              pre_value_cache=None,
                              cache_k_quant_scales=None,
                              cache_v_quant_scales=None,
                              cache_k_dequant_scales=None,
                              cache_v_dequant_scales=None,
                              qkv_out_scale=None, qkv_bias=None,
                              out_shift=None, out_smooth=None,
                              max_enc_len_this_time=None,
                              max_dec_len_this_time=None, rope_emb=None,
                              mask=None, tgt_mask=None, max_seq_len=-1,
                              block_size=64, use_neox_style=False, **kwargs):
    """Paged-KV attention over a batch of sequences.

    - DECODE: every sequence contributes one token (seq_lens_this_time ==
      1, some seq_lens_decoder > 0); its K/V go into page
      block_tables[b, pos // block_size] and it attends over its pages.
    - PREFILL: every sequence runs causal self-attention over its own
      fresh tokens (seq_lens_decoder == 0, this == encoder) and their K/V
      fill its pages.
    - MIXED: prefill sequences first, then decode sequences over the
      caches the prefill updated; outputs back in token order.

    qkv ``[token_num, 3 * H * D]``; key/value caches ``[max_blocks, H,
    block_size, D]``; block_tables ``[B, blocks_per_seq]``.  Returns
    ``(out [token_num, H * D], qkv, key_cache, value_cache)``.  The caches
    are updated in place: the returned caches are the tensors passed in.
    The sequence lengths are read on the host to pick the mode.  As in
    the JAX package, rope_emb, mask, tgt_mask, max_seq_len,
    padding_offsets, cum_offsets and cu_seqlens_q/k are accepted and
    ignored; quantized caches and pre-caches raise NotImplementedError.
    """
    if any(t is not None for t in (cache_k_quant_scales,
                                   cache_v_quant_scales,
                                   cache_k_dequant_scales,
                                   cache_v_dequant_scales, qkv_out_scale,
                                   out_shift, out_smooth)):
        raise NotImplementedError(
            "block_multihead_attention quantized-cache paths are serving "
            "deferrals; run the float cache")
    if pre_key_cache is not None or pre_value_cache is not None:
        raise NotImplementedError(
            "block_multihead_attention pre-cache (system prompt cache) is "
            "a serving deferral")
    if block_tables is None:
        raise ValueError("block_multihead_attention requires block_tables")

    enc = _host(seq_lens_encoder)
    dec = _host(seq_lens_decoder)
    this = _host(seq_lens_this_time)
    decode_mode = bool((this == 1).all() and (dec > 0).any())
    prefill_mode = bool((dec == 0).all() and (this == enc).all())
    if decode_mode:
        out = _decode(qkv, key_cache, value_cache, block_tables, dec,
                      qkv_bias)
        return out, qkv, key_cache, value_cache
    if prefill_mode:
        out = _prefill(qkv, key_cache, value_cache, block_tables, this,
                       qkv_bias)
        return out, qkv, key_cache, value_cache

    # MIXED batch (continuous batching): prefill tokens, then decode tokens
    # over the updated caches, outputs merged back into token order
    is_dec = (this == 1) & (dec > 0)
    if not (is_dec | ((dec == 0) & (this == enc))).all():
        raise NotImplementedError(
            "sequences must be pure prefill (dec==0, this==enc) or "
            "single-token decode (this==1, dec>0)")
    starts = np.concatenate([[0], np.cumsum(this)])
    pre_sel = np.where(~is_dec)[0]
    dec_sel = np.where(is_dec)[0]
    idx_pre = torch.as_tensor(np.concatenate(
        [np.arange(starts[b], starts[b + 1]) for b in pre_sel]),
        device=qkv.device)
    idx_dec = torch.as_tensor(starts[dec_sel], device=qkv.device)
    bt = torch.as_tensor(block_tables, device=qkv.device)
    out_p, _, kc, vc = block_multihead_attention(
        qkv[idx_pre], key_cache, value_cache, enc[pre_sel], dec[pre_sel],
        this[pre_sel], block_tables=bt[torch.as_tensor(pre_sel)],
        block_size=block_size, max_seq_len=max_seq_len,
        use_neox_style=use_neox_style, qkv_bias=qkv_bias)
    out_d, _, kc, vc = block_multihead_attention(
        qkv[idx_dec], kc, vc, enc[dec_sel], dec[dec_sel], this[dec_sel],
        block_tables=bt[torch.as_tensor(dec_sel)], block_size=block_size,
        max_seq_len=max_seq_len, use_neox_style=use_neox_style,
        qkv_bias=qkv_bias)
    merged = torch.zeros((qkv.shape[0], out_p.shape[1]), dtype=out_p.dtype,
                         device=qkv.device)
    merged[idx_pre] = out_p
    merged[idx_dec] = out_d
    return merged, qkv, kc, vc
