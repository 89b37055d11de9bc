"""Ring attention: exact blockwise attention over a sequence-sharded
process group (counterpart of paddle_tpu/parallel/ring_attention.py).

Each rank holds one block of the sequence, computes online-softmax blocks
in float32 and passes its K/V block to the next rank of the ring
(``ppermute``); the backward goes round the reverse ring (the
``ppermute`` transpose).  The math is plain PyTorch, as the reference's is
plain ``jnp`` (no Pallas kernel is reached from it).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .collectives import ppermute

__all__ = ["ring_attention", "ring_self_attention", "zigzag_permutation",
           "zigzag_inverse_permutation"]

_NEG_INF = float(-1e30)  # finite sentinel: avoids -inf NaN traps in exp/max


def _block_attn_step(q, k, v, m_i, l_i, acc, qpos, kpos, causal):
    """One online-softmax accumulation against a single KV block.

    q [B,h,Sq,d] / k,v [B,h,Sk,d] float32; m_i,l_i [B,h,Sq]; acc like q.
    qpos/kpos are GLOBAL token positions used for causal masking across
    ring steps.
    """
    d = q.shape[-1]
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(d)
    if causal:
        mask = kpos[None, None, None, :] <= qpos[None, None, :, None]
        s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    m_new = torch.maximum(m_i, torch.amax(s, dim=-1))
    alpha = torch.exp(m_i - m_new)
    p = torch.exp(s - m_new[..., None])
    if causal:
        p = torch.where(mask, p, torch.zeros_like(p))
    l_new = alpha * l_i + torch.sum(p, dim=-1)
    acc_new = acc * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, v)
    return m_new, l_new, acc_new


def ring_attention(q, k, v, group, causal: bool = True,
                   shard_positions=None):
    """Exact attention with q/k/v sequence-sharded over ``group`` (the
    reference takes a mesh axis name; a torch rank takes the axis's
    process group).  q/k/v: this rank's [B, S_local, H, D].  Returns
    [B, S_local, H, D] in the input dtype.

    shard_positions: optional [group size, S_local] integer array of the
    global token positions each rank holds (zigzag layouts).  Default:
    contiguous, rank i holds [i*S_local, (i+1)*S_local).
    """
    cp = group.size()
    my = group.rank()
    B, S, H, D = q.shape
    in_dtype = q.dtype
    dev = q.device

    qf = q.transpose(1, 2).float()                    # [B,h,S,d]
    kf = k.transpose(1, 2).float()
    vf = v.transpose(1, 2).float()

    if shard_positions is None:
        base = torch.arange(S, dtype=torch.int32, device=dev)
        qpos = my * S + base

        def pos_of(idx):
            return idx * S + base
    else:
        table = torch.as_tensor(np.asarray(shard_positions),
                                dtype=torch.int32, device=dev)
        qpos = table[my]

        def pos_of(idx):
            return table[idx]

    # KV travels forward around the ring: after t hops this rank holds
    # the block that started on rank (my - t) % cp
    perm = [(i, (i + 1) % cp) for i in range(cp)]

    m_f = torch.full((B, H, S), _NEG_INF, dtype=torch.float32, device=dev)
    l_f = torch.zeros((B, H, S), dtype=torch.float32, device=dev)
    acc = torch.zeros_like(qf)

    # block 0 (own KV) first; each later step permutes then computes, so
    # exactly cp - 1 KV hops go round the ring
    m_f, l_f, acc = _block_attn_step(qf, kf, vf, m_f, l_f, acc, qpos,
                                     pos_of(my), causal)
    k_cur, v_cur = kf, vf
    for t in range(1, cp):
        k_cur = ppermute(k_cur, group, perm)
        v_cur = ppermute(v_cur, group, perm)
        m_f, l_f, acc = _block_attn_step(qf, k_cur, v_cur, m_f, l_f, acc,
                                         qpos, pos_of((my - t) % cp), causal)

    out = acc / torch.clamp(l_f, min=1e-30)[..., None]
    return out.transpose(1, 2).to(in_dtype)


def zigzag_permutation(seq_len: int, cp: int):
    """Load-balanced ("zigzag") context-parallel layout: rank i holds
    chunks i and 2cp-1-i of 2cp chunks, which equalises causal work.

    Returns (perm, shard_positions): ``tokens[:, perm]`` reorders a global
    sequence so a plain contiguous split over cp ranks realises the
    layout, and shard_positions[i] are the global positions rank i holds
    (feed to ring_attention).
    """
    if seq_len % (2 * cp):
        raise ValueError("seq_len must be divisible by 2*cp")
    chunk = seq_len // (2 * cp)
    order = []
    for i in range(cp):
        order.extend(range(i * chunk, (i + 1) * chunk))
        j = 2 * cp - 1 - i
        order.extend(range(j * chunk, (j + 1) * chunk))
    perm = np.asarray(order, np.int32)
    return perm, perm.reshape(cp, 2 * chunk)


def zigzag_inverse_permutation(seq_len: int, cp: int):
    perm, _ = zigzag_permutation(seq_len, cp)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(seq_len, dtype=np.int32)
    return inv


def ring_self_attention(q, k, v, mesh, axis_name: str = "cp",
                        causal: bool = True):
    """Ring attention over ``axis_name`` of a ``Mesh``
    (``paddle_tpu_torch.parallel.build_mesh``).  The reference takes the
    global [B, S, H, D] arrays and shards them itself; a torch rank holds
    only its own shard, so q/k/v here are this rank's [B, S/n, H, D]
    block and so is the result.  The port's mesh names its context axis
    "cp" (the reference's default axis name, "sep", is not one of its
    axes)."""
    return ring_attention(q, k, v, mesh.group(axis_name), causal)
