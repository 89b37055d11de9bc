"""Top-k MoE gating, term for term the JAX package's
(paddle_tpu/incubate/distributed/models/moe/gating.py): GShard top-k
gates with a per-expert capacity, positions assigned by a cumulative sum,
dense [T, E, C] dispatch and combine tensors, all in float32.  Shared by
the expert-parallel ``moe_ffn`` (``paddle_tpu_torch.parallel.moe``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["topk_gating", "capacity_for", "gate_dispatch", "expert_silu_ffn",
           "combine_output"]


def capacity_for(num_tokens: int, num_experts: int, top_k: int,
                 capacity_factor: float) -> int:
    """Per-expert token capacity (reference: cap = factor * T * k / E)."""
    c = int(capacity_factor * num_tokens * top_k / num_experts)
    return max(1, c)


def _assign_capacity(mask, prev_count=None):
    """mask: [T, E] 0/1 expert assignment.  Returns the position of each
    token within its expert's buffer ([T] int32) counting any positions
    already taken (prev_count: [E])."""
    pos = torch.cumsum(mask, dim=0) - 1                   # [T, E]
    if prev_count is not None:
        pos = pos + prev_count[None, :]
    return torch.sum(pos * mask, dim=1).to(torch.int32)  # [T]


def topk_gating(logits, top_k: int, capacity: int, use_aux_loss: bool = True):
    """GShard-style top-k gating with capacity.

    logits: [T, E] float.  Returns (combine [T, E, C], dispatch [T, E, C]
    0/1 as float, aux_loss scalar).  top_k=1 is the Switch gate, top_k=2
    the GShard gate.  Tokens overflowing an expert's capacity are dropped
    for that expert (their combine weight is zero).  Ties in the top-k
    choice go to the lowest expert index, as ``jnp.argmax``'s do.
    """
    T, E = logits.shape
    C = capacity
    gates = torch.softmax(logits.float(), dim=-1)                 # [T, E]

    masks = []       # [T, E] one-hot per choice
    gate_vals = []   # [T] prob of that choice
    g = gates
    for _ in range(top_k):
        idx = torch.argmax(g, dim=-1)                             # [T]
        m = F.one_hot(idx, E).float()
        masks.append(m)
        gate_vals.append(torch.sum(gates * m, dim=-1))
        g = g * (1.0 - m)                                         # mask out

    # load-balancing auxiliary loss on the FIRST choice, before drops
    if use_aux_loss:
        me = torch.mean(gates, dim=0)                             # [E]
        ce = torch.mean(masks[0], dim=0)                          # [E]
        aux_loss = torch.sum(me * ce) * E
    else:
        aux_loss = torch.zeros((), dtype=torch.float32, device=logits.device)

    # capacity positions: choice k's tokens queue up behind choices < k
    prev = torch.zeros((E,), dtype=torch.float32, device=logits.device)
    positions, kept_masks = [], []
    for m in masks:
        pos = _assign_capacity(m, prev)                           # [T]
        keep = (pos < C).float()
        kept_masks.append(m * keep[:, None])
        positions.append(pos)
        prev = prev + torch.sum(m, dim=0)

    # renormalize combine weights over the kept choices
    vals = [v * torch.sum(km, dim=-1) for v, km in zip(gate_vals, kept_masks)]
    denom = sum(vals)
    denom = torch.where(denom > 0, denom, torch.ones_like(denom))

    combine = torch.zeros((T, E, C), dtype=torch.float32,
                          device=logits.device)
    dispatch = torch.zeros_like(combine)
    for v, km, pos in zip(vals, kept_masks, positions):
        loc = F.one_hot(torch.clamp(pos, 0, C - 1).long(), C).float()  # [T, C]
        sel = km[:, :, None] * loc[:, None, :]                    # [T, E, C]
        dispatch = dispatch + sel
        combine = combine + (v / denom)[:, None, None] * sel
    return combine, dispatch, aux_loss


def gate_dispatch(x2d, gate_weight, top_k, capacity):
    """Route tokens: x2d [T, H], gate_weight [H, E] ->
    (combine [T, E, C], expert_in [E, C, H] in x2d's dtype, aux_loss)."""
    logits = x2d.float() @ gate_weight.float()
    combine, dispatch, aux = topk_gating(logits, top_k, capacity)
    expert_in = torch.einsum("tec,th->ech", dispatch,
                             x2d.float()).to(x2d.dtype)
    return combine, expert_in, aux


def expert_silu_ffn(expert_in, w_in, w_out):
    """Batched per-expert SiLU MLP: [E, C, H] x [E, H, F] x [E, F, H]; the
    SiLU in float32, cast back."""
    h = torch.bmm(expert_in, w_in)
    h = F.silu(h.float()).to(h.dtype)
    return torch.bmm(h, w_out)


def combine_output(combine, expert_out, dtype):
    """Weighted un-dispatch: [T, E, C] x [E, C, H] -> [T, H]."""
    return torch.einsum("tec,ech->th", combine,
                        expert_out.float()).to(dtype)
