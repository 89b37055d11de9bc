"""Expert parallelism: the MoE FFN block with experts sharded over a
process group (counterpart of paddle_tpu/parallel/moe.py).

Tokens stay data-sharded, experts are sharded over the ep group, and two
``all_to_all`` collectives carry the (expert, slot) buffers between ranks.
In the hybrid trainer the ep group is the dp group.

    y, aux = moe_ffn(x_local, params, ep_group=mesh.group("dp"))
"""
from __future__ import annotations

import torch

from ..incubate.distributed.models.moe.gating import (
    capacity_for, combine_output, expert_silu_ffn, gate_dispatch)
from .collectives import all_to_all, pmean

__all__ = ["moe_ffn", "init_moe_params"]


def init_moe_params(generator, d_model: int, d_ffn: int, num_experts: int,
                    dtype=torch.float32, scale=0.02, *, device=None):
    """Returns {gate [H, E], w_in [E, H, F], w_out [E, F, H]} (global
    shapes; shard w_in / w_out dim 0 over ep), N(0, scale) drawn in f32
    from ``generator`` (a ``torch.Generator``, or an int seeding one on
    ``device``, the CPU by default).  The draws are not the JAX package's
    (that one takes a PRNG key)."""
    if not isinstance(generator, torch.Generator):
        generator = torch.Generator(device=device or "cpu").manual_seed(
            int(generator))
    dev = generator.device

    def normal(shape):
        w = torch.empty(shape, dtype=torch.float32, device=dev)
        return w.normal_(0.0, scale, generator=generator).to(dtype)

    return {"gate": normal((d_model, num_experts)),
            "w_in": normal((num_experts, d_model, d_ffn)),
            "w_out": normal((num_experts, d_ffn, d_model))}


def moe_ffn(x, params, ep_group=None, top_k: int = 2,
            capacity_factor: float = 2.0):
    """Gated MoE feed-forward over locally-sharded tokens.

    x: local [T_loc, H].  params: gate [H, E] replicated; w_in / w_out
    local expert shards [E_loc, H, F] / [E_loc, F, H] (E = ep * E_loc).
    Returns (y [T_loc, H], aux_loss scalar, pmean'd over ep when an ep
    group is given)."""
    ep = ep_group.size() if ep_group is not None else 1
    E_loc = params["w_in"].shape[0]
    E = ep * E_loc
    T_loc, H = x.shape

    C = capacity_for(T_loc, E, top_k, capacity_factor)
    # local buffers for EVERY global expert: [E, C, H]
    combine, expert_in, aux = gate_dispatch(x, params["gate"], top_k, C)

    if ep > 1:
        # rank r keeps its E_loc experts and receives their slots from
        # every rank, in rank order: [E, C, H] -> [E_loc, ep*C, H]
        expert_in = all_to_all(expert_in, ep_group, 0, 1)
    expert_out = expert_silu_ffn(expert_in, params["w_in"], params["w_out"])
    if ep > 1:
        # reverse exchange: [E_loc, ep*C, H] -> [E, C, H]
        expert_out = all_to_all(expert_out, ep_group, 1, 0)

    y = combine_output(combine, expert_out, x.dtype)
    if ep_group is not None:
        aux = pmean(aux, ep_group)
    return y, aux
