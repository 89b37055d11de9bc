"""The trainer of the PyTorch port: the hybrid-parallel LLaMA step over
torch.distributed (one card with no mesh), ring attention and the
expert-parallel MoE FFN."""
from .transformer import (  # noqa: F401
    HybridParallelConfig, Mesh, build_hybrid_mesh, build_mesh,
    build_train_step, from_jax_opt_state, from_jax_params, init_opt_state,
    init_params, loss_and_grads, opt_state_specs, param_count, param_specs,
    pipeline_schedule_stats, shard_opt_state, shard_params, to_numpy,
    vpp_layer_perm, zero_dims,
)
from .ring_attention import (  # noqa: F401
    ring_attention, ring_self_attention, zigzag_permutation,
    zigzag_inverse_permutation,
)
from .moe import init_moe_params, moe_ffn  # noqa: F401
