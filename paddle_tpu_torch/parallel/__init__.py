"""The trainer of the PyTorch port: the single-card LLaMA train step."""
from .transformer import (  # noqa: F401
    HybridParallelConfig, build_train_step, from_jax_opt_state,
    from_jax_params, init_opt_state, init_params, loss_and_grads,
    param_count, to_numpy,
)
