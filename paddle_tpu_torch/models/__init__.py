"""Model definitions of the PyTorch port."""
from .llama import LlamaConfig, LlamaForCausalLM, from_jax_decode_params

__all__ = ["LlamaConfig", "LlamaForCausalLM", "from_jax_decode_params"]
