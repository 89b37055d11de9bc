"""``paddle.nn.functional`` surface of the PyTorch port: the attention
functionals (counterpart of paddle_tpu/nn/functional/attention.py)."""
from .attention import (flash_attention, flash_attn_unpadded,
                        scaled_dot_product_attention)

__all__ = ["scaled_dot_product_attention", "flash_attention",
           "flash_attn_unpadded"]
