"""``paddle.nn.functional`` surface of the PyTorch port (counterpart of
paddle_tpu/nn/functional/): the attention functionals, and the common,
activation, loss, norm and conv functionals the eager surface has so far."""
from .activation import *  # noqa: F401,F403
from .attention import (flash_attention, flash_attn_unpadded,  # noqa: F401
                        scaled_dot_product_attention)
from .common import *  # noqa: F401,F403
from .conv import *  # noqa: F401,F403
from .loss import *  # noqa: F401,F403
from .norm import *  # noqa: F401,F403
from . import activation, common, conv, loss, norm

__all__ = (["scaled_dot_product_attention", "flash_attention",
            "flash_attn_unpadded"] + activation.__all__ + common.__all__
           + conv.__all__ + loss.__all__ + norm.__all__)
