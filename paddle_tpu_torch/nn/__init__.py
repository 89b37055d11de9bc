"""``paddle.nn`` surface of the PyTorch port (counterpart of
paddle_tpu/nn/): ``Layer``, the containers, the common, activation, loss,
norm and conv layers, initializers, gradient clipping and
``nn.functional``.  The rest of the JAX package's ``nn`` (rnn,
transformer, pooling, extension, quant, utils) is not ported yet
(ROADMAP.md Queue 1 item 13)."""
from . import functional  # noqa: F401
from . import initializer  # noqa: F401
from .clip import (  # noqa: F401
    ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue, clip_grad_norm_,
    clip_grad_value_,
)
from .initializer.attr import ParamAttr  # noqa: F401
from .layer.activation import *  # noqa: F401,F403
from .layer.common import *  # noqa: F401,F403
from .layer.container import *  # noqa: F401,F403
from .layer.conv import *  # noqa: F401,F403
from .layer.layers import Layer  # noqa: F401
from .layer.loss import *  # noqa: F401,F403
from .layer.norm import *  # noqa: F401,F403
