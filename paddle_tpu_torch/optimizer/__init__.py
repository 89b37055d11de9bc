"""optimizer namespace (counterpart of paddle_tpu/optimizer/)."""
from . import lr  # noqa: F401
from .optimizer import Optimizer  # noqa: F401
from .optimizers import (  # noqa: F401
    ASGD, LBFGS, SGD, Adadelta, Adagrad, Adam, Adamax, AdamW, Lamb, Momentum,
    NAdam, RAdam, RMSProp, Rprop,
)
