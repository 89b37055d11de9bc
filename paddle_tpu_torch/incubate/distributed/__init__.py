"""``paddle.incubate.distributed`` of the PyTorch port (ported so far: the
MoE gating math)."""
from . import models  # noqa: F401
