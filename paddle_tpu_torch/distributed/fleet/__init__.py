"""fleet for the port: so far the role makers, the hybrid topology and
the elastic manager (counterpart of paddle_tpu/distributed/fleet; fleet
base, the mpu layers, meta_parallel, recompute and the rest are ROADMAP
item 14b)."""
from .role_maker import (  # noqa: F401
    PaddleCloudRoleMaker, Role, RoleMakerBase, UserDefinedRoleMaker)
from .topology import (  # noqa: F401
    CommunicateTopology, HybridCommunicateGroup, ParallelMode)
from . import elastic  # noqa: F401
