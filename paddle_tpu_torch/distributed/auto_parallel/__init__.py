"""Auto-parallel for the port: so far the process mesh (the DistTensor
API and the planner are ROADMAP item 14b)."""
from .process_mesh import ProcessMesh, get_mesh, set_mesh  # noqa: F401

__all__ = ["ProcessMesh", "get_mesh", "set_mesh"]
