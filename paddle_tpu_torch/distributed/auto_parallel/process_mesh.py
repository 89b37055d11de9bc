"""ProcessMesh: the DistTensor mesh abstraction (counterpart of
paddle_tpu/distributed/auto_parallel/process_mesh.py).

A grid of process ids with named dims.  ``jax_mesh()`` keeps the
reference's name and returns the port's mesh: the hybrid trainer's
``Mesh`` (paddle_tpu_torch/parallel/transformer.py) over the same ranks,
one process group an axis, its dims mapped onto the trainer's axes.
"""
from __future__ import annotations

import numpy as np

__all__ = ["ProcessMesh", "get_mesh", "set_mesh"]

_global_mesh = None

# a dim's name -> the hybrid mesh axis it rides (Paddle's and the
# trainer's names)
_AXIS_OF = {"pp": "pp", "pipe": "pp", "dp": "dp", "data": "dp",
            "sharding": "dp", "cp": "cp", "sep": "cp", "tp": "tp",
            "mp": "tp", "model": "tp"}


class ProcessMesh:
    def __init__(self, mesh=None, dim_names=None, shape=None, process_ids=None):
        if mesh is not None:
            arr = np.asarray(mesh)
        else:
            arr = np.asarray(process_ids).reshape(shape)
        self._mesh_arr = arr
        self._shape = list(arr.shape)
        self._process_ids = arr.ravel().tolist()
        if dim_names is None:
            dim_names = [f"d{i}" for i in range(arr.ndim)]
        self._dim_names = list(dim_names)
        self._jax_mesh = None

    @property
    def shape(self):
        return list(self._shape)

    @property
    def ndim(self):
        return len(self._shape)

    @property
    def process_ids(self):
        return list(self._process_ids)

    @property
    def dim_names(self):
        return list(self._dim_names)

    @property
    def mesh(self):
        return self._mesh_arr

    def get_dim_size(self, dim_name):
        return self._shape[self._dim_names.index(dim_name)]

    def get_rank_by_dim_and_process_id(self, dim_name, process_id):
        axis = self._dim_names.index(dim_name)
        loc = np.argwhere(self._mesh_arr == process_id)
        return int(loc[0][axis]) if len(loc) else -1

    def jax_mesh(self):
        """The hybrid trainer's ``Mesh`` over these ranks (this process
        one of them): each dim maps onto an axis of ("pp", "dp", "cp",
        "tp") by name (``_AXIS_OF``; dims on one axis fold into it in
        order, missing axes have size 1).  Made once, by every rank of
        the mesh together, over the default group's store
        (``init_parallel_env``)."""
        if self._jax_mesh is None:
            from ...parallel.transformer import AXES, _mesh_from_layout
            unknown = [d for d in self._dim_names if d not in _AXIS_OF]
            if unknown:
                raise ValueError(
                    f"ProcessMesh dims {unknown} name no axis of the hybrid "
                    f"mesh; use {sorted(_AXIS_OF)}")
            axis = [AXES.index(_AXIS_OF[d]) for d in self._dim_names]
            order = sorted(range(self.ndim), key=lambda i: (axis[i], i))
            grid = np.transpose(self._mesh_arr, order)
            sizes = [1] * len(AXES)
            for i in order:
                sizes[axis[i]] *= self._shape[i]
            self._jax_mesh = _mesh_from_layout(
                grid.reshape(sizes), rank=None, world_size=None, store=None,
                backend=None, device=None, timeout=None)
        return self._jax_mesh

    def __eq__(self, other):
        return (isinstance(other, ProcessMesh)
                and self._shape == other._shape
                and self._process_ids == other._process_ids
                and self._dim_names == other._dim_names)

    def __hash__(self):
        return hash((tuple(self._shape), tuple(self._process_ids),
                     tuple(self._dim_names)))

    def __repr__(self):
        return (f"ProcessMesh(shape={self._shape}, dim_names={self._dim_names}, "
                f"process_ids={self._process_ids})")

    def __getitem__(self, index):
        """Sub-mesh along the first axis (reference ProcessMesh slicing)."""
        sub = self._mesh_arr[index]
        dim_names = self._dim_names[1:] if sub.ndim < self._mesh_arr.ndim else self._dim_names
        if sub.ndim == 0:
            sub = sub.reshape(1)
            dim_names = [self._dim_names[-1]]
        return ProcessMesh(sub, dim_names)


def get_mesh():
    return _global_mesh


def set_mesh(mesh):
    global _global_mesh
    _global_mesh = mesh
    return mesh
