"""Hybrid-parallel topology (counterpart of
paddle_tpu/distributed/fleet/topology.py): rank <-> (data, pipe,
sharding, sep, model) coordinates and the per-axis groups, each a
``collective.Group`` made by ``new_group`` over its members.

``get_jax_mesh()`` keeps the reference's name and returns the port's
mesh: the hybrid trainer's ``Mesh`` over the same ranks, with pipe as
its pp axis, sharding and data folded (in that order) into dp, sep as cp
and model as tp.
"""
from __future__ import annotations

import collections
import itertools

import numpy as np

from ..collective import new_group

__all__ = ["CommunicateTopology", "HybridCommunicateGroup", "ParallelMode"]


class ParallelMode:
    DATA_PARALLEL = 0
    TENSOR_PARALLEL = 1
    PIPELINE_PARALLEL = 2
    SHARDING_PARALLEL = 3
    SEGMENT_PARALLEL = 4


class CommunicateTopology:
    def __init__(self, hybrid_group_names=("data", "pipe", "sharding", "sep", "model"),
                 dims=(1, 1, 1, 1, 1)):
        self._parallel_names = list(hybrid_group_names)
        self._dims = list(dims)
        self.coordinate = collections.namedtuple("Coordinate", self._parallel_names)
        self.world_size = int(np.prod(self._dims))
        ranges = [range(d) for d in self._dims]
        all_coords = [self.coordinate(*c) for c in itertools.product(*ranges)]
        self._coord2rank = {c: i for i, c in enumerate(all_coords)}
        self._rank2coord = {i: c for c, i in self._coord2rank.items()}

    def get_hybrid_group_names(self):
        return self._parallel_names

    def get_dim(self, axis_name):
        return self._dims[self._parallel_names.index(axis_name)]

    get_dim_size = get_dim

    def get_rank(self, **kwargs):
        return self._coord2rank[self.coordinate(**kwargs)]

    def get_coord(self, rank):
        return self._rank2coord[rank]

    def get_axis_list(self, axis_name, index):
        axis = self._parallel_names.index(axis_name)
        return sorted(r for c, r in self._coord2rank.items() if c[axis] == index)

    def get_comm_list(self, axis_name):
        """All groups along axis_name: list of rank-lists."""
        axis = self._parallel_names.index(axis_name)
        other_ranges = [range(d) for i, d in enumerate(self._dims) if i != axis]
        out = []
        for other in itertools.product(*other_ranges):
            ranks = []
            for v in range(self._dims[axis]):
                coord = list(other)
                coord.insert(axis, v)
                ranks.append(self._coord2rank[self.coordinate(*coord)])
            out.append(ranks)
        return out

    def get_rank_from_stage(self, global_rank, **kwargs):
        coord = self.get_coord(global_rank)
        tf = coord._replace(**kwargs)._asdict()
        return self.get_rank(**tf)


class HybridCommunicateGroup:
    def __init__(self, topology: CommunicateTopology):
        self._topo = topology
        from ..parallel import get_rank
        self.global_rank = get_rank()
        self._dp_degree = self._topo.get_dim("data")
        self._mp_degree = self._topo.get_dim("model")
        self._pp_degree = self._topo.get_dim("pipe")
        self._sharding_degree = self._topo.get_dim("sharding")
        self._sep_degree = (self._topo.get_dim("sep")
                            if "sep" in self._topo.get_hybrid_group_names() else 1)

        self._dp_group, self._dp_comm_group = self._build("data")
        self._mp_group, self._mp_comm_group = self._build("model")
        self._pp_group, self._pp_comm_group = self._build("pipe")
        self._sharding_group, self._sharding_comm_group = self._build("sharding")
        if self._sep_degree > 1 or "sep" in self._topo.get_hybrid_group_names():
            self._sep_group, self._sep_comm_group = self._build("sep")
        else:
            self._sep_group, self._sep_comm_group = None, None

    def _build(self, axis_name):
        comm_lists = self._topo.get_comm_list(axis_name)
        my_group = None
        my_ranks = None
        axis_alias = {"data": "dp", "model": "mp", "pipe": "pp",
                      "sharding": "sharding", "sep": "sep"}[axis_name]
        for ranks in comm_lists:
            if self.global_rank in ranks:
                my_ranks = ranks
                my_group = new_group(ranks, axis_name=axis_alias)
        return my_ranks, my_group

    # topology info
    def topology(self):
        return self._topo

    def get_parallel_mode(self):
        if self._mp_degree == 1 and self._pp_degree == 1 and \
                self._sharding_degree == 1 and self._dp_degree > 1:
            return ParallelMode.DATA_PARALLEL
        if self._mp_degree > 1:
            return ParallelMode.TENSOR_PARALLEL
        if self._pp_degree > 1:
            return ParallelMode.PIPELINE_PARALLEL
        if self._sharding_degree > 1:
            return ParallelMode.SHARDING_PARALLEL
        return ParallelMode.DATA_PARALLEL

    # data parallel
    def get_data_parallel_rank(self):
        return self._topo.get_coord(self.global_rank).data

    def get_data_parallel_world_size(self):
        return self._dp_degree

    def get_data_parallel_group(self):
        return self._dp_comm_group

    def get_data_parallel_group_src_rank(self):
        return self._dp_group[0]

    # model (tensor) parallel
    def get_model_parallel_rank(self):
        return self._topo.get_coord(self.global_rank).model

    def get_model_parallel_world_size(self):
        return self._mp_degree

    def get_model_parallel_group(self):
        return self._mp_comm_group

    def get_model_parallel_group_src_rank(self):
        return self._mp_group[0]

    # pipeline parallel
    def get_stage_id(self):
        return self._topo.get_coord(self.global_rank).pipe

    def get_pipe_parallel_rank(self):
        return self.get_stage_id()

    def get_pipe_parallel_world_size(self):
        return self._pp_degree

    def get_pipe_parallel_group(self):
        return self._pp_comm_group

    def is_first_stage(self):
        return self.get_stage_id() == 0

    def is_last_stage(self):
        return self.get_stage_id() == self._pp_degree - 1

    def get_p2p_groups(self):
        return None

    # sharding
    def get_sharding_parallel_rank(self):
        return self._topo.get_coord(self.global_rank).sharding

    def get_sharding_parallel_world_size(self):
        return self._sharding_degree

    def get_sharding_parallel_group(self):
        return self._sharding_comm_group

    def get_sharding_parallel_group_src_rank(self):
        return self._sharding_group[0]

    # sep
    def get_sep_parallel_rank(self):
        c = self._topo.get_coord(self.global_rank)
        return getattr(c, "sep", 0)

    def get_sep_parallel_world_size(self):
        return self._sep_degree

    def get_sep_parallel_group(self):
        return self._sep_comm_group

    def get_rank_from_stage(self, stage_id, **kwargs):
        return self._topo.get_rank_from_stage(self.global_rank, pipe=stage_id,
                                              **kwargs)

    def get_jax_mesh(self):
        """The hybrid trainer's ``Mesh`` of this topology (pipe -> pp,
        sharding x data -> dp, sep -> cp, model -> tp), made once by every
        rank together over the default group's store; None when no process
        group of the topology's world size exists (then layers degenerate
        to serial)."""
        if getattr(self, "_jax_mesh", None) is not None:
            return self._jax_mesh
        import torch.distributed as dist

        world = self._topo.world_size
        if not dist.is_initialized() or dist.get_world_size() != world:
            return None
        alias = {"pipe": "pp", "sep": "sep", "sharding": "sharding",
                 "data": "dp", "model": "mp"}
        present = self._topo.get_hybrid_group_names()
        order = [n for n in ("pipe", "sharding", "data", "sep", "model")
                 if n in present]
        topo_dims = [self._topo.get_dim(n) for n in present]
        grid = np.arange(world).reshape(topo_dims)
        perm = [present.index(n) for n in order]
        rank_grid = np.transpose(grid, perm)
        from ..auto_parallel.process_mesh import ProcessMesh
        self._jax_mesh = ProcessMesh(
            rank_grid, [alias[n] for n in order]).jax_mesh()
        return self._jax_mesh
