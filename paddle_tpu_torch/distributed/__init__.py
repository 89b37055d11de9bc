"""distributed for the port: the process layer (counterpart of
paddle_tpu/distributed, the part that needs no eager ``Tensor`` or
``nn.Layer``).

- ``store``: the rendezvous ``TCPStore`` over ``torch.distributed``'s;
- ``parallel``: ``ParallelEnv``, ``init_parallel_env`` (the default
  NCCL or gloo process group from the launcher's environment), ``spawn``,
  and ``DataParallel`` over a ``torch.nn.Module``;
- ``collective``: groups and the eager collectives on ``torch.Tensor``;
- ``watchdog``: hang reports for in-flight collectives;
- ``launch``: ``python -m paddle_tpu_torch.distributed.launch``;
- ``fleet``: role makers, the hybrid topology, the elastic manager;
- ``rpc``; ``auto_parallel.ProcessMesh``.

The rest of the reference's package (auto_parallel's API and planner,
checkpoint, ps, sharding, fleet base and meta_parallel, the auto-tuner)
is ROADMAP item 14b.
"""
from __future__ import annotations

import importlib

# name -> the submodule that defines it; loaded on first use, so that
# ``python -m paddle_tpu_torch.distributed.launch`` starts its workers
# without importing torch itself
_EXPORTS = {
    **dict.fromkeys(
        ("Group", "P2POp", "ReduceOp", "all_gather", "all_gather_object",
         "all_reduce", "all_to_all", "alltoall", "barrier",
         "batch_isend_irecv", "broadcast", "destroy_process_group", "gather",
         "get_backend", "get_group", "irecv", "is_available", "isend",
         "new_group", "recv", "reduce", "reduce_scatter", "scatter", "send",
         "stream"), ".collective"),
    **dict.fromkeys(
        ("DataParallel", "ParallelEnv", "get_rank", "get_world_size",
         "init_parallel_env", "is_initialized", "spawn"), ".parallel"),
    **dict.fromkeys(("ProcessMesh", "get_mesh", "set_mesh"),
                    ".auto_parallel.process_mesh"),
}
_SUBMODULES = ("auto_parallel", "collective", "fleet", "launch", "parallel",
               "rpc", "store", "watchdog")

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        value = getattr(importlib.import_module(_EXPORTS[name], __name__),
                        name)
    elif name in _SUBMODULES:
        value = importlib.import_module(f".{name}", __name__)
    else:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS) | set(_SUBMODULES))
