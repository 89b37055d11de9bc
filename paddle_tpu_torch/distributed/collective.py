"""Communication API: groups and eager collectives over
``torch.distributed`` (counterpart of paddle_tpu/distributed/collective.py).

A ``Group`` is an ordered list of global ranks with, on its members, a
``ProcessGroup`` backend object (NCCL or gloo, as ``init_parallel_env``
chose) built over a ``PrefixStore`` of the default group's store.  So
``new_group`` is local to its members, as in the reference (torch's own
``new_group`` must be entered by every rank of the world); the n-th group
a rank builds over one rank list meets the other members' n-th.  The
world group is the default process group's backend.

The collectives take ``torch.Tensor``s and write in place where the
reference writes into its argument (``all_reduce``, ``broadcast``,
``reduce``, ``scatter``, ``reduce_scatter``, ``recv``); the list forms
append to the list they are given.  ``sync_op=False`` returns a task
whose ``wait()`` finishes the call; every call registers its work with
the watchdog (watchdog.py).  ``ReduceOp.AVG`` on gloo, which has none, is
SUM divided by the group's size.  A send to this same rank (the world-1
case) is handed to the matching receive through a buffer, as in the
reference; where no process group exists, a group of one rank is the
identity, as the reference's world-1 path is.

paddle_tpu/distributed/eager_comm.py, the reference's per-group compiled
XLA programs for eager collectives, has no port target: the
``torch.distributed`` calls here are those programs.
"""
from __future__ import annotations

import datetime
import pickle

import numpy as np
import torch
import torch.distributed as dist

from ..parallel.collectives import _P2PBatch
from .watchdog import watch

__all__ = ["ReduceOp", "Group", "new_group", "get_group", "is_available",
           "all_reduce", "all_gather", "all_gather_object", "broadcast",
           "reduce", "scatter", "alltoall", "all_to_all", "send", "recv",
           "barrier", "reduce_scatter", "destroy_process_group", "irecv",
           "isend", "batch_isend_irecv", "P2POp", "get_backend",
           "gather", "stream"]


class ReduceOp:
    SUM = 0
    MAX = 1
    MIN = 2
    PROD = 3
    AVG = 4


_TORCH_OPS = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.MAX: dist.ReduceOp.MAX,
              ReduceOp.MIN: dist.ReduceOp.MIN,
              ReduceOp.PROD: dist.ReduceOp.PRODUCT}


class Group:
    """A communication group: an ordered set of global ranks, optionally
    named for a mesh axis, with this rank's ``ProcessGroup`` backend
    (``process_group``; None where this rank is not a member or no process
    group exists)."""

    _next_id = 0

    def __init__(self, ranks, axis_name=None, pg_id=None, pg=None,
                 backend=None):
        self.ranks = list(ranks)
        self.nranks = len(self.ranks)
        self.axis_name = axis_name
        if pg_id is None:
            Group._next_id += 1
            pg_id = Group._next_id
        self.id = pg_id
        self._pg = pg
        self.backend = backend

    @property
    def world_size(self):
        return self.nranks

    def get_group_rank(self, rank):
        return self.ranks.index(rank) if rank in self.ranks else -1

    @property
    def rank(self):
        from .parallel import get_rank
        return self.get_group_rank(get_rank())

    def __repr__(self):
        return f"Group(id={self.id}, ranks={self.ranks}, axis={self.axis_name})"

    @property
    def process_group(self):
        return self._pg


_groups: dict[int, Group] = {}
_default_group: Group | None = None
_made: dict[tuple, int] = {}         # rank list -> groups this rank built


def _world_group() -> Group:
    global _default_group
    if _default_group is None:
        from . import parallel
        pg = backend = None
        if dist.is_initialized():
            backend = dist.get_backend()
            pg = dist.distributed_c10d._get_default_group()._get_backend(
                parallel._device())
        _default_group = Group(list(range(parallel.get_world_size())),
                               axis_name=None, pg_id=0, pg=pg,
                               backend=backend)
        _groups[0] = _default_group
    return _default_group


def new_group(ranks=None, backend=None, timeout=None, axis_name=None):
    """A group over ``ranks`` (global ranks; all of them by default),
    built by its members alone over the default group's store."""
    from . import parallel
    from ..parallel.transformer import _new_group, _timeout
    if ranks is None:
        ranks = list(range(parallel.get_world_size()))
    ranks = [int(r) for r in ranks]
    me = parallel.get_rank()
    pg = None
    backend = backend or (dist.get_backend() if dist.is_initialized()
                          else None)
    if me in ranks and dist.is_initialized():
        key = tuple(ranks)
        _made[key] = n = _made.get(key, 0) + 1
        prefix = f"paddle_tpu_torch/group/{'-'.join(map(str, ranks))}/{n}"
        store = dist.PrefixStore(prefix,
                                 dist.distributed_c10d._get_default_store())
        pg = _new_group(store, ranks.index(me), len(ranks), backend,
                        _timeout(timeout))
    g = Group(ranks, axis_name=axis_name, pg=pg, backend=backend)
    _groups[g.id] = g
    return g


def get_group(gid=0):
    if gid == 0:
        return _world_group()
    return _groups.get(gid)


def get_backend(group=None):
    """"nccl" or "gloo"; None before ``init_parallel_env``."""
    return (group or _world_group()).backend


def is_available():
    return dist.is_available()


def destroy_process_group(group=None):
    """Shut one group down, or (no group) every group and the default
    process group."""
    global _default_group
    from . import parallel
    if group is not None:
        _groups.pop(group.id, None)
        if group.id != 0 and hasattr(group._pg, "shutdown"):
            group._pg.shutdown()
        return
    for g in list(_groups.values()):
        if g.id != 0 and hasattr(g._pg, "shutdown"):
            g._pg.shutdown()
    _groups.clear()
    _made.clear()
    _default_group = None
    if dist.is_initialized():
        dist.destroy_process_group()
    parallel._reset()


class _Task:
    """What a call with ``sync_op=False`` returns: ``wait()`` waits for the
    work, finishes the call (AVG's division on gloo, a stack) and returns
    its result; ``is_completed()`` asks without waiting."""

    def __init__(self, work=None, then=None, result=None):
        self._work, self._then, self._result = work, then, result

    def is_completed(self):
        return self._work is None or self._work.is_completed()

    def wait(self):
        if self._work is not None:
            self._work.wait()
            self._work = None
        if self._then is not None:
            then, self._then = self._then, None
            out = then()
            if out is not None:
                self._result = out
        return self._result


def _members_pg(g):
    """The group's backend, or None for the reference's world-1 identity;
    raises where the group spans ranks and no process group exists."""
    if g._pg is not None:
        return g._pg
    if g.nranks <= 1 or (dist.is_initialized() and g.rank < 0):
        return None          # one rank, or a group this rank is not in
    raise RuntimeError(
        f"{g} has no process group here: call init_parallel_env() first "
        f"(under python -m paddle_tpu_torch.distributed.launch)")


def _finish(desc, g, work, shape, ret, sync_op, then=None):
    watch(desc, g.ranks, _Shaped(work, shape))
    task = _Task(work, then, ret)
    return task.wait() if sync_op else task


class _Shaped:
    """A work with the shape of what it moves, for the watchdog's dump."""

    __slots__ = ("work", "shape")

    def __init__(self, work, shape):
        self.work, self.shape = work, tuple(shape)

    def is_completed(self):
        return self.work.is_completed()


def _done(ret, sync_op):
    return ret if sync_op else _Task(result=ret)


def _avg_on_gloo(op, g):
    return op == ReduceOp.AVG and g.backend == "gloo"


def _torch_op(op, g):
    if op == ReduceOp.AVG:
        return dist.ReduceOp.SUM if g.backend == "gloo" else \
            dist.ReduceOp.AVG
    return _TORCH_OPS[int(op)]


def _divide(t, n):
    if t.is_floating_point() or t.is_complex():
        t.div_(n)
    else:
        t.floor_divide_(n)


def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True):
    """AllReduce in place."""
    g = group or _world_group()
    pg = _members_pg(g)
    if pg is None:
        return _done(tensor, sync_op)
    opts = dist.AllreduceOptions()
    opts.reduceOp = _torch_op(op, g)
    work = pg.allreduce([tensor], opts)
    then = (lambda: _divide(tensor, g.nranks)) if _avg_on_gloo(op, g) \
        else None
    return _finish("all_reduce", g, work, tensor.shape, tensor, sync_op,
                   then)


def all_gather(tensor_list, tensor, group=None, sync_op=True, axis=0):
    """Every rank's tensor, in rank order: appended to tensor_list, or
    returned stacked when tensor_list is not a list."""
    g = group or _world_group()
    pg = _members_pg(g)
    if pg is None:
        if isinstance(tensor_list, list):
            tensor_list.append(tensor)
            return _done(tensor_list, sync_op)
        return _done(tensor, sync_op)
    outs = [torch.empty_like(tensor) for _ in range(g.nranks)]
    work = pg.allgather([outs], [tensor.contiguous()])
    if isinstance(tensor_list, list):
        tensor_list.extend(outs)
        return _finish("all_gather", g, work, tensor.shape, tensor_list,
                       sync_op)
    # stacked over the ranks; one rank's gives its tensor, as the
    # reference's world-1 path does
    return _finish("all_gather", g, work, tensor.shape, None, sync_op,
                   lambda: torch.stack(outs) if g.nranks > 1 else outs[0])


def _device_of(g):
    from . import parallel
    return parallel._device() if g.backend == "nccl" else torch.device("cpu")


def all_gather_object(object_list, obj, group=None):
    """Every rank's picklable obj, in rank order, appended to
    object_list: the lengths, then one padded byte tensor."""
    g = group or _world_group()
    pg = _members_pg(g)
    if pg is None:
        object_list.append(obj)
        return object_list
    dev = _device_of(g)
    payload = np.frombuffer(pickle.dumps(obj), np.uint8)
    size = torch.tensor([payload.size], dtype=torch.int64, device=dev)
    sizes = []
    all_gather(sizes, size, group=g)
    cap = int(max(int(s.item()) for s in sizes))
    buf = torch.zeros((cap,), dtype=torch.uint8, device=dev)
    buf[:payload.size] = torch.from_numpy(payload.copy()).to(dev)
    got = []
    all_gather(got, buf, group=g)
    for s, b in zip(sizes, got):
        object_list.append(pickle.loads(b[:int(s.item())].cpu().numpy()
                                        .tobytes()))
    return object_list


def broadcast(tensor, src=0, group=None, sync_op=True):
    """src's tensor into every rank's, in place (src a global rank)."""
    g = group or _world_group()
    pg = _members_pg(g)
    if pg is None:
        return _done(tensor, sync_op)
    src_idx = g.get_group_rank(src)
    if src_idx < 0:
        raise ValueError(f"src rank {src} is not in group {g.ranks}")
    opts = dist.BroadcastOptions()
    opts.rootRank = src_idx
    opts.rootTensor = 0
    work = pg.broadcast([tensor], opts)
    return _finish("broadcast", g, work, tensor.shape, tensor, sync_op)


def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, sync_op=True):
    """As the reference: every member gets the reduction (only dst's value
    is defined by the Paddle API)."""
    return all_reduce(tensor, op, group, sync_op)


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    """src's tensor_list[r] into rank r's tensor, in place."""
    g = group or _world_group()
    pg = _members_pg(g)
    if pg is None:
        if tensor_list:
            tensor.copy_(tensor_list[0])
        return _done(tensor, sync_op)
    from .parallel import get_rank
    me = g.get_group_rank(get_rank())
    src_idx = g.get_group_rank(src)
    if me < 0 or src_idx < 0:
        raise ValueError(f"scatter: rank {get_rank()} / src {src} must both "
                         f"be in group {g.ranks}")
    opts = dist.ScatterOptions()
    opts.rootRank = src_idx
    inputs = [[t.contiguous() for t in tensor_list]] if me == src_idx else []
    work = pg.scatter([tensor], inputs, opts)
    return _finish("scatter", g, work, tensor.shape, tensor, sync_op)


def reduce_scatter(tensor, tensor_list, op=ReduceOp.SUM, group=None,
                   sync_op=True):
    """Rank r's tensor becomes the reduction over ranks of their
    tensor_list[r], in place."""
    g = group or _world_group()
    pg = _members_pg(g)
    if pg is None:
        if tensor_list:
            tensor.copy_(tensor_list[0])
        return _done(tensor, sync_op)
    inp = torch.cat([t.reshape(-1) for t in tensor_list])
    out = tensor if tensor.is_contiguous() else torch.empty_like(
        tensor, memory_format=torch.contiguous_format)
    opts = dist.ReduceScatterOptions()
    opts.reduceOp = _torch_op(op, g)
    work = pg._reduce_scatter_base(out.view(-1), inp, opts)

    def then():
        if _avg_on_gloo(op, g):
            _divide(out, g.nranks)
        if out is not tensor:
            tensor.copy_(out)
    return _finish("reduce_scatter", g, work, tensor.shape, tensor, sync_op,
                   then)


def alltoall(out_tensor_list, in_tensor_list, group=None, sync_op=True):
    """in_tensor_list[j] goes to rank j; what each rank sent this one is
    appended to out_tensor_list in rank order."""
    g = group or _world_group()
    pg = _members_pg(g)
    if pg is None:
        out_tensor_list.extend(in_tensor_list)
        return _done(out_tensor_list, sync_op)
    inp = torch.stack([t.contiguous() for t in in_tensor_list])
    out = torch.empty_like(inp)
    work = pg.alltoall_base(out, inp, [], [], dist.AllToAllOptions())
    out_tensor_list.extend(out.unbind(0))
    return _finish("alltoall", g, work, inp.shape, out_tensor_list,
                   sync_op)


all_to_all = alltoall

_p2p_buffer: list = []


def _me():
    from .parallel import get_rank
    return get_rank()


def send(tensor, dst=0, group=None, sync_op=True):
    g = group or _world_group()
    if dst == _me() or _members_pg(g) is None:
        _p2p_buffer.append(tensor.detach().clone())
        return _done(tensor, sync_op)
    work = g._pg.send([tensor.contiguous()], g.get_group_rank(dst), 0)
    return _finish("send", g, work, tensor.shape, tensor, sync_op)


def recv(tensor, src=0, group=None, sync_op=True):
    g = group or _world_group()
    if src == _me() or _members_pg(g) is None:
        if _p2p_buffer:
            tensor.copy_(_p2p_buffer.pop(0))
        return _done(tensor, sync_op)
    work = g._pg.recv([tensor], g.get_group_rank(src), 0)
    return _finish("recv", g, work, tensor.shape, tensor, sync_op)


class P2POp:
    def __init__(self, op, tensor, peer, group=None):
        self.op = op
        self.tensor = tensor
        self.peer = peer
        self.group = group


def isend(tensor, dst, group=None):
    return send(tensor, dst, group, sync_op=False)


def irecv(tensor, src=None, group=None):
    return recv(tensor, src or 0, group, sync_op=False)


def batch_isend_irecv(p2p_op_list):
    """Posts every op (on NCCL as one group call) and returns their
    tasks."""
    if not p2p_op_list:
        return []
    g = p2p_op_list[0].group or _world_group()
    pg = g._pg
    if pg is None or all(op.peer == _me() for op in p2p_op_list):
        # nothing crosses ranks (the world-1 buffer): no group call
        return [op.op(op.tensor, op.peer, op.group) for op in p2p_op_list]
    with _P2PBatch(pg, p2p_op_list[0].tensor) as batch:
        tasks = [op.op(op.tensor, op.peer, op.group) for op in p2p_op_list]
    return tasks + [_Task(w) for w in batch.works]


def gather(tensor, gather_list=None, dst=0, group=None, sync_op=True):
    """As the reference: every rank's tensor appended to gather_list on
    every rank (an all_gather)."""
    return all_gather(gather_list if gather_list is not None else [], tensor,
                      group)


def barrier(group=None):
    g = group or _world_group()
    pg = _members_pg(g)
    if pg is None:
        return
    opts = dist.BarrierOptions()
    if g.backend == "nccl":
        opts.device_ids = [_device_of(g).index]
    opts.timeout = datetime.timedelta(minutes=30)
    work = pg.barrier(opts)
    watch("barrier", g.ranks, work)
    work.wait()


class stream:
    """paddle.distributed.stream namespace (the same calls; their
    ``sync_op`` picks a task or a finished call)."""

    all_reduce = staticmethod(all_reduce)
    all_gather = staticmethod(all_gather)
    broadcast = staticmethod(broadcast)
    reduce = staticmethod(reduce)
    scatter = staticmethod(scatter)
    alltoall = staticmethod(alltoall)
    reduce_scatter = staticmethod(reduce_scatter)
    send = staticmethod(send)
    recv = staticmethod(recv)
