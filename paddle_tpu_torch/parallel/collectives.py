"""The collectives the hybrid trainer calls inside its per-rank step, as
``torch.autograd.Function``s over an explicit process group.

They are the counterparts of the ``lax`` collectives that
paddle_tpu/parallel/transformer.py calls inside ``shard_map``, and each
backward is a transpose:

    all_gather (tiled)   <->  psum_scatter (tiled)
    psum                  ->  psum
    pmean                 ->  psum / n
    psum_replicated       ->  the identity
    pmax                      no gradient (the reference stops it)
    ppermute(perm)        ->  ppermute(inverse perm)
    all_to_all(split, concat) -> all_to_all(concat, split)

``psum`` transposes to ``psum`` where the ranks' cotangents differ and are
summed by the transpose, e.g. an aux loss ``pmean``'d over ep = dp that
the dp average then weighs.  Where every rank of the group goes on to
hold the same loss, which nothing averages afterwards (the vocab-parallel
cross entropy's sums over tp, the loss sum over cp), the cotangent of the
sum is replicated and its transpose is the identity: that is
``psum_replicated``.  The reference runs with ``check_vma=False`` and
transposes those sums to ``psum`` too, so its gradients are tp x cp (x pp
under GPipe and the interleaved schedule) times the single-device ones;
the port's equal the single-device step's in every layout.

A group is a ``ProcessGroup`` backend object (``ProcessGroupGloo`` or
``ProcessGroupNCCL``) built over a store, not a group registered with
``torch.distributed.init_process_group``: the calls go to the object's own
methods, so ranks that are threads of one process (the CPU tests) never
share a global default group.  Ranks in a group are the group's own ranks
(0 .. size - 1).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["all_gather", "psum_scatter", "psum", "psum_replicated",
           "pmean", "pmax",
           "ppermute", "all_to_all", "axis_index", "send", "recv",
           "allreduce_", "wait_all"]


# ---------------------------------------------------------------------------
# raw collectives (no autograd)
# ---------------------------------------------------------------------------

def allreduce_(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce of a contiguous tensor; returns it."""
    opts = dist.AllreduceOptions()
    opts.reduceOp = op
    group.allreduce([x], opts).wait()
    return x


def _all_gather(x, group, dim):
    n = group.size()
    x = x.contiguous()
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    group._allgather_base(out, x).wait()
    if dim == 0:
        return out
    shape = list(x.shape)
    out = out.view(n, *shape).movedim(0, dim)
    shape[dim] *= n
    return out.reshape(shape)


def _psum_scatter(x, group, dim):
    n = group.size()
    shape = list(x.shape)
    if shape[dim] % n:
        raise ValueError(f"psum_scatter: dim {dim} of {tuple(x.shape)} does "
                         f"not divide by {n}")
    k = shape[dim] // n
    inp = x.reshape(shape[:dim] + [n, k] + shape[dim + 1:]).movedim(dim, 0)
    shape[dim] = k
    # rank r's block is rows r * shape[0] .. of the flattened leading dim
    inp = inp.contiguous().view([n * shape[0]] + shape[1:])
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    group._reduce_scatter_base(out, inp).wait()
    return out


def _psum(x, group):
    return allreduce_(x.contiguous().clone(), group)


def _all_to_all(x, group, split_dim, concat_dim):
    n = group.size()
    shape = list(x.shape)
    if shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(x.shape)} "
                         f"does not divide by {n}")
    k = shape[split_dim] // n
    inp = x.reshape(shape[:split_dim] + [n, k] + shape[split_dim + 1:])
    inp = inp.movedim(split_dim, 0).contiguous()
    out = torch.empty_like(inp)
    group.alltoall_base(out, inp, [], []).wait()
    # out[j] is rank j's chunk; concatenate them along concat_dim in rank
    # order
    rest = shape[:split_dim] + [k] + shape[split_dim + 1:]
    out = out.movedim(0, concat_dim)
    rest[concat_dim] *= n
    return out.reshape(rest)


class _P2PBatch:
    """Posts a batch of point-to-point calls.  NCCL takes them as one
    group call (between ``_start_coalescing`` and ``_end_coalescing`` of
    the backend object, which take no device), so the sends and receives
    of a batch progress together; gloo's calls return at once and need
    nothing."""

    def __init__(self, group, x):
        self.group, self.works = group, []
        self.on = x.is_cuda and hasattr(group, "_start_coalescing")

    def __enter__(self):
        if self.on:
            self.group._start_coalescing()
        return self

    def __exit__(self, exc_type, *exc):
        if self.on and exc_type is None:
            self.works.append(self.group._end_coalescing())
        return False


def send(x: torch.Tensor, group, dst: int, tag: int = 0):
    """Post a send of x to group rank dst; returns the work to wait on
    (keep x alive until then)."""
    return group.send([x.contiguous()], dst, tag)


def recv(like: torch.Tensor, group, src: int, tag: int = 0):
    """Post a receive from group rank src into a new tensor shaped like
    ``like``; returns (tensor, work)."""
    buf = torch.empty_like(like, memory_format=torch.contiguous_format)
    return buf, group.recv([buf], src, tag)


def wait_all(works) -> None:
    for w in works:
        if w is not None:
            w.wait()


def _ppermute(x, group, perm):
    me = group.rank()
    dsts = [d for s, d in perm if s == me]
    srcs = [s for s, d in perm if d == me]
    x = x.contiguous()
    out = torch.zeros_like(x) if not srcs else None
    with _P2PBatch(group, x) as batch:
        for d in dsts:
            batch.works.append(send(x, group, d))
        for s in srcs:
            out, w = recv(x, group, s)
            batch.works.append(w)
    wait_all(batch.works)
    return out


# ---------------------------------------------------------------------------
# differentiable collectives
# ---------------------------------------------------------------------------

class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _psum_scatter(g, ctx.group, ctx.dim), None, None


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _psum_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, ctx.dim), None, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, scale):
        ctx.group, ctx.scale = group, scale
        out = _psum(x, group)
        return out / scale if scale != 1 else out

    @staticmethod
    def backward(ctx, g):
        out = _psum(g, ctx.group)
        return (out / ctx.scale if ctx.scale != 1 else out), None, None


class _PsumReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _psum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, perm):
        ctx.group, ctx.perm = group, perm
        return _ppermute(x, group, perm)

    @staticmethod
    def backward(ctx, g):
        inv = tuple((d, s) for s, d in ctx.perm)
        return _ppermute(g, ctx.group, inv), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.group, ctx.dims = group, (split_dim, concat_dim)
        return _all_to_all(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return _all_to_all(g, ctx.group, concat_dim, split_dim), None, None, \
            None


def all_gather(x, group, dim):
    """``lax.all_gather(x, axis, axis=dim, tiled=True)``: the group's
    shards concatenated along dim in rank order."""
    return _AllGather.apply(x, group, dim)


def psum_scatter(x, group, dim):
    """``lax.psum_scatter(x, axis, scatter_dimension=dim, tiled=True)``:
    the sum over the group, this rank's block of dim."""
    return _PsumScatter.apply(x, group, dim)


def psum(x, group):
    """``lax.psum``: the sum over the group."""
    return _Psum.apply(x, group, 1)


def psum_replicated(x, group):
    """``lax.psum`` of a value every rank of the group then holds as one
    loss: the backward passes the (replicated) cotangent through."""
    return _PsumReplicated.apply(x, group)


def pmean(x, group):
    """``lax.pmean``: the sum over the group divided by its size."""
    return _Psum.apply(x, group, group.size())


def pmax(x, group):
    """``lax.pmax`` of a detached tensor (the reference stops its
    gradient)."""
    return allreduce_(x.detach().contiguous().clone(), group,
                      dist.ReduceOp.MAX)


def ppermute(x, group, perm):
    """``lax.ppermute``: each (src, dst) pair of perm sends src's x to dst;
    a rank nothing is sent to gets zeros.  Every send and receive is
    posted before any is waited on."""
    return _Ppermute.apply(x, group, tuple(tuple(p) for p in perm))


def all_to_all(x, group, split_dim, concat_dim):
    """``lax.all_to_all(x, axis, split_dim, concat_dim, tiled=True)``:
    split_dim cut into size blocks, block j sent to rank j, the blocks
    received concatenated along concat_dim in rank order."""
    return _AllToAll.apply(x, group, split_dim, concat_dim)


def axis_index(mesh, axis: str) -> int:
    """``lax.axis_index``: this rank's coordinate on a mesh axis."""
    return mesh.index(axis)
