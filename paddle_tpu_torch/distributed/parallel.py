"""Parallel environment and DataParallel (counterpart of
paddle_tpu/distributed/parallel.py).

``init_parallel_env()`` makes torch's default process group from the
launcher's environment (``python -m paddle_tpu_torch.distributed.launch``):
rank ``PADDLE_TRAINER_ID`` of ``PADDLE_TRAINERS_NUM``, meeting through a
``TCPStore`` that rank 0 hosts on ``PADDLE_MASTER``'s host at its port + 1
(the port itself belongs to the launcher's own store on multi-node runs,
as the reference places its coordinator).  The backend is
``PADDLE_DISTRI_BACKEND`` (Paddle's variable): NCCL by default, on
``cuda:FLAGS_selected_gpus`` (the launcher sets it to the local rank, or
the rank's entry of ``--devices``); gloo on the CPU only when asked.
With no CUDA and no explicit gloo it raises: there is no CPU fallback.

``DataParallel`` wraps a ``torch.nn.Module``: its trainable parameters'
gradient hooks feed ``_BucketReducer``, which groups them in reverse
order into buckets (the first 1 MB, then 25 MB) and, when a bucket's
gradients have all arrived in a backward, averages them over the group
in one all-reduce; gradients accumulated under ``no_sync`` are averaged
at the next synchronized backward.
"""
from __future__ import annotations

import contextlib
import datetime
import os

import torch
import torch.distributed as dist

from .store import TCPStore

__all__ = ["ParallelEnv", "init_parallel_env", "get_rank", "get_world_size",
           "is_initialized", "DataParallel", "spawn"]

_initialized = False
_store = None           # the TCPStore the default group meets through
_dev = None             # this rank's device for its collectives

STORE_TIMEOUT_S = 900.0
GROUP_TIMEOUT = datetime.timedelta(minutes=30)


class ParallelEnv:
    """Reads the launch env contract (PADDLE_TRAINER_ID and friends, then
    torchrun's RANK / WORLD_SIZE), falling back on the default process
    group, else rank 0 of 1."""

    def __init__(self):
        r = os.environ.get("PADDLE_TRAINER_ID", os.environ.get("RANK"))
        w = os.environ.get("PADDLE_TRAINERS_NUM",
                           os.environ.get("WORLD_SIZE"))
        up = dist.is_available() and dist.is_initialized()
        self._rank = int(r) if r is not None else \
            (dist.get_rank() if up else 0)
        self._world_size = int(w) if w is not None else \
            (dist.get_world_size() if up else 1)
        self._device_id = int(os.environ.get(
            "FLAGS_selected_gpus", os.environ.get(
                "PADDLE_LOCAL_RANK", os.environ.get("LOCAL_RANK", 0))))

    @property
    def rank(self):
        return self._rank

    @property
    def world_size(self):
        return self._world_size

    @property
    def device_id(self):
        return self._device_id

    @property
    def dev_id(self):
        return self._device_id

    local_rank = rank
    nranks = world_size

    @property
    def current_endpoint(self):
        return os.environ.get("PADDLE_CURRENT_ENDPOINT", "127.0.0.1:6170")

    @property
    def trainer_endpoints(self):
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        return eps.split(",") if eps else [self.current_endpoint]


def _backend() -> str:
    b = os.environ.get("PADDLE_DISTRI_BACKEND", "nccl").strip().lower()
    if b not in ("nccl", "gloo"):
        raise ValueError(f"PADDLE_DISTRI_BACKEND must be 'nccl' or 'gloo', "
                         f"got {b!r}")
    return b


def _coordinator(env):
    """The host and port the ranks meet on: PADDLE_MASTER's host at its
    port + 1, else rank 0's endpoint; None for a world of one started
    without a launcher."""
    master = os.environ.get("PADDLE_MASTER")
    if master and ":" in master:
        host, port = master.rsplit(":", 1)
        return host, int(port) + 1
    if env.world_size == 1 and "PADDLE_TRAINER_ENDPOINTS" not in os.environ:
        return None
    host, port = env.trainer_endpoints[0].rsplit(":", 1)
    return host, int(port)


def init_parallel_env():
    """Make the default process group from the launcher's environment and
    return a ``ParallelEnv`` (None when already initialized)."""
    global _initialized, _store, _dev
    if _initialized:
        return None
    env = ParallelEnv()
    backend = _backend()
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "init_parallel_env: the NCCL backend needs CUDA, and none is "
                "available; set PADDLE_DISTRI_BACKEND=gloo for CPU ranks")
        _dev = torch.device("cuda", env.device_id)
        torch.cuda.set_device(_dev)
    else:
        _dev = torch.device("cpu")
    where = _coordinator(env)
    if where is None:
        base = dist.HashStore()
    else:
        _store = TCPStore(where[0], where[1], is_master=(env.rank == 0),
                          timeout=STORE_TIMEOUT_S)
        base = _store.torch_store
    dist.init_process_group(
        backend, store=dist.PrefixStore("paddle_tpu_torch/default", base),
        rank=env.rank, world_size=env.world_size, timeout=GROUP_TIMEOUT)
    _initialized = True
    from .collective import _world_group
    _world_group()
    return ParallelEnv()


def _device():
    """This rank's collective device (init_parallel_env's)."""
    return _dev if _dev is not None else torch.device("cpu")


def _reset():
    global _initialized, _store, _dev
    _initialized, _store, _dev = False, None, None


def is_initialized():
    return _initialized


def get_rank(group=None):
    if group is not None:
        return group.rank
    return ParallelEnv().rank


def get_world_size(group=None):
    if group is not None:
        return group.nranks
    return ParallelEnv().world_size


def spawn(func, args=(), nprocs=-1, join=True, daemon=False, **options):
    """Runs func for one process; more processes are the launcher's job
    (``python -m paddle_tpu_torch.distributed.launch``), as in the
    reference."""
    if nprocs in (-1, 0, 1):
        func(*args)
        return None
    raise NotImplementedError(
        "multi-process spawn: use python -m "
        "paddle_tpu_torch.distributed.launch --nproc_per_node N")


class _BucketReducer:
    """Groups parameters into ~comm_buffer_size-MB buckets in reverse order
    (the order gradients become ready in backward; the first bucket is
    last_comm_buffer_size MB); when every gradient of a bucket has arrived,
    flattens them into one f32 buffer and averages it over the group in
    one all-reduce.

    A leaf's gradient hook fires once a backward with its summed gradient
    (shared parameters included), before autograd adds it to ``.grad``.
    What a bucket averages is each parameter's whole ``.grad`` after this
    backward, so gradients accumulated under ``no_sync`` are averaged at
    the next synchronized backward, as over the whole batch (the
    reference averages only the new backward's and adds it to them).  The
    hook that completes a bucket clears its ``.grad`` and returns its
    average; the bucket's other parameters, whose gradients autograd has
    already added, take theirs in place.  A bucket some of whose
    parameters got no gradient is averaged, with their ``.grad`` or
    zeros, when the backward ends."""

    def __init__(self, params, group, world, bucket_mb=25, last_bucket_mb=1):
        self.group = group
        self.world = world
        self.enabled = True
        self.buckets = []           # list[list[Parameter]]
        self._bucket_of = {}        # id(param) -> bucket index
        cap_last = last_bucket_mb * (1 << 20)
        cap = bucket_mb * (1 << 20)
        cur, cur_bytes, limit = [], 0, cap_last  # first (=last-ready) small
        for p in reversed(list(params)):
            nbytes = p.numel() * p.element_size()
            if cur and cur_bytes + nbytes > limit:
                self.buckets.append(cur)
                cur, cur_bytes, limit = [], 0, cap
            cur.append(p)
            cur_bytes += nbytes
        if cur:
            self.buckets.append(cur)
        for bi, bucket in enumerate(self.buckets):
            for p in bucket:
                self._bucket_of[id(p)] = bi
        self._pending = [dict() for _ in self.buckets]
        self._in_backward = False

    def on_grad(self, p, grad):
        """The hook of p: returns the gradient autograd should add to
        p.grad (the reduced slice when this one completes its bucket, the
        raw gradient otherwise)."""
        if not self.enabled or self.world <= 1:
            return grad
        if not self._in_backward:
            # a new backward: pending gradients of one that never finished
            # must not leak into it
            self._pending = [dict() for _ in self.buckets]
            self._in_backward = True
            torch.autograd.Variable._execution_engine.queue_callback(
                self._on_backward_done)
        bi = self._bucket_of[id(p)]
        pend = self._pending[bi]
        # the whole gradient p.grad will hold after this backward
        pend[id(p)] = grad if p.grad is None else p.grad + grad
        if len(pend) < len(self.buckets[bi]):
            return grad
        return self._flush(bi, ret_for=id(p))

    def _flush(self, bi, ret_for=None):
        from .collective import ReduceOp, all_reduce
        bucket = self.buckets[bi]
        pend = self._pending[bi]
        flat = torch.cat([pend[id(p)].reshape(-1).float() for p in bucket])
        all_reduce(flat, ReduceOp.AVG, self.group)
        ret = None
        off = 0
        for p in bucket:
            n = p.numel()
            piece = flat[off:off + n].view(p.shape).to(pend[id(p)].dtype)
            off += n
            if id(p) == ret_for:
                p.grad = None   # autograd sets p.grad to what the hook
                ret = piece     # returns
            elif p.grad is not None:
                p.grad.copy_(piece)
            else:
                p.grad = piece
        self._pending[bi] = {}
        return ret

    def _on_backward_done(self):
        self._in_backward = False
        if self.enabled and self.world > 1:
            self.flush_incomplete()

    def flush_incomplete(self):
        """Reduce the buckets some of whose parameters produced no gradient
        in this backward (they contribute zeros: every rank must still
        enter the collective)."""
        for bi, bucket in enumerate(self.buckets):
            pend = self._pending[bi]
            if not pend:
                continue
            for p in bucket:
                if id(p) not in pend:
                    pend[id(p)] = torch.zeros_like(p) if p.grad is None \
                        else p.grad
            self._flush(bi)


class DataParallel(torch.nn.Module):
    """Data-parallel wrapper of a ``torch.nn.Module``: with more than one
    rank, gradient hooks feed a bucketed reducer that averages the
    gradients over the group (the world by default) during backward."""

    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None):
        super().__init__()
        self._layers = layers
        self.group = group
        self.find_unused_parameters = find_unused_parameters
        world = get_world_size(group)
        self._reducer = None
        if world > 1:
            params = [p for p in layers.parameters() if p.requires_grad]
            self._reducer = _BucketReducer(params, group, world,
                                           comm_buffer_size,
                                           last_comm_buffer_size)

            def make_hook(p):
                def hook(grad):
                    return self._reducer.on_grad(p, grad)
                return hook
            for p in params:
                p.register_hook(make_hook(p))

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.load_state_dict(state_dict, *args, **kwargs)

    def scale_loss(self, loss):
        return loss

    def apply_collective_grads(self):
        if self._reducer is not None:
            self._reducer.flush_incomplete()

    def no_sync(self):
        @contextlib.contextmanager
        def ctx():
            if self._reducer is None:
                yield
                return
            self._reducer.enabled = False
            try:
                yield
            finally:
                self._reducer.enabled = True
        return ctx()
