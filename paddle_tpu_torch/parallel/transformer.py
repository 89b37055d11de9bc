"""The hybrid-parallel LLaMA trainer: dp x pp x cp x tp (+ sequence
parallel), ZeRO and MoE with expert parallelism, as per-rank PyTorch code
over ``torch.distributed`` process groups (counterpart of
paddle_tpu/parallel/transformer.py).

``build_train_step(cfg, hp, mesh)`` returns this rank's ``train_step(params,
opt_state, tokens) -> (params, opt_state, loss)``: the next-token cross
entropy of a stack of pre-norm decoder blocks (RMSNorm, interleaved RoPE,
GQA attention through the flash attention kernels, SwiGLU or a top-k MoE
FFN), averaged over ``hp.num_microbatches`` microbatches, its gradients,
their reductions over the mesh, the exact global-norm clip and AdamW.  The
arithmetic is the JAX trainer's term for term: RoPE and RMSNorm in f32,
SiLU in f32 cast back, the logits in f32 from the hidden state and head in
their storage type, f32 moments and an f32 update cast to the parameter
type.  With no mesh it is the single-card step (dp = pp = tp = cp = 1).

The parallel layout is the reference's:

- tp: Megatron column/row-parallel products; the activations stay
  sequence-sharded over tp between blocks (``all_gather`` into each
  tensor-parallel region after a norm, ``psum_scatter`` out of it after
  ``wo`` and ``w_down``); vocab-parallel embedding and cross entropy.
- cp: each cp rank holds a contiguous slice of the sequence; attention is
  ring attention over the cp group.
- pp: the stacked layers are cut into contiguous stages; GPipe, 1F1B (the
  backward recomputed from a ring of saved stage inputs) or the
  interleaved virtual pipeline (vpp chunks a stage).  The JAX schedules
  run every tick on every stage and mask the bubble, as SPMD requires;
  here a stage runs only its real ticks, and activations and their
  cotangents travel by point-to-point calls over the pp group, one batch
  a tick (NCCL matches a pair's calls by the order they were posted).
- dp: gradients pmean'd over dp, or reduce-scattered under ZeRO
  (``zero_stage >= 1``: Adam moments sharded over dp, each rank updates
  its shard and the shards are all-gathered).  MoE experts may be sharded
  over dp (``ep == dp``), tokens exchanged by ``all_to_all``.

The collectives are ``torch.autograd.Function``s whose backward is a
transpose (``collectives.py``).  A sum after which every rank of the
group holds the same loss (the cross entropy's over tp, the loss's over
cp) passes its cotangent through, and every schedule seeds the loss 1 /
M, so the gradients, the returned norm and the parameters are the
single-device step's in every layout and schedule.  The reference
transposes those sums to ``psum`` (``check_vma=False``) and seeds GPipe
and the interleaved schedule pp / M: its gradients are tp x cp (x pp)
times these before the clip.

Parameters are a dict in the JAX pytree layout: ``embed`` ``[V, H]``,
``norm_f`` ``[H]``, ``head`` ``[H, V]`` and ``layers.{ln1, wq, wk, wv, wo,
ln2, w_gate, w_up, w_down}`` (or ``moe_gate``, ``moe_w_in``,
``moe_w_out``) stacked on a leading layer axis, projections stored ``[in,
out]``.  ``from_jax_params`` / ``from_jax_opt_state`` carry the JAX
trainer's trees over (as numpy), ``to_numpy`` carries them back;
``shard_params`` / ``shard_opt_state`` cut a full tree into this rank's
shards.

A multi-GPU run, one process a card (``python -m
paddle_tpu_torch.distributed.launch --nproc_per_node N``, or ``torchrun
--nproc-per-node N``):

    init_parallel_env()               # under the port's launcher
    hp = HybridParallelConfig(dp=2, tp=2, ...)
    mesh = build_mesh(hp)             # the default group's rank and
                                      # store, or torchrun's env; NCCL
    params = shard_params(full_params, hp, mesh)
    opt = init_opt_state(params, hp, mesh)
    step = build_train_step(cfg, hp, mesh)
    params, opt, loss = step(params, opt, my_dp_shard_of_tokens)
"""
from __future__ import annotations

import datetime
import math
import os
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..models.llama import LlamaConfig, resolve_device
from ..ops import flash_attention as fa
from .collectives import (
    _all_gather as _raw_all_gather, _psum, _psum_scatter as _raw_psum_scatter,
    _P2PBatch, all_gather, allreduce_, pmax, psum_replicated, psum_scatter,
    recv, send, wait_all)
from .moe import moe_ffn
from .ring_attention import ring_attention

__all__ = ["HybridParallelConfig", "Mesh", "build_mesh", "build_hybrid_mesh",
           "init_params", "init_opt_state", "param_specs", "zero_dims",
           "opt_state_specs", "shard_params", "shard_opt_state",
           "vpp_layer_perm", "pipeline_schedule_stats", "build_train_step",
           "loss_and_grads", "from_jax_params", "from_jax_opt_state",
           "to_numpy", "param_count"]

LAYER_KEYS = ("ln1", "wq", "wk", "wv", "wo", "ln2", "w_gate", "w_up",
              "w_down")
MOE_LAYER_KEYS = ("ln1", "wq", "wk", "wv", "wo", "ln2", "moe_gate",
                  "moe_w_in", "moe_w_out")
AXES = ("pp", "dp", "cp", "tp")


@dataclass(frozen=True)
class HybridParallelConfig:
    """The JAX trainer's configuration, every field kept."""
    dp: int = 1
    pp: int = 1
    tp: int = 1
    cp: int = 1                       # context parallel (ring attention)
    num_microbatches: int = 1
    pp_schedule: str = "1f1b"         # "1f1b", "gpipe" or "vpp" (at pp = 1
                                      # "1f1b" runs the GPipe path, as in
                                      # the reference)
    vpp: int = 1                      # virtual chunks a stage (with "vpp")
    remat: bool = True                # recompute each block in backward
    remat_policy: str = "full"        # "attn": save the attention output
                                      # (the flash forward runs once)
    ep: int = 1                       # expert parallel: 1, or dp
    xent_chunk: int = 0               # >0: sequence-chunked cross entropy
    zero_stage: int = 0               # >=1: Adam moments sharded over dp
    dtype: Any = torch.float32        # parameter/activation dtype
    lr: float = 1e-3
    betas: tuple = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip_norm: float = 1.0

    @property
    def world(self):
        return self.dp * self.pp * self.tp * self.cp


# ---------------------------------------------------------------------------
# the mesh: this rank's coordinates and one process group per axis
# ---------------------------------------------------------------------------

class Mesh:
    """This rank's place on the ("pp", "dp", "cp", "tp") mesh: ``ranks``
    (the global rank at each mesh position), its coordinates, one process
    group for each axis (the ranks that differ from this one on that axis
    only; a group of size 1 where the axis has size 1) and its device."""

    def __init__(self, ranks, rank, groups, device, backend):
        self.ranks = ranks
        self.rank = rank
        pos = np.argwhere(ranks == rank)[0]
        self.coords = dict(zip(AXES, (int(i) for i in pos)))
        self.shape = dict(zip(AXES, ranks.shape))
        self.groups = groups
        self.device = device
        self.backend = backend

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def group(self, axis: str):
        return self.groups[axis]

    def close(self) -> None:
        """Shut the process groups down (NCCL asks for it before exit)."""
        for g in self.groups.values():
            if hasattr(g, "shutdown"):
                g.shutdown()


def _timeout(timeout):
    if timeout is None:
        return datetime.timedelta(minutes=30)
    if isinstance(timeout, datetime.timedelta):
        return timeout
    return datetime.timedelta(seconds=float(timeout))


def _new_group(store, rank, size, backend, timeout):
    if backend == "gloo":
        return dist.ProcessGroupGloo(store, rank, size, timeout)
    if backend == "nccl":
        if not hasattr(dist, "ProcessGroupNCCL"):
            raise RuntimeError("this PyTorch build has no NCCL backend")
        opts = dist.ProcessGroupNCCL.Options()
        opts._timeout = timeout
        return dist.ProcessGroupNCCL(store, rank, size, opts)
    raise ValueError(f"backend must be 'gloo' or 'nccl', got {backend!r}")


def _env_store(rank, world_size, timeout):
    """torchrun's store: the agent's when it offers one, else rank 0
    hosts a TCPStore at MASTER_ADDR:MASTER_PORT."""
    agent = os.environ.get("TORCHELASTIC_USE_AGENT_STORE") == "True"
    return dist.TCPStore(os.environ["MASTER_ADDR"],
                         int(os.environ["MASTER_PORT"]), world_size,
                         is_master=(rank == 0 and not agent),
                         timeout=timeout)


def _mesh_from_layout(ranks, *, rank, world_size, store, backend, device,
                      timeout):
    # a default process group (init_parallel_env under the port's
    # launcher, or the caller's init_process_group) gives the rank, the
    # world, the store and the backend; else torchrun's environment
    up = dist.is_initialized()
    if rank is None:
        rank = dist.get_rank() if up else int(os.environ["RANK"])
    if world_size is None:
        world_size = dist.get_world_size() if up else \
            int(os.environ["WORLD_SIZE"])
    if world_size != ranks.size:
        raise RuntimeError(f"need {ranks.size} ranks, have {world_size}")
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} outside world {world_size}")
    if up and store is None:
        store = dist.distributed_c10d._get_default_store()
    if up and backend is None:
        backend = dist.get_backend()
    if device is None and up:
        device = "cpu" if backend == "gloo" else \
            torch.device("cuda", torch.cuda.current_device())
    if device is None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(device)
    timeout = _timeout(timeout)
    if store is None:
        store = dist.HashStore() if world_size == 1 else \
            _env_store(rank, world_size, timeout)
    # each rank counts its own meshes, so the n-th mesh of every rank
    # meets under one prefix however many meshes a store has seen
    n = store.add(f"paddle_tpu_torch/mesh_count/{rank}", 1)
    pos = tuple(int(i) for i in np.argwhere(ranks == rank)[0])
    groups = {}
    for a, axis in enumerate(AXES):
        idx = list(pos)
        idx[a] = slice(None)
        line = [int(r) for r in ranks[tuple(idx)]]
        prefix = f"paddle_tpu_torch/mesh{n}/{axis}/" + \
            "-".join(map(str, line))
        groups[axis] = _new_group(dist.PrefixStore(prefix, store),
                                  line.index(rank), len(line), backend,
                                  timeout)
    return Mesh(ranks, rank, groups, device, backend)


def build_mesh(hp: HybridParallelConfig, *, rank=None, world_size=None,
               store=None, backend=None, device=None, timeout=None) -> Mesh:
    """This rank's ``Mesh``: rank r sits at position r of
    ``arange(world).reshape(pp, dp, cp, tp)`` (the reference's axis
    order, so tp rides the innermost, fastest links).

    With no arguments, in a rank where a default process group exists
    (``paddle_tpu_torch.distributed.init_parallel_env()`` under the port's
    launcher, at any world size), it takes that group's rank, world,
    store and backend, and the current CUDA device (the CPU under gloo).
    Otherwise it reads torchrun's ``RANK``, ``WORLD_SIZE`` and
    ``LOCAL_RANK``, meets the other ranks through torchrun's store, takes
    ``cuda:LOCAL_RANK`` and NCCL.  The groups are ``ProcessGroup``
    objects over ``PrefixStore``s of ``store`` (a ``HashStore`` for a
    world of 1), and no default group is made, so ranks may be threads of
    one process (the CPU tests: ``backend="gloo"``, ``device="cpu"``, one
    ``HashStore`` shared by the threads).  ``timeout`` (seconds or a
    timedelta; 30 minutes by default) bounds every collective."""
    ranks = np.arange(hp.world).reshape(hp.pp, hp.dp, hp.cp, hp.tp)
    return _mesh_from_layout(ranks, rank=rank, world_size=world_size,
                             store=store, backend=backend, device=device,
                             timeout=timeout)


def _hybrid_layout(hp, num_slices, dcn_axis):
    """The reference's multi-slice placement with ranks for devices:
    slice i holds ranks [i * world / num_slices, (i + 1) * world /
    num_slices), and only ``dcn_axis`` crosses slices."""
    if dcn_axis not in ("dp", "pp"):
        raise ValueError(f"dcn_axis must be 'dp' or 'pp' (low-frequency "
                         f"axes); got {dcn_axis!r}")
    flat = np.arange(hp.world)
    if num_slices <= 1:
        return flat.reshape(hp.pp, hp.dp, hp.cp, hp.tp)
    dcn_degree = getattr(hp, dcn_axis)
    if dcn_degree % num_slices != 0:
        raise ValueError(
            f"{dcn_axis} degree {dcn_degree} must be a multiple of "
            f"num_slices {num_slices} so only {dcn_axis} crosses DCN")
    per_slice = hp.world // num_slices
    groups = [flat[i * per_slice:(i + 1) * per_slice]
              for i in range(num_slices)]
    if any(len(g) != per_slice for g in groups) \
            or per_slice * num_slices != hp.world:
        raise ValueError(f"uneven slices: {[len(g) for g in groups]}")
    shard = {ax: getattr(hp, ax) for ax in AXES}
    shard[dcn_axis] //= num_slices
    stacked = np.stack([g.reshape(shard["pp"], shard["dp"], shard["cp"],
                                  shard["tp"]) for g in groups])
    pos = AXES.index(dcn_axis)
    stacked = np.moveaxis(stacked, 0, pos)
    new_shape = [shard[ax] for ax in AXES]
    new_shape[pos] *= num_slices
    return stacked.reshape(new_shape)


def build_hybrid_mesh(hp: HybridParallelConfig, num_slices=None,
                      dcn_axis="dp", *, rank=None, world_size=None,
                      store=None, backend=None, device=None,
                      timeout=None) -> Mesh:
    """Mesh for multi-node layouts: ``dcn_axis`` (dp or pp, one
    gradient- or boundary-sized transfer a step) is the only axis whose
    groups cross nodes; tp and cp, which talk every layer, stay inside
    one.  ``num_slices`` nodes hold contiguous blocks of ranks (torchrun
    numbers ranks node by node); by default it is WORLD_SIZE /
    LOCAL_WORLD_SIZE.  The reference reads the slice of each TPU device;
    its ``ValueError``s are kept.  The other arguments are
    ``build_mesh``'s."""
    if num_slices is None:
        ws = world_size if world_size is not None else \
            int(os.environ.get("WORLD_SIZE", hp.world))
        num_slices = ws // int(os.environ.get("LOCAL_WORLD_SIZE", ws))
    ranks = _hybrid_layout(hp, num_slices, dcn_axis)
    return _mesh_from_layout(ranks, rank=rank, world_size=world_size,
                             store=store, backend=backend, device=device,
                             timeout=timeout)


# ---------------------------------------------------------------------------
# parameters, specs and optimizer state
# ---------------------------------------------------------------------------

def _shapes(cfg: LlamaConfig) -> dict:
    H, Fd, V, L = (cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size,
                   cfg.num_hidden_layers)
    Hkv = cfg.num_key_value_heads * (H // cfg.num_attention_heads)
    if cfg.moe_experts:
        E = cfg.moe_experts
        ffn = {"moe_gate": (L, H, E), "moe_w_in": (L, E, H, Fd),
               "moe_w_out": (L, E, Fd, H)}
    else:
        ffn = {"w_gate": (L, H, Fd), "w_up": (L, H, Fd),
               "w_down": (L, Fd, H)}
    return {"embed": (V, H), "norm_f": (H,), "head": (H, V),
            "layers": {"ln1": (L, H), "wq": (L, H, H), "wk": (L, H, Hkv),
                       "wv": (L, H, Hkv), "wo": (L, H, H), "ln2": (L, H),
                       **ffn}}


def param_count(cfg: LlamaConfig) -> int:
    """Number of parameters of ``init_params(cfg, ...)``."""
    return int(sum(math.prod(s) for _, s in _leaves(_shapes(cfg))))


def init_params(cfg: LlamaConfig, hp: HybridParallelConfig, seed=0, *,
                device=None) -> dict:
    """Random full (unsharded) parameters in ``hp.dtype``: N(0, 0.02)
    embeddings and projections (``wo`` and ``w_down`` / ``moe_w_out``
    scaled by 1 / sqrt(2 L)), unit norm scales, the MoE gate in f32, drawn
    in f32 from ``seed`` (a ``torch.Generator`` on the device, or an int
    seeding one).  They are not the JAX package's draws: the parity tests
    carry those over with ``from_jax_params``."""
    dev = resolve_device(device)
    gen = seed if isinstance(seed, torch.Generator) else \
        torch.Generator(device=dev).manual_seed(int(seed))
    sh = _shapes(cfg)
    L = cfg.num_hidden_layers
    s = 0.02

    def draw(shape, scale):
        w = torch.empty(shape, device=dev, dtype=torch.float32)
        return w.normal_(0.0, scale, generator=gen)

    def normal(shape, scale):
        return draw(shape, scale).to(hp.dtype)

    def ones(shape):
        return torch.ones(shape, device=dev, dtype=hp.dtype)

    lay = sh["layers"]
    out = {
        "embed": normal(sh["embed"], s), "norm_f": ones(sh["norm_f"]),
        "head": normal(sh["head"], s),
        "layers": {
            "ln1": ones(lay["ln1"]), "wq": normal(lay["wq"], s),
            "wk": normal(lay["wk"], s), "wv": normal(lay["wv"], s),
            "wo": normal(lay["wo"], s / math.sqrt(2 * L)),
            "ln2": ones(lay["ln2"])}}
    if cfg.moe_experts:
        out["layers"].update(
            moe_gate=draw(lay["moe_gate"], s),
            moe_w_in=normal(lay["moe_w_in"], s),
            moe_w_out=normal(lay["moe_w_out"], s / math.sqrt(2 * L)))
    else:
        out["layers"].update(
            w_gate=normal(lay["w_gate"], s), w_up=normal(lay["w_up"], s),
            w_down=normal(lay["w_down"], s / math.sqrt(2 * L)))
    return out


def _is_moe_tree(tree) -> bool:
    layers = tree.get("layers", {}) if isinstance(tree, dict) else {}
    return "moe_w_in" in layers


def _layer_keys(tree) -> tuple:
    return MOE_LAYER_KEYS if _is_moe_tree(tree) else LAYER_KEYS


def _leaves(tree: dict) -> list:
    """(name, leaf) for every leaf, in a fixed order."""
    out = [(k, tree[k]) for k in ("embed", "norm_f", "head")]
    return out + [(f"layers.{k}", tree["layers"][k])
                  for k in _layer_keys(tree)]


def _tree(pairs) -> dict:
    d = dict(pairs)
    keys = MOE_LAYER_KEYS if "layers.moe_w_in" in d else LAYER_KEYS
    return {"embed": d["embed"], "norm_f": d["norm_f"], "head": d["head"],
            "layers": {k: d[f"layers.{k}"] for k in keys}}


def param_specs(hp: HybridParallelConfig, moe: bool = False) -> dict:
    """The placement of each parameter over the mesh, the counterpart of
    the reference's PartitionSpecs: a tuple with an axis name (or None)
    for each leading dim; layers are stacked on a pp-sharded L axis, tp
    shards the Megatron way (qkv / gate / up by output, o / down by
    input, embed and head by vocabulary), EP experts ride dp."""
    ep_ax = "dp" if hp.ep > 1 else None
    ffn = ({"moe_gate": ("pp", None, None),
            "moe_w_in": ("pp", ep_ax, None, "tp"),
            "moe_w_out": ("pp", ep_ax, "tp", None)} if moe else
           {"w_gate": ("pp", None, "tp"), "w_up": ("pp", None, "tp"),
            "w_down": ("pp", "tp", None)})
    return {"embed": ("tp", None), "norm_f": (), "head": (None, "tp"),
            "layers": {"ln1": ("pp", None), "wq": ("pp", None, "tp"),
                       "wk": ("pp", None, "tp"), "wv": ("pp", None, "tp"),
                       "wo": ("pp", "tp", None), "ln2": ("pp", None),
                       **ffn}}


def _shape(x) -> tuple:
    return tuple(x) if isinstance(x, (tuple, list)) else tuple(x.shape)


def _zero_dim(shape, spec, dp):
    """First dim not already mesh-sharded whose size divides by dp: the
    dim ZeRO shards optimizer state / scatters grads along (-1: none).
    Params already sharded over dp (EP expert weights) stay as they
    are."""
    if "dp" in tuple(spec):
        return -1
    for d in range(len(shape)):
        ax = spec[d] if d < len(spec) else None
        if ax is None and shape[d] % dp == 0:
            return d
    return -1


def zero_dims(hp, shapes) -> dict:
    """Tree of ZeRO shard dims (-1 = keep replicated) for a tree of full
    shapes (tuples, or anything with ``.shape``)."""
    moe = _is_moe_tree(shapes)
    specs = dict(_leaves(param_specs(hp, moe)))
    on = hp.zero_stage >= 1 and hp.dp > 1
    return _tree((n, _zero_dim(_shape(s), specs[n], hp.dp) if on else -1)
                 for n, s in _leaves(shapes))


def opt_state_specs(hp, shapes=None) -> dict:
    """Placement of m / v; with zero_stage >= 1 (and shapes given) the
    moments are also sharded over dp on their ZeRO dim."""
    moe = _is_moe_tree(shapes) if shapes is not None else False
    ps = param_specs(hp, moe)
    if hp.zero_stage >= 1 and hp.dp > 1 and shapes is not None:
        zd = dict(_leaves(zero_dims(hp, shapes)))
        specs = dict(_leaves(ps))

        def mv_spec(n, s):
            spec = specs[n]
            if zd[n] < 0:
                return spec
            parts = list(spec) + [None] * (len(_shape(s)) - len(spec))
            parts[zd[n]] = "dp"
            return tuple(parts)

        mv = _tree((n, mv_spec(n, s)) for n, s in _leaves(shapes))
        return {"m": mv, "v": mv, "step": ()}
    return {"m": ps, "v": ps, "step": ()}


def vpp_layer_perm(L, pp, v):
    """Permutation from logical layer order to the interleaved placement:
    physical stage s holds virtual chunks {c*pp + s | c < v} concatenated,
    so the contiguous pp-sharding of the stacked [L, ...] layer params
    puts each stage's v chunks in its shard."""
    Lc = L // (pp * v)
    Lloc = L // pp
    perm = np.zeros(L, np.int32)
    for s in range(pp):
        for c in range(v):
            for j in range(Lc):
                perm[s * Lloc + c * Lc + j] = (c * pp + s) * Lc + j
    return perm


def pipeline_schedule_stats(hp, M=None):
    """Static fill/drain accounting per stage (forward pass); relative
    time in full-stage-load units (one GPipe tick == 1): the interleaved
    schedule's bubble is (pp-1)/vpp instead of (pp-1)."""
    M = M if M is not None else hp.num_microbatches
    if hp.pp_schedule == "vpp" and hp.vpp > 1:
        ticks = hp.vpp * M + hp.pp - 1
        bubble = (hp.pp - 1) / ticks
        rel_time = ticks / hp.vpp
    else:
        ticks = M + hp.pp - 1
        bubble = (hp.pp - 1) / ticks
        rel_time = float(ticks)
    return {"ticks": ticks, "bubble_fraction": bubble,
            "relative_time": rel_time}


def _from_numpy(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":   # ml_dtypes' bfloat16: same 16 bits
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _local(t, spec, mesh, extra=None):
    """This rank's block of a full tensor: each dim cut by the mesh axis
    its spec names (extra: {dim: axis} added cuts)."""
    cuts = dict(enumerate(spec))
    cuts.update(extra or {})
    for d, ax in cuts.items():
        if ax is None:
            continue
        n = mesh.size(ax)
        if t.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(t.shape)} does not divide "
                             f"by {ax}={n}")
        k = t.shape[d] // n
        t = t.narrow(d, mesh.index(ax) * k, k)
    # always a copy: the step updates its shards in place
    return t.clone(memory_format=torch.contiguous_format)


def _vpp_permuted(tree, hp):
    if not (hp.pp_schedule == "vpp" and hp.vpp > 1):
        return tree
    L = _shape(next(iter(tree["layers"].values())))[0]
    perm = torch.from_numpy(vpp_layer_perm(L, hp.pp, hp.vpp).astype(np.int64))
    out = dict(tree)
    out["layers"] = {k: v[perm] if isinstance(v, torch.Tensor)
                     else np.asarray(v)[perm.numpy()]
                     for k, v in tree["layers"].items()}
    return out


def shard_params(params, hp, mesh) -> dict:
    """This rank's shards of a full parameter tree (torch tensors or numpy
    arrays, bf16 as ml_dtypes' bfloat16) on ``mesh.device``, dtypes kept.
    Under the interleaved schedule the stacked layers are first permuted
    (``vpp_layer_perm``) so each stage's shard holds its vpp chunks."""
    params = _vpp_permuted(params, hp)
    specs = dict(_leaves(param_specs(hp, _is_moe_tree(params))))
    return _tree((n, _local(_from_numpy(a, mesh.device), specs[n], mesh))
                 for n, a in _leaves(params))


def shard_opt_state(opt_state, hp, mesh) -> dict:
    """This rank's shards of a full optimizer state ({"m", "v", "step"}):
    the parameters' placement, plus dp on each leaf's ZeRO dim under
    zero_stage >= 1.  Permuted like the parameters under vpp."""
    specs = opt_state_specs(hp, opt_state["m"])
    out = {}
    for key in ("m", "v"):
        tree = _vpp_permuted(opt_state[key], hp)
        sp = dict(_leaves(specs[key]))
        out[key] = _tree((n, _local(_from_numpy(a, mesh.device), sp[n],
                                    mesh))
                         for n, a in _leaves(tree))
    out["step"] = _from_numpy(opt_state["step"], mesh.device).to(torch.int32)
    return out


def init_opt_state(params: dict, hp=None, mesh=None) -> dict:
    """Zero f32 Adam moments and step 0 (int32), shaped like ``params``;
    given this rank's shards with ``hp`` and ``mesh``, each moment is cut
    to its dp shard on its ZeRO dim under zero_stage >= 1."""
    zd = {}
    if mesh is not None and hp is not None:
        # a ZeRO dim is never mesh-sharded, so a shard's size there is
        # the full size and the local shapes give the same dims
        zd = dict(_leaves(zero_dims(hp, params)))

    def f32(n, t):
        shape = list(t.shape)
        if zd.get(n, -1) >= 0:
            shape[zd[n]] //= hp.dp
        return torch.zeros(shape, dtype=torch.float32, device=t.device)

    dev = params["embed"].device
    return {"m": _tree((n, f32(n, t)) for n, t in _leaves(params)),
            "v": _tree((n, f32(n, t)) for n, t in _leaves(params)),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def from_jax_params(params_np: dict, *, device=None) -> dict:
    """The JAX trainer's parameter tree (leaves as numpy arrays, bf16 as
    ml_dtypes' bfloat16) as the port's dict on ``device``, dtypes kept."""
    dev = resolve_device(device)
    return _tree((n, _from_numpy(a, dev)) for n, a in _leaves(params_np))


def from_jax_opt_state(opt_np: dict, *, device=None) -> dict:
    """The JAX trainer's optimizer state ({"m", "v", "step"}, numpy
    leaves) as the port's."""
    dev = resolve_device(device)
    return {"m": from_jax_params(opt_np["m"], device=dev),
            "v": from_jax_params(opt_np["v"], device=dev),
            "step": _from_numpy(opt_np["step"], dev).to(torch.int32)}


def to_numpy(tree):
    """A tree of tensors (params, opt state or grads) as numpy arrays,
    copies that later in-place steps leave alone; bf16 leaves come back
    as f32."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    t = tree.detach().to("cpu", copy=True)
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


# ---------------------------------------------------------------------------
# the per-rank model (all shapes local; no mesh = one card)
# ---------------------------------------------------------------------------

def _group(mesh, axis):
    return None if mesh is None else mesh.group(axis)


def _gather_seq(x, group):
    """Into a tensor-parallel region: all_gather over tp along the
    sequence (the identity with no mesh)."""
    return x if group is None else all_gather(x, group, 1)


def _scatter_seq(x, group):
    """Out of a tensor-parallel region: psum_scatter over tp along the
    sequence (the identity with no mesh)."""
    return x if group is None else psum_scatter(x, group, 1)


def _psum_or_id(x, group):
    return x if group is None else psum_replicated(x, group)


def _rope(x, theta, pos0=0):
    """Interleaved rotary embedding (pairs 2i, 2i+1) of x [m, S, h, d] in
    f32, cast back to x.dtype; pos0 is the global position of the first
    local token (nonzero under context parallelism)."""
    m_, s, h, d = x.shape
    pos = pos0 + torch.arange(s, dtype=torch.float32, device=x.device)
    inv = theta ** (-torch.arange(0, d, 2, dtype=torch.float32,
                                  device=x.device) / d)
    freqs = torch.outer(pos, inv)
    cos = torch.cos(freqs)[None, :, None, :]
    sin = torch.sin(freqs)[None, :, None, :]
    xf = x.float()
    x1, x2 = xf[..., 0::2], xf[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.reshape(m_, s, h, d).to(x.dtype)


def _rms(x, w, eps=1e-6):
    xf = x.float()
    out = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (out * w.float()).to(x.dtype)


def _attention(q, k, v):
    """Causal GQA attention through the flash attention kernels (the plain
    versions on CPU tensors)."""
    return fa.attention(q, k, v, causal=True)


def _make_block(cfg: LlamaConfig, hp: HybridParallelConfig, mesh=None):
    """The decoder block as three pieces, ``qkv(x, p) -> (q, k, v)``,
    ``attend(q, k, v)`` and ``finish(x, att, p) -> (x, aux)`` (aux None
    without MoE), so that ``remat_policy="attn"`` can checkpoint the two
    around the attention.  x: [m, S_cp/tp, H], sequence-sharded over tp,
    of this cp rank's contiguous slice of the sequence."""
    nh = cfg.num_attention_heads // hp.tp
    nkv = cfg.num_key_value_heads // hp.tp
    hd = cfg.hidden_size // cfg.num_attention_heads
    eps = cfg.rms_norm_eps
    tp_g = _group(mesh, "tp")
    cp_g = _group(mesh, "cp") if hp.cp > 1 else None
    ep_g = _group(mesh, "dp") if hp.ep > 1 else None
    cp_idx = 0 if mesh is None else mesh.index("cp")

    def qkv(x, p):
        pos0 = cp_idx * (x.shape[1] * hp.tp)       # S_cp a cp rank
        h = _gather_seq(_rms(x, p["ln1"], eps), tp_g)   # [m, S_cp, H]
        m_, s = h.shape[:2]
        q = (h @ p["wq"]).reshape(m_, s, nh, hd)
        k = (h @ p["wk"]).reshape(m_, s, nkv, hd)
        v = (h @ p["wv"]).reshape(m_, s, nkv, hd)
        return _rope(q, cfg.rope_theta, pos0), _rope(k, cfg.rope_theta,
                                                     pos0), v

    def attend(q, k, v):
        if cp_g is None:
            return _attention(q, k, v)      # GQA-aware kernels
        if nkv < nh:                        # the ring wants equal heads
            k, v = fa._repeat_kv(k, nh // nkv), fa._repeat_kv(v, nh // nkv)
        return ring_attention(q, k, v, cp_g, causal=True)

    def finish(x, att, p):
        m_, s = att.shape[:2]
        att = att.reshape(m_, s, nh * hd)
        x = x + _scatter_seq(att @ p["wo"], tp_g)   # partial over tp
        h2 = _gather_seq(_rms(x, p["ln2"], eps), tp_g)
        if cfg.moe_experts:
            H = h2.shape[-1]
            y, aux = moe_ffn(
                h2.reshape(m_ * s, H),
                {"gate": p["moe_gate"], "w_in": p["moe_w_in"],
                 "w_out": p["moe_w_out"]},
                ep_group=ep_g, top_k=cfg.moe_top_k,
                capacity_factor=cfg.moe_capacity_factor)
            d_partial = y.reshape(m_, s, H)  # partial over tp (F sharded)
        else:
            g = h2 @ p["w_gate"]
            u = h2 @ p["w_up"]
            a = F.silu(g.float()).to(g.dtype) * u
            d_partial = a @ p["w_down"]
            aux = None
        return x + _scatter_seq(d_partial, tp_g), aux

    return qkv, attend, finish


def _apply_block(pieces, x, p, hp, remat):
    qkv, attend, finish = pieces
    if not remat:
        return finish(x, attend(*qkv(x, p)), p)
    if hp.remat_policy == "attn":
        # the attention output is kept: only the pieces around it are
        # recomputed in backward, so the flash forward runs once
        q, k, v = checkpoint(qkv, x, p, use_reentrant=False)
        return checkpoint(finish, x, attend(q, k, v), p, use_reentrant=False)

    def block(x, p):
        return finish(x, attend(*qkv(x, p)), p)
    return checkpoint(block, x, p, use_reentrant=False)


def _vocab_parallel_embed(tokens, embed, mesh=None):
    """tokens [m, S] -> [m, S/tp, H] sequence-sharded activations; embed
    is this rank's vocabulary shard [V/tp, H] (a plain lookup with no
    mesh)."""
    if mesh is None:
        return F.embedding(tokens, embed)
    v_local = embed.shape[0]
    local_ids = tokens - mesh.index("tp") * v_local
    in_range = (local_ids >= 0) & (local_ids < v_local)
    out = F.embedding(torch.clamp(local_ids, 0, v_local - 1), embed)
    out = torch.where(in_range[..., None], out, torch.zeros_like(out))
    # complete the lookup over tp and enter the sequence-parallel region
    return psum_scatter(out, mesh.group("tp"), 1)


def _mm_f32(a, b):
    """a @ b with an f32 result from operands in their storage type: f32
    operands multiply in f32; bf16 operands on CUDA use the bf16 product
    with f32 output (``torch.mm(..., out_dtype=torch.float32)``), and on
    the CPU are upcast (exact products, f32 sums)."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _F32Logits(torch.autograd.Function):
    """h [N, H] @ head [H, V] -> f32 logits (the JAX einsum with
    ``preferred_element_type=float32``).  The backward takes the f32
    cotangent in the operands' type (a bf16 cotangent for bf16 operands)
    with f32 products, each gradient cast to its operand's type."""

    @staticmethod
    def forward(ctx, h, head):
        ctx.save_for_backward(h, head)
        return _mm_f32(h, head)

    @staticmethod
    def backward(ctx, g):
        h, head = ctx.saved_tensors
        gc = g.to(h.dtype)
        return (_mm_f32(gc, head.t()).to(h.dtype),
                _mm_f32(h.t(), gc).to(head.dtype))


def _vocab_parallel_xent(h, head, labels, pos_weight=None,
                         reduction="mean", mesh=None):
    """Cross entropy of h [m, S, H] (the full sequence of this cp rank)
    through this rank's vocabulary shard of the head [H, V/tp] against
    labels [m, S], positions weighted by pos_weight [S]: the max over tp
    (no gradient), the denominator and the picked logit psum'd over tp.
    Returns the weighted mean, or (weighted sum, weight count) with
    reduction="sumcount"."""
    m_, s, H = h.shape
    tp_g = _group(mesh, "tp")
    logits = _F32Logits.apply(h.reshape(m_ * s, H), head).reshape(m_, s, -1)
    v_local = logits.shape[-1]
    gmax = logits.detach().amax(-1)
    if tp_g is not None:
        gmax = pmax(gmax, tp_g)
    z = torch.exp(logits - gmax[..., None])
    denom = _psum_or_id(z.sum(-1), tp_g)
    local_label = labels - (0 if mesh is None else mesh.index("tp") * v_local)
    in_range = (local_label >= 0) & (local_label < v_local)
    safe = torch.clamp(local_label, 0, v_local - 1)
    picked = torch.gather(logits, -1, safe[..., None].long())[..., 0]
    picked = torch.where(in_range, picked, torch.zeros_like(picked))
    per_pos = gmax + torch.log(denom) - _psum_or_id(picked, tp_g)
    if pos_weight is None:
        pos_weight = torch.ones((s,), dtype=torch.float32, device=h.device)
    w = pos_weight[None, :]
    wsum = (per_pos * w).sum()
    wcount = w.sum() * m_
    if reduction == "sumcount":
        return wsum, wcount
    return wsum / torch.clamp(wcount, min=1.0)


def _vocab_parallel_xent_chunked(h, head, labels, pos_weight, chunk,
                                 mesh=None):
    """Sequence-chunked cross entropy: each chunk's f32 logits are
    recomputed in backward (``torch.utils.checkpoint``), so at most
    [m, chunk, V/tp] f32 logits live at once.  Returns (sum, count)."""
    S = h.shape[1]
    if chunk <= 0 or S % chunk or S == chunk:
        return _vocab_parallel_xent(h, head, labels, pos_weight,
                                    reduction="sumcount", mesh=mesh)

    def one(hc, lc, wc):
        return _vocab_parallel_xent(hc, head, lc, wc, reduction="sumcount",
                                    mesh=mesh)

    ws = wc = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, S, chunk):
        a, b = checkpoint(one, h[:, i:i + chunk], labels[:, i:i + chunk],
                          pos_weight[i:i + chunk], use_reentrant=False)
        ws, wc = ws + a, wc + b
    return ws, wc


def _aux_consistent(aux, hp, mesh=None):
    """The MoE aux loss made consistent across tp / cp ranks in value and
    gradient: the value is the cp mean of the per-slice aux; the
    differentiable share is aux / cp on tp rank 0 only (gating runs on
    tp-replicated tokens, so a share on every tp rank would be counted tp
    times), the rest rides through detach."""
    gshare = aux / hp.cp
    if hp.tp > 1 and mesh.index("tp") != 0:
        gshare = torch.zeros_like(aux.detach())
    value = aux.detach()
    if hp.cp > 1:
        value = allreduce_(value.clone(), mesh.group("cp")) / hp.cp
    return gshare + (value - gshare).detach()


def _stage_apply(params, tok_mb, act_in, cfg, hp, mesh=None, *, first=True,
                 last=True, layers=None):
    """One pipeline stage (or, with ``layers``, one interleaved chunk) on
    one microbatch tok_mb [m, S].  The first stage embeds this cp rank's
    slice of the tokens, the others take act_in [m, S_cp/tp, H]; then the
    layers, each block checkpointed under ``hp.remat`` (when a graph is
    being recorded); the last stage adds the final norm and the
    next-token loss with the sequence's last position masked.  Returns
    (out, mb_loss or None, aux or None)."""
    pieces = _make_block(cfg, hp, mesh)
    remat = hp.remat and torch.is_grad_enabled()
    S = tok_mb.shape[1]
    S_cp = S // hp.cp
    cp_start = 0 if mesh is None else mesh.index("cp") * S_cp
    if first:
        x = _vocab_parallel_embed(tok_mb[:, cp_start:cp_start + S_cp],
                                  params["embed"], mesh)
    else:
        x = act_in
    layers = params["layers"] if layers is None else layers
    keys = list(layers)
    moe = bool(cfg.moe_experts)
    aux_total = torch.zeros((), dtype=torch.float32, device=tok_mb.device) \
        if moe else None
    for vals in zip(*(layers[k].unbind(0) for k in keys)):
        x, aux = _apply_block(pieces, x, dict(zip(keys, vals)), hp, remat)
        if moe:
            aux_total = aux_total + aux
    if moe:
        aux_total = _aux_consistent(aux_total, hp, mesh)
    if not last:
        return x, None, aux_total
    hN = _gather_seq(_rms(x, params["norm_f"], cfg.rms_norm_eps),
                     _group(mesh, "tp"))
    labels = torch.cat([tok_mb, tok_mb[:, :1]], dim=1)[
        :, cp_start + 1:cp_start + 1 + S_cp]
    pos_w = ((cp_start + torch.arange(S_cp, device=tok_mb.device))
             < S - 1).float()
    ws, wc = _vocab_parallel_xent_chunked(hN, params["head"], labels, pos_w,
                                          hp.xent_chunk, mesh)
    if hp.cp > 1:
        ws = psum_replicated(ws, mesh.group("cp"))
        wc = allreduce_(wc.detach().clone(), mesh.group("cp"))
    return x, ws / torch.clamp(wc, min=1.0), aux_total


def loss_and_grads(params, tokens, cfg, hp):
    """One card: the mean loss over ``hp.num_microbatches`` microbatches of
    tokens [M * m, S] (microbatch i is rows i*m .. (i+1)*m - 1; with MoE
    each adds ``moe_aux_weight`` times its aux loss) and its gradients (a
    tree like params, each in its parameter's dtype, summed over
    microbatches in that dtype)."""
    M = hp.num_microbatches
    if tokens.shape[0] % M:
        raise ValueError(f"batch {tokens.shape[0]} not divisible by "
                         f"num_microbatches={M}")
    leaves = _leaves(params)
    live = [t.detach().requires_grad_(True) for _, t in leaves]
    ptree = _tree((n, t) for (n, _), t in zip(leaves, live))
    grads, total = None, torch.zeros((), dtype=torch.float32,
                                     device=tokens.device)
    for mb in tokens.reshape(M, tokens.shape[0] // M, tokens.shape[1]):
        _, loss, aux = _stage_apply(ptree, mb, None, cfg, hp)
        if aux is not None:
            loss = loss + cfg.moe_aux_weight * aux
        g = torch.autograd.grad(loss / M, live, allow_unused=True)
        g = [torch.zeros_like(t) if gi is None else gi
             for t, gi in zip(live, g)]
        grads = g if grads is None else [a + b for a, b in zip(grads, g)]
        total = total + loss.detach()
    return total / M, _tree((n, g) for (n, _), g in zip(leaves, grads))


# ---------------------------------------------------------------------------
# the pipeline schedules (per rank; a stage runs only its real ticks)
# ---------------------------------------------------------------------------

class _Pipe:
    """Point-to-point traffic of one stage over the pp group.  A schedule
    runs on one clock of ticks, and every message goes from one tick to
    the next: what a stage sends at tick t its neighbour takes at tick
    t + 1, tagged 2t (an activation, forward) or 2t + 1 (a cotangent,
    backward).  After a tick's work the stage posts, as one batch, that
    tick's sends and the receives of the next tick (``exchange``).

    NCCL matches a pair's sends and receives by the order they were
    posted, not by tag, runs them in that order, and holds a send larger
    than its buffer until the peer receives it.  Posted one call at a
    time, two stages that both send before they receive wait on each
    other; in one batch a tick, both ends of a pair post the tick's
    messages together, in tag order.  gloo matches by tag, so the tags
    check the order there.  A message to this same stage (pp = 1 under
    vpp) is handed over directly."""

    def __init__(self, mesh, like):
        self.group = mesh.group("pp")
        self.stage = mesh.index("pp")
        self.like = like
        self.outbox, self.inbox, self.sent = [], {}, []

    def send(self, x, dst, tag):
        """Queue x for dst; it goes out at the next ``exchange``."""
        x = x.detach()
        if dst == self.stage:
            self.inbox[tag] = x
        else:
            self.outbox.append((tag, dst, x))

    def exchange(self, wants):
        """Post the queued sends and a receive for each (src, tag) of
        ``wants`` as one batch, and wait for it."""
        out = sorted(self.outbox, key=lambda m: m[0])
        wants = sorted((tag, src) for src, tag in wants if src != self.stage)
        self.outbox = []
        if not out and not wants:
            return
        with _P2PBatch(self.group, self.like) as batch:
            for tag, dst, x in out:
                batch.works.append(send(x, self.group, dst, tag))
            for tag, src in wants:
                self.inbox[tag], work = recv(self.like, self.group, src, tag)
                batch.works.append(work)
        wait_all(batch.works)
        self.sent += [x for _, _, x in out]   # alive until the step ends

    def take(self, tag):
        return self.inbox.pop(tag)

    def finish(self):
        if self.outbox or self.inbox:
            raise RuntimeError(f"stage {self.stage}: messages left over")
        self.sent = []


def _scalar(v, device):
    return torch.tensor(v, dtype=torch.float32, device=device)


def _backward(outs, seeds, live, a_in):
    """Gradients of sum(seed * out) for the outs that carry a graph, with
    respect to the parameters (None where unused) and a_in."""
    pairs = [(o, s) for o, s in zip(outs, seeds)
             if o is not None and o.requires_grad]
    inputs = live + ([a_in] if a_in is not None else [])
    gs = torch.autograd.grad([o for o, _ in pairs], inputs,
                             [s for _, s in pairs], allow_unused=True)
    return list(gs[:len(live)]), (gs[-1] if a_in is not None else None)


def _act_like(tokens, cfg, hp, mesh):
    m, S = tokens.shape[1], tokens.shape[2]
    return torch.empty((m, S // hp.cp // hp.tp, cfg.hidden_size),
                       dtype=hp.dtype, device=mesh.device)


def _grads_gpipe(ptree, live, tokens, cfg, hp, mesh):
    """GPipe: every microbatch forward, then every backward in reverse,
    gradients summed in their dtype in that order (the reference's scan
    transpose).  On a clock of 2T ticks, T = M + pp - 1, stage s runs
    F(t - s) at tick t and B(f) at tick T + (pp - 1 - s) + (M - 1 - f).
    Each stage seeds its loss and aux terms 1 / M, as 1F1B does."""
    M, pp = hp.num_microbatches, hp.pp
    s = mesh.index("pp")
    first, last = s == 0, s == pp - 1
    moe = bool(cfg.moe_experts)
    pipe = _Pipe(mesh, _act_like(tokens, cfg, hp, mesh))
    dev = mesh.device
    T = M + pp - 1

    def fwd(t):
        return t - s if 0 <= t - s < M else None

    def bwd(t):
        u = t - T - (pp - 1 - s)
        return M - 1 - u if 0 <= u < M else None

    def wants(t):
        return ([(s - 1, 2 * (t - 1))] if fwd(t) is not None and not first
                else []) + \
            ([(s + 1, 2 * (t - 1) + 1)] if bwd(t) is not None and not last
             else [])

    loss = torch.zeros((), dtype=torch.float32, device=dev)
    seed = _scalar(1.0 / M, dev)
    saved, grads = {}, [None] * len(live)
    for t in range(2 * T):
        f = fwd(t)
        if f is not None:
            a = None if first else pipe.take(2 * (t - 1)).requires_grad_(True)
            out, mb_loss, aux = _stage_apply(ptree, tokens[f], a, cfg, hp,
                                             mesh, first=first, last=last)
            if not last:
                pipe.send(out, s + 1, 2 * t)
            else:
                loss = loss + mb_loss.detach()
            if moe:
                loss = loss + cfg.moe_aux_weight * aux.detach()
            saved[f] = (a, out, mb_loss, aux)
        b = bwd(t)
        if b is not None:
            a, out, mb_loss, aux = saved.pop(b)
            g_out = None if last else pipe.take(2 * (t - 1) + 1)
            gp, ga = _backward([None if last else out, mb_loss, aux],
                               [g_out, seed, seed * cfg.moe_aux_weight],
                               live, a)
            grads = [acc if g is None else (g if acc is None else acc + g)
                     for acc, g in zip(grads, gp)]
            if not first:
                pipe.send(ga, s - 1, 2 * t + 1)
        pipe.exchange(wants(t + 1))
    pipe.finish()
    return loss, grads


def _grads_1f1b(ptree, live, tokens, cfg, hp, mesh):
    """1F1B: at tick t stage s runs F(f = t - s), then B(b = t - (2pp - 2
    - s)), the backward recomputed from the stage input saved by F(b) in
    a ring of min(M, 2pp - 2) slots; f32 gradient sums in microbatch
    order; cotangents seeded 1/M (loss, last stage) and aux_weight/M."""
    M, pp = hp.num_microbatches, hp.pp
    s = mesh.index("pp")
    first, last = s == 0, s == pp - 1
    moe = bool(cfg.moe_experts)
    like = _act_like(tokens, cfg, hp, mesh)
    pipe = _Pipe(mesh, like)
    dev = mesh.device
    nslots = max(1, min(M, 2 * pp - 2))
    slots = [None] * nslots
    grads = [torch.zeros(t.shape, dtype=torch.float32, device=dev)
             for t in live]
    loss = torch.zeros((), dtype=torch.float32, device=dev)
    g_loss = _scalar(1.0 / M, dev)
    g_aux = _scalar(cfg.moe_aux_weight / M, dev)

    def wants(t):
        f, b = t - s, t - (2 * pp - 2 - s)
        return ([(s - 1, 2 * (t - 1))] if 0 <= f < M and not first
                else []) + \
            ([(s + 1, 2 * (t - 1) + 1)] if 0 <= b < M and not last else [])

    for t in range(M + 2 * pp - 2):
        f, b = t - s, t - (2 * pp - 2 - s)
        if 0 <= f < M:
            act = None if first else pipe.take(2 * (t - 1))
            with torch.no_grad():
                out, mb_loss, aux = _stage_apply(ptree, tokens[f], act, cfg,
                                                 hp, mesh, first=first,
                                                 last=last)
            if last:
                loss = loss + mb_loss
            else:
                pipe.send(out, s + 1, 2 * t)
            if moe:
                loss = loss + cfg.moe_aux_weight * aux
            slots[f % nslots] = act
        if 0 <= b < M:
            a_in = None if first else \
                slots[b % nslots].detach().requires_grad_(True)
            gact = None if last else pipe.take(2 * (t - 1) + 1)
            o, ml, ax = _stage_apply(ptree, tokens[b], a_in, cfg, hp, mesh,
                                     first=first, last=last)
            gp, ga = _backward([None if last else o, ml, ax],
                               [gact, g_loss, g_aux], live, a_in)
            for acc, g in zip(grads, gp):
                if g is not None:
                    acc.add_(g.float())
            if not first:
                pipe.send(ga, s - 1, 2 * t + 1)
        pipe.exchange(wants(t + 1))
    pipe.finish()
    return loss, grads


def _grads_vpp(ptree, live, tokens, cfg, hp, mesh):
    """The interleaved schedule: vpp chunks a stage, one chunk
    application a tick; stream position i = t - s walks, for each round of
    pp microbatches, chunks 0..vpp-1 of microbatches r*pp .. r*pp+pp-1.
    Chunk c of stage pp-1 feeds chunk c+1 of stage 0 one tick later.
    Forward over the ticks t < Tf = vpp M + pp - 1, then backward in
    reverse (tick 2Tf - 1 - t undoes tick t), seeds 1 / M as under
    GPipe, gradients summed in their dtype."""
    M, pp, V = hp.num_microbatches, hp.pp, hp.vpp
    s = mesh.index("pp")
    moe = bool(cfg.moe_experts)
    pipe = _Pipe(mesh, _act_like(tokens, cfg, hp, mesh))
    dev = mesh.device
    Lc = cfg.num_hidden_layers // pp // V
    Tf = V * M + pp - 1
    prv, nxt = (s - 1) % pp, (s + 1) % pp

    def place(i, stage):
        """(chunk, microbatch, first, last) of stream position i."""
        rem = i % (V * pp)
        c = rem // pp
        return c, (i // (V * pp)) * pp + rem % pp, c == 0 and stage == 0, \
            c == V - 1 and stage == pp - 1

    def takes_input(stage, i):
        return 0 <= i < V * M and not place(i, stage)[2]

    def wants(t):
        if t < Tf:
            return [(prv, 2 * (t - 1))] if takes_input(s, t - s) else []
        tf = 2 * Tf - 1 - t
        return [(nxt, 2 * (t - 1) + 1)] \
            if 0 <= tf - s < V * M and takes_input(nxt, tf + 1 - nxt) else []

    loss = torch.zeros((), dtype=torch.float32, device=dev)
    seed = _scalar(1.0 / M, dev)
    saved, grads = {}, [None] * len(live)
    for t in range(2 * Tf):
        if t < Tf and 0 <= t - s < V * M:
            c, mb, first, last = place(t - s, s)
            a = None if first else pipe.take(2 * (t - 1)).requires_grad_(True)
            layers = {k: v[c * Lc:(c + 1) * Lc]
                      for k, v in ptree["layers"].items()}
            out, mb_loss, aux = _stage_apply(ptree, tokens[mb], a, cfg, hp,
                                             mesh, first=first, last=last,
                                             layers=layers)
            used = takes_input(nxt, t + 1 - nxt)
            if used:
                pipe.send(out, nxt, 2 * t)
            if last:
                loss = loss + mb_loss.detach()
            if moe:
                loss = loss + cfg.moe_aux_weight * aux.detach()
            saved[t] = (a, out if used else None, mb_loss, aux)
        elif 2 * Tf - 1 - t in saved:
            a, out, mb_loss, aux = saved.pop(2 * Tf - 1 - t)
            g_out = None if out is None else pipe.take(2 * (t - 1) + 1)
            gp, ga = _backward([out, mb_loss, aux],
                               [g_out, seed, seed * cfg.moe_aux_weight],
                               live, a)
            grads = [acc if g is None else (g if acc is None else acc + g)
                     for acc, g in zip(grads, gp)]
            if a is not None:
                pipe.send(ga, prv, 2 * t + 1)
        pipe.exchange(wants(t + 1))
    pipe.finish()
    return loss, grads


# ---------------------------------------------------------------------------
# gradient reductions and the optimizer
# ---------------------------------------------------------------------------

@torch.no_grad()
def _reduce_grads(grads, names, hp, mesh, zdims):
    """The cross-axis reductions the per-rank backward leaves pending:
    dp pmean (EP experts, already summed by the all_to_all transpose,
    only divided; ZeRO-sharded leaves reduce-scattered over dp); cp psum;
    pp psum of embed, head and norm_f (only some stages touch them); tp
    psum of the norms and the MoE gate (partial over the
    sequence-parallel region)."""
    specs = dict(_leaves(param_specs(hp, any("moe_w_in" in n
                                             for n in names))))
    dp_g = mesh.group("dp")
    out = []
    for n, g in zip(names, grads):
        g = g.contiguous()
        if "dp" in specs[n]:
            g = g / hp.dp
        elif zdims[n] >= 0:
            g = _raw_psum_scatter(g, dp_g, zdims[n]) / hp.dp
        else:
            g = _psum(g, dp_g) / hp.dp
        if hp.cp > 1:
            g = allreduce_(g, mesh.group("cp"))
        if n in ("embed", "head", "norm_f"):
            g = allreduce_(g, mesh.group("pp"))
        if n in ("norm_f", "layers.ln1", "layers.ln2", "layers.moe_gate"):
            g = allreduce_(g, mesh.group("tp"))
        out.append(g)
    return out


def _global_sumsq(grads, names, hp, mesh, zdims):
    """The exact global sum of squares: each leaf's local sum psum'd over
    exactly the axes it is sharded on (plus dp for a ZeRO grad shard);
    leaves on the same axes share one all-reduce."""
    specs = dict(_leaves(param_specs(hp, any("moe_w_in" in n
                                             for n in names))))
    by_axes: dict = {}
    for n, g in zip(names, grads):
        axes = tuple(a for a in specs[n] if a is not None)
        if zdims[n] >= 0:
            axes = axes + ("dp",)
        by_axes.setdefault(axes, []).append(torch.sum(g.float() ** 2))
    sumsq = torch.zeros((), dtype=torch.float32, device=mesh.device)
    for axes, locs in by_axes.items():
        v = torch.stack(locs)
        for a in axes:
            v = allreduce_(v, mesh.group(a))
        sumsq = sumsq + v.sum()
    return sumsq


@torch.no_grad()
def _adamw_update(params, grads, opt_state, hp, mesh=None, zdims=None):
    """AdamW with the exact global-norm clip, in place: every parameter
    and moment tensor is overwritten, and opt_state["step"] advanced.
    With a mesh, ``grads`` are the reduced local gradients; a ZeRO leaf
    updates this dp rank's shard of its parameter and all-gathers the
    shards over dp."""
    b1, b2 = hp.betas
    step = opt_state["step"] + 1
    stepf = step.float()
    bc1 = 1.0 - b1 ** stepf
    bc2 = 1.0 - b2 ** stepf
    names = [n for n, _ in _leaves(params)]
    gl = [g for _, g in _leaves(grads)]
    if mesh is None:
        sumsq = torch.zeros((), dtype=torch.float32, device=step.device)
        for g in gl:
            sumsq = sumsq + torch.sum(g.float() ** 2)
    else:
        sumsq = _global_sumsq(gl, names, hp, mesh, zdims)
    gnorm = torch.sqrt(sumsq)
    scale = torch.clamp(hp.grad_clip_norm / (gnorm + 1e-6), max=1.0) \
        if hp.grad_clip_norm else 1.0
    for (n, p), g, (_, m), (_, v) in zip(_leaves(params), gl,
                                         _leaves(opt_state["m"]),
                                         _leaves(opt_state["v"])):
        zd = -1 if zdims is None else zdims[n]
        target = p
        if zd >= 0:
            sz = p.shape[zd] // hp.dp
            target = p.narrow(zd, mesh.index("dp") * sz, sz)
        gf = g.float() * scale
        m2 = b1 * m + (1 - b1) * gf
        v2 = b2 * v + (1 - b2) * gf * gf
        upd = (m2 / bc1) / (torch.sqrt(v2 / bc2) + hp.eps)
        pf = target.float()
        if hp.weight_decay:
            pf = pf * (1.0 - hp.lr * hp.weight_decay)
        new = (pf - hp.lr * upd).to(p.dtype)
        if zd >= 0:
            new = _raw_all_gather(new, mesh.group("dp"), zd)
        p.copy_(new)
        m.copy_(m2)
        v.copy_(v2)
    opt_state["step"] = step
    return gnorm


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

def _validate(cfg: LlamaConfig, hp: HybridParallelConfig):
    """The reference's checks, with its wording."""
    if hp.pp_schedule == "vpp" and hp.vpp > 1:
        if cfg.num_hidden_layers % (hp.pp * hp.vpp):
            raise ValueError(
                f"layers={cfg.num_hidden_layers} must divide by "
                f"pp*vpp={hp.pp * hp.vpp}")
        if hp.num_microbatches % hp.pp:
            raise ValueError(
                f"vpp schedule needs num_microbatches % pp == 0 "
                f"(got {hp.num_microbatches} % {hp.pp})")
    if cfg.num_key_value_heads % hp.tp:
        raise ValueError(
            f"num_key_value_heads={cfg.num_key_value_heads} must divide by "
            f"tp={hp.tp} (kv heads are sharded over tp)")
    if hp.ep not in (1, hp.dp):
        raise ValueError(
            f"ep must be 1 or equal to dp (experts ride the dp axis); "
            f"got ep={hp.ep}, dp={hp.dp}")
    if hp.ep > 1 and not cfg.moe_experts:
        raise ValueError("ep > 1 requires cfg.moe_experts > 0")
    if cfg.moe_experts and hp.ep > 1 and cfg.moe_experts % hp.ep:
        raise ValueError(
            f"moe_experts={cfg.moe_experts} must divide by ep={hp.ep}")
    if cfg.num_attention_heads % cfg.num_key_value_heads:
        raise ValueError(
            f"num_attention_heads={cfg.num_attention_heads} must divide by "
            f"num_key_value_heads={cfg.num_key_value_heads}")
    if hp.remat_policy not in ("full", "attn"):
        raise ValueError(f"remat_policy must be 'full' or 'attn', got "
                         f"{hp.remat_policy!r}")
    if hp.pp_schedule not in ("1f1b", "gpipe", "vpp"):
        raise ValueError(f"pp_schedule must be '1f1b', 'gpipe' or 'vpp', "
                         f"got {hp.pp_schedule!r}")


def _sharded_loss_and_grads(params, tokens, cfg, hp, mesh):
    """This rank's loss (psum'd over pp, not yet over dp) and its local
    gradients before the cross-axis reductions, as ``(loss, [grad a
    leaf])`` in ``_leaves`` order.  tokens: [M, m, S]."""
    leaves = _leaves(params)
    live = [t.detach().requires_grad_(True) for _, t in leaves]
    ptree = _tree((n, t) for (n, _), t in zip(leaves, live))
    if hp.pp > 1 and hp.pp_schedule == "1f1b":
        loss, grads = _grads_1f1b(ptree, live, tokens, cfg, hp, mesh)
    elif hp.pp_schedule == "vpp" and hp.vpp > 1:
        loss, grads = _grads_vpp(ptree, live, tokens, cfg, hp, mesh)
    else:
        loss, grads = _grads_gpipe(ptree, live, tokens, cfg, hp, mesh)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(live, grads)]
    loss = allreduce_(loss / hp.num_microbatches, mesh.group("pp"))
    return loss, grads


def build_train_step(cfg: LlamaConfig, hp: HybridParallelConfig, mesh=None,
                     *, device=None):
    """Returns ``train_step(params, opt_state, tokens) -> (params,
    opt_state, loss)``.

    With no mesh (world 1 only): the single-card step on ``device`` (CUDA
    unless the caller asks for another; raises when CUDA is asked for and
    absent); tokens [M * m, S].  With a ``Mesh``: this rank's step on
    ``mesh.device``; params and opt_state are this rank's shards
    (``shard_params``, ``init_opt_state(params, hp, mesh)`` or
    ``shard_opt_state``) and tokens [M * m, S] are this rank's dp shard of
    the batch (replicated over pp, cp and tp); loss is the global mean on
    every rank.

    loss is a 0-d f32 tensor left on the device.  Where the JAX step
    donates its buffers, this one updates in place under ``no_grad``: the
    returned params and opt_state are the dicts passed in, their tensors
    overwritten, opt_state["step"] advanced."""
    _validate(cfg, hp)
    if mesh is None:
        if hp.world > 1:
            raise ValueError(f"hp.world={hp.world} needs a mesh "
                             f"(build_mesh)")
        dev = resolve_device(device)

        def train_step(params, opt_state, tokens):
            tokens = torch.as_tensor(tokens, device=dev).long()
            if params["embed"].device != tokens.device:
                raise ValueError(f"params on {params['embed'].device}, step "
                                 f"on {tokens.device}")
            loss, grads = loss_and_grads(params, tokens, cfg, hp)
            _adamw_update(params, grads, opt_state, hp)
            return params, opt_state, loss

        return train_step

    if tuple(mesh.size(a) for a in AXES) != (hp.pp, hp.dp, hp.cp, hp.tp):
        raise ValueError(f"mesh {mesh.shape} does not match hp "
                         f"(pp={hp.pp}, dp={hp.dp}, cp={hp.cp}, tp={hp.tp})")
    if device is not None and resolve_device(device) != mesh.device:
        raise ValueError(f"device {device} is not the mesh's {mesh.device}")
    zd = dict(_leaves(zero_dims(hp, _shapes(cfg))))
    M = hp.num_microbatches

    def train_step(params, opt_state, tokens):
        tokens = torch.as_tensor(tokens, device=mesh.device).long()
        if tokens.shape[0] % M:
            raise ValueError(f"batch {tokens.shape[0]} not divisible by "
                             f"num_microbatches={M}")
        if tokens.shape[1] % (hp.cp * hp.tp):
            raise ValueError(f"seq {tokens.shape[1]} must divide by "
                             f"cp*tp={hp.cp * hp.tp}")
        tokens = tokens.reshape(M, tokens.shape[0] // M, tokens.shape[1])
        loss, grads = _sharded_loss_and_grads(params, tokens, cfg, hp, mesh)
        names = [n for n, _ in _leaves(params)]
        grads = _reduce_grads(grads, names, hp, mesh, zd)
        loss = allreduce_(loss, mesh.group("dp")) / hp.dp
        _adamw_update(params, _tree(zip(names, grads)), opt_state, hp, mesh,
                      zd)
        return params, opt_state, loss

    return train_step
