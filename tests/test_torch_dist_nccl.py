"""PyTorch port, distributed over NCCL: four ranks started by ``python -m
paddle_tpu_torch.distributed.launch --nproc_per_node 4``, one card each.
Marked ``cuda``; it needs four CUDA devices and skips with fewer.  On a
four-GPU host:

    python -m pytest tests/test_torch_dist_nccl.py --noconftest -q

The first launch runs every eager collective at world 4 against numpy
(sum, mean, max, min and product, a task, broadcast, the gathers,
reduce_scatter, alltoall, scatter, a ring of batched sends and a pair,
groups of half the ranks, barriers), then the hybrid trainer at dp 2 x
tp 2 on the mesh of ``HybridCommunicateGroup.get_jax_mesh()`` for 3 steps
against the single-card step on the first card (f32 losses to rtol
1e-4).  The second runs ``DataParallel`` (two buckets, a microbatch
accumulated under ``no_sync``): every rank's parameters after 3 SGD steps
equal the single-process step's on the whole batch (rtol 1e-5, atol
1e-6).  The same workers run over gloo on the CPU with
``PADDLE_DISTRI_BACKEND=gloo``."""
import json

import numpy as np
import pytest
import torch

import _torch_dist as td
from paddle_tpu_torch.models.llama import LlamaConfig
from paddle_tpu_torch.parallel import transformer as pt
from _torch_threads import torch_threads  # noqa: F401

pytestmark = pytest.mark.cuda

WORLD, STEPS, LR, SEED, SEQ, ROWS = 4, 3, 1e-3, 0, 256, 2
LOSS_RTOL, TOL = 1e-4, 1e-6
RUN_TIMEOUT_S = 600
SMALL = dict(vocab_size=2048, hidden_size=512, intermediate_size=1024,
             num_hidden_layers=4, num_attention_heads=8,
             num_key_value_heads=4, max_position_embeddings=512)
HP = dict(dp=2, tp=2, num_microbatches=2, zero_stage=1, lr=LR)

WORKER = f"""
import json
import numpy as np
import torch
import paddle_tpu_torch.distributed as dist
from paddle_tpu_torch.distributed.fleet import (CommunicateTopology,
                                                HybridCommunicateGroup)
from paddle_tpu_torch.models.llama import LlamaConfig
from paddle_tpu_torch.parallel import transformer as pt

dist.init_parallel_env()
rank, n = dist.get_rank(), dist.get_world_size()
nccl = dist.get_backend() == "nccl"
dev = torch.device("cuda", torch.cuda.current_device()) if nccl \\
    else torch.device("cpu")
torch.backends.cuda.matmul.allow_tf32 = False
rng = np.random.RandomState(0)
X = np.stack([rng.randn(6).astype(np.float32) for _ in range(n)])
checks = {{"nccl_on_own_card": not nccl or dev.index == rank}}


def mine():
    return torch.from_numpy(X[rank].copy()).to(dev)


def close(name, got, want, tol=1e-5):
    got = np.stack([g.cpu().numpy() for g in got]) \\
        if isinstance(got, list) else got.cpu().numpy()
    checks[name] = bool(np.allclose(got, want, rtol=tol, atol=tol))


for op, want in (("SUM", X.sum(0)), ("AVG", X.mean(0)), ("MAX", X.max(0)),
                 ("MIN", X.min(0)), ("PROD", X.prod(0))):
    t = mine()
    dist.all_reduce(t, getattr(dist.ReduceOp, op))
    close("all_reduce_" + op, t, want)
t = mine()
dist.all_reduce(t, sync_op=False).wait()
close("all_reduce_task", t, X.sum(0))
t = mine()
dist.broadcast(t, src=n - 1)
close("broadcast", t, X[n - 1])
outs = []
dist.all_gather(outs, mine())
close("all_gather", outs, X)
close("all_gather_stacked", dist.all_gather(None, mine()), X)
objs = []
dist.all_gather_object(objs, {{"r": rank, "pad": "x" * rank}})
checks["all_gather_object"] = objs == [{{"r": r, "pad": "x" * r}}
                                       for r in range(n)]
ins = [torch.full((2,), float(rank * n + i), device=dev) for i in range(n)]
out = torch.zeros(2, device=dev)
dist.reduce_scatter(out, ins)
close("reduce_scatter", out, np.full(2, sum(r * n + rank for r in range(n))))
outs = []
dist.alltoall(outs, ins)
close("alltoall", outs, [np.full(2, r * n + rank) for r in range(n)])
t = torch.zeros(6, device=dev)
dist.scatter(t, [torch.from_numpy(x).to(dev) for x in X] if rank == 0
             else None, src=0)
close("scatter", t, X[rank])
buf = torch.zeros(6, device=dev)
for task in dist.batch_isend_irecv(
        [dist.P2POp(dist.isend, mine(), (rank + 1) % n),
         dist.P2POp(dist.irecv, buf, (rank - 1) % n)]):
    task.wait()
close("batch_isend_irecv_ring", buf, X[(rank - 1) % n])
if rank == 0:
    dist.send(mine(), dst=1)
elif rank == 1:
    buf = torch.zeros(6, device=dev)
    dist.recv(buf, src=0)
    close("send_recv", buf, X[0])
halves = [dist.new_group(list(range(h * n // 2, (h + 1) * n // 2)))
          for h in range(2)]
g = halves[rank // (n // 2)]
t = mine()
dist.all_reduce(t, group=g)
close("new_group_half", t, X[g.ranks].sum(0))
dist.barrier()
dist.barrier(group=g)

# the hybrid trainer, dp 2 x tp 2, on the topology's mesh
hcg = HybridCommunicateGroup(CommunicateTopology(dims=(2, 1, 1, 1, 2)))
checks["hcg_groups"] = (hcg.get_data_parallel_group().ranks,
                        hcg.get_model_parallel_group().ranks) == (
    [rank % 2, rank % 2 + 2], [rank // 2 * 2, rank // 2 * 2 + 1])
mesh = hcg.get_jax_mesh()
checks["hcg_mesh"] = mesh.coords == {{"pp": 0, "dp": rank // 2, "cp": 0,
                                      "tp": rank % 2}}
cfg = LlamaConfig(**{SMALL!r})
hp = pt.HybridParallelConfig(**{HP!r})
full = pt.init_params(cfg, hp, seed={SEED}, device="cpu")
params = pt.shard_params(full, hp, mesh)
opt = pt.init_opt_state(params, hp, mesh)
step = pt.build_train_step(cfg, hp, mesh)
tokens = np.random.RandomState({SEED}).randint(
    0, cfg.vocab_size, ({STEPS}, hp.dp * hp.num_microbatches * {ROWS},
                        {SEQ}))
rows = tokens.shape[1] // hp.dp
d = mesh.index("dp")
losses = [float(step(params, opt, torch.from_numpy(t[d * rows:(d + 1) *
                                                     rows]))[2])
          for t in tokens]
mesh.close()
with open(f"rank{{rank}}.json", "w") as f:
    json.dump({{"checks": checks, "losses": losses}}, f)
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def cards():
    if torch.cuda.device_count() < WORLD:
        pytest.skip(f"needs {WORLD} CUDA devices")
    from paddle_tpu_torch.ops import _build
    _build.build(["flash_attention"])    # once, before the ranks start
    torch.backends.cuda.matmul.allow_tf32 = False


def single_card_losses():
    """The single-card step on the first card over the same global
    batches (its microbatches are every dp rank's, in order)."""
    cfg = LlamaConfig(**SMALL)
    hp = pt.HybridParallelConfig(**HP)
    hp1 = pt.HybridParallelConfig(
        lr=LR, num_microbatches=hp.num_microbatches * hp.dp)
    params = pt._tree((n, t.to("cuda:0")) for n, t in pt._leaves(
        pt.init_params(cfg, hp, seed=SEED, device="cpu")))
    opt = pt.init_opt_state(params)
    step = pt.build_train_step(cfg, hp1, device="cuda:0")
    tokens = np.random.RandomState(SEED).randint(
        0, cfg.vocab_size, (STEPS, hp.dp * hp.num_microbatches * ROWS, SEQ))
    return [float(step(params, opt, torch.from_numpy(t))[2])
            for t in tokens]


def test_collectives_and_hybrid_step_over_four_nccl_ranks(cards, tmp_path):
    r, logs = td.launch(tmp_path, WORKER, WORLD, "nccl",
                        timeout=RUN_TIMEOUT_S)
    assert r.returncode == 0, r.stderr[-3000:] + logs
    recs = [json.loads((tmp_path / f"rank{k}.json").read_text())
            for k in range(WORLD)]
    for k, rec in enumerate(recs):
        assert all(rec["checks"].values()), (k, rec["checks"])
    assert all(rec["losses"] == recs[0]["losses"] for rec in recs)
    np.testing.assert_allclose(recs[0]["losses"], single_card_losses(),
                               rtol=LOSS_RTOL)


def test_data_parallel_over_four_nccl_ranks(cards, tmp_path):
    r, logs = td.launch(tmp_path, td.DP_WORKER, WORLD, "nccl",
                        timeout=RUN_TIMEOUT_S)
    assert r.returncode == 0, r.stderr[-3000:] + logs
    want = td.dp_single_process(WORLD, "cuda:0")
    for rank in range(WORLD):
        got = np.load(tmp_path / f"params_{rank}.npz")
        assert set(got.files) == set(want)
        for n in want:
            np.testing.assert_allclose(got[n], want[n], rtol=1e-5, atol=TOL,
                                       err_msg=n)
