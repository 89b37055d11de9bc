"""Shared by the distributed tests on the CPU (tests/test_torch_dist_
collective.py, two gloo ranks) and on four cards (tests/test_torch_dist_
nccl.py, NCCL), without JAX: a launch through ``python -m
paddle_tpu_torch.distributed.launch``, and the ``DataParallel`` worker
with the single-process step it is held to."""
import os
import subprocess
import sys
import textwrap

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH_TIMEOUT_S = 180


def launch(tmp_path, body, nproc, backend, timeout=LAUNCH_TIMEOUT_S):
    """Runs body as every rank's script under the launcher, with
    ``PADDLE_DISTRI_BACKEND=backend``; returns (the completed process, the
    tail of every worker's log)."""
    script = tmp_path / "worker.py"
    script.write_text(textwrap.dedent(body))
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep +
               os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1",
               PADDLE_DISTRI_BACKEND=backend)
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc_per_node", str(nproc),
           "--log_dir", str(tmp_path / "log"), str(script)]
    r = subprocess.run(cmd, env=env, capture_output=True, text=True,
                       timeout=timeout, cwd=str(tmp_path))
    logs = "\n".join((tmp_path / "log" / f"workerlog.{i}").read_text()[-3000:]
                     for i in range(nproc)
                     if (tmp_path / "log" / f"workerlog.{i}").exists())
    return r, logs


# the model and data of the DataParallel check, run by the workers and,
# over the whole batch, by dp_single_process
DP_MODEL = """
import numpy as np
import torch

STEPS, LR, MICRO = 3, 0.1, 2


class Net(torch.nn.Module):
    # a shared layer applied twice, then a head

    def __init__(self):
        super().__init__()
        self.shared = torch.nn.Linear(8, 8)
        self.head = torch.nn.Linear(8, 4)

    def forward(self, x):
        return self.head(torch.tanh(self.shared(torch.tanh(self.shared(x)))))


def _data(world):
    # [step][micro][rank] (x [3, 8], y [3, 4]) from a numpy seed
    rng = np.random.RandomState(11)
    return [[[(rng.randn(3, 8).astype(np.float32),
               rng.randn(3, 4).astype(np.float32)) for _ in range(world)]
             for _ in range(MICRO)] for _ in range(STEPS)]
"""
exec(DP_MODEL)

# each rank: DataParallel with two buckets, every microbatch but the last
# accumulated under no_sync, SGD; its parameters saved as params_<rank>.npz
DP_WORKER = DP_MODEL + """
import paddle_tpu_torch.distributed as dist

dist.init_parallel_env()
rank, world = dist.get_rank(), dist.get_world_size()
dev = torch.device("cuda", torch.cuda.current_device()) \\
    if dist.get_backend() == "nccl" else torch.device("cpu")
torch.backends.cuda.matmul.allow_tf32 = False
torch.manual_seed(0)
net = Net().to(dev)
dp = dist.DataParallel(net, comm_buffer_size=1,
                       last_comm_buffer_size=0.0002)
assert len(dp._reducer.buckets) > 1
opt = torch.optim.SGD(net.parameters(), lr=LR)
for micros in _data(world):
    for i, micro in enumerate(micros):
        x, y = (torch.from_numpy(a).to(dev) for a in micro[rank])
        if i < len(micros) - 1:
            with dp.no_sync():
                torch.nn.functional.mse_loss(dp(x), y).backward()
        else:
            torch.nn.functional.mse_loss(dp(x), y).backward()
    dp.apply_collective_grads()
    opt.step()
    opt.zero_grad()
np.savez(f"params_{rank}.npz", **{n: p.detach().cpu().numpy()
                                  for n, p in net.named_parameters()})
dist.destroy_process_group()
"""


def dp_single_process(world, device="cpu"):
    """The same steps in one process over the whole batch: the loss is
    each microbatch's mean over ranks of their means, summed over
    microbatches."""
    torch.manual_seed(0)
    net = Net().to(device)
    opt = torch.optim.SGD(net.parameters(), lr=LR)
    for micros in _data(world):
        for micro in micros:
            loss = sum(torch.nn.functional.mse_loss(
                net(torch.from_numpy(x).to(device)),
                torch.from_numpy(y).to(device))
                for x, y in micro) / len(micro)
            loss.backward()
        opt.step()
        opt.zero_grad()
    return {n: p.detach().cpu().numpy() for n, p in net.named_parameters()}
