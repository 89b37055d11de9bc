"""paddle.distributed.launch for the port: one process a rank, the
reference's env contract (PADDLE_TRAINER_ID / PADDLE_TRAINERS_NUM /
PADDLE_CURRENT_ENDPOINT / PADDLE_TRAINER_ENDPOINTS / PADDLE_MASTER) and
FLAGS_selected_gpus, from which ``init_parallel_env`` makes the NCCL (or
gloo) process group (counterpart of paddle_tpu/distributed/launch)."""
from .main import launch, main  # noqa: F401

__all__ = ["launch", "main"]
