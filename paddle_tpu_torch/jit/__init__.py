"""jit namespace of the port (counterpart of paddle_tpu/jit/): whole
train-step capture as a CUDA graph.  ``to_static`` and the rest of the
JAX package's ``jit`` are not ported yet (ROADMAP.md Queue 1 item 13)."""
from .step import CapturedStep, capture_step  # noqa: F401

__all__ = ["capture_step", "CapturedStep"]
