"""AUTO-GENERATED by `python -m paddle_tpu_torch.codegen` — DO NOT EDIT.
Source of truth: paddle_tpu_torch/ops/ops.yaml
"""
from .op_registry import OP_REGISTRY  # noqa: F401
from .tensor_methods import bind_tensor_methods  # noqa: F401
from . import op_wrappers  # noqa: F401
