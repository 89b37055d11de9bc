"""Global autocast state consulted by the dispatcher (counterpart of
paddle_tpu/core/amp_state.py): the white and black op lists and the
per-thread autocast mode."""
from __future__ import annotations

import threading

import torch

_tls = threading.local()

# Ops that are numerically safe and fast in low precision (matmul-class).
WHITE_LIST = {
    "matmul", "conv2d", "conv1d", "conv3d", "conv2d_transpose", "mm", "bmm",
    "einsum", "linear", "addmm", "attention", "flash_attention",
    "fused_llama_attention", "fused_llama_mlp",
}
# Ops that must stay in float32.
BLACK_LIST = {
    "exp", "log", "log2", "log10", "log1p", "square", "reciprocal", "rsqrt",
    "pow", "softmax", "log_softmax", "cross_entropy",
    "softmax_with_cross_entropy", "cosh", "sinh", "cumsum", "cumprod", "sum",
    "mean", "norm", "p_norm", "layer_norm", "batch_norm", "group_norm",
    "instance_norm", "rms_norm", "sigmoid_cross_entropy_with_logits",
    "binary_cross_entropy", "nll_loss", "erf", "erfinv", "expm1", "tan",
    "acos", "asin", "atan2", "l1_loss", "smooth_l1_loss", "mse_loss",
    "kl_div", "margin_cross_entropy",
}


def enter_autocast(enable: bool, dtype, level: str):
    prev = get_state()
    _tls.state = (bool(enable), dtype, level)
    return prev


def restore(prev):
    _tls.state = prev


def get_state():
    return getattr(_tls, "state", (False, None, "O0"))


def is_autocast_enabled() -> bool:
    return get_state()[0]


def autocast_dtype_for(op_name: str):
    """Target torch dtype for this op's float inputs, or None for no
    cast."""
    enabled, dt, level = get_state()
    if not enabled:
        return None
    if op_name in WHITE_LIST:
        return dt
    if op_name in BLACK_LIST:
        return torch.float32
    if level == "O2":
        return dt
    return None
