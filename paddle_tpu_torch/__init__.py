"""PyTorch/CUDA port of paddle_tpu, slice by slice (see ROADMAP.md).

The JAX package ``paddle_tpu`` is the reference; this package imports
nothing of it and no JAX.  Ported so far: greedy and sampled LLaMA
serving through the continuous-batching ``inference.LLMEngine`` (float or
int8 KV pages, float or int8/int4 weight pools), the single-card and
hybrid-parallel LLaMA train steps ``parallel.build_train_step``, varlen
attention ``nn.functional.flash_attn_unpadded``, paged-KV
``incubate.nn.functional.block_multihead_attention`` and the fused ops
beside it, distributed's process layer, and the eager training surface:
``Tensor`` over torch autograd, the op schema's ported ops, ``nn.Layer``
and its layers, the optimizers and LR schedulers, AMP (``auto_cast``,
``decorate``, ``GradScaler``) and ``jit.capture_step`` (a CUDA graph of
the user's step).  Kernels are hand-written CUDA for Hopper under
``csrc/``: ragged paged attention (float and int8 pages) and paged decode,
the dequant matmul, flash attention forward, dK/dV and dQ, fixed-length
and varlen, and the fused RMSNorm / LayerNorm.  Entry points run on the
GPU unless the caller asks for the CPU (``set_device("cpu")``,
``device="cpu"``, or CPU tensors for the functionals).

    import paddle_tpu_torch as paddle
    net = paddle.nn.Sequential(paddle.nn.Linear(64, 128), paddle.nn.ReLU(),
                               paddle.nn.Linear(128, 1))
    opt = paddle.optimizer.Adam(learning_rate=0.01,
                                parameters=net.parameters())
    loss = paddle.nn.functional.mse_loss(net(x), y)
    loss.backward(); opt.step(); opt.clear_grad()
"""
from .core.dtype import (  # noqa: F401
    bfloat16, bool_ as bool, complex64, complex128, dtype, float8_e4m3fn,
    float8_e5m2, float16, float32, float64, int8, int16, int32, int64,
    uint8,
)
from .core.dispatch import (enable_grad, is_grad_enabled,  # noqa: F401
                            no_grad, set_grad_enabled)
from .core.flags import get_flags, set_flags  # noqa: F401
from .core.place import (CPUPlace, CUDAPinnedPlace, CUDAPlace,  # noqa: F401
                         device_count, get_device, is_compiled_with_cuda,
                         set_device)
from .core.random_state import (get_rng_state, seed,  # noqa: F401
                                set_rng_state)
from .core.tape import grad  # noqa: F401
from .core.tensor import Parameter, Tensor, to_tensor  # noqa: F401
from . import ops as _ops
from .ops import PUBLIC_OPS as _PUBLIC_OPS

globals().update({k: v for k, v in _PUBLIC_OPS.items()
                  if k not in globals()})
_ops.monkey_patch_tensor()

from . import amp, autograd, jit, nn, optimizer, regularizer  # noqa: E402,F401
