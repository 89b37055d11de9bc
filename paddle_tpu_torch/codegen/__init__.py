"""Op schema + code generation for the port (counterpart of
paddle_tpu/codegen/).

Schema file:   paddle_tpu_torch/ops/ops.yaml   (the JAX package's, with
                                                its paths rewritten)
Generated:     paddle_tpu_torch/ops/generated/op_wrappers.py
               paddle_tpu_torch/ops/generated/op_registry.py
               paddle_tpu_torch/ops/generated/tensor_methods.py
               paddle_tpu_torch/Tensor.pyi

Only the ops the port defines are emitted: a kernel-driven op when
``ops/kernels.py`` defines its kernel, a hand-written one when its module
defines it.  Regenerate with:  python -m paddle_tpu_torch.codegen
"""
from .schema import ArgSpec, OpSpec, load_schema  # noqa: F401
