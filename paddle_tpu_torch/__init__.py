"""PyTorch/CUDA port of paddle_tpu, slice by slice (see ROADMAP.md).

The JAX package ``paddle_tpu`` is the reference; this package imports
nothing of it and no JAX.  Ported so far: greedy and sampled LLaMA
serving through the continuous-batching ``inference.LLMEngine`` (float or
int8 KV pages, float or int8/int4 weight pools), the single-card LLaMA
train step ``parallel.build_train_step``, varlen attention
``nn.functional.flash_attn_unpadded``, paged-KV
``incubate.nn.functional.block_multihead_attention`` and the fused ops
beside it (``fused_rms_norm``, ``fused_layer_norm``, rotary embedding,
``swiglu``, ``fused_linear``).  Their kernels are hand-written CUDA for
Hopper under ``csrc/``: ragged paged attention (float and int8 pages) and
paged decode, the dequant matmul, flash attention forward, dK/dV and dQ,
fixed-length and varlen, and the fused RMSNorm / LayerNorm.  Entry points
run on the GPU unless the caller passes ``device="cpu"`` (or, for the
functionals, CPU tensors).
"""
