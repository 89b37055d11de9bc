"""PyTorch/CUDA port of paddle_tpu, slice by slice (see ROADMAP.md).

The JAX package ``paddle_tpu`` is the reference; this package imports
nothing of it and no JAX.  Ported so far: greedy and sampled LLaMA
serving through the continuous-batching ``inference.LLMEngine``, whose
attention runs through a hand-written CUDA kernel for Hopper
(``csrc/ragged_paged_attention.cu``).  Entry points run on the GPU unless
the caller passes ``device="cpu"``.
"""
