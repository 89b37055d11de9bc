"""Eager framework core of the PyTorch port (counterpart of
paddle_tpu/core/): dtypes, places, flags, errors, the random state, the
autocast state, op dispatch, the autograd surface and ``Tensor``."""
