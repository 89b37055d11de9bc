"""``paddle.nn`` surface of the PyTorch port (ported so far: the attention
functionals in ``nn.functional``)."""
