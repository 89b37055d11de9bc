"""``paddle.incubate`` surface of the PyTorch port (ported so far: paged
block attention and the fused ops in ``incubate.nn.functional``)."""
