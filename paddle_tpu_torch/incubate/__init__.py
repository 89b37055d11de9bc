"""``paddle.incubate`` surface of the PyTorch port (ported so far: paged
block attention in ``incubate.nn.functional``)."""
