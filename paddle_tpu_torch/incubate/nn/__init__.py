"""``paddle.incubate.nn`` surface of the PyTorch port."""
