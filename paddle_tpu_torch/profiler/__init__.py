"""Serving statistics of the PyTorch port."""
from .serving import ServingStats

__all__ = ["ServingStats"]
