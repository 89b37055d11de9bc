"""Serving engine of the PyTorch port."""
from .kv_cache import BlockManager, BlockPoolExhausted
from .serving import LLMEngine, Request, RequestOutput
from .spec_decode import DraftModelDrafter, Drafter, NGramDrafter

__all__ = ["BlockManager", "BlockPoolExhausted", "DraftModelDrafter",
           "Drafter", "LLMEngine", "NGramDrafter", "Request",
           "RequestOutput"]
