"""Serving engine of the PyTorch port."""
from .kv_cache import BlockManager, BlockPoolExhausted
from .serving import LLMEngine, Request, RequestOutput

__all__ = ["BlockManager", "BlockPoolExhausted", "LLMEngine", "Request",
           "RequestOutput"]
