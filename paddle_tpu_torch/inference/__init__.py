"""Serving engine of the PyTorch port."""
from .faults import FaultPlan, InjectedFault
from .kv_cache import BlockManager, BlockPoolExhausted
from .kv_tier import HostSpillPool
from .pressure import DegradationController
from .serving import LLMEngine, Request, RequestOutput
from .spec_decode import DraftModelDrafter, Drafter, NGramDrafter

__all__ = ["BlockManager", "BlockPoolExhausted", "DegradationController",
           "DraftModelDrafter", "Drafter", "FaultPlan", "HostSpillPool",
           "InjectedFault", "LLMEngine", "NGramDrafter", "Request",
           "RequestOutput"]
