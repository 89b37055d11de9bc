"""Mixture-of-Experts gating (the eager ``MoELayer`` and its gates wait
for the eager surface, ROADMAP Queue 1 item 13)."""
from .gating import capacity_for, topk_gating  # noqa: F401
