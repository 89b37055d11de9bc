"""Weight regularizers (counterpart of paddle_tpu/regularizer.py): L1Decay
/ L2Decay attached per parameter via ParamAttr or globally via the
optimizer's weight_decay argument.

L2Decay flows through the optimizers' fused weight-decay slot; L1Decay
contributes coeff * sign(p) to the gradient before the update.
"""
from __future__ import annotations

__all__ = ["L1Decay", "L2Decay"]


class L2Decay:
    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)
        self._l1 = False

    def __repr__(self):
        return f"L2Decay({self._coeff})"


class L1Decay:
    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)
        self._l1 = True

    def __repr__(self):
        return f"L1Decay({self._coeff})"
