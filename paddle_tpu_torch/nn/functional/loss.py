"""Loss functionals (counterpart of the ported part of
paddle_tpu/nn/functional/loss.py): the kernel-driven losses, and
softmax_with_cross_entropy over them."""
from __future__ import annotations

from ...ops.generated.op_wrappers import (  # noqa: F401
    binary_cross_entropy, binary_cross_entropy_with_logits, cross_entropy,
    kl_div, l1_loss, mse_loss, nll_loss, smooth_l1_loss,
)

__all__ = ["cross_entropy", "softmax_with_cross_entropy",
           "binary_cross_entropy", "binary_cross_entropy_with_logits",
           "nll_loss", "l1_loss", "mse_loss", "smooth_l1_loss", "kl_div"]


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1, name=None):
    from ...ops.generated.op_wrappers import softmax, unsqueeze
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis)
    loss = unsqueeze(loss, axis)
    if return_softmax:
        return loss, softmax(logits, axis=axis)
    return loss
