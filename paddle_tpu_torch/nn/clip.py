"""Gradient clipping (counterpart of paddle_tpu/nn/clip.py): on (param,
grad) lists as the optimizers consume them.  The norms and scales stay on
the card: no host read, so a captured step clips inside its graph."""
from __future__ import annotations

import torch

from ..core.tensor import Tensor

__all__ = ["ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm",
           "clip_grad_norm_", "clip_grad_value_"]


class ClipGradBase:
    def __call__(self, params_grads):
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def __call__(self, params_grads):
        return [(p, g if g is None else
                 Tensor(torch.clamp(g._data, self.min, self.max)))
                for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        out = []
        for p, g in params_grads:
            if g is None:
                out.append((p, g))
                continue
            norm = torch.sqrt(torch.sum(torch.square(g._data.float())))
            scale = torch.clamp(
                self.clip_norm / torch.clamp(norm, min=1e-12), max=1.0)
            out.append((p, Tensor((g._data * scale).to(g._data.dtype))))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        sq = [torch.sum(torch.square(g._data.float()))
              for p, g in params_grads
              if g is not None and getattr(p, "need_clip", True)]
        if not sq:
            return params_grads
        total = sq[0]
        for s in sq[1:]:
            total = total + s
        global_norm = torch.sqrt(total)
        scale = torch.clamp(
            self.clip_norm / torch.clamp(global_norm, min=1e-12), max=1.0)
        out = []
        for p, g in params_grads:
            if g is None or not getattr(p, "need_clip", True):
                out.append((p, g))
            else:
                out.append((p, Tensor((g._data.float() * scale)
                                      .to(g._data.dtype))))
        return out


def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    if isinstance(parameters, Tensor):
        parameters = [parameters]
    grads = [p._data.grad for p in parameters if p._data.grad is not None]
    if not grads:
        return Tensor(torch.zeros(()))
    if norm_type == float("inf"):
        total = torch.max(torch.stack([torch.max(torch.abs(g))
                                       for g in grads]))
    else:
        total = torch.sum(torch.stack(
            [torch.sum(torch.abs(g.float()) ** norm_type) for g in grads]
        )) ** (1.0 / norm_type)
    scale = torch.clamp(max_norm / torch.clamp(total, min=1e-6), max=1.0)
    with torch.no_grad():
        for g in grads:
            g.copy_((g * scale).to(g.dtype))
    return Tensor(total)


def clip_grad_value_(parameters, clip_value):
    if isinstance(parameters, Tensor):
        parameters = [parameters]
    with torch.no_grad():
        for p in parameters:
            if p._data.grad is not None:
                p._data.grad.clamp_(-clip_value, clip_value)
