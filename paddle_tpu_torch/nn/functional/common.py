"""Common functionals: linear, dropout, embedding, one_hot (counterpart of
the ported part of paddle_tpu/nn/functional/common.py)."""
from __future__ import annotations

import torch

from ...core import dispatch as D
from ...core import random_state
from ...core.tensor import Tensor

__all__ = ["linear", "dropout", "embedding", "one_hot"]


def _linear(x, w, b=None):
    y = torch.matmul(x, w)
    if b is not None:
        y = y + b
    return y


def linear(x, weight, bias=None, name=None):
    """y = x @ W (+ b), W laid out [in, out] as in Paddle."""
    args = (x, weight) if bias is None else (x, weight, bias)
    return D.apply("linear", _linear, args)


def _dropout(a, p, axis, upscale, gen):
    shape = a.shape if axis is None else tuple(
        a.shape[i] if i in axis else 1 for i in range(a.dim()))
    keep = torch.empty(shape, dtype=torch.float32, device=a.device)
    keep = keep.bernoulli_(1.0 - p, generator=gen).bool()
    if upscale:
        return torch.where(keep, a / (1.0 - p), 0.0).to(a.dtype)
    return torch.where(keep, a, 0.0)


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    if isinstance(p, Tensor):
        p = float(p.item())
    if not training or p == 0.0:
        if not training and mode == "downscale_in_infer" and p > 0.0:
            from ...ops.math import scale as _scale
            return _scale(x, 1.0 - p)
        return x
    ax = tuple(axis) if isinstance(axis, (list, tuple)) else \
        (None if axis is None else (int(axis),))
    return D.apply("dropout", _dropout, (x,),
                   {"p": float(p), "axis": ax,
                    "upscale": mode == "upscale_in_train",
                    "gen": random_state.generator(x._data.device)})


def _emb(ids, w, padding_idx):
    out = torch.nn.functional.embedding(ids.long(), w)
    if padding_idx is not None:
        # padding rows contribute no gradient to the table
        pad = (ids == padding_idx)[..., None]
        out = torch.where(pad, out.detach(), out)
    return out


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    return D.apply("embedding", _emb, (x, weight),
                   {"padding_idx": padding_idx})


def one_hot(x, num_classes, name=None):
    from ...ops.generated.op_wrappers import one_hot as _oh
    return _oh(x, num_classes)
