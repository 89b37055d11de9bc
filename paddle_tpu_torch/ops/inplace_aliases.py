"""The root surface's in-place twins, aliases, constants and the small
ops beside them (counterpart of paddle_tpu/ops/inplace_aliases.py).

``derive_inplace`` makes ``name_`` for every base op of the reference's
list that the port has; each twin writes its result into x's storage
(``ops/_inplace.py``), where the JAX package rebinds x to a new buffer.
The derivation is data-driven, so the two surfaces cannot drift."""
from __future__ import annotations

import numpy as np
import torch

from ..core import dispatch as D
from ..core.tensor import Tensor
from ._inplace import apply_inplace, rebind
from .manipulation import device_of, host_values

__all__ = ["derive_inplace", "ALIASES", "CONSTANTS", "extra_ops"]

# every `name_` the reference exports whose base op the port implements
_INPLACE_BASES = [
    "abs", "acos", "addmm", "asin", "atan", "bernoulli", "bitwise_and",
    "bitwise_not", "bitwise_or", "bitwise_xor", "cast", "ceil", "clip",
    "copysign", "cos", "cosh", "cumprod", "cumsum", "digamma", "divide",
    "equal", "erf", "exp", "expm1", "floor", "floor_divide", "frac",
    "gammainc", "gammaincc", "gcd", "greater_equal", "greater_than",
    "not_equal", "atanh", "lerp", "erfinv", "put_along_axis", "sigmoid",
    "acosh", "asinh",
    "hypot", "i0", "index_add",
    "index_fill", "index_put", "lcm", "ldexp", "less_equal", "less_than",
    "lgamma", "log", "log10", "log1p", "log2", "logical_and",
    "logical_not", "logical_or", "logical_xor", "logit", "masked_fill",
    "masked_scatter", "mod", "multiply", "nan_to_num", "neg", "pow",
    "reciprocal", "remainder", "renorm", "round", "rsqrt", "scale",
    "sigmoid", "sin", "sinc", "sinh", "sqrt", "square", "subtract",
    "tan", "tanh", "transpose", "tril", "triu", "trunc", "where",
    "bitwise_left_shift", "bitwise_right_shift", "polygamma",
    "multigammaln", "gammaln", "log_normal", "slice_scatter",
]


def _make_inplace(name, base):
    def fn_(x, *args, **kwargs):
        return apply_inplace(x, lambda s: base(s, *args, **kwargs))
    fn_.__name__ = name + "_"
    fn_.__doc__ = (f"In-place variant of `{name}`: the result is written "
                   "into x's storage.")
    return fn_


def derive_inplace(public_ops: dict) -> dict:
    out = {}
    for name in _INPLACE_BASES:
        base = public_ops.get(name)
        if base is not None and name + "_" not in public_ops:
            out[name + "_"] = _make_inplace(name, base)
    return out


# reference name -> existing op name
ALIASES = {
    "negative": "neg",
    "less": "less_than",
    "less_": "less_than_",
    "floor_mod": "mod",
    "floor_mod_": "mod_",
    "remainder": "mod",
    "row_stack": "vstack",
    "column_stack": "hstack",
    "bitwise_invert": "bitwise_not",
    "bitwise_invert_": "bitwise_not_",
}

CONSTANTS = {
    "inf": float("inf"),
    "nan": float("nan"),
    "pi": float(np.pi),
    "e": float(np.e),
    "newaxis": None,
}


def sigmoid(x, name=None):
    from .generated.op_wrappers import sigmoid as _f
    return _f(x)


def _positive(a):
    return +a


def positive(x, name=None):
    """Identity on numeric tensors."""
    return D.apply("positive", _positive, (x,))


def _t(a):
    return a.T if a.dim() == 2 else a.clone() if a.dim() < 2 else a


def t(input, name=None):
    """Transpose of a tensor of at most 2 dims."""
    if input.ndim > 2:
        raise ValueError(f"paddle.t expects ndim<=2, got {input.ndim}")
    return D.apply("t", _t, (input,))


def t_(input, name=None):
    return rebind(input, t(input))


def _matrix_transpose(a):
    return a.transpose(-1, -2)


def matrix_transpose(x, name=None):
    """Swap the last two dims."""
    return D.apply("matrix_transpose", _matrix_transpose, (x,))


def rank(input, name=None):
    """A 0-d int32 tensor holding ndim."""
    return Tensor(torch.tensor(input.ndim, dtype=torch.int32,
                               device=device_of(input)))


def _block_diag(*arrs):
    return torch.block_diag(*[torch.atleast_2d(a) for a in arrs])


def block_diag(inputs, name=None):
    """Block-diagonal assembly; gradients flow to every block."""
    return D.apply("block_diag", _block_diag, tuple(inputs))


def _cartesian_prod(*arrs):
    grids = torch.meshgrid(*arrs, indexing="ij")
    return torch.stack([g.reshape(-1) for g in grids], dim=-1)


def cartesian_prod(x, name=None):
    """Cartesian product of 1-D tensors, one row per combination."""
    return D.apply("cartesian_prod", _cartesian_prod, tuple(x))


def _isin(a, b, invert):
    return torch.isin(a, b.to(a.device), invert=invert)


def isin(x, test_x, assume_unique=False, invert=False, name=None):
    return D.apply("isin", _isin, (x, test_x), {"invert": bool(invert)})


def _vecdot(a, b, axis):
    return torch.sum(a * b, dim=axis)


def vecdot(x, y, axis=-1, name=None):
    return D.apply("vecdot", _vecdot, (x, y), {"axis": int(axis)})


def histogram_bin_edges(input, bins=100, min=0, max=0, name=None):
    """Bin edges on the host, as numpy computes them; on input's device."""
    a = host_values(input)
    lo, hi = (float(min), float(max)) if (min != 0 or max != 0) \
        else (float(a.min()), float(a.max()))
    edges = np.histogram_bin_edges(a, bins=bins, range=(lo, hi))
    return Tensor(torch.from_numpy(edges.astype(np.float32))
                  .to(device_of(input)))


def histogramdd(x, bins=10, ranges=None, density=False, weights=None,
                name=None):
    """A D-dimensional histogram on the host; on x's device."""
    a = host_values(x)
    w = None if weights is None else host_values(weights)
    hist, edges = np.histogramdd(a, bins=bins, range=ranges,
                                 density=density, weights=w)
    dev = device_of(x)
    return (Tensor(torch.from_numpy(hist.astype(np.float32)).to(dev)),
            [Tensor(torch.from_numpy(e.astype(np.float32)).to(dev))
             for e in edges])


def _frexp(a):
    m, e = torch.frexp(a)
    return m, e.to(torch.int32)


def frexp(x, name=None):
    return D.apply("frexp", _frexp, (x,))


def _unfold_windows(a, axis, size, step):
    n = (a.shape[axis] - size) // step + 1
    idx = torch.arange(n, device=a.device)[:, None] * step + \
        torch.arange(size, device=a.device)[None, :]
    out = torch.index_select(a, axis, idx.reshape(-1))
    shp = list(a.shape)
    shp[axis:axis + 1] = [n, size]
    # the window dim goes last
    return torch.movedim(out.reshape(shp), axis + 1, -1)


def unfold(x, axis, size, step, name=None):
    """Sliding windows along axis (Tensor.unfold)."""
    return D.apply("unfold_windows", _unfold_windows, (x,),
                   {"axis": int(axis), "size": int(size), "step": int(step)})


def check_shape(x, expected_shape):
    """Raise ValueError unless x's shape matches (-1 / None match any)."""
    got = tuple(x.shape)
    want = tuple(expected_shape)
    ok = len(got) == len(want) and all(
        w in (-1, None) or g == w for g, w in zip(got, want))
    if not ok:
        raise ValueError(f"shape mismatch: got {got}, expected {want}")
    return True


EXTRA_OPS = {f.__name__: f for f in (
    sigmoid, positive, t, t_, matrix_transpose, rank, block_diag,
    cartesian_prod, isin, vecdot, histogram_bin_edges, histogramdd, frexp,
    unfold, check_shape)}


def extra_ops():
    return dict(EXTRA_OPS)


def derived_names(public_ops: dict) -> set:
    """Names derived from schema'd bases (in-place twins, aliases,
    constants)."""
    names = set(CONSTANTS)
    names.update(ALIASES)
    names.update(n + "_" for n in _INPLACE_BASES)
    return names

