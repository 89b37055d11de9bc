"""Every kernel-driven op the port's generator emits, through the port's
generated wrapper and through the JAX package's, forward and gradient, at
f32.  Inputs are numpy from a seed, in each op's domain; the gradient is
of ``sum(output * cotangent)`` with a fixed random cotangent, taken with
respect to every float input.  Forward and gradient to rtol 1e-5 / atol
1e-6 (1e-4 for the transcendental ones whose float32 implementations
differ between XLA and ATen in the last bits); integer and boolean
outputs exactly.  The kernel-driven ops ported after this table was
written have their cases in tests/_torch_sweep_cases.py (held by
tests/test_torch_op_sweep.py); ``test_every_generated_op_has_a_case``
keeps the two tables whole between them."""
import re

import numpy as np
import pytest

from _torch_eager import close, eager_state  # noqa: F401
from _torch_threads import torch_threads  # noqa: F401

import paddle_tpu as jp
import paddle_tpu_torch as pp
from paddle_tpu.ops.generated import op_wrappers as jw
from paddle_tpu_torch.ops.generated import op_wrappers as pw


def _r(*shape, lo=-2.0, hi=2.0, seed=0):
    return np.random.RandomState(seed).uniform(lo, hi, shape) \
        .astype(np.float32)


X = _r(3, 4)
Y = _r(3, 4, seed=1)
POS = _r(3, 4, lo=0.2, hi=2.0, seed=2)
PROB = _r(3, 4, lo=0.05, hi=0.95, seed=3)
BIN = (_r(3, 4, seed=4) > 0).astype(np.float32)
IDX = np.array([2, 0, 1, 0], np.int64)
LBL = np.array([1, 3, 0], np.int64)
MASK = _r(3, 4, seed=5) > 0


def _un(a=X):
    return lambda: ((a,), {})


def _bin(a=X, b=Y):
    return lambda: ((a, b), {})


CASES = {
    "abs": _un(), "neg": _un(), "exp": _un(), "expm1": _un(),
    "log": _un(POS), "log2": _un(POS), "log10": _un(POS),
    "log1p": _un(POS), "sqrt": _un(POS), "rsqrt": _un(POS),
    "square": _un(), "sin": _un(), "cos": _un(), "tan": _un(X * 0.5),
    "tanh": _un(), "floor": _un(), "ceil": _un(), "round": _un(),
    "trunc": _un(), "sign": _un(), "reciprocal": _un(POS), "erf": _un(),
    "isnan": _un(), "isinf": _un(), "isfinite": _un(),
    "logical_not": _un(MASK),
    "add": _bin(), "subtract": _bin(), "multiply": _bin(),
    "divide": _bin(X, POS), "pow": _bin(POS, Y), "maximum": _bin(),
    "minimum": _bin(), "floor_divide": _bin(X, POS), "mod": _bin(X, POS),
    "greater_than": _bin(), "less_than": _bin(), "greater_equal": _bin(),
    "less_equal": _bin(), "equal": _bin(X, np.round(X)),
    "not_equal": _bin(X, np.round(X)), "logical_and": _bin(MASK, ~MASK),
    "logical_or": _bin(MASK, ~MASK),
    "clip": lambda: ((X,), {"min": -0.5, "max": 0.7}),
    "scale": lambda: ((X,), {"scale": 1.5, "bias": 0.25}),
    "cast": lambda: ((X,), {"dtype": "float64"}),
    "sum": lambda: ((X,), {"axis": 1}), "mean": lambda: ((X,), {}),
    "max": lambda: ((X,), {"axis": 0}), "min": lambda: ((X,), {"axis": 1}),
    "amax": lambda: ((X,), {"axis": [0, 1]}),
    "amin": lambda: ((X,), {"axis": -1, "keepdim": True}),
    "prod": lambda: ((POS,), {"axis": 1}),
    "argmax": lambda: ((X,), {"axis": 1}), "argmin": lambda: ((X,), {}),
    "any": lambda: ((MASK,), {"axis": 0}), "all": lambda: ((MASK,), {}),
    "logsumexp": lambda: ((X,), {"axis": 1}),
    "var": lambda: ((X,), {"axis": 0}), "std": lambda: ((X,), {}),
    "cumsum": lambda: ((X,), {"axis": 1}),
    "reshape": lambda: ((X,), {"shape": [4, 3]}),
    "transpose": lambda: ((X,), {"perm": [1, 0]}),
    "concat": lambda: (([X, Y],), {"axis": 1}),
    "stack": lambda: (([X, Y],), {"axis": 0}),
    "flatten": lambda: ((X.reshape(3, 2, 2),), {"start_axis": 1}),
    "unsqueeze": lambda: ((X,), {"axis": [0, 2]}),
    "squeeze": lambda: ((X.reshape(3, 1, 4),), {"axis": 1}),
    "expand": lambda: ((X[:1],), {"shape": [3, -1]}),
    "expand_as": lambda: ((X[:1], Y), {}),
    "broadcast_to": lambda: ((X[:, :1],), {"shape": [3, 4]}),
    "tile": lambda: ((X,), {"repeat_times": [2, 1]}),
    "gather": lambda: ((X, IDX[:3]), {"axis": 1}),
    "index_select": lambda: ((X, IDX), {"axis": 1}),
    "masked_fill": lambda: ((X, MASK, np.float32(0.5)), {}),
    "one_hot": lambda: ((LBL,), {"num_classes": 4}),
    "matmul": lambda: ((X, Y), {"transpose_y": True}),
    "bmm": lambda: ((X.reshape(1, 3, 4), Y.reshape(1, 4, 3)), {}),
    "relu": _un(), "relu6": _un(X * 4), "sigmoid": _un(), "silu": _un(),
    "swish": _un(), "log_sigmoid": _un(), "softsign": _un(), "mish": _un(),
    "gelu": lambda: ((X,), {"approximate": True}),
    "softmax": lambda: ((X,), {"axis": 0}),
    "log_softmax": lambda: ((X,), {"axis": -1}),
    "leaky_relu": lambda: ((X,), {"negative_slope": 0.2}),
    "elu": lambda: ((X,), {"alpha": 0.5}),
    "softplus": lambda: ((X * 8,), {"beta": 2.0, "threshold": 5.0}),
    "hardswish": _un(X * 2),
    "mse_loss": _bin(), "l1_loss": lambda: ((X, Y), {"reduction": "sum"}),
    "smooth_l1_loss": lambda: ((X, Y), {"delta": 0.5}),
    "cross_entropy": lambda: ((X, LBL), {"label_smoothing": 0.1}),
    "nll_loss": lambda: ((np.log(PROB), LBL), {}),
    "binary_cross_entropy": lambda: ((PROB, BIN), {}),
    "binary_cross_entropy_with_logits": lambda: (
        (X, BIN), {"pos_weight": POS[0]}),
    "kl_div": lambda: ((np.log(PROB), PROB[::-1].copy()),
                       {"reduction": "batchmean"}),
}
# The JAX package runs with x64 off: its int64 results come back int32
# and float64 ones float32 outside the creation ops; the port keeps
# Paddle's int64 / float64.
X64 = {("int32", "int64"), ("float32", "float64")}
# the output does not depend on this input: jax.vjp gives it a zero
# gradient, torch none
UNUSED = {"expand_as"}
LOOSE = {"tan", "expm1", "erf", "pow", "log10", "log2", "mish", "gelu",
         "log_sigmoid", "softplus", "logsumexp", "binary_cross_entropy",
         "binary_cross_entropy_with_logits", "kl_div", "std", "var"}
TENSOR_KW = {"pos_weight"}


def _generated_ops():
    src = open(pw.__file__).read()
    return sorted(re.findall(r"^_k_(\w+) = _resolve", src, re.M))


def _call(pd, wrappers, name):
    args, kwargs = CASES[name]()
    leaves = []

    def t(a):
        a = np.asarray(a)
        x = pd.to_tensor(a)
        if a.dtype == np.float32:
            x.stop_gradient = False
            leaves.append(x)
        return x
    targs = [[t(e) for e in a] if isinstance(a, list) else t(a)
             for a in args]
    tkw = {k: (t(v) if k in TENSOR_KW else v) for k, v in kwargs.items()}
    out = getattr(wrappers, name)(*targs, **tkw)
    grads = []
    if out.dtype.name in ("float32", "float64") and leaves:
        ct = np.random.RandomState(9).uniform(0.5, 1.5, out.shape) \
            .astype(out.dtype.name)
        (out * pd.to_tensor(ct)).sum().backward()
        grads = [x.grad if x.grad is not None or name not in UNUSED
                 else pd.zeros(x.shape) for x in leaves]
    return out, grads


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_forward_and_gradient(name):
    ref = _call(jp, jw, name)
    got = _call(pp, pw, name)
    tol = 1e-4 if name in LOOSE else 1e-5
    pair = (ref[0].dtype.name, got[0].dtype.name)
    assert pair[0] == pair[1] or pair in X64, pair
    close(ref, got, rtol=tol, atol=tol if name in LOOSE else 1e-6)


def test_every_generated_op_has_a_case():
    import _torch_sweep_cases as sweep
    assert sorted(set(_generated_ops()) - set(CASES)
                  - set(sweep.CASES)) == []
    assert len(_generated_ops()) >= 60
