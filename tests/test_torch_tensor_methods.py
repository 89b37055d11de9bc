"""The port's Tensor method surface and root op surface against the JAX
package's: every public op name (521), every module's __all__, the
Tensor methods the generated binding and monkey_patch_tensor attach, the
aliases and constants, and the in-place twins derived from
ops/inplace_aliases.py's base list.  Each twin is held to the JAX
package's on the sweep case of its base op (tests/_torch_sweep_cases.py;
rtol 1e-4 / atol 1e-4): its result and its input's values
after the call.  In the port a twin whose result keeps x's shape and
dtype writes into x's storage; a leaf that requires grad refuses the
write while autograd records, with Paddle's error."""
import importlib

import numpy as np
import pytest

from _torch_eager import close, eager_state  # noqa: F401
from _torch_threads import torch_threads  # noqa: F401

import paddle_tpu as jp
import paddle_tpu_torch as pp
from paddle_tpu_torch.ops import inplace_aliases as pia
import _torch_sweep_cases as S

# JAX-side internals of the reference's Tensor (its own tape and buffer
# rebinding), and the surfaces of packages the port has not reached yet
# (signal's stft / istft, the top-level create_parameter): ROADMAP.md
# Queue 1 item 13's later bullets.
NOT_METHODS = {"_accumulate_grad", "_accumulate_grad_raw", "_grad_node",
               "_output_index", "_replace_data", "create_parameter",
               "create_tensor", "istft", "stft"}


def test_public_ops_are_the_references():
    assert set(pp.ops.PUBLIC_OPS) == set(jp.ops.PUBLIC_OPS)
    assert len(pp.ops.PUBLIC_OPS) == 521
    for name, v in jp.ops.PUBLIC_OPS.items():
        got = pp.ops.PUBLIC_OPS[name]
        assert callable(got) == callable(v), name
        if not callable(v):
            assert got == v or (v != v and got != got), name
        assert callable(getattr(pp, name)) == callable(v), name


@pytest.mark.parametrize("mod", ["math", "manipulation", "logic", "linalg",
                                 "creation", "random", "array", "misc",
                                 "inplace_aliases"])
def test_module_exports_are_the_references(mod):
    ref = importlib.import_module("paddle_tpu.ops." + mod)
    got = importlib.import_module("paddle_tpu_torch.ops." + mod)
    # the reference lists two names it does not define at that module:
    # manipulation's rotate90 (None) and math's frexp (inplace_aliases)
    want = {n for n in getattr(ref, "__all__", ())
            if callable(getattr(ref, n, None))}
    have = {n for n in getattr(got, "__all__", ())
            if callable(getattr(got, n, None))}
    assert want <= have, sorted(want - have)


def test_tensor_methods_are_the_references():
    ref = {n for n in dir(jp.Tensor) if not n.startswith("__")}
    got = {n for n in dir(pp.Tensor) if not n.startswith("__")}
    assert ref - got == NOT_METHODS
    for name in sorted(ref - NOT_METHODS):
        assert callable(getattr(jp.Tensor, name)) == \
            callable(getattr(pp.Tensor, name)), name


def test_aliases_and_constants():
    J, P = jp.ops.PUBLIC_OPS, pp.ops.PUBLIC_OPS
    for alias, target in pia.ALIASES.items():
        # an alias names its target unless the name is an op of its own
        assert (P[alias] is P[target]) == (J[alias] is J[target]), alias
    assert pp.pi == jp.pi and pp.e == jp.e and pp.inf == jp.inf
    assert pp.newaxis is None and np.isnan(pp.nan)


def _twins():
    names = []
    for base in dict.fromkeys(pia._INPLACE_BASES):
        twin = base + "_"
        c = S.CASES.get(base)
        if twin in pp.ops.PUBLIC_OPS and c is not None and c.call is None:
            args, _ = S.inputs(base)
            if args and isinstance(args[0], np.ndarray):
                names.append(twin)
    return names


def _run_twin(pd, twin):
    args, kwargs = S.inputs(twin[:-1])
    conv = [pd.to_tensor(a) if isinstance(a, np.ndarray) else
            [pd.to_tensor(e) for e in a] if isinstance(a, list) else a
            for a in args]
    kw = {k: pd.to_tensor(v) if isinstance(v, np.ndarray) else v
          for k, v in kwargs.items()}
    x = conv[0]
    before = getattr(x, "_data", None)
    out = pd.ops.PUBLIC_OPS[twin](*conv, **kw)
    return out, x, before


@pytest.mark.parametrize("twin", _twins())
def test_inplace_twin_matches_the_jax_package(twin):
    jo, jx, _ = _run_twin(jp, twin)
    po, px, data = _run_twin(pp, twin)
    assert po is px
    close(jx.numpy(), px.numpy(), rtol=1e-4, atol=1e-4)
    close(jo.numpy(), po.numpy(), rtol=1e-4, atol=1e-4)
    args, _ = S.inputs(twin[:-1])
    if px.shape == list(args[0].shape) and \
            px._data.dtype == pp.to_tensor(args[0])._data.dtype:
        assert px._data is data          # written into x's own storage


def test_inplace_twins_are_derived_alike():
    assert len(_twins()) >= 80
    ref = {n for n in jp.ops.PUBLIC_OPS if n.endswith("_")}
    got = {n for n in pp.ops.PUBLIC_OPS if n.endswith("_")}
    assert ref == got


def test_inplace_on_a_leaf_that_requires_grad_raises():
    x = pp.to_tensor(np.ones((2, 2), np.float32), stop_gradient=False)
    with pytest.raises(RuntimeError, match="can't use inplace strategy"):
        x.exp_()
    with pp.no_grad():
        x.exp_()
    np.testing.assert_allclose(x.numpy(), np.e * np.ones((2, 2)), rtol=1e-6)


def test_inplace_on_an_intermediate_keeps_the_gradient():
    """d/dx sum(exp(2x)) through y = 2x; y.exp_().  (The JAX package's
    derived twin rebinds the buffer without the op's tape node, so its
    gradient there is 2: the port is held to the analytic one.)"""
    xn = np.array([0.5, -1.0, 2.0], np.float32)
    x = pp.to_tensor(xn, stop_gradient=False)
    y = x * 2.0
    y.exp_()
    y.sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), 2 * np.exp(2 * xn),
                               rtol=1e-6)
    np.testing.assert_allclose(y.numpy(), np.exp(2 * xn), rtol=1e-6)


def _iadd(pd, x, y):
    x += y
    return x


def _isub(pd, x, y):
    x -= y
    return x


def _imul(pd, x, y):
    x *= y
    return x


def _idiv(pd, x, y):
    x /= y
    return x


# one in-place op called as a Tensor method, an operator, a root twin and
# a functional: each writes into x's storage and refuses a leaf that
# requires grad, whichever way it is called
CALL_STYLES = {
    "x.add_(y)": lambda pd, x, y: x.add_(y),
    "x += y": _iadd,
    "x.subtract_(y)": lambda pd, x, y: x.subtract_(y),
    "x -= y": _isub,
    "paddle.subtract_(x, y)": lambda pd, x, y: pd.subtract_(x, y),
    "x.multiply_(y)": lambda pd, x, y: x.multiply_(y),
    "x *= y": _imul,
    "paddle.multiply_(x, y)": lambda pd, x, y: pd.multiply_(x, y),
    "x.divide_(y)": lambda pd, x, y: x.divide_(y),
    "x /= y": _idiv,
    "paddle.divide_(x, y)": lambda pd, x, y: pd.divide_(x, y),
    "x.clip_(-0.5, 0.5)": lambda pd, x, y: x.clip_(-0.5, 0.5),
    "paddle.clip_(x, -0.5, 0.5)": lambda pd, x, y: pd.clip_(x, -0.5, 0.5),
    "x.scale_(2.0, 1.0)": lambda pd, x, y: x.scale_(2.0, 1.0),
    "paddle.scale_(x, 2.0, 1.0)": lambda pd, x, y: pd.scale_(x, 2.0, 1.0),
    "x.fill_(2.5)": lambda pd, x, y: x.fill_(2.5),
    "paddle.fill_(x, 2.5)": lambda pd, x, y: pd.fill_(x, 2.5),
    "x.zero_()": lambda pd, x, y: x.zero_(),
    "x.tanh_()": lambda pd, x, y: x.tanh_(),
    "F.tanh_(x)": lambda pd, x, y: pd.nn.functional.tanh_(x),
    "F.relu_(x)": lambda pd, x, y: pd.nn.functional.relu_(x),
    "F.softmax_(x)": lambda pd, x, y: pd.nn.functional.softmax_(x),
}


@pytest.mark.parametrize("style", sorted(CALL_STYLES))
def test_inplace_writes_alike_however_called(style):
    """The result equals the JAX package's (rtol 1e-5 / atol 1e-6), x
    keeps its storage, and a leaf that requires grad refuses the write
    with Paddle's error while autograd records."""
    call = CALL_STYLES[style]
    r = np.random.RandomState(7)
    xn = r.randn(3, 4).astype(np.float32)
    yn = (np.abs(r.randn(3, 4)) + 0.5).astype(np.float32)
    jx = jp.to_tensor(xn)
    call(jp, jx, jp.to_tensor(yn))
    px = pp.to_tensor(xn)
    data = px._data
    out = call(pp, px, pp.to_tensor(yn))
    assert out is px and px._data is data
    close(jx.numpy(), px.numpy(), rtol=1e-5, atol=1e-6)
    leaf = pp.to_tensor(xn, stop_gradient=False)
    with pytest.raises(RuntimeError, match="can't use inplace strategy"):
        call(pp, leaf, pp.to_tensor(yn))
    np.testing.assert_array_equal(leaf.numpy(), xn)
