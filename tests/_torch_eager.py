"""Shared by the eager-surface tests (tests/test_torch_tensor.py,
_autograd, _optimizer, _optimizer_oracle, _amp, _nn, _capture_step,
_op_parity): import ``eager_state`` into a test file (``from _torch_eager
import eager_state  # noqa: F401``) to run the file with the port on the
CPU and with the JAX package's module state (random state, flags)
restored afterwards.

``both(fn)`` runs ``fn(package)`` with the JAX package and with the port
and returns the two results; ``close`` holds the port's numbers to the
JAX package's, through nested lists, tuples and dicts."""
import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as pp
from paddle_tpu.core import flags as jflags
from paddle_tpu.core import random_state as jrs
from paddle_tpu_torch.core import flags as pflags
from paddle_tpu_torch.core import place as pplace


@pytest.fixture(scope="module", autouse=True)
def eager_state():
    prev_place = pplace._state["place"]
    j_rng, j_flags = jrs.get_rng_state(), jflags.get_flags()
    p_rng, p_flags = pp.get_rng_state(), pflags.get_flags()
    pp.set_device("cpu")
    yield
    pplace._state["place"] = prev_place
    jrs.set_rng_state(j_rng)
    jflags.set_flags(j_flags)
    pp.set_rng_state(p_rng)
    pflags.set_flags(p_flags)


def both(fn):
    """(fn(JAX package), fn(port))."""
    return fn(jp), fn(pp)


def to_np(x):
    if hasattr(x, "numpy"):
        return np.asarray(x.numpy(), dtype=np.float64) \
            if x.dtype.name == "bfloat16" else np.asarray(x.numpy())
    return x


def close(ref, got, rtol=1e-6, atol=1e-6, path="out"):
    """Holds got (the port's) to ref (the JAX package's)."""
    if isinstance(ref, dict):
        assert set(ref) == set(got), (path, set(ref) ^ set(got))
        for k in ref:
            close(ref[k], got[k], rtol, atol, f"{path}[{k!r}]")
        return
    if isinstance(ref, (list, tuple)):
        assert len(ref) == len(got), (path, len(ref), len(got))
        for i, (a, b) in enumerate(zip(ref, got)):
            close(a, b, rtol, atol, f"{path}[{i}]")
        return
    a, b = to_np(ref), to_np(got)
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, (path, a.shape, b.shape)
        if a.dtype.kind in "biu" and b.dtype.kind in "biu":
            np.testing.assert_array_equal(b, a, err_msg=path)
        else:
            np.testing.assert_allclose(np.asarray(b, np.float64),
                                       np.asarray(a, np.float64),
                                       rtol=rtol, atol=atol, err_msg=path)
    else:
        if isinstance(a, float) or isinstance(b, float):
            np.testing.assert_allclose(b, a, rtol=rtol, atol=atol,
                                       err_msg=path)
        else:
            assert a == b, (path, a, b)


def carry(jnet, pnet):
    """The JAX layer's state dict, as numpy, into the port's layer of the
    same structure."""
    missing, unexpected = pnet.set_state_dict(
        {k: np.asarray(v.numpy()) for k, v in jnet.state_dict().items()})
    assert not missing and not unexpected, (missing, unexpected)
    return pnet
