"""The port's flag registry (core/flags.py) against the JAX package's:
the same flags with the same defaults and types, the same errors, and
``set_flags`` reaching the communication watchdog's timeout (the port's
watchdog reads the registry at every check, as the reference's does)."""
import pytest

import paddle_tpu_torch as pp
from paddle_tpu.core import flags as jflags
from paddle_tpu.distributed import watchdog as jwd
from paddle_tpu_torch.core import flags as pflags
from paddle_tpu_torch.distributed import watchdog as pwd
from _torch_threads import torch_threads  # noqa: F401


@pytest.fixture
def restore_flags():
    j, p = jflags.get_flags(), pflags.get_flags()
    yield
    jflags.set_flags(j)
    pflags.set_flags(p)


SHARED = ["v", "check_nan_inf", "check_nan_inf_level",
          "eager_compile_cache_size", "benchmark", "use_pallas_kernels",
          "log_compiles", "comm_watchdog_timeout", "analysis_mode"]


def test_defaults_match_the_reference():
    got = pflags.get_flags(SHARED)
    assert got == jflags.get_flags(SHARED)
    assert got["use_pallas_kernels"] is True
    assert got["check_nan_inf"] is False


def test_set_and_get_match_the_reference(restore_flags):
    for mod in (jflags, pflags):
        mod.set_flags({"FLAGS_check_nan_inf_level": "3",
                       "use_pallas_kernels": "false"})
    keys = ["FLAGS_check_nan_inf_level", "use_pallas_kernels"]
    assert pp.get_flags(keys) == jflags.get_flags(keys) == \
        {"FLAGS_check_nan_inf_level": 3, "use_pallas_kernels": False}
    for mod in (jflags, pflags):
        with pytest.raises(ValueError, match="Unknown flag"):
            mod.set_flags({"no_such_flag": 1})


def test_set_flags_changes_the_watchdog_timeout(restore_flags):
    assert pwd.comm_task_manager._timeout() == \
        jwd.comm_task_manager._timeout()
    pp.set_flags({"comm_watchdog_timeout": 2.5})
    jflags.set_flags({"comm_watchdog_timeout": 2.5})
    assert pwd.CommTaskManager()._timeout() == 2.5 == \
        jwd.CommTaskManager()._timeout()
    pp.set_flags({"FLAGS_comm_watchdog_timeout": 0})
    assert pwd.comm_task_manager._timeout() == 0.0


def test_check_nan_inf_flag(restore_flags):
    import numpy as np
    from paddle_tpu_torch.core import place
    prev = place._state["place"]
    pp.set_device("cpu")
    try:
        pp.set_flags({"check_nan_inf": True})
        x = pp.to_tensor(np.array([0.0, 1.0], np.float32))
        with pytest.raises(FloatingPointError, match="'log'"):
            pp.log(x)
    finally:
        place._state["place"] = prev


def test_use_pallas_kernels_routes_nothing(restore_flags, monkeypatch):
    """The port has no lowering probe for the flag to stand in for: with
    it off, a shape the kernels take still goes to the flash route and to
    the fused-norm wrapper (the kernels on the card, their plain versions
    on these CPU tensors), never to the compositions."""
    import numpy as np
    from paddle_tpu_torch.core import dispatch, place
    from paddle_tpu_torch.incubate.nn.functional import fused_rms_norm
    from paddle_tpu_torch.ops import fused_norms
    rng = np.random.RandomState(0)
    q, k, v = (rng.randn(1, 128, 2, 64).astype(np.float32)
               for _ in range(3))
    x = rng.randn(8, 128).astype(np.float32)
    w = rng.rand(128).astype(np.float32)
    calls, ops = [], []
    real = fused_norms.rms_norm
    monkeypatch.setattr(fused_norms, "rms_norm",
                        lambda *a: calls.append(1) or real(*a))
    prev, prev_obs = place._state["place"], dispatch.get_op_observer()
    pp.set_device("cpu")
    dispatch.set_op_observer(lambda name, t0, dt: ops.append(name))
    try:
        outs = {}
        for on in (True, False):
            pp.set_flags({"use_pallas_kernels": on})
            a = pp.nn.functional.scaled_dot_product_attention(
                *(pp.to_tensor(t) for t in (q, k, v)), is_causal=True)
            n = fused_rms_norm(pp.to_tensor(x), pp.to_tensor(w))[0]
            outs[on] = (a.numpy(), n.numpy())
    finally:
        dispatch.set_op_observer(prev_obs)
        place._state["place"] = prev
    assert ops.count("flash_attention") == 2 and "sdpa" not in ops
    assert len(calls) == 2
    for got, ref in zip(outs[False], outs[True]):
        np.testing.assert_array_equal(got, ref)
