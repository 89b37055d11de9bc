"""Shared by the op-sweep parity tests (tests/test_torch_op_sweep.py,
_ops_linalg, _ops_random, _ops_modules): the cases of
``tests/_torch_sweep_cases.py`` split by the op's home module, and
``hold(name)``, which runs one case through the JAX package and through
the port on the CPU and fails on any difference beyond the case's stated
tolerance (forward and gradient; integers and booleans exactly)."""
import paddle_tpu as jp
import paddle_tpu_torch as pp
import _torch_sweep_cases as S

REG = S.registry(pp)


def home(name):
    spec = REG[name]
    return "kernels" if spec.kernel else spec.module.rsplit(".", 1)[1]


def cases(*homes, exclude=False):
    """The case names whose op lives in one of homes (in none of them,
    with exclude)."""
    return sorted(n for n in S.CASES if (home(n) in homes) != exclude)


def hold(name):
    ref = S.run(jp, name)
    got = S.run(pp, name)
    bad = S.compare(name, ref, got)
    assert not bad, (name, bad)
    return ref, got
