"""Every kernel-driven op of the port's registry (ops/kernels.py through
the generated wrappers) against the JAX package's, case for case as in
tests/test_op_sweep.py: one call on numpy inputs from a seed, forward and
gradient of sum(out * cotangent) at f32.  Tolerances are stated per case
in tests/_torch_sweep_cases.py: rtol 1e-5 / atol 1e-6 by default, 1e-4
/ 1e-4 for transcendental and reducing ops (XLA and ATen round them an
ulp apart), 1e-3 / 1e-4 for factorizations; integer and boolean outputs
exactly.  Results that are not unique (SVD and QR signs, eigenvectors,
LU on ties) are held through invariants: reconstructions and sorted
eigenvalues.  test_every_spec_has_a_case keeps the table whole, and
test_every_differentiable_case_checks_its_gradient keeps a case from
leaving its gradient unchecked without a stated reason."""
import numpy as np
import paddle_tpu_torch as pp
import pytest

from _torch_eager import eager_state  # noqa: F401
from _torch_sweep import REG, S, cases, hold
from _torch_threads import torch_threads  # noqa: F401


@pytest.mark.parametrize("name", cases("kernels"))
def test_kernel_op_matches_the_jax_package(name):
    hold(name)


def test_every_spec_has_a_case():
    names = set(REG)
    covered = set(S.CASES) | set(S.RANDOM) | set(S.SKIPS)
    assert sorted(names - covered) == []
    assert sorted(covered - names) == []
    assert len(names) == 433
    assert all(reason for reason in S.SKIPS.values())


def _floats(a):
    if isinstance(a, list):
        return any(_floats(e) for e in a)
    return isinstance(a, np.ndarray) and a.dtype.kind == "f"


def test_every_differentiable_case_checks_its_gradient():
    """A case that takes a float input and gives a float output checks its
    gradient, or names in NO_GRAD why it cannot (not unique, not
    differentiable, a write into its input leaf)."""
    assert all(isinstance(why, str) and why for why in S.NO_GRAD.values())
    assert all(not S.CASES[n].grad for n in S.NO_GRAD)
    unchecked = []
    for name in sorted(S.CASES):
        c = S.CASES[name]
        if c.grad or name in S.NO_GRAD:
            continue
        args, kwargs = S.inputs(name)
        if not any(_floats(a) for a in list(args) + list(kwargs.values())):
            continue
        got = S.run(pp, name)
        if any(d in ("float32", "float64") for d in got.dtypes):
            unchecked.append(name)
    assert unchecked == []
