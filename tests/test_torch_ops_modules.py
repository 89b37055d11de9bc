"""The hand-written op modules of the port (ops/manipulation, creation,
math, logic, misc, array, inplace_aliases, indexing, and the nn
functionals the registry holds) against the JAX package's, case for case
as in tests/test_op_sweep.py and tests/test_misc_ops.py: one call on
numpy inputs from a seed, forward and gradient, tolerances stated per
case in tests/_torch_sweep_cases.py (rtol 1e-5 / atol 1e-6 by default,
1e-4 / 1e-4 for transcendental and reducing ops); integer and boolean
outputs exactly.  In-place ops are held by their result and by their
input's values after the call."""
import pytest

from _torch_eager import eager_state  # noqa: F401
from _torch_sweep import cases, hold
from _torch_threads import torch_threads  # noqa: F401


@pytest.mark.parametrize("name", cases("kernels", "linalg", "random",
                                       exclude=True))
def test_module_op_matches_the_jax_package(name):
    hold(name)
