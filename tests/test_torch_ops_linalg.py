"""ops/linalg.py of the port against the JAX package's (norms, lstsq,
lu / lu_unpack, eig / eigvals, matrix_rank, householder_product, ormqr,
the low-rank SVDs, cond), as in tests/test_op_sweep.py and
tests/test_misc_ops.py::test_new_linalg_ops.  Inputs are well
conditioned (symmetric or diagonally dominant for the solvers); results
that are not unique are held through invariants: LU through the matrix
its factors and pivots rebuild, eigenpairs through sorted eigenvalues
and the residual ||A V - V W||, low-rank factors through U S V^T of a
rank-2 input and its leading singular values.  Tolerance rtol 1e-3 /
atol 1e-4 for factorizations, 1e-4 / 1e-4 for the norms
(tests/_torch_sweep_cases.py).  svd_lowrank's draw is the port's own
(from the seeded generator of the input's device), so only its
invariants are compared."""
import numpy as np
import pytest

from _torch_eager import eager_state  # noqa: F401
from _torch_sweep import cases, hold
from _torch_threads import torch_threads  # noqa: F401

import paddle_tpu as jp
import paddle_tpu_torch as pp


@pytest.mark.parametrize("name", cases("linalg"))
def test_linalg_op_matches_the_jax_package(name):
    pp.seed(5)
    hold(name)


@pytest.mark.parametrize("upper", [False, True])
def test_cholesky_inverse_and_solve_read_one_triangle(upper):
    """A factor with garbage in its other triangle gives the inverse and
    the solve of the matrix its own triangle makes (tol 1e-4)."""
    rng = np.random.RandomState(3)
    a = rng.randn(4, 4).astype(np.float32)
    spd = a @ a.T + 4 * np.eye(4, dtype=np.float32)
    f = np.linalg.cholesky(spd).astype(np.float32)
    f = f.T if upper else f
    noisy = f + (np.tril(np.ones((4, 4)), -1) if upper
                 else np.triu(np.ones((4, 4)), 1)).astype(np.float32)
    b = rng.randn(4, 2).astype(np.float32)
    for pd in (jp, pp):
        L = pd.ops.linalg
        inv = L.cholesky_inverse(pd.to_tensor(noisy), upper=upper)
        np.testing.assert_allclose(inv.numpy() @ spd, np.eye(4), atol=1e-4)
        sol = L.cholesky_solve(pd.to_tensor(b), pd.to_tensor(noisy),
                               upper=upper)
        np.testing.assert_allclose(spd @ sol.numpy(), b, atol=1e-4)


def test_lu_pivots_are_lapacks_one_based_int32():
    a = np.array([[1., 2., 0.], [4., 1., 1.], [2., 5., 3.]], np.float32)
    outs = []
    for pd in (jp, pp):
        lu_m, piv, info = pd.ops.linalg.lu(pd.to_tensor(a), get_infos=True)
        outs.append((lu_m.numpy(), piv.numpy(), info.numpy()))
        assert piv.dtype.name == "int32" and info.dtype.name == "int32"
    np.testing.assert_allclose(outs[1][0], outs[0][0], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(outs[1][1], outs[0][1])
    np.testing.assert_array_equal(outs[1][2], outs[0][2])


def test_svd_lowrank_draws_from_the_seeded_generator():
    m = np.random.RandomState(2)
    x = (m.rand(10, 2) @ m.rand(2, 8)).astype(np.float32)
    draws = []
    for _ in range(2):
        pp.seed(11)
        u, s, v = pp.ops.linalg.svd_lowrank(pp.to_tensor(x), q=4)
        draws.append(u.numpy())
        recon = u.numpy() @ np.diag(s.numpy()) @ v.numpy().T
        np.testing.assert_allclose(recon, x, atol=1e-4)
    np.testing.assert_array_equal(draws[0], draws[1])
