"""Linear-algebra ops (counterpart of paddle_tpu/ops/linalg.py): the
norms, least squares, LU, the general eigenproblem, rank, Householder
products, the low-rank SVDs and the condition number, beside the
kernel-driven ones the generator writes (re-exported here).

Conventions are the JAX package's: ``lu`` returns LAPACK's 1-based int32
pivots (and a zero info with ``get_infos``), ``eig`` / ``eigvals`` give
complex results in LAPACK's order, ``lstsq`` returns the solution, the
residuals' squared norms, the rank and the singular values whatever the
driver.  ``svd_lowrank`` draws its test matrix from the generator of its
input's device (``core.random_state``), so its draws are not the JAX
package's; ``pca_lowrank`` draws nothing (an exact SVD, as there)."""
from __future__ import annotations

import builtins
import math

import torch

from ..core import dispatch as D
from ..core import random_state
from ..core.tensor import Tensor
from .generated.op_wrappers import (  # noqa: F401
    cdist, cholesky, cholesky_inverse, cholesky_solve, corrcoef, cov, cross,
    det, dist, eigh, eigvalsh, inv, matrix_exp, matrix_power, multi_dot,
    pinv, qr, slogdet, solve, svd, svdvals, tensordot, triangular_solve,
)

__all__ = [
    "norm", "vector_norm", "matrix_norm", "p_norm", "cholesky",
    "cholesky_solve", "qr", "svd", "svdvals", "inv", "solve", "lstsq", "lu",
    "lu_unpack", "eig", "eigh", "eigvals", "eigvalsh", "matrix_power",
    "matrix_rank", "pinv", "det", "slogdet", "triangular_solve", "cross",
    "cov", "corrcoef", "householder_product", "matrix_exp", "cdist", "dist",
    "multi_dot", "tensordot", "pca_lowrank", "cond", "cholesky_inverse",
    "ormqr", "svd_lowrank",
]


def _norm(a, p, axis, keepdim):
    if p is None:
        p = "fro" if (axis is None or isinstance(axis, tuple)) \
            and a.dim() >= 2 else 2
    if axis is None:
        if p == "fro":
            return torch.sqrt(torch.sum(torch.square(torch.abs(a))))
        if p == math.inf:
            return torch.amax(torch.abs(a))
        if p == -math.inf:
            return torch.amin(torch.abs(a))
        return torch.sum(torch.abs(a) ** p) ** (1.0 / p)
    if isinstance(axis, tuple):
        return torch.linalg.norm(a, ord=p, dim=axis, keepdim=keepdim)
    if p == "fro":
        p = 2
    if p == math.inf:
        return torch.amax(torch.abs(a), dim=axis, keepdim=keepdim)
    if p == -math.inf:
        return torch.amin(torch.abs(a), dim=axis, keepdim=keepdim)
    if p == 0:
        return torch.sum((a != 0).to(a.dtype), dim=axis, keepdim=keepdim)
    return torch.sum(torch.abs(a) ** p, dim=axis, keepdim=keepdim) \
        ** (1.0 / p)


def norm(x, p=None, axis=None, keepdim=False, name=None):
    if isinstance(p, str) and p not in ("fro", "nuc"):
        raise ValueError(f"unsupported norm order {p}")
    ax = tuple(int(a) for a in axis) if isinstance(axis, (list, tuple)) \
        else (None if axis is None else int(axis))
    pv = p if (p is None or isinstance(p, str)) else float(p)
    return D.apply("p_norm", _norm, (x,),
                   {"p": pv, "axis": ax, "keepdim": bool(keepdim)})


p_norm = norm


def vector_norm(x, p=2.0, axis=None, keepdim=False, name=None):
    return norm(x, p, axis, keepdim)


def _matrix_norm(a, p, axis, keepdim):
    return torch.linalg.matrix_norm(a, ord=p, dim=axis, keepdim=keepdim)


def matrix_norm(x, p="fro", axis=(-2, -1), keepdim=False, name=None):
    return D.apply("matrix_norm", _matrix_norm, (x,),
                   {"p": p, "axis": tuple(axis), "keepdim": bool(keepdim)})


def _lstsq(a, b, rcond):
    vec = b.dim() == 1
    if vec:
        b = b[:, None]
    m, n = a.shape
    eps = torch.finfo(a.dtype).eps
    rc = eps * builtins.max(n, m) if rcond is None \
        else (eps if rcond < 0 else rcond)
    u, s, vt = torch.linalg.svd(a, full_matrices=False)
    mask = (s > 0) & (s >= rc * s[0])
    rank = mask.sum()
    safe_s = torch.where(mask, s, torch.ones_like(s))
    s_inv = torch.where(mask, 1 / safe_s, torch.zeros_like(s))[:, None]
    x = vt.mT.conj() @ (s_inv * (u.mT.conj() @ b))
    resid = torch.linalg.vector_norm(b - a @ x, dim=0) ** 2
    return (x.reshape(-1) if vec else x), resid, rank, s


def lstsq(x, y, rcond=None, driver=None, name=None):
    return D.apply("lstsq", _lstsq, (x, y), {"rcond": rcond})


def _lu(a):
    lu_mat, piv = torch.linalg.lu_factor(a)
    return lu_mat, piv.to(torch.int32)


def lu(x, pivot=True, get_infos=False, name=None):
    out = D.apply("lu", _lu, (x,))
    if get_infos:
        return out[0], out[1], Tensor(torch.zeros(
            (), dtype=torch.int32, device=x._data.device))
    return out


def _lu_unpack(lu_mat, piv):
    P, L, U = torch.lu_unpack(lu_mat, piv.to(torch.int32))
    return P, L, U


def lu_unpack(x, y, unpack_ludata=True, unpack_pivots=True, name=None):
    return D.apply("lu_unpack", _lu_unpack, (x, y))


def _eig(a):
    return tuple(torch.linalg.eig(a))


def eig(x, name=None):
    return D.apply("eig", _eig, (x,))


def _eigvals(a):
    return torch.linalg.eigvals(a)


def eigvals(x, name=None):
    return D.apply("eigvals", _eigvals, (x,))


def _matrix_rank(a, tol, hermitian):
    sv = torch.abs(torch.linalg.eigvalsh(a)) if hermitian \
        else torch.linalg.svdvals(a)
    t = tol if tol is not None else (
        torch.amax(sv, dim=-1, keepdim=True)
        * builtins.max(a.shape[-2], a.shape[-1]) * torch.finfo(a.dtype).eps)
    return torch.sum(sv > t, dim=-1, dtype=torch.int64)


def matrix_rank(x, tol=None, hermitian=False, name=None):
    tv = tol.item() if isinstance(tol, Tensor) else tol
    return D.apply("matrix_rank", _matrix_rank, (x,),
                   {"tol": tv, "hermitian": bool(hermitian)})


def _householder_product(a, tau):
    m, n = a.shape[-2], a.shape[-1]
    eye = torch.eye(m, dtype=a.dtype, device=a.device)
    out = eye
    for i in range(n):
        v = torch.cat([torch.zeros(i, dtype=a.dtype, device=a.device),
                       torch.ones(1, dtype=a.dtype, device=a.device),
                       a[i + 1:, i]])
        out = out @ (eye - tau[i] * torch.outer(v, v))
    return out[:, :n]


def householder_product(x, tau, name=None):
    return D.apply("householder_product", _householder_product, (x, tau))


def _pca_lowrank(a, q, center):
    if center:
        a = a - torch.mean(a, dim=-2, keepdim=True)
    u, s, vt = torch.linalg.svd(a, full_matrices=False)
    return u[..., :q], s[..., :q], vt.mT[..., :q]


def pca_lowrank(x, q=None, center=True, niter=2, name=None):
    qv = q if q is not None else builtins.min(x.shape[-2:])
    return D.apply("pca_lowrank", _pca_lowrank, (x,),
                   {"q": int(qv), "center": bool(center)})


def _cond(a, p):
    af = a.to(torch.float32)
    if p is None or p in (2, -2):
        s = torch.linalg.svdvals(af)
        ratio = s[..., 0] / s[..., -1]
        return 1.0 / ratio if p == -2 else ratio
    return torch.linalg.matrix_norm(af, ord=p) * \
        torch.linalg.matrix_norm(torch.linalg.inv(af), ord=p)


def cond(x, p=None, name=None):
    """Condition number: sigma_max / sigma_min for p None / 2 / -2, else
    norm(x, p) * norm(inv(x), p)."""
    pk = p if p is None or isinstance(p, str) else float(p)
    if isinstance(pk, float) and pk in (2.0, -2.0):
        pk = int(pk)
    return D.apply("cond", _cond, (x,), {"p": pk})


def _ormqr(a, tau, y, left, transpose):
    if a.dim() != 2:
        raise ValueError(
            f"ormqr: batched inputs are not supported (got x rank "
            f"{a.dim()}); vmap over the batch dim")
    af, tf, yf = (t.to(torch.float32) for t in (a, tau, y))
    m, k = af.shape[-2], af.shape[-1]
    eye = torch.eye(m, dtype=torch.float32, device=a.device)
    rows = torch.arange(m, device=a.device)
    Q = eye
    for i in range(k):
        v = torch.where(rows < i, torch.zeros_like(af[:, i]), af[:, i])
        v = torch.where(rows == i, torch.ones_like(v), v)
        Q = Q @ (eye - tf[..., i] * torch.outer(v, v))
    if transpose:
        Q = Q.T
    return (Q @ yf) if left else (yf @ Q)


def ormqr(x, tau, other, left=True, transpose=False, name=None):
    """``other`` times the Q of a Householder QR given as (x, tau)."""
    return D.apply("ormqr", _ormqr, (x, tau, other),
                   {"left": bool(left), "transpose": bool(transpose)})


def _svd_lowrank(a, *m, q, niter, gen):
    af = a.to(torch.float32)
    if m:
        af = af - m[0].to(torch.float32)
    n = af.shape[-1]
    omega = torch.randn((n, q), dtype=torch.float32, device=a.device,
                        generator=gen)
    Q, _ = torch.linalg.qr(af @ omega)
    for _ in range(niter):
        Q, _ = torch.linalg.qr(af.T @ Q)
        Q, _ = torch.linalg.qr(af @ Q)
    u_b, s, vT = torch.linalg.svd(Q.T @ af, full_matrices=False)
    return Q @ u_b, s, vT.T


def svd_lowrank(x, q=6, niter=2, M=None, name=None):
    """Randomized low-rank SVD (Halko et al. subspace iteration)."""
    args = (x,) if M is None else (x, M)
    return D.apply("svd_lowrank", _svd_lowrank, args,
                   {"q": int(q), "niter": int(niter),
                    "gen": random_state.generator(x._data.device)})
