"""The op sweep's case table: every op of the port's generated registry
(``paddle_tpu_torch/ops/generated/op_registry.py``) with one call on
inputs made from a seed, or a property check for the ops that draw.

One table serves two holders.  The CPU parity tests
(``tests/test_torch_op_sweep.py`` and its neighbours) run each case
through the JAX package and through the port, forward and gradient, and
compare; ``chip_smoke.py``'s ``ops_sweep`` phase runs each case through
the port on the card and on the CPU.  Nothing here imports JAX: the
package under test is an argument (``pd``), and ops are resolved through
its own registry.

A case is ``make(r) -> (args, kwargs)`` over numpy inputs from ``r`` (a
``RandomState`` seeded by the op's name, so a case's inputs do not depend
on which others run).  numpy arrays become Tensors, lists of arrays lists
of Tensors; other arguments pass as they are.  Outputs are flattened to
numpy; floats compare within the case's tolerance, integers and booleans
exactly.  ``canon`` maps a result that is not unique (eigenvectors, QR
and SVD signs, LU on ties, low-rank factors) to invariants of it
(reconstructions, sorted eigenvalues) before the comparison.  The
gradient is of ``sum(out * cotangent)`` over the float outputs, with a
fixed cotangent, taken with respect to every float input.

``RANDOM`` holds the ops that draw.  Their draws come from
``core.random_state`` (the port) and are not the JAX package's, so they
are held to properties only: shape, dtype and device, support, the same
draw from the same seed and another from another seed, and moments
within 6 sigma of the sample size.
"""
from __future__ import annotations

import importlib
import math
import zlib

import numpy as np

__all__ = ["CASES", "RANDOM", "SKIPS", "NO_GRAD", "Case", "inputs", "run",
           "compare", "check_random", "registry", "cotangents"]


class Case:
    __slots__ = ("make", "grad", "tol", "gtol", "canon", "call", "vjp")

    def __init__(self, make, grad=True, tol=(1e-5, 1e-6), gtol=None,
                 canon=None, call=None, vjp=None):
        self.make, self.grad, self.tol = make, grad, tol
        self.gtol, self.canon, self.call = gtol or tol, canon, call
        self.vjp = vjp


CASES: dict = {}
RANDOM: dict = {}
SKIPS: dict = {}
# the cases that take a float input and give a float output but check no
# gradient, each with its reason (not unique, not differentiable, or a
# write into the input leaf); test_torch_op_sweep.py holds every other
# such case to its gradient
NO_GRAD: dict = {}

LOOSE = (1e-4, 1e-4)
LINALG = (1e-3, 1e-4)


def case(name, make, nograd=None, **kw):
    """Register a case; ``nograd`` (a reason) turns its gradient off.
    ``vjp(ins, cts) -> grads`` gives the reference gradient in numpy for
    an op whose JAX twin leaves its tape (no gradient to compare)."""
    if nograd is not None:
        NO_GRAD[name] = nograd
        kw["grad"] = False
    CASES[name] = Case(make, **kw)


class _R:
    """Input makers over one RandomState (values kept off kinks)."""

    def __init__(self, seed):
        self.s = np.random.RandomState(seed)

    def f(self, *s):
        a = self.s.randn(*s).astype(np.float32)
        return a + np.sign(a).astype(np.float32) * np.float32(0.15)

    def pos(self, *s):
        return (np.abs(self.s.randn(*s)) + 0.5).astype(np.float32)

    def unit(self, *s):
        return np.clip(self.s.rand(*s), 0.05, 0.95).astype(np.float32)

    def ints(self, hi, *s):
        return self.s.randint(0, hi, s).astype(np.int64)

    def perm(self, *s):
        """Distinct values: sort orders are unique."""
        n = int(np.prod(s))
        return ((self.s.permutation(n).astype(np.float32) - n / 2) / n) \
            .reshape(s)

    def boolean(self, *s):
        return self.s.rand(*s) > 0.5

    def spd(self, n):
        """Symmetric, diagonally dominant: well conditioned."""
        a = self.s.randn(n, n).astype(np.float32)
        return a @ a.T + n * np.eye(n, dtype=np.float32)

    def dd(self, n, m=None):
        """Diagonally dominant, not symmetric."""
        a = self.s.randn(n, n if m is None else m).astype(np.float32)
        return a + 2 * n * np.eye(n, a.shape[1], dtype=np.float32)

    def cplx(self, *s):
        return (self.s.randn(*s) + 1j * self.s.randn(*s)).astype(
            np.complex64)

    def lowrank(self, n, m, k):
        return (self.s.randn(n, k) @ self.s.randn(k, m)).astype(np.float32)


def inputs(name):
    return CASES[name].make(_R(zlib.crc32(name.encode())))


def registry(pd):
    return importlib.import_module(
        pd.__name__ + ".ops.generated.op_registry").OP_REGISTRY


def _op(pd, name):
    return registry(pd)[name].resolve()


def _un(name, **kw):
    case(name, lambda r: ((r.f(3, 4),), {}), **kw)


# -- unary elementwise ------------------------------------------------------
for _n in ("abs neg exp expm1 square sin cos tanh erf sinh cosh asinh atan "
           "sigmoid silu swish log_sigmoid softsign mish tanhshrink relu "
           "selu celu elu hardswish softshrink hardshrink hardtanh "
           "hardsigmoid positive sinc deg2rad rad2deg frac trunc").split():
    _un(_n, tol=LOOSE)
for _n in "floor ceil round sign sgn signbit".split():
    _un(_n)
case("tan", lambda r: ((r.f(3, 4) * 0.4,), {}), tol=LOOSE)
case("asin", lambda r: ((r.unit(3, 4) * 0.9,), {}), tol=LOOSE)
case("acos", lambda r: ((r.unit(3, 4) * 0.9,), {}), tol=LOOSE)
case("atanh", lambda r: ((r.unit(3, 4) * 0.9,), {}), tol=LOOSE)
case("acosh", lambda r: ((r.pos(3, 4) + 1.0,), {}), tol=LOOSE)
case("erfinv", lambda r: ((r.unit(3, 4) * 0.8,), {}), tol=LOOSE)
for _n in ("log log2 log10 log1p sqrt rsqrt reciprocal digamma lgamma "
           "gammaln").split():
    case(_n, lambda r: ((r.pos(3, 4),), {}), tol=LOOSE)
for _n in "i0 i1 i0e i1e".split():
    case(_n, lambda r: ((r.f(3, 4),), {}), tol=LOOSE)
case("polygamma", lambda r: ((r.pos(3, 4),), {"n": 1}), tol=LOOSE)
case("logit", lambda r: ((r.unit(3, 4),), {"eps": 1e-6}), tol=LOOSE)
case("stanh", lambda r: ((r.f(3, 4),), {"scale_a": 0.5, "scale_b": 1.5}),
     tol=LOOSE)
case("relu6", lambda r: ((r.f(3, 4) * 4,), {}))
case("gelu", lambda r: ((r.f(3, 4),), {"approximate": True}), tol=LOOSE)
case("leaky_relu", lambda r: ((r.f(3, 4),), {"negative_slope": 0.1}))
case("softplus", lambda r: ((r.f(3, 4) * 4,), {"beta": 2.0,
                                                "threshold": 5.0}),
     tol=LOOSE)
case("thresholded_relu", lambda r: ((r.f(3, 4),), {"threshold": 0.5}))
case("scale", lambda r: ((r.f(3, 4),), {"scale": 2.0, "bias": 1.0}))
case("clip", lambda r: ((r.f(3, 4),), {"min": -0.5, "max": 0.5}))
case("cast", lambda r: ((r.f(3, 4),), {"dtype": "float64"}))
case("nan_to_num", lambda r: ((np.array([[np.nan, np.inf, -np.inf, 1.5]],
                                        np.float32),), {}))
for _n in "isnan isinf isfinite isposinf isneginf".split():
    case(_n, lambda r: ((np.array([[1.0, np.inf, -np.inf, np.nan]],
                                  np.float32),), {}), grad=False)
case("isreal", lambda r: ((r.cplx(3, 4),), {}), grad=False)
for _n in "angle real imag conj".split():
    case(_n, lambda r: ((r.cplx(3, 4),), {}), grad=False)
case("logical_not", lambda r: ((r.boolean(3, 4),), {}), grad=False)
for _n in "bitwise_not bitwise_invert".split():
    case(_n, lambda r: ((r.ints(16, 3, 4),), {}), grad=False)

# -- binary elementwise -----------------------------------------------------
for _n in ("add subtract multiply maximum minimum fmax fmin atan2 hypot "
           "logaddexp").split():
    case(_n, lambda r: ((r.f(3, 4), r.f(3, 4)), {}), tol=LOOSE)
for _n in "copysign heaviside".split():
    case(_n, lambda r: ((r.f(3, 4), r.f(3, 4)), {}))
case("nextafter", lambda r: ((r.f(3, 4), r.f(3, 4)), {}),
     nograd="not differentiable: the JAX package defines no rule for it")
case("divide", lambda r: ((r.f(3, 4), r.pos(3, 4)), {}))
case("pow", lambda r: ((r.pos(3, 4), r.f(3, 4)), {}), tol=LOOSE)
case("float_power", lambda r: ((r.pos(3, 4), r.pos(3, 4)), {}),
     tol=LOOSE)
for _n in "floor_divide mod remainder".split():
    case(_n, lambda r: ((r.f(3, 4), r.pos(3, 4)), {}))
case("gcd", lambda r: ((r.ints(20, 3, 4), r.ints(20, 3, 4)), {}),
     grad=False)
case("lcm", lambda r: ((r.ints(20, 3, 4) + 1, r.ints(20, 3, 4) + 1), {}),
     grad=False)
case("ldexp", lambda r: ((r.f(3, 4), r.ints(4, 3, 4)), {}))
case("lerp", lambda r: ((r.f(3, 4), r.f(3, 4), r.unit(3, 4)), {}))
case("bitwise_left_shift", lambda r: ((r.ints(8, 3, 4), r.ints(4, 3, 4)),
                                      {}), grad=False)
case("bitwise_right_shift", lambda r: ((r.ints(64, 3, 4),
                                        r.ints(4, 3, 4)), {}), grad=False)
for _n in "bitwise_and bitwise_or bitwise_xor".split():
    case(_n, lambda r: ((r.ints(16, 3, 4), r.ints(16, 3, 4)), {}),
         grad=False)
for _n in ("equal not_equal less_than less_equal greater_than "
           "greater_equal").split():
    case(_n, lambda r: ((r.ints(3, 3, 4), r.ints(3, 3, 4)), {}),
         grad=False)
for _n in "logical_and logical_or logical_xor".split():
    case(_n, lambda r: ((r.boolean(3, 4), r.boolean(3, 4)), {}), grad=False)
case("isclose", lambda r: ((r.f(3, 4), r.f(3, 4)), {}), grad=False)
case("allclose", lambda r: ((r.f(3, 4), r.f(3, 4)), {}), grad=False)
case("equal_all", lambda r: ((r.ints(2, 3, 4), r.ints(2, 3, 4)), {}),
     grad=False)

# -- reductions and scans ---------------------------------------------------
case("sum", lambda r: ((r.f(3, 4),), {"axis": 1}))
case("mean", lambda r: ((r.f(3, 4),), {"axis": 0}))
case("max", lambda r: ((r.perm(3, 4),), {"axis": 1}))
case("min", lambda r: ((r.perm(3, 4),), {"axis": 1}))
case("amax", lambda r: ((r.perm(3, 4),), {"axis": [0, 1]}))
case("amin", lambda r: ((r.perm(3, 4),), {"axis": -1, "keepdim": True}))
case("prod", lambda r: ((r.pos(3, 4),), {"axis": 1}), tol=LOOSE)
case("std", lambda r: ((r.f(3, 4),), {"axis": 1}), tol=LOOSE)
case("var", lambda r: ((r.f(3, 4),), {"axis": 1}), tol=LOOSE)
case("logsumexp", lambda r: ((r.f(3, 4),), {"axis": 1}), tol=LOOSE)
case("nansum", lambda r: ((np.where(r.boolean(3, 4), np.nan, r.f(3, 4))
                           .astype(np.float32),), {"axis": 1}))
case("nanmean", lambda r: ((np.where(r.boolean(3, 4), np.nan, r.f(3, 4))
                            .astype(np.float32),), {"axis": 0}))
case("argmax", lambda r: ((r.perm(3, 4),), {"axis": 1}), grad=False)
case("argmin", lambda r: ((r.perm(3, 4),), {}), grad=False)
case("all", lambda r: ((r.boolean(3, 4),), {"axis": 1}), grad=False)
case("any", lambda r: ((r.boolean(3, 4),), {"axis": 0}), grad=False)
case("count_nonzero", lambda r: (((r.boolean(3, 4) * 1.0)
                                  .astype(np.float32),), {"axis": 1}),
     grad=False)
case("numel", lambda r: ((r.f(3, 4),), {}), grad=False)
case("mean_all", lambda r: ((r.f(3, 4),), {}))
case("median", lambda r: ((r.perm(3, 6),), {"axis": 1}))
case("nanmedian", lambda r: ((r.perm(3, 5),), {"axis": 1}))
case("quantile", lambda r: ((r.perm(3, 8),), {"q": [0.25, 0.5],
                                              "axis": 1}))
case("nanquantile", lambda r: ((np.where(np.eye(3, 8, dtype=bool), np.nan,
                                         r.perm(3, 8)).astype(np.float32),),
                               {"q": 0.3, "axis": 1}))
case("kthvalue", lambda r: ((r.perm(3, 6),), {"k": 2, "axis": 1}))
case("mode", lambda r: ((r.ints(3, 3, 6).astype(np.float32),),
                        {"axis": 1}),
     nograd="the mode repeats in its row, so the position that takes its "
            "gradient is not unique")
case("cumsum", lambda r: ((r.f(3, 4),), {"axis": 1}))
case("cumprod", lambda r: ((r.pos(3, 4),), {"dim": 1}), tol=LOOSE)
case("cummax", lambda r: ((r.perm(3, 5),), {"axis": 1}))
case("cummin", lambda r: ((r.perm(3, 5),), {"axis": 1}))
case("logcumsumexp", lambda r: ((r.f(3, 4),), {"axis": 1}), tol=LOOSE)
case("diff", lambda r: ((r.f(3, 5),), {"axis": 1,
                                       "prepend": r.f(3, 1)}))
case("trapezoid", lambda r: ((r.f(3, 5),), {"axis": 1}))
case("cumulative_trapezoid", lambda r: ((r.f(3, 5),),
                                        {"x": np.sort(r.f(5)), "axis": 1}))
case("log_normalize", lambda r: ((r.f(3, 4),), {}), tol=LOOSE)
case("reduce_as", lambda r: ((r.f(3, 4), r.f(1, 4)), {}))
case("renorm", lambda r: ((r.f(3, 4),), {"p": 2.0, "axis": 0,
                                         "max_norm": 1.0}), tol=LOOSE)
case("frobenius_norm", lambda r: ((r.f(3, 4),), {"axis": [-2, -1]}),
     tol=LOOSE)
case("squared_l2_norm", lambda r: ((r.f(3, 4),), {}), tol=LOOSE)
case("clip_by_norm", lambda r: ((r.f(3, 4),), {"max_norm": 1.0}),
     tol=LOOSE)
case("histogram", lambda r: ((r.f(20),), {"bins": 5, "min": -2.0,
                                          "max": 2.0}), grad=False)
case("bincount", lambda r: ((r.ints(6, 20),), {}), grad=False)

# -- matmul family ----------------------------------------------------------
case("matmul", lambda r: ((r.f(3, 4), r.f(3, 4)), {"transpose_y": True}),
     tol=LOOSE)
case("mm", lambda r: ((r.f(3, 4), r.f(4, 5)), {}), tol=LOOSE)
case("bmm", lambda r: ((r.f(2, 3, 4), r.f(2, 4, 5)), {}), tol=LOOSE)
case("dot", lambda r: ((r.f(5), r.f(5)), {}), tol=LOOSE)
case("inner", lambda r: ((r.f(3, 4), r.f(2, 4)), {}), tol=LOOSE)
case("outer", lambda r: ((r.f(3), r.f(4)), {}), tol=LOOSE)
case("mv", lambda r: ((r.f(3, 4), r.f(4)), {}), tol=LOOSE)
case("addmm", lambda r: ((r.f(3, 5), r.f(3, 4), r.f(4, 5)),
                         {"beta": 0.5, "alpha": 2.0}), tol=LOOSE)
case("kron", lambda r: ((r.f(2, 3), r.f(3, 2)), {}), tol=LOOSE)
case("tensordot", lambda r: ((r.f(3, 4, 5), r.f(4, 5, 6)), {"axes": 2}),
     tol=LOOSE)
case("multi_dot", lambda r: (([r.f(3, 4), r.f(4, 5), r.f(5, 2)],), {}),
     tol=LOOSE)
case("vecdot", lambda r: ((r.f(3, 4), r.f(3, 4)), {}), tol=LOOSE)
case("einsum", lambda r: (("ij,jk->ik", r.f(3, 4), r.f(4, 5)), {}),
     tol=LOOSE)
case("add_n", lambda r: (([r.f(2, 3), r.f(2, 3), r.f(2, 3)],), {}))
case("trace", lambda r: ((r.f(4, 4),), {"offset": 1}))
case("diagonal", lambda r: ((r.f(3, 4, 2),), {"axis1": 0, "axis2": 1}))
case("vander", lambda r: ((r.f(4),), {"n": 3}), tol=LOOSE)

# -- shape and indexing -----------------------------------------------------
case("reshape", lambda r: ((r.f(3, 4),), {"shape": [4, 3]}))
case("transpose", lambda r: ((r.f(3, 4, 5),), {"perm": [2, 0, 1]}))
case("moveaxis", lambda r: ((r.f(2, 3, 4),), {"source": 0,
                                              "destination": 2}))
case("swapaxes", lambda r: ((r.f(2, 3, 4),), {"axis1": 0, "axis2": 2}))
case("matrix_transpose", lambda r: ((r.f(2, 3, 4),), {}))
case("t", lambda r: ((r.f(3, 4),), {}))
case("squeeze", lambda r: ((r.f(3, 1, 4),), {"axis": 1}))
case("unsqueeze", lambda r: ((r.f(3, 4),), {"axis": [0, 2]}))
case("flatten", lambda r: ((r.f(2, 3, 4),), {"start_axis": 1}))
case("unflatten", lambda r: ((r.f(3, 8),), {"axis": 1, "shape": [2, 4]}))
case("flip", lambda r: ((r.f(3, 4),), {"axis": [1]}))
case("fliplr", lambda r: ((r.f(3, 4),), {}))
case("flipud", lambda r: ((r.f(3, 4),), {}))
case("reverse", lambda r: ((r.f(3, 4),), {"axis": [0, 1]}))
case("roll", lambda r: ((r.f(3, 4),), {"shifts": 2, "axis": 1}))
case("rot90", lambda r: ((r.f(3, 4),), {"k": 1}))
case("broadcast_to", lambda r: ((r.f(1, 4),), {"shape": [3, 4]}))
case("expand", lambda r: ((r.f(1, 4),), {"shape": [3, -1]}))
case("expand_as", lambda r: ((r.f(1, 4), r.f(3, 4)), {}))
case("tile", lambda r: ((r.f(2, 3),), {"repeat_times": [2, 2]}))
case("repeat_interleave", lambda r: ((r.f(2, 3),), {"repeats": 2,
                                                    "axis": 1}))
case("concat", lambda r: (([r.f(2, 3), r.f(2, 3)],), {"axis": 1}))
case("stack", lambda r: (([r.f(2, 3), r.f(2, 3)],), {"axis": 0}))
for _n in "hstack vstack dstack".split():
    case(_n, lambda r: (([r.f(2, 3), r.f(2, 3)],), {}))
case("split", lambda r: ((r.f(6, 4),), {"num_or_sections": [2, -1, 3],
                                        "axis": 0}))
case("chunk", lambda r: ((r.f(6, 4),), {"chunks": 3, "axis": 0}))
case("tensor_split", lambda r: ((r.f(7, 4),), {"num_or_indices": 3}))
case("hsplit", lambda r: ((r.f(4, 6),), {"num_or_indices": 2}))
case("vsplit", lambda r: ((r.f(6, 4),), {"num_or_indices": [1, 4]}))
case("dsplit", lambda r: ((r.f(2, 3, 4),), {"num_or_indices": 2}))
case("unbind", lambda r: ((r.f(3, 4),), {"axis": 1}))
case("unstack", lambda r: ((r.f(3, 4),), {"axis": 0}))
case("atleast_1d", lambda r: ((np.array(2.5, np.float32),), {}))
case("atleast_2d", lambda r: ((r.f(3),), {}))
case("atleast_3d", lambda r: ((r.f(3, 4),), {}))
case("broadcast_tensors", lambda r: (([r.f(3, 1), r.f(1, 4)],), {}))
case("view", lambda r: ((r.f(3, 4),), {"shape_or_dtype": [4, 3]}))
case("view_as", lambda r: ((r.f(3, 4), r.f(4, 3)), {}))
case("as_complex", lambda r: ((r.f(3, 4, 2),), {}), grad=False)
case("as_real", lambda r: ((r.cplx(3, 4),), {}), grad=False)
case("gather", lambda r: ((r.f(5, 4), r.ints(5, 3)), {"axis": 0}))
case("index_select", lambda r: ((r.f(3, 4), r.ints(4, 5)), {"axis": 1}))
case("gather_nd", lambda r: ((r.f(4, 5), r.ints(4, 3, 1)), {}))
case("take_along_axis", lambda r: ((r.f(3, 5), r.ints(5, 3, 2)),
                                   {"axis": 1}))
case("put_along_axis", lambda r: ((r.f(3, 5), np.stack(
    [r.s.permutation(5)[:2] for _ in range(3)]).astype(np.int64),
    r.f(3, 2)), {"axis": 1}))
case("index_sample", lambda r: ((r.f(3, 5), r.ints(5, 3, 2)), {}))
case("index_add", lambda r: ((r.f(5, 4), r.ints(5, 3), 0, r.f(3, 4)),
                             {}), tol=LOOSE)
case("index_fill", lambda r: ((r.f(5, 4), r.ints(5, 3)),
                              {"axis": 0, "value": -1.0}))
case("index_put", lambda r: ((r.f(3, 4), [r.s.permutation(3)[:2]
                                          .astype(np.int64)], r.f(2, 4)),
                             {}))
case("masked_fill", lambda r: ((r.f(3, 4), r.boolean(3, 4)),
                               {"value": -2.0}))
case("masked_scatter", lambda r: ((r.f(3, 4), r.boolean(3, 4), r.f(12)),
                                  {}))


def _vjp_masked_select(ins, cts):
    g = np.zeros_like(ins[0])
    g[ins[1]] = cts[0]
    return [g]


# the JAX package reads the mask on the host and leaves its tape: the
# port's gradient is held to the scatter of the cotangent
case("masked_select", lambda r: ((r.f(3, 4), r.boolean(3, 4)), {}),
     vjp=_vjp_masked_select)
case("where", lambda r: ((r.boolean(3, 4), r.f(3, 4), r.f(3, 4)), {}))
case("nonzero", lambda r: (((r.boolean(3, 4) * 1.0).astype(np.float32),),
                           {}), grad=False)
case("scatter", lambda r: ((r.f(5, 4), r.s.permutation(5)[:3]
                            .astype(np.int64), r.f(3, 4)), {}))
case("scatter_nd", lambda r: ((r.ints(5, 4, 1), r.f(4, 3)),
                              {"shape": [5, 3]}), tol=LOOSE)
case("scatter_nd_add", lambda r: ((r.f(5, 3), r.ints(5, 4, 1), r.f(4, 3)),
                                  {}), tol=LOOSE)
case("diagonal_scatter", lambda r: ((r.f(4, 4), r.f(3)), {"offset": 1}))
case("select_scatter", lambda r: ((r.f(3, 4), r.f(4)), {"axis": 0,
                                                        "index": 1}))
case("slice_scatter", lambda r: ((r.f(6, 4), r.f(2, 2)),
                                 {"axes": [0, 1], "starts": [1, 0],
                                  "ends": [5, 4], "strides": [2, 2]}))
case("strided_slice", lambda r: ((r.f(6, 6),),
                                 {"axes": [0, 1], "starts": [0, 5],
                                  "ends": [5, 0], "strides": [2, -2]}))
case("slice", lambda r: ((r.f(4, 5),), {"axes": [0, 1], "starts": [1, 0],
                                        "ends": [3, 4]}))
case("crop", lambda r: ((r.f(4, 5),), {"shape": [2, 3],
                                       "offsets": [1, 1]}))
case("pad", lambda r: ((r.f(2, 3, 4),), {"pad": [1, 2]}))
case("sort", lambda r: ((r.perm(3, 5),), {"axis": 1, "descending": True}))
case("argsort", lambda r: ((r.ints(3, 3, 5).astype(np.float32),),
                           {"axis": 1, "descending": True}), grad=False)
case("topk", lambda r: ((r.perm(3, 6),), {"k": 2, "axis": 1}))
case("searchsorted", lambda r: ((np.sort(r.f(8)), r.f(3)), {}),
     grad=False)
case("bucketize", lambda r: ((r.f(3, 4), np.sort(r.f(5))), {"right": True}),
     grad=False)
case("unique", lambda r: ((r.ints(4, 12).astype(np.float32),),
                          {"return_index": True, "return_inverse": True,
                           "return_counts": True}))
case("unique_consecutive", lambda r: ((np.sort(r.ints(4, 12))
                                       .astype(np.float32),),
                                      {"return_inverse": True,
                                       "return_counts": True}))
case("one_hot", lambda r: ((r.ints(5, 6),), {"num_classes": 5}),
     grad=False)
case("shard_index", lambda r: ((r.ints(20, 6, 1),),
                               {"index_num": 20, "nshards": 2,
                                "shard_id": 0}), grad=False)
case("take", lambda r: ((r.f(3, 4), r.ints(12, 5) - 6), {}))
case("combinations", lambda r: ((r.f(5),), {"r": 2}))
case("temporal_shift", lambda r: ((r.f(4, 8, 2, 2),),
                                  {"seg_num": 2, "shift_ratio": 0.25}))
case("as_strided", lambda r: ((r.f(4, 4),), {"shape": [2, 2],
                                             "stride": [4, 1],
                                             "offset": 1}))
case("getitem", lambda r: ((r.f(4, 5), (slice(1, 3), 1)), {}))
case("setitem", lambda r: ((r.f(4, 5), (slice(0, 2),), r.f(2, 5)), {}),
     nograd="the write rebinds x, the input leaf, so no gradient of it is "
            "left")

# -- creation ---------------------------------------------------------------
case("zeros", lambda r: (([3, 4],), {}), grad=False)
case("ones", lambda r: (([3, 4],), {"dtype": "int32"}), grad=False)
case("full", lambda r: (([3, 4], 2.5), {}), grad=False)
case("empty", lambda r: (([2, 3], "float32"), {}), grad=False,
     canon=lambda outs, ins: [np.asarray(o.shape) for o in outs])
case("empty_like", lambda r: ((r.f(4, 5),), {}),
     nograd="its values are undefined; only its shape is compared",
     canon=lambda outs, ins: [np.asarray(o.shape) for o in outs])
case("zeros_like", lambda r: ((r.f(2, 3),), {}))
case("ones_like", lambda r: ((r.f(2, 3),), {}))
case("full_like", lambda r: ((r.f(2, 3), 7.0), {}))
case("arange", lambda r: ((0, 10, 2), {}), grad=False)
case("linspace", lambda r: ((0.0, 1.0, 5), {}), grad=False)
case("logspace", lambda r: ((0.0, 2.0, 3), {}), grad=False, tol=LOOSE)
case("eye", lambda r: ((3, 4), {}), grad=False)
case("tril", lambda r: ((r.f(4, 4),), {"diagonal": -1}))
case("triu", lambda r: ((r.f(4, 4),), {"diagonal": 1}))
case("tril_indices", lambda r: ((4, 3, 1), {}), grad=False)
case("triu_indices", lambda r: ((3, 4, 0), {}), grad=False)
case("diag", lambda r: ((r.f(3),), {"offset": 1, "padding_value": 9}))
case("diagflat", lambda r: ((r.f(2, 2),), {"offset": -1}))
case("diag_embed", lambda r: ((r.f(3, 4),), {"offset": 1}))
# the JAX package's meshgrid leaves its tape: the port's gradient is
# held to the sums of the cotangents over the broadcast axes
case("meshgrid", lambda r: ((r.f(2), r.f(3)), {}),
     vjp=lambda ins, cts: [cts[0].sum(1), cts[1].sum(0)])
case("complex_", lambda r: ((r.f(3, 4), r.f(3, 4)), {}), grad=False)
case("polar", lambda r: ((r.pos(3), r.f(3)), {}), grad=False, tol=LOOSE)
case("assign", lambda r: ((r.f(2, 3),), {}))
case("clone", lambda r: ((r.f(2, 3),), {}))
case("to_tensor", lambda r: ((r.f(2, 2).tolist(),), {}), grad=False)
case("fill_diagonal", lambda r: ((r.f(4, 4),), {"value": 9.0,
                                                "offset": 1}))
case("fill_diagonal_tensor", lambda r: ((r.f(4, 5), r.f(4)), {}))
case("sequence_mask", lambda r: ((r.ints(5, 4) + 1,), {"maxlen": 6}),
     grad=False)
case("shape", lambda r: ((r.f(3, 4),), {}), grad=False)
case("rank", lambda r: ((r.f(2, 3, 4),), {}), grad=False)


def _call_bshape(fn, args, kwargs, pd):
    return fn([2, 1, 4], [3, 1])


case("broadcast_shape", lambda r: ((), {}), grad=False, call=_call_bshape)


def _call_check_shape(fn, args, kwargs, pd):
    ok = fn(args[0], [3, -1])
    try:
        fn(args[0], [4, 4])
    except ValueError:
        return [ok, True]
    return [ok, False]


case("check_shape", lambda r: ((r.f(3, 4),), {}), grad=False,
     call=_call_check_shape)
case("tolist", lambda r: ((np.array([[1.5, 2.0], [3.0, 4.0]],
                                    np.float32),), {}), grad=False)
for _n, _a in (("is_tensor", "f"), ("is_floating_point", "f"),
                ("is_integer", "i"), ("is_complex", "c")):
    case(_n, (lambda a: lambda r: (({"f": r.f(2, 2), "i": r.ints(5, 2, 2),
                                     "c": r.cplx(2, 2)}[a],), {}))(_a),
         grad=False)
case("is_empty", lambda r: ((np.zeros((0, 3), np.float32),), {}),
     grad=False)

# -- in-place ops: the result and the input's storage after the call --------


# An in-place twin's input here is the leaf whose gradient would be read:
# a twin that writes refuses a leaf that requires grad, and one that
# rebinds leaves no gradient of the leaf to read.  Its base op's case
# holds the gradient, and tests/test_torch_tensor_methods.py the gradient
# through a twin applied to an intermediate.
WRITES = "writes into its input, a leaf that requires grad, which refuses"
REBINDS = "rebinds its input, so no gradient of the input leaf is left"


def _inplace(name, make, nograd, **kw):
    def call(fn, args, kwargs, pd):
        return [fn(*args, **kwargs), args[0]]
    case(name, make, call=call, nograd=nograd, **kw)


_inplace("fill_", lambda r: ((r.f(3, 4),), {"value": 2.5}), WRITES)
_inplace("multiply_", lambda r: ((r.f(3, 4), r.f(3, 4)), {}), WRITES)
_inplace("increment", lambda r: ((r.f(3),), {"value": 2.0}), WRITES)
_inplace("flatten_", lambda r: ((r.f(3, 4),), {}), REBINDS)
_inplace("reshape_", lambda r: ((r.f(3, 4),), {"shape": [4, 3]}), REBINDS)
_inplace("squeeze_", lambda r: ((r.f(3, 1, 4),), {"axis": 1}), REBINDS)
_inplace("unsqueeze_", lambda r: ((r.f(3, 4),), {"axis": 1}), REBINDS)
_inplace("t_", lambda r: ((r.f(3, 4),), {}), REBINDS)
_inplace("tanh_", lambda r: ((r.f(3, 4),), {}), WRITES, tol=LOOSE)
_inplace("relu_", lambda r: ((r.f(3, 4),), {}), WRITES)
_inplace("softmax_", lambda r: ((r.f(3, 4),), {}), WRITES, tol=LOOSE)
_inplace("scatter_", lambda r: ((r.f(5, 3), np.array([0, 2], np.int64),
                                 r.f(2, 3)), {}), WRITES)

# -- linalg -----------------------------------------------------------------


def _recon_svd(outs, ins):
    u, s, vh = outs
    return [(u * s[..., None, :]) @ vh, s]


def _recon_lowrank(outs, ins):
    u, s, v = outs
    return [(u * s[..., None, :]) @ np.swapaxes(v, -1, -2), s]


def _recon_qr(outs, ins):
    q, r_ = outs
    return [q @ r_, np.abs(r_)]


def _recon_eigh(outs, ins):
    w, v = outs
    return [w, (v * w[..., None, :]) @ np.swapaxes(v, -1, -2)]


def _pivots(piv, n):
    perm = np.arange(n)
    for i, p in enumerate(np.asarray(piv).reshape(-1) - 1):
        perm[i], perm[p] = perm[p], perm[i]
    return perm


def _recon_lu(outs, ins):
    lu_mat, piv = outs[0].astype(np.float64), outs[1]
    n = lu_mat.shape[-1]
    L = np.tril(lu_mat, -1) + np.eye(n)
    U = np.triu(lu_mat)
    a = np.empty_like(lu_mat)
    a[_pivots(piv, n)] = L @ U
    return [a] + [np.asarray(o) for o in outs[2:]]


def _sorted_eig(outs, ins):
    w = np.sort_complex(np.asarray(outs[0]).astype(np.complex128))
    if len(outs) == 1:
        return [w]
    a = ins[0].astype(np.complex128)
    vv = np.asarray(outs[1], np.complex128)
    res = np.abs(a @ vv - vv * np.asarray(outs[0], np.complex128)).max()
    return [w, np.float64(res < 1e-3)]


case("cholesky", lambda r: ((r.spd(4),), {}), tol=LINALG)
case("cholesky_solve", lambda r: ((r.f(4, 2), np.linalg.cholesky(r.spd(4))
                                   .astype(np.float32)), {}), tol=LINALG)
case("cholesky_inverse", lambda r: ((np.linalg.cholesky(r.spd(4))
                                     .astype(np.float32),), {}),
     tol=LINALG)
case("triangular_solve", lambda r: ((np.triu(r.dd(4)), r.f(4, 2)),
                                    {"transpose": True}), tol=LINALG)
case("solve", lambda r: ((r.dd(4), r.f(4, 2)), {}), tol=LINALG)
case("det", lambda r: ((r.dd(3) / 3,), {}), tol=LINALG)
case("slogdet", lambda r: ((r.dd(3),), {}), tol=LINALG)
case("inv", lambda r: ((r.dd(4),), {}), tol=LINALG)
case("inverse", lambda r: ((r.spd(4),), {}), tol=LINALG)
case("pinv", lambda r: ((r.f(4, 3),), {}), tol=LINALG)
case("matrix_power", lambda r: ((r.spd(3) / 6.0,), {"n": 3}), tol=LINALG)
case("matrix_exp", lambda r: ((r.f(3, 3) * 0.3,), {}), tol=LINALG)
# eigenvectors, Q and R, U and V: each is unique only up to signs, so a
# gradient of them is not unique either
SIGNS = "its factors are unique only up to signs"
case("eigh", lambda r: ((r.spd(4),), {}), tol=LINALG, nograd=SIGNS,
     canon=_recon_eigh)
case("eigvalsh", lambda r: ((r.spd(4),), {}), tol=LINALG)
case("svd", lambda r: ((r.f(4, 3),), {}), tol=LINALG, nograd=SIGNS,
     canon=_recon_svd)
case("svdvals", lambda r: ((r.f(4, 3),), {}), tol=LINALG)
case("qr", lambda r: ((r.f(4, 3),), {}), tol=LINALG, nograd=SIGNS,
     canon=_recon_qr)
case("lu", lambda r: ((r.f(4, 4),), {"get_infos": True}), tol=LINALG,
     canon=_recon_lu)


def _call_lu_unpack(fn, args, kwargs, pd):
    lu_mat, piv = _op(pd, "lu")(args[0])
    return fn(lu_mat, piv)


case("lu_unpack", lambda r: ((r.f(4, 4),), {}), tol=LINALG,
     call=_call_lu_unpack,
     canon=lambda outs, ins: [outs[0] @ outs[1] @ outs[2]])
case("eig", lambda r: ((r.f(4, 4),), {}), tol=LINALG, nograd=SIGNS,
     canon=_sorted_eig)
case("eigvals", lambda r: ((r.f(4, 4),), {}), tol=LINALG, grad=False,
     canon=_sorted_eig)
case("lstsq", lambda r: ((r.f(5, 3), r.f(5, 2)), {}), tol=LINALG)
case("matrix_rank", lambda r: ((r.lowrank(5, 4, 2),), {}), grad=False)
case("cond", lambda r: ((r.spd(4),), {}), tol=LINALG)
case("norm", lambda r: ((r.f(3, 4),), {}), tol=LOOSE)
case("p_norm", lambda r: ((r.f(3, 4),), {"p": 3.0, "axis": 1}), tol=LOOSE)
case("vector_norm", lambda r: ((r.f(3, 4),), {"p": 1.0, "axis": [0, 1]}),
     tol=LOOSE)
case("matrix_norm", lambda r: ((r.f(2, 3, 4),), {"p": "fro"}), tol=LOOSE)
case("dist", lambda r: ((r.f(3, 4), r.f(3, 4)), {"p": 3}), tol=LOOSE)
case("cross", lambda r: ((r.f(3, 3), r.f(3, 3)), {"axis": 1}))
case("cdist", lambda r: ((r.f(3, 4), r.f(5, 4)), {}), tol=LOOSE)
case("pdist", lambda r: ((r.f(5, 3),), {}), tol=LOOSE)
case("cov", lambda r: ((r.f(3, 6),), {"aweights": r.pos(6)}), tol=LOOSE)
case("corrcoef", lambda r: ((r.f(3, 6),), {}), tol=LOOSE)


def _geqrf(r, m=4, n=3):
    """A Householder QR in LAPACK's (a, tau) form, from numpy."""
    a = r.f(m, n).astype(np.float64)
    taus, h = [], a.copy()
    for k in range(n):
        x = h[k:, k].copy()
        alpha = -np.sign(x[0]) * np.linalg.norm(x)
        v = x.copy()
        v[0] -= alpha
        v = v / v[0]
        tau = 2.0 / (v @ v)
        h[k:, k:] -= tau * np.outer(v, v @ h[k:, k:])
        h[k + 1:, k] = v[1:]
        taus.append(tau)
    return h.astype(np.float32), np.asarray(taus, np.float32)


case("householder_product", lambda r: (_geqrf(r), {}), tol=LINALG)
case("ormqr", lambda r: (_geqrf(r) + (r.f(4, 2),), {}), tol=LINALG)
# a random projection, then factors unique only up to signs and rotations
LOWRANK = "it draws a projection, and its factors are not unique"
case("pca_lowrank", lambda r: ((r.lowrank(6, 5, 2),), {"q": 2}),
     tol=LINALG, nograd=LOWRANK, canon=_recon_lowrank)
case("svd_lowrank", lambda r: ((r.lowrank(8, 6, 2),), {"q": 3}),
     tol=LINALG, nograd=LOWRANK,
     canon=lambda outs, ins: [_recon_lowrank(outs, ins)[0],
                              outs[1][:2]])

# -- activations, norms, layers ---------------------------------------------
case("softmax", lambda r: ((r.f(3, 5),), {"axis": 0}), tol=LOOSE)
case("log_softmax", lambda r: ((r.f(3, 5),), {"axis": -1}), tol=LOOSE)
case("glu", lambda r: ((r.f(3, 8),), {}), tol=LOOSE)
case("maxout", lambda r: ((r.perm(2, 4, 3, 3),), {"groups": 2}))
case("prelu", lambda r: ((r.f(2, 3, 4), r.pos(3)), {}))
case("linear", lambda r: ((r.f(3, 4), r.f(4, 5), r.f(5)), {}), tol=LOOSE)
case("embedding", lambda r: ((r.ints(6, 2, 3), r.f(6, 4)), {}))
case("layer_norm", lambda r: ((r.f(3, 8), 8, r.pos(8), r.f(8)), {}),
     tol=LOOSE)
case("rms_norm", lambda r: ((r.f(3, 8), r.pos(8)), {"epsilon": 1e-6}),
     tol=LOOSE)
case("batch_norm", lambda r: ((r.f(4, 3, 2, 2), r.f(3), r.pos(3), r.pos(3),
                               r.f(3)), {"training": False}), tol=LOOSE)
case("conv1d", lambda r: ((r.f(2, 3, 8), r.f(4, 3, 3), r.f(4)),
                          {"padding": 1}), tol=LOOSE)
case("conv2d", lambda r: ((r.f(2, 3, 6, 6), r.f(4, 3, 3, 3), r.f(4)),
                          {"stride": 2, "padding": 1}), tol=LOOSE)
case("conv3d", lambda r: ((r.f(1, 2, 4, 4, 4), r.f(3, 2, 3, 3, 3)),
                          {"padding": 1}), tol=LOOSE)
case("scaled_dot_product_attention",
     lambda r: ((r.f(1, 8, 2, 16), r.f(1, 8, 2, 16), r.f(1, 8, 2, 16)),
                {"is_causal": True}), tol=LOOSE)
case("flash_attention",
     lambda r: ((r.f(1, 8, 2, 16), r.f(1, 8, 2, 16), r.f(1, 8, 2, 16)),
                {"causal": True}), tol=LOOSE,
     canon=lambda outs, ins: outs[:1])

# -- losses -----------------------------------------------------------------


def _lbl(r):
    return r.ints(4, 3)


case("mse_loss", lambda r: ((r.f(3, 4), r.f(3, 4)), {}))
case("l1_loss", lambda r: ((r.f(3, 4), r.f(3, 4)), {"reduction": "sum"}))
case("smooth_l1_loss", lambda r: ((r.f(3, 4), r.f(3, 4)), {"delta": 0.5}))
case("square_error_cost", lambda r: ((r.f(3, 4), r.f(3, 4)), {}))
case("log_loss", lambda r: ((r.unit(3, 1), (r.boolean(3, 1) * 1.0)
                             .astype(np.float32)), {}), tol=LOOSE)
case("cross_entropy", lambda r: ((r.f(3, 4), _lbl(r)),
                                 {"label_smoothing": 0.1}), tol=LOOSE)
case("softmax_with_cross_entropy", lambda r: ((r.f(3, 4), _lbl(r)[:, None]),
                                              {}), tol=LOOSE)
case("nll_loss", lambda r: ((np.log(r.unit(3, 4)), _lbl(r)), {}),
     tol=LOOSE)
case("binary_cross_entropy", lambda r: ((r.unit(3, 4), (r.boolean(3, 4)
                                                        * 1.0)
                                         .astype(np.float32)), {}),
     tol=LOOSE)
case("binary_cross_entropy_with_logits",
     lambda r: ((r.f(3, 4), (r.boolean(3, 4) * 1.0).astype(np.float32)),
                {"pos_weight": r.pos(4)}), tol=LOOSE)
case("kl_div", lambda r: ((np.log(r.unit(3, 4)), r.unit(3, 4)),
                          {"reduction": "batchmean"}), tol=LOOSE)
case("margin_ranking_loss", lambda r: ((r.f(5), r.f(5), np.sign(r.f(5))),
                                       {"margin": 0.1}))
case("hinge_embedding_loss", lambda r: ((r.f(5), np.sign(r.f(5))), {}))
case("cosine_embedding_loss", lambda r: ((r.f(4, 3), r.f(4, 3),
                                          np.sign(r.f(4))), {}),
     tol=LOOSE)
case("soft_margin_loss", lambda r: ((r.f(3, 4), np.sign(r.f(3, 4))), {}),
     tol=LOOSE)
case("triplet_margin_loss", lambda r: ((r.f(4, 3), r.f(4, 3), r.f(4, 3)),
                                       {}), tol=LOOSE)
case("poisson_nll_loss", lambda r: ((r.f(3, 4), r.pos(3, 4) * 2),
                                    {"full": True}), tol=LOOSE)
case("gaussian_nll_loss", lambda r: ((r.f(3, 4), r.f(3, 4), r.pos(3, 4)),
                                     {"full": True}), tol=LOOSE)
case("dice_loss", lambda r: ((r.unit(3, 4), r.ints(4, 3, 1)), {}),
     tol=LOOSE)
case("multi_label_soft_margin_loss",
     lambda r: ((r.f(3, 4), (r.boolean(3, 4) * 1.0).astype(np.float32)),
                {"weight": r.pos(4)}), tol=LOOSE)
case("multi_margin_loss", lambda r: ((r.f(3, 4), _lbl(r)),
                                     {"weight": r.pos(4)}), tol=LOOSE)
case("sigmoid_focal_loss", lambda r: ((r.f(3, 4), (r.boolean(3, 4) * 1.0)
                                       .astype(np.float32)),
                                      {"normalizer": r.pos(1)}), tol=LOOSE)

# -- sequences, beams, arrays -----------------------------------------------
case("multiplex", lambda r: (([r.f(4, 3), r.f(4, 3)], r.ints(2, 4, 1)),
                             {}))
case("gather_tree", lambda r: ((r.ints(5, 4, 2, 3), r.ints(3, 4, 2, 3)),
                               {}), grad=False)
case("edit_distance", lambda r: ((r.ints(4, 3, 5), r.ints(4, 3, 6)),
                                 {"input_length": np.array([5, 3, 4]),
                                  "label_length": np.array([6, 2, 5])}),
     grad=False)
case("viterbi_decode", lambda r: ((r.f(2, 5, 3), r.f(5, 5),
                                   np.array([5, 3], np.int64)), {}))


def _top_p_peaked(r):
    p = r.unit(3, 6)
    p[np.arange(3), r.ints(6, 3)] = 20.0
    return p / p.sum(-1, keepdims=True), np.full((3,), 0.05, np.float32)


# with the nucleus cut to the top token the draw has one outcome
case("top_p_sampling", lambda r: (_top_p_peaked(r), {"seed": 7}))


def _call_create_array(fn, args, kwargs, pd):
    return fn("float32", [args[0], args[1]])


def _call_array_write(fn, args, kwargs, pd):
    arr = fn(args[0], 0)
    return fn(args[1], 1, arr)


def _call_array_read(fn, args, kwargs, pd):
    return fn([args[0], args[1]], args[2])


def _call_array_length(fn, args, kwargs, pd):
    return fn([args[0], args[1]])


def _call_array_pop(fn, args, kwargs, pd):
    arr = [args[0], args[1]]
    return [fn(arr, 0), len(arr)]


for _n, _c in (("create_array", _call_create_array),
               ("array_write", _call_array_write),
               ("array_read", _call_array_read),
               ("array_length", _call_array_length),
               ("array_pop", _call_array_pop)):
    case(_n, lambda r: ((r.f(2, 2), r.f(2, 2), np.array([1], np.int64)),
                        {}), call=_c)
case("histogram_bin_edges", lambda r: ((r.f(20),), {"bins": 5}),
     tol=LOOSE)
case("histogramdd", lambda r: ((r.f(20, 2),), {"bins": 4}), tol=LOOSE)
case("frexp", lambda r: ((r.f(3, 4) * 10,), {}))
case("isin", lambda r: ((r.ints(6, 3, 4), r.ints(6, 5)), {}), grad=False)
case("block_diag", lambda r: (([r.f(2, 3), r.f(1, 2)],), {}))
# the JAX package's cartesian_prod leaves its tape: the port's gradient is
# held to the sums of the cotangent's columns over the other factor
case("cartesian_prod", lambda r: (([r.f(3), r.f(2)],), {}),
     vjp=lambda ins, cts: [cts[0][:, 0].reshape(3, 2).sum(1),
                           cts[0][:, 1].reshape(3, 2).sum(0)])


def _call_gammainc(fn, args, kwargs, pd):
    return fn(args[0].detach(), args[1])


# the gradient in y only: torch has no derivative of the regularized
# incomplete gamma in its shape a (ROADMAP.md, Queue 3)
for _n in "gammainc gammaincc".split():
    case(_n, lambda r: ((r.pos(3, 4), r.pos(3, 4)), {}), tol=LOOSE,
         call=_call_gammainc)
case("multigammaln", lambda r: ((r.pos(3, 4) + 3.0,), {"p": 2}),
     tol=LOOSE)


def _call_rng_state(fn, args, kwargs, pd):
    """get_rng_state / set_rng_state / seed: a state taken and put back,
    or one seed, gives the same draw again (the draw is not returned)."""
    pd.seed(77)
    st = pd.get_rng_state()
    a = pd.rand([6]).numpy()
    pd.set_rng_state(st)
    b = pd.rand([6]).numpy()
    pd.seed(1234)
    c = pd.rand([6]).numpy()
    pd.seed(1234)
    d = pd.rand([6]).numpy()
    return [bool(np.array_equal(a, b)), bool(np.array_equal(c, d))]


for _n in "seed get_rng_state set_rng_state".split():
    case(_n, lambda r: ((), {}), grad=False, call=_call_rng_state)


# -- the ops that draw: properties only -------------------------------------
N_DRAW = 20000


def _sig6(var, n=N_DRAW):
    """Six standard errors of a sample mean of n draws of variance var."""
    return 6.0 * math.sqrt(var / n)


def _moments(mean, var):
    def check(a):
        a = np.asarray(a, np.float64).reshape(-1)
        bound = _sig6(var, a.size)
        return abs(a.mean() - mean) <= bound, \
            f"mean {a.mean():.5f} vs {mean} (bound {bound:.5f})"
    return check


def rnd(name, draw, support, moments=None, dtype=None):
    """draw(pd) -> a Tensor; support(a) -> bool over its values."""
    RANDOM[name] = (draw, support, moments, dtype)


def _t(pd, a):
    return pd.to_tensor(np.asarray(a))


rnd("rand", lambda pd: pd.rand([N_DRAW]),
    lambda a: (a >= 0).all() and (a < 1).all(), _moments(0.5, 1 / 12),
    "float32")
rnd("uniform", lambda pd: _op(pd, "uniform")([N_DRAW], min=-2.0, max=1.0),
    lambda a: (a >= -2).all() and (a < 1).all(), _moments(-0.5, 9 / 12),
    "float32")
rnd("randn", lambda pd: pd.randn([N_DRAW]), lambda a: np.isfinite(a).all(),
    _moments(0.0, 1.0), "float32")
rnd("standard_normal", lambda pd: _op(pd, "standard_normal")([N_DRAW]),
    lambda a: np.isfinite(a).all(), _moments(0.0, 1.0), "float32")
rnd("normal", lambda pd: _op(pd, "normal")(1.0, 2.0, [N_DRAW]),
    lambda a: np.isfinite(a).all(), _moments(1.0, 4.0), "float32")
rnd("gaussian", lambda pd: _op(pd, "gaussian")([N_DRAW], mean=-1.0,
                                                std=0.5),
    lambda a: np.isfinite(a).all(), _moments(-1.0, 0.25), "float32")
rnd("log_normal", lambda pd: _op(pd, "log_normal")(0.0, 0.5, [N_DRAW]),
    lambda a: (a > 0).all(), _moments(math.exp(0.125),
                                      (math.exp(0.25) - 1)
                                      * math.exp(0.25)), "float32")
rnd("randint", lambda pd: _op(pd, "randint")(2, 9, [N_DRAW]),
    lambda a: (a >= 2).all() and (a < 9).all(), _moments(5.0, 4.0),
    "int64")
rnd("randint_like", lambda pd: _op(pd, "randint_like")(
    pd.zeros([N_DRAW], "float32"), 0, 4),
    lambda a: np.isin(a, [0, 1, 2, 3]).all(), _moments(1.5, 1.25),
    "float32")
rnd("randperm", lambda pd: _op(pd, "randperm")(50),
    lambda a: np.array_equal(np.sort(a), np.arange(50)), None, "int64")
rnd("bernoulli", lambda pd: _op(pd, "bernoulli")(
    pd.full([N_DRAW], 0.3, "float32")),
    lambda a: np.isin(a, [0, 1]).all(), _moments(0.3, 0.21), "float32")
rnd("poisson", lambda pd: _op(pd, "poisson")(
    pd.full([N_DRAW], 4.0, "float32")),
    lambda a: (a >= 0).all() and (a == np.round(a)).all(),
    _moments(4.0, 4.0), "float32")
rnd("binomial", lambda pd: _op(pd, "binomial")(
    pd.full([N_DRAW], 10.0, "float32"), pd.full([N_DRAW], 0.25, "float32")),
    lambda a: (a >= 0).all() and (a <= 10).all(), _moments(2.5, 1.875),
    "int64")
rnd("standard_gamma", lambda pd: _op(pd, "standard_gamma")(
    pd.full([N_DRAW], 3.0, "float32")),
    lambda a: (a > 0).all(), _moments(3.0, 3.0), "float32")
rnd("multinomial", lambda pd: _op(pd, "multinomial")(
    _t(pd, np.array([0.1, 0.2, 0.3, 0.4], np.float32)), N_DRAW, True),
    lambda a: (a >= 0).all() and (a < 4).all(), _moments(2.0, 1.0),
    "int64")
rnd("uniform_", lambda pd: _op(pd, "uniform_")(pd.zeros([N_DRAW])),
    lambda a: (a >= -1).all() and (a < 1).all(), _moments(0.0, 1 / 3),
    "float32")
rnd("normal_", lambda pd: _op(pd, "normal_")(pd.zeros([N_DRAW]), 2.0, 3.0),
    lambda a: np.isfinite(a).all(), _moments(2.0, 9.0), "float32")
rnd("exponential_", lambda pd: _op(pd, "exponential_")(
    pd.zeros([N_DRAW]), 2.0),
    lambda a: (a >= 0).all(), _moments(0.5, 0.25), "float32")
rnd("geometric_", lambda pd: _op(pd, "geometric_")(pd.zeros([N_DRAW]), 0.25),
    lambda a: (a >= 1).all() and (a == np.round(a)).all(),
    _moments(4.0, 12.0), "float32")
# a Cauchy draw has no mean: its median is held instead (6 sigma of the
# sample median, pi * scale / (2 sqrt(n)) each)
rnd("cauchy_", lambda pd: _op(pd, "cauchy_")(pd.zeros([N_DRAW]), 1.0, 2.0),
    lambda a: np.isfinite(a).all(),
    lambda a: (abs(np.median(a) - 1.0) <= 6 * math.pi * 2.0
               / (2 * math.sqrt(a.size)), f"median {np.median(a):.4f}"),
    "float32")
rnd("dropout", lambda pd: _op(pd, "dropout")(pd.ones([N_DRAW]), p=0.25),
    lambda a: np.isin(a, [0.0, np.float32(1 / 0.75)]).all(),
    _moments(1.0, 0.25 / 0.75), "float32")
rnd("top_p_sampling", lambda pd: _op(pd, "top_p_sampling")(
    _t(pd, np.tile(np.array([[0.4, 0.3, 0.2, 0.1]], np.float32),
                   (N_DRAW, 1))),
    _t(pd, np.full((N_DRAW,), 0.5, np.float32)))[1],
    # the nucleus of p = 0.5 is the two top tokens (0.4 / 0.7 of it on 0)
    lambda a: np.isin(a, [0, 1]).all(), _moments(0.3 / 0.7,
                                                 0.3 / 0.7 * 0.4 / 0.7),
    "int64")


# ---------------------------------------------------------------------------
# the runner
# ---------------------------------------------------------------------------
def _to_np(t):
    if not isinstance(t, np.ndarray) and hasattr(t, "numpy"):
        a = np.asarray(t.numpy())
        return a.astype(np.float32) if a.dtype.name == "bfloat16" else a
    return np.asarray(t)


def _flat(out, acc):
    if isinstance(out, (list, tuple)):
        for o in out:
            _flat(o, acc)
    elif out is not None:
        acc.append(out)
    return acc


class Result:
    __slots__ = ("outs", "grads", "devices", "dtypes", "cts")

    def __init__(self, outs, grads, devices, dtypes, cts):
        self.outs, self.grads = outs, grads
        self.devices, self.dtypes, self.cts = devices, dtypes, cts


def _device_name(t):
    d = getattr(t, "_data", None)
    dev = getattr(d, "device", None)
    return getattr(dev, "type", None) if dev is not None else None


def run(pd, name, device=None):
    """One call of case ``name`` through package pd (on ``device``, for
    the port): outputs and gradients as numpy, with each output Tensor's
    device type and dtype name."""
    c = CASES[name]
    args, kwargs = inputs(name)
    prev = pd.get_device() if device is not None else None
    if device is not None:
        pd.set_device(device)
    try:
        leaves = []

        def conv(a):
            if isinstance(a, np.ndarray):
                t = pd.to_tensor(a)
                if c.grad and a.dtype.kind == "f":
                    t.stop_gradient = False
                    leaves.append(t)
                return t
            if isinstance(a, list) and a and all(
                    isinstance(e, np.ndarray) for e in a):
                return [conv(e) for e in a]
            return a
        targs = [conv(a) for a in args]
        tkw = {k: conv(v) for k, v in kwargs.items()}
        fn = _op(pd, name)
        out = c.call(fn, targs, tkw, pd) if c.call is not None \
            else fn(*targs, **tkw)
        flat = _flat(out, [])
        tens = [o for o in flat if isinstance(o, pd.Tensor)]
        grads, cts = [], []
        if c.grad and leaves:
            terms = []
            for i, o in enumerate(tens):
                if o.dtype.name in ("float32", "float64") and \
                        not o.stop_gradient:
                    ct = np.random.RandomState(9 + i).uniform(
                        0.5, 1.5, o.shape).astype(o.dtype.name)
                    cts.append(ct)
                    terms.append((o * pd.to_tensor(ct)).sum())
            if terms:
                loss = terms[0]
                for t in terms[1:]:
                    loss = loss + t
                loss.backward()
                grads = [_to_np(x.grad) if x.grad is not None
                         else np.zeros(x.shape, np.float32) for x in leaves]
        outs = [_to_np(o) for o in flat]
        devices = [_device_name(o) for o in tens]
        dtypes = [o.dtype.name for o in tens]
        return Result(outs, grads, devices, dtypes, cts)
    finally:
        if device is not None:
            pd.set_device(prev)


# The JAX package runs with x64 off: its int64 results come back int32 and
# its float64 ones float32; the port keeps Paddle's int64 / float64.
X64 = {("int32", "int64"), ("float32", "float64")}


def compare(name, ref, got, dtypes=True):
    """The differences of got from ref (run() results), as messages."""
    c = CASES[name]
    bad = []
    a_in, _ = inputs(name)
    ins = [np.asarray(a) for a in a_in if isinstance(a, np.ndarray)]
    ro, go = ref.outs, got.outs
    rg = ref.grads if c.vjp is None else c.vjp(ins, got.cts)
    if c.canon is not None:
        ro, go = c.canon(ro, ins), c.canon(go, ins)
    if len(ro) != len(go):
        return [f"{len(go)} outputs against {len(ro)}"]
    if dtypes:
        for i, (a, b) in enumerate(zip(ref.dtypes, got.dtypes)):
            if a != b and (a, b) not in X64:
                bad.append(f"out[{i}] dtype {b} against {a}")
    for tag, rs, gs, (rt, at) in (("out", ro, go, c.tol),
                                  ("grad", rg, got.grads, c.gtol)):
        if len(rs) != len(gs):
            bad.append(f"{len(gs)} {tag}s against {len(rs)}")
            continue
        for i, (a, b) in enumerate(zip(rs, gs)):
            a, b = np.asarray(a), np.asarray(b)
            if a.shape != b.shape:
                bad.append(f"{tag}[{i}] shape {b.shape} against {a.shape}")
            elif a.dtype.kind in "biuO" and b.dtype.kind in "biuO":
                if not np.array_equal(a, b):
                    bad.append(f"{tag}[{i}] differs")
            else:
                k = np.complex128 if "c" in (a.dtype.kind, b.dtype.kind) \
                    else np.float64
                a, b = a.astype(k), b.astype(k)
                ok = np.isclose(b, a, rtol=rt, atol=at, equal_nan=True)
                if not ok.all():
                    err = np.nanmax(np.abs(b - a)[~ok])
                    bad.append(f"{tag}[{i}] max abs err {err:.3g} "
                               f"(rtol {rt}, atol {at})")
    return bad


def check_random(pd, name, device=None, seed=1234):
    """The properties of RANDOM[name]'s draw through the port on device:
    messages for each one that fails."""
    draw, support, moments, dtype = RANDOM[name]
    prev = pd.get_device() if device is not None else None
    if device is not None:
        pd.set_device(device)
    try:
        pd.seed(seed)
        t1 = draw(pd)
        pd.seed(seed)
        t2 = draw(pd)
        pd.seed(seed + 1)
        t3 = draw(pd)
        a, b = _to_np(t1), _to_np(t2)
        bad = []
        if not np.array_equal(a, b):
            bad.append("one seed gave two draws")
        if np.array_equal(a, _to_np(t3)):
            bad.append("two seeds gave one draw")
        if dtype is not None and t1.dtype.name != dtype:
            bad.append(f"dtype {t1.dtype.name}, not {dtype}")
        if device is not None:
            want = "cpu" if device == "cpu" else "cuda"
            if _device_name(t1) != want:
                bad.append(f"on {_device_name(t1)}, not {want}")
        if not bool(support(a)):
            bad.append("a draw outside the support")
        if moments is not None:
            ok, msg = moments(a)
            if not ok:
                bad.append(msg)
        return bad
    finally:
        if device is not None:
            pd.set_device(prev)
