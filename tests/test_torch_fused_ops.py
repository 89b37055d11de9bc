"""PyTorch port, ``incubate.nn.functional`` fused ops on the CPU, against
the JAX package's: fused_rms_norm and fused_layer_norm (with and without
bias, residual and norm_bias; float32 and bfloat16 x against float32
weights; autograd gradients of x, weight and bias), the fused-norm shape
rule, fused_rotary_position_embedding in both styles (computed and given
sin/cos tables, position_ids gathers), swiglu in its one- and
two-argument forms, and fused_matmul_bias / fused_linear with transposes.
Mirrors tests/test_fused_ops.py.

Same inputs (numpy, from a seed) through both.  Off the TPU the JAX
package's norms take its compositions (``_rms_ref`` / ``_ln_ref``; its
Pallas rule is TPU-only), which are the port's plain versions, so the
port's kernel route on CPU tensors computes the same function.
Tolerances: float32 rtol = atol = 1e-5 (the same f32 math, reductions
and transcendentals in another order); bfloat16 outputs one bf16 ulp at
the reference's magnitude.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.incubate.nn.functional as JF
import paddle_tpu.ops.pallas.fused_norms as JFN
import paddle_tpu_torch.incubate.nn.functional as TF
from paddle_tpu_torch.ops import fused_norms as tfn
from _torch_threads import torch_threads  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)


def _j(a, dtype="float32", grad=False):
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    return paddle.to_tensor(jnp.asarray(np.asarray(a, np.float32), jd),
                            stop_gradient=not grad)


def _t(a, dtype="float32", grad=False):
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return torch.tensor(np.asarray(a, np.float32), dtype=td,
                        requires_grad=grad)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    data = x._data if hasattr(x, "_data") else x
    return np.asarray(jnp.asarray(data, jnp.float32))


def _close(got, want, dtype="float32"):
    got, want = _np(got), _np(want)
    if dtype == "bfloat16":
        mag = np.maximum(np.abs(want), 2.0 ** -126)
        ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
        assert np.all(np.abs(got - want) <= ulp), \
            float(np.max(np.abs(got - want) / ulp))
    else:
        np.testing.assert_allclose(got, want, **TOL)


# ---------------------------------------------------------------------------
# tests/test_fused_ops.py, case for case, against the JAX functions
# ---------------------------------------------------------------------------

def test_fused_rms_norm_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(4, 16)
    w = rng.randn(16)
    jo, jr = JF.fused_rms_norm(_j(x), _j(w), epsilon=1e-6)
    to, tr = TF.fused_rms_norm(_t(x), _t(w), epsilon=1e-6)
    _close(to, jo)
    _close(tr, jr)


def test_fused_rms_norm_with_residual_and_bias_matches_jax():
    rng = np.random.RandomState(1)
    x, b, r = rng.randn(4, 16), rng.randn(16), rng.randn(4, 16)
    w = np.ones(16)
    jo, jr = JF.fused_rms_norm(_j(x), _j(w), bias=_j(b), residual=_j(r))
    to, tr = TF.fused_rms_norm(_t(x), _t(w), bias=_t(b), residual=_t(r))
    _close(to, jo)
    _close(tr, jr)


def test_fused_layer_norm_matches_jax():
    rng = np.random.RandomState(2)
    x, w, b = rng.randn(6, 8), rng.randn(8), rng.randn(8)
    jo, _ = JF.fused_layer_norm(_j(x), _j(w), _j(b), epsilon=1e-5)
    to, _ = TF.fused_layer_norm(_t(x), _t(w), _t(b), epsilon=1e-5)
    _close(to, jo)


def test_fused_rms_norm_gradient_matches_jax():
    rng = np.random.RandomState(3)
    x, w = rng.randn(4, 16), rng.randn(16)
    jx, jw = _j(x, grad=True), _j(w, grad=True)
    JF.fused_rms_norm(jx, jw)[0].sum().backward()
    tx, tw = _t(x, grad=True), _t(w, grad=True)
    TF.fused_rms_norm(tx, tw)[0].sum().backward()
    _close(tx.grad, jx.grad)
    _close(tw.grad, jw.grad)


def test_rope_neox_rotation_matches_jax():
    rng = np.random.RandomState(4)
    q = rng.randn(2, 8, 2, 8)
    jq, jk, jv = JF.fused_rotary_position_embedding(_j(q))
    tq, tk, tv = TF.fused_rotary_position_embedding(_t(q))
    assert jk is jv is tk is tv is None
    _close(tq, jq)


def test_rope_qk_pair_matches_jax():
    rng = np.random.RandomState(5)
    q, k = rng.randn(1, 16, 1, 16), rng.randn(1, 16, 1, 16)
    jq, jk, _ = JF.fused_rotary_position_embedding(_j(q), _j(k))
    tq, tk, tv = TF.fused_rotary_position_embedding(_t(q), _t(k))
    assert tv is None
    _close(tq, jq)
    _close(tk, jk)


@pytest.mark.parametrize("two_args", [True, False], ids=["xy", "split"])
def test_swiglu_matches_jax(two_args):
    rng = np.random.RandomState(6)
    x, y = rng.randn(4, 8), rng.randn(4, 8)
    if two_args:
        _close(TF.swiglu(_t(x), _t(y)), JF.swiglu(_j(x), _j(y)))
    else:
        both = np.concatenate([x, y], -1)
        _close(TF.swiglu(_t(both)), JF.swiglu(_j(both)))


def test_fused_matmul_bias_and_linear_match_jax():
    rng = np.random.RandomState(7)
    x, w, b = rng.randn(4, 8), rng.randn(8, 16), rng.randn(16)
    _close(TF.fused_matmul_bias(_t(x), _t(w), _t(b)),
           JF.fused_matmul_bias(_j(x), _j(w), _j(b)))
    _close(TF.fused_linear(_t(x), _t(w.T), _t(b), transpose_weight=True),
           JF.fused_linear(_j(x), _j(w.T), _j(b), transpose_weight=True))


# ---------------------------------------------------------------------------
# the norms: every option, both dtypes, gradients
# ---------------------------------------------------------------------------

NORM_SHAPES = {"kernel_rule": (2, 8, 256), "off_rule": (3, 5, 96)}


def _norm_inputs(seed, shape):
    rng = np.random.RandomState(seed)
    H = shape[-1]
    return {"x": rng.randn(*shape), "w": 1 + 0.1 * rng.randn(H),
            "b": 0.1 * rng.randn(H), "bias": 0.1 * rng.randn(H),
            "residual": rng.randn(*shape), "norm_bias": 0.1 * rng.randn(H),
            "g": rng.randn(*shape)}


def _run_norm(lib, conv, kind, inp, dtype, opts):
    """One fused norm through ``lib`` (the JAX or the port surface);
    returns (out, residual_out, grads of x, weight, bias)."""
    x = conv(inp["x"], dtype, grad=True)
    w = conv(inp["w"], "float32", grad=True)
    b = conv(inp["b"], "float32", grad=True)
    kw = {k: conv(inp[k], dtype if k == "residual" else "float32")
          for k in opts}
    if kind == "rms":
        out, res = lib.fused_rms_norm(x, w, epsilon=1e-6, **kw)
    else:
        kw.pop("norm_bias", None)
        out, res = lib.fused_layer_norm(x, w, b, epsilon=1e-5, **kw)
    (out * conv(inp["g"], "float32")).sum().backward()
    return out, res, x.grad, w.grad, (b.grad if kind == "layer" else None)


OPTIONS = {"plain": (), "residual": ("residual",),
           "bias_residual": ("bias", "residual"),
           "norm_bias": ("norm_bias",)}


@pytest.mark.parametrize("opts", list(OPTIONS))
@pytest.mark.parametrize("shape", list(NORM_SHAPES))
@pytest.mark.parametrize("kind", ["rms", "layer"])
def test_norms_match_jax_in_f32_with_gradients(kind, shape, opts):
    inp = _norm_inputs(10, NORM_SHAPES[shape])
    want = _run_norm(JF, _j, kind, inp, "float32", OPTIONS[opts])
    got = _run_norm(TF, _t, kind, inp, "float32", OPTIONS[opts])
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            _close(g, w)


@pytest.mark.parametrize("shape", list(NORM_SHAPES))
@pytest.mark.parametrize("kind", ["rms", "layer"])
def test_norms_match_jax_on_bf16_x_with_f32_weights(kind, shape):
    """bf16 activations against f32 master weights: the output and the
    residual stream in bf16, within one bf16 ulp of the JAX package's."""
    inp = _norm_inputs(11, NORM_SHAPES[shape])
    x, r = inp["x"], inp["residual"]
    w, b = inp["w"], inp["b"]
    if kind == "rms":
        jo, jr = JF.fused_rms_norm(_j(x, "bfloat16"), _j(w),
                                   residual=_j(r, "bfloat16"))
        to, tr = TF.fused_rms_norm(_t(x, "bfloat16"), _t(w),
                                   residual=_t(r, "bfloat16"))
    else:
        jo, jr = JF.fused_layer_norm(_j(x, "bfloat16"), _j(w), _j(b),
                                     residual=_j(r, "bfloat16"))
        to, tr = TF.fused_layer_norm(_t(x, "bfloat16"), _t(w), _t(b),
                                     residual=_t(r, "bfloat16"))
    assert to.dtype == tr.dtype == torch.bfloat16
    _close(to, jo, "bfloat16")
    _close(tr, jr, "bfloat16")


@pytest.mark.parametrize("kind", ["rms", "layer"])
def test_norms_without_weight_match_jax(kind):
    """No weight (and for LayerNorm no bias): the compositions with ones
    and zeros, never the kernel."""
    x = np.random.RandomState(12).randn(8, 128)
    if kind == "rms":
        got = TF.fused_rms_norm(_t(x), None)[0]
        want = JF.fused_rms_norm(_j(x), None)[0]
    else:
        got = TF.fused_layer_norm(_t(x), None, None)[0]
        want = JF.fused_layer_norm(_j(x), None, None)[0]
    _close(got, want)


@pytest.mark.parametrize("kind", ["rms", "layer"])
def test_norms_refuse_other_norm_axes_like_jax(kind):
    x = np.ones((2, 4, 8))
    w = np.ones(32)
    fn_j = JF.fused_rms_norm if kind == "rms" else JF.fused_layer_norm
    fn_t = TF.fused_rms_norm if kind == "rms" else TF.fused_layer_norm
    args = (w,) if kind == "rms" else (w, np.zeros(32))
    with pytest.raises(NotImplementedError, match="begin_norm_axis"):
        fn_j(_j(x), *(_j(a) for a in args), begin_norm_axis=1)
    with pytest.raises(NotImplementedError, match="begin_norm_axis"):
        fn_t(_t(x), *(_t(a) for a in args), begin_norm_axis=1)


# ---------------------------------------------------------------------------
# the shape rule and the kernel route
# ---------------------------------------------------------------------------

RULE_SHAPES = [(8, 128), (16, 4096), (2, 4, 256), (4, 128), (8, 96),
               (12, 128), (3, 8, 1024), (8, 64), (1, 1, 128), (0, 128),
               (64, 11008)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("shape", RULE_SHAPES, ids=str)
def test_shape_rule_equals_jax(shape, dtype, monkeypatch):
    """The port's rule is the JAX ``_supports`` with its backend check
    answered "tpu" (the only place it holds)."""
    monkeypatch.setattr(JFN, "jax", types.SimpleNamespace(
        default_backend=lambda: "tpu"))
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}[dtype]
    assert tfn.supports(shape, tdt) is JFN._supports(shape, dtype)


def test_cpu_tensors_take_the_plain_versions_and_never_count():
    rng = np.random.RandomState(13)
    x, w, b = _t(rng.randn(8, 256)), _t(rng.randn(256)), _t(rng.randn(256))
    tfn.rms_launch_count = tfn.ln_launch_count = 0
    assert torch.equal(tfn.rms_norm(x, w, 1e-6), tfn.rms_ref(x, w, 1e-6))
    assert torch.equal(tfn.layer_norm(x, w, b, 1e-5),
                       tfn.ln_ref(x, w, b, 1e-5))
    TF.fused_rms_norm(x, w)
    TF.fused_layer_norm(x, w, b)
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        tfn._launch_rms(x, w, 1e-6)
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        tfn._launch_ln(x, w, b, 1e-5)
    assert tfn.rms_launch_count == tfn.ln_launch_count == 0


def test_routing_sends_rule_shapes_to_the_autograd_function(monkeypatch):
    """Where the rule holds the norms go through ``rms_norm`` /
    ``layer_norm`` (the kernel on CUDA tensors); elsewhere through the
    compositions."""
    calls = []
    real_rms, real_ln = tfn.rms_norm, tfn.layer_norm
    monkeypatch.setattr(tfn, "rms_norm",
                        lambda *a: calls.append("rms") or real_rms(*a))
    monkeypatch.setattr(tfn, "layer_norm",
                        lambda *a: calls.append("ln") or real_ln(*a))
    rng = np.random.RandomState(14)
    w, b = _t(rng.randn(128)), _t(rng.randn(128))
    TF.fused_rms_norm(_t(rng.randn(8, 128)), w)
    TF.fused_layer_norm(_t(rng.randn(2, 4, 128)), w, b)
    TF.fused_rms_norm(_t(rng.randn(8, 128), "bfloat16"), w)
    assert calls == ["rms", "ln", "rms"]
    TF.fused_rms_norm(_t(rng.randn(7, 128)), w)        # rows off the rule
    TF.fused_layer_norm(_t(rng.randn(8, 128)), w, None)  # no bias
    TF.fused_rms_norm(_t(rng.randn(8, 128)), None)     # no weight
    assert calls == ["rms", "ln", "rms"]


@pytest.mark.parametrize("name", ["float16_x", "weight_shape", "rows_7",
                                  "hidden_96", "noncontiguous_x",
                                  "float16_weight"])
def test_kernel_wrapper_rejects_bad_operands(name):
    rng = np.random.RandomState(15)
    x, w = _t(rng.randn(8, 128)), _t(rng.randn(128))
    if name == "float16_x":
        x = x.half()
    elif name == "weight_shape":
        w = w[:64]
    elif name == "rows_7":
        x = x[:7]
    elif name == "hidden_96":
        x, w = x[:, :96].contiguous(), w[:96]
    elif name == "noncontiguous_x":
        x = _t(rng.randn(128, 8)).t()
    elif name == "float16_weight":
        w = w.half()
    with pytest.raises(ValueError, match="fused rms_norm kernel"):
        tfn._launch_rms(x, w, 1e-6)


# ---------------------------------------------------------------------------
# rotary embedding, swiglu and the products in every form
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tables", ["computed", "given_2d", "given_4d"])
@pytest.mark.parametrize("neox", [True, False], ids=["interleaved", "half"])
def test_rope_styles_tables_and_positions_match_jax(neox, tables):
    rng = np.random.RandomState(16)
    B, S, H, D = 2, 6, 3, 16
    q, k, v = (rng.randn(B, S, H, D) for _ in range(3))
    pos = rng.randint(0, 40, (B, S))
    kw_j, kw_t = {}, {}
    if tables != "computed":
        ang = rng.rand(40, D) * 3.0
        sin, cos = np.sin(ang), np.cos(ang)
        if tables == "given_4d":
            sin, cos = sin[None, :, None, :], cos[None, :, None, :]
        kw_j = {"sin": _j(sin), "cos": _j(cos)}
        kw_t = {"sin": _t(sin), "cos": _t(cos)}
    want = JF.fused_rotary_position_embedding(
        _j(q), _j(k), _j(v), position_ids=paddle.to_tensor(pos.astype(np.int32)),
        use_neox_rotary_style=neox, **kw_j)
    got = TF.fused_rotary_position_embedding(
        _t(q), _t(k), _t(v), position_ids=torch.tensor(pos),
        use_neox_rotary_style=neox, **kw_t)
    for g, w in zip(got, want):
        _close(g, w)


def test_rope_without_positions_and_in_bf16_matches_jax():
    rng = np.random.RandomState(17)
    q = rng.randn(1, 12, 2, 32)
    want = JF.fused_rotary_position_embedding(_j(q, "bfloat16"),
                                              rotary_emb_base=500.0)[0]
    got = TF.fused_rotary_position_embedding(_t(q, "bfloat16"),
                                             rotary_emb_base=500.0)[0]
    assert got.dtype == torch.bfloat16
    _close(got, want, "bfloat16")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swiglu_dtypes_match_jax(dtype):
    rng = np.random.RandomState(18)
    x = rng.randn(3, 5, 64)
    _close(TF.swiglu(_t(x, dtype)), JF.swiglu(_j(x, dtype)), dtype)
    _close(TF.swiglu(_t(x, dtype), _t(x[..., ::-1].copy(), dtype)),
           JF.swiglu(_j(x, dtype), _j(x[..., ::-1].copy(), dtype)), dtype)


@pytest.mark.parametrize("tx,ty", [(False, False), (True, False),
                                   (False, True), (True, True)])
def test_fused_matmul_bias_transposes_match_jax(tx, ty):
    rng = np.random.RandomState(19)
    a = rng.randn(2, 8, 4) if tx else rng.randn(2, 4, 8)
    b = rng.randn(16, 8) if ty else rng.randn(8, 16)
    bias = rng.randn(16)
    _close(TF.fused_matmul_bias(_t(a), _t(b), _t(bias), transpose_x=tx,
                                transpose_y=ty),
           JF.fused_matmul_bias(_j(a), _j(b), _j(bias), transpose_x=tx,
                                transpose_y=ty))
    _close(TF.fused_linear(_t(a if not tx else a.swapaxes(-1, -2).copy()),
                           _t(b), transpose_weight=ty),
           JF.fused_linear(_j(a if not tx else a.swapaxes(-1, -2).copy()),
                           _j(b), transpose_weight=ty))
