"""Autograd of the port (torch autograd behind Paddle's semantics)
against the JAX package's tape (tests/test_autograd.py case for case):
backward, accumulation, hooks, paddle.grad (create_graph too), PyLayer,
stop_gradient, integer inputs.  Each case runs the same code on both
packages; gradients equal to rtol 1e-6 (atol 1e-6), and the JAX test's
own numeric-gradient checks hold on the port."""
import numpy as np
import pytest

from _torch_eager import both, close, eager_state  # noqa: F401
from _torch_threads import torch_threads  # noqa: F401


def numeric_grad(fn, x, eps=1e-3):
    x = x.astype(np.float64)
    g = np.zeros_like(x)
    it = np.nditer(x, flags=["multi_index"])
    while not it.finished:
        idx = it.multi_index
        xp = x.copy()
        xp[idx] += eps
        xm = x.copy()
        xm[idx] -= eps
        g[idx] = (fn(xp) - fn(xm)) / (2 * eps)
        it.iternext()
    return g


def _grad_of(body):
    """body(pd) -> leaf tensors after its backward; their grads."""
    def run(pd):
        return [t.grad for t in body(pd)]
    return both(run)


def test_simple_backward():
    def body(pd):
        x = pd.to_tensor([1.0, 2.0, 3.0], stop_gradient=False)
        (x * x).sum().backward()
        return [x]
    ref, got = _grad_of(body)
    close(ref, got)
    np.testing.assert_allclose(got[0].numpy(), [2, 4, 6])


def test_chain_backward():
    def body(pd):
        x = pd.to_tensor([2.0], stop_gradient=False)
        y = x * 3
        (y * y).backward()
        return [x]
    ref, got = _grad_of(body)
    close(ref, got)
    np.testing.assert_allclose(got[0].numpy(), [36.0])


def test_grad_accumulation():
    def body(pd):
        x = pd.to_tensor([1.0], stop_gradient=False)
        (x * 2 + x * 3).backward()
        return [x]
    ref, got = _grad_of(body)
    close(ref, got)
    np.testing.assert_allclose(got[0].numpy(), [5.0])


def test_multiple_backward_accumulates():
    def body(pd):
        x = pd.to_tensor([1.0], stop_gradient=False)
        (x * 2).backward()
        (x * 3).backward()
        return [x]
    ref, got = _grad_of(body)
    close(ref, got)
    np.testing.assert_allclose(got[0].numpy(), [5.0])


def test_clear_grad():
    def run(pd):
        x = pd.to_tensor([1.0], stop_gradient=False)
        (x * 2).backward()
        x.clear_grad()
        return x.grad
    assert both(run) == (None, None)


def test_no_grad():
    def run(pd):
        x = pd.to_tensor([1.0], stop_gradient=False)
        with pd.no_grad():
            y = x * 2
        return y.stop_gradient
    assert both(run) == (True, True)


def test_matmul_grad_numeric():
    rng = np.random.RandomState(0)
    a_np = rng.randn(3, 4).astype(np.float32)
    b_np = rng.randn(4, 2).astype(np.float32)

    def body(pd):
        a = pd.to_tensor(a_np, stop_gradient=False)
        b = pd.to_tensor(b_np, stop_gradient=False)
        (a @ b).sum().backward()
        return [a, b]
    ref, got = _grad_of(body)
    close(ref, got)
    na = numeric_grad(lambda ap: (ap @ b_np.astype(np.float64)).sum(), a_np)
    nb = numeric_grad(lambda bp: (a_np.astype(np.float64) @ bp).sum(), b_np)
    np.testing.assert_allclose(got[0].numpy(), na, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got[1].numpy(), nb, rtol=1e-3, atol=1e-3)


UNARY = [
    (lambda pd, x: pd.exp(x).sum(), lambda x: np.exp(x).sum()),
    (lambda pd, x: pd.tanh(x).sum(), lambda x: np.tanh(x).sum()),
    (lambda pd, x: pd.nn.functional.sigmoid(x).sum(),
     lambda x: (1 / (1 + np.exp(-x))).sum()),
    (lambda pd, x: (x ** 3).mean(), lambda x: (x ** 3).mean()),
    (lambda pd, x: pd.nn.functional.softmax(x).max(), None),
]


@pytest.mark.parametrize("op,ref_fn", UNARY)
def test_unary_grads_numeric(op, ref_fn):
    rng = np.random.RandomState(1)
    x_np = rng.randn(2, 5).astype(np.float32) * 0.5

    def body(pd):
        x = pd.to_tensor(x_np, stop_gradient=False)
        op(pd, x).backward()
        return [x]
    ref, got = _grad_of(body)
    close(ref, got)
    if ref_fn is None:
        return
    import paddle_tpu_torch as pp

    def fwd(xp):
        return float(op(pp, pp.to_tensor(xp.astype(np.float32))).numpy())
    n = numeric_grad(fwd, x_np)
    np.testing.assert_allclose(got[0].numpy(), n, rtol=1e-2, atol=1e-2)


def test_paddle_grad_api():
    def run(pd):
        x = pd.to_tensor([3.0], stop_gradient=False)
        (g,) = pd.grad([(x * x).sum()], [x])
        return [g, x.grad is None]
    ref, got = both(run)
    close(ref, got)
    assert got[1] is True
    np.testing.assert_allclose(got[0].numpy(), [6.0])


def test_grad_wrt_intermediate():
    def run(pd):
        x = pd.to_tensor([2.0], stop_gradient=False)
        y = x * 3
        (gy,) = pd.grad([(y * y).sum()], [y])
        return gy
    ref, got = both(run)
    close(ref, got)
    np.testing.assert_allclose(got.numpy(), [12.0])


def test_register_hook():
    def run(pd):
        x = pd.to_tensor([1.0], stop_gradient=False)
        seen = []
        x.register_hook(lambda g: seen.append(g.numpy().copy()))
        (x * 2).backward()
        return seen
    ref, got = both(run)
    close(ref, got)
    assert len(got) == 1


def test_hook_modifies_grad():
    def body(pd):
        x = pd.to_tensor([1.0], stop_gradient=False)
        x.register_hook(lambda g: g * 10)
        (x * 2).backward()
        return [x]
    ref, got = _grad_of(body)
    close(ref, got)
    np.testing.assert_allclose(got[0].numpy(), [20.0])


def test_retain_graph():
    def body(pd):
        x = pd.to_tensor([1.0], stop_gradient=False)
        y = x * 2
        y.backward(retain_graph=True)
        y.backward()
        return [x]
    ref, got = _grad_of(body)
    close(ref, got)
    np.testing.assert_allclose(got[0].numpy(), [4.0])


def test_double_backward_raises_without_retain():
    def run(pd):
        x = pd.to_tensor([1.0], stop_gradient=False)
        y = (x * 2) * 3
        y.backward()
        with pytest.raises(RuntimeError):
            y.backward()
        return True
    assert both(run) == (True, True)


def _double(pd):
    class Double(pd.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return x * 2

        @staticmethod
        def backward(ctx, grad):
            return grad * 2
    return Double


def test_pylayer():
    def body(pd):
        x = pd.to_tensor([1.0, 2.0], stop_gradient=False)
        _double(pd).apply(x).sum().backward()
        return [x]
    ref, got = _grad_of(body)
    close(ref, got)
    np.testing.assert_allclose(got[0].numpy(), [2.0, 2.0])


def test_stop_gradient_cuts_graph():
    def run(pd):
        x = pd.to_tensor([1.0], stop_gradient=False)
        return (((x * 2).detach()) * 3).stop_gradient
    assert both(run) == (True, True)


def test_int_inputs_not_differentiated():
    def body(pd):
        x = pd.to_tensor([1.0, 2.0, 3.0], stop_gradient=False)
        idx = pd.to_tensor([0, 2])
        pd.gather(x, idx).sum().backward()
        return [x]
    ref, got = _grad_of(body)
    close(ref, got)
    np.testing.assert_allclose(got[0].numpy(), [1.0, 0.0, 1.0])


def test_pylayer_stop_gradient_alignment():
    def run(pd):
        class TwoIn(pd.autograd.PyLayer):
            @staticmethod
            def forward(ctx, x, w):
                return x * w

            @staticmethod
            def backward(ctx, g):
                return None, g * 5.0

        x = pd.to_tensor([2.0])
        w = pd.to_tensor([3.0], stop_gradient=False)
        TwoIn.apply(x, w).sum().backward()
        return [w.grad, x.grad is None]
    ref, got = both(run)
    close(ref, got)
    assert got[1] is True
    np.testing.assert_allclose(got[0].numpy(), [5.0])


def test_pylayer_saved_tensor_is_method():
    def body(pd):
        class Square(pd.autograd.PyLayer):
            @staticmethod
            def forward(ctx, x):
                ctx.save_for_backward(x)
                return x * x

            @staticmethod
            def backward(ctx, g):
                (x,) = ctx.saved_tensor()
                return g * 2.0 * x

        x = pd.to_tensor([3.0], stop_gradient=False)
        Square.apply(x).sum().backward()
        return [x]
    ref, got = _grad_of(body)
    close(ref, got)
    np.testing.assert_allclose(got[0].numpy(), [6.0])


def test_backward_nonscalar_defaults_to_ones():
    def body(pd):
        x = pd.to_tensor([[1.0, 2.0], [3.0, 4.0]], stop_gradient=False)
        (x * 3.0).backward()
        return [x]
    ref, got = _grad_of(body)
    close(ref, got)
    np.testing.assert_allclose(got[0].numpy(), np.full((2, 2), 3.0))


def test_embedding_padding_idx_no_grad():
    from _torch_eager import carry
    import paddle_tpu as jp
    import paddle_tpu_torch as pp
    jemb = jp.nn.Embedding(5, 3, padding_idx=0)
    pemb = carry(jemb, pp.nn.Embedding(5, 3, padding_idx=0))
    grads = []
    for pd, emb in ((jp, jemb), (pp, pemb)):
        ids = pd.to_tensor([[0, 1], [2, 0]])
        emb(ids).sum().backward()
        grads.append(emb.weight.grad)
    close(grads[0], grads[1])
    g = grads[1].numpy()
    np.testing.assert_allclose(g[0], np.zeros(3))
    assert np.abs(g[1]).sum() > 0


def test_higher_order_grad_create_graph():
    def run(pd):
        x = pd.to_tensor(np.array([2.0, 3.0], np.float32))
        x.stop_gradient = False
        y = x * x * x
        g1 = pd.grad(y, x, create_graph=True)[0]
        g2 = pd.grad(g1.sum(), x, create_graph=True)[0]
        g3 = pd.grad(g2.sum(), x)[0]
        return [g1, g2, g3, g1.stop_gradient]
    ref, got = both(run)
    close(ref, got)
    np.testing.assert_allclose(got[0].numpy(), [12.0, 27.0])
    np.testing.assert_allclose(got[2].numpy(), [6.0, 6.0])
    assert got[3] is False


def test_backward_through_create_graph_grad():
    def body(pd):
        x = pd.to_tensor(np.array([1.5], np.float32))
        x.stop_gradient = False
        gz = pd.grad(pd.sin(x), x, create_graph=True)[0]
        (gz * gz).backward()
        return [x]
    ref, got = _grad_of(body)
    close(ref, got, rtol=1e-5)
    np.testing.assert_allclose(got[0].numpy(),
                               -2 * np.cos(1.5) * np.sin(1.5), rtol=1e-5)


def test_higher_order_multi_input():
    def run(pd):
        a = pd.to_tensor(np.array([1.0], np.float32))
        b = pd.to_tensor(np.array([2.0], np.float32))
        a.stop_gradient = False
        b.stop_gradient = False
        ga, gb = pd.grad(a * b + a * a, [a, b], create_graph=True)
        return [ga, gb, pd.grad(ga, a)[0]]
    ref, got = both(run)
    close(ref, got)
    np.testing.assert_allclose(got[2].numpy(), [2.0])
