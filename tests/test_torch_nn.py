"""nn.Layer, layers and functionals of the port against the JAX
package's (the cases of tests/test_nn.py whose layers this slice ports:
pooling, MultiHeadAttention and the transformer layers are not ported
yet).  Weights are the JAX layer's, carried across by state dict; inputs
are numpy, the same for both.  Values to rtol 1e-5 / atol 1e-6 (f32), the
JAX test's own checks on the port at its tolerances."""
import numpy as np

from _torch_eager import both, carry, close, eager_state  # noqa: F401
from _torch_threads import torch_threads  # noqa: F401

import paddle_tpu as jp
import paddle_tpu_torch as pp

TOL = dict(rtol=1e-5, atol=1e-6)
RNG = np.random.RandomState(0)


def _x(*shape):
    return RNG.randn(*shape).astype(np.float32)


def _pair(make):
    """make(pd) for both packages, the port's weights the JAX layer's."""
    jl = make(jp)
    return jl, carry(jl, make(pp))


def test_linear():
    jl, pl = _pair(lambda pd: pd.nn.Linear(4, 3))
    x = _x(2, 4)
    ref, got = jl(jp.to_tensor(x)), pl(pp.to_tensor(x))
    close(ref, got, **TOL)
    assert got.shape == [2, 3]
    np.testing.assert_allclose(
        got.numpy(), x @ pl.weight.numpy() + pl.bias.numpy(), rtol=1e-5,
        atol=1e-5)


def _net(pd):
    class Net(pd.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = pd.nn.Linear(4, 8)
            self.fc2 = pd.nn.Linear(8, 2)

        def forward(self, x):
            return self.fc2(pd.nn.functional.relu(self.fc1(x)))
    return Net()


def test_layer_registry():
    jn, pn = _pair(_net)
    assert [n for n, _ in jn.named_parameters()] == \
        [n for n, _ in pn.named_parameters()]
    assert len(pn.parameters()) == 4
    x = _x(3, 4)
    close(jn(jp.to_tensor(x)), pn(pp.to_tensor(x)), **TOL)


def test_state_dict_roundtrip():
    net = pp.nn.Linear(3, 3)
    net2 = pp.nn.Linear(3, 3)
    net2.set_state_dict(net.state_dict())
    np.testing.assert_allclose(net.weight.numpy(), net2.weight.numpy())
    jn = jp.nn.Linear(3, 3)
    carry(jn, net2)
    close(jn.state_dict(), net2.state_dict())


def test_sequential_and_layerlist():
    jn, pn = _pair(lambda pd: pd.nn.Sequential(
        pd.nn.Linear(4, 8), pd.nn.ReLU(), pd.nn.Linear(8, 2)))
    x = _x(2, 4)
    close(jn(jp.to_tensor(x)), pn(pp.to_tensor(x)), **TOL)
    assert len(pn) == 3
    ll = both(lambda pd: len(pd.nn.LayerList(
        [pd.nn.Linear(2, 2) for _ in range(3)]).parameters()))
    assert ll == (6, 6)


def test_conv2d_shapes():
    jn, pn = _pair(lambda pd: pd.nn.Conv2D(3, 8, 3, stride=1, padding=1))
    x = _x(2, 3, 16, 16)
    ref, got = jn(jp.to_tensor(x)), pn(pp.to_tensor(x))
    close(ref, got, rtol=1e-5, atol=1e-5)
    assert got.shape == [2, 8, 16, 16]


def test_conv2d_matches_reference():
    def run(pd):
        conv = pd.nn.Conv2D(1, 1, 3, padding=0, bias_attr=False)
        conv.weight.set_value(np.ones((1, 1, 3, 3), np.float32))
        return conv(pd.ones([1, 1, 5, 5]))
    ref, got = both(run)
    close(ref, got)
    np.testing.assert_allclose(got.numpy(), np.full((1, 1, 3, 3), 9.0))


def test_batchnorm_train_eval():
    jn, pn = _pair(lambda pd: pd.nn.BatchNorm2D(4))
    x = _x(8, 4, 5, 5)
    outs = []
    for pd, bn in ((jp, jn), (pp, pn)):
        bn.train()
        y = bn(pd.to_tensor(x))
        bn.eval()
        outs.append([y, bn(pd.to_tensor(x)), bn._mean, bn._variance])
    close(outs[0], outs[1], rtol=1e-5, atol=1e-5)
    out = outs[1][0].numpy()
    assert abs(out.mean()) < 1e-4 and abs(out.std() - 1.0) < 1e-2


def test_layernorm():
    jn, pn = _pair(lambda pd: pd.nn.LayerNorm(8))
    x = _x(2, 4, 8)
    ref, got = jn(jp.to_tensor(x)), pn(pp.to_tensor(x))
    close(ref, got, **TOL)
    out = got.numpy()
    np.testing.assert_allclose(out.mean(-1), np.zeros((2, 4)), atol=1e-5)
    np.testing.assert_allclose(out.std(-1), np.ones((2, 4)), atol=1e-2)


def test_rmsnorm():
    jn, pn = _pair(lambda pd: pd.nn.RMSNorm(8))
    x = _x(2, 8)
    got = pn(pp.to_tensor(x))
    close(jn(jp.to_tensor(x)), got, **TOL)
    ref = x / np.sqrt((x ** 2).mean(-1, keepdims=True) + 1e-6)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_embedding():
    jn, pn = _pair(lambda pd: pd.nn.Embedding(10, 4))
    ids = [[1, 2], [3, 4]]
    got = pn(pp.to_tensor(ids))
    close(jn(jp.to_tensor(ids)), got)
    assert got.shape == [2, 2, 4]
    np.testing.assert_allclose(got.numpy()[0, 0], pn.weight.numpy()[1])


def test_dropout_modes():
    """Masks differ between the packages (torch's generator against
    threefry); the rates and the eval identity are held on both."""
    def run(pd):
        drop = pd.nn.Dropout(0.5)
        x = pd.ones([100, 100])
        drop.train()
        y = drop(x).numpy()
        drop.eval()
        return [float((y == 0).mean()), sorted(set(np.unique(y))),
                drop(x).numpy()]
    ref, got = both(run)
    assert 0.3 < got[0] < 0.7 and 0.3 < ref[0] < 0.7
    assert ref[1] == got[1] == [0.0, 2.0]
    close(ref[2], got[2])


def test_cross_entropy():
    def run(pd):
        logits = pd.to_tensor([[2.0, 1.0, 0.1], [0.5, 2.5, 0.3]],
                              stop_gradient=False)
        loss = pd.nn.functional.cross_entropy(logits, pd.to_tensor([0, 1]))
        loss.backward()
        return [loss, logits.grad]
    ref, got = both(run)
    close(ref, got, **TOL)
    p = np.exp(np.array([[2.0, 1.0, 0.1], [0.5, 2.5, 0.3]]))
    p = p / p.sum(-1, keepdims=True)
    np.testing.assert_allclose(got[0].numpy(), -np.log(p[[0, 1], [0, 1]])
                               .mean(), rtol=1e-5)


def test_cross_entropy_soft_label():
    a, b = _x(4, 5), _x(4, 5)

    def run(pd):
        soft = pd.nn.functional.softmax(pd.to_tensor(b))
        return pd.nn.functional.cross_entropy(pd.to_tensor(a), soft,
                                              soft_label=True)
    ref, got = both(run)
    close(ref, got, **TOL)
    assert got.shape == []


def test_mse_l1():
    def run(pd):
        a = pd.to_tensor([1.0, 2.0])
        b = pd.to_tensor([2.0, 4.0])
        return [pd.nn.functional.mse_loss(a, b),
                pd.nn.functional.l1_loss(a, b)]
    ref, got = both(run)
    close(ref, got)
    np.testing.assert_allclose([got[0].numpy(), got[1].numpy()], [2.5, 1.5])


def test_activations():
    def run(pd):
        F = pd.nn.functional
        x = pd.to_tensor([-1.0, 0.0, 2.0])
        return [F.relu(x), F.leaky_relu(x, 0.1), F.softmax(x), F.gelu(x),
                F.silu(x), F.sigmoid(x), F.tanh(x)]
    ref, got = both(run)
    close(ref, got, **TOL)
    np.testing.assert_allclose(got[1].numpy(), [-0.1, 0, 2])
    np.testing.assert_allclose(got[2].numpy().sum(), 1.0, rtol=1e-6)


def test_sdpa_causal_matches_manual():
    b, s, h, d = 1, 4, 2, 8
    q, k, v = _x(b, s, h, d), _x(b, s, h, d), _x(b, s, h, d)

    def run(pd):
        return pd.nn.functional.scaled_dot_product_attention(
            pd.to_tensor(q), pd.to_tensor(k), pd.to_tensor(v),
            is_causal=True)
    ref, got = both(run)
    close(ref, got, rtol=1e-5, atol=1e-5)
    qn, kn, vn = (a.transpose(0, 2, 1, 3) for a in (q, k, v))
    scores = qn @ kn.transpose(0, 1, 3, 2) / np.sqrt(d)
    scores = np.where(np.tril(np.ones((s, s), bool)), scores, -np.inf)
    e = np.exp(scores - scores.max(-1, keepdims=True))
    manual = ((e / e.sum(-1, keepdims=True)) @ vn).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(got.numpy(), manual, rtol=1e-4, atol=1e-4)


def test_clip_grad_by_global_norm():
    def run(pd):
        p = pd.to_tensor([3.0, 4.0], stop_gradient=False)
        (p * p).sum().backward()
        return pd.nn.ClipGradByGlobalNorm(1.0)([(p, p.grad)])[0][1]
    ref, got = both(run)
    close(ref, got, **TOL)
    np.testing.assert_allclose(got.numpy(), [0.6, 0.8], rtol=1e-5)


def test_grad_flows_through_layers():
    jn, pn = _pair(lambda pd: pd.nn.Sequential(
        pd.nn.Linear(4, 8), pd.nn.Tanh(), pd.nn.Linear(8, 1)))
    x = _x(4, 4)
    for pd, net in ((jp, jn), (pp, pn)):
        net(pd.to_tensor(x)).sum().backward()
    for (k, a), (_, b) in zip(jn.named_parameters(), pn.named_parameters()):
        assert b.grad is not None, k
        close(a.grad, b.grad, **TOL)
