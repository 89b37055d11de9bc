"""Optimizers and LR schedulers of the port against the JAX package's
(tests/test_optimizer.py case for case).  Each case runs the same
training code on both packages from the same weights (carried across as
numpy); parameters to rtol 1e-5 / atol 1e-6 after the steps, and the JAX
test's own convergence bounds hold on the port."""
import numpy as np
import pytest

from _torch_eager import both, carry, close, eager_state  # noqa: F401
from _torch_threads import torch_threads  # noqa: F401

import paddle_tpu as jp
import paddle_tpu_torch as pp

TOL = dict(rtol=1e-5, atol=1e-6)


def _quadratic_step(pd, optimizer_fn, steps=50):
    w = pd.to_tensor([0.0], stop_gradient=False)
    w.name = "w_test"
    o = optimizer_fn(pd, [w])
    for _ in range(steps):
        loss = ((w - 3.0) ** 2).sum()
        loss.backward()
        o.step()
        o.clear_grad()
    return float(w.numpy()[0])


def _quad(fn, steps=50):
    return both(lambda pd: _quadratic_step(pd, fn, steps))


def test_sgd_converges():
    ref, got = _quad(lambda pd, ps: pd.optimizer.SGD(learning_rate=0.1,
                                                     parameters=ps))
    close(ref, got, **TOL)
    assert abs(got - 3.0) < 1e-3


def test_momentum_converges():
    ref, got = _quad(lambda pd, ps: pd.optimizer.Momentum(
        learning_rate=0.05, momentum=0.9, parameters=ps), 150)
    close(ref, got, **TOL)
    assert abs(got - 3.0) < 1e-2


def test_adam_converges():
    ref, got = _quad(lambda pd, ps: pd.optimizer.Adam(
        learning_rate=0.3, parameters=ps), 100)
    close(ref, got, **TOL)
    assert abs(got - 3.0) < 1e-2


def test_adamw_decoupled_decay():
    def run(pd):
        w = pd.to_tensor([1.0], stop_gradient=False)
        o = pd.optimizer.AdamW(learning_rate=0.1, parameters=[w],
                               weight_decay=0.5)
        (w * 0.0).sum().backward()
        o.step()
        return w
    ref, got = both(run)
    close(ref, got, **TOL)
    assert float(got.numpy()[0]) < 1.0


def test_sgd_matches_manual():
    def run(pd):
        w = pd.to_tensor([2.0], stop_gradient=False)
        o = pd.optimizer.SGD(learning_rate=0.1, parameters=[w])
        (3.0 * w).sum().backward()
        o.step()
        return w
    ref, got = both(run)
    close(ref, got, **TOL)
    np.testing.assert_allclose(got.numpy(), [2.0 - 0.1 * 3.0], rtol=1e-6)


def test_adam_first_step_matches_manual():
    def run(pd):
        w = pd.to_tensor([1.0], stop_gradient=False)
        o = pd.optimizer.Adam(learning_rate=0.1, parameters=[w])
        (2.0 * w).sum().backward()
        o.step()
        return w
    ref, got = both(run)
    close(ref, got, **TOL)
    np.testing.assert_allclose(got.numpy(), [1.0 - 0.1], rtol=1e-4)


def test_optimizer_state_dict():
    """The JAX optimizer's state dict, as numpy, loads into the port's and
    both then take the same next step."""
    ws, opts = [], []
    for pd in (jp, pp):
        w = pd.to_tensor([1.0], stop_gradient=False)
        w.name = "w_sd"
        o = pd.optimizer.Adam(learning_rate=0.1, parameters=[w])
        (w * 2).sum().backward()
        o.step()
        o.clear_grad()
        ws.append(w)
        opts.append(o)
    sd = opts[0].state_dict()
    assert sd["global_step"] == opts[1].state_dict()["global_step"] == 1
    w2 = pp.to_tensor(ws[0].numpy(), stop_gradient=False)
    w2.name = "w_sd"
    o2 = pp.optimizer.Adam(learning_rate=0.1, parameters=[w2])
    o2.set_state_dict({k: (v if k == "global_step" else np.asarray(v.numpy()))
                       for k, v in sd.items()})
    assert o2._global_step == 1
    for pd, w, o in ((jp, ws[0], opts[0]), (pp, w2, o2)):
        (w * 2).sum().backward()
        o.step()
    close(ws[0], w2, **TOL)


def test_lr_scheduler_step_decay():
    def run(pd):
        sched = pd.optimizer.lr.StepDecay(learning_rate=1.0, step_size=2,
                                          gamma=0.5)
        w = pd.to_tensor([1.0], stop_gradient=False)
        o = pd.optimizer.SGD(learning_rate=sched, parameters=[w])
        lrs = [o.get_lr()]
        sched.step()
        sched.step()
        return lrs + [o.get_lr()]
    ref, got = both(run)
    assert ref == got == [1.0, 0.5]


def test_cosine_schedule():
    def run(pd):
        s = pd.optimizer.lr.CosineAnnealingDecay(learning_rate=1.0, T_max=10)
        vals = []
        for _ in range(10):
            vals.append(s())
            s.step()
        return vals
    ref, got = both(run)
    assert ref == got
    assert got[0] == pytest.approx(1.0) and got[-1] < 0.1


def test_linear_warmup():
    def run(pd):
        s = pd.optimizer.lr.LinearWarmup(learning_rate=1.0, warmup_steps=5,
                                         start_lr=0.0, end_lr=1.0)
        v0 = s()
        for _ in range(6):
            s.step()
        return [v0, s()]
    ref, got = both(run)
    assert ref == got
    assert got[1] == pytest.approx(1.0) and got[0] < 0.5


def test_grad_clip_in_optimizer():
    def run(pd):
        w = pd.to_tensor([1.0, 1.0], stop_gradient=False)
        o = pd.optimizer.SGD(learning_rate=1.0, parameters=[w],
                             grad_clip=pd.nn.ClipGradByGlobalNorm(0.1))
        (w * pd.to_tensor([30.0, 40.0])).sum().backward()
        o.step()
        return w
    ref, got = both(run)
    close(ref, got, **TOL)
    np.testing.assert_allclose(got.numpy(), [1 - 0.06, 1 - 0.08], rtol=1e-4)


def test_weight_decay_l2():
    def run(pd):
        w = pd.to_tensor([1.0], stop_gradient=False)
        o = pd.optimizer.SGD(learning_rate=0.1, parameters=[w],
                             weight_decay=pd.regularizer.L2Decay(0.5))
        (w * 0.0).sum().backward()
        o.step()
        return w
    ref, got = both(run)
    close(ref, got, **TOL)
    np.testing.assert_allclose(got.numpy(), [1.0 - 0.1 * 0.5], rtol=1e-5)


@pytest.mark.parametrize("ctor", ["NAdam", "RAdam", "ASGD", "Rprop"])
def test_new_optimizers_converge(ctor):
    jp.seed(0)
    jnet = jp.nn.Linear(4, 1)
    pnet = carry(jnet, pp.nn.Linear(4, 1))
    x_np = np.random.RandomState(0).rand(16, 4).astype("float32")
    y_np = (np.random.RandomState(1).rand(16, 1) * 2).astype("float32")
    losses = []
    for pd, net in ((jp, jnet), (pp, pnet)):
        opt = getattr(pd.optimizer, ctor)(learning_rate=0.05,
                                          parameters=net.parameters())
        x, y = pd.to_tensor(x_np), pd.to_tensor(y_np)
        curve = []
        for _ in range(25):
            loss = ((net(x) - y) ** 2).mean()
            curve.append(float(loss.numpy()))
            loss.backward()
            opt.step()
            opt.clear_grad()
        curve.append(float(loss.numpy()))
        losses.append(curve)
    close(losses[0], losses[1], rtol=1e-5, atol=1e-6)
    close(jnet.state_dict(), pnet.state_dict(), **TOL)
    assert losses[1][-1] < losses[1][0] * 0.9, (ctor, losses[1])


def test_lbfgs_rosenbrock_style():
    jp.seed(0)
    jnet = jp.nn.Linear(2, 1, bias_attr=False)
    pnet = carry(jnet, pp.nn.Linear(2, 1, bias_attr=False))
    out = []
    for pd, net in ((jp, jnet), (pp, pnet)):
        A = pd.to_tensor(np.asarray([[1.0, 0.5]], np.float32))
        target = pd.to_tensor(np.asarray([[3.0]], np.float32))
        opt = pd.optimizer.LBFGS(learning_rate=1.0, max_iter=10,
                                 line_search_fn="strong_wolfe",
                                 parameters=net.parameters())

        def closure():
            opt.clear_grad()
            loss = ((net(A) - target) ** 2).mean()
            loss.backward()
            return loss

        for _ in range(4):
            loss = opt.step(closure)
        out.append(float(loss.numpy()))
        with pytest.raises(ValueError, match="closure"):
            opt.step()
    assert out[1] < 1e-4
    close(jnet.state_dict(), pnet.state_dict(), rtol=1e-4, atol=1e-5)
