"""Optimizer multi-step trajectories of the port against numpy
transcriptions of the reference kernels AND against the JAX package's
(tests/test_optimizer_oracle.py case for case, its oracles unchanged):
six steps with varying gradients; the port to rtol 1e-5 of the JAX
package, and both to the oracle at the JAX test's tolerance."""
import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as pp
from _torch_eager import eager_state  # noqa: F401
from _torch_threads import torch_threads  # noqa: F401

P0 = np.array([1.0, -2.0, 0.5, 3.0], np.float32)
GRADS = [np.array(g, np.float32) for g in (
    [0.1, -0.2, 0.3, -0.4], [0.5, 0.1, -0.2, 0.3],
    [-0.3, 0.2, 0.1, 0.6], [0.2, -0.5, 0.4, -0.1],
    [0.0, 0.3, -0.6, 0.2], [0.4, -0.1, 0.2, 0.1])]
LR = 0.1


def _run(paddle, ctor_kwargs, cls_name):
    p = paddle.to_tensor(P0.copy(), stop_gradient=False)
    opt = getattr(paddle.optimizer, cls_name)(
        learning_rate=LR, parameters=[p], **ctor_kwargs)
    for g in GRADS:
        loss = paddle.sum(p * paddle.to_tensor(g))
        loss.backward()
        opt.step()
        opt.clear_grad()
    return np.asarray(p.numpy(), np.float64)


def run_paddle(ctor_kwargs, cls_name):
    """The port's trajectory, held to the JAX package's (rtol 1e-5, atol
    1e-6: the port's bias corrections are f32 on the card, the JAX eager
    path's f64 on the host), then returned for the oracle check."""
    ref = _run(jp, _kw(jp, ctor_kwargs), cls_name)
    got = _run(pp, _kw(pp, ctor_kwargs), cls_name)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    return got


def _kw(paddle, ctor_kwargs):
    return {k: (paddle.regularizer.L2Decay(v._coeff)
                if type(v).__name__ == "L2Decay" else v)
            for k, v in ctor_kwargs.items()}


def _check(actual, expect, tol=1e-5):
    np.testing.assert_allclose(actual, expect, rtol=tol, atol=tol)


def test_sgd():
    x = P0.astype(np.float64).copy()
    for g in GRADS:
        x -= LR * g
    _check(run_paddle({}, "SGD"), x)


@pytest.mark.parametrize("nesterov", (False, True))
def test_momentum(nesterov):
    # momentum_kernel_impl.h:48-52: v = mu*v + g;
    # nesterov: p -= (g + mu*v)*lr ; else p -= lr*v
    mu = 0.9
    x = P0.astype(np.float64).copy()
    v = np.zeros(4)
    for g in GRADS:
        v = mu * v + g
        x -= LR * ((g + mu * v) if nesterov else v)
    _check(run_paddle({"momentum": mu, "use_nesterov": nesterov},
                      "Momentum"), x)


def test_adam():
    b1, b2, eps = 0.9, 0.999, 1e-8
    x = P0.astype(np.float64).copy()
    m = np.zeros(4)
    v = np.zeros(4)
    for t, g in enumerate(GRADS, 1):
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mhat = m / (1 - b1 ** t)
        vhat = v / (1 - b2 ** t)
        x -= LR * mhat / (np.sqrt(vhat) + eps)
    _check(run_paddle({"epsilon": eps}, "Adam"), x)


def test_adamw_decoupled():
    # adam_functors.h:648: p -= lr*coeff*p BEFORE the adam step
    b1, b2, eps, coeff = 0.9, 0.999, 1e-8, 0.05
    x = P0.astype(np.float64).copy()
    m = np.zeros(4)
    v = np.zeros(4)
    for t, g in enumerate(GRADS, 1):
        x -= LR * coeff * x
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        x -= LR * (m / (1 - b1 ** t)) / (np.sqrt(v / (1 - b2 ** t)) + eps)
    _check(run_paddle({"epsilon": eps, "weight_decay": coeff}, "AdamW"), x)


def test_adagrad():
    eps = 1e-6
    x = P0.astype(np.float64).copy()
    acc = np.zeros(4)
    for g in GRADS:
        acc += g * g
        x -= LR * g / (np.sqrt(acc) + eps)
    _check(run_paddle({"epsilon": eps}, "Adagrad"), x)


def test_adadelta():
    # adadelta_kernel_impl.h:60-82: eps inside both sqrts, lr-scaled update
    rho, eps = 0.95, 1e-6
    x = P0.astype(np.float64).copy()
    eg = np.zeros(4)
    ed = np.zeros(4)
    for g in GRADS:
        eg = rho * eg + (1 - rho) * g * g
        upd = -np.sqrt(ed + eps) / np.sqrt(eg + eps) * g
        x += LR * upd
        ed = rho * ed + (1 - rho) * upd * upd
    _check(run_paddle({"rho": rho, "epsilon": eps}, "Adadelta"), x)


def test_adamax():
    # adamax_kernel_impl.h:60-68: u = max(|g|, beta2*u + eps),
    # p -= lr/(1-b1^t) * m/u  (no eps in the division)
    b1, b2, eps = 0.9, 0.999, 1e-8
    x = P0.astype(np.float64).copy()
    m = np.zeros(4)
    u = np.zeros(4)
    for t, g in enumerate(GRADS, 1):
        m = b1 * m + (1 - b1) * g
        u = np.maximum(np.abs(g), b2 * u + eps)
        x -= (LR / (1 - b1 ** t)) * m / u
    _check(run_paddle({"epsilon": eps}, "Adamax"), x)


@pytest.mark.parametrize("centered", (False, True))
def test_rmsprop(centered):
    # rmsprop_kernel_impl.h:108/:158: eps INSIDE sqrt; centered subtracts
    # the squared mean-grad
    rho, eps, mu = 0.95, 1e-6, 0.9
    x = P0.astype(np.float64).copy()
    ms = np.zeros(4)
    mg = np.zeros(4)
    mom = np.zeros(4)
    for g in GRADS:
        ms = rho * ms + (1 - rho) * g * g
        if centered:
            mg = rho * mg + (1 - rho) * g
            denom = np.sqrt(ms - mg * mg + eps)
        else:
            denom = np.sqrt(ms + eps)
        mom = mu * mom + LR * g / denom
        x -= mom
    _check(run_paddle({"rho": rho, "epsilon": eps, "momentum": mu,
                       "centered": centered}, "RMSProp"), x)


def test_adam_weight_decay_is_l2_coupled():
    """Plain Adam with weight_decay folds L2 into the GRADIENT (coupled),
    unlike AdamW — regularizer semantics, optimizer.py _wd_grad."""
    b1, b2, eps, wd = 0.9, 0.999, 1e-8, 0.05
    x = P0.astype(np.float64).copy()
    m = np.zeros(4)
    v = np.zeros(4)
    for t, g in enumerate(GRADS, 1):
        gg = g + wd * x
        m = b1 * m + (1 - b1) * gg
        v = b2 * v + (1 - b2) * gg * gg
        x -= LR * (m / (1 - b1 ** t)) / (np.sqrt(v / (1 - b2 ** t)) + eps)
    _check(run_paddle({"epsilon": eps,
                       "weight_decay": jp.regularizer.L2Decay(wd)},
                      "Adam"), x, tol=1e-4)
