"""jit.capture_step of the port against the JAX package's
(tests/test_capture_step.py case for case).  On the CPU the port runs the
captured step eagerly under the capture contract; each case holds it to
the JAX package's captured step (one XLA program) from the same weights,
and, where the JAX test compares captured with eager, to the port's own
eager step too.  Losses and parameters to rtol 2e-5 / atol 1e-6 (the JAX
test's tolerance; 5e-5 through BatchNorm).  The same cases on the card,
captured as a CUDA graph, are in tests/test_torch_eager_cuda.py."""
import numpy as np
import pytest

from _torch_eager import carry, close, eager_state  # noqa: F401
from _torch_threads import torch_threads  # noqa: F401

import paddle_tpu as jp
import paddle_tpu_torch as pp

TOL = dict(rtol=2e-5, atol=1e-6)


def _mlp(pd, seed=0):
    pd.seed(seed)
    return pd.nn.Sequential(pd.nn.Linear(16, 32), pd.nn.ReLU(),
                            pd.nn.Linear(32, 4))


def _mlp_pair(seed=0):
    jn = _mlp(jp, seed)
    return jn, carry(jn, _mlp(pp, seed))


def _data_np(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(8, 16).astype(np.float32),
            rng.randn(8, 4).astype(np.float32))


def _run_steps(step_fn, x, y, n):
    return [float(step_fn(x, y).numpy()) for _ in range(n)]


def _step(pd, net, opt):
    F = pd.nn.functional

    def step(x, y):
        loss = F.mse_loss(net(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss
    return step


def _params(net):
    return {k: p.numpy() for k, p in net.named_parameters()}


def test_captured_matches_eager():
    xn, yn = _data_np()
    jn, pc = _mlp_pair(7)
    pe = carry(jn, _mlp(pp, 7))
    runs = {}
    for tag, pd, net, cap in (("jax", jp, jn, True), ("cap", pp, pc, True),
                              ("eager", pp, pe, False)):
        opt = pd.optimizer.AdamW(learning_rate=0.01,
                                 parameters=net.parameters())
        step = _step(pd, net, opt)
        if cap:
            step = pd.jit.capture_step(step, models=net, optimizers=opt)
        runs[tag] = (_run_steps(step, pd.to_tensor(xn), pd.to_tensor(yn), 4),
                     _params(net))
    close(runs["jax"], runs["cap"], **TOL)
    close(runs["eager"], runs["cap"], rtol=0, atol=0)


def test_single_trace_across_calls():
    xn, yn = _data_np(1)
    for pd in (jp, pp):
        net = _mlp(pd, 1)
        opt = pd.optimizer.SGD(learning_rate=0.1,
                               parameters=net.parameters())
        traces = []
        inner = _step(pd, net, opt)

        def step(x, y):
            traces.append(1)
            return inner(x, y)
        cap = pd.jit.capture_step(step, models=net, optimizers=opt)
        _run_steps(cap, pd.to_tensor(xn), pd.to_tensor(yn), 3)
        # the JAX step traces once; the port's CPU step runs each call
        # (on the card it is captured once: tests/test_torch_eager_cuda.py)
        assert len(traces) == (1 if pd is jp else 3)


def test_lr_scheduler_between_steps():
    xn, yn = _data_np(2)
    jn, pc = _mlp_pair(3)
    pe = carry(jn, _mlp(pp, 3))
    out = {}
    for tag, pd, net, cap in (("jax", jp, jn, True), ("cap", pp, pc, True),
                              ("eager", pp, pe, False)):
        sched = pd.optimizer.lr.StepDecay(learning_rate=0.1, step_size=1,
                                          gamma=0.1)
        opt = pd.optimizer.SGD(learning_rate=sched,
                               parameters=net.parameters())
        step = _step(pd, net, opt)
        if cap:
            step = pd.jit.capture_step(step, models=net, optimizers=opt)
        for _ in range(3):
            step(pd.to_tensor(xn), pd.to_tensor(yn))
            sched.step()
        out[tag] = _params(net)
    close(out["jax"], out["cap"], **TOL)
    close(out["eager"], out["cap"], rtol=0, atol=0)


def test_scaler_inf_skips_and_decays():
    xn, yn = _data_np(4)
    jn, pn = _mlp_pair(4)
    out = []
    for pd, net in ((jp, jn), (pp, pn)):
        opt = pd.optimizer.AdamW(learning_rate=0.01,
                                 parameters=net.parameters())
        scaler = pd.amp.GradScaler(init_loss_scaling=1024.0,
                                   incr_every_n_steps=1000,
                                   decr_every_n_nan_or_inf=1)
        F = pd.nn.functional

        def step(x, y):
            loss = F.mse_loss(net(x), y)
            scaler.scale(loss).backward()
            scaler.step(opt)
            scaler.update()
            opt.clear_grad()
            return loss
        cap = pd.jit.capture_step(step, models=net, optimizers=opt,
                                  scalers=scaler)
        x, y = pd.to_tensor(xn), pd.to_tensor(yn)
        cap(x, y)
        before = _params(net)
        cap(pd.to_tensor(np.full((8, 16), np.inf, np.float32)), y)
        after = _params(net)
        for k in before:
            np.testing.assert_array_equal(after[k], before[k], err_msg=k)
        assert float(scaler.get_loss_scaling().numpy()) == 512.0
        cap(x, y)
        final = _params(net)
        for k in before:
            assert not np.array_equal(final[k], before[k])
        out.append(final)
    close(out[0], out[1], **TOL)


def test_dropout_rng_advances_across_steps():
    xn, yn = _data_np(5)
    pp.seed(42)
    net = pp.nn.Sequential(pp.nn.Linear(16, 64), pp.nn.Dropout(0.5),
                           pp.nn.Linear(64, 4))
    opt = pp.optimizer.SGD(learning_rate=0.0, parameters=net.parameters())
    cap = pp.jit.capture_step(_step(pp, net, opt), models=net,
                              optimizers=opt)
    x, y = pp.to_tensor(xn), pp.to_tensor(yn)
    losses = [float(cap(x, y).numpy()) for _ in range(3)]
    assert len(set(losses)) > 1, "dropout mask frozen across captured steps"


def test_host_sync_inside_step_raises():
    xn, yn = _data_np(6)
    for pd in (jp, pp):
        net = _mlp(pd, 6)
        opt = pd.optimizer.SGD(learning_rate=0.1,
                               parameters=net.parameters())
        F = pd.nn.functional

        def step(x, y):
            loss = F.mse_loss(net(x), y)
            float(loss.numpy())
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss
        cap = pd.jit.capture_step(step, models=net, optimizers=opt)
        with pytest.raises(Exception, match="host sync|Tracer|concrete"):
            cap(pd.to_tensor(xn), pd.to_tensor(yn))


def test_uncleared_grads_raise():
    xn, yn = _data_np(8)
    msgs = []
    for pd in (jp, pp):
        net = _mlp(pd, 8)
        opt = pd.optimizer.SGD(learning_rate=0.1,
                               parameters=net.parameters())
        F = pd.nn.functional

        def step(x, y):
            loss = F.mse_loss(net(x), y)
            loss.backward()
            opt.step()
            return loss
        cap = pd.jit.capture_step(step, models=net, optimizers=opt)
        with pytest.raises(RuntimeError, match="clear_grad") as e:
            cap(pd.to_tensor(xn), pd.to_tensor(yn))
        msgs.append(str(e.value).split(" for ")[0])
    assert msgs[0] == msgs[1]


def test_captured_step_with_o2_master_weights():
    xn, yn = _data_np(11)

    def make(pd):
        return pd.nn.Sequential(pd.nn.Linear(16, 32), pd.nn.ReLU(),
                                pd.nn.Linear(32, 4))
    jn = make(jp)
    pn = carry(jn, make(pp))
    out = []
    for pd, net in ((jp, jn), (pp, pn)):
        net = pd.amp.decorate(net, level="O2", dtype="bfloat16")
        opt = pd.optimizer.AdamW(learning_rate=1e-4,
                                 parameters=net.parameters())
        scaler = pd.amp.GradScaler(init_loss_scaling=256.0)
        F = pd.nn.functional

        def step(x, y):
            with pd.amp.auto_cast(level="O2"):
                loss = F.mse_loss(net(x).astype("float32"), y)
            scaler.scale(loss).backward()
            scaler.step(opt)
            scaler.update()
            opt.clear_grad()
            return loss
        cap = pd.jit.capture_step(step, models=net, optimizers=opt,
                                  scalers=scaler)
        x, y = pd.to_tensor(xn), pd.to_tensor(yn)
        losses = [float(cap(x, y).numpy()) for _ in range(5)]
        assert losses[-1] < losses[0]
        out.append(losses)
    # bf16 forward: the two packages' bf16 matmuls round differently
    close(out[0], out[1], rtol=2e-2, atol=1e-3)
    import torch
    for _, p in pn.named_parameters():
        assert p._master_weight.dtype == torch.float32
        np.testing.assert_array_equal(
            p.numpy(), p._master_weight.to(torch.bfloat16).float().numpy())


def test_grad_accumulation_two_captured_fns():
    xn, yn = _data_np(13)
    x2n = xn[::-1].copy()
    jn_e, pc = _mlp_pair(21)
    pe = carry(jn_e, _mlp(pp, 21))
    jc = _mlp(jp, 21)
    carry(jn_e, jc)
    out = {}
    for tag, pd, net in (("eager", pp, pe),):
        opt = pd.optimizer.SGD(learning_rate=0.1, parameters=net.parameters())
        for xb in (xn, x2n):
            loss = pd.nn.functional.mse_loss(net(pd.to_tensor(xb)),
                                             pd.to_tensor(yn))
            (loss * 0.5).backward()
        opt.step()
        opt.clear_grad()
        out[tag] = _params(net)
    for tag, pd, net in (("jax", jp, jc), ("cap", pp, pc)):
        opt = pd.optimizer.SGD(learning_rate=0.1, parameters=net.parameters())
        F = pd.nn.functional

        def accum(xb, y):
            loss = F.mse_loss(net(xb), y)
            (loss * 0.5).backward()
            return loss

        def update(xb, y):
            loss = F.mse_loss(net(xb), y)
            (loss * 0.5).backward()
            opt.step()
            opt.clear_grad()
            return loss
        cap_a = pd.jit.capture_step(accum, models=net, optimizers=opt,
                                    grad_accumulation=True)
        cap_u = pd.jit.capture_step(update, models=net, optimizers=opt,
                                    grad_accumulation=True)
        cap_a(pd.to_tensor(xn), pd.to_tensor(yn))
        cap_u(pd.to_tensor(x2n), pd.to_tensor(yn))
        out[tag] = _params(net)
    close(out["jax"], out["cap"], **TOL)
    close(out["eager"], out["cap"], **TOL)


def test_batchnorm_running_stats_under_capture():
    rng = np.random.RandomState(3)
    xn = rng.randn(8, 4, 6, 6).astype(np.float32)
    yn = rng.randn(8, 2).astype(np.float32)

    def make(pd):
        pd.seed(11)
        return pd.nn.Sequential(
            pd.nn.Conv2D(4, 3, 3, padding=1), pd.nn.BatchNorm2D(3),
            pd.nn.ReLU(), pd.nn.Flatten(), pd.nn.Linear(3 * 36, 2))
    jn = make(jp)
    pc, pe = carry(jn, make(pp)), carry(jn, make(pp))
    out = {}
    for tag, pd, net, cap in (("jax", jp, jn, True), ("cap", pp, pc, True),
                              ("eager", pp, pe, False)):
        opt = pd.optimizer.SGD(learning_rate=0.05,
                               parameters=net.parameters())
        step = _step(pd, net, opt)
        if cap:
            step = pd.jit.capture_step(step, models=net, optimizers=opt)
        x, y = pd.to_tensor(xn), pd.to_tensor(yn)
        losses = _run_steps(step, x, y, 4)
        bn = net[1]
        stats = [bn._mean.numpy(), bn._variance.numpy()]
        net.eval()
        out[tag] = (losses, stats, net(x).numpy())
    close(out["jax"], out["cap"], rtol=5e-5, atol=1e-6)
    close(out["eager"], out["cap"], rtol=0, atol=0)


def test_signature_keys_shape_dtype_structure_and_values():
    import torch
    from paddle_tpu_torch.jit.step import signature
    x = pp.to_tensor(np.zeros((8, 4), np.float32))
    key = signature(((x, 1.0), {"flag": True}))
    # same shapes, other numbers: one key (numbers ride as device scalars)
    assert signature(((pp.to_tensor(np.ones((8, 4), np.float32)), 0.5),
                      {"flag": False})) == key
    others = [
        ((pp.to_tensor(np.zeros((1, 4), np.float32)), 1.0), {"flag": True}),
        ((pp.to_tensor(np.zeros((8, 4), np.float64)), 1.0), {"flag": True}),
        ((x, 1), {"flag": True}),                 # int, not float
        ((x,), {"flag": True}),                   # fewer leaves
        ([x, 1.0], {"flag": True}),               # list, not tuple
        ((x, 1.0), {"other": True}),
        ((x, 1.0), {"flag": True, "mode": "sum"}),
    ]
    keys = [signature(t) for t in others]
    assert key not in keys and len(set(keys)) == len(keys)
    # non-number leaves key by value
    assert signature(("sum",)) != signature(("mean",))
    assert signature(("sum",)) == signature(("sum",))
    assert signature(x) == ("tensor", (8, 4), torch.float32,
                            torch.device("cpu"))


def test_lift_scalars_makes_device_tensors():
    import torch
    from paddle_tpu_torch.jit.step import lift_scalars
    x = pp.to_tensor(np.ones((2, 3), np.float32))
    (a, w, n, f, s), kw = lift_scalars(
        ((x, 0.5, 3, True, "tag"), {"k": np.float32(2.0)}),
        torch.device("cpu"), clone=True)
    assert a._data is not x._data and torch.equal(a._data, x._data)
    assert (w._data.dtype, w._data.dim(), float(w._data)) == \
        (torch.float32, 0, 0.5)
    assert (n._data.dtype, int(n._data)) == (torch.int64, 3)
    assert (f._data.dtype, bool(f._data)) == (torch.bool, True)
    assert s == "tag"
    assert float(kw["k"]._data) == 2.0 and isinstance(kw["k"], pp.Tensor)


def test_new_batch_shape_and_python_weight_match_the_jit_step():
    """Batches of 8, 1, 5, 8 rows and loss weights 1, 1, 0.5, 2: the JAX
    step retraces per shape and takes the weight as a dynamic scalar; the
    port's step gives its losses and parameters."""
    rng = np.random.RandomState(17)
    batches = [(rng.randn(n, 16).astype(np.float32),
                rng.randn(n, 4).astype(np.float32)) for n in (8, 1, 5, 8)]
    weights = [1.0, 1.0, 0.5, 2.0]
    jn, pn = _mlp_pair(19)
    out = []
    for pd, net in ((jp, jn), (pp, pn)):
        opt = pd.optimizer.SGD(learning_rate=0.1,
                               parameters=net.parameters())
        F = pd.nn.functional

        def step(x, y, w):
            loss = F.mse_loss(net(x), y) * w
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss
        cap = pd.jit.capture_step(step, models=net, optimizers=opt)
        losses = [float(cap(pd.to_tensor(x), pd.to_tensor(y), w).numpy())
                  for (x, y), w in zip(batches, weights)]
        out.append((losses, _params(net)))
    close(out[0], out[1], **TOL)


def test_branch_on_python_scalar_is_a_host_read():
    xn, yn = _data_np(23)
    for pd in (jp, pp):
        net = _mlp(pd, 23)
        opt = pd.optimizer.SGD(learning_rate=0.1,
                               parameters=net.parameters())
        F = pd.nn.functional

        def step(x, y, w):
            loss = F.mse_loss(net(x), y)
            if w > 0.5:
                loss = loss * 2.0
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss
        cap = pd.jit.capture_step(step, models=net, optimizers=opt)
        with pytest.raises(Exception, match="host sync|Tracer|concrete"):
            cap(pd.to_tensor(xn), pd.to_tensor(yn), 1.0)
