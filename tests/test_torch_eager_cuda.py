"""The eager training surface on the card: ``jit.capture_step`` as a CUDA
graph held to the same step run eagerly, for the cases of
tests/test_capture_step.py (bit for bit where the graph replays the eager
kernels; the tolerance stated per case otherwise), and a ``Tensor``
through ``F.scaled_dot_product_attention`` and ``fused_rms_norm``
launching the flash forward, dK/dV and dQ kernels and the fused norm
kernel.  Marked ``cuda``; without a card it skips.  On the card:

    python -m pytest tests/test_torch_eager_cuda.py --noconftest -q
"""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def pp():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels and CUDA "
                    "graphs run on the card only)")
    import paddle_tpu_torch as pp
    torch.backends.cuda.matmul.allow_tf32 = False
    from paddle_tpu_torch.ops import _build
    _build.build(["flash_attention", "fused_norms"])
    return pp


def _data(pp, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (pp.Tensor(torch.randn((8, 16), generator=g, device="cuda")),
            pp.Tensor(torch.randn((8, 4), generator=g, device="cuda")))


def _mlp(pp, seed, dropout=False):
    pp.seed(seed)
    mid = [pp.nn.Dropout(0.5)] if dropout else [pp.nn.ReLU()]
    return pp.nn.Sequential(pp.nn.Linear(16, 32), *mid,
                            pp.nn.Linear(32, 4))


def _step(pp, net, opt, scaler=None):
    F = pp.nn.functional

    def step(x, y):
        loss = F.mse_loss(net(x), y)
        if scaler is None:
            loss.backward()
            opt.step()
        else:
            scaler.scale(loss).backward()
            scaler.step(opt)
            scaler.update()
        opt.clear_grad()
        return loss
    return step


def _pair(pp, make, n, data_seed=0, between=None):
    """(eager, captured) losses and parameters after n steps of the step
    make(pp) returns as (net, opt, step), from one seed."""
    out = []
    x, y = _data(pp, data_seed)
    for cap in (False, True):
        net, opt, step, extra = make(pp)
        if cap:
            step = pp.jit.capture_step(step, models=net, optimizers=opt,
                                       scalers=extra.get("scaler"))
        losses = []
        for _ in range(n):
            losses.append(float(step(x, y).numpy()))
            if between:
                between(extra)
        out.append((losses, [p._data.detach().clone()
                             for p in net.parameters()], extra))
    return out


def _bit_equal(e, c):
    assert e[0] == c[0]
    for a, b in zip(e[1], c[1]):
        assert torch.equal(a, b)


def test_captured_matches_eager(pp):
    def make(pp):
        net = _mlp(pp, 7)
        opt = pp.optimizer.AdamW(learning_rate=0.01,
                                 parameters=net.parameters())
        return net, opt, _step(pp, net, opt), {}
    _bit_equal(*_pair(pp, make, 4))


def test_replays_one_capture(pp):
    net = _mlp(pp, 1)
    opt = pp.optimizer.SGD(learning_rate=0.1, parameters=net.parameters())
    traces = []
    inner = _step(pp, net, opt)

    def step(x, y):
        traces.append(1)
        return inner(x, y)
    cap = pp.jit.capture_step(step, models=net, optimizers=opt)
    x, y = _data(pp, 1)
    for _ in range(3):
        cap(x, y)
    assert len(traces) == 2        # the warm-up and the capture


def _signature_run(pp, calls, captured):
    """Losses (host arrays, their dtypes kept) and parameters after the
    calls ``(x, y, w)`` of one SGD step from one seed, eagerly or through
    one capture_step; with the number of captures and traces."""
    net = _mlp(pp, 29)
    opt = pp.optimizer.SGD(learning_rate=0.1, parameters=net.parameters())
    F = pp.nn.functional
    traces = []

    def step(x, y, w):
        traces.append(1)
        loss = F.mse_loss(net(x), y) * w
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss
    fn = pp.jit.capture_step(step, models=net, optimizers=opt) \
        if captured else step
    losses = [fn(x, y, w).numpy() for x, y, w in calls]
    params = [p._data.detach().clone() for p in net.parameters()]
    return losses, params, getattr(fn, "num_captures", 0), len(traces)


def _batch(pp, seed, rows, dtype=torch.float32):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (pp.Tensor(torch.randn((rows, 16), generator=g, device="cuda")),
            pp.Tensor(torch.randn((rows, 4), generator=g, device="cuda")
                      .to(dtype)))


def _signature_case(pp, calls):
    (le, pe, _, _), (lc, pc, n, traces) = (
        _signature_run(pp, calls, False), _signature_run(pp, calls, True))
    assert [a.dtype for a in le] == [a.dtype for a in lc]
    assert all(np.array_equal(a, b) for a, b in zip(le, lc)), (le, lc)
    for a, b in zip(pe, pc):
        assert torch.equal(a, b)
    return n, traces


def test_second_batch_shape_captures_again(pp):
    b8, b5 = _batch(pp, 31, 8), _batch(pp, 32, 5)
    n, traces = _signature_case(pp, [(*b8, 1.0), (*b5, 1.0), (*b8, 1.0),
                                     (*b5, 1.0)])
    assert (n, traces) == (2, 4)      # warm-up and capture per signature


def test_broadcastable_batch_is_not_broadcast(pp):
    b8, b1 = _batch(pp, 33, 8), _batch(pp, 34, 1)
    n, _ = _signature_case(pp, [(*b8, 1.0), (*b1, 1.0), (*b8, 1.0)])
    assert n == 2


def test_other_dtype_is_not_cast(pp):
    b32, b64 = _batch(pp, 35, 8), _batch(pp, 35, 8, torch.float64)
    n, _ = _signature_case(pp, [(*b32, 1.0), (*b64, 1.0), (*b32, 1.0)])
    assert n == 2


def test_python_loss_weight_is_read_each_call(pp):
    b = _batch(pp, 36, 8)
    n, traces = _signature_case(pp, [(*b, 1.0), (*b, 0.5), (*b, 2.0),
                                     (*b, 0.25)])
    assert (n, traces) == (1, 2)


def test_lr_scheduler_between_steps(pp):
    def make(pp):
        net = _mlp(pp, 3)
        sched = pp.optimizer.lr.StepDecay(learning_rate=0.1, step_size=1,
                                          gamma=0.1)
        opt = pp.optimizer.SGD(learning_rate=sched,
                               parameters=net.parameters())
        return net, opt, _step(pp, net, opt), {"sched": sched}
    _bit_equal(*_pair(pp, make, 3, 2, between=lambda e: e["sched"].step()))


def test_scaler_inf_skips_and_decays(pp):
    net = _mlp(pp, 4)
    opt = pp.optimizer.AdamW(learning_rate=0.01, parameters=net.parameters())
    scaler = pp.amp.GradScaler(init_loss_scaling=1024.0,
                               incr_every_n_steps=1000,
                               decr_every_n_nan_or_inf=1)
    cap = pp.jit.capture_step(_step(pp, net, opt, scaler), models=net,
                              optimizers=opt, scalers=scaler)
    x, y = _data(pp, 4)
    cap(x, y)
    before = [p._data.detach().clone() for p in net.parameters()]
    cap(pp.Tensor(torch.full((8, 16), float("inf"), device="cuda")), y)
    for a, p in zip(before, net.parameters()):
        assert torch.equal(a, p._data)
    assert float(scaler.get_loss_scaling().numpy()) == 512.0
    cap(x, y)
    assert all(not torch.equal(a, p._data)
               for a, p in zip(before, net.parameters()))


def test_dropout_rng_advances_across_replays(pp):
    net = _mlp(pp, 42, dropout=True)
    opt = pp.optimizer.SGD(learning_rate=0.0, parameters=net.parameters())
    cap = pp.jit.capture_step(_step(pp, net, opt), models=net,
                              optimizers=opt)
    x, y = _data(pp, 5)
    losses = [float(cap(x, y).numpy()) for _ in range(3)]
    assert len(set(losses)) > 1, "dropout mask frozen across replays"


def test_host_sync_inside_step_raises(pp):
    net = _mlp(pp, 6)
    opt = pp.optimizer.SGD(learning_rate=0.1, parameters=net.parameters())
    inner = _step(pp, net, opt)

    def step(x, y):
        out = inner(x, y)
        float(out.numpy())
        return out
    cap = pp.jit.capture_step(step, models=net, optimizers=opt)
    with pytest.raises(RuntimeError, match="host sync"):
        cap(*_data(pp, 6))


def test_uncleared_grads_raise(pp):
    net = _mlp(pp, 8)
    opt = pp.optimizer.SGD(learning_rate=0.1, parameters=net.parameters())

    def step(x, y):
        loss = pp.nn.functional.mse_loss(net(x), y)
        loss.backward()
        opt.step()
        return loss
    cap = pp.jit.capture_step(step, models=net, optimizers=opt)
    with pytest.raises(RuntimeError, match="clear_grad"):
        cap(*_data(pp, 8))


def test_captured_step_with_o2_master_weights(pp):
    def make(pp):
        pp.seed(11)
        net = pp.amp.decorate(
            pp.nn.Sequential(pp.nn.Linear(16, 32), pp.nn.ReLU(),
                             pp.nn.Linear(32, 4)), level="O2",
            dtype="bfloat16")
        opt = pp.optimizer.AdamW(learning_rate=1e-4,
                                 parameters=net.parameters())
        scaler = pp.amp.GradScaler(init_loss_scaling=256.0)
        F = pp.nn.functional

        def step(x, y):
            with pp.amp.auto_cast(level="O2"):
                loss = F.mse_loss(net(x).astype("float32"), y)
            scaler.scale(loss).backward()
            scaler.step(opt)
            scaler.update()
            opt.clear_grad()
            return loss
        return net, opt, step, {"scaler": scaler}
    e, c = _pair(pp, make, 5, 11)
    _bit_equal(e, c)
    assert c[0][-1] < c[0][0]


def test_grad_accumulation_two_captured_fns(pp):
    x, y = _data(pp, 13)
    x2 = pp.Tensor(x._data.flip(0).contiguous())
    out = []
    for cap in (False, True):
        net = _mlp(pp, 21)
        opt = pp.optimizer.SGD(learning_rate=0.1,
                               parameters=net.parameters())
        F = pp.nn.functional

        def accum(xb, yb):
            loss = F.mse_loss(net(xb), yb)
            (loss * 0.5).backward()
            return loss

        def update(xb, yb):
            loss = accum(xb, yb)
            opt.step()
            opt.clear_grad()
            return loss
        if cap:
            accum_c = pp.jit.capture_step(accum, models=net, optimizers=opt,
                                          grad_accumulation=True)
            update_c = pp.jit.capture_step(update, models=net,
                                           optimizers=opt,
                                           grad_accumulation=True)
            for _ in range(2):
                accum_c(x, y)
                update_c(x2, y)
        else:
            for _ in range(2):
                accum(x, y)
                update(x2, y)
        out.append([p._data.detach().clone() for p in net.parameters()])
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_batchnorm_running_stats_under_capture(pp):
    g = torch.Generator(device="cuda").manual_seed(3)
    x = pp.Tensor(torch.randn((8, 4, 6, 6), generator=g, device="cuda"))
    y = pp.Tensor(torch.randn((8, 2), generator=g, device="cuda"))
    out = []
    for cap in (False, True):
        pp.seed(11)
        net = pp.nn.Sequential(
            pp.nn.Conv2D(4, 3, 3, padding=1), pp.nn.BatchNorm2D(3),
            pp.nn.ReLU(), pp.nn.Flatten(), pp.nn.Linear(3 * 36, 2))
        opt = pp.optimizer.SGD(learning_rate=0.05,
                               parameters=net.parameters())
        step = _step(pp, net, opt)
        if cap:
            step = pp.jit.capture_step(step, models=net, optimizers=opt)
        losses = [float(step(x, y).numpy()) for _ in range(4)]
        net.eval()
        out.append((losses, net[1]._mean._data.clone(),
                    net[1]._variance._data.clone(), net(x)._data.clone()))
    # cuDNN may pick another convolution algorithm under capture
    assert out[0][0] == pytest.approx(out[1][0], rel=5e-5, abs=1e-6)
    for a, b in zip(out[0][1:], out[1][1:]):
        torch.testing.assert_close(b, a, rtol=5e-5, atol=1e-6)


def test_tensor_attention_and_norm_launch_the_kernels(pp):
    from paddle_tpu_torch.incubate.nn.functional import fused_rms_norm
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused_norms as fn
    g = torch.Generator(device="cuda").manual_seed(0)
    B, S, H, D = 1, 256, 4, 128

    def t(*shape):
        x = pp.Tensor(torch.randn(shape, generator=g, device="cuda")
                      .to(torch.bfloat16))
        x.stop_gradient = False
        return x
    q, k, v = t(B, S, H, D), t(B, S, H, D), t(B, S, H, D)
    w = t(H * D)
    counts = (fa.fwd_launch_count, fa.dkdv_launch_count, fa.dq_launch_count,
              fn.rms_launch_count)
    a = pp.nn.functional.scaled_dot_product_attention(q, k, v,
                                                      is_causal=True)
    out = fused_rms_norm(a.reshape([B * S, H * D]), w)[0]
    out.astype("float32").sum().backward()
    after = (fa.fwd_launch_count, fa.dkdv_launch_count, fa.dq_launch_count,
             fn.rms_launch_count)
    assert [b - a_ for a_, b in zip(counts, after)] == [1, 1, 1, 1]
    ref = fa.flash_fwd_reference(q._data, k._data, v._data, True)[0]
    torch.testing.assert_close(a._data.float(), ref.float(), rtol=2e-2,
                               atol=2e-2)
    assert all(x.grad is not None for x in (q, k, v, w))
