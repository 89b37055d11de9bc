"""AMP of the port against the JAX package's (the cases of
tests/test_amp.py this slice covers: autocast lists, GradScaler, O2
decorate and master weights; amp.debugging and custom-op registration are
not ported yet).  Same inputs on both packages; f32 values to rtol 1e-6
(1e-5 after a matmul), values that went through a bf16 matmul to bf16's
resolution (rtol 1e-2: the packages accumulate the bf16 products in
different orders)."""
import numpy as np

from _torch_eager import both, carry, close, eager_state  # noqa: F401
from _torch_threads import torch_threads  # noqa: F401

import paddle_tpu as jp
import paddle_tpu_torch as pp
from paddle_tpu_torch.core import amp_state as pamp

A = np.random.RandomState(0).randn(8, 8).astype(np.float32)
B = np.random.RandomState(1).randn(8, 8).astype(np.float32)


def test_autocast_o1_dtype():
    def run(pd):
        a, b = pd.to_tensor(A), pd.to_tensor(B)
        with pd.amp.auto_cast(level="O1"):
            c = pd.matmul(a, b)
            s = pd.nn.functional.softmax(c)
        d = pd.matmul(a, b)
        return [c.dtype == pd.bfloat16, s.dtype == pd.float32,
                d.dtype == pd.float32, c, s, d]
    ref, got = both(run)
    assert ref[:3] == got[:3] == [True, True, True]
    close(ref[3:5], got[3:5], rtol=1e-2, atol=1e-2)
    close(ref[5], got[5], rtol=1e-5, atol=1e-5)


def test_autocast_custom_lists_restored():
    white0, black0 = set(pamp.WHITE_LIST), set(pamp.BLACK_LIST)

    def run(pd):
        with pd.amp.auto_cast(custom_black_list={"matmul"}):
            a = pd.to_tensor(A)
            c = pd.matmul(a, a)
        with pd.amp.auto_cast():
            c2 = pd.matmul(pd.to_tensor(A), pd.to_tensor(B))
        return [c.dtype == pd.float32, c2.dtype == pd.bfloat16]
    ref, got = both(run)
    assert ref == got == [True, True]
    assert pamp.WHITE_LIST == white0 and pamp.BLACK_LIST == black0


def test_grad_scaler_roundtrip():
    def run(pd):
        w = pd.to_tensor([1.0], stop_gradient=False)
        opt = pd.optimizer.SGD(learning_rate=0.1, parameters=[w])
        scaler = pd.amp.GradScaler(init_loss_scaling=1024.0)
        scaler.scale((w * 3.0).sum()).backward()
        scaler.unscale_(opt)
        g = w.grad.numpy().copy()
        scaler.step(opt)
        scaler.update()
        return [g, w, scaler.get_loss_scaling()]
    ref, got = both(run)
    close(ref, got)
    np.testing.assert_allclose(got[0], [3.0], rtol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), [1.0 - 0.3], rtol=1e-5)


def test_grad_scaler_inf_skips_step():
    def run(pd):
        w = pd.to_tensor([1.0], stop_gradient=False)
        opt = pd.optimizer.SGD(learning_rate=0.1, parameters=[w])
        scaler = pd.amp.GradScaler(init_loss_scaling=4.0)
        (w * 3.0).sum().backward()
        w.grad.set_value(np.asarray([np.inf], np.float32))
        scaler.step(opt)
        scaler.update()
        return [w, float(scaler.get_loss_scaling().numpy())]
    ref, got = both(run)
    close(ref, got)
    np.testing.assert_allclose(got[0].numpy(), [1.0])
    assert got[1] < 4.0


def test_o2_decorate_keeps_norms_fp32():
    def make(pd):
        return pd.nn.Sequential(pd.nn.Linear(4, 8), pd.nn.LayerNorm(8),
                                pd.nn.Linear(8, 2))
    jn = make(jp)
    pn = carry(jn, make(pp))
    x = np.random.RandomState(2).randn(2, 4).astype(np.float32)
    outs = []
    for pd, net in ((jp, jn), (pp, pn)):
        net = pd.amp.decorate(net, level="O2", dtype="bfloat16")
        assert net[0].weight.dtype == pd.bfloat16
        assert net[1].weight.dtype == pd.float32
        y = net(pd.to_tensor(x).astype("bfloat16"))
        outs.append(y)
    assert outs[1].shape == [2, 2]
    close(outs[0], outs[1], rtol=2e-2, atol=2e-2)


def test_o2_master_weights_accumulate_small_updates():
    jn = jp.nn.Linear(4, 4, bias_attr=False)
    pn = carry(jn, pp.nn.Linear(4, 4, bias_attr=False))
    w0 = pn.weight.numpy().copy()
    masters = []
    for pd, net in ((jp, jn), (pp, pn)):
        net = pd.amp.decorate(net, level="O2", dtype="bfloat16")
        opt = pd.optimizer.SGD(learning_rate=1.0,
                               parameters=net.parameters())
        g = np.full(net.weight.shape, 1e-4, np.float32)
        for _ in range(8):
            net.weight.grad = pd.to_tensor(g)
            opt.step()
            opt.clear_grad()
        masters.append(np.asarray(net.weight._master_weight, np.float32)
                       if pd is jp else
                       net.weight._master_weight.numpy())
    np.testing.assert_allclose(masters[1], masters[0], rtol=1e-6)
    np.testing.assert_allclose(masters[1], w0 - 8 * 1e-4, rtol=1e-5,
                               atol=1e-6)
    import torch
    np.testing.assert_array_equal(
        pn.weight.numpy(),
        pn.weight._master_weight.to(torch.bfloat16).float().numpy())
