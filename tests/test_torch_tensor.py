"""Eager Tensor of the port against the JAX package's
(tests/test_tensor.py case for case): creation, dtype rules, methods,
indexing.  Each case runs the same code on both packages with the same
inputs; values equal to rtol 1e-6 (f32 elementwise, reductions, matmul at
these sizes), integers and dtypes exactly."""
import numpy as np

from _torch_eager import both, close, eager_state  # noqa: F401
from _torch_threads import torch_threads  # noqa: F401


def test_to_tensor_dtypes():
    def run(pd):
        return [pd.to_tensor(1).dtype == pd.int64,
                pd.to_tensor(1.0).dtype == pd.float32,
                pd.to_tensor(True).dtype == pd.bool,
                pd.to_tensor([1, 2]).dtype == pd.int64,
                pd.to_tensor(np.zeros((2, 2), np.float64)).dtype
                == pd.float64]
    ref, got = both(run)
    assert ref == got == [True] * 5


def test_basic_math():
    def run(pd):
        x = pd.to_tensor([1.0, 2.0, 3.0])
        y = pd.to_tensor([4.0, 5.0, 6.0])
        return [x + y, x * y, y / x, x - 1, 2 - x, x ** 2, -x]
    ref, got = both(run)
    close(ref, got)
    np.testing.assert_allclose(got[4].numpy(), [1, 0, -1])


def test_matmul():
    a_np = np.arange(6, dtype=np.float32).reshape(2, 3)
    b_np = np.arange(12, dtype=np.float32).reshape(3, 4)

    def run(pd):
        a, b = pd.to_tensor(a_np), pd.to_tensor(b_np)
        return [a @ b, pd.matmul(a, b)]
    ref, got = both(run)
    close(ref, got)
    np.testing.assert_allclose(got[0].numpy(), a_np @ b_np)


def test_shape_props():
    def run(pd):
        x = pd.zeros([2, 3, 4])
        return [x.shape, x.ndim, x.size, x.numel(), len(x),
                x.dtype == pd.float32]
    ref, got = both(run)
    assert ref == got == [[2, 3, 4], 3, 24, 24, 2, True]


def test_methods():
    x_np = np.arange(12, dtype=np.float32).reshape(3, 4)

    def run(pd):
        x = pd.to_tensor(x_np)
        return [x.sum().item(), x.mean().item(), x.max().item(),
                x.reshape([4, 3]).shape, x.transpose([1, 0]).shape,
                x.flatten().shape, x.unsqueeze(0).shape,
                x.astype("int32").dtype == pd.int32]
    ref, got = both(run)
    assert ref == got
    assert got[:3] == [66.0, 5.5, 11.0]


def test_indexing():
    x_np = np.arange(24, dtype=np.float32).reshape(4, 6)

    def run(pd):
        x = pd.to_tensor(x_np)
        idx = pd.to_tensor([0, 2])
        return [x[0], x[1:3, 2], x[:, -1], x[idx], x[x > 20]]
    ref, got = both(run)
    close(ref, got)
    np.testing.assert_allclose(got[4].numpy(), [21, 22, 23])


def test_setitem():
    def run(pd):
        x = pd.zeros([3, 3])
        x[1] = 5.0
        x[0, 0] = 7.0
        return x
    ref, got = both(run)
    close(ref, got)
    assert got.numpy()[0, 0] == 7.0


def test_comparison_and_where():
    def run(pd):
        x = pd.to_tensor([1.0, 5.0, 3.0])
        y = pd.to_tensor([2.0, 2.0, 2.0])
        return [x > y, pd.where(x > y, x, y)]
    ref, got = both(run)
    close(ref, got)
    np.testing.assert_allclose(got[1].numpy(), [2, 5, 3])


def test_concat_split():
    def run(pd):
        a, b = pd.ones([2, 3]), pd.zeros([2, 3])
        c = pd.concat([a, b], axis=0)
        return [c] + pd.split(c, 2, axis=0)
    ref, got = both(run)
    close(ref, got)
    assert got[0].shape == [4, 3] and len(got) == 3


def test_creation_ops():
    def run(pd):
        return [pd.arange(5).dtype == pd.int64, pd.arange(1, 4),
                pd.full([2, 2], 3), pd.eye(3), pd.tril(pd.ones([3, 3]))]
    ref, got = both(run)
    close(ref, got)
    assert got[0] is True and got[2].numpy().sum() == 12


def test_clone_detach():
    def run(pd):
        x = pd.to_tensor([1.0, 2.0], stop_gradient=False)
        return [x.detach().stop_gradient, x.clone().stop_gradient]
    ref, got = both(run)
    assert ref == got == [True, False]


def test_cast_astype_roundtrip():
    def run(pd):
        x = pd.to_tensor([1.5, 2.5])
        y = x.astype("float64")
        z = y.astype(pd.bfloat16)
        return [y.dtype == pd.float64, z.dtype == pd.bfloat16, y, z]
    ref, got = both(run)
    close(ref, got)
    assert got[:2] == [True, True]
