"""tests/test_misc_ops.py's examples through the JAX package and the
port (``both``): the fill family, the norm helpers, sequence_mask and
gather_tree (the reference's docstring example), top_p_sampling's nucleus
of one token, temporal_shift, edit_distance unnormalized and normalized,
viterbi_decode without BOS/EOS tags against a brute force over every tag
sequence, overlapping as_strided windows, and the linalg examples (cond,
cholesky_inverse of either triangle, ormqr against LAPACK's Q, a rank-2
svd_lowrank).  Floats to rtol 1e-5 (1e-4 through factorizations),
integers exactly; svd_lowrank's draw is each package's own, so only its
reconstruction is compared."""
import itertools

import numpy as np
import pytest

from _torch_eager import both, close, eager_state  # noqa: F401
from _torch_threads import torch_threads  # noqa: F401


def t(pd, a):
    return pd.to_tensor(np.asarray(a))


def test_fill_family_and_diag_embed():
    def run(pd):
        d = t(pd, np.asarray([1., 2., 3.], np.float32))
        z = pd.ones([2, 2])
        pd.fill_(z, 7.0)
        return [pd.fill_diagonal(pd.zeros([3, 3]), 5.0).numpy(),
                pd.fill_diagonal(pd.zeros([3, 3]), 2.0, offset=1).numpy(),
                pd.fill_diagonal_tensor(pd.zeros([3, 3]), d).numpy(),
                pd.diag_embed(d).numpy(), pd.diag_embed(d, offset=1).numpy(),
                z.numpy()]
    ref, got = both(run)
    close(ref, got, rtol=0, atol=0)
    np.testing.assert_allclose(got[5], np.full((2, 2), 7.0))


def test_norm_helpers():
    def run(pd):
        x = t(pd, np.asarray([[3., 4.], [0., 0.]], np.float32))
        return [pd.frobenius_norm(x).numpy(), pd.squared_l2_norm(x).numpy(),
                pd.mean_all(x).numpy(),
                pd.clip_by_norm(t(pd, np.asarray([6., 8.], np.float32)),
                                5.0).numpy(),
                pd.clip_by_norm(t(pd, np.asarray([0.3, 0.4], np.float32)),
                                5.0).numpy()]
    ref, got = both(run)
    close(ref, got, rtol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got[3]), 5.0, rtol=1e-5)


def test_sequence_mask_and_gather_tree():
    ids = np.asarray([[[2, 2], [6, 1]], [[3, 9], [6, 1]], [[0, 1], [9, 0]]],
                     np.int64)
    parents = np.asarray([[[0, 0], [1, 1]], [[1, 0], [1, 0]],
                          [[0, 0], [0, 1]]], np.int64)

    def run(pd):
        lens = t(pd, np.asarray([1, 3, 2], np.int64))
        return [pd.sequence_mask(lens, maxlen=4).numpy(),
                pd.sequence_mask(lens).numpy(),
                pd.gather_tree(t(pd, ids), t(pd, parents)).numpy()]
    ref, got = both(run)
    close(ref, got)
    np.testing.assert_array_equal(
        got[2], [[[2, 2], [1, 6]], [[3, 3], [6, 1]], [[0, 1], [9, 0]]])


def test_top_p_sampling_nucleus_of_one():
    probs = np.asarray([[0.7, 0.2, 0.05, 0.05], [0.25, 0.25, 0.25, 0.25]],
                       np.float32)

    def run(pd):
        vals, ids = pd.top_p_sampling(t(pd, probs),
                                      t(pd, np.asarray([0.5, 0.9],
                                                       np.float32)), seed=3)
        return vals.numpy(), ids.numpy()
    (rv, ri), (gv, gi) = both(run)
    assert ri[0, 0] == gi[0, 0] == 0          # the nucleus is {token 0}
    np.testing.assert_allclose(gv[0, 0], rv[0, 0], rtol=1e-6)
    assert 0 <= gi[1, 0] < 4
    np.testing.assert_allclose(gv[1, 0], probs[1, gi[1, 0]], rtol=1e-6)


def test_temporal_shift():
    x = np.arange(4 * 4 * 2 * 2, dtype=np.float32).reshape(4, 4, 2, 2)
    for fmt in ("NCHW", "NHWC"):
        a = x if fmt == "NCHW" else x.transpose(0, 2, 3, 1).copy()
        ref, got = both(lambda pd: pd.temporal_shift(
            t(pd, a), seg_num=2, shift_ratio=0.25, data_format=fmt).numpy())
        close(ref, got, rtol=0, atol=0)


@pytest.mark.parametrize("normalized", [False, True])
def test_edit_distance(normalized):
    hyp = np.asarray([[1, 2, 3], [4, 5, 6]], np.int64)
    ref_ = np.asarray([[1, 2, 4, 0], [4, 5, 6, 7]], np.int64)

    def run(pd):
        d, n = pd.edit_distance(t(pd, hyp), t(pd, ref_),
                                normalized=normalized,
                                input_length=t(pd, np.asarray([3, 3])),
                                label_length=t(pd, np.asarray([3, 4])))
        return d.numpy(), n.numpy()
    ref, got = both(run)
    close(ref, got)
    want = [1 / 3, 1 / 4] if normalized else [1.0, 1.0]
    np.testing.assert_allclose(got[0].reshape(-1), want, rtol=1e-6)


@pytest.mark.parametrize("tags", [False, True])
def test_viterbi_decode(tags):
    rng = np.random.RandomState(0)
    B, T, N = 2, 5, 3
    emis = rng.rand(B, T, N).astype(np.float32)
    trans = rng.rand(N + 2 if tags else N, N + 2 if tags else N) \
        .astype(np.float32)
    lens = np.asarray([5, 3], np.int64)

    def run(pd):
        s, p = pd.viterbi_decode(t(pd, emis), t(pd, trans), t(pd, lens),
                                 include_bos_eos_tag=tags)
        return s.numpy(), p.numpy()
    ref, got = both(run)
    close(ref, got, rtol=1e-5)
    if not tags:
        best, best_path = -1e9, None
        for seq in itertools.product(range(N), repeat=T):
            s = emis[0, 0, seq[0]] + sum(
                trans[seq[i - 1], seq[i]] + emis[0, i, seq[i]]
                for i in range(1, T))
            if s > best:
                best, best_path = s, seq
        np.testing.assert_allclose(got[0][0], best, rtol=1e-5)
        np.testing.assert_array_equal(got[1][0], best_path)


def test_as_strided_overlapping_windows():
    x = np.arange(12, dtype=np.float32)
    ref, got = both(lambda pd: pd.as_strided(t(pd, x), [5, 4],
                                             [2, 1]).numpy())
    close(ref, got, rtol=0, atol=0)
    np.testing.assert_allclose(got, np.lib.stride_tricks.as_strided(
        x, (5, 4), (8, 4)))


def test_linalg_examples():
    A = np.asarray([[4., 0.], [0., 2.]], np.float32)
    B2 = np.asarray([[4., 1.], [1., 3.]], np.float32)
    U = np.linalg.cholesky(B2).T.astype(np.float32)
    h, tau = (np.asarray([[-4.0, 1.0, 2.0], [0.4, -3.0, 1.0],
                          [0.2, 0.1, -2.5], [0.3, 0.5, 0.6],
                          [0.1, 0.2, 0.3]], np.float32),
              np.asarray([1.2, 1.5, 1.1], np.float32))
    y = np.random.RandomState(1).rand(5, 2).astype(np.float32)

    def run(pd):
        L = pd.ops.linalg
        chol = L.cholesky(t(pd, B2))
        return [L.cond(t(pd, A)).numpy(),
                L.cholesky_inverse(chol).numpy(),
                L.cholesky_inverse(t(pd, U), upper=True).numpy(),
                L.ormqr(t(pd, h), t(pd, tau), t(pd, y)).numpy(),
                L.ormqr(t(pd, h), t(pd, tau), t(pd, y.T.copy()),
                        left=False, transpose=True).numpy()]
    ref, got = both(run)
    close(ref, got, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got[0], 2.0, rtol=1e-5)
    np.testing.assert_allclose(got[1] @ B2, np.eye(2), atol=1e-5)
    np.testing.assert_allclose(got[2] @ B2, np.eye(2), atol=1e-5)


def test_svd_lowrank_rebuilds_a_rank_2_matrix():
    R = np.random.RandomState(2)
    M = (R.rand(10, 2) @ R.rand(2, 8)).astype(np.float32)

    def run(pd):
        pd.seed(4)
        u, s, v = pd.ops.linalg.svd_lowrank(t(pd, M), q=4)
        return u.numpy() @ np.diag(s.numpy()) @ v.numpy().T
    ref, got = both(run)
    np.testing.assert_allclose(got, M, atol=1e-4)
    np.testing.assert_allclose(got, ref, atol=1e-4)
