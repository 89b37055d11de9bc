"""PyTorch port, distributed: the eager collectives and DataParallel.

- one 2-rank gloo launch through ``python -m
  paddle_tpu_torch.distributed.launch`` runs every collective on
  numpy-seeded inputs, to the expectations of the JAX package's
  cross-process test (tests/test_eager_distributed.py) and the
  definitions of the rest (AVG, PROD, MAX, new groups, ``sync_op=False``,
  scatter, gather, batched point-to-point, barrier);
- world 1 in process, with no process group and over a gloo group of one
  rank, against the JAX package's world-1 results;
- ``Group`` rank arithmetic, and ``_BucketReducer``'s bucket assignment,
  against the JAX package's;
- one 2-rank gloo ``DataParallel`` launch: after 3 SGD steps the
  parameters equal the single-process step's on the whole batch, with a
  shared layer and a microbatch accumulated under ``no_sync``;
- ``init_parallel_env`` with no CUDA and no explicit gloo raises.

Every launch runs under ``timeout=`` with OMP_NUM_THREADS=1; f32 to
1e-6."""
import os
import socket

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
from paddle_tpu.distributed import collective as jcoll
from paddle_tpu.distributed.parallel import _BucketReducer as JReducer
import paddle_tpu_torch.distributed as pdist
from paddle_tpu_torch.distributed import collective as pcoll
from paddle_tpu_torch.distributed.parallel import _BucketReducer as PReducer
import _torch_dist as td
from _torch_threads import torch_threads  # noqa: F401

TOL = 1e-6


def test_collectives_over_two_gloo_ranks(tmp_path):
    r, logs = td.launch(tmp_path, """
        import numpy as np
        import torch
        import paddle_tpu_torch.distributed as dist

        env = dist.init_parallel_env()
        rank, world = dist.get_rank(), dist.get_world_size()
        assert (env.rank, world, dist.get_backend()) == (rank, 2, "gloo")
        rng = np.random.RandomState(0)
        xs = [rng.randn(4).astype(np.float32) for _ in range(2)]
        mine = lambda: torch.from_numpy(xs[rank].copy())
        close = np.testing.assert_allclose

        # all_reduce SUM (the reference's expectation), AVG, MAX, PROD
        t = torch.full((4,), float(rank + 1))
        dist.all_reduce(t)
        close(t.numpy(), np.full((4,), 3.0))
        for op, want in ((dist.ReduceOp.SUM, xs[0] + xs[1]),
                         (dist.ReduceOp.AVG, (xs[0] + xs[1]) / 2),
                         (dist.ReduceOp.MAX, np.maximum(xs[0], xs[1])),
                         (dist.ReduceOp.MIN, np.minimum(xs[0], xs[1])),
                         (dist.ReduceOp.PROD, xs[0] * xs[1])):
            t = mine()
            dist.all_reduce(t, op)
            close(t.numpy(), want, rtol=1e-6)
        # sync_op=False: a task; AVG's division happens at wait()
        t = mine()
        task = dist.all_reduce(t, dist.ReduceOp.AVG, sync_op=False)
        assert task.wait() is t
        close(t.numpy(), (xs[0] + xs[1]) / 2, rtol=1e-6)

        # broadcast from rank 1
        t = torch.full((3,), float(rank))
        dist.broadcast(t, src=1)
        close(t.numpy(), np.full((3,), 1.0))

        # all_gather, to a list and stacked
        outs = []
        dist.all_gather(outs, torch.full((2,), float(rank)))
        assert len(outs) == 2
        close(outs[0].numpy(), np.zeros(2))
        close(outs[1].numpy(), np.ones(2))
        close(dist.all_gather(None, mine()).numpy(), np.stack(xs))

        # reduce (every member gets it, as in the reference)
        t = mine()
        dist.reduce(t, dst=0)
        close(t.numpy(), xs[0] + xs[1], rtol=1e-6)

        # reduce_scatter: rank r gets sum_i ins_i[r]
        out = torch.zeros(2)
        ins = [torch.full((2,), float(rank * 2 + i)) for i in range(2)]
        dist.reduce_scatter(out, ins)
        close(out.numpy(), np.full((2,), 2.0 if rank == 0 else 4.0))
        out = torch.zeros(2)
        dist.reduce_scatter(out, ins, op=dist.ReduceOp.AVG)
        close(out.numpy(), np.full((2,), 1.0 if rank == 0 else 2.0))

        # alltoall
        outs = []
        ins = [torch.full((2,), float(rank * 10 + i)) for i in range(2)]
        dist.alltoall(outs, ins)
        close(outs[0].numpy(), np.full((2,), 0.0 if rank == 0 else 1.0))
        close(outs[1].numpy(), np.full((2,), 10.0 if rank == 0 else 11.0))

        # scatter from rank 0, gather on every rank
        t = torch.zeros(3)
        dist.scatter(t, [torch.full((3,), 5.0 + i) for i in range(2)]
                     if rank == 0 else None, src=0)
        close(t.numpy(), np.full((3,), 5.0 + rank))
        got = dist.gather(mine(), [], dst=0)
        close(np.stack([g.numpy() for g in got]), np.stack(xs))

        # send/recv pair, then a batched pair each way
        if rank == 0:
            dist.send(torch.full((2,), 7.0), dst=1)
        else:
            buf = torch.zeros(2)
            dist.recv(buf, src=0)
            close(buf.numpy(), np.full((2,), 7.0))
        buf = torch.zeros(4)
        peer = 1 - rank
        tasks = dist.batch_isend_irecv(
            [dist.P2POp(dist.isend, mine(), peer),
             dist.P2POp(dist.irecv, buf, peer)])
        for task in tasks:
            task.wait()
        close(buf.numpy(), xs[peer])

        # all_gather_object
        objs = []
        dist.all_gather_object(objs, {"rank": rank, "tag": "x" * (rank + 1)})
        assert objs == [{"rank": 0, "tag": "x"}, {"rank": 1, "tag": "xx"}]

        # a new group over both ranks, and one of each rank alone
        g = dist.new_group([0, 1])
        assert (g.nranks, g.rank) == (2, rank)
        t = mine()
        dist.all_reduce(t, group=g)
        close(t.numpy(), xs[0] + xs[1], rtol=1e-6)
        solo = [dist.new_group([r]) for r in range(2)]
        t = mine()
        dist.all_reduce(t, group=solo[rank])
        close(t.numpy(), xs[rank])

        dist.barrier()
        dist.barrier(group=g)
        with open(f"ok_{rank}", "w") as f:
            f.write("pass")
        dist.destroy_process_group()
    """, 2, "gloo")
    assert r.returncode == 0, r.stderr[-3000:] + logs
    assert (tmp_path / "ok_0").exists() and (tmp_path / "ok_1").exists()


# ---------------------------------------------------------------------------
# world 1 in process
# ---------------------------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _world1_env(monkeypatch, **extra):
    for k in list(os.environ):
        if k.startswith("PADDLE_") or k in ("RANK", "WORLD_SIZE",
                                            "LOCAL_RANK"):
            monkeypatch.delenv(k)
    for k, v in extra.items():
        monkeypatch.setenv(k, v)


def _calls(d, wrap, unwrap):
    """Each world-1 collective of package d on seeded inputs, as numpy."""
    rng = np.random.RandomState(3)
    a, b = (rng.randn(2, 3).astype(np.float32) for _ in range(2))
    out = {}
    for op in ("SUM", "MAX", "MIN", "PROD", "AVG"):
        t = wrap(a)
        d.all_reduce(t, getattr(d.ReduceOp, op))
        out[f"all_reduce_{op}"] = unwrap(t)
    lst = []
    d.all_gather(lst, wrap(a))
    out["all_gather"] = [unwrap(x) for x in lst]
    out["all_gather_one"] = unwrap(d.all_gather(None, wrap(a)))
    objs = []
    d.all_gather_object(objs, {"k": [1, 2]})
    out["all_gather_object"] = objs
    t = wrap(a)
    d.broadcast(t, src=0)
    out["broadcast"] = unwrap(t)
    t = wrap(a)
    d.reduce(t, dst=0)
    out["reduce"] = unwrap(t)
    t = wrap(np.zeros_like(a))
    d.scatter(t, [wrap(b)], src=0)
    out["scatter"] = unwrap(t)
    t = wrap(np.zeros_like(a))
    d.reduce_scatter(t, [wrap(b)])
    out["reduce_scatter"] = unwrap(t)
    lst = []
    d.alltoall(lst, [wrap(b)])
    out["alltoall"] = [unwrap(x) for x in lst]
    d.send(wrap(b), dst=0)
    t = wrap(np.zeros_like(b))
    d.recv(t, src=0)
    out["send_recv"] = unwrap(t)
    d.barrier()
    return out


def _jax_world1():
    return _calls(jdist, lambda a: paddle.to_tensor(a),
                  lambda t: np.asarray(t.numpy()))


def _port_world1():
    return _calls(pdist, lambda a: torch.from_numpy(a.copy()),
                  lambda t: t.numpy().copy())


def _assert_same(got, want):
    assert set(got) == set(want)
    for k in want:
        if k == "all_gather_object":
            assert got[k] == want[k]
            continue
        g = got[k] if isinstance(got[k], list) else [got[k]]
        w = want[k] if isinstance(want[k], list) else [want[k]]
        assert len(g) == len(w), k
        for x, y in zip(g, w):
            assert x.shape == y.shape, k
            np.testing.assert_allclose(x, y, rtol=TOL, atol=TOL, err_msg=k)


@pytest.fixture
def jax_groups():
    """The JAX package's group registry, cleared for the test and put
    back after it."""
    saved = (dict(jcoll._groups), jcoll._default_group, jcoll.Group._next_id)
    jcoll.destroy_process_group()
    yield
    jcoll._groups.clear()
    jcoll._groups.update(saved[0])
    jcoll._default_group, jcoll.Group._next_id = saved[1:]


@pytest.fixture
def world1(monkeypatch, jax_groups):
    _world1_env(monkeypatch)
    pcoll.destroy_process_group()
    yield
    pcoll.destroy_process_group()


def test_world1_without_a_process_group_matches_the_reference(world1):
    _assert_same(_port_world1(), _jax_world1())


def test_world1_over_a_gloo_group_matches_the_reference(world1, monkeypatch):
    want = _jax_world1()
    _world1_env(monkeypatch, PADDLE_DISTRI_BACKEND="gloo",
                PADDLE_MASTER=f"127.0.0.1:{_free_port()}",
                PADDLE_TRAINER_ID="0", PADDLE_TRAINERS_NUM="1")
    env = pdist.init_parallel_env()
    assert (env.rank, env.world_size) == (0, 1)
    assert pdist.is_initialized() and pdist.get_backend() == "gloo"
    # the calls go through the gloo group of one rank, not around it
    assert pcoll.get_group(0).process_group is not None
    _assert_same(_port_world1(), want)
    task = pdist.all_reduce(torch.ones(3), sync_op=False)
    np.testing.assert_array_equal(task.wait().numpy(), np.ones(3))
    assert task.is_completed()


def test_init_parallel_env_without_cuda_or_gloo_raises(world1, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    with pytest.raises(RuntimeError, match="NCCL backend needs CUDA"):
        pdist.init_parallel_env()
    monkeypatch.setenv("PADDLE_DISTRI_BACKEND", "mpi")
    with pytest.raises(ValueError, match="PADDLE_DISTRI_BACKEND"):
        pdist.init_parallel_env()
    assert not pdist.is_initialized()


# ---------------------------------------------------------------------------
# rank arithmetic and buckets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ranks", [[0], [1, 3], [4, 2, 0, 6]])
@pytest.mark.parametrize("me", [0, 2, 3])
def test_group_rank_arithmetic_matches_the_reference(monkeypatch, jax_groups,
                                                     ranks, me):
    _world1_env(monkeypatch, PADDLE_TRAINER_ID=str(me),
                PADDLE_TRAINERS_NUM="8")
    j, p = jcoll.Group(ranks, axis_name="dp"), pcoll.Group(ranks,
                                                           axis_name="dp")
    assert (p.ranks, p.nranks, p.world_size, p.rank, p.axis_name) == \
        (j.ranks, j.nranks, j.world_size, j.rank, j.axis_name)
    for r in range(8):
        assert p.get_group_rank(r) == j.get_group_rank(r)
    assert pdist.get_rank(p) == jdist.get_rank(j)
    assert pdist.get_world_size(p) == jdist.get_world_size(j)
    assert pdist.get_world_size() == jdist.get_world_size() == 8


class _Shape:
    """A parameter as the JAX reducer reads one: shape and dtype."""

    def __init__(self, shape, dtype):
        self.shape, self.dtype = shape, np.dtype(dtype)


SHAPES = [(
    [((64, 64), "float32"), ((64,), "float32"), ((1024, 256), "float32"),
     ((256,), "float32"), ((4096, 1024), "float16"), ((3,), "float32")],
    1, 1), (
    [((512, 512), "float32")] * 7 + [((10,), "float32")], 2, 1), (
    [((300, 1000), "float32"), ((8,), "float32"), ((700, 1000), "float16"),
     ((2000, 1000), "float32")], 25, 1)]


@pytest.mark.parametrize("shapes,mb,last_mb", SHAPES)
def test_bucket_assignment_matches_the_reference(monkeypatch, shapes, mb,
                                                 last_mb):
    jparams = [_Shape(s, d) for s, d in shapes]
    tparams = [torch.nn.Parameter(torch.zeros(s, dtype=getattr(torch, d)))
               for s, d in shapes]
    jr = JReducer(jparams, None, 2, mb, last_mb)
    pr = PReducer(tparams, None, 2, mb, last_mb)
    want = [[jparams.index(p) for p in b] for b in jr.buckets]
    got = [[next(i for i, q in enumerate(tparams) if q is p) for p in b]
           for b in pr.buckets]
    assert got == want and len(want) > 1


# ---------------------------------------------------------------------------
# DataParallel over two gloo ranks
# ---------------------------------------------------------------------------

def test_data_parallel_over_two_gloo_ranks(tmp_path):
    r, logs = td.launch(tmp_path, td.DP_WORKER, 2, "gloo")
    assert r.returncode == 0, r.stderr[-3000:] + logs
    want = td.dp_single_process(2)
    for rank in (0, 1):
        got = np.load(tmp_path / f"params_{rank}.npz")
        assert set(got.files) == set(want)
        for n in want:
            np.testing.assert_allclose(got[n], want[n], rtol=1e-5,
                                       atol=TOL, err_msg=n)
