"""PyTorch port, the hybrid-parallel trainer: the port's per-rank step
(each rank a thread with its own gloo process groups) against the JAX
trainer on the 8-device CPU mesh, and against the port's own single-card
step, at dp, tp (with sequence parallel and GQA), pp (GPipe, 1F1B, the
interleaved schedule), ZeRO-1, the chunked cross entropy and
``remat_policy="attn"``; plus the mesh, spec and schedule helpers.
Context parallelism and MoE are in tests/test_torch_ring_moe.py.  The
cases, tolerances and runs are tests/_torch_hybrid.py's."""
import collections
import socket
import threading

import jax
import numpy as np
import pytest
import torch

import _torch_hybrid as th
from paddle_tpu.parallel import transformer as jt
from paddle_tpu_torch.parallel import transformer as pt
from paddle_tpu_torch.parallel.collectives import allreduce_
from _torch_threads import torch_threads  # noqa: F401

CASES = {
    "dp2": ({"dp": 2}, {}),
    "tp2": ({"tp": 2}, {}),
    "tp2_gqa": ({"tp": 2}, {"num_key_value_heads": 2}),
    "pp2_gpipe": ({"pp": 2, "num_microbatches": 4, "pp_schedule": "gpipe"},
                  {}),
    "pp2_1f1b": ({"pp": 2, "num_microbatches": 4}, {}),
    "dp2_pp2_tp2": ({"dp": 2, "pp": 2, "tp": 2, "num_microbatches": 2}, {}),
    "zero1_dp2": ({"dp": 2, "zero_stage": 1}, {}),
    "zero1_dp2_pp2_1f1b": ({"dp": 2, "pp": 2, "zero_stage": 1,
                            "num_microbatches": 4}, {}),
    "vpp2_pp2": ({"pp": 2, "vpp": 2, "pp_schedule": "vpp",
                  "num_microbatches": 2}, {"num_hidden_layers": 4}),
    "tp2_xent_chunk": ({"tp": 2, "xent_chunk": 8}, {}),
    "tp2_remat_attn": ({"tp": 2, "remat_policy": "attn"}, {}),
}


@pytest.fixture(scope="module")
def runs():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)         # the rank threads share the cores
    yield th.Runs(CASES)
    torch.set_num_threads(prev)


@pytest.mark.parametrize("name", list(CASES))
def test_losses_match_the_jax_trainer(runs, name):
    th.check_losses(runs, name)


@pytest.mark.parametrize("name", list(CASES))
def test_params_match_the_jax_trainer(runs, name):
    th.check_params(runs, name)


@pytest.mark.parametrize("name", list(CASES))
def test_first_step_gradients_match_the_jax_trainer(runs, name):
    th.check_first_moments(runs, name)


@pytest.mark.parametrize("name", list(CASES))
def test_gradients_match_the_single_card_step(runs, name):
    th.check_grads_world1(runs, name)


@pytest.mark.parametrize("name", list(CASES))
def test_steps_match_the_single_card_step(runs, name):
    th.check_steps_world1(runs, name)


SCHEDULES = {
    "gpipe": {"pp": 2, "num_microbatches": 2, "pp_schedule": "gpipe"},
    "1f1b": {"pp": 2, "num_microbatches": 2},
    "vpp": {"pp": 2, "vpp": 2, "pp_schedule": "vpp", "num_microbatches": 2},
    "tp2_cp2": {"tp": 2, "cp": 2, "num_microbatches": 2},
}


def test_schedules_and_tp_cp_give_the_single_card_gradients():
    """One model, one batch: GPipe, 1F1B and the interleaved schedule at
    pp 2, and tp 2 x cp 2, give the single-card step's gradients with no
    factor, and so each other's."""
    cfg_kw = {"num_hidden_layers": 4}
    jcfg, _ = th.configs(cfg_kw)
    init = th.np_tree(jt.init_params(jcfg, jt.HybridParallelConfig(),
                                     seed=0))
    tokens = th.global_tokens({"num_microbatches": 2})
    one = th.run_world1({}, cfg_kw, init, tokens[:1])["grads"]
    got = {name: th.first_grads(hp_kw, cfg_kw, init, tokens[0])
           for name, hp_kw in SCHEDULES.items()}
    for name, grads in got.items():
        th.assert_l2_close(grads, one)
    for name in ("1f1b", "vpp"):
        th.assert_l2_close(got[name], got["gpipe"])


def test_zero_cuts_each_ranks_moments_about_dp_times(runs):
    full = runs.port("dp2")["m_bytes"]
    zero = runs.port("zero1_dp2")["m_bytes"]
    assert set(full) == set(zero) == {0, 1}
    for r in full:
        assert 1.9 <= full[r] / zero[r] <= 2.0, (full[r], zero[r])


HYBRID = [({"dp": 4, "tp": 2}, 2, "dp"),
          ({"pp": 2, "dp": 2, "tp": 2}, 2, "pp"),
          ({"dp": 2, "pp": 2, "cp": 2}, 2, "dp"),
          ({"dp": 8}, 4, "dp"),
          ({"dp": 2, "tp": 4}, 1, "dp")]


@pytest.mark.parametrize("hp_kw,slices,axis", HYBRID,
                         ids=[f"{'_'.join(f'{k}{v}' for k, v in h.items())}"
                              f"_s{n}_{a}" for h, n, a in HYBRID])
def test_hybrid_mesh_layout_matches_the_reference(hp_kw, slices, axis):
    want = jt.build_hybrid_mesh(jt.HybridParallelConfig(**hp_kw),
                                jax.devices()[:8], num_slices=slices,
                                dcn_axis=axis)
    ids = np.vectorize(lambda d: d.id)(want.devices)
    hp = pt.HybridParallelConfig(**hp_kw)
    np.testing.assert_array_equal(pt._hybrid_layout(hp, slices, axis), ids)


def test_hybrid_mesh_groups_keep_tp_inside_a_slice():
    """Eight ranks on two nodes of four, dcn over dp: every tp and cp
    group lies inside one node, the dp groups cross."""
    hp = pt.HybridParallelConfig(dp=4, tp=2)
    store = torch.distributed.HashStore()
    out = {}

    def body(r):
        mesh = pt.build_hybrid_mesh(hp, 2, "dp", rank=r, world_size=8,
                                    store=store, backend="gloo",
                                    device="cpu", timeout=th.GROUP_TIMEOUT_S)
        out[r] = (mesh.coords, {a: mesh.group(a).size() for a in pt.AXES},
                  mesh.ranks)
    ts = [threading.Thread(target=body, args=(r,), daemon=True)
          for r in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(th.JOIN_TIMEOUT_S)
    assert len(out) == 8 and not any(t.is_alive() for t in ts)
    ranks = out[0][2]
    node = ranks // 4
    assert (node[..., 0] == node[..., 1]).all()          # tp pairs
    assert len(np.unique(node[0, :, 0, 0])) == 2          # dp crosses
    for r, (coords, sizes, _) in out.items():
        assert ranks[tuple(coords[a] for a in pt.AXES)] == r
        assert sizes == {"pp": 1, "dp": 4, "cp": 1, "tp": 2}


@pytest.mark.parametrize("hp_kw,slices,axis,match", [
    ({"dp": 2, "tp": 4}, 2, "tp", "dcn_axis must be"),
    ({"dp": 3, "tp": 2}, 2, "dp", "must be a multiple of num_slices"),
    ({"dp": 2, "pp": 3}, 2, "pp", "must be a multiple of num_slices"),
], ids=["tp_axis", "dp_not_multiple", "pp_not_multiple"])
def test_hybrid_mesh_raises_the_references_errors(hp_kw, slices, axis,
                                                  match):
    with pytest.raises(ValueError, match=match) as want:
        jt.build_hybrid_mesh(jt.HybridParallelConfig(**hp_kw),
                             jax.devices()[:jt.HybridParallelConfig(
                                 **hp_kw).world], num_slices=slices,
                             dcn_axis=axis)
    with pytest.raises(ValueError, match=match) as got:
        pt.build_hybrid_mesh(pt.HybridParallelConfig(**hp_kw), slices, axis,
                             rank=0, world_size=8, backend="gloo",
                             device="cpu")
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# the pipeline's point-to-point order, played as NCCL runs it
# ---------------------------------------------------------------------------

def nccl_stall(batches):
    """Play each rank's point-to-point calls as NCCL runs them.  batches:
    {rank: [[(kind, peer, tag), ...] a batch, ...]}, kind "send" or
    "recv", a call posted alone being a batch of its own.  NCCL matches
    the k-th send from a to b with the k-th receive on b from a, whatever
    the tags; a rank runs its batches in order, and a batch ends only when
    every call in it meets its match in the batch its peer is running (a
    send larger than NCCL's buffer waits for its receive).  Returns None
    when every batch ends and each matched pair carries one tag, else what
    went wrong."""
    where = {}                       # (rank, kind, peer, k) -> (batch, tag)
    for r, bs in batches.items():
        seen = collections.Counter()
        for i, batch in enumerate(bs):
            for kind, peer, tag in batch:
                where[(r, kind, peer, seen[kind, peer])] = (i, tag)
                seen[kind, peer] += 1

    def match(r, kind, peer, k):
        return (peer, "recv" if kind == "send" else "send", r, k)

    for key, (_, tag) in where.items():
        other = where.get(match(*key))
        if other is None or other[1] != tag:
            return f"{key} (tag {tag}) is matched by {other}"
    head = dict.fromkeys(batches, 0)
    while any(head[r] < len(bs) for r, bs in batches.items()):
        done = []
        for r, bs in batches.items():
            if head[r] == len(bs):
                continue
            seen = collections.Counter()
            for kind, peer, _ in (c for b in bs[:head[r]] for c in b):
                seen[kind, peer] += 1
            ok = True
            for kind, peer, _ in bs[head[r]]:
                m = match(r, kind, peer, seen[kind, peer])
                seen[kind, peer] += 1
                ok = ok and where[m][0] == head[peer]
            if ok:
                done.append(r)
        if not done:
            return f"stalled at batches {head}"
        for r in done:
            head[r] += 1
    return None


def test_nccl_stall_finds_two_stages_that_both_send_first():
    """1F1B at pp 2, M 2 with every call posted alone: stage 0 sends F0,
    F1, then takes B0; stage 1 takes F0, sends B0, takes F1.  Send F1
    waits for its receive behind send B0, which waits behind send F1."""
    alone = {0: [[("send", 1, 0)], [("send", 1, 2)], [("recv", 1, 3)],
                 [("recv", 1, 5)]],
             1: [[("recv", 0, 0)], [("send", 0, 3)], [("recv", 0, 2)],
                 [("send", 0, 5)]]}
    assert nccl_stall(alone).startswith("stalled")
    paired = {0: [[("send", 1, 0)], [("send", 1, 2), ("recv", 1, 3)],
                  [("recv", 1, 5)]],
              1: [[("recv", 0, 0)], [("send", 0, 3), ("recv", 0, 2)],
                  [("send", 0, 5)]]}
    assert nccl_stall(paired) is None
    assert "matched by" in nccl_stall({0: [[("send", 1, 0)]],
                                       1: [[("recv", 0, 2)]]})


PIPES = {
    "gpipe_pp2_m4": ({"pp": 2, "num_microbatches": 4,
                      "pp_schedule": "gpipe"}, 2),
    "gpipe_pp4_m3": ({"pp": 4, "num_microbatches": 3,
                      "pp_schedule": "gpipe"}, 4),
    "1f1b_pp2_m2": ({"pp": 2, "num_microbatches": 2}, 2),
    "1f1b_pp2_m4": ({"pp": 2, "num_microbatches": 4}, 2),
    "1f1b_pp4_m2": ({"pp": 4, "num_microbatches": 2}, 4),
    "1f1b_pp4_m6": ({"pp": 4, "num_microbatches": 6}, 4),
    "vpp2_pp2_m4": ({"pp": 2, "vpp": 2, "pp_schedule": "vpp",
                     "num_microbatches": 4}, 4),
    "vpp2_pp4_m4": ({"pp": 4, "vpp": 2, "pp_schedule": "vpp",
                     "num_microbatches": 4}, 8),
}


@pytest.mark.parametrize("name", list(PIPES))
def test_pipeline_posts_each_pairs_calls_in_one_order(monkeypatch, name):
    """Every schedule's sends and receives, recorded as each stage posts
    them over gloo, complete when played as NCCL runs them, each matched
    pair carrying one tag."""
    hp_kw, layers = PIPES[name]
    hp = pt.HybridParallelConfig(lr=th.LR, **hp_kw)
    _, cfg = th.configs({"num_hidden_layers": layers})
    log, local = collections.defaultdict(list), threading.local()

    class Batch(pt._P2PBatch):
        def __enter__(self):
            local.batch = []
            log[threading.get_ident()].append(local.batch)
            return super().__enter__()

        def __exit__(self, *exc):
            local.batch = None
            return super().__exit__(*exc)

    def recorded(kind, fn):
        def call(x, group, peer, tag=0):
            batch = getattr(local, "batch", None)
            if batch is None:            # posted alone: a batch of its own
                batch = []
                log[threading.get_ident()].append(batch)
            batch.append((kind, peer, tag))
            return fn(x, group, peer, tag)
        return call

    monkeypatch.setattr(pt, "_P2PBatch", Batch)
    monkeypatch.setattr(pt, "send", recorded("send", pt.send))
    monkeypatch.setattr(pt, "recv", recorded("recv", pt.recv))
    full = pt.init_params(cfg, hp, seed=0, device="cpu")
    rng = np.random.RandomState(0)
    toks = torch.from_numpy(rng.randint(0, th.TINY["vocab"], (
        hp.num_microbatches, th.MB, th.SEQ))).long()

    def rank(mesh):
        params = pt.shard_params(full, hp, mesh)
        loss, _ = pt._sharded_loss_and_grads(params, toks, cfg, hp, mesh)
        return threading.get_ident(), float(loss)

    res = th.run_ranks(hp, rank)
    batches = {r: log[ident] for r, (_, (ident, _)) in res.items()}
    assert all(batches.values())
    assert nccl_stall(batches) is None
    assert len({loss for _, (_, loss) in res.values()}) == 1


@pytest.mark.parametrize("hp_kw", [
    {"pp": 4, "num_microbatches": 8}, {"pp": 2, "num_microbatches": 3},
    {"pp": 4, "vpp": 2, "pp_schedule": "vpp", "num_microbatches": 8},
    {"pp": 2, "vpp": 4, "pp_schedule": "vpp", "num_microbatches": 4},
    {"pp": 1}], ids=["pp4_m8", "pp2_m3", "vpp2_pp4", "vpp4_pp2", "pp1"])
def test_pipeline_schedule_stats_match_the_reference(hp_kw):
    assert pt.pipeline_schedule_stats(pt.HybridParallelConfig(**hp_kw)) == \
        jt.pipeline_schedule_stats(jt.HybridParallelConfig(**hp_kw))


@pytest.mark.parametrize("L,pp,v", [(4, 2, 2), (8, 2, 2), (8, 4, 2),
                                    (12, 2, 3), (6, 1, 3)])
def test_vpp_layer_perm_matches_the_reference(L, pp, v):
    np.testing.assert_array_equal(pt.vpp_layer_perm(L, pp, v),
                                  jt.vpp_layer_perm(L, pp, v))


def _spec_tuple(spec):
    return tuple(spec)


@pytest.mark.parametrize("hp_kw,moe", [
    ({"dp": 2, "tp": 2, "pp": 2}, False),
    ({"dp": 4, "zero_stage": 1}, False),
    ({"dp": 2, "ep": 2, "zero_stage": 1}, True),
    ({"dp": 2, "tp": 2, "zero_stage": 1}, True)],
    ids=["dense", "zero_dp4", "moe_ep_zero", "moe_tp_zero"])
def test_specs_and_zero_dims_match_the_reference(hp_kw, moe):
    jcfg, cfg = th.configs({"moe_experts": 4} if moe else {})
    jhp = jt.HybridParallelConfig(**hp_kw)
    hp = pt.HybridParallelConfig(**hp_kw)
    shapes = jax.eval_shape(lambda: jt.init_params(jcfg, jhp, 0))
    is_p = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa: E731
    want = {
        "params": jax.tree.map(_spec_tuple, jt.param_specs(jhp, moe),
                               is_leaf=is_p),
        "zero": jt.zero_dims(jhp, shapes),
        "opt": jax.tree.map(_spec_tuple, jt.opt_state_specs(jhp, shapes),
                            is_leaf=is_p)}
    got = {"params": pt.param_specs(hp, moe),
           "zero": pt.zero_dims(hp, pt._shapes(cfg)),
           "opt": pt.opt_state_specs(hp, pt._shapes(cfg))}
    assert dict(pt._leaves(got["params"])) == dict(pt._leaves(want["params"]))
    assert dict(pt._leaves(got["zero"])) == dict(pt._leaves(want["zero"]))
    for k in ("m", "v"):
        assert dict(pt._leaves(got["opt"][k])) == \
            dict(pt._leaves(want["opt"][k]))
    assert tuple(got["opt"]["step"]) == tuple(want["opt"]["step"])


def test_build_mesh_reads_torchruns_environment(monkeypatch):
    """No rank or world given: RANK and WORLD_SIZE from the environment
    (torchrun's), a world of 1 meeting on an in-process store."""
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    mesh = pt.build_mesh(pt.HybridParallelConfig(), backend="gloo",
                         device="cpu", timeout=th.GROUP_TIMEOUT_S)
    assert mesh.rank == 0 and mesh.coords == dict.fromkeys(pt.AXES, 0)
    assert all(mesh.group(a).size() == 1 for a in pt.AXES)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="need 1 ranks, have 2"):
        pt.build_mesh(pt.HybridParallelConfig(), backend="gloo",
                      device="cpu")


def test_ranks_meet_through_a_tcp_store_on_localhost(monkeypatch):
    """Two ranks (threads) meet as torchrun's do: rank 0 hosts a TCPStore
    at MASTER_ADDR:MASTER_PORT, rank 1 connects; a dp pmean over them."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", str(port))
    monkeypatch.delenv("TORCHELASTIC_USE_AGENT_STORE", raising=False)
    hp = pt.HybridParallelConfig(dp=2)
    out = {}

    def body(r):
        store = pt._env_store(r, 2, pt._timeout(th.GROUP_TIMEOUT_S))
        mesh = pt.build_mesh(hp, rank=r, world_size=2, store=store,
                             backend="gloo", device="cpu",
                             timeout=th.GROUP_TIMEOUT_S)
        x = torch.full((3,), float(r + 1))
        out[r] = allreduce_(x, mesh.group("dp")).tolist()
    ts = [threading.Thread(target=body, args=(r,), daemon=True)
          for r in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(th.JOIN_TIMEOUT_S)
    assert not any(t.is_alive() for t in ts)
    assert out == {0: [3.0] * 3, 1: [3.0] * 3}


@pytest.mark.parametrize("moe", [False, True])
def test_init_params_shapes_dtypes_and_count(moe):
    """The port's own draws: the JAX trainer's shapes, hp.dtype (the MoE
    gate in f32, as the reference draws it) and param_count."""
    jcfg, cfg = th.configs({"moe_experts": 4} if moe else {})
    hp = pt.HybridParallelConfig(dtype=torch.bfloat16)
    got = dict(pt._leaves(pt.init_params(cfg, hp, seed=1, device="cpu")))
    want = dict(pt._leaves(jax.eval_shape(lambda: jt.init_params(
        jcfg, jt.HybridParallelConfig(dtype=jax.numpy.bfloat16), 0))))
    assert set(got) == set(want)
    for n, t in got.items():
        assert tuple(t.shape) == tuple(want[n].shape), n
        assert str(t.dtype).split(".")[-1] == str(want[n].dtype), n
    assert sum(t.numel() for t in got.values()) == pt.param_count(cfg)
