"""PyTorch port, distributed's host side: the comm watchdog (its hang
dump, its clearing of finished tasks, ``watch_step``; as the JAX
package's tests/test_eager_distributed.py holds them), the elastic
manager against the JAX package's for one membership script, the role
makers, rpc loopback (as tests/test_rpc.py), ``ProcessMesh`` and the
fleet topology's coordinates and group rank lists against the JAX
package's for 4 layouts, and the hybrid trainer's mesh from
``init_parallel_env`` (``build_mesh``, ``get_jax_mesh``,
``ProcessMesh.jax_mesh``) at world 1 over gloo.  Every wait, join and
socket is bounded."""
import logging
import os
import socket
import time

import numpy as np
import pytest
import torch

from paddle_tpu.distributed import collective as jcoll
from paddle_tpu.distributed import watchdog as jwd
from paddle_tpu.distributed.auto_parallel import process_mesh as jpm
from paddle_tpu.distributed.fleet import elastic as jel
from paddle_tpu.distributed.fleet import role_maker as jrm
from paddle_tpu.distributed.fleet import topology as jtopo
from paddle_tpu.distributed import store as jstore
import paddle_tpu_torch.distributed as pdist
import paddle_tpu_torch.distributed.rpc as rpc
from paddle_tpu_torch.distributed import collective as pcoll
from paddle_tpu_torch.core import flags as pflags
from paddle_tpu_torch.distributed import watchdog as pwd
from paddle_tpu_torch.distributed.auto_parallel import process_mesh as ppm
from paddle_tpu_torch.distributed.fleet import elastic as pel
from paddle_tpu_torch.distributed.fleet import role_maker as prm
from paddle_tpu_torch.distributed.fleet import topology as ptopo
from paddle_tpu_torch.distributed import store as pstore
from paddle_tpu_torch.parallel import transformer as pt
from _torch_threads import torch_threads  # noqa: F401

POLL_S, HANG_S, WAIT_S = 0.05, 0.1, 10.0

# ---------------------------------------------------------------------------
# the watchdog
# ---------------------------------------------------------------------------


class _NeverReady:
    shape = (4,)

    def is_completed(self):
        return False


class _Done:
    shape = (2,)

    def is_completed(self):
        return True


class _Flags:
    """Sets the port's flags by item, through ``set_flags``."""

    def __setitem__(self, name, value):
        pflags.set_flags({name: value})


@pytest.fixture
def flag():
    prev = pflags.get_flags(["comm_watchdog_timeout"])
    yield _Flags()
    pflags.set_flags(prev)


def _wait_for(cond, timeout=WAIT_S):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(POLL_S)
    return cond()


def test_watchdog_reports_hangs(caplog, flag):
    mgr = pwd.CommTaskManager(poll_interval=POLL_S)
    flag["comm_watchdog_timeout"] = HANG_S
    try:
        with caplog.at_level(logging.CRITICAL,
                             logger="paddle_tpu_torch.distributed.watchdog"):
            mgr.register("all_reduce", (0, 1), _NeverReady())
            assert _wait_for(lambda: any("comm watchdog" in r.message
                                         for r in caplog.records))
        msg = next(r.message for r in caplog.records
                   if "comm watchdog" in r.message)
        assert "'all_reduce'" in msg and "(0, 1)" in msg and "(4,)" in msg
        assert mgr.pending() == [("all_reduce", (0, 1), (4,))]
    finally:
        mgr.shutdown()


def test_watchdog_clears_finished_tasks(flag):
    mgr = pwd.CommTaskManager(poll_interval=POLL_S)
    flag["comm_watchdog_timeout"] = 5.0
    try:
        ev = torch.cuda.Event() if torch.cuda.is_available() else _Done()
        mgr.register("broadcast", (0,), _Done())
        mgr.register("event", (0,), ev)
        assert _wait_for(lambda: not mgr.pending())
    finally:
        mgr.shutdown()


def test_watchdog_is_off_at_zero(flag):
    mgr = pwd.CommTaskManager(poll_interval=POLL_S)
    flag["comm_watchdog_timeout"] = 0.0
    mgr.register("all_reduce", (0,), _NeverReady())
    assert mgr.pending() == [] and mgr._thread is None


def test_watch_step_dumps_on_a_stuck_step(caplog, flag, monkeypatch):
    mgr = pwd.CommTaskManager(poll_interval=POLL_S)
    monkeypatch.setattr(pwd, "comm_task_manager", mgr)
    flag["comm_watchdog_timeout"] = HANG_S
    stuck = _NeverReady()
    try:
        stepped = pwd.watch_step(lambda x: {"loss": stuck,
                                            "cpu": torch.ones(1)},
                                 "hybrid_step")
        with caplog.at_level(logging.CRITICAL,
                             logger="paddle_tpu_torch.distributed.watchdog"):
            out = stepped(1)
            assert out["loss"] is stuck                # passthrough
            assert _wait_for(lambda: any("hybrid_step" in r.message
                                         for r in caplog.records))
    finally:
        mgr.shutdown()


def test_watchdog_flag_matches_the_reference_default():
    """Both read FLAGS_comm_watchdog_timeout from the environment at
    import, 0 (off) when it is unset."""
    assert pflags.get_flag("comm_watchdog_timeout") == \
        float(os.environ.get("FLAGS_comm_watchdog_timeout", 0.0))
    assert pwd.CommTaskManager()._timeout() == \
        jwd.CommTaskManager()._timeout()


# ---------------------------------------------------------------------------
# the elastic manager
# ---------------------------------------------------------------------------

# (action, node, expected status of node "a" after it, expected members)
SCRIPT = [("join", "a", "wait", ["a"]),
          ("join", "b", "relaunch", ["a", "b"]),
          ("consume", None, "ok", ["a", "b"]),
          ("join", "c", "relaunch", ["a", "b", "c"]),
          ("consume", None, "ok", ["a", "b", "c"]),
          ("join", "d", "error", ["a", "b", "c", "d"]),
          ("leave", "d", "relaunch", ["a", "b", "c"]),
          ("consume", None, "ok", ["a", "b", "c"]),
          ("leave", "a", "exit", None)]


def _play(el, st_mod):
    store = st_mod.TCPStore("127.0.0.1", 0, is_master=True, timeout=5.0)
    nodes, seen = {}, []
    try:
        for action, node, want, members in SCRIPT:
            left = None
            if action == "join":
                nodes[node] = el.ElasticManager(
                    store, "job", node, np_range="2:3",
                    heartbeat_interval=POLL_S, lease_ttl=30.0)
                nodes[node].register()
            elif action == "leave":
                left = nodes.pop(node)
                left.exit()
            else:
                seen.append(("consumed", nodes["a"].consume_relaunch()))
            a = nodes.get("a", left)
            ok = _wait_for(lambda: a.status() == want and (
                members is None or sorted(a.members()) == members))
            seen.append((action, node, a.status(),
                         None if members is None else sorted(a.members()),
                         sorted(a.alive_nodes()), ok))
    finally:
        for m in nodes.values():
            m.exit()
    return seen


def test_elastic_statuses_match_the_reference():
    assert pel.ElasticStatus.__dict__.items() >= {
        k: v for k, v in jel.ElasticStatus.__dict__.items()
        if not k.startswith("_")}.items()
    got = _play(pel, pstore)
    assert got == _play(jel, jstore)
    assert all(step[-1] for step in got if step[0] != "consumed"), got
    assert [s[1] for s in got if s[0] == "consumed"] == [True] * 3


# ---------------------------------------------------------------------------
# role makers, rpc
# ---------------------------------------------------------------------------

def _roles(rm):
    return (rm.is_worker(), rm.is_server(), rm.is_first_worker(),
            rm.worker_index(), rm.server_index(), rm.worker_num(),
            rm.server_num(), rm.get_pserver_endpoints())


@pytest.mark.parametrize("env", [
    {},
    {"TRAINING_ROLE": "PSERVER", "PADDLE_PSERVERS_IP_PORT_LIST":
     "10.0.0.1:1,10.0.0.2:2", "PADDLE_PSERVER_ID": "1",
     "PADDLE_TRAINERS_NUM": "4"},
    {"TRAINING_ROLE": "trainer", "PADDLE_TRAINER_ID": "3",
     "PADDLE_TRAINERS_NUM": "4", "PADDLE_PSERVERS_IP_PORT_LIST": "h:1"},
])
def test_role_makers_match_the_reference(monkeypatch, env):
    for k in ("TRAINING_ROLE", "PADDLE_PSERVERS_IP_PORT_LIST",
              "PADDLE_PSERVER_ID", "PADDLE_TRAINER_ID",
              "PADDLE_TRAINERS_NUM"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert (prm.Role.WORKER, prm.Role.SERVER) == (jrm.Role.WORKER,
                                                  jrm.Role.SERVER)
    assert _roles(prm.PaddleCloudRoleMaker()) == \
        _roles(jrm.PaddleCloudRoleMaker())
    assert _roles(prm.PaddleCloudRoleMaker(is_collective=True)) == \
        _roles(jrm.PaddleCloudRoleMaker(is_collective=True))
    for args in [(), (2, prm.Role.SERVER, 3, ["a:1", "b:2"])]:
        assert _roles(prm.UserDefinedRoleMaker(*args)) == \
            _roles(jrm.UserDefinedRoleMaker(*args))


def _add(a, b):
    return a + b


def _boom():
    raise ValueError("remote kaboom")


def test_rpc_loopback(monkeypatch):
    monkeypatch.delenv("PADDLE_MASTER_ENDPOINT", raising=False)
    monkeypatch.setenv("PADDLE_CURRENT_ENDPOINT", "127.0.0.1:6170")
    monkeypatch.setenv("FLAGS_stop_check_timeout", "30")
    rpc.init_rpc("worker0", rank=0, world_size=1,
                 master_endpoint="127.0.0.1:0")
    try:
        info = rpc.get_current_worker_info()
        assert info.name == "worker0" and info.rank == 0
        assert info.ip == "127.0.0.1"
        assert rpc.get_worker_info("worker0").port == info.port
        assert [w.name for w in rpc.get_all_worker_infos()] == ["worker0"]

        assert rpc.rpc_sync("worker0", _add, args=(2, 3), timeout=10) == 5
        fut = rpc.rpc_async("worker0", _add, args=(10,), kwargs={"b": 20},
                            timeout=10)
        assert fut.wait() == 30

        # remote exceptions propagate to the caller
        with pytest.raises(ValueError, match="remote kaboom"):
            rpc.rpc_sync("worker0", _boom, timeout=10)
        # an unknown worker is a clear error
        with pytest.raises(ValueError, match="unknown RPC worker"):
            rpc.rpc_sync("nobody", _add, args=(1, 2), timeout=10)
        with pytest.raises(RuntimeError, match="already initialized"):
            rpc.init_rpc("again", rank=0, world_size=1,
                         master_endpoint="127.0.0.1:0")
    finally:
        rpc.shutdown()
    # re-init after shutdown works
    rpc.init_rpc("worker0", rank=0, world_size=1,
                 master_endpoint="127.0.0.1:0")
    rpc.shutdown()
    with pytest.raises(RuntimeError, match="init_rpc"):
        rpc.rpc_sync("worker0", _add, args=(1, 2))


# ---------------------------------------------------------------------------
# ProcessMesh and the fleet topology
# ---------------------------------------------------------------------------

LAYOUTS = {   # (data, pipe, sharding, sep, model)
    "dp4": (4, 1, 1, 1, 1),
    "dp2_mp2": (2, 1, 1, 1, 2),
    "pp2_sharding2_mp2": (1, 2, 2, 1, 2),
    "dp2_pp2_sep2": (2, 2, 1, 2, 1),
}


def _mesh_facts(m):
    out = [m.shape, m.ndim, m.process_ids, m.dim_names, m.mesh.tolist(),
           repr(m), hash(m) == hash(m)]
    for d in m.dim_names:
        out.append(m.get_dim_size(d))
        out += [m.get_rank_by_dim_and_process_id(d, p)
                for p in m.process_ids + [99]]
    sub = m[0]
    out += [sub.shape, sub.dim_names, sub.process_ids]
    return out


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_process_mesh_matches_the_reference(name):
    dims = [d for d in LAYOUTS[name] if d > 1] or [1]
    names = ["dp", "pp", "sharding", "sep", "mp"][:len(dims)]
    ids = np.arange(int(np.prod(dims))).reshape(dims)
    p, j = ppm.ProcessMesh(ids, names), jpm.ProcessMesh(ids, names)
    assert _mesh_facts(p) == _mesh_facts(j)
    q = ppm.ProcessMesh(shape=dims, process_ids=ids.ravel()[::-1].tolist())
    k = jpm.ProcessMesh(shape=dims, process_ids=ids.ravel()[::-1].tolist())
    assert _mesh_facts(q) == _mesh_facts(k)
    assert (p == ppm.ProcessMesh(ids, names)) and not (p == q)
    assert ppm.set_mesh(p) is p and ppm.get_mesh() is p
    ppm.set_mesh(None)


def _group_facts(hcg, topo):
    def ranks(g):
        return None if g is None else (g.ranks, g.nranks, g.axis_name)
    out = [hcg.get_parallel_mode(), hcg.get_data_parallel_rank(),
           hcg.get_data_parallel_world_size(),
           ranks(hcg.get_data_parallel_group()),
           hcg.get_data_parallel_group_src_rank(),
           hcg.get_model_parallel_rank(), hcg.get_model_parallel_world_size(),
           ranks(hcg.get_model_parallel_group()),
           hcg.get_model_parallel_group_src_rank(), hcg.get_stage_id(),
           hcg.get_pipe_parallel_world_size(),
           ranks(hcg.get_pipe_parallel_group()), hcg.is_first_stage(),
           hcg.is_last_stage(), hcg.get_sharding_parallel_rank(),
           hcg.get_sharding_parallel_world_size(),
           ranks(hcg.get_sharding_parallel_group()),
           hcg.get_sharding_parallel_group_src_rank(),
           hcg.get_sep_parallel_rank(), hcg.get_sep_parallel_world_size(),
           ranks(hcg.get_sep_parallel_group()), hcg.get_p2p_groups()]
    out += [hcg.get_rank_from_stage(s) for s in
            range(hcg.get_pipe_parallel_world_size())]
    for axis in topo.get_hybrid_group_names():
        out += [topo.get_dim(axis), topo.get_comm_list(axis)]
        out += [topo.get_axis_list(axis, i) for i in range(topo.get_dim(axis))]
    out += [tuple(topo.get_coord(r)) for r in range(topo.world_size)]
    return out


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


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_topology_matches_the_reference(monkeypatch, jax_groups, name):
    dims = LAYOUTS[name]
    world = int(np.prod(dims))
    pcoll.destroy_process_group()
    for r in range(world):
        monkeypatch.setenv("PADDLE_TRAINER_ID", str(r))
        monkeypatch.setenv("PADDLE_TRAINERS_NUM", str(world))
        ptp = ptopo.CommunicateTopology(dims=dims)
        jtp = jtopo.CommunicateTopology(dims=dims)
        assert ptp.world_size == jtp.world_size == world
        assert ptp.get_rank(data=0, pipe=dims[1] - 1, sharding=0, sep=0,
                            model=0) == jtp.get_rank(
            data=0, pipe=dims[1] - 1, sharding=0, sep=0, model=0)
        assert ptp.get_rank_from_stage(r, pipe=0) == \
            jtp.get_rank_from_stage(r, pipe=0)
        p = ptopo.HybridCommunicateGroup(ptp)
        j = jtopo.HybridCommunicateGroup(jtp)
        assert p.global_rank == j.global_rank == r
        assert _group_facts(p, ptp) == _group_facts(j, jtp)
        # no process group of this world: no mesh, as the reference has
        # none without the devices
        assert p.get_jax_mesh() is None


# ---------------------------------------------------------------------------
# the launcher meets the trainer: one rank over gloo
# ---------------------------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture
def gloo_world1(monkeypatch):
    for k in list(os.environ):
        if k.startswith("PADDLE_") or k in ("RANK", "WORLD_SIZE",
                                            "LOCAL_RANK"):
            monkeypatch.delenv(k)
    port = _free_port()
    for k, v in {"PADDLE_DISTRI_BACKEND": "gloo",
                 "PADDLE_MASTER": f"127.0.0.1:{port}",
                 "PADDLE_TRAINER_ID": "0", "PADDLE_TRAINERS_NUM": "1",
                 "PADDLE_LOCAL_RANK": "0"}.items():
        monkeypatch.setenv(k, v)
    pcoll.destroy_process_group()
    pdist.init_parallel_env()
    yield port
    pcoll.destroy_process_group()


def test_build_mesh_from_the_launchers_environment(gloo_world1):
    """No rank, world or store: the default group's, and its TCP store
    on PADDLE_MASTER's port + 1, not a private one."""
    from paddle_tpu_torch.distributed import parallel
    assert parallel._store.port == gloo_world1 + 1
    hp = pt.HybridParallelConfig()
    mesh = pt.build_mesh(hp)
    assert (mesh.rank, mesh.backend, mesh.device.type) == (0, "gloo", "cpu")
    # the mesh met through the default group's store, over the TCP store
    ds = torch.distributed.distributed_c10d._get_default_store()
    assert ds.check(["paddle_tpu_torch/mesh_count/0"])
    while hasattr(ds, "underlying_store"):
        ds = ds.underlying_store
    assert isinstance(ds, torch.distributed.TCPStore)
    assert ds.port == parallel._store.port
    assert mesh.shape == {"pp": 1, "dp": 1, "cp": 1, "tp": 1}
    t = torch.ones(3)
    pt.allreduce_(t, mesh.group("tp"))
    assert t.tolist() == [1.0] * 3


def test_meshes_of_the_topology_and_process_mesh(gloo_world1):
    hcg = ptopo.HybridCommunicateGroup(ptopo.CommunicateTopology())
    mesh = hcg.get_jax_mesh()
    assert mesh is hcg.get_jax_mesh() and mesh.shape == {
        "pp": 1, "dp": 1, "cp": 1, "tp": 1}
    pm = ppm.ProcessMesh([[0]], ["sharding", "model"])
    assert pm.jax_mesh().coords == {"pp": 0, "dp": 0, "cp": 0, "tp": 0}
    with pytest.raises(ValueError, match="name no axis"):
        ppm.ProcessMesh([[0]], ["x", "y"]).jax_mesh()
    with pytest.raises(RuntimeError, match="need 2 ranks"):
        ppm.ProcessMesh([0, 1], ["dp"]).jax_mesh()


def test_process_mesh_maps_its_dims_onto_the_trainers_axes():
    """The rank grid a ProcessMesh hands the trainer: dims in the
    trainer's axis order, folded where two share an axis."""
    seen = {}

    def fake(ranks, **kw):
        seen["ranks"] = ranks
        return "mesh"
    ids = np.arange(8).reshape(2, 2, 2)
    orig = pt._mesh_from_layout
    pt._mesh_from_layout = fake
    try:
        ppm.ProcessMesh(ids, ["mp", "pp", "dp"]).jax_mesh()
        np.testing.assert_array_equal(
            seen["ranks"], ids.transpose(1, 2, 0).reshape(2, 2, 1, 2))
        ppm.ProcessMesh(ids, ["sharding", "data", "sep"]).jax_mesh()
        np.testing.assert_array_equal(seen["ranks"],
                                      ids.reshape(1, 4, 2, 1))
    finally:
        pt._mesh_from_layout = orig
