"""PyTorch port, the hybrid trainer's context parallelism and MoE: the
port's per-rank step (each rank a thread with its own gloo process groups)
against the JAX trainer on the 8-device CPU mesh and against the port's
single-card step at cp (ring attention, GQA), MoE with experts sharded
over dp (ep = dp) and local, and MoE under tp x cp; ring attention and
the zigzag layout against dense attention; the gating math against the
JAX package's; every collective's backward against its forward (the
transpose).  The trainer cases, tolerances and runs are
tests/_torch_hybrid.py's; the rest hold f32 to 1e-5."""
import datetime
import importlib
import math
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_hybrid as th
from paddle_tpu.incubate.distributed.models.moe import gating as jg
from paddle_tpu.parallel import moe as jmoe
from paddle_tpu_torch.incubate.distributed.models.moe import gating as pg
from paddle_tpu_torch.parallel import collectives as C
from paddle_tpu_torch.parallel import moe as pmoe
from paddle_tpu_torch.parallel import transformer as pt
from _torch_threads import torch_threads  # noqa: F401

# the packages export the function ring_attention under the module's name
jring = importlib.import_module("paddle_tpu.parallel.ring_attention")
pring = importlib.import_module("paddle_tpu_torch.parallel.ring_attention")

MOE = {"moe_experts": 4}
CASES = {
    "cp2": ({"cp": 2}, {}),
    "cp2_tp2_gqa": ({"cp": 2, "tp": 2}, {"num_key_value_heads": 2}),
    "moe_ep2": ({"dp": 2, "ep": 2}, MOE),
    "moe_dp2_local": ({"dp": 2}, MOE),
    "moe_tp2_cp2": ({"tp": 2, "cp": 2}, MOE),
}
# Under cp the MoE gate sees each cp rank's slice of the sequence, so its
# aux loss is the mean over slices, not the aux of the whole sequence the
# single-card step gates: no single-card counterpart.
WORLD1 = [n for n in CASES if n != "moe_tp2_cp2"]
TOL = 1e-5


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


@pytest.mark.parametrize("name", WORLD1)
def test_gradients_match_the_single_card_step(runs, name):
    th.check_grads_world1(runs, name)


@pytest.mark.parametrize("name", WORLD1)
def test_steps_match_the_single_card_step(runs, name):
    th.check_steps_world1(runs, name)


# ---------------------------------------------------------------------------
# ring attention
# ---------------------------------------------------------------------------

def _group_run(n, fn):
    """fn(group) on n ranks, each a thread with its own gloo group."""
    store = dist.HashStore()
    out, errs = {}, {}

    def body(r):
        try:
            g = dist.ProcessGroupGloo(
                dist.PrefixStore("g", store), r, n,
                datetime.timedelta(seconds=th.GROUP_TIMEOUT_S))
            out[r] = fn(g)
        except BaseException as e:   # re-raised below on the test thread
            errs[r] = e
    ts = [threading.Thread(target=body, args=(r,), daemon=True)
          for r in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(th.JOIN_TIMEOUT_S)
    assert not any(t.is_alive() for t in ts), "a rank thread hung"
    if errs:
        raise next(iter(errs.values()))
    return [out[r] for r in range(n)]


def _dense(q, k, v, causal=True):
    """Plain f32 attention over the whole sequence, [B, S, H, D]."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    if causal:
        S = q.shape[1]
        s = s.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(),
                          float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)


RING = [(2, False), (4, False), (2, True), (4, True)]


@pytest.mark.parametrize("cp,zigzag", RING,
                         ids=[f"cp{c}{'_zigzag' if z else ''}"
                              for c, z in RING])
def test_ring_attention_matches_dense(cp, zigzag):
    """Each rank's ring attention output and its gradients in q, k, v,
    gathered, equal dense causal attention's on the whole sequence (in
    the zigzag layout, a sequence permuted by zigzag_permutation)."""
    B, S, H, D = 2, 32, 2, 8
    rng = np.random.RandomState(cp + 10 * zigzag)
    q, k, v, do = (torch.from_numpy(rng.randn(B, S, H, D).astype(np.float32))
                   for _ in range(4))
    perm, positions = pring.zigzag_permutation(S, cp) if zigzag else \
        (np.arange(S), None)
    qp, kp, vp, dop = (t[:, perm] for t in (q, k, v, do))
    n = S // cp

    def rank(g):
        r = g.rank()
        lq, lk, lv = (t[:, r * n:(r + 1) * n].clone().requires_grad_(True)
                      for t in (qp, kp, vp))
        out = pring.ring_attention(lq, lk, lv, g, True, positions)
        out.backward(dop[:, r * n:(r + 1) * n])
        return [t.detach() for t in (out, lq.grad, lk.grad, lv.grad)]

    got = [torch.cat(parts, 1) for parts in zip(*_group_run(cp, rank))]
    qr, kr, vr = (t.clone().requires_grad_(True) for t in (q, k, v))
    ref = _dense(qr, kr, vr)
    ref.backward(do)
    for a, b in zip(got, (ref, qr.grad, kr.grad, vr.grad)):
        torch.testing.assert_close(a, b.detach()[:, perm], rtol=TOL,
                                   atol=TOL)


def test_ring_attention_matches_the_jax_ring():
    """The port's ring at cp 2 against ``ring_self_attention`` on a
    two-device JAX mesh, zigzag positions included."""
    B, S, H, D, cp = 1, 16, 2, 8, 2
    rng = np.random.RandomState(3)
    q, k, v = (rng.randn(B, S, H, D).astype(np.float32) for _ in range(3))
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:cp]), ("sep",))
    want = np.asarray(jring.ring_self_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mesh))
    n = S // cp
    got = _group_run(cp, lambda g: pring.ring_attention(
        *(torch.from_numpy(t[:, g.rank() * n:(g.rank() + 1) * n])
          for t in (q, k, v)), g))
    np.testing.assert_allclose(torch.cat(got, 1).numpy(), want, rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("S,cp", [(16, 2), (32, 4), (24, 3)])
def test_zigzag_permutations_match_the_reference(S, cp):
    perm, pos = pring.zigzag_permutation(S, cp)
    jperm, jpos = jring.zigzag_permutation(S, cp)
    np.testing.assert_array_equal(perm, jperm)
    np.testing.assert_array_equal(pos, jpos)
    np.testing.assert_array_equal(pring.zigzag_inverse_permutation(S, cp),
                                  jring.zigzag_inverse_permutation(S, cp))


# ---------------------------------------------------------------------------
# gating and the MoE FFN
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T,E,k,cf", [(64, 4, 2, 2.0), (64, 8, 1, 1.0),
                                      (3, 16, 2, 0.5), (100, 6, 2, 1.25)])
def test_capacity_matches_the_reference(T, E, k, cf):
    assert pg.capacity_for(T, E, k, cf) == jg.capacity_for(T, E, k, cf)


GATING = [(2, 16), (1, 16), (2, 3), (1, 2), (2, 1)]


@pytest.mark.parametrize("top_k,capacity", GATING,
                         ids=[f"top{k}_cap{c}" for k, c in GATING])
def test_topk_gating_matches_the_reference(top_k, capacity):
    """Combine, dispatch and aux, and the gradient of a weighted sum of
    combine plus aux in the logits: ample capacity, and capacities that
    drop tokens (cap 3, 2, 1 of 32 tokens over 4 experts)."""
    T, E = 32, 4
    rng = np.random.RandomState(top_k * 100 + capacity)
    logits = rng.randn(T, E).astype(np.float32)
    w = rng.randn(T, E, capacity).astype(np.float32)

    def jf(x):
        c, d, a = jg.topk_gating(x, top_k, capacity)
        return jnp.sum(c * w) + a, (c, d, a)

    (_, (jc, jd, ja)), jgrad = jax.value_and_grad(jf, has_aux=True)(
        jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    c, d, a = pg.topk_gating(x, top_k, capacity)
    (torch.sum(c * torch.from_numpy(w)) + a).backward()
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    if capacity < T * top_k // E:
        assert d.sum() < T * top_k               # some tokens dropped
    np.testing.assert_allclose(c.detach().numpy(), np.asarray(jc), rtol=TOL,
                               atol=1e-7)
    np.testing.assert_allclose(float(a.detach()), float(ja), rtol=TOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrad), rtol=TOL,
                               atol=1e-7)


def test_topk_gating_breaks_ties_as_the_reference():
    """Equal logits: argmax takes the lowest expert in both packages."""
    logits = np.zeros((8, 4), np.float32)
    logits[::2, 1] = logits[::2, 3] = 1.0
    for top_k in (1, 2):
        jc, jd, _ = jg.topk_gating(jnp.asarray(logits), top_k, 8)
        c, d, _ = pg.topk_gating(torch.from_numpy(logits), top_k, 8)
        np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=TOL)


@pytest.mark.parametrize("cf", [2.0, 0.5])
def test_moe_ffn_matches_the_reference(cf):
    """moe_ffn with local experts: output, aux and the gradients of both
    in x and every weight (capacity factor 0.5 drops tokens)."""
    T, H, Fd, E = 24, 8, 16, 4
    rng = np.random.RandomState(int(cf * 10))
    x = rng.randn(T, H).astype(np.float32)
    p = {"gate": rng.randn(H, E).astype(np.float32) * 0.5,
         "w_in": rng.randn(E, H, Fd).astype(np.float32) * 0.2,
         "w_out": rng.randn(E, Fd, H).astype(np.float32) * 0.2}
    r = rng.randn(T, H).astype(np.float32)

    def jf(x, p):
        y, aux = jmoe.moe_ffn(x, p, ep_axis=None, capacity_factor=cf)
        return jnp.sum(y * r) + aux, (y, aux)

    (_, (jy, jaux)), (jgx, jgp) = jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True)(jnp.asarray(x),
                                          jax.tree.map(jnp.asarray, p))
    tx = torch.from_numpy(x).requires_grad_(True)
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    y, aux = pmoe.moe_ffn(tx, tp, capacity_factor=cf)
    (torch.sum(y * torch.from_numpy(r)) + aux).backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), rtol=TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=TOL,
                               atol=TOL)
    for k in p:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jgp[k]),
                                   rtol=TOL, atol=TOL, err_msg=k)


def test_init_moe_params_shapes_and_draws():
    a = pmoe.init_moe_params(7, 8, 16, 4, dtype=torch.bfloat16)
    b = pmoe.init_moe_params(7, 8, 16, 4, dtype=torch.bfloat16)
    shapes = {k: tuple(v.shape) for k, v in jmoe.init_moe_params(
        jax.random.PRNGKey(0), 8, 16, 4).items()}
    assert {k: tuple(v.shape) for k, v in a.items()} == shapes
    assert all(v.dtype == torch.bfloat16 and torch.equal(v, b[k])
               for k, v in a.items())


# ---------------------------------------------------------------------------
# the collectives: each backward is its forward's transpose
# ---------------------------------------------------------------------------

COLLECTIVES = {
    "all_gather": lambda x, g: C.all_gather(x, g, 1),
    "psum_scatter": lambda x, g: C.psum_scatter(x, g, 1),
    "psum": C.psum,
    "pmean": C.pmean,
    "ppermute_ring": lambda x, g: C.ppermute(
        x, g, [(i, (i + 1) % g.size()) for i in range(g.size())]),
    "ppermute_partial": lambda x, g: C.ppermute(x, g, [(0, g.size() - 1)]),
    "all_to_all": lambda x, g: C.all_to_all(x, g, 0, 1),
}


def _np_collective(name, xs):
    """The definition of each collective on every rank's input."""
    n = len(xs)
    if name == "all_gather":
        return [np.concatenate(xs, 1)] * n
    if name == "psum_scatter":
        tot = sum(xs)
        return list(np.split(tot, n, 1))
    if name in ("psum", "pmean"):
        tot = sum(xs) / (n if name == "pmean" else 1)
        return [tot] * n
    if name == "ppermute_ring":
        return [xs[(i - 1) % n] for i in range(n)]
    if name == "ppermute_partial":
        return [np.zeros_like(xs[0])] * (n - 1) + [xs[0]]
    if name == "all_to_all":
        return [np.concatenate([np.split(x, n, 0)[i] for x in xs], 1)
                for i in range(n)]
    raise KeyError(name)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", list(COLLECTIVES))
def test_collective_forward_and_transpose(name, n):
    """Forward: the definition.  Backward: the transpose, so sum over
    ranks of <f(x)_r, y_r> equals sum of <x_r, (f^T y)_r>."""
    rng = np.random.RandomState(n)
    xs = [rng.randn(4, 8, 3).astype(np.float32) for _ in range(n)]

    def rank(g):
        x = torch.from_numpy(xs[g.rank()]).requires_grad_(True)
        out = COLLECTIVES[name](x, g)
        y = torch.from_numpy(np.random.RandomState(99 + g.rank()).randn(
            *out.shape).astype(np.float32))
        (out * y).sum().backward()
        return out.detach().numpy(), y.numpy(), x.grad.numpy()

    res = _group_run(n, rank)
    want = _np_collective(name, xs)
    for (out, _, _), w in zip(res, want):
        np.testing.assert_allclose(out, w, rtol=TOL, atol=TOL)
    lhs = sum(float((o * y).sum()) for (o, y, _) in res)
    rhs = sum(float((x * gx).sum()) for x, (_, _, gx) in zip(xs, res))
    assert abs(lhs - rhs) <= 1e-4 * max(1.0, abs(lhs)), (lhs, rhs)


def test_psum_replicated_passes_the_cotangent_through():
    """The sum after which every rank holds one loss: forward the sum,
    backward the replicated cotangent itself (d<sum x, y>/dx_r = y)."""
    rng = np.random.RandomState(5)
    xs = [rng.randn(4, 3).astype(np.float32) for _ in range(3)]
    y = rng.randn(4, 3).astype(np.float32)

    def rank(g):
        x = torch.from_numpy(xs[g.rank()]).requires_grad_(True)
        out = C.psum_replicated(x, g)
        (out * torch.from_numpy(y)).sum().backward()
        return out.detach().numpy(), x.grad.numpy()

    for out, gx in _group_run(3, rank):
        np.testing.assert_allclose(out, sum(xs), rtol=TOL, atol=TOL)
        np.testing.assert_array_equal(gx, y)


def test_pmax_takes_the_max_without_gradient():
    res = _group_run(3, lambda g: C.pmax(
        torch.tensor([float(g.rank()), -float(g.rank())],
                     requires_grad=True), g))
    for r in res:
        assert r.tolist() == [2.0, 0.0] and not r.requires_grad


def test_train_step_needs_a_mesh_of_the_configured_shape():
    cfg = th.configs({})[1]
    with pytest.raises(ValueError, match="needs a mesh"):
        pt.build_train_step(cfg, pt.HybridParallelConfig(cp=2),
                            device="cpu")
    hp = pt.HybridParallelConfig()
    mesh = pt.build_mesh(hp, rank=0, world_size=1, backend="gloo",
                         device="cpu")
    with pytest.raises(ValueError, match="does not match hp"):
        pt.build_train_step(cfg, pt.HybridParallelConfig(cp=2), mesh)
