"""Shared by the hybrid trainer's parity tests (tests/test_torch_hybrid_
parallel.py, tests/test_torch_ring_moe.py): the JAX trainer on the
8-device CPU mesh, the port's per-rank step with each rank a thread on
gloo, the port's single-card step, and the comparisons.

Both packages start from the JAX package's ``init_params`` (carried over
as numpy) and take the same numpy tokens: ``STEPS`` steps on a fresh
batch each, at ``LlamaConfig.tiny(vocab=64, hidden=32, layers=2, heads=4,
ffn=64, seq=16)``, two sequences a microbatch.

The port's gradients are the single-device step's in every layout; the
JAX trainer's are ``grad_factor`` times them (tp x cp, x pp under GPipe
and the interleaved schedule; tests/_torch_shards.py).  The JAX trainer
runs with its clip norm and Adam's eps times the same factor
(``jax_hp``): the clip then fires where the port's does and scales both
to the same gradient, and Adam, whose update is unchanged when the
gradients and eps scale together, takes the same steps.  What each
comparison holds:

- against the port's single-card step (``check_grads_world1``,
  ``check_steps_world1``): the per-rank step's raw reduced gradients of
  the first batch, with no factor; the losses and the parameters after
  every step;
- against the JAX trainer: the losses and parameters of every step
  (``check_losses``, ``check_params``), and its first-step gradients,
  read from its first Adam moment (m1 = (1 - b1) * the clipped gradient)
  divided by ``grad_factor`` and held against the port's first moment,
  gathered over the ranks, ZeRO shards included (``check_first_moments``).
  With MoE under tp or cp the JAX trainer's aux loss is reweighed
  (``jax_cfg_kw``) so that its gradients are the factor times the port's
  in every term; its losses are then another objective's, and only the
  first step's loss, from a run at the case's own config, is held.

Tolerances (float32):
- losses: every step to rtol 1e-4;
- parameters after every step: atol lr everywhere, and atol 2e-5 at all
  but FLIPS elements (Adam moves a parameter whose gradient is zero up to
  rounding by up to 2 lr; none did at these sizes);
- gradients and first moments: ||d|| / ||ref|| <= 1e-4 a leaf.
"""
import dataclasses
import threading
import traceback

import jax
import jax.numpy as jnp
import numpy as np
import torch
import torch.distributed as dist

from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.parallel import transformer as jt
from paddle_tpu_torch.models.llama import LlamaConfig
from paddle_tpu_torch.parallel import transformer as pt
from _torch_shards import gather, grad_factor, logical

TINY = dict(vocab=64, hidden=32, layers=2, heads=4, ffn=64, seq=16)
SEQ, MB, LR, STEPS = 16, 2, 1e-3, 3
LOSS_RTOL, PARAM_ATOL, GRAD_L2_REL = 1e-4, 2e-5, 1e-4
FLIPS = 16
GROUP_TIMEOUT_S, JOIN_TIMEOUT_S = 60, 120


def configs(cfg_kw):
    """The JAX and port LlamaConfig of TINY with cfg_kw's fields."""
    return (dataclasses.replace(JaxLlamaConfig.tiny(**TINY), **cfg_kw),
            dataclasses.replace(LlamaConfig.tiny(**TINY), **cfg_kw))


def global_tokens(hp_kw, seed=0):
    """STEPS global batches [dp * M * MB, SEQ] from a numpy seed."""
    rng = np.random.RandomState(seed)
    B = hp_kw.get("dp", 1) * hp_kw.get("num_microbatches", 1) * MB
    return [rng.randint(0, TINY["vocab"], (B, SEQ)).astype(np.int32)
            for _ in range(STEPS)]


def np_tree(tree):
    return jax.tree.map(lambda x: np.array(x), tree)


def jax_hp(hp_kw):
    """The JAX trainer's configuration for hp_kw: its clip norm and eps
    times ``grad_factor``, so that its steps are the port's."""
    k = grad_factor(pt.HybridParallelConfig(**hp_kw))
    base = jt.HybridParallelConfig()
    return jt.HybridParallelConfig(lr=LR, grad_clip_norm=base.grad_clip_norm
                                   * k, eps=base.eps * k, **hp_kw)


def jax_cfg_kw(hp_kw, cfg_kw):
    """The JAX trainer's config fields for a case: with MoE under tp or
    cp, its aux weight times tp x cp.  The reference takes the aux loss's
    gradient on tp rank 0 and divides it by cp (``_aux_consistent``), so
    it lacks the tp x cp of its cross entropy's; reweighed, its gradients
    are ``grad_factor`` times the port's in every term."""
    hp = pt.HybridParallelConfig(**hp_kw)
    if not cfg_kw.get("moe_experts") or hp.tp * hp.cp == 1:
        return cfg_kw
    w = configs(cfg_kw)[0].moe_aux_weight
    return dict(cfg_kw, moe_aux_weight=w * hp.tp * hp.cp)


def run_jax(hp_kw, cfg_kw, tokens):
    """The JAX trainer under ``jax_hp``: (init params as numpy, losses,
    params after each step, the first step's m divided by
    ``grad_factor``)."""
    jcfg, _ = configs(cfg_kw)
    hp = jax_hp(hp_kw)
    k = grad_factor(pt.HybridParallelConfig(**hp_kw))
    mesh = jt.build_mesh(hp)
    init = np_tree(jt.init_params(jcfg, jt.HybridParallelConfig(), seed=0))
    params = jt.shard_params(jax.tree.map(jnp.asarray, init), hp, mesh)
    opt = jt.shard_opt_state(jt.init_opt_state(params), hp, mesh)
    step = jt.build_train_step(jcfg, hp, mesh)
    losses, trees, m1 = [], [], None
    for toks in tokens:
        params, opt, loss = step(params, opt, jnp.asarray(toks))
        losses.append(float(loss))
        trees.append(dict(pt._leaves(np_tree(params))))
        if m1 is None:
            m1 = {n: a / k for n, a in pt._leaves(np_tree(opt["m"]))}
    return {"init": init, "losses": losses, "params": trees, "m1": m1}


def run_ranks(hp, fn):
    """fn(mesh) on every rank of hp's mesh, each rank a thread with its
    own gloo groups over one HashStore; returns {rank: (coords, result)}."""
    store = dist.HashStore()
    out, errs = {}, {}

    def body(r):
        try:
            mesh = pt.build_mesh(hp, rank=r, world_size=hp.world,
                                 store=store, backend="gloo", device="cpu",
                                 timeout=GROUP_TIMEOUT_S)
            out[r] = (dict(mesh.coords), fn(mesh))
        except BaseException:
            errs[r] = traceback.format_exc()

    threads = [threading.Thread(target=body, args=(r,), daemon=True)
               for r in range(hp.world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(JOIN_TIMEOUT_S)
    assert not any(t.is_alive() for t in threads), "a rank thread hung"
    assert not errs, "\n".join(errs.values())
    return out


def first_grads(hp_kw, cfg_kw, init, tokens):
    """The per-rank step's reduced gradients of one global batch,
    gathered over the ranks, layers in logical order."""
    _, cfg = configs(cfg_kw)
    hp = pt.HybridParallelConfig(lr=LR, **hp_kw)
    rows = len(tokens) // hp.dp
    zd = dict(pt._leaves(pt.zero_dims(hp, pt._shapes(cfg))))

    def rank(mesh):
        params = pt.shard_params(init, hp, mesh)
        d = mesh.index("dp")
        toks = torch.from_numpy(tokens[d * rows:(d + 1) * rows]).long()
        names = [n for n, _ in pt._leaves(params)]
        _, g = pt._sharded_loss_and_grads(
            params, toks.reshape(hp.num_microbatches, -1, SEQ), cfg, hp,
            mesh)
        g = pt._reduce_grads(g, names, hp, mesh, zd)
        return leaf_arrays(pt._tree(zip(names, g)))

    res = run_ranks(hp, rank)
    specs = dict(pt._leaves(pt.opt_state_specs(hp, pt._shapes(cfg))["m"]))
    return logical(gather(res, specs), hp)


def leaf_arrays(tree):
    return {n: t.detach().float().numpy().copy() for n, t in pt._leaves(tree)}


def run_port(hp_kw, cfg_kw, init, tokens):
    """The port's per-rank step on every rank: the first batch's reduced
    gradients (before the step), losses, params after each step and the
    first step's m, each gathered over the ranks."""
    _, cfg = configs(cfg_kw)
    hp = pt.HybridParallelConfig(lr=LR, **hp_kw)
    rows = len(tokens[0]) // hp.dp
    zd = dict(pt._leaves(pt.zero_dims(hp, pt._shapes(cfg))))

    def rank(mesh):
        params = pt.shard_params(init, hp, mesh)
        opt = pt.init_opt_state(params, hp, mesh)
        step = pt.build_train_step(cfg, hp, mesh)
        d = mesh.index("dp")
        mine = [t[d * rows:(d + 1) * rows] for t in tokens]
        names = [n for n, _ in pt._leaves(params)]
        toks = torch.from_numpy(mine[0]).long().reshape(
            hp.num_microbatches, -1, SEQ)
        _, g = pt._sharded_loss_and_grads(params, toks, cfg, hp, mesh)
        g = pt._reduce_grads(g, names, hp, mesh, zd)
        rec = {"grads": leaf_arrays(pt._tree(zip(names, g))), "losses": [],
               "params": [], "m1": None, "m_bytes": sum(
                   t.numel() * t.element_size()
                   for _, t in pt._leaves(opt["m"]))}
        for t in mine:
            _, _, loss = step(params, opt, t)
            rec["losses"].append(float(loss))
            rec["params"].append(leaf_arrays(params))
            if rec["m1"] is None:
                rec["m1"] = leaf_arrays(opt["m"])
        return rec

    res = run_ranks(hp, rank)
    moe = bool(cfg.moe_experts)
    pspecs = dict(pt._leaves(pt.param_specs(hp, moe)))
    ospecs = dict(pt._leaves(pt.opt_state_specs(hp, pt._shapes(cfg))["m"]))
    losses = [rec["losses"] for _, rec in res.values()]
    assert all(ls == losses[0] for ls in losses), losses  # every rank
    return {
        "losses": losses[0],
        "params": [gather({r: (c, rec["params"][s])
                           for r, (c, rec) in res.items()}, pspecs)
                   for s in range(STEPS)],
        "m1": gather({r: (c, rec["m1"]) for r, (c, rec) in res.items()},
                     ospecs),
        "grads": gather({r: (c, rec["grads"]) for r, (c, rec) in res.items()},
                        ospecs),
        "m_bytes": {r: rec["m_bytes"] for r, (_, rec) in res.items()}}


def run_world1(hp_kw, cfg_kw, init, tokens):
    """The port's single-card step over the same global batches (its
    microbatches are every dp rank's, in order): gradients of the first
    batch, losses, params after each step."""
    _, cfg = configs(cfg_kw)
    hp_kw = {k: v for k, v in hp_kw.items()
             if k in ("xent_chunk", "remat", "remat_policy")}
    hp = pt.HybridParallelConfig(lr=LR, num_microbatches=len(tokens[0]) // MB,
                                 **hp_kw)
    params = pt.from_jax_params(init, device="cpu")
    opt = pt.init_opt_state(params)
    first, losses, trees = None, [], []
    for t in tokens:
        loss, g = pt.loss_and_grads(params, torch.from_numpy(t).long(), cfg,
                                    hp)
        first = first or leaf_arrays(g)
        pt._adamw_update(params, g, opt, hp)
        losses.append(float(loss))
        trees.append(leaf_arrays(params))
    return {"grads": first, "losses": losses, "params": trees}


def assert_params_close(got, want):
    """Every element within lr; all but FLIPS within PARAM_ATOL."""
    far = 0
    for n, a in got.items():
        b = np.asarray(want[n], np.float32)
        np.testing.assert_allclose(a, b, atol=LR, rtol=0, err_msg=n)
        far += int((np.abs(a - b) > PARAM_ATOL).sum())
    assert far <= FLIPS, far


def assert_l2_close(got, want):
    """||got - want|| / ||want|| <= GRAD_L2_REL a leaf."""
    for n, a in got.items():
        b = np.asarray(want[n], np.float32)
        ref = max(float(np.linalg.norm(b)), 1e-30)
        rel = float(np.linalg.norm(a - b)) / ref
        assert rel <= GRAD_L2_REL, (n, rel)


class Runs:
    """Each case's JAX run, port run and single-card run, made once and
    shared by the tests that read them."""

    def __init__(self, cases):
        self.cases = cases
        self.cache = {}

    def _get(self, kind, name, make):
        key = (kind, name)
        if key not in self.cache:
            self.cache[key] = make()
        return self.cache[key]

    def tokens(self, name):
        return self._get("tokens", name,
                         lambda: global_tokens(self.cases[name][0]))

    def jax(self, name):
        hp_kw, cfg_kw = self.cases[name]
        return self._get("jax", name, lambda: run_jax(
            hp_kw, jax_cfg_kw(hp_kw, cfg_kw), self.tokens(name)))

    def jax_first_loss(self, name):
        """The JAX trainer's first loss at the case's own config (its
        forward; the step's update does not enter it)."""
        hp_kw, cfg_kw = self.cases[name]
        return self._get("jax1", name, lambda: run_jax(
            hp_kw, cfg_kw, self.tokens(name)[:1])["losses"])

    def port(self, name):
        hp_kw, cfg_kw = self.cases[name]
        return self._get("port", name, lambda: run_port(
            hp_kw, cfg_kw, self.jax(name)["init"], self.tokens(name)))

    def world1(self, name):
        hp_kw, cfg_kw = self.cases[name]
        return self._get("world1", name, lambda: run_world1(
            hp_kw, cfg_kw, self.jax(name)["init"], self.tokens(name)))


def check_losses(runs, name):
    """Every step's loss; where ``jax_cfg_kw`` reweighs the JAX trainer's
    aux loss, its losses are another objective's, so only the first,
    from a run at the case's own config."""
    hp_kw, cfg_kw = runs.cases[name]
    if jax_cfg_kw(hp_kw, cfg_kw) == cfg_kw:
        want = runs.jax(name)["losses"]
    else:
        want = runs.jax_first_loss(name)
    got = runs.port(name)["losses"][:len(want)]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


def check_params(runs, name):
    for got, want in zip(runs.port(name)["params"], runs.jax(name)["params"]):
        assert_params_close(got, want)


def check_first_moments(runs, name):
    assert_l2_close(runs.port(name)["m1"], runs.jax(name)["m1"])


def check_grads_world1(runs, name):
    hp_kw = runs.cases[name][0]
    hp = pt.HybridParallelConfig(**hp_kw)
    assert_l2_close(logical(runs.port(name)["grads"], hp),
                    runs.world1(name)["grads"])


def check_steps_world1(runs, name):
    hp_kw = runs.cases[name][0]
    port, one = runs.port(name), runs.world1(name)
    np.testing.assert_allclose(port["losses"], one["losses"], rtol=LOSS_RTOL)
    for got, want in zip(port["params"], one["params"]):
        assert_params_close(logical(got, pt.HybridParallelConfig(**hp_kw)),
                            want)
