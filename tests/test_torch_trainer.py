"""PyTorch port, the single-card train step: the JAX package's
``build_train_step`` (its Pallas flash attention kernels run through the
interpreter, ``INTERPRET = True``) against the port's on ``device="cpu"``
(where the port's attention is its plain version), from the same
``init_params`` carried across with ``from_jax_params`` and the same numpy
tokens, three steps each.

Tolerances (float32): the loss of every step to rtol 2e-5 (both sides sum
the same f32 terms in another order); the Adam moments after step 1 to
rtol 1e-4 with atol 1e-9 for m and 1e-12 for v (the gradients agree to
f32 summation order, a relative 1e-5 or so, and a moment carries that);
the parameters after every step to atol lr = 1e-3 everywhere, and to
atol 2e-5, a fiftieth of lr, at all but ``FLIPS`` = 16 of the ~1.3M
elements: Adam divides each gradient by its own root-mean-square, so a
gradient that is zero up to rounding, of one sign on one side and of the
other on the other, moves its parameter by up to 2 lr a step (3 to 6
elements do so here, by at most 2.9e-4, at every variant).  bf16 (one
case): the losses only, to rtol 2e-3 (bf16 matmuls round at other places
in XLA and PyTorch).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.ops.pallas import flash_attention as FA
from paddle_tpu.parallel import transformer as jt
from paddle_tpu_torch.models.llama import LlamaConfig
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.parallel import transformer as pt
from _torch_threads import torch_threads  # noqa: F401

DIMS = dict(vocab_size=256, hidden_size=256, intermediate_size=512,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=128)
SEQ, BATCH, STEPS = 128, 2, 3
LR = 1e-3


@pytest.fixture(autouse=True)
def _interpret():
    prev = FA.INTERPRET
    FA.INTERPRET = True
    yield
    FA.INTERPRET = prev


def _np_tree(tree):
    return jax.tree.map(lambda x: np.array(x), tree)


def _run_jax(hp_kw, tokens, dtype):
    cfg = JaxLlamaConfig(**DIMS)
    hp = jt.HybridParallelConfig(dtype=dtype, lr=LR, **hp_kw)
    mesh = jt.build_mesh(hp)
    params = jt.init_params(cfg, hp, seed=0)
    init = _np_tree(params)
    params = jt.shard_params(params, hp, mesh)
    opt = jt.shard_opt_state(jt.init_opt_state(params), hp, mesh)
    step = jt.build_train_step(cfg, hp, mesh)
    losses, trees, opts = [], [], []
    for toks in tokens:
        params, opt, loss = step(params, opt, jnp.asarray(toks, jnp.int32))
        losses.append(float(loss))
        trees.append(_np_tree(params))
        opts.append(_np_tree(opt))
    return init, losses, trees, opts


def _run_port(hp_kw, tokens, init, dtype):
    cfg = LlamaConfig(**DIMS)
    hp = pt.HybridParallelConfig(dtype=dtype, lr=LR, **hp_kw)
    params = pt.from_jax_params(init, device="cpu")
    opt = pt.init_opt_state(params)
    step = pt.build_train_step(cfg, hp, device="cpu")
    losses, trees, opts = [], [], []
    for toks in tokens:
        params, opt, loss = step(params, opt, toks)
        losses.append(float(loss))
        trees.append(pt.to_numpy(params))
        opts.append(pt.to_numpy(opt))
    return losses, trees, opts


def _tokens(batch, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, DIMS["vocab_size"], (batch, SEQ)).astype(np.int32)
            for _ in range(STEPS)]


def _leaves(tree):
    return [("embed", tree["embed"]), ("norm_f", tree["norm_f"]),
            ("head", tree["head"])] + \
        [(f"layers.{k}", tree["layers"][k]) for k in pt.LAYER_KEYS]


def _assert_trees_close(got, want, **tol):
    for (name, a), (_, b) in zip(_leaves(got), _leaves(want)):
        np.testing.assert_allclose(a, np.asarray(b, np.float32), **tol,
                                   err_msg=name)


FLIPS = 16


def _assert_params_close(got, want):
    """Every element within lr; all but FLIPS within a fiftieth of it."""
    _assert_trees_close(got, want, atol=LR, rtol=0)
    far = sum(int((np.abs(a - np.asarray(b, np.float32)) > 2e-5).sum())
              for (_, a), (_, b) in zip(_leaves(got), _leaves(want)))
    assert far <= FLIPS, far


VARIANTS = {
    "remat": {"remat": True},
    "no_remat": {"remat": False},
    "microbatches2": {"remat": True, "num_microbatches": 2},
    "xent_chunk64": {"remat": False, "xent_chunk": 64},
}


@pytest.mark.parametrize("name", list(VARIANTS))
def test_train_steps_match_the_jax_trainer(name):
    hp_kw = VARIANTS[name]
    batch = BATCH * hp_kw.get("num_microbatches", 1)
    tokens = _tokens(batch)
    init, jl, jtrees, jopts = _run_jax(hp_kw, tokens, jnp.float32)
    fwd0 = fa.fwd_launch_count
    pl, ptrees, popts = _run_port(hp_kw, tokens, init, torch.float32)
    assert fa.fwd_launch_count == fwd0      # CPU: the plain version only
    np.testing.assert_allclose(pl, jl, rtol=2e-5)
    assert all(np.isfinite(pl))
    for got, want in zip(ptrees, jtrees):
        _assert_params_close(got, want)
    _assert_trees_close(popts[0]["m"], jopts[0]["m"], rtol=1e-4, atol=1e-9)
    _assert_trees_close(popts[0]["v"], jopts[0]["v"], rtol=1e-4, atol=1e-12)
    assert [int(o["step"]) for o in popts] == [1, 2, 3]


def test_bf16_losses_match_the_jax_trainer():
    hp_kw = {"remat": False}
    tokens = _tokens(BATCH, seed=1)
    init, jl, _, _ = _run_jax(hp_kw, tokens, jnp.bfloat16)
    assert init["embed"].dtype.name == "bfloat16"
    pl, ptrees, _ = _run_port(hp_kw, tokens, init, torch.bfloat16)
    np.testing.assert_allclose(pl, jl, rtol=2e-3)


def test_from_jax_params_keeps_values_and_dtypes():
    cfg = JaxLlamaConfig(**DIMS)
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        hp = jt.HybridParallelConfig(dtype=jdt)
        init = _np_tree(jt.init_params(cfg, hp, seed=3))
        params = pt.from_jax_params(init, device="cpu")
        for (name, a), (_, b) in zip(_leaves(params), _leaves(init)):
            assert a.dtype == tdt and tuple(a.shape) == b.shape, name
            np.testing.assert_array_equal(a.float().numpy(),
                                          np.asarray(b, np.float32))
        opt = pt.from_jax_opt_state(_np_tree(jt.init_opt_state(init)),
                                    device="cpu")
        assert opt["step"].dtype == torch.int32 and int(opt["step"]) == 0
        assert opt["m"]["layers"]["wq"].dtype == torch.float32


def test_init_params_shapes_and_count():
    """The port's own seeded init: the JAX shapes, dtype and scales, the
    same draws from the same generator seed, and param_count."""
    cfg = LlamaConfig(**DIMS)
    hp = pt.HybridParallelConfig(dtype=torch.bfloat16)
    a = pt.init_params(cfg, hp, seed=5, device="cpu")
    b = pt.init_params(cfg, hp, seed=5, device="cpu")
    shapes = jax.eval_shape(
        lambda: jt.init_params(JaxLlamaConfig(**DIMS),
                               jt.HybridParallelConfig(), 0))
    n = 0
    for (name, x), (_, y), (_, s) in zip(_leaves(a), _leaves(b),
                                         _leaves(shapes)):
        assert tuple(x.shape) == tuple(s.shape), name
        assert x.dtype == torch.bfloat16 and torch.equal(x, y), name
        n += x.numel()
    assert n == pt.param_count(cfg)
    assert float(a["embed"].float().std()) == pytest.approx(0.02, rel=0.05)
    assert torch.equal(a["layers"]["ln1"], torch.ones_like(a["layers"]["ln1"]))


def test_bench_configuration_parameter_count():
    """The bench's 350M GQA LLaMA: N = 336,118,784."""
    cfg = LlamaConfig(vocab_size=32000, hidden_size=1024,
                      intermediate_size=2816, num_hidden_layers=24,
                      num_attention_heads=16, num_key_value_heads=4)
    assert pt.param_count(cfg) == 336_118_784


def test_train_step_updates_in_place():
    cfg = LlamaConfig(**DIMS)
    hp = pt.HybridParallelConfig(remat=False)
    params = pt.init_params(cfg, hp, seed=0, device="cpu")
    opt = pt.init_opt_state(params)
    wq = params["layers"]["wq"]
    before = wq.clone()
    step = pt.build_train_step(cfg, hp, device="cpu")
    p2, o2, loss = step(params, opt, _tokens(BATCH)[0])
    assert p2 is params and o2 is opt and p2["layers"]["wq"] is wq
    assert not torch.equal(wq, before) and not wq.requires_grad
    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert int(o2["step"]) == 1


VPP = {"pp": 2, "vpp": 2, "pp_schedule": "vpp"}
REFERENCE_ERRORS = {
    "layers_pp_vpp": (VPP, {}, "must divide by pp\\*vpp=4"),
    "layers_vpp3": ({"vpp": 3, "pp_schedule": "vpp"}, {},
                    "must divide by pp\\*vpp=3"),
    "microbatches_pp_vpp": ({**VPP, "num_microbatches": 3},
                            {"num_hidden_layers": 4}, "num_microbatches % pp"),
    "kv_heads_tp4": ({"tp": 4}, {}, "kv heads are sharded over tp"),
    "kv_heads_tp3": ({"tp": 3}, {}, "kv heads are sharded over tp"),
    "ep_without_dp": ({"ep": 2}, {"moe_experts": 4}, "ep must be 1 or equal"),
    "ep_not_dp": ({"ep": 3, "dp": 2}, {"moe_experts": 6},
                  "ep must be 1 or equal"),
    "ep_without_experts": ({"ep": 2, "dp": 2}, {}, "requires cfg.moe_experts"),
    "experts_ep2": ({"ep": 2, "dp": 2}, {"moe_experts": 3},
                    "must divide by ep=2"),
    "experts_ep4": ({"ep": 4, "dp": 4}, {"moe_experts": 6},
                    "must divide by ep=4"),
}


@pytest.mark.parametrize("name", list(REFERENCE_ERRORS))
def test_build_train_step_raises_the_references_errors(name):
    """The JAX trainer's configuration checks, with its wording."""
    hp_kw, cfg_kw, match = REFERENCE_ERRORS[name]
    with pytest.raises(ValueError, match=match) as want:
        jt.build_train_step(JaxLlamaConfig(**{**DIMS, **cfg_kw}),
                            jt.HybridParallelConfig(**hp_kw), None)
    with pytest.raises(ValueError, match=match) as got:
        pt.build_train_step(LlamaConfig(**{**DIMS, **cfg_kw}),
                            pt.HybridParallelConfig(**hp_kw), device="cpu")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("hp_kw,match", [
    ({"dp": 2}, "needs a mesh"), ({"remat_policy": "dots"}, "remat_policy"),
    ({"pp_schedule": "zb"}, "pp_schedule")], ids=["mesh", "remat", "sched"])
def test_build_train_step_checks_its_own_options(hp_kw, match):
    with pytest.raises(ValueError, match=match):
        pt.build_train_step(LlamaConfig(**DIMS),
                            pt.HybridParallelConfig(**hp_kw), device="cpu")


def test_build_train_step_runs_on_cuda_unless_asked():
    """No device means CUDA: with no card it raises rather than falling
    back to the CPU."""
    cfg = LlamaConfig(**DIMS)
    hp = pt.HybridParallelConfig()
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.build_train_step(cfg, hp)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.init_params(cfg, hp)
