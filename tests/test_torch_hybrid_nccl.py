"""PyTorch port, the hybrid-parallel trainer over NCCL: four ranks, one
process and one card each, against the port's single-card step on the
first card from the same parameters and batches.  Marked ``cuda``; it
needs four CUDA devices and skips with fewer.  On a four-GPU host:

    python -m pytest tests/test_torch_hybrid_nccl.py --noconftest -q

The CPU tests (tests/test_torch_hybrid_parallel.py, test_torch_ring_moe.py)
hold the same per-rank code over gloo, where a send never waits for its
receive and the tags pick each receive's message.  Here every pipeline
schedule's point-to-point batches, ZeRO's reduce-scatter and all-gather,
the sequence-parallel collectives, ring attention's ppermute and MoE's
all_to_all run over NCCL, which matches a pair's calls by the order they
were posted, at the bench's 350M widths in bf16 for the pipelines (an
activation of 8 MiB a message, beyond NCCL's buffers) and at a small
width in f32 for the parity of gradients and parameters.

The world-1 reference runs ``num_microbatches * dp`` microbatches (every
dp rank's, in order); the per-rank step's gradients, losses and
parameters equal its own in every layout and schedule, with no factor.

Tolerances: f32 losses every step to rtol 1e-4, first-step gradients to
||d|| / ||ref|| <= 1e-4 a leaf, parameters after the last step within
2 lr a step everywhere (Adam turns a gradient near zero into a step of
lr of either sign) and within 2e-5 at all but 1e-4 of the elements; bf16
losses every step to rtol 2e-3.
"""
import dataclasses
import os
import socket
import tempfile
import traceback

import numpy as np
import pytest
import torch

from paddle_tpu_torch.models.llama import LlamaConfig
from paddle_tpu_torch.parallel import transformer as pt
from paddle_tpu_torch.parallel.collectives import _P2PBatch
from _torch_shards import gather, logical

pytestmark = pytest.mark.cuda

WORLD, LR, STEPS, SEED = 4, 1e-3, 2, 0
LOSS_RTOL = {"float32": 1e-4, "bfloat16": 2e-3}
GRAD_L2_REL, PARAM_ATOL, FAR_SHARE = 1e-4, 2e-5, 1e-4
GROUP_TIMEOUT_S, RUN_TIMEOUT_S = 300, 1200

SMALL = dict(vocab_size=2048, hidden_size=512, intermediate_size=1024,
             num_hidden_layers=4, num_attention_heads=8,
             num_key_value_heads=4, max_position_embeddings=512)
WIDE = dict(vocab_size=32000, hidden_size=1024, intermediate_size=2816,
            num_hidden_layers=8, num_attention_heads=16,
            num_key_value_heads=4, max_position_embeddings=2048)

# name -> (hp fields, config, config fields, seq, rows a microbatch)
CASES = {
    "dp2_tp2_zero1": ({"dp": 2, "tp": 2, "zero_stage": 1}, SMALL, {}, 512,
                      2),
    "pp2_dp2_1f1b_zero1": ({"pp": 2, "dp": 2, "zero_stage": 1,
                            "num_microbatches": 4}, SMALL, {}, 512, 1),
    "pp2_tp2_gpipe": ({"pp": 2, "tp": 2, "num_microbatches": 4,
                       "pp_schedule": "gpipe"}, SMALL, {}, 512, 1),
    "cp2_tp2": ({"cp": 2, "tp": 2}, SMALL, {}, 512, 2),
    "pp4_vpp2": ({"pp": 4, "vpp": 2, "pp_schedule": "vpp",
                  "num_microbatches": 4}, SMALL,
                 {"num_hidden_layers": 8}, 512, 1),
    "moe_ep4": ({"dp": 4, "ep": 4}, SMALL,
                {"moe_experts": 8, "moe_top_k": 2,
                 "moe_capacity_factor": 2.0}, 512, 2),
    "pp4_1f1b_wide_bf16": ({"pp": 4, "num_microbatches": 8,
                            "dtype": torch.bfloat16, "remat": False},
                           WIDE, {}, 2048, 2),
    "pp4_vpp2_wide_bf16": ({"pp": 4, "vpp": 2, "pp_schedule": "vpp",
                            "num_microbatches": 4, "dtype": torch.bfloat16,
                            "remat": False}, WIDE, {}, 2048, 2),
}


def setup(case):
    """(hp, cfg, STEPS global batches [dp * M * rows, seq] as int64)."""
    hp_kw, dims, cfg_kw, seq, rows = case
    hp = pt.HybridParallelConfig(lr=LR, **hp_kw)
    cfg = dataclasses.replace(LlamaConfig(**dims), **cfg_kw)
    rng = np.random.default_rng(SEED)
    B = hp.dp * hp.num_microbatches * rows
    return hp, cfg, [torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                   (B, seq)))
                     for _ in range(STEPS)]


def full_params(cfg, hp):
    return pt.init_params(cfg, hp, seed=SEED, device="cpu")


def wide(hp) -> bool:
    return hp.dtype == torch.bfloat16


def to_np(t):
    return t.detach().float().cpu().numpy()


def rank_main(rank, port, cases, outdir, backend):
    """Every case on this rank, one mesh a case over one TCPStore; writes
    {case: record} to outdir/rank<r>.pt (or the traceback to .err)."""
    try:
        device = f"cuda:{rank}" if backend == "nccl" else "cpu"
        torch.backends.cuda.matmul.allow_tf32 = False
        store = torch.distributed.TCPStore(
            "localhost", port, WORLD, is_master=rank == 0,
            timeout=pt._timeout(GROUP_TIMEOUT_S))
        out = {}
        for name, case in cases.items():
            hp, cfg, tokens = setup(case)
            mesh = pt.build_mesh(hp, rank=rank, world_size=WORLD,
                                 store=store, backend=backend, device=device,
                                 timeout=GROUP_TIMEOUT_S)
            try:
                out[name] = run_rank(mesh, hp, cfg, tokens)
            finally:
                mesh.close()
        torch.save(out, os.path.join(outdir, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(outdir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def run_rank(mesh, hp, cfg, tokens):
    """This rank's step on its dp shard of each batch: losses, and at the
    small width the first batch's reduced gradients and the parameters
    after the last step (local shards as numpy)."""
    params = pt.shard_params(full_params(cfg, hp), hp, mesh)
    opt = pt.init_opt_state(params, hp, mesh)
    step = pt.build_train_step(cfg, hp, mesh)
    rows = tokens[0].shape[0] // hp.dp
    d = mesh.index("dp")
    mine = [t[d * rows:(d + 1) * rows] for t in tokens]
    rec = {"coords": dict(mesh.coords), "losses": [],
           "coalesced": _P2PBatch(mesh.group("pp"),
                                  torch.empty(1, device=mesh.device)).on}
    if not wide(hp):
        names = [n for n, _ in pt._leaves(params)]
        zd = dict(pt._leaves(pt.zero_dims(hp, pt._shapes(cfg))))
        toks = mine[0].to(mesh.device).reshape(hp.num_microbatches, -1,
                                               mine[0].shape[1])
        _, g = pt._sharded_loss_and_grads(params, toks, cfg, hp, mesh)
        g = pt._reduce_grads(g, names, hp, mesh, zd)
        rec["grads"] = {n: to_np(x) for n, x in zip(names, g)}
    for t in mine:
        _, _, loss = step(params, opt, t)
        rec["losses"].append(float(loss))
    if not wide(hp):
        rec["params"] = {n: to_np(x) for n, x in pt._leaves(params)}
    return rec


def run_world(cases, backend="nccl"):
    """Every case on WORLD ranks, each a spawned process; returns
    {case: {rank: record}}."""
    ctx = torch.multiprocessing.get_context("spawn")
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    with tempfile.TemporaryDirectory() as outdir:
        procs = [ctx.Process(target=rank_main,
                             args=(r, port, cases, outdir, backend))
                 for r in range(WORLD)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(RUN_TIMEOUT_S)
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        errs = []
        for r in range(WORLD):
            err = os.path.join(outdir, f"rank{r}.err")
            if os.path.exists(err):
                errs.append(f"rank {r}:\n" + open(err).read())
        assert not hung, f"ranks {hung} did not finish in {RUN_TIMEOUT_S} s"
        assert not errs, "\n".join(errs)
        recs = {r: torch.load(os.path.join(outdir, f"rank{r}.pt"),
                              weights_only=False) for r in range(WORLD)}
    return {name: {r: recs[r][name] for r in recs} for name in cases}


def world1(case, device):
    """The single-card step over the same global batches: the first
    batch's gradients, the losses and the parameters after the last
    step."""
    hp, cfg, tokens = setup(case)
    hp1 = pt.HybridParallelConfig(
        lr=LR, dtype=hp.dtype, remat=hp.remat, remat_policy=hp.remat_policy,
        xent_chunk=hp.xent_chunk,
        num_microbatches=hp.num_microbatches * hp.dp)
    params = {n: t.to(device) for n, t in pt._leaves(full_params(cfg, hp))}
    params = pt._tree(params.items())
    opt = pt.init_opt_state(params)
    rec = {"losses": []}
    for t in tokens:
        loss, g = pt.loss_and_grads(params, t.to(device), cfg, hp1)
        if "grads" not in rec and not wide(hp):
            rec["grads"] = {n: to_np(x) for n, x in pt._leaves(g)}
        pt._adamw_update(params, g, opt, hp1)
        rec["losses"].append(float(loss))
    if not wide(hp):
        rec["params"] = {n: to_np(x) for n, x in pt._leaves(params)}
    return rec


@pytest.fixture(scope="module")
def runs():
    if torch.cuda.device_count() < WORLD:
        pytest.skip(f"needs {WORLD} CUDA devices")
    from paddle_tpu_torch.ops import _build
    _build.build(["flash_attention"])    # once, before the ranks start
    torch.backends.cuda.matmul.allow_tf32 = False
    ranks = run_world(CASES)
    ref = {name: world1(case, "cuda:0") for name, case in CASES.items()}
    return ranks, ref


def gathered(ranks, name, key, specs):
    return gather({r: (rec["coords"], rec[key])
                   for r, rec in ranks[name].items()}, specs)


@pytest.mark.parametrize("name", list(CASES))
def test_pipeline_batches_coalesce_on_nccl(runs, name):
    assert all(rec["coalesced"] for rec in runs[0][name].values())


@pytest.mark.parametrize("name", list(CASES))
def test_losses_match_the_single_card_step(runs, name):
    ranks, ref = runs
    hp = setup(CASES[name])[0]
    losses = [rec["losses"] for rec in ranks[name].values()]
    assert all(ls == losses[0] for ls in losses), losses
    np.testing.assert_allclose(losses[0], ref[name]["losses"],
                               rtol=LOSS_RTOL[str(hp.dtype).split(".")[-1]])


SMALL_CASES = [n for n, c in CASES.items() if c[1] is SMALL]


@pytest.mark.parametrize("name", SMALL_CASES)
def test_first_step_gradients_match_the_single_card_step(runs, name):
    ranks, ref = runs
    hp, cfg, _ = setup(CASES[name])
    moe = bool(cfg.moe_experts)
    specs = dict(pt._leaves(pt.opt_state_specs(hp, pt._shapes(cfg))["m"]))
    got = logical(gathered(ranks, name, "grads", specs), hp)
    assert moe == any("moe_w_in" in n for n in got)
    for n, a in got.items():
        b = ref[name]["grads"][n]
        rel = np.linalg.norm(a - b) / max(float(np.linalg.norm(b)), 1e-30)
        assert rel <= GRAD_L2_REL, (n, rel)


@pytest.mark.parametrize("name", SMALL_CASES)
def test_params_match_the_single_card_step(runs, name):
    ranks, ref = runs
    hp, cfg, _ = setup(CASES[name])
    specs = dict(pt._leaves(pt.param_specs(hp, bool(cfg.moe_experts))))
    got = logical(gathered(ranks, name, "params", specs), hp)
    far = total = 0
    for n, a in got.items():
        b = ref[name]["params"][n]
        np.testing.assert_allclose(a, b, atol=2 * LR * STEPS, rtol=0,
                                   err_msg=n)
        far += int((np.abs(a - b) > PARAM_ATOL).sum())
        total += a.size
    assert far <= FAR_SHARE * total, (far, total)
