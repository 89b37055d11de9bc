"""PyTorch port, the fused norm kernel's host plan (``_norm_plan``) and its
plain versions, on the CPU.

The plan sizes the row walk of ``csrc/fused_norms.cu``: teams of
``team_warps`` warps, ``threads // (32 * team_warps)`` teams a block, a
ring of ``stages`` row slots a team, ``grid`` blocks and ``smem`` shared
bytes; rows wider than a slot take the one-block-a-row kernel.  The
kernel cannot run here, so ``_walk`` below models its row assignment and
its ring (which row each team takes, which slot and mbarrier phase each
copy lands in, when a slot is refilled) from the kernel's own formulas,
and the tests hold every plan over the serving shapes to it: every row
visited once, shared memory within a block's 227 KB, the grid resident
at once, the wide-row path exactly where a row outgrows a slot.

The plain versions ``rms_ref`` / ``ln_ref`` are held to the JAX
package's ``_rms_ref`` / ``_ln_ref`` (what its norms run off the TPU) at
the fused decoder's prefill row count: float32 within rtol = atol = 1e-5
(the same f32 math, the row means summed in another order), bfloat16
within one bf16 ulp of the JAX result (both round the same f32 value,
which may sit on either side of a rounding boundary).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.ops.pallas.fused_norms as JFN
from paddle_tpu_torch.ops import fused_norms as fn
from _torch_threads import torch_threads  # noqa: F401

ROWS = [8, 16, 616, 2048, 2984, 8192]
WIDTHS = [128, 1024, 4096, 5120, 8192, 11008, 32768, 65536]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
SMS = 132


def _vec_bytes(H, w_dtype, kind):
    return H * fn._size(w_dtype) * (2 if kind == "ln" else 1)


def _walk(plan, R):
    """The kernel's walk under ``plan``: for each (block, team), its rows
    in order, each as (row, slot, parity, refill) -- the slot its copy
    lands in, the mbarrier phase the team waits for, and the row whose
    copy the team's leader issues into that slot once the row is done
    (None if none).  Also checks the prologue and refills in the order the
    kernel issues them: a slot is refilled only after its row was read."""
    teams, S = plan.teams, plan.stages
    G = plan.grid * teams
    out = {}
    for block in range(plan.grid):
        for team in range(teams):
            g = block * teams + team
            n = (R - 1 - g) // G + 1 if g < R else 0
            rows = [g + k * G for k in range(n)]
            in_slot = {k: rows[k] for k in range(min(S, n))}   # prologue
            uses = [0] * S
            walk = []
            for k in range(n):
                s = k % S
                assert in_slot[s] == rows[k]          # the copy it waits on
                parity = (k // S) & 1
                assert parity == uses[s] & 1          # the slot's phase
                uses[s] += 1
                refill = None
                if k + S < n:                         # after the row's read
                    refill = rows[k + S]
                    in_slot[s] = refill
                walk.append((rows[k], s, parity, refill))
            out[block, team] = walk
    return out


@pytest.mark.parametrize("kind", ["rms", "ln"])
@pytest.mark.parametrize("xname", list(DTYPES))
@pytest.mark.parametrize("H", WIDTHS)
@pytest.mark.parametrize("R", ROWS)
def test_norm_plan_walks_every_row_once_within_shared_memory(R, H, xname,
                                                             kind):
    xdt = DTYPES[xname]
    slot = H * fn._size(xdt)
    for wdt in DTYPES.values():
        plan = fn._norm_plan(R, H, xdt, wdt, kind, wdt, SMS)
        if fn.WALK_HEAD + slot > fn.SMEM_BLOCK:
            assert plan.path == "row" and plan.grid == R
            assert plan.threads % 32 == 0 and 32 <= plan.threads <= 512
            continue
        vec = _vec_bytes(H, wdt, kind)
        staged = fn.WALK_HEAD + slot + vec <= fn.SMEM_BLOCK
        assert plan.path == ("walk" if staged else "walk_global")
        assert plan.team_warps in (1, 2, 4, 8)
        assert plan.threads % (32 * plan.team_warps) == 0
        assert plan.threads <= fn.WALK_THREADS
        assert 1 <= plan.stages <= fn.MAX_STAGES
        assert plan.teams * plan.stages <= 64      # the head's barriers
        assert plan.smem == fn.WALK_HEAD + plan.teams * plan.stages * slot \
            + (vec if staged else 0)
        assert plan.smem <= fn.SMEM_BLOCK == 227 * 1024
        # a row is split over several warps only where every lane keeps
        # two 16-byte vectors of it
        assert plan.team_warps == 1 or slot // 16 >= 64 * plan.team_warps
        # persistent: every block resident at once
        per_sm = min(fn.SMEM_SM // (plan.smem + 1024),
                     2048 // plan.threads, 65536 // (plan.threads * 64))
        assert 1 <= plan.grid <= SMS * per_sm
        walk = _walk(plan, R)
        seen = sorted(r for rows in walk.values() for r, *_ in rows)
        assert seen == list(range(R))
        # team 0 of every block has a row (it waits for the vectors' copy)
        assert all(walk[b, 0] for b in range(plan.grid))
        # no stage that no team fills
        assert max(len(v) for v in walk.values()) >= plan.stages


@pytest.mark.parametrize("kind", ["rms", "ln"])
@pytest.mark.parametrize("xname", list(DTYPES))
def test_norm_plan_takes_the_row_kernel_exactly_above_a_slot(xname, kind):
    """The widest H (a multiple of 128) whose row fits a slot beside the
    head takes the walk, the next one the one-block-a-row kernel: 57,856 /
    57,984 in float32, 115,712 / 115,840 in bfloat16."""
    xdt = DTYPES[xname]
    xs = fn._size(xdt)
    widest = (fn.SMEM_BLOCK - fn.WALK_HEAD) // xs // 128 * 128
    assert widest == {4: 57_856, 2: 115_712}[xs]
    for wdt in DTYPES.values():
        for R in (8, 2984):
            assert fn._norm_plan(R, widest, xdt, wdt, kind, wdt,
                                 SMS).path != "row"
            assert fn._norm_plan(R, widest + 128, xdt, wdt, kind, wdt,
                                 SMS).path == "row"


def test_norm_plan_is_cached_by_shape_and_types():
    args = (2984, 4096, torch.bfloat16, torch.bfloat16, "rms",
            torch.bfloat16, SMS)
    first = fn._norm_plan(*args)
    hits = fn._norm_plan.cache_info().hits
    assert fn._norm_plan(*args) is first
    assert fn._norm_plan.cache_info().hits == hits + 1
    assert fn._norm_plan(2984, 4096, torch.bfloat16, torch.float32, "rms",
                         torch.float32, SMS) is not first


def test_norm_plan_at_the_fused_decoder_rows():
    """The decoder's launches (prefill 2,984 and 616 rows, decode 8, of
    4,096 in bf16 with bf16 weights) hold every row in a slot at once,
    the weight staged; at 8 rows each row is split over 8 warps."""
    for R in (8, 616, 2984):
        plan = fn._norm_plan(R, 4096, torch.bfloat16, torch.bfloat16,
                             "rms", torch.bfloat16, SMS)
        assert plan.path == "walk"
        assert plan.grid * plan.teams >= R
    assert fn._norm_plan(8, 4096, torch.bfloat16, torch.bfloat16, "rms",
                         torch.bfloat16, SMS).team_warps == 8


def _bf16_ulp(a):
    mag = np.maximum(np.abs(a), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("kind", ["rms", "ln"])
@pytest.mark.parametrize("xname", list(DTYPES))
def test_plain_versions_match_jax_refs_at_decoder_prefill_rows(xname, kind):
    rng = np.random.RandomState(31)
    R, H = 2984, 256
    x = rng.randn(R, H).astype(np.float32) * 2 + 0.5
    w = (1 + 0.1 * rng.randn(H)).astype(np.float32)
    b = (0.1 * rng.randn(H)).astype(np.float32)
    jdt = jnp.bfloat16 if xname == "bfloat16" else jnp.float32
    jx = jnp.asarray(x, jdt)
    tx = torch.from_numpy(x).to(DTYPES[xname])
    if kind == "rms":
        want = JFN._rms_ref(jx, jnp.asarray(w), 1e-6)
        got = fn.rms_ref(tx, torch.from_numpy(w), 1e-6)
    else:
        want = JFN._ln_ref(jx, jnp.asarray(w), jnp.asarray(b), 1e-5)
        got = fn.ln_ref(tx, torch.from_numpy(w), torch.from_numpy(b), 1e-5)
    assert got.dtype == DTYPES[xname]
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.float().numpy()
    if xname == "bfloat16":
        assert np.all(np.abs(got - want) <= _bf16_ulp(want))
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
