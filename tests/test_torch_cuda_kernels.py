"""PyTorch port, CUDA kernels on the card: each kernel against its plain
version over the shapes its wrapper accepts, and the engine's attention
and weight products, and the train step's attention, going through the
kernels.  Marked ``cuda``; without a CUDA device (or
nvcc) every test skips.  The card's machine has no JAX, so run this file
there without the suite's conftest:

    python -m pytest tests/test_torch_cuda_kernels.py --noconftest -q

Tolerances, on three measures of out - ref: the largest absolute error;
the largest over tokens of max|out_t - ref_t| / max|ref_t| (with N(0, 1)
inputs a token's outputs shrink as its row grows, ~0.04 at 2,000 keys, so
an absolute bound alone would be loose on long rows); and
||out - ref|| / ||ref||.  float32: 1e-4, 1e-4, 1e-5 (the online softmax
sums in another order).  bfloat16: 2e-2, 2e-2, 6e-3 (both sides round the
output to bf16, an ulp is 2^-7 of the binade, and the kernel also rounds
q * scale and p to bf16 where the plain version stays in f32; the norm
ratio averages single-element rounding out and catches a 1% shift).
The int8-page kernel keeps q * scale and p in f32 and rounds only its
output, so with bf16 q it is held to the plain version computed in f32 at
the same bf16 tolerances.  The dequant matmul feeds the tensor cores exact
bf16 operands (the integer codes; bf16 x, or f32 x split into three exact
bf16 terms), sums in f32 and scales after the sums, so it differs from its
plain version only in summation order: ||out - ref|| / ||ref|| <= 1e-5
and max|out - ref| / max|ref| <= 1e-4.
"""
import os
import shutil

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import flash_attention_varlen as fav
from paddle_tpu_torch.ops import fused_norms as fn
from paddle_tpu_torch.ops import paged_attention as pa
from paddle_tpu_torch.ops import quant_matmul as qm

pytestmark = pytest.mark.cuda
TOL = {torch.float32: {"abs": 1e-4, "token_rel": 1e-4, "l2_rel": 1e-5},
       torch.bfloat16: {"abs": 2e-2, "token_rel": 2e-2, "l2_rel": 6e-3}}


def _errors(out, ref):
    d = (out.float() - ref.float()).flatten(1)
    r = ref.float().flatten(1)
    tok = d.abs().amax(1) / r.abs().amax(1).clamp_min(1e-12)
    return {"abs": d.abs().max().item(), "token_rel": tok.max().item(),
            "l2_rel": (d.norm() / r.norm().clamp_min(1e-12)).item()}


def _assert_within(out, ref, dtype):
    errs = _errors(out, ref)
    assert all(errs[k] <= v for k, v in TOL[dtype].items()), errs


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if shutil.which("nvcc") is None and not \
            os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("needs nvcc to build the kernels")
    return torch.device("cuda")


def _case(dev, dtype, H, Hkv, D, bs, rows, Tq, nblk, seed=0):
    rng = np.random.default_rng(seed)
    B = len(rows)
    num_blocks = 1 + B * nblk
    cu = np.zeros(B + 1, np.int32)
    cu[1:] = np.cumsum([q for q, _ in rows])
    kvl = np.asarray([kv for _, kv in rows], np.int32)
    bt = np.zeros((B + 1, nblk), np.int32)
    pages = rng.permutation(np.arange(1, num_blocks))
    used = 0
    for r, (_, kv) in enumerate(rows):
        n = -(-kv // bs)
        bt[r, :n] = pages[used:used + n]
        used += n
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*s):
        return torch.randn(s, generator=g, device=dev).to(dtype)

    seg, rel = pa.ragged_segments(torch.from_numpy(cu).to(dev),
                                  torch.from_numpy(kvl).to(dev), Tq)
    return (randn(Tq, H, D), randn(num_blocks, Hkv, bs, D),
            randn(num_blocks, Hkv, bs, D), torch.from_numpy(bt).to(dev),
            seg, rel)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("H,Hkv,D,bs", [
    (4, 4, 64, 8), (8, 2, 64, 16), (32, 32, 128, 16), (32, 8, 128, 16),
    (16, 2, 128, 32), (8, 8, 128, 128), (12, 3, 64, 24)])
def test_kernel_matches_plain_version(dev, dtype, H, Hkv, D, bs):
    rows = [(9, 9), (5, 40), (1, 300), (1, 1), (0, 0), (3, 77)]
    Tq = 24
    ops = _case(dev, dtype, H, Hkv, D, bs, rows, Tq, -(-300 // bs))
    before = pa.launch_count
    out = pa.ragged_paged_attention_segrel_packed(*ops)
    torch.cuda.synchronize()
    assert pa.launch_count == before + 1
    ref = pa.ragged_paged_reference_segrel(*ops)
    assert out.dtype == dtype and torch.isfinite(out).all()
    _assert_within(out, ref, dtype)


def test_kernel_at_the_7b_decode_shape(dev):
    lens = [100, 2000, 731, 1290, 5, 16, 17, 1999]
    ops = _case(dev, torch.bfloat16, 32, 32, 128, 16,
                [(1, kv) for kv in lens], 8, 128, seed=3)
    out = pa.ragged_paged_attention_segrel_packed(*ops)
    ref = pa.ragged_paged_reference_segrel(*ops)
    _assert_within(out, ref, torch.bfloat16)


def test_engine_attention_goes_through_the_kernel(dev):
    from paddle_tpu_torch.inference import LLMEngine
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    cfg = LlamaConfig(vocab_size=512, hidden_size=256,
                      intermediate_size=512, num_hidden_layers=3,
                      num_attention_heads=4, num_key_value_heads=2,
                      max_position_embeddings=256)
    model = LlamaForCausalLM(cfg, device=dev, generator=1)
    eng = LLMEngine(model, max_num_seqs=4, block_size=16, max_model_len=256,
                    max_prefill_tokens=64, prefill_token_bucket=32)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, n).tolist() for n in (5, 90, 33, 17, 8)]
    for p in prompts:
        eng.add_request(p, max_new_tokens=12)
    pa.launch_count = 0
    outs = eng.run()
    steps = eng.stats.engine_steps
    assert pa.launch_count == cfg.num_hidden_layers * steps
    for rid, p in enumerate(prompts):
        gen = outs[rid].generated
        lg = model.forward_logits(torch.tensor([p + gen[:-1]],
                                               device=dev))[0, len(p) - 1:]
        y = torch.tensor(gen, device=dev)
        gap = lg.max(-1).values - lg[torch.arange(len(gen), device=dev), y]
        assert gap.max().item() <= 1e-3


def _quantize_pages(pages):
    """float pages [NB, H_kv, bs, D] -> int8 pages and f32 scales
    [NB, H_kv], per page and head, as the engine quantizes them."""
    s = pages.float().abs().amax((2, 3)) / 127.0
    q8 = torch.round(pages.float() / s[:, :, None, None].clamp_min(1e-30))
    return q8.clamp(-127, 127).to(torch.int8), s


def _quant_case(dev, dtype, H, Hkv, D, bs, rows, Tq, nblk, seed=0):
    q, kc, vc, bt, seg, rel = _case(dev, torch.float32, H, Hkv, D, bs, rows,
                                    Tq, nblk, seed)
    (kq, ks), (vq, vs) = _quantize_pages(kc), _quantize_pages(vc)
    return q.to(dtype), kq, vq, ks, vs, bt, seg, rel


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("H,Hkv,D,bs", [
    (4, 4, 64, 8), (8, 2, 64, 16), (32, 32, 128, 16), (32, 8, 128, 16),
    (16, 2, 128, 32), (8, 8, 128, 128), (12, 3, 64, 24)])
def test_quant_kernel_matches_plain_version(dev, dtype, H, Hkv, D, bs):
    rows = [(9, 9), (5, 40), (1, 300), (1, 1), (0, 0), (3, 77)]
    ops = _quant_case(dev, dtype, H, Hkv, D, bs, rows, 24, -(-300 // bs))
    before, before_f = pa.quant_launch_count, pa.launch_count
    out = pa.ragged_paged_attention_quant_segrel_packed(*ops)
    torch.cuda.synchronize()
    assert pa.quant_launch_count == before + 1
    assert pa.launch_count == before_f
    ref = pa.ragged_paged_reference_quant_segrel(ops[0].float(), *ops[1:])
    assert out.dtype == dtype and torch.isfinite(out).all()
    _assert_within(out, ref, dtype)


def test_quant_kernel_at_the_7b_decode_shape(dev):
    lens = [100, 2000, 731, 1290, 5, 16, 17, 1999]
    ops = _quant_case(dev, torch.bfloat16, 32, 32, 128, 16,
                      [(1, kv) for kv in lens], 8, 128, seed=3)
    out = pa.ragged_paged_attention_quant_segrel_packed(*ops)
    ref = pa.ragged_paged_reference_quant_segrel(ops[0].float(), *ops[1:])
    _assert_within(out, ref, torch.bfloat16)


def test_quant_kernel_refuses_float_pages(dev):
    ops = list(_quant_case(dev, torch.float32, 4, 4, 64, 8, [(3, 9)], 4, 2))
    ops[1] = ops[1].float()
    with pytest.raises(ValueError, match="int8-page"):
        pa.ragged_paged_attention_quant_segrel_packed(*ops)


QMM_TOL = {"l2_rel": 1e-5, "max_rel": 1e-4}


def _assert_qmm_within(out, ref):
    d = (out - ref).float()
    errs = {"l2_rel": (d.norm() / ref.norm().clamp_min(1e-30)).item(),
            "max_rel": (d.abs().max()
                        / ref.abs().max().clamp_min(1e-30)).item()}
    assert all(errs[k] <= v for k, v in QMM_TOL.items()), errs


@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("M,K,N", [
    (1, 2, 1), (8, 32, 97), (8, 64, 32), (5, 200, 130), (8, 4096, 4096),
    (17, 130, 66), (64, 64, 16), (512, 4096, 11008), (8, 11008, 4096),
    (8, 4096, 32000), (300, 1000, 77),
    # the tensor-core tiles' edges: M around the m16 / 64 / 128 row tiles,
    # N % 16 != 0 (plain loads instead of cp.async), a partial int4 group,
    # down's K (86 groups, split), the head's N
    (7, 256, 96), (9, 256, 8), (16, 512, 4098), (63, 384, 256),
    (64, 200, 4096), (65, 512, 4098), (513, 1024, 384), (1, 11008, 128),
    (17, 11008, 1024), (16, 4096, 32000), (129, 200, 32000)])
@pytest.mark.parametrize("wdt", ["int8", "int4"])
def test_qmm_kernel_matches_plain_version(dev, wdt, M, K, N, xdt):
    g = torch.Generator(device=dev).manual_seed(M * 7 + K + N)
    w = torch.randn((K, N), generator=g, device=dev) * 0.02
    q, s = qm.quantize_weight(w, wdt)
    x = torch.randn((M, K), generator=g, device=dev).to(xdt)
    before = qm.launch_count
    out = qm.matmul(x, q, s, wdt)
    torch.cuda.synchronize()
    assert qm.launch_count == before + 1
    assert out.dtype == torch.float32 and out.shape == (M, N)
    _assert_qmm_within(out, qm.reference_matmul(x, q, s, wdt))


@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("wdt", ["int8", "int4"])
def test_qmm_kernel_takes_unaligned_operands(dev, wdt, xdt):
    """x, q and s starting off a 16-byte boundary (contiguous views one
    element into a buffer) take the plain loads of the same kernel."""
    g = torch.Generator(device=dev).manual_seed(3)
    M, K, N = 24, 384, 160
    q0, s0 = qm.quantize_weight(
        torch.randn((K, N), generator=g, device=dev) * 0.02, wdt)
    qb = torch.empty(q0.numel() + 1, dtype=torch.int8, device=dev)
    q = qb[1:].view(q0.shape)
    q.copy_(q0)
    sb = torch.empty(s0.numel() + 1, device=dev)
    s = sb[1:].view(s0.shape)
    s.copy_(s0)
    xb = torch.randn(M * K + 1, generator=g, device=dev).to(xdt)
    x = xb[1:].view(M, K)
    assert x.data_ptr() % 16 and q.data_ptr() % 16 and s.data_ptr() % 16
    out = qm.matmul(x, q, s, wdt)
    torch.cuda.synchronize()
    _assert_qmm_within(out, qm.reference_matmul(x, q0, s0, wdt))


@pytest.mark.parametrize("M", [8, 512])
@pytest.mark.parametrize("wdt", ["int8", "int4"])
def test_qmm_kernel_repeats_bit_for_bit(dev, wdt, M):
    """At qkvo's shape the decode tile splits K over 8 blocks; the splits
    are summed in a fixed order, so ten launches give one result."""
    g = torch.Generator(device=dev).manual_seed(5)
    q, s = qm.quantize_weight(
        torch.randn((4096, 4096), generator=g, device=dev) * 0.02, wdt)
    x = torch.randn((M, 4096), generator=g, device=dev).bfloat16()
    first = qm.matmul(x, q, s, wdt)
    for _ in range(9):
        assert torch.equal(qm.matmul(x, q, s, wdt), first)
    _assert_qmm_within(first, qm.reference_matmul(x, q, s, wdt))


def test_qmm_kernel_refuses_bad_operands(dev):
    q, s = qm.quantize_weight(torch.randn((64, 32), device=dev), "int4")
    with pytest.raises(ValueError, match="dequant matmul kernel"):
        qm.matmul(torch.randn((8, 63), device=dev), q, s, "int4")
    with pytest.raises(ValueError, match="dequant matmul kernel"):
        qm.matmul(torch.randn((8, 64), device=dev).half(), q, s, "int4")


@pytest.mark.parametrize("opts", [
    {"kv_dtype": "int8"}, {"weight_dtype": "int8"},
    {"kv_dtype": "int8", "weight_dtype": "int4"}], ids=["kv8", "w8", "kv8w4"])
def test_quantized_engine_goes_through_the_kernels(dev, opts):
    """Attention launches == layers x steps on the kernel the pages call
    for (none on the other), dequant matmul launches == (7 layers + 1) x
    steps in a quantized-weight engine, and no plain version runs."""
    from paddle_tpu_torch.inference import LLMEngine
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    cfg = LlamaConfig(vocab_size=512, hidden_size=256,
                      intermediate_size=512, num_hidden_layers=3,
                      num_attention_heads=4, num_key_value_heads=2,
                      max_position_embeddings=256)
    model = LlamaForCausalLM(cfg, device=dev, generator=1)
    eng = LLMEngine(model, max_num_seqs=4, block_size=16, max_model_len=256,
                    max_prefill_tokens=64, prefill_token_bucket=32, **opts)
    rng = np.random.default_rng(0)
    for n in (5, 90, 33, 17, 8):
        eng.add_request(rng.integers(0, 512, n).tolist(), max_new_tokens=12)
    plain = (pa.ragged_paged_reference_segrel,
             pa.ragged_paged_reference_quant_segrel, qm.reference_matmul)

    def refuse(*a, **k):
        raise AssertionError("a plain version ran on the card")

    pa.ragged_paged_reference_segrel = refuse
    pa.ragged_paged_reference_quant_segrel = refuse
    qm.reference_matmul = refuse
    try:
        pa.launch_count = pa.quant_launch_count = qm.launch_count = 0
        outs = eng.run()
    finally:
        (pa.ragged_paged_reference_segrel,
         pa.ragged_paged_reference_quant_segrel, qm.reference_matmul) = plain
    steps = eng.stats.engine_steps
    L = cfg.num_hidden_layers
    int8_kv = opts.get("kv_dtype") == "int8"
    assert pa.quant_launch_count == (L * steps if int8_kv else 0)
    assert pa.launch_count == (0 if int8_kv else L * steps)
    quant_w = opts.get("weight_dtype", "float32") != "float32"
    assert qm.launch_count == ((7 * L + 1) * steps if quant_w else 0)
    assert all(len(o.generated) == 12 for o in outs.values())


@pytest.mark.parametrize("opts", [{}, {"kv_dtype": "int8",
                                       "weight_dtype": "int8"}],
                         ids=["float", "w8kv8"])
def test_engine_window_equals_k1_on_the_card(dev, opts):
    """The K=4 decode window on the card: the same tokens as K=1 (rows
    freezing mid-window on their budgets), attention launched once a
    layer a forward pass (a window counts its iterations), and no
    synchronizing CUDA call inside a dispatch."""
    import warnings
    from paddle_tpu_torch.inference import LLMEngine
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    cfg = LlamaConfig(vocab_size=512, hidden_size=256,
                      intermediate_size=512, num_hidden_layers=3,
                      num_attention_heads=2, num_key_value_heads=2,
                      max_position_embeddings=256)
    model = LlamaForCausalLM(cfg, device=dev, generator=1)
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(0, 512, n).tolist(), mx)
            for n, mx in ((5, 7), (90, 12), (33, 3), (17, 10))]

    def serve(k):
        eng = LLMEngine(model, max_num_seqs=4, block_size=16,
                        max_model_len=256, max_prefill_tokens=128,
                        prefill_token_bucket=32, decode_window=k, **opts)
        passes = []
        step, launch, dispatch = (eng._ragged_step, eng._launch_window,
                                  eng._dispatch)
        eng._ragged_step = lambda *a: passes.append(1) or step(*a)
        eng._launch_window = lambda n, *a: passes.append(n) or launch(n, *a)

        def checked():
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    dispatch()
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            assert not [w for w in caught
                        if "called a synchronizing" in str(w.message)]
        eng._dispatch = checked
        for p, mx in reqs:
            eng.add_request(p, max_new_tokens=mx)
        pa.launch_count = pa.quant_launch_count = 0
        outs = eng.run()
        att = pa.quant_launch_count if opts else pa.launch_count
        assert att == cfg.num_hidden_layers * sum(passes)
        assert eng.stats.quarantined == 0
        return [outs[r].generated for r in range(len(reqs))], eng

    k1, _ = serve(1)
    k4, eng = serve(4)
    assert k4 == k1
    assert eng.compile_counts.get("scan") == 1
    assert eng.stats.host_round_trips < eng.stats.decode_rounds


# ---------------------------------------------------------------------------
# flash attention: the forward, dK/dV and dQ kernels against their plain
# versions, and the train step going through them.  The forward's output is
# held by TOL's three measures over [B * S, H * D] rows (a row is one query
# position); lse, f32 on both sides and summed in another order, to 1e-3
# absolute (values up to ~20).  Gradients are held by two scale-free
# measures, max|d| / max|ref| over the whole tensor and ||d|| / ||ref||, at
# TOL's token_rel and l2_rel bounds: their magnitude grows with S, so an
# absolute bound means nothing, and a per-row ratio neither, since some
# rows are zero analytically (causal query 0 sees one key, and the
# gradient of a softmax over one key is 0) and hold rounding noise only.
# ---------------------------------------------------------------------------

LSE_ABS = 1e-3
GRAD_TOL = {dt: {"max_rel": t["token_rel"], "l2_rel": t["l2_rel"]}
            for dt, t in TOL.items()}
ORACLE_BF16 = {"max_rel": 5e-2, "l2_rel": 2e-2}


def _rows(x):
    return x.reshape(x.shape[0] * x.shape[1], -1)


def _grad_errors(got, want):
    d = (got.float() - want.float())
    w = want.float()
    return {"max_rel": (d.abs().max() / w.abs().max().clamp_min(1e-12)).item(),
            "l2_rel": (d.norm() / w.norm().clamp_min(1e-12)).item()}


def _assert_grad_within(got, want, tol):
    errs = _grad_errors(got, want)
    assert all(errs[k] <= v for k, v in tol.items()), errs


def _flash_case(dev, dtype, B, S, H, Hk, D, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*s):
        return torch.randn(s, generator=g, device=dev).to(dtype)
    return (randn(B, S, H, D), randn(B, S, Hk, D), randn(B, S, Hk, D),
            randn(B, S, H, D))


FLASH_SHAPES = [  # B, S, H, Hk, D
    (2, 128, 4, 4, 64), (2, 200, 8, 2, 64), (1, 100, 4, 1, 128),
    (1, 256, 16, 4, 64), (1, 130, 8, 8, 128), (1, 1, 4, 2, 64),
    (1, 200, 4, 2, 256)]
FLASH_IDS = ["mha", "gqa_S200", "mqa_d128_S100", "gqa4_S256", "d128_S130",
             "S1", "d256_gqa_S200"]
# the bf16 wgmma backward kernels' tile edges at D 64 and 128: one row
# short of and past a 64-row tile (and of a dQ block's 128 rows), the
# trainer's length, a GQA group of 8, and S 65 and 1 (a tile of one row)
WGMMA_SHAPES = [  # B, S, H, Hk, D
    (1, 127, 8, 1, 64), (2, 129, 4, 4, 64), (1, 65, 8, 2, 64),
    (1, 2048, 16, 2, 64), (1, 127, 4, 2, 128), (1, 129, 8, 1, 128),
    (1, 2048, 4, 4, 128), (1, 1, 8, 1, 128)]
WGMMA_IDS = ["g8_S127", "mha_S129", "gqa4_S65", "g8_S2048", "d128_S127",
             "d128_g8_S129", "d128_S2048", "d128_g8_S1"]
FLASH_SHAPES += WGMMA_SHAPES
FLASH_IDS += WGMMA_IDS


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,S,H,Hk,D", FLASH_SHAPES, ids=FLASH_IDS)
def test_flash_kernels_match_plain_versions(dev, B, S, H, Hk, D, dtype,
                                            causal):
    q, k, v, do = _flash_case(dev, dtype, B, S, H, Hk, D)
    counts = (fa.fwd_launch_count, fa.dkdv_launch_count, fa.dq_launch_count)
    out, lse = fa._launch_fwd(q, k, v, causal)
    ref, lse_ref = fa.flash_fwd_reference(q, k, v, causal)
    assert out.dtype == dtype and lse.shape == (B, H, S)
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    _assert_within(_rows(out), _rows(ref), dtype)
    assert (lse - lse_ref).abs().max().item() <= LSE_ABS
    delta = fa.attention_delta(ref, do)
    dk, dv = fa._launch_dkdv(q, k, v, do, lse_ref, delta, causal)
    dq = fa._launch_dq(q, k, v, do, lse_ref, delta, causal)
    torch.cuda.synchronize()
    assert (fa.fwd_launch_count, fa.dkdv_launch_count,
            fa.dq_launch_count) == tuple(c + 1 for c in counts)
    dk_ref, dv_ref = fa.flash_bwd_dkdv_reference(q, k, v, do, lse_ref, delta,
                                                 causal)
    dq_ref = fa.flash_bwd_dq_reference(q, k, v, do, lse_ref, delta, causal)
    for name, got, want in (("dk", dk, dk_ref), ("dv", dv, dv_ref),
                            ("dq", dq, dq_ref)):
        assert got.dtype == dtype and torch.isfinite(got).all()
        if S == 1 and name != "dv":
            # one key: dS = 0 analytically, both sides hold rounding noise
            assert got.float().abs().max().item() <= 1e-5
        else:
            _assert_grad_within(got, want, GRAD_TOL[dtype])


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("B,S,H,Hk,D", WGMMA_SHAPES, ids=WGMMA_IDS)
def test_wgmma_backward_kernels_repeat_bit_for_bit(dev, B, S, H, Hk, D,
                                                   causal):
    """Ten more launches of each bf16 backward kernel on the same inputs
    give the first launch's dK, dV and dQ bit for bit (no atomics, one
    fixed summation order)."""
    q, k, v, do = _flash_case(dev, torch.bfloat16, B, S, H, Hk, D, seed=3)
    ref, lse = fa.flash_fwd_reference(q, k, v, causal)
    delta = fa.attention_delta(ref, do)
    first = (*fa._launch_dkdv(q, k, v, do, lse, delta, causal),
             fa._launch_dq(q, k, v, do, lse, delta, causal))
    for _ in range(10):
        again = (*fa._launch_dkdv(q, k, v, do, lse, delta, causal),
                 fa._launch_dq(q, k, v, do, lse, delta, causal))
        assert all(torch.equal(a, b) for a, b in zip(again, first))


@pytest.mark.parametrize("B,S,H,Hk,D", WGMMA_SHAPES, ids=WGMMA_IDS)
def test_wgmma_backward_kernels_count_one_launch_a_call(dev, B, S, H, Hk, D):
    """dkdv_launch_count and dq_launch_count rise by one a call, and only
    through their own kernel."""
    q, k, v, do = _flash_case(dev, torch.bfloat16, B, S, H, Hk, D, seed=4)
    ref, lse = fa.flash_fwd_reference(q, k, v, True)
    delta = fa.attention_delta(ref, do)
    for n in range(3):
        counts = (fa.dkdv_launch_count, fa.dq_launch_count)
        fa._launch_dkdv(q, k, v, do, lse, delta, True)
        assert (fa.dkdv_launch_count, fa.dq_launch_count) == \
            (counts[0] + 1, counts[1])
        fa._launch_dq(q, k, v, do, lse, delta, True)
        assert (fa.dkdv_launch_count, fa.dq_launch_count) == \
            (counts[0] + 1, counts[1] + 1)
    torch.cuda.synchronize()


# the bf16 wgmma forward's block edges: S one row short of, at and past a
# warpgroup's 64 rows and a block's 128, one row, and the trainer's
# length; GQA groups 1, 4 and 8 (H, Hk); D 64 and 128
FWD_EDGE_S = [1, 63, 64, 65, 127, 128, 129, 2048]
FWD_EDGE_HEADS = [(4, 4), (8, 2), (8, 1)]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("H,Hk", FWD_EDGE_HEADS, ids=["g1", "g4", "g8"])
@pytest.mark.parametrize("S", FWD_EDGE_S)
def test_wgmma_forward_at_block_edges(dev, S, H, Hk, D, causal):
    """The bf16 forward kernel against its plain version (out at TOL, lse
    within LSE_ABS), one launch a call; two sequences a batch below 2,048
    rows, so a block's rows never run into the next sequence's."""
    B = 2 if S < 2048 else 1
    q, k, v, _ = _flash_case(dev, torch.bfloat16, B, S, H, Hk, D, seed=5)
    n = fa.fwd_launch_count
    out, lse = fa._launch_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    assert fa.fwd_launch_count == n + 1
    ref, lse_ref = fa.flash_fwd_reference(q, k, v, causal)
    assert out.dtype == torch.bfloat16 and lse.shape == (B, H, S)
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    _assert_within(_rows(out), _rows(ref), torch.bfloat16)
    assert (lse - lse_ref).abs().max().item() <= LSE_ABS


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("B,S,H,Hk,D", WGMMA_SHAPES, ids=WGMMA_IDS)
def test_wgmma_forward_repeats_bit_for_bit(dev, B, S, H, Hk, D, causal):
    """Ten more launches of the bf16 forward on the same inputs give the
    first launch's out and lse bit for bit."""
    q, k, v, _ = _flash_case(dev, torch.bfloat16, B, S, H, Hk, D, seed=6)
    first = fa._launch_fwd(q, k, v, causal)
    for _ in range(10):
        again = fa._launch_fwd(q, k, v, causal)
        assert all(torch.equal(a, b) for a, b in zip(again, first))


@pytest.mark.parametrize("B,S,H,Hk,D", WGMMA_SHAPES, ids=WGMMA_IDS)
def test_wgmma_forward_counts_one_launch_a_call(dev, B, S, H, Hk, D):
    """fwd_launch_count rises by one a call of the forward kernel and not
    through the backward kernels."""
    q, k, v, do = _flash_case(dev, torch.bfloat16, B, S, H, Hk, D, seed=7)
    for _ in range(3):
        counts = (fa.fwd_launch_count, fa.dkdv_launch_count,
                  fa.dq_launch_count)
        out, lse = fa._launch_fwd(q, k, v, True)
        assert (fa.fwd_launch_count, fa.dkdv_launch_count,
                fa.dq_launch_count) == (counts[0] + 1, *counts[1:])
        delta = fa.attention_delta(out, do)
        fa._launch_dkdv(q, k, v, do, lse, delta, True)
        fa._launch_dq(q, k, v, do, lse, delta, True)
        assert fa.fwd_launch_count == counts[0] + 1
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,S,H,Hk,D", [(2, 200, 8, 2, 64),
                                        (1, 130, 4, 4, 128),
                                        (1, 130, 2, 1, 256)],
                         ids=["gqa_S200", "d128_S130", "d256_S130"])
def test_flash_function_gradients_agree_with_autograd_of_the_oracle(
        dev, B, S, H, Hk, D, dtype):
    """The autograd Function on CUDA tensors (three kernel launches) against
    torch autograd through the O(S^2) f32 oracle on the same inputs, in
    the manner of gradcheck: the oracle's gradients are computed by an
    independent route.  f32 at GRAD_TOL; bf16 at ORACLE_BF16, looser
    because the oracle rounds nowhere while the kernels round q * scale,
    p and dS to bf16 (each a relative 2^-9) before their products."""
    q, k, v, do = _flash_case(dev, dtype, B, S, H, Hk, D, seed=1)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    counts = (fa.fwd_launch_count, fa.dkdv_launch_count, fa.dq_launch_count)
    out = fa.attention(*leaves, causal=True)
    out.backward(do)
    torch.cuda.synchronize()
    assert (fa.fwd_launch_count, fa.dkdv_launch_count,
            fa.dq_launch_count) == tuple(c + 1 for c in counts)
    oracle = [x.float().clone().requires_grad_(True) for x in (q, k, v)]
    ref = fa._ref_attention(*oracle, True)
    ref.backward(do.float())
    tol = GRAD_TOL[dtype] if dtype == torch.float32 else ORACLE_BF16
    for got, want in [(out, ref)] + [(x.grad, o.grad)
                                     for x, o in zip(leaves, oracle)]:
        _assert_grad_within(got, want, tol)


def test_flash_wrapper_refuses_what_the_kernels_do_not_take(dev):
    q, k, v, _ = _flash_case(dev, torch.float32, 1, 64, 4, 2, 64)
    with pytest.raises(ValueError, match="dtype"):
        fa.attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="Sq == Sk"):
        fa._launch_fwd(q, k[:, :32], v[:, :32], True)
    with pytest.raises(ValueError, match="head dim"):
        fa._launch_fwd(q[..., :32].contiguous(), k[..., :32].contiguous(),
                       v[..., :32].contiguous(), False)


@pytest.mark.parametrize("D", [64, 128, 256, 384, 512])
def test_sdpa_routes_head_dims_by_the_jax_rule(dev, D):
    """``scaled_dot_product_attention`` sends every head dim the JAX rule
    takes to the flash kernels, which launch at each of them (forward and
    both backward kernels once each); no plain version runs on the
    card."""
    from paddle_tpu_torch.nn import functional as F
    q, k, v, do = _flash_case(dev, torch.bfloat16, 1, 128, 4, 2, D, seed=2)
    q.requires_grad_(True)
    counts = (fa.fwd_launch_count, fa.dkdv_launch_count, fa.dq_launch_count)
    out = F.scaled_dot_product_attention(q, k, v, is_causal=True)
    out.backward(do)
    torch.cuda.synchronize()
    assert (fa.fwd_launch_count, fa.dkdv_launch_count,
            fa.dq_launch_count) == tuple(c + 1 for c in counts)
    ref, _ = fa.flash_fwd_reference(q.detach(), k, v, True)
    _assert_within(_rows(out.detach()), _rows(ref), torch.bfloat16)


@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat"])
def test_train_step_goes_through_the_kernels(dev, remat):
    """Two f32 steps of a 2-layer model on the card: every attention goes
    through the three kernels (forward twice a layer under remat) and no
    plain version runs; the losses equal the CPU run's (the plain
    versions) to rtol 1e-4, both sides f32 without TF32."""
    from paddle_tpu_torch.models.llama import LlamaConfig
    from paddle_tpu_torch.parallel import transformer as pt
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = LlamaConfig(vocab_size=256, hidden_size=256, intermediate_size=512,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, max_position_embeddings=200)
    hp = pt.HybridParallelConfig(remat=remat)
    toks = np.random.default_rng(0).integers(0, 256, (2, 2, 200))
    losses = {}
    for where in ("cpu", "cuda"):
        params = pt.init_params(cfg, hp, seed=0, device="cpu")
        params = pt.from_jax_params(pt.to_numpy(params), device=where)
        opt = pt.init_opt_state(params)
        step = pt.build_train_step(cfg, hp, device=where)
        fa.fwd_launch_count = fa.dkdv_launch_count = fa.dq_launch_count = 0
        if where == "cuda":
            plain = (fa.flash_fwd_reference, fa.flash_bwd_reference)

            def refuse(*a, **kw):
                raise AssertionError("a plain version ran on the card")
            fa.flash_fwd_reference = fa.flash_bwd_reference = refuse
        try:
            losses[where] = [float(step(params, opt, t)[2]) for t in toks]
        finally:
            if where == "cuda":
                fa.flash_fwd_reference, fa.flash_bwd_reference = plain
    L, steps = cfg.num_hidden_layers, len(toks)
    assert fa.fwd_launch_count == (2 if remat else 1) * L * steps
    assert fa.dkdv_launch_count == fa.dq_launch_count == L * steps
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)


# ---------------------------------------------------------------------------
# paged decode (blha): the decode kernel against its plain version, which
# rounds q * scale and p to the storage type as the kernel does, so both
# dtypes are held at TOL.
# ---------------------------------------------------------------------------

def _decode_case(dev, dtype, B, H, Hkv, D, bs, lens, seed=0):
    """Tables padded with -1 past each row's pages, pages permuted."""
    rng = np.random.default_rng(seed)
    nblk = -(-max(lens) // bs)
    num_blocks = 1 + sum(-(-n // bs) for n in lens)
    bt = np.full((B, nblk), -1, np.int32)
    pages = rng.permutation(np.arange(1, num_blocks))
    used = 0
    for b, n in enumerate(lens):
        m = -(-n // bs)
        bt[b, :m] = pages[used:used + m]
        used += m
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*s):
        return torch.randn(s, generator=g, device=dev).to(dtype)
    return (randn(B, H, D), randn(num_blocks, Hkv, bs, D),
            randn(num_blocks, Hkv, bs, D), torch.from_numpy(bt).to(dev),
            torch.tensor(lens, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("H,Hkv,D,bs", [
    (4, 4, 64, 8), (8, 2, 64, 16), (32, 32, 128, 64), (32, 8, 128, 64),
    (16, 2, 128, 32), (8, 8, 128, 128), (12, 3, 64, 24)])
def test_decode_kernel_matches_plain_version(dev, dtype, H, Hkv, D, bs):
    lens = [1, 9, 300, 64, 65, 130]
    q, kc, vc, bt, ln = _decode_case(dev, dtype, len(lens), H, Hkv, D, bs,
                                     lens)
    before, ragged = pa.decode_launch_count, pa.launch_count
    out = pa.paged_decode_attention(q, kc, vc, bt, ln)
    torch.cuda.synchronize()
    assert pa.decode_launch_count == before + 1
    assert pa.launch_count == ragged
    ref = pa.paged_decode_plain(q, kc, vc, bt, ln)
    assert out.dtype == dtype and torch.isfinite(out).all()
    _assert_within(out, ref, dtype)


def test_decode_kernel_at_the_7b_blha_shape(dev):
    lens = [100, 2000, 731, 1290, 5, 64, 65, 1999]
    for dtype in (torch.float32, torch.bfloat16):
        ops = _decode_case(dev, dtype, 8, 32, 32, 128, 64, lens, seed=3)
        _assert_within(pa.paged_decode_attention(*ops),
                       pa.paged_decode_plain(*ops), dtype)


def test_decode_kernel_refuses_what_it_does_not_take(dev):
    ops = list(_decode_case(dev, torch.float32, 2, 4, 4, 64, 8, [5, 9]))
    with pytest.raises(ValueError, match="paged decode kernel"):
        pa.paged_decode_attention(ops[0].half(), ops[1].half(),
                                  ops[2].half(), *ops[3:])
    with pytest.raises(ValueError, match="paged decode kernel"):
        pa.paged_decode_attention_packed(*ops[:4], ops[4][:1])
    off_rule = _decode_case(dev, torch.float32, 2, 4, 4, 96, 8, [5, 9])
    with pytest.raises(ValueError, match="rule"):
        pa.paged_decode_attention(*off_rule)


# ---------------------------------------------------------------------------
# the paged walk's edges (csrc/ragged_paged_attention.cu cuts a launch into
# query tiles and key splits of about 512 keys): rows of one key, of a split
# less one, a split, a split and one, and 2,000 keys; a chunk that resumes
# mid-page and is not a multiple of a tile; a 70-token prefill (one more
# than a tile); tiles next to decode rows; pad tokens; G 1/4/8, bs 16/64,
# D 64/128, f32 and bf16, each entry one launch; repeats bit for bit; the
# split counters reset between launches of different shapes.
# ---------------------------------------------------------------------------

WALK_ROWS = [(37, 100), (1, 1), (1, 511), (1, 512), (1, 513), (1, 2000),
             (70, 70), (1, 33)]
WALK_TQ = 120                                 # 113 live tokens, 7 pad
WALK_LENS = [1, 511, 512, 513, 2000, 64, 17]
WALK_HEADS = {"G1": (8, 8), "G4": (16, 4), "G8": (16, 2)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("bs", [16, 64])
@pytest.mark.parametrize("group", list(WALK_HEADS))
def test_paged_walk_edges_match_plain_versions(dev, group, bs, D, dtype):
    H, Hkv = WALK_HEADS[group]
    nblk = -(-2000 // bs)
    ops = _case(dev, dtype, H, Hkv, D, bs, WALK_ROWS, WALK_TQ, nblk, seed=6)
    before = pa.launch_count
    out = pa.ragged_paged_attention_segrel_packed(*ops)
    torch.cuda.synchronize()
    assert pa.launch_count == before + 1
    assert torch.isfinite(out).all()             # pad rows too
    _assert_within(out, pa.ragged_paged_reference_segrel(*ops), dtype)
    qops = _quant_case(dev, dtype, H, Hkv, D, bs, WALK_ROWS, WALK_TQ, nblk,
                       seed=7)
    before = pa.quant_launch_count
    out = pa.ragged_paged_attention_quant_segrel_packed(*qops)
    torch.cuda.synchronize()
    assert pa.quant_launch_count == before + 1
    assert torch.isfinite(out).all()
    _assert_within(out, pa.ragged_paged_reference_quant_segrel(
        qops[0].float(), *qops[1:]), dtype)
    dops = _decode_case(dev, dtype, len(WALK_LENS), H, Hkv, D, bs,
                        WALK_LENS, seed=8)
    before = pa.decode_launch_count
    out = pa.paged_decode_attention(*dops)
    torch.cuda.synchronize()
    assert pa.decode_launch_count == before + 1
    _assert_within(out, pa.paged_decode_plain(*dops), dtype)


def _walk_entries(dev, dtype=torch.bfloat16, H=32, Hkv=8, D=128, bs=16,
                  seed=9):
    """The three entries at a split-heavy shape, as thunks."""
    nblk = -(-2000 // bs)
    ops = _case(dev, dtype, H, Hkv, D, bs, WALK_ROWS, WALK_TQ, nblk, seed)
    qops = _quant_case(dev, dtype, H, Hkv, D, bs, WALK_ROWS, WALK_TQ, nblk,
                       seed)
    dops = _decode_case(dev, dtype, len(WALK_LENS), H, Hkv, D, bs,
                        WALK_LENS, seed)
    return {"float": lambda: pa.ragged_paged_attention_segrel_packed(*ops),
            "int8": lambda: pa.ragged_paged_attention_quant_segrel_packed(
                *qops),
            "decode": lambda: pa.paged_decode_attention(*dops)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_paged_walk_repeats_bit_for_bit(dev, dtype):
    """Ten launches of each entry give the same bits: the splits merge in
    split order whichever finishes last."""
    for name, run in _walk_entries(dev, dtype).items():
        first = run()
        for _ in range(10):
            assert torch.equal(run(), first), name


def test_paged_walk_counts_one_launch_a_call(dev):
    counts = {"float": "launch_count", "int8": "quant_launch_count",
              "decode": "decode_launch_count"}
    for name, run in _walk_entries(dev).items():
        before = {c: getattr(pa, c) for c in counts.values()}
        run()
        torch.cuda.synchronize()
        for entry, c in counts.items():
            assert getattr(pa, c) == before[c] + (entry == name), (name, c)


def test_paged_walk_counters_reset_between_shapes(dev):
    """Two shapes back to back and back again: each launch leaves the
    split counters at zero, so the repeat gives the first call's bits."""
    a = _walk_entries(dev, H=32, Hkv=8, D=128, bs=16, seed=10)
    b = _walk_entries(dev, H=8, Hkv=8, D=64, bs=64, seed=11)
    first = {k: run() for k, run in a.items()}
    for run in b.values():
        run()
    for k, run in a.items():
        assert torch.equal(run(), first[k]), k
    torch.cuda.synchronize()
    assert not any(c.any() for c, _ in pa._workspace.values())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("group", ["G1", "G8"])
def test_public_segrel_entries_take_shuffled_tokens(dev, group, dtype):
    """The unpacked entries order the tokens by seg before the walk (which
    wants seg non-decreasing) and hand the outputs back in the caller's
    order, so a shuffled launch holds the plain version, which takes any
    order.  Shuffled, seg would give the walk far more runs than its tile
    bound (at G 1 a bf16 tile is 64 tokens)."""
    H, Hkv = WALK_HEADS[group]
    D, bs = 128, 16
    nblk = -(-2000 // bs)
    perm = torch.from_numpy(
        np.random.default_rng(12).permutation(WALK_TQ)).to(dev)
    q, kc, vc, bt, seg, rel = _case(dev, dtype, H, Hkv, D, bs, WALK_ROWS,
                                    WALK_TQ, nblk, seed=12)
    ops = (q[perm], kc, vc, bt, seg[perm], rel[perm])
    before = pa.launch_count
    out = pa.ragged_paged_attention_segrel(*ops)
    torch.cuda.synchronize()
    assert pa.launch_count == before + 1
    assert torch.isfinite(out).all()
    _assert_within(out, pa.ragged_paged_reference_segrel(*ops), dtype)
    q, k8, v8, ks, vs, bt, seg, rel = _quant_case(
        dev, dtype, H, Hkv, D, bs, WALK_ROWS, WALK_TQ, nblk, seed=13)
    qops = (q[perm], k8, v8, ks, vs, bt, seg[perm], rel[perm])
    before = pa.quant_launch_count
    out = pa.ragged_paged_attention_quant_segrel(*qops)
    torch.cuda.synchronize()
    assert pa.quant_launch_count == before + 1
    assert torch.isfinite(out).all()
    _assert_within(out, pa.ragged_paged_reference_quant_segrel(
        qops[0].float(), *qops[1:]), dtype)


@pytest.mark.parametrize("order", ["shuffled", "one_swap"])
def test_packed_walk_writes_nan_where_seg_falls(dev, order):
    """The packed entries take seg non-decreasing (the walk's tile bound
    holds only then).  A launch whose seg falls -- shuffled, past the
    bound, or two decode tokens swapped, within it -- writes NaN over its
    whole output rather than drop tiles, leaves the counters at zero, and
    the next ordered launch holds the plain version."""
    H, Hkv, D, bs, dtype = 8, 8, 128, 16, torch.bfloat16
    nblk = -(-2000 // bs)
    if order == "shuffled":
        perm = np.random.default_rng(14).permutation(WALK_TQ)
    else:                                # tokens 40 and 41: decode rows
        perm = np.arange(WALK_TQ)
        perm[[40, 41]] = [41, 40]
    perm = torch.from_numpy(perm).to(dev)
    ops = _case(dev, dtype, H, Hkv, D, bs, WALK_ROWS, WALK_TQ, nblk, seed=14)
    qops = _quant_case(dev, dtype, H, Hkv, D, bs, WALK_ROWS, WALK_TQ, nblk,
                       seed=15)
    for entry, args in ((pa.ragged_paged_attention_segrel_packed, ops),
                        (pa.ragged_paged_attention_quant_segrel_packed,
                         qops)):
        q, *mid, seg, rel = args
        out = entry(q[perm], *mid, seg[perm], rel[perm])
        torch.cuda.synchronize()
        assert torch.isnan(out).all(), entry.__name__
    assert not any(c.any() for c, _ in pa._workspace.values())
    _assert_within(pa.ragged_paged_attention_segrel_packed(*ops),
                   pa.ragged_paged_reference_segrel(*ops), dtype)


# ---------------------------------------------------------------------------
# varlen flash attention: the forward, dK/dV and dQ kernels against their
# plain versions (out at TOL over [Tq, H * D] rows, lse to LSE_ABS where
# finite and -inf where the plain version has it, gradients at GRAD_TOL),
# and flash_attn_unpadded / block_multihead_attention going through them.
# ---------------------------------------------------------------------------

VARLEN_CASES = {  # (lens_q, lens_k or None for self attention), H, D
    "mixed_d64": (([7, 130, 0, 55, 64, 1], None), 4, 64),
    "d128": (([200, 33, 90], None), 2, 128),
    "d256": (([70, 3, 100], None), 2, 256),
    "cross_keyless": (([30, 40, 50, 5], [100, 0, 260, 1]), 2, 64),
}


def _varlen_case(dev, dtype, lens_q, lens_k, H, D, seed=0):
    lens_k = lens_q if lens_k is None else lens_k
    cu_q = np.concatenate([[0], np.cumsum(lens_q)]).astype(np.int32)
    cu_k = np.concatenate([[0], np.cumsum(lens_k)]).astype(np.int32)
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*s):
        return torch.randn(s, generator=g, device=dev).to(dtype)
    Tq, Tk = int(cu_q[-1]), int(cu_k[-1])
    return (randn(Tq, H, D), randn(Tk, H, D), randn(Tk, H, D),
            randn(Tq, H, D), torch.from_numpy(cu_q).to(dev),
            torch.from_numpy(cu_k).to(dev))


def _assert_lse(lse, ref):
    fin = torch.isfinite(ref)
    assert torch.equal(fin, torch.isfinite(lse))
    assert (ref[~fin] == float("-inf")).all() and \
        (lse[~fin] == float("-inf")).all()
    assert (lse[fin] - ref[fin]).abs().max().item() <= LSE_ABS


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case,causal", [
    pytest.param(name, causal, id=f"{name}-{'causal' if causal else 'full'}")
    for name, ((_, lens_k), _, _) in VARLEN_CASES.items()
    for causal in (True, False) if not (causal and lens_k)])
def test_varlen_kernels_match_plain_versions(dev, case, dtype, causal):
    """Causal attention pairs a query with its own sequence, so the cross
    case runs non-causal only."""
    (lens_q, lens_k), H, D = VARLEN_CASES[case]
    q, k, v, do, cu_q, cu_k = _varlen_case(dev, dtype, lens_q, lens_k, H, D)
    scale = D ** -0.5
    counts = (fav.fwd_launch_count, fav.dkdv_launch_count,
              fav.dq_launch_count)
    out, lse = fav._launch_fwd(q, k, v, cu_q, cu_k, causal, scale)
    ref, lse_ref = fav.varlen_fwd_reference(q, k, v, cu_q, cu_k, causal,
                                            scale)
    assert out.dtype == dtype and lse.shape == (H, q.shape[0])
    assert torch.isfinite(out).all()
    _assert_within(out.flatten(1), ref.flatten(1), dtype)
    _assert_lse(lse, lse_ref)
    delta = fav.varlen_delta(ref, do)
    args = (do, lse_ref, delta, cu_q, cu_k, causal, scale)
    dk, dv = fav._launch_dkdv(q, k, v, *args)
    dq = fav._launch_dq(q, k, v, *args)
    torch.cuda.synchronize()
    assert (fav.fwd_launch_count, fav.dkdv_launch_count,
            fav.dq_launch_count) == tuple(c + 1 for c in counts)
    dk_ref, dv_ref = fav.varlen_bwd_dkdv_reference(q, k, v, *args)
    dq_ref = fav.varlen_bwd_dq_reference(q, k, v, *args)
    for got, want in ((dk, dk_ref), (dv, dv_ref), (dq, dq_ref)):
        assert got.dtype == dtype and torch.isfinite(got).all()
        _assert_grad_within(got, want, GRAD_TOL[dtype])
    if lens_k is not None:                  # key-less query rows
        assert (out[30:70] == 0).all() and (dq[30:70] == 0).all()


# the bf16 wgmma varlen forward's edges (128 queries a block, 64 a
# warpgroup): fewer than 128 tokens; a block whose second warpgroup has no
# rows (Tq 60, and Tq 140's second block); empty and one-token sequences;
# cross attention; a sequence with no keys (its rows: 0 and lse -inf)
VARLEN_FWD_EDGES = {  # lens_q, lens_k or None for self attention
    "tq80": ([50, 30], None),
    "tq60_wg1_empty": ([40, 20], None),
    "tq140": ([100, 40], None),
    "empty_and_one": ([0, 1, 70, 0, 1, 130], None),
    "long_mixed": ([700, 1, 300, 129], None),
    "cross": ([100, 60, 5], [300, 20, 200]),
    "keyless": ([30, 40, 50], [100, 0, 70]),
}


def _edge_params(cases):
    """(name, causal) of each case: causal for self attention only."""
    for name, (_, lens_k) in cases.items():
        for causal in (True, False):
            if not (causal and lens_k):
                yield pytest.param(
                    name, causal, id=f"{name}-{'causal' if causal else 'full'}")


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("case,causal", list(_edge_params(VARLEN_FWD_EDGES)))
def test_varlen_wgmma_forward_at_block_edges(dev, case, causal, D):
    """The bf16 varlen forward kernel against its plain version (out at
    TOL, lse finite and within LSE_ABS where the plain version's is, -inf
    where it is), one launch a call; key-less rows are exactly 0."""
    lens_q, lens_k = VARLEN_FWD_EDGES[case]
    q, k, v, _, cu_q, cu_k = _varlen_case(dev, torch.bfloat16, lens_q,
                                          lens_k, 4, D, seed=8)
    args = (cu_q, cu_k, causal, D ** -0.5)
    n = fav.fwd_launch_count
    out, lse = fav._launch_fwd(q, k, v, *args)
    torch.cuda.synchronize()
    assert fav.fwd_launch_count == n + 1
    ref, lse_ref = fav.varlen_fwd_reference(q, k, v, *args)
    assert out.dtype == torch.bfloat16 and lse.shape == (4, q.shape[0])
    assert torch.isfinite(out).all()
    _assert_within(out.flatten(1), ref.flatten(1), torch.bfloat16)
    _assert_lse(lse, lse_ref)
    keyless = torch.isneginf(lse_ref).all(0)
    assert (out[keyless] == 0).all()
    if case == "keyless":
        assert keyless[30:70].all()


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("case", ["tq140", "long_mixed", "cross"])
def test_varlen_wgmma_forward_repeats_bit_for_bit(dev, case, D):
    lens_q, lens_k = VARLEN_FWD_EDGES[case]
    q, k, v, _, cu_q, cu_k = _varlen_case(dev, torch.bfloat16, lens_q,
                                          lens_k, 4, D, seed=9)
    args = (cu_q, cu_k, lens_k is None, D ** -0.5)
    first = fav._launch_fwd(q, k, v, *args)
    for _ in range(10):
        again = fav._launch_fwd(q, k, v, *args)
        assert all(torch.equal(a, b) for a, b in zip(again, first))


# the bf16 wgmma varlen backward's edges (128 rows a block, 64 a
# warpgroup, on both sides): fewer than 64 and than 128 tokens; blocks
# whose second warpgroup has no rows and no keys (Tq = Tk = 140); empty and
# one-token sequences; lengths off multiples of 64; cross attention; a
# sequence without keys (its rows' dq is 0) and one without queries (its
# keys' dk and dv are 0)
VARLEN_BWD_EDGES = {  # lens_q, lens_k or None for self attention
    "tq50": ([30, 20], None),
    "tq100": ([60, 40], None),
    "tq140_wg1_empty": ([100, 40], None),
    "empty_and_one": ([0, 1, 70, 0, 1, 130], None),
    "off_64": ([65, 127, 129, 200, 3], None),
    "cross": ([100, 60, 5], [300, 20, 200]),
    "keyless": ([30, 40, 50], [100, 0, 70]),
    "queryless": ([30, 0, 50], [100, 80, 70]),
}


def _varlen_bwd_inputs(dev, case, D, seed, causal=None):
    """The case's bf16 inputs and the plain forward's lse and delta, which
    both backward kernels and their plain versions are fed."""
    lens_q, lens_k = VARLEN_BWD_EDGES[case]
    q, k, v, do, cu_q, cu_k = _varlen_case(dev, torch.bfloat16, lens_q,
                                           lens_k, 4, D, seed=seed)
    causal = lens_k is None if causal is None else causal
    args = (cu_q, cu_k, causal, D ** -0.5)
    ref, lse = fav.varlen_fwd_reference(q, k, v, *args)
    return (q, k, v, do, lse, fav.varlen_delta(ref, do)), args


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("case,causal", list(_edge_params(VARLEN_BWD_EDGES)))
def test_varlen_wgmma_backward_at_block_edges(dev, case, causal, D):
    """The bf16 varlen dK/dV and dQ kernels against their plain versions
    (GRAD_TOL), one launch of each a call; dq of key-less rows and dk, dv
    of query-less keys are exactly 0."""
    x, args = _varlen_bwd_inputs(dev, case, D, 10, causal)
    counts = (fav.dkdv_launch_count, fav.dq_launch_count)
    dk, dv = fav._launch_dkdv(*x, *args)
    dq = fav._launch_dq(*x, *args)
    torch.cuda.synchronize()
    assert (fav.dkdv_launch_count, fav.dq_launch_count) == \
        (counts[0] + 1, counts[1] + 1)
    want = (*fav.varlen_bwd_dkdv_reference(*x, *args),
            fav.varlen_bwd_dq_reference(*x, *args))
    for got, ref in zip((dk, dv, dq), want):
        assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
        _assert_grad_within(got, ref, GRAD_TOL[torch.bfloat16])
    if case == "keyless":
        assert (dq[30:70] == 0).all()
    if case == "queryless":
        assert (dk[100:180] == 0).all() and (dv[100:180] == 0).all()


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("case", ["tq140_wg1_empty", "off_64", "cross"])
def test_varlen_wgmma_backward_repeats_bit_for_bit(dev, case, D):
    """Ten more launches of each bf16 varlen backward kernel give the
    first launch's dK, dV and dQ bit for bit (no atomics, one summation
    order)."""
    x, args = _varlen_bwd_inputs(dev, case, D, 11)
    first = (*fav._launch_dkdv(*x, *args), fav._launch_dq(*x, *args))
    for _ in range(10):
        again = (*fav._launch_dkdv(*x, *args), fav._launch_dq(*x, *args))
        assert all(torch.equal(a, b) for a, b in zip(again, first))


@pytest.mark.parametrize("D", [64, 128])
def test_varlen_backward_computes_its_metadata_once_a_call(dev, D,
                                                           monkeypatch):
    """``_backward`` on CUDA tensors: one ``_bwd_meta`` and one launch of
    each backward kernel a call, and the gradients its launches give
    alone."""
    x, args = _varlen_bwd_inputs(dev, "off_64", D, 12)
    q, k, v, do, lse, _ = x
    out, _ = fav.varlen_fwd_reference(q, k, v, *args)
    made = []
    real = fav._bwd_meta
    monkeypatch.setattr(fav, "_bwd_meta",
                        lambda *a: made.append(1) or real(*a))
    for n in range(1, 4):
        counts = (fav.dkdv_launch_count, fav.dq_launch_count)
        dq, dk, dv = fav._backward(q, k, v, out, lse, do, *args)
        assert len(made) == n
        assert (fav.dkdv_launch_count, fav.dq_launch_count) == \
            (counts[0] + 1, counts[1] + 1)
    alone = (fav._launch_dq(*x, *args), *fav._launch_dkdv(*x, *args))
    assert all(torch.equal(a, b) for a, b in zip((dq, dk, dv), alone))


def test_varlen_kernels_at_the_7b_shape(dev):
    """LLaMA-7B's attention (H 32, D 128) over 4 packed causal sequences
    (4,232 tokens, the longest 2,048), both dtypes."""
    lens = [2048, 1200, 700, 284]
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, do, cu, _ = _varlen_case(dev, dtype, lens, None, 32, 128,
                                          seed=4)
        args = (cu, cu, True, 128 ** -0.5)
        out, lse = fav._launch_fwd(q, k, v, *args)
        ref, lse_ref = fav.varlen_fwd_reference(q, k, v, *args)
        _assert_within(out.flatten(1), ref.flatten(1), dtype)
        _assert_lse(lse, lse_ref)
        delta = fav.varlen_delta(ref, do)
        grads = (fav._launch_dq(q, k, v, do, lse_ref, delta, *args),
                 *fav._launch_dkdv(q, k, v, do, lse_ref, delta, *args))
        del out, lse, ref
        want = (fav.varlen_bwd_dq_reference(q, k, v, do, lse_ref, delta,
                                            *args),
                *fav.varlen_bwd_dkdv_reference(q, k, v, do, lse_ref, delta,
                                               *args))
        for got, ref_g in zip(grads, want):
            _assert_grad_within(got, ref_g, GRAD_TOL[dtype])
        del q, k, v, do, grads, want
        torch.cuda.empty_cache()


def test_varlen_kernels_repeat_bit_for_bit(dev):
    (lens, _), H, D = VARLEN_CASES["mixed_d64"]
    q, k, v, do, cu, _ = _varlen_case(dev, torch.bfloat16, lens, None, H, D)
    args = (cu, cu, True, D ** -0.5)
    out, lse = fav._launch_fwd(q, k, v, *args)
    delta = fav.varlen_delta(out, do)
    first = (out, lse, *fav._launch_dkdv(q, k, v, do, lse, delta, *args),
             fav._launch_dq(q, k, v, do, lse, delta, *args))
    for _ in range(5):
        again = (*fav._launch_fwd(q, k, v, *args),
                 *fav._launch_dkdv(q, k, v, do, lse, delta, *args),
                 fav._launch_dq(q, k, v, do, lse, delta, *args))
        assert all(torch.equal(a, b) for a, b in zip(again, first))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_attn_unpadded_autograd_goes_through_the_kernels(dev, dtype):
    """``flash_attn_unpadded`` on CUDA tensors: one launch of each kernel
    for a forward and backward, gradients against torch autograd through
    the f32 segment-masked composition (f32 at GRAD_TOL, bf16 at
    ORACLE_BF16); GQA takes the composition and launches nothing."""
    from paddle_tpu_torch.nn.functional import flash_attn_unpadded
    from paddle_tpu_torch.nn.functional.attention import _unpadded_impl
    (lens, _), H, D = VARLEN_CASES["mixed_d64"]
    q, k, v, do, cu, _ = _varlen_case(dev, dtype, lens, None, H, D, seed=1)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    fav.fwd_launch_count = fav.dkdv_launch_count = fav.dq_launch_count = 0
    out, _ = flash_attn_unpadded(*leaves, cu, cu, 130, 130, D ** -0.5,
                                 causal=True)
    (out.float() * do.float()).sum().backward()
    torch.cuda.synchronize()
    assert (fav.fwd_launch_count, fav.dkdv_launch_count,
            fav.dq_launch_count) == (1, 1, 1)
    oracle = [x.float().clone().requires_grad_(True) for x in (q, k, v)]
    ref = _unpadded_impl(*oracle, cu, cu, scale=D ** -0.5, causal=True)
    (ref * do.float()).sum().backward()
    tol = GRAD_TOL[dtype] if dtype == torch.float32 else ORACLE_BF16
    for got, want in [(out, ref)] + [(x.grad, o.grad)
                                     for x, o in zip(leaves, oracle)]:
        _assert_grad_within(got, want, tol)
    flash_attn_unpadded(q, k[:, :2].contiguous(), v[:, :2].contiguous(), cu,
                        cu, 130, 130, D ** -0.5, causal=True)
    assert fav.fwd_launch_count == 1


def test_varlen_wrapper_refuses_what_the_kernels_do_not_take(dev):
    (lens, _), H, D = VARLEN_CASES["mixed_d64"]
    q, k, v, _, cu, _ = _varlen_case(dev, torch.float32, lens, None, H, D)
    with pytest.raises(ValueError, match="dtype"):
        fav._launch_fwd(q.half(), k.half(), v.half(), cu, cu, True, 0.1)
    with pytest.raises(ValueError, match="head dim"):
        sl = [x[..., :32].contiguous() for x in (q, k, v)]
        fav._launch_fwd(*sl, cu, cu, True, 0.1)
    with pytest.raises(ValueError, match="heads"):
        fav._launch_fwd(q, k[:, :2].contiguous(), v[:, :2].contiguous(), cu,
                        cu, True, 0.1)
    with pytest.raises(ValueError, match="cu_seqlens"):
        fav._launch_fwd(q, k, v, cu.long(), cu, True, 0.1)


def _blha_trace_case(dev, dtype, H=4, D=64, bs=16, seed=0):
    rng = np.random.default_rng(seed)
    B, nblk = 4, 8
    bt = rng.permutation(np.arange(B * nblk)).reshape(B, nblk).astype(
        np.int32)
    kc = torch.zeros((B * nblk, H, bs, D), dtype=dtype, device=dev)
    return rng, bt, kc, kc.clone()


def test_block_multihead_attention_goes_through_the_kernels(dev):
    """A prefill step, a mixed step and decode steps on the card: one
    varlen forward per prefill part and one decode launch per decode part,
    no plain version run; outputs equal the CPU run's (the plain versions)
    at f32 TOL and the caches bit for bit."""
    from paddle_tpu_torch.incubate.nn.functional import \
        block_multihead_attention as blha
    H, D, bs = 4, 64, 16
    runs = {}
    for where in ("cpu", "cuda"):
        rng, bt, kc, vc = _blha_trace_case(where, torch.float32, H, D, bs)
        steps = [([40, 7, 0, 0], [0, 0, 0, 0], [40, 7, 0, 0])]
        steps.append(([40, 7, 20, 0], [40, 7, 0, 0], [1, 1, 20, 0]))
        for i in range(3):
            steps.append(([40, 7, 20, 0], [41 + i, 8 + i, 20 + i, 0],
                          [1, 1, 1, 0]))
        outs = []
        plain = (fav.varlen_fwd_reference, pa.paged_decode_plain)
        if where == "cuda":
            def refuse(*a, **kw):
                raise AssertionError("a plain version ran on the card")
            fav.varlen_fwd_reference = pa.paged_decode_plain = refuse
        fav.fwd_launch_count = pa.decode_launch_count = 0
        try:
            for enc, dec, this in steps:
                sel = [b for b in range(4) if this[b] > 0]
                T = sum(this)
                qkv = torch.from_numpy(rng.standard_normal(
                    (T, 3 * H * D)).astype(np.float32)).to(where)
                out, _, kc2, vc2 = blha(
                    qkv, kc, vc, np.array(enc)[sel], np.array(dec)[sel],
                    np.array(this)[sel],
                    block_tables=torch.from_numpy(bt[sel]).to(where),
                    block_size=bs)
                assert kc2 is kc and vc2 is vc
                outs.append(out.cpu())
        finally:
            fav.varlen_fwd_reference, pa.paged_decode_plain = plain
        runs[where] = (outs, kc.cpu(), vc.cpu(),
                       (fav.fwd_launch_count, pa.decode_launch_count))
    assert runs["cuda"][3] == (2, 4)
    assert runs["cpu"][3] == (0, 0)
    for got, want in zip(runs["cuda"][0], runs["cpu"][0]):
        _assert_within(got, want, torch.float32)
    assert torch.equal(runs["cuda"][1], runs["cpu"][1])
    assert torch.equal(runs["cuda"][2], runs["cpu"][2])


# ---------------------------------------------------------------------------
# the repaired shapes: every head dim and query group the JAX rules take
# (the specialised kernels keep D 64/128 with G <= 8; the rest goes to the
# kernel that splits G and D over blocks, and to the chunked flash
# kernels), each held to its plain version at TOL
# ---------------------------------------------------------------------------

REPAIR_PAGED = [  # H, Hkv, D, bs
    (4, 2, 256, 16), (4, 4, 384, 16), (16, 1, 128, 16), (32, 1, 64, 8),
    (32, 2, 128, 16), (16, 1, 256, 32), (32, 1, 384, 16)]
REPAIR_IDS = ["d256", "d384", "g16", "g32_d64", "g16_hkv2", "g16_d256",
              "g32_d384"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("H,Hkv,D,bs", REPAIR_PAGED, ids=REPAIR_IDS)
def test_paged_entries_at_repaired_shapes(dev, dtype, H, Hkv, D, bs):
    """The float and int8-page ragged entries and the decode entry, each
    one launch, against their plain versions."""
    rows = [(9, 9), (5, 40), (1, 300), (1, 1), (0, 0), (3, 77)]
    nblk = -(-300 // bs)
    ops = _case(dev, dtype, H, Hkv, D, bs, rows, 24, nblk)
    before = pa.launch_count
    out = pa.ragged_paged_attention_segrel_packed(*ops)
    torch.cuda.synchronize()
    assert pa.launch_count == before + 1
    _assert_within(out, pa.ragged_paged_reference_segrel(*ops), dtype)
    qops = _quant_case(dev, dtype, H, Hkv, D, bs, rows, 24, nblk)
    before = pa.quant_launch_count
    out = pa.ragged_paged_attention_quant_segrel_packed(*qops)
    torch.cuda.synchronize()
    assert pa.quant_launch_count == before + 1
    _assert_within(out, pa.ragged_paged_reference_quant_segrel(
        qops[0].float(), *qops[1:]), dtype)
    lens = [1, 9, 300, 64, 65, 130]
    dops = _decode_case(dev, dtype, len(lens), H, Hkv, D, bs, lens)
    before = pa.decode_launch_count
    out = pa.paged_decode_attention(*dops)
    torch.cuda.synchronize()
    assert pa.decode_launch_count == before + 1
    _assert_within(out, pa.paged_decode_plain(*dops), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("H,Hkv,D", [(4, 4, 512), (8, 2, 1024),
                                     (32, 1, 1024)],
                         ids=["d512", "d1024_gqa", "d1024_g32"])
def test_decode_entry_at_large_head_dims(dev, dtype, H, Hkv, D):
    lens = [1, 17, 200, 64]
    ops = _decode_case(dev, dtype, len(lens), H, Hkv, D, 16, lens, seed=4)
    before = pa.decode_launch_count
    out = pa.paged_decode_attention(*ops)
    torch.cuda.synchronize()
    assert pa.decode_launch_count == before + 1
    _assert_within(out, pa.paged_decode_plain(*ops), dtype)


def test_specialised_paged_shapes_repeat_bit_for_bit(dev):
    """The shapes both kernels could serve stay on the specialised one:
    D 128 with G 8 gives the same bits launch after launch."""
    ops = _case(dev, torch.bfloat16, 32, 4, 128, 16,
                [(1, 700), (5, 40), (1, 1)], 8, 44, seed=5)
    first = pa.ragged_paged_attention_segrel_packed(*ops)
    for _ in range(3):
        assert torch.equal(pa.ragged_paged_attention_segrel_packed(*ops),
                           first)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,S,H,Hk,D", [(1, 130, 4, 2, 384),
                                        (2, 64, 2, 2, 512),
                                        (1, 200, 4, 1, 512)],
                         ids=["d384_gqa_S130", "d512_S64", "d512_mqa_S200"])
def test_flash_kernels_at_large_head_dims(dev, B, S, H, Hk, D, dtype,
                                          causal):
    test_flash_kernels_match_plain_versions(dev, B, S, H, Hk, D, dtype,
                                            causal)


# ---------------------------------------------------------------------------
# fused RMSNorm / LayerNorm: the kernel against its plain version.  float32
# x: each row's max |out - ref| / max |ref| <= 1e-5 (the same f32 math,
# the row sums in another order, the card's rsqrt within 2 ulp).  bfloat16
# x: every element within max(1e-2, one bf16 ulp of the reference) -- 1e-2
# is the JAX package's own hardware bound, and above 2 in magnitude one
# rounding of two f32 values an ulp apart is larger than that -- and
# ||out - ref|| / ||ref|| <= 1e-3, which a 0.5% shift fails.
# ---------------------------------------------------------------------------

def _assert_norm_within(out, ref):
    d = (out.float() - ref.float()).abs()
    r = ref.float()
    if out.dtype == torch.float32:
        rows = d.reshape(-1, d.shape[-1]).amax(1) / \
            r.reshape(-1, r.shape[-1]).abs().amax(1).clamp_min(1e-30)
        assert rows.max().item() <= 1e-5, rows.max().item()
        return
    ulp = torch.exp2(torch.floor(torch.log2(r.abs().clamp_min(2.0 ** -126)))
                     - 7)
    assert bool((d <= torch.maximum(ulp, torch.full_like(ulp, 1e-2))).all())
    assert (d.norm() / r.norm()).item() <= 1e-3


def _norm_case(dev, R, H, xdt, wdt, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((R, H), generator=g, device=dev).to(xdt)
    w = (1 + 0.1 * torch.randn(H, generator=g, device=dev)).to(wdt)
    b = (0.1 * torch.randn(H, generator=g, device=dev)).to(wdt)
    return x, w, b


# the last five: the fused decoder's prefill rows (2,984 and 616) and a
# 2,048-row step at LLaMA-7B's width, a wide decode row, and a row wider
# than the walk's shared-memory slot in float32 (the one-block-a-row kernel)
NORM_SHAPES = [(8, 4096), (2048, 1024), (16, 128), (8, 32768), (24, 11008),
               (2048, 4096), (2984, 4096), (616, 4096), (8, 8192),
               (8, 65536)]


@pytest.mark.parametrize("wdt", [torch.float32, torch.bfloat16],
                         ids=["w_f32", "w_bf16"])
@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16],
                         ids=["x_f32", "x_bf16"])
@pytest.mark.parametrize("R,H", NORM_SHAPES, ids=str)
def test_norm_kernel_matches_plain_version(dev, R, H, xdt, wdt):
    x, w, b = _norm_case(dev, R, H, xdt, wdt)
    counts = (fn.rms_launch_count, fn.ln_launch_count)
    y = fn._launch_rms(x, w, 1e-6)
    y2 = fn._launch_ln(x, w, b, 1e-5)
    torch.cuda.synchronize()
    assert (fn.rms_launch_count, fn.ln_launch_count) == (counts[0] + 1,
                                                         counts[1] + 1)
    assert y.dtype == y2.dtype == xdt
    _assert_norm_within(y, fn.rms_ref(x, w, 1e-6))
    _assert_norm_within(y2, fn.ln_ref(x, w, b, 1e-5))
    assert torch.equal(fn._launch_rms(x, w, 1e-6), y)
    assert torch.equal(fn._launch_ln(x, w, b, 1e-5), y2)


@pytest.mark.parametrize("kind", ["rms", "ln"])
def test_norm_walk_repeats_bit_for_bit_at_prefill_rows(dev, kind):
    """Ten launches at the fused decoder's prefill step (2,984 rows of
    4,096, bf16) give identical bits: the sums reduce in a fixed order."""
    x, w, b = _norm_case(dev, 2984, 4096, torch.bfloat16, torch.bfloat16, 3)
    if kind == "rms":
        def run():
            return fn._launch_rms(x, w, 1e-6)
    else:
        def run():
            return fn._launch_ln(x, w, b, 1e-5)
    first = run()
    assert all(torch.equal(run(), first) for _ in range(10))


@pytest.mark.parametrize("H", [4096, 57856, 57984])
def test_norm_paths_at_the_slot_threshold(dev, H):
    """f32 rows up to 57,856 take the walk (the last with the vectors read
    from device memory), 57,984 the one-block-a-row kernel; each path
    launches once a call and matches the plain version."""
    x, w, b = _norm_case(dev, 16, H, torch.float32, torch.float32, 4)
    plan = fn._norm_plan(16, H, torch.float32, torch.float32, "ln",
                         torch.float32, fn._sm_count(x.device.index))
    assert plan.path == {4096: "walk", 57856: "walk_global",
                         57984: "row"}[H]
    counts = (fn.rms_launch_count, fn.ln_launch_count)
    _assert_norm_within(fn.layer_norm(x, w, b, 1e-5),
                        fn.ln_ref(x, w, b, 1e-5))
    _assert_norm_within(fn.rms_norm(x, w, 1e-6), fn.rms_ref(x, w, 1e-6))
    assert (fn.rms_launch_count, fn.ln_launch_count) == (counts[0] + 1,
                                                         counts[1] + 1)


def test_norm_kernel_controls_fail_the_gate(dev):
    x, w, b = _norm_case(dev, 64, 4096, torch.bfloat16, torch.float32, 1)
    ref = fn.rms_ref(x, w, 1e-6)
    for bad in (fn._launch_rms(x, w, 1e-2),
                fn._launch_rms(x, torch.roll(w, 1), 1e-6)):
        with pytest.raises(AssertionError):
            _assert_norm_within(bad, ref)


def test_fused_ops_take_the_norm_kernel_on_the_card(dev):
    """The functionals launch the kernel where the rule holds (RMS with a
    weight, LayerNorm with weight and bias), the compositions elsewhere;
    autograd through the kernel's forward equals the CPU run's."""
    from paddle_tpu_torch.incubate.nn import functional as F
    x, w, b = _norm_case(dev, 16, 256, torch.float32, torch.float32, 2)
    counts = (fn.rms_launch_count, fn.ln_launch_count)
    F.fused_rms_norm(x, w)
    F.fused_layer_norm(x, w, b)
    F.fused_rms_norm(x[:7], w)                  # rows off the rule
    F.fused_layer_norm(x, w, None)              # no bias
    torch.cuda.synchronize()
    assert (fn.rms_launch_count, fn.ln_launch_count) == (counts[0] + 1,
                                                         counts[1] + 1)
    grads = {}
    for where in ("cuda", "cpu"):
        leaves = [t.detach().to(where).requires_grad_(True)
                  for t in (x, w, b)]
        out, res = F.fused_layer_norm(leaves[0], leaves[1], leaves[2],
                                      residual=leaves[0])
        (out.float() * torch.linspace(-1, 1, 256, device=where)) \
            .sum().backward()
        grads[where] = [t.grad.cpu() for t in leaves]
    for g, c in zip(grads["cuda"], grads["cpu"]):
        _assert_grad_within(g, c, GRAD_TOL[torch.float32])


@pytest.mark.parametrize("rows", [1, 3, 8])
def test_sampled_draw_graph_matches_eager_ops(dev, rows):
    """The sampler's Gumbel noise replayed from its CUDA graph equals the
    same ops launched one by one, bit for bit, as the keys change between
    replays; the card's threefry bits equal the CPU's."""
    from paddle_tpu_torch.inference import prng
    for seed in (0, 7, 2 ** 32 - 1):
        keys = prng.fold_in(prng.prng_key(seed),
                            torch.arange(rows)).to(dev)
        assert torch.equal(prng._gumbel_graphed(keys, 32000)[0].clone(),
                           prng.gumbel(keys, 32000))
        assert torch.equal(prng.random_bits(keys, 32000).cpu(),
                           prng.random_bits(keys.cpu(), 32000))


# ---------------------------------------------------------------------------
# tuned plans: every candidate of the tuning registry launches and matches
# ---------------------------------------------------------------------------

@pytest.fixture
def forced(monkeypatch):
    """Force one kernel's config through the tuning lookup."""
    import json

    def force(kernel, config):
        monkeypatch.setenv("PADDLE_TPU_TUNE_FORCE",
                           json.dumps({kernel: config}))
    monkeypatch.delenv("PADDLE_TPU_TUNE_CACHE", raising=False)
    return force


@pytest.mark.parametrize("split", [256, 512, 1024, 2048])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_tuned_walk_split_matches_plain_version(dev, forced, split, dtype):
    """Each split_keys candidate: the walk matches its plain version and
    repeats bit for bit; the default equals an untuned launch."""
    lens = [100, 2000, 731, 1290, 5, 16, 17, 1999]
    ops = _case(dev, dtype, 32, 32, 128, 16, [(1, kv) for kv in lens], 8,
                128, seed=5)
    mixed = _case(dev, dtype, 32, 8, 128, 16,
                  [(9, 9), (40, 700), (1, 1500), (3, 77)], 64, 128, seed=6)
    untuned = pa.ragged_paged_attention_segrel_packed(*ops)
    forced("paged_attention", {"split_keys": split})
    for c in (ops, mixed):
        out = pa.ragged_paged_attention_segrel_packed(*c)
        _assert_within(out, pa.ragged_paged_reference_segrel(*c), dtype)
        assert torch.equal(pa.ragged_paged_attention_segrel_packed(*c), out)
    if split == pa._SPLIT_KEYS:
        assert torch.equal(pa.ragged_paged_attention_segrel_packed(*ops),
                           untuned)


@pytest.mark.parametrize("tile,slabs", [(-1, 0), (0, 1), (0, 8), (1, 2),
                                        (1, 32), (2, 8), (-1, 32)])
@pytest.mark.parametrize("M,K", [(8, 4096), (72, 4096), (512, 4096),
                                 (8, 11008)])
@pytest.mark.parametrize("wdt", ["int8", "int4"])
def test_tuned_qmm_plan_matches_plain_version(dev, forced, wdt, M, K, tile,
                                              slabs):
    g = torch.Generator(device=dev).manual_seed(M)
    w = torch.randn((K, 2048), generator=g, device=dev) * 0.02
    q, s = qm.quantize_weight(w, wdt)
    xs = [torch.randn((M, K), generator=g, device=dev).to(xdt)
          for xdt in (torch.float32, torch.bfloat16)]
    untuned = [qm.matmul(x, q, s, wdt) for x in xs]
    forced("quant_matmul", {"tile": tile, "split_slabs": slabs})
    for x, base in zip(xs, untuned):
        out = qm.matmul(x, q, s, wdt)
        _assert_qmm_within(out, qm.reference_matmul(x, q, s, wdt))
        assert torch.equal(qm.matmul(x, q, s, wdt), out)
        if (tile, slabs) == (-1, 0):
            assert torch.equal(out, base)


@pytest.mark.parametrize("warps,stages", [(1, 1), (1, 2), (2, 1), (2, 2),
                                          (4, 1), (4, 2), (8, 1), (8, 2)])
@pytest.mark.parametrize("R,H", [(8, 4096), (2048, 4096), (616, 1024)])
def test_tuned_norm_plan_matches_plain_version(dev, forced, R, H, warps,
                                               stages):
    x, w, b = _norm_case(dev, R, H, torch.bfloat16, torch.bfloat16)
    untuned = fn._launch_rms(x, w, 1e-6)
    rule = fn._norm_plan(R, H, x.dtype, w.dtype, "rms", w.dtype,
                         fn._sm_count(x.device.index))
    forced("fused_norms", {"team_warps": warps, "stages": stages})
    y = fn._launch_rms(x, w, 1e-6)
    y2 = fn._launch_ln(x, w, b, 1e-5)
    _assert_norm_within(y, fn.rms_ref(x, w, 1e-6))
    _assert_norm_within(y2, fn.ln_ref(x, w, b, 1e-5))
    assert torch.equal(fn._launch_rms(x, w, 1e-6), y)
    # the ring's depth never changes a row's sums; the team width does
    if warps == rule.team_warps:
        assert torch.equal(y, untuned)


def test_tp2_engine_on_one_card_equals_tp1(dev):
    """Two shards on one card: the walk and the pools at kvh/2 heads, the
    q/k/v products at half width; greedy tokens equal tp=1's."""
    from paddle_tpu_torch.inference import LLMEngine
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = LlamaConfig(vocab_size=512, hidden_size=256,
                      intermediate_size=512, num_hidden_layers=3,
                      num_attention_heads=4, num_key_value_heads=2,
                      max_position_embeddings=256)
    model = LlamaForCausalLM(cfg, device=dev, generator=1)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, n).tolist() for n in (5, 40, 130, 17)]
    outs = {}
    for tp, kw in ((1, {}), (2, {}), (1, {"weight_dtype": "int8",
                                          "kv_dtype": "int8"}),
                   (2, {"weight_dtype": "int8", "kv_dtype": "int8"})):
        eng = LLMEngine(model, device=dev, tp=tp, max_num_seqs=4,
                        block_size=16, max_model_len=256,
                        max_prefill_tokens=64, prefill_token_bucket=32, **kw)
        for p in prompts:
            eng.add_request(p, max_new_tokens=8)
        before = (pa.launch_count, pa.quant_launch_count)
        got = {r: o.generated for r, o in eng.run().items()}
        launched = (pa.launch_count - before[0]) + \
            (pa.quant_launch_count - before[1])
        outs[tp, bool(kw)] = (got, launched)
    for quant in (False, True):
        assert outs[2, quant][0] == outs[1, quant][0]
        assert outs[2, quant][1] == 2 * outs[1, quant][1]
