"""PyTorch port, CUDA kernels on the card: each kernel against its plain
version over the shapes its wrapper accepts, and the engine's attention
and weight products going through the kernels.  Marked ``cuda``; without a CUDA device (or
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
the same bf16 tolerances.  The dequant matmul and its plain version both
compute in f32 from exactly upcast operands and differ only in summation
order: ||out - ref|| / ||ref|| <= 1e-5 and max|out - ref| / max|ref| <=
1e-4.
"""
import os
import shutil

import numpy as np
import pytest
import torch

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
    (8, 4096, 32000), (300, 1000, 77)])
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
