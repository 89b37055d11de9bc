"""PyTorch port, CUDA kernels on the card: each kernel against its plain
version over the shapes its wrapper accepts, and the engine's attention
going through the kernel.  Marked ``cuda``; without a CUDA device (or
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
"""
import os
import shutil

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import paged_attention as pa

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
