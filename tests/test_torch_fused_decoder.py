"""PyTorch port: the fused LLaMA decoder that Paddle's fused inference
models build from ``incubate.nn.functional`` ops, composed from the port's
ops and from the JAX package's on the same weights, served greedily
through the same trace (a prefill, a mixed step, decodes) over
``block_multihead_attention``.  Per layer: fused_rms_norm (residual in),
fused_linear for qkv, fused_rotary_position_embedding on q and k at each
token's position (blha ignores rope_emb), block_multihead_attention,
fused_linear out, fused_rms_norm (residual in), fused_linear gate and up,
swiglu, fused_linear down; then a final fused_rms_norm and the LM head.

A tiny LLaMA (2 layers, hidden 256, 2 heads of D 128, so that the norms'
rule holds wherever a step has a multiple of 8 tokens) from the JAX
package's ``LlamaForCausalLM``, drawn from its global random state seeded
to 0 inside a fixture that restores it.  Checks: greedy tokens equal;
each step's logits and the paged caches within 1e-5 (rtol and atol: the
same f32 math, sums and transcendentals in another order); and the fused
decoder's logits within 1e-4 of the JAX ``LlamaForCausalLM`` dense
forward on the same tokens, teacher-forced (the composition is LLaMA).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.ops.pallas.paged_attention as JPA
from paddle_tpu.core import random_state
from paddle_tpu.incubate.nn import functional as JIF
from paddle_tpu.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.incubate.nn import functional as TIF
from paddle_tpu_torch.ops import fused_norms as tfn
from _torch_threads import torch_threads  # noqa: F401

CFG = LlamaConfig(vocab_size=97, hidden_size=256, intermediate_size=512,
                  num_hidden_layers=2, num_attention_heads=2,
                  num_key_value_heads=2, max_position_embeddings=64)
H, D = 2, 128
BS, NBLK = 16, 4
PROMPTS = [5, 8, 11, 6]            # slots 0-2 prefill at step 0, 3 at step 1
N_DECODE = 3
STEP_TOL = dict(rtol=1e-5, atol=1e-5)
DENSE_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def weights():
    """The model's decode parameters as numpy, qkv and gate/up fused along
    the output axis; the JAX random state seeded to 0 and restored."""
    saved = dict(random_state._state)
    random_state.seed(0)
    try:
        model = LlamaForCausalLM(CFG)
    finally:
        random_state._state.update(saved)
    p = jax.tree.map(np.asarray, model.decode_params())
    lay = p["layers"]
    return model, {
        "embed": p["embed"], "norm_f": p["norm_f"], "head": p["head"],
        "layers": [{"ln1": lay["ln1"][i], "ln2": lay["ln2"][i],
                    "wqkv": np.concatenate([lay["wq"][i], lay["wk"][i],
                                            lay["wv"][i]], 1),
                    "wo": lay["wo"][i],
                    "gate_up": np.concatenate([lay["gate"][i],
                                               lay["up"][i]], 1),
                    "down": lay["down"][i]}
                   for i in range(CFG.num_hidden_layers)]}


@pytest.fixture(autouse=True)
def _interpret():
    """The JAX decode kernel through the Pallas interpreter (its default
    off the TPU, set here explicitly and restored)."""
    old = JPA.INTERPRET
    JPA.INTERPRET = True
    yield
    JPA.INTERPRET = old


class _Jax:
    """Tensor glue of the JAX package's surface."""
    F = JIF

    @staticmethod
    def t(a, dtype=np.float32):
        return paddle.to_tensor(np.asarray(a, dtype))

    @staticmethod
    def np(x):
        return np.asarray(jnp.asarray(x._data, jnp.float32))

    @staticmethod
    def reshape(x, shape):
        return x.reshape(list(shape))

    @staticmethod
    def concat(xs, axis):
        return paddle.concat(xs, axis=axis)

    @staticmethod
    def caches(n):
        return [paddle.to_tensor(np.zeros((n, H, BS, D), np.float32))
                for _ in range(2)]


class _Torch:
    """Tensor glue of the port's surface (CPU tensors)."""
    F = TIF

    @staticmethod
    def t(a, dtype=np.float32):
        return torch.from_numpy(np.array(a, dtype))

    @staticmethod
    def np(x):
        return x.detach().float().numpy()

    @staticmethod
    def reshape(x, shape):
        return x.reshape(shape)

    @staticmethod
    def concat(xs, axis):
        return torch.cat(xs, axis)

    @staticmethod
    def caches(n):
        return [torch.zeros((n, H, BS, D)) for _ in range(2)]


def _step(G, W, caches, toks, pos, enc, dec, this, bt):
    """One step of the fused decoder on ``G``'s surface: tokens [T] at
    absolute positions pos [T]; returns the logits of every token [T, V]
    and the caches the layers returned."""
    F, T = G.F, len(toks)
    eps = CFG.rms_norm_eps
    x = G.t(W["embed"][toks])
    pos_ids = G.t(pos[None], np.int32)
    res, new = None, []
    for lw, (kc, vc) in zip(W["layers"], caches):
        h, res = F.fused_rms_norm(x, G.t(lw["ln1"]), epsilon=eps,
                                  residual=res)
        qkv = G.reshape(F.fused_linear(h, G.t(lw["wqkv"])), (T, 3, H, D))
        q, k, _ = F.fused_rotary_position_embedding(
            G.reshape(qkv[:, 0], (1, T, H, D)),
            G.reshape(qkv[:, 1], (1, T, H, D)), position_ids=pos_ids,
            use_neox_rotary_style=True, rotary_emb_base=CFG.rope_theta)
        qkv = G.concat([G.reshape(q, (T, H * D)), G.reshape(k, (T, H * D)),
                        G.reshape(qkv[:, 2], (T, H * D))], -1)
        out, _, kc, vc = F.block_multihead_attention(
            qkv, kc, vc, enc, dec, this, block_tables=G.t(bt, np.int32),
            block_size=BS)
        new.append((kc, vc))
        h, res = F.fused_rms_norm(F.fused_linear(out, G.t(lw["wo"])),
                                  G.t(lw["ln2"]), epsilon=eps, residual=res)
        x = F.fused_linear(F.swiglu(F.fused_linear(h, G.t(lw["gate_up"]))),
                           G.t(lw["down"]))
    h, _ = F.fused_rms_norm(x, G.t(W["norm_f"]), epsilon=eps, residual=res)
    return G.np(F.fused_linear(h, G.t(W["head"]))), new


def _serve(G, W):
    """The greedy trace: step 0 prefills slots 0-2, step 1 prefills slot 3
    and decodes 0-2, then N_DECODE steps decode all four.  Returns (each
    slot's tokens, each step's logits at the rows it samples from, each
    sampled row's (slot, position), the final caches as numpy)."""
    rng = np.random.RandomState(5)
    seqs = [list(rng.randint(0, CFG.vocab_size, n)) for n in PROMPTS]
    n = len(PROMPTS)
    bt = np.arange(n * NBLK, dtype=np.int32).reshape(n, NBLK) + 1
    caches = [G.caches(1 + n * NBLK) for _ in W["layers"]]
    done = [0] * n                           # positions already cached
    plan = [[0, 1, 2], [0, 1, 2, 3]] + [[0, 1, 2, 3]] * N_DECODE
    logits, rows = [], []
    for step, active in enumerate(plan):
        enc, dec, this = (np.zeros(n, np.int32) for _ in range(3))
        toks, pos, last = [], [], []
        for b in active:
            new = seqs[b][done[b]:]
            if done[b] == 0:
                enc[b] = len(new)
            else:
                dec[b] = done[b]
            this[b] = len(new)
            toks += new
            pos += range(done[b], done[b] + len(new))
            last.append(len(toks) - 1)
        sel = [b for b in range(n) if this[b]]
        lg, caches = _step(G, W, caches, np.asarray(toks), np.asarray(pos),
                           enc[sel], dec[sel], this[sel], bt[sel])
        logits.append(lg[last])
        for b, r in zip(active, last):
            rows.append((b, pos[r]))
            done[b] += this[b]
            seqs[b].append(int(np.argmax(lg[r])))
    return seqs, logits, rows, [G.np(c) for pair in caches for c in pair]


@pytest.fixture(scope="module")
def served(weights):
    _, W = weights
    old = JPA.INTERPRET
    JPA.INTERPRET = True
    try:
        want = _serve(_Jax, W)
    finally:
        JPA.INTERPRET = old
    tfn.rms_launch_count = 0
    got = _serve(_Torch, W)
    return want, got


def test_greedy_tokens_equal(served):
    (jseqs, *_), (tseqs, *_) = served
    assert tseqs == jseqs


def test_each_step_logits_agree(served):
    (_, jl, jrows, _), (_, tl, trows, _) = served
    assert trows == jrows
    for step, (t, j) in enumerate(zip(tl, jl)):
        np.testing.assert_allclose(t, j, err_msg=f"step {step}", **STEP_TOL)


def test_caches_agree(served):
    """The paged caches within the step tolerance.  Not bit for bit: the
    K/V that blha writes come out of each framework's own f32 norm,
    matmul and rotary sin/cos, which round apart by an ulp or two (blha's
    writes of the same K/V are held bit for bit in test_torch_blha)."""
    (*_, jc), (*_, tc) = served
    for t, j in zip(tc, jc):
        np.testing.assert_allclose(t, j, **STEP_TOL)


def test_cpu_run_launched_no_kernel(served):
    assert tfn.rms_launch_count == tfn.ln_launch_count == 0


def test_fused_decoder_is_llama(served, weights):
    """Teacher-forced: the JAX LlamaForCausalLM dense forward on each
    slot's final tokens gives, at every position the fused decoder sampled
    from, the logits the fused decoder computed there."""
    model, _ = weights
    _, (seqs, logits, rows, _) = served
    flat = np.concatenate(logits)
    dense = {b: _Jax.np(model(paddle.to_tensor(
        np.asarray([s[:-1]], np.int64))))[0] for b, s in enumerate(seqs)}
    want = np.stack([dense[b][p] for b, p in rows])
    np.testing.assert_allclose(flat, want, **DENSE_TOL)
