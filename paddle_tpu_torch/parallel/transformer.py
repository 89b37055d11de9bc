"""The LLaMA train step on one card (counterpart of
paddle_tpu/parallel/transformer.py at dp = pp = tp = cp = 1).

``build_train_step(cfg, hp)`` returns ``train_step(params, opt_state,
tokens) -> (params, opt_state, loss)``: the next-token cross entropy of
a stack of pre-norm decoder blocks (RMSNorm, interleaved RoPE, GQA
attention through the flash attention kernels, SwiGLU), averaged over
``hp.num_microbatches`` microbatches, its gradients, the exact global-norm
clip and AdamW.  The arithmetic is the JAX trainer's term for term: RoPE
and RMSNorm in f32, SiLU in f32 cast back, the logits in f32 from the
hidden state and head in their storage type, f32 moments and an f32
update cast to the parameter type.

Parameters are a dict in the JAX pytree layout: ``embed`` ``[V, H]``,
``norm_f`` ``[H]``, ``head`` ``[H, V]`` and ``layers.{ln1, wq, wk, wv, wo,
ln2, w_gate, w_up, w_down}`` stacked on a leading layer axis, projections
stored ``[in, out]``.  ``from_jax_params`` / ``from_jax_opt_state`` carry
the JAX trainer's trees over (as numpy), ``to_numpy`` carries them back.

Options of later slices (dp, tp, pp, cp, ep > 1, ZeRO, the interleaved
schedule, MoE, ``remat_policy="attn"``) raise ``NotImplementedError``
naming their ROADMAP item.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..models.llama import LlamaConfig, resolve_device
from ..ops import flash_attention as fa

__all__ = ["HybridParallelConfig", "init_params", "init_opt_state",
           "build_train_step", "loss_and_grads", "from_jax_params",
           "from_jax_opt_state", "to_numpy", "param_count"]

LAYER_KEYS = ("ln1", "wq", "wk", "wv", "wo", "ln2", "w_gate", "w_up",
              "w_down")
_LATER = "ROADMAP Queue 1 item 12b (the distributed trainer)"


@dataclass(frozen=True)
class HybridParallelConfig:
    """The JAX trainer's configuration, every field kept.  The port runs
    dp = pp = tp = cp = ep = 1, zero_stage 0, vpp 1 and remat_policy
    "full"; ``build_train_step`` refuses the rest."""
    dp: int = 1
    pp: int = 1
    tp: int = 1
    cp: int = 1                       # context parallel (ring attention)
    num_microbatches: int = 1
    pp_schedule: str = "1f1b"         # at pp = 1 "1f1b" and "gpipe" are
                                      # one path; "vpp" is refused
    vpp: int = 1
    remat: bool = True                # recompute each block in backward
    remat_policy: str = "full"        # "attn" (save attention outputs) is
                                      # refused
    ep: int = 1
    xent_chunk: int = 0               # >0: sequence-chunked cross entropy
    zero_stage: int = 0
    dtype: Any = torch.float32        # parameter/activation dtype
    lr: float = 1e-3
    betas: tuple = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip_norm: float = 1.0


# ---------------------------------------------------------------------------
# parameters and optimizer state
# ---------------------------------------------------------------------------

def _shapes(cfg: LlamaConfig) -> dict:
    H, Fd, V, L = (cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size,
                   cfg.num_hidden_layers)
    Hkv = cfg.num_key_value_heads * (H // cfg.num_attention_heads)
    return {"embed": (V, H), "norm_f": (H,), "head": (H, V),
            "layers": {"ln1": (L, H), "wq": (L, H, H), "wk": (L, H, Hkv),
                       "wv": (L, H, Hkv), "wo": (L, H, H), "ln2": (L, H),
                       "w_gate": (L, H, Fd), "w_up": (L, H, Fd),
                       "w_down": (L, Fd, H)}}


def param_count(cfg: LlamaConfig) -> int:
    """Number of parameters of ``init_params(cfg, ...)``."""
    sh = _shapes(cfg)
    leaves = [sh["embed"], sh["norm_f"], sh["head"], *sh["layers"].values()]
    return int(sum(math.prod(s) for s in leaves))


def init_params(cfg: LlamaConfig, hp: HybridParallelConfig, seed=0, *,
                device=None) -> dict:
    """Random parameters in ``hp.dtype``: N(0, 0.02) embeddings and
    projections (``wo`` and ``w_down`` scaled by 1 / sqrt(2 L)), unit norm
    scales, drawn in f32 from ``seed`` (a ``torch.Generator`` on the
    device, or an int seeding one).  They are not the JAX package's draws:
    the parity tests carry those over with ``from_jax_params``."""
    if cfg.moe_experts:
        raise NotImplementedError(f"moe_experts > 0 waits for {_LATER}")
    dev = resolve_device(device)
    gen = seed if isinstance(seed, torch.Generator) else \
        torch.Generator(device=dev).manual_seed(int(seed))
    sh = _shapes(cfg)
    L = cfg.num_hidden_layers
    s = 0.02

    def normal(shape, scale):
        w = torch.empty(shape, device=dev, dtype=torch.float32)
        return w.normal_(0.0, scale, generator=gen).to(hp.dtype)

    def ones(shape):
        return torch.ones(shape, device=dev, dtype=hp.dtype)

    lay = sh["layers"]
    return {
        "embed": normal(sh["embed"], s), "norm_f": ones(sh["norm_f"]),
        "head": normal(sh["head"], s),
        "layers": {
            "ln1": ones(lay["ln1"]), "wq": normal(lay["wq"], s),
            "wk": normal(lay["wk"], s), "wv": normal(lay["wv"], s),
            "wo": normal(lay["wo"], s / math.sqrt(2 * L)),
            "ln2": ones(lay["ln2"]), "w_gate": normal(lay["w_gate"], s),
            "w_up": normal(lay["w_up"], s),
            "w_down": normal(lay["w_down"], s / math.sqrt(2 * L))}}


def _leaves(tree: dict) -> list:
    """(name, tensor) for every leaf, in a fixed order."""
    out = [(k, tree[k]) for k in ("embed", "norm_f", "head")]
    return out + [(f"layers.{k}", tree["layers"][k]) for k in LAYER_KEYS]


def _tree(pairs) -> dict:
    d = dict(pairs)
    return {"embed": d["embed"], "norm_f": d["norm_f"], "head": d["head"],
            "layers": {k: d[f"layers.{k}"] for k in LAYER_KEYS}}


def init_opt_state(params: dict) -> dict:
    """Zero f32 Adam moments shaped like ``params`` and step 0 (int32)."""
    def f32(t):
        return torch.zeros(t.shape, dtype=torch.float32, device=t.device)
    dev = params["embed"].device
    return {"m": _tree((n, f32(t)) for n, t in _leaves(params)),
            "v": _tree((n, f32(t)) for n, t in _leaves(params)),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _from_numpy(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":   # ml_dtypes' bfloat16: same 16 bits
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def from_jax_params(params_np: dict, *, device=None) -> dict:
    """The JAX trainer's parameter tree (leaves as numpy arrays, bf16 as
    ml_dtypes' bfloat16) as the port's dict on ``device``, dtypes kept."""
    dev = resolve_device(device)
    return _tree((n, _from_numpy(a, dev)) for n, a in _leaves(params_np))


def from_jax_opt_state(opt_np: dict, *, device=None) -> dict:
    """The JAX trainer's optimizer state ({"m", "v", "step"}, numpy
    leaves) as the port's."""
    dev = resolve_device(device)
    return {"m": from_jax_params(opt_np["m"], device=dev),
            "v": from_jax_params(opt_np["v"], device=dev),
            "step": _from_numpy(opt_np["step"], dev).to(torch.int32)}


def to_numpy(tree):
    """A tree of tensors (params, opt state or grads) as numpy arrays,
    copies that later in-place steps leave alone; bf16 leaves come back
    as f32."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    t = tree.detach().to("cpu", copy=True)
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

def _rope(x, theta, pos0=0):
    """Interleaved rotary embedding (pairs 2i, 2i+1) of x [m, S, h, d] in
    f32, cast back to x.dtype."""
    m_, s, h, d = x.shape
    pos = pos0 + torch.arange(s, dtype=torch.float32, device=x.device)
    inv = theta ** (-torch.arange(0, d, 2, dtype=torch.float32,
                                  device=x.device) / d)
    freqs = torch.outer(pos, inv)
    cos = torch.cos(freqs)[None, :, None, :]
    sin = torch.sin(freqs)[None, :, None, :]
    xf = x.float()
    x1, x2 = xf[..., 0::2], xf[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.reshape(m_, s, h, d).to(x.dtype)


def _rms(x, w, eps=1e-6):
    xf = x.float()
    out = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (out * w.float()).to(x.dtype)


def _attention(q, k, v):
    """Causal GQA attention through the flash attention kernels (the plain
    versions on CPU tensors)."""
    return fa.attention(q, k, v, causal=True)


def _make_block(cfg: LlamaConfig, hp: HybridParallelConfig):
    nh = cfg.num_attention_heads
    nkv = cfg.num_key_value_heads
    hd = cfg.hidden_size // nh
    eps = cfg.rms_norm_eps

    def block(x, p):
        # x [m, S, H]; at tp = 1 the JAX block's all_gather and
        # psum_scatter are identities
        h = _rms(x, p["ln1"], eps)
        m_, s = x.shape[:2]
        q = (h @ p["wq"]).reshape(m_, s, nh, hd)
        k = (h @ p["wk"]).reshape(m_, s, nkv, hd)
        v = (h @ p["wv"]).reshape(m_, s, nkv, hd)
        q = _rope(q, cfg.rope_theta)
        k = _rope(k, cfg.rope_theta)
        att = _attention(q, k, v).reshape(m_, s, nh * hd)
        x = x + att @ p["wo"]
        h2 = _rms(x, p["ln2"], eps)
        g = h2 @ p["w_gate"]
        u = h2 @ p["w_up"]
        a = F.silu(g.float()).to(g.dtype) * u
        return x + a @ p["w_down"]

    return block


def _vocab_parallel_embed(tokens, embed):
    """tokens [m, S] -> [m, S, H]: at tp = 1 a plain lookup."""
    return F.embedding(tokens, embed)


def _mm_f32(a, b):
    """a @ b with an f32 result from operands in their storage type: f32
    operands multiply in f32; bf16 operands on CUDA use the bf16 product
    with f32 output (``torch.mm(..., out_dtype=torch.float32)``), and on
    the CPU are upcast (exact products, f32 sums)."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _F32Logits(torch.autograd.Function):
    """h [N, H] @ head [H, V] -> f32 logits (the JAX einsum with
    ``preferred_element_type=float32``).  The backward takes the f32
    cotangent in the operands' type (a bf16 cotangent for bf16 operands)
    with f32 products, each gradient cast to its operand's type."""

    @staticmethod
    def forward(ctx, h, head):
        ctx.save_for_backward(h, head)
        return _mm_f32(h, head)

    @staticmethod
    def backward(ctx, g):
        h, head = ctx.saved_tensors
        gc = g.to(h.dtype)
        return (_mm_f32(gc, head.t()).to(h.dtype),
                _mm_f32(h.t(), gc).to(head.dtype))


def _vocab_parallel_xent(h, head, labels, pos_weight=None,
                         reduction="mean"):
    """Cross entropy of h [m, S, H] through head [H, V] against labels
    [m, S], positions weighted by pos_weight [S].  Returns the weighted
    mean, or (weighted sum, weight count) with reduction="sumcount"."""
    m_, s, H = h.shape
    logits = _F32Logits.apply(h.reshape(m_ * s, H), head).reshape(m_, s, -1)
    gmax = logits.detach().amax(-1)
    z = torch.exp(logits - gmax[..., None])
    denom = z.sum(-1)
    picked = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    per_pos = gmax + torch.log(denom) - picked
    if pos_weight is None:
        pos_weight = torch.ones((s,), dtype=torch.float32, device=h.device)
    w = pos_weight[None, :]
    wsum = (per_pos * w).sum()
    wcount = w.sum() * m_
    if reduction == "sumcount":
        return wsum, wcount
    return wsum / torch.clamp(wcount, min=1.0)


def _vocab_parallel_xent_chunked(h, head, labels, pos_weight, chunk):
    """Sequence-chunked cross entropy: each chunk's f32 logits are
    recomputed in backward (``torch.utils.checkpoint``), so at most
    [m, chunk, V] f32 logits live at once.  Returns (sum, count)."""
    S = h.shape[1]
    if chunk <= 0 or S % chunk or S == chunk:
        return _vocab_parallel_xent(h, head, labels, pos_weight,
                                    reduction="sumcount")

    def one(hc, lc, wc):
        return _vocab_parallel_xent(hc, head, lc, wc, reduction="sumcount")

    ws = wc = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, S, chunk):
        a, b = checkpoint(one, h[:, i:i + chunk], labels[:, i:i + chunk],
                          pos_weight[i:i + chunk], use_reentrant=False)
        ws, wc = ws + a, wc + b
    return ws, wc


def _stage_apply(params, tok_mb, cfg, hp):
    """The whole model on one microbatch tok_mb [m, S]: embed, the layer
    stack (each block under ``torch.utils.checkpoint`` with remat), the
    final norm and the next-token loss with the last position masked."""
    block = _make_block(cfg, hp)
    x = _vocab_parallel_embed(tok_mb, params["embed"])
    layers = params["layers"]
    per_layer = zip(*(layers[k].unbind(0) for k in LAYER_KEYS))
    for vals in per_layer:
        p = dict(zip(LAYER_KEYS, vals))
        x = checkpoint(block, x, p, use_reentrant=False) if hp.remat \
            else block(x, p)
    hN = _rms(x, params["norm_f"], cfg.rms_norm_eps)
    S = tok_mb.shape[1]
    labels = torch.cat([tok_mb, tok_mb[:, :1]], dim=1)[:, 1:S + 1]
    pos_w = (torch.arange(S, device=tok_mb.device) < S - 1).float()
    ws, wc = _vocab_parallel_xent_chunked(hN, params["head"], labels, pos_w,
                                          hp.xent_chunk)
    return ws / torch.clamp(wc, min=1.0)


def loss_and_grads(params, tokens, cfg, hp):
    """The mean loss over ``hp.num_microbatches`` microbatches of tokens
    [M * m, S] (microbatch i is rows i*m .. (i+1)*m - 1) and its gradients
    (a tree like params, each in its parameter's dtype, summed over
    microbatches in that dtype)."""
    M = hp.num_microbatches
    if tokens.shape[0] % M:
        raise ValueError(f"batch {tokens.shape[0]} not divisible by "
                         f"num_microbatches={M}")
    leaves = _leaves(params)
    live = [t.detach().requires_grad_(True) for _, t in leaves]
    ptree = _tree((n, t) for (n, _), t in zip(leaves, live))
    grads, total = None, torch.zeros((), dtype=torch.float32,
                                     device=tokens.device)
    for mb in tokens.reshape(M, tokens.shape[0] // M, tokens.shape[1]):
        loss = _stage_apply(ptree, mb, cfg, hp)
        g = torch.autograd.grad(loss / M, live)
        grads = list(g) if grads is None else \
            [a + b for a, b in zip(grads, g)]
        total = total + loss.detach()
    return total / M, _tree((n, g) for (n, _), g in zip(leaves, grads))


@torch.no_grad()
def _adamw_update(params, grads, opt_state, hp):
    """AdamW with the exact global-norm clip, in place: every parameter
    and moment tensor is overwritten, and opt_state["step"] advanced."""
    b1, b2 = hp.betas
    step = opt_state["step"] + 1
    stepf = step.float()
    bc1 = 1.0 - b1 ** stepf
    bc2 = 1.0 - b2 ** stepf
    gl = [g for _, g in _leaves(grads)]
    sumsq = torch.zeros((), dtype=torch.float32, device=step.device)
    for g in gl:
        sumsq = sumsq + torch.sum(g.float() ** 2)
    gnorm = torch.sqrt(sumsq)
    scale = torch.clamp(hp.grad_clip_norm / (gnorm + 1e-6), max=1.0) \
        if hp.grad_clip_norm else 1.0
    for (_, p), g, (_, m), (_, v) in zip(_leaves(params), gl,
                                         _leaves(opt_state["m"]),
                                         _leaves(opt_state["v"])):
        gf = g.float() * scale
        m2 = b1 * m + (1 - b1) * gf
        v2 = b2 * v + (1 - b2) * gf * gf
        upd = (m2 / bc1) / (torch.sqrt(v2 / bc2) + hp.eps)
        pf = p.float()
        if hp.weight_decay:
            pf = pf * (1.0 - hp.lr * hp.weight_decay)
        p.copy_((pf - hp.lr * upd).to(p.dtype))
        m.copy_(m2)
        v.copy_(v2)
    opt_state["step"] = step
    return gnorm


def _refuse_later_options(cfg: LlamaConfig, hp: HybridParallelConfig):
    for name in ("dp", "tp", "pp", "cp", "ep"):
        if getattr(hp, name) > 1:
            raise NotImplementedError(f"{name} > 1 waits for {_LATER}")
    if hp.zero_stage >= 1:
        raise NotImplementedError(f"zero_stage >= 1 waits for {_LATER}")
    if hp.vpp > 1 or hp.pp_schedule not in ("1f1b", "gpipe"):
        raise NotImplementedError(
            f"pp_schedule={hp.pp_schedule!r} / vpp={hp.vpp} (the "
            f"interleaved schedule) waits for {_LATER}")
    if cfg.moe_experts:
        raise NotImplementedError(f"moe_experts > 0 waits for {_LATER}")
    if hp.remat_policy != "full":
        raise NotImplementedError(
            f"remat_policy={hp.remat_policy!r} waits for {_LATER}")


def build_train_step(cfg: LlamaConfig, hp: HybridParallelConfig, *,
                     device=None):
    """Returns ``train_step(params, opt_state, tokens) -> (params,
    opt_state, loss)`` on ``device`` (CUDA unless the caller asks for
    another; raises when CUDA is asked for and absent).

    tokens: [M * m, S] integer ids (a tensor or array).  loss is the 0-d
    f32 mean over microbatches, left on the device.  Where the JAX step
    donates its buffers, this one updates in place under ``no_grad``: the
    returned params and opt_state are the dicts passed in, their tensors
    overwritten, opt_state["step"] advanced."""
    _refuse_later_options(cfg, hp)
    if cfg.num_attention_heads % cfg.num_key_value_heads:
        raise ValueError(
            f"num_attention_heads={cfg.num_attention_heads} must divide by "
            f"num_key_value_heads={cfg.num_key_value_heads}")
    dev = resolve_device(device)

    def train_step(params, opt_state, tokens):
        tokens = torch.as_tensor(tokens, device=dev).long()
        if params["embed"].device != tokens.device:
            raise ValueError(f"params on {params['embed'].device}, step on "
                             f"{tokens.device}")
        loss, grads = loss_and_grads(params, tokens, cfg, hp)
        _adamw_update(params, grads, opt_state, hp)
        return params, opt_state, loss

    return train_step
