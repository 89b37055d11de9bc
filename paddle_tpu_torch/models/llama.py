"""LLaMA decode math in PyTorch (counterpart of paddle_tpu/models/llama.py).

The serving engine (inference/serving.py) and the dense ``generate()``
oracle share the building blocks here: RMSNorm in f32 with a learned
scale (``_rms_weight``), INTERLEAVED rotary embeddings at per-token
absolute positions (``_rope_positions``: pairs ``(2i, 2i+1)``, not the
rotate-half layout of Hugging Face checkpoints), and the dense KV-cache
decode forward (``_make_decode_fwd``).  The float math is term for term
the JAX package's, so greedy tokens agree with it.

Weights live in the JAX package's stacked decode-parameter layout:
``layers.{ln1,wq,wk,wv,wo,ln2,gate,up,down}`` stacked on a leading layer
axis with projections stored ``[in, out]``, then ``embed``, ``norm_f`` and
``head``.  ``LlamaForCausalLM`` builds them from an explicit generator
(no checkpoint ships with the repository); ``from_jax_decode_params``
carries the JAX model's weights over for the parity tests, and
``from_hf`` loads a Hugging Face LLaMA checkpoint (model or state dict)
through the rotate-half -> interleaved RoPE permutation.

``speculative_generate`` is batch-1 speculative decoding over two dense
decode forwards (a draft model proposes, the target verifies a window in
one forward), drawing from the JAX version's threefry key stream.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

__all__ = ["LlamaConfig", "LlamaForCausalLM", "convert_hf_state_dict",
           "from_hf", "from_jax_decode_params", "resolve_device",
           "speculative_generate"]

LAYER_KEYS = ("ln1", "wq", "wk", "wv", "wo", "ln2", "gate", "up", "down")


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    # MoE (0 = dense SwiGLU FFN), the JAX config's fields; the port's
    # trainer refuses moe_experts > 0 until its MoE slice
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 2.0
    moe_aux_weight: float = 0.01

    @staticmethod
    def llama_7b():
        return LlamaConfig()

    @staticmethod
    def tiny(vocab=256, hidden=64, layers=2, heads=4, ffn=128, seq=128):
        return LlamaConfig(vocab_size=vocab, hidden_size=hidden,
                           intermediate_size=ffn, num_hidden_layers=layers,
                           num_attention_heads=heads, num_key_value_heads=heads,
                           max_position_embeddings=seq)


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another.  Raises when CUDA is asked for (explicitly or by default)
    and absent -- there is no silent CPU fallback."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev


def _layer_shapes(cfg: LlamaConfig) -> dict:
    h, f = cfg.hidden_size, cfg.intermediate_size
    d = h // cfg.num_attention_heads
    kv = cfg.num_key_value_heads * d
    return {"ln1": (h,), "wq": (h, cfg.num_attention_heads * d),
            "wk": (h, kv), "wv": (h, kv), "wo": (cfg.num_attention_heads * d, h),
            "ln2": (h,), "gate": (h, f), "up": (h, f), "down": (f, h)}


# ---------------------------------------------------------------------------
# decode-math building blocks (shared with inference/serving.py)
# ---------------------------------------------------------------------------

def _rms_weight(x, w, eps):
    """RMSNorm in f32 with a learned scale, cast back to x.dtype."""
    xf = x.float()
    o = xf * torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + eps)
    return (o * w.float()).to(x.dtype)


def _rope_positions(x, pos, theta):
    """Interleaved rotary embedding at per-token absolute positions.

    x [..., h, d]; pos [...] (matching x.shape[:-2], or broadcasting to
    it) integer positions.
    """
    d = x.shape[-1]
    inv = theta ** (-torch.arange(0, d, 2, dtype=torch.float32,
                                  device=x.device) / d)
    freqs = pos.float()[..., None, None] * inv             # [..., 1, d/2]
    cos = torch.cos(freqs)
    sin = torch.sin(freqs)
    xf = x.float()
    x1, x2 = xf[..., 0::2], xf[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.reshape(x.shape).to(x.dtype)


def _make_decode_fwd(cfg, all_logits=False):
    """Build the dense KV-cache decode forward:
    ``fwd(params, toks, ck, cv, pos, mask) -> (logits, ck, cv)``.

    toks [B, s]; ck/cv [L, B, T, kvh, d] (updated IN PLACE at positions
    ``pos[0] .. pos[0]+s-1``, where the JAX version returns new arrays);
    pos [s] absolute positions; mask [s, T] bool.  With all_logits the
    logits cover every window position ([B, s, V]) instead of the last.
    The attention is plain PyTorch: this is the port's oracle."""
    nh = cfg.num_attention_heads
    kvh = cfg.num_key_value_heads
    d = cfg.hidden_size // nh
    eps = cfg.rms_norm_eps
    theta = cfg.rope_theta

    def attend(q, kc, vc, mask):
        # q [B, s, nh, d]; kc/vc [B, T, kvh, d]; mask [s, T] bool
        if kvh != nh:
            kc = torch.repeat_interleave(kc, nh // kvh, dim=2)
            vc = torch.repeat_interleave(vc, nh // kvh, dim=2)
        sc = torch.einsum("bqhd,bkhd->bhqk", q.float(), kc.float()) \
            / (d ** 0.5)
        sc = torch.where(mask[None, None], sc, float("-inf"))
        pr = torch.softmax(sc, dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", pr, vc.float()).to(q.dtype)

    def block(x, p, kc, vc, pos, p0, mask):
        b, s = x.shape[:2]
        h = _rms_weight(x, p["ln1"], eps)
        q = _rope_positions((h @ p["wq"]).reshape(b, s, nh, d), pos, theta)
        k = _rope_positions((h @ p["wk"]).reshape(b, s, kvh, d), pos, theta)
        v = (h @ p["wv"]).reshape(b, s, kvh, d)
        kc[:, p0:p0 + s] = k.to(kc.dtype)
        vc[:, p0:p0 + s] = v.to(vc.dtype)
        att = attend(q, kc, vc, mask).reshape(b, s, nh * d)
        x = x + att @ p["wo"]
        h2 = _rms_weight(x, p["ln2"], eps)
        a = torch.nn.functional.silu((h2 @ p["gate"]).float()).to(h2.dtype) \
            * (h2 @ p["up"])
        return x + a @ p["down"]

    def fwd(params, toks, caches_k, caches_v, pos, mask):
        x = params["embed"][toks]
        layers = params["layers"]
        p0 = int(pos[0])                  # cache write offset, host int
        for i in range(caches_k.shape[0]):
            p = {k: v[i] for k, v in layers.items()}
            x = block(x, p, caches_k[i], caches_v[i], pos, p0, mask)
        h = _rms_weight(x, params["norm_f"], eps)
        hsel = h if all_logits else h[:, -1]
        logits = hsel.float() @ params["head"].float()
        return logits, caches_k, caches_v

    return fwd


class LlamaForCausalLM(nn.Module):
    """LLaMA decoder weights in the stacked decode layout, on one device.

    ``generator`` (a ``torch.Generator`` on ``device``, or an int seed;
    default seed 0) draws the random weights: N(0, 0.02) projections and
    embeddings, unit norm scales.  ``device=None`` means CUDA."""

    def __init__(self, config: LlamaConfig, *, device=None,
                 dtype=torch.float32, generator=None):
        super().__init__()
        self.config = config
        dev = resolve_device(device)
        if not isinstance(generator, torch.Generator):
            generator = torch.Generator(device=dev).manual_seed(
                0 if generator is None else int(generator))
        L = config.num_hidden_layers
        std = 0.02

        def weight(*shape):
            w = torch.empty(shape, device=dev, dtype=dtype)
            if len(shape) > 1 and shape[0] == L:
                for i in range(L):        # layer by layer: no f32 staging
                    w[i].normal_(0.0, std, generator=generator)
            else:
                w.normal_(0.0, std, generator=generator)
            return nn.Parameter(w, requires_grad=False)

        def ones(*shape):
            return nn.Parameter(torch.ones(shape, device=dev, dtype=dtype),
                                requires_grad=False)

        self.layers = nn.ParameterDict({
            k: (ones(L, *s) if k in ("ln1", "ln2") else weight(L, *s))
            for k, s in _layer_shapes(config).items()})
        self.embed = weight(config.vocab_size, config.hidden_size)
        self.norm_f = ones(config.hidden_size)
        self.head = None if config.tie_word_embeddings \
            else weight(config.hidden_size, config.vocab_size)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def decode_params(self) -> dict:
        """The stacked decode-parameter dict (views of the module's
        weights, no copy) in the layout ``_make_decode_fwd`` and the
        serving engine consume."""
        head = self.embed.T if self.head is None else self.head
        return {"layers": {k: self.layers[k] for k in LAYER_KEYS},
                "embed": self.embed, "norm_f": self.norm_f, "head": head}

    def forward_logits(self, input_ids) -> torch.Tensor:
        """Causal logits at every position of input_ids [B, S] ([B, S, V]
        f32), through the dense decode forward on a fresh cache."""
        ids = torch.as_tensor(input_ids, device=self.device).long()
        return self._dense(ids, ids.shape[1], all_logits=True)[0]

    def _dense(self, ids, T, all_logits=False):
        cfg = self.config
        d = cfg.hidden_size // cfg.num_attention_heads
        shape = (cfg.num_hidden_layers, ids.shape[0], T,
                 cfg.num_key_value_heads, d)
        ck = torch.zeros(shape, device=self.device, dtype=self.embed.dtype)
        cv = torch.zeros_like(ck)
        S0 = ids.shape[1]
        pos0 = torch.arange(S0, device=self.device)
        mask0 = torch.arange(T, device=self.device)[None, :] <= pos0[:, None]
        fwd = _make_decode_fwd(cfg, all_logits=all_logits)
        with torch.no_grad():
            logits, ck, cv = fwd(self.decode_params(), ids, ck, cv, pos0,
                                 mask0)
        return logits, ck, cv

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens=32, temperature=1.0,
                 top_p=None, top_k=None, repetition_penalty=None,
                 eos_token_id=None, seed=0):
        """Greedy/top-p/top-k sampling over a dense KV cache (the JAX
        package's compiled ``generate`` as an eager loop).

        input_ids: [B, S0] ints.  Returns [B, S0+max_new_tokens] int64
        (generation frozen at eos when eos_token_id is given).  Sampled
        draws take the JAX ``generate()``'s threefry keys: ``PRNGKey(seed)``
        split once before each step's draw, so they equal its tokens."""
        from ..inference import prng
        cfg = self.config
        dev = self.device
        ids = torch.as_tensor(input_ids, device=dev).long()
        B, S0 = ids.shape
        max_new = int(max_new_tokens)
        T = S0 + max_new
        key = prng.prng_key(seed, dev)
        params = self.decode_params()
        fwd = _make_decode_fwd(cfg)

        def sample(logits, seen=None):
            nonlocal key
            key, sub = prng.split(key)
            if repetition_penalty is not None and seen is not None:
                pen = torch.where(logits > 0, logits / repetition_penalty,
                                  logits * repetition_penalty)
                logits = torch.where(seen, pen, logits)
            if temperature == 0.0:
                return torch.argmax(logits, -1)
            lg = logits / max(temperature, 1e-6)
            if top_k is not None:
                kth = torch.topk(lg, int(top_k), dim=-1).values[:, -1:]
                lg = torch.where(lg < kth, float("-inf"), lg)
            if top_p is not None:
                idx = torch.argsort(-lg, dim=-1, stable=True)
                srt = torch.gather(lg, -1, idx)
                sp = torch.softmax(srt, -1)
                keep = torch.cumsum(sp, -1) - sp <= top_p
                pick = prng.categorical(
                    sub, torch.where(keep, srt, float("-inf")))
                return torch.gather(idx, -1, pick[:, None])[:, 0]
            return prng.categorical(sub, lg)

        logits, ck, cv = self._dense(ids, T)
        V = params["head"].shape[-1]
        rows = torch.arange(B, device=dev)
        seen = None
        if repetition_penalty is not None:
            seen = torch.zeros((B, V), dtype=torch.bool, device=dev)
            seen[rows[:, None], ids] = True
        tok = sample(logits, seen)
        if seen is not None:
            seen[rows, tok] = True
        done = torch.zeros((B,), dtype=torch.bool, device=dev) \
            if eos_token_id is None else tok == eos_token_id
        out = [tok]
        ar = torch.arange(T, device=dev)
        for t in range(max_new - 1):
            pos = S0 + t
            if eos_token_id is not None:
                tok = torch.where(done, torch.full_like(tok, eos_token_id),
                                  tok)
                out[-1] = tok
            mask = (ar <= pos)[None, :]
            logits, ck, cv = fwd(params, tok[:, None], ck, cv,
                                 torch.tensor([pos], device=dev), mask)
            tok = sample(logits, seen)
            if seen is not None:
                seen[rows, tok] = True
            if eos_token_id is not None:
                done = done | (tok == eos_token_id)
            out.append(tok)
        if eos_token_id is not None:       # freeze the final token too
            out[-1] = torch.where(done, torch.full_like(out[-1],
                                                        eos_token_id),
                                  out[-1])
        return torch.cat([ids, torch.stack(out, dim=1)], dim=1)


def speculative_generate(target, draft, input_ids, max_new_tokens=32,
                         gamma=4, temperature=1.0, seed=0,
                         eos_token_id=None):
    """Speculative decoding (Leviathan et al.): the draft model proposes
    ``gamma`` tokens per round; the target verifies them in ONE forward and
    accepts a prefix, resampling the first rejection from the residual
    distribution max(p - q, 0) -- the target's own distribution, so with
    temperature=0 the output EQUALS target-only greedy decoding.

    The JAX version's ``lax.while_loop`` over rounds as a Python loop (each
    round a gamma-step draft loop plus one (gamma+1)-token target forward
    over static-size dense KV caches), with its key stream: ``PRNGKey(seed)``
    split before every draw, so sampled output equals its tokens at the
    same seed.  Batch 1.  Returns [1, S0 + max_new_tokens] int64 on the
    target's device."""
    ids = torch.as_tensor(input_ids, device=target.device).long()
    if ids.shape[0] != 1:
        raise ValueError("speculative_generate is batch-1 (latency decode)")
    tcfg, dcfg = target.config, draft.config
    if tcfg.vocab_size != dcfg.vocab_size:
        raise ValueError("draft and target must share a vocabulary")
    run = _build_speculative(tcfg, dcfg, ids.shape[1], int(max_new_tokens),
                             int(gamma), float(temperature), eos_token_id)
    from ..inference import prng
    with torch.no_grad():
        return run(target.decode_params(), draft.decode_params(), ids,
                   prng.prng_key(seed, target.device))


def _build_speculative(tcfg, dcfg, S0, max_new, gamma, temperature, eos_id):
    from ..inference import prng

    T = S0 + max_new + gamma + 1          # static cache/buffer bound
    t_fwd = _make_decode_fwd(tcfg, all_logits=True)
    d_fwd = _make_decode_fwd(dcfg, all_logits=True)
    # prefill variants project only the LAST position's logits
    t_fwd_last = _make_decode_fwd(tcfg, all_logits=False)
    d_fwd_last = _make_decode_fwd(dcfg, all_logits=False)
    V = tcfg.vocab_size
    greedy = temperature == 0.0

    def dist(logits):
        # [*, V] logits -> sampling distribution at this temperature
        if greedy:
            return torch.nn.functional.one_hot(
                torch.argmax(logits, -1), V).float()
        return torch.softmax(logits / max(temperature, 1e-6), -1)

    def caches(cfg, dt, dev):
        d = cfg.hidden_size // cfg.num_attention_heads
        shape = (cfg.num_hidden_layers, 1, T, cfg.num_key_value_heads, d)
        return (torch.zeros(shape, dtype=dt, device=dev),
                torch.zeros(shape, dtype=dt, device=dev))

    def draw(key, probs):
        # categorical over log-probabilities, one key for the whole row
        return prng.categorical(key, torch.log(probs + 1e-30))

    def run(tp, dp, ids, key):
        dev = ids.device
        ar = torch.arange(T, device=dev)

        def mask_for(pos, s):
            # window of s tokens at absolute positions pos..pos+s-1
            q = pos + torch.arange(s, device=dev)
            return ar[None, :] <= q[:, None]

        t_ck, t_cv = caches(tcfg, tp["embed"].dtype, dev)
        d_ck, d_cv = caches(dcfg, dp["embed"].dtype, dev)

        # prefill BOTH models on the prompt; cur = first target-sampled
        # token, emitted but in neither cache yet
        pos0 = torch.arange(S0, device=dev)
        m0 = mask_for(0, S0)
        t_log, _, _ = t_fwd_last(tp, ids, t_ck, t_cv, pos0, m0)
        d_fwd_last(dp, ids, d_ck, d_cv, pos0, m0)
        key, sub = prng.split(key)
        cur = draw(sub, dist(t_log))[0]

        buf = torch.zeros((max_new + gamma + 1,), dtype=torch.long,
                          device=dev)
        buf[0] = cur
        n, done = 1, False
        arange_g1 = torch.arange(gamma + 1, device=dev)
        while n < max_new and not done:
            pos = S0 + n - 1                 # cur's absolute position

            # -- draft proposes gamma tokens, recording q-dists
            tok, props, qds = cur, [], []
            for i in range(gamma):
                lg, _, _ = d_fwd(dp, tok.view(1, 1), d_ck, d_cv,
                                 torch.tensor([pos + i], device=dev),
                                 mask_for(pos + i, 1))
                qd = dist(lg[0, -1])
                key, sub = prng.split(key)
                tok = draw(sub, qd)
                props.append(tok)
                qds.append(qd)
            props = torch.stack(props)                       # [gamma]
            qds = torch.stack(qds)                           # [gamma, V]

            # -- ONE target forward over [cur, props] (bonus slot last)
            window = torch.cat([cur.view(1), props])         # [gamma+1]
            t_log, _, _ = t_fwd(tp, window[None], t_ck, t_cv,
                                pos + arange_g1, mask_for(pos, gamma + 1))
            pds = dist(t_log[0])                             # [gamma+1, V]

            # -- acceptance: props[i] vs the p-dist at window position i
            key, sub = prng.split(key)
            us = prng.uniform(sub, gamma, minval=0.0)
            p_i = torch.gather(pds[:gamma], 1, props[:, None])[:, 0]
            q_i = torch.gather(qds, 1, props[:, None])[:, 0]
            ratio = torch.where(q_i > 0, p_i / torch.clamp_min(q_i, 1e-30),
                                0.0)
            acc = us < torch.clamp_max(ratio, 1.0)
            a = gamma if bool(acc.all()) else \
                int(torch.argmin(torch.cumprod(acc.int(), 0)))

            # -- corrective / bonus token
            resid = pds[a] - (qds[min(a, gamma - 1)] if a < gamma else 0.0)
            resid = torch.clamp_min(resid, 0.0)
            resid_sum = resid.sum()
            corr = torch.where(resid_sum > 0, resid / resid_sum, pds[a])
            key, sub = prng.split(key)
            nxt = draw(sub, corr)

            # -- emit: a accepted proposals then nxt
            emit = torch.cat([props[:a], nxt.view(1)])
            buf[n:n + a + 1] = emit
            if eos_id is not None:
                done = bool((emit == eos_id).any())
            n += a + 1
            cur = nxt
        gen = buf[:max_new].clone()
        if eos_id is not None:
            # generate()'s freeze contract: every position after (and
            # including padding beyond) the first eos reads eos
            hit = gen == eos_id
            if bool(hit.any()):
                first = int(torch.argmax(hit.int()))
                idx = torch.arange(max_new, device=dev)
                gen = torch.where((idx > first) | (idx >= n),
                                  torch.full_like(gen, eos_id), gen)
        return torch.cat([ids, gen[None]], dim=1)

    return run


def from_jax_decode_params(cfg: LlamaConfig, params_np: dict, *,
                           device=None,
                           dtype=torch.float32) -> LlamaForCausalLM:
    """Build the port's model from the JAX package's ``decode_params()``
    pytree converted with ``np.asarray`` (same stacked layout, same
    ``[in, out]`` projections), stored in ``dtype``."""
    def t(a):
        return torch.from_numpy(np.array(a, np.float32))

    model = LlamaForCausalLM(cfg, device=device, dtype=dtype)
    with torch.no_grad():
        for k in LAYER_KEYS:
            model.layers[k].copy_(t(params_np["layers"][k]))
        model.embed.copy_(t(params_np["embed"]))
        model.norm_f.copy_(t(params_np["norm_f"]))
        if model.head is not None:
            model.head.copy_(t(params_np["head"]))
    return model


# ---------------------------------------------------------------------------
# Hugging Face weight bridge: load an HF-format LLaMA checkpoint into
# LlamaForCausalLM (the JAX package's convert_hf_state_dict / from_hf).
# ---------------------------------------------------------------------------

def _unrotate_perm(d):
    """Output-dim permutation mapping HF's rotate-half RoPE layout (pairs
    (i, i + d/2)) onto this model's interleaved layout (pairs (2i, 2i+1))."""
    perm = np.empty(d, np.int64)
    perm[0::2] = np.arange(d // 2)
    perm[1::2] = np.arange(d // 2) + d // 2
    return perm


# HF projections stored [out, in]; this layout stores them [in, out]
_HF_TRANSPOSED = ("self_attn.v_proj.weight", "self_attn.o_proj.weight",
                  "mlp.gate_proj.weight", "mlp.up_proj.weight",
                  "mlp.down_proj.weight", "lm_head.weight")

# HF per-layer names -> the stacked decode layout's keys
_HF_LAYER_KEYS = {
    "input_layernorm.weight": "ln1", "self_attn.q_proj.weight": "wq",
    "self_attn.k_proj.weight": "wk", "self_attn.v_proj.weight": "wv",
    "self_attn.o_proj.weight": "wo",
    "post_attention_layernorm.weight": "ln2",
    "mlp.gate_proj.weight": "gate", "mlp.up_proj.weight": "up",
    "mlp.down_proj.weight": "down"}


def _hf_to_layout(key, w, config: LlamaConfig):
    """One HF tensor ``w`` (torch, on its own device) in this model's
    layout: q/k rows permuted head by head from rotate-half to
    interleaved (k over ``num_key_value_heads``), projections and the
    head transposed to ``[in, out]`` (views), anything else as it is.
    None for ``rotary_emb.inv_freq``, which the model recomputes."""
    if key.endswith("rotary_emb.inv_freq"):
        return None
    d = config.hidden_size // config.num_attention_heads

    def permute_rows(n_heads):
        # w: [n_heads * d, in] in HF layout; permute each head's rows
        perm = torch.from_numpy(_unrotate_perm(d)).to(w.device)
        return w.reshape(n_heads, d, -1).index_select(1, perm) \
            .reshape(n_heads * d, -1)

    if key.endswith("self_attn.q_proj.weight"):
        return permute_rows(config.num_attention_heads).T
    if key.endswith("self_attn.k_proj.weight"):
        return permute_rows(config.num_key_value_heads).T
    if key.endswith(_HF_TRANSPOSED):
        return w.T
    return w


def convert_hf_state_dict(hf_state, config: LlamaConfig):
    """HF transformers LLaMA state_dict -> the same names in this model's
    layout.

    Handles: torch [out, in] -> [in, out] Linear transpose; the
    rotate-half -> interleaved RoPE permutation on q/k projection outputs;
    lm_head transpose.  Values come out as numpy float32.
    """
    out = {}
    for k, v in hf_state.items():
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().float()
        else:
            v = torch.from_numpy(np.array(v, np.float32))
        v = _hf_to_layout(k, v, config)
        if v is not None:
            out[k] = v.numpy()
    return out


def _hf_target(model: LlamaForCausalLM, key: str):
    """The parameter (or stacked layer slice) an HF name loads into;
    None for a tied ``lm_head.weight``.  Raises on a name the model has
    no place for."""
    if key == "model.embed_tokens.weight":
        return model.embed
    if key == "model.norm.weight":
        return model.norm_f
    if key == "lm_head.weight":
        return model.head
    parts = key.split(".", 3)
    if len(parts) == 4 and parts[:2] == ["model", "layers"] \
            and parts[2].isdigit() and parts[3] in _HF_LAYER_KEYS:
        i = int(parts[2])
        if i < model.config.num_hidden_layers:
            return model.layers[_HF_LAYER_KEYS[parts[3]]][i]
    raise ValueError(f"from_hf: no parameter of LlamaForCausalLM takes "
                     f"the HF tensor {key!r}")


def from_hf(hf_model_or_state, config: LlamaConfig | None = None, *,
            device=None, dtype=torch.float32) -> LlamaForCausalLM:
    """Build LlamaForCausalLM from an HF transformers model/state_dict.

    ``config`` comes from the HF model's ``.config`` when not given (a
    bare state dict needs it).  ``device=None`` means CUDA
    (``resolve_device``).  Each tensor is converted on its own device
    (``_hf_to_layout``, the permutation and transposes
    ``convert_hf_state_dict`` applies) and written into the stacked
    parameters in ``dtype``, so a checkpoint already on the card is never
    staged whole on the host.  A tied ``lm_head.weight`` is skipped
    (``head`` stays None)."""
    if hasattr(hf_model_or_state, "state_dict"):
        hf_cfg = getattr(hf_model_or_state, "config", None)
        hf_state = hf_model_or_state.state_dict()
        if config is None and hf_cfg is not None:
            config = LlamaConfig(
                vocab_size=hf_cfg.vocab_size,
                hidden_size=hf_cfg.hidden_size,
                intermediate_size=hf_cfg.intermediate_size,
                num_hidden_layers=hf_cfg.num_hidden_layers,
                num_attention_heads=hf_cfg.num_attention_heads,
                num_key_value_heads=hf_cfg.num_key_value_heads,
                max_position_embeddings=hf_cfg.max_position_embeddings,
                rms_norm_eps=hf_cfg.rms_norm_eps,
                rope_theta=getattr(hf_cfg, "rope_theta", 10000.0),
                tie_word_embeddings=hf_cfg.tie_word_embeddings)
    else:
        hf_state = hf_model_or_state
    if config is None:
        raise ValueError("pass config= when converting a bare state_dict")
    model = LlamaForCausalLM(config, device=device, dtype=dtype)
    written = set()
    with torch.no_grad():
        for k, v in hf_state.items():
            if not isinstance(v, torch.Tensor):
                v = torch.from_numpy(np.array(v, np.float32))
            elif v.dtype == torch.float64:
                v = v.float()          # rounded once to f32, as converted
            v = _hf_to_layout(k, v.detach(), config)
            if v is None:
                continue
            dst = _hf_target(model, k)
            if dst is None:
                continue
            if tuple(v.shape) != tuple(dst.shape):
                raise ValueError(f"from_hf: {k!r} has shape "
                                 f"{tuple(v.shape)} in this layout, the "
                                 f"model expects {tuple(dst.shape)}")
            dst.copy_(v)
            written.add(k)
    L = config.num_hidden_layers
    need = {"model.embed_tokens.weight", "model.norm.weight"} \
        | {f"model.layers.{i}.{n}" for i in range(L) for n in _HF_LAYER_KEYS}
    if model.head is not None:
        need.add("lm_head.weight")
    missing = sorted(need - written)
    if missing:
        raise ValueError(f"from_hf: the state dict lacks {len(missing)} "
                         f"tensor(s), e.g. {missing[:3]}")
    return model
