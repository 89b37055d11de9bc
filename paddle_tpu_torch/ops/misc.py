"""The rest of the op surface (counterpart of paddle_tpu/ops/misc.py):
``shape``, ``multiplex``, ``fill_``, ``sequence_mask``, the beam and
sequence utilities (``gather_tree``, ``top_p_sampling``,
``edit_distance``, ``viterbi_decode``) and ``as_strided``, beside the
kernel-driven ones the generator writes (re-exported here).

``edit_distance`` runs its dynamic programme on the host, as the JAX
package does; its results go to the input's device.  ``top_p_sampling``
with ``seed >= 0`` draws from a generator seeded with it (one seed, one
draw), else from the input device's generator; its draws are not the
JAX package's."""
from __future__ import annotations

import numpy as np
import torch

from ..core import dispatch as D
from ..core import random_state
from ..core.dtype import to_torch_dtype
from ..core.tensor import Tensor
from ._inplace import apply_inplace
from .manipulation import device_of, host_values
from .generated.op_wrappers import (  # noqa: F401
    cast, clip_by_norm, diag_embed, fill_diagonal, fill_diagonal_tensor,
    frobenius_norm, gammainc, gammaincc, inverse, mean_all, multigammaln,
    mv, reverse, slice_scatter, squared_l2_norm, temporal_shift,
)

__all__ = [
    "cast", "shape", "mv", "inverse", "multiplex", "reverse", "fill_",
    "fill_diagonal", "fill_diagonal_tensor", "diag_embed", "clip_by_norm",
    "mean_all", "frobenius_norm", "squared_l2_norm", "sequence_mask",
    "gather_tree", "top_p_sampling", "temporal_shift", "edit_distance",
    "viterbi_decode", "as_strided", "slice_scatter", "gammainc",
    "gammaincc", "multigammaln",
]


def shape(x, name=None):
    """The shape as an int32 tensor on x's device."""
    return Tensor(torch.tensor(list(x.shape), dtype=torch.int32,
                               device=device_of(x)))


def _multiplex(idx, *cands):
    stacked = torch.stack(cands, dim=0)              # [C, B, ...]
    sel = idx.reshape(-1).long()                     # [B]
    rows = torch.arange(stacked.shape[1], device=stacked.device)
    return stacked[sel, rows]


def multiplex(inputs, index, name=None):
    """Row-wise select across candidates: out[i] = inputs[index[i]][i]."""
    return D.apply("multiplex", _multiplex, (index, *inputs))


def fill_(x, value):
    """Fill x in place with value."""
    return apply_inplace(x, lambda s: Tensor._wrap(
        torch.full_like(s._data, value)))


def _sequence_mask(lens, maxlen, dt):
    pos = torch.arange(maxlen, dtype=lens.dtype, device=lens.device)
    return (pos[None, :] < lens.reshape(-1, 1)).reshape(
        tuple(lens.shape) + (maxlen,)).to(dt)


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    """Lengths -> mask [..., maxlen]; maxlen defaults to the largest
    length, read on the host."""
    if maxlen is None:
        D.check_host_read()
        maxlen = int(x._data.max()) if x.size else 0
    return D.apply("sequence_mask", _sequence_mask, (x,),
                   {"maxlen": int(maxlen), "dt": to_torch_dtype(dtype)})


def _gather_tree(ids, parents):
    T = ids.shape[0]
    beam = torch.arange(ids.shape[2], dtype=parents.dtype,
                        device=ids.device)[None, :].expand(ids.shape[1], -1)
    rev = []
    for t in range(T):
        tt = T - 1 - t
        rev.append(torch.gather(ids[tt], 1, beam.long()))
        beam = torch.gather(parents[tt], 1, beam.long()).to(beam.dtype)
    return torch.flip(torch.stack(rev), dims=(0,))


def gather_tree(ids, parents, name=None):
    """Full beam-search sequences from per-step ids and parent beams
    ([T, B, beam])."""
    return D.apply("gather_tree", _gather_tree, (ids, parents))


def _top_p_sampling(probs, ps, gen):
    sort_idx = torch.argsort(-probs, dim=-1, stable=True)
    sorted_p = torch.gather(probs, -1, sort_idx)
    cum = torch.cumsum(sorted_p, dim=-1)
    keep = cum - sorted_p <= ps.reshape(-1, 1)      # the top token stays
    trimmed = torch.where(keep, sorted_p, torch.zeros_like(sorted_p))
    trimmed = trimmed / torch.sum(trimmed, dim=-1, keepdim=True)
    u = torch.rand(trimmed.shape, dtype=torch.float32, device=probs.device,
                   generator=gen)
    tiny = torch.finfo(torch.float32).tiny
    gumbel = -torch.log(-torch.log(torch.clamp(u, min=tiny)))
    pick = torch.argmax(torch.log(torch.clamp(trimmed.float(), min=1e-38))
                        + gumbel, dim=-1)
    ids = torch.gather(sort_idx, -1, pick[:, None])
    return torch.gather(probs, -1, ids), ids


def top_p_sampling(x, ps, threshold=None, seed=-1, name=None):
    """Nucleus sampling over probabilities x [B, V] with per-row p.
    Returns (sampled probabilities, sampled ids); the gradient reaches x
    through the sampled probabilities, as in the JAX package."""
    dev = x._data.device
    if seed >= 0:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
    else:
        gen = random_state.generator(dev)
    return D.apply("top_p_sampling", _top_p_sampling, (x, ps), {"gen": gen})


def edit_distance(input, label, normalized=True, ignored_tokens=None,
                  input_length=None, label_length=None, name=None):
    """Batched Levenshtein distance, a dynamic programme on the host.
    Returns (distance [B, 1] float32, sequence_num [1] int64)."""
    hyp, ref = host_values(input), host_values(label)
    hl = (host_values(input_length).reshape(-1) if input_length is not None
          else np.full((hyp.shape[0],), hyp.shape[1], np.int64))
    ll = (host_values(label_length).reshape(-1) if label_length is not None
          else np.full((ref.shape[0],), ref.shape[1], np.int64))
    ignored = set(ignored_tokens or ())
    out = np.zeros((hyp.shape[0], 1), np.float32)
    for b in range(hyp.shape[0]):
        h = [t for t in hyp[b][:hl[b]].tolist() if t not in ignored]
        r = [t for t in ref[b][:ll[b]].tolist() if t not in ignored]
        dp = np.arange(len(r) + 1, dtype=np.float32)
        for i, th in enumerate(h, 1):
            prev = dp.copy()
            dp[0] = i
            for j, tr in enumerate(r, 1):
                dp[j] = min(prev[j] + 1, dp[j - 1] + 1,
                            prev[j - 1] + (th != tr))
        d = dp[len(r)]
        if normalized:
            d = d / max(len(r), 1)
        out[b, 0] = d
    dev = device_of(input)
    return (Tensor(torch.from_numpy(out).to(dev)),
            Tensor(torch.tensor([hyp.shape[0]], dtype=torch.int64,
                                device=dev)))


def _viterbi(emis, trans, lens, with_tag):
    B, T, N = emis.shape
    emis = emis.to(torch.float32)
    trans = trans.to(torch.float32)
    if with_tag:
        # rows/cols N and N+1 are BOS/EOS
        start, stop, tr = trans[N, :N], trans[:N, N + 1], trans[:N, :N]
    else:
        start = torch.zeros(N, dtype=torch.float32, device=emis.device)
        stop, tr = start, trans
    alpha = emis[:, 0] + start[None, :]
    backs = []
    for t in range(1, T):
        scores = alpha[:, :, None] + tr[None, :, :] + emis[:, t][:, None, :]
        best = torch.amax(scores, dim=1)
        back = torch.argmax(scores, dim=1)
        live = (t < lens)[:, None]
        alpha = torch.where(live, best, alpha)
        backs.append(back)
    final = alpha + stop[None, :] if with_tag else alpha
    score = torch.amax(final, dim=-1)
    tag = torch.argmax(final, dim=-1)
    tags = [tag]
    for t in range(T - 1):
        tt = T - 2 - t
        prev = torch.gather(backs[tt], 1, tag[:, None])[:, 0]
        tag = torch.where((tt + 1) < lens, prev, tag)
        tags.append(tag)
    return score, torch.stack(tags[::-1], dim=1).to(torch.int64)


def viterbi_decode(potentials, transition_params, lengths,
                   include_bos_eos_tag=True, name=None):
    """CRF Viterbi decoding: potentials [B, T, N], transitions [N(+2), ...].
    Returns (scores [B], paths [B, T])."""
    return D.apply("viterbi_decode", _viterbi,
                   (potentials, transition_params, lengths),
                   {"with_tag": bool(include_bos_eos_tag)})


def _as_strided(a, shape, stride, offset):
    flat = a.reshape(-1)
    idx = torch.tensor(offset, dtype=torch.int64, device=a.device)
    for n, s in zip(shape, stride):
        idx = idx[..., None] + torch.arange(n, dtype=torch.int64,
                                            device=a.device) * s
    # out-of-range positions clamp, as the JAX package's gather does
    return flat[torch.clamp(idx.reshape(shape), 0, flat.numel() - 1)]


def as_strided(x, shape, stride, offset=0, name=None):
    """A strided view of x's flat values, as a copy."""
    return D.apply("as_strided", _as_strided, (x,),
                   {"shape": tuple(int(s) for s in shape),
                    "stride": tuple(int(s) for s in stride),
                    "offset": int(offset)})
