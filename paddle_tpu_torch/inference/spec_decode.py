"""Speculative decoding over the paged KV cache: propose -> verify ->
accept/rollback (counterpart of paddle_tpu/inference/spec_decode.py).

Plain continuous-batching decode (inference/serving.py) pays one full
forward pass per emitted token.  Speculative decoding (Leviathan et al.,
"Fast Inference from Transformers via Speculative Decoding") breaks that
coupling: a cheap DRAFTER proposes K tokens, the target model scores all
K+1 positions in ONE pass (a [last_token, drafts...] row of the
engine's single ragged step, whose raw logits at every packed position
ride along with the sampled tokens), and rejection sampling
accepts a prefix of the drafts.  Acceptance is provably exact:

- temperature 0: a draft is accepted iff it equals the target argmax at
  its position, and the first rejection emits that argmax — so the
  output stream is byte-identical to plain decode, by induction.
- sampled: accept draft d with probability min(1, p(d)/q(d)) where p is
  the target distribution (the FULL LogitProcessor chain — penalty,
  temperature, top-k, top-p — via sampling.target_dist) and q the draft
  distribution; on rejection, resample from max(p - q, 0) renormalized.
  The emitted token is distributed exactly as p, so the sampled stream
  follows the target distribution — the drafter only changes HOW FAST
  tokens arrive, never WHICH distribution they come from.

Both shipped drafters propose deterministically, making q one-hot: the
accept probability collapses to p(draft) and the rejection residual to p
with the draft zeroed out, which keeps the host-side math cheap and the
exactness argument one line.

Rejected drafts leave garbage K/V in the pages the verify step wrote;
``BlockManager.truncate`` rolls the table back (releasing empty tail
pages and scrubbing content hashes so the prefix cache never serves
rolled-back K/V).

Drafters
--------
``NGramDrafter``: prompt-lookup decoding — find the longest recent
n-gram suffix that occurred earlier in the context and propose the
tokens that followed it.  Zero extra model FLOPs, pure host work; wins
on repetitive text (code, structured output, self-repeating loops).

``DraftModelDrafter``: a small draft model with its OWN paged cache,
embedded as a private single-slot LLMEngine (on the draft model's
device) used purely as a step/pool container.  Catch-up tokens and
subsequent drafts each ride a single-row launch of the engine's ragged
step, whose one sampled token the drafter reads back on the host (a
read that waits for the card: a draft model proposes one token at a
time), and the engine's post-verify ``commit`` truncates the draft cache
back to the accepted prefix so both caches stay in lock-step.
"""
from __future__ import annotations

import numpy as np

from .kv_cache import NULL_BLOCK
from .sampling import make_samp, target_dist

__all__ = ["Drafter", "NGramDrafter", "DraftModelDrafter",
           "verify_and_accept"]


class Drafter:
    """Proposes draft tokens for a running sequence.

    ``propose(rid, context, k)`` returns ``(drafts, q_dists)`` — up to k
    proposed token ids and, for stochastic drafters, the [len(drafts), V]
    proposal distributions q (None means deterministic proposals, i.e.
    one-hot q).  Returning ``([], None)`` opts the sequence out of
    speculation for this step (it plain-decodes).

    ``commit(rid, n_valid)`` is called after each verify round with the
    sequence's accepted length (prompt + emitted tokens whose identity
    the drafter may rely on); stateful drafters roll their own caches
    back here.  ``release(rid)`` drops all per-sequence state (retire or
    preemption).
    """

    def propose(self, rid, context, k):  # pragma: no cover - interface
        raise NotImplementedError

    def commit(self, rid, n_valid):
        pass

    def release(self, rid):
        pass


class NGramDrafter(Drafter):
    """Prompt-lookup decoding: match the context's trailing n-gram
    against earlier context and propose the continuation of its most
    recent prior occurrence.  Longest n wins; stateless and free."""

    def __init__(self, *, max_ngram: int = 3, min_ngram: int = 1,
                 max_context: int = 2048):
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError("need 1 <= min_ngram <= max_ngram")
        self.max_ngram = int(max_ngram)
        self.min_ngram = int(min_ngram)
        self.max_context = int(max_context)

    def propose(self, rid, context, k):
        ctx = list(context[-self.max_context:])
        L = len(ctx)
        for n in range(min(self.max_ngram, L - 1), self.min_ngram - 1, -1):
            pat = ctx[L - n:]
            for i in range(L - n - 1, -1, -1):
                if ctx[i:i + n] == pat:
                    cont = ctx[i + n:i + n + k]
                    if cont:
                        return cont, None
                    break
        return [], None


class DraftModelDrafter(Drafter):
    """Small-draft-model proposals with their own paged KV cache.

    The inner LLMEngine is a CONTAINER, not a scheduler: this class
    drives its ragged step program by hand, one sequence per call, so
    the draft cache lives in the same kind of paged pool (and rolls
    back through the same ``truncate``) as the target's.
    ``capacity`` bounds how many sequences can hold draft state at once
    — a pool-exhausted proposal returns ``([], None)`` and the engine
    falls back to plain decode for that sequence.
    """

    def __init__(self, model, *, block_size: int = 16,
                 max_model_len: int | None = None, capacity: int = 8,
                 catchup_bucket: int = 64, kv_dtype: str = "float32"):
        from .serving import LLMEngine   # deferred: serving imports us

        nblk = -(-int(max_model_len or model.config.max_position_embeddings)
                 // int(block_size))
        # kv_dtype rides through so a quantized target engine can keep
        # its draft cache quantized too (half the reason to quantize is
        # freeing HBM for MORE resident state, drafts included)
        self._eng = LLMEngine(
            model, device=model.device, max_num_seqs=1,
            block_size=block_size,
            num_blocks=1 + int(capacity) * nblk,
            max_model_len=max_model_len,
            max_prefill_tokens=int(catchup_bucket),
            prefill_token_bucket=int(catchup_bucket),
            enable_prefix_caching=False, kv_dtype=kv_dtype)
        self._valid: dict = {}            # rid -> tokens with draft K/V

    @property
    def engine(self):
        return self._eng

    def propose(self, rid, context, k):
        eng = self._eng
        bm = eng.blocks
        n = len(context)
        k = min(int(k), eng.max_model_len - n)
        if k <= 0 or n == 0:
            return [], None
        if rid not in self._valid or not bm.has(rid):
            if not bm.allocate(rid, n):
                return [], None
            self._valid[rid] = 0
        if not bm.ensure(rid, n + k):
            self.release(rid)
            return [], None
        # catch up: feed every context token not yet in the draft cache
        # (at least the newest one) through one ragged chunk row, then
        # greedy-decode the remaining drafts one token at a time
        st = min(self._valid.get(rid, 0), n - 1)
        tok = self._chunk(rid, context[st:], st)
        drafts = [tok]
        pos = n
        while len(drafts) < k:
            tok = self._decode(rid, tok, pos)
            drafts.append(tok)
            pos += 1
        self._valid[rid] = n + len(drafts) - 1
        return drafts, None

    def commit(self, rid, n_valid):
        eng = self._eng
        if rid in self._valid and eng.blocks.has(rid):
            eng.blocks.truncate(rid, int(n_valid))
            self._valid[rid] = min(self._valid[rid], int(n_valid))

    def release(self, rid):
        if self._eng.blocks.has(rid):
            self._eng.blocks.free(rid)
        self._valid.pop(rid, None)

    def _chunk(self, rid, gap, start):
        # one single-row ragged launch: the gap enters at absolute
        # positions start..start+g-1, greedy-sampling the last position
        eng = self._eng
        g = len(gap)
        Tq = eng._ragged_bucket(g)
        toks = np.zeros((Tq,), np.int32)
        toks[:g] = gap
        cu = np.asarray([0, g], np.int32)
        kvl = np.asarray([start + g], np.int32)
        bt = np.full((2, eng.nblk), NULL_BLOCK, np.int32)
        bt[0] = eng.blocks.padded_table(rid, eng.nblk)
        lidx = np.asarray([g - 1], np.int32)
        samp = make_samp(1, eng.config.vocab_size)    # greedy defaults
        result, _ = eng._launch_ragged(Tq, toks, cu, kvl, bt, lidx, samp,
                                       g)
        return int(result[0, 0])

    def _decode(self, rid, tok, pos):
        # a decode token is just a one-token ragged row (same program)
        eng = self._eng
        toks = np.asarray([tok], np.int32)
        cu = np.asarray([0, 1], np.int32)
        kvl = np.asarray([pos + 1], np.int32)
        bt = np.full((2, eng.nblk), NULL_BLOCK, np.int32)
        bt[0] = eng.blocks.padded_table(rid, eng.nblk)
        lidx = np.zeros((1,), np.int32)
        samp = make_samp(1, eng.config.vocab_size)    # greedy defaults
        result, _ = eng._launch_ragged(eng._ragged_bucket(1), toks, cu,
                                       kvl, bt, lidx, samp, 1)
        return int(result[0, 0])


def verify_and_accept(logits, drafts, *, q_dists=None, temperature=0.0,
                      top_k=0, top_p=1.0, penalty=1.0, seen=None,
                      rng=None):
    """Rejection-sampling acceptance for ONE sequence's verify logits.

    logits: [k+1, V] target logits — row i is the position that feeds
    draft i (row k is the bonus position after the last draft).
    drafts: the k proposed tokens.  q_dists: [k, V] proposal
    distributions, or None for deterministic (one-hot) drafters.
    seen: the request's repetition-penalty mask (mutated in place as
    tokens are accepted, exactly as sequential decode would grow it).
    rng: numpy Generator for the sampled path (None is fine for greedy).

    Returns ``(n_accepted, emitted)`` — emitted is the accepted draft
    prefix plus exactly one more token: the rejection resample, or the
    bonus token when every draft survived.  Each emitted token is
    distributed exactly as plain decode at its position.
    """
    lg = np.asarray(logits, np.float32)
    k = len(drafts)
    greedy = temperature <= 0.0
    emitted = []

    def dist(i):
        return target_dist(lg[i], temperature=temperature, top_k=top_k,
                           top_p=top_p, penalty=penalty, seen=seen)

    def note(tok):
        if seen is not None:
            seen[tok] = True

    for i, d in enumerate(drafts):
        d = int(d)
        p = dist(i)
        if greedy:
            if p[d] > 0.0:                       # d IS the argmax
                emitted.append(d)
                note(d)
                continue
            g = int(np.argmax(p))
            emitted.append(g)
            note(g)
            return i, emitted
        q = None if q_dists is None else np.asarray(q_dists[i], np.float32)
        qd = 1.0 if q is None else float(q[d])
        ratio = p[d] / qd if qd > 0.0 else 0.0
        if float(rng.uniform()) < min(1.0, ratio):
            emitted.append(d)
            note(d)
            continue
        # rejected: resample from the residual max(p - q, 0); one-hot q
        # zeroes only the draft itself
        if q is None:
            res = p.copy()
            res[d] = 0.0
        else:
            res = np.maximum(p - q, 0.0)
        s = float(res.sum())
        res = res / s if s > 0.0 else p
        t = int(np.searchsorted(np.cumsum(res), rng.uniform(), side="right"))
        t = min(t, len(res) - 1)
        emitted.append(t)
        note(t)
        return i, emitted

    # every draft accepted: the bonus position emits one more token
    p = dist(k)
    if greedy:
        t = int(np.argmax(p))
    else:
        t = int(np.searchsorted(np.cumsum(p), rng.uniform(), side="right"))
        t = min(t, len(p) - 1)
    emitted.append(t)
    note(t)
    return k, emitted
