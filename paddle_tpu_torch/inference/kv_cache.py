"""Paged KV-cache block management for the serving engine.

The device caches are a fixed pool of ``num_blocks`` pages of
``block_size`` token slots each (layout ``[L, num_blocks, H_kv, bs, D]``,
the blha cache layout per layer).  This module owns the HOST side of that
pool: which pages belong to which sequence, in order — the per-sequence
block table the paged-attention kernel walks via scalar prefetch
(ops/pallas/paged_attention.py).  Mirrors the reference serving stack's
block manager around block_multi_head_attention (and vLLM's BlockManager
shape): alloc on admission, grow one page at a time during decode, free on
retirement, and report occupancy/fragmentation so the scheduler can decide
when to stop admitting and when to preempt.

Prefix caching (``enable_prefix_caching=True``) turns the pool into a
content-addressed cache: every FULL page is identified by a rolling chain
hash of all prompt/generated tokens up to and including that page, and a
hash → block map lets a new sequence whose token prefix matches reuse the
page instead of recomputing its KV.  Reuse is refcounted — a page may back
several live sequences at once — and any write into a page with
refcount > 1 first COPIES it (copy-on-write), so divergence after a shared
partial page never corrupts a neighbour.  Freed pages whose content is
registered are not returned to the free list; they park in an LRU of
refcount-0 "cached" pages and are only evicted (unregistered) when the
free list is empty — eviction is the last resort, so a hot system prompt
stays resident.  Page lifecycle:

    free → allocated (refcount 1) → shared (refcount n)
                  │                      │
                  └──── freed, hashed ───┘
                            ↓
                    cached (refcount 0, LRU) ── evicted ──→ free

Block id 0 is reserved as the NULL page: padded scheduler slots point
every block-table entry at it, so their (masked) cache writes land in a
page no live sequence owns.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np

__all__ = ["BlockManager", "BlockPoolExhausted", "NULL_BLOCK",
           "prefix_chain_hashes"]

NULL_BLOCK = 0


class BlockPoolExhausted(RuntimeError):
    """No free or evictable page is left — the caller must preempt."""


def _page_hash(prev, tokens):
    """Rolling chain hash: a page's identity is its OWN tokens plus the
    hash chain of every page before it, so identical pages at different
    prefix positions never alias."""
    return hash((prev, tuple(tokens)))


class BlockManager:
    """Fixed-size page pool with per-sequence block tables.

    Invariants (asserted by tests/test_llm_engine.py and
    tests/test_prefix_cache.py via ``check_invariants``):
    - block 0 (the null page) is never handed out;
    - every block is exactly one of: free, cached (refcount 0, hashed),
      or live (refcount >= 1);
    - a live block's refcount equals the number of block tables holding
      it (sharing only via the prefix cache);
    - num_used + num_free + num_cached == num_blocks - 1 at all times;
    - free() of an unknown/already-freed sequence raises instead of
      corrupting the free list.
    """

    def __init__(self, num_blocks: int, block_size: int,
                 enable_prefix_caching: bool = False):
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (one is the reserved null page)")
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.enable_prefix_caching = bool(enable_prefix_caching)
        # LIFO free list (ids 1..num_blocks-1); id 0 stays reserved
        self._free = list(range(self.num_blocks - 1, NULL_BLOCK, -1))
        self._tables: dict = {}          # seq id -> [block ids, in order]
        self._tokens: dict = {}          # seq id -> token count covered
        self._ref: dict = {}             # block id -> refcount (>= 1)
        # prefix-cache state
        self._cached: OrderedDict = OrderedDict()   # refcount-0 LRU
        self._hash_to_block: dict = {}   # chain hash -> block id
        self._block_hashes: dict = {}    # block id -> set of chain hashes
        self._ids: dict = {}             # seq id -> token ids (or None)
        self._valid: dict = {}           # seq id -> positions with valid KV
        self._chain: dict = {}           # seq id -> per-full-page chain hashes
        self._version: dict = {}         # seq id -> table mutation counter
        self._freed: set = set()         # for clear double-free errors
        # pages handed out since the last drain_fresh(): their previous
        # content (and, in int8 mode, their quantization scales) is dead.
        # The quantized engine drains this each step and resets the scale
        # rows device-side before any new write lands.
        self._fresh: set = set()
        # hierarchical-KV spill quarantine: when a host tier is attached
        # (spill_on_evict=True, set by the engine), evict_parked moves
        # registered LRU pages here instead of freeing them — the device
        # bytes must survive until the engine's step-boundary drain
        # copies them host-side.  block id -> tuple of chain hashes.
        self.spill_on_evict = False
        self._spill_pending: dict = {}
        # counters for the scheduler stats surface
        self.alloc_count = 0
        self.free_count = 0
        self.peak_used = 0
        self.cache_hit_tokens = 0
        self.cache_miss_tokens = 0
        self.cow_count = 0
        self.eviction_count = 0
        self.parked_evicted = 0
        self.spill_quarantined = 0    # pages routed to the spill drain
        self.spill_restored = 0       # pages adopted back from the tier
        # fault-injection seam: a nullary callable returning True while a
        # FaultPlan simulates pool exhaustion (allocation pressure without
        # shrinking the pool); None -> zero cost
        self._fault_hook = None

    # -- capacity queries ---------------------------------------------------

    def blocks_for(self, n_tokens: int) -> int:
        """Pages needed to hold n_tokens."""
        return max(0, -(-int(n_tokens) // self.block_size))

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_cached(self) -> int:
        return len(self._cached)

    @property
    def num_spill_pending(self) -> int:
        """Pages quarantined for the host-tier spill drain.  They free at
        the next step boundary, so pressure accounting may credit them as
        reclaimable headroom — but the allocator must NOT hand them out
        (their device bytes are still awaited by the drain)."""
        return len(self._spill_pending)

    @property
    def num_used(self) -> int:
        return (self.num_blocks - 1) - len(self._free) \
            - len(self._cached) - len(self._spill_pending)

    def can_allocate(self, n_blocks: int) -> bool:
        if self._fault_hook is not None and self._fault_hook():
            return False
        # cached pages are evictable, so they count as available
        return n_blocks <= len(self._free) + len(self._cached)

    # -- pool primitives ----------------------------------------------------

    def _take_block(self) -> int:
        """One fresh page: free list first, else evict the LRU cached page
        (the only moment a cached page loses its registered content)."""
        if self._fault_hook is not None and self._fault_hook():
            raise BlockPoolExhausted("injected pool exhaustion")
        if self._free:
            blk = self._free.pop()
            self._fresh.add(blk)
            return blk
        if self._cached:
            blk, _ = self._cached.popitem(last=False)     # oldest first
            self._unregister(blk)
            self.eviction_count += 1
            self._fresh.add(blk)
            return blk
        raise BlockPoolExhausted("no free or evictable page left")

    def _unregister(self, blk: int) -> None:
        for h in self._block_hashes.pop(blk, ()):
            if self._hash_to_block.get(h) == blk:
                del self._hash_to_block[h]

    def _register(self, blk: int, h) -> None:
        # first content wins: a hash already mapping to another live/cached
        # block keeps pointing there (dedup happens at match time)
        if self._hash_to_block.setdefault(h, blk) == blk:
            self._block_hashes.setdefault(blk, set()).add(h)

    def _incref(self, blk: int) -> None:
        self._ref[blk] = self._ref.get(blk, 0) + 1
        self._cached.pop(blk, None)

    def _decref(self, blk: int) -> None:
        r = self._ref.get(blk, 0)
        if r <= 0:
            raise AssertionError(
                f"refcount underflow on block {blk} (double free?)")
        if r == 1:
            del self._ref[blk]
            if self._block_hashes.get(blk):
                self._cached[blk] = None      # park, content stays valid
            else:
                self._free.append(blk)
        else:
            self._ref[blk] = r - 1

    # -- alloc / grow / free ------------------------------------------------

    def allocate(self, seq_id, n_tokens: int) -> bool:
        """Claim fresh pages covering n_tokens for a new sequence (no
        prefix matching — token ids unknown).  False (and no state change)
        when the pool cannot cover the request."""
        if seq_id in self._tables:
            raise ValueError(f"sequence {seq_id!r} already has a block table")
        need = self.blocks_for(n_tokens)
        if not self.can_allocate(need):
            return False
        table = [self._take_block() for _ in range(need)]
        for b in table:
            self._incref(b)
        self._tables[seq_id] = table
        self._tokens[seq_id] = int(n_tokens)
        self._ids[seq_id] = None
        self._valid[seq_id] = 0
        self._chain[seq_id] = []
        self._version[seq_id] = 0
        self._freed.discard(seq_id)
        self.alloc_count += need
        self.peak_used = max(self.peak_used, self.num_used)
        return True

    def match_prefix(self, token_ids) -> int:
        """Longest cached prefix (in tokens) for token_ids, capped at
        len(token_ids) - 1 so at least one token is always (re)computed
        for logits.  Read-only: no refcounts change."""
        hits, partial, n_hit = self._match(list(token_ids))
        return n_hit

    def _match(self, ids):
        """(full_hit_blocks, partial_hit_block_or_None, n_hit_tokens)."""
        if not self.enable_prefix_caching:
            return [], None, 0
        bs = self.block_size
        n = len(ids)
        hits, prev = [], None
        for p in range(n // bs):
            h = _page_hash(prev, ids[p * bs:(p + 1) * bs])
            blk = self._hash_to_block.get(h)
            if blk is None or blk in hits:
                break
            hits.append(blk)
            prev = h
        while len(hits) * bs >= n:        # keep >= 1 token to compute
            hits.pop()
            prev = None if not hits else _page_hash_chain(ids, len(hits), bs)
        n_hit = len(hits) * bs
        partial = None
        rem = ids[n_hit:]
        for k in range(min(bs - 1, n - 1 - n_hit), 0, -1):
            h = _page_hash(prev, rem[:k])
            blk = self._hash_to_block.get(h)
            if blk is not None and blk not in hits:
                partial = blk
                n_hit += k
                break
        return hits, partial, n_hit

    def acquire(self, seq_id, token_ids):
        """Prefix-cached admission: match token_ids against the cache,
        take refcounted references on every hit page, claim fresh pages
        for the miss suffix.  Returns the number of prefix tokens whose
        KV is already valid (0 on a clean miss), or None when the pool
        cannot cover the miss suffix."""
        if seq_id in self._tables:
            raise ValueError(f"sequence {seq_id!r} already has a block table")
        ids = [int(t) for t in token_ids]
        if not ids:
            raise ValueError("empty token_ids")
        if not self.enable_prefix_caching:
            return 0 if self.allocate(seq_id, len(ids)) else None
        hits, partial, n_hit = self._match(ids)
        hit_blocks = hits + ([partial] if partial is not None else [])
        fresh = self.blocks_for(len(ids)) - len(hit_blocks)
        evictable_hits = sum(1 for b in hit_blocks if b in self._cached)
        if fresh > len(self._free) + len(self._cached) - evictable_hits \
                or (fresh > 0 and self._fault_hook is not None
                    and self._fault_hook()):
            return None
        for b in hit_blocks:
            self._incref(b)
        table = hit_blocks + [self._take_block() for _ in range(fresh)]
        for b in table[len(hit_blocks):]:
            self._incref(b)
        self._tables[seq_id] = table
        self._tokens[seq_id] = len(ids)
        self._ids[seq_id] = ids
        self._valid[seq_id] = n_hit
        # chain hashes for the full hit pages (prefix of the table)
        chain, prev = [], None
        for p in range(len(hits)):
            prev = _page_hash(prev, ids[p * self.block_size:
                                        (p + 1) * self.block_size])
            chain.append(prev)
        self._chain[seq_id] = chain
        self._version[seq_id] = 0
        self._freed.discard(seq_id)
        self.alloc_count += fresh
        self.cache_hit_tokens += n_hit
        self.cache_miss_tokens += len(ids) - n_hit
        self.peak_used = max(self.peak_used, self.num_used)
        return n_hit

    def ensure(self, seq_id, n_tokens: int) -> bool:
        """Grow seq_id's table until it covers n_tokens (decode appends one
        token per step; this allocates the next page on a boundary).  False
        when the pool is exhausted — the scheduler's preemption trigger."""
        table = self._tables[seq_id]
        need = self.blocks_for(n_tokens)
        grow = need - len(table)
        if grow > 0:
            if not self.can_allocate(grow):
                return False
            for _ in range(grow):
                b = self._take_block()
                self._incref(b)
                table.append(b)
            self.alloc_count += grow
            self._version[seq_id] += 1
            self.peak_used = max(self.peak_used, self.num_used)
        self._tokens[seq_id] = max(self._tokens.get(seq_id, 0), int(n_tokens))
        return True

    def reserve_window(self, rows):
        """All-or-nothing page-slack reservation for a K-step decode window.

        ``rows`` is an iterable of ``(seq_id, n_tokens)`` targets.  Every
        sequence is grown (``ensure``) to its target; if ANY row cannot be
        covered, every grow this call performed is rolled back (``truncate``
        to the recorded prior token count — a no-op truncate drops no pages
        and does not bump the table version) and ``None`` is returned with
        the pool exactly as found.  On success returns the list of prior
        token counts, one per row, in input order: the rollback targets a
        caller must truncate back to if IT later abandons the window (e.g.
        a copy-on-write resolution fails mid-reservation).
        """
        done = []
        for seq_id, n_tokens in rows:
            prior = self._tokens.get(seq_id, 0)
            try:
                grown = self.ensure(seq_id, int(n_tokens))
            except BlockPoolExhausted:
                grown = False
            if not grown:
                for sid, tok in reversed(done):
                    self.truncate(sid, tok)
                return None
            done.append((seq_id, prior))
        return [tok for _, tok in done]

    def cow_if_shared(self, seq_id, pos: int):
        """Call before writing token position ``pos``: when the page
        holding pos is shared (refcount > 1) the writer gets a private
        copy — the table entry is swapped and (src, dst) returned so the
        engine can copy the page device-side.  None when the page is
        already private.  Raises BlockPoolExhausted when no page is
        available for the copy (preemption trigger)."""
        table = self._tables[seq_id]
        idx = int(pos) // self.block_size
        src = table[idx]
        if self._ref.get(src, 0) <= 1:
            return None
        dst = self._take_block()          # may raise BlockPoolExhausted
        # the engine's CoW program copies the page's quantization scale
        # rows along with its data, so the dst page is NOT fresh — a
        # scale reset here would corrupt the copied int8 content
        self._fresh.discard(dst)
        self._incref(dst)
        table[idx] = dst
        self._decref(src)                 # others keep the original
        self._version[seq_id] += 1
        self.cow_count += 1
        self.alloc_count += 1
        self.peak_used = max(self.peak_used, self.num_used)
        return src, dst

    def commit_prefill(self, seq_id, n_new: int) -> None:
        """Mark n_new more positions as device-valid (their KV writes are
        dispatched) and register every page this fills in the hash map."""
        if self._ids.get(seq_id) is None:
            self._valid[seq_id] = self._valid.get(seq_id, 0) + int(n_new)
            return
        v = self._valid[seq_id] + int(n_new)
        if v > len(self._ids[seq_id]):
            raise AssertionError(
                f"commit past known tokens for {seq_id!r}: {v} > "
                f"{len(self._ids[seq_id])}")
        self._valid[seq_id] = v
        self._register_full_pages(seq_id)

    def commit_decode_token(self, seq_id, token) -> None:
        """One decode step wrote `token`'s KV at the next position."""
        ids = self._ids.get(seq_id)
        if ids is None:
            self._valid[seq_id] = self._valid.get(seq_id, 0) + 1
            return
        if len(ids) != self._valid[seq_id]:
            raise AssertionError(
                f"decode commit for {seq_id!r} before prefill finished "
                f"({self._valid[seq_id]}/{len(ids)} valid)")
        ids.append(int(token))
        self._tokens[seq_id] = max(self._tokens.get(seq_id, 0), len(ids))
        self._valid[seq_id] = len(ids)
        self._register_full_pages(seq_id)

    def _register_full_pages(self, seq_id) -> None:
        if not self.enable_prefix_caching:
            return
        bs = self.block_size
        ids = self._ids[seq_id]
        chain = self._chain[seq_id]
        table = self._tables[seq_id]
        full = self._valid[seq_id] // bs
        while len(chain) < full:
            p = len(chain)
            prev = chain[-1] if chain else None
            h = _page_hash(prev, ids[p * bs:(p + 1) * bs])
            chain.append(h)
            self._register(table[p], h)

    def truncate(self, seq_id, n_tokens: int) -> int:
        """Roll seq_id back to its first ``n_tokens`` tokens (speculative-
        decode rejection: the verify step wrote K/V for draft tokens that
        were not accepted).  Three effects:

        - tail pages no longer needed by n_tokens are decommitted and
          released (refcount drop: shared pages stay live for their other
          owners, registered refcount-0 pages park in the cached LRU,
          the rest rejoin the free list);
        - content hashes registered by THIS sequence for pages at or past
          the new boundary are un-registered when the page is private
          (refcount 1): future writes will overwrite those slots, and the
          prefix cache must never serve rolled-back K/V.  Shared pages
          keep their registration — their content is still valid for the
          other owners, and this sequence's future writes copy-on-write
          first, so the registered bytes are never clobbered;
        - the sequence's id/valid/chain bookkeeping shrinks to n_tokens.

        Returns the number of pages released.  Truncating to a count the
        table already satisfies (no page drop, no hash past the boundary)
        is a cheap no-op that does not bump the table version.
        """
        if seq_id not in self._tables:
            raise ValueError(f"truncate of unknown sequence {seq_id!r}")
        n = int(n_tokens)
        if n < 0:
            raise ValueError(f"n_tokens must be >= 0, got {n}")
        table = self._tables[seq_id]
        bs = self.block_size
        need = self.blocks_for(n)
        if need > len(table):
            raise ValueError(
                f"truncate({seq_id!r}, {n}) needs {need} pages but the "
                f"table holds {len(table)}")
        dropped = len(table) - need
        # un-register full-page hashes this sequence registered beyond the
        # new boundary: those slots will be rewritten with different
        # tokens, so a prefix match on the old content would serve
        # rolled-back K/V.  Only private pages are scrubbed — a shared
        # page's content survives (CoW guards future writes).
        chain = self._chain.get(seq_id, [])
        full_keep = n // bs
        for p in range(full_keep, len(chain)):
            if p < len(table):
                blk = table[p]
                if self._ref.get(blk, 0) == 1 \
                        and self._hash_to_block.get(chain[p]) == blk:
                    del self._hash_to_block[chain[p]]
                    hs = self._block_hashes.get(blk)
                    if hs is not None:
                        hs.discard(chain[p])
                        if not hs:
                            del self._block_hashes[blk]
        del chain[full_keep:]
        if n % bs and full_keep < len(table) \
                and self._ref.get(table[full_keep], 0) == 1:
            # partial boundary page: slots >= n % bs will be rewritten, so
            # partial-prefix hashes registered by earlier owners (free()
            # registers written tails) could also serve rolled-back K/V.
            # Conservatively scrub every hash on the private page.
            self._unregister(table[full_keep])
        # release the tail pages themselves
        for blk in reversed(table[need:]):
            self._decref(blk)
        del table[need:]
        ids = self._ids.get(seq_id)
        if ids is not None and len(ids) > n:
            del ids[n:]
        if self._valid.get(seq_id, 0) > n:
            self._valid[seq_id] = n
        if self._tokens.get(seq_id, 0) > n:
            self._tokens[seq_id] = n
        if dropped:
            self._version[seq_id] += 1
            self.free_count += dropped
        return dropped

    def free(self, seq_id) -> None:
        """Return every page of seq_id (retirement/preemption): refcounts
        drop by one; pages with registered content park in the cached LRU,
        the rest rejoin the free list.  A written partial tail page is
        registered on the way out so a recompute/follow-up can hit it.
        Double-free raises a clear error instead of corrupting the pool."""
        self._drop(seq_id, register_tail=True, op="free")

    def release(self, seq_id) -> None:
        """Abort-path free: retire a sequence that may be MID-prefill,
        mid-decode, or mid-spec-verify.  Differences from ``free``:

        - the written partial tail page is NOT registered in the prefix
          cache — an aborted request's trailing positions are the ones
          the engine may have been about to overwrite, and an abort must
          never widen the cache's reachable content;
        - assertion-hardened for the shared-prefix case: a page this
          sequence shares with live neighbours must only DECREF — its
          chain-hash registrations stay exactly as they were (scrubbing
          them would make a hot system prompt vanish from the cache the
          moment one of its readers is cancelled), and the page itself
          must remain live for the surviving owners.

        Raises the same clear double-free/unknown errors as ``free``.
        """
        # snapshot shared pages + their registrations BEFORE the drop
        table = self._tables.get(seq_id, ())
        shared = {b: set(self._block_hashes.get(b, ()))
                  for b in table if self._ref.get(b, 0) > 1}
        self._drop(seq_id, register_tail=False, op="release")
        for b, hashes in shared.items():
            assert b in self._ref, (
                f"abort of {seq_id!r} killed shared page {b} "
                f"(refcount reached 0 with other owners alive)")
            assert self._block_hashes.get(b, set()) == hashes, (
                f"abort of {seq_id!r} scrubbed live chain hashes on "
                f"shared page {b}")
            for h in hashes:
                assert self._hash_to_block.get(h) == b, \
                    f"abort of {seq_id!r} redirected hash {h} off page {b}"

    def _drop(self, seq_id, *, register_tail: bool, op: str) -> None:
        if seq_id not in self._tables:
            if seq_id in self._freed:
                raise ValueError(
                    f"double {op}: sequence {seq_id!r} was already freed")
            raise ValueError(f"{op} of unknown sequence {seq_id!r}")
        table = self._tables.pop(seq_id)
        ids = self._ids.pop(seq_id, None)
        valid = self._valid.pop(seq_id, 0)
        chain = self._chain.pop(seq_id, [])
        self._tokens.pop(seq_id, None)
        self._version.pop(seq_id, None)
        if register_tail and self.enable_prefix_caching and ids is not None:
            bs = self.block_size
            p, k = valid // bs, valid % bs
            if k and len(chain) >= p:
                prev = chain[p - 1] if p else None
                self._register(table[p],
                               _page_hash(prev, ids[p * bs:p * bs + k]))
        self.free_count += len(table)
        for b in reversed(table):
            self._decref(b)
        self._freed.add(seq_id)

    def evict_parked(self, n: int) -> int:
        """Proactively evict up to ``n`` LRU parked (refcount-0 cached)
        pages — the degradation controller's tier-3 lever: trade future
        prefix-cache hits for immediate allocation headroom.  Counted
        separately from demand evictions (``eviction_count`` is
        _take_block's last-resort path).

        With a host spill tier attached (``spill_on_evict``) this is
        spill-first instead of kill: a registered page is quarantined in
        ``_spill_pending`` with its chain hashes — unregistered from the
        hash maps (it can no longer serve HBM hits) but NOT freed, since
        its device bytes must survive until the engine's step-boundary
        drain copies them into the host pool and calls
        ``take_spill_pending``.  Hashless pages free immediately either
        way.  Returns the number of pages evicted (spilled or freed)."""
        done = 0
        while done < int(n) and self._cached:
            blk, _ = self._cached.popitem(last=False)     # oldest first
            hashes = tuple(sorted(self._block_hashes.get(blk, ())))
            self._unregister(blk)
            if self.spill_on_evict and hashes:
                self._spill_pending[blk] = hashes
                self.spill_quarantined += 1
            else:
                self._free.append(blk)
            done += 1
        self.parked_evicted += done
        return done

    def take_spill_pending(self) -> list:
        """Engine step-boundary drain: pop every quarantined page as
        ``(block, chain_hashes)`` and return the blocks to the free
        list.  The CALLER must materialize the pages' device bytes
        host-side before issuing any new device write — freed blocks can
        be handed out again the same step.  Sorted for determinism."""
        if not self._spill_pending:
            return []
        out = sorted(self._spill_pending.items())
        self._spill_pending.clear()
        for blk, _ in out:
            self._free.append(blk)
        return out

    def adopt_restored(self, hashes):
        """Re-register one page restored from the host tier: claim a page
        from the FREE list only (a restore is opportunistic — it must
        never evict parked HBM content to make room), register it under
        every chain hash in ``hashes``, and park it refcount-0 in the
        cached LRU as most-recent, exactly as if a sequence had just
        retired it.  From here the normal content-addressed machinery —
        refcounted sharing, CoW, parking, eviction (or re-spill) — applies
        untouched.  Returns the block id, or None when no free page or no
        unclaimed hash is available (the caller keeps the host copy).

        The block is explicitly discarded from the fresh set: the caller
        restores the page's quantization scale rows along with its data
        (int8 mode), and the engine's fresh-mask scale reset would zero
        those freshly restored scales."""
        if not self._free:
            return None
        hashes = [h for h in hashes if h not in self._hash_to_block]
        if not hashes:
            return None
        blk = self._free.pop()
        self._fresh.discard(blk)
        for h in hashes:
            self._register(blk, h)
        self._cached[blk] = None          # park as most-recently-used
        self.spill_restored += 1
        return blk

    def has_hash(self, h) -> bool:
        """True when a chain hash is servable from the HBM prefix cache
        (live or parked) — the spill tier need not restore it."""
        return h in self._hash_to_block

    def chain_hashes(self, seq_id) -> list:
        """Chain hashes of seq_id's full hit/registered prefix pages, in
        order (prefetch-hit attribution reads these)."""
        return list(self._chain.get(seq_id, ()))

    def drain_fresh(self) -> list:
        """Pages handed out (via ``_take_block``) since the last drain,
        excluding CoW destinations (their content is a live copy).  The
        quantized engine calls this once per step and zeroes the returned
        pages' scale-pool rows before the step's writes commit; the
        float32 engine never needs it (stale page content is masked by
        ``kv_lens`` at read time, but a stale SCALE would rescale freshly
        written int8 values).  Sorted for determinism; clears the set."""
        out = sorted(self._fresh)
        self._fresh.clear()
        return out

    def has(self, seq_id) -> bool:
        return seq_id in self._tables

    # -- table export -------------------------------------------------------

    def block_table(self, seq_id) -> list:
        return list(self._tables[seq_id])

    def table_version(self, seq_id) -> int:
        """Bumped on every table mutation (grow / CoW swap) — lets the
        engine cache padded host rows and rebuild only on change."""
        return self._version[seq_id]

    def padded_table(self, seq_id, width: int) -> np.ndarray:
        """int32 [width] block table padded with the null page (the kernel
        clamps/never reads past `lengths`, and padded entries DMA the null
        page rather than a live one)."""
        table = self._tables[seq_id]
        if len(table) > width:
            raise ValueError(
                f"sequence {seq_id!r} holds {len(table)} pages > table "
                f"width {width}")
        out = np.full((width,), NULL_BLOCK, np.int32)
        out[:len(table)] = table
        return out

    # -- stats --------------------------------------------------------------

    def occupancy(self) -> float:
        """Fraction of the usable pool currently owned by sequences."""
        usable = self.num_blocks - 1
        return self.num_used / usable if usable else 0.0

    def fragmentation(self) -> float:
        """Internal fragmentation: fraction of allocated slots not backing
        a token (tail-of-last-page waste; paging trades this bounded waste
        for the dense [B, max_len] cache's unbounded padding waste)."""
        slots = self.num_used * self.block_size
        if slots == 0:
            return 0.0
        used_tokens = sum(min(self._tokens.get(s, 0),
                              len(t) * self.block_size)
                          for s, t in self._tables.items())
        return max(0.0, 1.0 - used_tokens / slots)

    def stats(self) -> dict:
        return {
            "num_blocks": self.num_blocks,
            "block_size": self.block_size,
            "used_blocks": self.num_used,
            "free_blocks": self.num_free,
            "cached_blocks": self.num_cached,
            "peak_used_blocks": self.peak_used,
            "occupancy": round(self.occupancy(), 4),
            "fragmentation": round(self.fragmentation(), 4),
            "alloc_count": self.alloc_count,
            "free_count": self.free_count,
            "prefix_caching": self.enable_prefix_caching,
            "cache_hit_tokens": self.cache_hit_tokens,
            "cache_miss_tokens": self.cache_miss_tokens,
            "cow_count": self.cow_count,
            "eviction_count": self.eviction_count,
            "parked_evicted": self.parked_evicted,
            "spill_pending": self.num_spill_pending,
            "spill_quarantined": self.spill_quarantined,
            "spill_restored": self.spill_restored,
        }

    # -- invariants (test surface) ------------------------------------------

    def check_invariants(self) -> None:
        """Raise AssertionError on any pool-accounting violation."""
        usable = self.num_blocks - 1
        free, cached, live = set(self._free), set(self._cached), \
            set(self._ref)
        spill = set(self._spill_pending)
        assert len(self._free) == len(free), "duplicate ids on free list"
        assert not (free & cached), "block both free and cached"
        assert not (free & live), "block both free and live"
        assert not (cached & live), "block both cached and live"
        assert not (spill & (free | cached | live)), \
            "spill-pending block also free/cached/live"
        assert len(free) + len(cached) + len(live) + len(spill) \
            == usable, (
            f"pool accounting broken: {len(free)} free + {len(cached)} "
            f"cached + {len(live)} live + {len(spill)} spill-pending "
            f"!= {usable}")
        assert NULL_BLOCK not in free | cached | live | spill, \
            "null page leaked"
        for blk in spill:
            assert blk not in self._block_hashes, \
                f"spill-pending block {blk} still registered"
        counts: dict = {}
        for seq, table in self._tables.items():
            assert len(table) == len(set(table)), \
                f"sequence {seq!r} holds a page twice"
            for b in table:
                counts[b] = counts.get(b, 0) + 1
        assert counts.keys() == live, "live set != union of tables"
        for b, n in counts.items():
            assert self._ref[b] == n, (
                f"block {b} refcount {self._ref[b]} != {n} table refs")
            assert self._ref[b] >= 1, f"block {b} refcount < 1"
        for h, b in self._hash_to_block.items():
            assert b in live or b in cached, \
                f"hash map points at free block {b}"
            assert h in self._block_hashes.get(b, ()), \
                f"hash map / block hash mismatch on {b}"


def _page_hash_chain(ids, n_pages, bs):
    """Chain hash after n_pages full pages of ids."""
    prev = None
    for p in range(n_pages):
        prev = _page_hash(prev, ids[p * bs:(p + 1) * bs])
    return prev


def prefix_chain_hashes(token_ids, block_size: int) -> list:
    """Chain hash of EVERY full page prefix of ``token_ids``, in order.

    ``result[i]`` identifies pages 0..i of the sequence — exactly the
    hashes ``BlockManager`` registers for a prompt's full pages, computed
    WITHOUT touching any pool.  The replica router uses this to predict
    which engine's prefix cache already holds a prompt's leading pages
    (frontend/router.py): two prompts share cached pages iff their chain
    hashes match, so matching hashes host-side is exactly the cache's own
    sharing criterion."""
    ids = [int(t) for t in token_ids]
    bs = int(block_size)
    out, prev = [], None
    for p in range(len(ids) // bs):
        prev = _page_hash(prev, ids[p * bs:(p + 1) * bs])
        out.append(prev)
    return out
