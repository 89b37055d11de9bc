"""Hierarchical KV: a host-DRAM spill tier below the HBM page pool.

Today KV pressure ends in death: when the ``DegradationController``
escalates to EVICT_PARKED, refcount-0 cached pages are destroyed and a
returning user re-prefills from scratch even though their prefix was
resident seconds ago.  The ``HostSpillPool`` is the tier below HBM
that the ROADMAP names as the path to millions-of-users KV residency
per chip: evicted parked pages spill here instead of dying, keyed by
the same rolling chain hashes the prefix cache and the affinity router
already speak, and admission restores them HBM-side so only the
residual prefill suffix is ever recomputed.

The pool is deliberately dumb about dtypes and layouts: a spilled page
is a named dict of host arrays (the engine's are CPU tensors: ``kc``/``vc``
for float pages, plus their f32 ``ks``/``vs`` scale rows for int8 pages)
and the pool only sums ``nbytes``.  That keeps the tier correct by
construction for every KV dtype the engine grows — restored bytes are
the exact bytes that were spilled, which is what pins the serve_bench
A/B byte-identical.

Concurrency: one lock guards the whole pool.  ``insert`` / ``take`` /
``lookup`` run on the engine thread at step boundaries, so their
acquire is uncontended in the common case; ``hint`` is called by the
frontend router at pick time and ``stats`` by whichever thread renders
``/metrics`` — those are the crossings the lock is actually for.
"""
from __future__ import annotations

import threading
from collections import OrderedDict, deque

__all__ = ["HostSpillPool"]


class HostSpillPool:
    """Bounded-byte, LRU, chain-hash-keyed host store of evicted KV pages.

    One entry per spilled HBM block.  A block can be registered under
    several chain hashes (``BlockManager._block_hashes`` is a set), so
    entries index every hash to one shared payload — the bytes are
    stored once.  ``capacity_bytes <= 0`` disables the tier (inserts
    become counted drops); that is also how a tier-off A/B arm is
    expressed without ripping out the plumbing.
    """

    def __init__(self, capacity_bytes: int, *, max_hints: int = 1024):
        self.capacity_bytes = int(capacity_bytes)
        self._lock = threading.Lock()
        self._entries: OrderedDict[int, dict] = OrderedDict()  # eid -> entry
        self._by_hash: dict[int, int] = {}                     # hash -> eid
        self._next_eid = 0
        self._bytes = 0
        # bumped on every successful insert: consumers that cache a
        # "nothing here for me" verdict (the engine's per-waiting-request
        # consult) re-check only when content actually arrived
        self._gen = 0
        # counters (read via stats())
        self.spilled_pages = 0        # successful inserts
        self.restored_pages = 0       # successful takes
        self.dropped_oversized = 0    # page bigger than the whole tier
        self.dropped_evicted = 0      # LRU-evicted to make room
        self.hits = 0                 # lookup/take found the hash
        self.misses = 0               # lookup/take missed
        # cross-thread prefetch hints (router -> engine)
        self._hints: deque[tuple[int, ...]] = deque(maxlen=int(max_hints))
        self.hints_received = 0
        self.hints_dropped = 0        # deque overflow (oldest displaced)

    # -- capacity ----------------------------------------------------------

    @property
    def bytes_resident(self) -> int:
        with self._lock:
            return self._bytes

    @property
    def gen(self) -> int:
        """Content generation: bumps on every successful insert."""
        with self._lock:
            return self._gen

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __contains__(self, h: int) -> bool:
        """Uncounted membership probe (for tests / prefetch planning)."""
        with self._lock:
            return h in self._by_hash

    # -- spill / restore (engine thread) ------------------------------------

    def insert(self, hashes, arrays: dict) -> bool:
        """Store one page under every hash in ``hashes``.

        Returns False (a counted drop) when the page alone exceeds the
        tier capacity; otherwise LRU-evicts resident entries until it
        fits.  A hash that is already resident is re-pointed at the new
        payload — the engine's copy is fresher by construction (it was
        live after the old spill).
        """
        hashes = tuple(int(h) for h in hashes)
        if not hashes:
            return False
        nbytes = int(sum(a.nbytes for a in arrays.values()))
        with self._lock:
            if self.capacity_bytes <= 0 or nbytes > self.capacity_bytes:
                self.dropped_oversized += 1
                return False
            for h in hashes:        # displace any stale entry for these keys
                eid = self._by_hash.get(h)
                if eid is not None:
                    self._drop_entry(eid, counted=False)
            while self._bytes + nbytes > self.capacity_bytes:
                old_eid, _ = next(iter(self._entries.items()))
                self._drop_entry(old_eid, counted=True)
            eid = self._next_eid
            self._next_eid += 1
            self._entries[eid] = {"hashes": hashes, "arrays": dict(arrays),
                                  "nbytes": nbytes}
            for h in hashes:
                self._by_hash[h] = eid
            self._bytes += nbytes
            self.spilled_pages += 1
            self._gen += 1
            return True

    def lookup(self, h: int) -> bool:
        """Counted residency probe — admission's tier consult on a
        prefix-cache miss.  Refreshes LRU recency on hit."""
        with self._lock:
            eid = self._by_hash.get(int(h))
            if eid is None:
                self.misses += 1
                return False
            self._entries.move_to_end(eid)
            self.hits += 1
            return True

    def take(self, h: int) -> dict | None:
        """Pop the page stored under ``h`` for an HBM restore.  Returns
        the entry (``hashes`` tuple + ``arrays`` dict) or None.  Not a
        counted consult — ``lookup`` is the hit/miss surface; ``take``
        only moves bytes.

        Take-not-copy: once restored the page is registered back in the
        HBM prefix cache, so a host copy would be a second, staler
        replica that could shadow future spills of the same chain.
        """
        with self._lock:
            eid = self._by_hash.get(int(h))
            if eid is None:
                return None
            entry = self._entries.pop(eid)
            for hh in entry["hashes"]:
                self._by_hash.pop(hh, None)
            self._bytes -= entry["nbytes"]
            self.restored_pages += 1
            return {"hashes": entry["hashes"], "arrays": entry["arrays"]}

    def _drop_entry(self, eid: int, *, counted: bool) -> None:  # guarded-by: _lock
        entry = self._entries.pop(eid)
        for h in entry["hashes"]:
            self._by_hash.pop(h, None)
        self._bytes -= entry["nbytes"]
        if counted:
            self.dropped_evicted += 1

    # -- prefetch hints (router thread -> engine thread) ---------------------

    def hint(self, hashes) -> None:
        """Queue a returning request's chain hashes for pre-staging.
        Thread-safe; called by the frontend router at pick time."""
        hashes = tuple(int(h) for h in hashes)
        if not hashes:
            return
        with self._lock:
            if len(self._hints) == self._hints.maxlen:
                self.hints_dropped += 1
            self._hints.append(hashes)
            self.hints_received += 1

    def drain_hints(self) -> list:
        """Engine thread: pop every queued hint (oldest first)."""
        with self._lock:
            if not self._hints:
                return []
            out = list(self._hints)
            self._hints.clear()
        return out

    # -- observability -------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            lookups = self.hits + self.misses
            return {
                "capacity_bytes": self.capacity_bytes,
                "bytes_resident": self._bytes,
                "entries": len(self._entries),
                "spilled_pages": self.spilled_pages,
                "restored_pages": self.restored_pages,
                "dropped_oversized": self.dropped_oversized,
                "dropped_evicted": self.dropped_evicted,
                "hits": self.hits,
                "misses": self.misses,
                "hit_rate": round(self.hits / lookups, 4) if lookups else 0.0,
                "hints_received": self.hints_received,
                "hints_dropped": self.hints_dropped,
            }
