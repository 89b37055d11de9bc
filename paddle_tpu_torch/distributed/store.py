"""Rendezvous store (counterpart of paddle_tpu/distributed/store.py).

A key-value store with a master daemon on rank 0, used for control-plane
rendezvous: the launcher's multi-node endpoints and restarts, host
barriers, elastic membership, rpc, and the process groups of
``init_parallel_env`` and the hybrid trainer (each through a
``torch.distributed.PrefixStore`` over ``TCPStore.torch_store``).

The reference's store is its own native C++ (csrc/tcp_store.cc), since
JAX has none.  This one wraps ``torch.distributed.TCPStore`` in the
reference's interface and errors:

- ``get(key, timeout)`` waits up to timeout for a missing key (torch's
  blocks for the store's whole timeout) and raises ``TimeoutError``, as
  ``wait`` does;
- a master at port 0 binds a free port, read back from ``port``;
- a client that cannot connect raises ``NativeError``; ``delete_key`` of a
  missing key does nothing.
"""
from __future__ import annotations

import datetime
import os

import torch.distributed as dist

__all__ = ["TCPStore", "create_default_store", "barrier_via_store"]

_default_store = None


class NativeError(RuntimeError):
    """The store failed (the reference's native core error)."""


def _td(seconds) -> datetime.timedelta:
    return datetime.timedelta(seconds=float(seconds))


class TCPStore:
    """Rendezvous KV store.  Rank 0 (``is_master=True``) hosts the master
    daemon in-process; every rank (including 0) connects a client to it."""

    def __init__(self, host: str, port: int, is_master: bool = False,
                 world_size: int | None = None, timeout: float = 90.0):
        self.host = host
        self.timeout = timeout
        try:
            self._store = dist.TCPStore(host, int(port), world_size,
                                        is_master=is_master,
                                        timeout=_td(timeout),
                                        wait_for_workers=False)
        except (RuntimeError, ValueError) as e:
            what = "master failed to bind" if is_master else \
                "could not connect to"
            raise NativeError(f"TCPStore {what} {host}:{port}: {e}") from None
        self.port = int(self._store.port)

    @property
    def torch_store(self):
        """The ``torch.distributed.Store`` under this one (process groups
        are built over it)."""
        return self._store

    def _wait(self, keys, timeout, what):
        timeout = self.timeout if timeout is None else timeout
        if timeout <= 0:                 # torch reads 0 as "no timeout"
            if not self._store.check(list(keys)):
                raise TimeoutError(f"store {what} timed out")
            return
        try:
            self._store.wait(list(keys), _td(timeout))
        except dist.DistStoreError as e:
            if "timeout" in str(e).lower():
                raise TimeoutError(f"store {what} timed out") from None
            raise NativeError(f"store {what} failed: {e}") from None

    def set(self, key: str, value):
        if isinstance(value, str):
            value = value.encode()
        self._store.set(key, bytes(value))

    def get(self, key: str, timeout: float | None = None) -> bytes:
        self._wait([key], timeout, f"get({key})")
        return bytes(self._store.get(key))

    def add(self, key: str, amount: int = 1) -> int:
        return int(self._store.add(key, int(amount)))

    def wait(self, keys, timeout: float | None = None):
        if isinstance(keys, str):
            keys = [keys]
        for key in keys:
            self._wait([key], timeout, f"wait({key})")

    def check(self, keys) -> bool:
        """Whether every key is set, without waiting."""
        if isinstance(keys, str):
            keys = [keys]
        return bool(self._store.check(list(keys)))

    def delete_key(self, key: str):
        self._store.delete_key(key)

    def close(self):
        """Drop this client (and, on the master, the daemon once no process
        group holds the store any more)."""
        self._store = None


def create_default_store(timeout: float = 90.0):
    """The process-wide store from the launch env contract
    (MASTER_ADDR / MASTER_PORT and PADDLE_TRAINER_ID; rank 0 hosts it)."""
    global _default_store
    if _default_store is not None:
        return _default_store
    host = os.environ.get("MASTER_ADDR", "127.0.0.1")
    port = int(os.environ.get("MASTER_PORT", "0") or 0)
    rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
    _default_store = TCPStore(host, port, is_master=(rank == 0),
                              timeout=timeout)
    return _default_store


def barrier_via_store(store: TCPStore, prefix: str, rank: int,
                      world_size: int, timeout: float = 90.0):
    """Store-based host barrier: every rank bumps a counter, then waits for
    the release key written when all arrived.

    Reusable with the same prefix: the shared arrival counter derives a
    generation number, and each generation gets its own release key.
    """
    n = store.add(f"{prefix}/count", 1)
    gen = (n - 1) // world_size
    if n == (gen + 1) * world_size:
        store.set(f"{prefix}/release/{gen}", b"1")
    store.wait([f"{prefix}/release/{gen}"], timeout=timeout)
