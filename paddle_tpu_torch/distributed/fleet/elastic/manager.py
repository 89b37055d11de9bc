"""TCPStore-backed elastic membership manager (counterpart of
paddle_tpu/distributed/fleet/elastic/manager.py, over the port's store).

Paddle's ElasticManager keeps an etcd node registry with lease-kept-alive
heartbeats and a watch that flags a membership change for the launcher's
relaunch loop.  Here the same protocol runs over the TCPStore:
- every node sets  elastic/<job>/node/<host_id> = <monotonic heartbeat>
  every ``heartbeat_interval`` seconds;
- liveness = heartbeat age < ``lease_ttl`` (store entries cannot expire
  server-side like etcd leases, so expiry is evaluated by readers);
- the watch thread re-lists membership and compares against the expected
  node set; under-provisioned -> WAIT, over/changed -> NEED_LAUNCH, within
  the elastic range and stable -> OK.
"""
from __future__ import annotations

import threading
import time

__all__ = ["ElasticManager", "ElasticStatus"]


class ElasticStatus:
    OK = "ok"                # membership matches; keep training
    WAIT = "wait"            # below np_lo: hold for nodes
    NEED_LAUNCH = "relaunch"  # membership changed within range: restart job
    ERROR = "error"          # above np_hi or unrecoverable
    EXIT = "exit"            # shutdown requested


def _parse_np(np_range) -> tuple[int, int]:
    """'2' -> (2,2); '2:4' -> (2,4) (the launch --nnodes contract)."""
    s = str(np_range)
    if ":" in s:
        lo, hi = s.split(":", 1)
        return int(lo), int(hi)
    return int(s), int(s)


class ElasticManager:
    def __init__(self, store, job_id: str, host_id: str, np_range="1",
                 heartbeat_interval: float = 2.0, lease_ttl: float = 10.0):
        self.store = store
        self.job_id = job_id
        self.host_id = host_id
        self.np_lo, self.np_hi = _parse_np(np_range)
        self.heartbeat_interval = heartbeat_interval
        self.lease_ttl = lease_ttl
        self.elastic = self.np_lo != self.np_hi
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._status = ElasticStatus.WAIT
        self._members: list[str] = []
        self._threads: list[threading.Thread] = []

    # --- registry -------------------------------------------------------

    def _key(self, host):
        return f"elastic/{self.job_id}/node/{host}"

    def _nreg_key(self):
        return f"elastic/{self.job_id}/nreg"

    def _slot_key(self, idx):
        return f"elastic/{self.job_id}/reg/{idx}"

    def register(self):
        """Join the registry and start heartbeat + watch threads.

        Registration is race-free: each node atomically claims a slot index
        via the store's add counter and writes only its own slot key —
        concurrent joins cannot clobber each other the way a shared
        read-modify-write hosts list would.
        """
        self._slot = self.store.add(self._nreg_key(), 1)
        self.store.set(self._slot_key(self._slot), self.host_id)
        self._beat()
        for fn in (self._heartbeat_loop, self._watch_loop):
            t = threading.Thread(target=fn, daemon=True,
                                 name=f"elastic-{fn.__name__}")
            t.start()
            self._threads.append(t)

    def _beat(self):
        self.store.set(self._key(self.host_id), repr(time.time()))

    def _list_registered(self):
        try:
            n = self.store.add(self._nreg_key(), 0)
        except Exception:
            return []
        out = []
        for i in range(1, int(n) + 1):
            try:
                h = self.store.get(self._slot_key(i), timeout=0.5).decode()
            except Exception:
                continue
            if h and h not in out:
                out.append(h)
        return out

    def alive_nodes(self) -> list[str]:
        now = time.time()
        out = []
        for h in self._list_registered():
            try:
                beat = float(self.store.get(self._key(h), timeout=0.5))
            except Exception:
                continue
            if now - beat < self.lease_ttl:
                out.append(h)
        return out

    # --- threads --------------------------------------------------------

    def _heartbeat_loop(self):
        while not self._stop.is_set():
            try:
                self._beat()
            except Exception:
                pass
            self._stop.wait(self.heartbeat_interval)

    def _watch_loop(self):
        prev = None
        while not self._stop.is_set():
            try:
                cur = sorted(self.alive_nodes())
            except Exception:
                cur = []
            with self._lock:
                self._members = cur
                n = len(cur)
                # NEED_LAUNCH latches until consume_relaunch() reads it —
                # a controller polling slower than the heartbeat must not
                # lose the signal (consumed, not recomputed per watch
                # tick)
                latched = self._status in (ElasticStatus.NEED_LAUNCH,
                                           ElasticStatus.EXIT)
                if n < self.np_lo:
                    if not latched:
                        self._status = ElasticStatus.WAIT
                elif n > self.np_hi:
                    self._status = ElasticStatus.ERROR
                elif prev is not None and cur != prev \
                        and self._status != ElasticStatus.EXIT:
                    # in-range membership change: job must relaunch on the
                    # new node set
                    self._status = ElasticStatus.NEED_LAUNCH
                elif not latched:
                    self._status = ElasticStatus.OK
            prev = cur
            self._stop.wait(self.heartbeat_interval)

    # --- controller API (consumed by the launch relaunch loop) ---------

    def status(self) -> str:
        with self._lock:
            return self._status

    def members(self) -> list[str]:
        with self._lock:
            return list(self._members)

    def wait_ready(self, timeout: float = 60.0) -> bool:
        """Block until membership reaches the elastic range."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            if len(self.alive_nodes()) >= self.np_lo:
                return True
            time.sleep(self.heartbeat_interval / 2)
        return False

    def consume_relaunch(self) -> bool:
        """True once per membership change (controller restarts the job)."""
        with self._lock:
            if self._status == ElasticStatus.NEED_LAUNCH:
                self._status = ElasticStatus.OK
                return True
            return False

    def exit(self):
        with self._lock:
            self._status = ElasticStatus.EXIT
        self._stop.set()
        # drop this node from the registry so peers see the leave quickly
        try:
            if getattr(self, "_slot", None) is not None:
                self.store.set(self._slot_key(self._slot), "")
            self.store.set(self._key(self.host_id), repr(0.0))
        except Exception:
            pass
        for t in self._threads:
            t.join(timeout=2.0)
