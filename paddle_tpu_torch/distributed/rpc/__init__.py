"""Distributed RPC (counterpart of paddle_tpu/distributed/rpc):
init_rpc / rpc_sync / rpc_async / shutdown / worker infos.

The control plane stays on the host.  Rendezvous rides the port's
TCPStore (the same store the launcher and the process groups use); each
worker runs a threaded socket server executing pickled callables;
``rpc_async`` returns a ``concurrent.futures.Future`` with Paddle's
``wait()``.  Length-prefixed pickle frames between cooperating trainer
processes.

Trust model: RPC peers are the job's own trainers (deserializing a frame
executes arbitrary code, as Paddle's pickled python UDFs do) — never
expose the port beyond the training cluster.
"""
from __future__ import annotations

import os
import pickle
import socket
import struct
import threading
from collections import namedtuple
from concurrent.futures import ThreadPoolExecutor

from ..store import TCPStore, barrier_via_store

__all__ = ["init_rpc", "rpc_sync", "rpc_async", "shutdown",
           "get_worker_info", "get_all_worker_infos",
           "get_current_worker_info", "WorkerInfo"]

WorkerInfo = namedtuple("WorkerInfo", ["name", "rank", "ip", "port"])

_state = threading.local()          # not process-global: tests reinit freely


class _Agent:
    def __init__(self, self_info, infos, store, world_size):
        self.self_info = self_info
        self.infos = infos           # name -> WorkerInfo
        self.store = store
        self.world_size = world_size
        self.server = None
        self.pool = ThreadPoolExecutor(max_workers=8,
                                       thread_name_prefix="rpc-client")
        self.stop = threading.Event()


_agent: _Agent | None = None


def _recv_exact(conn, n):
    buf = b""
    while len(buf) < n:
        chunk = conn.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("rpc peer closed")
        buf += chunk
    return buf


def _send_frame(conn, obj):
    data = pickle.dumps(obj, protocol=4)
    conn.sendall(struct.pack("<Q", len(data)) + data)


def _recv_frame(conn):
    (n,) = struct.unpack("<Q", _recv_exact(conn, 8))
    return pickle.loads(_recv_exact(conn, n))


def _serve(agent: _Agent, sock: socket.socket):
    exec_pool = ThreadPoolExecutor(max_workers=8,
                                   thread_name_prefix="rpc-server")

    def handle(conn):
        try:
            with conn:
                fn, args, kwargs = _recv_frame(conn)
                try:
                    _send_frame(conn, ("ok", fn(*args, **kwargs)))
                except Exception as e:       # ship the failure to the caller
                    _send_frame(conn, ("err", e))
        except Exception:
            pass                             # peer went away mid-call

    sock.settimeout(0.2)
    while not agent.stop.is_set():
        try:
            conn, _ = sock.accept()
        except socket.timeout:
            continue
        except OSError:
            break
        exec_pool.submit(handle, conn)
    exec_pool.shutdown(wait=False)


def init_rpc(name, rank=None, world_size=None, master_endpoint=None):
    """Start this worker's RPC agent and rendezvous with the others."""
    global _agent
    if _agent is not None:
        raise RuntimeError("RPC already initialized; call shutdown() first")
    rank = int(os.environ["PADDLE_TRAINER_ID"]) if rank is None else rank
    world_size = int(os.environ["PADDLE_TRAINERS_NUM"]) \
        if world_size is None else world_size
    master_endpoint = master_endpoint or \
        os.environ.get("PADDLE_MASTER_ENDPOINT") or \
        os.environ.get("PADDLE_MASTER", "127.0.0.1:0")
    host, port = master_endpoint.rsplit(":", 1)
    store = TCPStore(host, int(port), is_master=(rank == 0),
                     timeout=float(os.environ.get("FLAGS_stop_check_timeout",
                                                  "900")))

    # bind the service socket on all interfaces, advertise a ROUTABLE
    # address (multi-host peers must be able to dial it): prefer the
    # launch env's endpoint host, else this host's resolved address.
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(("0.0.0.0", 0))
    srv.listen(128)
    my_port = srv.getsockname()[1]
    ip = os.environ.get("PADDLE_CURRENT_ENDPOINT", "").rsplit(":", 1)[0]
    if not ip:
        try:
            ip = socket.gethostbyname(socket.gethostname())
        except OSError:
            ip = "127.0.0.1"

    self_info = WorkerInfo(name, rank, ip, my_port)
    store.set(f"rpc/worker/{rank}",
              pickle.dumps((name, rank, ip, my_port), protocol=4))
    store.wait([f"rpc/worker/{r}" for r in range(world_size)])
    infos = {}
    for r in range(world_size):
        w = WorkerInfo(*pickle.loads(store.get(f"rpc/worker/{r}")))
        infos[w.name] = w

    _agent = _Agent(self_info, infos, store, world_size)
    _agent.server = threading.Thread(target=_serve, args=(_agent, srv),
                                     daemon=True, name="rpc-server")
    _agent.server.start()
    # all workers serving before anyone calls out
    barrier_via_store(store, "rpc/init", rank, world_size)


def _require_agent() -> _Agent:
    if _agent is None:
        raise RuntimeError("call init_rpc() first")
    return _agent


def _invoke(to, fn, args, kwargs, timeout):
    agent = _require_agent()
    try:
        info = agent.infos[to]
    except KeyError:
        raise ValueError(f"unknown RPC worker {to!r}; known: "
                         f"{sorted(agent.infos)}") from None
    with socket.create_connection((info.ip, info.port),
                                  timeout=timeout if timeout and timeout > 0
                                  else None) as conn:
        _send_frame(conn, (fn, args or (), kwargs or {}))
        status, payload = _recv_frame(conn)
    if status == "err":
        raise payload
    return payload


def rpc_sync(to, fn, args=None, kwargs=None, timeout=-1):
    """Blocking remote call; returns fn's result."""
    return _invoke(to, fn, args, kwargs, timeout)


def rpc_async(to, fn, args=None, kwargs=None, timeout=-1):
    """Non-blocking remote call; returns a Future with .wait()/.result()."""
    agent = _require_agent()
    fut = agent.pool.submit(_invoke, to, fn, args, kwargs, timeout)
    fut.wait = fut.result            # Paddle's future spells it wait()
    return fut


def get_worker_info(name):
    return _require_agent().infos[name]


def get_all_worker_infos():
    return sorted(_require_agent().infos.values(), key=lambda w: w.rank)


def get_current_worker_info():
    return _require_agent().self_info


def shutdown():
    """Barrier, then stop serving."""
    global _agent
    if _agent is None:
        return
    agent = _agent
    barrier_via_store(agent.store, "rpc/shutdown", agent.self_info.rank,
                      agent.world_size)
    agent.stop.set()
    agent.pool.shutdown(wait=False)
    if agent.server is not None:
        agent.server.join(timeout=2.0)
    _agent = None
