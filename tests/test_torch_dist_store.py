"""PyTorch port, distributed: the rendezvous store.  One script of
operations played on the JAX package's native TCPStore
(paddle_tpu/distributed/store.py over csrc/tcp_store.cc) and on the port's
(over ``torch.distributed.TCPStore``): values, counters, the errors on
timeouts and on a refused connection, and ``barrier_via_store`` across
generations with ranks as threads, all equal.  Every wait, join and
socket is bounded.

The JAX package builds its native core (``paddle_tpu/lib/libptcore.so``)
at first use, and under six pytest workers several can run ``make`` at
once: one then loads the library while another's compiler is still
writing it, fails, and marks the core unavailable for its whole life.
The ``jax_native_core`` fixture waits for the build and loads the core
before this file runs, and puts the module's state back after it."""
import fcntl
import socket
import threading
import time

import pytest

from paddle_tpu.distributed import store as jstore
from paddle_tpu_torch.distributed import store as pstore
from _torch_threads import torch_threads  # noqa: F401

STORE_TIMEOUT_S, SHORT_S, JOIN_TIMEOUT_S = 10.0, 0.2, 30
RANKS, GENERATIONS = 3, 3
NATIVE_WAIT_S, NATIVE_POLL_S = 60.0, 0.5


@pytest.fixture(scope="module", autouse=True)
def jax_native_core():
    """Loads the JAX package's native core, waiting up to NATIVE_WAIT_S
    for another worker's build to finish; fails (never skips) if it
    cannot.  Loads are serialised by an fcntl lock beside the library;
    the module's state is restored afterwards."""
    from paddle_tpu.core import _native as N
    saved = (N._lib, N._load_failed)
    N._LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
    lock_path = N._LIB_PATH.with_name(N._LIB_PATH.name + ".lock")
    deadline = time.monotonic() + NATIVE_WAIT_S
    with open(lock_path, "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            while N.load() is None:
                if time.monotonic() > deadline:
                    pytest.fail(
                        f"the JAX package's native core did not load "
                        f"within {NATIVE_WAIT_S:.0f} s from "
                        f"{N._LIB_PATH} (exists: {N._LIB_PATH.exists()})")
                time.sleep(NATIVE_POLL_S)
                N._load_failed = False
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    yield N.peek()
    N._lib, N._load_failed = saved


def _outcome(fn):
    """fn()'s value, or the name of the exception it raised."""
    try:
        return ("ok", fn())
    except Exception as e:                       # noqa: BLE001
        return ("raised", type(e).__name__)


def _script(mod):
    master = mod.TCPStore("127.0.0.1", 0, is_master=True,
                          timeout=STORE_TIMEOUT_S)
    client = mod.TCPStore("127.0.0.1", master.port, is_master=False,
                          timeout=STORE_TIMEOUT_S)
    log = [master.port > 0]
    client.set("k", "text")
    master.set("b", b"\x00\x01bytes")
    log += [client.get("k"), master.get("b"), client.get("b", timeout=1.0)]
    log += [client.add("n", 1), master.add("n", 5), client.add("n", 0),
            master.add("m", -2)]
    log.append(_outcome(lambda: client.wait(["k", "n"], timeout=1.0)))
    log.append(_outcome(lambda: client.wait("k")))
    log.append(_outcome(lambda: client.get("absent", timeout=SHORT_S)))
    log.append(_outcome(lambda: client.wait(["k", "absent"],
                                            timeout=SHORT_S)))
    client.delete_key("k")
    log.append(_outcome(lambda: master.get("k", timeout=SHORT_S)))
    log.append(_outcome(lambda: client.delete_key("never-set")))
    client.set("k", b"again")
    log.append(master.get("k"))
    return log


@pytest.mark.parametrize("mod", [jstore, pstore], ids=["jax", "port"])
def test_store_script_runs(mod):
    assert _script(mod)[0] is True


def test_store_script_matches_the_reference():
    assert _script(pstore) == _script(jstore)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_a_refused_connection_raises_the_references_error():
    port = _free_port()              # nothing listens there
    got = []
    for mod in (jstore, pstore):
        try:
            mod.TCPStore("127.0.0.1", port, is_master=False, timeout=1.0)
            got.append(None)
        except Exception as e:                   # noqa: BLE001
            got.append(type(e).__name__)
    assert got[0] == got[1] == "NativeError", got


def _barrier_log(mod):
    """RANKS threads, each with its own client, pass GENERATIONS barriers
    under one prefix; returns the barriers each passed, the arrival
    counter and which generations' release keys are set."""
    master = mod.TCPStore("127.0.0.1", 0, is_master=True,
                          timeout=STORE_TIMEOUT_S)
    out, errs = {}, {}

    def rank(r):
        try:
            st = mod.TCPStore("127.0.0.1", master.port, is_master=False,
                              timeout=STORE_TIMEOUT_S)
            for g in range(GENERATIONS):
                mod.barrier_via_store(st, "bar", r, RANKS,
                                      timeout=STORE_TIMEOUT_S)
                out[r] = g + 1
        except Exception as e:                   # noqa: BLE001
            errs[r] = repr(e)

    threads = [threading.Thread(target=rank, args=(r,), daemon=True)
               for r in range(RANKS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(JOIN_TIMEOUT_S)
    assert not any(t.is_alive() for t in threads), "a rank hung"
    assert not errs, errs
    releases = [_outcome(lambda g=g: master.wait(
        [f"bar/release/{g}"], timeout=SHORT_S))[0] == "ok"
        for g in range(GENERATIONS + 1)]
    return out, master.add("bar/count", 0), releases


def test_barrier_via_store_generations_match_the_reference():
    port = _barrier_log(pstore)
    assert port == _barrier_log(jstore)
    assert port[0] == {r: GENERATIONS for r in range(RANKS)}
    assert port[1] == RANKS * GENERATIONS
    # every generation released, the next not yet
    assert port[2] == [True] * GENERATIONS + [False]


def test_barrier_via_store_times_out_like_the_reference():
    got = []
    for mod in (jstore, pstore):
        master = mod.TCPStore("127.0.0.1", 0, is_master=True,
                              timeout=STORE_TIMEOUT_S)
        got.append(_outcome(lambda: mod.barrier_via_store(
            master, "lonely", 0, 2, timeout=SHORT_S)))
    assert got[0] == got[1] == ("raised", "TimeoutError"), got
