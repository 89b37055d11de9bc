"""Process launcher with elastic restarts (counterpart of
paddle_tpu/distributed/launch/main.py).

Usage (the reference's CLI):
    python -m paddle_tpu_torch.distributed.launch \
        --nproc_per_node 4 --log_dir log train.py --arg1 ...

One process a rank, each with:
  - the env contract: PADDLE_TRAINER_ID, PADDLE_TRAINERS_NUM,
    PADDLE_CURRENT_ENDPOINT, PADDLE_TRAINER_ENDPOINTS, PADDLE_MASTER,
    PADDLE_LOCAL_RANK, PADDLE_NNODES, PADDLE_NODE_RANK, and
    FLAGS_selected_gpus (its card: the local rank, or its entry of
    --devices), which ``init_parallel_env`` reads;
  - its log file under --log_dir (workerlog.<local rank>).
On a worker's failure the launcher kills the others and, while
--max_restart is not exhausted (elastic level >= 1, or an --nnodes
range), relaunches the whole job; otherwise it returns the failed
worker's exit code.  Nodes of a multi-node job meet through the port's
TCPStore at --master.
"""
from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import time

__all__ = ["launch", "main"]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="paddle_tpu_torch.distributed.launch",
        description="launch a collective job (reference launch/main.py)")
    p.add_argument("--master", default=None,
                   help="master endpoint ip:port (default: local auto)")
    p.add_argument("--host", default=None,
                   help="routable address this node advertises to peers "
                        "(default: auto-detected from the route to "
                        "--master; loopback single-node)")
    p.add_argument("--rank", type=int, default=0, help="node rank")
    p.add_argument("--nnodes", default="1",
                   help="node count, or elastic range 'lo:hi'")
    p.add_argument("--nproc_per_node", type=int, default=None)
    p.add_argument("--log_dir", default="log")
    p.add_argument("--run_mode", default="collective")
    p.add_argument("--job_id", default="default")
    p.add_argument("--devices", "--gpus", default=None,
                   help="device ids for this node")
    p.add_argument("--ips", default=None, help="legacy node ip list")
    p.add_argument("--elastic_level", type=int, default=-1)
    p.add_argument("--max_restart", type=int, default=3)
    p.add_argument("--auto_tuner_json", default=None,
                   help="hybrid-parallel auto-tuner config (not ported: "
                        "ROADMAP item 14b)")
    p.add_argument("training_script")
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def _worker_env(local_rank, global_rank, world, endpoints, master, nnodes,
                node_rank, device_ids=None):
    env = dict(os.environ)
    dev = device_ids[local_rank] if device_ids else str(local_rank)
    env.update({
        "PADDLE_TRAINER_ID": str(global_rank),
        "PADDLE_LOCAL_RANK": str(local_rank),
        "PADDLE_TRAINERS_NUM": str(world),
        "PADDLE_CURRENT_ENDPOINT": endpoints[global_rank],
        "PADDLE_TRAINER_ENDPOINTS": ",".join(endpoints),
        "PADDLE_MASTER": master,
        "PADDLE_NNODES": str(nnodes),
        "PADDLE_NODE_RANK": str(node_rank),
        "FLAGS_selected_gpus": dev,
    })
    return env


def _advertise_host(args):
    """The address peers can reach this node's workers on: --host, else the
    local address of the route to --master, else loopback."""
    if args.host:
        return args.host
    mhost = args.master.split(":")[0]
    if mhost in ("127.0.0.1", "localhost"):
        return "127.0.0.1"
    try:
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            s.connect((mhost, 1))
            return s.getsockname()[0]
    except OSError:
        return "127.0.0.1"


def _open_rendezvous_store(args, node_rank):
    """One TCPStore for the whole job (node 0 hosts it); reused across
    elastic restart generations."""
    from ..store import TCPStore

    host, port = args.master.split(":")
    return TCPStore(host, int(port), is_master=(node_rank == 0),
                    timeout=120.0)


def _rendezvous_endpoints(store, gen, n_min, node_rank, adv_host,
                          local_ports):
    """Multi-node rendezvous: every node registers its worker endpoints
    under the current restart generation; returns the global ordered
    endpoint list."""
    mine = ",".join(f"{adv_host}:{p}" for p in local_ports)
    store.set(f"g{gen}/node/{node_rank}/endpoints", mine.encode())
    eps = []
    for n in range(n_min):
        store.wait([f"g{gen}/node/{n}/endpoints"], timeout=120.0)
        val = store.get(f"g{gen}/node/{n}/endpoints")
        eps.extend(val.decode().split(","))
    return eps


def _spawn(args, nprocs, store=None, gen=0):
    os.makedirs(args.log_dir, exist_ok=True)
    ports = [_free_port() for _ in range(nprocs)]
    device_ids = ([d.strip() for d in args.devices.split(",")]
                  if args.devices else None)
    nnodes = int(str(args.nnodes).split(":")[0])
    node_rank = args.rank
    if nnodes > 1:
        endpoints = _rendezvous_endpoints(store, gen, nnodes, node_rank,
                                          _advertise_host(args), ports)
        master = args.master
        world = nnodes * nprocs
    else:
        endpoints = [f"127.0.0.1:{p}" for p in ports]
        master = args.master or f"127.0.0.1:{ports[0]}"
        world = nprocs
    procs = []
    logs = []
    for rank in range(nprocs):
        grank = node_rank * nprocs + rank
        env = _worker_env(rank, grank, world, endpoints, master,
                          nnodes, node_rank, device_ids)
        cmd = [sys.executable, "-u", args.training_script,
               *args.training_script_args]
        logf = open(os.path.join(args.log_dir,
                                 f"workerlog.{rank}"), "ab", buffering=0)
        logs.append(logf)
        procs.append(subprocess.Popen(
            cmd, env=env, stdout=logf, stderr=subprocess.STDOUT))
    return procs, logs


def _kill_all(procs):
    for q in procs:
        if q.poll() is None:
            q.send_signal(signal.SIGTERM)
    deadline = time.time() + 10
    for q in procs:
        try:
            q.wait(timeout=max(0.1, deadline - time.time()))
        except subprocess.TimeoutExpired:
            q.kill()


PEER_ABORT = 250


def _store_has(store, key):
    try:
        return store.check([key])
    except Exception:
        return False


def _wait(procs, store=None, gen=0):
    """Wait for all workers; on any nonzero exit, kill the rest and return
    that code.  Returns 0 when every worker succeeds.

    Multi-node (store given): a failing node broadcasts an abort key for
    this restart generation so EVERY node's launcher tears down and
    re-enters rendezvous together."""
    last_peer_check = 0.0
    while True:
        alive = False
        for p in procs:
            rc = p.poll()
            if rc is None:
                alive = True
            elif rc != 0:
                if store is not None:
                    try:
                        store.set(f"g{gen}/abort", b"1")
                    except Exception:
                        pass
                _kill_all(procs)
                return rc
        if store is not None and time.time() - last_peer_check > 1.0:
            last_peer_check = time.time()
            if _store_has(store, f"g{gen}/abort"):
                _kill_all(procs)
                return PEER_ABORT
        if not alive:
            return 0
        time.sleep(0.2)


def _run_auto_tuner(args):
    """The reference scores candidate configs by AOT-compiling JAX programs
    on virtual devices (auto_tuner/tuner.py measure_cfg); the port's
    tuner needs a design of its own."""
    raise NotImplementedError(
        "--auto_tuner_json: the hybrid-parallel auto-tuner is not ported "
        "yet (ROADMAP Queue 1 item 14b)")


def launch(argv=None) -> int:
    args = _parse_args(argv)
    if args.auto_tuner_json:
        _run_auto_tuner(args)
    nprocs = args.nproc_per_node
    if nprocs is None:
        devs = args.devices
        nprocs = len(devs.split(",")) if devs else 1
    elastic = args.elastic_level >= 1 or ":" in str(args.nnodes)
    nnodes = int(str(args.nnodes).split(":")[0])
    store = None
    if nnodes > 1:
        if not args.master:
            raise SystemExit("--master ip:port is required for nnodes > 1")
        if args.rank >= nnodes:
            raise SystemExit(
                f"--rank {args.rank} >= nnodes minimum {nnodes}: standby "
                "nodes beyond the minimum world are not part of the static "
                "rendezvous; start them after a membership change")
        store = _open_rendezvous_store(args, args.rank)
    restarts = 0
    gen = 0
    while True:
        procs, logs = _spawn(args, nprocs, store, gen)
        rc = _wait(procs, store, gen)
        for f in logs:
            f.close()
        if rc == 0:
            # multi-node: success only when EVERY node finished this
            # generation (a peer may still abort and force a joint restart)
            if store is not None:
                try:
                    store.add(f"g{gen}/done", 1)
                    while True:
                        done = int(store.add(f"g{gen}/done", 0))
                        if done >= nnodes:
                            break
                        if _store_has(store, f"g{gen}/abort"):
                            rc = PEER_ABORT
                            break
                        time.sleep(0.5)
                except Exception:
                    # store master (node 0) gone: it only exits cleanly
                    # after all dones, or non-zero after broadcasting an
                    # abort we would have seen — treat closure as success
                    pass
                if rc == 0 and args.rank == 0:
                    time.sleep(1.0)   # grace: let peers read the final state
            if rc == 0:
                return 0
        if elastic and restarts < args.max_restart:
            restarts += 1
            gen += 1
            print(f"[launch] workers failed (exit {rc}); restart "
                  f"{restarts}/{args.max_restart}", file=sys.stderr)
            continue
        return rc


def main():
    sys.exit(launch())


if __name__ == "__main__":
    main()
