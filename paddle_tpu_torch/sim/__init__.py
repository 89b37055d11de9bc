"""Trace-driven fleet simulator: a seeded, deterministic discrete-event
model of the serving fleet.

The north star is serving millions of users, but CI runs on a shared
CPU — every fleet-level decision (router policy, admission threshold,
replica count, decode-window K) was an anecdote until this package: a
discrete-event simulator that replays or synthesizes request streams
through MODEL replicas at 1000x real scale, using the REAL policy code
wherever the decision is pure host Python and a calibrated cost model
wherever the decision is device work.

Layout::

    events.py     the event loop: virtual time, heap-ordered, seeded —
                  no wall clock anywhere (determinism is a hard
                  invariant, enforced by graft-lint's
                  ``nondeterministic-sim`` rule over this package)
    cost.py       ``CostModel``: per-step cost as a function of pack
                  shape, calibrated from a recorded trace by
                  ``tools/perf/step_timeline.py --fit``
    workload.py   request streams: replay a ``serve_bench
                  --dump-workload`` capture, or synthesize steady /
                  bursty / heavy-tailed / multi-tenant traces from
                  fitted distributions
    fleet.py      the model tiers: ``SimReplica`` (engine-step
                  granularity, real packing/pressure logic) and
                  ``SimFleet`` (router + admission over N replicas)
    validate.py   replay a recorded ``serve_bench --mixed`` run and
                  report predicted-vs-actual TTFT/ITL percentiles and
                  tok/s

What is REAL and what is MODELED is the load-bearing design decision;
see ``docs/simulation.md`` and the mapping table in ARCHITECTURE.md.
The short version: scheduling decisions (prefill packing, replica
choice, degradation tiers, decode-window slicing) run the same code the
live engine runs — imported from ``paddle_tpu_torch.inference.policy`` and
``paddle_tpu_torch.inference.pressure`` — while device step cost and
speculative token emission are fitted scalar models.
"""
from .cost import CostModel
from .events import EventLoop
from .fleet import FleetConfig, ReplicaConfig, SimFleet, SimReplica
from .validate import validate_record
from .workload import SimRequest, replay_workload, synthesize_workload

__all__ = [
    "CostModel", "EventLoop", "FleetConfig", "ReplicaConfig",
    "SimFleet", "SimReplica", "SimRequest", "replay_workload",
    "synthesize_workload", "validate_record",
]
