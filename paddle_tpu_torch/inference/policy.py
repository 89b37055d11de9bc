"""Pure host-side serving policies, shared by the engine and the fleet
simulator.

The fleet simulator (``paddle_tpu_torch/sim``) models the serving tiers as a
discrete-event system, but the DECISIONS those tiers make — which
prefill chunks a step packs, which replica a request lands on, how many
host round trips a decode window costs — are plain host Python with no
device state.  Duplicating them in the simulator would let the model
drift from the engine; instead the decision cores live here, stdlib
only, and BOTH sides call them:

    pack_prefill_chunks     the FCFS token-budget chunking rule
                            ``LLMEngine._schedule_prefill_chunks`` packs
                            a step with (serving.py calls it with the
                            CoW-resolution hook; the simulator calls it
                            with a pool-capacity hook)
    pick_replica            the routing decision inside
                            ``ReplicaRouter._pick`` (affinity / least /
                            random), lifted out so the simulator routes
                            synthetic fleets with the SAME tie-breaks
    window_chunks           the decode-window launch plan: how a K-step
                            window slices a row's remaining budget into
                            launches, i.e. the host-round-trip
                            accounting ``serve_bench --decode-window``
                            measures

Everything here is deterministic given its inputs; any randomness comes
in through a caller-owned ``random.Random`` (the random routing policy),
never from module state.
"""
from __future__ import annotations

__all__ = ["pack_prefill_chunks", "pick_replica", "window_chunks"]


def pack_prefill_chunks(candidates, budget: int, admit=None, out=None):
    """FCFS prefill-chunk packing under a per-step token budget.

    ``candidates``: (key, remaining_tokens) pairs already in FCFS
    (arrival) order.  ``admit``: optional predicate called just before a
    candidate takes budget; returning False skips it WITHOUT consuming
    budget (the engine hangs copy-on-write resolution here — a CoW
    preemption may also retroactively remove an earlier chunk from
    ``out``, which is why the accumulator is caller-visible).  ``out``:
    the list chunks are appended to (default: a fresh list).

    Returns ``out`` holding (key, chunk_len) pairs with
    ``sum(chunk_len) <= budget``: each candidate takes
    ``min(remaining, budget_left)`` — a long prompt takes whatever
    budget is left and resumes next step, so one 4096-token prompt
    never stalls running decodes.
    """
    chunks = out if out is not None else []
    budget = int(budget)
    for key, rem in candidates:
        if budget <= 0:
            break
        if rem <= 0:
            continue
        if admit is not None and not admit(key):
            continue
        take = min(int(rem), budget)
        chunks.append((key, take))
        budget -= take
    return chunks


def pick_replica(policy: str, hashes, registries, outstanding, rng=None):
    """One routing decision: ``(replica_index, was_affinity_hit)``.

    ``hashes``: the prompt's leading page chain hashes (empty disables
    affinity matching).  ``registries``: per-replica containers
    supporting ``in`` over those hashes.  ``outstanding``: per-replica
    outstanding-token loads.  ``rng``: a caller-seeded random.Random,
    consulted only by the "random" policy.

    Policy semantics (the ``ReplicaRouter`` contract, bit for bit):

    * random — uniform choice from ``rng``.
    * affinity — the replica matching the LONGEST leading run of page
      hashes wins; equal runs > 0 break to the lower outstanding load;
      no match anywhere falls through to least.
    * least — lowest outstanding-token load, ties to the LOWEST index
      (``min`` is stable), so a drained fleet fills deterministically.
    """
    n = len(outstanding)
    if policy == "random":
        return rng.randrange(n), False
    if policy == "affinity" and hashes:
        best, best_run = None, 0
        for i in range(n):
            reg = registries[i]
            run = 0
            for h in hashes:              # leading run: prefix pages chain
                if h not in reg:
                    break
                run += 1
            if run > best_run or (run == best_run and run > 0
                                  and outstanding[i] < outstanding[best]):
                best, best_run = i, run
        if best_run > 0:
            return best, True
    # least-outstanding-tokens; ties -> lowest index (min is stable)
    return min(range(n), key=lambda i: outstanding[i]), False


def window_chunks(remaining: int, k: int):
    """Decode-window launch plan for one row with ``remaining`` budget
    tokens left: the sequence of per-launch window lengths the engine's
    ``min(K, budget_left)`` reservation rule produces.  ``len(result)``
    is the row's host-round-trip count — the accounting behind
    ``decode_window_host_round_trips_per_token`` falling from ~1.0
    toward ~1/K when the window engages."""
    remaining = int(remaining)
    k = max(1, int(k))
    out = []
    while remaining > 0:
        take = min(k, remaining)
        out.append(take)
        remaining -= take
    return out
