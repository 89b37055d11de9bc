"""PyTorch port, page pool: a differential fuzz.  The same random sequence
of BlockManager operations goes through the JAX package's manager and the
port's copy; after every operation the results, block tables, chain
hashes, free/cached counts and ``stats()`` must agree and both pools must
pass ``check_invariants()``."""
import numpy as np
import pytest

from paddle_tpu.inference import kv_cache as jkv
from paddle_tpu_torch.inference import kv_cache as tkv
from _torch_threads import torch_threads  # noqa: F401


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except Exception as e:                    # compared across managers
        return ("raise", type(e).__name__, str(e))


def _state(bm, sids):
    return ({s: (bm.block_table(s), bm.chain_hashes(s),
                 bm.table_version(s)) for s in sids if bm.has(s)},
            bm.num_free, bm.num_cached, bm.num_used, bm.stats(),
            bm.eviction_count, bm.cow_count)


def _pick_op(rng, ref, sids, next_sid, caching):
    """One operation and its arguments, chosen from the reference pool's
    state so that most of them are legal."""
    live = [s for s in sids if ref.has(s)]
    bs = ref.block_size
    r = rng.rand()
    if r < 0.22 or not live:
        # new sequence; prompts share prefixes so the cache gets hits
        base = [7] * int(rng.randint(0, 3 * bs))
        toks = base + rng.randint(0, 5, int(rng.randint(1, 2 * bs))).tolist()
        if caching:
            return "acquire", (next_sid, toks)
        return "allocate", (next_sid, len(toks))
    sid = live[int(rng.randint(len(live)))]
    ntok = ref._tokens.get(sid, 0)
    valid = ref._valid.get(sid, 0)
    ids = ref._ids.get(sid)
    choices = ["ensure", "cow_if_shared", "truncate", "free", "release",
               "evict_parked", "commit"]
    op = choices[int(rng.randint(len(choices)))]
    if op == "ensure":
        return op, (sid, ntok + int(rng.randint(0, bs + 2)))
    if op == "cow_if_shared":
        n = len(ref.block_table(sid)) * bs
        return op, (sid, int(rng.randint(0, max(n, 1))))
    if op == "truncate":
        return op, (sid, int(rng.randint(0, ntok + 1)))
    if op in ("free", "release"):
        return op, (sid,)
    if op == "evict_parked":
        return op, (int(rng.randint(0, 4)),)
    # commit: finish (part of) the prefill, or decode one token
    if ids is not None and valid < len(ids):
        return "commit_prefill", (sid, int(rng.randint(1, len(ids) - valid
                                                       + 1)))
    if len(ref.block_table(sid)) * bs > valid:
        return "commit_decode_token", (sid, int(rng.randint(0, 5)))
    return "ensure", (sid, valid + 1)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("caching", [True, False], ids=["cache", "nocache"])
def test_block_manager_differential_fuzz(seed, caching):
    rng = np.random.RandomState(seed)
    ref = jkv.BlockManager(24, 4, enable_prefix_caching=caching)
    port = tkv.BlockManager(24, 4, enable_prefix_caching=caching)
    sids, next_sid, applied = [], 0, 0
    for _ in range(400):
        op, args = _pick_op(rng, ref, sids, next_sid, caching)
        if op in ("acquire", "allocate"):
            sids.append(next_sid)
            next_sid += 1
        a = _outcome(getattr(ref, op), *args)
        b = _outcome(getattr(port, op), *args)
        assert a == b, (op, args)
        applied += a[0] == "ok"
        assert _state(ref, sids) == _state(port, sids), (op, args)
        assert sorted(ref.drain_fresh()) == sorted(port.drain_fresh())
        ref.check_invariants()
        port.check_invariants()
    assert applied > 300                       # the fuzz mostly ran ops
    if caching:
        assert port.cache_hit_tokens > 0


def test_prefix_chain_hashes_and_constants_match():
    toks = list(range(37))
    assert tkv.prefix_chain_hashes(toks, 8) == jkv.prefix_chain_hashes(
        toks, 8)
    assert tkv.NULL_BLOCK == jkv.NULL_BLOCK == 0
    assert issubclass(tkv.BlockPoolExhausted, RuntimeError)
