"""Shared by the hybrid trainer's tests on the CPU and on four cards
(tests/_torch_hybrid.py, tests/test_torch_hybrid_nccl.py), without JAX:
whole arrays gathered from every rank's shards, the interleaved
schedule's layers back in logical order, and the JAX trainer's gradient
factor."""
import numpy as np

from paddle_tpu_torch.parallel import transformer as pt


def gather(per_rank, specs):
    """Full arrays from every rank's shards: {rank: (coords, {name:
    local})}, specs {name: spec}."""
    full = {}
    for n, spec in specs.items():
        blocks = [(c, tree[n]) for c, tree in per_rank.values()]
        a0 = blocks[0][1]
        spec = tuple(spec) + (None,) * (a0.ndim - len(spec))
        shape = [a0.shape[d] * (1 if ax is None else
                                max(c[ax] for c, _ in blocks) + 1)
                 for d, ax in enumerate(spec)]
        out = np.zeros(shape, np.float32)
        for c, a in blocks:
            out[tuple(slice(None) if ax is None else
                      slice(c[ax] * a.shape[d], (c[ax] + 1) * a.shape[d])
                      for d, ax in enumerate(spec))] = a
        full[n] = out
    return full


def logical(tree, hp):
    """Gathered layers back in logical order (the interleaved schedule
    keeps them permuted by vpp_layer_perm)."""
    if hp.pp_schedule != "vpp" or hp.vpp <= 1:
        return tree
    L = tree["layers.ln1"].shape[0]
    inv = np.argsort(pt.vpp_layer_perm(L, hp.pp, hp.vpp))
    return {n: a[inv] if n.startswith("layers.") else a
            for n, a in tree.items()}


def grad_factor(hp):
    """The JAX trainer's gradients over the port's (whose equal the
    single-device step's): tp * cp, and pp too unless 1F1B seeds them.
    The reference runs under ``check_vma=False``, where each psum over an
    axis whose ranks all hold the loss transposes to a psum of their
    cotangents, and GPipe and the interleaved schedule psum the loss over
    pp inside the differentiated function."""
    pipe = 1 if hp.pp_schedule == "1f1b" else hp.pp
    return hp.tp * hp.cp * pipe
