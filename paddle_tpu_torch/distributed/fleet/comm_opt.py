"""Communication-reducing optimizers: DGC and LocalSGD — counterpart of
``paddle_tpu/distributed/fleet/comm_opt.py`` (the reference's
``DGCOptimizer``: top-k sparse all-reduce with momentum correction and
error feedback; ``LocalSGDOptimizer``: local steps and periodic
parameter averaging).

Plain functions on dict trees of tensors, each leaf as the tree holds
it (a GPT's stacked ``[L, ...]`` block leaf is one leaf).  A reduction
over a mesh axis (``mesh``, ``axis``: a ``topology.Mesh`` and one of its
axis names) runs through ``distributed.collective``: a dense all-reduce,
then the division by the axis' size (JAX's ``pmean``).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from .. import collective


class DGCState(NamedTuple):
    u: Any  # momentum residual
    v: Any  # error-feedback accumulator


def _map(fn, *trees):
    """``fn`` over the leaves of dict trees of one structure."""
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def dgc_init(params, device=None) -> DGCState:
    """Zero float32 residuals shaped as each leaf of ``params``, on the
    leaf's device (or ``device``)."""
    def z(p):
        return torch.zeros(p.shape, dtype=torch.float32,
                           device=p.device if device is None else device)

    return DGCState(_map(z, params), _map(z, params))


def _pmean_(t, mesh, axis):
    collective.all_reduce_(t, mesh, axis)
    return t.div_(mesh.size(axis))


def _leaf(g, u, v, sparsity, momentum):
    g = g.to(torch.float32)
    u2 = u * momentum              # local momentum (dgc_momentum op)
    u2.add_(g)
    v2 = v + u2                    # error-feedback accumulator
    n = v2.numel()
    # JAX's own float expression for k (comm_opt.py:49)
    k = max(1, int(n * (1.0 - sparsity)))
    mag = v2.abs()
    # the k-th largest |v|: the least of the top k (unsorted: no sort)
    thresh = torch.topk(mag.reshape(-1), k, sorted=False).values.min()
    mask = mag >= thresh           # ties keep more than k, as in JAX
    del mag
    send = torch.where(mask, v2, 0.0)
    v2.masked_fill_(mask, 0.0)     # the residual stays local
    u2.masked_fill_(mask, 0.0)     # momentum factor masking
    return send, u2, v2


def dgc_compress(grads, state: DGCState, sparsity: float = 0.99,
                 momentum: float = 0.9, mesh=None, axis: str | None = None):
    """One DGC round: momentum correction, error feedback and the top-k
    mask, leaf by leaf: u' = m·u + g, v' = v + u', threshold = the k-th
    largest |v'| (k = max(1, int(n · (1 - sparsity)))), kept = |v'| ≥
    threshold; the send is v' on the kept set and 0 elsewhere, and the
    kept entries of u' and v' become 0.

    Returns (sends, new DGCState); ``state`` is not changed.  Each leaf's
    send has density ≤ 1 - sparsity but for ties at the threshold.  With
    ``axis``, the sends are meaned over it (``mesh`` required).  The
    temporaries a leaf needs beside its new u, v and send are |v'| and
    the mask, freed before the next leaf."""
    if axis is not None and mesh is None:
        raise ValueError("dgc_compress: an axis needs its mesh")
    if isinstance(grads, dict):
        outs = {k: dgc_compress(g, DGCState(state.u[k], state.v[k]),
                                sparsity, momentum, mesh, axis)
                for k, g in grads.items()}
        return ({k: s for k, (s, _) in outs.items()},
                DGCState({k: st.u for k, (_, st) in outs.items()},
                         {k: st.v for k, (_, st) in outs.items()}))
    send, u2, v2 = _leaf(grads, state.u, state.v, sparsity, momentum)
    if axis is not None:
        _pmean_(send, mesh, axis)
    return send, DGCState(u2, v2)


class LocalSGD:
    """Periodic parameter averaging across a mesh axis.

    Run ``k_steps`` local optimizer steps, then ``maybe_average(params,
    step, mesh)`` means every parameter over ``axis`` in place when
    ``step % k_steps == 0``; on every other step it makes no collective
    at all, so the axis sees 1/k of the traffic (``collective.STATS``
    counts it)."""

    def __init__(self, k_steps: int = 4, axis: str = "dp"):
        self.k_steps = k_steps
        self.axis = axis

    def maybe_average(self, params, step, mesh):
        if int(step) % self.k_steps == 0:
            _map(lambda p: _pmean_(p.data, mesh, self.axis), params)
        return params
