"""The collectives a parallel train step needs, over a :class:`Mesh`.

Counterpart of the parts of ``paddle_tpu/distributed/collective.py``
(:178-297) that the hybrid GPT step runs: ``all_reduce``,
``all_gather``, ``reduce_scatter``, ``broadcast`` and the point-to-point
exchange of a pipeline (there ``ppermute`` inside ``shard_map``).  Every
function names the mesh axes it runs over (a name or a tuple); over an
axis set of one rank it is the identity.

How a tensor travels is the mesh's ``transport``: "nccl" and "host"
(CPU tensors over gloo) call ``torch.distributed`` on the tensor itself;
"staged" — ranks sharing one card over gloo, whose ops move host
tensors (its send/recv take nothing else) — copies each CUDA tensor into
a pinned host buffer kept per shape (``mesh.pinned``), runs the op there
and copies the result back.  No op is staged under NCCL.

``exchange`` batches a tick's sends and receives into one
``batch_isend_irecv``, so that the stages of a pipeline, each sending
and receiving in both directions, cannot deadlock.

:data:`STATS` counts each op's calls and the bytes of its payload on
this rank (all-reduce: the tensor; all-gather: the output;
reduce-scatter: the input; exchange: what is sent and received).

The autograd pair of Megatron's tensor parallel: :func:`copy_to` —
identity forward, all-reduce backward (the "f" before a column-parallel
product) — and :func:`reduce_from` — all-reduce forward, identity
backward (the "g" after a row-parallel product).  A value computed the
same way on every rank of the axis gets the same, complete gradient on
each, so no loss seed is split over the replicas.
"""
from __future__ import annotations

import contextlib
import threading

import torch

STATS: dict = {}
_lock = threading.Lock()
_tls = threading.local()


def reset_stats():
    STATS.clear()


def stats() -> dict:
    """{op: {"calls": n, "bytes": b}} since the last :func:`reset_stats`."""
    return {k: dict(v) for k, v in STATS.items()}


def _add(op, calls, nbytes) -> None:
    """Count into :data:`STATS` — or, inside :func:`held` on this thread,
    into the innermost tally."""
    tally = getattr(_tls, "tally", None)
    with _lock if tally is None else contextlib.nullcontext():
        s = (STATS if tally is None else tally).setdefault(
            op, {"calls": 0, "bytes": 0})
        s["calls"] += calls
        s["bytes"] += int(nbytes)


def add_stats(delta: dict) -> None:
    """Add a tally ({op: {"calls", "bytes"}}, as :func:`held` yields) as
    the ops would: what one replay of a captured graph stands for (its
    Python, which counts, does not run again)."""
    for op, d in delta.items():
        _add(op, d["calls"], d["bytes"])


@contextlib.contextmanager
def held():
    """Count this thread's collectives into a fresh tally (the yielded
    dict) until the block ends; :data:`STATS` does not move — a graph
    capture's warm runs and the capture itself, as ``ops._counts.held``
    does for the launches."""
    prev = getattr(_tls, "tally", None)
    tally: dict = {}
    _tls.tally = tally
    try:
        yield tally
    finally:
        _tls.tally = prev


def _count(op, nbytes):
    _add(op, 1, nbytes)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _dist():
    import torch.distributed as dist

    return dist


def _staged(mesh, t) -> bool:
    return mesh.transport == "staged" and t.is_cuda


def _pinned(mesh, t, slot=0):
    """A pinned host buffer shaped like ``t``, reused across calls."""
    key = (tuple(t.shape), t.dtype, slot)
    buf = mesh.pinned.get(key)
    if buf is None:
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        mesh.pinned[key] = buf
    return buf


def all_reduce_(t, mesh, axes):
    """Sum ``t`` in place over ``axes``; returns ``t``."""
    pg = mesh.group(axes)
    if pg is None:
        return t
    dist = _dist()
    _count("all_reduce", _nbytes(t))
    if _staged(mesh, t):
        host = _pinned(mesh, t)
        host.copy_(t)
        dist.all_reduce(host, group=pg)
        t.copy_(host)
    else:
        dist.all_reduce(t, group=pg)
    return t


def all_reduce(t, mesh, axes):
    """The sum of ``t`` over ``axes``, in a new tensor."""
    if mesh.group(axes) is None:
        return t
    return all_reduce_(t.contiguous().clone(), mesh, axes)


def _gather_into(out, t, pg):
    dist = _dist()
    fn = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    fn(out, t, group=pg)


def _scatter_into(out, t, pg):
    dist = _dist()
    fn = getattr(dist, "reduce_scatter_single", None) \
        or dist.reduce_scatter_tensor
    fn(out, t, group=pg)


def all_gather(t, mesh, axes, dim=0):
    """The ranks' ``t`` along ``axes`` concatenated along ``dim`` in the
    group's rank order (one axis: its coordinate order)."""
    pg = mesh.group(axes)
    if pg is None:
        return t
    n = mesh.size(mesh.active(axes))
    t = t.movedim(dim, 0).contiguous() if dim else t.contiguous()
    out = torch.empty((n * t.shape[0],) + t.shape[1:], dtype=t.dtype,
                      device=t.device)
    _count("all_gather", _nbytes(out))
    if _staged(mesh, t):
        host_in, host_out = _pinned(mesh, t, 1), _pinned(mesh, out, 2)
        host_in.copy_(t)
        _gather_into(host_out, host_in, pg)
        out.copy_(host_out)
    else:
        _gather_into(out, t, pg)
    return out.movedim(0, dim) if dim else out


def reduce_scatter(t, mesh, axes, dim=0):
    """The sum of ``t`` over ``axes``, of which this rank keeps chunk
    ``mesh.index(axes)`` along ``dim``."""
    pg = mesh.group(axes)
    if pg is None:
        return t
    n = mesh.size(mesh.active(axes))
    t = t.movedim(dim, 0).contiguous() if dim else t.contiguous()
    if t.shape[0] % n:
        raise ValueError(f"reduce_scatter: dim of {t.shape[0]} does not "
                         f"divide over {n} ranks")
    out = torch.empty((t.shape[0] // n,) + t.shape[1:], dtype=t.dtype,
                      device=t.device)
    _count("reduce_scatter", _nbytes(t))
    if _staged(mesh, t):
        host_in, host_out = _pinned(mesh, t, 1), _pinned(mesh, out, 2)
        host_in.copy_(t)
        _scatter_into(host_out, host_in, pg)
        out.copy_(host_out)
    else:
        _scatter_into(out, t, pg)
    return out.movedim(0, dim) if dim else out


def broadcast_(t, mesh, axes, src: int = 0):
    """``t`` in place from the rank at index ``src`` along ``axes``."""
    pg = mesh.group(axes)
    if pg is None:
        return t
    dist = _dist()
    root = mesh.ranks(axes)[src]
    _count("broadcast", _nbytes(t))
    if _staged(mesh, t):
        host = _pinned(mesh, t)
        host.copy_(t)
        dist.broadcast(host, root, group=pg)
        t.copy_(host)
    else:
        dist.broadcast(t, root, group=pg)
    return t


def exchange(mesh, axis, sends=(), recvs=()):
    """One batched point-to-point round along ``axis``: ``sends`` is
    [(tensor, offset)], ``recvs`` [(shape, dtype, offset)] — offsets in
    steps along the axis — and the received tensors come back in order,
    on the mesh's device."""
    if not sends and not recvs:
        return []
    dist = _dist()
    pg = mesh.group(axis)
    dev = mesh.device
    ops, outs, back = [], [], []
    for i, (t, off) in enumerate(sends):
        t = t.contiguous()
        _count("exchange", _nbytes(t))
        if _staged(mesh, t):
            host = _pinned(mesh, t, ("send", i))
            host.copy_(t)
            t = host
        ops.append(dist.P2POp(dist.isend, t, mesh.peer(axis, off), pg))
    for i, (shape, dtype, off) in enumerate(recvs):
        t = torch.empty(shape, dtype=dtype, device=dev)
        _count("exchange", _nbytes(t))
        buf = t
        if _staged(mesh, t):
            buf = _pinned(mesh, t, ("recv", i))
            back.append((t, buf))
        ops.append(dist.P2POp(dist.irecv, buf, mesh.peer(axis, off), pg))
        outs.append(t)
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    for t, buf in back:
        t.copy_(buf)
    return outs


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.mesh, ctx.axes), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return all_reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def copy_to(x, mesh, axes):
    """Identity forward, all-reduce of the gradient over ``axes``."""
    if mesh is None or mesh.group(axes) is None:
        return x
    return _CopyTo.apply(x, mesh, axes)


def reduce_from(x, mesh, axes):
    """All-reduce forward over ``axes``, identity backward."""
    if mesh is None or mesh.group(axes) is None:
        return x
    return _ReduceFrom.apply(x, mesh, axes)
