"""Rank processes a controlling process drives step by step: the
machinery under a tensor-parallel server (``text/tp_serving.py``).

JAX serves a sharded model from one process over a device mesh; here a
rank is a process with one card (or, on one card and on the CPU, a share
of it), and the process that owns the server — its scheduler, its
requests, a fleet's router — is none of them.  It starts the ranks, tells
them which step to run with which feeds, and reads the outputs back from
the first rank:

* :class:`RankPool` — ``world`` rank processes (start method "spawn", a
  ``file://`` rendezvous in a fresh temporary directory, one intra-op
  thread a rank on the CPU), joined in one process group by
  ``env.init_process`` with the placement of ``env.placement``: NCCL with
  a card a rank where there are as many cards as ranks, gloo staged
  through pinned host memory where ranks share one card, gloo on the CPU
  for ``device="cpu"``.  A rank that finds no card where one was asked
  for fails the pool's start.
* :class:`ServingMesh` — a ``topology.Mesh`` of named axes over the pool's
  first ranks, its process groups built on every rank (``new_group`` is
  collective) and each used once before any step runs; the object a
  server takes as ``mesh=``.  :func:`serving_mesh` makes a pool of the
  mesh's size and the mesh over it in one call.

The wire is one duplex pipe a rank.  Frames (a tag byte, a small pickled
head, raw tensor bytes): ``C`` a control call (``"module:function"`` run
on the rank with its :class:`RankState`; every addressed rank answers);
``T`` a tensor upload (a server's weight shards, cut on the host, each
rank sent its own block: the bytes go through a file in the pool's
temporary directory, the frame names it); ``S`` a step — its id and its
feeds' bytes, never pickled tensors — answered by the first rank alone
(``M``: the outputs' bytes in a file both processes map, the frame their
shapes); ``U`` an in-place write of a replicated leaf (a paged server's
block tables).  A rank that fails answers ``E`` with its traceback.

Failure is loud and bounded: every wait polls the pipes and the
processes' sentinels with a deadline (``timeout_s``, also the process
group's collective timeout); a rank's error, a rank's death or a missed
deadline raises :class:`RankFailure` and marks the pool broken — a
broken pool refuses every later call, and :meth:`RankPool.close` stops
the ranks (terminating the ones that do not answer).
"""
from __future__ import annotations

import importlib
import mmap
import os
import pickle
import shutil
import struct
import tempfile
import threading
import time
import traceback
import weakref
from multiprocessing import connection as _mpc

import numpy as np
import torch

from .topology import Mesh

__all__ = ["RankPool", "ServingMesh", "RankFailure", "serving_mesh",
           "RankState"]



class RankFailure(RuntimeError):
    """A rank failed, died or missed its deadline; the pool is broken."""

    fatal = True


# -- frames ----------------------------------------------------------------


def _dtype_name(dt) -> str:
    return str(dt).split(".", 1)[1]


def _tensor_bytes(t):
    """A tensor's bytes as a memoryview (CPU, contiguous)."""
    t = t.detach()
    if t.device.type != "cpu":
        t = t.cpu()
    t = t.reshape(-1)
    if t.numel() == 0:
        return memoryview(b"")
    if t.stride(0) != 1:        # a view, or one element of any stride
        t = t.new_empty(t.shape).copy_(t)
    return memoryview(t.view(torch.uint8).numpy())


def pack(tag: bytes, head, tensors=()) -> bytes:
    """One frame: ``tag``, a pickled (head, tensor metas), the bytes."""
    views = [_tensor_bytes(t) for t in tensors]
    metas = [(_dtype_name(t.dtype), tuple(t.shape), v.nbytes)
             for t, v in zip(tensors, views)]
    h = pickle.dumps((head, metas), protocol=pickle.HIGHEST_PROTOCOL)
    return b"".join([tag, struct.pack("<I", len(h)), h, *views])


def unpack(data):
    """(tag, head, [tensors]) of a frame; the tensors are CPU copies."""
    tag = bytes(data[:1])
    (n,) = struct.unpack("<I", data[1:5])
    head, metas = pickle.loads(data[5:5 + n])
    buf = bytearray(data[5 + n:]) if metas else None
    out, off = [], 0
    for name, shape, nb in metas:
        dt = getattr(torch, name)
        if nb == 0:
            out.append(torch.empty(shape, dtype=dt))
        else:
            u = torch.frombuffer(buf, dtype=torch.uint8, count=nb,
                                 offset=off)
            out.append(u.view(dt).reshape(shape))
        off += nb
    return tag, head, out


class _Mapped:
    """A file mapped by the reply rank (which writes a step's outputs into
    it, growing it as needed) and the controlling process (which copies
    them out before it sends the next step)."""

    def __init__(self, path: str):
        self.path = path
        self.f = self.mm = None
        self.size = 0

    def _map(self, need: int, grow: bool) -> None:
        if self.mm is not None and self.size >= need:
            return
        if self.f is None:
            self.f = open(self.path, "a+b")
        if grow:
            os.ftruncate(self.f.fileno(), max(need, 2 * self.size, 1 << 20))
        size = os.fstat(self.f.fileno()).st_size
        if self.mm is not None:
            self.mm.close()
        self.mm = mmap.mmap(self.f.fileno(), size)
        self.size = size

    def write(self, tensors) -> list:
        views = [_tensor_bytes(t) for t in tensors]
        self._map(sum(v.nbytes for v in views), grow=True)
        off = 0
        for v in views:
            self.mm[off:off + v.nbytes] = v
            off += v.nbytes
        return [(_dtype_name(t.dtype), tuple(t.shape), v.nbytes)
                for t, v in zip(tensors, views)]

    def read(self, metas) -> list:
        if not metas:
            return []
        self._map(sum(m[2] for m in metas), grow=False)
        out, off = [], 0
        for name, shape, nb in metas:
            dt = getattr(torch, name)
            if nb == 0:
                out.append(torch.empty(shape, dtype=dt))
            else:
                u = torch.frombuffer(self.mm, dtype=torch.uint8, count=nb,
                                     offset=off)
                out.append(u.view(dt).reshape(shape).clone())
                del u
            off += nb
        return out


def _resolve(path: str):
    mod, _, fn = path.partition(":")
    if not mod.startswith("paddle_tpu_torch."):
        raise ValueError(f"{path!r}: rank calls name paddle_tpu_torch "
                         f"functions only")
    return getattr(importlib.import_module(mod), fn)


# -- the rank process --------------------------------------------------------


class RankState:
    """What one rank keeps between frames: its pool rank, device, backend
    and transport, the meshes it belongs to (``meshes[mid]``: a
    ``topology.Mesh``, or None where it is not a member), finished
    uploads (``uploads[key]``, on the rank's device) and ``objects`` —
    whatever the called functions keep (a server's bindings and steps)."""

    def __init__(self, rank, world, device, backend, transport):
        self.rank, self.world = rank, world
        self.device, self.backend, self.transport = device, backend, \
            transport
        self.meshes: dict = {}
        self.uploads: dict = {}
        self.objects: dict = {}
        self._fns: dict = {}
        self.steps, self.step_s = 0, 0.0     # step frames, receipt to done

    def fn(self, path):
        f = self._fns.get(path)
        if f is None:
            f = self._fns[path] = _resolve(path)
        return f

    def upload(self, head) -> None:
        key, dtype, shape, path = head
        raw = torch.from_numpy(np.fromfile(path, dtype=np.uint8))
        os.unlink(path)
        dt = getattr(torch, dtype)
        t = raw.view(dt).reshape(shape) if raw.numel() else \
            torch.empty(shape, dtype=dt)
        self.uploads[key] = t.to(self.device)


def step_times(state: RankState, reset: bool = False) -> dict:
    """This rank's step frames since the last reset and their wall, from a
    frame's receipt to its step's return (and, on the reply rank, its
    outputs written)."""
    out = {"steps": state.steps, "step_s": state.step_s}
    if reset:
        state.steps, state.step_s = 0, 0.0
    return out


def make_mesh(state: RankState, mid: int, shape: dict) -> bool:
    """Control call run on every pool rank: the process groups of the
    mesh over pool ranks [0, size) (every rank takes part in each
    ``new_group``); a member keeps its ``topology.Mesh`` and runs one
    all-reduce on each of its groups, so no later call is a group's
    first.  Returns membership."""
    from . import collective

    size = 1
    for v in shape.values():
        size *= int(v)
    member = state.rank < size
    mesh = Mesh(shape, state.rank if member else 0, state.device,
                state.backend, state.transport).build_groups()
    if not member:
        state.meshes[mid] = None
        return False
    for axes in list(mesh._groups):
        collective.all_reduce_(torch.zeros(1, device=state.device), mesh,
                               axes)
    state.meshes[mid] = mesh
    return True


def _rank_main(conn, rank, world, init, device, timeout_s, reply_path):
    import torch.distributed as dist

    from . import env

    try:
        if device is not None and torch.device(device).type == "cpu":
            torch.set_num_threads(1)
        dev = env.init_process(rank, world, init, device, timeout_s)
        _, backend, transport = env._DEVICE
        state = RankState(rank, world, dev, backend, transport)
        replies = _Mapped(reply_path)
        conn.send_bytes(pack(b"R", (str(dev), backend, transport)))
    except Exception:  # noqa: BLE001 - reported to the controller
        conn.send_bytes(pack(b"E", traceback.format_exc()))
        return
    failed = False
    try:
        while True:
            try:
                data = conn.recv_bytes()
            except (EOFError, OSError):
                break
            t_recv = time.perf_counter()
            tag, head, ts = unpack(data)
            if tag == b"C" and head[0] == "stop":
                conn.send_bytes(pack(b"R", None))
                break
            if failed:
                # drain: the controller is told already, and a rank that
                # stops reading could block its sends
                if tag == b"C":
                    conn.send_bytes(pack(b"E", "rank failed earlier"))
                continue
            try:
                if tag == b"S":
                    path, reply, args = head
                    outs = state.fn(path)(state, *args, feeds=ts)
                    if reply == rank:
                        conn.send_bytes(pack(b"M", replies.write(outs)))
                    state.steps += 1
                    state.step_s += time.perf_counter() - t_recv
                elif tag == b"U":
                    path, args = head
                    state.fn(path)(state, *args, feeds=ts)
                elif tag == b"T":
                    state.upload(head)
                else:
                    path, args = head
                    conn.send_bytes(pack(b"R", state.fn(path)(state, *args)))
            except Exception:  # noqa: BLE001 - reported to the controller
                if tag != b"C":
                    # a step may have left peers inside a collective
                    failed = True
                conn.send_bytes(pack(b"E", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            try:
                dist.destroy_process_group()
            except Exception:  # noqa: BLE001 - the process is ending
                pass


# -- the controlling process -------------------------------------------------


def _stop(procs, conns, tmpdir, grace=5.0):
    for c in conns:
        try:
            c.send_bytes(pack(b"C", ("stop", ())))
        except (OSError, ValueError):
            pass
    deadline = time.monotonic() + grace
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.terminate()
            p.join(2.0)
        if p.is_alive():
            p.kill()
            p.join(2.0)
    for c in conns:
        try:
            c.close()
        except OSError:
            pass
    shutil.rmtree(tmpdir, ignore_errors=True)


class RankPool:
    """``world`` rank processes in one process group (module note).
    ``device``: "cpu" for CPU ranks, None for the card placement.
    ``timeout_s`` bounds every wait for a rank and every collective."""

    def __init__(self, world: int, device=None, timeout_s: float = 120.0):
        import multiprocessing as mp

        self.world = int(world)
        self.timeout_s = float(timeout_s)
        self.broken: str | None = None
        self._lock = threading.RLock()
        self._next_id = 0
        self._deferred: list = []
        self.steps, self.step_s = 0, 0.0     # step round trips, their wall
        self._tmp = tempfile.mkdtemp(prefix="serving_ranks_")
        self._replies = _Mapped(os.path.join(self._tmp, "replies"))
        init = "file://" + os.path.join(self._tmp, "rendezvous")
        ctx = mp.get_context("spawn")
        self.conns, self.procs = [], []
        for r in range(self.world):
            here, there = ctx.Pipe(duplex=True)
            p = ctx.Process(target=_rank_main,
                            args=(there, r, self.world, init, device,
                                  self.timeout_s, self._replies.path),
                            daemon=True, name=f"serving-rank-{r}")
            p.start()
            there.close()
            self.conns.append(here)
            self.procs.append(p)
        self._finalizer = weakref.finalize(self, _stop, self.procs,
                                           self.conns, self._tmp)
        try:
            ready = self._collect(range(self.world), "start")
        except BaseException:
            self.close()
            raise
        self.devices = [torch.device(r[0]) for r in ready]
        self.backend, self.transport = ready[0][1], ready[0][2]

    def new_id(self) -> int:
        with self._lock:
            self._next_id += 1
            return self._next_id

    def defer(self, path: str, *args) -> None:
        """Queue a control call for the next call's start: what a
        finalizer asks (a dropped binding's release), which must not
        interleave with a call in progress."""
        self._deferred.append((path, args))

    def _flush(self) -> None:
        while self._deferred and self.broken is None:
            path, args = self._deferred.pop(0)
            self._send(range(self.world), pack(b"C", (path, args)))
            self._collect(range(self.world), path)

    # -- waiting ------------------------------------------------------------

    def _fail(self, msg: str):
        self.broken = msg
        raise RankFailure(msg)

    def _check(self):
        if self.broken is not None:
            raise RankFailure(f"the rank pool is broken: {self.broken}")

    def _collect(self, ranks, what: str, tags=(b"R",)) -> list:
        """The answers of ``ranks`` (one frame each, in rank order),
        polling every pipe and process with the pool's deadline: any
        rank's error, a death or the deadline raises."""
        ranks = list(ranks)
        got: dict = {}
        deadline = time.monotonic() + self.timeout_s
        by_conn = {self.conns[r]: r for r in range(self.world)}
        by_sent = {self.procs[r].sentinel: r for r in range(self.world)}
        while len(got) < len(ranks):
            left = deadline - time.monotonic()
            if left <= 0:
                missing = [r for r in ranks if r not in got]
                self._fail(f"ranks {missing} did not answer {what} within "
                           f"{self.timeout_s:g} s")
            ready = _mpc.wait(list(by_conn) + list(by_sent), timeout=left)
            for obj in ready:
                if obj in by_conn:
                    r = by_conn[obj]
                    try:
                        data = obj.recv_bytes()
                    except (EOFError, OSError):
                        self._fail(f"rank {r} closed its pipe during {what}")
                    tag, head, ts = unpack(data)
                    if tag == b"E":
                        self._fail(f"rank {r} failed during {what}:\n{head}")
                    if r not in ranks or tag not in tags or r in got:
                        self._fail(f"rank {r} answered out of turn "
                                   f"({tag!r}) during {what}")
                    got[r] = self._replies.read(head) if tag == b"M" else head
                elif not self.procs[by_sent[obj]].is_alive():
                    self._fail(f"rank {by_sent[obj]} died during {what} "
                               f"(exit code "
                               f"{self.procs[by_sent[obj]].exitcode})")
        return [got[r] for r in ranks]

    def _send(self, ranks, frame: bytes) -> None:
        for r in ranks:
            try:
                self.conns[r].send_bytes(frame)
            except (OSError, ValueError) as e:
                self._fail(f"rank {r}'s pipe is gone ({e})")

    # -- calls ----------------------------------------------------------------

    def call(self, ranks, path: str, *args) -> list:
        """Run ``path`` (``"module:function"``, called with the rank's
        :class:`RankState` and ``args``) on ``ranks``; their results in
        rank order.  An error on a rank is raised here as a
        :class:`RankFailure`."""
        with self._lock:
            self._check()
            self._flush()
            self._send(ranks, pack(b"C", (path, args)))
            return self._collect(ranks, path)

    def upload(self, rank: int, key, t) -> None:
        """Send tensor ``t`` to ``rank``, where it lands in
        ``state.uploads[key]`` on the rank's device (its bytes through a
        file the rank reads and removes)."""
        with self._lock:
            self._check()
            path = os.path.join(self._tmp, f"upload{self.new_id()}")
            with open(path, "wb") as f:
                f.write(_tensor_bytes(t))
            self._send([rank], pack(b"T", (key, _dtype_name(t.dtype),
                                           tuple(t.shape), path)))

    def step(self, ranks, path: str, args, feeds, reply: int = 0):
        """One step frame to ``ranks`` (``path`` called on each with
        ``args`` and the feeds); returns rank ``reply``'s output
        tensors."""
        with self._lock:
            self._check()
            self._flush()
            t0 = time.perf_counter()
            self._send(ranks, pack(b"S", (path, reply, args), feeds))
            (outs,) = self._collect([reply], path, tags=(b"M",))
            self.steps += 1
            self.step_s += time.perf_counter() - t0
            return outs

    def write(self, ranks, path: str, args, feeds) -> None:
        """An in-place write on ``ranks`` (no answer; an error surfaces
        at the next wait)."""
        frame = pack(b"U", (path, args), feeds)
        with self._lock:
            self._check()
            self._send(ranks, frame)

    def mesh(self, shape) -> "ServingMesh":
        """A :class:`ServingMesh` over this pool's first ranks."""
        return ServingMesh(self, shape)

    def close(self) -> None:
        """Stop every rank (terminating those that do not answer)."""
        with self._lock:
            if self.broken is None:
                self.broken = "closed"
        self._finalizer()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class ServingMesh(Mesh):
    """Named axes over the first ranks of a :class:`RankPool`, seen from
    the controlling process: the ``topology.Mesh`` layout (``shape``,
    ``size``, ``coord`` of rank 0), ``devices`` (each member's), the
    pool, and ``key`` — the fingerprint a tensor-parallel server's step
    keys carry (axes, sizes and the members' devices)."""

    def __init__(self, pool: RankPool, shape, _owns: bool = False):
        shape = dict(shape)
        size = 1
        for v in shape.values():
            size *= int(v)
        if size > pool.world:
            raise ValueError(f"mesh {shape} needs {size} ranks; the pool has "
                             f"{pool.world}")
        super().__init__(shape, 0, pool.devices[0], pool.backend,
                         pool.transport)
        self.pool = pool
        self.members = list(range(size))
        self.devices = pool.devices[:size]
        self.mid = pool.new_id()
        self._owns = _owns
        pool.call(range(pool.world),
                  "paddle_tpu_torch.distributed.serving_mesh:make_mesh",
                  self.mid, shape)
        self.key = (tuple(self.shape.items()),
                    tuple(str(d) for d in self.devices), self.mid)

    def close(self) -> None:
        """Stop the pool when this mesh made it (:func:`serving_mesh`)."""
        if self._owns:
            self.pool.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __repr__(self):
        return (f"ServingMesh({self.shape}, devices="
                f"{[str(d) for d in self.devices]}, {self.backend}, "
                f"{self.transport})")


def serving_mesh(shape, device=None, timeout_s: float = 120.0) -> ServingMesh:
    """A :class:`RankPool` of the mesh's size and the :class:`ServingMesh`
    over it; closing the mesh stops the pool."""
    size = 1
    for v in dict(shape).values():
        size *= int(v)
    pool = RankPool(size, device=device, timeout_s=timeout_s)
    try:
        return ServingMesh(pool, shape, _owns=True)
    except BaseException:
        pool.close()
        raise
