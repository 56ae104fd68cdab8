"""Native-backed data ingestion — counterpart of
``paddle_tpu/io/native_reader.py``: ``BlockingBatchQueue``,
``TokenShardReader`` and ``DevicePrefetcher``.

The C++ side (``csrc/host/io_runtime.cpp``, the JAX package's source
copied unedited, built by ``_native.io_runtime``) reads fixed-record
binary shards on a thread pool, packs batches and hands them over a
bounded blocking queue; Python views each batch as a numpy array, and
:class:`DevicePrefetcher` moves batches to the card ahead of the step
that reads them (the reference's buffered_reader role).

With ``num_threads > 1`` the order of records across the reader's
threads is not fixed (the C++ feeders race for the queue); one thread
reads the files in order, record by record.

Importing this module loads no torch; ``DevicePrefetcher`` imports it
when built.
"""
from __future__ import annotations

import ctypes
import os
import queue
import threading
import time
from typing import Iterator, Sequence

import numpy as np

from .._native import NativeUnavailable, io_runtime  # noqa: F401


class BlockingBatchQueue:
    """Bounded MPMC byte-batch queue backed by the C++ runtime."""

    def __init__(self, capacity: int = 8):
        self._lib = io_runtime()
        self._h = self._lib.ptq_create(capacity)
        # next_size + pop must be one atomic step per consumer (two C calls)
        self._pop_lock = threading.Lock()

    def push(self, arr: np.ndarray) -> bool:
        arr = np.ascontiguousarray(arr)
        if arr.nbytes == 0:
            # size 0 is the closed-and-drained sentinel on the pop side
            raise ValueError("cannot push an empty buffer")
        p = arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        return bool(self._lib.ptq_push(self._h, p, arr.nbytes))

    def pop(self) -> np.ndarray | None:
        """Blocking; None when the queue is closed and drained."""
        with self._pop_lock:
            n = self._lib.ptq_next_size(self._h)
            if n == 0:
                return None
            out = np.empty(n, np.uint8)
            got = self._lib.ptq_pop(
                self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n)
        if got == 0:
            return None
        return out[:got]

    def __len__(self):
        return int(self._lib.ptq_size(self._h))

    def close(self):
        self._lib.ptq_close(self._h)

    def __del__(self):
        try:
            self._lib.ptq_close(self._h)
            self._lib.ptq_destroy(self._h)
        except Exception:
            pass


class TokenShardReader:
    """Multithreaded reader of fixed-length token-record binary shards.

    Each record is ``seq_len`` tokens of ``dtype`` (default int32) — the
    standard pretraining shard layout.  Yields [batch, seq_len] arrays
    (a thread's last batch may be short: no record is dropped).
    ``shuffle_window`` > 1 shuffles each thread's records through a
    reservoir of that size, seeded ``seed + thread``.
    """

    def __init__(self, files: Sequence[str], seq_len: int, batch_size: int,
                 num_threads: int = 4, dtype=np.int32, capacity: int = 8,
                 seed: int = 0, shuffle_window: int = 0):
        self.files = [os.fspath(f) for f in files]
        self.seq_len = int(seq_len)
        self.batch_size = int(batch_size)
        self.dtype = np.dtype(dtype)
        self._lib = io_runtime()
        self._q = BlockingBatchQueue(capacity)
        rec_bytes = self.seq_len * self.dtype.itemsize
        blob = ("\n".join(self.files)).encode()
        self._f = self._lib.ptf_start(
            self._q._h, blob, rec_bytes, self.batch_size, int(num_threads),
            int(seed), int(shuffle_window))

    @property
    def records_read(self) -> int:
        return int(self._lib.ptf_records_read(self._f))

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            raw = self._q.pop()
            if raw is None:
                return
            yield raw.view(self.dtype).reshape(-1, self.seq_len)

    def close(self):
        self._q.close()
        self._lib.ptf_join(self._f)

    def __del__(self):
        try:
            self.close()
            self._lib.ptf_destroy(self._f)
        except Exception:
            pass


def _tree_map(fn, x):
    """``fn`` on every leaf of a batch: an array or tensor, or a dict,
    list or tuple of them."""
    if isinstance(x, dict):
        return {k: _tree_map(fn, v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_tree_map(fn, v) for v in x)
    return fn(x)


def _host_tensor(torch, a):
    """A CPU tensor holding a snapshot of ``a`` (an array, a tensor or a
    number), as ``jax.device_put`` takes one."""
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", copy=True)
    return torch.from_numpy(np.array(a))


class _Staged:
    """A batch copied to the card on the stager's stream: the consumer's
    stream waits for ``events`` before it reads ``value``."""

    __slots__ = ("value", "events")

    def __init__(self, value, events):
        self.value, self.events = value, events


class _CardStager:
    """Host batches to one card through a ring of pinned buffers.

    Each leaf is copied into the next of ``slots`` pinned buffers of its
    shape and dtype (allocated once, at the first such leaf), then to a
    fresh device tensor on a side stream, and an event is recorded after
    the copy.  A slot is written again only after the event of the copy
    that last read it has completed — so a slow consumer never sees a
    buffer overwritten under its copy, and no batch pins fresh memory."""

    def __init__(self, torch, device, slots: int):
        self.torch = torch
        self.device = device
        self.slots = slots
        self.stream = torch.cuda.Stream(device)
        self._rings: dict = {}      # (shape, dtype) -> [buffers, events, i]
        self.stats = {"copies": 0, "slot_waits": 0, "pinned_buffers": 0}

    def _leaf(self, a, events):
        torch = self.torch
        src = a if isinstance(a, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(a))
        if src.is_cuda:
            raise ValueError("DevicePrefetcher takes host batches; this one "
                             "is already on a card")
        key = (tuple(src.shape), src.dtype)
        ring = self._rings.get(key)
        if ring is None:
            ring = [[torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
                     for _ in range(self.slots)], [None] * self.slots, 0]
            self._rings[key] = ring
            self.stats["pinned_buffers"] += self.slots
        bufs, evs, i = ring
        ring[2] = (i + 1) % self.slots
        if evs[i] is not None:
            if not evs[i].query():
                self.stats["slot_waits"] += 1
            evs[i].synchronize()    # the slot's last copy has read it
        bufs[i].copy_(src)
        with torch.cuda.stream(self.stream):
            out = torch.empty(src.shape, dtype=src.dtype, device=self.device)
            out.copy_(bufs[i], non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self.stream)
        evs[i] = ev
        events.append((out, ev))
        self.stats["copies"] += 1
        return out

    def put(self, batch):
        events: list = []
        value = _tree_map(lambda a: self._leaf(a, events), batch)
        return _Staged(value, events)

    def deliver(self, item):
        """The consumer's side: its current stream waits for the copies,
        and each tensor is marked in use on it (it was made on the side
        stream)."""
        cur = self.torch.cuda.current_stream(self.device)
        for out, ev in item.events:
            cur.wait_event(ev)
            out.record_stream(cur)
        return item.value


class DevicePrefetcher:
    """A background thread that moves host batches to the device ahead of
    the consumer (the buffered_reader double-buffer role).

    ``device``: the card (``cuda``, the default) or ``"cpu"``; on a card
    each batch goes through :class:`_CardStager`'s ring of ``depth + 1``
    pinned buffers and a side stream, and the consumer's stream waits on
    the copy's event before the step reads the batch.  ``transform``
    replaces the move (a caller with a mesh places the batch itself).  At
    most ``depth`` moved batches wait in the queue.

    The JAX package's resilience contract: a worker exception propagates
    to the consuming loop (never a hang on the bounded queue), after up to
    ``retries`` bounded re-read attempts on the source iterator
    (``flags.prefetch_retries()``, ``PADDLE_TPU_PREFETCH_RETRIES``,
    default 2; each counted in ``resilience.prefetch_retries``, spaced by
    ``resilience.backoff_schedule``); the ``"prefetch"`` fault site is
    checked before each pull; a generator that died stays dead and its
    error is raised, not an empty epoch; ``close()`` stops the thread; the
    consumer polls the worker's liveness, so a worker that died without
    its end-of-stream sentinel ends iteration with its error.  A failed
    move (a copy to the card) raises in the consumer; nothing falls back
    to the CPU."""

    def __init__(self, it, depth: int = 2, device=None, transform=None,
                 retries: int | None = None):
        import torch

        from .. import faults as _faults
        from .. import flags as _flags
        from .. import resilience as _resilience
        from .. import resolve_device
        from .. import telemetry as _telemetry

        self._out: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._src = iter(it)
        self._stop = threading.Event()
        retries = (_flags.prefetch_retries() if retries is None
                   else max(0, int(retries)))
        self.stager = None
        if transform is not None:
            put = transform
        else:
            dev = resolve_device(device)
            if dev.type == "cuda":
                self.stager = _CardStager(torch, dev, max(1, depth) + 1)
                put = self.stager.put
            else:
                put = lambda x: _tree_map(  # noqa: E731
                    lambda a: _host_tensor(torch, a).to(dev), x)

        def put_q(item) -> bool:
            # bounded put that observes close() so an abandoned consumer
            # doesn't pin this thread (and the source reader) forever
            while not self._stop.is_set():
                try:
                    self._out.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        self._err: BaseException | None = None

        def next_item():
            # one source pull, retried within bounds on a TRANSIENT
            # error: a re-callable iterator (shard reader) may succeed
            # on the next record; an exhausted generator re-raises
            # StopIteration (never retried), and a generator that raised
            # is dead — its retry fails fast with the same error
            if _faults.active():
                _faults.check("prefetch", "io.prefetch")
            return next(self._src)

        def worker():
            fails = 0
            last_err: BaseException | None = None
            while not self._stop.is_set():
                try:
                    item = next_item()
                    fails = 0
                    last_err = None
                except StopIteration:
                    # a generator that raised is dead: its retry pull
                    # lands here as StopIteration — surface the error it
                    # raised, never a silently short epoch
                    if last_err is not None:
                        self._err = last_err
                    break
                except BaseException as e:  # noqa: BLE001 - surfaced to
                    # the consumer, not stderr
                    fails += 1
                    last_err = e
                    if fails > retries:
                        self._err = e
                        break
                    _telemetry.count("resilience.prefetch_retries")
                    # exponential growth across consecutive failures
                    delays = _resilience.backoff_schedule(
                        retries + 1, base=0.02, max_delay=1.0)
                    time.sleep(delays[min(fails, len(delays)) - 1])
                    continue
                try:
                    if not put_q(put(item)):
                        return
                except BaseException as e:  # the move or transform failed
                    self._err = e
                    break
            put_q(None)

        self._t = threading.Thread(target=worker, daemon=True)
        self._t.start()

    def pending(self) -> int:
        """Moved batches waiting in the queue now."""
        return self._out.qsize()

    def close(self):
        """Stop the prefetch thread and drop queued batches."""
        self._stop.set()
        try:
            while True:
                self._out.get_nowait()
        except queue.Empty:
            pass

    def __iter__(self):
        while True:
            try:
                # bounded get + liveness poll: a worker thread that died
                # without its end-of-stream sentinel ends iteration (with
                # its error if recorded), never a deadlock
                item = self._out.get(timeout=0.5)
            except queue.Empty:
                if self._t.is_alive():
                    continue
                if self._err is not None:
                    raise self._err
                return
            if item is None:
                if self._err is not None:
                    raise self._err
                return
            if isinstance(item, _Staged):
                item = self.stager.deliver(item)
            yield item
