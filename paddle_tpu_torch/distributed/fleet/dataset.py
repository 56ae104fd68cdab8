"""Industrial dataset ingestion: ``InMemoryDataset`` / ``QueueDataset`` —
counterpart of ``paddle_tpu/distributed/fleet/dataset.py`` (the
reference's fleet/dataset/dataset.py over the C++ Dataset / DataFeed).

Both wrap the native shard feeder (``io.native_reader.TokenShardReader``
over ``csrc/host/io_runtime.cpp``).  Records are fixed-length binary
(``set_record_schema`` gives the [seq_len, dtype] layout — the
pretraining shard format); batches surface as numpy arrays, which a
``DevicePrefetcher`` moves to the card.  Same configuration surface,
batches and shuffles as the JAX package's.  Imports no torch.
"""
from __future__ import annotations

from typing import Iterator, Sequence

import numpy as np


def _np_dtype(dt):
    """A numpy dtype from a numpy dtype, its name or a torch dtype."""
    if getattr(dt, "is_floating_point", None) is not None:     # torch
        return np.dtype(str(dt).replace("torch.", ""))
    return np.dtype(dt)


class _DatasetBase:
    def __init__(self):
        self._files: list[str] = []
        self._seq_len = 0
        self._dtype = np.int32
        self._batch = 1
        self._threads = 4
        self._shuffle_window = 0
        self._seed = 0

    # reference config surface
    def set_filelist(self, files: Sequence[str]):
        self._files = list(files)

    def set_batch_size(self, bs: int):
        self._batch = int(bs)

    def set_thread(self, n: int):
        self._threads = int(n)

    def set_record_schema(self, seq_len: int, dtype=np.int32):
        self._seq_len = int(seq_len)
        self._dtype = np.dtype(dtype)

    def set_shuffle_window(self, window: int):
        """Streaming reservoir-shuffle window (0 = no shuffle)."""
        self._shuffle_window = int(window)

    def set_seed(self, seed: int):
        self._seed = int(seed)

    def set_use_var(self, var_list):
        """Bind variables to record columns (reference dataset.set_use_var
        → DataFeed slots): any objects with ``.name``, ``.shape`` and
        ``.dtype`` (a numpy dtype, its name, or a torch dtype).  Each var
        with trailing dim k consumes the next k columns of the flat
        record, cast to its dtype (:meth:`slice_batch`)."""
        self._use_vars = list(var_list)

    def slice_batch(self, batch: np.ndarray) -> dict:
        """Split a [B, seq_len] record batch into a feed dict per use_var."""
        if not getattr(self, "_use_vars", None):
            raise ValueError("set_use_var(...) first")
        feed = {}
        col = 0
        for v in self._use_vars:
            k = 1
            for s in v.shape[1:]:
                if int(s) < 0:
                    raise ValueError(
                        f"use_var {v.name!r} has dynamic trailing dim "
                        f"{list(v.shape)}: record slicing needs static "
                        "widths (only dim 0 may be batch/-1)")
                k *= int(s)
            width = k if len(v.shape) > 1 else 1
            chunk = batch[:, col:col + width]
            col += width
            if len(v.shape) == 1:
                chunk = chunk.reshape(-1)
            else:
                chunk = chunk.reshape((-1,) + tuple(
                    max(1, int(s)) for s in v.shape[1:]))
            feed[v.name] = chunk.astype(_np_dtype(v.dtype))
        return feed

    def _reader(self, capacity=8):
        from ...io.native_reader import TokenShardReader

        if not self._files or not self._seq_len:
            raise ValueError("set_filelist + set_record_schema first")
        return TokenShardReader(
            self._files, seq_len=self._seq_len, batch_size=self._batch,
            num_threads=self._threads, dtype=self._dtype, capacity=capacity,
            seed=self._seed, shuffle_window=self._shuffle_window)


class QueueDataset(_DatasetBase):
    """Streaming: batches flow straight from reader threads (no staging).

    The native feeder delivers trailing PARTIAL per-thread batches so no
    record is lost; a step of fixed shape needs full batches, so QueueDataset
    keeps its documented only-full-batches contract by default
    (``drop_last=True``) and short tails are filtered here.  Call
    ``set_drop_last(False)`` to receive the ragged tails; use
    InMemoryDataset for epoch-exact full batches."""

    def __init__(self):
        super().__init__()
        self._drop_last = True

    def set_drop_last(self, drop: bool):
        self._drop_last = bool(drop)
        return self

    def __iter__(self) -> Iterator[np.ndarray]:
        for arr in self._reader():
            if self._drop_last and arr.shape[0] < self._batch:
                continue
            yield arr


class InMemoryDataset(_DatasetBase):
    """Stage everything in host RAM, then (re-)shuffle and iterate epochs
    (reference load_into_memory/local_shuffle/global_shuffle)."""

    def __init__(self):
        super().__init__()
        self._records: np.ndarray | None = None

    def load_into_memory(self):
        # stage at record granularity (batch=1) so no ragged per-worker tail
        # is dropped; batching happens at iteration time
        saved = self._batch
        self._batch = 1
        try:
            batches = list(self._reader(capacity=32))
        finally:
            self._batch = saved
        if batches:
            self._records = np.concatenate(batches, axis=0)
        else:
            self._records = np.empty((0, self._seq_len), self._dtype)
        return self

    def local_shuffle(self, seed: int | None = None):
        assert self._records is not None, "load_into_memory first"
        rng = np.random.default_rng(self._seed if seed is None else seed)
        rng.shuffle(self._records)
        return self

    # single-host build: global == local (multi-host would alltoall shards)
    global_shuffle = local_shuffle

    def get_memory_data_size(self) -> int:
        return 0 if self._records is None else len(self._records)

    def __iter__(self) -> Iterator[np.ndarray]:
        assert self._records is not None, "load_into_memory first"
        n = (len(self._records) // self._batch) * self._batch
        for i in range(0, n, self._batch):
            yield self._records[i:i + self._batch]

    def release_memory(self):
        self._records = None
