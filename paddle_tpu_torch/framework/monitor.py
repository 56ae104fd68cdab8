"""Global runtime counters — counterpart of
``paddle_tpu/framework/monitor.py`` (the reference's platform/monitor.h:44
``StatValue`` / ``StatRegistry``).

A thread-safe process-local registry of named int (or float) stats.
:func:`snapshot_device_stats` folds each card's memory counters into
the same registry under the JAX package's names, read from
``torch.cuda.memory_stats(i)``: ``bytes_in_use`` (the allocator's
``allocated_bytes.all.current``), ``peak_bytes_in_use``
(``allocated_bytes.all.peak``) and ``bytes_limit`` (the card's total
memory).  Imports no torch at module level.
"""
from __future__ import annotations

import threading
import time
from typing import Iterator

__all__ = ["StatValue", "StatRegistry", "get_stat", "stats", "reset_all",
           "snapshot_device_stats"]


class StatValue:
    """One named monotonic-ish counter.  Int64 semantics by default like
    the reference's StatValue (add/sub/reset/get truncate to int);
    ``as_float=True`` makes it a float accumulator (latency sums) — the
    cast is fixed at creation, so existing int counters are unchanged."""

    def __init__(self, name: str, as_float: bool = False):
        self.name = name
        self.is_float = bool(as_float)
        self._cast = float if as_float else int
        self._v = self._cast(0)
        self._lock = threading.Lock()

    def add(self, n=1):
        with self._lock:
            self._v += self._cast(n)
            return self._v

    def sub(self, n=1):
        return self.add(-n)

    def set(self, n) -> None:
        with self._lock:
            self._v = self._cast(n)

    def get(self):
        with self._lock:
            return self._v

    def reset(self) -> None:
        self.set(0)


class StatRegistry:
    """Singleton name→StatValue table (monitor.h StatRegistry)."""

    _inst: "StatRegistry | None" = None
    _inst_lock = threading.Lock()

    def __init__(self):
        self._stats: dict[str, StatValue] = {}
        self._lock = threading.Lock()

    @classmethod
    def instance(cls) -> "StatRegistry":
        with cls._inst_lock:
            if cls._inst is None:
                cls._inst = cls()
            return cls._inst

    def get(self, name: str, as_float: bool = False) -> StatValue:
        with self._lock:
            if name not in self._stats:
                self._stats[name] = StatValue(name, as_float=as_float)
            return self._stats[name]

    def __iter__(self) -> Iterator[StatValue]:
        with self._lock:
            return iter(list(self._stats.values()))

    def dict(self) -> dict:
        return {s.name: s.get() for s in self}

    def reset_all(self) -> None:
        for s in self:
            s.reset()


def get_stat(name: str, as_float: bool = False, **labels) -> StatValue:
    """Registry accessor; ``labels`` build a Prometheus-style namespaced
    name — ``get_stat("serving.ttft_ms", slot=3)`` →
    ``serving.ttft_ms{slot="3"}`` — so per-entity series live beside the
    bare aggregate without a separate label store.  The first ``get``
    fixes a stat's int/float semantics."""
    if labels:
        def esc(v):  # Prometheus exposition escaping for label values
            return str(v).replace("\\", r"\\").replace('"', r'\"') \
                .replace("\n", r"\n")

        name = name + "{" + ",".join(
            f'{k}="{esc(labels[k])}"' for k in sorted(labels)) + "}"
    return StatRegistry.instance().get(name, as_float=as_float)


def stats() -> dict:
    return StatRegistry.instance().dict()


def reset_all() -> None:
    StatRegistry.instance().reset_all()


class _CudaDevice:
    """One card's memory counters under the JAX package's names."""

    def __init__(self, index: int):
        self.index = index

    def memory_stats(self) -> dict:
        import torch

        ms = torch.cuda.memory_stats(self.index)
        return {"bytes_in_use": int(ms.get("allocated_bytes.all.current", 0)),
                "peak_bytes_in_use": int(ms.get("allocated_bytes.all.peak",
                                                0)),
                "bytes_limit": int(torch.cuda.get_device_properties(
                    self.index).total_memory)}


def _local_devices() -> list:
    """Every card of this process, or none where torch or CUDA is
    missing (a CPU-only run)."""
    try:
        import torch
    except ImportError:
        return []
    if not torch.cuda.is_available():
        return []
    return [_CudaDevice(i) for i in range(torch.cuda.device_count())]


def snapshot_device_stats(devices=None) -> dict[str, int]:
    """Fold per-card memory stats into the registry (STAT_gpuN_mem
    analog: stat 'device{i}_bytes_in_use' etc.).

    ``devices`` overrides the sampled device list (anything with a
    ``memory_stats()`` method — tests inject fakes; None = every card of
    this process).  Without a card the return is {} and no device stat
    is written; the snapshot's time is recorded either way."""
    if devices is None:
        devices = _local_devices()
    out = {}
    for i, d in enumerate(devices):
        ms = d.memory_stats() or {}
        for k in ("bytes_in_use", "peak_bytes_in_use", "bytes_limit"):
            if k in ms:
                name = f"device{i}_{k}"
                get_stat(name).set(ms[k])
                out[name] = ms[k]
    get_stat("device_stats_snapshot_time_ns").set(time.time_ns())
    return out
