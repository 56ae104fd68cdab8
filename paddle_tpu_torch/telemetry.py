"""The telemetry registry the server's ticks feed: counters, streaming
histograms, gauges, a ring of host events and the runtime-wedge verdict.

The port's own copy of the registry half of ``paddle_tpu/telemetry.py``
(counters under the same names, letter for letter, so a test can hold
the two packages' counters key for key): :func:`count`, :func:`observe`,
:func:`set_gauge`, :func:`event`, :func:`reset`, :func:`snapshot`,
:func:`latency_summary`, :class:`Histogram` (fixed log-spaced buckets,
O(1) memory), :func:`quantile_from_counts`, :class:`Gauge`, and
:func:`set_runtime_wedge` / :func:`clear_runtime_wedge` /
:func:`runtime_wedge`.  The counters live here (the JAX package keeps
them in ``framework.monitor``'s registry, which the port does not have).

``PADDLE_TPU_TELEMETRY=0`` turns every record call into an early return.
The Prometheus export, the metrics HTTP server, request spans and the
device feed are not ported.
"""
from __future__ import annotations

import bisect
import math
import threading
import time
from collections import deque

from . import flags as _flags

__all__ = [
    "enabled", "reset", "hist", "gauge", "observe", "set_gauge", "count",
    "counter", "counters", "event", "events", "snapshot",
    "latency_summary", "Histogram", "Gauge", "quantile_from_counts",
    "set_runtime_wedge", "clear_runtime_wedge", "runtime_wedge",
]


def enabled() -> bool:
    """Master switch (re-read per call so tests can flip the env)."""
    return _flags.telemetry_enabled()


# Fixed log-spaced bucket bounds shared by every histogram: 20 buckets per
# decade from 1e-3 to 1e7 (unit-agnostic; in ms that spans 1 us .. ~3 h).
_BOUNDS: tuple = tuple(10.0 ** (i / 20.0) for i in range(-60, 141))


class Histogram:
    """Streaming latency histogram: fixed log-spaced buckets, O(1) memory,
    lock-cheap ``observe``."""

    __slots__ = ("name", "_counts", "_count", "_sum", "_min", "_max",
                 "_lock")

    def __init__(self, name: str):
        self.name = name
        self._counts = [0] * (len(_BOUNDS) + 1)  # last = overflow
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        self._lock = threading.Lock()

    def observe(self, value: float, n: int = 1) -> None:
        """Record ``n`` observations of ``value``."""
        v = float(value)
        i = bisect.bisect_left(_BOUNDS, v) if v > 0.0 else 0
        with self._lock:
            self._counts[i] += n
            self._count += n
            self._sum += v * n
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v

    def quantile(self, q: float) -> float:
        """Interpolated quantile from the bucket counts: linear within the
        containing bucket, clamped to the observed min/max."""
        with self._lock:
            total = self._count
            if total == 0:
                return 0.0
            counts = list(self._counts)
            lo_obs, hi_obs = self._min, self._max
        rank = q * total
        cum = 0.0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            if cum + c >= rank:
                lo = _BOUNDS[i - 1] if 0 < i <= len(_BOUNDS) else 0.0
                hi = _BOUNDS[i] if i < len(_BOUNDS) else hi_obs
                v = lo + (hi - lo) * ((rank - cum) / c)
                return min(max(v, lo_obs), hi_obs)
            cum += c
        return hi_obs

    def summary(self) -> dict:
        with self._lock:
            n, s = self._count, self._sum
            mn = self._min if n else 0.0
            mx = self._max if n else 0.0
        return {"count": n, "sum": round(s, 6),
                "avg": round(s / n, 6) if n else 0.0,
                "min": round(mn, 6), "max": round(mx, 6),
                "p50": round(self.quantile(0.50), 6),
                "p90": round(self.quantile(0.90), 6),
                "p99": round(self.quantile(0.99), 6)}

    def raw_counts(self) -> list:
        """A consistent copy of the raw per-bucket counts."""
        with self._lock:
            return list(self._counts)


def quantile_from_counts(counts, q: float) -> float:
    """Interpolated quantile over a raw bucket-count vector (a
    :meth:`Histogram.raw_counts`, or the delta of two — a windowed
    distribution); the rule of :meth:`Histogram.quantile` without the
    min/max clamp.  0.0 on an empty window."""
    total = sum(counts)
    if total <= 0:
        return 0.0
    rank = q * total
    cum = 0.0
    for i, c in enumerate(counts):
        if c <= 0:
            continue
        if cum + c >= rank:
            lo = _BOUNDS[i - 1] if 0 < i <= len(_BOUNDS) else 0.0
            hi = _BOUNDS[i] if i < len(_BOUNDS) else _BOUNDS[-1]
            return lo + (hi - lo) * ((rank - cum) / c)
        cum += c
    return _BOUNDS[-1]


class Gauge:
    """Last-write-wins float gauge."""

    __slots__ = ("name", "_v", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._v = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._v = float(v)

    def get(self) -> float:
        with self._lock:
            return self._v


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

_EVENTS = 65536         # host events kept (a ring: the oldest go first)

_lock = threading.Lock()
_hists: dict[str, Histogram] = {}
_gauges: dict[str, Gauge] = {}
_counters: dict[str, int] = {}
_events: deque = deque(maxlen=_EVENTS)

# the resilience watchdog's live verdict: some server's async fetch blew
# its wall budget and no clean tick has completed since
_wedge_lock = threading.Lock()
_wedge: dict = {"wedged": False, "reason": None, "since": None,
                "detections": 0, "recoveries": 0}


def set_runtime_wedge(reason: str) -> None:
    """Mark the process wedged (the watchdog's verdict)."""
    with _wedge_lock:
        _wedge["wedged"] = True
        _wedge["reason"] = str(reason)
        _wedge["since"] = time.time()
        _wedge["detections"] += 1


def clear_runtime_wedge() -> None:
    """The loop recovered: a full tick completed after a wedge."""
    with _wedge_lock:
        if _wedge["wedged"]:
            _wedge["recoveries"] += 1
        _wedge["wedged"] = False
        _wedge["reason"] = None
        _wedge["since"] = None


def runtime_wedge() -> dict:
    with _wedge_lock:
        return dict(_wedge)


def hist(name: str) -> Histogram:
    h = _hists.get(name)
    if h is None:
        with _lock:
            h = _hists.setdefault(name, Histogram(name))
    return h


def gauge(name: str) -> Gauge:
    g = _gauges.get(name)
    if g is None:
        with _lock:
            g = _gauges.setdefault(name, Gauge(name))
    return g


def observe(name: str, value: float, n: int = 1) -> None:
    if not enabled():
        return
    hist(name).observe(value, n)


def set_gauge(name: str, value: float) -> None:
    if not enabled():
        return
    gauge(name).set(value)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    if not enabled():
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + int(n)


def counter(name: str) -> int:
    """One counter's value (0 when never counted)."""
    with _lock:
        return _counters.get(name, 0)


def counters(prefix: str = "") -> dict:
    """Every counter whose name starts with ``prefix``, sorted by name."""
    with _lock:
        return {n: v for n, v in sorted(_counters.items())
                if n.startswith(prefix)}


def event(name: str, t0: float, t1: float, tid: int = 0, **args) -> None:
    """Record a completed host span [t0, t1] (``time.perf_counter``
    seconds) in the event ring."""
    if not enabled():
        return
    rec = {"name": name, "t0": t0, "t1": t1, "tid": int(tid)}
    if args:
        rec["args"] = args
    with _lock:
        _events.append(rec)


def events(name: str | None = None) -> list:
    """The events in the ring (of one name, when given), oldest first."""
    with _lock:
        return [dict(e) for e in _events if name is None or e["name"] == name]


def reset() -> None:
    """Drop every histogram, gauge, counter and event (tests; a serve
    that reads its own counts).  The wedge verdict is left alone
    (:func:`clear_runtime_wedge`)."""
    with _lock:
        _hists.clear()
        _gauges.clear()
        _counters.clear()
        _events.clear()


def snapshot() -> dict:
    """One JSON-serializable dict: histogram summaries, gauges, counters,
    the number of events in the ring and the wedge verdict."""
    with _lock:
        hists = sorted(_hists.items())
        gauges = sorted(_gauges.items())
        ctrs = dict(sorted(_counters.items()))
        n_events = len(_events)
    return {"enabled": enabled(),
            "histograms": {n: h.summary() for n, h in hists},
            "gauges": {n: g.get() for n, g in gauges},
            "counters": ctrs, "events": n_events,
            "runtime_wedge": runtime_wedge()}


def latency_summary(prefix: str = "serving.") -> dict:
    """Compact {short_name: {count, p50, p99}} over the histograms under
    ``prefix``."""
    with _lock:
        hists = sorted(_hists.items())
    out = {}
    for name, h in hists:
        if not name.startswith(prefix):
            continue
        s = h.summary()
        out[name[len(prefix):]] = {"count": s["count"], "p50": s["p50"],
                                   "p99": s["p99"]}
    return out
