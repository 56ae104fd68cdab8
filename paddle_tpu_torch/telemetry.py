"""Runtime telemetry: the registry the server's ticks feed, and its
export — Prometheus text, a metrics HTTP endpoint, request spans and
traces, the recompile watch and the device feed.

The port's own copy of ``paddle_tpu/telemetry.py``, under the same
names, letter for letter, so a test can hold the two packages' series
key for key:

* the registry: :func:`count`, :func:`observe`, :func:`set_gauge`,
  :func:`event`, :func:`reset`, :class:`Histogram` (fixed log-spaced
  buckets, O(1) memory; :meth:`Histogram.state` / :meth:`Histogram.merge`
  fold distributions exactly), :func:`quantile_from_counts`,
  :class:`Gauge`, :func:`admission_snapshot` and the runtime-wedge
  verdict (:func:`set_runtime_wedge` / :func:`clear_runtime_wedge` /
  :func:`runtime_wedge`).  The counters live here (the JAX package keeps
  them in ``framework.monitor``'s registry, which the port does not have);
* spans: :func:`span`, the JSONL log (``PADDLE_TPU_TELEMETRY_LOG``),
  :func:`mint_trace`, :class:`SpanRing`, :func:`spans_to_chrome`,
  :func:`chrome_events` and :func:`dump_chrome_trace`, which merges the
  events of a ``torch.profiler`` run where the JAX package merges its
  profiler's;
* the recompile watch: :func:`record_compile`.  The port's counterpart of
  a jit-cache miss is the Engine building a step (on the card: capturing
  its CUDA graph, ``text/engine.py``); a build of a step key seen before
  under other flags warns;
* the device feed: each step build's cost count
  (:func:`instrument_compile`, and the Engine's builds through
  :func:`record_build`), :func:`note_step_time` (per-step walls) and
  :func:`sample_device_stats` (the card's memory, read from
  ``torch.cuda.memory_stats`` / ``torch.cuda.mem_get_info`` into the
  ``device.*`` gauges), joined by :func:`device_feed` into FLOPs, bytes,
  MFU and a roofline verdict per step.  Where the JAX package reads XLA's
  cost and memory analyses of a compiled step, the port counts the
  step's own work by shape while it runs once (:func:`counted_call`,
  and :func:`counted` on each kernel): FLOPs of the matmul family and of
  the kernels, bytes each op reads and writes, and the step's argument,
  output and (on the card) graph-pool sizes;
* export: :func:`snapshot`, :func:`render_prometheus`,
  :func:`probe_health`, :func:`capture_device_profile` and
  :class:`MetricsServer` (``GET /metrics``, ``/snapshot``, ``/healthz`` —
  503 while wedged — and ``POST /profile``), loopback by default.

One deliberate difference: :func:`probe_health` reads only an explicit
path or ``PADDLE_TPU_PROBE_LOG``, never a probe log found in the
checkout (that log records another machine's accelerator).

``PADDLE_TPU_TELEMETRY=0`` turns every record call into an early return.
"""
from __future__ import annotations

import bisect
import contextlib
import functools
import json
import math
import os
import threading
import time
import warnings
from collections import deque

from . import flags as _flags

__all__ = [
    "enabled", "reset", "hist", "gauge", "observe", "set_gauge", "count",
    "counter", "counters", "event", "events", "span", "snapshot",
    "latency_summary", "Histogram", "Gauge", "quantile_from_counts",
    "admission_snapshot", "set_runtime_wedge", "clear_runtime_wedge",
    "runtime_wedge", "record_compile", "compile_log", "instrument_compile",
    "record_build", "counted_call", "counted", "note_step_time",
    "sample_device_stats", "device_feed", "render_prometheus",
    "probe_health", "capture_device_profile", "MetricsServer",
    "serve_metrics", "chrome_events", "dump_chrome_trace", "SpanRing",
    "mint_trace", "spans_to_chrome",
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

    def buckets(self):
        """(upper_bound, cumulative_count) pairs for Prometheus exposition:
        the bounds where the cumulative count changes, then +Inf."""
        with self._lock:
            counts = list(self._counts)
        out, cum = [], 0
        for i, c in enumerate(counts[:-1]):
            if c:
                cum += c
                out.append((_BOUNDS[i], cum))
        out.append((math.inf, cum + counts[-1]))
        return out

    def state(self) -> dict:
        """JSON-safe form (raw bucket counts, count, sum and the observed
        extremes) that :meth:`merge` folds without the samples."""
        with self._lock:
            return {"counts": list(self._counts), "count": self._count,
                    "sum": self._sum,
                    "min": self._min if self._count else None,
                    "max": self._max if self._count else None}

    def merge(self, other) -> "Histogram":
        """Fold another histogram, or its :meth:`state` dict, into this
        one by exact bucket-count addition (every histogram shares
        ``_BOUNDS``, so quantiles of the merge are those of the
        concatenated samples).  Returns ``self``."""
        st = other.state() if isinstance(other, Histogram) else other
        counts = st["counts"]
        with self._lock:
            if len(counts) != len(self._counts):
                raise ValueError(
                    f"bucket ladder mismatch: {len(counts)} vs "
                    f"{len(self._counts)}")
            for i, c in enumerate(counts):
                self._counts[i] += int(c)
            self._count += int(st["count"])
            self._sum += float(st["sum"])
            if st.get("min") is not None and float(st["min"]) < self._min:
                self._min = float(st["min"])
            if st.get("max") is not None and float(st["max"]) > self._max:
                self._max = float(st["max"])
        return self


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
_COMPILES = 4096        # recompile-watch records kept (a ring too)

_lock = threading.Lock()
_hists: dict[str, Histogram] = {}
_gauges: dict[str, Gauge] = {}
_counters: dict[str, int] = {}
_events: deque = deque(maxlen=_EVENTS)
_log_lock = threading.Lock()   # JSONL I/O only: never blocks recording
_log_fh = None
_log_path: str | None = None

# the device feed: per-step cost records, wall EWMAs and the last card
# memory sample
_device_lock = threading.Lock()
_step_analysis: dict[str, dict] = {}
_step_times: dict[str, dict] = {}
_skip_first_wall: set = set()
_device_info: dict = {}
_ANALYSES = 256          # cost records kept (the oldest capture goes first)
_hbm_last: dict = {}
_hbm_state = {"t": -math.inf}
# EWMA weight of a step's walls: about the last 8 calls dominate
_STEP_EWMA_ALPHA = 0.25

# the recompile watch: per (name, flagless key) the flags key last built
_compile_lock = threading.Lock()
_compile_seen: dict[tuple, tuple] = {}
_compile_log: deque = deque(maxlen=_COMPILES)
_warn_last: dict[str, float] = {}
# at most one recompile warning per step name an interval (module-level
# so tests can shrink it)
_WARN_INTERVAL_S = 30.0

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
    _jsonl_write(rec)


def events(name: str | None = None) -> list:
    """The events in the ring (of one name, when given), oldest first."""
    with _lock:
        return [dict(e) for e in _events if name is None or e["name"] == name]


def admission_snapshot() -> dict:
    """Every ``admission.*`` gauge and counter registered (rung, budget
    level, sheds per class, tenant throttles, ...) as one flat dict: the
    ``/healthz`` admission block."""
    with _lock:
        out = {n: g.get() for n, g in _gauges.items()
               if n.startswith("admission.")}
        out.update((n, v) for n, v in _counters.items()
                   if n.startswith("admission."))
    return out


def reset() -> None:
    """Drop every histogram, gauge, counter and event, the JSONL log's
    handle, the recompile watch's records and the device feed's
    measurements (tests; a serve that reads its own counts).  The wedge
    verdict and the steps' cost records are left alone."""
    global _log_fh, _log_path
    with _lock:
        _hists.clear()
        _gauges.clear()
        _counters.clear()
        _events.clear()
    with _log_lock:
        if _log_fh is not None:
            with contextlib.suppress(Exception):
                _log_fh.close()
        _log_fh = None
        _log_path = None
    with _compile_lock:
        _compile_seen.clear()
        _compile_log.clear()
        _warn_last.clear()
    with _device_lock:
        # measurements only: a step's cost record describes a build that
        # reset() does not drop (it is counted once), so the store stays,
        # as in the JAX package
        _step_times.clear()
        _skip_first_wall.clear()
        _hbm_last.clear()
        _hbm_state["t"] = -math.inf




# ---------------------------------------------------------------------------
# spans and events: the JSONL log, counter samples, Chrome traces
# ---------------------------------------------------------------------------


def _jsonl_write(rec: dict) -> None:
    """Append ``rec`` to ``PADDLE_TPU_TELEMETRY_LOG`` as one JSON line."""
    global _log_fh, _log_path
    path = _flags.telemetry_log()
    if not path:
        return
    with _log_lock:
        if _log_fh is None or _log_path != path:
            if _log_fh is not None:
                with contextlib.suppress(Exception):
                    _log_fh.close()
            os.makedirs(os.path.dirname(os.path.abspath(path)),
                        exist_ok=True)
            _log_fh = open(path, "a", encoding="utf-8")
            _log_path = path
        _log_fh.write(json.dumps(rec) + "\n")
        _log_fh.flush()


def _counter_event(name: str, values: dict) -> None:
    """A Chrome-trace counter sample ('C' phase: the card memory gauges
    ride the timeline as counter tracks) into the ring and the log."""
    if not enabled() or not values:
        return
    rec = {"name": name, "ph": "C", "t": time.perf_counter(),
           "args": {k: float(v) for k, v in values.items()}}
    with _lock:
        _events.append(rec)
    _jsonl_write(rec)


@contextlib.contextmanager
def span(name: str, tid: int = 0, **args):
    """``with telemetry.span("prefill", rid=3): ...`` records an event on
    exit (nothing when telemetry is off)."""
    if not enabled():
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        event(name, t0, time.perf_counter(), tid=tid, **args)


def chrome_events(pid: int = 1, shift: float = 0.0) -> list:
    """The event ring as Chrome-trace events (µs timestamps): 'X' spans
    and 'C' counter samples.  ``shift`` (seconds) is added to every
    timestamp (``time.perf_counter`` seconds otherwise)."""
    out = [{"name": "process_name", "ph": "M", "pid": pid,
            "args": {"name": "paddle_tpu_torch.telemetry"}}]
    with _lock:
        evs = list(_events)
    for e in evs:
        if e.get("ph") == "C":
            out.append({"name": e["name"], "ph": "C", "pid": pid, "tid": 0,
                        "ts": (e["t"] + shift) * 1e6,
                        "args": e.get("args", {})})
            continue
        ev = {"name": e["name"], "ph": "X", "pid": pid, "tid": e["tid"],
              "ts": (e["t0"] + shift) * 1e6,
              "dur": (e["t1"] - e["t0"]) * 1e6}
        if "args" in e:
            ev["args"] = e["args"]
        out.append(ev)
    return out


# ---------------------------------------------------------------------------
# request traces: trace contexts and per-server span rings
# ---------------------------------------------------------------------------

_trace_lock = threading.Lock()
_trace_seq = [0]


def mint_trace(parent=None):
    """A trace context: a JSON-safe ``{"trace_id": ...}`` (plus ``parent``
    when nesting), unique across processes (pid, a per-process sequence,
    wall ms).  ``None`` with telemetry or ``PADDLE_TPU_TRACE`` off, so no
    key ever rides a request then."""
    if not enabled() or not _flags.trace_enabled():
        return None
    with _trace_lock:
        _trace_seq[0] += 1
        seq = _trace_seq[0]
    ctx = {"trace_id": f"{os.getpid():x}-{seq:x}-"
                       f"{int(time.time() * 1e3) & 0xFFFFFFFF:x}"}
    if parent is not None:
        ctx["parent"] = parent
    return ctx


class SpanRing:
    """Bounded buffer of one server's COMPLETED trace spans, stamped in
    wall-clock seconds (``time.time``; the ``perf_counter`` stamps a call
    site holds are shifted by the clock offset at record time), so rings
    of several processes line up on one timeline.  A full ring drops new
    spans and counts them: loss is accounted, never silent."""

    __slots__ = ("_cap", "_spans", "_dropped", "_lock")

    def __init__(self, cap=None):
        self._cap = (_flags.trace_ring_spans() if cap is None
                     else max(1, int(cap)))
        self._spans: list = []
        self._dropped = 0
        self._lock = threading.Lock()

    def record(self, trace, name, t0, t1, **args) -> None:
        """Record the span ``[t0, t1]`` (``perf_counter`` seconds) under
        ``trace``; nothing without a trace context or with telemetry
        off."""
        if not trace or not enabled():
            return
        off = time.time() - time.perf_counter()
        sp = {"trace_id": trace.get("trace_id"), "name": name,
              "ts": t0 + off, "dur": max(0.0, t1 - t0)}
        if "parent" in trace:
            sp["parent"] = trace["parent"]
        if args:
            sp["args"] = dict(args)
        self.push(sp)
        _jsonl_write(dict(sp, ph="S"))

    def push(self, sp: dict) -> None:
        """Append one formed span; counts a drop when the ring is full."""
        with self._lock:
            if len(self._spans) >= self._cap:
                self._dropped += 1
            else:
                self._spans.append(sp)

    def drain(self, cap=None):
        """Take up to ``cap`` spans and the drops so far (the drop count
        resets with the take, so repeated takes sum exactly)."""
        with self._lock:
            if cap is None or cap >= len(self._spans):
                spans, self._spans = self._spans, []
            else:
                spans = self._spans[:cap]
                del self._spans[:cap]
            dropped, self._dropped = self._dropped, 0
        return spans, dropped

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)


def spans_to_chrome(spans, pid: int, name: str) -> list:
    """Wall-clock trace spans as Chrome 'X' events on one process track
    (one ``tid`` row per request id, the trace id in args)."""
    out = [{"name": "process_name", "ph": "M", "pid": pid,
            "args": {"name": name}}]
    for sp in spans:
        args = dict(sp.get("args", {}))
        tid = args.get("rid", 0)
        args["trace_id"] = sp.get("trace_id")
        out.append({"name": sp.get("name", "?"), "ph": "X", "pid": pid,
                    "tid": int(tid) if isinstance(tid, (int, float)) else 0,
                    "ts": float(sp.get("ts", 0.0)) * 1e6,
                    "dur": float(sp.get("dur", 0.0)) * 1e6, "args": args})
    return out


def _profiler_events(prof) -> tuple:
    """A finished ``torch.profiler.profile``'s Chrome-trace events and the
    wall-clock µs its timestamps count from (Kineto writes
    ``baseTimeNanoseconds`` beside µs timestamps relative to it)."""
    import tempfile

    fd, tmp = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(tmp)
        with open(tmp) as f:
            doc = json.load(f)
    finally:
        with contextlib.suppress(OSError):
            os.remove(tmp)
    return doc.get("traceEvents", []), doc.get("baseTimeNanoseconds", 0) / 1e3


def dump_chrome_trace(path: str, profiler=None, spans=None) -> str:
    """Write one Perfetto-loadable Chrome trace: the telemetry event ring
    (request lifecycles, builds, ladder moves) and ``spans`` (a server's
    drained trace spans) beside the events of ``profiler`` — a finished
    ``torch.profiler.profile``, host and card activity — on one wall
    clock.  Returns ``path``."""
    evs, base_us = ([], 0.0) if profiler is None \
        else _profiler_events(profiler)
    pids = [e["pid"] for e in evs if isinstance(e.get("pid"), int)]
    pid = max(pids, default=0) + 1
    # the ring counts perf_counter seconds; the profiler wall-clock µs
    # past base_us
    off = time.time() - time.perf_counter() - base_us / 1e6
    evs = list(evs) + chrome_events(pid=pid, shift=off)
    if spans:
        evs += [dict(e, ts=e["ts"] - base_us) if "ts" in e else e
                for e in spans_to_chrome(spans, pid + 1,
                                         "paddle_tpu_torch.spans")]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"traceEvents": evs, "displayTimeUnit": "ms"}, f)
    return path


# ---------------------------------------------------------------------------
# the recompile watch
# ---------------------------------------------------------------------------


def _strip_flags(key, flags_key):
    """``key`` with every (nested) occurrence of ``flags_key`` replaced by
    a sentinel: the config part of a step key (``engine.cfg_key`` embeds
    ``flags.decode_jit_key()`` as a sub-tuple)."""
    if key == flags_key:
        return "<flags>"
    if isinstance(key, tuple):
        return tuple(_strip_flags(k, flags_key) for k in key)
    return key


def _key_diff(old: tuple, new: tuple) -> str:
    if not (isinstance(old, tuple) and isinstance(new, tuple)
            and len(old) == len(new)):
        return f"{old!r} -> {new!r}"
    ds = [f"[{i}] {a!r} -> {b!r}" for i, (a, b) in
          enumerate(zip(old, new)) if a != b]
    return "; ".join(ds) or f"{old!r} -> {new!r}"


def record_compile(name: str, key, flags_key=None,
                   seconds: float | None = None) -> None:
    """Record one step build (the Engine's cache miss; on the card a CUDA
    graph capture): ``compile.count``, the ``compile.ms`` histogram, an
    event and a record in :func:`compile_log`.  The watch: when this
    (name, config part of ``key``) was built before under another
    ``flags_key``, a flag flipped mid-process forced the build —
    ``compile.recompiles`` counts it and a rate-limited
    ``RuntimeWarning`` names the diff.  A first build never warns."""
    if not enabled():
        return
    count("compile.count")
    if seconds is not None:
        hist("compile.ms").observe(seconds * 1e3)
        now = time.perf_counter()
        event(f"compile:{name}", now - seconds, now, key=repr(key))
    with _compile_lock:
        _compile_log.append({"name": name, "key": repr(key),
                             "seconds": None if seconds is None
                             else round(seconds, 4)})
        if flags_key is None:
            return
        base = (name, _strip_flags(key, flags_key))
        last = _compile_seen.get(base)
        _compile_seen[base] = flags_key
        if last is None or last == flags_key:
            return
        now = time.monotonic()
        rate_ok = now - _warn_last.get(name, -math.inf) >= _WARN_INTERVAL_S
        if rate_ok:
            _warn_last[name] = now
    count("compile.recompiles")
    if rate_ok:
        warnings.warn(
            f"[paddle_tpu_torch.telemetry] steady-state rebuild of "
            f"{name!r}: the flags key changed mid-process "
            f"({_key_diff(last, flags_key)}) — a captured step bakes these "
            f"in, so the flip forced a new capture (flags.decode_jit_key "
            f"discipline)", RuntimeWarning, stacklevel=3)


def compile_log() -> list:
    """The recompile watch's records, oldest first: one dict (name, key,
    seconds) a step build."""
    with _compile_lock:
        return [dict(r) for r in _compile_log]


# ---------------------------------------------------------------------------
# the cost count: a step's FLOPs and bytes, counted by shape as it runs once
# ---------------------------------------------------------------------------

_open_counts = 0         # counts open in the process: the hooks' one test
_open_lock = threading.Lock()
_mode_cls = None


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _cost_mode():
    """The ``TorchDispatchMode`` class of a count, built at its first use.

    Under it every aten op adds FLOPs from ``torch.utils.flop_counter``'s
    registry (the matmul family: mm, addmm, bmm, baddbmm, ...) and bytes:
    its tensor operands plus its results — the unfused reading of XLA's
    ``bytes accessed``.  An op whose result shares an operand's storage
    (a view, or a write in place: a cache row's ``index_copy_``) counts
    no bytes; an op that gathers rows of a source (embedding,
    ``index_select``, indexing, ``gather``) reads only the rows it
    returns.  Inside a kernel's hook (:func:`counted`) nothing is
    counted.  A failure in the count is kept on the mode, never raised:
    the step runs as it would without it."""
    global _mode_cls
    if _mode_cls is not None:
        return _mode_cls
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves
    from torch.utils.flop_counter import flop_registry

    aten = torch.ops.aten
    gathers = {aten.embedding, aten.index_select, aten.index, aten.gather}

    class _CostMode(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.flops = 0
            self.bytes = 0
            self.muted = 0          # open kernel hooks
            self.failed = None

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            if self.muted or self.failed is not None:
                return out
            try:
                packet = func._overloadpacket
                fl = flop_registry.get(packet)
                if fl is not None:
                    self.flops += int(fl(*args, **kwargs, out_val=out))
                ins = [t for t in tree_leaves((args, kwargs))
                       if isinstance(t, torch.Tensor)]
                outs = [t for t in tree_leaves(out)
                        if isinstance(t, torch.Tensor)]
                held = {t.untyped_storage().data_ptr() for t in ins}
                if any(o.untyped_storage().data_ptr() in held
                       for o in outs):
                    return out
                if packet in gathers:
                    self.bytes += sum(_nbytes(t) for t in ins[1:]) \
                        + 2 * sum(map(_nbytes, outs))
                else:
                    self.bytes += sum(map(_nbytes, ins)) \
                        + sum(map(_nbytes, outs))
            except Exception as e:  # noqa: BLE001 - never break the step
                self.failed = e
            return out

    _mode_cls = _CostMode
    return _mode_cls


def _active_count():
    """The count open on this thread (the innermost), or None."""
    if _mode_cls is None:
        return None
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

    for m in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(m, _mode_cls):
            return m
    return None


def counted(cost):
    """Decorate a kernel wrapper (or a site whose CPU branch is a kernel's
    plain math) with its cost hook: while a count is open on this thread,
    each call adds ``cost(*args, **kwargs)`` — the kernel's (FLOPs, bytes)
    for the call's inputs, from their shapes alone; ``cost`` takes the
    wrapper's signature — and counts nothing its body runs: the kernel's
    launch and allocations on the card, the plain twin's aten ops on the
    CPU, a hook nested inside.  So a step counts the same on both
    devices.  Outside a count a call pays one test."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            mode = _active_count() if _open_counts else None
            if mode is None or mode.muted:
                return fn(*args, **kwargs)
            if mode.failed is None:
                try:
                    f, b = cost(*args, **kwargs)
                    mode.flops += int(f)
                    mode.bytes += int(b)
                except Exception as e:  # noqa: BLE001 - never break a step
                    mode.failed = e
            mode.muted += 1
            try:
                return fn(*args, **kwargs)
            finally:
                mode.muted -= 1
        return call
    return wrap


def _tensors(tree) -> list:
    import torch
    from torch.utils._pytree import tree_leaves

    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def counted_call(fn, args=(), kwargs=None):
    """``fn(*args, **kwargs)`` run once; with the device feed on, under a
    count.  Returns (its output, the cost record or None): ``flops``,
    ``bytes_accessed``, ``argument_bytes`` (the distinct storages of the
    call's arguments: a step's params, cache and feeds), ``output_bytes``
    (its output tensors).  The count also
    names the device it ran on in the feed (a card's name outranks the
    CPU's).  A count never runs inside a CUDA graph capture."""
    global _open_counts
    kwargs = kwargs or {}
    if not _flags.device_feed_enabled():
        return fn(*args, **kwargs), None
    mode = _cost_mode()()
    with _open_lock:
        _open_counts += 1
    try:
        with mode:
            out = fn(*args, **kwargs)
    finally:
        with _open_lock:
            _open_counts -= 1
    rec = {"captured_at": time.time()}
    try:
        if mode.failed is not None:
            raise mode.failed
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        if mode.flops > 0:
            rec["flops"] = float(mode.flops)
        if mode.bytes > 0:
            rec["bytes_accessed"] = float(mode.bytes)
        rec["argument_bytes"] = sum({t.untyped_storage().data_ptr():
                                     t.untyped_storage().nbytes()
                                     for t in ins}.values())
        rec["output_bytes"] = sum({(t.data_ptr(), _nbytes(t)): _nbytes(t)
                                   for t in outs}.values())
        _note_device(ins + outs)
    except Exception as e:  # noqa: BLE001 - a failed count is a null feed
        rec = {"captured_at": rec["captured_at"],
               "count_failed": repr(e)[:200]}
    return out, rec


def _note_device(tensors) -> None:
    """The feed's platform and device kind from a counted step's tensors:
    a card's name replaces the CPU's, never the other way."""
    dev = next((t.device for t in tensors if t.is_cuda), None)
    with _device_lock:
        if dev is None:
            _device_info.setdefault("platform", "cpu")
            _device_info.setdefault("device_kind", "cpu")
            return
    import torch

    kind = torch.cuda.get_device_name(dev)
    with _device_lock:
        _device_info["platform"] = "gpu"
        _device_info["device_kind"] = kind


def _store_analysis(name: str, rec: dict) -> None:
    if len(rec) <= 1:  # nothing beyond the timestamp — keep the feed null
        return
    with _device_lock:
        prev = _step_analysis.get(name)
        rec["compiles"] = (prev.get("compiles", 0) + 1) if prev else 1
        _step_analysis[name] = rec
        # a new build owns the name now (another server's, another
        # config's): the old build's walls must not blend into its MFU
        _step_times.pop(name, None)
        # at most _ANALYSES names: the oldest capture goes first
        while len(_step_analysis) > _ANALYSES:
            oldest = min(_step_analysis,
                         key=lambda n: _step_analysis[n]["captured_at"])
            del _step_analysis[oldest]
            _step_times.pop(oldest, None)
            _skip_first_wall.discard(oldest)
        while len(_skip_first_wall) > 1024:  # names never noted
            _skip_first_wall.pop()


def record_build(name: str, key, flags_key, seconds: float,
                 cost: dict | None = None) -> None:
    """One step build (the Engine's graph capture or first eager call, an
    :func:`instrument_compile` wrapper's first call): the recompile
    watch's record, the first wall noted after it discarded (it
    overlapped the build), and ``cost`` (:func:`counted_call`'s record)
    stored under ``name`` for :func:`device_feed`."""
    record_compile(name, key, flags_key, seconds)
    if not enabled():
        return
    with _device_lock:
        _skip_first_wall.add(name)
    if cost is not None:
        _store_analysis(name, cost)


def instrument_compile(name: str, key, flags_key, fn):
    """Wrap a plain function: its first call is its build — counted
    (:func:`counted_call`), timed and recorded (:func:`record_build`);
    later calls pay one test.  Returns ``fn`` unchanged when telemetry is
    off.  ``wrapper._telemetry_inner`` is ``fn``."""
    if not enabled():
        return fn
    done = False

    @functools.wraps(fn)
    def wrapper(*a, **k):
        nonlocal done
        if done:
            return fn(*a, **k)
        t0 = time.perf_counter()
        out, rec = counted_call(fn, a, k)
        done = True
        record_build(name, key, flags_key, time.perf_counter() - t0, rec)
        return out

    wrapper._telemetry_inner = fn
    return wrapper


# ---------------------------------------------------------------------------
# the device feed
# ---------------------------------------------------------------------------


def note_step_time(name: str, seconds: float) -> None:
    """Feed one measured wall of step ``name`` into its EWMA (callers hold
    a wall that covers the card's work: a tick up to its token fetch, an
    admission up to its logits fetch).  The first wall after a build is
    discarded: it overlapped the build."""
    if not enabled() or seconds <= 0.0:
        return
    s = float(seconds)
    with _device_lock:
        if name in _skip_first_wall:
            _skip_first_wall.discard(name)
            return
        t = _step_times.get(name)
        if t is None:
            _step_times[name] = {"ewma_s": s, "last_s": s, "calls": 1}
        elif t["calls"] == 1 and t["ewma_s"] > 3.0 * s:
            # a first wall that was an outlier (a capture rode it):
            # restart the EWMA at the steady sample
            _step_times[name] = {"ewma_s": s, "last_s": s, "calls": 2}
        else:
            t["ewma_s"] += _STEP_EWMA_ALPHA * (s - t["ewma_s"])
            t["last_s"] = s
            t["calls"] += 1


def _card_memory(devices) -> dict:
    """``device{i}_bytes_in_use`` / ``_peak_bytes_in_use`` /
    ``_bytes_limit`` of each card (the caching allocator's live and peak
    bytes, the card's total memory), or of each object of ``devices``
    with a ``memory_stats()`` dict of those keys (tests pass fakes)."""
    out = {}
    if devices is None:
        import torch

        if not torch.cuda.is_available():
            return {}
        with _device_lock:
            if "platform" not in _device_info:
                _device_info["platform"] = "gpu"
                _device_info["device_kind"] = torch.cuda.get_device_name(0)
        for i in range(torch.cuda.device_count()):
            ms = torch.cuda.memory_stats(i)
            out[f"device{i}_bytes_in_use"] = int(
                ms.get("allocated_bytes.all.current", 0))
            out[f"device{i}_peak_bytes_in_use"] = int(
                ms.get("allocated_bytes.all.peak", 0))
            out[f"device{i}_bytes_limit"] = int(torch.cuda.mem_get_info(i)[1])
        return out
    for i, d in enumerate(devices):
        ms = d.memory_stats() or {}
        for k in ("bytes_in_use", "peak_bytes_in_use", "bytes_limit"):
            if k in ms:
                out[f"device{i}_{k}"] = ms[k]
    return out


def sample_device_stats(min_interval_s: float | None = None,
                        devices=None) -> dict:
    """The card memory sample of the hot paths, rate-limited to one a
    ``PADDLE_TPU_HBM_SAMPLE_MS`` (the last sample in between): the
    ``device.*`` gauges and a 'C' event on the timeline.  A host query,
    never a stream sync; {} without a card.  ``devices`` overrides the
    sampled cards (objects with ``memory_stats()``)."""
    if not _flags.device_feed_enabled():
        return {}
    now = time.monotonic()
    interval = (_flags.hbm_sample_interval_s() if min_interval_s is None
                else min_interval_s)
    with _device_lock:
        if now - _hbm_state["t"] < interval:
            return dict(_hbm_last)
        _hbm_state["t"] = now
    try:
        out = _card_memory(devices)
    except Exception:  # noqa: BLE001 - a failed query must not kill a tick
        return {}
    if not out:
        return {}
    for k, v in out.items():
        gauge(f"device.{k}").set(v)
    with _device_lock:
        _hbm_last.clear()
        _hbm_last.update(out)
    _counter_event("hbm", {k: v for k, v in out.items()
                           if "bytes_in_use" in k})
    return dict(out)


def device_feed() -> dict:
    """The device half of :func:`snapshot`: each step's cost record —
    ``flops``, ``bytes_accessed``, ``argument_bytes``, ``output_bytes``,
    ``temp_bytes`` (a graph's private pool, on the card), ``compiles`` —
    joined with its measured walls into ``step_s``, ``flops_per_s``,
    ``mfu``, ``bytes_per_s``, ``hbm_bw_util``, ``arithmetic_intensity``
    and ``bound`` ("compute" when the intensity reaches the card's peak
    FLOP/s over its peak bytes/s), and the last memory sample.

    FLOPs are the matmul family's and the kernels' (attention over the
    window a step is built for: every position a graph serves is a feed,
    so the count is the window's, not the live rows'); ``mfu`` is against
    the card's dense bf16 peak whatever the step's dtype, as in the JAX
    package.  Peaks come from ``framework.platform.DEVICE_PEAKS``: on the
    CPU or an unlisted card they, ``mfu``, ``hbm_bw_util`` and ``bound``
    are None.  A step with walls and no record (no build counted) has
    None cost fields."""
    from .framework import platform as _platform

    with _device_lock:
        info = dict(_device_info)
        analyses = {n: dict(r) for n, r in _step_analysis.items()}
        times = {n: dict(t) for n, t in _step_times.items()}
        hbm = dict(_hbm_last)
    peak_f, peak_bw = _platform.device_peaks(info.get("device_kind"),
                                             info.get("platform"))
    balance = (peak_f / peak_bw) if peak_f and peak_bw else None
    steps = {}
    for nm in sorted(set(analyses) | set(times)):
        rec = analyses.get(nm, {})
        s = {k: v for k, v in rec.items() if k != "captured_at"}
        flops = s.setdefault("flops", None)
        bts = s.setdefault("bytes_accessed", None)
        s["mfu"] = None
        s["bound"] = None
        if flops and bts:
            ai = flops / bts  # arithmetic intensity, FLOPs a byte
            s["arithmetic_intensity"] = round(ai, 3)
            if balance is not None:
                s["bound"] = "compute" if ai >= balance else "bandwidth"
        t = times.get(nm)
        if t and t.get("ewma_s", 0) > 0:
            s["step_s"] = round(t["ewma_s"], 6)
            s["step_calls"] = t["calls"]
            if flops:
                fps = flops / t["ewma_s"]
                s["flops_per_s"] = round(fps, 1)
                if peak_f:
                    s["mfu"] = fps / peak_f
            if bts:
                bps = bts / t["ewma_s"]
                s["bytes_per_s"] = round(bps, 1)
                if peak_bw:
                    s["hbm_bw_util"] = bps / peak_bw
        steps[nm] = s
    return {"platform": info.get("platform"),
            "device_kind": info.get("device_kind"),
            "peak_flops": peak_f, "peak_hbm_bytes_per_s": peak_bw,
            "steps": steps, "hbm": hbm}


# ---------------------------------------------------------------------------
# export: snapshot, Prometheus, health, profiles, the HTTP endpoint
# ---------------------------------------------------------------------------


def snapshot() -> dict:
    """One JSON-serializable dict: histogram summaries, gauges, counters,
    the recompile log, the device feed, the number of events in the ring
    and the wedge verdict."""
    with _lock:
        hists = sorted(_hists.items())
        gauges = sorted(_gauges.items())
        ctrs = dict(sorted(_counters.items()))
        n_events = len(_events)
    return {"enabled": enabled(),
            "histograms": {n: h.summary() for n, h in hists},
            "gauges": {n: g.get() for n, g in gauges},
            "counters": ctrs, "compiles": compile_log(),
            "device": device_feed(), "events": n_events,
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


def _prom_name(name: str) -> str:
    """The exposition name: ``paddle_tpu_`` + the name with every
    character but letters, digits and ``_`` made ``_``; a ``{k="v"}``
    label block is kept as it is."""
    base, brace, labels = name.partition("{")
    out = "".join(c if c.isalnum() or c == "_" else "_" for c in base)
    return "paddle_tpu_" + out + brace + labels


def render_prometheus() -> str:
    """Prometheus text exposition (v0.0.4) of the whole registry:
    histograms, gauges, counters, then the device feed's five labelled
    gauge families (``paddle_tpu_device_step_flops``,
    ``_step_bytes_accessed``, ``_step_mfu``, ``_step_hbm_bw_util``,
    ``_step_seconds``; ``{step="..."}``), in the JAX package's order."""
    with _lock:
        hists = sorted(_hists.items())
        gauges = sorted(_gauges.items())
        ctrs = sorted(_counters.items())
    lines = []
    for name, h in hists:
        pn = _prom_name(name)
        s = h.summary()
        lines.append(f"# TYPE {pn} histogram")
        for ub, cum in h.buckets():
            le = "+Inf" if ub == math.inf else f"{ub:.6g}"
            lines.append(f'{pn}_bucket{{le="{le}"}} {cum}')
        lines.append(f"{pn}_sum {s['sum']:.6g}")
        lines.append(f"{pn}_count {s['count']}")
    for name, g in gauges:
        pn = _prom_name(name)
        lines.append(f"# TYPE {pn} gauge")
        lines.append(f"{pn} {g.get():.6g}")
    for name, v in ctrs:
        pn = _prom_name(name)
        lines.append(f"# TYPE {pn.partition('{')[0]} counter")
        lines.append(f"{pn} {v}")
    # the device feed: per-step cost, MFU and roofline as labelled gauges
    # (a null — an unknown card — is absent, never a fabricated 0)
    steps = device_feed()["steps"]
    for metric, field in (("step_flops", "flops"),
                          ("step_bytes_accessed", "bytes_accessed"),
                          ("step_mfu", "mfu"),
                          ("step_hbm_bw_util", "hbm_bw_util"),
                          ("step_seconds", "step_s")):
        rows = [(nm, s[field]) for nm, s in steps.items()
                if s.get(field) is not None]
        if rows:
            lines.append(f"# TYPE paddle_tpu_device_{metric} gauge")
            lines.extend(f'paddle_tpu_device_{metric}{{step="{nm}"}} {v:.6g}'
                         for nm, v in rows)
    return "\n".join(lines) + "\n"


def probe_health(path: str | None = None,
                 wedge_window_s: float | None = None) -> dict:
    """The accelerator probe log's verdict: the last JSON line of the log
    at ``path`` or ``PADDLE_TPU_PROBE_LOG`` (``{"ts": ISO time, "ok":
    bool, ...}``, appended by a probe process).  ``ok`` — the last probe
    was healthy and within the window; ``wedged`` — it failed within the
    window; ``stale`` — it is older than the window
    (``PADDLE_TPU_WEDGE_TTL_S``, 1800 s), evidence of nothing; ``unknown``
    — no log.  Unlike the JAX package no log is looked for in the
    checkout: that one records another machine."""
    if wedge_window_s is None:
        wedge_window_s = _flags.wedge_evidence_ttl_s()
    path = path or os.environ.get("PADDLE_TPU_PROBE_LOG") or None
    if path is None:
        return {"status": "unknown", "log": None, "last_probe": None}
    last = None
    try:
        # only the last entry matters: read a bounded tail
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            f.seek(max(0, f.tell() - 65536))
            tail = f.read().decode("utf-8", errors="replace")
    except OSError:
        return {"status": "unknown", "log": path, "last_probe": None}
    for line in tail.splitlines():
        line = line.strip()
        if line:
            with contextlib.suppress(json.JSONDecodeError):
                rec = json.loads(line)
                if isinstance(rec, dict):
                    last = rec
    if last is None:
        return {"status": "unknown", "log": path, "last_probe": None}
    age = None
    with contextlib.suppress(Exception):
        import datetime

        age = (datetime.datetime.now(datetime.timezone.utc)
               - datetime.datetime.fromisoformat(str(last.get("ts")))
               ).total_seconds()
    fresh = age is not None and 0 <= age <= wedge_window_s
    if last.get("ok"):
        status = "ok" if fresh else "stale"
    else:
        status = "wedged" if fresh else "stale"
    return {"status": status, "log": path, "last_probe": last,
            "age_s": None if age is None else round(age, 1)}


_profile_lock = threading.Lock()


def capture_device_profile(ms: float = 500.0,
                           out_dir: str | None = None) -> str:
    """Trace ``ms`` milliseconds of whatever runs (the serving threads
    keep ticking; only the caller waits) with ``torch.profiler``, host
    and, on a card, CUDA activity, into ``<out_dir>/trace.json``
    (``PADDLE_TPU_PROFILE_DIR`` or a fresh temporary directory).  Returns
    the directory.  One capture at a time: a second raises."""
    ms = float(ms)
    if not 0 < ms <= 60_000:
        raise ValueError(f"profile window must be in (0, 60000] ms, "
                         f"got {ms}")
    if not _profile_lock.acquire(blocking=False):
        raise RuntimeError("a device profile capture is already running")
    try:
        import tempfile

        import torch
        from torch.profiler import ProfilerActivity, profile

        out_dir = (out_dir or os.environ.get("PADDLE_TPU_PROFILE_DIR")
                   or tempfile.mkdtemp(prefix="paddle_tpu_torch_trace_"))
        os.makedirs(out_dir, exist_ok=True)
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        # the window itself lands on the timeline: which requests it saw
        with span("profiler.capture", dir=out_dir, ms=ms):
            with profile(activities=acts) as prof:
                time.sleep(ms / 1e3)
        prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
        return out_dir
    finally:
        _profile_lock.release()


class MetricsServer:
    """A small HTTP endpoint: ``GET /metrics`` (Prometheus text), ``GET
    /snapshot`` (JSON), ``GET /healthz`` (the probe log's and the wedge
    watchdog's verdicts, the device feed and the admission block; 503
    while either says wedged) and ``POST /profile?ms=500`` (a
    ``torch.profiler`` capture around live traffic; returns its
    directory).  Threaded, daemon; ``port=0`` takes a free port
    (``.port``).  Binds loopback by default: the endpoint has no
    authentication, so ``host="0.0.0.0"`` is an explicit choice.
    ``render``/``snap`` override what ``/metrics`` and ``/snapshot``
    serve."""

    def __init__(self, port: int, host: str = "127.0.0.1",
                 render=None, snap=None):
        import http.server

        render_fn = render if render is not None else render_prometheus
        snap_fn = snap if snap is not None else snapshot

        class Handler(http.server.BaseHTTPRequestHandler):
            def _reply(self_h, code, body, ctype):  # noqa: N805
                self_h.send_response(code)
                self_h.send_header("Content-Type", ctype)
                self_h.send_header("Content-Length", str(len(body)))
                self_h.end_headers()
                self_h.wfile.write(body)

            def do_GET(self_h):  # noqa: N805
                if self_h.path.startswith("/snapshot"):
                    self_h._reply(200, json.dumps(snap_fn()).encode(),
                                  "application/json")
                elif self_h.path.startswith("/healthz"):
                    probe = probe_health()
                    feed = device_feed()
                    wedge = runtime_wedge()
                    healthy = (probe["status"] != "wedged"
                               and not wedge["wedged"])
                    body = json.dumps({
                        "ok": healthy, "telemetry_enabled": enabled(),
                        "device_feed_enabled": _flags.device_feed_enabled(),
                        "probe": probe, "runtime_wedge": wedge,
                        "platform": feed["platform"],
                        "device_kind": feed["device_kind"],
                        "instrumented_steps": sorted(
                            n for n, st in feed["steps"].items()
                            if "compiles" in st),
                        "hbm": feed["hbm"],
                        "admission": admission_snapshot()}).encode()
                    # a probe that reads no body needs a non-2xx
                    self_h._reply(200 if healthy else 503, body,
                                  "application/json")
                elif self_h.path.startswith("/metrics") \
                        or self_h.path == "/":
                    self_h._reply(200, render_fn().encode(),
                                  "text/plain; version=0.0.4")
                else:
                    self_h.send_error(404)

            def do_POST(self_h):  # noqa: N805
                if not self_h.path.startswith("/profile"):
                    self_h.send_error(404)
                    return
                from urllib.parse import parse_qs, urlparse

                q = parse_qs(urlparse(self_h.path).query)
                try:
                    ms = float(q.get("ms", ["500"])[0])
                    # the client names no directory: the endpoint has no
                    # authentication, so the write target stays ours
                    trace_dir = capture_device_profile(ms)
                except ValueError as e:
                    code, body = 400, {"error": str(e)}
                except RuntimeError as e:      # a capture is running
                    code, body = 409, {"error": str(e)}
                except Exception as e:  # noqa: BLE001 - report, don't die
                    code, body = 500, {"error": f"{type(e).__name__}: {e}"}
                else:
                    code, body = 200, {"trace_dir": trace_dir, "ms": ms}
                self_h._reply(code, json.dumps(body).encode(),
                              "application/json")

            def log_message(self_h, *a):  # noqa: N805 - quiet by design
                pass

        self._httpd = http.server.ThreadingHTTPServer((host, int(port)),
                                                      Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="paddle-tpu-torch-metrics",
                                        daemon=True)
        self._thread.start()

    def close(self):
        """Stop serving and join the thread (bounded)."""
        with contextlib.suppress(Exception):
            self._httpd.shutdown()
            self._httpd.server_close()
        with contextlib.suppress(Exception):
            if self._thread.is_alive():
                self._thread.join(timeout=5.0)


def serve_metrics(port: int, host: str = "127.0.0.1",
                  render=None, snap=None) -> MetricsServer:
    """Start the metrics endpoint (``DecodeServer(metrics_port=...)`` calls
    this)."""
    return MetricsServer(port, host, render=render, snap=snap)
