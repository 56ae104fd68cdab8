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
* the device feed: :func:`note_step_time` (per-step walls) and
  :func:`sample_device_stats` (the card's memory, read from
  ``torch.cuda.memory_stats`` / ``torch.cuda.mem_get_info`` into the
  ``device.*`` gauges), joined by :func:`device_feed`.  The JAX package
  also reads XLA's cost and memory analyses of each compiled step into
  FLOPs, bytes, MFU and a roofline verdict; the port has no counterpart
  yet, so those fields are ``None`` — what the JAX package reports for a
  chip it does not know;
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
    "runtime_wedge", "record_compile", "compile_log", "note_step_time",
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

# the device feed: per-step wall EWMAs and the last card memory sample
_device_lock = threading.Lock()
_step_times: dict[str, dict] = {}
_device_info: dict = {}
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
    verdict is left alone (:func:`clear_runtime_wedge`)."""
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
        _step_times.clear()
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
# the device feed
# ---------------------------------------------------------------------------


def note_step_time(name: str, seconds: float) -> None:
    """Feed one measured wall of step ``name`` into its EWMA (callers hold
    a wall that covers the card's work: a tick up to its token fetch, an
    admission up to its logits fetch)."""
    if not enabled() or seconds <= 0.0:
        return
    s = float(seconds)
    with _device_lock:
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
    """The device half of :func:`snapshot`: each step's wall EWMA and the
    last memory sample.  ``flops``, ``bytes_accessed``, ``mfu`` and
    ``bound`` are ``None``: the port reads no per-step cost analysis
    yet."""
    with _device_lock:
        info = dict(_device_info)
        times = {n: dict(t) for n, t in _step_times.items()}
        hbm = dict(_hbm_last)
    steps = {nm: {"step_s": round(t["ewma_s"], 6), "step_calls": t["calls"],
                  "flops": None, "bytes_accessed": None, "mfu": None,
                  "bound": None}
             for nm, t in sorted(times.items())}
    return {"platform": info.get("platform"),
            "device_kind": info.get("device_kind"),
            "peak_flops": None, "peak_hbm_bytes_per_s": None,
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
    histograms, gauges, counters, then each step's wall as
    ``paddle_tpu_device_step_seconds{step="..."}``."""
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
    steps = device_feed()["steps"]
    if steps:
        lines.append("# TYPE paddle_tpu_device_step_seconds gauge")
        lines.extend(f'paddle_tpu_device_step_seconds{{step="{nm}"}} '
                     f'{s["step_s"]:.6g}' for nm, s in steps.items())
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
                        "instrumented_steps": sorted(feed["steps"]),
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
