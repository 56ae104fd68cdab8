"""Disaggregated serving fleet: prefill workers, the KV handoff, a router.

Counterpart of ``paddle_tpu/text/fleet.py``.  Three legs over the port's
``DecodeServer`` (``text/serving.py``):

* **Prefill/decode disaggregation** — :class:`PrefillWorker` runs
  admission prefill off the token loop: the same Engine kinds a decode
  replica runs locally (``prefill`` per bucket, ``paged_prefill`` per
  chunk width; streamed, ``prefill_chunk@W`` / ``paged_prefill@W``) on a
  one-slot cache of its own, on a CUDA stream of its own, so its prefill
  overlaps the replicas' decode replays on the same card.  It hands the
  finished cache rows and the admission logits back over a transport
  (:class:`LoopbackTransport` in process, :class:`SocketTransport` TCP
  frames across processes); the replica writes them into a slot through
  its graphed ``inject`` step (``DecodeServer.adopt_request`` /
  ``submit_prefilled``; streamed, ``stream_prefilled_*``), and decode goes
  on bit for bit as after a local admission.
* **A multi-replica** :class:`Router` — admission and priority at a fleet
  queue with TTL and queue-cap sheds, load balancing on the quantities
  the telemetry gauges sample (queue depth, admitting slots, slot
  occupancy, KV utilization: ``DecodeServer.load_stats``) led by a prefix
  affinity with an imbalance cap, a wedged replica drained and its queued
  work re-routed, live ``add_replica`` / ``remove_replica`` and an
  autoscale loop over registered spares, ``healthz``, an admission
  controller of its own that takes in the replicas' rungs, and replica
  ticks fanned out over a thread pool.
* **The trace plane** — every request's spans (router queue wait and
  route, worker prefill chunks, replica inject / decode / retire) under
  one trace id, collected into per-source tracks (``fleet_trace``,
  ``dump_fleet_trace``), and the fleet-merged metrics
  (``fleet_snapshot``, ``render_fleet_prometheus``: replica histograms
  merged by exact bucket addition).

Rows on the card.  A worker's rows are copies, never views of its cache
(its next job reuses the slot).  Over a loopback they stay card tensors
— the worker and the replicas share the card — and the message carries
a CUDA event recorded once they are final.  The worker's thread waits for
that event before it sends (a streamed chunk's wait overlaps the next
chunk's compute), so a replica never stalls its decode stream on the
worker's compute; the replica's stream still waits on the event before the
``inject`` replay and records the rows on itself, so the allocator cannot
hand their memory back to the worker early.  Over a socket the worker
copies them into pinned host memory first.

Threads.  The router ticks its replicas concurrently (a barrier a round)
beside the worker's thread; the kernel wrappers' launch counters are
safe across threads (``ops/_counts.py``), Engine captures are serialized,
and each capture takes the side stream of its calling stream, so the
worker's graphs never share a tick ticket buffer with the replicas'.
Capture every graph before the threads start: ``DecodeServer.warmup``
on each replica and :meth:`PrefillWorker.warmup`, then build the Router,
which warms the replicas' ``inject`` steps at the workers' lengths.

The wire codec is the reference's: a JSON header (the object tree with
each tensor replaced by a ``{"__nd__", "shape", "dtype"}`` descriptor,
the reference's dtype names) and one raw buffer frame a tensor, rebuilt
with ``torch.frombuffer``.  Nothing on the wire is pickled: an unknown
type raises.  The link carries model activations between co-owned
processes; never expose a transport port beyond them.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import json
import os
import queue
import socket
import struct
import threading
import time

import numpy as np
import torch

from . import admission as _admission
from . import engine as _engine
from . import generate, gpt, kv_pool as _kv, serving
from .. import flags as _flags
from .. import resilience as _resilience
from .. import resolve_device
from .. import telemetry as _telemetry
from ..ops import _counts as _launch_counts

__all__ = [
    "LoopbackTransport", "SocketTransport", "PrefillWorker", "Router",
    "serve_prefill_worker",
]


# ---------------------------------------------------------------------------
# transports: one message-passing shape, two fabrics
# ---------------------------------------------------------------------------


class _QueueEndpoint:
    """One side of an in-process transport (a pair of ``queue.Queue``)."""

    def __init__(self, send_q: queue.Queue, recv_q: queue.Queue):
        self._send = send_q
        self._recv = recv_q

    def send(self, obj) -> None:
        self._send.put(obj)

    def recv(self, timeout: float = 0.0):
        """Next message, or None when none arrives within ``timeout``."""
        try:
            if timeout and timeout > 0:
                return self._recv.get(timeout=timeout)
            return self._recv.get_nowait()
        except queue.Empty:
            return None

    def close(self) -> None:
        pass


class LoopbackTransport:
    """In-process endpoint pair: ``.client`` is the router's side,
    ``.worker`` the prefill worker's — messages pass by reference."""

    def __init__(self):
        a, b = queue.Queue(), queue.Queue()
        self.client = _QueueEndpoint(a, b)
        self.worker = _QueueEndpoint(b, a)


# a frame (or a headered message awaiting its buffer frames) the peer
# started but did not finish within this budget is a dead link
_FRAME_BUDGET_S = 30.0

# typed wire frames: 1-byte frame type + 8-byte big-endian body length.
# A message is ONE header frame (JSON) followed by header["nbufs"] raw
# buffer frames, one a tensor descriptor, in index order
_F_HDR = 1
_F_BUF = 2
_FRAME_PREFIX = struct.Struct(">BQ")

# iovecs one sendmsg call takes at most (POSIX IOV_MAX is commonly 1024)
_SENDMSG_MAX_FRAMES = 512

# the wire's dtype names (the reference's numpy names) and their tensors
_WIRE_DTYPES = {name: getattr(torch, name) for name in (
    "float32", "float64", "float16", "bfloat16", "int8", "uint8", "int16",
    "int32", "int64", "bool")}


def _send_frames(sock: socket.socket, frames: list) -> None:
    """One gathered write for a whole message: the frame prefixes, the
    header and every buffer frame go down in one ``sendmsg`` call (the
    bytes are those of a frame-by-frame write).  A partial send resumes
    at its exact offset; without ``sendmsg``, one ``sendall`` a frame."""
    if not hasattr(sock, "sendmsg"):
        for f in frames:
            sock.sendall(f)
        return
    views = []
    for f in frames:
        mv = f if isinstance(f, memoryview) else memoryview(f)
        views.append(mv.cast("B") if mv.ndim != 1 or mv.format != "B"
                     else mv)
    while views:
        try:
            sent = sock.sendmsg(views[:_SENDMSG_MAX_FRAMES])
        except InterruptedError:
            continue
        while views and sent >= views[0].nbytes:
            sent -= views[0].nbytes
            views.pop(0)
        if views and sent:
            views[0] = views[0][sent:]


def _frame_view(t) -> memoryview:
    """The raw bytes of one contiguous host tensor as a flat uint8
    memoryview — no copy."""
    return memoryview(t.reshape(-1).view(torch.uint8).numpy())


def _encode_msg(obj):
    """Split one message into (json header bytes, [host buffer, ...]).

    The header is the object tree with each tensor leaf replaced by a
    buffer descriptor; the buffers ride apart as raw frames, each a
    contiguous host tensor (a card tensor is copied to the host here).
    Only JSON scalars, lists/tuples, str-keyed dicts and tensors are
    legal — anything else raises (never a pickle)."""
    bufs: list = []

    def enc(v):
        if isinstance(v, torch.Tensor):
            a = v.detach().to("cpu").contiguous()
            name = str(a.dtype).rsplit(".", 1)[-1]
            if name not in _WIRE_DTYPES:
                raise TypeError(f"dtype {name} is not transportable")
            bufs.append(a)
            return {"__nd__": len(bufs) - 1,
                    "shape": list(a.shape), "dtype": name}
        if isinstance(v, np.generic):
            return v.item()
        if isinstance(v, dict):
            if any(not isinstance(k, str) for k in v):
                raise TypeError("transport dict keys must be str")
            return {k: enc(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [enc(x) for x in v]
        if v is None or isinstance(v, (bool, int, float, str)):
            return v
        raise TypeError(
            f"type {type(v).__name__} is not transportable (the wire "
            f"carries JSON scalars + raw tensor frames, never pickle)")

    tree = enc(obj)
    hdr = json.dumps({"o": tree, "nbufs": len(bufs)},
                     separators=(",", ":")).encode("utf-8")
    return hdr, bufs


def _decode_msg(hdr: bytes, bufs: list):
    """Inverse of :func:`_encode_msg`: rebuild the object tree, each
    received (writable) buffer wrapped as a CPU tensor
    (``torch.frombuffer``, no copy)."""
    top = json.loads(hdr.decode("utf-8"))

    def dec(v):
        if isinstance(v, dict):
            if "__nd__" in v:
                dt = _WIRE_DTYPES.get(v["dtype"])
                if dt is None:
                    raise ConnectionError(
                        f"unknown transport dtype {v['dtype']!r}")
                buf = bufs[v["__nd__"]]
                if len(buf) == 0:
                    return torch.empty(v["shape"], dtype=dt)
                return torch.frombuffer(buf, dtype=dt).reshape(v["shape"])
            return {k: dec(x) for k, x in v.items()}
        if isinstance(v, list):
            return [dec(x) for x in v]
        return v

    if len(bufs) != top.get("nbufs", 0):
        raise ConnectionError(
            f"transport message carried {len(bufs)} buffer frames, "
            f"header promised {top.get('nbufs', 0)}")
    return dec(top["o"])


class _SocketEndpoint:
    """Typed frames over one TCP socket (the loopback endpoint's send /
    recv surface).  Writes are locked (whole messages); reads keep partial
    frames and partly received messages across ``recv`` calls, so a poll
    timeout never tears either."""

    def __init__(self, sock: socket.socket):
        self._sock = sock
        self._wlock = threading.Lock()
        self._buf = bytearray()
        self._scratch = bytearray(1 << 20)   # recv_into target, reused
        self._hdr: bytes | None = None   # parsed header awaiting buffers
        self._need = 0                   # buffer frames still expected
        self._bufs: list = []            # buffer frames received so far

    def send(self, obj) -> None:
        hdr, arrs = _encode_msg(obj)
        frames = [_FRAME_PREFIX.pack(_F_HDR, len(hdr)), hdr]
        for a in arrs:
            # the tensor's own bytes feed the socket: no serializer, no
            # intermediate bytes object
            mv = _frame_view(a)
            frames.append(_FRAME_PREFIX.pack(_F_BUF, mv.nbytes))
            frames.append(mv)
        with self._wlock:
            _send_frames(self._sock, frames)
        if _telemetry.enabled():
            _telemetry.count("fleet.frame_batches")

    def _pop_frame(self):
        """(ftype, body) of the next complete frame in the read buffer,
        or None; a buffer frame's body is a fresh writable bytearray."""
        if len(self._buf) < 9:
            return None
        ftype, ln = _FRAME_PREFIX.unpack_from(self._buf)
        if len(self._buf) < 9 + ln:
            return None
        body = bytearray(self._buf[9:9 + ln])
        del self._buf[:9 + ln]
        return ftype, body

    def _pump(self):
        """Fold complete frames into the message assembler; returns a
        finished message's decoded object, else None."""
        while True:
            fr = self._pop_frame()
            if fr is None:
                return None
            ftype, body = fr
            if ftype == _F_HDR:
                if self._hdr is not None:
                    raise ConnectionError(
                        "transport header frame arrived mid-message")
                try:
                    need = json.loads(bytes(body).decode("utf-8")).get(
                        "nbufs", 0)
                except (ValueError, UnicodeDecodeError) as e:
                    raise ConnectionError(
                        f"malformed transport header: {e}") from e
                if need == 0:
                    return _decode_msg(bytes(body), [])
                self._hdr, self._need, self._bufs = bytes(body), need, []
            elif ftype == _F_BUF:
                if self._hdr is None:
                    raise ConnectionError(
                        "transport buffer frame without a header")
                self._bufs.append(body)
                if len(self._bufs) == self._need:
                    hdr, bufs = self._hdr, self._bufs
                    self._hdr, self._need, self._bufs = None, 0, []
                    return _decode_msg(hdr, bufs)
            else:
                raise ConnectionError(
                    f"unknown transport frame type {ftype}")

    def recv(self, timeout: float = 0.0):
        deadline = time.perf_counter() + max(float(timeout), 0.0)
        frame_deadline = None
        tried = False
        while True:
            msg = self._pump()
            if msg is not None:
                return msg
            mid = bool(self._buf) or self._hdr is not None
            if mid and frame_deadline is None:
                # any partial frame or unfinished message arms the budget
                frame_deadline = time.perf_counter() + _FRAME_BUDGET_S
            rem = deadline - time.perf_counter()
            if mid:
                # mid-message: wait for the rest (bounded by the frame
                # budget), even past the caller's poll timeout
                rem = max(rem, 0.05)
                if time.perf_counter() > frame_deadline:
                    raise ConnectionError(
                        "torn transport frame (peer died mid-send?)")
            elif rem <= 0 and tried:
                # timeout 0 is a poll: one non-blocking read runs first
                return None
            tried = True
            self._sock.settimeout(max(rem, 1e-3))
            try:
                n = self._sock.recv_into(self._scratch)
            except socket.timeout:
                continue
            except ConnectionError:
                raise
            except OSError as e:
                # a reset peer raises like a closed one, never reads idle
                raise ConnectionError(
                    f"transport socket error: {e}") from e
            if not n:
                # orderly shutdown: the peer is gone, not idle
                raise ConnectionError(
                    "transport closed mid-frame" if mid
                    else "transport closed by peer")
            self._buf += memoryview(self._scratch)[:n]

    def close(self) -> None:
        with contextlib.suppress(OSError):
            self._sock.close()


class _SocketListener:
    def __init__(self, srv: socket.socket):
        self._srv = srv
        self.port = srv.getsockname()[1]

    def accept(self, timeout: float = 30.0) -> _SocketEndpoint:
        self._srv.settimeout(timeout)
        sock, _ = self._srv.accept()
        return _SocketEndpoint(sock)

    def close(self) -> None:
        with contextlib.suppress(OSError):
            self._srv.close()


class SocketTransport:
    """TCP transport for fleets across processes: ``listen`` on the
    worker's host, ``connect`` from the router.  Frames are JSON headers
    and raw buffer frames (never pickle); bind loopback unless the
    processes share a trust domain beyond it."""

    @staticmethod
    def listen(host: str = "127.0.0.1", port: int = 0) -> _SocketListener:
        srv = socket.create_server((host, int(port)))
        return _SocketListener(srv)

    @staticmethod
    def connect(host: str, port: int,
                timeout: float = 30.0) -> _SocketEndpoint:
        return _SocketEndpoint(
            socket.create_connection((host, int(port)), timeout=timeout))


# ---------------------------------------------------------------------------
# prefill worker: admission prefill off the token loop
# ---------------------------------------------------------------------------


class PrefillWorker:
    """A dedicated prefill engine: one slot and the Engine kinds a
    ``DecodeServer`` runs for its own admission, so the rows it hands a
    replica decode bit for bit as local admission's would.

    ``layout`` must be the replicas' (the layouts' prefill math differs);
    ``device`` defaults to the card, where the worker runs on a CUDA
    stream of its own (``params`` must live there).  Drive it
    cooperatively (:meth:`run_once`) or on a daemon thread
    (:meth:`start`), consuming ``{"rid", "prompt"}`` jobs from
    ``endpoint`` and answering ``{"rid", "rows", "logits"}`` (or
    ``{"rid", "error"}``; streamed, ``{"op": "chunk", ...}``)."""

    def __init__(self, params, cfg: gpt.GPTConfig, max_len: int,
                 layout: str | None = None, block_size: int | None = None,
                 endpoint=None, device=None, name: str = "prefill"):
        lay = layout if layout is not None else _flags.kv_layout()
        if lay not in ("contiguous", "paged"):
            raise ValueError(
                f"layout {lay!r}: expected 'contiguous' or 'paged'")
        self.device = resolve_device(device)
        if params["wte"].device != self.device:
            raise ValueError(f"params live on {params['wte'].device}, the "
                             f"worker was asked to run on {self.device}")
        self.cfg = cfg
        self.params = params
        self.max_len = int(max_len)
        self.name = name
        self.endpoint = endpoint
        self._paged = lay == "paged"
        self.cache = generate.init_cache(cfg, 1, max_len, self.device,
                                         layout=lay, block_size=block_size)
        self._pool = (_kv.PagedAllocator(*_kv._geometry(self.cache), 1)
                      if self._paged else None)
        self._bind = _engine.Binding(params, self.cache)
        self._cuda = self.device.type == "cuda"
        # the worker's own stream: its prefill overlaps the replicas'
        # decode replays on the default stream
        self._stream = torch.cuda.Stream(self.device) if self._cuda else None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.warm_lens: list[int] | None = None    # set by warmup()
        self._tel = _telemetry.enabled()
        # fleet tracing: this worker's completed spans, drained onto the
        # replies it already sends
        self._span_ring = _telemetry.SpanRing()

    # -- device helpers ---------------------------------------------------

    def _on_stream(self):
        return (torch.cuda.stream(self._stream) if self._stream is not None
                else contextlib.nullcontext())

    def _host(self, arr):
        t = torch.from_numpy(np.ascontiguousarray(arr))
        return t.pin_memory() if self._cuda else t

    def _feeds(self, tokens, width: int, *scalars) -> tuple:
        """The admission feeds ``DecodeServer._feeds`` builds: tokens
        [1, width] int64 (0-padded) and each scalar as an int64 [1]."""
        padded = np.zeros((1, width), np.int64)
        padded[0, :len(tokens)] = tokens
        return (self._host(padded),
                *(self._host(np.array([v], np.int64)) for v in scalars))

    def _spec(self, **kw) -> _engine.StepSpec:
        return _engine.StepSpec(cfg=self.cfg, paged=self._paged,
                                payload=self._bind, **kw)

    def _window(self) -> int:
        return min(self.max_len, self.cfg.max_seq_len)

    def _bucket(self, n: int) -> int:
        """The decode replica's own admission width for a fresh n-token
        prompt: the power-of-two bucket; paged, floored at the block size
        (the suffix rule at no shared prefix)."""
        window = self._window()
        if self._paged:
            return min(max(serving._pow2_bucket(n), self._pool.bs), window)
        return serving._pow2_bucket(n, self.max_len, self.cfg.max_seq_len)

    def _chunk_width(self, chunk_rows) -> int:
        window = self._window()
        C = (int(chunk_rows) if chunk_rows is not None
             else _flags.stream_chunk_rows())
        W = serving._pow2_bucket(max(1, min(C, window)), window)
        if self._paged:
            W = min(max(W, self._pool.bs), window)
        return W

    def _map_rows(self, n: int):
        """Paged: map the slot's rows [0, n) and push its table."""
        self._pool.ensure_rows(0, 0, n)
        self.cache["tables"].copy_(self._host(self._pool.tables),
                                   non_blocking=True)
        self._pool.dirty = False

    def _take_rows(self, lo: int, hi: int) -> dict:
        """Copies (never views: the slot's next job rewrites it) of the
        slot's rows [lo, hi) per cache leaf, [L, 1, hi - lo, Hkv(, hd)],
        on the worker's stream."""
        out = {}
        if self._paged:
            bs = self._pool.bs
            tb = self._pool.tables[0]
            phys = torch.as_tensor(
                [int(tb[i // bs]) * bs + i % bs for i in range(lo, hi)],
                dtype=torch.long).to(self.device, non_blocking=True)
        for name, arr in self.cache.items():
            if name == "tables":
                continue
            if self._paged:
                flat = arr.view((arr.shape[0], -1) + arr.shape[3:])
                out[name] = flat.index_select(1, phys).unsqueeze(1)
            else:
                out[name] = arr[:, 0:1, lo:hi].clone()
        return out

    def _ship(self, rows: dict, logits, host: bool):
        """Rows (and logits) on their way out of the worker, and the event
        they are final at, on the worker's stream: ``host`` starts their
        copies into pinned host memory (a socket link), else they stay
        card tensors.  Returns (rows, logits, event); no event on the
        CPU."""
        if not self._cuda:
            return rows, logits, None
        if host:
            def pinned(t):
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                return h.copy_(t, non_blocking=True)

            rows = {name: pinned(t) for name, t in rows.items()}
            logits = pinned(logits) if logits is not None else None
        ev = torch.cuda.Event()
        ev.record(self._stream)
        return rows, logits, ev

    # -- prefill ----------------------------------------------------------

    def warmup(self, prompt_lens=None, chunk_rows=None) -> dict:
        """Build (on the card: capture, from the worker's stream) every
        step this worker will run before its first job: the admission step
        at the width of each of ``prompt_lens`` (default every bucket up
        to its window) and the streamed walk's chunk step
        (``chunk_rows``, default ``PADDLE_TPU_STREAM_CHUNK_ROWS``; none at
        0).  The steps write row 0 of the worker's own slot; the kernels'
        launch counters do not move.  A Router built over this worker
        afterwards warms its replicas' ``inject`` steps at the same
        prompt lengths.  Returns {step: seconds}."""
        window = self._window()
        lens = prompt_lens if prompt_lens is not None else [
            1 << i for i in range(window.bit_length() + 1)
            if (1 << i) <= window]
        self.warm_lens = sorted({int(n) for n in lens})
        kind = "paged_prefill" if self._paged else "prefill"
        warm = [(kind, {"bucket": w}) for w in
                sorted({self._bucket(int(n)) for n in lens})]
        C = (int(chunk_rows) if chunk_rows is not None
             else _flags.stream_chunk_rows())
        if C > 0:
            W = self._chunk_width(C)
            warm.append(("paged_prefill", {"bucket": W}) if self._paged
                        else ("prefill_chunk", {"width": W}))
        timings = {}
        with _launch_counts.held(), self._on_stream():
            for kind, kw in dict.fromkeys(
                    (k, tuple(kw.items())) for k, kw in warm):
                kw = dict(kw)
                width = kw.get("bucket") or kw.get("width")
                t0 = time.perf_counter()
                fn = _engine.ENGINE.get(kind, self._spec(**kw))
                if kind == "prefill":
                    fn(*self._feeds([0], width, 1, 0))
                else:
                    fn(*self._feeds([0], width, 0, 1, 0))
                if self._cuda:
                    self._stream.synchronize()
                timings[f"{kind}@{width}"] = time.perf_counter() - t0
        return timings

    def _prefill(self, prompt, trace=None, host: bool = False):
        """One prompt's admission prefill on the worker's stream, waited
        for on this thread (``fleet.prefill_ms`` is its compute, as the
        reference's host fetch times it); returns (rows, logits, event) as
        :meth:`_ship` gives them."""
        prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        n = len(prompt)
        window = self._window()
        if not prompt or n > window:
            raise ValueError(f"prompt length {n} outside (0, {window}]")
        t0 = time.perf_counter()
        with self._on_stream():
            C = self._bucket(n)
            if self._paged:
                # the decode replica's fresh-prompt rule (no shared
                # prefix): one chunk at the bucket, floored at the block
                # size — the same step, the same rows
                self._map_rows(n)
                fn = _engine.ENGINE.get("paged_prefill",
                                        self._spec(bucket=C))
                (logits,) = fn(*self._feeds(prompt, C, 0, n, 0))
            else:
                fn = _engine.ENGINE.get("prefill", self._spec(bucket=C))
                (logits,) = fn(*self._feeds(prompt, C, n, 0))
            rows = self._take_rows(0, n)
            logits = logits.float().clone()
            rows, logits, ev = self._ship(rows, logits, host)
        if ev is not None:
            ev.synchronize()
        if self._paged:
            self._pool.free_slot(0)
        if self._tel:
            _telemetry.count("fleet.prefill_jobs")
            _telemetry.observe("fleet.prefill_ms",
                               (time.perf_counter() - t0) * 1e3)
            self._span_ring.record(trace, "prefill_chunk[0]", t0,
                                   time.perf_counter(), start=0, stop=n)
        return rows, logits, ev

    def prefill(self, prompt, trace=None):
        """Run one prompt's admission prefill; returns ``(rows, logits)``:
        rows ``[L, 1, n, Hkv(, hd)]`` per cache leaf (int8 scale planes
        included) in the storage dtype, copies on the worker's device,
        final when this returns; logits the fp32 [V] admission logits —
        what ``DecodeServer.submit_prefilled`` takes."""
        rows, logits, _ = self._prefill(prompt, trace)
        return rows, logits

    def prefill_stream(self, prompt, emit, chunk_rows=None, trace=None,
                       host: bool = False, ready: bool = False) -> None:
        """The chunked prefill: walk the prompt through the offset-aware
        chunk step (``prefill_chunk@W`` / ``paged_prefill@W``) and hand
        each finished chunk's rows to ``emit`` while the next chunk
        computes — a chunk's rows are copied on the worker's stream right
        after its dispatch, and emitted after the next chunk's dispatch.
        The final chunk's message carries the fp32 admission logits.

        ``emit(msg)`` receives ``{"op": "chunk", "seq", "start", "stop",
        "n", "rows", ["logits"]}``: rows ``[L, 1, stop - start, ...]`` per
        leaf, spans disjoint and covering [0, n) in order.  The walk
        overlaps its last window instead of overrunning the window.
        ``host``: rows (and logits) as pinned host tensors (a socket
        link); else card tensors.  Each message leaves once its rows are
        final (the worker's thread waits for them, the next chunk
        computing meanwhile); ``ready`` adds the event they were final at
        (``"ready"``), which the receiver's stream waits on."""
        prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        n = len(prompt)
        window = self._window()
        if not prompt or n > window:
            raise ValueError(f"prompt length {n} outside (0, {window}]")
        W = self._chunk_width(chunk_rows)
        t0 = time.perf_counter()
        if n <= W:
            # a single-window prompt: the monolithic walk is the chunk
            rows, logits, ev = self._prefill(prompt, trace=trace, host=host)
            msg = {"op": "chunk", "seq": 0, "start": 0, "stop": n,
                   "n": n, "rows": rows, "logits": logits}
            self._emit(emit, msg, ev, ready)
            self._count_stream(rows)
            if self._tel:
                self._span_ring.record(
                    trace, "stream", t0, time.perf_counter(), chunks=1)
            return
        starts = list(range(0, n - W, W)) + [n - W]
        pending = None            # (seq, lo, hi, rows, event, t_disp)
        prev_stop = 0
        with self._on_stream():
            if self._paged:
                self._map_rows(n)
                fn = _engine.ENGINE.get("paged_prefill",
                                        self._spec(bucket=W))
            else:
                fn = _engine.ENGINE.get("prefill_chunk",
                                        self._spec(width=W))
            for j, s in enumerate(starts):
                t_disp = time.perf_counter()
                chunk = prompt[s:s + W]
                (logits,) = fn(*self._feeds(chunk, W, s, len(chunk), 0))
                lo, hi = prev_stop, min(s + W, n)
                prev_stop = hi
                last = j == len(starts) - 1
                # the chunk's rows (copied now, waited for at emit time,
                # after the next chunk's dispatch)
                shipped = self._ship(self._take_rows(lo, hi),
                                     logits.float().clone() if last
                                     else None, host)
                if pending is not None:
                    self._emit_chunk(emit, pending, n, ready, trace)
                pending = (j, lo, hi, shipped, t_disp)
        self._emit_chunk(emit, pending, n, ready, trace)
        if self._paged:
            self._pool.free_slot(0)
        if self._tel:
            _telemetry.count("fleet.prefill_jobs")
            _telemetry.observe("fleet.prefill_ms",
                               (time.perf_counter() - t0) * 1e3)
            self._span_ring.record(trace, "stream", t0, time.perf_counter(),
                                   chunks=len(starts))

    @staticmethod
    def _emit(emit, msg: dict, ev, ready: bool) -> None:
        """Hand one message out once its rows are final: this (the worker's)
        thread waits for ``ev`` first — a streamed chunk's wait runs while
        the next chunk computes — so a replica never stalls its decode
        stream on the worker's compute; with ``ready`` the event rides the
        message too, and the receiving stream still orders its copy after
        it."""
        if ev is not None:
            ev.synchronize()
            if ready and msg["rows"] and next(
                    iter(msg["rows"].values())).is_cuda:
                msg["ready"] = ev
        emit(msg)

    def _emit_chunk(self, emit, pending, n: int, ready: bool,
                    trace=None) -> None:
        """Stream one finished chunk out (its copies overlapped the next
        chunk's dispatch)."""
        seq, lo, hi, (rows, logits, ev), t_disp = pending
        msg = {"op": "chunk", "seq": seq, "start": lo, "stop": hi, "n": n,
               "rows": rows}
        if logits is not None:
            msg["logits"] = logits
        self._emit(emit, msg, ev, ready)
        self._count_stream(rows)
        if self._tel:
            # dispatch to emitted: the chunk's device work and the copy
            # that overlapped the next chunk's dispatch
            self._span_ring.record(trace, f"prefill_chunk[{seq}]", t_disp,
                                   time.perf_counter(), start=lo, stop=hi)

    def _count_stream(self, rows) -> None:
        if self._tel:
            _telemetry.count("fleet.stream_chunks")
            _telemetry.count("fleet.stream_bytes",
                             sum(t.numel() * t.element_size()
                                 for t in rows.values()))

    def run_once(self, timeout: float = 0.0) -> bool:
        """Consume at most one job from the endpoint; returns whether a
        message was handled.  With ``PADDLE_TPU_STREAM_CHUNK_ROWS`` > 0 the
        reply streams chunk by chunk (``{"op": "chunk", ...}``, the last
        carrying the admission logits); 0 answers with one
        ``{"rid", "rows", "logits"}``.  Over a loopback on a card the rows
        stay card tensors and each reply carries its ``ready`` event; over
        any other link they leave as pinned host tensors.  A reply leaves
        once its rows are final, so the replicas never wait on the
        worker's compute."""
        msg = self.endpoint.recv(timeout)
        if msg is None:
            return False
        if isinstance(msg, dict) and msg.get("op") == "stop":
            self._stop.set()
            return True
        loop = isinstance(self.endpoint, _QueueEndpoint)
        try:
            C = _flags.stream_chunk_rows()
            # the router's trace context, carried on the job's header:
            # every span this worker records for the job lands under it
            tr = msg.get("trace") if isinstance(msg, dict) else None
            if C > 0:
                rid = msg["rid"]
                self.prefill_stream(
                    msg["prompt"],
                    lambda m: self.endpoint.send(
                        self._with_spans(dict(m, rid=rid))),
                    chunk_rows=C, trace=tr, host=not loop, ready=loop)
            else:
                rows, logits, ev = self._prefill(msg["prompt"], trace=tr,
                                                 host=not loop)
                reply = {"rid": msg["rid"], "rows": rows, "logits": logits}
                self._emit(lambda m: self.endpoint.send(self._with_spans(m)),
                           reply, ev, loop)
        except ConnectionError:
            raise                  # a dead link: the caller retires it
        except Exception as e:  # noqa: BLE001 - reported to the router
            self.endpoint.send({"rid": msg.get("rid"),
                                "error": f"{type(e).__name__}: {e}"})
        return True

    def _with_spans(self, msg: dict) -> dict:
        """Drain this worker's completed spans onto an outgoing reply
        (capped a message, drops carried so the router accounts them)."""
        if self._tel:
            spans, dropped = self._span_ring.drain(
                _flags.trace_piggyback_cap())
            if spans or dropped:
                msg["spans"] = spans
                msg["span_drops"] = dropped
        return msg

    def start(self) -> None:
        """Serve jobs on a daemon thread until :meth:`close` (or a
        ``{"op": "stop"}`` frame)."""
        if self.endpoint is None:
            raise ValueError("PrefillWorker.start() needs an endpoint")
        if self._thread is not None:
            return

        def run():
            while not self._stop.is_set():
                try:
                    self.run_once(timeout=0.02)
                except ConnectionError:
                    break              # a dead link: done serving it

        self._thread = threading.Thread(
            target=run, daemon=True, name=f"paddle-tpu-{self.name}")
        self._thread.start()

    def close(self) -> None:
        """Stop the thread, close the endpoint, release the slot's cache
        and the worker's steps."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if self.endpoint is not None:
            self.endpoint.close()
        if self._pool is not None:
            self._pool.close()
        if self._bind is not None:
            _engine.ENGINE.purge(binding=self._bind)
            self._bind = None
        self.cache = None


def serve_prefill_worker(worker: PrefillWorker, host: str = "127.0.0.1",
                         port: int = 0):
    """Serve one :class:`PrefillWorker` over the socket transport (the
    deployment across processes): accepts ONE router connection and runs
    the worker loop on a daemon thread.  Returns the listener (``.port``
    is the bound port; ``worker.close()`` stops the loop)."""
    listener = SocketTransport.listen(host, port)

    def run():
        try:
            ep = listener.accept(timeout=60.0)
        except OSError:
            return
        worker.endpoint = ep
        while not worker._stop.is_set():
            try:
                worker.run_once(timeout=0.02)
            except ConnectionError:
                break                  # the router hung up

    threading.Thread(target=run, daemon=True,
                     name=f"paddle-tpu-{worker.name}-serve").start()
    return listener


# ---------------------------------------------------------------------------
# router: admission, load balancing, health aggregation
# ---------------------------------------------------------------------------


class Router:
    """Fleet front end over N ``DecodeServer`` replicas (and optional
    prefill workers).

        router = fleet.Router([srv_a, srv_b], prefill=[worker])
        rid = router.submit(prompt, max_new_tokens=64)
        while router.pending():
            router.tick()
        tokens = router.result(rid)

    Requests enter a fleet queue (priority-ordered, TTL-shed) and go to
    the least loaded healthy replica — scored by prefix affinity (capped
    by ``PADDLE_TPU_PREFIX_ROUTE_IMBALANCE``), then queue depth, admitting
    slots, slot occupancy and KV utilization (``load_stats``).  Prompts at
    or past ``prefill_threshold`` go to a prefill worker first; its rows
    join the request (or stream into the replica chunk by chunk), so the
    decode loop never runs their prefill.  A replica whose wedge
    watchdog trips is drained: its queued work re-routes to the others
    (``fleet.reroutes``) while its active slots keep decoding through the
    server's wedge recovery; :meth:`healthz` aggregates the replicas'
    state.  ``prefill`` takes :class:`PrefillWorker` objects (wired over a
    loopback and started here) or ready client endpoints
    (``SocketTransport.connect(...)``).  Replicas tick concurrently on a
    thread pool (``PADDLE_TPU_FLEET_TICK_WORKERS``), a barrier a round.

    ``close()`` shuts down the whole fleet it fronts: replicas, owned
    workers, remote workers (a stop frame), and the metrics server."""

    def __init__(self, replicas, prefill=(),
                 prefill_threshold: int | None = None,
                 tick_block: int | None = None,
                 max_queue: int | None = None,
                 metrics_port: int | None = None,
                 spares=()):
        self.replicas = list(replicas)
        if not self.replicas:
            raise ValueError("Router needs at least one decode replica")
        self._prefill_eps = []
        self._ep_windows = []      # per endpoint: the worker's window, or
        self._owned_workers = []   # None when unknown (a raw endpoint)
        prefill = list(prefill)
        # the replicas' handoff steps are captured here, before any worker
        # thread runs: at the lengths the workers were warmed at (every
        # bucket when one is a raw endpoint or was not warmed)
        lens = set()
        for p in prefill:
            if getattr(p, "warm_lens", None) is None:
                lens = None
                break
            lens.update(p.warm_lens)
        self._handoff_lens = sorted(lens) if lens is not None else None
        if prefill:
            for srv in self.replicas + list(spares):
                self._warm_inject(srv)
        for p in prefill:
            if hasattr(p, "prefill"):          # a PrefillWorker object
                lt = LoopbackTransport()
                p.endpoint = lt.worker
                p.start()
                self._owned_workers.append(p)
                self._prefill_eps.append(lt.client)
                self._ep_windows.append(min(p.max_len,
                                            p.cfg.max_seq_len))
            else:                              # a ready client endpoint
                self._prefill_eps.append(p)
                self._ep_windows.append(None)
        self._threshold = (_flags.fleet_prefill_threshold()
                           if prefill_threshold is None
                           else int(prefill_threshold))
        self._block = (_flags.fleet_tick_block() if tick_block is None
                       else max(1, int(tick_block)))
        self._max_queue = (_flags.fleet_max_queue() if max_queue is None
                           else max(0, int(max_queue)))
        self._window = min(min(r.max_len, r.cfg.max_seq_len)
                           for r in self.replicas)
        self._default_ttl = _flags.request_ttl_s()
        self._resil = _resilience.enabled()
        self._tel = _telemetry.enabled()
        # the trace plane: per-track span stores (the router's own spans,
        # rings drained from replicas and workers), each bounded and
        # drop-counted; the router's port serves the fleet-merged views
        self._trace_tracks: dict = {}
        self._t_start = time.perf_counter()
        port = (metrics_port if metrics_port is not None
                else _flags.fleet_metrics_port())
        self.metrics_server = (_telemetry.serve_metrics(
            port, render=self.render_fleet_prometheus,
            snap=self.fleet_snapshot) if port is not None else None)
        self._queue: list[int] = []            # fleet rids awaiting dispatch
        self._requests: dict[int, dict] = {}   # fleet rid -> record
        self._local: dict = {}                 # (replica, local rid) -> rid
        self._ok = [True] * len(self.replicas)
        self._next_rid = 0
        self._pf_next = 0
        self._prefilling: set[int] = set()     # rids out at a worker
        self._dead_eps: set[int] = set()       # endpoint indices gone
        # replica ticks fan out over a bounded thread pool (made at the
        # first round that needs it); the router's state stays on the
        # caller's thread, each replica is ticked by one thread a round
        self._tick_workers = _flags.fleet_tick_workers()
        self._tick_pool = None
        # fleet admission at the front door: the tenants' token buckets
        # and bounded class queues, shedding by the worst replica's rung
        # (no histogram loop of its own); PADDLE_TPU_ADMISSION=0 builds
        # none
        self._adm = (_admission.AdmissionController(scope="fleet")
                     if _flags.admission_enabled() else None)
        self._prefix_route_on = _flags.prefix_route()
        self._route_imbalance = _flags.prefix_route_imbalance()
        # the elastic fleet: registered spares and the scaling loop's
        # sustain counters; a removed replica tombstones to None, so every
        # rec["replica"] index stays valid
        self._spares = list(spares)
        self._autoscale_on = _flags.fleet_autoscale()
        self._scale_rung = _flags.fleet_scale_rung()
        self._scale_out_ticks = _flags.fleet_scale_out_ticks()
        self._scale_in_ticks = _flags.fleet_scale_in_ticks()
        self._hot_ticks = 0
        self._idle_ticks = 0

    # -- submission ---------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int = 32,
               stop: list | None = None, temperature: float = 0.0,
               top_k: int = 0, top_p: float = 1.0,
               ttl_s: float | None = None, priority: int = 0,
               tenant: str | None = None) -> int:
        """Fleet submit: ``DecodeServer.submit``'s request surface, one id
        space across every replica.  Admission control runs at this door
        (the tenant's bucket, lowest-class sheds while a replica's rung
        sheds): a refused request retires ``rejected`` and ``result``
        raises ``resilience.Overloaded``."""
        vocab = next(r.cfg.vocab_size for r in self.replicas
                     if r is not None)
        prompt, stop, ttl, top_k = serving.validate_request(
            prompt, max_new_tokens, stop, temperature, top_k, top_p,
            ttl_s, window=self._window,
            vocab_size=vocab, default_ttl=self._default_ttl)
        now = time.perf_counter()
        rid = self._next_rid
        self._next_rid += 1
        req = {"prompt": prompt, "max_new": int(max_new_tokens),
               "stop": stop, "temperature": float(temperature),
               "top_k": top_k, "top_p": float(top_p),
               "ttl": ttl, "priority": int(priority),
               "tenant": tenant,
               "t_submit": now, "t_enqueue": now}
        # the trace context is minted here and rides the request dict
        # through handoff, stream, adopt, reroute and migration; with
        # telemetry off no key is attached at all
        tr = _telemetry.mint_trace()
        if tr is not None:
            req["trace"] = tr
        rec = {"state": "queued", "req": req}
        self._requests[rid] = rec
        if self._tel:
            _telemetry.count("fleet.requests")
        if self._adm is not None:
            ok, _reason = self._adm.admit(
                tenant, priority, len(prompt) + int(max_new_tokens))
            if not ok:
                rec["state"] = "rejected"
                if self._tel:
                    _telemetry.count("fleet.requests_rejected")
                self._gauges()
                return rid
        if self._prefill_eps and len(prompt) >= self._threshold:
            self._handoff_prefill(rid, rec)
        else:
            self._queue.append(rid)
            if self._adm is not None:
                self._shed_queue_overflow()
            self._route()
        self._gauges()
        return rid

    def _shed_queue_overflow(self) -> None:
        """The bounded class queues at the fleet: while a class is over
        ``PADDLE_TPU_ADMISSION_QUEUE_CAP``, retire the controller's victim
        ``rejected``."""
        while True:
            qreqs = [self._requests[rid]["req"] for rid in self._queue]
            i = self._adm.overflow_victim(qreqs)
            if i is None:
                return
            rid = self._queue.pop(i)
            rec = self._requests[rid]
            rec["state"] = "rejected"
            self._adm.count_shed(rec["req"].get("priority", 0),
                                 "queue_full")
            if self._tel:
                _telemetry.count("fleet.requests_rejected")

    def _live_eps(self):
        return [i for i in range(len(self._prefill_eps))
                if i not in self._dead_eps]

    def _handoff_prefill(self, rid: int, rec: dict) -> None:
        """Hand one admission prefill to a worker (round robin over the
        live endpoints whose known window fits the prompt).  With none —
        all dead, or every known window too small — the request falls back
        to the fleet queue and its replica prefills it locally."""
        n = len(rec["req"]["prompt"])

        def usable():
            return [i for i in self._live_eps()
                    if self._ep_windows[i] is None
                    or self._ep_windows[i] >= n]

        # the trace context rides the job's header frame
        job = {"rid": rid, "prompt": rec["req"]["prompt"]}
        tr = rec["req"].get("trace")
        if tr is not None:
            job["trace"] = tr
        live = usable()
        while live:
            i = live[self._pf_next % len(live)]
            self._pf_next += 1
            try:
                self._prefill_eps[i].send(job)
            except (ConnectionError, OSError):
                self._fail_prefill_ep(i)
                live = usable()
                continue
            rec["state"] = "prefilling"
            rec["ep"] = i
            self._prefilling.add(rid)
            if self._tel:
                _telemetry.count("fleet.prefill_handoffs")
            return
        self._queue.append(rid)        # no workers left: prefill locally

    def _fail_prefill_ep(self, i: int) -> None:
        """One endpoint's transport died: every prefill out at it fails
        (``error``, never a hang; a request mid-stream is aborted on its
        replica, whose slot frees), and the endpoint leaves the
        rotation."""
        self._dead_eps.add(i)
        for rid in sorted(self._prefilling):
            rec = self._requests[rid]
            if rec.get("ep") != i:
                continue
            self._prefilling.discard(rid)
            self._abort_stream(rec, "prefill worker transport died "
                                    "mid-job")
            rec["state"] = "error"
            rec["error"] = "prefill worker transport died mid-job"
            if self._tel:
                _telemetry.count("fleet.prefill_errors")

    def _abort_stream(self, rec: dict, reason: str) -> None:
        """Tear down a half-streamed handoff on its replica (the request
        fails, the claimed slot frees)."""
        if rec.get("state") != "streaming":
            return
        i, local = rec["replica"], rec["local_rid"]
        self._local.pop((i, local), None)
        srv = self.replicas[i]
        if srv is not None:
            with contextlib.suppress(KeyError):
                srv.stream_prefilled_abort(local, reason)
        if self._tel:
            _telemetry.count("fleet.stream_aborts")

    def _stream_chunk(self, ep_i: int, msg: dict) -> None:
        """Fold one streamed prefill chunk into its replica
        (``stream_prefilled_rows``) the moment it arrives.  The first
        chunk picks the replica (the dispatch scorer); the last carries
        the admission logits and leaves the request to its replica."""
        rid = msg.get("rid")
        rec = self._requests.get(rid)
        if rec is None or rec["state"] not in ("prefilling", "streaming"):
            return                  # shed or aborted mid-stream: late rows
        if rec["state"] == "prefilling":
            i = self._pick_replica(req=rec["req"])
            if i is None:
                # every candidate is at capacity: park on the best healthy
                # replica anyway — its queue holds the rows until a slot
                # frees
                live = [j for j, r in enumerate(self.replicas)
                        if r is not None and self._ok[j]]
                if not live:
                    self._prefilling.discard(rid)
                    rec["state"] = "error"
                    rec["error"] = ("no healthy replica to receive "
                                    "streamed prefill rows")
                    return
                i = live[0]
            req = rec["req"]
            try:
                local = self.replicas[i].stream_prefilled_begin(
                    req["prompt"], max_new_tokens=req["max_new"],
                    stop=req.get("stop"),
                    temperature=req.get("temperature", 0.0),
                    top_k=req.get("top_k", 0),
                    top_p=req.get("top_p", 1.0),
                    ttl_s=req.get("ttl"),
                    priority=req.get("priority", 0),
                    trace=req.get("trace"))
            except ValueError as e:
                self._prefilling.discard(rid)
                rec["state"] = "error"
                rec["error"] = str(e)
                return
            rec["state"] = "streaming"
            rec["replica"] = i
            rec["local_rid"] = local
            self._local[(i, local)] = rid
            if self._tel:
                # the first chunk's pick is this request's routing
                _telemetry.count("fleet.routed")
                self._dispatch_spans(rid, req, i)
        srv = self.replicas[rec["replica"]]
        try:
            srv.stream_prefilled_rows(
                rec["local_rid"], int(msg["start"]), int(msg["stop"]),
                msg["rows"], logits=msg.get("logits"),
                ready=msg.get("ready"))
        except Exception as e:  # noqa: BLE001 - surfaced on the request
            self._prefilling.discard(rid)
            self._abort_stream(rec, f"stream injection failed: {e}")
            rec["state"] = "error"
            rec["error"] = f"stream injection failed: {e}"
            return
        if msg.get("logits") is not None:
            # the final chunk: the replica owns the request now
            self._prefilling.discard(rid)
            rec["state"] = "dispatched"

    def _poll_prefill(self) -> None:
        for i in self._live_eps():
            ep = self._prefill_eps[i]
            while True:
                try:
                    msg = ep.recv(0.0)
                except (ConnectionError, OSError):
                    self._fail_prefill_ep(i)
                    break
                if msg is None:
                    break
                if self._tel and isinstance(msg, dict) \
                        and "spans" in msg:
                    # the worker's spans ride the replies this poll reads
                    self._absorb_spans(f"worker-{i}", msg["spans"],
                                       msg.get("span_drops", 0))
                if msg.get("op") == "chunk":
                    self._stream_chunk(i, msg)
                    continue
                rid = msg.get("rid")
                self._prefilling.discard(rid)
                rec = self._requests.get(rid)
                if rec is None or rec["state"] not in ("prefilling",
                                                       "streaming"):
                    continue
                if "error" in msg:
                    # a worker that failed mid-walk reports here; a
                    # half-streamed request aborts on its replica
                    self._abort_stream(rec, msg["error"])
                    rec["state"] = "error"
                    rec["error"] = msg["error"]
                    if self._tel:
                        _telemetry.count("fleet.prefill_errors")
                    continue
                rec["req"]["prefilled"] = (msg["rows"], msg["logits"],
                                           msg.get("ready"))
                rec["state"] = "queued"
                self._queue.append(rid)

    # -- scheduling ---------------------------------------------------------

    def _expired(self, rec: dict, now: float) -> bool:
        req = rec["req"]
        ttl = req.get("ttl")
        return (ttl is not None
                and now - req.get("t_enqueue", req["t_submit"]) > ttl)

    def _shed_expired(self) -> None:
        """Fleet-queue TTL shedding (the replica's rule one level up): a
        request still waiting here — queued, or out at a worker — past
        its TTL retires ``timeout`` before it reaches a replica."""
        if not self._resil or not (self._queue or self._prefilling):
            return
        now = time.perf_counter()
        kept = []
        for rid in self._queue:
            rec = self._requests[rid]
            if self._expired(rec, now):
                rec["state"] = "timeout"
                if self._tel:
                    _telemetry.count("fleet.ttl_sheds")
            else:
                kept.append(rid)
        self._queue[:] = kept
        for rid in sorted(self._prefilling):
            rec = self._requests[rid]
            if self._expired(rec, now):
                self._prefilling.discard(rid)
                # a half-streamed request frees its claimed slot too
                self._abort_stream(rec, "ttl expired mid-stream")
                rec["state"] = "timeout"
                if self._tel:
                    _telemetry.count("fleet.ttl_sheds")

    def _snapshot_load(self) -> dict:
        """One ``load_stats()`` read per healthy replica for a whole
        scheduling round (``_route`` keeps it honest between dispatches)."""
        return {i: r.load_stats() for i, r in enumerate(self.replicas)
                if r is not None and self._ok[i]}

    def _pick_replica(self, exclude=(), stats=None, req=None):
        """The best healthy replica with admission capacity (free slots,
        or queue room under ``max_queue``) by :meth:`_prefix_route`'s
        score.  ``stats``: the round's ``_snapshot_load``; absent, each
        replica is read live."""
        cands = []
        for i, r in enumerate(self.replicas):
            if r is None or not self._ok[i] or i in exclude:
                continue
            ls = (stats.get(i) if stats is not None
                  else r.load_stats())
            if ls is None:
                continue
            cap = ls["free_slots"] + max(
                0, self._max_queue - ls["queue_depth"])
            if cap <= 0:
                continue
            cands.append((i, ls))
        return self._prefix_route(req, cands)

    def _prefix_route(self, req, cands):
        """The replica score: the expected prefix overlap between the
        prompt and the replica's resident radix tree (matched by root
        fingerprint from ``load_stats()["prefix_summary"]``) leads, then
        queue depth, admitting slots, occupancy and KV utilization.  A
        candidate more than ``PADDLE_TPU_PREFIX_ROUTE_IMBALANCE`` queued
        requests above the least loaded scores no overlap, so a hot
        tenant never starves a cold replica.  Counts
        ``fleet.prefix_routed`` when affinity decided."""
        if not cands:
            return None
        prompt = (req or {}).get("prompt")
        min_q = min(ls["queue_depth"] for _, ls in cands)
        best, best_score = None, None
        for i, ls in cands:
            ov = 0
            if (self._prefix_route_on and prompt
                    and ls["queue_depth"] - min_q
                    <= self._route_imbalance):
                for run_len, fp, resident in \
                        ls.get("prefix_summary") or ():
                    if (len(prompt) >= run_len and fp
                            == _kv.prefix_fingerprint(
                                prompt[:run_len])):
                        ov = max(ov, min(resident, len(prompt)))
            score = (-ov, ls["queue_depth"],
                     ls.get("admitting_slots", 0),
                     ls["slot_occupancy"], ls["kv_utilization"], i)
            if best_score is None or score < best_score:
                best, best_score = i, score
        if best is not None and best_score[0] < 0 and self._tel:
            _telemetry.count("fleet.prefix_routed")
        return best

    def _route(self, stats=None) -> None:
        """Dispatch queued work: priority first (ties: submit order), each
        request to the best replica; what no replica can take stays in the
        fleet queue (re-routable)."""
        if not self._queue:
            return
        if stats is None:
            stats = self._snapshot_load()
        self._queue.sort(key=lambda rid: (
            -self._requests[rid]["req"]["priority"],
            self._requests[rid]["req"]["t_submit"]))
        held = []
        for rid in self._queue:
            rec = self._requests[rid]
            rejected = {}
            while True:
                i = self._pick_replica(exclude=rejected, stats=stats,
                                       req=rec["req"])
                if i is None:
                    healthy = {j for j, r in enumerate(self.replicas)
                               if r is not None and self._ok[j]}
                    if healthy and healthy <= set(rejected):
                        # every healthy replica refused it outright (its
                        # window or pool is too small: permanent, not a
                        # capacity wait)
                        rec["state"] = "error"
                        rec["error"] = "; ".join(
                            sorted(set(rejected.values())))
                        if self._tel:
                            _telemetry.count("fleet.route_errors")
                    else:
                        held.append(rid)
                    break
                self._migrate_chains(rec["req"], i)
                try:
                    local = self.replicas[i].adopt_request(rec["req"])
                except ValueError as e:
                    rejected[i] = str(e)
                    continue
                rec["state"] = "dispatched"
                rec["replica"] = i
                rec["local_rid"] = local
                self._local[(i, local)] = rid
                if i in stats:
                    # the adopted request takes a free slot if one was
                    # open, else sits on i's queue
                    if stats[i]["free_slots"] > 0:
                        stats[i]["free_slots"] -= 1
                    else:
                        stats[i]["queue_depth"] += 1
                if self._tel:
                    _telemetry.count("fleet.routed")
                    self._dispatch_spans(rid, rec["req"], i)
                break
        self._queue[:] = held

    def _check_health(self) -> None:
        for i, r in enumerate(self.replicas):
            if r is None:
                continue
            ok = not r.wedged
            if self._ok[i] and not ok:
                self._ok[i] = False
                self._drain_replica(i)
            elif ok and not self._ok[i]:
                self._ok[i] = True
                if self._tel:
                    _telemetry.count("fleet.replica_recoveries")

    def _drain_replica(self, i: int) -> None:
        """A replica's wedge watchdog tripped (or it is being removed):
        pull its queued router-owned work back to the front of the fleet
        queue for the others; its active slots stay."""
        if self._tel:
            _telemetry.count("fleet.drains")
        # only the rids this router owns: a request submitted directly to
        # the replica stays queued for its submitter
        mine = {lr for (ri, lr) in self._local if ri == i}
        reqs = self.replicas[i].drain_queue(mine)
        front = []
        for req in reqs:
            rid = self._local.pop((i, req["rid"]), None)
            if rid is None:
                continue
            rec = self._requests[rid]
            if req.get("stream"):
                # a queued streamed handoff cannot move: its chunks flow
                # to this replica's stream.  It fails (the worker's late
                # chunks drop on the state check)
                self._prefilling.discard(rid)
                rec["state"] = "error"
                rec["error"] = "stream target replica drained mid-handoff"
                rec.pop("replica", None)
                rec.pop("local_rid", None)
                if self._tel:
                    _telemetry.count("fleet.stream_aborts")
                continue
            r = dict(req)
            r.pop("rid", None)  # the local rid died with the drain
            rec["req"] = r
            rec["state"] = "queued"
            rec.pop("replica", None)
            rec.pop("local_rid", None)
            front.append(rid)
            # the trace context rides the request dict through the
            # reroute; a marker span keeps the hop on the timeline
            tr = r.get("trace")
            if tr:
                now = time.perf_counter()
                self._track("router").record(tr, "reroute", now, now,
                                             rid=rid, src=i)
        if front:
            self._queue[:0] = front
            if self._tel:
                _telemetry.count("fleet.reroutes", len(front))

    # -- elastic fleet ------------------------------------------------------

    def _migrate_chains(self, req, dest_i: int) -> None:
        """Cross-replica chain migration: before ``dest_i`` adopts a
        request, any other replica holding a spilled prefix chain of its
        prompt ships it over through the wire codec (the frames a socket
        fleet moves rows with), into the destination's spill store, where
        its admission restores it through its own ``inject`` step.  A move,
        not a copy (``kv_pool.chain_migrations``)."""
        prompt = req.get("prompt")
        dest = self.replicas[dest_i]
        pool = getattr(dest, "_pool", None)
        if not prompt or pool is None \
                or not hasattr(pool, "migrate_in"):
            return
        for j, r in enumerate(self.replicas):
            if j == dest_i or r is None:
                continue
            src = getattr(r, "_pool", None)
            if src is None or not hasattr(src, "migrate_out"):
                continue
            entries = src.migrate_out(prompt)
            if not entries:
                continue
            t0m = time.perf_counter()
            hdr, arrays = _encode_msg(entries)
            entries = _decode_msg(
                hdr, [bytearray(_frame_view(a)) for a in arrays])
            pool.migrate_in(entries)
            tr = req.get("trace")
            if tr:
                self._track("router").record(
                    tr, "migrate", t0m, time.perf_counter(),
                    src=j, dest=dest_i)

    def _warm_inject(self, srv) -> None:
        """Capture an idle card replica's ``inject`` steps (where the
        handoffs land), so a worker's first rows replay a graph: a capture
        mid-serve synchronizes the whole card."""
        if srv.device.type == "cuda" and not srv.pending():
            _engine.ENGINE.warm_inject(srv, self._handoff_lens)

    def add_replica(self, srv) -> int:
        """Attach a decode replica live: it joins routing at the next
        round (on the card, with its ``inject`` steps warmed first when
        the fleet has prefill workers).  The fleet window tightens if the
        newcomer's is smaller.  Returns its index."""
        if self._prefill_eps:
            self._warm_inject(srv)
        return self._attach(srv)

    def _attach(self, srv) -> int:
        self.replicas.append(srv)
        self._ok.append(True)
        self._window = min(self._window,
                           min(srv.max_len, srv.cfg.max_seq_len))
        if self._tel:
            _telemetry.count("fleet.replica_adds")
        self._gauges()
        return len(self.replicas) - 1

    def remove_replica(self, i: int):
        """Detach replica ``i`` live: its queued router-owned work re-routes
        to the others, a handoff streaming to it fails, and its active
        slots tick to the end here with their results kept in the fleet's
        records.  The index tombstones to ``None``.  Returns the detached
        server (the caller owns it again)."""
        srv = self.replicas[i]
        if srv is None:
            raise KeyError(f"replica {i} was already removed")
        if sum(1 for r in self.replicas if r is not None) <= 1:
            raise ValueError("cannot remove the last replica")
        self._drain_replica(i)
        for rid in sorted(self._prefilling):
            rec = self._requests[rid]
            if (rec.get("state") == "streaming"
                    and rec.get("replica") == i):
                self._prefilling.discard(rid)
                self._abort_stream(rec, "replica removed mid-stream")
                rec["state"] = "error"
                rec["error"] = "replica removed mid-stream"
        while srv.pending():
            self._tick_replica(srv)
        for (ri, local), rid in list(self._local.items()):
            if ri != i:
                continue
            rec = self._requests[rid]
            try:
                rec["result"] = srv.result(local)
                rec["state"] = "done"
            except Exception as e:  # noqa: BLE001 - surfaced on result
                rec["state"] = "error"
                rec["error"] = str(e)
            del self._local[(ri, local)]
        if self._tel and hasattr(srv, "drain_spans"):
            # the last collection before the handle leaves the fleet
            spans, drops = srv.drain_spans()
            self._absorb_spans(f"replica-{i}", spans, drops)
        self.replicas[i] = None
        self._ok[i] = False
        self._window = min(min(r.max_len, r.cfg.max_seq_len)
                           for r in self.replicas if r is not None)
        if self._tel:
            _telemetry.count("fleet.replica_removes")
        self._route()
        self._gauges()
        return srv

    def register_spare(self, srv) -> None:
        """Park a warm replica for the autoscale loop (attached in
        registration order; scale-in returns drained replicas here)."""
        if self._prefill_eps:
            self._warm_inject(srv)
        self._spares.append(srv)

    def _autoscale(self, stats) -> bool:
        """The scaling loop (``PADDLE_TPU_FLEET_AUTOSCALE``): out to a
        spare after the worst healthy replica's rung has held at or above
        ``PADDLE_TPU_FLEET_SCALE_RUNG`` for ``_SCALE_OUT_TICKS`` rounds, in
        after ``_SCALE_IN_TICKS`` rounds with no work anywhere.  Returns
        True when the topology changed."""
        if stats is None:
            stats = self._snapshot_load()
        rungs = [ls.get("admission_rung", 0) for ls in stats.values()]
        hot = bool(rungs) and max(rungs) >= self._scale_rung
        busy = (bool(self._queue) or bool(self._prefilling)
                or any(ls["queue_depth"] > 0 or ls["slot_occupancy"] > 0
                       for ls in stats.values()))
        self._hot_ticks = self._hot_ticks + 1 if hot else 0
        self._idle_ticks = 0 if busy else self._idle_ticks + 1
        if self._hot_ticks >= self._scale_out_ticks and self._spares:
            self._scale_out()
            return True
        if (self._idle_ticks >= self._scale_in_ticks
                and sum(1 for r in self.replicas
                        if r is not None) > 1):
            self._scale_in()
            return True
        return False

    def _scale_out(self) -> None:
        """The oldest registered spare joins (``fleet.scale_outs``)."""
        # a registered spare's handoff steps were warmed at registration
        self._attach(self._spares.pop(0))
        self._hot_ticks = 0
        if self._tel:
            _telemetry.count("fleet.scale_outs")

    def _scale_in(self) -> None:
        """The highest-index live replica drains back to the spares
        (``fleet.scale_ins``)."""
        live = [j for j, r in enumerate(self.replicas)
                if r is not None]
        self._spares.append(self.remove_replica(live[-1]))
        self._idle_ticks = 0
        if self._tel:
            _telemetry.count("fleet.scale_ins")

    def _tick_replica(self, r) -> None:
        if self._block > 1:
            r.tick_block(self._block)
        else:
            r.tick()

    def tick(self) -> None:
        """One fleet round: fold in finished prefills, health check (drain
        and re-route on a wedge), TTL sheds, dispatch, then tick every
        replica with work — concurrently over the thread pool, a barrier:
        every tick ends (or raises) before the health check after it, and
        the first replica exception propagates once all have joined."""
        self._poll_prefill()
        self._check_health()
        self._shed_expired()
        stats = (self._snapshot_load()
                 if self._queue or self._adm is not None
                 or self._autoscale_on else None)
        self._absorb_backpressure(stats)
        if self._autoscale_on and self._autoscale(stats):
            stats = self._snapshot_load()   # the topology changed
        self._route(stats)
        pend = [r for r in self.replicas
                if r is not None and r.pending()]
        if len(pend) <= 1 or self._tick_workers <= 1:
            for r in pend:
                self._tick_replica(r)
        else:
            if self._tick_pool is None:
                self._tick_pool = concurrent.futures.ThreadPoolExecutor(
                    max_workers=min(len(self.replicas),
                                    self._tick_workers),
                    thread_name_prefix="fleet-tick")
            errs = []
            for f in [self._tick_pool.submit(self._tick_replica, r)
                      for r in pend]:
                try:
                    f.result()
                except Exception as e:  # noqa: BLE001 - re-raised below
                    errs.append(e)
            if errs:
                raise errs[0]
        self._check_health()
        self._harvest_spans()
        self._gauges()

    def _absorb_backpressure(self, stats=None) -> None:
        """The front door takes the worst healthy replica's degradation
        rung (``load_stats()["admission_rung"]``)."""
        if self._adm is None:
            return
        if stats is None:
            stats = self._snapshot_load()
        rungs = [ls.get("admission_rung", 0) for ls in stats.values()]
        self._adm.absorb_fleet_rung(max(rungs) if rungs else 0)

    def pending(self) -> bool:
        return (bool(self._queue) or bool(self._prefilling)
                or any(r.pending() for r in self.replicas
                       if r is not None))

    # -- results ------------------------------------------------------------

    def status(self, rid: int) -> str:
        """``queued`` | ``prefilling`` | ``streaming`` | ``timeout`` |
        ``rejected`` | ``error`` at the fleet; once dispatched, the owning
        replica's status; ``ok`` for a result kept by
        :meth:`remove_replica`."""
        rec = self._requests[rid]
        if rec["state"] == "dispatched":
            return self.replicas[rec["replica"]].status(rec["local_rid"])
        if rec["state"] == "done":
            return "ok"
        return rec["state"]

    def result(self, rid: int):
        rec = self._requests[rid]
        state = rec["state"]
        if state == "done":
            return rec["result"]
        if state == "timeout":
            raise _resilience.DeadlineExceeded(
                f"request {rid} was shed at the router: still queued "
                f"past its ttl")
        if state == "rejected":
            raise _resilience.Overloaded(
                f"request {rid} was rejected at the fleet door "
                f"(rate limit, queue bound, or overload shed) — it "
                f"never queued; back off and resubmit")
        if state == "error":
            raise RuntimeError(
                f"request {rid} failed: {rec.get('error')}")
        if state != "dispatched":
            raise KeyError(f"request {rid} is still {state}")
        return self.replicas[rec["replica"]].result(rec["local_rid"])

    # -- health + telemetry -------------------------------------------------

    def healthz(self) -> dict:
        """Fleet health: ``ok`` iff every replica's wedge watchdog is
        clear, with each replica's live load stats."""
        reps = []
        for r in self.replicas:
            if r is None:
                continue
            ls = r.load_stats()
            reps.append(dict(ls, ok=not ls["wedged"]))
        return {
            "ok": all(rp["ok"] for rp in reps),
            "replicas": reps,
            "queue_depth": len(self._queue),
            "prefill_workers": len(self._prefill_eps),
            "prefill_outstanding": len(self._prefilling),
            "admission": (None if self._adm is None
                          else self._adm.stats()),
        }

    # -- fleet tracing: collection + assembly -------------------------------

    def _track(self, name: str) -> _telemetry.SpanRing:
        """The named span track: ``router`` for this process's spans,
        ``replica-N`` / ``worker-N`` for rings collected from the fleet."""
        ring = self._trace_tracks.get(name)
        if ring is None:
            ring = self._trace_tracks[name] = _telemetry.SpanRing()
        return ring

    def _absorb_spans(self, track: str, spans, dropped=0) -> None:
        """Fold a remote ring's drained spans and drop count into a track
        (drops also on ``fleet.trace_drops``)."""
        ring = self._track(track)
        for s in spans or ():
            if isinstance(s, dict):
                ring.push(s)
        if dropped:
            ring.add_drops(int(dropped))
            _telemetry.count("fleet.trace_drops", int(dropped))

    def _dispatch_spans(self, rid: int, req: dict, replica: int) -> None:
        """The dispatch on the trace: the fleet-queue wait and a
        zero-width route marker naming the replica."""
        tr = req.get("trace")
        if not tr:
            return
        now = time.perf_counter()
        ring = self._track("router")
        ring.record(tr, "queue_wait",
                    req.get("t_enqueue", req.get("t_submit", now)), now,
                    rid=rid)
        ring.record(tr, "route", now, now, rid=rid, replica=replica)

    def _harvest_spans(self) -> None:
        """One collection round: drain every live replica's span ring
        into its track (worker spans arrive on the replies)."""
        if not self._tel:
            return
        for i, r in enumerate(self.replicas):
            if r is None or not hasattr(r, "drain_spans"):
                continue
            spans, dropped = r.drain_spans()
            if spans or dropped:
                self._absorb_spans(f"replica-{i}", spans, dropped)

    def fleet_trace(self) -> dict:
        """``{track: [span, ...]}``: a collection round, then every track
        as it stands (spans are wall-clock stamped: one timeline)."""
        self._harvest_spans()
        return {nm: ring.spans()
                for nm, ring in sorted(self._trace_tracks.items())}

    def dump_fleet_trace(self, path: str) -> str:
        """One Chrome-trace timeline of the whole fleet: a process track a
        span source (router / replica-N / worker-N, a row a request)
        beside the process telemetry ring shifted onto the wall clock."""
        tracks = self.fleet_trace()
        evs = []
        pid = 1
        for nm, spans in tracks.items():
            evs.extend(_telemetry.spans_to_chrome(
                spans, pid=pid, name=f"fleet.{nm}"))
            pid += 1
        evs.extend(_telemetry.chrome_events(
            pid=0, shift=time.time() - time.perf_counter()))
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump({"traceEvents": evs, "displayTimeUnit": "ms"}, f)
        return path

    # -- fleet metrics aggregation ------------------------------------------

    def fleet_snapshot(self) -> dict:
        """The router's ``/snapshot``: each replica's own histogram states,
        counters and live load, fleet rollups by exact histogram merge
        (every histogram shares one bucket ladder) and the span tracks'
        accounting."""
        reps: dict = {}
        merged: dict = {}
        counters: dict = {}
        for i, r in enumerate(self.replicas):
            if r is None:
                continue
            snap = (r.local_snapshot()
                    if hasattr(r, "local_snapshot")
                    else {"histograms": {}, "counters": {}})
            summaries = {}
            for name, stt in snap["histograms"].items():
                h = merged.get(name)
                if h is None:
                    h = merged[name] = _telemetry.Histogram(
                        f"fleet.{name}")
                h.merge(stt)
                one = _telemetry.Histogram(name)
                one.merge(stt)
                summaries[name] = one.summary()
            reps[str(i)] = {
                "histograms": snap["histograms"],
                "summaries": summaries,
                "counters": snap["counters"],
                "load": r.load_stats(),
                "healthy": bool(self._ok[i]),
            }
            for name, c in snap["counters"].items():
                counters[name] = counters.get(name, 0) + c
        uptime = max(time.perf_counter() - self._t_start, 1e-9)
        toks = counters.get("serving.tokens_generated", 0)
        ttft = merged.get("serving.ttft_ms")
        tpot = merged.get("serving.tpot_ms")
        return {
            "replicas": reps,
            "fleet": {
                "replicas": sum(1 for r in self.replicas
                                if r is not None),
                "healthy_replicas": sum(self._ok),
                "queue_depth": len(self._queue),
                "prefill_outstanding": len(self._prefilling),
                "uptime_s": round(uptime, 3),
                "tokens_generated": toks,
                "tok_s": round(toks / uptime, 3),
                "requests_completed": counters.get(
                    "serving.requests_completed", 0),
                "ttft_p99_ms": (round(ttft.quantile(0.99), 6)
                                if ttft is not None else 0.0),
                "tpot_p99_ms": (round(tpot.quantile(0.99), 6)
                                if tpot is not None else 0.0),
                "histograms": {name: h.summary()
                               for name, h in sorted(merged.items())},
            },
            "trace": {nm: {"spans": len(ring),
                           "dropped": ring.dropped}
                      for nm, ring in sorted(
                          self._trace_tracks.items())},
        }

    @staticmethod
    def _render_hist_lines(out: list, name: str, h, label: str) -> None:
        pn = ("paddle_tpu_fleet_"
              + name.replace(".", "_").replace("-", "_"))
        for ub, cum in h.buckets():
            le = "+Inf" if ub == float("inf") else repr(ub)
            out.append(f'{pn}_bucket{{{label},le="{le}"}} {cum}')
        s = h.summary()
        out.append(f'{pn}_sum{{{label}}} {s["sum"]}')
        out.append(f'{pn}_count{{{label}}} {s["count"]}')

    def render_fleet_prometheus(self) -> str:
        """One Prometheus exposition for the fleet: the process registry,
        each replica's histograms and counters under ``paddle_tpu_fleet_*``
        labelled ``{replica="i"}``, then the fleet rollups (merged by
        bucket addition, never by averaging quantiles)."""
        snap = self.fleet_snapshot()
        out = [_telemetry.render_prometheus().rstrip("\n")]
        for i in sorted(snap["replicas"], key=int):
            rep = snap["replicas"][i]
            for name, stt in rep["histograms"].items():
                h = _telemetry.Histogram(name)
                h.merge(stt)
                self._render_hist_lines(out, name, h,
                                        f'replica="{i}"')
            for name, c in rep["counters"].items():
                pn = ("paddle_tpu_fleet_"
                      + name.replace(".", "_").replace("-", "_")
                      + "_total")
                out.append(f'{pn}{{replica="{i}"}} {c}')
        fl = snap["fleet"]
        for k in ("replicas", "healthy_replicas", "queue_depth",
                  "prefill_outstanding", "tokens_generated", "tok_s",
                  "ttft_p99_ms", "tpot_p99_ms"):
            out.append(f"paddle_tpu_fleet_{k} {fl[k]}")
        return "\n".join(out) + "\n"

    def _gauges(self) -> None:
        if not self._tel:
            return
        _telemetry.set_gauge(
            "fleet.replicas",
            sum(1 for r in self.replicas if r is not None))
        _telemetry.set_gauge("fleet.healthy_replicas", sum(self._ok))
        _telemetry.set_gauge("fleet.queue_depth", len(self._queue))
        _telemetry.set_gauge("fleet.prefill_outstanding",
                             len(self._prefilling))
        if self._adm is not None:
            _telemetry.set_gauge("admission.fleet_rung", self._adm.rung)

    def close(self) -> None:
        """Shut the fleet down: stop frames to remote workers, owned
        workers closed, the tick pool joined, every replica and spare
        closed (unfinished work is abandoned per ``DecodeServer.close``),
        the metrics server joined."""
        for ep in self._prefill_eps:
            with contextlib.suppress(Exception):
                ep.send({"op": "stop"})
            with contextlib.suppress(Exception):
                ep.close()
        for w in self._owned_workers:
            with contextlib.suppress(Exception):
                w.close()
        if self._tick_pool is not None:
            self._tick_pool.shutdown(wait=True)
            self._tick_pool = None
        for r in list(self.replicas) + list(self._spares):
            if r is None:
                continue
            with contextlib.suppress(Exception):
                r.close()
        if self.metrics_server is not None:
            self.metrics_server.close()
            self.metrics_server = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
