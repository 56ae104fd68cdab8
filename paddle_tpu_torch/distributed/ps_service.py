"""Parameter-server SERVICE: table-server processes, the sharded client
and the async / geo communicators.

Counterpart of ``paddle_tpu/distributed/ps_service.py`` (``OPS`` :41,
``_pack`` / ``_unpack`` :51-71, ``PSServer`` :81, ``run_server`` :408,
``PSClient`` :424, ``AsyncCommunicator`` :764, ``GeoCommunicator`` :845,
``main`` :901) — the reference's brpc PS stack (BrpcPsServer /
BrpcPsClient, the async Communicator of service/communicator.cc).  A
CPU-hosted table service that outlives any one worker and holds
recommender vocabularies beyond a card's memory:

* the hot loops (pull gather, duplicate-merged adagrad push, snapshot
  IO, the graph table's sampling) run in native code —
  ``csrc/host/ps_table.cpp``, the JAX package's source, built by
  ``_native.py``;
* the wire is stdlib TCP: the KV store's length-prefixed frame carrying
  one op byte and an ``npz`` body (never a pickle), the same bytes as
  the JAX package's, so clients and servers of the two packages mix;
* sharding is ``id % num_servers``, mapped client-side to (server,
  local row ``id // num_servers``); a graph table shards edges by
  ``src % num_servers``.

Servers are CPU processes and never touch CUDA: this module and its
imports load neither torch nor a card (``python -m
paddle_tpu_torch.distributed.ps_service`` starts one).
"""
from __future__ import annotations

import ctypes
import io
import os
import queue
import socket
import socketserver
import threading
import time
from typing import Sequence

import numpy as np

# ---------------------------------------------------------------------------
# wire format: !I frame length | !B op | npz-style payload
# ---------------------------------------------------------------------------

OPS = {"create": 1, "pull": 2, "push": 3, "pull_dense": 4, "push_dense": 5,
       "save": 6, "load": 7, "stat": 8, "barrier_add": 9, "shutdown": 10,
       "barrier_get": 11, "err": 12, "push_delta": 13,
       # graph table service (common_graph_table.cc role)
       "g_create": 14, "g_add_edges": 15, "g_sample": 16, "g_degree": 17,
       "g_nodes": 18, "g_add_nodes": 19, "g_stat": 20,
       "g_set_feat": 21, "g_get_feat": 22}
_OP_NAMES = {v: k for k, v in OPS.items()}


def _pack(op: str, meta: dict, arrays: dict[str, np.ndarray]) -> bytes:
    """Frame payload: 1 op byte + npz body (length prefix added by the
    shared kvstore framing on send)."""
    import json

    buf = io.BytesIO()
    np.savez(buf, __meta__=np.frombuffer(
        json.dumps(meta).encode(), np.uint8), **arrays)
    return bytes([OPS[op]]) + buf.getvalue()


def _unpack(frame: bytes):
    import json

    op = _OP_NAMES[frame[0]]
    with np.load(io.BytesIO(frame[1:]), allow_pickle=False) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        arrays = {k: z[k] for k in z.files if k != "__meta__"}
    return op, meta, arrays


# length-prefixed framing shared with the KV store (kvstore.py)
from .kvstore import recv_frame as _recv_frame  # noqa: E402
from .kvstore import send_frame as _send_frame  # noqa: E402


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------

class PSServer:
    """One table-shard server process (BrpcPsServer role).

    Owns the rows with ``id % num_servers == server_idx`` of every table,
    stored/updated by the native kernel; handles pull/push/dense/save/load
    over threaded TCP."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 server_idx: int = 0, num_servers: int = 1,
                 ssd_dir: str | None = None):
        from .._native import ps_table

        self._lib = ps_table()
        self.server_idx = server_idx
        self.num_servers = num_servers
        self._ssd_dir = ssd_dir  # enables storage="ssd" tables
        self._tables: dict[int, dict] = {}
        self._tables_lock = threading.Lock()
        self._dense: dict[str, np.ndarray] = {}
        self._dense_lock = threading.Lock()
        self._counters: dict[str, int] = {}
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                try:
                    while True:
                        frame = _recv_frame(self.request)
                        resp = outer._dispatch(frame)
                        _send_frame(self.request, resp)
                        if frame[0] == OPS["shutdown"]:
                            threading.Thread(
                                target=outer._srv.shutdown,
                                daemon=True).start()
                            return
                except (ConnectionError, OSError):
                    return

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._srv = Server((host, port), Handler)
        self.host, self.port = self._srv.server_address

    @property
    def endpoint(self) -> str:
        return f"{self.host}:{self.port}"

    def _local_rows(self, vocab: int) -> int:
        # rows this shard owns under id % S == idx
        s, i = self.num_servers, self.server_idx
        return (vocab - i + s - 1) // s if vocab > i else 0

    def _dispatch(self, frame: bytes) -> bytes:
        try:
            op, meta, arrays = _unpack(frame)
        except Exception as e:  # noqa: BLE001 - protocol skew/corrupt frame:
            # the client still deserves an answer, not a dead thread
            return _pack("err", {"ok": False,
                                 "err": f"bad frame: {e!r}"}, {})
        lib = self._lib
        try:
            if op == "create":
                tid = meta["tid"]
                storage = meta.get("storage", "mem")
                fresh = False
                with self._tables_lock:  # concurrent creates must not
                    # race the check-then-insert (handle leak + lost pushes)
                    if tid not in self._tables:
                        fresh = True
                        rows = self._local_rows(meta["vocab"])
                        seed = meta.get("seed", 0) * 1000 + self.server_idx
                        rng = meta.get("init_range", 0.05)
                        if storage == "ssd":
                            # mmap-file-backed shard (SSDSparseTable role)
                            if self._ssd_dir is None:
                                return _pack("create", {
                                    "ok": False,
                                    "err": "server started without "
                                           "ssd_dir"}, {})
                            os.makedirs(self._ssd_dir, exist_ok=True)
                            path = os.path.join(
                                self._ssd_dir,
                                f"table_{tid}.shard{self.server_idx}.mmap")
                            h = lib.pst_create_ssd(rows, meta["dim"], seed,
                                                   rng, path.encode())
                            if not h:
                                return _pack("create", {
                                    "ok": False,
                                    "err": f"mmap create failed: {path}"},
                                    {})
                        else:
                            h = lib.pst_create(rows, meta["dim"], seed, rng)
                        self._tables[tid] = {"h": h, "rows": rows,
                                             "dim": meta["dim"],
                                             "vocab": meta["vocab"],
                                             "storage": storage}
                # fresh=True means THIS server just created (randomly
                # initialized) the shard — recovery paths use it to restore
                # a snapshot onto exactly the restarted servers
                return _pack("create", {"ok": True, "fresh": fresh}, {})
            if op == "pull":
                t = self._tables[meta["tid"]]
                ids = np.ascontiguousarray(arrays["ids"], np.int64)
                out = np.empty((len(ids), t["dim"]), np.float32)
                lib.pst_pull(t["h"],
                             ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                             len(ids),
                             out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
                return _pack("pull", {"ok": True}, {"rows": out})
            if op == "push":
                t = self._tables[meta["tid"]]
                ids = np.ascontiguousarray(arrays["ids"], np.int64)
                g = np.ascontiguousarray(arrays["grads"], np.float32)
                lib.pst_push_adagrad(
                    t["h"],
                    ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                    g.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                    len(ids), meta.get("lr", 0.05), meta.get("eps", 1e-8))
                return _pack("push", {"ok": True}, {})
            if op == "push_delta":
                t = self._tables[meta["tid"]]
                ids = np.ascontiguousarray(arrays["ids"], np.int64)
                d = np.ascontiguousarray(arrays["deltas"], np.float32)
                lib.pst_push_delta(
                    t["h"],
                    ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                    d.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                    len(ids))
                return _pack("push_delta", {"ok": True}, {})
            if op == "pull_dense":
                with self._dense_lock:
                    arr = self._dense.get(meta["key"])
                return _pack("pull_dense", {"ok": arr is not None},
                             {"value": arr} if arr is not None else {})
            if op == "push_dense":
                with self._dense_lock:
                    if meta.get("grad", False):
                        if meta["key"] not in self._dense:
                            # applying a grad to nothing would silently store
                            # the gradient AS the parameter
                            return _pack("push_dense", {
                                "ok": False,
                                "err": f"dense key {meta['key']!r} not "
                                       f"initialized; push the value first"},
                                {})
                        self._dense[meta["key"]] = (
                            self._dense[meta["key"]]
                            - meta.get("lr", 0.05) * arrays["value"])
                    else:
                        self._dense[meta["key"]] = arrays["value"]
                return _pack("push_dense", {"ok": True}, {})
            if op == "save":
                os.makedirs(meta["dir"], exist_ok=True)
                with self._tables_lock:  # snapshot: creates may race
                    tables = list(self._tables.items())
                for tid, t in tables:
                    path = os.path.join(
                        meta["dir"],
                        f"table_{tid}.shard{self.server_idx}").encode()
                    if t.get("kind") == "graph":
                        lib.pgt_save(t["h"], path)
                        continue
                    if t.get("storage") == "ssd":
                        lib.pst_sync(t["h"])  # msync the mmap first
                    lib.pst_save(t["h"], path)
                return _pack("save", {"ok": True}, {})
            if op == "load":
                with self._tables_lock:
                    tables = list(self._tables.items())
                for tid, t in tables:
                    path = os.path.join(
                        meta["dir"],
                        f"table_{tid}.shard{self.server_idx}").encode()
                    fn = (lib.pgt_load if t.get("kind") == "graph"
                          else lib.pst_load)
                    rc = fn(t["h"], path)
                    if rc != 0:
                        return _pack("load", {"ok": False, "rc": rc}, {})
                return _pack("load", {"ok": True}, {})
            if op == "g_create":
                tid = meta["tid"]
                with self._tables_lock:
                    if tid not in self._tables:
                        h = lib.pgt_create(
                            meta.get("seed", 0) * 1000 + self.server_idx + 1)
                        self._tables[tid] = {"h": h, "kind": "graph",
                                             "rows": 0, "dim": 0}
                return _pack("g_create", {"ok": True}, {})
            if op == "g_add_edges":
                t = self._tables[meta["tid"]]
                src = np.ascontiguousarray(arrays["src"], np.int64)
                dst = np.ascontiguousarray(arrays["dst"], np.int64)
                w = arrays.get("weights")
                wp = None
                if w is not None:
                    w = np.ascontiguousarray(w, np.float32)
                    wp = w.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
                lib.pgt_add_edges(
                    t["h"],
                    src.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                    dst.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                    wp, len(src))
                return _pack("g_add_edges", {"ok": True}, {})
            if op == "g_add_nodes":
                t = self._tables[meta["tid"]]
                ids = np.ascontiguousarray(arrays["ids"], np.int64)
                lib.pgt_add_nodes(
                    t["h"],
                    ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                    len(ids))
                return _pack("g_add_nodes", {"ok": True}, {})
            if op == "g_sample":
                t = self._tables[meta["tid"]]
                ids = np.ascontiguousarray(arrays["ids"], np.int64)
                k = int(meta["k"])
                out = np.full((len(ids), k), -1, np.int64)
                lib.pgt_sample_neighbors(
                    t["h"],
                    ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                    len(ids), k,
                    out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
                return _pack("g_sample", {"ok": True}, {"nbrs": out})
            if op == "g_degree":
                t = self._tables[meta["tid"]]
                ids = np.ascontiguousarray(arrays["ids"], np.int64)
                out = np.zeros(len(ids), np.int64)
                lib.pgt_degrees(
                    t["h"],
                    ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                    len(ids),
                    out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
                return _pack("g_degree", {"ok": True}, {"degrees": out})
            if op == "g_set_feat":
                t = self._tables[meta["tid"]]
                ids = np.ascontiguousarray(arrays["ids"], np.int64)
                feats = np.ascontiguousarray(arrays["feats"], np.float32)
                dim = feats.shape[1] if feats.ndim == 2 else int(meta["dim"])
                rc = lib.pgt_set_node_feat(
                    t["h"],
                    ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                    feats.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                    len(ids), dim)
                if rc != 0:
                    return _pack("err", {"ok": False, "err": (
                        f"set_node_feat: feature dim {dim} conflicts with "
                        f"the table's established dim "
                        f"{int(lib.pgt_feat_dim(t['h']))}")}, {})
                return _pack("g_set_feat", {"ok": True}, {})
            if op == "g_get_feat":
                t = self._tables[meta["tid"]]
                ids = np.ascontiguousarray(arrays["ids"], np.int64)
                dim = int(meta["dim"]) if meta.get("dim") \
                    else int(lib.pgt_feat_dim(t["h"]))
                out = np.zeros((len(ids), max(dim, 1)), np.float32)
                found = np.zeros(len(ids), np.uint8)
                if dim:
                    rc = lib.pgt_get_node_feat(
                        t["h"],
                        ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                        len(ids), dim,
                        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                        found.ctypes.data_as(
                            ctypes.POINTER(ctypes.c_uint8)))
                    if rc != 0:
                        return _pack("err", {"ok": False, "err": (
                            f"get_node_feat: dim {dim} != table dim "
                            f"{int(lib.pgt_feat_dim(t['h']))}")}, {})
                return _pack("g_get_feat", {"ok": True, "dim": dim},
                             {"feats": out[:, :dim], "found": found})
            if op == "g_stat":
                # read-only: must not touch the sampling RNG
                t = self._tables[meta["tid"]]
                return _pack("g_stat", {
                    "ok": True,
                    "num_nodes": int(lib.pgt_num_nodes(t["h"])),
                    "num_edges": int(lib.pgt_num_edges(t["h"]))}, {})
            if op == "g_nodes":
                t = self._tables[meta["tid"]]
                k = int(meta["k"])
                out = np.full(k, -1, np.int64)
                lib.pgt_random_sample_nodes(
                    t["h"], k,
                    out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
                return _pack("g_nodes", {
                    "ok": True,
                    "num_nodes": int(lib.pgt_num_nodes(t["h"])),
                    "num_edges": int(lib.pgt_num_edges(t["h"]))},
                    {"nodes": out})
            if op == "barrier_add":
                with self._dense_lock:
                    k = meta["key"]
                    self._counters[k] = self._counters.get(k, 0) + 1
                    return _pack("barrier_add",
                                 {"ok": True, "count": self._counters[k]}, {})
            if op == "barrier_get":
                with self._dense_lock:
                    return _pack("barrier_get", {
                        "ok": True,
                        "count": self._counters.get(meta["key"], 0)}, {})
            if op == "stat":
                with self._tables_lock:
                    tables = list(self._tables.items())
                return _pack("stat", {
                    "ok": True, "server_idx": self.server_idx,
                    "tables": {str(tid): {"rows": t["rows"], "dim": t["dim"]}
                               for tid, t in tables}}, {})
            if op == "shutdown":
                return _pack("shutdown", {"ok": True}, {})
            return _pack(op, {"ok": False, "err": f"bad op {op}"}, {})
        except Exception as e:  # noqa: BLE001 - must answer the client
            return _pack(op, {"ok": False, "err": repr(e)}, {})

    def serve_forever(self):
        self._srv.serve_forever()

    def start_background(self):
        t = threading.Thread(target=self._srv.serve_forever, daemon=True)
        t.start()
        return t

    def shutdown(self):
        self._srv.shutdown()
        self._srv.server_close()


MODULE = "paddle_tpu_torch.distributed.ps_service"


def start_servers(num_servers: int, workdir: str, *, indices=None,
                  ports=None, ssd_dir: str | None = None,
                  module: str = MODULE, env: dict | None = None,
                  timeout: float = 60.0):
    """Start servers ``indices`` (default: all) of a ``num_servers``
    cluster as child processes ``python -m <module>``, all at once, and
    wait until each has written its endpoint (to a file under
    ``workdir``).  ``ports``: one a server (0: any free port).  Returns
    (processes, endpoints); a server that exits first raises."""
    import subprocess
    import sys
    import uuid

    indices = list(range(num_servers)) if indices is None else list(indices)
    ports = ports or [0] * len(indices)
    env = dict(os.environ if env is None else env)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    os.makedirs(workdir, exist_ok=True)
    procs, readies = [], []
    for i, port in zip(indices, ports):
        ready = os.path.join(workdir, f"ep{i}.{uuid.uuid4().hex}.txt")
        cmd = [sys.executable, "-m", module, "--port", str(port),
               "--server_idx", str(i), "--num_servers", str(num_servers),
               "--ready_path", ready]
        if ssd_dir is not None:
            cmd += ["--ssd_dir", ssd_dir]
        procs.append(subprocess.Popen(cmd, env=env))
        readies.append(ready)
    deadline = time.time() + timeout
    endpoints = []
    for p, ready in zip(procs, readies):
        while not (os.path.exists(ready) and os.path.getsize(ready)):
            if p.poll() is not None or time.time() > deadline:
                for q in procs:
                    q.kill()
                raise RuntimeError(f"table server {module} did not come up "
                                   f"(exit {p.poll()})")
            time.sleep(0.01)
        with open(ready) as f:
            endpoints.append(f.read().strip())
    return procs, endpoints


def run_server(port: int, server_idx: int, num_servers: int,
               ready_path: str | None = None, ssd_dir: str | None = None):
    """Blocking server entry point for a spawned process (the reference's
    server-side main, TheOnePSRuntime._init_server role)."""
    srv = PSServer(port=port, server_idx=server_idx, num_servers=num_servers,
                   ssd_dir=ssd_dir)
    if ready_path:
        with open(ready_path, "w") as f:
            f.write(srv.endpoint)
    srv.serve_forever()


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------

class PSClient:
    """Sharded client (BrpcPsClient role): routes by id % num_servers,
    fans requests to all servers in parallel, reassembles in order."""

    def __init__(self, endpoints: Sequence[str], timeout: float = 60.0):
        from concurrent.futures import ThreadPoolExecutor

        self.endpoints = list(endpoints)
        self.S = len(self.endpoints)
        self._socks: list[socket.socket | None] = [None] * self.S
        self._locks = [threading.Lock() for _ in range(self.S)]
        self._timeout = timeout
        # persistent fan-out pool: pull/push run every training step —
        # per-call thread construction would sit on the hot path
        self._pool = ThreadPoolExecutor(max_workers=self.S,
                                        thread_name_prefix="psclient")

    def _sock(self, s: int) -> socket.socket:
        if self._socks[s] is None:
            host, port = self.endpoints[s].rsplit(":", 1)
            sk = socket.create_connection((host, int(port)),
                                          timeout=self._timeout)
            sk.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._socks[s] = sk
        return self._socks[s]

    def _rpc(self, s: int, op: str, meta: dict, arrays: dict):
        with self._locks[s]:
            try:
                sk = self._sock(s)
                _send_frame(sk, _pack(op, meta, arrays))
                rop, rmeta, rarr = _unpack(_recv_frame(sk))
            except (ConnectionError, OSError, EOFError):
                # a dead/restarted server leaves the cached socket broken —
                # drop it so the next call dials fresh (heter recovery path)
                try:
                    if self._socks[s] is not None:
                        self._socks[s].close()
                except OSError:
                    pass
                self._socks[s] = None
                raise
        if not rmeta.get("ok", False):
            raise RuntimeError(f"PS {op} on server {s} failed: "
                               f"{rmeta.get('err', rmeta)}")
        return rmeta, rarr

    def reset_connections(self):
        """Drop every cached socket; subsequent RPCs reconnect (used by
        recovery paths after a server restart)."""
        for s in range(self.S):
            with self._locks[s]:
                if self._socks[s] is not None:
                    try:
                        self._socks[s].close()
                    except OSError:
                        pass
                    self._socks[s] = None

    def _fan(self, op: str, metas, arrays_by_s):
        futs = {s: self._pool.submit(self._rpc, s, op, metas[s],
                                     arrays_by_s[s])
                for s in range(self.S)}
        return {s: f.result() for s, f in futs.items()}

    # -- table API ----------------------------------------------------------
    def create_table(self, tid: int, vocab: int, dim: int, seed: int = 0,
                     init_range: float = 0.05, storage: str = "mem"):
        """storage="ssd" puts the shard in an mmap'd file on the server
        (SSDSparseTable role; the server needs ssd_dir).  Returns
        {server -> fresh}: True where the shard was just created (used by
        recovery to reload snapshots onto restarted servers ONLY)."""
        meta = {"tid": tid, "vocab": vocab, "dim": dim, "seed": seed,
                "init_range": init_range, "storage": storage}
        out = self._fan("create", [meta] * self.S, [{}] * self.S)
        return {s: bool(out[s][0].get("fresh", False)) for s in range(self.S)}

    def load_shard(self, s: int, dirname: str):
        """Restore ONE server's tables from a snapshot dir (recovery path —
        a plain load() would roll healthy shards back too)."""
        self._rpc(s, "load", {"dir": dirname}, {})

    def push_sparse_shard(self, s: int, tid: int, local_ids: np.ndarray,
                          grads: np.ndarray, lr: float = 0.05):
        """Push pre-sharded LOCAL row grads to one server.  Retry loops use
        this so a shard that already applied its update is never pushed
        twice (adagrad is not idempotent)."""
        self._rpc(s, "push", {"tid": tid, "lr": lr},
                  {"ids": np.asarray(local_ids, np.int64),
                   "grads": np.asarray(grads, np.float32)})

    def push_sparse_delta(self, tid: int, ids: np.ndarray,
                          deltas: np.ndarray):
        """rows[ids] += deltas (the geo-async merge op)."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        deltas = np.asarray(deltas, np.float32).reshape(len(ids), -1)
        srv = ids % self.S
        local = ids // self.S
        metas, arrs = [], []
        for s in range(self.S):
            m = srv == s
            metas.append({"tid": tid})
            arrs.append({"ids": local[m], "deltas": deltas[m]})
        self._fan("push_delta", metas, arrs)

    def pull_sparse(self, tid: int, ids: np.ndarray) -> np.ndarray:
        ids = np.asarray(ids, np.int64).reshape(-1)
        srv = ids % self.S
        local = ids // self.S
        metas, arrs = [], []
        for s in range(self.S):
            metas.append({"tid": tid})
            arrs.append({"ids": local[srv == s]})
        out = self._fan("pull", metas, arrs)
        dim = next(iter(out.values()))[1]["rows"].shape[1]
        res = np.empty((len(ids), dim), np.float32)
        for s in range(self.S):
            res[srv == s] = out[s][1]["rows"]
        return res

    def push_sparse(self, tid: int, ids: np.ndarray, grads: np.ndarray,
                    lr: float = 0.05):
        ids = np.asarray(ids, np.int64).reshape(-1)
        grads = np.asarray(grads, np.float32).reshape(len(ids), -1)
        srv = ids % self.S
        local = ids // self.S
        metas, arrs = [], []
        for s in range(self.S):
            m = srv == s
            metas.append({"tid": tid, "lr": lr})
            arrs.append({"ids": local[m], "grads": grads[m]})
        self._fan("push", metas, arrs)

    # -- graph API (common_graph_table.cc role) ------------------------------
    def create_graph_table(self, tid: int, seed: int = 0):
        """Distributed graph table for GNN sampling: each server owns the
        full out-neighborhood of the nodes with ``src % num_servers ==
        server_idx``."""
        self._fan("g_create", [{"tid": tid, "seed": seed}] * self.S,
                  [{}] * self.S)

    def add_edges(self, tid: int, src, dst, weights=None):
        src = np.asarray(src, np.int64).reshape(-1)
        dst = np.asarray(dst, np.int64).reshape(-1)
        if len(src) != len(dst):
            raise ValueError("src/dst length mismatch")
        w = None if weights is None else np.asarray(
            weights, np.float32).reshape(-1)
        srv = src % self.S
        metas, arrs = [], []
        for s in range(self.S):
            m = srv == s
            metas.append({"tid": tid})
            a = {"src": src[m], "dst": dst[m]}
            if w is not None:
                a["weights"] = w[m]
            arrs.append(a)
        self._fan("g_add_edges", metas, arrs)
        # register dst nodes on THEIR owning shards so per-shard node sets
        # partition the graph (random_sample_nodes stays unbiased)
        dsrv = dst % self.S
        self._fan("g_add_nodes", [{"tid": tid}] * self.S,
                  [{"ids": np.unique(dst[dsrv == s])}
                   for s in range(self.S)])

    def sample_neighbors(self, tid: int, ids, k: int) -> np.ndarray:
        """[n, k] int64 of sampled out-neighbors, -1-padded where the
        degree is below k.  Uniform without replacement, or
        weight-proportional when the edges carried weights."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        srv = ids % self.S
        metas, arrs = [], []
        for s in range(self.S):
            metas.append({"tid": tid, "k": int(k)})
            arrs.append({"ids": ids[srv == s]})
        out = self._fan("g_sample", metas, arrs)
        res = np.full((len(ids), int(k)), -1, np.int64)
        for s in range(self.S):
            res[srv == s] = out[s][1]["nbrs"]
        return res

    def node_degrees(self, tid: int, ids) -> np.ndarray:
        ids = np.asarray(ids, np.int64).reshape(-1)
        srv = ids % self.S
        metas, arrs = [], []
        for s in range(self.S):
            metas.append({"tid": tid})
            arrs.append({"ids": ids[srv == s]})
        out = self._fan("g_degree", metas, arrs)
        res = np.zeros(len(ids), np.int64)
        for s in range(self.S):
            res[srv == s] = out[s][1]["degrees"]
        return res

    def set_node_feat(self, tid: int, ids, feats):
        """Store per-node float feature vectors on the owning shards
        (reference common_graph_table.h:121 set_node_feat).  ``feats`` is
        [n, dim]; the dim is fixed by the first call table-wide."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        feats = np.asarray(feats, np.float32)
        if feats.ndim != 2 or len(feats) != len(ids) or feats.shape[1] == 0:
            raise ValueError(f"feats must be [{len(ids)}, dim>=1], got "
                             f"{feats.shape}")
        if (ids < 0).any():
            # get_node_feat treats negative ids as sample padding — a
            # stored-but-unreadable feature would be a silent write loss
            raise ValueError("negative node ids cannot carry features")
        srv = ids % self.S
        metas, arrs = [], []
        for s in range(self.S):
            m = srv == s
            metas.append({"tid": tid, "dim": int(feats.shape[1])})
            arrs.append({"ids": ids[m], "feats": feats[m]})
        self._fan("g_set_feat", metas, arrs)

    def get_node_feat(self, tid: int, ids):
        """[n, dim] float32 features for ``ids`` plus an [n] bool found
        mask; unknown nodes (including -1 sample padding) zero-fill with
        found=False, so sampled neighborhoods feed the model directly."""
        ids = np.asarray(ids, np.int64)
        shape = ids.shape
        flat = ids.reshape(-1)
        srv = flat % self.S
        # -1 padding from sample_neighbors: never ask a shard for it
        srv = np.where(flat < 0, -1, srv)
        metas, arrs = [], []
        for s in range(self.S):
            metas.append({"tid": tid, "dim": 0})
            arrs.append({"ids": flat[srv == s]})
        out = self._fan("g_get_feat", metas, arrs)
        dims = [out[s][0]["dim"] for s in range(self.S)]
        nonzero = sorted({d for d in dims if d})
        if len(nonzero) > 1:
            # a shard restored from a different-dim snapshot must be LOUD,
            # not silently zero-filled training data
            raise RuntimeError(
                f"graph table {tid}: shards disagree on feature dim "
                f"(per-shard dims {dims}); reload matching snapshots")
        dim = nonzero[0] if nonzero else 0
        res = np.zeros((len(flat), dim), np.float32)
        found = np.zeros(len(flat), bool)
        for s in range(self.S):
            m = srv == s
            fe = out[s][1]["feats"]
            if fe.shape[1] == dim:  # dim-0 shard = no features stored there
                res[m] = fe
                found[m] = out[s][1]["found"].astype(bool)
        return (res.reshape(shape + (dim,)),
                found.reshape(shape))

    def random_sample_nodes(self, tid: int, k: int) -> np.ndarray:
        """k nodes drawn ~uniformly across the whole distributed graph:
        each shard returns k uniform draws from its own node set plus its
        node count; the client keeps a count-weighted mix."""
        out = self._fan("g_nodes", [{"tid": tid, "k": int(k)}] * self.S,
                        [{}] * self.S)
        counts = np.array([out[s][0]["num_nodes"] for s in range(self.S)],
                          np.float64)
        if counts.sum() == 0:
            return np.full(int(k), -1, np.int64)
        take = np.random.multinomial(int(k), counts / counts.sum())
        picks = [out[s][1]["nodes"][:t] for s, t in enumerate(take)]
        res = np.concatenate(picks) if picks else np.empty(0, np.int64)
        # a shard with fewer unique draws than requested never under-fills:
        # the server samples with replacement, so take<=k always satisfiable
        return res

    def graph_stat(self, tid: int) -> dict:
        out = self._fan("g_stat", [{"tid": tid}] * self.S, [{}] * self.S)
        return {"num_nodes": sum(out[s][0]["num_nodes"]
                                 for s in range(self.S)),
                "num_edges": sum(out[s][0]["num_edges"]
                                 for s in range(self.S))}

    # -- dense API (key-sharded by hash) -------------------------------------
    def _dense_server(self, key: str) -> int:
        import zlib

        # stable across processes (python's hash() is per-process salted —
        # workers would route the same key to different servers)
        return zlib.crc32(key.encode()) % self.S

    def push_dense(self, key: str, value: np.ndarray, grad: bool = False,
                   lr: float = 0.05):
        s = self._dense_server(key)
        self._rpc(s, "push_dense", {"key": key, "grad": grad, "lr": lr},
                  {"value": np.asarray(value, np.float32)})

    def pull_dense(self, key: str) -> np.ndarray:
        s = self._dense_server(key)
        _, arr = self._rpc(s, "pull_dense", {"key": key}, {})
        return arr["value"]

    # -- control -------------------------------------------------------------
    def save(self, dirname: str):
        self._fan("save", [{"dir": dirname}] * self.S, [{}] * self.S)

    def load(self, dirname: str):
        self._fan("load", [{"dir": dirname}] * self.S, [{}] * self.S)

    def stat(self):
        return [self._rpc(s, "stat", {}, {})[0] for s in range(self.S)]

    def barrier(self, key: str, world: int, timeout: float = 60.0):
        """All-worker barrier through server 0's counter table (the
        reference BarrierTable role).  Generation-based so the same key is
        reusable across epochs: my arrival number fixes my generation, and
        I wait until that whole generation has arrived — the counter only
        ever grows, no reset race."""
        m, _ = self._rpc(0, "barrier_add", {"key": key}, {})
        gen_target = ((m["count"] - 1) // world + 1) * world
        t0 = time.time()
        while time.time() - t0 < timeout:
            c, _ = self._rpc(0, "barrier_get", {"key": key}, {})
            if c["count"] >= gen_target:
                return True
            time.sleep(0.05)
        raise TimeoutError(f"PS barrier {key!r}")

    def shutdown_servers(self):
        for s in range(self.S):
            try:
                self._rpc(s, "shutdown", {}, {})
            except Exception:  # noqa: BLE001 - best effort on teardown
                pass

    def close(self):
        self._pool.shutdown(wait=False)
        for sk in self._socks:
            if sk is not None:
                try:
                    sk.close()
                except OSError:
                    pass


# ---------------------------------------------------------------------------
# async communicator (a_sync mode)
# ---------------------------------------------------------------------------

class AsyncCommunicator:
    """Client-side async push batching (reference service/communicator.cc:
    per-table send queues, merged batched push, bounded staleness).

    ``push_sparse`` enqueues; a background thread concatenates pending
    (ids, grads) per table — duplicate merge happens server-side — and
    pushes every ``flush_interval`` seconds or ``max_pending`` batches."""

    def __init__(self, client: PSClient, flush_interval: float = 0.01,
                 max_pending: int = 16):
        self.client = client
        self.flush_interval = flush_interval
        self.max_pending = max_pending
        self._q: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        # race-free flush accounting: every enqueued push increments
        # _pushed; only after its batch is ACKed by the server does
        # _applied catch up (no event-flag lost-wakeup window)
        self._cv = threading.Condition()
        self._pushed = 0
        self._applied = 0
        self._err: Exception | None = None
        self._t = threading.Thread(target=self._loop, daemon=True)
        self._t.start()

    def push_sparse(self, tid: int, ids, grads, lr: float = 0.05):
        if self._err is not None:
            raise self._err
        with self._cv:
            self._pushed += 1
        self._q.put((tid, np.asarray(ids, np.int64).reshape(-1),
                     np.asarray(grads, np.float32), float(lr)))

    def _drain(self):
        pending: dict[tuple, list] = {}
        n = 0
        while n < self.max_pending:
            try:
                tid, ids, g, lr = self._q.get_nowait()
            except queue.Empty:
                break
            pending.setdefault((tid, lr), []).append(
                (ids, g.reshape(len(ids), -1)))
            n += 1
        for (tid, lr), items in pending.items():
            ids = np.concatenate([i for i, _ in items])
            grads = np.concatenate([g for _, g in items])
            self.client.push_sparse(tid, ids, grads, lr=lr)
        if n:
            with self._cv:
                self._applied += n
                self._cv.notify_all()
        return n

    def _loop(self):
        while not self._stop.is_set():
            try:
                if self._drain() == 0:
                    self._stop.wait(self.flush_interval)
            except Exception as e:  # noqa: BLE001 - surfaced on next push/flush
                with self._cv:
                    self._err = e
                    self._cv.notify_all()
                return

    def flush(self, timeout: float = 30.0):
        deadline = time.time() + timeout
        with self._cv:
            while self._applied < self._pushed and self._err is None:
                remaining = deadline - time.time()
                if remaining <= 0 or not self._cv.wait(timeout=remaining):
                    raise TimeoutError("AsyncCommunicator flush")
            if self._err is not None:
                raise self._err

    def stop(self):
        self.flush()
        self._stop.set()
        self._t.join(timeout=5)


class GeoCommunicator:
    """Geo-async sparse training (reference SparseGeoTable +
    GeoCommunicator, service/communicator.cc geo mode): the trainer
    trains against a LOCAL row cache (zero-latency pull/push) and every
    ``k_steps`` pushes only the accumulated per-row DELTA to the server
    and refreshes its cache with the globally merged rows — bounded
    staleness instead of per-step round trips."""

    def __init__(self, client: PSClient, tid: int, k_steps: int = 10):
        self.client = client
        self.tid = tid
        self.k_steps = k_steps
        self._cache: dict[int, np.ndarray] = {}  # id -> local row
        self._base: dict[int, np.ndarray] = {}   # id -> row at last sync
        self._dirty: set[int] = set()
        self._step = 0

    def pull(self, ids: np.ndarray) -> np.ndarray:
        ids = np.asarray(ids, np.int64).reshape(-1)
        missing = [int(i) for i in ids if int(i) not in self._cache]
        if missing:
            rows = self.client.pull_sparse(self.tid, np.asarray(missing))
            for i, r in zip(missing, rows):
                self._cache[i] = r.copy()
                self._base[i] = r.copy()
        return np.stack([self._cache[int(i)] for i in ids])

    def push(self, ids: np.ndarray, grads: np.ndarray, lr: float = 0.05):
        """Local SGD on the cache; server sync every k_steps.  Ids never
        pulled are fetched lazily first (push-before-pull is legal)."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        grads = np.asarray(grads, np.float32).reshape(len(ids), -1)
        self.pull(ids)  # ensure every id is cached (no-op when warm)
        for i, g in zip(ids, grads):
            i = int(i)
            self._cache[i] = self._cache[i] - lr * g
            self._dirty.add(i)
        self._step += 1
        if self._step % self.k_steps == 0:
            self.sync()

    def sync(self):
        """Push accumulated deltas, refresh the cache with merged rows."""
        if not self._dirty:
            return
        ids = np.asarray(sorted(self._dirty), np.int64)
        deltas = np.stack([self._cache[int(i)] - self._base[int(i)]
                           for i in ids])
        self.client.push_sparse_delta(self.tid, ids, deltas)
        merged = self.client.pull_sparse(self.tid, ids)
        for i, r in zip(ids, merged):
            self._cache[int(i)] = r.copy()
            self._base[int(i)] = r.copy()
        self._dirty.clear()


def main(argv=None):
    """Server-process CLI: python -m paddle_tpu_torch.distributed.ps_service
    --port P --server_idx I --num_servers N [--ready_path F]"""
    import argparse

    p = argparse.ArgumentParser(prog="paddle_tpu_torch.distributed.ps_service")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--server_idx", type=int, required=True)
    p.add_argument("--num_servers", type=int, required=True)
    p.add_argument("--ready_path", default=None)
    p.add_argument("--ssd_dir", default=None,
                   help="enable storage='ssd' tables (mmap files here)")
    a = p.parse_args(argv)
    run_server(a.port, a.server_idx, a.num_servers, a.ready_path, a.ssd_dir)


if __name__ == "__main__":
    main()
