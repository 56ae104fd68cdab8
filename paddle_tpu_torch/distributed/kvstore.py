"""TCP key-value store: rendezvous, barrier and heartbeat primitive.

Counterpart of ``paddle_tpu/distributed/kvstore.py`` (``send_frame`` :25,
``recv_frame`` :42, ``KVServer`` :55, ``KVClient`` :155), kept byte for
byte on the wire: a port client works against a JAX-package server and
the other way round.  It serves the launcher (``launch.py``: host
registration, the ``tcp://`` init method of the ranks' process group),
elastic membership heartbeats (``elastic.py``) and barriers; its framing
is the one the parameter-server wire (``ps_service.py``) uses.  Pure
stdlib, a thread per connection.

Protocol: length-prefixed JSON requests {op, key, value?, ...} -> {ok,
value?}.  Ops: set, get (blocking-optional), add (atomic counter),
barrier, keys, stamp (server-clock heartbeat), snapshot, delete, ping.
"""
from __future__ import annotations

import json
import socket
import socketserver
import struct
import threading
import time
from typing import Any


def send_frame(sock: socket.socket, payload: bytes):
    """Length-prefixed frame write (shared by the KV store and the PS
    service wire — one framing implementation to fix, not two)."""
    sock.sendall(struct.pack("!I", len(payload)) + payload)


def read_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    while n:
        b = sock.recv(min(n, 1 << 20))
        if not b:
            raise ConnectionError("peer closed")
        chunks.append(b)
        n -= len(b)
    return b"".join(chunks)


def recv_frame(sock: socket.socket) -> bytes:
    (n,) = struct.unpack("!I", read_exact(sock, 4))
    return read_exact(sock, n)


def _send(sock: socket.socket, obj: Any):
    send_frame(sock, json.dumps(obj).encode())


def _recv(sock: socket.socket) -> Any:
    return json.loads(recv_frame(sock).decode())


class KVServer:
    """Threaded TCP KV server; start() returns the bound (host, port)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        store: dict[str, Any] = {}
        cond = threading.Condition()

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                try:
                    while True:
                        req = _recv(self.request)
                        op = req.get("op")
                        if op == "set":
                            with cond:
                                store[req["key"]] = req["value"]
                                cond.notify_all()
                            _send(self.request, {"ok": True})
                        elif op == "get":
                            timeout = req.get("timeout", 0)
                            deadline = time.time() + timeout
                            with cond:
                                while req["key"] not in store:
                                    left = deadline - time.time()
                                    if timeout == 0 or left <= 0:
                                        break
                                    cond.wait(min(left, 1.0))
                                val = store.get(req["key"])
                            _send(self.request,
                                  {"ok": req["key"] in store, "value": val})
                        elif op == "add":
                            with cond:
                                cur = int(store.get(req["key"], 0)) + int(
                                    req.get("value", 1))
                                store[req["key"]] = cur
                                cond.notify_all()
                            _send(self.request, {"ok": True, "value": cur})
                        elif op == "barrier":
                            key, world = req["key"], int(req["world"])
                            with cond:
                                cur = int(store.get(key, 0)) + 1
                                store[key] = cur
                                cond.notify_all()
                                deadline = time.time() + req.get("timeout", 300)
                                while int(store.get(key, 0)) % world != 0:
                                    left = deadline - time.time()
                                    if left <= 0:
                                        break
                                    cond.wait(min(left, 1.0))
                                done = int(store.get(key, 0)) % world == 0
                            _send(self.request, {"ok": done})
                        elif op == "keys":
                            with cond:
                                ks = [k for k in store
                                      if k.startswith(req.get("prefix", ""))]
                            _send(self.request, {"ok": True, "value": ks})
                        elif op == "stamp":
                            # heartbeat: stamped with the SERVER clock so
                            # liveness never depends on cross-host clock sync
                            with cond:
                                store[req["key"]] = time.time()
                                cond.notify_all()
                            _send(self.request, {"ok": True})
                        elif op == "snapshot":
                            with cond:
                                kv = {k: v for k, v in store.items()
                                      if k.startswith(req.get("prefix", ""))}
                            _send(self.request, {"ok": True, "value": kv,
                                                 "now": time.time()})
                        elif op == "delete":
                            with cond:
                                store.pop(req["key"], None)
                                cond.notify_all()
                            _send(self.request, {"ok": True})
                        elif op == "ping":
                            _send(self.request, {"ok": True})
                        else:
                            _send(self.request, {"ok": False,
                                                 "error": f"bad op {op}"})
                except (ConnectionError, OSError):
                    pass

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._srv = Server((host, port), Handler)
        self.host, self.port = self._srv.server_address
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True)

    def start(self):
        self._thread.start()
        return self.host, self.port

    def shutdown(self):
        self._srv.shutdown()
        self._srv.server_close()


class KVClient:
    """Client handle; one persistent connection, thread-safe.

    Connection is retried with backoff until ``connect_timeout`` — peers may
    come up before the rank-0 server (the reference's comm-id exchange
    retries the same way)."""

    def __init__(self, host: str, port: int, timeout: float = 300,
                 connect_timeout: float = 60):
        self._addr = (host, port)
        self._lock = threading.Lock()
        deadline = time.time() + connect_timeout
        delay = 0.05
        while True:
            try:
                self._sock = socket.create_connection(self._addr,
                                                      timeout=timeout)
                break
            except OSError:
                if time.time() >= deadline:
                    raise
                time.sleep(delay)
                delay = min(delay * 2, 1.0)

    def _rpc(self, req: dict, wait: float = 0) -> dict:
        with self._lock:
            # the socket deadline must outlive any server-side blocking wait
            self._sock.settimeout(max(30.0, wait + 30.0))
            _send(self._sock, req)
            return _recv(self._sock)

    def set(self, key: str, value):
        return self._rpc({"op": "set", "key": key, "value": value})["ok"]

    def get(self, key: str, timeout: float = 0):
        r = self._rpc({"op": "get", "key": key, "timeout": timeout},
                      wait=timeout)
        return r["value"] if r["ok"] else None

    def add(self, key: str, value: int = 1) -> int:
        return int(self._rpc({"op": "add", "key": key, "value": value})["value"])

    def barrier(self, key: str, world: int, timeout: float = 300) -> bool:
        return self._rpc({"op": "barrier", "key": key, "world": world,
                          "timeout": timeout}, wait=timeout)["ok"]

    def keys(self, prefix: str = "") -> list:
        return self._rpc({"op": "keys", "prefix": prefix})["value"]

    def stamp(self, key: str):
        """Server-clock heartbeat write."""
        return self._rpc({"op": "stamp", "key": key})["ok"]

    def snapshot(self, prefix: str = ""):
        """Returns ({key: value}, server_now) for clock-skew-free liveness."""
        r = self._rpc({"op": "snapshot", "prefix": prefix})
        return r["value"], float(r["now"])

    def delete(self, key: str):
        return self._rpc({"op": "delete", "key": key})["ok"]

    def close(self):
        try:
            self._sock.close()
        except OSError:
            pass
