"""Elastic membership: heartbeat-based scale-up/down detection.

Counterpart of ``paddle_tpu/distributed/elastic.py`` (``ElasticStatus``
:19, ``ElasticManager`` :25; the reference's etcd-backed ElasticManager,
fleet/elastic.py:90).  Membership rides the stdlib KV store
(``kvstore.py``): each host stamps ``elastic/host/<id>`` with the
server's clock; the manager watches the live set and reports the scale
events the launcher acts on — it relaunches the pod with the new world
size, each rank joining a fresh process group.
"""
from __future__ import annotations

import threading
import time

from .kvstore import KVClient


class ElasticStatus:
    OK = "ok"
    SCALE = "scale"
    EXIT = "exit"


class ElasticManager:
    def __init__(self, client: KVClient, host_id: str,
                 np_range: tuple[int, int] | None = None,
                 heartbeat_interval: float = 1.0, ttl: float = 5.0):
        self.c = client
        self.host_id = host_id
        self.interval = heartbeat_interval
        self.ttl = ttl
        self.np_min, self.np_max = np_range or (1, 1 << 30)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._last_live: frozenset = frozenset()

    # -- membership ----------------------------------------------------------
    def register(self):
        self._beat()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        self._last_live = frozenset(self.live_hosts()[: self.np_max])
        return self

    def _beat(self):
        # server-clock stamp: liveness never depends on cross-host clock sync
        self.c.stamp(f"elastic/host/{self.host_id}")

    def _loop(self):
        while not self._stop.is_set():
            self._beat()
            self._stop.wait(self.interval)

    def deregister(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)
        self.c.delete(f"elastic/host/{self.host_id}")

    def live_hosts(self) -> list:
        kv, now = self.c.snapshot("elastic/host/")  # server clock for both
        return sorted(k.split("/", 2)[2] for k, ts in kv.items()
                      if now - float(ts) < self.ttl)

    def resnapshot(self):
        """Re-baseline the membership snapshot (call once every expected
        peer has registered, so their first heartbeats don't read as a
        scale event)."""
        self._last_live = frozenset(self.live_hosts()[: self.np_max])

    def effective_hosts(self) -> list:
        """The np_max-capped membership the job actually runs with."""
        return self.live_hosts()[: self.np_max]

    # -- watch ---------------------------------------------------------------
    def check(self) -> str:
        """Poll once: OK (effective membership unchanged), SCALE (world
        changed within [np_min, np_max] → relaunch), EXIT (below np_min).
        Hosts beyond np_max are ignored (capped), not a scale event."""
        live = self.live_hosts()
        if len(live) < self.np_min:
            return ElasticStatus.EXIT
        effective = frozenset(live[: self.np_max])
        if effective != self._last_live:
            self._last_live = effective
            return ElasticStatus.SCALE
        return ElasticStatus.OK

    def wait_for_np(self, n: int, timeout: float = 60) -> bool:
        deadline = time.time() + timeout
        while time.time() < deadline:
            if len(self.live_hosts()) >= n:
                return True
            time.sleep(self.interval / 2)
        return False
