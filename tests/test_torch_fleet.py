"""The port's serving fleet (paddle_tpu_torch/text/fleet.py and the
server's fleet entries) against the JAX package's, on the CPU: loopback
fleets, the server's handoff entries and the Router.

The cases of ``tests/test_fleet.py`` (its tensor-parallel ones aside),
each run on both packages' fleets over the same small fp32 model (the
JAX weights carried over by ``paddle_tpu_torch/convert.py``) and the same
numpy prompts.  Each requires what the reference case requires of both
packages, and the two packages to agree: the same streams (bit for bit:
both compute in fp32), the same statuses and exception types, and the
same ``fleet.*`` / ``serving.*`` counters.  Fleet streams must also equal
a single ``DecodeServer``'s, on both layouts.  The fleet and stream flags
read as the JAX package's do.

The transports, the wire codec, sockets, streaming, the elastic fleet and
chain migration are in ``tests/test_torch_fleet_stream.py``; the trace
plane in ``tests/test_torch_fleet_trace.py``.
"""
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu import faults as jfaults
from paddle_tpu import flags as jflags
from paddle_tpu import resilience as jres
from paddle_tpu import telemetry as jtl
from paddle_tpu.framework import monitor
from paddle_tpu.text import fleet as jfleet
from paddle_tpu.text import gpt as jgpt
from paddle_tpu.text import serving as jserving
from paddle_tpu_torch import convert, faults, flags, resilience
from paddle_tpu_torch import telemetry as tl
from paddle_tpu_torch.text import fleet, serving

PKGS = ("jax", "torch")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny steps: one intra-op thread runs them far faster than a pool
    contending for a shared CPU."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(autouse=True)
def _clean():
    for f, t in ((jfaults, jtl), (faults, tl)):
        f.reset()
        t.reset()
        t.clear_runtime_wedge()
    yield
    for f, t in ((jfaults, jtl), (faults, tl)):
        f.reset()
        t.clear_runtime_wedge()


@pytest.fixture(scope="module")
def model():
    """The reference suite's random model, fp32 in both packages."""
    jcfg = jgpt.GPTConfig(vocab_size=64, hidden_size=32, num_layers=2,
                          num_heads=4, max_seq_len=64, dtype=jnp.float32)
    jp = jax.device_get(jgpt.init_params(jcfg, jax.random.PRNGKey(0)))
    return jcfg, jp, convert.config_from_jax(jcfg), \
        convert.params_from_jax(jp)


class Pkg:
    """One package's fleet surface over the shared model."""

    def __init__(self, name, model):
        jcfg, jp, cfg, params = model
        self.name = name
        if name == "jax":
            self.fleet, self.serving, self.res = jfleet, jserving, jres
            self.tl, self.faults = jtl, jfaults
            self.cfg, self.params, self.dev = jcfg, jp, {}
        else:
            self.fleet, self.serving, self.res = fleet, serving, resilience
            self.tl, self.faults = tl, faults
            self.cfg, self.params, self.dev = cfg, params, {"device": "cpu"}

    def server(self, **kw):
        return self.serving.DecodeServer(self.params, self.cfg, **self.dev,
                                         **kw)

    def worker(self, **kw):
        return self.fleet.PrefillWorker(self.params, self.cfg, **self.dev,
                                        **kw)

    def count(self, name) -> int:
        if self.name == "jax":
            return int(monitor.get_stat(name).get())
        return tl.counter(name)

    def reset(self):
        self.tl.reset()


def _both(model):
    return [Pkg(p, model) for p in PKGS]


def _toks(streams):
    return [[int(t) for t in s] for s in streams]


def _layout_kw(layout):
    return ({} if layout == "contiguous"
            else {"layout": "paged", "block_size": 8})


def _prompts(n_short=3, long_len=20, seed=7):
    rng = np.random.default_rng(seed)
    lens = [int(x) for x in rng.integers(3, 8, n_short)] + [long_len]
    return [[int(x) for x in rng.integers(1, 60, n)] for n in lens]


def _single(P, prompts, max_new=6, max_len=48, **kw):
    srv = P.server(max_batch=len(prompts), max_len=max_len, **kw)
    rids = [srv.submit(p, max_new_tokens=max_new) for p in prompts]
    while srv.pending():
        srv.tick()
    out = [srv.result(r) for r in rids]
    srv.close()
    return _toks(out)


def _drive(router, prompts, max_new=6, timeout_s=120.0):
    rids = [router.submit(p, max_new_tokens=max_new) for p in prompts]
    deadline = time.time() + timeout_s
    while router.pending() and time.time() < deadline:
        router.tick()
        if not any(r._slots or r._queue for r in router.replicas
                   if r is not None):
            # nothing decoding: the fleet waits on a worker thread
            time.sleep(0.002)
    assert not router.pending(), "fleet never drained"
    return _toks([router.result(r) for r in rids])


# ---------------------------------------------------------------------------
# the flags
# ---------------------------------------------------------------------------


_FLAGS = [
    ("fleet_prefill_threshold", "PADDLE_TPU_FLEET_PREFILL_THRESHOLD", "24"),
    ("fleet_tick_block", "PADDLE_TPU_FLEET_TICK_BLOCK", "4"),
    ("fleet_tick_workers", "PADDLE_TPU_FLEET_TICK_WORKERS", "3"),
    ("fleet_max_queue", "PADDLE_TPU_FLEET_MAX_QUEUE", "0"),
    ("fleet_metrics_port", "PADDLE_TPU_FLEET_METRICS_PORT", "0"),
    ("prefix_route", "PADDLE_TPU_PREFIX_ROUTE", "off"),
    ("prefix_route_imbalance", "PADDLE_TPU_PREFIX_ROUTE_IMBALANCE", "5"),
    ("fleet_autoscale", "PADDLE_TPU_FLEET_AUTOSCALE", "1"),
    ("fleet_scale_out_ticks", "PADDLE_TPU_FLEET_SCALE_OUT_TICKS", "7"),
    ("fleet_scale_in_ticks", "PADDLE_TPU_FLEET_SCALE_IN_TICKS", "9"),
    ("fleet_scale_rung", "PADDLE_TPU_FLEET_SCALE_RUNG", "3"),
    ("stream_chunk_rows", "PADDLE_TPU_STREAM_CHUNK_ROWS", "0"),
]


@pytest.mark.parametrize("name,env,value", _FLAGS,
                         ids=[f[0] for f in _FLAGS])
def test_fleet_flags_read_as_the_jax_package(monkeypatch, name, env,
                                             value):
    """Each fleet and stream flag: the same environment name, default,
    parse of a set value and fallback on garbage or a negative value as
    ``paddle_tpu/flags.py``."""
    ours, theirs = getattr(flags, name), getattr(jflags, name)
    monkeypatch.delenv(env, raising=False)
    assert ours() == theirs()
    for v in (value, "garbage", "-3", ""):
        monkeypatch.setenv(env, v)
        assert ours() == theirs(), v


# ---------------------------------------------------------------------------
# loopback fleet: greedy bit parity against one DecodeServer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_loopback_fleet_bit_parity(model, layout):
    """Router + 2 decode replicas + 1 prefill worker == one server, bit
    for bit, on a mixed short/long stream (the long prompt's prefill runs
    in the worker and injects) — and the port's fleet == the JAX
    fleet."""
    kw = _layout_kw(layout)
    prompts = _prompts()
    out = {}
    for P in _both(model):
        ref = _single(P, prompts, **kw)
        P.reset()
        worker = P.worker(max_len=48, layout=layout, block_size=8)
        router = P.fleet.Router(
            [P.server(max_batch=2, max_len=48, **kw) for _ in range(2)],
            prefill=[worker], prefill_threshold=16)
        got = _drive(router, prompts)
        health = router.healthz()
        router.close()
        assert got == ref
        assert health["ok"] and len(health["replicas"]) == 2
        assert P.count("fleet.prefill_handoffs") >= 1
        assert P.count("fleet.routed") >= len(prompts)
        assert P.count("fleet.requests") == len(prompts)
        out[P.name] = (got, {n: P.count(n) for n in (
            "fleet.prefill_handoffs", "fleet.routed", "fleet.requests",
            "serving.prefilled_rows")})
    assert out["torch"] == out["jax"]


def test_fleet_without_prefill_workers_still_matches(model):
    """No workers: every admission runs on its replica — still the single
    server's streams."""
    prompts = _prompts(seed=11)
    out = {}
    for P in _both(model):
        ref = _single(P, prompts)
        router = P.fleet.Router(
            [P.server(max_batch=2, max_len=48) for _ in range(2)])
        got = _drive(router, prompts)
        router.close()
        assert got == ref
        out[P.name] = got
    assert out["torch"] == out["jax"]


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_submit_prefilled_matches_local_admission(model, layout):
    """The decode half of the handoff alone: a worker's rows through
    ``submit_prefilled`` decode as a locally prefilled request."""
    kw = _layout_kw(layout)
    prompt = _prompts()[3]
    out = {}
    for P in _both(model):
        ref = _single(P, [prompt], **kw)
        P.reset()
        worker = P.worker(max_len=48, layout=layout, block_size=8)
        rows, logits = worker.prefill(prompt)
        worker.close()
        srv = P.server(max_batch=1, max_len=48, **kw)
        rid = srv.submit_prefilled(prompt, rows, logits, max_new_tokens=6)
        while srv.pending():
            srv.tick()
        got = _toks([srv.result(rid)])
        srv.close()
        assert got == ref
        assert P.count("serving.prefilled_submissions") == 1
        out[P.name] = (got, np.asarray(logits, np.float32))
    assert out["torch"][0] == out["jax"][0]
    np.testing.assert_allclose(out["torch"][1], out["jax"][1], rtol=1e-5,
                               atol=1e-5)


def test_worker_rows_equal_the_jax_workers(model):
    """The rows themselves: the port worker's rows for a prompt equal the
    JAX worker's within fp32 rounding, leaf for leaf, on both layouts."""
    prompt = _prompts()[3]
    for layout in ("contiguous", "paged"):
        got = {}
        for P in _both(model):
            w = P.worker(max_len=48, layout=layout, block_size=8)
            rows, _ = w.prefill(prompt)
            w.close()
            got[P.name] = {n: np.asarray(v, np.float32)
                           for n, v in rows.items()}
        assert set(got["torch"]) == set(got["jax"])
        for n in got["jax"]:
            assert got["torch"][n].shape == got["jax"][n].shape
            np.testing.assert_allclose(got["torch"][n], got["jax"][n],
                                       rtol=1e-5, atol=1e-5)


def test_submit_prefilled_rejects_mismatched_rows(model):
    for P in _both(model):
        worker = P.worker(max_len=48)
        rows, logits = worker.prefill([1, 2, 3])
        worker.close()
        srv = P.server(max_batch=1, max_len=48)
        with pytest.raises(ValueError, match="cover 3 positions"):
            srv.submit_prefilled([1, 2], rows, logits)
        rows = dict(rows)
        rows.pop("v")
        with pytest.raises(ValueError, match="leaves"):
            srv.submit_prefilled([1, 2, 3], rows, logits)
        srv.close()


def test_submit_prefilled_rejects_dtype_drift(model):
    """Same leaves, another storage dtype (env drift between a worker
    process and the server): refused, never cast."""
    for P in _both(model):
        worker = P.worker(max_len=48)
        rows, logits = worker.prefill([1, 2, 3])
        worker.close()
        srv = P.server(max_batch=1, max_len=48)
        if P.name == "jax":
            rows = {n: np.asarray(v).astype(np.float16)
                    for n, v in rows.items()}
        else:
            rows = {n: v.to(torch.float16) for n, v in rows.items()}
        with pytest.raises(ValueError, match="dtype drift|stores"):
            srv.submit_prefilled([1, 2, 3], rows, logits)
        srv.close()


def test_prefill_worker_error_reported_at_router(model):
    """A raw (window-unknown) endpoint whose worker refuses the prompt
    reports it over the transport: the request retires ``error``."""
    for P in _both(model):
        lt = P.fleet.LoopbackTransport()
        worker = P.worker(max_len=8, endpoint=lt.worker)    # tiny window
        worker.start()
        router = P.fleet.Router([P.server(max_batch=2, max_len=48)],
                                prefill=[lt.client], prefill_threshold=10)
        rid = router.submit(list(range(1, 21)), max_new_tokens=4)
        deadline = time.time() + 10.0
        while router.status(rid) == "prefilling" \
                and time.time() < deadline:
            router.tick()
            time.sleep(0.01)
        assert router.status(rid) == "error"
        with pytest.raises(RuntimeError, match="failed"):
            router.result(rid)
        assert P.count("fleet.prefill_errors") == 1
        router.close()
        worker.close()


def test_small_window_owned_worker_falls_back_to_local(model):
    """An owned worker's window is known: a prompt past it prefills on
    its replica; fitting prompts still hand off."""
    long_p = list(range(1, 13))
    out = {}
    for P in _both(model):
        ref = _single(P, [long_p])
        worker = P.worker(max_len=8)
        router = P.fleet.Router([P.server(max_batch=2, max_len=48)],
                                prefill=[worker], prefill_threshold=4)
        rid = router.submit(long_p, max_new_tokens=6)
        while router.pending():
            router.tick()
        assert router.status(rid) == "ok"
        got = _toks([router.result(rid)])
        assert got == ref
        assert P.count("fleet.prefill_handoffs") == 0
        short = router.submit([1, 2, 3, 4, 5], max_new_tokens=4)
        deadline = time.time() + 30.0
        while router.pending() and time.time() < deadline:
            router.tick()
            time.sleep(0.002)
        assert router.status(short) == "ok"
        assert P.count("fleet.prefill_handoffs") == 1
        out[P.name] = got + _toks([router.result(short)])
        router.close()
    assert out["torch"] == out["jax"]


def test_injected_prefill_adopts_shared_prefix(model):
    """Paged handoff reuse: a repeated prompt through a worker adopts the
    indexed blocks at injection (prefix hits), streams unchanged."""
    prompt = _prompts()[3]
    out = {}
    for P in _both(model):
        ref = _single(P, [prompt], layout="paged", block_size=8)
        replica = P.server(max_batch=2, max_len=48, layout="paged",
                           block_size=8)
        worker = P.worker(max_len=48, layout="paged", block_size=8)
        router = P.fleet.Router([replica], prefill=[worker],
                                prefill_threshold=8)
        first = _drive(router, [prompt])
        hits0 = replica._pool.stats()["prefix_hits"]
        second = _drive(router, [prompt])
        hits1 = replica._pool.stats()["prefix_hits"]
        router.close()
        assert first == ref and second == ref
        assert hits1 > hits0, "repeat injection adopted no indexed blocks"
        out[P.name] = (first, second, hits0, hits1)
    assert out["torch"] == out["jax"]


def test_request_rejected_by_every_replica_errors_not_livelocks(model):
    """A request no replica's pool can ever hold retires ``error``
    instead of parking in the fleet queue."""
    for P in _both(model):
        router = P.fleet.Router(
            [P.server(max_batch=1, max_len=48, layout="paged",
                      block_size=8, num_blocks=2)])      # a 16-row pool
        rid = router.submit([1] * 30, max_new_tokens=10)  # needs 5 blocks
        for _ in range(8):
            router.tick()
        assert router.status(rid) == "error"
        with pytest.raises(RuntimeError, match="KV blocks"):
            router.result(rid)
        assert P.count("fleet.route_errors") == 1
        assert not router.pending()
        router.close()


# ---------------------------------------------------------------------------
# scheduling: TTL shed, priority, load balancing
# ---------------------------------------------------------------------------


def test_router_ttl_shed(model):
    """A request still fleet-queued past its TTL sheds ``timeout``.  The
    expiry is made certain, not raced: the queued request's enqueue
    stamp is moved back past its TTL before the next tick."""
    out = {}
    for P in _both(model):
        router = P.fleet.Router([P.server(max_batch=1, max_len=48)],
                                max_queue=0)       # the 2nd stays queued
        keep = router.submit([1, 2, 3], max_new_tokens=8)
        shed = router.submit([4, 5, 6], max_new_tokens=4, ttl_s=0.001)
        assert router.status(shed) == "queued"
        router._requests[shed]["req"]["t_enqueue"] -= 1.0
        while router.pending():
            router.tick()
        assert router.status(keep) == "ok"
        assert router.status(shed) == "timeout"
        with pytest.raises(P.res.DeadlineExceeded):
            router.result(shed)
        assert P.count("fleet.ttl_sheds") == 1
        out[P.name] = _toks([router.result(keep)])
        router.close()
    assert out["torch"] == out["jax"]


def test_router_priority_dispatches_first(model):
    """With one busy replica, the higher-priority queued request takes
    the next free slot whatever the submit order."""
    out = {}
    for P in _both(model):
        router = P.fleet.Router([P.server(max_batch=1, max_len=48)],
                                max_queue=0)
        router.submit([1, 2], max_new_tokens=2)
        low = router.submit([3, 4], max_new_tokens=2, priority=0)
        high = router.submit([5, 6], max_new_tokens=2, priority=5)
        ticks = 0
        for _ in range(64):
            if router.status(high) != "queued":
                break
            router.tick()
            ticks += 1
        assert router.status(high) != "queued"
        assert router.status(low) == "queued"
        while router.pending():
            router.tick()
        out[P.name] = (ticks, _toks([router.result(low),
                                     router.result(high)]))
        router.close()
    assert out["torch"] == out["jax"]


def test_router_load_balances_on_gauge_triple(model):
    """Four concurrent requests over two 2-slot replicas spread 2/2."""
    out = {}
    for P in _both(model):
        replicas = [P.server(max_batch=2, max_len=48) for _ in range(2)]
        router = P.fleet.Router(replicas)
        rids = [router.submit([1 + i, 2 + i], max_new_tokens=4)
                for i in range(4)]
        spread = [len(r._slots) for r in replicas]
        assert spread == [2, 2]
        where = [router._requests[r]["replica"] for r in rids]
        while router.pending():
            router.tick()
        out[P.name] = (where, _toks([router.result(r) for r in rids]))
        router.close()
    assert out["torch"] == out["jax"]


def test_router_submit_validation(model):
    for P in _both(model):
        router = P.fleet.Router([P.server(max_batch=1, max_len=48)])
        with pytest.raises(ValueError, match="empty prompt"):
            router.submit([], max_new_tokens=4)
        with pytest.raises(ValueError, match="window"):
            router.submit([1] * 40, max_new_tokens=40)
        with pytest.raises(ValueError, match="ttl"):
            router.submit([1], max_new_tokens=1, ttl_s=-1.0)
        router.close()
        with pytest.raises(ValueError, match="at least one"):
            P.fleet.Router([])


# ---------------------------------------------------------------------------
# prefix-aware routing: affinity, the imbalance cap, one snapshot a tick
# ---------------------------------------------------------------------------


def test_router_prefix_affinity_sticks_to_warm_replica(model):
    """A tenant's repeats land on the replica holding its radix chain
    (fingerprint match), each counted by ``fleet.prefix_routed``."""
    rng = np.random.default_rng(12)
    pre = [int(x) for x in rng.integers(1, 60, 12)]
    out = {}
    for P in _both(model):
        replicas = [P.server(max_batch=2, max_len=48, **_layout_kw("paged"))
                    for _ in range(2)]
        router = P.fleet.Router(replicas)
        rid0 = router.submit(pre + [61], max_new_tokens=2)
        while router.pending():
            router.tick()
        home = router._requests[rid0]["replica"]
        routed0 = P.count("fleet.prefix_routed")
        rids = []
        for t in range(3):
            rid = router.submit(pre + [50 + t], max_new_tokens=2)
            while router.pending():
                router.tick()
            rids.append(rid)
        where = [router._requests[r]["replica"] for r in rids]
        assert where == [home] * 3
        assert P.count("fleet.prefix_routed") - routed0 >= 3
        out[P.name] = (home, where, P.count("fleet.prefix_routed"),
                       replicas[home].load_stats()["prefix_summary"])
        router.close()
    assert out["torch"] == out["jax"]


def test_router_prefix_affinity_imbalance_cap_fills_cold_replica(model):
    """Affinity is capped: a hot tenant's flood pins to its warm replica
    only while it stays within the imbalance cap; the overflow fills the
    cold replica by load."""
    rng = np.random.default_rng(13)
    pre = [int(x) for x in rng.integers(1, 60, 12)]
    out = {}
    for P in _both(model):
        replicas = [P.server(max_batch=1, max_len=48, **_layout_kw("paged"))
                    for _ in range(2)]
        router = P.fleet.Router(replicas, max_queue=4)
        rid0 = router.submit(pre + [61], max_new_tokens=2)
        while router.pending():
            router.tick()
        home = router._requests[rid0]["replica"]
        rids = [router.submit(pre + [40 + i], max_new_tokens=2)
                for i in range(6)]
        where = [router._requests[r]["replica"] for r in rids]
        assert set(where) == {0, 1}
        assert where.count(home) >= 3
        assert where.count(1 - home) >= 2
        while router.pending():
            router.tick()
        out[P.name] = (home, where, _toks([router.result(r) for r in rids]))
        router.close()
    assert out["torch"] == out["jax"]


def test_router_snapshots_load_once_per_tick(model):
    """One ``load_stats()`` read per healthy replica per round, however
    deep the fleet queue."""
    out = {}
    for P in _both(model):
        replicas = [P.server(max_batch=1, max_len=48) for _ in range(2)]
        router = P.fleet.Router(replicas, max_queue=0)
        reads = [0, 0]
        for i, r in enumerate(replicas):
            def wrap(i=i, orig=r.load_stats):
                reads[i] += 1
                return orig()
            r.load_stats = wrap
        rids = [router.submit([1 + i, 2], max_new_tokens=4)
                for i in range(2)]
        extra = [router.submit([7 + i, 8], max_new_tokens=2)
                 for i in range(4)]
        assert sum(reads) > 0
        reads[0] = reads[1] = 0
        router.tick()                      # 4 requests still queued
        assert max(reads) <= 1
        first = list(reads)
        while router.pending():
            router.tick()
        out[P.name] = (first, _toks([router.result(r) for r in
                                     rids + extra]))
        router.close()
    assert out["torch"] == out["jax"]


# ---------------------------------------------------------------------------
# wedge: drain, re-route, aggregated health
# ---------------------------------------------------------------------------


def test_wedged_replica_drains_reroutes_and_healthz_flips(model,
                                                          monkeypatch):
    """The wedge drill: one of two replicas wedges mid-stream — its queued
    request re-routes to the survivor (``fleet.reroutes``), the fleet's
    health flips and recovers, and every stream is a fault-free single
    server's."""
    prompts = _prompts(seed=13)
    out = {}
    for P in _both(model):
        ref = _single(P, prompts, async_dispatch=True)
        P.reset()
        monkeypatch.setenv("PADDLE_TPU_STEP_BUDGET_S", "0.25")
        monkeypatch.setenv("PADDLE_TPU_FAULT_WEDGE_S", "0.8")
        P.faults.install("wedge:tick:1")
        try:
            router = P.fleet.Router(
                [P.server(max_batch=1, max_len=48, async_dispatch=True)
                 for _ in range(2)])
            rids = [router.submit(p, max_new_tokens=6) for p in prompts]
            saw_unhealthy = False
            for _ in range(512):
                if not router.pending():
                    break
                router.tick()
                if not router.healthz()["ok"]:
                    saw_unhealthy = True
            assert not router.pending()
            got = _toks([router.result(r) for r in rids])
            health = router.healthz()
            router.close()
        finally:
            P.faults.reset()
            monkeypatch.delenv("PADDLE_TPU_STEP_BUDGET_S")
            monkeypatch.delenv("PADDLE_TPU_FAULT_WEDGE_S")
        assert saw_unhealthy, "the injected wedge never surfaced in healthz"
        assert health["ok"], "the wedged replica never recovered"
        assert got == ref
        assert P.count("fleet.drains") >= 1
        assert P.count("fleet.reroutes") >= 1
        assert P.count("resilience.wedge_detected") >= 1
        out[P.name] = (got, P.count("fleet.reroutes"), P.count("fleet.drains"))
    assert out["torch"] == out["jax"]


def test_drain_queue_returns_adoptable_requests(model):
    """The drain/adopt handshake alone: a drained queue entry re-enqueues
    on another server and finishes with the same tokens."""
    prompt = [5, 9, 2]
    out = {}
    for P in _both(model):
        ref = _single(P, [prompt])
        a = P.server(max_batch=1, max_len=48)
        a.submit([1, 2], max_new_tokens=2)            # takes the slot
        a.submit(prompt, max_new_tokens=6)            # queued
        drained = a.drain_queue()
        assert len(drained) == 1 and a.load_stats()["queue_depth"] == 0
        b = P.server(max_batch=1, max_len=48)
        rid = b.adopt_request(drained[0])
        while b.pending():
            b.tick()
        got = _toks([b.result(rid)])
        assert got == ref
        while a.pending():
            a.tick()
        a.close()
        b.close()
        out[P.name] = (got, P.count("serving.queue_drained"),
                       P.count("serving.requests_adopted"))
    assert out["torch"] == out["jax"]


def test_adopt_request_checks_window_and_pool(model):
    """``adopt_request`` checks again what a replica can hold: the
    window, and on the paged layout the whole pool, in the JAX server's
    words."""
    for P in _both(model):
        a = P.server(max_batch=1, max_len=48)
        a.submit([1, 2], max_new_tokens=2)
        a.submit(list(range(1, 31)), max_new_tokens=10)
        (req,) = a.drain_queue()
        small = P.server(max_batch=1, max_len=24)
        with pytest.raises(ValueError, match="window"):
            small.adopt_request(req)
        tiny = P.server(max_batch=1, max_len=48, layout="paged",
                        block_size=8, num_blocks=2)
        with pytest.raises(ValueError, match="KV blocks"):
            tiny.adopt_request(req)
        for s in (a, small, tiny):
            s.close()


def test_drain_spares_directly_submitted_requests(model):
    """``drain_queue(rids)``: the router drains only its own work — a
    request submitted directly survives and finishes for its
    submitter."""
    prompt = [5, 9, 2]
    out = {}
    for P in _both(model):
        ref = _single(P, [prompt])
        srv = P.server(max_batch=1, max_len=48)
        srv.submit([1, 2], max_new_tokens=2)
        direct = srv.submit(prompt, max_new_tokens=6)
        drained = srv.drain_queue(rids=set())
        assert drained == [] and srv.load_stats()["queue_depth"] == 1
        while srv.pending():
            srv.tick()
        got = _toks([srv.result(direct)])
        assert got == ref
        srv.close()
        out[P.name] = got
    assert out["torch"] == out["jax"]


def test_load_stats_reads_the_gauge_triple(model):
    out = {}
    for P in _both(model):
        srv = P.server(max_batch=2, max_len=48)
        ls0 = srv.load_stats()
        assert ls0["active_slots"] == 0 and ls0["queue_depth"] == 0
        assert ls0["free_slots"] == 2 and not ls0["wedged"]
        srv.submit([1, 2, 3], max_new_tokens=4)
        ls1 = srv.load_stats()
        assert ls1["active_slots"] == 1
        assert ls1["slot_occupancy"] == 0.5
        assert ls1["kv_utilization"] > 0
        while srv.pending():
            srv.tick()
        out[P.name] = {k: ls1[k] for k in (
            "active_slots", "free_slots", "queue_depth", "slot_occupancy",
            "kv_utilization", "admitting_slots")}
        srv.close()
    assert out["torch"] == out["jax"]
