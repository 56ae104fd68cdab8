"""The port's fleet trace plane (``Router.fleet_trace``,
``dump_fleet_trace``, ``fleet_snapshot``, ``render_fleet_prometheus``) and
the repo's fleet tools on its output, against the JAX package's, on the
CPU.

The cases of ``tests/test_tracing.py`` run on both packages' loopback
fleets over the same small fp32 model and prompts: one Chrome-trace file
where each retired request's spans share one trace id across >= 3
process tracks; ``PADDLE_TPU_TELEMETRY=0`` minting and collecting
nothing with the streams unchanged; greedy parity with tracing on across
{contiguous, paged} x {tick, async}; worker spans crossing a socket.
Both packages must agree on the streams and on the span structure (the
names each trace holds, the tracks).  The fleet's merged TTFT p99 is held
to the histogram merge of the replicas' own snapshots exactly — bucket
counts equal, the rendered value equal to the merge's rounded quantile —
never as two wall-clock renders compared at a tolerance.

The fleet-tool cases of ``tests/test_distributed_trace.py`` run the repo's
stdlib scripts (``tools/check_instrumented.py``, ``tools/merge_timeline.py``,
``tools/fleet_top.py``, loaded by path) on the port's fleet source, its
telemetry log and its snapshots.
"""
import importlib.util
import json
import os
import socket
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu import faults as jfaults
from paddle_tpu import telemetry as jtl
from paddle_tpu.text import fleet as jfleet
from paddle_tpu.text import generate as jgenerate
from paddle_tpu.text import gpt as jgpt
from paddle_tpu.text import serving as jserving
from paddle_tpu_torch import convert, faults
from paddle_tpu_torch import telemetry as tl
from paddle_tpu_torch.text import fleet, serving

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = ("jax", "torch")


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "tools", name + ".py"))
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    return m


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
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
    jcfg = jgpt.GPTConfig(vocab_size=64, hidden_size=32, num_layers=2,
                          num_heads=4, max_seq_len=64, dtype=jnp.float32)
    jp = jax.device_get(jgpt.init_params(jcfg, jax.random.PRNGKey(0)))
    return jcfg, jp, convert.config_from_jax(jcfg), \
        convert.params_from_jax(jp)


class Pkg:
    def __init__(self, name, model):
        jcfg, jp, cfg, params = model
        self.name = name
        if name == "jax":
            self.fleet, self.serving, self.tl = jfleet, jserving, jtl
            self.cfg, self.params, self.dev = jcfg, jp, {}
        else:
            self.fleet, self.serving, self.tl = fleet, serving, tl
            self.cfg, self.params, self.dev = cfg, params, {"device": "cpu"}

    def server(self, **kw):
        return self.serving.DecodeServer(self.params, self.cfg, **self.dev,
                                         **kw)

    def worker(self, **kw):
        return self.fleet.PrefillWorker(self.params, self.cfg, **self.dev,
                                        **kw)


def _both(model):
    return [Pkg(p, model) for p in PKGS]


def _toks(streams):
    return [[int(t) for t in s] for s in streams]


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
        if not any(r._slots or r._queue for r in router.replicas):
            time.sleep(0.002)
    assert not router.pending(), "fleet never drained"
    return _toks([router.result(r) for r in rids])


def _localhost_sockets_ok() -> bool:
    try:
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        s.close()
        return True
    except OSError:
        return False


requires_sockets = pytest.mark.skipif(
    not _localhost_sockets_ok(),
    reason="sandbox has no localhost sockets")


@pytest.fixture()
def fleet_env(monkeypatch):
    def set_(**kw):
        for k, v in kw.items():
            if v is None:
                monkeypatch.delenv(k, raising=False)
            else:
                monkeypatch.setenv(k, v)
        jgenerate._GEN_CACHE.clear()
        jserving._STEP_CACHE.clear()
    yield set_
    jgenerate._GEN_CACHE.clear()
    jserving._STEP_CACHE.clear()


def _span_shape(evs):
    """Per trace: (number of process tracks, sorted span names), sorted —
    the waterfall's structure, free of wall times and ids."""
    by_tid = {}
    for e in evs:
        if e.get("ph") == "X" and "trace_id" in e.get("args", {}):
            g = by_tid.setdefault(e["args"]["trace_id"],
                                  {"pids": set(), "names": set()})
            g["pids"].add(e["pid"])
            g["names"].add(e["name"])
    return by_tid


# ---------------------------------------------------------------------------
# the acceptance drill: one waterfall across the loopback fleet
# ---------------------------------------------------------------------------


def test_fleet_trace_acceptance(model, tmp_path):
    """1 router / 2 replicas / 1 worker, every request handed off: ONE
    trace file where each retired request's spans share a trace id
    across >= 3 tracks, and the merged Prometheus TTFT p99 is the
    histogram merge of the replicas' own snapshots."""
    prompts = _prompts(seed=23)
    ft = _tool("fleet_top")
    out = {}
    for P in _both(model):
        worker = P.worker(max_len=48)
        router = P.fleet.Router(
            [P.server(max_batch=2, max_len=48) for _ in range(2)],
            prefill=[worker], prefill_threshold=2)  # every request hands off
        got = _drive(router, prompts)
        assert all(got)
        path = router.dump_fleet_trace(str(tmp_path / f"{P.name}.json"))
        evs = json.loads(open(path).read())["traceEvents"]
        tracks = {e["pid"]: e["args"]["name"] for e in evs
                  if e.get("ph") == "M" and e.get("name") == "process_name"}
        assert any(n.endswith("router") for n in tracks.values())
        by_tid = _span_shape(evs)
        assert len(by_tid) == len(prompts)           # one trace a request
        for tid, g in by_tid.items():
            assert len(g["pids"]) >= 3, (tid, g)     # router+worker+replica
            assert {"queue_wait", "route", "inject",
                    "decode", "retire"} <= g["names"], (tid, g)
            assert any(n.startswith("prefill_chunk[") for n in g["names"])
        # the fleet p99 is the merge of the replicas' own histograms: the
        # same bucket counts, hence the same (rounded) quantile
        expect = P.tl.Histogram("expect.ttft")
        for r in router.replicas:
            st = r.local_snapshot()["histograms"].get("serving.ttft_ms")
            if st is not None:
                expect.merge(st)
        snap = router.fleet_snapshot()
        merged = snap["fleet"]["histograms"]["serving.ttft_ms"]
        assert merged["count"] == expect.summary()["count"] == len(prompts)
        prom = router.render_fleet_prometheus()
        line = [ln for ln in prom.splitlines()
                if ln.startswith("paddle_tpu_fleet_ttft_p99_ms ")]
        assert len(line) == 1
        assert float(line[0].split()[1]) == round(expect.quantile(0.99), 6)
        assert 'replica="0"' in prom and 'replica="1"' in prom
        frame = ft.render(router.fleet_snapshot())
        assert "replicas" in frame and "ttft p99" in frame
        assert "trace" in frame
        router.close()
        worker.close()
        out[P.name] = (got, sorted(
            (len(g["pids"]), tuple(sorted(g["names"])))
            for g in by_tid.values()), sorted(
            n.split(".", 1)[1] for n in tracks.values()
            if n.startswith("fleet.")))
    assert out["torch"] == out["jax"]


def test_fleet_trace_telemetry_off_noop(fleet_env, model):
    """``PADDLE_TPU_TELEMETRY=0``: no trace context minted or attached on
    the fleet path, nothing collected — and the same streams."""
    prompts = _prompts(seed=29)
    out = {}
    for P in _both(model):
        fleet_env(PADDLE_TPU_TELEMETRY=None)
        ref = _single(P, prompts)
        fleet_env(PADDLE_TPU_TELEMETRY="0")
        worker = P.worker(max_len=48)
        router = P.fleet.Router(
            [P.server(max_batch=2, max_len=48) for _ in range(2)],
            prefill=[worker], prefill_threshold=2)
        rids = [router.submit(p, max_new_tokens=6) for p in prompts]
        assert all("trace" not in router._requests[r]["req"] for r in rids)
        deadline = time.time() + 120
        while router.pending() and time.time() < deadline:
            router.tick()
            if not any(r._slots or r._queue for r in router.replicas):
                time.sleep(0.002)
        got = _toks([router.result(r) for r in rids])
        assert got == ref
        assert router.fleet_trace() == {}
        router.close()
        worker.close()
        out[P.name] = got
    assert out["torch"] == out["jax"]


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("dispatch", ["tick", "async"])
def test_fleet_bit_parity_with_tracing_on(model, layout, dispatch):
    """Tracing records nothing on the device and changes no token: greedy
    parity against the single server in every layout x dispatch, spans
    flowing the whole time."""
    kw = ({} if layout == "contiguous"
          else {"layout": "paged", "block_size": 8})
    if dispatch == "async":
        kw["async_dispatch"] = True
    prompts = _prompts(seed=31)
    out = {}
    for P in _both(model):
        ref = _single(P, prompts, **kw)
        P.tl.reset()
        worker = P.worker(
            max_len=48, **({"layout": "paged", "block_size": 8}
                           if layout == "paged" else {}))
        router = P.fleet.Router(
            [P.server(max_batch=2, max_len=48, **kw) for _ in range(2)],
            prefill=[worker], prefill_threshold=2)
        got = _drive(router, prompts)
        tracks = router.fleet_trace()
        router.close()
        worker.close()
        assert got == ref
        names = {s["name"] for spans in tracks.values() for s in spans}
        assert {"queue_wait", "route", "decode", "retire"} <= names
        out[P.name] = (got, sorted(names), sorted(tracks))
    assert out["torch"] == out["jax"]


@requires_sockets
def test_cross_process_trace_over_sockets(model):
    """A worker served over TCP: its spans ride the codec back on the
    replies, into the router's ``worker-0`` track, stitched to the trace
    ids the replicas retire (wall-clock stamps survive the wire)."""
    prompts = _prompts(seed=37)
    out = {}
    for P in _both(model):
        worker = P.worker(max_len=48)
        listener = P.fleet.serve_prefill_worker(worker)
        ep = P.fleet.SocketTransport.connect("127.0.0.1", listener.port)
        router = P.fleet.Router(
            [P.server(max_batch=2, max_len=48) for _ in range(2)],
            prefill=[ep], prefill_threshold=2)
        got = _drive(router, prompts)
        assert all(got)
        tracks = router.fleet_trace()
        router.close()
        worker.close()
        listener.close()
        wtids = {s["trace_id"] for s in tracks.get("worker-0", [])}
        assert wtids, "no worker spans crossed the socket"
        rtids = {s["trace_id"] for nm, spans in tracks.items()
                 if nm.startswith("replica-") for s in spans}
        assert wtids <= rtids
        for s in tracks["worker-0"]:
            assert s["ts"] > 1e9
        out[P.name] = (got, sorted({s["name"]
                                    for s in tracks["worker-0"]}))
    assert out["torch"] == out["jax"]


# ---------------------------------------------------------------------------
# the fleet tools on the port's output
# ---------------------------------------------------------------------------


def test_trace_lint_fixture_and_repo_clean():
    """The TRACE lint rule (every path that moves a request carries its
    trace context or drops it on purpose) on fixtures, and on the port's
    fleet."""
    ci = _tool("check_instrumented")
    bad = ("def _handoff_prefill(self, rid, rec):\n"
           "    self.endpoint.send({'rid': rid})\n")
    vs = ci.scan_trace_source(bad, "f.py")
    assert len(vs) == 1 and "trace" in vs[0][2]
    good = ("def _handoff_prefill(self, rid, rec):\n"
            "    job = {'rid': rid}\n"
            "    tr = rec['req'].get('trace')\n"
            "    if tr is not None:\n"
            "        job['trace'] = tr\n"
            "    self.endpoint.send(job)\n")
    assert ci.scan_trace_source(good, "f.py") == []
    dropped = ("def _migrate_chains(self, req):\n"
               "    req.pop('trace', None)  # spans end at migration\n"
               "    self._move(req)\n")
    assert ci.scan_trace_source(dropped, "f.py") == []
    delegated = ("def adopt_and_reroute(self, rid):\n"
                 "    self._handoff_prefill(rid, self._requests[rid])\n")
    assert ci.scan_trace_source(delegated, "f.py") == []
    assert ci.scan_trace_source("def tick(self):\n    pass\n",
                                "f.py") == []
    with open(os.path.join(REPO, "paddle_tpu_torch", "text",
                           "fleet.py")) as f:
        assert ci.scan_trace_source(f.read(), "fleet.py") == []


def test_merge_timeline_multi_log_spans(model, tmp_path, monkeypatch):
    """``merge_timeline`` merges span logs on the shared wall clock: the
    reference's two-file fixture (cross-file deltas kept exactly), and
    two replicas' logs the port's fleet wrote
    (``PADDLE_TPU_TELEMETRY_LOG``), each request's spans rebased past
    zero under its trace id."""
    mt = _tool("merge_timeline")
    wall = 1.7e9
    a = tmp_path / "replica0.jsonl"
    b = tmp_path / "replica1.jsonl"
    a.write_text(json.dumps(
        {"ph": "S", "trace_id": "t-1", "name": "decode",
         "ts": wall + 1.0, "dur": 0.5, "args": {"rid": 4}}) + "\n"
        + json.dumps({"name": "hbm", "ph": "C", "t": 10.0,
                      "args": {"bytes": 1}}) + "\n")
    b.write_text(json.dumps(
        {"ph": "S", "trace_id": "t-1", "name": "prefill_chunk[0]",
         "ts": wall + 0.25, "dur": 0.1}) + "\n")
    doc = mt.merge([str(a), str(b)])
    spans = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    by_name = {e["name"]: e for e in spans}
    assert by_name["prefill_chunk[0]"]["ts"] == pytest.approx(0.0)
    assert by_name["decode"]["ts"] == pytest.approx(0.75e6)
    assert by_name["decode"]["args"]["trace_id"] == "t-1"
    # the port's fleet writes its spans to the telemetry log: one log a
    # replica here (the log switches between the two serves)
    P = Pkg("torch", model)
    logs = []
    for i, prompts in enumerate((_prompts(seed=41), _prompts(seed=43))):
        path = tmp_path / f"port{i}.jsonl"
        monkeypatch.setenv("PADDLE_TPU_TELEMETRY_LOG", str(path))
        router = P.fleet.Router([P.server(max_batch=2, max_len=48)])
        _drive(router, prompts)
        router.close()
        logs.append(str(path))
    monkeypatch.delenv("PADDLE_TPU_TELEMETRY_LOG")
    doc = mt.merge(logs)
    spans = [e for e in doc["traceEvents"]
             if e.get("ph") == "X" and "trace_id" in e.get("args", {})]
    assert {e["pid"] for e in spans} == {0, 1}
    assert min(e["ts"] for e in spans) == pytest.approx(0.0)
    assert all(e["ts"] >= 0 for e in spans)
    names = {e["name"] for e in spans}
    assert {"decode", "retire", "queue_wait", "route"} & names >= {
        "decode", "retire"}
    assert len({e["args"]["trace_id"] for e in spans}) == 8


def test_fleet_top_render_pure(model):
    """``fleet_top.render``: the reference's snapshot fixture, and the
    port router's own snapshot of an idle two-replica fleet."""
    ft = _tool("fleet_top")
    snap = {
        "fleet": {"replicas": 2, "healthy_replicas": 1,
                  "queue_depth": 3, "prefill_outstanding": 1,
                  "uptime_s": 12.5, "tokens_generated": 640,
                  "tok_s": 51.2, "requests_completed": 9,
                  "ttft_p99_ms": 21.0, "tpot_p99_ms": 3.5},
        "replicas": {"0": {"healthy": True, "histograms": {},
                           "summaries": {
                               "serving.ttft_ms": {"count": 5,
                                                   "p99": 21.0}},
                           "counters": {
                               "serving.tokens_generated": 400},
                           "load": {"queue_depth": 1,
                                    "active_slots": 2}},
                     "1": {"healthy": False, "histograms": {},
                           "counters": {}, "load": {}}},
        "trace": {"router": {"spans": 12, "dropped": 0}},
    }
    frame = ft.render(snap)
    assert "2 replicas (1 healthy)" in frame
    assert "51.2 tok/s" in frame
    assert "21.0" in frame
    assert "NO" in frame
    assert "router: 12 spans (0 dropped)" in frame
    P = Pkg("torch", model)
    router = P.fleet.Router([P.server(max_batch=1, max_len=48)
                             for _ in range(2)])
    frame = ft.render(router.fleet_snapshot())
    assert "2 replicas (2 healthy)" in frame
    router.close()
