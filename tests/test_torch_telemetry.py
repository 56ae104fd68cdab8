"""The port's telemetry export (paddle_tpu_torch/telemetry.py) against the
JAX package's, on the CPU.

* the same ``count`` / ``observe`` / ``set_gauge`` calls in both
  registries render the same Prometheus lines for the ``admission.*`` and
  ``serving.*`` series, and fill the same ``admission_snapshot``;
* ``Histogram.state`` / ``merge`` and the span ring's loss accounting
  match the JAX package's (``tests/test_distributed_trace.py``);
  ``mint_trace`` is ``None`` with telemetry or tracing off;
* the recompile watch: a rebuild under another flags key warns and
  counts in both; the device feed's fake-card sample names the JAX
  package's gauges, and a step with walls and no counted build has
  ``None`` cost fields (the cost count: test_torch_device_telemetry.py);
* the JSONL log, and a Chrome trace holding telemetry events, request
  spans and CPU ``torch.profiler`` events on one clock;
* ``MetricsServer`` over loopback on port 0: ``/metrics``, ``/snapshot``,
  ``/healthz`` 200, then 503 after ``set_runtime_wedge`` and 200 again
  after ``clear_runtime_wedge``, ``POST /profile``, 404 elsewhere;
* ``probe_health``'s states on a temporary log, and ``unknown`` with no
  path — the probe log in the checkout is never read.
"""
import datetime
import json
import os
import time
import urllib.error
import urllib.request
import warnings

import numpy as np
import pytest
import torch

from paddle_tpu import telemetry as jtl
from paddle_tpu.framework import monitor
from paddle_tpu_torch import telemetry as tl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in ("PADDLE_TPU_TELEMETRY", "PADDLE_TPU_TRACE",
              "PADDLE_TPU_TELEMETRY_LOG", "PADDLE_TPU_PROBE_LOG",
              "PADDLE_TPU_DEVICE_FEED", "PADDLE_TPU_WEDGE_TTL_S"):
        monkeypatch.delenv(k, raising=False)
    for t in (jtl, tl):
        t.reset()
        t.clear_runtime_wedge()
    yield
    for t in (jtl, tl):
        t.reset()
        t.clear_runtime_wedge()


# names only this file records, so other tests' series in the JAX
# package's process-wide monitor registry cannot mix in
SERIES = ("admission.rung", "admission.budget_level", "admission.sheds",
          "admission.sheds_class0", "admission.tenant_throttles",
          "serving.ttft_ms", "serving.decode_gap_ms", "serving.queue_depth",
          "serving.requests_rejected", "serving.tokens_generated")


def _feed(t):
    rng = np.random.default_rng(3)
    for v in rng.lognormal(1.0, 1.2, 300):
        t.observe("serving.ttft_ms", float(v))
    for v in rng.lognormal(0.5, 0.4, 200):
        t.observe("serving.decode_gap_ms", float(v), n=2)
    t.observe("serving.decode_gap_ms", 0.0)
    t.set_gauge("serving.queue_depth", 7)
    t.set_gauge("admission.rung", 3)
    t.set_gauge("admission.budget_level", 1)
    t.count("admission.sheds", 5)
    t.count("admission.sheds_class0", 4)
    t.count("admission.sheds_class0")
    t.count("admission.tenant_throttles", 2)
    t.count("serving.requests_rejected", 5)
    t.count("serving.tokens_generated", 1234)


def _families(text):
    """The exposition lines of ``SERIES``, TYPE lines included."""
    keep = tuple("paddle_tpu_" + n.replace(".", "_") for n in SERIES)
    out = []
    for line in text.splitlines():
        body = line[len("# TYPE "):] if line.startswith("# TYPE ") else line
        name = body.split(" ")[0].split("{")[0]
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and name[:-len(suffix)] in keep:
                name = name[:-len(suffix)]
        if name in keep:
            out.append(line)
    return out


def test_prometheus_lines_match_jax():
    _feed(jtl)
    _feed(tl)
    ours, theirs = _families(tl.render_prometheus()), \
        _families(jtl.render_prometheus())
    assert ours == theirs
    assert len(ours) > 20
    snap_j = {k: v for k, v in jtl.admission_snapshot().items()
              if k in SERIES}
    assert tl.admission_snapshot() == snap_j


def test_prometheus_text_parses():
    """Every line is a comment or ``name{labels} value``."""
    _feed(tl)
    tl.note_step_time("serving.step", 0.01)
    for line in tl.render_prometheus().splitlines():
        if line.startswith("#"):
            assert line.split()[1] == "TYPE"
            continue
        name, value = line.rsplit(" ", 1)
        float(value)
        assert name.startswith("paddle_tpu_")


def test_histogram_state_and_merge_match_jax():
    rng = np.random.default_rng(11)
    a, b = rng.lognormal(1.0, 1.0, 2000), rng.lognormal(3.0, 0.3, 500)
    merged = {}
    for pkg, t in (("jax", jtl), ("torch", tl)):
        h1, h2 = t.Histogram("m.a"), t.Histogram("m.b")
        for v in a:
            h1.observe(float(v))
        for v in b:
            h2.observe(float(v))
        m = t.Histogram("m").merge(h1).merge(h2.state())
        merged[pkg] = (m.state(), [m.quantile(q) for q in (0.5, 0.9, 0.99)],
                       m.buckets())
        with pytest.raises(ValueError):
            m.merge({"counts": [0, 1], "count": 1, "sum": 1.0,
                     "min": 1.0, "max": 1.0})
    assert merged["torch"] == merged["jax"]
    assert merged["torch"][0]["count"] == 2500


def test_span_ring_loss_accounting_matches_jax():
    got = {}
    for pkg, t in (("jax", jtl), ("torch", tl)):
        ring = t.SpanRing(cap=2)
        trace = t.mint_trace()
        assert trace is not None and "trace_id" in trace
        now = time.perf_counter()
        for i in range(5):
            ring.record(trace, f"s{i}", now, now + 0.001, rid=i)
        seen = [len(ring), ring.dropped]
        spans, dropped = ring.drain()
        ring.record(None, "ghost", now, now + 1.0)
        for i in range(3):
            ring.record(trace, f"t{i}", now, now, rid=i)
        got[pkg] = (seen, [(s["name"], s["args"]) for s in spans], dropped,
                    len(ring), ring.dropped, ring.drain(cap=1)[1])
    assert got["torch"] == got["jax"]
    assert got["torch"][:3] == ([2, 3], [("s0", {"rid": 0}),
                                         ("s1", {"rid": 1})], 3)


def test_mint_trace_none_when_off(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_TRACE", "0")
    assert tl.mint_trace() is None
    monkeypatch.delenv("PADDLE_TPU_TRACE")
    a, b = tl.mint_trace(), tl.mint_trace(parent="x")
    assert a["trace_id"] != b["trace_id"] and b["parent"] == "x"
    monkeypatch.setenv("PADDLE_TPU_TELEMETRY", "0")
    assert tl.mint_trace() is None
    ring = tl.SpanRing(cap=4)
    ring.record({"trace_id": "x"}, "s", 0.0, 1.0)
    assert len(ring) == 0


def test_recompile_watch_matches_jax():
    key_a = ("step", (64, 2, ("", "1")), 8)
    key_b = ("step", (64, 2, ("", "")), 8)
    got = {}
    for pkg, t in (("jax", jtl), ("torch", tl)):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            t.record_compile("serving.step", key_a, ("", "1"), 0.5)
            t.record_compile("serving.step", key_a, ("", "1"), 0.5)
            t.record_compile("serving.other", key_b, ("", ""), None)
            t.record_compile("serving.step", key_b, ("", ""), 0.25)
        ctr = (PKG_CTR[pkg]("compile.count"),
               PKG_CTR[pkg]("compile.recompiles"))
        # the key diff each warning names
        got[pkg] = (ctr, [str(x.message).split("mid-process (")[1]
                          .split(")")[0] for x in w
                          if issubclass(x.category, RuntimeWarning)])
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == (4, 1) and len(got["torch"][1]) == 1
    log = tl.compile_log()
    assert [r["name"] for r in log] == ["serving.step"] * 2 + [
        "serving.other", "serving.step"]
    assert log[0]["seconds"] == 0.5 and log[2]["seconds"] is None


PKG_CTR = {"jax": lambda n: int(monitor.get_stat(n).get()),
           "torch": tl.counter}


class _FakeCard:
    def __init__(self, used):
        self.used = used

    def memory_stats(self):
        return {"bytes_in_use": self.used, "peak_bytes_in_use": 2 * self.used,
                "bytes_limit": 80 << 30}


def test_device_feed_names_and_nulls_match_jax():
    cards = [_FakeCard(1 << 20), _FakeCard(3 << 20)]
    j = jtl.sample_device_stats(min_interval_s=0.0, devices=cards)
    t = tl.sample_device_stats(min_interval_s=0.0, devices=cards)
    assert t == j and len(t) == 6
    assert tl.snapshot()["gauges"]["device.device1_bytes_in_use"] == 3 << 20
    # rate-limited: a second sample within the interval repeats the last
    cards[0].used = 5
    assert tl.sample_device_stats(min_interval_s=60.0, devices=cards) == t
    # a name no build makes: the cost records outlive reset(), as in the
    # JAX package, so a step an earlier serve counted would carry costs
    tl.note_step_time("t.wall_only", 0.02)
    tl.note_step_time("t.wall_only", 0.01)
    feed = tl.device_feed()
    step = feed["steps"]["t.wall_only"]
    assert step["step_calls"] == 2 and 0.01 < step["step_s"] < 0.02
    assert all(step[k] is None for k in ("flops", "bytes_accessed", "mfu",
                                         "bound"))
    assert feed["hbm"] == t
    # no card on this machine: the real sample is empty, never an error
    if not torch.cuda.is_available():
        tl.reset()
        assert tl.sample_device_stats(min_interval_s=0.0) == {}


def test_jsonl_log_and_chrome_trace_with_profiler(tmp_path, monkeypatch):
    log = tmp_path / "tel.jsonl"
    monkeypatch.setenv("PADDLE_TPU_TELEMETRY_LOG", str(log))
    from torch.profiler import ProfilerActivity, profile

    ring = tl.SpanRing()
    trace = tl.mint_trace()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tl.span("serving.request", rid=7):
            x = torch.randn(64, 64)
            (x @ x).sum().item()
        t0 = time.perf_counter()
        ring.record(trace, "prefill", t0, t0 + 1e-3, rid=7)
    tl.sample_device_stats(min_interval_s=0.0, devices=[_FakeCard(9)])
    recs = [json.loads(l) for l in log.read_text().splitlines()]
    assert [r.get("name") for r in recs] == ["serving.request", "prefill",
                                             "hbm"]
    assert recs[1]["ph"] == "S" and recs[2]["ph"] == "C"
    path = tl.dump_chrome_trace(str(tmp_path / "t.json"), profiler=prof,
                                spans=ring.drain()[0])
    evs = json.load(open(path))["traceEvents"]
    names = {e.get("name") for e in evs}
    assert "serving.request" in names and "prefill" in names
    assert any(str(n).startswith("aten::") for n in names)
    # one clock: the request span encloses the matmul the profiler saw
    req = next(e for e in evs if e.get("name") == "serving.request")
    mm = [e for e in evs if e.get("name") in ("aten::mm", "aten::matmul")]
    assert mm and any(req["ts"] - 1e3 <= e["ts"] <= req["ts"] + req["dur"]
                      + 1e3 for e in mm)


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_metrics_server_loopback(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PROFILE_DIR", str(tmp_path / "prof"))
    _feed(tl)
    srv = tl.serve_metrics(0)
    try:
        base = f"http://127.0.0.1:{srv.port}"
        code, body = _get(base + "/metrics")
        assert code == 200 and "paddle_tpu_admission_rung 3" in body
        code, body = _get(base + "/snapshot")
        snap = json.loads(body)
        assert code == 200 and snap["counters"]["admission.sheds"] == 5
        code, body = _get(base + "/healthz")
        h = json.loads(body)
        assert code == 200 and h["ok"] and h["probe"]["status"] == "unknown"
        assert h["admission"]["admission.rung"] == 3
        tl.set_runtime_wedge("drill")
        code, body = _get(base + "/healthz")
        assert code == 503 and json.loads(body)["runtime_wedge"]["wedged"]
        tl.clear_runtime_wedge()
        assert _get(base + "/healthz")[0] == 200
        assert _get(base + "/nope")[0] == 404
        req = urllib.request.Request(base + "/profile?ms=20", method="POST")
        with urllib.request.urlopen(req, timeout=30) as r:
            out = json.loads(r.read())
        assert os.path.exists(os.path.join(out["trace_dir"], "trace.json"))
        req = urllib.request.Request(base + "/profile?ms=0", method="POST")
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=10)
        assert ei.value.code == 400
    finally:
        srv.close()


def _probe_log(path, ok, age_s):
    ts = (datetime.datetime.now(datetime.timezone.utc)
          - datetime.timedelta(seconds=age_s)).isoformat()
    with open(path, "a") as f:
        f.write("not json\n")
        f.write(json.dumps({"ts": ts, "ok": ok}) + "\n")


def test_probe_health_states(tmp_path, monkeypatch):
    p = tmp_path / "probe.jsonl"
    assert tl.probe_health(str(p))["status"] == "unknown"     # no file
    _probe_log(p, True, 5)
    assert tl.probe_health(str(p))["status"] == "ok"
    _probe_log(p, False, 5)
    assert tl.probe_health(str(p))["status"] == "wedged"
    _probe_log(p, False, 4000)
    assert tl.probe_health(str(p))["status"] == "stale"
    assert tl.probe_health(str(p), wedge_window_s=1e5)["status"] == "wedged"
    monkeypatch.setenv("PADDLE_TPU_PROBE_LOG", str(p))
    assert tl.probe_health()["log"] == str(p)
    # no path: unknown, even from the checkout root, whose probe log
    # records another machine
    monkeypatch.delenv("PADDLE_TPU_PROBE_LOG")
    monkeypatch.chdir(REPO)
    h = tl.probe_health()
    assert h == {"status": "unknown", "log": None, "last_probe": None}
