"""The port's admission control (paddle_tpu_torch/text/admission.py and the
DecodeServer's door, class queues and SLO ladder) against the JAX
package's, on the CPU.

* the controller: every behaviour of ``tests/test_admission.py``'s
  controller tests — priority classes and ladder widths, the token
  bucket, overflow victims, the ladder's climb / hold / stepwise
  recovery, the adaptive budget (on and off), the idle reset, the shed
  rung, two tenants under one rate, and ``absorb_fleet_rung`` — driven on
  both packages' ``AdmissionController`` with the same explicit ``now``
  clock and the same histogram feed: the rung, ``budget_level``, the
  verdicts, the per-class sheds and the admitted tokens must be equal at
  every step (one parametrised test);
* the server, on a small random fp32 model in both packages (the same
  weights): ``PADDLE_TPU_ADMISSION=0`` against an unconfigured controller
  (bit-identical, both layouts, sync and async), the bounded class queue,
  ``rejected`` against ``timeout``, the injected ``overload`` fault, the
  ``delay``-driven SLO breach and its idle recovery, ``load_stats``
  carrying the rung; under forced rungs and queue caps the port's
  statuses and streams per request equal the JAX server's;
* the port alone: a ladder move picks among the widths ``warmup`` built
  (no new step and no recompile-watch record), an OOM-evicted request
  keeps its class and its place, ``spec_forced`` and the tenant bucket of
  a ``tenant=`` submit.
"""
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu import faults as jfaults
from paddle_tpu import resilience as jres
from paddle_tpu import telemetry as jtl
from paddle_tpu.framework import monitor
from paddle_tpu.text import admission as jadm
from paddle_tpu.text import gpt as jgpt
from paddle_tpu.text import serving as jserving
from paddle_tpu_torch import convert, faults, resilience
from paddle_tpu_torch import telemetry as tl
from paddle_tpu_torch.text import admission, engine, serving

_ADM_ENV = ("PADDLE_TPU_ADMISSION", "PADDLE_TPU_SLO_TTFT_MS",
            "PADDLE_TPU_SLO_TPOT_MS", "PADDLE_TPU_SLO_WINDOW_S",
            "PADDLE_TPU_TENANT_RATE", "PADDLE_TPU_TENANT_BURST",
            "PADDLE_TPU_ADMISSION_QUEUE_CAP", "PADDLE_TPU_EVICT_REQUEUE_MAX",
            "PADDLE_TPU_ADAPTIVE_BUDGET", "PADDLE_TPU_PREFILL_BUDGET")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny steps: one intra-op thread runs them far faster than a pool
    contending for a shared CPU."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in _ADM_ENV:
        monkeypatch.delenv(k, raising=False)
    for f, t in ((jfaults, jtl), (faults, tl)):
        f.reset()
        t.reset()
    yield
    for f in (jfaults, faults):
        f.reset()


# the two packages, as the scenarios see them: (admission module,
# telemetry module, counter reader)
PKGS = {"jax": (jadm, jtl, lambda n: int(monitor.get_stat(n).get())),
        "torch": (admission, tl, tl.counter)}

SHED_KEYS = ("admission.sheds", "admission.sheds_class0",
             "admission.sheds_class1", "admission.sheds_class2",
             "admission.tenant_throttles", "admission.degradations",
             "admission.recoveries", "admission.budget_shrinks",
             "admission.budget_grows")


def _state(adm, ctr) -> tuple:
    """What the controller shows after a step: rung, budget level, the
    derived levers, the admitted tokens and the admission counters."""
    return (adm.rung, adm.budget_level, adm.effective_budget(64),
            adm.effective_admit_cap(8), adm.spec_forced(), adm.rejecting(),
            dict(adm.admitted_tokens), tuple(ctr(k) for k in SHED_KEYS))


def _gaps(T, ms, n=6):
    for _ in range(n):
        T.observe("serving.decode_gap_ms", ms)


# -- the scenarios: each returns the trace of states it walked -------------


def _sc_classes_and_widths(A, T, ctr):
    return [[A.priority_class(p) for p in (-3, 0, 1, 2, 9)],
            [A.ladder_widths(b) for b in (64, 16, 8, 0, 100, 512)]]


def _sc_token_bucket(A, T, ctr):
    b = A.TokenBucket(rate=100.0, burst=200.0, now=0.0)
    return [b.try_take(200, now=0.0), b.try_take(1, now=0.0),
            b.try_take(100, now=1.0), b.try_take(1000, now=2.0),
            b.level, b.t_last]


def _sc_overflow_victim(A, T, ctr):
    q = [{"priority": 2, "t_enqueue": 1.0}, {"priority": 0, "t_enqueue": 2.0},
         {"priority": 0, "t_enqueue": 5.0}, {"priority": 1, "t_enqueue": 9.0},
         {"priority": 1, "t_enqueue": 3.0}]
    out = []
    for cap in (0, 1, 2):
        adm = A.AdmissionController(scope="t", queue_cap=cap, now=0.0)
        out.append([adm.overflow_victim(q[:n]) for n in range(len(q) + 1)])
    return out


def _sc_ladder(A, T, ctr):
    adm = A.AdmissionController(scope="t", slo_tpot_ms=10.0, window_s=1.0,
                                budget_rungs=(64, 32, 16), now=0.0)
    out, t = [_state(adm, ctr)], 0.0
    for ms, n in ([(50.0, 6)] * 5 + [(1.0, 1)] + [(1.0, 6)] * 5):
        _gaps(T, ms, n)
        t += 1.01
        out.append((adm.control_tick(now=t), _state(adm, ctr)))
        # a tick inside the window evaluates nothing
        out.append(adm.control_tick(now=t + 0.5))
    return out


def _sc_adaptive(A, T, ctr):
    adm = A.AdmissionController(scope="t", slo_tpot_ms=10.0, window_s=1.0,
                                budget_rungs=(64, 32, 16), now=0.0)
    out = []
    for t, ms, idle in ((1.01, 50.0, False), (2.02, 50.0, False),
                        (3.03, 1.0, False), (4.04, 1.0, False),
                        (5.05, 50.0, False), (6.06, None, True)):
        if ms is not None:
            _gaps(T, ms)
        out.append((adm.control_tick(now=t, idle=idle), _state(adm, ctr),
                    adm.stats()))
    return out


def _sc_adaptive_off(A, T, ctr):
    import os
    os.environ["PADDLE_TPU_ADAPTIVE_BUDGET"] = "0"
    try:
        adm = A.AdmissionController(scope="t", slo_tpot_ms=10.0,
                                    window_s=1.0,
                                    budget_rungs=(64, 32, 16), now=0.0)
    finally:
        del os.environ["PADDLE_TPU_ADAPTIVE_BUDGET"]
    out = []
    for t in (1.01, 2.02, 3.03):
        _gaps(T, 50.0)
        out.append((adm.control_tick(now=t), _state(adm, ctr)))
    return out


def _sc_idle_reset(A, T, ctr):
    adm = A.AdmissionController(scope="t", slo_tpot_ms=10.0,
                                slo_ttft_ms=100.0, window_s=1.0, now=0.0)
    out = []
    for t, ms, idle in ((1.01, 50.0, False), (2.02, 50.0, False),
                        (3.03, None, False), (4.04, None, True)):
        if ms is not None:
            _gaps(T, ms)
            T.observe("serving.ttft_ms", 1.0)
        out.append((adm.control_tick(now=t, idle=idle), _state(adm, ctr)))
    return out


def _sc_shed_rung(A, T, ctr):
    adm = A.AdmissionController(scope="t", now=0.0)
    out = []
    for rung in (A.RUNG_SHED - 1, A.RUNG_SHED):
        adm.rung = rung
        out.append([adm.admit(None, p, 10, now=0.0) for p in (-1, 0, 1, 2)])
        out.append(_state(adm, ctr))
    return out


def _sc_tenants(A, T, ctr):
    adm = A.AdmissionController(scope="t", tenant_rate=100.0,
                                tenant_burst=200.0, now=0.0)
    out, t = [], 0.0
    for _ in range(200):
        t += 0.01
        out.append([adm.admit(tn, 0, 10, now=t)[0] for tn in ("a", "b")])
    out.append(_state(adm, ctr))
    return out


def _sc_fleet_rung(A, T, ctr):
    adm = A.AdmissionController(scope="router", now=0.0,
                                budget_rungs=(64, 32, 16))
    out = []
    for r in (2, 9, 4, -3, 0):
        adm.absorb_fleet_rung(r)
        out.append((_state(adm, ctr), adm.stats()))
    return out


SCENARIOS = {"classes_and_widths": _sc_classes_and_widths,
             "token_bucket": _sc_token_bucket,
             "overflow_victim": _sc_overflow_victim,
             "ladder_climbs_holds_recovers": _sc_ladder,
             "adaptive_budget": _sc_adaptive,
             "adaptive_budget_off": _sc_adaptive_off,
             "idle_reset": _sc_idle_reset, "shed_rung": _sc_shed_rung,
             "two_tenants": _sc_tenants, "absorb_fleet_rung": _sc_fleet_rung}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_controller_matches_jax(name):
    traces = {}
    for pkg, (A, T, ctr) in PKGS.items():
        jtl.reset()
        tl.reset()
        traces[pkg] = SCENARIOS[name](A, T, ctr)
    assert traces["torch"] == traces["jax"]


def test_controller_scenarios_hold_the_reference_verdicts():
    """The traces above are the JAX tests' own: spot-check them."""
    lad = _sc_ladder(admission, tl, tl.counter)
    rungs = [s[1][0] for s in lad[1::2]]
    assert rungs == [1, 2, 3, 4, 4, 4, 3, 2, 1, 0, 0]
    ten = _sc_tenants(admission, tl, tl.counter)[-1]
    a, b = ten[6]["a"], ten[6]["b"]
    assert min(a, b) > 0 and abs(a - b) <= 0.2 * max(a, b)
    assert ten[7][SHED_KEYS.index("admission.tenant_throttles")] > 0


# ---------------------------------------------------------------------------
# the server, in both packages
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small():
    jcfg = jgpt.GPTConfig(vocab_size=64, hidden_size=64, num_layers=2,
                          num_heads=4, max_seq_len=128, dtype=jnp.float32)
    jp = jax.device_get(jgpt.init_params(jcfg, jax.random.PRNGKey(0)))
    return jcfg, jp, convert.config_from_jax(jcfg), \
        convert.params_from_jax(jp)


def _server(pkg, model, **kw):
    jcfg, jp, cfg, params = model
    if pkg == "jax":
        return jserving.DecodeServer(jp, jcfg, **kw)
    return serving.DecodeServer(params, cfg, device="cpu", **kw)


def _prompts(seed, lens=(5, 7, 4), hi=64):
    rng = np.random.default_rng(seed)
    return [[int(x) for x in rng.integers(1, hi, n)] for n in lens]


def _outcome(srv, rid):
    try:
        return [int(t) for t in srv.result(rid)]
    except (RuntimeError, TimeoutError) as e:
        return type(e).__name__


def _drain(srv, limit=500):
    for _ in range(limit):
        if not srv.pending():
            return
        srv.tick()
    raise AssertionError("the server did not drain")


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("async_dispatch", [False, True])
def test_admission_off_is_bit_identical(small, monkeypatch, layout,
                                        async_dispatch):
    """``PADDLE_TPU_ADMISSION=0`` (no controller) and the unconfigured
    default controller serve the same greedy streams — and the JAX
    server's."""
    prompts = _prompts(3)
    kw = dict(max_batch=2, max_len=48, layout=layout,
              async_dispatch=async_dispatch)
    runs = {}
    for tag, pkg, off in (("off", "torch", True), ("on", "torch", False),
                          ("jax", "jax", False)):
        if off:
            monkeypatch.setenv("PADDLE_TPU_ADMISSION", "0")
        else:
            monkeypatch.delenv("PADDLE_TPU_ADMISSION", raising=False)
        srv = _server(pkg, small, **kw)
        assert (srv._adm is None) == off
        if srv._adm is not None:
            assert not srv._adm.engaged
        rids = [srv.submit(p, max_new_tokens=6) for p in prompts]
        _drain(srv)
        runs[tag] = [_outcome(srv, r) for r in rids]
    assert runs["on"] == runs["off"] == runs["jax"]


def _both(model, submits, env=(), force_rung=None, ticks_between=0,
          **kw):
    """The same submits (dicts of ``submit`` keywords) through the JAX
    server and the port's under ``env``: statuses, outcomes and the
    admission and serving counters must agree.  ``force_rung`` sets the
    ladder's rung before the first submit.  Returns the port's
    (statuses, outcomes)."""
    import os
    res = {}
    for pkg in ("jax", "torch"):
        (jtl if pkg == "jax" else tl).reset()
        old = {k: os.environ.get(k) for k, _ in env}
        os.environ.update(dict(env))
        try:
            srv = _server(pkg, model, **kw)
        finally:
            for k, v in old.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        if force_rung is not None:
            srv._adm.rung = force_rung
            srv._adm._set_gauges()
        # the compared counters are what the serve added: an absolute
        # read would also see whatever earlier tests of the worker left in
        # the JAX registry that ``telemetry.reset()`` does not clear
        ctr = PKGS[pkg][2]
        keys = SHED_KEYS + ("serving.requests_rejected",
                            "serving.requests_completed")
        before = {k: ctr(k) for k in keys}
        rids = []
        for sub in submits:
            rids.append(srv.submit(**sub))
            for _ in range(ticks_between):
                srv.tick()
        _drain(srv)
        res[pkg] = ([srv.status(r) for r in rids],
                    [_outcome(srv, r) for r in rids],
                    {k: ctr(k) - before[k] for k in keys})
    assert res["torch"] == res["jax"], (res["torch"], res["jax"])
    return res["torch"][:2]


def test_queue_bound_sheds_lowest_class_first(small):
    """4x oversubscription of a 1-slot server with queue cap 1: the
    high-priority request rides out the burst, the newest low-priority
    submissions are ``rejected`` and ``result`` raises
    ``resilience.Overloaded``."""
    subs = ([dict(prompt=p, max_new_tokens=4, priority=0, tenant="bulk")
             for p in _prompts(4)]
            + [dict(prompt=_prompts(5)[0], max_new_tokens=4, priority=2,
                    tenant="gold")]
            + [dict(prompt=p, max_new_tokens=4, priority=0, tenant="bulk")
               for p in _prompts(6)])
    st, out = _both(small, subs, env=[("PADDLE_TPU_ADMISSION_QUEUE_CAP",
                                       "1")], max_batch=1, max_len=48)
    assert st[3] == "ok" and len(out[3]) == 4
    assert "rejected" in st and set(st) <= {"ok", "rejected"}
    assert tl.counter("admission.sheds_class0") == st.count("rejected")
    assert out[st.index("rejected")] == "Overloaded"


def _expire(srv, rid, pkg) -> None:
    """Move a queued request's wait clock back past any TTL: the JAX
    server times the queue wait from ``t_enqueue``, the port from
    ``t_queued``."""
    key = "t_enqueue" if pkg == "jax" else "t_queued"
    (req,) = [r for r in srv._queue if r["rid"] == rid]
    req[key] -= 3600.0


def test_rejected_is_not_timeout(small, monkeypatch):
    """A reject at the door and a TTL shed are different verdicts: other
    statuses, other exceptions.  The TTL expires when the test says so,
    not by the wall clock: a TTL short enough to pass in a sleep could
    also pass before the burst is submitted (a loaded run), shedding the
    slow request early and leaving the burst room in the class queue."""
    monkeypatch.setenv("PADDLE_TPU_ADMISSION_QUEUE_CAP", "1")
    for pkg in ("jax", "torch"):
        srv = _server(pkg, small, max_batch=1, max_len=48)
        p = _prompts(7)
        srv.submit(p[0], max_new_tokens=8)
        slow = srv.submit(p[1], max_new_tokens=4, ttl_s=60.0)
        burst = [srv.submit(p[2], max_new_tokens=4) for _ in range(3)]
        _expire(srv, slow, pkg)
        _drain(srv)
        assert srv.status(slow) == "timeout"
        assert [srv.status(r) for r in burst] == \
            ["rejected", "rejected", "rejected"]
        exc = resilience if pkg == "torch" else jres
        with pytest.raises(exc.DeadlineExceeded):
            srv.result(slow)
        with pytest.raises(exc.Overloaded):
            srv.result(burst[0])
    assert not issubclass(resilience.Overloaded, TimeoutError)


def test_injected_overload_fault_sheds_at_the_door(small):
    for f in (jfaults, faults):
        f.install("overload:admission.submit:2")
    st, out = _both(small, [dict(prompt=p, max_new_tokens=4)
                            for p in _prompts(1)],
                    max_batch=2, max_len=48)
    assert st == ["ok", "rejected", "ok"]
    assert out[1] == "Overloaded"
    assert tl.counter("admission.sheds") == 1


@pytest.mark.parametrize("rung", [0, 1, 2, 3, 4])
def test_forced_rungs_and_caps_match_jax(small, rung):
    """Mixed-class traffic, some prompts longer than the budget, on a
    2-slot budgeted server with queue cap 2 and the ladder held at
    ``rung``: every status and stream equals the JAX server's (the class
    sort, the class-0 admit cap, the budget's width, the shed rung, the
    queue bound)."""
    lens = (30, 5, 22, 9, 40, 12, 7, 33)
    prio = (0, 2, 1, 0, 2, 1, 0, 1)
    subs = [dict(prompt=p, max_new_tokens=5, priority=q)
            for p, q in zip(_prompts(11, lens), prio)]
    # a window no serve here outlasts: the rung stays where it was put
    st, out = _both(small, subs,
                    env=[("PADDLE_TPU_ADMISSION_QUEUE_CAP", "2"),
                         ("PADDLE_TPU_SLO_WINDOW_S", "3600")],
                    force_rung=rung, ticks_between=1, max_batch=2,
                    max_len=64, prefill_budget=16)
    assert set(st) <= {"ok", "rejected"}
    assert all(s == "ok" for s, q in zip(st, prio) if q > 0)
    assert all(s == ("rejected" if rung == 4 else "ok")
               for s, q in zip(st, prio) if q <= 0)


def test_slo_breach_degrades_and_idle_recovers(small, monkeypatch):
    """An injected 20 ms delay a tick against a 5 ms decode-gap objective
    climbs the ladder on a live server; then idle windows bring it back
    to rung 0 — in both packages."""
    monkeypatch.setenv("PADDLE_TPU_SLO_TPOT_MS", "5")
    monkeypatch.setenv("PADDLE_TPU_SLO_WINDOW_S", "0.1")
    for pkg, f, ctr in (("jax", jfaults, PKGS["jax"][2]),
                        ("torch", faults, tl.counter)):
        srv = _server(pkg, small, max_batch=2, max_len=48)
        f.install("delay:tick:0:0.02")
        rids = [srv.submit(p, max_new_tokens=10) for p in _prompts(9)]
        rung_max = 0
        while srv.pending():
            srv.tick()
            rung_max = max(rung_max, srv._adm.rung)
        assert [srv.status(r) for r in rids] == ["ok"] * 3
        assert rung_max >= 1 and ctr("admission.degradations") >= 1
        f.reset()
        t0 = time.perf_counter()
        while srv._adm.rung > 0 and time.perf_counter() - t0 < 3.0:
            srv.tick()
            time.sleep(0.01)
        assert srv._adm.rung == 0 and ctr("admission.recoveries") >= 1
        assert srv.load_stats()["slo_ok"] is True


def test_load_stats_and_snapshot_carry_the_rung(small, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_ADMISSION_QUEUE_CAP", "4")
    for pkg, t in (("jax", jtl), ("torch", tl)):
        srv = _server(pkg, small, max_batch=2, max_len=48)
        srv._adm.rung = 2
        srv._adm._set_gauges()
        ls = srv.load_stats()
        assert ls["admission_rung"] == 2 and ls["slo_ok"] is False
        assert ls["free_slots"] == 1           # the class-0 cap, halved
        assert t.admission_snapshot()["admission.rung"] == 2


# ---------------------------------------------------------------------------
# the port alone
# ---------------------------------------------------------------------------


def test_ladder_moves_build_nothing_after_warmup(small, monkeypatch):
    """``warmup`` builds every ladder width; forcing the controller
    through rungs 0-3 mid-serve adds no step to the Engine and no record
    to the recompile watch, and each claim ran at its rung's width."""
    _, _, cfg, params = small
    monkeypatch.setenv("PADDLE_TPU_ADMISSION_QUEUE_CAP", "8")
    srv = serving.DecodeServer(params, cfg, max_batch=2, max_len=48,
                               prefill_budget=16, device="cpu")
    assert srv._adm.budget_rungs == admission.ladder_widths(16) == (16, 8)
    names = {n for n, _, _ in srv._admission_widths()}
    assert {"prefill_chunk@16", "prefill_chunk@8"} <= names
    srv.warmup()
    keys0, logs0 = set(engine.ENGINE._steps.keys()), len(tl.compile_log())
    widths = []
    claim = srv._claim_admitting

    def watched(slot, st):
        claim(slot, st)
        widths.append(st["admit_w"])

    srv._claim_admitting = watched
    prompt = _prompts(8, (30,))[0]
    for rung in (0, 1, 2, 3):
        srv._adm.rung = rung
        rid = srv.submit(prompt, max_new_tokens=4)
        _drain(srv)
        assert srv.status(rid) == "ok"
    assert widths == [16, 16, 8, 8]
    assert set(engine.ENGINE._steps.keys()) == keys0
    assert len(tl.compile_log()) == logs0
    srv.close()


def test_evicted_request_keeps_its_class_and_place(small, monkeypatch):
    """Under a configured controller the queue is sorted by class, then by
    first enqueue: an OOM-evicted request comes back ahead of newer work
    of its class (its ``t_enqueue`` is kept; the TTL clock restarts)."""
    _, _, cfg, params = small
    monkeypatch.setenv("PADDLE_TPU_ADMISSION_QUEUE_CAP", "8")
    srv = serving.DecodeServer(params, cfg, max_batch=1, max_len=48,
                               device="cpu")
    p = _prompts(12)
    first = srv.submit(p[0], max_new_tokens=6, priority=1)
    srv.tick()
    later = srv.submit(p[1], max_new_tokens=6, priority=1)
    t_first = next(iter(srv._slots.values()))["t_enqueue"]
    assert srv._evict_one()
    req = srv._queue[0]
    assert req["rid"] == first and req["t_enqueue"] == t_first
    assert req["t_queued"] > t_first
    srv._admit()
    assert srv.status(first) == "active" and srv.status(later) == "queued"
    _drain(srv)
    assert srv.status(first) == srv.status(later) == "ok"


def test_tenant_submits_draw_on_their_buckets(small, monkeypatch):
    """``submit(tenant=)`` charges prompt + max_new tokens to the tenant's
    bucket: past its burst the tenant is throttled while another is not;
    ``spec_forced`` follows the rung (inert until speculation lands)."""
    _, _, cfg, params = small
    monkeypatch.setenv("PADDLE_TPU_TENANT_RATE", "1")
    monkeypatch.setenv("PADDLE_TPU_TENANT_BURST", "20")
    srv = serving.DecodeServer(params, cfg, max_batch=2, max_len=48,
                               device="cpu")
    p = _prompts(13, (6,))[0]
    a = [srv.submit(p, max_new_tokens=4, tenant="a") for _ in range(3)]
    b = srv.submit(p, max_new_tokens=4, tenant="b")
    _drain(srv)
    assert [srv.status(r) for r in a] == ["ok", "ok", "rejected"]
    assert srv.status(b) == "ok"
    assert tl.counter("admission.tenant_throttles") == 1
    assert srv._adm.admitted_tokens == {"a": 20, "b": 10}
    assert not srv._adm.spec_forced()
    srv._adm.rung = admission.RUNG_SPEC_OFF
    assert srv._adm.spec_forced()
