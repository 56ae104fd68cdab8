"""The port's resilience layer (paddle_tpu_torch/faults.py, resilience.py,
telemetry.py and the DecodeServer's guard: TTL shedding, the OOM ladder,
the wedge watchdog, the NaN guard) against the JAX package's, on the CPU.

The chaos suite of ``tests/test_resilience.py``, run twice: every drill
installs the same ``PADDLE_TPU_FAULTS`` spec in each package's harness
and drives the JAX server and the port's on the same fp32 model and
prompts.  Each must give the same tokens (exactly: both compute in
fp32, and the markov model's margins leave no tie), the same statuses,
the same ``serving.* / resilience.* / kv_pool.*`` telemetry counters key
for key, and the fault-free run's tokens where the drill says the
requests survive:

* the primitives: the fault grammar and nth semantics, no-op when
  unset, ``is_oom`` on ``InjectedOOM``, the pool's ``PoolExhausted`` and a
  constructed ``torch.cuda.OutOfMemoryError``, ``corrupt_nan`` on a numpy
  array and a torch tensor, the backoff schedule, retry and the budget;
* deadline shedding and ``ttl=None``;
* the sync OOM ladder's bit parity (tick and tick_block, contiguous and
  paged), async -> sync, eviction requeues with progress and the admit
  cap halving, the requeue bound, the exhausted ladder failing fast,
  ``PADDLE_TPU_RESILIENCE=0`` failing fast;
* the wedge watchdog's recovery (the ``wedged`` property and the
  telemetry verdict set and cleared) and a sync server's loud wedge;
* a failed admission restores the request and the slot;
* NaN prefill and tick logits fail exactly the poisoned request;
* async parity with resilience on; shutdown with a step in flight.
"""
import dataclasses
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
from paddle_tpu.text import gpt as jgpt
from paddle_tpu.text import serving as jserving
from paddle_tpu_torch import convert, faults, resilience
from paddle_tpu_torch import telemetry as tl
from paddle_tpu_torch.text import engine, kv_pool, serving

FAMILIES = ("serving.", "resilience.", "kv_pool.")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's steps here are tiny: one intra-op thread runs them far
    faster than a pool of threads contending for a shared CPU."""
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


def _counters(pkg) -> dict:
    """One package's nonzero counters of the compared families."""
    if pkg == "jax":
        got = monitor.stats()
    else:
        got = tl.counters()
    return {k: int(v) for k, v in sorted(got.items())
            if k.startswith(FAMILIES) and v}


@pytest.fixture(scope="module")
def small():
    """The reference suite's random model (vocab 32, 2 layers), fp32 in
    both packages."""
    jcfg = jgpt.GPTConfig(vocab_size=32, hidden_size=32, num_layers=2,
                          num_heads=4, max_seq_len=64, dtype=jnp.float32)
    jp = jax.device_get(jgpt.init_params(jcfg, jax.random.PRNGKey(0)))
    return jcfg, jp, convert.config_from_jax(jcfg), \
        convert.params_from_jax(jp)


@pytest.fixture(scope="module")
def markov(markov_gpt):
    """The trained ``markov_gpt`` fixture, computed in fp32 by both."""
    jcfg, jparams = markov_gpt
    return (dataclasses.replace(jcfg, dtype=jnp.float32), jparams,
            dataclasses.replace(convert.config_from_jax(jcfg),
                                dtype=torch.float32),
            convert.params_from_jax(jparams))


def _server(pkg, model, **kw):
    jcfg, jp, cfg, params = model
    if pkg == "jax":
        return jserving.DecodeServer(jp, jcfg, **kw)
    return serving.DecodeServer(params, cfg, device="cpu", **kw)


def _outcome(srv, rid):
    """A request's tokens, or the name of the exception ``result``
    raises."""
    try:
        return [int(t) for t in srv.result(rid)]
    except (RuntimeError, TimeoutError) as e:
        return type(e).__name__


def _run(pkg, model, prompts, spec="", mode="tick", max_new=6,
         priorities=None, max_batch=2, max_len=32, **kw):
    """One serve in ``pkg`` ("jax" or "torch") under ``spec``: submit every
    prompt, drive ``mode`` (tick, tick_block = 4-step blocks) until
    drained.  Returns (outcomes, statuses, counters, the server's admit
    cap and dispatch mode after the serve)."""
    f, t = (jfaults, jtl) if pkg == "jax" else (faults, tl)
    f.reset()
    t.reset()
    if spec:
        f.install(spec)
    try:
        srv = _server(pkg, model, max_batch=max_batch, max_len=max_len,
                      **kw)
        pr = priorities or [0] * len(prompts)
        rids = [srv.submit(p, max_new_tokens=max_new, priority=q)
                for p, q in zip(prompts, pr)]
        for _ in range(400):
            if not srv.pending():
                break
            srv.tick_block(4) if mode == "tick_block" else srv.tick()
        assert not srv.pending()
        out = [_outcome(srv, r) for r in rids]
        st = [srv.status(r) for r in rids]
        after = (srv._admit_cap, srv._async)
        srv.close()
    finally:
        f.reset()
    return out, st, _counters(pkg), after


def _both(model, prompts, **kw):
    """The serve in both packages; asserts they agree and returns the
    port's (outcomes, statuses, counters, after)."""
    j = _run("jax", model, prompts, **kw)
    t = _run("torch", model, prompts, **kw)
    assert t[0] == j[0], (t[0], j[0])
    assert t[1] == j[1]
    assert t[2] == j[2], (t[2], j[2])
    assert t[3] == j[3]
    return t


def _prompts(seed, n, length, hi=13):
    rng = np.random.default_rng(seed)
    return [[int(x) for x in rng.integers(1, hi, length)] for _ in range(n)]


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------


def test_fault_spec_grammar():
    spec = "oom:serving.block:2, wedge:tick:1,nan:logits:3,delay:tick:0:0.5"
    mine = [(f.kind, f.site, f.nth, f.seconds)
            for f in faults.parse_spec(spec)]
    assert mine == [(f.kind, f.site, f.nth, f.seconds)
                    for f in jfaults.parse_spec(spec)]
    assert mine[:3] == [("oom", "serving.block", 2, None),
                        ("wedge", "tick", 1, None),
                        ("nan", "logits", 3, None)]
    for bad in ("oom:tick", "boom:tick:1", "oom::1", "oom:tick:x",
                "oom:tick:-1", "delay:tick:0:x"):
        with pytest.raises(ValueError):
            faults.parse_spec(bad)
        with pytest.raises(ValueError):
            jfaults.parse_spec(bad)
    assert faults.parse_spec("") == []


def test_fault_nth_semantics():
    faults.install("oom:site:2")
    faults.check("site")                     # 1st check: no fire
    with pytest.raises(faults.InjectedOOM):
        faults.check("other", "site")        # 2nd (alias match): fires
    faults.check("site")                     # 3rd: spent, no fire
    faults.install("error:site:0")           # 0 = every check
    for _ in range(3):
        with pytest.raises(faults.InjectedError):
            faults.check("site")
    faults.install("wedge:site:1")
    with pytest.raises(faults.InjectedWedge):
        faults.check("site")                 # a wedge at a check site
    faults.install("wedge:site:1")
    faults.check("site", kinds=("oom", "error"))   # not taken here


def test_faults_noop_when_unset():
    assert not faults.active()
    faults.check("anything")                 # no-op
    arr, ten = np.ones(3), torch.ones(3)
    assert faults.corrupt_nan("logits", arr) is arr
    assert faults.corrupt_nan("logits", ten) is ten
    faults.hang("tick")                      # returns at once


def test_corrupt_nan_takes_numpy_and_torch():
    faults.install("nan:logits:0")
    out = faults.corrupt_nan("logits", np.ones((2, 3), np.float16))
    assert out.dtype == np.float32 and np.isnan(out).all()
    t = faults.corrupt_nan("logits", torch.ones(2, 3, dtype=torch.bfloat16))
    assert t.dtype == torch.float32 and t.shape == (2, 3)
    assert torch.isnan(t).all()


def test_is_oom_classifies_like_jax():
    faults.install("oom:x:1")
    with pytest.raises(faults.InjectedOOM) as ei:
        faults.check("x")
    cases = [ei.value, kv_pool.PoolExhausted(2, 8),
             torch.cuda.OutOfMemoryError(
                 "CUDA out of memory. Tried to allocate 20.00 GiB. GPU 0 "
                 "has a total capacity of 79.19 GiB"),
             ValueError("plain"), RuntimeError("CUDA error: an illegal "
                                               "memory access")]
    assert [resilience.is_oom(e) for e in cases] == [True] * 3 + [False] * 2
    assert [resilience.is_oom(e) for e in cases] == \
        [jres.is_oom(e) for e in cases]


def test_backoff_retry_and_budget_match_jax():
    kw = dict(base=0.1, factor=2.0, max_delay=0.5, jitter=0.1, seed=7)
    assert resilience.backoff_schedule(6, **kw) == \
        jres.backoff_schedule(6, **kw)
    assert resilience.backoff_schedule(1) == []
    calls, slept = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return "ok"

    assert resilience.retry(flaky, name="t", attempts=4, seed=1,
                            sleep=slept.append) == "ok"
    assert slept == resilience.backoff_schedule(4, seed=1)[:2]
    assert tl.counter("resilience.retries") == 2
    assert tl.counter("resilience.retries.t") == 2
    with pytest.raises(ValueError):
        resilience.retry(flaky, name="")
    d = resilience.Deadline(0.0)
    assert d.expired and resilience.Deadline(None).remaining() == \
        float("inf")
    assert resilience.call_with_budget(lambda: 5, 1.0, name="f") == 5
    with pytest.raises(resilience.WedgeError):
        resilience.call_with_budget(lambda: time.sleep(0.5), 0.05,
                                    name="f")
    assert tl.counter("resilience.wedge_detected.f") == 1


def test_telemetry_registry_basics():
    tl.count("serving.x", 3)
    tl.observe("serving.lat_ms", 2.0, n=4)
    tl.set_gauge("serving.g", 1.5)
    tl.event("serving.e", 0.0, 1.0, rid=1)
    snap = tl.snapshot()
    assert snap["counters"] == {"serving.x": 3}
    assert snap["gauges"] == {"serving.g": 1.5}
    assert snap["histograms"]["serving.lat_ms"]["count"] == 4
    assert tl.latency_summary()["lat_ms"]["count"] == 4
    assert tl.events("serving.e")[0]["args"] == {"rid": 1}
    h = tl.Histogram("h")
    for v in (1.0, 2.0, 3.0, 100.0):
        h.observe(v)
    jh = jtl.Histogram("h")
    for v in (1.0, 2.0, 3.0, 100.0):
        jh.observe(v)
    assert h.summary() == jh.summary()
    assert tl.quantile_from_counts(h.raw_counts(), 0.5) == \
        jtl.quantile_from_counts(jh.raw_counts(), 0.5)
    tl.set_runtime_wedge("x")
    assert tl.runtime_wedge()["wedged"]
    tl.clear_runtime_wedge()
    assert not tl.runtime_wedge()["wedged"]
    tl.reset()
    assert tl.counters() == {} and tl.snapshot()["histograms"] == {}


# ---------------------------------------------------------------------------
# serving: deadline shed
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("async_", [False, True])
def test_deadline_shed(small, async_):
    def run(pkg):
        srv = _server(pkg, small, max_batch=2, max_len=32,
                      async_dispatch=async_)
        rng = np.random.default_rng(0)
        live = [srv.submit(rng.integers(1, 30, 4), max_new_tokens=6)
                for _ in range(2)]        # both slots busy
        doomed = srv.submit(rng.integers(1, 30, 4), max_new_tokens=6,
                            ttl_s=0.001)  # queued behind them
        assert srv.status(doomed) == "queued"
        time.sleep(0.01)
        while srv.pending():
            srv.tick()
        assert srv.status(doomed) == "timeout"
        exc = jres.DeadlineExceeded if pkg == "jax" \
            else resilience.DeadlineExceeded
        with pytest.raises(exc):
            srv.result(doomed)
        out = [[int(t) for t in srv.result(r)] for r in live]
        assert all(srv.status(r) == "ok" and len(o) == 6
                   for r, o in zip(live, out))
        srv.close()
        return out, _counters(pkg)

    j, t = run("jax"), run("torch")
    assert t == j
    assert t[1]["resilience.deadline_sheds"] == 1
    assert t[1]["serving.requests_shed"] == 1
    with pytest.raises(ValueError, match="ttl_s"):
        _server("torch", small, max_batch=1, max_len=32).submit(
            [1, 2], max_new_tokens=2, ttl_s=0)


def test_ttl_none_never_sheds(small, monkeypatch):
    _, st, ctr, _ = _both(small, _prompts(3, 3, 4, hi=30))
    assert st == ["ok"] * 3 and "resilience.deadline_sheds" not in ctr
    # PADDLE_TPU_REQUEST_TTL_S is the TTL of a submit that names none
    monkeypatch.setenv("PADDLE_TPU_REQUEST_TTL_S", "30")
    srv = _server("torch", small, max_batch=1, max_len=32)
    srv.submit([1, 2], max_new_tokens=4)
    rid = srv.submit([1, 2], max_new_tokens=4)     # queued behind it
    assert [(q["rid"], q["ttl"]) for q in srv._queue] == [(rid, 30.0)]
    srv.close()


# ---------------------------------------------------------------------------
# serving: the OOM ladder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode,layout,spec", [
    ("tick", "contiguous", "oom:tick:2"),
    ("tick", "paged", "oom:tick:2"),
    ("tick_block", "contiguous", "oom:serving.block:1"),
    ("tick_block", "paged", "oom:tick:1"),
])
def test_oom_ladder_sync_bit_parity(markov, mode, layout, spec):
    """One injected tick OOM on a sync server: the ladder retries it after
    one rung; every request finishes with its fault-free tokens, in both
    packages alike (the markov model: its next token depends on the fed
    one, so a retry that feeds the wrong offset cannot hide)."""
    kw = dict(layout=layout, **({"block_size": 8} if layout == "paged"
                                else {}))
    prompts = _prompts(1, 2, 5)
    clean = _both(markov, prompts, mode=mode, **kw)[0]
    out, st, ctr, _ = _both(markov, prompts, spec=spec, mode=mode, **kw)
    assert out == clean and st == ["ok", "ok"]
    assert ctr["resilience.oom_retries"] >= 1


def test_oom_ladder_async_degrades_to_sync(markov):
    prompts = _prompts(2, 3, 5)
    clean = _both(markov, prompts, async_dispatch=True)[0]
    out, _, ctr, (cap, async_) = _both(markov, prompts, spec="oom:tick:3",
                                       async_dispatch=True)
    assert out == clean
    assert not async_ and cap == 2           # rung 2 only
    assert ctr["resilience.oom_retries"] == 1


def test_oom_eviction_requeues_with_progress(markov):
    """Two consecutive tick OOMs on a sync server: the ladder halves the
    admitted batch twice (4 -> 2 -> 1), evicting the lowest-priority slots
    back to the queue mid-generation with their progress carried; every
    request still finishes with its fault-free tokens."""
    prompts = _prompts(4, 3, 5)
    clean = _both(markov, prompts, max_batch=4)[0]
    out, st, ctr, (cap, _) = _both(markov, prompts,
                                   spec="oom:tick:2,oom:tick:3",
                                   priorities=(2, 1, 0), max_batch=4)
    assert out == clean and st == ["ok"] * 3
    assert cap == 1
    assert ctr["resilience.oom_evictions"] >= 2
    assert ctr["resilience.oom_retries"] >= 2


def test_oom_requeue_bound(small, monkeypatch):
    """The requeue bound (``PADDLE_TPU_EVICT_REQUEUE_MAX=1``): the first
    OOM halves the cap 4 -> 2, evicting the two lowest-priority requests;
    re-admitted once the others finish, the second OOM (cap 2 -> 1)
    evicts the lowest again — its second eviction, past the bound — so it
    fails with the ``error`` status, counted, and the rest finish."""
    monkeypatch.setenv("PADDLE_TPU_EVICT_REQUEUE_MAX", "1")
    prompts = _prompts(6, 4, 5)
    out, st, ctr, (cap, _) = _both(small, prompts,
                                   spec="oom:tick:2,oom:tick:8",
                                   priorities=(0, 1, 2, 3), max_batch=4)
    assert st == ["error", "ok", "ok", "ok"] and cap == 1
    assert out[0] == "RuntimeError"
    assert ctr["resilience.evict_requeue_overflows"] == 1
    assert ctr["resilience.oom_evictions"] == 2
    assert ctr["serving.requests_failed"] == 1


def test_oom_ladder_exhausted_fails_fast(small):
    for pkg, exc in (("jax", jfaults.InjectedOOM),
                     ("torch", faults.InjectedOOM)):
        (jfaults if pkg == "jax" else faults).install("oom:tick:0")
        srv = _server(pkg, small, max_batch=1, max_len=32)
        srv.submit([1, 2, 3], max_new_tokens=4)
        with pytest.raises(exc):
            while srv.pending():
                srv.tick()
        (jfaults if pkg == "jax" else faults).reset()
        srv.close()


def test_resilience_off_fails_fast(small, monkeypatch):
    """``PADDLE_TPU_RESILIENCE=0``: the first injected OOM kills the tick —
    no retry, no rung, no shed."""
    monkeypatch.setenv("PADDLE_TPU_RESILIENCE", "0")
    for pkg, f, exc in (("jax", jfaults, jfaults.InjectedOOM),
                        ("torch", faults, faults.InjectedOOM)):
        f.install("oom:tick:1")
        srv = _server(pkg, small, max_batch=2, max_len=32)
        srv.submit([1, 2, 3], max_new_tokens=4)
        with pytest.raises(exc):
            srv.tick()
        assert srv._admit_cap == 2
        f.reset()
        srv.close()
        assert _counters(pkg).get("resilience.oom_retries", 0) == 0


# ---------------------------------------------------------------------------
# serving: the wedge watchdog
# ---------------------------------------------------------------------------


def test_wedge_watchdog_recovery(markov, monkeypatch):
    """An async fetch past its wall budget: the server is marked wedged
    (and the process's verdict with it), the dispatches in flight are
    cancelled, and the steps decoded again — the requests finish with the
    tokens of an unfaulted async serve; the next clean tick clears the
    verdict."""
    prompts = _prompts(5, 2, 5)
    clean = _both(markov, prompts, async_dispatch=True)[0]
    monkeypatch.setenv("PADDLE_TPU_STEP_BUDGET_S", "0.3")
    monkeypatch.setenv("PADDLE_TPU_FAULT_WEDGE_S", "0.6")
    seen = {}
    for pkg, f, t in (("jax", jfaults, jtl), ("torch", faults, tl)):
        t.reset()
        f.install("wedge:tick:1")
        srv = _server(pkg, markov, max_batch=2, max_len=32,
                      async_dispatch=True)
        rids = [srv.submit(p, max_new_tokens=6) for p in prompts]
        flags = []
        for _ in range(64):
            if not srv.pending():
                break
            srv.tick()
            flags.append((bool(srv.wedged),
                          t.runtime_wedge()["wedged"]))
        out = [_outcome(srv, r) for r in rids]
        srv.close()
        f.reset()
        seen[pkg] = (out, flags, _counters(pkg))
    assert seen["torch"] == seen["jax"]
    out, flags, ctr = seen["torch"]
    assert out == clean
    assert (True, True) in flags and flags[-1] == (False, False)
    assert ctr["resilience.wedge_detected"] == 1
    assert ctr["resilience.wedge_recoveries"] == 1


def test_wedge_on_sync_server_fails_loudly(small):
    faults.install("wedge:tick:1")
    srv = _server("torch", small, max_batch=1, max_len=32)
    srv.submit([1, 2], max_new_tokens=2)
    with pytest.raises(faults.InjectedWedge):
        srv.tick()
    srv.close()


def test_wedge_budget_off_by_default(small):
    srv = _server("torch", small, max_batch=2, max_len=32,
                  async_dispatch=True)
    assert srv._step_budget == 0.0
    assert srv.load_stats()["wedged"] is False
    srv.close()


# ---------------------------------------------------------------------------
# serving: a failed admission
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_admission_prefill_failure_restores_request(small, monkeypatch,
                                                    layout):
    """A failed admission prefill neither loses the request nor leaks the
    slot (paged: nor its blocks); the next attempt serves it."""
    kw = {"layout": layout}
    if layout == "paged":
        kw["block_size"] = 8
    srv = _server("torch", small, max_batch=2, max_len=32, **kw)
    real_get = engine.ENGINE.get
    calls = {"n": 0}

    def get(kind, spec):
        fn = real_get(kind, spec)
        if kind not in ("prefill", "paged_prefill"):
            return fn

        def wrapped(*feeds):
            calls["n"] += 1
            if calls["n"] == 1:
                raise faults.InjectedOOM("prefill")
            return fn(*feeds)
        return wrapped

    monkeypatch.setattr(engine.ENGINE, "get", get)
    with pytest.raises(faults.InjectedOOM):
        srv.submit([1, 2, 3], max_new_tokens=4)   # admission runs inline
    assert len(srv._free) == 2 and len(srv._queue) == 1
    if layout == "paged":
        assert srv._pool.blocks_in_use == 0
    rid = srv._queue[0]["rid"]
    assert srv.status(rid) == "queued"
    while srv.pending():
        srv.tick()
    assert len(srv.result(rid)) == 4
    srv.close()


# ---------------------------------------------------------------------------
# serving: the NaN guard
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("budget", [0, 4])
def test_nan_prefill_logits_fail_cleanly(small, budget):
    """``nan:logits:1`` poisons the first admission's logits (monolithic,
    or a budgeted admission's graduation): that request fails with the
    ``error`` status, the server lives, the next request decodes."""
    seen = {}
    for pkg, f in (("jax", jfaults), ("torch", faults)):
        f.install("nan:logits:1")
        srv = _server(pkg, small, max_batch=2, max_len=32,
                      prefill_budget=budget)
        bad = srv.submit([1, 2, 3, 4, 5, 6], max_new_tokens=4)
        while srv.pending():
            srv.tick()
        assert srv.status(bad) == "error"
        with pytest.raises(RuntimeError, match="non-finite"):
            srv.result(bad)
        ok = srv.submit([4, 5, 6], max_new_tokens=4)
        while srv.pending():
            srv.tick()
        seen[pkg] = ([int(t) for t in srv.result(ok)], _counters(pkg))
        srv.close()
        f.reset()
    assert seen["torch"] == seen["jax"]
    assert seen["torch"][1]["resilience.nan_requests"] == 1
    assert seen["torch"][1]["serving.requests_failed"] == 1


@pytest.mark.parametrize("guard_flag", [False, True])
def test_nan_tick_logits_fail_cleanly(small, monkeypatch, guard_flag):
    """``nan:logits:2``: check 1 is the admission's logits (clean), check
    2 the first tick's — the poisoned request fails, a later one decodes.
    With ``PADDLE_TPU_NAN_GUARD_SERVING=1`` the guard runs on every greedy
    tick; without a fault it fails nothing."""
    if guard_flag:
        monkeypatch.setenv("PADDLE_TPU_NAN_GUARD_SERVING", "1")
    seen = {}
    for pkg, f in (("jax", jfaults), ("torch", faults)):
        f.install("nan:logits:2")
        srv = _server(pkg, small, max_batch=2, max_len=32)
        bad = srv.submit([1, 2, 3], max_new_tokens=6)
        while srv.pending():
            srv.tick()
        assert srv.status(bad) == "error"
        f.reset()
        ok = srv.submit([7, 8], max_new_tokens=3)
        while srv.pending():
            srv.tick()
        seen[pkg] = ([int(t) for t in srv.result(ok)], _counters(pkg))
        srv.close()
    assert seen["torch"] == seen["jax"]
    assert seen["torch"][1]["resilience.nan_requests"] == 1


# ---------------------------------------------------------------------------
# serving: pins held with the resilience layer on
# ---------------------------------------------------------------------------


def test_async_parity_with_resilience_on(small):
    assert resilience.enabled()
    prompts = _prompts(6, 3, 5, hi=30)
    sync_toks = _both(small, prompts)[0]
    assert _both(small, prompts, async_dispatch=True)[0] == sync_toks


def test_shutdown_idempotent_under_inflight(small):
    with _server("torch", small, max_batch=2, max_len=32,
                 async_dispatch=True) as srv:
        rid = srv.submit([1, 2, 3], max_new_tokens=8)
        srv.tick()                           # leaves a dispatch in flight
        assert srv._inflight is not None
        assert srv.status(rid) == "active"
        srv.shutdown()                       # cancels it
        assert srv._inflight is None
        assert srv.status(rid) == "dropped"
        srv.shutdown()                       # idempotent
    assert srv.cache is None


def test_stats_and_load_stats_read_the_counters(small):
    prompts = _prompts(7, 3, 5, hi=30)
    out, _, ctr, _ = _both(small, prompts)
    srv = _server("torch", small, max_batch=2, max_len=32)
    tl.reset()
    rids = [srv.submit(p, max_new_tokens=6) for p in prompts]
    ls = srv.load_stats()
    assert ls["admit_cap"] == 2 and ls["wedged"] is False
    assert ls["free_slots"] == 0 and ls["queue_depth"] == 1
    while srv.pending():
        srv.tick()
    assert [[int(t) for t in srv.result(r)] for r in rids] == out
    st = srv.stats()
    assert st == {k: v for k, v in ctr.items() if k.startswith(
        ("serving.", "resilience."))}
    assert st["serving.requests_completed"] == 3
    assert st["serving.tokens_generated"] == 18
    assert srv.load_stats()["tokens_generated"] == 18
    srv.close()
