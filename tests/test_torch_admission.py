"""Admission through the port's step Engine (paddle_tpu_torch/text/
generate.py, kv_pool.py, serving.py) against the JAX package, on the CPU.

* ``prefill_slot``, ``prefill_slot_chunk`` and ``paged_prefill_chunk`` fed
  their length, offset and slot as 0-d int64 tensors (a captured step's
  feeds) against the JAX functions on an fp32 config over a randomly
  filled cache: logits within 1e-5, every written row within 1e-5, and
  every other row — the chunk's pad rows, the other slots, the blocks
  the slot does not map — bit for bit what it was;
* budgeted admission (``prefill_budget=``): the port's server gives the
  JAX budgeted server's greedy tokens on the trained ``markov_gpt``
  (computed in fp32 by both), contiguous and paged, under ``tick``,
  ``tick_block`` and async dispatch; budgeted == monolithic in the port
  at budgets 5, 16 and 39 on a random fp32 model (39: two windows
  overlapping by one token over a 40-token prompt); sampled requests
  draw the same tokens under ``tick``, ``tick_block`` and async at a
  budget;
* the budget's validation, flag and warmup;
* warmup on a drained paged server leaves the cached prefix rows alone:
  re-admitting a served prompt after ``warmup()`` gives the admission
  logits a server never warmed gives, bit for bit (sync and async).

The JAX server shares that warmup fault, and is not changed: the port
pushes its pool's pending table update before warmup's first step.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.text import generate as JG
from paddle_tpu.text import gpt as jgpt
from paddle_tpu.text import kv_pool as jkv
from paddle_tpu.text import serving as jserving
from paddle_tpu_torch import convert, flags
from paddle_tpu_torch.text import engine, gpt, serving
from paddle_tpu_torch.text import generate as G
from paddle_tpu_torch.text import kv_pool

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's steps here are tiny: one intra-op thread runs them far
    faster than a pool of threads contending for a shared CPU."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


ARCHS = {"learned_mha": {},
         "rope_gqa": dict(pos_embed="rope", num_kv_heads=1,
                          norm="rmsnorm", activation="swiglu")}


def _tiny(arch):
    jcfg = jgpt.GPTConfig(vocab_size=64, hidden_size=128, num_layers=2,
                          num_heads=2, max_seq_len=64, dtype=jnp.float32,
                          **ARCHS[arch])
    jp = jgpt.init_params(jcfg, jax.random.PRNGKey(5))
    return (jcfg, jp, convert.config_from_jax(jcfg),
            convert.params_from_jax(jax.device_get(jp)))


def _filled(jcache, tcache, rng):
    """Fill both caches' value leaves with the same random rows (the
    tables of a paged cache stay as they are): admission must leave every
    row it does not write exactly as it found it."""
    for name in tcache:
        if name == "tables":
            continue
        t = tcache[name]
        shape = tuple(jcache[name].shape)
        v = rng.standard_normal(shape).astype(np.float32)
        jcache = dict(jcache, **{name: jnp.asarray(v)})
        t[(slice(None),) + tuple(slice(0, n) for n in shape[1:])] = \
            torch.from_numpy(v)
    return jcache


def _feed(v, shape=()):
    """A scalar as an int64 tensor of ``shape`` (0-d, or [1] as the
    server feeds it)."""
    return torch.tensor(v, dtype=torch.int64).reshape(shape)


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("kind", ["prefill", "chunk", "paged"])
def test_device_indexed_admission_matches_jax(kind, arch):
    jcfg, jp, cfg, params = _tiny(arch)
    rng = np.random.default_rng(11)
    B, max_len, width = 3, 40, 16
    if kind == "paged":
        bs, N = 8, 12
        jc = JG.init_cache(jcfg, B, max_len, layout="paged", block_size=bs,
                           num_blocks=N)
        tc = G.init_cache(cfg, B, max_len, "cpu", layout="paged",
                          block_size=bs, num_blocks=N)
        tables = np.full(tuple(tc["tables"].shape), -1, np.int32)
        perm = rng.permutation(N).astype(np.int32)
        tables[0, :2], tables[1, :4] = perm[:2], perm[2:6]
        jc = dict(jc, tables=jnp.asarray(tables))
        tc["tables"].copy_(torch.from_numpy(tables))
    else:
        jc = JG.init_cache(jcfg, B, max_len)
        tc = G.init_cache(cfg, B, max_len, device="cpu")
    jc = _filled(jc, tc, rng)
    before = {n: t.clone() for n, t in tc.items()}
    slot, pos0, length = (2, 0, 13) if kind == "prefill" else (1, 8, 11)
    toks = np.zeros((1, width), np.int32)
    toks[0, :length] = rng.integers(0, 64, length)
    if kind == "prefill":
        jl, jc = jax.jit(functools.partial(JG.prefill_slot, cfg=jcfg))(
            jp, jc, jnp.asarray(toks), jnp.asarray(length),
            jnp.asarray(slot))
        tl, tc = G.prefill_slot(params, tc, torch.from_numpy(toks),
                                _feed(length), _feed(slot, (1,)), cfg)
    else:
        jfn = JG.prefill_slot_chunk if kind == "chunk" \
            else jkv.paged_prefill_chunk
        tfn = G.prefill_slot_chunk if kind == "chunk" \
            else kv_pool.paged_prefill_chunk
        jl, jc = jax.jit(functools.partial(jfn, cfg=jcfg))(
            jp, jc, jnp.asarray(toks), jnp.asarray(pos0),
            jnp.asarray(length), jnp.asarray(slot))
        tl, tc = tfn(params, tc, torch.from_numpy(toks), _feed(pos0),
                     _feed(length), _feed(slot, (1,)), cfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5,
                               rtol=0)
    for name in tc:
        if name == "tables":
            assert torch.equal(tc[name], before[name])
            continue
        t = tc[name]
        if kind == "paged":
            written = torch.zeros(t.shape[1:3], dtype=torch.bool)
            for r in range(pos0, pos0 + length):
                written[tables[slot, r // bs], r % bs] = True
            t, old = t[:, :N], before[name][:, :N]   # block N: the sink
            written = written[:N][None].expand(t.shape[:3])
        else:
            written = torch.zeros(t.shape[:3], dtype=torch.bool)
            written[:, slot, pos0:pos0 + length] = True
            old = before[name]
        np.testing.assert_allclose(t.numpy(), np.asarray(jc[name]),
                                   atol=1e-5, rtol=0)
        assert torch.equal(t[~written], old[~written]), name
        assert not torch.equal(t[written], old[written]), name


# ---------------------------------------------------------------------------
# budgeted admission
# ---------------------------------------------------------------------------


def _rule_run(t0, n):
    out = [t0]
    for _ in range(n - 1):
        out.append((out[-1] * 3 + 1) % 13)
    return out


# rule-following prompts: the trained model's next token is the rule's,
# with margins no rounding difference reaches
MARKOV_PROMPTS = [_rule_run(4, 20), _rule_run(1, 3), _rule_run(7, 12),
                  _rule_run(2, 5)]


@pytest.fixture(scope="module")
def markov(markov_gpt):
    """The markov model computed in fp32 by both packages (its weights are
    the fp32 masters it was trained as)."""
    jcfg, jparams = markov_gpt
    return (dataclasses.replace(jcfg, dtype=jnp.float32), jparams,
            dataclasses.replace(convert.config_from_jax(jcfg),
                                dtype=torch.float32),
            convert.params_from_jax(jparams))


def _serve(srv, prompts, mode="tick", **kw):
    """Submit every prompt, then drive ``mode`` (tick, tick_block = 4-step
    blocks; async servers take either) until drained."""
    rids = [srv.submit(p, **kw) for p in prompts]
    for _ in range(400):
        if not srv.pending():
            break
        srv.tick_block(4) if mode == "tick_block" else srv.tick()
    assert not srv.pending()
    return [[int(t) for t in srv.result(r)] for r in rids]


@pytest.mark.parametrize("mode", ["tick", "tick_block", "async"])
@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_budgeted_streams_equal_jax(markov, layout, mode):
    """prefill_budget=5 with queueing (4 requests, 2 slots): the port's
    streams equal the JAX budgeted server's, follow the rule, and two
    long prompts were admitted in budget-wide chunks."""
    jcfg, jparams, cfg, params = markov
    kw = dict(max_batch=2, max_len=32, prefill_budget=5,
              async_dispatch=mode == "async", layout=layout)
    if layout == "paged":
        kw["block_size"] = 8
    srv = serving.DecodeServer(params, cfg, device="cpu", **kw)
    got = _serve(srv, MARKOV_PROMPTS, mode, max_new_tokens=8)
    jgot = _serve(jserving.DecodeServer(jparams, jcfg, **kw),
                  MARKOV_PROMPTS, mode, max_new_tokens=8)
    assert got == jgot
    for p, g in zip(MARKOV_PROMPTS, got):
        assert [p[-1]] + g == _rule_run(p[-1], 9)
    st = srv.stats()
    assert st["serving.admitting_claims"] == 2
    assert st["serving.prefill_chunks_interleaved"] >= 2
    assert srv.load_stats()["admitting_slots"] == 0


def _random_model():
    cfg = gpt.GPTConfig(vocab_size=64, hidden_size=64, num_layers=2,
                        num_heads=4, max_seq_len=128, dtype=torch.float32)
    return cfg, gpt.init_params(cfg, seed=0, device="cpu")


def _long_prompts(long_len=40, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 64, n).tolist() for n in (long_len, 5, 7)]


# 5: many small chunks; 16: a few; 39: two windows overlapping by one
# token over the 40-token prompt
@pytest.mark.parametrize("budget", [5, 16, 39])
def test_budgeted_matches_monolithic(budget):
    cfg, params = _random_model()
    prompts = _long_prompts()
    for layout in ("contiguous", "paged"):
        lay = dict(layout=layout, block_size=8) if layout == "paged" \
            else {}
        for mode in ("tick", "tick_block", "async"):
            kw = dict(max_batch=2, max_len=64, device="cpu",
                      async_dispatch=mode == "async", **lay)
            ref = _serve(serving.DecodeServer(params, cfg, **kw), prompts,
                         mode, max_new_tokens=8)
            srv = serving.DecodeServer(params, cfg, prefill_budget=budget,
                                       **kw)
            assert _serve(srv, prompts, mode, max_new_tokens=8) == ref, (
                layout, mode)
            long = [len(p) for p in prompts if len(p) > budget]
            st = srv.stats()
            assert {k: st.get(k, 0) for k in (
                "serving.admitting_claims",
                "serving.prefill_chunks_interleaved")} == {
                "serving.admitting_claims": len(long),
                "serving.prefill_chunks_interleaved": sum(
                    len(srv._chunk_starts(n, budget)) for n in long)}


def test_budgeted_sampled_draws_alike_in_every_mode():
    """Sampled requests at a budget: tick, tick_block(3|8) and async
    ticks draw the same tokens (counter-keyed draws; max_batch fits every
    prompt, so no admission lands at another step)."""
    cfg, params = _random_model()
    prompts = _long_prompts()

    def run(block, async_=False):
        srv = serving.DecodeServer(params, cfg, max_batch=3, max_len=64,
                                   device="cpu", prefill_budget=8, seed=7,
                                   async_dispatch=async_)
        rids = [srv.submit(p, max_new_tokens=8, temperature=0.8)
                for p in prompts]
        while srv.pending():
            srv.tick_block(block) if block else srv.tick()
        return [srv.result(r) for r in rids]

    ref = run(None)
    greedy = serving.DecodeServer(params, cfg, max_batch=3, max_len=64,
                                  device="cpu", prefill_budget=8)
    assert _serve(greedy, prompts, max_new_tokens=8) != ref   # it sampled
    for block in (3, 8):
        assert run(block) == ref, block
    assert run(None, async_=True) == ref


def test_budget_validation_and_flag(monkeypatch):
    cfg, params = _random_model()
    with pytest.raises(ValueError, match=">= 0"):
        serving.DecodeServer(params, cfg, 1, 32, device="cpu",
                             prefill_budget=-1)
    with pytest.raises(ValueError, match="prefill=True"):
        serving.DecodeServer(params, cfg, 1, 32, device="cpu",
                             prefill=False, prefill_budget=8)
    assert serving.DecodeServer(params, cfg, 1, 32, device="cpu",
                                prefill_budget=10_000)._budget == 32
    monkeypatch.delenv("PADDLE_TPU_PREFILL_BUDGET", raising=False)
    assert flags.prefill_budget() == 0
    k0 = engine.cfg_key(cfg)
    monkeypatch.setenv("PADDLE_TPU_PREFILL_BUDGET", "12")
    assert flags.prefill_budget() == 12
    assert engine.cfg_key(cfg) != k0     # a captured width: a new key
    assert serving.DecodeServer(params, cfg, 1, 32,
                                device="cpu")._budget == 12
    assert serving.DecodeServer(params, cfg, 1, 32, device="cpu",
                                prefill=False)._budget == 0
    for bad in ("-1", "x", "1.5"):
        monkeypatch.setenv("PADDLE_TPU_PREFILL_BUDGET", bad)
        with pytest.raises(ValueError):
            flags.prefill_budget()


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_warmup_covers_the_budget_width(layout):
    """warmup() builds the budget-width chunk step (named as the JAX
    warmup names it) besides the monolithic ones: a budgeted serve after
    it adds no Engine entry."""
    cfg, params = _random_model()
    lay = dict(layout=layout, block_size=8) if layout == "paged" else {}
    srv = serving.DecodeServer(params, cfg, max_batch=2, max_len=64,
                               device="cpu", prefill_budget=8, **lay)
    timings = srv.warmup(prompt_lens=[40, 5, 7])
    name = "paged_prefill8" if layout == "paged" else "prefill_chunk@8"
    assert name in timings
    keys = set(engine.ENGINE._steps.keys())
    _serve(srv, _long_prompts(), max_new_tokens=4)
    assert set(engine.ENGINE._steps.keys()) == keys
    srv.close()


# ---------------------------------------------------------------------------
# warmup on a drained paged server
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("async_", [False, True])
def test_warmup_after_a_drain_keeps_the_prefix_rows(async_):
    """Serve a prompt to the end, warm up, admit it again: the admission
    (adopting the prompt's indexed blocks) gives the logits of a server
    that was never warmed, bit for bit in fp32 — warmup's steps wrote
    through the pushed (empty) tables, into the sink."""
    cfg, params = _random_model()
    prompt = np.random.default_rng(3).integers(1, 64, 19).tolist()

    def readmit(warm):
        srv = serving.DecodeServer(params, cfg, max_batch=2, max_len=64,
                                   device="cpu", layout="paged",
                                   block_size=8, async_dispatch=async_)
        _serve(srv, [prompt], max_new_tokens=3)
        if warm:
            srv.warmup()
        seen = []
        prefill = srv._prefill_slot
        srv._prefill_slot = lambda p, s, *a: seen.append(
            prefill(p, s, *a).clone()) or seen[-1]
        _serve(srv, [prompt], max_new_tokens=3)
        assert srv.load_stats()["kv_pool"]["prefix_hits"] >= 16
        return seen[0]

    assert torch.equal(readmit(True), readmit(False))


# ---------------------------------------------------------------------------
# a half-prefilled slot under the resilience machinery
# ---------------------------------------------------------------------------


def _faulted(pkg, markov, prompts, spec, priorities=(0, 1), ttl=None,
             async_=False, layout="contiguous", sleep_on_requeue=0.0):
    """Serve ``prompts`` (5 new tokens each) through a budgeted
    (``prefill_budget=6``) server of ``pkg`` under the fault ``spec`` in
    that package's harness; the first request gets ``ttl``.  Returns
    (outcomes, statuses, whether request 0 was ever seen queued again,
    the compared counters).  The counters are what the serve added: the
    registry read after it minus a snapshot taken before the submits —
    an absolute read would also see what earlier tests of the worker left
    in the JAX registry that ``telemetry.reset()`` does not clear (a
    ``monitor.get_stat`` made outside the telemetry module, such as the
    reference telemetry test's ``serving.test_ms{slot="3"}``)."""
    from paddle_tpu import faults as jfaults
    from paddle_tpu import telemetry as jtl
    from paddle_tpu.framework import monitor
    from paddle_tpu_torch import faults
    from paddle_tpu_torch import telemetry as tl

    import time

    jcfg, jparams, cfg, params = markov
    f, t = (jfaults, jtl) if pkg == "jax" else (faults, tl)
    f.reset()
    t.reset()
    t.clear_runtime_wedge()
    f.install(spec)
    kw = dict(max_batch=2, max_len=32, prefill_budget=6,
              async_dispatch=async_, layout=layout)
    if layout == "paged":
        kw["block_size"] = 8
    try:
        srv = (jserving.DecodeServer(jparams, jcfg, **kw) if pkg == "jax"
               else serving.DecodeServer(params, cfg, device="cpu", **kw))
        before = (monitor.stats() if pkg == "jax" else tl.counters()).copy()
        rids = [srv.submit(p, max_new_tokens=5, priority=q,
                           ttl_s=ttl if i == 0 else None)
                for i, (p, q) in enumerate(zip(prompts, priorities))]
        requeued = False
        for _ in range(200):
            if not srv.pending():
                break
            srv.tick()
            if not requeued and srv.status(rids[0]) == "queued":
                requeued = True
                time.sleep(sleep_on_requeue)
        out = []
        for r in rids:
            try:
                out.append([int(x) for x in srv.result(r)])
            except (RuntimeError, TimeoutError) as e:
                out.append(type(e).__name__)
        st = [srv.status(r) for r in rids]
        srv.close()
    finally:
        f.reset()
        t.clear_runtime_wedge()
    got = monitor.stats() if pkg == "jax" else tl.counters()
    ctr = {k: int(v) - int(before.get(k, 0)) for k, v in sorted(got.items())
           if k.startswith(("serving.", "resilience.", "kv_pool."))}
    return out, st, requeued, {k: v for k, v in ctr.items() if v}


def _half_prefilled_prompts(seed):
    rng = np.random.default_rng(seed)
    return ([int(x) for x in rng.integers(1, 13, 20)],
            [int(x) for x in rng.integers(1, 13, 4)])


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_oom_evicts_half_prefilled_slot_and_finishes_exact(markov, layout):
    """A tick OOM while a long prompt is mid-admission: the ladder evicts
    the (lowest-priority) admitting slot back to the queue with its
    ORIGINAL prompt, and the request still finishes with its fault-free
    tokens — the JAX server's tokens, statuses and counters."""
    jcfg, jparams, cfg, params = markov
    long_p, short_p = _half_prefilled_prompts(4)
    clean = _serve(serving.DecodeServer(params, cfg, max_batch=2, max_len=32,
                                        device="cpu"),
                   [long_p, short_p], max_new_tokens=5)
    seen = {pkg: _faulted(pkg, markov, [long_p, short_p], "oom:tick:2",
                          layout=layout)
            for pkg in ("jax", "torch")}
    assert seen["torch"] == seen["jax"]
    out, st, requeued, ctr = seen["torch"]
    assert out == clean and st == ["ok", "ok"] and requeued
    assert ctr["resilience.oom_evictions"] >= 1
    # the evicted half-prefilled request claimed budgeted admission again
    assert ctr["serving.admitting_claims"] >= 2


def test_ttl_sheds_evicted_half_prefilled_request(markov):
    """An OOM-evicted admitting request with a tiny TTL: its queue clock
    restarts at the requeue, and the shed times it out instead of
    admitting it again; the short request is unaffected."""
    jcfg, jparams, cfg, params = markov
    long_p, short_p = _half_prefilled_prompts(5)
    clean_short = _serve(serving.DecodeServer(params, cfg, max_batch=2,
                                              max_len=32, device="cpu"),
                         [short_p], max_new_tokens=5)[0]
    seen = {pkg: _faulted(pkg, markov, [long_p, short_p], "oom:tick:2",
                          ttl=0.05, sleep_on_requeue=0.08)
            for pkg in ("jax", "torch")}
    assert seen["torch"] == seen["jax"]
    out, st, requeued, ctr = seen["torch"]
    assert requeued and st == ["timeout", "ok"]
    assert out == ["DeadlineExceeded", clean_short]
    assert ctr["resilience.deadline_sheds"] == 1


def test_wedge_recovery_with_admitting_slot(markov, monkeypatch):
    """A wedged async fetch while a long prompt is mid-admission: the
    watchdog cancels the work in flight and recovers with the admitting
    slot's chunk walk intact — the tokens of an unfaulted budgeted async
    serve, in both packages alike."""
    jcfg, jparams, cfg, params = markov
    long_p, short_p = _half_prefilled_prompts(6)
    clean = _serve(serving.DecodeServer(params, cfg, max_batch=2, max_len=32,
                                        device="cpu", prefill_budget=6,
                                        async_dispatch=True),
                   [long_p, short_p], max_new_tokens=5)
    monkeypatch.setenv("PADDLE_TPU_STEP_BUDGET_S", "0.3")
    monkeypatch.setenv("PADDLE_TPU_FAULT_WEDGE_S", "0.6")
    seen = {pkg: _faulted(pkg, markov, [long_p, short_p], "wedge:tick:2",
                          priorities=(0, 0), async_=True)
            for pkg in ("jax", "torch")}
    assert seen["torch"][:2] == seen["jax"][:2]
    assert seen["torch"][3] == seen["jax"][3]
    out, st, _, ctr = seen["torch"]
    assert out == clean
    assert ctr["resilience.wedge_detected"] >= 1
    assert ctr["resilience.wedge_recoveries"] >= 1
