"""The port's host-RAM KV spill tier (paddle_tpu_torch/text/kv_pool.py:
``spill_cold``, ``rss_watchdog``, the restore hook in ``adopt_prefix``,
``take_restores``, ``inject_rows``; the server's ``_evict_or_spill``,
``_spill_fetch`` and ``_drain_restores`` through the ``inject`` step)
against the JAX package's, on the CPU.

* ``inject_rows`` writes the same pool rows as the JAX function, fp32
  and int8 KV (the scale planes too), and nothing else;
* the allocator round trip op for op against the JAX allocator: cold
  block-aligned chains spill leaf-first, adoption restores them block by
  block, the restore records carry what was fetched at spill time, and
  the byte accounting against ``PADDLE_TPU_KV_SPILL_MB`` (an over-budget
  block is a plain drop) is the JAX allocator's, fp32 and int8 rows;
* the RSS watchdog: oldest spills first, then cold leaves, bounded by
  the spill batch — and riding the scheduler tick (1 in 16);
* serving: spill then restore gives the tokens of the cold pass and of
  the contiguous slab, the JAX server's tokens, stats and counters, and
  every restored row bit-equal to the row that was spilled, fp32 and
  int8 KV, sync and async; the pool tensors keep their addresses;
* an OOM fault whose first rung spills the cold prefix, with parity;
* the pressure phase's traffic (``profile_serving.pressure_waves``) at
  the paged path's geometry on a tiny model: spilled blocks, the
  returning wave's chain restored in full and none of its shared rows
  recomputed, streams equal to the evict-only and roomy servers'.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu import faults as jfaults
from paddle_tpu import telemetry as jtl
from paddle_tpu.framework import monitor
from paddle_tpu.text import generate as JG
from paddle_tpu.text import gpt as jgpt
from paddle_tpu.text import kv_pool as jkv
from paddle_tpu.text import serving as jserving
from paddle_tpu_torch import convert, faults
from paddle_tpu_torch import telemetry as tl
from paddle_tpu_torch.text import generate as G
from paddle_tpu_torch.text import gpt, kv_pool, serving
from paddle_tpu_torch.tools import profile_serving

FAMILIES = ("serving.", "resilience.", "kv_pool.")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


# each package's counters after the last reset (_mark): the compared
# counters are differences from it (_counters)
_BASE: dict = {}


def _raw(pkg) -> dict:
    got = monitor.stats() if pkg == "jax" else tl.counters()
    return {k: int(v) for k, v in got.items() if k.startswith(FAMILIES)}


def _mark() -> None:
    """Snapshot both packages' counters before a serve.  Comparing
    absolute registry contents would also see what earlier tests of the
    worker left in the JAX registry that ``telemetry.reset()`` does not
    clear (a ``monitor.get_stat`` made outside the telemetry module, such
    as the reference telemetry test's ``serving.test_ms{slot="3"}``)."""
    for pkg in ("jax", "torch"):
        _BASE[pkg] = _raw(pkg)


@pytest.fixture(autouse=True)
def _clean():
    for f, t in ((jfaults, jtl), (faults, tl)):
        f.reset()
        t.reset()
    _mark()
    yield
    jfaults.reset()
    faults.reset()


@pytest.fixture()
def kv_env(monkeypatch):
    """Env setter that also empties the JAX package's value-keyed step
    caches (the port reads the flags at construction)."""
    def set_(**kw):
        for k, v in kw.items():
            if v is None:
                monkeypatch.delenv(k, raising=False)
            else:
                monkeypatch.setenv(k, v)
        JG._GEN_CACHE.clear()
        jserving._STEP_CACHE.clear()
    yield set_
    JG._GEN_CACHE.clear()
    jserving._STEP_CACHE.clear()


def _counters(pkg) -> dict:
    """One package's nonzero counters of the compared families, as the
    difference from the last :func:`_mark`."""
    base = _BASE.get(pkg, {})
    got = {k: v - base.get(k, 0) for k, v in sorted(_raw(pkg).items())}
    return {k: v for k, v in got.items() if v}


@pytest.fixture(scope="module")
def markov(markov_gpt):
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


def _drain(srv, mode="tick"):
    for _ in range(300):
        if not srv.pending():
            return
        srv.tick_block(4) if mode == "tick_block" else srv.tick()
    raise AssertionError("the server did not drain")


# ---------------------------------------------------------------------------
# inject_rows
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv", ["", "int8"])
def test_inject_rows_matches_jax(kv, kv_env):
    kv_env(PADDLE_TPU_KV_DTYPE=kv or None)
    jcfg = jgpt.GPTConfig(vocab_size=32, hidden_size=64, num_layers=2,
                          num_heads=4, num_kv_heads=2, max_seq_len=64,
                          dtype=jnp.float32)
    cfg = convert.config_from_jax(jcfg)
    B, max_len, bs, N = 2, 40, 8, 10
    jc = JG.init_cache(jcfg, B, max_len, layout="paged", block_size=bs,
                       num_blocks=N)
    tc = G.init_cache(cfg, B, max_len, "cpu", layout="paged", block_size=bs,
                      num_blocks=N)
    rng = np.random.default_rng(3)
    tables = np.full(tuple(tc["tables"].shape), -1, np.int32)
    tables[1, :4] = rng.permutation(N)[:4]
    jc = dict(jc, tables=jnp.asarray(tables))
    tc["tables"].copy_(torch.from_numpy(tables))
    for name in kv_pool.POOL_LEAVES:
        if name in tc:
            v = rng.standard_normal(tuple(tc[name].shape)) * 50
            v = v.astype(np.asarray(jc[name]).dtype)
            jc = dict(jc, **{name: jnp.asarray(v)})
            tc[name].copy_(torch.from_numpy(v))
    before = {n: t.clone() for n, t in tc.items()}
    C, start, length, slot = 32, 5, 29, 1
    rows = {}
    for name in kv_pool.POOL_LEAVES:
        if name in tc:
            shape = (cfg.num_layers, 1, C) + tuple(tc[name].shape[3:])
            rows[name] = (rng.standard_normal(shape) * 50).astype(
                np.asarray(jc[name]).dtype)
    jout = jax.jit(jkv.inject_rows)(
        jc, {n: jnp.asarray(v) for n, v in rows.items()},
        jnp.asarray(start), jnp.asarray(length), jnp.asarray(slot))
    tout = kv_pool.inject_rows(
        tc, {n: torch.from_numpy(v) for n, v in rows.items()},
        torch.tensor([start]), torch.tensor(length), slot)
    assert tout is tc
    for name in rows:
        got, ref = tc[name][:, :N], np.asarray(jout[name])[:, :N]
        assert np.array_equal(got.numpy(), ref), name
        written = torch.zeros(got.shape[1:3], dtype=torch.bool)
        for r in range(start, length):
            written[tables[slot, r // bs], r % bs] = True
        assert torch.equal(got[:, ~written], before[name][:, :N][:, ~written])
        for r in range(start, length):
            b = tables[slot, r // bs]
            assert torch.equal(got[:, b, r % bs],
                               torch.from_numpy(rows[name][:, 0, r])), name


# ---------------------------------------------------------------------------
# the allocator
# ---------------------------------------------------------------------------


def _alloc_state(a):
    return (a.tables.tolist(), a._ref.tolist(), list(a._free),
            a._blk_ents.tolist(), sorted(a._spilled), a.stats())


def _fetchers(kv, L=2, bs=8):
    """(JAX fetch, port fetch) stamping each block's rows with its
    physical id: numpy [L, P, ...] arrays for the JAX allocator, one
    record of host tensors a block for the port's, int8 values with fp32
    scale planes under ``int8``."""
    def rows(blocks):
        dt = np.int8 if kv == "int8" else np.float32
        out = {"k": np.stack([np.full((L, bs, 2, 4), b, dt)
                              for b in blocks], axis=1)}
        if kv == "int8":
            out["k_s"] = np.stack([np.full((L, bs, 2), b + 0.5, np.float32)
                                   for b in blocks], axis=1)
        return out

    def records(blocks):                  # the port's: a record a block
        out = rows(blocks)
        return [{n: torch.from_numpy(v[:, j].copy()) for n, v in out.items()}
                for j in range(len(blocks))]

    return rows, records


@pytest.mark.parametrize("kv", ["fp32", "int8"])
def test_spill_restore_allocator_roundtrip(kv, kv_env):
    """Cold block-aligned chains demote leaf-first to host records within
    the byte budget (a block past it is a plain drop), adoption restores
    them block by block, and the restore records carry the rows fetched
    at spill time — the JAX allocator's state at every step."""
    fj, ft = _fetchers(kv)
    per_block = sum(v[:, 0].nbytes for v in fj([0]).values())
    kv_env(PADDLE_TPU_KV_SPILL_MB="1")
    allocs = [jkv.PagedAllocator(8, 8, 4, 2),
              kv_pool.PagedAllocator(8, 8, 4, 2)]
    for a in allocs:
        a.spill_limit_bytes = 3 * per_block      # room for three blocks

    def spill_all():
        for _ in range(8):
            if not allocs[1].prefix_entries:
                break
            assert allocs[0].spill_cold(8, fetch=fj) == \
                allocs[1].spill_cold(8, fetch=ft)
            assert _alloc_state(allocs[0]) == _alloc_state(allocs[1])

    prompt = list(range(24))              # 3 full blocks, aligned
    for a in allocs:
        a.ensure_rows(0, 0, 24)
        a.register_prefix(0, prompt)
        chain = [int(a.tables[0, i]) for i in range(3)]
        a.free_slot(0)
    spill_all()
    ta = allocs[1]
    assert ta.spilled_blocks == 3 and ta.blocks_in_use == 0
    assert ta.host_spill_bytes == 3 * per_block
    for a in allocs:                      # one more block: over budget
        a.ensure_rows(0, 0, 8)
        a.register_prefix(0, list(range(50, 58)))
        a.free_slot(0)
    spill_all()
    assert ta.spilled_blocks == 3 and ta.prefix_entries == 0
    shared = [a.adopt_prefix(1, prompt) for a in allocs]
    assert shared[0] == shared[1] == 23   # the whole chain, capped n - 1
    assert _alloc_state(allocs[0]) == _alloc_state(allocs[1])
    jrecs, trecs = (a.take_restores() for a in allocs)
    assert [r[:2] + r[3:] for r in trecs] == [r[:2] + r[3:] for r in jrecs]
    assert [r[1] for r in trecs] == [0, 8, 16]
    for pos, (slot, start, rows, blk) in enumerate(trecs):
        for name, v in rows.items():
            assert np.array_equal(v.numpy(), jrecs[pos][2][name])
        assert float(rows["k"][0, 0, 0, 0]) == float(chain[pos])
    assert ta.host_spill_bytes == 0 and not ta._spilled
    assert ta.take_restores() == []
    assert _counters("torch") == _counters("jax")
    assert _counters("torch")["kv_pool.restored_blocks"] == 3


@pytest.mark.parametrize("kv", ["", "int8"])
def test_spill_slots_hand_out_and_take_back(kv, kv_env):
    """The server's spill memory: whole slots within the budget, one
    record a block with every pool leaf at [L, bs, ...], records apart
    from each other, and a slot back on the free list once its record is
    dropped."""
    kv_env(PADDLE_TPU_KV_DTYPE=kv or None)
    cfg = gpt.GPTConfig(vocab_size=32, hidden_size=64, num_layers=2,
                        num_heads=4, num_kv_heads=2, max_seq_len=64,
                        dtype=torch.float32)
    cache = G.init_cache(cfg, 2, 32, "cpu", layout="paged", block_size=8,
                         num_blocks=6)
    names = [n for n in kv_pool.POOL_LEAVES if n in cache]
    per_block = sum(cache[n][:, 0].numel() * cache[n].element_size()
                    for n in names)
    slots = kv_pool.SpillSlots(cache, 3 * per_block + 64, pin=False)
    assert slots.free == 3 and slots.slot_bytes >= per_block
    recs = [slots.take() for _ in range(3)]
    assert slots.take() is None and slots.free == 0
    for i, rec in enumerate(recs):
        assert sorted(rec) == sorted(names)
        for n in names:
            assert rec[n].shape == cache[n][:, 0].shape
            assert rec[n].dtype == cache[n].dtype
            rec[n].fill_(i + 1)
    for i, rec in enumerate(recs):
        assert all(bool((rec[n] == i + 1).all()) for n in names)
    del recs[1], rec
    assert slots.free == 1
    assert slots.take() is not None


def test_restores_into_a_freed_block_are_dropped(kv_env):
    """A restore whose block dies before the drain (the request parked,
    its slot freed, the index dropped) is discarded with it, as a pending
    copy into a dead block is."""
    _, ft = _fetchers("fp32")
    kv_env(PADDLE_TPU_KV_SPILL_MB="1")
    a = kv_pool.PagedAllocator(8, 8, 4, 2)
    a.ensure_rows(0, 0, 8)
    a.register_prefix(0, list(range(8)))
    a.free_slot(0)
    assert a.spill_cold(8, fetch=ft) == 1
    assert a.adopt_prefix(1, list(range(9))) == 8
    a.free_slot(1)
    a.evict_cold()
    assert a.blocks_in_use == 0 and a.take_restores() == []


def test_rss_watchdog_releases_oldest_spills_then_evicts(kv_env):
    kv_env(PADDLE_TPU_KV_SPILL_MB="4", PADDLE_TPU_KV_SPILL_RSS_MB="1")
    fj, ft = _fetchers("fp32")
    allocs = [jkv.PagedAllocator(8, 8, 4, 2), kv_pool.PagedAllocator(8, 8, 4, 2)]
    for a, f in zip(allocs, (fj, ft)):
        a.ensure_rows(0, 0, 24)
        a.register_prefix(0, list(range(24)))
        a.free_slot(0)
        for _ in range(8):
            if not a.prefix_entries:
                break
            a.spill_cold(8, fetch=f)
        assert len(a._spilled) == 3 and a.host_spill_bytes > 0
        assert a.rss_watchdog(rss_bytes=1 << 20) == 0     # at threshold
        a.ensure_rows(0, 0, 8)
        a.register_prefix(0, list(range(100, 108)))
        a.free_slot(0)
        assert a.rss_watchdog(rss_bytes=2 << 20) == 4     # 3 spills + 1
        assert not a._spilled and a.host_spill_bytes == 0
        assert a.prefix_entries == 0 and a.rss_spills == 4
        assert a.rss_watchdog(rss_bytes=2 << 20) == 0
    assert _alloc_state(allocs[0]) == _alloc_state(allocs[1])
    assert _counters("torch") == _counters("jax")
    assert kv_pool._read_rss_bytes() > 0


def test_rss_watchdog_rides_the_scheduler_tick(kv_env, markov):
    """With the RSS threshold at 1 MiB (any process is over it) idle ticks
    run the watchdog every 16th tick and drain the retired request's
    cold chain — in both servers alike."""
    kv_env(PADDLE_TPU_KV_SPILL_RSS_MB="1")
    prompt = [int(x) for x in np.random.default_rng(3).integers(0, 13, 16)]
    seen = {}
    for pkg in ("jax", "torch"):
        srv = _server(pkg, markov, max_batch=2, max_len=32, layout="paged",
                      block_size=8)
        rid = srv.submit(prompt, max_new_tokens=4)
        _drain(srv)
        out = [int(t) for t in srv.result(rid)]
        assert srv._pool.prefix_entries > 0
        for _ in range(64):
            srv.tick()
        seen[pkg] = (out, srv._pool.stats(), srv._pool.rss_spills,
                     _counters(pkg))
        srv.close()
    assert seen["torch"] == seen["jax"]
    assert seen["torch"][1]["prefix_entries"] == 0
    assert seen["torch"][2] > 0


# ---------------------------------------------------------------------------
# serving: spill and restore
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv", ["fp32", "int8"])
@pytest.mark.parametrize("mode", ["tick", "async"])
def test_spill_restore_bit_parity(kv_env, kv, mode, markov):
    """Demote a retired prompt's whole chain to host memory, serve the
    prompt again: the tokens of the cold pass, of the contiguous slab and
    of the JAX server; at least 90% of the re-admission's rows restored,
    not recomputed; every restored pool row bit-equal to the row spilled;
    the pool tensors at the addresses they had."""
    kv_env(PADDLE_TPU_KV_DTYPE=None if kv == "fp32" else kv,
           PADDLE_TPU_KV_SPILL_MB="4")
    prompt = [int(x) for x in np.random.default_rng(9).integers(0, 13, 16)]
    async_ = mode == "async"
    seen, kept, restored = {}, {}, []
    for pkg in ("jax", "torch"):
        ref = _server(pkg, markov, max_batch=2, max_len=32,
                      async_dispatch=async_)
        r = ref.submit(prompt, max_new_tokens=6)
        _drain(ref)
        slab = [int(t) for t in ref.result(r)]
        ref.close()
        srv = _server(pkg, markov, max_batch=2, max_len=32, layout="paged",
                      block_size=8, async_dispatch=async_)
        if pkg == "torch":
            ptrs = {n: t.data_ptr() for n, t in srv.cache.items()}
            fetch, take = srv._spill_fetch, srv._pool.take_restores

            def spill_fetch(blocks):
                recs = fetch(blocks)
                for rec in recs:
                    kept[len(kept)] = {n: v.clone() for n, v in rec.items()}
                return recs

            def take_restores():
                recs = take()
                restored.extend(recs)
                return recs

            srv._spill_fetch = spill_fetch
            srv._pool.take_restores = take_restores
        r0 = srv.submit(prompt, max_new_tokens=6)
        _drain(srv)
        cold = [int(t) for t in srv.result(r0)]
        for _ in range(8):
            if not srv._pool.prefix_entries:
                break
            srv._evict_or_spill(8)
        assert srv._pool.spilled_blocks >= 2
        hits0 = srv._pool.prefix_hits
        r1 = srv.submit(prompt, max_new_tokens=6)
        _drain(srv)
        warm = [int(t) for t in srv.result(r1)]
        saved = srv._pool.prefix_hits - hits0
        stats = srv._pool.stats()
        if pkg == "torch":
            assert {n: t.data_ptr() for n, t in srv.cache.items()} == ptrs
            assert len(restored) == stats["restored_blocks"] >= 2
            for _slot, _start, rows, blk in restored:
                for name, v in rows.items():
                    assert torch.equal(srv.cache[name][:, blk], v), name
                assert any(all(torch.equal(v, k[n]) for n, v in rows.items())
                           for k in kept.values())
        srv.close()
        assert warm == cold == slab
        assert stats["restored_blocks"] >= 2
        assert saved >= 0.9 * (len(prompt) - 1)
        seen[pkg] = (warm, stats, _counters(pkg))
        tl.reset()
        jtl.reset()
        _mark()
    assert seen["torch"] == seen["jax"]


def test_oom_fault_spills_cold_prefix_with_parity(kv_env, markov):
    """With the spill tier on, an injected OOM's first rung demotes cold
    chains instead of dropping them, and the faulted pass keeps its
    tokens — both servers alike."""
    kv_env(PADDLE_TPU_KV_SPILL_MB="4")
    prompt = [int(x) for x in np.random.default_rng(5).integers(0, 13, 12)]

    def run(pkg, spec):
        f = jfaults if pkg == "jax" else faults
        f.reset()
        srv = _server(pkg, markov, max_batch=2, max_len=32, layout="paged",
                      block_size=8)
        r0 = srv.submit(prompt, max_new_tokens=4)
        _drain(srv, "tick_block")
        if spec:
            f.install(spec)
        r1 = srv.submit([int(x) for x in prompt[::-1][:10]],
                        max_new_tokens=4)
        _drain(srv, "tick_block")
        out = ([int(t) for t in srv.result(r0)],
               [int(t) for t in srv.result(r1)], srv._pool.stats())
        srv.close()
        f.reset()
        return out

    got = {}
    for pkg in ("jax", "torch"):
        clean = run(pkg, "")
        tl.reset()
        jtl.reset()
        _mark()
        faulted = run(pkg, "oom:serving.block:1")
        assert faulted[:2] == clean[:2]
        got[pkg] = (faulted, _counters(pkg))
    assert got["torch"] == got["jax"]
    assert got["torch"][1]["kv_pool.spilled_blocks"] >= 1
    assert got["torch"][1]["resilience.oom_retries"] == 1


# ---------------------------------------------------------------------------
# the pressure phase's traffic, at the paged path's geometry
# ---------------------------------------------------------------------------


def test_pressure_waves_restore_the_returning_prefix(monkeypatch):
    """``profile_serving.pressure_waves`` (system prompts A, B, C, D, E,
    then A again, 8 chat requests a wave, 64 new tokens each) through the
    paged path's geometry on a one-layer model: with the spill tier the
    waves spill, and the returning wave restores A's 12-block chain and
    recomputes none of its 192 rows; evict-only, it recomputes them; a
    roomy pool evicts nothing — and all three give the same streams."""
    cfg = gpt.GPTConfig(vocab_size=50304, hidden_size=64, num_layers=1,
                        num_heads=1, max_seq_len=2048, dtype=torch.float32)
    params = gpt.init_params(cfg, seed=0, device="cpu")
    waves = profile_serving.pressure_waves(cfg.vocab_size, seed=0)
    assert len(waves) == 6 and all(len(w) == 8 for w in waves)
    assert waves[-1][0][:200] == waves[0][0][:200]
    runs = {}
    for name, spill, blocks in (
            ("spill", profile_serving.PRESSURE_SPILL_MB, None),
            ("evict", 0, None), ("roomy", 0, 512)):
        monkeypatch.setenv("PADDLE_TPU_KV_SPILL_MB", str(spill))
        geo = dict(profile_serving.PAGED_GEOMETRY)
        if blocks:
            geo["num_blocks"] = blocks
        srv = serving.DecodeServer(params, cfg, device="cpu", **geo)
        runs[name] = (profile_serving.serve_waves(srv, waves,
                                                  profile_serving.NEW),
                      srv.stats(), srv.load_stats()["kv_pool"])
        srv.close()
    last = {k: r[0][-1] for k, r in runs.items()}
    for k in ("evict", "roomy"):
        assert [w["streams"] for w in runs[k][0]] == \
            [w["streams"] for w in runs["spill"][0]]
    assert runs["spill"][2]["spilled_blocks"] > 0
    assert last["spill"]["restored_blocks"] == 12
    # every request of the returning wave adopted the 12-block chain
    assert last["spill"]["prefix_hits"] >= 8 * 192
    assert last["spill"]["prefill_rows"] == \
        last["spill"]["prompt_rows"] - last["spill"]["prefix_hits"]
    assert last["evict"]["prefix_hits"] < 8 * 192
    assert last["evict"]["prefill_rows"] > last["spill"]["prefill_rows"]
    assert runs["roomy"][2]["prefix_entries"] > 0
    assert "resilience.oom_retries" not in runs["roomy"][1]
    assert runs["spill"][1]["resilience.oom_retries"] > 0
