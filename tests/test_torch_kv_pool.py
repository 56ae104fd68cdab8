"""The port's paged KV cache (paddle_tpu_torch/text/kv_pool.py, the paged
half of ops/decode_attention.py, DecodeServer(layout="paged")) against the
JAX package's, on the CPU.

* the block-table attention twin (``_plain_paged``) against the Pallas
  kernel ``_paged_call`` in interpret mode and its XLA oracle
  ``_xla_paged``, over fp32 / bf16 / int8 pools, G in {1, 4}, Tq in
  {1, 4}, block sizes 8 and 16, shuffled physical blocks and -1 entries
  past each slot's frontier.  fp32: atol 1e-5 (summation order only);
  bf16 outputs: atol = rtol = 1e-2, one bf16 ulp where the fp32 order
  tips a rounding;
* the host allocator replayed op for op against the JAX one on seeded
  random admission / decode / retire / eviction sequences: tables,
  refcounts, free lists, pending copies and ``stats()`` equal after
  every operation;
* ``paged_prefill_chunk`` and ``paged_decode_step_batched`` logits and
  pool rows against JAX on an fp32 architecture grid, fp32 and int8 KV
  (logits atol 1e-4, 1e-3 under int8 — a row may quantize one step
  apart);
* served greedy tokens on the session's trained ``markov_gpt``: port
  paged == port contiguous == the JAX paged server, on shared-prefix,
  fully shared (copy-on-write) and mid-block-split prompts, with equal
  allocator counters; pool exhaustion parks a request until blocks
  free;
* the paged path's own traffic (``profile_serving.paged_prompts``) on a
  tiny model at the path's geometry: the allocator counters the card
  run asserts.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops import decode_attention as jda
from paddle_tpu.text import generate as JG
from paddle_tpu.text import gpt as jgpt
from paddle_tpu.text import kv_pool as jkv
from paddle_tpu.text import serving as jserving
from paddle_tpu_torch import convert
from paddle_tpu_torch.ops import decode_attention as da
from paddle_tpu_torch.text import generate as G
from paddle_tpu_torch.text import gpt, kv_pool, serving
from paddle_tpu_torch.tools import profile_serving


@pytest.fixture()
def interpret():
    """Run the JAX decode kernels in Pallas interpret mode for one test."""
    old = jda._INTERPRET
    jda._INTERPRET = True
    yield
    jda._INTERPRET = old


# ---------------------------------------------------------------------------
# block-table attention
# ---------------------------------------------------------------------------

B, HKV, HD, NMAX = 3, 2, 64, 6


def _paged_inputs(G_, Tq, bs, kv, seed=0):
    """q [B, Tq, HKV*G, HD] and a pool of N shuffled blocks: slot b maps
    blocks through its frontier pos[b] + Tq - 1 (random distinct physical
    blocks) and leaves later entries -1.  Returns (jax inputs, torch
    inputs) — int8 through each package's own quantize_kv."""
    rng = np.random.default_rng(seed)
    N = B * NMAX + 2
    T = NMAX * bs
    dt = np.float32
    q = rng.standard_normal((B, Tq, HKV * G_, HD)).astype(dt)
    k = rng.standard_normal((N, bs, HKV, HD)).astype(dt)
    v = rng.standard_normal((N, bs, HKV, HD)).astype(dt)
    pos = np.array([3, bs + 1, T - Tq], np.int32)   # inside, past, at end
    perm = rng.permutation(N).astype(np.int32)
    tables = np.full((B, NMAX), -1, np.int32)
    for b in range(B):
        used = (pos[b] + Tq - 1) // bs + 1
        tables[b, :used] = perm[b * NMAX:b * NMAX + used]
    jin = [jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
           jnp.asarray(tables), jnp.asarray(pos), None, None]
    tin = [torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
           torch.from_numpy(tables), torch.from_numpy(pos), None, None]
    if kv == "bf16":
        jin[:3] = [a.astype(jnp.bfloat16) for a in jin[:3]]
        tin[:3] = [a.bfloat16() for a in tin[:3]]
    if kv == "int8":
        jin[1], jin[5] = jda.quantize_kv(jin[1])
        jin[2], jin[6] = jda.quantize_kv(jin[2])
        tin[1], tin[5] = da.quantize_kv(tin[1])
        tin[2], tin[6] = da.quantize_kv(tin[2])
    return jin, tin


def _close(out, ref, kv):
    out = out.float().numpy()
    ref = np.asarray(ref, np.float32)
    if kv == "bf16":
        np.testing.assert_allclose(out, ref, atol=1e-2, rtol=1e-2)
    else:
        np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("bs", [8, 16])
@pytest.mark.parametrize("Tq", [1, 4])
@pytest.mark.parametrize("G_", [1, 4])
@pytest.mark.parametrize("kv", ["fp32", "bf16", "int8"])
def test_plain_paged_matches_pallas_interpret(interpret, kv, G_, Tq, bs):
    jin, tin = _paged_inputs(G_, Tq, bs, kv)
    assert jda.paged_supported(jin[0].shape, jin[1].shape)
    ref = jda._paged_call(*jin, None)
    out = da.paged_decode_attention(*tin)      # CPU tensors: the twin
    assert out.dtype == tin[0].dtype and out.shape == tuple(ref.shape)
    _close(out, ref, kv)


@pytest.mark.parametrize("bs", [8, 16])
@pytest.mark.parametrize("Tq", [1, 4])
@pytest.mark.parametrize("G_", [1, 4])
@pytest.mark.parametrize("kv", ["fp32", "bf16", "int8"])
def test_plain_paged_matches_xla_oracle(kv, G_, Tq, bs):
    jin, tin = _paged_inputs(G_, Tq, bs, kv, seed=1)
    # a free slot too (table row all -1, pos 0): the oracle and the twin
    # both read block 0 there
    jin[3] = jin[3].at[1].set(-1)
    jin[4] = jin[4].at[1].set(0)
    tin[3][1] = -1
    tin[4][1] = 0
    ref = jda._xla_paged(*jin, None)
    _close(da._plain_paged(*tin, None), ref, kv)


def test_gather_and_shape_gate_match_jax():
    rng = np.random.default_rng(3)
    pool = rng.standard_normal((7, 8, 2, 4)).astype(np.float32)
    tables = np.array([[3, -1, 6], [0, 5, -1]], np.int32)
    ref = np.asarray(jda.gather_paged_view(jnp.asarray(pool),
                                           jnp.asarray(tables)))
    out = da.gather_paged_view(torch.from_numpy(pool),
                               torch.from_numpy(tables))
    np.testing.assert_array_equal(out.numpy(), ref)
    for q_shape, pool_shape in [((2, 1, 16, 128), (9, 16, 16, 128)),
                                ((2, 256, 16, 64), (9, 8, 4, 64)),
                                ((2, 257, 16, 64), (9, 8, 4, 64)),
                                ((1, 1, 4, 256), (9, 16, 4, 256)),
                                ((1, 1, 4, 96), (9, 16, 4, 96)),
                                ((1, 1, 4, 64), (9, 12, 4, 64)),
                                ((1, 1, 6, 64), (9, 16, 4, 64))]:
        assert da.paged_supported(q_shape, pool_shape) \
            == jda.paged_supported(q_shape, pool_shape)


def test_paged_wrapper_refuses():
    """What the paged kernel does not take raises before any launch."""
    q = torch.zeros(2, 1, 4, 64)
    pool = torch.zeros(5, 16, 4, 64)
    tables = torch.zeros(2, 3, dtype=torch.int32)
    pos = torch.zeros(2, dtype=torch.int32)
    da._check(q, pool, pool, pos, None, None, tables)   # accepted
    bad_bs = torch.zeros(5, 12, 4, 64)
    with pytest.raises(ValueError, match="block size 12"):
        da._check(q, bad_bs, bad_bs, pos, None, None, tables)
    with pytest.raises(ValueError, match="tables must be int32"):
        da._check(q, pool, pool, pos, None, None, tables.long())
    with pytest.raises(ValueError, match="tables must be int32"):
        da._check(q, pool, pool, pos, None, None, tables[:1])
    s = torch.zeros(5, 8, 4)
    qp = torch.zeros(5, 16, 4, 64, dtype=torch.int8)
    with pytest.raises(ValueError, match="k_scale must be float32"):
        da._check(q, qp, qp, pos, s, s, tables)


# ---------------------------------------------------------------------------
# host allocator: op-for-op replay against the JAX one
# ---------------------------------------------------------------------------


def _alloc_state(a):
    return (a.tables.tolist(), a._ref.tolist(), list(a._free),
            a._blk_ents.tolist(), list(a._pending_copies), a.stats())


def _replay(seed, radix, monkeypatch, n_ops=160):
    """Drive both allocators through one seeded sequence of what a server
    does — admissions (adopt, ensure, register), decode growth, retires,
    evictions, copy drains — with prompts over a 3-token alphabet that
    share prefixes and diverge mid-block."""
    monkeypatch.setenv("PADDLE_TPU_KV_RADIX", "1" if radix else "0")
    N, bs, nmax, mb = 14, 4, 8, 3
    ja = jkv.PagedAllocator(N, bs, nmax, mb)
    ta = kv_pool.PagedAllocator(N, bs, nmax, mb)
    rng = np.random.default_rng(seed)
    bases = [list(rng.integers(0, 3, 12)) for _ in range(3)]
    live = {}                                   # slot -> next write row
    for step in range(n_ops):
        op = rng.choice(["admit", "grow", "retire", "evict", "drain"],
                        p=[0.35, 0.35, 0.15, 0.1, 0.05])
        free = [s for s in range(mb) if s not in live]
        if op == "admit" and free:
            slot = int(rng.choice(free))
            base = bases[rng.integers(3)]
            cut = int(rng.integers(1, len(base) + 1))
            prompt = [int(t) for t in base[:cut]] + \
                [int(t) for t in rng.integers(0, 3, rng.integers(0, 6))]
            res = [a.adopt_prefix(slot, prompt) for a in (ja, ta)]
            assert res[0] == res[1], (step, res)
            errs = []
            for a in (ja, ta):
                try:
                    a.ensure_rows(slot, res[0], len(prompt))
                    errs.append(None)
                except (jkv.PoolExhausted, kv_pool.PoolExhausted) as e:
                    errs.append(type(e).__name__)
            assert errs[0] == errs[1], (step, errs)
            if errs[0] is None:
                for a in (ja, ta):
                    a.register_prefix(slot, prompt)
                live[slot] = len(prompt)
            else:
                for a in (ja, ta):
                    a.free_slot(slot)
        elif op == "grow" and live:
            slot = int(rng.choice(sorted(live)))
            p = live[slot]
            errs = []
            for a in (ja, ta):
                try:
                    a.ensure_rows(slot, p, min(p + 1, nmax * bs))
                    errs.append(None)
                except (jkv.PoolExhausted, kv_pool.PoolExhausted) as e:
                    errs.append(type(e).__name__)
            assert errs[0] == errs[1], (step, errs)
            live[slot] = p + 1
        elif op == "retire" and live:
            slot = int(rng.choice(sorted(live)))
            for a in (ja, ta):
                a.free_slot(slot)
            del live[slot]
        elif op == "evict":
            k = int(rng.integers(1, 4))
            assert ja.evict_cold(k) == ta.evict_cold(k)
        elif op == "drain":
            assert ja.take_copies() == ta.take_copies()
        assert _alloc_state(ja) == _alloc_state(ta), (step, op)
    for a in (ja, ta):
        a.close()
    assert _alloc_state(ja) == _alloc_state(ta)
    assert ta.blocks_in_use == 0
    return ta.stats()


@pytest.mark.parametrize("seed", range(6))
def test_allocator_replays_like_jax(seed, monkeypatch):
    stats = _replay(seed, True, monkeypatch)
    assert stats["prefix_hits"] > 0


def test_allocator_replays_like_jax_block_granular(monkeypatch):
    """PADDLE_TPU_KV_RADIX=0: whole-block matching, no splits."""
    stats = _replay(11, False, monkeypatch)
    assert stats["radix_splits"] == 0


def test_allocator_sequences_reach_every_path(monkeypatch):
    """The replayed sequences do exercise splits, copy-on-write and pool
    exhaustion (else the parity above would prove little)."""
    seen = {"radix_splits": 0, "cow_copies": 0}
    for seed in range(6):
        st = _replay(seed, True, monkeypatch)
        for k in seen:
            seen[k] += st[k]
    assert all(seen.values()), seen


def test_prefix_fingerprint_matches_jax():
    for run in [(), (1,), (3, 1, 4, 1, 5), tuple(range(300)), (2 ** 40,)]:
        assert kv_pool.prefix_fingerprint(run) == jkv.prefix_fingerprint(run)
        assert kv_pool.prefix_fingerprint(list(run)) \
            == kv_pool.prefix_fingerprint(run)


def test_round_len_and_cache_layout_match_jax(monkeypatch):
    for n, bs in [(32, 8), (33, 8), (5, 8), (500, 16), (600, 16)]:
        assert kv_pool.round_len(n, bs) == jkv.round_len(n, bs)
    for kv in ("", "int8"):
        monkeypatch.setenv("PADDLE_TPU_KV_DTYPE", kv)
        jcfg = jgpt.GPTConfig(vocab_size=16, hidden_size=32, num_layers=2,
                              num_heads=4, max_seq_len=64,
                              dtype=jnp.float32)
        cfg = convert.config_from_jax(jcfg)
        jc = JG.init_cache(jcfg, 3, 40, layout="paged", block_size=8)
        tc = G.init_cache(cfg, 3, 40, "cpu", layout="paged", block_size=8)
        assert set(tc) == set(jc)
        for name in jc:
            want = list(jc[name].shape)
            if name != "tables":
                want[1] += 1                      # + the sink block
            assert list(tc[name].shape) == want, name
            assert str(tc[name].dtype) == f"torch.{jc[name].dtype}"
        assert (tc["tables"] == -1).all()
    with pytest.raises(ValueError, match="multiple of 8"):
        G.init_cache(cfg, 1, 8, "cpu", layout="paged", block_size=12)
    with pytest.raises(ValueError, match="layout"):
        G.init_cache(cfg, 1, 8, "cpu", layout="ring")


def test_copy_blocks_copies_every_leaf(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_KV_DTYPE", "int8")
    cfg = gpt.GPTConfig(vocab_size=16, hidden_size=32, num_layers=2,
                        num_heads=4, max_seq_len=64, dtype=torch.float32)
    c = G.init_cache(cfg, 2, 16, "cpu", layout="paged", block_size=8)
    for name in kv_pool.POOL_LEAVES:
        c[name].copy_(torch.randn(c[name].shape).to(c[name].dtype))
    before = {n: c[n].clone() for n in kv_pool.POOL_LEAVES}
    kv_pool.copy_blocks(c, torch.tensor([0, 2]), torch.tensor([3, 1]))
    for n in kv_pool.POOL_LEAVES:
        assert torch.equal(c[n][:, 3], before[n][:, 0])
        assert torch.equal(c[n][:, 1], before[n][:, 2])
        assert torch.equal(c[n][:, 0], before[n][:, 0])


# ---------------------------------------------------------------------------
# paged prefill chunk + decode step against JAX
# ---------------------------------------------------------------------------

ARCHS = {"mha_learned": {},
         "gqa_rope_swiglu": dict(num_heads=4, num_kv_heads=2,
                                 pos_embed="rope", activation="swiglu",
                                 norm="rmsnorm")}


@pytest.mark.parametrize("kv", ["", "int8"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_paged_prefill_and_decode_match_jax(arch, kv, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_KV_DTYPE", kv)
    tol = 1e-4 if kv == "" else 1e-3
    kw = dict(vocab_size=64, hidden_size=128, num_layers=2, num_heads=2,
              max_seq_len=64, dtype=jnp.float32)
    jcfg = jgpt.GPTConfig(**{**kw, **ARCHS[arch]})
    jp = jgpt.init_params(jcfg, jax.random.PRNGKey(4))
    cfg = convert.config_from_jax(jcfg)
    params = convert.params_from_jax(jax.device_get(jp))
    Bn, max_len, bs, N = 3, 40, 8, 12
    jc = JG.init_cache(jcfg, Bn, max_len, layout="paged", block_size=bs,
                       num_blocks=N)
    tc = G.init_cache(cfg, Bn, max_len, "cpu", layout="paged",
                      block_size=bs, num_blocks=N)
    nmax = tc["tables"].shape[1]
    rng = np.random.default_rng(0)
    # shuffled blocks; slot 2 stays free (all -1, fed pos 0 below)
    tables = np.full((Bn, nmax), -1, np.int32)
    perm = rng.permutation(N).astype(np.int32)
    tables[0, :3] = perm[:3]
    tables[1, :4] = perm[3:7]
    jc = dict(jc, tables=jnp.asarray(tables))
    tc["tables"].copy_(torch.from_numpy(tables))
    jchunk = jax.jit(functools.partial(jkv.paged_prefill_chunk, cfg=jcfg))
    jstep = jax.jit(functools.partial(jkv.paged_decode_step_batched,
                                      cfg=jcfg))
    # slot 0: one 16-wide chunk of 13 tokens; slot 1: two chunks (the
    # second at pos0 = 16 attends the first's rows through the table)
    lens = {0: 13, 1: 27}
    for slot, chunks in ((0, [(0, 13)]), (1, [(0, 16), (16, 11)])):
        for pos0, length in chunks:
            toks = np.zeros((1, 16), np.int32)
            toks[0, :length] = rng.integers(0, 64, length)
            jl, jc = jchunk(jp, jc, jnp.asarray(toks), jnp.asarray(pos0),
                            jnp.asarray(length), jnp.asarray(slot))
            tl, tc = kv_pool.paged_prefill_chunk(
                params, tc, torch.from_numpy(toks), pos0, length, slot, cfg)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=tol,
                                       rtol=0)
    pos = np.array([lens[0], lens[1], 0], np.int32)
    for _ in range(4):
        tok = rng.integers(0, 64, Bn).astype(np.int32)
        jl, jc = jstep(jp, jc, jnp.asarray(tok), jnp.asarray(pos))
        tl, tc = serving.decode_step_batched(
            params, tc, torch.from_numpy(tok), torch.from_numpy(pos), cfg)
        np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2],
                                   atol=tol, rtol=0)
        pos = pos + np.array([1, 1, 0], np.int32)
    # every row the mapped blocks hold agrees (int8 within one step)
    used = perm[:7]
    for name in kv_pool.POOL_LEAVES:
        if name not in jc:
            continue
        t = tc[name][:, used].numpy()
        j = np.asarray(jc[name][:, used])
        if t.dtype == np.int8:
            assert np.abs(t.astype(np.int32) - j.astype(np.int32)).max() <= 1
        else:
            np.testing.assert_allclose(t, j, atol=1e-5, rtol=1e-5)


def test_free_slot_writes_land_in_the_sink():
    """A free slot's fresh row (table -1) goes to the sink block, never
    into a block the allocator owns."""
    cfg = gpt.GPTConfig(vocab_size=16, hidden_size=32, num_layers=1,
                        num_heads=4, max_seq_len=64, dtype=torch.float32)
    params = gpt.init_params(cfg, seed=0, device="cpu")
    c = G.init_cache(cfg, 2, 16, "cpu", layout="paged", block_size=8,
                     num_blocks=3)
    c["tables"][0, 0] = 1
    kv_pool.paged_decode_step_batched(
        params, c, torch.tensor([3, 5]), torch.tensor([0, 0],
                                                      dtype=torch.int32),
        cfg)
    assert c["k"][:, 1, 0].any()                 # slot 0's row
    assert not c["k"][:, [0, 2]].any()           # untouched blocks
    assert c["k"][:, 3, 0].any()                 # the free slot's: sink


# ---------------------------------------------------------------------------
# the server: port paged == port contiguous == the JAX paged server
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def markov(markov_gpt):
    jcfg, jparams = markov_gpt
    return (jcfg, jparams, convert.config_from_jax(jcfg),
            convert.params_from_jax(jparams))


def _serve(srv, prompts, max_new=6):
    rids = [srv.submit(p, max_new_tokens=max_new) for p in prompts]
    for _ in range(300):
        if not srv.pending():
            break
        srv.tick()
    assert not srv.pending()
    return [[int(t) for t in srv.result(r)] for r in rids]


def _three_ways(markov, prompts, max_batch=2, max_new=6, **paged_kw):
    """(port paged, port contiguous, JAX paged) tokens, and the two
    paged allocators' stats."""
    jcfg, jparams, cfg, params = markov
    kw = dict(max_batch=max_batch, max_len=32)
    tp = serving.DecodeServer(params, cfg, device="cpu", layout="paged",
                              **kw, **paged_kw)
    got = _serve(tp, prompts, max_new)
    cont = _serve(serving.DecodeServer(params, cfg, device="cpu", **kw),
                  prompts, max_new)
    jsrv = jserving.DecodeServer(jparams, jcfg, layout="paged", **kw,
                                 **paged_kw)
    jgot = _serve(jsrv, prompts, max_new)
    return got, cont, jgot, tp.load_stats()["kv_pool"], jsrv._pool.stats()


def _rule_ok(prompt, out):
    chain = [prompt[-1]]
    for _ in out:
        chain.append((chain[-1] * 3 + 1) % 13)
    return chain[1:] == out


@pytest.mark.parametrize("kv", ["", "bf16", "int8"])
def test_markov_paged_equals_contiguous_and_jax(markov, kv, monkeypatch):
    """Shared bs-aligned prefix + distinct tails (mirrors the JAX
    package's test_paged_matches_contiguous_greedy)."""
    monkeypatch.setenv("PADDLE_TPU_KV_DTYPE", kv)
    rng = np.random.default_rng(0)
    shared = [int(t) for t in rng.integers(0, 13, 8)]
    prompts = [shared + [1, 5], shared + [2],
               [int(t) for t in rng.integers(0, 13, 5)]]
    got, cont, jgot, st, jst = _three_ways(markov, prompts, block_size=8)
    assert got == cont == jgot
    assert st == jst and st["prefix_hits"] > 0
    assert all(_rule_ok(p, g) for p, g in zip(prompts, got))


def test_markov_fully_shared_prompt_copies_on_write(markov):
    """A prompt entirely indexed still computes its last token: the
    one-row write into the shared final block copies it."""
    prompt = [int(x) for x in np.random.default_rng(4).integers(0, 13, 16)]
    got, cont, jgot, st, jst = _three_ways(markov, [prompt, prompt],
                                           block_size=8)
    assert got == cont == jgot and got[0] == got[1]
    assert st == jst and st["cow_copies"] >= 1


def test_markov_mid_block_divergence_splits(markov):
    """14 shared tokens + 3-token tails at block size 8: the second
    prompt diverges inside indexed block 1 and adopts 14 rows through a
    radix split (mirrors the JAX package's split test)."""
    rng = np.random.default_rng(6)
    pre = [int(t) for t in rng.integers(0, 13, 14)]
    prompts = [pre + [1, 2, 3], pre + [4, 5, 6], pre + [7, 8, 9]]
    got, cont, jgot, st, jst = _three_ways(markov, prompts, max_batch=1,
                                           block_size=8)
    assert got == cont == jgot
    assert st == jst
    assert st["radix_splits"] >= 1 and st["prefix_hits"] >= 2 * 14


def test_markov_paged_prefix_hit_saves_prefill_rows(markov):
    """A repeated prompt adopts the registered blocks: admission runs
    only the suffix, tokens stay identical to the cold pass."""
    _, _, cfg, params = markov
    prompt = [int(x) for x in np.random.default_rng(3).integers(0, 13, 18)]
    srv = serving.DecodeServer(params, cfg, max_batch=1, max_len=32,
                               layout="paged", block_size=8, device="cpu")
    cold = _serve(srv, [prompt], 4)
    rows_cold = srv.load_stats()["prefill_rows"]
    warm = _serve(srv, [prompt], 4)
    rows_warm = srv.load_stats()["prefill_rows"] - rows_cold
    assert warm == cold and rows_warm < rows_cold
    assert srv.load_stats()["kv_pool"]["prefix_hits"] >= 16


@pytest.mark.parametrize("chunk", [4, 8])
def test_markov_paged_chunked_admission_equals_jax(markov, chunk):
    """``prefill_chunk=`` on the paged layout: several chunks per prompt
    after the adopted prefix."""
    rng = np.random.default_rng(8)
    pre = [int(t) for t in rng.integers(0, 13, 10)]
    prompts = [pre + [int(t) for t in rng.integers(0, 13, n)]
               for n in (7, 2, 11)]
    got, cont, jgot, st, jst = _three_ways(markov, prompts, block_size=8,
                                           prefill_chunk=chunk)
    assert got == cont == jgot and st == jst


def _serve_mode(srv, prompts, block=None, max_new=6):
    rids = [srv.submit(p, max_new_tokens=max_new) for p in prompts]
    for _ in range(300):
        if not srv.pending():
            break
        srv.tick_block(block) if block else srv.tick()
    assert not srv.pending()
    return [[int(t) for t in srv.result(r)] for r in rids]


@pytest.mark.parametrize("kv", ["", "int8"])
def test_paged_tick_block_maps_ahead_and_equals_contiguous(markov, kv,
                                                           monkeypatch):
    """Paged tick_block and async dispatch (mirrors the JAX package's
    test_paged_matches_contiguous_block_and_async), the markov model in
    fp32: streams equal the contiguous single-tick server's and the JAX
    paged server's under each mode; and before every block dispatch the
    tables the step reads map each active slot's rows [pos, pos + k)
    (clamped to the tables' reach) — allocation ahead of the block."""
    monkeypatch.setenv("PADDLE_TPU_KV_DTYPE", kv)
    jcfg, jparams, cfg, params = markov
    jcfg = dataclasses.replace(jcfg, dtype=jnp.float32)
    cfg = dataclasses.replace(cfg, dtype=torch.float32)
    rng = np.random.default_rng(1)
    prompts = [[int(t) for t in rng.integers(0, 13, n)] for n in (9, 4, 12)]
    kw = dict(max_batch=2, max_len=32)
    ref = _serve_mode(serving.DecodeServer(params, cfg, device="cpu", **kw),
                      prompts)
    seen = []
    real_get = serving.engine.ENGINE.get

    def spy_get(kind, spec):
        fn = real_get(kind, spec)
        if kind not in ("block", "async_block"):
            return fn

        def call(*feeds):
            seen.append((spec.k, feeds[-1].clone(),
                         spec.payload.cache["tables"].clone()))
            return fn(*feeds)
        return call

    monkeypatch.setattr(serving.engine.ENGINE, "get", spy_get)
    for block, async_ in ((3, False), (None, True), (3, True)):
        got = _serve_mode(serving.DecodeServer(
            params, cfg, device="cpu", layout="paged", block_size=8,
            async_dispatch=async_, **kw), prompts, block)
        jgot = _serve_mode(jserving.DecodeServer(
            jparams, jcfg, layout="paged", block_size=8,
            async_dispatch=async_, **kw), prompts, block)
        assert got == ref == jgot, (block, async_)
    assert len(seen) >= 4
    for k, pos, tables in seen:
        cap = tables.shape[1] * 8
        for b in range(pos.shape[0]):
            if (tables[b] < 0).all():
                continue                       # a free slot
            p = int(pos[b])
            lo, hi = p // 8, (min(p + k, cap) - 1) // 8
            assert (tables[b, lo:hi + 1] >= 0).all(), (k, p, tables[b])


def test_pool_exhaustion_queues_until_blocks_free(markov):
    """A pool too small for two requests at once serves both: the second
    parks at the queue front until the first retires its blocks."""
    _, _, cfg, params = markov
    srv = serving.DecodeServer(params, cfg, max_batch=2, max_len=32,
                               layout="paged", block_size=8, num_blocks=2,
                               device="cpu")
    p = [1, 2, 3, 4, 5, 6, 7, 8, 9]
    rids = [srv.submit(p, max_new_tokens=4) for _ in range(2)]
    assert srv.status(rids[1]) == "queued"
    assert srv.load_stats()["kv_utilization"] == 1.0
    for _ in range(200):
        if not srv.pending():
            break
        srv.tick()
    outs = [srv.result(r) for r in rids]
    assert outs[0] == outs[1] and len(outs[0]) == 4
    with pytest.raises(ValueError, match="needs 3 KV blocks"):
        srv.submit(list(range(13)) * 1 + [1] * 5, max_new_tokens=4)
    srv.close()
    assert srv.load_stats()["kv_pool"]["blocks_in_use"] == 0


def test_server_validates_layout_and_chunk(markov):
    _, _, cfg, params = markov
    with pytest.raises(ValueError, match="layout"):
        serving.DecodeServer(params, cfg, 1, 32, device="cpu", layout="x")
    with pytest.raises(ValueError, match="prefill_chunk requires"):
        serving.DecodeServer(params, cfg, 1, 32, device="cpu", prefill=False,
                             prefill_chunk=8)
    with pytest.raises(ValueError, match="prefill_chunk must be in"):
        serving.DecodeServer(params, cfg, 1, 32, device="cpu",
                             prefill_chunk=33)


# ---------------------------------------------------------------------------
# the paged path's traffic, at its geometry, on a tiny model
# ---------------------------------------------------------------------------


def test_paged_path_traffic_hits_its_counters():
    """``profile_serving``'s paged workload (8 chat requests sharing a
    200-token system prompt, 64 new tokens each) through the path's
    server geometry on a one-layer model: the allocator counters the card
    run asserts, and tokens equal to the contiguous server's."""
    cfg = gpt.GPTConfig(vocab_size=50304, hidden_size=64, num_layers=1,
                        num_heads=1, max_seq_len=2048, dtype=torch.float32)
    params = gpt.init_params(cfg, seed=0, device="cpu")
    prompts = profile_serving.paged_prompts(cfg.vocab_size, seed=0)
    assert prompts[2] == prompts[1]
    assert all(p[:200] == prompts[0][:200] for p in prompts)
    srv = serving.DecodeServer(params, cfg, device="cpu",
                               **profile_serving.PAGED_GEOMETRY)
    got = _serve(srv, prompts, profile_serving.NEW)
    st = srv.load_stats()
    pool = st["kv_pool"]
    assert pool["prefix_hits"] >= 7 * 192
    assert pool["cow_copies"] >= 1 and pool["radix_splits"] >= 1
    assert st["prefill_rows"] < sum(map(len, prompts))
    cont = serving.DecodeServer(params, cfg, max_batch=8, max_len=512,
                                device="cpu")
    assert _serve(cont, prompts, profile_serving.NEW) == got
