"""The port's decode path and server (paddle_tpu_torch/text/generate.py,
serving.py) against the JAX package's, on the CPU.

* prefill + batched decode logits and cache rows on an fp32 tiny config
  (fp32 and int8 KV, distinct per-slot positions) — atol 1e-4 on logits
  (fp32 matmul order; 1e-3 under int8, where a row may quantize one step
  apart), int8 rows within one quantization step;
* served greedy tokens on the session's trained ``markov_gpt`` (bf16
  compute, as trained) identical to JAX ``generate`` and the JAX
  ``DecodeServer`` — a model whose next token depends on the fed token, so
  a wrong-input bug cannot hide behind an attractor token;
* the sampling filter, sampled-request laws, and the package boundary
  (no JAX imported, no silent CPU fallback).
"""
import dataclasses
import functools
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.text import generate as JG
from paddle_tpu.text import gpt as jgpt
from paddle_tpu.text import serving as jserving
from paddle_tpu_torch import convert
from paddle_tpu_torch.text import generate as G
from paddle_tpu_torch.text import gpt, serving

ARCHS = {"learned_mha": {},
         "rope_gqa": dict(pos_embed="rope", num_kv_heads=1,
                          norm="rmsnorm", activation="swiglu")}


def _tiny(arch):
    jcfg = jgpt.GPTConfig(vocab_size=64, hidden_size=128, num_layers=2,
                          num_heads=2, max_seq_len=64, dtype=jnp.float32,
                          **ARCHS[arch])
    jp = jgpt.init_params(jcfg, jax.random.PRNGKey(2))
    return (jcfg, jp, convert.config_from_jax(jcfg),
            convert.params_from_jax(jax.device_get(jp)))


def _rows_close(trow, jrow, int8):
    t, j = trow.numpy(), np.asarray(jrow)
    if not int8 or t.dtype != np.int8:
        np.testing.assert_allclose(t, j, atol=1e-5, rtol=1e-5)
    else:   # a value on a rounding boundary may land one step over
        assert np.abs(t.astype(np.int32) - j.astype(np.int32)).max() <= 1
        assert (t != j).mean() < 0.01


@pytest.mark.parametrize("kv", ["", "int8"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_prefill_and_batched_decode_match_jax(arch, kv, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_KV_DTYPE", kv)
    # an int8 row one quantization step apart moves a logit by ~1e-4
    tol = 1e-4 if kv == "" else 1e-3
    jcfg, jp, cfg, params = _tiny(arch)
    B, max_len = 3, 40
    jprefill = jax.jit(functools.partial(JG.prefill_slot, cfg=jcfg))
    jstep = jax.jit(functools.partial(jserving.decode_step_batched,
                                      cfg=jcfg))
    jcache = JG.init_cache(jcfg, B, max_len)
    tcache = G.init_cache(cfg, B, max_len, device="cpu")
    assert set(tcache) == set(jcache)
    assert all(tcache[n].shape == jcache[n].shape for n in jcache)
    rng = np.random.default_rng(0)
    lens = [5, 11, 17]
    seqs = [rng.integers(0, 64, n) for n in lens]
    for slot, s in enumerate(seqs):
        bucket = serving._pow2_bucket(len(s))
        pad = np.zeros((1, bucket), np.int32)
        pad[0, :len(s)] = s
        jl, jcache = jprefill(jp, jcache, jnp.asarray(pad),
                              jnp.asarray(len(s)), jnp.asarray(slot))
        tl, tcache = G.prefill_slot(params, tcache, torch.from_numpy(pad),
                                    len(s), slot, cfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=tol,
                                   rtol=0)
        for name in jcache:
            _rows_close(tcache[name][:, slot, :len(s)],
                        jcache[name][:, slot, :len(s)], kv == "int8")
    pos = np.array(lens, np.int32)
    for _ in range(4):
        tok = rng.integers(0, 64, B).astype(np.int32)
        jl, jcache = jstep(jp, jcache, jnp.asarray(tok), jnp.asarray(pos))
        tl, tcache = serving.decode_step_batched(
            params, tcache, torch.from_numpy(tok), torch.from_numpy(pos), cfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=tol,
                                   rtol=0)
        for name in jcache:
            for b in range(B):
                _rows_close(tcache[name][:, b, pos[b]],
                            jcache[name][:, b, pos[b]], kv == "int8")
        pos = pos + 1


def test_decode_step_scalar_pos_matches_per_slot():
    """``generate.decode_step`` takes one position for the batch or one
    per slot; the scalar is broadcast."""
    _, _, cfg, params = _tiny("learned_mha")
    tok = torch.tensor([3, 9])
    a, ca = G.decode_step(params, G.init_cache(cfg, 2, 16, "cpu"), tok, 0, cfg)
    b, cb = G.decode_step(params, G.init_cache(cfg, 2, 16, "cpu"), tok,
                          torch.zeros(2, dtype=torch.int32), cfg)
    assert torch.equal(a, b) and torch.equal(ca["k"], cb["k"])


def _rule_run(t0, n):
    out = [t0]
    for _ in range(n - 1):
        out.append((out[-1] * 3 + 1) % 13)
    return out


PROMPTS = [_rule_run(t0, n) for t0, n in [(1, 3), (4, 9), (7, 5), (11, 6),
                                          (2, 12)]]


@pytest.fixture(scope="module")
def markov(markov_gpt):
    jcfg, jparams = markov_gpt
    return (jcfg, jparams, convert.config_from_jax(jcfg),
            convert.params_from_jax(jparams))


def _serve(srv, prompts, **kw):
    rids = [srv.submit(p, **kw) for p in prompts]
    for _ in range(200):
        if not srv.pending():
            break
        srv.tick()
    assert not srv.pending()
    return [srv.result(r) for r in rids]


@pytest.mark.parametrize("prefill,kv", [(True, ""), (False, ""),
                                        (True, "int8")])
def test_markov_served_tokens_equal_jax(markov, prefill, kv, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_KV_DTYPE", kv)   # read at init_cache
    jcfg, jparams, cfg, params = markov
    assert cfg.dtype == torch.bfloat16      # served as trained
    srv = serving.DecodeServer(params, cfg, max_batch=3, max_len=32,
                               prefill=prefill, device="cpu")
    got = _serve(srv, PROMPTS, max_new_tokens=8)
    jsrv = jserving.DecodeServer(jparams, jcfg, max_batch=3, max_len=32)
    jgot = [list(map(int, t)) for t in _serve(jsrv, PROMPTS,
                                              max_new_tokens=8)]
    for p, g, jg in zip(PROMPTS, got, jgot):
        solo = np.asarray(JG.generate(jparams, jcfg, np.asarray([p]), 8))
        assert g == solo[0, len(p):].tolist() == jg
        assert [p[-1]] + g == _rule_run(p[-1], 9)     # follows the rule
    assert srv.load_stats()["tokens_generated"] == 8 * len(PROMPTS)


@pytest.mark.parametrize("chunk,kv", [(4, ""), (8, ""), (4, "int8")])
def test_markov_chunked_admission_equals_jax(markov, chunk, kv,
                                             monkeypatch):
    """``prefill_chunk=N`` on the contiguous layout: prompts longer than N
    admit through several ``prefill_slot_chunk`` calls (the last window
    overlapping the one before); tokens equal the JAX chunked server's
    and the whole-prompt server's."""
    monkeypatch.setenv("PADDLE_TPU_KV_DTYPE", kv)
    jcfg, jparams, cfg, params = markov
    srv = serving.DecodeServer(params, cfg, max_batch=3, max_len=32,
                               prefill_chunk=chunk, device="cpu")
    got = _serve(srv, PROMPTS, max_new_tokens=8)
    jsrv = jserving.DecodeServer(jparams, jcfg, max_batch=3, max_len=32,
                                 prefill_chunk=chunk)
    jgot = [list(map(int, t)) for t in _serve(jsrv, PROMPTS,
                                              max_new_tokens=8)]
    whole = _serve(serving.DecodeServer(params, cfg, max_batch=3,
                                        max_len=32, device="cpu"),
                   PROMPTS, max_new_tokens=8)
    assert got == jgot == whole
    assert srv.load_stats()["prefill_rows"] >= sum(map(len, PROMPTS))


def test_prefill_slot_chunk_matches_jax_rows():
    """Chunk logits and the slot's cache rows against the JAX
    ``prefill_slot_chunk`` on an fp32 config, two chunks per prompt."""
    jcfg, jp, cfg, params = _tiny("rope_gqa")
    jfn = jax.jit(functools.partial(JG.prefill_slot_chunk, cfg=jcfg))
    jcache = JG.init_cache(jcfg, 2, 40)
    tcache = G.init_cache(cfg, 2, 40, device="cpu")
    toks = np.random.default_rng(3).integers(0, 64, 27)
    for pos0, length in ((0, 16), (16, 11)):
        pad = np.zeros((1, 16), np.int32)
        pad[0, :length] = toks[pos0:pos0 + length]
        jl, jcache = jfn(jp, jcache, jnp.asarray(pad), jnp.asarray(pos0),
                         jnp.asarray(length), jnp.asarray(1))
        tl, tcache = G.prefill_slot_chunk(params, tcache,
                                          torch.from_numpy(pad), pos0,
                                          length, 1, cfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=0)
    for name in jcache:
        _rows_close(tcache[name][:, 1, :27], jcache[name][:, 1, :27], False)


def test_markov_generate_equals_jax(markov):
    jcfg, jparams, cfg, params = markov
    p = np.asarray([PROMPTS[1], PROMPTS[2][:1] * 9])
    ref = np.asarray(JG.generate(jparams, jcfg, p, 10))
    out = G.generate(params, cfg, p, 10, device="cpu")
    assert out.tolist() == ref.tolist()
    # sampling through a top-1 filter is greedy, whatever the generator
    top1 = G.generate(params, cfg, p, 10, temperature=2.0, top_k=1,
                      generator=torch.Generator().manual_seed(3),
                      device="cpu")
    assert top1.tolist() == ref.tolist()


def test_filter_logits_matches_jax():
    rng = np.random.default_rng(5)
    logits = (rng.standard_normal((5, 50)) * 3).astype(np.float32)
    temp = np.array([0.0, 0.7, 1.0, 1.3, 2.0], np.float32)
    topk = np.array([0, 1, 5, 0, 50], np.int32)
    topp = np.array([1.0, 1.0, 0.9, 0.5, 0.2], np.float32)
    ref = np.asarray(JG._filter_logits(jnp.asarray(logits), jnp.asarray(temp),
                                       jnp.asarray(topk), jnp.asarray(topp)))
    out = G._filter_logits(torch.from_numpy(logits), torch.from_numpy(temp),
                           torch.from_numpy(topk).long(),
                           torch.from_numpy(topp))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=0)
    scalar = G._filter_logits(torch.from_numpy(logits), 0.7, 3, 1.0)
    np.testing.assert_allclose(scalar.numpy(), np.asarray(
        JG._filter_logits(jnp.asarray(logits), 0.7, 3, 1.0)), rtol=1e-6)


def test_sampled_requests_obey_their_filter(markov):
    """top_k=1 sampling IS greedy; top_k=3 only ever emits one of the
    three highest-scoring tokens at its step (checked against the full
    forward over the served sequence)."""
    _, _, cfg, params = markov
    srv = serving.DecodeServer(params, cfg, max_batch=4, max_len=32,
                               seed=7, device="cpu")
    greedy = _serve(srv, PROMPTS[:2], max_new_tokens=8)
    top1 = _serve(srv, PROMPTS[:2], max_new_tokens=8, temperature=1.5,
                  top_k=1)
    assert top1 == greedy
    top3 = _serve(srv, PROMPTS[1:4] * 2, max_new_tokens=10,
                  temperature=5.0, top_k=3)
    for p, g in zip(PROMPTS[1:4] * 2, top3):
        seq = torch.tensor([p + g])
        logits = gpt.forward(params, seq, cfg)[0].float()
        for i, t in enumerate(g):
            assert t in torch.topk(logits[len(p) - 1 + i], 3).indices
    assert len({tuple(g) for g in top3}) > 1      # it did sample


def test_server_lifecycle(markov):
    _, _, cfg, params = markov
    srv = serving.DecodeServer(params, cfg, max_batch=1, max_len=32,
                               eos_id=_rule_run(PROMPTS[1][-1], 4)[-1],
                               device="cpu")
    a = srv.submit(PROMPTS[1], max_new_tokens=8)                # hits eos
    b = srv.submit(PROMPTS[2], max_new_tokens=8,
                   stop=[_rule_run(PROMPTS[2][-1], 3)[1:]])     # hits stop
    c = srv.submit(PROMPTS[3], max_new_tokens=8)
    assert srv.status(a) == "active" and srv.status(b) == "queued"
    st = srv.load_stats()
    assert (st["active_slots"], st["queue_depth"], st["free_slots"]) \
        == (1, 2, 0)
    while srv.status(b) != "ok":
        srv.tick()
    assert srv.result(a) == _rule_run(PROMPTS[1][-1], 4)[1:]
    assert srv.result(b) == _rule_run(PROMPTS[2][-1], 3)[1:]
    srv.close()
    assert srv.status(c) == "dropped"
    with pytest.raises(RuntimeError):
        srv.result(c)
    with pytest.raises(RuntimeError):
        srv.submit(PROMPTS[0])
    with pytest.raises(KeyError):
        srv.status(99)


@pytest.mark.parametrize("kw", [dict(prompt=[]),
                                dict(prompt=[1] * 30, max_new_tokens=5),
                                dict(prompt=[99]),
                                dict(prompt=[1], max_new_tokens=0),
                                dict(prompt=[1], temperature=-1.0),
                                dict(prompt=[1], top_p=0.0),
                                dict(prompt=[1], stop=[[]])])
def test_submit_validates(markov, kw):
    _, _, cfg, params = markov
    srv = serving.DecodeServer(params, cfg, max_batch=1, max_len=32,
                               device="cpu")
    with pytest.raises(ValueError):
        srv.submit(**kw)


def test_no_silent_cpu_fallback(markov, monkeypatch):
    """Entry points default to the card; without one they raise instead
    of running on the CPU."""
    _, _, cfg, params = markov
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serving.DecodeServer(params, cfg, max_batch=1, max_len=32)
    with pytest.raises(RuntimeError, match="CUDA"):
        G.generate(params, cfg, [PROMPTS[0]], 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        gpt.init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        G.init_cache(cfg, 1, 8)


def test_resolve_device_names_the_card(monkeypatch):
    """The default device is the current card BY INDEX, as tensors report
    it: an unindexed ``cuda`` never equals a parameter's ``cuda:0``, and
    the server would refuse its own params."""
    from paddle_tpu_torch import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    for name in (None, "cuda", "cuda:0"):
        assert resolve_device(name) == torch.device("cuda", 0)
    assert resolve_device("cpu") == torch.device("cpu")


def test_package_imports_no_jax():
    """Importing the port and every submodule leaves neither jax nor any
    module of the JAX package in sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import paddle_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "'paddle_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
        "('jax.', 'jaxlib')) or m == 'paddle_tpu' or "
        "m.startswith('paddle_tpu.')]\n"
        "assert len(names) >= 22, names\n"
        "for want in ('text.kv_pool', 'text.gpt_hybrid', 'ops.fused_ce', "
        "'ops.fused_norm', 'ops.woq_matmul', 'text.woq', "
        "'optimizer', 'optimizer.optimizer', 'tools.profile_train'):\n"
        "    assert 'paddle_tpu_torch.' + want in names, (want, names)\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


# ---------------------------------------------------------------------------
# tick_block and async dispatch (the step Engine's dispatch modes), on the
# markov model computed in fp32, float and int8 KV
# ---------------------------------------------------------------------------


def _fp32(markov):
    """The markov model computed in fp32 by both packages (its weights are
    the fp32 masters it was trained as)."""
    jcfg, jparams, cfg, params = markov
    return (dataclasses.replace(jcfg, dtype=jnp.float32), jparams,
            dataclasses.replace(cfg, dtype=torch.float32), params)


def _serve_mode(srv, prompts, block=None, **kw):
    """Submit every prompt, then ``tick_block(block)`` (or ``tick``) until
    drained; tokens per request as ints."""
    rids = [srv.submit(p, **kw) for p in prompts]
    for _ in range(300):
        if not srv.pending():
            break
        srv.tick_block(block) if block else srv.tick()
    assert not srv.pending()
    return [[int(t) for t in srv.result(r)] for r in rids]


@pytest.mark.parametrize("kv", ["", "int8"])
@pytest.mark.parametrize("block", [4, 8])
def test_tick_block_streams_equal_jax_and_single_ticks(markov, block, kv,
                                                       monkeypatch):
    """tick_block(4|8) with queueing (5 requests, 3 slots): the port's
    streams equal its own single ticks and the JAX server's tick_block."""
    monkeypatch.setenv("PADDLE_TPU_KV_DTYPE", kv)
    jcfg, jparams, cfg, params = _fp32(markov)
    kw = dict(max_batch=3, max_len=32)
    ticks = _serve_mode(serving.DecodeServer(params, cfg, device="cpu",
                                             **kw), PROMPTS,
                        max_new_tokens=8)
    got = _serve_mode(serving.DecodeServer(params, cfg, device="cpu", **kw),
                      PROMPTS, block, max_new_tokens=8)
    jgot = _serve_mode(jserving.DecodeServer(jparams, jcfg, **kw), PROMPTS,
                       block, max_new_tokens=8)
    assert got == ticks == jgot
    for p, g in zip(PROMPTS, got):
        assert [p[-1]] + g == _rule_run(p[-1], 9)


@pytest.mark.parametrize("kv", ["", "int8"])
def test_async_dispatch_equals_sync_and_jax(markov, kv, monkeypatch):
    """async_dispatch=True, greedy, under tick and tick_block(4): the same
    streams as the sync server and as the JAX async server."""
    monkeypatch.setenv("PADDLE_TPU_KV_DTYPE", kv)
    jcfg, jparams, cfg, params = _fp32(markov)
    kw = dict(max_batch=3, max_len=32)
    want = _serve_mode(serving.DecodeServer(params, cfg, device="cpu",
                                            **kw), PROMPTS,
                       max_new_tokens=8)
    for block in (None, 4):
        got = _serve_mode(serving.DecodeServer(
            params, cfg, device="cpu", async_dispatch=True, **kw), PROMPTS,
            block, max_new_tokens=8)
        jgot = _serve_mode(jserving.DecodeServer(
            jparams, jcfg, async_dispatch=True, **kw), PROMPTS, block,
            max_new_tokens=8)
        assert got == want == jgot, block


def test_async_sampled_equals_sync_sampled(markov):
    """Sampled serving draws from the (seed, step) keys: async tick and
    tick_block draw what sync tick and tick_block draw (no queueing — an
    admission shift changes which steps a queued slot occupies, as in
    the JAX server), and tick_block what tick draws."""
    _, _, cfg, params = _fp32(markov)
    kw = dict(max_batch=5, max_len=32, seed=5, device="cpu")
    samp = dict(max_new_tokens=8, temperature=3.0, top_k=6)
    want = _serve_mode(serving.DecodeServer(params, cfg, **kw), PROMPTS,
                       **samp)
    greedy = _serve_mode(serving.DecodeServer(params, cfg, **kw), PROMPTS,
                         max_new_tokens=8)
    assert want != greedy                        # sampling engaged
    for block in (None, 2, 4):
        for async_ in (False, True):
            got = _serve_mode(serving.DecodeServer(
                params, cfg, async_dispatch=async_, **kw), PROMPTS, block,
                **samp)
            assert got == want, (block, async_)


def test_eos_and_stop_mid_block_retire_and_readmit(markov):
    """Requests ending on eos or a stop sequence in the middle of a block
    retire there (the block's surplus discarded) and queued requests
    admit into the freed slots — tick_block and async as single ticks
    and as the JAX server's tick_block; a block overrunning the serving
    window's last row stays in the cache."""
    jcfg, jparams, cfg, params = _fp32(markov)
    prompts = PROMPTS + [_rule_run(5, 4), _rule_run(9, 7)]
    eos = _rule_run(PROMPTS[1][-1], 4)[-1]
    stop = [_rule_run(PROMPTS[2][-1], 3)[1:]]
    kw = dict(max_batch=2, max_len=32, eos_id=eos)
    submit = dict(max_new_tokens=10, stop=stop)
    want = _serve_mode(serving.DecodeServer(params, cfg, device="cpu",
                                            **kw), prompts, **submit)
    assert any(len(w) < 10 for w in want)        # eos / stop engaged
    jgot = _serve_mode(jserving.DecodeServer(jparams, jcfg, **kw), prompts,
                       3, **submit)
    assert jgot == want
    for block in (3, 8):
        for async_ in (False, True):
            got = _serve_mode(serving.DecodeServer(
                params, cfg, device="cpu", async_dispatch=async_, **kw),
                prompts, block, **submit)
            assert got == want, (block, async_)
    # a request filling the window (12 + 20 = 32 rows): its block's
    # overrun past row 31 is held at the last row
    full = [_rule_run(2, 12)]
    ref = _serve_mode(serving.DecodeServer(params, cfg, device="cpu",
                                           max_batch=1, max_len=32),
                      full, max_new_tokens=20)
    for async_ in (False, True):
        assert _serve_mode(serving.DecodeServer(
            params, cfg, device="cpu", max_batch=1, max_len=32,
            async_dispatch=async_), full, 8, max_new_tokens=20) == ref


def test_tick_block_rejects_block_below_one(markov):
    _, _, cfg, params = markov
    srv = serving.DecodeServer(params, cfg, max_batch=1, max_len=32,
                               device="cpu")
    for bad in (0, -1):
        with pytest.raises(ValueError, match="block"):
            srv.tick_block(bad)


def test_prompt_feeding_slots_fall_back_to_single_ticks(markov):
    """With prefill=False a slot feeds its prompt token by token, so
    tick_block runs single ticks (sync and async) — the same streams."""
    _, _, cfg, params = _fp32(markov)
    kw = dict(max_batch=2, max_len=32, prefill=False, device="cpu")
    want = _serve_mode(serving.DecodeServer(params, cfg, **kw), PROMPTS,
                       max_new_tokens=6)
    for async_ in (False, True):
        got = _serve_mode(serving.DecodeServer(
            params, cfg, async_dispatch=async_, **kw), PROMPTS, 4,
            max_new_tokens=6)
        assert got == want, async_


def test_close_abandons_in_flight_work(markov):
    _, _, cfg, params = markov
    srv = serving.DecodeServer(params, cfg, max_batch=2, max_len=32,
                               device="cpu", async_dispatch=True)
    a = srv.submit(PROMPTS[1], max_new_tokens=8)
    b = srv.submit(PROMPTS[2], max_new_tokens=8)
    c = srv.submit(PROMPTS[3], max_new_tokens=8)
    srv.tick()
    srv.tick_block(3)
    assert srv._inflight is not None             # a dispatch in flight
    srv.close()
    assert srv._inflight is None
    assert [srv.status(r) for r in (a, b, c)] == ["dropped"] * 3
    with pytest.raises(RuntimeError, match="abandoned"):
        srv.result(a)
    srv.close()                                  # idempotent
