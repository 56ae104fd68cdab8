"""Speculative decoding in the port's server (paddle_tpu_torch/text/
serving.py ``DecodeServer(spec_k=, draft_cfg=, draft_params=)``, the
Engine's ``spec_verify`` kind) against the JAX server, on the CPU — the
cases of ``tests/test_spec_serving.py`` (its MoE, adapter and Router
cases aside: the port has none of them yet):

* greedy: a speculating server's streams equal the plain server's and
  the JAX speculating server's token for token — a draft model
  (contiguous and paged, ``tick`` and ``tick_block``), n-gram
  self-drafting (both layouts), async dispatch (tick and block), a
  smaller distinct draft on the trained ``markov_gpt``, int8 KV, a
  warmed server, a slot whose window ends K rows past it (plain ticks at
  the edge), a server at the admission ladder's spec-off rung; target
  passes a token at least 1.5x fewer than plain with draft == target
  (and the JAX server's counts);
* sampled: the second generated token of requests served next to a
  stranger follows the target's exact two-step law (chi-square), with a
  draft and self-drafting — held by law, as the port's host streams are
  not ``jax.random``'s;
* the acceptance fallback on a draft that proposes garbage and the
  re-earn after its cooldown, the
  ``spec.*`` counters (each package's counted as its difference across
  the serve) and the accept-rate gauge, an OOM evicting speculating
  slots (tokens and counters JAX's), the NaN guard over a round's verify
  logits, ``PADDLE_TPU_SPEC_K`` in
  ``flags.decode_jit_key``, the verify's capture in the recompile log,
  the constructor's refusals, and the four ``ngram_propose`` cases.

Models are the reference suite's random one (vocab 32, 2 layers) in fp32
in both packages.
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
from paddle_tpu.text import serving as jserving
from paddle_tpu_torch import convert, faults, flags
from paddle_tpu_torch import telemetry as tl
from paddle_tpu_torch.text import admission, engine
from paddle_tpu_torch.text import generate as G
from paddle_tpu_torch.text import serving

from test_torch_speculative import _chi2, _second_token_law


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(autouse=True)
def _clean():
    for f in (jfaults, faults):
        f.reset()
    yield
    for f in (jfaults, faults):
        f.reset()


def _pair(seed, **over):
    kw = dict(vocab_size=32, hidden_size=32, num_layers=2, num_heads=4,
              max_seq_len=64, dtype=jnp.float32)
    kw.update(over)
    jcfg = jgpt.GPTConfig(**kw)
    jp = jax.device_get(jgpt.init_params(jcfg, jax.random.PRNGKey(seed)))
    return jcfg, jp, convert.config_from_jax(jcfg), \
        convert.params_from_jax(jp)


@pytest.fixture(scope="module")
def markov(markov_gpt):
    jcfg, jparams = markov_gpt
    return (dataclasses.replace(jcfg, dtype=jnp.float32), jparams,
            dataclasses.replace(convert.config_from_jax(jcfg),
                                dtype=torch.float32),
            convert.params_from_jax(jparams))


def _server(pkg, model, draft=None, **kw):
    """A server of ``pkg`` on ``model``; ``draft``: "self" (draft ==
    target) or another model tuple."""
    jcfg, jp, cfg, params = model
    if draft is not None:
        d = model if draft == "self" else draft
        kw.update(draft_cfg=d[0] if pkg == "jax" else d[2],
                  draft_params=d[1] if pkg == "jax" else d[3])
    if pkg == "jax":
        return jserving.DecodeServer(jp, jcfg, **kw)
    return serving.DecodeServer(params, cfg, device="cpu", **kw)


def _drive(srv, prompts, max_new=8, block=0, **sub):
    rids = [srv.submit(p, max_new_tokens=max_new, **sub) for p in prompts]
    for _ in range(500):
        if not srv.pending():
            break
        srv.tick_block(block) if block > 1 else srv.tick()
    assert not srv.pending()
    return [[int(t) for t in srv.result(r)] for r in rids]


def _serve(pkg, model, prompts, max_new=8, block=0, draft=None, **kw):
    srv = _server(pkg, model, draft, **kw)
    out = _drive(srv, prompts, max_new, block)
    srv.close()
    return out


def _prompts(seed, n, length, hi=30):
    rng = np.random.default_rng(seed)
    return [[int(x) for x in rng.integers(1, hi, length)] for _ in range(n)]


def _layout(layout):
    kw = dict(max_batch=2, max_len=48, layout=layout)
    if layout == "paged":
        kw["block_size"] = 8
    return kw


# ---------------------------------------------------------------------------
# greedy: spec server == plain server == the JAX spec server
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("block", [0, 4])
def test_spec_draft_greedy_parity(layout, block):
    """Draft-model speculation on both layouts under tick and
    tick_block: mid-round rejections leave stale rows the mask hides,
    and the streams are the plain server's and the JAX server's."""
    model = _pair(0)
    prompts = _prompts(0, 3, 5)
    kw = _layout(layout)
    ref = _serve("torch", model, prompts, block=block, **kw)
    got = _serve("torch", model, prompts, block=block, draft="self",
                 spec_k=4, **kw)
    assert got == ref
    assert got == _serve("jax", model, prompts, block=block, draft="self",
                         spec_k=4, **kw)


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_spec_self_draft_greedy_parity(layout):
    model = _pair(1)
    prompts = [[5, 9, 5, 9, 5, 9]] + _prompts(1, 1, 7)
    kw = _layout(layout)
    ref = _serve("torch", model, prompts, **kw)
    got = _serve("torch", model, prompts, spec_k=4, **kw)
    assert got == ref
    assert got == _serve("jax", model, prompts, spec_k=4, **kw)


@pytest.mark.parametrize("block", [0, 4])
def test_spec_async_dispatch_parity(block):
    """An async server drains its step in flight and speculates
    synchronously: the plain streams, and the JAX async spec server's."""
    model = _pair(2)
    prompts = _prompts(2, 3, 4)
    kw = dict(max_batch=2, max_len=48)
    ref = _serve("torch", model, prompts, block=block, **kw)
    got = _serve("torch", model, prompts, block=block, draft="self",
                 spec_k=3, async_dispatch=True, **kw)
    assert got == ref
    assert got == _serve("jax", model, prompts, block=block, draft="self",
                         spec_k=3, async_dispatch=True, **kw)


def test_spec_small_distinct_draft_parity(markov):
    """A different, smaller draft on the trained markov target (whose next
    token depends on the fed token, so a wrong feed shows)."""
    jcfg = markov[0]
    jdcfg = jgpt.GPTConfig(vocab_size=jcfg.vocab_size, hidden_size=32,
                           num_layers=1, num_heads=2,
                           max_seq_len=jcfg.max_seq_len, dtype=jnp.float32)
    jdp = jax.device_get(jgpt.init_params(jdcfg, jax.random.PRNGKey(7)))
    draft = (jdcfg, jdp, convert.config_from_jax(jdcfg),
             convert.params_from_jax(jdp))
    prompts = _prompts(3, 3, 5, hi=13)
    kw = dict(max_batch=2, max_len=32)
    ref = _serve("torch", markov, prompts, **kw)
    got = _serve("torch", markov, prompts, draft=draft, spec_k=3, **kw)
    assert got == ref
    assert got == _serve("jax", markov, prompts, draft=draft, spec_k=3, **kw)


def test_spec_kv_dtype_parity(monkeypatch):
    """int8 KV on both layouts: the verify writes through the quantized
    store (the contiguous cache's scale planes, the pool's through the
    tables) — spec and plain agree in the same storage dtype, and with
    the JAX int8 spec server."""
    monkeypatch.setenv("PADDLE_TPU_KV_DTYPE", "int8")
    model = _pair(3)
    prompts = _prompts(4, 2, 6)
    for layout in ("contiguous", "paged"):
        kw = _layout(layout)
        got = _serve("torch", model, prompts, draft="self", spec_k=4, **kw)
        assert got == _serve("torch", model, prompts, **kw), layout
        assert got == _serve("jax", model, prompts, draft="self", spec_k=4,
                             **kw), layout


def _passes(srv):
    return (srv._spec_rounds + srv._spec_plain_steps if srv._spec_on
            else srv._step_no)


def test_spec_fewer_target_passes():
    """Draft == target: at least 1.5x fewer target passes than plain
    serving, the same streams, and the JAX server's pass counts."""
    model = _pair(0)
    prompts = _prompts(5, 2, 5)
    out = {}
    for pkg in ("torch", "jax"):
        for name, kw in (("plain", {}), ("spec", dict(draft="self",
                                                      spec_k=4))):
            srv = _server(pkg, model, max_batch=2, max_len=48, **kw)
            toks = _drive(srv, prompts, 12)
            out[pkg, name] = (toks, _passes(srv))
            srv.close()
    assert out["torch", "spec"][0] == out["torch", "plain"][0]
    assert out["torch", "plain"][1] >= 1.5 * out["torch", "spec"][1], out
    assert out["torch", "spec"] == out["jax", "spec"]


def test_spec_warmed_server_parity():
    """warmup() builds spec_verify@K, the draft's step and block and its
    admission steps, and the warmed server serves the plain streams with
    no build after it."""
    model = _pair(4)
    prompts = _prompts(6, 2, 5)
    ref = _serve("torch", model, prompts, max_batch=2, max_len=48)
    srv = _server("torch", model, "self", max_batch=2, max_len=48,
                  spec_k=4)
    warmed = srv.warmup()
    assert "spec_verify@4" in warmed and "draft_step" in warmed
    assert "draft_block3" in warmed
    assert any(k.startswith("draft_prefill") for k in warmed)
    n_builds = len(tl.compile_log())
    assert _drive(srv, prompts) == ref
    assert len(tl.compile_log()) == n_builds
    srv.close()


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_spec_slot_at_window_edge(layout):
    """A request whose prompt + max_new fill the window (20 + 12 = 32):
    at position 30 a round of K = 5 would write past ``max_len``, so the
    server runs plain ticks there — no write past a slot's rows, the
    plain streams, JAX's."""
    model = _pair(5)
    prompts = [_prompts(7, 1, 20)[0], _prompts(8, 1, 9)[0]]
    kw = dict(max_batch=2, max_len=32, layout=layout)
    if layout == "paged":
        kw["block_size"] = 8
    ref = _serve("torch", model, prompts, max_new=12, **kw)
    srv = _server("torch", model, "self", spec_k=5, **kw)
    got = _drive(srv, prompts, 12)
    assert srv._spec_plain_steps > 0 and srv._spec_rounds > 0
    srv.close()
    assert got == ref
    assert got == _serve("jax", model, prompts, max_new=12, draft="self",
                         spec_k=5, **kw)


def test_spec_forced_off_at_the_spec_off_rung():
    """At the admission ladder's spec-off rung a new claim decodes plain:
    ``spec_off`` at claim and ``admission.spec_forced`` counted, as in the
    JAX server (whose re-earn rule the port keeps: the flag carries no
    cooldown, so the slot rejoins at the next eligible round); the streams
    stay the plain ones."""
    model = _pair(6)
    prompts = _prompts(9, 2, 5)
    ref = _serve("torch", model, prompts, max_batch=2, max_len=48)
    seen = {}
    for pkg in ("jax", "torch"):
        t = jtl if pkg == "jax" else tl
        t.reset()
        srv = _server(pkg, model, "self", max_batch=2, max_len=48, spec_k=4)
        srv._adm.rung = admission.RUNG_SPEC_OFF
        # class 1: the rung's halved admit cap bounds class 0 only
        rids = [srv.submit(p, max_new_tokens=8, priority=1)
                for p in prompts]
        forced = [st.get("spec_off") for st in srv._slots.values()]
        while srv.pending():
            srv.tick()
        got = monitor.stats() if pkg == "jax" else tl.counters()
        seen[pkg] = ([[int(x) for x in srv.result(r)] for r in rids],
                     forced, int(got.get("admission.spec_forced", 0)),
                     int(got.get("spec.reearns", 0)))
        srv.close()
    assert seen["torch"] == seen["jax"]
    assert seen["torch"][0] == ref
    assert seen["torch"][1] == [True, True] and seen["torch"][2] == 2


# ---------------------------------------------------------------------------
# sampling: the token law is the target's
# ---------------------------------------------------------------------------


def _second_token_counts(model, prompt, n, temperature, stranger=None,
                         **kw):
    """n second-token draws from ONE server: each request id seeds its own
    streams, so n submits are n independent samples."""
    srv = _server("torch", model, seed=77, **kw)
    rids = []
    for _ in range(n):
        rids.append(srv.submit(prompt, max_new_tokens=2,
                               temperature=temperature))
        if stranger is not None:
            srv.submit(stranger, max_new_tokens=2, temperature=temperature)
    while srv.pending():
        srv.tick()
    toks = [srv.result(r)[1] for r in rids]
    assert srv._spec_rounds > 0
    srv.close()
    return np.bincount(toks, minlength=12).astype(float)


@pytest.mark.parametrize("drafting", ["draft", "self_draft"])
def test_spec_sampled_serving_follows_target_law(drafting):
    """Chi-square at batch > 1: token #2 of a sampled request served next
    to a stranger through verify rounds follows the target's exact
    two-step law (with a draft: draft == target; self-drafting: q is a
    point mass)."""
    model = _pair(9, vocab_size=12)
    _, _, cfg, params = model
    n = 200
    if drafting == "draft":
        prompt, temp = [4, 7], 1.3
        kw = dict(draft="self", stranger=[2, 9, 1])
    else:
        prompt, temp = [4, 7, 4, 7], 1.1
        kw = {}
    law = _second_token_law(params, cfg, prompt, temp, 0, 1.0)
    counts = _second_token_counts(model, prompt, n, temp, max_batch=4,
                                  max_len=16, spec_k=3, **kw)
    stat, df = _chi2(counts, law, n)
    assert stat < 3 * max(df, 1) + 10, stat


# ---------------------------------------------------------------------------
# fallback, telemetry, pressure, keys, refusals
# ---------------------------------------------------------------------------


def _biased(model):
    """A draft proposing one constant token: the final LN bias pushed
    toward embedding row 10 makes every logit row argmax to it (a merely
    re-seeded random draft agrees with the target too often)."""
    jcfg, jp, cfg, params = model
    jbad = dict(jp)
    jbad["ln_f_b"] = jp["ln_f_b"] + 50.0 * jp["wte"][10]
    return jcfg, jbad, cfg, convert.params_from_jax(jbad)


def _diff(pkg, before) -> dict:
    """A package's counters of the spec / serving / resilience families
    now, minus ``before`` (its :func:`_snap`): what one serve counted,
    whatever earlier tests left in the registry."""
    now = _snap(pkg)
    return {k: v - before.get(k, 0) for k, v in now.items()
            if v != before.get(k, 0)}


def _snap(pkg) -> dict:
    got = monitor.stats() if pkg == "jax" else tl.counters()
    return {k: int(v) for k, v in got.items()
            if k.startswith(("spec.", "serving.", "resilience."))}


def test_spec_fallback_on_bad_draft(monkeypatch):
    """A draft proposing garbage trips the per-request fallback (the slot
    takes plain steps) and the streams are still the plain ones; the
    fallbacks and the accept rate are the JAX server's."""
    monkeypatch.setenv("PADDLE_TPU_SPEC_MIN_ACCEPT", "0.6")
    model = _pair(0)
    bad = _biased(model)
    prompts = _prompts(7, 2, 5)
    ref = _serve("torch", model, prompts, max_new=16, max_batch=2,
                 max_len=64)
    seen = {}
    for pkg in ("jax", "torch"):
        before = _snap(pkg)
        srv = _server(pkg, model, bad, max_batch=2, max_len=64, spec_k=4)
        got = _drive(srv, prompts, 16)
        stats = srv.load_stats()
        plain = srv._spec_plain_steps
        srv.close()
        d = _diff(pkg, before)
        seen[pkg] = (got, d.get("spec.fallbacks", 0),
                     stats["spec_accept_rate"], plain)
    assert seen["torch"] == seen["jax"]
    got, fallbacks, rate, plain = seen["torch"]
    assert got == ref and fallbacks >= 2 and plain > 0
    assert rate is not None and rate < 0.6


def test_spec_reearns_after_the_cooldown(monkeypatch):
    """A fallen-back slot sits out its cooldown (16 eligible rounds), then
    speculates again with a fresh window (``spec.reearns``), and falls
    back again — the plain stream throughout, and the JAX server's
    fallback and re-earn counts."""
    monkeypatch.setenv("PADDLE_TPU_SPEC_MIN_ACCEPT", "0.6")
    model = _pair(0)
    prompts = _prompts(8, 1, 5)
    ref = _serve("torch", model, prompts, max_new=40, max_batch=1,
                 max_len=64)
    seen = {}
    for pkg in ("jax", "torch"):
        before = _snap(pkg)
        got = _serve(pkg, model, prompts, max_new=40, draft=_biased(model),
                     max_batch=1, max_len=64, spec_k=4)
        d = _diff(pkg, before)
        seen[pkg] = (got, d.get("spec.fallbacks", 0),
                     d.get("spec.reearns", 0))
    assert seen["torch"] == seen["jax"]
    got, fallbacks, reearns = seen["torch"]
    assert got == ref and reearns >= 1 and fallbacks >= 2


def test_spec_counters_and_accept_gauge():
    """The spec.* and serving.* counters one serve adds are the JAX
    server's, key for key; draft == target accepts everything and the
    gauge reads 1.0."""
    model = _pair(0)
    seen = {}
    for pkg in ("jax", "torch"):
        before = _snap(pkg)
        got = _serve(pkg, model, [[3, 5, 7, 9]], max_batch=1, max_len=48,
                     draft="self", spec_k=4)
        seen[pkg] = (got, {k: v for k, v in _diff(pkg, before).items()
                           if not k.startswith("serving.admitting")})
    assert seen["torch"] == seen["jax"]
    got, d = seen["torch"]
    assert len(got[0]) == 8
    assert d["spec.proposed"] >= 3 and d["spec.accepted"] == \
        d["spec.proposed"]
    assert tl.snapshot()["gauges"]["serving.spec_accept_rate"] == 1.0


def test_spec_oom_evicts_speculating_slot(markov):
    """Two tick OOMs on a speculating server: the ladder evicts
    speculating slots (their draft rows with them) and the carried
    re-admission feeds exactly — the clean tokens, and the JAX server's
    tokens and resilience counters."""
    prompts = _prompts(4, 3, 5, hi=13)
    clean = _serve("torch", markov, prompts, max_new=6, max_batch=4,
                   max_len=32)
    seen = {}
    for pkg, f in (("jax", jfaults), ("torch", faults)):
        before = _snap(pkg)
        f.install("oom:tick:2,oom:tick:3")
        try:
            srv = _server(pkg, markov, "self", max_batch=4, max_len=32,
                          spec_k=3)
            rids = [srv.submit(p, max_new_tokens=6, priority=pr)
                    for p, pr in zip(prompts, (2, 1, 0))]
            while srv.pending():
                srv.tick()
            out = [[int(t) for t in srv.result(r)] for r in rids]
            srv.close()
        finally:
            f.reset()
        d = _diff(pkg, before)
        seen[pkg] = (out, {k: v for k, v in d.items()
                           if k.startswith("resilience.")})
    assert seen["torch"] == seen["jax"]
    out, d = seen["torch"]
    assert out == clean
    assert d["resilience.oom_evictions"] >= 1
    assert d["resilience.oom_retries"] >= 1


def test_spec_nan_verify_logits_fail_cleanly():
    """``nan:logits:2``: check 1 is the admission's logits (clean), check 2
    the first verify round's — the poisoned request fails with the
    ``error`` status and a later request decodes, as in the JAX server."""
    model = _pair(3)
    seen = {}
    for pkg, f in (("jax", jfaults), ("torch", faults)):
        before = _snap(pkg)
        f.install("nan:logits:2")
        srv = _server(pkg, model, "self", max_batch=2, max_len=48, spec_k=4)
        bad = srv.submit([1, 2, 3], max_new_tokens=6)
        while srv.pending():
            srv.tick()
        status = srv.status(bad)
        f.reset()
        ok = _drive(srv, [[7, 8]], 5)
        srv.close()
        d = _diff(pkg, before)
        seen[pkg] = (status, ok, d.get("resilience.nan_requests", 0))
    assert seen["torch"] == seen["jax"]
    assert seen["torch"][0] == "error" and seen["torch"][2] == 1


def test_spec_k_in_decode_jit_key(monkeypatch):
    base = flags.decode_jit_key()
    monkeypatch.setenv("PADDLE_TPU_SPEC_K", "6")
    assert flags.decode_jit_key() != base
    assert flags.spec_k() == 6
    model = _pair(0)
    srv = _server("torch", model, max_batch=1, max_len=32)
    assert srv._spec_k == 6 and srv._self_draft
    srv.close()


def test_spec_verify_build_recorded():
    model = _pair(0)
    n0 = len(tl.compile_log())
    _serve("torch", model, [[1, 2, 3]], max_batch=1, max_len=48,
           draft="self", spec_k=5)
    names = [c["name"] for c in tl.compile_log()[n0:]]
    assert "serving.spec_verify@5" in names
    assert "serving.block@4" in names          # the draft's proposals


def test_spec_rejects_bad_args():
    model = _pair(0)
    other = _pair(1, vocab_size=16)
    short = _pair(1, max_seq_len=24)
    cases = [
        (ValueError, dict(spec_k=0, draft="self")),      # draft without K
        (ValueError, dict(spec_k=-1)),
        (ValueError, dict(spec_k=32)),                   # K must fit
        (ValueError, dict(spec_k=2, draft=other)),       # vocab differs
        (ValueError, dict(spec_k=2, draft=short)),       # window uncovered
        (ValueError, dict(spec_k=2, spec_tree=4)),       # one round shape
    ]
    for exc, kw in cases:
        with pytest.raises(exc):
            _server("torch", model, max_batch=1, max_len=32, **kw)
    _, _, cfg, params = model
    with pytest.raises(ValueError, match="draft_params"):
        serving.DecodeServer(params, cfg, max_batch=1, max_len=32,
                             device="cpu", spec_k=2, draft_cfg=cfg)


@pytest.mark.parametrize("seq,k,kw,want", [
    ([4, 5, 6, 7, 8, 5, 6], 2, {}, [7, 8]),          # copies the follow-on
    ([9, 1, 2, 7, 1, 2], 4, {}, [7, 1, 2, 2]),       # a short hit is padded
    ([1, 2, 3, 4, 5], 3, {}, None),                  # no earlier match
    ([7], 3, {}, None),
    ([1, 2] + [9] * 300 + [1, 2], 2, dict(window=64), None),
    ([1, 2] + [9] * 300 + [1, 2], 2, dict(window=512), [9, 9])],
    ids=["copy", "pad", "miss", "short", "window64", "window512"])
def test_ngram_propose(seq, k, kw, want):
    assert G.ngram_propose(seq, k, **kw) == want
    assert G.ngram_propose(seq, k, **kw) == JG.ngram_propose(seq, k, **kw)
