"""Tree speculation in the port's server (paddle_tpu_torch/text/serving.py
``DecodeServer(spec_tree=N)``, the Engine's ``spec_tree_verify`` and
``spec_tree_commit`` kinds) against the JAX tree server, on the CPU —
the cases of ``tests/test_spec_tree.py``:

* greedy: a tree server's streams equal the plain server's and the JAX
  tree server's token for token, with the ``spec.*`` / ``serving.*``
  counters each package added across the serve, the target passes and
  ``load_stats()``'s ``spec_tree_accept_len`` and ``spec_accept_rate``
  equal to JAX's — draft == target, a biased draft whose trunk is wrong
  (so acceptance takes sibling branches and the row permute runs), a
  smaller distinct draft, and n-gram tries, both layouts; ``tick_block``
  and async dispatch serve the same streams;
* sampled: the second token of a request served next to a stranger
  through tree rounds follows the target's exact two-step law
  (chi-square), with a draft and self-drafting — held by law, as the
  port's host streams are not ``jax.random``'s;
* the acceptance fallback counted in path lengths and the re-earn, an
  OOM evicting speculating slots, the NaN guard over a round's logits
  (each against the JAX server's tokens and counters), the window's edge,
  a warmed server building nothing while it serves, the accept-length
  gauge, ``PADDLE_TPU_SPEC_TREE`` read, validated and keyed, and the
  constructor's refusals;
* constrained slots keep speculating through pruned trees: greedy streams
  equal to the plain constrained server's and the JAX tree server's,
  banned branches pruned (``spec.tree_pruned_constrained``), sampled
  streams inside the language, ``constraint.spec_fallbacks`` at 0.

The JAX tree servers run once per configuration, in a module fixture.
Models are the reference suite's random one (vocab 32, 2 layers) in fp32
in both packages.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu import faults as jfaults
from paddle_tpu import flags as jflags
from paddle_tpu.framework import monitor
from paddle_tpu.text import gpt as jgpt
from paddle_tpu.text import serving as jserving
from paddle_tpu_torch import convert, faults, flags
from paddle_tpu_torch import telemetry as tl
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


def _biased(model, row=20):
    """A draft whose argmax is one constant token (the final LN bias
    pushed toward an embedding row): its trunk is wrong nearly
    everywhere, while its second choice still follows the model."""
    jcfg, jp, cfg, _ = model
    jbad = dict(jp)
    jbad["ln_f_b"] = jp["ln_f_b"] + 50.0 * jp["wte"][row]
    return jcfg, jbad, cfg, convert.params_from_jax(jbad)


@functools.lru_cache(maxsize=None)
def _models():
    """The target and the drafters — itself, the biased one, a smaller
    distinct model; n-gram drafts with none — made once, at first use."""
    model = _pair(0)
    return model, {"self": model, "biased": _biased(model),
                   "small": _pair(7, hidden_size=16, num_layers=1,
                                  num_heads=2),
                   "ngram": None}


def _target():
    return _models()[0]


def _drafts():
    return _models()[1]


PROMPTS = [[5, 9, 5, 9, 5, 9], [7, 3, 9, 7, 3, 5, 7, 3],
           [int(x) for x in np.random.default_rng(1).integers(1, 30, 5)]]


def _server(pkg, model, draft=None, **kw):
    jcfg, jp, cfg, params = model
    if draft is not None:
        kw.update(draft_cfg=draft[0] if pkg == "jax" else draft[2],
                  draft_params=draft[1] if pkg == "jax" else draft[3])
    if pkg == "jax":
        return jserving.DecodeServer(jp, jcfg, **kw)
    return serving.DecodeServer(params, cfg, device="cpu", **kw)


def _snap(pkg) -> dict:
    got = monitor.stats() if pkg == "jax" else tl.counters()
    return {k: int(v) for k, v in got.items()
            if k.startswith(("spec.", "serving.", "resilience."))
            and not k.startswith("serving.admitting")}


def _run(pkg, model, prompts, max_new=8, draft=None, way="tick",
         priorities=None, **kw):
    """One serve: (streams, counters it added, load stats, target passes,
    requests' statuses)."""
    before = _snap(pkg)
    srv = _server(pkg, model, draft, async_dispatch=way == "async", **kw)
    rids = [srv.submit(p, max_new_tokens=max_new,
                       **({} if priorities is None
                          else dict(priority=priorities[i])))
            for i, p in enumerate(prompts)]
    for _ in range(500):
        if not srv.pending():
            break
        srv.tick_block(4) if way == "block4" else srv.tick()
    assert not srv.pending()
    status = [srv.status(r) for r in rids]
    out = [[int(t) for t in srv.result(r)] if s == "ok" else None
           for r, s in zip(rids, status)]
    stats = srv.load_stats()
    passes = (srv._spec_rounds + srv._spec_plain_steps if srv._spec_on
              else srv._step_no)
    srv.close()
    now = _snap(pkg)
    d = {k: v - before.get(k, 0) for k, v in now.items()
         if v != before.get(k, 0)}
    return out, d, (stats["spec_tree_accept_len"],
                    stats["spec_accept_rate"]), passes, status


def _layout(layout):
    kw = dict(max_batch=2, max_len=48, layout=layout)
    if layout == "paged":
        kw["block_size"] = 8
    return kw


CASES = [("contiguous", "self"), ("paged", "self"),
         ("contiguous", "biased"), ("paged", "biased"),
         ("contiguous", "small"), ("contiguous", "ngram"),
         ("paged", "ngram")]


@pytest.fixture(scope="module")
def jax_tree():
    """The JAX tree server's serve of PROMPTS for each of CASES (N = 4,
    N = 5 for n-gram tries), by tick."""
    return {case: _run("jax", _target(), PROMPTS,
                       draft=_drafts()[case[1]],
                       spec_tree=5 if case[1] == "ngram" else 4,
                       **_layout(case[0]))
            for case in CASES}


@pytest.fixture(scope="module")
def plain():
    return {lay: _run("torch", _target(), PROMPTS, **_layout(lay))[0]
            for lay in ("contiguous", "paged")}


# ---------------------------------------------------------------------------
# greedy: tree server == plain server == the JAX tree server
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout,drafting", CASES,
                         ids=[f"{a}-{b}" for a, b in CASES])
def test_tree_greedy_matches_jax_and_plain(layout, drafting, jax_tree,
                                           plain):
    """Streams, the counters the serve added, the target passes, the mean
    accepted path length and the accept rate: the JAX tree server's; the
    streams are the plain server's."""
    got = _run("torch", _target(), PROMPTS, draft=_drafts()[drafting],
               spec_tree=5 if drafting == "ngram" else 4,
               **_layout(layout))
    want = jax_tree[layout, drafting]
    assert got[0] == plain[layout]
    assert got[:4] == want[:4]
    d = got[1]
    assert d["spec.tree_rounds"] > 0 and d["spec.tree_nodes_proposed"] > 0
    if drafting == "self":
        # two trunk steps a round, each accepted: the mean path is 2
        assert got[2][0] == 2.0 and "spec.fallbacks" not in d
    if drafting == "biased":
        assert 0 < got[2][0] < 1.5     # sibling branches took tokens


WAYS = [("contiguous", "self", "block4"), ("paged", "biased", "block4"),
        ("contiguous", "biased", "async"), ("paged", "ngram", "async")]


@pytest.mark.parametrize("layout,drafting,way", WAYS,
                         ids=["-".join(w) for w in WAYS])
def test_tree_dispatch_ways_serve_the_same_streams(layout, drafting, way,
                                                   jax_tree, plain):
    """``tick_block`` (ceil(block / N) rounds a call) and async dispatch
    (the step in flight drained, then a synchronous round) serve the
    plain and the JAX tree server's streams."""
    got = _run("torch", _target(), PROMPTS, draft=_drafts()[drafting], way=way,
               spec_tree=5 if drafting == "ngram" else 4, **_layout(layout))
    assert got[0] == plain[layout] == jax_tree[layout, drafting][0]
    assert got[1]["spec.tree_rounds"] > 0


def test_tree_kv_int8_both_layouts(monkeypatch):
    """int8 KV: the tree verify writes and the permute moves the quantized
    rows and their scales — the tree server serves the plain int8
    streams on both layouts (a biased draft, so rows move)."""
    monkeypatch.setenv("PADDLE_TPU_KV_DTYPE", "int8")
    for layout in ("contiguous", "paged"):
        ref = _run("torch", _target(), PROMPTS, **_layout(layout))[0]
        got = _run("torch", _target(), PROMPTS, draft=_drafts()["biased"],
                   spec_tree=4, **_layout(layout))
        assert got[0] == ref, layout
        assert got[1]["spec.tree_nodes_accepted"] > 0


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_tree_slot_at_window_edge(layout):
    """A request filling the window (20 + 12 = 32 rows): near its end a
    round of N = 5 would write past the slot's rows, so the server runs
    plain ticks there — the plain streams."""
    prompts = [[int(x) for x in np.random.default_rng(7).integers(1, 30,
                                                                  20)],
               PROMPTS[2]]
    kw = dict(max_batch=2, max_len=32, layout=layout)
    if layout == "paged":
        kw["block_size"] = 8
    ref = _run("torch", _target(), prompts, max_new=12, **kw)[0]
    got = _run("torch", _target(), prompts, max_new=12,
               draft=_drafts()["self"], spec_tree=5, **kw)
    assert got[0] == ref
    assert got[1]["spec.tree_rounds"] > 0


# ---------------------------------------------------------------------------
# sampling: the token law is the target's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("drafting", ["draft", "self_draft"])
def test_tree_sampled_follows_target_law(drafting):
    """Chi-square at batch > 1: token #2 of a sampled request served next
    to a stranger through tree rounds follows the target's two-step law —
    per-node multi-candidate rejection with siblings drawn without
    replacement (draft == target), or point-mass trie nodes
    (self-drafting)."""
    model = _pair(9, vocab_size=12, max_seq_len=16)
    _, _, cfg, params = model
    n = 200
    if drafting == "draft":
        prompt, temp, stranger, draft = [4, 7], 1.3, [2, 9, 1], model
    else:
        prompt, temp, stranger, draft = [4, 7, 4, 7], 1.1, None, None
    law = _second_token_law(params, cfg, prompt, temp, 0, 1.0)
    srv = _server("torch", model, draft, seed=77, max_batch=4, max_len=16,
                  spec_tree=3)
    rids = []
    for _ in range(n):
        rids.append(srv.submit(prompt, max_new_tokens=2,
                               temperature=temp))
        if stranger is not None:
            srv.submit(stranger, max_new_tokens=2, temperature=temp)
    while srv.pending():
        srv.tick()
    counts = np.bincount([srv.result(r)[1] for r in rids],
                         minlength=12).astype(float)
    assert srv.stats()["spec.tree_rounds"] > 0
    srv.close()
    stat, df = _chi2(counts, law, n)
    assert stat < 3 * max(df, 1) + 10, stat


# ---------------------------------------------------------------------------
# fallback, pressure, the NaN guard, warmup, telemetry, flags, refusals
# ---------------------------------------------------------------------------


def test_tree_fallback_then_reearn(monkeypatch):
    """A biased draft trips the fallback (accepted path length over the
    trees' depth below PADDLE_TPU_SPEC_MIN_ACCEPT), the slot decodes
    plain, re-earns after its cooldown and falls back again — the plain
    streams, and the JAX server's streams, fallbacks and re-earns."""
    monkeypatch.setenv("PADDLE_TPU_SPEC_MIN_ACCEPT", "0.9")
    kw = dict(max_batch=2, max_len=64)
    prompts = PROMPTS[:1]
    ref = _run("torch", _target(), prompts, max_new=40, **kw)[0]
    seen = {pkg: _run(pkg, _target(), prompts, max_new=40,
                      draft=_drafts()["biased"], spec_tree=4, **kw)
            for pkg in ("jax", "torch")}
    assert seen["torch"][0] == ref
    for pkg in ("jax", "torch"):
        seen[pkg] = (seen[pkg][0], seen[pkg][1].get("spec.fallbacks", 0),
                     seen[pkg][1].get("spec.reearns", 0), seen[pkg][3])
    assert seen["torch"] == seen["jax"]
    assert seen["torch"][1] >= 2 and seen["torch"][2] >= 1


def test_tree_oom_evicts_speculating_slot():
    """Two tick OOMs on a tree-speculating server: the ladder evicts
    speculating slots (their draft rows with them) and the carried
    re-admission feeds exactly — the clean streams, and the JAX server's
    streams and ``resilience.*`` counters."""
    kw = dict(max_batch=4, max_len=32)
    clean = _run("torch", _target(), PROMPTS, max_new=6, **kw)[0]
    seen = {}
    for pkg, f in (("jax", jfaults), ("torch", faults)):
        f.install("oom:tick:2,oom:tick:3")
        try:
            out, d, *_ = _run(pkg, _target(), PROMPTS, max_new=6,
                              draft=_drafts()["self"], spec_tree=4,
                              priorities=(2, 1, 0), **kw)
        finally:
            f.reset()
        seen[pkg] = (out, {k: v for k, v in d.items()
                           if k.startswith("resilience.")})
    assert seen["torch"] == seen["jax"]
    out, d = seen["torch"]
    assert out == clean
    assert d["resilience.oom_evictions"] >= 1
    assert d["resilience.oom_retries"] >= 1


def test_tree_nan_verify_logits_fail_cleanly():
    """``nan:logits:2``: check 1 is the admission's logits, check 2 the
    first tree round's — the poisoned request fails with the ``error``
    status while the other finishes, as in the JAX server."""
    seen = {}
    for pkg, f in (("jax", jfaults), ("torch", faults)):
        f.install("nan:logits:2")
        try:
            out, d, _, _, status = _run(pkg, _target(), PROMPTS[:1] + [[7, 8]],
                                        max_new=6, draft=_drafts()["self"],
                                        spec_tree=4, max_batch=1,
                                        max_len=48)
        finally:
            f.reset()
        seen[pkg] = (out, status, d.get("resilience.nan_requests", 0))
    assert seen["torch"] == seen["jax"]
    assert seen["torch"][1] == ["error", "ok"] and seen["torch"][2] == 1


def test_tree_warmed_server_builds_nothing_while_serving():
    """warmup() builds the tree verify and the permute at N (and the
    draft's step and admission steps); a serve whose rounds take sibling
    branches then builds nothing — topology is a feed, not a key — and
    serves the plain streams."""
    kw = _layout("contiguous")
    ref = _run("torch", _target(), PROMPTS, **kw)[0]
    srv = _server("torch", _target(), _drafts()["biased"], spec_tree=4, **kw)
    warmed = srv.warmup()
    assert {"spec_tree_verify@4", "spec_tree_commit@4",
            "draft_step"} <= set(warmed)
    assert "spec_verify@0" not in warmed and "draft_block3" not in warmed
    n_builds = len(tl.compile_log())
    rids = [srv.submit(p, max_new_tokens=8) for p in PROMPTS]
    while srv.pending():
        srv.tick()
    assert [[int(t) for t in srv.result(r)] for r in rids] == ref
    assert srv.stats()["spec.tree_nodes_accepted"] > 0
    assert len(tl.compile_log()) == n_builds
    srv.close()


def test_tree_accept_len_gauge():
    """The mean accepted path length lands in ``load_stats`` and the
    ``serving.spec_tree_accept_len`` gauge (draft == target: 2.0)."""
    out, _, (accept_len, rate), _, _ = _run(
        "torch", _target(), [[3, 5, 7, 9]], max_batch=1, max_len=48,
        draft=_drafts()["self"], spec_tree=4)
    assert len(out[0]) == 8 and accept_len == 2.0 and rate == 1.0
    assert tl.snapshot()["gauges"]["serving.spec_tree_accept_len"] == 2.0


def test_spec_tree_flag(monkeypatch):
    """``PADDLE_TPU_SPEC_TREE`` is read, validated and keyed as in the
    reference, and turns a server built without ``spec_tree=`` into a tree
    server even with ``PADDLE_TPU_SPEC_K`` set; ``PADDLE_TPU_SPEC_BRANCH``
    shapes proposals only."""
    base = flags.decode_jit_key()
    monkeypatch.setenv("PADDLE_TPU_SPEC_TREE", "6")
    assert flags.decode_jit_key() != base
    assert flags.spec_tree() == jflags.spec_tree() == 6
    monkeypatch.setenv("PADDLE_TPU_SPEC_BRANCH", "3")
    key = flags.decode_jit_key()
    assert flags.spec_branch() == jflags.spec_branch() == 3
    monkeypatch.setenv("PADDLE_TPU_SPEC_BRANCH", "x")
    assert flags.spec_branch() == jflags.spec_branch() == 2
    assert flags.decode_jit_key() == key
    monkeypatch.setenv("PADDLE_TPU_SPEC_K", "3")
    srv = _server("torch", _target(), max_batch=1, max_len=32)
    assert (srv._spec_tree_n, srv._spec_k, srv._self_draft) == (6, 0, True)
    srv.close()
    for bad in ("1", "-2", "x"):
        monkeypatch.setenv("PADDLE_TPU_SPEC_TREE", bad)
        for fn in (flags.spec_tree, jflags.spec_tree):
            with pytest.raises(ValueError):
                fn()


def test_tree_rejects_bad_construction():
    """The reference's refusals (its adapter-pool case is in
    test_torch_adapters.py): tree and linear K together, a 1-node tree, a
    tree past the window, a negative budget — each a ValueError in both
    packages."""
    cases = [dict(spec_tree=4, spec_k=4), dict(spec_tree=1),
             dict(spec_tree=16, max_len=16), dict(spec_tree=-1),
             dict(spec_tree=4, spec_k=2, draft=_drafts()["self"])]
    for kw in cases:
        kw = dict(kw)
        draft = kw.pop("draft", None)
        kw.setdefault("max_len", 48)
        for pkg in ("jax", "torch"):
            with pytest.raises(ValueError):
                _server(pkg, _target(), draft, max_batch=1, **kw)
    # a draft model with spec_k=0 opts into the tree
    srv = _server("torch", _target(), _drafts()["self"], max_batch=1,
                  max_len=48, spec_tree=4, spec_k=0)
    assert srv._spec_tree_n == 4 and srv.draft_cfg is not None
    srv.close()


# ---------------------------------------------------------------------------
# constrained slots: pruned trees instead of the fallback
# ---------------------------------------------------------------------------


def _constrained(pkg, model, prompts, allowed, draft=None, max_new=8,
                 temperature=0.0, **kw):
    """One constrained serve: (streams, counters it added)."""
    before = {**_snap(pkg), **_ckeys(pkg)}
    srv = _server(pkg, model, draft, max_len=48, **kw)
    rids = [srv.submit(p, max_new_tokens=max_new, temperature=temperature,
                       constraint=allowed) for p in prompts]
    while srv.pending():
        srv.tick()
    out = [[int(t) for t in srv.result(r)] for r in rids]
    srv.close()
    now = {**_snap(pkg), **_ckeys(pkg)}
    return out, {k: v - before.get(k, 0) for k, v in now.items()
                 if v != before.get(k, 0)}


def _ckeys(pkg):
    got = monitor.stats() if pkg == "jax" else tl.counters()
    return {k: int(v) for k, v in got.items() if k.startswith("constraint.")}


def test_tree_constrained_parity_and_zero_fallbacks():
    """Constrained slots speculate in tree mode: greedy streams equal to
    the plain constrained server's and the JAX tree server's, tree rounds
    run, and ``constraint.spec_fallbacks`` does not move."""
    model = _pair(3)
    allowed = [2, 5, 9, 11, 17, 23]
    prompts = [[5, 9, 5, 9, 5, 9], [int(x) for x in
               np.random.default_rng(5).integers(1, 30, 6)]]
    ref, _ = _constrained("torch", model, prompts, allowed, max_batch=2)
    got, d = _constrained("torch", model, prompts, allowed, draft=model,
                          spec_tree=4, max_batch=2)
    jgot, jd = _constrained("jax", model, prompts, allowed, draft=model,
                            spec_tree=4, max_batch=2)
    assert got == ref == jgot
    assert all(t in allowed for toks in got for t in toks)
    assert d.get("spec.tree_rounds", 0) > 0
    assert d.get("constraint.spec_fallbacks", 0) == 0
    assert d.get("spec.tree_rounds") == jd.get("spec.tree_rounds")


def test_tree_constrained_prunes_forbidden_branches():
    """A draft whose argmax is the banned token 20: the lookahead prunes
    those branches before the verify (the pruned counter moves as JAX's),
    with no fallback and the plain constrained streams."""
    model = _pair(4)
    allowed = [3, 6, 12, 19, 25]
    bad = _biased(model)
    prompts = [[int(x) for x in np.random.default_rng(6).integers(1, 30, 5)]]
    ref, _ = _constrained("torch", model, prompts, allowed, max_new=6,
                          max_batch=1)
    got, d = _constrained("torch", model, prompts, allowed, draft=bad,
                          max_new=6, spec_tree=4, max_batch=1)
    jgot, jd = _constrained("jax", model, prompts, allowed, draft=bad,
                            max_new=6, spec_tree=4, max_batch=1)
    assert got == ref == jgot
    assert d.get("spec.tree_pruned_constrained", 0) > 0
    assert d.get("spec.tree_pruned_constrained") == \
        jd.get("spec.tree_pruned_constrained")
    assert d.get("constraint.spec_fallbacks", 0) == 0


def test_tree_constrained_sampled_stays_in_language():
    """Sampled constrained tree serving: every token inside the allowed
    set, no fallback."""
    model = _pair(5)
    allowed = [2, 5, 9, 11, 17]
    got, d = _constrained("torch", model, [[4, 7, 4, 7]] * 3, allowed,
                          draft=model, temperature=1.2, spec_tree=4,
                          max_batch=2, seed=7)
    assert all(t in allowed for toks in got for t in toks)
    assert all(len(toks) == 8 for toks in got)
    assert d.get("spec.tree_rounds", 0) > 0
    assert d.get("constraint.spec_fallbacks", 0) == 0
