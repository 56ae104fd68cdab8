"""Multi-tenant adapter serving in the port (paddle_tpu_torch/text/
adapters.py, the ``adapter_*`` / ``masked_step`` Engine kinds and
``DecodeServer(adapter_pool=)`` / ``submit(adapter=, constraint=)``)
against the JAX package's, on the CPU, in fp32 (the reference suite's
model: vocab 32, 2 layers, weights and adapters carried from JAX):

* the pool: registration, ids, shapes, capacity, tenancy and its
  refusals, in the JAX pool's words; the server's refusals (MoE, another
  config, pre-adapted params, ``spec_tree``) in the JAX server's;
* the adapter steps' logits with mixed ids (0, 1, 2) — decode, verify and
  admission, contiguous and paged — within 1e-5 of the JAX steps' (the
  port adds the per-slot rank-r term to the base product, JAX merges the
  slot's weight: the same function, re-associated);
* id-0 traffic under a pool equal to the pool-less server's streams and
  logits, on both layouts, by tick, block, async and budgeted admission;
* a {base, a, b} batch equal to each adapter's merged solo decode and to
  JAX's served streams, both layouts, every tick mode; the tenant default;
* constraints: a token set (greedy), the admission token masked (sampled),
  the sampled law over the allowed set (chi-square), JSON-schema streams
  that parse (greedy streams JAX's), linear speculation's counted
  fallback, adapter x constraint against the masked merged reference;
* a warmed server serving mixed traffic builds nothing (the warm names
  a subset of JAX's), a register after warmup changes the next streams
  without a build, an injected OOM's requeue keeps adapter and
  constraint, and ``load_stats`` / the telemetry counters and gauges.
"""
import functools
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu import faults as jfaults
from paddle_tpu.text import adapters as JA
from paddle_tpu.text import generate as jG
from paddle_tpu.text import gpt as jgpt
from paddle_tpu.text import lora as jlora
from paddle_tpu.text import moe as jmoe
from paddle_tpu.text import serving as jserving
from paddle_tpu_torch import convert, faults
from paddle_tpu_torch import telemetry as tl
from paddle_tpu_torch.text import adapters as A
from paddle_tpu_torch.text import engine
from paddle_tpu_torch.text import generate as G
from paddle_tpu_torch.text import lora, serving

from test_torch_speculative import _chi2

TOL = 1e-5
# char-level vocab for the automaton constraints: token i's decoded text
VOCAB = list('{}":,truefalsokgb0123456789-') + ["?", "!", "#", "~"]
SCHEMA = {"type": "object", "properties": {"ok": {"type": "boolean"},
                                            "tag": {"enum": ["a", "b"]}}}


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


def _pair(seed=0, **over):
    kw = dict(vocab_size=32, hidden_size=32, num_layers=2, num_heads=4,
              max_seq_len=64, dtype=jnp.float32)
    kw.update(over)
    jcfg = jgpt.GPTConfig(**kw)
    jp = jax.device_get(jgpt.init_params(jcfg, jax.random.PRNGKey(seed)))
    return jcfg, jp, convert.config_from_jax(jcfg), \
        convert.params_from_jax(jp)


def _jad(jp, jcfg, seed, rank=4, scale=0.3):
    """A JAX adapter sub-tree whose ``b`` is drawn (numpy), so it bites."""
    ad = jax.device_get(jlora.split_lora(jlora.lora_init(
        jp, jcfg, rank=rank, key=jax.random.PRNGKey(seed)))[1])
    rng = np.random.default_rng(seed)
    return {k: (scale * rng.standard_normal(v.shape).astype(np.float32)
                if k.endswith("_lora_b") else np.asarray(v))
            for k, v in ad.items()}


@functools.lru_cache(maxsize=None)
def _model():
    jcfg, jp, cfg, params = _pair(0)
    ads = {"prod-a": _jad(jp, jcfg, 1), "prod-b": _jad(jp, jcfg, 2)}
    return jcfg, jp, cfg, params, ads


def _pools(names=("prod-a", "prod-b"), max_adapters=2):
    jcfg, jp, cfg, params, ads = _model()
    jpool = JA.AdapterPool(jp, jcfg, rank=4, max_adapters=max_adapters)
    pool = A.AdapterPool(params, cfg, rank=4, max_adapters=max_adapters)
    for n in names:
        assert jpool.register(n, ads[n]) == pool.register(
            n, convert.params_from_jax(ads[n]))
    return jpool, pool


def _server(pkg, pool=None, **kw):
    jcfg, jp, cfg, params, _ = _model()
    if pkg == "jax":
        return jserving.DecodeServer(jp, jcfg, adapter_pool=pool, **kw)
    return serving.DecodeServer(params, cfg, device="cpu", adapter_pool=pool,
                                **kw)


def _serve(pkg, jobs, max_new=8, way="tick", pool=None, **kw):
    """jobs: [(prompt, submit kwargs)] -> the streams (and the server,
    closed)."""
    srv = _server(pkg, pool, async_dispatch=way == "async", **kw)
    rids = [srv.submit(p, max_new_tokens=max_new, **skw) for p, skw in jobs]
    for _ in range(400):
        if not srv.pending():
            break
        srv.tick_block(4) if way == "block" else srv.tick()
    assert not srv.pending()
    out = [[int(t) for t in srv.result(r)] for r in rids]
    srv.close()
    return out, srv


def _layout(layout, **kw):
    kw = dict(max_batch=3, max_len=48, layout=layout, **kw)
    if layout == "paged":
        kw["block_size"] = 8
    return kw


def _greedy_ref(params, cfg, prompt, max_new, allowed=None):
    """Solo greedy decode through ``generate.decode_step`` (the argmax
    restricted to ``allowed`` when given)."""
    cache = G.init_cache(cfg, 1, cfg.max_seq_len, "cpu")
    out, tok = [], None
    for pos in range(len(prompt) + max_new - 1):
        cur = prompt[pos] if pos < len(prompt) else tok
        l, cache = G.decode_step(params, cache, torch.tensor([cur]), pos, cfg)
        if pos >= len(prompt) - 1:
            row = l[0].clone()
            if allowed is not None:
                ban = torch.ones_like(row, dtype=torch.bool)
                ban[allowed] = False
                row[ban] = A.NEG_INF
            tok = int(row.argmax())
            out.append(tok)
    return out


PROMPTS = [[1, 5, 7, 3, 2], [4, 8, 9, 1], [6, 6, 2, 3, 4, 5]]
MIXED = [(PROMPTS[0], {}), (PROMPTS[1], {"adapter": "prod-a"}),
         (PROMPTS[2], {"adapter": "prod-b"})]


# ---------------------------------------------------------------------------
# the pool and the refusals
# ---------------------------------------------------------------------------


def _same_error(fn, jfn, exc=ValueError):
    with pytest.raises(exc) as mine:
        fn()
    with pytest.raises(exc) as theirs:
        jfn()
    assert str(mine.value) == str(theirs.value)


def test_pool_registry_matches_jax():
    jcfg, jp, cfg, params, ads = _model()
    jpool, pool = _pools(("prod-a",))
    assert pool.pool_key() == jpool.pool_key() == \
        ("adapters", 3, 4, ("qkv_w", "proj_w"))
    for k, s in pool.stacks().items():
        js = np.asarray(jpool.stacks()[k])
        assert s.shape == js.shape and s.dtype == torch.float32
        np.testing.assert_array_equal(s.numpy(), js)
        assert not s[0].any() and not s[2].any()
    assert pool.resolve("prod-a") == 1 and pool.resolve(None) == 0
    assert pool.name_of(1) == "prod-a" and pool.name_of(0) == "base"
    _same_error(lambda: pool.resolve("nope"), lambda: jpool.resolve("nope"))
    a8 = _jad(jp, jcfg, 9, rank=8)
    _same_error(lambda: pool.register("r8", convert.params_from_jax(a8)),
                lambda: jpool.register("r8", a8))
    short = {k: v for k, v in ads["prod-a"].items()
             if not k.startswith("proj")}
    _same_error(lambda: pool.register("s", convert.params_from_jax(short)),
                lambda: jpool.register("s", short))
    _same_error(lambda: pool.register("", ads["prod-a"]),
                lambda: jpool.register("", ads["prod-a"]))
    # a full adapted tree registers too; re-registering keeps the row
    tree = lora.join_lora(params, convert.params_from_jax(ads["prod-b"]))
    assert pool.register("prod-b", tree) == 2
    assert pool.register("prod-a", convert.params_from_jax(
        ads["prod-b"])) == 1
    assert torch.equal(pool.stacks()["qkv_w_lora_b"][1],
                       pool.stacks()["qkv_w_lora_b"][2])
    jpool.register("prod-b", ads["prod-b"])
    _same_error(lambda: pool.register("prod-c", ads["prod-a"]),
                lambda: jpool.register("prod-c", ads["prod-a"]))
    pool.set_tenant_default("acme", "prod-b")
    assert pool.default_for("acme") == "prod-b"
    assert pool.default_for("other") is None
    pool.set_tenant_default("acme", None)
    assert pool.default_for("acme") is None
    _same_error(lambda: pool.set_tenant_default("acme", "nope"),
                lambda: jpool.set_tenant_default("acme", "nope"))
    _same_error(lambda: A.AdapterPool(params, cfg, rank=0),
                lambda: JA.AdapterPool(jp, jcfg, rank=0))
    _same_error(lambda: A.AdapterPool(params, cfg, targets=("zz",)),
                lambda: JA.AdapterPool(jp, jcfg, targets=("zz",)))


def test_server_refusals_match_jax():
    jcfg, jp, cfg, params, ads = _model()
    jpool, pool = _pools(("prod-a",))
    ojcfg, ojp, ocfg, oparams = _pair(1, hidden_size=64, num_heads=8)
    jother = JA.AdapterPool(ojp, ojcfg, rank=4)
    other = A.AdapterPool(oparams, ocfg, rank=4)
    kw = dict(max_batch=1, max_len=16)
    _same_error(lambda: _server("torch", other, **kw),
                lambda: _server("jax", jother, **kw))
    pre = lora.join_lora(params, convert.params_from_jax(ads["prod-a"]))
    jpre = jlora.join_lora(jp, ads["prod-a"])
    _same_error(
        lambda: serving.DecodeServer(pre, cfg, device="cpu",
                                     adapter_pool=pool, **kw),
        lambda: jserving.DecodeServer(jpre, jcfg, adapter_pool=jpool, **kw))
    _same_error(
        lambda: serving.DecodeServer(params, cfg, device="cpu",
                                     adapter_pool=pool, spec_tree=4,
                                     draft_cfg=cfg, draft_params=params,
                                     max_batch=1, max_len=32),
        lambda: jserving.DecodeServer(jp, jcfg, adapter_pool=jpool,
                                      spec_tree=4, draft_cfg=jcfg,
                                      draft_params=jp, max_batch=1,
                                      max_len=32), NotImplementedError)
    mjcfg, mjp, mcfg, mparams = _pair(
        2, moe=jmoe.MoEConfig(num_experts=2, top_k=1))
    mjpool = JA.AdapterPool(mjp, mjcfg, rank=4)
    mpool = A.AdapterPool(mparams, mcfg, rank=4)
    _same_error(
        lambda: serving.DecodeServer(mparams, mcfg, device="cpu",
                                     adapter_pool=mpool, **kw),
        lambda: jserving.DecodeServer(mjp, mjcfg, adapter_pool=mjpool, **kw),
        NotImplementedError)
    msrv = serving.DecodeServer(mparams, mcfg, device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="MoE server"):
        msrv.submit([1, 2], max_new_tokens=2, constraint=[1, 2])
    msrv.close()
    plain, jplain = _server("torch", **kw), _server("jax", **kw)
    _same_error(lambda: plain.submit([1, 2], adapter="prod-a"),
                lambda: jplain.submit([1, 2], adapter="prod-a"))
    _same_error(lambda: plain.submit([1, 2], constraint=[]),
                lambda: jplain.submit([1, 2], constraint=[]))
    _same_error(lambda: plain.submit([1, 2], constraint=[99]),
                lambda: jplain.submit([1, 2], constraint=[99]))
    srv, jsrv = _server("torch", pool, **kw), _server("jax", jpool, **kw)
    _same_error(lambda: srv.submit([1, 2], adapter="nope"),
                lambda: jsrv.submit([1, 2], adapter="nope"))
    for s in (plain, srv, jplain, jsrv):
        s.close()


# ---------------------------------------------------------------------------
# the adapter steps against JAX's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_adapter_steps_match_jax(layout):
    """Admission of each slot under its adapter, four decode steps and a
    K = 3 verify with ids (0, 1, 2): logits within 1e-5 of JAX's; the
    prefill rows of id 0 bit-equal to the plain prefill's."""
    jcfg, jp, cfg, params, _ = _model()
    jpool, pool = _pools()
    st, jst = pool.stacks(), jpool.stacks()
    B, rng = 3, np.random.default_rng(4)
    kw = dict(layout="paged", block_size=8, num_blocks=18) \
        if layout == "paged" else {}
    tc = G.init_cache(cfg, B, 48, "cpu", **kw)
    jc = jG.init_cache(jcfg, B, 48, **kw)
    if layout == "paged":
        tables = np.full(tuple(tc["tables"].shape), -1, np.int32)
        perm = rng.permutation(18).astype(np.int32)
        tables[:, :6] = perm.reshape(3, 6)
        tc["tables"].copy_(torch.from_numpy(tables))
        jc = dict(jc, tables=jnp.asarray(tables))
        jpre = jax.jit(functools.partial(JA.adapter_paged_prefill_chunk,
                                         cfg=jcfg))
    else:
        jpre = jax.jit(functools.partial(JA.adapter_prefill_slot, cfg=jcfg))
    jstep = jax.jit(functools.partial(JA.adapter_decode_step_batched,
                                      cfg=jcfg))
    jver = jax.jit(functools.partial(JA.adapter_spec_verify_batched,
                                     cfg=jcfg))
    lens = [7, 5, 9]
    for slot in range(B):
        toks = np.zeros((1, 16), np.int32)
        toks[0, :lens[slot]] = rng.integers(0, 32, lens[slot])
        if layout == "paged":
            tl_, tc = A.adapter_paged_prefill_chunk(
                params, tc, st, slot, torch.from_numpy(toks), 0,
                lens[slot], slot, cfg)
            jl, jc = jpre(jp, jc, jst, jnp.asarray(slot), jnp.asarray(toks),
                          jnp.asarray(0), jnp.asarray(lens[slot]),
                          jnp.asarray(slot))
        else:
            tl_, tc = A.adapter_prefill_slot(
                params, tc, st, slot, torch.from_numpy(toks), lens[slot],
                slot, cfg)
            jl, jc = jpre(jp, jc, jst, jnp.asarray(slot), jnp.asarray(toks),
                          jnp.asarray(lens[slot]), jnp.asarray(slot))
        np.testing.assert_allclose(tl_.numpy(), np.asarray(jl), atol=TOL,
                                   rtol=0)
    ids = np.array([0, 1, 2])
    pos = np.array(lens, np.int32)
    for _ in range(4):
        tok = rng.integers(0, 32, B)
        tl_, tc = A.adapter_decode_step_batched(
            params, tc, st, torch.from_numpy(ids), torch.from_numpy(tok),
            torch.from_numpy(pos), cfg)
        jl, jc = jstep(jp, jc, jst, jnp.asarray(ids, jnp.int32),
                       jnp.asarray(tok, jnp.int32), jnp.asarray(pos))
        np.testing.assert_allclose(tl_.numpy(), np.asarray(jl), atol=TOL,
                                   rtol=0)
        pos = pos + 1
    toks = rng.integers(0, 32, (B, 3))
    tl_, tc = A.adapter_spec_verify_batched(
        params, tc, st, torch.from_numpy(ids), torch.from_numpy(toks),
        torch.from_numpy(pos), cfg)
    jl, jc = jver(jp, jc, jst, jnp.asarray(ids, jnp.int32),
                  jnp.asarray(toks, jnp.int32), jnp.asarray(pos))
    np.testing.assert_allclose(tl_.numpy(), np.asarray(jl), atol=TOL, rtol=0)
    # id 0 under the pool: the plain step's logits bit for bit
    plain = G.init_cache(cfg, B, 48, "cpu", **kw)
    adap = G.init_cache(cfg, B, 48, "cpu", **kw)
    if layout == "paged":
        plain["tables"].copy_(tc["tables"])
        adap["tables"].copy_(tc["tables"])
    tok = torch.tensor([3, 4, 5])
    p0 = torch.tensor([0, 0, 0], dtype=torch.int32)
    want, _ = serving.decode_step_batched(params, plain, tok, p0, cfg)
    got, _ = A.adapter_decode_step_batched(params, adap, st,
                                           torch.zeros(3, dtype=torch.long),
                                           tok, p0, cfg)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# served streams
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("way", ["tick", "block", "async", "budget"])
@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_id0_under_a_pool_equals_the_poolless_server(layout, way):
    """Base traffic under a pool: the pool-less server's streams."""
    _, pool = _pools()
    jobs = [(p, {}) for p in PROMPTS]
    kw = _layout(layout, prefill_budget=4 if way == "budget" else 0)
    way = "tick" if way == "budget" else way
    ref, _ = _serve("torch", jobs, way=way, **kw)
    got, _ = _serve("torch", jobs, way=way, pool=pool, **kw)
    assert got == ref


@functools.lru_cache(maxsize=None)
def _jax_mixed(layout):
    jpool, _ = _pools()
    return _serve("jax", MIXED, pool=jpool, **_layout(layout))[0]


@pytest.mark.parametrize("way", ["tick", "block", "async", "budget"])
@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_mixed_batch_matches_merged_solo_and_jax(layout, way):
    """{base, prod-a, prod-b} in one batch: each stream is its adapter's
    merged-tree solo decode and the JAX server's stream."""
    jcfg, jp, cfg, params, ads = _model()
    _, pool = _pools()
    kw = _layout(layout, prefill_budget=4 if way == "budget" else 0)
    got, srv = _serve("torch", MIXED, pool=pool,
                      way="tick" if way == "budget" else way, **kw)
    refs = [_greedy_ref(params, cfg, PROMPTS[0], 8)]
    for prompt, name in ((PROMPTS[1], "prod-a"), (PROMPTS[2], "prod-b")):
        merged = lora.merge_lora(lora.join_lora(
            params, convert.params_from_jax(ads[name])))
        refs.append(_greedy_ref(merged, cfg, prompt, 8))
    assert got == refs
    assert got == _jax_mixed(layout)
    assert got[1] != _greedy_ref(params, cfg, PROMPTS[1], 8)
    if layout == "paged":
        # adapted prompts neither adopt nor index prefix rows
        assert srv._pool.stats()["prefix_hits"] == 0


def test_tenant_default_routes_weights():
    jcfg, jp, cfg, params, ads = _model()
    jpool, pool = _pools()
    pool.set_tenant_default("acme", "prod-a")
    jpool.set_tenant_default("acme", "prod-a")
    jobs = [(PROMPTS[0], {"tenant": "acme"}), (PROMPTS[1], {})]
    got, _ = _serve("torch", jobs, pool=pool, max_batch=2, max_len=32)
    assert got == _serve("jax", jobs, pool=jpool, max_batch=2,
                         max_len=32)[0]
    merged = lora.join_lora(params, convert.params_from_jax(ads["prod-a"]))
    assert got[0] == _greedy_ref(merged, cfg, PROMPTS[0], 8)


def test_linear_spec_with_a_pool_equals_plain():
    """Draft == base target, K = 3, under a pool: the verify gathers each
    slot's adapter, so the streams are the plain pool server's."""
    _, _, cfg, params, _ = _model()
    _, pool = _pools()
    ref, _ = _serve("torch", MIXED, pool=pool, max_batch=3, max_len=48)
    srv = _server("torch", pool, max_batch=3, max_len=48, spec_k=3,
                  draft_cfg=cfg, draft_params=params)
    rids = [srv.submit(p, max_new_tokens=8, **kw) for p, kw in MIXED]
    while srv.pending():
        srv.tick()
    got = [srv.result(r) for r in rids]
    assert srv._spec_rounds > 0
    names = {fn.name for fn in engine.ENGINE._steps.values()
             if getattr(fn, "binding", None) is srv._bind}
    assert "serving.adapter_spec_verify@3" in names
    srv.close()
    assert got == ref


# ---------------------------------------------------------------------------
# constrained decoding
# ---------------------------------------------------------------------------


def test_token_set_greedy_matches_jax_and_reference():
    _, _, cfg, params, _ = _model()
    allowed = [3, 7, 11, 19]
    jobs = [([1, 2, 4], {"constraint": allowed}), ([5, 6], {})]
    got, _ = _serve("torch", jobs, max_new=6, max_batch=2, max_len=32)
    assert got == _serve("jax", jobs, max_new=6, max_batch=2,
                         max_len=32)[0]
    assert all(t in allowed for t in got[0])
    assert got[0] == _greedy_ref(params, cfg, [1, 2, 4], 6, allowed)
    assert got[1] == _greedy_ref(params, cfg, [5, 6], 6)


@pytest.mark.parametrize("way", ["async", "block"])
def test_constrained_slots_run_stepwise(way):
    """Async and block dispatch drain to synchronous single ticks for a
    constrained batch (async: ``constraint.sync_fallbacks``): the tick
    streams."""
    allowed = [3, 7, 11, 19]
    jobs = [([1, 2, 4], {"constraint": allowed}), ([5, 6], {})]
    ref, _ = _serve("torch", jobs, max_new=6, max_batch=2, max_len=32)
    tl.reset()
    got, srv = _serve("torch", jobs, max_new=6, way=way, max_batch=2,
                      max_len=32)
    assert got == ref
    if way == "async" and tl.enabled():
        assert srv.stats()["constraint.sync_fallbacks"] > 0


def test_constrained_admission_token_is_masked():
    """The admission token (drawn at temperature 1.4) is always allowed."""
    _, _, cfg, params, _ = _model()
    for seed in range(8):
        srv = serving.DecodeServer(params, cfg, max_batch=1, max_len=16,
                                   seed=seed, device="cpu")
        rid = srv.submit([4, 7], max_new_tokens=1, temperature=1.4,
                         constraint=[5, 9])
        while srv.pending():
            srv.tick()
        assert srv.result(rid)[0] in (5, 9), seed
        srv.close()


def test_constrained_sampled_follows_the_renormalized_law():
    """A constrained sampled step draws from the target law renormalized
    over the allowed set (chi-square over 200 serves: prefill=False, so
    the draw is the masked tick's)."""
    jcfg, jp, cfg, params = _pair(9, vocab_size=12)
    prompt, allowed, n = [4, 7], [1, 3, 4, 8, 10], 200
    cache = G.init_cache(cfg, 1, 16, "cpu")
    for pos, t in enumerate(prompt):
        l, cache = G.decode_step(params, cache, torch.tensor([t]), pos, cfg)
    amask = np.zeros(12, bool)
    amask[allowed] = True
    law = G._filtered_probs(l[0].numpy() + np.where(
        amask, 0.0, np.float32(A.NEG_INF)), 1.3, 0, 1.0)
    toks = []
    for i in range(n):
        srv = serving.DecodeServer(params, cfg, max_batch=1, max_len=16,
                                   prefill=False, seed=100 + i, device="cpu")
        rid = srv.submit(prompt, max_new_tokens=1, temperature=1.3,
                         constraint=allowed)
        while srv.pending():
            srv.tick()
        toks.append(srv.result(rid)[0])
    counts = np.bincount(toks, minlength=12).astype(float)
    assert counts[~amask].sum() == 0
    stat, df = _chi2(counts, law, n)
    assert stat < 3 * max(df, 1) + 10, stat


@pytest.mark.parametrize("temp", [0.0, 1.3])
@pytest.mark.parametrize("pool", [False, True])
def test_json_schema_streams_parse(temp, pool):
    """Every request under the JSON schema decodes to JSON of the
    schema's shape, greedy or sampled, with or without a pool (then the
    adapter_sample step masks); greedy streams are JAX's."""
    jpool, tpool = _pools() if pool else (None, None)
    rng = np.random.default_rng(5)
    prompts = [[int(x) for x in rng.integers(1, 30, 4)] for _ in range(3)]

    def jobs(mod):
        spec = mod.JsonSchemaConstraint(SCHEMA, VOCAB)
        return [(p, {"constraint": spec, "temperature": temp,
                     **({"adapter": "prod-a"} if pool and i == 1 else {})})
                for i, p in enumerate(prompts)]

    outs, _ = _serve("torch", jobs(A), max_new=30, pool=tpool, max_batch=3,
                     max_len=48, seed=7)
    for toks in outs:
        doc = json.loads("".join(VOCAB[t] for t in toks))
        assert set(doc) == {"ok", "tag"}
        assert isinstance(doc["ok"], bool) and doc["tag"] in ("a", "b")
    if temp == 0.0:
        assert outs == _serve("jax", jobs(JA), max_new=30, pool=jpool,
                              max_batch=3, max_len=48, seed=7)[0]


def test_linear_spec_falls_back_for_constrained_slots():
    """Linear speculation steps plainly while a slot is constrained
    (``constraint.spec_fallbacks`` moves); the streams are JAX's."""
    _, _, cfg, params, _ = _model()
    jobs = [([1, 2, 4], {"constraint": [3, 7, 11]}), ([5, 6], {})]
    tl.reset()
    got, srv = _serve("torch", jobs, max_new=6, max_batch=2, max_len=48,
                      spec_k=3)
    assert all(t in (3, 7, 11) for t in got[0]) and len(got[1]) == 6
    assert got == _serve("jax", jobs, max_new=6, max_batch=2, max_len=48,
                         spec_k=3)[0]
    if tl.enabled():
        assert srv.stats()["constraint.spec_fallbacks"] > 0


def test_adapter_and_constraint_compose():
    """One slot with both: the masked argmax of the adapted logits, as
    the merged-tree reference and the JAX server give."""
    jcfg, jp, cfg, params, ads = _model()
    jpool, pool = _pools()
    allowed = list(range(16))
    jobs = [([2, 9, 4], {"adapter": "prod-a", "constraint": allowed})]
    got, _ = _serve("torch", jobs, max_new=5, pool=pool, max_batch=1,
                    max_len=32)
    merged = lora.join_lora(params, convert.params_from_jax(ads["prod-a"]))
    assert got == [_greedy_ref(merged, cfg, [2, 9, 4], 5, allowed)]
    assert got == _serve("jax", jobs, max_new=5, pool=jpool, max_batch=1,
                         max_len=32)[0]


# ---------------------------------------------------------------------------
# the Engine surface: warmup, a register after it, keys
# ---------------------------------------------------------------------------


def _entries():
    return set(engine.ENGINE._steps.keys())


def test_warmup_covers_adapter_and_constraint_paths():
    """After ``warmup(sample=True, constrained=True, blocks=(4,))`` mixed
    base / adapter / sampled / constrained traffic and a block serve build
    nothing; every adapter key carries the pool's geometry; the warm names
    are among JAX's."""
    jpool, pool = _pools()
    kw = dict(max_batch=3, max_len=48, seed=3)
    srv = _server("torch", pool, **kw)
    names = srv.warmup(sample=True, constrained=True, blocks=(4,))
    jnames = _server("jax", jpool, **kw).warmup(sample=True,
                                                constrained=True,
                                                blocks=(4,))
    assert set(names) <= set(jnames)
    assert {"adapter_step", "adapter_sample_step", "adapter_block4"} \
        <= set(names)
    before = _entries()
    rng = np.random.default_rng(6)
    rids = [srv.submit([int(x) for x in rng.integers(1, 30, 4)]),
            srv.submit([int(x) for x in rng.integers(1, 30, 5)],
                       adapter="prod-a", temperature=1.1),
            srv.submit([int(x) for x in rng.integers(1, 30, 3)],
                       constraint=[3, 7, 11])]
    while srv.pending():
        srv.tick()
    rid = srv.submit([1, 2, 3], max_new_tokens=6, adapter="prod-a")
    while srv.pending():
        srv.tick_block(4)
    assert all(srv.result(r) for r in rids + [rid])
    assert _entries() == before
    mine = [k for k in _entries() if k[-1] == srv._bind.key
            and str(k[0]).startswith("adapter")]
    assert mine and all(pool.pool_key() in k for k in mine)
    srv.close()
    # pool-less constrained warmup: masked_step, among JAX's names
    plain = _server("torch", **kw)
    got = plain.warmup(constrained=True)
    assert "masked_step" in got
    assert set(got) <= set(_server("jax", **kw).warmup(constrained=True))
    before = _entries()
    rid = plain.submit([1, 2, 3], constraint=[3, 7, 11])
    while plain.pending():
        plain.tick()
    assert plain.result(rid) and _entries() == before
    plain.close()


def test_register_after_warmup_builds_nothing_and_serves_the_row():
    """A register after warmup writes its row in place: no step is built,
    and the next serve under that name is the new adapter's."""
    jcfg, jp, cfg, params, ads = _model()
    _, pool = _pools(("prod-a",))
    srv = _server("torch", pool, max_batch=2, max_len=48)
    srv.warmup(prompt_lens=[4])
    before = _entries()
    pool.register("prod-b", convert.params_from_jax(ads["prod-b"]))
    rid = srv.submit(PROMPTS[1], max_new_tokens=8, adapter="prod-b")
    while srv.pending():
        srv.tick()
    merged = lora.join_lora(params, convert.params_from_jax(ads["prod-b"]))
    assert srv.result(rid) == _greedy_ref(merged, cfg, PROMPTS[1], 8)
    assert _entries() == before
    srv.close()


def test_oom_requeue_keeps_adapter_and_constraint():
    """An injected tick OOM halves the batch (3 -> 1), evicting two slots
    back to the queue; re-admitted,
    it keeps its adapter and its automaton (carried tokens replayed): the
    unfaulted streams."""
    _, pool = _pools()
    jobs = [(PROMPTS[0], {"constraint": [3, 7, 11, 19], "priority": 0}),
            (PROMPTS[1], {"adapter": "prod-a", "priority": 0}),
            (PROMPTS[2], {"adapter": "prod-b", "priority": 1})]
    ref, _ = _serve("torch", jobs, pool=pool, max_batch=3, max_len=48)
    faults.install("oom:tick:3")
    got, srv = _serve("torch", jobs, pool=pool, max_batch=3, max_len=48)
    assert srv._admit_cap < 3
    assert got == ref


def test_load_stats_and_telemetry():
    """``constrained_slots`` always, ``adapters_active`` with a pool; the
    gather, register and masked-token counters and the per-adapter
    gauges."""
    _, pool = _pools(("prod-a",))
    tl.reset()
    srv = _server("torch", pool, max_batch=3, max_len=32, prefill=False)
    srv.submit([1, 2], max_new_tokens=6, adapter="prod-a")
    srv.submit([3, 4], max_new_tokens=6)
    srv.submit([5, 6], max_new_tokens=6, constraint=[3, 7, 11])
    srv.tick()
    srv.tick()                  # past the prompt: the mask is built
    ls = srv.load_stats()
    assert ls["adapters_active"] == {"prod-a": 1, "base": 2}
    assert ls["constrained_slots"] == 1
    if tl.enabled():
        assert srv.stats()["adapters.gather_steps"] >= 1
        assert tl.counter("constraint.masked_tokens") > 0
        assert tl.gauge('adapters.active{adapter="prod-a"}').get() == 1
        assert tl.gauge('adapters.active{adapter="base"}').get() == 2
        pool.register("prod-b", {k: v[1] for k, v in pool.stacks().items()})
        assert tl.counter("adapters.registered") == 1
    while srv.pending():
        srv.tick()
    srv.close()
    srv2 = _server("torch", max_batch=1, max_len=16)
    ls2 = srv2.load_stats()
    assert "adapters_active" not in ls2 and ls2["constrained_slots"] == 0
    srv2.close()
