"""The port's step Engine (paddle_tpu_torch/text/engine.py) against the
JAX package's (paddle_tpu/text/engine.py), on the CPU.

* every kind's key reads only its spec fields, and the same fields as the
  JAX registry's key (the shard fragment aside: the port has no mesh);
* ``cfg_key`` folds in the routing flags a captured step bakes in;
* the bounded LRU evicts at its bound (``PADDLE_TPU_STEP_CACHE_SIZE``);
* ``purge`` drops every entry of a config, or only one server's;
* warmup refuses a busy server, builds what a serve needs (serving after
  it adds no entry), names its steps as the JAX warmup does, and leaves
  the sampling stream where it was (a warmed server draws what a cold
  one draws);
* the counter-based sampling stream: a pure function of (key, element),
  drawing in distribution;
* the speculative ``spec_verify``, ``spec_tree_verify`` and
  ``spec_tree_commit`` kinds, ``beam_search``'s ``beam`` kind, the
  ``moe_*`` kinds, ``masked_step`` and the ``adapter_*`` kinds (their
  ``pkey``, the pool's geometry, among the fields) are keyed as the JAX
  registry keys them (``beam`` plus the prompt shape);
* ``generate`` runs as the Engine's ``generate`` kind: greedy fp32 tokens
  equal to the JAX ``generate``'s, keyed as the JAX registry keys it plus
  the prompt shape, its step and cache reused by a second call of the
  shape and freed by ``purge(cfg)``.

On the CPU every kind runs its plain callable; the card tests hold the
captured graphs against the eager steps.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.text import engine as jengine
from paddle_tpu.text import generate as jgenerate
from paddle_tpu.text import gpt as jgpt
from paddle_tpu.text import serving as jserving
from paddle_tpu_torch import convert
from paddle_tpu_torch.rng import seed_key
from paddle_tpu_torch.text import engine, gpt, serving
from paddle_tpu_torch.text import generate as G

_FIELDS = dict(paged=(False, True), bucket=(8, 16), width=(4, 8),
               k=(2, 4), extra=((8, 0, 1.0), (16, 3, 0.9)),
               pkey=(("adapters", 3, 4, ("qkv_w", "proj_w")),
                     ("adapters", 5, 8, ("qkv_w",))))
_READS = {"step": {"paged"}, "sample": {"paged"}, "async": {"paged"},
          "block": {"paged", "k"}, "sample_block": {"paged", "k"},
          "async_block": {"paged", "k"},
          "async_sample_block": {"paged", "k"},
          "prefill": {"bucket"}, "prefill_chunk": {"width"},
          "paged_prefill": {"bucket"}, "inject": {"bucket", "paged"},
          "kv_copy": {"k"},
          "spec_verify": {"paged", "k"}, "spec_tree_verify": {"paged", "k"},
          "spec_tree_commit": {"paged", "k"}, "generate": {"extra"},
          "sharded_decode": {"extra"},
          "beam": {"extra"}, "moe_step": {"paged"}, "moe_sample": {"paged"},
          "moe_block": {"paged", "k"}, "moe_async": {"paged"},
          "moe_prefill": {"bucket"}, "moe_prefill_chunk": {"width"},
          "moe_paged_prefill": {"bucket"}, "moe_verify": {"paged", "k"},
          "masked_step": {"paged"}, "adapter_step": {"paged", "pkey"},
          "adapter_sample": {"paged", "pkey"},
          "adapter_block": {"paged", "k", "pkey"},
          "adapter_async": {"paged", "pkey"},
          "adapter_spec_verify": {"paged", "k", "pkey"},
          "adapter_prefill": {"bucket", "pkey"},
          "adapter_prefill_chunk": {"width", "pkey"},
          "adapter_paged_prefill": {"bucket", "pkey"}}


def _cfg(**kw):
    base = dict(vocab_size=16, hidden_size=32, num_layers=1, num_heads=2,
                max_seq_len=64, dtype=torch.float32)
    base.update(kw)
    return gpt.GPTConfig(**base)


@pytest.fixture(scope="module")
def model():
    cfg = _cfg()
    return cfg, gpt.init_params(cfg, seed=0, device="cpu")


def test_registry_kinds():
    assert set(engine.kinds()) == set(_READS)
    assert set(_READS) <= set(jengine.kinds())


@pytest.mark.parametrize("kind", sorted(_READS))
def test_each_kind_keys_only_its_fields(kind):
    """Varying a field the kind reads changes its key; any other field
    leaves it; and the key carries the same fields, in the same order,
    as the JAX registry's (its config key and shard fragment aside; the
    JAX ``generate`` key has no kind name, and the port's adds the prompt
    shape a graph is fixed to, ``()`` here)."""
    cfg = _cfg()
    base = {f: v[0] for f, v in _FIELDS.items()}
    key0 = engine.StepSpec(cfg=cfg, **base).key(kind)
    assert key0[0] == kind and key0[1] == engine.cfg_key(cfg)
    for field, (_, other) in _FIELDS.items():
        key1 = engine.StepSpec(cfg=cfg, **dict(base, **{field: other})) \
            .key(kind)
        assert (key1 != key0) == (field in _READS[kind]), field
    # the payload (a server's binding) is never part of the spec's key
    assert engine.StepSpec(cfg=cfg, payload=object(), **base).key(kind) \
        == key0
    jcfg = jgpt.GPTConfig(vocab_size=16, hidden_size=32, num_layers=1,
                          num_heads=2, max_seq_len=64)
    jck = jengine.cfg_key(jcfg)
    jkey = jengine.StepSpec(cfg=jcfg, **base).key(kind)
    assert [x for x in jkey if x not in (jck, kind) and x is not None] \
        == [x for x in key0 if x not in (key0[1], kind, ())]


def test_cfg_key_folds_in_the_routing_flags(monkeypatch):
    """Flipping a flag a captured step bakes in keys a new step — in the
    port as in the JAX package."""
    cfg = _cfg()
    jcfg = jgpt.GPTConfig(vocab_size=16, hidden_size=32, num_layers=1,
                          num_heads=2, max_seq_len=64)
    for name, value in (("PADDLE_TPU_W4_KERNEL", "1"),
                        ("PADDLE_TPU_KV_DTYPE", "int8"),
                        ("PADDLE_TPU_FUSED_LN", "1"),
                        ("PADDLE_TPU_KV_LAYOUT", "paged"),
                        ("PADDLE_TPU_KV_BLOCK", "32")):
        monkeypatch.delenv(name, raising=False)
        k0, j0 = engine.cfg_key(cfg), jengine.cfg_key(jcfg)
        monkeypatch.setenv(name, value)
        assert engine.cfg_key(cfg) != k0, name
        assert jengine.cfg_key(jcfg) != j0, name
        monkeypatch.delenv(name)
        assert engine.cfg_key(cfg) == k0, name
    # the config is keyed by value: an equal config keys the same step
    assert engine.cfg_key(_cfg()) == engine.cfg_key(cfg)
    assert engine.cfg_key(_cfg(hidden_size=64)) != engine.cfg_key(cfg)


def test_lru_evicts_at_the_bound(model, monkeypatch):
    lru = engine._LRU(2)
    lru["a"], lru["b"] = 1, 2
    assert lru["a"] == 1                  # a is now the most recent
    lru["c"] = 3
    assert set(lru.keys()) == {"a", "c"} and len(lru) == 2
    with pytest.raises(KeyError):
        lru["b"]
    monkeypatch.setenv("PADDLE_TPU_STEP_CACHE_SIZE", "3")
    eng = engine.Engine()
    assert eng._steps.maxsize == 3
    cfg, params = model
    srv = serving.DecodeServer(params, cfg, max_batch=2, max_len=16,
                               device="cpu")
    first = eng.get("step", srv._spec())
    for k in (2, 3, 4):
        eng.get("block", srv._spec(k=k))
    assert len(eng._steps) == 3
    assert eng.get("step", srv._spec()) is not first   # evicted, rebuilt


def test_purge_drops_every_entry_of_a_config(model):
    cfg, params = model
    cfg2 = _cfg(hidden_size=64)
    params2 = gpt.init_params(cfg2, seed=1, device="cpu")
    eng = engine.Engine()
    a = serving.DecodeServer(params, cfg, 2, 16, device="cpu")
    b = serving.DecodeServer(params, cfg, 2, 16, device="cpu")
    c = serving.DecodeServer(params2, cfg2, 2, 16, device="cpu")
    for srv in (a, b, c):
        eng.get("step", srv._spec())
        eng.get("block", srv._spec(k=4))
        eng.get("prefill", srv._spec(bucket=8))
    assert len(eng._steps) == 9
    # two servers of one config never share a step: each is bound to its
    # own cache
    assert eng.get("step", a._spec()) is not eng.get("step", b._spec())
    assert eng.purge(cfg, binding=a._bind) == 3          # a's only
    assert len(eng._steps) == 6
    assert eng.purge(cfg) == 3                            # b's
    assert all(k[1] == engine.cfg_key(cfg2) for k in eng._steps.keys())
    assert eng.purge(cfg2, None) == 3 and len(eng._steps) == 0
    assert eng.purge() == 0
    # a server's close() drops its steps whatever flags keyed them
    eng.get("step", a._spec())
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PADDLE_TPU_W4_KERNEL", "1")
        eng.get("step", a._spec())
    assert len(eng._steps) == 2
    assert eng.purge(binding=a._bind) == 2 and len(eng._steps) == 0


def _reqs():
    rng = np.random.default_rng(7)
    return [(list(rng.integers(1, 16, 2 + 2 * i)), 4 + i) for i in range(3)]


def _serve(srv, reqs, block=None, **kw):
    rids = [srv.submit(p, max_new_tokens=n, **kw) for p, n in reqs]
    for _ in range(300):
        if not srv.pending():
            break
        srv.tick_block(block) if block else srv.tick()
    assert not srv.pending()
    return [srv.result(r) for r in rids]


def test_warmup_on_a_busy_server_raises(model):
    cfg, params = model
    srv = serving.DecodeServer(params, cfg, max_batch=1, max_len=32,
                               device="cpu")
    srv.submit([1, 2, 3], max_new_tokens=4)
    with pytest.raises(RuntimeError, match="idle"):
        srv.warmup()
    srv.submit([4, 5], max_new_tokens=4)       # queued behind the first
    while srv.pending():
        srv.tick()
    srv.warmup()                                # idle again: fine
    srv.close()
    with pytest.raises(RuntimeError, match="closed"):
        srv.warmup()


@pytest.mark.parametrize("mode", ["tick", "block", "async"])
@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_serving_after_warmup_adds_zero_entries(model, mode, layout):
    """warmup builds every step a serve of greedy and sampled requests
    needs: serving afterwards adds no Engine entry (the JAX Engine's
    warmup-then-serve contract)."""
    cfg, params = model
    engine.ENGINE._steps.clear()
    srv = serving.DecodeServer(params, cfg, max_batch=2, max_len=40,
                               device="cpu", layout=layout, block_size=8,
                               async_dispatch=mode == "async")
    t = srv.warmup(prompt_lens=[3, 12], blocks=(3,), sample=True)
    assert all(isinstance(v, float) for v in t.values())
    keys0 = set(engine.ENGINE._steps.keys())
    assert keys0 and len(keys0) == len(t)
    reqs = [([2, 3, 4], 4), ([2] * 12, 4)]
    block = 3 if mode != "tick" else None
    _serve(srv, reqs, block)
    _serve(srv, reqs, block, temperature=0.7, top_k=5)
    assert set(engine.ENGINE._steps.keys()) == keys0
    srv.close()
    assert not engine.ENGINE._steps.keys()


def test_warmup_reports_its_steps(model):
    """The JAX warmup's names (tests/test_decode_hot_path.py): the tick
    step, its sampled twin, each block size and each prefill bucket."""
    cfg, params = model
    srv = serving.DecodeServer(params, cfg, max_batch=2, max_len=16,
                               device="cpu")
    t = srv.warmup(prompt_lens=[3, 5], blocks=(2,), sample=True)
    assert {"step", "sample_step", "block2", "sample_block2", "prefill4",
            "prefill8"} == set(t)
    rid = srv.submit([3, 5, 9], max_new_tokens=4)     # still usable
    while srv.pending():
        srv.tick()
    assert len(srv.result(rid)) == 4
    chunked = serving.DecodeServer(params, cfg, max_batch=2, max_len=16,
                                   device="cpu", prefill_chunk=4)
    assert set(chunked.warmup()) == {"step", "prefill_chunk4"}
    asy = serving.DecodeServer(params, cfg, max_batch=2, max_len=16,
                               device="cpu", async_dispatch=True)
    assert set(asy.warmup(prompt_lens=[3], blocks=(2,), sample=True)) == {
        "async_step", "async_sample_step", "async_block2",
        "async_sample_block2", "prefill4"}
    paged = serving.DecodeServer(params, cfg, max_batch=2, max_len=40,
                                 device="cpu", layout="paged", block_size=8)
    assert set(paged.warmup()) == {"step", "paged_prefill8",
                                   "paged_prefill16", "paged_prefill32",
                                   "paged_prefill40", "kv_copy@1",
                                   "kv_copy@2"}


@pytest.mark.parametrize("mode", ["tick", "block", "async"])
def test_warmed_server_samples_what_a_cold_one_does(model, mode):
    cfg, params = model
    kw = dict(temperature=0.9, top_k=6)
    block = 2 if mode != "tick" else None

    def run(warm):
        srv = serving.DecodeServer(params, cfg, max_batch=4, max_len=24,
                                   device="cpu", seed=11,
                                   async_dispatch=mode == "async")
        if warm:
            srv.warmup(blocks=(2,), sample=True)
        out = _serve(srv, _reqs(), block, **kw)
        srv.close()
        return out

    cold = run(False)
    assert run(True) == cold
    other = serving.DecodeServer(params, cfg, max_batch=4, max_len=24,
                                 device="cpu", seed=12)
    assert _serve(other, _reqs(), **kw) != cold     # the seed matters


def test_warmup_leaves_counters_and_state(model):
    """No launch counter, step counter or request state moves (on the
    card the captures' launches are put back too: the card tests)."""
    cfg, params = model
    srv = serving.DecodeServer(params, cfg, max_batch=2, max_len=16,
                               device="cpu")
    before = engine._counts()
    srv.warmup(blocks=(2,), sample=True)
    assert engine._counts() == before
    assert srv._step_no == 0 and srv.load_stats()["tokens_generated"] == 0
    assert not srv.pending() and srv._inflight is None


def test_sampling_stream_is_keyed_and_in_distribution():
    """A draw is a pure function of (key, slot, logits): the same key
    draws the same tokens, another counter other ones; and over many
    slots of one logits row the draws follow its softmax."""
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.standard_normal(8).astype(np.float32)) * 2
    B = 40000
    rows = logits.expand(B, 8).contiguous()
    temp = torch.ones(B)
    tk = torch.zeros(B, dtype=torch.int64)
    tp = torch.ones(B)
    key = torch.tensor([seed_key(3), 17])
    a = serving._sample_batched(rows, key, temp, tk, tp)
    assert torch.equal(a, serving._sample_batched(rows, key, temp, tk, tp))
    b = serving._sample_batched(rows, torch.tensor([seed_key(3), 18]),
                                temp, tk, tp)
    assert (a != b).float().mean() > 0.3
    freq = torch.bincount(a, minlength=8).float() / B
    want = torch.softmax(logits, -1)
    assert (freq - want).abs().max() < 0.01, (freq, want)
    # the block's key schedule is the tick's: step n + j
    assert torch.equal(serving._step_key(key, 3), torch.tensor(
        [seed_key(3), 20]))


def test_jax_server_and_port_share_the_warmup_surface(markov_gpt):
    """The JAX server's warmup names are the port's for the same
    server shape (tests/test_decode_hot_path.py)."""
    jcfg, jparams = markov_gpt
    cfg = convert.config_from_jax(jcfg)
    params = convert.params_from_jax(jparams)
    jt = jserving.DecodeServer(jparams, jcfg, max_batch=2, max_len=16) \
        .warmup(prompt_lens=[3, 5], blocks=(2,), sample=True)
    t = serving.DecodeServer(params, cfg, max_batch=2, max_len=16,
                             device="cpu").warmup(prompt_lens=[3, 5],
                                                  blocks=(2,), sample=True)
    assert set(t) <= set(jt)


def test_generate_runs_through_the_engine():
    jcfg = jgpt.GPTConfig(vocab_size=64, hidden_size=64, num_layers=2,
                          num_heads=4, max_seq_len=32, dtype=jnp.float32)
    jp = jgpt.init_params(jcfg, jax.random.PRNGKey(1))
    cfg = convert.config_from_jax(jcfg)
    params = convert.params_from_jax(jax.device_get(jp))
    prompt = np.random.default_rng(0).integers(0, 64, (2, 5))
    ref = np.asarray(jgenerate.generate(jp, jcfg, prompt, 7)).tolist()
    engine.ENGINE.purge(cfg)
    assert G.generate(params, cfg, prompt, 7, device="cpu").tolist() == ref
    (key,) = [k for k in engine.ENGINE._steps.keys() if k[0] == "generate"
              and k[1] == engine.cfg_key(cfg)]
    jkey = jengine.StepSpec(cfg=jcfg, extra=(7, 0, 1.0)).key("generate")
    assert jkey == (jengine.cfg_key(jcfg), 7, 0, 1.0)
    assert key[:-1] == ("generate", engine.cfg_key(cfg), *jkey[1:], (2, 5))
    step = engine.ENGINE._steps.get(key)
    (gkey,) = [k for k in engine.ENGINE._gen if k[0] == key[1]]
    assert G.generate(params, cfg, prompt, 7, device="cpu").tolist() == ref
    assert engine.ENGINE._steps.get(key) is step          # replayed, not
    assert [k for k in engine.ENGINE._gen if k[0] == key[1]] == [gkey]
    assert engine.ENGINE.purge(cfg) == 1
    assert gkey not in engine.ENGINE._gen
    assert key not in engine.ENGINE._steps.keys()
