"""The port's MoE serving (paddle_tpu_torch/text/moe_serving.py, the
``moe_*`` Engine kinds and the MoE paths of ``DecodeServer``) against the
JAX package's, on the CPU.

* served greedy streams equal JAX ``dense_reference_greedy``'s exactly —
  {tick, block, async} x {contiguous, paged}, budgeted admission,
  token-by-token prompts, and a single slot at cf 0.25 (one token can
  never drop) — with no drop counted at the dropless capacity;
* the device drop counter: on a zeroed router (every token ties onto
  experts 0 and 1) at cf 0.5 it equals the host replay of the reference's
  ``test_capacity_overflow_drops_exactly_match_host_routing`` and the
  JAX server's counters, load included, and the ``moe.*`` telemetry
  follows it;
* after ``warmup`` a greedy, sampled and block serve adds no Engine key;
  a sampled ``tick_block`` runs stepwise (the tokens of ``tick``);
* the door refusals in the reference's words (speculation, adapter pools,
  constraints); ``cfg_key`` keys every routing field; the binding keys
  the accumulator; ``moe_verify``'s key, name and scores (JAX's at a
  dropless capacity).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.text import engine as jengine
from paddle_tpu.text import generate as JG
from paddle_tpu.text import moe_serving as jms
from paddle_tpu.text import serving as jserving
from paddle_tpu_torch import telemetry as tl
from paddle_tpu_torch.text import engine
from paddle_tpu_torch.text import generate as G
from paddle_tpu_torch.text import moe, serving

from test_torch_moe import both, jax_cfg

PROMPTS = [[5, 3, 9, 1], [2, 8, 8], [7, 1, 4, 4, 2, 6]]
MAX_NEW = 6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def model():
    return both(jax_cfg(), seed=11)


@pytest.fixture(scope="module")
def reference(model):
    """JAX's capacity-free ground truth, once per prompt."""
    jcfg, jp, _, _ = model
    return [jms.dense_reference_greedy(jp, jcfg, p, MAX_NEW, 32)
            for p in PROMPTS]


def _serve(srv, prompts=PROMPTS, mode="tick", **sub):
    rids = [srv.submit(p, max_new_tokens=MAX_NEW, **sub) for p in prompts]
    ticks = 0
    while srv.pending():
        srv.tick_block(3) if mode == "block" else srv.tick()
        ticks += 1
        assert ticks < 200
    return [srv.result(r) for r in rids]


def test_reference_streams_are_not_constant(reference):
    """The model's streams depend on the prompt (no attractor token that
    would hide a wrong-input bug)."""
    assert len({tuple(r) for r in reference}) == len(PROMPTS)
    assert all(len(set(r)) > 1 for r in reference)


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("mode", ["tick", "block", "async"])
def test_served_streams_equal_the_dense_eval_reference(model, reference,
                                                       mode, layout):
    """B = 2, E = 4, top-2, cf 1.25: C = 2 >= B, so joint routing equals
    solo routing, which equals the dense evaluation — token for token,
    with no drop on the device counter (three requests: a slot is
    reused)."""
    _, _, cfg, p = model
    kw = dict(max_batch=2, max_len=32, device="cpu")
    if layout == "paged":
        kw.update(layout="paged", block_size=8)
    if mode == "async":
        kw["async_dispatch"] = True
    srv = serving.DecodeServer(p, cfg, **kw)
    assert _serve(srv, mode=mode) == reference
    ls = srv.load_stats()
    assert ls["moe_dropped_tokens"] == 0
    assert sum(ls["moe_expert_load"]) > 0
    srv.close()


@pytest.mark.parametrize("how", ["budgeted", "token_by_token"])
def test_admission_modes_equal_the_reference(model, reference, how):
    """prefill_budget=2: a claimed slot admits in chunks (left out of the
    occupancy mask) while the other decodes; prefill=False: prompts feed
    through the joint step (prompt-feeding slots route).  Both serve the
    reference's streams with nothing dropped."""
    _, _, cfg, p = model
    kw = (dict(prefill_budget=2) if how == "budgeted"
          else dict(prefill=False))
    srv = serving.DecodeServer(p, cfg, max_batch=2, max_len=32,
                               device="cpu", **kw)
    assert _serve(srv) == reference
    if how == "budgeted":
        assert srv.stats()["serving.admitting_claims"] == len(PROMPTS)
    assert srv.load_stats()["moe_dropped_tokens"] == 0


def test_single_slot_never_drops():
    """One occupied slot claims at most one slot an expert and C >= 1, so
    even cf 0.25 is dropless solo: the stream is the reference's."""
    jcfg, jp, cfg, p = both(jax_cfg(cf=0.25), seed=11)
    want = jms.dense_reference_greedy(jp, jcfg, PROMPTS[0], MAX_NEW, 32)
    srv = serving.DecodeServer(p, cfg, max_batch=2, max_len=32,
                               device="cpu")
    assert _serve(srv, PROMPTS[:1]) == [want]
    assert srv.load_stats()["moe_dropped_tokens"] == 0


@pytest.fixture(scope="module")
def overflow():
    """The zeroed-router model at cf 0.5 (C = 1 at B = 2) and the JAX
    server's counters on the reference test's two requests."""
    jcfg, jp, cfg, p = both(jax_cfg(cf=0.5), seed=3)
    jp["blocks"]["moe"]["router_w"][:] = 0.0
    p["blocks"]["moe"]["router_w"].zero_()
    jsrv = jserving.DecodeServer(jax.tree_util.tree_map(jnp.asarray, jp),
                                 jcfg, max_batch=2, max_len=32)
    rids = [jsrv.submit([1, 2], max_new_tokens=4),
            jsrv.submit([3, 4, 5], max_new_tokens=4)]
    while jsrv.pending():
        jsrv.tick()
    jls = jsrv.load_stats()
    jsrv.close()
    return cfg, p, (jls["moe_dropped_tokens"], jls["moe_expert_load"]), \
        [jsrv.result(r) for r in rids]


def test_drop_counter_equals_host_replay_and_jax(overflow):
    """Every token ties onto experts 0 and 1: a tick with ``a`` active
    slots drops (a - 1) assignments per claimed expert per layer.  The
    device counter equals that replay and the JAX server's counters,
    the load shows only experts 0 and 1, the tokens are JAX's, and the
    ``moe.*`` telemetry follows the drain."""
    cfg, p, (jdropped, jload), jtoks = overflow
    L = cfg.num_layers
    tl.reset()
    srv = serving.DecodeServer(p, cfg, max_batch=2, max_len=32,
                               device="cpu")
    rids = [srv.submit([1, 2], max_new_tokens=4),
            srv.submit([3, 4, 5], max_new_tokens=4)]
    exp_dropped = exp_kept = 0
    while srv.pending():
        active = sum(1 for st in srv._slots.values()
                     if not st.get("admitting"))
        srv.tick()
        if active:
            exp_dropped += 2 * L * max(0, active - 1)
            exp_kept += L
    ls = srv.load_stats()
    assert exp_dropped > 0
    assert ls["moe_dropped_tokens"] == exp_dropped == jdropped
    assert ls["moe_expert_load"] == [exp_kept, exp_kept, 0, 0] == jload
    assert [srv.result(r) for r in rids] == jtoks
    assert all(len(srv.result(r)) == 4 for r in rids)
    assert tl.counter("moe.dropped_tokens") == exp_dropped
    assert tl.snapshot()["gauges"]["moe.expert_load{expert=1}"] == exp_kept
    # a second drain publishes no drop twice; close drains once more
    srv.load_stats()
    srv.close()
    assert tl.counter("moe.dropped_tokens") == exp_dropped


def test_warmup_builds_everything_served(model):
    """After warmup(prompt_lens, blocks, sample=True) a greedy, a sampled
    and a block serve add no Engine key, and the warm steps (an all-False
    occupancy) counted no routing."""
    _, _, cfg, p = model
    srv = serving.DecodeServer(p, cfg, max_batch=2, max_len=32,
                               device="cpu")
    names = srv.warmup(prompt_lens=(4,), blocks=(3,), sample=True)
    assert {"step", "moe_sample_step", "moe_block3", "prefill4"} <= set(names)
    assert srv.load_stats()["moe_expert_load"] == [0, 0, 0, 0]
    keys = set(engine.ENGINE._steps.keys())
    rids = [srv.submit([5, 3, 9, 1], max_new_tokens=4),
            srv.submit([2, 8, 8, 1], max_new_tokens=4, temperature=0.8,
                       top_k=4)]
    while srv.pending():
        srv.tick()
    rid = srv.submit([1, 2, 3, 4], max_new_tokens=4)
    while srv.pending():
        srv.tick_block(3)
    assert all(len(srv.result(r)) == 4 for r in rids + [rid])
    assert set(engine.ENGINE._steps.keys()) == keys
    srv.close()
    # an async server warms its one tick step
    asrv = serving.DecodeServer(p, cfg, max_batch=2, max_len=32,
                                device="cpu", async_dispatch=True,
                                layout="paged", block_size=8)
    names = asrv.warmup(prompt_lens=(4,), blocks=(3,))
    assert "moe_async_step" in names and "moe_block3" not in names
    assert {n for n in names if n.startswith("paged_prefill")}
    asrv.close()


def test_sampled_tick_block_runs_stepwise(model):
    _, _, cfg, p = model
    got = []
    for mode in ("tick", "block"):
        srv = serving.DecodeServer(p, cfg, max_batch=2, max_len=32,
                                   device="cpu", seed=4)
        got.append(_serve(srv, PROMPTS[:2], mode=mode, temperature=1.0))
        srv.close()
    assert got[0] == got[1]


def test_door_refusals_in_the_reference_words(model):
    _, _, cfg, p = model
    with pytest.raises(NotImplementedError,
                       match="speculative serving requires dense"):
        serving.DecodeServer(p, cfg, max_batch=1, max_len=16, device="cpu",
                             spec_k=2)
    with pytest.raises(NotImplementedError,
                       match="adapter_pool with an MoE"):
        serving.DecodeServer(p, cfg, max_batch=1, max_len=16, device="cpu",
                             adapter_pool=object())
    srv = serving.DecodeServer(p, cfg, max_batch=1, max_len=16,
                               device="cpu")
    with pytest.raises(NotImplementedError,
                       match="constrained decoding on an MoE"):
        srv.submit([1, 2], max_new_tokens=2, constraint=object())
    assert not srv.pending()


def test_keys_cover_routing_and_the_accumulator(model):
    _, _, cfg, p = model
    keys = {engine.cfg_key(dataclasses.replace(
        cfg, moe=moe.MoEConfig(**kw))) for kw in (
        {}, {"top_k": 1}, {"capacity_factor": 2.0}, {"num_experts": 4},
        {"router_noise": 0.1}, {"aux_loss_weight": 0.0})}
    assert len(keys) == 6
    assert engine.cfg_key(cfg) != engine.cfg_key(
        dataclasses.replace(cfg, moe=None))
    a = serving.DecodeServer(p, cfg, max_batch=1, max_len=16, device="cpu")
    b = serving.DecodeServer(p, cfg, max_batch=1, max_len=16, device="cpu")
    assert a._bind.key[-1] == tuple(t.data_ptr()
                                    for t in a._moe_stats.values())
    assert a._bind.key != b._bind.key


@pytest.mark.parametrize("cf", [2.0, 1.25])
def test_moe_verify_key_name_and_scores(cf):
    """The staged verify kind: keyed and named as the JAX registry's, and
    runnable; at the dropless cf = E / k its scores are the JAX kind's
    (whose vmapped route takes each slot's window apart)."""
    jcfg, jp, cfg, p = both(jax_cfg(cf=cf), seed=2)
    spec = engine.StepSpec(cfg=cfg, k=3)
    assert spec.key("moe_verify") == ("moe_verify", engine.cfg_key(cfg),
                                      3, False)
    jspec = jengine.StepSpec(cfg=jcfg, k=3)
    assert jspec.name("moe_verify") == "serving.moe_verify@3" \
        == engine._REGISTRY["moe_verify"].name(spec)
    cache = G.init_cache(cfg, 2, 16, "cpu")
    toks = np.asarray([[1, 2, 3], [4, 5, 6]])
    fn = engine.ENGINE.get("moe_verify", engine.StepSpec(
        cfg=cfg, k=3, payload=engine.Binding(p, cache)))
    (logits,) = fn(torch.from_numpy(toks), torch.zeros(2, dtype=torch.int32))
    assert logits.shape == (2, 3, cfg.vocab_size)
    assert torch.isfinite(logits).all()
    if cf == 2.0:
        jfn = jengine.ENGINE.get("moe_verify", jspec)
        jlogits, _ = jfn(jax.tree_util.tree_map(jnp.asarray, jp),
                         JG.init_cache(jcfg, 2, 16),
                         jnp.asarray(toks, jnp.int32),
                         jnp.zeros((2,), jnp.int32))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   atol=1e-5)

