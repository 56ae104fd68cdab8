"""The port's MoE layers (paddle_tpu_torch/text/moe.py and the MoE
branches of gpt.py, generate.py, kv_pool.py, woq.py and convert.py)
against the JAX package's, on the CPU.

Tiny fp32 configs (vocab 32, hidden 32, 2 layers, 4 heads, 4 experts,
top-2); the same numpy-seeded weights reach both packages (the JAX tree
as numpy arrays, the port's through ``convert.params_from_jax``).

* the router: dispatch equal, combine and aux within 1e-6 — plain, under
  a pad mask, at an overridden (dropless) capacity, at cf 0.5 where
  assignments drop, and on a zeroed router where every token ties (the
  lowest experts win, as ``jax.lax.top_k``'s order);
* ``moe_ffn``: y within 1e-6, aux, and the routing-stats delta exactly;
* the model: ``forward_with_aux`` (logits and the aux term), the decode
  step against the full forward, chunked prefill against stepwise
  feeding, a padded prompt routing as its prefix, ``prefill_slot`` and
  ``dense_eval_decode_step`` against JAX's;
* conversion (the nested tree, ``router_w`` kept float32, the MoE config
  field by field), the config's gelu-only check, the tree's size
  against the expert arithmetic and ``count_params`` / ``flops_per_token``
  against JAX's, the ``GPT`` module's nested parameters, and int8 / int4
  expert quantization bit-equal to JAX's.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.text import generate as JG
from paddle_tpu.text import gpt as jgpt
from paddle_tpu.text import moe as jmoe
from paddle_tpu.text import moe_serving as jms
from paddle_tpu.text import woq as jwoq
from paddle_tpu_torch import convert
from paddle_tpu_torch.text import generate as G
from paddle_tpu_torch.text import gpt, moe, moe_serving, woq

TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def jax_cfg(cf=1.25, E=4, k=2, **over):
    kw = dict(vocab_size=32, hidden_size=32, num_layers=2, num_heads=4,
              max_seq_len=64, dtype=jnp.float32,
              moe=jmoe.MoEConfig(num_experts=E, top_k=k, capacity_factor=cf,
                                 router_noise=0.0))
    kw.update(over)
    return jgpt.GPTConfig(**kw)


def numpy_tree(jcfg, seed=0, std=0.3):
    """The JAX init tree's structure with numpy-drawn values: gains 1,
    every other leaf normal(0, std) — biases too, so they are exercised;
    float32 throughout, as the reference's masters."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jgpt.init_params(
        jcfg, jax.random.PRNGKey(0)))

    def draw(path, leaf):
        name = str(getattr(path[-1], "key", ""))
        if name.endswith("_g"):
            return np.ones(leaf.shape, np.float32)
        return (rng.standard_normal(leaf.shape) * std).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def both(jcfg, seed=0, std=0.3):
    jp = numpy_tree(jcfg, seed, std)
    return jcfg, jp, convert.config_from_jax(jcfg), \
        convert.params_from_jax(jp)


def _route_case(name):
    """(x [N, D], router params, valid, C, cfg) of a router case."""
    rng = np.random.default_rng(3)
    N, D, E = 12, 32, 4
    x = rng.standard_normal((N, D)).astype(np.float32)
    mp = {"router_w": (rng.standard_normal((D, E)) * 0.3).astype(np.float32)}
    cf = {"cf05": 0.5}.get(name, 1.25)
    mcfg = jmoe.MoEConfig(num_experts=E, top_k=2, capacity_factor=cf)
    valid = None
    C = max(1, int(np.ceil(N * 2 / E * cf)))
    if name == "valid":
        valid = np.arange(N) < 7
    if name == "dropless":
        C = N
    if name == "ties":
        mp["router_w"][:] = 0.0
    return x, mp, valid, C, mcfg


CASES = ["plain", "valid", "dropless", "cf05", "ties"]


@pytest.mark.parametrize("case", CASES)
def test_route_matches_jax(case):
    x, mp, valid, C, mcfg = _route_case(case)
    jd, jc, ja = jmoe._route(
        mp, jnp.asarray(x), mcfg, None, 4, C, jnp.float32,
        valid=None if valid is None else jnp.asarray(valid))
    tmp = {"router_w": torch.from_numpy(mp["router_w"])}
    td, tc, ta = moe._route(
        tmp, torch.from_numpy(x), moe.MoEConfig(**vars(mcfg)), None, 4, C,
        torch.float32, valid=None if valid is None
        else torch.from_numpy(valid))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=TOL)
    np.testing.assert_allclose(float(ta), float(ja), atol=TOL)
    if case == "ties":          # every token on experts 0 and 1
        assert td.numpy()[:, 2:].sum() == 0
    if case == "cf05":
        assert td.numpy().sum() < 12 * 2       # the case drops


@pytest.mark.parametrize("case", CASES)
def test_moe_ffn_matches_jax(case):
    x, mp, valid, C, mcfg = _route_case(case)
    rng = np.random.default_rng(5)
    E, D, F = 4, 32, 64
    for n, shape in (("w_in", (E, D, F)), ("b_in", (E, F)),
                     ("w_out", (E, F, D)), ("b_out", (E, D))):
        mp[n] = (rng.standard_normal(shape) * 0.2).astype(np.float32)
    cap = C if case == "dropless" else None
    jv = None if valid is None else jnp.asarray(valid)
    jy, ja, jdl = jmoe.moe_ffn({k: jnp.asarray(v) for k, v in mp.items()},
                               jnp.asarray(x), mcfg, valid=jv, capacity=cap,
                               with_stats=True)
    tv = None if valid is None else torch.from_numpy(valid)
    tp = {k: torch.from_numpy(v) for k, v in mp.items()}
    ty, ta, tdl = moe.moe_ffn(tp, torch.from_numpy(x),
                              moe.MoEConfig(**vars(mcfg)), valid=tv,
                              capacity=cap, with_stats=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=TOL)
    np.testing.assert_allclose(float(ta), float(ja), atol=TOL)
    assert int(tdl["dropped"]) == int(jdl["dropped"])
    np.testing.assert_array_equal(tdl["load"].numpy(),
                                  np.asarray(jdl["load"]))
    assert tdl["dropped"].dtype == torch.int32
    # moe_tail: the same y, the same delta added into an accumulator
    st = moe_serving.moe_stats_init(4, "cpu")
    st["dropped"] += 5
    y2 = moe.moe_tail(tp, torch.from_numpy(x), moe.MoEConfig(**vars(mcfg)),
                      valid=tv, capacity=cap, stats=st)
    assert torch.equal(y2, ty)
    assert int(st["dropped"]) == 5 + int(jdl["dropped"])
    np.testing.assert_array_equal(st["load"].numpy(),
                                  np.asarray(jdl["load"]))


def test_top_k_ties_take_the_lowest_experts():
    logits = torch.zeros(3, 8)
    logits[1, 5] = logits[1, 6] = 1.0
    w, idx, _ = moe._top_k_gating(logits, 2)
    assert idx.tolist() == [[0, 1], [5, 6], [0, 1]]
    np.testing.assert_allclose(w.numpy(), 0.5)


def test_forward_with_aux_matches_jax():
    jcfg, jp, cfg, p = both(jax_cfg())
    toks = np.random.default_rng(0).integers(0, 32, (2, 9))
    jl, ja = jgpt.forward_with_aux(jp, jnp.asarray(toks), jcfg)
    tl, ta = gpt.forward_with_aux(p, torch.from_numpy(toks), cfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)
    np.testing.assert_allclose(float(ta), float(ja), atol=TOL)
    assert float(ta) > 0
    # the nn.Module form nests the expert leaves and computes the same
    mod = gpt.GPT(cfg, p)
    assert "blocks.moe.w_in" in dict(mod.named_parameters())
    assert torch.equal(mod(torch.from_numpy(toks)), tl)


def test_decode_matches_full_forward():
    """As the reference's TestMoEDecode: top_k == E and cf 1.0 so no
    capacity binds in the forward or the steps — the cache path equals
    the full forward, in the port and against the JAX steps."""
    jcfg, jp, cfg, p = both(jax_cfg(cf=1.0, E=2, k=2), seed=1)
    toks = np.random.default_rng(1).integers(0, 32, (2, 6))
    full = gpt.forward(p, torch.from_numpy(toks), cfg)
    cache = G.init_cache(cfg, 2, 6, "cpu")
    jcache = JG.init_cache(jcfg, 2, 6)
    for t in range(6):
        lg, cache = G.decode_step(p, cache, torch.from_numpy(toks[:, t]), t,
                                  cfg)
        jlg, jcache = JG.decode_step(jp, jcache, jnp.asarray(toks[:, t]), t,
                                     jcfg)
        np.testing.assert_allclose(lg.numpy(), full[:, t].numpy(),
                                   atol=1e-5)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=1e-5)


def _stepwise(p, cfg, prompt, max_len=48):
    cache = G.init_cache(cfg, 1, max_len, "cpu")
    for pos, tok in enumerate(prompt):
        logits, cache = G.decode_step(p, cache, torch.tensor([tok]), pos, cfg)
    return logits[0], cache


def test_chunked_equals_stepwise():
    """A 7-token prompt in 3-token chunks (the last padded) routes each
    chunk dropless under its pad mask: the logits of stepwise feeding,
    and the JAX chunk path's."""
    jcfg, jp, cfg, p = both(jax_cfg(), seed=2)
    prompt = [int(t) for t in np.random.default_rng(1).integers(0, 32, 7)]
    want, _ = _stepwise(p, cfg, prompt)
    cache = G.init_cache(cfg, 1, 48, "cpu")
    jcache = JG.init_cache(jcfg, 1, 48)
    C = 3
    for i in range(0, len(prompt), C):
        chunk = prompt[i:i + C]
        padded = np.zeros((1, C), np.int64)
        padded[0, :len(chunk)] = chunk
        logits, cache = G.prefill_slot_chunk(
            p, cache, torch.from_numpy(padded), i, len(chunk), 0, cfg)
        jlogits, jcache = JG.prefill_slot_chunk(
            jp, jcache, jnp.asarray(padded, jnp.int32), jnp.asarray(i),
            jnp.asarray(len(chunk)), jnp.asarray(0), jcfg)
    np.testing.assert_allclose(logits.numpy(), want.numpy(), atol=1e-5)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=1e-5)


def test_padded_prompt_routes_like_its_prefix():
    """prefill_slot on a padded bucket: the pads claim no capacity, so the
    logits and cache rows are stepwise feeding's (and JAX's)."""
    jcfg, jp, cfg, p = both(jax_cfg(), seed=4)
    prompt = [5, 3, 9, 1, 7]
    want, cache_r = _stepwise(p, cfg, prompt, 16)
    padded = np.zeros((1, 8), np.int64)
    padded[0, :5] = prompt
    got, cache_p = G.prefill_slot(p, G.init_cache(cfg, 1, 16, "cpu"),
                                  torch.from_numpy(padded), 5, 0, cfg)
    jgot, _ = JG.prefill_slot(jp, JG.init_cache(jcfg, 1, 16),
                              jnp.asarray(padded, jnp.int32),
                              jnp.asarray(5), jnp.asarray(0), jcfg)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), atol=1e-5)
    np.testing.assert_allclose(cache_p["k"][:, 0, :5].numpy(),
                               cache_r["k"][:, 0, :5].numpy(), atol=1e-5)
    # at the router: pads dispatch nowhere, the valid rows keep top_k
    x = torch.randn(16, 32, generator=torch.Generator().manual_seed(0))
    mp = {"router_w": p["blocks"]["moe"]["router_w"][0]}
    valid = torch.arange(16) < 6
    d, c, _ = moe._route(mp, x, cfg.moe, None, 4, 16, torch.float32,
                         valid=valid)
    assert d[6:].sum() == 0 and (d[:6].sum(dim=(1, 2)) == 2).all()
    d2, c2, _ = moe._route(mp, x[:6], cfg.moe, None, 4, 16, torch.float32)
    assert torch.equal(d[:6], d2) and torch.equal(c[:6], c2)


def test_dense_eval_decode_step_matches_jax():
    jcfg, jp, cfg, p = both(jax_cfg(), seed=5)
    toks = np.random.default_rng(2).integers(0, 32, (3, 4))
    cache = G.init_cache(cfg, 3, 8, "cpu")
    jcache = JG.init_cache(jcfg, 3, 8)
    for t in range(4):
        lg, cache = moe_serving.dense_eval_decode_step(
            p, cache, torch.from_numpy(toks[:, t]), t, cfg)
        jlg, jcache = jms.dense_eval_decode_step(
            jp, jcache, jnp.asarray(toks[:, t]), t, jcfg)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=1e-5)
    # per-slot positions: each slot at its own position is its solo run
    a, b = toks[0, :3], toks[1, :2]
    cache2 = G.init_cache(cfg, 2, 8, "cpu")
    for pos, feed in (([0, 0], [a[0], b[0]]), ([1, 0], [a[1], b[0]]),
                      ([2, 1], [a[2], b[1]])):
        lg2, cache2 = moe_serving.dense_eval_decode_step(
            p, cache2, torch.tensor(feed),
            torch.tensor(pos, dtype=torch.int32), cfg)
    for row, seq in ((0, a), (1, b)):
        solo = G.init_cache(cfg, 1, 8, "cpu")
        for t, tok in enumerate(seq):
            want, solo = moe_serving.dense_eval_decode_step(
                p, solo, torch.tensor([tok]), t, cfg)
        np.testing.assert_allclose(lg2[row].numpy(), want[0].numpy(),
                                   atol=1e-5)
    with pytest.raises(ValueError, match="MoE reference"):
        dense = gpt.GPTConfig(vocab_size=32, hidden_size=32, num_layers=1,
                              num_heads=4, dtype=torch.float32)
        moe_serving.dense_eval_decode_step(
            gpt.init_params(dense, device="cpu"),
            G.init_cache(dense, 1, 8, "cpu"), torch.tensor([1]), 0, dense)


def test_conversion_and_config():
    jcfg, jp, cfg, p = both(jax_cfg(cf=0.5, E=8, k=1))
    assert cfg.moe == moe.MoEConfig(num_experts=8, top_k=1,
                                    capacity_factor=0.5, router_noise=0.0,
                                    aux_loss_weight=0.01)
    m = p["blocks"]["moe"]
    assert set(m) == {"router_w", "w_in", "b_in", "w_out", "b_out"}
    assert m["w_in"].shape == (2, 8, 32, 128)
    for n, leaf in m.items():
        np.testing.assert_array_equal(leaf.numpy(), jp["blocks"]["moe"][n])
    # a bf16 serving tree keeps the router float32
    bf = dict(jp, blocks=dict(jp["blocks"], moe=dict(
        jp["blocks"]["moe"], w_in=jnp.asarray(jp["blocks"]["moe"]["w_in"],
                                              jnp.bfloat16))))
    got = convert.params_from_jax(jax.device_get(bf))["blocks"]["moe"]
    assert got["router_w"].dtype == torch.float32
    assert got["w_in"].dtype == torch.bfloat16
    # the reference's gelu-only check, in its words
    with pytest.raises(ValueError) as ref:
        jgpt.GPTConfig(activation="swiglu", moe=jmoe.MoEConfig())
    with pytest.raises(ValueError) as ours:
        gpt.GPTConfig(activation="swiglu", moe=moe.MoEConfig())
    assert str(ours.value) == str(ref.value)


def test_init_params_and_counts():
    """The MoE tree's size is its leaves' sum, the expert arithmetic
    written out here; ``count_params`` and ``flops_per_token`` are the
    JAX package's numbers, which count one dense FFN a block (kept for
    parity: the reference counts neither the experts nor the router)."""
    cfg = gpt.GPTConfig(vocab_size=32, hidden_size=32, num_layers=3,
                        num_heads=4, max_seq_len=16, dtype=torch.bfloat16,
                        moe=moe.MoEConfig(num_experts=4, top_k=2))
    p = gpt.init_params(cfg, seed=0, device="cpu")
    m = p["blocks"]["moe"]
    assert "fc_w" not in p["blocks"]
    assert m["router_w"].dtype == torch.float32
    assert m["w_in"].dtype == torch.bfloat16
    assert m["w_in"].shape == (3, 4, 32, 128)
    assert m["w_out"].shape == (3, 4, 128, 32)
    assert abs(float(m["w_in"].float().std()) - 0.02) < 2e-3
    n = sum(t.numel() for t in gpt.GPT(cfg, p).parameters())
    L, E, D, F, V, T = 3, 4, 32, 128, 32, 16
    experts = E * (2 * D * F + F + D) + D * E        # and the router
    attention = 4 * D + 3 * D * D + 3 * D + D * D + D  # norms, qkv, proj
    assert n == L * (experts + attention) + V * D + T * D + 2 * D
    jcfg = jgpt.GPTConfig(vocab_size=V, hidden_size=D, num_layers=L,
                          num_heads=4, max_seq_len=T,
                          moe=jmoe.MoEConfig(num_experts=E, top_k=2))
    assert gpt.count_params(cfg) == jgpt.count_params(jcfg)
    assert gpt.count_params(cfg) == n - L * (experts - (2 * D * F + F + D))
    for seq in (16, 2048):
        assert gpt.flops_per_token(cfg, seq) \
            == jgpt.flops_per_token(jcfg, seq)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_experts_match_jax(bits):
    """int8 / int4 expert stacks: values and scales bit-equal to JAX's
    quantization, the router left float; a decode step on the quantized
    tree within 1e-5 of JAX's (``woq.w`` on the [E, ...] stacks)."""
    jcfg, jp, cfg, p = both(jax_cfg(hidden_size=128, num_heads=4), seed=6,
                            std=0.05)
    jq = (jwoq.quantize_gpt_int8(jp) if bits == 8
          else jwoq.quantize_gpt_int4(jp, group_size=64))
    tq = (woq.quantize_gpt_int8(p) if bits == 8
          else woq.quantize_gpt_int4(p, group_size=64))
    jm, tm = jax.device_get(jq["blocks"]["moe"]), tq["blocks"]["moe"]
    assert set(tm) == set(jm) == {"router_w", "w_in", "w_in_s", "b_in",
                                  "w_out", "w_out_s", "b_out"}
    for n in tm:
        np.testing.assert_array_equal(tm[n].numpy(), np.asarray(jm[n]))
    assert tm["router_w"].dtype == torch.float32
    assert tm["w_in"].dtype == torch.int8
    assert woq.is_quantized(tq)
    toks = np.array([3, 7])
    lg, _ = G.decode_step(tq, G.init_cache(cfg, 2, 8, "cpu"),
                          torch.from_numpy(toks), 0, cfg)
    jlg, _ = JG.decode_step(jq, JG.init_cache(jcfg, 2, 8), jnp.asarray(toks),
                            0, jcfg)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=1e-5)
