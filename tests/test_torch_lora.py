"""LoRA in the port (paddle_tpu_torch/text/lora.py, the delta in
text/woq.py ``w``) against the JAX package's (paddle_tpu/text/lora.py),
on the CPU, in fp32:

* ``lora_init`` by law — its ``a`` comes from the port's ``rng.normal``,
  not ``jax.random``'s stream: ``b`` all zero, ``a``'s std
  ``(alpha / r) / sqrt(in)``, and an adapted model's logits equal the
  base model's bit for bit;
* split / join / stack / unstack round trips and their refusals, in the
  JAX package's words;
* the adapted forward on adapters carried from JAX (nonzero ``b``) within
  1e-5 of the JAX forward, and ``merge_lora``'s tree against the adapted
  forward (1e-5) and against JAX's merged weights; its int8 refusal;
* QLoRA over an int8 base: zero-``b`` decode equals the quantized base's,
  and an adapted int8 decode's logits equal JAX's within 1e-5;
* ``build_lora_train_step``: a 5-step AdamW trajectory from the same
  adapters, losses within 1e-5 and adapters within a tenth of lr of the
  JAX step's, the frozen base bit-unchanged and never a gradient leaf,
  and a QLoRA int8 step;
* QLoRA over an int4 base, adapters built in numpy at the logical shape
  (the shape both packages' ``woq.w`` take; the JAX ``lora_init`` shapes
  ``a`` by the packed rows, which its ``woq.w`` refuses — shown apart):
  decode logits and a two-step LoRA trajectory against JAX within 1e-5,
  and a pool-attached server over the int4 tree against the adapted
  tree's solo decode (the JAX pool refuses logical-shape rows).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.optimizer import AdamW as JAdamW
from paddle_tpu.text import generate as jG
from paddle_tpu.text import gpt as jgpt
from paddle_tpu.text import lora as jlora
from paddle_tpu.text import woq as jwoq
from paddle_tpu_torch import convert
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.text import generate as G
from paddle_tpu_torch.text import gpt, lora, woq

TOL = 1e-5
LR = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _pair(seed=0, **over):
    kw = dict(vocab_size=16, hidden_size=32, num_layers=2, num_heads=4,
              max_seq_len=32, dtype=jnp.float32)
    kw.update(over)
    jcfg = jgpt.GPTConfig(**kw)
    jp = jax.device_get(jgpt.init_params(jcfg, jax.random.PRNGKey(seed)))
    return jcfg, jp, convert.config_from_jax(jcfg), \
        convert.params_from_jax(jp)


def _jax_adapters(jp, jcfg, seed, rank=4, scale=0.05, targets=None):
    """A JAX adapter sub-tree with nonzero ``b`` (numpy draws), so the
    delta bites."""
    kw = {} if targets is None else {"targets": targets}
    ad = jax.device_get(jlora.split_lora(jlora.lora_init(
        jp, jcfg, rank=rank, key=jax.random.PRNGKey(seed), **kw))[1])
    rng = np.random.default_rng(seed)
    return {k: (scale * rng.standard_normal(v.shape).astype(np.float32)
                if k.endswith("_lora_b") else np.asarray(v))
            for k, v in ad.items()}


def _toks(seed, shape, vocab=16):
    return np.random.default_rng(seed).integers(0, vocab, shape)


def test_lora_init_by_law():
    """Zero b, a's std (alpha / r) / sqrt(in) per target (GQA's stacked
    kv_w and q_w too), float32 on the base's device, the key steering the
    draw; the adapted forward equals the base's bit for bit."""
    _, _, cfg, params = _pair(0, hidden_size=64, num_heads=4,
                              num_kv_heads=2)
    adapted = lora.lora_init(params, cfg, rank=8, key=3, alpha=16.0)
    for t in ("q_w", "kv_w", "proj_w"):
        a = adapted["blocks"][t + "_lora_a"]
        b = adapted["blocks"][t + "_lora_b"]
        w = params["blocks"][t]
        assert a.shape == w.shape[:-1] + (8,) and a.dtype == torch.float32
        assert b.shape == w.shape[:-2] + (8, w.shape[-1])
        assert not b.any()
        want = (16.0 / 8) / np.sqrt(w.shape[-2])
        assert abs(float(a.std()) / want - 1) < 0.1, t
        assert abs(float(a.mean())) < 0.1 * want, t
    assert "qkv_w_lora_a" not in adapted["blocks"]
    other = lora.lora_init(params, cfg, rank=8, key=4)
    assert not torch.equal(other["blocks"]["q_w_lora_a"],
                           adapted["blocks"]["q_w_lora_a"])
    toks = torch.as_tensor(_toks(0, (2, 8)))
    assert torch.equal(gpt.forward(params, toks, cfg),
                       gpt.forward(adapted, toks, cfg))


def test_split_join_stack_unstack_round_trips():
    jcfg, jp, cfg, params = _pair(0)
    ads = [convert.params_from_jax(_jax_adapters(jp, jcfg, i + 1))
           for i in range(3)]
    base, ad = lora.split_lora(lora.join_lora(params, ads[0]))
    assert set(ad) == set(ads[0]) and set(base["blocks"]) == set(
        params["blocks"])
    assert all(base["blocks"][k] is params["blocks"][k]
               for k in params["blocks"])
    stacked = lora.stack_adapters(ads)
    jstacked = jlora.stack_adapters([jax.device_get(
        {k: jnp.asarray(v.numpy()) for k, v in a.items()}) for a in ads])
    assert sorted(stacked) == sorted(jstacked)
    for k, v in stacked.items():
        assert v.shape[0] == 3 and v.dtype == torch.float32
        np.testing.assert_array_equal(v.numpy(), np.asarray(jstacked[k]))
    for orig, got in zip(ads, lora.unstack_adapters(stacked)):
        assert set(orig) == set(got)
        for k in orig:
            assert torch.equal(orig[k], got[k])


def _raises_as_jax(fn, jfn, exc=ValueError):
    with pytest.raises(exc) as mine:
        fn()
    with pytest.raises(exc) as theirs:
        jfn()
    assert str(mine.value) == str(theirs.value)


def test_stack_refusals_match_jax():
    jcfg, jp, _, _ = _pair(0)
    a4 = _jax_adapters(jp, jcfg, 1, rank=4)
    a8 = _jax_adapters(jp, jcfg, 2, rank=8)
    missing = {k: v for k, v in a4.items() if not k.startswith("proj_w")}
    t4, t8, tm = (convert.params_from_jax(a) for a in (a4, a8, missing))
    _raises_as_jax(lambda: lora.stack_adapters([]),
                   lambda: jlora.stack_adapters([]))
    _raises_as_jax(lambda: lora.stack_adapters([t4, t8]),
                   lambda: jlora.stack_adapters([a4, a8]))
    _raises_as_jax(lambda: lora.stack_adapters([t4, tm]),
                   lambda: jlora.stack_adapters([a4, missing]))
    z = np.zeros((2, 4, 4))
    _raises_as_jax(lambda: lora.stack_adapters([{"qkv_w": torch.tensor(z)}]),
                   lambda: jlora.stack_adapters([{"qkv_w": z}]))
    bad = {"a_lora_a": np.zeros((2, 3)), "b_lora_b": np.zeros((3, 3))}
    _raises_as_jax(lambda: lora.unstack_adapters(
        {k: torch.tensor(v) for k, v in bad.items()}),
        lambda: jlora.unstack_adapters(bad))
    _raises_as_jax(lambda: lora.unstack_adapters({}),
                   lambda: jlora.unstack_adapters({}))


@pytest.mark.parametrize("targets", [None, ("qkv_w", "proj_w", "fc_w",
                                             "out_w")], ids=["attn", "all"])
def test_adapted_forward_and_merge_match_jax(targets):
    """JAX's adapters carried across: the adapted forward within 1e-5 of
    JAX's; ``merge_lora``'s weights JAX's merged ones within 1e-6, no lora
    leaf left, and its forward the adapted forward's."""
    jcfg, jp, cfg, params = _pair(4)
    jad = _jax_adapters(jp, jcfg, 5, scale=0.3, targets=targets)
    adapted = lora.join_lora(params, convert.params_from_jax(jad))
    jadapted = jlora.join_lora(jp, jad)
    toks = _toks(1, (2, 6))
    want = np.asarray(jgpt.forward(jadapted, jnp.asarray(toks), jcfg))
    got = gpt.forward(adapted, torch.as_tensor(toks), cfg)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    base = gpt.forward(params, torch.as_tensor(toks), cfg)
    assert float((got - base).abs().max()) > 1e-2     # the delta bites
    merged = lora.merge_lora(adapted)
    jmerged = jax.device_get(jlora.merge_lora(jadapted))
    assert not any(k.endswith(("_lora_a", "_lora_b"))
                   for k in merged["blocks"])
    for k, v in merged["blocks"].items():
        np.testing.assert_allclose(v.numpy(), jmerged["blocks"][k],
                                   atol=1e-6, rtol=0, err_msg=k)
    np.testing.assert_allclose(
        gpt.forward(merged, torch.as_tensor(toks), cfg).numpy(),
        got.numpy(), atol=TOL, rtol=0)


def test_merge_on_quantized_base_raises_as_jax():
    jcfg, jp, cfg, params = _pair(9)
    q = lora.lora_init(woq.quantize_gpt_int8(params), cfg, rank=2)
    jq = jlora.lora_init(jwoq.quantize_gpt_int8(jp), jcfg, rank=2)
    _raises_as_jax(lambda: lora.merge_lora(q),
                   lambda: jlora.merge_lora(jq), NotImplementedError)


def test_qlora_int8_decode_matches_jax():
    """Zero-b adapters over an int8 base decode the quantized base's
    tokens; nonzero ones (carried from JAX) give JAX's decode logits
    within 1e-5, each position through ``generate.decode_step``."""
    jcfg, jp, cfg, params = _pair(7)
    qbase = woq.quantize_gpt_int8(params)
    zero = lora.lora_init(qbase, cfg, rank=4, key=8)
    prompt = torch.tensor([[3, 1]])
    assert torch.equal(G.generate(qbase, cfg, prompt, max_new_tokens=5,
                                  device="cpu"),
                       G.generate(zero, cfg, prompt, max_new_tokens=5,
                                  device="cpu"))
    jq = jax.device_get(jwoq.quantize_gpt_int8(jp))
    jad = _jax_adapters(jp, jcfg, 8, scale=0.3)
    adapted = lora.join_lora(convert.params_from_jax(jq),
                             convert.params_from_jax(jad))
    jadapted = jlora.join_lora(jq, jad)
    cache = G.init_cache(cfg, 2, 16, "cpu")
    jcache = jG.init_cache(jcfg, 2, 16)
    toks = _toks(2, (2, 6))
    for pos in range(6):
        lt, cache = G.decode_step(adapted, cache,
                                  torch.as_tensor(toks[:, pos]), pos, cfg)
        lj, jcache = jG.decode_step(jadapted, jcache,
                                    jnp.asarray(toks[:, pos]), pos, jcfg)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=TOL,
                                   rtol=0)


def _trajectory_pair(jcfg, jp, cfg, params, jad, steps, seed):
    """The same adapters and one repeated token batch through both
    packages' LoRA steps: (port losses, JAX losses, port state, JAX
    state)."""
    jinit, jstep = jlora.build_lora_train_step(jcfg, JAdamW(
        learning_rate=LR))
    jstate = jinit(jlora.join_lora(jp, jad))
    init, step = lora.build_lora_train_step(cfg, AdamW(learning_rate=LR))
    state = init(lora.join_lora(params, convert.params_from_jax(jad)))
    losses, jlosses = [], []
    toks = _toks(seed, (4, 9))
    for _ in range(steps):
        jstate, jl = jstep(jstate, jnp.asarray(toks, jnp.int32), LR)
        state, l = step(state, toks, LR)
        jlosses.append(float(jl))
        losses.append(float(l))
    return losses, jlosses, state, jax.device_get(jstate)


def test_train_step_trajectory_matches_jax():
    """Five AdamW steps on the attention and MLP adapters: losses within
    1e-5 of JAX's, every adapter element within lr / 10, the frozen base
    the same tensors, bit-unchanged, and never a gradient leaf."""
    jcfg, jp, cfg, params = _pair(3)
    jad = _jax_adapters(jp, jcfg, 11, scale=0.05,
                        targets=("qkv_w", "proj_w", "fc_w", "out_w"))
    before = {k: v.clone() for k, v in params["blocks"].items()}
    losses, jlosses, state, jstate = _trajectory_pair(
        jcfg, jp, cfg, params, jad, 5, 20)
    np.testing.assert_allclose(losses, jlosses, atol=TOL, rtol=0)
    assert losses[-1] < losses[0]
    assert int(state.step) == 5
    for k, v in state.adapters.items():
        np.testing.assert_allclose(v.numpy(), jstate.adapters[k],
                                   atol=LR / 10, rtol=0, err_msg=k)
        assert not v.requires_grad
        assert float((v - torch.as_tensor(jad[k])).abs().max()) > 0, k
    for k, v in state.base["blocks"].items():
        assert v is params["blocks"][k]
        assert torch.equal(v, before[k]) and not v.requires_grad, k
        assert v.grad is None


def test_qlora_int8_train_step_matches_jax():
    """One step over an int8 base: the loss JAX's within 1e-5, the int8
    weights outside the trainable tree and unchanged."""
    jcfg, jp, _, _ = _pair(6)
    jq = jax.device_get(jwoq.quantize_gpt_int8(jp))
    cfg = convert.config_from_jax(jcfg)
    q = convert.params_from_jax(jq)
    jad = _jax_adapters(jp, jcfg, 12, scale=0.05)
    losses, jlosses, state, _ = _trajectory_pair(jcfg, jq, cfg, q, jad, 2,
                                                 40)
    np.testing.assert_allclose(losses, jlosses, atol=TOL, rtol=0)
    assert not any(k in state.adapters for k in ("qkv_w", "proj_w"))
    assert state.base["blocks"]["qkv_w"].dtype == torch.int8
    assert torch.equal(state.base["blocks"]["qkv_w"], q["blocks"]["qkv_w"])
    with pytest.raises(ValueError, match="no lora leaves"):
        lora.build_lora_train_step(cfg, AdamW())[0](q)


# ---------------------------------------------------------------------------
# QLoRA over an int4 base.  The adapters are built in numpy at each
# target's LOGICAL shape ([L, ..., in, out], ``woq.logical_shape``), the
# shape both packages' ``woq.w`` add the delta at.  The JAX ``lora_init``
# shapes ``a`` by the packed int4 rows ([..., in / 2, r]), which its own
# ``woq.w`` then cannot broadcast; the port's ``lora_init`` takes the
# logical rows.  These tests hold the port to the logical shape — the one
# on which the JAX forward runs at all — and show the JAX init's shape
# apart.
# ---------------------------------------------------------------------------


def _int4_pair(seed):
    """A hidden-64 model and its int4 tree (group size 32), both
    packages (the quantized trees are bit-identical)."""
    jcfg, jp, cfg, params = _pair(seed, hidden_size=64)
    jq = jax.device_get(jwoq.quantize_gpt_int4(jp, group_size=32))
    q = woq.quantize_gpt_int4(params, group_size=32)
    for k, v in convert.params_from_jax(jq)["blocks"].items():
        assert torch.equal(v, q["blocks"][k]), k
    return jcfg, jq, cfg, q


def _logical_adapters(q, seed, rank=4, scale=0.3, zero_b=False,
                      targets=("qkv_w", "proj_w")):
    """numpy adapters at each target's logical shape: ``a`` kaiming-scaled,
    ``b`` drawn (or zero)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name in targets:
        shp = woq.logical_shape(q["blocks"], name)
        out[name + "_lora_a"] = (rng.standard_normal(shp[:-1] + (rank,))
                                 / np.sqrt(shp[-2])).astype(np.float32)
        out[name + "_lora_b"] = (
            np.zeros(shp[:-2] + (rank, shp[-1]), np.float32) if zero_b
            else (scale * rng.standard_normal(shp[:-2] + (rank, shp[-1])))
            .astype(np.float32))
    return out


def test_lora_init_on_int4_shapes_a_by_logical_rows():
    """The port's ``lora_init`` on an int4 base shapes ``a`` by the
    logical rows, and its forward runs; the JAX ``lora_init`` shapes it by
    the packed rows (half), which the JAX ``woq.w`` refuses — the reason
    the int4 tests below build their adapters in numpy."""
    jcfg, jq, cfg, q = _int4_pair(13)
    tree = lora.lora_init(q, cfg, rank=4, key=3)
    jtree = jax.device_get(jlora.lora_init(jq, jcfg, rank=4,
                                           key=jax.random.PRNGKey(3)))
    for name in ("qkv_w", "proj_w"):
        logical = woq.logical_shape(q["blocks"], name)
        assert tuple(tree["blocks"][name + "_lora_a"].shape) == \
            logical[:-1] + (4,)
        assert tuple(jtree["blocks"][name + "_lora_a"].shape) == \
            logical[:-2] + (logical[-2] // 2, 4)
    cache = G.init_cache(cfg, 1, 8, "cpu")
    logits, _ = G.decode_step(tree, cache, torch.tensor([3]), 0, cfg)
    assert torch.isfinite(logits).all()
    with pytest.raises(Exception):
        jG.decode_step(jtree, jG.init_cache(jcfg, 1, 8), jnp.asarray([3]),
                       0, jcfg)


def test_qlora_int4_decode_matches_jax():
    """Zero-b adapters over an int4 base decode the int4 base's tokens;
    drawn ones give the JAX decode's logits within 1e-5 at every
    position."""
    jcfg, jq, cfg, q = _int4_pair(7)
    zero = lora.join_lora(q, convert.params_from_jax(
        _logical_adapters(q, 8, zero_b=True)))
    prompt = torch.tensor([[3, 1]])
    assert torch.equal(G.generate(q, cfg, prompt, max_new_tokens=5,
                                  device="cpu"),
                       G.generate(zero, cfg, prompt, max_new_tokens=5,
                                  device="cpu"))
    ad = _logical_adapters(q, 9)
    adapted = lora.join_lora(q, convert.params_from_jax(ad))
    jadapted = jlora.join_lora(jq, ad)
    cache = G.init_cache(cfg, 2, 16, "cpu")
    jcache = jG.init_cache(jcfg, 2, 16)
    toks = _toks(4, (2, 6))
    base_cache = G.init_cache(cfg, 2, 16, "cpu")
    moved = 0.0
    for pos in range(6):
        lt, cache = G.decode_step(adapted, cache,
                                  torch.as_tensor(toks[:, pos]), pos, cfg)
        lj, jcache = jG.decode_step(jadapted, jcache,
                                    jnp.asarray(toks[:, pos]), pos, jcfg)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=TOL,
                                   rtol=0)
        lb, base_cache = G.decode_step(q, base_cache,
                                       torch.as_tensor(toks[:, pos]), pos,
                                       cfg)
        moved = max(moved, float((lt - lb).abs().max()))
    assert moved > 1e-3                       # the delta bites


def test_qlora_int4_train_step_matches_jax():
    """Two LoRA steps over an int4 base: losses within 1e-5 of JAX's, the
    int4 weights outside the trainable tree and unchanged, every adapter
    within lr / 10 of JAX's."""
    jcfg, jq, cfg, q = _int4_pair(6)
    ad = _logical_adapters(q, 12, scale=0.05)
    before = {k: v.clone() for k, v in q["blocks"].items()}
    losses, jlosses, state, jstate = _trajectory_pair(jcfg, jq, cfg, q, ad,
                                                      2, 40)
    np.testing.assert_allclose(losses, jlosses, atol=TOL, rtol=0)
    assert state.base["blocks"]["qkv_w"].dtype == torch.int8
    for k, v in state.base["blocks"].items():
        assert torch.equal(v, before[k]), k
    for k, v in state.adapters.items():
        np.testing.assert_allclose(v.numpy(), jstate.adapters[k],
                                   atol=LR / 10, rtol=0, err_msg=k)


def test_served_adapter_pool_over_int4_matches_adapted_decode():
    """A pool-attached server over the int4 tree: a base request is the
    int4 base's stream and an adapted one the adapted int4 tree's solo
    greedy decode (whose logits the test above holds to JAX's), on both
    layouts.  The JAX pool is not the reference here: it sizes its rows
    by the packed int4 rows and refuses logical-shape adapters."""
    from paddle_tpu_torch.text import adapters as A
    from paddle_tpu_torch.text import serving

    jcfg, jq, cfg, q = _int4_pair(5)
    ad = convert.params_from_jax(_logical_adapters(q, 21))
    adapted = lora.join_lora(q, ad)

    def solo(tree, prompt, n):
        cache = G.init_cache(cfg, 1, cfg.max_seq_len, "cpu")
        out, tok = [], None
        for pos in range(len(prompt) + n - 1):
            cur = prompt[pos] if pos < len(prompt) else tok
            lg, cache = G.decode_step(tree, cache, torch.tensor([cur]), pos,
                                      cfg)
            if pos >= len(prompt) - 1:
                tok = int(lg[0].argmax())
                out.append(tok)
        return out

    prompts = [[1, 5, 7, 3, 2], [4, 8, 9, 1]]
    want = [solo(q, prompts[0], 6), solo(adapted, prompts[1], 6)]
    assert want[1] != solo(q, prompts[1], 6)
    for layout in ("contiguous", "paged"):
        pool = A.AdapterPool(q, cfg, rank=4, max_adapters=2)
        pool.register("w4", ad)
        kw = {"block_size": 8} if layout == "paged" else {}
        srv = serving.DecodeServer(q, cfg, max_batch=2, max_len=32,
                                   device="cpu", layout=layout,
                                   adapter_pool=pool, **kw)
        rids = [srv.submit(prompts[0], max_new_tokens=6),
                srv.submit(prompts[1], max_new_tokens=6, adapter="w4")]
        while srv.pending():
            srv.tick()
        got = [[int(t) for t in srv.result(r)] for r in rids]
        srv.close()
        assert got == want, layout
