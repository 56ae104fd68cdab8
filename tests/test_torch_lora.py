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
  and a QLoRA int8 step.
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
