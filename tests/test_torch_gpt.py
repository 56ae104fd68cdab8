"""The port's GPT (paddle_tpu_torch/text/gpt.py) against the JAX
package's: the same weights (carried across by ``convert.params_from_jax``)
and the same numpy tokens must give the same logits over the
architecture grid {learned, rope} x {layernorm, rmsnorm} x {gelu, swiglu}
x {MHA, GQA}.  fp32 configs, 2 layers: atol 1e-4 on the logits
(summation order differs between XLA's and PyTorch's CPU matmuls).
"""
import dataclasses
import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.text import gpt as jgpt
from paddle_tpu.text import moe as jmoe
from paddle_tpu_torch import convert
from paddle_tpu_torch.text import gpt

GRID = list(itertools.product(["learned", "rope"], ["layernorm", "rmsnorm"],
                              ["gelu", "swiglu"], [None, 2]))


def _jcfg(pos_embed="learned", norm="layernorm", activation="gelu",
          num_kv_heads=None, **kw):
    base = dict(vocab_size=64, hidden_size=64, num_layers=2, num_heads=4,
                max_seq_len=32, dtype=jnp.float32, pos_embed=pos_embed,
                norm=norm, activation=activation, num_kv_heads=num_kv_heads)
    base.update(kw)
    return jgpt.GPTConfig(**base)


@pytest.mark.parametrize("pos_embed,norm,activation,kvh", GRID)
def test_forward_logits_match_jax(pos_embed, norm, activation, kvh):
    jcfg = _jcfg(pos_embed, norm, activation, kvh)
    jp = jgpt.init_params(jcfg, jax.random.PRNGKey(1))
    cfg = convert.config_from_jax(jcfg)
    params = convert.params_from_jax(jax.device_get(jp))
    toks = np.random.default_rng(0).integers(0, 64, (2, 12))
    ref = np.asarray(jgpt.forward(jp, jnp.asarray(toks), jcfg))
    out = gpt.forward(params, torch.from_numpy(toks), cfg)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("pos_embed,norm,activation,kvh",
                         [GRID[0], GRID[-1]])
def test_init_params_tree_matches_jax(pos_embed, norm, activation, kvh):
    """Same names, shapes and parameter count as the JAX tree; the module
    reads like the dict and computes the same forward."""
    jcfg = _jcfg(pos_embed, norm, activation, kvh)
    cfg = convert.config_from_jax(jcfg)
    jp = jgpt.init_params(jcfg, jax.random.PRNGKey(0))
    tp = gpt.init_params(cfg, seed=0, device="cpu")
    flat = lambda t: {f"blocks.{k}" if n == "blocks" else n:  # noqa: E731
                      tuple(v.shape)
                      for n, sub in t.items()
                      for k, v in (sub.items() if n == "blocks"
                                   else [(n, sub)])}
    assert flat(tp) == flat(jax.device_get(jp))
    assert gpt.count_params(cfg) == jgpt.count_params(jcfg) \
        == sum(t.numel() for t in gpt.GPT(cfg, tp).parameters())
    m = gpt.GPT(cfg, tp)
    toks = torch.randint(0, 64, (1, 7), generator=torch.Generator()
                         .manual_seed(0))
    assert torch.equal(m(toks), gpt.forward(tp, toks, cfg))
    assert m["blocks"] is m.blocks and m["wte"] is m.wte
    with pytest.raises(KeyError):
        m["nope"]


def test_init_params_is_seeded_and_scaled():
    cfg = convert.config_from_jax(_jcfg(num_layers=4))
    a = gpt.init_params(cfg, seed=3, device="cpu")
    assert a["blocks"]["proj_w"].dtype == torch.float32
    bf16 = dataclasses.replace(cfg, dtype=torch.bfloat16)
    b = gpt.init_params(bf16, seed=3, device="cpu")
    assert torch.equal(a["wte"].to(torch.bfloat16), b["wte"])
    assert b["blocks"]["proj_w"].dtype == torch.bfloat16
    assert torch.equal(gpt.init_params(cfg, seed=3, device="cpu")["wte"],
                       a["wte"])
    assert abs(a["wte"].std().item() - 0.02) < 2e-3
    assert abs(a["blocks"]["out_w"].std().item()
               - 0.02 / np.sqrt(8)) < 1e-3


def test_config_from_jax_maps_fields():
    jcfg = jgpt.gpt_1p3b()
    cfg = convert.config_from_jax(jcfg)
    ref = gpt.gpt_1p3b()
    assert cfg == ref and cfg.dtype == torch.bfloat16
    assert gpt.count_params(ref) == jgpt.count_params(jcfg)
    # an MoE config: both count one dense FFN a block (kept for parity)
    jmoe_cfg = dataclasses.replace(jcfg, moe=jmoe.MoEConfig())
    assert gpt.count_params(convert.config_from_jax(jmoe_cfg)) \
        == jgpt.count_params(jmoe_cfg) == jgpt.count_params(jcfg)
    assert convert.config_from_jax(_jcfg()).dtype == torch.float32


def _generate_ref_jcfg():
    """The reference config of tests/test_generate.py: fp32, head_dim 8,
    ``use_flash=False``."""
    return jgpt.GPTConfig(vocab_size=64, hidden_size=32, num_layers=2,
                          num_heads=4, max_seq_len=32, dtype=jnp.float32,
                          use_flash=False)


def test_config_from_jax_carries_use_flash_false():
    """``use_flash`` reaches no math in either package (attention routes by
    shape), so the port takes the JAX config's value as it is."""
    jcfg = _generate_ref_jcfg()
    cfg = convert.config_from_jax(jcfg)
    assert cfg.use_flash is False
    for f in ("vocab_size", "hidden_size", "num_layers", "num_heads",
              "max_seq_len", "ffn_ratio", "num_kv_heads"):
        assert getattr(cfg, f) == getattr(jcfg, f)
    assert cfg.dtype == torch.float32
    assert gpt.GPTConfig(use_flash=False).use_flash is False


@pytest.mark.parametrize("use_flash", [False, True])
def test_use_flash_false_logits_match_jax(use_flash):
    """The port's fp32 logits on the use_flash=False reference config, with
    the JAX weights carried over, equal the JAX package's (atol 1e-4: CPU
    matmul summation order), and the field changes nothing in the port."""
    jcfg = _generate_ref_jcfg()
    jp = jgpt.init_params(jcfg, jax.random.PRNGKey(0))
    toks = np.random.default_rng(0).integers(0, 64, (2, 8))
    ref = np.asarray(jgpt.forward(jp, jnp.asarray(toks), jcfg))
    cfg = dataclasses.replace(convert.config_from_jax(jcfg),
                              use_flash=use_flash)
    params = convert.params_from_jax(jax.device_get(jp))
    out = gpt.forward(params, torch.from_numpy(toks), cfg)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=0)


def test_apply_rope_per_row_positions():
    """[B, T] positions (the serving step: one position per slot) rotate
    each batch row as the shared-[T] form rotates that row alone."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((3, 1, 2, 16)).astype(np.float32))
    pos = torch.tensor([[0], [5], [17]])
    both = gpt.apply_rope(x, pos)
    for b in range(3):
        one = gpt.apply_rope(x[b:b + 1], pos[b])
        torch.testing.assert_close(both[b:b + 1], one, rtol=0, atol=0)
    ref = jgpt.apply_rope(jnp.asarray(x.numpy()[1:2]), jnp.asarray([5]))
    np.testing.assert_allclose(both[1:2].numpy(), np.asarray(ref), atol=1e-6)
