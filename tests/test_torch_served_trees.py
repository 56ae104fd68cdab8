"""The trees the smoke's GPT-1.3B arms serve on the card, served by both
packages' ``DecodeServer`` on the CPU and held to the JAX package's
tokens exactly, on small fp32 models:

* an int4 weight-only tree (``quantize_gpt_int4``, group 32, quantized
  by the JAX package and carried over) on the paged layout, and on the
  contiguous one beside it — with the port's W4 kernel flag on and off
  (the JAX server has no such route off its TPU kernel: its ``woq.w``
  dequantizes either way);
* a GQA model (4 query heads over 1 kv head: the 1.3B GQA arm's G = 4)
  under ``PADDLE_TPU_KV_DTYPE=int8``, on both layouts; its float-KV
  twin beside it.

Both packages' paged servers hand out blocks from one allocator design,
so the streams are compared whole.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.text import gpt as jgpt
from paddle_tpu.text import serving as jserving
from paddle_tpu.text import woq as jwoq
from paddle_tpu_torch import convert
from paddle_tpu_torch.text import serving


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _model(seed, **over):
    kw = dict(vocab_size=64, hidden_size=128, num_layers=2, num_heads=2,
              max_seq_len=96, dtype=jnp.float32)
    kw.update(over)
    jcfg = jgpt.GPTConfig(**kw)
    jp = jax.device_get(jgpt.init_params(jcfg, jax.random.PRNGKey(seed)))
    return jcfg, jp


def _layout(layout):
    kw = dict(max_batch=3, max_len=64, layout=layout)
    if layout == "paged":
        kw.update(block_size=8, num_blocks=24)
    return kw


def _serve(srv, prompts, new=10):
    rids = [srv.submit(p, max_new_tokens=new) for p in prompts]
    for _ in range(400):
        if not srv.pending():
            break
        srv.tick()
    assert not srv.pending()
    out = [[int(t) for t in srv.result(r)] for r in rids]
    srv.close()
    return out


def _both(jcfg, jp, layout, prompts):
    """(JAX tokens, port tokens) of one serve of ``prompts``."""
    ref = _serve(jserving.DecodeServer(jp, jcfg, **_layout(layout)), prompts)
    cfg, params = convert.config_from_jax(jcfg), convert.params_from_jax(jp)
    got = _serve(serving.DecodeServer(params, cfg, device="cpu",
                                      **_layout(layout)), prompts)
    return ref, got


def _prompts(seed, lens, hi=60):
    rng = np.random.default_rng(seed)
    return [[int(x) for x in rng.integers(1, hi, n)] for n in lens]


@pytest.mark.parametrize("w4", ["0", "1"])
@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_int4_tree_serves_jax_tokens(layout, w4, monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_KV_DTYPE", raising=False)
    monkeypatch.setenv("PADDLE_TPU_W4_KERNEL", w4)
    jcfg, jp = _model(7)
    jq = jax.device_get(jwoq.quantize_gpt_int4(jp, group_size=32))
    # five requests through three slots: the pool recycles blocks
    ref, got = _both(jcfg, jq, layout, _prompts(3, (5, 19, 11, 30, 8)))
    assert got == ref
    assert all(len(s) == 10 for s in got)


@pytest.mark.parametrize("kv", ["int8", ""])
@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_gqa_int8_kv_serves_jax_tokens(layout, kv, monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_W4_KERNEL", raising=False)
    monkeypatch.setenv("PADDLE_TPU_KV_DTYPE", kv)   # read at the cache's init
    jcfg, jp = _model(11, hidden_size=256, num_heads=4, num_kv_heads=1,
                      pos_embed="rope")
    ref, got = _both(jcfg, jp, layout, _prompts(4, (6, 23, 14, 33, 9)))
    assert got == ref
    assert all(len(s) == 10 for s in got)
