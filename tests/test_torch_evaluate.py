"""Evaluation in the port (paddle_tpu_torch/text/evaluate.py) against the
JAX package's (paddle_tpu/text/evaluate.py), on the CPU, on the session's
``markov_gpt`` (tests/conftest.py) carried across in fp32:

* ``nll`` / ``perplexity`` on the model's rule stream and on random
  tokens, and on its int8, int4 and LoRA-adapted trees: within 1e-5 of
  JAX's (perplexity: relative 2e-5);
* ``cached_nll`` (the decode path, one position at a time) within 1e-5 of
  JAX's, and of the port's own ``nll`` to the reference's 5e-2;
* a list of batches accumulates token-weighted, as one batch;
* a batch that is not [B, T + 1] with T >= 1 raises, in JAX's words;
* the int8-KV ``cached_perplexity`` delta: JAX's within 1e-4 and under
  the reference's 5%.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.text import evaluate as jev
from paddle_tpu.text import lora as jlora
from paddle_tpu.text import woq as jwoq
from paddle_tpu_torch import convert
from paddle_tpu_torch.text import evaluate as ev
from paddle_tpu_torch.text import lora, woq

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def model(markov_gpt):
    """The session model in fp32 in both packages."""
    jcfg, jp = markov_gpt
    jcfg = dataclasses.replace(jcfg, dtype=jnp.float32)
    jp = jax.device_get(jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float32), jp))
    return jcfg, jp, convert.config_from_jax(jcfg), \
        convert.params_from_jax(jp)


def _rule_batch(rng, B, T):
    t = rng.integers(0, 13, (B, 1))
    rows = [t]
    for _ in range(T):
        t = (t * 3 + 1) % 13
        rows.append(t)
    return np.concatenate(rows, 1)


def _lora_pair(jcfg, jp):
    jad = jax.device_get(jlora.split_lora(jlora.lora_init(
        jp, jcfg, rank=4, key=jax.random.PRNGKey(2)))[1])
    rng = np.random.default_rng(2)
    jad = {k: (0.1 * rng.standard_normal(v.shape).astype(np.float32)
               if k.endswith("_lora_b") else v) for k, v in jad.items()}
    return jlora.join_lora(jp, jad), convert.params_from_jax(jad)


@pytest.mark.parametrize("tree", ["float", "int8", "int4", "lora"])
def test_nll_and_perplexity_match_jax(model, tree):
    jcfg, jp, cfg, params = model
    if tree == "int8":
        jp, params = jwoq.quantize_gpt_int8(jp), woq.quantize_gpt_int8(params)
    elif tree == "int4":
        jp, params = (jwoq.quantize_gpt_int4(jp, 32),
                      woq.quantize_gpt_int4(params, 32))
    elif tree == "lora":
        jp, ad = _lora_pair(jcfg, jp)
        params = lora.join_lora(params, ad)
    rng = np.random.default_rng(1)
    on_rule = _rule_batch(rng, 8, 16)
    random_toks = rng.integers(0, 13, (8, 17))
    for batch in (on_rule, random_toks):
        a, b = ev.nll(params, cfg, batch), jev.nll(jp, jcfg, batch)
        assert abs(a - b) < TOL, (a, b)
        pa, pb = ev.perplexity(params, cfg, batch), \
            jev.perplexity(jp, jcfg, batch)
        assert abs(pa - pb) / pb < 2 * TOL, (pa, pb)
    if tree == "float":
        assert ev.perplexity(params, cfg, on_rule) < 1.6
        assert ev.perplexity(params, cfg, random_toks) > 5.0


def test_cached_nll_matches_jax_and_the_forward(model):
    jcfg, jp, cfg, params = model
    batch = _rule_batch(np.random.default_rng(5), 4, 16)
    c, jc = ev.cached_nll(params, cfg, batch), jev.cached_nll(jp, jcfg,
                                                              batch)
    assert abs(c - jc) < TOL, (c, jc)
    assert abs(c - ev.nll(params, cfg, batch)) < 5e-2
    pa, pb = ev.cached_perplexity(params, cfg, batch), \
        jev.cached_perplexity(jp, jcfg, batch)
    assert abs(pa - pb) / pb < 2 * TOL, (pa, pb)


def test_nll_accumulates_over_batches(model):
    jcfg, jp, cfg, params = model
    rng = np.random.default_rng(3)
    a, b = _rule_batch(rng, 4, 16), _rule_batch(rng, 2, 10)
    joint = ev.nll(params, cfg, [a, b])
    n_a, n_b = a.shape[0] * (a.shape[1] - 1), b.shape[0] * (b.shape[1] - 1)
    weighted = (ev.nll(params, cfg, a) * n_a
                + ev.nll(params, cfg, b) * n_b) / (n_a + n_b)
    assert abs(joint - weighted) < 1e-6
    assert abs(joint - jev.nll(jp, jcfg, [a, b])) < TOL
    assert abs(ev.cached_nll(params, cfg, (a, b))
               - jev.cached_nll(jp, jcfg, [a, b])) < TOL


@pytest.mark.parametrize("bad", [np.zeros((4, 1), np.int32),
                                 np.zeros((5,), np.int32),
                                 np.zeros((2, 3, 4), np.int32)],
                         ids=["T=0", "1-d", "3-d"])
def test_bad_batch_shapes_are_loud(model, bad):
    jcfg, jp, cfg, params = model
    for fn in (ev.nll, ev.cached_nll):
        with pytest.raises(ValueError, match="T >= 1"):
            fn(params, cfg, bad)
    with pytest.raises(ValueError, match="T >= 1"):
        jev.nll(jp, jcfg, bad)


def test_int8_kv_cached_delta_matches_jax(model, monkeypatch):
    """The decode path's perplexity under ``PADDLE_TPU_KV_DTYPE=int8``:
    the JAX package's within 1e-4, and within 5% of the exact cache's."""
    jcfg, jp, cfg, params = model
    batch = _rule_batch(np.random.default_rng(6), 4, 16)
    ppl_f = ev.cached_perplexity(params, cfg, batch)
    monkeypatch.setenv("PADDLE_TPU_KV_DTYPE", "int8")
    jev._EVAL_CACHE.clear()
    try:
        ppl_q = ev.cached_perplexity(params, cfg, batch)
        jppl_q = jev.cached_perplexity(jp, jcfg, batch)
    finally:
        jev._EVAL_CACHE.clear()
    assert abs(ppl_q - jppl_q) < 1e-4, (ppl_q, jppl_q)
    assert ppl_q != ppl_f
    assert abs(ppl_q - ppl_f) / ppl_f < 0.05, (ppl_f, ppl_q)
