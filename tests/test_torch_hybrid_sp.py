"""The port's ``sp`` axis in the hybrid train step (ring attention over
the sequence chunks, paddle_tpu_torch/text/gpt_hybrid.py) against the
JAX package, on the CPU: the twins of the reference's sp loss tests
(tests/test_gpt_hybrid.py:142-158, :431-460), its long-context
composition (:372-393) and its GQA sp loss (:653-665).

The port's ranks are 8 gloo CPU processes running ``meta[
"loss_and_grads"]`` (kind "grads" of ``tools/hybrid_check.py``) on the
same numpy params and tokens that JAX's ``make_pipeline_gpt_loss`` runs
under ``shard_map`` on its 8-device mesh; the gradients are held against
``jax.grad`` of the dense loss.  fp32 throughout.  Tolerances: losses
rtol 2e-5 (GQA 3e-5, the reference's; the T = 2049 composition 5e-5,
the reference's), gradients rtol 5e-4 / atol 1e-6 (the pipeline's in
test_torch_hybrid.py).
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from paddle_tpu.compat import shard_map
from paddle_tpu.text import gpt as jgpt
from paddle_tpu.text import gpt_hybrid as jhybrid
from paddle_tpu_torch import convert

from test_torch_hybrid import (
    JCFG, _gqa_jcfg, dense_params, fetch, get, leaves, mesh_of,
    ranks_in_background, tokens)

LONG = jgpt.GPTConfig(vocab_size=64, hidden_size=32, num_layers=2,
                      num_heads=2, max_seq_len=2048, sp_sub_block=64,
                      dtype=jnp.float32)

# name: (jax config, mesh shape, mesh names, n_micro, zigzag, loss rtol)
RUNS = {
    "dp2_sp2_mp2": (JCFG, (2, 2, 2), ("dp", "sp", "mp"), 1, False, 2e-5),
    "dp2_sp2_mp2_zigzag": (JCFG, (2, 2, 2), ("dp", "sp", "mp"), 1, True,
                           2e-5),
    "dp2_sp4_zigzag": (JCFG, (2, 4), ("dp", "sp"), 1, True, 2e-5),
    "gqa_dp2_sp2_mp2": (_gqa_jcfg(), (2, 2, 2), ("dp", "sp", "mp"), 1,
                        False, 3e-5),
    "long_pp2_sp2_mp2_zigzag": (LONG, (2, 2, 2), ("pp", "sp", "mp"), 2,
                                True, 5e-5),
}


def _toks(name, jcfg):
    if name.startswith("long"):
        return np.random.default_rng(7).integers(
            0, jcfg.vocab_size, (2, 2049)).astype(np.int32)
    return tokens(jcfg)


def _jax_loss(jcfg, shape, names, n_micro, zigzag):
    mesh = mesh_of(shape, names)
    raw = jhybrid.make_pipeline_gpt_loss(jcfg, mesh, n_micro=n_micro,
                                         sp_zigzag=zigzag)
    specs = jgpt.param_shardings(
        jcfg, mp="mp" if "mp" in names else None,
        pp="pp" if "pp" in names else None)
    tok_spec = P("dp") if "dp" in names else P()
    return shard_map(raw, mesh=mesh, in_specs=(specs, tok_spec, P()),
                     out_specs=P(), check_vma=False)


@pytest.fixture(scope="module")
def runs():
    params, cases = {}, []
    for name, (jcfg, shape, names, n_micro, zig, _) in RUNS.items():
        params[name] = dense_params(jcfg)
        cases.append({"kind": "grads", "cfg": convert.config_from_jax(jcfg),
                      "mesh": dict(zip(names, shape)),
                      "params": params[name], "tokens": _toks(name, jcfg),
                      "device": "cpu",
                      "kw": {"n_micro": n_micro, "sp_zigzag": zig}})
    port = ranks_in_background(cases, 8)
    key = jax.random.PRNGKey(0)
    want = {}
    for name, (jcfg, shape, names, n_micro, zig, _) in RUNS.items():
        p, t = params[name], jnp.asarray(_toks(name, jcfg))
        f = _jax_loss(jcfg, shape, names, n_micro, zig)
        want[name] = {
            "loss": float(jax.jit(f)(p, t, key)),
            "dense": float(jgpt.loss_fn(p, t, jcfg)),
            "grads": fetch(jax.jit(jax.grad(
                lambda q: jgpt.loss_fn(q, t, jcfg)))(p))}
    return want, dict(zip(RUNS, port.result()))


def _loss_check(runs, name):
    want, got = runs
    rtol = RUNS[name][5]
    np.testing.assert_allclose(got[name]["loss"], want[name]["loss"],
                               rtol=rtol, err_msg=name)
    np.testing.assert_allclose(got[name]["loss"], want[name]["dense"],
                               rtol=rtol, err_msg=name)


def _grad_check(runs, name):
    want, got = runs
    for path, w in leaves(want[name]["grads"]):
        np.testing.assert_allclose(get(got[name]["grads"], path), w,
                                   rtol=5e-4, atol=1e-6,
                                   err_msg=f"{name} {path}")


def test_sp_hybrid_loss_matches_dense(runs):
    """dp x sp x mp (ring attention + Megatron) == JAX's loss == the
    dense loss."""
    _loss_check(runs, "dp2_sp2_mp2")


def test_sp_zigzag_loss_matches_dense(runs):
    """The zigzag layout through the whole loss (gathered positions, the
    ring, the CE over the permuted rows)."""
    _loss_check(runs, "dp2_sp2_mp2_zigzag")
    _loss_check(runs, "dp2_sp4_zigzag")


@pytest.mark.parametrize("name", ["dp2_sp2_mp2", "dp2_sp2_mp2_zigzag",
                                  "dp2_sp4_zigzag"])
def test_sp_grads_match_jax_grad(runs, name):
    """The whole gradients of the sp step (the ring's dk/dv handed back
    to their owners, averaged over dp and sp) equal ``jax.grad`` of the
    dense loss."""
    _grad_check(runs, name)


def test_gqa_sp_loss_matches_dense(runs):
    """GQA through the ring (Hkv kv heads unrepeated on the wire)."""
    _loss_check(runs, "gqa_dp2_sp2_mp2")
    _grad_check(runs, "gqa_dp2_sp2_mp2")


def test_long_context_composition(runs):
    """zigzag + the sub-block walk (sp_sub_block = 64) + the pipeline
    (1F1B, n_micro 2) + mp, T = 2049: the loss equals JAX's and the
    dense loss within rtol 5e-5; the gradients equal ``jax.grad``'s."""
    _loss_check(runs, "long_pp2_sp2_mp2_zigzag")
    _grad_check(runs, "long_pp2_sp2_mp2_zigzag")


def test_config_carries_sp_sub_block():
    cfg = convert.config_from_jax(LONG)
    assert cfg.sp_sub_block == 64
    assert convert.config_from_jax(JCFG).sp_sub_block is None
    assert dataclasses.replace(cfg, sp_sub_block=None).sp_sub_block is None
