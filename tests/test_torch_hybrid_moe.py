"""MoE on a mesh in the port (``moe.moe_ffn_manual``, ``ExpertParallel``
and the hybrid step's ``ep`` axis) against the JAX package, on the CPU:
the repair of MoE routing over ``dp`` and the twins of the reference's
``test_ep_sharded_loss_matches_replicated``, ``test_moe_manual_matches_
gspmd`` and ``TestMoEPipeline.test_1f1b_grads_match_dense``
(tests/test_moe.py:68-160); the trajectories are in
``test_torch_hybrid_moe_train.py``.

**The dp repair.**  Where JAX runs the step as one GSPMD program (pp ==
sp == 1) it routes the global batch's tokens as one set: one capacity
over the global N, one slot order, one aux loss from the global means.
The port's ranks now all-gather the router logits over dp to do the
same.  Held here with a capacity factor below E / k (tokens drop) and
aux weight 0.01, at dp8, dp2 x mp4 and dp2 x ep4, and at accum 2 (JAX's
micro-batch i is rows block i of the global batch, routed whole): the
losses within rtol 2e-5 of ``gpt.loss_fn`` over the global batch (and
of JAX's accum step), the gradients within rtol 5e-4 / atol 1e-6 of
``jax.grad`` (at accum 2, a bf16 carry on both sides: within 1% of each
leaf's largest gradient).  The per-rank routing the port did before
(each dp rank's batch a set of its own) leaves the loss 7.8e-4 off on
these tokens at dp2, eight times the loss tolerance (asserted above
5e-4, so the test tells the two apart).

The port's ranks are gloo CPU processes (kinds "grads" and "moe" of
``tools/hybrid_check.py``); fp32; router noise 0, so no draw differs.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from paddle_tpu.optimizer import AdamW as JAdamW
from paddle_tpu.text import gpt as jgpt
from paddle_tpu.text import gpt_hybrid as jhybrid
from paddle_tpu.text.moe import MoEConfig as JMoEConfig
from paddle_tpu.text.moe import init_moe_params, moe_ffn
from paddle_tpu_torch import convert
from paddle_tpu_torch.text.moe import MoEConfig

from test_torch_hybrid import (
    LR, fetch, get, jax_init, leaves, mesh_of, ranks_in_background)

GPT_MOE = jgpt.GPTConfig(vocab_size=128, hidden_size=64, num_layers=2,
                         num_heads=4, max_seq_len=64, dtype=jnp.float32,
                         moe=JMoEConfig(num_experts=4, capacity_factor=2.0))
# capacity binding: cf 0.5 < E / k = 2
GPT_MOE_BIND = dataclasses.replace(
    GPT_MOE, moe=JMoEConfig(num_experts=4, capacity_factor=0.5,
                            aux_loss_weight=0.01))
GRAD_TOL = dict(rtol=5e-4, atol=1e-6)


def moe_tokens(B=8, T=33, seed=0):
    return np.random.default_rng(seed).integers(0, 128, (B, T)) \
        .astype(np.int32)


def moe_params(jcfg):
    return fetch(jgpt.init_params(jcfg, jax.random.PRNGKey(0)))


# name: (jax config, mesh, step kwargs)
GRADS = {
    "bind_dp8": (GPT_MOE_BIND, {"dp": 8}, {}),
    "bind_dp2_mp4": (GPT_MOE_BIND, {"dp": 2, "mp": 4}, {}),
    "bind_dp2_ep4": (GPT_MOE_BIND, {"dp": 2, "ep": 4}, {}),
    "bind_dp2_mp4_accum2": (GPT_MOE_BIND, {"dp": 2, "mp": 4},
                            {"accum": 2}),
    "ep_sharded_dp2_ep4": (GPT_MOE, {"dp": 2, "ep": 4}, {}),
}
PIPE = {"pp2_ep2_1f1b": (GPT_MOE, {"pp": 2, "ep": 2}, {"n_micro": 1})}
MANUAL = JMoEConfig(num_experts=8, capacity_factor=4.0, top_k=2)


def _manual_inputs():
    params = fetch(init_moe_params(jax.random.PRNGKey(0), 16, 32, MANUAL))
    g = np.random.default_rng(1)
    x = g.standard_normal((4, 6, 16)).astype(np.float32)
    w = g.standard_normal((4, 6, 16)).astype(np.float32)
    return params, x, w


def _grads_case(jcfg, mesh, kw, params, toks):
    return {"kind": "grads", "cfg": convert.config_from_jax(jcfg),
            "mesh": mesh, "params": params, "tokens": toks,
            "device": "cpu", "kw": kw}


@pytest.fixture(scope="module")
def runs():
    toks = moe_tokens()
    params = {id(GPT_MOE): moe_params(GPT_MOE),
              id(GPT_MOE_BIND): moe_params(GPT_MOE_BIND)}
    cases8 = [_grads_case(c, m, kw, params[id(c)], toks)
              for c, m, kw in GRADS.values()]
    mp, mx, mw = _manual_inputs()
    cases8.append({"kind": "moe", "mesh": {"ep": 4, "mp": 2},
                   "moe_cfg": MoEConfig(**vars(MANUAL)), "params": mp,
                   "x": mx, "w": mw, "device": "cpu"})
    pipe_toks = moe_tokens(4)
    cases4 = [_grads_case(c, m, kw, params[id(c)], pipe_toks)
              for c, m, kw in PIPE.values()]
    port8 = ranks_in_background(cases8, 8)
    port4 = ranks_in_background(cases4, 4)

    want = {}
    for jcfg in (GPT_MOE, GPT_MOE_BIND):
        p, t = params[id(jcfg)], jnp.asarray(toks)
        want[id(jcfg)] = {"loss": float(jgpt.loss_fn(p, t, jcfg)),
                      "grads": fetch(jax.jit(jax.grad(
                          lambda q: jgpt.loss_fn(q, t, jcfg)))(p))}
    # the per-rank routing of the old port (each dp half its own set)
    p, t = params[id(GPT_MOE_BIND)], jnp.asarray(toks)
    want["per_rank"] = float(np.mean([jgpt.loss_fn(p, t[:4], GPT_MOE_BIND),
                                      jgpt.loss_fn(p, t[4:], GPT_MOE_BIND)]))
    # accum 2: JAX's step loss on the dp2 x mp4 mesh; fp32 mean gradient
    init_fn, step_fn, _ = jhybrid.build_gpt_train_step(
        GPT_MOE_BIND, mesh_of((2, 4), ("dp", "mp")),
        JAdamW(learning_rate=LR), donate=False, accum=2)
    state = jax_init(init_fn, mesh_of((2, 4), ("dp", "mp")))
    _, loss = step_fn(state, t, jax.random.PRNGKey(0), LR)
    g = jax.jit(jax.grad(lambda q: 0.5 * (
        jgpt.loss_fn(q, t[:4], GPT_MOE_BIND)
        + jgpt.loss_fn(q, t[4:], GPT_MOE_BIND))))(p)
    want["accum2"] = {"loss": float(loss), "grads": fetch(g)}
    # the manual FFN: moe_ffn unsharded and its jax.grad
    mpj = jax.tree_util.tree_map(jnp.asarray, mp)

    def manual_loss(prm, x):
        y, aux = moe_ffn(prm, x, MANUAL)
        return jnp.sum(y * mw) + aux

    y, aux = moe_ffn(mpj, jnp.asarray(mx), MANUAL)
    gp, gx = jax.grad(manual_loss, argnums=(0, 1))(mpj, jnp.asarray(mx))
    want["manual"] = {"y": np.asarray(y), "aux": float(aux),
                      "grads": fetch(gp), "dx": np.asarray(gx)}
    pt = jnp.asarray(pipe_toks)
    pg = params[id(GPT_MOE)]
    want["pipe"] = fetch(jax.jit(jax.grad(
        lambda q: jgpt.loss_fn(q, pt, GPT_MOE)))(pg))
    got8, got4 = port8.result(), port4.result()
    got = dict(zip(list(GRADS) + ["manual"], got8))
    got.update(zip(PIPE, got4))
    return want, got


def _grad_check(got, want, what, **tol):
    for path, w in leaves(want):
        np.testing.assert_allclose(get(got, path), w,
                                   err_msg=f"{what} {path}",
                                   **(tol or GRAD_TOL))


@pytest.mark.parametrize("name", ["bind_dp8", "bind_dp2_mp4",
                                  "bind_dp2_ep4"])
def test_dp_moe_routes_the_global_batch(runs, name):
    """The repair: capacity binding (cf 0.5), aux 0.01 — the dp step's
    loss and gradients are JAX's over the global batch."""
    want, got = runs
    ref = want[id(GPT_MOE_BIND)]
    np.testing.assert_allclose(got[name]["loss"], ref["loss"], rtol=2e-5)
    _grad_check(got[name]["grads"], ref["grads"], name)
    # per-rank routing would be told apart on these tokens
    assert abs(want["per_rank"] - ref["loss"]) > 5e-4, want["per_rank"]


def test_dp_moe_accum_routes_each_global_micro_batch(runs):
    """accum 2 at dp2 x mp4: micro-batch i is the global rows block i,
    routed whole; the loss is JAX's accum step's, the bf16-carried
    gradients JAX's fp32 mean gradient within 1% of each leaf's
    largest."""
    want, got = runs
    ref = want["accum2"]
    np.testing.assert_allclose(got["bind_dp2_mp4_accum2"]["loss"],
                               ref["loss"], rtol=2e-5)
    for path, w in leaves(ref["grads"]):
        np.testing.assert_allclose(
            get(got["bind_dp2_mp4_accum2"]["grads"], path), w, rtol=1e-2,
            atol=1e-2 * float(np.abs(w).max()), err_msg=str(path))


def test_ep_sharded_loss_matches_replicated(runs):
    """dp2 x ep4 sharded MoE GPT loss == the same params unsharded (and
    the gradients == jax.grad's)."""
    want, got = runs
    ref = want[id(GPT_MOE)]
    np.testing.assert_allclose(got["ep_sharded_dp2_ep4"]["loss"],
                               ref["loss"], rtol=2e-5)
    _grad_check(got["ep_sharded_dp2_ep4"]["grads"], ref["grads"],
                "dp2_ep4")


def test_moe_manual_matches_gspmd(runs):
    """moe_ffn_manual at ep4 x mp2 (each rank 2 experts, 16 of their 32
    FFN columns) computes moe_ffn: y within atol 2e-5, aux within rtol
    1e-6 (the reference's); the gradients of sum(y · w) + aux — the
    router's whole on every rank, the experts' gathered back, x's —
    within rtol 1e-4 / atol 1e-6 of jax.grad's."""
    want, got = runs
    ref, res = want["manual"], got["manual"]
    np.testing.assert_allclose(res["y"], ref["y"], atol=2e-5)
    np.testing.assert_allclose(res["aux"], ref["aux"], rtol=1e-6)
    _grad_check(res["grads"], ref["grads"], "manual", rtol=1e-4,
                atol=1e-6)
    np.testing.assert_allclose(res["dx"], ref["dx"], rtol=1e-4, atol=1e-6)


def test_1f1b_grads_match_dense(runs):
    """pp2 x ep2 1F1B: every leaf's gradient (the router's and the
    experts' too) within 1e-4 of jax.grad's, relative to the leaf's
    largest (the reference's measure)."""
    want, got = runs
    for path, w in leaves(want["pipe"]):
        g = get(got["pp2_ep2_1f1b"]["grads"], path)
        rel = float(np.abs(g - w).max() / (np.abs(w).max() + 1e-9))
        assert rel < 1e-4, (path, rel)


def test_moe_param_shardings_match_jax():
    """The expert leaves' layout equals the reference's PartitionSpecs,
    and the GPT tree's MoE specs prepend the stacked-layer axis."""
    from paddle_tpu.text.moe import moe_param_shardings as jspecs
    from paddle_tpu_torch.text import gpt
    from paddle_tpu_torch.text.moe import moe_param_shardings

    for ep, mp in (("ep", None), ("ep", "mp"), (None, "mp")):
        got = moe_param_shardings(ep=ep, mp=mp)
        want = jspecs(ep=ep, mp=mp)
        assert got == {k: tuple(v) for k, v in want.items()}
    cfg = convert.config_from_jax(GPT_MOE)
    specs = gpt.param_shardings(cfg, mp="mp", pp="pp", ep="ep")
    jsp = jgpt.param_shardings(GPT_MOE, mp="mp", pp="pp", ep="ep")
    for path, spec in leaves(specs):
        assert tuple(spec) == tuple(get(jsp, path)), path
