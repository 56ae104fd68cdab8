"""The port's functional pipeline (paddle_tpu_torch/distributed/
pipeline.py: ``make_pipeline_loss`` / ``build_pipeline_train_step``)
against the JAX package's (paddle_tpu/distributed/pipeline.py) under
``shard_map`` on its CPU mesh, on the pp meshes pp2 and pp4.

A tiny fp32 GPT's embed, stage and head functions — the port's
``tools/hybrid_check.gpt_pipeline_fns`` and their JAX twins below, built
from each package's own ``gpt`` pieces — run through both pipelines from
the same numpy params and tokens, at M = 2 and 4 micro-batches, with
``remat_stage`` on and off.  The port's ranks are gloo CPU processes
(``distributed.spawn``), one spawn a world size, started before JAX
compiles.  Held: the first step's loss within 1e-5 and its gradients
within 1e-5 of each leaf's largest |JAX gradient| (the embedding's and
the head's summed over pp), and two AdamW steps' losses within 1e-4.
The dp2 x pp2 mesh is in ``test_torch_pipeline_dp.py``.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from paddle_tpu.compat import shard_map
from paddle_tpu.distributed import pipeline as jpipe
from paddle_tpu.optimizer import AdamW as JAdamW
from paddle_tpu.text import gpt as jgpt
from paddle_tpu.text import woq as jwoq
from paddle_tpu_torch import convert

from test_torch_hybrid import (fetch, get, leaves, mesh_of,
                               ranks_in_background, tokens)

JCFG = jgpt.GPTConfig(vocab_size=128, hidden_size=64, num_layers=4,
                      num_heads=4, max_seq_len=64, dtype=jnp.float32)
LR = 1e-3
STEPS = 2
LOSS_TOL = 1e-5
GRAD_RTOL = 1e-5
TRAIN_LOSS_TOL = 1e-4

# (name, mesh, n_micro, remat_stage): each of M = 2, 4 and remat on / off
# on each mesh
CASES = [("pp2_m2", {"pp": 2}, 2, False),
         ("pp2_m4_remat", {"pp": 2}, 4, True),
         ("pp4_m4", {"pp": 4}, 4, False),
         ("pp4_m2_remat", {"pp": 4}, 2, True)]


def jax_fns(jcfg):
    """The JAX package's embed, stage and head functions of a dense GPT:
    the pieces of its ``loss_fn``."""
    dt = jcfg.dtype

    def embed(params, tok):
        x = jwoq.embed(params, tok[:, :-1], dt)
        return x + params["wpe"][:tok.shape[1] - 1].astype(dt)[None]

    def stage(blocks, x, key):
        def body(x, p):
            return jgpt._block(x, p, jcfg)

        return jax.lax.scan(body, x, blocks)[0]

    def head(params, y, tok):
        y = jgpt._norm(y, params, "ln_f", jcfg)
        logits = jwoq.logits(y, params, dt)
        logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
        ll = jnp.take_along_axis(logp, tok[:, 1:, None], axis=-1)[..., 0]
        return -jnp.mean(ll)

    return embed, stage, head


def jax_specs(jcfg):
    return jgpt.param_shardings(jcfg, mp=None, pp="pp")


def jax_run(jcfg, mesh_shape, n_micro, remat, params, toks):
    """(step-1 loss, its gradients, the losses of STEPS AdamW steps) of
    the JAX pipeline on its CPU mesh."""
    names = tuple(mesh_shape)
    mesh = mesh_of(tuple(mesh_shape.values()), names)
    specs = jax_specs(jcfg)
    fns = jax_fns(jcfg)
    inner = jpipe.make_pipeline_loss(*fns, n_micro, mesh_shape["pp"], "pp",
                                     remat)
    tok_spec = P("dp") if "dp" in names else P()

    def spmd_loss(p, t, k):   # build_pipeline_train_step's own
        l = inner(p, t, k)
        if "dp" in names:
            l = jax.lax.pmean(l, "dp")
        return l

    sharded = shard_map(spmd_loss, mesh=mesh, in_specs=(specs, tok_spec, P()),
                        out_specs=P(), check_vma=False)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    key = jax.random.PRNGKey(0)
    loss, grads = jax.jit(jax.value_and_grad(sharded))(jp, jnp.asarray(toks),
                                                       key)
    opt = JAdamW(learning_rate=LR)
    step = jpipe.build_pipeline_train_step(mesh, *fns, specs, opt, n_micro,
                                           remat_stage=remat)
    state = opt.init_state(jp)
    losses = []
    for i in range(STEPS):
        jp, state, l = step(jp, state, jnp.asarray(toks), key, LR, i)
        losses.append(float(l))
    return float(loss), fetch(grads), losses


def params_and_tokens(jcfg, seed=0):
    params = fetch(jgpt.init_params(jcfg, jax.random.PRNGKey(seed)))
    return params, tokens(jcfg, B=8, T=17, seed=seed)


def port_case(jcfg, mesh, n_micro, remat, params, toks):
    return {"kind": "pipeline", "cfg": convert.config_from_jax(jcfg),
            "mesh": mesh, "params": params, "batches": [toks] * STEPS,
            "n_micro": n_micro, "remat_stage": remat, "lr": LR,
            "opt": ("AdamW", {"learning_rate": LR}), "grads": True,
            "device": "cpu", "key": 0}


def run_both(cases):
    """{name: (JAX's (loss, grads, losses), the port's rank-0 result)}:
    one spawn of the port's ranks a world size, JAX meanwhile."""
    params, toks = params_and_tokens(JCFG)
    by_world: dict = {}
    for name, mesh, m, remat in cases:
        world = int(np.prod(list(mesh.values())))
        by_world.setdefault(world, []).append(
            (name, port_case(JCFG, mesh, m, remat, params, toks)))
    futs = {w: ranks_in_background([c for _, c in cs], w)
            for w, cs in by_world.items()}
    ref = {name: jax_run(JCFG, mesh, m, remat, params, toks)
           for name, mesh, m, remat in cases}
    got = {}
    for w, cs in by_world.items():
        for (name, _), out in zip(cs, futs[w].result()):
            got[name] = out
    return {name: (ref[name], got[name]) for name in ref}


def check(ref, got, name):
    loss, grads, losses = ref
    # the port's step-1 loss is the loss its gradients came from
    assert abs(got["losses"][0] - loss) <= LOSS_TOL, (name, got["losses"],
                                                      loss)
    for path, g in leaves(grads):
        want = np.asarray(g)
        have = get(got["grads"], path)
        scale = float(np.abs(want).max())
        err = float(np.abs(have - want).max())
        assert err <= GRAD_RTOL * scale, (name, path, err, scale)
    np.testing.assert_allclose(got["losses"], losses, atol=TRAIN_LOSS_TOL,
                               rtol=0)
    assert got["losses"][1] < got["losses"][0]


@pytest.fixture(scope="module")
def runs():
    return run_both(CASES)


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_pipeline_matches_jax(runs, name):
    ref, got = runs[name]
    check(ref, got, name)


def test_stage_launch_counts_follow_the_ticks_run(runs):
    """Each rank's #1-#7 launches are its stage's for M micro-batches
    (bubble ticks run nothing; remat recomputes the stage) — what the
    card's gates count (the plain twins count no launches here, so this
    holds the expected counts' shape: one dict a step)."""
    from paddle_tpu_torch.tools import hybrid_check as hc

    cfg = convert.config_from_jax(JCFG)
    for name, mesh, m, remat in CASES:
        want = hc.expected_pipeline_launches(cfg, mesh["pp"], m,
                                             mesh["pp"] - 1, remat)
        assert want["fused_ce_fwd"] == m
        assert want["flash_attention_fwd"] == (
            cfg.num_layers // mesh["pp"]) * m * (1 + remat)
        assert len(runs[name][1]["launches"]) == STEPS
