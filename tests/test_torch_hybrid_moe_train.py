"""MoE through the port's hybrid step on meshes with ``ep``, ``mp``,
``pp`` and ``sp``, against the JAX package on the CPU — the twins of the
reference's ``test_moe_gpt_trains``, ``TestMoEPipeline.
test_loss_matches_dense``, ``test_moe_with_sequence_parallel_trains``
and ``test_full_hybrid_moe_trains`` (tests/test_moe.py:84-218).

* 5-step AdamW trajectories at dp2 x ep2 x mp2 (JAX's GSPMD step: the
  global batch routed as one set), dp2 x sp2 x ep2 and dp2 x pp2 x ep2
  (JAX's manual path: each rank's micro-batch and sequence chunk routed
  on its own, as the port does there): losses within rtol 2e-5 at every
  step, final params by the share past lr/10, each loss falling;
* the pipeline meshes' loss (n_micro 1; both schedules at pp2 x ep2,
  1F1B at pp2 x mp2 and dp2 x pp2 x ep2) within rtol 2e-5 of JAX's
  ``make_pipeline_gpt_loss`` and within the reference's 3e-4 of the
  dense loss (dp splits the aux loss's means).

The port's ranks are gloo CPU processes (8 and 4 of them, one spawn
each), fp32, router noise 0.
"""
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
    assert_trajectory, jax_start, jax_steps, mesh_of, ranks_in_background,
    train_case)
from test_torch_hybrid_moe import GPT_MOE, moe_params, moe_tokens

TRAIN = {  # name: (mesh shape, names, step kwargs, tokens' seed, T + 1)
    "dp2_ep2_mp2": ((2, 2, 2), ("dp", "ep", "mp"), {}, 0, 33),
    "dp2_sp2_ep2": ((2, 2, 2), ("dp", "sp", "ep"), {}, 3, 65),
    "dp2_pp2_ep2": ((2, 2, 2), ("dp", "pp", "ep"), {"n_micro": 2}, 1, 65),
}
LOSS = {  # name: (mesh shape, names, schedule)
    "pp2_ep2_fthenb": ((2, 2), ("pp", "ep"), "fthenb"),
    "pp2_ep2_1f1b": ((2, 2), ("pp", "ep"), "1f1b"),
    "pp2_mp2_1f1b": ((2, 2), ("pp", "mp"), "1f1b"),
    "dp2_pp2_ep2_1f1b": ((2, 2, 2), ("dp", "pp", "ep"), "1f1b"),
}


def _jax_pipeline_loss(shape, names):
    mesh = mesh_of(shape, names)
    raw = jhybrid.make_pipeline_gpt_loss(GPT_MOE, mesh, n_micro=1)
    specs = jgpt.param_shardings(
        GPT_MOE, mp="mp" if "mp" in names else None, pp="pp",
        ep="ep" if "ep" in names else None)
    return shard_map(raw, mesh=mesh,
                     in_specs=(specs, P("dp") if "dp" in names else P(),
                               P()),
                     out_specs=P(), check_vma=False)


@pytest.fixture(scope="module")
def runs():
    starts, cases8, cases4 = {}, [], []
    for name, (shape, names, kw, seed, T) in TRAIN.items():
        starts[name] = jax_start(GPT_MOE, shape, names, **kw)
        cases8.append(train_case(GPT_MOE, dict(zip(names, shape)),
                                 starts[name][2], moe_tokens(8, T, seed),
                                 kw=kw))
    params = moe_params(GPT_MOE)
    ltoks = moe_tokens(4)
    for name, (shape, names, sched) in LOSS.items():
        case = {"kind": "grads", "cfg": convert.config_from_jax(GPT_MOE),
                "mesh": dict(zip(names, shape)), "params": params,
                "tokens": ltoks, "device": "cpu",
                "kw": {"n_micro": 1, "schedule": sched}}
        (cases8 if len(shape) == 3 else cases4).append(case)
    port8 = ranks_in_background(cases8, 8)
    port4 = ranks_in_background(cases4, 4)
    ref = {name: jax_steps(step_fn, state,
                           moe_tokens(8, TRAIN[name][4], TRAIN[name][3]))
           for name, (step_fn, state, _) in starts.items()}
    key = jax.random.PRNGKey(1)
    lt = jnp.asarray(ltoks)
    want = {name: float(jax.jit(_jax_pipeline_loss(shape, names))(
        params, lt, key)) for name, (shape, names, _) in LOSS.items()}
    want["dense"] = float(jgpt.loss_fn(params, lt, GPT_MOE))
    got8, got4 = port8.result(), port4.result()
    got = dict(zip(TRAIN, got8))
    got.update(zip([n for n, v in LOSS.items() if len(v[0]) == 3],
                   got8[len(TRAIN):]))
    got.update(zip([n for n, v in LOSS.items() if len(v[0]) == 2], got4))
    return ref, want, got


@pytest.mark.parametrize("name", list(TRAIN))
def test_moe_trajectory_matches_jax(runs, name):
    ref, _, got = runs
    losses, final = ref[name]
    assert np.isfinite(got[name]["losses"]).all()
    assert got[name]["losses"][-1] < got[name]["losses"][0]
    assert_trajectory(got[name], losses, final, name)


@pytest.mark.parametrize("name", list(LOSS))
def test_pipeline_moe_loss_matches_jax(runs, name):
    _, want, got = runs
    np.testing.assert_allclose(got[name]["loss"], want[name], rtol=2e-5)
    assert abs(got[name]["loss"] - want["dense"]) < 3e-4
