"""5-step AdamW trajectories of the port's hybrid step with the ``sp``
axis against the JAX package's, on the CPU — the twins of the
reference's ``test_gspmd_sp_loss_matches_dense`` (tests/
test_gpt_hybrid.py:142-158), ``test_sp_pp_mp_training`` (:475-490) and
an F-then-B twin of it; the zigzag runs are in
``test_torch_hybrid_sp_zigzag.py``.  The port's ranks are 8 gloo CPU
processes (one spawn for every mesh), JAX runs its
``build_gpt_train_step`` on its 8-device mesh, from the same numpy params
(JAX's ``init_fn(0)``, fetched) and tokens; fp32.  Losses within rtol
2e-5 at every step, the first also against the dense loss; final params
by the share past lr/10 (``assert_trajectory``); each loss falls.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from paddle_tpu.text import gpt as jgpt

from test_torch_hybrid import (
    JCFG, LOSS_RTOL, assert_trajectory, jax_start, jax_steps,
    ranks_in_background, tokens, train_case)

MESHES = {
    "dp2_sp2_mp2": (JCFG, (2, 2, 2), ("dp", "sp", "mp"), {}),
    "pp2_sp2_mp2_1f1b": (JCFG, (2, 2, 2), ("pp", "sp", "mp"),
                         {"n_micro": 2}),
    "pp2_sp2_mp2_fthenb": (JCFG, (2, 2, 2), ("pp", "sp", "mp"),
                           {"n_micro": 2, "schedule": "fthenb"}),
}


def trajectories(meshes):
    """(JAX's (losses, final params), the port's rank-0 results) of every
    mesh, the port's ranks running while JAX compiles."""
    starts, cases = {}, []
    for name, (jcfg, shape, names, kw) in meshes.items():
        starts[name] = jax_start(jcfg, shape, names, **kw)
        cases.append(train_case(jcfg, dict(zip(names, shape)),
                                starts[name][2], tokens(jcfg), kw=kw))
    port = ranks_in_background(cases, 8)
    ref = {name: jax_steps(step_fn, state, tokens(meshes[name][0]))
           for name, (step_fn, state, _) in starts.items()}
    return ref, dict(zip(meshes, port.result()))


@pytest.fixture(scope="module")
def runs():
    return trajectories(MESHES)


@pytest.mark.parametrize("name", list(MESHES))
def test_trajectory_matches_jax(runs, name):
    ref, got = runs
    losses, final = ref[name]
    assert got[name]["losses"][-1] < got[name]["losses"][0]
    assert_trajectory(got[name], losses, final, name)
    assert got[name]["meta"]["sp"] == 2


def test_gspmd_sp_loss_matches_dense(runs):
    """The dp x sp x mp step's first loss is the dense loss of the
    initial params."""
    _, got = runs
    params = jgpt.init_params(JCFG, jax.random.PRNGKey(0))
    want = float(jgpt.loss_fn(params, jnp.asarray(tokens(JCFG)), JCFG))
    np.testing.assert_allclose(got["dp2_sp2_mp2"]["losses"][0], want,
                               rtol=LOSS_RTOL)
