"""5-step AdamW trajectories of the port's hybrid step against the JAX
package's, on the pipeline meshes of the reference's
``test_loss_decreases`` (tests/test_gpt_hybrid.py:160-180): dp2 x pp2 x
mp2 and pp4 x mp2 (1F1B, two micro-batches); its dp8 mesh is ZeRO stage
0 in ``test_torch_zero.py``.  The port's ranks are gloo CPU processes
(one spawn for both meshes), JAX runs on its 8-device mesh, from the
same numpy params (JAX's ``init_fn(0)``, fetched) and tokens.  Losses within rtol 2e-5 at every
step; final params by the share past lr/10; and each rank's stored
leaves are its blocks of the Megatron layout.
"""
import pytest

from paddle_tpu_torch import convert
from paddle_tpu_torch.text import gpt

from test_torch_hybrid import (
    JCFG, assert_trajectory, jax_start, jax_steps, leaves,
    ranks_in_background, tokens, train_case)

MESHES = {  # the reference test_loss_decreases' pipeline meshes
    "dp2_pp2_mp2": ((2, 2, 2), ("dp", "pp", "mp"), 2),
    "pp4_mp2": ((4, 2), ("pp", "mp"), 2),
}


@pytest.fixture(scope="module")
def runs():
    toks = tokens(JCFG)
    starts = {name: jax_start(JCFG, shape, names, n_micro=n_micro)
              for name, (shape, names, n_micro) in MESHES.items()}
    cases = [train_case(JCFG, dict(zip(names, shape)), starts[name][2],
                        toks, kw={"n_micro": n_micro})
             for name, (shape, names, n_micro) in MESHES.items()]
    port = ranks_in_background(cases, 8)
    ref = {name: jax_steps(step_fn, state, toks)
           for name, (step_fn, state, _) in starts.items()}
    return ref, dict(zip(MESHES, port.result()))


@pytest.mark.parametrize("name", list(MESHES))
def test_trajectory_matches_jax(runs, name):
    ref, got = runs
    losses, final = ref[name]
    assert got[name]["losses"][-1] < got[name]["losses"][0]
    assert_trajectory(got[name], losses, final, name)


@pytest.mark.parametrize("name", list(MESHES))
def test_each_rank_holds_its_blocks(runs, name):
    """The stored leaves are the rank's blocks of the Megatron layout:
    [L/pp] stacked layers, H/mp heads' columns, V/mp vocab rows."""
    shape, names, _ = MESHES[name]
    sizes = dict(zip(names, shape))
    got = runs[1][name]["local_shapes"]
    cfg = convert.config_from_jax(JCFG)
    specs = dict(leaves(gpt.param_shardings(
        cfg, mp="mp" if sizes.get("mp", 1) > 1 else None,
        pp="pp" if sizes.get("pp", 1) > 1 else None)))
    for path, shp in leaves(gpt.param_shapes(cfg)):
        want = list(shp)
        for d, entry in enumerate(specs[path]):
            if entry is not None:
                want[d] //= sizes.get(entry, 1)
        assert got[".".join(path)] == tuple(want), (path, got)
