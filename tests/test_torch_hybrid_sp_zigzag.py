"""5-step AdamW trajectories of the port's hybrid step with ``sp`` in the
zigzag layout against the JAX package's, on the CPU — the twins of the
reference's ``test_sp_zigzag_1f1b_training`` (tests/test_gpt_hybrid.py:
460-473) and ``test_gqa_sp_zigzag_trains`` (:607-620), fp32 (the GQA
reference runs bf16).  As ``test_torch_hybrid_sp_train.py``: losses
within rtol 2e-5 at every step, final params by the share past lr/10,
each loss falling.
"""
import pytest

from test_torch_hybrid import JCFG, _gqa_jcfg, assert_trajectory
from test_torch_hybrid_sp_train import trajectories

MESHES = {
    "pp2_sp2_mp2_zigzag_1f1b": (JCFG, (2, 2, 2), ("pp", "sp", "mp"),
                                {"n_micro": 2, "sp_zigzag": True}),
    "gqa_pp2_sp2_mp2_zigzag": (_gqa_jcfg(), (2, 2, 2), ("pp", "sp", "mp"),
                               {"n_micro": 2, "sp_zigzag": True}),
}


@pytest.fixture(scope="module")
def runs():
    return trajectories(MESHES)


@pytest.mark.parametrize("name", list(MESHES))
def test_trajectory_matches_jax(runs, name):
    ref, got = runs
    losses, final = ref[name]
    assert got[name]["losses"][-1] < got[name]["losses"][0]
    assert_trajectory(got[name], losses, final, name)
    assert got[name]["meta"]["sp_zigzag"] is True
