"""The port's functional pipeline against the JAX package's on the
dp2 x pp2 mesh (see ``test_torch_pipeline.py``, whose helpers run both):
each dp rank its block of the batch's rows, the loss and every gradient
meaned over dp, the pp-replicated leaves' gradients summed over pp; at
M = 2 with ``remat_stage`` and M = 4 without.  Same tolerances.
"""
import pytest

from test_torch_pipeline import check, run_both

CASES = [("dp2_pp2_m2_remat", {"dp": 2, "pp": 2}, 2, True),
         ("dp2_pp2_m4", {"dp": 2, "pp": 2}, 4, False)]


@pytest.fixture(scope="module")
def runs():
    return run_both(CASES)


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_pipeline_matches_jax(runs, name):
    ref, got = runs[name]
    check(ref, got, name)
