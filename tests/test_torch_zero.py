"""ZeRO stages 1-3 of the port's hybrid step against the JAX package's
(tests/test_zero_sharding.py), on the CPU, with the harness of
``test_torch_hybrid.py``.

* ``test_loss_parity_across_stages``: dp8 at stages 0-3, AdamW steps
  (five at stage 0, three at 1-3) against JAX's at the same stage (losses within rtol 2e-5 at
  every step, params by the share past lr/10) and against the port's own
  stage 0 (rtol 2e-4, the reference's); stage 0 is the reference's dp8
  ``test_loss_decreases`` mesh;
* ``test_zero3_shards_params_linearly``: stage 3 (AdamW) at dp 2 and 8
  — each rank stores JAX's shard shapes, and its parameter and
  optimizer bytes shrink about linearly in the shard count; it still
  trains;
* the port's analogue of ``test_zero2_update_is_shard_local`` (an XLA
  compile artefact there): under stage 2 the gradients that reach the
  optimizer and its state are JAX's shard shapes;
* ``test_zero_stage2_rejected_on_pipeline``: NotImplementedError in
  both packages.
"""
import numpy as np
import pytest
import torch

import jax

from paddle_tpu.optimizer import Adam as JAdam
from paddle_tpu.text import gpt as jgpt
from paddle_tpu.text import gpt_hybrid as jhybrid
from paddle_tpu_torch import convert
from paddle_tpu_torch.distributed.topology import Mesh as TMesh
from paddle_tpu_torch.optimizer import Adam
from paddle_tpu_torch.text import gpt_hybrid

from test_torch_hybrid import (
    LR, assert_trajectory, jax_start, jax_steps, leaves, mesh_of,
    ranks_in_background, train_case)

ZCFG = jgpt.GPTConfig(vocab_size=128, hidden_size=64, num_layers=2,
                      num_heads=4, max_seq_len=64, dtype=np.float32)


# stage 0 is the dp8 trajectory of the reference's test_loss_decreases
# (five steps); stages 1-3 take the reference's three
STEPS = {0: 5, 1: 3, 2: 3, 3: 3}


def _tokens(B=8, seed=0):
    return np.random.default_rng(seed).integers(
        0, ZCFG.vocab_size, (B, ZCFG.max_seq_len)).astype(np.int32)


def _shard_shapes(tree):
    """{dotted path: [shape of one device's shard, ...]} of a JAX tree
    (a tuple leaf gives one shape per array)."""
    out = {}
    for path, leaf in leaves(tree):
        arrs = leaf if isinstance(leaf, (tuple, list)) else (leaf,)
        out[".".join(path)] = [tuple(a.addressable_shards[0].data.shape)
                               for a in arrs]
    return out


@pytest.fixture(scope="module")
def runs():
    toks = _tokens()
    starts = {stage: jax_start(ZCFG, (8,), ("dp",), zero=stage)
              for stage in range(4)}
    dp2 = jax_start(ZCFG, (2,), ("dp",), zero=3)
    w8 = [train_case(ZCFG, {"dp": 8}, starts[stage][2], toks,
                     steps=STEPS[stage], kw={"zero": stage},
                     record_update=True)
          for stage in range(4)]
    w2 = [train_case(ZCFG, {"dp": 2}, dp2[2], _tokens(B=2), steps=2,
                     kw={"zero": 3}, record_update=True)]
    port8, port2 = ranks_in_background(w8, 8), ranks_in_background(w2, 2)
    ref = {stage: jax_steps(step_fn, state, toks, STEPS[stage])
           for stage, (step_fn, state, _) in starts.items()}
    out8, out2 = port8.result(), port2.result()
    return {"ref": ref, "stages": out8, "lin": {8: out8[3], 2: out2[0]},
            "jax_states": {s: starts[s][1] for s in starts},
            "jax_lin": {8: starts[3][1], 2: dp2[1]}}


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_loss_parity_across_stages(runs, stage):
    losses, final = runs["ref"][stage]
    got = runs["stages"][stage]
    assert np.isfinite(got["losses"]).all()
    assert_trajectory(got, losses, final, f"stage {stage}")
    n = STEPS[stage]
    np.testing.assert_allclose(got["losses"],
                               runs["stages"][0]["losses"][:n], rtol=2e-4,
                               err_msg=f"stage {stage}")


@pytest.mark.parametrize("dp", [2, 8])
def test_zero3_stores_jax_shards(runs, dp):
    got = runs["lin"][dp]
    js = runs["jax_lin"][dp]
    want = _shard_shapes(js.params)
    assert {k: [v] for k, v in got["local_shapes"].items()} == want
    assert got["update"]["state"] == _shard_shapes(js.opt_state)
    assert np.isfinite(got["losses"]).all()


def test_zero3_shards_params_linearly(runs):
    def nbytes(r):
        n = sum(int(np.prod(s)) for s in r["local_shapes"].values())
        n += sum(int(np.prod(s)) for st in r["update"]["state"].values()
                 for s in st)
        return 4 * n

    b = {dp: nbytes(runs["lin"][dp]) for dp in (2, 8)}
    # 4x more shards -> ~4x less resident per rank (small replicated
    # leaves — norms, biases — keep it from being exactly linear)
    assert b[8] < b[2] / 2.5, b


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_zero_update_is_shard_local(runs, stage):
    """What the optimizer sees at stages 1-3 is shard-sized: the state
    always, the gradients too from stage 2 on (stage 1 cuts the
    all-reduced gradient to the same block) — JAX's shard shapes."""
    seen = runs["stages"][stage]["update"]
    want = _shard_shapes(runs["jax_states"][stage].opt_state)
    assert seen["state"] == want
    assert {k: [v] * 2 for k, v in seen["grads"].items()} == want
    full = {".".join(p): a.shape for p, a in
            leaves(jgpt.init_params(ZCFG, jax.random.PRNGKey(0)))}
    fc = "blocks.fc_w"
    assert np.prod(seen["grads"][fc]) * 8 == np.prod(full[fc])


def test_zero_stage2_rejected_on_pipeline():
    mesh = mesh_of((2, 4), ("pp", "dp"))
    with pytest.raises(NotImplementedError):
        jhybrid.build_gpt_train_step(ZCFG, mesh, JAdam(learning_rate=LR),
                                     n_micro=2, zero=2)
    with pytest.raises(NotImplementedError):
        gpt_hybrid.build_gpt_train_step(
            convert.config_from_jax(ZCFG), Adam(learning_rate=LR),
            mesh=TMesh({"pp": 2, "dp": 4}, device=torch.device("cpu")),
            n_micro=2, zero=2)
