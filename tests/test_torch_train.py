"""The port's training surface (paddle_tpu_torch/text/gpt.py ``loss_fn``,
text/gpt_hybrid.py ``build_gpt_train_step``) against the JAX package's,
on the CPU.

* ``loss_fn`` and its gradients against ``jax.value_and_grad(gpt.loss_fn)``
  over the 16-case architecture grid of tests/test_torch_gpt.py, with
  ``PADDLE_TPU_FUSED_CE`` off and on (fp32, 2 layers: loss within 1e-5,
  grads within 1e-5 — matmul summation order).  On the CPU the JAX fused
  branch falls back to its XLA expression, so one JAX reference per
  architecture serves both settings; the port's fused branch runs the
  plain twins of its kernels through their autograd Function;
* a 5-step fp32 trajectory of ``build_gpt_train_step`` (AdamW) with
  accum 1 and 2 against the JAX step on a 1-device mesh, from the same
  ``params_from_jax`` weights, and a resume from the JAX run's step-3
  state (``opt_state_from_jax``) — losses within 1e-5; params within 1e-5
  at accum 1 and 1e-4 (a tenth of lr) at accum 2, which sums its
  micro-batch grads in a bf16 carry in both packages: a grad element on a
  bf16 rounding boundary may round to the other neighbour in one of them,
  and that moves the element's Adam steps by a few thousandths of lr;
* the train path's recipe (tools/profile_train.py: bf16, accum 8, AdamW
  with bf16 moments, the fused CE flag) at a small width against the JAX
  step — losses within 1e-3 (bf16 matmul rounding);
* the ``markov_gpt`` recipe (tests/conftest.py) trained in the port
  reaches loss < 0.1;
* with ``PADDLE_TPU_FUSED_LN=1`` the loss runs the fused LayerNorm's plain
  twins and equals the JAX package's flagged loss (Pallas in interpret
  mode) within 1e-5;
* a 3-step trajectory under ``remat_policy="dots"`` with Adafactor at
  accum 2 (hidden 128, so Adafactor factors the block matrices) against
  the JAX step — losses within 1e-5, params within the accum-2 1e-4.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from paddle_tpu import optimizer as jopt
from paddle_tpu.ops import fused_norm as jfused_norm
from paddle_tpu.text import gpt as jgpt
from paddle_tpu.text import gpt_hybrid as jhybrid
from paddle_tpu.text import moe as jmoe
from paddle_tpu_torch import convert
from paddle_tpu_torch.ops import fused_norm
from paddle_tpu_torch.optimizer import Adafactor, AdamW
from paddle_tpu_torch.text import gpt, gpt_hybrid

from test_torch_gpt import GRID, _jcfg

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's steps here are tiny: one intra-op thread runs them ~15x
    faster than a pool of threads contending for a shared CPU."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _close_trees(tp, jp, tol=TOL):
    for path, t in _leaves(tp):
        np.testing.assert_allclose(t.detach().float().numpy(),
                                   np.asarray(_get(jp, path), np.float32),
                                   atol=tol, rtol=0, err_msg=str(path))


TOKENS = np.random.default_rng(0).integers(0, 64, (2, 13))


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(arch):
    jcfg = _jcfg(*arch)
    jp = jgpt.init_params(jcfg, jax.random.PRNGKey(1))
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, t: jgpt.loss_fn(p, t, jcfg)))(jp, jnp.asarray(TOKENS))
    return jcfg, jax.device_get(jp), float(loss), jax.device_get(grads)


@pytest.mark.parametrize("fused_ce", ["0", "1"])
@pytest.mark.parametrize("pos_embed,norm,activation,kvh", GRID)
def test_loss_and_grads_match_jax(pos_embed, norm, activation, kvh,
                                  fused_ce, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_FUSED_CE", fused_ce)
    jcfg, jp, ref_loss, ref_grads = _jax_loss_and_grads(
        (pos_embed, norm, activation, kvh))
    cfg = convert.config_from_jax(jcfg)
    params = convert.params_from_jax(jp)
    loss, grads = gpt_hybrid.value_and_grad(
        lambda p, t: gpt.loss_fn(p, t, cfg), params,
        torch.from_numpy(TOKENS))
    assert loss.dtype == torch.float32 and loss.shape == ()
    assert abs(loss.item() - ref_loss) < TOL
    _close_trees(grads, ref_grads)


def _jax_init(jinit, mesh):
    """The JAX step's initial state with ``step`` placed as the step
    returns it (replicated over the mesh), so that the jitted step
    compiles once instead of again at its second call."""
    js = jinit(0)
    return js._replace(step=jax.device_put(
        js.step, NamedSharding(mesh, PartitionSpec())))


def _train_cfg():
    return _jcfg("rope", "layernorm", "gelu", 2, vocab_size=64)


@pytest.mark.parametrize("accum", [1, 2])
def test_trajectory_matches_jax_and_resumes(accum):
    jcfg = _train_cfg()
    mesh = Mesh(np.array(jax.devices()[:1]), ("dp",))
    jinit, jstep, _ = jhybrid.build_gpt_train_step(
        jcfg, mesh, jopt.AdamW(learning_rate=1e-3, weight_decay=0.01),
        accum=accum)
    rng = np.random.default_rng(5)
    batches = [rng.integers(0, 64, (4, 13)) for _ in range(5)]
    js = _jax_init(jinit, mesh)
    p0 = jax.device_get(js.params)
    key = jax.random.PRNGKey(0)
    j_losses, snap = [], None
    for i, b in enumerate(batches):
        js, loss = jstep(js, jnp.asarray(b, jnp.int32), key, 1e-3)
        j_losses.append(float(loss))
        if i == 2:
            snap = jax.device_get((js.params, js.opt_state, js.step))
    j_final = jax.device_get(js.params)

    cfg = convert.config_from_jax(jcfg)
    opt = AdamW(learning_rate=1e-3, weight_decay=0.01)
    _, step_fn, meta = gpt_hybrid.build_gpt_train_step(cfg, opt, accum=accum,
                                                       device="cpu")
    assert meta["accum"] == accum
    params = convert.params_from_jax(p0)
    st = gpt_hybrid.GPTTrainState(params, opt.init_state(params),
                                  torch.zeros((), dtype=torch.int32))
    for i, b in enumerate(batches):
        st, loss = step_fn(st, b, None, 1e-3)
        assert abs(loss.item() - j_losses[i]) < TOL, (i, loss, j_losses)
    assert int(st.step) == 5
    p_tol = TOL if accum == 1 else 1e-4
    _close_trees(st.params, j_final, p_tol)

    # resume mid-run: the JAX state after step 3, two more port steps
    sp, so, sstep = snap
    st = gpt_hybrid.GPTTrainState(convert.params_from_jax(sp),
                                  convert.opt_state_from_jax(so),
                                  torch.tensor(int(sstep), dtype=torch.int32))
    for i in (3, 4):
        st, loss = step_fn(st, batches[i], None, 1e-3)
        assert abs(loss.item() - j_losses[i]) < TOL
    _close_trees(st.params, j_final, p_tol)


def test_rung_recipe_matches_jax_in_bf16(monkeypatch):
    """The train path's recipe (bench.py's ``gpt_1.3b_acc8_b8`` rung with
    the fused CE flag) at a small width: bf16 compute, accum 8, AdamW(2e-4,
    weight decay 0.01, bf16 moments), one batch repeated for five steps.
    bf16 matmuls round differently in XLA and in PyTorch, so losses agree
    within 1e-3; at this width both fall on every step."""
    monkeypatch.setenv("PADDLE_TPU_FUSED_CE", "1")
    jcfg = _jcfg("learned", "layernorm", "gelu", None, vocab_size=512,
                 dtype=jnp.bfloat16)
    mesh = Mesh(np.array(jax.devices()[:1]), ("dp",))
    jinit, jstep, _ = jhybrid.build_gpt_train_step(
        jcfg, mesh, jopt.AdamW(learning_rate=2e-4, weight_decay=0.01,
                               state_dtype=jnp.bfloat16), accum=8)
    js = _jax_init(jinit, mesh)
    p0 = jax.device_get(js.params)
    toks = np.random.default_rng(0).integers(0, 512, (8, 17))
    j_losses = []
    for _ in range(5):
        js, loss = jstep(js, jnp.asarray(toks, jnp.int32),
                         jax.random.PRNGKey(0), 2e-4)
        j_losses.append(float(loss))

    cfg = convert.config_from_jax(jcfg)
    assert cfg.dtype == torch.bfloat16
    opt = AdamW(learning_rate=2e-4, weight_decay=0.01,
                state_dtype=torch.bfloat16)
    _, step_fn, _ = gpt_hybrid.build_gpt_train_step(cfg, opt, accum=8,
                                                    device="cpu")
    params = convert.params_from_jax(p0)
    st = gpt_hybrid.GPTTrainState(params, opt.init_state(params),
                                  torch.zeros((), dtype=torch.int32))
    losses = []
    for _ in range(5):
        st, loss = step_fn(st, toks, None, 2e-4)
        losses.append(loss.item())
    np.testing.assert_allclose(losses, j_losses, atol=1e-3, rtol=0)
    for ls in (losses, j_losses):
        assert all(b < a for a, b in zip(ls, ls[1:])), ls


def test_markov_recipe_trains_in_the_port():
    """tests/conftest.py's markov_gpt recipe — vocab 16, hidden 64, 2
    layers, bf16 compute, AdamW(3e-3), batches of 8 rows of the stream
    next = (tok * 3 + 1) % 13 — trained by the port's step from its own
    initialisation reaches loss < 0.1 within the recipe's 150 steps."""
    cfg = gpt.GPTConfig(vocab_size=16, hidden_size=64, num_layers=2,
                        num_heads=4, max_seq_len=32)
    init_fn, step_fn, _ = gpt_hybrid.build_gpt_train_step(
        cfg, AdamW(learning_rate=3e-3), device="cpu")
    st = init_fn(0)
    assert st.params["wte"].dtype == torch.float32      # fp32 masters
    rng = np.random.default_rng(0)

    def stream(B, T):
        t = rng.integers(0, 13, (B, 1))
        rows = [t]
        for _ in range(T):
            t = (t * 3 + 1) % 13
            rows.append(t)
        return np.concatenate(rows, 1)

    loss = None
    for _ in range(150):
        st, loss = step_fn(st, stream(8, 31), None, 3e-3)
        if loss.item() < 0.1:
            break
    assert loss.item() < 0.1, loss.item()


def test_gpt_module_trains_through_its_parameters():
    """``GPT(cfg, params, trainable=True)``: loss_fn on the module
    backpropagates into its parameters, equal to the functional grads."""
    cfg = convert.config_from_jax(_train_cfg())
    params = gpt.init_master_params(cfg, seed=2, device="cpu")
    toks = torch.from_numpy(TOKENS)
    _, ref = gpt_hybrid.value_and_grad(
        lambda p, t: gpt.loss_fn(p, t, cfg), params, toks)
    m = gpt.GPT(cfg, params, trainable=True)
    gpt.loss_fn(m, toks, cfg).backward()
    assert m.blocks["qkv_w" if "qkv_w" in m.blocks else "q_w"].grad \
        is not None
    for path, g in _leaves(ref):
        got = _get({"blocks": dict(m.blocks.items()),
                    **{n: p for n, p in m.named_parameters()
                       if "." not in n}}, path).grad
        torch.testing.assert_close(got, g, atol=0, rtol=0)
    assert not any(p.requires_grad for p in gpt.GPT(cfg, params).parameters())


def test_master_params_round_to_the_serving_params():
    cfg = gpt.GPTConfig(vocab_size=64, hidden_size=64, num_layers=2,
                        num_heads=4, max_seq_len=16)
    master = gpt.init_master_params(cfg, seed=4, device="cpu")
    served = gpt.init_params(cfg, seed=4, device="cpu")
    for path, t in _leaves(master):
        assert t.dtype == torch.float32
        assert torch.equal(t.to(torch.bfloat16), _get(served, path))


@pytest.mark.parametrize("field,value", [("dropout", 0.1), ("remat", True)])
def test_unported_config_values_raise(field, value):
    """Dropout and remat once raised here; both are ported now: the port's
    config and ``config_from_jax`` take them (remat with every reference
    policy), and a loss runs under them."""
    policies = [None, "dots", "dots_no_batch", "everything"] \
        if field == "remat" else [None]
    for policy in policies:
        kw = {field: value, "remat_policy": policy}
        cfg = gpt.GPTConfig(**kw)
        assert (cfg.dropout, cfg.remat, cfg.remat_policy) == (
            kw.get("dropout", 0.0), kw.get("remat", False), policy)
        jcfg = dataclasses.replace(_jcfg(), **kw)
        cfg = convert.config_from_jax(jcfg)
        assert getattr(cfg, field) == value and cfg.remat_policy == policy
        loss = gpt.loss_fn(gpt.init_master_params(cfg, 0, "cpu"),
                           torch.from_numpy(TOKENS), cfg, key=3)
        assert torch.isfinite(loss)


def test_remat_adafactor_accum_trajectory_matches_jax():
    """bench.py's ``gpt_1.3b_fused_remat_af`` recipe pieces at a small
    width — remat (policy "dots"), Adafactor, accum 2 — three steps of
    the port's step against the JAX step from the same weights."""
    jcfg = _jcfg("learned", "layernorm", "gelu", None, hidden_size=128,
                 remat=True, remat_policy="dots")
    mesh = Mesh(np.array(jax.devices()[:1]), ("dp",))
    jinit, jstep, _ = jhybrid.build_gpt_train_step(
        jcfg, mesh, jopt.Adafactor(learning_rate=1e-3), accum=2)
    rng = np.random.default_rng(6)
    batches = [rng.integers(0, 64, (4, 13)) for _ in range(3)]
    js = _jax_init(jinit, mesh)
    p0 = jax.device_get(js.params)
    j_losses = []
    for b in batches:
        js, loss = jstep(js, jnp.asarray(b, jnp.int32),
                         jax.random.PRNGKey(0), 1e-3)
        j_losses.append(float(loss))

    cfg = convert.config_from_jax(jcfg)
    assert cfg.remat and cfg.remat_policy == "dots"
    opt = Adafactor(learning_rate=1e-3)
    _, step_fn, _ = gpt_hybrid.build_gpt_train_step(cfg, opt, accum=2,
                                                    device="cpu")
    params = convert.params_from_jax(p0)
    st = gpt_hybrid.GPTTrainState(params, opt.init_state(params),
                                  torch.zeros((), dtype=torch.int32))
    assert len(st.opt_state["blocks"]["fc_w"]) == 2        # factored
    for i, b in enumerate(batches):
        st, loss = step_fn(st, b, None, None)     # lr: the optimizer's
        assert abs(loss.item() - j_losses[i]) < TOL, (i, loss, j_losses)
    # the key bias's gradient is 0 in exact arithmetic (softmax ignores a
    # shift shared by a query's scores), so in both packages it is
    # rounding noise that Adafactor (eps 1e-30) scales to steps of ~lr:
    # those rows are compared apart, by the bound on the steps they took
    # (|u| <= 1 / sqrt(1 - beta2_t) = t^0.4 at step t, in each package)
    jp = jax.device_get(js.params)
    kb, jkb = st.params["blocks"]["qkv_b"], jp["blocks"]["qkv_b"]
    keep = torch.ones(kb.shape, dtype=torch.bool)
    keep[:, 1] = False
    np.testing.assert_allclose(kb[keep].numpy(), np.asarray(jkb)[keep],
                               atol=1e-4, rtol=0)
    assert np.abs(kb[:, 1].numpy() - np.asarray(jkb[:, 1])).max() \
        <= 2 * sum(t ** 0.4 for t in range(1, len(batches) + 1)) * 1e-3
    _close_trees({n: v for n, v in st.params.items() if n != "blocks"},
                 jp, 1e-4)
    _close_trees({n: v for n, v in st.params["blocks"].items()
                  if n != "qkv_b"}, jp["blocks"], 1e-4)


def test_fused_ln_flag_takes_the_plain_norm_on_cpu(monkeypatch):
    """PADDLE_TPU_FUSED_LN=1 on the CPU: every LayerNorm of the port goes
    through ``fused_layer_norm`` on its kernels' plain twins (on a card, the
    kernels — tests/test_torch_kernels_cuda.py), and the loss matches the
    JAX package's flagged loss, whose Pallas kernels run in interpret mode
    (hidden 128: their gate wants F % 128 == 0)."""
    monkeypatch.setattr(jfused_norm, "_INTERPRET", True)
    monkeypatch.setenv("PADDLE_TPU_FUSED_LN", "1")
    jcfg = _jcfg(hidden_size=128)
    jp = jgpt.init_params(jcfg, jax.random.PRNGKey(1))
    ref = float(jgpt.loss_fn(jp, jnp.asarray(TOKENS), jcfg))
    cfg = convert.config_from_jax(jcfg)
    params = convert.params_from_jax(jax.device_get(jp))
    calls = []
    plain = fused_norm._plain_ln_fwd
    monkeypatch.setattr(fused_norm, "_plain_ln_fwd",
                        lambda *a: calls.append(1) or plain(*a))
    loss = gpt.loss_fn(params, torch.from_numpy(TOKENS), cfg)
    assert len(calls) == 2 * cfg.num_layers + 1
    assert abs(loss.item() - ref) < TOL


@pytest.mark.parametrize("arch", [GRID[0], GRID[-1], GRID[5]])
def test_flops_per_token_matches_jax(arch):
    jcfg = _jcfg(*arch)
    cfg = convert.config_from_jax(jcfg)
    assert gpt.flops_per_token(cfg, 2048) == jgpt.flops_per_token(jcfg, 2048)
    assert gpt.flops_per_token(gpt.gpt_1p3b(), 2048) \
        == jgpt.flops_per_token(jgpt.gpt_1p3b(), 2048)
    # an MoE config: the JAX package counts one dense FFN a block, and so
    # does the port (kept for parity)
    if jcfg.activation == "gelu":          # MoE experts are gelu FFNs
        jmoe_cfg = dataclasses.replace(
            jcfg, moe=jmoe.MoEConfig(num_experts=4, top_k=2))
        assert gpt.flops_per_token(convert.config_from_jax(jmoe_cfg), 2048) \
            == jgpt.flops_per_token(jmoe_cfg, 2048) \
            == jgpt.flops_per_token(jcfg, 2048)


def test_accum_must_divide_the_batch():
    cfg = convert.config_from_jax(_train_cfg())
    init_fn, step_fn, _ = gpt_hybrid.build_gpt_train_step(
        cfg, AdamW(1e-3), accum=3, device="cpu")
    with pytest.raises(ValueError, match="divide by accum 3"):
        step_fn(init_fn(0), TOKENS, None, 1e-3)
