"""MoE training in the port against the JAX package's, on the CPU:
``rng.normal`` (paddle_tpu_torch/rng.py), router noise and the gradients
of text/moe.py, the MoE loss under a key (text/gpt.py), the MoE train
step (text/gpt_hybrid.py) and the optimizers over the nested expert tree.

Tiny fp32 configs (≤ 2 layers, hidden ≤ 64, ≤ 4 experts); the same numpy
inputs reach both packages.

* ``rng.normal`` by law: mean and std within 5e-3 on 10^6 draws, the
  Kolmogorov-Smirnov distance to N(0, 1) (``math.erf``) below 5e-3; the
  same key gives the same bits, other keys other bits.
* ``moe_ffn`` value and ``value_and_grad`` of ``sum(y * r) + aux`` (a fixed
  random cotangent ``r``) against ``jax.value_and_grad`` of the JAX
  ``moe_ffn`` — y, aux and the grads of x and every expert leaf within
  1e-5 — at cf 1.25, at cf 0.5 (assignments dropped: the residual carries
  them, their gates get no gradient), at top-1, and at E = 1 against the
  JAX dense FFN on the same weights.
* Under noise, exactly: both draws replaced by one numpy array
  (``jax.random.normal`` as the JAX moe module sees it, the port's
  ``rng.normal``), so both packages route on the same noisy logits —
  values and grads within 1e-5.  No file of the JAX package changes.
* Under noise, by law: one token repeated 8192 times at sigma = 1, each
  expert's top-1 share in the port within 0.03 of JAX's (each package
  draws its own noise).
* ``gpt.loss_fn`` on an MoE config under a key (noise fixed as above),
  with ``PADDLE_TPU_FUSED_CE`` 0 and 1: loss and grads within 1e-5; full
  remat and "dots" bit-equal to no remat with the port's own noise.
* A 5-step AdamW trajectory of ``build_gpt_train_step`` at accum 1 and 2
  (noise fixed) against the JAX step on a 1-device mesh from
  ``params_from_jax``: losses within 1e-5, params within 1e-5 at accum 1
  and 1e-4 at accum 2 (the bf16 gradient carry, as in
  tests/test_torch_train.py); then a resume from the JAX step-3 state
  through ``opt_state_from_jax``.  An element whose gradient is a
  near-cancellation (0 < |g| < 1e-6 at some step: fewer than 1 in 100)
  is held to lr / 10 instead, since Adam divides it by |g| + 1e-8.
* The trainable ``GPT`` module's nested expert grads equal the functional
  ones; an MoE model trained in the port from its own init lowers its
  loss (the one-card counterpart of tests/test_moe.py's
  ``test_moe_gpt_trains``).
* AdamW (with ``apply_decay_param_fun`` on ``keystr`` names), Adafactor
  (the [L, E, D, F] stacks factored) and the global-norm clip over a tree
  with a ``blocks["moe"]`` subtree: the JAX package's steps.

Top-k near-ties move whole rows, so every exact test records the smallest
gap between the k-th and the (k+1)-th router probability the port saw and
asserts it above ``MARGIN``: a flip needs an error that large, three
orders of magnitude over the tolerances, so a failure here is a fault,
not a tie.
"""
import contextlib
import dataclasses
import functools
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.text import gpt as jgpt
from paddle_tpu.text import gpt_hybrid as jhybrid
from paddle_tpu.text import moe as jmoe
from paddle_tpu_torch import convert, rng
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.optimizer.optimizer import keystr
from paddle_tpu_torch.text import gpt, gpt_hybrid, moe

from test_torch_optimizer import _compare, _compare_state, _run
from test_torch_train import _close_trees, _get, _jax_init, _leaves

TOL = 1e-5
MARGIN = 1e-5
NOISE = np.random.default_rng(9).standard_normal((4096, 4)).astype(
    np.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@contextlib.contextmanager
def fixed_noise(keys=None):
    """Both packages' router draws replaced by the first rows of NOISE:
    ``jax.random.normal`` for an [N, E] draw (any other falls through)
    and the port's ``rng.normal``, which appends each key it is given to
    ``keys`` (when a list is passed), in the order of the draws."""
    real_j, real_t = jax.random.normal, rng.normal

    def j_normal(key, shape=(), dtype=jnp.float32):
        if len(shape) == 2 and shape[1] <= NOISE.shape[1]:
            return jnp.asarray(NOISE[:shape[0], :shape[1]], dtype)
        return real_j(key, shape, dtype)

    def t_normal(key, shape, device):
        if keys is not None:
            keys.append(int(key))
        return torch.from_numpy(NOISE[:shape[0], :shape[1]]).to(device)

    jax.random.normal, rng.normal = j_normal, t_normal
    try:
        yield
    finally:
        jax.random.normal, rng.normal = real_j, real_t


@contextlib.contextmanager
def margins(out):
    """Append, at each port routing, the smallest gap between a token's
    k-th and (k+1)-th router probability."""
    real = moe._top_k_gating

    def gating(logits, k):
        w, idx, probs = real(logits, k)
        if probs.shape[-1] > k:
            s = torch.sort(probs.detach(), dim=-1, descending=True).values
            out.append(float((s[:, k - 1] - s[:, k]).min()))
        return w, idx, probs

    moe._top_k_gating = gating
    try:
        yield
    finally:
        moe._top_k_gating = real


# --------------------------------------------------------------------------
# rng.normal
# --------------------------------------------------------------------------

def test_normal_draws_are_standard_normal_by_law():
    z = rng.normal(rng.seed_key(0), (1000, 1000), "cpu")
    assert z.dtype == torch.float32 and z.shape == (1000, 1000)
    assert abs(float(z.mean())) < 5e-3
    assert abs(float(z.std()) - 1.0) < 5e-3
    assert float(z.abs().max()) < 5.5
    x = np.sort(z.numpy().ravel().astype(np.float64))
    cdf = 0.5 * (1.0 + np.frompyfunc(math.erf, 1, 1)(x / math.sqrt(2.0))
                 .astype(np.float64))
    n = x.size
    ks = max(np.max(np.arange(1, n + 1) / n - cdf),
             np.max(cdf - np.arange(n) / n))
    assert ks < 5e-3, ks


def test_normal_draws_are_a_function_of_the_key():
    k = rng.fold_in(rng.seed_key(3), 2)
    a = rng.normal(k, (64, 8), "cpu")
    assert torch.equal(a, rng.normal(k, (64, 8), "cpu"))
    assert torch.equal(a, rng.normal(torch.tensor(k), (64, 8), "cpu"))
    b = rng.normal(rng.fold_in(rng.seed_key(3), 1), (64, 8), "cpu")
    assert not torch.equal(a, b)
    assert (a != b).float().mean() > 0.99
    # an element's draw depends on its flat index only
    assert torch.equal(rng.normal(k, (512,), "cpu"), a.reshape(-1))


def test_draws_stay_finite_at_the_extreme_bits():
    """Under these keys element 161 (37) draws the largest (smallest) 24
    high bits a hash can give, where a 24-bit midpoint uniform rounds to
    1.0 in float32 (and erfinv(1) and the Gumbel's log are infinite):
    there ``uniform`` stays inside (0, 1), ``normal`` and the server's
    ``gumbel`` finite."""
    base = rng.seed_key(3)
    for counter, i, top in ((27713, 161, (1 << 24) - 1), (57913, 37, 0)):
        key = rng.fold_in(base, counter)
        assert int(rng.bits(key, (256,), "cpu")[i]) >> 8 == top
        u = rng.uniform(key, (256,), "cpu")
        assert 0.0 < float(u.min()) and float(u.max()) < 1.0
        z = rng.normal(key, (256,), "cpu")
        assert bool(torch.isfinite(z).all()) and 5.0 < abs(float(z[i])) < 5.3
        gum = rng.gumbel(torch.tensor([base, counter]), (256,), "cpu")
        assert bool(torch.isfinite(gum).all())


# --------------------------------------------------------------------------
# moe_ffn: values and gradients
# --------------------------------------------------------------------------

LEAVES = ("router_w", "w_in", "b_in", "w_out", "b_out")


def _ffn_case(E=4, k=2, cf=1.25, noise=0.0, N=24, D=32, F=64, seed=5):
    """(moe params, x, r, MoEConfig kwargs) drawn from a numpy seed."""
    g = np.random.default_rng(seed)
    shapes = {"router_w": (D, E), "w_in": (E, D, F), "b_in": (E, F),
              "w_out": (E, F, D), "b_out": (E, D)}
    mp = {n: (g.standard_normal(s) * (0.3 if n == "router_w" else 0.1))
          .astype(np.float32) for n, s in shapes.items()}
    x = g.standard_normal((N, D)).astype(np.float32)
    r = g.standard_normal((N, D)).astype(np.float32)
    return mp, x, r, dict(num_experts=E, top_k=k, capacity_factor=cf,
                          router_noise=noise)


def _jax_ffn_vg(mp, x, r, kw, key=None):
    mcfg = jmoe.MoEConfig(**kw)

    def f(p, x):
        y, aux = jmoe.moe_ffn(p, x, mcfg, key=key)
        return jnp.sum(y * r) + aux, (y, aux)

    (val, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(
            {n: jnp.asarray(v) for n, v in mp.items()}, jnp.asarray(x))
    return float(val), np.asarray(y), float(aux), jax.device_get(gp), \
        np.asarray(gx)


def _port_ffn_vg(mp, x, r, kw, key=None):
    tp = {n: torch.from_numpy(v).requires_grad_(True) for n, v in mp.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    gaps = []
    with margins(gaps):
        y, aux, st = moe.moe_ffn(tp, tx, moe.MoEConfig(**kw), key=key,
                                 with_stats=True)
    val = torch.sum(y * torch.from_numpy(r)) + aux
    val.backward()
    return (val.item(), y.detach().numpy(), aux.item(),
            {n: t.grad.numpy() for n, t in tp.items()}, tx.grad.numpy(),
            st, gaps)


def _hold_ffn(port, ref, what):
    val, y, aux, gp, gx, _, gaps = port
    rval, ry, raux, rgp, rgx = ref
    if gaps:
        assert min(gaps) > MARGIN, (what, min(gaps))
    np.testing.assert_allclose(y, ry, atol=TOL, rtol=0, err_msg=what)
    assert abs(aux - raux) < TOL and abs(val - rval) < 10 * TOL, \
        (what, aux, raux, val, rval)
    np.testing.assert_allclose(gx, rgx, atol=TOL, rtol=0, err_msg=what)
    for n in LEAVES:
        np.testing.assert_allclose(gp[n], np.asarray(rgp[n]), atol=TOL,
                                   rtol=0, err_msg=f"{what} {n}")


@pytest.mark.parametrize("case", ["cf1.25", "cf0.5", "top1"])
def test_moe_ffn_value_and_grad_match_jax(case):
    kw = {"cf1.25": {}, "cf0.5": dict(cf=0.5), "top1": dict(k=1)}[case]
    mp, x, r, mkw = _ffn_case(**kw)
    port = _port_ffn_vg(mp, x, r, mkw)
    _hold_ffn(port, _jax_ffn_vg(mp, x, r, mkw), case)
    if case == "cf0.5":
        assert int(port[5]["dropped"]) > 0
    # the gates' gradient reaches the router; the load statistic's does not
    assert np.abs(port[3]["router_w"]).max() > 0


def test_single_expert_is_the_dense_ffn():
    """E = 1, top-1, cf 1: every token keeps its one slot, the gate is 1,
    so the MoE FFN is the JAX dense FFN on w_in[0] ... b_out[0] — values
    and grads (the router's is exactly 0: a softmax over one logit)."""
    mp, x, r, mkw = _ffn_case(E=1, k=1, cf=1.0)
    val, y, aux, gp, gx, st, _ = _port_ffn_vg(mp, x, r, mkw)
    assert int(st["dropped"]) == 0
    jcfg = jgpt.GPTConfig(hidden_size=32, num_heads=4, ffn_ratio=2,
                          dtype=jnp.float32)
    names = {"fc_w": "w_in", "fc_b": "b_in", "out_w": "w_out",
             "out_b": "b_out"}

    def dense(p, x):
        y = jgpt._ffn_body(x, p, jcfg)
        return jnp.sum(y * r), y

    (rval, ry), (rgp, rgx) = jax.jit(jax.value_and_grad(
        dense, argnums=(0, 1), has_aux=True))(
            {d: jnp.asarray(mp[m][0]) for d, m in names.items()},
            jnp.asarray(x))
    np.testing.assert_allclose(y, np.asarray(ry), atol=TOL, rtol=0)
    assert abs(aux - 0.01) < 1e-7          # E · fe · me · weight = 0.01
    np.testing.assert_allclose(gx, np.asarray(rgx), atol=TOL, rtol=0)
    for d, m in names.items():
        np.testing.assert_allclose(gp[m][0], np.asarray(rgp[d]), atol=TOL,
                                   rtol=0, err_msg=m)
    assert not np.any(gp["router_w"])
    # and the JAX moe_ffn at E = 1 agrees with both
    _hold_ffn((val, y, aux, gp, gx, st, []), _jax_ffn_vg(mp, x, r, mkw),
              "E=1")


@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_moe_ffn_under_noise_matches_jax_exactly(cf):
    """router_noise 0.5 under a key, both draws fed the same array."""
    mp, x, r, mkw = _ffn_case(cf=cf, noise=0.5, seed=6)
    with fixed_noise():
        ref = _jax_ffn_vg(mp, x, r, mkw, key=jax.random.PRNGKey(0))
        port = _port_ffn_vg(mp, x, r, mkw, key=rng.seed_key(0))
    _hold_ffn(port, ref, f"noise cf {cf}")
    # the noise moved the routing: without it the output differs
    quiet = _port_ffn_vg(mp, x, r, mkw, key=None)
    assert not np.allclose(quiet[1], port[1], atol=1e-3)


def test_router_noise_by_law():
    """One token repeated 8192 times at sigma = 1 (8 calls of 1024 tokens,
    each its own key, dropless): each expert's top-1 share — the expert of
    the larger combine weight — in the port within 0.03 of JAX's."""
    D, E, N = 32, 4, 1024
    g = np.random.default_rng(11)
    w = (g.standard_normal((D, E)) * 0.05).astype(np.float32)
    x = np.repeat(g.standard_normal((1, D)).astype(np.float32), N, 0)
    kw = dict(num_experts=E, top_k=2, capacity_factor=2.0, router_noise=1.0)
    shares = {}
    jroute = jax.jit(lambda key: jmoe._route(
        {"router_w": jnp.asarray(w)}, jnp.asarray(x), jmoe.MoEConfig(**kw),
        key, E, N, jnp.float32)[1])
    for name, keys in (("jax", jax.random.split(jax.random.PRNGKey(0), 8)),
                       ("port", [rng.fold_in(rng.seed_key(0), i)
                                 for i in range(8)])):
        top = np.zeros(E)
        for key in keys:
            if name == "jax":
                comb = jroute(key)
            else:
                _, comb, _ = moe._route(
                    {"router_w": torch.from_numpy(w)}, torch.from_numpy(x),
                    moe.MoEConfig(**kw), key, E, N, torch.float32)
            top += np.bincount(np.asarray(comb).sum(-1).argmax(-1),
                               minlength=E)
        shares[name] = top / (8 * N)
    assert np.abs(shares["port"] - shares["jax"]).max() < 0.03, shares
    assert shares["port"].min() > 0.05      # the noise spreads the token


# --------------------------------------------------------------------------
# the model: loss_fn under a key, remat, the module
# --------------------------------------------------------------------------

def _moe_jcfg(cf=1.25, noise=0.1, **kw):
    base = dict(vocab_size=64, hidden_size=64, num_layers=2, num_heads=4,
                max_seq_len=32, dtype=jnp.float32,
                moe=jmoe.MoEConfig(num_experts=4, top_k=2,
                                   capacity_factor=cf, router_noise=noise))
    base.update(kw)
    return jgpt.GPTConfig(**base)


TOKENS = np.random.default_rng(0).integers(0, 64, (2, 13))


@functools.lru_cache(maxsize=None)
def _jax_moe_loss_and_grads(cf):
    jcfg = _moe_jcfg(cf)
    jp = jgpt.init_params(jcfg, jax.random.PRNGKey(1))
    with fixed_noise():
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p, t, k: jgpt.loss_fn(p, t, jcfg, key=k)))(
                jp, jnp.asarray(TOKENS), jax.random.PRNGKey(2))
    return jcfg, jax.device_get(jp), float(loss), jax.device_get(grads)


@pytest.mark.parametrize("cf", [1.25, 0.5])
@pytest.mark.parametrize("fused_ce", ["0", "1"])
def test_loss_and_grads_under_a_key_match_jax(fused_ce, cf, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_FUSED_CE", fused_ce)
    jcfg, jp, ref_loss, ref_grads = _jax_moe_loss_and_grads(cf)
    cfg = convert.config_from_jax(jcfg)
    assert cfg.moe.router_noise == 0.1
    gaps, keys = [], []
    with fixed_noise(keys), margins(gaps):
        loss, grads = gpt_hybrid.value_and_grad(
            lambda p, t: gpt.loss_fn(p, t, cfg, key=7),
            convert.params_from_jax(jp), torch.from_numpy(TOKENS))
    assert min(gaps) > MARGIN, min(gaps)
    # layer l routes under fold_in(fold_in(key, l), 2)
    assert keys == [rng.fold_in(rng.fold_in(7, l), 2) for l in range(2)]
    assert abs(loss.item() - ref_loss) < TOL, (loss.item(), ref_loss)
    _close_trees(grads, ref_grads)
    assert set(grads["blocks"]["moe"]) == set(LEAVES)


def test_remat_redraws_the_same_noise():
    """Full remat and "dots" under a key with the port's own noise: loss
    and every grad bit-equal to the run without remat."""
    cfg = convert.config_from_jax(_moe_jcfg(noise=0.5))
    params = gpt.init_master_params(cfg, seed=3, device="cpu")
    toks = torch.from_numpy(TOKENS)
    runs = {}
    for name, kw in (("none", {}), ("full", dict(remat=True)),
                     ("dots", dict(remat=True, remat_policy="dots"))):
        c = dataclasses.replace(cfg, **kw)
        runs[name] = gpt_hybrid.value_and_grad(
            lambda p, t: gpt.loss_fn(p, t, c, key=5), params, toks)
    for name in ("full", "dots"):
        loss, grads = runs[name]
        assert torch.equal(loss, runs["none"][0]), name
        for path, g in _leaves(grads):
            assert torch.equal(g, _get(runs["none"][1], path)), (name, path)
    quiet = gpt.loss_fn(params, toks, cfg)
    assert not torch.equal(quiet, runs["none"][0])   # the key drew noise


def test_gpt_module_receives_the_expert_grads():
    cfg = convert.config_from_jax(_moe_jcfg())
    params = gpt.init_master_params(cfg, seed=2, device="cpu")
    toks = torch.from_numpy(TOKENS)
    _, ref = gpt_hybrid.value_and_grad(
        lambda p, t: gpt.loss_fn(p, t, cfg, key=4), params, toks)
    m = gpt.GPT(cfg, params, trainable=True)
    gpt.loss_fn(m, toks, cfg, key=4).backward()
    tree = {"blocks": {n: (dict(v.items()) if n == "moe" else v)
                       for n, v in m.blocks.items()},
            **{n: p for n, p in m.named_parameters() if "." not in n}}
    for path, g in _leaves(ref):
        torch.testing.assert_close(_get(tree, path).grad, g, atol=0, rtol=0)
    assert m.blocks["moe"]["router_w"].grad.abs().max() > 0


# --------------------------------------------------------------------------
# the train step
# --------------------------------------------------------------------------

# a gradient element this small is a near-cancellation of terms ~1e-2
# (fp32 rounding leaves it a few 1e-9 off in either package), and Adam's
# first steps divide it by |g| + 1e-8: such elements move by a share of lr
# that rounding decides, so they are held to lr / 10 apart
TINY_GRAD = 1e-6


def _record_tiny_grads(opt):
    """Wrap ``opt.apply_gradients`` to OR up, per leaf, a mask of the
    elements whose gradient fell below TINY_GRAD at some step."""
    tiny, apply = {}, opt.apply_gradients

    def recording(grads, *args, **kw):
        for path, g in _leaves(grads):
            m = (g.abs() < TINY_GRAD) & (g != 0)
            tiny[path] = m if path not in tiny else tiny[path] | m
        return apply(grads, *args, **kw)

    opt.apply_gradients = recording
    return tiny


def _close_trees_apart(tp, jp, tol, tiny):
    """Params within ``tol``, but the tiny-gradient elements within lr /
    10 (1e-4) — and fewer than 1 in 100 of them (the attention key bias,
    whose gradient is 0 in exact arithmetic, among them)."""
    n_tiny = sum(int(m.sum()) for m in tiny.values())
    assert n_tiny < 1e-2 * sum(m.numel() for m in tiny.values()), n_tiny
    for path, t in _leaves(tp):
        got, want = t.numpy(), np.asarray(_get(jp, path), np.float32)
        m = tiny[path].numpy()
        np.testing.assert_allclose(got[~m], want[~m], atol=tol, rtol=0,
                                   err_msg=str(path))
        np.testing.assert_allclose(got[m], want[m], atol=1e-4, rtol=0,
                                   err_msg=f"{path}, tiny grads")


@pytest.mark.parametrize("accum", [1, 2])
def test_trajectory_matches_jax_and_resumes(accum):
    jcfg = _moe_jcfg(pos_embed="rope")
    mesh = Mesh(np.array(jax.devices()[:1]), ("dp",))
    jinit, jstep, _ = jhybrid.build_gpt_train_step(
        jcfg, mesh, jopt.AdamW(learning_rate=1e-3, weight_decay=0.01),
        accum=accum)
    g = np.random.default_rng(5)
    batches = [g.integers(0, 64, (4, 13)) for _ in range(5)]
    js = _jax_init(jinit, mesh)
    p0 = jax.device_get(js.params)
    assert p0["blocks"]["moe"]["router_w"].dtype == np.float32
    j_losses, snap = [], None
    with fixed_noise():
        for i, b in enumerate(batches):
            js, loss = jstep(js, jnp.asarray(b, jnp.int32),
                             jax.random.PRNGKey(0), 1e-3)
            j_losses.append(float(loss))
            if i == 2:
                snap = jax.device_get((js.params, js.opt_state, js.step))
    j_final = jax.device_get(js.params)

    cfg = convert.config_from_jax(jcfg)
    opt = topt.AdamW(learning_rate=1e-3, weight_decay=0.01)
    _, step_fn, _ = gpt_hybrid.build_gpt_train_step(cfg, opt, accum=accum,
                                                    device="cpu")
    params = convert.params_from_jax(p0)
    st = gpt_hybrid.GPTTrainState(params, opt.init_state(params),
                                  torch.zeros((), dtype=torch.int32))
    p_tol = TOL if accum == 1 else 1e-4
    tiny = _record_tiny_grads(opt)
    gaps, keys = [], []
    with fixed_noise(keys), margins(gaps):
        for i, b in enumerate(batches):
            st, loss = step_fn(st, b, 0, 1e-3)
            assert abs(loss.item() - j_losses[i]) < TOL, (i, loss, j_losses)
        assert min(gaps) > MARGIN, min(gaps)
        # micro-batch m of a step under key 0 draws layer l's noise under
        # fold_in(fold_in(fold_in(0, m), l), 2) (the step's own key at
        # accum 1): one key a draw, none shared with another layer or
        # micro-batch, nor with a dropout key (fold_in(layer key, 0 or 1))
        micro = ([0] if accum == 1 else [rng.fold_in(0, m)
                                         for m in range(accum)])
        want = [rng.fold_in(rng.fold_in(k, l), 2)
                for k in micro for l in range(2)]
        assert keys == 5 * want, (keys, want)
        dropout = {rng.fold_in(rng.fold_in(k, l), d)
                   for k in micro for l in range(2) for d in (0, 1)}
        assert len(set(want)) == len(want) and not dropout & set(want)
        _close_trees_apart(st.params, j_final, p_tol, tiny)
        # resume mid-run: the JAX state after step 3, two more port steps
        sp, so, sstep = snap
        st = gpt_hybrid.GPTTrainState(
            convert.params_from_jax(sp), convert.opt_state_from_jax(so),
            torch.tensor(int(sstep), dtype=torch.int32))
        assert st.opt_state["blocks"]["moe"]["w_in"][0].shape \
            == (2, 4, 64, 256)
        for i in (3, 4):
            st, loss = step_fn(st, batches[i], 0, 1e-3)
            assert abs(loss.item() - j_losses[i]) < TOL
    _close_trees_apart(st.params, j_final, p_tol, tiny)


def test_moe_model_trains_from_its_own_init():
    """The port's MoE GPT from ``init_fn`` under a key (router noise on),
    AdamW on the Markov stream next = (tok * 3 + 1) % 13: the loss falls
    over five steps, and the experts and the router moved."""
    cfg = gpt.GPTConfig(vocab_size=16, hidden_size=64, num_layers=2,
                        num_heads=4, max_seq_len=32,
                        moe=moe.MoEConfig(num_experts=4, top_k=2,
                                          router_noise=0.1))
    init_fn, step_fn, _ = gpt_hybrid.build_gpt_train_step(
        cfg, topt.AdamW(learning_rate=3e-3), accum=2, device="cpu")
    st = init_fn(0)
    m0 = {n: t.clone() for n, t in st.params["blocks"]["moe"].items()}
    g = np.random.default_rng(0)
    t = g.integers(0, 13, (8, 1))
    rows = [t]
    for _ in range(16):
        t = (t * 3 + 1) % 13
        rows.append(t)
    batch = np.concatenate(rows, 1)
    losses = []
    for i in range(5):
        st, loss = step_fn(st, batch, rng.fold_in(rng.seed_key(0), i), 3e-3)
        losses.append(loss.item())
    assert all(map(math.isfinite, losses))
    assert losses[-1] < losses[0] - 0.1, losses
    for n, t0 in m0.items():
        assert not torch.equal(st.params["blocks"]["moe"][n], t0), n


# --------------------------------------------------------------------------
# the optimizers over the nested expert tree
# --------------------------------------------------------------------------

# a tree with a blocks["moe"] subtree at widths where Adafactor factors
# the [L, E, D, F] stacks (both trailing axes >= 128) and not router_w
MOE_SHAPES = {"wte": (16, 128), "ln_f_g": (128,),
              "blocks": {"ln1_g": (2, 128), "proj_w": (2, 128, 128),
                         "moe": {"router_w": (2, 128, 4),
                                 "w_in": (2, 4, 128, 128),
                                 "b_in": (2, 4, 128),
                                 "w_out": (2, 4, 128, 128),
                                 "b_out": (2, 4, 128)}}}


def _no_decay_on_router_or_biases(seen):
    def fn(name):
        seen.append(name)
        return not (name.endswith("['router_w']") or name.endswith("_b']")
                    or name.endswith("_g']"))
    return fn


@pytest.mark.parametrize("name", ["AdamW", "Adafactor", "Adafactor_beta1",
                                  "AdamW_clip"])
def test_optimizers_over_the_expert_tree_match_jax(name):
    seen = {"jax": [], "torch": []}

    def make(mod, which):
        if name == "AdamW":
            return mod.AdamW(learning_rate=1e-2, weight_decay=0.1,
                             apply_decay_param_fun=
                             _no_decay_on_router_or_biases(seen[which]))
        if name == "AdamW_clip":
            clip = (jnn if mod is jopt else tnn).ClipGradByGlobalNorm(0.5)
            return mod.AdamW(learning_rate=1e-2, grad_clip=clip)
        return mod.Adafactor(learning_rate=1e-2,
                             beta1=0.9 if name.endswith("beta1") else None)

    steps = list(_run(lambda: make(jopt, "jax"), lambda: make(topt, "torch"),
                      steps=3, shapes=MOE_SHAPES))
    for _, jp, js, tp, ts in steps:
        _compare(tp, jp, 1e-6)
        _compare_state(ts, js)
    ts = steps[-1][4]
    if name.startswith("Adafactor"):
        assert [tuple(a.shape) for a in ts["blocks"]["moe"]["w_in"][:2]] \
            == [(2, 4, 128), (2, 4, 128)]                    # factored
        assert ts["blocks"]["moe"]["router_w"][0].shape == (2, 128, 4)
    if name == "AdamW":
        assert sorted(seen["jax"]) == sorted(seen["torch"])
        assert "['blocks']['moe']['router_w']" in seen["torch"]
        assert sorted(set(seen["torch"])) == sorted(
            keystr(p) for p, _ in _leaves(MOE_SHAPES))
