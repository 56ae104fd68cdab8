"""The port's fused LayerNorm (paddle_tpu_torch/ops/fused_norm.py) held
against the JAX package's Pallas kernels ``_ln_fwd_impl`` /
``_ln_bwd_impl`` (interpret mode on the CPU) and against autograd of the
plain expression; and ``gpt.loss_fn`` with ``PADDLE_TPU_FUSED_LN=1``
against the JAX package's flagged loss.

Tolerances.  fp32: y, mu, rstd and dx within 1e-5 (the Pallas body and
the plain twin sum a row in another order); dg and db are sums over all
rows — 1e-5 absolute plus 1e-5 relative.  bf16 x (the train path's: fp32
statistics, bf16 y and dx): y and dx within one bf16 ulp where the fp32
summation order tips a rounding, 1e-2·(1 + |ref|); mu, rstd, dg, db stay
fp32 (1e-5; dg and db 1e-4 relative, their rows being bf16-rounded dy).
Losses and grads of the fp32 model: 1e-5.  The CUDA kernels run only on
a card: tests/test_torch_kernels_cuda.py holds them against these twins.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops import fused_norm as jfn
from paddle_tpu.text import gpt as jgpt
from paddle_tpu_torch import convert
from paddle_tpu_torch.ops import fused_norm as fn
from paddle_tpu_torch.text import gpt, gpt_hybrid

from test_torch_gpt import _jcfg

TOL = 1e-5


@pytest.fixture()
def interpret(monkeypatch):
    monkeypatch.setattr(jfn, "_INTERPRET", True)


def _case(N, F, seed=0):
    rng = np.random.default_rng(seed)
    x = (2.0 * rng.standard_normal((N, F)) + 0.5).astype(np.float32)
    g = rng.uniform(0.5, 1.5, F).astype(np.float32)
    b = rng.standard_normal(F).astype(np.float32)
    dy = rng.standard_normal((N, F)).astype(np.float32)
    return x, g, b, dy


# (40, 256): the Pallas grid has five 8-row blocks, so its dg/db carry
# across grid steps is live; (64, 128): one 64-row block
@pytest.mark.parametrize("N,F", [(40, 256), (64, 128)])
def test_plain_twins_match_pallas_interpret_fp32(interpret, N, F):
    x, g, b, dy = _case(N, F)
    jy, jmu, jr = jfn._ln_fwd_impl(jnp.asarray(x), jnp.asarray(g),
                                   jnp.asarray(b), 1e-5)
    jdx, jdg, jdb = jfn._ln_bwd_impl(jnp.asarray(x), jnp.asarray(g), jmu,
                                     jr, jnp.asarray(dy))
    t = [torch.from_numpy(a) for a in (x, g, b, dy)]
    y, mu, r = fn.ln_fwd(t[0], t[1], t[2])
    assert y.dtype == torch.float32 and mu.shape == r.shape == (N, 1)
    for got, ref in ((y, jy), (mu, jmu), (r, jr)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL,
                                   rtol=0)
    dx, dg, db = fn.ln_bwd(t[0], t[1], mu, r, t[3])
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), atol=TOL, rtol=0)
    for got, ref in ((dg, jdg), (db, jdb)):
        assert got.dtype == torch.float32 and got.shape == (F,)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL,
                                   rtol=TOL)


def test_plain_twins_match_pallas_interpret_bf16_x(interpret):
    """bf16 x and dy with fp32 g and b — the train path's dtypes."""
    x, g, b, dy = _case(40, 256, seed=1)
    jx, jdy = jnp.asarray(x, jnp.bfloat16), jnp.asarray(dy, jnp.bfloat16)
    jy, jmu, jr = jfn._ln_fwd_impl(jx, jnp.asarray(g), jnp.asarray(b), 1e-5)
    jdx, jdg, jdb = jfn._ln_bwd_impl(jx, jnp.asarray(g), jmu, jr, jdy)
    tx = torch.from_numpy(x).bfloat16()
    tdy = torch.from_numpy(dy).bfloat16()
    y, mu, r = fn.ln_fwd(tx, torch.from_numpy(g), torch.from_numpy(b))
    dx, dg, db = fn.ln_bwd(tx, torch.from_numpy(g), mu, r, tdy)
    assert y.dtype == dx.dtype == torch.bfloat16
    for got, ref in ((y, jy), (dx, jdx)):
        ref = np.asarray(ref, np.float32)
        np.testing.assert_allclose(got.float().numpy(), ref,
                                   atol=1e-2, rtol=1e-2)
    for got, ref in ((mu, jmu), (r, jr)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL,
                                   rtol=0)
    for got, ref in ((dg, jdg), (db, jdb)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL,
                                   rtol=1e-4)


def _plain_ln(x, w, b, eps=1e-5):
    m = x.mean(dim=-1, keepdim=True)
    v = ((x - m) ** 2).mean(dim=-1, keepdim=True)
    return (x - m) * torch.rsqrt(v + eps) * w + b


def test_fused_ln_grads_match_autograd_of_the_plain_expression():
    """Leading dims and a width that is not a multiple of 128; the fp32
    grads of x, weight and bias equal autograd's through the plain
    expression.  A bf16 bias gets its grad in bf16."""
    rng = np.random.default_rng(2)
    x0 = rng.standard_normal((2, 5, 96)).astype(np.float32)
    w0 = rng.uniform(0.5, 1.5, 96).astype(np.float32)
    b0 = rng.standard_normal(96).astype(np.float32)
    c = torch.from_numpy(rng.standard_normal((2, 5, 96)).astype(np.float32))
    grads = []
    for f in (fn.fused_layer_norm, _plain_ln):
        x, w, b = (torch.from_numpy(a).requires_grad_() for a in (x0, w0, b0))
        y = f(x, w, b)
        (y * c).sum().backward()
        grads.append((y.detach(), x.grad, w.grad, b.grad))
    for got, ref in zip(*grads):
        torch.testing.assert_close(got, ref, atol=TOL, rtol=TOL)

    xb = torch.from_numpy(x0).bfloat16().requires_grad_()
    w = torch.from_numpy(w0).requires_grad_()
    b = torch.from_numpy(b0).bfloat16().requires_grad_()
    y = fn.fused_layer_norm(xb, w, b)
    y.float().sum().backward()
    assert y.dtype == xb.grad.dtype == b.grad.dtype == torch.bfloat16
    assert w.grad.dtype == torch.float32
    ref = _plain_ln(xb.float(), w, b.float())
    torch.testing.assert_close(y.float(), ref.detach(), atol=1e-2, rtol=1e-2)


def test_defaults_and_no_launches_on_the_cpu():
    """weight / bias default to ones / zeros (the JAX package's defaults);
    a CPU tensor never counts a kernel launch."""
    x = torch.from_numpy(_case(6, 32)[0])
    before = (fn.ln_fwd.launches, fn.ln_bwd.launches)
    y = fn.fused_layer_norm(x)
    ref = torch.nn.functional.layer_norm(x, (32,), eps=1e-5)
    torch.testing.assert_close(y, ref, atol=TOL, rtol=0)
    assert (fn.ln_fwd.launches, fn.ln_bwd.launches) == before


@pytest.mark.parametrize("N", [1, 7, 131, 132, 133, 2048, 4096, 5000])
@pytest.mark.parametrize("sms", [132, 114])
def test_bwd_plan_covers_rows_once_with_a_partial_per_sm_at_most(N, sms):
    R, P = fn.bwd_plan(N, sms)
    assert 1 <= P <= sms
    rows = [r for b in range(P) for r in range(b * R, min((b + 1) * R, N))]
    assert rows == list(range(N))             # each row once, in order
    assert all(b * R < N for b in range(P))   # no CTA without a row


@pytest.mark.parametrize("arch", [("learned", "gelu", None),
                                  ("rope", "swiglu", 2)])
def test_loss_and_grads_with_fused_ln_match_jax(interpret, monkeypatch,
                                                arch):
    """``PADDLE_TPU_FUSED_LN=1`` in both packages: the JAX loss runs the
    Pallas kernels in interpret mode (hidden 128: the TPU gate wants
    F % 128 == 0; B·T = 24 rows, three 8-row blocks), the port's through
    ``_FusedLN`` on the plain twins — loss and every grad within 1e-5."""
    monkeypatch.setenv("PADDLE_TPU_FUSED_LN", "1")
    pos, act, kvh = arch
    jcfg = _jcfg(pos, "layernorm", act, kvh, hidden_size=128)
    jp = jgpt.init_params(jcfg, jax.random.PRNGKey(3))
    toks = np.random.default_rng(4).integers(0, 64, (2, 13))
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(
        lambda p, t: jgpt.loss_fn(p, t, jcfg)))(jp, jnp.asarray(toks))
    ref_grads = jax.device_get(ref_grads)
    cfg = convert.config_from_jax(jcfg)
    calls = []
    plain = fn._plain_ln_bwd
    monkeypatch.setattr(fn, "_plain_ln_bwd",
                        lambda *a: calls.append(1) or plain(*a))
    loss, grads = gpt_hybrid.value_and_grad(
        lambda p, t: gpt.loss_fn(p, t, cfg),
        convert.params_from_jax(jax.device_get(jp)), torch.from_numpy(toks))
    assert len(calls) == 2 * cfg.num_layers + 1      # every norm, fused
    assert abs(loss.item() - float(ref_loss)) < TOL
    for name, g in grads.items():
        subs = g.items() if name == "blocks" else [(name, g)]
        ref = ref_grads[name]
        for k, t in subs:
            r = ref[k] if name == "blocks" else ref
            np.testing.assert_allclose(t.numpy(), np.asarray(r), atol=TOL,
                                       rtol=0, err_msg=f"{name}.{k}")
