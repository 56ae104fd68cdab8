"""The port's fused softmax cross-entropy (paddle_tpu_torch/ops/
fused_ce.py) held against the JAX package's Pallas kernels
(``_ce_fwd_impl`` / ``_ce_bwd_impl``, interpret mode on the CPU) and its
XLA expression ``_xla_ce``.

Tolerances: fp32.  The Pallas forward walks 128-column vocab blocks with
an online max/sum where the plain twin takes one max and one sum per row:
loss and lse within 1e-6 absolute + 1e-6 relative (a few fp32 ulps at
|loss| ~ 6); the backward is elementwise on the same lse: 1e-6.  Against
``_xla_ce`` at ragged shapes (which the TPU kernel does not take without
padding): 1e-5.  The CUDA kernels run only on a card:
tests/test_torch_kernels_cuda.py holds them against these plain twins.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops import fused_ce as jfc
from paddle_tpu_torch.ops import fused_ce as fc


@pytest.fixture()
def interpret():
    old = jfc._INTERPRET
    jfc._INTERPRET = True
    yield
    jfc._INTERPRET = old


def _case(N, V, seed=0, lead=None):
    rng = np.random.default_rng(seed)
    shape = lead if lead is not None else (N,)
    logits = (3.0 * rng.standard_normal(shape + (V,))).astype(np.float32)
    labels = rng.integers(0, V, shape).astype(np.int64)
    return logits, labels


def test_plain_fwd_matches_pallas_interpret(interpret):
    """N = 64, V = 256: two 128-column vocab blocks per row, so the online
    rescale and the cross-block label pick are live in the Pallas body."""
    x, y = _case(64, 256)
    x[0, 5], x[0, 200] = 40.0, 41.0            # maxima in different blocks
    loss, lse = jfc._ce_fwd_impl(jnp.asarray(x), jnp.asarray(y, jnp.int32))
    got_loss, got_lse = fc.ce_fwd(torch.from_numpy(x), torch.from_numpy(y))
    assert got_loss.dtype == got_lse.dtype == torch.float32
    np.testing.assert_allclose(got_loss.numpy(), np.asarray(loss),
                               atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(lse)[:, 0],
                               atol=1e-6, rtol=1e-6)


def test_plain_bwd_matches_pallas_interpret(interpret):
    x, y = _case(64, 256, seed=1)
    dl = np.random.default_rng(2).standard_normal(64).astype(np.float32)
    _, lse = jfc._ce_fwd_impl(jnp.asarray(x), jnp.asarray(y, jnp.int32))
    ref = jfc._ce_bwd_impl(jnp.asarray(x), jnp.asarray(y, jnp.int32), lse,
                           jnp.asarray(dl))
    got = fc.ce_bwd(torch.from_numpy(x), torch.from_numpy(y),
                    torch.from_numpy(np.array(lse)[:, 0]),
                    torch.from_numpy(dl))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6,
                               rtol=0)


def test_fused_ce_grads_match_pallas_custom_vjp(interpret):
    """The autograd Function against jax.vjp of the custom-vjp
    ``_fused_ce`` (both Pallas kernels, interpret mode)."""
    x, y = _case(64, 256, seed=3)
    dl = np.random.default_rng(4).standard_normal(64).astype(np.float32)
    loss, vjp = jax.vjp(lambda a: jfc._fused_ce(a, jnp.asarray(y, jnp.int32)),
                        jnp.asarray(x))
    (ref,) = vjp(jnp.asarray(dl))
    tx = torch.from_numpy(x).requires_grad_()
    got = fc.fused_softmax_ce(tx, torch.from_numpy(y))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(loss),
                               atol=1e-6, rtol=1e-6)
    got.backward(torch.from_numpy(dl))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(ref), atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("lead,V", [((37,), 1000), ((2, 5), 77),
                                    ((3, 1), 50)])
def test_fused_ce_matches_xla_ce_at_ragged_shapes(lead, V):
    """Shapes the TPU kernel takes only after padding rows and needs a
    128-divisible vocab for: the port takes them as they are.  Loss and
    dlogits against the JAX package's XLA expression."""
    x, y = _case(None, V, seed=5, lead=lead)
    dl = np.random.default_rng(6).standard_normal(lead).astype(np.float32)

    def ref_fn(a):
        out = jfc._xla_ce(a.reshape(-1, V), jnp.asarray(y.reshape(-1)))
        return jnp.sum(out.reshape(lead) * dl), out

    (_, ref_loss), ref_g = jax.value_and_grad(ref_fn, has_aux=True)(
        jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    got = fc.fused_softmax_ce(tx, torch.from_numpy(y))
    assert got.shape == lead and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy().reshape(-1),
                               np.asarray(ref_loss), atol=1e-5, rtol=0)
    got.backward(torch.from_numpy(dl))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(ref_g),
                               atol=1e-5, rtol=0)


def test_label_outside_vocab_picks_nothing(interpret):
    """A label outside [0, V) matches no column in the Pallas body: pick 0,
    no one-hot in the backward.  The plain twins (and the kernels) agree."""
    x, y = _case(64, 256, seed=7)
    y[3], y[10] = -1, 256
    loss, lse = jfc._ce_fwd_impl(jnp.asarray(x), jnp.asarray(y, jnp.int32))
    dl = np.ones(64, np.float32)
    ref = jfc._ce_bwd_impl(jnp.asarray(x), jnp.asarray(y, jnp.int32), lse,
                           jnp.asarray(dl))
    got_loss, got_lse = fc.ce_fwd(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(got_loss.numpy(), np.asarray(loss),
                               atol=1e-6, rtol=1e-6)
    got = fc.ce_bwd(torch.from_numpy(x), torch.from_numpy(y), got_lse,
                    torch.from_numpy(dl))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6,
                               rtol=0)


def test_bf16_logits_keep_their_dtype():
    x, y = _case(16, 64, seed=8)
    tx = torch.from_numpy(x).bfloat16().requires_grad_()
    loss = fc.fused_softmax_ce(tx, torch.from_numpy(y))
    assert loss.dtype == torch.float32
    loss.sum().backward()
    assert tx.grad.dtype == torch.bfloat16
    ref = fc._plain_ce_fwd(tx.detach().float(), torch.from_numpy(y))[0]
    torch.testing.assert_close(loss.detach(), ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("args,match", [
    ((torch.zeros(4, 8, dtype=torch.float16), torch.zeros(4).long()),
     "float32 or bfloat16"),
    ((torch.zeros(4, 8), torch.zeros(4, dtype=torch.int32)),
     "labels must be int64"),
    ((torch.zeros(4, 8), torch.zeros(5).long()), "expected logits"),
    ((torch.zeros(2, 4, 8), torch.zeros(2, 4).long()), "expected logits"),
    ((torch.zeros(8, 4).t(), torch.zeros(4).long()), "must be contiguous"),
    ((torch.zeros(0, 8), torch.zeros(0).long()), "empty"),
    ((torch.zeros(4, 8), torch.zeros(4, device="meta").long()),
     "share one device"),
], ids=["dtype", "label_dtype", "label_shape", "rank", "strided", "empty",
        "device"])
def test_ce_wrapper_refuses(args, match):
    """What the kernels do not take raises before any launch (the checks
    run on any device; a CUDA tensor is never sent to the plain twin)."""
    with pytest.raises((TypeError, ValueError), match=match):
        fc._check("ce_fwd", *args)
