"""The port's flash-attention backward (paddle_tpu_torch/ops/
flash_attention.py: ``_plain_bwd``, the ``_Flash`` autograd Function,
``attention_array`` under autograd) held against the JAX package's Pallas
backward (``_flash_bwd_impl``, interpret mode on the CPU), its custom-vjp
``_flash`` and ``jax.grad`` of its XLA attention.

Tolerances: fp32 throughout.  The Pallas kernels walk 128-row blocks and
sum in another order than the plain twin's einsums: atol 1e-5 on dq, dk
and dv (inputs of unit scale, T = 256).  The CUDA kernels run only on a
card: tests/test_torch_kernels_cuda.py holds them against this plain twin.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops import attention as jattn
from paddle_tpu.ops import flash_attention as jfa
from paddle_tpu_torch.ops import attention, decode_attention as da
from paddle_tpu_torch.ops import flash_attention as fa

TOL = 1e-5


@pytest.fixture()
def interpret():
    old = jfa._INTERPRET
    jfa._INTERPRET = True
    yield
    jfa._INTERPRET = old


def _arrays(B=1, T=256, H=2, D=64, Hkv=None, seed=0, n=4):
    """q, then k and v with Hkv heads, then n - 3 more q-shaped arrays."""
    rng = np.random.default_rng(seed)
    shapes = [(B, T, H, D), (B, T, Hkv or H, D), (B, T, Hkv or H, D)]
    shapes += [(B, T, H, D)] * (n - 3)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


def _close(got, ref):
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r),
                                   atol=TOL, rtol=0)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_bwd_matches_pallas_interpret(interpret, causal):
    """T = 256: two 128-row q blocks and two k blocks, so the Pallas dq
    kernel sums across k blocks and the dk/dv kernel across q blocks (and
    skips the causally dead block)."""
    q, k, v, do = _arrays()
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    out, lse = jfa._flash_fwd_impl(jq, jk, jv, causal, None)
    ref = jfa._flash_bwd_impl(jq, jk, jv, out, lse, jdo, causal, None)
    got = fa.flash_attention_bwd(
        *_t(q, k, v), torch.from_numpy(np.array(out)),
        torch.from_numpy(np.array(lse)[..., 0]), torch.from_numpy(do),
        causal=causal)
    _close(got, ref)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_grads_match_jax_custom_vjp(interpret, causal):
    """The autograd Function's gradients against jax.vjp of the custom-vjp
    ``_flash`` (Pallas forward and backward, interpret mode)."""
    q, k, v, do = _arrays(B=2, T=256, H=2, D=64, seed=1)
    out, vjp = jax.vjp(lambda a, b, c: jfa._flash(a, b, c, causal, None),
                       *map(jnp.asarray, (q, k, v)))
    ref = vjp(jnp.asarray(do))
    tq, tk, tv = (x.requires_grad_() for x in _t(q, k, v))
    o = fa.flash_attention(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(out),
                               atol=TOL, rtol=0)
    o.backward(torch.from_numpy(do))
    _close([tq.grad, tk.grad, tv.grad], ref)


@pytest.mark.parametrize("route", ["flash_attention", "attention_array"])
def test_gqa_grads_match_jax_repeated_heads(route):
    """k/v with Hkv < H heads (G = 4): the JAX package trains on heads
    repeated with jnp.repeat, whose transpose sums each group's dk/dv; the
    port never repeats them for the kernels — the plain backward (and on
    the card the dk/dv kernel) sums the group itself.  Against jax.grad of
    xla_attention over the repeated heads, at a ragged T."""
    q, k, v, do = _arrays(B=2, T=40, H=8, D=64, Hkv=2, seed=2)

    def ref_fn(a, b, c):
        out = jattn.xla_attention(a, jnp.repeat(b, 4, 2), jnp.repeat(c, 4, 2),
                                  is_causal=True)
        return jnp.sum(out * jnp.asarray(do))

    ref = jax.grad(ref_fn, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (x.requires_grad_() for x in _t(q, k, v))
    fn = fa.flash_attention if route == "flash_attention" \
        else attention.attention_array
    out = fn(tq, tk, tv, True)
    out.backward(torch.from_numpy(do))
    assert tk.grad.shape == (2, 40, 2, 64)
    _close([tq.grad, tk.grad, tv.grad], ref)


@pytest.mark.parametrize("T,causal", [(37, True), (37, False), (100, True)])
def test_plain_bwd_matches_autograd_of_plain_fwd(T, causal):
    """At ragged T (no tiling here), with GQA: the hand-derived backward
    (the kernels' math, delta = rowsum(do * out)) equals PyTorch's
    autograd through the plain forward."""
    q, k, v, do = _arrays(B=2, T=T, H=4, D=64, Hkv=2, seed=3)
    tq, tk, tv = (x.requires_grad_() for x in _t(q, k, v))
    out, lse = fa._plain_fwd(tq, tk, tv, causal)
    out.backward(torch.from_numpy(do))
    got = fa._plain_bwd(*_t(q, k, v), out.detach(), lse.detach(),
                        torch.from_numpy(do), causal)
    for g, r in zip(got, (tq.grad, tk.grad, tv.grad)):
        torch.testing.assert_close(g, r, atol=TOL, rtol=0)


def test_plain_bwd_bf16_returns_input_dtypes():
    q, k, v, do = (torch.from_numpy(a).bfloat16()
                   for a in _arrays(T=16, seed=4))
    out, lse = fa._plain_fwd(q, k, v, True)
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, out, lse, do, causal=True)
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
    ref = fa._plain_bwd(*(x.float() for x in (q, k, v, out)), lse,
                        do.float(), True)
    for g, r in zip((dq, dk, dv), ref):
        torch.testing.assert_close(g.float(), r, atol=1e-2, rtol=1e-2)


def _bwd_good():
    z = torch.zeros(1, 8, 2, 64)
    return dict(q=z, k=z.clone(), v=z.clone(), lse=torch.zeros(2, 8),
                do=z.clone(), out=z.clone())


@pytest.mark.parametrize("bad,match", [
    (dict(q=torch.zeros(1, 8, 2, 96), k=torch.zeros(1, 8, 2, 96),
          v=torch.zeros(1, 8, 2, 96), do=torch.zeros(1, 8, 2, 96),
          out=torch.zeros(1, 8, 2, 96)), "head_dim 96"),
    (dict(do=torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16)),
     "do must match q"),
    (dict(out=torch.zeros(1, 8, 2, 32)), "out must match q"),
    (dict(lse=torch.zeros(2, 8, dtype=torch.float64)),
     "lse must be float32"),
    (dict(lse=torch.zeros(2, 7)), r"lse must be float32 \[2, 8\]"),
    (dict(do=torch.zeros(1, 2, 8, 64).transpose(1, 2)),
     "do must be contig"),
    (dict(k=torch.zeros(1, 8, 2, 64, dtype=torch.float16),
          v=torch.zeros(1, 8, 2, 64, dtype=torch.float16)),
     "got torch.float32/torch.float16/"),
    ({}, "take CUDA tensors"),
], ids=["head_dim", "do_dtype", "out_shape", "lse_dtype", "lse_shape",
        "strided_do", "kv_dtype", "cpu"])
def test_bwd_wrapper_refuses(bad, match):
    """What the backward kernels do not take raises before any launch; the
    last case is a good CPU set, which the kernels never take (the public
    ``flash_attention_bwd`` sends it to the plain twin)."""
    a = {**_bwd_good(), **bad}
    before = (fa.flash_attention_bwd_dq.launches,
              fa.flash_attention_bwd_dkv.launches)
    with pytest.raises((TypeError, ValueError), match=match):
        fa.flash_attention_bwd_dq(a["q"], a["k"], a["v"], a["out"], a["lse"],
                                  a["do"])
    assert (fa.flash_attention_bwd_dq.launches,
            fa.flash_attention_bwd_dkv.launches) == before


@pytest.mark.parametrize("hd", [64, 128, 256])
def test_wrappers_take_head_dim_256(hd):
    """The JAX gates admit hd in {64, 128, 256} (flash ``_shape_supported``,
    the decode ``supported``); so do the port's wrappers — forward, backward
    and both decode kernels."""
    z = torch.zeros(1, 8, 2, hd)
    fa._check(z, z, z)
    da._check(torch.zeros(2, 1, 4, hd), torch.zeros(2, 16, 2, hd),
              torch.zeros(2, 16, 2, hd), torch.zeros(2, dtype=torch.int32),
              None, None)
    da._check(torch.zeros(2, 1, 4, hd), torch.zeros(6, 16, 2, hd),
              torch.zeros(6, 16, 2, hd), torch.zeros(2, dtype=torch.int32),
              None, None, tables=torch.zeros(2, 3, dtype=torch.int32))
    assert da.paged_supported((2, 1, 4, hd), (6, 16, 2, hd))
    with pytest.raises(ValueError, match="take CUDA tensors"):
        fa._check_bwd(z, z, z, torch.zeros(2, 8), z)   # passes the hd check


def test_split_plan_row_tile_at_head_dim_256():
    """At hd 256 a CTA holds 32 query rows (64 would not fit in shared
    memory), so the plan counts twice the row tiles there."""
    assert da.row_tile(64) == da.row_tile(128) == 64 and da.row_tile(256) == 32
    assert da.split_plan(1, 4, 512, 512, hd=256) \
        == da.split_plan(1, 4, 512, 1024, hd=128)
