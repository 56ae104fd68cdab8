"""The port's flash-attention forward (paddle_tpu_torch/ops/
flash_attention.py) held against the JAX package's Pallas forward
(``_flash_fwd_impl``, interpret mode on the CPU) and its plain XLA
attention; the port's ``xla_attention`` against the JAX one.

Tolerances: fp32; the Pallas kernel walks 128-key blocks with an online
softmax where the plain twin takes one softmax per row — atol 1e-5 on out
and on lse.  The kernel itself runs only on a card:
tests/test_torch_kernels_cuda.py holds it against this plain twin.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops import attention as jattn
from paddle_tpu.ops import flash_attention as jfa
from paddle_tpu_torch.ops import attention, flash_attention as fa


@pytest.fixture()
def interpret():
    old = jfa._INTERPRET
    jfa._INTERPRET = True
    yield
    jfa._INTERPRET = old


def _qkv(B=2, T=128, H=2, D=64, Hkv=None, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    k = rng.standard_normal((B, T, Hkv or H, D)).astype(np.float32)
    v = rng.standard_normal((B, T, Hkv or H, D)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("causal", [True, False])
def test_plain_fwd_matches_pallas_interpret(interpret, causal):
    q, k, v = _qkv()
    ref_out, ref_lse = jfa._flash_fwd_impl(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v), causal, None)
    out, lse = fa.flash_attention_fwd(torch.from_numpy(q),
                                      torch.from_numpy(k),
                                      torch.from_numpy(v), causal=causal)
    assert lse.shape == (2 * 2, 128) and lse.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse)[..., 0],
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_fwd_matches_xla_attention(causal):
    q, k, v = _qkv(T=100, seed=1)     # any T: no 128-row tiling here
    ref = jattn.xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              is_causal=causal)
    out, _ = fa._plain_fwd(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_xla_attention_matches_jax(causal, dtype):
    """The CPU path of attention_array: same expression, same casts (p to
    q.dtype before p.v).  bf16 rounds at the same places, so 1 bf16 ulp
    of the output magnitude (~2e-2) is the bound there."""
    q, k, v = _qkv(T=40, seed=2)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    ref = jattn.xla_attention(jnp.asarray(q, jd), jnp.asarray(k, jd),
                              jnp.asarray(v, jd), is_causal=causal)
    out = attention.xla_attention(torch.from_numpy(q).to(td),
                                  torch.from_numpy(k).to(td),
                                  torch.from_numpy(v).to(td),
                                  is_causal=causal)
    tol = 1e-6 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), atol=tol, rtol=0)


def test_attention_array_gqa_repeats_heads_on_cpu():
    """k/v with Hkv < H heads: head h reads kv head h // (H / Hkv), the
    jnp.repeat layout the JAX prefill builds by hand."""
    q, k, v = _qkv(H=4, Hkv=2, T=24, seed=3)
    ref = jattn.xla_attention(jnp.asarray(q), jnp.repeat(jnp.asarray(k), 2, 2),
                              jnp.repeat(jnp.asarray(v), 2, 2), is_causal=True)
    out = attention.attention_array(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), is_causal=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6,
                               rtol=0)
    plain, _ = fa._plain_fwd(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), True)
    np.testing.assert_allclose(plain.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)


def _good():
    return dict(q=torch.zeros(1, 8, 2, 64), k=torch.zeros(1, 8, 2, 64),
                v=torch.zeros(1, 8, 2, 64))


@pytest.mark.parametrize("bad,match", [
    (dict(q=torch.zeros(1, 8, 2, 32), k=torch.zeros(1, 8, 2, 32),
          v=torch.zeros(1, 8, 2, 32)), "head_dim 32"),
    (dict(q=torch.zeros(1, 8, 2, 64, dtype=torch.float16)),
     "got torch.float16/"),
    (dict(k=torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16)),
     "got torch.float32/torch.bfloat16/"),
    (dict(k=torch.zeros(1, 2, 8, 64).transpose(1, 2)), "k must be contig"),
    (dict(k=torch.zeros(1, 8, 3, 64), v=torch.zeros(1, 8, 3, 64)),
     "do not match"),
    (dict(v=torch.zeros(1, 8, 2, 64, device="meta")), "share one device"),
], ids=["head_dim", "dtype", "mixed_dtype", "strided_k", "gqa_ratio",
        "device"])
def test_kernel_wrapper_refuses(bad, match):
    """What the kernel does not take raises before any launch, each case
    on its own check (the checks run on any device; a CUDA tensor is never
    sent to the plain path)."""
    args = {**_good(), **bad}
    with pytest.raises((TypeError, ValueError), match=match):
        fa._check(args["q"], args["k"], args["v"])


def test_kernel_wrapper_accepts_good_inputs():
    g = _good()
    fa._check(g["q"], g["k"], g["v"])
    gqa = dict(k=torch.zeros(1, 5, 1, 128, dtype=torch.bfloat16))
    fa._check(torch.zeros(1, 8, 2, 128, dtype=torch.bfloat16), gqa["k"],
              gqa["k"].clone())
