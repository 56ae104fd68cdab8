"""The port's ring attention (paddle_tpu_torch/ops/ring_attention.py)
against the JAX package's, on the CPU — the twins of the reference's
``TestRingAttention`` (tests/test_gpt_hybrid.py:225-429) and its GQA
ring test (:621-651).

The port's ring runs on 8 gloo CPU ranks (``distributed.spawn``, the
JAX-free ``tools/hybrid_check.py`` kind "ring"): a ring of R over mesh
{"sp": R, "mp": 8 / R}, each mp slice running its own ring.  JAX runs
``ring_attention`` / ``ring_attention_zigzag`` under ``shard_map`` on its
8-virtual-device mesh, from the same numpy q, k, v.  Gradients are of
sum(out · w) for a numpy cotangent w on both sides.  Tolerances, fp32:
outputs within rtol 2e-5 / atol 2e-5, gradients within rtol 2e-4 /
atol 2e-5 (the reference's own against dense attention).  The plain
route is JAX's math; the kernel route runs on the CPU through the
flash wrappers' plain twins, so its ring walk (live blocks only, the
lse merge, the dk/dv hop back) is held here too, with its launch
counts.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from paddle_tpu.compat import shard_map
from paddle_tpu.ops import ring_attention as jra
from paddle_tpu.ops.attention import xla_attention
from paddle_tpu_torch.ops import ring_attention as ra

from test_torch_hybrid import mesh_of, ranks_in_background

OUT_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)


def _draw(seed, B, T, H, D, Hkv=None):
    g = np.random.default_rng(seed)
    Hkv = Hkv or H
    q = g.standard_normal((B, T, H, D)).astype(np.float32)
    k = g.standard_normal((B, T, Hkv, D)).astype(np.float32)
    v = g.standard_normal((B, T, Hkv, D)).astype(np.float32)
    w = g.standard_normal((B, T, H, D)).astype(np.float32)
    return q, k, v, w


# name: (R, (seed, B, T, H, D, Hkv), zigzag, sub_block, causal, routes)
CASES = {
    "causal_r8": (8, (0, 2, 64, 2, 16, None), False, None, True,
                  ("plain", "kernel")),
    "grads_r4": (4, (1, 1, 32, 2, 8, None), False, None, True,
                 ("plain", "kernel")),
    "zigzag_r8": (8, (0, 2, 64, 2, 16, None), True, None, True,
                  ("plain", "kernel")),
    "zigzag_r4": (4, (1, 2, 32, 2, 16, None), True, None, True,
                  ("plain", "kernel")),
    "sub4_r4": (4, (2, 1, 64, 2, 8, None), False, 4, True, ("plain",)),
    "zigzag_sub4_r4": (4, (2, 1, 64, 2, 8, None), True, 4, True,
                       ("plain",)),
    "gqa_sub4_r4": (4, (9, 1, 32, 6, 8, 2), False, 4, True,
                    ("plain", "kernel")),
    "gqa_zigzag_r4": (4, (9, 1, 32, 6, 8, 2), True, None, True,
                      ("plain", "kernel")),
    "full_r4": (4, (3, 1, 32, 2, 8, None), False, None, False,
                ("plain", "kernel")),
}
# the score-temp witness: T = 512 over 2 ranks, whole blocks vs sub 32
TEMP = {"whole": None, "sub32": 32}


def _port_cases():
    cases = []
    for name, (R, draw, zig, sub, causal, routes) in CASES.items():
        q, k, v, w = _draw(*draw[:5], Hkv=draw[5])
        cases.append({"kind": "ring", "mesh": {"sp": R, "mp": 8 // R},
                      "q": q, "k": k, "v": v, "w": w, "zigzag": zig,
                      "sub_block": sub, "causal": causal, "routes": routes,
                      "device": "cpu"})
    q, k, v, w = _draw(3, 1, 512, 1, 8)
    for sub in TEMP.values():
        cases.append({"kind": "ring", "mesh": {"sp": 2, "mp": 4},
                      "q": q, "k": k, "v": v, "w": w, "sub_block": sub,
                      "routes": ("plain",), "largest": True,
                      "device": "cpu"})
    return cases


def _jax_ring(q, k, v, w, R, zigzag, sub, causal):
    """JAX's ring under shard_map: (out, (dq, dk, dv) of sum(out · w))."""
    mesh = mesh_of((R,), ("sp",))
    if zigzag:
        T = q.shape[1]
        perm, inv = jra.zigzag_permutation(T, R), jra.zigzag_inverse(T, R)
        body = lambda a, b, c: jra.ring_attention_zigzag(  # noqa: E731
            a, b, c, "sp", sub_block=sub)
    else:
        body = lambda a, b, c: jra.ring_attention(  # noqa: E731
            a, b, c, "sp", causal=causal, sub_block=sub)
    f = shard_map(body, mesh=mesh, in_specs=(P(None, "sp"),) * 3,
                  out_specs=P(None, "sp"), check_vma=False)

    def run(q, k, v):
        if zigzag:
            return f(q[:, perm], k[:, perm], v[:, perm])[:, inv]
        return f(q, k, v)

    out = jax.jit(run)(q, k, v)
    grads = jax.jit(jax.grad(lambda a, b, c: jnp.sum(run(a, b, c) * w),
                             argnums=(0, 1, 2)))(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.fixture(scope="module")
def rings():
    port = ranks_in_background(_port_cases(), 8)
    want = {}
    for name, (R, draw, zig, sub, causal, _) in CASES.items():
        q, k, v, w = _draw(*draw[:5], Hkv=draw[5])
        want[name] = _jax_ring(q, k, v, w, R, zig, sub, causal)
    got = port.result()
    return want, dict(zip(list(CASES) + list(TEMP), got))


def _check(got, want, what):
    out, grads = want
    np.testing.assert_allclose(got["out"], out, err_msg=what, **OUT_TOL)
    for name, g in zip(("dq", "dk", "dv"), grads):
        np.testing.assert_allclose(got[name], g, err_msg=f"{what} {name}",
                                   **GRAD_TOL)


@pytest.mark.parametrize("name", ["causal_r8", "grads_r4"])
def test_matches_jax_causal(rings, name):
    """ring_attention, causal, contiguous layout: output and gradients
    equal JAX's ring (and so dense causal attention)."""
    want, got = rings
    for route, res in got[name].items():
        _check(res, want[name], f"{name} {route}")


def test_matches_dense_causal(rings):
    """The port's ring against dense causal attention directly (the
    reference test's own comparison)."""
    want, got = rings
    q, k, v, _ = _draw(0, 2, 64, 2, 16)
    dense = np.asarray(xla_attention(q, k, v, is_causal=True))
    np.testing.assert_allclose(got["causal_r8"]["plain"]["out"], dense,
                               **OUT_TOL)


@pytest.mark.parametrize("name", ["zigzag_r8", "zigzag_r4"])
def test_zigzag_matches_jax(rings, name):
    want, got = rings
    for route, res in got[name].items():
        _check(res, want[name], f"{name} {route}")


@pytest.mark.parametrize("name", ["sub4_r4", "zigzag_sub4_r4"])
def test_sub_block_matches_jax_and_whole_block(rings, name):
    """The sub-block walk (4-row sub-chunks, each checkpointed) equals
    JAX's sub-blocked ring in values and gradients."""
    want, got = rings
    _check(got[name]["plain"], want[name], name)


def test_sub_block_caps_score_temp(rings):
    """The port's witness for the reference's compile-memory test: at
    T = 512 over 2 ranks the largest tensor any op makes in the forward
    and backward is the [B, H, 256, 256] score block with whole chunks,
    and at most a [B, H, 256, 32] one with sub_block = 32."""
    _, got = rings
    whole = got["whole"]["plain"]["largest"]
    subbed = got["sub32"]["plain"]["largest"]
    assert whole >= 256 * 256, whole
    assert subbed < whole * 0.7 and subbed <= 256 * 32 * 8, (whole, subbed)


@pytest.mark.parametrize("name", ["gqa_sub4_r4", "gqa_zigzag_r4"])
def test_grouped_ring_matches_jax(rings, name):
    """Unrepeated Hkv = 2 kv heads for H = 6 query heads ride the ring:
    values and gradients (dk / dv summed over each group) equal JAX's."""
    want, got = rings
    for route, res in got[name].items():
        _check(res, want[name], f"{name} {route}")


def test_full_ring_matches_jax(rings):
    want, got = rings
    for route, res in got["full_r4"].items():
        _check(res, want["full_r4"], f"full_r4 {route}")


def test_kernel_route_launch_counts():
    """The kernel route launches #1, #2 and #3 once a live block (on the
    CPU its blocks run the wrappers' plain twins, which count nothing;
    the card counts them, tests/test_torch_kernels_cuda.py): contiguous
    causal my + 1 at rank my, zigzag 2R + 1, non-causal R."""
    for R in (2, 4, 8):
        assert [ra.launches("causal", R, my) for my in range(R)] == \
            list(range(1, R + 1))
        assert {ra.launches("zigzag", R, my) for my in range(R)} == \
            {2 * R + 1}
        assert {ra.launches("full", R, my) for my in range(R)} == {R}
    # zigzag: 3 blocks at step 0, then 2 a step, one of them the high q
    # rows against the low kv chunk
    for my in range(4):
        steps = [ra.plan("zigzag", 4, my, r) for r in range(4)]
        assert [len(s) for s in steps] == [3, 2, 2, 2]
        assert all(("hi", "lo", False) in s for s in steps)


def test_zigzag_permutation_roundtrip():
    T, R = 48, 4
    perm, inv = ra.zigzag_permutation(T, R), ra.zigzag_inverse(T, R)
    np.testing.assert_array_equal(perm, jra.zigzag_permutation(T, R))
    np.testing.assert_array_equal(inv, jra.zigzag_inverse(T, R))
    x = np.arange(T)
    np.testing.assert_array_equal(x[perm][inv], x)
    Tc = T // (2 * R)
    np.testing.assert_array_equal(perm[:Tc], np.arange(Tc))
    np.testing.assert_array_equal(
        perm[Tc:2 * Tc], np.arange((2 * R - 1) * Tc, 2 * R * Tc))
    with pytest.raises(ValueError):
        ra.zigzag_permutation(50, 4)


def test_sub_block_validated():
    """Divisibility and positivity are refused loudly, as in JAX."""
    import torch

    q = torch.zeros(1, 8, 2, 4)
    with pytest.raises(ValueError):
        ra._chunk_attend(q, q, q, 0.5, sub=3)
    with pytest.raises(ValueError):
        ra._chunk_attend(q, q, q, 0.5, sub=0)
