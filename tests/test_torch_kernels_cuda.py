"""The port's CUDA kernels against their plain PyTorch twins, on a card:
flash prefill, split-KV decode (up to 1024 query rows per kv head) and
block-table (paged) decode.

Every test here is marked ``cuda`` and decides in its body whether a
card is present — never at import, in ``skipif`` or in ``parametrize``,
so every pytest-xdist worker collects the same tests.  Without a card
they skip.  The file imports neither JAX nor the JAX package, so it runs
on the card machine as it stands:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerances: a bf16 output may sit one bf16 ulp (2^-7 relative) from the
plain twin's where fp32 summation order tips a rounding: atol = rtol =
1e-2; fp32 outputs differ only by summation order (1e-4); lse is fp32
(1e-3).
"""
import pytest
import torch

from paddle_tpu_torch.ops import decode_attention as da
from paddle_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("T,H,Hkv,D,dtype,causal", [
    (64, 16, 16, 128, "bfloat16", True),
    (1000, 16, 16, 128, "bfloat16", True),
    (200, 4, 2, 64, "float32", False),
    (37, 8, 8, 64, "float32", True),
])
def test_flash_fwd_matches_plain(T, H, Hkv, D, dtype, causal):
    gen = _card()
    dt = getattr(torch, dtype)
    q = torch.randn(2, T, H, D, generator=gen, device="cuda").to(dt)
    k = torch.randn(2, T, Hkv, D, generator=gen, device="cuda").to(dt)
    v = torch.randn(2, T, Hkv, D, generator=gen, device="cuda").to(dt)
    before = fa.flash_attention_fwd.launches
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    ref, ref_lse = fa._plain_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.launches == before + 1
    tol = 1e-2 if dt == torch.bfloat16 else 1e-4
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    assert (lse - ref_lse).abs().max().item() < 1e-3


@pytest.mark.parametrize("Hq,Hkv,Tq,kv,qdt", [
    (16, 16, 1, "bfloat16", "bfloat16"),
    (16, 4, 4, "int8", "bfloat16"),
    (8, 2, 3, "float32", "float32"),
    (16, 16, 1, "float32", "bfloat16"),
])
def test_decode_matches_plain(Hq, Hkv, Tq, kv, qdt):
    gen = _card()
    T = 520
    q = torch.randn(3, Tq, Hq, 128, generator=gen,
                    device="cuda").to(getattr(torch, qdt))
    k = torch.randn(3, T, Hkv, 128, generator=gen, device="cuda")
    v = torch.randn(3, T, Hkv, 128, generator=gen, device="cuda")
    ks = vs = None
    if kv == "int8":
        k, ks = da.quantize_kv(k)
        v, vs = da.quantize_kv(v)
    else:
        k, v = k.to(getattr(torch, kv)), v.to(getattr(torch, kv))
    pos = torch.tensor([0, 257, T - Tq], dtype=torch.int32, device="cuda")
    before = da.decode_attention.launches
    out = da.decode_attention(q, k, v, pos, ks, vs)
    ref = da._plain_decode(q, k, v, pos, ks, vs, None)
    torch.cuda.synchronize()
    assert da.decode_attention.launches == before + 1
    tol = 1e-2 if q.dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("B,Tq,Hq,Hkv,pos0,kv", [
    (1, 512, 16, 16, 0, "bfloat16"),      # R = 512, an admission chunk
    (2, 512, 16, 16, 0, "int8"),
    (2, 256, 16, 4, 200, "bfloat16"),     # R = 1024, the cap
    (1, 100, 8, 2, 37, "float32"),        # ragged last row tile
])
def test_decode_wide_query_rows_match_plain(B, Tq, Hq, Hkv, pos0, kv):
    """Tq * G up to 1024 query rows per kv head (prefill chunks), cut into
    64-row tiles across CTAs."""
    gen = _card()
    T = 512
    q = torch.randn(B, Tq, Hq, 128, generator=gen, device="cuda")
    q = q.bfloat16() if kv != "float32" else q
    k = torch.randn(B, T, Hkv, 128, generator=gen, device="cuda")
    v = torch.randn(B, T, Hkv, 128, generator=gen, device="cuda")
    ks = vs = None
    if kv == "int8":
        k, ks = da.quantize_kv(k)
        v, vs = da.quantize_kv(v)
    else:
        k, v = k.to(getattr(torch, kv)), v.to(getattr(torch, kv))
    pos = torch.tensor([pos0, T - Tq][:B], dtype=torch.int32, device="cuda")
    before = da.decode_attention.launches
    out = da.decode_attention(q, k, v, pos, ks, vs)
    ref = da._plain_decode(q, k, v, pos, ks, vs, None)
    torch.cuda.synchronize()
    assert da.decode_attention.launches == before + 1
    tol = 1e-2 if q.dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


def _paged_inputs(gen, B, Tq, Hq, Hkv, bs, nmax, kv, qdt, pos_list):
    """A shuffled pool: live slot b maps its blocks through its write
    frontier to random distinct physical blocks and leaves the rest -1;
    a slot whose position is None is free (table row all -1, pos 0)."""
    N = B * nmax + 3
    q = torch.randn(B, Tq, Hq, 128, generator=gen,
                    device="cuda").to(getattr(torch, qdt))
    k = torch.randn(N, bs, Hkv, 128, generator=gen, device="cuda")
    v = torch.randn(N, bs, Hkv, 128, generator=gen, device="cuda")
    ks = vs = None
    if kv == "int8":
        k, ks = da.quantize_kv(k)
        v, vs = da.quantize_kv(v)
    else:
        k, v = k.to(getattr(torch, kv)), v.to(getattr(torch, kv))
    perm = torch.randperm(N, generator=gen, device="cuda").int()
    tables = torch.full((B, nmax), -1, dtype=torch.int32, device="cuda")
    pos = torch.zeros(B, dtype=torch.int32, device="cuda")
    for b, p in enumerate(pos_list):
        if p is None:
            continue
        used = (p + Tq - 1) // bs + 1
        tables[b, :used] = perm[b * nmax:b * nmax + used]
        pos[b] = p
    return q, k, v, ks, vs, tables, pos


@pytest.mark.parametrize("Hq,Hkv,Tq,kv,qdt,bs", [
    (16, 16, 1, "bfloat16", "bfloat16", 16),   # the paged path's tick
    (16, 4, 4, "int8", "bfloat16", 8),
    (8, 2, 3, "float32", "float32", 24),
    (16, 16, 1, "int8", "bfloat16", 16),
])
def test_paged_matches_plain(Hq, Hkv, Tq, kv, qdt, bs):
    """Live slots equal the gather-then-attend twin; a free slot returns
    zeros (the kernel reads no unmapped block, the twin reads block 0)."""
    gen = _card()
    nmax = 512 // bs
    T = nmax * bs
    pos_list = [0, 1, bs - 1, bs, 200, None, T - Tq, 333]
    q, k, v, ks, vs, tables, pos = _paged_inputs(
        gen, 8, Tq, Hq, Hkv, bs, nmax, kv, qdt, pos_list)
    before = da.paged_decode_attention.launches
    out = da.paged_decode_attention(q, k, v, tables, pos, ks, vs)
    ref = da._plain_paged(q, k, v, tables, pos, ks, vs, None)
    torch.cuda.synchronize()
    assert da.paged_decode_attention.launches == before + 1
    live = [b for b, p in enumerate(pos_list) if p is not None]
    tol = 1e-2 if q.dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(out[live].float(), ref[live].float(),
                               atol=tol, rtol=tol)
    assert not out[pos_list.index(None)].any()


def test_paged_wide_query_rows_match_plain():
    """A paged prefill-sized query block: Tq * G = 1024 rows."""
    gen = _card()
    q, k, v, ks, vs, tables, pos = _paged_inputs(
        gen, 2, 256, 16, 4, 16, 32, "bfloat16", "bfloat16", [0, 200])
    out = da.paged_decode_attention(q, k, v, tables, pos)
    ref = da._plain_paged(q, k, v, tables, pos, None, None, None)
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-2,
                               rtol=1e-2)


def test_kernels_launch_on_a_second_card():
    """Tensors on cuda:1 while cuda:0 is current: both kernels launch on
    the tensors' card (the shared-memory limit is per device) and agree
    with their plain twins."""
    _card()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    torch.cuda.set_device(0)
    dev = torch.device("cuda:1")
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(1, 256, 16, 128, generator=gen, device=dev)
               .bfloat16() for _ in range(3))
    out, _ = fa.flash_attention_fwd(q, k, v, causal=True)
    torch.testing.assert_close(out.float(), fa._plain_fwd(q, k, v, True)[0]
                               .float(), atol=1e-2, rtol=1e-2)
    q = torch.randn(2, 4, 16, 128, generator=gen, device=dev).bfloat16()
    pos = torch.tensor([3, 200], dtype=torch.int32, device=dev)
    kq, ks = da.quantize_kv(k.float().reshape(2, 128, 16, 128))
    vq, vs = da.quantize_kv(v.float().reshape(2, 128, 16, 128))
    kq, ks, vq, vs = (t.repeat(1, 2, 1, 1) if t.dim() == 4 else
                      t.repeat(1, 2, 1) for t in (kq, ks, vq, vs))
    out = da.decode_attention(q, kq, vq, pos, ks, vs)
    ref = da._plain_decode(q, kq, vq, pos, ks, vs, None)
    assert out.device == dev
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-2,
                               rtol=1e-2)


def test_cuda_tensors_the_kernels_cannot_take_raise():
    """No fallback: a CUDA tensor outside a kernel's contract raises."""
    _card()
    before = fa.flash_attention_fwd.launches
    z = torch.zeros(1, 8, 2, 64, device="cuda")
    q = torch.zeros(1, 8, 2, 48, device="cuda")
    with pytest.raises(ValueError, match="head_dim 48"):
        fa.flash_attention_fwd(q, q, q, causal=True)
    h = z.half()
    with pytest.raises(TypeError, match="got torch.float16/"):
        fa.flash_attention_fwd(h, h, h, causal=True)
    with pytest.raises(TypeError, match="got torch.float32/torch.bfloat16/"):
        fa.flash_attention_fwd(z, z.bfloat16(), z, causal=True)
    strided = torch.zeros(1, 2, 8, 64, device="cuda").transpose(1, 2)
    with pytest.raises(ValueError, match="k must be contig"):
        fa.flash_attention_fwd(z, strided, z, causal=True)
    k3 = torch.zeros(1, 8, 3, 64, device="cuda")
    with pytest.raises(ValueError, match="do not match"):
        fa.flash_attention_fwd(z, k3, k3, causal=True)
    assert fa.flash_attention_fwd.launches == before
    q = torch.zeros(1, 1, 2, 64, device="cuda", dtype=torch.float16)
    k = torch.zeros(1, 16, 2, 64, device="cuda", dtype=torch.float16)
    pos = torch.zeros(1, dtype=torch.int32, device="cuda")
    with pytest.raises(TypeError, match="got torch.float16"):
        da.decode_attention(q, k, k, pos)
    before = da.paged_decode_attention.launches
    q = torch.zeros(2, 1, 4, 64, device="cuda")
    pool = torch.zeros(6, 12, 4, 64, device="cuda")       # bs 12
    tables = torch.zeros(2, 3, dtype=torch.int32, device="cuda")
    pos = torch.zeros(2, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="block size 12"):
        da.paged_decode_attention(q, pool, pool, tables, pos)
    pool = torch.zeros(6, 16, 4, 64, device="cuda")
    with pytest.raises(ValueError, match="tables must be int32"):
        da.paged_decode_attention(q, pool, pool, tables.long(), pos)
    with pytest.raises(ValueError, match="head_dim 256"):
        z = torch.zeros(2, 1, 4, 256, device="cuda")
        da.paged_decode_attention(z, torch.zeros(6, 16, 4, 256,
                                                 device="cuda"),
                                  torch.zeros(6, 16, 4, 256, device="cuda"),
                                  tables, pos)
    assert da.paged_decode_attention.launches == before
