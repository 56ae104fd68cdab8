"""Flash attention, forward and backward: the hand-written Hopper kernels
and their plain PyTorch twins.

Counterpart of ``paddle_tpu/ops/flash_attention.py``.  The Pallas forward
(``_flash_fwd_impl``) becomes ``csrc/flash_fwd.cu`` — bf16 on the
tensor-core body of ``csrc/attn_tc.cuh``, fp32 on an FMA body
(:func:`route`); the backward's two
Pallas kernels (``dq_kernel``, ``dkv_kernel`` of ``_flash_bwd_impl``)
become ``csrc/flash_bwd.cu`` — bf16 at head dim 64 and 128 on tensor-core
bodies over the same primitives, the rest on an FMA body
(:func:`route_bwd`) — see the notes at the top of those files for
what bounds them and how they are laid out.  The custom-vjp ``_flash``
becomes :class:`_Flash`, a ``torch.autograd.Function``
(:func:`flash_attention`).

Every function takes the JAX package's [B, T, H, D] layout.  k and v may
carry fewer heads (Hkv dividing H; head h reads kv head h // (H / Hkv)),
so GQA callers need not repeat them; dk/dv come back with Hkv heads, each
the sum over its group.  A CPU tensor goes to the plain twin; a CUDA
tensor launches the kernel or raises on what the kernel does not take —
there is no fallback.
"""
from __future__ import annotations

import ctypes

import torch

from .. import telemetry as _telemetry
from . import _build, _counts

_NEG = -1e30  # large-negative instead of -inf: keeps lse finite on empty rows
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128, 256)


def route(q_dtype, hd) -> str:
    """Which body of ``csrc/flash_fwd.cu`` a forward launch takes: "tc"
    (the wgmma body of ``csrc/attn_tc.cuh``) for bfloat16, "fma" (fp32
    products on the CUDA cores) for float32.  The C entry decides the same
    from the same dtype; every head dim the kernel takes runs on either."""
    if q_dtype not in _DTYPES or hd not in _HEAD_DIMS:
        raise ValueError(f"flash_attention_fwd: no route for {q_dtype}, "
                         f"head_dim {hd}")
    return "tc" if q_dtype == torch.bfloat16 else "fma"


def route_bwd(q_dtype, hd) -> str:
    """Which body of ``csrc/flash_bwd.cu`` a backward launch (dq or dk/dv)
    takes: "tc" (wgmma products over ``csrc/attn_tc.cuh``) for bfloat16 at
    head dim 64 or 128, "fma" (fp32 products on the CUDA cores) for float32
    and for bfloat16 at head dim 256, where the dk/dv accumulators alone
    would fill a warpgroup's registers.  The C entries decide the same."""
    if q_dtype not in _DTYPES or hd not in _HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd: no route for {q_dtype}, "
                         f"head_dim {hd}")
    return "tc" if q_dtype == torch.bfloat16 and hd in (64, 128) else "fma"


def _plain_fwd(q, k, v, causal: bool, scale=None):
    """The kernel's math in plain PyTorch: fp32 scores ``scale * q.k``,
    the causal mask filled with -1e30, softmax in fp32, out cast to
    q.dtype, lse = m + log(l) per row [B*H, T] (l == 0 divides by 1)."""
    B, T, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    if Hkv != H:
        k = k.repeat_interleave(H // Hkv, dim=2)
        v = v.repeat_interleave(H // Hkv, dim=2)
    s = scale * torch.einsum("bthd,bshd->bhts", q.float(), k.float())
    if causal:
        keep = torch.ones(T, S, dtype=torch.bool, device=q.device).tril()
        s = torch.where(keep, s, torch.full_like(s, _NEG))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    out = torch.einsum("bhts,bshd->bthd", p, v.float()) \
        / l_safe.permute(0, 2, 1, 3)
    lse = (m + torch.log(l_safe)).reshape(B * H, T)
    return out.to(q.dtype), lse


def _check(q, k, v, what="flash_attention_fwd"):
    if not (k.device == q.device and v.device == q.device):
        raise ValueError(f"{what}: q, k, v must share one device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{what}: q, k, v must all be float32 "
                        f"or bfloat16, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{what}: expected q [B,T,H,D] and "
                         f"k = v [B,S,Hkv,D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, T, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or H % k.shape[2]:
        raise ValueError(f"{what}: k/v {tuple(k.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"{what}: head_dim {D} not in "
                         f"{_HEAD_DIMS}")
    if T == 0 or k.shape[1] == 0:
        raise ValueError(f"{what}: empty sequence")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be "
                             f"contiguous and 16-byte aligned")


def _pairs(T: int, S: int, causal: bool) -> int:
    """(query row, key) pairs a head computes: all T·S, or causal — row i
    sees keys j <= i — the visible ones."""
    if not causal:
        return T * S
    m = min(T, S)
    return m * (m + 1) // 2 + (T - m) * S


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def flash_fwd_cost(q, k, v, causal: bool = False, scale=None):
    """(FLOPs, bytes) of a :func:`flash_attention_fwd` call for the device
    feed (``telemetry.counted``): q·Kᵀ and p·V over the visible pairs,
    4·B·H·D·pairs; q, k, v read, out and the fp32 lse written."""
    B, T, H, D = q.shape
    return (4 * B * H * D * _pairs(T, k.shape[1], causal),
            2 * _nbytes(q) + _nbytes(k, v) + B * H * T * 4)


def flash_bwd_dq_cost(q, k, v, out, lse, do, causal=False, scale=None,
                      f32_out=False):
    """(FLOPs, bytes) of :func:`flash_attention_bwd_dq`: S, dP and dQ,
    6·B·H·D·pairs; q, k, v, out, do, lse read, dq and delta written."""
    B, T, H, D = q.shape
    return (6 * B * H * D * _pairs(T, k.shape[1], causal),
            _nbytes(q, k, v, out, do, lse) + _nbytes(q, lse))


def flash_bwd_dkv_cost(q, k, v, lse, delta, do, causal=False, scale=None,
                       f32_out=False):
    """(FLOPs, bytes) of :func:`flash_attention_bwd_dkv`: S, dP, dV and
    dK, 8·B·H·D·pairs; q, k, v, do, lse, delta read, dk and dv written."""
    B, T, H, D = q.shape
    return (8 * B * H * D * _pairs(T, k.shape[1], causal),
            _nbytes(q, k, v, do, lse, delta) + _nbytes(k, v))


def flash_bwd_cost(q, k, v, out, lse, do, causal=False, scale=None):
    """(FLOPs, bytes) of :func:`flash_attention_bwd`: its two kernels'."""
    f1, b1 = flash_bwd_dq_cost(q, k, v, out, lse, do, causal)
    f2, b2 = flash_bwd_dkv_cost(q, k, v, lse, lse, do, causal)
    return f1 + f2, b1 + b2


@_telemetry.counted(flash_fwd_cost)
def flash_attention_fwd(q, k, v, causal: bool = False, scale=None):
    """q [B, T, H, D], k/v [B, S, Hkv, D] -> (out [B, T, H, D] in q.dtype,
    lse [B*H, T] float32).  Causal means query row i sees keys j <= i.

    CPU tensors run :func:`_plain_fwd`.  CUDA tensors launch
    ``csrc/flash_fwd.cu`` (float32 or bfloat16, D in {64, 128, 256}, any T);
    every launch adds one to ``flash_attention_fwd.launches``, and one on
    the tensor-core body (:func:`route`) to ``.tc_launches``."""
    if not q.is_cuda:
        return _plain_fwd(q, k, v, causal, scale)
    _check(q, k, v)
    B, T, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    out = torch.empty_like(q)
    lse = torch.empty((B * H, T), dtype=torch.float32, device=q.device)
    fn = _build.load("flash_fwd").flash_fwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_void_p])
    with torch.cuda.device(q.device):        # launch on q's card
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  lse.data_ptr(), B, T, S, H, Hkv, D, _DTYPES[q.dtype],
                  int(bool(causal)), float(scale),
                  torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(code, "flash_fwd")
    _counts.bump(flash_attention_fwd, launches=1,
                 tc_launches=route(q.dtype, D) == "tc")
    return out, lse


flash_attention_fwd.launches = 0
flash_attention_fwd.tc_launches = 0


def _plain_bwd(q, k, v, out, lse, do, causal: bool, scale=None,
               f32_out=False):
    """The backward kernels' math in plain PyTorch, all in fp32: p =
    exp(scale * q.k - lse) with the causal mask filled with -1e30, dp =
    do.v, delta = rowsum(do * out), ds = p * (dp - delta); dq = scale *
    ds.k, dk = scale * ds^T.q, dv = p^T.do.  GQA grads sum over each kv
    head's group.  Returns (dq, dk, dv) in q's, k's and v's dtypes, or in
    float32 with ``f32_out``."""
    B, T, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    qf, kf, vf, of, dof = (x.float() for x in (q, k, v, out, do))
    if G > 1:
        kf = kf.repeat_interleave(G, dim=2)
        vf = vf.repeat_interleave(G, dim=2)
    s = scale * torch.einsum("bthd,bshd->bhts", qf, kf)
    if causal:
        keep = torch.ones(T, S, dtype=torch.bool, device=q.device).tril()
        s = torch.where(keep, s, torch.full_like(s, _NEG))
    p = torch.exp(s - lse.reshape(B, H, T, 1))
    dp = torch.einsum("bthd,bshd->bhts", dof, vf)
    delta = (dof * of).sum(-1).permute(0, 2, 1)[..., None]     # [B,H,T,1]
    ds = p * (dp - delta)
    dq = scale * torch.einsum("bhts,bshd->bthd", ds, kf)
    dk = scale * torch.einsum("bhts,bthd->bshd", ds, qf)
    dv = torch.einsum("bhts,bthd->bshd", p, dof)
    if G > 1:
        dk = dk.reshape(B, S, Hkv, G, D).sum(3)
        dv = dv.reshape(B, S, Hkv, G, D).sum(3)
    if f32_out:
        return dq, dk, dv
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_bwd(q, k, v, lse, do, out=None, delta=None):
    """Refuse what the backward kernels do not take: _check's q/k/v rules;
    do (and out) like q; lse (and delta) float32 [B*H, T]."""
    _check(q, k, v, "flash_attention_bwd")
    B, T, H, _ = q.shape
    like_q = [("do", do)] + ([("out", out)] if out is not None else [])
    like_lse = [("lse", lse)] + ([("delta", delta)] if delta is not None
                                 else [])
    for name, t in like_q:
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"flash_attention_bwd: {name} must match q "
                             f"{tuple(q.shape)} {q.dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    for name, t in like_lse:
        if t.dtype != torch.float32 or t.shape != (B * H, T) \
                or t.device != q.device:
            raise ValueError(f"flash_attention_bwd: {name} must be float32 "
                             f"[{B * H}, {T}] on q's device, got {t.dtype} "
                             f"{tuple(t.shape)}")
    for name, t in like_q + like_lse:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention_bwd: {name} must be "
                             f"contiguous and 16-byte aligned")
    if not q.is_cuda:
        raise ValueError("flash_attention_bwd: the kernels take CUDA "
                         "tensors (flash_attention_bwd sends CPU tensors "
                         "to the plain twin)")


def _out(like, f32_out):
    """The gradient buffer: like ``like``, or float32 with ``f32_out``."""
    return torch.empty_like(like, dtype=torch.float32 if f32_out
                            else like.dtype)


def _bwd_fn(name):
    """A backward entry of csrc/flash_bwd.cu: 8 pointers, 8 ints (B, T, S,
    H, Hkv, D, dtype, causal), the scale and the stream."""
    fn = getattr(_build.load("flash_bwd"), name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_void_p])
    return fn


def _dims(q, k, causal):
    B, T, H, D = q.shape
    return [B, T, k.shape[1], H, k.shape[2], D, _DTYPES[q.dtype],
            int(bool(causal))]


@_telemetry.counted(flash_bwd_dq_cost)
def flash_attention_bwd_dq(q, k, v, out, lse, do, causal=False, scale=None,
                           f32_out=False):
    """Launch the dq kernel (``csrc/flash_bwd.cu``, Pallas ``dq_kernel``)
    on CUDA tensors -> (dq like q, delta [B*H, T] float32 =
    rowsum(do * out), which :func:`flash_attention_bwd_dkv` reads).
    ``f32_out``: dq in float32 from the same body (its ``_f32out`` entry;
    bf16 inputs) — for a caller that sums partial gradients.  Every
    launch adds one to ``flash_attention_bwd_dq.launches``, and one on the
    tensor-core body (:func:`route_bwd`) to ``.tc_launches``."""
    _check_bwd(q, k, v, lse, do, out=out)
    B, T, H, D = q.shape
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    f32_out = f32_out and q.dtype != torch.float32
    dq = _out(q, f32_out)
    delta = torch.empty((B * H, T), dtype=torch.float32, device=q.device)
    fn = _bwd_fn("flash_bwd_dq_f32out" if f32_out else "flash_bwd_dq")
    with torch.cuda.device(q.device):
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                  dq.data_ptr(), *_dims(q, k, causal), float(scale),
                  torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(code, "flash_bwd_dq")
    _counts.bump(flash_attention_bwd_dq, launches=1,
                 tc_launches=route_bwd(q.dtype, D) == "tc")
    return dq, delta


flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dq.tc_launches = 0


@_telemetry.counted(flash_bwd_dkv_cost)
def flash_attention_bwd_dkv(q, k, v, lse, delta, do, causal=False,
                            scale=None, f32_out=False):
    """Launch the dk/dv kernel (``csrc/flash_bwd.cu``, Pallas
    ``dkv_kernel``) on CUDA tensors -> (dk, dv) like k and v (float32
    with ``f32_out``, as :func:`flash_attention_bwd_dq`), each kv head's
    group summed.  Every launch adds one to
    ``flash_attention_bwd_dkv.launches``, and one on the tensor-core body
    (:func:`route_bwd`) to ``.tc_launches``."""
    _check_bwd(q, k, v, lse, do, delta=delta)
    scale = scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    f32_out = f32_out and q.dtype != torch.float32
    dk = _out(k, f32_out)
    dv = _out(v, f32_out)
    fn = _bwd_fn("flash_bwd_dkv_f32out" if f32_out else "flash_bwd_dkv")
    with torch.cuda.device(q.device):
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                  lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                  dv.data_ptr(), *_dims(q, k, causal), float(scale),
                  torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(code, "flash_bwd_dkv")
    _counts.bump(flash_attention_bwd_dkv, launches=1,
                 tc_launches=route_bwd(q.dtype, q.shape[-1]) == "tc")
    return dk, dv


flash_attention_bwd_dkv.launches = 0
flash_attention_bwd_dkv.tc_launches = 0


@_telemetry.counted(flash_bwd_cost)
def flash_attention_bwd(q, k, v, out, lse, do, causal=False, scale=None):
    """Gradients of :func:`flash_attention_fwd`: q/out/do [B, T, H, D],
    k/v [B, S, Hkv, D], lse [B*H, T] float32 (the forward's) -> (dq, dk,
    dv).  CPU tensors run :func:`_plain_bwd`.  CUDA tensors launch the dq
    kernel, then the dk/dv kernel (float32 or bfloat16, D in {64, 128,
    256}, any T)."""
    if not q.is_cuda:
        return _plain_bwd(q, k, v, out, lse, do, causal, scale)
    dq, delta = flash_attention_bwd_dq(q, k, v, out, lse, do, causal, scale)
    dk, dv = flash_attention_bwd_dkv(q, k, v, lse, delta, do, causal, scale)
    return dq, dk, dv


class _Flash(torch.autograd.Function):
    """Differentiable flash attention: the forward kernel, saving q, k, v,
    out and the [B*H, T] fp32 lse; the backward kernels on the cotangent
    (the JAX package's custom_vjp ``_flash``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = flash_attention_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do.contiguous(),
                                         ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = False, scale=None):
    """q [B, T, H, D], k/v [B, S, Hkv, D] -> out [B, T, H, D], with
    gradients through :class:`_Flash` (the kernels on CUDA tensors, the
    plain twins on CPU ones)."""
    return _Flash.apply(q, k, v, causal, scale)
