"""Flash-attention forward: the hand-written Hopper kernel and its plain
PyTorch twin.

Counterpart of ``paddle_tpu/ops/flash_attention.py``.  The Pallas forward
(``_flash_fwd_impl``) becomes ``csrc/flash_fwd.cu`` — see the note at the
top of that file for what bounds it and how it is laid out.  Forward
only: the custom-vjp backward comes with the training slice.

:func:`flash_attention_fwd` takes the JAX package's [B, T, H, D] layout.
k and v may carry fewer heads (Hkv dividing H; head h reads kv head
h // (H / Hkv)), so GQA callers need not repeat them.  A CPU tensor goes
to :func:`_plain_fwd`; a CUDA tensor launches the kernel or raises on
what the kernel does not take — there is no fallback.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_NEG = -1e30  # large-negative instead of -inf: keeps lse finite on empty rows
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)


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


def _check(q, k, v):
    if not (k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention_fwd: q, k, v must share one "
                         "device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention_fwd: q, k, v must all be float32 "
                        f"or bfloat16, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention_fwd: expected q [B,T,H,D] and "
                         f"k = v [B,S,Hkv,D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, T, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or H % k.shape[2]:
        raise ValueError(f"flash_attention_fwd: k/v {tuple(k.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"flash_attention_fwd: head_dim {D} not in "
                         f"{_HEAD_DIMS}")
    if T == 0 or k.shape[1] == 0:
        raise ValueError("flash_attention_fwd: empty sequence")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention_fwd: {name} must be "
                             f"contiguous and 16-byte aligned")


def flash_attention_fwd(q, k, v, causal: bool = False, scale=None):
    """q [B, T, H, D], k/v [B, S, Hkv, D] -> (out [B, T, H, D] in q.dtype,
    lse [B*H, T] float32).  Causal means query row i sees keys j <= i.

    CPU tensors run :func:`_plain_fwd`.  CUDA tensors launch
    ``csrc/flash_fwd.cu`` (float32 or bfloat16, D in {64, 128}, any T);
    every launch adds one to ``flash_attention_fwd.launches``."""
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
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0
