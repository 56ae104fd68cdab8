"""Split-KV decode attention and the quantized-KV helpers: the
hand-written Hopper kernel and its plain PyTorch twin.

Counterpart of ``paddle_tpu/ops/decode_attention.py``.  The Pallas kernel
(``_decode_call``) becomes ``csrc/decode_attention.cu`` — a split-KV
partial kernel plus a combine kernel; the note at the top of that file
says what bounds it and how it is laid out.  ``quantize_kv`` /
``dequantize_kv`` are THE int8 cache format, as in the JAX package.

:func:`decode_attention` takes a CPU tensor to :func:`_plain_decode` and
launches the kernel for a CUDA tensor, raising on what the kernel does
not take — there is no fallback.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_NEG = -1e30
_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_HEAD_DIMS = (64, 128)
_R_CAP = 64     # query rows (Tq * G) one CTA holds
_BT = 64        # cache rows per kernel tile; a split is a multiple of it
_TARGET_CTAS = 264   # two CTAs per SM on a 132-SM card


def quantize_kv(x):
    """Symmetric per-(..., head) int8 over the trailing head_dim axis:
    returns (q int8 like x, scale float32 of x.shape[:-1])."""
    xf = x.float()
    s = torch.clamp_min(xf.abs().amax(dim=-1), 1e-8) / 127.0
    q = torch.clamp(torch.round(xf / s[..., None]), -127, 127)
    return q.to(torch.int8), s


def dequantize_kv(q, s, dt):
    """Inverse of quantize_kv, in fp32 then cast to ``dt``."""
    return (q.float() * s[..., None]).to(dt)


def _plain_decode(q, k, v, pos, k_scale, v_scale, scale):
    """Grouped-query cached attention in plain PyTorch (the counterpart of
    the JAX package's ``_xla_decode``): q [B, Tq, Hq, hd], cache
    [B, T, Hkv, hd] (+ scales for int8), mask t <= pos[b] + i for q row i,
    fp32 softmax, out in q.dtype."""
    B, Tq, Hq, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = scale if scale is not None else 1.0 / (hd ** 0.5)
    kf, vf = k.float(), v.float()
    if k_scale is not None:
        kf = kf * k_scale[..., None]
        vf = vf * v_scale[..., None]
    qg = q.reshape(B, Tq, Hkv, G, hd).float()
    s = torch.einsum("bikgd,btkd->bkgit", qg, kf) * scale
    t = torch.arange(T, device=q.device)
    i = torch.arange(Tq, device=q.device)
    pos = pos.to(q.device).reshape(B, 1, 1, 1, 1)
    mask = t[None, :] <= pos + i[:, None]            # [B, 1, 1, Tq, T]
    s = torch.where(mask, s, torch.full_like(s, _NEG))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgit,btkd->bikgd", w, vf)
    return out.reshape(B, Tq, Hq, hd).to(q.dtype)


def split_plan(B: int, Hkv: int, T: int):
    """(chunk, nsplit): cut the T walk into splits of ``chunk`` rows (a
    multiple of the kernel's 64-row tile) so that B * Hkv * nsplit CTAs
    fill the card about twice over; splits past a row's frontier exit at
    once, so the plan is sized on the cache length, not on pos."""
    tiles = -(-T // _BT)
    want = max(1, min(tiles, -(-_TARGET_CTAS // max(1, B * Hkv))))
    chunk = -(-tiles // want) * _BT
    return chunk, -(-T // chunk)


def _check(q, k, v, pos, k_scale, v_scale):
    dev = q.device
    if not all(t.device == dev for t in (k, v, pos)):
        raise ValueError("decode_attention: q, k, v, pos must share one "
                         "device")
    if q.dtype not in _Q_DTYPES:
        raise TypeError(f"decode_attention: q must be float32 or bfloat16, "
                        f"got {q.dtype}")
    if k.dtype not in _KV_DTYPES or v.dtype != k.dtype:
        raise TypeError(f"decode_attention: cache must be float32, bfloat16 "
                        f"or int8, got {k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"decode_attention: expected q [B,Tq,Hq,hd] and "
                         f"k = v [B,T,Hkv,hd], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Tq, Hq, hd = q.shape
    Hkv = k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or Hq % Hkv:
        raise ValueError(f"decode_attention: cache {tuple(k.shape)} does not "
                         f"match q {tuple(q.shape)}")
    if hd not in _HEAD_DIMS:
        raise ValueError(f"decode_attention: head_dim {hd} not in "
                         f"{_HEAD_DIMS}")
    if Tq * (Hq // Hkv) > _R_CAP:
        raise ValueError(f"decode_attention: Tq * G = {Tq * (Hq // Hkv)} "
                         f"query rows per kv head exceed {_R_CAP}")
    if pos.dtype != torch.int32 or pos.shape != (B,):
        raise ValueError(f"decode_attention: pos must be int32 [B], got "
                         f"{pos.dtype} {tuple(pos.shape)}")
    quant = k.dtype == torch.int8
    if quant != (k_scale is not None) or (k_scale is None) != (v_scale is None):
        raise ValueError("decode_attention: int8 caches need k_scale and "
                         "v_scale; float caches take none")
    tensors = [("q", q), ("k", k), ("v", v), ("pos", pos)]
    if quant:
        for name, s in (("k_scale", k_scale), ("v_scale", v_scale)):
            if s.dtype != torch.float32 or s.shape != k.shape[:3] \
                    or s.device != dev:
                raise ValueError(f"decode_attention: {name} must be float32 "
                                 f"{tuple(k.shape[:3])} on {dev}")
            tensors.append((name, s))
    for name, t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"decode_attention: {name} must be contiguous "
                             f"and 16-byte aligned")


def decode_attention(q, k, v, pos, k_scale=None, v_scale=None, scale=None):
    """q [B, Tq, Hq, hd] against a cache [B, T, Hkv, hd] -> [B, Tq, Hq, hd]
    (q.dtype).  ``pos`` [B] int32: q row i of batch b attends cache rows
    t <= pos[b] + i.  int8 caches pass per-row ``k_scale``/``v_scale``
    [B, T, Hkv] float32.

    CPU tensors run :func:`_plain_decode`.  CUDA tensors launch
    ``csrc/decode_attention.cu`` (q float32/bfloat16; cache float32,
    bfloat16 or int8; hd in {64, 128}; Tq * Hq / Hkv <= 64); every launch
    adds one to ``decode_attention.launches``."""
    if not q.is_cuda:
        return _plain_decode(q, k, v, pos, k_scale, v_scale, scale)
    _check(q, k, v, pos, k_scale, v_scale)
    B, Tq, Hq, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    R = Tq * (Hq // Hkv)
    scale = scale if scale is not None else 1.0 / (hd ** 0.5)
    chunk, nsplit = split_plan(B, Hkv, T)
    out = torch.empty_like(q)
    f32 = dict(dtype=torch.float32, device=q.device)
    o_part = torch.empty((B, Hkv, nsplit, R, hd), **f32)
    m_part = torch.empty((B, Hkv, nsplit, R), **f32)
    l_part = torch.empty((B, Hkv, nsplit, R), **f32)
    fn = _build.load("decode_attention").decode_attention
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 10
                       + [ctypes.c_float, ctypes.c_void_p])
    with torch.cuda.device(q.device):        # launch on q's card
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  k_scale.data_ptr() if k_scale is not None else None,
                  v_scale.data_ptr() if v_scale is not None else None,
                  pos.data_ptr(), out.data_ptr(), o_part.data_ptr(),
                  m_part.data_ptr(), l_part.data_ptr(),
                  B, Tq, Hq, Hkv, T, hd, _Q_DTYPES[q.dtype],
                  _KV_DTYPES[k.dtype], chunk, nsplit, float(scale),
                  torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(code, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
