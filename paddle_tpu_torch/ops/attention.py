"""Attention entry used by the model code: the plain path and the
flash-kernel path.

Counterpart of ``paddle_tpu/ops/attention.py``.  CUDA tensors go to the
hand-written flash kernel (``ops/flash_attention.py``) at any sequence
length — the TPU's ``T % 128`` gate is a tiling artifact of its kernel
and does not apply; CPU tensors take :func:`xla_attention`, the JAX
package's plain expression.
"""
from __future__ import annotations

import torch

from . import flash_attention as fa


def xla_attention(q, k, v, is_causal=False, scale=None):
    """Plain attention on [B, T, H, D] (the reference's XLA path): scores
    in the input dtype, a -1e30 causal fill, softmax in fp32, p cast back
    to q.dtype before the p.v product."""
    B, T, H, D = q.shape
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    s = torch.einsum("bthd,bshd->bhts", q, k) * scale
    if is_causal:
        keep = torch.ones(T, k.shape[1], dtype=torch.bool,
                          device=q.device).tril()
        s = torch.where(keep, s, torch.full_like(s, -1e30))
    p = torch.softmax(s.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhts,bshd->bthd", p, v)


def attention_array(q, k, v, is_causal=False, scale=None):
    """q [B, T, H, D], k/v [B, S, Hkv, D] with Hkv dividing H (GQA heads
    need not be repeated) -> [B, T, H, D].  CUDA: the flash kernel;
    CPU: :func:`xla_attention` on repeated heads."""
    if q.is_cuda:
        return fa.flash_attention_fwd(q, k, v, causal=is_causal,
                                      scale=scale)[0]
    rep = q.shape[2] // k.shape[2]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    return xla_attention(q, k, v, is_causal=is_causal, scale=scale)
