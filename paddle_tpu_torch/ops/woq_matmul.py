"""W4A16 dequant-matmul: the hand-written Hopper kernel and its plain
PyTorch twin.

Counterpart of ``paddle_tpu/ops/woq_matmul.py``.  The Pallas kernel
``_w4_call`` becomes ``csrc/woq_matmul.cu`` (the note at its top says what
bounds it and how it is laid out): it streams the nibble-packed int4
weight (text/woq.py's ``quantize_gpt_int4`` layout) once, dequantizes in
registers in the activation dtype — bit for bit ``woq.w``'s weight — and
never writes a dequantized copy.  Forward only: packed int4 weights exist
only on the frozen decode path.

Routing, as in the JAX package: x with at most ``_N_CAP`` rows goes to the
kernel; prefill-sized N goes to :func:`_plain_w4` (the JAX package sends
it to XLA by design).  The TPU's tiling gates (M % 128, group-aligned K
blocks) do not apply: the kernel takes every shape ``quantize_gpt_int4``
produces.  A CPU tensor goes to the plain twin; a CUDA tensor at N <=
``_N_CAP`` launches the kernel or raises — there is no fallback.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_N_CAP = 256        # decode / serving batches; prefill-sized N goes plain
_BN, _BM = 8, 128   # csrc/woq_matmul.cu: rows of x and columns per CTA
_MIN_SPLIT_ROWS = 64    # packed rows per K split, at least


def unpack_int4(packed):
    """Packed int8 [..., K/2, M] -> signed int8 values [..., K, M]: the low
    nibbles (``(b << 4) >> 4``) are rows [0, K/2), the high (``b >> 4``)
    rows [K/2, K)."""
    return torch.cat([(packed << 4) >> 4, packed >> 4], dim=-2)


def _plain_w4(x, packed, scale):
    """The kernel's math, as the JAX package's ``_xla_w4``: unpack, dequant
    in x.dtype with the group scales, then one matmul.  x [N, K], packed
    [K/2, M] int8, scale [G, 1, M] float32 -> [N, M] in x.dtype."""
    dt = x.dtype
    q = unpack_int4(packed)
    K, G = q.shape[0], scale.shape[0]
    w = (q.reshape(G, K // G, -1).to(dt) * scale.to(dt)).reshape(K, -1)
    return x @ w


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def splits_for(N: int, K: int, M: int, sm_count: int) -> int:
    """K splits for one launch: enough CTAs for about two per SM when the
    output tiles alone are fewer (a CTA walking all of K is bound by its
    own instruction rate), while every split keeps at least
    ``_MIN_SPLIT_ROWS`` packed rows and the fp32 partials (splits · N · M
    · 4 bytes, written and read once) stay within half the weight's
    K/2 · M bytes."""
    tiles = -(-M // _BM) * -(-N // _BN)
    want = -(-2 * sm_count // tiles)
    return max(1, min(want, (K // 2) // _MIN_SPLIT_ROWS, K // (16 * N)))


def _check(x, packed, scale):
    if x.dtype not in _DTYPES:
        raise TypeError(f"w4_matmul: x must be float32 or bfloat16, got "
                        f"{x.dtype}")
    if packed.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"w4_matmul: packed must be int8 and scale float32, "
                        f"got {packed.dtype}, {scale.dtype}")
    for name, t in (("packed", packed), ("scale", scale)):
        if t.device != x.device:
            raise ValueError(f"w4_matmul: x and {name} must share one device")
        if not t.is_contiguous():
            raise ValueError(f"w4_matmul: {name} must be contiguous")


def w4_matmul(x, packed, scale):
    """x [..., K] @ dequant(packed [K/2, M] int8, scale [G, 1, M] float32)
    -> [..., M] in x.dtype, fp32 accumulation.  Raises ``ValueError`` on a
    shape mismatch.

    CPU tensors, and x with more than ``_N_CAP`` rows, run
    :func:`_plain_w4`.  Otherwise CUDA tensors launch the kernel of
    ``csrc/woq_matmul.cu`` (x float32 or bfloat16); every launch adds one
    to ``w4_matmul.launches``."""
    lead = x.shape[:-1]
    K = x.shape[-1]
    Kp, M = packed.shape
    G = scale.shape[0]
    if K != 2 * Kp or K % G or tuple(scale.shape) != (G, 1, M):
        raise ValueError(f"shape mismatch: x[..., {K}], packed[{Kp}, {M}], "
                         f"scale{tuple(scale.shape)}")
    N = 1
    for d in lead:
        N *= d
    x2 = x.reshape(N, K)
    if not x.is_cuda or N > _N_CAP:
        return _plain_w4(x2, packed, scale).reshape(*lead, M)
    if N == 0:
        raise ValueError("w4_matmul: x has no rows")
    x2 = x2.contiguous()
    _check(x2, packed, scale)
    out = torch.empty((N, M), dtype=x.dtype, device=x.device)
    splits = splits_for(N, K, M, _sm_count(x.device))
    part = torch.empty((splits, N, M) if splits > 1 else (1,),
                       dtype=torch.float32, device=x.device)
    fn = _build.load("woq_matmul").w4_matmul
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
    with torch.cuda.device(x.device):
        code = fn(x2.data_ptr(), packed.data_ptr(), scale.data_ptr(),
                  out.data_ptr(), part.data_ptr(), N, K, M, K // G, splits,
                  _DTYPES[x.dtype],
                  torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(code, "w4_matmul")
    w4_matmul.launches += 1
    return out.reshape(*lead, M)


w4_matmul.launches = 0
