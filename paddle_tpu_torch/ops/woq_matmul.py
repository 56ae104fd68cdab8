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
it to XLA by design).  Inside the kernel, :func:`route` picks the body:
bf16 x with gs % 16 == 0 (and K % 32 == 0) runs the tensor-core body
("tc"), everything else the fp32-FMA body ("fma"); the C entry decides
the same way and refuses a caller that disagrees.  The TPU's tiling
gates (M % 128, group-aligned K blocks) do not apply: the kernel takes
every shape ``quantize_gpt_int4`` produces.  A CPU tensor goes to the
plain twin; a CUDA tensor at N <= ``_N_CAP`` launches the kernel or
raises — there is no fallback.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import telemetry as _telemetry
from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_N_CAP = 256        # decode / serving batches; prefill-sized N goes plain
_BN, _BM = 8, 128   # csrc/woq_matmul.cu, "fma": rows of x, columns a CTA
_MIN_SPLIT_ROWS = 64    # packed rows per K split, at least ("fma")
_TC_BM, _TC_BN, _TC_BKP = 64, 64, 64   # "tc": columns, rows of x a CTA;
                                        # packed rows a stage
_ROUTES = {"fma": 0, "tc": 1}


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


def route(dtype, N: int, K: int, M: int, gs: int) -> str:
    """The kernel body for one launch: "tc" (the tensor-core body) for
    bf16 x when every k16 step stays inside one scale group in both halves
    of K (gs % 16 == 0 and K % 32 == 0), else "fma" (the fp32-FMA body:
    fp32 x is never rounded to bf16 or TF32).  N and M do not change it.
    Raises ``TypeError`` on a dtype the kernel does not take."""
    if dtype not in _DTYPES:
        raise TypeError(f"w4_matmul: x must be float32 or bfloat16, got "
                        f"{dtype}")
    if dtype == torch.bfloat16 and gs % 16 == 0 and K % 32 == 0:
        return "tc"
    return "fma"


def splits_for(N: int, K: int, M: int, sm_count: int, route: str) -> int:
    """K splits for one launch: enough CTAs for about two per SM when the
    output tiles alone are fewer (at N = 8 a 2048-wide output is 32 tiles
    of 64 columns on the tensor-core route, at N = 256 128 tiles of 64 ×
    64), while the fp32 partials (splits · N · M · 4 bytes, written and
    read once) stay within half the weight's K/2 · M bytes — so N = 256
    takes one split at 2048².  On the "tc"
    route a split walks whole 64-row stages and none is empty; on "fma"
    every split keeps at least ``_MIN_SPLIT_ROWS`` packed rows.  ``route``
    is :func:`route`'s answer for the launch."""
    Kp = K // 2
    if route == "tc":
        tiles, rows = -(-M // _TC_BM) * -(-N // _TC_BN), _TC_BKP
    else:
        tiles, rows = -(-M // _BM) * -(-N // _BN), _MIN_SPLIT_ROWS
    want = -(-2 * sm_count // tiles)
    splits = max(1, min(want, Kp // rows, K // (16 * N)))
    if route == "tc":           # csrc/woq_matmul.cu w4tc::chunk_rows
        per = -(-Kp // splits)
        chunk = -(-per // _TC_BKP) * _TC_BKP
        splits = -(-Kp // chunk)
    return splits


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


def w4_matmul_cost(x, packed, scale):
    """(FLOPs, bytes) of a :func:`w4_matmul` call for the device feed
    (``telemetry.counted``): 2·N·K·M FLOPs; x, the packed nibbles and
    the scales read, the [N, M] output written in x.dtype."""
    K, M = x.shape[-1], packed.shape[1]
    N = x.numel() // K
    return (2 * N * K * M,
            (x.numel() + N * M) * x.element_size() + packed.numel()
            + scale.numel() * 4)


@_telemetry.counted(w4_matmul_cost)
def w4_matmul(x, packed, scale):
    """x [..., K] @ dequant(packed [K/2, M] int8, scale [G, 1, M] float32)
    -> [..., M] in x.dtype, fp32 accumulation.  Raises ``ValueError`` on a
    shape mismatch.

    CPU tensors, and x with more than ``_N_CAP`` rows, run
    :func:`_plain_w4`.  Otherwise CUDA tensors launch the kernel of
    ``csrc/woq_matmul.cu`` (x float32 or bfloat16) on the body
    :func:`route` picks; every launch adds one to ``w4_matmul.launches``,
    and one on the tensor-core body also to ``w4_matmul.tc_launches``."""
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
    body = route(x.dtype, N, K, M, K // G)
    if body == "tc" and x2.data_ptr() % 16:
        x2 = x2.clone()             # cp.async stages x in 16-byte pieces
    out = torch.empty((N, M), dtype=x.dtype, device=x.device)
    splits = splits_for(N, K, M, _sm_count(x.device), body)
    part = torch.empty((splits, N, M) if splits > 1 else (1,),
                       dtype=torch.float32, device=x.device)
    fn = _build.load("woq_matmul").w4_matmul
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 \
            + [ctypes.c_void_p]
    with torch.cuda.device(x.device):
        code = fn(x2.data_ptr(), packed.data_ptr(), scale.data_ptr(),
                  out.data_ptr(), part.data_ptr(), N, K, M, K // G, splits,
                  _DTYPES[x.dtype], _ROUTES[body],
                  torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(code, "w4_matmul")
    w4_matmul.launches += 1
    w4_matmul.tc_launches += body == "tc"
    return out.reshape(*lead, M)


w4_matmul.launches = 0
w4_matmul.tc_launches = 0
