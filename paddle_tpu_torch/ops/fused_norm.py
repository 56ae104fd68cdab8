"""Fused LayerNorm, forward and backward: the hand-written Hopper kernels
and their plain PyTorch twins.

Counterpart of ``paddle_tpu/ops/fused_norm.py``.  The Pallas kernels
``_ln_fwd_impl`` and ``_ln_bwd_impl`` become ``csrc/fused_norm.cu`` (the
note at its top says what bounds them and how they are laid out); the
custom-vjp ``_fused_ln`` becomes :class:`_FusedLN`, a
``torch.autograd.Function`` that saves x in its own dtype and the [N, 1]
fp32 statistics — never an fp32 copy of x, which is what the plain
``F.layer_norm(x.float(), ...)`` path keeps for its backward.

The TPU's row padding (``_pad_rows``), row-block divisibility
(``_row_block``) and 128-column gate do not apply: the kernels mask ragged
edges and take any N and any F up to :data:`MAX_FEATURES`; a wider row
raises.  A CPU tensor goes to the plain twin; a CUDA tensor launches the
kernel or raises on what it does not take — there is no fallback.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import telemetry as _telemetry
from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_FEATURES = 8192          # csrc/fused_norm.cu kMaxF: one row in registers


def _plain_ln_fwd(x, g, b, eps=1e-5):
    """The forward kernel's math: x [N, F], g and b [F] -> (y [N, F] in
    x.dtype, mu [N, 1], rstd [N, 1] float32).  fp32 statistics, two passes
    (the mean, then the mean of the squared deviations)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    c = xf - mu
    rstd = torch.rsqrt((c * c).mean(dim=-1, keepdim=True) + eps)
    y = (c * rstd) * g.float() + b.float()
    return y.to(x.dtype), mu, rstd


def _plain_ln_bwd(x, g, mu, rstd, dy):
    """The backward kernel's math: (dx [N, F] in x.dtype, dg [F], db [F]
    float32) with c1 = mean(g·dy) and c2 = mean(g·dy·xhat) per row, and dg,
    db summed over all rows."""
    dyf = dy.float()
    xhat = (x.float() - mu) * rstd
    wdy = dyf * g.float()
    c1 = wdy.mean(dim=-1, keepdim=True)
    c2 = (wdy * xhat).mean(dim=-1, keepdim=True)
    dx = (wdy - c1 - xhat * c2) * rstd
    return dx.to(x.dtype), (dyf * xhat).sum(dim=0), dyf.sum(dim=0)


def _check(what, x, *params):
    if x.dtype not in _DTYPES:
        raise TypeError(f"{what}: x must be float32 or bfloat16, got "
                        f"{x.dtype}")
    if x.dim() != 2 or x.shape[0] == 0:
        raise ValueError(f"{what}: expected a non-empty x [N, F], got "
                         f"{tuple(x.shape)}")
    F = x.shape[1]
    if not 1 <= F <= MAX_FEATURES:
        raise ValueError(f"{what}: F = {F} columns; the kernel takes 1 to "
                         f"{MAX_FEATURES} (one row held in registers)")
    for name, t in params:
        if t.dtype != params[0][1].dtype or t.dtype not in _DTYPES:
            raise TypeError(f"{what}: g and b must share one dtype, float32 "
                            f"or bfloat16, got {t.dtype} for {name}")
        if t.shape != (F,):
            raise ValueError(f"{what}: {name} must be [{F}], got "
                             f"{tuple(t.shape)}")
    for name, t in (("x", x),) + params:
        if t.device != x.device:
            raise ValueError(f"{what}: x and {name} must share one device")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


def _fn(name, n_ptrs, n_ints, n_floats):
    fn = getattr(_build.load("fused_norm"), name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                       + [ctypes.c_float] * n_floats + [ctypes.c_int] * 2
                       + [ctypes.c_void_p])
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def bwd_plan(N: int, sm_count: int) -> tuple[int, int]:
    """(R, P) for the backward's row pass: P CTAs of R consecutive rows
    each — CTA b takes rows [b·R, min((b + 1)·R, N)) — so every row is
    normalised exactly once and at most one CTA, hence one fp32 partial
    row of dg and of db, falls to each SM."""
    R = -(-N // sm_count)
    return R, -(-N // R)


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def ln_fwd_cost(x, g, b, eps=1e-5):
    """(FLOPs, bytes) of an :func:`ln_fwd` call for the device feed
    (``telemetry.counted``): no matmul FLOPs (the feed counts the
    matmul family's, and a norm's elementwise work is not); x, g, b read,
    y and the fp32 mu, rstd written."""
    return 0, 2 * _nbytes(x) + _nbytes(g, b) + 8 * x.shape[0]


def ln_bwd_cost(x, g, mu, rstd, dy):
    """(FLOPs, bytes) of :func:`ln_bwd`: no matmul FLOPs; x, g, mu, rstd,
    dy read, dx and the fp32 dg, db written."""
    return 0, _nbytes(x, g, mu, rstd, dy) + _nbytes(x) + 8 * x.shape[1]


@_telemetry.counted(ln_fwd_cost)
def ln_fwd(x, g, b, eps=1e-5):
    """x [N, F], g and b [F] -> (y [N, F] in x.dtype, mu [N, 1], rstd
    [N, 1] float32).

    CPU tensors run :func:`_plain_ln_fwd`.  CUDA tensors launch the forward
    kernel of ``csrc/fused_norm.cu`` (x float32 or bfloat16, g and b of one
    of those dtypes); every launch adds one to ``ln_fwd.launches``."""
    if not x.is_cuda:
        return _plain_ln_fwd(x, g, b, eps)
    _check("ln_fwd", x, ("g", g), ("b", b))
    N, F = x.shape
    y = torch.empty_like(x)
    mu = torch.empty((N, 1), dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mu)
    fn = _fn("ln_fwd", 6, 2, 1)
    with torch.cuda.device(x.device):
        code = fn(x.data_ptr(), g.data_ptr(), b.data_ptr(), y.data_ptr(),
                  mu.data_ptr(), rstd.data_ptr(), N, F, eps,
                  _DTYPES[x.dtype], _DTYPES[g.dtype],
                  torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(code, "ln_fwd")
    ln_fwd.launches += 1
    return y, mu, rstd


ln_fwd.launches = 0


@_telemetry.counted(ln_bwd_cost)
def ln_bwd(x, g, mu, rstd, dy):
    """(dx [N, F] in x.dtype, dg [F], db [F] float32) from x and dy [N, F],
    g [F] and the forward's mu, rstd [N, 1] float32.

    CPU tensors run :func:`_plain_ln_bwd`.  CUDA tensors launch the
    backward kernels of ``csrc/fused_norm.cu`` — its row pass (at most one
    CTA per SM, :func:`bwd_plan`) and its column sum of dg/db — counted as
    one launch in ``ln_bwd.launches``."""
    if not x.is_cuda:
        return _plain_ln_bwd(x, g, mu, rstd, dy)
    _check("ln_bwd", x, ("g", g))
    N, F = x.shape
    if dy.dtype != x.dtype or dy.shape != x.shape \
            or dy.device != x.device or not dy.is_contiguous():
        raise ValueError(f"ln_bwd: dy must be contiguous {x.dtype} "
                         f"{tuple(x.shape)} on x's device, got {dy.dtype} "
                         f"{tuple(dy.shape)}")
    for name, t in (("mu", mu), ("rstd", rstd)):
        if t.dtype != torch.float32 or t.shape != (N, 1) \
                or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"ln_bwd: {name} must be contiguous float32 "
                             f"[{N}, 1] on x's device, got {t.dtype} "
                             f"{tuple(t.shape)}")
    R, P = bwd_plan(N, _sm_count(x.device))
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    part = torch.empty((2, P, F), **f32)
    dgb = torch.empty((2, F), **f32)
    fn = _fn("ln_bwd", 10, 3, 0)
    with torch.cuda.device(x.device):
        code = fn(x.data_ptr(), g.data_ptr(), mu.data_ptr(), rstd.data_ptr(),
                  dy.data_ptr(), dx.data_ptr(), part[0].data_ptr(),
                  part[1].data_ptr(), dgb[0].data_ptr(), dgb[1].data_ptr(),
                  N, F, R, _DTYPES[x.dtype], _DTYPES[g.dtype],
                  torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(code, "ln_bwd")
    ln_bwd.launches += 1
    return dx, dgb[0], dgb[1]


ln_bwd.launches = 0


class _FusedLN(torch.autograd.Function):
    """Row LayerNorm with the fused kernels on both sides (the JAX
    package's custom_vjp ``_fused_ln``): saves x, g and the [N, 1] mu and
    rstd; returns dg and db in the dtypes of g and b."""

    @staticmethod
    def forward(ctx, x, g, b, eps):
        y, mu, rstd = ln_fwd(x, g, b, eps)
        ctx.save_for_backward(x, g, mu, rstd)
        ctx.b_dtype = b.dtype
        return y

    @staticmethod
    def backward(ctx, dy):
        x, g, mu, rstd = ctx.saved_tensors
        dx, dg, db = ln_bwd(x, g, mu, rstd, dy.contiguous())
        return dx, dg.to(g.dtype), db.to(ctx.b_dtype), None


def fused_layer_norm(x, weight=None, bias=None, eps: float = 1e-5):
    """LayerNorm over the last axis of ``x`` ([..., F] -> [..., F] in
    x.dtype), differentiable in x, weight and bias.  ``weight`` defaults
    to ones and ``bias`` to zeros in x.dtype, as in the JAX package; a bias
    of another dtype than the weight enters the kernels cast to the
    weight's (its gradient comes back in its own)."""
    F = x.shape[-1]
    g = torch.ones(F, dtype=x.dtype, device=x.device) if weight is None \
        else weight.contiguous()
    b = torch.zeros(F, dtype=x.dtype, device=x.device) if bias is None \
        else bias
    b = b.to(g.dtype).contiguous()
    y = _FusedLN.apply(x.reshape(-1, F).contiguous(), g, b, eps)
    return y.reshape(x.shape)
