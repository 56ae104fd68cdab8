"""Fused softmax cross-entropy, forward and backward: the hand-written
Hopper kernels and their plain PyTorch twins.

Counterpart of ``paddle_tpu/ops/fused_ce.py``.  The Pallas kernels
``_ce_fwd_impl`` and ``_ce_bwd_impl`` become ``csrc/fused_ce.cu`` (the
note at its top says what bounds them and how they are laid out); the
custom-vjp ``_fused_ce`` becomes :class:`_FusedCE`, a
``torch.autograd.Function``.  The loss head never holds an [N, V] fp32
log-softmax: the forward saves the [N] logsumexp, the backward recomputes
the softmax from the logits.

The TPU's row padding (``_pad_rows``) and vocab-block divisibility
(``_blocks``) do not apply: the kernels take any N and V.  A CPU tensor
goes to the plain twin; a CUDA tensor launches the kernel or raises on
what it does not take — there is no fallback.
"""
from __future__ import annotations

import ctypes

import torch

from .. import telemetry as _telemetry
from . import _build, _counts

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _plain_ce_fwd(logits, labels):
    """The forward kernel's math: logits [N, V], int labels [N] ->
    (loss [N], lse [N]) float32; lse = log-sum-exp of the fp32 logits,
    loss = lse - logits[label] (a label outside [0, V) picks 0)."""
    x = logits.float()
    m = x.amax(dim=-1)
    lse = m + torch.log(torch.exp(x - m[:, None]).sum(dim=-1))
    V = x.shape[-1]
    ok = (labels >= 0) & (labels < V)
    pick = x.gather(-1, labels.clamp(0, V - 1).long()[:, None])[:, 0]
    return lse - torch.where(ok, pick, torch.zeros_like(pick)), lse


def _plain_ce_bwd(logits, labels, lse, dloss):
    """The backward kernel's math: dlogits = (exp(x - lse) - onehot(label))
    * dloss per row, in fp32, cast to logits.dtype."""
    x = logits.float()
    cols = torch.arange(x.shape[-1], device=x.device)
    onehot = (cols[None, :] == labels.long()[:, None]).float()
    dx = (torch.exp(x - lse[:, None]) - onehot) * dloss.float()[:, None]
    return dx.to(logits.dtype)


def _check(what, logits, labels):
    if logits.dtype not in _DTYPES:
        raise TypeError(f"{what}: logits must be float32 or bfloat16, got "
                        f"{logits.dtype}")
    if logits.dim() != 2 or labels.shape != logits.shape[:1]:
        raise ValueError(f"{what}: expected logits [N, V] and labels [N], "
                         f"got {tuple(logits.shape)}, {tuple(labels.shape)}")
    if labels.dtype != torch.int64:
        raise TypeError(f"{what}: labels must be int64, got {labels.dtype}")
    if logits.shape[0] == 0 or logits.shape[1] == 0:
        raise ValueError(f"{what}: empty logits {tuple(logits.shape)}")
    if labels.device != logits.device:
        raise ValueError(f"{what}: logits and labels must share one device")
    for name, t in (("logits", logits), ("labels", labels)):
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


def _fn(name, n_ptrs):
    fn = getattr(_build.load("fused_ce"), name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
    return fn


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def ce_fwd_cost(logits, labels):
    """(FLOPs, bytes) of a :func:`ce_fwd` call for the device feed
    (``telemetry.counted``): no matmul FLOPs; the logits and labels
    read, the fp32 loss and lse written."""
    return 0, _nbytes(logits, labels) + 8 * logits.shape[0]


def ce_bwd_cost(logits, labels, lse, dloss):
    """(FLOPs, bytes) of :func:`ce_bwd`: no matmul FLOPs; logits, labels,
    lse, dloss read, dlogits written."""
    return 0, 2 * _nbytes(logits) + _nbytes(labels, lse, dloss)


@_telemetry.counted(ce_fwd_cost)
def ce_fwd(logits, labels):
    """logits [N, V], labels [N] int64 -> (loss [N], lse [N]) float32.

    CPU tensors run :func:`_plain_ce_fwd`.  CUDA tensors launch the
    forward kernel of ``csrc/fused_ce.cu`` (float32 or bfloat16 logits);
    every launch adds one to ``ce_fwd.launches``."""
    if not logits.is_cuda:
        return _plain_ce_fwd(logits, labels)
    _check("ce_fwd", logits, labels)
    N, V = logits.shape
    f32 = dict(dtype=torch.float32, device=logits.device)
    loss = torch.empty(N, **f32)
    lse = torch.empty(N, **f32)
    fn = _fn("ce_fwd", 4)
    with torch.cuda.device(logits.device):
        code = fn(logits.data_ptr(), labels.data_ptr(), loss.data_ptr(),
                  lse.data_ptr(), N, V, _DTYPES[logits.dtype],
                  torch.cuda.current_stream(logits.device).cuda_stream)
    _build.check(code, "ce_fwd")
    _counts.bump(ce_fwd, launches=1)
    return loss, lse


ce_fwd.launches = 0


@_telemetry.counted(ce_bwd_cost)
def ce_bwd(logits, labels, lse, dloss):
    """dlogits [N, V] in logits.dtype = (softmax - onehot(label)) * dloss,
    the softmax recomputed from ``lse`` [N] float32; ``dloss`` [N].

    CPU tensors run :func:`_plain_ce_bwd`.  CUDA tensors launch the
    backward kernel of ``csrc/fused_ce.cu``; every launch adds one to
    ``ce_bwd.launches``."""
    if not logits.is_cuda:
        return _plain_ce_bwd(logits, labels, lse, dloss)
    _check("ce_bwd", logits, labels)
    N, V = logits.shape
    for name, t in (("lse", lse), ("dloss", dloss)):
        if t.dtype != torch.float32 or t.shape != (N,) \
                or t.device != logits.device or not t.is_contiguous():
            raise ValueError(f"ce_bwd: {name} must be contiguous float32 "
                             f"[{N}] on the logits' device, got {t.dtype} "
                             f"{tuple(t.shape)}")
    dx = torch.empty_like(logits)
    fn = _fn("ce_bwd", 5)
    with torch.cuda.device(logits.device):
        code = fn(logits.data_ptr(), labels.data_ptr(), lse.data_ptr(),
                  dloss.data_ptr(), dx.data_ptr(), N, V,
                  _DTYPES[logits.dtype],
                  torch.cuda.current_stream(logits.device).cuda_stream)
    _build.check(code, "ce_bwd")
    _counts.bump(ce_bwd, launches=1)
    return dx


ce_bwd.launches = 0


class _FusedCE(torch.autograd.Function):
    """Per-row softmax cross-entropy with the fused kernels on both sides
    (the JAX package's custom_vjp ``_fused_ce``): saves the logits, the
    labels and the [N] lse; labels get no gradient."""

    @staticmethod
    def forward(ctx, logits, labels):
        loss, lse = ce_fwd(logits, labels)
        ctx.save_for_backward(logits, labels, lse)
        return loss

    @staticmethod
    def backward(ctx, dloss):
        logits, labels, lse = ctx.saved_tensors
        return ce_bwd(logits, labels, lse, dloss.float().contiguous()), None


def fused_softmax_ce(logits, labels):
    """Per-row cross-entropy: logits [..., V], int labels [...] -> loss
    [...] float32, differentiable in the logits."""
    V = logits.shape[-1]
    lead = logits.shape[:-1]
    loss = _FusedCE.apply(logits.reshape(-1, V).contiguous(),
                          labels.reshape(-1).to(torch.int64).contiguous())
    return loss.reshape(lead)
