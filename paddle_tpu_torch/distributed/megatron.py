"""Megatron tensor-parallel layers with explicit collectives.

Counterpart of ``paddle_tpu/distributed/megatron.py`` (:31-101).  Each
function takes a rank's local shard of a weight, the mesh and the
tensor-parallel axis (None, or an axis of size 1: the one-card math).
The collectives are Megatron's autograd pair (``collective.copy_to`` /
``reduce_from``): every value after a reduction is the same on each rank
of the axis, and so is its gradient — the loss needs no 1/mp seed (the
JAX primitives' psum-transposes-to-psum convention does not carry over).

The vocab-parallel loss has two routes over a logits shard [N, V/mp]:

* :func:`vocab_parallel_softmax_ce` — kernels #6 / #7 through
  :class:`_VocabParallelCE`: ``ce_fwd`` on the shard gives its ``lse_r``
  and ``loss_r`` (a label outside the shard picks 0), so its pick is
  ``lse_r - loss_r``; one all-gather of the [2, N] pair gives the global
  lse (the logsumexp of the ``lse_r``) and the pick (their sum); the
  backward is ``ce_bwd`` on the shard with the global lse, i.e.
  softmax_global - onehot_local;
* :func:`plain_vocab_parallel_softmax_ce` — the reference's math in
  torch (global max from the gathered shard maxima, a summed partition
  function, the pick from its owner), differentiable through the pair.
"""
from __future__ import annotations

import torch

from ..ops import fused_ce
from . import collective as C


def _active(mesh, axis) -> bool:
    return mesh is not None and axis is not None and mesh.size(axis) > 1


class TensorParallel:
    """A rank's view of one tensor-parallel axis, as ``gpt._block`` takes
    it: its local heads and kv heads, and Megatron's f (:meth:`enter`,
    before a column-parallel product) and g (:meth:`exit`, after a
    row-parallel one)."""

    def __init__(self, mesh, axis, heads: int, kv_heads: int):
        self.mesh, self.axis = mesh, axis
        self.heads, self.kv_heads = heads, kv_heads

    def enter(self, x):
        return C.copy_to(x, self.mesh, self.axis)

    def exit(self, y):
        return C.reduce_from(y, self.mesh, self.axis)


def vocab_parallel_embedding(wte_local, tokens, mesh=None, axis=None,
                             vocab_per_shard=None, dtype=None):
    """wte[tokens] with the vocab dim sharded over ``axis``: each rank
    looks up the tokens it owns, zeros elsewhere, and one all-reduce
    assembles the rows (in ``dtype`` when given: one nonzero term a
    row, so the sum is exact in any dtype)."""
    if not _active(mesh, axis):
        e = wte_local[tokens]
        return e if dtype is None else e.to(dtype)
    vps = vocab_per_shard or wte_local.shape[0]
    local = tokens - mesh.coord(axis) * vps
    ok = (local >= 0) & (local < vps)
    e = wte_local[local.clamp(0, vps - 1)]
    if dtype is not None:
        e = e.to(dtype)
    e = torch.where(ok[..., None], e, torch.zeros((), dtype=e.dtype,
                                                  device=e.device))
    return C.reduce_from(e, mesh, axis)


def column_parallel_linear(x, w_local, b_local=None, mesh=None, axis=None):
    """y_local = f(x) @ W[:, shard] (+ b[shard]): the output's feature dim
    stays sharded; the input's gradient is all-reduced."""
    y = C.copy_to(x, mesh, axis) @ w_local
    return y if b_local is None else y + b_local


def row_parallel_linear(x_local, w_local, b=None, mesh=None, axis=None):
    """y = g(x_local @ W[shard, :]) (+ b): one all-reduce restores the
    whole activation; the bias is added once, after it."""
    y = C.reduce_from(x_local @ w_local, mesh, axis)
    return y if b is None else y + b


def vocab_parallel_logits(x, wte_local, mesh=None, axis=None):
    """The tied head against the vocab-sharded embedding: f(x) @
    wte_local.T -> local logits [..., V/mp] (left sharded)."""
    return C.copy_to(x, mesh, axis) @ wte_local.T


def _local_labels(targets, mesh, axis, vps):
    return (targets - mesh.coord(axis) * vps).to(torch.int64)


class _VocabParallelCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, mesh, axis):
        loss_r, lse_r = fused_ce.ce_fwd(logits, labels)
        pair = torch.stack([lse_r, lse_r - loss_r])       # [2, N]
        both = C.all_gather(pair[None], mesh, axis)       # [mp, 2, N]
        lse = torch.logsumexp(both[:, 0], dim=0)
        loss = lse - both[:, 1].sum(dim=0)
        ctx.save_for_backward(logits, labels, lse)
        return loss

    @staticmethod
    def backward(ctx, dloss):
        logits, labels, lse = ctx.saved_tensors
        dx = fused_ce.ce_bwd(logits, labels, lse.contiguous(),
                             dloss.float().contiguous())
        return dx, None, None, None


def vocab_parallel_softmax_ce(logits_local, targets, mesh=None, axis=None,
                              vocab_per_shard=None):
    """Per-token softmax CE (fp32) over logits sharded on the vocab dim,
    on kernels #6 / #7 (their plain twins for CPU tensors); without an
    active axis, ``fused_softmax_ce`` on the whole vocab."""
    if not _active(mesh, axis):
        return fused_ce.fused_softmax_ce(logits_local, targets)
    Vl = logits_local.shape[-1]
    vps = vocab_per_shard or Vl
    lead = logits_local.shape[:-1]
    labels = _local_labels(targets, mesh, axis, vps).reshape(-1)
    loss = _VocabParallelCE.apply(
        logits_local.reshape(-1, Vl).contiguous(), labels.contiguous(),
        mesh, axis)
    return loss.reshape(lead)


def plain_vocab_parallel_softmax_ce(logits_local, targets, mesh=None,
                                    axis=None, vocab_per_shard=None):
    """The reference's ``vocab_parallel_softmax_ce`` math in torch, fp32:
    log(z) + m - pick, with m the global max (no gradient), z the summed
    partition function and pick the target logit from its shard."""
    lg = logits_local.float()
    if not _active(mesh, axis):
        m = lg.amax(dim=-1, keepdim=True).detach()
        z = torch.exp(lg - m).sum(dim=-1)
        tl = torch.gather(lg, -1, targets[..., None].long())[..., 0]
        return torch.log(z) + m[..., 0] - tl
    vps = vocab_per_shard or lg.shape[-1]
    m_local = lg.detach().amax(dim=-1)
    m = C.all_gather(m_local[None], mesh, axis).amax(dim=0)
    z = C.reduce_from(torch.exp(lg - m[..., None]).sum(dim=-1), mesh, axis)
    local = _local_labels(targets, mesh, axis, vps)
    ok = (local >= 0) & (local < vps)
    tl = torch.gather(lg, -1, local.clamp(0, vps - 1)[..., None])[..., 0]
    tl = C.reduce_from(torch.where(ok, tl, torch.zeros_like(tl)), mesh, axis)
    return torch.log(z) + m - tl
