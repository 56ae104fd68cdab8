"""Ring attention — context parallelism over an axis of a ``Mesh``.

Counterpart of ``paddle_tpu/ops/ring_attention.py``.  q, k and v are a
rank's LOCAL rows of the sequence, whose chunks are laid out over the
ring of ``R`` ranks along ``axis``; at each step a rank attends its q
chunk to the k/v chunk it holds, merges the partial into its running
softmax state, and passes k/v to the next rank (one batched
``collective.exchange``: send to ``mesh.peer(axis, +1)``, receive from
``-1``, every rank posting both in the same call).  k and v may carry
Hkv < H heads (grouped-query attention): they ride the ring unrepeated.

Two routes compute the same function:

* **plain** — the JAX module's math in float32 (:func:`_block_attend`,
  :func:`_chunk_attend` with its ``sub`` walk, :func:`_merge`) under
  autograd, each ring step a non-reentrant ``torch.utils.checkpoint``
  (JAX's ``jax.checkpoint`` per step) and each sub-chunk another (its
  inner one); the k/v hop is :class:`_RingShift`, whose backward sends
  the gradients the other way.  Like JAX it computes every block, the
  fully masked ones too.  CPU tensors take it by default, and it is the
  kernel route's twin on the card.
* **kernel** — :class:`_RingFlash`: each block that the causal mask
  leaves live goes through kernel #1 (``flash_attention_fwd``, which
  returns out and its lse): ``causal=True`` on the diagonal blocks
  (square and aligned, so "row i sees keys j <= i" is JAX's ``q_pos >=
  k_pos``), ``causal=False`` on the fully visible ones, nothing for a
  fully masked block (in JAX such a block enters the merge with weight
  exp(-1e30 - m) = 0 after the live diagonal one, so skipping it is
  exact).  The partials merge by their lse in float32.  The backward
  walks the ring again: for each live block #2 gives dq and #3 dk/dv,
  both fed the global out and the merged lse (as the vocab-parallel CE
  feeds ``ce_bwd`` the global lse) and both writing float32 (their
  ``_f32out`` entries: a bf16 partial rounded before the sum loses bits
  where the blocks' partials cancel); the dk/dv partials accumulate in
  float32 and travel with k/v, and one last hop hands them to their
  owner.  Launches of #1 a call, in a ring of R at rank ``my``:
  contiguous causal ``my + 1``, zigzag ``2R + 1`` (3 at step 0, 2 at
  each later one), non-causal ``R``; the backward launches #2 and #3 as
  many times each.  ``sub_block`` does not change it: flash never forms
  the score block.  CUDA tensors take it by default; on CPU tensors the
  wrappers run their plain twins, so its ring logic is testable there.

The zigzag layout gives rank i the chunk pair (i, 2R-1-i) of 2R chunks
(:func:`zigzag_permutation`), which balances the causal work.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..distributed import collective as C
from . import flash_attention as fa

_NEG = -1e30


def _block_attend(q, k, v, scale, mask=None):
    """One dense score block in float32 -> (m [B, H, Tq], l [B, H, Tq],
    acc [B, H, Tq, D]).  q [B, Tq, H, D]; k/v [B, Tk, Hkv, D], Hkv
    dividing H (q head h reads kv head h // (H / Hkv)): the group dim
    folds into the einsums, so k/v are never repeated."""
    B, Tq, H, hd = q.shape
    Hkv = k.shape[2]
    if H % Hkv:
        raise ValueError(f"kv heads {Hkv} must divide q heads {H}")
    g = H // Hkv
    Tk = k.shape[1]
    qg = q.reshape(B, Tq, Hkv, g, hd).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * scale
    s = s.reshape(B, H, Tq, Tk)
    if mask is not None:
        s = torch.where(mask, s, torch.full((), _NEG, device=s.device))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgqs,bskd->bkgqd", p.reshape(B, Hkv, g, Tq, Tk),
                       v.float()).reshape(B, H, Tq, hd)
    return m, l, acc


def _merge(m_acc, l_acc, o_acc, m_new, l_new, acc_new):
    """Online-softmax merge of one partial into the running (max,
    denominator, accumulator) state."""
    m_next = torch.maximum(m_acc, m_new)
    a_old = torch.exp(m_acc - m_next)
    a_new = torch.exp(m_new - m_next)
    return (m_next, l_acc * a_old + l_new * a_new,
            o_acc * a_old[..., None] + acc_new * a_new[..., None])


def _mask(q_pos, k_pos):
    return (q_pos[:, None] >= k_pos[None, :])[None, None]


def _sub_step(q, kk, vv, scale, q_pos, kp, m, l, o):
    mm = None if q_pos is None else _mask(q_pos, kp)
    return _merge(m, l, o, *_block_attend(q, kk, vv, scale, mm))


def _chunk_attend(q, k, v, scale, pos=None, sub: int | None = None):
    """Blockwise partial attention, the causal mask given as POSITIONS
    ``pos = (q_pos [Tq], k_pos [Tk])`` (rows see columns with q_pos >=
    k_pos).  ``sub`` walks the kv rows in sub-chunks of that many rows
    with an online-softmax merge, each sub-chunk under its own
    checkpoint, so the largest live score tensor is [B, H, Tq, sub] —
    masks included — in the backward too."""
    if sub is not None and sub <= 0:
        raise ValueError(f"sub_block must be positive (got {sub})")
    if sub is None or sub >= k.shape[1]:
        mask = None if pos is None else _mask(*pos)
        return _block_attend(q, k, v, scale, mask)
    B, Tk, Hkv, D = k.shape
    if Tk % sub:
        raise ValueError(f"sub_block {sub} must divide the kv chunk {Tk}")
    Tq, H = q.shape[1], q.shape[2]
    dev = q.device
    m = torch.full((B, H, Tq), _NEG, device=dev)
    l = torch.zeros((B, H, Tq), device=dev)
    o = torch.zeros((B, H, Tq, D), device=dev)
    for i in range(Tk // sub):
        rows = slice(i * sub, (i + 1) * sub)
        q_pos, kp = (None, None) if pos is None else (pos[0], pos[1][rows])
        m, l, o = checkpoint(_sub_step, q, k[:, rows], v[:, rows], scale,
                             q_pos, kp, m, l, o, use_reentrant=False,
                             preserve_rng_state=False)
    return m, l, o


def _hop(mesh, axis, ts, off):
    """Send each of ``ts`` ``off`` steps along ``axis``; receive as many
    from ``-off``: one batched exchange."""
    return C.exchange(mesh, axis, [(t, off) for t in ts],
                      [(t.shape, t.dtype, -off) for t in ts])


class _RingShift(torch.autograd.Function):
    """k/v to the next rank of the ring; their gradients to the previous
    one in the backward."""

    @staticmethod
    def forward(ctx, mesh, axis, *ts):
        ctx.mesh, ctx.axis = mesh, axis
        return tuple(_hop(mesh, axis, ts, 1))

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, *_hop(ctx.mesh, ctx.axis, gs, -1))


def _finish(m, l, o, dtype):
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    return (o / l_safe[..., None]).to(dtype).transpose(1, 2)  # [B, T, H, D]


def _ring_step(q, k, v, scale, q_pos, k_pos, sub, m, l, o):
    pos = None if q_pos is None else (q_pos, k_pos)
    return _merge(m, l, o, *_chunk_attend(q, k, v, scale, pos, sub))


def _state(q, parts=1):
    B, T, H, D = q.shape
    dev = q.device
    return (torch.full((B, H, T // parts), _NEG, device=dev),
            torch.zeros((B, H, T // parts), device=dev),
            torch.zeros((B, H, T // parts, D), device=dev))


def _step_ckpt(*args):
    return checkpoint(_ring_step, *args, use_reentrant=False,
                      preserve_rng_state=False)


def _plain_ring(q, k, v, mesh, axis, causal, scale, sub):
    B, Tl, H, D = q.shape
    R, my = mesh.size(axis), mesh.coord(axis)
    rows = torch.arange(Tl, device=q.device)
    m, l, o = _state(q)
    for r in range(R):
        if r:
            k, v = _RingShift.apply(mesh, axis, k, v)
        src = (my - r) % R
        q_pos = my * Tl + rows if causal else None
        k_pos = src * Tl + rows if causal else None
        m, l, o = _step_ckpt(q, k, v, scale, q_pos, k_pos, sub, m, l, o)
    return _finish(m, l, o, q.dtype)


def _plain_zigzag(q, k, v, mesh, axis, scale, sub):
    Tc = q.shape[1] // 2
    R, my = mesh.size(axis), mesh.coord(axis)
    qa, qb = q[:, :Tc], q[:, Tc:]
    rows = torch.arange(Tc, device=q.device)

    def step(qq, kk, vv, diag, st):
        return _step_ckpt(qq, kk, vv, scale, rows if diag else None,
                          rows if diag else None, sub, *st)

    # step 0: qa sees its own diagonal; qb sees ka whole and its diagonal
    st_a = step(qa, k[:, :Tc], v[:, :Tc], True, _state(q, 2))
    st_b = step(qb, k[:, :Tc], v[:, :Tc], False, _state(q, 2))
    st_b = step(qb, k[:, Tc:], v[:, Tc:], True, st_b)
    for r in range(1, R):
        k, v = _RingShift.apply(mesh, axis, k, v)
        j = (my - r) % R
        st_b = step(qb, k[:, :Tc], v[:, :Tc], False, st_b)
        if j < my:      # low vs low is live
            st_a = step(qa, k[:, :Tc], v[:, :Tc], False, st_a)
        else:           # high vs high is live
            st_b = step(qb, k[:, Tc:], v[:, Tc:], False, st_b)
    return torch.cat([_finish(*st_a, q.dtype), _finish(*st_b, q.dtype)],
                     dim=1)


# ---------------------------------------------------------------------------
# the kernel route
# ---------------------------------------------------------------------------

def _parts(layout: str, T: int) -> dict:
    """The q / kv row ranges a layout's blocks name."""
    if layout == "zigzag":
        return {"lo": (0, T // 2), "hi": (T // 2, T)}
    return {"all": (0, T)}


def plan(layout: str, R: int, my: int, r: int) -> list:
    """The live blocks of ring step ``r`` at rank ``my``: [(q part, kv
    part, causal)] — the kernel route's launches of #1 at that step."""
    if layout == "zigzag":
        if r == 0:
            return [("lo", "lo", True), ("hi", "lo", False),
                    ("hi", "hi", True)]
        live = ("lo", "lo", False) if (my - r) % R < my \
            else ("hi", "hi", False)
        return [("hi", "lo", False), live]
    if layout == "full":
        return [("all", "all", False)]
    return [("all", "all", r == 0)] if r <= my else []


def launches(layout: str, R: int, my: int) -> int:
    """#1's launches of one kernel-route call (and #2's, #3's of its
    backward): contiguous causal my + 1, zigzag 2R + 1, full R."""
    return sum(len(plan(layout, R, my, r)) for r in range(R))


def _rows(t, part, parts):
    a, b = parts[part]
    return t if (a, b) == (0, t.shape[1]) else t[:, a:b].contiguous()


def _lse_rows(lse, part, parts):
    a, b = parts[part]
    return lse if (a, b) == (0, lse.shape[1]) else lse[:, a:b].contiguous()


def _lse_weight(lse, B, H):
    """[B*H, T] -> [B, T, H, 1]."""
    return lse.reshape(B, H, -1).permute(0, 2, 1)[..., None]


def _merge_lse(acc, out, lse):
    """Merge the block partial (out in q.dtype, lse) into the running
    (lse, float32 out) of a q part."""
    if acc is None:
        return lse, out.float()
    lse_a, o_a = acc
    B, _, H, _ = out.shape
    lse_n = torch.logaddexp(lse_a, lse)
    o = (o_a * torch.exp(_lse_weight(lse_a - lse_n, B, H))
         + out.float() * torch.exp(_lse_weight(lse - lse_n, B, H)))
    return lse_n, o


def _ring_fwd(q, k, v, mesh, axis, layout, scale):
    R, my = mesh.size(axis), mesh.coord(axis)
    parts = _parts(layout, q.shape[1])
    qs = {n: _rows(q, n, parts) for n in parts}
    acc = dict.fromkeys(parts)
    for r in range(R):
        if r:
            k, v = _hop(mesh, axis, (k, v), 1)
        for qn, kn, causal in plan(layout, R, my, r):
            o, lse = fa.flash_attention_fwd(qs[qn], _rows(k, kn, parts),
                                            _rows(v, kn, parts), causal,
                                            scale)
            acc[qn] = _merge_lse(acc[qn], o, lse)
    out = torch.cat([acc[n][1] for n in parts], dim=1).to(q.dtype)
    lse = torch.cat([acc[n][0] for n in parts], dim=1).contiguous()
    return out.contiguous(), lse


def _block_bwd(q, k, v, out, lse, do, causal, scale):
    """One live block's (dq, dk, dv) in float32: #2 and #3 from their
    float32-out entries (the plain twin on CPU tensors), so the sums over
    the ring round once, at the end."""
    if not q.is_cuda:
        return fa._plain_bwd(q, k, v, out, lse, do, causal, scale,
                             f32_out=True)
    dq, delta = fa.flash_attention_bwd_dq(q, k, v, out, lse, do, causal,
                                          scale, f32_out=True)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, lse, delta, do, causal,
                                        scale, f32_out=True)
    return dq, dk, dv


def _ring_bwd(q, k, v, out, lse, do, mesh, axis, layout, scale):
    R, my = mesh.size(axis), mesh.coord(axis)
    parts = _parts(layout, q.shape[1])
    qs = {n: _rows(q, n, parts) for n in parts}
    outs = {n: _rows(out, n, parts) for n in parts}
    dos = {n: _rows(do, n, parts) for n in parts}
    lses = {n: _lse_rows(lse, n, parts) for n in parts}
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    for r in range(R):
        if r:
            k, v, dk, dv = _hop(mesh, axis, (k, v, dk, dv), 1)
        for qn, kn, causal in plan(layout, R, my, r):
            a, b = parts[kn]
            gq, gk, gv = _block_bwd(qs[qn], _rows(k, kn, parts),
                                    _rows(v, kn, parts), outs[qn], lses[qn],
                                    dos[qn], causal, scale)
            qa, qb = parts[qn]
            dq[:, qa:qb] += gq
            dk[:, a:b] += gk
            dv[:, a:b] += gv
    if R > 1:   # the chunk held now is the next rank's: hand its grads over
        dk, dv = _hop(mesh, axis, (dk, dv), 1)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _RingFlash(torch.autograd.Function):
    """The kernel route, differentiable: saves q, k, v, the merged out
    and lse; the backward walks the ring again."""

    @staticmethod
    def forward(ctx, q, k, v, mesh, axis, layout, scale):
        out, lse = _ring_fwd(q, k, v, mesh, axis, layout, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mesh, ctx.axis, ctx.layout, ctx.scale = mesh, axis, layout, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _ring_bwd(q, k, v, out, lse, do.contiguous(), ctx.mesh,
                               ctx.axis, ctx.layout, ctx.scale)
        return dq, dk, dv, None, None, None, None


def _route(q, route):
    route = route or ("kernel" if q.is_cuda else "plain")
    if route not in ("kernel", "plain"):
        raise ValueError(f"unknown ring route {route!r}")
    return route


def ring_attention(q, k, v, mesh, axis: str = "sp", causal: bool = True,
                   scale=None, sub_block: int | None = None,
                   route: str | None = None):
    """Sequence-parallel attention over the ``axis`` ring of ``mesh``:
    q [B, Tl, H, D], k/v [B, Tl, Hkv, D], this rank's chunk ``my`` of
    the contiguous layout (global rows [my·Tl, (my+1)·Tl)) -> its output
    chunk [B, Tl, H, D] in q.dtype.  ``sub_block`` caps the plain
    route's live score block at [B, H, Tl, sub_block].  ``route``:
    "kernel", "plain", or None — the kernel route on CUDA tensors, the
    plain one on CPU tensors (module docstring)."""
    D = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    if _route(q, route) == "plain":
        return _plain_ring(q, k, v, mesh, axis, causal, scale, sub_block)
    return _RingFlash.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                            mesh, axis, "causal" if causal else "full",
                            scale)


def zigzag_permutation(T: int, R: int):
    """Global row order placing chunk pair (i, 2R-1-i) on rank i:
    ``x_zig = x[perm]``, chunks of T/(2R) rows."""
    if T % (2 * R):
        raise ValueError(f"zigzag needs seq len divisible by 2R "
                         f"(T={T}, R={R})")
    Tc = T // (2 * R)
    idx = []
    for i in range(R):
        idx.extend(range(i * Tc, (i + 1) * Tc))
        idx.extend(range((2 * R - 1 - i) * Tc, (2 * R - i) * Tc))
    return np.asarray(idx, np.int32)


def zigzag_inverse(T: int, R: int):
    """``x == x_zig[zigzag_inverse(T, R)]``."""
    perm = zigzag_permutation(T, R)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(T, dtype=np.int32)
    return inv


def ring_attention_zigzag(q, k, v, mesh, axis: str = "sp", scale=None,
                          sub_block: int | None = None,
                          route: str | None = None):
    """Causal ring attention in the zigzag layout: q/k/v [B, 2·Tc, H, D]
    whose rows [:Tc] are global chunk ``my`` and [Tc:] chunk 2R-1-my ->
    the output in the same layout.  Routes as :func:`ring_attention`."""
    if q.shape[1] % 2:
        raise ValueError("zigzag local chunk must hold an even row count")
    D = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    if _route(q, route) == "plain":
        return _plain_zigzag(q, k, v, mesh, axis, scale, sub_block)
    return _RingFlash.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                            mesh, axis, "zigzag", scale)


class SequenceParallel:
    """A rank's view of the ``sp`` axis, as ``gpt._block`` takes it: its
    attention is the ring, in the contiguous or the zigzag layout."""

    def __init__(self, mesh, axis: str = "sp", zigzag: bool = False,
                 sub_block: int | None = None):
        self.mesh, self.axis, self.zigzag = mesh, axis, bool(zigzag)
        self.sub_block = sub_block

    def attend(self, q, k, v):
        if self.zigzag:
            return ring_attention_zigzag(q, k, v, self.mesh, self.axis,
                                         sub_block=self.sub_block)
        return ring_attention(q, k, v, self.mesh, self.axis, causal=True,
                              sub_block=self.sub_block)
