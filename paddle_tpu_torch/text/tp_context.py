"""The tensor-parallel context a serving rank runs its decode steps under.

A rank of a tensor-parallel server (``text/tp_serving.py``) holds its
block of every weight and of the KV cache and runs the same step bodies
as a single-card server; the few places where a rank's math differs from
one card's read :func:`current`:

* ``woq.embed`` / ``woq.logits`` — the vocab-parallel embedding (one
  all-reduce: one nonzero term a row) and the tied head, whose [.., V/mp]
  shard is all-gathered to the whole vocabulary, so sampling (which
  hashes the global vocab index, ``rng.py``) draws what one card draws;
* ``gpt._project_qkv`` — the rank's H/mp query heads and its kv heads;
* the attention projection (``generate._block_post_attn``,
  ``generate._prefill_block``) and the FFN's down product
  (``gpt._ffn_body``) — one all-reduce over ``mp`` each, before the bias;
* ``moe.moe_tail`` — the rank's E/ep experts and F/mp columns, one
  all-reduce over (ep, mp);
* the cached attention (``generate._attend_cache`` / ``_attend_masked``,
  ``kv_pool._attend_pool``) — where ``mp`` does not divide the kv heads
  every rank keeps all of them and attends the ones its query heads
  read (:func:`kv_view`).

Outside a rank's step — every single-card server, the train step — the
context is None and nothing changes.  It is per thread; a rank runs its
steps on one.
"""
from __future__ import annotations

import contextlib
import threading

_LOCAL = threading.local()


def current():
    """The :class:`DecodeShard` of the step running on this thread, or
    None."""
    return getattr(_LOCAL, "ctx", None)


@contextlib.contextmanager
def use(ctx):
    """Run the enclosed step bodies under ``ctx`` (None: unsharded)."""
    prev = current()
    _LOCAL.ctx = ctx
    try:
        yield ctx
    finally:
        _LOCAL.ctx = prev


class DecodeShard:
    """A rank's view of the decode math: the rank's ``mesh``
    (``distributed.topology.Mesh`` with its groups built), the ``mp`` and
    ``ep`` axes (None: not split) and, from the model config, its local
    query heads (``heads``), the kv heads its cache holds (``kv_heads``),
    the slice of them its queries attend (``kv_sel``: None when the cache
    is split, or all of it is read), whether the vocabulary is split
    (``vocab_split``) and its experts (``e0``, ``experts``)."""

    def __init__(self, mesh, cfg, mp=None, ep=None):
        self.mesh, self.mp, self.ep = mesh, mp, ep
        n = mesh.size(mp) if mp is not None else 1
        r = mesh.coord(mp) if mp is not None else 0
        self.n_mp, self.r_mp = n, r
        H, Hkv = cfg.num_heads, cfg.kv_heads
        if H % n:
            raise ValueError(f"num_heads={H} does not split over mp={n}")
        self.heads = H // n
        self.kv_split = Hkv % n == 0
        self.kv_sel = None
        if self.kv_split:
            self.kv_heads = Hkv // n
        else:
            # every rank keeps all Hkv heads; its query heads
            # [r·H/n, (r+1)·H/n) read kv heads h // G of them
            self.kv_heads = Hkv
            G = H // Hkv
            lo = r * self.heads // G
            hi = ((r + 1) * self.heads - 1) // G + 1
            if self.heads % (hi - lo):
                raise NotImplementedError(
                    f"mp={n} over num_heads={H}, kv_heads={Hkv}: a rank's "
                    f"query heads do not map evenly onto kv heads "
                    f"{lo}..{hi - 1}")
            if hi - lo < Hkv:
                self.kv_sel = (lo, hi - lo)
        self.vocab_split = n > 1 and cfg.vocab_size % n == 0
        self.vocab_per_shard = (cfg.vocab_size // n if self.vocab_split
                                else cfg.vocab_size)
        n_ep = mesh.size(ep) if ep is not None else 1
        E = cfg.moe.num_experts if cfg.moe is not None else 0
        self.n_ep = n_ep
        self.experts = E // n_ep if E else 0
        self.e0 = (mesh.coord(ep) if ep is not None else 0) * self.experts

    # Megatron's f and g, as ``megatron.TensorParallel`` spells them: the
    # decode steps run without autograd, so f is the identity and g one
    # all-reduce over mp
    def enter(self, x):
        return x

    def exit(self, y):
        from ..distributed import collective

        if self.n_mp == 1:
            return y
        return collective.all_reduce_(y.contiguous(), self.mesh, self.mp)

    def gather_vocab(self, y):
        """[..., V/mp] logits of every rank concatenated in vocab order."""
        from ..distributed import collective

        if not self.vocab_split:
            return y
        return collective.all_gather(y, self.mesh, self.mp,
                                     dim=y.dim() - 1)

    def reduce_experts(self, y):
        """The sum over (ep, mp) of each rank's expert partial."""
        from ..distributed import collective

        axes = tuple(a for a in (self.ep, self.mp) if a is not None)
        if not axes or self.mesh.size(axes) == 1:
            return y
        return collective.all_reduce_(y.contiguous(), self.mesh, axes)


def reduce_mp(y):
    """The all-reduce after a row-parallel product (identity unsharded)."""
    ctx = current()
    return y if ctx is None else ctx.exit(y)


def kv_view(t, axis: int):
    """``t`` (a cache leaf with its kv-head dim at ``axis``) narrowed to
    the kv heads this rank's queries read, where the cache is replicated
    and the rank reads a part of it; else ``t`` itself.  A leaf already
    narrowed passes through.  On the card the narrowed view is made
    contiguous (the kernels read a contiguous layer)."""
    ctx = current()
    if ctx is None or ctx.kv_sel is None or t.shape[axis] != ctx.kv_heads:
        return t
    lo, n = ctx.kv_sel
    out = t.narrow(axis, lo, n)
    return out.contiguous() if out.is_cuda else out


def kv_view_leaves(leaves: dict, axis: int) -> dict:
    """:func:`kv_view` over a layer's cache leaves (values and scales
    share the kv-head axis)."""
    if current() is None:
        return leaves
    return {n: (kv_view(v, axis) if n != "tables" else v)
            for n, v in leaves.items()}
