"""A functional pipeline over embed, stage and head functions —
counterpart of ``paddle_tpu/distributed/pipeline.py``
(``make_pipeline_loss`` :31, ``build_pipeline_train_step`` :78).

There the schedule is one ``lax.scan`` of ``M + S - 1`` ticks under
``shard_map`` over the ``pp`` axis, each tick's output moving one stage
on by ``ppermute``, and ``jax.grad`` differentiates through the hops.
Here each pp rank is a process: it runs the ticks itself, and the hop is
:class:`_Hop`, a ``torch.autograd.Function`` over
``collective.exchange`` — forward: send this tick's output to stage
``(s + 1) % S`` (the ring's wrap included) and receive stage ``s - 1``'s;
backward: send the received value's gradient back to ``s - 1`` and take
the sent value's gradient from ``s + 1``.  Every rank makes one hop a
tick and each tick's input depends on the last hop's output (stage 0
through a zero-gradient tie, as JAX's ``where``), so each rank's
backward runs the hops in reverse tick order — one matched exchange a
tick on every rank.

Bubble ticks are skipped where that is exact: stage ``s`` runs its
stage only at ticks ``s .. s + M - 1``, when it holds a micro-batch; at
the others its output is its input passed on unchanged.  What a bubble
tick computes in the JAX scan never reaches the loss (it travels only
into other bubble ticks, and the wrap's value is dropped by stage 0), so
the loss and gradients are the same, and each rank launches its stage's
kernels for M micro-batches.  Stage 0 embeds micro-batch
``clip(t, 0, M - 1)`` at its active ticks; the last stage adds the head
loss at ticks ``t ≥ S - 1`` (micro-batch ``t - S + 1``).  The loss is
summed over pp (forward only: each rank's gradient comes from its own
terms, as the psum's transpose gives) and divided by M.

The per-tick key of ``jax.random.split(key, ticks)`` is the port's
counter-based ``rng.fold_in(key, t)``: a stage function that draws
(dropout) draws other values than JAX's, by law.

The model contract is the stacked-block layout of ``text.gpt``:
``params["blocks"]`` leaves carry a leading layer axis cut over ``pp``
(spec entry ``"pp"``), so each stage holds ``L / S`` layers —
``gpt.shard_params`` cuts a whole tree so, ``gpt.gather_params`` joins
it back.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from .. import rng
from . import collective


class _Hop(torch.autograd.Function):
    """One tick's ring hop along ``axis``: send ``y`` one stage on,
    receive the previous stage's; the backward hops the gradients the
    other way."""

    @staticmethod
    def forward(ctx, y, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        (x,) = collective.exchange(mesh, axis, sends=[(y, 1)],
                                   recvs=[(y.shape, y.dtype, -1)])
        return x

    @staticmethod
    def backward(ctx, g):
        (gy,) = collective.exchange(ctx.mesh, ctx.axis,
                                    sends=[(g.contiguous(), -1)],
                                    recvs=[(g.shape, g.dtype, 1)])
        return gy, None, None


class _Tie(torch.autograd.Function):
    """``a`` forward; gradients (g, zeros shaped as ``b``): ``b`` joins
    the graph without changing a value.  Stage 0's input drops what the
    ring's wrap delivered but keeps it in the graph (JAX's ``where(s ==
    0, embed, x_recv)``); the loss keeps the last hop's output; the first
    tick's zeros hang from a parameter — so that on every rank every
    hop lies between the loss and the parameters, and autograd runs each
    hop's backward (it skips nodes no requested input depends on)."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.b = (b.shape, b.dtype, b.device)
        return a.view_as(a)

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.b
        return g, torch.zeros(shape, dtype=dtype, device=device)


def _grad_leaf(tree):
    """A tensor of ``tree`` that takes gradients, or None."""
    if isinstance(tree, dict):
        for v in tree.values():
            t = _grad_leaf(v)
            if t is not None:
                return t
        return None
    return tree if getattr(tree, "requires_grad", False) else None


def make_pipeline_loss(embed_fn, stage_fn, head_loss_fn, n_micro: int,
                       pp_size: int, pp_axis: str = "pp",
                       remat_stage: bool = True, mesh=None):
    """The loss of one pp rank for a static pipeline size ``pp_size``:
    ``loss_fn(params, tokens, key, mesh=None)`` on this rank's params
    (its ``L / S`` block layers) and its tokens [B, T + 1] (B divisible
    by ``n_micro``), on ``mesh`` (the call's, else the one given here,
    else ``env.get_mesh()``).  ``embed_fn(params, tokens_mb) -> x``,
    ``stage_fn(blocks, x, key) -> y`` (``key`` an int from ``rng``, the
    tick's), ``head_loss_fn(params, y, tokens_mb) -> scalar``.  Returns
    the 0-d fp32 loss, the same on every pp rank; its backward gives this
    rank's gradients (see the module docstring).  ``remat_stage`` runs
    each stage call under ``torch.utils.checkpoint``."""
    S, M = int(pp_size), int(n_micro)
    stage = stage_fn
    if remat_stage:
        def stage(blocks, x, k):
            return checkpoint(stage_fn, blocks, x, k, use_reentrant=False)
    default_mesh = mesh

    def loss_fn(params, tokens, key=0, mesh=None):
        from . import env

        mesh = mesh or default_mesh or env.get_mesh()
        if mesh.size(pp_axis) != S:
            raise ValueError(f"the mesh's {pp_axis!r} has "
                             f"{mesh.size(pp_axis)} ranks, not {S}")
        s = mesh.coord(pp_axis)
        B = tokens.shape[0]
        if B % M:
            raise ValueError(f"batch {B} does not divide into {M} "
                             f"micro-batches")
        mb = tokens.reshape((M, B // M) + tuple(tokens.shape[1:]))
        ticks = M + S - 1
        with torch.no_grad():
            probe = embed_fn(params, mb[0])
        x_recv = torch.zeros_like(probe)
        anchor = _grad_leaf(params)
        if anchor is not None:
            x_recv = _Tie.apply(x_recv, anchor)
        loss = torch.zeros((), dtype=torch.float32, device=probe.device)
        key = 0 if key is None else key
        for t in range(ticks):
            active = s <= t <= s + M - 1
            if s == 0:
                x_in = (_Tie.apply(embed_fn(params, mb[min(t, M - 1)]),
                                   x_recv) if active else x_recv)
            else:
                x_in = x_recv
            y = (stage(params["blocks"], x_in, rng.fold_in(key, t))
                 if active else x_in)
            if s == S - 1 and t >= S - 1:
                loss = loss + head_loss_fn(params, y, mb[t - (S - 1)]).float()
            x_recv = _Hop.apply(y, mesh, pp_axis) if S > 1 else y
        if S > 1:
            loss = _Tie.apply(loss, x_recv)
        # summed over pp in the forward only: each stage's gradient comes
        # from the terms it computed, as the psum's transpose gives
        return collective.reduce_from(loss, mesh, pp_axis) / M

    return loss_fn


def _pp_cut(spec, pp_axis) -> bool:
    return any(pp_axis in (e if isinstance(e, tuple) else (e,))
               for e in (spec or ()))


def _leaves(tree, specs, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, specs[k], path + (k,))
    else:
        yield path, tree, specs


def _build(pairs):
    out: dict = {}
    for path, v in pairs:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def build_pipeline_train_step(mesh, embed_fn, stage_fn, head_loss_fn,
                              param_specs, optimizer, n_micro: int,
                              dp_axis="dp", pp_axis="pp", remat_stage=True):
    """The full train step with pp (and optionally dp) over ``mesh`` (a
    ``topology.Mesh`` with only ``dp_axis`` and ``pp_axis`` above size
    1).  ``param_specs``: each leaf's spec (``gpt.param_shardings``'
    form); the leaves cut over ``pp_axis`` are this rank's layers, the
    others are held whole on every rank.

    Returns ``step(params, opt_state, tokens, key, lr, step) -> (params,
    opt_state, loss)`` on this rank's params (``gpt.shard_params``' cut)
    and the global batch (each dp rank takes its block of rows).  The
    gradients of the pp-replicated leaves (embedding, head) are summed
    over pp — as shard_map's transpose sums them — and every gradient and
    the loss are meaned over dp; ``optimizer.apply_gradients(grads,
    params, opt_state, lr=lr, step=step + 1)`` makes the update.
    ``step.loss_and_grads(params, tokens, key)`` gives the loss and the
    synced gradients (this rank's blocks) without the update."""
    for name in mesh.names:
        if name not in (dp_axis, pp_axis) and mesh.size(name) > 1:
            raise ValueError(f"build_pipeline_train_step: axis {name!r} "
                             f"is neither dp ({dp_axis!r}) nor pp "
                             f"({pp_axis!r})")
    S = mesh.size(pp_axis)
    loss_inner = make_pipeline_loss(embed_fn, stage_fn, head_loss_fn,
                                    n_micro, S, pp_axis, remat_stage, mesh)
    dp = mesh.size(dp_axis)

    def loss_and_grads(params, tokens, key):
        dev = mesh.device
        tokens = torch.as_tensor(tokens, device=dev).long()
        if tokens.shape[0] % dp:
            raise ValueError(f"batch {tokens.shape[0]} does not divide "
                             f"over {dp_axis} ({dp} ranks)")
        rows = tokens.shape[0] // dp
        tokens = tokens[mesh.coord(dp_axis) * rows:][:rows]
        pairs = list(_leaves(params, param_specs))
        leaves = [t.detach().requires_grad_(True) for _, t, _ in pairs]
        loss = loss_inner(_build((p, t) for (p, _, _), t in
                                 zip(pairs, leaves)), tokens, key, mesh)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        out = []
        for (path, _, spec), leaf, g in zip(pairs, leaves, grads):
            g = torch.zeros_like(leaf) if g is None else g
            if not _pp_cut(spec, pp_axis):
                collective.all_reduce_(g, mesh, pp_axis)
            if dp > 1:
                collective.all_reduce_(g, mesh, dp_axis).div_(dp)
            out.append((path, g))
        loss = loss.detach()
        if dp > 1:
            loss = collective.all_reduce(loss, mesh, dp_axis) / dp
        return loss, _build(out)

    def step_fn(params, opt_state, tokens, key, lr, step):
        loss, grads = loss_and_grads(params, tokens, key)
        new_p, new_o = optimizer.apply_gradients(
            grads, params, opt_state, lr=lr, step=step + 1)
        return new_p, new_o, loss

    step_fn.loss_and_grads = loss_and_grads
    return step_fn
