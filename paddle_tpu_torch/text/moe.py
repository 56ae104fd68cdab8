"""Mixture-of-Experts FFN layers (GShard-style routing), in PyTorch.

Counterpart of ``paddle_tpu/text/moe.py``.  The router picks each
token's top-k experts (softmax renormalized over the k), every
(token, choice) assignment takes a capacity slot of its expert in
token-major then choice order (a cumulative sum over the flattened
[N·k, E] one-hot), and assignments past the capacity C are dropped
(the residual keeps those tokens as they were).  Dispatch and combine
are dense [N, E, C] tensors and the expert FFN runs every expert on its
[C, D] buffer, as in the reference, so shapes are static — what a
captured CUDA graph needs too.

Where the reference scatters into the dispatch and combine tensors,
this module builds them from one-hots (each (token, expert, slot) cell
takes at most one assignment, so both are exact), and its top-k is a
stable descending sort: ``jax.lax.top_k`` breaks ties to the lowest
index, which ``torch.topk`` does not promise.

Serving calls :func:`moe_tail` (no aux loss; the routing statistics,
when asked, are added in place into the caller's int32 accumulator);
:func:`moe_ffn` is the reference's signature; training calls it under a
key, and then the router logits take ``router_noise`` × standard normals
drawn by ``rng.normal`` (counter-based, so a remat recompute draws them
again).  Its aux loss and the combine weights carry the reference's
gradients: the load statistic ``fe`` and the dispatch mask are
comparisons (no gradient), ``me`` and the gates reach the router through
the softmax.

:func:`moe_ffn_manual` is the expert-parallel form a mesh's train step
calls (``ExpertParallel`` is its view of the mesh): the tokens are the
same on every rank of ``ep`` and each rank runs only its E/ep experts on
its block of the dispatch and combine tensors; under ``mp`` each expert
holds F/mp columns and its down product is all-reduced over ``mp``
before ``b_out``; one all-reduce over ``ep`` merges the parts.  With
``route_axes`` (the train step's ``dp`` where JAX runs the step as one
GSPMD program) the router logits are all-gathered over those axes, so
that the capacity, the slot order and the aux loss are those of the
global token set, as in JAX, while each rank dispatches only its own
tokens.  Gradients follow Megatron's convention (``collective.copy_to``
/ ``reduce_from``): a leaf the ranks hold whole gets its complete
gradient on each rank, so no leaf's gradient is summed over ``ep``.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from .. import resolve_device, rng
from ..distributed import collective as _C
from . import tp_context as _tp_context
from . import woq


@dataclasses.dataclass
class MoEConfig:
    num_experts: int = 8
    capacity_factor: float = 1.25
    router_noise: float = 0.0          # jitter std for exploration
    aux_loss_weight: float = 0.01      # load-balancing loss (GShard eq. 4)
    top_k: int = 2


def init_moe_params(cfg: MoEConfig, d_model: int, d_ff: int, L: int,
                    gen: torch.Generator, device=None,
                    dtype=torch.float32) -> dict:
    """The stacked expert leaves of ``L`` layers with the reference's
    shapes and init scales: ``router_w`` [L, D, E] and the expert
    weights ``w_in`` [L, E, D, F], ``w_out`` [L, E, F, D] drawn normal
    (std 0.02) in float32 from ``gen``, one layer at a time (so the
    float32 transient is one layer's [E, D, F]), and stored in ``dtype``;
    biases zero.  ``router_w`` stays float32 whatever ``dtype`` is: the
    router computes in float32, as in the reference."""
    dev = resolve_device(device)
    E, D, Fd = cfg.num_experts, d_model, d_ff

    def nrm(shape, out_dtype):
        out = torch.empty((L, *shape), dtype=out_dtype, device=dev)
        for l in range(L):
            out[l] = (torch.randn(shape, generator=gen, device=dev,
                                  dtype=torch.float32) * 0.02).to(out_dtype)
        return out

    return {"router_w": nrm((D, E), torch.float32),
            "w_in": nrm((E, D, Fd), dtype),
            "b_in": torch.zeros((L, E, Fd), dtype=dtype, device=dev),
            "w_out": nrm((E, Fd, D), dtype),
            "b_out": torch.zeros((L, E, D), dtype=dtype, device=dev)}


def expert_capacity(n_tokens: int, cfg: MoEConfig) -> int:
    """Slots per expert for a call over ``n_tokens`` rows, by the
    reference's float expression: max(1, ceil(N · k / E · cf))."""
    return max(1, math.ceil(n_tokens * cfg.top_k / cfg.num_experts
                            * cfg.capacity_factor))


def _top_k_gating(logits, k: int):
    """(weights [N, k] renormalized over the k, indices [N, k], softmax
    probs [N, E]) — ties to the lowest index, as ``jax.lax.top_k``."""
    probs = torch.softmax(logits.float(), dim=-1)
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = w[:, :k], idx[:, :k]
    return w / w.sum(dim=-1, keepdim=True), idx, probs


def _route(params, xf, cfg: MoEConfig, key, E: int, C: int, dtype,
           valid=None, aux: bool = True):
    """The router: (disp [N, E, C] in ``dtype``, comb [N, E, C] float32,
    aux scalar or None).  ``valid`` [N] bool: tokens with False (bucket
    padding, free slots) claim no capacity slot, carry zero gates and
    stay out of the load-balancing statistics.  ``aux=False`` skips the
    aux loss (serving).  With a ``key`` and ``router_noise`` > 0 the
    logits take ``router_noise`` × ``rng.normal(key, [N, E])`` before
    the gating, as in the reference, so the noisy probabilities feed the
    gates and the aux statistics alike (the draws are not
    ``jax.random``'s: hold them by law).

    One-hots are comparisons against an ``arange``; an assignment whose
    slot is -1 (a masked token claimed nothing) or past C (dropped)
    matches no slot, so it lands nowhere in either tensor."""
    N = xf.shape[0]
    k = cfg.top_k
    dev = xf.device
    logits = xf.float() @ params["router_w"].float()
    if cfg.router_noise > 0.0 and key is not None:
        logits = logits + cfg.router_noise * rng.normal(key, logits.shape,
                                                        dev)
    gate_w, gate_idx, probs = _top_k_gating(logits, k)
    experts = torch.arange(E, device=dev)
    v = None if valid is None else valid.reshape(N)
    if v is not None:
        gate_w = gate_w * v.float()[:, None]
    aux_loss = _aux_loss(probs, gate_idx, experts, cfg, v) if aux else None
    onehot = gate_idx[..., None] == experts                        # [N,k,E]
    pos = _slots(onehot, v)
    disp, comb = _cells(onehot, pos, gate_w, C)
    return disp.to(dtype), comb, aux_loss


def _slots(onehot, v=None):
    """Each assignment's capacity slot [N, k]: token-major then choice
    order (a cumulative sum over the flattened [N·k, E] claims); -1
    where nothing was claimed."""
    N, k, E = onehot.shape
    claims = onehot if v is None else onehot & v[:, None, None]
    flat = claims.reshape(N * k, E).to(torch.int32)
    return (torch.cumsum(flat, dim=0) * flat - 1).amax(dim=-1).reshape(N, k)


def _cells(onehot, pos, gate_w, C: int):
    """(disp bool [N, E, C], comb float32 [N, E, C]) from the one-hots
    [N, k, E], the slots [N, k] and the gates [N, k]: a slot past C or
    -1 matches no cell."""
    k = onehot.shape[1]
    slot = pos[..., None] == torch.arange(C, device=pos.device)    # [N,k,C]
    disp = comb = None
    for j in range(k):
        cell = onehot[:, j, :, None] & slot[:, j, None, :]         # [N,E,C]
        c = cell * gate_w[:, j, None, None]
        disp = cell if disp is None else disp | cell
        comb = c if comb is None else comb + c
    return disp, comb


def _aux_loss(probs, gate_idx, experts, cfg: MoEConfig, v=None):
    """The load-balancing loss E · Σ_e f_e · m_e · weight over the
    (valid) tokens: f_e the share routed first to e (no gradient), m_e
    the mean router probability."""
    N, E = probs.shape
    first = (gate_idx[:, 0, None] == experts).float()
    if v is None:
        me = probs.mean(dim=0)
        fe = first.sum(dim=0) / N
    else:
        vf = v.float()[:, None]
        denom = torch.clamp_min(vf.sum(), 1.0)
        me = (probs * vf).sum(dim=0) / denom
        fe = (first * vf).sum(dim=0) / denom
    return E * torch.sum(fe * me) * cfg.aux_loss_weight


def _experts(params, disp, comb, xf, dt, down=None, bias: bool = True,
             comb_dt=None):
    """Dispatch -> each expert's FFN on its [C, D] buffer (tanh-gelu) ->
    combine: disp [N, E, C] (bool or ``dt``), comb [N, E, C] float32 over
    the experts ``params`` holds (all of them, or a rank's E/ep block with
    F/mp of each one's columns) -> y [N, D].  ``down`` runs on the down
    product before ``b_out`` (a training rank's all-reduce over mp),
    ``bias=False`` leaves ``b_out`` out (a serving rank off mp coordinate
    0), and the combine runs in ``comb_dt`` (None: ``dt``).  Weights
    resolve through ``woq.w`` (a cast of float experts, the dequantized
    int8 / int4 stacks)."""
    N, E, C = disp.shape
    D = xf.shape[-1]
    xin = (disp.to(dt).reshape(N, E * C).T @ xf).reshape(E, C, D)
    h = F.gelu(torch.bmm(xin, woq.w(params, "w_in", dt))
               + params["b_in"].to(dt)[:, None], approximate="tanh")
    out = torch.bmm(h, woq.w(params, "w_out", dt))
    if down is not None:
        out = down(out)
    if bias:
        out = out + params["b_out"].to(dt)[:, None]
    cd = dt if comb_dt is None else comb_dt
    return comb.to(cd).reshape(N, E * C) @ out.reshape(E * C, D).to(cd)


def _delta(disp, valid, k: int):
    """The routing statistics of one call from its dispatch mask: kept
    assignments per expert (int32 [E]) and dropped ones (valid tokens ×
    k − kept, int32 scalar)."""
    kept = disp.to(torch.int32).sum(dim=(0, 2), dtype=torch.int32)
    n_valid = (kept.new_full((), disp.shape[0]) if valid is None
               else valid.reshape(-1).to(torch.int32).sum(dtype=torch.int32))
    return n_valid * k - kept.sum(dtype=torch.int32), kept


def _moe(params, x, cfg: MoEConfig, key, valid, capacity, aux: bool):
    """Route x [..., D] and run the experts: (y [..., D], disp, aux)."""
    shape = x.shape
    xf = x.reshape(-1, shape[-1])
    C = (int(capacity) if capacity is not None
         else expert_capacity(xf.shape[0], cfg))
    disp, comb, aux_loss = _route(params, xf, cfg, key, cfg.num_experts, C,
                                  x.dtype, valid=valid, aux=aux)
    return (_experts(params, disp, comb, xf, x.dtype).reshape(shape), disp,
            aux_loss)


def moe_tail(params, x, cfg: MoEConfig, valid=None, capacity=None,
             stats=None):
    """The serving form of :func:`moe_ffn`: x [..., D] -> y [..., D]
    with no aux loss.  ``capacity`` overrides C (None: the
    capacity-factor bound over the call's tokens).  ``stats`` — a
    ``{"dropped": int32 [], "load": int32 [E]}`` accumulator
    (``moe_serving.moe_stats_init``) — takes this call's routing delta
    IN PLACE, so a captured step adds to the tensors it was bound to.
    On a tensor-parallel serving rank (``tp_context``) the experts are
    the rank's block: :func:`_moe_tail_sharded`."""
    ctx = _tp_context.current()
    if ctx is not None and (ctx.n_ep > 1 or ctx.n_mp > 1):
        return _moe_tail_sharded(params, x, cfg, ctx, valid, capacity,
                                 stats)
    y, disp, _ = _moe(params, x, cfg, None, valid, capacity, aux=False)
    if stats is not None:
        dropped, kept = _delta(disp, valid, cfg.top_k)
        stats["dropped"].add_(dropped)
        stats["load"].add_(kept)
    return y


def _moe_tail_sharded(params, x, cfg: MoEConfig, ctx, valid, capacity,
                      stats):
    """:func:`moe_tail` on a serving rank holding experts [e0, e0 + E/ep)
    and F/mp of each one's FFN columns (``moe_decode_rules``).  The router
    is whole on every rank and x the same on each, so every rank routes
    the call's tokens jointly and identically: the same capacity slots,
    the same drop and load counts (``stats`` — the host reads one rank's
    copy).  Each rank dispatches to its own experts, runs its columns,
    adds ``b_out`` on the mp coordinate 0 only and combines its part in
    float32; one float32 all-reduce over (ep, mp) sums the parts, rounded
    to the compute dtype once (as one card's combine product is)."""
    shape = x.shape
    D = shape[-1]
    xf = x.reshape(-1, D)
    dt = x.dtype
    C = (int(capacity) if capacity is not None
         else expert_capacity(xf.shape[0], cfg))
    disp, comb, _ = _route(params, xf, cfg, None, cfg.num_experts, C, dt,
                           valid=valid, aux=False)
    if stats is not None:
        dropped, kept = _delta(disp, valid, cfg.top_k)
        stats["dropped"].add_(dropped)
        stats["load"].add_(kept)
    e0, El = ctx.e0, params["w_in"].shape[0]
    y = _experts(params, disp[:, e0:e0 + El], comb[:, e0:e0 + El], xf, dt,
                 bias=ctx.r_mp == 0, comb_dt=torch.float32)
    return ctx.reduce_experts(y).to(dt).reshape(shape)


def moe_ffn(params, x, cfg: MoEConfig, key=None, valid=None,
            capacity: int | None = None, with_stats: bool = False):
    """x [..., D] -> (y [..., D], aux loss scalar), as the reference's
    ``moe_ffn``: C = ceil(N · k / E · cf) unless ``capacity`` overrides
    it; ``valid`` masks tokens out of routing.  ``with_stats`` also
    returns this call's ``{"dropped": int32, "load": int32 [E]}``.  The
    experts use tanh-gelu (the reference's ``activation`` default, the
    only one its GPT passes)."""
    y, disp, aux = _moe(params, x, cfg, key, valid, capacity, aux=True)
    if not with_stats:
        return y, aux
    dropped, kept = _delta(disp, valid, cfg.top_k)
    return y, aux, {"dropped": dropped, "load": kept}


# ---------------------------------------------------------------------------
# expert parallelism
# ---------------------------------------------------------------------------

def moe_param_shardings(ep="ep", mp=None) -> dict:
    """One layer's expert leaves' layout, as the reference's (moe.py:50):
    the experts split over ``ep``; inside each expert the FFN dim may
    split over ``mp``; the router is whole on every rank."""
    return {"router_w": (None, None), "w_in": (ep, None, mp),
            "b_in": (ep, mp), "w_out": (ep, mp, None), "b_out": (ep, None)}


class _GatherRows(torch.autograd.Function):
    """All-gather of rows over ``axes``; the backward reduce-scatters, so
    each rank gets the sum of every rank's gradient on its own rows."""

    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return _C.all_gather(t, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return _C.reduce_scatter(g, ctx.mesh, ctx.axes), None, None


def moe_ffn_manual(params, x, cfg: MoEConfig, mesh=None,
                   ep_axis: str | None = None, mp_axis: str | None = None,
                   key=None, route_axes=()):
    """The expert-parallel MoE FFN (the reference's ``moe_ffn_manual``,
    moe.py:123-170): x [..., D], the same on every rank of ``ep_axis``;
    ``params`` the rank's blocks of :func:`moe_param_shardings` (w_in
    [E/ep, D, F/mp], ...; the router whole) -> (y [..., D], aux).

    The router runs on every rank.  Without ``route_axes`` the call's
    tokens are routed as one set (the reference's manual path: a rank's
    micro-batch or sequence chunk); with them the float32 logits [N, E]
    are all-gathered over those axes and the capacity C, the slots and
    the aux loss are the gathered set's (JAX's GSPMD step over the
    global batch), the noise the gathered set's draw sliced to this
    rank's rows.  Each rank then dispatches its own rows to its own
    experts' [C, D] buffers (tanh-gelu), all-reduces the down product
    over ``mp_axis`` before ``b_out``, combines, and all-reduces over
    ``ep_axis``.  ``copy_to`` over (ep, mp) before the dispatch and over
    ep on the gates give the input and the router their whole
    gradients."""
    shape = x.shape
    D = shape[-1]
    xf = x.reshape(-1, D)
    n = xf.shape[0]
    dev = xf.device
    dt = x.dtype
    k = cfg.top_k
    E_local = params["w_in"].shape[0]
    n_ep = mesh.size(ep_axis) if mesh is not None else 1
    E = E_local * n_ep
    if E != cfg.num_experts:
        raise ValueError(f"{E_local} experts x ep {n_ep} != num_experts "
                         f"{cfg.num_experts}")
    group = mesh.active(route_axes) if mesh is not None else ()
    N = n * (mesh.size(group) if group else 1)
    row0 = mesh.index(group) * n if group else 0
    logits = xf.float() @ params["router_w"].float()
    if cfg.router_noise > 0.0 and key is not None:
        noise = rng.normal(key, (N, E), dev)[row0:row0 + n]
        logits = logits + cfg.router_noise * noise
    if group:
        logits = _GatherRows.apply(logits, mesh, group)
    C = expert_capacity(N, cfg)
    gate_w, gate_idx, probs = _top_k_gating(logits, k)
    experts = torch.arange(E, device=dev)
    aux = _aux_loss(probs, gate_idx, experts, cfg)
    pos = _slots(gate_idx[..., None] == experts)[row0:row0 + n]
    gate_w, gate_idx = gate_w[row0:row0 + n], gate_idx[row0:row0 + n]
    e0 = (mesh.coord(ep_axis) if mesh is not None else 0) * E_local
    if n_ep > 1:
        gate_w = _C.copy_to(gate_w, mesh, ep_axis)
    mine = gate_idx[..., None] == torch.arange(e0, e0 + E_local, device=dev)
    disp, comb = _cells(mine, pos, gate_w, C)          # [n, E_local, C]
    xe = xf if mesh is None else _C.copy_to(xf, mesh, (ep_axis, mp_axis))
    y = _experts(params, disp, comb, xe, dt,
                 down=(None if mesh is None
                       else lambda o: _C.reduce_from(o, mesh, mp_axis)))
    if mesh is not None:
        y = _C.reduce_from(y, mesh, ep_axis)
    return y.reshape(shape), aux


class ExpertParallel:
    """A rank's view of the MoE layout, as ``gpt._block`` takes it: the
    mesh, its ``ep`` and ``mp`` axes (None: not split) and the axes the
    router gathers its logits over (see :func:`moe_ffn_manual`)."""

    def __init__(self, mesh, ep_axis=None, mp_axis=None, route_axes=()):
        self.mesh, self.ep_axis, self.mp_axis = mesh, ep_axis, mp_axis
        self.route_axes = tuple(route_axes)

    def ffn(self, params, x, cfg: MoEConfig, key=None):
        return moe_ffn_manual(params, x, cfg, self.mesh, self.ep_axis,
                              self.mp_axis, key=key,
                              route_axes=self.route_axes)
