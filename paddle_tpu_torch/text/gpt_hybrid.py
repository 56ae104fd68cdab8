"""The GPT train step: on one card, or hybrid-parallel over a mesh of
ranks.

Counterpart of ``paddle_tpu/text/gpt_hybrid.py``'s
``build_gpt_train_step`` (gpt_hybrid.py:551-766), with the same contract:
``step_fn(state, tokens, key, lr) -> (state, loss)``.

**One card** (no mesh, or a mesh whose axes are all 1).  Parameters are
fp32 masters (``gpt.init_master_params``), cast to ``cfg.dtype`` at each
use inside the forward.  Gradients come from PyTorch's autograd through
the hand-written kernels' backward functions (flash attention; the fused
loss head under ``PADDLE_TPU_FUSED_CE=1``).  ``accum > 1`` follows the
JAX step exactly: the batch is cut into ``accum`` micro-batches, whose
gradients accumulate in a **bf16** carry as ``carry + (g *
(1/accum)).to(bf16)`` and whose losses sum as ``l * (1/accum)``; the
optimizer receives the bf16 grads.  (A trajectory accumulated in fp32
would not match the JAX one.)  The carry is updated in place, which
saves a copy of the gradient tree per micro-batch.  Each micro-batch
draws its dropout and an MoE model's router noise under its own key
(``rng.fold_in(key, i)``, where the JAX step splits its key over the
micro-batches).  An MoE tree's expert leaves (``blocks["moe"]``,
``router_w`` float32) take the same bf16 carry and the same update; the
aux loss is part of ``gpt.loss_fn``'s value.

**A mesh** (``distributed.topology.Mesh`` with axes ``dp``, ``pp``,
``mp``, ``sp``, ``ep`` and ``sharding``; one process a rank, every rank
calling the step with the same global batch).  Where JAX compiles one
``shard_map``/GSPMD program, each rank here runs its own part:

* the batch splits over ``dp`` in contiguous blocks (JAX's ``P("dp")``);
  at ``accum > 1`` JAX's micro-batch i is rows block i of the global
  batch, so a rank takes its dp part of each block;
* every leaf is stored as the rank's block of ``gpt.param_shardings``
  (stacked blocks split [L] over ``pp``; Megatron's column / row splits
  over ``mp``; ``wte`` split by vocab over ``mp`` on every stage);
* the block is ``gpt._block`` itself; under ``mp`` on the local
  shards (``megatron.TensorParallel``: H/mp heads, F/mp FFN columns, two
  all-reduces a block), the embedding vocab-parallel and the loss the
  vocab-parallel CE (kernels #6 / #7 under ``PADDLE_TPU_FUSED_CE=1``,
  the reference's max / sum / pick otherwise);
* ``sp > 1`` (ring attention, ``ops/ring_attention.py``): each rank
  takes its rows of the sequence — contiguous [r·Tl, (r+1)·Tl), or the
  chunk pair (r, 2R-1-r) under ``sp_zigzag`` — with their own positions
  in ``wpe``, and the block's attention is the ring over the ``sp``
  group (``gpt._block(sp=)``; the kernel route on the card, the plain
  one on the CPU); the dropout and router-noise key is folded by the sp
  rank, so each chunk draws its own;
* MoE (``ep`` splits the experts, ``mp`` their FFN columns; the tokens
  are the same on every ``ep`` rank): ``gpt._block(ep=)`` runs
  ``moe.moe_ffn_manual``.  Where JAX runs one GSPMD program (``pp ==
  sp == 1``) the router logits are all-gathered over ``dp``, so the
  global batch (or global micro-batch) is routed as one set; on the
  pipeline and ring paths each rank routes its own micro-batch and
  sequence chunk, as JAX's ``shard_map`` does.  No leaf's gradient is
  summed over ``ep``: the experts' blocks are each rank's own, and every
  leaf held whole (the router among them) gets its complete gradient on
  each ep rank (``copy_to`` before the dispatch and on the gates);
* ``pp > 1`` runs ``n_micro`` micro-batches through the stages, each
  stage holding its layers (stage 0 the embedding, the last one the
  final norm and the head), activations and their gradients passing
  between neighbours by ``collective.exchange``.  ``schedule="1f1b"``
  is JAX's tick (gpt_hybrid.py:367-538): at tick t stage s runs the
  forward of micro-batch t - s and the backward of t - 2(S-1) + s, then
  one batched exchange each way.  **It keeps each in-flight
  micro-batch's autograd graph** (no recompute: every kernel launches
  once a micro-batch, as on one card), so at most ``min(M, 2S-1)``
  graphs live on stage 0 — flat in M.  ``"fthenb"`` runs every forward,
  then every backward: M graphs live at once.  Micro-batch m draws
  under ``rng.fold_in(key, m)`` and layer l (global index) under
  ``fold_in(that, l)``, so a pipeline step equals the one-card step
  at ``accum = n_micro``;
* the gradients are then made whole: summed over ``pp`` for the leaves
  a stage may not use (``wte``, ``wpe``, ``ln_f_*``; an unused leaf
  gives zeros), left as they are over ``mp`` and ``ep`` (Megatron's pair
  gives every rank the complete gradient of a replicated leaf),
  averaged over ``dp`` and ``sp``.  The returned loss is the mean over
  ``dp`` and ``sp``, summed over ``pp`` (the last stage's head, and each
  stage's MoE aux loss);
* ZeRO (``zero``): stage 1 keeps the optimizer state of each leaf as
  the block of ``fleet.base.zero_shard_spec`` (its ZeRO dim split over
  ``sharding``, or ``dp`` without it), updates that block and
  all-gathers the parameters back; stage 2 also reduce-scatters the
  gradients (over ``dp``); stage 3 also stores the parameters as those
  blocks and all-gathers them at the start of a step;
* the optimizer runs on the blocks (an elementwise update); a
  ``ClipGradByGlobalNorm`` reduces its sums of squares over the axes
  each leaf is split on.  Lamb, Lars and Adafactor, whose per-leaf norms
  and means need the whole leaf, are refused under a layout that splits
  leaves (ROADMAP A2);
* ``accum > 1`` composes with ``pp == sp == 1`` only, as in JAX: the
  same bf16 carry on each rank, averaged over ``dp`` once (in fp32)
  before the update.

The interleaved virtual-stage schedule is not ported yet (ROADMAP A2).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from .. import flags, resolve_device, rng
from . import gpt


class GPTTrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: Any


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _build(pairs):
    out: dict = {}
    for path, v in pairs:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def value_and_grad(loss, params, *args):
    """(loss(params', *args) detached, grads tree) where params' are the
    leaves of ``params`` as fresh autograd leaves (the masters themselves
    are not touched)."""
    pairs = list(_leaves(params))
    leaves = [t.detach().requires_grad_(True) for _, t in pairs]
    value = loss(_build((p, t) for (p, _), t in zip(pairs, leaves)), *args)
    grads = torch.autograd.grad(value, leaves)
    return value.detach(), _build((p, g) for (p, _), g in zip(pairs, grads))


def _accumulate(loss_fn, params, tokens, key, accum, dev):
    """(loss, grads) of one step's batch: one ``value_and_grad``, or
    ``accum`` micro-batches into the bf16 carry."""
    if accum == 1:
        return value_and_grad(loss_fn, params, tokens, key)
    B = tokens.shape[0]
    if B % accum:
        raise ValueError(f"batch size {B} must divide by accum {accum}")
    micro = tokens.reshape((accum, B // accum) + tokens.shape[1:])
    inv = 1.0 / accum
    loss = torch.zeros((), dtype=torch.float32, device=dev)
    grads = {path: torch.zeros_like(t, dtype=torch.bfloat16)
             for path, t in _leaves(params)}
    for i, t in enumerate(micro):
        k = None if key is None else rng.fold_in(key, i)
        l, g = value_and_grad(loss_fn, params, t, k)
        for path, gl in _leaves(g):
            grads[path].add_((gl * inv).to(torch.bfloat16))
        del g
        loss = loss + l * inv
    return loss, _build(grads.items())


def build_gpt_train_step(cfg: gpt.GPTConfig, optimizer, accum: int = 1,
                         device=None, mesh=None, n_micro: int = 1,
                         zero: bool | int = False, schedule: str = "1f1b",
                         sp_zigzag: bool = False):
    """The GPT train step.  Returns (init_fn, step_fn, meta):

    * ``init_fn(seed=0, params=None, opt_state=None) -> GPTTrainState``:
      fp32 master params drawn from ``seed`` on the device (or the whole
      tree ``params`` given — tensors, or ``convert.params_from_jax``'s),
      the optimizer's initial state (or the whole state ``opt_state``
      given, ``convert.opt_state_from_jax``'s), step 0 — on a mesh, each
      cut to this rank's blocks;
    * ``step_fn(state, tokens, key, lr) -> (state, loss)``: tokens
      [B, T + 1] (tensor or array; B divisible by ``accum``, and on a
      mesh by dp and by ``n_micro`` a dp block; T divisible by sp, and
      by 2·sp under ``sp_zigzag``), ``key`` the dropout and
      router-noise key (an int or an int64 tensor on the device,
      ``rng.py``; None: neither), ``lr`` a number, or None for the
      optimizer's own (its scheduler's current value); the loss a 0-d
      fp32 tensor on the device (no host sync);
    * ``meta``: the axis sizes, ``n_micro``, ``accum``, the device; on a
      mesh also the mesh, the schedule, the ZeRO stage, the spec trees
      (``specs``: the parameters' layout; ``param_specs``: as stored;
      ``opt_specs``: the optimizer state's) and ``loss_and_grads(params,
      tokens, key)`` — the step's loss and its whole (synced, not
      ZeRO-cut) gradients on the stored layout of stages 0-2.

    ``sp_zigzag`` lays the sequence over ``sp`` in the zigzag layout
    (rank r holds chunks r and 2R-1-r of 2R), which balances the causal
    ring.  Runs on the card unless ``device="cpu"``; on a mesh, on the
    mesh's device.  See the module docstring for the mesh path and its
    refusals, which raise JAX's exception types."""
    if schedule not in ("1f1b", "fthenb"):
        raise ValueError(f"unknown pipeline schedule {schedule!r}")
    if accum < 1:
        raise ValueError(f"accum {accum} must be >= 1")
    if mesh is not None and mesh.world_size > 1:
        return _build_mesh_step(cfg, optimizer, mesh, accum, n_micro,
                                int(zero), schedule, sp_zigzag)
    dev = mesh.device if mesh is not None else resolve_device(device)

    def init_fn(seed: int = 0, params=None, opt_state=None) -> GPTTrainState:
        params = (gpt.init_master_params(cfg, seed, dev) if params is None
                  else _on(params, dev))
        opt = (optimizer.init_state(params) if opt_state is None
               else _on(opt_state, dev))
        return GPTTrainState(params, opt,
                             torch.zeros((), dtype=torch.int32, device=dev))

    def loss_fn(params, tokens, key):
        return gpt.loss_fn(params, tokens, cfg, key=key)

    def step_fn(state: GPTTrainState, tokens, key, lr):
        tokens = torch.as_tensor(tokens, device=dev).long()
        loss, grads = _accumulate(loss_fn, state.params, tokens, key, accum,
                                  dev)
        step = state.step + 1
        new_p, new_o = optimizer.apply_gradients(
            grads, state.params, state.opt_state, lr=lr, step=step)
        return GPTTrainState(new_p, new_o, step), loss

    meta = dict(dp=1, pp=1, mp=1, sp=1, ep=1, sp_zigzag=False, n_micro=1,
                accum=accum, device=dev)
    return init_fn, step_fn, meta


def _on(tree, dev):
    """A tree of tensors, arrays or tuples of them, on ``dev``."""
    if isinstance(tree, dict):
        return {k: _on(v, dev) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_on(v, dev) for v in tree)
    return torch.as_tensor(tree).to(dev)


_NORM_OPTIMIZERS = ("Lamb", "Lars", "Adafactor")


def _refuse(cfg, mesh, accum, zero_stage):
    """The refusals of the JAX ``build_gpt_train_step``
    (gpt_hybrid.py:579-631, :716-720), with its exception types, and the
    port's own (ROADMAP A2)."""
    pp, mp = mesh.size("pp"), mesh.size("mp")
    sp, ep = mesh.size("sp"), mesh.size("ep")
    if (pp > 1 or sp > 1) and (cfg.pos_embed != "learned"
                               or cfg.norm != "layernorm"
                               or cfg.activation != "gelu"):
        raise NotImplementedError(
            "pos_embed/norm/activation variants (rope/rmsnorm/swiglu) "
            "are implemented on the GSPMD path only; use pp == 1, "
            "sp == 1 (dp/mp/ep shard via GSPMD)")
    if cfg.num_layers % pp:
        raise ValueError(f"num_layers {cfg.num_layers} must divide by pp {pp}")
    if cfg.num_heads % mp or cfg.vocab_size % mp:
        raise ValueError("num_heads and vocab_size must divide by mp")
    if cfg.moe is not None and cfg.moe.num_experts % ep:
        raise ValueError("num_experts must divide by ep")
    if cfg.num_kv_heads is not None and cfg.kv_heads % mp:
        raise ValueError(
            f"num_kv_heads {cfg.kv_heads} must divide by mp {mp} (kv heads "
            f"shard over tensor parallel like q heads)")
    if zero_stage >= 2 and (pp > 1 or sp > 1):
        raise NotImplementedError(
            "ZeRO stage >= 2 composes with the pure-GSPMD path (pp == 1, "
            "sp == 1) only; the manual-collective pipeline computes its own "
            "grad reduction")
    if accum > 1 and (pp > 1 or sp > 1):
        raise ValueError("accum composes with the pure-GSPMD path only "
                         "(pp == 1, sp == 1); the pipeline already "
                         "micro-batches via n_micro")


def _refuse_optimizer(optimizer, split: bool):
    if not split:
        return
    name = type(optimizer).__name__
    if name in _NORM_OPTIMIZERS:
        raise NotImplementedError(
            f"{name} takes norms or means over each whole leaf; under a "
            f"layout that splits leaves (mp, pp or ZeRO) it is not ported "
            f"yet (ROADMAP A2)")
    clip = getattr(optimizer, "_grad_clip", None)
    if clip is not None and type(clip).__name__ not in (
            "ClipGradByGlobalNorm", "ClipGradByValue"):
        raise NotImplementedError(
            f"{type(clip).__name__} under a layout that splits leaves is "
            f"not ported yet (ROADMAP A2); use ClipGradByGlobalNorm")


def _split_axes(spec, mesh) -> tuple:
    """The axes (above size 1) a spec splits its leaf over, in mesh
    order."""
    from ..distributed.topology import axes_of

    return mesh.active(tuple(a for e in (spec or ()) for a in axes_of(e)))


def _build_mesh_step(cfg, optimizer, mesh, accum, n_micro, zero_stage,
                     schedule, sp_zigzag):
    from ..distributed import collective as C
    from ..distributed import megatron as mt
    from ..distributed.fleet.base import zero_dim, zero_shard_spec
    from ..ops.ring_attention import SequenceParallel
    from . import moe

    _refuse(cfg, mesh, accum, zero_stage)
    dev = mesh.device
    S, mp, dp = mesh.size("pp"), mesh.size("mp"), mesh.size("dp")
    R, ep = mesh.size("sp"), mesh.size("ep")
    s = mesh.coord("pp")
    first, last = s == 0, s == S - 1
    mp_ax = "mp" if mp > 1 else None
    pp_ax = "pp" if S > 1 else None
    sp_ax = "sp" if R > 1 else None
    ep_ax = "ep" if ep > 1 else None
    zig = bool(sp_zigzag) and sp_ax is not None
    # JAX's manual-collective path (shard_map): pp or sp; else one GSPMD
    # program over the global batch
    manual = S > 1 or sp_ax is not None
    data = ("dp", "sp")             # the loss and gradients average here
    n_data = dp * R
    zero_axis = "sharding" if mesh.size("sharding") > 1 else "dp"
    zero_on = zero_stage >= 1 and mesh.size(zero_axis) > 1
    shapes = gpt.param_shapes(cfg)
    if mp_ax is None and pp_ax is None and ep_ax is None:
        specs = gpt._per_layer(shapes, lambda shp: ())
    else:
        specs = gpt.param_shardings(cfg, mp=mp_ax, pp=pp_ax, ep=ep_ax)
    paths = [p for p, _ in _leaves(specs)]
    spec_of = dict(_leaves(specs))
    shape_of = dict(_leaves(shapes))
    zspec_of = {p: (zero_shard_spec(spec_of[p], shape_of[p], zero_axis,
                                    mesh) if zero_on else spec_of[p])
                for p in paths}
    zdim_of = {p: zero_dim(spec_of[p], zspec_of[p]) for p in paths}
    split = zero_on and any(d is not None for d in zdim_of.values())
    split = split or any(_split_axes(spec_of[p], mesh) for p in paths)
    _refuse_optimizer(optimizer, split)
    store_of = zspec_of if zero_stage >= 3 else spec_of
    zspecs = _build(zspec_of.items())
    store_specs = _build(store_of.items())
    opt_specs = zspecs if zero_on else specs
    # the axes each leaf's update-time gradient is split on (the clip's
    # reductions): its spec's, and the ZeRO axis where it was cut
    owned_of = {p: mesh.active(_split_axes(spec_of[p], mesh)
                               + ((zero_axis,) if zero_on
                                  and zdim_of[p] is not None else ()))
                for p in paths}
    tp = (mt.TensorParallel(mesh, mp_ax, cfg.num_heads // mp,
                            cfg.kv_heads // mp) if mp_ax else None)
    ring = (SequenceParallel(mesh, "sp", zig, cfg.sp_sub_block)
            if sp_ax else None)
    # MoE routes the global batch's tokens as one set where JAX runs one
    # GSPMD program (the router's logits gathered over dp), each rank's
    # micro-batch and sequence chunk on the manual path, as JAX does
    experts = (moe.ExpertParallel(mesh, ep_ax, mp_ax,
                                  route_axes=() if manual else ("dp",))
               if cfg.moe is not None else None)
    vps = cfg.vocab_size // mp
    L_local = cfg.num_layers // S
    dt = cfg.dtype

    def zslice(t, dim):
        n = mesh.size(zero_axis)
        c = t.shape[dim] // n
        return t.narrow(dim, mesh.coord(zero_axis) * c, c)

    def init_fn(seed: int = 0, params=None, opt_state=None) -> GPTTrainState:
        full = (gpt.init_master_params(cfg, seed, dev) if params is None
                else _on(params, dev))
        local = gpt.shard_params(full, store_specs, mesh)
        if opt_state is None:
            opt = optimizer.init_state(gpt.shard_params(full, opt_specs,
                                                        mesh))
        else:
            ospec = dict(_leaves(opt_specs))
            opt = _build(
                (p, tuple(gpt.shard_leaf(torch.as_tensor(a).to(dev),
                                         ospec[p], mesh) for a in st))
                for p, st in _leaves_to_tuples(opt_state))
        del full
        return GPTTrainState(local, opt,
                             torch.zeros((), dtype=torch.int32, device=dev))

    # -- the sequence: this rank's rows (JAX's seq_chunk / seq_pos) --------
    def seq_len(T):
        """The local rows of a T-token sequence, with JAX's checks."""
        if T % R:
            raise ValueError(f"sequence length {T} must divide by sp {R}")
        Tl = T // R
        if zig and Tl % 2:
            raise ValueError(
                f"zigzag needs an even local sequence chunk (Tl={Tl}: "
                f"T-1 must divide by 2*sp)")
        return Tl

    def seq_rows(Tl):
        """The global positions of this rank's rows: a range (contiguous
        layout), or the chunk pair (rank, 2R-1-rank) under zigzag."""
        r = mesh.coord("sp")
        if not zig:
            return [(r * Tl, Tl)]
        Tc = Tl // 2
        return [(r * Tc, Tc), ((2 * R - 1 - r) * Tc, Tc)]

    def seq(tok, Tl, shift):
        """tok [..., T + 1] -> this rank's inputs (shift 0) or targets
        (shift 1)."""
        return torch.cat([tok[..., a + shift:a + shift + n]
                          for a, n in seq_rows(Tl)], dim=-1)

    # -- the loss pieces on a rank's shards --------------------------------
    def embed(p, tok):
        x = mt.vocab_parallel_embedding(p["wte"], tok, mesh, mp_ax, vps,
                                        dtype=dt)
        if cfg.pos_embed == "learned":
            wpe = torch.cat([p["wpe"][a:a + n]
                             for a, n in seq_rows(tok.shape[1])])
            x = x + wpe.to(dt)[None]
        return x

    def blocks(p, x, key, layer0):
        """The stage's layers -> (x, the summed MoE aux or None).  Layer
        l (global index) draws under fold_in(key, l); under sp the key is
        first folded by the sp rank, so each chunk masks its own rows."""
        blk = gpt._remat_wrap(cfg)
        need_keys = key is not None and (cfg.dropout > 0.0
                                         or cfg.moe is not None)
        if need_keys and sp_ax:
            key = rng.fold_in(key, mesh.coord("sp"))
        per_layer = gpt._per_layer(p["blocks"], lambda t: t.unbind(0))
        aux = None
        for l in range(_layer_count(per_layer)):
            x, a = blk(x, gpt._per_layer(per_layer, lambda ts: ts[l]), cfg,
                       rng.fold_in(key, layer0 + l) if need_keys else None,
                       tp, sp=ring, ep=experts)
            if a is not None:
                aux = a if aux is None else aux + a
        return x, aux

    def head_loss(p, x, tgt):
        x = gpt._norm(x, p, "ln_f", cfg)
        logits = mt.vocab_parallel_logits(x, p["wte"].to(dt), mesh, mp_ax)
        ce = (mt.vocab_parallel_softmax_ce if flags.fused_ce()
              else mt.plain_vocab_parallel_softmax_ce)
        return torch.mean(ce(logits, tgt, mesh, mp_ax, vps))

    def model_loss(p, tokens, key):
        Tl = seq_len(tokens.shape[1] - 1)
        x, aux = blocks(p, embed(p, seq(tokens, Tl, 0)), key, 0)
        loss = head_loss(p, x, seq(tokens, Tl, 1))
        return loss if aux is None else loss + aux

    # -- the pipeline ------------------------------------------------------
    def pipeline(params, tokens, key):
        M = n_micro
        B = tokens.shape[0]
        if B % M:
            raise ValueError(
                f"per-dp-shard batch {B} must be divisible by n_micro {M}")
        b = B // M
        Tl = seq_len(tokens.shape[1] - 1)
        mb = tokens.reshape(M, b, tokens.shape[1])
        pairs = list(_leaves(params))
        leaves = [t.detach().requires_grad_(True) for _, t in pairs]
        p = _build((path, t) for (path, _), t in zip(pairs, leaves))
        act = ((b, Tl, cfg.hidden_size), dt)
        seed = torch.full((), 1.0 / M, dtype=torch.float32, device=dev)
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        inflight = {}
        x_recv = dy_recv = None

        def forward(m, x_in):
            tok = mb[m]
            k = None if key is None else rng.fold_in(key, m)
            x = embed(p, seq(tok, Tl, 0)) if first else x_in
            y, aux = blocks(p, x, k, s * L_local)
            if last:
                y = head_loss(p, y, seq(tok, Tl, 1))
                return (y if aux is None else y + aux), None
            return y, aux

        def backward(m, dy):
            # each stage's MoE aux joins the loss (JAX counts it at the
            # stage's valid ticks and sums over pp)
            nonlocal loss_sum
            x_in, out, aux = inflight.pop(m)
            outs, grads = [], []
            if last:
                loss_sum = loss_sum + out.detach()
                outs.append(out), grads.append(seed)
            else:
                outs.append(out), grads.append(dy)
            if aux is not None:
                loss_sum = loss_sum + aux.detach()
                outs.append(aux), grads.append(seed)
            torch.autograd.backward(outs, grads)
            return None if first else x_in.grad

        def f_slot(t, sends):
            m = t - s
            if 0 <= m < M:
                x_in = None if first else x_recv.requires_grad_(True)
                out, aux = forward(m, x_in)
                inflight[m] = (x_in, out, aux)
                if not last:
                    sends.append((out.detach(), 1))

        def swap(sends, want_x, want_dy):
            nonlocal x_recv, dy_recv
            recvs = ([(act[0], act[1], -1)] if want_x else []) \
                + ([(act[0], act[1], 1)] if want_dy else [])
            got = C.exchange(mesh, "pp", sends, recvs)
            x_recv = got.pop(0) if want_x else None
            dy_recv = got.pop(0) if want_dy else None

        if schedule == "1f1b":
            for t in range(M + 2 * (S - 1)):
                sends = []
                f_slot(t, sends)
                m = t - 2 * (S - 1) + s
                if 0 <= m < M:
                    dx = backward(m, dy_recv)
                    if dx is not None:
                        sends.append((dx, -1))
                swap(sends, not first and 0 <= t + 1 - s < M,
                     not last and 0 <= t + 1 - 2 * (S - 1) + s < M)
        else:
            for t in range(M + S - 1):
                sends = []
                f_slot(t, sends)
                swap(sends, not first and 0 <= t + 1 - s < M, False)
            for t in range(M + S - 1):
                sends = []
                m = t - (S - 1 - s)
                if 0 <= m < M:
                    dx = backward(m, dy_recv)
                    if dx is not None:
                        sends.append((dx, -1))
                swap(sends, False,
                     not last and 0 <= t + 1 - (S - 1 - s) < M)
        grads = _build((path, t.grad if t.grad is not None
                        else torch.zeros_like(t))
                       for (path, _), t in zip(pairs, leaves))
        return loss_sum / M, grads

    # -- the step ----------------------------------------------------------
    def local_loss_and_grads(params, tokens, key):
        tokens = torch.as_tensor(tokens, device=dev).long()
        B = tokens.shape[0]
        if B % dp:
            raise ValueError(f"batch size {B} must divide by dp {dp}")
        d = mesh.coord("dp")
        if accum > 1:
            # JAX's micro-batch i is rows block i of the global batch,
            # split over dp: this rank takes its part of each
            if B % accum or (B // accum) % dp:
                raise ValueError(f"batch size {B} must divide by accum "
                                 f"{accum} x dp {dp}")
            Bm = B // accum // dp
            tokens = tokens.reshape(accum, dp, Bm, tokens.shape[1])[:, d]
            tokens = tokens.reshape(accum * Bm, -1)
        else:
            Bl = B // dp
            tokens = tokens[d * Bl:(d + 1) * Bl]
        if S > 1:
            return pipeline(params, tokens, key)
        return _accumulate(model_loss, params, tokens, key, accum, dev)

    def reduce_loss(loss):
        loss = loss.reshape(1)
        C.all_reduce_(loss, mesh, ("pp",) + data)
        return (loss / n_data if n_data > 1 else loss).reshape(())

    def sync(path, g, cut: bool):
        """Leaf ``path``'s whole gradient: summed over pp where a stage
        may not use the leaf, averaged over dp and sp; with ``cut`` its
        ZeRO block (reduce-scattered over dp at stages 2-3)."""
        zdim = zdim_of[path]
        cut = cut and zero_on and zdim is not None
        axes = () if S == 1 or "pp" in _split_axes(spec_of[path], mesh) \
            else ("pp",)
        low = g.dtype != torch.float32
        g = g.float() if low else g.clone()
        if cut and zero_stage >= 2 and zero_axis == "dp":
            g = C.reduce_scatter(g, mesh, "dp", dim=zdim)
            if axes:
                C.all_reduce_(g, mesh, axes)
        else:
            C.all_reduce_(g, mesh, axes + data)
            if cut:
                g = zslice(g, zdim).contiguous()
        if n_data > 1:
            g = g / n_data
        return g.to(torch.bfloat16) if low else g

    def sum_squares(sq_tree):
        groups: dict = {}
        for path, sq in _leaves(sq_tree):
            groups.setdefault(owned_of[path], []).append(sq)
        total = None
        for axes in sorted(groups):
            part = sum(groups[axes]).reshape(1)
            C.all_reduce_(part, mesh, axes)
            total = part if total is None else total + part
        return total.reshape(())

    def gather_store(params):
        """Stage 3: the parameters on their Megatron layout, all-gathered
        over the ZeRO axis."""
        if zero_stage < 3 or not zero_on:
            return params
        return _build((path, t if zdim_of[path] is None else
                       C.all_gather(t, mesh, zero_axis, dim=zdim_of[path]))
                      for path, t in _leaves(params))

    def loss_and_grads(params, tokens, key):
        loss, grads = local_loss_and_grads(gather_store(params), tokens, key)
        grads = _build((path, sync(path, g, False))
                       for path, g in _leaves(grads))
        return reduce_loss(loss), grads

    def step_fn(state: GPTTrainState, tokens, key, lr):
        whole = gather_store(state.params)
        loss, grads = local_loss_and_grads(whole, tokens, key)
        grads = _build((path, sync(path, g, True))
                       for path, g in _leaves(grads))
        if zero_on and zero_stage < 3:
            blocks_ = _build((path, t if zdim_of[path] is None else
                              zslice(t, zdim_of[path]))
                             for path, t in _leaves(whole))
        else:
            blocks_ = state.params
        step = state.step + 1
        new_b, new_o = optimizer.apply_gradients(
            grads, blocks_, state.opt_state, lr=lr, step=step,
            sum_squares=sum_squares if split else None)
        if zero_on and zero_stage < 3:
            new_b = _build((path, t if zdim_of[path] is None else
                            C.all_gather(t, mesh, zero_axis,
                                         dim=zdim_of[path]))
                           for path, t in _leaves(new_b))
        return GPTTrainState(new_b, new_o, step), reduce_loss(loss)

    meta = dict(dp=dp, pp=S, mp=mp, sp=R, ep=ep, sp_zigzag=zig,
                n_micro=n_micro, accum=accum,
                device=dev, mesh=mesh, schedule=schedule, zero=zero_stage,
                zero_axis=zero_axis if zero_on else None, specs=specs,
                param_specs=store_specs, opt_specs=opt_specs,
                loss_and_grads=loss_and_grads, backend=mesh.backend,
                transport=mesh.transport)
    return init_fn, step_fn, meta


def _layer_count(per_layer) -> int:
    """The number of layers in a tree of per-layer tuples."""
    for v in per_layer.values():
        return _layer_count(v) if isinstance(v, dict) else len(v)
    return 0


def _leaves_to_tuples(tree, path=()):
    """(path, tuple of arrays) of an optimizer-state tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves_to_tuples(v, path + (k,))
    else:
        yield path, tuple(tree)
