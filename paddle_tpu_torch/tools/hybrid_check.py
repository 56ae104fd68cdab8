"""Rank bodies for checking the hybrid-parallel train step.

    from paddle_tpu_torch.distributed import spawn
    from paddle_tpu_torch.tools import hybrid_check as hc
    outs = spawn.spawn(hc.run_cases, (cases,), nprocs=8, device="cpu")

:func:`run_cases` runs on every rank of a process group (``spawn``) a
list of cases, each a dict with a ``kind``:

* ``"train"`` — ``build_gpt_train_step`` over ``mesh`` (an ordered
  {axis: size}) from the whole ``params`` tree (numpy or tensors; or
  ``seed``), ``steps`` steps on ``batches``; returns the losses, the
  gathered final params (rank 0), each step's ms, the peak memory and the
  collectives' calls and bytes, the kernels' launches a step (the
  counters zeroed before the first; tensor-core launches apart), with
  ``profile_last=True`` the last step's device time by family
  (``profiled_step``), with ``saved=True`` the peak bytes the autograd graphs held
  (``SavedBytes``), with ``record_update=True`` the shapes of the
  gradients and the optimizer state the update saw; with
  ``stagger_init=True`` the ranks initialise one at a time;
* ``"grads"`` — the step's ``meta["loss_and_grads"]`` on ``params``:
  the loss and the gathered whole gradients;
* ``"megatron"`` — the tensor-parallel primitives at the mesh's ``mp``
  on whole inputs given: the vocab-parallel embedding, the row-parallel
  linear, the vocab-parallel CE (both routes) and its gradient; and a
  broadcast from the axis' first rank (all-gathered back);
* ``"ring"`` — ring attention over the mesh's ``sp`` on whole q, k, v
  and a cotangent w (numpy, or ``gen``: drawn on the device from a
  seed), each rank its rows of the contiguous or the zigzag layout, for
  each of ``routes``: the output and dq, dk, dv of sum(out · w),
  gathered back to the global row order (rank 0), the kernels' launches
  and tensor-core launches, the forward + backward's ms, and with
  ``largest=True`` the most elements of any tensor an op produced in
  them;
* ``"moe"`` — ``moe.moe_ffn_manual`` on a whole layer of expert
  params, each rank its blocks of ``moe_param_shardings`` over the
  mesh's ``ep`` / ``mp``: y, aux and the gradients of sum(y · w) + aux
  (params gathered back, x).

Optimizers are named (``opt``: [class name, kwargs], ``clip``: a clip
norm for ``ClipGradByGlobalNorm``), so a case pickles.  Nothing here
imports JAX: the children a test spawns stay free of it.  The smoke
(``chip_smoke.py``) drives the same bodies on the card.
"""
from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch
from torch.utils._pytree import tree_leaves
from torch.utils._python_dispatch import TorchDispatchMode

from .. import nn as clip_mod
from .. import optimizer as optim
from ..distributed import collective as C
from ..distributed import env
from ..distributed import megatron as mt
from ..ops import flash_attention as fa
from ..ops import fused_ce as fc
from ..ops import fused_norm as fn
from ..ops import ring_attention as ra
from ..text import gpt, gpt_hybrid, moe

KERNELS = (("flash_attention_fwd", lambda: fa.flash_attention_fwd),
           ("flash_attention_bwd_dq", lambda: fa.flash_attention_bwd_dq),
           ("flash_attention_bwd_dkv", lambda: fa.flash_attention_bwd_dkv),
           ("fused_ce_fwd", lambda: fc.ce_fwd),
           ("fused_ce_bwd", lambda: fc.ce_bwd),
           ("fused_layer_norm_fwd", lambda: fn.ln_fwd),
           ("fused_layer_norm_bwd", lambda: fn.ln_bwd))


def launch_counts() -> dict:
    return {name: get().launches for name, get in KERNELS}


def tc_counts() -> dict:
    """Launches on the tensor-core bodies (the flash kernels)."""
    return {name: get().tc_launches for name, get in KERNELS
            if hasattr(get(), "tc_launches")}


def zero_counts():
    for _, get in KERNELS:
        get().launches = 0
        if hasattr(get(), "tc_launches"):
            get().tc_launches = 0


# device-time families of a profiled step: the collectives' kernels and
# the staging copies before the port's own (profile_train.FAMILIES)
COMM_FAMILIES = (("collective", ("nccl",)), ("memcpy", ("memcpy",)))


def profiled_step(fn, dev):
    """Run ``fn()`` under ``torch.profiler`` and return (its result, the
    device ms by family — ``COMM_FAMILIES`` then the train step's — the
    collectives' share of the device time, the wall ms)."""
    from torch.profiler import ProfilerActivity, profile

    from . import profile_serving, profile_train

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    _sync(dev)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fn()
        _sync(dev)
        wall = time.perf_counter() - t0
    fams = COMM_FAMILIES + profile_train.FAMILIES
    summ = profile_serving.summarize(torch, prof, wall, 1, fams)
    by = summ["device_ms_by_family"]
    dev_ms = summ["device_ms"] or 0.0
    summ["collective_share"] = (by.get("collective", 0.0) / dev_ms
                                if dev_ms else None)
    return out, summ


def expected_hybrid_launches(cfg, mesh_shape, n_micro=1, accum=1,
                             stage=0, fused_ln=True, fused_ce=True,
                             sp_rank=0, zigzag=False) -> dict:
    """Kernels #1-#7 launched by one rank in one step: per micro-batch,
    a flash forward, dq and dk/dv for each of the stage's layers (its
    graph is kept, so nothing is recomputed; remat's checkpoint adds each
    block's flash and two LN forwards again) — under sp the ring's kernel
    route, ``ring_attention.launches`` of each at sp rank ``sp_rank``;
    the CE forward and backward once on the stage holding the head; every
    LayerNorm of the stage (two a block, the final one with the head)
    forward and backward once."""
    S = int(mesh_shape.get("pp", 1))
    R = int(mesh_shape.get("sp", 1))
    M = n_micro if S > 1 else accum
    L = cfg.num_layers // S
    head = int(stage == S - 1)
    again = int(bool(cfg.remat))
    ln = int(fused_ln and cfg.norm == "layernorm")
    ce = int(fused_ce)
    fl = (ra.launches("zigzag" if zigzag else "causal", R, sp_rank)
          if R > 1 else 1)
    return {"flash_attention_fwd": L * M * fl * (1 + again),
            "flash_attention_bwd_dq": L * M * fl,
            "flash_attention_bwd_dkv": L * M * fl,
            "fused_ce_fwd": head * M * ce, "fused_ce_bwd": head * M * ce,
            "fused_layer_norm_fwd": ((2 * L + head) + 2 * L * again) * M * ln,
            "fused_layer_norm_bwd": (2 * L + head) * M * ln}


class _Held:
    __slots__ = ("owner", "n")

    def __init__(self, owner, n):
        self.owner, self.n = owner, n
        owner.live += n
        owner.peak = max(owner.peak, owner.live)

    def __del__(self):
        self.owner.live -= self.n


class SavedBytes:
    """The bytes autograd graphs hold for their backward, counted with
    ``torch.autograd.graph.saved_tensors_hooks``: each packed tensor adds
    its bytes while its graph lives; ``peak`` is the most at once."""

    def __init__(self):
        self.live = self.peak = 0

    @contextlib.contextmanager
    def hooks(self):
        def pack(t):
            return t, _Held(self, t.numel() * t.element_size())

        def unpack(packed):
            return packed[0]

        with torch.autograd.graph.saved_tensors_hooks(pack, unpack):
            yield self


def make_optimizer(spec, clip=None):
    name, kw = spec
    if clip is not None:
        kw = dict(kw, grad_clip=clip_mod.ClipGradByGlobalNorm(clip))
    return getattr(optim, name)(**kw)


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.detach().float().cpu().numpy()


@contextlib.contextmanager
def _flags(values):
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _release(dev):
    """Return this process's cached card memory (ranks may share a
    card)."""
    import gc

    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _barrier(mesh):
    C.all_reduce_(torch.zeros(1, device=mesh.device), mesh, mesh.names)


def _train(case, mesh):
    cfg = case["cfg"]
    opt = make_optimizer(case.get("opt", ("AdamW", {"learning_rate": 1e-3})),
                         case.get("clip"))
    init_fn, step_fn, meta = gpt_hybrid.build_gpt_train_step(
        cfg, opt, mesh=mesh, **case.get("kw", {}))
    dev = mesh.device

    def init():
        return init_fn(case.get("seed", 0), params=case.get("params"),
                       opt_state=case.get("opt_state"))

    if case.get("stagger_init"):
        # one rank at a time: the whole masters a rank draws before it
        # cuts its blocks never sit on a shared card four times at once
        state = None
        for r in range(mesh.world_size):
            if r == mesh.rank:
                state = init()
                _release(dev)
            _barrier(mesh)
    else:
        state = init()
    seen = {}
    if case.get("record_update"):
        apply = opt.apply_gradients

        def recording(grads, params, st, **kw):
            seen["grads"] = {".".join(p): tuple(g.shape)
                             for p, g in gpt_hybrid._leaves(grads)}
            seen["state"] = {".".join(p): [tuple(a.shape) for a in s]
                             for p, s in gpt_hybrid._leaves_to_tuples(st)}
            return apply(grads, params, st, **kw)

        opt.apply_gradients = recording
    saved = SavedBytes()
    batches = case["batches"]
    steps = case.get("steps", len(batches))
    losses, ms, launches, tcs, comm = [], [], [], [], []
    profile = None
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    for i in range(steps):
        toks = torch.as_tensor(np.asarray(batches[i % len(batches)]),
                               device=dev)
        before, before_tc = launch_counts(), tc_counts()
        C.reset_stats()
        _sync(dev)

        def one():
            with (saved.hooks() if case.get("saved") else
                  contextlib.nullcontext()):
                return step_fn(state, toks, case.get("key"),
                               case.get("lr", 1e-3))

        t0 = time.perf_counter()
        if case.get("profile_last") and i == steps - 1:
            (state, loss), profile = profiled_step(one, dev)
        else:
            state, loss = one()
        losses.append(loss.item())
        _sync(dev)
        ms.append(1e3 * (time.perf_counter() - t0))
        launches.append({k: v - before[k]
                         for k, v in launch_counts().items()})
        tcs.append({k: v - before_tc[k] for k, v in tc_counts().items()})
        comm.append(C.stats())
    out = {"losses": losses, "step_ms": ms, "launches": launches,
           "tc_launches": tcs, "profile": profile,
           "comm": comm, "rank": mesh.rank, "coords": dict(mesh.coords),
           "saved_peak": saved.peak, "update": seen,
           "peak_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                       if dev.type == "cuda" else None),
           "meta": {k: meta[k] for k in ("dp", "pp", "mp", "sp", "ep",
                                         "sp_zigzag", "n_micro",
                                         "accum", "schedule", "zero",
                                         "backend", "transport")},
           "local_shapes": {".".join(p): tuple(t.shape) for p, t in
                            gpt_hybrid._leaves(state.params)}}
    if case.get("gather", True):
        full = gpt.gather_params(state.params, meta["param_specs"], mesh)
        out["params"] = _numpy(full) if mesh.rank == 0 else None
    return out


def _grads(case, mesh):
    cfg = case["cfg"]
    opt = make_optimizer(("AdamW", {"learning_rate": 1e-3}))
    init_fn, _, meta = gpt_hybrid.build_gpt_train_step(
        cfg, opt, mesh=mesh, **case.get("kw", {}))
    state = init_fn(params=case["params"])
    toks = torch.as_tensor(np.asarray(case["tokens"]), device=mesh.device)
    loss, grads = meta["loss_and_grads"](state.params, toks,
                                         case.get("key"))
    full = gpt.gather_params(grads, meta["specs"], mesh)
    return {"loss": loss.item(),
            "grads": _numpy(full) if mesh.rank == 0 else None}


def _megatron(case, mesh):
    """The primitives on whole inputs cut to this rank's blocks; the
    outputs and gradients come back whole (rank 0)."""
    dev = mesh.device
    ax = "mp"
    n, i = mesh.size(ax), mesh.coord(ax)

    def block(a, dim):
        t = torch.as_tensor(a, device=dev)
        c = t.shape[dim] // n
        return t.narrow(dim, i * c, c).contiguous()

    if (env.get_rank(), env.get_world_size(), env.axis_size(ax)) != (
            mesh.rank, mesh.world_size, n):
        raise AssertionError("env and the mesh disagree")
    out = {}
    # broadcast from mp index 0: every rank ends with rank 0's tensor
    b = C.broadcast_(torch.full((3,), float(mesh.rank), device=dev), mesh,
                     ax)
    out["broadcast"] = C.all_gather(b, mesh, ax)
    wte, tok = case["wte"], torch.as_tensor(case["tokens"], device=dev)
    V = np.asarray(wte).shape[0]
    out["embedding"] = mt.vocab_parallel_embedding(
        block(wte, 0), tok, mesh, ax, V // n)
    x, w, b = case["x"], case["w"], case["b"]
    out["row_parallel"] = mt.row_parallel_linear(
        block(x, -1), block(w, 0), torch.as_tensor(b, device=dev), mesh, ax)
    logits = torch.as_tensor(case["logits"], device=dev)
    tgt = torch.as_tensor(case["targets"], device=dev)
    Vl = logits.shape[-1]
    for name, fn_ in (("ce_kernel", mt.vocab_parallel_softmax_ce),
                      ("ce_plain", mt.plain_vocab_parallel_softmax_ce)):
        lg = block(logits, -1).requires_grad_(True)
        loss = fn_(lg, tgt, mesh, ax, Vl // n)
        torch.mean(loss).backward()
        out[name] = loss.detach()
        out[name + "_grad"] = C.all_gather(lg.grad, mesh, ax, dim=-1)
    return {k: v.float().cpu().numpy() for k, v in out.items()} \
        if mesh.rank == 0 else None


def _global_rows(T, R, r, zigzag):
    """The global rows of rank ``r``'s chunk of a T-row sequence."""
    if not zigzag:
        Tl = T // R
        return list(range(r * Tl, (r + 1) * Tl))
    Tc = T // (2 * R)
    return (list(range(r * Tc, (r + 1) * Tc))
            + list(range((2 * R - 1 - r) * Tc, (2 * R - r) * Tc)))


def _ring_inputs(case, dev):
    if "gen" in case:
        B, T, H, Hkv, D, seed = case["gen"]
        g = torch.Generator(device=dev).manual_seed(seed)
        dt = getattr(torch, case.get("dtype", "bfloat16"))

        def draw(h):
            return torch.randn(B, T, h, D, generator=g, device=dev).to(dt)

        return draw(H), draw(Hkv), draw(Hkv), draw(H)
    return tuple(torch.as_tensor(np.asarray(case[n]), device=dev)
                 for n in ("q", "k", "v", "w"))


class _Largest(TorchDispatchMode):
    """The most elements of any tensor an op produced under it."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.n = max(self.n, t.numel())
        return out


def _ring(case, mesh):
    dev = mesh.device
    R, r = mesh.size("sp"), mesh.coord("sp")
    zig = case.get("zigzag", False)
    q, k, v, w = _ring_inputs(case, dev)
    ids = torch.tensor(_global_rows(q.shape[1], R, r, zig), device=dev)
    order = torch.argsort(C.all_gather(ids, mesh, "sp"))
    ql, kl, vl, wl = (t[:, ids].contiguous() for t in (q, k, v, w))
    del q, k, v, w
    out = {}
    for route in case.get("routes", ("plain",)):
        qq, kk, vv = (t.clone().requires_grad_(True) for t in (ql, kl, vl))
        before, before_tc = launch_counts(), tc_counts()
        _sync(dev)
        t0 = time.perf_counter()
        largest = _Largest()
        with (largest if case.get("largest") else contextlib.nullcontext()):
            if zig:
                o = ra.ring_attention_zigzag(qq, kk, vv, mesh, "sp",
                                             sub_block=case.get("sub_block"),
                                             route=route)
            else:
                o = ra.ring_attention(qq, kk, vv, mesh, "sp",
                                      causal=case.get("causal", True),
                                      sub_block=case.get("sub_block"),
                                      route=route)
            (o.float() * wl.float()).sum().backward()
        _sync(dev)
        ms = 1e3 * (time.perf_counter() - t0)
        res = {"ms": ms, "largest": largest.n,
               "launches": {k_: v_ - before[k_]
                            for k_, v_ in launch_counts().items()
                            if k_.startswith("flash")},
               "tc_launches": {k_: v_ - before_tc[k_]
                               for k_, v_ in tc_counts().items()}}
        for name, t in (("out", o), ("dq", qq.grad), ("dk", kk.grad),
                        ("dv", vv.grad)):
            full = C.all_gather(t.detach().contiguous(), mesh, "sp", dim=1)
            res[name] = (full[:, order].float().cpu().numpy()
                         if mesh.rank == 0 else None)
        out[route] = res
    return out


def _moe(case, mesh):
    dev = mesh.device
    cfg = case["moe_cfg"]
    ep_ax = "ep" if mesh.size("ep") > 1 else None
    mp_ax = "mp" if mesh.size("mp") > 1 else None
    specs = moe.moe_param_shardings(ep=ep_ax, mp=mp_ax)
    whole = {n: torch.as_tensor(np.asarray(a), device=dev)
             for n, a in case["params"].items()}
    p = {n: gpt.shard_leaf(t, specs[n], mesh).requires_grad_(True)
         for n, t in whole.items()}
    x = torch.as_tensor(np.asarray(case["x"]), device=dev) \
        .requires_grad_(True)
    w = torch.as_tensor(np.asarray(case["w"]), device=dev)
    y, aux = moe.moe_ffn_manual(p, x, cfg, mesh, ep_ax, mp_ax,
                                route_axes=case.get("route_axes", ()))
    ((y * w).sum() + aux).backward()
    grads = {n: gpt.gather_leaf(t.grad, specs[n], mesh) for n, t in p.items()}
    if mesh.rank != 0:
        return None
    return {"y": y.detach().cpu().numpy(), "aux": aux.item(),
            "dx": x.grad.cpu().numpy(),
            "grads": {n: g.cpu().numpy() for n, g in grads.items()}}


_KINDS = {"train": _train, "grads": _grads, "megatron": _megatron,
          "ring": _ring, "moe": _moe}


def run_cases(cases):
    """Each case on this rank (see the module docstring), each over a
    mesh of its own on this process group; returns the results in
    order."""
    results = []
    for case in cases:
        mesh = env.init_parallel_env(case["mesh"],
                                     device=case.get("device"))
        with _flags(case.get("flags", {})):
            results.append(_KINDS[case["kind"]](case, mesh))
        _release(mesh.device)
    return results
