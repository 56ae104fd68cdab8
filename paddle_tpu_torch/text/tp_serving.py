"""Tensor- and expert-parallel serving: a model's weights and KV cache
split over the ranks of a ``distributed.serving_mesh.ServingMesh``.

Counterpart of the JAX package's ``mesh=`` serving path — there one
process runs each step ``jax.jit``-ed under the Megatron shardings
(``generate._decode_param_specs``, ``sharded_cache_specs``,
``engine._ShardCtx``) and XLA inserts the collectives.  Here each rank is
a process holding its block of every leaf, and the process that owns the
server (one controller: the scheduler, the paged allocator, admission,
the ladders, a fleet's router) drives them:

* **The weights** are cut on the host and each rank is sent only its
  block (:class:`ShardedParams`).  Placements follow the JAX specs with
  the changes a rank's own arithmetic needs (:func:`local_specs`): a
  quantization scale is cut along its weight's split dims (JAX replicates
  it and reshards at the product); a row-split int4 weight is unpacked,
  cut to its contiguous rows and packed again (the half-split byte layout
  puts rows i and i + K/2 in one byte, so its packed rows are not a row
  block), its group scales cut with it — K/mp must stay a multiple of
  the group size; where ``mp`` does not divide the kv heads, ``kv_w`` /
  ``kv_b`` are whole on every rank, which projects all Hkv heads and
  keeps the whole cache (``sharded_cache_specs``' rule), its query heads
  reading the ones they need (``tp_context.kv_view``).
* **A binding** (:class:`ShardedBinding`) is a server's cache — each
  rank's Hkv/mp heads, allocated there — with its weights, the MoE
  routing accumulator (whole on every rank: the routing is joint and
  identical everywhere; the host reads the first rank's) and the rank's
  ``engine.Binding``, so each rank captures and replays its own graphs
  (NCCL: collectives inside the graph) or runs its steps eagerly (gloo:
  one card shared, or the CPU — gloo's staged copies cannot be
  captured).  The controller sees handles (:class:`ShardedTensor`: the
  global shape, the spec, ``shard_shape()``, ``fetch()``).
* **A step** is the Engine's kind run on every rank: the controller's
  ``Engine.get`` returns a :class:`_Remote`, whose call sends the kind's
  feeds (bytes, never pickled tensors) to each rank, every rank runs the
  same step under its ``tp_context.DecodeShard`` and the first rank
  sends back the outputs — logits all-gathered to the whole vocabulary,
  so the host samples what one card would.  Ranks replay the same kinds
  in the same order: the pipe orders them.

On the CPU every rank runs the plain twins; on the cards the kernels,
each at its rank's local shapes (#1 at H/mp heads, #8 on the int4
shards, #9 / #10 on Hkv/mp cache heads).
"""
from __future__ import annotations

import dataclasses
import os
import time
import weakref

import torch

from ..distributed.topology import Mesh
from . import gpt, tp_context, woq

_MOD = "paddle_tpu_torch.text.tp_serving"


# -- placements --------------------------------------------------------------


def _flat(tree, prefix=""):
    out = []
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.extend(_flat(v, name))
        else:
            out.append((name, v))
    return out


def _get(tree, path: str):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def _put(tree: dict, path: str, v) -> None:
    *head, last = path.split("/")
    for k in head:
        tree = tree.setdefault(k, {})
    tree[last] = v


def local_specs(params, cfg: gpt.GPTConfig, pspecs, mesh, mp: str) -> dict:
    """{leaf path: spec} of what each rank holds (module note): the JAX
    specs ``pspecs`` with scales, LoRA pairs and int4 row blocks placed
    by their weight, whole ``kv_w`` / ``kv_b`` where ``mp`` does not
    divide the kv heads and a whole ``wte`` where it does not divide the
    vocabulary.  A spec here always has one entry a dim."""
    n = mesh.size(mp)
    flat = dict(_flat(params))
    specs = dict(_flat(pspecs))
    out = {}
    for name, t in flat.items():
        spec = tuple(specs[name]) + (None,) * (t.dim() - len(specs[name]))
        base = name.rsplit("/", 1)[-1]
        if base in ("kv_w", "kv_b") and cfg.kv_heads % n:
            spec = (None,) * t.dim()
        if name == "wte" and cfg.vocab_size % n:
            spec = (None,) * t.dim()
        out[name] = spec
    for name, t in flat.items():
        for suffix in ("_s", "_lora_a", "_lora_b"):
            if not name.endswith(suffix) or name[:-len(suffix)] not in out:
                continue
            w = out[name[:-len(suffix)]]
            if suffix == "_lora_a":             # [.., in, r]
                out[name] = w[:-1] + (None,)
            elif suffix == "_lora_b":           # [.., r, out]
                out[name] = w[:-2] + (None, w[-1])
            elif t.dim() == len(w) + 1:         # int4 groups [.., G, 1, out]
                out[name] = w[:-1] + (None, w[-1])
            elif name == "wte_s":               # per-row [V, 1]
                out[name] = (w[0], None)
            else:                               # per-channel [.., 1, out]
                out[name] = w[:-2] + (None, w[-1])
    return out


def _packed_rows_split(flat, name, spec) -> bool:
    """A packed int4 weight whose input (row) dim is split."""
    t = flat[name]
    s = flat.get(name + "_s")
    return (woq._packed(t, s) and spec[-2] is not None)


def _narrow(t, spec, mesh_r, name: str):
    """The block of ``t`` that ``mesh_r``'s rank holds under ``spec``
    (a view)."""
    for d, e in enumerate(spec):
        c = mesh_r.size(e)
        if c == 1:
            continue
        if t.shape[d] % c:
            raise ValueError(f"{name}: dim {d} of {tuple(t.shape)} does not "
                             f"split over {e} ({c} ranks)")
        size = t.shape[d] // c
        t = t.narrow(d, mesh_r.index(e) * size, size)
    return t


def cut(flat: dict, specs: dict, mesh_r) -> dict:
    """{path: this rank's block} of the whole leaves ``flat`` under
    ``specs``, for the rank whose coordinates ``mesh_r`` (a
    ``topology.Mesh``) names — host tensors.  A row-split packed int4
    weight is unpacked, cut and packed again (module note)."""
    from ..ops.woq_matmul import unpack_int4

    out = {}
    for name, t in flat.items():
        spec = specs[name]
        t = torch.as_tensor(t)
        if _packed_rows_split(flat, name, spec):
            G = flat[name + "_s"].shape[-3]
            blk = _narrow(unpack_int4(t), spec, mesh_r, name)
            if G % mesh_r.size(spec[-2]) or blk.shape[-2] % 2:
                raise ValueError(f"{name}: {G} int4 row groups do not split "
                                 f"over {spec[-2]} in whole, even groups")
            out[name] = woq.pack_int4_halves(blk).cpu()
        else:
            out[name] = _narrow(t, spec, mesh_r, name).detach().to(
                "cpu", copy=True).contiguous()
    return out


def _block_shape(shape, spec, mesh) -> tuple:
    return tuple(s // mesh.size(e) for s, e in zip(shape, spec))


# -- the controller's handles -----------------------------------------------


class ShardedTensor:
    """A leaf of a sharded tree as the controller sees it: the whole
    ``shape`` and ``dtype``, the ``spec`` of each rank's block, and the
    rank-side ``owner`` (a binding or a params set) holding it.
    ``shard_shape()`` is a rank's block shape (JAX's
    ``sharding.shard_shape``); ``fetch()`` assembles the whole tensor on
    the host (a replicated leaf: the first rank's copy); ``copy_(src)``
    writes a replicated leaf on every rank in place (the block tables'
    push)."""

    def __init__(self, mesh, owner, path: str, shape, dtype, spec,
                 local_shape=None):
        self.mesh, self.owner, self.path = mesh, owner, path
        self.params = None      # a params leaf's ShardedParams
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.spec = tuple(spec) + (None,) * (len(shape) - len(spec))
        self._local = (tuple(local_shape) if local_shape is not None
                       else _block_shape(shape, self.spec, mesh))
        self.device = torch.device("meta")

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def shard_shape(self) -> tuple:
        return self._local

    @property
    def replicated(self) -> bool:
        return self._local == tuple(self.shape)

    def fetch(self) -> torch.Tensor:
        pool = self.mesh.pool
        ranks = [0] if self.replicated else self.mesh.members
        blocks = pool.call(ranks, f"{_MOD}:rank_fetch", self.owner,
                           self.path)
        if self.replicated:
            return _from_wire(blocks[0])
        out = torch.empty(self.shape, dtype=self.dtype)
        for r, b in zip(ranks, blocks):
            _narrow(out, self.spec, Mesh(self.mesh.shape, r),
                    self.path).copy_(_from_wire(b))
        return out

    def copy_(self, src, non_blocking: bool = False):
        if not self.replicated:
            raise ValueError(f"{self.path}: only a replicated leaf is "
                             f"written whole")
        src = torch.as_tensor(src).to(self.dtype).reshape(self.shape)
        self.mesh.pool.write(self.mesh.members, f"{_MOD}:rank_write",
                             (self.owner, self.path), [src])
        return self

    def __repr__(self):
        return (f"ShardedTensor({self.path}, {tuple(self.shape)}, "
                f"{self.dtype}, spec={self.spec}, "
                f"shard={self._local})")


def _to_wire(t):
    from ..distributed.serving_mesh import _tensor_bytes

    return (str(t.dtype).split(".", 1)[1], tuple(t.shape),
            bytes(_tensor_bytes(t)))


def _from_wire(w):
    dtype, shape, raw = w
    dt = getattr(torch, dtype)
    if not raw:
        return torch.empty(shape, dtype=dt)
    return torch.frombuffer(bytearray(raw), dtype=torch.uint8).view(dt) \
        .reshape(shape).clone()


def _handles(mesh, owner, flat_shapes: dict, specs: dict) -> dict:
    tree: dict = {}
    for name, (shape, dtype, local) in flat_shapes.items():
        _put(tree, name, ShardedTensor(mesh, owner, name, shape, dtype,
                                       specs[name], local))
    return tree


def _env() -> dict:
    """The routing flags a rank's steps read (``flags.py``), as set in the
    controlling process."""
    return {k: v for k, v in os.environ.items()
            if k.startswith("PADDLE_TPU_")}


class ShardedParams:
    """A parameter tree cut over a mesh (module note): each member rank
    holds its blocks under ``("params", pid)``; ``tree`` mirrors the
    params with :class:`ShardedTensor` handles (each holding this object,
    which lives while any handle does); ``specs`` the local specs by
    path.  A server given ``tree`` as its params reuses the blocks on the
    ranks (:func:`shard_params`)."""

    def __init__(self, params, cfg, mesh, pspecs, mp: str, ep=None):
        self.mesh, self.cfg, self.mp, self.ep = mesh, cfg, mp, ep
        self.pid = mesh.pool.new_id()
        flat = dict(_flat(params))
        self.specs = local_specs(params, cfg, pspecs, mesh, mp)
        shapes = {}
        pool = mesh.pool
        for r in mesh.members:
            blocks = cut(flat, self.specs, Mesh(mesh.shape, r))
            for name, b in blocks.items():
                pool.upload(r, ("p", self.pid, name), b)
                if r == 0:
                    shapes[name] = (tuple(flat[name].shape),
                                    flat[name].dtype, tuple(b.shape))
            del blocks
        pool.call(mesh.members, f"{_MOD}:rank_params", self.pid,
                  list(flat))
        self.tree = _handles(mesh, ("params", self.pid), shapes, self.specs)
        for _, h in _flat(self.tree):
            h.params = self
        self._gc = weakref.finalize(self, pool.defer, f"{_MOD}:rank_drop",
                                    ("params", self.pid))

    @staticmethod
    def of(tree):
        """The :class:`ShardedParams` a handle tree came from, or None for
        a tree of tensors."""
        return getattr(tree.get("wte"), "params", None)

    def release(self) -> None:
        """Drop the blocks on every rank (at collection, if not before)."""
        _release_now(self.mesh.pool, self._gc, ("params", self.pid))


def shard_params(params, cfg, mesh, mp: str = "mp", ep=None) -> dict:
    """``params`` cut over ``mesh`` once, as a tensor-parallel server cuts
    them (the JAX specs: ``generate._decode_param_specs``, or
    ``moe_serving.moe_decode_param_specs`` on an MoE config): the handle
    tree, which any number of servers on ``mesh`` with the same ``cfg``
    and axes take as their params without another upload."""
    from . import generate, moe_serving

    if cfg.moe is not None:
        pspecs = moe_serving.moe_decode_param_specs(params, cfg, mp=mp,
                                                    ep=ep)
    else:
        pspecs = generate._decode_param_specs(params, cfg, mp)
    return ShardedParams(params, cfg, mesh, pspecs, mp, ep).tree


class ShardedBinding:
    """A server's binding on a mesh (module note): a KV cache made on
    each rank from the global geometry (``layout``, ``batch``,
    ``max_len``, ``block_size``, ``num_blocks``; its Hkv axis split per
    ``shard.cache``), bound with ``params`` (:class:`ShardedParams`) and,
    on an MoE config, a routing accumulator.  ``share_tables``: another
    binding whose ``tables`` leaf this cache reads (a draft's pool).
    ``cache`` / ``stats`` are handle dicts; ``key`` joins every step key
    (the shard context's fingerprint and this binding's id)."""

    def __init__(self, shard, params: ShardedParams, cache_template: dict,
                 layout: str, batch: int, max_len: int, block_size=None,
                 num_blocks=None, share_tables=None, graphs: bool = True,
                 adapters=None):
        self.shard, self.params = shard, params
        self.mesh = params.mesh
        self.cfg = params.cfg
        self.bid = self.mesh.pool.new_id()
        pool = self.mesh.pool
        E = self.cfg.moe.num_experts if self.cfg.moe is not None else 0
        # graphs only where the collectives can be captured (NCCL)
        self.rank_graphs = bool(graphs) and self.mesh.transport == "nccl"
        # an adapter pool's stacks: each rank its blocks, a register's new
        # row written there too (AdapterPool._mirrors)
        self.stack_specs = {}
        if adapters is not None:
            for leaf in adapters.stacks():
                w = params.specs["blocks/" + leaf.rsplit("_lora_", 1)[0]]
                self.stack_specs[leaf] = (
                    (None,) + w[:-1] + (None,) if leaf.endswith("_lora_a")
                    else (None,) + w[:-2] + (None, w[-1]))
            for r in self.mesh.members:
                for leaf, b in cut(adapters.stacks(), self.stack_specs,
                                   Mesh(self.mesh.shape, r)).items():
                    pool.upload(r, ("a", self.bid, leaf), b)
        local = pool.call(
            self.mesh.members, f"{_MOD}:rank_bind", self.mesh.mid, self.bid,
            params.pid, self.cfg, params.mp, params.ep, layout, int(batch),
            int(max_len), block_size, num_blocks,
            share_tables.bid if share_tables is not None else None,
            self.rank_graphs, E, list(self.stack_specs), _env())[0]
        if adapters is not None:
            adapters._mirrors.add(self)
        cspecs = shard.cache
        shapes = {n: (tuple(t.shape), t.dtype, local[n])
                  for n, t in cache_template.items()}
        self.cache = _handles(self.mesh, ("bind", self.bid), shapes,
                              {n: cspecs[n] for n in shapes})
        for n, h in self.cache.items():
            if h.shard_shape() != _block_shape(h.shape, h.spec, self.mesh):
                raise AssertionError(f"{n}: rank block {h.shard_shape()} "
                                     f"!= its spec's")
        self.stats = None
        if E:
            self.stats = {
                "dropped": ShardedTensor(self.mesh, ("bind", self.bid),
                                         "stats/dropped", (), torch.int32,
                                         ()),
                "load": ShardedTensor(self.mesh, ("bind", self.bid),
                                      "stats/load", (E,), torch.int32,
                                      (None,))}
        self.key = (shard.key, self.bid)
        self._gc = weakref.finalize(self, pool.defer, f"{_MOD}:rank_drop",
                                    ("bind", self.bid))

    def step(self, kind: str, spec, name: str, key):
        """The Engine's entry for ``kind`` at ``spec`` on this binding."""
        return _Remote(self, kind, spec, name, key)

    def adapter_row(self, i: int, rows: dict) -> None:
        """Write adapter row ``i`` (whole leaves [..]) as each rank's
        blocks of its stacks."""
        if self._gc.alive is False or self.mesh.pool.broken is not None:
            return
        specs = {leaf: s[1:] for leaf, s in self.stack_specs.items()}
        for r in self.mesh.members:
            blocks = cut(rows, specs, Mesh(self.mesh.shape, r))
            self.mesh.pool.write([r], f"{_MOD}:rank_adapter_row",
                                 (self.bid, i, list(blocks)),
                                 list(blocks.values()))

    def counts(self) -> list:
        """Each rank's kernel-wrapper launch counters ({"wrapper.attr": n})."""
        return self.mesh.pool.call(self.mesh.members, f"{_MOD}:rank_counts")

    def release(self) -> None:
        """Drop this binding's steps, graphs and cache on every rank (at
        collection, if not before)."""
        _release_now(self.mesh.pool, self._gc, ("bind", self.bid))


def _release_now(pool, gc, owner) -> None:
    if gc.detach() is not None and pool.broken is None:
        pool.call(range(pool.world), f"{_MOD}:rank_drop", owner)


_SPEC_FIELDS = ("paged", "bucket", "width", "k", "extra", "shape", "pkey")


class _Remote:
    """One step kind of a :class:`ShardedBinding`: registered on every rank
    at its first call (each rank's ``Engine.get`` builds, and on NCCL
    captures, its own), then one step frame a call — the feeds' bytes to
    every rank, the outputs' bytes back from the first.  The first call is
    the build the recompile watch records."""

    def __init__(self, bind: ShardedBinding, kind: str, spec, name: str,
                 key):
        self.bind, self.kind, self.name, self.key = bind, kind, name, key
        self.spec_kw = {f: getattr(spec, f) for f in _SPEC_FIELDS}
        self.sid = None

    def __call__(self, *feeds):
        b = self.bind
        pool = b.mesh.pool
        feeds = [torch.as_tensor(f) for f in feeds]
        if self.sid is None:
            t0 = time.perf_counter()
            sid = pool.new_id()
            pool.call(b.mesh.members, f"{_MOD}:rank_reg", sid, b.bid,
                      self.kind, self.spec_kw, _env())
            self.sid = sid
            outs = pool.step(b.mesh.members, f"{_MOD}:rank_run", (sid,),
                             feeds)
            from . import engine

            engine._record_build(self.name, self.key,
                                 time.perf_counter() - t0)
            return tuple(outs)
        return tuple(pool.step(b.mesh.members, f"{_MOD}:rank_run",
                               (self.sid,), feeds))


# -- the rank side -------------------------------------------------------------


@dataclasses.dataclass
class _RankBind:
    cfg: object
    ctx: tp_context.DecodeShard
    bind: object            # engine.Binding
    pid: int


def _apply_env(state, env: dict) -> None:
    """Make this rank's flag environment the controller's ``env`` (the
    flags a step reads at its build or at each call)."""
    if env == state.objects.get("env"):
        return
    for k in [k for k in os.environ if k.startswith("PADDLE_TPU_")]:
        if k not in env:
            del os.environ[k]
    os.environ.update(env)
    state.objects["env"] = dict(env)


def rank_params(state, pid: int, names: list) -> None:
    tree: dict = {}
    for name in names:
        _put(tree, name, state.uploads.pop(("p", pid, name)))
    state.objects[("params", pid)] = tree


def rank_bind(state, mid, bid, pid, cfg, mp, ep, layout, batch, max_len,
              block_size, num_blocks, share, graphs, n_experts, stacks, env):
    """Make binding ``bid`` on this rank: its cache (local kv heads), its
    routing accumulator, its ``engine.Binding`` over params ``pid``;
    returns {leaf: local shape}."""
    from . import engine, generate, moe_serving

    _apply_env(state, env)
    mesh = state.meshes[mid]
    ctx = tp_context.DecodeShard(mesh, cfg, mp, ep)
    lcfg = dataclasses.replace(cfg, num_kv_heads=ctx.kv_heads)
    cache = generate.init_cache(lcfg, batch, max_len, state.device,
                                layout=layout, block_size=block_size,
                                num_blocks=num_blocks)
    if share is not None:
        cache["tables"] = state.objects[("bind", share)].bind.cache["tables"]
    stats = (moe_serving.moe_stats_init(n_experts, state.device)
             if n_experts else None)
    params = state.objects[("params", pid)]
    adapters = ({leaf: state.uploads.pop(("a", bid, leaf)) for leaf in stacks}
                if stacks else None)
    bind = engine.Binding(params, cache, graphs=graphs, stats=stats,
                          adapters=adapters)
    state.objects[("bind", bid)] = _RankBind(cfg, ctx, bind, pid)
    return {n: tuple(t.shape) for n, t in cache.items()}


def rank_reg(state, sid, bid, kind, spec_kw, env) -> None:
    from . import engine

    _apply_env(state, env)
    b = state.objects[("bind", bid)]
    spec = engine.StepSpec(cfg=b.cfg, payload=b.bind, **spec_kw)
    with tp_context.use(b.ctx):
        fn = engine.ENGINE.get(kind, spec)
    state.objects[("step", sid)] = (b, fn, kind, env)


def rank_run(state, sid, feeds):
    """One step on this rank: the feeds of the kind (an ``inject``'s rows
    cut to the rank's kv heads), under the rank's ``DecodeShard``."""
    b, fn, kind, env = state.objects[("step", sid)]
    _apply_env(state, env)
    ctx = b.ctx
    if kind == "inject" and ctx.kv_split and ctx.n_mp > 1:
        n = ctx.kv_heads
        feeds = [f.narrow(3, ctx.r_mp * n, n) if i < len(feeds) - 3 else f
                 for i, f in enumerate(feeds)]
    # timed only inside a window that ``rank_step_ms`` opened
    evs = state.objects.get("events")
    if evs is not None and state.device.type == "cuda":
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        evs.append(ev)
    with tp_context.use(ctx):
        outs = list(fn(*feeds))
    if evs is not None and state.device.type == "cuda":
        ev[1].record()
    return outs


def rank_write(state, owner, path, feeds) -> None:
    leaf = _rank_leaf(state, owner, path)
    leaf.copy_(feeds[0].to(leaf.device))


def rank_adapter_row(state, bid, i, leaves, feeds) -> None:
    stacks = state.objects[("bind", bid)].bind.adapters
    for leaf, row in zip(leaves, feeds):
        stacks[leaf][i].copy_(row.to(stacks[leaf].device, torch.float32))


def _rank_leaf(state, owner, path):
    obj = state.objects[tuple(owner)]
    if isinstance(obj, _RankBind):
        head, _, rest = path.partition("/")
        if head == "stats":
            return obj.bind.stats[rest]
        return obj.bind.cache[path]
    return _get(obj, path)


def rank_fetch(state, owner, path):
    t = _rank_leaf(state, owner, path)
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    return _to_wire(t)


def rank_drop(state, owner) -> None:
    """Drop a binding (its steps, graphs and cache) or a params set."""
    from . import engine

    owner = tuple(owner)
    obj = state.objects.pop(owner, None)
    if isinstance(obj, _RankBind):
        engine.ENGINE.purge(binding=obj.bind)
        for k in [k for k, v in state.objects.items()
                  if k[0] == "step" and v[0] is obj]:
            del state.objects[k]
    del obj
    if state.device.type == "cuda":
        torch.cuda.synchronize(state.device)
        torch.cuda.empty_cache()


def rank_counts(state) -> dict:
    """This rank's kernel-wrapper launch counters."""
    from . import engine

    return {f"{w.__name__}.{a}": getattr(w, a)
            for w, a in engine._counter_fields()}


def rank_reset_counts(state) -> None:
    from . import engine

    for w, a in engine._counter_fields():
        setattr(w, a, 0)


def rank_collectives(state, reset: bool = False) -> dict:
    """This rank's collective calls and bytes since the last reset."""
    from ..distributed import collective

    out = collective.stats()
    if reset:
        collective.reset_stats()
    return out


def rank_memory(state) -> dict:
    """This rank's card memory: reserved and peak allocated bytes."""
    if state.device.type != "cuda":
        return {"reserved": 0, "peak": 0}
    return {"reserved": torch.cuda.memory_reserved(state.device),
            "peak": torch.cuda.max_memory_allocated(state.device)}


def rank_graphs(state, bid) -> dict:
    """This rank's graphs of binding ``bid``: how many are captured, and
    the replays of each step name."""
    from . import engine

    bind = state.objects[("bind", bid)].bind
    graphs = engine.ENGINE.graphs(bind)
    replays: dict = {}
    for g in graphs:
        replays[g.name] = replays.get(g.name, 0) + g.replays
    return {"captured": len(graphs), "replays": replays}


def rank_step_ms(state, reset: bool = False) -> list:
    """A timing window over this rank's steps: ``reset`` opens it (each
    step then records CUDA events around it: a replay, or an eager step's
    kernels); a read closes it and returns each step's card time in ms.
    Outside a window a step records nothing."""
    if reset:
        state.objects["events"] = []
        return []
    evs = state.objects.pop("events", None) or []
    if evs:
        torch.cuda.synchronize(state.device)
    return [a.elapsed_time(b) for a, b in evs]


def rank_sync(state) -> None:
    if state.device.type == "cuda":
        torch.cuda.synchronize(state.device)
