"""The step Engine: one registry that builds, caches and replays every
step the server and ``generate`` run.

Counterpart of ``paddle_tpu/text/engine.py``.  The JAX Engine compiles
each step once per config value and re-launches the executable; here a
step on the card is captured once as a CUDA graph and replayed, so a
tick costs the host one graph launch instead of the ~700 Python kernel
wrappers of an eager step.

* :class:`StepSpec` — the declarative description of one step: the
  model config (whose :func:`cfg_key` folds in ``flags.decode_jit_key()``
  — the W4 and fused-LN routes, KV dtype, layout and block size, all
  baked into a captured graph), the layout tag, prompt bucket or chunk
  width, block length, ``generate``'s knobs and prompt shape, and an
  un-keyed ``payload``: the server's :class:`Binding`.
* the registry — ``@register(kind, key=..., name=...)`` builders, each
  keyed only by the spec fields it reads.  Every kind is captured on the
  card: the decode ticks (``step``, ``sample``, ``block``,
  ``sample_block``, ``async``, ``async_block``, ``async_sample_block``),
  admission (``prefill`` per bucket, ``prefill_chunk`` per width,
  ``paged_prefill`` per chunk width — fed the tokens and the offset,
  length and slot as device tensors, so one graph serves any prompt and
  slot), ``inject`` per rows bucket and layout (rows computed elsewhere
  written into a slot: a spilled prefix chain restored through the block
  tables, a fleet worker's handoff), ``kv_copy`` per power-of-two pair
  count (copy-on-write block copies), ``spec_verify`` per chunk K
  (the speculative round's one target pass, fed device tokens and
  positions like the ticks), ``spec_tree_verify`` and
  ``spec_tree_commit`` per node budget N (the tree round's pass, its
  topology fed as data, and its row permute), ``generate``'s decode step
  and ``beam``'s position step, and an MoE server's ``moe_*`` twins
  (joint-routing ``moe_step``, ``moe_sample``, ``moe_block``,
  ``moe_async``, fed the occupancy mask and adding into the binding's
  routing accumulator; ``moe_prefill``, ``moe_prefill_chunk``,
  ``moe_paged_prefill``; ``moe_verify``), a constrained server's
  ``masked_step`` (fed the [B, V] mask) and a pool-attached server's
  ``adapter_*`` twins (``adapter_step``, ``adapter_sample``,
  ``adapter_block``, ``adapter_async``, ``adapter_spec_verify``,
  ``adapter_prefill``, ``adapter_prefill_chunk``,
  ``adapter_paged_prefill``: fed the per-slot adapter ids, reading the
  pool's stacks from the binding).  On the CPU every kind runs its plain
  callable.
* :class:`Engine` — the bounded, thread-safe cache (``_LRU``, sized by
  ``PADDLE_TPU_STEP_CACHE_SIZE`` as in the JAX package), ``get``,
  ``purge``, ``warmup`` and the caches ``generate`` binds its steps to
  (:meth:`Engine.generate_binding`).

The one design difference from the JAX Engine: **a graph is bound to
buffers.**  It reads the server's params and cache leaves (the paged
``tables`` leaf included, an MoE server's routing accumulator and an
adapter pool's stacks) by address and owns static input and output
buffers, so the Engine keys each step by ``spec.key(kind)`` plus the
binding — the leaves' ``data_ptr``s.  Two servers with one config never
share a graph; ``Engine.purge(cfg, binding=...)`` (which
``DecodeServer.close`` calls) drops a server's graphs and their private
memory pools.  A graph keeps references to what it reads, so it never
replays into freed memory.

Capture follows PyTorch's recipe: one eager run on the capture stream
first — it builds the kernels (``ops/_build.load``), sets their
``argtypes`` and creates the stream's tick ticket buffer
(``ops/decode_attention._ticket_buf``), which would otherwise be born
inside the capture — then ``torch.cuda.graph`` records the same call.
Every step but ``beam`` and ``spec_tree_commit`` is idempotent on the
cache (it rewrites the rows it attends from the same inputs — an
admission the rows of its prompt or chunk), so the eager run and the
replay that follows leave the cache as one step would; ``beam`` reorders
the cache's batch axis and ``spec_tree_commit`` permutes rows, so their
captures put the cache back as it was after the eager run.  A binding's
routing accumulator is never idempotent (each run adds its delta): every
capture puts it back after the eager run, so the call counts once.  A capture
that fails (a real allocator OOM inside it, say) raises after the capture has
ended and its graph has been dropped: the
step is left uncaptured, the launch counters as they were, and the next
call captures afresh.  There is no eager fallback on the card.

Every build — a capture on the card, an eager step's first call — is
reported to the recompile watch (``telemetry.record_build``) with its
step key and ``flags.decode_jit_key()``: ``telemetry.compile_log()``
lists the builds, and a build of a step seen before under other flags
warns.  The same build gives the device feed its cost record: the eager
run (a capture's first warm run) is counted by shape — FLOPs, bytes,
argument and output sizes (``telemetry.counted_call``) — and a
capture's private pool is its ``temp_bytes``; ``telemetry.device_feed``
joins them with the server's walls per step name.  After ``warmup`` a
server's serve should add no record (the admission ladder's widths are
captured there too).

The kernel wrappers count launches in Python (``.launches``,
``.tc_launches``, ``.tick_launches``, through ``ops/_counts.py``), which a
replay does not run: a capture tallies its warm run's and its own
launches on the capturing thread only (``_counts.held``) and keeps the
capture's tally, which every replay adds — so N replays count exactly N
eager steps' launches, and a capture or a warmup on one thread never
takes back the launches another thread made meanwhile (a fleet ticks its
replicas on a thread pool beside a prefill worker's thread).  Captures
are serialized by one lock, and each takes the side stream of the stream
it was made from, so a worker's graphs (its own stream) and the
replicas' (the default stream) never share a tick ticket buffer.

"""
from __future__ import annotations

import collections
import dataclasses
import os as _os
import threading
import time as _time
from typing import Any, Callable

import torch

from .. import flags as _flags
from .. import telemetry as _telemetry
from ..distributed import collective as _collective
from ..ops import _counts as _launch_counts

__all__ = ["StepSpec", "Binding", "Engine", "ENGINE", "register", "kinds",
           "cfg_key"]


class _LRU:
    """Bounded step cache with least-recently-used eviction; evicting an
    entry drops the last reference to its graph (and with it the graph's
    private memory pool).  Thread-safe: an unlocked OrderedDict corrupts
    under concurrent ``move_to_end``/``popitem``."""

    _MISS = object()

    def __init__(self, maxsize: int):
        self._d = collections.OrderedDict()
        self._mu = threading.Lock()
        self.maxsize = maxsize

    def get(self, k, default=None):
        with self._mu:
            if k in self._d:
                self._d.move_to_end(k)
                return self._d[k]
            return default

    def __getitem__(self, k):
        v = self.get(k, _LRU._MISS)
        if v is _LRU._MISS:
            raise KeyError(k)
        return v

    def __setitem__(self, k, v):
        evicted = []
        with self._mu:
            self._d[k] = v
            self._d.move_to_end(k)
            while len(self._d) > self.maxsize:
                evicted.append(self._d.popitem(last=False)[1])
        for fn in evicted:
            _release(fn)

    def __len__(self):
        with self._mu:
            return len(self._d)

    def keys(self):
        with self._mu:
            return list(self._d.keys())

    def values(self):
        with self._mu:
            return list(self._d.values())

    def pop(self, k, default=None):
        with self._mu:
            return self._d.pop(k, default)

    def clear(self):
        with self._mu:
            dropped = list(self._d.values())
            self._d.clear()
        for fn in dropped:
            _release(fn)


def cfg_key(cfg):
    """Value-based key of a GPTConfig (an unhashable dataclass) plus
    ``flags.decode_jit_key()``: the routes a captured step bakes in.  An
    MoE config adds every routing field, (E, top_k, capacity_factor,
    router_noise, aux_loss_weight), as the JAX key does: two MoE configs
    differing in any of them never share a step."""
    moe = cfg.moe
    moe_key = ((moe.num_experts, moe.top_k, moe.capacity_factor,
                moe.router_noise, moe.aux_loss_weight)
               if moe is not None else None)
    return (cfg.vocab_size, cfg.hidden_size, cfg.num_layers, cfg.num_heads,
            cfg.num_kv_heads, cfg.max_seq_len, cfg.ffn_ratio, str(cfg.dtype),
            cfg.pos_embed, cfg.norm, cfg.activation, moe_key,
            _flags.decode_jit_key())


def _param_leaves(params) -> list:
    """Every tensor of a parameter tree (a dict, nested ``blocks`` and
    its MoE subtree included, or a module's parameters)."""
    if isinstance(params, torch.nn.Module):
        return list(params.parameters())
    out = []
    for t in params.values():
        out.extend([t] if isinstance(t, torch.Tensor) else _param_leaves(t))
    return out


class Binding:
    """The buffers a server's steps read and write: its ``params`` and
    ``cache`` (leaves written in place by every step), on an MoE server
    ``stats`` — the routing accumulator its ``moe_*`` decode steps add
    into (``moe_serving.moe_stats_init``) — and with an adapter pool
    ``adapters``, the pool's stacks (``AdapterPool.stacks()``, written in
    place by a register, read by the ``adapter_*`` steps).  ``key`` — the
    device, the graph switch and every leaf's address, the accumulator's
    and the stacks' too — is the part of the Engine's cache key that keeps
    one server's graphs from another's (and from another server's
    counters).

    ``graphs=False`` runs the steps eagerly on the card: a private switch
    for the card tests, ``chip_smoke.py`` and ``tools/profile_serving``,
    which hold graphs against the eager steps (the JAX server has no
    eager mode either)."""

    def __init__(self, params, cache: dict, graphs: bool = True,
                 stats: dict | None = None, adapters: dict | None = None):
        self.params = params
        self.cache = cache
        self.stats = stats
        self.adapters = adapters
        # held by a caller driving the binding's steps from its own loop
        # (``generate``), so two threads never interleave on one cache
        self.lock = threading.Lock()
        self.device = cache["k"].device
        self.graphs = bool(graphs) and self.device.type == "cuda"
        self.key = (str(self.device), self.graphs,
                    tuple(t.data_ptr() for t in cache.values()),
                    tuple(t.data_ptr() for t in _param_leaves(params)),
                    tuple(t.data_ptr() for t in (adapters or {}).values()),
                    tuple(t.data_ptr() for t in (stats or {}).values()))


class _ShardCtx:
    """A tensor-parallel server's placement (the JAX ``_ShardCtx``): the
    ``mesh`` (``distributed.serving_mesh.ServingMesh``), its ``mp`` axis
    and optional ``ep`` axis, and the specs its leaves take — ``params``
    (``generate._decode_param_specs``, or on an MoE config
    ``moe_serving.moe_decode_param_specs``: experts over ``ep``, replicated
    under pure tensor parallel), ``cache`` (``generate.sharded_cache_specs``:
    the Hkv axis of slab and pool over ``mp``, ``tables`` whole) and, with
    an adapter pool, ``adapters`` (``adapters.stacked_pool_specs``).  The
    refusals are the JAX server's, in its words.  ``key`` — the axis, the
    mesh's shape and devices, and ``ep`` when given — joins every step key
    of the server (through its ``tp_serving.ShardedBinding``), so a sharded
    server's builds never collide with a single card's and stay visible to
    the recompile watch.  What JAX's ``_shard_kw`` hands ``jax.jit`` (the
    in / out shardings) is here each rank's own binding: its blocks of the
    params, its cache heads."""

    def __init__(self, mesh, cfg, params, cache, mp: str = "mp",
                 pool=None, ep: str | None = None):
        from . import generate

        if mp not in mesh.shape:
            raise ValueError(f"mesh has no {mp!r} axis (axes: "
                             f"{tuple(mesh.shape)})")
        if ep is not None:
            if cfg.moe is None:
                raise ValueError("ep axis given but cfg.moe is None — "
                                 "expert parallelism needs experts")
            if ep not in mesh.shape:
                raise ValueError(f"mesh has no {ep!r} axis (axes: "
                                 f"{tuple(mesh.shape)})")
            if cfg.moe.num_experts % mesh.shape[ep] != 0:
                raise ValueError(
                    f"num_experts={cfg.moe.num_experts} not divisible by "
                    f"ep axis size {mesh.shape[ep]}")
        self.mesh, self.mp, self.ep = mesh, mp, ep
        if cfg.moe is not None:
            from . import moe_serving

            self.params = moe_serving.moe_decode_param_specs(
                params, cfg, mp=mp, ep=ep)
        else:
            self.params = generate._decode_param_specs(params, cfg, mp)
        self.cache = generate.sharded_cache_specs(cfg, cache, mesh, mp)
        if pool is not None:
            from . import adapters

            self.adapters = adapters.stacked_pool_specs(pool, mp=mp)
        else:
            self.adapters = None
        self.key = (mp, tuple(mesh.shape.items()),
                    tuple(str(d) for d in mesh.devices))
        if ep is not None:
            self.key = self.key + (("ep", ep),)


@dataclasses.dataclass(frozen=True)
class StepSpec:
    """Declarative description of one step.  Fields a kind does not read
    stay at their defaults:

    * ``cfg`` — the model's GPTConfig (keyed by value via :func:`cfg_key`);
    * ``paged`` — the layout tag (block tables vs the contiguous slab);
    * ``bucket`` — prompt bucket (``prefill``) or chunk width
      (``paged_prefill``);
    * ``width`` — the chunk width of ``prefill_chunk``;
    * ``k`` — the block length of the block kinds;
    * ``extra`` — kind-specific scalars folded into the key as they are
      (``generate``'s ``(max_new_tokens, top_k, top_p)``, as in the JAX
      registry);
    * ``shape`` — the feed shape of a kind the JAX package retraces per
      shape and a graph fixes (``generate``'s prompt [B, P]);
    * ``pkey`` — ``AdapterPool.pool_key()``, the pool's geometry
      (capacity, rank, targets), read by the ``adapter_*`` kinds;
    * ``payload`` — the server's :class:`Binding`, never keyed by value
      (the Engine adds its ``key``)."""

    cfg: Any
    paged: bool = False
    bucket: int | None = None
    width: int | None = None
    k: int | None = None
    extra: tuple = ()
    shape: tuple = ()
    pkey: Any = None
    payload: Any = dataclasses.field(default=None, compare=False)

    def key(self, kind: str) -> tuple:
        """The step key of ``kind`` at this spec: ``cfg_key`` plus exactly
        the fields the kind's step depends on."""
        return _REGISTRY[kind].key(self)


class _Kind:
    __slots__ = ("kind", "key", "name", "build", "idempotent")

    def __init__(self, kind, key, name, build, idempotent):
        self.kind, self.key, self.name, self.build = kind, key, name, build
        self.idempotent = idempotent


_REGISTRY: dict[str, _Kind] = {}


def register(kind: str, *, key: Callable, name, idempotent: bool = True):
    """Register a step builder: ``key(spec)`` -> step key (reading only
    the fields the step depends on), ``name(spec)`` -> its name (a str
    for a fixed one).  The builder takes the :class:`StepSpec` and returns
    the step body ``body(params, cache, *feeds) -> tuple of tensors``,
    captured on the card.  ``idempotent=False``: running the body twice
    on the same feeds changes the cache again (``beam``'s reorder), so a
    capture restores the cache after its eager run."""
    name_fn = (lambda spec, _n=name: _n) if isinstance(name, str) else name

    def deco(build: Callable) -> Callable:
        _REGISTRY[kind] = _Kind(kind, key, name_fn, build, idempotent)
        return build

    return deco


def kinds() -> tuple:
    """Every registered step kind, sorted."""
    return tuple(sorted(_REGISTRY))


# --------------------------------------------------------------------------
# registry: the serving steps.  Builders import their siblings at build
# time (serving imports this module).
# --------------------------------------------------------------------------


@register("step", key=lambda s: ("step", cfg_key(s.cfg), s.paged),
          name="serving.step")
def _build_step(spec):
    """One batched decode step: (tok [B], pos [B]) -> (logits [B, V],)."""
    from . import serving

    def body(p, c, tok, pos, _cfg=spec.cfg):
        return (serving.decode_step_batched(p, c, tok, pos, _cfg)[0],)
    return body


@register("sample", key=lambda s: ("sample", cfg_key(s.cfg), s.paged),
          name="serving.sample_step")
def _build_sample(spec):
    """One sampled step: (tok, pos, key, temp, top_k, top_p) -> (tokens,)
    — greedy where temp == 0."""
    from . import serving

    def body(p, c, tok, pos, key, te, tk, tp, _cfg=spec.cfg):
        return (serving.sample_step_batched(p, c, tok, pos, key, te, tk, tp,
                                            _cfg)[0],)
    return body


@register("block", key=lambda s: ("block", cfg_key(s.cfg), s.k, s.paged),
          name=lambda s: f"serving.block@{s.k}")
def _build_block(spec):
    """``k`` greedy steps, each argmax fed back on the device:
    (tok, pos) -> (tokens [B, k],)."""
    from . import serving

    def body(p, c, tok, pos, _cfg=spec.cfg, _k=spec.k):
        return (serving.decode_block_batched(p, c, tok, pos, _k, _cfg)[0],)
    return body


@register("sample_block",
          key=lambda s: ("sample_block", cfg_key(s.cfg), s.k, s.paged),
          name=lambda s: f"serving.sample_block@{s.k}")
def _build_sample_block(spec):
    """``k`` sampled steps; step j draws with the key of step n + j."""
    from . import serving

    def body(p, c, tok, pos, key, te, tk, tp, _cfg=spec.cfg, _k=spec.k):
        return (serving.sample_block_batched(p, c, tok, pos, key, te, tk, tp,
                                             _k, _cfg)[0],)
    return body


@register("async", key=lambda s: ("async", cfg_key(s.cfg), s.paged),
          name="serving.async_step")
def _build_async(spec):
    """The async-dispatch step: the ``sample`` step whose feed token is
    selected on the device — ``pm`` [B] bool takes ``pv`` (the in-flight
    step's tokens, never fetched) over ``ht`` (host tokens).  Greedy slots
    pass temp 0, so one step serves greedy and sampled ticks."""
    from . import serving

    def body(p, c, ht, pm, pv, pos, key, te, tk, tp, _cfg=spec.cfg):
        return (serving.sample_step_batched(p, c, torch.where(pm, pv, ht),
                                            pos, key, te, tk, tp, _cfg)[0],)
    return body


@register("async_block",
          key=lambda s: ("async_block", cfg_key(s.cfg), s.k, s.paged),
          name=lambda s: f"serving.async_block@{s.k}")
def _build_async_block(spec):
    """Async greedy block: ``block`` with the device-side feed select."""
    from . import serving

    def body(p, c, ht, pm, pv, pos, _cfg=spec.cfg, _k=spec.k):
        return (serving.decode_block_batched(p, c, torch.where(pm, pv, ht),
                                             pos, _k, _cfg)[0],)
    return body


@register("async_sample_block",
          key=lambda s: ("async_sample_block", cfg_key(s.cfg), s.k,
                         s.paged),
          name=lambda s: f"serving.async_sample_block@{s.k}")
def _build_async_sample_block(spec):
    """Async sampled block: ``sample_block`` with the feed select."""
    from . import serving

    def body(p, c, ht, pm, pv, pos, key, te, tk, tp, _cfg=spec.cfg,
             _k=spec.k):
        return (serving.sample_block_batched(
            p, c, torch.where(pm, pv, ht), pos, key, te, tk, tp, _k,
            _cfg)[0],)
    return body


@register("prefill",
          key=lambda s: ("prefill", cfg_key(s.cfg), int(s.bucket)),
          name=lambda s: f"serving.prefill@{s.bucket}")
def _build_prefill(spec):
    """Whole-prompt admission at one bucket: (tokens [1, bucket], length,
    slot) -> (logits [V],); length and slot are 0-d int64 device feeds."""
    from . import generate

    def body(p, c, tokens, length, slot, _cfg=spec.cfg):
        return (generate.prefill_slot(p, c, tokens, length, slot, _cfg)[0],)
    return body


@register("prefill_chunk",
          key=lambda s: ("prefill_chunk", cfg_key(s.cfg), int(s.width)),
          name=lambda s: f"serving.prefill_chunk@{s.width}")
def _build_prefill_chunk(spec):
    """One fixed-width admission chunk on the slab (``prefill_chunk=N``,
    or a budgeted admission's chunk): (tokens [1, C], pos0, length, slot)
    -> (logits [V],), any offset and slot."""
    from . import generate

    def body(p, c, tokens, pos0, length, slot, _cfg=spec.cfg):
        return (generate.prefill_slot_chunk(p, c, tokens, pos0, length, slot,
                                            _cfg)[0],)
    return body


@register("paged_prefill",
          key=lambda s: ("paged_prefill", cfg_key(s.cfg), int(s.bucket)),
          name=lambda s: f"serving.paged_prefill@{s.bucket}")
def _build_paged_prefill(spec):
    """One admission chunk through the block tables, any offset and slot:
    (tokens [1, C], pos0, length, slot) -> (logits [V],).  Copy-on-write
    and the table push run before it, outside the graph (the graph reads
    the ``tables`` leaf by address)."""
    from . import kv_pool

    def body(p, c, tokens, pos0, length, slot, _cfg=spec.cfg):
        return (kv_pool.paged_prefill_chunk(p, c, tokens, pos0, length, slot,
                                            _cfg)[0],)
    return body


@register("inject",
          key=lambda s: ("inject", cfg_key(s.cfg), int(s.bucket), s.paged),
          name=lambda s: f"serving.inject@{s.bucket}")
def _build_inject(spec):
    """Rows computed elsewhere written into one slot's rows [start,
    length): (one [L, 1, bucket, Hkv(, hd)] rows feed per cache leaf, in
    ``kv_pool.POOL_LEAVES`` order, start, length, slot) -> ().  Paged:
    through the slot's block table (``kv_pool.inject_rows``; a restored
    spill chain, a fleet handoff); contiguous: the masked merge into the
    slab (``generate.inject_slot_rows``; a fleet handoff)."""
    from . import generate, kv_pool

    write = kv_pool.inject_rows if spec.paged else generate.inject_slot_rows

    def body(p, c, *feeds):
        names = [n for n in kv_pool.POOL_LEAVES if n in c]
        *rows, start, length, slot = feeds
        write(c, dict(zip(names, rows)), start, length, slot)
        return ()
    return body


@register("kv_copy",
          key=lambda s: ("kv_copy", cfg_key(s.cfg), int(s.k)),
          name=lambda s: f"serving.kv_copy@{s.k}")
def _build_kv_copy(spec):
    """The copy-on-write device half: ``k`` pool block pairs copied in one
    step (``kv_pool.copy_blocks``): (src [k], dst [k] int64) -> ().  The
    server pads a drain's pairs to a power of two by repeating its first
    pair (the same copy twice), so one graph serves every count of a
    log2 bucket."""
    from . import kv_pool

    def body(p, c, src, dst):
        kv_pool.copy_blocks(c, src, dst)
        return ()
    return body


@register("spec_verify",
          key=lambda s: ("spec_verify", cfg_key(s.cfg), int(s.k), s.paged),
          name=lambda s: f"serving.spec_verify@{s.k}")
def _build_spec_verify(spec):
    """The speculative round's verify: (tokens [B, K], pos [B]) ->
    (logits [B, K, V],) — column 0 each slot's feed token, columns 1..K-1
    its proposals, row j the target's logits at pos_b + j.  One graph per
    (cfg, K, layout, binding); K is in the shapes (and
    ``PADDLE_TPU_SPEC_K`` in ``flags.decode_jit_key``)."""
    from . import serving

    def body(p, c, tok, pos, _cfg=spec.cfg):
        return (serving.spec_verify_batched(p, c, tok, pos, _cfg)[0],)
    return body


@register("spec_tree_verify",
          key=lambda s: ("spec_tree_verify", cfg_key(s.cfg), int(s.k),
                         s.paged),
          name=lambda s: f"serving.spec_tree_verify@{s.k}")
def _build_spec_tree_verify(spec):
    """The tree round's verify: (tokens [B, N], amask [B, N, N] bool,
    depth [B, N], pos [B]) -> (logits [B, N, V],).  The topology is fed
    like the tokens, so one graph per (cfg, N, layout, binding) serves
    every tree; N is in the shapes (and ``PADDLE_TPU_SPEC_TREE`` in
    ``flags.decode_jit_key``).  Torch ops only: the tree mask is not
    causal, and the decode kernels' is."""
    from . import serving

    def body(p, c, tok, amask, depth, pos, _cfg=spec.cfg):
        return (serving.spec_tree_verify_batched(p, c, tok, amask, depth,
                                                 pos, _cfg)[0],)
    return body


@register("spec_tree_commit",
          key=lambda s: ("spec_tree_commit", cfg_key(s.cfg), int(s.k),
                         s.paged),
          name=lambda s: f"serving.spec_tree_commit@{s.k}",
          idempotent=False)
def _build_spec_tree_commit(spec):
    """The tree round's row permute, cache only: (src [B, N - 1], pos [B])
    -> ().  Not idempotent — a second run moves the moved rows again — so
    its capture puts the cache back after the eager run."""
    from . import serving

    def body(p, c, src, pos):
        serving.spec_tree_commit_batched(c, src, pos)
        return ()
    return body


@register("sharded_decode",
          key=lambda s: ("sharded_decode", cfg_key(s.cfg)) + tuple(s.extra),
          name="generate.sharded_decode")
def _build_sharded_decode(spec):
    """``generate.build_sharded_decode``'s step, run on every rank of its
    binding: (token [B], pos 0-d) -> (logits [B, V],), the cache written
    in place.  ``extra`` is (layout, block_size): the paged layout takes
    the block-table step with ``pos`` broadcast to every slot."""
    from . import generate, kv_pool

    paged = spec.extra[0] == "paged"

    def body(p, c, tok, pos, _cfg=spec.cfg):
        if paged:
            pos_b = pos.to(torch.int32).reshape(()).expand(tok.shape[0])
            return (kv_pool.paged_decode_step_batched(
                p, c, tok, pos_b.contiguous(), _cfg)[0],)
        return (generate.decode_step(p, c, tok, pos, _cfg)[0],)
    return body


@register("generate",
          key=lambda s: ("generate", cfg_key(s.cfg), *s.extra, s.shape),
          name="generate.generate")
def _build_generate(spec):
    """``generate``'s decode step over its own cache: (tok [B], pos) ->
    (logits [B, V],), pos a 0-d int32 device feed — one replay a
    position.  Keyed as the JAX registry keys its whole-generate jit
    (cfg, max_new_tokens, top_k, top_p), plus the prompt shape the graph
    is fixed to."""
    from . import generate

    def body(p, c, tok, pos, _cfg=spec.cfg):
        return (generate.decode_step(p, c, tok, pos, _cfg)[0],)
    return body


@register("beam",
          key=lambda s: ("beam", cfg_key(s.cfg), *s.extra, s.shape),
          name="generate.beam_search", idempotent=False)
def _build_beam(spec):
    """One beam-search position over ``beam_search``'s [B * W] cache:
    (tok [B * W], pos, scores, alive, lengths) -> (scores, parent,
    new_tok, alive, lengths), each [B, W] (``generate._beam_step``) — one
    replay a position, as ``generate``'s.  Keyed as the JAX registry
    keys its whole-search jit (cfg, max_new_tokens, num_beams,
    length_penalty, eos_id), plus the prompt shape."""
    from . import generate

    eos_id = spec.extra[3]

    def body(p, c, tok, pos, scores, alive, lengths, _cfg=spec.cfg):
        return generate._beam_step(p, c, tok, pos, scores, alive, lengths,
                                   _cfg, eos_id)
    return body


# -- MoE serving kinds (text/moe_serving.py) --------------------------------
#
# The joint-routing decode steps take the occupancy mask ``act`` [B] bool
# as their last feed and add their routing delta into the binding's
# ``stats`` accumulator in place (a replay writes the tensors the graph
# was captured over; their addresses are in the binding's key).  The
# admission kinds are the dense bodies — a prefill routes under its pad
# mask at the dropless capacity, which is exact for MoE — registered
# apart so an MoE server's admission steps are named and keyed as the
# JAX registry's.  ``moe_verify`` is the spec verify over an MoE target:
# registered and runnable, while ``DecodeServer`` refuses speculation on
# MoE models (as the JAX server does).


def _moe_stats(spec):
    stats = spec.payload.stats
    if stats is None:
        raise ValueError("a moe_* decode step needs the binding's routing "
                         "accumulator (Binding(stats=...))")
    return stats


@register("moe_step", key=lambda s: ("moe_step", cfg_key(s.cfg), s.paged),
          name="serving.moe_step")
def _build_moe_step(spec):
    """Greedy joint-routing step: (tok [B], pos [B], act [B]) -> (logits
    [B, V],)."""
    from . import moe_serving

    st = _moe_stats(spec)

    def body(p, c, tok, pos, act, _cfg=spec.cfg):
        return (moe_serving.moe_decode_step_batched(p, c, tok, pos, act, st,
                                                    _cfg)[0],)
    return body


@register("moe_sample",
          key=lambda s: ("moe_sample", cfg_key(s.cfg), s.paged),
          name="serving.moe_sample_step")
def _build_moe_sample(spec):
    """Sampled joint-routing step: (tok, pos, key, temp, top_k, top_p,
    act) -> (tokens,), the dense ``sample`` kind's key schedule."""
    from . import moe_serving

    st = _moe_stats(spec)

    def body(p, c, tok, pos, key, te, tk, tp, act, _cfg=spec.cfg):
        return (moe_serving.moe_sample_step_batched(
            p, c, tok, pos, key, te, tk, tp, act, st, _cfg)[0],)
    return body


@register("moe_block",
          key=lambda s: ("moe_block", cfg_key(s.cfg), s.k, s.paged),
          name=lambda s: f"serving.moe_block@{s.k}")
def _build_moe_block(spec):
    """``k`` greedy joint-routing steps: (tok, pos, act) -> (tokens
    [B, k],); ``act`` is the occupancy at dispatch for the whole block."""
    from . import moe_serving

    st = _moe_stats(spec)

    def body(p, c, tok, pos, act, _cfg=spec.cfg, _k=spec.k):
        return (moe_serving.moe_decode_block_batched(p, c, tok, pos, act, st,
                                                     _k, _cfg)[0],)
    return body


@register("moe_async", key=lambda s: ("moe_async", cfg_key(s.cfg), s.paged),
          name="serving.moe_async_step")
def _build_moe_async(spec):
    """The async-dispatch joint-routing tick: the device-side feed select
    (``pm`` takes the in-flight step's ``pv`` over the host's ``ht``, as
    the dense ``async`` kind) in front of the sampled joint step (temp 0
    is greedy): (ht, pm, pv, pos, key, temp, top_k, top_p, act) ->
    (tokens,)."""
    from . import moe_serving

    st = _moe_stats(spec)

    def body(p, c, ht, pm, pv, pos, key, te, tk, tp, act, _cfg=spec.cfg):
        return (moe_serving.moe_sample_step_batched(
            p, c, torch.where(pm, pv, ht), pos, key, te, tk, tp, act, st,
            _cfg)[0],)
    return body


@register("moe_prefill",
          key=lambda s: ("moe_prefill", cfg_key(s.cfg), int(s.bucket)),
          name=lambda s: f"serving.moe_prefill@{s.bucket}")
def _build_moe_prefill(spec):
    """MoE admission at one bucket: the ``prefill`` body (pads masked
    out of routing, dropless capacity)."""
    return _build_prefill(spec)


@register("moe_prefill_chunk",
          key=lambda s: ("moe_prefill_chunk", cfg_key(s.cfg),
                         None if s.width is None else int(s.width)),
          name=lambda s: ("serving.moe_prefill_chunk" if s.width is None
                          else f"serving.moe_prefill_chunk@{int(s.width)}"))
def _build_moe_prefill_chunk(spec):
    """MoE chunked or budgeted admission: the ``prefill_chunk`` body."""
    return _build_prefill_chunk(spec)


@register("moe_paged_prefill",
          key=lambda s: ("moe_paged_prefill", cfg_key(s.cfg),
                         int(s.bucket)),
          name=lambda s: f"serving.moe_paged_prefill@{s.bucket}")
def _build_moe_paged_prefill(spec):
    """MoE admission through the block tables: the ``paged_prefill``
    body."""
    return _build_paged_prefill(spec)


@register("moe_verify",
          key=lambda s: ("moe_verify", cfg_key(s.cfg), int(s.k), s.paged),
          name=lambda s: f"serving.moe_verify@{s.k}")
def _build_moe_verify(spec):
    """The spec verify over an MoE target: the ``spec_verify`` body, whose
    FFN tails route the call's B·K tokens jointly under the
    capacity-factor bound (the reference's kernel route; its vmapped
    route takes each slot's K apart — the same tokens wherever the
    capacity is dropless)."""
    return _build_spec_verify(spec)


# -- constrained and adapter kinds (text/adapters.py) ----------------------
#
# ``masked_step`` is a pool-less server's constrained step: the ``sample``
# step plus the [B, V] float32 mask, a feed copied into the graph's static
# input each tick.  The ``adapter_*`` kinds are a pool-attached server's
# twins of its steps: they read the pool's stacks from the binding (by
# address: a register writes a row in place, and the next replay reads
# it) and take the per-slot ids [B] (admission: the slot's id [1]) as
# their first feed.  Each keys on ``pkey``, the pool's geometry, beside
# the fields its plain twin reads, as the JAX registry keys them.


def _adapter_stacks(spec):
    stacks = spec.payload.adapters
    if stacks is None:
        raise ValueError("an adapter_* step needs the binding's pool stacks "
                         "(Binding(adapters=...))")
    return stacks


@register("masked_step",
          key=lambda s: ("masked_step", cfg_key(s.cfg), s.paged),
          name="serving.masked_step")
def _build_masked_step(spec):
    """Constrained step without a pool: (tok, pos, key, temp, top_k, top_p,
    mask [B, V]) -> (tokens,); greedy slots take the masked argmax."""
    from . import serving

    def body(p, c, tok, pos, key, te, tk, tp, m, _cfg=spec.cfg):
        return (serving.sample_step_batched(p, c, tok, pos, key, te, tk, tp,
                                            _cfg, mask=m)[0],)
    return body


@register("adapter_step",
          key=lambda s: ("adapter_step", cfg_key(s.cfg), s.pkey, s.paged),
          name="serving.adapter_step")
def _build_adapter_step(spec):
    """Greedy adapter step: (ids [B], tok [B], pos [B]) -> (logits
    [B, V],)."""
    from . import adapters

    ad = _adapter_stacks(spec)

    def body(p, c, ids, tok, pos, _cfg=spec.cfg):
        return (adapters.adapter_decode_step_batched(p, c, ad, ids, tok, pos,
                                                     _cfg)[0],)
    return body


@register("adapter_sample",
          key=lambda s: ("adapter_sample", cfg_key(s.cfg), s.pkey, s.paged),
          name="serving.adapter_sample_step")
def _build_adapter_sample(spec):
    """Sampled / masked adapter step: (ids, tok, pos, key, temp, top_k,
    top_p, mask [B, V]) -> (tokens,); an all-zero mask is unconstrained."""
    from . import adapters

    ad = _adapter_stacks(spec)

    def body(p, c, ids, tok, pos, key, te, tk, tp, m, _cfg=spec.cfg):
        return (adapters.adapter_sample_step_batched(
            p, c, ad, ids, tok, pos, key, te, tk, tp, m, _cfg)[0],)
    return body


@register("adapter_block",
          key=lambda s: ("adapter_block", cfg_key(s.cfg), s.k, s.pkey,
                         s.paged),
          name=lambda s: f"serving.adapter_block@{s.k}")
def _build_adapter_block(spec):
    """``k`` greedy adapter steps: (ids, tok, pos) -> (tokens [B, k],)."""
    from . import adapters

    ad = _adapter_stacks(spec)

    def body(p, c, ids, tok, pos, _cfg=spec.cfg, _k=spec.k):
        return (adapters.adapter_decode_block_batched(p, c, ad, ids, tok, pos,
                                                      _k, _cfg)[0],)
    return body


@register("adapter_async",
          key=lambda s: ("adapter_async", cfg_key(s.cfg), s.pkey, s.paged),
          name="serving.adapter_async_step")
def _build_adapter_async(spec):
    """The async adapter step: the ``async`` kind's device-side feed
    select in front of the sampled adapter step (temp 0 is greedy), no
    mask — constrained slots run synchronously: (ids, ht, pm, pv, pos,
    key, temp, top_k, top_p) -> (tokens,)."""
    from . import adapters

    ad = _adapter_stacks(spec)

    def body(p, c, ids, ht, pm, pv, pos, key, te, tk, tp, _cfg=spec.cfg):
        return (adapters.adapter_sample_step_batched(
            p, c, ad, ids, torch.where(pm, pv, ht), pos, key, te, tk, tp,
            None, _cfg)[0],)
    return body


@register("adapter_spec_verify",
          key=lambda s: ("adapter_spec_verify", cfg_key(s.cfg), int(s.k),
                         s.pkey, s.paged),
          name=lambda s: f"serving.adapter_spec_verify@{s.k}")
def _build_adapter_spec_verify(spec):
    """The adapter verify: (ids, tokens [B, K], pos) -> (logits [B, K,
    V],), each slot under its own adapter."""
    from . import adapters

    ad = _adapter_stacks(spec)

    def body(p, c, ids, tok, pos, _cfg=spec.cfg):
        return (adapters.adapter_spec_verify_batched(p, c, ad, ids, tok, pos,
                                                     _cfg)[0],)
    return body


@register("adapter_prefill",
          key=lambda s: ("adapter_prefill", cfg_key(s.cfg), int(s.bucket),
                         s.pkey),
          name=lambda s: f"serving.adapter_prefill@{s.bucket}")
def _build_adapter_prefill(spec):
    """Whole-prompt admission under one slot's adapter: (aid [1], tokens
    [1, bucket], length, slot) -> (logits [V],)."""
    from . import adapters

    ad = _adapter_stacks(spec)

    def body(p, c, aid, tokens, length, slot, _cfg=spec.cfg):
        return (adapters.adapter_prefill_slot(p, c, ad, aid, tokens, length,
                                              slot, _cfg)[0],)
    return body


@register("adapter_prefill_chunk",
          key=lambda s: ("adapter_prefill_chunk", cfg_key(s.cfg), s.pkey,
                         None if s.width is None else int(s.width)),
          name=lambda s: ("serving.adapter_prefill_chunk" if s.width is None
                          else f"serving.adapter_prefill_chunk@"
                               f"{int(s.width)}"))
def _build_adapter_prefill_chunk(spec):
    """Chunked or budgeted admission under one slot's adapter: (aid,
    tokens [1, C], pos0, length, slot) -> (logits [V],)."""
    from . import adapters

    ad = _adapter_stacks(spec)

    def body(p, c, aid, tokens, pos0, length, slot, _cfg=spec.cfg):
        return (adapters.adapter_prefill_slot_chunk(
            p, c, ad, aid, tokens, pos0, length, slot, _cfg)[0],)
    return body


@register("adapter_paged_prefill",
          key=lambda s: ("adapter_paged_prefill", cfg_key(s.cfg),
                         int(s.bucket), s.pkey),
          name=lambda s: f"serving.adapter_paged_prefill@{s.bucket}")
def _build_adapter_paged_prefill(spec):
    """Paged admission chunk under one slot's adapter: (aid, tokens
    [1, C], pos0, length, slot) -> (logits [V],)."""
    from . import adapters

    ad = _adapter_stacks(spec)

    def body(p, c, aid, tokens, pos0, length, slot, _cfg=spec.cfg):
        return (adapters.adapter_paged_prefill_chunk(
            p, c, ad, aid, tokens, pos0, length, slot, _cfg)[0],)
    return body


# --------------------------------------------------------------------------
# launch counters: a replay runs no Python wrapper
# --------------------------------------------------------------------------


_COUNTERS: list = []


def _counter_fields() -> list:
    """(wrapper, attribute) of every launch counter of the port's
    kernels."""
    if _COUNTERS:
        return _COUNTERS
    from ..ops import decode_attention as da
    from ..ops import flash_attention as fa
    from ..ops import fused_ce as fc
    from ..ops import fused_norm as fn
    from ..ops import woq_matmul as wm

    wrappers = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
                fa.flash_attention_bwd_dkv, fc.ce_fwd, fc.ce_bwd,
                fn.ln_fwd, fn.ln_bwd, wm.w4_matmul, da.decode_attention,
                da.paged_decode_attention)
    _COUNTERS.extend((w, a) for w in wrappers
                     for a in ("launches", "tc_launches", "tick_launches")
                     if hasattr(w, a))
    return _COUNTERS


def _counts() -> list:
    return [getattr(w, a) for w, a in _counter_fields()]


# --------------------------------------------------------------------------
# the two step wrappers
# --------------------------------------------------------------------------


_WARM_RUNS = 1          # eager runs on the capture stream before capture
_GEN_BINDINGS = 4       # generate caches kept (Engine.generate_binding)
_capture_streams: dict = {}
# one capture at a time in the process: a capture's warm run and the
# capture itself must not interleave with another thread's on a shared
# side stream, and the allocator's capture pool is per capture
_capture_lock = threading.RLock()


def _capture_stream(device, stream) -> torch.cuda.Stream:
    """The side stream every eager warm run and capture made from
    ``stream`` (the caller's current stream) runs on, one per (card,
    calling stream), so its per-stream state (the tick ticket buffer,
    cuBLAS's workspace) is made once, outside any capture.  A graph bakes
    in the ticket buffer of its capture stream: graphs captured from
    different streams get different buffers, so a prefill worker replaying
    on its own stream never shares tickets with the replicas' ticks on
    the default stream (launches sharing a buffer must be ordered)."""
    key = (device, stream.cuda_stream)
    s = _capture_streams.get(key)
    if s is None:
        s = _capture_streams[key] = torch.cuda.Stream(device)
    return s


def _record_build(name: str, key, seconds: float, cost=None) -> None:
    """A step build for the recompile watch — its name, step key and the
    flags key (the part of ``cfg_key`` a flag flip changes) — and for the
    device feed: ``cost``, the record of its counted run."""
    _telemetry.record_build(name, key, _flags.decode_jit_key(), seconds,
                            cost)


class _Eager:
    """A step run eagerly: on the CPU (the plain twins) or on the card
    with graphs off.  Host tensors among the feeds move to the binding's
    device (without blocking when they are pinned).  Its first call is
    its build for the recompile watch, and the run the device feed
    counts."""

    def __init__(self, body, binding: Binding, name: str, key=None):
        self.body, self.binding, self.name = body, binding, name
        self.key = key
        self._built = False

    def __call__(self, *feeds):
        dev = self.binding.device
        feeds = [f.to(dev, non_blocking=True)
                 if isinstance(f, torch.Tensor) and f.device != dev else f
                 for f in feeds]
        if self._built:
            return self.body(self.binding.params, self.binding.cache, *feeds)
        t0 = _time.perf_counter()
        out, cost = _telemetry.counted_call(
            self.body, (self.binding.params, self.binding.cache, *feeds))
        self._built = True
        _record_build(self.name, self.key, _time.perf_counter() - t0, cost)
        return out


class _Graph:
    """A step captured as a CUDA graph on its first call and replayed
    after.  ``static`` holds the input buffers the graph reads (each call
    copies its feeds in, without blocking), ``out`` the output tensors a
    replay overwrites — a caller must copy them out before the next
    replay.  ``delta``: the launch counts one replay stands for ({(wrapper,
    attribute): n}, the capture's ``_counts.held`` tally), ``coll_delta``
    the collectives (the capture's ``collective.held`` tally).  A
    capture is reported to the recompile watch; the device feed counts
    its first eager warm run (never the capture) and takes the growth of
    ``torch.cuda.memory_reserved`` across the capture — the graph's
    private pool — as the step's ``temp_bytes``."""

    def __init__(self, body, binding: Binding, name: str, key=None,
                 idempotent: bool = True):
        self.body, self.binding, self.name = body, binding, name
        self.key = key
        self.idempotent = idempotent
        self.graph = None
        self.static = self.out = self.delta = None
        self.coll_delta = {}
        self.replays = 0
        self._keep = ()

    def _capture(self, feeds) -> None:
        with _capture_lock:
            self._capture_locked(feeds)

    def _capture_locked(self, feeds) -> None:
        from ..ops import decode_attention as da

        dev = self.binding.device
        p, c = self.binding.params, self.binding.cache
        t0 = _time.perf_counter()
        self.static = tuple(torch.empty(f.shape, dtype=f.dtype, device=dev)
                            for f in feeds)
        for buf, f in zip(self.static, feeds):
            buf.copy_(f, non_blocking=True)
        cur = torch.cuda.current_stream(dev)
        side = _capture_stream(dev, cur)
        side.wait_stream(cur)
        graph = cost = None
        # the routing accumulator is never idempotent: the eager runs'
        # deltas are taken back, so the replay below is the call's one
        stats, stats0 = self.binding.stats, None
        try:
            # the warm run's launches and collectives are dropped (the
            # replay below is the call's one), the capture's become the
            # replays' ``delta`` / ``coll_delta``: all tallied on this
            # thread only
            with torch.cuda.stream(side), _launch_counts.held(), \
                    _collective.held():
                if stats is not None:
                    stats0 = {n: t.clone() for n, t in stats.items()}
                kept = (None if self.idempotent
                        else {n: t.clone() for n, t in c.items()})
                cost = _telemetry.counted_call(self.body,
                                               (p, c, *self.static))[1]
                for _ in range(_WARM_RUNS - 1):
                    self.body(p, c, *self.static)
                if kept is not None:
                    # the replay below is the call's one application
                    for n, t in c.items():
                        t.copy_(kept[n])
                    del kept
                if stats0 is not None:
                    for n, t in stats.items():
                        t.copy_(stats0[n])
            graph = torch.cuda.CUDAGraph()
            # a failure inside ends the capture on the way out (the
            # context manager's exit); the graph is dropped below.
            # "thread_local": only this thread is barred from syncing
            # calls while it captures.  In the default "global" mode an
            # event wait on any other thread voids the capture — a fetch
            # that the wedge watchdog abandoned (resilience.call_with_
            # budget) wakes and waits on its event, whenever that is.
            with torch.cuda.graph(graph, stream=side,
                                  capture_error_mode="thread_local"), \
                    _launch_counts.held() as delta, \
                    _collective.held() as coll:
                # the context has dropped the allocator's free cache: from
                # here the reserved memory grows by the graph's private
                # pool alone (a host query, legal inside a capture)
                reserved = torch.cuda.memory_reserved(dev)
                out = self.body(p, c, *self.static)
        except BaseException:
            cur.wait_stream(side)
            if graph is not None:
                graph.reset()
            if stats0 is not None:
                for n, t in stats.items():
                    t.copy_(stats0[n])
            self.static = None
            raise
        cur.wait_stream(side)
        if cost is not None and "count_failed" not in cost:
            cost["temp_bytes"] = max(
                0, torch.cuda.memory_reserved(dev) - reserved)
        # the launches and collectives (a rank of a tensor-parallel
        # server) a replay stands for
        self.delta, self.coll_delta = delta, coll
        self.graph, self.out = graph, out
        # buffers the graph reads by address that no binding names: the
        # tick route's ticket buffers (replaced, never freed, while held)
        self._keep = tuple(da._tickets.values())
        _record_build(self.name, self.key, _time.perf_counter() - t0, cost)

    def __call__(self, *feeds):
        if self.graph is None:
            self._capture(feeds)
        else:
            if len(feeds) != len(self.static):
                raise ValueError(f"{self.name}: {len(feeds)} feeds, the "
                                 f"graph takes {len(self.static)}")
            for buf, f in zip(self.static, feeds):
                if f.shape != buf.shape or f.dtype != buf.dtype:
                    raise ValueError(
                        f"{self.name}: feed {tuple(f.shape)} {f.dtype} "
                        f"does not fit the captured {tuple(buf.shape)} "
                        f"{buf.dtype}")
                buf.copy_(f, non_blocking=True)
        self.graph.replay()
        self.replays += 1
        _launch_counts.add(self.delta)
        if self.coll_delta:
            _collective.add_stats(self.coll_delta)
        return self.out

    def release(self) -> None:
        """Drop the graph, its buffers and its private pool."""
        if self.graph is not None:
            self.graph.reset()
        self.graph = self.static = self.out = None
        self._keep = ()


def _release(fn) -> None:
    if isinstance(fn, _Graph):
        fn.release()


class Engine:
    """THE step authority: build via the registry, cache by
    ``spec.key(kind)`` plus the binding, capture on the card, warm up and
    purge.  ``_steps`` is the bounded cache (``PADDLE_TPU_STEP_CACHE_SIZE``
    entries, default 64, read at construction); ``_gen`` holds the caches
    ``generate`` binds its steps to (:meth:`generate_binding`)."""

    def __init__(self):
        self._steps = _LRU(
            int(_os.environ.get("PADDLE_TPU_STEP_CACHE_SIZE", "64")))
        self._gen = collections.OrderedDict()
        self._gen_mu = threading.Lock()
        # a lookup that misses builds and inserts under this lock, so two
        # threads asking for one step get one entry
        self._mu = threading.RLock()

    def generate_binding(self, params, cfg, batch: int, rows: int,
                         device) -> Binding:
        """The :class:`Binding` ``generate`` runs ``params`` on for a batch
        of ``batch`` sequences of ``rows`` positions: a cache of its own
        (``generate.init_cache``), made at the first such call and kept at
        a fixed address, so the graph captured over it replays at every
        later call of that shape.  At most ``_GEN_BINDINGS`` are kept (the
        least recently used goes first, with its steps); :meth:`purge` of
        the config frees them."""
        from . import generate

        key = (cfg_key(cfg), str(device), int(batch), int(rows),
               tuple(t.data_ptr() for t in _param_leaves(params)))
        evicted = []
        with self._gen_mu:
            bind = self._gen.get(key)
            if bind is None:
                bind = self._gen[key] = Binding(
                    params, generate.init_cache(cfg, batch, rows, device))
                while len(self._gen) > _GEN_BINDINGS:
                    evicted.append(self._gen.popitem(last=False)[1])
            self._gen.move_to_end(key)
        for old in evicted:
            self.purge(binding=old)
        return bind

    def get(self, kind: str, spec: StepSpec):
        """The step ``kind`` at ``spec``, bound to ``spec.payload`` (a
        :class:`Binding`): a cache hit, or a new :class:`_Graph` (a graphed
        kind on a card with graphs on; captured at its first call) or
        eager callable.  Either is called with the kind's feeds and
        returns the step's output tensors."""
        from .tp_serving import ShardedBinding

        entry = _REGISTRY[kind]
        bind = spec.payload
        if not isinstance(bind, (Binding, ShardedBinding)):
            raise TypeError(f"{kind}: StepSpec.payload must be the server's "
                            f"Binding, got {type(bind).__name__}")
        key = entry.key(spec) + (bind.key,)
        fn = self._steps.get(key)
        if fn is None:
            with self._mu:
                fn = self._steps.get(key)
                if fn is None:
                    if isinstance(bind, ShardedBinding):
                        # every rank builds (and on NCCL captures) its own
                        fn = bind.step(kind, spec, entry.name(spec), key)
                    elif bind.graphs:
                        fn = _Graph(entry.build(spec), bind,
                                    entry.name(spec), key, entry.idempotent)
                    else:
                        fn = _Eager(entry.build(spec), bind,
                                    entry.name(spec), key)
                    self._steps[key] = fn
        return fn

    def graphs(self, binding: Binding | None = None) -> list:
        """The captured graphs in the cache (of one binding, if given)."""
        return [fn for fn in self._steps.values()
                if isinstance(fn, _Graph) and fn.graph is not None
                and (binding is None or fn.binding is binding)]

    def purge(self, *cfgs, binding: Binding | None = None) -> int:
        """Drop every cached step keyed to any of ``cfgs`` (whatever its
        binding) or, given a ``binding``, every step bound to it (of those
        configs only, when some are named) — releasing each graph and its
        private pool.  Purging configs also frees ``generate``'s caches of
        them.  Returns the number of steps dropped."""
        cks = [cfg_key(c) for c in cfgs if c is not None]
        if not cks and binding is None:
            return 0
        if cks and binding is None:
            with self._gen_mu:
                for k in [k for k in self._gen if k[0] in cks]:
                    del self._gen[k]
        dropped = 0
        with self._mu:
            for k in self._steps.keys():
                if (not cks or k[1] in cks) and (binding is None
                                                 or k[-1] == binding.key):
                    fn = self._steps.pop(k, None)
                    if fn is not None:
                        _release(fn)
                        dropped += 1
        return dropped

    def warmup(self, srv, prompt_lens=None, blocks=(), sample=False,
               constrained=False) -> dict:
        """Build (and on the card capture) every step ``srv`` (a
        DecodeServer) will serve, so its first request pays device time
        only: the tick step of its dispatch mode (``step``, or on an async
        server ``async_block`` at k = 1, its greedy step), the sampled
        twins when ``sample`` (``sample``, ``async``), the block
        kinds for each size in ``blocks``, and the admission steps at the
        buckets or chunk widths of ``prompt_lens`` (default every bucket
        up to the serving window) and at the budget width when
        ``prefill_budget`` is set (``DecodeServer._admission_widths``).
        A speculating server adds ``spec_verify`` at its K (a tree server
        ``spec_tree_verify`` and ``spec_tree_commit`` at its N, fed a
        self-only mask, zero depths and an identity permute) and, with a
        draft model, the draft's ``step``, its ``block`` of K - 1 steps
        (a linear greedy round's proposals) and its admission steps at the
        same widths, on the draft's binding.  An MoE server warms its
        ``moe_*`` twins under the JAX warmup's names: ``moe_step`` (named
        "step"), ``moe_sample`` ("moe_sample_step"), ``moe_block``
        ("moe_block{k}"), on an async server ``moe_async``
        ("moe_async_step", its only tick step: an async MoE block runs
        stepwise), and the ``moe_`` admission kinds — fed an all-False
        occupancy mask, so the warm routes claim nothing and add nothing
        to its routing counters.  A pool-attached server warms every
        site's adapter twin instead, fed all-zero ids, under the JAX
        warmup's names: ``adapter_step`` always, ``adapter_async_step`` on
        an async server, ``adapter_sample_step`` when ``sample`` or
        ``constrained``, ``adapter_block{k}`` on a sync server,
        ``adapter_spec_verify@K`` and the admission names with the
        ``adapter_`` prefix; ``constrained`` without a pool warms
        ``masked_step`` (fed a zero mask).  A paged server warms
        ``kv_copy`` at every power of two up to its batch ("kv_copy@{k}",
        copying the sink block onto itself: a drain copies at most one
        block a slot).  A fleet replica's ``inject`` steps are
        :meth:`warm_inject`'s, which the fleet's Router calls.

        Warm steps run on the live cache with zero feeds, writing rows at
        position 0 of every slot (warm admissions: of slot 0) — rows
        admission overwrites before any mask exposes them, which holds
        only for requests admitted later: a busy server raises.  A paged
        server pushes its pending pool work first: a drained server's
        device tables may still name the retired slots' blocks, which the
        prefix index keeps, and the warm steps must write through the
        empty tables, into the sink block.  The step counter, the counters
        of the kernel wrappers and the server's host state are left as
        they were, so a warmed server serves the tokens a cold one does.

        Returns {name: seconds} of each build (capture or first run)."""
        self._idle(srv)
        dev = srv.device
        cuda = dev.type == "cuda"
        B = srv.max_batch
        zi = torch.zeros(B, dtype=torch.int64)
        zp = torch.zeros(B, dtype=torch.int32)
        zf = torch.zeros(B, dtype=torch.float32)
        of = torch.ones(B, dtype=torch.float32)
        zb = torch.zeros(B, dtype=torch.bool)
        key = torch.tensor(srv._key(0))
        pv = zi.to(dev)
        timings = {}

        def warm(name, kind, *feeds, draft=False, **kw):
            t0 = _time.perf_counter()
            self.get(kind, (srv._dspec if draft else srv._spec)(**kw))(
                *feeds)
            if cuda:
                torch.cuda.synchronize(dev)
            timings[name] = _time.perf_counter() - t0

        moe = srv.cfg.moe is not None
        pool = srv._adapters is not None
        ids = (zi,) if pool else ()
        aid = (torch.zeros(1, dtype=torch.int64),) if pool else ()
        zm = (torch.zeros((B, srv.cfg.vocab_size), dtype=torch.float32)
              if pool or constrained else None)
        # the warm steps' launches are tallied on this thread and dropped:
        # the counters other threads add meanwhile stay
        with _launch_counts.held():
            if pool:
                # the adapter twins ARE what a pool-attached server runs;
                # the sync greedy step also serves an async server's
                # constrained fallback
                if srv._async:
                    warm("adapter_async_step", "adapter_async", zi, zi, zb,
                         pv, zp, key, zf, zi, of)
                warm("adapter_step", "adapter_step", zi, zi, zp)
                if sample or constrained:
                    warm("adapter_sample_step", "adapter_sample", zi, zi, zp,
                         key, zf, zi, of, zm)
            elif srv._async and moe:
                warm("moe_async_step", "moe_async", zi, zb, pv, zp, key, zf,
                     zi, of, zb)
            elif srv._async:
                warm("async_step", "async_block", zi, zb, pv, zp, k=1)
                if sample:
                    warm("async_sample_step", "async", zi, zb, pv, zp, key,
                         zf, zi, of)
            else:
                act = (zb,) if moe else ()
                warm("step", srv._kind("step"), zi, zp, *act)
                if sample:
                    warm("moe_sample_step" if moe else "sample_step",
                         srv._kind("sample"), zi, zp, key, zf, zi, of, *act)
            if constrained and not pool and not moe:
                # an async server's constrained traffic drains to it too
                warm("masked_step", "masked_step", zi, zp, key, zf, zi, of,
                     zm)
            for k in blocks:
                k = int(k)
                if pool:
                    # an async pool server's blocks run stepwise (the
                    # adapter async step above); sampled pool traffic steps
                    # through adapter_sample
                    if not srv._async:
                        warm(f"adapter_block{k}", "adapter_block", zi, zi, zp,
                             k=k)
                elif moe:
                    # an MoE block is greedy and sync (sampled or async
                    # MoE blocks run stepwise, on the steps above)
                    if not srv._async:
                        warm(f"moe_block{k}", "moe_block", zi, zp, zb, k=k)
                elif srv._async:
                    warm(f"async_block{k}", "async_block", zi, zb, pv, zp,
                         k=k)
                    if sample:
                        warm(f"async_sample_block{k}", "async_sample_block",
                             zi, zb, pv, zp, key, zf, zi, of, k=k)
                else:
                    warm(f"block{k}", "block", zi, zp, k=k)
                    if sample:
                        warm(f"sample_block{k}", "sample_block", zi, zp, key,
                             zf, zi, of, k=k)
            drafts = (False, True) if srv._draft_bind is not None \
                else (False,)
            if srv._spec_on:
                K, N = srv._spec_k, srv._spec_tree_n
                if N:
                    warm(f"spec_tree_verify@{N}", "spec_tree_verify",
                         torch.zeros((B, N), dtype=torch.int64),
                         torch.eye(N, dtype=torch.bool).expand(B, N, N)
                         .contiguous(),
                         torch.zeros((B, N), dtype=torch.int64), zp, k=N)
                    warm(f"spec_tree_commit@{N}", "spec_tree_commit",
                         torch.arange(1, N).expand(B, N - 1).contiguous(),
                         zp, k=N)
                else:
                    warm(f"{srv._kind('spec_verify')}@{K}",
                         srv._kind("spec_verify"), *ids,
                         torch.zeros((B, K), dtype=torch.int64), zp, k=K)
                if srv._draft_bind is not None:
                    warm("draft_step", "step", zi, zp, draft=True)
                    if K > 1:
                        warm(f"draft_block{K - 1}", "block", zi, zp,
                             k=K - 1, draft=True)
            for name, plain, width in srv._admission_widths(prompt_lens):
                for draft in drafts:
                    # the draft walks the plain kinds; the target its twin
                    kind = plain if draft else srv._kind(plain)
                    lead = () if draft else aid
                    tag = ("draft_" + name if draft else
                           "adapter_" + name if pool else name)
                    if plain == "prefill":
                        warm(tag, kind, *lead, *srv._feeds([0], width, 1, 0),
                             bucket=width, draft=draft)
                    elif plain == "prefill_chunk":
                        warm(tag, kind, *lead,
                             *srv._feeds([0], width, 0, 1, 0),
                             width=width, draft=draft)
                    else:
                        warm(tag, kind, *lead,
                             *srv._feeds([0], width, 0, 1, 0),
                             bucket=width, draft=draft)
            if srv._paged:
                sink = torch.full((1,), srv._pool.N, dtype=torch.int64)
                k = 1
                while True:
                    for draft in drafts:
                        warm(("draft_" if draft else "") + f"kv_copy@{k}",
                             "kv_copy", sink.expand(k).contiguous(),
                             sink.expand(k).contiguous(), k=k, draft=draft)
                    if k >= B:
                        break
                    k *= 2
        return timings

    @staticmethod
    def _idle(srv):
        """The warm steps' precondition: an idle, open server, its paged
        pool work pushed."""
        if srv._inflight is not None and not srv._slots and not srv._queue:
            srv._inflight = None       # a drained server's overrun step
        if srv._slots or srv._queue or srv._inflight is not None:
            raise RuntimeError(
                "DecodeServer.warmup() requires an idle server: warm steps "
                "write rows at position 0 of every slot, which only "
                "requests admitted later are sure to overwrite")
        if srv.cache is None:
            raise RuntimeError("the server is closed")
        if srv._paged:
            srv._apply_pool_ops()

    def warm_inject(self, srv, prompt_lens=None) -> dict:
        """Build (on the card: capture) a fleet replica's handoff steps:
        ``inject`` at the bucket of each of ``prompt_lens`` (default every
        bucket up to the serving window), "inject@{bucket}", one zero row
        into slot 0 — so a worker's first rows replay a graph instead of
        capturing one mid-serve.  Same contract as :meth:`warmup`: an idle
        server, its counters left as they were.  Returns {name: seconds}."""
        from . import kv_pool, serving

        self._idle(srv)
        dev = srv.device
        window = min(srv.max_len, srv.cfg.max_seq_len)
        lens = prompt_lens if prompt_lens is not None else [
            1 << i for i in range(window.bit_length() + 1)
            if (1 << i) <= window]
        timings = {}
        with _launch_counts.held():
            for bucket in sorted({serving._pow2_bucket(
                    int(n), srv.max_len, srv.cfg.max_seq_len)
                    for n in lens}):
                rows = [torch.zeros((a.shape[0], 1, bucket)
                                    + tuple(a.shape[3:]),
                                    dtype=a.dtype, device=dev)
                        for a in (srv.cache[n] for n in kv_pool.POOL_LEAVES
                                  if n in srv.cache)]
                t0 = _time.perf_counter()
                self.get("inject", srv._spec(bucket=bucket))(
                    *rows, *srv._scalars(0, 1, 0))
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                timings[f"inject@{bucket}"] = _time.perf_counter() - t0
        return timings


ENGINE = Engine()
