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
  slot), ``inject`` per rows bucket (a spilled prefix chain restored
  into the pool through the block tables), ``spec_verify`` per chunk K
  (the speculative round's one target pass, fed device tokens and
  positions like the ticks), ``spec_tree_verify`` and
  ``spec_tree_commit`` per node budget N (the tree round's pass, its
  topology fed as data, and its row permute), ``generate``'s decode step
  and ``beam``'s position step.  On the CPU every kind runs its plain
  callable.
* :class:`Engine` — the bounded, thread-safe cache (``_LRU``, sized by
  ``PADDLE_TPU_STEP_CACHE_SIZE`` as in the JAX package), ``get``,
  ``purge``, ``warmup`` and the caches ``generate`` binds its steps to
  (:meth:`Engine.generate_binding`).

The one design difference from the JAX Engine: **a graph is bound to
buffers.**  It reads the server's params and cache leaves (the paged
``tables`` leaf included) by address and owns static input and output
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
captures put the cache back as it was after the eager run.  A capture
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
``.tc_launches``, ``.tick_launches``), which a replay does not run: each
graph records the counts its capture added, puts back what its eager and
captured runs added, and adds the recorded counts at every replay — so N
replays count exactly N eager steps' launches.
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
    ``flags.decode_jit_key()``: the routes a captured step bakes in."""
    return (cfg.vocab_size, cfg.hidden_size, cfg.num_layers, cfg.num_heads,
            cfg.num_kv_heads, cfg.max_seq_len, cfg.ffn_ratio, str(cfg.dtype),
            cfg.pos_embed, cfg.norm, cfg.activation,
            _flags.decode_jit_key())


def _param_leaves(params) -> list:
    if isinstance(params, torch.nn.Module):
        return list(params.parameters())
    return [t for n, t in params.items() if n != "blocks"] \
        + list(params["blocks"].values())


class Binding:
    """The buffers a server's steps read and write: its ``params`` and
    ``cache`` (leaves written in place by every step).  ``key`` — the
    device, the graph switch and every leaf's address — is the part of
    the Engine's cache key that keeps one server's graphs from another's.

    ``graphs=False`` runs the steps eagerly on the card: a private switch
    for the card tests, ``chip_smoke.py`` and ``tools/profile_serving``,
    which hold graphs against the eager steps (the JAX server has no
    eager mode either)."""

    def __init__(self, params, cache: dict, graphs: bool = True):
        self.params = params
        self.cache = cache
        # held by a caller driving the binding's steps from its own loop
        # (``generate``), so two threads never interleave on one cache
        self.lock = threading.Lock()
        self.device = cache["k"].device
        self.graphs = bool(graphs) and self.device.type == "cuda"
        self.key = (str(self.device), self.graphs,
                    tuple(t.data_ptr() for t in cache.values()),
                    tuple(t.data_ptr() for t in _param_leaves(params)))


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
    * ``payload`` — the server's :class:`Binding`, never keyed by value
      (the Engine adds its ``key``)."""

    cfg: Any
    paged: bool = False
    bucket: int | None = None
    width: int | None = None
    k: int | None = None
    extra: tuple = ()
    shape: tuple = ()
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
    """Rows written into one slot's pool rows [start, length) through its
    block table (``kv_pool.inject_rows``): (one [L, 1, bucket, Hkv(, hd)]
    rows feed per pool leaf, in ``POOL_LEAVES`` order, start, length,
    slot) -> ().  The server restores a spilled prefix chain with it.
    Paged only: the contiguous twin (the JAX package's
    ``generate._merge_slot_rows``, which only its fleet handoff runs) is
    not ported."""
    from . import kv_pool

    if not spec.paged:
        raise NotImplementedError("the inject step is ported for the paged "
                                  "layout only")

    def body(p, c, *feeds):
        names = [n for n in kv_pool.POOL_LEAVES if n in c]
        *rows, start, length, slot = feeds
        kv_pool.inject_rows(c, dict(zip(names, rows)), start, length, slot)
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


def _set_counts(values) -> None:
    for (w, a), v in zip(_counter_fields(), values):
        setattr(w, a, v)


def _add_counts(delta) -> None:
    for (w, a), d in zip(_counter_fields(), delta):
        if d:
            setattr(w, a, getattr(w, a) + d)


# --------------------------------------------------------------------------
# the two step wrappers
# --------------------------------------------------------------------------


_WARM_RUNS = 1          # eager runs on the capture stream before capture
_GEN_BINDINGS = 4       # generate caches kept (Engine.generate_binding)
_capture_streams: dict = {}


def _capture_stream(device) -> torch.cuda.Stream:
    """One side stream per card for every eager warm run and capture, so
    their per-stream state (the tick ticket buffer, cuBLAS's workspace)
    is made once, outside any capture."""
    s = _capture_streams.get(device)
    if s is None:
        s = _capture_streams[device] = torch.cuda.Stream(device)
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
    replay.  ``delta``: the launch counts one replay stands for.  A
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
        self.replays = 0
        self._keep = ()

    def _capture(self, feeds) -> None:
        from ..ops import decode_attention as da

        dev = self.binding.device
        p, c = self.binding.params, self.binding.cache
        t0 = _time.perf_counter()
        self.static = tuple(torch.empty(f.shape, dtype=f.dtype, device=dev)
                            for f in feeds)
        for buf, f in zip(self.static, feeds):
            buf.copy_(f, non_blocking=True)
        before = _counts()
        side = _capture_stream(dev)
        cur = torch.cuda.current_stream(dev)
        side.wait_stream(cur)
        graph = cost = None
        try:
            with torch.cuda.stream(side):
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
            warm = _counts()
            graph = torch.cuda.CUDAGraph()
            # a failure inside ends the capture on the way out (the
            # context manager's exit); the graph is dropped below.
            # "thread_local": only this thread is barred from syncing
            # calls while it captures.  In the default "global" mode an
            # event wait on any other thread voids the capture — a fetch
            # that the wedge watchdog abandoned (resilience.call_with_
            # budget) wakes and waits on its event, whenever that is.
            with torch.cuda.graph(graph, stream=side,
                                  capture_error_mode="thread_local"):
                # the context has dropped the allocator's free cache: from
                # here the reserved memory grows by the graph's private
                # pool alone (a host query, legal inside a capture)
                reserved = torch.cuda.memory_reserved(dev)
                out = self.body(p, c, *self.static)
        except BaseException:
            cur.wait_stream(side)
            if graph is not None:
                graph.reset()
            self.static = None
            _set_counts(before)
            raise
        cur.wait_stream(side)
        if cost is not None and "count_failed" not in cost:
            cost["temp_bytes"] = max(
                0, torch.cuda.memory_reserved(dev) - reserved)
        self.delta = [a - b for a, b in zip(_counts(), warm)]
        _set_counts(before)
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
        _add_counts(self.delta)
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
        entry = _REGISTRY[kind]
        bind = spec.payload
        if not isinstance(bind, Binding):
            raise TypeError(f"{kind}: StepSpec.payload must be the server's "
                            f"Binding, got {type(bind).__name__}")
        key = entry.key(spec) + (bind.key,)
        fn = self._steps.get(key)
        if fn is None:
            if bind.graphs:
                fn = _Graph(entry.build(spec), bind, entry.name(spec), key,
                            entry.idempotent)
            else:
                fn = _Eager(entry.build(spec), bind, entry.name(spec), key)
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
        for k in self._steps.keys():
            if (not cks or k[1] in cks) and (binding is None
                                             or k[-1] == binding.key):
                fn = self._steps.pop(k, None)
                if fn is not None:
                    _release(fn)
                    dropped += 1
        return dropped

    def warmup(self, srv, prompt_lens=None, blocks=(), sample=False) -> dict:
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
        same widths, on the draft's binding.

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
        counts = _counts()

        def warm(name, kind, *feeds, draft=False, **kw):
            t0 = _time.perf_counter()
            self.get(kind, (srv._dspec if draft else srv._spec)(**kw))(
                *feeds)
            if cuda:
                torch.cuda.synchronize(dev)
            timings[name] = _time.perf_counter() - t0

        try:
            if srv._async:
                warm("async_step", "async_block", zi, zb, pv, zp, k=1)
                if sample:
                    warm("async_sample_step", "async", zi, zb, pv, zp, key,
                         zf, zi, of)
            else:
                warm("step", "step", zi, zp)
                if sample:
                    warm("sample_step", "sample", zi, zp, key, zf, zi, of)
            for k in blocks:
                k = int(k)
                if srv._async:
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
                    warm(f"spec_verify@{K}", "spec_verify",
                         torch.zeros((B, K), dtype=torch.int64), zp, k=K)
                if srv._draft_bind is not None:
                    warm("draft_step", "step", zi, zp, draft=True)
                    if K > 1:
                        warm(f"draft_block{K - 1}", "block", zi, zp,
                             k=K - 1, draft=True)
            for name, kind, width in srv._admission_widths(prompt_lens):
                for draft in drafts:
                    tag = "draft_" + name if draft else name
                    if kind == "prefill":
                        warm(tag, kind, *srv._feeds([0], width, 1, 0),
                             bucket=width, draft=draft)
                    elif kind == "prefill_chunk":
                        warm(tag, kind, *srv._feeds([0], width, 0, 1, 0),
                             width=width, draft=draft)
                    else:
                        warm(tag, kind, *srv._feeds([0], width, 0, 1, 0),
                             bucket=width, draft=draft)
        finally:
            _set_counts(counts)
        return timings


ENGINE = Engine()
