"""Paged KV cache: block pool, block tables, refcounted prefix reuse.

Counterpart of ``paddle_tpu/text/kv_pool.py`` for the paged serving
slice:

* **block pool** — leaves ``[L, N + 1, bs, Hkv, hd]`` (int8 scale planes
  ``[L, N + 1, bs, Hkv]`` ride along as in the contiguous layout) shared
  by every slot.  Blocks ``[0, N)`` belong to the allocator; block ``N``
  is the WRITE SINK (see :func:`_scatter_rows`) and no table ever names
  it;
* **block tables** — an int32 ``[max_batch, nmax]`` leaf mapping each
  slot's logical block to a physical block (-1 = unmapped), pushed from
  the host allocator when it changes;
* **host allocator** (:class:`PagedAllocator`) — the free list,
  refcounts, copy-on-write and the radix prefix index, in plain Python
  and numpy, replaying the JAX package's allocator operation for
  operation, with its telemetry counters (``kv_pool.*``);
* **host-RAM spill tier** (``PADDLE_TPU_KV_SPILL_MB``) — the evict rung
  demotes cold block-aligned prefix chains to pinned host memory
  (:meth:`PagedAllocator.spill_cold`; the caller's one batched gather and
  device-to-host copy a round) instead of dropping them, admission
  restores a spilled chain block by block as its adopt walk descends
  (:meth:`PagedAllocator.take_restores` feeds the caller's
  :func:`inject_rows` step, graphed on the card), and an RSS watchdog
  (``PADDLE_TPU_KV_SPILL_RSS_MB``) releases the oldest spills first.
  The byte accounting against the budget is the JAX package's.  Restores
  and spills never replace a pool tensor: the graphs read the pool by
  address.  Cross-replica chain migration (the fleet's) is not ported.

Device math: :func:`paged_decode_step_batched` (the pooled twin of
``serving.decode_step_batched``), :func:`paged_prefill_chunk` (the
pooled ``generate.prefill_slot_chunk``) and
:func:`paged_verify_chunk_batched` (the pooled
``generate.verify_chunk_batched``) write each layer's fresh rows into
the pool, then attend through the tables — on the card with the
block-table kernel (``ops/decode_attention.paged_decode_attention``),
which reads the pool in place, on the CPU through each slot's gathered
view.  Tree speculation's :func:`paged_tree_verify_chunk_batched` writes
the same way but attends each slot's gathered view under the tree mask
on both devices (the kernel's mask is causal), and
:func:`paged_tree_commit` permutes accepted rows through the tables.
All write in place and return the cache they were given.
"""
from __future__ import annotations

import weakref
import zlib

import numpy as np
import torch

from . import generate, gpt, woq
from .. import flags as _flags
from .. import resolve_device
from .. import telemetry as _telemetry
from ..ops import decode_attention as da

__all__ = [
    "PoolExhausted", "PagedAllocator", "round_len", "init_paged_cache",
    "paged_decode_step_batched", "paged_prefill_chunk",
    "paged_verify_chunk_batched", "paged_tree_verify_chunk_batched",
    "paged_tree_commit", "copy_blocks",
    "inject_rows", "SpillSlots", "prefix_fingerprint",
]

# the value/scale leaves of a pooled cache (everything except "tables")
POOL_LEAVES = ("k", "v", "k_s", "v_s")


class PoolExhausted(RuntimeError):
    """The KV block pool has no free block.  The message carries the JAX
    package's ``RESOURCE_EXHAUSTED`` marker."""

    def __init__(self, need: int = 1, total: int = 0):
        super().__init__(
            f"RESOURCE_EXHAUSTED: KV block pool exhausted "
            f"(need {need} more block(s), pool size {total})")


def round_len(max_len: int, block_size: int) -> int:
    """A paged cache's per-slot logical row count: the contiguous
    layout's rounding (``generate._round_cache_len``), then up to a whole
    number of blocks.  Pick ``block_size`` dividing the contiguous
    length when parity with a contiguous cache of the same window
    matters."""
    T = generate._round_cache_len(max_len)
    bs = int(block_size)
    return -(-T // bs) * bs


def init_paged_cache(cfg: gpt.GPTConfig, batch: int, max_len: int,
                     block_size: int | None = None,
                     num_blocks: int | None = None, device=None) -> dict:
    """The pooled cache (``generate.init_cache(layout="paged")``) on
    ``device`` (default the card): value leaves ``[L, N + 1, bs, Hkv, hd]``
    (+ int8 scale planes ``[L, N + 1, bs, Hkv]``) and an int32 ``tables``
    leaf ``[batch, nmax]`` initialized unmapped (-1).  ``num_blocks`` (N)
    defaults to full provisioning (``batch * nmax``); block N is the
    write sink, outside the allocator's range."""
    bs = _flags.kv_block_size() if block_size is None else int(block_size)
    if bs < 8 or bs % 8:
        raise ValueError(f"block_size {bs}: must be a positive multiple "
                         f"of 8 (the decode kernel's row tile)")
    T = round_len(max_len, bs)
    nmax = T // bs
    N = batch * nmax if num_blocks is None else int(num_blocks)
    if N < 1:
        raise ValueError(f"num_blocks must be >= 1, got {N}")
    dev = resolve_device(device)
    L, H, hd = cfg.num_layers, cfg.kv_heads, cfg.head_dim
    dt = generate._kv_store_dtype(cfg)
    shape = (L, N + 1, bs, H, hd)
    cache = {"k": torch.zeros(shape, dtype=dt, device=dev),
             "v": torch.zeros(shape, dtype=dt, device=dev),
             "tables": torch.full((batch, nmax), -1, dtype=torch.int32,
                                  device=dev)}
    if dt == torch.int8:
        cache["k_s"] = torch.zeros(shape[:-1], dtype=torch.float32,
                                   device=dev)
        cache["v_s"] = torch.zeros(shape[:-1], dtype=torch.float32,
                                   device=dev)
    return cache


def _geometry(cache: dict):
    """(N, block_size, nmax) of a pooled cache: N allocator blocks (the
    pool holds N + 1, the last being the write sink)."""
    return (cache["k"].shape[1] - 1, cache["k"].shape[2],
            cache["tables"].shape[1])


def _layer_pool(cache: dict, l: int) -> dict:
    """Layer ``l``'s pool leaves [N + 1, bs, ...] (contiguous views: writes
    land in the cache, and the kernel takes them without a copy)."""
    return {n: cache[n][l] for n in POOL_LEAVES if n in cache}


def _scatter_rows(pool_l: dict, rows: dict, phys) -> None:
    """Write row leaves [R, Hkv(, hd)] into one layer's pool leaves
    [N + 1, bs, Hkv(, hd)] at flat physical rows ``phys`` [R] — IN PLACE.
    The single row write every paged path funnels through.

    Rows with nowhere to go (an unmapped block, a pad row, a row past
    the table) carry the index of the sink block's first row, N * bs.
    ``index_put_`` has no drop mode (out of range it raises on the CPU
    and asserts on the card), and a boolean mask would sync the host once
    per layer; the sink keeps the write one sync-free scatter.  Several
    rows may land in the sink at once; which one stays does not matter,
    since no table names the sink."""
    for name, val in rows.items():
        arr = pool_l[name]
        flat = arr.view((-1,) + arr.shape[2:])
        flat.index_put_((phys,), val.to(arr.dtype))


def _phys_rows(trows, logi, N: int, bs: int, valid=None):
    """Flat physical row of logical rows ``logi`` [R] through table rows
    ``trows`` [R, nmax] (one table row per written row): the sink row
    N * bs where the block is unmapped, past the table, or ``valid`` is
    False."""
    nmax = trows.shape[1]
    blk = logi // bs
    tb = torch.gather(trows, 1, blk.clamp(max=nmax - 1)[:, None])[:, 0]
    ok = (tb >= 0) & (blk < nmax)
    if valid is not None:
        ok &= valid
    return torch.where(ok, tb.long() * bs + logi % bs,
                       torch.full_like(logi, N * bs))


def _attend_pool_cost(q, pool_l: dict, tables, pos, cfg: gpt.GPTConfig):
    """The device feed's count of :func:`_attend_pool`: the block-table
    kernel's, whichever body runs."""
    return da.paged_decode_attention_cost(q, pool_l["k"], pool_l["v"],
                                          tables, pos, pool_l.get("k_s"))


@_telemetry.counted(_attend_pool_cost)
def _attend_pool(q, pool_l: dict, tables, pos, cfg: gpt.GPTConfig):
    """Cached attention for q [B, Tq, H, hd] through the block tables
    against one layer's pool ``pool_l`` (rows through the current
    positions written): row i of slot b attends logical rows
    t <= pos[b] + i.  Returns [B, Tq, H*hd] in the compute dtype.

    CUDA: the block-table kernel, which reads each slot's mapped blocks
    and nothing else.  CPU: the contiguous path's plain math
    (``generate._attend_cache``) on each slot's gathered view — the JAX
    package's own route off its kernel."""
    B, Tq, H, hd = q.shape
    if pool_l["k"].is_cuda:
        out = da.paged_decode_attention(
            q.contiguous(), pool_l["k"], pool_l["v"], tables, pos,
            k_scale=pool_l.get("k_s"), v_scale=pool_l.get("v_s"))
        return out.to(cfg.dtype).reshape(B, Tq, H * hd)
    view = {n: da.gather_paged_view(v, tables) for n, v in pool_l.items()}
    return generate._attend_cache(q, view, pos, cfg)


@torch.no_grad()
def paged_decode_step_batched(params, cache, token, pos,
                              cfg: gpt.GPTConfig):
    """``serving.decode_step_batched`` on the pooled layout: token [B]
    int, pos int32 [B] (each slot's write position), cache an
    :func:`init_paged_cache` tree -> (logits [B, V] float32, cache).

    Per layer: the fresh rows are scattered into the pool first (through
    the table; a free slot's row goes to the sink), then the layer
    attends through the tables — scatter-then-attend, so this step
    attends exactly what later steps read back (int8 included)."""
    N, bs, _ = _geometry(cache)
    tables = cache["tables"]
    phys = _phys_rows(tables, pos.long(), N, bs)
    x = generate._embed_step(params, token, pos, cfg)
    for l in range(cfg.num_layers):
        p = gpt.layer(params, l)
        pool_l = _layer_pool(cache, l)
        q3, rows = generate._block_pre_attn(x, p, pos, cfg)
        _scatter_rows(pool_l, rows, phys)
        attn = _attend_pool(q3, pool_l, tables, pos, cfg)    # [B, 1, D]
        x = generate._block_post_attn(x, attn, p, cfg)
    x = gpt._norm(x, params, "ln_f", cfg)
    return woq.logits(x, params, cfg.dtype)[:, 0].float(), cache


@torch.no_grad()
def paged_prefill_chunk(params, cache, tokens, pos0, length, slot,
                        cfg: gpt.GPTConfig):
    """``generate.prefill_slot_chunk`` on the pooled layout: one chunk of
    a prompt at positions [pos0, pos0 + C) for one slot; ``pos0``,
    ``length`` and ``slot`` are Python ints or 0-d int tensors on the
    cache's device (a captured step's feeds: the slot's table row is
    gathered, nothing is read on the host).  Per layer, the chunk's valid
    rows scatter through the table first (pads and unmapped entries to
    the sink), then its C rows attend the slot's rows t <= pos0 + i
    through the table (:func:`_attend_pool`: on the card the block-table
    kernel at Tq = C reads the pool in place; on the CPU the slot's
    gathered view) — the scatter-then-attend order of
    :func:`paged_decode_step_batched`.  Returns (logits at the chunk's
    last valid position [V] float32, cache).

    A valid row i < ``length`` sees only rows <= pos0 + i, which the
    caller has made writable (``PagedAllocator.ensure_rows``) and this
    chunk or an earlier one has written, so the pads' rows (in the sink,
    or unmapped) never reach it; the pads' own outputs are discarded.
    With a shared prefix adopted into the table, ``pos0`` starts at the
    first unshared row: the shared blocks are attended but never
    recomputed."""
    N, bs, _ = _geometry(cache)
    dev = tokens.device
    pos0, length, slot = (generate._index(v, dev)
                          for v in (pos0, length, slot))
    trow = cache["tables"].index_select(0, slot.reshape(1))   # [1, nmax]
    C = tokens.shape[1]
    idx = torch.arange(C, device=dev)
    phys = _phys_rows(trow.expand(C, -1), pos0 + idx, N, bs,
                      valid=idx < length)
    pos = pos0.to(torch.int32).reshape(1)
    x = generate._embed_chunk(params, tokens, cfg, pos0)
    for l in range(cfg.num_layers):
        p = gpt.layer(params, l)
        pool_l = _layer_pool(cache, l)
        q, rows = generate._chunk_pre_attn(x, p, pos0, cfg)
        _scatter_rows(pool_l, {n: v[0] for n, v in rows.items()}, phys)
        attn = _attend_pool(q, pool_l, trow, pos, cfg)      # [1, C, D]
        x = generate._block_post_attn(x, attn, p, cfg)
    return generate._last_logits(x, length, params, cfg), cache


@torch.no_grad()
def paged_verify_chunk_batched(params, cache, tokens, pos,
                               cfg: gpt.GPTConfig):
    """``generate.verify_chunk_batched`` on the pooled layout: tokens
    [B, K] int scored at per-slot positions [pos_b, pos_b + K) (``pos``
    int32 [B]) -> (logits [B, K, V] float32, cache).

    Per layer the K rows of every slot scatter through its table first
    (a free slot's, or an unmapped block's, to the sink), then the layer
    attends through the tables — on the card one launch of the
    block-table kernel at Tq = K over the pool in place.  Rows
    [pos_b, pos_b + K) may cross a block boundary: the caller maps them
    all before the step (``DecodeServer._ensure_decode_blocks(K)``).
    Rejected rows stay behind the slot's position pointer, as on the
    contiguous layout."""
    N, bs, nmax = _geometry(cache)
    B, K = tokens.shape
    dev = tokens.device
    pos = generate._positions(pos, B, dev)
    tables = cache["tables"]
    logi = pos.long()[:, None] + torch.arange(K, device=dev)     # [B, K]
    phys = _phys_rows(tables[:, None].expand(B, K, nmax).reshape(B * K,
                                                                nmax),
                      logi.reshape(-1), N, bs)
    x = generate._embed_verify(params, tokens, pos, cfg)
    for l in range(cfg.num_layers):
        p = gpt.layer(params, l)
        pool_l = _layer_pool(cache, l)
        q, rows = generate._chunk_pre_attn(x, p, pos.long()[:, None], cfg)
        _scatter_rows(pool_l, {n: v.reshape((B * K,) + v.shape[2:])
                               for n, v in rows.items()}, phys)
        attn = _attend_pool(q, pool_l, tables, pos, cfg)     # [B, K, D]
        x = generate._block_post_attn(x, attn, p, cfg)
    x = gpt._norm(x, params, "ln_f", cfg)
    return woq.logits(x, params, cfg.dtype).float(), cache


@torch.no_grad()
def paged_tree_verify_chunk_batched(params, cache, tokens, amask, depth, pos,
                                    cfg: gpt.GPTConfig):
    """``generate.tree_verify_chunk_batched`` on the pooled layout: tokens
    [B, N] int (node 0 the feed token), ``amask`` [B, N, N] bool, ``depth``
    [B, N] int, ``pos`` int32 [B] -> (logits [B, N, V] float32, cache).

    The same tree body (``generate._tree_forward``): per layer each slot's
    N rows scatter through its table to logical rows [pos_b, pos_b + N)
    (a free slot's, or an unmapped block's, to the sink), then every node
    attends its slot's gathered view under the tree mask — the einsum on
    both devices, as in the reference (the block-table kernel's mask is
    causal).  The caller maps the N rows first
    (``DecodeServer._ensure_decode_blocks(N)``)."""
    n_blocks, bs, nmax = _geometry(cache)
    B, N = tokens.shape
    dev = tokens.device
    pos = generate._positions(pos, B, dev)
    tables = cache["tables"]
    logi = pos.long()[:, None] + torch.arange(N, device=dev)     # [B, N]
    phys = _phys_rows(tables[:, None].expand(B, N, nmax).reshape(B * N,
                                                                nmax),
                      logi.reshape(-1), n_blocks, bs)

    def write(l, rows):
        _scatter_rows(_layer_pool(cache, l),
                      {n: v.reshape((B * N,) + v.shape[2:])
                       for n, v in rows.items()}, phys)

    def read(l):
        return {n: da.gather_paged_view(v, tables)
                for n, v in _layer_pool(cache, l).items()}

    logits = generate._tree_forward(
        params, tokens, depth, pos,
        generate._tree_visibility(amask, pos, nmax * bs), write, read, cfg)
    return logits, cache


@torch.no_grad()
def paged_tree_commit(cache: dict, src, pos) -> dict:
    """``generate.tree_commit_rows`` on the pooled layout: per slot b the
    pool rows at logical ``pos_b + src[b, i]`` move to logical ``pos_b +
    1 + i``, both sides mapped through the slot's table (``_phys_rows``;
    unmapped destinations go to the sink).  Gathered into a temporary
    before any write, so rows sharing a block cannot alias; identity
    entries rewrite themselves.  The destinations [pos_b + 1, pos_b + M
    + 1) were mapped and split copy-on-write before the round's verify.
    In place, every layer at once; returns the cache."""
    n_blocks, bs, nmax = _geometry(cache)
    B, M = src.shape
    dev = src.device
    trows = cache["tables"][:, None].expand(B, M, nmax).reshape(B * M, nmax)
    base = pos.long()[:, None]
    src_p = _phys_rows(trows, (base + src.long()).reshape(-1), n_blocks, bs)
    dst_p = _phys_rows(trows, (base + 1 + torch.arange(M, device=dev))
                       .reshape(-1), n_blocks, bs)
    for name in POOL_LEAVES:
        if name in cache:
            arr = cache[name]
            flat = arr.view((arr.shape[0], -1) + arr.shape[3:])
            flat.index_copy_(1, dst_p, flat.index_select(1, src_p))
    return cache


@torch.no_grad()
def copy_blocks(cache: dict, src, dst) -> dict:
    """Copy physical blocks ``src`` -> ``dst`` (int [P]) across every
    pool leaf and layer, in place — the device half of copy-on-write.
    Destinations are freshly allocated (never in ``src``), and the
    source rows are gathered before any write, so there is no ordering
    hazard."""
    for name in POOL_LEAVES:
        if name in cache:
            arr = cache[name]
            arr[:, dst] = arr[:, src]
    return cache


@torch.no_grad()
def inject_rows(cache: dict, rows: dict, start, length, slot) -> dict:
    """Write externally held cache rows into one slot's rows [start,
    length) through its block table, in place — the restore of a spilled
    prefix chain (and, in the JAX package, the fleet handoff's decode
    half).  ``rows``: leaves ``[L, 1, C, Hkv(, hd)]`` by pool leaf name
    (the int8 scale planes too), holding the slot's logical rows [0, C);
    ``start``, ``length`` and ``slot`` are ints or 0-d / [1] int tensors
    (a captured step's feeds).  Rows outside [start, length), past the
    table or in an unmapped block go to the sink block; the caller has
    made the write range writable (``PagedAllocator.ensure_rows``, or a
    restore's fresh block).  One ``index_copy_`` a leaf, across every
    layer at once.  Returns the cache it was given."""
    N, bs, _ = _geometry(cache)
    dev = cache["k"].device
    start, length, slot = (generate._index(v, dev)
                           for v in (start, length, slot))
    C = rows["k"].shape[2]
    trow = cache["tables"].index_select(0, slot.reshape(1))   # [1, nmax]
    logi = torch.arange(C, device=dev)
    phys = _phys_rows(trow.expand(C, -1), logi, N, bs,
                      valid=(logi >= start) & (logi < length))
    for name in POOL_LEAVES:
        if name in cache:
            arr = cache[name]
            flat = arr.view((arr.shape[0], -1) + arr.shape[3:])
            flat.index_copy_(1, phys, rows[name][:, 0].to(arr.dtype))
    return cache


# ---------------------------------------------------------------------------
# host allocator: free list + refcounts + radix prefix index
# ---------------------------------------------------------------------------


def _read_rss_bytes() -> int:
    """Current process resident set in bytes — ``/proc/self/statm``
    (field 2, pages) on Linux, ``getrusage`` peak RSS as the portable
    fallback, 0 when neither is readable (the watchdog disarms rather
    than guessing)."""
    try:
        with open("/proc/self/statm", "rb") as f:
            pages = int(f.read().split()[1])
        import resource

        return pages * resource.getpagesize()
    except (OSError, ValueError, IndexError, ImportError):
        try:
            import resource

            # ru_maxrss is KiB on Linux: a conservative upper bound, the
            # safe direction for a pressure watchdog
            return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss << 10
        except Exception:
            return 0


class SpillSlots:
    """Host memory for the spill tier, pinned once: one slot a KV block
    (every pool leaf's rows, ``[L, bs, Hkv(, hd)]`` each), as many slots
    as ``limit_bytes`` holds whole.  Pinning fresh host memory is the slow
    part of a device-to-host copy (page locking ran at about 1 GB/s:
    3.5 ms a 3 MiB GPT-1.3B block, against ~0.1 ms for the copy, in
    ``chip_smoke.py``'s pressure phase on an H100 80GB HBM3 host), so the
    server pins the tier's budget when it is built and no spill pays it.
    :meth:`take` hands out a record of views into one free slot; the slot
    returns to the free list when the record's first view dies — its
    views live and die together in the record's dict, which the
    allocator drops on a restore, a release or a replacement.  Without
    ``pin`` (a CPU server) the memory is ordinary."""

    def __init__(self, cache: dict, limit_bytes: int, pin: bool):
        self._layout = []
        off = 0
        for name in POOL_LEAVES:
            if name in cache:
                arr = cache[name]
                shape = (arr.shape[0],) + tuple(arr.shape[2:])
                nb = arr.element_size() * int(np.prod(shape))
                self._layout.append((name, shape, arr.dtype, off, nb))
                off += -(-nb // 64) * 64         # 64-byte aligned leaves
        self.slot_bytes = off
        n = int(limit_bytes) // self.slot_bytes
        self._buf = torch.empty(n * self.slot_bytes, dtype=torch.uint8,
                                pin_memory=pin)
        self._free = list(range(n - 1, -1, -1))

    @property
    def free(self) -> int:
        return len(self._free)

    def take(self):
        """A record of views into a free slot ({leaf: [L, bs, ...]}), or
        None when every slot holds a record."""
        if not self._free:
            return None
        i = self._free.pop()
        base = i * self.slot_bytes
        rec = {name: self._buf[base + off:base + off + nb].view(dt)
               .view(shape) for name, shape, dt, off, nb in self._layout}
        weakref.finalize(rec[self._layout[0][0]], self._free.append, i)
        return rec


def prefix_fingerprint(tokens) -> int:
    """Deterministic fingerprint of a token run, equal to the JAX
    package's (crc32 over the int64 bytes — Python's ``hash()`` is salted
    per process), for prefix-aware routing across replicas."""
    return zlib.crc32(np.asarray(tuple(tokens), np.int64).tobytes())


class _PrefixEntry:
    """One indexed radix node: the physical pool block, its LRU clock,
    its position in the interned tree (``key`` = the intern-table key
    ``(parent chain id, token run)``, ``parent`` = the previous node's
    chain id, 0 at the root) and ``end`` — the cumulative token count of
    the chain through this node.  A node's run never crosses a block
    boundary, and its block holds valid rows for in-block offsets
    ``[0, end - 1 mod bs]`` — split siblings share a block precisely
    because their common rows are identical."""

    __slots__ = ("block", "last_hit", "key", "parent", "end")

    def __init__(self, block: int, tick: int, key, parent: int,
                 end: int):
        self.block = block
        self.last_hit = tick
        self.key = key
        self.parent = parent
        self.end = end


class PagedAllocator:
    """Host-side block accounting for one pooled cache: the free list,
    per-block refcounts, the per-slot table mirror (pushed to the device
    leaf when ``dirty``), pending copy-on-write copies, and the prefix
    index.

    Prefix identity is an interned parent-id RADIX tree: a node's chain
    id is interned under ``(parent_chain_id, token_run)`` where the run
    never crosses a block boundary, and siblings under one parent always
    diverge on their first token (``_children`` maps parent ->
    {first token -> child id}).  A prompt sharing only part of a node's
    run SPLITS the node (:meth:`_split_entry`): a new parent takes the
    shared tokens and an extra refcount on the SAME physical block; the
    adopter's first divergent write copies the block through the normal
    copy-on-write drain.

    The index holds its own reference on every registered block (one
    per node — split siblings stack refs on a shared block, mirrored in
    ``_blk_ents``), so a retired request's prefix blocks survive for the
    next request until :meth:`evict_cold` / :meth:`spill_cold` (the OOM
    ladder's first rung) or :meth:`close` releases them.  With
    ``PADDLE_TPU_KV_SPILL_MB`` set, :meth:`spill_cold` demotes cold
    block-aligned chains to host memory instead of dropping them and
    :meth:`adopt_prefix` restores them on the next match — the restore
    rows ride :meth:`take_restores` to the caller's :func:`inject_rows`
    step."""

    def __init__(self, num_blocks: int, block_size: int, nmax: int,
                 max_batch: int):
        if num_blocks < 1:
            raise ValueError(f"num_blocks must be >= 1, got {num_blocks}")
        self.N = int(num_blocks)
        self.bs = int(block_size)
        self.nmax = int(nmax)
        self.max_batch = int(max_batch)
        self.tables = np.full((max_batch, nmax), -1, np.int32)
        # pop() takes from the end: ids ascending-on-pop, deterministic
        self._free = list(range(self.N - 1, -1, -1))
        self._ref = np.zeros(self.N, np.int64)
        self._blk_ents = np.zeros(self.N, np.int64)  # index entries per block
        self._prefix: dict = {}              # chain id -> _PrefixEntry
        self._interned: dict = {}            # (parent id, run) -> chain id
        self._children: dict = {}            # chain id -> {tok0 -> child id}
        self._next_chain = 1                 # 0 is the root sentinel
        self._pending_copies: list = []      # [(src, dst)] for copy_blocks
        self._tick = 0                       # LRU clock for the index
        self.dirty = True                    # tables need a device push
        self.radix_on = _flags.kv_radix()
        self.restore_on = _flags.kv_restore()
        self.spill_limit_bytes = _flags.kv_spill_mb() << 20
        self.spill_batch = _flags.kv_spill_batch()
        self.rss_limit_bytes = _flags.kv_spill_rss_mb() << 20
        self._spilled: dict = {}   # full chain tokens -> (host rows, nbytes)
        self._pending_restores: list = []    # [(slot, start, rows, block)]
        # host mirrors of the telemetry counters
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.cow_copies = 0
        self.peak_blocks_in_use = 0
        self.radix_splits = 0
        self.spilled_blocks = 0
        self.restored_blocks = 0
        self.host_spill_bytes = 0
        self.rss_spills = 0

    # -- pool accounting ----------------------------------------------------

    @property
    def blocks_in_use(self) -> int:
        return self.N - len(self._free)

    def _alloc_block(self) -> int:
        """One block off the free list (ref 1) — every allocation path
        funnels through here."""
        if not self._free:
            raise PoolExhausted(1, self.N)
        b = self._free.pop()
        self._ref[b] = 1
        _telemetry.count("kv_pool.blocks_allocated")
        self.peak_blocks_in_use = max(self.peak_blocks_in_use,
                                      self.blocks_in_use)
        return b

    def _decref_free(self, b: int) -> None:
        """Drop one reference; a block reaching zero returns to the free
        list — the single release path.  Pending copies whose destination
        just died are discarded with it: a stale (src, dst) surviving
        into a later drain could copy into a REALLOCATED dst.  Undrained
        restores into it go the same way."""
        self._ref[b] -= 1
        if self._ref[b] < 0:
            raise AssertionError(f"block {b} refcount went negative")
        if self._ref[b] == 0:
            self._free.append(b)
            if self._pending_copies:
                self._pending_copies = [p for p in self._pending_copies
                                        if p[1] != b]
            if self._pending_restores:
                self._pending_restores = [r for r in self._pending_restores
                                          if r[3] != b]
            _telemetry.count("kv_pool.blocks_freed")

    def _cow_block(self, slot: int, li: int) -> int:
        """Copy-on-write: the slot is about to write into a block another
        holder (a slot or the prefix index) also references — allocate a
        fresh block, queue the device copy, remap the table entry, and
        drop the shared reference."""
        src = int(self.tables[slot, li])
        dst = self._alloc_block()
        self._pending_copies.append((src, dst))
        self.tables[slot, li] = dst
        self._decref_free(src)
        self.dirty = True
        self.cow_copies += 1
        _telemetry.count("kv_pool.cow_copies")
        return dst

    def ensure_rows(self, slot: int, start: int, stop: int) -> None:
        """Make rows [start, stop) of ``slot`` writable: allocate
        unmapped logical blocks, copy-on-write shared ones.  Raises
        :exc:`PoolExhausted` when the free list runs dry; row indices
        clamp to the slot's logical window."""
        if stop <= start:
            return
        lo = max(0, start // self.bs)
        hi = min(self.nmax - 1, (stop - 1) // self.bs)
        for li in range(lo, hi + 1):
            b = int(self.tables[slot, li])
            if b < 0:
                self.tables[slot, li] = self._alloc_block()
                self.dirty = True
            elif self._ref[b] > 1:
                self._cow_block(slot, li)

    def free_slot(self, slot: int) -> None:
        """Retire a slot: every mapped block loses the slot's reference
        (prefix-indexed blocks stay resident under the index's own
        ref)."""
        for li in range(self.nmax):
            b = int(self.tables[slot, li])
            if b >= 0:
                self._decref_free(b)
        self.tables[slot] = -1
        self.dirty = True

    def take_copies(self) -> list:
        """Drain the pending copy-on-write (src, dst) pairs for
        :func:`copy_blocks`."""
        out, self._pending_copies = self._pending_copies, []
        return out

    # -- radix prefix index -------------------------------------------------

    def adopt_prefix(self, slot: int, prompt) -> int:
        """Map the longest indexed TOKEN prefix of ``prompt`` into
        ``slot``'s table (one incref per mapped block) and return the
        shared row count, capped at ``len(prompt) - 1`` so admission
        always computes at least the last token's logits (a fully shared
        prompt copies its final block on that one-row write).

        The walk descends the radix tree one node per step; a node
        matching only partially is SPLIT at the divergence point
        (``PADDLE_TPU_KV_RADIX``) so the shared head still adopts; a
        missing child may instead be RESTORED from the host spill tier
        (:meth:`_restore_spilled`).  Hits/misses count in TOKEN rows."""
        n = len(prompt)
        self._tick += 1
        matched = 0
        parent = 0
        deepest = {}                 # block index -> deepest node's block
        while matched < n:
            cid = self._children.get(parent, {}).get(prompt[matched])
            if cid is None and self.restore_on:
                cid = self._restore_spilled(slot, parent, prompt, matched)
            if cid is None:
                break
            ent = self._prefix[cid]
            run = ent.key[1]
            lim = min(len(run), n - matched)
            m = 0
            while m < lim and run[m] == prompt[matched + m]:
                m += 1
            if m == len(run):
                ent.last_hit = self._tick
                matched += m
                deepest[(ent.end - 1) // self.bs] = ent.block
                parent = cid
                continue
            # partial match: split iff it buys adoptable rows
            if self.radix_on and m and min(matched + m, n - 1) > matched:
                scid = self._split_entry(cid, m)
                sent = self._prefix[scid]
                sent.last_hit = self._tick
                matched += m
                deepest[(sent.end - 1) // self.bs] = sent.block
            break
        for bi, b in deepest.items():
            self._ref[b] += 1
            self.tables[slot, bi] = b
        if deepest:
            self.dirty = True
        shared = min(matched, n - 1)
        if shared > 0:
            self.prefix_hits += shared
            _telemetry.count("kv_pool.prefix_hits", shared)
        missed = (n - 1) - shared
        if missed > 0:
            self.prefix_misses += missed
            _telemetry.count("kv_pool.prefix_misses", missed)
        return shared

    def register_prefix(self, slot: int, prompt) -> None:
        """Index ``slot``'s full prompt blocks for future sharing (the
        index takes its own reference per node).  The owner never
        rewrites a full prompt block — decode writes start at
        ``len(prompt)`` — so registered blocks are immutable until
        released; partial tail blocks are never registered.  The walk
        descends existing nodes, splits at mid-run divergence (the new
        sibling is backed by the slot's own block) and interns the
        remainder one block-run per node."""
        self._tick += 1
        n_full = (len(prompt) // self.bs) * self.bs
        off = 0
        parent = 0
        while off < n_full:
            b = int(self.tables[slot, off // self.bs])
            if b < 0:
                break
            stop = (off // self.bs + 1) * self.bs
            run = tuple(prompt[off:stop])
            cid = self._children.get(parent, {}).get(run[0])
            if cid is None:
                key = (parent, run)
                cid = self._next_chain
                self._next_chain += 1
                self._interned[key] = cid
                self._prefix[cid] = _PrefixEntry(b, self._tick, key,
                                                 parent, stop)
                self._children.setdefault(parent, {})[run[0]] = cid
                self._blk_ents[b] += 1
                self._ref[b] += 1
                parent = cid
                off = stop
                continue
            ent = self._prefix[cid]
            erun = ent.key[1]
            # a node's run never crosses a block boundary, so erun fits
            # inside run's remainder
            m = 0
            while m < len(erun) and erun[m] == run[m]:
                m += 1
            if m == len(erun):
                ent.last_hit = self._tick
                parent = cid
                off += m
                continue
            if not (self.radix_on and m):
                # block-granular baseline: a mid-run divergence is a stop
                break
            parent = self._split_entry(cid, m)
            self._prefix[parent].last_hit = self._tick
            off += m

    def _split_entry(self, cid: int, m: int) -> int:
        """Split an indexed node at run offset ``m``: a new parent node
        takes tokens ``[:m]`` and an extra refcount on the SAME physical
        block (rows up to the split point are identical by the chain
        invariant), while the deep node keeps its chain id with tokens
        ``[m:]`` — its descendants' parent pointers stay valid.  No device
        copy happens here: the first writer adopting the split node sees
        the stacked refcount and copies through the normal COW drain.
        Returns the new parent's chain id."""
        ent = self._prefix[cid]
        run = ent.key[1]
        parent = ent.parent
        skey = (parent, run[:m])
        scid = self._next_chain
        self._next_chain += 1
        self._interned[skey] = scid
        self._prefix[scid] = _PrefixEntry(ent.block, self._tick, skey,
                                          parent,
                                          ent.end - (len(run) - m))
        self._blk_ents[ent.block] += 1
        self._ref[ent.block] += 1
        # re-key the deep node under the split node (same cid)
        del self._interned[ent.key]
        ent.key = (scid, run[m:])
        ent.parent = scid
        self._interned[ent.key] = cid
        self._children.setdefault(parent, {})[run[0]] = scid
        self._children[scid] = {run[m]: cid}
        self.radix_splits += 1
        _telemetry.count("kv_pool.radix_splits")
        return scid

    @property
    def prefix_entries(self) -> int:
        return len(self._prefix)

    def _drop_entry(self, cid: int) -> None:
        """Remove one index entry plus its intern record (and its
        parent's child-map slot) — the single removal path eviction and
        close share."""
        ent = self._prefix.pop(cid)
        self._interned.pop(ent.key, None)
        pm = self._children.get(ent.parent)
        if pm is not None:
            tok0 = ent.key[1][0]
            if pm.get(tok0) == cid:
                del pm[tok0]
            if not pm:
                del self._children[ent.parent]
        self._blk_ents[ent.block] -= 1
        self._decref_free(ent.block)

    def _cold_leaves(self, max_entries: int | None) -> list:
        """Eviction candidates: tree LEAVES no live slot references,
        coldest (LRU) first.  "No slot references" means every ref on the
        block is index-held (``_blk_ents``); only leaves are candidates
        because dropping an inner node would orphan its descendants."""
        cold = sorted(
            (ent.last_hit, cid) for cid, ent in self._prefix.items()
            if self._ref[ent.block] == self._blk_ents[ent.block]
            and not self._children.get(cid))
        return cold if max_entries is None else cold[:max_entries]

    def evict_cold(self, max_entries: int | None = None) -> int:
        """Drop cold prefix-cache leaves — the OOM ladder's first rung
        with the spill tier off, and admission's last resort before
        parking a request.  Returns the number of entries dropped.  A
        cold inner block's whole subtree is cold too, so repeated
        engagements drain chains tail-first."""
        freed = 0
        for _, cid in self._cold_leaves(max_entries):
            self._drop_entry(cid)
            freed += 1
        if freed:
            _telemetry.count("kv_pool.prefix_evictions", freed)
        return freed

    # -- host-RAM spill tier ------------------------------------------------

    def _chain_tokens(self, cid: int) -> tuple:
        """Full token chain of a node, root to ``cid`` — the spill-store
        key.  Parents are always live: only childless nodes are dropped."""
        parts = []
        while cid:
            ent = self._prefix[cid]
            parts.append(ent.key[1])
            cid = ent.parent
        return tuple(t for run in reversed(parts) for t in run)

    def spill_cold(self, max_entries: int | None = None,
                   fetch=None) -> int:
        """The evict rung, spill-aware: demote cold block-aligned leaf
        chains to host memory before freeing their blocks.  ``fetch`` (the
        caller's one batched read of the pool leaves) is called once a
        round with the block list and returns one record a block,
        ``{leaf: [L, bs, ...]}`` of host tensors — where
        the JAX allocator's fetch returns ``{leaf: [L, P, bs, ...]}`` and
        keeps ``leaf[:, j]``: the server's records are slots of its pinned
        :class:`SpillSlots`, not views of one batch.  Entries outside the
        spill contract (mid-block
        split remnants, blocks with undrained copies or restores, past
        ``PADDLE_TPU_KV_SPILL_BATCH`` or the ``PADDLE_TPU_KV_SPILL_MB``
        budget) drop as :meth:`evict_cold` drops them.  Returns the
        entries freed."""
        if fetch is None or not self.spill_limit_bytes:
            return self.evict_cold(max_entries)
        cold = self._cold_leaves(max_entries)
        if not cold:
            return 0
        # blocks whose device rows are not written yet: pending copy
        # destinations and restore targets — spilling one would keep
        # garbage
        pend = {d for _, d in self._pending_copies}
        pend.update(r[3] for r in self._pending_restores)
        spill, drop = [], []
        for _, cid in cold:
            ent = self._prefix[cid]
            if (len(spill) < self.spill_batch and ent.end % self.bs == 0
                    and ent.block not in pend):
                spill.append(cid)
            else:
                drop.append(cid)
        if spill:
            recs = fetch([self._prefix[cid].block for cid in spill])
            kept = 0
            for rec, cid in zip(recs, spill):
                nb = sum(a.numel() * a.element_size() for a in rec.values())
                key = self._chain_tokens(cid)
                old = self._spilled.pop(key, None)
                if old is not None:
                    self.host_spill_bytes -= old[1]
                if self.host_spill_bytes + nb > self.spill_limit_bytes:
                    self._drop_entry(cid)    # over budget: plain drop
                    continue
                self._spilled[key] = (rec, nb)
                self.host_spill_bytes += nb
                self._drop_entry(cid)
                kept += 1
            if kept:
                self.spilled_blocks += kept
                _telemetry.count("kv_pool.spilled_blocks", kept)
        for cid in drop:
            self._drop_entry(cid)
        freed = len(spill) + len(drop)
        if freed:
            _telemetry.count("kv_pool.prefix_evictions", freed)
        return freed

    def rss_watchdog(self, rss_bytes: int | None = None) -> int:
        """Host-memory relief (``PADDLE_TPU_KV_SPILL_RSS_MB``): over the
        threshold, release up to ``spill_batch`` entries — the OLDEST
        spilled chains first (insertion order is spill order), then cold
        index leaves through :meth:`evict_cold`.  ``rss_bytes`` overrides
        the ``/proc`` read.  Returns entries released; counts
        ``kv_pool.rss_spills``."""
        if not self.rss_limit_bytes:
            return 0
        rss = _read_rss_bytes() if rss_bytes is None else int(rss_bytes)
        if rss <= self.rss_limit_bytes:
            return 0
        freed = 0
        while self._spilled and freed < self.spill_batch:
            key = next(iter(self._spilled))
            _, nb = self._spilled.pop(key)
            self.host_spill_bytes -= nb
            freed += 1
        if freed < self.spill_batch:
            freed += self.evict_cold(self.spill_batch - freed)
        if freed:
            self.rss_spills += freed
            _telemetry.count("kv_pool.rss_spills", freed)
        return freed

    def _restore_spilled(self, slot: int, parent: int, prompt,
                         matched: int):
        """Adoption's promotion of one spilled chain block: re-intern the
        node on a fresh block (the index's reference) and queue its host
        rows for the caller's :func:`inject_rows` step
        (:meth:`take_restores`).  Chains restore block by block as the
        adopt walk descends.  Returns the new chain id, or None when
        nothing matches."""
        if not self._spilled or not self._free or matched % self.bs:
            return None
        end = matched + self.bs
        if end > len(prompt):
            return None
        item = self._spilled.pop(tuple(prompt[:end]), None)
        if item is None:
            return None
        rec, nb = item
        self.host_spill_bytes -= nb
        b = self._alloc_block()              # the index's own ref
        run = tuple(prompt[matched:end])
        key = (parent, run)
        cid = self._next_chain
        self._next_chain += 1
        self._interned[key] = cid
        self._prefix[cid] = _PrefixEntry(b, self._tick, key, parent, end)
        self._children.setdefault(parent, {})[run[0]] = cid
        self._blk_ents[b] += 1
        self._pending_restores.append((slot, matched, rec, b))
        self.restored_blocks += 1
        _telemetry.count("kv_pool.restored_blocks")
        return cid

    def take_restores(self) -> list:
        """Drain the pending restores ``(slot, start_row, rows, block)``
        for the caller's inject step (``serving._drain_restores``)."""
        out, self._pending_restores = self._pending_restores, []
        if out:
            _telemetry.count("kv_pool.restore_drains")
        return out

    def close(self) -> None:
        """Release the whole index, every table and the spill store
        (server shutdown)."""
        for cid in list(self._prefix):
            if cid in self._prefix:
                self._drop_entry(cid)
        for slot in range(self.max_batch):
            if (self.tables[slot] >= 0).any():
                self.free_slot(slot)
        self._spilled.clear()
        self._pending_restores.clear()
        self.host_spill_bytes = 0

    def stats(self) -> dict:
        """The JAX allocator's stats, key for key (cross-replica chain
        migration is not ported: ``chain_migrations`` stays 0)."""
        return {
            "num_blocks": self.N, "block_size": self.bs,
            "blocks_in_use": self.blocks_in_use,
            "peak_blocks_in_use": self.peak_blocks_in_use,
            "prefix_entries": self.prefix_entries,
            "prefix_hits": self.prefix_hits,
            "prefix_misses": self.prefix_misses,
            "cow_copies": self.cow_copies,
            "radix_splits": self.radix_splits,
            "spilled_blocks": self.spilled_blocks,
            "restored_blocks": self.restored_blocks,
            "spilled_entries": len(self._spilled),
            "host_spill_bytes": self.host_spill_bytes,
            "chain_migrations": 0,
        }
