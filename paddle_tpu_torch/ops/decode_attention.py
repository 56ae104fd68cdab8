"""Decode attention, contiguous and paged, and the quantized-KV helpers:
the hand-written Hopper kernels and their plain PyTorch twins.

Counterpart of ``paddle_tpu/ops/decode_attention.py``.  The Pallas
kernels become CUDA sources that share three bodies, each written over
where cache row t of batch row b lives (a contiguous cache or a block
table) — the note atop each says what bounds it and how it is laid out:
at a tick's widths (R = Tq·G < ``R_TC``) the tick body of
``csrc/decode_tick.cuh``; at admission-chunk widths with bf16 q over a
bf16 or int8 cache the tensor-core body of ``csrc/decode_chunk_tc.cuh``
(``csrc/attn_tc.cuh``'s tiles); otherwise (fp32) the split-KV body of
``csrc/split_kv.cuh``:

* ``_decode_call`` -> ``csrc/decode_attention.cu``, a contiguous cache
  [B, T, Hkv, hd] (:func:`route`);
* ``_paged_call`` -> ``csrc/paged_decode_attention.cu``, a block pool
  [N, bs, Hkv, hd] read in place through per-slot block tables
  (:func:`paged_route`).

``quantize_kv`` / ``dequantize_kv`` are THE int8 cache format, as in the
JAX package.

:func:`decode_attention` and :func:`paged_decode_attention` take a CPU
tensor to the plain twin and launch the kernel for a CUDA tensor, raising
on what the kernel does not take — there is no fallback.
"""
from __future__ import annotations

import ctypes

import torch

from .. import telemetry as _telemetry
from . import _build, _counts

_NEG = -1e30
_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_HEAD_DIMS = (64, 128, 256)
_R_CAP = 1024   # query rows (Tq * G) per kv head, the JAX kernels' cap
_BT = 64        # cache rows per kernel tile; a split is a multiple of it
_TARGET_CTAS = 264   # two CTAs per SM on a 132-SM card
_SMS = 132           # SMs of an H100 SXM
_TC_ROWS = 64        # packed query rows per tensor-core CTA (attn_tc kBM)
_TC_MIN_CHUNK = 512  # cache rows a tensor-core split walks at least
# CTAs the tick route's plan aims at (8 an SM: a tick's splits past a
# slot's frontier return at once, so about half of them work)
_TICK_CTAS = 8 * _SMS
# The least R = Tq * G that takes the tensor-core route: the smallest R, not
# below 16, at which it beat the split-KV body in a sweep on an H100
# (B = 1, T = 512, bf16, R = 8..512: it won at every width, 0.020 against
# 0.055 ms at R = 16; tools/sweep_decode_routes.py, PERF.md).  Below it
# the tick body runs; against that body the same sweep puts the crossing
# between R = 8 and 12 (PERF.md, PR 8).  Read at every launch.
R_TC = 16


def quantize_kv(x):
    """Symmetric per-(..., head) int8 over the trailing head_dim axis:
    returns (q int8 like x, scale float32 of x.shape[:-1])."""
    xf = x.float()
    s = torch.clamp_min(xf.abs().amax(dim=-1), 1e-8) / 127.0
    q = torch.clamp(torch.round(xf / s[..., None]), -127, 127)
    return q.to(torch.int8), s


def dequantize_kv(q, s, dt):
    """Inverse of quantize_kv, in fp32 then cast to ``dt``."""
    return (q.float() * s[..., None]).to(dt)


def _plain_decode(q, k, v, pos, k_scale, v_scale, scale):
    """Grouped-query cached attention in plain PyTorch (the counterpart of
    the JAX package's ``_xla_decode``): q [B, Tq, Hq, hd], cache
    [B, T, Hkv, hd] (+ scales for int8), mask t <= pos[b] + i for q row i,
    fp32 softmax, out in q.dtype."""
    B, Tq, Hq, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = scale if scale is not None else 1.0 / (hd ** 0.5)
    kf, vf = k.float(), v.float()
    if k_scale is not None:
        kf = kf * k_scale[..., None]
        vf = vf * v_scale[..., None]
    qg = q.reshape(B, Tq, Hkv, G, hd).float()
    s = torch.einsum("bikgd,btkd->bkgit", qg, kf) * scale
    t = torch.arange(T, device=q.device)
    i = torch.arange(Tq, device=q.device)
    pos = pos.to(q.device).reshape(B, 1, 1, 1, 1)
    mask = t[None, :] <= pos + i[:, None]            # [B, 1, 1, Tq, T]
    s = torch.where(mask, s, torch.full_like(s, _NEG))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgit,btkd->bikgd", w, vf)
    return out.reshape(B, Tq, Hq, hd).to(q.dtype)


def route(R: int, q_dtype, hd: int, kv_dtype=torch.bfloat16) -> str:
    """Which body a contiguous ``decode_attention`` launch of R = Tq * G
    packed query rows per kv head takes: "tick" (``csrc/decode_tick.cuh``)
    below ``R_TC``, for every dtype; from ``R_TC`` on, "tc" (the wgmma
    body of ``csrc/attn_tc.cuh``) for bf16 q over a bf16 or int8 cache,
    else "split" (the split-KV body of ``csrc/split_kv.cuh``: fp32 q or
    cache).  The C entry takes the same decision from the same inputs and
    ``R_TC``."""
    if q_dtype not in _Q_DTYPES or kv_dtype not in _KV_DTYPES \
            or hd not in _HEAD_DIMS:
        raise ValueError(f"decode_attention: no route for q {q_dtype}, "
                         f"cache {kv_dtype}, head_dim {hd}")
    if R < R_TC:
        return "tick"
    tc = q_dtype == torch.bfloat16 and kv_dtype != torch.float32
    return "tc" if tc else "split"


def paged_route(R: int, q_dtype, hd: int, kv_dtype=torch.bfloat16) -> str:
    """Which body a ``paged_decode_attention`` launch takes: the same as
    :func:`route` for a contiguous cache — "tick" below ``R_TC``, then
    "tc" (``csrc/decode_chunk_tc.cuh``, the pool read in place) for bf16
    q over a bf16 or int8 pool, else "split" — each body over the block
    tables.  The paged C entry takes the same decision from the same
    inputs and ``R_TC``."""
    return route(R, q_dtype, hd, kv_dtype)


def tick_rows(R: int) -> int:
    """Query rows one CTA of the tick route holds (``RT`` in
    csrc/decode_tick.cuh): 1 for a lone row, else 4."""
    return 1 if R == 1 else 4


def tick_plan(B: int, Hkv: int, T: int, R: int):
    """(chunk, nsplit) of the tick route: one CTA per (tile of
    :func:`tick_rows` query rows, split, kv head, batch row), the T walk
    cut into splits of ``chunk`` rows (a multiple of 64) so that the CTAs
    number about ``_TICK_CTAS`` — sized on the cache length, not on pos,
    which is on the card; splits past a slot's frontier return at once."""
    tiles = -(-T // _BT)
    cells = B * Hkv * -(-R // tick_rows(R))
    want = max(1, min(tiles, -(-_TICK_CTAS // cells)))
    chunk = -(-tiles // want) * _BT
    return chunk, -(-T // chunk)


def tc_split_plan(B: int, Hkv: int, T: int, R: int):
    """(chunk, nsplit) of the tensor-core route: one CTA per (64-row tile
    of the R rows, split, kv head, batch row).  The cache walk is split
    only when the (row tiles x Hkv x B) CTAs are fewer than the card's
    132 SMs, into about as many splits as fill it — but no split walks
    fewer than ``_TC_MIN_CHUNK`` rows: a split's partial sums cost a pass
    of split_kv.cuh's combine kernel, which the sweep (PERF.md) found
    dearer than a CTA walking a 512-row cache alone.  A split is a
    multiple of the 64-row key tile."""
    tiles = -(-T // _BT)
    cells = B * Hkv * -(-R // _TC_ROWS)
    want = 1 if cells >= _SMS else min(-(-_SMS // cells),
                                       max(1, tiles // (_TC_MIN_CHUNK // _BT)))
    chunk = -(-tiles // want) * _BT
    return chunk, -(-T // chunk)


def row_tile(hd: int) -> int:
    """Query rows one CTA holds (``kRT`` in csrc/split_kv.cuh): 64, or 32
    at hd 256, where a 64-row tile would not fit in shared memory."""
    return 32 if hd > 128 else 64


def split_plan(B: int, Hkv: int, T: int, R: int = 1, hd: int = 128):
    """(chunk, nsplit): cut the T walk into splits of ``chunk`` rows (a
    multiple of the kernel's 64-row tile) so that the CTAs — one per
    (query tile of the R rows, split, kv head, batch row) — fill the card
    about twice over; splits past a row's frontier exit at once, so the
    plan is sized on the cache length, not on pos."""
    tiles = -(-T // _BT)
    cells = max(1, B * Hkv * -(-R // row_tile(hd)))
    want = max(1, min(tiles, -(-_TARGET_CTAS // cells)))
    chunk = -(-tiles // want) * _BT
    return chunk, -(-T // chunk)


def _check(q, k, v, pos, k_scale, v_scale, tables=None):
    """Refuse what the kernels do not take.  k/v are a contiguous cache
    [B, T, Hkv, hd] or, with ``tables`` [B, nmax] int32, a pool
    [N, bs, Hkv, hd] (bs a multiple of 8); int8 scales are k.shape[:3]."""
    what = "decode_attention" if tables is None else "paged_decode_attention"
    dev = q.device
    if not all(t.device == dev for t in (k, v, pos)) or (
            tables is not None and tables.device != dev):
        raise ValueError(f"{what}: q, k, v, pos (and tables) must share one "
                         f"device")
    if q.dtype not in _Q_DTYPES:
        raise TypeError(f"{what}: q must be float32 or bfloat16, got "
                        f"{q.dtype}")
    if k.dtype not in _KV_DTYPES or v.dtype != k.dtype:
        raise TypeError(f"{what}: cache must be float32, bfloat16 or int8, "
                        f"got {k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{what}: expected q [B,Tq,Hq,hd] and k = v "
                         f"[{'B,T' if tables is None else 'N,bs'},Hkv,hd], "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Tq, Hq, hd = q.shape
    Hkv = k.shape[2]
    if (tables is None and k.shape[0] != B) or k.shape[3] != hd or Hq % Hkv:
        raise ValueError(f"{what}: cache {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if hd not in _HEAD_DIMS:
        raise ValueError(f"{what}: head_dim {hd} not in {_HEAD_DIMS}")
    if Tq * (Hq // Hkv) > _R_CAP:
        raise ValueError(f"{what}: Tq * G = {Tq * (Hq // Hkv)} query rows "
                         f"per kv head exceed {_R_CAP}")
    if pos.dtype != torch.int32 or pos.shape != (B,):
        raise ValueError(f"{what}: pos must be int32 [B], got {pos.dtype} "
                         f"{tuple(pos.shape)}")
    tensors = [("q", q), ("k", k), ("v", v), ("pos", pos)]
    if tables is not None:
        bs = k.shape[1]
        if bs < 8 or bs % 8:
            raise ValueError(f"{what}: block size {bs} is not a positive "
                             f"multiple of 8")
        if tables.dtype != torch.int32 or tables.dim() != 2 \
                or tables.shape[0] != B:
            raise ValueError(f"{what}: tables must be int32 [B, nmax], got "
                             f"{tables.dtype} {tuple(tables.shape)}")
        # read an entry at a time: a slot's row of a larger table will do
        if not tables.is_contiguous():
            raise ValueError(f"{what}: tables must be contiguous")
    quant = k.dtype == torch.int8
    if quant != (k_scale is not None) or (k_scale is None) != (v_scale is None):
        raise ValueError(f"{what}: int8 caches need k_scale and v_scale; "
                         f"float caches take none")
    if quant:
        for name, s in (("k_scale", k_scale), ("v_scale", v_scale)):
            if s.dtype != torch.float32 or s.shape != k.shape[:3] \
                    or s.device != dev:
                raise ValueError(f"{what}: {name} must be float32 "
                                 f"{tuple(k.shape[:3])} on {dev}")
            tensors.append((name, s))
    for name, t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be contiguous and 16-byte "
                             f"aligned")


# The tick route's tickets: int32 counters, one per (b, kv head, query
# tile), that the kernel leaves at 0 — kept per (card, stream), so that
# launches sharing a buffer are ordered.
_tickets: dict = {}


def _ticket_buf(device, stream: int, n: int):
    buf = _tickets.get((device, stream))
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _tickets[(device, stream)] = buf
    return buf


def _launch(name, q, k, Hkv, T, ptrs, dims, scale, body):
    """Allocate the output and the split scratch, launch ``csrc/<name>.cu``
    on q's card with ``ptrs`` (input pointers, None for an absent scale)
    and ``dims``, and raise on a refused launch.  ``body``: the route the
    launch takes (:func:`route`, :func:`paged_route`), whose split plan
    it then uses (the tick route's tickets too); ``R_TC`` goes to the C
    entry, which decides the same."""
    B, Tq, Hq, hd = q.shape
    R = Tq * (Hq // Hkv)
    scale = scale if scale is not None else 1.0 / (hd ** 0.5)
    plan = {"tick": tick_plan, "tc": tc_split_plan}.get(body)
    chunk, nsplit = (plan(B, Hkv, T, R) if plan
                     else split_plan(B, Hkv, T, R, hd))
    out = torch.empty_like(q)
    f32 = dict(dtype=torch.float32, device=q.device)
    o_part = torch.empty((B, Hkv, nsplit, R, hd), **f32)
    m_part = torch.empty((B, Hkv, nsplit, R), **f32)
    l_part = torch.empty((B, Hkv, nsplit, R), **f32)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    tickets = (_ticket_buf(q.device, stream, B * Hkv * R).data_ptr()
               if body == "tick" else None)
    ptrs = [*ptrs, out.data_ptr(), o_part.data_ptr(), m_part.data_ptr(),
            l_part.data_ptr(), tickets]
    ints = [*dims, hd, _Q_DTYPES[q.dtype], _KV_DTYPES[k.dtype], chunk, nsplit,
            R_TC]
    fn = getattr(_build.load(name), name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * len(ptrs) + [ctypes.c_int]
                       * len(ints) + [ctypes.c_float, ctypes.c_void_p])
    with torch.cuda.device(q.device):        # launch on q's card
        code = fn(*ptrs, *ints, float(scale), stream)
    _build.check(code, name)
    return out


def _row_pieces(q, Hkv: int) -> list:
    """Query-row offsets of the launches one call takes: [0] — or, past
    the kernels' cap of ``_R_CAP`` rows a kv head (a wide admission chunk
    under GQA: Tq * G > 1024), the starts of pieces of ``_R_CAP // G``
    rows.  A G past the cap keeps one launch, which ``_check`` refuses."""
    Tq, G = q.shape[1], q.shape[2] // Hkv
    if Tq * G <= _R_CAP or G > _R_CAP:
        return [0]
    return list(range(0, Tq, _R_CAP // G))


def _by_pieces(launch, q, Hkv: int, pos):
    """``launch(q_piece, pos_piece)`` over q's row pieces
    (:func:`_row_pieces`), concatenated on the row axis: the piece from
    row i attends as its rows do in the whole block, at ``pos + i``."""
    step = _R_CAP // (q.shape[2] // Hkv)
    return torch.cat([launch(q[:, i:i + step].contiguous(), pos + i)
                      for i in _row_pieces(q, Hkv)], dim=1)


def _scale_ptrs(k_scale, v_scale):
    return (k_scale.data_ptr() if k_scale is not None else None,
            v_scale.data_ptr() if v_scale is not None else None)


def _window_bytes(q, k, k_scale, B: int, T: int) -> int:
    """Bytes a launch moves over a window of T cache rows a slot: q in and
    out, K and V (and their int8 scales) of every row."""
    Hkv, hd = k.shape[2], k.shape[3]
    kv = 2 * B * T * Hkv * hd * k.element_size()
    if k_scale is not None:
        kv += 2 * B * T * Hkv * 4
    return 2 * q.numel() * q.element_size() + kv


def decode_attention_cost(q, k, v, pos, k_scale=None, v_scale=None,
                          scale=None):
    """(FLOPs, bytes) of a :func:`decode_attention` call for the device
    feed (``telemetry.counted``): q·Kᵀ and p·V over the cache's whole
    window T, 4·B·Tq·Hq·T·hd FLOPs, and the window's bytes.  The window,
    not the live rows: a captured step serves every position, which is a
    feed."""
    B, Tq, Hq, hd = q.shape
    T = k.shape[1]
    return (4 * B * Tq * Hq * T * hd,
            _window_bytes(q, k, k_scale, B, T) + 4 * B)


def paged_decode_attention_cost(q, k_pool, v_pool, tables, pos,
                                k_scale=None, v_scale=None, scale=None):
    """(FLOPs, bytes) of a :func:`paged_decode_attention` call: as
    :func:`decode_attention_cost` over the window the tables address,
    nmax · block_size rows a slot (the table's shape, not its live
    blocks), plus the tables."""
    B, Tq, Hq, hd = q.shape
    T = tables.shape[1] * k_pool.shape[1]
    return (4 * B * Tq * Hq * T * hd,
            _window_bytes(q, k_pool, k_scale, B, T) + 4 * B
            + tables.numel() * 4)


@_telemetry.counted(decode_attention_cost)
def decode_attention(q, k, v, pos, k_scale=None, v_scale=None, scale=None):
    """q [B, Tq, Hq, hd] against a cache [B, T, Hkv, hd] -> [B, Tq, Hq, hd]
    (q.dtype).  ``pos`` [B] int32: q row i of batch b attends cache rows
    t <= pos[b] + i.  int8 caches pass per-row ``k_scale``/``v_scale``
    [B, T, Hkv] float32.

    CPU tensors run :func:`_plain_decode`.  CUDA tensors launch
    ``csrc/decode_attention.cu`` (q float32/bfloat16; cache float32,
    bfloat16 or int8; hd in {64, 128, 256}) once for each piece of at
    most 1024 query rows a kv head (:func:`_row_pieces`); every launch
    adds one to ``decode_attention.launches``, and one on the tick route
    (:func:`route`) to ``.tick_launches``, on the tensor-core route to
    ``.tc_launches``."""
    if not q.is_cuda:
        return _plain_decode(q, k, v, pos, k_scale, v_scale, scale)
    if len(_row_pieces(q, k.shape[2])) > 1:
        return _by_pieces(lambda qp, pp: decode_attention(
            qp, k, v, pp, k_scale, v_scale, scale), q, k.shape[2], pos)
    _check(q, k, v, pos, k_scale, v_scale)
    B, Tq, Hq, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    body = route(Tq * (Hq // Hkv), q.dtype, hd, k.dtype)
    out = _launch("decode_attention", q, k, Hkv, T,
                  [q.data_ptr(), k.data_ptr(), v.data_ptr(),
                   *_scale_ptrs(k_scale, v_scale), pos.data_ptr()],
                  [B, Tq, Hq, Hkv, T], scale, body)
    _counts.bump(decode_attention, launches=1,
                 tick_launches=body == "tick", tc_launches=body == "tc")
    return out


decode_attention.launches = 0
decode_attention.tick_launches = 0
decode_attention.tc_launches = 0


# ---------------------------------------------------------------------------
# paged (block-table) attention — the pool layout's decode hot path
# ---------------------------------------------------------------------------


def gather_paged_view(k_pool, tables):
    """Per-slot contiguous view of a pooled leaf: k_pool [N, bs, ...] +
    tables [B, nmax] -> [B, nmax*bs, ...] (a copy).  Unmapped entries (-1)
    clamp to block 0 — the allocator maps every block through a live
    slot's write position, so those rows sit past its causal frontier
    and are masked like a slab's unwritten rows.  The plain twin's and
    the CPU paths' materialization; the kernel resolves the table per
    staged row instead."""
    idx = tables.long().clamp(0, k_pool.shape[0] - 1)          # [B, nmax]
    g = k_pool[idx]                                          # [B,nmax,bs,...]
    return g.reshape((g.shape[0], g.shape[1] * g.shape[2]) + g.shape[3:])


def paged_supported(q_shape, pool_shape) -> bool:
    """The JAX package's static shape gate for its paged kernel: q
    [B, Tq, Hq, hd] against a pool [N, bs, Hkv, hd] — what the port's
    paged kernel takes too."""
    B, Tq, Hq, hd = q_shape
    N, bs, Hkv = pool_shape[0], pool_shape[1], pool_shape[2]
    return (hd in _HEAD_DIMS and Hq % Hkv == 0
            and Tq * (Hq // Hkv) <= _R_CAP
            and bs >= 8 and bs % 8 == 0)


def _plain_paged(q, k_pool, v_pool, tables, pos, k_scale, v_scale, scale):
    """The plain twin of the paged kernel (the JAX package's
    ``_xla_paged``): gather each slot's view through its table, then
    :func:`_plain_decode`.  It equals the kernel wherever every unmapped
    block lies past the slot's frontier — what the allocator guarantees
    for a live slot.  A free slot (table row all -1) differs: the gather
    reads block 0 here, the kernel reads nothing and returns zeros; both
    outputs are discarded by the server."""
    k = gather_paged_view(k_pool, tables)
    v = gather_paged_view(v_pool, tables)
    ks = gather_paged_view(k_scale, tables) if k_scale is not None else None
    vs = gather_paged_view(v_scale, tables) if v_scale is not None else None
    return _plain_decode(q, k, v, pos, ks, vs, scale)


@_telemetry.counted(paged_decode_attention_cost)
def paged_decode_attention(q, k_pool, v_pool, tables, pos,
                           k_scale=None, v_scale=None, scale=None):
    """Block-table decode attention: q [B, Tq, Hq, hd] against a pooled
    cache k/v [N, bs, Hkv, hd] addressed through ``tables`` [B, nmax]
    int32 (physical block per logical block; -1 = unmapped) ->
    [B, Tq, Hq, hd] (q.dtype).  Logical row t of slot b is row t % bs of
    block tables[b, t // bs]; rows t <= pos[b] + i are attended.  int8
    pools pass per-row scales [N, bs, Hkv] float32.

    CPU tensors run :func:`_plain_paged`.  CUDA tensors launch
    ``csrc/paged_decode_attention.cu`` (what ``decode_attention`` takes,
    with bs a multiple of 8; unmapped blocks are never read), once a
    piece of at most 1024 query rows a kv head as there; every launch
    adds one to ``paged_decode_attention.launches``, and one on the tick
    route (:func:`paged_route`) to ``.tick_launches``, on the tensor-core
    route to ``.tc_launches``."""
    if not q.is_cuda:
        return _plain_paged(q, k_pool, v_pool, tables, pos, k_scale,
                            v_scale, scale)
    if len(_row_pieces(q, k_pool.shape[2])) > 1:
        return _by_pieces(lambda qp, pp: paged_decode_attention(
            qp, k_pool, v_pool, tables, pp, k_scale, v_scale, scale), q,
            k_pool.shape[2], pos)
    _check(q, k_pool, v_pool, pos, k_scale, v_scale, tables)
    B, Tq, Hq, hd = q.shape
    N, bs, Hkv = k_pool.shape[:3]
    nmax = tables.shape[1]
    body = paged_route(Tq * (Hq // Hkv), q.dtype, hd, k_pool.dtype)
    out = _launch("paged_decode_attention", q, k_pool, Hkv, nmax * bs,
                  [q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                   *_scale_ptrs(k_scale, v_scale), pos.data_ptr(),
                   tables.data_ptr()],
                  [B, Tq, Hq, Hkv, N, nmax, bs], scale, body)
    _counts.bump(paged_decode_attention, launches=1,
                 tick_launches=body == "tick", tc_launches=body == "tc")
    return out


paged_decode_attention.launches = 0
paged_decode_attention.tick_launches = 0
paged_decode_attention.tc_launches = 0
