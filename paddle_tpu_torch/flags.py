"""Environment flags the port reads — its own copy of the few it needs
from ``paddle_tpu/flags.py``, same names and defaults (the port imports
nothing of the JAX package)."""
from __future__ import annotations

import os


def kv_cache_dtype() -> str:
    """KV-cache STORAGE dtype: '' (default — the model's compute dtype),
    'fp32', 'bf16', or 'int8', from ``PADDLE_TPU_KV_DTYPE``.

    Read at ``generate.init_cache`` time; int8 stores per-(position,
    head) fp32 scales beside the cache (``decode_attention.quantize_kv``)
    and the decode kernel dequantizes in registers."""
    v = os.environ.get("PADDLE_TPU_KV_DTYPE", "").strip().lower()
    if v in ("", "fp32", "float32"):
        return "" if v == "" else "fp32"
    if v in ("bf16", "bfloat16"):
        return "bf16"
    if v == "int8":
        return "int8"
    raise ValueError(
        f"PADDLE_TPU_KV_DTYPE={v!r}: expected fp32|bf16|int8 (or empty "
        f"for the model compute dtype)")


def kv_layout() -> str:
    """KV-cache LAYOUT for serving, from ``PADDLE_TPU_KV_LAYOUT``:
    'contiguous' (default — one [L, max_batch, rows, Hkv, hd] slab, every
    slot provisioned for the worst-case context) or 'paged'
    (``text/kv_pool.py`` — a fixed pool of block_size-row blocks shared by
    all slots through per-slot block tables, with refcounted prefix reuse
    and copy-on-write).  ``DecodeServer(layout=...)`` overrides it."""
    v = os.environ.get("PADDLE_TPU_KV_LAYOUT", "").strip().lower()
    if v in ("", "contiguous", "slab"):
        return "contiguous"
    if v == "paged":
        return "paged"
    raise ValueError(
        f"PADDLE_TPU_KV_LAYOUT={v!r}: expected contiguous|paged")


def kv_block_size() -> int:
    """Rows per KV-cache block under the paged layout
    (``PADDLE_TPU_KV_BLOCK``, default 16).  Must be a multiple of 8."""
    v = os.environ.get("PADDLE_TPU_KV_BLOCK", "16")
    try:
        bs = int(v)
    except ValueError:
        raise ValueError(
            f"PADDLE_TPU_KV_BLOCK={v!r}: expected an integer multiple "
            f"of 8")
    if bs < 8 or bs % 8:
        raise ValueError(
            f"PADDLE_TPU_KV_BLOCK={bs}: must be a positive multiple of 8")
    return bs


def kv_radix() -> bool:
    """Token-granular radix matching in the paged prefix index (on by
    default): a prompt sharing only PART of an indexed block's tokens
    splits that node, so admission adopts the longest token prefix.
    ``PADDLE_TPU_KV_RADIX=0`` restores whole-block matching.  Read when a
    ``PagedAllocator`` is built."""
    v = os.environ.get("PADDLE_TPU_KV_RADIX", "1").strip().lower()
    return v not in ("0", "false", "off", "no")


def fused_ce() -> bool:
    """The fused softmax-CE loss head (``ops/fused_ce.py``), from
    ``PADDLE_TPU_FUSED_CE == "1"`` — read by ``gpt.loss_fn`` at each call,
    as the JAX package reads it at trace time.  Off: the fp32
    ``log_softmax`` expression."""
    return os.environ.get("PADDLE_TPU_FUSED_CE", "") == "1"


def fused_ln() -> bool:
    """The fused LayerNorm kernels (``ops/fused_norm.py``: Pallas #4/#5 in
    the JAX package, ``csrc/fused_norm.cu`` here), from
    ``PADDLE_TPU_FUSED_LN == "1"`` — read by ``gpt._norm`` at each call.
    On: every LayerNorm takes ``fused_layer_norm`` on its compute-dtype
    input and saves only x and the [N, 1] statistics for the backward —
    the kernels on a CUDA tensor, their plain twins on the CPU.  Off: the
    fp32 ``F.layer_norm`` expression.  RMSNorm never takes it."""
    return os.environ.get("PADDLE_TPU_FUSED_LN", "") == "1"


def remat_policy() -> str | None:
    """The remat policy name from ``PADDLE_TPU_REMAT_POLICY`` (unset or
    empty: None, full recompute).  Read by ``gpt.forward_with_aux`` only
    when the config sets no ``remat_policy``: an explicit config stays
    authoritative, as in the JAX package (text/gpt.py ``_remat_policy``).
    Names are validated where they are resolved
    (``ops/remat_policies.py``)."""
    return os.environ.get("PADDLE_TPU_REMAT_POLICY") or None


def w4_kernel() -> bool:
    """The W4A16 dequant-matmul kernel (``ops/woq_matmul.py``: Pallas #8
    in the JAX package, ``csrc/woq_matmul.cu`` here) for nibble-packed
    int4 weights, from ``PADDLE_TPU_W4_KERNEL == "1"`` — read by
    ``woq.mm`` / ``woq.mm_stacked`` at each call, where the JAX package
    reads it inline (``paddle_tpu/text/woq.py``).  Off: the weight is
    dequantized in the compute dtype and multiplied as a float matrix."""
    return os.environ.get("PADDLE_TPU_W4_KERNEL", "") == "1"


def prefill_budget() -> int:
    """Per-scheduler-round admission prefill token budget
    (``PADDLE_TPU_PREFILL_BUDGET``, default 0 = monolithic admission), the
    default of ``DecodeServer(prefill_budget=)``.  When > 0, a prompt
    longer than the budget is admitted in budget-wide chunks, one a
    scheduler round between decode steps, so its prefill never stalls the
    decoding slots.  The budget is the width of the admission steps — a
    captured shape — so the raw string is part of
    :func:`decode_jit_key`."""
    v = os.environ.get("PADDLE_TPU_PREFILL_BUDGET", "0")
    try:
        b = int(v)
    except ValueError:
        raise ValueError(
            f"PADDLE_TPU_PREFILL_BUDGET={v!r}: expected an integer >= 0 "
            f"(0 keeps monolithic admission)")
    if b < 0:
        raise ValueError(f"PADDLE_TPU_PREFILL_BUDGET={b}: must be >= 0")
    return b


def spec_k() -> int:
    """Proposals scored per speculative serving round, feed token
    included (``PADDLE_TPU_SPEC_K``, default 0 = speculation off): what a
    ``DecodeServer`` built without ``spec_k=`` resolves.  The verify step
    captures K in its shapes, so the raw string is part of
    :func:`decode_jit_key`."""
    v = os.environ.get("PADDLE_TPU_SPEC_K", "0")
    try:
        k = int(v)
    except ValueError:
        raise ValueError(f"PADDLE_TPU_SPEC_K={v!r}: expected an integer "
                         f">= 0 (0 disables speculation)")
    if k < 0:
        raise ValueError(f"PADDLE_TPU_SPEC_K={k}: must be >= 0")
    return k


def spec_tree() -> int:
    """Node budget of a tree-speculation round (``PADDLE_TPU_SPEC_TREE``,
    default 0 = off): what a ``DecodeServer`` built without
    ``spec_tree=`` resolves.  Node 0 carries the feed token, so a tree
    needs at least 2 nodes.  The tree verify step captures N in its
    shapes, so the raw string is part of :func:`decode_jit_key`; the
    tree's topology is a runtime feed and keys nothing."""
    v = os.environ.get("PADDLE_TPU_SPEC_TREE", "0")
    try:
        n = int(v)
    except ValueError:
        raise ValueError(f"PADDLE_TPU_SPEC_TREE={v!r}: expected an "
                         f"integer >= 0 (0 disables tree speculation)")
    if n < 0 or n == 1:
        raise ValueError(f"PADDLE_TPU_SPEC_TREE={n}: must be 0 (off) or "
                         f">= 2 (node 0 carries the feed token, so a "
                         f"1-node tree proposes nothing)")
    return n


def spec_branch() -> int:
    """Sibling candidates a tree proposal may fan out at a node
    (``PADDLE_TPU_SPEC_BRANCH``, default 2): the draft's top-b tokens, or
    distinct n-gram continuations when self-drafting.  Host proposal
    shaping only — never part of a step key."""
    try:
        return max(1, int(os.environ.get("PADDLE_TPU_SPEC_BRANCH", "2")))
    except ValueError:
        return 2


def spec_min_accept() -> float:
    """Rolling per-request acceptance rate below which a speculating slot
    falls back to plain decode (``PADDLE_TPU_SPEC_MIN_ACCEPT``, default
    0.3).  Host scheduling only — never part of a step key."""
    try:
        return min(1.0, max(0.0, float(os.environ.get(
            "PADDLE_TPU_SPEC_MIN_ACCEPT", "0.3"))))
    except ValueError:
        return 0.3


def telemetry_enabled() -> bool:
    """The telemetry registry's master switch (``PADDLE_TPU_TELEMETRY``,
    on by default): off, every record call of ``paddle_tpu_torch.telemetry``
    returns at once.  Host bookkeeping only — never part of a step key."""
    v = os.environ.get("PADDLE_TPU_TELEMETRY", "1").strip().lower()
    return v not in ("0", "false", "off", "no")


def resilience_enabled() -> bool:
    """The resilience layer's master switch (``PADDLE_TPU_RESILIENCE``,
    on by default).  On, the server survives faults: it sheds expired
    queued requests, runs the OOM degradation ladder, recovers a wedged
    async fetch and fails a request with non-finite logits instead of
    serving it.  ``PADDLE_TPU_RESILIENCE=0`` fails fast everywhere
    (``resilience.retry`` makes one attempt, no ladder, no shed).  Host
    scheduling only — never part of a step key."""
    v = os.environ.get("PADDLE_TPU_RESILIENCE", "1").strip().lower()
    return v not in ("0", "false", "off", "no")


def prefetch_retries() -> int:
    """Bounded re-read retries for a ``DevicePrefetcher`` worker whose
    source iterator raises a transient error
    (``PADDLE_TPU_PREFETCH_RETRIES``, default 2; resilience off = 0)."""
    if not resilience_enabled():
        return 0
    try:
        return max(0, int(os.environ.get("PADDLE_TPU_PREFETCH_RETRIES",
                                         "2")))
    except ValueError:
        return 2


def request_ttl_s() -> float | None:
    """Default per-request deadline (``PADDLE_TPU_REQUEST_TTL_S`` seconds,
    None = off): a request still queued this long after it entered the
    queue is shed with the ``timeout`` status.  ``DecodeServer.submit(
    ttl_s=...)`` overrides it per request."""
    v = os.environ.get("PADDLE_TPU_REQUEST_TTL_S", "").strip()
    if not v:
        return None
    try:
        ttl = float(v)
    except ValueError:
        return None
    return ttl if ttl > 0 else None


def step_budget_s() -> float:
    """Wall budget of one async serving fetch (``PADDLE_TPU_STEP_BUDGET_S``
    seconds, 0 = watchdog off, the default).  Past it the wedge watchdog
    marks the server wedged, cancels the dispatches in flight, rolls the
    slots back and decodes those steps again.  The budget must exceed an
    honest step with room to spare (captures excluded: warm up first)."""
    try:
        return max(0.0, float(
            os.environ.get("PADDLE_TPU_STEP_BUDGET_S", "0")))
    except ValueError:
        return 0.0


def kv_spill_mb() -> int:
    """Host-RAM spill tier capacity in MiB for cold prefix-cache blocks
    (``PADDLE_TPU_KV_SPILL_MB``, default 0 = spill off).  Set, the evict
    rung demotes cold block-aligned prefix chains to pinned host memory
    (one batched gather and one device-to-host copy a round) instead of
    dropping them, and admission restores a spilled chain through the
    ``inject`` step instead of recomputing it.  Host scheduling only."""
    try:
        return max(0, int(os.environ.get("PADDLE_TPU_KV_SPILL_MB", "0")))
    except ValueError:
        return 0


def kv_spill_batch() -> int:
    """Most prefix blocks demoted a spill round
    (``PADDLE_TPU_KV_SPILL_BATCH``, default 8); candidates past it are
    dropped as the plain evict rung drops them."""
    try:
        return max(1, int(os.environ.get("PADDLE_TPU_KV_SPILL_BATCH",
                                         "8")))
    except ValueError:
        return 8


def kv_spill_rss_mb() -> int:
    """Host-RSS watchdog threshold in MiB (``PADDLE_TPU_KV_SPILL_RSS_MB``,
    default 0 = off).  Over it, every 16th scheduler tick releases up to
    ``kv_spill_batch()`` entries: the oldest spilled chains first, then
    cold prefix leaves through the evict rung."""
    try:
        return max(0, int(os.environ.get("PADDLE_TPU_KV_SPILL_RSS_MB",
                                         "0")))
    except ValueError:
        return 0


def kv_restore() -> bool:
    """Whether admission restores spilled prefix chains
    (``PADDLE_TPU_KV_RESTORE``, on by default).  ``0`` keeps the spill
    store write-only: admission recomputes instead."""
    v = os.environ.get("PADDLE_TPU_KV_RESTORE", "1").strip().lower()
    return v not in ("0", "false", "off", "no")


def requeue_max() -> int:
    """How often one request may be evicted by the OOM ladder and
    requeued (``PADDLE_TPU_EVICT_REQUEUE_MAX``, default 8; 0 = no bound).
    Past it the request fails with the ``error`` status instead of
    cycling."""
    try:
        return max(0, int(os.environ.get("PADDLE_TPU_EVICT_REQUEUE_MAX",
                                         "8")))
    except ValueError:
        return 8


def nan_guard_serving() -> bool:
    """The serving NaN guard on the decode ticks' logits
    (``PADDLE_TPU_NAN_GUARD_SERVING == "1"``, off by default): a greedy
    tick then fetches its logits [B, V] and fails the request whose row
    is not finite.  Admission logits are always checked (they are
    fetched anyway); with a fault installed the ticks are too."""
    return os.environ.get("PADDLE_TPU_NAN_GUARD_SERVING", "") == "1"


def admission_enabled() -> bool:
    """Admission control's master switch (``PADDLE_TPU_ADMISSION``, on by
    default).  On, ``DecodeServer`` builds a
    ``text.admission.AdmissionController``: per-tenant token buckets,
    bounded per-class queues that shed the lowest class first, and the
    SLO degradation ladder (admit cap -> prefill-budget rung -> speculation
    off -> shed) driven by the TTFT and decode-gap histograms.  ``0``
    builds no controller: strict FIFO admission, no request ever
    ``rejected``.  Host scheduling only — never part of a step key (the
    ladder picks among chunk widths ``warmup`` captured)."""
    v = os.environ.get("PADDLE_TPU_ADMISSION", "1").strip().lower()
    return v not in ("0", "false", "off", "no")


def adaptive_budget() -> bool:
    """The adaptive prefill budget (``PADDLE_TPU_ADAPTIVE_BUDGET``, on by
    default): a breached decode-gap (TPOT) window moves the budget one
    ladder width down on its own counter, without the ladder's other
    levers; healthy windows move it back up, an idle window resets it.
    ``0`` couples the budget to the ladder's rung alone.  Host scheduling
    only."""
    v = os.environ.get("PADDLE_TPU_ADAPTIVE_BUDGET", "1").strip().lower()
    return v not in ("0", "false", "off", "no")


def _float_or_none(name: str) -> float | None:
    v = os.environ.get(name)
    if v is None or not v.strip():
        return None
    try:
        f = float(v)
    except ValueError:
        raise ValueError(f"{name}={v!r}: expected a number")
    return f if f > 0 else None


def slo_ttft_ms() -> float | None:
    """The TTFT objective in ms (``PADDLE_TPU_SLO_TTFT_MS``; unset or 0:
    none), held against the windowed p99 of ``serving.ttft_ms``."""
    return _float_or_none("PADDLE_TPU_SLO_TTFT_MS")


def slo_tpot_ms() -> float | None:
    """The decode-gap objective in ms (``PADDLE_TPU_SLO_TPOT_MS``; unset or
    0: none), held against the windowed p99 of ``serving.decode_gap_ms``."""
    return _float_or_none("PADDLE_TPU_SLO_TPOT_MS")


def slo_window_s() -> float:
    """The SLO evaluation window in seconds (``PADDLE_TPU_SLO_WINDOW_S``,
    default 2.0, at least 0.05): one ladder move at most a window."""
    try:
        return max(0.05, float(os.environ.get("PADDLE_TPU_SLO_WINDOW_S",
                                              "2.0")))
    except ValueError:
        return 2.0


def tenant_rate() -> float | None:
    """Per-tenant token-bucket refill rate in admitted tokens (prompt +
    max_new) a second (``PADDLE_TPU_TENANT_RATE``; unset or 0: no rate
    limit).  A submit its tenant's bucket cannot cover is ``rejected``."""
    return _float_or_none("PADDLE_TPU_TENANT_RATE")


def tenant_burst() -> float | None:
    """Per-tenant bucket capacity (``PADDLE_TPU_TENANT_BURST``; default
    twice the rate)."""
    return _float_or_none("PADDLE_TPU_TENANT_BURST")


def admission_queue_cap() -> int:
    """Bound on each priority class's queued requests
    (``PADDLE_TPU_ADMISSION_QUEUE_CAP``, default 0 = unbounded); past it
    the lowest over-cap class sheds its newest entry as ``rejected``."""
    try:
        return max(0, int(os.environ.get(
            "PADDLE_TPU_ADMISSION_QUEUE_CAP", "0")))
    except ValueError:
        return 0


def wedge_evidence_ttl_s() -> float:
    """How long a probe-log entry stays evidence (``PADDLE_TPU_WEDGE_TTL_S``
    seconds, default 1800): ``telemetry.probe_health`` calls an older
    entry ``stale``."""
    try:
        return max(0.0, float(os.environ.get("PADDLE_TPU_WEDGE_TTL_S",
                                             "1800")))
    except ValueError:
        return 1800.0


def device_feed_enabled() -> bool:
    """The device feed (``PADDLE_TPU_DEVICE_FEED``, on by default, under
    the telemetry switch): each step build's cost count (FLOPs, bytes,
    memory sizes: ``telemetry.instrument_compile`` and the Engine's
    builds), per-step walls (``telemetry.note_step_time``) and the
    rate-limited card memory sample (``telemetry.sample_device_stats``).
    Host bookkeeping only: it never changes a step."""
    return device_feed_mode() != "off"


def device_feed_mode() -> str:
    """'off' | 'on' | 'full' — the one parse of ``PADDLE_TPU_DEVICE_FEED``
    (the JAX package's values).  In the port 'full' equals 'on': the
    memory sizes come with the cost count, which is cheap, so 'on'
    already takes both."""
    if not telemetry_enabled():
        return "off"
    v = os.environ.get("PADDLE_TPU_DEVICE_FEED", "1").strip().lower()
    if v in ("0", "false", "off", "no"):
        return "off"
    return "full" if v == "full" else "on"


def hbm_sample_interval_s() -> float:
    """Least seconds between two card memory samples on the hot paths
    (``PADDLE_TPU_HBM_SAMPLE_MS``, default 500)."""
    try:
        return max(0.0, float(os.environ.get("PADDLE_TPU_HBM_SAMPLE_MS",
                                             "500"))) / 1e3
    except ValueError:
        return 0.5


def telemetry_log() -> str | None:
    """``PADDLE_TPU_TELEMETRY_LOG=<path>``: every telemetry event and span
    is also appended to this file as one JSON line.  None: no log."""
    return os.environ.get("PADDLE_TPU_TELEMETRY_LOG") or None


def trace_enabled() -> bool:
    """Request tracing (``PADDLE_TPU_TRACE``, on by default, under the
    telemetry switch): ``telemetry.mint_trace`` hands out trace contexts
    and the server records request spans under them.  Host bookkeeping
    only."""
    v = os.environ.get("PADDLE_TPU_TRACE", "1").strip().lower()
    return v not in ("0", "false", "off", "no")


def trace_ring_spans() -> int:
    """Completed spans a server's ring holds before new ones are dropped
    and counted (``PADDLE_TPU_TRACE_RING``, default 4096)."""
    try:
        return max(1, int(os.environ.get("PADDLE_TPU_TRACE_RING", "4096")))
    except ValueError:
        return 4096


def trace_piggyback_cap() -> int:
    """Spans one ``drain_spans`` takes (``PADDLE_TPU_TRACE_PIGGYBACK``,
    default 256); the rest wait for the next take."""
    try:
        return max(1, int(os.environ.get("PADDLE_TPU_TRACE_PIGGYBACK",
                                         "256")))
    except ValueError:
        return 256


def _int_flag(name: str, default: int, lo: int) -> int:
    """An integer flag, at least ``lo``; the default when unset or not an
    integer."""
    try:
        return max(lo, int(os.environ.get(name, str(default))))
    except ValueError:
        return default


def fleet_prefill_threshold() -> int:
    """Prompt length at which the fleet router hands admission prefill to
    a prefill worker (``PADDLE_TPU_FLEET_PREFILL_THRESHOLD``, default 0:
    every prompt while a worker is attached).  Host scheduling only."""
    return _int_flag("PADDLE_TPU_FLEET_PREFILL_THRESHOLD", 0, 0)


def fleet_tick_block() -> int:
    """Decode steps a replica tick takes in the router's loop
    (``PADDLE_TPU_FLEET_TICK_BLOCK``, default 1; > 1 ticks through
    ``tick_block(k)``).  Host scheduling only."""
    return _int_flag("PADDLE_TPU_FLEET_TICK_BLOCK", 1, 1)


def fleet_tick_workers() -> int:
    """Threads the router ticks its replicas on
    (``PADDLE_TPU_FLEET_TICK_WORKERS``, default 8; 1 ticks them in turn on
    the caller's thread).  Host scheduling only."""
    return _int_flag("PADDLE_TPU_FLEET_TICK_WORKERS", 8, 1)


def fleet_max_queue() -> int:
    """Requests the router stacks on one replica's queue beyond its free
    slots before holding work in the fleet queue
    (``PADDLE_TPU_FLEET_MAX_QUEUE``, default 2).  Host scheduling only."""
    return _int_flag("PADDLE_TPU_FLEET_MAX_QUEUE", 2, 0)


def fleet_metrics_port() -> int | None:
    """``PADDLE_TPU_FLEET_METRICS_PORT=<port>``: the router's
    fleet-aggregated metrics endpoint when it is built without
    ``metrics_port=`` (0 = a free port); None = no endpoint."""
    v = os.environ.get("PADDLE_TPU_FLEET_METRICS_PORT")
    if v is None or not v.strip():
        return None
    try:
        return max(0, int(v))
    except ValueError:
        return None


def prefix_route() -> bool:
    """Prefix-aware fleet routing (``PADDLE_TPU_PREFIX_ROUTE``, on by
    default): the router leads its load score with each replica's
    expected prefix overlap.  Host scheduling only."""
    v = os.environ.get("PADDLE_TPU_PREFIX_ROUTE", "1").strip().lower()
    return v not in ("0", "false", "off", "no")


def prefix_route_imbalance() -> int:
    """Prefix affinity counts only on replicas whose queue is within this
    many requests of the least loaded candidate's
    (``PADDLE_TPU_PREFIX_ROUTE_IMBALANCE``, default 2).  Host scheduling
    only."""
    return _int_flag("PADDLE_TPU_PREFIX_ROUTE_IMBALANCE", 2, 0)


def stream_chunk_rows() -> int:
    """Rows a prefill worker streams a chunk
    (``PADDLE_TPU_STREAM_CHUNK_ROWS``, default 256; 0 = the whole walk in
    one reply).  Host scheduling only: the width rounds to a power of
    two, a width warmup captures."""
    return _int_flag("PADDLE_TPU_STREAM_CHUNK_ROWS", 256, 0)


def fleet_autoscale() -> bool:
    """The router's scaling loop (``PADDLE_TPU_FLEET_AUTOSCALE``, off by
    default): a sustained degradation rung attaches a registered spare, a
    sustained idle fleet drains its youngest replica back to the spares.
    Host scheduling only."""
    v = os.environ.get("PADDLE_TPU_FLEET_AUTOSCALE", "0").strip().lower()
    return v not in ("0", "false", "off", "no", "")


def fleet_scale_rung() -> int:
    """The worst replica rung that arms a scale-out
    (``PADDLE_TPU_FLEET_SCALE_RUNG``, default 2)."""
    return _int_flag("PADDLE_TPU_FLEET_SCALE_RUNG", 2, 1)


def fleet_scale_out_ticks() -> int:
    """Consecutive hot router ticks before a spare attaches
    (``PADDLE_TPU_FLEET_SCALE_OUT_TICKS``, default 3)."""
    return _int_flag("PADDLE_TPU_FLEET_SCALE_OUT_TICKS", 3, 1)


def fleet_scale_in_ticks() -> int:
    """Consecutive idle router ticks before the youngest replica drains
    back to the spares (``PADDLE_TPU_FLEET_SCALE_IN_TICKS``, default 50)."""
    return _int_flag("PADDLE_TPU_FLEET_SCALE_IN_TICKS", 50, 1)


def decode_jit_key() -> tuple:
    """The decode-routing flags a captured step bakes in — the port's copy
    of ``paddle_tpu/flags.py``'s ``decode_jit_key``, cut to the flags the
    port reads: the W4 kernel gate (``woq.mm``), the fused LayerNorm
    (``gpt._norm``), the KV-cache storage dtype, layout and block size,
    the speculative chunk K (the verify step's token and logit shapes),
    the tree node budget (the tree verify's) and the admission prefill
    budget.  ``text/engine.cfg_key`` folds it
    into every step key, so flipping one of them mid-process keys a new
    CUDA graph instead of replaying one captured on the other route.

    The admission and telemetry flags (``PADDLE_TPU_ADMISSION``, the SLO,
    tenant and queue knobs, the adaptive budget, the telemetry log, the
    trace ring, the device feed) are not in it: they change which
    captured step the host picks or what it records, never what a step
    computes.  The ladder's chunk widths are ``StepSpec`` fields of the
    graphs ``warmup`` captures."""
    return (os.environ.get("PADDLE_TPU_W4_KERNEL", ""),
            os.environ.get("PADDLE_TPU_FUSED_LN", ""),
            kv_cache_dtype(), kv_layout(), kv_block_size(),
            os.environ.get("PADDLE_TPU_SPEC_K", ""),
            os.environ.get("PADDLE_TPU_SPEC_TREE", ""),
            os.environ.get("PADDLE_TPU_PREFILL_BUDGET", ""))
