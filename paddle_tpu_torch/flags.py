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


def decode_jit_key() -> tuple:
    """The decode-routing flags a captured step bakes in — the port's copy
    of ``paddle_tpu/flags.py``'s ``decode_jit_key``, cut to the flags the
    port reads: the W4 kernel gate (``woq.mm``), the fused LayerNorm
    (``gpt._norm``), the KV-cache storage dtype, layout and block size,
    and the admission prefill budget.  ``text/engine.cfg_key`` folds it
    into every step key, so flipping one of them mid-process keys a new
    CUDA graph instead of replaying one captured on the other route."""
    return (os.environ.get("PADDLE_TPU_W4_KERNEL", ""),
            os.environ.get("PADDLE_TPU_FUSED_LN", ""),
            kv_cache_dtype(), kv_layout(), kv_block_size(),
            os.environ.get("PADDLE_TPU_PREFILL_BUDGET", ""))
