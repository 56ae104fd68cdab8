"""Environment flags the port reads — its own copy of the few it needs
from ``paddle_tpu/flags.py`` (the port imports nothing of the JAX
package)."""
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
