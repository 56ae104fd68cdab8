"""Sweep of the contiguous decode kernel's two bf16 routes across query
widths, on one card: the tick body and the tensor-core body, each forced
at every width, so that ``decode_attention.R_TC`` (the least R = Tq·G taking
the tensor-core route) can be read off.

    python3 -m paddle_tpu_torch.tools.sweep_decode_routes [--widths 8,16,...]

Shape: B = 1, a T = 512-row cache, Hq = Hkv = 16 (G = 1, so R = Tq),
hd = 128, bf16, the Tq rows at the end of the cache (pos = T - Tq), timed
by ``chip_smoke.time_decode_chunk`` (L2 flushed, host enqueue hidden,
median of 20 launches).  Prints the card line, then one JSON line per
width with both times and the faster route.  Needs a CUDA card; imports
nothing of JAX or the JAX package.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[2]
WIDTHS = (8, 16, 32, 64, 128, 256, 512)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--widths", default=",".join(map(str, WIDTHS)))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("sweep_decode_routes: no CUDA device", file=sys.stderr)
        return 2
    import torch.nn.functional as F

    sys.path.insert(0, str(_ROOT))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", _ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    from paddle_tpu_torch.ops import decode_attention as da
    from paddle_tpu_torch.tools import profile_serving as wl

    print(wl.card_line(), flush=True)
    chosen = da.R_TC
    try:
        for R in (int(w) for w in args.widths.split(",")):
            row = {"R": R}
            for name, r_tc in (("tick", 1 << 30), ("tc", 1)):
                da.R_TC = r_tc
                before = da.decode_attention.tc_launches
                t = chip_smoke.time_decode_chunk(torch, da, F, Tq=R)
                ran_tc = da.decode_attention.tc_launches > before
                assert ran_tc == (name == "tc"), (name, R)
                row[f"{name}_ms"] = t["ms"]
                row.update(bound_ms=t["bound_ms"], bound_by=t["bound_by"],
                           library_ms=t["library_ms"])
            row["faster"] = "tc" if row["tc_ms"] < row["tick_ms"] else "tick"
            print(json.dumps(row), flush=True)
    finally:
        da.R_TC = chosen
    print(json.dumps({"R_TC": chosen}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
