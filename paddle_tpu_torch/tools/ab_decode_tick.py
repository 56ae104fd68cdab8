"""A/B of the decode tick's kernels (the contiguous decode kernel and the
paged one) across checkouts, on one card.

    python3 paddle_tpu_torch/tools/ab_decode_tick.py ROOT_A ROOT_B ROOT_B ROOT_A

Each ROOT is the top directory of a checkout.  Each is timed in a process
of its own, in the order given (two builds of the same template kernels
in one process fail to launch), by ``chip_smoke.time_decode`` of THIS
checkout on that checkout's ``decode_attention``: B = 8 slots at the main
path's mid-serve positions, T = 512, Hq = Hkv = 16, hd = 128, bf16, L2
flushed, median of 20 launches; then by ``chip_smoke.time_paged`` on its
``paged_decode_attention`` at the paged path's mid-serve tick.  Prints the
card line, then two JSON lines per run.  Needs a CUDA card; imports nothing of JAX or the JAX package.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

_HERE = Path(__file__).resolve()


def _child(root: str) -> None:
    import importlib.util

    import torch
    import torch.nn.functional as F

    sys.path.insert(0, root)    # the checkout under test's paddle_tpu_torch
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", _HERE.parents[2] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    from paddle_tpu_torch.ops import decode_attention as da
    from paddle_tpu_torch.tools import profile_serving as wl

    torch.backends.cuda.matmul.allow_tf32 = False
    assert Path(da.__file__).resolve().is_relative_to(Path(root).resolve())
    row = chip_smoke.time_decode(torch, da, F,
                                 [n + wl.NEW // 2 for n in wl.LENS])
    print(json.dumps({"root": root, "kernel": "decode_attention", **row}),
          flush=True)
    lens = [len(p) for p in wl.paged_prompts(50304)]
    row = chip_smoke.time_paged(torch, da, F,
                                [n + wl.NEW // 2 for n in lens])
    print(json.dumps({"root": root, "kernel": "paged_decode_attention",
                      **row}), flush=True)


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        _child(sys.argv[2])
        return 0
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("ab_decode_tick: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(_HERE.parents[2]))
    from paddle_tpu_torch.tools import profile_serving as wl
    print(wl.card_line(), flush=True)
    for root in sys.argv[1:]:
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        subprocess.run([sys.executable, str(_HERE), "--child",
                        os.path.abspath(root)], env=env, check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
