"""A/B of the decode kernels (the contiguous one and the paged one, at
the tick and at admission widths) and of the LayerNorm forward across
checkouts, on one card.

    python3 paddle_tpu_torch/tools/ab_kernels.py ROOT_A ROOT_B ROOT_B ROOT_A

Each ROOT is the top directory of a checkout.  Each is timed in a process
of its own, in the order given (two builds of the same template kernels
in one process fail to launch), by ``chip_smoke.time_decode`` of THIS
checkout on that checkout's ``decode_attention``: B = 8 slots at the main
path's mid-serve positions, T = 512, Hq = Hkv = 16, hd = 128, bf16, L2
flushed, median of 20 launches; then by ``chip_smoke.time_paged`` on its
``paged_decode_attention`` at the paged path's mid-serve tick and at the
paged serve's admission widths C = 128 and 256 (one slot's chunk ending
at its 512th row), and by ``chip_smoke.time_decode_chunk`` on its
``decode_attention`` at the same geometry for C = 128; then by
``chip_smoke.time_paged_addressing`` (both kernels on the same memory,
the paged one through identity and shuffled tables) at the paged tick
and at C = 128; then by
``chip_smoke.time_norm`` on its ``ln_fwd`` at the train shape (N = F =
2048, bf16 x, fp32 g and b), whose row also carries ``bits``: a hash of
the forward's y, mu and rstd on those inputs, so that two checkouts'
outputs can be held equal bit for bit.  Prints the card line, the
floor of that timing (``chip_smoke.cold_ms`` of a one-element add, and of
a 16 MB bf16 copy and a sum over 13.4 MB as byte-bound yardsticks), then
eight JSON lines per run.  Needs a CUDA card; imports nothing of JAX or the JAX package.
"""
from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

_HERE = Path(__file__).resolve()


def _child(root: str) -> None:
    import torch
    import torch.nn.functional as F

    sys.path.insert(0, root)    # the checkout under test's paddle_tpu_torch
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", _HERE.parents[2] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    from paddle_tpu_torch.ops import decode_attention as da
    from paddle_tpu_torch.ops import fused_norm as fn
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
    for C in (128, 256):
        row = chip_smoke.time_paged(torch, da, F, [512 - C], Tq=C)
        print(json.dumps({"root": root, "kernel":
                          f"paged_decode_attention C={C}", **row}),
              flush=True)
    row = chip_smoke.time_decode_chunk(torch, da, F, Tq=128)
    print(json.dumps({"root": root, "kernel": "decode_attention R=128",
                      **row}), flush=True)
    for what, args in (("tick", ([n + wl.NEW // 2 for n in lens],)),
                       ("C=128", ([384], 128))):
        row = chip_smoke.time_paged_addressing(torch, da, *args)
        print(json.dumps({"root": root, "kernel": "paged_decode_attention "
                          f"on contiguous memory, {what}", **row}),
              flush=True)
    row = chip_smoke.time_norm(torch, fn, F)["fwd"]
    gen = torch.Generator(device="cuda").manual_seed(16)  # time_norm's
    x, g, b, _ = chip_smoke._ln_inputs(torch, gen, 2048, 2048,
                                       torch.bfloat16, torch.float32)
    h = hashlib.sha256()
    for t in fn.ln_fwd(x, g, b):
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    row["bits"] = h.hexdigest()[:16]
    print(json.dumps({"root": root, "kernel": "fused_layer_norm_fwd",
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
        print("ab_kernels: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(_HERE.parents[2]))
    from paddle_tpu_torch.tools import profile_serving as wl
    print(wl.card_line(), flush=True)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", _HERE.parents[2] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    one = torch.zeros(1, device="cuda")
    x = torch.randn(8 << 20, device="cuda").bfloat16()       # 16 MB
    y = torch.empty_like(x)
    print(json.dumps({"floor": {
        "one_element_add_ms": chip_smoke.cold_ms(torch, lambda: one.add_(1)),
        "copy_16MB_ms": chip_smoke.cold_ms(torch, lambda: y.copy_(x)),
        "sum_13_4MB_ms": chip_smoke.cold_ms(
            torch, lambda: x[:6_700_000].sum())}}), flush=True)
    del one, x, y
    for root in sys.argv[1:]:
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        subprocess.run([sys.executable, str(_HERE), "--child",
                        os.path.abspath(root)], env=env, check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
