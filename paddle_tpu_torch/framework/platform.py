"""The peaks of the cards the port knows, for MFU and roofline verdicts.

The port's own copy of the peaks half of ``paddle_tpu/framework/
platform.py``, for NVIDIA cards: one table that the device feed
(``telemetry.device_feed``) reads, so a live MFU and a benchmark's can
never disagree about what "peak" means.  There is no catch-all entry: a
kind not listed here gets (None, None) and MFU reports as null — an
honest "unknown" beats a fabricated percentage.
"""
from __future__ import annotations

# (dense bf16 tensor-core FLOP/s, HBM bytes/s) keyed on a lowercased
# substring of ``torch.cuda.get_device_name``; the first match wins, so
# the PCIe part is listed before the bare SXM names.  NVIDIA's H100 data
# sheet, dense rates (no sparsity) at the full power limit: SXM 989
# TFLOP/s and 3.35 TB/s (HBM3), PCIe 756 TFLOP/s and 2.0 TB/s (HBM2e).
DEVICE_PEAKS: dict = {
    "h100 pcie": (756e12, 2.0e12),
    "h100 80gb hbm3": (989e12, 3.35e12),
    "h100 sxm": (989e12, 3.35e12),
}


def device_peaks(device_kind: str | None = None,
                 platform: str | None = None) -> tuple:
    """(peak_flops, peak_hbm_bytes_per_s) of a card kind, resolved by
    substring against :data:`DEVICE_PEAKS`.  ``platform`` (the feed's
    ``gpu`` or ``cpu``) gates it: the CPU, or any platform but a GPU,
    gets (None, None), as does a kind the table does not list."""
    plat = (platform or "").lower()
    if plat and plat not in ("gpu", "cuda"):
        return (None, None)
    kind = (device_kind or "").lower()
    for k, peaks in DEVICE_PEAKS.items():
        if k in kind:
            return peaks
    return (None, None)


def peak_flops(device_kind: str | None = None,
               platform: str | None = None):
    """bf16 peak FLOP/s of a card kind, or None when unknown."""
    return device_peaks(device_kind, platform)[0]
