"""The device feed's per-step cost analysis in the port
(paddle_tpu_torch/telemetry.py: ``instrument_compile``, ``counted_call``,
the kernel hooks, ``device_feed``, the gauges; framework/platform.py's
peaks) against the JAX package's (``tests/test_device_telemetry.py``), on
the CPU:

* an instrumented [64, 64] @ [64, 64] fp32 matmul: ``flops`` exactly
  2·64³ and the JAX package's XLA count, ``argument_bytes`` and
  ``output_bytes`` the JAX package's memory analysis; no ``temp_bytes``
  on the CPU (a graph's pool is the card's);
* ``mfu``, ``hbm_bw_util``, ``arithmetic_intensity`` and ``bound`` by
  hand against an H100's peaks; an unlisted card, or the CPU, null;
* ``PADDLE_TPU_DEVICE_FEED=0`` counts nothing and still records the
  build; the wall that overlapped a build is discarded;
* a tiny served pass fills ``serving.step`` and ``serving.prefill@8``
  under the JAX package's names: the step's FLOPs equal the hand count
  exactly (its matmuls, logits included, and attention over the cache's
  whole window) and lie within 15% of XLA's count on the same config; a
  paged pass counts the same step alike; a count that fails leaves a
  null feed and the served tokens as they were;
* the device gauge families and labels of ``render_prometheus`` equal
  the JAX package's for the same instrumented matmul, and ``/healthz``
  lists the counted steps.
"""
import json
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu import telemetry as jtl
from paddle_tpu.text import gpt as jgpt
from paddle_tpu.text import serving as jserving
from paddle_tpu_torch import convert
from paddle_tpu_torch import telemetry as tl
from paddle_tpu_torch.framework import platform
from paddle_tpu_torch.ops import decode_attention as da
from paddle_tpu_torch.text import serving

H100 = "NVIDIA H100 80GB HBM3"
N = 64


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in ("PADDLE_TPU_TELEMETRY", "PADDLE_TPU_DEVICE_FEED"):
        monkeypatch.delenv(k, raising=False)
    for t in (jtl, tl):
        t.reset()
    yield
    for t in (jtl, tl):
        t.reset()


def _matmul(pkg, name):
    """One instrumented [N, N] @ [N, N] fp32 matmul of two distinct
    operands drawn from one numpy seed, called once in ``pkg``."""
    rng = np.random.default_rng(0)
    a, b = (rng.standard_normal((N, N)).astype(np.float32) for _ in "ab")
    if pkg == "jax":
        fn = jtl.instrument_compile(name, (name,), None,
                                    jax.jit(lambda x, y: x @ y))
        fn(jnp.asarray(a), jnp.asarray(b))
    else:
        fn = tl.instrument_compile(name, (name,), None, lambda x, y: x @ y)
        fn(torch.from_numpy(a), torch.from_numpy(b))


def test_matmul_count_matches_jax():
    _matmul("jax", "t.count")
    _matmul("torch", "t.count")
    j = jtl.device_feed()["steps"]["t.count"]
    feed = tl.device_feed()
    s = feed["steps"]["t.count"]
    assert s["flops"] == 2 * N ** 3 == j["flops"]
    assert s["argument_bytes"] == 2 * N * N * 4 == j["argument_bytes"]
    assert s["output_bytes"] == N * N * 4 == j["output_bytes"]
    # operands read once, the result written once: the unfused reading
    assert s["bytes_accessed"] == 3 * N * N * 4
    assert s["compiles"] == 1 and "temp_bytes" not in s
    assert feed["platform"] == "cpu" and feed["peak_flops"] is None
    assert s["mfu"] is None and s["bound"] is None
    assert tl.compile_log()[-1]["name"] == "t.count"


def test_peaks_table():
    assert platform.device_peaks(H100, "gpu") == (989e12, 3.35e12)
    assert platform.device_peaks("NVIDIA H100 SXM5 80GB") == (989e12,
                                                              3.35e12)
    assert platform.device_peaks("NVIDIA H100 PCIe", "gpu") == (756e12,
                                                                2.0e12)
    # no guess: an unlisted card, the CPU, an empty kind
    assert platform.device_peaks("NVIDIA A100-SXM4-40GB", "gpu") \
        == (None, None)
    assert platform.device_peaks(H100, "cpu") == (None, None)
    assert platform.device_peaks("cpu") == (None, None)
    assert platform.device_peaks("", "gpu") == (None, None)
    assert platform.peak_flops(H100) == 989e12


def test_mfu_and_roofline_vs_hand_computed(monkeypatch):
    _matmul("torch", "t.mfu")
    monkeypatch.setitem(tl._device_info, "device_kind", H100)
    monkeypatch.setitem(tl._device_info, "platform", "gpu")
    wall = 1e-4
    # the first wall after the build overlapped it: discarded
    tl.note_step_time("t.mfu", wall)
    tl.note_step_time("t.mfu", wall)
    feed = tl.device_feed()
    assert (feed["peak_flops"], feed["peak_hbm_bytes_per_s"]) == (989e12,
                                                                  3.35e12)
    s = feed["steps"]["t.mfu"]
    flops, nbytes = 2 * N ** 3, 3 * N * N * 4
    assert s["step_calls"] == 1 and s["step_s"] == wall
    assert s["mfu"] == pytest.approx(flops / wall / 989e12, rel=1e-9)
    assert s["hbm_bw_util"] == pytest.approx(nbytes / wall / 3.35e12,
                                             rel=1e-9)
    assert s["flops_per_s"] == pytest.approx(flops / wall)
    assert s["arithmetic_intensity"] == round(flops / nbytes, 3)
    # 10.7 FLOPs a byte, under the H100's 989e12 / 3.35e12 = 295
    assert s["bound"] == "bandwidth"


@pytest.mark.parametrize("kind,platform_", [("NVIDIA A100-SXM4-40GB", "gpu"),
                                            ("cpu", "cpu")])
def test_unknown_card_and_cpu_give_null_mfu(monkeypatch, kind, platform_):
    _matmul("torch", "t.null")
    monkeypatch.setitem(tl._device_info, "device_kind", kind)
    monkeypatch.setitem(tl._device_info, "platform", platform_)
    tl.note_step_time("t.null", 1e-4)
    tl.note_step_time("t.null", 1e-4)
    s = tl.device_feed()["steps"]["t.null"]
    assert s["mfu"] is None and s["bound"] is None
    assert "hbm_bw_util" not in s
    assert s["flops_per_s"] > 0           # the honest half still reports


def test_feed_off_counts_nothing_but_records_the_build(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_DEVICE_FEED", "0")
    for pkg in ("jax", "torch"):
        _matmul(pkg, "t.off")
    for t in (jtl, tl):
        assert "t.off" not in t.device_feed()["steps"]
        assert any(c["name"] == "t.off" for c in t.snapshot()["compiles"])
    monkeypatch.setenv("PADDLE_TPU_DEVICE_FEED", "full")
    from paddle_tpu_torch import flags
    assert flags.device_feed_mode() == "full" and flags.device_feed_enabled()


def test_compile_overlapped_wall_is_discarded():
    _matmul("torch", "t.skip")
    tl.note_step_time("t.skip", 5.0)           # overlapped the build
    with tl._device_lock:
        assert "t.skip" not in tl._step_times
    tl.note_step_time("t.skip", 0.01)
    with tl._device_lock:
        assert tl._step_times["t.skip"]["ewma_s"] == pytest.approx(0.01)


# the served pass: 2 layers, hidden 64, 4 heads, vocab 128 in the preset's
# bf16, as both packages serve it.  (XLA's CPU count of the fp32 step is
# 258,152 FLOPs, under the matmuls' own 425,984: it costs fp32
# matrix-vector dots otherwise, so the bf16 step is the yardstick.)
CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
           max_seq_len=64)
BATCH, WINDOW, PROMPT = 2, 32, 8


def _hand_step_flops(cfg, batch, window):
    """A decode step's FLOPs by hand: 2 · batch · the matmul weights (qkv,
    proj, the two FFN matmuls a layer, the tied logits head) plus
    4 · batch · window · hidden a layer for attention over the window."""
    D, V, L = cfg["hidden_size"], cfg["vocab_size"], cfg["num_layers"]
    weights = L * (3 * D * D + D * D + 2 * 4 * D * D) + D * V
    return 2 * batch * weights + 4 * batch * window * D * L


def _serve(srv, prompts, new=4):
    rids = [srv.submit(p, max_new_tokens=new) for p in prompts]
    while srv.pending():
        srv.tick()
    return [[int(t) for t in srv.result(r)] for r in rids]


@pytest.fixture(scope="module")
def served():
    """Both packages serve the same 2 prompts of 8 tokens on the same bf16
    weights; each feed is read right after its own serve."""
    jtl.reset()
    tl.reset()
    jcfg = jgpt.GPTConfig(**CFG)
    jp = jax.device_get(jgpt.init_params(jcfg, jax.random.PRNGKey(5)))
    cfg, params = convert.config_from_jax(jcfg), convert.params_from_jax(jp)
    prompts = np.random.default_rng(1).integers(
        1, CFG["vocab_size"], (BATCH, PROMPT)).tolist()
    jsrv = jserving.DecodeServer(jp, jcfg, max_batch=BATCH, max_len=WINDOW)
    _serve(jsrv, prompts)
    jfeed = jtl.device_feed()["steps"]
    srv = serving.DecodeServer(params, cfg, max_batch=BATCH, max_len=WINDOW,
                               device="cpu")
    tok = _serve(srv, prompts)
    feed = tl.device_feed()["steps"]
    srv.close()
    return dict(cfg=cfg, params=params, prompts=prompts, tok=tok,
                jfeed=jfeed, feed=feed)


def test_served_pass_fills_the_step_feed(served):
    assert all(len(t) == 4 for t in served["tok"])
    feed, jfeed = served["feed"], served["jfeed"]
    for name in ("serving.step", f"serving.prefill@{PROMPT}"):
        assert name in jfeed, sorted(jfeed)
        s = feed[name]
        assert s["flops"] > 0 and s["bytes_accessed"] > 0, (name, s)
        assert s["argument_bytes"] > 0 and s["output_bytes"] > 0, (name, s)
    step = feed["serving.step"]
    hand = _hand_step_flops(CFG, BATCH, WINDOW)
    assert hand == 458752
    assert step["flops"] == hand
    assert abs(step["flops"] - jfeed["serving.step"]["flops"]) \
        <= 0.15 * jfeed["serving.step"]["flops"]
    # every weight and the whole K/V window read once at least
    weights = sum(t.numel() * t.element_size()
                  for t in served["params"]["blocks"].values()) \
        + served["params"]["wte"].numel() * 2
    assert step["bytes_accessed"] > weights
    # the ticks' walls joined the counted step (the first one discarded)
    assert step["step_s"] > 0 and step["flops_per_s"] > 0


def test_paged_step_counts_alike(served):
    """The paged step attends the window its tables address (nmax · bs
    rows), so its FLOPs are the contiguous step's."""
    tl.reset()
    srv = serving.DecodeServer(served["params"], served["cfg"],
                               max_batch=BATCH, max_len=WINDOW,
                               layout="paged", block_size=16, device="cpu")
    assert _serve(srv, served["prompts"]) == served["tok"]
    srv.close()
    step = tl.device_feed()["steps"]["serving.step"]
    assert step["flops"] == _hand_step_flops(CFG, BATCH, WINDOW)


def test_failed_count_is_a_null_feed(served, monkeypatch):
    def broken(*a, **k):
        raise RuntimeError("no count")

    monkeypatch.setattr(da, "decode_attention_cost", broken)
    srv = serving.DecodeServer(served["params"], served["cfg"],
                               max_batch=BATCH, max_len=WINDOW, device="cpu")
    assert _serve(srv, served["prompts"]) == served["tok"]
    srv.close()
    step = tl.device_feed()["steps"]["serving.step"]
    assert step["flops"] is None and step["bytes_accessed"] is None
    assert "no count" in step["count_failed"]


FAMILIES = [f"paddle_tpu_device_{m}" for m in (
    "step_flops", "step_bytes_accessed", "step_mfu", "step_hbm_bw_util",
    "step_seconds")]


def _device_lines(text, name):
    """The feed's TYPE lines and ``name``'s samples, value dropped."""
    types = {f"# TYPE {f} gauge" for f in FAMILIES}
    return [line if line in types else line.split(" ")[0]
            for line in text.splitlines()
            if line in types or f'step="{name}"' in line]


def test_prometheus_device_gauges_match_jax(monkeypatch):
    for pkg, t, kind, plat in (("jax", jtl, "TPU v5 lite", "tpu"),
                               ("torch", tl, H100, "gpu")):
        _matmul(pkg, "t.prom")
        monkeypatch.setitem(t._device_info, "device_kind", kind)
        monkeypatch.setitem(t._device_info, "platform", plat)
        t.note_step_time("t.prom", 1e-4)
        t.note_step_time("t.prom", 1e-4)
    ours = tl.render_prometheus()
    theirs = jtl.render_prometheus()
    rows = _device_lines(ours, "t.prom")
    assert rows == _device_lines(theirs, "t.prom")
    assert rows == [x for f in FAMILIES
                    for x in (f"# TYPE {f} gauge", f'{f}{{step="t.prom"}}')]
    assert f'paddle_tpu_device_step_flops{{step="t.prom"}} {2 * N ** 3}' \
        in ours
    # a wall-only step has no cost gauges, and /healthz lists the counted
    tl.note_step_time("t.walls", 0.01)
    assert 'paddle_tpu_device_step_flops{step="t.walls"}' \
        not in tl.render_prometheus()
    ms = tl.serve_metrics(0)
    try:
        body = json.load(urllib.request.urlopen(
            f"http://127.0.0.1:{ms.port}/healthz"))
    finally:
        ms.close()
    assert "t.prom" in body["instrumented_steps"]
    assert "t.walls" not in body["instrumented_steps"]
