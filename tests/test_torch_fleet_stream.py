"""The port's fleet transports, wire codec, streamed handoff, elastic
fleet and chain migration (paddle_tpu_torch/text/fleet.py, the server's
``stream_prefilled_*`` entries, ``kv_pool.PagedAllocator.migrate_out`` /
``migrate_in``) against the JAX package's, on the CPU.

The transport, streaming and elastic cases of ``tests/test_fleet.py``, each
run on both packages over the same small fp32 model and numpy prompts,
holding both to the reference case's asserts and to each other: the same
streams, statuses, exception types and ``fleet.*`` / ``serving.*`` /
``kv_pool.*`` counters.  The wire codec is held byte for byte: the same
message encodes to the same header and the same buffer frames in both
packages (numpy with ml_dtypes bf16 on the JAX side, torch tensors here),
and each decodes the other's bytes.  Socket cases use 127.0.0.1 only,
behind the reference's capability skip.  The repo's lint rules
(``tools/check_instrumented.py``) pass on the port's fleet and pool.
"""
import importlib.util
import os
import socket
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu import faults as jfaults
from paddle_tpu import telemetry as jtl
from paddle_tpu.framework import monitor
from paddle_tpu.text import fleet as jfleet
from paddle_tpu.text import generate as jgenerate
from paddle_tpu.text import gpt as jgpt
from paddle_tpu.text import serving as jserving
from paddle_tpu_torch import convert, faults
from paddle_tpu_torch import telemetry as tl
from paddle_tpu_torch.text import fleet, serving

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = ("jax", "torch")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(autouse=True)
def _clean():
    for f, t in ((jfaults, jtl), (faults, tl)):
        f.reset()
        t.reset()
        t.clear_runtime_wedge()
    yield
    for f, t in ((jfaults, jtl), (faults, tl)):
        f.reset()
        t.clear_runtime_wedge()


def _jcfg():
    return jgpt.GPTConfig(vocab_size=64, hidden_size=32, num_layers=2,
                          num_heads=4, max_seq_len=64, dtype=jnp.float32)


@pytest.fixture(scope="module")
def model():
    jcfg = _jcfg()
    jp = jax.device_get(jgpt.init_params(jcfg, jax.random.PRNGKey(0)))
    return jcfg, jp, convert.config_from_jax(jcfg), \
        convert.params_from_jax(jp)


class Pkg:
    """One package's fleet surface over the shared model."""

    def __init__(self, name, model):
        jcfg, jp, cfg, params = model
        self.name = name
        if name == "jax":
            self.fleet, self.serving, self.tl, self.faults = \
                jfleet, jserving, jtl, jfaults
            self.cfg, self.params, self.dev = jcfg, jp, {}
        else:
            self.fleet, self.serving, self.tl, self.faults = \
                fleet, serving, tl, faults
            self.cfg, self.params, self.dev = cfg, params, {"device": "cpu"}

    def server(self, **kw):
        return self.serving.DecodeServer(self.params, self.cfg, **self.dev,
                                         **kw)

    def worker(self, **kw):
        return self.fleet.PrefillWorker(self.params, self.cfg, **self.dev,
                                        **kw)

    def count(self, name) -> int:
        if self.name == "jax":
            return int(monitor.get_stat(name).get())
        return tl.counter(name)

    def gauge(self, name) -> float:
        return self.tl.gauge(name).get()


def _both(model):
    return [Pkg(p, model) for p in PKGS]


def _toks(streams):
    return [[int(t) for t in s] for s in streams]


def _layout_kw(layout):
    return ({} if layout == "contiguous"
            else {"layout": "paged", "block_size": 8})


def _prompts(n_short=3, long_len=20, seed=7):
    rng = np.random.default_rng(seed)
    lens = [int(x) for x in rng.integers(3, 8, n_short)] + [long_len]
    return [[int(x) for x in rng.integers(1, 60, n)] for n in lens]


def _single(P, prompts, max_new=6, max_len=48, **kw):
    srv = P.server(max_batch=len(prompts), max_len=max_len, **kw)
    rids = [srv.submit(p, max_new_tokens=max_new) for p in prompts]
    while srv.pending():
        srv.tick()
    out = [srv.result(r) for r in rids]
    srv.close()
    return _toks(out)


def _drive(router, prompts, max_new=6, timeout_s=120.0):
    rids = [router.submit(p, max_new_tokens=max_new) for p in prompts]
    deadline = time.time() + timeout_s
    while router.pending() and time.time() < deadline:
        router.tick()
        if not any(r._slots or r._queue for r in router.replicas
                   if r is not None):
            time.sleep(0.002)
    assert not router.pending(), "fleet never drained"
    return _toks([router.result(r) for r in rids])


def _localhost_sockets_ok() -> bool:
    try:
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        s.close()
        return True
    except OSError:
        return False


requires_sockets = pytest.mark.skipif(
    not _localhost_sockets_ok(),
    reason="sandbox has no localhost sockets")


@pytest.fixture()
def fleet_env(monkeypatch):
    """Env setter that also empties the JAX package's value-keyed step
    caches (the port keys its steps by the flags it reads)."""
    def set_(**kw):
        for k, v in kw.items():
            if v is None:
                monkeypatch.delenv(k, raising=False)
            else:
                monkeypatch.setenv(k, v)
        jgenerate._GEN_CACHE.clear()
        jserving._STEP_CACHE.clear()
    yield set_
    jgenerate._GEN_CACHE.clear()
    jserving._STEP_CACHE.clear()


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "tools", name + ".py"))
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    return m


# ---------------------------------------------------------------------------
# transports
# ---------------------------------------------------------------------------


def test_loopback_transport_roundtrip():
    for F in (jfleet, fleet):
        lt = F.LoopbackTransport()
        lt.client.send({"rid": 1, "prompt": [1, 2]})
        assert lt.worker.recv(0.1) == {"rid": 1, "prompt": [1, 2]}
        assert lt.worker.recv(0.0) is None          # poll: empty
        lt.worker.send({"rid": 1, "rows": None})
        assert lt.client.recv(0.1)["rid"] == 1


@requires_sockets
def test_socket_transport_frames_and_poll():
    listener = fleet.SocketTransport.listen()
    client = fleet.SocketTransport.connect("127.0.0.1", listener.port)
    server = listener.accept(timeout=5.0)
    payload = {"rid": 3, "rows": {"k": torch.arange(8.0).reshape(2, 4)}}
    client.send(payload)
    got = server.recv(5.0)
    assert got["rid"] == 3
    assert torch.equal(got["rows"]["k"], payload["rows"]["k"])
    assert server.recv(0.0) is None             # poll: empty, no hang
    server.close()
    client.close()
    listener.close()


@requires_sockets
def test_socket_send_is_one_gathered_write():
    """A whole message leaves in ONE scatter-gather write
    (``fleet.frame_batches`` counts messages), a partial ``sendmsg``
    resumes at its exact offset, and the bytes are the codec's (a
    multi-buffer payload round-trips exactly)."""
    before = tl.counter("fleet.frame_batches")
    listener = fleet.SocketTransport.listen()
    client = fleet.SocketTransport.connect("127.0.0.1", listener.port)
    server = listener.accept(timeout=5.0)
    calls = []

    class _SendmsgProxy:
        def __init__(self, sock):
            self._s = sock

        def __getattr__(self, name):
            return getattr(self._s, name)

        def sendmsg(self, views):
            views = list(views)
            calls.append(len(views))
            if len(calls) == 1:
                # a partial first write: half the first frame goes out
                half = max(1, views[0].nbytes // 2)
                return self._s.sendmsg([views[0][:half]])
            return self._s.sendmsg(views)

    client._sock = _SendmsgProxy(client._sock)
    payload = {"rid": 9, "rows": {"k": torch.arange(12.0).reshape(3, 4),
                                  "v": torch.arange(6, dtype=torch.int32)}}
    client.send(payload)
    got = server.recv(5.0)
    assert calls and calls[0] == 6, calls
    assert torch.equal(got["rows"]["k"], payload["rows"]["k"])
    assert torch.equal(got["rows"]["v"], payload["rows"]["v"])
    assert got["rows"]["v"].dtype == torch.int32
    assert tl.counter("fleet.frame_batches") >= before + 1
    server.close()
    client.close()
    listener.close()


@requires_sockets
def test_socket_fleet_bit_parity(model):
    """A worker served over TCP (``serve_prefill_worker``), the router
    connected as a remote client: the single server's streams, in both
    packages."""
    prompts = _prompts(seed=17)
    out = {}
    for P in _both(model):
        ref = _single(P, prompts)
        worker = P.worker(max_len=48)
        listener = P.fleet.serve_prefill_worker(worker)
        ep = P.fleet.SocketTransport.connect("127.0.0.1", listener.port)
        router = P.fleet.Router(
            [P.server(max_batch=2, max_len=48) for _ in range(2)],
            prefill=[ep], prefill_threshold=16)
        got = _drive(router, prompts)
        router.close()
        worker.close()
        listener.close()
        assert got == ref
        assert P.count("fleet.prefill_handoffs") >= 1
        out[P.name] = (got, P.count("fleet.prefill_handoffs"))
    assert out["torch"] == out["jax"]


def test_prefilling_request_ttl_sheds(model):
    """A request out at a prefill worker past its TTL sheds ``timeout``.
    The expiry is made certain, not raced: the request's enqueue stamp is
    moved back past its TTL before the tick."""
    for P in _both(model):
        lt = P.fleet.LoopbackTransport()       # no worker ever attached
        router = P.fleet.Router([P.server(max_batch=1, max_len=48)],
                                prefill=[lt.client], prefill_threshold=1)
        rid = router.submit([1, 2, 3], max_new_tokens=4, ttl_s=0.01)
        assert router.status(rid) == "prefilling"
        router._requests[rid]["req"]["t_enqueue"] -= 1.0
        router.tick()
        assert router.status(rid) == "timeout"
        with pytest.raises(TimeoutError):
            router.result(rid)
        assert not router.pending()
        assert P.count("fleet.ttl_sheds") == 1
        router.close()


@requires_sockets
def test_dead_socket_worker_fails_requests_not_hangs(model):
    """A worker dying mid-job (orderly close, no reply): its prefills
    retire ``error``, the endpoint leaves the rotation, new work prefills
    locally."""
    out = {}
    for P in _both(model):
        listener = P.fleet.SocketTransport.listen()
        client = P.fleet.SocketTransport.connect("127.0.0.1", listener.port)
        worker_side = listener.accept(timeout=5.0)
        router = P.fleet.Router([P.server(max_batch=1, max_len=48)],
                                prefill=[client], prefill_threshold=1)
        rid = router.submit([1, 2, 3], max_new_tokens=4)
        assert worker_side.recv(5.0)["rid"] == rid
        worker_side.close()
        deadline = time.time() + 10.0
        while router.status(rid) == "prefilling" \
                and time.time() < deadline:
            router.tick()
            time.sleep(0.01)
        assert router.status(rid) == "error"
        with pytest.raises(RuntimeError, match="prefill worker"):
            router.result(rid)
        assert not router.pending()
        assert P.count("fleet.prefill_errors") == 1
        rid2 = router.submit([4, 5, 6], max_new_tokens=4)
        while router.pending():
            router.tick()
        assert router.status(rid2) == "ok"
        out[P.name] = _toks([router.result(rid2)])
        router.close()
        listener.close()
    assert out["torch"] == out["jax"]


# ---------------------------------------------------------------------------
# the wire codec
# ---------------------------------------------------------------------------


def _codec_msgs():
    """One message twice: numpy leaves (ml_dtypes bf16) for the JAX codec
    and the same values as torch tensors for the port's."""
    ml_dtypes = pytest.importorskip("ml_dtypes")
    rng = np.random.default_rng(3)
    k = rng.standard_normal((2, 1, 4, 8)).astype(np.float32)
    q8 = rng.integers(-128, 127, (2, 1, 4), dtype=np.int8)
    b16 = rng.standard_normal((3, 4)).astype(np.float32)
    ids = np.arange(5, dtype=np.int64)
    jmsg = {"rid": 7, "op": "chunk", "start": 0, "stop": 4,
            "rows": {"k": k, "q8": q8,
                     "b16": b16.astype(ml_dtypes.bfloat16)},
            "meta": [1, "x", None, 2.5, np.float32(0.5)], "ids": ids}
    tmsg = {"rid": 7, "op": "chunk", "start": 0, "stop": 4,
            "rows": {"k": torch.from_numpy(k), "q8": torch.from_numpy(q8),
                     "b16": torch.from_numpy(b16).to(torch.bfloat16)},
            "meta": [1, "x", None, 2.5, np.float32(0.5)],
            "ids": torch.from_numpy(ids)}
    return jmsg, tmsg


def test_wire_codec_is_the_jax_codec_byte_for_byte():
    """The same message encodes to the same JSON header and the same raw
    buffer frames in both packages (bf16 bits included), and each
    package decodes the other's bytes to the same values."""
    jmsg, tmsg = _codec_msgs()
    jhdr, jarr = jfleet._encode_msg(jmsg)
    thdr, tarr = fleet._encode_msg(tmsg)
    assert thdr == jhdr
    jframes = [a.reshape(-1).view(np.uint8).tobytes() for a in jarr]
    tframes = [bytes(fleet._frame_view(t)) for t in tarr]
    assert tframes == jframes
    # the port decodes the JAX frames, the JAX package the port's
    got = fleet._decode_msg(jhdr, [bytearray(f) for f in jframes])
    back = jfleet._decode_msg(thdr, [bytearray(f) for f in tframes])
    for name in ("k", "q8", "b16"):
        assert got["rows"][name].dtype == tmsg["rows"][name].dtype
        assert torch.equal(got["rows"][name], tmsg["rows"][name])
        assert back["rows"][name].dtype == jmsg["rows"][name].dtype
        np.testing.assert_array_equal(
            back["rows"][name].view(np.uint8),
            jmsg["rows"][name].view(np.uint8))
    assert got["meta"] == back["meta"] == [1, "x", None, 2.5, 0.5]


def test_wire_codec_roundtrip_dtypes():
    """The raw-row codec round-trips every KV storage dtype (fp32, int8,
    bf16) exactly, nested trees included, into writable tensors (the
    decode side owns fresh buffers)."""
    _, msg = _codec_msgs()
    hdr, bufs = fleet._encode_msg(msg)
    assert isinstance(hdr, bytes)
    out = fleet._decode_msg(hdr, [bytearray(fleet._frame_view(b))
                                  for b in bufs])
    assert out["rid"] == 7 and out["meta"] == [1, "x", None, 2.5, 0.5]
    for name, ref in msg["rows"].items():
        got = out["rows"][name]
        assert got.dtype == ref.dtype and got.shape == ref.shape
        assert torch.equal(got.view(torch.uint8) if got.dtype != torch.int8
                           else got, ref.view(torch.uint8)
                           if ref.dtype != torch.int8 else ref)
        got.view(-1)[0] = got.view(-1)[0]          # writable


def test_wire_codec_never_pickles_unknown_types():
    """A leaf the codec does not carry is a loud TypeError in both
    packages — never a pickle."""
    for F in (jfleet, fleet):
        with pytest.raises(TypeError):
            F._encode_msg({"bad": {1, 2, 3}})
        with pytest.raises(TypeError):
            F._encode_msg({"fn": lambda: None})
    with pytest.raises(TypeError):
        fleet._encode_msg({"c": torch.zeros(2, dtype=torch.complex64)})


@requires_sockets
def test_socket_torn_frame_budget_and_reset(monkeypatch):
    """A peer stalling mid-frame trips the torn-frame budget as a
    ConnectionError, and an orderly close mid-stream raises the same."""
    monkeypatch.setattr(fleet, "_FRAME_BUDGET_S", 0.05)
    listener = fleet.SocketTransport.listen()
    raw = socket.create_connection(("127.0.0.1", listener.port))
    ep = listener.accept(timeout=5.0)
    try:
        raw.sendall(fleet._FRAME_PREFIX.pack(1, 1000) + b"torn")
        with pytest.raises(ConnectionError):
            ep.recv(1.0)
    finally:
        raw.close()
        ep.close()
        listener.close()
    listener = fleet.SocketTransport.listen()
    raw = socket.create_connection(("127.0.0.1", listener.port))
    ep = listener.accept(timeout=5.0)
    try:
        raw.close()
        with pytest.raises(ConnectionError):
            ep.recv(1.0)
    finally:
        ep.close()
        listener.close()


# ---------------------------------------------------------------------------
# the streamed handoff
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv", ["fp32", "int8"])
@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_chunked_stream_bit_parity(fleet_env, model, kv, layout):
    """A prefill handed off chunk by chunk (rows injected while the worker
    computes the next chunk) gives one server's streams, bit for bit —
    {contiguous, paged} x {fp32, int8 KV storage} — in both packages."""
    fleet_env(PADDLE_TPU_STREAM_CHUNK_ROWS="4",
              PADDLE_TPU_KV_DTYPE=None if kv == "fp32" else kv)
    kw = _layout_kw(layout)
    prompts = _prompts(seed=23)
    out = {}
    for P in _both(model):
        ref = _single(P, prompts, **kw)
        P.tl.reset()
        worker = P.worker(max_len=48, layout=layout, block_size=8)
        router = P.fleet.Router(
            [P.server(max_batch=2, max_len=48, **kw) for _ in range(2)],
            prefill=[worker], prefill_threshold=16)
        got = _drive(router, prompts)
        router.close()
        assert got == ref
        assert P.count("fleet.stream_chunks") >= 2
        assert P.count("fleet.stream_bytes") > 0
        assert P.count("serving.stream_claims") >= 1
        out[P.name] = (got, {n: P.count(n) for n in (
            "fleet.stream_chunks", "fleet.stream_bytes",
            "serving.stream_claims", "serving.stream_begins",
            "serving.prefilled_rows")})
    assert out["torch"] == out["jax"]


def test_monolithic_flag_restores_whole_walk(fleet_env, model):
    """``PADDLE_TPU_STREAM_CHUNK_ROWS=0``: the whole-walk reply, no chunk
    frames, the same streams."""
    fleet_env(PADDLE_TPU_STREAM_CHUNK_ROWS="0")
    prompts = _prompts(seed=29)
    out = {}
    for P in _both(model):
        ref = _single(P, prompts)
        P.tl.reset()
        worker = P.worker(max_len=48)
        router = P.fleet.Router(
            [P.server(max_batch=2, max_len=48) for _ in range(2)],
            prefill=[worker], prefill_threshold=16)
        got = _drive(router, prompts)
        router.close()
        assert got == ref
        assert P.count("fleet.stream_chunks") == 0
        assert P.count("fleet.prefill_handoffs") >= 1
        out[P.name] = (got, P.count("fleet.prefill_handoffs"))
    assert out["torch"] == out["jax"]


def test_stream_rows_refused_as_the_jax_server_refuses(model):
    """``stream_prefilled_rows`` refuses a gap, logits before the last
    row, a final chunk without logits and an unknown stream, with the
    same exception types in both packages."""
    prompt = [int(x) for x in np.random.default_rng(5).integers(1, 60, 12)]
    for P in _both(model):
        w = P.worker(max_len=48)
        msgs = []
        w.prefill_stream(prompt, msgs.append, chunk_rows=4)
        w.close()
        srv = P.server(max_batch=1, max_len=48)
        rid = srv.stream_prefilled_begin(prompt, max_new_tokens=3)
        m0, m1 = msgs[0], msgs[1]
        with pytest.raises(ValueError, match="expected start"):
            srv.stream_prefilled_rows(rid, m1["start"], m1["stop"],
                                      m1["rows"])
        with pytest.raises(ValueError, match="before the final"):
            srv.stream_prefilled_rows(rid, m0["start"], m0["stop"],
                                      m0["rows"], logits=msgs[-1]["logits"])
        with pytest.raises(KeyError):
            srv.stream_prefilled_rows(rid + 99, 0, 4, m0["rows"])
        for m in msgs[:-1]:
            srv.stream_prefilled_rows(rid, m["start"], m["stop"], m["rows"])
        last = msgs[-1]
        with pytest.raises(ValueError, match="no admission logits"):
            srv.stream_prefilled_rows(rid, last["start"], last["stop"],
                                      last["rows"])
        srv.stream_prefilled_abort(rid, "test")
        assert srv.status(rid) == "error"
        with pytest.raises(KeyError):
            srv.stream_prefilled_abort(rid, "again")
        assert not srv._slots
        srv.close()


@requires_sockets
def test_mid_stream_worker_death_fails_honestly(fleet_env, model):
    """A worker that dies after ONE chunk: the half-streamed request
    retires ``error``, its claimed slot frees, the replica serves on."""
    fleet_env(PADDLE_TPU_STREAM_CHUNK_ROWS="4")
    prompt = [int(x) for x in
              np.random.default_rng(31).integers(1, 60, 12)]
    out = {}
    for P in _both(model):
        listener = P.fleet.SocketTransport.listen()
        client = P.fleet.SocketTransport.connect("127.0.0.1", listener.port)
        worker_side = listener.accept(timeout=5.0)
        srv = P.server(max_batch=1, max_len=48)
        router = P.fleet.Router([srv], prefill=[client], prefill_threshold=1)
        rid = router.submit(prompt, max_new_tokens=4)
        job = worker_side.recv(5.0)
        assert job["rid"] == rid
        helper = P.worker(max_len=48)
        msgs = []
        helper.prefill_stream(job["prompt"], msgs.append, chunk_rows=4)
        helper.close()
        assert len(msgs) >= 2 and msgs[0].get("logits") is None
        worker_side.send(dict(msgs[0], rid=rid))
        deadline = time.time() + 10.0
        while (router._requests[rid]["state"] != "streaming"
               and time.time() < deadline):
            router.tick()
            time.sleep(0.01)
        assert router._requests[rid]["state"] == "streaming"
        worker_side.close()
        deadline = time.time() + 10.0
        while (router.status(rid) in ("prefilling", "streaming")
               and time.time() < deadline):
            router.tick()
            time.sleep(0.01)
        assert router.status(rid) == "error"
        with pytest.raises(RuntimeError):
            router.result(rid)
        assert not router.pending()
        assert P.count("fleet.stream_aborts") >= 1
        assert not srv._slots and not srv._streams
        rid2 = router.submit([4, 5], max_new_tokens=2)
        deadline = time.time() + 20.0
        while router.pending() and time.time() < deadline:
            router.tick()
            time.sleep(0.005)
        assert router.status(rid2) == "ok"
        out[P.name] = (_toks([router.result(rid2)]),
                       P.count("fleet.stream_aborts"), len(msgs))
        router.close()
        listener.close()
    assert out["torch"] == out["jax"]


# ---------------------------------------------------------------------------
# the elastic fleet
# ---------------------------------------------------------------------------


def test_live_add_remove_replica_bit_identical(model):
    """A replica attached live joins routing; one removed live keeps its
    in-flight results first — every stream an undisturbed single
    server's."""
    prompts = _prompts(n_short=5, seed=37)
    out = {}
    for P in _both(model):
        ref = _single(P, prompts)
        P.tl.reset()
        mk = lambda: P.server(max_batch=2, max_len=48)  # noqa: E731
        router = P.fleet.Router([mk(), mk()])
        rids = [router.submit(p, max_new_tokens=6) for p in prompts]
        for _ in range(2):
            router.tick()
        third = router.add_replica(mk())
        assert P.count("fleet.replica_adds") == 1
        for _ in range(2):
            router.tick()
        removed = router.remove_replica(0)
        removed.close()
        assert P.count("fleet.replica_removes") == 1
        assert router.replicas[0] is None
        deadline = time.time() + 120.0
        while router.pending() and time.time() < deadline:
            router.tick()
        got = _toks([router.result(r) for r in rids])
        assert got == ref
        assert int(P.gauge("fleet.replicas")) == 2
        assert router.healthz()["ok"]
        with pytest.raises(KeyError):
            router.remove_replica(0)
        router.close()
        assert third == 2
        out[P.name] = (got, [router._requests[r].get("replica")
                             for r in rids])
    assert out["torch"] == out["jax"]


def test_autoscale_drill_out_then_in(fleet_env, model):
    """The scaling loop: a sustained rung at or past the threshold
    attaches the spare (``fleet.scale_outs``), a sustained idle fleet
    drains it back (``fleet.scale_ins``) — debounced both ways."""
    fleet_env(PADDLE_TPU_FLEET_AUTOSCALE="1",
              PADDLE_TPU_FLEET_SCALE_RUNG="2",
              PADDLE_TPU_FLEET_SCALE_OUT_TICKS="2",
              PADDLE_TPU_FLEET_SCALE_IN_TICKS="3")
    for P in _both(model):
        srv = P.server(max_batch=2, max_len=48)
        spare = P.server(max_batch=2, max_len=48)
        router = P.fleet.Router([srv])
        router.register_spare(spare)
        live = lambda: sum(  # noqa: E731
            1 for r in router.replicas if r is not None)
        orig = srv.load_stats
        srv.load_stats = lambda: dict(orig(), admission_rung=2,
                                      queue_depth=1)
        router.tick()                        # hot tick 1: debounced
        assert live() == 1 and P.count("fleet.scale_outs") == 0
        router.tick()                        # hot tick 2: the spare joins
        assert live() == 2
        assert P.count("fleet.scale_outs") == 1
        assert int(P.gauge("fleet.replicas")) == 2
        srv.load_stats = orig
        for _ in range(3):
            assert live() == 2
            router.tick()
        assert live() == 1
        assert P.count("fleet.scale_ins") == 1
        assert router._spares == [spare]
        assert int(P.gauge("fleet.replicas")) == 1
        router.close()


def test_chain_migration_follows_the_prompt(fleet_env, model):
    """A host-RAM spilled chain on replica A moves to replica B through
    the wire codec (the source forgets it), lands in B's spill store, and
    B's admission restores it through its own inject step — the single
    server's stream, ``kv_pool.chain_migrations`` counted."""
    fleet_env(PADDLE_TPU_KV_SPILL_MB="4")
    prompt = [int(x) for x in
              np.random.default_rng(41).integers(1, 60, 16)]
    out = {}
    for P in _both(model):
        ref = _single(P, [prompt], layout="paged", block_size=8)
        mk = lambda: P.server(max_batch=2, max_len=48,  # noqa: E731
                              layout="paged", block_size=8)
        a, b = mk(), mk()
        router = P.fleet.Router([a, b])
        r0 = a.submit(prompt, max_new_tokens=6)
        while a.pending():
            a.tick()
        assert _toks([a.result(r0)]) == ref
        for _ in range(8):
            if not a._pool.prefix_entries:
                break
            a._evict_or_spill(8)
        assert a._pool._spilled
        router._migrate_chains({"prompt": prompt}, 1)
        assert not a._pool._spilled          # a move, not a copy
        assert b._pool._spilled
        assert P.count("kv_pool.chain_migrations") >= 1
        assert P.count("kv_pool.chain_migrations_out") >= 1
        r1 = b.submit(prompt, max_new_tokens=6)
        while b.pending():
            b.tick()
        warm = _toks([b.result(r1)])
        stats = b._pool.stats()
        router.close()
        assert warm == ref
        assert stats["restored_blocks"] >= 1
        assert stats["chain_migrations"] >= 1
        out[P.name] = (warm, {k: stats[k] for k in (
            "restored_blocks", "chain_migrations", "spilled_entries",
            "host_spill_bytes")}, P.count("kv_pool.chain_migrations"))
    assert out["torch"] == out["jax"]


def test_prefix_summary_and_migrate_refusals(fleet_env, model):
    """``prefix_summary`` is the JAX allocator's, tuple for tuple, and
    ``migrate_in`` refuses a chain that is not block-aligned in both."""
    fleet_env(PADDLE_TPU_KV_SPILL_MB="4")
    prompt = [int(x) for x in np.random.default_rng(43).integers(1, 60, 20)]
    out = {}
    for P in _both(model):
        srv = P.server(max_batch=1, max_len=48, layout="paged",
                       block_size=8)
        rid = srv.submit(prompt, max_new_tokens=2)
        while srv.pending():
            srv.tick()
        summ = [tuple(int(x) for x in t) for t in srv._pool.prefix_summary()]
        assert summ == [tuple(int(x) for x in t)
                        for t in srv.load_stats()["prefix_summary"]]
        rows = {"k": np.zeros((2, 8, 4, 8), np.float32)}
        if P.name == "torch":
            rows = {"k": torch.zeros((2, 8, 4, 8))}
        assert srv._pool.migrate_in([{"tokens": [1, 2, 3], "rows": rows}]) \
            == 0
        out[P.name] = (summ, _toks([srv.result(rid)]))
        srv.close()
    assert out["torch"] == out["jax"]


# ---------------------------------------------------------------------------
# lint: the fleet's counters and the pickle ban, on the port's files
# ---------------------------------------------------------------------------


def test_fleet_lint_catches_silent_reroute():
    """The FLEET lint rule on fixtures, and on the port's fleet: every
    router scheduling path counts a ``fleet.*`` counter or delegates."""
    ci = _tool("check_instrumented")
    bad = ("class R:\n"
           "    def _route(self, q):\n"
           "        return q.pop()\n")
    assert ci.scan_fleet_source(bad)
    good = ("class R:\n"
            "    def _shed_expired(self):\n"
            "        count('fleet.ttl_sheds')\n"
            "    def _drain_replica(self, i):\n"
            "        self._shed_expired()\n")
    assert not ci.scan_fleet_source(good)
    with open(os.path.join(REPO, "paddle_tpu_torch/text/fleet.py"),
              encoding="utf-8") as f:
        assert not ci.scan_fleet_source(f.read(), "fleet.py")


def test_stream_lint_family_and_pickle_ban():
    """The STREAM lint rules on fixtures and on the port's tree: every
    stream / scale / migrate path counts or delegates, and the port's
    fleet carries no pickle site."""
    ci = _tool("check_instrumented")
    bad = ("class R:\n"
           "    def _stream_chunk(self, m):\n"
           "        return m\n"
           "    def _scale_out(self):\n"
           "        self.n += 1\n")
    assert len(ci.scan_stream_source(bad)) == 2
    good = ("class R:\n"
            "    def _scale_in(self):\n"
            "        count('fleet.scale_ins')\n"
            "    def _migrate_chains(self, req, i):\n"
            "        self._scale_in()\n")
    assert not ci.scan_stream_source(good)
    assert ci.scan_pickle_ban_source("import pickle\n")
    assert ci.scan_pickle_ban_source(
        "def recv(self):\n    return pickle.loads(b'')\n")
    assert not ci.scan_pickle_ban_source(
        "import json\nx = json.loads('{}')\n")
    for rel in ("paddle_tpu_torch/text/fleet.py",
                "paddle_tpu_torch/text/kv_pool.py"):
        with open(os.path.join(REPO, rel), encoding="utf-8") as f:
            assert not ci.scan_stream_source(f.read(), rel)
    with open(os.path.join(REPO, "paddle_tpu_torch/text/fleet.py"),
              encoding="utf-8") as f:
        assert not ci.scan_pickle_ban_source(f.read(), "fleet.py")
