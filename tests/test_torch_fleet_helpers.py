"""The port's framework and fleet helpers against the JAX package's:
``framework/errors``, ``monitor`` and ``crypto``;
``distributed/fleet/strategy``, ``metrics``, ``util`` and ``utils/fs``.

* the 12 cases of tests/test_monitor_errors_metrics.py in the port (the
  device snapshot: ``{}`` and the timestamp without a card; an injected
  device folds its three stats);
* encrypted blobs crossing the two packages' ``crypto`` both ways;
* every ``DistributedStrategy`` field and sub-config default equal to
  JAX's, and a strategy's JSON loading in the other package;
* ``UtilBase`` over 4 gloo CPU ranks: sum / max / min, a gather, a
  barrier, each rank's file shard;
* ``LocalFS`` on a temporary directory; ``HDFSClient`` refusing without
  a hadoop binary;
* the modules a torch-free process imports (the reader, the data
  generator, the errors, monitor, crypto, strategy, fs and the schedule
  generator) import with torch blocked.
"""
import dataclasses
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from paddle_tpu.distributed.fleet import metrics as jfm
from paddle_tpu.distributed.fleet import strategy as jstrategy
from paddle_tpu.framework import crypto as jcrypto
from paddle_tpu_torch.distributed.fleet import metrics as fm
from paddle_tpu_torch.distributed.fleet import strategy as tstrategy
from paddle_tpu_torch.distributed.fleet.utils import HDFSClient, LocalFS
from paddle_tpu_torch.framework import crypto, errors, monitor


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class TestMonitor:
    def setup_method(self, _):
        monitor.reset_all()

    def test_counter_add_get_reset(self):
        s = monitor.get_stat("steps")
        assert s.add(5) == 5
        assert s.sub(2) == 3
        assert monitor.get_stat("steps") is s
        assert monitor.stats()["steps"] == 3
        monitor.reset_all()
        assert s.get() == 0

    def test_thread_safety(self):
        s = monitor.get_stat("concurrent")

        def work():
            for _ in range(1000):
                s.add(1)

        ts = [threading.Thread(target=work) for _ in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert s.get() == 8000

    def test_device_snapshot(self):
        out = monitor.snapshot_device_stats()
        assert monitor.stats()["device_stats_snapshot_time_ns"] > 0
        assert isinstance(out, dict)
        import torch

        if not torch.cuda.is_available():
            assert out == {}
        fake = type("Dev", (), {"memory_stats": lambda self: {
            "bytes_in_use": 5, "peak_bytes_in_use": 9, "bytes_limit": 80,
            "other": 1}})()
        assert monitor.snapshot_device_stats([fake]) == {
            "device0_bytes_in_use": 5, "device0_peak_bytes_in_use": 9,
            "device0_bytes_limit": 80}


class TestErrors:
    def test_typed_codes_and_hint(self):
        with pytest.raises(errors.InvalidArgumentError,
                           match=r"(?s)\[INVALID_ARGUMENT\].*positive.*Hint"):
            errors.enforce(False, "n must be positive", hint="pass n >= 1")

    def test_enforce_eq_message(self):
        with pytest.raises(errors.InvalidArgumentError,
                           match="expected 4, got 3"):
            errors.enforce_eq(3, 4, "axis size")

    def test_enforce_shape_wildcards(self):
        errors.enforce_shape(np.zeros((2, 5)), (None, 5))
        with pytest.raises(errors.InvalidArgumentError, match="shape"):
            errors.enforce_shape(np.zeros((2, 5)), (None, 4), "logits")

    def test_hierarchy(self):
        assert issubclass(errors.NotFoundError, errors.EnforceNotMet)
        with pytest.raises(errors.EnforceNotMet):
            errors.enforce(False, "x", exc=errors.UnavailableError)


class TestCrypto:
    def test_round_trip_and_tamper(self, tmp_path):
        sd = {"w": np.arange(12, dtype=np.float32).reshape(3, 4),
              "b": np.zeros(4, np.float32)}
        p = str(tmp_path / "m.pdenc")
        crypto.save_encrypted(sd, p, key="s3cret")
        back = crypto.load_encrypted(p, key="s3cret")
        np.testing.assert_array_equal(back["w"], sd["w"])
        with pytest.raises(ValueError, match="wrong key|HMAC"):
            crypto.load_encrypted(p, key="wrong")
        blob = bytearray(open(p, "rb").read())
        blob[len(blob) // 2] ^= 0xFF
        open(p, "wb").write(bytes(blob))
        with pytest.raises(ValueError, match="tampered|HMAC"):
            crypto.load_encrypted(p, key="s3cret")

    def test_ciphertext_hides_plaintext(self):
        data = b"SECRET_WEIGHTS" * 100
        blob = crypto.encrypt_bytes(data, "k")
        assert b"SECRET_WEIGHTS" not in blob
        assert crypto.decrypt_bytes(blob, "k") == data


class TestFleetMetrics:
    def test_auc_perfect_and_random(self):
        B = 10
        pos = np.zeros(B)
        neg = np.zeros(B)
        pos[9] = 100
        neg[0] = 100
        assert fm.auc(pos, neg) == pytest.approx(1.0)
        pos = np.ones(B) * 10
        neg = np.ones(B) * 10
        assert fm.auc(pos, neg) == pytest.approx(0.5)
        assert fm.auc(np.zeros(B), neg) == 0.5

    def test_auc_matches_sklearn_style_reference(self):
        rng = np.random.default_rng(0)
        B = 100
        scores_pos = np.clip(rng.beta(4, 2, 2000), 0, 0.999)
        scores_neg = np.clip(rng.beta(2, 4, 2000), 0, 0.999)
        pos, _ = np.histogram(scores_pos, bins=B, range=(0, 1))
        neg, _ = np.histogram(scores_neg, bins=B, range=(0, 1))
        got = fm.auc(pos, neg)
        exact = 0.0
        tot = 0.0
        bp = (np.arange(B) + 0.5) / B
        for i in range(B):
            for j in range(B):
                if pos[i] == 0 or neg[j] == 0:
                    continue
                w = pos[i] * neg[j]
                tot += w
                exact += w * (1.0 if bp[i] > bp[j] else
                              0.5 if i == j else 0.0)
        np.testing.assert_allclose(got, exact / tot, atol=0.01)
        assert got == jfm.auc(pos, neg)

    def test_stacked_reduce_and_acc(self):
        stacked = np.arange(8, dtype=np.float64)
        assert float(fm.sum(stacked, stacked=8)[0]) == 28.0
        assert float(fm.max(stacked, stacked=8)[0]) == 7.0
        correct = np.full(8, 10.0)
        total = np.full(8, 20.0)
        assert fm.acc(correct, total, stacked=8) == pytest.approx(0.5)
        assert float(fm.sum(stacked).sum()) == 28.0
        with pytest.raises(errors.InvalidArgumentError, match="multiple"):
            fm.sum(np.ones(7), stacked=8)


def test_blobs_cross_both_packages(tmp_path):
    data = os.urandom(1000)
    assert jcrypto.decrypt_bytes(crypto.encrypt_bytes(data, "key"),
                                 "key") == data
    assert crypto.decrypt_bytes(jcrypto.encrypt_bytes(data, b"key"),
                                "key") == data
    sd = {"w": np.arange(6, dtype=np.float32), "n": [1, 2]}
    crypto.save_encrypted(sd, str(tmp_path / "t.enc"), key="k")
    back = jcrypto.load_encrypted(str(tmp_path / "t.enc"), key="k")
    np.testing.assert_array_equal(back["w"], sd["w"])
    assert back["n"] == [1, 2]
    import torch

    crypto.save_encrypted({"t": torch.arange(3.0)}, str(tmp_path / "x.enc"),
                          key="k")
    np.testing.assert_array_equal(
        jcrypto.load_encrypted(str(tmp_path / "x.enc"), key="k")["t"],
        np.arange(3.0, dtype=np.float32))


def _defaults(obj):
    return dataclasses.asdict(obj)


def test_strategy_defaults_and_json_equal_jax():
    j, t = jstrategy.DistributedStrategy(), tstrategy.DistributedStrategy()
    assert _defaults(j) == _defaults(t)
    for name in ("DGCConfig", "LocalSGDConfig", "HybridConfig",
                 "ShardingConfig", "PipelineConfig", "AMPConfig"):
        assert _defaults(getattr(jstrategy, name)()) == \
            _defaults(getattr(tstrategy, name)())
    t.dgc = True
    t.dgc_configs = {"sparsity": 0.99}
    t.hybrid_configs = {"dp_degree": 2, "pp_degree": 4}
    back = jstrategy.DistributedStrategy.from_json(t.to_json())
    assert back.dgc and back.dgc_configs.sparsity == 0.99
    assert back.mesh_shape() == t.mesh_shape()
    assert tstrategy.DistributedStrategy.from_json(back.to_json()) == t


def test_util_over_four_ranks():
    files = [f"f{i}" for i in range(10)]
    values = [np.array([r, -r, 2.5 * r]) for r in range(4)]
    outs = run_ranks_all([{"kind": "util", "mesh": {"dp": 4},
                           "device": "cpu", "values": values,
                           "files": files}], 4)
    stacked = np.stack(values)
    shards = []
    for r, (out,) in enumerate(outs):
        assert out["backend"] == "gloo"
        np.testing.assert_array_equal(out["sum"], stacked.sum(0))
        np.testing.assert_array_equal(out["max"], stacked.max(0))
        np.testing.assert_array_equal(out["min"], stacked.min(0))
        assert [int(x) for x in out["gather"]] == [0, 1, 2, 3]
        shards.append(out["shard"])
    assert shards == [files[0:3], files[3:6], files[6:8], files[8:10]]


def run_ranks_all(cases, world):
    from paddle_tpu_torch.distributed import spawn
    from paddle_tpu_torch.tools import hybrid_check as hc

    return spawn.spawn(hc.run_cases, (cases,), nprocs=world, device="cpu")


def test_util_one_rank_and_role_maker():
    from paddle_tpu_torch.distributed.fleet.util import UtilBase
    from paddle_tpu_torch.distributed.role_maker import UserDefinedRoleMaker

    u = UtilBase()
    np.testing.assert_array_equal(u.all_reduce([1, 2], "max"), [1, 2])
    assert [int(x) for x in u.all_gather(7)] == [7]
    u.barrier()
    assert u.get_file_shard(["a", "b"]) == ["a", "b"]
    with pytest.raises(ValueError, match="sum/max/min"):
        u.all_reduce(1, "mean")
    rm = UserDefinedRoleMaker(current_id=2, worker_num=3)
    assert UtilBase(rm).get_file_shard(list("abcdefg")) == ["f", "g"]


def test_local_fs(tmp_path):
    fs = LocalFS()
    d = str(tmp_path / "a" / "b")
    fs.mkdirs(d)
    assert fs.is_dir(d) and fs.is_exist(d) and not fs.is_file(d)
    f = os.path.join(d, "x.txt")
    fs.touch(f)
    assert fs.is_file(f)
    with pytest.raises(FileExistsError):
        fs.touch(f, exist_ok=False)
    fs.mkdirs(os.path.join(d, "sub"))
    assert fs.ls_dir(d) == (["sub"], ["x.txt"])
    assert fs.list_dirs(d) == ["sub"]
    g = os.path.join(d, "y.txt")
    fs.mv(f, g)
    assert fs.is_file(g) and not fs.is_exist(f)
    fs.touch(f)
    with pytest.raises(FileExistsError):
        fs.mv(f, g)
    fs.mv(f, g, overwrite=True)
    up = str(tmp_path / "up.txt")
    fs.upload(g, up)
    fs.download(up, str(tmp_path / "down.txt"))
    assert fs.is_file(str(tmp_path / "down.txt"))
    fs.delete(str(tmp_path / "a"))
    assert not fs.is_exist(str(tmp_path / "a"))
    assert fs.ls_dir(str(tmp_path / "missing")) == ([], [])
    with pytest.raises(FileNotFoundError):
        fs.mv(str(tmp_path / "missing"), str(tmp_path / "z"))


def test_hdfs_client_refuses_without_hadoop(tmp_path):
    c = HDFSClient(hadoop_home=str(tmp_path / "no_hadoop"))
    with pytest.raises(RuntimeError, match="hadoop CLI not found"):
        c.is_exist("/x")


TORCH_FREE = ["paddle_tpu_torch.io", "paddle_tpu_torch.io.native_reader",
              "paddle_tpu_torch.framework.errors",
              "paddle_tpu_torch.framework.monitor",
              "paddle_tpu_torch.framework.crypto",
              "paddle_tpu_torch.distributed.fleet.strategy",
              "paddle_tpu_torch.distributed.fleet.data_generator",
              "paddle_tpu_torch.distributed.fleet.utils.fs",
              "paddle_tpu_torch.distributed.fleet.metrics",
              "paddle_tpu_torch.distributed.fleet.dataset",
              "paddle_tpu_torch.distributed.fleet.util",
              "paddle_tpu_torch.distributed.pp_schedule"]


def test_host_modules_import_without_torch():
    """A PS server or a data-generator process starts without torch:
    these modules import with ``torch`` blocked in ``sys.modules``, and
    the monitor's snapshot still answers ({})."""
    code = ("import sys; sys.modules['torch'] = None\n"
            "import importlib\n"
            f"for m in {TORCH_FREE!r}: importlib.import_module(m)\n"
            "from paddle_tpu_torch.framework import monitor\n"
            "assert monitor.snapshot_device_stats() == {}\n"
            "from paddle_tpu_torch.distributed import pp_schedule\n"
            "pp_schedule.build(2, 2, 4)\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
