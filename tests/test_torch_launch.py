"""The port's launch CLI, KV store and elastic membership
(paddle_tpu_torch/distributed/{launch,kvstore,elastic,role_maker}.py) —
twins of tests/test_launch.py's eight cases, and the KV wire held against
the JAX package's store in both directions.

The launched scripts are torch ranks on the CPU (``--device cpu``: gloo,
the process group from the launcher's ``tcp://`` init method), or plain
scripts where the case is about the watch loop.  The elastic case's pod
sleeps 6 s and the launcher's TTL is 4 s (the JAX case: 25 s and 8 s),
which still leaves the heartbeat thread seconds of slack under a loaded
run.
"""
import os
import socket
import subprocess
import sys
import threading
import time

import pytest

from paddle_tpu.distributed import kvstore as jkv
from paddle_tpu_torch.distributed import kvstore as tkv
from paddle_tpu_torch.distributed.elastic import ElasticManager, ElasticStatus
from paddle_tpu_torch.distributed.kvstore import KVClient, KVServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env(**extra):
    env = dict(os.environ, **extra)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    return env


def _launch(*args, timeout=120, env=None):
    return subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch", *args],
        cwd=REPO, capture_output=True, text=True, timeout=timeout,
        env=env or _env())


@pytest.fixture()
def kv():
    srv = KVServer()
    host, port = srv.start()
    clients = []

    def make():
        c = KVClient(host, port)
        clients.append(c)
        return c

    yield make
    for c in clients:
        c.close()
    srv.shutdown()


def test_kv_set_get_add(kv):
    c = kv()
    assert c.set("a", {"x": 1})
    assert c.get("a") == {"x": 1}
    assert c.get("missing") is None
    assert c.add("ctr") == 1
    assert c.add("ctr", 5) == 6
    assert sorted(c.keys()) == ["a", "ctr"]


def test_kv_blocking_get(kv):
    c1, c2 = kv(), kv()

    def setter():
        time.sleep(0.2)
        c2.set("late", 42)

    t = threading.Thread(target=setter)
    t.start()
    assert c1.get("late", timeout=5) == 42
    t.join()


def test_kv_barrier(kv):
    results = []
    cs = [kv() for _ in range(3)]
    ts = [threading.Thread(target=lambda c=c: results.append(
        c.barrier("b1", 3, timeout=10))) for c in cs]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert results == [True, True, True]


@pytest.mark.parametrize("server_pkg,client_pkg", [("jax", "port"),
                                                   ("port", "jax")])
def test_kv_wire_across_packages(server_pkg, client_pkg):
    """A port client on a JAX store and a JAX client on a port store:
    every op, the blocking get, the barrier and the server-clock
    snapshot."""
    srv = (jkv if server_pkg == "jax" else tkv).KVServer()
    host, port = srv.start()
    mod = jkv if client_pkg == "jax" else tkv
    c, c2 = mod.KVClient(host, port), mod.KVClient(host, port)
    try:
        assert c.set("k", [1, "two", {"3": 3.5}])
        assert c2.get("k") == [1, "two", {"3": 3.5}]
        assert c.add("n", 2) == 2 and c2.add("n") == 3
        threading.Timer(0.1, lambda: c2.set("late", "x")).start()
        assert c.get("late", timeout=5) == "x"
        assert c.barrier("b", 1, timeout=5)
        assert c.stamp("elastic/host/a")
        kvs, now = c2.snapshot("elastic/host/")
        assert list(kvs) == ["elastic/host/a"] and now >= kvs["elastic/host/a"]
        assert sorted(c.keys()) == ["b", "elastic/host/a", "k", "late", "n"]
        assert c.delete("k") and c2.get("k") is None
    finally:
        c.close()
        c2.close()
        srv.shutdown()


def test_elastic_membership(kv):
    c1, c2 = kv(), kv()
    m1 = ElasticManager(c1, "hostA", np_range=(1, 4),
                        heartbeat_interval=0.1, ttl=1.0).register()
    assert m1.check() == ElasticStatus.OK
    m2 = ElasticManager(c2, "hostB", np_range=(1, 4),
                        heartbeat_interval=0.1, ttl=1.0).register()
    assert m2.wait_for_np(2, timeout=5)
    assert m1.check() == ElasticStatus.SCALE     # the join
    assert m1.check() == ElasticStatus.OK
    m2.deregister()
    time.sleep(0.1)
    assert m1.check() == ElasticStatus.SCALE     # the leave
    m1.deregister()


def test_launch_cli_runs_torch_ranks(tmp_path):
    """Two gloo ranks on the CPU join one process group from the
    launcher's environment and all-reduce."""
    script = tmp_path / "train.py"
    script.write_text(
        "import os, torch, torch.distributed as dist\n"
        "from paddle_tpu_torch.distributed import env\n"
        "dev = env.init_process()\n"
        "t = torch.ones(3) * (dist.get_rank() + 1)\n"
        "dist.all_reduce(t)\n"
        "print(f'rank {os.environ[\"PADDLE_TRAINER_ID\"]}/'\n"
        "      f'{os.environ[\"PADDLE_TRAINERS_NUM\"]} ok on {dev} '\n"
        "      f'sum {int(t[0])}', flush=True)\n"
        "dist.destroy_process_group()\n")
    log_dir = tmp_path / "logs"
    r = _launch("--nproc_per_host", "2", "--device", "cpu", "--coordinator",
                "127.0.0.1:0", "--log_dir", str(log_dir), str(script))
    assert r.returncode == 0, r.stderr
    assert sorted(os.listdir(log_dir)) == ["worker.0.log", "worker.1.log"]
    assert "rank 1/2 ok on cpu sum 3" in (log_dir / "worker.1.log").read_text()


def test_launch_elastic_scale_relaunch(tmp_path):
    """A new host heartbeating into the coordinator's store triggers a
    pod relaunch; its one heartbeat expiring triggers another, and the
    last pod runs to its end."""
    script = tmp_path / "train.py"
    script.write_text(
        "import os, time\n"
        "print('POD-START world', os.environ['PADDLE_TRAINERS_NUM'],"
        " flush=True)\n"
        "time.sleep(6)\n")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--coordinator", f"127.0.0.1:{port}", "--elastic_np", "1:4",
         str(script)], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=_env(PADDLE_ELASTIC_HEARTBEAT="0.3", PADDLE_ELASTIC_TTL="4.0"))
    try:
        c = KVClient("127.0.0.1", port)
        deadline = time.time() + 30
        while time.time() < deadline:
            kvs, _ = c.snapshot("elastic/host/")
            if any(k.endswith("node0") for k in kvs):
                break
            time.sleep(0.1)
        else:
            raise TimeoutError("launcher never registered membership")
        time.sleep(0.5)   # the post-register baseline snapshot lands
        c.stamp("elastic/host/node99")     # a second host joins
        out, err = proc.communicate(timeout=90)
        c.close()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert "elastic scale event" in err, err
    assert out.count("POD-START") >= 2, out


def test_role_maker_env_parsing(monkeypatch):
    from paddle_tpu_torch.distributed.role_maker import (
        PaddleCloudRoleMaker, UserDefinedRoleMaker)

    monkeypatch.setenv("PADDLE_TRAINER_ID", "2")
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "4")
    monkeypatch.setenv("PADDLE_TRAINER_ENDPOINTS",
                       "h0:8000,h1:8000,h2:8000,h3:8000")
    monkeypatch.setenv("PADDLE_PSERVER_ENDPOINTS", "h0:9000,h1:9000")
    monkeypatch.setenv("TRAINING_ROLE", "TRAINER")
    rm = PaddleCloudRoleMaker()
    assert rm.is_worker() and not rm.is_server()
    assert rm.worker_index() == 2 and rm.worker_num() == 4
    assert rm.server_num() == 2
    assert rm.get_pserver_endpoints() == ["h0:9000", "h1:9000"]
    assert not rm.is_first_worker()

    monkeypatch.setenv("TRAINING_ROLE", "PSERVER")
    monkeypatch.setenv("PADDLE_PSERVER_ID", "1")
    rs = PaddleCloudRoleMaker()
    assert rs.is_server() and rs.server_index() == 1

    u = UserDefinedRoleMaker(current_id=0, worker_num=2,
                             worker_endpoints=["a:1", "b:1"])
    assert u.is_first_worker() and u.worker_num() == 2


def test_launch_restarts_on_failure(tmp_path):
    marker = tmp_path / "marker"
    script = tmp_path / "flaky.py"
    script.write_text(
        f"import os, sys\n"
        f"m = {str(marker)!r}\n"
        f"if not os.path.exists(m):\n"
        f"    open(m, 'w').close()\n"
        f"    sys.exit(3)\n"
        f"print('recovered')\n")
    r = _launch("--coordinator", "127.0.0.1:0", "--max_restarts", "1",
                str(script))
    assert r.returncode == 0, (r.stdout, r.stderr)
    assert "restart 1/1" in r.stderr
    assert "recovered" in r.stdout
