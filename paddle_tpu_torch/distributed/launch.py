"""Launch CLI: ``python -m paddle_tpu_torch.distributed.launch``.

Counterpart of ``paddle_tpu/distributed/launch.py`` (``parse_args`` :33,
``_proc_env`` :60, ``TrainerProc`` :82, ``launch_ps`` :115, ``launch``
:209 with the elastic watch, ``main`` :350; the reference's
fleet/launch.py and launch_utils.py).  The port runs one process a
rank, not one a host.  The launcher:

1. rendezvous — node 0 runs the KV server (``kvstore.py``) at
   ``--coordinator``; every node registers there, and node 0 publishes
   the ``tcp://`` address on which rank 0's process group store will
   listen (a free port, fresh at every pod start, so that a restarted
   pod never meets its predecessor's store);
2. exports what ``env.init_process`` reads — ``PADDLE_TRAINER_ID``,
   ``PADDLE_TRAINERS_NUM``, ``PADDLE_TPU_INIT_METHOD`` (and
   ``PADDLE_TPU_DEVICE`` under ``--device``) — plus the reference's
   ``PADDLE_*`` variables;
3. spawns the training script, one process a rank, watches the pod and
   restarts it on a failure up to ``--max_restarts``; with
   ``--elastic_np MIN:MAX`` it heartbeats into the KV store and
   relaunches the pod on a scale event (``elastic.py``).

``--nproc_per_host N`` runs N ranks on this host: one a card (NCCL), or
on the CPU over gloo with ``--device cpu`` — what replaces the JAX
launcher's ``JAX_PLATFORMS=cpu`` simulation.  ``--server_num N
--worker_num M`` starts a parameter-server pod instead: N table servers
(``ps_service.py``, CPU processes) and M trainers, which find the
servers in ``PADDLE_PSERVER_ENDPOINTS``.  The launcher itself imports
neither torch nor a card.
"""
from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import time

from .kvstore import KVClient, KVServer


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="paddle_tpu_torch.distributed.launch",
        description="launch distributed training (one process per rank)")
    p.add_argument("--nnodes", type=int, default=1,
                   help="number of hosts in the job (one rank each)")
    p.add_argument("--node_rank", type=int, default=0)
    p.add_argument("--coordinator", default="127.0.0.1:37777",
                   help="host:port of node 0's rendezvous KV store")
    p.add_argument("--nproc_per_host", type=int, default=1,
                   help="ranks on this host (single-host job)")
    p.add_argument("--device", default=None,
                   help="'cpu' puts every rank on the CPU (gloo); by "
                        "default ranks go on the cards (env.placement)")
    p.add_argument("--max_restarts", type=int, default=0)
    p.add_argument("--log_dir", default=None)
    p.add_argument("--elastic_np", default=None,
                   help="MIN:MAX live-host range; watch KV membership and "
                        "relaunch the pod on scale events (reference "
                        "ElasticManager, fleet/elastic.py:90)")
    p.add_argument("--server_num", type=int, default=0,
                   help="parameter-server mode: spawn N table servers "
                        "(reference ParameterServerLauncher)")
    p.add_argument("--worker_num", type=int, default=1,
                   help="parameter-server mode: trainer process count")
    p.add_argument("training_script")
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def free_port(host: str = "127.0.0.1") -> int:
    with socket.socket() as s:
        s.bind((host, 0))
        return s.getsockname()[1]


def _proc_env(rank: int, world: int, coordinator: str, init_method: str,
              device=None):
    env = dict(os.environ)
    env.update({
        # what env.init_process reads
        "PADDLE_TRAINER_ID": str(rank),
        "PADDLE_TRAINERS_NUM": str(world),
        "PADDLE_TPU_INIT_METHOD": init_method,
        # reference-shaped env so ported scripts keep working
        "PADDLE_TPU_COORDINATOR": coordinator,
        "PADDLE_TPU_NUM_PROCESSES": str(world),
        "PADDLE_TPU_PROCESS_ID": str(rank),
        "PADDLE_CURRENT_ENDPOINT": coordinator,
        "TRAINING_ROLE": "TRAINER",
    })
    if device is not None:
        env["PADDLE_TPU_DEVICE"] = str(device)
    return env


class TrainerProc:
    def __init__(self, cmd, env, log_path, rank):
        self.cmd, self.env, self.log_path, self.rank = cmd, env, log_path, rank
        self.restarts = 0
        self.proc: subprocess.Popen | None = None
        self._log = None

    def start(self):
        if self._log:  # restart: drop the previous handle first
            self._log.close()
            self._log = None
        if self.log_path:
            self._log = open(self.log_path, "ab")
        self.proc = subprocess.Popen(
            self.cmd, env=self.env,
            stdout=self._log or None, stderr=self._log or None)

    def poll(self):
        return self.proc.poll() if self.proc else None

    def terminate(self):
        if self.proc and self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()  # reap: the old rank must free its ports
        if self._log:
            self._log.close()
            self._log = None


def launch_ps(args) -> int:
    """Parameter-server pod: N table servers + M trainer workers
    (reference ParameterServerLauncher, fleet/launch_utils.py:788).
    Servers run ``paddle_tpu_torch.distributed.ps_service``; workers get
    PADDLE_PSERVER_ENDPOINTS / TRAINING_ROLE / PADDLE_TRAINER_ID."""
    import shutil
    import tempfile

    if args.log_dir:
        os.makedirs(args.log_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="pt_ps_")
    try:
        return _launch_ps_impl(args, tmp, args.log_dir)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _launch_ps_impl(args, tmp, log_dir) -> int:
    servers: list[TrainerProc] = []
    for i in range(args.server_num):
        ready = os.path.join(tmp, f"ep{i}.txt")
        cmd = [sys.executable, "-u", "-m",
               "paddle_tpu_torch.distributed.ps_service",
               "--port", "0", "--server_idx", str(i),
               "--num_servers", str(args.server_num), "--ready_path", ready]
        env = dict(os.environ)
        env["TRAINING_ROLE"] = "PSERVER"
        env["PADDLE_PSERVER_ID"] = str(i)
        log = os.path.join(log_dir, f"server.{i}.log") if log_dir else None
        sp = TrainerProc(cmd, env, log, i)
        sp.ready_path = ready
        servers.append(sp)
    for sp in servers:
        sp.start()
    endpoints = []
    deadline = time.time() + 120
    for sp in servers:
        while not (os.path.exists(sp.ready_path)
                   and os.path.getsize(sp.ready_path)):
            if sp.poll() is not None:
                for s in servers:
                    s.terminate()
                print(f"[launch] ps server {sp.rank} died during startup",
                      file=sys.stderr)
                return 1
            if time.time() > deadline:
                for s in servers:
                    s.terminate()
                print("[launch] ps servers did not come up", file=sys.stderr)
                return 1
            time.sleep(0.02)
        with open(sp.ready_path) as f:
            endpoints.append(f.read().strip())

    workers: list[TrainerProc] = []
    init_method = f"tcp://127.0.0.1:{free_port()}"
    for r in range(args.worker_num):
        cmd = [sys.executable, "-u", args.training_script,
               *args.training_script_args]
        env = _proc_env(r, args.worker_num, args.coordinator, init_method,
                        args.device)
        env["PADDLE_PSERVER_ENDPOINTS"] = ",".join(endpoints)
        log = os.path.join(log_dir, f"worker.{r}.log") if log_dir else None
        workers.append(TrainerProc(cmd, env, log, r))
    for w in workers:
        w.start()

    exit_code = 0
    try:
        while True:
            failed = [w for w in workers if w.poll() not in (None, 0)]
            dead_srv = [s for s in servers if s.poll() is not None]
            if failed or dead_srv:
                exit_code = (failed[0].poll() if failed
                             else dead_srv[0].poll()) or 1
                who = (f"worker {failed[0].rank}" if failed
                       else f"server {dead_srv[0].rank}")
                print(f"[launch] {who} exited abnormally; terminating pod",
                      file=sys.stderr)
                break
            if all(w.poll() == 0 for w in workers):
                break  # normal completion
            time.sleep(0.05)
    except KeyboardInterrupt:
        exit_code = exit_code or 1
    finally:
        for p in workers + servers:
            p.terminate()
    return exit_code


def launch(args) -> int:
    if args.server_num > 0:
        return launch_ps(args)
    coord_host, coord_port = args.coordinator.split(":")
    coord_port = int(coord_port)
    local = args.nproc_per_host > 1
    if local and args.nnodes > 1:
        raise SystemExit("--nproc_per_host > 1 is a single-host job; it "
                         "cannot combine with --nnodes")
    if args.nnodes > 1 and coord_port == 0:
        raise SystemExit("--nnodes > 1 needs a fixed --coordinator port "
                         "(every host must dial the same address)")
    bind = coord_host if coord_host != "localhost" else "127.0.0.1"
    server = None
    if args.node_rank == 0:
        server = KVServer(bind, coord_port)
        _, coord_port = server.start()  # port 0 -> the bound port
    coordinator = f"{coord_host}:{coord_port}"
    world = args.nnodes if not local else args.nproc_per_host

    # rendezvous: register and wait for everyone (gen_comm_id role)
    client = None
    if args.nnodes > 1:
        client = KVClient(coord_host, coord_port)
        client.set(f"host/{args.node_rank}", os.uname().nodename)
        client.barrier("launch/ready", args.nnodes)

    elastic = None
    if args.elastic_np:
        from .elastic import ElasticManager

        np_min, np_max = (int(v) for v in args.elastic_np.split(":"))
        if client is None:
            client = KVClient(coord_host, coord_port)
        # the TTL leaves slack for scheduler stalls on loaded hosts (a
        # starved heartbeat thread reads as a dead peer)
        hb = float(os.environ.get("PADDLE_ELASTIC_HEARTBEAT", "0.2"))
        ttl = float(os.environ.get("PADDLE_ELASTIC_TTL", "2.0"))
        elastic = ElasticManager(client, host_id=f"node{args.node_rank}",
                                 np_range=(np_min, np_max),
                                 heartbeat_interval=hb, ttl=ttl)
        elastic.register()
        if args.nnodes > 1:
            # wait for every expected peer's first heartbeat before the
            # baseline, or their arrival reads as a scale event
            elastic.wait_for_np(min(args.nnodes, np_max), timeout=60)
        elastic.resnapshot()

    generation = [0]

    def init_method_for(world_n: int) -> str:
        """The process group's tcp:// address for this pod start: node 0
        picks a free port and publishes it; the others read it."""
        generation[0] += 1
        if args.nnodes == 1:
            return f"tcp://127.0.0.1:{free_port()}"
        key = f"launch/init_method/{generation[0]}"
        if args.node_rank == 0:
            client.set(key, f"tcp://{coord_host}:{free_port(bind)}")
        found = client.get(key, timeout=120)
        if found is None:
            raise SystemExit("[launch] no init method from node 0")
        return found

    def spawn_pod(world_n: int, my_rank: int | None = None):
        init_method = init_method_for(world_n)
        ps = []
        ranks = range(world_n) if local else [
            my_rank if my_rank is not None else args.node_rank]
        for r in ranks:
            cmd = [sys.executable, "-u", args.training_script,
                   *args.training_script_args]
            env = _proc_env(r, world_n, coordinator, init_method,
                            args.device)
            log = (os.path.join(args.log_dir, f"worker.{r}.log")
                   if args.log_dir else None)
            if args.log_dir:
                os.makedirs(args.log_dir, exist_ok=True)
            ps.append(TrainerProc(cmd, env, log, r))
        for p in ps:
            p.start()
        return ps

    procs = spawn_pod(world)

    # watch loop: abnormal exit of ANY rank stops the whole pod (a process
    # group cannot survive a dead rank); restarts relaunch the POD, each
    # rank joining a fresh process group
    pod_restarts = 0
    exit_code = 0
    try:
        while True:
            alive = any(p.poll() is None for p in procs)
            failed = [p for p in procs if p.poll() not in (None, 0)]
            if elastic is not None and alive:
                status = elastic.check()
                if status == "scale":
                    # re-rank against the capped effective membership, so
                    # the surviving hosts' ranks stay contiguous
                    eff = elastic.effective_hosts()
                    me = f"node{args.node_rank}"
                    if not local and me not in eff:
                        print("[launch] elastic: this host fell out of the "
                              "effective membership; exiting", file=sys.stderr)
                        exit_code = 1
                        break
                    new_rank = eff.index(me) if not local else None
                    print(f"[launch] elastic scale event: effective hosts -> "
                          f"{len(eff)}; relaunching pod", file=sys.stderr)
                    for p in procs:
                        p.terminate()
                    world = len(eff) if not local else world
                    procs = spawn_pod(world, new_rank)
                    continue
                if status == "exit":
                    print("[launch] elastic: below np_min; terminating",
                          file=sys.stderr)
                    exit_code = 1
                    break
            if failed:
                rc = failed[0].poll()
                for p in procs:
                    p.terminate()
                if pod_restarts < args.max_restarts:
                    pod_restarts += 1
                    print(f"[launch] rank {failed[0].rank} exited {rc}; pod "
                          f"restart {pod_restarts}/{args.max_restarts}",
                          file=sys.stderr)
                    procs = spawn_pod(world)
                    continue
                print(f"[launch] rank {failed[0].rank} failed (exit {rc}); "
                      "terminating pod", file=sys.stderr)
                exit_code = rc
                break
            if not alive:
                break
            time.sleep(0.05)
    except KeyboardInterrupt:
        exit_code = exit_code or 1
    finally:
        for p in procs:
            p.terminate()
        if elastic is not None:
            elastic.deregister()
        if client:
            client.close()
        if server:
            server.shutdown()
    return exit_code


def main(argv=None):
    sys.exit(launch(parse_args(argv)))


if __name__ == "__main__":
    main()
