"""Relaunch and AutoCheckpoint kill test for the port (paddle_tpu_torch/
distributed/launch.py + framework/checkpoint.py) — the twin of
tests/test_elastic_checkpoint.py: a 2-rank pod of gloo CPU ranks trains
with a row-sharded checkpoint every step (each rank writes its own
chunk, ``Shard`` starts [rank, 0]); rank 1 is SIGKILLed at step 6 before
it saves; the launcher relaunches the pod, both ranks resume from the
same newest complete step, and every rank ends at 1 + 2 + ... + 12 = 78,
the state of an uninterrupted run.  A gloo all-reduce couples the ranks
each step, so the survivor cannot run ahead alone.
"""
import os
import subprocess
import sys

_TRAIN = r"""
import os, signal
import torch
import torch.distributed as dist
from paddle_tpu_torch.distributed import env
from paddle_tpu_torch.framework.checkpoint import AutoCheckpoint, Shard

env.init_process()
rank = dist.get_rank()
TOTAL = 12
state = {"w": Shard(torch.zeros(1, 8), (rank, 0), (2, 8))}
acp = AutoCheckpoint(os.environ["TEST_CKPT_DIR"], every_steps=1, keep_max=6)
state, start = acp.resume(state)
print(f"rank {rank} resumed at step {start}", flush=True)
for step in range(start + 1, TOTAL + 1):
    state = {"w": Shard(state["w"].data + float(step), (rank, 0), (2, 8))}
    if rank == 1 and step == 6 and not os.path.exists(
            os.environ["TEST_MARKER"]):
        open(os.environ["TEST_MARKER"], "w").close()
        os.kill(os.getpid(), signal.SIGKILL)      # dies BEFORE saving step 6
    dist.all_reduce(state["w"].data.clone())       # cross-rank coupling
    acp.maybe_save(state, step)
mine = state["w"].data
assert torch.all(mine == sum(range(1, TOTAL + 1))), (rank, mine)
with open(os.environ["TEST_DONE"] + f".{rank}", "w") as f:
    f.write(str(float(mine[0, 0])))
print(f"rank {rank} DONE {float(mine[0, 0])}", flush=True)
dist.destroy_process_group()
"""


def test_kill_rank_resumes_from_sharded_checkpoint(tmp_path):
    script = tmp_path / "train.py"
    script.write_text(_TRAIN)
    marker = tmp_path / "killed"
    log_dir = tmp_path / "logs"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, TEST_CKPT_DIR=str(tmp_path / "ckpt"),
               TEST_MARKER=str(marker), TEST_DONE=str(tmp_path / "done"),
               PYTHONPATH=os.pathsep.join(
                   [repo] + ([os.environ["PYTHONPATH"]]
                             if os.environ.get("PYTHONPATH") else [])))
    r = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_host", "2", "--device", "cpu", "--coordinator",
         "127.0.0.1:0", "--max_restarts", "2", "--log_dir", str(log_dir),
         str(script)],
        cwd=repo, capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-2000:])
    assert marker.exists(), "the kill never happened"
    assert "pod restart" in r.stderr, r.stderr[-2000:]
    for rank in (0, 1):
        f = tmp_path / f"done.{rank}"
        assert f.exists(), (rank, r.stderr[-2000:])
        assert float(f.read_text()) == float(sum(range(1, 13)))
    # the relaunched pod resumed from a checkpoint, not step 0, and both
    # ranks chose the same step (verify_step's global completeness)
    per_rank = {}
    for p in os.listdir(log_dir):
        rank = int(p.split(".")[1])
        per_rank[rank] = [int(line.rsplit("step", 1)[1])
                          for line in (log_dir / p).read_text().splitlines()
                          if "resumed at step" in line]
    finals = {r: v[-1] for r, v in per_rank.items() if v}
    assert len(finals) == 2 and len(set(finals.values())) == 1, per_rank
    assert next(iter(finals.values())) >= 4, per_rank
