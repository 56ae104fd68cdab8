"""Role makers: cluster-spec discovery from environment variables.

Counterpart of ``paddle_tpu/distributed/role_maker.py``
(``PaddleCloudRoleMaker`` :65, ``UserDefinedRoleMaker`` :105; the
reference's fleet/base/role_maker.py:530).  ``PaddleCloudRoleMaker``
parses the PADDLE_* environment the launcher exports (trainer id, number
and endpoints, TRAINING_ROLE, the pserver endpoints) and answers
is_worker / is_server / rank / size; ``UserDefinedRoleMaker`` takes the
same facts explicitly.  A collective job's ranks get their topology from
``launch.py``'s environment (what ``env.init_process`` reads); the PS pod
(``launch --server_num``) exports TRAINING_ROLE and
PADDLE_PSERVER_ENDPOINTS, which these role makers surface."""
from __future__ import annotations

import os

__all__ = ["Role", "RoleMakerBase", "PaddleCloudRoleMaker",
           "UserDefinedRoleMaker"]


class Role:
    WORKER = 1
    SERVER = 2


class RoleMakerBase:
    def __init__(self):
        self._role = Role.WORKER
        self._current_id = 0
        self._worker_num = 1
        self._server_num = 0
        self._worker_endpoints: list[str] = []
        self._server_endpoints: list[str] = []

    def is_worker(self) -> bool:
        return self._role == Role.WORKER

    def is_server(self) -> bool:
        return self._role == Role.SERVER

    def is_first_worker(self) -> bool:
        return self.is_worker() and self._current_id == 0

    def worker_index(self) -> int:
        return self._current_id if self.is_worker() else -1

    def server_index(self) -> int:
        return self._current_id if self.is_server() else -1

    def worker_num(self) -> int:
        return self._worker_num

    def server_num(self) -> int:
        return self._server_num

    def get_trainer_endpoints(self) -> list[str]:
        return list(self._worker_endpoints)

    def get_pserver_endpoints(self) -> list[str]:
        return list(self._server_endpoints)

    def role_id(self) -> int:
        return self._current_id


class PaddleCloudRoleMaker(RoleMakerBase):
    """Parse the launcher-exported env (role_maker.py:530 analog).

    Collective mode (is_collective=True): rank/size from
    PADDLE_TRAINER_ID/PADDLE_TRAINERS_NUM (or the paddle_tpu process env).
    PS mode: TRAINING_ROLE selects worker/server and
    PADDLE_PSERVER_ENDPOINTS lists the table servers (launch --server_num
    exports exactly these)."""

    def __init__(self, is_collective: bool = True, **kw):
        super().__init__()
        self._is_collective = is_collective
        env = os.environ
        self._current_id = int(env.get("PADDLE_TRAINER_ID", 0))
        self._worker_num = int(env.get("PADDLE_TRAINERS_NUM",
                                       env.get("PADDLE_TPU_NUM_PROCESSES",
                                               1)))
        eps = env.get("PADDLE_TRAINER_ENDPOINTS", "")
        self._worker_endpoints = [e for e in eps.split(",") if e]
        ps = env.get("PADDLE_PSERVER_ENDPOINTS", "")
        self._server_endpoints = [e for e in ps.split(",") if e]
        self._server_num = len(self._server_endpoints)
        role = env.get("TRAINING_ROLE", "TRAINER").upper()
        if role in ("PSERVER", "SERVER"):
            self._role = Role.SERVER
            self._current_id = int(env.get("PADDLE_PSERVER_ID",
                                           env.get("POD_INDEX", 0)))
        else:
            self._role = Role.WORKER

    def ps_client(self):
        """Connect a PSClient to the pod's table servers."""
        from .ps_service import PSClient

        if not self._server_endpoints:
            raise RuntimeError("no PADDLE_PSERVER_ENDPOINTS in env — run "
                               "under launch --server_num")
        return PSClient(self._server_endpoints)


class UserDefinedRoleMaker(RoleMakerBase):
    def __init__(self, current_id: int = 0, role: int = Role.WORKER,
                 worker_num: int = 1, server_endpoints=None,
                 worker_endpoints=None):
        super().__init__()
        self._current_id = current_id
        self._role = role
        self._worker_num = worker_num
        self._server_endpoints = list(server_endpoints or [])
        self._worker_endpoints = list(worker_endpoints or [])
        self._server_num = len(self._server_endpoints)
