"""Role makers for parameter-server fleets (counterpart of
paddle_tpu/distributed/fleet/role_maker.py, transcribed): PaddleCloudRoleMaker
reads the cloud env contract, UserDefinedRoleMaker takes explicit args;
the Role.WORKER / SERVER enum.
"""
from __future__ import annotations

import os

__all__ = ["Role", "RoleMakerBase", "PaddleCloudRoleMaker",
           "UserDefinedRoleMaker"]


class Role:
    WORKER = 1
    SERVER = 2


class RoleMakerBase:
    """Answers: what am I, which index, who are the servers/workers."""

    def __init__(self):
        self._role = Role.WORKER
        self._current_id = 0
        self._worker_num = 1
        self._server_endpoints = []
        self._is_collective = False      # role makers exist for PS fleets

    def is_worker(self):
        return self._role == Role.WORKER

    def is_server(self):
        return self._role == Role.SERVER

    def is_first_worker(self):
        return self.is_worker() and self._current_id == 0

    def worker_index(self):
        return self._current_id

    def server_index(self):
        return self._current_id

    def worker_num(self):
        return self._worker_num

    def server_num(self):
        return len(self._server_endpoints)

    def get_pserver_endpoints(self):
        return list(self._server_endpoints)


class PaddleCloudRoleMaker(RoleMakerBase):
    """Env-contract role maker:
    TRAINING_ROLE=TRAINER|PSERVER, PADDLE_PSERVERS_IP_PORT_LIST,
    PADDLE_TRAINERS_NUM, PADDLE_TRAINER_ID / PADDLE_PSERVER_ID."""

    def __init__(self, is_collective=False, **kwargs):
        super().__init__()
        self._is_collective = is_collective
        if is_collective:
            return
        role = os.environ.get("TRAINING_ROLE", "TRAINER").upper()
        self._role = Role.SERVER if role == "PSERVER" else Role.WORKER
        eps = os.environ.get("PADDLE_PSERVERS_IP_PORT_LIST", "")
        self._server_endpoints = [e for e in eps.split(",") if e]
        self._worker_num = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
        self._current_id = int(
            os.environ.get("PADDLE_PSERVER_ID", "0") if self.is_server()
            else os.environ.get("PADDLE_TRAINER_ID", "0"))


class UserDefinedRoleMaker(RoleMakerBase):
    """Explicit-args role maker."""

    def __init__(self, current_id=0, role=Role.WORKER, worker_num=1,
                 server_endpoints=None):
        super().__init__()
        self._current_id = int(current_id)
        self._role = role
        self._worker_num = int(worker_num)
        self._server_endpoints = list(server_endpoints or [])
