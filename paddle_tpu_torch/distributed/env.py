"""The process-group environment (port of paddle_tpu's `distributed/
env.py`), for one process: rank and world size read from paddle's
launcher protocol (`PADDLE_TRAINER_ID`, `PADDLE_TRAINERS_NUM`), and
`ParallelEnv` over them.

`init_distributed` is the one-process bootstrap: it reads the world size
(an argument, else `PADDLE_TRAINERS_NUM`, else 1) and raises
`NotImplementedError` for more than one process, which needs a
`torch.distributed` process group over NCCL (ROADMAP queue 1 item 7).
Nothing runs as one process while the environment says there are more:
`get_world_size` and `ParallelEnv` read the same variables, and every
entry point that builds on them (`init_parallel_env`, `fleet.init`)
calls `init_distributed` first."""
from __future__ import annotations

import os

__all__ = ["get_rank", "get_world_size", "init_distributed", "ParallelEnv"]

# where the port's errors point for what needs more than one device or
# process
MULTI_DEVICE = "ROADMAP queue 1 item 7"

_initialized = False


def get_rank() -> int:
    """Global process rank (`PADDLE_TRAINER_ID`, default 0)."""
    return int(os.environ.get("PADDLE_TRAINER_ID", "0"))


def get_world_size() -> int:
    """Number of processes (`PADDLE_TRAINERS_NUM`, default 1)."""
    return int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None):
    """The JAX package's bootstrap call, for one process: more than one
    process raises `NotImplementedError`."""
    global _initialized
    n = num_processes if num_processes is not None else get_world_size()
    if int(n) > 1:
        raise NotImplementedError(
            f"init_distributed: {n} processes; paddle_tpu_torch runs one "
            f"process on one device (multi-process training over NCCL: "
            f"{MULTI_DEVICE})")
    _initialized = True


class ParallelEnv:
    """Rank information from the launcher's environment (paddle's
    `fluid/dygraph/parallel.py` ParallelEnv)."""

    @property
    def rank(self):
        return get_rank()

    @property
    def world_size(self):
        return get_world_size()

    @property
    def local_rank(self):
        return int(os.environ.get("PADDLE_LOCAL_RANK", "0"))

    @property
    def dev_id(self):
        return self.local_rank

    @property
    def trainer_endpoints(self):
        return os.environ.get("PADDLE_TRAINER_ENDPOINTS", "").split(",")

    @property
    def current_endpoint(self):
        return os.environ.get("PADDLE_CURRENT_ENDPOINT", "")

    @property
    def nranks(self):
        return self.world_size
