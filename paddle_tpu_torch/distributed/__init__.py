"""paddle.distributed for one process on one device: the launcher
environment (`env`), `init_parallel_env` / `init`, `ParallelEnv`,
`DataParallel` and `barrier` at world size 1 (`parallel`), the
one-device mesh (`mesh`), and `fleet`. The collectives, process groups,
`spawn`, the stores, the launcher and the parameter server need more than
one rank (ROADMAP queue 1 item 7)."""
from . import env, fleet
from .env import get_rank, get_world_size, init_distributed
from .mesh import build_mesh, get_mesh, set_mesh
from .parallel import DataParallel, ParallelEnv, barrier, init_parallel_env

init = init_parallel_env        # paddle.distributed's alias

__all__ = ["env", "fleet", "get_rank", "get_world_size", "init_distributed",
           "build_mesh", "get_mesh", "set_mesh", "DataParallel",
           "ParallelEnv", "barrier", "init_parallel_env", "init"]
