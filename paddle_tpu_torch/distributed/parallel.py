"""Dygraph data parallelism at world size 1 (port of paddle_tpu's
`distributed/parallel.py`): `init_parallel_env`, `ParallelEnv`,
`DataParallel` and `barrier`.

`init_parallel_env()` bootstraps the one process (`env.init_distributed`:
more processes raise, ROADMAP queue 1 item 7) and sets the one-device
`dp` mesh on the default device as the current mesh when there is none.
`DataParallel(layer)` is the layer at one rank: forward, `state_dict` and
`set_state_dict` pass through, every other attribute is the layer's, and
`apply_collective_grads()` has nothing to average. `barrier()` waits for
the work queued on the current mesh's device. The collectives and groups
need more than one rank (ROADMAP queue 1 item 7)."""
from __future__ import annotations

import torch

from . import env as env_mod
from . import mesh as mesh_mod
from .env import MULTI_DEVICE

__all__ = ["init_parallel_env", "ParallelEnv", "DataParallel", "barrier"]


class ParallelEnv:
    """Env-derived rank info (paddle's dygraph ParallelEnv)."""

    @property
    def rank(self):
        return env_mod.get_rank()

    @property
    def world_size(self):
        return env_mod.get_world_size()

    @property
    def device_id(self):
        return 0

    local_rank = rank
    nranks = world_size


def init_parallel_env():
    """The one-process bootstrap and a default one-device 'dp' mesh."""
    env_mod.init_distributed()
    if mesh_mod.get_mesh() is None:
        mesh_mod.set_mesh(mesh_mod.build_mesh())
    return ParallelEnv()


def barrier(group=None):
    """At one rank: wait for the work queued on the current mesh's device
    (nothing to wait for without a mesh or on the CPU)."""
    if group is not None:
        raise NotImplementedError(
            f"barrier(group=): process groups need more than one rank "
            f"({MULTI_DEVICE})")
    m = mesh_mod.get_mesh()
    if m is not None and m.device.type == "cuda":
        torch.cuda.synchronize(m.device)


class DataParallel:
    """A layer with DDP's API at world size 1: forward passes through,
    and `apply_collective_grads()` (which averages the gradients over the
    ranks after `backward`) leaves them as they are."""

    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None):
        if group is not None:
            raise NotImplementedError(
                f"DataParallel(group=): process groups need more than one "
                f"rank ({MULTI_DEVICE})")
        self._layers = layers
        self._group = group
        self.find_unused_parameters = find_unused_parameters

    def __call__(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(self.__dict__["_layers"], name)

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    def apply_collective_grads(self):
        if env_mod.get_world_size() > 1:
            raise NotImplementedError(
                f"DataParallel over more than one rank ({MULTI_DEVICE})")

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def set_state_dict(self, *a, **k):
        return self._layers.set_state_dict(*a, **k)
