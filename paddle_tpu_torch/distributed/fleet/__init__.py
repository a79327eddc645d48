"""paddle.distributed.fleet in collective mode, for one process on one
device (port of paddle_tpu's `distributed/fleet/__init__.py`, without the
parameter server).

`fleet.init(is_collective=True, strategy=...)` bootstraps the one process
(`env.init_distributed`: more raise, ROADMAP queue 1 item 7), remembers
the strategy and the role maker, and builds the strategy's one-device
mesh; a strategy that needs more devices raises there. The role makers
read paddle's launcher variables (`PADDLE_TRAINER_ID`,
`PADDLE_TRAINERS_NUM`). `distributed_optimizer(opt)` wraps the optimizer
and records it for the step-level `Fleet` methods (`minimize`, `step`,
`clear_grad`, `set_lr`, `get_lr`, `state_dict`, `set_state_dict`);
`distributed_model(layer)` tags the layer with the strategy and returns
it. Either goes into `hapi.Model.prepare(strategy=)` or
`compile_train_step` as the plain object would. `util.all_reduce` and
`util.all_gather` return their input at one rank.

Still raising: the parameter server (`init_server`, `run_server`,
`stop_server`, `ps_client`, `stop_worker`, the `MultiSlot*DataGenerator`
readers; ROADMAP queue 1 item 7) and the static-graph savers
(`save_inference_model`, `save_persistables`; item 8)."""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from .. import env as env_mod
from .. import mesh as mesh_mod
from ..env import MULTI_DEVICE
from ..parallel import barrier as _barrier
from .compiler import CompiledTrainStep, compile_train_step
from .strategy import DistributedStrategy

__all__ = ["init", "DistributedStrategy", "distributed_optimizer",
           "distributed_model", "compile_train_step", "CompiledTrainStep",
           "worker_num", "worker_index", "is_first_worker", "barrier_worker",
           "get_strategy", "get_mesh", "UserDefinedRoleMaker",
           "PaddleCloudRoleMaker", "is_server", "is_worker", "init_server",
           "run_server", "server_endpoints", "ps_client", "stop_worker",
           "stop_server", "Fleet", "UtilBase", "Role", "fleet", "util",
           "MultiSlotDataGenerator", "MultiSlotStringDataGenerator",
           "utils"]

_STATIC = "ROADMAP queue 1 item 8"

_state = {"strategy": None, "initialized": False, "role_maker": None,
          "optimizer": None}


class Role:
    """Process roles (paddle's fleet/base/role_maker.py)."""
    WORKER = 1
    SERVER = 2
    HETER_WORKER = 3
    ALL = 4


class PaddleCloudRoleMaker:
    """Reads paddle's launcher variables."""

    def __init__(self, is_collective=True, **kwargs):
        self.is_collective = is_collective

    def worker_num(self):
        return env_mod.get_world_size()

    def worker_index(self):
        return env_mod.get_rank()


class UserDefinedRoleMaker(PaddleCloudRoleMaker):
    def __init__(self, current_id=0, workers_num=1, role=None, **kw):
        super().__init__(True)
        self._id = current_id
        self._n = workers_num

    def worker_num(self):
        return self._n

    def worker_index(self):
        return self._id


def init(role_maker=None, is_collective=True, strategy=None):
    """Bootstrap the one process, build the strategy's one-device mesh,
    remember both. A role maker or a strategy that asks for more than
    one worker or device raises `NotImplementedError`."""
    if strategy is None:
        strategy = DistributedStrategy()
    env_mod.init_distributed()
    role_maker = role_maker or PaddleCloudRoleMaker(is_collective)
    if role_maker.worker_num() > 1:
        raise NotImplementedError(
            f"fleet.init: {role_maker.worker_num()} workers; "
            f"paddle_tpu_torch runs one ({MULTI_DEVICE})")
    strategy.build_mesh()
    _state.update(strategy=strategy, role_maker=role_maker,
                  initialized=True)


def get_strategy() -> Optional[DistributedStrategy]:
    return _state["strategy"]


def get_mesh():
    return mesh_mod.get_mesh()


def worker_num():
    rm = _state["role_maker"]
    return rm.worker_num() if rm else env_mod.get_world_size()


def worker_index():
    rm = _state["role_maker"]
    return rm.worker_index() if rm else env_mod.get_rank()


def is_first_worker():
    return worker_index() == 0


def barrier_worker():
    _barrier()


class _DistributedOptimizer:
    """The optimizer, marked for the strategy: every attribute is the
    inner optimizer's, and `minimize(loss)` runs backward and its step."""

    def __init__(self, optimizer, strategy):
        self._inner = optimizer
        self.user_defined_strategy = strategy

    def __getattr__(self, name):
        return getattr(self.__dict__["_inner"], name)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        loss.backward()
        self._inner.step()
        return [], []


def distributed_optimizer(optimizer, strategy=None):
    strategy = strategy or _state["strategy"] or DistributedStrategy()
    _state["strategy"] = strategy
    wrapped = _DistributedOptimizer(optimizer, strategy)
    _state["optimizer"] = wrapped
    return wrapped


def distributed_model(model):
    """The layer, tagged with the active strategy (`_fleet_strategy`):
    at one rank there is nothing to wrap."""
    model._fleet_strategy = _state["strategy"]
    return model


# -- the parameter server: not ported ---------------------------------------

def _ps(name):
    raise NotImplementedError(
        f"fleet.{name}: the parameter server is not ported to "
        f"paddle_tpu_torch ({MULTI_DEVICE})")


def is_server() -> bool:
    return os.environ.get("TRAINING_ROLE", "").upper() == "PSERVER"


def is_worker() -> bool:
    return not is_server()


def server_endpoints():
    eps = os.environ.get("PADDLE_PSERVERS_IP_PORT_LIST", "")
    return [e for e in eps.replace(",", ";").split(";") if e]


def init_server(*args, **kwargs):
    _ps("init_server")


def run_server():
    _ps("run_server")


def ps_client():
    _ps("ps_client")


def stop_worker():
    _ps("stop_worker")


def stop_server():
    _ps("stop_server")


class MultiSlotDataGenerator:
    """The parameter server's slot reader: not ported."""

    def __init__(self, *args, **kwargs):
        _ps(type(self).__name__)


class MultiSlotStringDataGenerator(MultiSlotDataGenerator):
    pass


from . import utils            # noqa: E402,F401


class UtilBase:
    """Worker utilities at one rank: a reduce or a gather over one worker
    is its input."""

    _MODES = ("sum", "max", "min")

    def all_reduce(self, input, mode="sum"):
        if mode not in self._MODES:
            raise ValueError(f"all_reduce mode must be one of "
                             f"{sorted(self._MODES)}, got {mode!r}")
        return np.array(input)

    def all_gather(self, input):
        return np.array(input)

    def barrier(self, comm_world="worker"):
        barrier_worker()

    def get_file_shard(self, files):
        """Split `files` across workers, contiguous blocks with the
        remainder spread over the first ranks."""
        if not isinstance(files, list):
            raise TypeError("files should be a list of file names")
        n, idx = worker_num(), worker_index()
        base, extra = divmod(len(files), n)
        start = idx * base + min(idx, extra)
        return files[start:start + base + (1 if idx < extra else 0)]

    def print_on_rank(self, message, rank_id=0):
        if worker_index() == rank_id:
            print(message)


class Fleet:
    """The facade class: every method delegates to the module-level
    implementation, and `fleet` below is the singleton whose bound
    methods the module names mirror."""

    def __init__(self):
        self._util = UtilBase()

    # lifecycle / topology
    def init(self, role_maker=None, is_collective=True, strategy=None):
        return init(role_maker, is_collective, strategy)

    def is_first_worker(self):
        return is_first_worker()

    def worker_num(self):
        return worker_num()

    def worker_index(self):
        return worker_index()

    def is_worker(self):
        return is_worker()

    def worker_endpoints(self, to_string=False):
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        lst = [e for e in eps.replace(";", ",").split(",") if e]
        return ",".join(lst) if to_string else lst

    def server_num(self):
        return len(server_endpoints())

    def server_index(self):
        return int(os.environ.get("PADDLE_PSERVER_ID", "0"))

    def server_endpoints(self, to_string=False):
        eps = server_endpoints()
        return ",".join(eps) if to_string else eps

    def is_server(self):
        return is_server()

    @property
    def util(self):
        return self._util

    def barrier_worker(self):
        return barrier_worker()

    # parameter-server lifecycle
    def init_worker(self):
        return None

    def init_server(self, *args, **kwargs):
        return init_server(*args, **kwargs)

    def run_server(self):
        return run_server()

    def stop_worker(self):
        return stop_worker()

    # training surface
    def distributed_optimizer(self, optimizer, strategy=None):
        return distributed_optimizer(optimizer, strategy)

    def distributed_model(self, model):
        return distributed_model(model)

    def _opt(self):
        opt = _state.get("optimizer")
        if opt is None:
            raise RuntimeError(
                "no fleet optimizer yet: call fleet.distributed_optimizer "
                "first")
        return opt

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        """Backward, then the fleet optimizer's step."""
        loss.backward()
        self._opt()._inner.step()
        return [], []

    def step(self):
        return self._opt().step()

    def clear_grad(self):
        return self._opt().clear_grad()

    def set_lr(self, value):
        return self._opt().set_lr(value)

    def get_lr(self):
        return self._opt().get_lr()

    def state_dict(self):
        opt = _state.get("optimizer")
        if opt is not None:
            return opt.state_dict()
        st = _state["strategy"]
        return dict(st.__dict__) if st is not None else {}

    def set_state_dict(self, state):
        opt = _state.get("optimizer")
        if opt is not None:
            return opt.set_state_dict(state)

    def shrink(self, threshold=None):
        """A parameter-server table shrink: no table, nothing to do."""

    def save_inference_model(self, *args, **kwargs):
        raise NotImplementedError(
            f"fleet.save_inference_model: the inference export is not "
            f"ported to paddle_tpu_torch ({_STATIC})")

    def save_persistables(self, *args, **kwargs):
        raise NotImplementedError(
            f"fleet.save_persistables: static programs are not ported to "
            f"paddle_tpu_torch ({_STATIC})")


fleet = Fleet()
util = fleet.util

init_worker = fleet.init_worker
worker_endpoints = fleet.worker_endpoints
server_num = fleet.server_num
server_index = fleet.server_index
minimize = fleet.minimize
save_inference_model = fleet.save_inference_model
save_persistables = fleet.save_persistables
state_dict = fleet.state_dict
set_state_dict = fleet.set_state_dict
step = fleet.step
clear_grad = fleet.clear_grad
set_lr = fleet.set_lr
get_lr = fleet.get_lr
shrink = fleet.shrink
