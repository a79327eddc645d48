"""The port's fleet and `paddle.distributed` front door for one process,
against the JAX package's on the CPU: `fleet.init(is_collective=True)`,
the role makers on paddle's launcher variables, `distributed_optimizer`
+ `distributed_model` + an eager `minimize` loop, the step-level `Fleet`
methods, `util`, `init_parallel_env` + `DataParallel`, `ParallelEnv`,
what raises for more than one process, and the parameter-server and
static-graph calls that are not ported. The names of both namespaces are
in tests/test_torch_namespace.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402

import paddle_tpu as paddle                                   # noqa: E402
import paddle_tpu.distributed as jdist                        # noqa: E402
import paddle_tpu.distributed.fleet as jfleet                 # noqa: E402
import paddle_tpu.nn as jnn                                   # noqa: E402
import paddle_tpu.optimizer as jopt                           # noqa: E402
from paddle_tpu.distributed import mesh as jmesh              # noqa: E402

import paddle_tpu_torch as ptt                                # noqa: E402
import paddle_tpu_torch.distributed as tdist                  # noqa: E402
import paddle_tpu_torch.distributed.fleet as tfleet           # noqa: E402
import paddle_tpu_torch.nn as tnn                             # noqa: E402
import paddle_tpu_torch.optimizer as topt                     # noqa: E402
from paddle_tpu_torch.core import device as tdevice           # noqa: E402
from paddle_tpu_torch.distributed import mesh as tmesh        # noqa: E402
from paddle_tpu_torch.hapi import Model as TModel             # noqa: E402
from paddle_tpu_torch.models import GPT                       # noqa: E402
from paddle_tpu_torch.models.gpt import gpt_tiny              # noqa: E402

LAUNCHER = ("PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM", "PADDLE_LOCAL_RANK",
            "PADDLE_TRAINER_ENDPOINTS", "PADDLE_CURRENT_ENDPOINT",
            "TRAINING_ROLE", "PADDLE_PSERVERS_IP_PORT_LIST")
# fp32 through two frameworks: summation order only
TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_process(monkeypatch):
    """The CPU as the port's device, no launcher variables, and both
    packages' fleet state and current mesh restored after each test."""
    monkeypatch.setattr(tdevice, "_DEFAULT", [torch.device("cpu")])
    for k in LAUNCHER:
        monkeypatch.delenv(k, raising=False)
    saved = (dict(tfleet._state), dict(jfleet._state), tmesh.get_mesh())
    yield
    tfleet._state.clear()
    tfleet._state.update(saved[0])
    jfleet._state.clear()
    jfleet._state.update(saved[1])
    tmesh.set_mesh(saved[2])


def _one_device_jax_mesh():
    """The JAX package's mesh on one of the tests' 8 virtual devices."""
    jmesh.set_mesh(jmesh.build_mesh(devices=jax.devices()[:1]))


def _mlp_weights(seed=0):
    rng = np.random.default_rng(seed)
    return {"0.weight": rng.standard_normal((8, 16)).astype(np.float32) / 3,
            "0.bias": rng.standard_normal(16).astype(np.float32) / 3,
            "2.weight": rng.standard_normal((16, 4)).astype(np.float32) / 4,
            "2.bias": np.zeros(4, np.float32)}


def _mlp(nn, weights, load):
    net = nn.Sequential(nn.Linear(8, 16), nn.ReLU(), nn.Linear(16, 4))
    load(net, weights)
    return net


def _tmlp(weights):
    return _mlp(tnn, weights, lambda n, w: n.set_state_dict(
        {k: torch.as_tensor(v) for k, v in w.items()}))


def _jmlp(weights):
    return _mlp(jnn, weights, lambda n, w: n.set_state_dict(
        {k: paddle.to_tensor(v) for k, v in w.items()}))


def _data(seed=1, n=4):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((6, 8)).astype(np.float32),
             rng.standard_normal((6, 4)).astype(np.float32))
            for _ in range(n)]


# ------------------------------------------------------------ topology

def test_fleet_init_is_one_worker_as_in_jax():
    """`fleet.init(is_collective=True)` in both packages: one worker of
    index 0, the first; the strategy remembered; the port's current mesh
    is its strategy's one-device mesh, every axis 1."""
    s_t, s_j = tfleet.DistributedStrategy(), jfleet.DistributedStrategy()
    tfleet.init(is_collective=True, strategy=s_t)
    jfleet.init(is_collective=True, strategy=s_j)
    for f in (tfleet, jfleet):
        assert f.worker_num() == 1 and f.worker_index() == 0
        assert f.is_first_worker() and f.fleet.is_first_worker()
        assert f.fleet.worker_num() == 1 and f.fleet.worker_index() == 0
        assert f.fleet.is_worker() and not f.fleet.is_server()
        assert f.fleet.worker_endpoints() == []
        assert f.fleet.server_num() == 0
    assert tfleet.get_strategy() is s_t and jfleet.get_strategy() is s_j
    m = tfleet.get_mesh()
    assert m is tdist.get_mesh() and m.device == torch.device("cpu")
    assert dict(m.shape) == {"pp": 1, "dp": 1, "ep": 1, "sp": 1, "tp": 1}
    tfleet.barrier_worker()
    tfleet.util.barrier()
    assert tfleet.Role.WORKER == jfleet.Role.WORKER == 1
    assert tfleet.Role.SERVER == jfleet.Role.SERVER == 2


@pytest.mark.parametrize("rank,n", [(0, 1), (3, 4)])
def test_role_makers_read_the_launcher_variables(monkeypatch, rank, n):
    """PaddleCloudRoleMaker reads PADDLE_TRAINER_ID / PADDLE_TRAINERS_NUM
    and UserDefinedRoleMaker its arguments, in both packages alike, as do
    get_rank, get_world_size and both ParallelEnv classes."""
    monkeypatch.setenv("PADDLE_TRAINER_ID", str(rank))
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", str(n))
    monkeypatch.setenv("PADDLE_LOCAL_RANK", str(rank))
    monkeypatch.setenv("PADDLE_TRAINER_ENDPOINTS", "a:1,b:2")
    monkeypatch.setenv("PADDLE_CURRENT_ENDPOINT", "b:2")
    for f, d in ((tfleet, tdist), (jfleet, jdist)):
        rm = f.PaddleCloudRoleMaker(is_collective=True)
        assert (rm.worker_num(), rm.worker_index()) == (n, rank)
        um = f.UserDefinedRoleMaker(current_id=2, workers_num=5)
        assert (um.worker_num(), um.worker_index()) == (5, 2)
        assert (d.get_rank(), d.get_world_size()) == (rank, n)
        pe = d.ParallelEnv()
        assert (pe.rank, pe.world_size, pe.nranks, pe.local_rank,
                pe.device_id) == (rank, n, n, rank, 0)
        ee = d.env.ParallelEnv()
        assert (ee.rank, ee.world_size, ee.local_rank, ee.dev_id,
                ee.trainer_endpoints, ee.current_endpoint) == \
            (rank, n, rank, rank, ["a:1", "b:2"], "b:2")


def test_more_than_one_process_raises(monkeypatch):
    """A world size above 1, from the launcher or a role maker or an
    argument, raises naming ROADMAP queue 1 item 7: nothing runs as one
    process while the environment says there are more."""
    calls = [lambda: tfleet.init(is_collective=True),
             lambda: tdist.init_parallel_env(),
             lambda: tdist.init(),
             lambda: tdist.init_distributed()]
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
    for call in calls:
        with pytest.raises(NotImplementedError, match="queue 1 item 7"):
            call()
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "1")
    for call in (lambda: tdist.init_distributed(num_processes=4),
                 lambda: tfleet.init(tfleet.UserDefinedRoleMaker(0, 2)),
                 lambda: tdist.DataParallel(tnn.Linear(2, 2), group=object()),
                 lambda: tdist.barrier(group=object())):
        with pytest.raises(NotImplementedError, match="queue 1 item 7"):
            call()
    s = tfleet.DistributedStrategy()
    s.hybrid_configs.dp_degree = 2
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        tfleet.init(is_collective=True, strategy=s)


def test_ps_and_static_calls_raise_naming_their_items():
    """The parameter server (item 7) and the static-graph savers (item
    8) are not ported and raise."""
    tfleet.init(is_collective=True)
    for call in (tfleet.init_server, tfleet.run_server, tfleet.ps_client,
                 tfleet.stop_worker, tfleet.stop_server,
                 tfleet.fleet.init_server, tfleet.fleet.run_server,
                 tfleet.fleet.stop_worker, tfleet.MultiSlotDataGenerator,
                 tfleet.MultiSlotStringDataGenerator):
        with pytest.raises(NotImplementedError, match="queue 1 item 7"):
            call()
    for call in (tfleet.save_inference_model, tfleet.save_persistables):
        with pytest.raises(NotImplementedError, match="queue 1 item 8"):
            call(None, "/nonexistent")
    assert tfleet.fleet.init_worker() is None
    assert tfleet.shrink() is None


# ------------------------------------------------------- the eager loop

def _eager(fleet_api, make, nn, opt, weights, data, to):
    """Four eager steps. With `fleet_api`: fleet.init, then
    distributed_model and distributed_optimizer and `minimize` (and
    fleet.clear_grad); without: the plain loop. Returns the losses and the
    weights."""
    net = make(weights)
    sgd = opt.Momentum(learning_rate=0.1, momentum=0.9,
                       parameters=net.parameters())
    if fleet_api is not None:
        fleet_api.init(is_collective=True)
        net = fleet_api.distributed_model(net)
        sgd = fleet_api.distributed_optimizer(sgd)
    losses = []
    for x, y in data:
        loss = ((net(to(x)) - to(y)) ** 2).mean()
        if fleet_api is not None:
            sgd.minimize(loss)
            fleet_api.clear_grad()
        else:
            loss.backward()
            sgd.step()
            sgd.clear_grad()
        losses.append(float(loss.item()))
    return losses, {k: np.asarray(v.numpy()) for k, v in
                    net.state_dict().items()}


def test_distributed_optimizer_and_model_loop_equals_the_plain_loop():
    """fleet.init -> distributed_model -> distributed_optimizer ->
    minimize in the port equals its plain eager loop bit for bit, and the
    JAX package's fleet loop within fp32 summation order."""
    w, data = _mlp_weights(), _data()
    tt = lambda a: torch.as_tensor(a)                       # noqa: E731
    plain = _eager(None, _tmlp, tnn, topt, w, data, tt)
    fl = _eager(tfleet, _tmlp, tnn, topt, w, data, tt)
    assert plain[0] == fl[0]
    for k in plain[1]:
        np.testing.assert_array_equal(fl[1][k], plain[1][k])
    assert isinstance(tfleet._state["optimizer"],
                      tfleet._DistributedOptimizer)
    assert tfleet._state["optimizer"].user_defined_strategy is \
        tfleet.get_strategy()
    _one_device_jax_mesh()
    jl, jw = _eager(jfleet, _jmlp, jnn, jopt, w, data, paddle.to_tensor)
    np.testing.assert_allclose(fl[0], jl, atol=TOL, rtol=0)
    for k in jw:
        np.testing.assert_allclose(fl[1][k], jw[k], atol=TOL, rtol=0)


def test_fleet_step_methods_act_on_the_wrapped_optimizer():
    """fleet.step / clear_grad / set_lr / get_lr / state_dict /
    set_state_dict and fleet.minimize, in both packages alike; without a
    fleet optimizer they raise."""
    with pytest.raises(RuntimeError):
        tfleet.fleet.step()
    w, data = _mlp_weights(), _data(n=2)
    out = {}
    for f, make, nn, opt, to in (
            (tfleet, _tmlp, tnn, topt, torch.as_tensor),
            (jfleet, _jmlp, jnn, jopt, paddle.to_tensor)):
        f.init(is_collective=True)
        if f is jfleet:
            _one_device_jax_mesh()
        net = f.distributed_model(make(w))
        o = f.distributed_optimizer(opt.Adam(learning_rate=0.01,
                                             parameters=net.parameters()))
        x, y = data[0]
        f.minimize(((net(to(x)) - to(y)) ** 2).mean())
        f.clear_grad()
        f.set_lr(0.001)
        lr = f.get_lr()
        x, y = data[1]
        ((net(to(x)) - to(y)) ** 2).mean().backward()
        f.step()
        f.clear_grad()
        sd = f.state_dict()
        f.set_state_dict(sd)
        out[f] = (lr, o.get_lr(), sorted(sd), {k: np.asarray(v.numpy())
                                              for k, v in
                                              net.state_dict().items()})
    t, j = out[tfleet], out[jfleet]
    assert t[0] == j[0] == t[1] == j[1] == 0.001
    assert len(t[2]) == len(j[2])
    for k in j[3]:
        np.testing.assert_allclose(t[3][k], j[3][k], atol=TOL, rtol=0)


def test_util_at_one_rank_returns_its_input():
    """fleet.util's all_reduce (sum, max, min) and all_gather at one rank
    give back their input, as the JAX package's do on a one-device mesh;
    an unknown mode raises in both; the file shard of one worker is every
    file."""
    tfleet.init(is_collective=True)
    jfleet.init(is_collective=True)
    _one_device_jax_mesh()
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    for mode in ("sum", "max", "min"):
        got = tfleet.util.all_reduce(x, mode=mode)
        np.testing.assert_array_equal(got, x)
        np.testing.assert_array_equal(
            got, np.asarray(jfleet.util.all_reduce(x, mode=mode)))
    np.testing.assert_array_equal(tfleet.util.all_gather(x), x)
    np.testing.assert_array_equal(
        np.asarray(jfleet.util.all_gather(x)).reshape(x.shape), x)
    for u in (tfleet.util, jfleet.util):
        with pytest.raises(ValueError):
            u.all_reduce(x, mode="avg")
        assert u.get_file_shard(["a", "b", "c"]) == ["a", "b", "c"]


# --------------------------------------------- init_parallel_env, DataParallel

def test_init_parallel_env_and_data_parallel_are_the_layer():
    """init_parallel_env sets the one-device dp mesh; DataParallel's
    forward, backward, apply_collective_grads, parameters and state_dict
    are the bare layer's, and its state_dict round-trips through
    set_state_dict."""
    tmesh.set_mesh(None)
    env = tdist.init_parallel_env()
    assert (env.rank, env.world_size) == (0, 1)
    m = tdist.get_mesh()
    assert m.axis_names == ("dp",) and m.device == torch.device("cpu")
    assert tdist.init_parallel_env() is not None and tdist.get_mesh() is m
    w = _mlp_weights()
    bare, dp = _tmlp(w), tdist.DataParallel(_tmlp(w))
    x, y = (torch.as_tensor(a) for a in _data()[0])
    outs = []
    for net in (bare, dp):
        out = net(x)
        ((out - y) ** 2).mean().backward()
        outs.append(out)
    dp.apply_collective_grads()
    assert torch.equal(outs[0], outs[1])
    assert torch.equal(dp.forward(x), bare(x))
    for (n, a), (m_, b) in zip(bare.named_parameters(),
                               dp.named_parameters()):
        assert n == m_ and torch.equal(a.grad, b.grad)
    sd = dp.state_dict()
    assert sorted(sd) == sorted(bare.state_dict())
    other = tdist.DataParallel(_tmlp(_mlp_weights(seed=5)))
    other.set_state_dict(sd)
    for k, v in other.state_dict().items():
        assert torch.equal(v, sd[k]), k
    assert ptt.DataParallel is tdist.DataParallel
    assert tdist.ParallelEnv().nranks == 1


def test_fleet_wrapped_model_and_optimizer_train_through_model_prepare():
    """A `fleet.distributed_model` layer with a
    `fleet.distributed_optimizer` optimizer, and a `DataParallel` layer,
    go into `Model.prepare(strategy=)` with gradient merge: two
    `train_batch` steps equal those of the plain layer and optimizer."""
    from paddle_tpu.models import GPT as JGPT
    from paddle_tpu.models.gpt import gpt_tiny as jgpt_tiny
    paddle.seed(0)
    arrays = {k: np.asarray(v._data) for k, v in
              JGPT(jgpt_tiny()).state_dict().items()}
    ids = np.random.default_rng(0).integers(0, 512, (4, 32)).astype(np.int64)

    class Loss(tnn.Layer):
        def __init__(self, m):
            super().__init__()
            self.m = m

        def forward(self, ids, labels):
            return self.m.loss(ids, labels)

    def run(wrap):
        s = tfleet.DistributedStrategy()
        s.gradient_merge = True
        s.gradient_merge_configs.k_steps = 2
        net = Loss(GPT(gpt_tiny()).load_numpy(arrays))
        opt = topt.Adam(learning_rate=1e-3, parameters=net.parameters())
        if wrap == "fleet":
            tfleet.init(is_collective=True, strategy=s)
            net = tfleet.distributed_model(net)
            opt = tfleet.distributed_optimizer(opt)
        elif wrap == "data_parallel":
            tdist.init_parallel_env()
            net = tdist.DataParallel(net)
        model = TModel(net)
        model.prepare(opt, strategy=s)
        losses = [model.train_batch([ids, ids])[0] for _ in range(2)]
        return losses, {k: v.detach().clone() for k, v in
                        net.state_dict().items()}
    pl, pw = run(None)
    for wrap in ("fleet", "data_parallel"):
        wl, ww = run(wrap)
        assert wl == pl, wrap
        for k in pw:
            assert torch.equal(pw[k], ww[k]), (wrap, k)
