"""The port's io pipeline against the JAX package's, in one process:
samplers, datasets, the DataLoader with num_workers=0 (batches, dtypes,
tree shapes, `Tensor`s on the asked device), `device_prefetch` on the
CPU, and `Model.fit` with and without `prefetch_device` against each
other and against the JAX package's fit. The worker processes are in
tests/test_torch_io_workers.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                                       # noqa: E402

import paddle_tpu.io as jio                                   # noqa: E402
import paddle_tpu.nn as jnn                                   # noqa: E402
import paddle_tpu.optimizer as jopt                           # noqa: E402
from paddle_tpu.core.tensor import Tensor as JTensor          # noqa: E402
from paddle_tpu.hapi import Model as JModel                   # noqa: E402

import paddle_tpu_torch as ptt                                # noqa: E402
import paddle_tpu_torch.io as tio                             # noqa: E402
import paddle_tpu_torch.nn as tnn                             # noqa: E402
import paddle_tpu_torch.optimizer as topt                     # noqa: E402
from paddle_tpu_torch.core import device as tdevice           # noqa: E402
from paddle_tpu_torch.hapi import Model as TModel             # noqa: E402

from torch_io_cases import Arrays                             # noqa: E402


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(tdevice, "_DEFAULT", [torch.device("cpu")])


def _host(x):
    """A leaf of either package's batch as numpy (trees recursed)."""
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_host(v) for v in x)
    if isinstance(x, torch.Tensor):
        return torch.Tensor.detach(x).numpy()
    if isinstance(x, JTensor):
        return np.asarray(x._data)
    return x


def _same_tree(got, want, what=""):
    assert type(got) is type(want), (what, type(got), type(want))
    if isinstance(want, dict):
        assert list(got) == list(want), what
        for k in want:
            _same_tree(got[k], want[k], f"{what}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _same_tree(g, w, f"{what}[{i}]")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        assert got == want, what


def _tensors_on_cpu(tree):
    leaves = []

    def visit(x):
        if isinstance(x, dict):
            for v in x.values():
                visit(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                visit(v)
        else:
            leaves.append(x)
    visit(tree)
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor):
            assert isinstance(leaf, ptt.Tensor) and leaf.device.type == "cpu"
    return leaves


# ---------------------------------------------------------------- samplers

def _sampler_pairs():
    data = list(range(23))
    return {
        "sequence": lambda m: m.SequenceSampler(data),
        "random": lambda m: m.RandomSampler(data),
        "random_replacement": lambda m: m.RandomSampler(
            data, replacement=True, num_samples=30),
        "random_num_samples": lambda m: m.RandomSampler(data,
                                                        num_samples=9),
        "subset_random": lambda m: m.SubsetRandomSampler([3, 5, 8, 13, 21]),
        "weighted": lambda m: m.WeightedRandomSampler(
            [0.1, 0.5, 0.2, 0.2, 1.0], 12),
        "weighted_no_replacement": lambda m: m.WeightedRandomSampler(
            [0.1, 0.5, 0.2, 0.2, 1.0], 4, replacement=False),
        "batch_shuffle": lambda m: m.BatchSampler(
            dataset=data, shuffle=True, batch_size=5),
        "batch_drop_last": lambda m: m.BatchSampler(
            sampler=m.SequenceSampler(data), batch_size=5, drop_last=True),
    }


@pytest.mark.parametrize("name", sorted(_sampler_pairs()))
def test_sampler_indices_match_jax(name):
    make = _sampler_pairs()[name]
    js, ts = make(jio), make(tio)
    for epoch in range(2):
        np.random.seed(7 + epoch)
        want = list(js)
        np.random.seed(7 + epoch)
        got = list(ts)
        assert got == want
        assert len(ts) == len(js)


@pytest.mark.parametrize("nranks", [2, 3])
@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("drop_last", [False, True])
def test_distributed_batch_sampler_matches_jax(nranks, shuffle, drop_last):
    """23 samples over 2-3 ranks: padded to a multiple of the ranks,
    strided shares, the same epochs (set_epoch) as the JAX sampler."""
    data = list(range(23))
    seen = []
    for rank in range(nranks):
        js = jio.DistributedBatchSampler(data, 4, num_replicas=nranks,
                                         rank=rank, shuffle=shuffle,
                                         drop_last=drop_last)
        ts = tio.DistributedBatchSampler(data, 4, num_replicas=nranks,
                                         rank=rank, shuffle=shuffle,
                                         drop_last=drop_last)
        for epoch in (0, 3):
            js.set_epoch(epoch)
            ts.set_epoch(epoch)
            got = list(ts)
            assert got == list(js)
            assert len(ts) == len(js) == len(got)
            if epoch == 0:
                seen += [i for b in got for i in b]
    if not drop_last:
        assert set(seen) == set(data)     # padding covers every sample


def test_distributed_batch_sampler_reads_the_trainer_env(monkeypatch):
    monkeypatch.setenv("PADDLE_TRAINER_ID", "1")
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "3")
    ts = tio.DistributedBatchSampler(list(range(10)), 2)
    assert (ts.local_rank, ts.nranks) == (1, 3)
    assert list(ts) == [[1, 4], [7, 0]]
    monkeypatch.delenv("PADDLE_TRAINER_ID")
    monkeypatch.delenv("PADDLE_TRAINERS_NUM")
    ts = tio.DistributedBatchSampler(list(range(10)), 2)
    assert (ts.local_rank, ts.nranks) == (0, 1)


# ---------------------------------------------------------------- datasets

class _Range:
    def __init__(self, n, off=0):
        self.n, self.off = n, off

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i >= self.n:
            raise IndexError(i)
        return np.float32(i + self.off), np.int64(i)


class _JStream(jio.IterableDataset):
    def __init__(self, n):
        self.n = n

    def __iter__(self):
        for i in range(self.n):
            yield np.full((2,), i, np.float32), i


class _TStream(tio.IterableDataset):
    def __init__(self, n):
        self.n = n

    def __iter__(self):
        for i in range(self.n):
            yield np.full((2,), i, np.float32), i


def _dataset_pairs():
    return {
        "tensor": lambda m: m.TensorDataset(
            [np.arange(12.0).reshape(6, 2), np.arange(6)]),
        "compose": lambda m: m.ComposeDataset([_Range(5), _Range(5, 10)]),
        "concat": lambda m: m.ConcatDataset([_Range(3), _Range(4, 100),
                                             _Range(2, 50)]),
        "subset": lambda m: m.Subset(_Range(10), [9, 2, 4]),
    }


@pytest.mark.parametrize("name", sorted(_dataset_pairs()))
def test_dataset_items_match_jax(name):
    jd, td = _dataset_pairs()[name](jio), _dataset_pairs()[name](tio)
    assert len(td) == len(jd)
    for i in range(len(jd)):
        _same_tree(_host(td[i]), _host(jd[i]), f"{name}[{i}]")
    if name == "concat":
        _same_tree(_host(td[-1]), _host(jd[-1]))


def test_chain_and_iterable_dataset_match_jax():
    jc = jio.ChainDataset([_JStream(3), _JStream(2)])
    tc = tio.ChainDataset([_TStream(3), _TStream(2)])
    got, want = [s for s in tc], [s for s in jc]
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        _same_tree(_host(g), _host(w))
    for ds in (_TStream(2), tc):
        with pytest.raises(RuntimeError):
            ds[0]
        with pytest.raises(RuntimeError):
            len(ds)


def test_random_split_matches_jax():
    np.random.seed(11)
    js = jio.random_split(_Range(10), [3, 7])
    np.random.seed(11)
    ts = tio.random_split(_Range(10), [3, 7])
    assert [s.indices for s in ts] == [s.indices for s in js]
    with pytest.raises(ValueError):
        tio.random_split(_Range(10), [3, 6])


# ------------------------------------------------------ loader, 0 workers

def _loader_pairs():
    ds = Arrays(21)
    return {
        "dict_tuple_shuffle": lambda m: m.DataLoader(
            ds, batch_size=4, shuffle=True),
        "drop_last": lambda m: m.DataLoader(ds, batch_size=4,
                                            drop_last=True),
        "batch_size_none": lambda m: m.DataLoader(
            m.TensorDataset([np.arange(15.0).reshape(5, 3),
                             np.arange(5)]), batch_size=None),
        "batch_sampler": lambda m: m.DataLoader(
            ds, batch_sampler=m.BatchSampler(
                sampler=m.SubsetRandomSampler(range(0, 21, 2)),
                batch_size=3)),
        "tensor_dataset": lambda m: m.DataLoader(
            m.TensorDataset([np.arange(24, dtype=np.float32).reshape(8, 3),
                             np.arange(8, dtype=np.int32)]),
            batch_size=3, shuffle=True),
        "collate_fn": lambda m: m.DataLoader(
            ds, batch_size=5, collate_fn=_first_x),
        "iterable_drop_last": lambda m: m.DataLoader(
            (_JStream if m is jio else _TStream)(7), batch_size=3,
            drop_last=True),
        "iterable": lambda m: m.DataLoader(
            (_JStream if m is jio else _TStream)(7), batch_size=3),
    }


def _first_x(batch):
    return np.stack([b["x"][0] for b in batch]), [b["y"] for b in batch]


@pytest.mark.parametrize("name", sorted(_loader_pairs()))
def test_loader_batches_match_jax(name):
    """The same batches as the JAX DataLoader's for one numpy seed: values,
    dtypes and the tree, the port's leaves `Tensor`s on the default
    device (the CPU here); two epochs."""
    make = _loader_pairs()[name]
    jl, tl = make(jio), make(tio)
    for epoch in range(2):
        np.random.seed(5 + epoch)
        want = [_host(b) for b in jl]
        np.random.seed(5 + epoch)
        got_raw = list(tl)
        for b in got_raw:
            _tensors_on_cpu(b)
        got = [_host(b) for b in got_raw]
        assert len(got) == len(want) > 0
        for i, (g, w) in enumerate(zip(got, want)):
            _same_tree(g, w, f"{name} epoch {epoch} batch {i}")
    if not name.startswith("iterable"):
        assert len(tl) == len(jl)


def test_loader_places_and_default_device(monkeypatch):
    dl = tio.DataLoader(Arrays(4), batch_size=2, places=[ptt.CPUPlace()])
    b = next(iter(dl))
    assert b["x"].device.type == "cpu"
    # the default device is cuda: without a GPU iterating raises
    monkeypatch.setattr(tdevice, "_DEFAULT", [None])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            next(iter(tio.DataLoader(Arrays(4), batch_size=2)))


def test_default_collate_fn_matches_jax():
    batches = [
        [np.float32(1.5), np.float32(2.5)],
        [1, 2, 3],
        [(np.ones(2), "a"), (np.zeros(2), "b")],
        [{"k": 1.0, "s": b"x"}, {"k": 2.0, "s": b"y"}],
        [np.arange(3, dtype=np.int16), np.arange(3, dtype=np.int16)],
    ]
    for b in batches:
        _same_tree(tio.default_collate_fn(b), jio.default_collate_fn(b),
                   repr(b))
    t = [torch.arange(3.0), torch.arange(3.0)]
    np.testing.assert_array_equal(tio.default_collate_fn(t),
                                  np.stack([np.arange(3.0)] * 2))


# ------------------------------------------------------- device_prefetch

def test_device_prefetch_keeps_order_and_places():
    dl = tio.DataLoader(Arrays(13), batch_size=4)
    want = [_host(b) for b in dl]
    got = list(tio.device_prefetch(iter(dl), depth=2))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _tensors_on_cpu(g)
        _same_tree(_host(g), w)
    # a plain generator of numpy batches, and place= on every leaf
    seen = []

    def place(x):
        seen.append(tuple(x.shape))
        return x.clone()

    gen = (np.full((2, 2), i, np.float32) for i in range(5))
    out = [_host(b) for b in tio.device_prefetch(gen, place=place)]
    assert [float(o[0, 0]) for o in out] == [0, 1, 2, 3, 4]
    assert seen == [(2, 2)] * 5


def test_device_prefetch_raises_feeder_and_place_errors():
    def gen():
        yield np.zeros(2, np.float32)
        raise ValueError("loader broke")

    it = tio.device_prefetch(gen())
    next(it)
    with pytest.raises(ValueError, match="loader broke"):
        next(it)

    def bad_place(x):
        raise TypeError("cannot place")

    with pytest.raises(TypeError, match="cannot place"):
        list(tio.device_prefetch(iter([np.zeros(2, np.float32)]),
                                 place=bad_place))
    with pytest.raises(NotImplementedError):
        next(tio.device_prefetch(iter([]), sharding=object()))


def test_device_prefetch_early_exit_stops_the_feeder():
    import threading
    pulled = []

    def gen():
        for i in range(1000):
            pulled.append(i)
            yield np.full((1,), i, np.float32)

    before = threading.active_count()
    it = tio.device_prefetch(gen(), depth=2)
    first = [float(next(it)[0]) for _ in range(3)]
    it.close()
    assert first == [0.0, 1.0, 2.0]
    assert len(pulled) <= 3 + 2 + 2       # depth ahead, not the stream
    assert threading.active_count() <= before


# -------------------------------------------------------------- Model.fit

def _fit_data(n=24, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 6)).astype(np.float32)
    y = rng.standard_normal((n, 3)).astype(np.float32)
    return x, y


def _init(seed=1):
    rng = np.random.default_rng(seed)
    return {"fc.weight": rng.standard_normal((6, 3)).astype(np.float32),
            "fc.bias": rng.standard_normal(3).astype(np.float32)}


class _TNet(tnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc = tnn.Linear(6, 3)

    def forward(self, x):
        return self.fc(x)


class _JNet(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc = jnn.Linear(6, 3)

    def forward(self, x):
        return self.fc(x)


def _mse(out, y):
    return ((out - y) ** 2).mean()


class _Losses:
    def __init__(self, cbks):
        class C(cbks.Callback):
            def __init__(self):
                super().__init__()
                self.losses = []

            def on_train_batch_end(self, step, logs=None):
                self.losses.append(float(logs["loss"]))
        self.cb = C()


def _port_fit(prefetch, loader=False):
    from paddle_tpu_torch.hapi import callbacks as tcbks
    net = _TNet()
    net.set_state_dict(_init())
    m = TModel(net)
    m.prepare(topt.Adam(1e-2, parameters=net.parameters()), loss=_mse)
    x, y = _fit_data()
    data = tio.TensorDataset([x, y])
    if loader:
        data = tio.DataLoader(data, batch_size=5, shuffle=True)
    rec = _Losses(tcbks).cb
    np.random.seed(9)
    m.fit(data, batch_size=5, epochs=3, verbose=0, shuffle=True,
          prefetch_device=prefetch, callbacks=[rec])
    return rec.losses, {n: p.detach().numpy().copy()
                        for n, p in net.named_parameters()}, m


def test_fit_with_and_without_prefetch_bit_equal_and_equal_to_jax():
    """`prefetch_device` moves the copy, not the arithmetic: losses and
    parameters bit-equal, and both within the fit tolerance of the JAX
    package's own fit (sync steps) on the same seed."""
    from paddle_tpu.hapi import callbacks as jcbks
    l_pre, p_pre, m = _port_fit(True)
    l_plain, p_plain, _ = _port_fit(False)
    assert l_pre == l_plain
    for n in p_pre:
        np.testing.assert_array_equal(p_pre[n], p_plain[n])
    assert len(m.batch_wait_s) == 15 and all(w >= 0 for w in m.batch_wait_s)
    l_loader, p_loader, _ = _port_fit(True, loader=True)
    assert l_loader == l_pre

    net = _JNet()
    net.set_state_dict({k: JTensor(jnp.asarray(v))
                        for k, v in _init().items()})
    jm = JModel(net)
    jm.prepare(jopt.Adam(1e-2, parameters=net.parameters()), loss=_mse)
    x, y = _fit_data()
    rec = _Losses(jcbks).cb
    np.random.seed(9)
    jm.fit(jio.TensorDataset([x, y]), batch_size=5, epochs=3, verbose=0,
           shuffle=True, callbacks=[rec])
    np.testing.assert_allclose(l_pre, rec.losses, rtol=1e-5, atol=1e-6)
    jparams = {k: np.asarray(v._data) for k, v in
               jm.network.state_dict().items()}
    for n in p_pre:
        np.testing.assert_allclose(p_pre[n], jparams[n], rtol=1e-5,
                                   atol=1e-6, err_msg=n)


def test_compiled_step_put_batch_places_once():
    """`put_batch` gives a `Tensor` on the step's device, and the step
    takes it without another copy."""
    net = _TNet()
    m = TModel(net)
    m.prepare(topt.SGD(0.1, parameters=net.parameters()), loss=_mse)
    prog = m._prog
    x = prog.put_batch(np.ones((2, 6), np.float32))
    assert isinstance(x, ptt.Tensor) and x.device.type == "cpu"
    assert prog._put_data(x).data_ptr() == x.data_ptr()


def test_jax_workers_leave_python_random_unseeded():
    """The JAX fault the port does not copy (ROADMAP queue 3): a JAX worker
    seeds numpy's generator from the seed but not Python's `random`, so
    two runs from one numpy seed repeat the numpy draws and not the
    `random` ones (every random vision transform draws from `random`).
    The port's workers repeat both (tests/test_torch_io_workers.py)."""
    from torch_io_cases import Draws
    runs = []
    for _ in range(2):
        np.random.seed(21)
        runs.append(np.concatenate([np.asarray(b._data) for b in
                                    jio.DataLoader(Draws(), batch_size=2,
                                                   num_workers=2,
                                                   timeout=120)]))
    np.testing.assert_array_equal(runs[0][:, 0], runs[1][:, 0])
    assert not np.array_equal(runs[0][:, 1], runs[1][:, 1])


class _TXY(tio.IterableDataset):
    """(x, y) pairs of `_fit_data`, streamed."""

    def __iter__(self):
        x, y = _fit_data()
        yield from zip(x, y)


class _JXY(jio.IterableDataset):
    def __iter__(self):
        x, y = _fit_data()
        yield from zip(x, y)


def test_fit_over_an_iterable_dataset_matches_jax():
    """A loader of an IterableDataset has no length: fit runs it to its
    end (progress with no step count) in both packages alike."""
    from paddle_tpu.hapi import callbacks as jcbks
    from paddle_tpu_torch.hapi import callbacks as tcbks
    net = _TNet()
    net.set_state_dict(_init())
    m = TModel(net)
    m.prepare(topt.SGD(0.05, parameters=net.parameters()), loss=_mse)
    rec = _Losses(tcbks).cb
    m.fit(tio.DataLoader(_TXY(), batch_size=5), epochs=2, verbose=2,
          callbacks=[rec])
    jnet = _JNet()
    jnet.set_state_dict({k: JTensor(jnp.asarray(v))
                         for k, v in _init().items()})
    jm = JModel(jnet)
    jm.prepare(jopt.SGD(0.05, parameters=jnet.parameters()), loss=_mse)
    jrec = _Losses(jcbks).cb
    jm.fit(jio.DataLoader(_JXY(), batch_size=5), epochs=2, verbose=0,
           callbacks=[jrec])
    assert len(rec.losses) == len(jrec.losses) == 10
    np.testing.assert_allclose(rec.losses, jrec.losses, rtol=1e-5,
                               atol=1e-6)
