"""The port's DataLoader with worker processes (spawned) against its own
num_workers=0: the same batches in the same order, shared-memory
transport, a worker's error raised with its traceback, a killed worker
reported, persistent workers over two epochs, `get_worker_info`, seeds,
an early `break` leaving no process or segment behind, and `timeout`.

Every test bounds its waits: the loader's `timeout` and a join timeout
on each worker. The datasets are in tests/torch_io_cases.py (numpy
only), which the workers import."""
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu_torch.io as tio                             # noqa: E402
from paddle_tpu_torch.core import device as tdevice           # noqa: E402
from paddle_tpu_torch.io import dataloader as dl_mod          # noqa: E402
from paddle_tpu_torch.vision import datasets as vds           # noqa: E402
from paddle_tpu_torch.vision import transforms as T           # noqa: E402

import torch_io_cases as C                                    # noqa: E402

TIMEOUT = 60          # seconds: the loader's own bound on a batch


# the worker pools the current test's loaders started, with every worker
# each one had (a pool forgets its workers at shutdown)
_POOLS = []


class _RecordedPool(dl_mod._Pool):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.started = []
        _POOLS.append(self)

    def shutdown(self):
        self.started += [w for w in self.workers if w not in self.started]
        super().shutdown()


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(tdevice, "_DEFAULT", [torch.device("cpu")])
    monkeypatch.setattr(dl_mod, "_Pool", _RecordedPool)
    _POOLS.clear()
    yield
    _POOLS.clear()


def _segments():
    """The shared-memory segments of this test's loaders still on disk
    (each pool names its segments under its own `shm_base`)."""
    if not os.path.isdir("/dev/shm"):
        return []
    bases = tuple(p.shm_base for p in _POOLS)
    return sorted(n for n in os.listdir("/dev/shm") if bases and
                  n.startswith(bases))


def _workers_gone(deadline=15.0):
    """Every worker process of this test's loaders has exited (joined
    within `deadline`)."""
    def alive():
        return [w for p in _POOLS for w in p.started + p.workers
                if w.is_alive()]
    t0 = time.monotonic()
    while alive() and time.monotonic() - t0 < deadline:
        time.sleep(0.05)
    return bool(_POOLS) and not alive()


def _flat(batch):
    if isinstance(batch, dict):
        return [x for k in sorted(batch) for x in _flat(batch[k])]
    if isinstance(batch, (list, tuple)):
        return [x for v in batch for x in _flat(v)]
    return [batch]


def _equal(a, b):
    fa, fb = _flat(a), _flat(b)
    assert len(fa) == len(fb)
    for x, y in zip(fa, fb):
        if isinstance(y, torch.Tensor):
            assert isinstance(x, torch.Tensor) and x.dtype == y.dtype
            assert torch.equal(x, y)
        elif isinstance(y, np.ndarray):
            np.testing.assert_array_equal(x, y)
        else:
            assert x == y


def _epoch(loader, seed):
    np.random.seed(seed)
    return list(loader)


def test_workers_give_the_batches_of_no_workers_in_order():
    """Shuffled map-style data, 2 workers, shared memory and pickled
    transport: batch for batch the num_workers=0 loader's, with two
    epochs through persistent workers (one start)."""
    ds = C.Arrays(37)
    want = [_epoch(tio.DataLoader(ds, batch_size=5, shuffle=True), s)
            for s in (1, 2)]
    for shm in (True, False):
        loader = tio.DataLoader(ds, batch_size=5, shuffle=True,
                                num_workers=2, use_shared_memory=shm,
                                persistent_workers=True, timeout=TIMEOUT,
                                prefetch_factor=3)
        got = [_epoch(loader, s) for s in (1, 2)]
        pids = {w.pid for w in loader._persistent_iter._pool.workers}
        assert len(pids) == 2
        for g, w in zip(got, want):
            assert len(g) == len(w) == 8
            for a, b in zip(g, w):
                _equal(a, b)
        # the same two processes served both epochs
        assert {w.pid for w in loader._persistent_iter._pool.workers} == pids
        assert not _segments()
        del loader
        assert _workers_gone()
    assert not _segments()


def test_worker_info_seeds_and_init_fn():
    """get_worker_info inside a worker (None outside); batch k from worker
    k mod 2; numpy and Python's random seeded base + id in each worker,
    the same draws for the same numpy seed."""
    assert tio.get_worker_info() is None
    loader = tio.DataLoader(C.WhoAmI(), batch_size=3, num_workers=2,
                            timeout=TIMEOUT, worker_init_fn=C.worker_init)
    got = [b.numpy() for b in loader]
    assert [int(b[0, 1]) for b in got] == [0, 1, 0, 1]
    assert all((b[:, 2] == 2).all() for b in got)
    assert len({int(b[0, 3]) for b in got}) == 1      # one base seed
    assert all((b[:, 4] == b[:, 1]).all() for b in got)   # init_fn ran
    draws = []
    for _ in range(2):
        np.random.seed(21)
        draws.append(np.concatenate([b.numpy() for b in tio.DataLoader(
            C.Draws(), batch_size=2, num_workers=2, timeout=TIMEOUT)]))
    np.testing.assert_array_equal(draws[0], draws[1])
    # worker 0 and worker 1 draw different streams, in numpy and random
    assert not np.array_equal(draws[0][0], draws[0][2])
    assert _workers_gone()


def test_worker_seeds_change_from_one_epoch_to_the_next():
    """Workers started anew each epoch (not persistent, no shuffle, and
    nothing else drawing from numpy's generator between the epochs) draw
    new numbers in each: the base seed counts the loader's starts."""
    loader = tio.DataLoader(C.Draws(), batch_size=2, num_workers=2,
                            timeout=TIMEOUT)
    epochs = [np.concatenate([b.numpy() for b in loader]) for _ in range(2)]
    assert epochs[0].shape == (8, 2)
    assert not np.any(epochs[0] == epochs[1])     # numpy's and random's
    assert _workers_gone()


def test_persistent_epoch_after_an_early_break():
    """Break out of a persistent loader after one batch while a later
    batch has arrived before an earlier one (item 4, in batch 2, is
    slow, so batch 3 overtakes it); the next epoch takes what the
    abandoned one left in flight and gives the batches of num_workers=0,
    within the loader's timeout."""
    ds = C.Slow(16, slow=4, delay=1.0)
    want = list(tio.DataLoader(ds, batch_size=2))
    loader = tio.DataLoader(ds, batch_size=2, num_workers=2,
                            persistent_workers=True, prefetch_factor=2,
                            timeout=10)
    for _ in loader:
        time.sleep(0.5)          # batches 1 and 3 arrive, 2 is loading
        break
    got = list(loader)
    assert len(got) == len(want) == 8
    for a, b in zip(got, want):
        _equal(a, b)
    del loader
    assert _workers_gone()
    assert not _segments()


def test_fit_left_early_then_fit_again_over_persistent_workers():
    """`Model.fit(num_iters=1)` with prefetch over a persistent 2-worker
    loader returns only after its feeder thread has left the loader's
    iterator, although the feeder is then waiting 6 s for a slow batch;
    the next fit re-arms that iterator, and its steps get the loader's
    batches in order."""
    import threading
    from paddle_tpu_torch import nn as tnn
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.hapi import Model

    class Seen(tnn.Layer):
        def __init__(self):
            super().__init__()
            self.fc, self.xs = tnn.Linear(4, 1), []

        def forward(self, x):
            self.xs.append(torch.Tensor.detach(x).clone())
            return self.fc(x)

    ds = C.SlowPairs(8, slow=4, delay=6.0)
    want = [b[0] for b in tio.DataLoader(C.SlowPairs(8), batch_size=2)]
    net = Seen()
    model = Model(net)
    model.prepare(topt.SGD(0.1, parameters=net.parameters()),
                  loss=lambda out, y: ((out - y) ** 2).mean())
    loader = tio.DataLoader(ds, batch_size=2, num_workers=2,
                            persistent_workers=True, timeout=30)
    model.fit(loader, epochs=1, verbose=0, num_iters=1)
    assert not [t for t in threading.enumerate()
                if t.name == "device_prefetch feeder"]
    assert len(net.xs) == 1
    net.xs.clear()
    model.fit(loader, epochs=1, verbose=0)
    assert len(net.xs) == len(want) == 4
    for a, b in zip(net.xs, want):
        assert torch.equal(a, b)
    del loader
    assert _workers_gone()
    assert not _segments()


def test_random_transforms_in_workers_follow_the_seed(tmp_path):
    """A RandomResizedCrop + flip pipeline over DatasetFolder: the same
    numpy seed gives the same images through 2 workers twice (the JAX
    package seeds only numpy in its workers, so its Python-random
    transforms do not follow the seed; the port seeds both)."""
    rng = np.random.default_rng(0)
    for c in ("a", "b"):
        os.makedirs(tmp_path / c)
        for i in range(4):
            np.save(tmp_path / c / f"{i}.npy",
                    rng.integers(0, 255, (20, 24, 3), dtype=np.uint8))
    tf = T.Compose([T.RandomResizedCrop(12), T.RandomHorizontalFlip(),
                    T.Transpose()])
    ds = vds.DatasetFolder(str(tmp_path), loader=np.load,
                           extensions=(".npy",), transform=tf)
    runs = []
    for _ in range(2):
        np.random.seed(4)
        runs.append([b[0].numpy() for b in tio.DataLoader(
            ds, batch_size=2, num_workers=2, timeout=TIMEOUT)])
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)
    assert runs[0][0].shape == (2, 3, 12, 12)
    assert _workers_gone()


def test_object_leaves_travel_pickled():
    got = list(tio.DataLoader(C.Objects(), batch_size=3, num_workers=2,
                              timeout=TIMEOUT))
    want = list(tio.DataLoader(C.Objects(), batch_size=3))
    for g, w in zip(got, want):
        assert torch.equal(g[0], w[0])
        assert g[1].dtype == object and list(g[1].ravel()) == \
            list(w[1].ravel())
    assert _workers_gone() and not _segments()


def test_worker_error_is_raised_with_its_traceback():
    loader = tio.DataLoader(C.Failing(40, bad=13), batch_size=4,
                            num_workers=2, timeout=TIMEOUT)
    it = iter(loader)
    seen = 0
    with pytest.raises(RuntimeError) as err:
        for _ in it:
            seen += 1
    assert seen == 3                     # batches 0-2 came first, in order
    assert "DataLoader worker failed" in str(err.value)
    assert "ValueError: bad sample 13" in str(err.value)
    assert "torch_io_cases.py" in str(err.value)
    del it
    assert _workers_gone() and not _segments()


def test_killed_worker_is_reported():
    loader = tio.DataLoader(C.Dying(40, bad=13), batch_size=4,
                            num_workers=2, timeout=TIMEOUT)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="died unexpectedly"):
        for _ in loader:
            pass
    assert time.monotonic() - t0 < TIMEOUT
    assert _workers_gone() and not _segments()


def test_timeout_raises():
    loader = tio.DataLoader(C.Slow(16, slow=5, delay=30.0), batch_size=2,
                            num_workers=2, timeout=2)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="timed out"):
        for _ in loader:
            pass
    assert time.monotonic() - t0 < 20
    assert _workers_gone() and not _segments()


def test_early_break_leaves_no_process_or_segment():
    """Breaking out after one batch (with batches of the others already
    packed into shared memory) stops the workers and unlinks every
    segment; so does leaving `device_prefetch` early."""
    loader = tio.DataLoader(C.Arrays(40), batch_size=4, num_workers=2,
                            timeout=TIMEOUT, prefetch_factor=4)
    for b in loader:
        time.sleep(0.5)          # let the workers fill their queue
        break
    del b
    assert _workers_gone()
    assert not _segments()
    it = tio.device_prefetch(iter(loader))
    next(it)
    it.close()
    del it
    assert _workers_gone()
    assert not _segments()


def test_shutdown_sweeps_an_empty_segment():
    """A worker stopped between creating its segment and sizing it leaves
    an empty one, which cannot be mapped: the shutdown's sweep removes it
    by name, and then the rest of the pool's segments."""
    from multiprocessing import shared_memory as shm_mod
    loader = tio.DataLoader(C.Arrays(40), batch_size=4, num_workers=2,
                            timeout=TIMEOUT)
    it = iter(loader)
    next(it)
    pool = _POOLS[-1]
    name = pool.shm_base + "0_999"
    os.close(shm_mod._posixshmem.shm_open(
        "/" + name, os.O_CREAT | os.O_EXCL | os.O_RDWR, mode=0o600))
    assert name in _segments()
    pool.shutdown()
    assert _workers_gone() and not _segments()
    del it


def test_iterable_dataset_in_workers_and_fork_flag():
    """An IterableDataset: every worker iterates the whole stream (paddle's
    rule; shard it with get_worker_info), batched with drop_last; the
    start method is the `dataloader_start_method` flag."""
    from paddle_tpu_torch.core.flags import get_flags
    assert get_flags("dataloader_start_method") == "spawn"
    ds = tio.ChainDataset([C.Stream(5), C.Stream(2)])
    got = list(tio.DataLoader(ds, batch_size=3, drop_last=True,
                              num_workers=2, timeout=TIMEOUT))
    want = list(tio.DataLoader(ds, batch_size=3, drop_last=True))
    assert len(got) == 2 * len(want)
    key = sorted(tuple(b.numpy().ravel()) for b in got)
    assert key == sorted(2 * [tuple(b.numpy().ravel()) for b in want])
    assert _workers_gone() and not _segments()
