"""Datasets for the DataLoader worker tests (tests/test_torch_io_*.py).

Worker processes start by spawn and unpickle the dataset, so these live
at module level in a module that imports numpy only: a worker imports
this file and the port's io, never JAX or a test module."""
import os
import random
import signal
import time

import numpy as np


class Arrays:
    """Item i: a dict of an image-like float array, an int label and a
    (float64 vector, int) tuple, all from a seed and i."""

    def __init__(self, n=40, seed=0):
        self.n, self.seed = n, seed

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.default_rng(self.seed * 1000 + i)
        return {"x": rng.standard_normal((3, 4, 5)).astype(np.float32),
                "y": int(rng.integers(0, 10)),
                "pair": (rng.standard_normal(6), np.int32(i))}


class Failing(Arrays):
    """Raises on item `bad`."""

    def __init__(self, n=40, bad=13):
        super().__init__(n)
        self.bad = bad

    def __getitem__(self, i):
        if i == self.bad:
            raise ValueError(f"bad sample {i}")
        return super().__getitem__(i)


class Dying(Arrays):
    """The worker that loads item `bad` kills itself."""

    def __init__(self, n=40, bad=13):
        super().__init__(n)
        self.bad = bad

    def __getitem__(self, i):
        if i == self.bad:
            os.kill(os.getpid(), signal.SIGKILL)
        return super().__getitem__(i)


class Slow(Arrays):
    """Item `slow` takes `delay` seconds."""

    def __init__(self, n=16, slow=5, delay=30.0):
        super().__init__(n)
        self.slow, self.delay = slow, delay

    def __getitem__(self, i):
        if i == self.slow:
            time.sleep(self.delay)
        return super().__getitem__(i)


class SlowPairs:
    """Item i: (x, y), float32 vectors of 4 and 1 from a seed and i; item
    `slow` takes `delay` seconds."""

    def __init__(self, n=8, slow=None, delay=0.0):
        self.n, self.slow, self.delay = n, slow, delay

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i == self.slow:
            time.sleep(self.delay)
        rng = np.random.default_rng(i)
        return (rng.standard_normal(4).astype(np.float32),
                rng.standard_normal(1).astype(np.float32))


class WhoAmI:
    """Item i: (i, the worker's id, its num_workers, its seed, the id its
    worker_init_fn recorded), from `get_worker_info()` inside the
    worker."""

    def __len__(self):
        return 12

    def __getitem__(self, i):
        from paddle_tpu_torch.io import get_worker_info
        info = get_worker_info()
        return np.array([i, info.id, info.num_workers, info.seed % 100003,
                         int(os.environ.get("PT_TEST_WORKER_INIT", -1))],
                        np.int64)


class Draws:
    """Item i: one draw of numpy's and one of Python's global generators
    in the process that loads it."""

    def __len__(self):
        return 8

    def __getitem__(self, i):
        return np.array([np.random.random(), random.random()])


class Objects:
    """Items with an object-dtype leaf (it travels pickled)."""

    def __len__(self):
        return 6

    def __getitem__(self, i):
        return (np.full((2,), i, np.float32),
                np.array([f"s{i}", None], dtype=object))


class Stream:
    """An iterable of n float32 scalars (a component of ChainDataset)."""

    def __init__(self, n):
        self.n = n

    def __iter__(self):
        for i in range(self.n):
            yield np.float32(i)


def worker_init(worker_id):
    """A worker_init_fn: records its call in the process environment."""
    os.environ["PT_TEST_WORKER_INIT"] = str(worker_id)
