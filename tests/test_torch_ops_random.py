"""paddle_tpu_torch's `ops/random.py` on the CPU. The two packages draw
different numbers from one seed, so each function is held to the JAX
function's shape and dtype for the same arguments, to its support, and
to its law (tests/torch_op_cases.py RANDOM_LAWS, which chip_smoke.py's
phase 13 runs on the card): the sample mean (and, where the fourth
moment is known, the variance) of n >= 10^5 draws within 5 standard
errors of the law's, with a fixed seed. Then what a seed promises: `paddle.seed` and
`set_cuda_rng_state` replay the same numbers, `uniform(seed=s)` gives
the same numbers on every call, a `torch.Generator` passed as `key=` is
drawn from; `multinomial` without replacement over more samples than
nonzero weights returns (as the JAX package's does); and the AMP
dispatch names of the three ops that dispatch."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu as jp                                       # noqa: E402
import paddle_tpu_torch as tp                                 # noqa: E402
from paddle_tpu.ops import random as jrandom                  # noqa: E402

from torch_op_cases import N_DRAWS, RANDOM_LAWS, law_errors  # noqa: E402
from torch_op_parity import cpu_default, recording  # noqa: E402


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    cpu_default(monkeypatch)
    tp.seed(2024)


# (name, call(P)): shape and dtype equal to the JAX function's
SHAPES = [
    ("rand", lambda P: P.rand([3, 4])),
    ("rand", lambda P: P.rand([2], dtype="float64")),
    ("randn", lambda P: P.randn([5])),
    ("standard_normal", lambda P: P.standard_normal([2, 2], "float64")),
    ("uniform", lambda P: P.uniform([3], min=2.0, max=5.0)),
    ("uniform", lambda P: P.uniform(4, dtype="float64", seed=7)),
    ("normal", lambda P: P.normal(1.0, 2.0, [3, 2])),
    ("normal", lambda P: P.normal(P.to_tensor(np.zeros((2, 1), np.float32)),
                                  P.to_tensor(np.ones(3, np.float32)))),
    ("gaussian", lambda P: P.gaussian([2, 3], 1.0, 0.5)),
    ("randint", lambda P: P.randint(3, 9, [4])),
    ("randint", lambda P: P.randint(5, shape=[2, 2], dtype="int32")),
    ("randint_like", lambda P: P.randint_like(
        P.to_tensor(np.zeros((2, 3), np.float32)), 4)),
    ("randint_like", lambda P: P.randint_like(
        P.to_tensor(np.zeros(3, np.int64)), 1, 6, dtype="int32")),
    ("randperm", lambda P: P.randperm(6)),
    ("randperm", lambda P: P.randperm(4, dtype="int32")),
    ("bernoulli", lambda P: P.bernoulli(
        P.to_tensor(np.full((2, 3), 0.5, np.float32)))),
    ("bernoulli", lambda P: P.bernoulli(
        P.to_tensor(np.full(3, 0.5, np.float16)))),
    ("multinomial", lambda P: P.multinomial(
        P.to_tensor(np.array([0.2, 0.3, 0.5], np.float32)), 2)),
    ("multinomial", lambda P: P.multinomial(
        P.to_tensor(np.ones(4, np.float32)), 5, replacement=True)),
    ("poisson", lambda P: P.poisson(
        P.to_tensor(np.full((2, 2), 3.0, np.float32)))),
    ("exponential_", lambda P: P.exponential_(
        P.to_tensor(np.zeros(4, np.float32)), 2.0)),
    ("uniform_", lambda P: P.uniform_(
        P.to_tensor(np.zeros((2, 2), np.float64)), 0.0, 1.0)),
]


@pytest.mark.parametrize("name,call", SHAPES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(SHAPES)])
def test_shape_and_dtype_match_jax(name, call):
    j, t = call(jp), call(tp)
    assert isinstance(t, tp.Tensor) and t.device.type == "cpu"
    assert list(t.shape) == list(j.shape), (name, j.shape, t.shape)
    assert np.dtype(j.dtype).name == tp.core.dtype.dtype_name(t.dtype)


def test_every_random_name_is_tested():
    assert {n for n, _ in SHAPES} == set(jrandom.__all__)
    for n in jrandom.__all__:
        assert callable(getattr(tp, n)), n


@pytest.mark.parametrize("law", RANDOM_LAWS, ids=[law.id for law in
                                                  RANDOM_LAWS])
def test_law(law):
    t = law.draw(tp, N_DRAWS)
    assert isinstance(t, tp.Tensor) and t.device.type == "cpu"
    assert tp.core.dtype.dtype_name(t.dtype) == law.dtype
    law_errors(law, t.numpy())


def test_every_random_name_has_a_law():
    assert {law.id.split("-")[0] for law in RANDOM_LAWS} == \
        set(jrandom.__all__)


def test_multinomial_rows_and_short_support():
    """Rows of weights, with and without replacement (the JAX package's
    `categorical` call refuses rows with replacement: its `shape` puts
    the batch first; ROADMAP queue 3); without replacement the draws of
    a row are distinct, and more samples than nonzero weights return
    (zero-weight categories last), as in the JAX package."""
    p = np.tile(np.array([0.1, 0.0, 0.6, 0.3], np.float32), (1000, 1))
    assert tp.multinomial(tp.to_tensor(p), 7, replacement=True).shape == \
        [1000, 7]
    r = tp.multinomial(tp.to_tensor(p), 3).numpy()
    assert r.shape == (1000, 3) and all(len(set(row)) == 3 for row in r)
    w = np.array([0.5, 0.5, 0.0, 0.0], np.float32)
    for P in (jp, tp):
        got = P.multinomial(P.to_tensor(w), 4)
        assert sorted(got.numpy().tolist()) == [0, 1, 2, 3]
        assert sorted(got.numpy()[:2].tolist()) == [0, 1]


def test_seeds_replay():
    tp.seed(5)
    a = tp.rand([8]).numpy()
    tp.seed(5)
    np.testing.assert_array_equal(tp.rand([8]).numpy(), a)
    state = tp.get_cuda_rng_state()
    b = tp.randn([8]).numpy()
    tp.set_cuda_rng_state(state)
    np.testing.assert_array_equal(tp.randn([8]).numpy(), b)
    # uniform(seed=s): the same numbers on every call, whatever the
    # global generators did in between
    u = tp.uniform([6], seed=11).numpy()
    tp.rand([3])
    np.testing.assert_array_equal(tp.uniform([6], seed=11).numpy(), u)
    x, y = tp.zeros([6]), tp.zeros([6])
    np.testing.assert_array_equal(tp.uniform_(x, seed=11).numpy(), u)
    np.testing.assert_array_equal(tp.uniform_(y, seed=11).numpy(), u)
    assert not np.array_equal(tp.uniform([6], seed=12).numpy(), u)
    # key=: a torch.Generator
    g1 = torch.Generator().manual_seed(3)
    g2 = torch.Generator().manual_seed(3)
    for fn in (lambda k: tp.randn([4], key=k),
               lambda k: tp.randint(0, 100, [4], key=k),
               lambda k: tp.multinomial(tp.to_tensor(
                   np.ones(5, np.float32)), 3, key=k),
               lambda k: tp.bernoulli(tp.to_tensor(
                   np.full(4, 0.5, np.float32)), key=k)):
        np.testing.assert_array_equal(fn(g1).numpy(), fn(g2).numpy())


def test_amp_dispatch_names_match_jax():
    x = np.full(4, 0.5, np.float32)
    with recording() as (jnames, tnames):
        for P in (jp, tp):
            P.bernoulli(P.to_tensor(x))
            P.poisson(P.to_tensor(x))
            P.gaussian([2])
            P.rand([2])
            P.multinomial(P.to_tensor(x), 2)
            P.exponential_(P.to_tensor(x))
    assert jnames == tnames == ["bernoulli", "poisson", "gaussian"]
