"""paddle_tpu_torch's `ops/manipulation.py` against the JAX package's,
name by name (harness: tests/torch_op_parity.py): values, dtypes and
shapes, gradients, the AMP dispatch names, the in-place ops' effect on
their input, and tests/test_ops.py's manipulation and indexing cases."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu as jp                                          # noqa: E402
import paddle_tpu_torch as tp                                    # noqa: E402
from paddle_tpu.ops import manipulation as jmanip                # noqa: E402

from torch_op_cases import MANIPULATION_CASES as CASES  # noqa: E402
from torch_op_cases import SEARCH_CASES, FP32, Rand  # noqa: E402
from torch_op_parity import (assert_covered, check_case,  # noqa: E402
                             check_same, cpu_default)

R = Rand(24)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    cpu_default(monkeypatch)


def test_every_manipulation_name_has_a_case():
    assert_covered(set(jmanip.__all__) - {"stride_check"}, CASES)
    for n in jmanip.__all__:
        assert callable(getattr(tp, n)), n


@pytest.mark.parametrize("case", CASES, ids=[c.id for c in CASES])
def test_manipulation_matches_jax(case):
    check_case(case)


def test_stride_check_raises_in_both():
    for P in (jp, tp):
        with pytest.raises(NotImplementedError):
            P.stride_check(P.to_tensor([1.0]))


_INPLACE = [
    ("reshape_", lambda P, y: P.reshape_(y, [2, 3])),
    ("squeeze_", lambda P, y: P.squeeze_(P.unsqueeze_(y, 0), 0)),
    ("unsqueeze_", lambda P, y: P.unsqueeze_(y, 0)),
    ("scatter_", lambda P, y: P.scatter_(
        y, P.to_tensor(np.array([1])), P.to_tensor(np.ones(1, np.float32)))),
    ("tanh_", lambda P, y: P.tanh_(y)),
]


@pytest.mark.parametrize("name,fn", _INPLACE, ids=[n for n, _ in _INPLACE])
@pytest.mark.parametrize("history", [False, True])
def test_inplace_ops_keep_stop_gradient_as_jax(name, fn, history):
    """An in-place op returns its input, now holding the result, and
    leaves `stop_gradient` as the JAX package does: True on a plain
    tensor, False on one with autograd history."""
    res = []
    for P in (jp, tp):
        w = P.to_tensor(np.arange(6, dtype=np.float32),
                        stop_gradient=not history)
        y = w * 2.0
        out = fn(P, y)
        assert out is y
        res.append((y.stop_gradient, y))
    assert res[0][0] == res[1][0]
    check_same(res[0][1], res[1][1], dict(rtol=1e-4, atol=1e-4))


def test_inplace_ops_carry_the_gradient():
    """Through reshape_, unsqueeze_, squeeze_ and tanh_ the gradient
    reaches the leaf. (The JAX package loses it here: its in-place ops
    point the tensor's tape node at a node whose input is the tensor
    itself, so the sweep stops; ROADMAP queue 3.)"""
    w = tp.to_tensor(np.arange(6, dtype=np.float32), stop_gradient=False)
    y = w * 2.0
    assert tp.reshape_(y, [2, 3]) is y and y.shape == [2, 3]
    tp.unsqueeze_(y, 0)
    tp.squeeze_(y, 0)
    tp.tanh_(y)
    tp.sum(y).backward()
    want = 2.0 * (1.0 - np.tanh(2.0 * np.arange(6)) ** 2)
    np.testing.assert_allclose(w.grad.numpy(), want.reshape(6), rtol=1e-5,
                               atol=1e-6)
    jw = jp.to_tensor(np.arange(6, dtype=np.float32), stop_gradient=False)
    jy = jw * 2.0
    jp.reshape_(jy, [2, 3])
    jp.sum(jy).backward()
    assert jw.grad is None


def test_manipulation_as_test_ops():
    """tests/test_ops.py test_manipulation / test_concat_split_stack /
    test_indexing_ops / test_where_clip, on the port and against JAX."""
    x = R.f(2, 3, 4)
    for fn, ref in [
            (lambda P, t: P.reshape(t, [6, 4]), lambda a: a.reshape(6, 4)),
            (lambda P, t: P.transpose(t, [2, 0, 1]),
             lambda a: a.transpose(2, 0, 1)),
            (lambda P, t: P.squeeze(P.unsqueeze(t, 0), 0), lambda a: a),
            (lambda P, t: P.flatten(t, 1, 2), lambda a: a.reshape(2, 12)),
            (lambda P, t: P.tile(t, [2, 1, 1]),
             lambda a: np.tile(a, (2, 1, 1))),
            (lambda P, t: P.flip(t, axis=[0]), lambda a: np.flip(a, 0)),
            (lambda P, t: P.roll(t, 1, axis=0), lambda a: np.roll(a, 1, 0)),
            (lambda P, t: P.where(t > 0, t, -t), np.abs)]:
        res = [fn(P, P.to_tensor(x)) for P in (jp, tp)]
        np.testing.assert_allclose(res[1].numpy(), ref(x), rtol=1e-6)
        check_same(res[0], res[1], FP32)
    a, b = R.f(2, 3), R.f(2, 3)
    for P in (jp, tp):
        ta, tb = P.to_tensor(a), P.to_tensor(b)
        np.testing.assert_allclose(P.concat([ta, tb], axis=0).numpy(),
                                   np.concatenate([a, b], 0))
        np.testing.assert_allclose(P.stack([ta, tb], axis=1).numpy(),
                                   np.stack([a, b], 1))
        parts = P.split(P.to_tensor(R.f(6, 2)), 3, axis=0)
        assert len(parts) == 3 and parts[0].shape == [2, 2]
        assert len(P.unbind(ta, axis=0)) == 2
        m = R.f(5, 3)
        i = P.to_tensor(np.array([0, 2, 4]))
        np.testing.assert_allclose(P.gather(P.to_tensor(m), i).numpy(),
                                   m[[0, 2, 4]])
        np.testing.assert_allclose(
            P.index_select(P.to_tensor(m), i, axis=0).numpy(), m[[0, 2, 4]])


WHERE_CASES = [c for c in SEARCH_CASES if c.name == "where"]


@pytest.mark.parametrize("case", WHERE_CASES,
                         ids=[c.id for c in WHERE_CASES])
def test_where_matches_jax(case):
    check_case(case)


def test_split_is_one_op_for_autograd():
    """split / chunk return the parts of one split: their backward is one
    concatenation (the GPT blocks' q, k, v chunks of the qkv product),
    not a zero-filled copy of the whole input per part."""
    x = tp.to_tensor(R.f(2, 6), stop_gradient=False)
    for parts in (tp.split(x, 3, axis=1), tp.chunk(x, 2, axis=1),
                  tp.split(x, [1, -1, 2], axis=1),
                  tp.split(tp.to_tensor(R.f(7), stop_gradient=False), 3)):
        # each part: the alias node of its wrapping over one split node
        under = {p.grad_fn.next_functions[0][0] for p in parts}
        assert len(under) == 1, under
        assert type(under.pop()).__name__.startswith("SplitWithSizes")
