"""The harness of the port's op-library parity tests
(tests/test_torch_ops_*.py): each case runs one call of the paddle API
through the JAX package (`paddle_tpu`) and through the port
(`paddle_tpu_torch`, on the CPU) on the same numpy inputs and holds the
port to JAX's results:

  * every output a `Tensor` of the port where JAX gives a `Tensor`, of
    the same shape and dtype; integer and bool values exact, floats
    within rtol 1e-5 / atol 1e-6 (fp32) or the case's tolerance (1e-4 for
    transcendentals, as tests/test_ops.py uses);
  * with `grad`, the float inputs made differentiable and the gradients
    of sum(out * w) (w fixed random weights, one per float output) by
    `backward()` within 1e-5 (or the case's rtol) of the largest
    gradient;
  * the AMP dispatch names the op casts its inputs under, in order, equal
    to the JAX dispatcher's.
"""
from __future__ import annotations

import contextlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu as jp                                         # noqa: E402
import paddle_tpu_torch as tp                                   # noqa: E402
from paddle_tpu.core import tensor as jtensor                   # noqa: E402
from paddle_tpu_torch import amp as tamp                        # noqa: E402
from paddle_tpu_torch.core import device as tdevice             # noqa: E402
from paddle_tpu_torch.core.dtype import dtype_name              # noqa: E402


def cpu_default(monkeypatch):
    monkeypatch.setattr(tdevice, "_DEFAULT", [torch.device("cpu")])


def _tensors(P, inputs, grad):
    out = []
    for a in inputs:
        if isinstance(a, np.ndarray):
            sg = not (grad and a.dtype.kind == "f")
            out.append(P.to_tensor(a, dtype=a.dtype.name, stop_gradient=sg))
        else:
            out.append(a)
    return out


def _leaves(v):
    if isinstance(v, (jp.Tensor, tp.Tensor)):
        return [v]
    if isinstance(v, (list, tuple)):
        return [x for e in v for x in _leaves(e)]
    return []


def _float_leaves(v):
    return [t for t in _leaves(v)
            if np.dtype(_np_dtype(t)).kind == "f"]


def _np_dtype(t):
    return np.dtype(t.dtype).name if isinstance(t, jp.Tensor) \
        else dtype_name(t.dtype)


@contextlib.contextmanager
def recording():
    """(jax_names, port_names): the AMP dispatch names of the calls made
    inside the block."""
    jnames, tnames = [], []
    jorig = jtensor._amp_hook[0]
    torig = tamp.maybe_cast_inputs
    users = [m for name, m in list(sys.modules.items())
             if name.startswith("paddle_tpu_torch")
             and getattr(m, "maybe_cast_inputs", None) is torig]

    def jrec(name, raw):
        jnames.append(name)
        return jorig(name, raw)

    def trec(name, xs):
        tnames.append(name)
        return torig(name, xs)

    jtensor._amp_hook[0] = jrec
    for m in users:
        m.maybe_cast_inputs = trec
    try:
        yield jnames, tnames
    finally:
        jtensor._amp_hook[0] = jorig
        for m in users:
            m.maybe_cast_inputs = torig


def check_same(j, t, tol, path="out"):
    """The port's result `t` against JAX's `j`."""
    if isinstance(j, jp.Tensor):
        assert isinstance(t, tp.Tensor), (path, type(t))
        assert list(j.shape) == list(t.shape), (path, j.shape, t.shape)
        assert _np_dtype(j) == _np_dtype(t), (path, j.dtype, t.dtype)
        jn, tn = np.asarray(j.numpy()), np.asarray(t.numpy())
        if jn.dtype.kind in "biu":
            np.testing.assert_array_equal(tn, jn, err_msg=path)
        else:
            wide = np.complex128 if jn.dtype.kind == "c" else np.float64
            np.testing.assert_allclose(tn.astype(wide), jn.astype(wide),
                                       equal_nan=True, err_msg=path, **tol)
    elif isinstance(j, (list, tuple)):
        assert type(j) is type(t), (path, type(j), type(t))
        assert len(j) == len(t), path
        for i, (a, b) in enumerate(zip(j, t)):
            check_same(a, b, tol, f"{path}[{i}]")
    else:
        assert j == t, (path, j, t)


def _run(P, case, grad_seed):
    ts = _tensors(P, case.inputs, case.grad)
    res = case.fn(P, *ts)
    grads = None
    if case.grad:
        leaves = _float_leaves(res)
        rng = np.random.default_rng(grad_seed)
        loss = None
        for leaf in leaves:
            w = rng.standard_normal(list(leaf.shape)).astype(_np_dtype(leaf))
            term = P.sum(P.multiply(leaf, P.to_tensor(w, dtype=w.dtype.name)))
            loss = term if loss is None else loss + term
        if loss is not None:
            loss.backward()
        grads = [t.grad for t in ts
                 if isinstance(t, (jp.Tensor, tp.Tensor))
                 and np.dtype(_np_dtype(t)).kind == "f"]
    return res, grads


def check_case(case):
    """Run `case` in both packages and hold the port to JAX."""
    with recording() as (jnames, tnames):
        jres, _ = _run_forward(jp, case)
        tres, _ = _run_forward(tp, case)
    check_same(jres, tres, case.tol)
    assert tnames == jnames, (case.id, jnames, tnames)
    if case.grad:
        _, jg = _run(jp, case, 7)
        _, tg = _run(tp, case, 7)
        assert len(jg) == len(tg)
        scale = max([float(np.abs(np.asarray(g.numpy(), np.float64)).max())
                     for g in jg if g is not None] + [1e-30])
        for k, (a, b) in enumerate(zip(jg, tg)):
            assert (a is None) == (b is None), (case.id, k)
            if a is None:
                continue
            assert list(a.shape) == list(b.shape), (case.id, k)
            err = float(np.abs(np.asarray(b.numpy(), np.float64)
                               - np.asarray(a.numpy(), np.float64)).max())
            assert err <= max(case.tol["rtol"], 1e-5) * scale, \
                (case.id, k, err, scale)


def _run_forward(P, case):
    ts = _tensors(P, case.inputs, False)
    return case.fn(P, *ts), ts


def assert_covered(module_all, cases):
    """Every name of a JAX module's `__all__` has a case."""
    names = {c.name for c in cases}
    missing = sorted(set(module_all) - names)
    assert not missing, f"names without a parity case: {missing}"
