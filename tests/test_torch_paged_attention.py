"""paddle_tpu_torch paged decode attention against the JAX package.

The port's `paged_decode_attention` on CPU tensors takes its plain
PyTorch version; it is held here against the JAX package's XLA reference
and its Pallas kernel (interpret mode on the CPU). The CUDA kernel itself
runs only on a GPU and is held against the same plain version by
chip_smoke.py.

Tolerance: atol 5e-5. This XLA build evaluates exp with TPU-profile
approximations even on the CPU (about 3e-5 absolute error against numpy),
and the softmax goes through it.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from paddle_tpu.ops.pallas import decode_attention as jda  # noqa: E402
from paddle_tpu_torch.ops.kernels import _build  # noqa: E402
from paddle_tpu_torch.ops.kernels import decode_attention as tda  # noqa: E402

ATOL = 5e-5
H = 4


def _inputs(seed, B, D, pt, W, lengths, null_rows=()):
    """q, pools and block tables from numpy: every sequence maps its own
    random live pages; table entries past them (and every entry of a
    `null_rows` row, a padded batch row) point at the null page 0."""
    rng = np.random.default_rng(seed)
    P = B * W + 1
    q = rng.standard_normal((B, H, D), np.float32)
    k = rng.standard_normal((P, pt, H, D), np.float32)
    v = rng.standard_normal((P, pt, H, D), np.float32)
    perm = rng.permutation(np.arange(1, P))
    tables = np.zeros((B, W), np.int32)
    for b, n in enumerate(lengths):
        if b not in null_rows:
            live = -(-n // pt)
            tables[b, :live] = perm[b * W:b * W + live]
    return q, k, v, tables, np.asarray(lengths, np.int32)


def _cases():
    out = []
    for D in (16, 64):
        for pt in (4, 16):
            W = 8 if pt == 4 else 4
            out.append((1, D, pt, W, [2 * pt], ()))          # page boundary
            out.append((1, D, pt, W, [W * pt], ()))          # full table
            out.append((3, D, pt, W, [1, pt + 1, W * pt], ()))
            out.append((3, D, pt, W, [1, pt, W * pt - 1], (0,)))  # padded row
    return out


@pytest.mark.parametrize("B,D,pt,W,lengths,null_rows", _cases())
def test_plain_matches_jax_xla_and_pallas(B, D, pt, W, lengths, null_rows):
    q, k, v, tables, lens = _inputs(B * 1000 + D * 10 + pt, B, D, pt, W,
                                    lengths, null_rows)
    got = tda.paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(tables), torch.from_numpy(lens)).numpy()
    jargs = [jnp.asarray(a) for a in (q, k, v, tables, lens)]
    want_xla = np.asarray(jda.paged_decode_attention(*jargs, kernel="xla"))
    want_pallas = np.asarray(
        jda.paged_decode_attention(*jargs, kernel="pallas"))
    assert got.shape == (B, H, D) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want_xla, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, want_pallas, rtol=0, atol=ATOL)


def test_dispatch_on_device_and_kernel_argument():
    q, k, v, tables, lens = _inputs(3, 2, 16, 4, 4, [3, 9])
    args = [torch.from_numpy(a) for a in (q, k, v, tables, lens)]
    before = tda.launches
    np.testing.assert_array_equal(
        tda.paged_decode_attention(*args).numpy(),
        tda.paged_decode_attention(*args, kernel="reference").numpy())
    assert tda.launches == before          # CPU tensors launch nothing
    with pytest.raises(ValueError):
        tda.paged_decode_attention(*args, kernel="pallas")
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="no kernel for device"):
        tda.paged_decode_attention(*meta)


def test_wrapper_checks_reject_what_the_kernel_does_not_take():
    q, k, v, tables, lens = (torch.from_numpy(a) for a in
                             _inputs(4, 2, 16, 4, 4, [3, 9]))
    tda._check(q, k, v, tables, lens)                     # well-formed
    with pytest.raises(TypeError):
        tda._check(q.double(), k, v, tables, lens)
    with pytest.raises(TypeError):
        tda._check(q, k, v, tables.long(), lens)
    with pytest.raises(ValueError, match="contiguous"):
        tda._check(q.transpose(0, 1).contiguous().transpose(0, 1),
                   k, v, tables, lens)
    with pytest.raises(ValueError, match="dims"):
        tda._check(q[0], k, v, tables, lens)
    with pytest.raises(ValueError, match="head_dim"):
        odd = torch.zeros(2, 4, 15)
        pool = torch.zeros(9, 4, 4, 15)
        tda._check(odd, pool, pool, tables, lens)
    with pytest.raises(ValueError, match="do not match"):
        tda._check(q, k, v, tables[:1], lens)


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()
    assert "paged_decode_attention" in _build.sources()
