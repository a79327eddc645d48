"""paddle_tpu_torch paged decode attention against the JAX package.

The port's `paged_decode_attention` on CPU tensors takes its plain
PyTorch version; it is held here against the JAX package's XLA reference
and its Pallas kernel (interpret mode on the CPU). The CUDA kernel itself
runs only on a GPU and is held against the same plain version by
chip_smoke.py.

The kernel's split-KV arithmetic (csrc/paged_decode_split.cuh) is
emulated in PyTorch (`split_emulation`): each sequence's rows cut into
`SPLIT` CTA ranges, each range into warps' chunks of the kernel's stage
rows, an online softmax per warp, the warps merged per CTA and the CTAs
in rank order. It is held to the plain version within the kernel's gate
(1e-5), to JAX within 5e-5 and to float64 within 1e-5; with one CTA's
partial state left out it fails the gate.

Tolerance against JAX: atol 5e-5. This XLA build evaluates exp with
TPU-profile approximations even on the CPU (about 3e-5 absolute error
against numpy), and the softmax goes through it.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from paddle_tpu.ops.pallas import decode_attention as jda  # noqa: E402
from paddle_tpu_torch.ops.kernels import _build  # noqa: E402
from paddle_tpu_torch.ops.kernels import decode_attention as tda  # noqa: E402

ATOL = 5e-5
KERNEL_TOL = 1e-5     # the fp32 kernel against its plain version
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


# ------------------------------------------- the split kernels' arithmetic

def _merge(states):
    """Partial softmax states (m [H], l [H], acc [H, D]) merged in order,
    as the kernel merges its warps and then its cluster's CTAs."""
    M = states[0][0]
    for m, _, _ in states[1:]:
        M = torch.maximum(M, m)
    L = torch.zeros_like(M)
    acc = torch.zeros_like(states[0][2])
    for m, l, a in states:
        f = torch.exp(m - M)
        L = L + l * f
        acc = acc + a * f[:, None]
    return M, L, acc


def split_emulation(q, k_pool, v_pool, tables, lengths, scales=None,
                    drop=None):
    """csrc/paged_decode_split.cuh's arithmetic in float32: the rows
    [0, len) of sequence b (len clamped to [1, W*pt]) cut into SPLIT CTA
    ranges [r*len//SPLIT, (r+1)*len//SPLIT), each range into chunks of the
    stage rows taken by the CTA's warps in turn, an online softmax per warp
    chunk by chunk, the warps merged into the CTA's state and the CTAs'
    states merged in rank order. `scales` = (k_scale, v_scale) for int8
    pools: the score times k_scale, p times v_scale before it multiplies
    v. `drop` leaves one CTA's state out of the merge."""
    B, H_, D = q.shape
    pt, W = k_pool.shape[1], tables.shape[1]
    g = tda.split_geometry(B, H_, D, pt, W, int8=scales is not None)
    S, warps, R = g["grid"][0], g["threads"] // 32, g["stage_rows"]
    scale = 1.0 / math.sqrt(D)
    out = torch.empty(B, H_, D)
    for b in range(B):
        n = min(max(int(lengths[b]), 1), W * pt)
        t = torch.arange(n)
        page, off = tables[b, t // pt].long(), t % pt
        k, v = k_pool[page, off].float(), v_pool[page, off].float()
        if scales is not None:
            ks, vs = scales[0][page, off], scales[1][page, off]
        ctas = []
        for r in range(S):
            r0, r1 = r * n // S, (r + 1) * n // S
            states = []
            for w in range(warps):
                m = torch.full((H_,), tda.NEG_INF)
                l = torch.zeros(H_)
                acc = torch.zeros(H_, D)
                for c0 in range(r0 + w * R, r1, warps * R):
                    rows = slice(c0, min(c0 + R, r1))
                    s = torch.einsum("hd,nhd->nh", q[b], k[rows])
                    s = s * ks[rows] * scale if scales is not None \
                        else s * scale
                    m_new = torch.maximum(m, s.max(0).values)
                    corr = torch.exp(m - m_new)
                    p = torch.exp(s - m_new)
                    pv = p * vs[rows] if scales is not None else p
                    l = l * corr + p.sum(0)
                    acc = acc * corr[:, None] \
                        + torch.einsum("nh,nhd->hd", pv, v[rows])
                    m = m_new
                states.append((m, l, acc))
            ctas.append(_merge(states))
        if drop is not None:
            del ctas[drop]
        _, L, acc = _merge(ctas)
        out[b] = acc / L[:, None]
    return out


def float64_attention(q, k, v, tables, lengths):
    """The exact answer in float64 (numpy): rows [0, len) through the
    table, softmax(q.k / sqrt(D)) . v."""
    B, H_, D = q.shape
    pt, W = k.shape[1], tables.shape[1]
    out = np.empty((B, H_, D))
    for b in range(B):
        n = min(max(int(lengths[b]), 1), W * pt)
        t = np.arange(n)
        kk = k[tables[b, t // pt], t % pt].astype(np.float64)   # [n, H, D]
        vv = v[tables[b, t // pt], t % pt].astype(np.float64)
        s = np.einsum("hd,nhd->hn", q[b].astype(np.float64), kk) \
            / math.sqrt(D)
        p = np.exp(s - s.max(1, keepdims=True))
        out[b] = np.einsum("hn,nhd->hd", p / p.sum(1, keepdims=True), vv)
    return out


def _split_cases():
    """Ragged lengths: 1, page multiples, W*pt, a length-1 row with an
    all-null table, lengths shorter than SPLIT (CTAs with no rows), at
    head dims on both sides of 64 (one pair a lane, two)."""
    S = tda.SPLIT
    out = []
    for D in (16, 64, 128):
        for pt, W in ((4, 8), (16, 4)):
            out.append((D, pt, W, [1, 2 * pt, W * pt], ()))
            out.append((D, pt, W, [1, S - 3, W * pt - 1], (0,)))
            out.append((D, pt, W, [S - 1, pt + 1, 3], ()))
    return out


@pytest.mark.parametrize("D,pt,W,lengths,null_rows", _split_cases())
def test_split_emulation_matches_plain_jax_pallas_and_float64(
        D, pt, W, lengths, null_rows):
    B = len(lengths)
    q, k, v, tables, lens = _inputs(D * 100 + pt + W, B, D, pt, W, lengths,
                                    null_rows)
    args = [torch.from_numpy(a) for a in (q, k, v, tables, lens)]
    got = split_emulation(*args).numpy()
    plain = tda.paged_decode_attention(*args).numpy()
    jargs = [jnp.asarray(a) for a in (q, k, v, tables, lens)]
    want_pallas = np.asarray(
        jda.paged_decode_attention(*jargs, kernel="pallas"))
    exact = float64_attention(q, k, v, tables, lens)
    assert got.shape == (B, H, D) and np.isfinite(got).all()
    np.testing.assert_allclose(got, plain, rtol=0, atol=KERNEL_TOL)
    np.testing.assert_allclose(got, want_pallas, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, exact, rtol=0, atol=KERNEL_TOL)


@pytest.mark.parametrize("D", [64, 128])
def test_split_emulation_with_a_split_left_out_fails_the_gate(D):
    """The gate sees a lost CTA: leaving one rank's partial state out of
    the merge (rank 0, or the last) moves the answer past 1e-5."""
    q, k, v, tables, lens = _inputs(D, 3, D, 16, 4, [64, 41, 9])
    args = [torch.from_numpy(a) for a in (q, k, v, tables, lens)]
    plain = tda.paged_decode_attention(*args).numpy()
    full = np.abs(split_emulation(*args).numpy() - plain).max()
    assert full <= KERNEL_TOL
    for drop in (0, tda.SPLIT - 1):
        err = np.abs(split_emulation(*args, drop=drop).numpy()
                     - plain).max()
        assert not err <= KERNEL_TOL, (drop, err)


def test_split_geometry_is_a_function_of_the_static_shapes():
    """The launch of both paged kernels from (B, H, D, pt, W) alone: at
    the decode path's shape and GPT-3 1.3B's head shape; every CTA's
    range at every length fits the table entries it stages, and the
    ranges cover [0, len) once; shapes the kernels do not take raise."""
    S = tda.SPLIT
    g = tda.split_geometry(8, 12, 64, 16, 64)
    assert g == {"grid": (S, 12, 8), "cluster": (S, 1, 1), "threads": 128,
                 "smem_bytes": 4 * (64 * 16 // S // 16 + 1),
                 "stage_rows": 4, "workspace_bytes": 0}
    assert tda.split_geometry(8, 12, 64, 16, 64, int8=True)["stage_rows"] \
        == 16
    big = tda.split_geometry(8, 16, 128, 16, 128)
    assert big["grid"] == (S, 16, 8) and big["stage_rows"] == 2
    assert tda.split_geometry(8, 16, 128, 16, 128, int8=True)[
        "stage_rows"] == 8
    for pt, W in ((1, 3), (4, 5), (16, 4), (7, 9)):
        slots = tda.split_geometry(2, 1, 16, pt, W)["smem_bytes"] // 4
        for n in range(1, W * pt + 1):
            covered = []
            for r in range(S):
                r0, r1 = r * n // S, (r + 1) * n // S
                covered += range(r0, r1)
                if r1 > r0:
                    assert (r1 - 1) // pt - r0 // pt + 1 <= slots
            assert covered == list(range(n))
    for bad in ((8, 12, 63, 16, 64), (8, 12, 130, 16, 64),
                (70000, 12, 64, 16, 64), (8, 12, 64, 16, 20000),
                (8, 12, 64, 0, 64)):
        with pytest.raises(ValueError):
            tda.split_geometry(*bad)
    q, k, v, tables, lens = (torch.from_numpy(a) for a in
                             _inputs(5, 2, 16, 4, 4, [3, 9]))
    wide = torch.zeros(2, 20000, dtype=torch.int32)
    with pytest.raises(ValueError, match="too wide"):
        tda._check(q, k, v, wide, lens)
