"""paddle_tpu_torch int8 serving pieces against the JAX package.

The same numpy inputs go through the JAX package's `quant` modules and
kernels and through the port's:

  * `quant.ptq` weight PTQ (bit-equal, both param layouts, gains fp32);
  * `quant.kv` row quantization (equal codes and scales on the same rows)
    and `kv_page_bytes`;
  * the plain `int8_weight_matmul` against JAX's ``kernel="xla"`` and its
    Pallas kernel (interpret mode on the CPU), atol 1e-5 — the JAX gate
    (tests/test_quant.py `test_quant_kernels_match_reference`);
  * the M > 8 kernel's tensor-core arithmetic (x cut into three bf16
    pieces, int8 codes as bf16, fp32 sums in the kernel's order and split
    of K) emulated in PyTorch, within that gate of the plain version, JAX's
    reference and float64 at the decode step's K; with one piece it fails;
  * the M <= 8 GEMV's arithmetic (x as three bf16 pieces, one fp32
    accumulator per piece over a warp's 16-deep steps, the pieces' sums
    added b2 + b1 + b0, a CTA's warps' k parts in order, the cluster's K
    ranges in rank order, then the scale) emulated in PyTorch at M = 1, 2,
    4, 8 and the four GPT-2 block shapes, within that gate of the plain
    version, JAX's reference and Pallas kernel and float64; with one K
    range left out it fails. `gemv_geometry` is a function of (M, N, K)
    alone and gives at least two CTAs per SM at those shapes;
  * the plain `paged_decode_attention_quant` against JAX's reference and
    Pallas kernel at atol 5e-5: this XLA build evaluates exp with
    TPU-profile approximations on the CPU (~3e-5), as in
    tests/test_torch_paged_attention.py; and against the fp32 attention of
    the unquantized pools within 0.05 (the documented int8-KV tolerance);
  * the int8 kernel's split-KV arithmetic (test_torch_paged_attention.py
    `split_emulation` with the scales folded as the kernel folds them)
    within 1e-4 of the plain version, 5e-5 of JAX's reference and Pallas
    kernel, 1e-4 of float64 over the dequantized pools and 0.05 of the
    fp32 attention of the unquantized pools; with one CTA's partial state
    left out it fails the 1e-4 gate;
  * the pool ops on (data, scale) pairs, and the wrappers' checks.

The CUDA kernels run only on a GPU; chip_smoke.py holds them against the
same plain versions there.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu import framework  # noqa: E402
from paddle_tpu import quant as jquant  # noqa: E402
from paddle_tpu.inference import decode as jdecode  # noqa: E402
from paddle_tpu.models import gpt as jgpt  # noqa: E402
from paddle_tpu.ops.pallas import decode_attention as jda  # noqa: E402
from paddle_tpu.ops.pallas import quant_matmul as jqm  # noqa: E402
from paddle_tpu_torch import quant as tquant  # noqa: E402
from paddle_tpu_torch.inference import decode as tdecode  # noqa: E402
from paddle_tpu_torch.memory.page_allocator import (  # noqa: E402
    copy_page, gather_pages, write_pages)
from paddle_tpu_torch.models import gpt as tgpt  # noqa: E402
from paddle_tpu_torch.ops.kernels import _build  # noqa: E402
from paddle_tpu_torch.ops.kernels import decode_attention as tda  # noqa: E402
from paddle_tpu_torch.ops.kernels import quant_matmul as tqm  # noqa: E402
from tests.test_torch_paged_attention import (  # noqa: E402
    _split_cases, float64_attention, split_emulation)

ATOL_MM = 1e-5
ATOL_ATTN = 5e-5
INT8_KERNEL_TOL = 1e-4    # the int8 attention kernel against its plain version
INT8_KV_TOL = 0.05
H = 4

_CFGS = [
    ("tiny-scan", jgpt.gpt_tiny()),
    ("small-unrolled", jgpt.GPTConfig(vocab_size=256, max_seq_len=64,
                                      hidden=32, layers=3, heads=2,
                                      scan_layers=False)),
]


@pytest.fixture(scope="module")
def arrays():
    paddle.seed(17)
    return {name: {k: np.asarray(v) for k, v in
                   framework.param_arrays(jgpt.GPT(cfg)).items()}
            for name, cfg in _CFGS}


@pytest.mark.parametrize("name", [n for n, _ in _CFGS])
def test_quantize_params_is_bit_equal_to_jax(arrays, name):
    a = arrays[name]
    want = jquant.quantize_params(a)
    got = tquant.quantize_params(a)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    stacked = name == "tiny-scan"
    qkv = "blocks.attn.qkv.weight" if stacked else "blocks.0.attn.qkv.weight"
    ln = "blocks.ln1.weight" if stacked else "blocks.0.ln1.weight"
    assert got[qkv].dtype == np.int8
    assert got[qkv + tquant.SCALE_SUFFIX].shape == a[qkv].shape[:-2] \
        + a[qkv].shape[-1:]                  # [L, out] stacked, [out]
    # gains, biases and embeddings stay fp32 (a stacked [L, hidden] gain
    # is 2-D and must not pick up a scale)
    for k in (ln, "ln_f.weight", "wte.weight", "wpe.weight"):
        assert got[k].dtype == np.float32 and k + "::scale" not in got, k
    assert tquant.is_quantized(got) and not tquant.is_quantized(a)
    deq_t, deq_j = tquant.dequantize_params(got), \
        jquant.dequantize_params(want)
    assert set(deq_t) == set(a)
    for k in deq_j:
        np.testing.assert_array_equal(deq_t[k], deq_j[k], err_msg=k)
    with pytest.raises(ValueError, match="double quantize"):
        tquant.quantize_params(got)


def test_quantize_kv_matches_jax_on_the_same_rows():
    rng = np.random.default_rng(4)
    rows = rng.standard_normal((3, 5, 4, 16), np.float32) * 3
    rows[0, 0, 0] = 0.0                          # an all-zero row
    rows[1, 2, 3] = np.arange(16) - 8.0          # exact ties at scale 8/127
    rows[2, 4, 1, :2] = [127.0, -63.5]           # and a half-way code
    jq, js = jquant.quantize_kv(jnp.asarray(rows))
    tq, ts = tquant.quantize_kv(torch.from_numpy(rows))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert tq.shape == rows.shape and ts.shape == rows.shape[:-1]
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert (tq[0, 0, 0] == 0).all() and np.isfinite(ts.numpy()).all()
    np.testing.assert_array_equal(
        tquant.dequantize_kv(tq, ts).numpy(),
        np.asarray(jquant.dequantize_kv(jq, js)))


def test_kv_dtype_pool_zeros_and_page_bytes_match_jax():
    for v in ("", None, "fp32", "F32", "float32", "int8", " INT8 "):
        assert tquant.validate_kv_dtype(v) == jquant.validate_kv_dtype(v)
    with pytest.raises(ValueError):
        tquant.validate_kv_dtype("int4")
    shape = (2, 5, 4, 3, 8)
    data, scale = tquant.kv_pool_zeros(shape, "int8", "cpu")
    assert data.dtype == torch.int8 and data.shape == shape
    assert scale.dtype == torch.float32 and scale.shape == shape[:-1]
    fp = tquant.kv_pool_zeros(shape)
    assert fp.dtype == torch.float32 and fp.shape == shape
    assert not fp.any() and not data.any() and not scale.any()
    for _, cfg in _CFGS + [("124m", jgpt.gpt2_124m())]:
        pcfg = tgpt.GPTConfig(**dataclasses.asdict(cfg))
        for pt in (4, 16):
            for kvd in ("float32", "int8"):
                assert tdecode.kv_page_bytes(pcfg, pt, kvd) \
                    == jdecode.kv_page_bytes(cfg, pt, kvd)
    g = tgpt.gpt2_124m()
    assert tdecode.kv_page_bytes(g, 16, "int8") == 313344
    assert tdecode.kv_page_bytes(g, 16) == 1179648


# (K, N, x's leading shape, weight std): the JAX gate's own 16 x 8 unit
# normals, and a wider 96 x 40 weight at GPT's init scale (std 0.02), so
# the outputs have the magnitude the 1e-5 gate was set for
@pytest.mark.parametrize("K,N,xshape,std", [(16, 8, (3,), 1.0),
                                            (16, 8, (2, 3), 1.0),
                                            (96, 40, (5,), 0.02),
                                            (96, 40, (2, 7), 0.02)])
def test_int8_matmul_plain_matches_jax_xla_and_pallas(K, N, xshape, std):
    rng = np.random.default_rng(K * 100 + N + len(xshape))
    q = tquant.quantize_params(
        {"l.weight": rng.standard_normal((K, N), np.float32) * std})
    wq, s = q["l.weight"], q["l.weight::scale"]
    x = rng.standard_normal(xshape + (K,), np.float32)
    got = tqm.int8_weight_matmul(torch.from_numpy(x), torch.from_numpy(wq),
                                 torch.from_numpy(s)).numpy()
    jargs = (jnp.asarray(x), jnp.asarray(wq), jnp.asarray(s))
    want_xla = np.asarray(jqm.int8_weight_matmul(*jargs, kernel="xla"))
    want_pallas = np.asarray(jqm.int8_weight_matmul(*jargs,
                                                    kernel="pallas"))
    assert got.shape == xshape + (N,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want_xla, rtol=0, atol=ATOL_MM)
    np.testing.assert_allclose(got, want_pallas, rtol=0, atol=ATOL_MM)
    exact = x @ (wq.astype(np.float32) * s)
    np.testing.assert_allclose(got, exact, rtol=0, atol=ATOL_MM)


# ------------------------- the int8 matmul's M > 8 tensor-core arithmetic

def _cut_bf16(v):
    """v with its low 16 bits cleared: its top 8 significant bits, a bf16
    value held as float32."""
    return (v.view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)


def _split3(x):
    """csrc/int8_weight_matmul.cu `split3`: x = b0 + b1 + b2 exactly."""
    b0 = _cut_bf16(x)
    r1 = x - b0
    b1 = _cut_bf16(r1)
    return b0, b1, r1 - b1


def _k_ranges(M, N, K, sms=132):
    """The kernel's split of K (`split_k`, on a card of `sms` SMs): 64 x 64
    tiles of out, K ranges of whole 32-deep steps, at least 256 deep."""
    tiles = -(-M // 64) * -(-N // 64)
    S = 1 if tiles >= 2 * sms else min(-(-2 * sms // tiles),
                                       max(K // 256, 1))
    steps = -(-K // 32)
    chunk = -(-steps // S) * 32
    return [(k, min(K, k + chunk)) for k in range(0, K, chunk)]


def _tc_mm_emulation(x, wq, s, pieces=3):
    """The M > 8 kernel's sums in float32: x cut into `pieces` of its
    three bf16 pieces, per K range and 16-deep k slice acc += b2.q, acc +=
    b1.q, acc += b0.q (each product exact, fp32 sums), the ranges' partials
    summed in range order, then scaled."""
    parts = [torch.from_numpy(np.ascontiguousarray(b))
             for b in _split3(x)[:pieces]]
    q = torch.from_numpy(wq.astype(np.float32))
    M, K = x.shape
    total = None
    for k0, k1 in _k_ranges(M, wq.shape[1], K):
        acc = torch.zeros(M, wq.shape[1])
        for k in range(k0, k1, 16):
            for b in reversed(parts):
                acc += b[:, k:min(k + 16, k1)] @ q[k:min(k + 16, k1)]
        total = acc if total is None else total + acc
    return (total * torch.from_numpy(s)).numpy()


@pytest.mark.parametrize("K", [768, 3072])
def test_int8_matmul_tensor_core_split_matches_plain_jax_and_float64(K):
    """The tensor-core route's arithmetic at the decode step's K (x cut into
    three bf16 pieces times the int8 codes, fp32 sums in the kernel's
    order, split K) is within ATOL_MM of the port's plain version, JAX's
    `int8_weight_matmul_reference` and the float64 product, on weights
    quantized from GPT's std-0.02 init; with one piece (x cut to bf16) it
    is not."""
    rng = np.random.default_rng(K)
    M, N = 24, 64
    q = tquant.quantize_params(
        {"l.weight": rng.standard_normal((K, N), np.float32) * 0.02})
    wq, s = q["l.weight"], q["l.weight::scale"]
    x = rng.standard_normal((M, K), np.float32)
    b0, b1, b2 = _split3(x)
    assert np.array_equal(b0 + b1 + b2, x)
    assert not any((b.view(np.uint32) & 0xFFFF).any() for b in (b0, b1, b2))
    assert len(_k_ranges(M, N, K)) > 1
    plain = tqm.int8_weight_matmul(torch.from_numpy(x), torch.from_numpy(wq),
                                   torch.from_numpy(s)).numpy()
    jax_ref = np.asarray(jqm.int8_weight_matmul_reference(
        jnp.asarray(x), jnp.asarray(wq), jnp.asarray(s)))
    exact = x.astype(np.float64) @ (wq.astype(np.float64) * s)
    got = _tc_mm_emulation(x, wq, s)
    for want in (plain, jax_ref, exact):
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_MM)
    errs = {n: np.abs(_tc_mm_emulation(x, wq, s, n) - exact).max()
            for n in (1, 2)}
    print(f"K={K}: max abs error against float64 with 1, 2, 3 pieces: "
          f"{errs[1]:.3e}, {errs[2]:.3e}, {np.abs(got - exact).max():.3e} "
          f"(gate {ATOL_MM})")
    assert errs[1] > ATOL_MM


# ----------------------------- the M <= 8 GEMV's tensor-core arithmetic

GPT2_BLOCK_SHAPES = ((768, 2304), (768, 768), (768, 3072), (3072, 768))


def _gemv_emulation(x, wq, s, drop=None):
    """csrc/int8_weight_matmul.cu `int8_gemv_mma_kernel` in float32, from
    `gemv_geometry`: K in `split` ranges of `k_steps` 16-deep steps (one
    CTA each), a range in passes of `pass_steps`, a pass's steps in 4 //
    (strip // 16) contiguous k parts (one warp each per 16 columns); a
    warp keeps one accumulator per piece of x over its steps and adds them
    b2 + b1 + b0; a CTA adds its k parts in order, the cluster its ranges
    in rank order, then the scale. Columns never mix, so all N go at once.
    `drop` leaves one K range out."""
    M, K = x.shape
    N = wq.shape[1]
    g = tqm.gemv_geometry(M, N, K)
    split, chunk, pas = g["grid"][0], g["k_steps"], g["pass_steps"]
    parts = 4 // (g["strip"] // 16)
    steps = -(-K // 16)
    pieces = [torch.from_numpy(np.ascontiguousarray(b)) for b in _split3(x)]
    q = torch.from_numpy(wq.astype(np.float32))
    total = torch.zeros(M, N)
    for r in range(split):
        s1 = min(steps, (r + 1) * chunk)
        acc = [[torch.zeros(M, N) for _ in pieces] for _ in range(parts)]
        for ps in range(r * chunk, s1, pas):
            pn = min(pas, s1 - ps)
            per = -(-pn // parts)
            for wk in range(parts):
                for st in range(ps + wk * per, ps + min(pn, (wk + 1) * per)):
                    sl = slice(16 * st, min(16 * st + 16, K))
                    for i, b in enumerate(pieces):
                        acc[wk][i] += b[:, sl] @ q[sl]
        cta = torch.zeros(M, N)
        for a in acc:
            cta = cta + ((a[2] + a[1]) + a[0])
        if r != drop:
            total = total + cta
    return (total * torch.from_numpy(s)).numpy()


def _gemv_inputs(M, K, N):
    rng = np.random.default_rng(M * 10007 + K + N)
    q = tquant.quantize_params(
        {"l.weight": rng.standard_normal((K, N), np.float32) * 0.02})
    return (rng.standard_normal((M, K), np.float32), q["l.weight"],
            q["l.weight::scale"])


@pytest.mark.parametrize("K,N", GPT2_BLOCK_SHAPES)
@pytest.mark.parametrize("M", [1, 2, 4, 8])
def test_gemv_tensor_core_split_matches_plain_jax_and_float64(M, K, N):
    """The decode GEMV's arithmetic at every batch rung and each block
    matmul of GPT-2 124M is within ATOL_MM of the port's plain version,
    JAX's `int8_weight_matmul_reference`, its Pallas kernel (interpret
    mode) and the float64 product, on weights quantized from GPT's
    std-0.02 init."""
    x, wq, s = _gemv_inputs(M, K, N)
    assert tqm.gemv_geometry(M, N, K)["grid"][0] > 1     # a split of K
    got = _gemv_emulation(x, wq, s)
    plain = tqm.int8_weight_matmul(torch.from_numpy(x), torch.from_numpy(wq),
                                   torch.from_numpy(s)).numpy()
    jargs = (jnp.asarray(x), jnp.asarray(wq), jnp.asarray(s))
    jax_ref = np.asarray(jqm.int8_weight_matmul_reference(*jargs))
    pallas = np.asarray(jqm.int8_weight_matmul(*jargs, kernel="pallas"))
    exact = x.astype(np.float64) @ (wq.astype(np.float64) * s)
    assert got.shape == (M, N) and np.isfinite(got).all()
    for want in (plain, jax_ref, pallas, exact):
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_MM)


@pytest.mark.parametrize("K,N", [(768, 768), (3072, 768)])
def test_gemv_with_a_k_range_left_out_fails_the_gate(K, N):
    """The gate sees a lost CTA: leaving the first or the last K range of
    the cluster out of the sum moves the answer past ATOL_MM."""
    x, wq, s = _gemv_inputs(8, K, N)
    exact = x.astype(np.float64) @ (wq.astype(np.float64) * s)
    assert np.abs(_gemv_emulation(x, wq, s) - exact).max() <= ATOL_MM
    split = tqm.gemv_geometry(8, N, K)["grid"][0]
    for drop in (0, split - 1):
        err = np.abs(_gemv_emulation(x, wq, s, drop=drop) - exact).max()
        assert not err <= ATOL_MM, (drop, err)


def test_gemv_geometry_is_a_function_of_the_static_shapes():
    """The GEMV's launch from (M, N, K) alone: the same at every batch
    rung, at least two CTAs on each of the H100's 132 SMs at the four
    GPT-2 block shapes, K ranges and passes that cover the k steps once,
    a strip of whole warps, panels within the 48 KB a CTA may use beside
    the kernel's 18,448 B of static shared memory; shapes it does not take
    raise."""
    for K, N in GPT2_BLOCK_SHAPES:
        g = tqm.gemv_geometry(8, N, K)
        assert all(tqm.gemv_geometry(M, N, K) == g for M in (1, 2, 4))
        assert g["grid"][0] * g["grid"][1] >= 2 * 132
        assert g["cluster"] == (g["grid"][0], 1, 1) and g["cluster"][0] <= 8
    for M, N, K in ((1, 45, 37), (3, 770, 768), (2, 16, 20000),
                    (8, 2304, 768), (8, 768, 3072), (5, 100, 1000)):
        g = tqm.gemv_geometry(M, N, K)
        split, chunk, pas = g["grid"][0], g["k_steps"], g["pass_steps"]
        steps = -(-K // 16)
        covered = [st for r in range(split)
                   for ps in range(r * chunk, min(steps, (r + 1) * chunk), pas)
                   for st in range(ps, min(ps + pas, (r + 1) * chunk, steps))]
        assert covered == list(range(steps))
        assert g["strip"] in (16, 32, 64) and g["grid"][1] * g["strip"] >= N
        assert g["threads"] == 128 and g["workspace_bytes"] == 0
        assert g["smem_bytes"] + 18448 <= 48 * 1024
    assert tqm.gemv_geometry(2, 16, 20000)["pass_steps"] \
        < tqm.gemv_geometry(2, 16, 20000)["k_steps"]      # several passes
    for bad in ((0, 768, 768), (9, 768, 768), (8, 0, 768), (8, 768, 0)):
        with pytest.raises(ValueError):
            tqm.gemv_geometry(*bad)


def _attn_inputs(seed, B, D, pt, W, lengths, null_rows=()):
    rng = np.random.default_rng(seed)
    P = B * W + 1
    q = rng.standard_normal((B, H, D), np.float32)
    k = rng.standard_normal((P, pt, H, D), np.float32)
    v = rng.standard_normal((P, pt, H, D), np.float32)
    perm = rng.permutation(np.arange(1, P))
    tables = np.zeros((B, W), np.int32)
    for b, n in enumerate(lengths):
        if b not in null_rows:
            tables[b, :-(-n // pt)] = perm[b * W:b * W - (-n // pt)]
    kq, ks = (np.array(a) for a in jquant.quantize_kv(jnp.asarray(k)))
    vq, vs = (np.array(a) for a in jquant.quantize_kv(jnp.asarray(v)))
    return q, (k, v), (kq, ks, vq, vs), tables, np.asarray(lengths,
                                                           np.int32)


def _attn_cases():
    out = []
    for D in (16, 64):
        for pt in (4, 16):
            W = 8 if pt == 4 else 4
            out.append((1, D, pt, W, [2 * pt], ()))            # page boundary
            out.append((3, D, pt, W, [1, pt + 1, W * pt], ()))  # full table
            out.append((3, D, pt, W, [1, pt, W * pt - 1], (0,)))  # padded row
    return out


@pytest.mark.parametrize("B,D,pt,W,lengths,null_rows", _attn_cases())
def test_quant_attention_plain_matches_jax(B, D, pt, W, lengths, null_rows):
    q, (k, v), quant, tables, lens = _attn_inputs(
        B * 1000 + D * 10 + pt, B, D, pt, W, lengths, null_rows)
    got = tda.paged_decode_attention_quant(
        torch.from_numpy(q), *(torch.from_numpy(a) for a in quant),
        torch.from_numpy(tables), torch.from_numpy(lens)).numpy()
    jargs = [jnp.asarray(a) for a in (q, *quant, tables, lens)]
    want_xla = np.asarray(jda.paged_decode_attention_quant(*jargs,
                                                           kernel="xla"))
    want_pallas = np.asarray(jda.paged_decode_attention_quant(
        *jargs, kernel="pallas"))
    assert got.shape == (B, H, D) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want_xla, rtol=0, atol=ATOL_ATTN)
    np.testing.assert_allclose(got, want_pallas, rtol=0, atol=ATOL_ATTN)
    truth = tda.paged_decode_attention(
        *(torch.from_numpy(a) for a in (q, k, v, tables, lens))).numpy()
    assert np.abs(got - truth).max() < INT8_KV_TOL


@pytest.mark.parametrize("D,pt,W,lengths,null_rows", _split_cases())
def test_split_emulation_int8_matches_plain_jax_float64_and_fp32(
        D, pt, W, lengths, null_rows):
    B = len(lengths)
    q, (k, v), quant, tables, lens = _attn_inputs(
        D * 100 + pt + W, B, D, pt, W, lengths, null_rows)
    kq, ks, vq, vs = (torch.from_numpy(a) for a in quant)
    tq, tt, tl = (torch.from_numpy(a) for a in (q, tables, lens))
    got = split_emulation(tq, kq, vq, tt, tl, scales=(ks, vs)).numpy()
    plain = tda.paged_decode_attention_quant(tq, kq, ks, vq, vs, tt,
                                             tl).numpy()
    jargs = [jnp.asarray(a) for a in (q, *quant, tables, lens)]
    want_pallas = np.asarray(jda.paged_decode_attention_quant(
        *jargs, kernel="pallas"))
    deq = [quant[0] * quant[1][..., None], quant[2] * quant[3][..., None]]
    exact = float64_attention(q, *deq, tables, lens)
    truth = tda.paged_decode_attention(
        *(torch.from_numpy(a) for a in (q, k, v, tables, lens))).numpy()
    assert got.shape == (B, H, D) and np.isfinite(got).all()
    np.testing.assert_allclose(got, plain, rtol=0, atol=INT8_KERNEL_TOL)
    np.testing.assert_allclose(got, want_pallas, rtol=0, atol=ATOL_ATTN)
    np.testing.assert_allclose(got, exact, rtol=0, atol=INT8_KERNEL_TOL)
    assert np.abs(got - truth).max() < INT8_KV_TOL


def test_split_emulation_int8_with_a_split_left_out_fails_the_gate():
    q, _, quant, tables, lens = _attn_inputs(11, 3, 64, 16, 4, [64, 41, 9])
    kq, ks, vq, vs = (torch.from_numpy(a) for a in quant)
    tq, tt, tl = (torch.from_numpy(a) for a in (q, tables, lens))
    plain = tda.paged_decode_attention_quant(tq, kq, ks, vq, vs, tt,
                                             tl).numpy()
    full = split_emulation(tq, kq, vq, tt, tl, scales=(ks, vs)).numpy()
    assert np.abs(full - plain).max() <= INT8_KERNEL_TOL
    for drop in (0, tda.SPLIT - 1):
        err = np.abs(split_emulation(tq, kq, vq, tt, tl, scales=(ks, vs),
                                     drop=drop).numpy() - plain).max()
        assert not err <= INT8_KERNEL_TOL, (drop, err)


def test_pool_ops_on_pairs_and_copy_on_write():
    data, scale = tquant.kv_pool_zeros((2, 4, 3, 2, 5), "int8")
    pool = (data, scale)
    rows = torch.randn(2, 2, 3, 2, 5)
    out = write_pages(pool, tquant.quantize_kv(rows), torch.tensor([2, 1]))
    assert out is pool                                     # in place
    got = tquant.dequantize_kv(*gather_pages(pool, torch.tensor([2, 1])))
    assert (got - rows).abs().max() <= scale.max() / 2 + 1e-7
    copy_page(pool, 2, 3)                                  # COW: both leaves
    torch.testing.assert_close(data[:, 3], data[:, 2], rtol=0, atol=0)
    torch.testing.assert_close(scale[:, 3], scale[:, 2], rtol=0, atol=0)
    gd, gs = gather_pages(pool, torch.tensor([[3, 1], [0, 2]]))
    assert gd.shape == (2, 2, 2, 3, 2, 5) and gs.shape == (2, 2, 2, 3, 2)
    gd.zero_()                                             # independent copy
    assert data[:, 3].abs().sum() > 0
    # single rows of one layer: pool[1, pages, offsets] = rows
    one = tquant.quantize_kv(torch.full((2, 2, 5), 3.0))
    write_pages(pool, one, torch.tensor([1, 3]), offset=torch.tensor([0, 2]),
                layer=1)
    assert (data[1, 1, 0] == 127).all() and (data[1, 3, 2] == 127).all()
    assert torch.allclose(scale[1, 1, 0], torch.tensor(3.0 / 127))
    assert not (data[0, 1, 0] == 127).all()
    with pytest.raises(TypeError):
        write_pages(pool, rows, torch.tensor([2, 1]))     # fp32 rows, pair
    with pytest.raises(TypeError):
        write_pages(data.float(), one, torch.tensor([1, 3]))


def test_wrappers_reject_what_the_kernels_do_not_take():
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((3, 16), np.float32))
    w = torch.from_numpy(rng.integers(-127, 128, (16, 8)).astype(np.int8))
    s = torch.rand(8)
    before = tqm.launches
    torch.testing.assert_close(
        tqm.int8_weight_matmul(x, w, s),
        tqm.int8_weight_matmul(x, w, s, kernel="reference"))
    assert tqm.launches == before              # CPU tensors launch nothing
    with pytest.raises(TypeError):
        tqm.int8_weight_matmul(x, w.float(), s)          # fp32 "int8" weight
    with pytest.raises(TypeError):
        tqm.int8_weight_matmul(x.double(), w, s)
    with pytest.raises(ValueError, match="do not match"):
        tqm.int8_weight_matmul(x[:, :15], w, s)
    with pytest.raises(ValueError, match="do not match"):
        tqm.int8_weight_matmul(x, w, s[:7])
    with pytest.raises(ValueError, match="on meta"):
        tqm.int8_weight_matmul(x, w.to("meta"), s)
    with pytest.raises(ValueError, match="no kernel for device"):
        tqm.int8_weight_matmul(x.to("meta"), w.to("meta"), s.to("meta"))
    with pytest.raises(ValueError, match="kernel="):
        tqm.int8_weight_matmul(x, w, s, kernel="pallas")

    q, _, (kq, ks, vq, vs), tables, lens = _attn_inputs(
        5, 2, 16, 4, 4, [3, 9])
    args = [torch.from_numpy(a) for a in (q, kq, ks, vq, vs, tables, lens)]
    before = tda.quant_launches
    torch.testing.assert_close(
        tda.paged_decode_attention_quant(*args),
        tda.paged_decode_attention_quant(*args, kernel="reference"))
    assert tda.quant_launches == before
    tda._check_quant(*args)                              # well-formed
    bad = list(args)
    bad[1] = args[1].float()                             # fp32 pool
    with pytest.raises(TypeError):
        tda._check_quant(*bad)
    bad = list(args)
    bad[2] = args[2][:, :2].contiguous()                 # scale shape
    with pytest.raises(ValueError, match="scales"):
        tda._check_quant(*bad)
    bad = list(args)
    bad[4] = args[4].to("meta")                          # device
    with pytest.raises(ValueError, match="on meta"):
        tda._check_quant(*bad)
    with pytest.raises(ValueError, match="do not match"):
        tda._check_quant(args[0], *args[1:5], args[5][:1], args[6])
    with pytest.raises(ValueError, match="kernel="):
        tda.paged_decode_attention_quant(*args, kernel="pallas")
    with pytest.raises(ValueError, match="no kernel for device"):
        tda.paged_decode_attention_quant(*(a.to("meta") for a in args))


def test_missing_nvcc_raises_for_both_int8_kernels(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(tqm, "_FN", None)
    monkeypatch.setattr(tda, "_QFN", None)
    # the CUDA path of each wrapper builds its kernel first: no fallback
    with pytest.raises(RuntimeError, match="nvcc not found"):
        tqm._kernel_fn()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        tda._quant_kernel_fn()
    assert {"int8_weight_matmul", "paged_decode_attention_int8"} \
        <= set(_build.sources())
