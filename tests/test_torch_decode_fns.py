"""paddle_tpu_torch contiguous-cache decode (`gpt_decode_fns`) against the
JAX package.

  * `decode_attention` on CPU tensors takes its plain PyTorch version; it
    is held against JAX's `decode_attention_reference` and its Pallas
    kernel `_decode_attention_pallas` (interpret mode on the CPU) at
    test_decode.py's kernel gate shape, including a length of 0 (every
    row masked: the softmax is uniform, the output the mean of all cap
    rows of v) and lengths past cap (every row live). The CUDA kernel
    itself runs only on a GPU and is held against the same plain version
    by chip_smoke.py (phase 2c).
  * the kernel's arithmetic (csrc/paged_decode_split.cuh with the
    contiguous row address) emulated in float32 PyTorch
    (`contig_split_emulation`: the rows of each sequence cut into SPLIT
    CTA ranges, each into the warps' chunks of the stage rows, an online
    softmax per warp, the warps and then the CTAs merged in order; a
    length of 0 scores every one of the cap rows -1e30), within 1e-5 of
    the plain version, JAX's reference, its Pallas kernel and float64 at
    lengths 0, 1, cap, cap + 5 and shorter than SPLIT, a cap shorter than
    SPLIT, and D = 16, 64, 128; with one CTA's partial state left out it
    fails the gate. `contig_split_geometry` is a function of (B, H, D,
    cap) alone.
  * prefill + 6 decode steps, logits and both caches, against JAX
    `gpt_decode_fns` from the same numpy weights, on both configurations
    of tests/test_decode.py: a scan-stacked gpt_tiny (JAX params
    ``blocks.<name>`` with a leading [layers] axis) and an unrolled
    ``scan_layers=False`` config (``blocks.<i>.<name>``). The port always
    takes the indexed layout (`params_from_numpy` expands the stacked
    one). fp32 weights, then int8 block weights from each package's own
    `quantize_params` (the caches stay fp32 in both).
  * a step at cache_len >= cap (the capacity past the prefill's panel,
    below max_seq_len) and past max_seq_len: JAX clamps the position to
    max_seq_len - 1 and XLA clamps the write to row cap - 1; the port
    does the same in place.
  * `framework.param_arrays` of a port `GPT` feeds `gpt_decode_fns`, and
    prefill + steps reproduce that layer's own full forward (as
    test_decode.py does for the JAX package).

Tolerances. Attention: 1e-5, the contract of test_decode.py's kernel
gate. Decode logits and caches: atol 2e-4, rtol 1e-4, as
tests/test_torch_gpt_decode.py: the two frameworks sum fp32 matmuls in
different orders, and this XLA build evaluates exp, tanh and erf with
TPU-profile approximations on the CPU (about 3e-5 each); both compound
through the layers into logits of magnitude ~1-10. The port against its
own `GPT` forward: atol 1e-4, test_decode.py's gate for the same check.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu import framework as jframework  # noqa: E402
from paddle_tpu import quant as jquant  # noqa: E402
from paddle_tpu.models import gpt as jgpt  # noqa: E402
from paddle_tpu.ops.pallas import decode_attention as jda  # noqa: E402
from paddle_tpu_torch import framework as tframework  # noqa: E402
from paddle_tpu_torch import quant as tquant  # noqa: E402
from paddle_tpu_torch.core import device as tdevice  # noqa: E402
from paddle_tpu_torch.ops.kernels import _build  # noqa: E402
from paddle_tpu_torch.models import gpt as tgpt  # noqa: E402
from paddle_tpu_torch.ops.kernels import decode_attention as tda  # noqa: E402
from tests.test_torch_paged_attention import _merge  # noqa: E402

ATTN_TOL = 1e-5
ATOL, RTOL = 2e-4, 1e-4
SELF_TOL = 1e-4
CAP = 16
STEPS = 6
PROMPT_LENS = (5, 9)

_CFGS = [
    ("tiny-scan", jgpt.gpt_tiny()),
    ("small-unrolled", jgpt.GPTConfig(vocab_size=256, max_seq_len=64,
                                      hidden=32, layers=3, heads=2,
                                      scan_layers=False)),
]


@pytest.fixture(scope="module")
def models():
    paddle.seed(7)
    out = {}
    for name, cfg in _CFGS:
        arrays = {k: np.asarray(v) for k, v in
                  jframework.param_arrays(jgpt.GPT(cfg)).items()}
        out[name] = (cfg, arrays)
    return out


def _attn_inputs(B, cap, H, D, lengths, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, H, D).astype(np.float32),
            rng.randn(B, cap, H, D).astype(np.float32),
            rng.randn(B, cap, H, D).astype(np.float32),
            np.asarray(lengths, np.int32))


# test_decode.py's kernel gate shape: B=3, cap=32, H=4, D=16
@pytest.mark.parametrize("lengths", [[1, 17, 32], [0, 32 + 5, 3]],
                         ids=["ragged", "zero-and-past-cap"])
def test_plain_attention_matches_jax_reference_and_pallas(lengths):
    q, k, v, lens = _attn_inputs(3, 32, 4, 16, lengths, 41)
    got = tda.decode_attention(*(torch.from_numpy(a)
                                 for a in (q, k, v, lens))).numpy()
    jargs = [jnp.asarray(a) for a in (q, k, v, lens)]
    want_ref = np.asarray(jda.decode_attention_reference(*jargs))
    want_pallas = np.asarray(jda._decode_attention_pallas(*jargs))
    assert got.shape == (3, 4, 16) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want_ref, rtol=0, atol=ATTN_TOL)
    np.testing.assert_allclose(got, want_pallas, rtol=0, atol=ATTN_TOL)
    if lengths[0] == 0:          # every row masked: the mean of v's rows
        np.testing.assert_allclose(got[0], v[0].mean(axis=0), rtol=0,
                                   atol=ATTN_TOL)


def test_dispatch_and_wrapper_checks():
    q, k, v, lens = (torch.from_numpy(a) for a in
                     _attn_inputs(2, 8, 4, 16, [3, 8], 5))
    before = tda.contig_launches
    np.testing.assert_array_equal(
        tda.decode_attention(q, k, v, lens).numpy(),
        tda.decode_attention(q, k, v, lens, kernel="reference").numpy())
    assert tda.contig_launches == before     # CPU tensors launch nothing
    for bad in ("cuda", "pallas", "xla"):    # JAX's switch is not carried
        with pytest.raises(ValueError):
            tda.decode_attention(q, k, v, lens, kernel=bad)
    meta = [t.to("meta") for t in (q, k, v, lens)]
    with pytest.raises(ValueError, match="no kernel for device"):
        tda.decode_attention(*meta)
    # the kernel's contract, checked before a launch
    tda._check_contig(q, k, v, lens)                       # well-formed
    with pytest.raises(TypeError):
        tda._check_contig(q.double(), k, v, lens)
    with pytest.raises(TypeError):
        tda._check_contig(q, k, v, lens.long())
    with pytest.raises(ValueError, match="contiguous"):
        tda._check_contig(q.transpose(0, 1).contiguous().transpose(0, 1),
                          k, v, lens)
    with pytest.raises(ValueError, match="do not match"):
        tda._check_contig(q, k[:, :, :2].contiguous(),
                          v[:, :, :2].contiguous(), lens)
    with pytest.raises(ValueError, match="do not match"):
        tda._check_contig(q, k, v, lens[:1])
    with pytest.raises(ValueError, match="cap 0"):
        tda._check_contig(q, k[:, :0], v[:, :0], lens)
    with pytest.raises(ValueError, match="head_dim"):
        odd = torch.zeros(2, 4, 15)
        tda._check_contig(odd, torch.zeros(2, 8, 4, 15),
                          torch.zeros(2, 8, 4, 15), lens)


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    """The CUDA path builds its kernel first, and a build that cannot run
    raises: there is no fallback to the plain version."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(tda, "_CFN", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        tda._contig_kernel_fn()
    assert "decode_attention" in _build.sources()


# ------------------------------------ the split kernel's arithmetic (row 3)

def contig_split_emulation(q, k, v, lengths, drop=None):
    """csrc/paged_decode_split.cuh with `ContiguousRows`, in float32: the
    length clamped to [0, cap], 0 meaning every one of the cap rows scores
    -1e30; rows [0, n) cut into SPLIT CTA ranges [r*n//SPLIT,
    (r+1)*n//SPLIT), each into chunks of the stage rows taken by the CTA's
    warps in turn, an online softmax per warp chunk by chunk, the warps
    merged into the CTA's state and the CTAs' states merged in rank order.
    `drop` leaves one CTA's state out of the merge."""
    B, cap, H_, D = k.shape
    g = tda.contig_split_geometry(B, H_, D, cap)
    S, warps, R = g["grid"][0], g["threads"] // 32, g["stage_rows"]
    scale = 1.0 / np.sqrt(D)
    out = torch.empty(B, H_, D)
    for b in range(B):
        n = min(max(int(lengths[b]), 0), cap)
        uniform = n == 0
        n = cap if uniform else n
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
                    s = torch.einsum("hd,nhd->nh", q[b], k[b, rows]) * scale
                    if uniform:
                        s = torch.full_like(s, tda.NEG_INF)
                    m_new = torch.maximum(m, s.max(0).values)
                    corr = torch.exp(m - m_new)
                    p = torch.exp(s - m_new)
                    l = l * corr + p.sum(0)
                    acc = acc * corr[:, None] \
                        + torch.einsum("nh,nhd->hd", p, v[b, rows])
                    m = m_new
                states.append((m, l, acc))
            ctas.append(_merge(states))
        if drop is not None:
            del ctas[drop]
        _, L, acc = _merge(ctas)
        out[b] = acc / L[:, None]
    return out


def _float64_contig(q, k, v, lengths):
    """The exact answer in float64 (numpy): softmax(q.k / sqrt(D)) . v
    over rows [0, min(len, cap)), uniform over all cap rows at length 0."""
    B, cap, H_, D = k.shape
    out = np.empty((B, H_, D))
    for b in range(B):
        n = min(max(int(lengths[b]), 0), cap)
        vv = v[b].astype(np.float64)
        if n == 0:
            out[b] = vv.mean(axis=0)
            continue
        s = np.einsum("hd,nhd->hn", q[b].astype(np.float64),
                      k[b, :n].astype(np.float64)) / np.sqrt(D)
        p = np.exp(s - s.max(1, keepdims=True))
        out[b] = np.einsum("hn,nhd->hd", p / p.sum(1, keepdims=True), vv[:n])
    return out


def _contig_split_cases():
    """(cap, D, lengths): the edges 0, 1, cap and past it, lengths shorter
    than SPLIT (CTAs with no rows), a cap shorter than SPLIT, at head dims
    on both sides of 64 (one pair a lane, two)."""
    S = tda.SPLIT
    out = []
    for D in (16, 64, 128):
        out.append((32, D, [0, 1, 32, 32 + 5]))
        out.append((32, D, [S - 1, 3, 0, 2 * S + 1]))
        out.append((5, D, [0, 2, 5, 7]))
    return out


@pytest.mark.parametrize("cap,D,lengths", _contig_split_cases())
def test_contig_split_emulation_matches_plain_jax_pallas_and_float64(
        cap, D, lengths):
    q, k, v, lens = _attn_inputs(len(lengths), cap, 4, D, lengths,
                                 cap * 1000 + D)
    args = [torch.from_numpy(a) for a in (q, k, v, lens)]
    got = contig_split_emulation(*args).numpy()
    plain = tda.decode_attention(*args).numpy()
    jargs = [jnp.asarray(a) for a in (q, k, v, lens)]
    want_ref = np.asarray(jda.decode_attention_reference(*jargs))
    want_pallas = np.asarray(jda._decode_attention_pallas(*jargs))
    exact = _float64_contig(q, k, v, lens)
    assert got.shape == (len(lengths), 4, D) and np.isfinite(got).all()
    for want in (plain, want_ref, want_pallas, exact):
        np.testing.assert_allclose(got, want, rtol=0, atol=ATTN_TOL)


@pytest.mark.parametrize("D", [64, 128])
def test_contig_split_emulation_with_a_split_left_out_fails_the_gate(D):
    """The gate sees a lost CTA: leaving one rank's partial state out of
    the merge (rank 0, or the last) moves the answer past 1e-5, at a
    length of 0 (the uniform mean) as well as at live lengths."""
    q, k, v, lens = _attn_inputs(3, 64, 4, D, [64, 41, 0], D)
    args = [torch.from_numpy(a) for a in (q, k, v, lens)]
    plain = tda.decode_attention(*args).numpy()
    full = np.abs(contig_split_emulation(*args).numpy() - plain).max()
    assert full <= ATTN_TOL
    for drop in (0, tda.SPLIT - 1):
        err = np.abs(contig_split_emulation(*args, drop=drop).numpy()
                     - plain).max(axis=(1, 2))
        assert (err > ATTN_TOL).all(), (drop, err)


def test_contig_split_geometry_is_a_function_of_the_static_shapes():
    """The contiguous kernel's launch from (B, H, D, cap) alone: the
    split-KV template's grid, cluster and stage rows, no dynamic shared
    memory and no workspace, 768 CTAs at the decode path's shape; the CTA
    ranges cover [0, n) once at every length (n = cap at length 0); shapes
    the kernel does not take raise."""
    S = tda.SPLIT
    g = tda.contig_split_geometry(8, 12, 64, 1024)
    assert g == {"grid": (S, 12, 8), "cluster": (S, 1, 1), "threads": 128,
                 "smem_bytes": 0, "stage_rows": 4, "workspace_bytes": 0}
    assert g["grid"][0] * g["grid"][1] * g["grid"][2] >= 2 * 132
    big = tda.contig_split_geometry(8, 16, 128, 2048)
    assert big["grid"] == (S, 16, 8) and big["stage_rows"] == 2
    assert tda.contig_split_geometry(8, 12, 64, 32) == g   # cap: no effect
    for cap in (1, 5, 8, 33):
        for length in range(0, cap + 3):
            n = min(length, cap) or cap
            covered = []
            for r in range(S):
                covered += range(r * n // S, (r + 1) * n // S)
            assert covered == list(range(n))
    for bad in ((8, 12, 63, 1024), (8, 12, 130, 1024), (70000, 12, 64, 8),
                (8, 12, 64, 0), (0, 12, 64, 8)):
        with pytest.raises(ValueError):
            tda.contig_split_geometry(*bad)


def _port_params(cfg, arrays):
    pcfg = tgpt.GPTConfig(**dataclasses.asdict(cfg))
    return pcfg, tgpt.params_from_numpy(pcfg, arrays, device="cpu")


def _prompts(cfg, seed):
    """A [B, CAP] panel of prompts of PROMPT_LENS tokens (zero padded),
    and the tokens fed to the steps (fixed, so both packages see the same
    inputs whatever their argmax)."""
    rng = np.random.RandomState(seed)
    toks = np.zeros((len(PROMPT_LENS), CAP), np.int32)
    for b, n in enumerate(PROMPT_LENS):
        toks[b, :n] = rng.randint(0, cfg.vocab_size, n)
    feed = rng.randint(0, cfg.vocab_size, (STEPS, len(PROMPT_LENS)))
    return toks, np.asarray(PROMPT_LENS, np.int32), feed.astype(np.int32)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=ATOL, rtol=RTOL)


def _run_both(cfg, tparams, jparams, seed):
    """prefill + STEPS decode steps through both packages; holds logits
    and both caches after every call, and the port's in-place writes."""
    pcfg = tgpt.GPTConfig(**dataclasses.asdict(cfg))
    jpre, jstep = jgpt.gpt_decode_fns(cfg)
    tpre, tstep = tgpt.gpt_decode_fns(pcfg)
    toks, lens, feed = _prompts(cfg, seed)
    jl, jk, jv = jpre(jparams, jnp.asarray(toks), jnp.asarray(lens))
    tl, tk, tv = tpre(tparams, torch.from_numpy(toks),
                      torch.from_numpy(lens))
    assert tuple(tk.shape) == (cfg.layers, len(lens), CAP, cfg.heads,
                               cfg.hidden // cfg.heads)
    for got, want in ((tl, jl), (tk, jk), (tv, jv)):
        _close(got, want)
    clen = lens.copy()
    for s in range(STEPS):
        jl, jk, jv = jstep(jparams, jk, jv, jnp.asarray(feed[s]),
                           jnp.asarray(clen))
        tl, tk2, tv2 = tstep(tparams, tk, tv, torch.from_numpy(feed[s]),
                             torch.from_numpy(clen))
        assert tk2 is tk and tv2 is tv           # written in place
        for got, want in ((tl, jl), (tk, jk), (tv, jv)):
            _close(got, want)
        clen = clen + 1
    return tk, tv, jk, jv


@pytest.mark.parametrize("quant", [None, "int8"])
@pytest.mark.parametrize("name", [n for n, _ in _CFGS])
def test_prefill_and_decode_steps_match_jax(models, name, quant):
    cfg, arrays = models[name]
    if quant:
        jq = jquant.quantize_params(arrays)
        tq = tquant.quantize_params(arrays)
        assert set(tq) == set(jq)
        for key in jq:                           # the same int8 weights
            np.testing.assert_array_equal(tq[key], jq[key])
        jarrays, tarrays = jq, tq
    else:
        jarrays = tarrays = arrays
    _, tparams = _port_params(cfg, tarrays)
    if quant:
        assert tparams["blocks.0.fc1.weight"].dtype == torch.int8
    jparams = {k: jnp.asarray(v) for k, v in jarrays.items()}
    _run_both(cfg, tparams, jparams, seed=3)


@pytest.mark.parametrize("name", [n for n, _ in _CFGS])
def test_step_past_the_capacity_matches_jax_clamped_write(models, name):
    """Two steps from a full [2, CAP] panel at cache_len CAP (one past the
    panel) and CAP + 4 (below max_seq_len), then CAP + 5 and far past
    max_seq_len: every write lands on row CAP - 1 and every row attends."""
    cfg, arrays = models[name]
    _, tparams = _port_params(cfg, arrays)
    jparams = {k: jnp.asarray(v) for k, v in arrays.items()}
    pcfg = tgpt.GPTConfig(**dataclasses.asdict(cfg))
    jpre, jstep = jgpt.gpt_decode_fns(cfg)
    tpre, tstep = tgpt.gpt_decode_fns(pcfg)
    rng = np.random.RandomState(9)
    toks = rng.randint(0, cfg.vocab_size, (2, CAP)).astype(np.int32)
    lens = np.full(2, CAP, np.int32)
    _, jk, jv = jpre(jparams, jnp.asarray(toks), jnp.asarray(lens))
    _, tk, tv = tpre(tparams, torch.from_numpy(toks), torch.from_numpy(lens))
    before = tk.clone()
    assert CAP + 5 < cfg.max_seq_len
    for clen in ([CAP, CAP + 4], [CAP + 5, 10 * cfg.max_seq_len]):
        clen = np.asarray(clen, np.int32)
        last = rng.randint(0, cfg.vocab_size, 2).astype(np.int32)
        jl, jk, jv = jstep(jparams, jk, jv, jnp.asarray(last),
                           jnp.asarray(clen))
        tl, tk, tv = tstep(tparams, tk, tv, torch.from_numpy(last),
                           torch.from_numpy(clen))
        for got, want in ((tl, jl), (tk, jk), (tv, jv)):
            _close(got, want)
    # only row CAP - 1 of each sequence changed
    changed = (tk != before).any(dim=(0, 3, 4))              # [B, CAP]
    assert changed[:, CAP - 1].all() and not changed[:, :CAP - 1].any()


@pytest.fixture
def cpu_default(monkeypatch):
    """The port's training layers are created on the CPU here."""
    monkeypatch.setattr(tdevice, "_DEFAULT", [torch.device("cpu")])


def test_param_arrays_of_a_port_gpt_feed_the_decode_fns(models, cpu_default):
    """A port `GPT` (blocks always a Python loop, indexed names) loaded
    from the scan-stacked JAX gpt_tiny's weights: `param_arrays` carries
    exactly the names `split_decode_params` reads, and prefill + steps
    reproduce that GPT's own full forward, token by token."""
    cfg, arrays = models["tiny-scan"]
    assert "blocks.attn.qkv.weight" in arrays          # JAX: stacked
    pcfg = tgpt.GPTConfig(**dataclasses.asdict(cfg))
    model = tgpt.GPT(pcfg).load_numpy(arrays)
    model.eval()
    params = tframework.param_arrays(model)
    assert set(params) == set(tgpt.param_shapes(pcfg))  # port: indexed
    assert tframework.state_arrays(model) == {}
    assert all(not p.requires_grad for p in params.values())
    eps = model.ln_f._epsilon
    prefill, step = tgpt.gpt_decode_fns(pcfg, eps=eps)
    rng = np.random.RandomState(3)
    plen = 9
    toks = [int(t) for t in rng.randint(0, cfg.vocab_size, plen)]
    padded = torch.zeros((1, 32), dtype=torch.long)
    padded[0, :plen] = torch.tensor(toks)
    logits, k, v = prefill(params, padded, torch.tensor([plen]))

    def full(seq):
        with torch.no_grad():
            return model(torch.tensor([seq]))[0, -1].numpy()

    np.testing.assert_allclose(logits[0].numpy(), full(toks), atol=SELF_TOL)
    for _ in range(STEPS):
        last = int(logits[0].argmax())
        toks.append(last)
        logits, k, v = step(params, k, v, torch.tensor([last]),
                            torch.tensor([len(toks) - 1]))
        np.testing.assert_allclose(logits[0].numpy(), full(toks),
                                   atol=SELF_TOL)
    # a frozen parameter moves from param_arrays to state_arrays
    model.ln_f.weight.requires_grad_(False)
    assert "ln_f.weight" not in tframework.param_arrays(model)
    assert set(tframework.state_arrays(model)) == {"ln_f.weight"}
