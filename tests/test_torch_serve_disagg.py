"""The prefill/decode KV handoff of paddle_tpu_torch against the JAX
package's, in process and over the wire.

  * `serialize_pages` gives the JAX package's bytes, metadata and crc32s
    for the same pages (fp32 and int8 leaves); a flipped byte or a
    missing leaf is refused;
  * `kv_fingerprint` is equal across the packages for the same weights
    (stacked and per-block JAX layouts, and int8 weights) and tracks the
    model;
  * engine handoff on the CPU: export on one port engine, import on
    another, and the decode stream equals the JAX unified engine's
    (greedy, seeded, speculative, and a zero-page prompt), admitted as a
    prefix hit; every compat and integrity refusal is a typed
    FAILED_PRECONDITION, and so is a handoff to an engine with it off;
  * across the packages: a JAX engine's `export_kv` lands in a port
    engine's `import_kv` and the other way round;
  * over the wire: a port `InferenceServer` pair (roles prefill and
    decode) serves kv_export, kv_handoff and the stream, driven by the JAX
    package's frame helpers; the daemon's `--role` and `--host-pages`.

The router tests of tests/test_serve_disagg.py wait for the port's
router.
"""
import dataclasses
import json
import os
import signal
import socket
import subprocess
import sys
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu import framework  # noqa: E402
from paddle_tpu.inference import decode as jdecode  # noqa: E402
from paddle_tpu.inference import serve as jserve  # noqa: E402
from paddle_tpu.memory import migration as jmigration  # noqa: E402
from paddle_tpu.models.gpt import GPT, GPTConfig as JGPTConfig  # noqa: E402
from paddle_tpu.models.gpt import gpt_tiny  # noqa: E402
from paddle_tpu.quant.ptq import quantize_params as jquantize  # noqa: E402
from paddle_tpu_torch.inference import decode as tdecode  # noqa: E402
from paddle_tpu_torch.inference import serve as tserve  # noqa: E402
from paddle_tpu_torch.inference.errors import (  # noqa: E402
    ERR_FAILED_PRECONDITION, TypedServeError)
from paddle_tpu_torch.memory import migration as tmigration  # noqa: E402
from paddle_tpu_torch.models.gpt import (  # noqa: E402
    GPTConfig, params_from_numpy)

MAX_NEW = 8
TIMEOUT = 120
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DRAFT = JGPTConfig(vocab_size=512, max_seq_len=128, hidden=32, layers=1,
                   heads=2, scan_layers=False)


def _arrays(model):
    return {k: np.asarray(v)
            for k, v in framework.param_arrays(model).items()}


@pytest.fixture(scope="module")
def rig(tmp_path_factory):
    """gpt_tiny + the draft as numpy, a JAX decode artifact of gpt_tiny,
    and the JAX unified engine's streams as the oracle."""
    paddle.seed(7)
    model = GPT(gpt_tiny())
    draft = GPT(DRAFT)
    prefix = str(tmp_path_factory.mktemp("disagg") / "gpt")
    jdecode.save_for_decode(model, prefix)
    eng = jdecode.DecodeEngine(model, max_slots=4, max_new_tokens=32)
    refs = {}

    def ref(prompt, max_new=MAX_NEW, **opts):
        key = (tuple(prompt), max_new, tuple(sorted(opts.items())))
        if key not in refs:
            refs[key] = eng.submit(prompt, max_new_tokens=max_new,
                                   **opts).result(timeout=TIMEOUT)
        return refs[key]
    yield {"model": model, "cfg": model.cfg, "arrays": _arrays(model),
           "dcfg": draft.cfg, "darrays": _arrays(draft),
           "prefix": prefix, "ref": ref}
    eng.stop()


def _prompt(seed, size):
    return [int(t) for t in
            np.random.RandomState(seed).randint(0, 512, size=size)]


def _tcfg(jcfg):
    return GPTConfig(**dataclasses.asdict(jcfg))


def _port(rig, spec=False, **kw):
    cfg = _tcfg(rig["cfg"])
    params = params_from_numpy(cfg, rig["arrays"], "cpu")
    kw.setdefault("max_slots", 4)
    kw.setdefault("max_new_tokens", MAX_NEW)
    if not spec:
        return tdecode.DecodeEngine(cfg=cfg, params=params, eps=1e-5,
                                    device="cpu", **kw)
    dcfg = _tcfg(rig["dcfg"])
    return tdecode.SpecDecodeEngine(
        cfg=cfg, params=params, eps=1e-5, draft_cfg=dcfg,
        draft_params=params_from_numpy(dcfg, rig["darrays"], "cpu"),
        draft_eps=1e-5, device="cpu", **kw)


# ------------------------------------------------ serialization units

def test_serialize_pages_byte_equal_across_packages():
    """The same pages (an fp32 leaf, an int8 pool pair) serialize to the
    same bytes, metadata and checksums in both packages; each package
    reads the other's payload, and a corrupt or short one is refused."""
    rng = np.random.RandomState(0)
    f = rng.randn(2, 3, 4, 2, 4).astype(np.float32)
    q = rng.randint(-128, 127, size=(2, 3, 4, 2, 4), dtype=np.int8)
    s = rng.rand(2, 3, 4, 2).astype(np.float32)
    jarrays, jmeta = jmigration.serialize_pages((f, (q, s)), 2)
    tarrays, tmeta = tmigration.serialize_pages(
        (torch.from_numpy(f), (torch.from_numpy(q), torch.from_numpy(s))),
        2)
    assert tmeta == jmeta and len(tmeta["crcs"]) == 2
    assert [a.dtype for a in tarrays] == [np.float32, np.uint8, np.float32]
    for a, b in zip(tarrays, jarrays):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    for leaves in (tmigration.deserialize_pages(jarrays, jmeta),
                   jmigration.deserialize_pages(tarrays, tmeta)):
        np.testing.assert_array_equal(leaves[0], f[:, :2])
        assert leaves[1].dtype == np.int8
        np.testing.assert_array_equal(leaves[1], q[:, :2])
    bad = [a.copy() for a in tarrays]
    bad[1].reshape(-1)[5] ^= 0xFF
    with pytest.raises(ValueError, match="checksum"):
        tmigration.deserialize_pages(bad, tmeta)
    with pytest.raises(ValueError, match="structure"):
        tmigration.deserialize_pages(tarrays[:2], tmeta)


def test_fingerprint_equal_across_packages_and_tracks_model(rig):
    """A port engine and a JAX engine over the same weights carry the same
    fingerprint — stacked (gpt_tiny), per-block (the draft, scan_layers
    False) and int8 weights — and a different model changes it."""
    cfg, arrays = rig["cfg"], rig["arrays"]
    tcfg = _tcfg(cfg)
    tparams = params_from_numpy(tcfg, arrays, "cpu")
    jfp = jdecode.kv_fingerprint(cfg, 1e-5, arrays)
    assert tdecode.kv_fingerprint(tcfg, 1e-5, tparams) == jfp
    dcfg, darrays = rig["dcfg"], rig["darrays"]
    tdcfg = _tcfg(dcfg)
    dfp = tdecode.kv_fingerprint(
        tdcfg, 1e-5, params_from_numpy(tdcfg, darrays, "cpu"))
    assert dfp == jdecode.kv_fingerprint(dcfg, 1e-5, darrays) != jfp
    qarrays = jquantize(arrays)
    qfp = tdecode.kv_fingerprint(
        tcfg, 1e-5, params_from_numpy(tcfg, qarrays, "cpu"))
    assert qfp == jdecode.kv_fingerprint(cfg, 1e-5, qarrays) != jfp
    assert tdecode.kv_fingerprint(tcfg, 1e-6, tparams) != jfp
    eng = _port(rig)
    jeng = jdecode.DecodeEngine(rig["model"], max_slots=1)
    try:
        assert eng.fingerprint == jeng.fingerprint == jfp
        assert eng.kv_compat() == jeng.kv_compat()
    finally:
        eng.stop()
        jeng.stop()


# ----------------------------------------- in-process engine handoff

def _handoff(pre, dec, prompt, **opts):
    payload = pre.export_kv(prompt)
    assert payload["n_pages"] == len(prompt) // pre.page_tokens
    assert dec.import_kv(payload) == payload["n_pages"]
    return payload, dec.submit(prompt, max_new_tokens=MAX_NEW,
                               **opts).result(timeout=TIMEOUT)


def test_engine_handoff_equals_jax_unified(rig):
    """Export on one port engine, import on another: the decode stream
    equals the JAX unified engine's for greedy and seeded sampling, it
    admits as a prefix hit over the imported pages (no prefill on the
    decode side), and a re-export is a pure gather with the same
    checksums."""
    pre, dec = _port(rig, handoff=True), _port(rig, handoff=True)
    try:
        for prompt, opts in ((_prompt(3, 37), {}),
                             (_prompt(4, 21),
                              {"temperature": 0.8, "seed": 42})):
            payload, got = _handoff(pre, dec, prompt, **opts)
            assert got == rig["ref"](prompt, **opts)
        st = dec.stats()
        assert st["prefills"] == 0
        assert st["prefix_cache"]["hits"] == 2
        assert st["prefix_cache"]["hit_tokens"] == (2 + 1) * 16
        assert pre.stats()["handoff"]["exports"] == 2
        assert st["handoff"]["imports"] == 2
        p0 = pre.stats()["prefills"]
        assert pre.export_kv(_prompt(3, 37))["crcs"] == \
            pre.export_kv(_prompt(3, 37))["crcs"]
        assert pre.stats()["prefills"] == p0       # trie hits, no prefill
    finally:
        pre.stop()
        dec.stop()


def test_engine_handoff_speculative_and_zero_page(rig):
    """A speculative pair hands off all four pools of each page and the
    stream equals the unified one; a sub-page prompt exports no page and
    the decode side's plain prefill still matches."""
    kw = dict(speculate_k=4, max_slots=2, max_new_tokens=24, page_tokens=4)
    prompt = _prompt(11, 19)
    pre, dec = _port(rig, True, handoff=True, **kw), \
        _port(rig, True, handoff=True, **kw)
    try:
        payload = pre.export_kv(prompt)
        assert len(payload["arrays"]) == 4
        assert dec.import_kv(payload) == len(prompt) // 4
        got = dec.submit(prompt, max_new_tokens=12).result(timeout=TIMEOUT)
        assert got == rig["ref"](prompt, max_new=12)
    finally:
        pre.stop()
        dec.stop()
    pre, dec = _port(rig, handoff=True), _port(rig, handoff=True)
    try:
        prompt = _prompt(6, 7)
        payload = pre.export_kv(prompt)
        assert payload["n_pages"] == 0 and payload["arrays"] == []
        assert dec.import_kv(payload) == 0
        assert dec.submit(prompt, max_new_tokens=MAX_NEW) \
            .result(timeout=TIMEOUT) == rig["ref"](prompt)
    finally:
        pre.stop()
        dec.stop()


def test_engine_handoff_compat_and_integrity_rejects(rig):
    """Every refusal is a typed FAILED_PRECONDITION, counted: page size,
    pool dtype and fingerprint mismatches, a corrupt payload, and a
    speculative payload landing in a plain engine; a good payload still
    lands afterwards. An engine with the handoff off refuses both
    halves."""
    pre, dec = _port(rig, handoff=True), _port(rig, handoff=True)
    others = [_port(rig, handoff=True, page_tokens=8),
              _port(rig, handoff=True, kv_dtype="int8"),
              _port(rig, True, handoff=True, speculate_k=2, max_slots=2)]
    off = _port(rig, max_slots=2)
    try:
        prompt = _prompt(9, 33)
        payload = pre.export_kv(prompt)
        with pytest.raises(TypedServeError,
                           match="page_tokens mismatch") as ei:
            others[0].import_kv(payload)
        assert ei.value.code == ERR_FAILED_PRECONDITION
        with pytest.raises(TypedServeError, match="kv_dtype mismatch"):
            others[1].import_kv(payload)
        with pytest.raises(TypedServeError, match="fingerprint"):
            dec.import_kv(dict(payload, fingerprint="0" * 16))
        corrupt = dict(payload, arrays=[a.copy()
                                        for a in payload["arrays"]])
        corrupt["arrays"][0].view(np.uint8).reshape(-1)[0] ^= 0xFF
        with pytest.raises(TypedServeError, match="checksum"):
            dec.import_kv(corrupt)
        with pytest.raises(TypedServeError, match="structure"):
            dec.import_kv(others[2].export_kv(prompt))
        st = dec.stats()["handoff"]
        assert st["rejects"] == 3 and st["imports"] == 0
        assert dec.import_kv(payload) == payload["n_pages"]
        for call in (lambda: off.export_kv(prompt),
                     lambda: off.import_kv(payload)):
            with pytest.raises(TypedServeError, match="disabled") as ei:
                call()
            assert ei.value.code == ERR_FAILED_PRECONDITION
    finally:
        for e in [pre, dec, off] + others:
            e.stop()


def test_handoff_crosses_between_the_packages(rig):
    """A JAX engine's export lands in a port engine and a port engine's
    export lands in a JAX engine; each follow-up stream admits as a prefix
    hit and equals the JAX unified stream."""
    jpre = jdecode.DecodeEngine(rig["model"], max_slots=2,
                                max_new_tokens=MAX_NEW, handoff=True)
    jdec = jdecode.DecodeEngine(rig["model"], max_slots=2,
                                max_new_tokens=MAX_NEW, handoff=True)
    tpre, tdec = _port(rig, handoff=True), _port(rig, handoff=True)
    try:
        p1, p2 = _prompt(21, 40), _prompt(22, 35)
        payload, got = _handoff(jpre, tdec, p1)
        assert got == rig["ref"](p1)
        assert tdec.stats()["prefix_cache"]["hit_tokens"] == 2 * 16
        assert tdec.stats()["prefills"] == 0
        tpayload, got = _handoff(tpre, jdec, p2)
        assert got == rig["ref"](p2)
        assert jdec.stats()["handoff"]["imports"] == 1
        assert payload["fingerprint"] == tpayload["fingerprint"]
    finally:
        for e in (jpre, jdec, tpre, tdec):
            e.stop()


# ---------------------------------------------------- over the wire

def _connect(port):
    return socket.create_connection(("127.0.0.1", port), timeout=TIMEOUT)


def test_server_pair_serves_the_handoff_over_the_wire(rig):
    """A prefill-role and a decode-role port server: kv_export to the
    first, kv_handoff of its reply to the second, then the stream on the
    same connection — all through the JAX package's frame helpers — and
    the stream equals the JAX unified one, over the imported pages. A
    unified server refuses a kv_handoff with a typed error frame and the
    connection stays usable."""
    srvs = [tserve.InferenceServer(rig["prefix"], port=0, decode=True,
                                   decode_slots=2, decode_max_new=MAX_NEW,
                                   device="cpu", role=role)
            for role in ("prefill", "decode", "unified")]
    pre, dec, uni = srvs
    try:
        assert [s.role for s in srvs] == ["prefill", "decode", "unified"]
        assert pre.engine.handoff and dec.engine.handoff
        assert not uni.engine.handoff
        assert dec._status()["role"] == "decode"
        prompt = _prompt(31, 45)
        with _connect(pre.port) as s:
            jserve.write_tensors(s, [np.asarray(prompt, np.int32)],
                                 ctx={"trace_id": "t1", "kv_export": {}})
            arrays, err, rctx = jserve.read_reply_ctx(s)
        assert err is None and rctx["trace_id"] == "t1"
        meta = rctx["kv_export"]
        assert meta["n_pages"] == 2 and len(arrays) == 2
        with _connect(dec.port) as s:
            jserve.write_tensors(s, arrays,
                                 ctx={"trace_id": "t1", "kv_handoff": meta})
            ack, err, actx = jserve.read_reply_ctx(s)
            assert err is None and actx["kv_handoff"] == {"landed": 2}
            assert int(ack[0][0]) == 2
            got = jserve.decode_request(
                s, prompt, opts={"max_new_tokens": MAX_NEW,
                                 "tenant": "alpha", "priority": 1})
        assert got == rig["ref"](prompt)
        st = dec.engine.stats()
        assert st["prefills"] == 0 and st["tenant_admissions"] == \
            {"alpha": 1}
        assert st["prefix_cache"]["hit_tokens"] == 2 * 16
        with _connect(uni.port) as s:
            jserve.write_tensors(s, arrays,
                                 ctx={"trace_id": "t2", "kv_handoff": meta})
            _, err, _ = jserve.read_reply_ctx(s)
            assert err.startswith(ERR_FAILED_PRECONDITION) \
                and "disabled" in err
            assert jserve.decode_request(s, prompt) == rig["ref"](prompt)
    finally:
        for s in srvs:
            s.stop()


def test_daemon_role_and_host_pages_flags(rig):
    """`serve --role decode --host-pages 8`: /statusz reports the role and
    a host tier of 8 pages, a kv_handoff lands, and the drain's stats line
    names the role."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.inference.serve",
         rig["prefix"], "--decode", "--decode-slots", "2",
         "--decode-max-new", "3", "--port", "0", "--metrics-port", "0",
         "--device", "cpu", "--role", "decode", "--host-pages", "8"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        ports = {}
        for line in proc.stdout:
            if line.startswith(("METRICS ", "SERVING ")):
                ports[line.split()[0]] = int(line.split()[1])
            if "SERVING" in ports:
                break
        assert set(ports) == {"METRICS", "SERVING"}, ports
        with urllib.request.urlopen(
                f"http://127.0.0.1:{ports['METRICS']}/statusz",
                timeout=TIMEOUT) as r:
            status = json.loads(r.read())
        assert status["role"] == "decode"
        assert status["decode"]["kv_tier"]["host_pages_total"] == 8
        pre = _port(rig, handoff=True)
        try:
            payload = pre.export_kv(_prompt(41, 20))
        finally:
            pre.stop()
        with _connect(ports["SERVING"]) as s:
            meta = {k: v for k, v in payload.items() if k != "arrays"}
            jserve.write_tensors(s, payload["arrays"],
                                 ctx={"trace_id": "t", "kv_handoff": meta})
            _, err, actx = jserve.read_reply_ctx(s)
            assert err is None and actx["kv_handoff"] == {"landed": 1}
        proc.send_signal(signal.SIGTERM)
        rest = proc.communicate(timeout=TIMEOUT)[0]
        assert "DRAINED ok=True" in rest and proc.returncode == 0, rest
        assert "role=decode" in rest, rest
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
