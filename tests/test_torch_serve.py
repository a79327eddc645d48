"""paddle_tpu_torch decode server, driven by the JAX package's client.

The port's `InferenceServer(decode=True, device="cpu")` serves a JAX
`save_for_decode` artifact; the JAX package's `serve.decode_request`
talks to it over PDI2 (per-token frames, then a done frame) and PDI1 (one
accumulated frame) and must get the tokens the port's in-process engine
gives for the same prompts. Requests run one at a time on both sides, so
both engines compute every step at the same batch shape and agree
exactly.
"""
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.inference import decode as jdecode  # noqa: E402
from paddle_tpu.inference import serve as jserve  # noqa: E402
from paddle_tpu.models.gpt import GPT, gpt_tiny  # noqa: E402
from paddle_tpu_torch.inference import decode as tdecode  # noqa: E402
from paddle_tpu_torch.inference import serve as tserve  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    paddle.seed(11)
    prefix = str(tmp_path_factory.mktemp("art") / "gpt")
    jdecode.save_for_decode(GPT(gpt_tiny()), prefix)
    return prefix


def _connect(port):
    return socket.create_connection(("127.0.0.1", port), timeout=120)


def test_jax_client_gets_the_engines_tokens(artifact, monkeypatch):
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in (5, 9)]
    eng = tdecode.load_for_decode(artifact, device="cpu", max_slots=2,
                                  page_tokens=4)
    try:
        ref6 = [eng.submit(p, max_new_tokens=6).result(timeout=120)
                for p in prompts]
        ref4 = [eng.submit(p, max_new_tokens=4).result(timeout=120)
                for p in prompts]
    finally:
        eng.stop()
    monkeypatch.setenv("PADDLE_TPU_DECODE_PAGE_TOKENS", "4")
    srv = tserve.InferenceServer(artifact, port=0, decode=True,
                                 decode_slots=2, decode_max_new=4,
                                 device="cpu")
    try:
        assert srv.engine.page_tokens == 4
        for p, want6, want4 in zip(prompts, ref6, ref4):
            frames = []
            with _connect(srv.port) as s:         # PDI2: streamed
                got = jserve.decode_request(
                    s, p, opts={"max_new_tokens": 6, "temperature": 0.0},
                    on_token=lambda tok, st: frames.append((tok, st)))
                assert got == want6
                assert [t for t, _ in frames] == want6
                assert [st["seq"] for _, st in frames] == list(range(6))
                # same keep-alive connection, legacy PDI1: server default
                assert jserve.decode_request(s, p, trace=False) == want4
            with _connect(srv.port) as s:         # the port's own client
                assert tserve.decode_request(s, p, trace=False) == want4
        # a typed error frame, and the connection stays usable
        with _connect(srv.port) as s:
            with pytest.raises(jserve.TypedServeError) as ei:
                jserve.decode_request(s, np.asarray([600], np.int32))
            assert ei.value.code == "INVALID_ARGUMENT"
            assert jserve.decode_request(s, prompts[0],
                                         trace=False) == ref4[0]
        # a malformed frame gets an INVALID_ARGUMENT frame, then EOF
        with _connect(srv.port) as s:
            s.sendall(b"JUNKJUNK")
            arrays, err = jserve.read_reply(s)
            assert arrays is None and err.startswith("INVALID_ARGUMENT")
    finally:
        assert srv.drain(timeout=30)


def test_drain_joins_every_server_thread(artifact, monkeypatch):
    """After drain() no thread the server started is left: not the accept
    loop, not the scheduler, not a connection thread blocked reading an
    idle keep-alive socket or a socket that never sent a frame. (A daemon
    thread left running at interpreter exit could abort the daemon.)"""
    monkeypatch.setenv("PADDLE_TPU_DECODE_PAGE_TOKENS", "4")
    before = set(threading.enumerate())
    srv = tserve.InferenceServer(artifact, port=0, decode=True,
                                 decode_slots=1, decode_max_new=2,
                                 device="cpu")
    served, idle = _connect(srv.port), _connect(srv.port)
    try:
        assert len(tserve.decode_request(
            served, np.asarray([1, 2, 3], np.int32), trace=False)) == 2
        deadline = time.monotonic() + 30
        while len(srv._conns) < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert len(srv._conns) == 2
        assert srv.drain(timeout=30)
        assert srv._conns == {}
        left = [t for t in threading.enumerate()
                if t not in before and t.is_alive()]
        assert left == [], left
    finally:
        served.close()
        idle.close()
        srv.stop()


def test_stop_raises_on_a_thread_that_outlives_its_join(artifact,
                                                        monkeypatch):
    """A connection thread still running after its join makes stop() raise
    and name it, so a thread left to abort the interpreter's exit is seen."""
    monkeypatch.setattr(tserve, "_JOIN_TIMEOUT_S", 0.05)
    srv = tserve.InferenceServer(artifact, port=0, decode=True,
                                 decode_slots=1, decode_max_new=2,
                                 device="cpu")
    release = threading.Event()
    stuck = threading.Thread(target=release.wait, name="stuck-conn",
                             daemon=True)
    a, b = socket.socketpair()
    stuck.start()
    srv._conns[stuck] = a
    try:
        with pytest.raises(RuntimeError, match="stuck-conn"):
            srv.stop()
    finally:
        release.set()
        stuck.join(30)
        a.close()
        b.close()
    srv.stop()          # nothing left running: quiet


def test_wire_frames_are_byte_identical():
    """The port's framing emits exactly the JAX package's bytes."""
    class Sink:
        def __init__(self):
            self.buf = b""

        def sendall(self, b):
            self.buf += bytes(b)

    arrays = [np.arange(6, dtype=np.int32).reshape(2, 3),
              np.linspace(0, 1, 70000, dtype=np.float32),
              np.asarray([True, False])]
    for ctx in (None, {"trace_id": "t", "stream": {"seq": 1}}):
        a, b = Sink(), Sink()
        jserve.write_tensors(a, arrays, ctx=ctx)
        tserve.write_tensors(b, arrays, ctx=ctx)
        assert a.buf == b.buf
        a, b = Sink(), Sink()
        jserve.write_error(a, "UNAVAILABLE: x", ctx=ctx)
        tserve.write_error(b, "UNAVAILABLE: x", ctx=ctx)
        assert a.buf == b.buf


def test_daemon_main_serves_and_drains_on_sigterm(artifact):
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.inference.serve", artifact,
         "--decode", "--decode-slots", "2", "--decode-max-new", "3",
         "--port", "0", "--device", "cpu", "--warmup"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        lines = []
        for line in proc.stdout:
            lines.append(line.strip())
            if line.startswith("SERVING "):
                break
        assert lines and lines[-1].startswith("SERVING "), lines
        assert any(ln.startswith("DECODE WARMUP") for ln in lines), lines
        port = int(lines[-1].split()[1])
        with _connect(port) as s:
            assert len(jserve.decode_request(s, [1, 2, 3],
                                             trace=False)) == 3
        proc.send_signal(signal.SIGTERM)
        rest = proc.communicate(timeout=60)[0]
        assert "DRAINED ok=True" in rest, rest
        assert proc.returncode == 0
        # on the CPU the plain version serves: the prefill gave the first
        # of the 3 tokens and two decode steps the rest; no kernel launched
        stats = [ln for ln in rest.splitlines()
                 if ln.startswith("DECODE STATS ")]
        assert len(stats) == 1, rest
        kv = dict(f.split("=", 1) for f in stats[0].split()[2:])
        assert kv["device"] == "cpu" and kv["steps"] == "2", kv
        assert kv["tokens"] == "3", kv
        assert int(kv["paged_decode_attention_launches"]) == 0, kv
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
