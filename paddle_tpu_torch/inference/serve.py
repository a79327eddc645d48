"""Decode serve daemon: a TCP front-end over the paged DecodeEngine.

Port of the decode mode of paddle_tpu's `inference/serve.py`, speaking
the same wire protocol byte for byte (little endian, one request per
round trip):

  request : u32 magic 'PDI1' | u32 n_tensors | tensors
  tensor  : u8 dtype | u8 ndim | i64 shape[ndim] | raw data
  reply   : u32 magic | u32 n_tensors | tensors     (or n=0xFFFFFFFF +
            u32 len + utf8 error message)

dtype codes: 0 f32, 1 f64, 2 i32, 3 i64, 4 u8, 5 bool. A 'PDI2' frame
carries a JSON context between the header and the payload
(``u32 ctx_len | ctx JSON``); a PDI2 decode request has its sampling
options in ``ctx["decode"]`` and gets one frame per sampled token
(``{"stream": {"seq", "eos", "done": false}}``) then a final frame with
the whole sequence (``{"stream": {"done": true, "n_tokens"}}``). A PDI1
request gets exactly one frame with the accumulated tokens.

    python -m paddle_tpu_torch.inference.serve <prefix> --decode --port 9000

    python -m paddle_tpu_torch.inference.serve <int8 prefix> --decode \
        --kv-dtype int8          # int8 weights (save_for_decode(quant=
                                 # "int8")) and int8 KV pages

    python -m paddle_tpu_torch.inference.serve <target> --decode \
        --draft-model <draft> --speculate-k 4 [--draft-quant] \
        --metrics-port 0         # speculative decoding + the admin plane

With ``--metrics-port`` (or PADDLE_TPU_METRICS_PORT; 0 = an ephemeral
port) the daemon mounts `observability.AdminServer` (``/metrics``,
``/healthz``, ``/statusz``) and prints ``METRICS <port>`` first. It prints
``SERVING <port>`` once it listens, and on SIGTERM drains (answers every
request in flight), prints ``DECODE STATS device=... kv_dtype=...
steps=N prefills=N tokens=N`` (a speculative engine adds
``spec_drafted=N spec_accepted=N spec_rollback_released=N
spec_draft_steps=N spec_draft_prefills=N``) and the kernel launches
counted since ``SERVING`` (``paged_decode_attention_launches=N
paged_decode_attention_int8_launches=N int8_weight_matmul_launches=N``,
so a run can show the kernels served its requests), then ``DRAINED
ok=<bool>``, and exits 0. The one-shot (non-decode) predictor mode, the
router, the admin plane's other endpoints and KV handoff are later
slices of the port.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import socket
import struct
import threading
import time

import numpy as np

from ..core import flags as _flags
from ..utils.net import recv_exact
from .errors import (ERR_INTERNAL, ERR_INVALID_ARGUMENT, TypedServeError,
                     error_code)

MAGIC = 0x31494450          # 'PDI1'
MAGIC_TRACE = 0x32494450    # 'PDI2': header is followed by a trace ctx
ERR = 0xFFFFFFFF
_DTYPES = [np.float32, np.float64, np.int32, np.int64, np.uint8, np.bool_]
_MAX_TENSORS = 256          # a request claiming more is malformed
_MAX_NDIM = 32
_MAX_CTX_BYTES = 1 << 16    # trace-context JSON cap
_SEND_COPY_MAX = 1 << 16    # payloads above this go out via memoryview
_JOIN_TIMEOUT_S = 30.0      # stop(): how long each server thread may take


def _recv_exact(sock, n):
    return recv_exact(sock, n, what="client")


def max_request_bytes() -> int:
    """Per-request payload budget (``PADDLE_TPU_MAX_REQUEST_BYTES``)."""
    return int(_flags.env_value("PADDLE_TPU_MAX_REQUEST_BYTES"))


def _encode_ctx(ctx: dict) -> bytes:
    raw = json.dumps(ctx, separators=(",", ":")).encode("utf-8")
    if len(raw) > _MAX_CTX_BYTES:
        # oversize context degrades to the trace id alone rather than
        # failing the frame
        raw = json.dumps({"trace_id": ctx.get("trace_id")},
                         separators=(",", ":")).encode("utf-8")
    return struct.pack("<I", len(raw)) + raw


def _read_ctx(sock) -> dict:
    (clen,) = struct.unpack("<I", _recv_exact(sock, 4))
    if clen > _MAX_CTX_BYTES:
        raise ValueError(f"trace context claims {clen} bytes "
                         f"(cap {_MAX_CTX_BYTES})")
    raw = _recv_exact(sock, clen)
    try:
        ctx = json.loads(raw.decode("utf-8"))
    except (ValueError, UnicodeDecodeError):
        return {}               # garbage context must not fail the frame
    return ctx if isinstance(ctx, dict) else {}


def _read_tensor_list(sock, n, max_bytes, what):
    """The per-tensor loop: validates every size field BEFORE allocating
    or recv-ing — dtype code and ndim in range, no negative dims, and the
    total payload capped by PADDLE_TPU_MAX_REQUEST_BYTES."""
    out, total = [], 0
    for _ in range(n):
        dt, nd = struct.unpack("<BB", _recv_exact(sock, 2))
        if dt >= len(_DTYPES):
            raise IndexError(f"bad dtype code {dt}")
        if nd > _MAX_NDIM:
            raise ValueError(f"tensor ndim {nd} exceeds cap {_MAX_NDIM}")
        shape = struct.unpack(f"<{nd}q", _recv_exact(sock, 8 * nd)) \
            if nd else ()
        if any(d < 0 for d in shape):
            raise ValueError(f"negative dim in shape {shape}")
        dtype = np.dtype(_DTYPES[dt])
        count = 1
        for d in shape:          # python ints: no int64 overflow
            count *= d
        nbytes = count * dtype.itemsize
        total += nbytes
        if total > max_bytes:
            raise ValueError(
                f"{what} exceeds PADDLE_TPU_MAX_REQUEST_BYTES="
                f"{max_bytes} ({total} bytes claimed)")
        data = _recv_exact(sock, nbytes)
        out.append(np.frombuffer(data, dtype, count).reshape(shape).copy())
    return out


def read_request(sock, max_bytes=None):
    """Decode one request frame -> ``(arrays, ctx)``. ``ctx`` is the
    context dict of a 'PDI2' frame, ``None`` for a legacy 'PDI1' frame."""
    if max_bytes is None:
        max_bytes = max_request_bytes()
    magic, n = struct.unpack("<II", _recv_exact(sock, 8))
    if magic not in (MAGIC, MAGIC_TRACE):
        raise ValueError("bad magic")
    ctx = _read_ctx(sock) if magic == MAGIC_TRACE else None
    if n > _MAX_TENSORS:
        raise ValueError(f"request claims {n} tensors "
                         f"(cap {_MAX_TENSORS})")
    return _read_tensor_list(sock, n, max_bytes, "request"), ctx


def write_tensors(sock, arrays, ctx=None):
    """Encode one frame. Small tensors are coalesced into one send; large
    payloads go out as a `memoryview` of the array. A ``ctx`` dict makes
    the frame 'PDI2' with the JSON context after the header — only send
    one to a peer known to speak it."""
    if ctx is None:
        small = [struct.pack("<II", MAGIC, len(arrays))]
    else:
        small = [struct.pack("<II", MAGIC_TRACE, len(arrays)),
                 _encode_ctx(ctx)]
    for a in arrays:
        a = np.ascontiguousarray(a)
        if a.dtype not in [np.dtype(d) for d in _DTYPES]:
            if np.issubdtype(a.dtype, np.floating):
                a = a.astype(np.float32)   # f16 outputs -> f32 wire
            else:
                raise ValueError(
                    f"unsupported output dtype {a.dtype} on the wire "
                    f"(supported: {[np.dtype(d).name for d in _DTYPES]})")
        dt = next(i for i, d in enumerate(_DTYPES) if np.dtype(d) == a.dtype)
        small.append(struct.pack("<BB", dt, a.ndim))
        small.append(struct.pack(f"<{a.ndim}q", *a.shape))
        if a.nbytes > _SEND_COPY_MAX:
            sock.sendall(b"".join(small))
            small = []
            sock.sendall(memoryview(a).cast("B"))
        else:
            small.append(a.tobytes())
    if small:
        sock.sendall(b"".join(small))


def write_error(sock, msg: str, ctx=None):
    m = msg.encode()[:65536]
    if ctx is None:
        sock.sendall(struct.pack("<III", MAGIC, ERR, len(m)) + m)
    else:
        sock.sendall(struct.pack("<II", MAGIC_TRACE, ERR)
                     + _encode_ctx(ctx)
                     + struct.pack("<I", len(m)) + m)


def read_reply_ctx(sock, max_bytes=None):
    """Decode one REPLY frame -> ``(arrays, errmsg, ctx)``: a tensor
    reply is ``(arrays, None, ctx)``, an error frame ``(None, message,
    ctx)``; ``ctx`` is ``None`` unless the peer sent a 'PDI2' frame."""
    if max_bytes is None:
        max_bytes = max_request_bytes()
    magic, n = struct.unpack("<II", _recv_exact(sock, 8))
    if magic not in (MAGIC, MAGIC_TRACE):
        raise ValueError("bad magic in reply")
    ctx = _read_ctx(sock) if magic == MAGIC_TRACE else None
    if n == ERR:
        (mlen,) = struct.unpack("<I", _recv_exact(sock, 4))
        if mlen > 65536:
            raise ValueError(f"error frame claims {mlen} bytes")
        return None, _recv_exact(sock, mlen).decode("utf-8", "replace"), ctx
    if n > _MAX_TENSORS:
        raise ValueError(f"reply claims {n} tensors (cap {_MAX_TENSORS})")
    return _read_tensor_list(sock, n, max_bytes, "reply"), None, ctx


def read_reply(sock, max_bytes=None):
    """Decode one REPLY frame: ``(arrays, None)`` for a tensor reply,
    ``(None, message)`` for an error frame."""
    arrays, err, _ = read_reply_ctx(sock, max_bytes)
    return arrays, err


def decode_request(sock, prompt, opts=None, trace=True,
                   on_token=None, max_bytes=None):
    """Client half of the decode wire exchange on an open socket.

    Sends the prompt (int32 [T]); with ``trace=True`` the request is a
    'PDI2' frame (``opts`` rides in its ``decode`` context field) and the
    server streams per-token frames — ``on_token(tok, stream_ctx)`` fires
    for each — before the final accumulated frame. ``trace=False`` sends
    legacy 'PDI1' and blocks for the single accumulated reply. Returns
    the generated tokens as a list; raises TypedServeError on a typed
    error frame, carrying the tokens already received as
    ``.partial_tokens`` plus ``.last_seq``."""
    arr = np.asarray(prompt, np.int32).reshape(-1)
    ctx = None
    if trace:
        ctx = {"trace_id": f"decode-{os.getpid()}-{id(arr):x}",
               "decode": dict(opts or {})}
    write_tensors(sock, [arr], ctx=ctx)
    by_seq = {}
    while True:
        arrays, err, rctx = read_reply_ctx(sock, max_bytes)
        if err is not None:
            code = error_code(err)
            detail = err.split(":", 1)[1].strip() if code else err
            exc = TypedServeError(code or ERR_INTERNAL, detail)
            exc.partial_tokens = [t for _, t in sorted(by_seq.items())]
            exc.last_seq = max(by_seq) if by_seq else -1
            raise exc
        stream = (rctx or {}).get("stream") or {}
        if not trace or stream.get("done"):
            return [int(t) for t in np.asarray(arrays[0]).reshape(-1)]
        tok = int(np.asarray(arrays[0]).reshape(-1)[0])
        seq = int(stream.get("seq", len(by_seq)))
        if seq in by_seq:
            continue                 # duplicate frame: already surfaced
        by_seq[seq] = tok
        if on_token is not None:
            on_token(tok, stream)


class InferenceServer:
    """Serves one `save_for_decode` artifact over TCP through a
    `DecodeEngine` on `device` (default cuda). Loopback by default: the
    daemon is unauthenticated."""

    def __init__(self, model_prefix: str, port: int = 0,
                 host: str = "127.0.0.1", decode: bool = True,
                 decode_slots: int = None, decode_max_new: int = None,
                 warmup: bool = False, kv_dtype: str = None, device=None,
                 draft_model: str = None, speculate_k: int = None,
                 draft_quant: bool = None, metrics_port: int = None):
        if not decode:
            raise NotImplementedError(
                "paddle_tpu_torch serves decode mode only (pass "
                "decode=True / --decode)")
        from .decode import load_for_decode
        kw = {}
        if decode_slots:
            kw["max_slots"] = int(decode_slots)
        if decode_max_new:
            kw["max_new_tokens"] = int(decode_max_new)
        if kv_dtype:
            kw["kv_dtype"] = str(kv_dtype)
        if draft_model:
            kw["draft_prefix"] = draft_model
        if speculate_k is not None:
            kw["speculate_k"] = int(speculate_k)
        if draft_quant:
            kw["draft_quant"] = True
        self._engine = load_for_decode(model_prefix, device=device, **kw)
        self.warmup_steps = self._engine.warmup(verbose=True) if warmup \
            else 0
        self._idle_timeout = float(
            _flags.env_value("PADDLE_TPU_SERVE_IDLE_TIMEOUT"))
        self._request_timeout = float(
            _flags.env_value("PADDLE_TPU_SERVE_REQUEST_TIMEOUT"))
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(64)
        self.port = self._srv.getsockname()[1]
        self._stop = threading.Event()
        self._draining = threading.Event()
        self._conn_inflight = 0      # requests read and not yet answered
        self._conn_lock = threading.Lock()
        self._conns = {}             # connection thread -> its socket
        self._thread = threading.Thread(target=self._accept_loop,
                                        daemon=True)
        self._thread.start()
        # admin endpoint: off unless a port is given (argument or env);
        # 0 = ephemeral. Loopback only, like the data-plane default.
        self._admin = None
        self.metrics_port = None
        if metrics_port is None:
            metrics_port = _flags.env_value("PADDLE_TPU_METRICS_PORT")
        if metrics_port is not None and int(metrics_port) >= 0:
            from ..observability import AdminServer
            self._admin = AdminServer(port=int(metrics_port), host=host,
                                      health_fn=self._health,
                                      status_fn=self._status)
            self.metrics_port = self._admin.port

    @property
    def engine(self):
        return self._engine

    # -- admin surface ---------------------------------------------------

    def _health(self):
        """(healthy, reasons) for /healthz: the accept loop and the decode
        scheduler must be alive, and the server neither stopped nor
        draining (a draining backend takes no new traffic)."""
        reasons = []
        if self._stop.is_set():
            reasons.append("server stopped")
        elif self._draining.is_set():
            reasons.append("draining")
        elif not self._thread.is_alive():
            reasons.append("accept thread dead")
        if not self._engine._thread.is_alive():
            reasons.append("decode scheduler thread dead")
        return not reasons, reasons

    def _status(self) -> dict:
        return {
            "engine": "decode",
            "port": self.port,
            "metrics_port": self.metrics_port,
            "trace_wire": True,
            "draining": self._draining.is_set(),
            "inflight_requests": self.inflight_requests,
            "config": {
                "idle_timeout_s": self._idle_timeout,
                "request_timeout_s": self._request_timeout,
                "max_request_bytes": max_request_bytes(),
            },
            "warmup_steps": self.warmup_steps,
            "decode": self._engine.stats(),
        }

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except OSError:
                break
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 daemon=True)
            with self._conn_lock:
                if self._stop.is_set():     # stop() has taken the list
                    conn.close()
                    break
                self._conns[t] = conn
            t.start()

    def _serve_decode(self, conn, inputs, ctx):
        """One decode request on an open connection: per-token PDI2
        frames then a done frame, or one PDI1 frame; a stream that dies
        becomes a typed error frame on the same connection. Returns
        False when the socket is unusable."""
        opts = {}
        if ctx is not None and isinstance(ctx.get("decode"), dict):
            d = ctx["decode"]
            for key in ("max_new_tokens", "top_k", "eos_id", "seed"):
                if d.get(key) is not None:
                    opts[key] = int(d[key])
            if d.get("temperature") is not None:
                opts["temperature"] = float(d["temperature"])

        def _sctx(stream_fields, req_id=None):
            if ctx is None:
                return None
            out = {"stream": stream_fields}
            if ctx.get("trace_id") is not None:
                out["trace_id"] = ctx.get("trace_id")
            if req_id is not None:
                out["request_id"] = int(req_id)
            return out

        try:
            if len(inputs) != 1:
                raise TypedServeError(
                    ERR_INVALID_ARGUMENT,
                    f"decode request wants exactly one prompt tensor, "
                    f"got {len(inputs)}")
            prompt = np.asarray(inputs[0])
            if prompt.dtype not in (np.int32, np.int64) \
                    or prompt.ndim not in (1, 2) \
                    or (prompt.ndim == 2 and prompt.shape[0] != 1):
                raise TypedServeError(
                    ERR_INVALID_ARGUMENT,
                    "decode prompt must be int32/int64 [T] or [1, T]")
            stream = self._engine.submit(prompt.reshape(-1), **opts)
        except TypedServeError as e:
            try:
                write_error(conn, str(e),
                            ctx=_sctx({"done": True, "error": True}))
            except OSError:
                pass
            return True          # frame fully consumed; keep the conn
        timeout = self._request_timeout \
            if self._request_timeout and self._request_timeout > 0 else None
        seq = 0
        try:
            while True:
                ev = stream.next_event(timeout=timeout)
                if ev[0] == "done":
                    final = np.asarray(ev[1], np.int32)
                    write_tensors(conn, [final],
                                  ctx=_sctx({"done": True,
                                             "n_tokens": int(final.size)},
                                            stream.request_id))
                    return True
                _, tok, eos = ev
                if ctx is not None:
                    write_tensors(
                        conn, [np.asarray([tok], np.int32)],
                        ctx=_sctx({"seq": seq, "eos": bool(eos),
                                   "done": False}, stream.request_id))
                seq += 1
        except TypedServeError as e:
            try:
                write_error(conn, str(e),
                            ctx=_sctx({"done": True, "error": True,
                                       "seq": seq}))
            except OSError:
                pass
            return True
        except (ConnectionError, TimeoutError, OSError):
            return False

    def _serve_conn(self, conn):
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        # per-connection idle timeout: a dead client must not pin a
        # daemon thread (and its socket buffers) forever
        if self._idle_timeout and self._idle_timeout > 0:
            conn.settimeout(self._idle_timeout)
        try:
            while True:
                try:
                    inputs, ctx = read_request(conn)
                except (ConnectionError, TimeoutError, struct.error,
                        OSError):
                    return
                except (ValueError, IndexError) as e:
                    # unparseable request: the stream is desynced —
                    # best-effort typed error frame, drop the connection
                    try:
                        write_error(conn,
                                    f"{ERR_INVALID_ARGUMENT}: malformed "
                                    f"request: {e}")
                    except OSError:
                        pass
                    return
                with self._conn_lock:
                    self._conn_inflight += 1
                try:
                    if not self._serve_decode(conn, inputs, ctx):
                        return
                finally:
                    with self._conn_lock:
                        self._conn_inflight -= 1
                if self._draining.is_set():
                    return
        finally:
            conn.close()
            with self._conn_lock:
                self._conns.pop(threading.current_thread(), None)

    @property
    def inflight_requests(self) -> int:
        """Requests read off a connection and not yet answered."""
        with self._conn_lock:
            return self._conn_inflight

    def drain(self, timeout: float = 30.0) -> bool:
        """Graceful retirement (the SIGTERM path): stop accepting new
        connections, answer every request already read, then stop.
        Returns True when everything in flight was answered inside
        ``timeout``."""
        self._draining.set()
        try:
            self._srv.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._srv.close()
        deadline = time.monotonic() + float(timeout)
        drained = False
        while time.monotonic() < deadline:
            st = self._engine.stats()
            if self.inflight_requests == 0 \
                    and st["active"] + st["pending"] == 0:
                drained = True
                break
            time.sleep(0.01)
        self.stop()
        return drained

    def stop(self):
        """Stop serving and join every thread the server started: the
        accept loop, the engine's scheduler (open streams get typed
        errors) and each connection thread (its socket shut down first, so
        a blocked read returns). A daemon thread left inside torch when the
        interpreter exits aborts the process ("terminate called without an
        active exception"), so a thread still alive after its join raises."""
        self._stop.set()
        try:
            self._srv.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._srv.close()
        self._thread.join(_JOIN_TIMEOUT_S)
        self._engine.stop()
        if self._admin is not None:
            self._admin.stop()
        with self._conn_lock:
            conns = list(self._conns.items())
        for _, conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        for t, _ in conns:
            t.join(_JOIN_TIMEOUT_S)
        admin = () if self._admin is None else (self._admin._thread,)
        alive = [t.name for t in
                 (self._thread, self._engine._thread, *admin,
                  *(t for t, _ in conns))
                 if t.is_alive()]
        if alive:
            raise RuntimeError(f"server threads still running after "
                               f"{_JOIN_TIMEOUT_S} s: {alive}")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="paddle_tpu_torch decode server")
    ap.add_argument("model", help="save_for_decode artifact prefix")
    ap.add_argument("--port", type=int, default=9000)
    ap.add_argument("--host", default="127.0.0.1",
                    help="bind address (default loopback; 0.0.0.0 exposes "
                         "the unauthenticated daemon to the network)")
    ap.add_argument("--decode", action="store_true",
                    help="autoregressive decode mode (the only mode this "
                         "package serves so far)")
    ap.add_argument("--decode-slots", type=int, default=None,
                    help="concurrent sequences; default sized from free "
                         "device memory")
    ap.add_argument("--decode-max-new", type=int, default=None,
                    help="default max new tokens per request when the "
                         "client does not specify one")
    ap.add_argument("--kv-dtype", default=None,
                    choices=("float32", "int8"),
                    help="KV page-pool dtype: int8 stores quantized pages "
                         "with per-row scales, cutting page memory ~4x "
                         "(default PADDLE_TPU_DECODE_KV_DTYPE)")
    ap.add_argument("--draft-model", default=None, metavar="PREFIX",
                    help="draft-model save_for_decode artifact prefix "
                         "enabling speculative decoding; must share the "
                         "target's vocab (default "
                         "PADDLE_TPU_DECODE_DRAFT_MODEL)")
    ap.add_argument("--speculate-k", type=int, default=None,
                    help="speculation depth: draft steps per scheduler "
                         "tick, verified in one k+1-token target forward "
                         "(default PADDLE_TPU_DECODE_SPECULATE; 0 "
                         "disables)")
    ap.add_argument("--draft-quant", action="store_true", default=None,
                    help="int8-quantize the draft model's weights at load "
                         "— draft numerics only move the speculation "
                         "acceptance rate, never the target stream "
                         "(default PADDLE_TPU_DECODE_DRAFT_QUANT)")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="mount /metrics + /healthz + /statusz on this "
                         "port (0 = ephemeral; default off, or "
                         "PADDLE_TPU_METRICS_PORT)")
    ap.add_argument("--warmup", action="store_true",
                    help="run every decode step shape once at startup")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the "
                         "plain PyTorch versions)")
    ap.add_argument("--drain-timeout", type=float, default=30.0,
                    help="seconds SIGTERM waits for in-flight requests "
                         "before hard stop")
    args = ap.parse_args(argv)
    if not args.decode:
        ap.error("only --decode mode is served by paddle_tpu_torch")
    from ..ops.kernels import decode_attention, quant_matmul
    srv = InferenceServer(args.model, port=args.port, host=args.host,
                          decode_slots=args.decode_slots,
                          decode_max_new=args.decode_max_new,
                          warmup=args.warmup, kv_dtype=args.kv_dtype,
                          device=args.device, draft_model=args.draft_model,
                          speculate_k=args.speculate_k,
                          draft_quant=args.draft_quant,
                          metrics_port=args.metrics_port)

    def counts():
        return {"paged_decode_attention_launches": decode_attention.launches,
                "paged_decode_attention_int8_launches":
                    decode_attention.quant_launches,
                "int8_weight_matmul_launches": quant_matmul.launches}

    # kernel launches counted from here on belong to served requests
    # (warmup's are already in the counts)
    counts0 = counts()
    if srv.metrics_port is not None:
        print(f"METRICS {srv.metrics_port}", flush=True)
    print(f"SERVING {srv.port}", flush=True)
    # SIGTERM = graceful retirement: stop accepting, finish in-flight,
    # exit 0
    term = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: term.set())
    try:
        term.wait()
        print("DRAINING", flush=True)
        ok = srv.drain(timeout=args.drain_timeout)
        st = srv.engine.stats()
        served = " ".join(f"{k}={v - counts0[k]}"
                          for k, v in counts().items())
        sp = st.get("speculate")
        spec = "" if sp is None else (
            f"spec_drafted={sp['drafted']} spec_accepted={sp['accepted']} "
            f"spec_rollback_released={sp['rollback_released']} "
            f"spec_draft_steps={sp['draft_steps']} "
            f"spec_draft_prefills={sp['draft_prefills']} ")
        print(f"DECODE STATS device={st['device']} "
              f"kv_dtype={st['kv_dtype']} steps={st['steps']} "
              f"prefills={st['prefills']} tokens={st['tokens']} "
              f"{spec}{served}", flush=True)
        print(f"DRAINED ok={ok}", flush=True)
    except KeyboardInterrupt:
        srv.stop()


if __name__ == "__main__":
    main()
