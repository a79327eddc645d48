"""Model-file encryption (port of paddle_tpu's `io/crypto`): ChaCha20 with
a Poly1305 tag (RFC 7539 / 8439) in `native/chacha20.cpp`, the port's own
copy of the JAX package's source, built with the host C++ compiler (g++)
at first use into ``build/paddle_tpu_torch/crypto/<key>/`` at the root
of the checkout (git-ignored; ``<key>`` hashes the source, the flags and
the compiler). A failed build raises.

    from paddle_tpu_torch.io import crypto
    key = crypto.CipherFactory.generate_key()        # 32 bytes
    cipher = crypto.CipherFactory.create_cipher()
    cipher.encrypt_to_file(plain_bytes, key, "model.enc")
    plain = cipher.decrypt_from_file(key, "model.enc")

`paddle_tpu_torch.save` / `load(..., cipher_key=...)` route through this
module. The file layout is the JAX package's, so a file encrypted by
either package decrypts in the other: magic "PDTC" | u8 version | 12-byte
nonce | 16-byte tag | ciphertext. Version 2's tag is the RFC 8439
ChaCha20-Poly1305 AEAD tag (empty AAD, one-time key from the counter-0
block); version-1 files are rejected.
"""
from __future__ import annotations

import ctypes
import hashlib
import hmac
import os
import secrets
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["Cipher", "CipherFactory", "encrypt", "decrypt",
           "encrypt_to_file", "decrypt_from_file"]

SRC = Path(__file__).resolve().parent / "native" / "chacha20.cpp"
BUILD_ROOT = (Path(__file__).resolve().parents[3] / "build"
              / "paddle_tpu_torch" / "crypto")
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")
_MAGIC = b"PDTC"
_VERSION = 2
_lib = None
_LOCK = threading.Lock()


def _compiler():
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise RuntimeError("no C++ compiler (g++ or $CXX) to build "
                           "paddle_tpu_torch's chacha20 library")
    return cxx


def _build() -> Path:
    """The library, built first if its source, flags or compiler
    changed."""
    cxx = _compiler()
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(cxx.encode())
    out = BUILD_ROOT / h.hexdigest()[:16] / "libchacha20.so"
    if out.is_file():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    res = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SRC)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"chacha20 build failed:\n{res.stderr}")
    os.replace(tmp, out)        # atomic: concurrent builds agree
    return out


def _load_lib():
    global _lib
    with _LOCK:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            u8p = ctypes.c_char_p
            lib.pd_chacha20_xor.argtypes = [u8p, u8p, ctypes.c_uint32,
                                            ctypes.c_void_p, ctypes.c_uint64]
            lib.pd_chacha20_xor.restype = ctypes.c_int
            lib.pd_chacha20_mac.argtypes = [u8p, u8p, u8p, ctypes.c_uint64,
                                            ctypes.c_void_p]
            lib.pd_chacha20_mac.restype = ctypes.c_int
            lib.pd_poly1305.argtypes = [u8p, u8p, ctypes.c_uint64,
                                        ctypes.c_void_p]
            lib.pd_poly1305.restype = ctypes.c_int
            _lib = lib
    return _lib


def _keystream_xor(key: bytes, nonce: bytes, data: bytes,
                   counter: int = 1) -> bytes:
    lib = _load_lib()
    buf = ctypes.create_string_buffer(bytes(data), len(data))
    lib.pd_chacha20_xor(key, nonce, counter, buf, len(data))
    return buf.raw


def _mac(key: bytes, nonce: bytes, data: bytes) -> bytes:
    lib = _load_lib()
    tag = ctypes.create_string_buffer(16)
    lib.pd_chacha20_mac(key, nonce, bytes(data), len(data), tag)
    return tag.raw


def _poly1305(key: bytes, msg: bytes) -> bytes:
    """Raw Poly1305 of `msg` under a 32-byte one-time key (RFC 7539
    §2.5; for the test vectors)."""
    lib = _load_lib()
    tag = ctypes.create_string_buffer(16)
    lib.pd_poly1305(_check_key(key), bytes(msg), len(msg), tag)
    return tag.raw


def _check_key(key: bytes) -> bytes:
    key = bytes(key)
    if len(key) != 32:
        raise ValueError(f"cipher key must be 32 bytes, got {len(key)}")
    return key


def encrypt(data: bytes, key: bytes) -> bytes:
    """magic | version | nonce | tag | ciphertext (encrypt-then-MAC)."""
    key = _check_key(key)
    nonce = secrets.token_bytes(12)
    ct = _keystream_xor(key, nonce, bytes(data))
    return _MAGIC + bytes([_VERSION]) + nonce + _mac(key, nonce, ct) + ct


def decrypt(blob: bytes, key: bytes) -> bytes:
    key = _check_key(key)
    if blob[:4] != _MAGIC or len(blob) < 4 + 1 + 12 + 16:
        raise ValueError("not a paddle_tpu encrypted blob")
    if blob[4] != _VERSION:
        raise ValueError(f"unsupported cipher version {blob[4]}")
    nonce, tag, ct = blob[5:17], blob[17:33], blob[33:]
    if not hmac.compare_digest(_mac(key, nonce, ct), tag):
        raise ValueError("decryption failed: wrong key or corrupted file")
    return _keystream_xor(key, nonce, ct)


def encrypt_to_file(data: bytes, key: bytes, path: str):
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        f.write(encrypt(data, key))


def decrypt_from_file(key: bytes, path: str) -> bytes:
    with open(path, "rb") as f:
        return decrypt(f.read(), key)


class Cipher:
    """Paddle's Cipher surface: Encrypt / Decrypt and the file forms."""

    def encrypt(self, plaintext: bytes, key: bytes) -> bytes:
        return encrypt(plaintext, key)

    def decrypt(self, ciphertext: bytes, key: bytes) -> bytes:
        return decrypt(ciphertext, key)

    def encrypt_to_file(self, plaintext: bytes, key: bytes, path: str):
        encrypt_to_file(plaintext, key, path)

    def decrypt_from_file(self, key: bytes, path: str) -> bytes:
        return decrypt_from_file(key, path)


class CipherFactory:
    @staticmethod
    def create_cipher(config_file: str = None) -> Cipher:
        return Cipher()

    @staticmethod
    def generate_key() -> bytes:
        return secrets.token_bytes(32)
