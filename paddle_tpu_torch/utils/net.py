"""Socket helper for the serve wire protocol: the recv-until-n loop."""
from __future__ import annotations

__all__ = ["recv_exact"]


def recv_exact(sock, n: int, what: str = "peer") -> bytes:
    """Read exactly n bytes or raise ConnectionError on EOF."""
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError(f"{what} closed connection")
        buf.extend(chunk)
    return bytes(buf)
