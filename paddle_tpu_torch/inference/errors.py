"""Typed serving errors: machine-parseable failure classes on the wire.

A copy of paddle_tpu's `inference/errors.py`: a typed error's frame
message is ``CODE: detail`` with CODE one of the ``ERR_*`` constants
(gRPC-style), and :func:`error_code` recovers the code from a received
message (``None`` for legacy untyped errors, which clients must treat as
non-retryable).
"""
from __future__ import annotations

__all__ = ["TypedServeError", "error_code", "tag_code",
           "ERR_UNAVAILABLE", "ERR_RESOURCE_EXHAUSTED",
           "ERR_DEADLINE_EXCEEDED", "ERR_INVALID_ARGUMENT",
           "ERR_INTERNAL", "ERR_FAILED_PRECONDITION",
           "RETRYABLE_CODES", "WIRE_ERROR_CODES"]

# a dead/draining dependency: safe to fail over to another backend
ERR_UNAVAILABLE = "UNAVAILABLE"
# admission control refused the request: back off, do NOT fail over
# (every backend is past its watermark — retrying amplifies the overload)
ERR_RESOURCE_EXHAUSTED = "RESOURCE_EXHAUSTED"
# the server-side request deadline expired in queue+execute
ERR_DEADLINE_EXCEEDED = "DEADLINE_EXCEEDED"
# the request itself is malformed; retrying anywhere cannot help
ERR_INVALID_ARGUMENT = "INVALID_ARGUMENT"
# an unexpected server-side fault (model error, bug)
ERR_INTERNAL = "INTERNAL"
# the operation's precondition does not hold on THIS peer: retrying the
# same operation cannot help, but the caller has a defined fallback
ERR_FAILED_PRECONDITION = "FAILED_PRECONDITION"

WIRE_ERROR_CODES = (ERR_UNAVAILABLE, ERR_RESOURCE_EXHAUSTED,
                    ERR_DEADLINE_EXCEEDED, ERR_INVALID_ARGUMENT,
                    ERR_INTERNAL, ERR_FAILED_PRECONDITION)

# codes a router may answer by trying ANOTHER backend; everything else is
# either deterministic (INVALID_ARGUMENT, INTERNAL) or made worse by a
# retry (RESOURCE_EXHAUSTED, DEADLINE_EXCEEDED)
RETRYABLE_CODES = frozenset({ERR_UNAVAILABLE})


class TypedServeError(RuntimeError):
    """A serving-path failure with a wire-visible status code."""

    def __init__(self, code: str, detail: str = ""):
        if code not in WIRE_ERROR_CODES:
            raise ValueError(f"unknown serve error code {code!r}")
        self.code = code
        super().__init__(f"{code}: {detail}" if detail else code)


def tag_code(exc: BaseException, code: str) -> BaseException:
    """Stamp a wire error code onto an existing exception (best effort —
    some builtin exceptions refuse new attributes)."""
    try:
        exc.code = code
    except Exception:
        pass
    return exc


def error_code(message: str):
    """The ``ERR_*`` code a wire error message carries, or ``None`` for
    a legacy untyped message."""
    if not message:
        return None
    head = message.split(":", 1)[0].strip()
    return head if head in WIRE_ERROR_CODES else None
