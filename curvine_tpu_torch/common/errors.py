"""Errors the port raises.

Own copy of the classes of ``curvine_tpu/common/errors.py`` that the data
path and the vector path need; ``code`` is the same wire code
(``ErrorCode``) so a later RPC layer can carry them unchanged, and
``code_of`` reads that code from an error of any client that carries one,
such as the cache's own client."""

from __future__ import annotations

FILE_NOT_FOUND = 2            # curvine_tpu.common.errors.ErrorCode
INVALID_ARGUMENT = 8
ABNORMAL_DATA = 20


class CurvineError(Exception):
    code: int = 0


class FileNotFound(CurvineError):
    code = FILE_NOT_FOUND


class InvalidArgument(CurvineError):
    code = INVALID_ARGUMENT


class AbnormalData(CurvineError):
    """Bytes failed an integrity check (media crc or device-copy hash)."""

    code = ABNORMAL_DATA


def code_of(e: BaseException) -> int | None:
    """The wire code ``e`` carries, or None for an error without one. A
    client the port is handed raises its own error classes; they are
    told apart by this code, as they are on the wire."""
    code = getattr(e, "code", None)
    return int(code) if isinstance(code, int) else None
