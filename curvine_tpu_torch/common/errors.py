"""Errors the port raises.

Own copy of the two classes of ``curvine_tpu/common/errors.py`` that the
data path needs; ``code`` is the same wire code (``ErrorCode``) so a
later RPC layer can carry them unchanged."""

from __future__ import annotations

ABNORMAL_DATA = 20            # curvine_tpu.common.errors.ErrorCode


class CurvineError(Exception):
    code: int = 0


class AbnormalData(CurvineError):
    """Bytes failed an integrity check (media crc or device-copy hash)."""

    code = ABNORMAL_DATA
