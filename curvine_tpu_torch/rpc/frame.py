"""Wire framing.

Own copy of ``curvine_tpu/rpc/frame.py:1-231``: the frame
``[u32 len][fixed][header][data]`` with the fixed block ``u8 version |
u16 code | u64 req_id | u8 status | u8 flags | u32 header_len``, the
header a msgpack map (through the port's ``wirepack``) and the data raw
bytes, never copied into the header. ``Message.check`` is the decoding
side of ``error_for``: it raises the error a response carries, with its
backoff and leader hints; ``response_for`` and ``error_for`` (:156-179)
build a server's replies. Left out: the coalesced writer's
``encode_into`` and the deadline and trace context a server reads from
a request (the port sends neither, and its server ignores them)."""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Any

from curvine_tpu_torch.common.errors import CurvineError, ErrorCode
from curvine_tpu_torch.rpc import wirepack

VERSION = 1
FIXED = struct.Struct(">BHQBBI")
FIXED_LEN = FIXED.size
LEN_PREFIX = struct.Struct(">I")
ENVELOPE_MAX = LEN_PREFIX.size + FIXED_LEN   # bytes before the header
MAX_FRAME = 64 * 1024 * 1024 + 1024          # one chunk + slack

STATUS_OK = 0
STATUS_ERROR = 1


class Flags:
    REQUEST = 0
    RESPONSE = 1 << 0
    CHUNK = 1 << 1   # intermediate streaming frame
    EOF = 1 << 2     # final streaming frame


@dataclass
class Message:
    code: int = 0
    req_id: int = 0
    status: int = STATUS_OK
    flags: int = Flags.REQUEST
    header: dict = field(default_factory=dict)
    data: bytes | bytearray | memoryview = b""

    @property
    def is_response(self) -> bool:
        return bool(self.flags & Flags.RESPONSE)

    @property
    def is_chunk(self) -> bool:
        return bool(self.flags & Flags.CHUNK)

    @property
    def is_eof(self) -> bool:
        return bool(self.flags & Flags.EOF)

    def check(self) -> "Message":
        """Raise the remote error this response carries, if any."""
        if self.status != STATUS_OK:
            code = self.header.get("error_code", ErrorCode.UNDEFINED)
            e = CurvineError.from_wire(code, self.header.get("error", ""))
            ra = self.header.get("retry_after_ms")
            if ra is not None:
                e.retry_after_ms = int(ra)
            hint = self.header.get("leader_hint")
            if hint:
                e.leader_hint = str(hint)
            members = self.header.get("members")
            if members:
                e.members = list(members)
            raise e
        return self

    def encode(self) -> list[bytes | bytearray | memoryview]:
        """The buffers to write, the data passed through uncopied."""
        hdr = wirepack.packb(self.header) if self.header else b""
        total = FIXED_LEN + len(hdr) + len(self.data)
        out: list = [LEN_PREFIX.pack(total) + FIXED.pack(
            VERSION, self.code, self.req_id, self.status, self.flags,
            len(hdr))]
        if hdr:
            out.append(hdr)
        if len(self.data):
            out.append(self.data)
        return out


def response_for(req: Message, header: dict | None = None,
                 data: bytes | memoryview = b"",
                 flags: int = Flags.RESPONSE) -> Message:
    return Message(code=req.code, req_id=req.req_id, status=STATUS_OK,
                   flags=flags, header=header or {}, data=data)


def error_for(req: Message, e: Exception) -> Message:
    """The error reply to ``req``: a ``CurvineError``'s code and hints, any
    other exception as an IO error naming its type."""
    if isinstance(e, CurvineError):
        code, msg = int(e.code), str(e)
    else:
        code, msg = int(ErrorCode.IO), f"{type(e).__name__}: {e}"
    header = {"error_code": code, "error": msg}
    ra = getattr(e, "retry_after_ms", None)
    if ra is not None:
        header["retry_after_ms"] = int(ra)
    hint = getattr(e, "leader_hint", None)
    if hint:
        header["leader_hint"] = str(hint)
    members = getattr(e, "members", None)
    if members:
        header["members"] = list(members)
    return Message(code=req.code, req_id=req.req_id, status=STATUS_ERROR,
                   flags=Flags.RESPONSE | Flags.EOF, header=header)


def parse_envelope(prefix) -> tuple[int, int, int, int, int, int]:
    """Validate the first ``ENVELOPE_MAX`` bytes of a frame; returns
    ``(code, req_id, status, flags, header_len, data_len)``."""
    (total,) = LEN_PREFIX.unpack_from(prefix, 0)
    if total > MAX_FRAME or total < FIXED_LEN:
        raise CurvineError(f"bad frame length {total}",
                           code=ErrorCode.ABNORMAL_DATA)
    version, code, req_id, status, flags, hdr_len = FIXED.unpack_from(
        prefix, LEN_PREFIX.size)
    if version != VERSION:
        raise CurvineError(f"unsupported frame version {version}",
                           code=ErrorCode.ABNORMAL_DATA)
    if FIXED_LEN + hdr_len > total:
        raise CurvineError(f"bad header length {hdr_len}",
                           code=ErrorCode.ABNORMAL_DATA)
    return code, req_id, status, flags, hdr_len, total - FIXED_LEN - hdr_len


def decode_header(buf) -> dict:
    """A frame's header map ({} when empty)."""
    if not len(buf):
        return {}
    try:
        header = wirepack.unpackb(buf, raw=False, strict_map_key=False)
    except ValueError as e:
        raise CurvineError(f"frame header does not parse: {e}",
                           code=ErrorCode.ABNORMAL_DATA) from e
    if not isinstance(header, dict):
        raise CurvineError(f"frame header is {type(header).__name__}, not "
                           f"a map", code=ErrorCode.ABNORMAL_DATA)
    return header


def pack(obj: Any) -> bytes:
    return wirepack.packb(obj, use_bin_type=True)


def unpack(buf) -> Any:
    return wirepack.unpackb(buf, raw=False, strict_map_key=False) \
        if len(buf) else None
