"""Wire framing.

Own copy of ``curvine_tpu/rpc/frame.py:1-231``: the frame
``[u32 len][fixed][header][data]`` with the fixed block ``u8 version |
u16 code | u64 req_id | u8 status | u8 flags | u32 header_len``, the
header a msgpack map (through the port's ``wirepack``) and the data raw
bytes, never copied into the header. ``Message.check`` is the decoding
side of ``error_for``: it raises the error a response carries, with its
backoff and leader hints; ``response_for`` and ``error_for`` (:156-179)
build a server's replies. A server sets ``Message.deadline``, never
sent, from the request's ``deadline_ms`` header (``rpc/deadline.py``),
and ``Message.trace``, never sent either, from its ``trace_ctx`` header
(``trace_ctx()``; ``obs/trace.py``), the caller's span.
The coalesced writer appends a frame to its batch with ``encode_into``
(:117-139), and the bulk decoder parses one frame's envelope out of its
buffer with ``decode_envelope`` (:193-231)."""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Any

from curvine_tpu_torch.common.errors import CurvineError, ErrorCode
from curvine_tpu_torch.obs.trace import SpanCtx
from curvine_tpu_torch.rpc import wirepack
from curvine_tpu_torch.rpc.deadline import Deadline

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
    # server side: the caller's budget, set at dispatch from the header
    # (never sent)
    deadline: Deadline | None = None
    # server side: the caller's span, set at dispatch from the header
    # (never sent)
    trace: SpanCtx | None = None

    @property
    def is_response(self) -> bool:
        return bool(self.flags & Flags.RESPONSE)

    @property
    def is_chunk(self) -> bool:
        return bool(self.flags & Flags.CHUNK)

    @property
    def is_eof(self) -> bool:
        return bool(self.flags & Flags.EOF)

    def trace_ctx(self) -> SpanCtx | None:
        """The caller's trace context, if the request carries one."""
        return SpanCtx.from_header(self.header)

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

    def encode_into(self, out: bytearray, inline_max: int = 0
                    ) -> bytes | bytearray | memoryview | None:
        """Append this frame to ``out``, the coalesced writer's batch. A
        data payload longer than ``inline_max`` is not copied: it is
        returned, for the caller to send right after ``out``'s bytes; a
        shorter one is copied into ``out`` and None is returned."""
        hdr = wirepack.packb(self.header) if self.header else b""
        out += LEN_PREFIX.pack(FIXED_LEN + len(hdr) + len(self.data))
        out += FIXED.pack(VERSION, self.code, self.req_id, self.status,
                          self.flags, len(hdr))
        if hdr:
            out += hdr
        if not len(self.data):
            return None
        if len(self.data) <= inline_max:
            out += self.data
            return None
        return self.data


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


def decode_envelope(buf, pos: int, limit: int
                    ) -> tuple[int, int, int, int, int, dict, int] | None:
    """One frame's envelope (length prefix, fixed block, header) out of
    ``buf[pos:limit]``, its data left unread: ``(end, code, req_id,
    status, flags, header, data_len)`` with ``end`` the offset of the
    first data byte, or None while the envelope is not all buffered. A
    length past ``MAX_FRAME`` or short of ``FIXED_LEN`` is refused from
    the prefix alone; nothing is consumed before a refusal."""
    avail = limit - pos
    if avail < LEN_PREFIX.size:
        return None
    (total,) = LEN_PREFIX.unpack_from(buf, pos)
    if total > MAX_FRAME or total < FIXED_LEN:
        raise CurvineError(f"bad frame length {total}",
                           code=ErrorCode.ABNORMAL_DATA)
    if avail < ENVELOPE_MAX:
        return None
    version, code, req_id, status, flags, hdr_len = FIXED.unpack_from(
        buf, pos + LEN_PREFIX.size)
    if version != VERSION:
        raise CurvineError(f"unsupported frame version {version}",
                           code=ErrorCode.ABNORMAL_DATA)
    if FIXED_LEN + hdr_len > total:
        raise CurvineError(f"bad header length {hdr_len}",
                           code=ErrorCode.ABNORMAL_DATA)
    end = pos + ENVELOPE_MAX + hdr_len
    if limit < end:
        return None
    header = decode_header(memoryview(buf)[pos + ENVELOPE_MAX:end]) \
        if hdr_len else {}
    return (end, code, req_id, status, flags, header,
            total - FIXED_LEN - hdr_len)
