"""Errors the port raises, and the wire's error codes.

Own copy of ``curvine_tpu/common/errors.py``: ``ErrorCode`` with the same
numbers, its retryable set, ``CurvineError.from_wire`` and the classes the
port's data path, vector path, cache client, worker, master and
under-filesystems raise or receive. A
class's ``code`` is its wire code, so an error crosses the RPC boundary
unchanged, and ``code_of`` reads that code from an error of any client
that carries one. Codes without a class here arrive as a plain
``CurvineError`` that carries the code."""

from __future__ import annotations

import enum


class ErrorCode(enum.IntEnum):
    UNDEFINED = 0
    IO = 1
    FILE_NOT_FOUND = 2
    FILE_ALREADY_EXISTS = 3
    DIR_NOT_EMPTY = 4
    NOT_A_DIRECTORY = 5
    IS_A_DIRECTORY = 6
    INVALID_PATH = 7
    INVALID_ARGUMENT = 8
    LEASE_CONFLICT = 9
    BLOCK_NOT_FOUND = 10
    WORKER_NOT_FOUND = 11
    NO_AVAILABLE_WORKER = 12
    CAPACITY_EXCEEDED = 13
    QUOTA_EXCEEDED = 14
    NOT_LEADER = 15
    TIMEOUT = 16
    CANCELLED = 17
    UNSUPPORTED = 18
    IN_PROGRESS = 19
    ABNORMAL_DATA = 20
    UFS_ERROR = 21
    MOUNT_NOT_FOUND = 22
    PERMISSION_DENIED = 23
    EXPIRED = 24
    JOB_NOT_FOUND = 25
    CONNECT = 26
    UNCOMPLETED = 27
    FAST_MISS = 28
    FAST_GATED = 29
    THROTTLED = 30
    DRAINING = 31

    @property
    def retryable(self) -> bool:
        """The operation may succeed if tried again, perhaps against
        another master or worker."""
        return self in _RETRYABLE


_RETRYABLE = {ErrorCode.TIMEOUT, ErrorCode.NOT_LEADER, ErrorCode.CONNECT,
              ErrorCode.IN_PROGRESS, ErrorCode.THROTTLED, ErrorCode.DRAINING}

FILE_NOT_FOUND = int(ErrorCode.FILE_NOT_FOUND)


class CurvineError(Exception):
    """Base error carrying an ``ErrorCode`` across the RPC boundary. A
    server's redirect and backoff hints ride along: ``retry_after_ms``
    (THROTTLED), ``leader_hint`` and ``members`` (NOT_LEADER)."""

    code: ErrorCode = ErrorCode.UNDEFINED
    retry_after_ms: int | None = None
    leader_hint: str | None = None
    members: list | None = None

    def __init__(self, message: str = "", code: int | None = None):
        super().__init__(message)
        if code is not None:
            self.code = ErrorCode(code)

    @property
    def retryable(self) -> bool:
        return self.code.retryable

    @staticmethod
    def from_wire(code: int, message: str) -> "CurvineError":
        """The error a response's ``error_code`` and ``error`` name: its
        class where the port has one, else a ``CurvineError`` with the
        code (``UNDEFINED`` for a code this copy does not know)."""
        try:
            ec = ErrorCode(code)
        except ValueError:
            ec = ErrorCode.UNDEFINED
        return _CODE_TO_CLASS.get(ec, CurvineError)(message, code=ec)


def _make(name: str, code: ErrorCode) -> type[CurvineError]:
    return type(name, (CurvineError,), {"code": code})


FileNotFound = _make("FileNotFound", ErrorCode.FILE_NOT_FOUND)
FileAlreadyExists = _make("FileAlreadyExists", ErrorCode.FILE_ALREADY_EXISTS)
DirNotEmpty = _make("DirNotEmpty", ErrorCode.DIR_NOT_EMPTY)
NotADirectory = _make("NotADirectory", ErrorCode.NOT_A_DIRECTORY)
IsADirectory = _make("IsADirectory", ErrorCode.IS_A_DIRECTORY)
InvalidPath = _make("InvalidPath", ErrorCode.INVALID_PATH)
InvalidArgument = _make("InvalidArgument", ErrorCode.INVALID_ARGUMENT)
LeaseConflict = _make("LeaseConflict", ErrorCode.LEASE_CONFLICT)
BlockNotFound = _make("BlockNotFound", ErrorCode.BLOCK_NOT_FOUND)
WorkerNotFound = _make("WorkerNotFound", ErrorCode.WORKER_NOT_FOUND)
NoAvailableWorker = _make("NoAvailableWorker", ErrorCode.NO_AVAILABLE_WORKER)
CapacityExceeded = _make("CapacityExceeded", ErrorCode.CAPACITY_EXCEEDED)
Unsupported = _make("Unsupported", ErrorCode.UNSUPPORTED)
WorkerDraining = _make("WorkerDraining", ErrorCode.DRAINING)
NotLeader = _make("NotLeader", ErrorCode.NOT_LEADER)
RpcTimeout = _make("RpcTimeout", ErrorCode.TIMEOUT)
AbnormalData = _make("AbnormalData", ErrorCode.ABNORMAL_DATA)
AbnormalData.__doc__ = ("Bytes failed an integrity check (media crc, "
                        "device-copy hash or a frame that does not parse).")
PermissionDenied = _make("PermissionDenied", ErrorCode.PERMISSION_DENIED)
ConnectError = _make("ConnectError", ErrorCode.CONNECT)
Uncompleted = _make("Uncompleted", ErrorCode.UNCOMPLETED)
UfsError = _make("UfsError", ErrorCode.UFS_ERROR)
MountNotFound = _make("MountNotFound", ErrorCode.MOUNT_NOT_FOUND)
JobNotFound = _make("JobNotFound", ErrorCode.JOB_NOT_FOUND)

_CODE_TO_CLASS: dict[ErrorCode, type[CurvineError]] = {
    c.code: c for c in [
        FileNotFound, FileAlreadyExists, DirNotEmpty, NotADirectory,
        IsADirectory, InvalidPath, InvalidArgument, LeaseConflict,
        BlockNotFound, WorkerNotFound, NoAvailableWorker, CapacityExceeded,
        Unsupported, WorkerDraining, NotLeader, RpcTimeout, AbnormalData,
        PermissionDenied, ConnectError, Uncompleted, UfsError,
        MountNotFound, JobNotFound]}


def code_of(e: BaseException) -> int | None:
    """The wire code ``e`` carries, or None for an error without one. A
    client the port is handed raises its own error classes; they are
    told apart by this code, as they are on the wire."""
    code = getattr(e, "code", None)
    return int(code) if isinstance(code, int) else None
