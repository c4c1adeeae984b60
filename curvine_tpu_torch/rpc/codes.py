"""RPC operation codes the port's cache client sends.

Own copy of the numbers of ``curvine_tpu/rpc/codes.py::RpcCode`` that the
client's read path and its writer use: the master's namespace and block
calls and the worker's block calls, the short-circuit write's grant,
commit and abort among them. The numbers are the wire's and must not
change."""

from __future__ import annotations

import enum


class RpcCode(enum.IntEnum):
    # master
    MKDIR = 2
    DELETE = 3
    CREATE_FILE = 4
    FILE_STATUS = 7
    LIST_STATUS = 8
    ADD_BLOCK = 11
    COMPLETE_FILE = 12
    GET_BLOCK_LOCATIONS = 13
    META_BATCH = 29
    REPORT_UNDER_REPLICATED_BLOCKS = 45
    PREFETCH_WINDOW = 75
    # worker
    WRITE_BLOCK = 80
    READ_BLOCK = 81
    GET_BLOCK_INFO = 85
    # short-circuit write of a co-located block: the worker grants a temp
    # block file, the client writes it and commits (or aborts) it
    SC_WRITE_OPEN = 86
    SC_WRITE_COMMIT = 87
    SC_WRITE_ABORT = 88
