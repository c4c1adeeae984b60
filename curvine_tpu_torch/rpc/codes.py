"""RPC operation codes the port's cache client and worker send and serve.

Own copy of the numbers of ``curvine_tpu/rpc/codes.py::RpcCode`` that the
client's read path and its writer use (the master's namespace and block
calls and the worker's block calls, the short-circuit write's grant,
commit and abort among them), and those the port's worker serves or
sends to the master: its heartbeat and block report, block deletes,
short-circuit read reports, the device tier-0's pin and unpin, the
device-path transfer it refuses, the master's info for checks of the
master's view, and the calls the worker refuses by name (the master's
replication jobs and tasks, batched small writes). The numbers are the
wire's and must not change."""

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
    GET_MASTER_INFO = 14
    META_BATCH = 29
    PREFETCH_WINDOW = 75
    # worker → master
    WORKER_HEARTBEAT = 40
    WORKER_BLOCK_REPORT = 41
    REPORT_UNDER_REPLICATED_BLOCKS = 45
    # master → worker
    SUBMIT_TASK = 39
    SUBMIT_BLOCK_REPLICATION_JOB = 42
    # worker
    WRITE_BLOCK = 80
    READ_BLOCK = 81
    WRITE_BLOCKS_BATCH = 82
    DELETE_BLOCK = 84
    GET_BLOCK_INFO = 85
    # short-circuit write of a co-located block: the worker grants a temp
    # block file, the client writes it and commits (or aborts) it
    SC_WRITE_OPEN = 86
    SC_WRITE_COMMIT = 87
    SC_WRITE_ABORT = 88
    # a client's per-block short-circuit read counts (the block's heat)
    SC_READ_REPORT = 89
    # the device tier-0
    HBM_PIN = 100
    HBM_UNPIN = 101
    ICI_TRANSFER = 103
