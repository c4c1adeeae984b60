"""RPC operation codes the port's cache client, worker and master send
and serve.

Own copy of the numbers of ``curvine_tpu/rpc/codes.py::RpcCode`` that the
client's read path and its writer use (the master's namespace and block
calls and the worker's block calls, the short-circuit write's grant,
commit and abort among them), and those the port's worker serves or
sends to the master: its heartbeat and block report, block deletes,
short-circuit read reports, the device tier-0's pin and unpin, the
device-path transfer, the master's replication jobs and the results it
reports back, the master's load, export and prefetch tasks and their
reports, the master's info for checks of the master's view, and the
call the worker refuses by name (batched small writes); and those the
port's master serves (the namespace, block, worker-plane, replication,
mount, job and prefetch-window calls, and raft between masters) or
refuses by name
(``MASTER_REFUSED``: every other code the reference's master
registers). The numbers are the wire's and must not change."""

from __future__ import annotations

import enum


class RpcCode(enum.IntEnum):
    # master
    MKDIR = 2
    DELETE = 3
    CREATE_FILE = 4
    OPEN_FILE = 5
    APPEND_FILE = 6
    FILE_STATUS = 7
    LIST_STATUS = 8
    EXISTS = 9
    RENAME = 10
    ADD_BLOCK = 11
    COMPLETE_FILE = 12
    GET_BLOCK_LOCATIONS = 13
    GET_MASTER_INFO = 14
    SET_ATTR = 15
    SYMLINK = 16
    LINK = 17
    RESIZE_FILE = 18
    ASSIGN_WORKER = 19
    GET_LOCK = 20
    SET_LOCK = 21
    LIST_LOCK = 22
    CREATE_FILES_BATCH = 23
    ADD_BLOCKS_BATCH = 24
    COMPLETE_FILES_BATCH = 25
    FREE = 26
    LIST_OPTIONS = 27
    CONTENT_SUMMARY = 28
    META_BATCH = 29
    MOUNT = 30
    UNMOUNT = 31
    UPDATE_MOUNT = 32
    GET_MOUNT_TABLE = 33
    GET_MOUNT_INFO = 34
    SUBMIT_JOB = 35
    GET_JOB_STATUS = 36
    CANCEL_JOB = 37
    REPORT_TASK = 38
    METRICS_REPORT = 60
    CLUSTER_HEALTH = 61
    GET_SPANS = 62
    SHARD_TX = 70
    SHARD_TX_LIST = 71
    SHARD_STATS = 72
    SHARD_TABLE = 73
    TENANT_STATS = 74
    PREFETCH_WINDOW = 75
    # raft between masters (master/ha.py); RAFT_STATUS answers on any
    # node, MEMBER_CHANGE and TRANSFER are the leader's admin calls
    RAFT_VOTE = 90
    RAFT_APPEND = 91
    RAFT_SNAPSHOT = 92
    RAFT_PREVOTE = 93
    RAFT_SNAPSHOT_CHUNK = 94
    RAFT_TIMEOUT_NOW = 95
    RAFT_STATUS = 96
    RAFT_MEMBER_CHANGE = 97
    RAFT_TRANSFER = 98
    # worker → master
    WORKER_HEARTBEAT = 40
    WORKER_BLOCK_REPORT = 41
    REPORT_BLOCK_REPLICATION_RESULT = 43
    REQUEST_REPLACEMENT_WORKER = 44
    REPORT_UNDER_REPLICATED_BLOCKS = 45
    DECOMMISSION_WORKER = 46
    EC_COMMIT_STRIPE = 47
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


# the codes the reference's master registers (curvine_tpu/master/
# server.py:340-410) that the port's master answers UNSUPPORTED, by name
MASTER_REFUSED = (
    RpcCode.APPEND_FILE, RpcCode.SYMLINK, RpcCode.LINK,
    RpcCode.RESIZE_FILE, RpcCode.FREE, RpcCode.CREATE_FILES_BATCH,
    RpcCode.ADD_BLOCKS_BATCH, RpcCode.COMPLETE_FILES_BATCH,
    RpcCode.LIST_OPTIONS, RpcCode.CONTENT_SUMMARY, RpcCode.GET_LOCK,
    RpcCode.SET_LOCK, RpcCode.LIST_LOCK, RpcCode.ASSIGN_WORKER,
    RpcCode.CLUSTER_HEALTH, RpcCode.SHARD_TX,
    RpcCode.SHARD_TX_LIST, RpcCode.SHARD_STATS, RpcCode.SHARD_TABLE,
    RpcCode.TENANT_STATS)
