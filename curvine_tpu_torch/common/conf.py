"""Master, client and worker configuration.

Own copy of the fields of ``curvine_tpu/common/conf.py:23-306``
(``MasterConf``, ``TierConf``, ``WorkerConf``, ``ClientConf``) that the
port's master, cache client and worker read, with the same names and
defaults, inside a ``ClusterConf`` that holds them; ``ClusterConf.load``
reads the ``[master]``, ``[client]``, ``[worker]``, ``[ec]``, ``[rpc]``
and ``[obs]`` tables of the cluster's TOML file, ``[[worker.tiers]]``
included (other tables and unknown keys are ignored, so the cluster's
own file loads as is).

The master's metadata store is the reference's (:29-37): ``meta_store``
is ``"kv"`` by default (the log-structured KV store, in ``meta_dir``,
``""`` meaning ``<journal_dir>-meta``; its engine ``meta_engine``,
``"auto"``, ``"native"`` or ``"python"``; its inode cache holds the
reference's default of 65,536 inodes, a constant) or ``"mem"`` (the
namespace in RAM, made durable by the journal's snapshots); any other
value of either is refused by name. The
master's fields that name a feature the port's master does not have are
constants (``MASTER_FIXED``), at the value it implements: the sharded
namespace (``meta_shards`` stays 1: the reference refuses sharding
under raft anyway), raft's tuning knobs that no cluster file sets
(``raft_promote_lag``, ``raft_snapshot_chunk_mb`` and
``raft_transfer_timeout_ms``, at the reference's defaults), the native
fast metadata port
(the reference's default is on), ACLs beyond the superuser gate
(``acl_enabled`` stays on), the UFS backup, the TTL scanner, the read
leases, the audit log, the dir watchdog and ``min_replication``. A file
that sets one of them otherwise is refused by name.
``block_placement_policy`` takes every policy of the reference, ``"ici"``
(the torus-distance spread) among them; ``ici_mesh_shape`` (the torus
the hop distance wraps on) and ``replication_pull_budget_ms`` (the
budget of one pull the replication manager dispatches) are fields.
A node's own raft settings (:104-119) are fields with the reference's
defaults: ``raft_peers`` (every master's ``host:port``; empty, a single
master), ``raft_node_id`` and ``raft_learner``.
``fast_port``, ``web_port`` and ``worker_heartbeat_ms`` are ignored, as
the reference's master ignores them with the fast port off and no web
server.

The client's fields are the reference's, with its defaults: the
identity sent with every request (``user`` and ``groups``; empty, the
OS user and that user's groups), a file's replica count at CREATE_FILE
(``replicas``), the tier its blocks are written to (``storage_type``),
the writer's chunk (``write_chunk_size``), the metadata retry policy
(``conn_retry_max``, ``conn_retry_base_ms``), and the writer's
recovery: ``write_replay_buffer`` keeps the open block's bytes so that
a block that lost its last leg, or fell below ``write_min_replicas``
live legs, is re-placed and replayed (off, the failure reaches the
caller), and the block keeps streaming on its surviving legs while at
least ``write_min_replicas`` remain; and the per-worker circuit
breakers of ``client/health.py`` (``breaker_enabled``, on by default as
in the reference, ``breaker_fail_threshold``, ``breaker_open_ms`` and
``breaker_decay_ms``, :281-290); and the reader's deadline,
``op_deadline_ms`` (:275-280; 0, the default, is none), the budget of
one read, which its hops to a block's replicas share.
The worker's fields that name a branch the port's worker does not have
are constants too (``WORKER_FIXED``, ``TIER_FIXED``, ``QOS_FIXED``): the
bdev layout and a tier's direct-IO queue depth, the direct-IO engine,
the disk-fault thresholds and the QoS tenant specs. A file that sets one
of them to anything but the value the port implements is refused. The
shared-memory read plane's four keys (``shm_reads``, ``shm_export_cap``,
``shm_warm_cap_mb``, ``shm_warm_min_reads``, :204-218) are fields at the
reference's defaults: on, 128, 64 and 3. The device-path transfer
(``ici_transfer``, on by default, as in the reference), the bound of
the tier-0's heartbeat advertisement (``hbm_advertise_max``) and the
tasks a worker runs at once (``task_parallelism``, :168) are fields.
The ``[ec]`` table is the one field of the reference's ``ECConf``
(:448-470) that anything reads, ``convert_cold_s`` (the age at which a
file's blocks may be converted). Its other three keys, ``enabled``,
``profile`` and ``sweep_interval_s``, are read by neither package: they
are constants (``EC_FIXED``) at the reference's defaults, and a file
that sets one of them to another value is refused.
The ``[rpc]`` table is the reference's ``RpcConf`` (:348-386), the wire
transport's knobs (``rpc/transport.py``), shared by every client and
server of a process. Its one field is ``send_coalesce_frames``, the
most frames a send. Its other keys are constants (``RPC_FIXED``) at the
reference's defaults, which are the transport's own: ``uvloop`` (off:
the port runs stock asyncio), ``send_coalesce_bytes``,
``send_inline_max``, ``recv_buffer_bytes``, ``recv_registered_bytes``
and ``recv_aligned_min``; a file that sets one of them to another value
is refused. Its io_uring receive ring (``recv_ring``,
``recv_ring_min``) waits for the worker's direct IO: both are constants
(``RING_FIXED``) at what the port implements, no ring, and the refusal
names ROADMAP §A item 3.
The client's read-ahead (:247-252) is the reference's
``read_ahead_chunks`` (the reader's prefetch window and ``chunks``'
read-ahead); its sequential-read detector's keys,
``enable_smart_prefetch`` and ``sequential_read_threshold``, are
constants (``CLIENT_FIXED``) at the reference's defaults, on and 3.
The ``[obs]`` table is the reference's ``ObsConf`` (:331-345), the
tracing plane's (``obs/trace.py``). Its one field is ``enabled`` (on).
Its other keys are constants (``OBS_FIXED``) at the reference's
defaults, which are the tracer's own: ``trace_sample_rate`` (0.01),
``slow_op_ms`` (1,000), ``span_store_size`` (8,192) and
``trace_collect_timeout_ms`` (2,000); a file that sets one of them to
another value is refused.
Left out: the fuse and gateway sections, the worker's scrub and
web-server fields, the client's meta-cache, tenant and prefetch-window
fields, the CLI's ``read_parallel`` and ``large_file_size``, and the
``CURVINE_*`` environment overrides."""

from __future__ import annotations

import dataclasses
import tomllib
from dataclasses import dataclass, field

MB = 1024 * 1024
GB = 1024 * MB


# the master's branches the port does not have, at the value it implements
MASTER_FIXED = {
    "fast_meta": False, "meta_lease_ms": 3_000, "meta_lease_dirs": 4_096,
    "acl_enabled": True, "audit_log": False, "watchdog_stall_ms": 10_000,
    "ufs_backup_uri": "", "ufs_backup_interval_s": 300, "meta_shards": 1,
    "shard_backend": "process", "shard_dir_cache": 65_536,
    "raft_promote_lag": 64, "raft_snapshot_chunk_mb": 4,
    "raft_transfer_timeout_ms": 5_000,
    "ttl_check_ms": 1_000, "ttl_bucket_ms": 1_000,
    "min_replication": 1, "meta_cache_inodes": 65_536}
PLACEMENTS = ("local", "random", "robin", "weighted", "load", "ici")
META_STORES = ("kv", "mem")
META_ENGINES = ("auto", "native", "python")


# the worker's branches the port does not have, at the value it implements
WORKER_FIXED = {"direct_io": False,
                "direct_io_engine": "off", "disk_error_threshold": 3,
                "disk_error_decay_s": 60.0, "disk_probe_interval_s": 5.0,
                "disk_probe_failures": 2, "disk_probe_successes": 3,
                "disk_evac_batch": 256}
TIER_FIXED = {"layout": "file", "queue_depth": 0}
QOS_FIXED = {"tenants": []}
EC_FIXED = {"enabled": True, "profile": "rs-6-3", "sweep_interval_s": 0.0}
# the transport's keys nothing sets, at the reference's defaults (the
# constants of rpc/transport.py)
RPC_FIXED = {"uvloop": False, "send_coalesce_bytes": 256 * 1024,
             "send_inline_max": 8 * 1024, "recv_buffer_bytes": 256 * 1024,
             "recv_registered_bytes": 32 * MB,
             "recv_aligned_min": 256 * 1024}
# the transport's io_uring receive ring, not in the port: no ring
RING_FIXED = {"recv_ring": False, "recv_ring_min": 256 * 1024}
# the reader's sequential-read detector, at the reference's defaults
CLIENT_FIXED = {"enable_smart_prefetch": True,
                "sequential_read_threshold": 3}
# the tracing plane's keys nothing sets, at the reference's defaults
# (the constants of obs/trace.py)
OBS_FIXED = {"trace_sample_rate": 0.01, "slow_op_ms": 1_000,
             "span_store_size": 8192, "trace_collect_timeout_ms": 2_000}


@dataclass
class MasterConf:
    hostname: str = "127.0.0.1"
    rpc_port: int = 8995
    # the metadata store: "kv" (the log-structured KV store, which may
    # outgrow RAM; a restart replays the journal's tail) or "mem" (dicts,
    # snapshot and replay); its directory ("": <journal_dir>-meta)
    meta_dir: str = ""
    meta_store: str = "kv"
    # the KV engine: "auto" (the native one when its library builds),
    # "native" (that one or an error) or "python"; the same files
    meta_engine: str = "auto"
    journal_dir: str = "data/journal"
    journal_fsync: bool = False
    # group commit: an idle mutation commits at once; under load the
    # group lingers up to journal_group_commit_ms, at most
    # journal_group_max entries
    journal_group_commit_ms: float = 1.0
    journal_group_max: int = 1024
    snapshot_interval_entries: int = 100_000
    worker_lost_timeout_ms: int = 30_000
    heartbeat_check_ms: int = 1_000
    block_placement_policy: str = "local"   # local|random|robin|weighted|load|ici
    # ICI torus shape for the hop distance (e.g. [4, 2]); empty: the
    # distance falls back to host labels
    ici_mesh_shape: list[int] = field(default_factory=list)
    retry_cache_size: int = 100_000
    retry_cache_ttl_ms: int = 600_000
    superuser: str = "root"
    supergroup: str = "supergroup"
    # the budget of one replication pull the master dispatches (the
    # submit and the destination's stream from the source), carried in
    # the request header
    replication_pull_budget_ms: int = 20_000
    # raft (HA); empty peers: a single master on its journal
    raft_peers: list[str] = field(default_factory=list)
    raft_node_id: int = 1
    # start this node as a non-voting learner
    raft_learner: bool = False


@dataclass
class TierConf:
    storage_type: str = "mem"   # hbm|mem|ssd|hdd
    dir: str = "data/mem"
    capacity: int = 1 * GB


@dataclass
class WorkerConf:
    hostname: str = "127.0.0.1"
    rpc_port: int = 8996
    web_port: int = 9001
    tiers: list[TierConf] = field(default_factory=lambda: [TierConf()])
    heartbeat_ms: int = 3_000
    block_report_interval_ms: int = 60_000
    io_chunk_size: int = 4 * MB
    # eviction watermarks (fraction of tier capacity)
    eviction_high_water: float = 0.95
    eviction_low_water: float = 0.80
    # hot-data promotion: blocks read >= min_reads since the last scan
    # move up to the fastest tier and auto-pin into the device tier-0
    # (0 disables the scan)
    promote_interval_ms: int = 30_000
    promote_min_reads: int = 3
    ici_coords: list[int] = field(default_factory=list)
    # the device tier-0 (bytes of device memory for the cache; 0 disables)
    hbm_capacity: int = 0
    # the peer-device plane (gpu/ici_plane.py): advertise the tier-0's
    # blocks to peers and land ICI_TRANSFER pulls from a peer's tier-0;
    # a miss is answered success False (the caller's TCP rail)
    ici_transfer: bool = True
    hbm_export_cap: int = 128
    # exported blocks advertised a heartbeat, most recent first
    hbm_advertise_max: int = 64
    # admission on the mem and device tiers: "s3fifo" or "lru"
    cache_admission: str = "s3fifo"
    cache_ghost_entries: int = 8192
    cache_small_ratio: float = 0.1
    # the master's load, export and prefetch tasks run at once
    task_parallelism: int = 4
    # the shared-memory read plane (worker/shm.py): MEM-tier blocks
    # exported as sealed memfds and handed to co-located clients over an
    # SCM_RIGHTS unix side channel, whose reads are then slices of the
    # mapping, with no RPC; needs os.memfd_create (Linux)
    shm_reads: bool = True
    # sealed-memfd export cache entries (LRU; an eviction closes the
    # worker's fd, a client's dup stays valid)
    shm_export_cap: int = 128
    # the warm cache for the tiers below mem: a read-hot block's bytes
    # copied once into a sealed memfd and served over the same channel;
    # bounded in MiB, 0 disables it (the MEM exports are unaffected)
    shm_warm_cap_mb: int = 64
    # reads (the SC_READ_REPORT heat) a block below mem needs before it
    # earns a warm copy
    shm_warm_min_reads: int = 3


@dataclass
class ClientConf:
    master_addrs: list[str] = field(
        default_factory=lambda: ["127.0.0.1:8995"])
    # the identity sent with every request (empty: the OS user and its
    # groups)
    user: str = ""
    groups: list[str] = field(default_factory=list)
    block_size: int = 64 * MB
    replicas: int = 1
    write_chunk_size: int = 4 * MB
    read_chunk_size: int = 4 * MB
    # chunks kept in flight ahead of a sequential reader: the prefetch
    # window of positional reads and ``chunks``' read-ahead
    read_ahead_chunks: int = 4
    short_circuit: bool = True
    # the tier a file's blocks are written to: hbm|mem|ssd|hdd
    storage_type: str = "mem"
    # keep the open block's bytes until it seals, so that a block that
    # lost its legs is re-placed and replayed; off, the loss surfaces
    write_replay_buffer: bool = True
    # verify full-block reads against the block's commit-time crc
    read_verify: bool = True
    # the fan-out floor: a block keeps streaming on its surviving legs
    # while at least this many remain; below it the block is replayed
    write_min_replicas: int = 1
    rpc_timeout_ms: int = 30_000
    conn_retry_max: int = 3
    conn_retry_base_ms: int = 100
    conn_pool_size: int = 4
    # per-worker circuit breakers (client/health.py): after
    # breaker_fail_threshold failures in a row against one worker its
    # breaker opens for breaker_open_ms (reads try it last, placements
    # exclude it), then half-opens for one probe; counts decay after
    # breaker_decay_ms without a failure
    breaker_enabled: bool = True
    breaker_fail_threshold: int = 3
    breaker_open_ms: int = 5_000
    breaker_decay_ms: int = 30_000
    # the budget of one read (rpc/deadline.py), carried in each request's
    # header: a hop waits at most the remaining budget over the replicas
    # left to try, so a wedged worker costs a share of it, not a whole
    # rpc_timeout_ms, before the read fails over; 0 is no budget
    op_deadline_ms: int = 0


def _check(path: str, section: str, table: dict, fixed: dict,
           item: str) -> None:
    """Refuse a key of ``fixed`` that ``table`` sets to another value."""
    for k, v in table.items():
        if k in fixed and v != fixed[k]:
            raise ValueError(f"{path}: {section}.{k} = {v!r}: the port's "
                             f"{item} takes only {fixed[k]!r}")


def _apply(obj, table: dict) -> None:
    """Set ``obj``'s fields from ``table``; unknown keys are ignored."""
    names = {f.name for f in dataclasses.fields(obj)} - {"tiers"}
    for k, v in table.items():
        if k in names:
            setattr(obj, k, v)


@dataclass
class RpcConf:
    """The wire transport's knob (``rpc/transport.py``), shared by every
    client and server of the process."""

    # the coalesced writer: the frames queued within one turn of the
    # loop leave in one vectored send, at most this many frames
    send_coalesce_frames: int = 128


@dataclass
class ECConf:
    """The erasure-coded capacity tier's cluster settings."""

    # a file's blocks are converted once its mtime is this old (0: any
    # complete file)
    convert_cold_s: int = 0


@dataclass
class ObsConf:
    """The tracing plane's switch (``obs/trace.py``)."""

    # off: every span is a no-op
    enabled: bool = True


@dataclass
class ClusterConf:
    master: MasterConf = field(default_factory=MasterConf)
    client: ClientConf = field(default_factory=ClientConf)
    worker: WorkerConf = field(default_factory=WorkerConf)
    ec: ECConf = field(default_factory=ECConf)
    rpc: RpcConf = field(default_factory=RpcConf)
    obs: ObsConf = field(default_factory=ObsConf)

    @staticmethod
    def load(path: str) -> "ClusterConf":
        """The ``[master]``, ``[client]``, ``[worker]``, ``[ec]``,
        ``[rpc]`` and ``[obs]`` tables of the TOML file at ``path``."""
        with open(path, "rb") as f:
            data = tomllib.load(f)
        conf = ClusterConf()
        master = data.get("master") or {}
        item = "master (ROADMAP A3d)"
        _check(path, "master", master, MASTER_FIXED, item)
        for key, allowed in (("meta_store", META_STORES),
                             ("meta_engine", META_ENGINES)):
            if key in master and master[key] not in allowed:
                raise ValueError(
                    f"{path}: master.{key} = {master[key]!r}: the port's "
                    f"master takes {list(allowed)}")
        policy = master.get("block_placement_policy", "local")
        if policy not in PLACEMENTS:
            raise ValueError(
                f"{path}: master.block_placement_policy = {policy!r}: the "
                f"port's {item} takes only {list(PLACEMENTS)}")
        _apply(conf.master, master)
        client = data.get("client") or {}
        _check(path, "client", client, CLIENT_FIXED, "client")
        _apply(conf.client, client)
        ec = data.get("ec") or {}
        _check(path, "ec", ec, EC_FIXED, "erasure coding")
        _apply(conf.ec, ec)
        rpc = data.get("rpc") or {}
        _check(path, "rpc", rpc, RPC_FIXED, "transport")
        _check(path, "rpc", rpc, RING_FIXED,
               "transport (the receive ring waits for ROADMAP §A item 3)")
        _apply(conf.rpc, rpc)
        obs = data.get("obs") or {}
        _check(path, "obs", obs, OBS_FIXED, "tracing")
        _apply(conf.obs, obs)
        worker = data.get("worker") or {}
        item = "worker (ROADMAP A3c)"
        _check(path, "worker", worker, WORKER_FIXED, item)
        _check(path, "qos", data.get("qos") or {}, QOS_FIXED, item)
        _apply(conf.worker, worker)
        if "tiers" in worker:
            conf.worker.tiers = []
            for t in worker["tiers"]:
                _check(path, "worker.tiers", t, TIER_FIXED, item)
                tier = TierConf()
                _apply(tier, t)
                conf.worker.tiers.append(tier)
        return conf
