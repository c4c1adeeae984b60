"""Client and worker configuration.

Own copy of the fields of ``curvine_tpu/common/conf.py:127-306``
(``TierConf``, ``WorkerConf``, ``ClientConf``) that the port's cache
client and worker read, with the same defaults, inside a ``ClusterConf``
that holds them; ``ClusterConf.load`` reads the ``[client]`` and
``[worker]`` tables of the cluster's TOML file, ``[[worker.tiers]]``
included (other tables and unknown keys are ignored, so the cluster's
own file loads as is).

The reference's ``user``, ``groups``, ``replicas``, ``storage_type``,
``write_chunk_size``, ``conn_retry_max`` and ``conn_retry_base_ms`` are
constants here, at the reference's defaults (``FIXED``): the OS user,
one replica (the writer has no replica recovery), the mem tier. A file
that sets one of them to another value is refused, never ignored.
The worker's fields that name a branch the port's worker does not have
are constants too (``WORKER_FIXED``, ``TIER_FIXED``, ``QOS_FIXED``): the
bdev layout and a tier's direct-IO queue depth, the direct-IO engine,
the shared-memory reads and their warm cache, the disk-fault thresholds,
the device-path transfer (``ici_transfer``, off until ROADMAP A10; the
reference's default is on) and the QoS tenant specs. A file that sets
one of them to anything but the value the port implements is refused.
Left out: the master, fuse, gateway, obs, rpc and ec sections, the
worker's scrub, task and web-server fields, the client's breaker,
deadline, meta-cache, tracing, tenant, replay-buffer, read-ahead and
prefetch-window fields, and the ``CURVINE_*`` environment overrides."""

from __future__ import annotations

import dataclasses
import tomllib
from dataclasses import dataclass, field

MB = 1024 * 1024
GB = 1024 * MB


# the reference's defaults, which the port does not let a caller change
REPLICAS = 1
STORAGE_TYPE = "mem"
WRITE_CHUNK_SIZE = 4 * MB
CONN_RETRY_MAX = 3
CONN_RETRY_BASE_MS = 100
FIXED = {"user": "", "groups": [], "replicas": REPLICAS,
         "storage_type": STORAGE_TYPE, "write_chunk_size": WRITE_CHUNK_SIZE,
         "conn_retry_max": CONN_RETRY_MAX,
         "conn_retry_base_ms": CONN_RETRY_BASE_MS}


# the worker's branches the port does not have, at the value it implements
WORKER_FIXED = {"ici_transfer": False, "shm_reads": False,
                "shm_warm_cap_mb": 0, "direct_io": False,
                "direct_io_engine": "off", "disk_error_threshold": 3,
                "disk_error_decay_s": 60.0, "disk_probe_interval_s": 5.0,
                "disk_probe_failures": 2, "disk_probe_successes": 3,
                "disk_evac_batch": 256}
TIER_FIXED = {"layout": "file", "queue_depth": 0}
QOS_FIXED = {"tenants": []}


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
    hbm_export_cap: int = 128
    # admission on the mem and device tiers: "s3fifo" or "lru"
    cache_admission: str = "s3fifo"
    cache_ghost_entries: int = 8192
    cache_small_ratio: float = 0.1


@dataclass
class ClientConf:
    master_addrs: list[str] = field(
        default_factory=lambda: ["127.0.0.1:8995"])
    block_size: int = 64 * MB
    read_chunk_size: int = 4 * MB
    short_circuit: bool = True
    # verify full-block reads against the block's commit-time crc
    read_verify: bool = True
    rpc_timeout_ms: int = 30_000
    conn_pool_size: int = 4


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
class ClusterConf:
    client: ClientConf = field(default_factory=ClientConf)
    worker: WorkerConf = field(default_factory=WorkerConf)

    @staticmethod
    def load(path: str) -> "ClusterConf":
        """The ``[client]`` and ``[worker]`` tables of the TOML file at
        ``path``."""
        with open(path, "rb") as f:
            data = tomllib.load(f)
        conf = ClusterConf()
        client = data.get("client") or {}
        _check(path, "client", client, FIXED, "client (ROADMAP A3b)")
        _apply(conf.client, client)
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
