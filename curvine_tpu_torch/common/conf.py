"""Client configuration.

Own copy of the fields of ``curvine_tpu/common/conf.py:230-306``
(``ClientConf``) that the port's cache client reads, with the same
defaults, inside a ``ClusterConf`` that holds it; ``ClusterConf.load``
reads the ``[client]`` table of the cluster's TOML file (other tables
and unknown keys are ignored, so the cluster's own file loads as is).

The reference's ``user``, ``groups``, ``replicas``, ``storage_type``,
``write_chunk_size``, ``conn_retry_max`` and ``conn_retry_base_ms`` are
constants here, at the reference's defaults (``FIXED``): the OS user,
one replica (the writer has no replica recovery), the mem tier. A file
that sets one of them to another value is refused, never ignored.
Left out: the master, worker, fuse, gateway, obs, rpc, qos and ec
sections, the client's breaker, deadline, meta-cache, tracing, tenant,
replay-buffer, read-ahead and prefetch-window fields, and the
``CURVINE_*`` environment overrides."""

from __future__ import annotations

import dataclasses
import tomllib
from dataclasses import dataclass, field

MB = 1024 * 1024


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


@dataclass
class ClusterConf:
    client: ClientConf = field(default_factory=ClientConf)

    @staticmethod
    def load(path: str) -> "ClusterConf":
        """The ``[client]`` table of the TOML file at ``path``."""
        with open(path, "rb") as f:
            data = tomllib.load(f)
        conf = ClusterConf()
        names = {f.name for f in dataclasses.fields(ClientConf)}
        for k, v in (data.get("client") or {}).items():
            if k in FIXED and v != FIXED[k]:
                raise ValueError(f"{path}: client.{k} = {v!r}: the port's "
                                 f"client takes only {FIXED[k]!r} "
                                 f"(ROADMAP A3b)")
            if k in names:
                setattr(conf.client, k, v)
        return conf
