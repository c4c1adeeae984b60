"""Run the port's cache master until SIGTERM or SIGINT.

    python -m curvine_tpu_torch.master --conf FILE [--metrics-out FILE]

The counterpart of ``curvine_tpu/cli/main.py:796-807`` (``cmd_master``),
without the web server: the ``[master]`` table of the cluster's TOML
file (``common/conf.py``; its ``[rpc]`` table the transport)
configures one
``MasterServer``, which
recovers its namespace from its metadata store and the journal under
``journal_dir`` and then serves. Once it serves, prints one JSON line,
``{"addr": "host:port", "pid": N, "jax_free": true or false,
"recover_s": s, "journal_seq": N, "store": {...}, "recovery": {...},
"raft": {...} or null}``:
``jax_free`` says that no module
named ``jax*``, ``curvine_tpu`` or ``curvine_tpu.*`` is loaded in this
process, ``recover_s`` is the seconds from the server's construction to
serving (the store's open and the journal's replay included), and
``store`` and ``recovery`` are as in ``stats``, and ``raft`` is the
node's ``RaftLite.status()`` under raft (null without). With
``--metrics-out``, once stopped it writes there what it counted
(``stats``): the RPC counts, the counters and gauges (``raft.*`` among
them, and ``rpc.writer_breaks``, the reply writers that broke, with
``rpc.writer_breaks_peer_gone`` of them because the client had left), the metadata store's kind and engine, its KV directory's
segments, the recovery's figures, and ``raft``, the status as it stood
just before the stop."""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import os
import signal
import time

from curvine_tpu_torch import jax_free
from curvine_tpu_torch.common.conf import ClusterConf
from curvine_tpu_torch.master.server import MasterServer


def store_stats(master: MasterServer) -> dict:
    """The metadata store's ``kind`` ("kv" or "mem"), and for the KV
    store its ``engine`` ("native" or "python"), ``dir`` and the
    ``segments`` there (counted on disk, so also after its close)."""
    store = master.fs.store
    if store.kind != "kv":
        return {"kind": store.kind}
    d = store.kv.dir
    return {"kind": "kv", "engine": store.engine, "dir": d,
            "segments": sum(n.startswith("seg-") and n.endswith(".sst")
                            for n in os.listdir(d))}


def raft_status(master: MasterServer) -> dict | None:
    return master.raft.status() if master.raft is not None else None


# the writers' histogram of frames a send (rpc/transport.py) and the
# dispatches' reply sends (rpc/server.py), not codes
SEND_BATCH = "rpc.send_batch_frames"
REPLY_SEND = "rpc.reply_send"


def stats(master: MasterServer, raft: dict | None = None) -> dict:
    """The master's counters and gauges, each code's ``rpc.<name>``
    histogram as its count, p50, p99 and mean in ms, the sends of its
    connections' writers (``send_batch_frames``: sends, frames, the mean
    and the most frames a send), the replies' sends, a part of each
    dispatch (``reply_send``, the same figures), the journal's
    last seq,
    the group commit's groups and entries, the store (``store_stats``)
    and the recovery's figures (inodes, blocks, ``applied_seq``, tail
    entries replayed; ``MasterFilesystem.recovery``), and ``raft``, the
    raft status given."""
    m = master.metrics
    batches = m.histograms.get(SEND_BATCH)

    def times(h) -> dict:
        return {"count": h.count, "p50_ms": 1e3 * h.quantile(0.5),
                "p99_ms": 1e3 * h.quantile(0.99),
                "mean_ms": 1e3 * h.sum / max(1, h.count)}
    return {"rpc": {name[len("rpc."):]: times(h)
                    for name, h in sorted(m.histograms.items())
                    if name.startswith("rpc.")
                    and name not in (SEND_BATCH, REPLY_SEND)},
            "reply_send": None if REPLY_SEND not in m.histograms else
            times(m.histograms[REPLY_SEND]),
            "send_batch_frames": None if batches is None else {
                "sends": batches.count, "frames": batches.sum,
                "mean": batches.sum / max(1, batches.count),
                "max": batches.max},
            "counters": dict(m.counters), "gauges": dict(m.gauges),
            "journal_seq": master.fs.journal.seq,
            "groups": master.fs.committer.groups,
            "entries": master.fs.committer.entries,
            "store": store_stats(master),
            "recovery": dict(master.fs.recovery),
            "raft": raft}


async def serve(conf: ClusterConf, metrics_out: str | None = None) -> None:
    t = time.perf_counter()
    master = MasterServer(conf)
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        loop.add_signal_handler(sig, stop.set)
    await master.start()
    try:
        print(json.dumps({"addr": master.addr, "pid": os.getpid(),
                          "jax_free": jax_free(),
                          "recover_s": time.perf_counter() - t,
                          "journal_seq": master.fs.journal.seq,
                          "store": store_stats(master),
                          "recovery": master.fs.recovery,
                          "raft": raft_status(master)}), flush=True)
        await stop.wait()
    finally:
        last = raft_status(master)
        await master.stop()
        if metrics_out:
            with open(metrics_out, "w") as f:
                json.dump(stats(master, last), f)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--conf", required=True, help="the cluster's TOML file")
    ap.add_argument("--metrics-out", default=None,
                    help="write the master's counts here as JSON once it "
                         "stops")
    args = ap.parse_args()
    logging.basicConfig(level=logging.INFO)
    conf = ClusterConf.load(args.conf)
    asyncio.run(serve(conf, args.metrics_out))


if __name__ == "__main__":
    main()
