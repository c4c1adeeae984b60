"""Run the port's cache worker until SIGTERM or SIGINT.

    python -m curvine_tpu_torch.worker --conf FILE

The counterpart of ``curvine_tpu/cli/main.py:809-822`` (``cmd_worker``),
without the web server: the ``[worker]`` and ``[client]`` tables of the
cluster's TOML file (``common/conf.py``; the master's address is the
client's ``master_addrs``) configure one ``WorkerServer``, which
registers with the master by its heartbeat. Once it serves, prints one
JSON line, ``{"addr": "host:port", "worker_id": N}``. A ``[worker]``
table with ``hbm_capacity`` above 0 puts a device tier-0 on every CUDA
device, and fails where there is none."""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import signal

from curvine_tpu_torch.common.conf import ClusterConf
from curvine_tpu_torch.worker.server import WorkerServer


async def serve(conf: ClusterConf) -> None:
    worker = WorkerServer(conf)
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        loop.add_signal_handler(sig, stop.set)
    await worker.start()
    try:
        print(json.dumps({"addr": worker.addr,
                          "worker_id": worker.worker_id}), flush=True)
        await stop.wait()
    finally:
        await worker.stop()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--conf", required=True, help="the cluster's TOML file")
    args = ap.parse_args()
    logging.basicConfig(level=logging.INFO)
    asyncio.run(serve(ClusterConf.load(args.conf)))


if __name__ == "__main__":
    main()
