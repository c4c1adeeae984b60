#!/usr/bin/env python3
"""Run a curvine cluster (the JAX package's master and N workers) in this
process until SIGTERM or SIGINT.

    python3 scripts/card_cluster.py --base-dir DIR [--tier-bytes BYTES]
        [--codec auto|port] [--workers N]

This is ``curvine_tpu.testing.MiniCluster(workers=N, base_dir=DIR,
tier_capacity=BYTES, block_size=64 MiB, lost_timeout_ms=30_000)``: master and
workers on ephemeral localhost ports, each worker's one tier a mem tier
under DIR, no web server and no device tier. It is how the PyTorch port
(``curvine_tpu_torch``) gets a cache on a machine that runs it: the port
imports nothing of ``curvine_tpu``, so the cluster runs beside it, in its
own process. ``--workers 0`` runs the master alone; the port's own worker
(``curvine_tpu_torch.worker``) then registers with it and serves the
blocks. The default is one worker.

The cluster's control plane is msgpack. ``--codec auto`` uses the
``msgpack`` package where it is installed; ``--codec port``, or ``auto``
where it is missing, registers the port's own codec
(``curvine_tpu_torch.rpc.wirepack``, byte-equal to msgpack on what the
cluster carries) as ``msgpack`` before ``curvine_tpu`` is imported.

Once the master serves and its workers have registered, prints one
JSON line:
``{"master": "host:port", "codec": "msgpack" or "wirepack", "native":
true or false, "pid": N}``; ``native`` says whether the package's C++
helpers (crc32c among them, built with ``make`` under ``csrc/``) loaded.
On SIGTERM or SIGINT the cluster stops and the process exits 0."""

from __future__ import annotations

import argparse
import asyncio
import importlib.util
import json
import os
import signal
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MiB = 1 << 20


def install_codec(choice: str) -> str:
    """Make ``import msgpack`` resolve to the codec that will serve;
    returns its name."""
    if choice == "auto" and importlib.util.find_spec("msgpack") is not None:
        return "msgpack"
    from curvine_tpu_torch.rpc import wirepack
    sys.modules["msgpack"] = wirepack
    return "wirepack"


async def serve(base_dir: str, tier_bytes: int, codec: str,
                workers: int) -> None:
    from curvine_tpu.common import native
    from curvine_tpu.testing import MiniCluster
    # build the package's C++ helpers (csrc/, `make`) now, not inside the
    # first block write: without them the worker hashes blocks in Python
    have_native = native.available()
    mc = MiniCluster(workers=workers, base_dir=base_dir,
                     tier_capacity=tier_bytes,
                     block_size=64 * MiB, lost_timeout_ms=30_000)
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        loop.add_signal_handler(sig, stop.set)
    await mc.start()
    try:
        print(json.dumps({"master": mc.master.addr, "codec": codec,
                          "native": have_native, "pid": os.getpid()}),
              flush=True)
        await stop.wait()
    finally:
        await mc.stop()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base-dir", required=True)
    ap.add_argument("--tier-bytes", type=int, default=1 << 30)
    ap.add_argument("--codec", choices=("auto", "port"), default="auto")
    ap.add_argument("--workers", type=int, default=1,
                    help="workers to start; 0 runs the master alone")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    codec = install_codec(args.codec)
    asyncio.run(serve(args.base_dir, args.tier_bytes, codec, args.workers))
    return 0


if __name__ == "__main__":
    sys.exit(main())
