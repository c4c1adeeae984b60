#!/usr/bin/env python3
"""READ_BLOCK through the port's client: two trees of this repository
timed in turns against one cluster on one machine.

    python3 scripts/read_block_ab.py OTHER_TREE [--reps 3] [--out FILE]

Starts a one-worker cluster as ``chip_smoke.py`` does
(``scripts/card_cluster.py`` in its own process, a mem tier on tmpfs),
writes 8 files of 64 MiB (one block each) through this tree's client,
then reads them with the short circuit off (READ_BLOCK) through each
tree's ``curvine_tpu_torch`` in a process of its own, in the order
OTHER_TREE, this tree, this tree, OTHER_TREE: one file alone ``--reps``
times (a fresh client each time), and the 8 files at once (8 streams
over the client's connection pool). Every read is held to the written
bytes. Prints GiB/s per tree and case, and last one JSON line. OTHER_TREE
is, for example, an earlier commit unpacked with ``git archive``."""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import shutil
import statistics
import subprocess
import sys
import zlib

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (the cluster's start and stop)

MiB = 1 << 20
FILES, FILE_BYTES = 8, 64 * MiB

# runs in a process of its own with one tree first on sys.path
_READER = r"""
import asyncio, json, sys, time, zlib
tree, master, reps, files, want = sys.argv[1], sys.argv[2], \
    int(sys.argv[3]), sys.argv[4].split(","), int(sys.argv[5])
sys.path.insert(0, tree)
from curvine_tpu_torch.client.unified import CurvineClient
from curvine_tpu_torch.common.conf import ClusterConf

def client():
    conf = ClusterConf()
    conf.client.master_addrs = [master]
    conf.client.short_circuit = False
    return CurvineClient(conf)

async def main():
    one = []
    for _ in range(reps):
        async with client() as c:
            t = time.perf_counter()
            data = await c.read_all(files[0])
            one.append(time.perf_counter() - t)
            assert zlib.crc32(data) == want, "bytes differ"
    async with client() as c:
        t = time.perf_counter()
        got = await asyncio.gather(*(c.read_all(f) for f in files))
        many = time.perf_counter() - t
        assert all(len(g) == len(got[0]) for g in got)
    print(json.dumps({"one_s": one, "many_s": many}))

asyncio.run(main())
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="another tree of this repository")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    other = os.path.abspath(args.other)
    res = {"card": chip_smoke.gpu_name_and_limit(), "other": other,
           "file_bytes": FILE_BYTES, "files": FILES}
    root = chip_smoke.pick_data_dir(FILES * FILE_BYTES + 2 * chip_smoke.GiB)
    proc = None
    try:
        proc, info = chip_smoke.start_cluster(
            root, FILES * FILE_BYTES + chip_smoke.GiB)
        data = np.random.default_rng(0).integers(
            0, 256, FILE_BYTES, dtype=np.uint8).tobytes()
        paths = [f"/ab/f{i}.bin" for i in range(FILES)]

        async def write():
            async with chip_smoke.port_client(info["master"]) as c:
                for p in paths:
                    await c.write_all(p, data)
        asyncio.run(write())
        want = zlib.crc32(data)
        runs = {"other": [], "this": []}
        for name, tree in (("other", other), ("this", ROOT),
                           ("this", ROOT), ("other", other)):
            out = subprocess.run(
                [sys.executable, "-c", _READER, tree, info["master"],
                 str(args.reps), ",".join(paths), str(want)],
                check=True, capture_output=True, text=True, cwd=tree)
            runs[name].append(json.loads(out.stdout.strip().splitlines()[-1]))
        for name, rs in runs.items():
            one = [FILE_BYTES / chip_smoke.GiB / s for r in rs
                   for s in r["one_s"]]
            many = [FILES * FILE_BYTES / chip_smoke.GiB / r["many_s"]
                    for r in rs]
            res[name] = {"one_gibs": one, "one_gibs_median":
                         statistics.median(one), "many_gibs": many}
            print(f"read_block_ab: {name} tree: one 64 MiB file "
                  f"{[round(x, 3) for x in one]} GiB/s (median "
                  f"{statistics.median(one):.3f}); {FILES} files at once "
                  f"{[round(x, 3) for x in many]} GiB/s")
    finally:
        if proc is not None:
            chip_smoke.stop_cluster(proc)
        shutil.rmtree(root, ignore_errors=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(res["card"])
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
