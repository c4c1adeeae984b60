#!/usr/bin/env python3
"""The POSIX feed and the client feed of ``chip_smoke.py`` (phases 4 and
4b): two trees of this repository timed in turns on one card.

    python3 scripts/client_feed_ab.py OTHER_TREE [--pairs 3] [--out FILE]

Each run is a process of its own with one tree's ``chip_smoke`` and
``curvine_tpu_torch``: a data directory on tmpfs, ``phase_feed`` (8
POSIX shards of 64 MiB at batch 32 x 8192), then the port's master and
worker as ``chip_smoke.py`` starts them and ``phase_client`` (8 shards
written through the port's client and streamed through the client-fed
``GpuTrainFeed``, one read twice by READ_BLOCK). The trees alternate
OTHER_TREE, this tree, this tree, OTHER_TREE, ``--pairs`` pairs in all;
each phase checks its own bytes. Prints batches/s per run and tree, the
card's name and power limit, and last one JSON line. OTHER_TREE is, for
example, an earlier commit unpacked with ``git archive``; delete its
``curvine_tpu_torch/build/`` first."""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_RUN = r"""
import json, os, shutil, sys
import numpy as np
sys.path.insert(0, os.getcwd())
import chip_smoke as cs
from curvine_tpu_torch.device import default_device
dev = default_device()
rng = np.random.default_rng(0)
root = cs.pick_data_dir(4 << 30)
proc = pw = None
try:
    feed = cs.phase_feed(rng, dev, root)
    conf = cs.master_conf(root)
    proc, info = cs.start_master(root, conf)
    pw = cs.PortWorker(info["addr"], root, 2 << 30, dev)
    cs.await_port_worker(info["addr"], pw)
    client = cs.phase_client(rng, dev, info["addr"], feed)
    print("RESULT " + json.dumps({
        "posix_batches_per_s": feed["batches_per_s"],
        "client_batches_per_s": client["batches_per_s"],
        "read_block_gibs": client["read_block_gibs"],
        "write_gibs": client["write_gibs"]}))
finally:
    if pw is not None:
        pw.stop()
    if proc is not None:
        cs.stop_master(proc)
    shutil.rmtree(root, ignore_errors=True)
"""


def run(tree: str) -> dict:
    out = subprocess.run([sys.executable, "-c", _RUN], cwd=tree,
                         capture_output=True, text=True, timeout=600)
    for line in out.stdout.splitlines():
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])
    raise RuntimeError(f"{tree}: exit {out.returncode}\n"
                       f"{out.stdout[-2000:]}\n{out.stderr[-3000:]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other")
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    other = os.path.abspath(args.other)
    order = []
    for i in range(args.pairs):
        order += [other, ROOT] if i % 2 == 0 else [ROOT, other]
    runs = []
    for tree in order:
        res = run(tree)
        runs.append({"tree": tree, **res})
        print(f"{tree}: {res}", flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    summary = {}
    for name, tree in (("other", other), ("this", ROOT)):
        mine = [r for r in runs if r["tree"] == tree]
        summary[name] = {k: statistics.median(r[k] for r in mine)
                         for k in ("posix_batches_per_s",
                                   "client_batches_per_s",
                                   "read_block_gibs", "write_gibs")}
    print(card)
    result = {"card": card, "runs": runs, "median": summary}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result["median"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
