#!/usr/bin/env python3
"""Phase 5 of ``chip_smoke.py`` (the four K3 kernels checked against
their plain versions and timed beside SDPA): two trees of this
repository in turns on one card.

    python3 scripts/flash_phase_ab.py OTHER_TREE [--pairs 2] [--out FILE]

Each run is a process of its own with one tree's ``chip_smoke`` and
``curvine_tpu_torch`` (its kernels built at first use), running
``phase_flash`` alone. The trees alternate OTHER_TREE, this tree, this
tree, OTHER_TREE, ``--pairs`` pairs in all. Prints each run's kernel
and library times (ms), the card's name and power limit, and last one
JSON line of the medians per tree. OTHER_TREE is, for example, an
earlier commit unpacked with ``git archive``; delete its
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
import json, os, sys
sys.path.insert(0, os.getcwd())
import torch
import chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
r = cs.phase_flash(torch.device("cuda", 0), 0)["kernels"]
print("RESULT " + json.dumps({n: {"ms": k["ms"], "library_ms": k["library_ms"]}
                              for n, k in r.items()}))
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
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    other = os.path.abspath(args.other)
    order = []
    for i in range(args.pairs):
        order += [other, ROOT] if i % 2 == 0 else [ROOT, other]
    runs = []
    for tree in order:
        res = run(tree)
        runs.append({"tree": tree, "kernels": res})
        print(f"{tree}: {json.dumps(res)}", flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    median = {}
    for name, tree in (("other", other), ("this", ROOT)):
        mine = [r["kernels"] for r in runs if r["tree"] == tree]
        median[name] = {n: {k: statistics.median(m[n][k] for m in mine)
                            for k in ("ms", "library_ms")}
                        for n in mine[0]}
    print(card)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "runs": runs, "median": median}, f,
                      indent=1)
    print(json.dumps(median))
    return 0


if __name__ == "__main__":
    sys.exit(main())
