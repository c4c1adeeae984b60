#!/usr/bin/env python3
"""Phase ``ring`` of ``chip_smoke.py`` with the model's products made in
other ways, in turns on one card: the share of ``gpu/model.py::_mm`` in
the ring's step.

    python3 scripts/ring_mm_ab.py [--order bmm,local,plain,local,bmm]
                                  [--timeout 900] [--out FILE]

``bmm``: every product of activations [B, L, K] and a weight [K, N]
batched over B against the weight expanded, as ``_mm`` makes it under a
mesh with a ``seq`` axis. ``plain``: ``x @ w`` on the DTensors, which
DTensor propagates through the flattened [B·L, K] layout (torch 2.11
refuses it: the flatten of a split dimension). ``local``: ``x @ w`` on
the local tensors, one GEMM as without a mesh, wrapped back with the
placements DTensor's rule gives; right only on a mesh of one rank, where
every shard is the whole tensor, which is the phase's. Each run is a
process of its own (DTensor's caches cold in each) running
``phase_ring`` alone: three unsharded K3 steps, then three ring steps
on a (1, 1, 1) data x model x seq mesh. A run that fails or passes
``--timeout`` seconds is reported as such. Prints each run's step times
(ms), peak memory and losses, the card's name and power limit, and
last one JSON line of every run."""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_RUN = r"""
import json, os, sys
sys.path.insert(0, os.getcwd())
import torch
import chip_smoke as cs
from curvine_tpu_torch.gpu import model as tm
from torch.distributed.tensor import DTensor, Partial, Shard


def local_mm(x, w, mesh):
    if mesh is None:
        return x @ w
    assert mesh.size() == 1, "the local product is right on one rank only"
    # DTensor's rule: a column split of w splits the output's last dim,
    # a row split (x split alike) leaves it partial, else x's placement
    out = [Shard(2) if wp == Shard(1) else Partial() if wp == Shard(0)
           else xp for xp, wp in zip(x.placements, w.placements)]
    return DTensor.from_local(x.to_local() @ w.to_local(), mesh, out,
                              run_check=False)


tm._mm = {"bmm": lambda x, w, mesh: x @ w if mesh is None else torch.bmm(
              x, w.expand(x.shape[0], *w.shape)),
          "plain": lambda x, w, mesh: x @ w,
          "local": local_mm}[sys.argv[1]]
torch.backends.cuda.matmul.allow_tf32 = False
r = cs.phase_ring(torch.device("cuda", 0), 0)
print("RESULT " + json.dumps({k: r[k] for k in (
    "step_ms", "step_ms_k3", "peak_bytes", "losses", "losses_k3",
    "loss_abs_diff", "attention_max_abs_err")}))
"""


def run(variant: str, timeout: float) -> dict:
    t = time.perf_counter()
    try:
        out = subprocess.run([sys.executable, "-c", _RUN, variant], cwd=ROOT,
                             capture_output=True, text=True, timeout=timeout)
    except subprocess.TimeoutExpired:
        return {"variant": variant, "timed_out_s": timeout}
    for line in out.stdout.splitlines():
        if line.startswith("RESULT "):
            return {"variant": variant, "wall_s": time.perf_counter() - t,
                    **json.loads(line[len("RESULT "):])}
    err = [ln for ln in out.stderr.splitlines() if "Error" in ln]
    return {"variant": variant, "failed_exit": out.returncode,
            "error": err[-3:] if err else out.stderr[-1000:]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--order", default="bmm,local,plain,local,bmm")
    ap.add_argument("--timeout", type=float, default=900)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    runs = []
    for variant in args.order.split(","):
        r = run(variant, args.timeout)
        runs.append(r)
        print(json.dumps(r), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip())
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card.strip(), "runs": runs}, f, indent=1)
    print(json.dumps({"card": card.strip(), "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
