"""Run phases of ``chip_smoke.py`` alone on the card.

    python3 scripts/chip_phases.py [--seed N] [--out FILE] PHASE [...]

PHASE is ``drain``, ``ec``, ``shm``, ``ha``, ``wire`` or ``trace``. The
kernels are built from the checkout (``phase_build``), the flagship's parameters and
AdamW step made from the seed (the phases train three steps on them),
each phase run in a data directory of its own size (``pick_data_dir``),
and with ``--out`` every number written to FILE as JSON. Each phase also
reports its port workers' heartbeats (``heartbeats``: per worker the
beats, the longest gap between two beats' starts and the longest beat, in
seconds), which a master's lost timeout is held against. A phase takes
about a minute on the card, the build and the model's init included.
"""

import argparse
import json
import math
import os
import shutil
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

PHASES = ("drain", "ec", "shm", "ha", "wire", "trace")
NEED = {"drain": cs.DRAIN_PHASE_BYTES, "ec": cs.EC_PHASE_BYTES,
        "shm": cs.SHM_PHASE_BYTES, "ha": cs.HA_PHASE_BYTES,
        "wire": cs.WIRE_PHASE_BYTES, "trace": cs.TRACE_PHASE_BYTES}
# worker id -> (start, seconds) of each heartbeat, this process's workers
BEATS: dict[int, list[tuple[float, float]]] = {}


def record_beats() -> None:
    """Time every port worker's ``heartbeat_once`` into BEATS."""
    from curvine_tpu_torch.worker.server import WorkerServer
    beat = WorkerServer.heartbeat_once

    async def timed(self):
        t = time.perf_counter()
        try:
            return await beat(self)
        finally:
            BEATS.setdefault(self.worker_id, []).append(
                (t, time.perf_counter() - t))
    WorkerServer.heartbeat_once = timed


def beats_since(t0: float) -> dict:
    out = {}
    for wid, beats in BEATS.items():
        starts = [t for t, _ in beats if t >= t0]
        if len(starts) > 1:
            out[wid] = {"beats": len(starts),
                        "max_gap_s": max(b - a for a, b in
                                         zip(starts, starts[1:])),
                        "max_beat_s": max(d for t, d in beats if t >= t0)}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="also write every measured number to this JSON file")
    ap.add_argument("phases", nargs="+", choices=PHASES)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_phases: no CUDA device is visible", file=sys.stderr)
        return 2
    from curvine_tpu_torch.gpu import model as tm
    t0 = time.perf_counter()
    card = cs.gpu_name_and_limit()
    print(card, flush=True)
    cs.phase_build()
    dev = torch.device("cuda", 0)
    cfg = cs._flagship()
    params = tm.init_params(torch.Generator(device=dev).manual_seed(
        args.seed), cfg, dev)
    step = tm.make_train_step(cfg, tm.make_optimizer(params))
    out = {"card": card}
    cs.count_writer_breaks()
    record_beats()
    for name in args.phases:
        root = cs.pick_data_dir(NEED[name])
        t_phase = time.perf_counter()
        try:
            if name in ("shm", "wire", "trace"):
                fn = {"shm": cs.phase_shm, "wire": cs.phase_wire,
                      "trace": cs.phase_trace}[name]
                out[name] = fn(dev, root, args.seed, params, step, math.nan)
            else:
                fn = {"drain": cs.phase_drain, "ec": cs.phase_ec,
                      "ha": cs.phase_ha}[name]
                out[name] = fn(dev, root, args.seed, params, step,
                               {"batches_per_s": math.nan})
        finally:
            shutil.rmtree(root, ignore_errors=True)
        out[name]["heartbeats"] = beats_since(t_phase)
        print(f"chip_phases: {name}: heartbeats by worker "
              f"{out[name]['heartbeats']}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1, default=str)
    print(f"chip_phases: {time.perf_counter() - t0:.1f}s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
