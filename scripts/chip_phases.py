"""Run phases of ``chip_smoke.py`` alone on the card.

    python3 scripts/chip_phases.py [--seed N] [--out FILE] PHASE [...]

PHASE is ``shm`` or ``ha``. The kernels are built from the checkout
(``phase_build``), the flagship's parameters and AdamW step made from the
seed (the phases train three steps on them), each phase run in a data
directory of its own size (``pick_data_dir``), and with ``--out`` every
number written to FILE as JSON. A phase takes about a minute on the
card, the build and the model's init included.
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

PHASES = ("shm", "ha")


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
    for name in args.phases:
        need = cs.SHM_PHASE_BYTES if name == "shm" else cs.HA_PHASE_BYTES
        root = cs.pick_data_dir(need)
        try:
            if name == "shm":
                out[name] = cs.phase_shm(dev, root, args.seed, params, step,
                                         math.nan)
            else:
                out[name] = cs.phase_ha(dev, root, args.seed, params, step,
                                        {"batches_per_s": math.nan})
        finally:
            shutil.rmtree(root, ignore_errors=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1, default=str)
    print(f"chip_phases: {time.perf_counter() - t0:.1f}s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
