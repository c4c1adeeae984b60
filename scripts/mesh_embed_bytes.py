#!/usr/bin/env python3
"""Bytes each rank sends per train step for the embedding table's three
layouts under a ``("data", "model")`` mesh, at the flagship's shapes.

    python3 scripts/mesh_embed_bytes.py [--json]

The flagship (bench.py:1746-1755, ``chip_smoke.py``'s phase 6): vocab
32,000, d_model 2560, bf16, batch 16 x 1024, ``ce_chunk`` 2048, the
cross entropy's chunks recomputed in the backward. A rank's share of a
ring collective over n ranks of S bytes: (n - 1) / n * S for an
all-gather or a reduce-scatter, twice that for an all-reduce. Layouts:

- (a) the table gathered whole over ``model`` for the lookup and again
  for the loss (``gpu/model.py`` before ROADMAP C4 was closed);
- (b) the reference's: the lookup on each rank's column shard, then the
  activations all-gathered over ``model``; the unembedding on the column
  shard, its partial logits all-reduced over ``model`` in bf16 per chunk,
  in the forward and again in the recompute, and each chunk's hidden
  gradient all-gathered in the backward;
- (c) the table gathered whole once a step, shared by the lookup and the
  loss (``gpu/model.py`` now).

Each layout also all-reduces the table's gradient over ``data`` once, on
each rank's column shard. The position table and every other leaf move
the same bytes in the three layouts and are left out."""

from __future__ import annotations

import argparse
import json
import math

VOCAB, D_MODEL, BYTES = 32_000, 2560, 2        # bf16
BATCH, SEQ, CHUNK = 16, 1024, 2048
MESHES = [(1, 4), (2, 2)]                      # (data, model)


def gather(size: float, n: int) -> float:
    return (n - 1) / n * size


def reduce(size: float, n: int) -> float:
    return 2 * (n - 1) / n * size


def per_rank(nd: int, nm: int) -> dict:
    table = VOCAB * D_MODEL * BYTES
    grad = reduce(table / nm, nd)
    rows = BATCH // nd
    acts = rows * SEQ * D_MODEL * BYTES
    chunks = math.ceil(rows * (SEQ - 1) / CHUNK)
    logits = CHUNK * VOCAB * BYTES
    hidden = CHUNK * D_MODEL * BYTES
    return {
        "a": 2 * gather(table, nm) + grad,
        "b": gather(acts, nm) + 2 * chunks * reduce(logits, nm)
        + chunks * gather(hidden, nm) + grad,
        "c": gather(table, nm) + grad,
        "chunks": chunks,
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args()
    out = {f"{nd}x{nm}": per_rank(nd, nm) for nd, nm in MESHES}
    if args.json:
        print(json.dumps(out))
        return
    for mesh, r in out.items():
        best = min("abc", key=r.get)
        print(f"mesh (data, model) {mesh}: {r['chunks']} chunks a rank; "
              + ", ".join(f"({k}) {r[k] / 1e6:.2f} MB" for k in "abc")
              + f"; fewest: ({best})")


if __name__ == "__main__":
    main()
