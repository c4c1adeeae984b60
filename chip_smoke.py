#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``curvine_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed N] [--out results.json]

Phases, each raising on a fault (the exit code is then non-zero):

1. build: compile every source of the port, all at once: the CUDA ones
   with ``nvcc`` (sm_90a), the host C++ one (crc32c) with ``c++``; each
   kernel's registers, spills and stack as ptxas reports them;
2. kernel: ``block_checksum`` on the card against its plain PyTorch
   version and the host hash at sizes from 1 byte to 64 MiB + 1, a bit
   flip and a word swap; its time at 64 MiB (CUDA events, median of 20,
   L2 flushed between launches) beside its bound and the plain version;
3. main path: 96 distinct 64 MiB blocks in the worker's on-disk layout,
   promoted with ``promote_block`` (media crc, device copy, kernel hash
   against host hash) into a 4 GiB S3-FIFO ``MultiHbmTier``: a hot set
   of 16 touched 3 times, then a one-touch scan of 80. Checks that every
   pin was verified by the kernel, that the tier spilled, that the hot
   set survived the scan, and that a corrupted device copy is caught and
   dropped. Measures mmap views → tier against a pinned 128 MiB buffer
   → device, interleaved;
4. feed: 8 int32 token shards of 64 MiB, files under a POSIX directory,
   through ``PosixTrainFeed`` at batch 32 x seq 8192, depth 2, over the
   whole epoch; every device batch must equal the host tokens;
4b. client: a cache of the JAX package's master, started alone as its
   own process (``scripts/card_cluster.py --workers 0``, the port's codec
   in place of ``msgpack``), and the port's own worker
   (``curvine_tpu_torch.worker.server.WorkerServer``, in this process on a
   thread with its own event loop: a mem tier on the same tmpfs, a 4 GiB
   device tier-0, 64 MiB blocks), which must be the master's only live
   worker, here and at the end of the run; every later phase's cluster
   traffic goes through it. 8 new shards of 64 MiB written through the
   port's ``CurvineClient`` (``write_token_shards``, one block each) and
   streamed through the client-backed ``GpuTrainFeed`` (short-circuit
   ``mmap_view``, prefetch advice to the master) at phase 4's batch;
   every device batch must equal the host tokens, and some bytes must
   come by short circuit; rates beside phase 4's, stage shares, bytes by
   each path, advise RPCs, write GiB/s (by short circuit); then one
   shard read twice through READ_BLOCK (received into the caller's
   buffer) with the short circuit off, byte-equal; then the shards are
   deleted;
4c. worker: the device tier-0 through the port's worker: 16 hot and 16
   cold files of one 64 MiB block written through the port's client by
   short circuit, one more with a byte of its block file flipped after
   the commit. Until the hot set is pinned, the hot set is read once
   through the client (its read-heat reports) and one promote cycle runs
   (at most 256 MiB a cycle, each pin verified by K1 on the card): 4
   cycles, 16 pins, every hot block and no cold one in the tier, K1
   launches equal to the pins, the corrupt block refused, counted and
   reported to the master; a cold block whose device copy is flipped after
   its H2D copy refused by K1 (one launch), counted and reported; autopin
   GiB/s beside phase 3's and each pin's split (map, media crc, host
   hash, H2D, K1); every pinned tensor equal to its file on the card; a
   tier-0 hit (``hbm_get`` and a device-to-device copy of the block)
   against the short-circuit read staged to the card, median of 16; HBM_PIN and
   HBM_UNPIN over the port's connection, the master's view of one
   ``hbm:0`` of 4 GiB between; a deleted file's device copy gone within
   10 heartbeats;
5. flash: the four K3 kernels (forward, di, dK/dV, dQ) on the card against
   their plain PyTorch versions, element by element and row by row
   (``flash_errors``), at the flagship's attention shape
   [16, 20, 1024, 128] bf16, causal, and at [1, 2, 128, 128],
   [2, 4, 2048, 128] and [3, 5, 384, 128]; each kernel's time at the
   flagship's shape (CUDA events, median of 20, L2 flushed) beside its
   bound, the plain version's and ``scaled_dot_product_attention``'s
   (di's: ``torch.linalg.vecdot(o, do)``, the library's formula; each a
   yardstick only);
6. train: the flagship 1.03 B-parameter transformer (bench.py's: vocab
   32,000, d_model 2560, 20 heads, 12 layers, d_ff 10,240, bf16, flash
   attention, chunked cross entropy) on one card at batch 16 x seq 1024:
   a cache-fed pass through the client-backed ``GpuTrainFeed`` from the
   same cluster (10 shards of one batch under ``/ds/train``; the next
   batch's fetch overlaps the step, one sync a step) and a synthetic
   pass on one fixed device tensor; step times,
   ``ingest_overlap_ratio``, tokens/s, MFU, peak memory, every loss,
   K3's share of the step; a profiler table of
   two steps; at batch 2 the loss and every gradient of the kernel path
   against the same model with its attention taken by the plain
   versions, and each layer's dQ, dK and dV against f64 dense
   attention; last, a float32 model at head_dim 128 with flash attention
   asked for, one layer forward at L 128: the gate admits it as the
   reference's does, and the kernels' argument check must refuse it
   before any launch (they take bf16 only), never dense in its place;
6b. ckpt: the flagship's parameters as phase 6 left them (99 tensors,
   1.92 GiB of bf16) saved with ``save_checkpoint`` through the port's
   client into the cluster, every byte by short circuit (SC_WRITE_OPEN:
   the worker is on this host), then loaded onto the card with
   ``distribute_checkpoint_to_device`` by short circuit and again with
   it off (READ_BLOCK received into the caller's buffer); each load bit
   for bit equal to the saved tensors, compared on the card through
   integer views, and the loss of one train batch from the loaded
   parameters equal to the saved ones' (K3's forward); save and load
   GiB/s beside phase 3's ``link_gibs``, the pinned ring's staging time;
7. vector: K2, the ADC scan, on the card against its plain version, bit
   for bit, at four shapes (the path's own among them) with planted
   out-of-range codes, both code layouts; its time at the path's shape
   beside its bound, the plain version's and ``embedding_bag``'s (a
   yardstick only). Then bench.py's headline ANN configuration at full
   size through the port's ``VectorTable`` on the port's client (the
   table in the cluster, by short circuit both ways): 500,000
   rows x 256 from a mixture of 1,024 Gaussians, an IVF-PQ index (nlist
   1024, pq_m 16, cap_pct 90), ``AnnServer.query_many`` (4,096 queries,
   batch 256, depth 4), 3,072 concurrent ``query()`` callers, flat IVF,
   the exact scan in float32 and bf16, recall@10 of both indexed paths
   against the exact scan (at least 0.9 each, scripts/perf_floor.json),
   and the PQ search of 64 queries with K2 against the same search with
   its ADC stage taken by the plain version (ids and scores equal); last,
   a small table compacted, its old row group deleted through the
   client's ``meta.delete``.

The kernel launch counts are set to 0 just before phase 3 and read just
after phase 4 (K1), again just before phase 4c's promote cycles and read
just after them (K1), again just before the two passes of phase 6 and read
just after them (K3), again just before phase 6b and read just after it
(K3's forward, twice a layer for the two losses, and no backward
kernel), and just before phase 7's ``query_many`` and read just after it
(K2, which must equal the ADC stages the search issued). The kernels
line gives K1's two counts summed (each held to its pins, the refused
device copies included) and phase 6's K3 counts. The port's worker and
the cluster are stopped, and the data directory removed, however the
run ends. Prints each phase's numbers, the card's name and power limit,
one JSON line of kernels, and last the line
``{"ok": true, "device": {...}}``. Exits non-zero, and prints no result,
where no CUDA device is visible or the port is not importable."""

from __future__ import annotations

import argparse
import asyncio
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np
import torch

MiB = 1 << 20
GiB = 1 << 30
BLOCK = 64 * MiB                   # worker block_size default
N_BLOCKS = 96
N_HOT = 16
TIER_BYTES = 4 * GiB
HBM_BYTES_PER_S = 3.35e12          # H100 SXM published memory rate
BF16_FLOP_PER_S = 989e12           # H100 SXM dense bf16 tensor-core peak
SIZES = [1, 3, 4, 262143, 262144, 262145, MiB + 13, BLOCK, BLOCK + 1]
SHARDS = 8
SHARD_BYTES = 64 * MiB
BATCH, SEQ = 32, 8192
# the flagship's first; [3, 5, 384, 128] has an odd B*H and three
# 128-row tiles, so diagonal tiles and partial walks run in every kernel
FLASH_SHAPES = [(16, 20, 1024, 128), (1, 2, 128, 128), (2, 4, 2048, 128),
                (3, 5, 384, 128)]
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 16, 1024, 8
CHECK_BATCH = 2                    # the full-width agreement check
# bench.py:1581-1693, the headline ANN configuration (docs/ann-serving.md)
VEC_ROWS, VEC_DIM, VEC_CENTERS, VEC_SIGMA = 500_000, 256, 1024, 0.25
VEC_INDEX = dict(nlist=1024, metric="cosine", iters=4, pq_m=16, cap_pct=90.0)
VEC_K, VEC_NPROBE, VEC_RERANK = 10, 8, 512
ANN_QUERIES, ANN_BATCH, ANN_DEPTH = 4096, 256, 4
SERVED_QUERIES, FLAT_QUERIES, SCAN_REPS, RECALL_QUERIES = 3072, 512, 8, 64
# K2 against its plain version: (Q, W, M, ksub); the path's own shape,
# (256, W of the run, 16, 256), is added by the phase
PQ_SHAPES = [(1, 1, 4, 16), (3, 1000, 8, 32), (16, 7777, 64, 256)]
HERE = os.path.dirname(os.path.abspath(__file__))
# the flagship's checkpoint: 1,028,323,840 bf16 parameters, 1.92 GiB
CKPT_PATH, CKPT_BYTES = "/ckpt/flagship", 2 * GiB
# the cluster's mem tier holds, without evicting: the client phase's
# shards, the checkpoint, the vector table, and 1 GiB for the rest (the
# train phase's shards, 768 KiB; the index; the compaction check; the
# block being written, which the worker reserves at its full size)
CLUSTER_TIER_BYTES = SHARDS * SHARD_BYTES + CKPT_BYTES \
    + VEC_ROWS * VEC_DIM * 4 + GiB
CLUSTER_START_S = 300
# the worker phase: a hot set and as many cold files of one 64 MiB block,
# and one more whose file is corrupted before its pin
WORKER_HOT = WORKER_COLD = 16
WORKER_PHASE_BYTES = (WORKER_HOT + WORKER_COLD + 1) * BLOCK
# the port's worker: its mem tier holds the cluster's data and the worker
# phase's; its device tier-0 is phase 3's size; heat of one read pass
# through the client is 2 (the open's probe and the read's report)
WORKER_TIER_BYTES = CLUSTER_TIER_BYTES + WORKER_PHASE_BYTES
WORKER_MIN_READS = 2
WORKER_HEARTBEAT_MS = 1000


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_name_and_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def event_ms(fn, reps: int, scratch: torch.Tensor, prep=None
             ) -> list[float]:
    """Per-call device times of ``fn`` (CUDA events); before each call,
    outside the timed span, ``prep()`` and an L2 flush (a 256 MiB write,
    five times the 50 MB L2)."""
    times = []
    for _ in range(reps):
        if prep is not None:
            prep()
        scratch.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return times


# ------------------------------------------------------------------ phases

def _kernel_name(mangled: str) -> str:
    """The function's own name out of an Itanium-mangled one: the
    shortest length-prefixed part that ends in ``_kernel`` (a length may
    follow other digits, and a hash in the namespace may look like one),
    with a template's arguments as mangled, else the whole."""
    found = []
    for m in re.finditer(r"\d+", mangled):
        for k in range(m.start(), m.end()):
            n = int(mangled[k:m.end()])
            cand = mangled[m.end():m.end() + n]
            if len(cand) == n and cand.endswith("_kernel"):
                targs = re.match(r"I(\w+?)E", mangled[m.end() + n:])
                found.append(cand + (f"<{targs.group(1)}>" if targs else ""))
    return min(found, key=len) if found else mangled


def ptxas_stats(log_text: str) -> dict:
    """Per kernel, what ``ptxas -v`` reports: registers, bytes of stack,
    spill stores and loads, static shared memory."""
    out, cur = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = out.setdefault(_kernel_name(m.group(1)), {
                "registers": None, "stack": 0, "spill_stores": 0,
                "spill_loads": 0, "smem": 0})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur["stack"], cur["spill_stores"], cur["spill_loads"] = map(
                int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(s.group(1)) if s else 0
    return out


def phase_build() -> dict:
    from curvine_tpu_torch.gpu import _build
    t0 = time.perf_counter()
    info = _build.build_all()
    secs = time.perf_counter() - t0
    ptxas = {}
    for name, i in sorted(info.items()):
        log(f"build: {name}: {i['seconds']:.2f}s")
        ptxas[name] = ptxas_stats(i["log"])
        for kern, st in ptxas[name].items():
            log(f"  ptxas: {kern}: {st['registers']} registers, "
                f"{st['spill_stores']} bytes spill stores, "
                f"{st['spill_loads']} bytes spill loads, {st['stack']} bytes "
                f"stack, {st['smem']} bytes static smem")
    log(f"build: all sources in {secs:.2f}s")
    return {"seconds": secs, "ptxas": ptxas}


def phase_kernel(rng: np.random.Generator, dev: torch.device) -> dict:
    from curvine_tpu_torch.gpu import cuda_ops as ops
    max_err = 0
    for n in SIZES:
        host = rng.integers(0, 256, n, dtype=np.uint8)
        t = torch.from_numpy(host).to(dev)
        k = ops.block_checksum(t)
        p = ops.block_checksum_torch(t)
        h = ops.block_checksum_host(host)
        max_err = max(max_err, abs(k - p), abs(k - h))
        if not k == p == h:
            raise AssertionError(f"size {n}: kernel {k:#010x} plain {p:#010x}"
                                 f" host {h:#010x}")
        if n > 8:
            # a 4-byte-aligned base that is not 16-byte aligned takes the
            # word-by-word path of the kernel
            k4 = ops.block_checksum(t[4:])
            h4 = ops.block_checksum_host(host[4:])
            if k4 != h4:
                raise AssertionError(f"size {n} at offset 4: kernel "
                                     f"{k4:#010x} host {h4:#010x}")
        log(f"kernel: {n:>9} B  hash {k:#010x}  kernel == plain == host")
    # sensitivity at the main path's size
    base = rng.integers(0, 256, BLOCK, dtype=np.uint8)
    t = torch.from_numpy(base).to(dev)
    h0 = ops.block_checksum(t)
    flipped = t.clone()
    flipped[1000] ^= 0xFF
    # the hash sees a swap of words i and j through the bits where their
    # index terms differ: words 0 and 127 differ in the 7 low bits, so the
    # swap goes unseen only where the two words agree there (1 in 128)
    swapped = t.clone()
    swapped[0:4], swapped[508:512] = t[508:512].clone(), t[0:4].clone()
    for what, v in (("bit flip", flipped), ("word swap", swapped)):
        hv = ops.block_checksum(v)
        if hv == h0 or hv != ops.block_checksum_host(v.cpu().numpy()):
            raise AssertionError(f"{what}: hash {hv:#010x} vs {h0:#010x}")
        log(f"kernel: {what} changes the hash ({h0:#010x} -> {hv:#010x})")
    # time at 64 MiB: the kernel alone (one launch into a zeroed output),
    # and the plain version as a whole call
    scratch = torch.empty(256 * MiB, dtype=torch.uint8, device=dev)
    out = torch.zeros(2, dtype=torch.int32, device=dev)

    kernel_ms = statistics.median(
        event_ms(lambda: ops.launch(t, out), 20, scratch, prep=out.zero_))
    plain_ms = statistics.median(
        event_ms(lambda: ops.block_checksum_torch(t), 20, scratch))
    bound_ms = BLOCK / HBM_BYTES_PER_S * 1e3
    host_t0 = time.perf_counter()
    for _ in range(3):
        ops.block_checksum_host(base)
    host_s = (time.perf_counter() - host_t0) / 3
    res = {"max_abs_err": max_err, "ms": kernel_ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "checksum_gibs": BLOCK / GiB / (kernel_ms
                                                                  / 1e3),
           "host_hash_gibs": BLOCK / GiB / host_s,
           "launches_in_phase": ops.block_checksum.launches}
    log(f"kernel: 64 MiB in {kernel_ms:.4f} ms, checksum_gibs "
        f"{res['checksum_gibs']:.1f} (bound {bound_ms:.4f} ms by "
        f"bytes, {bound_ms / kernel_ms:.1%} of it); plain version "
        f"{plain_ms:.4f} ms; host hash {res['host_hash_gibs']:.3f} GiB/s; "
        f"launches in this phase {res['launches_in_phase']}")
    return res


class _FlipDeviceCopy:
    """A tier whose device copies arrive with one byte flipped: the bytes
    pass the media crc and then diverge on the device."""

    def __init__(self, tier):
        self.tier = tier

    def put(self, block_id, data):
        arr = self.tier.put(block_id, data)
        arr[12345] ^= 0x01
        return arr

    def drop(self, block_id, evicted=False):
        self.tier.drop(block_id, evicted=evicted)


def pick_data_dir(need: int) -> str:
    shm = "/dev/shm"
    if os.path.isdir(shm):
        st = os.statvfs(shm)
        if st.f_bavail * st.f_frsize > need + GiB:
            return tempfile.mkdtemp(prefix="curvine-smoke-", dir=shm)
    return tempfile.mkdtemp(prefix="curvine-smoke-")


def phase_main(rng: np.random.Generator, dev: torch.device, root: str
               ) -> dict:
    from curvine_tpu_torch.gpu.cuda_ops import block_checksum_host
    from curvine_tpu_torch.gpu.hbm import HbmTier, MultiHbmTier
    from curvine_tpu_torch.common.errors import AbnormalData
    from curvine_tpu_torch.worker.blockfile import (
        block_path, crc_update, map_block)
    from curvine_tpu_torch.worker.promote import promote_block

    blocks = os.path.join(root, "mem")
    t0 = time.perf_counter()
    crcs = {}
    for bid in range(1, N_BLOCKS + 1):
        data = rng.integers(0, 1 << 64, BLOCK // 8, dtype=np.uint64)
        p = block_path(blocks, bid)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        data.tofile(p)
        crcs[bid] = zlib.crc32(data)
    log(f"main: wrote {N_BLOCKS} blocks of {BLOCK // MiB} MiB "
        f"({N_BLOCKS * BLOCK / GiB:.1f} GiB) in "
        f"{time.perf_counter() - t0:.1f}s")

    tier = MultiHbmTier(TIER_BYTES, devices=[dev], admission="s3fifo")
    hot = list(range(1, N_HOT + 1))
    scan = list(range(N_HOT + 1, N_BLOCKS + 1))

    def promote(bid):
        return promote_block(tier, bid, block_path(blocks, bid), 0, BLOCK,
                             crc=crcs[bid], crc_algo="crc32")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for bid in hot:
        promote(bid)
    for _ in range(3):
        for bid in hot:
            if tier.get(bid) is None:
                raise AssertionError(f"hot block {bid} missing")
    for bid in scan:
        promote(bid)
    torch.cuda.synchronize()
    promote_s = time.perf_counter() - t0
    pins = N_BLOCKS
    # a copy that passes the media crc and then diverges on the device
    try:
        promote_block(_FlipDeviceCopy(tier), 10_000,
                      block_path(blocks, hot[0] + 1), 0, BLOCK,
                      crc=crcs[hot[0] + 1], crc_algo="crc32")
    except AbnormalData as e:
        log(f"main: corrupted device copy caught: {e}")
    else:
        raise AssertionError("a corrupted device copy was promoted")
    pins += 1
    if 10_000 in tier:
        raise AssertionError("the corrupted block stayed in the tier")
    st = tier.stats()
    if st["spills"] <= 0:
        raise AssertionError(f"the tier never spilled: {st}")
    resident = [bid for bid in hot if bid in tier]
    if len(resident) != N_HOT:
        raise AssertionError(f"the scan spilled the hot set: "
                             f"{len(resident)}/{N_HOT} resident")
    # resident bytes equal the files
    for bid in (hot[0], scan[-1]):
        got = tier.get(bid)
        if got is None or not torch.equal(
                got.cpu(), torch.from_numpy(
                    np.fromfile(block_path(blocks, bid), dtype=np.uint8))):
            raise AssertionError(f"block {bid}: device bytes differ")
    log(f"main: {pins} pins ({N_BLOCKS} verified + 1 corrupted) in "
        f"{promote_s:.2f}s ({N_BLOCKS * BLOCK / GiB / promote_s:.3f} GiB/s "
        f"promoted); tier {st['blocks']} blocks, {st['used'] / GiB:.2f} "
        f"GiB used, spills {st['spills']}, scan_evicted "
        f"{st['scan_evicted']}, hot {len(resident)}/{N_HOT} resident")
    del tier

    # the raw rails: mmap views → tier, pinned buffer → device. The views
    # are mapped once, so the first read pass also faults their pages in
    views = [map_block(block_path(blocks, bid), 0, BLOCK) for bid in hot]
    link_buf = torch.from_numpy(
        rng.integers(0, 256, 128 * MiB, dtype=np.uint8)).pin_memory()
    link_dst = torch.empty(128 * MiB, dtype=torch.uint8, device=dev)

    def link_pass() -> float:
        torch.cuda.synchronize()
        t = time.perf_counter()
        link_dst.copy_(link_buf, non_blocking=True)
        torch.cuda.synchronize()
        return 128 * MiB / GiB / (time.perf_counter() - t)

    def read_pass() -> float:
        rt = HbmTier(len(views) * BLOCK, device=dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for i, v in enumerate(views):
            rt.put(i, v)
        torch.cuda.synchronize()
        return len(views) * BLOCK / GiB / (time.perf_counter() - t)

    link_pass()
    reads, links = [], []
    for _ in range(4):
        links.append(link_pass())
        reads.append(read_pass())
    crc_t = time.perf_counter()
    for v in views[:4]:
        crc_update("crc32", v)
    crc_gibs = 4 * BLOCK / GiB / (time.perf_counter() - crc_t)
    hh_t = time.perf_counter()
    for v in views[:4]:
        block_checksum_host(v)
    host_gibs = 4 * BLOCK / GiB / (time.perf_counter() - hh_t)
    res = {"pins": pins, "verified_pins": N_BLOCKS, "spills": st["spills"],
           "scan_evicted": st["scan_evicted"],
           "hot_resident": len(resident), "promote_s": promote_s,
           "promote_gibs": N_BLOCKS * BLOCK / GiB / promote_s,
           "read_gibs_into_device": max(reads), "link_gibs": max(links),
           "pipeline_vs_link": max(reads) / max(links),
           "read_passes_gibs": reads, "link_passes_gibs": links,
           "crc32_gibs": crc_gibs, "host_hash_gibs": host_gibs}
    log(f"main: read_gibs_into_device {res['read_gibs_into_device']:.3f} "
        f"link_gibs {res['link_gibs']:.3f} pipeline_vs_link "
        f"{res['pipeline_vs_link']:.3f} (best of 4 interleaved passes); "
        f"media crc32 {crc_gibs:.3f} GiB/s; host hash {host_gibs:.3f} GiB/s")
    return res


async def drive_feed(feed, expect: torch.Tensor, dev: torch.device
                     ) -> tuple[int, int, float]:
    """Drain a feed of [BATCH, SEQ] device batches, each compared on the
    card with its slice of ``expect``: (batches, tokens that differ,
    seconds)."""
    per_batch = BATCH * SEQ
    bad = torch.zeros((), dtype=torch.int64, device=dev)
    n = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    async for b in feed:
        if b.shape != (BATCH, SEQ) or b.device != dev:
            raise AssertionError(f"batch {n}: {b.shape} on {b.device}")
        ref = expect[n * per_batch:(n + 1) * per_batch].view(BATCH, SEQ)
        bad += (b != ref).sum()
        n += 1
    torch.cuda.synchronize()
    return n, int(bad), time.perf_counter() - t


def feed_stats(phase: str, n: int, secs: float, prof) -> dict:
    """A feed's rates and the profiler's stage shares, logged."""
    per_batch = BATCH * SEQ
    summary = prof.summary()
    snap = prof.snapshot()["stages"]
    res = {"batches": n, "batches_per_s": n / secs,
           "tokens_per_s": n * per_batch / secs,
           "gibs": n * per_batch * 4 / GiB / secs,
           "fractions": summary["fractions"],
           "stage_p50_ms": {k: v["p50"] * 1e3 for k, v in snap.items()},
           "stage_total_s": {k: v["total_s"] for k, v in snap.items()}}
    log(f"{phase}: {n} batches of {BATCH}x{SEQ} int32, all equal to the "
        f"host tokens, {res['batches_per_s']:.1f} batches/s "
        f"({res['gibs']:.3f} GiB/s)")
    for k in ("host_to_hbm", "input_wait", "compute_wait", "cache_fetch",
              "decode"):
        if k in snap:
            log(f"{phase}: {k:>12}: total {snap[k]['total_s']:.4f}s "
                f"p50 {snap[k]['p50'] * 1e3:.3f} ms "
                f"share {summary['fractions'][k]:.3f}")
    return res


def feed_tokens(rng: np.random.Generator) -> np.ndarray:
    return rng.integers(0, 50257, SHARDS * SHARD_BYTES // 4, dtype=np.int32)


def phase_feed(rng: np.random.Generator, dev: torch.device, root: str
               ) -> dict:
    from curvine_tpu_torch.gpu.loader import PosixTrainFeed, write_posix_shards
    tokens = feed_tokens(rng)
    shard_dir = os.path.join(root, "shards")
    write_posix_shards(shard_dir, tokens, SHARD_BYTES // 4)
    expect = torch.from_numpy(tokens).to(dev)
    n_expect = tokens.size // (BATCH * SEQ)

    async def run():
        feed = PosixTrainFeed(shard_dir, BATCH, SEQ, depth=2, device=dev)
        return await drive_feed(feed, expect, dev), feed.profiler

    (n, bad, secs), prof = asyncio.run(run())
    if n != n_expect or bad:
        raise AssertionError(f"feed: {n}/{n_expect} batches, {bad} tokens "
                             f"differ from the host tokens")
    return feed_stats("feed", n, secs, prof)


# ------------------------------------------------------------ the cluster

def start_cluster(root: str):
    """``scripts/card_cluster.py --workers 0`` in its own process: the JAX
    package's master alone, its control plane on the port's codec
    (``rpc/wirepack.py`` standing in for ``msgpack``); the port's worker
    (``PortWorker``) registers with it. Returns the process and its JSON
    line (master address, codec, native helpers); raises when the line
    does not come within CLUSTER_START_S."""
    import select
    err = open(os.path.join(root, "cluster.err"), "wb")
    proc = subprocess.Popen(
        [sys.executable, os.path.join(HERE, "scripts", "card_cluster.py"),
         "--base-dir", os.path.join(root, "cluster"), "--codec", "port",
         "--workers", "0"],
        cwd=HERE, stdout=subprocess.PIPE, stderr=err)
    err.close()
    ready, _, _ = select.select([proc.stdout], [], [], CLUSTER_START_S)
    line = proc.stdout.readline() if ready else b""
    if not line:
        stop_cluster(proc)
        with open(os.path.join(root, "cluster.err"), "rb") as f:
            tail = f.read()[-4000:].decode(errors="replace")
        raise RuntimeError(f"the cluster did not start (exit "
                           f"{proc.returncode}):\n{tail}")
    info = json.loads(line)
    log(f"client: master pid {info['pid']} serves at {info['master']}, "
        f"codec {info['codec']}, the package's C++ helpers "
        f"{'loaded' if info['native'] else 'missing'}")
    return proc, info


def stop_cluster(proc) -> None:
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    proc.stdout.close()


class PortWorker:
    """The port's ``WorkerServer`` in this process, on a thread with its
    own event loop (the phases' clients run their own loops and reach it
    over loopback TCP, and the worker phase takes device tensors from
    ``worker.hbm``): a mem tier of ``tier_bytes`` under ``root``, a device
    tier-0 of TIER_BYTES on ``dev``, 64 MiB blocks, no periodic promote
    cycle (the worker phase runs its cycles itself)."""

    def __init__(self, master: str, root: str, tier_bytes: int,
                 dev: torch.device):
        import threading
        from curvine_tpu_torch.common.conf import ClusterConf, TierConf
        from curvine_tpu_torch.worker.server import WorkerServer
        conf = ClusterConf()
        conf.client.master_addrs = [master]
        conf.client.block_size = BLOCK
        wc = conf.worker
        wc.hostname, wc.rpc_port = "127.0.0.1", 0
        wc.heartbeat_ms = WORKER_HEARTBEAT_MS
        wc.promote_interval_ms = 0
        wc.promote_min_reads = WORKER_MIN_READS
        wc.tiers = [TierConf(storage_type="mem",
                             dir=os.path.join(root, "worker", "mem"),
                             capacity=tier_bytes)]
        wc.hbm_capacity = TIER_BYTES
        self.conf = conf
        self.worker = WorkerServer(conf, devices=[dev])
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       name="port-worker", daemon=True)
        self.thread.start()
        self.call(self.worker.start())

    def call(self, coro, timeout: float = 600):
        """Run ``coro`` on the worker's loop and return its result."""
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(
            timeout)

    def stop(self) -> None:
        try:
            self.call(self.worker.stop(), timeout=120)
        finally:
            self.loop.call_soon_threadsafe(self.loop.stop)
            self.thread.join(timeout=60)
            if not self.thread.is_alive():
                self.loop.close()


async def live_workers(client) -> list[dict]:
    """The master's live workers (GET_MASTER_INFO), as wire dicts."""
    from curvine_tpu_torch.rpc.codes import RpcCode
    rep = await client.meta.call(RpcCode.GET_MASTER_INFO, {})
    return rep["info"]["live_workers"]


def await_port_worker(master: str, pw: PortWorker, timeout: float = 60
                      ) -> None:
    """Wait until the master lists exactly one live worker, the port's;
    raises otherwise."""
    async def run():
        async with port_client(master) as c:
            t = time.perf_counter()
            while True:
                live = await live_workers(c)
                if live or time.perf_counter() - t > timeout:
                    return live
                await asyncio.sleep(0.1)

    live = asyncio.run(run())
    ids = [w["address"]["worker_id"] for w in live]
    if ids != [pw.worker.worker_id]:
        raise AssertionError(f"the master's live workers are {ids}, not the "
                             f"port's worker {pw.worker.worker_id} alone")


def port_client(master: str, **client):
    from curvine_tpu_torch.client.unified import CurvineClient
    from curvine_tpu_torch.common.conf import ClusterConf
    conf = ClusterConf()
    conf.client.master_addrs = [master]
    for k, v in client.items():
        setattr(conf.client, k, v)
    return CurvineClient(conf)


def phase_client(rng: np.random.Generator, dev: torch.device, master: str,
                 posix: dict) -> dict:
    from curvine_tpu_torch.gpu.loader import GpuTrainFeed, write_token_shards
    tokens = feed_tokens(rng)
    expect = torch.from_numpy(tokens).to(dev)
    n_expect = tokens.size // (BATCH * SEQ)

    async def run():
        async with port_client(master) as c:
            t = time.perf_counter()
            paths = await write_token_shards(c, "/ds/feed", tokens,
                                             SHARD_BYTES // 4)
            write_s = time.perf_counter() - t
            written = dict(c.counters)
            feed = GpuTrainFeed(c, "/ds/feed", BATCH, SEQ, prefetch=True,
                                device=dev)
            fed = await drive_feed(feed, expect, dev)
            counters = {k: v - written.get(k, 0)
                        for k, v in c.counters.items()}
        # twice: the worker's first READ_BLOCK is its slowest
        raws, rb_s = [], []
        async with port_client(master, short_circuit=False) as c:
            for _ in range(2):
                t = time.perf_counter()
                raws.append(await c.read_all(paths[0]))
                rb_s.append(time.perf_counter() - t)
            rb_counters = dict(c.counters)
            # the shards are the hottest blocks the worker holds: gone,
            # they leave the worker phase's promote cycles to its own
            await c.meta.delete("/ds/feed", recursive=True)
        return paths, write_s, written, fed, feed.profiler, counters, raws, \
            rb_s, rb_counters

    paths, write_s, written, (n, bad, secs), prof, counters, raws, rb_s, \
        rb = asyncio.run(run())
    if len(paths) != SHARDS or n != n_expect or bad:
        raise AssertionError(f"client: {len(paths)} shards, {n}/{n_expect} "
                             f"batches, {bad} tokens differ from the host "
                             f"tokens")
    res = feed_stats("client", n, secs, prof)
    sc = counters.get("sc.bytes.read", 0)
    res.update({
        "write_s": write_s, "write_gibs": tokens.nbytes / GiB / write_s,
        "sc_bytes": sc, "read_block_bytes": counters.get(
            "read.zero_copy_bytes", 0),
        "advise_rpcs": counters.get("advise.rpcs", 0),
        "sc_bytes_written": written.get("sc.bytes.written", 0),
        "sc_write_fallbacks": written.get("sc.write.fallbacks", 0),
        "read_block_check_bytes": rb.get("read.zero_copy_bytes", 0),
        "read_block_gibs": SHARD_BYTES / GiB / rb_s[0],
        "read_block_again_gibs": SHARD_BYTES / GiB / rb_s[1],
        "posix_batches_per_s": posix["batches_per_s"],
        "posix_gibs": posix["gibs"]})
    if not all(np.array_equal(np.frombuffer(raw, dtype=np.int32),
                              tokens[:SHARD_BYTES // 4]) for raw in raws):
        raise AssertionError(f"client: {paths[0]} read through READ_BLOCK "
                             f"differs from the host tokens")
    if res["read_block_check_bytes"] != 2 * SHARD_BYTES:
        raise AssertionError(f"client: READ_BLOCK served "
                             f"{res['read_block_check_bytes']} bytes of "
                             f"{2 * SHARD_BYTES}")
    log(f"client: wrote {SHARDS} shards of {SHARD_BYTES // MiB} MiB through "
        f"the port's client in {write_s:.3f}s ({res['write_gibs']:.3f} "
        f"GiB/s; {res['sc_bytes_written']} bytes by short circuit, "
        f"{res['sc_write_fallbacks']} blocks over WRITE_BLOCK); the feed "
        f"read {sc} bytes by short circuit (mmap_view) "
        f"and {res['read_block_bytes']} by READ_BLOCK, sent "
        f"{res['advise_rpcs']} advise RPCs; {res['batches_per_s']:.1f} "
        f"batches/s ({res['gibs']:.3f} GiB/s) against phase 4's POSIX "
        f"{posix['batches_per_s']:.1f} batches/s ({posix['gibs']:.3f} "
        f"GiB/s) on this machine")
    log(f"client: with short circuit off, {paths[0]} read twice through "
        f"READ_BLOCK into the caller's buffer, byte-equal, in "
        f"{rb_s[0]:.3f}s ({res['read_block_gibs']:.3f} GiB/s, the worker's "
        f"first READ_BLOCK) and {rb_s[1]:.3f}s "
        f"({res['read_block_again_gibs']:.3f} GiB/s)")
    if sc == 0:
        raise AssertionError("client: no byte came through the short "
                             "circuit, the path this phase drives")
    if res["sc_bytes_written"] != tokens.nbytes:
        raise AssertionError(f"client: {res['sc_bytes_written']} of "
                             f"{tokens.nbytes} bytes written by short "
                             f"circuit to a worker on this host")
    return res


# ------------------------------------------------------------------ worker

def _timed(fn, into: list):
    """``fn`` with each call's seconds appended to ``into``."""
    def timed(*a, **kw):
        t = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            into.append(time.perf_counter() - t)
    return timed


def phase_worker(rng: np.random.Generator, dev: torch.device, master: str,
                 pw: PortWorker, promote_gibs: float) -> dict:
    """The device tier-0 through the port's worker: 16 hot and 16 cold
    files of one 64 MiB block written through the port's client by short
    circuit, and one more whose block file gets one byte flipped after its
    commit. Until the hot set is pinned: the hot set read once through the
    client, then one promote cycle (at most 256 MiB pinned a cycle, each
    pin verified by K1 on the card). Then a device copy flipped after its
    H2D copy, refused by K1; the pinned tensors against the files; a
    tier-0 hit against the short-circuit read staged to the card;
    HBM_PIN / HBM_UNPIN over the port's connection with the master's view
    between, the refused corrupt block, and a delete's device copy gone
    within 10 heartbeats."""
    from curvine_tpu_torch.gpu import cuda_ops
    from curvine_tpu_torch.gpu.ingest import DeviceCopier
    from curvine_tpu_torch.rpc.client import Connection
    from curvine_tpu_torch.rpc.codes import RpcCode
    from curvine_tpu_torch.rpc.frame import pack
    from curvine_tpu_torch.worker import promote, server
    w = pw.worker
    hot = [f"/worker/hot-{i:02d}" for i in range(WORKER_HOT)]
    cold = [f"/worker/cold-{i:02d}" for i in range(WORKER_COLD)]
    bad = "/worker/corrupt"
    res = {}
    # the client phase's shards, deleted at its end, leave on a heartbeat
    for _ in range(10):
        if not w.store.hot_blocks(WORKER_MIN_READS):
            break
        pw.call(w.heartbeat_once())
    else:
        raise AssertionError(f"worker: blocks already hot before the phase: "
                             f"{w.store.hot_blocks(WORKER_MIN_READS)[:4]}")

    async def setup():
        async with port_client(master) as c:
            ids = {}
            t = time.perf_counter()
            for p in hot + cold + [bad]:
                await c.write_all(p, rng.integers(0, 1 << 64, BLOCK // 8,
                                                  dtype=np.uint64))
                fb = await c.meta.get_block_locations(p)
                ids[p] = fb.block_locs[0].block.id
            return ids, time.perf_counter() - t, dict(c.counters)

    ids, write_s, wrote = asyncio.run(setup())
    n_files = len(ids)
    if wrote.get("sc.bytes.written") != n_files * BLOCK:
        raise AssertionError(f"worker: {wrote} for {n_files} blocks")
    # one byte of the corrupt block's file, after its commit, before a pin
    bad_id = ids[bad]
    with open(w.store.get(bad_id, touch=False).path, "r+b") as f:
        f.seek(BLOCK // 3)
        b = f.read(1)
        f.seek(BLOCK // 3)
        f.write(bytes([b[0] ^ 0x40]))

    async def heat_pass(first: bool) -> None:
        async with port_client(master) as c:
            for p in hot:
                await c.read_all(p)
            if first:
                # heat for the corrupt block as a client reports it, above
                # the hot set's so the first cycle tries it first
                conn = await Connection(w.addr).connect()
                try:
                    await conn.call(RpcCode.SC_READ_REPORT, data=pack(
                        {"block_reads": {bad_id: WORKER_MIN_READS + 1}}))
                finally:
                    await conn.close()

    # each pin's split, timed inside promote_block: the map, the media
    # crc, the host hash, H2D (the put, then its stream synchronised), K1
    # (the launch and the result's read)
    split = {"map": [], "media_crc": [], "host_hash": [], "h2d": [],
             "k1": []}
    real = {n: getattr(promote, n) for n in
            ("map_block", "crc_update", "block_checksum",
             "block_checksum_host")}
    real_put = w.hbm.put

    def h2d_put(block_id, data, device=None):
        t = time.perf_counter()
        out = real_put(block_id, data, device)
        torch.cuda.current_stream(out.device).synchronize()
        split["h2d"].append(time.perf_counter() - t)
        return out

    promote.map_block = _timed(real["map_block"], split["map"])
    promote.crc_update = _timed(real["crc_update"], split["media_crc"])
    promote.block_checksum_host = _timed(real["block_checksum_host"],
                                         split["host_hash"])
    promote.block_checksum = _timed(real["block_checksum"], split["k1"])
    w.hbm.put = h2d_put
    hot_ids = [ids[p] for p in hot]
    cycle_s, read_s = [], []
    try:
        cuda_ops.block_checksum.launches = 0
        while not all(w.hbm_holds(b) for b in hot_ids) and len(cycle_s) < 8:
            t = time.perf_counter()
            asyncio.run(heat_pass(not cycle_s))
            read_s.append(time.perf_counter() - t)
            t = time.perf_counter()
            pw.call(w._promote_once())
            cycle_s.append(time.perf_counter() - t)
        launches = cuda_ops.block_checksum.launches
    finally:
        for n, fn in real.items():
            setattr(promote, n, fn)
        del w.hbm.put
    counters = dict(w.metrics.counters)
    pins = counters.get("blocks.hbm_pinned", 0)
    pinned_bytes = pins * BLOCK
    res.update(files=n_files, write_s=write_s,
               write_gibs=n_files * BLOCK / GiB / write_s, cycles=len(cycle_s),
               cycle_s=cycle_s, read_pass_s=read_s, pins=pins,
               pinned_bytes=pinned_bytes, k1_launches=launches,
               autopin_gibs=pinned_bytes / GiB / sum(cycle_s),
               promote_gibs=promote_gibs,
               corrupt=counters.get("blocks.corrupt", 0),
               corrupt_reported=counters.get("blocks.corrupt_reported", 0),
               split_ms={k: [x * 1e3 for x in v] for k, v in split.items()},
               split_median_ms={k: statistics.median(v) * 1e3
                                for k, v in split.items() if v})
    log(f"worker: wrote {n_files} blocks of 64 MiB through the port's "
        f"client in {write_s:.3f}s ({res['write_gibs']:.3f} GiB/s, all by "
        f"short circuit); {len(cycle_s)} promote cycles pinned {pins} "
        f"blocks ({pinned_bytes / GiB:.2f} GiB) in {sum(cycle_s):.3f}s: "
        f"autopin_gibs {res['autopin_gibs']:.3f} against phase 3's "
        f"promote_gibs {promote_gibs:.3f} on this machine; K1 launches "
        f"{launches}; read passes {sum(read_s):.3f}s")
    sm = res["split_median_ms"]
    log(f"worker: a pin's split, median ms: map {sm['map']:.3f}, media crc "
        f"{sm['media_crc']:.2f}, host hash {sm['host_hash']:.2f}, H2D "
        f"{sm['h2d']:.2f}, K1 {sm['k1']:.3f}")
    missing = [b for b in hot_ids if not w.hbm_holds(b)]
    cold_pinned = [ids[p] for p in cold if w.hbm_holds(ids[p])]
    if missing or cold_pinned or pins != WORKER_HOT \
            or len(cycle_s) != -(-WORKER_HOT * BLOCK // server.PIN_BUDGET):
        raise AssertionError(f"worker: {len(cycle_s)} cycles, {pins} pins, "
                             f"hot missing {missing}, cold pinned "
                             f"{cold_pinned}")
    if launches != pins or len(split["k1"]) != pins:
        raise AssertionError(f"worker: {launches} K1 launches for {pins} "
                             f"pins")
    if w.hbm_holds(bad_id) or res["corrupt"] != 1 \
            or res["corrupt_reported"] != 1:
        raise AssertionError(f"worker: the corrupt block: in the tier "
                             f"{w.hbm_holds(bad_id)}, counted "
                             f"{res['corrupt']}, reported "
                             f"{res['corrupt_reported']}")
    log(f"worker: every hot block in the tier-0, no cold one; the corrupt "
        f"block refused by its media crc, counted (blocks.corrupt "
        f"{res['corrupt']}) and reported to the master")

    # a good media copy whose device copy diverges after the H2D copy:
    # refused by K1 on the card, on the worker's own promotion
    flip_id = ids[cold[1]]

    def flip_put(block_id, data, device=None):
        out = real_put(block_id, data, device)
        if block_id == flip_id:
            out[BLOCK // 5] ^= 0x01
        return out

    w.hbm.put = flip_put
    try:
        cuda_ops.block_checksum.launches = 0
        flip_pinned = pw.call(w._autopin_block(flip_id))
        flip_launches = cuda_ops.block_checksum.launches
    finally:
        del w.hbm.put
    after = dict(w.metrics.counters)
    if flip_pinned or flip_launches != 1 or w.hbm_holds(flip_id) \
            or after.get("blocks.corrupt") != res["corrupt"] + 1 \
            or after.get("blocks.corrupt_reported") != \
            res["corrupt_reported"] + 1 \
            or after.get("blocks.hbm_pinned") != pins:
        raise AssertionError(f"worker: the diverging device copy: pinned "
                             f"{flip_pinned} bytes, K1 launches "
                             f"{flip_launches}, in the tier "
                             f"{w.hbm_holds(flip_id)}, counters {after}")
    res.update(k1_refused_launches=flip_launches,
               k1_launches=launches + flip_launches)
    log(f"worker: a device copy flipped after its H2D copy refused by K1 "
        f"({flip_launches} launch), counted (blocks.corrupt "
        f"{after['blocks.corrupt']}) and reported; not pinned")

    # the pinned tensors against the files, on the card, as integers
    for bid in hot_ids:
        got = w.hbm_get(bid)
        ref = torch.from_numpy(np.fromfile(
            w.store.get(bid, touch=False).path, dtype=np.uint8)).to(dev)
        if not torch.equal(got.view(torch.int64), ref.view(torch.int64)):
            raise AssertionError(f"worker: block {bid}: device bytes differ")
    del ref

    # a tier-0 hit against the short-circuit read staged to the card
    hit_bid, hit_path = hot_ids[0], hot[0]

    dst = torch.empty(BLOCK, dtype=torch.uint8, device=dev)

    def hit(use: bool) -> float:
        """The tier's lookup alone, or with a first use that moves every
        byte: a device-to-device copy of the block."""
        torch.cuda.synchronize()
        t = time.perf_counter()
        got = w.hbm_get(hit_bid)
        if use:
            dst.copy_(got)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    async def staged():
        copier = DeviceCopier(dev)
        fetch, stage = [], []
        async with port_client(master) as c:
            r = await c.open(hit_path)
            try:
                for _ in range(16):
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    view = await r.mmap_view(0, BLOCK)
                    t1 = time.perf_counter()
                    out = copier.deliver(copier.transfer(view))
                    torch.cuda.synchronize()
                    fetch.append(t1 - t)
                    stage.append(time.perf_counter() - t1)
            finally:
                await r.close()
        return fetch, stage, out

    lookups = [hit(False) for _ in range(16)]
    hits = [hit(True) for _ in range(16)]
    if not torch.equal(dst.view(torch.int64),
                       w.hbm_get(hit_bid).view(torch.int64)):
        raise AssertionError("worker: the tier-0 hit's copy differs")
    fetch, stage, out = asyncio.run(staged())
    if not torch.equal(out.view(torch.int64),
                       w.hbm_get(hit_bid).view(torch.int64)):
        raise AssertionError("worker: the staged block differs from the "
                             "tier-0's")
    del out, dst
    res.update(hit_ms=statistics.median(hits) * 1e3,
               lookup_ms=statistics.median(lookups) * 1e3,
               cache_fetch_ms=statistics.median(fetch) * 1e3,
               host_to_hbm_ms=statistics.median(stage) * 1e3,
               staged_ms=statistics.median(
                   [a + b for a, b in zip(fetch, stage)]) * 1e3)
    log(f"worker: a 64 MiB block from the tier-0 in {res['hit_ms']:.4f} ms "
        f"(hbm_get and a device-to-device copy of the block, median of 16; "
        f"the lookup alone {res['lookup_ms']:.4f} ms) against "
        f"{res['staged_ms']:.3f} ms by short circuit and staging "
        f"(cache_fetch {res['cache_fetch_ms']:.3f} + host_to_hbm "
        f"{res['host_to_hbm_ms']:.3f})")

    async def rpc_and_master():
        cold_id = ids[cold[0]]
        conn = await Connection(w.addr).connect()
        try:
            rep = (await conn.call(RpcCode.HBM_PIN, data=pack(
                {"block_id": cold_id}))).header
            if rep["len"] != BLOCK or rep["holders"] != [0] \
                    or not w.hbm_holds(cold_id):
                raise AssertionError(f"worker: HBM_PIN answered {rep}")
            await asyncio.wrap_future(asyncio.run_coroutine_threadsafe(
                w.heartbeat_once(), pw.loop))
            async with port_client(master) as c:
                live = await live_workers(c)
            hbm = [s for x in live for s in x["storages"]
                   if s["storage_type"] == -1]
            if [x["address"]["worker_id"] for x in live] != [w.worker_id] \
                    or [(s["dir_id"], s["capacity"]) for s in hbm] != \
                    [("hbm:0", TIER_BYTES)]:
                raise AssertionError(f"worker: the master sees {live}")
            await conn.call(RpcCode.HBM_UNPIN, data=pack(
                {"block_id": cold_id}))
            if w.hbm_holds(cold_id):
                raise AssertionError("worker: HBM_UNPIN left the copy")
            return hbm[0]
        finally:
            await conn.close()

    res["master_hbm_storage"] = asyncio.run(rpc_and_master())
    log(f"worker: HBM_PIN of a cold block over the port's connection: len "
        f"{BLOCK}, holders [0]; the master lists the port's worker alone, "
        f"with {res['master_hbm_storage']}; HBM_UNPIN dropped the copy")

    async def delete():
        async with port_client(master) as c:
            await c.meta.delete(hot[1])
        for k in range(1, 11):
            await asyncio.wrap_future(asyncio.run_coroutine_threadsafe(
                w.heartbeat_once(), pw.loop))
            if not w.hbm_holds(hot_ids[1]):
                return k
        return None

    beats = asyncio.run(delete())
    if beats is None or w.store.contains(hot_ids[1]):
        raise AssertionError("worker: a deleted block's device copy stayed "
                             "10 heartbeats")
    res["delete_heartbeats"] = beats
    log(f"worker: {hot[1]} deleted through the port's client; its device "
        f"copy gone after {beats} heartbeat(s)")
    return res


# K3 against its plain version. The plain version rounds P to bf16 after
# normalising it, the forward kernel before (against a running maximum),
# and both round their f32 sums, taken in other orders, to bf16. So an
# element may be off by the rounding of its own value (2 bf16 ulps of
# it) plus a sum of small rounding differences of P (and dS) that scales
# with its row, not with the element: near zero an element has no ulps
# to spare. The floor is FLASH_ROW_FLOOR_ULPS bf16 ulps of its row's
# scale: the median magnitude of the row (a query row of o and dq, a key
# row of dk and dv), or of the whole tensor where that is larger, since
# a row may be nothing but rounding (dQ's first row is exactly 0: dS of
# a row sums to 0 and that row has one key). A row as a whole, against
# its norm or the median row norm where that is larger, and the whole
# tensor must agree to FLASH_ROW_REL and FLASH_REL in relative norm: a
# kernel that drops or mis-scales a tile moves whole rows. lse is f32,
# sums of up to L exponentials in another order and __expf's few-ulp
# error: 1e-4 at |lse| <= 20. di is f32, a sum of L products P dP: 1e-4
# of its own magnitude plus 1e-4 of the median one.
FLASH_ELEM_ULPS = 2
FLASH_ROW_FLOOR_ULPS = 8
FLASH_ROW_REL = 1e-2
FLASH_REL = 1e-2
FLASH_LSE_ABS = 1e-4
FLASH_DI_REL = 1e-4


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp (8 significant bits) at each magnitude of ``x``."""
    _, e = torch.frexp(x.abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(x), e - 8)


def flash_pairs(q, k, v, do) -> dict:
    """Each K3 kernel's outputs beside its plain version's, in f32 from
    the same bf16 inputs, the same ``do`` and the same residuals (lse, di
    from the kernels)."""
    from curvine_tpu_torch.gpu import flash
    o, lse = flash.flash_fwd(q, k, v)
    di = flash.flash_bwd_di(q, k, v, do, lse)
    dk, dv = flash.flash_bwd_dkv(q, k, v, do, lse, di)
    dq = flash.flash_bwd_dq(q, k, v, do, lse, di)
    o_p, lse_p = flash.flash_fwd_plain(q, k, v)
    di_p = flash.flash_bwd_di_plain(q, k, v, do, lse)
    dq_p, dk_p, dv_p = flash.flash_bwd_plain(q, k, v, do, lse, di)
    return {"o": (o, o_p), "dk": (dk, dk_p), "dv": (dv, dv_p),
            "dq": (dq, dq_p), "lse": (lse, lse_p), "di": (di, di_p)}


def flash_errors(name: str, got: torch.Tensor, ref: torch.Tensor) -> dict:
    """How far ``got`` is from ``ref`` against the limits above:
    ``elem_ratio`` is the largest error over its element's tolerance and
    ``ok`` whether every limit holds."""
    g, r = got.float(), ref.float()
    err, mag = (g - r).abs(), r.abs()
    med = mag.median()
    if name == "lse":
        tol = torch.full_like(mag, FLASH_LSE_ABS)
    elif name == "di":
        tol = FLASH_DI_REL * (mag + med)
    else:
        row_scale = mag.median(dim=-1, keepdim=True).values.clamp_min(med)
        tol = (FLASH_ELEM_ULPS * _bf16_ulp(mag)
               + FLASH_ROW_FLOOR_ULPS * _bf16_ulp(row_scale))
    out = {"max_abs_err": err.max().item(), "max_abs_ref": mag.max().item(),
           "median_abs_ref": med.item(),
           "elem_ratio": (err / tol).max().item(),
           "rel": (err.norm() / r.norm()).item()}
    ok = out["elem_ratio"] <= 1.0
    if name in ("o", "dk", "dv", "dq"):
        norms = r.norm(dim=-1)
        out["row_rel"] = (err.norm(dim=-1) / norms.clamp_min(
            norms.median())).max().item()
        ok = ok and out["row_rel"] <= FLASH_ROW_REL and out["rel"] <= FLASH_REL
    out["ok"] = ok
    return out


def flash_bounds(shape) -> dict:
    """Each K3 kernel's least time on the card at ``shape``: the larger of
    its operations (the causal half: L(L+1)/2 query-key pairs a head, 2D
    FLOP a pair a product) over the bf16 peak, and its bytes (each input
    read once, each output written once) over the memory rate."""
    B, H, L, D = shape
    prod = 2 * D * B * H * L * (L + 1) / 2      # FLOP of one product
    t = B * H * L * D * 2                       # bytes of one bf16 operand
    r = B * H * L * 4                           # bytes of one f32 row vector
    work = {
        # S, P V; q, k, v in, o and lse out
        "flash_fwd": (2 * prod, 4 * t + r),
        # S, dP; q, k, v, do, lse in, di out
        "flash_bwd_di": (2 * prod, 4 * t + 2 * r),
        # S, dP, dV, dK; q, k, v, do, lse, di in, dk, dv out
        "flash_bwd_dkv": (4 * prod, 6 * t + 2 * r),
        # S, dP, dQ; q, k, v, do, lse, di in, dq out
        "flash_bwd_dq": (3 * prod, 5 * t + 2 * r),
    }
    out = {}
    for name, (flop, nbytes) in work.items():
        ops_ms = flop / BF16_FLOP_PER_S * 1e3
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        out[name] = {"flop": flop, "bytes": nbytes,
                     "bound_ms": max(ops_ms, bytes_ms),
                     "bound_by": "operations" if ops_ms >= bytes_ms
                     else "bytes"}
    return out


def phase_flash(dev: torch.device, seed: int) -> dict:
    import torch.nn.functional as F
    from curvine_tpu_torch.gpu import flash
    gen = torch.Generator(device=dev).manual_seed(seed)
    res = {"shapes": {}}
    main = None
    for shape in FLASH_SHAPES:
        q, k, v, do = (torch.randn(shape, generator=gen, device=dev)
                       .to(torch.bfloat16) for _ in range(4))
        pairs = flash_pairs(q, k, v, do)
        torch.cuda.synchronize()
        errs = {n: flash_errors(n, g, r) for n, (g, r) in pairs.items()}
        lse, di = pairs["lse"][0], pairs["di"][0]
        bad = {n: e for n, e in errs.items() if not e["ok"]}
        if bad:
            raise AssertionError(f"flash {shape}: kernel and plain version "
                                 f"disagree: {bad}")
        res["shapes"][str(list(shape))] = errs
        log(f"flash: {list(shape)} kernel vs plain: " + "; ".join(
            f"{n} max abs err {e['max_abs_err']:.3g} (|ref| median "
            f"{e['median_abs_ref']:.3g}, max {e['max_abs_ref']:.3g}), "
            f"worst element at {e['elem_ratio']:.3f} of its tolerance"
            + (f", worst row rel {e['row_rel']:.2e}" if "row_rel" in e
               else "") + f", rel {e['rel']:.2e}" for n, e in errs.items()))
        if main is None:
            main = (shape, q, k, v, do, pairs["o"][0], lse, di, errs)
        del pairs
    shape, q, k, v, do, o, lse, di, errs = main
    scratch = torch.empty(256 * MiB, dtype=torch.uint8, device=dev)

    def med(fn, prep=None):
        fn()
        torch.cuda.synchronize()
        return statistics.median(event_ms(fn, 20, scratch, prep=prep))

    fwd_ms = med(lambda: flash.flash_fwd(q, k, v))
    di_ms = med(lambda: flash.flash_bwd_di(q, k, v, do, lse))
    dkv_ms = med(lambda: flash.flash_bwd_dkv(q, k, v, do, lse, di))
    dq_ms = med(lambda: flash.flash_bwd_dq(q, k, v, do, lse, di))
    fwd_plain_ms = med(lambda: flash.flash_fwd_plain(q, k, v))
    di_plain_ms = med(lambda: flash.flash_bwd_di_plain(q, k, v, do, lse))
    bwd_plain_ms = med(lambda: flash.flash_bwd_plain(q, k, v, do, lse, di))
    # yardstick only: PyTorch's fused attention, forward, and its
    # backward (dq, dk, dv in one call) through autograd
    sdpa_fwd_ms = med(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True))
    qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
    out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
    sdpa_bwd_ms = med(lambda: torch.autograd.grad(
        out, (qg, kg, vg), do, retain_graph=True))
    # the library's di = rowsum(o * do) from the forward's bf16 o: too
    # coarse for dQ (PERF.md §6), a yardstick of speed only
    vecdot_ms = med(lambda: torch.linalg.vecdot(o, do, dim=-1))
    del out, qg, kg, vg, o, scratch
    bounds = flash_bounds(shape)
    err_of = {"flash_fwd": max(errs["o"]["max_abs_err"],
                               errs["lse"]["max_abs_err"]),
              "flash_bwd_di": errs["di"]["max_abs_err"],
              "flash_bwd_dkv": max(errs["dk"]["max_abs_err"],
                                   errs["dv"]["max_abs_err"]),
              "flash_bwd_dq": errs["dq"]["max_abs_err"]}
    timed = {"flash_fwd": (fwd_ms, fwd_plain_ms, sdpa_fwd_ms),
             "flash_bwd_di": (di_ms, di_plain_ms, vecdot_ms),
             "flash_bwd_dkv": (dkv_ms, bwd_plain_ms, sdpa_bwd_ms),
             "flash_bwd_dq": (dq_ms, bwd_plain_ms, sdpa_bwd_ms)}
    res["kernels"] = {}
    for name, (ms, plain_ms, lib_ms) in timed.items():
        b = bounds[name]
        res["kernels"][name] = {
            "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
            "max_abs_err": err_of[name], "flop": b["flop"],
            "bytes": b["bytes"], "tflops": b["flop"] / ms / 1e9}
        lib = "vecdot(o, do)" if name == "flash_bwd_di" else "sdpa"
        log(f"flash: {name} at {list(shape)}: {ms:.4f} ms "
            f"({b['flop'] / ms / 1e9:.1f} TFLOP/s), bound {b['bound_ms']:.4f}"
            f" ms by {b['bound_by']} ({b['bound_ms'] / ms:.1%} of it); "
            f"plain {plain_ms:.4f} ms; {lib} {lib_ms:.4f} ms")
    log("flash: the plain backward and sdpa's backward compute dq, dk and "
        "dv in one call: their time stands beside both backward kernels; "
        "di's yardstick is the library's formula, rowsum(o * do) from the "
        "bf16 o, not the function the kernel computes")
    return res


def _flagship():
    from curvine_tpu_torch.gpu.model import ModelConfig
    # bench.py:1751-1755
    return ModelConfig(vocab=32_000, d_model=2560, n_heads=20, n_layers=12,
                       d_ff=10_240, max_seq=1024, dtype="bfloat16",
                       use_flash_attention=True, ce_chunk=2048)


K3_NAMES = ("flash_fwd", "flash_bwd_di", "flash_bwd_dkv", "flash_bwd_dq")


def device_work(prof) -> tuple[list, float]:
    """Work on the card in a profile: kernels and copies, less CUPTI's
    "Command Buffer Full" spans (the host waiting on a full launch queue)
    and the device-side ranges of user annotations; and the busy time in
    microseconds, the union of their spans."""
    from torch.autograd import DeviceType
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not e.is_user_annotation and e.name != "Command Buffer Full"]
    busy_us, end = 0.0, None
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in kern):
        if end is None or a > end:
            busy_us += b - a
            end = b
        elif b > end:
            busy_us += b - end
            end = b
    return kern, busy_us


def flash_gate_check(dev: torch.device, seed: int) -> dict:
    """A float32 model at head_dim 128, flash attention asked for, one
    layer forward at L 128 on the card: the gate admits it, as the
    reference's does on the TPU, and the kernels' argument check refuses
    it (they take bf16 only) with a ValueError before any launch; it never
    runs quietly as dense attention. The same model with flash attention
    off runs dense, finite."""
    import dataclasses
    from curvine_tpu_torch.gpu import flash, model as tm
    cfg = tm.ModelConfig(vocab=128, d_model=256, n_heads=2, n_layers=1,
                         d_ff=512, max_seq=128, dtype="float32",
                         use_flash_attention=True)
    params = tm.init_params(torch.Generator(device=dev).manual_seed(seed),
                            cfg, dev)
    tok = torch.randint(0, cfg.vocab, (2, 128), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(
                            seed + 1), dtype=torch.int32)
    before = flash.flash_fwd.launches
    refused = ""
    with torch.no_grad():
        try:
            tm.forward(params, tok, cfg)
        except ValueError as e:
            refused = str(e)
        dense = tm.forward(params, tok, dataclasses.replace(
            cfg, use_flash_attention=False))
    torch.cuda.synchronize()
    ok = ("bf16" in refused and flash.flash_fwd.launches == before
          and tm._flash_eligible(cfg, 128, dev)
          and dense.shape == (2, 128, cfg.vocab)
          and bool(torch.isfinite(dense).all()))
    what = f"refused before any launch ({refused})" if ok else "FAILED"
    log(f"train: float32 head_dim 128 with flash attention asked for, one "
        f"layer at L 128: {what}; flash off: dense, logits "
        f"{tuple(dense.shape)}")
    if not ok:
        raise AssertionError(f"the flash path took or hid a float32 config "
                             f"(error {refused!r})")
    return {"refused": refused, "dense_shape": list(dense.shape)}


def train_tokens(cfg, seed: int) -> np.ndarray:
    """bench.py:1761-1763: batch·seq·(steps+2) tokens, one batch a shard."""
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, TRAIN_BATCH * TRAIN_SEQ * (TRAIN_STEPS + 2),
        dtype=np.int32)


def phase_train(dev: torch.device, master: str, seed: int, flash_res: dict
                ) -> tuple[dict, dict]:
    """The flagship trained on the card; returns its numbers and its
    parameters as the steps left them."""
    from torch.profiler import ProfilerActivity, profile
    from curvine_tpu_torch.gpu import flash, model as tm
    from curvine_tpu_torch.gpu.loader import GpuTrainFeed, write_token_shards
    cfg = _flagship()
    B, L, steps = TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS
    tokens = train_tokens(cfg, seed)

    async def write():
        async with port_client(master) as c:
            return await write_token_shards(c, "/ds/train", tokens,
                                            shard_tokens=B * L)

    n_shards = len(asyncio.run(write()))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = tm.init_params(torch.Generator(device=dev).manual_seed(seed),
                            cfg, dev)
    n_params = tm.n_params(params)
    opt = tm.make_optimizer(params)
    step = tm.make_train_step(cfg, opt)
    torch.cuda.synchronize()
    log(f"train: {n_params:,} parameters initialised on {dev} in "
        f"{time.perf_counter() - t0:.2f}s")
    D, Fd = cfg.d_model, cfg.d_ff
    expect = (cfg.vocab + cfg.max_seq + 1) * D + cfg.n_layers * (
        4 * D * D + 2 * D * Fd + 2 * D)         # 1,028,323,840
    if n_params != expect:
        raise AssertionError(f"{n_params} parameters, {expect} expected")

    async def timed_steps(batches):
        """bench.py:1777-1791: batch k+1's fetch and copy overlap step k
        (the step returns once its work is queued); one sync a step."""
        times, losses = [], []
        nxt = await anext(batches, None)
        while nxt is not None:
            t = time.perf_counter()
            loss = step(params, nxt)
            nxt = await anext(batches, None)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            losses.append(loss)
        return times, [float(x) for x in losses]

    async def cache_fed():
        async with port_client(master) as c:
            feed = GpuTrainFeed(c, "/ds/train", B, L, depth=2, device=dev)
            return feed.profiler, await timed_steps(feed.prefetcher), \
                c.counters.get("sc.bytes.read", 0)

    async def synthetic(tok, n):
        for _ in range(n):
            yield tok

    tok0 = torch.from_numpy(np.random.default_rng(seed + 5).integers(
        0, cfg.vocab, (B, L), dtype=np.int32)).to(dev)
    kernels = [getattr(flash, n) for n in K3_NAMES]
    for fn in kernels:
        fn.launches = 0
    feed_prof, (cache_times, cache_losses), sc_bytes = asyncio.run(
        cache_fed())
    synth_times, synth_losses = asyncio.run(timed_steps(synthetic(tok0,
                                                                  steps)))
    launches = {fn.__name__: fn.launches for fn in kernels}
    peak = torch.cuda.max_memory_allocated(dev)
    n_steps = len(cache_times) + len(synth_times)
    for name, n in launches.items():
        if n != cfg.n_layers * n_steps:
            raise AssertionError(f"{name} launched {n} times in {n_steps} "
                                 f"steps of {cfg.n_layers} layers")
    losses = cache_losses + synth_losses
    if len(cache_times) != steps + 2 or not all(map(math.isfinite, losses)):
        raise AssertionError(f"train: {len(cache_times)} cache-fed steps, "
                             f"losses {losses}")
    step_s = statistics.median(cache_times[1:])      # the first warms up
    synth_s = statistics.median(synth_times)
    tokens_per_step = B * L
    mfu = 6.0 * n_params * tokens_per_step / step_s / BF16_FLOP_PER_S
    k3_ms = sum(flash_res["kernels"][n]["ms"] for n in K3_NAMES)
    k3_share = cfg.n_layers * k3_ms / (step_s * 1e3)
    fractions = feed_prof.summary()["fractions"]
    res = {"params": n_params, "batch": B, "seq": L,
           "train_step_ms": step_s * 1e3, "train_step_synth_ms": synth_s * 1e3,
           "ingest_overlap_ratio": step_s / synth_s,
           "tokens_per_s": tokens_per_step / step_s, "mfu": mfu,
           "peak_bytes": peak, "losses_cache_fed": cache_losses,
           "losses_synthetic": synth_losses,
           "step_ms_cache_fed": [t * 1e3 for t in cache_times],
           "step_ms_synthetic": [t * 1e3 for t in synth_times],
           "launches": launches, "k3_share_of_step": k3_share,
           "feed_fractions": fractions, "shards": n_shards,
           "feed_sc_bytes": sc_bytes}
    if sc_bytes != tokens.nbytes:
        raise AssertionError(f"train: the client feed read {sc_bytes} of "
                             f"{tokens.nbytes} bytes by short circuit")
    log(f"train: cache-fed steps read {n_shards} shards of {B}x{L} int32 "
        f"through the port's client (/ds/train, {sc_bytes} bytes by short "
        f"circuit)")
    log(f"train: cache-fed step times ms "
        f"{[round(t * 1e3, 2) for t in cache_times]} (first dropped); "
        f"synthetic {[round(t * 1e3, 2) for t in synth_times]}")
    log(f"train: losses cache-fed {[round(x, 4) for x in cache_losses]}; "
        f"synthetic {[round(x, 4) for x in synth_losses]}")
    log(f"train: train_step_ms {res['train_step_ms']:.2f} "
        f"train_step_synth_ms {res['train_step_synth_ms']:.2f} "
        f"ingest_overlap_ratio {res['ingest_overlap_ratio']:.4f} "
        f"tokens_per_s {res['tokens_per_s']:.0f} mfu {mfu:.4f} (6 x "
        f"params x tokens / step / 989 TFLOP/s) peak "
        f"{peak / GiB:.2f} GiB; K3 launches {launches} in {n_steps} steps; "
        f"K3 share of the step {k3_share:.3f} ({cfg.n_layers} x "
        f"{k3_ms:.3f} ms / {step_s * 1e3:.2f} ms); feed input_wait "
        f"{fractions.get('input_wait', 0.0):.3f} host_to_hbm "
        f"{fractions.get('host_to_hbm', 0.0):.3f}")

    # where the step goes: two synthetic steps under the profiler
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(2):
            step(params, tok0)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t
    kern, busy_us = device_work(prof)
    k3_us = sum(e.time_range.elapsed_us() for e in kern
                if "flash_" in e.name)
    res["profile"] = {"wall_ms": wall_s * 1e3, "device_busy_ms": busy_us / 1e3,
                      "k3_device_ms": k3_us / 1e3, "device_events": len(kern)}
    if kern:
        log(f"train: profiler, 2 steps: wall {wall_s * 1e3:.1f} ms, device "
            f"kernels {busy_us / 1e3:.1f} ms (busy share "
            f"{busy_us / 1e3 / (wall_s * 1e3):.3f}), K3 {k3_us / 1e3:.1f} ms"
            f" ({k3_us / max(busy_us, 1):.3f} of device time)")
        for line in prof.key_averages().table(
                sort_by="self_device_time_total", row_limit=14,
                max_name_column_width=48).splitlines():
            log(f"  {line}")
    else:
        log("train: the profiler recorded no device time (not measured)")
    del prof, kern

    # the loss alone, forward and backward, on hidden states of the
    # flagship's batch: peak memory chunked (one [ce_chunk, V] f32 slice
    # of logits alive at a time) and one-shot (all B·(L-1) rows at once)
    x = torch.randn(B * (L - 1), cfg.d_model, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(seed)
                    ).to(torch.bfloat16).requires_grad_(True)
    targets = torch.from_numpy(tokens[:B * (L - 1)]).to(dev).long()
    ce_peak = {}
    for name, chunk in (("chunked", cfg.ce_chunk), ("one_shot", 0)):
        for p in tm.leaves(params):
            p.grad = None
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        loss = (tm._chunked_ce(x, targets, params["embed"], chunk) if chunk
                else tm._oneshot_ce(x, targets, params["embed"]))
        loss.backward()
        torch.cuda.synchronize()
        ce_peak[name] = torch.cuda.max_memory_allocated(dev) - base
        x.grad = None
        del loss
    res["ce_peak_bytes"] = ce_peak
    log(f"train: cross entropy of {B * (L - 1)} rows x {cfg.vocab} vocab, "
        f"forward and backward: peak {ce_peak['chunked'] / GiB:.3f} GiB "
        f"above its inputs in chunks of {cfg.ce_chunk}, "
        f"{ce_peak['one_shot'] / GiB:.3f} GiB one-shot")
    del x, targets

    # full width, batch 2: the kernel path against the plain versions
    check = torch.from_numpy(tokens[:CHECK_BATCH * L].reshape(
        CHECK_BATCH, L)).to(dev)
    leaves = tm.leaves(params)

    def loss_and_grads():
        for p in leaves:
            p.grad = None
        loss = tm.loss_fn(params, check, cfg)
        loss.backward()
        return loss.item(), [p.grad for p in leaves]

    real = tm.flash_attention
    seen = []                   # each layer's q, k, v and incoming do

    def recording(q, k, v, causal=True, sm_scale=None):
        o = real(q, k, v, causal, sm_scale)
        entry = [q.detach(), k.detach(), v.detach(), None]
        o.register_hook(lambda g: entry.__setitem__(3, g.contiguous()))
        seen.append(entry)
        return o

    before = [fn.launches for fn in kernels]
    tm.flash_attention = recording
    try:
        loss_k, grads_k = loss_and_grads()
    finally:
        tm.flash_attention = real
    if [fn.launches - b for fn, b in zip(kernels, before)] != \
            [cfg.n_layers] * len(kernels):
        raise AssertionError("the kernel path did not launch K3 once a layer")
    tm.flash_attention = flash.flash_attention_plain
    try:
        before = [fn.launches for fn in kernels]
        loss_p, grads_p = loss_and_grads()
        if [fn.launches for fn in kernels] != before:
            raise AssertionError("the plain path launched a kernel")
    finally:
        tm.flash_attention = real
    rel = abs(loss_k - loss_p) / abs(loss_p)
    cos = [torch.nn.functional.cosine_similarity(
        a.float().flatten(), b.float().flatten(), dim=0).item()
        for a, b in zip(grads_k, grads_p)]
    worst = min(range(len(cos)), key=cos.__getitem__)
    res["check"] = {"batch": CHECK_BATCH, "loss_kernel": loss_k,
                    "loss_plain": loss_p, "loss_rel_diff": rel,
                    "min_grad_cosine": cos[worst], "worst_leaf": worst,
                    "grad_cosines": cos}
    log(f"train: full-width check at batch {CHECK_BATCH}: loss kernel "
        f"{loss_k:.6f} plain {loss_p:.6f} (rel diff {rel:.2e}, limit 1e-3); "
        f"gradient cosine min {cos[worst]:.6f} (leaf {worst} of "
        f"{len(cos)}, limit 0.99)")
    if not rel <= 1e-3 or not cos[worst] >= 0.99:
        raise AssertionError(f"kernel path and plain path disagree: loss "
                             f"rel {rel}, gradient cosine {cos[worst]}")

    # each layer's dQ, dK and dV from the kernels (di the row sums of
    # P dP) against f64 dense attention on the same q, k, v and do
    from curvine_tpu_torch.gpu.attention import dense_attention
    cos64 = {"dq": [], "dk": [], "dv": []}
    for q, k, v, do in seen:
        _, lse = flash.flash_fwd(q, k, v)
        di = flash.flash_bwd_di(q, k, v, do, lse)
        got = {"dq": flash.flash_bwd_dq(q, k, v, do, lse, di)}
        got["dk"], got["dv"] = flash.flash_bwd_dkv(q, k, v, do, lse, di)
        q64, k64, v64 = (t.double().requires_grad_(True) for t in (q, k, v))
        dense_attention(q64, k64, v64).backward(do.double())
        for name, ref in (("dq", q64), ("dk", k64), ("dv", v64)):
            cos64[name].append(torch.nn.functional.cosine_similarity(
                got[name].double().flatten(), ref.grad.flatten(),
                dim=0).item())
        del lse, di, got, q64, k64, v64
    for name, cos_l in cos64.items():
        res[f"{name}_cosine_f64"] = cos_l
        log(f"train: {name} against f64 dense attention, layer by layer, at "
            f"batch {CHECK_BATCH}: cosine {[round(c, 5) for c in cos_l]} "
            f"(limit 0.99)")
    worst = {name: min(cos_l) for name, cos_l in cos64.items()}
    if not min(worst.values()) >= 0.99:
        raise AssertionError(f"gradients against f64: cosine {worst}")
    del seen
    for p in leaves:
        p.grad = None
    del grads_k, grads_p, leaves, opt, step
    torch.cuda.empty_cache()
    res["flash_gate"] = flash_gate_check(dev, seed)
    return res, params


# ------------------------------------------------------------ checkpoint

def _int_view(t: torch.Tensor) -> torch.Tensor:
    """``t``'s bits as integers of its width, for a comparison bit for
    bit (a float compare would call -0.0 and 0.0 equal, NaN unequal)."""
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return t.detach().reshape(-1).view(ints[t.element_size()])


def phase_ckpt(dev: torch.device, master: str, seed: int, params: dict,
               link_gibs: float) -> dict:
    """The flagship's parameters as the train phase left them, saved
    through the port's client into the cluster (every byte by short
    circuit: the worker is on this host) and loaded back onto the card
    twice with ``distribute_checkpoint_to_device``: by short circuit, and
    with it off (READ_BLOCK into the caller's buffer, the path of a host
    without a worker). Each load bit-equal to the saved tensors on the
    card; one forward loss of a train batch from the loaded parameters
    equal to the saved ones' (K3's forward, counted here)."""
    from curvine_tpu_torch.gpu import broadcast, flash, ingest, model as tm
    cfg = _flagship()
    saved = tm.leaves(params)
    nbytes = sum(t.nbytes for t in saved)
    batch = torch.from_numpy(train_tokens(cfg, seed)[
        :TRAIN_BATCH * TRAIN_SEQ].reshape(TRAIN_BATCH, TRAIN_SEQ)).to(dev)
    kernels = [getattr(flash, n) for n in K3_NAMES]

    def loss_of(p) -> torch.Tensor:
        with torch.no_grad():
            return tm.loss_fn(p, batch, cfg)

    # timed inside the save: each tensor's copy to the host; inside the
    # short-circuit load: the pinned ring's host side (np.copyto into the
    # ring's buffers and the copies' enqueue)
    real_leaf_bytes = broadcast._leaf_bytes
    real_transfer = ingest.DeviceCopier.transfer
    to_host, staging = [], []

    def timed_leaf_bytes(leaf):
        t = time.perf_counter()
        out = real_leaf_bytes(leaf)
        to_host.append(time.perf_counter() - t)
        return out

    def timed_transfer(self, raw):
        t = time.perf_counter()
        out = real_transfer(self, raw)
        staging.append(time.perf_counter() - t)
        return out

    async def load(short_circuit: bool):
        async with port_client(master, short_circuit=short_circuit) as c:
            torch.cuda.synchronize()
            t = time.perf_counter()
            got = await broadcast.distribute_checkpoint_to_device(
                c, CKPT_PATH, dev)
            torch.cuda.synchronize()
            return got, time.perf_counter() - t, dict(c.counters)

    async def run():
        async with port_client(master) as c:
            torch.cuda.synchronize()
            broadcast._leaf_bytes = timed_leaf_bytes
            try:
                t = time.perf_counter()
                await broadcast.save_checkpoint(c, CKPT_PATH, params)
                save_s = time.perf_counter() - t
            finally:
                broadcast._leaf_bytes = real_leaf_bytes
            save_counters = dict(c.counters)
        ingest.DeviceCopier.transfer = timed_transfer
        try:
            sc_load = await load(True)
        finally:
            ingest.DeviceCopier.transfer = real_transfer
        return save_s, save_counters, sc_load

    for fn in kernels:
        fn.launches = 0
    save_s, wrote, (loaded, sc_s, sc_counters) = asyncio.run(run())
    manifest_bytes = wrote.get("write.bytes", 0) - nbytes
    res = {"tensors": len(saved), "bytes": nbytes,
           "manifest_bytes": manifest_bytes, "save_s": save_s,
           "save_gibs": nbytes / GiB / save_s,
           "save_to_host_s": sum(to_host),
           "sc_bytes_written": wrote.get("sc.bytes.written", 0),
           "write_bytes": wrote.get("write.bytes", 0),
           "sc_write_fallbacks": wrote.get("sc.write.fallbacks", 0),
           "load_sc_s": sc_s, "load_sc_gibs": nbytes / GiB / sc_s,
           "load_sc_bytes": sc_counters.get("sc.bytes.read", 0),
           "load_sc_read_block_bytes": sc_counters.get(
               "read.zero_copy_bytes", 0),
           "staging_s": sum(staging), "staging_share": sum(staging) / sc_s,
           "link_gibs": link_gibs}
    log(f"ckpt: saved {len(saved)} tensors, {nbytes:,} bytes (+ a "
        f"{manifest_bytes:,}-byte manifest) through the port's client in "
        f"{save_s:.3f}s ({res['save_gibs']:.3f} GiB/s; the copies to the "
        f"host {res['save_to_host_s']:.3f}s of it); "
        f"{res['sc_bytes_written']:,} of {res['write_bytes']:,} bytes by "
        f"short circuit, {res['sc_write_fallbacks']} blocks over "
        f"WRITE_BLOCK")
    if res["sc_bytes_written"] != res["write_bytes"] or \
            res["sc_write_fallbacks"] or manifest_bytes <= 0:
        raise AssertionError("ckpt: the checkpoint did not go all by short "
                             "circuit to a worker on this host")

    def check(name: str, got: dict) -> None:
        back = tm.leaves(got)
        bad = [i for i, (a, b) in enumerate(zip(saved, back))
               if a.dtype != b.dtype or a.shape != b.shape
               or a.device != b.device
               or not torch.equal(_int_view(a), _int_view(b))]
        if len(back) != len(saved) or bad:
            raise AssertionError(f"ckpt: {name} load: {len(back)} tensors, "
                                 f"{len(bad)} not bit-equal ({bad[:5]})")

    check("short-circuit", loaded)
    loss_saved = loss_of(params)
    loss_loaded = loss_of(loaded)
    res["loss_saved"], res["loss_loaded"] = loss_saved.item(), \
        loss_loaded.item()
    del loaded
    log(f"ckpt: loaded onto {dev} by short circuit in {sc_s:.3f}s "
        f"({res['load_sc_gibs']:.3f} GiB/s against phase 3's link_gibs "
        f"{link_gibs:.3f}; {res['load_sc_bytes']:,} bytes by short "
        f"circuit, {res['load_sc_read_block_bytes']} by READ_BLOCK); "
        f"staging through the pinned ring on the event loop "
        f"{res['staging_s']:.3f}s ({res['staging_share']:.3f} of the "
        f"load); every tensor bit-equal on the card; loss of a "
        f"{TRAIN_BATCH}x{TRAIN_SEQ} train batch saved "
        f"{res['loss_saved']!r} loaded {res['loss_loaded']!r}")
    if not (torch.equal(loss_saved, loss_loaded)
            and math.isfinite(res["loss_saved"])):
        raise AssertionError("ckpt: the loaded parameters' loss differs")
    if res["load_sc_bytes"] != nbytes + manifest_bytes or \
            res["load_sc_read_block_bytes"]:
        raise AssertionError("ckpt: the short-circuit load did not read "
                             "every byte by short circuit")

    loaded, rb_s, rb_counters = asyncio.run(load(False))
    res.update(load_rb_s=rb_s, load_rb_gibs=nbytes / GiB / rb_s,
               load_rb_bytes=rb_counters.get("read.zero_copy_bytes", 0),
               load_rb_sc_bytes=rb_counters.get("sc.bytes.read", 0))
    check("READ_BLOCK", loaded)
    del loaded
    launches = {fn.__name__: fn.launches for fn in kernels}
    res["launches"] = launches
    log(f"ckpt: loaded onto {dev} with the short circuit off in "
        f"{rb_s:.3f}s ({res['load_rb_gibs']:.3f} GiB/s; "
        f"{res['load_rb_bytes']:,} bytes by READ_BLOCK into the caller's "
        f"buffer, {res['load_rb_sc_bytes']} by short circuit); every "
        f"tensor bit-equal on the card; K3 launches on this path "
        f"{launches}")
    if res["load_rb_bytes"] != nbytes + manifest_bytes or \
            res["load_rb_sc_bytes"]:
        raise AssertionError("ckpt: the READ_BLOCK load took another path")
    if launches != {"flash_fwd": 2 * cfg.n_layers, "flash_bwd_di": 0,
                    "flash_bwd_dkv": 0, "flash_bwd_dq": 0}:
        raise AssertionError(f"ckpt: K3 launches {launches} for two "
                             f"forward losses of {cfg.n_layers} layers")
    return res


# ------------------------------------------------------------------ vector

def pq_case(gen: torch.Generator, dev: torch.device, q: int, w: int, m: int,
            ksub: int, pre_offset: bool):
    """A random LUT [Q, M, ksub] and codes [Q, W, M] on the card, with
    planted out-of-range codes: -1, past the table, and (pre-offset) a
    code in the next subspace's range."""
    lut = torch.randn((q, m, ksub), generator=gen, device=dev)
    codes = torch.randint(0, ksub, (q, w, m), generator=gen, device=dev,
                          dtype=torch.int32)
    if pre_offset:
        codes += torch.arange(m, device=dev, dtype=torch.int32) * ksub
    codes[:, ::7, 0] = -1
    codes[:, 1::5, m - 1] = m * ksub + 3
    if m > 1:
        codes[:, 2::3, 1] += ksub
    return lut, codes


def pq_bit_check(lut, codes, pre_offset: bool) -> float:
    """K2 against its plain version on the same tensors: every float32
    bit equal (both add the same terms in the same order). Returns the
    largest absolute difference (0 when equal)."""
    from curvine_tpu_torch.gpu import pq
    got = pq.pq_lut_scan(lut, codes, pre_offset=pre_offset)
    ref = pq.pq_lut_scan_plain(lut, codes, pre_offset=pre_offset)
    torch.cuda.synchronize()
    if not torch.equal(got.view(torch.int32), ref.view(torch.int32)):
        bad = int((got.view(torch.int32) != ref.view(torch.int32)).sum())
        raise AssertionError(f"pq_lut_scan {tuple(lut.shape)} x "
                             f"{tuple(codes.shape)} pre_offset={pre_offset}:"
                             f" {bad} scores differ from the plain version "
                             f"(max abs {(got - ref).abs().max().item()})")
    return (got - ref).abs().max().item()


def pq_timing(lut, codes, dev: torch.device) -> dict:
    """K2 at the path's shape, on the search's own LUT and pre-offset
    codes: CUDA events, median of 20, L2 flushed before each launch;
    beside its bound, the plain version and one ``embedding_bag`` call
    on the same codes offset per query (computed outside the timing)."""
    import torch.nn.functional as F
    from curvine_tpu_torch.gpu import pq
    q, w, m = codes.shape
    ksub = lut.shape[2]
    scratch = torch.empty(256 * MiB, dtype=torch.uint8, device=dev)
    flat_idx = (codes + (torch.arange(q, device=dev, dtype=torch.int32)
                         * (m * ksub))[:, None, None]).view(q * w, m)
    table = lut.reshape(-1, 1)

    def med(fn):
        fn()
        torch.cuda.synchronize()
        return statistics.median(event_ms(fn, 20, scratch))

    ms = med(lambda: pq.pq_lut_scan(lut, codes, pre_offset=True))
    plain_ms = med(lambda: pq.pq_lut_scan_plain(lut, codes, pre_offset=True))
    lib_ms = med(lambda: F.embedding_bag(flat_idx, table, mode="sum"))
    lib = F.embedding_bag(flat_idx, table, mode="sum").view(q, w)
    got = pq.pq_lut_scan(lut, codes, pre_offset=True)
    lib_err = (lib - got).abs().max().item()
    nbytes = q * w * m * 4 + q * m * ksub * 4 + q * w * 4
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    del scratch
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "bytes": nbytes,
            "embedding_bag_max_abs_diff": lib_err}


def phase_vector(dev: torch.device, master: str, seed: int) -> dict:
    from torch.profiler import ProfilerActivity, profile
    from curvine_tpu_torch.common.errors import FileNotFound
    from curvine_tpu_torch.gpu import pq
    from curvine_tpu_torch.vector import AnnServer, VectorTable
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    res = {"pq_shapes": {}}
    max_err = 0.0
    for shape in PQ_SHAPES:
        for pre_offset in (False, True):
            max_err = max(max_err, pq_bit_check(
                *pq_case(gen, dev, *shape, pre_offset), pre_offset))
        res["pq_shapes"][str(list(shape))] = "bit-equal"
        log(f"vector: K2 {list(shape)} (Q, W, M, ksub), both code layouts, "
            f"planted out-of-range codes: bit-equal to the plain version")

    # bench.py:1587-1592: a mixture of 1,024 Gaussians, sigma 0.25
    centers = rng.standard_normal((VEC_CENTERS, VEC_DIM), dtype=np.float32)
    vecs = rng.standard_normal((VEC_ROWS, VEC_DIM), dtype=np.float32)
    vecs *= VEC_SIGMA
    vecs += centers[rng.integers(0, VEC_CENTERS, VEC_ROWS)]
    queries = vecs[rng.integers(0, VEC_ROWS, ANN_QUERIES)]

    def recall10(ann_i, exact_i) -> float:
        hits = sum(len(set(map(int, a)) & set(map(int, b)))
                   for a, b in zip(ann_i[:RECALL_QUERIES], exact_i))
        return hits / (RECALL_QUERIES * 10)

    async def compaction(client) -> None:
        """A small table's first row group deleted and compacted away:
        the port client's ``meta.delete`` of one row-group file."""
        small = vecs[:2000]
        t = await VectorTable.create(client, "/bench/compact", VEC_DIM)
        await t.append(small[:1000])
        await t.append(small[1000:])
        await t.delete(list(range(1000)))
        if await t.compact() != 1000 or t.row_groups != 1:
            raise AssertionError("vector: compaction kept the deleted rows")
        try:
            await client.meta.file_status("/bench/compact/rg-00001.vec")
            raise AssertionError("vector: compaction left its old row group")
        except FileNotFound:
            pass
        got, _ = await t.take([0, 999])
        if not np.array_equal(got, small[[1000, 1999]]):
            raise AssertionError("vector: compacted rows differ")
        res["compaction"] = "row group rg-00001.vec deleted, rows equal"

    async def run():
        async with port_client(master) as client:
            out = await serve(client)
            await compaction(client)
            res["client_counters"] = dict(client.counters)
        return out

    async def serve(client):
        t0 = time.perf_counter()
        table = await VectorTable.create(client, "/bench/vec", VEC_DIM)
        await table.append(vecs)
        res["append_s"] = time.perf_counter() - t0
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        await table.knn(vecs[0], k=8, device=dev)        # pin
        res["pin_s"] = time.perf_counter() - t0
        # the pinned tensors, and all that pinning and the first scan left
        # allocated (cuBLAS keeps its workspace in PyTorch's allocator)
        res["table_bytes_pinned"] = sum(
            t.nbytes for t in next(iter(table._dev_cache.values())))
        res["allocated_after_pin_bytes"] = \
            torch.cuda.memory_allocated(dev) - base
        # a stream of single-query scans, one sync at the end
        t0 = time.perf_counter()
        outs = [await table.knn(vecs[123 + i], k=8, device=dev,
                                materialize=False) for i in range(SCAN_REPS)]
        ids = outs[-1][0].cpu().numpy()
        res["vector_scan_mrows_s"] = SCAN_REPS * VEC_ROWS / (
            time.perf_counter() - t0) / 1e6
        if int(ids[0, 0]) != 123 + SCAN_REPS - 1:
            raise AssertionError(f"exact scan: top id {ids[0, 0]}")

        t0 = time.perf_counter()
        idx = await table.create_index(device=dev, **VEC_INDEX)
        torch.cuda.synchronize()
        res["vector_index_build_s"] = time.perf_counter() - t0
        cap = int(idx.lists.shape[1])
        res.update(list_cap=cap, nlist_total=idx.nlist_total,
                   width=VEC_NPROBE * cap)
        exact_i, _ = await table.knn(queries[:RECALL_QUERIES], k=10,
                                     device=dev, use_index=False)

        # the PQ search of 64 queries: K2 against the plain ADC stage,
        # passed in through the search's hook; and the path's own K2
        # inputs (the first 256 queries' LUT and codes) for the timing
        v, vid = await table._device_vectors("cosine", dev)
        kw = dict(k=VEC_K, metric="cosine", nprobe=VEC_NPROBE, device=dev,
                  rerank=VEC_RERANK)
        s_k, i_k = idx.search(queries[:64], v, vid, **kw)
        s_p, i_p = idx.search(queries[:64], v, vid, adc=pq.pq_lut_scan_plain,
                              **kw)
        if not (torch.equal(i_k, i_p) and torch.equal(s_k, s_p)):
            raise AssertionError("the PQ search with K2 and with its plain "
                                 "ADC stage disagree")
        seen = []

        def capture(lut, codes, pre_offset):
            seen.append((lut, codes))
            return pq.pq_lut_scan_plain(lut, codes, pre_offset)
        idx.search(queries[:ANN_BATCH], v, vid, adc=capture, **kw)
        del v, vid

        srv = await AnnServer(table, k=VEC_K, nprobe=VEC_NPROBE,
                              rerank=VEC_RERANK, device=dev,
                              max_batch=ANN_BATCH, warm_all=False).start()
        await srv.query_many(queries[:ANN_BATCH])          # warm
        pq.pq_lut_scan.launches = 0
        idx.adc_calls = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ann_i, _ = await srv.query_many(queries, batch=ANN_BATCH,
                                        depth=ANN_DEPTH)
        ann_s = time.perf_counter() - t0
        launches, adc_calls = pq.pq_lut_scan.launches, idx.adc_calls
        # where a batch goes: 4 batches of query_many under the profiler
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            await srv.query_many(queries[:4 * ANN_BATCH], batch=ANN_BATCH,
                                 depth=ANN_DEPTH)
            wall_s = time.perf_counter() - t0
        kern, busy_us = device_work(prof)
        k2_us = sum(e.time_range.elapsed_us() for e in kern
                    if "pq_scan" in e.name)
        res["profile"] = {"wall_ms": wall_s * 1e3,
                          "device_busy_ms": busy_us / 1e3,
                          "k2_device_ms": k2_us / 1e3,
                          "device_events": len(kern)}
        if kern:
            log(f"vector: profiler, query_many of {4 * ANN_BATCH}: wall "
                f"{wall_s * 1e3:.2f} ms, device busy {busy_us / 1e3:.2f} ms"
                f" (busy share {busy_us / 1e3 / (wall_s * 1e3):.3f}), K2 "
                f"{k2_us / 1e3:.3f} ms, {len(kern)} device events")
            for line in prof.key_averages().table(
                    sort_by="self_device_time_total", row_limit=12,
                    max_name_column_width=48).splitlines():
                log(f"  {line}")
        else:
            log("vector: the profiler recorded no device time "
                "(not measured)")
        del prof, kern
        await srv.stop()
        if not 0 < launches == adc_calls:
            raise AssertionError(f"query_many: {launches} K2 launches for "
                                 f"{adc_calls} ADC stages")
        res.update(vector_ann_qps=ANN_QUERIES / ann_s,
                   vector_ann_recall10=recall10(ann_i, exact_i),
                   k2_launches=launches, adc_calls=adc_calls)

        srv = await AnnServer(table, k=VEC_K, nprobe=VEC_NPROBE,
                              use_pq=False, device=dev, max_batch=ANN_BATCH,
                              warm_all=False).start()
        await srv.query_many(queries[:ANN_BATCH])          # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        flat_i, _ = await srv.query_many(queries[:FLAT_QUERIES],
                                         batch=ANN_BATCH, depth=ANN_DEPTH)
        res["vector_ann_flat_qps"] = FLAT_QUERIES / (time.perf_counter() - t0)
        res["vector_ann_flat_recall10"] = recall10(flat_i, exact_i)
        await srv.stop()

        srv = await AnnServer(table, k=VEC_K, nprobe=VEC_NPROBE,
                              rerank=VEC_RERANK, device=dev,
                              max_batch=ANN_BATCH, max_wait_ms=2.0).start()
        await asyncio.gather(*(srv.query(q) for q in queries[:ANN_BATCH]))
        t0 = time.perf_counter()
        served = await asyncio.gather(
            *(srv.query(q) for q in queries[:SERVED_QUERIES]))
        res["vector_ann_served_qps"] = SERVED_QUERIES / (
            time.perf_counter() - t0)
        st = srv.stats()
        res["vector_ann_batch_occupancy"] = st["batch_occupancy"]
        res["served_batches"] = st["batches"]
        await srv.stop()
        res["vector_ann_served_recall10"] = recall10(
            np.stack([i for i, _ in served]), exact_i)

        torch.cuda.synchronize()
        res["device_bytes_after_index"] = torch.cuda.memory_allocated(dev)
        await table.knn(vecs[0], k=8, device=dev, use_index=False,
                        dtype="bf16")                      # re-pin in bf16
        t0 = time.perf_counter()
        outs = [await table.knn(vecs[123 + i], k=8, device=dev,
                                use_index=False, materialize=False,
                                dtype="bf16") for i in range(SCAN_REPS)]
        ids = outs[-1][0].cpu().numpy()
        res["vector_scan_bf16_mrows_s"] = SCAN_REPS * VEC_ROWS / (
            time.perf_counter() - t0) / 1e6
        if int(ids[0, 0]) != 123 + SCAN_REPS - 1:
            raise AssertionError(f"bf16 scan: top id {ids[0, 0]}")
        res["table_bf16_bytes_pinned"] = sum(
            t.nbytes for t in next(iter(table._dev_cache.values())))
        return seen[0]

    lut, codes = asyncio.run(run())
    cc = res["client_counters"]
    if cc.get("sc.write.fallbacks") or not cc.get("sc.bytes.written") or \
            cc.get("read.zero_copy_bytes"):
        raise AssertionError(f"vector: the table's bytes took another path "
                             f"than the short circuit: {cc}")
    q, w, m = codes.shape
    ksub = lut.shape[2]
    for pre_offset in (False, True):          # the path's own shape
        max_err = max(max_err, pq_bit_check(
            *pq_case(gen, dev, q, w, m, ksub, pre_offset), pre_offset))
    max_err = max(max_err, pq_bit_check(lut, codes, True))
    res["pq_shapes"][str([q, w, m, ksub])] = "bit-equal"
    res["max_abs_err"] = max_err
    res["k2"] = pq_timing(lut, codes, dev)
    res["k2"]["shape"] = [q, w, m, ksub]
    k2 = res["k2"]
    log(f"vector: K2 {[q, w, m, ksub]} (the path's, and on its own "
        f"inputs): bit-equal to the plain version; {k2['ms']:.4f} ms, "
        f"bound {k2['bound_ms']:.4f} ms by bytes ({k2['bound_ms'] / k2['ms']:.1%}"
        f" of it); plain {k2['plain_ms']:.4f} ms; embedding_bag "
        f"{k2['library_ms']:.4f} ms (max abs diff "
        f"{k2['embedding_bag_max_abs_diff']:.3g})")
    for key in ("vector_ann_recall10", "vector_ann_flat_recall10",
                "vector_ann_served_recall10"):
        if not res[key] >= 0.9:          # scripts/perf_floor.json:13
            raise AssertionError(f"{key} {res[key]} < 0.9")
    log(f"vector: the table through the port's client: "
        f"{cc.get('sc.bytes.written', 0):,} bytes written and "
        f"{cc.get('sc.bytes.read', 0):,} read by short circuit; "
        f"{res['compaction']}")
    log(f"vector: {VEC_ROWS:,} x {VEC_DIM} f32 appended in "
        f"{res['append_s']:.2f}s, pinned in {res['pin_s']:.2f}s "
        f"({res['table_bytes_pinned'] / MiB:.1f} MiB pinned, "
        f"{res['allocated_after_pin_bytes'] / MiB:.1f} MiB more allocated on"
        f" the card); "
        f"vector_index_build_s {res['vector_index_build_s']:.3f} (list cap "
        f"{res['list_cap']}, {res['nlist_total']} lists with spills, W "
        f"{res['width']}); device memory after the index "
        f"{res['device_bytes_after_index'] / MiB:.1f} MiB; bf16 table "
        f"{res['table_bf16_bytes_pinned'] / MiB:.1f} MiB pinned")
    log(f"vector: vector_ann_qps {res['vector_ann_qps']:.1f} "
        f"vector_ann_recall10 {res['vector_ann_recall10']:.4f} "
        f"vector_ann_flat_qps {res['vector_ann_flat_qps']:.1f} "
        f"vector_ann_flat_recall10 {res['vector_ann_flat_recall10']:.4f} "
        f"vector_ann_served_qps {res['vector_ann_served_qps']:.1f} "
        f"vector_ann_batch_occupancy {res['vector_ann_batch_occupancy']:.3f}"
        f" ({res['served_batches']} batches, recall10 "
        f"{res['vector_ann_served_recall10']:.4f}) vector_scan_mrows_s "
        f"{res['vector_scan_mrows_s']:.1f} vector_scan_bf16_mrows_s "
        f"{res['vector_scan_bf16_mrows_s']:.1f}; K2 launches in "
        f"query_many {res['k2_launches']} for {res['adc_calls']} ADC "
        f"stages; PQ search with K2 == with the plain ADC (64 queries)")
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="also write every measured number to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    from curvine_tpu_torch.device import default_device
    from curvine_tpu_torch.gpu import cuda_ops

    dev = default_device()
    # the plain versions' f32 products in full f32, as stated
    torch.backends.cuda.matmul.allow_tf32 = False
    card = gpu_name_and_limit()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)} ({card})")
    rng = np.random.default_rng(args.seed)
    results = {"card": card, "seed": args.seed}
    results["build"] = phase_build()
    results["kernel"] = phase_kernel(rng, dev)
    need = N_BLOCKS * BLOCK + SHARDS * SHARD_BYTES + WORKER_TIER_BYTES
    root = pick_data_dir(need)
    log(f"main: data under {root} (needs {need / GiB:.2f} GiB and 1 GiB "
        f"spare: {N_BLOCKS} blocks and {SHARDS} POSIX shards of 64 MiB, "
        f"the port's worker's mem tier of {WORKER_TIER_BYTES / GiB:.2f} "
        f"GiB)")
    cluster = pw = None
    try:
        cuda_ops.block_checksum.launches = 0
        results["main"] = phase_main(rng, dev, root)
        results["feed"] = phase_feed(rng, dev, root)
        launches = cuda_ops.block_checksum.launches
        cluster, info = start_cluster(root)
        results["cluster"] = info
        pw = PortWorker(info["master"], root, WORKER_TIER_BYTES, dev)
        await_port_worker(info["master"], pw)
        log(f"client: the port's worker {pw.worker.worker_id} serves at "
            f"{pw.worker.addr}, the master's only live worker")
        results["client"] = phase_client(rng, dev, info["master"],
                                         results["feed"])
        results["worker"] = phase_worker(rng, dev, info["master"], pw,
                                         results["main"]["promote_gibs"])
        results["flash"] = phase_flash(dev, args.seed)
        results["train"], params = phase_train(
            dev, info["master"], args.seed, results["flash"])
        log(f"train: mfu {results['train']['mfu']:.4f} on {card}")
        results["ckpt"] = phase_ckpt(dev, info["master"], args.seed, params,
                                     results["main"]["link_gibs"])
        del params
        torch.cuda.empty_cache()
        results["vector"] = phase_vector(dev, info["master"], args.seed)
        # every phase's cluster traffic went through the port's worker
        await_port_worker(info["master"], pw)
        m = pw.worker.metrics
        results["port_worker"] = {
            "worker_id": pw.worker.worker_id, "counters": dict(m.counters),
            "rpcs": {k: v.count for k, v in m.histograms.items()}}
        log(f"worker: the port's worker {pw.worker.worker_id} served the "
            f"run: {results['port_worker']['rpcs']}; bytes.written "
            f"{m.counters.get('bytes.written', 0):,}, bytes.read (READ_BLOCK)"
            f" {m.counters.get('bytes.read', 0):,}")
        if not m.counters.get("bytes.read") or \
                not m.counters.get("bytes.written"):
            raise AssertionError("the port's worker served no READ_BLOCK or "
                                 "no write")
    finally:
        if pw is not None:
            pw.stop()
        if cluster is not None:
            stop_cluster(cluster)
        shutil.rmtree(root, ignore_errors=True)
    if launches != results["main"]["pins"]:
        raise AssertionError(f"{launches} kernel launches for "
                             f"{results['main']['pins']} pins")
    wk = results["worker"]
    k = results["kernel"]
    kernels = [{
        "name": "block_checksum", "route": "cuda",
        "source": "curvine_tpu_torch/csrc/checksum.cu",
        "replaces": "curvine_tpu/tpu/pallas_ops.py:27",
        "launches": launches + wk["k1_launches"],
        "max_abs_err": k["max_abs_err"],
        "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": "bytes", "library_ms": None}]
    replaces = {"flash_fwd": ":758", "flash_bwd_di": ":273",
                "flash_bwd_dkv": ":1121", "flash_bwd_dq": ":1456"}
    for name in K3_NAMES:
        f = results["flash"]["kernels"][name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "curvine_tpu_torch/csrc/flash_attention.cu",
            "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py"
                        + replaces[name] + " (via curvine_tpu/tpu/model.py"
                        ":113)",
            "launches": results["train"]["launches"][name],
            "max_abs_err": f["max_abs_err"], "ms": f["ms"],
            "plain_ms": f["plain_ms"], "bound_ms": f["bound_ms"],
            "bound_by": f["bound_by"], "library_ms": f["library_ms"]})
    v = results["vector"]
    kernels.append({
        "name": "pq_lut_scan", "route": "cuda",
        "source": "curvine_tpu_torch/csrc/pq_scan.cu",
        "replaces": "curvine_tpu/tpu/pallas_ops.py:111",
        "launches": v["k2_launches"], "max_abs_err": v["max_abs_err"],
        "ms": v["k2"]["ms"], "plain_ms": v["k2"]["plain_ms"],
        "bound_ms": v["k2"]["bound_ms"], "bound_by": "bytes",
        "library_ms": v["k2"]["library_ms"]})
    results["kernels"] = kernels
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
