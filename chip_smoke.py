#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``curvine_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed N] [--out results.json]

Phases, each raising on a fault (the exit code is then non-zero):

1. build: compile every CUDA source of the port with ``nvcc`` (sm_90a);
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
4. feed: 8 int32 token shards of 64 MiB through ``GpuTrainFeed`` at
   batch 32 x seq 8192, depth 2, over the whole epoch; every device batch
   must equal the host tokens.

The kernel launch counts are set to 0 just before phase 3 and read just
after phase 4. Prints each phase's numbers, the card's name and power
limit, one JSON line of kernels, and last the line
``{"ok": true, "device": {...}}``. Exits non-zero, and prints no result,
where no CUDA device is visible or the port is not importable."""

from __future__ import annotations

import argparse
import asyncio
import json
import os
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
SIZES = [1, 3, 4, 262143, 262144, 262145, MiB + 13, BLOCK, BLOCK + 1]
SHARDS = 8
SHARD_BYTES = 64 * MiB
BATCH, SEQ = 32, 8192


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

def phase_build() -> dict:
    from curvine_tpu_torch.gpu import _build
    t0 = time.perf_counter()
    info = _build.build_all()
    secs = time.perf_counter() - t0
    for name, i in sorted(info.items()):
        log(f"build: {name}: nvcc {i['seconds']:.2f}s")
        for line in i["log"].splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  ptxas: {line.strip()}")
    log(f"build: all sources in {secs:.2f}s")
    return {"seconds": secs}


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


def phase_feed(rng: np.random.Generator, dev: torch.device, root: str
               ) -> dict:
    from curvine_tpu_torch.gpu.loader import GpuTrainFeed, write_token_shards
    shard_tokens = SHARD_BYTES // 4
    tokens = rng.integers(0, 50257, SHARDS * shard_tokens, dtype=np.int32)
    shard_dir = os.path.join(root, "shards")
    write_token_shards(shard_dir, tokens, shard_tokens)
    expect = torch.from_numpy(tokens).to(dev)
    per_batch = BATCH * SEQ
    n_expect = tokens.size // per_batch

    async def run():
        feed = GpuTrainFeed(shard_dir, BATCH, SEQ, depth=2, device=dev)
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
        return n, int(bad), time.perf_counter() - t, feed.profiler

    n, bad, secs, prof = asyncio.run(run())
    if n != n_expect or bad:
        raise AssertionError(f"feed: {n}/{n_expect} batches, {bad} tokens "
                             f"differ from the host tokens")
    summary = prof.summary()
    snap = prof.snapshot()["stages"]
    res = {"batches": n, "batches_per_s": n / secs,
           "tokens_per_s": n * per_batch / secs,
           "gibs": n * per_batch * 4 / GiB / secs,
           "fractions": summary["fractions"],
           "stage_p50_ms": {k: v["p50"] * 1e3 for k, v in snap.items()},
           "stage_total_s": {k: v["total_s"] for k, v in snap.items()}}
    log(f"feed: {n} batches of {BATCH}x{SEQ} int32, all equal to the host "
        f"tokens, {res['batches_per_s']:.1f} batches/s "
        f"({res['gibs']:.3f} GiB/s)")
    for k in ("host_to_hbm", "input_wait", "compute_wait", "cache_fetch",
              "decode"):
        if k in snap:
            log(f"feed: {k:>12}: total {snap[k]['total_s']:.4f}s "
                f"p50 {snap[k]['p50'] * 1e3:.3f} ms "
                f"share {summary['fractions'][k]:.3f}")
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
    card = gpu_name_and_limit()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)} ({card})")
    rng = np.random.default_rng(args.seed)
    results = {"card": card, "seed": args.seed}
    results["build"] = phase_build()
    results["kernel"] = phase_kernel(rng, dev)
    root = pick_data_dir(N_BLOCKS * BLOCK + SHARDS * SHARD_BYTES)
    log(f"main: data under {root}")
    try:
        cuda_ops.block_checksum.launches = 0
        results["main"] = phase_main(rng, dev, root)
        results["feed"] = phase_feed(rng, dev, root)
        launches = cuda_ops.block_checksum.launches
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if launches != results["main"]["pins"]:
        raise AssertionError(f"{launches} kernel launches for "
                             f"{results['main']['pins']} pins")
    k = results["kernel"]
    kernels = [{
        "name": "block_checksum", "route": "cuda",
        "source": "curvine_tpu_torch/csrc/checksum.cu",
        "replaces": "curvine_tpu/tpu/pallas_ops.py:27",
        "launches": launches, "max_abs_err": k["max_abs_err"],
        "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": "bytes", "library_ms": None}]
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
