#!/usr/bin/env python3
"""Build copies of ``curvine_tpu_torch/csrc/flash_attention.cu`` with one
change each, beside the kernel, and check or time them on one card.

    python3 scripts/flash_variants.py faults
    python3 scripts/flash_variants.py ab NAME [NAME ...]

``faults``: each planted fault of ``FAULTS`` (in the di/dQ kernel
template) must fail ``chip_smoke.flash_errors`` at every shape of
``chip_smoke.FLASH_SHAPES`` (each changes the result at all four), and
the source as it stands must pass; prints one line a copy and exits 1
otherwise. ``ab``: the source as it stands and each named variant of
``VARIANTS``, checked the same way, then the four K3 kernels of each
timed at the flagship's shape (CUDA events, medians of 20, L2 flushed)
in turns: a b ... b a, a b .... The copies build into the gitignored
``chip_tree/variants/``; each change must apply exactly once. Needs a
CUDA card and ``nvcc``."""

from __future__ import annotations

import ctypes
import os
import statistics
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs                                    # noqa: E402
from curvine_tpu_torch.gpu import _build, flash            # noqa: E402

SRC = os.path.join(_build.CSRC, "flash_attention.cu")
OUT = os.path.join(ROOT, "chip_tree", "variants")

# name: (text of the source, its replacement)
FAULTS = {
    "key tile 0 dropped": (
        "                    ex2(fmaf(s[4 * j + e], scale_log2, -l2[e >> 1]));",
        "                    kt == 0 ? 0.f : "
        "ex2(fmaf(s[4 * j + e], scale_log2, -l2[e >> 1]));"),
    "mask off by one": (
        "if (key > row0 + (e >> 1) * 8) s[4 * j + e] = 0.f;",
        "if (key > row0 + (e >> 1) * 8 + 1) s[4 * j + e] = 0.f;"),
    "di ignored in dS": (
        "s[4 * j + e] * (dp[4 * j + e] - dr[e >> 1]) * scale;",
        "s[4 * j + e] * (dp[4 * j + e] - 0.f) * scale;"),
    "another row's lse": (
        "l2[i] = rows[lrow + i * 8] * LOG2E;",
        "l2[i] = rows[(lrow + i * 8 + 1) % KT] * LOG2E;"),
    "dS scaled by 1%": (
        "s[4 * j + e] * (dp[4 * j + e] - dr[e >> 1]) * scale;",
        "s[4 * j + e] * (dp[4 * j + e] - dr[e >> 1]) * scale * 1.01f;"),
    "K's k-steps swapped in dS K": (
        "mnstep(mndesc(k_addr, BK), kk));",
        "mnstep(mndesc(k_addr, BK), kk ^ 1));"),
    "consumer 0 not skipping tile 2 qt + 1": (
        "const int n_kt = (qt * KT + c * 64 + 63) / BK + 1;",
        "const int n_kt = (qt * KT + 127) / BK + 1;"),
    "V's k-steps swapped in dP": (
        "hopper::wgmma_64_ss(dp, kstep(dod, KT, kk), kstep(vd, BK, kk),",
        "hopper::wgmma_64_ss(dp, kstep(dod, KT, kk), kstep(vd, BK, kk ^ 1),"),
    "di without the quad sum": (
        "const float sum = quad_sum(acc[i]);",
        "const float sum = acc[i];"),
}

VARIANTS = {
    "n_kt = 2 qt + 1 + c": (
        "const int n_kt = (qt * KT + c * 64 + 63) / BK + 1;",
        "const int n_kt = 2 * qt + 1 + c;"),
    "3 stages": (
        "constexpr int QB_STAGES = 4;", "constexpr int QB_STAGES = 3;"),
}


def build(changes: dict[str, tuple[str, str]]) -> dict[str, ctypes.CDLL]:
    """The source as it stands and one copy a change, built all at once."""
    text = open(SRC).read()
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for i, (name, (old, new)) in enumerate(changes.items()):
        if text.count(old) != 1:
            raise SystemExit(f"{name!r}: the text to change is found "
                             f"{text.count(old)} times in {SRC}")
        src = os.path.join(OUT, f"v{i}.cu")
        with open(src, "w") as f:
            f.write(text.replace(old, new))
        procs[name] = (src[:-3] + ".so", subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", _build.CSRC,
             "-o", src[:-3] + ".so", src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {"as it stands": _build.load("flash_attention")}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{name!r} did not build:\n{log}")
        libs[name] = ctypes.CDLL(so)
    return libs


def inputs(shape, dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    return [torch.randn(shape, generator=gen, device=dev)
            .to(torch.bfloat16) for _ in range(4)]


def failing(lib, dev) -> list[list[str]]:
    """For each shape, the outputs outside their limits."""
    _build._libs["flash_attention"] = lib
    out = []
    for shape in cs.FLASH_SHAPES:
        pairs = cs.flash_pairs(*inputs(shape, dev))
        torch.cuda.synchronize()
        out.append(sorted(n for n, (g, r) in pairs.items()
                          if not cs.flash_errors(n, g, r)["ok"]))
    return out


def main() -> int:
    if len(sys.argv) < 2 or sys.argv[1] not in ("faults", "ab"):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("flash_variants: no CUDA device is visible", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.gpu_name_and_limit(), flush=True)
    mode = sys.argv[1]
    changes = FAULTS if mode == "faults" else {
        n: VARIANTS[n] for n in sys.argv[2:]}
    libs = build(changes)
    shapes = [str(list(s)) for s in cs.FLASH_SHAPES]
    ok = True
    for name, lib in libs.items():
        bad = failing(lib, dev)
        print(f"{name}: " + "; ".join(
            f"{s} {'fails ' + ','.join(b) if b else 'passes'}"
            for s, b in zip(shapes, bad)), flush=True)
        expect_fail = mode == "faults" and name != "as it stands"
        ok = ok and all(bool(b) == expect_fail for b in bad)
    if mode == "faults":
        print("every fault failed at every shape, the source passed" if ok
              else "FAULT CHECK FAILED", flush=True)
        return 0 if ok else 1
    if not ok:
        return 1
    q, k, v, do = inputs(cs.FLASH_SHAPES[0], dev)
    _, lse = flash.flash_fwd(q, k, v)
    di = flash.flash_bwd_di(q, k, v, do, lse)
    scratch = torch.empty(256 * cs.MiB, dtype=torch.uint8, device=dev)
    calls = {"flash_fwd": lambda: flash.flash_fwd(q, k, v),
             "flash_bwd_di": lambda: flash.flash_bwd_di(q, k, v, do, lse),
             "flash_bwd_dkv": lambda: flash.flash_bwd_dkv(q, k, v, do, lse,
                                                          di),
             "flash_bwd_dq": lambda: flash.flash_bwd_dq(q, k, v, do, lse,
                                                        di)}
    names = list(libs)
    times = {}
    for name in names + names[::-1] + names:
        _build._libs["flash_attention"] = libs[name]
        for kern, fn in calls.items():
            fn()
            torch.cuda.synchronize()
            times.setdefault((kern, name), []).append(
                statistics.median(cs.event_ms(fn, 20, scratch)))
    for (kern, name), ts in times.items():
        print(f"{kern} {name}: " + " ".join(f"{t:.4f}" for t in ts)
              + f" ms, median {statistics.median(ts):.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
