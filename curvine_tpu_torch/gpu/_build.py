"""Build and load the port's native code: CUDA C++ kernels and host C++.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a``, and
each ``csrc/*.cc`` source (host code, such as the crc32c routine) by the
host C++ compiler, into a shared library with a plain C interface, at
first use, into ``curvine_tpu_torch/build/`` (listed in ``.gitignore``),
and loaded with ``ctypes``; again whenever the source, or a header of
its kind under ``csrc/`` (``.cuh`` for a ``.cu`` source, ``.h`` for a
``.cc`` source, such as the KV engine's ``kvwire.h``), is newer than the
library. The sources
include no PyTorch header, so a build takes seconds. Nothing here runs
at import time: the CPU tests import every module of the port on
machines without ``nvcc``.

A missing compiler or a failed build raises ``KernelBuildError`` with the
compiler's output; there is no fallback."""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PKG, "csrc")
BUILD = os.path.join(PKG, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
CXX_FLAGS = ["-std=c++17", "-O3", "-shared", "-fPIC"]
# a source's extension -> the headers under csrc/ that make it stale
_HEADERS = {".cu": ".cuh", ".cc": ".h"}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# per source: {"seconds": build time (0.0 when the library was current),
#              "log": the compiler's output}
build_info: dict[str, dict] = {}


class KernelBuildError(RuntimeError):
    pass


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise KernelBuildError(
        "nvcc not found (neither on PATH nor under $CUDA_HOME/bin): the "
        "port's CUDA kernels build only where the CUDA toolkit is installed")


def cxx_path() -> str:
    for cand in ("c++", "g++", "clang++"):
        path = shutil.which(cand)
        if path:
            return path
    raise KernelBuildError("no host C++ compiler (c++, g++ or clang++) on "
                           "PATH: the port's host routines need one")


def is_stale(so: str, src: str, csrc: str = CSRC) -> bool:
    """Whether the library ``so`` must be built again from ``src``: it is
    missing, or older than its source or than the newest header of the
    source's kind under ``csrc`` (``.cuh`` for a ``.cu`` source, ``.h``
    for a ``.cc`` source: any source may include any of them)."""
    if not os.path.exists(so):
        return True
    newest = os.path.getmtime(src)
    header = _HEADERS.get(os.path.splitext(src)[1])
    if header is not None:
        for f in os.listdir(csrc):
            if f.endswith(header):
                newest = max(newest, os.path.getmtime(os.path.join(csrc, f)))
    return os.path.getmtime(so) < newest


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` (with ``nvcc``) or ``csrc/<name>.cc``
    (with the host compiler) into ``build/lib<name>.so`` unless the
    library is current (``is_stale``); return the library's path."""
    src = os.path.join(CSRC, f"{name}.cu")
    if os.path.exists(src):
        compiler, flags = nvcc_path(), NVCC_FLAGS
    else:
        src = os.path.join(CSRC, f"{name}.cc")
        compiler, flags = cxx_path(), CXX_FLAGS
    so = os.path.join(BUILD, f"lib{name}.so")
    if not is_stale(so, src):
        build_info.setdefault(name, {"seconds": 0.0, "log": ""})
        return so
    os.makedirs(BUILD, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [compiler, *flags, "-o", tmp, src]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise KernelBuildError(
            f"{os.path.basename(compiler)} failed ({proc.returncode}) for {src}:\n{' '.join(cmd)}\n"
            f"{log}")
    os.replace(tmp, so)
    build_info[name] = {"seconds": seconds, "log": log}
    return so


def sources() -> list[str]:
    """Names of every source under ``csrc/`` (``.cu`` and ``.cc``)."""
    return sorted(os.path.splitext(f)[0] for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cc")))


def build_all() -> dict[str, dict]:
    """Build every source at once, one compiler each, all started
    together; return ``build_info``."""
    from concurrent.futures import ThreadPoolExecutor
    names = sources()
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        for f in [pool.submit(build, n) for n in names]:
            f.result()
    return build_info


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` or ``.cc``, built at
    first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(build(name))
        return lib
