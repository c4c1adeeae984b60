"""The port stands alone: every module of ``curvine_tpu_torch`` imports
without pulling in ``jax``, ``optax``, ``msgpack``, ``aiohttp`` or
anything of ``curvine_tpu``, its
crc32c maps no library of the JAX package's ``csrc/build/``, and its
entry points refuse to run on the CPU unless asked to."""

import os
import subprocess
import sys

import numpy as np
import pytest

import torch

from curvine_tpu_torch import device as dev_mod
from curvine_tpu_torch.client.unified import CurvineClient
from curvine_tpu_torch.gpu import hbm, ingest, loader, model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
import curvine_tpu_torch
names = [m.name for m in pkgutil.walk_packages(curvine_tpu_torch.__path__,
                                               "curvine_tpu_torch.")]
for n in names:
    importlib.import_module(n)
from curvine_tpu_torch.worker import blockfile
assert blockfile.crc_update("crc32c", b"123456789") == 0xE3069283
with open("/proc/self/maps") as f:
    mapped = sorted({line.split()[-1] for line in f if "csrc/build" in line})
bad = sorted(k for k in sys.modules
             if k in ("jax", "optax", "curvine_tpu", "msgpack", "aiohttp")
             or k.startswith(("jax.", "jaxlib", "optax.", "curvine_tpu.",
                              "msgpack.", "aiohttp.")))
print(len(names), "modules;", "leaked:", bad, "mapped:", mapped)
required = {"curvine_tpu_torch.gpu.attention", "curvine_tpu_torch.gpu.flash",
            "curvine_tpu_torch.gpu.model", "curvine_tpu_torch.gpu.pq",
            "curvine_tpu_torch.client.posix", "curvine_tpu_torch.vector",
            "curvine_tpu_torch.vector.index", "curvine_tpu_torch.vector.table",
            "curvine_tpu_torch.vector.serving",
            "curvine_tpu_torch.rpc.wirepack", "curvine_tpu_torch.rpc.frame",
            "curvine_tpu_torch.rpc.client",
            "curvine_tpu_torch.client.fs_client",
            "curvine_tpu_torch.client.reader",
            "curvine_tpu_torch.client.writer",
            "curvine_tpu_torch.client.unified",
            "curvine_tpu_torch.common.executor",
            "curvine_tpu_torch.rpc.server",
            "curvine_tpu_torch.worker.storage",
            "curvine_tpu_torch.worker.server",
            "curvine_tpu_torch.worker.__main__",
            "curvine_tpu_torch.common.path",
            "curvine_tpu_torch.common.journal",
            "curvine_tpu_torch.master.store",
            "curvine_tpu_torch.master.inode",
            "curvine_tpu_torch.master.block_map",
            "curvine_tpu_torch.master.worker_map",
            "curvine_tpu_torch.master.placement",
            "curvine_tpu_torch.master.replication",
            "curvine_tpu_torch.rpc.deadline",
            "curvine_tpu_torch.master.retry_cache",
            "curvine_tpu_torch.master.acl",
            "curvine_tpu_torch.master.filesystem",
            "curvine_tpu_torch.master.server",
            "curvine_tpu_torch.master.__main__",
            "curvine_tpu_torch.gpu.mesh", "curvine_tpu_torch.gpu.multihost",
            "curvine_tpu_torch.gpu.ici_plane",
            "curvine_tpu_torch.gpu.ici_transfer",
            "curvine_tpu_torch.gpu.pipeline",
            "curvine_tpu_torch.ufs.base", "curvine_tpu_torch.ufs.local",
            "curvine_tpu_torch.ufs.memory", "curvine_tpu_torch.master.mount",
            "curvine_tpu_torch.master.jobs",
            "curvine_tpu_torch.client.ufs_reader",
            "curvine_tpu_torch.obs.trace"}
sys.exit(1 if bad or mapped or len(names) < 71 or required - set(names)
         else 0)
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "leaked: []" in out.stdout


def test_entry_points_need_cuda_unless_the_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dev_mod.default_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dev_mod.local_devices()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hbm.HbmTier(1024)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hbm.MultiHbmTier(1024)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ingest.DevicePrefetcher(iter([]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_params(torch.Generator().manual_seed(0),
                          model.ModelConfig.tiny())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loader.GpuTrainFeed(CurvineClient(), "/ds", batch=2, seq_len=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.params_from_jax(
            {"embed": np.zeros((4, 2), np.float32), "pos": np.zeros(
                (4, 2), np.float32), "ln_f": np.ones(2, np.float32),
             "layers": []})
    tree = model.params_from_jax(
        {"embed": np.zeros((4, 2), np.float32), "pos": np.zeros(
            (4, 2), np.float32), "ln_f": np.ones(2, np.float32),
         "layers": []}, device="cpu")
    assert tree["embed"].device == torch.device("cpu")
    assert dev_mod.default_device(cpu=True) == torch.device("cpu")
    assert dev_mod.device_id(torch.device("cpu", 3)) == 3
    assert dev_mod.device_id(5) == 5
