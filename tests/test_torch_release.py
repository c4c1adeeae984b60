"""The port frees a model's parameters and its optimizer at ``del``,
without the cycle collector (ROADMAP C3).

torch imports ``torch._dynamo`` at the first call of a function it wraps
in ``_disable_dynamo`` (the first optimizer's ``add_param_group``, or
DTensor's dispatch when parameters are sharded); a module that import
loads calls ``torch.fx.wrap``, whose frame keeps itself in a local, and
the cycle holds every frame then on the stack, and their locals, until
the collector runs. ``gpu/model.py`` imports the module first, on a
thread of its own, when it is itself imported.

The port's ``ConnectionPool`` made a second such cycle on the card: a
connection dialed while others filled the pool was handed out and never
closed, and its read loop, cancelled when ``asyncio.run`` ended, kept
its traceback, with every frame up to ``asyncio.run``'s caller and that
caller's locals (a checkpoint's parameters in ``chip_smoke.py``). The
pool now closes such a connection at once.

Each case runs in a fresh interpreter, since another test of this process
may have imported ``torch._dynamo`` already: it builds ``init_params``,
``make_optimizer`` and ``make_train_step`` on the CPU, takes one step with
the collector disabled, deletes all three, and reports how many of the
parameters and of the optimizer's state tensors a weak reference still
reaches."""

import asyncio
import gc
import json
import os
import subprocess
import sys
import weakref

import pytest
import torch

from curvine_tpu_torch.rpc.client import ConnectionPool

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = r"""
import gc, json, sys, weakref
gc.disable()
import torch
torch.set_num_threads(1)
from curvine_tpu_torch.gpu import model as tm
case = sys.argv[1]
cfg = tm.ModelConfig(vocab=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
                     max_seq=32, dtype="float32",
                     ce_chunk=20 if case == "ce_chunk_remat" else 0,
                     remat=case == "ce_chunk_remat")
mesh = None
if case == "mesh":
    from curvine_tpu_torch.gpu import multihost
    from curvine_tpu_torch.gpu.ingest import put_sharded
    from curvine_tpu_torch.gpu.mesh import make_mesh
    multihost.initialize(cpu=True)
    mesh = make_mesh(shape=(1, 1))
params = tm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
if mesh is not None:
    params = tm.shard_params(params, mesh)
opt = tm.make_optimizer(params, 1e-2)
step = tm.make_train_step(cfg, opt, mesh)
tokens = torch.arange(64, dtype=torch.int32).reshape(2, 32) % cfg.vocab
if mesh is not None:
    tokens = put_sharded(tokens.numpy(), mesh, tm.batch_spec(mesh))
loss = float(step(params, tokens))
refs = [weakref.ref(p) for p in tm.leaves(params)]
refs += [weakref.ref(t) for s in opt.state.values() for t in s.values()
         if isinstance(t, torch.Tensor)]
n = len(refs)
del params, opt, step, tokens
alive = sum(r() is not None for r in refs)
print(json.dumps({"loss": loss, "refs": n, "alive": alive,
                  "collector_enabled": gc.isenabled()}))
"""


@pytest.mark.parametrize("case", ["plain", "ce_chunk_remat", "mesh"])
def test_params_and_optimizer_freed_at_del(case):
    """Every parameter and every tensor of the optimizer's state (two
    moments and a step count a leaf) is freed at ``del``, the collector
    off: none is alive. ``mesh`` shards the parameters on a (1, 1) mesh of
    a gloo world of one before the optimizer is built."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", _CHILD, case], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    leaves = 19
    assert got["refs"] == 4 * leaves, got
    assert not got["collector_enabled"]
    assert got["alive"] == 0, got


def _concurrent_gets(n: int):
    """``n`` concurrent ``get``s of a pool of 2 against a loopback server
    that accepts and never answers, from a frame that holds a tensor;
    returns a weak reference to it, the connections the pool dialed and
    those it handed out."""
    held = torch.zeros(1 << 16)

    async def main():
        writers = []
        server = await asyncio.start_server(
            lambda r, w: writers.append(w), "127.0.0.1", 0)
        addr = f"127.0.0.1:{server.sockets[0].getsockname()[1]}"
        pool = ConnectionPool(size=2)
        dialed, real = [], pool._dial

        async def dial(a, attempts=3):
            dialed.append(await real(a, attempts))
            return dialed[-1]

        pool._dial = dial
        got = await asyncio.gather(*(pool.get(addr) for _ in range(n)))
        await pool.close()
        for w in writers:
            w.close()
        server.close()
        return dialed, got

    dialed, got = asyncio.run(main())
    return weakref.ref(held), dialed, got


def test_a_pool_closes_every_connection_it_dials():
    """16 concurrent ``get``s dial more connections than the pool keeps
    (each saw it empty); at most 2 are handed out, every one dialed is
    closed with its read loop ended, and, the collector off, the tensor
    of the frame that ran the event loop is freed when it returns."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        ref, dialed, got = _concurrent_gets(16)
        assert len(dialed) > 2
        assert len({id(c) for c in got}) <= 2
        assert all(c.closed and c._reader_task is None for c in dialed)
        assert ref() is None
    finally:
        if enabled:
            gc.enable()
