"""Port parity: ``curvine_tpu_torch/gpu/ici_transfer.py`` and the
broadcast rail of ``gpu/ici_plane.py`` on a mesh of four gloo ranks,
against the JAX package's functions on a mesh of four CPU devices, bit
for bit.

Mirrors ``test_ici_block_transfer`` (tests/test_tpu.py:256: scatter,
gather and broadcast of MB + 5 bytes over a 1-d mesh, the shard size of
the zero-padded block, ``replicate_to_devices``),
``test_ici_ring_shift_and_reshard`` (:476: ``ring_shift`` by 1 and by 3
hops, ``reshard_stripes`` from ``data`` to ``model``, here on a (2, 2)
mesh in place of (4, 2), its refusal of a wrong ``from_axis``, and
``verify_scattered`` against the host's sums), and
``test_broadcast_bytes_bit_exact`` and ``_empty_payload``
(tests/test_ici_plane.py:174, :192: 3 MB + 123 bytes in chunks of 1 MB,
four chunks each replicated on every rank, ``flat_replicate`` as the
baseline, the counters). One spawn of four ranks serves every check; the
ranks meet through a file store under ``tmp_path``, take one intra-op
thread each, and are killed after ``SPAWN_TIMEOUT_S``. Each rank writes
what it holds; only rank 0's host bytes are real (the others pass
zeros), so every scatter and broadcast is shown to read the block once.
The JAX functions run in the test's process meanwhile."""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax

from curvine_tpu.tpu import ici_plane as jax_plane
from curvine_tpu.tpu import ici_transfer as jit
from curvine_tpu.tpu.mesh import make_mesh as jax_make_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPUS = jax.devices("cpu")
SPAWN_TIMEOUT_S = 180
MB = 1 << 20
N = 4


def _inputs():
    rng = np.random.default_rng(0)
    return {"block": rng.integers(0, 255, MB + 5, dtype=np.uint8),
            "ring": np.arange(N * 16, dtype=np.uint8),
            "payload": np.frombuffer(np.random.default_rng(1).bytes(
                3 * MB + 123), dtype=np.uint8)}


# One rank: argv is (rank, world, store, work dir).
_RANK = r"""
import sys
import numpy as np
import torch
torch.set_num_threads(1)
from curvine_tpu_torch.gpu import ici_plane, ici_transfer as it, multihost
from curvine_tpu_torch.gpu.mesh import make_mesh

rank, world, store, work = (int(sys.argv[1]), int(sys.argv[2]),
                            sys.argv[3], sys.argv[4])
multihost.initialize(f"file://{store}", world, rank, cpu=True)
inp = np.load(f"{work}/inputs.npz")
out = {}
# only rank 0's host bytes count: the others pass zeros
def host(name):
    a = inp[name]
    return a if rank == 0 else np.zeros_like(a)

mesh = make_mesh(axis_names=("x",))
sc = it.scatter_block(host("block"), mesh)
out["sc_local"] = sc.to_local().numpy()
out["sc_placements"] = np.array([repr(p) for p in sc.placements])
rep = it.gather_block(sc, mesh)
out["rep_local"] = rep.to_local().numpy()
out["rep_placements"] = np.array([repr(p) for p in rep.placements])
out["bcast_local"] = it.broadcast_block(host("block"), mesh).to_local().numpy()
src = torch.from_numpy(inp["block"].copy())
# the block's own device, then three more device ids
copies = it.replicate_to_devices(src, [src.device] + [
    torch.device("cpu", i) for i in range(1, world)])
out["copies"] = np.array([c.data_ptr() == src.data_ptr() for c in copies])
out["copies_equal"] = np.array([torch.equal(c, src) for c in copies])

ring = it.scatter_block(host("ring"), mesh)
out["shift1"] = it.ring_shift(ring, mesh, steps=1).to_local().numpy()
out["shift3"] = it.ring_shift(ring, mesh, steps=3).to_local().numpy()
out["shift4"] = it.ring_shift(ring, mesh, steps=4).to_local().numpy()
out["sums"] = it.verify_scattered(ring, mesh)

mesh2 = make_mesh(axis_names=("data", "model"), shape=(2, 2))
s1 = it.scatter_block(host("ring"), mesh2, axis="data")
s2 = it.reshard_stripes(s1, mesh2, "data", "model")
out["s1_local"] = s1.to_local().numpy()
out["s2_local"] = s2.to_local().numpy()
out["s2_placements"] = np.array([repr(p) for p in s2.placements])
out["s2_gathered"] = it.gather_block(s2, mesh2).to_local().numpy()
out["s2_sums"] = it.verify_scattered(s2, mesh2, axis="model")
try:
    it.reshard_stripes(s2, mesh2, "data", "model")
    out["refused"] = np.array("")
except ValueError as e:
    out["refused"] = np.array(str(e))

counters = {}
payload = host("payload").tobytes()
rb = ici_plane.broadcast_bytes(payload, mesh, chunk_bytes=1 << 20,
                               counters=counters)
out["rb_n"] = np.array(len(rb.chunks))
out["rb_bytes"] = rb.np()
out["rb_replicated"] = np.array([repr(c.placements) for c in rb.chunks])
out["rb_counter"] = np.array(counters["ici.broadcast_bytes"])
out["rb_has_ms"] = np.array("ici.broadcast_ms" in counters)
flat = ici_plane.flat_replicate(payload, mesh)
out["flat_local"] = flat.to_local().numpy()
empty = ici_plane.broadcast_bytes(b"", mesh)
out["empty"] = np.array([empty.nbytes, len(bytes(empty.np()))])
np.savez(f"{work}/rank{rank}.npz", **out)
multihost.shutdown()
print("rank", rank, "ok", flush=True)
"""


def _jax_runs(inp) -> dict:
    """The reference's functions on four CPU devices, on the same
    inputs."""
    mesh = jax_make_mesh(devices=CPUS[:N], axis_names=("x",))
    block, ring = inp["block"], inp["ring"]
    sc = jit.scatter_block(block, mesh)
    out = {"sc_shards": [np.asarray(s.data) for s in sc.addressable_shards],
           "rep": np.asarray(jit.gather_block(sc, mesh)),
           "bcast": np.asarray(jit.broadcast_block(block, mesh))}
    rs = jit.scatter_block(ring, mesh)
    for k in (1, 3, 4):
        out[f"shift{k}"] = np.asarray(jit.ring_shift(rs, mesh, steps=k))
    out["sums"] = jit.verify_scattered(rs, mesh)
    mesh2 = jax_make_mesh(devices=CPUS[:N], axis_names=("data", "model"),
                          shape=(2, 2))
    s2 = jit.reshard_stripes(jit.scatter_block(ring, mesh2, axis="data"),
                             mesh2, "data", "model")
    out["s2"] = np.asarray(s2)
    out["s2_shard"] = np.asarray(s2.addressable_shards[0].data)
    out["s2_sums"] = jit.verify_scattered(s2, mesh2, axis="model")
    counters = {}
    rb = jax_plane.broadcast_bytes(inp["payload"].tobytes(), mesh,
                                   chunk_bytes=MB, counters=counters)
    out["rb_n"] = len(rb.chunks)
    out["rb"] = rb.np()
    out["rb_counter"] = counters["ici.broadcast_bytes"]
    out["flat"] = np.asarray(jax_plane.flat_replicate(
        inp["payload"].tobytes(), mesh))
    out["empty"] = jax_plane.broadcast_bytes(b"", mesh).nbytes
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("ici_mesh")
    inp = _inputs()
    np.savez(work / "inputs.npz", **inp)
    script = work / "rank.py"
    script.write_text(_RANK)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(N), str(work / "store"),
         str(work)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        env=env, text=True) for r in range(N)]
    try:
        ref = _jax_runs(inp)
        outs = [p.communicate(timeout=SPAWN_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"rank {r} ok" in out, \
            f"rank {r} failed:\n{out[-3000:]}"
    ranks = [dict(np.load(work / f"rank{r}.npz")) for r in range(N)]
    return {"inp": inp, "jax": ref, "ranks": ranks}


def test_ici_block_transfer(runs):
    """Each rank's shard of the zero-padded block is JAX's device shard
    of the same index, (size + 3) // 4 bytes; gathered and broadcast, the
    block is whole on every rank and equal to JAX's; a replica on the
    block's own device is the block itself, on another device id a copy
    (a CPU tensor's device carries no index: ``cpu:1`` is another id)."""
    data, ref = runs["inp"]["block"], runs["jax"]
    size = (data.size + 3) // N
    for r, got in enumerate(runs["ranks"]):
        assert got["sc_local"].shape == (size,)
        assert np.array_equal(got["sc_local"], ref["sc_shards"][r])
        assert list(got["sc_placements"]) == ["Shard(dim=0)"]
        assert list(got["rep_placements"]) == ["Replicate()"]
        assert np.array_equal(got["rep_local"][:data.size], data)
        assert np.array_equal(got["rep_local"], ref["rep"])
        assert np.array_equal(got["bcast_local"], ref["bcast"])
        assert list(got["copies"]) == [True] + [False] * (N - 1)
        assert got["copies_equal"].all()


def test_ici_ring_shift_and_reshard(runs):
    """Shard k after a shift by s is shard (k - s) mod 4 of the input, as
    JAX's ppermute gives it (a shift by 4 is the input); the (2, 2)
    reshard from ``data`` to ``model`` keeps the bytes and halves each
    rank's stripe as JAX's does; a wrong ``from_axis`` raises; the
    per-shard sums equal JAX's and the host's."""
    data, ref = runs["inp"]["ring"], runs["jax"]
    shards = data.reshape(N, 16)
    for r, got in enumerate(runs["ranks"]):
        for k in (1, 3, 4):
            want = np.roll(shards, k, axis=0)[r]
            assert np.array_equal(got[f"shift{k}"], want)
            assert np.array_equal(got[f"shift{k}"],
                                  ref[f"shift{k}"].reshape(N, 16)[r])
        assert np.array_equal(got["sums"], ref["sums"])
        assert np.array_equal(got["sums"], shards.astype(np.uint32).sum(
            axis=1, dtype=np.uint32))
        # (data, model) = divmod(rank, 2): data-stripe of 32, then model
        d, m = divmod(r, 2)
        assert np.array_equal(got["s1_local"], data[d * 32:(d + 1) * 32])
        assert np.array_equal(got["s2_local"], data[m * 32:(m + 1) * 32])
        assert got["s2_local"].size == data.size // 2 == \
            ref["s2_shard"].size
        assert list(got["s2_placements"]) == ["Replicate()", "Shard(dim=0)"]
        assert np.array_equal(got["s2_gathered"], data)
        assert np.array_equal(got["s2_gathered"], ref["s2"])
        assert np.array_equal(got["s2_sums"], ref["s2_sums"])
        assert "not from_axis='data'" in str(got["refused"])


def test_broadcast_bytes_bit_exact(runs):
    """3 MB + 123 bytes in four chunks of 1 MB, each replicated on every
    rank, reassembled bit for bit on each, as JAX's rail gives them; the
    flat baseline equal; the counters."""
    data, ref = runs["inp"]["payload"], runs["jax"]
    for got in runs["ranks"]:
        assert int(got["rb_n"]) == ref["rb_n"] == 4
        assert np.array_equal(got["rb_bytes"], data)
        assert np.array_equal(got["rb_bytes"], ref["rb"])
        assert set(got["rb_replicated"]) == {"(Replicate(),)"}
        assert int(got["rb_counter"]) == ref["rb_counter"] == data.size
        assert bool(got["rb_has_ms"])
        assert np.array_equal(got["flat_local"], data)
        assert np.array_equal(got["flat_local"], ref["flat"])


def test_broadcast_bytes_empty_payload(runs):
    for got in runs["ranks"]:
        assert list(got["empty"]) == [runs["jax"]["empty"], 0] == [0, 0]
