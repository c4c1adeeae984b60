"""Port parity: the mesh layer of ``curvine_tpu_torch`` (``gpu/mesh.py``,
``gpu/multihost.py``, ``gpu/ingest.py::put_sharded``, the feeds' and the
model's ``mesh`` arguments, the spec table, ``_moe_ffn`` and
``gpu/broadcast.py::broadcast_params``) against the JAX package's, on the
CPU.

Mirrors ``test_mesh_factoring_and_topology`` (tests/test_tpu.py:41) over
a grid, ``test_multihost_two_process_distributed`` (:514) as a run of two
gloo ranks, and ``test_cache_feed_to_device`` (:66)'s mesh placement on
the port's own cluster; holds the spec table, ``_sanitize`` and
``batch_spec`` against the JAX package's on three meshes, and the
refusals: a mesh shape that does not fit the devices, an axis the mesh
lacks, a CUDA group without NCCL or a card. A ``seq`` axis of 2 trains
a step as JAX's jitted step does. Meshes of one rank run in the test's
process (a world of one gloo process, made and destroyed by each test);
the two-rank run meets through a file store under ``tmp_path`` and is
killed after ``SPAWN_TIMEOUT_S``. The sharded train steps are in
``tests/test_torch_mesh_train.py``."""

import asyncio
import contextlib
import copy
import dataclasses
import itertools
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
from jax.sharding import Mesh

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from curvine_tpu.tpu import mesh as jmesh
from curvine_tpu.tpu import model as jm
from curvine_tpu.tpu.broadcast import broadcast_params as jax_broadcast
from curvine_tpu_torch.client.unified import CurvineClient
from curvine_tpu_torch.common.conf import ClusterConf, TierConf
from curvine_tpu_torch.gpu import mesh as tmesh
from curvine_tpu_torch.gpu import model as tm
from curvine_tpu_torch.gpu import multihost
from curvine_tpu_torch.gpu.broadcast import broadcast_params
from curvine_tpu_torch.gpu.ingest import DevicePrefetcher, put_sharded
from curvine_tpu_torch.gpu.loader import (GpuTrainFeed, PosixTrainFeed,
                                          write_posix_shards,
                                          write_token_shards)
from curvine_tpu_torch.master.server import MasterServer
from curvine_tpu_torch.worker.server import WorkerServer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPUS = jax.devices("cpu")
MB = 1 << 20
SPAWN_TIMEOUT_S = 180
AXES = [("data", "model"), ("data", "ep"), ("data", "model", "seq")]
TINY32 = dataclasses.replace(jm.ModelConfig.tiny(), dtype="float32")
MOE = jm.ModelConfig(vocab=128, d_model=32, n_heads=2, n_layers=2, d_ff=64,
                     max_seq=32, dtype="float32", moe_experts=4)


@pytest.fixture
def world():
    """A world of this process alone, over gloo; destroyed after."""
    multihost.initialize(cpu=True)
    try:
        yield
    finally:
        multihost.shutdown()


@pytest.fixture
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port_mesh(axes):
    return tmesh.make_mesh(axis_names=axes, shape=(1,) * len(axes))


def _jax_mesh(axes):
    shape = {2: (4, 2), 3: (2, 2, 2)}[len(axes)]
    return Mesh(np.array(CPUS).reshape(shape), axes)


def _as_placements(spec, axes) -> list:
    """A JAX PartitionSpec as DTensor placements over ``axes``."""
    out = [Replicate()] * len(axes)
    for dim, a in enumerate(spec):
        if a is not None:
            out[axes.index(a)] = Shard(dim)
    return out


def _tree(cfg):
    return jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0),
                                                   cfg))


# ------------------------------------------------ mesh and topology

def test_mesh_factoring_and_topology():
    """test_tpu.py:41's checks, then the port's ``factor_mesh`` and
    ``IciTopology`` against the JAX package's over a grid: n 1..64 on 1-3
    axes; five torus shapes at 1 and 4 chips a host, every chip's coords
    and host, and the hops of every pair of chips."""
    assert tmesh.factor_mesh(8, 2) == (4, 2)
    assert tmesh.factor_mesh(16, 2) == (4, 4)
    assert tmesh.factor_mesh(8, 3) == (4, 2, 1)
    topo = tmesh.IciTopology((4, 4), chips_per_host=4)
    assert topo.num_chips() == 16 and topo.num_hosts() == 4
    assert topo.coords_of(0) == (0, 0)
    assert topo.coords_of(5) == (1, 1)
    assert topo.hops((0, 0), (3, 3)) == 2      # torus wrap
    assert topo.hops((0, 0), (2, 1)) == 3

    for n in range(1, 65):
        for axes in (1, 2, 3):
            assert tmesh.factor_mesh(n, axes) == jmesh.factor_mesh(n, axes)
    for shape in [(4, 4), (2, 3), (8,), (2, 2, 2), (3, 4, 2)]:
        for per_host in (1, 4):
            a = tmesh.IciTopology(shape, per_host)
            b = jmesh.IciTopology(shape, per_host)
            assert (a.num_chips(), a.num_hosts()) == \
                (b.num_chips(), b.num_hosts())
            chips = range(a.num_chips())
            assert [a.coords_of(i) for i in chips] == \
                [b.coords_of(i) for i in chips]
            assert [a.host_of(i) for i in chips] == \
                [b.host_of(i) for i in chips]
            assert [a.host_coords(h) for h in range(a.num_hosts())] == \
                [b.host_coords(h) for h in range(b.num_hosts())]
            for i, j in itertools.product(chips, chips):
                ci, cj = b.coords_of(i), b.coords_of(j)
                assert a.hops(ci, cj) == b.hops(ci, cj)


def test_mesh_over_one_rank_and_bad_shapes(world):
    """The default mesh over a world of one is (1, 1) on the CPU; a shape
    that does not multiply out to the devices raises ValueError in both
    packages; a spec naming an axis the mesh lacks, or one axis twice,
    raises ValueError."""
    mesh = tmesh.make_mesh()
    assert mesh.mesh_dim_names == ("data", "model")
    assert tuple(mesh.shape) == (1, 1) and mesh.device_type == "cpu"
    with pytest.raises(ValueError, match="mesh shape"):
        tmesh.make_mesh(shape=(2, 2))
    with pytest.raises(ValueError, match="mesh shape"):
        jmesh.make_mesh(devices=CPUS, shape=(3, 2))
    with pytest.raises(ValueError, match="not an axis"):
        tmesh.placements(mesh, tmesh.P("ep"))
    with pytest.raises(ValueError, match="twice"):
        tmesh.placements(mesh, tmesh.P("data", "data"))
    assert tmesh.replicated(mesh) == [Replicate(), Replicate()]
    assert tmesh.batch_sharding(mesh) == [Shard(0), Replicate()]
    assert tmesh.batch_sharding(mesh, "model") == [Replicate(), Shard(0)]


def test_initialize_refusals(monkeypatch, world):
    """No second group over a live one; a multi-process group needs its
    rendezvous, world size and rank; without ``cpu=True`` the group is
    NCCL on the card, or an error: none here, and none where this torch
    has no NCCL (a CUDA run never carries on with gloo)."""
    with pytest.raises(RuntimeError, match="initialized already"):
        multihost.initialize(cpu=True)
    multihost.shutdown()
    with pytest.raises(ValueError, match="coordinator"):
        multihost.initialize("127.0.0.1:1", cpu=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.initialize()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(dist, "is_nccl_available", lambda: False)
    with pytest.raises(RuntimeError, match="no NCCL"):
        multihost.initialize()
    assert not dist.is_initialized()
    multihost.initialize(cpu=True)      # for the fixture's shutdown


def test_pod_coords_and_worker_conf():
    """A GPU has no torus coordinates, as a JAX CPU device has none: the
    co-located worker advertises []."""
    from curvine_tpu.tpu import multihost as jmh
    assert multihost.local_ici_coords() == jmh.local_ici_coords() == []
    conf = ClusterConf()
    conf.worker.ici_coords = [9, 9]
    multihost.worker_conf_for_pod(conf)
    assert conf.worker.ici_coords == []


# ------------------------------------------------ spec table

@pytest.mark.parametrize("axes", AXES, ids=["dp_tp", "dp_ep", "dp_tp_sp"])
@pytest.mark.parametrize("cfg", [TINY32, MOE], ids=["dense", "moe"])
def test_spec_table_matches_jax(world, axes, cfg):
    """``param_spec_tree`` and ``_sanitize`` give the JAX package's
    PartitionSpecs, and their placements are those specs, axis by axis,
    for every leaf; ``batch_spec`` too."""
    jtree = _tree(cfg)
    ptree = tm.params_from_jax(jtree, device="cpu")
    mesh, jm_mesh = _port_mesh(axes), _jax_mesh(axes)
    want = jax.tree.leaves(jax.tree.map(
        lambda s: jm._sanitize(s, jm_mesh), jm.param_spec_tree(jtree),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    specs = tm.param_spec_tree(ptree)
    got = []
    for key in sorted(specs):
        if key == "layers":
            for layer in specs["layers"]:
                got.extend(tm._sanitize(layer[k], mesh)
                           for k in sorted(layer))
        else:
            got.append(tm._sanitize(specs[key], mesh))
    assert len(got) == len(want) == len(tm.leaves(ptree))
    for g, w in zip(got, want):
        assert tuple(g) == tuple(w)
        assert tmesh.placements(mesh, g) == _as_placements(w, axes)
    assert tuple(tm.batch_spec(mesh)) == tuple(jm.batch_spec(jm_mesh))
    assert tmesh.placements(mesh, tm.batch_spec(mesh)) == \
        _as_placements(jm.batch_spec(jm_mesh), axes)


def test_shard_and_broadcast_params_match_jax(world):
    """``shard_params`` and ``broadcast_params`` (replicated, and by a
    spec tree) place each leaf as the JAX package's do: a DTensor whose
    placements are its JAX spec's, bit for bit the same values (bf16
    too), gathered back by ``params_to_numpy``; a leaf that required grad
    is a new leaf that does."""
    axes = ("data", "model")
    mesh, jm_mesh = _port_mesh(axes), _jax_mesh(axes)
    cfg = dataclasses.replace(TINY32, dtype="bfloat16")
    jtree = _tree(cfg)
    ptree = tm.params_from_jax(jtree, device="cpu")
    sharded = tm.shard_params(ptree, mesh)
    jsharded = jm.shard_params(jax.tree.map(jax.numpy.asarray, jtree),
                               jm_mesh)
    for p, j in zip(tm.leaves(sharded), jax.tree.leaves(jsharded)):
        assert isinstance(p, DTensor) and p.is_leaf and p.requires_grad
        assert list(p.placements) == _as_placements(j.sharding.spec, axes)
    back = tm.params_to_numpy(sharded)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jtree)):
        assert np.array_equal(a, b.view(np.uint16))
    specs = tmesh.tree_map(lambda s: tm._sanitize(s, mesh),
                           tm.param_spec_tree(ptree))
    for spec_tree in (None, specs):
        got = broadcast_params(ptree, mesh, spec_tree)
        jspecs = None if spec_tree is None else jax.tree.map(
            lambda s: jm._sanitize(s, jm_mesh), jm.param_spec_tree(jtree),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        want = jax_broadcast(jtree, jm_mesh, jspecs)
        for p, j, a in zip(tm.leaves(got), jax.tree.leaves(want),
                           jax.tree.leaves(jtree)):
            assert list(p.placements) == _as_placements(j.sharding.spec,
                                                        axes)
            assert np.array_equal(
                p.full_tensor().view(torch.int16).numpy().view(np.uint16),
                a.view(np.uint16))


# ------------------------------------------------ model under a mesh

def test_moe_ffn_and_init_match_jax(one_torch_thread):
    """``init_params``' MoE branch has the reference's names and shapes;
    ``_moe_ffn`` (f32 softmax routing, top-2 mask, renormalised gates,
    tanh GELU) gives JAX's values (rtol 1e-5, atol 1e-6) and gradients
    (rtol 1e-4, atol 1e-5 of each leaf's largest), on one device."""
    pt = tm.init_params(torch.Generator().manual_seed(0),
                        tm.ModelConfig(**dataclasses.asdict(MOE)), "cpu")
    jt = _tree(MOE)
    assert [sorted(l) for l in pt["layers"]] == \
        [sorted(l) for l in jt["layers"]]
    for a, b in zip(tm.leaves(pt), jax.tree.leaves(jt)):
        assert tuple(a.shape) == b.shape
    layer = {k: jt["layers"][0][k] for k in ("router", "ew1", "ew2")}
    x = np.random.default_rng(1).standard_normal((2, 8, MOE.d_model),
                                                 dtype=np.float32)
    dy = np.random.default_rng(2).standard_normal(x.shape, dtype=np.float32)
    ref, vjp = jax.vjp(lambda x, l: jm._moe_ffn(x, l, MOE), x, layer)
    rdx, rl = vjp(dy)
    tx = torch.from_numpy(x).requires_grad_(True)
    tl = {k: torch.from_numpy(np.array(v)).requires_grad_(True)
          for k, v in layer.items()}
    out = tm._moe_ffn(tx, tl, MOE)
    out.backward(torch.from_numpy(dy))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-6)
    for got, want in [(tx.grad, rdx)] + [(tl[k].grad, rl[k]) for k in tl]:
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("cfg", [TINY32, MOE,
                                 dataclasses.replace(TINY32, n_heads=1)],
                         ids=["dense", "moe", "one_head"])
def test_one_rank_mesh_step_equals_no_mesh(world, one_torch_thread, cfg):
    """Under a (1, 1) mesh, two train steps give the unsharded step's
    losses and parameters bit for bit (the local ops are the same, and
    each residual stream is pinned once and used from there, so its
    gradient's terms are summed in the same grouping), and return the
    loss as a plain tensor; then the logits too: the card's ``mesh``
    phase at small size."""
    axes = ("data", "ep") if cfg.moe_experts else ("data", "model")
    mesh = _port_mesh(axes)
    pcfg = tm.ModelConfig(**dataclasses.asdict(cfg))
    jtree = _tree(cfg)
    tokens = np.random.default_rng(3).integers(0, cfg.vocab, (4, 32),
                                               dtype=np.int32)
    plain = tm.params_from_jax(jtree, device="cpu")
    step = tm.make_train_step(pcfg, tm.make_optimizer(plain, 1e-2))
    want = [float(step(plain, torch.from_numpy(tokens))) for _ in range(2)]
    params = tm.shard_params(tm.params_from_jax(jtree, device="cpu"), mesh)
    step = tm.make_train_step(pcfg, tm.make_optimizer(params, 1e-2), mesh)
    tok = put_sharded(tokens, mesh, tm.batch_spec(mesh))
    got = []
    for _ in range(2):
        loss = step(params, tok)
        assert type(loss) is torch.Tensor and loss.dim() == 0
        got.append(float(loss))
    assert got == want
    for a, b in zip(jax.tree.leaves(tm.params_to_numpy(params)),
                    tm.leaves(plain)):
        assert np.array_equal(a, b.detach().numpy())
    with torch.no_grad():
        logits = tm.forward(params, tok, pcfg, mesh)
        assert torch.equal(logits.full_tensor(),
                           tm.forward(plain, torch.from_numpy(tokens), pcfg))


# ------------------------------------------------ placement and feeds

def test_put_sharded_and_prefetcher_on_one_rank(world):
    """At world size 1 the whole batch goes onto the mesh: a DTensor laid
    out by the spec (default: the first axis over the batch), equal to
    the host batch; ``DevicePrefetcher`` with a mesh delivers the same;
    without one it delivers plain tensors, as before."""
    mesh = _port_mesh(("data", "model"))
    batch = np.arange(32, dtype=np.int32).reshape(4, 8)
    t = put_sharded(batch, mesh)
    assert isinstance(t, DTensor) and list(t.placements) == \
        [Shard(0), Replicate()]
    assert np.array_equal(t.full_tensor().numpy(), batch)
    t = put_sharded(batch, mesh, tmesh.P("data", "model"))
    assert list(t.placements) == [Shard(0), Shard(1)]
    batches = [batch + i for i in range(3)]
    got = list(DevicePrefetcher(iter(batches), mesh=mesh,
                                spec=tm.batch_spec(mesh)))
    assert all(isinstance(g, DTensor) for g in got)
    assert all(np.array_equal(g.full_tensor().numpy(), b)
               for g, b in zip(got, batches))
    plain = list(DevicePrefetcher(iter(batches), device="cpu"))
    assert not any(isinstance(g, DTensor) for g in plain)
    with pytest.raises(ValueError, match="not the mesh's"):
        DevicePrefetcher(iter(batches), device="cuda:0", mesh=mesh)


@contextlib.asynccontextmanager
async def _cluster(tmp_path):
    """The port's master and one port worker, in this process."""
    conf = ClusterConf()
    conf.master.rpc_port = 0
    conf.master.journal_dir = str(tmp_path / "journal")
    conf.master.worker_lost_timeout_ms = 30_000
    conf.client.block_size = MB
    m = MasterServer(conf)
    await m.start()
    conf.client.master_addrs = [m.addr]
    wconf = copy.deepcopy(conf)
    wc = wconf.worker
    wc.hostname, wc.rpc_port, wc.heartbeat_ms = "127.0.0.1", 0, 200
    wc.promote_interval_ms = 0
    wc.tiers = [TierConf(storage_type="mem", dir=str(tmp_path / "mem"),
                         capacity=64 * MB)]
    w = WorkerServer(wconf)
    try:
        await w.start()
        while len(m.fs.workers.live_workers()) < 1:
            await asyncio.sleep(0.02)
        yield conf
    finally:
        await w.stop()
        await m.stop()


async def test_feed_on_a_mesh_matches_the_feed_without(tmp_path):
    """``GpuTrainFeed(mesh=...)`` over the port's cluster at world size
    1 yields the batches of the feed without a mesh, as DTensors laid out
    by ``batch_spec`` (``P('data', None)``, as ``TpuTrainFeed``'s are);
    ``PosixTrainFeed`` shares the path."""
    multihost.initialize(cpu=True)
    try:
        mesh = _port_mesh(("data", "model"))
        want = tmesh.placements(mesh, tm.batch_spec(mesh))
        assert want == _as_placements(jm.batch_spec(
            _jax_mesh(("data", "model"))), ("data", "model"))
        tokens = np.arange(4096, dtype=np.int32)
        async with _cluster(tmp_path) as conf:
            async with CurvineClient(copy.deepcopy(conf)) as c:
                await write_token_shards(c, "/ds/train", tokens,
                                         shard_tokens=1000)
                plain = [b async for b in GpuTrainFeed(
                    c, "/ds/train", batch=4, seq_len=128, device="cpu")]
                got = [b async for b in GpuTrainFeed(
                    c, "/ds/train", batch=4, seq_len=128, mesh=mesh)]
        assert len(plain) == len(got) == 4096 // 512
        for g, p in zip(got, plain):
            assert isinstance(g, DTensor) and list(g.placements) == want
            assert torch.equal(g.full_tensor(), p)
        write_posix_shards(str(tmp_path / "posix"), tokens, 1000)
        posix = [b async for b in PosixTrainFeed(
            str(tmp_path / "posix"), batch=4, seq_len=128, mesh=mesh)]
        assert all(list(b.placements) == want for b in posix)
        assert all(torch.equal(a.full_tensor(), b)
                   for a, b in zip(posix, plain))
    finally:
        multihost.shutdown()


# ------------------------------------------------ two processes

# One of two ranks: argv is (rank, store, work dir). test_tpu.py:514's
# check, then one train step on a (1, 1, 2) data x model x seq mesh, with
# and without ring attention, from the parameters and tokens in the work
# dir; rank 0 writes the losses and the gathered parameters.
_RANK = r"""
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from curvine_tpu_torch.gpu import model as tm, multihost
from curvine_tpu_torch.gpu.ingest import put_sharded
from curvine_tpu_torch.gpu.mesh import P, make_mesh

pid, store, work = int(sys.argv[1]), sys.argv[2], sys.argv[3]
multihost.initialize(coordinator=f"file://{store}", num_processes=2,
                     process_id=pid, cpu=True)
mesh = make_mesh(axis_names=("data",))
assert tuple(mesh.shape) == (2,), mesh.shape
# per-process local shard -> one global [4, 8] tensor
local = np.full((2, 8), pid + 1, dtype=np.float32)
arr = put_sharded(local, mesh, P("data"))
assert tuple(arr.shape) == (4, 8), arr.shape
total = float(arr.sum().full_tensor())
# both processes see the GLOBAL sum: 2*8*1 + 2*8*2 = 48
assert total == 48.0, total
print("proc", pid, "ok", flush=True)

seq = make_mesh(axis_names=("data", "model", "seq"), shape=(1, 1, 2))
assert tuple(tm.batch_spec(seq)) == ("data", "seq")
d = np.load(f"{work}/seq.npz")
tree = {k: d[k] for k in ("embed", "pos", "ln_f")}
tree["layers"] = [{k[2:]: d[k] for k in d.files if k.startswith("0.")}]
out = {}
for ring in (False, True):
    cfg = tm.ModelConfig(vocab=64, d_model=32, n_heads=2, n_layers=1,
                         d_ff=64, max_seq=16, dtype="float32",
                         use_ring_attention=ring)
    params = tm.shard_params(tm.params_from_jax(tree, device="cpu"), seq)
    tok = put_sharded(d["tokens"][:, pid * 4:(pid + 1) * 4], seq,
                      tm.batch_spec(seq))
    step = tm.make_train_step(cfg, tm.make_optimizer(params), seq)
    out[str(ring)] = float(step(params, tok))
    gathered = [p.full_tensor().detach().numpy() for p in tm.leaves(params)]
    if pid == 0:
        np.savez(f"{work}/seq_{ring}.npz", *gathered)
json.dump(out, open(f"{work}/seq{pid}.json", "w"))
print("proc", pid, "seq accepted", flush=True)
multihost.shutdown()
"""


def _jax_seq_step(tree, tokens, ring: bool):
    """JAX's jitted train step on a (1, 1, 2) data x model x seq mesh of
    two CPU devices: the loss and the updated leaves."""
    from jax.sharding import NamedSharding
    cfg = jm.ModelConfig(vocab=64, d_model=32, n_heads=2, n_layers=1,
                         d_ff=64, max_seq=16, dtype="float32",
                         use_ring_attention=ring)
    mesh = Mesh(np.array(CPUS[:2]).reshape(1, 1, 2), ("data", "model", "seq"))
    params = jm.shard_params(tree, mesh)
    opt = jm.make_optimizer()
    tok = jax.device_put(tokens, NamedSharding(mesh, jm.batch_spec(mesh)))
    params, _, loss = jax.jit(jm.make_train_step(cfg, opt, mesh))(
        params, opt.init(params), tok)
    return float(loss), [np.asarray(x) for x in jax.tree.leaves(params)]


def test_multihost_two_process_distributed(tmp_path):
    """test_tpu.py:514 on two gloo ranks: both call
    ``multihost.initialize`` against one rendezvous (a file store), build
    one mesh spanning both, assemble a global tensor from each rank's
    (2, 8) block (``put_sharded``'s multi-process path) and sum it: 48
    on both. Then a mesh with a ``seq`` axis of 2 is accepted: one train
    step, each rank holding half of every row, with ring attention and
    without (the sequence gathered for attention), gives JAX's jitted
    step's loss (rel 1e-5, measured 9.7e-8) and parameters (each leaf
    within 1e-5 of its norm, measured 8.7e-8; by at most lr 3e-4
    anywhere, measured 1.2e-7) on a (1, 1, 2) mesh of two CPU devices."""
    with jax.default_device(CPUS[0]):
        tree = jax.tree.map(np.asarray, jm.init_params(
            jax.random.PRNGKey(0), jm.ModelConfig(
                vocab=64, d_model=32, n_heads=2, n_layers=1, d_ff=64,
                max_seq=16, dtype="float32")))
    tokens = np.random.default_rng(0).integers(0, 64, (2, 8)).astype(
        np.int32)
    flat = {k: tree[k] for k in ("embed", "pos", "ln_f")}
    flat.update({f"0.{k}": v for k, v in tree["layers"][0].items()})
    np.savez(tmp_path / "seq.npz", tokens=tokens, **flat)
    script = tmp_path / "mh_rank.py"
    script.write_text(_RANK)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(i), str(tmp_path / "store"),
         str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True)
        for i in range(2)]
    outs = []
    try:
        with jax.default_device(CPUS[0]):
            ref = {ring: _jax_seq_step(tree, tokens, ring)
                   for ring in (False, True)}
        for p in procs:
            outs.append(p.communicate(timeout=SPAWN_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out[-2000:]}"
        assert f"proc {i} ok" in out and f"proc {i} seq accepted" in out
    import json
    for ring, (loss, leaves) in ref.items():
        for i in range(2):
            got = json.loads((tmp_path / f"seq{i}.json").read_text())
            assert got[str(ring)] == pytest.approx(loss, rel=1e-5)
        port = np.load(tmp_path / f"seq_{ring}.npz")
        assert len(port.files) == len(leaves)
        for k, want in enumerate(leaves):
            p = port[f"arr_{k}"]
            assert np.linalg.norm(p - want) <= 1e-5 * np.linalg.norm(want)
            assert np.abs(p - want).max() <= 3e-4
