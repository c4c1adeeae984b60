"""Port parity: one-device checkpoints of ``curvine_tpu_torch``
(``gpu/broadcast.py``) against ``curvine_tpu/tpu/broadcast.py`` on the CPU.

Mirrors ``test_checkpoint_tree_skeleton`` (test_tpu.py:200), the
one-device part of ``test_checkpoint_roundtrip_and_broadcast`` (:166) and
``test_checkpoint_legacy_pickle_fallback`` (:218). Both packages write
through their own clients into one one-worker ``MiniCluster``
(``lost_timeout_ms=30_000``, as ``tests/test_torch_client.py`` does):
manifests and tensor files are compared byte for byte, and each package
loads the other's checkpoint bit for bit. The slice as a whole: the
port's loss from parameters loaded out of a JAX-written checkpoint
against the JAX loss, at ``tests/test_torch_model.py``'s f32 tolerance
(rtol 1e-5) and, in bf16, its logits tolerance (0.05 of the largest
logit)."""

import dataclasses
import json
import pickle

import numpy as np
import pytest

import jax

import torch

from curvine_tpu.common import errors as jerr
from curvine_tpu.testing import MiniCluster
from curvine_tpu.tpu import broadcast as jb
from curvine_tpu.tpu import model as jm
from curvine_tpu_torch.client.unified import CurvineClient
from curvine_tpu_torch.common import errors as perr
from curvine_tpu_torch.common.conf import ClusterConf
from curvine_tpu_torch.gpu import broadcast as pb
from curvine_tpu_torch.gpu import ingest
from curvine_tpu_torch.gpu import model as tm

CPU = torch.device("cpu")
CPUS = jax.devices("cpu")
BF16 = jm.ModelConfig.tiny()
F32 = dataclasses.replace(BF16, dtype="float32")


@pytest.fixture(autouse=True)
def _cpu_default():
    with jax.default_device(CPUS[0]):
        yield


def _cluster():
    return MiniCluster(workers=1, lost_timeout_ms=30_000)


def _port_client(mc, **client) -> CurvineClient:
    conf = ClusterConf()
    conf.client.master_addrs = list(mc.conf.client.master_addrs)
    conf.client.block_size = mc.conf.client.block_size
    for k, v in client.items():
        setattr(conf.client, k, v)
    return CurvineClient(conf)


def _jax_tree(cfg, seed):
    return jax.tree.map(np.asarray,
                        jm.init_params(jax.random.PRNGKey(seed), cfg))


def _bits(x) -> np.ndarray:
    """A leaf's bytes: a torch tensor's or a (JAX or numpy) array's."""
    if isinstance(x, torch.Tensor):
        return x.detach().contiguous().reshape(-1).view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(x)).reshape(-1).view(np.uint8)


def _assert_same_leaves(port_leaves, ref_leaves):
    """Port tensors against the reference's leaves (tensors, or arrays of
    numpy's or ml_dtypes' dtypes): dtype name, shape and bytes."""
    assert len(port_leaves) == len(ref_leaves)
    for p, r in zip(port_leaves, ref_leaves):
        name = pb._NAMES[r.dtype] if isinstance(r, torch.Tensor) else \
            str(np.asarray(r).dtype)
        assert pb._NAMES[p.dtype] == name
        assert tuple(p.shape) == tuple(np.shape(r))
        np.testing.assert_array_equal(_bits(p), _bits(r))


async def _files(read, path, n):
    return [await read(f"{path}/{name}") for name in
            ["manifest.json"] + [f"t{i:05d}.bin" for i in range(n)]]


def test_checkpoint_tree_skeleton():
    """The same skeleton JSON and leaf order from both packages on one
    tree (dict keys sorted, lists, tuples, None); a non-string key is
    refused by both."""
    def tree(mk):
        return {"b": [mk(3), (mk(2), None)], "a": mk(4),
                "c": {"z": (), "y": [mk(1)]}}
    jskel, jleaves = jb._tree_skeleton(tree(np.arange))
    pskel, pleaves = pb._tree_skeleton(tree(torch.arange))
    assert json.dumps(pskel) == json.dumps(jskel)
    assert [tuple(x.shape) for x in pleaves] == \
        [x.shape for x in jleaves] == [(4,), (3,), (2,), (1,)]
    back = pb._tree_build(pskel, pleaves)
    assert isinstance(back["b"][1], tuple) and back["b"][1][1] is None
    assert back["c"]["z"] == () and back["b"][0] is pleaves[1]
    assert json.dumps(pb._tree_skeleton(back)[0]) == json.dumps(jskel)
    for mod in (jb, pb):
        with pytest.raises(TypeError):
            mod._tree_skeleton({1: np.arange(2)})


@pytest.mark.parametrize("cfg", [BF16, F32], ids=["bf16", "f32"])
async def test_checkpoint_files_equal_and_cross_load(cfg):
    """The port's checkpoint of a JAX tree (carried over with
    ``params_from_jax``) is the JAX package's, file for file and byte for
    byte; each package loads the other's bit for bit; neither writes a
    ``treedef.pkl``."""
    tree = _jax_tree(cfg, 7)
    params = tm.params_from_jax(tree, device="cpu")
    n = len(jax.tree.leaves(tree))
    async with _cluster() as mc:
        jc = mc.client()
        pc = _port_client(mc)
        try:
            await jb.save_checkpoint(jc, "/ckpt/jax", tree)
            await pb.save_checkpoint(pc, "/ckpt/port", params)
            jfiles = await _files(jc.read_all, "/ckpt/jax", n)
            pfiles = await _files(pc.read_all, "/ckpt/port", n)
            assert pfiles == jfiles
            manifest = json.loads(pfiles[0])
            assert [t["dtype"] for t in manifest["tensors"]] == \
                [cfg.dtype] * n
            for path in ("/ckpt/jax", "/ckpt/port"):
                for c, errs in ((jc, jerr), (pc, perr)):
                    with pytest.raises(errs.FileNotFound):
                        await c.meta.file_status(f"{path}/treedef.pkl")
            # every tensor file went by short circuit
            assert pc.counters["sc.bytes.written"] == \
                pc.counters["write.bytes"] == sum(map(len, pfiles))
            # the port loads the JAX checkpoint, JAX the port's
            port_back = await pb.load_checkpoint(pc, "/ckpt/jax")
            jax_back = await jb.load_checkpoint(jc, "/ckpt/port")
            _assert_same_leaves(tm.leaves(port_back),
                                jax.tree.leaves(tree))
            _assert_same_leaves(tm.leaves(params), jax.tree.leaves(jax_back))
            assert jax.tree.structure(jax_back) == jax.tree.structure(tree)
            assert sorted(port_back) == sorted(params)
            assert all(not t.requires_grad and t.device == CPU
                       for t in tm.leaves(port_back))
        finally:
            await pc.close()


async def test_checkpoint_roundtrip_one_device():
    """The one-device part of ``test_checkpoint_roundtrip_and_broadcast``:
    the port saves its own parameters and loads them back equal, on the
    CPU when asked for, through READ_BLOCK when the short circuit is
    off; the loaded tensors own their memory."""
    cfg = tm.ModelConfig(**dataclasses.asdict(BF16))
    params = tm.init_params(torch.Generator().manual_seed(7), cfg, CPU)
    tree = {"params": params, "step": torch.tensor(3, dtype=torch.int64),
            "mask": torch.tensor([True, False, True]), "none": None,
            "pair": (torch.zeros(0, 4), np.float64(0.5))}
    async with _cluster() as mc:
        pc = _port_client(mc)
        rb = _port_client(mc, short_circuit=False)
        try:
            await pb.save_checkpoint(pc, "/ckpt/step0", tree)
            for client, how in ((pc, "sc.bytes.read"),
                                (rb, "read.zero_copy_bytes")):
                back = await pb.distribute_checkpoint_to_device(
                    client, "/ckpt/step0", torch.device("cpu"))
                a, b = pb._tree_skeleton(tree), pb._tree_skeleton(back)
                assert json.dumps(a[0]) == json.dumps(b[0])
                _assert_same_leaves(b[1], a[1])
                assert back["none"] is None
                assert isinstance(back["pair"], tuple)
                assert back["pair"][1].dtype == torch.float64
                assert client.counters[how] > 0
                back["params"]["embed"].add_(1)        # owns its memory
            assert "read.zero_copy_bytes" not in pc.counters
            assert "sc.bytes.read" not in rb.counters
            with pytest.raises(perr.FileNotFound):
                await pc.meta.file_status("/ckpt/step0/treedef.pkl")
        finally:
            await pc.close()
            await rb.close()


async def test_checkpoint_placer_stages_every_tensor():
    """``load_checkpoint`` hands each tensor's bytes to the placer and
    delivers every one at the end; a multi-block tensor (the embedding,
    at a 4 KiB block size) comes through ``read_all``."""
    cfg = tm.ModelConfig(**dataclasses.asdict(BF16))
    params = tm.init_params(torch.Generator().manual_seed(1), cfg, CPU)

    class Counting(ingest.DeviceCopier):
        def __init__(self):
            super().__init__("cpu")
            self.sizes, self.delivered = [], 0

        def transfer(self, batch):
            self.sizes.append(batch.nbytes)
            return super().transfer(batch)

        def deliver(self, item):
            self.delivered += 1
            return super().deliver(item)

    async with _cluster() as mc:
        pc = _port_client(mc, block_size=4096)
        try:
            await pb.save_checkpoint(pc, "/ckpt/p", params)
            r = await pc.open("/ckpt/p/t00000.bin")
            assert len(r.blocks.block_locs) > 1       # embed spans blocks
            await r.close()
            placer = Counting()
            back = await pb.load_checkpoint(pc, "/ckpt/p", placer=placer)
            leaves = tm.leaves(params)
            # in the order the bytes landed, not the manifest's
            assert sorted(placer.sizes) == sorted(p.nbytes for p in leaves)
            assert placer.delivered == len(leaves)
            _assert_same_leaves(tm.leaves(back), leaves)
        finally:
            await pc.close()


async def test_checkpoint_legacy_manifests_refused():
    """A bare-list manifest raises the reference's ValueError without
    ``allow_pickle``; with it, the pickled JAX treedef is refused by name
    (only JAX rebuilds it). A manifest naming a dtype the port does not
    map, or a tensor file of the wrong length, raises."""
    params = {"w": np.arange(6, dtype=np.float32).reshape(2, 3)}
    flat, treedef = jax.tree.flatten(params)
    async with _cluster() as mc:
        jc = mc.client()
        pc = _port_client(mc)
        try:
            await jc.meta.mkdir("/ckpt/legacy")
            await jc.write_all("/ckpt/legacy/t00000.bin", flat[0].tobytes())
            await jc.write_all("/ckpt/legacy/manifest.json", json.dumps(
                [{"name": "t00000.bin", "dtype": "float32",
                  "shape": [2, 3]}]).encode())
            await jc.write_all("/ckpt/legacy/treedef.pkl",
                               pickle.dumps(treedef))
            for mod, c in ((jb, jc), (pb, pc)):
                with pytest.raises(ValueError, match="allow_pickle=True"):
                    await mod.load_checkpoint(c, "/ckpt/legacy")
            back = await jb.load_checkpoint(jc, "/ckpt/legacy",
                                            allow_pickle=True)
            np.testing.assert_array_equal(back["w"], params["w"])
            with pytest.raises(NotImplementedError, match="only JAX"):
                await pb.load_checkpoint(pc, "/ckpt/legacy",
                                         allow_pickle=True)
            for name, entry in (("dtype", {"dtype": "complex64"}),
                                ("shape", {"shape": [2, 4]})):
                t = {"name": "t00000.bin", "dtype": "float32",
                     "shape": [2, 3], **entry}
                await pc.write_all(f"/ckpt/{name}/manifest.json", json.dumps(
                    {"tensors": [t], "tree": {"k": "leaf", "i": 0}}).encode())
                await pc.write_all(f"/ckpt/{name}/t00000.bin",
                                   flat[0].tobytes())
                with pytest.raises(ValueError, match=name):
                    await pb.load_checkpoint(pc, f"/ckpt/{name}")
        finally:
            await pc.close()


async def test_distribute_to_device_needs_cuda_unless_the_cpu_is_asked_for(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    async with _cluster() as mc:
        pc = _port_client(mc)
        try:
            await pb.save_checkpoint(pc, "/ckpt/d", {"x": torch.ones(3)})
            with pytest.raises(RuntimeError, match="no CUDA device"):
                await pb.distribute_checkpoint_to_device(pc, "/ckpt/d")
            back = await pb.distribute_checkpoint_to_device(pc, "/ckpt/d",
                                                            "cpu")
            assert torch.equal(back["x"], torch.ones(3))
        finally:
            await pc.close()


@pytest.mark.parametrize("cfg", [F32, BF16], ids=["f32", "bf16"])
async def test_loss_from_a_jax_checkpoint_matches_jax(cfg):
    """The slice as a whole: the JAX package saves its parameters through
    its client, the port loads them through its own onto the CPU, and
    the port's loss and logits from them match the JAX ones."""
    tree = _jax_tree(cfg, 3)
    tokens = np.random.default_rng(4).integers(0, cfg.vocab, (2, 33),
                                               dtype=np.int32)
    async with _cluster() as mc:
        pc = _port_client(mc)
        try:
            await jb.save_checkpoint(mc.client(), "/ckpt/model", tree)
            params = await pb.distribute_checkpoint_to_device(
                pc, "/ckpt/model", CPU)
        finally:
            await pc.close()
    pcfg = tm.ModelConfig(**dataclasses.asdict(cfg))
    tok = torch.from_numpy(tokens)
    with torch.no_grad():
        loss = tm.loss_fn(params, tok, pcfg).item()
        logits = tm.forward(params, tok, pcfg).float().numpy()
    ref_loss = float(jax.jit(jm.loss_fn, static_argnums=2)(tree, tokens,
                                                            cfg))
    ref_logits = np.asarray(jm.forward(tree, tokens, cfg)).astype(np.float32)
    if cfg.dtype == "float32":
        np.testing.assert_allclose(loss, ref_loss, rtol=1e-5)
        np.testing.assert_allclose(logits, ref_logits, rtol=1e-4, atol=1e-4)
    else:
        scale = float(np.abs(ref_logits).max())
        assert np.abs(logits - ref_logits).max() <= 0.05 * scale
