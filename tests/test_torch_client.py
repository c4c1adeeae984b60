"""Port parity: the cache client of ``curvine_tpu_torch`` (its wire codec,
framing, connections, metadata client, reader, writer) and the cache-fed
feed against the JAX package, on the CPU.

The port's client talks to a one-worker ``MiniCluster`` of the JAX
package (``lost_timeout_ms=30_000``, as ``tests/test_torch_vector.py``
does): bytes either client writes, the other reads back bit for bit.
Mirrors ``test_cache_feed_to_device`` (test_tpu.py:83, one device),
``test_train_from_cache_e2e`` (test_train_e2e.py:23, its training part),
``test_step_profiler_through_train_feed`` (test_obs.py:207) and the
prefetch-window tests of test_cache_admission.py:271-352 through the
port's ``advise``. One case runs the cluster launcher
``scripts/card_cluster.py`` with the port's codec in place of
``msgpack``, as it runs on a machine without that package."""

import asyncio
import dataclasses
import json
import os
import subprocess
import sys

import msgpack
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import torch

from curvine_tpu.common import errors as jerr
from curvine_tpu.common.epoch import epoch_shard_order
from curvine_tpu.common.types import JobState
from curvine_tpu.rpc import frame as jframe
from curvine_tpu.testing import MiniCluster
from curvine_tpu.tpu import loader as jax_loader
from curvine_tpu_torch.client.unified import CurvineClient
from curvine_tpu_torch.common import errors as perr
from curvine_tpu_torch.common.conf import ClusterConf
from curvine_tpu_torch.gpu import loader
from curvine_tpu_torch.gpu import model as tm
from curvine_tpu_torch.rpc import frame, wirepack
from curvine_tpu_torch.rpc.codes import RpcCode

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
MiB = 1 << 20


def _cluster(**kw):
    return MiniCluster(workers=1, lost_timeout_ms=30_000, **kw)


def _port_client(mc, **client) -> CurvineClient:
    conf = ClusterConf()
    conf.client.master_addrs = list(mc.conf.client.master_addrs)
    conf.client.block_size = mc.conf.client.block_size
    for k, v in client.items():
        setattr(conf.client, k, v)
    return CurvineClient(conf)


# ------------------------------------------------------------ wirepack

_INT_EDGES = [0, 1, 31, 32, 127, 128, 255, 256, 65535, 65536, 2**32 - 1,
              2**32, 2**63 - 1, 2**63, 2**64 - 1, -1, -32, -33, -128,
              -129, -2**15, -2**15 - 1, -2**31, -2**31 - 1, -2**63]

_scalars = (st.none() | st.booleans()
            | st.integers(-2**63, 2**64 - 1) | st.sampled_from(_INT_EDGES)
            | st.floats(allow_nan=True) | st.text() | st.binary())
_values = st.recursive(
    _scalars,
    lambda inner: (st.lists(inner, max_size=20)
                   | st.tuples(inner, inner)
                   | st.dictionaries(st.text() | st.integers(-2**63,
                                                             2**64 - 1),
                                     inner, max_size=20)),
    max_leaves=60)


@settings(max_examples=300, deadline=None)
@given(_values)
def test_wirepack_bytes_equal_msgpack_and_round_trip(v):
    b = wirepack.packb(v, use_bin_type=True)
    assert b == msgpack.packb(v, use_bin_type=True)
    got = wirepack.unpackb(b, raw=False, strict_map_key=False)
    ref = msgpack.unpackb(b, raw=False, strict_map_key=False)
    # NaN != NaN: compare the values through their encodings
    assert wirepack.packb(got) == msgpack.packb(ref) == \
        msgpack.packb(msgpack.unpackb(b, raw=False, strict_map_key=False,
                                      use_list=True))
    assert repr(wirepack.unpackb(b, raw=True, strict_map_key=False)) == \
        repr(msgpack.unpackb(b, raw=True, strict_map_key=False))


@pytest.mark.parametrize("n", [0, 15, 16, 31, 32, 255, 256, 65535, 65536])
def test_wirepack_lengths_take_the_smallest_form(n):
    for v in ("x" * n, b"x" * n, bytearray(n), memoryview(b"y" * n),
              list(range(n)), tuple(range(n)),
              {str(i): i for i in range(n)}):
        assert wirepack.packb(v) == msgpack.packb(v, use_bin_type=True)
    for v in _INT_EDGES:
        assert wirepack.packb(v) == msgpack.packb(v)
        assert wirepack.unpackb(wirepack.packb(v)) == v


def test_wirepack_raw_strict_and_refusals():
    b = wirepack.packb({"k": ["é", b"\x00"], 3: None})
    assert wirepack.unpackb(b, raw=True, strict_map_key=False) == \
        {b"k": ["é".encode(), b"\x00"], 3: None}
    with pytest.raises(ValueError):
        wirepack.unpackb(b)                  # strict_map_key: int key
    assert wirepack.unpackb(wirepack.packb({"a": 1})) == {"a": 1}
    for bad in (object(), {1, 2}, np.int64(3), {(1, 2): 3}, {b"k": 1},
                complex(1, 2)):
        with pytest.raises(TypeError):
            wirepack.packb(bad)
    for big in (2**64, -2**63 - 1):
        with pytest.raises(OverflowError):
            wirepack.packb(big)
    with pytest.raises(ValueError):
        wirepack.packb(1, use_bin_type=False)
    for broken in (b"\xa5ab", b"\x92\x01", b"\xc1", b"\xd4\x01\x02",
                   wirepack.packb(1) + b"\x00", b"\xa2\xff\xfe"):
        with pytest.raises(ValueError):
            wirepack.unpackb(broken)
    with pytest.raises(wirepack.UnpackException):
        wirepack.unpackb(b"")
    assert msgpack.unpackb(wirepack.packb(float("inf"))) == float("inf")
    assert wirepack.unpackb(msgpack.packb(1.5, use_single_float=True)) == 1.5


# ------------------------------------------------------------- framing

def _decode(wire: bytes):
    """A whole frame through the port's envelope and header parsing:
    (code, req_id, status, flags, header, data)."""
    end, code, req_id, status, flags, header, data_len = \
        frame.decode_envelope(wire, 0, len(wire))
    assert len(wire) == end + data_len
    return code, req_id, status, flags, header, wire[end:]


def _frames():
    hdr = {"block_id": 2**40 + 5, "offset": 0, "len": 3 * MiB,
           "chunk_size": 4 * MiB}
    yield dict(code=int(RpcCode.READ_BLOCK), req_id=7, header=hdr)
    yield dict(code=int(RpcCode.READ_BLOCK), req_id=7, status=0,
               flags=frame.Flags.RESPONSE | frame.Flags.EOF,
               header={"block_crc32": 0xDEADBEEF,
                       "block_crc_algo": "crc32c"}, data=b"\x01" * 1000)
    yield dict(code=int(RpcCode.FILE_STATUS), req_id=2**63,
               data=frame.pack({"path": "/a", "user": "root",
                                "groups": ["root"]}))
    yield dict(code=int(RpcCode.WRITE_BLOCK), req_id=9,
               flags=frame.Flags.CHUNK, data=memoryview(b"\xff" * 70000))


@pytest.mark.parametrize("i", range(4))
def test_message_bytes_equal_the_reference_frame(i):
    kw = list(_frames())[i]
    got = b"".join(bytes(b) for b in frame.Message(**kw).encode())
    ref = b"".join(bytes(b) for b in jframe.Message(**kw).encode())
    assert got == ref
    assert _decode(ref) == (kw["code"], kw["req_id"], kw.get("status", 0),
                            kw.get("flags", 0), kw.get("header", {}),
                            bytes(kw.get("data", b"")))


def test_error_responses_decode_to_the_port_errors():
    req = jframe.Message(code=int(RpcCode.FILE_STATUS), req_id=3)
    for e, cls in ((jerr.FileNotFound("/nope"), perr.FileNotFound),
                   (jerr.NotLeader("elsewhere"), perr.NotLeader),
                   (jerr.Throttled("busy", retry_after_ms=25),
                    perr.CurvineError),
                   (KeyError("k"), perr.CurvineError)):
        if isinstance(e, jerr.NotLeader):
            e.leader_hint, e.members = "10.0.0.2:8995", ["a:1", "b:2"]
        wire = b"".join(bytes(b) for b in jframe.error_for(req, e).encode())
        code, req_id, status, flags, header, data = _decode(wire)
        msg = frame.Message(code=code, req_id=req_id, status=status,
                            flags=flags, header=header, data=data)
        assert msg.is_response and msg.is_eof and req_id == 3
        with pytest.raises(cls) as got:
            msg.check()
        assert got.value.code == (e.code if isinstance(e, jerr.CurvineError)
                                  else jerr.ErrorCode.IO)
        assert got.value.retryable == (
            isinstance(e, jerr.CurvineError) and e.retryable)
        if isinstance(e, jerr.Throttled):
            assert got.value.retry_after_ms == 25
        if isinstance(e, jerr.NotLeader):
            assert got.value.leader_hint == "10.0.0.2:8995"
            assert got.value.members == ["a:1", "b:2"]
    with pytest.raises(perr.CurvineError, match="frame length"):
        frame.decode_envelope(b"\x00\x00\x00\x01" + b"\x00" * 16, 0, 20)


def test_error_codes_and_wire_types_mirror_the_reference():
    from curvine_tpu.common import types as jt
    from curvine_tpu_torch.common import types as pt
    assert {e.name: int(e) for e in perr.ErrorCode} == \
        {e.name: int(e) for e in jerr.ErrorCode}
    assert {e for e in perr.ErrorCode if e.retryable} == \
        {perr.ErrorCode(int(e)) for e in jerr.ErrorCode if e.retryable}
    from curvine_tpu.rpc.codes import RpcCode as JCode
    assert all(JCode[c.name] == c for c in RpcCode)
    for name in ("StoragePolicy", "FileStatus", "WorkerAddress",
                 "ExtendedBlock", "BlockLocation", "LocatedBlock",
                 "FileBlocks", "CommitBlock"):
        j, p = getattr(jt, name), getattr(pt, name)
        assert [f.name for f in dataclasses.fields(j)] == \
            [f.name for f in dataclasses.fields(p)]
        assert p().to_wire() == j().to_wire()          # the defaults
    lb = jt.LocatedBlock(
        block=jt.ExtendedBlock(id=9, len=5, storage_type=jt.StorageType.MEM),
        offset=64, locs=[jt.WorkerAddress(worker_id=1, hostname="h",
                                          ip_addr="1.2.3.4", rpc_port=7)],
        storage_types=[jt.StorageType.SSD])
    fb = jt.FileBlocks(status=jt.FileStatus(id=3, path="/p", len=69),
                       block_locs=[lb])
    assert pt.FileBlocks.from_wire(fb.to_wire()).to_wire() == fb.to_wire()


def test_client_conf_mirrors_the_reference_and_loads_toml(tmp_path,
                                                         monkeypatch):
    from curvine_tpu.common.conf import ClientConf as JConf
    from curvine_tpu.common.conf import ClusterConf as JClusterConf
    port = dataclasses.asdict(ClusterConf().client)
    ref = dataclasses.asdict(JConf())
    assert port == {k: ref[k] for k in port}
    assert port["short_circuit"] and port["read_verify"]
    p = tmp_path / "cluster.toml"
    p.write_text('cluster_name = "c"\n[master]\nrpc_port = 1\n'
                 '[client]\nmaster_addrs = ["10.0.0.1:8995"]\n'
                 'block_size = 4194304\nshort_circuit = false\n'
                 'meta_cache = true\n')
    cc = ClusterConf.load(str(p)).client
    assert cc.master_addrs == ["10.0.0.1:8995"]
    assert cc.block_size == 4 * MiB and not cc.short_circuit
    assert cc.rpc_timeout_ms == ref["rpc_timeout_ms"]
    # the replica count and the fan-out floor are fields
    p.write_text('[client]\nreplicas = 3\nwrite_min_replicas = 2\n')
    cc = ClusterConf.load(str(p)).client
    assert (cc.replicas, cc.write_min_replicas) == (3, 2)
    # so are the identity, the tier, the chunk, the retry policy and the
    # replay buffer, which the reference loads alike
    six = ("user", "groups", "storage_type", "write_chunk_size",
           "conn_retry_max", "conn_retry_base_ms", "write_replay_buffer")
    assert set(six) <= set(port)
    p.write_text('[client]\nuser = "bob"\ngroups = ["ml", "ops"]\n'
                 'storage_type = "ssd"\nwrite_chunk_size = 65536\n'
                 'conn_retry_max = 5\nconn_retry_base_ms = 20\n'
                 'write_replay_buffer = false\n')
    for k in [k for k in os.environ if k.startswith("CURVINE_")]:
        monkeypatch.delenv(k)
    cc = dataclasses.asdict(ClusterConf.load(str(p)).client)
    jc = dataclasses.asdict(JClusterConf.load(str(p)).client)
    assert cc == {k: jc[k] for k in cc}
    assert [cc[k] for k in six] == ["bob", ["ml", "ops"], "ssd", 65536, 5,
                                    20, False]


# ------------------------------------------------ clients against the cluster

@pytest.mark.parametrize("size", [1, 4 * MiB - 1, 2 * 4 * MiB + 12345])
async def test_bytes_cross_between_the_jax_and_port_clients(size):
    data = np.random.default_rng(size).integers(
        0, 256, size, dtype=np.uint8).tobytes()
    async with _cluster() as mc:
        jc = mc.client()
        pc = _port_client(mc)
        pc_rb = _port_client(mc, short_circuit=False)
        try:
            await jc.write_all("/x/jax.bin", data)
            await pc.write_all("/x/port.bin", data)
            assert await jc.read_all("/x/port.bin") == data
            for path in ("/x/jax.bin", "/x/port.bin"):
                r = await pc.open(path)
                assert r.len == size
                got = bytearray()
                for lb in r.blocks.block_locs:     # block by block
                    v = await r.mmap_view(lb.offset, lb.block.len)
                    assert v is not None
                    got += v.tobytes()
                assert bytes(got) == data
                whole = await r.mmap_view(0, size)      # spans blocks?
                assert (whole is None) == (len(r.blocks.block_locs) > 1)
                assert whole is None or whole.tobytes() == data
                await r.close()
                assert await pc_rb.read_all(path) == data
                r = await pc_rb.open(path)
                assert await r.mmap_view(0, 1) is None     # no short circuit
                assert await r.pread(size // 2, 100) == \
                    data[size // 2:size // 2 + 100]
                await r.close()
            st = await pc.meta.file_status("/x/port.bin")
            assert st.len == size and st.is_complete
            assert sorted(s.path for s in await pc.meta.list_status("/x")) \
                == ["/x/jax.bin", "/x/port.bin"]
            one_block = size <= mc.conf.client.block_size
            assert pc.counters["sc.bytes.read"] == 2 * size * (1 + one_block)
            assert pc_rb.counters["read.zero_copy_bytes"] == \
                2 * size + 2 * len(data[size // 2:size // 2 + 100])
            assert "read.zero_copy_bytes" not in pc.counters
        finally:
            await pc.close()
            await pc_rb.close()


async def test_corrupt_block_is_caught_not_returned():
    data = np.random.default_rng(5).integers(0, 256, 3 * MiB,
                                             dtype=np.uint8).tobytes()
    async with _cluster() as mc:
        pc = _port_client(mc)
        try:
            await mc.client().write_all("/c.bin", data)
            r = await pc.open("/c.bin")
            lb = r.blocks.block_locs[0]
            path = await r._local_path(lb)
            with open(path, "r+b") as f:
                f.seek(12345)
                b = f.read(1)
                f.seek(12345)
                f.write(bytes([b[0] ^ 1]))
            assert await r.mmap_view(0, len(data)) is None
            assert pc.counters["read.checksum_mismatch"] == 1
            # the worker streams the same bad bytes: READ_BLOCK's crc
            # catches them too
            with pytest.raises(perr.AbnormalData):
                await r.read_all()
            await r.close()
        finally:
            await pc.close()


async def test_missing_and_unfinished_files():
    async with _cluster() as mc:
        pc = _port_client(mc)
        try:
            with pytest.raises(perr.FileNotFound):
                await pc.open("/nope")
            with pytest.raises(perr.FileNotFound):
                await pc.meta.list_status("/nope")
            w = await pc.create("/open.bin")
            await w.write(b"abc")
            with pytest.raises(perr.Uncompleted):
                await pc.read_all("/open.bin")
            await w.close()
            assert await pc.read_all("/open.bin") == b"abc"
            await pc.meta.mkdir("/d/e")
            await pc.meta.delete("/d", recursive=True)
            with pytest.raises(perr.FileNotFound):
                await pc.meta.file_status("/d/e")
        finally:
            await pc.close()


async def test_reads_fail_over_to_the_next_replica():
    """Two workers, a file the JAX client wrote with two replicas: the
    worker the port reads from stops mid-read, and the rest of the read
    streams from the other replica. With both stopped the read raises."""
    data = np.random.default_rng(11).integers(
        0, 256, 2 * 4 * MiB + 12345, dtype=np.uint8).tobytes()
    async with MiniCluster(workers=2, lost_timeout_ms=30_000) as mc:
        await mc.client().write_all("/rep.bin", data, replicas=2)
        pc = _port_client(mc, short_circuit=False)
        try:
            r = await pc.open("/rep.bin")
            assert all(len(lb.locs) == 2 for lb in r.blocks.block_locs)
            head = await r.read(MiB)
            first = r._pick_loc(r.blocks.block_locs[0]).worker_id
            await mc.kill_worker(next(i for i, w in enumerate(mc.workers)
                                      if w.worker_id == first))
            assert head + await r.read() == data
            assert pc.counters["read.zero_copy_bytes"] == len(data)
            await r.close()
            assert await pc.read_all("/rep.bin") == data     # a new reader
            await mc.kill_worker(next(i for i, w in enumerate(mc.workers)
                                      if w.worker_id != first))
            r = await pc.open("/rep.bin")
            with pytest.raises(perr.CurvineError):
                await r.pread(0, 100)
            await r.close()
        finally:
            await pc.close()


async def test_master_calls_follow_the_leader_hint_and_skip_dead_masters(
        tmp_path):
    """Three raft masters: a call sent to a follower reaches the leader
    with one retry (its NOT_LEADER error names the leader), and a master
    that does not answer is skipped (CONNECT)."""
    from curvine_tpu.testing.cluster import MiniRaftCluster
    rc = MiniRaftCluster(n=3, spares=1, base_dir=str(tmp_path))
    await rc.start()
    clients = []
    try:
        leader = await rc.wait_leader()
        lid = next(n for n, m in rc.masters.items() if m is leader)
        lead = rc.addrs[lid - 1]
        followers = [n for n in rc.masters if n != lid]
        await _wait(lambda: all(rc.masters[n].raft.leader_id == lid
                                for n in followers))
        dead = rc.addrs[3]                       # the spare: no server
        firsts = [rc.addrs[n - 1] for n in followers] + [dead]
        for i, first in enumerate(firsts):
            conf = ClusterConf()
            conf.client.master_addrs = [first, lead]
            pc = CurvineClient(conf)
            clients.append(pc)
            pc.meta.retry.max_retries = 1
            st = await pc.meta.mkdir(f"/led{i}")
            assert st.path == f"/led{i}" and st.is_dir
            assert pc.meta.masters[pc.meta._active] == lead
            assert (await pc.meta.file_status(f"/led{i}")).is_dir
    finally:
        for pc in clients:
            await pc.close()
        await rc.stop()


def test_leader_hint_and_member_list_move_the_active_master():
    """``FsClient._note_leader_hint``: a NOT_LEADER's member list
    replaces the client's, its hint becomes the active master (added when
    the list lacks it); an error without a hint rotates to the next."""
    from curvine_tpu_torch.client.fs_client import FsClient
    conf = ClusterConf()
    conf.client.master_addrs = ["a:1", "b:2"]
    fs = FsClient(conf)
    e = perr.NotLeader("follower")
    e.leader_hint, e.members = "c:3", ["b:2", "a:1", "c:3"]
    fs._note_leader_hint(e)          # the hint, not the next member
    assert fs.masters == ["b:2", "a:1", "c:3"] and fs._active == 2
    fs._note_leader_hint(perr.ConnectError("down"))
    assert fs._active == 0
    e = perr.NotLeader("follower")
    e.leader_hint = "d:4"
    fs._note_leader_hint(e)
    assert fs.masters == ["b:2", "a:1", "c:3", "d:4"] and fs._active == 3


def test_writer_refuses_a_block_placed_on_more_than_one_worker():
    """The short circuit refuses a block of two locations: the writer
    asks no worker for a grant and opens one WRITE_BLOCK leg per
    location, in the locations' order."""
    from curvine_tpu_torch.client.writer import FsWriter
    from curvine_tpu_torch.common import types as pt
    opened = []

    class Conn:
        def __init__(self, addr):
            self.addr = addr

        async def call(self, code, data=b""):
            raise AssertionError(f"{code} asked of {self.addr}")

        async def open_upload(self, code, header):
            opened.append((self.addr, code, header["block_id"]))
            return object()

    class Pool:
        async def get(self, addr):
            return Conn(addr)

    w = FsWriter(None, "/f", Pool(), block_size=MiB, short_circuit=True)
    locs = [pt.WorkerAddress(worker_id=i, hostname="127.0.0.1",
                             ip_addr="127.0.0.1", rpc_port=i)
            for i in (1, 2)]
    w._block = pt.LocatedBlock(block=pt.ExtendedBlock(id=3, len=0),
                               offset=0, locs=locs)
    asyncio.run(w._open_block())
    assert opened == [("127.0.0.1:1", RpcCode.WRITE_BLOCK, 3),
                      ("127.0.0.1:2", RpcCode.WRITE_BLOCK, 3)]
    assert [loc.worker_id for loc in w._upload_locs] == [1, 2]
    assert w._sc_file is None and len(w._uploads) == 2


@pytest.mark.parametrize("seed,drop", [(None, True), (None, False),
                                       (7, True), (7, False)])
async def test_cache_shard_source_matches_jax(seed, drop):
    tokens = np.arange(4096 + 77, dtype=np.int32) * 7 - 5
    async with _cluster() as mc:
        jc = mc.client()
        pc = _port_client(mc)
        try:
            shards = await loader.write_token_shards(pc, "/ds/p", tokens,
                                                     shard_tokens=1000)
            assert [p.replace("/ds/p", "/ds/j") for p in shards] == \
                await jax_loader.write_token_shards(jc, "/ds/j", tokens,
                                                    shard_tokens=1000)
            ref = [b.copy() async for b in jax_loader.CacheShardSource(
                jc, "/ds/j", batch=4, seq_len=128, shuffle_seed=seed,
                drop_remainder=drop).batches()]
            for path in ("/ds/p", "/ds/j"):
                src = loader.CacheShardSource(pc, path, batch=4, seq_len=128,
                                              shuffle_seed=seed,
                                              drop_remainder=drop)
                got = [b.copy() async for b in src.batches()]
                assert len(got) == len(ref) > 0
                assert all(g.dtype == np.int32 and np.array_equal(g, r)
                           for g, r in zip(got, ref))
                assert src.epoch == 1
                names = [p.rsplit("/", 1)[1] for p in shards]
                assert await src.shards() == epoch_shard_order(
                    [f"{path}/{n}" for n in names], seed, 1)
        finally:
            await pc.close()


async def test_write_token_shards_removes_stale_shards():
    async with _cluster() as mc:
        pc = _port_client(mc)
        try:
            await loader.write_token_shards(pc, "/ds", np.arange(5000),
                                            1000)
            out = await loader.write_token_shards(pc, "/ds", np.arange(2500),
                                                  1000)
            assert [s.path for s in await pc.meta.list_status("/ds")] == out
            assert len(out) == 3
            src = loader.CacheShardSource(pc, "/ds", 1, 500)
            got = np.concatenate([b.ravel() async for b in src.batches()])
            assert np.array_equal(got, np.arange(2500, dtype=np.int32))
        finally:
            await pc.close()


async def test_cache_feed_to_device():
    async with _cluster() as mc:
        pc = _port_client(mc)
        try:
            tokens = np.arange(4096, dtype=np.int32)
            shards = await loader.write_token_shards(pc, "/ds/train", tokens,
                                                     shard_tokens=1000)
            assert len(shards) == 5
            src = loader.CacheShardSource(pc, "/ds/train", batch=4,
                                          seq_len=128)
            host = [b async for b in src.batches()]
            assert all(b.shape == (4, 128) for b in host)
            assert sum(b.size for b in host) == 4096 - 4096 % 512
            got = np.concatenate([b.reshape(-1) for b in host])
            assert np.array_equal(got, tokens[:got.size])
            feed = loader.GpuTrainFeed(pc, "/ds/train", batch=4, seq_len=128,
                                       device=CPU)
            dev = [b async for b in feed]
            assert len(dev) == len(host)
            assert all(isinstance(d, torch.Tensor) and d.device == CPU
                       and d.dtype == torch.int32 for d in dev)
            assert all(np.array_equal(d.numpy(), h)
                       for d, h in zip(dev, host))
        finally:
            await pc.close()


@pytest.fixture
def one_torch_thread():
    """A model this small gains nothing from more intra-op threads, and a
    process's eight spinning ones, beside other test processes doing the
    same, slowed three such runs 40-fold on an 8-core machine."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


async def test_train_from_cache_e2e(one_torch_thread):
    cfg = tm.ModelConfig(vocab=128, d_model=64, n_heads=4, n_layers=2,
                         d_ff=128, max_seq=64, dtype="float32")
    async with _cluster() as mc:
        pc = _port_client(mc)
        try:
            tokens = np.tile(np.arange(16, dtype=np.int32), 4096 // 16 * 8)
            await loader.write_token_shards(pc, "/train/tok", tokens,
                                            shard_tokens=4096)
            params = tm.init_params(torch.Generator().manual_seed(0), cfg,
                                    CPU)
            step = tm.make_train_step(cfg, tm.make_optimizer(params, 1e-2))
            losses = []
            for _ in range(4):
                async for batch in loader.GpuTrainFeed(
                        pc, "/train/tok", batch=8, seq_len=64, device=CPU):
                    assert batch.shape == (8, 64)
                    losses.append(float(step(params, batch)))
            assert len(losses) == 4 * tokens.size // (8 * 64)
            assert losses[-1] < losses[0] * 0.5, (losses[0], losses[-1])
        finally:
            await pc.close()


async def test_step_profiler_through_train_feed():
    async with _cluster() as mc:
        pc = _port_client(mc)
        try:
            tokens = np.arange(4 * 64, dtype=np.int32)
            await loader.write_token_shards(pc, "/prof", tokens,
                                            shard_tokens=128)
            feed = loader.GpuTrainFeed(pc, "/prof", batch=2, seq_len=32,
                                       depth=1, device=CPU)
            n = 0
            async for _batch in feed:
                n += 1
            assert n == 4 * 64 // (2 * 32)
            snap = feed.profiler.snapshot()
            assert snap["steps"] == n
            assert snap["stages"]["cache_fetch"]["count"] >= 2
            assert snap["stages"]["host_to_hbm"]["count"] == n
            assert snap["stages"]["input_wait"]["count"] >= n
        finally:
            await pc.close()


# ------------------------------------------------------ prefetch window

async def _seed_shards(c, n=6, size=256):
    for i in range(n):
        await c.write_all(f"/ds/shard-{i:03d}.bin", b"\0" * size)
    return [f"/ds/shard-{i:03d}.bin" for i in range(n)]


async def _wait(cond, timeout=10.0):
    async def w():
        while not cond():
            await asyncio.sleep(0.05)
    await asyncio.wait_for(w(), timeout)


async def test_prefetch_window_plans_epoch_order(tmp_path):
    async with _cluster(base_dir=str(tmp_path)) as mc:
        pc = _port_client(mc)
        try:
            shards = await _seed_shards(pc)
            r = await pc.advise("/ds", cursor=0, window=2, epoch=1, seed=42)
            job = mc.master.jobs.jobs[r["job_id"]]
            await _wait(lambda: len(job.tasks) >= 2)
            want = epoch_shard_order(shards, 42, 1)
            assert [t.path for t in job.tasks] == want[:2]
            assert job.total_files == len(shards)
            await pc.advise("/ds", cursor=2, window=2, epoch=1, seed=42)
            await _wait(lambda: len(job.tasks) >= 4)
            assert [t.path for t in job.tasks] == want[:4]
            await _wait(lambda: all(t.state == JobState.COMPLETED
                                    for t in job.tasks), 15.0)
            assert job.state != JobState.COMPLETED
            await pc.advise("/ds", cursor=len(shards), window=2, epoch=1,
                            seed=42)
            await _wait(lambda: job.state == JobState.COMPLETED, 15.0)
            assert pc.counters["advise.rpcs"] == 3
        finally:
            await pc.close()


async def test_prefetch_restart_resumes_cursor_not_dataset(tmp_path):
    async with _cluster(base_dir=str(tmp_path)) as mc:
        pc = _port_client(mc)
        try:
            shards = await _seed_shards(pc)
            r = await pc.advise("/ds", cursor=3, window=2, epoch=0, seed=9)
            jid = r["job_id"]
            await _wait(lambda: len(mc.master.jobs.jobs[jid].tasks) >= 2)
            await mc.restart_master()
            jobs2 = mc.master.jobs
            await _wait(lambda: jid in jobs2.jobs
                        and len(jobs2.jobs[jid].tasks) >= 2, 15.0)
            job2 = jobs2.jobs[jid]
            assert job2.cursor == 3 and job2.epoch == 0 and job2.seed == 9
            assert [t.path for t in job2.tasks] == \
                epoch_shard_order(shards, 9, 0)[3:5]
            # the port's pooled connection died with the old master: the
            # next call redials
            assert (await pc.meta.file_status(shards[0])).len == 256
        finally:
            await pc.close()


async def test_prefetch_epoch_rollover_and_missing_path(tmp_path):
    async with _cluster(base_dir=str(tmp_path)) as mc:
        pc = _port_client(mc)
        try:
            await _seed_shards(pc)
            r0 = await pc.advise("/ds", epoch=0)
            r1 = await pc.advise("/ds", epoch=1)
            assert r0["job_id"] != r1["job_id"]
            jobs = mc.master.jobs
            assert ("/ds", 0) in jobs._prefetch and ("/ds", 1) in \
                jobs._prefetch
            await pc.advise("/ds", epoch=2)
            assert ("/ds", 0) not in jobs._prefetch
            assert jobs.jobs[r0["job_id"]].state == JobState.COMPLETED
            r = await pc.advise("/nowhere")
            job = jobs.jobs[r["job_id"]]
            await _wait(lambda: job.state == JobState.FAILED)
            assert job.message
        finally:
            await pc.close()


async def test_cache_shard_source_advises_as_it_reads():
    async with _cluster() as mc:
        pc = _port_client(mc)
        try:
            await loader.write_token_shards(pc, "/ds", np.arange(6000), 1000)
            src = loader.CacheShardSource(pc, "/ds", 1, 1000, shuffle_seed=3,
                                          prefetch=True, prefetch_window=2)
            assert len([b async for b in src.batches()]) == 6
            # a cursor a shard, and the next epoch's head near the end
            assert pc.counters["advise.rpcs"] == 6 + 1
            jobs = mc.master.jobs
            assert ("/ds", 0) in jobs._prefetch and ("/ds", 1) in \
                jobs._prefetch
            job = jobs.jobs[jobs._prefetch[("/ds", 0)]]
            assert job.cursor == 5 and job.seed == 3
        finally:
            await pc.close()


# ------------------------------------------------------------ launcher

async def test_card_cluster_launcher_serves_through_the_port_codec(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = await asyncio.create_subprocess_exec(
        sys.executable, os.path.join(ROOT, "scripts", "card_cluster.py"),
        "--base-dir", str(tmp_path), "--tier-bytes", str(256 * MiB),
        "--codec", "port", cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        # the launcher first builds the JAX package's C++ helpers (make)
        # where a checkout has none yet: tens of seconds under load
        line = await asyncio.wait_for(proc.stdout.readline(), 300)
        info = json.loads(line)
        assert info["codec"] == "wirepack" and info["pid"] == proc.pid
        conf = ClusterConf()
        conf.client.master_addrs = [info["master"]]
        tokens = np.random.default_rng(1).integers(0, 50257, 300_001,
                                                   dtype=np.int32)
        async with CurvineClient(conf) as pc:
            await asyncio.wait_for(loader.write_token_shards(
                pc, "/ds/one", tokens, shard_tokens=tokens.size), 60)
            r = await pc.open("/ds/one/shard-00000.bin")
            assert r.blocks.status.block_size == 64 * MiB
            view = await r.mmap_view(0, r.len)
            assert np.array_equal(view.view(np.int32), tokens)
            await r.close()
    finally:
        if proc.returncode is None:
            proc.terminate()
        rc = await asyncio.wait_for(proc.wait(), 60)
        err = (await proc.stderr.read()).decode()
    assert rc == 0, err
