"""Port parity: ``curvine_tpu_torch.worker.promote.promote_block`` on
blocks that the JAX package's own ``worker/storage.py`` BlockStore wrote
and committed (file tier and bdev extent tier), on the CPU. The tier's
bytes equal the file's; a corrupted file fails the media crc check; a
corrupted device copy fails the hash check; either way the block leaves
the tier."""

import os

import numpy as np
import pytest

import torch

from curvine_tpu.common.types import StorageType
from curvine_tpu.worker.storage import BdevTier, BlockStore, TierDir
from curvine_tpu_torch.common.errors import AbnormalData
from curvine_tpu_torch.gpu import cuda_ops
from curvine_tpu_torch.gpu.hbm import HbmTier, MultiHbmTier
from curvine_tpu_torch.worker import blockfile
from curvine_tpu_torch.worker.promote import promote_block

MB = 1024 * 1024
CPU = torch.device("cpu")


def _commit(store, bid, payload, checksum=None, algo="crc32"):
    info = store.create_temp(bid, size_hint=len(payload))
    with open(info.path, "r+b" if info.is_extent else "wb") as f:
        f.seek(info.offset)
        f.write(payload)
    return store.commit(bid, len(payload), checksum=checksum,
                        checksum_algo=algo)


def _promote(tier, info):
    return promote_block(tier, info.block_id, info.path, info.offset,
                         info.len, crc=info.crc32c, crc_algo=info.crc_algo)


@pytest.mark.parametrize("layout", ["file", "bdev"])
def test_promote_blocks_written_by_the_jax_worker(tmp_path, layout):
    if layout == "file":
        tier = TierDir(StorageType.MEM, str(tmp_path / "mem"), 64 * MB)
    else:
        tier = BdevTier(StorageType.SSD, str(tmp_path / "bdev.img"), 64 * MB)
    store = BlockStore([tier])
    rng = np.random.default_rng(5)
    infos = []
    for bid, n in ((300, MB + 13), (7, 262145), (1024, 3)):
        payload = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        # commit without a checksum: the store computes crc32c from disk
        infos.append((_commit(store, bid, payload), payload))
    dev = MultiHbmTier(8 * MB, devices=[torch.device("cpu", 0),
                                        torch.device("cpu", 1)],
                       admission="s3fifo")
    for info, payload in infos:
        assert info.crc_algo == "crc32c"
        if layout == "file":
            assert info.path == blockfile.block_path(str(tmp_path / "mem"),
                                                     info.block_id)
        assert _promote(dev, info) == len(payload)
        assert dev.get(info.block_id).numpy().tobytes() == payload
        assert blockfile.crc_update(info.crc_algo, payload) == info.crc32c
    assert dev.stats()["blocks"] == 3


def test_crc32_media_checksum_and_zlib_parity(tmp_path):
    store = BlockStore([TierDir(StorageType.MEM, str(tmp_path), 8 * MB)])
    payload = os.urandom(MB)
    import zlib
    info = _commit(store, 5, payload, checksum=zlib.crc32(payload))
    assert info.crc_algo == "crc32"
    tier = HbmTier(4 * MB, device=CPU)
    assert _promote(tier, info) == MB
    assert tier.get(5).numpy().tobytes() == payload


def test_corrupted_file_fails_media_crc_and_is_dropped(tmp_path):
    store = BlockStore([TierDir(StorageType.MEM, str(tmp_path), 8 * MB)])
    payload = np.random.default_rng(1).integers(0, 256, MB, np.uint8)
    info = _commit(store, 9, payload.tobytes())
    tier = HbmTier(4 * MB, device=CPU)
    assert _promote(tier, info) == MB              # resident and verified
    with open(info.path, "r+b") as f:              # rot on the media
        f.seek(1234)
        f.write(bytes([payload[1234] ^ 0x10]))
    tier.drop(9)
    with pytest.raises(AbnormalData, match="promotion verify"):
        _promote(tier, info)
    assert 9 not in tier and tier.used == 0


class _FlipAfterPut:
    """The device copy diverges from the bytes that passed the crc."""

    def __init__(self, tier):
        self.tier = tier

    def put(self, block_id, data):
        arr = self.tier.put(block_id, data)
        arr[arr.numel() // 3] ^= 0x80
        return arr

    def drop(self, block_id, evicted=False):
        self.tier.drop(block_id, evicted=evicted)


def test_corrupted_device_copy_fails_hash_and_is_dropped(tmp_path):
    store = BlockStore([TierDir(StorageType.MEM, str(tmp_path), 8 * MB)])
    info = _commit(store, 11, os.urandom(MB + 5))
    tier = HbmTier(4 * MB, device=CPU)
    before = cuda_ops.block_checksum.launches       # CPU: no kernel launch
    with pytest.raises(AbnormalData, match="device copy diverges"):
        _promote(_FlipAfterPut(tier), info)
    assert 11 not in tier and tier.used == 0
    assert cuda_ops.block_checksum.launches == before
