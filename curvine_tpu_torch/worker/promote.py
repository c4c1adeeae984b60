"""Promote a cached block into the device tier-0, verified twice.

Counterpart of the ``work()`` body of
``curvine_tpu/worker/server.py:628-653`` (``WorkerServer._autopin_block``):

1. map the block's bytes (read-only, zero-copy) and check the media crc
   recorded at commit — a bad replica must never become the hottest copy;
2. pin the bytes into the tier;
3. hash the device copy with the CUDA kernel ``block_checksum`` and
   compare with the host hash of the same bytes.

Any mismatch drops the block from the tier and raises ``AbnormalData``;
any other failure on the way drops it too and propagates. A caller that
shares the tier with other threads passes its lock, which is then held
over steps 2-3 only.
Unlike the JAX worker, which skips the device check when its kernel
cannot be imported, a kernel that cannot build or launch fails the
promotion."""

from __future__ import annotations

import contextlib

from curvine_tpu_torch.common.errors import AbnormalData
from curvine_tpu_torch.gpu.cuda_ops import block_checksum, block_checksum_host
from curvine_tpu_torch.worker.blockfile import crc_update, map_block, supported

__all__ = ["promote_block"]


def promote_block(tier, block_id: int, path: str, offset: int = 0,
                  length: int | None = None, crc: int | None = None,
                  crc_algo: str | None = None, lock=None) -> int:
    """Pin ``length`` bytes at ``offset`` of ``path`` as ``block_id`` into
    ``tier`` (an ``HbmTier`` or ``MultiHbmTier``); returns the bytes
    pinned. ``crc``/``crc_algo`` are the commit-time media checksum; the
    crc check is skipped when either is absent. ``lock``, where given, is
    held over the put and the device check (and the drop of a bad copy)
    only: the media crc and the host hash run outside it."""
    lock = lock if lock is not None else contextlib.nullcontext()
    view = map_block(path, offset, length)
    try:
        if crc is not None and supported(crc_algo) \
                and crc_update(crc_algo, view) != crc:
            raise AbnormalData(f"block {block_id} failed promotion verify")
        want = block_checksum_host(view)
        with lock:
            arr = tier.put(block_id, view)
            if block_checksum(arr) != want:
                raise AbnormalData(f"block {block_id} device copy diverges")
    except BaseException:
        # a copy that is bad, or that could not be verified, leaves the tier
        with lock:
            tier.drop(block_id)
        raise
    return view.size
