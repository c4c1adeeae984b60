"""Port parity: the block checksum of ``curvine_tpu_torch`` against the JAX
package's (Pallas kernel in interpret mode on the CPU, and its numpy host
hash). Hashes are integers: equality is exact."""

import numpy as np
import pytest

import jax

import torch

from curvine_tpu.tpu import pallas_ops as jax_ops
from curvine_tpu_torch.gpu import cuda_ops as ops

MB = 1024 * 1024
SIZES = [1, 3, 4, 262143, 262144, 262145, MB + 13]


def _block(n: int) -> np.ndarray:
    return np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8)


@pytest.mark.parametrize("n", SIZES)
def test_checksum_matches_jax(n):
    data = _block(n)
    ref = jax_ops.block_checksum(jax.device_put(data, jax.devices("cpu")[0]))
    assert ref == jax_ops.block_checksum_host(data.tobytes())
    t = torch.from_numpy(data.copy())
    assert ops.block_checksum(t) == ref          # CPU tensor: plain version
    assert ops.block_checksum_torch(t) == ref
    assert ops.block_checksum_host(data) == ref
    assert ops.block_checksum_host(data.tobytes()) == ref


@pytest.mark.parametrize("n", SIZES)
def test_checksum_sees_flip_and_swap(n):
    data = _block(n)
    base = ops.block_checksum(torch.from_numpy(data.copy()))
    flipped = data.copy()
    flipped[n // 2] ^= 0x01
    got = ops.block_checksum(torch.from_numpy(flipped))
    assert got != base
    assert got == jax_ops.block_checksum_host(flipped.tobytes())
    if n >= 512:
        # words 0 and 127: their index terms differ in the 7 low bits, so
        # the hash sees the swap unless the two words agree there
        swapped = data.copy()
        swapped[0:4], swapped[508:512] = data[508:512], data[0:4]
        got = ops.block_checksum(torch.from_numpy(swapped))
        assert got != base
        assert got == jax_ops.block_checksum_host(swapped.tobytes())


def test_checksum_host_reads_views_in_place():
    """A read-only view (an mmap of a block file) hashes without a copy
    of whole tiles and equals the hash of its bytes."""
    data = _block(3 * ops.TILE_WORDS * 4 + 5)
    view = data[:]
    view.setflags(write=False)
    assert ops.block_checksum_host(view) == \
        jax_ops.block_checksum_host(data.tobytes())


def test_checksum_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        ops.block_checksum(torch.zeros(8, dtype=torch.int32))
    with pytest.raises(ValueError):
        ops.block_checksum(torch.zeros((2, 4), dtype=torch.uint8))
    with pytest.raises(ValueError):
        ops.block_checksum(torch.zeros(16, dtype=torch.uint8)[::2])
    with pytest.raises(ValueError):                  # the kernel is CUDA only
        ops.launch(torch.zeros(8, dtype=torch.uint8),
                   torch.zeros(2, dtype=torch.int32))
