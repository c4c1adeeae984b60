"""The port's own crc32c (``csrc/crc32c.cc``, built with the host C++
compiler at first use) against its plain table version, a published
check value, zlib-independent chaining, and the JAX package's native
routine. Checksums are integers: equality is exact."""

import numpy as np
import pytest

from curvine_tpu.common import native as jax_native
from curvine_tpu_torch.gpu import _build
from curvine_tpu_torch.worker import blockfile


def test_crc32c_check_value():
    # the standard check value of CRC-32C (Castagnoli) over "123456789"
    assert blockfile.crc_update("crc32c", b"123456789") == 0xE3069283
    assert blockfile.crc32c_table(b"123456789") == 0xE3069283


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 255, 768, 769, 3 * 8192,
                               3 * 8192 + 13, 100_003])
def test_crc32c_built_routine_matches_table(n):
    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8)
    want = blockfile.crc32c_table(data.tobytes())
    assert blockfile.crc_update("crc32c", data) == want
    # an unaligned start takes the byte loop before the 8-byte words
    if n > 3:
        assert blockfile.crc_update("crc32c", data[3:]) == \
            blockfile.crc32c_table(data[3:].tobytes())
    # chained in two pieces
    k = n // 3
    part = blockfile.crc_update("crc32c", data[:k])
    assert blockfile.crc_update("crc32c", data[k:], part) == want


def test_crc32c_matches_the_jax_package():
    data = np.random.default_rng(7).integers(0, 256, 50_001,
                                             dtype=np.uint8).tobytes()
    assert blockfile.crc_update("crc32c", data) == \
        jax_native.crc32c(data)


def test_crc32c_is_built_from_the_port_sources():
    blockfile.crc_update("crc32c", b"x")
    lib = blockfile._crc32c_lib()
    assert lib._name.startswith(_build.BUILD)
    assert lib.cv_crc32c_hw() in (0, 1)
