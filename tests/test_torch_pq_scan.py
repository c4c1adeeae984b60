"""Port parity: the ADC scan K2 (``curvine_tpu_torch.gpu.pq``) against the
JAX package's ``pq_lut_scan`` (its Pallas kernel in interpret mode on the
CPU). On CPU tensors the wrapper runs the plain version, which adds the
same float32 terms in the same order (m = 0..M-1) as the TPU kernel and
the CUDA kernel: the results must be bit-equal, out-of-range codes
included. Against the JAX search's gather-and-sum ADC (``pallas=False``),
which sums in XLA's reduce order, the tolerance is 1e-6 relative to the
sum of the terms' magnitudes."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import torch

from curvine_tpu.tpu.pallas_ops import pq_lut_scan as jax_scan
from curvine_tpu_torch.gpu import pq


def _inputs(m, ksub, w, pre_offset, seed, q=None):
    """A LUT and codes with planted out-of-range codes: -1, >= ksub (past
    the whole table when pre-offset) and, pre-offset, a code in the next
    subspace's range."""
    rng = np.random.default_rng(seed)
    lead = () if q is None else (q,)
    lut = rng.normal(size=lead + (m, ksub)).astype(np.float32)
    codes = rng.integers(0, ksub, size=lead + (w, m)).astype(np.int32)
    if pre_offset:
        codes = codes + (np.arange(m, dtype=np.int32) * ksub)
    c = codes.reshape(-1, w, m)
    c[:, ::7, 0] = -1
    c[:, 1::5, m - 1] = m * ksub + 3 if pre_offset else ksub
    if m > 1:
        c[:, 2::3, 1] = (c[:, 2::3, 1] + ksub if pre_offset
                         else c[:, 2::3, 1] % ksub + ksub)
    return lut, codes


def _bits(a):
    return np.asarray(a, dtype=np.float32).view(np.uint32)


@pytest.mark.parametrize("w", [1, 100, 128, 1000])
@pytest.mark.parametrize("ksub", [16, 32, 256])
@pytest.mark.parametrize("m", [4, 16, 64])
def test_plain_scan_bit_equal_to_the_jax_kernel(m, ksub, w):
    for pre_offset in (False, True):
        lut, codes = _inputs(m, ksub, w, pre_offset, seed=m * 1000 + w)
        ref = jax_scan(lut, codes, interpret=True, pre_offset=pre_offset)
        got = pq.pq_lut_scan(torch.from_numpy(lut), torch.from_numpy(codes),
                             pre_offset=pre_offset)
        assert got.shape == (w,) and got.dtype == torch.float32
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(ref))
        plain = pq.pq_lut_scan_plain(torch.from_numpy(lut),
                                     torch.from_numpy(codes), pre_offset)
        np.testing.assert_array_equal(_bits(plain.numpy()), _bits(ref))


@pytest.mark.parametrize("m,ksub,w", [(16, 256, 300), (8, 32, 129),
                                      (4, 16, 1)])
def test_batched_form_bit_equal_to_the_jax_kernel_vmapped(m, ksub, w):
    """[Q, M, ksub] x [Q, W, M] in one call, as the search issues it,
    against JAX's vmap of the one-query kernel (index.py:307-312)."""
    for pre_offset in (False, True):
        lut, codes = _inputs(m, ksub, w, pre_offset, seed=w, q=3)
        ref = jax.vmap(lambda lt, cd: jax_scan(
            lt, cd, interpret=True, pre_offset=pre_offset))(lut, codes)
        got = pq.pq_lut_scan(torch.from_numpy(lut), torch.from_numpy(codes),
                             pre_offset=pre_offset)
        assert got.shape == (3, w)
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(ref))


@pytest.mark.parametrize("m,ksub", [(4, 16), (16, 256), (64, 32)])
def test_scan_close_to_the_jax_gather_sum_on_in_range_codes(m, ksub):
    """The JAX search's default ADC (``pallas=False``, index.py:314-316):
    a gather from the flattened LUT and an XLA sum, whose order may
    differ from m = 0..M-1. Reordering a sum of M terms of both signs
    moves it by the rounding of its partial sums, so the 1e-6 is relative
    to the sum of the terms' magnitudes, the scale of those partial sums
    (at M 64 the sum itself may cancel to near 0)."""
    rng = np.random.default_rng(m + ksub)
    q, w = 4, 333
    lut = rng.normal(size=(q, m, ksub)).astype(np.float32)
    codes = (rng.integers(0, ksub, size=(q, w, m))
             + np.arange(m) * ksub).astype(np.int32)
    ref = jnp.sum(jnp.take_along_axis(
        jnp.asarray(lut).reshape(q, 1, m * ksub), jnp.asarray(codes),
        axis=2), axis=2)
    got = pq.pq_lut_scan(torch.from_numpy(lut), torch.from_numpy(codes),
                         pre_offset=True).numpy()
    scale = np.take_along_axis(np.abs(lut).reshape(q, 1, m * ksub), codes,
                               axis=2).sum(axis=2)
    assert np.all(np.abs(got - np.asarray(ref)) <= 1e-6 * scale)


def test_scan_checks_its_arguments():
    lut = torch.zeros(2, 4, 16)
    codes = torch.zeros(2, 10, 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="float32 and codes int32"):
        pq.pq_lut_scan(lut, codes.long())
    with pytest.raises(ValueError, match="float32 and codes int32"):
        pq.pq_lut_scan(lut.double(), codes)
    with pytest.raises(ValueError, match="not \\[Q, M, ksub\\]"):
        pq.pq_lut_scan(lut, codes[:, :, :3])
    with pytest.raises(ValueError, match="not \\[Q, M, ksub\\]"):
        pq.pq_lut_scan(lut, codes[:1])
    with pytest.raises(TypeError):
        pq.pq_lut_scan(lut.numpy(), codes)
    launches = pq.pq_lut_scan.launches
    assert pq.pq_lut_scan(lut, codes).shape == (2, 10)
    assert pq.pq_lut_scan.launches == launches    # the CPU never launches
