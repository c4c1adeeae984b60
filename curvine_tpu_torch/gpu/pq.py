"""The ADC scan of the IVF-PQ search (K2): CUDA kernel and plain version.

Port of ``curvine_tpu/tpu/pallas_ops.py:106-168`` (``pq_lut_scan``). For
each query q and candidate w (see ``csrc/pq_scan.cu``):

    out[q, w] = sum_m lut[q, m, codes[q, w, m] - (pre_offset ? m*ksub : 0)]

in float32, adding m = 0..M-1 in order; a code outside its subspace's
[0, ksub) adds 0, as the TPU kernel's select against an iota does.

* ``pq_lut_scan(lut, codes, pre_offset)`` launches the kernel for CUDA
  tensors, one launch for the whole batch (``pq_lut_scan.launches``
  counts them), and runs the plain version for CPU tensors. It never falls
  back from the card to the plain version.
* ``pq_lut_scan_plain`` is the plain PyTorch version: a loop over m of a
  gather and a mask, adding in the same order, so it is bit-equal to the
  kernel and to the JAX package's kernel.

Both take the batched form, lut [Q, M, ksub] and codes [Q, W, M], or one
query's, lut [M, ksub] and codes [W, M] (the JAX function's signature)."""

from __future__ import annotations

import ctypes

import torch

from curvine_tpu_torch.gpu import _build

__all__ = ["pq_lut_scan", "pq_lut_scan_plain", "MAX_LUT_BYTES"]

MAX_LUT_BYTES = 232_448          # an H100 block's shared memory at most


def _batched(lut: torch.Tensor, codes: torch.Tensor):
    """(lut [Q, M, ksub], codes [Q, W, M], whether the input was one
    query's), after checking shapes and types."""
    if not isinstance(lut, torch.Tensor) or not isinstance(codes,
                                                           torch.Tensor):
        raise TypeError("pq_lut_scan takes tensors")
    one = lut.dim() == 2
    if one:
        lut, codes = lut[None], codes[None]
    if lut.dim() != 3 or codes.dim() != 3 or codes.shape[0] != lut.shape[0] \
            or codes.shape[2] != lut.shape[1]:
        raise ValueError(f"pq_lut_scan: lut {tuple(lut.shape)} and codes "
                         f"{tuple(codes.shape)} are not [Q, M, ksub] and "
                         f"[Q, W, M] (or [M, ksub] and [W, M])")
    if lut.dtype != torch.float32 or codes.dtype != torch.int32:
        raise ValueError(f"pq_lut_scan: lut must be float32 and codes int32, "
                         f"got {lut.dtype} and {codes.dtype}")
    if lut.device != codes.device:
        raise ValueError(f"pq_lut_scan: lut on {lut.device}, codes on "
                         f"{codes.device}")
    return lut, codes, one


def _lib() -> ctypes.CDLL:
    lib = _build.load("pq_scan")
    fn = lib.cv_pq_lut_scan
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def pq_lut_scan(lut: torch.Tensor, codes: torch.Tensor,
                pre_offset: bool = False) -> torch.Tensor:
    """ADC scores [Q, W] (or [W]). CUDA tensors go through the kernel on
    the current stream; CPU tensors through the plain version."""
    lut3, codes3, one = _batched(lut, codes)
    if lut3.device.type == "cpu":
        return pq_lut_scan_plain(lut, codes, pre_offset)
    if lut3.device.type != "cuda":
        raise ValueError(f"pq_lut_scan: {lut3.device} is neither CUDA nor "
                         f"the CPU")
    if not lut3.is_contiguous() or not codes3.is_contiguous():
        raise ValueError("pq_lut_scan kernel: lut and codes must be "
                         "contiguous")
    nq, m, ksub = lut3.shape
    w = codes3.shape[1]
    if m * ksub * 4 > MAX_LUT_BYTES:
        raise ValueError(f"pq_lut_scan kernel: a {m} x {ksub} float32 LUT "
                         f"exceeds a block's {MAX_LUT_BYTES} bytes of "
                         f"shared memory")
    out = torch.empty((nq, w), dtype=torch.float32, device=lut3.device)
    if out.numel():
        with torch.cuda.device(lut3.device):
            stream = torch.cuda.current_stream(lut3.device).cuda_stream
            rc = _lib().cv_pq_lut_scan(
                lut3.data_ptr(), codes3.data_ptr(), out.data_ptr(), nq, w, m,
                ksub, int(bool(pre_offset)), stream)
        if rc != 0:
            raise RuntimeError(f"pq_lut_scan kernel launch failed: CUDA "
                               f"error {rc}")
        pq_lut_scan.launches += 1
    return out[0] if one else out


pq_lut_scan.launches = 0


def pq_lut_scan_plain(lut: torch.Tensor, codes: torch.Tensor,
                      pre_offset: bool = False) -> torch.Tensor:
    """Plain PyTorch version, on the tensors' own device: bit-equal to
    the kernel (the same float32 adds in the same order)."""
    lut3, codes3, one = _batched(lut, codes)
    nq, m, ksub = lut3.shape
    acc = torch.zeros(codes3.shape[:2], dtype=torch.float32,
                      device=lut3.device)
    for mi in range(m):
        c = codes3[:, :, mi].long()
        if pre_offset:
            c = c - mi * ksub
        hit = (c >= 0) & (c < ksub)
        v = torch.gather(lut3[:, mi, :], 1, c.clamp(0, ksub - 1))
        acc = acc + torch.where(hit, v, torch.zeros((), device=v.device))
    return acc[0] if one else acc
