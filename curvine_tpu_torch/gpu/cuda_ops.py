"""Block checksum for the device tier-0: CUDA kernel, plain version, host hash.

Port of ``curvine_tpu/tpu/pallas_ops.py:22-103`` (``block_checksum``,
``block_checksum_host``). The hash (see ``csrc/checksum.cu``): zero-pad
the bytes to little-endian uint32 words w[i] and then to whole tiles of
``TILE_WORDS`` words, and return s ^ (m << 1) mod 2^32 with s = sum w[i]
and m = sum (w[i] ^ ((i mod 128) + TILE_WORDS * (i // TILE_WORDS))).

* ``block_checksum(t)`` launches the CUDA kernel for a CUDA tensor and
  runs the plain version for a CPU tensor; it never falls back from the
  card to the plain version.
* ``block_checksum_torch(t)`` is the plain PyTorch version (int64 lanes,
  masked to 32 bits), the kernel's yardstick on the card.
* ``block_checksum_host(data)`` is the numpy hash a promotion compares
  the device copy against. It works in uint32 tile by tile and sums into
  uint64, instead of the JAX package's three padded-length uint64 index
  arrays, and is bit-identical to it."""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from curvine_tpu_torch.gpu import _build

__all__ = ["block_checksum", "block_checksum_torch", "block_checksum_host",
           "launch", "LANE", "TILE_WORDS"]

LANE = 128
TILE_WORDS = 64 * 8 * LANE          # 65,536 words: one TPU grid step
_MASK = 0xFFFFFFFF
_HOST_CHUNK_TILES = 16              # 4 MiB of words per numpy pass
# the launch count is bumped from the worker's pin threads and the caller's
_launch_lock = threading.Lock()


def _combine(s: int, m: int) -> int:
    return (s & _MASK) ^ ((m << 1) & _MASK)


def _padded_words(nbytes: int) -> int:
    words = (nbytes + 3) // 4
    return -(-words // TILE_WORDS) * TILE_WORDS


def _check_block(t: torch.Tensor) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"block_checksum takes a tensor, got {type(t)}")
    if t.dtype != torch.uint8 or t.dim() != 1:
        raise ValueError(f"block must be a 1-D uint8 tensor, got "
                         f"{t.dtype} of shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError("block must be contiguous")


def _lib() -> ctypes.CDLL:
    lib = _build.load("checksum")
    fn = lib.cv_block_checksum
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_ulonglong,
                       ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def block_checksum(t: torch.Tensor) -> int:
    """Checksum of a 1-D uint8 block. A CUDA tensor goes through the
    hand-written kernel on the current stream (``block_checksum.launches``
    counts each launch); a CPU tensor goes through the plain version."""
    _check_block(t)
    if t.device.type == "cpu":
        return block_checksum_torch(t)
    out = torch.zeros(2, dtype=torch.int32, device=t.device)
    launch(t, out)
    s, m = (int(v) & _MASK for v in out.tolist())
    return _combine(s, m)


def launch(t: torch.Tensor, out: torch.Tensor) -> None:
    """Launch the kernel on the current stream: add the block's two sums
    into ``out`` (2 int32 words on the same device, zeroed by the caller)
    without waiting. The one place the kernel launches, and the one place
    that counts."""
    _check_block(t)
    if t.device.type != "cuda":
        raise ValueError(f"block_checksum kernel: {t.device} is not a CUDA "
                         f"device")
    if t.data_ptr() % 4:
        raise ValueError("block_checksum kernel: the block's base must be "
                         "4-byte aligned (16-byte for vector loads)")
    if out.dtype != torch.int32 or out.numel() != 2 \
            or out.device != t.device or not out.is_contiguous():
        raise ValueError("block_checksum kernel: out must be 2 contiguous "
                         "int32 words on the block's device")
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream(t.device).cuda_stream
        rc = _lib().cv_block_checksum(t.data_ptr(), t.numel(),
                                      out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"block_checksum kernel launch failed: CUDA "
                           f"error {rc}")
    _count_launch()


def _count_launch() -> None:
    """Add one to ``block_checksum.launches``, under a lock: launches come
    from more than one thread (a worker's promotions run on threads)."""
    with _launch_lock:
        block_checksum.launches += 1


block_checksum.launches = 0


def block_checksum_torch(t: torch.Tensor) -> int:
    """Plain PyTorch version of the hash, on the tensor's own device."""
    _check_block(t)
    n = t.numel()
    padded = _padded_words(n)
    if padded == 0:
        return 0
    buf = torch.zeros(padded * 4, dtype=torch.uint8, device=t.device)
    buf[:n] = t
    w = buf.view(torch.int32).to(torch.int64) & _MASK
    i = torch.arange(padded, dtype=torch.int64, device=t.device)
    idx = ((i & (LANE - 1)) + (i & ~(TILE_WORDS - 1))) & _MASK
    # int64 sums wrap mod 2^64, which keeps them exact mod 2^32
    s = int(w.sum())
    m = int((w ^ idx).sum())
    return _combine(s, m)


def block_checksum_host(data) -> int:
    """Numpy hash of a host block (bytes, memoryview or uint8 array)."""
    arr = np.frombuffer(data, dtype=np.uint8) if isinstance(
        data, (bytes, bytearray, memoryview)) else np.asarray(data)
    arr = arr.reshape(-1)
    if arr.dtype != np.uint8:
        arr = arr.view(np.uint8)
    nbytes = arr.size
    padded = _padded_words(nbytes)
    if padded == 0:
        return 0
    whole = nbytes // (TILE_WORDS * 4)   # tiles read in place
    tiles = padded // TILE_WORDS
    cols = np.arange(LANE, dtype=np.uint32)
    s = m = 0
    for t0 in range(0, tiles, _HOST_CHUNK_TILES):
        t1 = min(tiles, t0 + _HOST_CHUNK_TILES)
        if t1 <= whole:
            w = arr[t0 * TILE_WORDS * 4:t1 * TILE_WORDS * 4].view(np.uint32)
        else:                            # the ragged last tile, zero-padded
            part = arr[t0 * TILE_WORDS * 4:]
            w8 = np.zeros((t1 - t0) * TILE_WORDS * 4, dtype=np.uint8)
            w8[:part.size] = part
            w = w8.view(np.uint32)
        w = w.reshape(t1 - t0, TILE_WORDS // LANE, LANE)
        tile_base = (np.arange(t0, t1, dtype=np.uint64)
                     * TILE_WORDS).astype(np.uint32)  # wraps mod 2^32
        idx = cols[None, None, :] + tile_base[:, None, None]
        s += int(w.sum(dtype=np.uint64))
        m += int(np.bitwise_xor(w, idx).sum(dtype=np.uint64))
    return _combine(s, m)
