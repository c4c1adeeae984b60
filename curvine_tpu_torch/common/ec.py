"""Reed-Solomon erasure codec over GF(256): the EC capacity tier's math.

The port's own copy of ``curvine_tpu/common/ec.py`` (all 249 lines): the
``_EXP``/``_LOG``/``_MUL`` tables, ``gf_mul``, ``gf_inv``, ``ECProfile``
(the Cauchy generator and ``parse``), ``gf_matinv``, ``split``, ``join``,
``encode``, ``decode`` and ``reconstruct``, bit for bit.

Systematic RS(k, m): a block is split into k equal data cells; m parity
cells are derived so that any k of the k+m cells rebuild the block
(a Cauchy generator, MDS). Encode and decode are linear maps byte by
byte, so a degraded read of a byte range needs only the same range of
any k surviving cells. Data cell j holds block bytes
[j * cell_size, (j + 1) * cell_size), the tail cell zero-padded; the
block's length lives in the stripe record.

The hot loop, dst ^= gf_mul(coef, src) over whole cells, has two
versions: ``use_native=True`` goes through the port's host routine
``csrc/gf256.cc`` (SSSE3 ``pshufb`` where the CPU has it), built with the
host C++ compiler at first use (``gpu/_build.py``); a failed build raises
``KernelBuildError``, as the port's crc32c does
(``worker/blockfile.py``). It does not fall back to the table quietly,
as the reference's ``_mul_xor`` does. ``use_native=False`` is the 64 KiB
numpy table path, the plain version the routine is held to."""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from curvine_tpu_torch.common import errors as err
from curvine_tpu_torch.gpu import _build

GF_POLY = 0x11D

# exp/log tables of the multiplicative group (generator x = 2)
_EXP = np.zeros(512, dtype=np.uint8)
_LOG = np.zeros(256, dtype=np.int32)
_x = 1
for _i in range(255):
    _EXP[_i] = _x
    _LOG[_x] = _i
    _x <<= 1
    if _x & 0x100:
        _x ^= GF_POLY
_EXP[255:510] = _EXP[:255]


def gf_mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return int(_EXP[_LOG[a] + _LOG[b]])


def gf_inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("gf_inv(0)")
    return int(_EXP[255 - _LOG[a]])


# full 256x256 product table: MUL[a, b] = a*b. 64 KiB; one fancy-index
# per (coef, cell) pair is the whole numpy encode inner loop.
_MUL = np.zeros((256, 256), dtype=np.uint8)
for _a in range(1, 256):
    _MUL[_a, 1:] = _EXP[_LOG[_a] + _LOG[1:]]


class ECDecodeError(err.CurvineError):
    """Too many erasures (or a singular submatrix — impossible for MDS)."""


class ECProfile:
    """An `rs-<k>-<m>` storage-class profile; parsed once, cached."""

    _cache: dict[str, "ECProfile"] = {}

    def __init__(self, k: int, m: int):
        if k < 1 or m < 1 or k + m > 256:
            raise err.InvalidArgument(f"bad EC profile rs-{k}-{m}")
        self.k = k
        self.m = m
        self.name = f"rs-{k}-{m}"
        # systematic generator G ((k+m) x k): top k rows identity, parity
        # row i is the Cauchy row C[i][j] = 1/(x_i ^ y_j) with x_i = k+i,
        # y_j = j — disjoint index sets, so every denominator is nonzero
        # and every square submatrix of G is invertible (MDS).
        g = np.zeros((k + m, k), dtype=np.uint8)
        for j in range(k):
            g[j, j] = 1
        for i in range(m):
            for j in range(k):
                g[k + i, j] = gf_inv((k + i) ^ j)
        self.gen = g

    @classmethod
    def parse(cls, name: str) -> "ECProfile":
        p = cls._cache.get(name)
        if p is not None:
            return p
        parts = name.split("-")
        if len(parts) != 3 or parts[0] != "rs":
            raise err.InvalidArgument(f"bad EC profile {name!r} "
                                      "(want rs-<k>-<m>)")
        try:
            p = cls(int(parts[1]), int(parts[2]))
        except ValueError:
            raise err.InvalidArgument(f"bad EC profile {name!r}") from None
        cls._cache[name] = p
        return p

    def cell_size(self, block_len: int) -> int:
        return max(1, -(-block_len // self.k))

    def __repr__(self) -> str:
        return f"ECProfile({self.name})"


# ---------------- hot loop ----------------

_gf_lock = threading.Lock()
_gf_lib: ctypes.CDLL | None = None


def _gf_native() -> ctypes.CDLL:
    """The built ``csrc/gf256.cc``, its table filled once."""
    global _gf_lib
    with _gf_lock:
        if _gf_lib is None:
            lib = _build.load("gf256")
            lib.cv_gf_init.argtypes = []
            lib.cv_gf_init.restype = None
            lib.cv_gf_hw.argtypes = []
            lib.cv_gf_hw.restype = ctypes.c_int
            lib.cv_gf_mul_xor.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                          ctypes.c_size_t, ctypes.c_uint8]
            lib.cv_gf_mul_xor.restype = None
            lib.cv_gf_init()
            _gf_lib = lib
        return _gf_lib


def gf_mul_xor_native(dst: np.ndarray, src, coef: int) -> None:
    """dst ^= coef * src through ``csrc/gf256.cc``; ``dst`` a writable
    contiguous uint8 array, ``src`` any buffer of its length."""
    s = _as_u8(src)
    if not s.flags.c_contiguous:
        s = np.ascontiguousarray(s)
    if s.dtype != np.uint8 or dst.dtype != np.uint8 or len(s) != len(dst) \
            or not dst.flags.c_contiguous or not dst.flags.writeable:
        raise ValueError("gf_mul_xor_native wants uint8 buffers of one "
                         "length, dst writable and contiguous")
    _gf_native().cv_gf_mul_xor(dst.ctypes.data, s.ctypes.data, len(dst),
                               coef)


def native_hw() -> bool:
    """Whether the built routine runs its SSSE3 loop on this CPU."""
    return bool(_gf_native().cv_gf_hw())


def _mul_xor(dst: np.ndarray, src, coef: int, use_native: bool) -> None:
    """dst ^= coef * src (elementwise GF(256))."""
    if coef == 0:
        return
    if use_native:
        gf_mul_xor_native(dst, src, coef)
        return
    s = _as_u8(src)
    if coef == 1:
        np.bitwise_xor(dst, s, out=dst)
    else:
        np.bitwise_xor(dst, _MUL[coef][s], out=dst)


def _as_u8(cell) -> np.ndarray:
    if isinstance(cell, np.ndarray):
        return cell
    return np.frombuffer(cell, dtype=np.uint8)


def _matmul_cells(rows: np.ndarray, cells: list, n: int,
                  use_native: bool) -> list[np.ndarray]:
    """out[i] = Σ_j rows[i][j] * cells[j] — the shared encode/decode core."""
    out = []
    for i in range(rows.shape[0]):
        acc = np.zeros(n, dtype=np.uint8)
        for j in range(rows.shape[1]):
            _mul_xor(acc, cells[j], int(rows[i, j]), use_native)
        out.append(acc)
    return out


# ---------------- matrix algebra ----------------

def gf_matinv(mat: np.ndarray) -> np.ndarray:
    """Gauss-Jordan inverse over GF(256). Raises ECDecodeError on a
    singular matrix (cannot happen for submatrices of a Cauchy-systematic
    generator, but decode paths must fail loudly, not wrongly)."""
    n = mat.shape[0]
    aug = np.concatenate(
        [mat.astype(np.uint8), np.eye(n, dtype=np.uint8)], axis=1)
    for col in range(n):
        piv = col
        while piv < n and aug[piv, col] == 0:
            piv += 1
        if piv == n:
            raise ECDecodeError("singular decode matrix")
        if piv != col:
            aug[[col, piv]] = aug[[piv, col]]
        inv_p = gf_inv(int(aug[col, col]))
        aug[col] = _MUL[inv_p][aug[col]]
        for r in range(n):
            if r != col and aug[r, col]:
                aug[r] ^= _MUL[int(aug[r, col])][aug[col]]
    return aug[:, n:]


# ---------------- block <-> cells ----------------

def split(data, k: int, cell_size: int | None = None
          ) -> tuple[list[np.ndarray], int]:
    """Split a block into k data cells of cell_size bytes (tail
    zero-padded). Returns (cells, cell_size)."""
    buf = _as_u8(data)
    if cell_size is None:
        cell_size = max(1, -(-len(buf) // k))
    padded = np.zeros(k * cell_size, dtype=np.uint8)
    padded[:len(buf)] = buf
    return [padded[j * cell_size:(j + 1) * cell_size] for j in range(k)], \
        cell_size


def join(cells: list, block_len: int) -> bytes:
    """Reassemble data cells into the original block (drops padding)."""
    return b"".join(bytes(_as_u8(c)) for c in cells)[:block_len]


# ---------------- encode / decode / reconstruct ----------------

def encode(profile: ECProfile, data_cells: list,
           use_native: bool = True) -> list[np.ndarray]:
    """k equal-length data cells -> m parity cells."""
    if len(data_cells) != profile.k:
        raise err.InvalidArgument(
            f"encode wants {profile.k} cells, got {len(data_cells)}")
    cells = [_as_u8(c) for c in data_cells]
    n = len(cells[0])
    return _matmul_cells(profile.gen[profile.k:], cells, n, use_native)


def decode(profile: ECProfile, cells: list,
           use_native: bool = True) -> list[np.ndarray]:
    """Recover the k data cells from any k survivors.

    `cells` is the full stripe, length k+m, with None for missing /
    failed cells; all present cells must be the same length (a common
    byte sub-range of each cell is fine — the map is positionwise).
    Raises ECDecodeError when fewer than k cells survive."""
    k, m = profile.k, profile.m
    if len(cells) != k + m:
        raise err.InvalidArgument(
            f"decode wants {k + m} slots, got {len(cells)}")
    present = [i for i, c in enumerate(cells) if c is not None]
    if len(present) < k:
        raise ECDecodeError(
            f"{k + m - len(present)} erasures exceed m={m} for "
            f"{profile.name}")
    if all(cells[j] is not None for j in range(k)):
        return [_as_u8(cells[j]) for j in range(k)]
    # prefer data cells (identity rows make the inverse sparser), top up
    # with parity to exactly k rows
    rows = [i for i in present if i < k] + \
           [i for i in present if i >= k]
    rows = rows[:k]
    sub = profile.gen[rows]                  # k x k
    inv = gf_matinv(sub)
    surv = [_as_u8(cells[i]) for i in rows]
    n = len(surv[0])
    return _matmul_cells(inv, surv, n, use_native)


def reconstruct(profile: ECProfile, cells: list, targets: list[int],
                use_native: bool = True) -> dict[int, np.ndarray]:
    """Rebuild specific lost cells (data or parity) from any k
    survivors — the server-side healing path. Returns {index: cell}."""
    data = decode(profile, cells, use_native=use_native)
    out: dict[int, np.ndarray] = {}
    need_parity = [t for t in targets if t >= profile.k]
    parity = None
    if need_parity:
        parity = encode(profile, data, use_native=use_native)
    for t in targets:
        out[t] = data[t] if t < profile.k else parity[t - profile.k]
    return out
