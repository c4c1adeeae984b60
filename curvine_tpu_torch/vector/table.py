"""Vector tables on the cache, searched on the card.

Port of ``curvine_tpu/vector/table.py``. Row groups are fixed-schema
columnar blobs stored as ordinary cached files; the table's live rows are
pinned in device memory as one [N + 1, D] tensor with a zero sentinel row
(id -1), normalised for cosine, in float32 or bf16; an exact k-NN is one
matrix product and a top-k over it, and an IVF index
(``vector/index.py``) narrows the search when it is fresh.

The client is the constructor's argument, as in the JAX package, and the
port imports none: it calls ``open(path)`` (a reader with ``len``,
``read_all()``, ``mmap_view()`` and ``close()``), ``write_all``,
``meta.mkdir`` and ``meta.delete``. ``client.posix.PosixClient`` offers
those over a directory; the port's ``CurvineClient`` offers them over
the cache. Errors of either are
told apart by their wire code (``errors.code_of``).

Layout under `<path>/` (the JAX package's, byte for byte):
  schema.json                  {"dim": D, "columns": {...}, "row_groups": N}
  rg-00000.vec ...             row groups: [n, D] float32 + packed columns
"""

from __future__ import annotations

import asyncio
import json
import logging

import numpy as np
import torch

from curvine_tpu_torch.common import errors as err
from curvine_tpu_torch.vector.index import (
    IvfIndex, _as_tensor, _device, _dots, _norm, _topk, table_snapshot)

log = logging.getLogger(__name__)

_DTYPES = {"f32": np.float32, "i32": np.int32, "i64": np.int64}


def _scan(q: torch.Tensor, v: torch.Tensor, ids: torch.Tensor, metric: str,
          k: int):
    """Exact [Q, D] x [D, N] scan and top-k (``_scan_fn``). ``v`` may be
    bf16; the products sum in float32 either way. ``v``/``ids`` carry a
    zero sentinel row (id -1) at the end, masked out here."""
    dots = _dots(q, v)                                  # [Q, N] float32
    if metric == "cosine":
        scores = dots / _norm(q)
    else:
        vf = v.float()
        vv = torch.sum(vf * vf, dim=1)
        scores = -(torch.sum(q * q, dim=1)[:, None]
                   - 2 * dots + vv[None, :])
    scores = torch.where(ids[None, :] < 0, float("-inf"), scores)
    s, dense = _topk(scores, min(k, scores.shape[1]))
    return s, ids[dense]                # dense idx -> global row id


async def _read_file(client, path: str):
    """The whole of one file; the reader is closed after."""
    reader = await client.open(path)
    try:
        return await reader.read_all()
    finally:
        await reader.close()


def _is_not_found(e: BaseException) -> bool:
    return err.code_of(e) == err.FILE_NOT_FOUND


class VectorTable:
    def __init__(self, client, path: str, dim: int,
                 columns: dict[str, str], row_groups: int,
                 version: int = 0, rows: int | None = None):
        self.client = client
        self.path = path.rstrip("/")
        self.dim = dim
        self.columns = columns
        self.row_groups = row_groups
        self.version = version
        self.rows = rows          # physical rows (None: legacy manifest)
        # deleted global row ids (Lance-style delete vector; rows stay in
        # their row groups until compaction rewrites them out)
        self._deletes: set[int] | None = None
        # the table's LIVE vectors pinned on the device (normalized per
        # metric) + the dense->global id map
        self._dev_cache: dict = {}
        # lazily-loaded IVF index (vector/index.py); None = not probed
        self._index = None
        self._index_missing = False
        # knn calls that wanted the index but fell back to the exact scan
        # because it was stale: logged once, counted always
        self.stale_fallbacks = 0
        self._stale_warned = False

    # ---------------- lifecycle ----------------

    @staticmethod
    async def create(client, path: str, dim: int,
                     columns: dict[str, str] | None = None) -> "VectorTable":
        columns = columns or {}
        for name, dt in columns.items():
            if dt not in _DTYPES:
                raise err.InvalidArgument(f"column {name}: bad dtype {dt}")
        t = VectorTable(client, path, dim, columns, 0, rows=0)
        await client.meta.mkdir(path)
        await t._write_schema()
        return t

    @staticmethod
    async def open(client, path: str) -> "VectorTable":
        s = json.loads(await _read_file(
            client, f"{path.rstrip('/')}/schema.json"))
        return VectorTable(client, path, s["dim"], s["columns"],
                           s["row_groups"], version=s.get("version", 0),
                           rows=s.get("rows"))

    async def _write_schema(self) -> None:
        await self.client.write_all(
            f"{self.path}/schema.json",
            json.dumps({"dim": self.dim, "columns": self.columns,
                        "row_groups": self.row_groups,
                        "version": self.version,
                        "rows": self.rows}).encode())

    # ---------------- delete vector ----------------

    async def _load_deletes(self) -> set[int]:
        if self._deletes is None:
            try:
                raw = await _read_file(self.client,
                                       f"{self.path}/deletes.bin")
                self._deletes = set(
                    np.frombuffer(raw, dtype=np.int64).tolist())
            except Exception as e:
                if not _is_not_found(e):
                    # any other failure propagates WITHOUT memoizing: an
                    # empty set would resurrect tombstoned rows
                    raise
                self._deletes = set()
        return self._deletes

    async def _save_deletes(self) -> None:
        arr = np.array(sorted(self._deletes or ()), dtype=np.int64)
        await self.client.write_all(f"{self.path}/deletes.bin",
                                    arr.tobytes())

    # ---------------- append / scan ----------------

    def _validate_batch(self, vectors: np.ndarray,
                        columns: dict[str, np.ndarray] | None
                        ) -> tuple[np.ndarray, dict[str, np.ndarray]]:
        columns = columns or {}
        vectors = np.ascontiguousarray(vectors, dtype=np.float32)
        if vectors.ndim != 2 or vectors.shape[1] != self.dim:
            raise err.InvalidArgument(
                f"vectors must be [n, {self.dim}], got {vectors.shape}")
        n = vectors.shape[0]
        out = {}
        for name, dt in self.columns.items():
            if name not in columns:
                raise err.InvalidArgument(f"missing column {name!r}")
            col = np.ascontiguousarray(columns[name], dtype=_DTYPES[dt])
            if col.shape[0] != n:
                raise err.InvalidArgument(f"column {name} length mismatch")
            out[name] = col
        return vectors, out

    async def append(self, vectors: np.ndarray,
                     columns: dict[str, np.ndarray] | None = None) -> int:
        """Append one row group; returns its index."""
        vectors, columns = self._validate_batch(vectors, columns)
        n = vectors.shape[0]
        parts = [np.int64(n).tobytes(), vectors.tobytes()]
        for name in self.columns:
            parts.append(columns[name].tobytes())
        rg = self.row_groups
        await self.client.write_all(f"{self.path}/rg-{rg:05d}.vec",
                                    b"".join(parts))
        self.row_groups += 1
        if self.rows is not None:          # legacy manifests stay lazy
            self.rows += n
        self._dev_cache.clear()
        await self._write_schema()
        return rg

    async def read_group(self, rg: int) -> tuple[np.ndarray, dict]:
        reader = await self.client.open(f"{self.path}/rg-{rg:05d}.vec")
        try:
            view = await reader.mmap_view(0, reader.len)
            if view is None:
                view = np.frombuffer(await reader.read_all(), dtype=np.uint8)
        finally:
            await reader.close()
        n = int(view[:8].view(np.int64)[0])
        off = 8
        vec_bytes = n * self.dim * 4
        vectors = view[off:off + vec_bytes].view(np.float32).reshape(
            n, self.dim)
        off += vec_bytes
        cols = {}
        for name, dt in self.columns.items():
            dtype = np.dtype(_DTYPES[dt])
            cols[name] = view[off:off + n * dtype.itemsize].view(dtype)
            off += n * dtype.itemsize
        return vectors, cols

    async def scan(self):
        """Async iterator over (vectors, columns) per row group."""
        for rg in range(self.row_groups):
            yield await self.read_group(rg)

    async def _physical_rows(self) -> int:
        if self.rows is not None:
            return self.rows
        total = 0                  # legacy manifest without a row count
        async for vectors, _ in self.scan():
            total += vectors.shape[0]
        self.rows = total
        return total

    async def count(self) -> int:
        """Live rows (deletes excluded)."""
        return await self._physical_rows() - len(await self._load_deletes())

    # ---------------- delete / update / compaction ----------------

    async def delete(self, row_ids) -> int:
        """Mark global row ids deleted (the bytes stay in their row groups
        until compact()). Returns how many NEW rows were deleted."""
        total = await self._physical_rows()
        ids = [int(r) for r in np.asarray(row_ids).reshape(-1)]
        bad = [r for r in ids if not 0 <= r < total]
        if bad:
            raise err.InvalidArgument(
                f"row ids out of range [0, {total}): {bad[:5]}")
        dels = await self._load_deletes()
        before = len(dels)
        dels.update(ids)
        await self._save_deletes()
        self._dev_cache.clear()
        return len(dels) - before

    async def update(self, row_ids, vectors: np.ndarray,
                     columns: dict[str, np.ndarray] | None = None) -> int:
        """delete + insert (the Lance update model); returns the row group
        holding the new versions. Validation runs before the tombstones
        persist."""
        vectors, columns = self._validate_batch(
            np.atleast_2d(np.asarray(vectors, dtype=np.float32)), columns)
        row_ids = np.asarray(row_ids).reshape(-1)
        if vectors.shape[0] != row_ids.size:
            raise err.InvalidArgument("update rows/vectors length mismatch")
        await self.delete(row_ids)
        return await self.append(vectors, columns)

    async def compact(self) -> int:
        """Rewrite row groups dropping deleted rows; global row ids are
        renumbered densely. Returns live rows kept."""
        dels = await self._load_deletes()
        del_arr = np.fromiter(dels, dtype=np.int64) if dels else \
            np.empty(0, dtype=np.int64)
        old_groups = self.row_groups
        self.row_groups = 0
        self.rows = 0
        self.version += 1
        self._deletes = set()
        # clear the delete vector on disk BEFORE rewriting row groups: a
        # crash mid-compaction then resurrects tombstoned rows instead of
        # tombstoning arbitrary renumbered rows
        await self._save_deletes()
        kept = 0
        base = 0
        for rg in range(old_groups):
            vectors, cols = await self.read_group(rg)
            n = vectors.shape[0]
            keep = np.nonzero(~np.isin(np.arange(n) + base, del_arr))[0]
            base += n
            if not keep.size:
                continue
            await self.append(vectors[keep],
                              {name: np.asarray(cols[name])[keep]
                               for name in self.columns})
            kept += int(keep.size)
        if kept == 0:
            await self._write_schema()
        # drop superseded row-group files past the rewritten prefix
        for rg in range(self.row_groups, old_groups):
            try:
                await self.client.meta.delete(f"{self.path}/rg-{rg:05d}.vec")
            except Exception as e:
                if err.code_of(e) is None:
                    raise
        self._dev_cache.clear()
        return kept

    # ---------------- device knn ----------------

    async def _host_live(self) -> tuple[np.ndarray, np.ndarray]:
        """All LIVE rows as one host [N, D] array + dense->global row-id
        map, in ascending global-id order (the index build and the pinned
        device array agree on this order)."""
        dels = await self._load_deletes()
        if self.row_groups == 0:
            raise err.FileNotFound(f"table {self.path} is empty")
        groups = await asyncio.gather(
            *(self.read_group(rg) for rg in range(self.row_groups)))
        host = (np.concatenate([v for v, _ in groups], axis=0)
                if len(groups) > 1 else groups[0][0])
        if dels:
            mask = ~np.isin(np.arange(host.shape[0]),
                            np.fromiter(dels, dtype=np.int64))
            live = np.nonzero(mask)[0].astype(np.int32)
            host = host[live]
        else:
            live = np.arange(host.shape[0], dtype=np.int32)
        if host.shape[0] == 0:
            raise err.FileNotFound(f"table {self.path} has no live rows")
        return host, live

    async def _device_vectors(self, metric: str, device: torch.device,
                              dtype: str = "f32"):
        """LIVE rows as ONE device [N + 1, D] tensor (normalized for
        cosine, a zero sentinel row last) plus the dense->global id map
        (-1 for the sentinel), pinned across calls; one resident copy a
        table. dtype="bf16" pins half the bytes; scores still sum in
        float32, and top-k order can differ for near-ties."""
        dels = await self._load_deletes()
        key = (metric, dtype, device, self.row_groups, len(dels))
        hit = self._dev_cache.get(key)
        if hit is not None:
            return hit
        self._dev_cache.clear()          # drop the old copy before pinning
        host, live = await self._host_live()
        v = torch.empty((host.shape[0] + 1, host.shape[1]),
                        dtype=torch.float32, device=device)
        v[:-1] = _as_tensor(host, device)
        v[-1] = 0.0
        ids = _as_tensor(np.concatenate([live, np.full(1, -1, np.int32)]),
                         device)
        if metric == "cosine":
            v = v / _norm(v)
        if dtype == "bf16":
            v = v.to(torch.bfloat16)
        if v.is_cuda:
            torch.cuda.synchronize(device)
        self._dev_cache = {key: (v, ids)}
        return v, ids

    # ---------------- IVF index ----------------

    async def create_index(self, nlist: int | None = None,
                           metric: str = "cosine", iters: int = 10,
                           device=None, cap_pct: float = 95.0,
                           pq_m: int | None = None, pq_ksub: int = 256,
                           pq_iters: int = 8,
                           pq_sample: int = 65536) -> IvfIndex:
        """Build (or rebuild) the IVF ANN index on the device and persist
        it as ``index.ivf`` (the JAX package's format 2). The index is a
        snapshot: table mutations leave it stale, and knn falls back to
        the exact scan until the next create_index. ``cap_pct`` clips the
        inverted-list padding at that percentile of list lengths;
        ``pq_m`` also trains residual PQ (pq_m subspaces x pq_ksub
        codewords) for the two-stage ADC + exact re-rank search."""
        if metric not in ("cosine", "l2"):
            raise err.InvalidArgument(f"metric {metric!r}")
        if pq_m and self.dim % pq_m:
            raise err.InvalidArgument(
                f"pq_m {pq_m} must divide dim {self.dim}")
        host, live = await self._host_live()
        if metric == "cosine":
            host = host / np.linalg.norm(
                host, axis=1, keepdims=True).clip(1e-12)
        n = host.shape[0]
        if nlist is None:
            nlist = max(1, int(np.sqrt(n)))     # the usual IVF default
        snap = table_snapshot(self)
        snap["metric"] = metric
        # the build is seconds of host and device work: off the event
        # loop, which goes on serving meanwhile
        idx = await asyncio.to_thread(
            IvfIndex.build, host, live, nlist, snap, iters=iters,
            device=_device(device), cap_pct=cap_pct, pq_m=pq_m,
            pq_ksub=pq_ksub, pq_iters=pq_iters, pq_sample=pq_sample)
        await self.client.write_all(f"{self.path}/index.ivf",
                                    idx.to_bytes())
        self._index = idx
        self._index_missing = False
        return idx

    async def _load_index(self):
        if self._index is not None or self._index_missing:
            return self._index
        try:
            raw = await _read_file(self.client, f"{self.path}/index.ivf")
        except Exception as e:
            if not _is_not_found(e):
                raise
            self._index_missing = True
            return None
        self._index = IvfIndex.from_bytes(raw)
        return self._index

    async def _fresh_index(self, metric: str):
        """The persisted index, or None when absent/stale/other-metric
        (knn then uses the exact scan)."""
        idx = await self._load_index()
        if idx is None:
            return None
        await self._load_deletes()
        snap = table_snapshot(self)
        snap["metric"] = metric
        return idx if idx.built_at == snap else None

    async def knn(self, query: np.ndarray, k: int = 10,
                  metric: str = "cosine", device=None,
                  materialize: bool = True, use_index: bool = True,
                  nprobe: int = 8, dtype: str = "f32",
                  use_pq: bool | str = "auto", rerank: int | None = None):
        """Top-k nearest rows to `query` [D] or [Q, D]: (ids [Q, k],
        scores [Q, k]).

        With a FRESH IVF index and use_index=True the search is chained
        device stages over the probed lists only (with PQ codes and
        use_pq: K2's ADC scan, then an exact re-rank of the top-`rerank`);
        otherwise ONE exact product + top-k over the pinned table. A STALE
        index falls back to the exact scan, warned once and counted in
        `stale_fallbacks`.

        materialize=False returns the device tensors without waiting, so a
        stream of calls can be queued and synchronised once."""
        if metric not in ("cosine", "l2"):
            raise err.InvalidArgument(f"metric {metric!r}")
        if dtype not in ("f32", "bf16"):
            raise err.InvalidArgument(f"dtype {dtype!r}")
        query = np.atleast_2d(np.asarray(query, dtype=np.float32))
        if query.shape[1] != self.dim:
            raise err.InvalidArgument(
                f"query dim {query.shape[1]} != {self.dim}")
        dev = _device(device)
        v, ids = await self._device_vectors(metric, dev, dtype=dtype)
        idx = await self._fresh_index(metric) if use_index else None
        if use_index and idx is None and self._index is not None:
            self.stale_fallbacks += 1
            if not self._stale_warned:
                self._stale_warned = True
                log.warning(
                    "table %s: IVF index is stale (or built for another "
                    "metric) — knn falling back to the exact brute-force "
                    "scan until create_index() rebuilds it (warned once; "
                    "see the stale_fallbacks counter)", self.path)
        if idx is not None:
            s, i = idx.search(query, v, ids, k, metric, nprobe, dev,
                              use_pq=use_pq, rerank=rerank)
        else:
            s, i = _scan(_as_tensor(query, dev), v, ids, metric, k)
        if not materialize:
            return i, s
        return i.cpu().numpy(), s.cpu().numpy()

    async def take(self, row_ids: np.ndarray) -> tuple[np.ndarray, dict]:
        """Materialize rows by global row id (deleted rows are invalid)."""
        row_ids = np.asarray(row_ids).reshape(-1)
        dels = await self._load_deletes()
        bad = [int(r) for r in row_ids if int(r) in dels]
        if bad:
            raise err.InvalidArgument(f"row ids deleted: {bad[:5]}")
        out_vecs = np.zeros((row_ids.size, self.dim), dtype=np.float32)
        out_cols = {name: np.zeros(row_ids.size, dtype=_DTYPES[dt])
                    for name, dt in self.columns.items()}
        base = 0
        async for vectors, cols in self.scan():
            n = vectors.shape[0]
            mask = (row_ids >= base) & (row_ids < base + n)
            if mask.any():
                local = row_ids[mask] - base
                out_vecs[mask] = vectors[local]
                for name in self.columns:
                    out_cols[name][mask] = cols[name][local]
            base += n
        return out_vecs, out_cols
