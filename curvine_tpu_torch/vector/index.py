"""IVF ANN index for the port's VectorTable: IVF-flat and IVF-PQ.

Port of ``curvine_tpu/vector/index.py``. The design is the JAX package's
(see its docstring): Lloyd k-means where both steps are matrix products,
a dense [C', L] inverted-list matrix capped at a percentile of the list
lengths with spill lists that repeat their parent's centroid, residual
product quantization, and a search of chained device stages with no host
round trip between them. What changes on the card:

* The plain products (centroid scores, the k-means and PQ-encode products,
  the re-rank, the exact scan) are ``torch`` matmuls in full float32 (a
  bf16 table is multiplied with float32 accumulation, never rounded to
  bf16); JAX leaves them to XLA too.
* The ADC stage of the PQ search is K2, ``gpu.pq.pq_lut_scan``: one launch
  per batch of queries for CUDA tensors, the plain version for CPU tensors.
  There is no switch to a gather-and-sum path.
* ``jax.lax.top_k`` puts the lower index first among equal values, and
  ties are common here (the -inf of list padding and of the sentinel row,
  ``rerank`` or ``k`` larger than the live candidates); ``torch.topk``
  promises no order among them. ``_topk`` makes the order explicit.
* ``lax.map`` over query chunks becomes a loop over chunks; results are
  per query, so the chunking does not change them.
* The centroid update stays a one-hot product, as in JAX: deterministic,
  where ``index_add_`` on CUDA adds with atomics in a varying order.

Freshness follows the Lance model, as in the JAX package: an index is
built at a table (version, row_groups, deletes) snapshot, and table
mutations leave it stale."""

from __future__ import annotations

import functools
import json

import numpy as np
import torch

from curvine_tpu_torch.common import errors as err
from curvine_tpu_torch.device import default_device
from curvine_tpu_torch.gpu import pq as pq_ops

__all__ = ["PqCodebook", "IvfIndex", "table_snapshot"]

FLAT_QCHUNK = 16                   # the JAX package's qchunk
PQ_CHUNK_BYTES = 512 << 20         # the PQ search's per-chunk gathers


def _as_tensor(a, device, dtype=None) -> torch.Tensor:
    """A numpy array (or tensor) as a tensor on ``device``; a read-only
    array (a view of bytes read from the cache) is copied first."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype)
    a = np.asarray(a)
    if not a.flags.writeable or not a.flags.c_contiguous:
        a = np.array(a)
    return torch.from_numpy(a).to(device=device, dtype=dtype)


def _device(device) -> torch.device:
    """``device``, or the card when None (an error without one); a CUDA
    device always with its index, so that device caches key alike."""
    dev = default_device() if device is None else torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _norm(x: torch.Tensor) -> torch.Tensor:
    """``jnp.linalg.norm(x, axis=1, keepdims=True).clip(1e-12)``."""
    return torch.linalg.vector_norm(x, dim=1, keepdim=True).clamp_min(1e-12)


def _topk(scores: torch.Tensor, k: int):
    """``jax.lax.top_k`` along the last axis of a float32 [Q, N]: the k
    largest, in descending order, the lower index first among equal
    values. Each score becomes a distinct int64 key, its order-preserving
    32 bits above N-1-index, so one ``torch.topk`` has no ties to break.
    The 32 bits follow the float total order, as XLA's top_k does: -0.0
    below +0.0."""
    n = scores.shape[-1]
    bits = scores.contiguous().view(torch.int32).long()
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    rank = torch.arange(n - 1, -1, -1, device=scores.device)
    _, idx = torch.topk(ordered * (1 << 32) + rank, k, dim=-1)
    return scores.gather(-1, idx), idx


@functools.cache
def _mm_has_out_dtype() -> bool:
    """Whether this torch's ``torch.mm`` takes ``out_dtype`` on CUDA (a
    bf16 product with a float32 result)."""
    a = torch.zeros(1, 1, dtype=torch.bfloat16, device="cuda")
    try:
        torch.mm(a, a, out_dtype=torch.float32)
    except (TypeError, RuntimeError, NotImplementedError):
        return False
    return True


def _dots(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[Q, D] x [N, D] -> [Q, N] float32: q cast to the table's type and
    the products summed in float32 (``preferred_element_type``). A bf16
    operand is upcast where torch has no float32-output bf16 product (on
    the CPU); the upcast is exact."""
    qc = q.to(v.dtype)
    if v.dtype == torch.float32:
        return qc @ v.T
    if v.is_cuda and _mm_has_out_dtype():
        return torch.mm(qc, v.T, out_dtype=torch.float32)
    return qc.float() @ v.float().T


def _bdots(q: torch.Tensor, cv: torch.Tensor) -> torch.Tensor:
    """einsum("qd,qmd->qm") of q cast to ``cv``'s type, in float32."""
    qc = q.to(cv.dtype).float()
    return torch.bmm(cv.float(), qc[:, :, None])[:, :, 0]


def _kmeans_step(vectors: torch.Tensor, centroids: torch.Tensor):
    """One Lloyd iteration (``_kmeans_step_fn``): assignment by the
    2 v.c - |c|^2 surrogate, update as a one-hot [C, N] x [N, D] product;
    an empty list keeps its seed."""
    scores = 2.0 * (vectors @ centroids.T) \
        - torch.sum(centroids * centroids, dim=1)[None, :]
    assign = torch.argmax(scores, dim=1)          # first maximum, as JAX
    del scores
    onehot = torch.zeros(vectors.shape[0], centroids.shape[0],
                         dtype=vectors.dtype, device=vectors.device)
    onehot.scatter_(1, assign[:, None], 1.0)
    sums = onehot.T @ vectors
    counts = torch.sum(onehot, dim=0)[:, None]
    del onehot
    new = torch.where(counts > 0, sums / counts.clamp_min(1.0), centroids)
    shift = torch.max(torch.abs(new - centroids))
    return new, assign, shift


def _pq_encode(v: torch.Tensor, cbs: torch.Tensor) -> torch.Tensor:
    """[N, M, dsub] x [M, ksub, dsub] -> [N, M] uint8 nearest codewords."""
    scores = 2.0 * torch.einsum("nmd,mkd->nmk", v, cbs) \
        - torch.sum(cbs * cbs, dim=2)[None, :, :]
    return torch.argmax(scores, dim=2).to(torch.uint8)


# ---------------------------------------------------------------- PQ


class PqCodebook:
    """Product-quantization codebooks: M subspaces of dsub dims, each
    with ksub (<=256) centroids, codes 1 byte per subspace."""

    def __init__(self, codebooks: np.ndarray):
        self.codebooks = np.asarray(codebooks, dtype=np.float32)
        self.m, self.ksub, self.dsub = self.codebooks.shape

    @staticmethod
    def train(vectors: np.ndarray, m: int, ksub: int = 256,
              iters: int = 8, device=None, seed: int = 0,
              sample: int = 65536) -> "PqCodebook":
        """Per-subspace k-means on (a sample of) the vectors, the same
        numpy draws as the JAX package's."""
        n, d = vectors.shape
        if d % m:
            raise err.InvalidArgument(f"dim {d} not divisible by pq_m {m}")
        dsub = d // m
        rng = np.random.default_rng(seed)
        if n > sample:
            train_v = vectors[rng.choice(n, size=sample, replace=False)]
        else:
            train_v = vectors
        tn = train_v.shape[0]
        ksub = max(1, min(ksub, 256, tn))
        sub = np.ascontiguousarray(
            train_v.reshape(tn, m, dsub).transpose(1, 0, 2))
        dev = _device(device)
        cbs = []
        for mi in range(m):
            v = _as_tensor(np.ascontiguousarray(sub[mi], dtype=np.float32),
                           dev)
            seeds = sub[mi][rng.choice(tn, size=ksub, replace=False)]
            cent = _as_tensor(np.asarray(seeds, dtype=np.float32), dev)
            for _ in range(iters):
                cent, _, shift = _kmeans_step(v, cent)
                if float(shift) < 1e-4:
                    break
            cbs.append(cent.cpu().numpy())
        return PqCodebook(np.stack(cbs))

    def encode(self, vectors, device=None, chunk: int = 16384,
               anchors=None) -> np.ndarray:
        """[N, D] -> [N, M] uint8 codes, in chunks of ``chunk`` rows.
        ``anchors=(centers [C, D], assign [N])`` encodes the residuals
        vectors[i] - centers[assign[i]]. Inputs may be numpy arrays or
        tensors (the build passes its device copies)."""
        n, d = vectors.shape
        if d != self.m * self.dsub:
            raise err.InvalidArgument(
                f"encode dim {d} != {self.m}x{self.dsub}")
        dev = _device(device)
        cbs = _as_tensor(self.codebooks, dev)
        if anchors is not None:
            centers = _as_tensor(anchors[0], dev, torch.float32)
            assign = _as_tensor(anchors[1], dev, torch.long)
        out = torch.empty((n, self.m), dtype=torch.uint8, device=dev)
        chunk = min(chunk, max(1, n))
        for off in range(0, n, chunk):
            part = _as_tensor(vectors[off:off + chunk], dev, torch.float32)
            if anchors is not None:
                part = part - centers[assign[off:off + chunk]]
            out[off:off + chunk] = _pq_encode(
                part.reshape(-1, self.m, self.dsub), cbs)
        return out.cpu().numpy()

    def decode(self, codes: np.ndarray) -> np.ndarray:
        """[N, M] uint8 -> reconstructed [N, D] f32 (codeword lookup)."""
        codes = np.asarray(codes)
        parts = [self.codebooks[mi][codes[:, mi].astype(np.int64)]
                 for mi in range(self.m)]
        return np.concatenate(parts, axis=1)


# ---------------------------------------------------------------- search


def _probe(q, cs, lists, nprobe, sentinel):
    """top-nprobe lists of each query -> (probe [Q, nprobe], cand [Q, W]
    row ids with -1 padding, slot [Q, W] with the padding on the
    sentinel row)."""
    _, probe = _topk(cs, nprobe)
    cand = lists[probe].reshape(q.shape[0], -1)
    slot = torch.where(cand < 0, sentinel, cand)
    return probe, cand, slot


def _exact_scores(q, qn, cv, metric):
    """The brute-force scan's arithmetic on gathered rows cv [Q, R, D]."""
    dots = _bdots(q, cv)
    if metric == "cosine":
        return dots / qn
    cvf = cv.float()
    return -(torch.sum(q * q, dim=1)[:, None]
             - 2.0 * dots + torch.sum(cvf * cvf, dim=2))


def _flat_chunk(q, cent, lists, v_pad, ids_pad, metric, k, nprobe):
    """IVF-flat (``_search_fn``'s one_chunk): probe, gather the
    candidates' rows from the pinned table, exact scores, top-k."""
    qn = _norm(q)
    if metric == "cosine":
        cs = (q / qn) @ (cent / _norm(cent)).T
    else:
        cs = 2.0 * (q @ cent.T) \
            - torch.sum(cent * cent, dim=1)[None, :]
    _, cand, slot = _probe(q, cs, lists, nprobe, v_pad.shape[0] - 1)
    scores = _exact_scores(q, qn, v_pad[slot], metric)
    scores = torch.where(cand < 0, float("-inf"), scores)
    s, idx = _topk(scores, min(k, int(scores.shape[1])))
    return s, ids_pad[slot.gather(1, idx)]


def _pq_chunk(q, cent, lists, cbs, codes_pad, norms_pad, v_pad, ids_pad,
              metric, k, nprobe, rerank, adc):
    """Two-stage IVF-PQ (``_pq_search_fn``'s one_chunk): probe; residual
    ADC of the probed candidates through ``adc`` (K2); exact re-rank of
    the top-``rerank`` survivors; top-k."""
    m, ksub, dsub = cbs.shape
    L = lists.shape[1]
    qn = _norm(q)
    cdot = q @ cent.T                                   # [Qc, C']
    if metric == "cosine":
        cnorm = torch.linalg.vector_norm(cent, dim=1).clamp_min(1e-12)
        cs = (cdot / qn) / cnorm[None, :]
    else:
        cs = 2.0 * cdot - torch.sum(cent * cent, dim=1)[None, :]
    probe, cand, slot = _probe(q, cs, lists, nprobe, v_pad.shape[0] - 1)

    # residual ADC: x ~ c + r_hat, so q.x ~ q.c (per list) + sum_m LUT
    lut = torch.einsum("qmd,mkd->qmk", q.reshape(q.shape[0], m, dsub), cbs)
    cprobe = cdot.gather(1, probe)
    if metric == "l2":
        lut = 2.0 * lut
        cprobe = 2.0 * cprobe
    const = cprobe.repeat_interleave(L, dim=1)          # [Qc, W]
    codes = codes_pad[slot]                             # [Qc, W, M] int32
    scores = adc(lut.contiguous(), codes, pre_offset=True) + const
    if metric == "l2":
        scores = scores - norms_pad[slot]
    scores = torch.where(cand < 0, float("-inf"), scores)

    # exact re-rank of the top-R ADC survivors
    rr = min(rerank, int(scores.shape[1]))
    _, r_idx = _topk(scores, rr)
    r_slot = slot.gather(1, r_idx)
    r_cand = cand.gather(1, r_idx)
    scores = _exact_scores(q, qn, v_pad[r_slot], metric)
    scores = torch.where(r_cand < 0, float("-inf"), scores)
    s, idx = _topk(scores, min(k, rr))
    return s, ids_pad[r_slot.gather(1, idx)]


def _capped_layout(assign: np.ndarray, nlist: int, cap_pct: float
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Pack cluster members into a dense [C+S, cap] id matrix. cap is
    the cap_pct-percentile list length; clusters longer than cap get
    SPILL rows appended after the primaries, and `owner[row]` names the
    centroid each matrix row belongs to (owner[c]=c for primaries).
    Falls back to the plain max-length layout when capping would not
    shrink the matrix by >=10% (tiny/uniform tables)."""
    counts = np.bincount(assign, minlength=nlist)
    max_len = max(int(counts.max()) if counts.size else 1, 1)
    cap = max_len
    if cap_pct < 100.0 and counts.size:
        pcap = max(1, int(np.ceil(np.percentile(counts, cap_pct))))
        if pcap < max_len:
            spills = int(np.sum(np.maximum(
                np.ceil(counts / pcap).astype(np.int64) - 1, 0)))
            if (nlist + spills) * pcap < 0.9 * nlist * max_len:
                cap = pcap
    order = np.argsort(assign, kind="stable").astype(np.int32)
    bounds = np.concatenate([[0], np.cumsum(counts)])
    extra = np.maximum(np.ceil(counts / cap).astype(np.int64) - 1, 0)
    total = nlist + int(extra.sum())
    lists = np.full((total, cap), -1, dtype=np.int32)
    owner = np.arange(total, dtype=np.int32)
    spill = nlist
    for c in range(nlist):
        members = order[bounds[c]:bounds[c + 1]]
        lists[c, :min(cap, members.size)] = members[:cap]
        for off in range(cap, members.size, cap):
            part = members[off:off + cap]
            lists[spill, :part.size] = part
            owner[spill] = c
            spill += 1
    return lists, owner


class IvfIndex:
    """Device-side state + persistence for one table's IVF index
    (flat or PQ)."""

    def __init__(self, nlist: int, centroids: np.ndarray,
                 lists: np.ndarray, built_at: dict,
                 pq: PqCodebook | None = None,
                 codes: np.ndarray | None = None,
                 norms: np.ndarray | None = None):
        self.nlist = nlist                # logical k-means lists
        self.centroids = centroids        # [C+S, D] f32 (spill rows
        #                                   duplicate their parent's)
        self.lists = lists                # [C+S, L] i32 dense-row ids,
        #                                   -1 pad
        self.built_at = built_at          # table snapshot id
        self.pq = pq                      # PqCodebook | None
        self.codes = codes                # [N, M] uint8 RESIDUAL codes,
        #                                   dense-row order
        self.norms = norms                # [N] f32 |c+r_hat|^2 (l2 ADC)
        self.adc_calls = 0                # ADC stages the search issued
        self._dev: dict = {}

    @property
    def nlist_total(self) -> int:
        """Physical list count including spill lists."""
        return int(self.lists.shape[0])

    # ---------------- build ----------------

    @staticmethod
    def build(vectors: np.ndarray, dense_ids: np.ndarray, nlist: int,
              built_at: dict, iters: int = 10, device=None,
              seed: int = 0, cap_pct: float = 95.0,
              pq_m: int | None = None, pq_ksub: int = 256,
              pq_iters: int = 8, pq_sample: int = 65536) -> "IvfIndex":
        """K-means on the device over the LIVE vectors ([N, D] host array,
        dense row i <-> dense_ids[i] in the pinned table), with the JAX
        package's numpy draws from ``seed``. pq_m != None also trains PQ
        codebooks on residuals and packs one uint8 code row per vector."""
        n, d = vectors.shape
        nlist = max(1, min(nlist, n))
        rng = np.random.default_rng(seed)
        seeds = vectors[rng.choice(n, size=nlist, replace=False)]
        dev = _device(device)
        v = _as_tensor(np.asarray(vectors, dtype=np.float32), dev)
        cent = _as_tensor(np.asarray(seeds, dtype=np.float32), dev)
        assign = None
        for _ in range(iters):
            cent, assign, shift = _kmeans_step(v, cent)
            if float(shift) < 1e-4:
                break
        assign_h = assign.cpu().numpy()
        centroids = cent.cpu().numpy()
        lists, owner = _capped_layout(assign_h, nlist, cap_pct)
        pq = None
        codes = None
        norms = None
        if pq_m:
            # PQ on residuals x - c_assigned (Jegou IVF-ADC), trained on a
            # sample, encoded in chunks on the device
            sidx = rng.choice(n, size=min(n, pq_sample), replace=False)
            resid_sample = vectors[sidx] - centroids[assign_h[sidx]]
            pq = PqCodebook.train(resid_sample, pq_m, ksub=pq_ksub,
                                  iters=pq_iters, device=dev, seed=seed,
                                  sample=pq_sample)
            codes = pq.encode(v, device=dev, anchors=(cent, assign))
            norms = _recon_norms(pq, codes, cent, assign, dev)
        del v
        centroids = centroids[owner]
        return IvfIndex(nlist, centroids, lists, built_at, pq=pq,
                        codes=codes, norms=norms)

    # ---------------- persistence ----------------

    def to_bytes(self) -> bytes:
        meta = {
            "fmt": 2, "nlist": self.nlist,
            "nlist_total": int(self.lists.shape[0]),
            "dim": int(self.centroids.shape[1]),
            "list_cap": int(self.lists.shape[1]),
            "built_at": self.built_at, "pq": None}
        if self.pq is not None:
            meta["pq"] = {"m": self.pq.m, "ksub": self.pq.ksub,
                          "dsub": self.pq.dsub,
                          "rows": int(self.codes.shape[0])}
        mb = json.dumps(meta).encode()
        parts = [np.int64(len(mb)).tobytes(), mb,
                 self.centroids.astype(np.float32).tobytes(),
                 self.lists.astype(np.int32).tobytes()]
        if self.pq is not None:
            parts.append(self.pq.codebooks.astype(np.float32).tobytes())
            parts.append(self.codes.astype(np.uint8).tobytes())
            parts.append(self.norms.astype(np.float32).tobytes())
        return b"".join(parts)

    @staticmethod
    def from_bytes(buf) -> "IvfIndex":
        view = np.frombuffer(buf, dtype=np.uint8)
        mlen = int(view[:8].view(np.int64)[0])
        meta = json.loads(view[8:8 + mlen].tobytes())
        off = 8 + mlen
        d, cap = meta["dim"], meta["list_cap"]
        # fmt 1 (pre-PQ) files have no nlist_total/pq keys
        ct = meta.get("nlist_total", meta["nlist"])
        cent = view[off:off + ct * d * 4].view(np.float32).reshape(ct, d)
        off += ct * d * 4
        lists = view[off:off + ct * cap * 4].view(np.int32).reshape(
            ct, cap)
        off += ct * cap * 4
        pq = None
        codes = None
        norms = None
        pmeta = meta.get("pq")
        if pmeta:
            m, ksub, dsub = pmeta["m"], pmeta["ksub"], pmeta["dsub"]
            cbs = view[off:off + m * ksub * dsub * 4].view(
                np.float32).reshape(m, ksub, dsub)
            off += m * ksub * dsub * 4
            rows = pmeta["rows"]
            codes = view[off:off + rows * m].reshape(rows, m)
            off += rows * m
            norms = view[off:off + rows * 4].view(np.float32)
            pq = PqCodebook(np.array(cbs))
        return IvfIndex(meta["nlist"], cent, lists, meta["built_at"],
                        pq=pq, codes=codes, norms=norms)

    # ---------------- search ----------------

    def _device_state(self, device: torch.device) -> dict:
        got = self._dev.get(device)
        if got is None:
            got = {"cent": _as_tensor(self.centroids, device),
                   "lists": _as_tensor(self.lists, device, torch.long)}
            if self.pq is not None:
                # sentinel-padded codes pinned PRE-OFFSET as int32:
                # codes[i, m] + m*ksub indexes the flattened [M*ksub] LUT;
                # row N is the sentinel the -1 list padding maps to
                # (masked out of the ADC scores)
                offs = (np.arange(self.pq.m, dtype=np.int32)
                        * self.pq.ksub)[None, :]
                codes_pad = np.concatenate(
                    [self.codes.astype(np.int32) + offs,
                     np.broadcast_to(offs, (1, self.pq.m))])
                norms_pad = np.concatenate(
                    [np.asarray(self.norms, dtype=np.float32),
                     np.zeros(1, dtype=np.float32)])
                got["cbs"] = _as_tensor(self.pq.codebooks, device)
                got["codes"] = _as_tensor(codes_pad, device)
                got["norms"] = _as_tensor(norms_pad, device)
            self._dev = {device: got}
        return got

    def search(self, query, v_pinned: torch.Tensor, ids_pinned: torch.Tensor,
               k: int, metric: str, nprobe: int, device=None,
               use_pq: bool | str = "auto", rerank: int | None = None,
               adc=None):
        """v_pinned/ids_pinned: the table's one pinned sentinel-padded pair
        (LIVE rows + a zero/-1 sentinel, normalized per metric), shared
        with the exact scan.

        use_pq: "auto" uses the ADC path iff PQ codes were built; rerank:
        ADC survivors re-scored exactly (default max(4k, 32)). ``adc`` is
        the ADC stage, K2 (``pq_ops.pq_lut_scan``) when None; a caller may
        pass K2's plain version to hold the kernel's search against it."""
        adc = pq_ops.pq_lut_scan if adc is None else adc
        if use_pq == "auto":
            use_pq = self.pq is not None
        elif use_pq and self.pq is None:
            raise err.InvalidArgument(
                "index has no PQ codes (create_index(pq_m=...))")
        dev = v_pinned.device if device is None else _device(device)
        nprobe = max(1, min(nprobe, self.nlist_total))
        state = self._device_state(dev)
        q = _as_tensor(np.atleast_2d(np.asarray(query, dtype=np.float32)),
                       dev)
        width = nprobe * int(self.lists.shape[1])
        if not use_pq:
            args = (state["cent"], state["lists"], v_pinned, ids_pinned,
                    metric, k, nprobe)
            return _chunked(q, FLAT_QCHUNK,
                            lambda qq: _flat_chunk(qq, *args))
        rr = max(k, min(rerank if rerank else max(4 * k, 32), width))
        # the [Qc, W, M] codes and [Qc, R, D] re-rank gathers bound the
        # chunk; at the serving shape (W 7.7K, M 16, R 512, D 256) one
        # chunk holds 256 queries: one ADC launch a batch
        per_query = width * (4 * self.pq.m + 24) \
            + rr * v_pinned.shape[1] * 8
        qchunk = int(max(1, min(256, PQ_CHUNK_BYTES // per_query)))
        args = (state["cent"], state["lists"], state["cbs"], state["codes"],
                state["norms"], v_pinned, ids_pinned, metric, k, nprobe, rr)

        def one(qq):
            self.adc_calls += 1
            return _pq_chunk(qq, *args, adc)
        return _chunked(q, qchunk, one)


def _chunked(q: torch.Tensor, qchunk: int, fn):
    """``fn`` over query chunks of at most ``qchunk`` rows (``lax.map``'s
    counterpart), results concatenated."""
    if q.shape[0] <= qchunk:
        return fn(q)
    parts = [fn(q[off:off + qchunk]) for off in range(0, q.shape[0], qchunk)]
    return (torch.cat([s for s, _ in parts]),
            torch.cat([i for _, i in parts]))


def _recon_norms(pq: PqCodebook, codes: np.ndarray, cent: torch.Tensor,
                 assign: torch.Tensor, dev: torch.device,
                 chunk: int = 65536) -> np.ndarray:
    """Per-row |c_assigned + r_hat|^2, the l2 ADC term, in chunks."""
    cbs = _as_tensor(pq.codebooks, dev)
    sub = torch.arange(pq.m, device=dev)[None, :]
    n = codes.shape[0]
    out = torch.empty(n, dtype=torch.float32, device=dev)
    for off in range(0, n, chunk):
        part = _as_tensor(codes[off:off + chunk], dev, torch.long)
        recon = cbs[sub, part].reshape(part.shape[0], -1) \
            + cent[assign[off:off + chunk]]
        out[off:off + chunk] = torch.sum(recon * recon, dim=1)
    return out.cpu().numpy()


def table_snapshot(table) -> dict:
    """The freshness id an index is built against."""
    return {"version": table.version, "row_groups": table.row_groups,
            "deletes": len(table._deletes or ())}
