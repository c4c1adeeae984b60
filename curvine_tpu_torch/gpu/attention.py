"""Attention without a kernel: dense, and the ring over a ``seq`` axis.

Port of ``curvine_tpu/tpu/ring_attention.py``. ``dense_attention`` is the
plain path the model takes wherever flash attention is not eligible (on
the CPU, or for shapes the kernel does not tile), and the yardstick the
flash kernels are tested against. ``ring_attention`` is exact attention
over a sequence split along a mesh axis: q stays put, k and v rotate
around the axis with ``gpu/mesh.py::ppermute`` while each step folds one
block into flash-style online-softmax partials (o, m, s). The
reference's blocks are XLA einsums, not a Pallas kernel, so the port's
are plain torch, with the reference's numerics: the scores, ``m`` and
``s`` in q's dtype, ``NEG_INF`` for masked scores and the ``max(m,
NEG_INF)`` guard, masked weights, and ``o / max(s, 1e-20)`` at the end.
Layout ``[B, H, L, D]``.

Causal masking is on global positions: with q's block index i fixed and
the kv block visiting at step t from index j = (i - t) mod P, a block is
fully visible when j < i, fully masked when j > i, and diagonal when
j == i."""

from __future__ import annotations

import math

import torch

from curvine_tpu_torch.gpu.mesh import P, ppermute, shard_map

__all__ = ["NEG_INF", "dense_attention", "ring_attention", "ring_spec",
           "ring_attention_sharded"]

NEG_INF = -1e30


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Softmax(q kᵀ / √D) v over ``[B, H, L, D]``, masked above the
    diagonal when ``causal``. The scores and weights keep the inputs'
    dtype, as the JAX function's do."""
    L = q.shape[2]
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(q.shape[-1])
    if causal:
        mask = torch.ones(L, L, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~mask, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w, v)


def _block_attn(q, k, v, mask):
    """One (q block, kv block) step → (o unnormalised, row max, row sum).
    q: [B, H, Lq, D], k and v: [B, H, Lk, D], mask [Lq, Lk] bool."""
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(q.shape[-1])
    scores = scores.masked_fill(~mask, NEG_INF)
    m = scores.amax(-1, keepdim=True)
    m = m.clamp_min(NEG_INF)                # avoid -inf - -inf
    p = torch.exp(scores - m)
    p = p.masked_fill(~mask, 0.0)
    s = p.sum(-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v)
    return o, m, s


def _merge(o1, m1, s1, o2, m2, s2):
    """Merge two online-softmax partials."""
    m = torch.maximum(m1, m2)
    a1 = torch.exp(m1 - m)
    a2 = torch.exp(m2 - m)
    return o1 * a1 + o2 * a2, m, s1 * a1 + s2 * a2


def ring_attention(q, k, v, mesh, axis_name: str = "seq",
                   causal: bool = True) -> torch.Tensor:
    """Runs inside ``shard_map``: q, k, v are this rank's local blocks
    [B, H, L/P, D] of a sequence split over ``axis_name`` of ``mesh``.
    Returns the local output block [B, H, L/P, D]. Takes P steps and
    rotates k and v after each, the last included, as the reference's
    scan does; every rank calls it with blocks of one shape."""
    n = mesh.size(mesh.mesh_dim_names.index(axis_name))
    my = mesh.get_local_rank(axis_name)
    lq, lk = q.shape[2], k.shape[2]
    q_pos = my * lq + torch.arange(lq, device=q.device)
    o = torch.zeros_like(q)
    m = torch.full(q.shape[:3] + (1,), NEG_INF, dtype=q.dtype,
                   device=q.device)
    s = torch.zeros(q.shape[:3] + (1,), dtype=q.dtype, device=q.device)
    for step in range(n):
        if causal:
            kv_pos = ((my - step) % n) * lq + torch.arange(lk,
                                                           device=q.device)
            mask = q_pos[:, None] >= kv_pos[None, :]
        else:
            mask = torch.ones(lq, lk, dtype=torch.bool, device=q.device)
        o, m, s = _merge(o, m, s, *_block_attn(q, k, v, mask))
        k = ppermute(k, mesh, axis_name)
        v = ppermute(v, mesh, axis_name)
    return o / s.clamp_min(1e-20)


def ring_spec(mesh, axis_name: str = "seq") -> P:
    """The layout ``ring_attention_sharded`` runs on: [B, H, L, D] with L
    over ``axis_name``, and B over ``data`` and H over ``model`` where
    the mesh has them."""
    names = mesh.mesh_dim_names
    return P("data" if "data" in names else None,
             "model" if "model" in names else None, axis_name, None)


def ring_attention_sharded(q, k, v, mesh, axis_name: str = "seq",
                           causal: bool = True):
    """``ring_attention`` under ``shard_map``: q, k, v are DTensors
    [B, H, L, D] laid out by ``ring_spec`` (L over ``axis_name``); the
    output has the same layout. The reference's shard_map names only
    ``axis_name``, so every data and model rank computes every row and
    head; here each rank runs the ring on its own rows and heads over
    its ``axis_name`` group. Rows and heads are independent, so the
    values are the same, and none is computed twice. Inputs laid out
    otherwise raise (``shard_map`` moves nothing)."""
    spec = ring_spec(mesh, axis_name)
    return shard_map(
        lambda q, k, v: ring_attention(q, k, v, mesh, axis_name, causal),
        mesh, (spec,) * 3, spec)(q, k, v)
