"""Reference single-device attention.

The port's own copy of ``NEG_INF`` and ``dense_attention`` from
``curvine_tpu/tpu/ring_attention.py:22,82-90``: the plain path the model
takes wherever flash attention is not eligible (on the CPU, or for
shapes the kernel does not tile), and the yardstick the flash kernels
are tested against. Layout ``[B, H, L, D]``. Under a mesh the model calls
it on each rank's local heads. Ring attention is not ported (ROADMAP
A11)."""

from __future__ import annotations

import math

import torch

__all__ = ["NEG_INF", "dense_attention"]

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
