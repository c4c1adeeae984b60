"""Vector tables on the cache, IVF-flat / IVF-PQ search and batched ANN
serving, on the card (port of ``curvine_tpu/vector``)."""

from curvine_tpu_torch.vector.index import IvfIndex, PqCodebook
from curvine_tpu_torch.vector.serving import AnnServer
from curvine_tpu_torch.vector.table import VectorTable

__all__ = ["VectorTable", "AnnServer", "IvfIndex", "PqCodebook"]
