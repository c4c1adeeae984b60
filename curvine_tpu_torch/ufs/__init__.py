"""The port's under-filesystems: ``file://`` and ``mem://`` (ROADMAP A3e
queues the object stores)."""

from curvine_tpu_torch.ufs.base import (Ufs, UfsStatus, create_ufs,
                                        register_scheme, split_uri)
from curvine_tpu_torch.ufs import local, memory  # noqa: F401  (register)

__all__ = ["Ufs", "UfsStatus", "create_ufs", "register_scheme", "split_uri"]
