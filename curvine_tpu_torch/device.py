"""Device choice for the port.

Stands in for ``jax.devices()[0]`` / ``jax.local_devices()`` in the JAX
package (``curvine_tpu/tpu/hbm.py:81,183``). The port runs on CUDA by
default; the CPU is used only when the caller asks for it."""

from __future__ import annotations

import torch

__all__ = ["default_device", "local_devices", "device_id"]


def default_device(cpu: bool = False) -> torch.device:
    """``cuda:0``, or the CPU when ``cpu=True``. Raises when CUDA is
    absent and the CPU was not asked for: a silent CPU fallback would
    report host numbers as device numbers."""
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass cpu=True (or a CPU device) "
            "to run on the host")
    return torch.device("cuda", 0)


def local_devices() -> list[torch.device]:
    """Every visible CUDA device (``jax.local_devices()``'s counterpart).
    Raises when there is none."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError("no CUDA device is visible")
    return [torch.device("cuda", i) for i in range(n)]


def device_id(device) -> int:
    """The integer id a tier keys a device by: the CUDA index, or the
    explicit index of a ``torch.device("cpu", i)`` (0 when absent), or
    an int passed as is."""
    if isinstance(device, int):
        return device
    device = torch.device(device)
    if device.index is not None:
        return device.index
    if device.type == "cuda":
        return torch.cuda.current_device()
    return 0
