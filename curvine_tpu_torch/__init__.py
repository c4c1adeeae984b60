"""curvine_tpu_torch: the PyTorch/CUDA port of curvine_tpu's device side.

The JAX package ``curvine_tpu`` stays the reference. This package imports
``torch`` and never ``jax``, and nothing of ``curvine_tpu``: what it needs
from there it keeps as its own copy. Module names mirror the JAX package
(``tpu/`` becomes ``gpu/``) and each module's docstring names the file it
ports.

Entry points run on ``cuda:0`` unless the caller passes a CPU device, as
the CPU tests do; with no CUDA device and no CPU request they raise
(``device.default_device``). The hand-written kernels are CUDA C++ for
``sm_90a`` under ``csrc/``, built with ``nvcc`` at first use into
``build/`` (``gpu/_build.py``): K1, the block checksum
(``gpu.cuda_ops.block_checksum``); K2, the ADC scan of the IVF-PQ search
(``gpu.pq.pq_lut_scan``), which ``vector``'s ANN search runs; and K3,
causal flash attention forward, dK/dV and dQ (``gpu.flash.flash_attention``),
which the train step of ``gpu.model`` runs on a CUDA device.
``csrc/crc32c.cc`` is host C++, built there too with the host compiler.
``rpc`` and ``client`` are the port's own cache client (its wire codec
``rpc.wirepack`` stands in for ``msgpack``), which ``gpu.loader``'s
``GpuTrainFeed`` reads shards through, ``gpu.broadcast`` saves and loads
checkpoints through, and ``vector``'s tables live on."""
