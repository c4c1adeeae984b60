"""Port parity: the flash-attention gate of ``curvine_tpu_torch/gpu/model.py``
against the reference's (``curvine_tpu/tpu/model.py::_flash_eligible``), on
the CPU.

The port admits on the card what the reference admits on the TPU (head_dim
and L multiples of 128, any dtype). Among those, what K3's kernels do not
take (float32, head_dim 256) fails loudly in ``flash.check_kernel_args``,
before any launch, and is never sent quietly to dense attention."""

import dataclasses
import itertools

import pytest

import torch

from curvine_tpu.tpu import model as jm
from curvine_tpu_torch.gpu import flash, model as tm

CUDA = torch.device("cuda", 0)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

_GRID = list(itertools.product(("float32", "bfloat16"), (64, 128, 256),
                               (96, 128, 256)))


def _configs(dtype: str, head_dim: int):
    base = dict(vocab=64, n_heads=2, n_layers=1, d_ff=64, max_seq=256,
                dtype=dtype, d_model=2 * head_dim, use_flash_attention=True)
    return jm.ModelConfig(**base), tm.ModelConfig(**base)


@pytest.mark.parametrize("dtype,head_dim,L", _GRID)
def test_gate_admits_what_the_reference_admits(monkeypatch, dtype,
                                               head_dim, L):
    jcfg, tcfg = _configs(dtype, head_dim)
    monkeypatch.setattr(jm.jax, "default_backend", lambda: "tpu")
    want = jm._flash_eligible(jcfg, L)
    assert tm._flash_eligible(tcfg, L, CUDA) == want
    assert not tm._flash_eligible(tcfg, L, torch.device("cpu"))
    assert not tm._flash_eligible(
        dataclasses.replace(tcfg, use_flash_attention=False), L, CUDA)


@pytest.mark.parametrize("dtype,head_dim", [("float32", 128),
                                            ("bfloat16", 256),
                                            ("float32", 256)])
def test_admitted_configs_the_kernels_refuse_raise(dtype, head_dim):
    """Admitted by the gate, refused by the kernels' argument check: the
    layer's q/k/v raise ValueError, which the card run surfaces."""
    _, tcfg = _configs(dtype, head_dim)
    assert tm._flash_eligible(tcfg, 128, CUDA)
    q = torch.zeros(1, tcfg.n_heads, 128, tcfg.head_dim,
                    dtype=DTYPES[dtype])
    with pytest.raises(ValueError, match="bf16|head_dim"):
        flash.check_kernel_args(q, q, q)


def test_the_kernels_take_the_flagship_layer():
    _, tcfg = _configs("bfloat16", 128)
    assert tm._flash_eligible(tcfg, 1024, CUDA)
    q = torch.zeros(1, tcfg.n_heads, 1024, 128, dtype=torch.bfloat16)
    flash.check_kernel_args(q, q, q)
