"""The yardstick that ``chip_smoke.py`` holds the K3 kernels to, pinned on
the CPU: ``flash_errors`` passes the plain versions' outputs and fails
outputs with a planted fault of the kinds a kernel could make, and
``flash_bounds`` gives the bounds that PERF.md's kernel table states.
Inputs come from numpy seeds; everything runs the plain versions of
``curvine_tpu_torch.gpu.flash``."""

import numpy as np
import pytest
import torch

import chip_smoke
from curvine_tpu_torch.gpu import flash

SHAPE = (3, 5, 384, 128)        # odd B*H, three 128-row tiles


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(5)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(SHAPE, np.float32))
                   .to(torch.bfloat16) for _ in range(4))
    o, lse = flash.flash_fwd_plain(q, k, v)
    di = flash.flash_bwd_di_plain(q, k, v, do, lse)
    dq, dk, dv = flash.flash_bwd_plain(q, k, v, do, lse, di)
    return {"in": (q, k, v, do, lse, di), "o": o, "lse": lse, "di": di,
            "dq": dq, "dk": dk, "dv": dv}


def _dq(q, k, v, do, lse, di, visible, scale_out=1.0):
    """dQ as the plain backward computes it, with P kept where
    ``visible`` [L, L] is true: the faults below change the mask, di or
    the output's scale."""
    scale = 1.0 / q.shape[-1] ** 0.5
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.exp(s - lse.unsqueeze(-1)).masked_fill(~visible, 0.0)
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = (p * (dp - di.unsqueeze(-1)) * scale).to(q.dtype).float()
    return (torch.matmul(ds, k.float()) * scale_out).to(q.dtype)


def _causal(L, shift=0):
    i = torch.arange(L)
    return i[None, :] <= i[:, None] + shift


def test_plain_outputs_pass_against_themselves(case):
    for name in ("o", "lse", "di", "dq", "dk", "dv"):
        e = chip_smoke.flash_errors(name, case[name], case[name].clone())
        assert e["ok"] and e["elem_ratio"] == 0.0, (name, e)


def test_plain_dq_rebuilt_passes(case):
    """The faults' own dQ with nothing planted is the plain dQ: what
    fails below fails for its fault alone."""
    L = SHAPE[2]
    got = _dq(*case["in"], _causal(L))
    assert chip_smoke.flash_errors("dq", got, case["dq"])["ok"]


def _fault(name, case):
    q, k, v, do, lse, di = case["in"]
    L = SHAPE[2]
    i = torch.arange(L)
    if name == "dq scaled by 1.01":
        return "dq", _dq(q, k, v, do, lse, di, _causal(L), 1.01)
    if name == "dq with di = 0":
        return "dq", _dq(q, k, v, do, lse, torch.zeros_like(di), _causal(L))
    if name == "dq without the diagonal 64-key tile":
        same_tile = (i[None, :] // 64) == (i[:, None] // 64)
        return "dq", _dq(q, k, v, do, lse, di, _causal(L) & ~same_tile)
    if name == "dq with one key past the diagonal":
        return "dq", _dq(q, k, v, do, lse, di, _causal(L, 1))
    if name == "dq without the diagonal key":
        return "dq", _dq(q, k, v, do, lse, di, _causal(L, -1))
    if name == "di scaled by 1.001":
        return "di", case["di"] * 1.001
    raise KeyError(name)


@pytest.mark.parametrize("fault", [
    "dq scaled by 1.01", "dq with di = 0",
    "dq without the diagonal 64-key tile",
    "dq with one key past the diagonal", "dq without the diagonal key",
    "di scaled by 1.001"])
def test_planted_fault_fails(case, fault):
    name, got = _fault(fault, case)
    e = chip_smoke.flash_errors(name, got, case[name])
    assert not e["ok"], (fault, e)


@pytest.mark.parametrize("kernel,bound_ms,bound_by", [
    ("flash_fwd", 0.1006, "bytes"), ("flash_bwd_di", 0.1009, "bytes"),
    ("flash_bwd_dkv", 0.1739, "operations"),
    ("flash_bwd_dq", 0.1304, "operations")])
def test_bounds_at_the_flagship_shape(kernel, bound_ms, bound_by):
    b = chip_smoke.flash_bounds((16, 20, 1024, 128))[kernel]
    assert round(b["bound_ms"], 4) == bound_ms
    assert b["bound_by"] == bound_by


@pytest.mark.parametrize("kernel,products", [
    ("flash_fwd", 2), ("flash_bwd_di", 2), ("flash_bwd_dkv", 4),
    ("flash_bwd_dq", 3)])
def test_flop_count_the_unmasked_pairs(kernel, products):
    B, H, L, D = SHAPE
    pairs = torch.ones(L, L, dtype=torch.float64).tril().sum().item()
    flop = chip_smoke.flash_bounds(SHAPE)[kernel]["flop"]
    assert flop == B * H * pairs * 2 * D * products


def test_ptxas_names_the_di_and_dq_template():
    log = """\
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__fb0f697d_18_flash_attention_cu_2e0c969c18flash_bwd_q_kernelILb1EEEv14CUtensorMap_stS1_S1_S1_PKfPfP13__nv_bfloat16iff' for 'sm_90a'
ptxas info    : Used 168 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__fb0f697d_18_flash_attention_cu_2e0c969c18flash_bwd_q_kernelILb0EEEv14CUtensorMap_stS1_S1_S1_PKfPfP13__nv_bfloat16iff' for 'sm_90a'
ptxas info    : Used 168 registers, used 1 barriers
"""
    st = chip_smoke.ptxas_stats(log)
    assert sorted(st) == ["flash_bwd_q_kernel<Lb0>", "flash_bwd_q_kernel<Lb1>"]
    assert all(s["registers"] == 168 and s["spill_stores"] == 0
               for s in st.values())
