"""When ``curvine_tpu_torch.gpu._build`` builds a library again: the rule
in ``is_stale``, on temporary files with set modification times (no
compiler is needed)."""

import os

import pytest

from curvine_tpu_torch.gpu import _build


def _touch(path, mtime):
    with open(path, "a"):
        pass
    os.utime(path, (mtime, mtime))


@pytest.fixture
def tree(tmp_path):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    return csrc, tmp_path / "lib.so"


def test_missing_library_is_stale(tree):
    csrc, so = tree
    _touch(csrc / "k.cu", 100)
    assert _build.is_stale(str(so), str(csrc / "k.cu"), str(csrc))


@pytest.mark.parametrize("src_t,so_t,stale", [
    (100, 200, False), (200, 200, False), (300, 200, True)])
def test_library_against_its_source(tree, src_t, so_t, stale):
    csrc, so = tree
    _touch(csrc / "k.cu", src_t)
    _touch(so, so_t)
    assert _build.is_stale(str(so), str(csrc / "k.cu"), str(csrc)) is stale


def test_newer_header_makes_every_cu_stale(tree):
    csrc, so = tree
    _touch(csrc / "k.cu", 100)
    _touch(csrc / "old.cuh", 150)
    _touch(so, 200)
    assert not _build.is_stale(str(so), str(csrc / "k.cu"), str(csrc))
    _touch(csrc / "new.cuh", 250)
    assert _build.is_stale(str(so), str(csrc / "k.cu"), str(csrc))
    # an older library of another .cu source than the header names
    _touch(csrc / "other.cu", 50)
    assert _build.is_stale(str(so), str(csrc / "other.cu"), str(csrc))


def test_headers_do_not_touch_host_sources(tree):
    csrc, so = tree
    _touch(csrc / "h.cc", 100)
    _touch(csrc / "new.cuh", 300)
    _touch(so, 200)
    assert not _build.is_stale(str(so), str(csrc / "h.cc"), str(csrc))


def test_other_files_are_not_headers(tree):
    csrc, so = tree
    _touch(csrc / "k.cu", 100)
    _touch(csrc / "notes.txt", 300)
    _touch(csrc / "x.cuh.bak", 300)
    _touch(so, 200)
    assert not _build.is_stale(str(so), str(csrc / "k.cu"), str(csrc))


def test_repo_sources_and_headers():
    """The kernels' shared header is under csrc/ and is not a source of
    its own."""
    assert "hopper.cuh" in os.listdir(_build.CSRC)
    assert "hopper" not in _build.sources()
    assert "flash_attention" in _build.sources()


def test_ptxas_stats_per_kernel():
    """chip_smoke.py's reading of ``ptxas -v``: one entry a kernel, named
    out of its mangled name, with registers, spills, stack and static
    shared memory."""
    import chip_smoke
    log = """\
ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__9db79091_11_checksum_cu_eadd5ad715checksum_kernelEPKhmmiPj' for 'sm_90a'
ptxas info    : Function properties for _ZN44_GLOBAL__N__9db79091_11_checksum_cu_eadd5ad715checksum_kernelEPKhmmiPj
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 28 registers, used 1 barriers, 64 bytes smem, 380 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__fb0f697d_18_flash_attention_cu_2e0c969c20flash_bwd_dkv_kernelE14CUtensorMap_stS0_S0_S0_PKfS2_P13__nv_bfloat16S4_iff' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__fb0f697d_18_flash_attention_cu_2e0c969c20flash_bwd_dkv_kernelE14CUtensorMap_stS0_S0_S0_PKfS2_P13__nv_bfloat16S4_iff
    304 bytes stack frame, 292 bytes spill stores, 296 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 304 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN43_GLOBAL__N__671072fd_10_pq_scan_cu_c9a8b6e414pq_scan_kernelILb1EEEvPKfPKiPfixiii' for 'sm_90a'
ptxas info    : Used 32 registers
ptxas info    : Compiling entry function '_ZN38_GLOBAL__N__8d4e0a38e6_6_ovp_cu_2e0c969c16flash_fwd_kernelE14CUtensorMap_stS0_S0_P13__nv_bfloat16Pfif' for 'sm_90a'
ptxas info    : Used 168 registers
"""
    st = chip_smoke.ptxas_stats(log)
    assert st == {
        "checksum_kernel": {"registers": 28, "stack": 0, "spill_stores": 0,
                            "spill_loads": 0, "smem": 64},
        "flash_bwd_dkv_kernel": {"registers": 168, "stack": 304,
                                 "spill_stores": 292, "spill_loads": 296,
                                 "smem": 0},
        "pq_scan_kernel<Lb1>": {"registers": 32, "stack": 0,
                                "spill_stores": 0, "spill_loads": 0,
                                "smem": 0},
        # "38e6_6_ovp_cu_..._kernel" in the namespace hash parses too
        "flash_fwd_kernel": {"registers": 168, "stack": 0,
                             "spill_stores": 0, "spill_loads": 0,
                             "smem": 0}}
