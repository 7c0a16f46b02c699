"""The port's kernel build helpers and launch rules that run without a card:
the ``ptxas -v`` log reader behind chip_smoke.py's per-kernel register,
spill and shared-memory lines, the explicit rules that pick the bf16 flash
forward's and backward's wgmma kernels (head-batched and masked) and their
tiles, and the layout probe's shape guard."""

import pytest
import torch

from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import flash_attention as fa

LOG = """== flash_attention.cu
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119hb_fwd_wgmma_kernelILi128EEEv14CUtensorMap_stS1_S1_NS_4ArgsEi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_119hb_fwd_wgmma_kernelILi128EEEv14CUtensorMap_stS1_S1_NS_4ArgsEi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 167 registers, used 1 barriers, 128 bytes smem, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_113hb_dkv_kernelIfLi128EEEvNS_4ArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_113hb_dkv_kernelIfLi128EEEvNS_4ArgsE
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 64 registers, 400 bytes cmem[0]
"""


def test_ptxas_report_reads_each_kernel():
    rep = _build.ptxas_report(LOG)
    fwd = rep["_ZN12_GLOBAL__N_119hb_fwd_wgmma_kernelILi128EEEv14CUtensorMap"
              "_stS1_S1_NS_4ArgsEi"]
    assert fwd == {"registers": 167, "stack": 0, "spill_stores": 0,
                   "spill_loads": 0, "smem": 128}
    dkv = rep["_ZN12_GLOBAL__N_113hb_dkv_kernelIfLi128EEEvNS_4ArgsE"]
    assert dkv == {"registers": 64, "stack": 8, "spill_stores": 4,
                   "spill_loads": 4, "smem": 0}
    assert len(rep) == 2


@pytest.mark.parametrize("d", fa.SUPPORTED_HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fwd_route_is_a_rule_on_head_dim_and_dtype(d, dtype):
    want = "wgmma" if dtype == torch.bfloat16 and d in (64, 128) else "smem"
    assert fa.fwd_route(d, dtype) == want


@pytest.mark.parametrize("rep", range(1, fa.MAX_REP + 1))
def test_wgmma_fwd_tiles_fill_at_most_128_rows(rep):
    bq, bk = fa.wgmma_fwd_tiles(rep)
    assert bk == 64 and rep * bq <= 128 and rep * (bq + 1) > 128


@pytest.mark.parametrize("d", fa.SUPPORTED_HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bwd_route_is_a_rule_on_head_dim_and_dtype(d, dtype):
    want = "wgmma" if dtype == torch.bfloat16 and d in (64, 128) else "smem"
    assert fa.bwd_route(d, dtype) == want


@pytest.mark.parametrize("rep", range(1, fa.MAX_REP + 1))
def test_wgmma_bwd_tiles_fill_at_most_64_and_128_rows(rep):
    """dk/dv: q tiles of at most 64 rows against 128 keys; dq: at most 128
    rows against 64 keys; each as many whole positions as fit."""
    (bq_kv, bk_kv), (bq_q, bk_q) = fa.wgmma_bwd_tiles(rep)
    assert (bk_kv, bk_q) == (128, 64)
    assert rep * bq_kv <= 64 < rep * (bq_kv + 1)
    assert rep * bq_q <= 128 < rep * (bq_q + 1)


@pytest.mark.parametrize("d", fa.SUPPORTED_HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_masked_fwd_route_is_a_rule_on_head_dim_and_dtype(d, dtype):
    want = "wgmma" if dtype == torch.bfloat16 and d in (64, 128) else "smem"
    assert fa.masked_fwd_route(d, dtype) == want


@pytest.mark.parametrize("rep", range(1, 17))
def test_masked_fwd_wgmma_tiles_fill_at_most_128_rows(rep):
    """hpc divides rep and is its largest divisor up to 8 (the TMA box's
    head extent); the CTA's 128 rows hold hpc heads at as many whole
    positions as fit, against 64-key tiles."""
    hpc, bq, bk = fa.masked_fwd_wgmma_tiles(rep)
    assert rep % hpc == 0 and hpc <= 8
    assert not any(rep % c == 0 for c in range(hpc + 1, min(rep, 8) + 1))
    assert bk == 64 and hpc * bq <= 128 < hpc * (bq + 1)


@pytest.mark.parametrize("d", fa.SUPPORTED_HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_masked_bwd_route_is_a_rule_on_head_dim_and_dtype(d, dtype):
    """B6's kernels by the forward's rule, whatever the fused/split route."""
    want = "wgmma" if dtype == torch.bfloat16 and d in (64, 128) else "smem"
    assert fa.masked_bwd_route(d, dtype) == want


@pytest.mark.parametrize("rep", range(1, 17))
def test_masked_bwd_wgmma_tiles_fill_at_most_64_and_128_rows(rep):
    """One hpc for both kernels, the largest divisor of rep up to 8; dk/dv:
    ringed q tiles of at most 64 rows against 128 keys; dq: at most 128
    rows against ringed k tiles of 64 keys; each as many whole positions as
    fit."""
    (hpc, bq_kv, bk_kv), (hpc_q, bq_q, bk_q) = fa.masked_bwd_wgmma_tiles(rep)
    assert hpc == hpc_q and rep % hpc == 0 and hpc <= 8
    assert not any(rep % c == 0 for c in range(hpc + 1, min(rep, 8) + 1))
    assert (bk_kv, bk_q) == (128, 64)
    assert hpc * bq_kv <= 64 < hpc * (bq_kv + 1)
    assert hpc * bq_q <= 128 < hpc * (bq_q + 1)
    # the dq kernel's tiles are the wgmma forward's
    assert (hpc, bq_q, bk_q) == fa.masked_fwd_wgmma_tiles(rep)


@pytest.mark.parametrize("mode", sorted(_build.PROBE_B_SHAPES))
def test_wgmma_probe_refuses_other_shapes(mode):
    """The probe checks its operands' shapes before it builds or launches
    anything (so this runs without a card)."""
    a = torch.zeros(64, 64, dtype=torch.bfloat16)
    rows, cols = _build.PROBE_B_SHAPES[mode]
    with pytest.raises(ValueError, match=f"mode {mode}"):
        _build.wgmma_probe(mode, a, torch.zeros(rows, cols + 8,
                                                dtype=torch.bfloat16))
    with pytest.raises(ValueError, match=f"mode {mode}"):
        _build.wgmma_probe(mode, a[:32], torch.zeros(rows, cols,
                                                     dtype=torch.bfloat16))


def test_wgmma_kernels_named_in_the_sources():
    text = "".join(p.read_text() for p in _build.SOURCES)
    for name in _build.WGMMA_KERNELS:
        assert f" {name}(" in text, name
    assert _build.CSRC / "hopper.cuh" in _build.HEADERS
