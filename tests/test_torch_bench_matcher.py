"""The matcher benchmark's bookkeeping and the kernel source's route, on the
CPU. The timings themselves need the card (chip_smoke.py,
colmap_tpu_torch/bench_matcher.py)."""

import os

import pytest
import torch

from colmap_tpu_torch import bench_matcher as bm
from colmap_tpu_torch import cuda_build


@pytest.mark.parametrize("B,n,ms,by", [(8, 8192, 0.069449, "operations"),
                                       (190, 1024, 0.025772, "operations"),
                                       (32, 2048, 0.017362, "operations"),
                                       (1, 64, 0.0000056167, "bytes")])
def test_bound_is_the_larger_of_bytes_and_operations(B, n, ms, by):
    bound, bound_by = bm.bound_ms(B, n, n)
    assert bound_by == by
    assert bound == pytest.approx(ms, rel=1e-3)
    t_ops = 2 * 128 * B * n * n / bm.INT8_OPS_PER_S * 1e3
    t_bytes = bm.matcher_bytes(B, n, n) / bm.HBM_BYTES_PER_S * 1e3
    assert bound == max(t_ops, t_bytes)


def test_partials_are_the_two_pass_reverse_buffer():
    # (B, N/64, M) (best, row) pairs of 4 + 4 bytes, written and read back
    assert bm.partial_bytes(8, 8192, 8192) == 2 * 8 * 128 * 8192 * 8


def test_kernel_source_uses_tensor_cores_not_dp4a():
    with open(os.path.join(cuda_build.CSRC, "matcher_top2.cu")) as f:
        src = f.read()
    assert "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32" in src
    assert "ldmatrix.sync.aligned" in src and "cp.async" in src
    assert "__dp4a" not in src


def test_bench_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal where there is no card")
    with pytest.raises(SystemExit, match="CUDA"):
        bm.main(["--out", os.devnull])


def test_sass_loop_counts_take_the_widest_backward_branch():
    sass = """
        Function : other_kernel
        /*0000*/                   FADD R1, R2, R3 ;
        Function : _ZN_matcher_sweep_kernelEv
        /*0000*/                   MOV R1, R2 ;
        /*0010*/                   FMNMX R1, R1, R2, !PT ;
        /*0020*/              @P0 SEL R3, R4, R3, P1 ;
        /*0030*/                   IMMA.16832.S8.S8 R8, R4.ROW, R6.COL, R8 ;
        /*0040*/              @P1 BRA 0x20 ;
        /*0050*/              @!P2 BRA 0x10 ;
        /*0060*/                   EXIT ;
    """
    counts = bm.sass_loop_counts(sass)
    assert counts == {"FMNMX": 1, "SEL": 1, "IMMA": 1, "BRA": 2}
