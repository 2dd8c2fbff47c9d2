"""The model FLOPs and bytes of bench_port/work.py against counts by hand."""

import pytest

from bench_port import work

SCALED, WIDE = (2, 20, 20, 20, 1), (2, 256, 256, 256, 1)


def test_step_flops_of_the_main_path_by_hand():
    # 3 streams (u, ux, uy) x 16,384 points x (2*20 + 20*20 + 20*20 + 20*1) multiply-adds x 2 FLOPs,
    # and twice that for the backward: 253.6 MFLOP a network-step
    forward = 2 * 3 * 16384 * (40 + 400 + 400 + 20)
    assert forward == 84_541_440
    assert work.step_flops(SCALED, 16384, 2, False) == 3 * forward
    assert work.step_flops(SCALED, 16384, 2, False) / 1e6 == pytest.approx(253.6, abs=0.05)


def test_step_flops_of_the_wide_point_by_hand():
    # (2*256 + 2 * 256*256 + 256) multiply-adds: 38.9 GFLOP a member-step
    assert work.step_flops(WIDE, 16384, 2, False) == 3 * 2 * 3 * 16384 * (512 + 2 * 65536 + 256)
    assert work.step_flops(WIDE, 16384, 2, False) / 1e9 == pytest.approx(38.88, abs=0.01)


def test_bytes_are_each_input_and_output_once():
    n_params = 2 * 20 + 20 + 2 * (20 * 20 + 20) + 20 + 1
    assert work.n_params(SCALED) == n_params == 921
    _, fwd_bytes = work.fields_fwd(SCALED, 1000, 2, False)
    assert fwd_bytes == 4 * (1000 * 2 + n_params + 1000 * 3)
    bwd_flops, bwd_bytes = work.fields_bwd(SCALED, 1000, 2, False)
    assert bwd_flops == 2 * work.fields_fwd(SCALED, 1000, 2, False)[0]
    assert bwd_bytes == 4 * (1000 * 2 + 1000 * 3 + 2 * n_params)
    assert work.streams(3, True) == 7 and work.streams(2, False) == 3


def test_the_bound_is_the_larger_of_compute_and_bandwidth():
    assert work.bound_s(67e12, 0) == pytest.approx(1.0)
    assert work.bound_s(0, 3.35e12) == pytest.approx(1.0)
    flops, moved = work.fields_fwd(SCALED, 16384, 2, False)
    assert work.bound_s(flops, moved) == pytest.approx(flops / 67e12)  # the main path's B1 is bound by FLOPs
