"""The least bytes of one full sweep, worked by hand."""
import pytest

from perfbench import roofline


def test_path_with_an_isolated_node():
    # Path 0-1-2 and node 3 alone: 4 neighbour slots, 3 nodes with a
    # neighbour, starts at most 2 (int16): 4*4 + 3*(2 + 4 + 2) = 40 bytes.
    assert roofline.full_sweep_bytes(4, 3, 2) == 40


def test_int32_estimates_past_int16():
    assert roofline.estimate_bytes((1 << 15) - 1) == 2
    assert roofline.estimate_bytes(1 << 15) == 4
    assert roofline.full_sweep_bytes(4, 3, 1 << 15) == 16 + 3 * 12


def test_share_is_least_time_over_kernel_time():
    least = int(roofline.HBM_BYTES_PER_S)  # one second at the peak
    assert roofline.share_percent(least, 2.0) == pytest.approx(50.0)
