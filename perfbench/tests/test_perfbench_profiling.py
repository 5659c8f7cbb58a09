"""Reading a trace: busy time as a union, idle gaps named by the host."""
import pytest

from perfbench import profiling
from perfbench.profiling import DeviceEvent


def test_union_merges_overlaps():
    assert profiling.union([(5, 7), (0, 2), (1, 3), (7, 8)]) == [(0, 3), (5, 8)]


def test_gaps_within_window():
    busy = [(2, 4), (6, 7)]
    assert profiling.gaps(busy, 0, 10) == [(0, 2), (4, 6), (7, 10)]


def test_summarize_counts_overlap_once_and_splits_kinds():
    events = [
        DeviceEvent("kernelA", 1_000_000_000, 2_000_000_000),
        DeviceEvent("kernelB", 1_500_000_000, 2_500_000_000),  # overlaps A
        DeviceEvent("Memcpy HtoD (Pageable -> Device)", 3_000_000_000, 4_000_000_000),
        DeviceEvent("Memset (Device)", 4_000_000_000, 4_100_000_000),
        DeviceEvent("kernelC", 9_000_000_000, 11_000_000_000),  # half outside
    ]
    t = profiling.summarize(events, 0, 10_000_000_000,
                            [3_500_000_000, 5_000_000_000, 6_000_000_000],
                            ["copy", "host.a", "host.a"])
    assert t.window_s == pytest.approx(10.0)
    assert t.busy_s == pytest.approx(1.5 + 1.1 + 1.0)
    assert t.kernel_s == pytest.approx(1.0 + 1.0 + 2.0)
    assert t.upload_s == pytest.approx(1.0)
    gaps = dict(t.idle_gaps)
    assert gaps["host.a"] == pytest.approx(4.9)
    assert gaps[profiling.SHORT_GAPS] == pytest.approx(1.0 + 0.5)
    assert t.device_ops[0] == ("kernelC", pytest.approx(2.0))


def test_frame_name_prefers_the_program():
    import sys

    def inner():
        return profiling.frame_name(sys._getframe())

    # Called from a test module: neither the port nor the harness is on
    # the stack, so the innermost frame names itself.
    assert inner().endswith(":inner")


def test_short_names_are_cut():
    long = "void kcore::row_per_warp<32, " + "x" * 300
    assert len(profiling.short_name(long)) == profiling.NAME_CHARS
    assert profiling.short_name("Memcpy HtoD (Pageable -> Device)").startswith("Memcpy HtoD")


def test_host_sampler_samples_and_stops():
    import time

    with profiling.HostSampler(interval_s=0.001) as sampler:
        end = time.perf_counter() + 10
        while len(sampler.times_ns) < 3 and time.perf_counter() < end:
            time.sleep(0.001)
    assert len(sampler.times_ns) >= 3
    assert sampler.times_ns == sorted(sampler.times_ns)
    assert len(sampler.names) == len(sampler.times_ns)
    assert not sampler._thread.is_alive()
