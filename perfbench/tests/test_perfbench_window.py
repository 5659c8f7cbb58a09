"""The timed window: a closed loop back to back, an open loop at its arrivals."""
import io
import time

from perfbench import harness


def test_closed_loop_calls_back_to_back_until_the_window_closes():
    calls = []
    results, latencies, failures, window_s = harness.window(
        lambda: calls.append(time.perf_counter()) or len(calls), 0.05, lambda: None)
    assert results == list(range(1, len(calls) + 1)) and failures == 0
    assert len(latencies) == len(calls) and window_s >= 0.05


def test_open_loop_keeps_its_arrivals_and_counts_the_wait():
    """A call that takes longer than the gap between arrivals delays the
    next, and the delay is part of the next call's latency."""
    starts = []

    def slow():
        starts.append(time.perf_counter())
        time.sleep(0.03 if len(starts) == 1 else 0.0)

    results, latencies, failures, window_s = harness.window(slow, 0.1, lambda: None,
                                                            arrivals_per_s=50)
    assert failures == 0 and len(results) == len(latencies)
    assert 2 <= len(latencies) <= 7  # arrivals 20 ms apart over 0.1 s
    assert latencies[1] >= 0.01  # arrived at 20 ms, started at 30 ms
    # No call starts before its arrival (load only makes calls later).
    assert all(t - starts[0] >= i * 0.02 - 0.002 for i, t in enumerate(starts))


def test_a_call_that_raises_is_counted_and_the_window_goes_on():
    def bad():
        raise RuntimeError("planted fault")

    results, latencies, failures, _ = harness.window(bad, 0.02, lambda: None,
                                                     log=io.StringIO())
    assert results == [] and failures == len(latencies) >= 1
