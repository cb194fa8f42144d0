"""The trace summary of ``multigrid_parallel_tpu_torch.utils.split_trace``
on hand-made kernel intervals (the profiler itself needs a card): busy
time as the union of intervals, the span, per-name sums and counts, and
the device idle just before each kernel name."""

import pytest

from multigrid_parallel_tpu_torch.utils import split_trace as st


def test_summary_and_idle_before():
    # (start us, end us, name), sorted by start: a and b overlap, gaps of
    # 10 us before the second a and 5 us before c
    intervals = [(0, 10, "a"), (5, 20, "b"), (30, 40, "a"), (45, 50, "c")]
    busy, count, by_name, span = st._summary(intervals)
    assert (busy, count, span) == (pytest.approx(0.035), 4, pytest.approx(0.05))
    assert by_name == {"a": (pytest.approx(0.02), 2), "b": (pytest.approx(0.015), 1),
                       "c": (pytest.approx(0.005), 1)}
    assert st.idle_before(intervals) == {"a": pytest.approx(0.01), "c": pytest.approx(0.005)}


def test_summary_of_an_empty_trace():
    assert st._summary([]) == (None, 0, {}, None)
    assert st.idle_before([]) == {}
