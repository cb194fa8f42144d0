"""The trace summary of ``multigrid_parallel_tpu_torch.utils.split_trace``
on hand-made kernel intervals (the profiler itself needs a card): busy
time as the union of intervals, the span, per-name sums and counts, and
the device idle just before each kernel name, and each smoothing
stage's calls by level."""

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


def test_stage_calls_group_each_form_by_level():
    """A K2 call of the first form is its from-zero kernel and the K1
    half-sweeps after it, a K4 call its correction kernel and its three;
    half-sweeps that follow neither (another kernel between) head K1 calls;
    a one-pass call is its one kernel; the level from the (name, grid,
    shared memory) map, the grid alone where the trace has no shared
    memory."""
    from multigrid_parallel_tpu_torch.hierarchy import Hierarchy
    from multigrid_parallel_tpu_torch.ops import pallas_split as tps

    sizes = st._stage_sizes(Hierarchy(ndim=3, coarse_n=5, num_levels=5), 132)
    g = {n: (-(-n ** 3 // 256), 1, 1, 0) for n in (9, 65)}
    half = [(10 * i, 10 * i + 2, "rb_half_sweep_kernel", g[65]) for i in range(1, 8)]
    plan = tps._stage_plan(9, 2, 132, prolong=True, rect=True)
    intervals = ([(0, 5, "rb_half_sweep_from_zero_kernel", g[65])] + half[:3]
                 + [(35, 39, "prolong_correct_black_kernel", g[9])] + half[3:6]
                 + [(64, 65, "residual_restrict_kernel", ())] + half[6:]
                 + [(90, 93, "rect_prolong_stage_kernel", (plan.blocks, 1, 1, plan.smem)),
                    (95, 96, "rect_prolong_stage_kernel", (plan.blocks, 1, 1))])
    got = st.stage_calls(sorted(intervals), sizes)
    assert got == {"K1 n=65": [1, pytest.approx(0.002), pytest.approx(0.002)],
                   "K2 n=65": [1, pytest.approx(0.011), pytest.approx(0.011)],
                   "K4 n=9": [3, pytest.approx(0.014), pytest.approx(0.003)]}


def test_stage_calls_tell_the_one_pass_stages_apart():
    """rect_stage_kernel is K1 or K2 by its ZERO argument, split_stage_kernel
    K7 or K8; K8's first form is its from-zero half-sweep and the three
    split half-sweeps after it; a kernel name keeps its template arguments,
    demangled or mangled."""
    from multigrid_parallel_tpu_torch.hierarchy import Hierarchy
    from multigrid_parallel_tpu_torch.ops import pallas_split as tps

    assert st.short_name("void (anonymous namespace)::rect_stage_kernel<2, true, false>"
                         "(mg::rect::StageArgs)") == "rect_stage_kernel<2, true, false>"
    assert (st.short_name("_ZN12_GLOBAL__N_118split_stage_kernelILi2ELb1ELb1EEEvN2mg5split9Stage"
                          "ArgsE") == "split_stage_kernel<2, true, true>")
    assert (st.short_name("void <unnamed>::rect_stage_kernel<(int)1, (bool)0, (bool)1>(mg::rect::"
                          "StageArgs)") == "rect_stage_kernel<1, false, true>")
    assert st.short_name("void mg_residual_restrict_kernel(float*)") == "mg_residual_restrict_kernel"
    sizes = st._stage_sizes(Hierarchy(ndim=3, coarse_n=5, num_levels=5), 132)
    rect = tps._stage_plan(65, 2, 132, rect=True)
    split = tps._stage_plan(65, 2, 132)
    r, s = (rect.blocks, 1, 1, rect.smem), (split.blocks, 1, 1, split.smem)
    slot = (-(-65 * 65 * 32 // 256), 1, 1, 0)
    intervals = [(0, 3, "rect_stage_kernel<2, false, true>", r),
                 (5, 7, "rect_stage_kernel<2, true, true>", r),
                 (10, 14, "split_stage_kernel<2, true, true>", s),
                 (20, 25, "split_stage_kernel<2, true, false>", s),
                 (30, 36, "split_prolong_stage_kernel<2, true>", (split.blocks, 1, 1)),
                 (40, 41, "split_half_sweep_from_zero_kernel", slot)]
    intervals += [(50 + 10 * i, 52 + 10 * i, "split_half_sweep_kernel", slot) for i in range(3)]
    got = st.stage_calls(intervals, sizes)
    assert got == {"K1 n=65": [1, pytest.approx(0.003), pytest.approx(0.003)],
                   "K2 n=65": [1, pytest.approx(0.002), pytest.approx(0.002)],
                   "K8 n=65": [2, pytest.approx(0.011), pytest.approx(0.0055)],
                   "K7 n=65": [1, pytest.approx(0.005), pytest.approx(0.005)],
                   "K10 n=65": [1, pytest.approx(0.006), pytest.approx(0.006)]}
