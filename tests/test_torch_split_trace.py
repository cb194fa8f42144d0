"""The trace summary of ``multigrid_parallel_tpu_torch.utils.split_trace``
on hand-made kernel intervals (the profiler itself needs a card): busy
time as the union of intervals, the span, per-name sums and counts, and
the device idle just before each kernel name, and each smoothing
stage's calls by level (the one-pass forms and the first forms, the
msplit tier's K21, K22 and K24 among them)."""

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


def test_stage_calls_group_the_fold_stages():
    """The electrospray fold cycle's stages: a first-form K17 call is its
    from-zero half-sweep, the three half-sweeps after it and the BC pass,
    K19's its correction kernel, three half-sweeps and the BC pass, K16's
    four half-sweeps and the BC pass; the one-pass K17 (fold_stage_kernel
    with ZERO true) and K19 one kernel a call, by level from their plans."""
    from multigrid_parallel_tpu_torch.hierarchy import Hierarchy
    from multigrid_parallel_tpu_torch.ops import pallas_split as tps

    sizes = st._stage_sizes(Hierarchy(ndim=3, coarse_n=5, num_levels=5), 132)
    g = (-(-65 * 65 * 63 // 256), 1, 1, 0)
    half = [(10 * i, 10 * i + 2, "mixed_fold_half_sweep_kernel<false>", g) for i in range(1, 12)]
    bc = [(10 * i + 5, 10 * i + 6, "mixed_fold_bc_pass_kernel", (1, 1, 1, 0)) for i in (3, 7, 11)]
    k17, k19 = tps._stage_plan(33, 2, 132, rect=True), tps._stage_plan(33, 2, 132, True, True)
    intervals = sorted([(0, 4, "mixed_fold_half_sweep_kernel<true>", g)] + half[:3] + [bc[0]]
                       + half[3:7] + [bc[1]]
                       + [(78, 79, "mixed_fold_prolong_correct_black_kernel", g)]
                       + half[7:10] + [bc[2]]
                       + [(200, 203, "fold_stage_kernel<2, true, true>",
                           (k17.blocks, 1, 1, k17.smem)),
                          (210, 215, "fold_prolong_stage_kernel<2, true>",
                           (k19.blocks, 1, 1, k19.smem))])
    got = st.stage_calls(intervals, sizes)
    assert got == {"K17 n=65": [1, pytest.approx(0.011), pytest.approx(0.011)],
                   "K16 n=65": [1, pytest.approx(0.009), pytest.approx(0.009)],
                   "K19 n=65": [1, pytest.approx(0.008), pytest.approx(0.008)],
                   "K17 n=33": [1, pytest.approx(0.003), pytest.approx(0.003)],
                   "K19 n=33": [1, pytest.approx(0.005), pytest.approx(0.005)]}


def test_stage_calls_group_the_full_tier_stages():
    """The electrospray full tier's stages: a first-form K14 call is K2's
    from-zero kernel, the three mixed half-sweeps after it and the BC pass,
    K15's its correction kernel, three half-sweeps and the BC pass, K13's
    four half-sweeps and the BC pass (a K2 call of the first form, with the
    rect half-sweeps, stays K2); the one-pass K14 (mixed_stage_kernel with
    ZERO true) and K15 one kernel a call, by level from their plans."""
    from multigrid_parallel_tpu_torch.hierarchy import Hierarchy
    from multigrid_parallel_tpu_torch.ops import pallas_split as tps

    sizes = st._stage_sizes(Hierarchy(ndim=3, coarse_n=5, num_levels=5), 132)
    g = (-(-65 ** 3 // 256), 1, 1, 0)
    half = [(10 * i, 10 * i + 2, "mixed_half_sweep_kernel", g) for i in range(1, 11)]
    bc = [(10 * i + 5, 10 * i + 6, "mixed_bc_pass_kernel", (1, 1, 1, 0)) for i in (3, 7, 10)]
    rect = [(300 + 10 * i, 302 + 10 * i, "rb_half_sweep_kernel", g) for i in range(1, 4)]
    k14, k15 = tps._stage_plan(33, 2, 132, rect=True), tps._stage_plan(33, 2, 132, True, True)
    intervals = sorted([(0, 4, "rb_half_sweep_from_zero_kernel", g)] + half[:3] + [bc[0]]
                       + half[3:7] + [bc[1]]
                       + [(78, 79, "mixed_prolong_correct_black_kernel", g)]
                       + half[7:10] + [bc[2]]
                       + [(200, 203, "mixed_stage_kernel<2, true, true>",
                           (k14.blocks, 1, 1, k14.smem)),
                          (210, 215, "mixed_prolong_stage_kernel<2, true>",
                           (k15.blocks, 1, 1, k15.smem)),
                          (300, 301, "rb_half_sweep_from_zero_kernel", g)] + rect)
    got = st.stage_calls(intervals, sizes)
    assert got == {"K14 n=65": [1, pytest.approx(0.011), pytest.approx(0.011)],
                   "K13 n=65": [1, pytest.approx(0.009), pytest.approx(0.009)],
                   "K15 n=65": [1, pytest.approx(0.008), pytest.approx(0.008)],
                   "K14 n=33": [1, pytest.approx(0.003), pytest.approx(0.003)],
                   "K15 n=33": [1, pytest.approx(0.005), pytest.approx(0.005)],
                   "K2 n=65": [1, pytest.approx(0.007), pytest.approx(0.007)]}


def test_stage_calls_group_the_msplit_stages():
    """The electrospray split tier's finest-level stages: a first-form K22
    call is its from-zero half-sweep, the three half-sweeps after it and
    the BC pass, K24's its red correction (no half-sweep), the black
    correction's half-sweep, three half-sweeps and the BC pass, K21's four
    half-sweeps and the BC pass; the one-pass K22 (msplit_stage_kernel
    with ZERO true) and K24 one kernel a call, by level from their plans,
    and at n_smooth 2 a loaded msplit stage launch after them a K21 call
    of its own (K21's one-pass stage); the names demangled or mangled."""
    from multigrid_parallel_tpu_torch.hierarchy import Hierarchy
    from multigrid_parallel_tpu_torch.ops import pallas_split as tps

    assert (st.short_name("_ZN12_GLOBAL__N_119msplit_stage_kernelILi2ELb1ELb1EEEvN2mg5split9Stage"
                          "ArgsE") == "msplit_stage_kernel<2, true, true>")
    assert (st.short_name("void (anonymous namespace)::msplit_prolong_stage_kernel<1, false>(mg::"
                          "split::StageArgs, (anonymous namespace)::MsplitProlongPrep)")
            == "msplit_prolong_stage_kernel<1, false>")
    sizes = st._stage_sizes(Hierarchy(ndim=3, coarse_n=5, num_levels=5), 132)
    g = (-(-65 * 65 * 32 // 256), 1, 1, 0)
    half = [(10 * i, 10 * i + 2, "msplit_half_sweep_kernel", g) for i in range(1, 11)]
    bc = [(10 * i + 5, 10 * i + 6, "msplit_bc_pass_kernel", (1, 1, 1, 0)) for i in (3, 7, 10)]
    k22 = tps._stage_plan(65, 2, 132, msplit=True)
    k24 = tps._stage_plan(65, 2, 132, prolong=True, msplit=True)
    intervals = sorted([(0, 4, "msplit_half_sweep_from_zero_kernel", g)] + half[:3] + [bc[0]]
                       + half[3:7] + [bc[1]]
                       + [(76, 77, "msplit_prolong_correct_red_kernel", g),
                          (78, 79, "msplit_prolong_correct_black_kernel", g)]
                       + half[7:10] + [bc[2]]
                       + [(200, 203, "msplit_stage_kernel<2, true, true>",
                           (k22.blocks, 1, 1, k22.smem)),
                          (210, 215, "msplit_prolong_stage_kernel<2, true>",
                           (k24.blocks, 1, 1, k24.smem)),
                          (220, 222, "msplit_stage_kernel<1, true, false>",
                           (k22.blocks, 1, 1))])
    got = st.stage_calls(intervals, sizes)
    assert got == {"K22 n=65": [2, pytest.approx(0.014), pytest.approx(0.007)],
                   "K21 n=65": [2, pytest.approx(0.011), pytest.approx(0.0055)],
                   "K24 n=65": [2, pytest.approx(0.014), pytest.approx(0.007)]}


def test_stage_calls_tell_k21s_stage_from_later_launches():
    """K21 on the msplit stage: msplit_stage_kernel with ZERO false heads a
    K21 call; at n_smooth 3 a K22, K24 or K21 call takes the loaded
    stage's next launch as its second, and the launch after that heads a
    K21 call of its own; by level from the plan; a name without its
    template arguments is "K21|K22"."""
    from multigrid_parallel_tpu_torch.hierarchy import Hierarchy
    from multigrid_parallel_tpu_torch.ops import pallas_split as tps

    assert st.stage_label("msplit_stage_kernel<2, true, false>") == "K21"
    assert st.stage_label("msplit_stage_kernel<2, true, true>") == "K22"
    assert st.stage_label("msplit_stage_kernel") == "K21|K22"
    sizes = st._stage_sizes(Hierarchy(ndim=3, coarse_n=5, num_levels=5), 132)
    k22 = tps._stage_plan(65, 2, 132, msplit=True)
    k24 = tps._stage_plan(65, 2, 132, prolong=True, msplit=True)
    grid, pgrid = (k22.blocks, 1, 1, k22.smem), (k24.blocks, 1, 1, k24.smem)
    loaded = "msplit_stage_kernel<1, true, false>"
    intervals = [(0, 3, "msplit_stage_kernel<2, true, true>", grid), (3, 4, loaded, grid),
                 (10, 13, "msplit_prolong_stage_kernel<2, true>", pgrid), (13, 14, loaded, grid),
                 (20, 23, "msplit_stage_kernel<2, true, false>", grid), (23, 24, loaded, grid),
                 (30, 32, "msplit_stage_kernel<2, true, false>", grid)]
    assert st.stage_calls(intervals, sizes, n_smooth=3) == {
        "K22 n=65": [1, pytest.approx(0.004), pytest.approx(0.004)],
        "K24 n=65": [1, pytest.approx(0.004), pytest.approx(0.004)],
        "K21 n=65": [2, pytest.approx(0.006), pytest.approx(0.003)]}


def test_restrict_calls_by_level_for_both_forms():
    """K3 and K9 a kernel a call, by level: the first forms from their one
    thread a coarse point, the streaming stage from its plan's grid and
    shared memory (the grid alone where the trace has none), a mangled
    name with its template argument; other kernels are not counted."""
    from multigrid_parallel_tpu_torch.hierarchy import Hierarchy
    from multigrid_parallel_tpu_torch.ops import pallas_split as tps

    sizes = st._stage_sizes(Hierarchy(ndim=3, coarse_n=5, num_levels=5), 132)
    first = {n: (-(-((n + 1) // 2) ** 3 // 256), 1, 1, 0) for n in (33, 65)}
    k3 = tps._restrict_plan(65, 132)
    k9 = tps._restrict_plan(65, 132, split=True)
    assert (st.short_name("_ZN12_GLOBAL__N_121split_restrict_kernelILi2EEEvN2mg11restriction4Args"
                          "E") == "split_restrict_kernel<2>")
    intervals = [(0, 3, "residual_restrict_kernel", first[65]),
                 (5, 6, "residual_restrict_kernel", first[33]),
                 (10, 12, "split_residual_restrict_kernel", first[65]),
                 (20, 21, "rect_restrict_kernel<2>", (k3.blocks, 1, 1, k3.smem)),
                 (22, 24, "rect_restrict_kernel<2>", (k3.blocks, 1, 1)),
                 (30, 34, "split_restrict_kernel<1>", (k9.blocks, 1, 1, k9.smem)),
                 (40, 49, "rect_stage_kernel<2, true, true>", (1, 1, 1, 0))]
    got = st.restrict_calls(intervals, sizes)
    assert got == {"K3 n=33": [1, pytest.approx(0.001), pytest.approx(0.001)],
                   "K3 n=65": [3, pytest.approx(0.006), pytest.approx(0.002)],
                   "K9 n=65": [2, pytest.approx(0.006), pytest.approx(0.003)]}


def test_restrict_calls_map_both_forms_of_k23():
    """K23 a kernel a call, by level: the first form
    (residual_restrict_msplit_kernel) from its one thread a stored coarse
    point of the (nc, nc, nc - 2) fold, the streaming stage
    (msplit_restrict_kernel) from K9's plan's grid and shared memory, its
    name mangled or not; K9's stage on the same grid stays K9's."""
    from multigrid_parallel_tpu_torch.hierarchy import Hierarchy
    from multigrid_parallel_tpu_torch.ops import pallas_split as tps

    sizes = st._stage_sizes(Hierarchy(ndim=3, coarse_n=5, num_levels=6), 132)
    first = (-(-17 ** 2 * 15 // 256), 1, 1, 0)
    stage = tps._restrict_plan(129, 132, split=True)
    assert (st.short_name("_ZN12_GLOBAL__N_122msplit_restrict_kernelILi1EEEvN2mg11restriction4Args"
                          "E") == "msplit_restrict_kernel<1>")
    intervals = [(0, 2, "residual_restrict_msplit_kernel", first),
                 (10, 14, "msplit_restrict_kernel<1>", (stage.blocks, 1, 1, stage.smem)),
                 (20, 23, "msplit_restrict_kernel<1>", (stage.blocks, 1, 1)),
                 (30, 31, "split_restrict_kernel<1>", (stage.blocks, 1, 1, stage.smem))]
    assert st.restrict_calls(intervals, sizes) == {
        "K23 n=33": [1, pytest.approx(0.002), pytest.approx(0.002)],
        "K23 n=129": [2, pytest.approx(0.007), pytest.approx(0.0035)],
        "K9 n=129": [1, pytest.approx(0.001), pytest.approx(0.001)]}


def test_stage_calls_map_k16_on_the_fold_stage():
    """K16 on the fold stage: fold_stage_kernel with ZERO false heads a K16
    call, by level from its plan; at n_smooth 3 a fold call (K16, K17,
    K19) takes the loaded stage's next launch as its second, and the next
    loaded launch heads a K16 call of its own; the parent's first-form
    K16 (four half-sweeps and the BC pass) stays mapped."""
    from multigrid_parallel_tpu_torch.hierarchy import Hierarchy
    from multigrid_parallel_tpu_torch.ops import pallas_split as tps

    sizes = st._stage_sizes(Hierarchy(ndim=3, coarse_n=5, num_levels=5), 132)
    plans = {n: tps._stage_plan(n, 2, 132, rect=True) for n in (33, 65)}
    grid = {n: (p.blocks, 1, 1, p.smem) for n, p in plans.items()}
    k19 = tps._stage_plan(33, 2, 132, True, True)
    one = (7, 1, 1, 0)  # an n_iter 1 launch's grid: not a level of the map
    assert st.stage_label("fold_stage_kernel<2, false, true>") == "K16"
    assert st.stage_label("fold_stage_kernel<2, true, true>") == "K17"
    intervals = [(0, 3, "fold_stage_kernel<2, false, true>", grid[65]),
                 (10, 12, "fold_stage_kernel<2, false, true>", grid[33]),
                 (20, 21, "rect_restrict_kernel<1>", (1, 1, 1, 0)),
                 (30, 32, "fold_stage_kernel<2, false, true>", grid[33])]
    got = st.stage_calls(intervals, sizes)
    assert got == {"K16 n=65": [1, pytest.approx(0.003), pytest.approx(0.003)],
                   "K16 n=33": [2, pytest.approx(0.004), pytest.approx(0.002)]}
    intervals = [(0, 3, "fold_stage_kernel<2, true, true>", grid[33]),
                 (4, 5, "fold_stage_kernel<1, false, true>", one),
                 (10, 14, "fold_prolong_stage_kernel<2, true>", (k19.blocks, 1, 1, k19.smem)),
                 (15, 16, "fold_stage_kernel<1, false, true>", one),
                 (20, 22, "fold_stage_kernel<2, false, true>", grid[33]),
                 (23, 24, "fold_stage_kernel<1, false, true>", one)]
    got = st.stage_calls(intervals, sizes, n_smooth=3)
    assert got == {"K17 n=33": [1, pytest.approx(0.004), pytest.approx(0.004)],
                   "K19 n=33": [1, pytest.approx(0.005), pytest.approx(0.005)],
                   "K16 n=33": [1, pytest.approx(0.003), pytest.approx(0.003)]}
    g = (-(-65 * 65 * 63 // 256), 1, 1, 0)
    first = [(10 * i, 10 * i + 2, "mixed_fold_half_sweep_kernel<false>", g) for i in range(4)]
    first.append((45, 46, "mixed_fold_bc_pass_kernel", (1, 1, 1, 0)))
    assert st.stage_calls(first, sizes) == {
        "K16 n=65": [1, pytest.approx(0.009), pytest.approx(0.009)]}


def test_stage_calls_map_k13_and_k34_on_the_loaded_stages():
    """K13 on the full-layout mixed stage (mixed_stage_kernel with ZERO
    false) and K34 on the segment stage (mixed_seg_stage_kernel<NITER,
    ZERO, BOX> with ZERO false) head a call each, by level from their
    plans, beside K14 and K35 (ZERO true); the parent's segment kernel
    without ZERO (<NITER, BOX>) stays K35, a name without its arguments is
    either; at n_smooth 3 a K14 or K15 call takes the loaded stage's next
    launch as its second, and the next loaded launch heads a K13 call that
    takes the one after it."""
    from multigrid_parallel_tpu_torch.hierarchy import Hierarchy
    from multigrid_parallel_tpu_torch.ops import pallas_split as tps
    from multigrid_parallel_tpu_torch.parallel.sharded import ShardPlan

    assert st.stage_label("mixed_stage_kernel<2, false, true>") == "K13"
    assert st.stage_label("mixed_stage_kernel<2, true, true>") == "K14"
    assert st.stage_label("mixed_seg_stage_kernel<2, false, false>") == "K34"
    assert st.stage_label("mixed_seg_stage_kernel<2, true, true>") == "K35"
    assert st.stage_label("mixed_seg_stage_kernel<2, false>") == "K35"
    assert st.stage_label("mixed_seg_stage_kernel") == "K34|K35"
    assert (st.short_name("_ZN12_GLOBAL__N_122mixed_seg_stage_kernelILi2ELb0ELb1EEEvN2mg4rect"
                          "12SegStageArgsE") == "mixed_seg_stage_kernel<2, false, true>")
    sizes = st._stage_sizes(Hierarchy(ndim=3, coarse_n=5, num_levels=6), 132)
    grid = {n: (p.blocks, 1, 1, p.smem) for n, p in
            ((n, tps._stage_plan(n, 2, 132, rect=True)) for n in (65, 129))}
    k15 = tps._stage_plan(65, 2, 132, True, True)
    one = (7, 1, 1, 0)  # an n_iter 1 launch's grid: not a level of the map
    intervals = [(0, 3, "mixed_stage_kernel<2, false, true>", grid[129]),
                 (10, 12, "mixed_stage_kernel<2, true, true>", grid[65]),
                 (20, 21, "mixed_stage_kernel<2, false, true>", grid[65])]
    assert st.stage_calls(intervals, sizes) == {
        "K13 n=129": [1, pytest.approx(0.003), pytest.approx(0.003)],
        "K14 n=65": [1, pytest.approx(0.002), pytest.approx(0.002)],
        "K13 n=65": [1, pytest.approx(0.001), pytest.approx(0.001)]}
    intervals = [(0, 3, "mixed_stage_kernel<2, true, true>", grid[65]),
                 (4, 5, "mixed_stage_kernel<1, false, true>", one),
                 (10, 14, "mixed_prolong_stage_kernel<2, true>", (k15.blocks, 1, 1, k15.smem)),
                 (15, 16, "mixed_stage_kernel<1, false, true>", one),
                 (20, 22, "mixed_stage_kernel<2, false, true>", grid[65]),
                 (23, 24, "mixed_stage_kernel<1, false, true>", one)]
    assert st.stage_calls(intervals, sizes, n_smooth=3) == {
        "K14 n=65": [1, pytest.approx(0.004), pytest.approx(0.004)],
        "K15 n=65": [1, pytest.approx(0.005), pytest.approx(0.005)],
        "K13 n=65": [1, pytest.approx(0.003), pytest.approx(0.003)]}

    plan = ShardPlan(n_dev=1, axis="x", n_sharded=6, fine_local=320)
    seg = st._seg_sizes(Hierarchy(ndim=3, coarse_n=5, num_levels=7), 132, plan)
    k34 = {n: tps._stage_plan(n, 2, 132, rect=True, seg_planes=n) for n in (65, 129)}
    intervals = [(0, 3, "mixed_seg_stage_kernel<2, false, true>",
                  (k34[129].blocks, 1, 1, k34[129].smem)),
                 (10, 11, "mixed_seg_stage_kernel<2, true, true>",
                  (k34[65].blocks, 1, 1, k34[65].smem)),
                 (20, 22, "mixed_seg_stage_kernel<2, false, true>",
                  (k34[65].blocks, 1, 1, k34[65].smem)),
                 (30, 34, "mixed_seg_stage_kernel<2, true>",
                  (k34[129].blocks, 1, 1, k34[129].smem))]
    assert st.stage_calls(intervals, seg) == {
        "K34 n=129": [1, pytest.approx(0.003), pytest.approx(0.003)],
        "K35 n=65": [1, pytest.approx(0.001), pytest.approx(0.001)],
        "K34 n=65": [1, pytest.approx(0.002), pytest.approx(0.002)],
        "K35 n=129": [1, pytest.approx(0.004), pytest.approx(0.004)]}


def test_restrict_calls_map_both_forms_of_k18():
    """K18 a kernel a call, by level: the first form
    (residual_restrict_fold_kernel) from its one thread a stored coarse
    point of the (nc, nc, nc - 2) fold, the streaming stage
    (fold_restrict_kernel) from the fold plan's grid and shared memory."""
    from multigrid_parallel_tpu_torch.hierarchy import Hierarchy
    from multigrid_parallel_tpu_torch.ops import pallas_split as tps

    sizes = st._stage_sizes(Hierarchy(ndim=3, coarse_n=5, num_levels=6), 132)
    first = {n: (-(-((n + 1) // 2) ** 2 * ((n + 1) // 2 - 2) // 256), 1, 1, 0) for n in (17, 65)}
    stage = tps._restrict_plan(129, 132, fold=True)
    assert (st.short_name("_ZN12_GLOBAL__N_120fold_restrict_kernelILi1EEEvN2mg11restriction4Args"
                          "E") == "fold_restrict_kernel<1>")
    intervals = [(0, 2, "residual_restrict_fold_kernel", first[65]),
                 (5, 6, "residual_restrict_fold_kernel", first[17]),
                 (10, 14, "fold_restrict_kernel<1>", (stage.blocks, 1, 1, stage.smem)),
                 (20, 23, "fold_restrict_kernel<1>", (stage.blocks, 1, 1)),
                 (30, 39, "fold_stage_kernel<2, true, true>", (1, 1, 1, 0))]
    got = st.restrict_calls(intervals, sizes)
    assert got == {"K18 n=17": [1, pytest.approx(0.001), pytest.approx(0.001)],
                   "K18 n=65": [1, pytest.approx(0.002), pytest.approx(0.002)],
                   "K18 n=129": [2, pytest.approx(0.007), pytest.approx(0.0035)]}


def test_stage_and_restrict_calls_map_the_sharded_electrospray():
    """The one-rank sharded electrospray solve (plan: 6 sharded levels, L =
    320 at 257^3): K34's first form (four seg_mixed half-sweeps and the BC
    pass), K35's (K29's from-zero head, three K34 half-sweeps, the BC pass)
    and K36's (its correction head, three half-sweeps, the BC pass), each
    by level from its rows' threads (L + 6 or L + 8 planes); K35 and K36 as
    one-pass stages (mixed_seg_stage_kernel, mixed_seg_prolong_stage_kernel)
    one kernel a call, by level from their plans of min(L, n) planes; K30 a
    kernel a call from its coarse points, L / 2 planes; a K29 head followed
    by the Dirichlet half-sweeps stays K29."""
    from multigrid_parallel_tpu_torch.hierarchy import Hierarchy
    from multigrid_parallel_tpu_torch.ops import pallas_split as tps
    from multigrid_parallel_tpu_torch.parallel.sharded import ShardPlan

    hier = Hierarchy(ndim=3, coarse_n=5, num_levels=7)
    plan = ShardPlan(n_dev=1, axis="x", n_sharded=6, fine_local=320)
    sizes = st._seg_sizes(hier, 132, plan)
    assert plan.local_planes(1) == 160

    def grid(n, rows):
        return (-(-rows * n * n // 256), 1, 1, 0)

    sweep = [(10 * i, 10 * i + 2, "seg_mixed_half_sweep_kernel", grid(129, 166))
             for i in range(1, 11)]
    bc = [(10 * i + 5, 10 * i + 6, "seg_mixed_bc_pass_kernel", (1, 2, 1, 0)) for i in (3, 7, 10)]
    k35 = tps._stage_plan(257, 2, 132, rect=True, seg_planes=257)
    k36 = tps._stage_plan(65, 2, 132, True, True, seg_planes=65)
    intervals = sorted(
        [(0, 4, "seg_half_sweep_from_zero_kernel<mg::Seg>", grid(129, 168))] + sweep[:3]
        + [bc[0]] + sweep[3:7] + [bc[1]]
        + [(78, 79, "seg_mixed_prolong_correct_black_kernel", grid(129, 168))] + sweep[7:10]
        + [bc[2]]
        + [(200, 203, "mixed_seg_stage_kernel<2, false>", (k35.blocks, 1, 1, k35.smem)),
           (210, 215, "mixed_seg_prolong_stage_kernel<2, true>", (k36.blocks, 1, 1, k36.smem)),
           (220, 221, "seg_residual_restrict_kernel<mg::Seg>", (-(-160 * 129 ** 2 // 256), 1, 1,
                                                                0)),
           (300, 301, "seg_half_sweep_from_zero_kernel<mg::Seg>", grid(129, 168)),
           (310, 312, "seg_half_sweep_kernel<mg::Seg>", grid(129, 166))])
    got = st.stage_calls(intervals, sizes)
    assert got == {"K35 n=129": [1, pytest.approx(0.011), pytest.approx(0.011)],
                   "K34 n=129": [1, pytest.approx(0.009), pytest.approx(0.009)],
                   "K36 n=129": [1, pytest.approx(0.008), pytest.approx(0.008)],
                   "K35 n=257": [1, pytest.approx(0.003), pytest.approx(0.003)],
                   "K36 n=65": [1, pytest.approx(0.005), pytest.approx(0.005)],
                   "K29 n=129": [1, pytest.approx(0.003), pytest.approx(0.003)]}
    assert st.restrict_calls(intervals, sizes) == {
        "K30 n=257": [1, pytest.approx(0.001), pytest.approx(0.001)]}


def test_stage_and_restrict_calls_map_the_sharded_dirichlet_solves():
    """The one-rank i-sharded Dirichlet solve (plan: 6 sharded levels, L =
    320 at 257^3) and the 1x1 (i, j) one (4 sharded levels, Li = Lj = 272):
    K28's first form (four half-sweeps), K29's (its from-zero head and three
    half-sweeps) and K31's (its correction head and three half-sweeps), by
    level from their rows' threads (L + 6 or L + 8 planes); K31 as the
    one-pass stage (seg_prolong_stage_kernel) one kernel a call, by level
    from its plan of min(L, n) planes; K30 a kernel a call from its coarse
    points; the same kernels on Seg2 are K37, K38, K40 and K39, by level from
    their blocks' rows and columns; a name without its arguments is either."""
    from multigrid_parallel_tpu_torch.hierarchy import Hierarchy
    from multigrid_parallel_tpu_torch.ops import pallas_split as tps
    from multigrid_parallel_tpu_torch.parallel.sharded import ShardPlan
    from multigrid_parallel_tpu_torch.parallel.sharded2d_padded import plan_sharding_2d_padded

    hier = Hierarchy(ndim=3, coarse_n=5, num_levels=7)
    plan = ShardPlan(n_dev=1, axis="x", n_sharded=6, fine_local=320)
    sizes = st._seg_sizes(hier, 132, plan)

    def grid(n, rows):
        return (-(-rows * n * n // 256), 1, 1, 0)

    half = [(10 * i, 10 * i + 2, "seg_half_sweep_kernel<mg::Seg>", grid(129, 166))
            for i in range(1, 10)]
    k31 = tps._stage_plan(65, 2, 132, True, True, seg_planes=65)
    intervals = sorted(
        half[:4]
        + [(48, 49, "seg_half_sweep_from_zero_kernel<mg::Seg>", grid(129, 168))] + half[4:7]
        + [(75, 79, "seg_prolong_correct_black_kernel<mg::Seg>", grid(257, 328))]
        + [(80 + 10 * i, 81 + 10 * i, "seg_half_sweep_kernel<mg::Seg>", grid(257, 326))
           for i in range(3)]
        + [(200, 203, "seg_prolong_stage_kernel<2, false, mg::rect::SegStageArgs, "
                      "mg::rect::SegProlongPrep>", (k31.blocks, 1, 1, k31.smem)),
           (210, 211, "seg_residual_restrict_kernel<mg::Seg>", (-(-160 * 129 ** 2 // 256), 1, 1,
                                                                0))])
    got = st.stage_calls(intervals, sizes)
    assert got == {"K28 n=129": [1, pytest.approx(0.008), pytest.approx(0.008)],
                   "K29 n=129": [1, pytest.approx(0.007), pytest.approx(0.007)],
                   "K31 n=257": [1, pytest.approx(0.007), pytest.approx(0.007)],
                   "K31 n=65": [1, pytest.approx(0.003), pytest.approx(0.003)]}
    assert st.restrict_calls(intervals, sizes) == {
        "K30 n=257": [1, pytest.approx(0.001), pytest.approx(0.001)]}

    plan2 = plan_sharding_2d_padded(hier, 1, 1)
    assert (plan2.n_sharded, plan2.local_i(0), plan2.local_j(0)) == (4, 272, 272)
    sizes2 = st._seg2d_sizes(hier, 132, plan2)

    def grid2(n, li, lj):
        return (-(-li * lj * n // 256), 1, 1, 0)

    k40 = tps._stage_plan(257, 2, 132, True, True, seg_planes=257, seg_cols=257)
    sweep2 = [(10 * i, 10 * i + 1, "seg_half_sweep_kernel<mg::Seg2>", grid2(65, 74, 74))
              for i in range(1, 7)]
    intervals2 = sorted(
        [(0, 3, "seg_prolong_correct_black_kernel<mg::Seg2>", grid2(65, 76, 76))] + sweep2[:3]
        + [(35, 36, "seg_half_sweep_from_zero_kernel<mg::Seg2>", grid2(65, 76, 76))]
        + sweep2[3:]
        + [(100, 104, "seg_prolong_stage_kernel<2, false, mg::rect::Seg2StageArgs, "
                      "mg::rect::Seg2ProlongPrep>", (k40.blocks, 1, 1, k40.smem)),
           (110, 111, "seg_residual_restrict_kernel<mg::Seg2>",
            (-(-136 * 136 * 129 // 256), 1, 1, 0)),
           (120, 121, "seg_prolong_stage_kernel", (k40.blocks, 1, 1, k40.smem))])
    assert st.stage_calls(intervals2, sizes2) == {
        "K40 n=65": [1, pytest.approx(0.006), pytest.approx(0.006)],
        "K38 n=65": [1, pytest.approx(0.004), pytest.approx(0.004)],
        "K40 n=257": [1, pytest.approx(0.004), pytest.approx(0.004)],
        "K31|K40 n=257": [1, pytest.approx(0.001), pytest.approx(0.001)]}
    assert st.restrict_calls(intervals2, sizes2) == {
        "K39 n=257": [1, pytest.approx(0.001), pytest.approx(0.001)]}


def test_stage_calls_map_the_segment_smoothing_stages():
    """K28's and K37's one-pass stage (seg_smooth_stage_kernel, K1's stage
    on a rank's segmented block) is one kernel a call: K28 on
    SegStageArgs, K37 on Seg2StageArgs, by level from its plan of the
    rank's planes (and rows); between K29's first-form calls it starts a
    call of its own; a name without its arguments is either."""
    from multigrid_parallel_tpu_torch.hierarchy import Hierarchy
    from multigrid_parallel_tpu_torch.ops import pallas_split as tps
    from multigrid_parallel_tpu_torch.parallel.sharded import ShardPlan
    from multigrid_parallel_tpu_torch.parallel.sharded2d_padded import plan_sharding_2d_padded

    hier = Hierarchy(ndim=3, coarse_n=5, num_levels=7)
    sizes = st._seg_sizes(hier, 132, ShardPlan(n_dev=1, axis="x", n_sharded=6, fine_local=320))
    k28 = tps._stage_plan(257, 2, 132, False, True, seg_planes=257)
    k28_65 = tps._stage_plan(65, 2, 132, False, True, seg_planes=65)
    zero = (-(-168 * 129 * 129 // 256), 1, 1, 0)
    intervals = sorted(
        [(0, 3, "seg_smooth_stage_kernel<2, false, mg::rect::SegStageArgs>",
          (k28.blocks, 1, 1, k28.smem)),
         (10, 11, "seg_half_sweep_from_zero_kernel<mg::Seg>", zero)]
        + [(20 + 10 * i, 21 + 10 * i, "seg_half_sweep_kernel<mg::Seg>",
            (-(-166 * 129 * 129 // 256), 1, 1, 0)) for i in range(3)]
        + [(60, 62, "seg_smooth_stage_kernel<2, true, mg::rect::SegStageArgs>",
            (k28_65.blocks, 1, 1, k28_65.smem))])
    assert st.stage_calls(intervals, sizes) == {
        "K28 n=257": [1, pytest.approx(0.003), pytest.approx(0.003)],
        "K29 n=129": [1, pytest.approx(0.004), pytest.approx(0.004)],
        "K28 n=65": [1, pytest.approx(0.002), pytest.approx(0.002)]}
    sizes2 = st._seg2d_sizes(hier, 132, plan_sharding_2d_padded(hier, 1, 1))
    k37 = tps._stage_plan(257, 2, 132, False, True, seg_planes=257, seg_cols=257)
    intervals2 = [(0, 4, "seg_smooth_stage_kernel<2, false, mg::rect::Seg2StageArgs>",
                   (k37.blocks, 1, 1, k37.smem)),
                  (10, 11, "seg_smooth_stage_kernel", (k37.blocks, 1, 1, k37.smem))]
    assert st.stage_calls(intervals2, sizes2) == {
        "K37 n=257": [1, pytest.approx(0.004), pytest.approx(0.004)],
        "K28|K37 n=257": [1, pytest.approx(0.001), pytest.approx(0.001)]}


def test_stage_calls_map_the_segment_from_zero_stages():
    """K29's and K38's one-pass stage (seg_smooth_from_zero_stage_kernel,
    K2's stage from a zero tile on a rank's segmented block) is one kernel a
    call, told from K28's and K37's seg_smooth_stage_kernel with or without
    its arguments: K29 on SegStageArgs, K38 on Seg2StageArgs, by level from
    its plan of the rank's planes (and rows); a first-form K29 call (its
    head and three half-sweeps) beside it is grouped as before; a name
    without its arguments is either of the twins."""
    from multigrid_parallel_tpu_torch.hierarchy import Hierarchy
    from multigrid_parallel_tpu_torch.ops import pallas_split as tps
    from multigrid_parallel_tpu_torch.parallel.sharded import ShardPlan
    from multigrid_parallel_tpu_torch.parallel.sharded2d_padded import plan_sharding_2d_padded

    hier = Hierarchy(ndim=3, coarse_n=5, num_levels=7)
    sizes = st._seg_sizes(hier, 132, ShardPlan(n_dev=1, axis="x", n_sharded=6, fine_local=320))
    k29 = tps._stage_plan(257, 2, 132, False, True, seg_planes=257)
    k29_129 = tps._stage_plan(129, 2, 132, False, True, seg_planes=129)
    intervals = sorted(
        [(0, 3, "seg_smooth_from_zero_stage_kernel<2, false, mg::rect::SegStageArgs>",
          (k29.blocks, 1, 1, k29.smem)),
         (5, 6, "seg_smooth_stage_kernel<2, false, mg::rect::SegStageArgs>",
          (k29.blocks, 1, 1, k29.smem)),
         (10, 12, "seg_smooth_from_zero_stage_kernel<2, true, mg::rect::SegStageArgs>",
          (k29_129.blocks, 1, 1, k29_129.smem)),
         (20, 21, "seg_half_sweep_from_zero_kernel<mg::Seg>", (-(-88 * 65 * 65 // 256), 1, 1,
                                                               0))]
        + [(30 + 10 * i, 31 + 10 * i, "seg_half_sweep_kernel<mg::Seg>",
            (-(-86 * 65 * 65 // 256), 1, 1, 0)) for i in range(3)])
    assert st.stage_calls(intervals, sizes) == {
        "K29 n=257": [1, pytest.approx(0.003), pytest.approx(0.003)],
        "K28 n=257": [1, pytest.approx(0.001), pytest.approx(0.001)],
        "K29 n=129": [1, pytest.approx(0.002), pytest.approx(0.002)],
        "K29 n=65": [1, pytest.approx(0.004), pytest.approx(0.004)]}
    sizes2 = st._seg2d_sizes(hier, 132, plan_sharding_2d_padded(hier, 1, 1))
    k38 = tps._stage_plan(257, 2, 132, False, True, seg_planes=257, seg_cols=257)
    intervals2 = [(0, 4, "seg_smooth_from_zero_stage_kernel<2, false, mg::rect::Seg2StageArgs>",
                   (k38.blocks, 1, 1, k38.smem)),
                  (10, 11, "seg_smooth_from_zero_stage_kernel", (k38.blocks, 1, 1, k38.smem)),
                  (20, 22, "seg_smooth_stage_kernel", (k38.blocks, 1, 1, k38.smem))]
    assert st.stage_calls(intervals2, sizes2) == {
        "K38 n=257": [1, pytest.approx(0.004), pytest.approx(0.004)],
        "K29|K38 n=257": [1, pytest.approx(0.001), pytest.approx(0.001)],
        "K28|K37 n=257": [1, pytest.approx(0.002), pytest.approx(0.002)]}


def test_restrict_calls_map_the_segment_restriction_stages():
    """K30's and K39's streaming stages (seg_restrict_kernel<mg::Seg, C>
    and <mg::Seg2, C>, from a demangled or a mangled name) one kernel a
    call, by level from their plans of rank 0's interior coarse rows (and
    columns) on the one-rank i-sharded plan (L = 320 at 257^3) and the 1x1
    (i, j) one (272^2), beside the first form's kernel; a name without its
    arguments is either."""
    from multigrid_parallel_tpu_torch.hierarchy import Hierarchy
    from multigrid_parallel_tpu_torch.ops import pallas_sharded as tpx
    from multigrid_parallel_tpu_torch.ops import pallas_split as tps
    from multigrid_parallel_tpu_torch.parallel.sharded import ShardPlan
    from multigrid_parallel_tpu_torch.parallel.sharded2d_padded import plan_sharding_2d_padded

    assert (st.short_name("void (anonymous namespace)::seg_restrict_kernel<mg::Seg2, 2>("
                          "mg::restriction::SegArgs<mg::Seg2>)")
            == "seg_restrict_kernel<mg::Seg2, 2>")
    hier = Hierarchy(ndim=3, coarse_n=5, num_levels=7)
    sizes = st._seg_sizes(hier, 132, ShardPlan(n_dev=1, axis="x", n_sharded=6, fine_local=320))
    plan2 = plan_sharding_2d_padded(hier, 1, 1)
    sizes2 = st._seg2d_sizes(hier, 132, plan2)
    k30 = {n: tps._restrict_plan(n, 132, seg_rows=tpx.seg_restrict_extents(n, 0, L)[0])
           for n, L in ((257, 320), (129, 160), (9, 10))}
    k39 = {n: tps._restrict_plan(n, 132, seg_rows=(n - 1) // 2 - 1, seg_cols=(n - 1) // 2 - 1)
           for n in (257, 129)}
    assert all((k39[n].rows, k39[n].cols) == tpx.seg_restrict_extents(n, 0, w, 0, w)
               for n, w in ((257, 272), (129, 136)))

    def shape(p, smem=True):
        return (p.blocks, 1, 1, p.smem) if smem else (p.blocks, 1, 1)

    intervals = [(0, 4, "seg_restrict_kernel<mg::Seg, 2>", shape(k30[257])),
                 (10, 12, "seg_restrict_kernel<mg::Seg, 1>", shape(k30[129], False)),
                 (20, 21, "seg_restrict_kernel<mg::Seg, 1>", shape(k30[9])),
                 (30, 31, "seg_residual_restrict_kernel<mg::Seg>",
                  (-(-5 * 5 * 5 // 256), 1, 1, 0))]
    assert st.restrict_calls(intervals, {**sizes}) == {
        "K30 n=257": [1, pytest.approx(0.004), pytest.approx(0.004)],
        "K30 n=129": [1, pytest.approx(0.002), pytest.approx(0.002)],
        "K30 n=9": [2, pytest.approx(0.002), pytest.approx(0.001)]}
    intervals2 = [(0, 3, "seg_restrict_kernel<mg::Seg2, 2>", shape(k39[257])),
                  (10, 11, "seg_restrict_kernel<mg::Seg2, 1>", shape(k39[129])),
                  (20, 22, "seg_restrict_kernel", shape(k39[129]))]
    assert st.restrict_calls(intervals2, sizes2) == {
        "K39 n=257": [1, pytest.approx(0.003), pytest.approx(0.003)],
        "K39 n=129": [1, pytest.approx(0.001), pytest.approx(0.001)],
        "K30|K39 n=129": [1, pytest.approx(0.002), pytest.approx(0.002)]}


def test_norm_calls_join_each_partials_kernel_to_its_sum():
    """A K5, K32 or K41 call is its partials kernel (K5's, K32's first
    form or stage, K41 where the arguments hold Seg2, "K32|K41" where the
    trace dropped them) and the sum_partials_kernel after it; other
    kernels between calls are no part of one."""
    assert (st.short_name("void (anonymous namespace)::df_stage_kernel<mg::Seg2, 8>("
                          "(anonymous namespace)::DfArgs<mg::Seg2>)")
            == "df_stage_kernel<mg::Seg2, 8>")
    intervals = [(0, 100, "df_stage_kernel<mg::Seg, 8>", ()),
                 (100, 103, "sum_partials_kernel", ()),
                 (110, 120, "rb_half_sweep_kernel", ()),
                 (130, 290, "df_stage_kernel<mg::Seg, 8>", ()),
                 (290, 292, "sum_partials_kernel", ()),
                 (300, 400, "seg_residual_df_partials_kernel<mg::Seg2>", ()),
                 (400, 401, "sum_partials_kernel", ()),
                 (410, 420, "df_stage_kernel", ()),
                 (420, 421, "sum_partials_kernel", ()),
                 (430, 530, "residual_df_partials_kernel", ()),
                 (530, 532, "sum_partials_kernel", ())]
    assert st.norm_calls(intervals) == {
        "K32": [2, pytest.approx(0.265), pytest.approx(0.1325)],
        "K41": [1, pytest.approx(0.101), pytest.approx(0.101)],
        "K32|K41": [1, pytest.approx(0.011), pytest.approx(0.011)],
        "K5": [1, pytest.approx(0.102), pytest.approx(0.102)]}
