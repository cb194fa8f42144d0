#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths (multigrid_parallel_tpu_torch). The
double-float defect-correction solve of 3D Poisson at 257^3 (coarse_n 5,
7 levels, quadratic Dirichlet data, f = 0) to relative residual 1e-8
against the whole-cube ||f||, 4 f32 correction V-cycles per outer step,
2 RB-GS sweeps before and after; in its unfused configuration (K1, K2, R,
matrix-product transfers, K5), its fused one (the default: K1, K2, K3,
K4, K6, with K5 for the initial residual), fused with the full-multigrid
bootstrap, the f64-outer mixed solver on the fused cycle, and the
split-colour solver (the finest level on red / black pairs: K7-K12; the
levels below on the fused cycle: K1-K4). And the electrospray mixed-BC
solve at 257^3 in its production configuration (docs/MIXED_BC.md section
4: W-cycles capped at 65^3, one inner cycle per outer step, to 1e-8 of
the initial residual) on the fused-kernel tier (K13-K15, K3, K5), on
the k-fold tier (the same solve in the (n, n, n - 2) fold layout:
K16-K20) and on the split-colour tier (the finest level on red / black
pairs: K22-K25, and K21 where a cycle starts from a correction; the
levels below on the fold cycle). And the reference driver surface: the
f64 V-cycle solve at 257^3 through each of its entry points,
MultigridSolver with a checkpoint, the smoother study on K1 and the
CLI. And the i-sharded distributed double-float solve at 257^3 on
torch.distributed (K28-K32; K33 beside them), the i-sharded
electrospray solve at 257^3 in its production configuration (K34-K36 with
K30 and K32), each on one NCCL rank and on four gloo ranks sharing the
card, and the (i, j)-sharded double-float solve at 257^3 (K37-K41, with
K28-K31 in its j-replicated tier and K2-K4 in its replicated tail) on one
NCCL rank and on the four gloo ranks as 2x2 and 1x4 meshes. And the
packed split-colour smoothing stage (K42), which no solve path calls,
through its stage bench (utils.timing.profile_splitcolor_stage, the
counterpart of scripts/splitcolor_bench.py) at 257^3. Phases, each of
which fails the run:

  1. build the hand-written CUDA kernels from ops/csrc (one nvcc per
     source, all started together; sm_90a);
  2. hold each kernel against its plain PyTorch version on the card at
     65^3 and 257^3 (numpy-seeded inputs; the split kernels on pairs
     packed from zero-boundary cubes; K13-K15, and K3 and K5 once more,
     at the electrospray's h = 3e-4 / (n - 1) with its pin planes; the
     fold kernels K16-K20 on the same fields packed into the fold layout
     and K21-K25 on them packed into pairs, and K19 and K24 once more at
     17^3, where the pin-edge delta is live) and time both (CUDA events,
     median of 20); K3 and K9 (the streaming restriction stage) bit for
     bit, K3 at both h; K1 (a one-pass stage) timed beside its per-sweep form
     (one launch a half-sweep) in the same call, at 65^3 and 257^3 and at
     every level of the main path, 9^3-257^3 (CUDA events, and device time
     a call from a trace of 20 calls); K26 (K1's one-pass stage that also
     writes the residual: fresh (u', r), u untouched, ceil(n_iter / 2)
     launches a call) bit for bit at n_iter 1-3, both orders, timed against
     K1 + R in the same call, and residual_norm_fused (R and a sum) against its plain
     version; K1, K2 and K4 (one-pass stages) once more at 129^3, n_iter
     1-3, K2 and K4 timed at n_iter 2 beside the bound from the bytes a
     call needs; K17 and K19 (one-pass fold stages) bit for bit at 65^3,
     257^3 and, with the pin-edge delta, 17^3; K16 (the fold stage on a
     loaded field) bit for bit at 65^3 and 257^3, one launch a call at
     n_iter <= 2; K18 bit for bit at 17^3 and 65^3 (its first form) and
     257^3 (the streaming stage); K14 and K15 (one-pass
     full-layout mixed stages) bit for bit at 17^3, 65^3 and 257^3; K21,
     K22 and K24 (one-pass msplit stages) and K23 (the streaming
     restriction stage on the pair) bit for bit at 17^3 (K24 with the
     pin-edge delta), 65^3 and 257^3;
  3. solve 33^3 on the CPU (plain versions) and on the card (kernels),
     unfused, fused, fused with FMG and split: same outer-step count,
     solutions within 1e-8; the electrospray full, fold and split tiers
     at 33^3, V and W, and the split tier with two inner cycles (K21
     launched exactly once an outer step; its card solves' launches
     counted): same count, within 1e-7 V;
  4. solve 257^3 on each Dirichlet path with every launch count reset
     just before and read just after, then check the outer-step count,
     the final relative residual, the error against the analytic solution
     and that the path launched exactly its kernels (the one-pass stages
     exactly: the split solve 1 K8, 3 K7, 4 K10, 20 K2 and 20 K4 launches
     an outer step, the fused one 3 K1, 21 K2 and 24 K4, the unfused one
     27 K1 and 21 K2); time
     each solve (warm-up, median of 5); the split solution against the
     fused one;
  5. time the split and fused 257^3 solves interleaved run by run in
     this one call (host wall and CUDA-event span, 9 each), then trace one
     solve of each (device busy, kernels by name, the device's idle share
     of the span from its first kernel to its last);
  6. the electrospray 257^3 solve, launches reset and read around it:
     14 +- 1 outer steps, final norm <= 1e-8 of the initial one, only
     K13-K15, K3 and K5 launched, K13, K14 and K15 exactly as many times
     as the cycle's calls in that many outer steps need (one launch a call
     each); its wall (warm-up, median of 5)
     beside the device-busy time of one traced solve; its solution within
     1e-3 V of the f64-outer MixedBCSolver.solve_on_device, outer steps
     within 1; K13, K14 and K15's device time a call by level from a trace;
  7. the electrospray 257^3 solve on the fold tier, launches reset and
     read around it: only K16-K20 launched, K16, K17 and K19 exactly as
     many times as the fold cycle's calls in that many outer steps need
     (one launch a call each), the full tier's
     outer-step count, max|u_fold - u_full| <= 1e-7 max|u|; then the fold
     and full walls interleaved run by run (9 each), the device-busy time
     of one traced solve of each, and K16, K17 and K19's device time a
     call by level from a trace of the fold solve;
  8. the same solve on the split tier, launches reset and read around
     it: only K22-K25 and K16-K19 launched, K16, K17 and K19 exactly as
     the fold cycle below the finest level needs, K22 and K24 exactly as
     the finest level's calls need (one launch a call), the fold tier's
     outer-step count, converged to 1e-8 of its initial norm, max|u_msplit
     - u_fold| <= 1e-7 max|u|; then the split and fold walls interleaved,
     the device-busy time of one traced solve of each, and K16, K17, K19,
     K22 and K24's device time a call by level;
  9. the driver surface: (a) the f64 reference solve at 257^3 (solve,
     solve_mixed, solve with FMG, solve_on_device, solve_on_device_mixed):
     converged, 16 +- 1 V-cycles (the C reference's 16), L2 error <= 5e-9
     (its 2.81e-9), no hand kernel launched, wall (median of 3) and
     device-busy time; (b) MultigridSolver at 257^3 to convergence, saved
     and restored, three more cycles bit for bit, one profiled stage
     table; (c) the smoother study at 50^3 on K1 (f32, 600 iterations),
     launches reset and read around it (2 a iteration): ratio^2 within
     1e-3 of the published 0.983675, the trajectory bit for bit against
     the plain f32 study; (d) profile_padded_stages at 257^3; (e) the CLI
     in-process, each flag set on the card and on the CPU at 33^3: the
     same cycle counts, printed errors within 1e-5;
 10. the i-sharded solve (parallel.sharded_padded): (a) K28-K33 on four
     simulated ranks' segments of 65^3 and 257^3 fields and on one rank's
     257^3 segment (L = 320), each bitwise equal to its plain version and,
     stitched, to the single-device kernels (K1, K2, R, K3, K4, K5's r;
     the partial norms' sum within 1e-6 of K5's), each timed against its
     plain version, and K30 (the streaming restriction stage on segments)
     and K28 and K29 (K1's and K2's one-pass stages on segments) timed on
     the one-rank L = 320 segment beside their bounds from the bytes they
     need, and K32 (the streaming df residual-and-norm stage) and K33 (the
     streaming residual stage) checked and timed there against their plain
     versions and that bound (K33's also on rank 1's: 12 bytes an interior
     point, 4 any other), K5 on the whole field beside them; (b)
     make_sharded_df_solver at 257^3 on one rank of an NCCL group, launch
     counts reset and read around it: exactly the launches predicted from
     its outer steps (K28, K29 and K31 one a call, one-pass stages), only
     K28-K32, the fused solve's outer steps, error within 1% of its, max|u - u_fused| <=
     1e-9, walls interleaved with the fused solve (5 each) and the device
     busy time of each; (c) the same solve on four gloo ranks on the one
     card (halos staged through host memory, every kernel on the card),
     spawned by parallel.launch: (b)'s outer steps, u within 1e-9 of (b)'s,
     each rank launching only K28-K32 and, in the replicated 9^3 cycle,
     K2-K4, each exactly as predicted, one host-staged wall (not a scaling
     figure); and the f64 sharded V-cycle at 129^3 on those ranks against
     the single-device one within 1e-11;
 11. the i-sharded electrospray solve (parallel.sharded_mixed_padded):
     (a) K34-K36 on simulated ranks' segments of 65^3 (four ranks of L =
     24, and of L = 32, where plane 64 is rank 2's first row) and 257^3
     (four ranks of L = 96, one of L = 320, and five of L = 64, where plane
     256 is rank 4's first row) electrospray fields with the problem's
     pins, each bitwise equal to its plain version and, stitched, to
     K13-K15, pad planes zero, each timed on rank 1's 257^3 segments (L =
     96) against its plain version, and K34 and K35 timed on the one-rank
     plan's blocks at 129^3 (L = 160) and 65^3 (L = 80), where the solve
     runs K34, beside their bounds; (b) make_sharded_mixed_padded_df_solver
     at 257^3 (production configuration) on one NCCL rank, launch counts
     reset and read around it: K30, K32 and K34-K36 (one-pass stages)
     launched as often as phase 6's full tier launches K3, K5 and K13-K15,
     and nothing else, the full tier's outer
     steps, max|u - u_full| <= 1e-7 max|u|, walls interleaved with the full
     tier (5 each) and the device busy time of each; (c) in 10c's spawned
     group, the same solve on the four gloo ranks: (b)'s outer steps, u
     within 1e-7 max|u| of (b)'s, each rank launching exactly K34 42, K35
     168, K36 210, K30 210 and K32 15 times and, in the replicated 9^3
     tail, K14, K3 and K15 56 times each; and the f64 sharded mixed-BC
     cycle at 65^3 against MixedBCSolver's within 1e-11 max|u|;
 12. the (i, j)-sharded solve (parallel.sharded2d_padded): (a) K37-K41 on
     the simulated ranks' blocks of 65^3 and 257^3 fields on 1x1, 2x2, 4x1
     and 1x4 meshes (the padded plan's blocks, five halo parts with the corner
     blocks), each bitwise equal to its plain version and, stitched, to K1
     (both orders), K2, K3, K4 and K5's r, each timed on rank (0, 0)'s
     257^3 2x2 block against its plain version, and K39, K37, K38 and K41
     checked and timed on the 1x1 block (272^2) beside their bounds (K41
     against its plain version too, K5 beside it); (b)
     make_sharded2d_padded_df_solver at 257^3 on one NCCL rank (a 1x1 mesh,
     plan Li = Lj = 272, n_sharded 4), launch counts reset and read around
     it: exactly the launches predicted from the tier map (K37, K38, K40
     and the j-replicated tier's K28, K29 and K31 one a call), the fused
     solve's outer steps, max|u - u_fused| = 0, walls interleaved with the
     fused solve (5 each), the device busy time of each, and the dry-run
     twin on that rank; (c) four gloo ranks through parallel.launch: the
     same solve on a 2x2 mesh (Li = Lj = 144) and on a 1x4 mesh whose 9^3
     level runs the j-replicated tier, each in (b)'s outer steps with u
     bitwise equal to (b)'s and each rank's launches as predicted, one
     host-staged wall a rank, and the dry-run twin with its 2D part;
 13. the packed split-colour stage (ops.pallas_splitcolor): (a) K42 (K7's
     one-pass stage on the packed array) at 65^3 and 257^3 on packed
     arrays of zero-boundary cubes, n_iter 1-3, both orders, each call
     launching ceil(n_iter / 2) times into a fresh array, u2 untouched,
     bit for bit against its plain version and, within 4 ulp of max|u|
     (another addition order), K7 on the pair and K1 on the cube; timed
     against its plain version; (b) the stage bench at 257^3, n_iter 2,
     launch counts reset just before and read just after: the rect (K1)
     stage, the packed (K42) stage and the pair (K7) stage, each beside
     its per-sweep form (one launch a half-sweep), and the same-bytes
     floor, interleaved (median of 20 CUDA-event rounds), each with its
     one-pass bytes and bound, K42 against K7's stage, and exactly one
     launch of each of K1, K42 and K7 a call, 2 n_iter of each per-sweep
     form (counted apart).

Prints a {"kernels": [...]} line (each kernel's launches summed over the
257^3 runs of phases 4, 6, 7, 8, 10, 11 and 12 (all four ranks of 10c,
11c and 12c), the split tier's 33^3 card solves of phase 3, the study of
phase 9c and the stage bench of phase 13b; bound_ms from the timed call's bytes and operations), the
card's name and power limit, and as its last line
{"ok": true, "device": {...}}. Exits non-zero, printing no result, when
there is no CUDA device or any check fails.
"""

import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REL_TOL = 1e-8
FIELD_ULPS = 4      # fields: expected bitwise equal; allowed 4 ulp of the max
NORM_RTOL = 1e-5    # ||r||^2: kernel and plain sum in different orders
ERR_TOL = 1e-8      # L2 error against the analytic solution at 257^3
SOURCES = {
    # K1 and R also serve the single-buffered site :174 (rb_smooth_fused_padded
    # :556 and its cube wrapper :1618; residual_fused_padded :610 and the
    # cube wrappers residual_fused :1626, residual_norm_fused :1631)
    "rb_smooth_fused": ("multigrid_parallel_tpu_torch/ops/csrc/rb_smooth.cu",
                        "multigrid_parallel_tpu/ops/pallas3d.py:515, "
                        "multigrid_parallel_tpu/ops/pallas3d.py:556"),
    "rb_smooth_from_zero_fused": ("multigrid_parallel_tpu_torch/ops/csrc/rb_smooth.cu",
                                  "multigrid_parallel_tpu/ops/pallas3d.py:412"),
    "residual_fused": ("multigrid_parallel_tpu_torch/ops/csrc/residual.cu",
                       "multigrid_parallel_tpu/ops/pallas3d.py:626, "
                       "multigrid_parallel_tpu/ops/pallas3d.py:610"),
    "rb_smooth_residual_fused": ("multigrid_parallel_tpu_torch/ops/csrc/rb_smooth_residual.cu",
                                 "multigrid_parallel_tpu/ops/pallas3d.py:695"),
    "residual_df_fused": ("multigrid_parallel_tpu_torch/ops/csrc/residual_df_norm.cu",
                          "multigrid_parallel_tpu/ops/pallas3d.py:1528"),
    "residual_df_norm_fused": ("multigrid_parallel_tpu_torch/ops/csrc/residual_df_norm.cu",
                               "multigrid_parallel_tpu/ops/pallas3d.py:1245"),
    "residual_restrict_fused": ("multigrid_parallel_tpu_torch/ops/csrc/residual_restrict.cu",
                                "multigrid_parallel_tpu/ops/pallas3d.py:872"),
    "prolong_smooth_fused": ("multigrid_parallel_tpu_torch/ops/csrc/prolong_smooth.cu",
                             "multigrid_parallel_tpu/ops/pallas3d.py:1075"),
    "df_step_residual_norm_fused": ("multigrid_parallel_tpu_torch/ops/csrc/df_step.cu",
                                    "multigrid_parallel_tpu/ops/pallas3d.py:1426"),
    "rb_smooth_split": ("multigrid_parallel_tpu_torch/ops/csrc/rb_smooth_split.cu",
                        "multigrid_parallel_tpu/ops/pallas_split.py:406"),
    "rb_smooth_split_from_zero": ("multigrid_parallel_tpu_torch/ops/csrc/rb_smooth_split.cu",
                                  "multigrid_parallel_tpu/ops/pallas_split.py:434"),
    "residual_restrict_split": ("multigrid_parallel_tpu_torch/ops/csrc/residual_restrict_split.cu",
                                "multigrid_parallel_tpu/ops/pallas_split.py:573"),
    "prolong_smooth_split": ("multigrid_parallel_tpu_torch/ops/csrc/prolong_smooth_split.cu",
                             "multigrid_parallel_tpu/ops/pallas_split.py:746"),
    "df_step_split": ("multigrid_parallel_tpu_torch/ops/csrc/df_split.cu",
                      "multigrid_parallel_tpu/ops/pallas_split.py:830"),
    "residual_df_norm_split": ("multigrid_parallel_tpu_torch/ops/csrc/df_split.cu",
                               "multigrid_parallel_tpu/ops/pallas_split.py:879"),
    "mixed_rb_smooth_fused": ("multigrid_parallel_tpu_torch/ops/csrc/mixed_rb_smooth.cu",
                              "multigrid_parallel_tpu/ops/pallas_mixed.py:277"),
    "mixed_rb_smooth_from_zero_fused": ("multigrid_parallel_tpu_torch/ops/csrc/mixed_rb_smooth.cu",
                                        "multigrid_parallel_tpu/ops/pallas_mixed.py:300"),
    "mixed_prolong_smooth_fused": ("multigrid_parallel_tpu_torch/ops/csrc/mixed_prolong_smooth.cu",
                                   "multigrid_parallel_tpu/ops/pallas_mixed.py:320"),
    "mixed_rb_smooth_fold": ("multigrid_parallel_tpu_torch/ops/csrc/mixed_rb_smooth_fold.cu",
                             "multigrid_parallel_tpu/ops/pallas_mixed_fold.py:233"),
    "mixed_rb_smooth_from_zero_fold": ("multigrid_parallel_tpu_torch/ops/csrc/mixed_rb_smooth_fold.cu",
                                       "multigrid_parallel_tpu/ops/pallas_mixed_fold.py:256"),
    "residual_restrict_fold": ("multigrid_parallel_tpu_torch/ops/csrc/residual_restrict_fold.cu",
                               "multigrid_parallel_tpu/ops/pallas_mixed_fold.py:399"),
    "mixed_prolong_smooth_fold": ("multigrid_parallel_tpu_torch/ops/csrc/mixed_prolong_smooth_fold.cu",
                                  "multigrid_parallel_tpu/ops/pallas_mixed_fold.py:502"),
    "residual_df_norm_fold": ("multigrid_parallel_tpu_torch/ops/csrc/residual_df_norm_fold.cu",
                              "multigrid_parallel_tpu/ops/pallas_mixed_fold.py:744"),
    "mixed_rb_smooth_msplit": ("multigrid_parallel_tpu_torch/ops/csrc/mixed_rb_smooth_msplit.cu",
                               "multigrid_parallel_tpu/ops/pallas_mixed_split.py:448"),
    "mixed_rb_smooth_from_zero_msplit": ("multigrid_parallel_tpu_torch/ops/csrc/mixed_rb_smooth_msplit.cu",
                                         "multigrid_parallel_tpu/ops/pallas_mixed_split.py:479"),
    "residual_restrict_msplit": ("multigrid_parallel_tpu_torch/ops/csrc/residual_restrict_msplit.cu",
                                 "multigrid_parallel_tpu/ops/pallas_mixed_split.py:615"),
    "mixed_prolong_smooth_msplit": ("multigrid_parallel_tpu_torch/ops/csrc/mixed_prolong_smooth_msplit.cu",
                                    "multigrid_parallel_tpu/ops/pallas_mixed_split.py:831"),
    "residual_df_norm_msplit": ("multigrid_parallel_tpu_torch/ops/csrc/residual_df_norm_msplit.cu",
                                "multigrid_parallel_tpu/ops/pallas_mixed_split.py:922"),
    # the i-sharded kernels: each serves the ext and the halo form of its
    # Pallas kernel (the sites :184 and :864 for K28 / K29; :374 and :864 for K32)
    "rb_smooth_seg": ("multigrid_parallel_tpu_torch/ops/csrc/rb_smooth_seg_stage.cu",
                      "multigrid_parallel_tpu/ops/pallas_sharded.py:184, "
                      "multigrid_parallel_tpu/ops/pallas_sharded.py:864"),
    "rb_smooth_from_zero_seg": ("multigrid_parallel_tpu_torch/ops/csrc/rb_smooth_seg_stage.cu",
                                "multigrid_parallel_tpu/ops/pallas_sharded.py:184, "
                                "multigrid_parallel_tpu/ops/pallas_sharded.py:864"),
    "residual_restrict_seg": ("multigrid_parallel_tpu_torch/ops/csrc/residual_restrict_seg.cu",
                              "multigrid_parallel_tpu/ops/pallas_sharded.py:511, "
                              "multigrid_parallel_tpu/ops/pallas_sharded.py:1056"),
    "prolong_smooth_seg": ("multigrid_parallel_tpu_torch/ops/csrc/prolong_smooth_seg.cu",
                           "multigrid_parallel_tpu/ops/pallas_sharded.py:658, "
                           "multigrid_parallel_tpu/ops/pallas_sharded.py:1188"),
    "residual_df_norm_seg": ("multigrid_parallel_tpu_torch/ops/csrc/residual_df_norm_seg.cu",
                             "multigrid_parallel_tpu/ops/pallas_sharded.py:374, "
                             "multigrid_parallel_tpu/ops/pallas_sharded.py:864"),
    "residual_seg": ("multigrid_parallel_tpu_torch/ops/csrc/residual.cu",
                     "multigrid_parallel_tpu/ops/pallas_sharded.py:184"),
    # the i-sharded electrospray kernels: each serves the ext and the halo
    # form of its Pallas kernel
    "mixed_rb_smooth_seg": ("multigrid_parallel_tpu_torch/ops/csrc/mixed_rb_smooth_seg.cu",
                            "multigrid_parallel_tpu/ops/pallas_mixed.py:524, "
                            "multigrid_parallel_tpu/ops/pallas_mixed.py:786"),
    "mixed_rb_smooth_from_zero_seg": ("multigrid_parallel_tpu_torch/ops/csrc/mixed_rb_smooth_seg.cu",
                                      "multigrid_parallel_tpu/ops/pallas_mixed.py:524, "
                                      "multigrid_parallel_tpu/ops/pallas_mixed.py:786"),
    "mixed_prolong_smooth_seg": ("multigrid_parallel_tpu_torch/ops/csrc/mixed_prolong_smooth_seg.cu",
                                 "multigrid_parallel_tpu/ops/pallas_mixed.py:684, "
                                 "multigrid_parallel_tpu/ops/pallas_mixed.py:948"),
    # the (i, j)-sharded kernels: the i-sharded sources instantiated on the 2D
    # accessor (seg2d.cuh); each serves the ext and the halo form of its Pallas
    # kernel (the sites :181 and :910 for K37 / K38; :676 and :910 for K41)
    "rb_smooth_seg2d": ("multigrid_parallel_tpu_torch/ops/csrc/rb_smooth_seg_stage.cu",
                        "multigrid_parallel_tpu/ops/pallas_sharded2d.py:181, "
                        "multigrid_parallel_tpu/ops/pallas_sharded2d.py:910"),
    "rb_smooth_from_zero_seg2d": ("multigrid_parallel_tpu_torch/ops/csrc/rb_smooth_seg_stage.cu",
                                  "multigrid_parallel_tpu/ops/pallas_sharded2d.py:181, "
                                  "multigrid_parallel_tpu/ops/pallas_sharded2d.py:910"),
    "residual_restrict_seg2d": ("multigrid_parallel_tpu_torch/ops/csrc/residual_restrict_seg.cu",
                                "multigrid_parallel_tpu/ops/pallas_sharded2d.py:382, "
                                "multigrid_parallel_tpu/ops/pallas_sharded2d.py:1122"),
    "prolong_smooth_seg2d": ("multigrid_parallel_tpu_torch/ops/csrc/prolong_smooth_seg.cu",
                             "multigrid_parallel_tpu/ops/pallas_sharded2d.py:540, "
                             "multigrid_parallel_tpu/ops/pallas_sharded2d.py:1259"),
    "residual_df_norm_seg2d": ("multigrid_parallel_tpu_torch/ops/csrc/residual_df_norm_seg.cu",
                               "multigrid_parallel_tpu/ops/pallas_sharded2d.py:676, "
                               "multigrid_parallel_tpu/ops/pallas_sharded2d.py:910"),
    # the packed split-colour stage: on no solve path; the stage bench's (phase 13)
    "rb_smooth_split_fused": ("multigrid_parallel_tpu_torch/ops/csrc/rb_smooth_splitcolor.cu",
                              "multigrid_parallel_tpu/ops/pallas_splitcolor.py:220"),
}
# f32 operations per stored output point of each kernel as the main path
# calls it (n_iter = 2), counted from its arithmetic: an RB update is 8
# (five adds, h^2 r, the difference, the 1/6 scaling), a residual 9, an
# EFT residual ~70 plus the f64 square and sum, df_add 12, the 27-point
# restriction ~5 per fine point on top of the residual, the
# interpolation ~3. They only decide bound_by: each is two orders of
# magnitude under the bytes.
OPS_PER_POINT = {
    "rb_smooth_fused": 16, "rb_smooth_from_zero_fused": 16, "residual_fused": 9,
    "residual_df_norm_fused": 72, "residual_restrict_fused": 14, "prolong_smooth_fused": 20,
    "df_step_residual_norm_fused": 84, "rb_smooth_split": 16, "rb_smooth_split_from_zero": 16,
    "residual_restrict_split": 14, "prolong_smooth_split": 20, "df_step_split": 84,
    "residual_df_norm_split": 72, "mixed_rb_smooth_fused": 16,
    "mixed_rb_smooth_from_zero_fused": 16, "mixed_prolong_smooth_fused": 20,
    "mixed_rb_smooth_fold": 16, "mixed_rb_smooth_from_zero_fold": 16,
    "residual_restrict_fold": 14, "mixed_prolong_smooth_fold": 20, "residual_df_norm_fold": 72,
    "mixed_rb_smooth_msplit": 16, "mixed_rb_smooth_from_zero_msplit": 16,
    "residual_restrict_msplit": 14, "mixed_prolong_smooth_msplit": 20,
    "residual_df_norm_msplit": 72, "rb_smooth_residual_fused": 16 + 9, "residual_df_fused": 70,
    "rb_smooth_seg": 16, "rb_smooth_from_zero_seg": 16, "residual_restrict_seg": 14,
    "prolong_smooth_seg": 20, "residual_df_norm_seg": 72, "residual_seg": 9,
    "mixed_rb_smooth_seg": 16, "mixed_rb_smooth_from_zero_seg": 16, "mixed_prolong_smooth_seg": 20,
    "rb_smooth_seg2d": 16, "rb_smooth_from_zero_seg2d": 16, "residual_restrict_seg2d": 14,
    "prolong_smooth_seg2d": 20, "residual_df_norm_seg2d": 72, "rb_smooth_split_fused": 16,
}
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
F32_OPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores (same sheet)
ES_LENGTH = 3e-4            # the electrospray cube's side: h = 3e-4 / (n - 1)
MIXED_DU_TOL = 1e-7         # V: 33^3 electrospray, CPU against card
FOLD_FULL_RTOL = 1e-7       # of max|u|: 257^3 fold tier against the full tier (tests/test_mixed_fold.py:201)
FIXED_POINT_TOL = 1e-3      # V: 257^3 tier against the f64-outer solve (tests/test_mixed_bc.py:230)
# kernels each 257^3 path must launch (every other kernel: no launch)
_CYCLE = ("rb_smooth_fused", "rb_smooth_from_zero_fused")
_FUSED_CYCLE = _CYCLE + ("residual_restrict_fused", "prolong_smooth_fused")
_FUSED_DF = _FUSED_CYCLE + ("residual_df_norm_fused", "df_step_residual_norm_fused")
PATH_KERNELS = {
    "unfused": _CYCLE + ("residual_fused", "residual_df_norm_fused"),
    "fused": _FUSED_DF,
    "fmg_fused": _FUSED_DF,
    "mixed_pallas": _FUSED_CYCLE,  # its f64 outer residual is plain torch
    # the finest level on pairs, the levels below on the fused cycle. Those
    # are always entered from a zero correction (gamma 1), so K1 makes no
    # launch there.
    "split": ("rb_smooth_from_zero_fused", "residual_restrict_fused", "prolong_smooth_fused",
              "rb_smooth_split", "rb_smooth_split_from_zero", "residual_restrict_split",
              "prolong_smooth_split", "df_step_split", "residual_df_norm_split"),
}
# the electrospray tier: mixed smoothing, the Dirichlet K3 and K5 (its
# outer df_add and BC pass are plain torch, the coarse LU a library call)
ES_KERNELS = ("mixed_rb_smooth_fused", "mixed_rb_smooth_from_zero_fused",
              "mixed_prolong_smooth_fused", "residual_restrict_fused", "residual_df_norm_fused")
# the fold tier: only its own kernels (its outer BC pass and df_add are
# plain torch, the coarse level's fold <-> full conversions torch copies)
FOLD_KERNELS = ("mixed_rb_smooth_fold", "mixed_rb_smooth_from_zero_fold", "residual_restrict_fold",
                "mixed_prolong_smooth_fold", "residual_df_norm_fold")
# the split tier at 257^3 with one inner cycle: every finest-level cycle
# starts from zero (K22, no K21), the levels below on the fold cycle (its
# outer residual is K25, not K20)
MSPLIT_KERNELS = ("mixed_rb_smooth_from_zero_msplit", "residual_restrict_msplit",
                  "mixed_prolong_smooth_msplit", "residual_df_norm_msplit") + FOLD_KERNELS[:4]
# the one-pass stages' calls an outer step of 4 inner V-cycles at 257^3 (7
# levels, coarse_n 5), one launch each: the split path's K8 on the finest
# level's first cycle, 3 K7 on the other three and 4 K10, K2 and K4 on the
# 5 rect levels 129^3 .. 9^3; the fused path's K1 on the finest level's
# cycles 2-4, K2 on its first and on the levels below (1 + 5 x 4), and K4
# on all 6 levels (6 x 4); the unfused path's K1 and K2 as the fused one's,
# and K1 for the post-smoothing of all 6 levels (3 + 6 x 4)
STAGE_CALLS = {
    "split": {"rb_smooth_split_from_zero": 1, "rb_smooth_split": 3, "prolong_smooth_split": 4,
              "rb_smooth_from_zero_fused": 20, "prolong_smooth_fused": 20},
    "fused": {"rb_smooth_fused": 3, "rb_smooth_from_zero_fused": 21, "prolong_smooth_fused": 24},
    "unfused": {"rb_smooth_fused": 27, "rb_smooth_from_zero_fused": 21},
}
INTERLEAVED = 9  # 257^3 solves of each of two paths, in phases 5, 7 and 8
REF_ERR_TOL = 5e-9  # f64 reference solve at 257^3: the C reference's L2 error is 2.81e-9
# the 50^3 study on K1 in f32: the spread of the last 20 per-iteration
# ratios^2 of an f32 study is ~1.1e-4 (their f64 spread 2e-7)
STUDY_TOL = 1e-3
# the CLI's printed f64 error, card against CPU: the error ~2.5e-9 is a
# difference of O(1) values that agree to ~1e-15 (matrix-product sums in
# another order), ~1e-6 relative, printed to 7 digits
CLI_RTOL = 1e-5
SHARDED_RANKS = 4           # simulated (phase 10a) and host-staged gloo (10c) ranks on the one card
SHARDED_DU_TOL = 1e-9       # max|u|: the sharded 257^3 solves against the single-device fused one
SHARDED_NORM_RTOL = 1e-6    # the ranks' partial ||r||^2 summed, against K5's (the sum's order only)
# the f64 sharded V-cycle against the single-device one (tests/test_sharded.py)
SHARDED_F64_TOL = 1e-11
# the kernels of the sharded 257^3 solve (K33, residual_ext, is on no path, as in the JAX
# package): on one rank the plan shards down to 9^3 and gathers the bare 5^3 LU; on four
# it gathers at 9^3, whose replicated cycle runs K2, K3 and K4 on every rank
SEG_KERNELS = ("rb_smooth_seg", "rb_smooth_from_zero_seg", "residual_restrict_seg",
               "prolong_smooth_seg", "residual_df_norm_seg")
SEG_TAIL_KERNELS = ("rb_smooth_from_zero_fused", "residual_restrict_fused",
                    "prolong_smooth_fused")
# the sharded electrospray 257^3 solve: K34-K36 with the Dirichlet K30 and K32 on
# every sharded level, each launched as often as phase 6's full tier launches
# K13-K15, K3 and K5; on four ranks the replicated 9^3 tail runs the full tier
# from a zero correction (K14, K3, K15; no revisit below 65^3, so no K13)
MIXED_SEG_TWINS = {"mixed_rb_smooth_seg": "mixed_rb_smooth_fused",
                   "mixed_rb_smooth_from_zero_seg": "mixed_rb_smooth_from_zero_fused",
                   "mixed_prolong_smooth_seg": "mixed_prolong_smooth_fused",
                   "residual_restrict_seg": "residual_restrict_fused",
                   "residual_df_norm_seg": "residual_df_norm_fused"}
MIXED_SEG_TAIL_KERNELS = ("mixed_rb_smooth_from_zero_fused", "residual_restrict_fused",
                          "mixed_prolong_smooth_fused")
# each of the four gloo ranks' launches in that solve (L = 96; the 9^3 tail's K14, K3
# and K15 too): K34, K35 and K36 one a call since their one-pass stages (210, 840 and
# 1,050 in their first forms)
MIXED_SEG_RANK_LAUNCHES = {"mixed_rb_smooth_seg": 42, "mixed_rb_smooth_from_zero_seg": 168,
                           "mixed_prolong_smooth_seg": 210, "residual_restrict_seg": 210,
                           "residual_df_norm_seg": 15, "mixed_rb_smooth_from_zero_fused": 56,
                           "residual_restrict_fused": 56, "mixed_prolong_smooth_fused": 56}
# of max|u|: the sharded electrospray solves against the full tier and each other
# (tests/test_mixed_fold.py:201's bound; the arithmetic is the same, so 0 is expected)
SHARDED_MIXED_RTOL = 1e-7
# the (i, j)-sharded solve (phase 12): simulated blocks on each mesh shape; the
# four gloo ranks as a 2x2 mesh, and as a 1x4 mesh under NARROW_2D (n_sharded,
# fine_local_i, fine_local_j), whose 9^3 level has Lj = 4 columns, too narrow
# for the 2D kernels' halos: the gate runs the j-replicated tier (K28-K31) there
SHARDED2D_SHAPES = ((1, 1), (2, 2), (4, 1), (1, 4))
NARROW_2D = (6, 320, 128)
# the kernel names of each tier of the (i, j) cycle: smoothing, smoothing from
# zero, residual + restriction, prolongation + smoothing
TIER_KERNELS = {
    "2d": ("rb_smooth_seg2d", "rb_smooth_from_zero_seg2d", "residual_restrict_seg2d",
           "prolong_smooth_seg2d"),
    "j-replicated": ("rb_smooth_seg", "rb_smooth_from_zero_seg", "residual_restrict_seg",
                     "prolong_smooth_seg"),
    "replicated": ("rb_smooth_fused", "rb_smooth_from_zero_fused", "residual_restrict_fused",
                   "prolong_smooth_fused"),
}
# of max|u| (1350 V): the f64 sharded mixed-BC cycle against MixedBCSolver's own
SHARDED_MIXED_F64_RTOL = 1e-11
STAGE_REPS = 20  # phase 13b: CUDA-event rounds of each stage of the splitcolor stage bench


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def time_ms(fn, reps=20):
    """Median device time of fn over reps runs (CUDA events), after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(name, points, inputs, outputs):
    """(bound_ms, bound_by): the least time the card could take for one
    call over ``points`` stored output points, the larger of its bytes
    (each input read once, each output written once; an int in ``inputs``
    is a count of bytes that the call needs) over the memory rate and its
    operations over the f32 rate."""
    nbytes = sum(t if isinstance(t, int) else t.numel() * t.element_size()
                 for t in (*inputs, *outputs))
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = OPS_PER_POINT[name] * points / F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def field_err(got, want):
    err = float((got.double() - want.double()).abs().max())
    tol = FIELD_ULPS * float(np.spacing(np.float32(want.abs().max().item())))
    return err, tol, bool(torch.equal(got, want))


def compare_kernels(pk, ps, pm, pmf, pms, es, dev):
    """Phase 2: each kernel against its plain version at 65^3 and 257^3
    (the mixed ones with the pin planes of the electrospray problem es),
    and K19 and K24 at 17^3."""
    from multigrid_parallel_tpu_torch.utils.timing import split_stage_bytes

    results = {name: {"max_abs_err": 0.0} for name in SOURCES}

    def record(name, n, label, got, want, t_kernel=None, t_plain=None, io=None, points=None,
               bitwise=False):
        err, tol, exact = field_err(got, want)
        if t_kernel is not None:
            results[name]["ms"], results[name]["plain_ms"] = t_kernel, t_plain
            results[name]["bound_ms"], results[name]["bound_by"] = bound(
                name, n ** 3 if points is None else points, *io)
        print(f"[kernel] {name:26s} n={n:3d} {label:14s} max_abs_err={err:.3e} "
              f"(tol {tol:.3e}) bitwise_equal={exact}"
              + (f" kernel_ms={t_kernel:.4f} plain_ms={t_plain:.4f} bound_ms="
                 f"{results[name]['bound_ms']:.4f} ({results[name]['bound_by']})"
                 if t_kernel else ""))
        check(err <= tol, f"{name} n={n} {label}: {err} > {tol}")
        check(exact or not bitwise, f"{name} n={n} {label}: not bitwise equal ({err:.3e})")
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)

    for n in (65, 257):
        h = 1.0 / (n - 1)
        rng = np.random.default_rng(n)
        u, f = (torch.from_numpy(rng.standard_normal((n, n, n)).astype(np.float32)).to(dev)
                for _ in range(2))
        for red_first in (True, False):
            label = "red_first" if red_first else "black_first"
            want = pk.rb_smooth_plain(u, f, h, 2, red_first)
            u0 = u.clone()
            got = pk.rb_smooth_fused(u, f, h, 2, red_first)
            torch.cuda.synchronize()
            check(torch.equal(u, u0), f"rb_smooth_fused n={n} {label}: u changed")
            times = ()
            if red_first:
                times = (time_ms(lambda: pk.rb_smooth_fused(u, f, h, 2, True)),
                         time_ms(lambda: pk.rb_smooth_plain(u, f, h, 2, True)))
                uk = u.clone()
                results["rb_smooth_fused"]["per_sweep_ms"] = time_ms(
                    lambda: pk.rb_smooth_fused_per_sweep(uk, f, h, 2, True))
                print(f"[kernel] rb_smooth_fused            n={n:3d} one-pass K1_ms={times[0]:.4f}"
                      f" per-sweep_ms={results['rb_smooth_fused']['per_sweep_ms']:.4f}")
            record("rb_smooth_fused", n, label, got, want, *times, io=((u, f), (got,)))

            want = pk.rb_smooth_from_zero_plain(f, h, 2, red_first)
            got = pk.rb_smooth_from_zero_fused(f, h, 2, red_first)
            times = ()
            if red_first:
                times = (time_ms(lambda: pk.rb_smooth_from_zero_fused(f, h, 2, True)),
                         time_ms(lambda: pk.rb_smooth_from_zero_plain(f, h, 2, True)))
            record("rb_smooth_from_zero_fused", n, label, got, want, *times, io=((f,), (got,)))

        times = (time_ms(lambda: pk.residual_fused(u, f, h)),
                 time_ms(lambda: pk.residual_plain(u, f, h)))
        record("residual_fused", n, "", pk.residual_fused(u, f, h),
               pk.residual_plain(u, f, h), *times, io=((u, f), (u,)))

        # a double-float state near a solution, where K5 runs
        c = np.arange(n) * h
        x, y, z = np.meshgrid(c, c, c, indexing="ij")
        u64 = x * x - 2 * y * y + z * z + 1e-9 * rng.standard_normal((n, n, n))
        f64 = 1e-6 * rng.standard_normal((n, n, n))
        state = [t.to(dev) for x64 in (u64, f64)
                 for t in pk.df_split(torch.from_numpy(x64))]
        r, nrm2 = pk.residual_df_norm_fused(*state, h)
        r_ref, nrm2_ref = pk.residual_df_norm_plain(*state, h)
        rel = abs(float(nrm2) - float(nrm2_ref)) / float(nrm2_ref)
        print(f"[kernel] residual_df_norm_fused     n={n:3d} norm2={float(nrm2):.9e} "
              f"plain={float(nrm2_ref):.9e} rel_diff={rel:.3e} (tol {NORM_RTOL:g})")
        check(rel <= NORM_RTOL, f"residual_df_norm_fused n={n}: norm rel diff {rel}")
        times = (time_ms(lambda: pk.residual_df_norm_fused(*state, h)),
                 time_ms(lambda: pk.residual_df_norm_plain(*state, h)))
        record("residual_df_norm_fused", n, "r", r, r_ref, *times, io=(state, (r, nrm2)))
        check(torch.equal(r, r_ref), f"residual_df_norm_fused n={n}: r not bitwise equal")

        # K27: K5's residual without its norm
        r27 = pk.residual_df_fused(*state, h)
        check(torch.equal(r27, r), f"residual_df_fused n={n}: r differs from K5's")
        times = (time_ms(lambda: pk.residual_df_fused(*state, h)),
                 time_ms(lambda: pk.residual_df_plain(*state, h)))
        record("residual_df_fused", n, "r", r27, pk.residual_df_plain(*state, h), *times,
               io=(state, (r27,)))
        check(torch.equal(r27, pk.residual_df_plain(*state, h)),
              f"residual_df_fused n={n}: r not bitwise equal")

        # K26: the pre-smoothing stage and its residual (one launch of K1's
        # stage that writes r), against K1 then R; fresh (u', r), u untouched
        for n_iter in (1, 2, 3):
            for red_first in (True, False):
                want_u, want_r = pk.rb_smooth_residual_plain(u, f, h, n_iter, red_first)
                u0 = u.clone()
                before = pk.LAUNCHES["rb_smooth_residual_fused"]
                got_u, got_r = pk.rb_smooth_residual_fused(u, f, h, n_iter, red_first)
                calls = pk.LAUNCHES["rb_smooth_residual_fused"] - before
                torch.cuda.synchronize()
                label = f"n_iter={n_iter}_" + ("red_first" if red_first else "black_first")
                check(torch.equal(u, u0), f"rb_smooth_residual_fused n={n} {label}: u changed")
                check(calls == (n_iter + 1) // 2,
                      f"rb_smooth_residual_fused n={n} {label}: {calls} launches")
                times = ()
                if n_iter == 2 and red_first:  # the pre-smoother of the main paths
                    times = (time_ms(lambda: pk.rb_smooth_residual_fused(u, f, h, 2, True)),
                             time_ms(lambda: pk.rb_smooth_residual_plain(u, f, h, 2, True)))
                record("rb_smooth_residual_fused", n, label + "_u", got_u, want_u)
                record("rb_smooth_residual_fused", n, label + "_r", got_r, want_r, *times,
                       io=((u, f), (got_u, got_r)))
                check(torch.equal(got_u, want_u) and torch.equal(got_r, want_r),
                      f"rb_smooth_residual_fused n={n} {label}: not bitwise equal")
        fused_ms = results["rb_smooth_residual_fused"]["ms"]
        pair_ms = time_ms(lambda: pk.residual_fused(pk.rb_smooth_fused(u, f, h, 2, True), f, h))
        results["rb_smooth_residual_fused"]["pair_ms"] = pair_ms
        print(f"[kernel] rb_smooth_residual_fused   n={n:3d} K26_ms={fused_ms:.4f} "
              f"K1+R_ms={pair_ms:.4f} K26/(K1+R)={fused_ms / pair_ms:.3f} bound_ms="
              f"{results['rb_smooth_residual_fused']['bound_ms']:.4f} (K26's bytes)")
        nrm = pk.residual_norm_fused(u, f, h)
        nrm_ref = pk.residual_norm_plain(u, f, h)
        rel = abs(float(nrm) - float(nrm_ref)) / float(nrm_ref)
        t_norm = (time_ms(lambda: pk.residual_norm_fused(u, f, h)),
                  time_ms(lambda: pk.residual_norm_plain(u, f, h)))
        print(f"[kernel] residual_norm_fused (R + sum) n={n:3d} norm={float(nrm):.9e} "
              f"plain={float(nrm_ref):.9e} rel_diff={rel:.3e} (tol {NORM_RTOL:g}) "
              f"kernel_ms={t_norm[0]:.4f} plain_ms={t_norm[1]:.4f}")
        check(rel <= NORM_RTOL, f"residual_norm_fused n={n}: norm rel diff {rel}")

        # K3 on the random (u, f) as (e, r): the streaming stage, bit for bit
        times = (time_ms(lambda: pk.residual_restrict_fused(u, f, h)),
                 time_ms(lambda: pk.residual_restrict_plain(u, f, h)))
        rc = pk.residual_restrict_fused(u, f, h)
        rc_ref = pk.residual_restrict_plain(u, f, h)
        record("residual_restrict_fused", n, "", rc, rc_ref, *times, io=((u, f), (rc,)))
        check(torch.equal(rc, rc_ref), f"residual_restrict_fused n={n}: not bitwise equal")

        # K4: a coarse correction interpolated into (u, f) as (e, r)
        nc = (n + 1) // 2
        ec = torch.from_numpy(rng.standard_normal((nc, nc, nc)).astype(np.float32)).to(dev)
        for n_iter in (1, 2):
            times = ()
            if n_iter == 2:  # the main path's n_smooth
                times = (time_ms(lambda: pk.prolong_smooth_fused(ec, u, f, h, 2)),
                         time_ms(lambda: pk.prolong_smooth_plain(ec, u, f, h, 2)))
            record("prolong_smooth_fused", n, f"n_iter={n_iter}",
                   pk.prolong_smooth_fused(ec, u, f, h, n_iter),
                   pk.prolong_smooth_plain(ec, u, f, h, n_iter), *times, io=((ec, u, f), (u,)))

        # K6: the K5 state plus a small correction
        d = torch.from_numpy(1e-6 * rng.standard_normal((n, n, n)).astype(np.float32)).to(dev)
        args = (state[0], state[1], d, state[2], state[3], h)
        got = pk.df_step_residual_norm_fused(*args)
        want = pk.df_step_residual_norm_plain(*args)
        rel = abs(float(got[3]) - float(want[3])) / float(want[3])
        print(f"[kernel] df_step_residual_norm_fused n={n:3d} norm2={float(got[3]):.9e} "
              f"plain={float(want[3]):.9e} rel_diff={rel:.3e} (tol {NORM_RTOL:g})")
        check(rel <= NORM_RTOL, f"df_step_residual_norm_fused n={n}: norm rel diff {rel}")
        times = (time_ms(lambda: pk.df_step_residual_norm_fused(*args)),
                 time_ms(lambda: pk.df_step_residual_norm_plain(*args)))
        for label, g, w in zip(("u_hi", "u_lo"), got, want):
            record("df_step_residual_norm_fused", n, label, g, w)
        record("df_step_residual_norm_fused", n, "r", got[2], want[2], *times,
               io=(args[:-1], got))

        # K7-K12 on pairs packed from zero-boundary cubes (dead slots and
        # boundary rows 0, the pair invariant), the colours held one by one
        def record_pair(name, label, got, want, times=(), io=None):
            for colour, g, w in zip(("red", "black"), got, want):
                record(name, n, f"{label}{colour}", g, w,
                       *(times if colour == "black" else ()), io=io)

        inner = torch.zeros((n, n, n), dtype=torch.bool, device=dev)
        inner[1:-1, 1:-1, 1:-1] = True
        e2, r2, d2 = (ps.pack_split(torch.where(inner, x, torch.zeros_like(x)))
                      for x in (u, f, d))
        for red_first in (True, False):
            label = "red_first_" if red_first else "black_first_"
            want = ps.rb_smooth_split_plain(*e2, *r2, h, 2, red_first)
            got = ps.rb_smooth_split(e2[0].clone(), e2[1].clone(), *r2, h, 2, red_first)
            times = ()
            if red_first:
                ek = tuple(x.clone() for x in e2)
                times = (time_ms(lambda: ps.rb_smooth_split(*ek, *r2, h, 2, True)),
                         time_ms(lambda: ps.rb_smooth_split_plain(*e2, *r2, h, 2, True)))
            record_pair("rb_smooth_split", label, got, want, times,
                        io=((split_stage_bytes(n, True),), ()))
            times = ()
            if red_first:
                times = (time_ms(lambda: ps.rb_smooth_split_from_zero(*r2, h, 2, True)),
                         time_ms(lambda: ps.rb_smooth_split_from_zero_plain(*r2, h, 2, True)))
            record_pair("rb_smooth_split_from_zero", label,
                        ps.rb_smooth_split_from_zero(*r2, h, 2, red_first),
                        ps.rb_smooth_split_from_zero_plain(*r2, h, 2, red_first), times,
                        io=((split_stage_bytes(n, True, from_zero=True),), ()))
        times = (time_ms(lambda: ps.residual_restrict_split(*e2, *r2, h)),
                 time_ms(lambda: ps.residual_restrict_split_plain(*e2, *r2, h)))
        rc = ps.residual_restrict_split(*e2, *r2, h)
        rc_ref = ps.residual_restrict_split_plain(*e2, *r2, h)
        record("residual_restrict_split", n, "", rc, rc_ref, *times, io=((*e2, *r2), (rc,)))
        check(torch.equal(rc, rc_ref), f"residual_restrict_split n={n}: not bitwise equal")
        for n_iter in (1, 2):
            times = ()
            if n_iter == 2:
                times = (time_ms(lambda: ps.prolong_smooth_split(ec, *e2, *r2, h, 2)),
                         time_ms(lambda: ps.prolong_smooth_split_plain(ec, *e2, *r2, h, 2)))
            record_pair("prolong_smooth_split", f"n_iter={n_iter}_",
                        ps.prolong_smooth_split(ec, *e2, *r2, h, n_iter),
                        ps.prolong_smooth_split_plain(ec, *e2, *r2, h, n_iter), times,
                        io=((split_stage_bytes(n, False, prolong=True),), ()))
        split_state = [x for t in state for x in ps.pack_split(t)]
        for name, args in (("residual_df_norm_split", split_state),
                           ("df_step_split", split_state[:4] + list(d2) + split_state[4:])):
            kernel, plain = getattr(ps, name), getattr(ps, name + "_plain")
            got, want = kernel(*args, h), plain(*args, h)
            rel = abs(float(got[-1]) - float(want[-1])) / float(want[-1])
            print(f"[kernel] {name:26s} n={n:3d} norm2={float(got[-1]):.9e} "
                  f"plain={float(want[-1]):.9e} rel_diff={rel:.3e} (tol {NORM_RTOL:g})")
            check(rel <= NORM_RTOL, f"{name} n={n}: norm rel diff {rel}")
            times = (time_ms(lambda: kernel(*args, h)), time_ms(lambda: plain(*args, h)))
            if name == "df_step_split":
                record_pair(name, "u_hi_", got[0:2], want[0:2])
                record_pair(name, "u_lo_", got[2:4], want[2:4])
            record_pair(name, "r_", got[-3:-1], want[-3:-1], times, io=(args, got))

        # K3 and K5 at the electrospray's non-dyadic h, on fields with a live
        # boundary (the mixed case)
        h_es = ES_LENGTH / (n - 1)
        rc, rc_ref = pk.residual_restrict_fused(u, f, h_es), pk.residual_restrict_plain(u, f, h_es)
        record("residual_restrict_fused", n, "h=3e-4/(n-1)", rc, rc_ref)
        check(torch.equal(rc, rc_ref),
              f"residual_restrict_fused n={n} h=3e-4/(n-1): not bitwise equal")
        xs = np.linspace(0.0, 1.0, n)[:, None, None]  # volts towards the extractor
        u64 = -1350.0 * xs * xs + 1e-3 * rng.standard_normal((n, n, n))
        es_state = [t.to(dev) for x64 in (u64, 1e3 * rng.standard_normal((n, n, n)))
                    for t in pk.df_split(torch.from_numpy(x64))]
        r, nrm2 = pk.residual_df_norm_fused(*es_state, h_es)
        r_ref, nrm2_ref = pk.residual_df_norm_plain(*es_state, h_es)
        rel = abs(float(nrm2) - float(nrm2_ref)) / float(nrm2_ref)
        check(rel <= NORM_RTOL, f"residual_df_norm_fused n={n} h=3e-4/(n-1): norm rel diff {rel}")
        record("residual_df_norm_fused", n, "h=3e-4/(n-1)", r, r_ref)
        check(torch.equal(r, r_ref), f"residual_df_norm_fused n={n} h=3e-4/(n-1): r differs")

        # K13-K15 with the electrospray's pin planes at the same h, on
        # BC-consistent corrections (where the fold equals the plain copy
        # form), the coarse boundary of K15's ec live
        pin = pm.dirichlet_pin_planes(es, n, dev)
        e_bc = pm.apply_bcs_padded(u, pin)
        r0 = torch.where(inner, f, torch.zeros_like(f))
        for n_iter in (1, 2):
            timed = n_iter == 2  # the main path's n_smooth
            for red_first in (True, False):
                want = pm.mixed_rb_smooth_plain(e_bc, r0, pin, h_es, n_iter, red_first)
                e0 = e_bc.clone()
                got = pm.mixed_rb_smooth_fused(e_bc, r0, pin, h_es, n_iter, red_first)
                torch.cuda.synchronize()
                check(torch.equal(e_bc, e0), f"mixed_rb_smooth_fused n={n}: e changed")
                times = ()
                if timed and red_first:
                    times = (time_ms(lambda: pm.mixed_rb_smooth_fused(e_bc, r0, pin, h_es, 2)),
                             time_ms(lambda: pm.mixed_rb_smooth_plain(e_bc, r0, pin, h_es, 2)))
                label = f"n_iter={n_iter}_" + ("red_first" if red_first else "black_first")
                record("mixed_rb_smooth_fused", n, label, got, want, *times,
                       io=((e_bc, r0, pin), (got,)), bitwise=True)
            got = pm.mixed_rb_smooth_from_zero_fused(r0, pin, h_es, n_iter)
            times = ()
            if timed:
                times = (time_ms(lambda: pm.mixed_rb_smooth_from_zero_fused(r0, pin, h_es, 2)),
                         time_ms(lambda: pm.mixed_rb_smooth_from_zero_plain(r0, pin, h_es, 2)))
            record("mixed_rb_smooth_from_zero_fused", n, f"n_iter={n_iter}", got,
                   pm.mixed_rb_smooth_from_zero_plain(r0, pin, h_es, n_iter), *times,
                   io=((r0, pin), (got,)), bitwise=True)
            got = pm.mixed_prolong_smooth_fused(ec, e_bc, r0, pin, h_es, n_iter)
            times = ()
            if timed:
                times = (time_ms(lambda: pm.mixed_prolong_smooth_fused(ec, e_bc, r0, pin, h_es, 2)),
                         time_ms(lambda: pm.mixed_prolong_smooth_plain(ec, e_bc, r0, pin, h_es, 2)))
            record("mixed_prolong_smooth_fused", n, f"n_iter={n_iter}", got,
                   pm.mixed_prolong_smooth_plain(ec, e_bc, r0, pin, h_es, n_iter), *times,
                   io=((ec, e_bc, r0, pin), (got,)), bitwise=True)

        # K16-K20 on the same fields packed into the fold layout, K21-K25
        # packed into pairs
        compare_fold(pm, pmf, es, n, h_es, u, r0, ec, es_state, dev, record, timed=True)
        compare_msplit(pm, pmf, pms, ps, es, n, h_es, u, r0, ec, es_state, dev, record,
                       timed=True)

    # K2 and K4 at 129^3, the largest rect level of the split path: n_iter
    # 1-3 (n_iter 3: two launches) against their plain versions, timed at
    # the main path's n_iter 2 beside the bound from the bytes a call needs
    n = 129
    h = 1.0 / (n - 1)
    rng = np.random.default_rng(n)
    u, f, ec = (torch.from_numpy(rng.standard_normal((m, m, m)).astype(np.float32)).to(dev)
                for m in (n, n, (n + 1) // 2))
    for n_iter in (1, 2, 3):
        for red_first in (True, False):
            record("rb_smooth_fused", n, f"n_iter={n_iter}_red_first={red_first}",
                   pk.rb_smooth_fused(u, f, h, n_iter, red_first),
                   pk.rb_smooth_plain(u, f, h, n_iter, red_first))
            record("rb_smooth_from_zero_fused", n, f"n_iter={n_iter}_red_first={red_first}",
                   pk.rb_smooth_from_zero_fused(f, h, n_iter, red_first),
                   pk.rb_smooth_from_zero_plain(f, h, n_iter, red_first))
        record("prolong_smooth_fused", n, f"n_iter={n_iter}",
               pk.prolong_smooth_fused(ec, u, f, h, n_iter),
               pk.prolong_smooth_plain(ec, u, f, h, n_iter))
    for name, kernel, plain, io in (
            ("rb_smooth_from_zero_fused", lambda: pk.rb_smooth_from_zero_fused(f, h, 2, True),
             lambda: pk.rb_smooth_from_zero_plain(f, h, 2, True), ((f,), (f,))),
            ("prolong_smooth_fused", lambda: pk.prolong_smooth_fused(ec, u, f, h, 2),
             lambda: pk.prolong_smooth_plain(ec, u, f, h, 2), ((ec, u, f), (u,)))):
        at = dict(zip(("ms", "plain_ms"), (time_ms(kernel), time_ms(plain))))
        at["bound_ms"], at["bound_by"] = bound(name, n ** 3, *io)
        print(f"[kernel] {name:26s} n={n:3d} n_iter=2 kernel_ms={at['ms']:.4f} "
              f"plain_ms={at['plain_ms']:.4f} bound_ms={at['bound_ms']:.4f} ({at['bound_by']})")

    # K1 at every level of the main path (it runs at each on the unfused and
    # FMG paths): the one-pass stage against its per-sweep form, the same
    # call, n_iter 2, red first; event-timed (host launch work included),
    # and device time a call from one trace of 20 calls of each, 10 ms idle
    # at each end of the trace
    for n in (9, 17, 33, 65, 129, 257):
        h = 1.0 / (n - 1)
        u, f = (torch.from_numpy(np.random.default_rng(n + 1).standard_normal((n, n, n))
                                 .astype(np.float32)).to(dev) for _ in range(2))
        uk = u.clone()
        one_pass = time_ms(lambda: pk.rb_smooth_fused(u, f, h, 2, True))
        per_sweep = time_ms(lambda: pk.rb_smooth_fused_per_sweep(uk, f, h, 2, True))
        b_ms, _ = bound("rb_smooth_fused", n ** 3, (u, f), (u,))
        calls, device, seen = 20, [], []
        for fn, per_call in ((lambda: pk.rb_smooth_fused(u, f, h, 2, True), 1),
                             (lambda: pk.rb_smooth_fused_per_sweep(uk, f, h, 2, True), 4)):
            traces = retraced(lambda: device_trace(lambda: [fn() for _ in range(calls)], 0.01),
                              lambda t: t[0] is not None and t[1] == per_call * calls)
            busy, kernels, _, _ = traces[-1]
            check(busy is None or kernels == per_call * calls,
                  f"rb_smooth_fused n={n}: {kernels} kernels traced for {calls} calls "
                  f"(traces: {[t[1] for t in traces]})")
            device.append("not measured" if busy is None else f"{busy / calls:.4f}")
            seen.append([t[1] for t in traces])
        print(f"[kernel] rb_smooth_fused by level n={n:3d} one-pass_ms={one_pass:.4f} "
              f"per-sweep_ms={per_sweep:.4f} one-pass/per-sweep={one_pass / per_sweep:.3f} "
              f"| device ms a call: one-pass {device[0]} per-sweep {device[1]} | "
              f"bound_ms={b_ms:.4f} | kernels a trace {seen}")

    # K19 and K24 where the pin-edge delta is live: 17^3, coarse level 9^3;
    # K14 and K15 (one-pass stages) at 17^3 too, where the plan's blocks are
    # 1-plane, 1-row boxes
    n = 17
    rng = np.random.default_rng(n)
    u, f, ec = (torch.from_numpy(rng.standard_normal((m, m, m)).astype(np.float32)).to(dev)
                for m in (n, n, (n + 1) // 2))
    inner = torch.zeros((n, n, n), dtype=torch.bool, device=dev)
    inner[1:-1, 1:-1, 1:-1] = True
    h, r = ES_LENGTH / (n - 1), torch.where(inner, f, 0 * f)
    pin = pm.dirichlet_pin_planes(es, n, dev)
    for n_iter in (1, 2):
        record("mixed_rb_smooth_from_zero_fused", n, f"n_iter={n_iter}",
               pm.mixed_rb_smooth_from_zero_fused(r, pin, h, n_iter),
               pm.mixed_rb_smooth_from_zero_plain(r, pin, h, n_iter), bitwise=True)
        record("mixed_prolong_smooth_fused", n, f"n_iter={n_iter}",
               pm.mixed_prolong_smooth_fused(ec, u, r, pin, h, n_iter),
               pm.mixed_prolong_smooth_plain(ec, u, r, pin, h, n_iter), bitwise=True)
    compare_fold(pm, pmf, es, n, h, u, r, ec, None, dev, record, timed=False)
    compare_msplit(pm, pmf, pms, ps, es, n, h, u, r, ec, None, dev, record, timed=False)
    return results


def launched(mod, name, fn):
    """fn()'s result and the launches of ``mod``'s kernel ``name`` it made."""
    before = mod.LAUNCHES[name]
    out = fn()
    return out, mod.LAUNCHES[name] - before


def compare_fold(pm, pmf, es, n, h, u, r, ec, es_state, dev, record, timed):
    """K16-K20 against their plain versions at size n: the fold fields
    packed from u after a BC pass (the cycle's fields are BC-consistent)
    and from the zero-boundary r, the coarse correction from ec after the
    coarse level's BC pass, K19 with the coarse level's sign planes (zero
    at 33^3 and above in this geometry), K20 on the packed double-float
    state es_state (skipped when None). Timed at n_iter = 2 when
    ``timed``, else (17^3) K19's delta check and K18 only. K16, K17 and
    K19, one-pass stages, bit for bit, K16 one launch a call at n_iter <=
    2 and e left as it is; K18, a launch a call on either of its forms,
    bit for bit."""
    nc = (n + 1) // 2
    pin_full = pm.dirichlet_pin_planes(es, n, dev)
    pin = pmf.pack_fold(pin_full)
    fe, fr = pmf.pack_fold(pm.apply_bcs_padded(u, pin_full)), pmf.pack_fold(r)
    fec = pmf.pack_fold(pm.apply_bcs_padded(ec, pm.dirichlet_pin_planes(es, nc, dev)))
    sgn = pmf.fold_edge_sign_planes(es, nc, dev)
    points = n * n * (n - 2)
    check(bool(sgn.any()) == (nc <= 17), f"fold sign planes at {nc}^3: nonzero={bool(sgn.any())}")

    def restrict(label, times=()):
        rc, calls = launched(pmf, "residual_restrict_fold",
                             lambda: pmf.residual_restrict_fold(fe, fr, h))
        check(calls == 1, f"residual_restrict_fold n={n}: {calls} launches a call")
        form = "stage" if n >= pmf.ps.FOLD_RESTRICT_STAGE_MIN_N else "first_form"
        record("residual_restrict_fold", n, f"{form}{label}", rc,
               pmf.residual_restrict_fold_plain(fe, fr, h), *times, io=((fe, fr), (rc,)),
               points=points, bitwise=True)

    if not timed:  # the delta check and K18's first form
        for n_iter in (1, 2):
            record("mixed_prolong_smooth_fold", n, f"n_iter={n_iter}_delta",
                   pmf.mixed_prolong_smooth_fold(fec, fe, fr, pin, sgn, h, n_iter),
                   pmf.mixed_prolong_smooth_fold_plain(fec, fe, fr, pin, sgn, h, n_iter),
                   bitwise=True)
        restrict("")
        return
    e0 = fe.clone()
    for n_iter in (1, 2):
        t2 = n_iter == 2  # the main path's n_smooth
        for red_first in (True, False):
            times = ()
            if t2 and red_first:
                times = (time_ms(lambda: pmf.mixed_rb_smooth_fold(fe, fr, pin, h, 2)),
                         time_ms(lambda: pmf.mixed_rb_smooth_fold_plain(fe, fr, pin, h, 2)))
            got, calls = launched(pmf, "mixed_rb_smooth_fold", lambda: pmf.mixed_rb_smooth_fold(
                fe, fr, pin, h, n_iter, red_first))
            check(calls == 1, f"mixed_rb_smooth_fold n={n}: {calls} launches a call")
            record("mixed_rb_smooth_fold", n,
                   f"n_iter={n_iter}_" + ("red_first" if red_first else "black_first"), got,
                   pmf.mixed_rb_smooth_fold_plain(fe, fr, pin, h, n_iter, red_first), *times,
                   io=((fe, fr, pin), (got,)), points=points, bitwise=True)
        got = pmf.mixed_rb_smooth_from_zero_fold(fr, pin, h, n_iter)
        times = ()
        if t2:
            times = (time_ms(lambda: pmf.mixed_rb_smooth_from_zero_fold(fr, pin, h, 2)),
                     time_ms(lambda: pmf.mixed_rb_smooth_from_zero_fold_plain(fr, pin, h, 2)))
        record("mixed_rb_smooth_from_zero_fold", n, f"n_iter={n_iter}", got,
               pmf.mixed_rb_smooth_from_zero_fold_plain(fr, pin, h, n_iter), *times,
               io=((fr, pin), (got,)), points=points, bitwise=True)
        got = pmf.mixed_prolong_smooth_fold(fec, fe, fr, pin, sgn, h, n_iter)
        times = ()
        if t2:
            times = (time_ms(lambda: pmf.mixed_prolong_smooth_fold(fec, fe, fr, pin, sgn, h, 2)),
                     time_ms(lambda: pmf.mixed_prolong_smooth_fold_plain(fec, fe, fr, pin, sgn,
                                                                         h, 2)))
        record("mixed_prolong_smooth_fold", n, f"n_iter={n_iter}", got,
               pmf.mixed_prolong_smooth_fold_plain(fec, fe, fr, pin, sgn, h, n_iter), *times,
               io=((fec, fe, fr, pin, sgn), (got,)), points=points, bitwise=True)
    torch.cuda.synchronize()
    check(torch.equal(fe, e0), f"mixed_rb_smooth_fold n={n}: e changed")
    restrict("", (time_ms(lambda: pmf.residual_restrict_fold(fe, fr, h)),
                  time_ms(lambda: pmf.residual_restrict_fold_plain(fe, fr, h))))
    state = [pmf.pack_fold(t) for t in es_state]
    r20, nrm2 = pmf.residual_df_norm_fold(*state, h)
    r_ref, nrm2_ref = pmf.residual_df_norm_fold_plain(*state, h)
    rel = abs(float(nrm2) - float(nrm2_ref)) / float(nrm2_ref)
    print(f"[kernel] residual_df_norm_fold      n={n:3d} norm2={float(nrm2):.9e} "
          f"plain={float(nrm2_ref):.9e} rel_diff={rel:.3e} (tol {NORM_RTOL:g})")
    check(rel <= NORM_RTOL, f"residual_df_norm_fold n={n}: norm rel diff {rel}")
    times = (time_ms(lambda: pmf.residual_df_norm_fold(*state, h)),
             time_ms(lambda: pmf.residual_df_norm_fold_plain(*state, h)))
    record("residual_df_norm_fold", n, "r", r20, r_ref, *times, io=(state, (r20, nrm2)),
           points=points)
    check(torch.equal(r20, r_ref), f"residual_df_norm_fold n={n}: r not bitwise equal")


def compare_msplit(pm, pmf, pms, ps, es, n, h, u, r, ec, es_state, dev, record, timed):
    """K21-K25 against their plain versions at size n, on the fields of
    compare_fold packed into pairs (the cycle's pairs are BC-consistent,
    their dead slots 0), with the electrospray's pin packs and the coarse
    level's fold correction and sign planes; K25 on the packed
    double-float state es_state. K21-K24 bit for bit at every size; K25
    only when ``timed``, the others timed then at n_iter = 2 (17^3, not
    timed: K24's delta check, K21-K23 on its plans)."""
    nc = (n + 1) // 2
    packs = pms.msplit_pin_packs(es, n, dev)
    e2 = ps.pack_split(pm.apply_bcs_padded(u, pm.dirichlet_pin_planes(es, n, dev)))
    r2 = ps.pack_split(r)
    fec = pmf.pack_fold(pm.apply_bcs_padded(ec, pm.dirichlet_pin_planes(es, nc, dev)))
    sgn = pmf.fold_edge_sign_planes(es, nc, dev)
    points = 2 * n * n * ps.split_shape(n)[2]

    def record_pair(name, label, got, want, times=(), io=None, bitwise=False):
        for colour, g, w in zip(("red", "black"), got, want):
            record(name, n, f"{label}{colour}", g, w, *(times if colour == "black" else ()),
                   io=io, points=points, bitwise=bitwise)

    for n_iter in (1, 2):
        t2 = timed and n_iter == 2  # the main path's n_smooth
        times = ()
        if t2:
            times = (time_ms(lambda: pms.mixed_prolong_smooth_msplit(fec, *e2, *r2, packs, sgn, h,
                                                                     2)),
                     time_ms(lambda: pms.mixed_prolong_smooth_msplit_plain(fec, *e2, *r2, packs,
                                                                           sgn, h, 2)))
        got = pms.mixed_prolong_smooth_msplit(fec, *e2, *r2, packs, sgn, h, n_iter)
        record_pair("mixed_prolong_smooth_msplit",
                    f"n_iter={n_iter}_" + ("" if timed else "delta_"), got,
                    pms.mixed_prolong_smooth_msplit_plain(fec, *e2, *r2, packs, sgn, h, n_iter),
                    times, io=((fec, *e2, *r2, packs, sgn), got), bitwise=True)
        got = pms.mixed_rb_smooth_from_zero_msplit(*r2, packs, h, n_iter)
        times = ()
        if t2:
            times = (time_ms(lambda: pms.mixed_rb_smooth_from_zero_msplit(*r2, packs, h, 2)),
                     time_ms(lambda: pms.mixed_rb_smooth_from_zero_msplit_plain(*r2, packs, h,
                                                                                2)))
        record_pair("mixed_rb_smooth_from_zero_msplit", f"n_iter={n_iter}_", got,
                    pms.mixed_rb_smooth_from_zero_msplit_plain(*r2, packs, h, n_iter), times,
                    io=((*r2, packs), got), bitwise=True)
        for red_first in (True, False):
            got = pms.mixed_rb_smooth_msplit(*e2, *r2, packs, h, n_iter, red_first)
            times = ()
            if t2 and red_first:
                times = (time_ms(lambda: pms.mixed_rb_smooth_msplit(*e2, *r2, packs, h, 2)),
                         time_ms(lambda: pms.mixed_rb_smooth_msplit_plain(*e2, *r2, packs, h, 2)))
            record_pair("mixed_rb_smooth_msplit",
                        f"n_iter={n_iter}_" + ("red_first_" if red_first else "black_first_"),
                        got,
                        pms.mixed_rb_smooth_msplit_plain(*e2, *r2, packs, h, n_iter, red_first),
                        times, io=((*e2, *r2, packs), got), bitwise=True)
    rc = pms.residual_restrict_msplit(*e2, *r2, h)
    times = ()
    if timed:
        times = (time_ms(lambda: pms.residual_restrict_msplit(*e2, *r2, h)),
                 time_ms(lambda: pms.residual_restrict_msplit_plain(*e2, *r2, h)))
    record("residual_restrict_msplit", n, "", rc, pms.residual_restrict_msplit_plain(*e2, *r2, h),
           *times, io=((*e2, *r2), (rc,)), points=points, bitwise=True)
    if not timed:
        return
    state = [x for t in es_state for x in ps.pack_split(t)]
    got, want = pms.residual_df_norm_msplit(*state, h), pms.residual_df_norm_msplit_plain(*state, h)
    rel = abs(float(got[2]) - float(want[2])) / float(want[2])
    print(f"[kernel] residual_df_norm_msplit    n={n:3d} norm2={float(got[2]):.9e} "
          f"plain={float(want[2]):.9e} rel_diff={rel:.3e} (tol {NORM_RTOL:g})")
    check(rel <= NORM_RTOL, f"residual_df_norm_msplit n={n}: norm rel diff {rel}")
    check(all(torch.equal(g, w) for g, w in zip(got[:2], want[:2])),
          f"residual_df_norm_msplit n={n}: r not bitwise equal")
    times = (time_ms(lambda: pms.residual_df_norm_msplit(*state, h)),
             time_ms(lambda: pms.residual_df_norm_msplit_plain(*state, h)))
    record_pair("residual_df_norm_msplit", "r_", got[:2], want[:2], times, io=(state, got))


def device_trace(fn, guard_s=0.0):
    """(busy ms, kernels, by_name, span ms) of one traced call of fn
    (``utils.split_trace.device_trace``)."""
    from multigrid_parallel_tpu_torch.utils.split_trace import device_trace as trace

    return trace(fn, guard_s)


def _launch_modules():
    from multigrid_parallel_tpu_torch.ops import pallas3d, pallas_mixed, pallas_mixed_fold
    from multigrid_parallel_tpu_torch.ops import pallas_mixed_split, pallas_sharded, pallas_split
    from multigrid_parallel_tpu_torch.ops import pallas_sharded2d, pallas_splitcolor

    return (pallas3d, pallas_split, pallas_mixed, pallas_mixed_fold, pallas_mixed_split,
            pallas_sharded, pallas_sharded2d, pallas_splitcolor)


def retraced(trace, complete, tries=6, pause_s=0.25):
    """The traces taken by calling trace() until one is complete(), at
    most ``tries``, the device drained and idle for ``pause_s`` before each
    retry: the profiler now and then loses a trace's kernel events, some or
    all of them, though the traced calls launch the same kernels every time
    (``utils.trace_drops`` counts such traces), and the losses come in runs
    of consecutive traces that lose fewer each time (kernels seen at 257^3:
    5, 8, 20 and 1, 8, 18 of 20)."""
    out = [trace()]
    while not complete(out[-1]) and len(out) < tries:
        torch.cuda.synchronize()
        time.sleep(pause_s)
        out.append(trace())
    return out


def reset_launches():
    for mod in _launch_modules():
        mod.reset_launches()


def read_launches():
    return {name: count for mod in _launch_modules() for name, count in mod.LAUNCHES.items()}


def es_solver(es, dev):
    """The production electrospray configuration at 257^3 (docs/MIXED_BC.md
    section 4): gamma 2, gamma_min_n 65 = finest / 4, n_smooth 2."""
    import multigrid_parallel_tpu_torch as mg
    from multigrid_parallel_tpu_torch.mixed_bc import MixedBCSolver

    hier = mg.Hierarchy(ndim=3, coarse_n=5, num_levels=7, length=es.length)
    return MixedBCSolver(es, hier, n_smooth=2, gamma=2, gamma_min_n=(hier.finest_n - 1) // 4 + 1,
                         device=dev)


def electrospray_257(es, dev, card, launches):
    """Phase 6: the production electrospray solve at 257^3 on the full
    kernel tier (one inner cycle) with the launch counts reset just before
    and read just after (added into ``launches``); then its wall and
    device-busy time and its solution against the f64-outer
    MixedBCSolver.solve_on_device on the card. Returns (u, outer steps,
    solve, launch counts) for phases 7 and 11."""
    from multigrid_parallel_tpu_torch import mixed_padded as mp
    from multigrid_parallel_tpu_torch.models.electrospray import EXTRACTOR_VOLTAGE
    from multigrid_parallel_tpu_torch.ops import pallas3d as pk

    solver = es_solver(es, dev)
    hier = solver.hier
    n = hier.finest_n
    run = mp.make_mixed_padded_df_solver(solver, rel_tol=REL_TOL, max_cycles=100,
                                         inner_cycles=1)
    state = mp.setup_mixed_df_problem(solver)
    n0 = float(torch.sqrt(pk.residual_df_norm_fused(*state, hier.spacing(6))[1]))
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    out = run(*state)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = read_launches()
    u, nrm, it = mp.unpack_mixed_solution(out[0], out[1], hier), float(out[2]), out[3]
    print(f"[solve {n}^3 electrospray] outer_steps={it} final_norm={nrm:.6e} n0={n0:.6e} "
          f"rel={nrm / n0:.3e} min_V={float(u.min()):.6f} max_V={float(u.max()):.6f} "
          f"finite={bool(torch.isfinite(u).all())} shape={tuple(u.shape)}")
    print(f"[launches {n}^3 electrospray] {json.dumps(counts)}")
    check(tuple(u.shape) == (n, n, n) and bool(torch.isfinite(u).all()),
          "electrospray: solution not finite")
    check(13 <= it <= 15, f"electrospray: {it} outer steps, expected 14 +- 1")
    check(nrm <= REL_TOL * n0, f"electrospray not converged: {nrm} > {REL_TOL} * {n0}")
    check(float(u.min()) >= EXTRACTOR_VOLTAGE - 1e-3 and float(u.max()) <= 1e-3,
          "electrospray: potential outside the electrode voltages")
    for name in SOURCES:
        check((counts[name] > 0) == (name in ES_KERNELS),
              f"electrospray: kernel {name} launched {counts[name]} times in the {n}^3 solve")
        launches[name] += counts[name]
    top = hier.num_levels - 1
    check_stage_launches(counts, cycle_calls(solver, top, True, new_calls(FULL_STAGES)), it,
                         solver.n_smooth, f"{n}^3 electrospray", FULL_STAGES)
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = run(*state)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        check(again[3] == it, "electrospray: outer-step count changed between runs")
    busy, n_kernels, by_name, _ = device_trace(lambda: run(*state))
    busy_s = "not measured" if busy is None else f"{busy:.3f} ms over {n_kernels} kernels"
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    print(f"[device time {n}^3 electrospray] "
          + "; ".join(f"{name}: {ms:.3f} ms / {count}" for name, (ms, count) in top))
    print(f"[wall {n}^3 electrospray] first_run_s={first_s:.4f} "
          f"median_of_5_s={statistics.median(walls):.4f} runs_s={[round(w, 4) for w in walls]} "
          f"device_busy={busy_s} card: {card}")
    t0 = time.perf_counter()
    u_ref, nrm_ref, it_ref, init_ref = solver.solve_on_device(rel_tol=REL_TOL, max_cycles=100,
                                                               inner_cycles=1)
    torch.cuda.synchronize()
    du = float((u - u_ref).abs().max())
    print(f"[electrospray {n}^3 tier vs f64-outer solve_on_device] outer_steps {it} vs {it_ref} "
          f"max|du|={du:.3e} V (tol {FIXED_POINT_TOL:g}) f64_rel={nrm_ref / init_ref:.3e} "
          f"f64_wall_s={time.perf_counter() - t0:.3f}")
    check(abs(it - it_ref) <= 1, f"electrospray: {it} outer steps against {it_ref} in f64")
    check(du <= FIXED_POINT_TOL, f"electrospray: tier and f64 solutions differ by {du} V")
    print_stage_times(lambda: run(*state), solver, f"{n}^3 electrospray", card, FULL_STAGES)
    return u, it, lambda: run(*state), counts


def fold_257(es, dev, card, launches, full):
    """Phase 7: the production electrospray solve at 257^3 on the fold
    tier, launch counts reset just before and read just after (added into
    ``launches``): only K16-K20, the full tier's outer-step count, the
    full tier's solution (``full``: phase 6's (u, outer steps, solve, counts))
    within 1e-7 max|u|; then the fold and full walls interleaved and the
    device-busy time of one traced solve of each."""
    from multigrid_parallel_tpu_torch import mixed_padded as mp
    from multigrid_parallel_tpu_torch.ops import pallas_mixed_fold as pmf

    solver = es_solver(es, dev)
    n = solver.hier.finest_n
    run = mp.make_mixed_fold_df_solver(solver, rel_tol=REL_TOL, max_cycles=100, inner_cycles=1)
    state = mp.setup_mixed_fold_df_problem(solver)
    n0 = float(torch.sqrt(pmf.residual_df_norm_fold(*state, solver.hier.spacing(solver.hier.num_levels - 1))[1]))
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    out = run(*state)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = read_launches()
    u, nrm, it = mp.unpack_mixed_fold_solution(out[0], out[1], solver), float(out[2]), out[3]
    u_full, it_full, solve_full, _ = full
    scale = float(u_full.abs().max())
    du = float((u - u_full).abs().max())
    print(f"[solve {n}^3 electrospray fold] outer_steps={it} final_norm={nrm:.6e} n0={n0:.6e} "
          f"rel={nrm / n0:.3e} finite={bool(torch.isfinite(u).all())} shape={tuple(u.shape)} "
          f"| full tier: outer_steps={it_full} max|u_fold-u_full|={du:.3e} V "
          f"(tol {FOLD_FULL_RTOL:g} * {scale:g}) first_run_s={first_s:.4f}")
    print(f"[launches {n}^3 electrospray fold] {json.dumps(counts)}")
    check(tuple(u.shape) == (n, n, n) and bool(torch.isfinite(u).all()),
          "fold: solution not finite")
    check(nrm <= REL_TOL * n0, f"fold not converged: {nrm} > {REL_TOL} * {n0}")
    check(it == it_full, f"fold: {it} outer steps against the full tier's {it_full}")
    check(du <= FOLD_FULL_RTOL * scale, f"fold: solution differs from the full tier's by {du} V")
    for name in SOURCES:
        check((counts[name] > 0) == (name in FOLD_KERNELS),
              f"fold: kernel {name} launched {counts[name]} times in the {n}^3 solve")
        launches[name] += counts[name]
    top = solver.hier.num_levels - 1
    calls = cycle_calls(solver, top, True, new_calls(FOLD_STAGES))
    check_stage_launches(counts, calls, it, solver.n_smooth, f"{n}^3 electrospray fold",
                         FOLD_STAGES)
    check_fold_restrict_launches(counts, calls, it, f"{n}^3 electrospray fold")
    solve = lambda: run(*state)  # noqa: E731
    interleave({"fold": solve, "full": solve_full}, f"{n}^3 electrospray", card)
    print_device_time({"fold": solve, "full": solve_full}, f"{n}^3 electrospray", card)
    print_stage_times(solve, solver, f"{n}^3 electrospray fold", card, FOLD_STAGES)
    return u, it, solve


# each mixed-BC cycle's smoothing stages: where a level's correction is
# revisited (K13, K16), entered from zero (K14, K17) and the prolongation
# (K15, K19), in that order; one-pass stages of ceil(n_smooth / 2) launches
# a call
FULL_STAGES = {"K13": "mixed_rb_smooth_fused", "K14": "mixed_rb_smooth_from_zero_fused",
               "K15": "mixed_prolong_smooth_fused"}
FOLD_STAGES = {"K16": "mixed_rb_smooth_fold", "K17": "mixed_rb_smooth_from_zero_fold",
               "K19": "mixed_prolong_smooth_fold"}
# the msplit tier's finest level: K21 where its correction is revisited,
# K22 from zero and K24 (one-pass stages; their first forms took 2 n_smooth
# + 1, 2 n_smooth + 1 and 2 n_smooth + 2 launches a call)
MSPLIT_STAGES = {"K21": "mixed_rb_smooth_msplit", "K22": "mixed_rb_smooth_from_zero_msplit",
                 "K24": "mixed_prolong_smooth_msplit"}


def new_calls(stages):
    return dict.fromkeys(stages, 0)


def cycle_calls(solver, level, from_zero, calls):
    """Add to ``calls`` (keyed as FULL_STAGES or FOLD_STAGES: revisit,
    from zero, prolongation) the stage calls of one mixed-cycle descent at
    ``level`` (mixed_padded._make_mixed_descend's and
    _make_mixed_descend_fold's recursion, walked without running it: the
    from-zero stage where a level is entered from zero, the revisit stage
    where its correction is revisited, the prolongation once a call) and
    return it."""
    revisit, zero, prolong = calls
    if level == 0:
        return calls
    calls[zero if from_zero else revisit] += 1
    cycle_calls(solver, level - 1, True, calls)
    for _ in range(solver._revisits(level - 1)):
        cycle_calls(solver, level - 1, False, calls)
    calls[prolong] += 1
    return calls


def check_stage_launches(counts, calls, steps, n_smooth, what, stages, first_forms=None):
    """A mixed cycle's stage launches in a solve of ``steps`` outer steps,
    ``calls`` those of one step: the one-pass stages one launch per two
    iterations a call, each exactly; printed beside the first forms'
    launches a call (``first_forms`` by stage, else 2 n_smooth + 1)."""
    chunks = -(-n_smooth // 2)
    first = {k: 2 * n_smooth + 1 for k in stages} | (first_forms or {})
    for key, name in stages.items():
        want = steps * calls[key] * chunks
        check(counts[name] == want, f"{what}: {name} launched {counts[name]} times, expected "
              f"{want} ({steps} outer steps x {calls[key]} calls x {chunks})")
    fewer = sum(steps * calls[k] * (first[k] - chunks) for k in stages)
    print(f"[launches {what} stages] "
          + "; ".join(f"{k}: {steps * calls[k]} calls, {counts[name]} launches (first form "
                      f"{steps * calls[k] * first[k]})" for k, name in stages.items())
          + f" | {fewer} launches fewer than the first forms of " + ", ".join(stages))


def check_fold_restrict_launches(counts, calls, steps, what):
    """K18 in a solve of ``steps`` outer steps: one launch a call, a call
    each fold-cycle level visit, as many as K19's (``calls``: one step's,
    keyed as FOLD_STAGES), exactly."""
    want = steps * calls["K19"]
    got = counts["residual_restrict_fold"]
    check(got == want, f"{what}: residual_restrict_fold launched {got} times, expected {want} "
          f"({steps} outer steps x {calls['K19']} calls)")
    print(f"[launches {what} K18] {got} launches, {steps * calls['K19']} calls")


def print_stage_times(solve, solver, what, card, stages):
    """The device time a call by level of the ``stages``' calls, from one
    traced solve (``utils.split_trace.stage_calls``: [calls, summed ms,
    median ms a call])."""
    from multigrid_parallel_tpu_torch.utils.split_trace import (_stage_sizes, kernel_intervals,
                                                                stage_calls)

    sizes = _stage_sizes(solver.hier, torch.cuda.get_device_properties(0).multi_processor_count)
    intervals = retraced(lambda: kernel_intervals(solve), bool)[-1]
    calls = stage_calls(intervals, sizes, solver.n_smooth)
    mine = {k: v for k, v in calls.items() if k.split()[0] in stages}
    check(bool(mine), f"{what}: no {', '.join(stages)} call in the trace")
    print(f"[stage calls {what}] {json.dumps(mine)} card: {card}")


def print_device_time(solves, what, card):
    """The device-busy time and the top kernels of one traced run of each
    solve in ``solves``, and the device's idle share of the span from the
    run's first kernel to its last."""
    for label, solve in solves.items():
        busy, n_kernels, by_name, span = device_trace(solve)
        busy_s = "not measured" if busy is None else (
            f"{busy:.3f} ms over {n_kernels} kernels, device span {span:.3f} ms, idle share "
            f"{1 - busy / span:.1%}")
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
        print(f"[device time {what} {label}] busy={busy_s} | "
              + "; ".join(f"{name}: {ms:.3f} ms / {count}" for name, (ms, count) in top)
              + f" | card: {card}")


def msplit_257(es, dev, card, launches, fold):
    """Phase 8: the production electrospray solve at 257^3 on the split
    tier, launch counts reset just before and read just after (added into
    ``launches``): only K22-K25 and K16-K19, K16, K17 and K19 exactly as
    the fold cycle below needs, K22 and K24 exactly one launch a call (one
    finest-level cycle an outer step), the fold tier's outer-step count,
    converged to 1e-8 of its initial norm, the fold tier's solution
    (``fold``: phase 7's (u, outer steps, solve)) within 1e-7 max|u|; then
    the split and fold walls interleaved, the device-busy time of one
    traced solve of each, and the stages' device time a call by level."""
    from multigrid_parallel_tpu_torch import mixed_padded as mp
    from multigrid_parallel_tpu_torch.ops import pallas_mixed_split as pms

    solver = es_solver(es, dev)
    n = solver.hier.finest_n
    run = mp.make_mixed_split_df_solver(solver, rel_tol=REL_TOL, max_cycles=100, inner_cycles=1)
    state = mp.setup_mixed_split_df_problem(solver)
    n0 = float(torch.sqrt(pms.residual_df_norm_msplit(*state, solver.hier.spacing(solver.hier.num_levels - 1))[2]))
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    out = run(*state)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = read_launches()
    u, nrm, it = mp.unpack_mixed_split_solution(*out[:4], solver), float(out[4]), out[5]
    u_fold, it_fold, solve_fold = fold
    scale = float(u_fold.abs().max())
    du = float((u - u_fold).abs().max())
    print(f"[solve {n}^3 electrospray msplit] outer_steps={it} final_norm={nrm:.6e} n0={n0:.6e} "
          f"rel={nrm / n0:.3e} finite={bool(torch.isfinite(u).all())} shape={tuple(u.shape)} "
          f"| fold tier: outer_steps={it_fold} max|u_msplit-u_fold|={du:.3e} V "
          f"(tol {FOLD_FULL_RTOL:g} * {scale:g}) first_run_s={first_s:.4f}")
    print(f"[launches {n}^3 electrospray msplit] {json.dumps(counts)}")
    check(tuple(u.shape) == (n, n, n) and bool(torch.isfinite(u).all()),
          "msplit: solution not finite")
    check(nrm <= REL_TOL * n0, f"msplit not converged: {nrm} > {REL_TOL} * {n0}")
    check(it == it_fold, f"msplit: {it} outer steps against the fold tier's {it_fold}")
    check(du <= FOLD_FULL_RTOL * scale, f"msplit: solution differs from the fold tier's by {du} V")
    for name in SOURCES:
        check((counts[name] > 0) == (name in MSPLIT_KERNELS),
              f"msplit: kernel {name} launched {counts[name]} times in the {n}^3 solve")
        launches[name] += counts[name]
    below = solver.hier.num_levels - 2  # the fold cycle's top level: entered from zero, revisited
    calls = cycle_calls(solver, below, True, new_calls(FOLD_STAGES))
    for _ in range(solver._revisits(below)):
        cycle_calls(solver, below, False, calls)
    check_stage_launches(counts, calls, it, solver.n_smooth, f"{n}^3 electrospray msplit",
                         FOLD_STAGES)
    check_fold_restrict_launches(counts, calls, it, f"{n}^3 electrospray msplit")
    # the finest level: one cycle an outer step, entered from zero (inner_cycles 1)
    check_stage_launches(counts, {"K21": 0, "K22": 1, "K24": 1}, it, solver.n_smooth,
                         f"{n}^3 electrospray msplit finest", MSPLIT_STAGES,
                         {"K24": 2 * solver.n_smooth + 2})
    solve = lambda: run(*state)  # noqa: E731
    interleave({"msplit": solve, "fold": solve_fold}, f"{n}^3 electrospray", card)
    print_device_time({"msplit": solve, "fold": solve_fold}, f"{n}^3 electrospray", card)
    print_stage_times(solve, solver, f"{n}^3 electrospray msplit", card,
                      {**FOLD_STAGES, **MSPLIT_STAGES})


def interleave(solves, what, card, reps=INTERLEAVED):
    """The walls (host clock) and CUDA-event spans of the two solves in
    ``solves``, interleaved run by run (alternating which goes first),
    ``reps`` each; prints the medians and the pairs."""
    a, b = solves
    walls = {a: [], b: []}
    spans = {a: [], b: []}
    for rep in range(reps):
        for label in (a, b) if rep % 2 == 0 else (b, a):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            solves[label]()
            end.record()
            torch.cuda.synchronize()
            walls[label].append(1e3 * (time.perf_counter() - t0))
            spans[label].append(start.elapsed_time(end))
    med = {k: statistics.median(v) for k, v in walls.items()}
    med_span = {k: statistics.median(v) for k, v in spans.items()}
    print(f"[interleaved {what} {a} vs {b}] runs={reps} each | wall median ms: "
          f"{a}={med[a]:.3f} {b}={med[b]:.3f} {a}/{b}={med[a] / med[b]:.3f} | event span "
          f"median ms: {a}={med_span[a]:.3f} {b}={med_span[b]:.3f} | pairs ({a}, {b}) "
          f"ms={[(round(x, 3), round(y, 3)) for x, y in zip(walls[a], walls[b])]} | card: {card}")


def reference_257(dev, card):
    """Phase 9a: the f64 reference solve at 257^3 (plain torch, no hand
    kernel) through each of its entry points: converged, 16 +- 1 V-cycles
    (FMG: at most 17), L2 error <= REF_ERR_TOL; the wall (median of 3) and
    the device-busy time of one traced solve of each."""
    import multigrid_parallel_tpu_torch as mg
    from multigrid_parallel_tpu_torch.hierarchy import evaluate_on_grid

    prob = mg.poisson_3d_quadratic()
    hier = mg.Hierarchy(ndim=3, coarse_n=5, num_levels=7)
    cfg = mg.CycleConfig(n_smooth=2)
    exact = evaluate_on_grid(prob.analytic, hier, hier.num_levels - 1, dev)

    def host_loop(fn, **kw):
        def go():
            res = fn(prob, hier, cfg, rel_tol=REL_TOL, device=dev, **kw)
            return res.u, res.n_cycles, res.residual_norms[-1], res.initial_residual
        return go

    def on_device(fn):
        def go():
            u, norm, n_cycles, init = fn(prob, hier, cfg, rel_tol=REL_TOL, device=dev)
            return u, n_cycles, norm, init
        return go

    solves = {"solve": host_loop(mg.solve), "solve_mixed": host_loop(mg.solve_mixed),
              "solve_fmg": host_loop(mg.solve, use_fmg=True),
              "solve_on_device": on_device(mg.solve_on_device),
              "solve_on_device_mixed": on_device(mg.solve_on_device_mixed)}
    n = hier.finest_n
    for label, go in solves.items():
        torch.cuda.synchronize()
        reset_launches()
        u, it, nrm, init = go()
        torch.cuda.synchronize()
        counts = read_launches()
        err = float(torch.sqrt(torch.sum((u - exact) ** 2)))
        print(f"[reference {n}^3 f64 {label}] cycles={it} final_norm={nrm:.6e} "
              f"rel={nrm / init:.3e} err_l2_vs_analytic={err:.3e} dtype={u.dtype} "
              f"finite={bool(torch.isfinite(u).all())}")
        check(u.dtype == torch.float64 and bool(torch.isfinite(u).all()),
              f"reference {label}: not a finite f64 solution")
        check(nrm <= REL_TOL * init, f"reference {label} not converged: {nrm} > {REL_TOL} * {init}")
        check(it <= 17 if label == "solve_fmg" else abs(it - 16) <= 1,
              f"reference {label}: {it} cycles, expected 16 +- 1")
        check(err <= REF_ERR_TOL, f"reference {label}: error {err} > {REF_ERR_TOL}")
        check(not any(counts.values()), f"reference {label}: hand kernels launched {counts}")
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            go()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        busy, n_kernels, _, _ = device_trace(go)
        busy_s = "not measured" if busy is None else f"{busy:.3f} ms over {n_kernels} kernels"
        print(f"[wall {n}^3 f64 {label}] median_of_3_s={statistics.median(walls):.4f} "
              f"runs_s={[round(w, 4) for w in walls]} device_busy={busy_s} card: {card}")


def solver_257(dev, card, tmp):
    """Phase 9b: MultigridSolver at 257^3: lin_solve to convergence, then a
    checkpoint saved and restored resumes bit for bit over three more
    cycles; one lin_solve_profiled stage table."""
    import multigrid_parallel_tpu_torch as mg

    s = mg.MultigridSolver(5, 7, 2, device=dev)
    t0 = time.perf_counter()
    norms = s.solve(rel_tol=REL_TOL)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    init, err = s.get_initial_residual(), s.error_vs_analytic()
    print(f"[MultigridSolver 257^3] cycles={len(norms)} final_norm={norms[-1]:.6e} "
          f"rel={norms[-1] / init:.3e} err_l2_vs_analytic={err:.3e} wall_s={solve_s:.4f} "
          f"card: {card}")
    check(norms[-1] <= REL_TOL * init and abs(len(norms) - 16) <= 1,
          f"MultigridSolver: {len(norms)} cycles to {norms[-1] / init}")
    check(err <= REF_ERR_TOL, f"MultigridSolver: error {err} > {REF_ERR_TOL}")
    path = str(tmp / "state.npz")
    t0 = time.perf_counter()
    s.save(path)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    r = mg.MultigridSolver.restore(path, device=dev)
    restore_s = time.perf_counter() - t0
    cont = [s.lin_solve() for _ in range(3)]
    resumed = [r.lin_solve() for _ in range(3)]
    exact = bool(torch.equal(r.u, s.u)) and resumed == cont
    print(f"[MultigridSolver 257^3 checkpoint] save_s={save_s:.2f} restore_s={restore_s:.2f} "
          f"three more cycles {cont} resumed {resumed} bitwise_equal={exact}")
    check(exact, "MultigridSolver: the restored solver does not resume bit for bit")
    s.reset_timing_info()
    s.lin_solve_profiled()
    print(f"[MultigridSolver 257^3 lin_solve_profiled] card: {card}")
    s.print_timing_info()


def study_50(dev, card, launches):
    """Phase 9c: the smoother study at 50^3 on K1 (use_pallas=True, f32
    fields), K1 launch counts reset just before and read just after (2 a
    iteration, one one-pass launch a stage, added into ``launches``): its ratio^2 against the published
    0.983675 within STUDY_TOL, its trajectory bit for bit against the plain
    f32 study on the card; the f64 plain study's ratio^2 for the record."""
    from multigrid_parallel_tpu_torch.studies import smoother_study

    kw = dict(n=50, rel_tol=1e-8, max_iters=600, device=dev)
    torch.cuda.synchronize()
    reset_launches()
    got = smoother_study(use_pallas=True, dtype=torch.float32, **kw)
    torch.cuda.synchronize()
    counts = read_launches()
    plain = smoother_study(dtype=torch.float32, **kw)
    ref64 = smoother_study(dtype=torch.float64, **kw)
    ratio2 = got.final_ratio ** 2
    same = got.residual_norms == plain.residual_norms
    print(f"[study 50^3 K1 f32] iters={got.n_iters} ratio^2={ratio2:.7f} (published 0.983675, "
          f"tol {STUDY_TOL:g}) final_norm={got.residual_norms[-1]:.6e} K1_launches="
          f"{counts['rb_smooth_fused']} wall_s={got.wall_time_s:.4f} | plain f32 trajectory "
          f"bitwise_equal={same} wall_s={plain.wall_time_s:.4f} | plain f64 ratio^2="
          f"{ref64.final_ratio ** 2:.7f} | card: {card}")
    check(got.n_iters == 600, f"study: {got.n_iters} iterations")
    check(counts["rb_smooth_fused"] == 2 * got.n_iters
          and all(v == 0 for k, v in counts.items() if k != "rb_smooth_fused"),
          f"study: launches {counts}")
    check(abs(ratio2 - 0.983675) <= STUDY_TOL, f"study: ratio^2 {ratio2}")
    check(same, "study: K1 trajectory differs from the plain f32 one")
    launches["rb_smooth_fused"] += counts["rb_smooth_fused"]


def run_cli(args, device):
    """The CLI in this process; its stdout."""
    import contextlib
    import io

    from multigrid_parallel_tpu_torch.__main__ import main as cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli([*args, "--quiet", "--device", device])
    return buf.getvalue()


def cli_values(out):
    """(cycles or iterations, error or final ratio) from the CLI's output."""
    m = re.search(r"^cycles: (\d+)   wall time: ", out, re.M)
    if m:
        e = re.search(r"^error vs analytic \(L2\): (\S+)$", out, re.M)
        return int(m.group(1)), (float(e.group(1)) if e else None)
    m = re.search(r"^iters: (\d+)  converged: True  final ResidRatio: (\S+)  wall: ", out, re.M)
    check(m is not None, f"CLI printed no result: {out[-300:]}")
    return int(m.group(1)), float(m.group(2))


def cli_phase(tmp):
    """Phase 9e: the CLI in-process, each flag set with --device cuda and
    --device cpu: the same cycle count and the printed error (or the
    study's ratio) within CLI_RTOL; the --vtk files with equal headers and
    coordinates and values within 1e-13."""
    base = ["5", "4", "2"]
    flag_sets = [
        base, base + ["--mixed"], base + ["--fmg"], base + ["--gamma", "2", "--gamma-min", "9"],
        base + ["--smoother", "jacobi"], base + ["--smoother", "lex"],
        base + ["--problem", "trig"], base + ["--f32", "--tol", "1e-3"], base + ["--profile"],
        ["5", "3", "2", "--study"], ["5", "9", "2", "--ndim", "1"],
        base + ["--electrospray"], base + ["--electrospray", "--mixed"],
        base + ["--electrospray", "--fold", "--gamma", "2"],
        base + ["--electrospray", "--split", "--gamma", "2"],
    ]
    for args in flag_sets:
        got = {}
        for d in ("cuda", "cpu"):
            t0 = time.perf_counter()
            got[d] = cli_values(run_cli(args, d)) + (time.perf_counter() - t0,)
        (c_cuda, v_cuda, s_cuda), (c_cpu, v_cpu, s_cpu) = got["cuda"], got["cpu"]
        rel = None if v_cuda is None else abs(v_cuda - v_cpu) / abs(v_cpu)
        print(f"[cli {' '.join(args)}] cuda: {c_cuda}, {v_cuda} ({s_cuda:.2f} s) | cpu: {c_cpu}, "
              f"{v_cpu} ({s_cpu:.2f} s) | rel_diff={rel}")
        check(c_cuda == c_cpu, f"CLI {args}: {c_cuda} cycles on the card, {c_cpu} on the CPU")
        check((v_cuda is None) == (v_cpu is None), f"CLI {args}: printed values differ")
        if "--f32" in args:
            # the f32 error is roundoff, in another summation order on each
            # device: both under 1e-4 at 33^3 (tests/test_torch_reference_solve.py)
            check(v_cuda < 1e-4 and v_cpu < 1e-4, f"CLI {args}: f32 errors {v_cuda}, {v_cpu}")
        elif rel is not None:
            check(rel <= CLI_RTOL, f"CLI {args}: printed values differ: {v_cuda} against {v_cpu}")
    files = {d: tmp / f"{d}.vtk" for d in ("cuda", "cpu")}
    for d, path in files.items():
        run_cli(["5", "4", "2", "--vtk", str(path)], d)
    lines = {d: path.read_text().splitlines() for d, path in files.items()}
    n_pts = 33 ** 3
    head = 6 + n_pts + 3  # header, coordinates, the scalars' header
    vals = {d: np.array(v[head:], dtype=np.float64) for d, v in lines.items()}
    dv = float(np.abs(vals["cuda"] - vals["cpu"]).max())
    print(f"[cli 5 4 2 --vtk] files byte-equal={lines['cuda'] == lines['cpu']} "
          f"headers and coordinates equal={lines['cuda'][:head] == lines['cpu'][:head]} "
          f"max|d error field|={dv:.3e} (tol 1e-13) lines={len(lines['cuda'])}")
    check(len(lines["cuda"]) == len(lines["cpu"]) == head + n_pts, "CLI --vtk: file length")
    check(lines["cuda"][:head] == lines["cpu"][:head], "CLI --vtk: headers or coordinates differ")
    check(dv <= 1e-13, f"CLI --vtk: error fields differ by {dv}")


def driver_phase(dev, card, launches):
    """Phase 9: the driver surface on the card (9a-9e)."""
    import tempfile

    import multigrid_parallel_tpu_torch as mg
    from multigrid_parallel_tpu_torch.ops import _build
    from multigrid_parallel_tpu_torch.utils.timing import profile_padded_stages

    t_phase = time.perf_counter()
    reference_257(dev, card)
    with tempfile.TemporaryDirectory(dir=_build.library_path().parent) as tmp_dir:
        tmp = Path(tmp_dir)
        solver_257(dev, card, tmp)
        study_50(dev, card, launches)
        rows, latency = profile_padded_stages(mg.Hierarchy(ndim=3, coarse_n=5, num_levels=7),
                                              mg.CycleConfig(n_smooth=2), device=dev)
        print(f"[profile_padded_stages 257^3] launch+sync latency {1e3 * latency:.4f} ms | "
              + "; ".join(f"{label}: {1e3 * s:.4f} ms" for label, s in rows)
              + f" | card: {card}")
        check(len(rows) == 4 * 6 + 2 and all(s > 0 for _, s in rows),
              "profile_padded_stages: rows")
        cli_phase(tmp)
    print(f"[phase 9] {time.perf_counter() - t_phase:.1f} s")


def _seg_parts(x, rank, L, kl, kr):
    """Rank ``rank``'s own copies of its (local, lh, rh) segments of the
    global field x (n_dev * L planes); a chain end receives zeros."""
    n_dev, m = x.shape[0] // L, x.shape[1:]
    body = x[rank * L:(rank + 1) * L].clone()
    lh = x[rank * L - kl:rank * L].clone() if rank > 0 else x.new_zeros((kl,) + m)
    rh = (x[(rank + 1) * L:(rank + 1) * L + kr].clone() if rank < n_dev - 1
          else x.new_zeros((kr,) + m))
    return body, lh, rh


def _seg_ext(x, rank, L, k):
    body, lh, rh = _seg_parts(x, rank, L, k, k)
    return torch.cat([lh, body, rh])


def _seg_interior(n, g0, L):
    """The interior points of an i-sharded block of L rows from global plane
    g0: its planes in [1, n - 2] times (n - 2)^2."""
    return max(0, min(L, n - 1 - g0) - max(0, 1 - g0)) * (n - 2) ** 2


def bitwise_same(results, name, n, label, got, want):
    """Check got == want bit for bit; keep the largest difference seen in
    results[name]["max_abs_err"]."""
    err = float((got.double() - want.double()).abs().max()) if got.numel() else 0.0
    results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)
    check(torch.equal(got, want), f"{name} n={n} {label}: not bitwise equal ({err:.3e})")


def compare_sharded(dev, results):
    """Phase 10a: K28-K33 on SHARDED_RANKS simulated ranks' segments of
    65^3 and 257^3 fields, and on one rank's of 257^3 (their own copies:
    real neighbour halos, zeros at the chain ends, gi0 = rank L - halo; L
    as the 4-rank plan has it, 24 and 96, so at 257^3 the last rank owns
    only pad planes, and as the 1-rank plan, 320, 63 pad planes): each rank's
    kernel output bitwise equal to its plain version on the same segments,
    the stitched owned rows bitwise equal to the single-device kernel on
    the whole field (K1 stage both orders, K2 stage, R, K3, K4 stage, K5's
    r), the ranks' partial norms summed within SHARDED_NORM_RTOL of K5's;
    then each timed on rank 1's 257^3 segments against its plain version."""
    import multigrid_parallel_tpu_torch as mg
    from multigrid_parallel_tpu_torch.ops import pallas3d as pk
    from multigrid_parallel_tpu_torch.ops import pallas_sharded as px
    from multigrid_parallel_tpu_torch.parallel import sharded as sh

    hh = 4  # the stage halo of n_smooth = 2
    for name in px.KERNELS:
        results[name] = {"max_abs_err": 0.0}

    def same(name, n, label, got, want):
        bitwise_same(results, name, n, label, got, want)

    # 65^3 and 257^3 on four ranks' segments (the last 257^3 rank pad only), and 257^3 on one
    # rank's (L = 320, 63 pad rows), the four-rank 257^3 last: its fields are timed below
    for levels, D in ((5, SHARDED_RANKS), (7, 1), (7, SHARDED_RANKS)):
        hier = mg.Hierarchy(ndim=3, coarse_n=5, num_levels=levels)
        n, L = hier.finest_n, sh.plan_sharding(hier, D).local_planes(0)
        h, nc, Lc = 1.0 / (n - 1), (n + 1) // 2, L // 2
        rng = np.random.default_rng(n + 10)

        def glob(m, rows):
            x = np.zeros((rows, m, m), np.float32)
            x[:m] = rng.standard_normal((m, m, m))
            return torch.from_numpy(x).to(dev)

        u, f, ec = glob(n, D * L), glob(n, D * L), glob(nc, D * Lc)
        parts = lambda x, r, kl, kr, Lr=L: _seg_parts(x, r, Lr, kl, kr)  # noqa: E731

        def stitched(name, label, kernel, plain, want):
            outs = []
            for r in range(D):
                got = kernel(r)
                same(name, n, f"{label} rank {r} against plain", got, plain(r))
                outs.append(got)
            same(name, n, f"{label} stitched against single-device",
                 torch.cat(outs)[:want.shape[0]], want)
            return torch.cat(outs)

        for red in (True, False):
            want = pk.rb_smooth_fused(u[:n].clone(), f[:n], h, 2, red)
            stitched("rb_smooth_seg", f"red_first={red}",
                     lambda r: px.rb_smooth_halo(parts(u, r, hh, hh), parts(f, r, hh, hh),
                                                 r * L - hh, h, 2, n, L, red),
                     lambda r: px.rb_smooth_halo_plain(parts(u, r, hh, hh), parts(f, r, hh, hh),
                                                       r * L - hh, h, 2, n, L, red), want)
        stitched("rb_smooth_seg", "ext form",
                 lambda r: px.rb_smooth_ext(_seg_ext(u, r, L, hh), _seg_ext(f, r, L, hh),
                                            r * L - hh, h, 2, n, L, False),
                 lambda r: px.rb_smooth_halo_plain(parts(u, r, hh, hh), parts(f, r, hh, hh),
                                                   r * L - hh, h, 2, n, L, False), want)
        # K29: K2's one-pass stage on the segments, one launch a call, the pad rows 0
        before = px.LAUNCHES["rb_smooth_from_zero_seg"]
        for red in (True, False):
            out = stitched("rb_smooth_from_zero_seg", f"red_first={red}",
                           lambda r: px.rb_smooth_from_zero_halo(parts(f, r, hh, hh), r * L - hh,
                                                                 h, 2, n, L, red),
                           lambda r: px.rb_smooth_from_zero_halo_plain(
                               parts(f, r, hh, hh), r * L - hh, h, 2, n, L, red),
                           pk.rb_smooth_from_zero_fused(f[:n], h, 2, red))
            check(not out[n:].any(), f"rb_smooth_from_zero_seg n={n}: pad rows not zero")
        stitched("rb_smooth_from_zero_seg", "ext form",
                 lambda r: px.rb_smooth_from_zero_ext(_seg_ext(f, r, L, hh), r * L - hh, h, 2, n,
                                                      L, False),
                 lambda r: px.rb_smooth_from_zero_halo_plain(parts(f, r, hh, hh), r * L - hh, h,
                                                             2, n, L, False),
                 pk.rb_smooth_from_zero_fused(f[:n], h, 2, False))
        k29_launches = px.LAUNCHES["rb_smooth_from_zero_seg"] - before
        check(k29_launches == 3 * D, f"rb_smooth_from_zero_seg n={n}: {k29_launches} launches "
              f"for {3 * D} calls")
        stitched("residual_seg", "ext form",
                 lambda r: px.residual_ext(_seg_ext(u, r, L, 1), _seg_ext(f, r, L, 1), r * L - 1,
                                           h, n, L),
                 lambda r: px.residual_ext_plain(_seg_ext(u, r, L, 1), _seg_ext(f, r, L, 1),
                                                 r * L - 1, h, n, L),
                 pk.residual_fused(u[:n], f[:n], h))
        coarse = stitched("residual_restrict_seg", "halo 2 / 1",
                          lambda r: px.residual_restrict_halo(parts(u, r, 2, 1), parts(f, r, 2, 1),
                                                              r * L - 2, h, n, Lc),
                          lambda r: px.residual_restrict_halo_plain(parts(u, r, 2, 1),
                                                                    parts(f, r, 2, 1),
                                                                    r * L - 2, h, n, Lc),
                          pk.residual_restrict_fused(u[:n], f[:n], h))
        check(not coarse[nc:].any(), f"residual_restrict_seg n={n}: pad coarse planes not zero")
        stitched("prolong_smooth_seg", "n_iter=2",
                 lambda r: px.prolong_smooth_halo(parts(ec, r, 2, 3, Lc), parts(u, r, hh, hh),
                                                  parts(f, r, hh, hh), r * L - hh, h, 2, n, L),
                 lambda r: px.prolong_smooth_halo_plain(parts(ec, r, 2, 3, Lc),
                                                        parts(u, r, hh, hh), parts(f, r, hh, hh),
                                                        r * L - hh, h, 2, n, L),
                 pk.prolong_smooth_fused(ec[:nc], u[:n], f[:n], h, 2))
        df = [t for _ in range(2) for t in pk.df_split(
            glob(n, D * L).double() + 1e-9 * glob(n, D * L).double())]
        want_r, want_n2 = pk.residual_df_norm_fused(*(x[:n] for x in df), h)
        df_parts = lambda r: [parts(x, r, 1, 1) for x in df]  # noqa: E731
        outs = [px.residual_df_norm_halo(*df_parts(r), r * L - 1, h, n, L) for r in range(D)]
        for r, (got_r, got_n2) in enumerate(outs):
            plain_r, plain_n2 = px.residual_df_norm_halo_plain(*df_parts(r), r * L - 1, h, n, L)
            same("residual_df_norm_seg", n, f"r rank {r} against plain", got_r, plain_r)
            check(abs(float(got_n2) - float(plain_n2)) <= SHARDED_NORM_RTOL * float(plain_n2),
                  f"residual_df_norm_seg n={n} rank {r}: partial norm {float(got_n2)} against "
                  f"{float(plain_n2)}")
        same("residual_df_norm_seg", n, "r stitched against K5",
             torch.cat([o[0] for o in outs])[:n], want_r)
        n2 = sum(float(o[1]) for o in outs)
        rel = abs(n2 - float(want_n2)) / float(want_n2)
        print(f"[sharded kernels n={n} L={L} x{D} rank(s)] K28-K33 bitwise equal to their plain "
              f"versions and, stitched, to K1 and K2 (both orders, and the ext form), R, K3, K4, "
              f"K5's r; sum of the partial ||r||^2 {n2:.9e} against K5's {float(want_n2):.9e} "
              f"(rel {rel:.2e}, tol {SHARDED_NORM_RTOL:g})")
        check(rel <= SHARDED_NORM_RTOL, f"residual_df_norm_seg n={n}: norm rel diff {rel}")

    # times on rank 1's segments of the 257^3 fields (the 4-rank solve's shapes)
    seg = lambda x, kl, kr, Lr=L: _seg_parts(x, 1, Lr, kl, kr)  # noqa: E731
    u4, f4, u21, f21 = seg(u, hh, hh), seg(f, hh, hh), seg(u, 2, 1), seg(f, 2, 1)
    ec23 = seg(ec, 2, 3, Lc)
    u_ext, f_ext = _seg_ext(u, 1, L, 1), _seg_ext(f, 1, L, 1)
    calls = {
        # K28's one-pass stage reads u's and f's rows, halos included, and
        # writes the fresh body
        "rb_smooth_seg": (lambda: px.rb_smooth_halo(u4, f4, L - hh, h, 2, n, L),
                          lambda: px.rb_smooth_halo_plain(u4, f4, L - hh, h, 2, n, L),
                          (*u4, *f4), L * n * n),
        # K29's one-pass stage (K2's from a zero tile) reads f's rows, halos
        # included, and writes the fresh body
        "rb_smooth_from_zero_seg": (lambda: px.rb_smooth_from_zero_halo(f4, L - hh, h, 2, n, L),
                                    lambda: px.rb_smooth_from_zero_halo_plain(f4, L - hh, h, 2,
                                                                              n, L),
                                    f4, L * n * n),
        # K33 reads u and f at the block's interior points and writes r at every point
        "residual_seg": (lambda: px.residual_ext(u_ext, f_ext, L - 1, h, n, L),
                         lambda: px.residual_ext_plain(u_ext, f_ext, L - 1, h, n, L),
                         (8 * _seg_interior(n, L, L),), L * n * n),
        "residual_restrict_seg": (lambda: px.residual_restrict_halo(u21, f21, L - 2, h, n, Lc),
                                  lambda: px.residual_restrict_halo_plain(u21, f21, L - 2, h, n,
                                                                          Lc),
                                  (*u21, *f21), L * n * n),
        "prolong_smooth_seg": (lambda: px.prolong_smooth_halo(ec23, u4, f4, L - hh, h, 2, n, L),
                               lambda: px.prolong_smooth_halo_plain(ec23, u4, f4, L - hh, h, 2,
                                                                    n, L),
                               (*ec23, *u4, *f4), (L + 2 * hh) * n * n),
    }
    for name, (kernel, plain, inputs, points) in calls.items():
        out = kernel()
        outputs = out if isinstance(out, tuple) else (out,)
        res = results[name]
        res["ms"], res["plain_ms"] = time_ms(kernel), time_ms(plain)
        res["bound_ms"], res["bound_by"] = bound(name, points, inputs, outputs)
        print(f"[sharded kernel] {name:24s} n={n} L={L} rank 1 kernel_ms={res['ms']:.4f} "
              f"plain_ms={res['plain_ms']:.4f} bound_ms={res['bound_ms']:.4f} "
              f"({res['bound_by']}) max_abs_err={res['max_abs_err']:.3e}")
    # K30, K28 and K29 on the one-rank plan's 257^3 segment (L = 320, 63 pad planes): the
    # shape of the one-rank solves (phases 10b and 11b); each bound from the bytes the
    # function needs: e (u) and r (f) on the field's n planes, read once, and the block
    L1 = 320
    u1, f1 = _seg_parts(u[:L1], 0, L1, 2, 1), _seg_parts(f[:L1], 0, L1, 2, 1)
    k30 = lambda: px.residual_restrict_halo(u1, f1, -2, h, n, L1 // 2)  # noqa: E731
    got = k30()
    bitwise_same(results, "residual_restrict_seg", n, "L=320 rank 0 against plain", got,
                 px.residual_restrict_halo_plain(u1, f1, -2, h, n, L1 // 2))
    bound1, _ = bound("residual_restrict_seg", L1 * n * n, (8 * n ** 3,), (got,))
    print(f"[sharded kernel] residual_restrict_seg    n={n} L={L1} rank 0 of 1 "
          f"kernel_ms={time_ms(k30):.4f} bound_ms={bound1:.4f}")
    # K32's stage there, and K5 on the whole field beside it, each bound from the bytes
    # the function needs: u_hi, u_lo, f_hi, f_lo on the field's n planes, read once, and r
    # written (K32: its L planes, the pad ones 0)
    df1 = [_seg_parts(x[:L1], 0, L1, 1, 1) for x in df]
    time_df_norm(results, "residual_df_norm_seg", "[sharded kernel] residual_df_norm_seg    "
                 f" n={n} L={L1} rank 0 of 1",
                 lambda: px.residual_df_norm_halo(*df1, -1, h, n, L1),
                 lambda: px.residual_df_norm_halo_plain(*df1, -1, h, n, L1),
                 L1 * n * n, [x[:n] for x in df], h)
    # K33 there, its bound the bytes the function needs as on rank 1's block
    u_ext1, f_ext1 = _seg_ext(u[:L1], 0, L1, 1), _seg_ext(f[:L1], 0, L1, 1)
    k33 = lambda: px.residual_ext(u_ext1, f_ext1, -1, h, n, L1)  # noqa: E731
    got = k33()
    bitwise_same(results, "residual_seg", n, "L=320 rank 0 against plain", got,
                 px.residual_ext_plain(u_ext1, f_ext1, -1, h, n, L1))
    bound1, _ = bound("residual_seg", L1 * n * n, (8 * _seg_interior(n, 0, L1),), (got,))
    print(f"[sharded kernel] residual_seg             n={n} L={L1} rank 0 of 1 "
          f"kernel_ms={time_ms(k33):.4f} bound_ms={bound1:.4f}")
    u1, f1 = _seg_parts(u[:L1], 0, L1, hh, hh), _seg_parts(f[:L1], 0, L1, hh, hh)
    ec1 = _seg_parts(ec[:L1 // 2], 0, L1 // 2, 2, 3)
    nc = (n + 1) // 2
    one_rank = {
        "rb_smooth_seg": (lambda: px.rb_smooth_halo(u1, f1, -hh, h, 2, n, L1),
                          lambda: px.rb_smooth_halo_plain(u1, f1, -hh, h, 2, n, L1), 8 * n ** 3),
        "rb_smooth_from_zero_seg": (lambda: px.rb_smooth_from_zero_halo(f1, -hh, h, 2, n, L1),
                                    lambda: px.rb_smooth_from_zero_halo_plain(f1, -hh, h, 2, n,
                                                                              L1), 4 * n ** 3),
        # K31: e and r on the field's n planes and the coarse field's nc read once
        "prolong_smooth_seg": (
            lambda: px.prolong_smooth_halo(ec1, u1, f1, -hh, h, 2, n, L1),
            lambda: px.prolong_smooth_halo_plain(ec1, u1, f1, -hh, h, 2, n, L1),
            8 * n ** 3 + 4 * nc ** 3),
    }
    for name, (kernel, plain, need) in one_rank.items():
        got = kernel()
        bitwise_same(results, name, n, "L=320 rank 0 against plain", got, plain())
        bound1, _ = bound(name, n * n * n, (need,), (got,))
        print(f"[sharded kernel] {name:24s} n={n} L={L1} rank 0 of 1 "
              f"kernel_ms={time_ms(kernel):.4f} bound_ms={bound1:.4f}")


def time_df_norm(results, name, label, kernel, plain, points, cube, h):
    """A K32 or K41 call on a one-rank block of ``points`` points: its r
    bitwise equal to the plain version's and its norm within
    SHARDED_NORM_RTOL; its time, the plain version's and its bound (the
    bytes it needs: u_hi, u_lo, f_hi, f_lo on the field's n^3 points read
    once and r written) into results[name]; K5 on the whole field ``cube``
    timed beside it against its own bound."""
    from multigrid_parallel_tpu_torch.ops import pallas3d as pk

    n = cube[0].shape[0]
    got_r, got_n2 = kernel()
    plain_r, plain_n2 = plain()
    bitwise_same(results, name, n, f"{label} against plain", got_r, plain_r)
    check(abs(float(got_n2) - float(plain_n2)) <= SHARDED_NORM_RTOL * float(plain_n2),
          f"{name} {label}: partial norm {float(got_n2)} against {float(plain_n2)}")
    res = results[name]
    res["ms"], res["plain_ms"] = time_ms(kernel), time_ms(plain)
    res["bound_ms"], res["bound_by"] = bound(name, points, (16 * n ** 3,), (got_r, got_n2))
    k5 = lambda: pk.residual_df_norm_fused(*cube, h)  # noqa: E731
    k5_bound, _ = bound("residual_df_norm_fused", n ** 3, (16 * n ** 3,), k5())
    print(f"{label} kernel_ms={res['ms']:.4f} plain_ms={res['plain_ms']:.4f} "
          f"bound_ms={res['bound_ms']:.4f} ({res['bound_by']}) "
          f"max_abs_err={res['max_abs_err']:.3e}; K5 n={n} kernel_ms={time_ms(k5):.4f} "
          f"bound_ms={k5_bound:.4f}")


def _sharded_solver(mesh, init):
    """The 257^3 double-float solve of phases 4 and 10 on i-sharded blocks:
    (run, plan, this rank's (u_hi, u_lo, f_hi, f_lo) blocks)."""
    import multigrid_parallel_tpu_torch as mg
    from multigrid_parallel_tpu_torch.parallel import sharded_padded as spp

    hier = mg.Hierarchy(ndim=3, coarse_n=5, num_levels=7)
    run, plan = spp.make_sharded_df_solver(hier, mg.CycleConfig(n_smooth=2), mesh,
                                           rel_tol=REL_TOL, max_cycles=40, inner_cycles=4,
                                           init_norm=init)
    return run, plan, spp.setup_df_problem_sharded_padded(mg.poisson_3d_quadratic(), hier,
                                                          mesh, plan)


def sharded_one_rank(dev, card, launches, fused):
    """Phase 10b: make_sharded_df_solver at 257^3 on one rank of an NCCL
    group, launch counts reset just before and read just after (added
    into ``launches``): exactly the launches predicted from the solve's
    outer steps (``predicted_launches`` with the six sharded levels on
    K28-K31 and K32 as the norm; the plan shards down to 9^3, so the
    gathered tail is the bare 5^3 LU), the fused single-device
    solve's outer steps (``fused``: phase 4's (u, outer steps, solve)), its
    L2 error within 1%, max|u - u_fused| <= SHARDED_DU_TOL; then the walls
    interleaved with the fused solve and the device-busy time of each.
    Returns (u, outer steps)."""
    import torch.distributed as dist

    import multigrid_parallel_tpu_torch as mg
    from multigrid_parallel_tpu_torch import cycles_padded as cp
    from multigrid_parallel_tpu_torch.hierarchy import evaluate_on_grid
    from multigrid_parallel_tpu_torch.parallel import sharded as sh
    from multigrid_parallel_tpu_torch.parallel import sharded_padded as spp
    from multigrid_parallel_tpu_torch.parallel.launch import _free_port

    u_fused, it_fused, solve_fused = fused
    hier = mg.Hierarchy(ndim=3, coarse_n=5, num_levels=7)
    n = hier.finest_n
    exact = evaluate_on_grid(mg.poisson_3d_quadratic().analytic, hier, hier.num_levels - 1, dev)
    init = cp.ref_init_norm(mg.poisson_3d_quadratic(), hier, dev)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = sh.make_mesh(1)
        run, plan, state = _sharded_solver(mesh, init)
        check((plan.n_sharded, plan.local_planes(0)) == (6, 320), f"1-rank plan {plan}")
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        out = run(*state)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        counts = read_launches()
        u = spp.unpad_solution(sh.gather_global(out[0], mesh), sh.gather_global(out[1], mesh),
                               hier)
        it, nrm = out[3], float(out[2])
        err = float(torch.sqrt(torch.sum((u - exact) ** 2)))
        err_fused = float(torch.sqrt(torch.sum((u_fused - exact) ** 2)))
        du = float((u - u_fused).abs().max())
        print(f"[solve {n}^3 sharded 1 rank nccl {mesh.device}] plan={plan} outer_steps={it} "
              f"final_norm={nrm:.6e} rel={nrm / init:.3e} err_l2_vs_analytic={err:.4e} "
              f"(fused {err_fused:.4e}) max|u-u_fused|={du:.3e} (tol {SHARDED_DU_TOL:g}) "
              f"finite={bool(torch.isfinite(u).all())} first_run_s={first_s:.4f}")
        sharded_levels = hier.sizes[hier.num_levels - plan.n_sharded:]
        want = predicted_launches(hier, dict.fromkeys(sharded_levels, "j-replicated"), it, 4,
                                  norm="residual_df_norm_seg")
        print(f"[launches {n}^3 sharded 1 rank] {json.dumps(counts)}")
        check(bool(torch.isfinite(u).all()) and nrm <= REL_TOL * init,
              f"1-rank sharded solve not converged: {nrm}")
        check(it == it_fused, f"1-rank sharded solve: {it} outer steps, fused {it_fused}")
        check(abs(err - err_fused) <= 0.01 * err_fused, f"1-rank sharded solve: error {err}")
        check(du <= SHARDED_DU_TOL, f"1-rank sharded solve: max|u - u_fused| = {du}")
        for name in SOURCES:
            check((counts[name] > 0) == (name in SEG_KERNELS) and counts[name] == want[name],
                  f"1-rank sharded: kernel {name} launched {counts[name]} times, predicted "
                  f"{want[name]}")
            launches[name] += counts[name]
        solve = lambda: run(*state)  # noqa: E731
        interleave({"sharded_1rank": solve, "fused": solve_fused}, f"{n}^3", card, reps=5)
        print_device_time({"sharded_1rank": solve, "fused": solve_fused}, f"{n}^3", card)
    finally:
        dist.destroy_process_group()
    return u, it


def sharded_rank_main(mesh, init, u_ref_path, es_u_ref_path):
    """Phases 10c and 11c on each host-staged gloo rank: the 257^3 sharded
    solve (a warm-up, then one run with the launch counts reset just before
    and read just after), this rank's max|u - u_ref| and squared error over
    its valid planes, reduced over the ranks; then the f64 sharded V-cycle
    at 129^3 (two cycles); then the same for the sharded electrospray
    257^3 solve and the f64 sharded mixed-BC cycle at 65^3. Rank 0 returns
    the results."""
    import torch.distributed as dist

    import multigrid_parallel_tpu_torch as mg
    from multigrid_parallel_tpu_torch.hierarchy import evaluate_on_grid
    from multigrid_parallel_tpu_torch.ops import pallas3d as pk
    from multigrid_parallel_tpu_torch.parallel import sharded as sh

    run, plan, state = _sharded_solver(mesh, init)
    run(*state)
    torch.cuda.synchronize()
    dist.barrier()
    reset_launches()
    t0 = time.perf_counter()
    u_hi, u_lo, nrm, it = run(*state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_launches()
    hier = mg.Hierarchy(ndim=3, coarse_n=5, num_levels=7)
    n, L = hier.finest_n, plan.local_planes(0)
    g0 = mesh.rank * L
    g1 = max(min(g0 + L, n), g0)
    u = pk.df_to_f64(u_hi, u_lo)[:g1 - g0]
    u_ref = torch.from_numpy(np.array(np.load(u_ref_path, mmap_mode="r")[g0:g1]))
    exact = evaluate_on_grid(mg.poisson_3d_quadratic().analytic, hier, hier.num_levels - 1,
                             mesh.device)[g0:g1]
    du = torch.tensor([float((u.cpu() - u_ref).abs().max()) if g1 > g0 else 0.0])
    err2 = torch.tensor([float(torch.sum((u - exact) ** 2))], dtype=torch.float64)
    dist.all_reduce(du, op=dist.ReduceOp.MAX)
    dist.all_reduce(err2)
    per_rank = [None] * mesh.n_dev
    dist.all_gather_object(per_rank, (wall, counts))

    hier64 = mg.Hierarchy(ndim=3, coarse_n=5, num_levels=6)
    step64, plan64 = sh.make_sharded_cycle(hier64, mg.CycleConfig(n_smooth=2), mesh)
    u64, f64 = sh.setup_problem_sharded(mg.poisson_3d_quadratic(), hier64, mesh, plan64)
    norms64 = []
    for _ in range(2):
        u64, nrm64 = step64(u64, f64)
        norms64.append(float(nrm64))
    u64 = sh.unpad(sh.gather_global(u64, mesh), hier64)
    es = sharded_mixed_rank(mesh, es_u_ref_path)
    if mesh.rank != 0:
        return None
    return {"plan": plan, "it": it, "nrm": float(nrm), "du": float(du), "err": float(err2) ** 0.5,
            "per_rank": per_rank, "plan64": plan64, "norms64": norms64, "u64": u64,
            "backend": mesh.backend, "device": str(mesh.device), "staged": mesh.staged, "es": es}


def sharded_mixed_rank(mesh, u_ref_path):
    """Phase 11c on each rank: the sharded electrospray 257^3 solve (a
    warm-up, then one run with the launch counts reset just before and read
    just after), max|u - u_ref| over the valid planes reduced over the
    ranks; then two f64 sharded mixed-BC cycles at 65^3 (gamma 2 capped at
    17, a quarter of the finest size as in production). Returns the results
    (gathered; every rank)."""
    import torch.distributed as dist

    import multigrid_parallel_tpu_torch as mg
    from multigrid_parallel_tpu_torch.mixed_bc import MixedBCSolver
    from multigrid_parallel_tpu_torch.ops import pallas3d as pk
    from multigrid_parallel_tpu_torch.parallel import sharded as sh
    from multigrid_parallel_tpu_torch.parallel import sharded_mixed as sm
    from multigrid_parallel_tpu_torch.parallel import sharded_mixed_padded as smp

    es = mg.electrospray_problem()
    solver = es_solver(es, mesh.device)
    run, plan = smp.make_sharded_mixed_padded_df_solver(solver, mesh, rel_tol=REL_TOL,
                                                        max_cycles=100, inner_cycles=1)
    state = smp.setup_mixed_df_problem_sharded(solver, mesh, plan)
    run(*state)
    torch.cuda.synchronize()
    dist.barrier()
    reset_launches()
    t0 = time.perf_counter()
    u_hi, u_lo, nrm, it = run(*state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_launches()
    n, L = solver.hier.finest_n, plan.local_planes(0)
    g0 = mesh.rank * L
    g1 = max(min(g0 + L, n), g0)
    u = pk.df_to_f64(u_hi, u_lo)[:g1 - g0].cpu()
    u_ref = torch.from_numpy(np.array(np.load(u_ref_path, mmap_mode="r")[g0:g1]))
    du = torch.tensor([float((u - u_ref).abs().max()) if g1 > g0 else 0.0])
    finite = torch.tensor([float(torch.isfinite(u).all())])
    dist.all_reduce(du, op=dist.ReduceOp.MAX)
    dist.all_reduce(finite, op=dist.ReduceOp.MIN)
    per_rank = [None] * mesh.n_dev
    dist.all_gather_object(per_rank, (wall, counts))

    hier65 = mg.Hierarchy(ndim=3, coarse_n=5, num_levels=5, length=es.length)
    s65 = MixedBCSolver(es, hier65, n_smooth=2, gamma=2, gamma_min_n=17, device=mesh.device)
    step, plan65 = sm.make_sharded_mixed_bc_cycle(s65, mesh)
    u65, f65 = sm.setup_mixed_problem_sharded(s65, mesh, plan65)
    norms65 = []
    for _ in range(2):
        u65, nrm65 = step(u65, f65)
        norms65.append(float(nrm65))
    return {"plan": plan, "it": it, "nrm": float(nrm), "du": float(du), "finite": bool(finite),
            "per_rank": per_rank, "plan65": plan65, "norms65": norms65,
            "u65": sh.gather_global(u65, mesh)[:hier65.finest_n].cpu()}


def sharded_four_ranks(dev, card, launches, one_rank, es_one_rank, tmp):
    """Phases 10c and 11c: four gloo ranks on the one card (halos and
    reductions staged through host memory; every kernel on the card): the
    257^3 sharded solve in phase 10b's outer steps with u within
    SHARDED_DU_TOL of its, each rank launching K28-K32 and, in the
    replicated 9^3 cycle, K2-K4, exactly as often as ``predicted_launches``
    says from its outer steps (added into ``launches``), one host-staged
    wall; the f64 sharded V-cycle at 129^3 against the single-device one
    within SHARDED_F64_TOL; then the electrospray's (11c) against
    ``es_one_rank``, phase 11b's (u, outer steps)."""
    import multigrid_parallel_tpu_torch as mg
    from multigrid_parallel_tpu_torch import cycles_padded as cp
    from multigrid_parallel_tpu_torch.cycles import make_cycle_fn, setup_problem
    from multigrid_parallel_tpu_torch.parallel.launch import launch

    u_one, it_one = one_rank
    u_ref_path, es_u_ref_path = tmp / "u_one_rank.npy", tmp / "es_u_one_rank.npy"
    np.save(u_ref_path, u_one.cpu().numpy())
    np.save(es_u_ref_path, es_one_rank[0].cpu().numpy())
    init = cp.ref_init_norm(mg.poisson_3d_quadratic(), mg.Hierarchy(ndim=3, coarse_n=5,
                                                                    num_levels=7), dev)
    t0 = time.perf_counter()
    res = launch(sharded_rank_main, SHARDED_RANKS, init, str(u_ref_path), str(es_u_ref_path),
                 backend="gloo", device="cuda", timeout=600.0)[0]
    launch_s = time.perf_counter() - t0
    n = 257
    print(f"[solve {n}^3 sharded {SHARDED_RANKS} ranks {res['backend']} on one card, halos "
          f"host-staged={res['staged']} ({res['device']})] plan={res['plan']} "
          f"outer_steps={res['it']} final_norm={res['nrm']:.6e} err_l2_vs_analytic="
          f"{res['err']:.4e} max|u-u_1rank|={res['du']:.3e} (tol {SHARDED_DU_TOL:g}) | "
          f"host-staged wall (not a scaling figure) per rank s="
          f"{[round(w, 4) for w, _ in res['per_rank']]} | launch incl. spawn {launch_s:.1f} s "
          f"| card: {card}")
    check(res["staged"] and (res["plan"].n_sharded, res["plan"].local_planes(0)) == (5, 96),
          f"4-rank plan {res['plan']}")
    check(res["it"] == it_one, f"4-rank sharded solve: {res['it']} outer steps, 1 rank {it_one}")
    check(res["du"] <= SHARDED_DU_TOL, f"4-rank sharded solve: max|u - u_1rank| = {res['du']}")
    # the sharded levels on K28-K31, the level below them the replicated cycle (K2-K4)
    hier = mg.Hierarchy(ndim=3, coarse_n=5, num_levels=7)
    first_sharded = hier.num_levels - res["plan"].n_sharded
    tiers = dict.fromkeys(hier.sizes[first_sharded:], "j-replicated")
    tiers[hier.sizes[first_sharded - 1]] = "replicated"
    want = predicted_launches(hier, tiers, res["it"], 4, norm="residual_df_norm_seg")
    for rank, (_, counts) in enumerate(res["per_rank"]):
        print(f"[launches {n}^3 sharded rank {rank} of {SHARDED_RANKS}] "
              f"{json.dumps({k: v for k, v in counts.items() if v})}")
        for name in SOURCES:
            check((counts[name] > 0) == (name in SEG_KERNELS + SEG_TAIL_KERNELS)
                  and counts[name] == want[name],
                  f"4-rank sharded rank {rank}: kernel {name} launched {counts[name]} times, "
                  f"predicted {want[name]}")
            launches[name] += counts[name]

    hier64 = mg.Hierarchy(ndim=3, coarse_n=5, num_levels=6)
    cycle = make_cycle_fn(hier64, mg.CycleConfig(n_smooth=2), device=dev)
    u1, f1 = setup_problem(mg.poisson_3d_quadratic(), hier64, dev)
    for it in range(2):
        u1, n1 = cycle(u1, f1)
        check(abs(res["norms64"][it] - float(n1)) <= 1e-10 * float(n1),
              f"f64 sharded cycle {it}: norm {res['norms64'][it]} against {float(n1)}")
    du64 = float((res["u64"].to(dev) - u1).abs().max())
    print(f"[f64 sharded cycle 129^3 {SHARDED_RANKS} ranks gloo] plan={res['plan64']} norms="
          f"{res['norms64']} single-device={float(n1):.10e} max|du|={du64:.3e} "
          f"(tol {SHARDED_F64_TOL:g})")
    check(du64 <= SHARDED_F64_TOL, f"f64 sharded cycle: max|du| = {du64}")
    sharded_mixed_four_ranks(dev, card, launches, es_one_rank, res["es"])


def sharded_mixed_four_ranks(dev, card, launches, es_one_rank, res):
    """Phase 11c, read on the host: the sharded electrospray 257^3 solve on
    the four gloo ranks in phase 11b's outer steps with u within
    SHARDED_MIXED_RTOL of its, each rank launching exactly
    MIXED_SEG_RANK_LAUNCHES (K34-K36, K30 and K32 and, in the replicated
    9^3 tail, K14, K3 and K15; added into ``launches``) and nothing else;
    the f64 sharded mixed-BC cycle at 65^3 against
    MixedBCSolver's single-device cycle within SHARDED_MIXED_F64_RTOL."""
    import multigrid_parallel_tpu_torch as mg
    from multigrid_parallel_tpu_torch.mixed_bc import MixedBCSolver
    from multigrid_parallel_tpu_torch.ops import stencils_3d as ops3

    u_one, it_one = es_one_rank
    scale = float(u_one.abs().max())
    n = 257
    print(f"[solve {n}^3 electrospray sharded {SHARDED_RANKS} ranks gloo on one card] "
          f"plan={res['plan']} outer_steps={res['it']} final_norm={res['nrm']:.6e} "
          f"finite={res['finite']} max|u-u_1rank|={res['du']:.3e} V (tol {SHARDED_MIXED_RTOL:g} "
          f"* {scale:g}) | host-staged wall (not a scaling figure) per rank s="
          f"{[round(w, 4) for w, _ in res['per_rank']]} | card: {card}")
    check((res["plan"].n_sharded, res["plan"].local_planes(0)) == (5, 96),
          f"4-rank electrospray plan {res['plan']}")
    check(res["finite"] and res["it"] == it_one,
          f"4-rank electrospray solve: {res['it']} outer steps, 1 rank {it_one}")
    check(res["du"] <= SHARDED_MIXED_RTOL * scale,
          f"4-rank electrospray solve: max|u - u_1rank| = {res['du']}")
    for rank, (_, counts) in enumerate(res["per_rank"]):
        print(f"[launches {n}^3 electrospray sharded rank {rank} of {SHARDED_RANKS}] "
              f"{json.dumps({k: v for k, v in counts.items() if v})}")
        for name in SOURCES:
            want = MIXED_SEG_RANK_LAUNCHES.get(name, 0)
            check(counts[name] == want, f"4-rank electrospray rank {rank}: kernel {name} "
                                        f"launched {counts[name]} times, expected {want}")
            launches[name] += counts[name]

    es = mg.electrospray_problem()
    hier65 = mg.Hierarchy(ndim=3, coarse_n=5, num_levels=5, length=es.length)
    s65 = MixedBCSolver(es, hier65, n_smooth=2, gamma=2, gamma_min_n=17, device=dev)
    u1, f1 = s65.initial_state()
    coarse = s65._coarse_solver(hier65.dtype)
    for it in range(2):
        u1 = s65._descend(u1, f1, hier65.num_levels - 1, False, coarse)
        n1 = float(ops3.residual_norm(u1, f1, hier65.spacing(hier65.num_levels - 1)))
        check(abs(res["norms65"][it] - n1) <= 1e-10 * n1,
              f"f64 sharded mixed cycle {it}: norm {res['norms65'][it]} against {n1}")
    du65 = float((res["u65"].to(dev) - u1).abs().max())
    scale65 = float(u1.abs().max())
    print(f"[f64 sharded mixed-BC cycle 65^3 {SHARDED_RANKS} ranks gloo] plan={res['plan65']} "
          f"norms={res['norms65']} single-device={n1:.10e} max|du|={du65:.3e} V "
          f"(tol {SHARDED_MIXED_F64_RTOL:g} * {scale65:g})")
    check(du65 <= SHARDED_MIXED_F64_RTOL * scale65, f"f64 sharded mixed cycle: max|du| = {du65}")


def compare_sharded_mixed(dev, results, es):
    """Phase 11a: K34-K36 on simulated ranks' segments of electrospray
    fields (h = 3e-4 / (n - 1), the problem's pin planes; their own copies,
    zeros at the chain ends): 65^3 on SHARDED_RANKS ranks of L = 24 (the
    4-rank plan) and of L = 32 (plane 64 is rank 2's row 0: its left halo
    is one plane deeper), 257^3 on SHARDED_RANKS ranks of L = 96 (the last
    rank owns pad planes only), on one of L = 320 (the one-rank plan) and
    on five of L = 64 (plane 256 is rank 4's row 0). Each rank's kernel
    output bitwise equal to its plain version, the stitched owned rows
    bitwise equal to K13-K15 on the whole field, the pad planes zero; then
    each timed on rank 1's 257^3 segments (L = 96) against its plain
    version."""
    from multigrid_parallel_tpu_torch.ops import pallas_mixed as pm

    hh = 4
    names = ("mixed_rb_smooth_seg", "mixed_rb_smooth_from_zero_seg", "mixed_prolong_smooth_seg")
    for name in names:
        results[name] = {"max_abs_err": 0.0}

    def same(name, n, label, got, want):
        bitwise_same(results, name, n, label, got, want)

    for n, L, D in ((257, 320, 1), (257, 64, 5), (65, 24, SHARDED_RANKS),
                    (65, 32, SHARDED_RANKS), (257, 96, SHARDED_RANKS)):
        h, nc, Lc = es.length / (n - 1), (n + 1) // 2, L // 2
        pin = pm.dirichlet_pin_planes(es, n, dev)
        rng = np.random.default_rng(n + L)

        def glob(m, rows):
            x = np.zeros((rows, m, m), np.float32)
            x[:m] = rng.standard_normal((m, m, m))
            return torch.from_numpy(x).to(dev)

        u, f, ec = glob(n, D * L), glob(n, D * L), glob(nc, D * Lc)
        u[:n] = pm.apply_bcs_padded(u[:n], pin)  # BC-consistent, as the cycle hands it over

        def kl(r):
            return hh + (r * L == n - 1)

        def parts(x, r):
            return _seg_parts(x, r, L, kl(r), hh)

        def cparts(r):
            return _seg_parts(ec, r, Lc, kl(r) - 2, 3)

        def stitched(name, label, kernel, plain, want):
            outs = []
            for r in range(D):
                got = kernel(r)
                same(name, n, f"{label} rank {r} against plain", got, plain(r))
                outs.append(got)
            got = torch.cat(outs)
            same(name, n, f"{label} stitched against single-device", got[:n], want)
            check(not got[n:].any(), f"{name} n={n} L={L}: a pad plane was written")

        for red in (True, False):
            stitched("mixed_rb_smooth_seg", f"L={L} red_first={red}",
                     lambda r: pm.mixed_rb_smooth_halo(parts(u, r), parts(f, r), pin, r * L - hh,
                                                       h, 2, n, L, red),
                     lambda r: pm.mixed_rb_smooth_halo_plain(parts(u, r), parts(f, r), pin,
                                                             r * L - hh, h, 2, n, L, red),
                     pm.mixed_rb_smooth_fused(u[:n].clone(), f[:n], pin, h, 2, red))
        stitched("mixed_rb_smooth_from_zero_seg", f"L={L}",
                 lambda r: pm.mixed_rb_smooth_from_zero_halo(parts(f, r), pin, r * L - hh, h, 2,
                                                             n, L),
                 lambda r: pm.mixed_rb_smooth_from_zero_halo_plain(parts(f, r), pin, r * L - hh,
                                                                   h, 2, n, L),
                 pm.mixed_rb_smooth_from_zero_fused(f[:n], pin, h, 2))
        stitched("mixed_prolong_smooth_seg", f"L={L}",
                 lambda r: pm.mixed_prolong_smooth_halo(cparts(r), parts(u, r), parts(f, r), pin,
                                                        r * L - hh, h, 2, n, L),
                 lambda r: pm.mixed_prolong_smooth_halo_plain(cparts(r), parts(u, r), parts(f, r),
                                                              pin, r * L - hh, h, 2, n, L),
                 pm.mixed_prolong_smooth_fused(ec[:nc], u[:n], f[:n], pin, h, 2))
        print(f"[sharded mixed kernels n={n} L={L} x{D} ranks] K34-K36 bitwise equal to their "
              f"plain versions and, stitched, to K13 (both orders), K14, K15; pad planes zero")

    # times on rank 1's segments of the 257^3 fields (the 4-rank solve's shapes)
    u4, f4, ec23 = _seg_parts(u, 1, L, hh, hh), _seg_parts(f, 1, L, hh, hh), cparts(1)
    points = (L + 2 * hh) * n * n
    calls = {
        "mixed_rb_smooth_seg": (lambda: pm.mixed_rb_smooth_halo(u4, f4, pin, L - hh, h, 2, n, L),
                                lambda: pm.mixed_rb_smooth_halo_plain(u4, f4, pin, L - hh, h, 2,
                                                                      n, L),
                                (*u4, *f4, pin)),
        "mixed_rb_smooth_from_zero_seg": (
            lambda: pm.mixed_rb_smooth_from_zero_halo(f4, pin, L - hh, h, 2, n, L),
            lambda: pm.mixed_rb_smooth_from_zero_halo_plain(f4, pin, L - hh, h, 2, n, L),
            (*f4, pin)),
        "mixed_prolong_smooth_seg": (
            lambda: pm.mixed_prolong_smooth_halo(ec23, u4, f4, pin, L - hh, h, 2, n, L),
            lambda: pm.mixed_prolong_smooth_halo_plain(ec23, u4, f4, pin, L - hh, h, 2, n, L),
            (*ec23, *u4, *f4, pin)),
    }
    twins = {"mixed_rb_smooth_seg": ("mixed_rb_smooth_fused", "rb_smooth_seg"),
             "mixed_rb_smooth_from_zero_seg": ("mixed_rb_smooth_from_zero_fused",
                                               "rb_smooth_from_zero_seg"),
             "mixed_prolong_smooth_seg": ("mixed_prolong_smooth_fused", "prolong_smooth_seg")}
    for name, (kernel, plain, inputs) in calls.items():
        res = results[name]
        res["ms"], res["plain_ms"] = time_ms(kernel), time_ms(plain)
        res["bound_ms"], res["bound_by"] = bound(name, points, inputs, (kernel(),))
        single, dirichlet = (results[k]["ms"] for k in twins[name])
        print(f"[sharded mixed kernel] {name:30s} n={n} L={L} rank 1 kernel_ms={res['ms']:.4f} "
              f"plain_ms={res['plain_ms']:.4f} bound_ms={res['bound_ms']:.4f} "
              f"({res['bound_by']}) max_abs_err={res['max_abs_err']:.3e} | the Dirichlet seg "
              f"kernel {twins[name][1]} {dirichlet:.4f} ms on the same rows; per stored point "
              f"{res['ms'] / points * 1e9:.3f} ps against {twins[name][0]}'s "
              f"{single / n ** 3 * 1e9:.3f} ps on the whole {n}^3 field")
    time_mixed_one_rank(dev, results, es)


def time_mixed_one_rank(dev, results, es):
    """K34 and K35 on the one-rank plan's blocks where the solve runs K34:
    129^3 (L = 160) and 65^3 (L = 80), the halos zero (the chain ends), e
    BC-consistent, each bitwise equal to its plain version and to K13's and
    K14's on the whole field, timed beside its bound: the bytes it needs,
    e (K34) and r on the field's n planes read once, the pins, and the
    body written. A call this short is bound by the wrapper's host work
    under CUDA events, so its device time a call is the mean of its
    kernel's events in a trace of 20 calls (the profiler may drop some;
    the launches are counted by LAUNCHES)."""
    from multigrid_parallel_tpu_torch.ops import pallas_mixed as pm

    hh = 4
    for n, L1 in ((129, 160), (65, 80)):
        h, pin = es.length / (n - 1), pm.dirichlet_pin_planes(es, n, dev)
        rng = np.random.default_rng(n + L1)
        u, f = (torch.zeros((L1, n, n), device=dev) for _ in range(2))
        u[:n] = pm.apply_bcs_padded(torch.from_numpy(
            rng.standard_normal((n, n, n)).astype(np.float32)).to(dev), pin)
        f[:n] = torch.from_numpy(rng.standard_normal((n, n, n)).astype(np.float32)).to(dev)
        u1, f1 = _seg_parts(u, 0, L1, hh, hh), _seg_parts(f, 0, L1, hh, hh)
        calls = {
            "mixed_rb_smooth_seg": (
                lambda: pm.mixed_rb_smooth_halo(u1, f1, pin, -hh, h, 2, n, L1),
                lambda: pm.mixed_rb_smooth_halo_plain(u1, f1, pin, -hh, h, 2, n, L1),
                pm.mixed_rb_smooth_plain(u[:n], f[:n], pin, h, 2), 8),
            "mixed_rb_smooth_from_zero_seg": (
                lambda: pm.mixed_rb_smooth_from_zero_halo(f1, pin, -hh, h, 2, n, L1),
                lambda: pm.mixed_rb_smooth_from_zero_halo_plain(f1, pin, -hh, h, 2, n, L1),
                pm.mixed_rb_smooth_from_zero_plain(f[:n], pin, h, 2), 4),
        }
        for name, (kernel, plain, whole, need) in calls.items():
            got = kernel()
            bitwise_same(results, name, n, f"L={L1} rank 0 of 1 against plain", got, plain())
            bitwise_same(results, name, n, f"L={L1} rank 0 of 1 against the whole field",
                         got[:n], whole)
            bound1, _ = bound(name, n ** 3, (need * n ** 3, pin), (got,))
            _, _, by_name, _ = device_trace(lambda: [kernel() for _ in range(20)], 0.01)
            seen = [v for k, v in by_name.items() if k.startswith("mixed_seg_stage_kernel")]
            device = (f"{sum(ms for ms, _ in seen) / sum(c for _, c in seen):.4f} "
                      f"({sum(c for _, c in seen)} of 20 traced)" if seen else "not measured")
            print(f"[sharded mixed kernel] {name:30s} n={n} L={L1} rank 0 of 1 "
                  f"kernel_ms={time_ms(kernel):.4f} device_ms_a_call={device} "
                  f"bound_ms={bound1:.4f}")


def sharded_mixed_one_rank(dev, card, launches, full, es):
    """Phase 11b: make_sharded_mixed_padded_df_solver at 257^3 in the
    production configuration on one rank of an NCCL group, launch counts
    reset just before and read just after (added into ``launches``): K30 and
    K32 launched exactly as often as phase 6's full tier launches K3 and K5,
    K34-K36 as often as it launches K13-K15 (seg_twin_launches), and
    nothing else (the plan shards
    down to 9^3 and gathers the bare 5^3 LU); the full tier's outer steps (``full``: phase
    6's (u, outer steps, solve, counts)), max|u - u_full| <=
    SHARDED_MIXED_RTOL max|u|; then the walls interleaved with the full tier
    and the device-busy time of each. Returns (u, outer steps)."""
    import torch.distributed as dist

    from multigrid_parallel_tpu_torch import mixed_padded as mp
    from multigrid_parallel_tpu_torch.ops import pallas3d as pk
    from multigrid_parallel_tpu_torch.parallel import sharded as sh
    from multigrid_parallel_tpu_torch.parallel import sharded_mixed_padded as smp
    from multigrid_parallel_tpu_torch.parallel.launch import _free_port

    u_full, it_full, solve_full, counts_full = full
    solver = es_solver(es, dev)
    hier = solver.hier
    n = hier.finest_n
    n0 = float(torch.sqrt(pk.residual_df_norm_fused(*mp.setup_mixed_df_problem(solver),
                                                    hier.spacing(hier.num_levels - 1))[1]))
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = sh.make_mesh(1)
        run, plan = smp.make_sharded_mixed_padded_df_solver(solver, mesh, rel_tol=REL_TOL,
                                                            max_cycles=100, inner_cycles=1)
        check((plan.n_sharded, plan.local_planes(0)) == (6, 320), f"1-rank plan {plan}")
        state = smp.setup_mixed_df_problem_sharded(solver, mesh, plan)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        out = run(*state)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        counts = read_launches()
        u = smp.unpack_mixed_solution_sharded(sh.gather_global(out[0], mesh),
                                              sh.gather_global(out[1], mesh), hier)
        it, nrm = out[3], float(out[2])
        scale = float(u_full.abs().max())
        du = float((u - u_full).abs().max())
        print(f"[solve {n}^3 electrospray sharded 1 rank nccl {mesh.device}] plan={plan} "
              f"outer_steps={it} final_norm={nrm:.6e} n0={n0:.6e} rel={nrm / n0:.3e} "
              f"max|u-u_full|={du:.3e} V (tol {SHARDED_MIXED_RTOL:g} * {scale:g}) "
              f"finite={bool(torch.isfinite(u).all())} first_run_s={first_s:.4f}")
        print(f"[launches {n}^3 electrospray sharded 1 rank] "
              f"{json.dumps({k: v for k, v in counts.items() if v})}")
        check(bool(torch.isfinite(u).all()) and nrm <= REL_TOL * n0,
              f"1-rank electrospray solve not converged: {nrm}")
        check(it == it_full, f"1-rank electrospray solve: {it} outer steps, full tier {it_full}")
        check(du <= SHARDED_MIXED_RTOL * scale, f"1-rank electrospray solve: max|du| = {du}")
        for name in SOURCES:
            want = seg_twin_launches(counts_full, name)
            check(counts[name] == want, f"1-rank electrospray: kernel {name} launched "
                                        f"{counts[name]} times, expected {want}")
            launches[name] += counts[name]
        solve = lambda: run(*state)  # noqa: E731
        interleave({"sharded_1rank": solve, "full": solve_full}, f"{n}^3 electrospray", card,
                   reps=5)
        print_device_time({"sharded_1rank": solve, "full": solve_full}, f"{n}^3 electrospray",
                          card)
    finally:
        dist.destroy_process_group()
    return u, it


def seg_twin_launches(counts_full, name):
    """The launches the one-rank sharded electrospray solve makes of kernel
    ``name``: 0 unless it has a twin in MIXED_SEG_TWINS, else its twin's in
    phase 6's full-tier solve: K30 and K32 as K3 and K5, K34, K35 and K36
    (one-pass stages, one a call at n_smooth 2) as K13, K14 and K15 (42,
    224 and 266; 210, 1,120 and 1,330 in their first forms)."""
    twin = MIXED_SEG_TWINS.get(name)
    return 0 if twin is None else counts_full[twin]


def sharded_phase(dev, card, launches, results, fused, full, es):
    """Phases 10 and 11: the i-sharded Dirichlet solve (10a, 10b) and
    electrospray solve (11a, 11b), then one spawned group of four gloo
    ranks for both (10c, 11c)."""
    import tempfile

    from multigrid_parallel_tpu_torch.ops import _build

    t_phase = time.perf_counter()
    compare_sharded(dev, results)
    one_rank = sharded_one_rank(dev, card, launches, fused)
    t_mixed = time.perf_counter()
    compare_sharded_mixed(dev, results, es)
    es_one_rank = sharded_mixed_one_rank(dev, card, launches, full, es)
    print(f"[phase 11a-b] {time.perf_counter() - t_mixed:.1f} s")
    with tempfile.TemporaryDirectory(dir=_build.library_path().parent) as tmp_dir:
        sharded_four_ranks(dev, card, launches, one_rank, es_one_rank, Path(tmp_dir))
    print(f"[phases 10-11] {time.perf_counter() - t_phase:.1f} s")


def _seg_parts2d(x, ix, iy, li, lj, kl, kr):
    """Rank (ix, iy)'s own copies of its five parts (body, jl, jr, lh, rh)
    of the global field x (nx li, ny lj, m): the j halos (kl columns before
    the block, kr after), and j-extended i-halo rows (corners included);
    zeros past the array's edges (the chain ends)."""
    rows, cols, m = x.shape
    g = x.new_zeros((rows + kl + kr, cols + kl + kr, m))
    g[kl:kl + rows, kl:kl + cols] = x
    e = g[ix * li:ix * li + kl + li + kr, iy * lj:iy * lj + kl + lj + kr]
    mid = e[kl:kl + li]
    return (mid[:, kl:kl + lj].clone(), mid[:, :kl].clone(), mid[:, kl + lj:].clone(),
            e[:kl].clone(), e[kl + li:].clone())


def compare_sharded2d(dev, results):
    """Phase 12a: K37-K41 on the simulated ranks' blocks of 65^3 and 257^3
    fields on 1x1, 2x2, 4x1 and 1x4 meshes (the blocks of the padded plan; their
    own copies of the five halo parts, corner blocks included, zeros past
    the chain ends; gij0 = (ix Li - halo, iy Lj - halo)): each rank's kernel
    output bitwise equal to its plain version, the stitched owned points
    bitwise equal to the single-device kernel on the whole field (K1 stage
    both orders, K2 stage, K3, K4 stage, K5's r), the ranks' partial norms
    summed within SHARDED_NORM_RTOL of K5's; then each timed on rank (0,
    0)'s 257^3 2x2 block against its plain version."""
    import multigrid_parallel_tpu_torch as mg
    from multigrid_parallel_tpu_torch.ops import pallas3d as pk
    from multigrid_parallel_tpu_torch.ops import pallas_sharded2d as px2
    from multigrid_parallel_tpu_torch.parallel import sharded2d_padded as s2p

    hh = 4  # the stage halo of n_smooth = 2
    for name in px2.KERNELS:
        results[name] = {"max_abs_err": 0.0}
    timed = {}
    for levels in (5, 7):
        hier = mg.Hierarchy(ndim=3, coarse_n=5, num_levels=levels)
        n = hier.finest_n
        h, nc = 1.0 / (n - 1), (n + 1) // 2
        rng = np.random.default_rng(n + 20)

        def cube(m):
            return torch.from_numpy(rng.standard_normal((m, m, m)).astype(np.float32)).to(dev)

        u, f, ec = cube(n), cube(n), cube(nc)
        df = [t for _ in range(2) for t in pk.df_split(cube(n).double() + 1e-9 * cube(n).double())]
        wants = {
            ("rb_smooth_seg2d", True): pk.rb_smooth_fused(u.clone(), f, h, 2, True),
            ("rb_smooth_seg2d", False): pk.rb_smooth_fused(u.clone(), f, h, 2, False),
            ("rb_smooth_from_zero_seg2d", True): pk.rb_smooth_from_zero_fused(f, h, 2, True),
            ("rb_smooth_from_zero_seg2d", False): pk.rb_smooth_from_zero_fused(f, h, 2, False),
            ("residual_restrict_seg2d", True): pk.residual_restrict_fused(u, f, h),
            ("prolong_smooth_seg2d", True): pk.prolong_smooth_fused(ec, u, f, h, 2),
        }
        want_r, want_n2 = pk.residual_df_norm_fused(*df, h)
        for nx, ny in SHARDED2D_SHAPES:
            plan = s2p.plan_sharding_2d_padded(hier, nx, ny)
            li, lj = plan.local_i(0), plan.local_j(0)
            lic, ljc = li // 2, lj // 2

            def glob(x, a, b):
                m = x.shape[0]
                out = x.new_zeros((nx * a, ny * b, m))
                out[:m, :m] = x
                return out

            U, F, EC = glob(u, li, lj), glob(f, li, lj), glob(ec, lic, ljc)
            DF = [glob(x, li, lj) for x in df]
            ranks = [(ix, iy) for ix in range(nx) for iy in range(ny)]
            g = lambda ix, iy, halo: (ix * li - halo, iy * lj - halo)  # noqa: E731

            def p5(x, ix, iy, kl, kr, a=li, b=lj):
                return _seg_parts2d(x, ix, iy, a, b, kl, kr)

            calls = {
                ("rb_smooth_seg2d", True): lambda ix, iy, fn: fn(
                    p5(U, ix, iy, hh, hh), p5(F, ix, iy, hh, hh), g(ix, iy, hh), h, 2, n, li, lj,
                    True),
                ("rb_smooth_seg2d", False): lambda ix, iy, fn: fn(
                    p5(U, ix, iy, hh, hh), p5(F, ix, iy, hh, hh), g(ix, iy, hh), h, 2, n, li, lj,
                    False),
                ("rb_smooth_from_zero_seg2d", True): lambda ix, iy, fn: fn(
                    p5(F, ix, iy, hh, hh), g(ix, iy, hh), h, 2, n, li, lj, True),
                ("rb_smooth_from_zero_seg2d", False): lambda ix, iy, fn: fn(
                    p5(F, ix, iy, hh, hh), g(ix, iy, hh), h, 2, n, li, lj, False),
                ("residual_restrict_seg2d", True): lambda ix, iy, fn: fn(
                    p5(U, ix, iy, 2, 1), p5(F, ix, iy, 2, 1), g(ix, iy, 2), h, n, lic, ljc),
                ("prolong_smooth_seg2d", True): lambda ix, iy, fn: fn(
                    p5(EC, ix, iy, 2, 3, lic, ljc), p5(U, ix, iy, hh, hh), p5(F, ix, iy, hh, hh),
                    g(ix, iy, hh), h, 2, n, li, lj),
            }
            fns = {"rb_smooth_seg2d": (px2.rb_smooth_halo2d, px2.rb_smooth_halo2d_plain),
                   "rb_smooth_from_zero_seg2d": (px2.rb_smooth_from_zero_halo2d,
                                                 px2.rb_smooth_from_zero_halo2d_plain),
                   "residual_restrict_seg2d": (px2.residual_restrict_halo2d,
                                               px2.residual_restrict_halo2d_plain),
                   "prolong_smooth_seg2d": (px2.prolong_smooth_halo2d,
                                            px2.prolong_smooth_halo2d_plain)}
            label = f"{nx}x{ny} Li={li} Lj={lj}"
            for (name, red), call in calls.items():
                kern, plain = fns[name]
                outs = {}
                for ix, iy in ranks:
                    before = px2.LAUNCHES[name]
                    outs[ix, iy] = call(ix, iy, kern)
                    check(px2.LAUNCHES[name] - before == 1,  # each a one-pass stage
                          f"{name} n={n} {label}: {px2.LAUNCHES[name] - before} launches a call")
                    bitwise_same(results, name, n, f"{label} red_first={red} rank ({ix}, {iy}) "
                                 "against plain", outs[ix, iy], call(ix, iy, plain))
                stitched = torch.cat([torch.cat([outs[ix, iy] for iy in range(ny)], dim=1)
                                      for ix in range(nx)])
                want = wants[name, red]
                m = want.shape[0]
                bitwise_same(results, name, n, f"{label} red_first={red} stitched against the "
                             "single-device kernel", stitched[:m, :m].contiguous(), want)
                # (K40 writes e + P ec on pad points too, which nothing reads)
                check(name == "prolong_smooth_seg2d"
                      or (not stitched[m:].any() and not stitched[:, m:].any()),
                      f"{name} n={n} {label}: pad points not zero")
            outs, n2 = {}, 0.0
            for ix, iy in ranks:
                segs = [p5(x, ix, iy, 1, 1) for x in DF]
                got_r, got_n2 = px2.residual_df_norm_halo2d(*segs, g(ix, iy, 1), h, n, li, lj)
                plain_r, plain_n2 = px2.residual_df_norm_halo2d_plain(*segs, g(ix, iy, 1), h, n,
                                                                      li, lj)
                bitwise_same(results, "residual_df_norm_seg2d", n,
                             f"{label} r rank ({ix}, {iy}) against plain", got_r, plain_r)
                check(abs(float(got_n2) - float(plain_n2)) <= SHARDED_NORM_RTOL * float(plain_n2),
                      f"residual_df_norm_seg2d n={n} {label} rank ({ix}, {iy}): partial norm "
                      f"{float(got_n2)} against {float(plain_n2)}")
                outs[ix, iy] = got_r
                n2 += float(got_n2)
            stitched = torch.cat([torch.cat([outs[ix, iy] for iy in range(ny)], dim=1)
                                  for ix in range(nx)])
            bitwise_same(results, "residual_df_norm_seg2d", n, f"{label} r stitched against K5",
                         stitched[:n, :n].contiguous(), want_r)
            rel = abs(n2 - float(want_n2)) / float(want_n2)
            check(rel <= SHARDED_NORM_RTOL, f"residual_df_norm_seg2d n={n} {label}: norm rel {rel}")
            print(f"[sharded2d kernels n={n} {label}] K37-K41 bitwise equal to their plain "
                  f"versions and, stitched, to K1 and K2 (both orders), K3, K4, K5's r; sum of "
                  f"the partial ||r||^2 {n2:.9e} against K5's {float(want_n2):.9e} (rel {rel:.2e})")
            if n == 257 and (nx, ny) == (2, 2):
                timed = dict(U=U, F=F, EC=EC, DF=DF, li=li, lj=lj, n=n, h=h, p5=p5)

    # times on rank (0, 0)'s block of the 257^3 fields on 2x2 (the 4-rank solve's shapes)
    U, F, EC, DF, li, lj, n, h, p5 = (timed[k] for k in ("U", "F", "EC", "DF", "li", "lj", "n",
                                                          "h", "p5"))
    u4, f4 = p5(U, 0, 0, hh, hh), p5(F, 0, 0, hh, hh)
    u21, f21 = p5(U, 0, 0, 2, 1), p5(F, 0, 0, 2, 1)
    ec23 = p5(EC, 0, 0, 2, 3, li // 2, lj // 2)
    g = lambda halo: (-halo, -halo)  # noqa: E731
    ext_pts = (li + 2 * hh) * (lj + 2 * hh) * n
    calls = {
        # K37's one-pass stage reads u's and f's points, halos included, and
        # writes the fresh block
        "rb_smooth_seg2d": (lambda: px2.rb_smooth_halo2d(u4, f4, g(hh), h, 2, n, li, lj),
                            lambda: px2.rb_smooth_halo2d_plain(u4, f4, g(hh), h, 2, n, li, lj),
                            (*u4, *f4), li * lj * n),
        # K38's one-pass stage (K2's from a zero tile) reads f's points, halos
        # included, and writes the fresh block
        "rb_smooth_from_zero_seg2d": (
            lambda: px2.rb_smooth_from_zero_halo2d(f4, g(hh), h, 2, n, li, lj),
            lambda: px2.rb_smooth_from_zero_halo2d_plain(f4, g(hh), h, 2, n, li, lj),
            f4, li * lj * n),
        "residual_restrict_seg2d": (
            lambda: px2.residual_restrict_halo2d(u21, f21, g(2), h, n, li // 2, lj // 2),
            lambda: px2.residual_restrict_halo2d_plain(u21, f21, g(2), h, n, li // 2, lj // 2),
            (*u21, *f21), li * lj * n),
        "prolong_smooth_seg2d": (
            lambda: px2.prolong_smooth_halo2d(ec23, u4, f4, g(hh), h, 2, n, li, lj),
            lambda: px2.prolong_smooth_halo2d_plain(ec23, u4, f4, g(hh), h, 2, n, li, lj),
            (*ec23, *u4, *f4), ext_pts),
    }
    for name, (kernel, plain, inputs, points) in calls.items():
        out = kernel()
        outputs = out if isinstance(out, tuple) else (out,)
        res = results[name]
        res["ms"], res["plain_ms"] = time_ms(kernel), time_ms(plain)
        res["bound_ms"], res["bound_by"] = bound(name, points, inputs, outputs)
        print(f"[sharded2d kernel] {name:26s} n={n} Li={li} Lj={lj} rank (0, 0) of 2x2 "
              f"kernel_ms={res['ms']:.4f} plain_ms={res['plain_ms']:.4f} "
              f"bound_ms={res['bound_ms']:.4f} ({res['bound_by']}) "
              f"max_abs_err={res['max_abs_err']:.3e}")
    # K39, K37 and K38 on the 1x1 plan's 257^3 block (272^2, 15 pad rows and columns): the
    # shape of the one-rank solve (phase 12b); each bound from the bytes the function needs
    w = 272
    u1, f1 = (_seg_parts2d(x[:w, :w].contiguous(), 0, 0, w, w, 2, 1) for x in (U, F))
    k39 = lambda: px2.residual_restrict_halo2d(u1, f1, g(2), h, n, w // 2, w // 2)  # noqa: E731
    got = k39()
    bitwise_same(results, "residual_restrict_seg2d", n, "1x1 Li=Lj=272 against plain", got,
                 px2.residual_restrict_halo2d_plain(u1, f1, g(2), h, n, w // 2, w // 2))
    bound1, _ = bound("residual_restrict_seg2d", w * w * n, (8 * n ** 3,), (got,))
    print(f"[sharded2d kernel] residual_restrict_seg2d    n={n} Li={w} Lj={w} block (0, 0) of 1x1 "
          f"kernel_ms={time_ms(k39):.4f} bound_ms={bound1:.4f}")
    # K41's stage there, and K5 beside it, as K32's in phase 10a
    df1 = [_seg_parts2d(x[:w, :w].contiguous(), 0, 0, w, w, 1, 1) for x in DF]
    time_df_norm(results, "residual_df_norm_seg2d", "[sharded2d kernel] residual_df_norm_seg2d    "
                 f"  n={n} Li={w} Lj={w} block (0, 0) of 1x1",
                 lambda: px2.residual_df_norm_halo2d(*df1, g(1), h, n, w, w),
                 lambda: px2.residual_df_norm_halo2d_plain(*df1, g(1), h, n, w, w),
                 w * w * n, [x[:n, :n].contiguous() for x in DF], h)
    u1, f1 = (_seg_parts2d(x[:w, :w].contiguous(), 0, 0, w, w, hh, hh) for x in (U, F))
    nc, wc = (n + 1) // 2, w // 2
    c1 = EC.new_zeros((wc, wc, nc))
    c1[:nc, :nc] = EC[:nc, :nc]
    ec1 = _seg_parts2d(c1, 0, 0, wc, wc, 2, 3)
    one_rank = {
        "rb_smooth_seg2d": (lambda: px2.rb_smooth_halo2d(u1, f1, g(hh), h, 2, n, w, w),
                            lambda: px2.rb_smooth_halo2d_plain(u1, f1, g(hh), h, 2, n, w, w),
                            8 * n ** 3),
        "rb_smooth_from_zero_seg2d": (
            lambda: px2.rb_smooth_from_zero_halo2d(f1, g(hh), h, 2, n, w, w),
            lambda: px2.rb_smooth_from_zero_halo2d_plain(f1, g(hh), h, 2, n, w, w), 4 * n ** 3),
        # K40: e and r on the field's n^3 points and the coarse field's nc^3 read once
        "prolong_smooth_seg2d": (
            lambda: px2.prolong_smooth_halo2d(ec1, u1, f1, g(hh), h, 2, n, w, w),
            lambda: px2.prolong_smooth_halo2d_plain(ec1, u1, f1, g(hh), h, 2, n, w, w),
            8 * n ** 3 + 4 * nc ** 3),
    }
    for name, (kernel, plain, need) in one_rank.items():
        got = kernel()
        bitwise_same(results, name, n, "1x1 Li=Lj=272 against plain", got, plain())
        bound1, _ = bound(name, n * n * n, (need,), (got,))
        print(f"[sharded2d kernel] {name:26s} n={n} Li={w} Lj={w} block (0, 0) of 1x1 "
              f"kernel_ms={time_ms(kernel):.4f} bound_ms={bound1:.4f}")


def predicted_launches(hier, tiers, steps, inner_cycles, n_smooth=2,
                       norm="residual_df_norm_seg2d"):
    """The kernel launches of one (i, j)-sharded double-float solve of
    ``steps`` outer steps, from the tier map (gamma 1: every coarse visit
    starts from zero; the finest level's first cycle of each step too):
    per V-cycle and level, one launch of the smoothing from zero (K29's and
    K38's one-pass stages) or of the smoothing stage (K28's and K37's; 2
    n_smooth each in their first forms, past n_smooth 2), one residual +
    restriction, one prolongation + smoothing launch (K31's and K40's
    one-pass stages, as K28's); the replicated tail runs
    the single-device cycle (K1-K4) on each of its levels above the coarse
    LU, whose K1, K2 and K4 are one-pass stages: ceil(n_smooth / 2)
    launches a call; one ``norm`` launch (K41; K32 for the i-sharded
    solve, whose sharded levels are the "j-replicated" tier's kernels,
    K28-K31) per outer step and one before."""
    cycles, hs = steps * inner_cycles, 2 * n_smooth
    stage = -(-n_smooth // 2)  # K1's, K2's and K4's launches a call
    seg_stage = 1 if n_smooth <= 2 else hs  # K28's, K29's, K31's, K37's, K38's and K40's
    out = dict.fromkeys(SOURCES, 0)
    top = hier.num_levels - 1
    for depth, (n, tier) in enumerate(sorted(tiers.items(), reverse=True)):
        if tier == "replicated":
            levels = [m for m in hier.sizes[:top - depth + 1] if m > hier.coarse_n]
        elif tier in TIER_KERNELS:
            levels = [n]
        else:
            continue
        smooth, smooth0, rr, ps = TIER_KERNELS[tier]
        per_call = stage if tier == "replicated" else seg_stage
        for m in levels:
            first = depth == 0 and m == n
            out[smooth0] += per_call * (steps if first else cycles)
            out[smooth] += per_call * (cycles - steps) if first else 0
            out[rr] += cycles
            out[ps] += per_call * cycles
    out[norm] = steps + 1
    return out


def _sharded2d_solver(mesh2, init, plan=None):
    """The 257^3 double-float solve of phases 4 and 12 on (i, j)-sharded
    blocks: (run, plan, this rank's (u_hi, u_lo, f_hi, f_lo) blocks, tier
    map)."""
    import multigrid_parallel_tpu_torch as mg
    from multigrid_parallel_tpu_torch.parallel import sharded2d_padded as s2p

    hier = mg.Hierarchy(ndim=3, coarse_n=5, num_levels=7)
    cfg = mg.CycleConfig(n_smooth=2)
    run, plan = s2p.make_sharded2d_padded_df_solver(hier, cfg, mesh2, plan, rel_tol=REL_TOL,
                                                    max_cycles=40, inner_cycles=4,
                                                    init_norm=init)
    state = s2p.setup_df_problem_sharded2d_padded(mg.poisson_3d_quadratic(), hier, mesh2, plan)
    return run, plan, state, s2p.tier_map(hier, cfg, plan)


def sharded2d_one_rank(dev, card, launches, fused):
    """Phase 12b: make_sharded2d_padded_df_solver at 257^3 on one rank of an
    NCCL group (a 1x1 mesh), launch counts reset just before and read just
    after (added into ``launches``): exactly the launches predicted from the
    tier map (K37-K41 on the sharded levels 257^3 .. 33^3, K2-K4 in the
    replicated 17^3 tail), the fused single-device solve's outer steps
    (``fused``: phase 4's (u, outer steps, solve)), max|u - u_fused| = 0;
    then the walls interleaved with the fused solve (5 each), the device
    busy time of each, and the dry-run twin on this one rank (its 2D part
    needs an even rank count >= 4). Returns (u, outer steps)."""
    import torch.distributed as dist

    import multigrid_parallel_tpu_torch as mg
    from multigrid_parallel_tpu_torch import cycles_padded as cp
    from multigrid_parallel_tpu_torch.parallel import launch as ln
    from multigrid_parallel_tpu_torch.parallel import sharded as sh
    from multigrid_parallel_tpu_torch.parallel import sharded2d as s2
    from multigrid_parallel_tpu_torch.parallel import sharded2d_padded as s2p

    u_fused, it_fused, solve_fused = fused
    hier = mg.Hierarchy(ndim=3, coarse_n=5, num_levels=7)
    n = hier.finest_n
    init = cp.ref_init_norm(mg.poisson_3d_quadratic(), hier, dev)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{ln._free_port()}",
                            world_size=1, rank=0)
    try:
        mesh2 = s2.make_mesh_2d(1, 1)
        run, plan, state, tiers = _sharded2d_solver(mesh2, init)
        check((plan.n_sharded, plan.local_i(0), plan.local_j(0)) == (4, 272, 272),
              f"1x1 plan {plan}")
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        out = run(*state)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        counts = read_launches()
        u = s2p.unpad_solution2d(s2.gather_global2d(out[0], mesh2),
                                 s2.gather_global2d(out[1], mesh2), hier)
        it, nrm = out[3], float(out[2])
        du = float((u - u_fused).abs().max())
        want = predicted_launches(hier, tiers, it, 4)
        print(f"[solve {n}^3 sharded2d 1x1 nccl {mesh2.device}] plan={plan} tiers={tiers} "
              f"outer_steps={it} final_norm={nrm:.6e} rel={nrm / init:.3e} "
              f"max|u-u_fused|={du:.3e} finite={bool(torch.isfinite(u).all())} "
              f"first_run_s={first_s:.4f}")
        ran = {k: v for k, v in counts.items() if v}
        print(f"[launches {n}^3 sharded2d 1x1] {json.dumps(ran)}")
        check(bool(torch.isfinite(u).all()) and nrm <= REL_TOL * init,
              f"1x1 sharded2d solve not converged: {nrm}")
        check(it == it_fused, f"1x1 sharded2d solve: {it} outer steps, fused {it_fused}")
        check(du == 0.0, f"1x1 sharded2d solve: max|u - u_fused| = {du}")
        for name in SOURCES:
            check(counts[name] == want[name],
                  f"1x1 sharded2d: kernel {name} launched {counts[name]} times, predicted "
                  f"{want[name]}")
            launches[name] += counts[name]
        solve = lambda: run(*state)  # noqa: E731
        interleave({"sharded2d_1x1": solve, "fused": solve_fused}, f"{n}^3", card, reps=5)
        print_device_time({"sharded2d_1x1": solve, "fused": solve_fused}, f"{n}^3", card)
        t0 = time.perf_counter()
        print(f"[dryrun 1 rank nccl] {ln._dryrun_ranks(sh.make_mesh(1))} "
              f"({time.perf_counter() - t0:.1f} s)")
    finally:
        dist.destroy_process_group()
    return u, it


def _block_du(u_hi, u_lo, mesh2, plan, u_ref_path, n):
    """max|u - u_ref| over this rank's valid points (u_ref: the (n, n, n)
    f64 solution saved by phase 12b)."""
    from multigrid_parallel_tpu_torch.ops import pallas3d as pk

    li, lj = plan.local_i(0), plan.local_j(0)
    i0, j0 = mesh2.ix * li, mesh2.iy * lj
    i1, j1 = max(min(i0 + li, n), i0), max(min(j0 + lj, n), j0)
    if i1 == i0 or j1 == j0:
        return 0.0
    u = pk.df_to_f64(u_hi, u_lo)[:i1 - i0, :j1 - j0].cpu()
    u_ref = torch.from_numpy(np.array(np.load(u_ref_path, mmap_mode="r")[i0:i1, j0:j1]))
    return float((u - u_ref).abs().max())


def sharded2d_rank_main(mesh, init, u_ref_path):
    """Phase 12c on each host-staged gloo rank: the 257^3 (i, j)-sharded
    solve on the four ranks as a 2x2 mesh (a warm-up, then one run with the
    launch counts reset just before and read just after), this rank's
    max|u - u_ref| over its valid points, reduced over the ranks; the same
    on the 1x4 mesh under NARROW_2D (the j-replicated tier at 9^3); then the
    dry-run twin on the four ranks (its 2D part on a 2x2 mesh). Rank 0
    returns the results."""
    import torch.distributed as dist

    from multigrid_parallel_tpu_torch.parallel import launch as ln
    from multigrid_parallel_tpu_torch.parallel import sharded2d as s2

    out = {}
    for label, shape, spec in (("2x2", (2, 2), None), ("1x4 narrow", (1, 4), NARROW_2D)):
        mesh2 = s2.make_mesh_2d(*shape, device=mesh.device)
        plan = s2.ShardPlan2D(shape[0], shape[1], ("x", "y"), *spec) if spec else None
        run, plan, state, tiers = _sharded2d_solver(mesh2, init, plan)
        if label == "2x2":
            run(*state)  # warm-up
        torch.cuda.synchronize()
        dist.barrier()
        reset_launches()
        t0 = time.perf_counter()
        u_hi, u_lo, nrm, it = run(*state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_launches()
        du = torch.tensor([_block_du(u_hi, u_lo, mesh2, plan, u_ref_path, 257)])
        dist.all_reduce(du, op=dist.ReduceOp.MAX)
        per_rank = [None] * mesh.n_dev
        dist.all_gather_object(per_rank, (wall, counts))
        out[label] = {"plan": plan, "tiers": tiers, "it": it, "nrm": float(nrm),
                      "du": float(du), "per_rank": per_rank}
    t0 = time.perf_counter()
    dry = ln._dryrun_ranks(mesh)
    out["dryrun"] = (dry, time.perf_counter() - t0)
    out.update(backend=mesh.backend, device=str(mesh.device), staged=mesh.staged)
    return out if mesh.rank == 0 else None


def sharded2d_four_ranks(dev, card, launches, one_rank, tmp):
    """Phase 12c: four gloo ranks on the one card (halos and reductions
    staged through host memory; every kernel on the card) through
    parallel.launch: the 257^3 solve on a 2x2 mesh and on a 1x4 mesh under
    NARROW_2D, each in phase 12b's outer steps with u bitwise equal to its,
    each rank launching exactly the kernels predicted from the tier map
    (added into ``launches``), one host-staged wall a rank; and the dry-run
    twin with its 2D part."""
    import multigrid_parallel_tpu_torch as mg
    from multigrid_parallel_tpu_torch import cycles_padded as cp
    from multigrid_parallel_tpu_torch.parallel.launch import launch

    u_one, it_one = one_rank
    u_ref_path = tmp / "u_sharded2d_1x1.npy"
    np.save(u_ref_path, u_one.cpu().numpy())
    hier = mg.Hierarchy(ndim=3, coarse_n=5, num_levels=7)
    init = cp.ref_init_norm(mg.poisson_3d_quadratic(), hier, dev)
    t0 = time.perf_counter()
    res = launch(sharded2d_rank_main, SHARDED_RANKS, init, str(u_ref_path), backend="gloo",
                 device="cuda", timeout=600.0)[0]
    launch_s = time.perf_counter() - t0
    n = hier.finest_n
    check(res["staged"], f"4 gloo ranks not host-staged: {res['backend']} {res['device']}")
    for label in ("2x2", "1x4 narrow"):
        r = res[label]
        print(f"[solve {n}^3 sharded2d {label} {SHARDED_RANKS} ranks {res['backend']} on one "
              f"card, halos host-staged] plan={r['plan']} tiers={r['tiers']} "
              f"outer_steps={r['it']} final_norm={r['nrm']:.6e} max|u-u_1x1|={r['du']:.3e} | "
              f"host-staged wall (not a scaling figure) per rank s="
              f"{[round(w, 4) for w, _ in r['per_rank']]} | card: {card}")
        check(r["it"] == it_one, f"{label} sharded2d solve: {r['it']} outer steps, 1x1 {it_one}")
        check(r["du"] == 0.0, f"{label} sharded2d solve: max|u - u_1x1| = {r['du']}")
        check(("j-replicated" in r["tiers"].values()) == (label != "2x2"),
              f"{label} tiers {r['tiers']}")
        want = predicted_launches(hier, r["tiers"], r["it"], 4)
        for rank, (_, counts) in enumerate(r["per_rank"]):
            print(f"[launches {n}^3 sharded2d {label} rank {rank} of {SHARDED_RANKS}] "
                  f"{json.dumps({k: v for k, v in counts.items() if v})}")
            for name in SOURCES:
                check(counts[name] == want[name],
                      f"{label} sharded2d rank {rank}: kernel {name} launched {counts[name]} "
                      f"times, predicted {want[name]}")
                launches[name] += counts[name]
    dry, dry_s = res["dryrun"]
    check(" 2d(2x2) " in dry, f"the dry run's 2D part did not run: {dry}")
    print(f"[dryrun {SHARDED_RANKS} ranks gloo] {dry} ({dry_s:.1f} s)")
    print(f"[phase 12c] launch incl. spawn {launch_s:.1f} s")


def sharded2d_phase(dev, card, launches, results, fused):
    """Phase 12: the (i, j)-sharded solve: K37-K41 on simulated blocks
    (12a), the 257^3 solve on one NCCL rank against the fused solve (12b),
    and on four host-staged gloo ranks as 2x2 and 1x4 meshes (12c)."""
    import tempfile

    from multigrid_parallel_tpu_torch.ops import _build

    t_phase = time.perf_counter()
    compare_sharded2d(dev, results)
    print(f"[phase 12a] {time.perf_counter() - t_phase:.1f} s")
    one_rank = sharded2d_one_rank(dev, card, launches, fused)
    with tempfile.TemporaryDirectory(dir=_build.library_path().parent) as tmp_dir:
        sharded2d_four_ranks(dev, card, launches, one_rank, Path(tmp_dir))
    print(f"[phase 12] {time.perf_counter() - t_phase:.1f} s")


def compare_splitcolor(dev, results):
    """Phase 13a: K42 (K7's one-pass stage on the packed array) against its
    plain version at 65^3 and 257^3 on packed arrays of numpy-seeded
    zero-boundary cubes, n_iter 1-3, both orders, bit for bit, into a fresh
    array with u2 left as it is, each call launching exactly ceil(n_iter /
    2) times; against K7 (its pair joined along j) and K1 (through
    unpack_split) within FIELD_ULPS of max|u|, the gap printed in ulps
    (another addition order); K42 and its plain version timed at n_iter 2,
    red first."""
    from multigrid_parallel_tpu_torch.ops import pallas3d as pk
    from multigrid_parallel_tpu_torch.ops import pallas_split as ps
    from multigrid_parallel_tpu_torch.ops import pallas_splitcolor as psc
    from multigrid_parallel_tpu_torch.utils.timing import split_stage_bytes

    name = "rb_smooth_split_fused"
    res = results[name]
    for n in (65, 257):
        h = 1.0 / (n - 1)
        rng = np.random.default_rng(n)
        u, f = (torch.from_numpy(np.pad(rng.standard_normal((n - 2,) * 3).astype(np.float32), 1))
                .to(dev) for _ in range(2))
        u2, f2 = psc.pack_split(u), psc.pack_split(f)
        pu, pf = ps.pack_split(u), ps.pack_split(f)
        for n_iter in (1, 2, 3):
            for red_first in (True, False):
                label = f"n_iter={n_iter}_" + ("red_first" if red_first else "black_first")
                want = psc.rb_smooth_split_fused_plain(u2, f2, h, n_iter, red_first)
                before = psc.LAUNCHES[name]
                u0 = u2.clone()
                got = psc.rb_smooth_split_fused(u2, f2, h, n_iter, n, red_first)
                calls = psc.LAUNCHES[name] - before
                torch.cuda.synchronize()
                check(got is not u2 and torch.equal(u2, u0), f"{name}: u2 changed")
                err, tol, exact = field_err(got, want)
                k7 = torch.cat(ps.rb_smooth_split(pu[0].clone(), pu[1].clone(), *pf, h, n_iter,
                                                  red_first), dim=1)
                k1 = pk.rb_smooth_fused(u.clone(), f, h, n_iter, red_first)
                ulp = float(np.spacing(np.float32(want.abs().max().item())))
                gap7 = float((got - k7).abs().max())
                gap1 = float((psc.unpack_split(got) - k1).abs().max())
                times = ()
                if n_iter == 2 and red_first:
                    times = (time_ms(lambda: psc.rb_smooth_split_fused(u2, f2, h, 2, n, True)),
                             time_ms(lambda: psc.rb_smooth_split_fused_plain(u2, f2, h, 2, True)))
                print(f"[kernel] {name:26s} n={n:3d} {label:22s} max_abs_err={err:.3e} "
                      f"(tol {tol:.3e}) bitwise_equal={exact} launches={calls} | vs K7 "
                      f"{gap7 / ulp:.1f} ulp, vs K1 {gap1 / ulp:.1f} ulp of max|u| "
                      f"{float(want.abs().max()):.4f} (tol {FIELD_ULPS})"
                      + (f" kernel_ms={times[0]:.4f} plain_ms={times[1]:.4f}" if times else ""))
                check(err <= tol and exact, f"{name} n={n} {label}: {err} > {tol}, or not "
                      "bit for bit")
                check(calls == (n_iter + 1) // 2, f"{name} n={n} {label}: {calls} launches")
                check(max(gap7, gap1) <= FIELD_ULPS * ulp,
                      f"{name} n={n} {label}: {gap7 / ulp} / {gap1 / ulp} ulp from K7 / K1")
                res["max_abs_err"] = max(res["max_abs_err"], err)
                if times:
                    res["ms"], res["plain_ms"] = times
                    res["bound_ms"], res["bound_by"] = bound(
                        name, n ** 3, (split_stage_bytes(n, True, packed=True),), ())


def splitcolor_phase(dev, card, launches, results):
    """Phase 13: the packed split-colour stage (K42): against its plain
    version, K7 and K1 (13a), then its path, the stage bench
    profile_splitcolor_stage at 257^3, n_iter 2, with launch counts reset
    just before and read just after (13b)."""
    from multigrid_parallel_tpu_torch.ops import pallas3d as pk
    from multigrid_parallel_tpu_torch.ops import pallas_split as ps
    from multigrid_parallel_tpu_torch.ops import pallas_splitcolor as psc
    from multigrid_parallel_tpu_torch.utils.timing import profile_splitcolor_stage

    t_phase = time.perf_counter()
    compare_splitcolor(dev, results)
    n, n_iter = 257, 2
    torch.cuda.synchronize()
    reset_launches()
    rows = profile_splitcolor_stage(n, n_iter, reps=STAGE_REPS, device=dev)
    torch.cuda.synchronize()
    counts = read_launches()
    for label, seconds, nbytes, bound_s in rows:
        print(f"[splitcolor stage {n}^3] {label}: {1e3 * seconds:.4f} ms, "
              f"{nbytes / seconds / 1e9:.1f} GB/s of {nbytes / 1e6:.1f} MB one-pass, bound "
              f"{1e3 * bound_s:.4f} ms ({bound_s / seconds:.1%}) | card: {card}")
    check(len(rows) == 7 and all(np.isfinite(s) and s > 0 for _, s, _, _ in rows),
          "profile_splitcolor_stage: rows")
    k42_s, k7_s = rows[2][1], rows[4][1]
    print(f"[splitcolor stage {n}^3] packed K42 / pair K7 one-pass = {k42_s / k7_s:.3f} "
          f"({1e3 * k42_s:.4f} / {1e3 * k7_s:.4f} ms; K42's bound from the bytes it needs "
          f"{results['rb_smooth_split_fused']['bound_ms']:.4f} ms) | card: {card}")
    ran = {k: v for k, v in counts.items() if v}
    per_sweep = {**ps.PER_SWEEP_LAUNCHES, **pk.PER_SWEEP_LAUNCHES, **psc.PER_SWEEP_LAUNCHES}
    print(f"[launches {n}^3 splitcolor stage bench] {json.dumps(ran)} | per-sweep K7, K1 and "
          f"K42 {json.dumps(per_sweep)}")
    calls = STAGE_REPS + 1  # a warm-up call and STAGE_REPS timed ones
    want = {"rb_smooth_split_fused": calls,
            "rb_smooth_fused": calls, "rb_smooth_split": calls}  # one one-pass launch a call
    check(ran == want, f"stage bench launches {ran}, {want} expected")
    check(per_sweep == {"rb_smooth_split_per_sweep": 2 * n_iter * calls,
                        "rb_smooth_fused_per_sweep": 2 * n_iter * calls,
                        "rb_smooth_split_fused_per_sweep": 2 * n_iter * calls},
          f"stage bench per-sweep K7, K1 and K42 launches {per_sweep}")
    for name in SOURCES:
        launches[name] += counts[name]
    print(f"[phase 13] {time.perf_counter() - t_phase:.1f} s")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on one",
              file=sys.stderr)
        return 1
    import multigrid_parallel_tpu_torch as mg
    from multigrid_parallel_tpu_torch import cycles_padded as cp
    from multigrid_parallel_tpu_torch import cycles_split as cs
    from multigrid_parallel_tpu_torch.cycles import setup_problem
    from multigrid_parallel_tpu_torch.hierarchy import evaluate_on_grid
    from multigrid_parallel_tpu_torch.ops import _build
    from multigrid_parallel_tpu_torch import mixed_padded as mp
    from multigrid_parallel_tpu_torch.mixed_bc import MixedBCSolver
    from multigrid_parallel_tpu_torch.ops import pallas3d as pk
    from multigrid_parallel_tpu_torch.ops import pallas_mixed as pm
    from multigrid_parallel_tpu_torch.ops import pallas_mixed_fold as pmf
    from multigrid_parallel_tpu_torch.ops import pallas_mixed_split as pms
    from multigrid_parallel_tpu_torch.ops import pallas_split as ps

    dev = torch.device("cuda")
    card = card_line()
    print(f"[card] {card} | torch {torch.__version__} cuda {torch.version.cuda} "
          f"| {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # 1. build
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load()
    print(f"[build] {time.perf_counter() - t0:.2f} s -> {lib_path.name}")

    # 2. kernels against their plain versions
    es = mg.electrospray_problem()
    results = compare_kernels(pk, ps, pm, pmf, pms, es, dev)

    cfg = mg.CycleConfig(n_smooth=2)
    prob = mg.poisson_3d_quadratic()

    def df_path(hier, init, d, split=False, **kw):
        """(solve, to_cube): solve() runs the double-float solve from its
        setup and returns its outputs, (..., norm, n_outer); to_cube maps
        them to the f64 (n, n, n) solution."""
        if split:
            run = cs.make_split_df_solver(hier, cfg, rel_tol=REL_TOL, max_cycles=40,
                                          inner_cycles=4, init_norm=init, device=d)
            state = cs.setup_split_df_problem(prob, hier, d)
            return (lambda: run(*state)), (lambda out: cs.unsplit_solution(*out[:4], prob, hier))
        run = cp.make_on_device_df_solver(hier, cfg, rel_tol=REL_TOL, max_cycles=40,
                                          inner_cycles=4, init_norm=init, device=d, **kw)
        state = cp.setup_df_problem(prob, hier, d)
        return (lambda: run(*state)), (lambda out: pk.df_to_f64(*out[:2]))

    df_configs = {"unfused": dict(fused=False), "fused": dict(fused=True),
                  "fmg_fused": dict(fused=True, use_fmg=True), "split": dict(split=True)}

    # 3. small solves: card (kernels) against CPU (plain versions)
    hier33 = mg.Hierarchy(ndim=3, coarse_n=5, num_levels=4)
    init33 = cp.ref_init_norm(prob, hier33, dev)
    for label, kw in df_configs.items():
        small = {}
        for d in ("cpu", "cuda"):
            solve, to_cube = df_path(hier33, init33, d, **kw)
            out = solve()
            small[d] = (to_cube(out).cpu(), out[-1], float(out[-2]))
        du = float((small["cpu"][0] - small["cuda"][0]).abs().max())
        print(f"[solve 33^3 {label}] cpu steps={small['cpu'][1]} norm={small['cpu'][2]:.6e} | "
              f"cuda steps={small['cuda'][1]} norm={small['cuda'][2]:.6e} | max|du|={du:.3e}")
        check(small["cpu"][1] == small["cuda"][1], f"33^3 {label}: outer-step count cpu != cuda")
        check(du <= 1e-8, f"33^3 {label}: solutions differ by {du}")

    # 3b. the electrospray tiers at 33^3, V- and W-cycles (the split tier
    # also with two inner cycles, whose second finest-level cycle runs K21):
    # card against CPU. The split tier's card solves are paths of their
    # own: launch counts reset just before, read just after.
    launches = dict.fromkeys(SOURCES, 0)
    es33 = mg.Hierarchy(ndim=3, coarse_n=5, num_levels=4, length=es.length)
    tiers = {
        "": (mp.make_mixed_padded_df_solver, mp.setup_mixed_df_problem,
             lambda out, solver: mp.unpack_mixed_solution(out[0], out[1], es33)),
        " fold": (mp.make_mixed_fold_df_solver, mp.setup_mixed_fold_df_problem,
                  lambda out, solver: mp.unpack_mixed_fold_solution(out[0], out[1], solver)),
        " msplit": (mp.make_mixed_split_df_solver, mp.setup_mixed_split_df_problem,
                    lambda out, solver: mp.unpack_mixed_split_solution(*out[:4], solver)),
    }
    cycles = (("V", 1, 1), ("W", 2, 1))
    for tier, (make, setup, unpack) in tiers.items():
        for label, gamma, inner_cycles in cycles + ((("V_inner2", 1, 2),) if tier == " msplit"
                                                   else ()):
            label = f"{label}{tier}"
            small = {}
            for d in ("cpu", "cuda"):
                solver = MixedBCSolver(es, es33, n_smooth=2, gamma=gamma, device=d)
                run, state = make(solver, rel_tol=REL_TOL, inner_cycles=inner_cycles), setup(solver)
                torch.cuda.synchronize()
                reset_launches()
                out = run(*state)
                torch.cuda.synchronize()
                counts = read_launches()
                small[d] = (unpack(out, solver).cpu(), out[-1], float(out[-2]))
            du = float((small["cpu"][0] - small["cuda"][0]).abs().max())
            print(f"[solve 33^3 electrospray {label}] cpu steps={small['cpu'][1]} "
                  f"norm={small['cpu'][2]:.6e} | cuda steps={small['cuda'][1]} "
                  f"norm={small['cuda'][2]:.6e} | max|du|={du:.3e} V (tol {MIXED_DU_TOL:g})")
            check(small["cpu"][1] == small["cuda"][1],
                  f"33^3 electrospray {label}: outer-step count cpu != cuda")
            check(du <= MIXED_DU_TOL, f"33^3 electrospray {label}: solutions differ by {du} V")
            if tier == " msplit":
                print(f"[launches 33^3 electrospray {label}] {json.dumps(counts)}")
                # K21: one stage launch a call, a call each finest-level cycle
                # after an outer step's first
                want21 = small["cuda"][1] * (inner_cycles - 1)
                check(counts["mixed_rb_smooth_msplit"] == want21,
                      f"33^3 {label}: K21 launched {counts['mixed_rb_smooth_msplit']} times, "
                      f"expected {want21}")
                check(inner_cycles == 1 or want21 > 0, f"33^3 {label}: K21 never ran")
                for name in SOURCES:
                    launches[name] += counts[name]

    # 4. the main path: 257^3, each configuration
    hier = mg.Hierarchy(ndim=3, coarse_n=5, num_levels=7)
    n = hier.finest_n
    init = cp.ref_init_norm(prob, hier, dev)
    exact = evaluate_on_grid(prob.analytic, hier, hier.num_levels - 1, dev)
    mixed_state = setup_problem(prob, hier, dev)
    f_norm = float(torch.sqrt(torch.sum(mixed_state[1] ** 2)))
    mixed = cp.make_on_device_mixed_solver_pallas(hier, cfg, rel_tol=REL_TOL, max_cycles=40,
                                                  inner_cycles=2, device=dev)
    paths = {label: df_path(hier, init, dev, **kw) + (init,) for label, kw in df_configs.items()}
    paths["mixed_pallas"] = (lambda: mixed(*mixed_state)), (lambda out: out[0]), f_norm
    solved = {}
    for label, (solve, to_cube, ref_norm) in paths.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        out = solve()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        counts = read_launches()
        u, nrm, it = to_cube(out), float(out[-2]), out[-1]
        err = float(torch.sqrt(torch.sum((u - exact) ** 2)))
        print(f"[solve {n}^3 {label}] outer_steps={it} final_norm={nrm:.6e} "
              f"init_norm={ref_norm:.6e} rel={nrm / ref_norm:.3e} err_l2_vs_analytic={err:.3e} "
              f"finite={bool(torch.isfinite(u).all())} shape={tuple(u.shape)}")
        print(f"[launches {n}^3 {label}] {json.dumps(counts)}")
        check(tuple(u.shape) == (n, n, n) and bool(torch.isfinite(u).all()),
              f"{label}: solution not finite")
        check(it < 40 and nrm <= REL_TOL * ref_norm,
              f"{label} not converged: {nrm} > {REL_TOL} * {ref_norm}")
        check(err <= ERR_TOL, f"{label}: error vs analytic {err} > {ERR_TOL}")
        for name in SOURCES:
            ran = counts[name] > 0
            check(ran == (name in PATH_KERNELS[label]),
                  f"{label}: kernel {name} launched {counts[name]} times in the {n}^3 solve")
            launches[name] += counts[name]
        if label in STAGE_CALLS:  # one-pass stages: one launch a call (n_smooth 2)
            for name, calls in STAGE_CALLS[label].items():
                check(counts[name] == calls * it,
                      f"{label}: {name} launched {counts[name]} times, {calls} x {it} expected")
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = solve()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            check(out[-1] == it, f"{label}: outer-step count changed between runs")
        print(f"[wall {n}^3 {label}] first_run_s={first_s:.4f} "
              f"median_of_5_s={statistics.median(walls):.4f} "
              f"runs_s={[round(w, 4) for w in walls]} peak_mem_GiB="
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} card: {card}")
        solved[label] = (u, it)

    for label in ("unfused", "split"):
        du = float((solved[label][0] - solved["fused"][0]).abs().max())
        print(f"[{label} vs fused {n}^3] outer_steps {solved[label][1]} vs "
              f"{solved['fused'][1]} max|du|={du:.3e}")
        check(solved[label][1] == solved["fused"][1],
              f"{label} and fused outer-step counts differ")
        check(du <= 1e-8, f"{label} and fused solutions differ by {du}")

    # 5. split against fused, interleaved run by run (alternating which goes first),
    # then one traced solve of each: device busy, kernels, idle share
    interleave({"split": paths["split"][0], "fused": paths["fused"][0]}, f"{n}^3", card)
    print_device_time({"split": paths["split"][0], "fused": paths["fused"][0]}, f"{n}^3", card)

    # 6. the electrospray production solve at 257^3 (docs/MIXED_BC.md section 4)
    full = electrospray_257(es, dev, card, launches)

    # 7. the same solve on the fold tier, held against the full tier's
    fold = fold_257(es, dev, card, launches, full)

    # 8. the same solve on the split tier, held against the fold tier's
    msplit_257(es, dev, card, launches, fold)

    # 9. the driver surface: the f64 reference solve, MultigridSolver, the
    # smoother study on K1, the stage profile and the CLI
    driver_phase(dev, card, launches)

    # 10. the i-sharded solve: K28-K33 on simulated ranks, the 257^3 solve on
    # one NCCL rank against the fused solve, and on four host-staged gloo ranks;
    # 11. the same for the electrospray solve (K34-K36) against the full tier
    sharded_phase(dev, card, launches, results,
                  (solved["fused"][0], solved["fused"][1], paths["fused"][0]), full, es)

    # 12. the (i, j)-sharded solve: K37-K41 on simulated blocks, the 257^3
    # solve on one NCCL rank (1x1) against the fused solve, and on four
    # host-staged gloo ranks as a 2x2 mesh and as a 1x4 one (j-replicated tier)
    sharded2d_phase(dev, card, launches, results,
                    (solved["fused"][0], solved["fused"][1], paths["fused"][0]))

    # 13. the packed split-colour stage: K42 against its plain version, K7
    # and K1, then the stage bench at 257^3 (rect, packed, pair, per-sweep
    # pair, floor)
    splitcolor_phase(dev, card, launches, results)

    # no single PyTorch call computes any of these stencils: library_ms is null
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": results[name]["max_abs_err"],
         "ms": results[name]["ms"], "plain_ms": results[name]["plain_ms"],
         "bound_ms": results[name]["bound_ms"], "bound_by": results[name]["bound_by"],
         "library_ms": None}
        for name, (src, rep) in SOURCES.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
