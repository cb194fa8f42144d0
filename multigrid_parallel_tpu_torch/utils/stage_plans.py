"""Time the rect stage kernels (K2's and K4's, ops/csrc/rect.cuh) on
candidate plans at each level size on one card: the planner's own, the
wavefront's and box plans of several block sizes, each held bit for bit
against its plain version.

    python -m multigrid_parallel_tpu_torch.utils.stage_plans [--sizes 9 17 33 65 129]
                                                             [--reps 20]

For each size and kernel (K2 from zero, K4, both at n_iter 2) and plan,
one JSON line: the plan, whether the output equals the plain version, and
the median device time of ``reps`` launches from a torch.profiler trace
(``utils.split_trace.kernel_intervals``). The numbers serve to tune
``pallas_split._stage_plan``'s choice between the wavefront and the box,
and the box's block size; the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import numpy as np
import torch

from multigrid_parallel_tpu_torch.ops import pallas3d as pk
from multigrid_parallel_tpu_torch.ops import pallas_split as ps
from multigrid_parallel_tpu_torch.utils.split_trace import kernel_intervals


def launch(plan, f, h, ec=None, u=None):
    """One launch of K2's stage (from zero, or on u) or, given ec, K4's (u
    is e) on ``plan``, into a fresh field."""
    out = torch.empty_like(f)
    args = (plan.n_iter, plan.bi, plan.bj, plan.bk, plan.k_halo, plan.threads, plan.smem,
            int(plan.box), pk._stream())
    lib = pk._lib()
    if ec is None:
        err = lib.mg_rect_stage(out.data_ptr(), None if u is None else u.data_ptr(),
                                f.data_ptr(), plan.n, h * h, 1, *args)
    else:
        err = lib.mg_rect_prolong_stage(out.data_ptr(), ec.data_ptr(), u.data_ptr(),
                                        f.data_ptr(), plan.n, h * h, *args)
    pk._check(err, "stage_plans")
    return out


def box(n, bi, bj, prolong, n_iter=2):
    """A box plan of bi planes x bj rows (whole rows), or None where it does
    not fit."""
    s, halo = n // 2, 2 * n_iter
    smem = ps._stage_smem(n_iter, bj, ps._stage_width(n, s, 0, True), prolong, True, box_bi=bi)
    if smem > ps.SMEM_MAX:
        return None
    rows = min(n, bi + 2 * halo) * min(n, bj + 2 * halo)
    threads = 32 * max(1, min(ps.RECT_MAX_THREADS // 32, -(-rows * ps._row_lanes(s) // 32)))
    return ps.StagePlan(n, n_iter, halo, 0, bi, bj, s, threads, smem, True, True)


def wave(n, bi, bj, prolong, n_iter=2):
    """A wavefront plan of bi planes x bj rows (whole rows), or None where
    it does not fit."""
    s, halo = n // 2, 2 * n_iter
    smem = ps._stage_smem(n_iter, bj, ps._stage_width(n, s, 0, True), prolong, True)
    if smem > ps.SMEM_MAX:
        return None
    rows = min(n, bj + 2 * halo)
    threads = 32 * max(1, min(ps.RECT_MAX_THREADS // 32, -(-rows * ps._row_lanes(s) // 32)))
    return ps.StagePlan(n, n_iter, halo, 0, bi, bj, s, threads, smem, True, False)


def evened(n, b):
    return -(-n // -(-n // min(b, n)))


def candidates(n, prolong, sms):
    """The planner's plan, the wavefront's, and box plans of square blocks
    and wavefront plans of a few box sizes."""
    plans = {"planner": ps._stage_plan(n, 2, sms, prolong=prolong, rect=True),
             "wave": ps._wave_plan(n, 2, sms, prolong, True)}
    for b in (1, 2, 3, 4, 6, 8, 10, 12, 16, 24, 33):
        b = evened(n, b)
        plan = box(n, b, b, prolong)
        if plan is not None:
            plans[f"box{b}x{b}"] = plan
    for bi, bj in ((8, 4), (8, 10), (16, 4), (16, 6), (33, 4)):
        bi, bj = evened(n, bi), evened(n, bj)
        plan = wave(n, bi, bj, prolong)
        if plan is not None and n >= 65:
            plans[f"wave{bi}x{bj}"] = plan
    return plans


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--sizes", type=int, nargs="+", default=[9, 17, 33, 65, 129])
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("stage_plans: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"[card] {card}", flush=True)
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for n in args.sizes:
        h = 1.0 / (n - 1)
        rng = np.random.default_rng(n)
        e, f, ec = (torch.from_numpy(rng.standard_normal((m, m, m)).astype(np.float32)).to(dev)
                    for m in (n, n, (n + 1) // 2))
        for kernel, prolong in (("K2", False), ("K4", True)):
            want = (pk.prolong_smooth_plain(ec, e, f, h, 2) if prolong
                    else pk.rb_smooth_from_zero_plain(f, h, 2, True))
            for label, plan in candidates(n, prolong, sms).items():
                run = ((lambda: launch(plan, f, h, ec=ec, u=e)) if prolong
                       else (lambda: launch(plan, f, h)))
                exact = bool(torch.equal(run(), want))
                torch.cuda.synchronize()
                times = [(b - a) / 1e3 for a, b, name, *_ in
                         kernel_intervals(lambda: [run() for _ in range(args.reps)])
                         if name.startswith("rect_")]
                print(json.dumps({"n": n, "kernel": kernel, "plan": label, "box": plan.box,
                                  "bi": plan.bi, "bj": plan.bj, "blocks": plan.blocks,
                                  "threads": plan.threads, "smem": plan.smem, "exact": exact,
                                  "device_ms": statistics.median(times) if times else None}),
                      flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
