"""Count the torch.profiler traces that lose device kernels, on one card:
the same calls traced again and again, which launch the same kernels
every time.

    python -m multigrid_parallel_tpu_torch.utils.trace_drops [--traces 60]
                                                             [--sizes 9 17 33]

Each trace holds 20 calls of K1 (``rb_smooth_fused``, n_iter 2, red
first), in its one-pass form (one kernel a call) and in its per-sweep form
(four), as ``chip_smoke.py``'s K1-by-level trace does, through
``split_trace.kernel_intervals``. For each size and form, one JSON line:
the kernels wanted and how many traces saw each count; the card's name
and power limit first.
"""

from __future__ import annotations

import argparse
import collections
import json
import subprocess

import numpy as np
import torch

from multigrid_parallel_tpu_torch.ops import pallas3d as pk
from multigrid_parallel_tpu_torch.utils.split_trace import kernel_intervals


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--traces", type=int, default=60)
    ap.add_argument("--sizes", type=int, nargs="+", default=[9, 17, 33])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("trace_drops needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    dev, calls = torch.device("cuda"), 20
    for n in args.sizes:
        h = 1.0 / (n - 1)
        u, f = (torch.from_numpy(np.random.default_rng(n + 1).standard_normal((n, n, n))
                                 .astype(np.float32)).to(dev) for _ in range(2))
        for form, fn, per_call in (
                ("one-pass", lambda: pk.rb_smooth_fused(u, f, h, 2, True), 1),
                ("per-sweep", lambda: pk.rb_smooth_fused_per_sweep(u, f, h, 2, True), 4)):
            fn()
            torch.cuda.synchronize()
            seen = collections.Counter(
                len(kernel_intervals(lambda: [fn() for _ in range(calls)]))
                for _ in range(args.traces))
            print(json.dumps({"n": n, "form": form, "want": calls * per_call,
                              "traces_by_count": dict(seen)}), flush=True)


if __name__ == "__main__":
    main()
