"""Checkpoint / resume of solver state, in the JAX package's own format
(``multigrid_parallel_tpu.utils.checkpoint``): one compressed npz with a
``meta`` JSON header and the finest ``u`` and ``f``. A checkpoint written
by either package loads into the other, and a half-finished solve
resumes bit-exactly (the cycle is a pure function of (u, f)).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple

import numpy as np
import torch

from multigrid_parallel_tpu_torch.cycles import CycleConfig
from multigrid_parallel_tpu_torch.hierarchy import Hierarchy

_FORMAT_VERSION = 1


def _dtype_name(dtype: torch.dtype) -> str:
    """The numpy name of a torch dtype ("float64"), as the JAX package
    writes ``np.dtype(hier.dtype).name``."""
    return torch.empty((), dtype=dtype).numpy().dtype.name


def save_state(path: str, u: torch.Tensor, f: torch.Tensor, hier: Hierarchy,
               cfg: Optional[CycleConfig] = None, extra: Optional[dict] = None) -> None:
    meta = {
        "format_version": _FORMAT_VERSION,
        "hierarchy": {
            "ndim": hier.ndim,
            "coarse_n": hier.coarse_n,
            "num_levels": hier.num_levels,
            "length": hier.length,
            "dtype": _dtype_name(hier.dtype),
        },
        "cycle_config": dataclasses.asdict(cfg) if cfg else None,
        "extra": extra or {},
    }
    np.savez_compressed(path, u=u.detach().cpu().numpy(), f=f.detach().cpu().numpy(),
                        meta=json.dumps(meta))


def load_state(path: str, device="cuda"
               ) -> Tuple[torch.Tensor, torch.Tensor, Hierarchy, Optional[CycleConfig], dict]:
    """(u, f, hier, cfg, extra), the fields in the checkpoint's dtype on
    ``device``."""
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["meta"]))
        if meta["format_version"] > _FORMAT_VERSION:
            raise ValueError(f"checkpoint from newer format: {meta['format_version']}")
        hm = meta["hierarchy"]
        hier = Hierarchy(ndim=hm["ndim"], coarse_n=hm["coarse_n"],
                         num_levels=hm["num_levels"], length=hm["length"],
                         dtype=getattr(torch, hm["dtype"]))
        cfg = CycleConfig(**meta["cycle_config"]) if meta["cycle_config"] else None
        u, f = (torch.from_numpy(np.array(data[k])).to(device=device, dtype=hier.dtype)
                for k in ("u", "f"))
        return u, f, hier, cfg, meta["extra"]
