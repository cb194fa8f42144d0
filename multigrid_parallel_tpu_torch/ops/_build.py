"""Build and load the hand-written CUDA kernels of ``ops/csrc``.

Each source is compiled by its own ``nvcc`` process, all started
together, and the objects are linked into one shared library with a
plain C interface, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
         -Xcompiler -fPIC -c -o <tmp>/<name>.o csrc/<name>.cu     (each .cu)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared
         -o _build/libmg_kernels_<hash>.so <tmp>/*.o

``--fmad=false`` (and no ``--use_fast_math``) keeps every f32 operation
a separate IEEE rounding, so the kernels match their plain PyTorch
versions bit for bit and the EFT two-sum chains stay exact.

``python -m multigrid_parallel_tpu_torch.ops._build --ptxas rb_smooth.cu
...`` compiles the named sources with the same flags and ``-Xptxas -v``
and prints each kernel's registers, stack frame and spill bytes.

The library is built at first use into ``multigrid_parallel_tpu_torch/
_build/`` (listed in .gitignore), named by a hash of the sources and the
flags, so an edited source rebuilds and an unchanged one loads at once.
Nothing here runs at import: the package and its CPU tests import
without ``nvcc`` or a GPU.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-Xcompiler", "-fPIC",
)
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# name -> argtypes of every exported launcher (all return a cudaError_t as int)
_SIGNATURES = {
    "mg_rb_half_sweep": (_P, _P, _I, _F, _I, _P),
    "mg_rb_half_sweep_from_zero": (_P, _P, _I, _F, _I, _P),
    "mg_residual": (_P, _P, _P, _I, _F, _P),
    "mg_residual_df_norm_partials": (_I,),
    "mg_residual_df_norm": (_P, _P, _P, _P, _P, _P, _P, _I, _F, _P),
    "mg_residual_restrict": (_P, _P, _P, _I, _F, _P),
    "mg_rb_last_sweep_residual": (_P, _P, _P, _I, _F, _F, _I, _P),
    "mg_residual_df": (_P, _P, _P, _P, _P, _I, _F, _P),
    "mg_df_step_partials": (_I,),
    "mg_df_step": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _F, _P),
    "mg_split_half_sweep": (_P, _P, _P, _I, _F, _I, _P),
    "mg_split_residual_restrict": (_P, _P, _P, _P, _P, _I, _F, _P),
    # the one-pass stages: pointers, n, h2, (red_first,) n_iter, the plan
    # (bi, bj, bk, k_halo, threads, smem), stream
    "mg_split_stage": (_P,) * 6 + (_I, _F, _I, _I) + (_I,) * 6 + (_P,),
    "mg_split_stage_from_zero": (_P,) * 4 + (_I, _F, _I, _I) + (_I,) * 6 + (_P,),
    "mg_split_prolong_stage": (_P,) * 7 + (_I, _F, _I) + (_I,) * 6 + (_P,),
    # the rect stages: the plan, then its box flag
    "mg_rect_stage": (_P,) * 3 + (_I, _F, _I, _I) + (_I,) * 7 + (_P,),
    "mg_rect_prolong_stage": (_P,) * 4 + (_I, _F, _I) + (_I,) * 7 + (_P,),
    "mg_split_df_partials": (_I,),
    "mg_split_residual_df_norm": (_P,) * 12 + (_I, _F, _P),
    "mg_split_df_step": (_P,) * 18 + (_I, _F, _P),
    "mg_splitcolor_half_sweep": (_P, _P, _I, _F, _I, _P),
    "mg_mixed_half_sweep": (_P, _P, _P, _I, _F, _I, _P),
    "mg_mixed_bc_pass": (_P, _P, _I, _P),
    "mg_mixed_prolong_correct_black": (_P, _P, _P, _P, _P, _I, _F, _P),
    "mg_mixed_fold_half_sweep": (_P, _P, _P, _I, _F, _I, _P),
    "mg_mixed_fold_half_sweep_from_zero": (_P, _P, _I, _F, _I, _P),
    "mg_mixed_fold_bc_pass": (_P, _P, _I, _P),
    "mg_residual_restrict_fold": (_P, _P, _P, _I, _F, _P),
    "mg_mixed_fold_prolong_correct_black": (_P, _P, _P, _P, _P, _P, _I, _F, _P),
    "mg_residual_df_norm_fold_partials": (_I,),
    "mg_residual_df_norm_fold": (_P, _P, _P, _P, _P, _P, _P, _I, _F, _P),
    "mg_msplit_half_sweep": (_P, _P, _P, _P, _I, _F, _I, _P),
    "mg_msplit_half_sweep_from_zero": (_P, _P, _P, _I, _F, _I, _P),
    "mg_msplit_bc_pass": (_P, _P, _P, _I, _P),
    "mg_msplit_residual_restrict": (_P, _P, _P, _P, _P, _I, _F, _P),
    "mg_msplit_prolong_correct_red": (_P, _P, _P, _P, _I, _P),
    "mg_msplit_prolong_correct_black": (_P, _P, _P, _P, _P, _P, _P, _I, _F, _P),
    "mg_msplit_residual_df_norm_partials": (_I,),
    "mg_msplit_residual_df_norm": (_P,) * 12 + (_I, _F, _P),
    # segmented (i-sharded) blocks: each segment is (lh, body, rh[, r_off])
    "mg_seg_half_sweep": (_P, _P, _P, _I) * 2 + (_I,) * 5 + (_F, _I, _P),
    "mg_seg_half_sweep_from_zero": (_P,) * 6 + (_I,) * 6 + (_F, _I, _P),
    "mg_seg_residual_restrict": (_P,) + (_P, _P, _P, _I) * 2 + (_I,) * 5 + (_F, _P),
    "mg_seg_prolong_correct_black": ((_P,) * 6 + (_I,) * 3 + (_P, _P, _P, _I) * 2
                                     + (_I,) * 4 + (_F, _P)),
    "mg_seg_residual_df_norm_partials": (_I, _I),
    "mg_seg_residual_df_norm": (_P,) * 3 + (_P, _P, _P, _I) * 2 + (_P, _P) + (_I,) * 3
                               + (_F, _P),
    "mg_seg_residual": (_P, _P, _P, _P, _I, _P, _I, _I, _I, _F, _P),
    # (i, j)-sharded blocks: each segment is a host descriptor (seg2d.cuh)
    "mg_seg2d_half_sweep": (_P, _P) + (_I,) * 6 + (_F, _I, _P),
    "mg_seg2d_half_sweep_from_zero": (_P, _P) + (_I,) * 6 + (_F, _I, _P),
    "mg_seg2d_residual_restrict": (_P,) * 3 + (_I,) * 5 + (_F, _P),
    "mg_seg2d_prolong_correct_black": (_P,) * 4 + (_I,) * 6 + (_F, _P),
    "mg_seg2d_residual_df_norm_partials": (_I, _I, _I),
    "mg_seg2d_residual_df_norm": (_P,) * 7 + (_I,) * 5 + (_F, _P),
    "mg_seg_mixed_half_sweep":(_P, _P, _P, _I) * 2 + (_P,) + (_I,) * 5 + (_F, _I, _P),
    "mg_seg_mixed_bc_pass": (_P, _P, _P, _I, _P) + (_I,) * 5 + (_P,),
    "mg_seg_mixed_prolong_correct_black": ((_P,) * 6 + (_I,) * 3 + (_P, _P, _P, _I) * 2
                                           + (_P,) + (_I,) * 5 + (_F, _P)),
}


def _sources():
    return sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda)")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return _BUILD_DIR / f"libmg_kernels_{h.hexdigest()[:16]}.so"


def _spawn(cmd):
    return cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                 text=True)


def _finish(job) -> None:
    cmd, proc = job
    out, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}\n{err}")


def build() -> Path:
    """Compile the kernels unless a library of these sources exists."""
    out = library_path()
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=_BUILD_DIR))
    nvcc = _nvcc()
    try:
        jobs = [_spawn([nvcc, *NVCC_FLAGS, "-c", "-o", str(tmp / f"{src.stem}.o"), str(src)])
                for src in sorted(_CSRC.glob("*.cu"))]
        try:
            for job in jobs:
                _finish(job)
        finally:
            for _, proc in jobs:  # a failed compile stops the others
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        lib = tmp / "lib.so"
        _finish(_spawn([nvcc, *LINK_FLAGS, "-o", str(lib),
                        *(str(o) for o in sorted(tmp.glob("*.o")))]))
        os.replace(lib, out)  # atomic: a concurrent loader sees all or nothing
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The kernel library, built on first use, with argtypes set."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def ptxas_report(names) -> str:
    """ptxas's resource lines (registers, stack frame, spills) of each
    kernel of the named ``csrc`` sources, compiled with the build's flags
    and ``-Xptxas -v``; mangled names demangled where cu++filt is found."""
    nvcc = _nvcc()
    filt = Path(nvcc).with_name("cu++filt")
    lines = []
    with tempfile.TemporaryDirectory() as tmp:
        for name in names:
            cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", str(Path(tmp) / "k.o"),
                   str(_CSRC / name)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                                   f"{proc.stdout}\n{proc.stderr}")
            for line in (proc.stdout + proc.stderr).splitlines():
                if "entry function" in line or "registers" in line or "spill" in line:
                    found = re.search(r"'(_Z\w+)'", line)
                    if found and filt.exists():
                        name_d = subprocess.run([str(filt), found.group(1)], capture_output=True,
                                                text=True).stdout.strip()
                        line = line.replace(found.group(1), name_d)
                    lines.append(f"{name}: {line.strip()}")
    return "\n".join(lines)


if __name__ == "__main__":
    import sys

    if len(sys.argv) < 3 or sys.argv[1] != "--ptxas":
        sys.exit("usage: python -m multigrid_parallel_tpu_torch.ops._build --ptxas SOURCE.cu ...")
    print(ptxas_report(sys.argv[2:]))
