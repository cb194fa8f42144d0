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
and prints each kernel's registers, stack frame and spill bytes, a line a
kernel; with ``--csrc DIR`` first, the sources of DIR (another
checkout's ``ops/csrc``), so that ``diff`` compares two trees' reports.
``--sass`` in place of ``--ptxas`` prints each kernel's machine code
(``cuobjdump -sass``) as its instruction count and a hash, a line a
kernel, so that the same ``diff`` shows which kernels' code changed.

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
    "mg_residual": (_P, _P, _P, _I, _F, _P),
    "mg_residual_df_norm_partials": (_I,),
    "mg_residual_df_norm": (_P, _P, _P, _P, _P, _P, _P, _I, _F, _P),
    # the streaming restrictions: pointers, n, inv_h2, the plan (bci, bcj,
    # bck, chunks, threads, smem), stream
    "mg_residual_restrict": (_P, _P, _P, _I, _F) + (_I,) * 6 + (_P,),
    "mg_residual_df": (_P, _P, _P, _P, _P, _I, _F, _P),
    "mg_df_step_partials": (_I,),
    "mg_df_step": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _F, _P),
    "mg_split_half_sweep": (_P, _P, _P, _I, _F, _I, _P),
    "mg_split_residual_restrict": (_P,) * 5 + (_I, _F) + (_I,) * 6 + (_P,),
    # the one-pass stages: pointers, n, h2, (red_first,) n_iter, the plan
    # (bi, bj, bk, k_halo, threads, smem), stream
    "mg_split_stage": (_P,) * 6 + (_I, _F, _I, _I) + (_I,) * 6 + (_P,),
    "mg_split_stage_from_zero": (_P,) * 4 + (_I, _F, _I, _I) + (_I,) * 6 + (_P,),
    "mg_split_prolong_stage": (_P,) * 7 + (_I, _F, _I) + (_I,) * 6 + (_P,),
    # the rect stages: the plan, then its box flag
    "mg_rect_stage": (_P,) * 3 + (_I, _F, _I, _I) + (_I,) * 7 + (_P,),
    "mg_rect_prolong_stage": (_P,) * 4 + (_I, _F, _I) + (_I,) * 7 + (_P,),
    # K26's: out, r, u, f, n, h2, inv_h2, red_first, n_iter, the plan and its box flag
    "mg_rect_resid_stage": (_P,) * 4 + (_I, _F, _F, _I, _I) + (_I,) * 7 + (_P,),
    "mg_split_df_partials": (_I,),
    "mg_split_residual_df_norm": (_P,) * 12 + (_I, _F, _P),
    "mg_split_df_step": (_P,) * 18 + (_I, _F, _P),
    "mg_splitcolor_half_sweep": (_P, _P, _I, _F, _I, _P),
    "mg_splitcolor_stage": (_P,) * 3 + (_I, _F, _I, _I) + (_I,) * 6 + (_P,),
    # the full-layout mixed stages (rect.cuh, kMixed): the rect stages' arguments with
    # the pins after the fields
    "mg_mixed_stage": (_P,) * 4 + (_I, _F, _I, _I) + (_I,) * 7 + (_P,),
    "mg_mixed_prolong_stage": (_P,) * 5 + (_I, _F, _I) + (_I,) * 7 + (_P,),
    "mg_residual_restrict_fold": (_P, _P, _P, _I, _F, _P),
    "mg_fold_residual_restrict": (_P, _P, _P, _I, _F) + (_I,) * 6 + (_P,),
    # the fold stages (rect.cuh, kFold): the rect stages' arguments with the pins
    # (and K19's coarse sign planes) after the fields
    "mg_fold_stage": (_P,) * 4 + (_I, _F, _I, _I) + (_I,) * 7 + (_P,),
    "mg_fold_prolong_stage": (_P,) * 6 + (_I, _F, _I) + (_I,) * 7 + (_P,),
    "mg_residual_df_norm_fold_partials": (_I,),
    "mg_residual_df_norm_fold": (_P, _P, _P, _P, _P, _P, _P, _I, _F, _P),
    # the msplit stages (split.cuh, MIXED): the split stages' arguments with the
    # pin packs (and K24's coarse sign planes) among the pointers
    "mg_msplit_stage": (_P,) * 7 + (_I, _F, _I, _I) + (_I,) * 6 + (_P,),
    "mg_msplit_prolong_stage": (_P,) * 9 + (_I, _F, _I) + (_I,) * 6 + (_P,),
    "mg_msplit_residual_restrict": (_P, _P, _P, _P, _P, _I, _F, _P),
    "mg_msplit_restrict_stage": (_P,) * 5 + (_I, _F) + (_I,) * 6 + (_P,),
    "mg_msplit_residual_df_norm_partials": (_I,),
    "mg_msplit_residual_df_norm": (_P,) * 12 + (_I, _F, _P),
    # segmented (i-sharded) blocks: each segment is (lh, body, rh[, r_off])
    "mg_seg_half_sweep": (_P, _P, _P, _I) * 2 + (_I,) * 5 + (_F, _I, _P),
    "mg_seg_half_sweep_from_zero": (_P,) * 6 + (_I,) * 6 + (_F, _I, _P),
    "mg_seg_prolong_correct_black": ((_P,) * 6 + (_I,) * 3 + (_P, _P, _P, _I) * 2
                                     + (_I,) * 4 + (_F, _P)),
    "mg_seg_residual_df_norm_partials": (_I, _I),
    "mg_seg_residual_df_norm": (_P,) * 3 + (_P, _P, _P, _I) * 2 + (_P, _P) + (_I,) * 3
                               + (_F, _P),
    # K33's streaming residual stage: r, the u segment, f's owned rows, the geometry
    # (kl, L, kr, n, g0), inv_h2, the plan (bi, bj, bk, chunks, threads, smem), stream
    "mg_seg_resid_stage": (_P,) + (_P, _P, _P, _I) + (_P,) + (_I,) * 5 + (_F,) + (_I,) * 6
                          + (_P,),
    # (i, j)-sharded blocks: each segment is a host descriptor (seg2d.cuh)
    "mg_seg2d_half_sweep": (_P, _P) + (_I,) * 6 + (_F, _I, _P),
    "mg_seg2d_half_sweep_from_zero": (_P, _P) + (_I,) * 6 + (_F, _I, _P),
    "mg_seg2d_prolong_correct_black": (_P,) * 4 + (_I,) * 6 + (_F, _P),
    "mg_seg2d_residual_df_norm_partials": (_I, _I, _I),
    "mg_seg2d_residual_df_norm": (_P,) * 7 + (_I,) * 5 + (_F, _P),
    "mg_seg_mixed_half_sweep":(_P, _P, _P, _I) * 2 + (_P,) + (_I,) * 5 + (_F, _I, _P),
    "mg_seg_mixed_bc_pass": (_P, _P, _P, _I, _P) + (_I,) * 5 + (_P,),
    "mg_seg_mixed_prolong_correct_black": ((_P,) * 6 + (_I,) * 3 + (_P, _P, _P, _I) * 2
                                           + (_P,) + (_I,) * 5 + (_F, _P)),
    # K34's and K35's, and K36's one-pass stages on segments: ..., h2,
    # (red_first,) the plan (n_iter, bi, bj, bk, k_halo, threads, smem, box),
    # stream; K34's and K35's fields out, the u segment (null for K35) and f's
    "mg_seg_mixed_stage": (_P,) + (_P, _P, _P, _I) * 2 + (_P,) + (_I,) * 5 + (_F,) + (_I,) * 9
                          + (_P,),
    "mg_seg_mixed_prolong_stage": ((_P,) * 4 + (_I,) * 3 + (_P, _P, _P, _I) * 2 + (_P,)
                                   + (_I,) * 5 + (_F,) + (_I,) * 8 + (_P,)),
    # K31's and K40's one-pass stages on segments: out, the coarse, e and r
    # segments (K40: descriptors, then the halos after the blocks), the
    # geometry, h2, the plan (n_iter, bi, bj, bk, k_halo, threads, smem,
    # box), stream
    "mg_seg_prolong_stage": ((_P,) * 4 + (_I,) * 3 + (_P, _P, _P, _I) * 2 + (_I,) * 5 + (_F,)
                             + (_I,) * 8 + (_P,)),
    "mg_seg2d_prolong_stage": (_P,) * 4 + (_I,) * 9 + (_F,) + (_I,) * 8 + (_P,),
    # K28's and K37's one-pass stages on segments: out, the u and f segments
    # (K37: descriptors, then the halos after the block), the geometry, h2,
    # red_first, the plan (n_iter, bi, bj, bk, k_halo, threads, smem, box), stream
    "mg_seg_smooth_stage": (_P,) + (_P, _P, _P, _I) * 2 + (_I,) * 5 + (_F,) + (_I,) * 9 + (_P,),
    "mg_seg2d_smooth_stage": (_P,) * 3 + (_I,) * 7 + (_F,) + (_I,) * 9 + (_P,),
    # K29's and K38's (K2's stage from a zero tile): the same with f's segments only
    "mg_seg_smooth_from_zero_stage": (_P,) + (_P, _P, _P, _I) + (_I,) * 5 + (_F,) + (_I,) * 9
                                     + (_P,),
    "mg_seg2d_smooth_from_zero_stage": (_P,) * 2 + (_I,) * 7 + (_F,) + (_I,) * 9 + (_P,),
    # K30's and K39's streaming restriction stages on segments: out, the e and
    # r segments (K39: descriptors, then the halos after the blocks), the
    # geometry, inv_h2, the plan (bci, bcj, bck, chunks, threads, smem), stream
    "mg_seg_restrict_stage": (_P,) + (_P, _P, _P, _I) * 2 + (_I,) * 5 + (_F,) + (_I,) * 6 + (_P,),
    "mg_seg2d_restrict_stage": (_P,) * 3 + (_I,) * 7 + (_F,) + (_I,) * 6 + (_P,),
    # K32's and K41's streaming df residual-and-norm stages: r, nrm2, the
    # partials and their count, the u_hi, u_lo, f_hi and f_lo segments (K41:
    # descriptors, then the halos after the block), the geometry, inv_h2, the
    # plan (bi, bj, bk, chunks, threads, smem), stream
    "mg_seg_df_stage": ((_P,) * 3 + (_I,) + (_P, _P, _P, _I) * 2 + (_P, _P) + (_I,) * 5
                        + (_F,) + (_I,) * 6 + (_P,)),
    "mg_seg2d_df_stage": (_P,) * 3 + (_I,) + (_P,) * 4 + (_I,) * 7 + (_F,) + (_I,) * 6 + (_P,),
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


def ptxas_report(names, csrc: Path = _CSRC) -> str:
    """ptxas's resource lines of each kernel of the named sources of
    ``csrc`` (by default this package's; another checkout's to compare
    two), each source compiled by its own nvcc with the build's flags and
    ``-Xptxas -v``, all started together: one line a kernel, ``source:
    kernel | stack frame and spills | registers``, sorted, the kernel's
    name demangled where cu++filt is found (the unnamed namespace's
    path-dependent tag dropped where not), so that two reports compare
    line by line."""
    nvcc = _nvcc()
    filt = Path(nvcc).with_name("cu++filt")
    with tempfile.TemporaryDirectory() as tmp:
        procs = {name: subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", str(Path(tmp) / f"{name}.o"),
             str(Path(csrc) / name)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for name in names}
        outs = {name: proc.communicate()[0] for name, proc in procs.items()}
    lines = []
    for name, out in outs.items():
        if procs[name].returncode != 0:
            raise RuntimeError(f"nvcc failed ({procs[name].returncode}) on {name}:\n{out}")
        kernel, parts = None, []
        for line in out.splitlines() + ["ptxas info    : Compiling entry function 'end'"]:
            found = re.search(r"Compiling entry function '(\w+)'", line)
            if found:
                if kernel is not None:
                    lines.append(f"{name}: {kernel} | " + " | ".join(parts))
                kernel, parts = _demangled(found.group(1), filt), []
            elif kernel is not None and ("registers" in line or "spill" in line):
                parts.append(line.split("ptxas info    :")[-1].strip())
    return "\n".join(sorted(lines))


def _demangled(name: str, filt: Path) -> str:
    """A kernel's name demangled where cu++filt is found, the unnamed
    namespace's path-dependent tag dropped, as ptxas_report prints it."""
    if filt.exists() and name.startswith("_Z"):
        name = subprocess.run([str(filt), name], capture_output=True, text=True).stdout.strip()
    return re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__", name)


def sass_report(names, csrc: Path = _CSRC) -> str:
    """Each kernel's machine code of the named sources of ``csrc``,
    compiled with the build's flags, all started together: one line a
    kernel, ``source: kernel | instructions | sha256 of its cuobjdump
    -sass text``, sorted, so that two trees' reports compare line by
    line."""
    nvcc = _nvcc()
    filt, objdump = Path(nvcc).with_name("cu++filt"), Path(nvcc).with_name("cuobjdump")
    with tempfile.TemporaryDirectory() as tmp:
        procs = {name: subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(Path(tmp) / f"{name}.o"), str(Path(csrc) / name)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for name in names}
        lines = []
        for name, proc in procs.items():
            out = proc.communicate()[0]
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}) on {name}:\n{out}")
            sass = subprocess.run([str(objdump), "-sass", str(Path(tmp) / f"{name}.o")],
                                  capture_output=True, text=True, check=True).stdout
            kernels, kernel = {}, None
            for line in sass.splitlines():
                found = re.match(r"\s*Function : (\S+)", line)
                if found:
                    kernel = _demangled(found.group(1), filt)
                    kernels[kernel] = []
                elif kernel is not None and re.search(r"/\*[0-9a-f]{4}\*/", line):
                    kernels[kernel].append(" ".join(line.split()))
            for kernel, code in kernels.items():
                digest = hashlib.sha256("\n".join(code).encode()).hexdigest()[:16]
                lines.append(f"{name}: {kernel} | {len(code)} instructions | sass {digest}")
    return "\n".join(sorted(lines))


if __name__ == "__main__":
    import sys

    args = sys.argv[1:]
    if len(args) < 2 or args[0] not in ("--ptxas", "--sass"):
        sys.exit("usage: python -m multigrid_parallel_tpu_torch.ops._build --ptxas | --sass "
                 "[--csrc DIR] SOURCE.cu ...")
    report = ptxas_report if args[0] == "--ptxas" else sass_report
    root = _CSRC
    if args[1] == "--csrc":
        root, args = Path(args[2]), args[2:]
    print(report(args[1:], root))
