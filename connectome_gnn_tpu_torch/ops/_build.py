"""Builds the CUDA kernels at first use and binds them with ``ctypes``.

Each ``csrc/*.cu`` is compiled by its own ``nvcc`` for ``sm_90a``, all of
them at once, and the objects are linked into one shared library with a
plain C interface, written to ``connectome_gnn_tpu_torch/_build/`` under a
name keyed by a hash of the sources.  A build writes temporary files and
renames the library into place, so concurrent builds race safely.  Nothing
is built at import: the first CUDA call does it.  A failed build raises;
there is no fallback.

``nvcc`` is taken from ``$CUDA_HOME/bin``, else from ``PATH``, else from
the toolkit's default location ``/usr/local/cuda/bin``.  The sources in
:data:`PTXAS_VERBOSE` are compiled with ``-Xptxas -v``; what ``ptxas`` says
of their kernels (registers, shared memory, spills) is kept beside the
library, and :func:`ptxas_report` returns it.  The library links only the
CUDA runtime: ``csrc/band_mma.cu`` reaches the driver's
``cuTensorMapEncodeTiled`` through the runtime's driver entry point.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-O3", "-std=c++17", "-Xcompiler", "-fPIC"]
#: sources whose kernels' register and shared-memory use the build records
PTXAS_VERBOSE = ("band_mma.cu", "fused_forward.cu", "row_gather.cu")


def sources() -> list[str]:
    return sorted(
        os.path.join(_CSRC, f)
        for f in os.listdir(_CSRC)
        if f.endswith((".cu", ".cuh"))
    )


def find_nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for path in candidates:
        if path and os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        "nvcc not found: set CUDA_HOME or put the CUDA toolkit's bin/ on PATH"
    )


def _stem() -> str:
    digest = hashlib.sha1()
    for path in sources():
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + f.read())
    return f"cgt_kernels_{digest.hexdigest()[:12]}"


def build() -> str:
    """Compile the kernels unless a library for these sources exists;
    returns the library's path."""
    stem = _stem()
    lib_path = os.path.join(BUILD_DIR, f"{stem}.so")
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc, tag = find_nvcc(), f"tmp{os.getpid()}"
    objects, procs = [], []
    for src in (p for p in sources() if p.endswith(".cu")):
        obj = os.path.join(BUILD_DIR, f"{stem}.{os.path.basename(src)}.{tag}.o")
        verbose = ["-Xptxas", "-v"] if os.path.basename(src) in PTXAS_VERBOSE else []
        objects.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *verbose, "-c", "-o", obj, src],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        ))
    failures, ptxas = [], []
    for proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{' '.join(proc.args)} ({proc.returncode}):\n{err}")
        elif "-v" in proc.args:
            ptxas.append(err)
    try:
        if failures:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
        tmp = os.path.join(BUILD_DIR, f"{stem}.ptxas.txt.{tag}")
        with open(tmp, "w") as f:
            f.write("".join(ptxas))
        os.replace(tmp, os.path.join(BUILD_DIR, f"{stem}.ptxas.txt"))
        tmp = f"{lib_path}.{tag}"
        proc = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", tmp, *objects],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, lib_path)
    finally:
        for obj in objects:
            if os.path.exists(obj):
                os.remove(obj)
    return lib_path


def ptxas_report() -> str:
    """What ``ptxas -v`` said when the library for these sources was built
    (the :data:`PTXAS_VERBOSE` sources); empty if it was not built here."""
    path = os.path.join(BUILD_DIR, f"{_stem()}.ptxas.txt")
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


@functools.cache
def library() -> ctypes.CDLL:
    """The built kernel library with every entry point's signature set."""
    lib = ctypes.CDLL(build())
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.cgt_fused_gcn_forward.argtypes = [ptr] * 12 + [i32] * 8 + [ptr]
    lib.cgt_fused_sage_forward.argtypes = [ptr] * 15 + [i32] * 8 + [ptr]
    lib.cgt_fused_smem_bytes.argtypes = [i32] * 6
    lib.cgt_banded_spmm_quant.argtypes = [ptr] * 4 + [i32] * 7 + [ptr]
    lib.cgt_banded_spmm_quant_fm.argtypes = [ptr] * 4 + [i32] * 7 + [i64, i64, ptr]
    lib.cgt_banded_spmm_quant_fm_w8a8.argtypes = [ptr] * 5 + [i32] * 6 + [ptr]
    lib.cgt_banded_spmm_quant_blocked.argtypes = [ptr] * 4 + [i32] * 5 + [ptr]
    lib.cgt_banded_spmm_quant_fm_bf16.argtypes = [ptr] * 4 + [i32] * 5 + [i64, i64, ptr]
    lib.cgt_banded_spmm_quant_blocked_bf16.argtypes = [ptr] * 4 + [i32] * 5 + [ptr]
    lib.cgt_banded_spmm_direct_f32.argtypes = [ptr] * 3 + [i32] * 7 + [ptr]
    lib.cgt_banded_spmm_direct_bf16.argtypes = [ptr] * 3 + [i32] * 7 + [ptr]
    lib.cgt_banded_spmm_w8a8_rowmajor.argtypes = [ptr] * 5 + [i32] * 6 + [ptr]
    lib.cgt_banded_spmm_quant_fused_dot.argtypes = [ptr] * 4 + [i32] * 8 + [ptr]
    lib.cgt_fm_bf16_band.argtypes = [ptr] * 4 + [i32] * 5 + [i64, i64, ptr]
    lib.cgt_fm_dma_only.argtypes = [ptr] * 3 + [i32] * 5 + [i64, i64, ptr]
    lib.cgt_fm_compute_only.argtypes = [ptr] * 5 + [i32] * 6 + [ptr]
    lib.cgt_row_gather.argtypes = [ptr] * 3 + [i64] * 2 + [i32] * 4 + [ptr]
    for entry in (
        "cgt_fused_gcn_forward", "cgt_fused_sage_forward", "cgt_banded_spmm_quant",
        "cgt_banded_spmm_quant_fm", "cgt_banded_spmm_quant_fm_w8a8",
        "cgt_banded_spmm_quant_blocked", "cgt_banded_spmm_quant_fm_bf16",
        "cgt_banded_spmm_quant_blocked_bf16", "cgt_banded_spmm_direct_f32",
        "cgt_banded_spmm_direct_bf16", "cgt_banded_spmm_w8a8_rowmajor",
        "cgt_banded_spmm_quant_fused_dot", "cgt_fm_bf16_band",
        "cgt_fm_dma_only", "cgt_fm_compute_only", "cgt_row_gather",
        "cgt_fused_smem_bytes",
    ):
        getattr(lib, entry).restype = i32
    lib.cgt_error_string.argtypes = [i32]
    lib.cgt_error_string.restype = ctypes.c_char_p
    return lib
