"""Builds the CUDA kernels at first use and binds them with ``ctypes``.

``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, written to ``connectome_gnn_tpu_torch/
_build/`` under a name keyed by a hash of the sources.  A build writes a
temporary file and renames it into place, so concurrent builds race
safely.  Nothing is built at import: the first CUDA call does it.  A failed
build raises; there is no fallback.

``nvcc`` is taken from ``$CUDA_HOME/bin``, else from ``PATH``, else from
the toolkit's default location ``/usr/local/cuda/bin``.
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

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
]


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


def build() -> str:
    """Compile the kernels unless a library for these sources exists;
    returns the library's path."""
    digest = hashlib.sha1()
    for path in sources():
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + f.read())
    lib_path = os.path.join(BUILD_DIR, f"fused_forward_{digest.hexdigest()[:12]}.so")
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib_path}.tmp{os.getpid()}"
    cu = [p for p in sources() if p.endswith(".cu")]
    proc = subprocess.run(
        [find_nvcc(), *NVCC_FLAGS, "-o", tmp, *cu], capture_output=True, text=True
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib_path)
    return lib_path


@functools.cache
def library() -> ctypes.CDLL:
    """The built kernel library with every entry point's signature set."""
    lib = ctypes.CDLL(build())
    ptr, i32, size = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
    lib.cgt_fused_gcn_forward.argtypes = [ptr] * 12 + [i32] * 7 + [size, ptr]
    lib.cgt_fused_gcn_forward.restype = i32
    lib.cgt_fused_sage_forward.argtypes = [ptr] * 15 + [i32] * 7 + [size, ptr]
    lib.cgt_fused_sage_forward.restype = i32
    lib.cgt_error_string.argtypes = [i32]
    lib.cgt_error_string.restype = ctypes.c_char_p
    return lib
