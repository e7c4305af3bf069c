"""Build the CUDA kernels of ``csrc/`` on first use and load them with ctypes.

``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared`` compiles
``csrc/stationary.cu`` (plain C entry points, no PyTorch headers, so the
build takes seconds) into ``projected_lmc_tpu_torch/_build/``, a directory
that ``.gitignore`` lists. The library's name carries a hash of the source
and flags, so an edited source is rebuilt and never mixed with a stale
library. Nothing is built or loaded at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "stationary.cu"
BUILD_DIR = _PKG / "_build"
# --split-compile=0: the compiler's optimisation passes on every CPU
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "--split-compile=0")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "CUDA kernels are built on the machine with the card")
    return path


def build() -> Path:
    """Path of the shared library, compiling it if it is not there yet. The
    compiler's register/shared-memory report is kept beside it (``.log``)."""
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"libplmc_stationary_{tag}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    lib.with_suffix(".log").write_text(res.stdout + res.stderr)
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    lib = ctypes.CDLL(str(build()))
    P, I = ctypes.c_void_p, ctypes.c_int
    signatures = {
        "plmc_tile_size": [],
        "plmc_scaled_stack_sym": [P, P, P, P, I, I, I, I, I, I, P],
        "plmc_kernel_matrix": [P, P, P, P, I, I, I, I, I, P],
        "plmc_lowrank_reduce_sym": [P, P, P, P, P, P, P, I, I, I, I, I, P],
        "plmc_lowrank_reduce_sym_kr": [P] * 10 + [I] * 5 + [P],
        "plmc_lowrank_reduce_sym_krs": [P] * 11 + [I] * 6 + [P],
        "plmc_scaled_stack": [P] * 5 + [I] * 6 + [P],
        "plmc_quantized_stack": [P] * 4 + [I] * 8 + [P],
        "plmc_lowrank_reduce": [P] * 8 + [I] * 5 + [P],
        "plmc_lowrank_reduce_rows": [P] * 10 + [I] * 6 + [P],
        "plmc_lowrank_reduce_rows_kr": [P] * 12 + [I] * 6 + [P],
        "plmc_lowrank_reduce_rows_krs": [P] * 13 + [I] * 7 + [P],
        "plmc_kr_rows_runs": [I],
        "plmc_reduce_runs": [I],
        "plmc_max_features": [],
        "plmc_reduce_width": [I, I],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = I
    # K4/K5's and K7's scratch sizes, so that the caller allocates what the
    # kernels index
    for name, argtypes in (("plmc_kr_slot_count", [I]),
                           ("plmc_kr_pack_floats", [I, I]),
                           ("plmc_reduce_pack_floats", [I, I])):
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_longlong
    return lib
