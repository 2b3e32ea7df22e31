"""Build and bind the port's CUDA kernels.

The sources under ``csrc/`` have a plain C interface, so one ``nvcc
-shared`` call compiles them into a shared library that ``ctypes`` loads:
no PyTorch headers, a build of seconds.  The build runs at first use, from
the sources in this package only, into ``kernels/_build/`` (listed in
``.gitignore``), under a name that hashes the sources and flags, so an
edited source is rebuilt and an unchanged one is reused.  Importing this
module builds nothing.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = (CSRC / "decode_step.cu",)
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: pointer fields of ``DecodeStepArgs`` in decode_step.cu, in order
DECODE_STEP_PTRS = (
    "x_new", "k_cache", "v_cache", "lengths", "slot", "logit_temp",
    "gumbel", "mask",
    "ln1_scale", "ln1_bias", "q_w", "q_b", "kv_w", "kv_b", "proj_w",
    "proj_b", "ln2_scale", "ln2_bias", "ff1_w", "ff1_b", "ff2_w", "ff2_b",
    "ln_f_scale", "ln_f_bias", "q0", "w_out", "b_out",
    "action", "log_pf", "y")
#: int fields of ``DecodeStepArgs``, in order
DECODE_STEP_INTS = ("num_layers", "batch", "capacity", "dim", "num_heads",
                    "ff_dim", "num_actions", "device")


class DecodeStepArgs(ctypes.Structure):
    """Mirror of ``DecodeStepArgs`` in decode_step.cu."""
    _fields_ = ([(n, ctypes.c_void_p) for n in DECODE_STEP_PTRS]
                + [(n, ctypes.c_int) for n in DECODE_STEP_INTS])


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and Path("/usr/local/cuda/bin/nvcc").exists():
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                           "are built at first use and need the CUDA "
                           "toolkit")
    return nvcc


@functools.lru_cache(maxsize=None)
def build() -> tuple:
    """Compile the kernels if needed.  Returns ``(library path, compiler
    log)``; the log holds ptxas's register and shared-memory report when
    this call compiled, and is empty when it reused a built library."""
    digest = hashlib.sha256()
    for src in SOURCES:
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = BUILD_DIR / f"librepro_torch_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return str(lib), ""
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [find_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, SOURCES)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return str(lib), proc.stdout + proc.stderr


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built kernel library, loaded once per process."""
    path, _ = build()
    lib = ctypes.CDLL(path)
    lib.repro_decode_step.argtypes = [ctypes.POINTER(DecodeStepArgs),
                                      ctypes.c_void_p]
    lib.repro_decode_step.restype = ctypes.c_int
    lib.repro_decode_step_smem_bytes.argtypes = [ctypes.c_int] * 5
    lib.repro_decode_step_smem_bytes.restype = ctypes.c_size_t
    return lib
