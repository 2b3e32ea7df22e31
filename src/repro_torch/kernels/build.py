"""Build and bind the port's CUDA kernels.

The sources under ``csrc/`` have a plain C interface, so ``nvcc``
compiles each (in parallel) and one ``nvcc -shared`` call links them into a
shared library that ``ctypes`` loads: no PyTorch headers, a build of
seconds.  The build runs at first use, from
the sources in this package only, into ``kernels/_build/`` (listed in
``.gitignore``), under a name that hashes the sources and flags, so an
edited source is rebuilt and an unchanged one is reused.  Importing this
module builds nothing.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = (CSRC / "decode_step.cu", CSRC / "decode_attention.cu",
           CSRC / "traj_logprob.cu", CSRC / "subtb_loss.cu",
           CSRC / "flash_attention.cu", CSRC / "flash_attention_wgmma.cu",
           CSRC / "rwkv6_scan.cu", CSRC / "rwkv6_chunk.cu",
           CSRC / "flash_attention_bwd.cu", CSRC / "rwkv6_scan_bwd.cu",
           CSRC / "flash_attention_bwd_wgmma.cu", CSRC / "rwkv6_chunk_bwd.cu")
#: headers the sources include (hashed with them)
HEADERS = (CSRC / "flash_attention.cuh", CSRC / "flash_attention_bwd.cuh",
           CSRC / "flash_wgmma_common.cuh")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-shared")

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


class DecodeAttentionArgs(ctypes.Structure):
    """Mirror of ``DecodeAttentionArgs`` in decode_attention.cu."""
    _fields_ = ([(n, ctypes.c_void_p)
                 for n in ("q", "k", "v", "kv_valid", "out")]
                + [(n, ctypes.c_int) for n in ("batch", "slots", "num_heads",
                                               "head_dim", "device")])


#: pointer fields of ``TrajLogprobArgs`` in traj_logprob.cu, in order
TRAJ_LOGPROB_PTRS = ("logits", "mask", "actions", "valid", "g_total",
                     "g_step", "total", "per_step", "dlogits", "arrivals")
#: stride fields (elements) of ``TrajLogprobArgs``, in order
TRAJ_LOGPROB_STRIDES = ("logits_sb", "logits_st", "mask_sb", "mask_st",
                        "actions_sb", "actions_st", "valid_sb", "valid_st",
                        "g_step_sb", "g_step_st")


class TrajLogprobArgs(ctypes.Structure):
    """Mirror of ``TrajLogprobArgs`` in traj_logprob.cu."""
    _fields_ = ([(n, ctypes.c_void_p) for n in TRAJ_LOGPROB_PTRS]
                + [(n, ctypes.c_longlong) for n in TRAJ_LOGPROB_STRIDES]
                + [(n, ctypes.c_int) for n in ("batch", "steps",
                                               "num_actions", "device")])


class SubtbArgs(ctypes.Structure):
    """Mirror of ``SubtbArgs`` in subtb_loss.cu."""
    _fields_ = ([(n, ctypes.c_void_p)
                 for n in ("phi", "length", "g", "loss", "dphi")]
                + [(n, ctypes.c_longlong) for n in ("phi_sb", "phi_st")]
                + [("lam", ctypes.c_float)]
                + [(n, ctypes.c_int) for n in ("batch", "states", "device")])


class FlashAttentionArgs(ctypes.Structure):
    """Mirror of ``FlashAttentionArgs`` in flash_attention.cuh."""
    _fields_ = ([(n, ctypes.c_void_p) for n in ("q", "k", "v", "out",
                                                 "lse")]
                + [(n, ctypes.c_int) for n in (
                    "batch", "q_len", "kv_size", "num_heads", "num_kv_heads",
                    "head_dim", "causal", "window", "q_offset", "kv_len",
                    "bf16", "device")])


class FlashAttentionBwdArgs(ctypes.Structure):
    """Mirror of ``FlashAttentionBwdArgs`` in flash_attention_bwd.cuh (both
    backward routes)."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "q", "k", "v", "out", "dout", "lse", "delta", "dq", "dk", "dv")]
                + [(n, ctypes.c_int) for n in (
                    "batch", "q_len", "kv_size", "num_heads", "num_kv_heads",
                    "head_dim", "causal", "window", "bf16", "device")])


class Rwkv6ScanArgs(ctypes.Structure):
    """Mirror of ``Rwkv6ScanArgs`` in rwkv6_scan.cu."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "r", "k", "v", "w", "u", "state_in", "out", "state_out", "carry")]
                + [(n, ctypes.c_int) for n in (
                    "batch", "steps", "num_heads", "dk", "dv", "bf16",
                    "device")])


class Rwkv6ChunkArgs(ctypes.Structure):
    """Mirror of ``Rwkv6ChunkArgs`` in rwkv6_chunk.cu."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "r", "k", "v", "w", "u", "state_in", "out", "state_out", "carry",
        "decay")]
                + [(n, ctypes.c_int) for n in (
                    "batch", "steps", "num_heads", "dk", "dv", "device")])


class Rwkv6ScanBwdArgs(ctypes.Structure):
    """Mirror of ``Rwkv6ScanBwdArgs`` in rwkv6_scan_bwd.cu."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "r", "k", "v", "w", "u", "carry", "dout", "dstate_out", "scratch",
        "grad_r", "grad_k", "grad_v", "grad_w", "grad_u", "grad_state")]
                + [(n, ctypes.c_int) for n in (
                    "batch", "steps", "num_heads", "dk", "dv", "bf16",
                    "device")])


class Rwkv6ChunkBwdArgs(ctypes.Structure):
    """Mirror of ``Rwkv6ChunkBwdArgs`` in rwkv6_chunk_bwd.cu."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "r", "k", "v", "w", "u", "carry", "dout", "dstate_out", "gstate",
        "decay", "grad_r", "grad_k", "grad_v", "grad_w", "grad_u",
        "grad_state")]
                + [(n, ctypes.c_int) for n in (
                    "batch", "steps", "num_heads", "dk", "dv", "device")])


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and Path("/usr/local/cuda/bin/nvcc").exists():
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                           "are built at first use and need the CUDA "
                           "toolkit")
    return nvcc


#: held while the library is built or loaded: the serving front's runner
#: threads may reach the first launch together, and two builds would run
#: nvcc into the same object files
_LOCK = threading.RLock()
_BUILT: Optional[tuple] = None
_LIBRARY: Optional[ctypes.CDLL] = None


def build() -> tuple:
    """Compile the kernels if needed: one ``nvcc -c`` per source, all
    started together, then one ``nvcc -shared`` link.  Returns ``(library
    path, compiler log)``; the log holds ptxas's register and shared-memory
    report when this call compiled, and is empty when it reused a built
    library.  Once per process, whichever threads ask."""
    global _BUILT
    with _LOCK:
        if _BUILT is None:
            digest = hashlib.sha256()
            for src in SOURCES + HEADERS:
                digest.update(src.read_bytes())
            digest.update(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            lib = BUILD_DIR / f"librepro_torch_{digest.hexdigest()[:16]}.so"
            _BUILT = (str(lib), "" if lib.exists() else _compile(lib))
        return _BUILT


def _compile(lib: Path) -> str:
    """Build ``lib`` from the sources; returns the compiler log."""
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs = [Path(tmpdir) / f"{src.stem}.o" for src in SOURCES]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(SOURCES, objs)]
        logs = [p.communicate()[0] for p in procs]
        log = "".join(logs)
        failed = [(src.name, p.returncode)
                  for src, p in zip(SOURCES, procs) if p.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n{log}")
        tmp = Path(tmpdir) / lib.name
        proc = subprocess.run([nvcc, *LINK_FLAGS, "-o", str(tmp),
                               *map(str, objs)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)
    return log + proc.stdout + proc.stderr


def library() -> ctypes.CDLL:
    """The built kernel library, loaded once per process."""
    global _LIBRARY
    with _LOCK:
        if _LIBRARY is None:
            _LIBRARY = _load(build()[0])
        return _LIBRARY


def _load(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    lib.repro_decode_step.argtypes = [ctypes.POINTER(DecodeStepArgs),
                                      ctypes.c_void_p]
    lib.repro_decode_step.restype = ctypes.c_int
    lib.repro_decode_attention.argtypes = [
        ctypes.POINTER(DecodeAttentionArgs), ctypes.c_void_p]
    lib.repro_decode_attention.restype = ctypes.c_int
    for fn in (lib.repro_traj_logprob_fwd, lib.repro_traj_logprob_bwd):
        fn.argtypes = [ctypes.POINTER(TrajLogprobArgs), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    for fn in (lib.repro_subtb_fwd, lib.repro_subtb_bwd):
        fn.argtypes = [ctypes.POINTER(SubtbArgs), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    for fn in (lib.repro_flash_attention, lib.repro_flash_attention_wgmma):
        fn.argtypes = [ctypes.POINTER(FlashAttentionArgs), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.repro_rwkv6_scan.argtypes = [ctypes.POINTER(Rwkv6ScanArgs),
                                     ctypes.c_void_p]
    lib.repro_rwkv6_scan.restype = ctypes.c_int
    for fn in (lib.repro_rwkv6_chunk, lib.repro_rwkv6_chunk_adjoint):
        fn.argtypes = [ctypes.POINTER(Rwkv6ChunkArgs), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    for fn in (lib.repro_flash_attention_bwd,
               lib.repro_flash_attention_bwd_wgmma):
        fn.argtypes = [ctypes.POINTER(FlashAttentionBwdArgs), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.repro_rwkv6_scan_bwd.argtypes = [ctypes.POINTER(Rwkv6ScanBwdArgs),
                                         ctypes.c_void_p]
    lib.repro_rwkv6_scan_bwd.restype = ctypes.c_int
    lib.repro_rwkv6_chunk_bwd.argtypes = [ctypes.POINTER(Rwkv6ChunkBwdArgs),
                                          ctypes.c_void_p]
    lib.repro_rwkv6_chunk_bwd.restype = ctypes.c_int
    return lib
