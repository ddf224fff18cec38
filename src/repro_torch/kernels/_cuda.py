"""Build and bind the hand-written CUDA kernels of the port.

The sources live in ``repro_torch/csrc``.  At first use they are compiled
with ``nvcc`` for ``sm_90a`` into a shared library with a plain C
interface, which is loaded with ``ctypes`` (no PyTorch headers, so a build
takes seconds).  The library lands in ``repro_torch/_build`` under a name
that hashes the source and the flags, so an edited source is rebuilt and
concurrent processes never load a half-written file.

Every wrapper that launches a kernel adds one to its entry in
:data:`LAUNCHES`; a run reads the counts to show which kernels its path
went through.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCE = CSRC / "cosine_gate.cu"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# ring / operand dtype codes of the C interface
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES = {"fused_sample_2d": 0, "cosine_weight_2d": 0,
            "cosine_weights_2d": 0}

_lib = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (looked on PATH and in "
                           f"{home}/bin): the CUDA kernels cannot be built")
    return path


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libcosine_gate_{digest[:16]}.so"


def build() -> dict:
    """Compile the kernel library if it is not built yet.

    -> {"path", "seconds", "log"}: ``log`` is nvcc's output (register and
    shared-memory use per kernel from ``-Xptxas -v``), empty when the
    library was already there."""
    out = library_path()
    if out.exists():
        return {"path": str(out), "seconds": 0.0, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) on "
                               f"{SOURCE}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return {"path": str(out), "seconds": time.perf_counter() - t0,
            "log": proc.stdout + proc.stderr}


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(build()["path"])
        fn = handle.cosine_gate
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_float, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        handle.cosine_gate_error_string.argtypes = [ctypes.c_int]
        handle.cosine_gate_error_string.restype = ctypes.c_char_p
        _lib = handle
    return _lib


def _ptr(t):
    return None if t is None else t.data_ptr()


def launch_cosine_gate(name: str, *, slot, n_slots: int, slot_stride: int,
                       a, z, dz, w, cot, thresh: float) -> None:
    """Launch ``csrc/cosine_gate.cu`` on the current stream of ``a``'s
    device.  The caller has checked devices, dtypes, shapes and
    contiguity and allocated ``w`` / ``cot``."""
    B, F = a.shape
    handle = lib()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        status = handle.cosine_gate(
            _ptr(slot), n_slots, slot_stride, _ptr(a), _ptr(z), _ptr(dz),
            _ptr(w), _ptr(cot), B, F, thresh, DTYPE_CODES[z.dtype], stream)
    if status != 0:
        msg = handle.cosine_gate_error_string(status).decode()
        raise RuntimeError(f"{name}: cosine_gate launch failed: {msg} "
                           f"({status})")
    LAUNCHES[name] += 1
