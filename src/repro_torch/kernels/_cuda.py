"""Build and bind the hand-written CUDA kernels of the port.

The sources live in ``repro_torch/csrc``.  At first use every ``*.cu``
there is compiled with ``nvcc`` for ``sm_90a`` (one ``nvcc`` per source,
all started together) and the objects are linked into one shared library
with a plain C interface, which is loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds).  The ``*.cuh`` headers there are
included by the sources, not compiled on their own.  The library lands in
``repro_torch/_build`` under a name that hashes every source, every
header and the flags, so an edited source or header is rebuilt and
concurrent processes never load a half-written file.

Every wrapper that launches a kernel adds one to its entry in
:data:`LAUNCHES`; a run reads the counts to show which kernels its path
went through.

A tensor without data (on the meta device, or a ``FakeTensor``) is
*abstract* (:func:`is_abstract`): there a wrapper allocates what the
card's launch allocates (its outputs, the LSE, the split-row workspace)
and computes nothing, and, while a :class:`Accountant` is installed
(:func:`accounting`), adds the kernel's operations and bytes, by the
formulas its bound uses, to it.  That is how ``launch/budget.py`` and
``launch/dryrun.py`` trace the model as the card runs it.
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
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")
COMPILE_FLAGS = ARCH_FLAGS + ("-Xptxas", "-v")
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

# ring / operand dtype codes of the C interface
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES = {"fused_sample_2d": 0, "cosine_weight_2d": 0,
            "cosine_weights_2d": 0, "quantize_sr_2d": 0,
            "fused_sample_q8_2d": 0, "fused_sample_q4_2d": 0,
            "fused_adagrad": 0, "fused_adagrad_q8": 0,
            "fused_dequant_q8_2d": 0, "fused_dequant_q4_2d": 0,
            "flash_attention": 0, "flash_attention_fwd_lse": 0,
            "flash_attention_bwd_dkv": 0, "flash_attention_bwd_dq": 0}

_lib = None
# False in a spawned rank (``launch/dist.py``): the caller builds the
# library before it starts the world, and a rank that finds none raises
BUILD = True

_P, _I, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
# C entry points: argument types (every pointer and the stream as
# c_void_p, or ctypes would pass them as 32-bit ints)
_SIGNATURES = {
    "cosine_gate": [_P, _I, _LL, _P, _P, _P, _P, _P, _I, _I, _F, _I, _P,
                    _LL, _I, _P, _P, _P],
    "cosine_gate_quant": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _F,
                          _I, _P, _LL, _I, _P, _P, _P],
    "quantize_sr": [_P, _P, _P, _P, _I, _I, _F, _I, _P, _LL, _P],
    "fused_adagrad": [_P, _P, _F, _F, _I, _P],
    "fused_adagrad_q8": [_P, _P, _F, _F, _I, _P],
    "fused_adagrad_layout": [_P],
    "ring_dequant": [_P, _I, _P, _P, _P, _I, _I, _I, _P],
    "flash_attention_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F,
                            _I, _P],
    "flash_attention_bwd_dkv": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                _I, _I, _I, _F, _I, _P],
    "flash_attention_bwd_dq": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                               _I, _I, _F, _I, _P],
}


# The leaf tables of ``csrc/fused_adagrad.cu`` (K7, K8), passed by value
# to the kernels; :func:`lib` checks these mirrors against the C layout.
ADAGRAD_LEAVES = 48        # leaves a launch
ADAGRAD_CHUNK = 1024       # K7 elements a block
ADAGRAD_MAX_COLS = 1024    # K8's widest row


class K7Leaf(ctypes.Structure):
    _fields_ = [("g", _P), ("a", _P), ("a_out", _P), ("dst", _P),
                ("n", _LL), ("flags", _I), ("pad", _I)]


class K7Table(ctypes.Structure):
    _fields_ = [("leaf", K7Leaf * ADAGRAD_LEAVES),
                ("start", _I * (ADAGRAD_LEAVES + 1)), ("n_leaves", _I)]


class K8Leaf(ctypes.Structure):
    _fields_ = [("g", _P), ("q", _P), ("s", _P), ("q_out", _P),
                ("s_out", _P), ("noise", _P), ("dst", _P), ("n", _LL),
                ("C", _I), ("flags", _I)]


class K8Table(ctypes.Structure):
    _fields_ = [("leaf", K8Leaf * ADAGRAD_LEAVES),
                ("start", _I * (ADAGRAD_LEAVES + 1)), ("n_leaves", _I)]


def _check_adagrad_layout(handle) -> None:
    got = (ctypes.c_longlong * 5)()
    handle.fused_adagrad_layout(ctypes.addressof(got))
    want = (ctypes.sizeof(K7Table), ctypes.sizeof(K8Table), ADAGRAD_LEAVES,
            ADAGRAD_CHUNK, ADAGRAD_MAX_COLS)
    if tuple(got) != want:
        raise RuntimeError(f"csrc/fused_adagrad.cu's table layout "
                           f"{tuple(got)} is not its ctypes mirror's {want}")


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def is_abstract(t) -> bool:
    """True for a tensor that holds no data: on the meta device, or a
    ``FakeTensor`` (whatever device it reports)."""
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor) or t.device.type == "meta"


class Accountant:
    """The kernels' costs over a trace: {name: [calls, operations,
    bytes]}, added by the wrappers on abstract tensors."""

    def __init__(self):
        self.kernels = {}

    def add(self, name: str, flops: float, nbytes: float) -> None:
        row = self.kernels.setdefault(name, [0, 0, 0])
        row[0] += 1
        row[1] += int(flops)
        row[2] += int(nbytes)

    def flops(self) -> int:
        return sum(r[1] for r in self.kernels.values())

    def nbytes(self) -> int:
        return sum(r[2] for r in self.kernels.values())


_ACCOUNTANT = None


class accounting:
    """``with accounting() as acc:`` installs a fresh :class:`Accountant`
    (restoring the previous one on exit)."""

    def __enter__(self) -> Accountant:
        global _ACCOUNTANT
        self._prev, _ACCOUNTANT = _ACCOUNTANT, Accountant()
        return _ACCOUNTANT

    def __exit__(self, *exc) -> None:
        global _ACCOUNTANT
        _ACCOUNTANT = self._prev


def account(name: str, flops: float, nbytes: float) -> None:
    """A wrapper's abstract call: add its costs to the installed
    accountant, if any."""
    if _ACCOUNTANT is not None:
        _ACCOUNTANT.add(name, flops, nbytes)


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


def sources() -> list:
    """The ``*.cu`` files: each is compiled to one object."""
    return sorted(CSRC.glob("*.cu"))


def headers() -> list:
    """The ``*.cuh`` files the sources include."""
    return sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256()
    for src in sources() + headers():
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    h.update(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    return BUILD_DIR / f"librepro_torch_{h.hexdigest()[:16]}.so"


def build() -> dict:
    """Compile the kernel library if it is not built yet.

    -> {"path", "seconds", "log"}: ``log`` is nvcc's output (register and
    shared-memory use per kernel from ``-Xptxas -v``), empty when the
    library was already there."""
    out = library_path()
    if out.exists():
        return {"path": str(out), "seconds": 0.0, "log": ""}
    if not BUILD:
        raise RuntimeError(f"{out} is not built: build the kernels "
                           f"(kernels._cuda.build()) before starting the "
                           f"ranks")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, src.stem + ".o") for src in sources()]
        procs = [subprocess.Popen([nvcc, *COMPILE_FLAGS, "-c", "-o", obj,
                                   str(src)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(sources(), objs)]
        log = []
        for src, proc in zip(sources(), procs):
            text, _ = proc.communicate()
            log.append(text)
            if proc.returncode != 0:
                for p in procs:
                    p.kill()
                    p.wait()
                raise RuntimeError(f"nvcc failed ({proc.returncode}) on "
                                   f"{src}:\n{text}")
        lib_tmp = os.path.join(tmp, out.name)
        proc = subprocess.run([nvcc, *LINK_FLAGS, "-o", lib_tmp, *objs],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) linking "
                               f"{out.name}:\n{proc.stdout}{proc.stderr}")
        os.replace(lib_tmp, out)
    return {"path": str(out), "seconds": time.perf_counter() - t0,
            "log": "".join(log) + proc.stdout + proc.stderr}


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(build()["path"])
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        handle.kernel_error_string.argtypes = [ctypes.c_int]
        handle.kernel_error_string.restype = ctypes.c_char_p
        _check_adagrad_layout(handle)
        _lib = handle
    return _lib


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(name: str, entry: str, device, *args) -> None:
    """Call C entry point ``entry`` on the current stream of ``device``
    (the stream is its last argument), raise on a nonzero status, and
    count one launch of ``name``."""
    handle = lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        status = getattr(handle, entry)(*args, stream)
    if status != 0:
        msg = handle.kernel_error_string(status).decode()
        raise RuntimeError(f"{name}: {entry} launch failed: {msg} "
                           f"({status})")
    LAUNCHES[name] += 1


def _numel(t) -> int:
    return 0 if t is None else t.numel()


# the job strides' order in the gate entry points' ``js`` array
GATE_STRIDES = ("slot", "a", "z", "zs", "dz", "dzs", "thr")


def _job_strides(strides) -> ctypes.Array:
    """{operand: job stride in elements} -> the C ``js`` array (0 for an
    operand not named: one shared by every job, or none)."""
    strides = strides or {}
    unknown = set(strides) - set(GATE_STRIDES)
    if unknown:
        raise ValueError(f"unknown gate operands {sorted(unknown)}")
    return (_LL * len(GATE_STRIDES))(*[int(strides.get(k, 0))
                                       for k in GATE_STRIDES])


def launch_cosine_gate(name: str, *, slot, n_slots: int, slot_stride: int,
                       a, z, dz, w, cot, part, thresh: float, n_jobs: int = 1,
                       thr=None, strides=None) -> None:
    """Launch the fp32/bf16 gate of ``csrc/cosine_gate.cu`` (K1, K2).  The
    caller has checked devices, dtypes, shapes and contiguity and
    allocated ``w`` / ``cot`` and the split-row path's workspace ``part``
    (None for the narrow path).  A job-batched call (``n_jobs`` > 1) runs
    all its jobs in this one launch: ``a`` is then one job's (B, F)
    (``a`` of job n at ``a + n * strides["a"]``), ``strides`` the job
    strides of :data:`GATE_STRIDES` (0 or absent: shared), ``thr`` the
    jobs' fp32 thresholds (None: ``thresh`` for every job), and ``w`` /
    ``cot`` / ``part`` hold every job's."""
    B, F = a.shape[-2:]
    js = _job_strides(strides)
    _launch(name, "cosine_gate", a.device, _ptr(slot), n_slots, slot_stride,
            _ptr(a), _ptr(z), _ptr(dz), _ptr(w), _ptr(cot), B, F, thresh,
            DTYPE_CODES[z.dtype], _ptr(part), _numel(part), n_jobs,
            _ptr(thr), ctypes.addressof(js))


def launch_cosine_gate_quant(name: str, *, bits: int, slot, n_slots: int,
                             a, zq, zs, dzq, dzs, w, cot, part,
                             thresh: float, n_jobs: int = 1, thr=None,
                             strides=None) -> None:
    """Launch the int8 (``bits=8``, K4) or packed int4 (``bits=4``, K5)
    ring gate of ``csrc/cosine_gate.cu``; ``a`` is (B, F) with F the
    unpacked (even, for int4) row width; ``part``, ``n_jobs``, ``thr``
    and ``strides`` as for :func:`launch_cosine_gate`."""
    B, F = a.shape[-2:]
    js = _job_strides(strides)
    _launch(name, "cosine_gate_quant", a.device, _ptr(slot), n_slots,
            _ptr(a), _ptr(zq), _ptr(zs), _ptr(dzq), _ptr(dzs), _ptr(w),
            _ptr(cot), B, F, thresh, bits, _ptr(part), _numel(part), n_jobs,
            _ptr(thr), ctypes.addressof(js))


def launch_quantize_sr(name: str, *, x, u, q, scale, part,
                       levels: float) -> None:
    """Launch ``csrc/quantize.cu`` (K3) on checked (T, L) operands (x fp32
    or bf16); ``part`` is the split-row path's (T, chunks) fp32
    workspace, or None for the narrow path."""
    T, L = x.shape
    _launch(name, "quantize_sr", x.device, _ptr(x), _ptr(u), _ptr(q),
            _ptr(scale), T, L, levels, DTYPE_CODES[x.dtype], _ptr(part),
            _numel(part))


def launch_fused_adagrad(name: str, table, *, device, scale, lr: float,
                         eps: float, apply: bool) -> None:
    """Launch K7 (``name`` "fused_adagrad", a :class:`K7Table`) or K8
    ("fused_adagrad_q8", a :class:`K8Table`) of ``csrc/fused_adagrad.cu``
    over a table of checked leaves; ``scale`` a 0-d fp32 tensor or None;
    ``apply`` adds the update to each leaf's ``dst`` instead of writing
    it there."""
    _launch(name, name, device, ctypes.addressof(table), _ptr(scale), lr,
            eps, int(apply))


def launch_ring_dequant(name: str, *, bits: int, slot, zq, zs, out) -> None:
    """Launch K6 (``bits=8``) or K11 (``bits=4``) of
    ``csrc/cosine_gate.cu``; ``out`` is (B, F) fp32 with F the unpacked
    row width."""
    B, F = out.shape
    _launch(name, "ring_dequant", out.device, _ptr(slot), zq.shape[0],
            _ptr(zq), _ptr(zs), _ptr(out), B, F, bits)


def launch_flash_attention(name: str, *, q, k, v, out, lse, causal: bool,
                           window: int, scale: float) -> None:
    """Launch K9 (``lse`` None) or K9-LSE of ``csrc/flash_attention.cu`` on
    checked (B, S, H, hd) operands."""
    B, S, H, hd = q.shape
    _launch(name, "flash_attention_fwd", q.device, _ptr(q), _ptr(k),
            _ptr(v), _ptr(out), _ptr(lse), B, S, H, hd, int(causal),
            int(window), scale, DTYPE_CODES[q.dtype])


def launch_flash_attention_bwd(name: str, *, q, k, v, do, lse, delta, dq,
                               dk, dv, causal: bool, window: int,
                               scale: float) -> None:
    """Launch K10's dkv kernel (``dq`` None) or its dq kernel (``dk``,
    ``dv`` None) of ``csrc/flash_attention_bwd.cu`` on checked operands."""
    B, S, H, hd = q.shape
    tail = (B, S, H, hd, int(causal), int(window), scale,
            DTYPE_CODES[q.dtype])
    if dq is None:
        _launch(name, "flash_attention_bwd_dkv", q.device, _ptr(q), _ptr(k),
                _ptr(v), _ptr(do), _ptr(lse), _ptr(delta), _ptr(dk),
                _ptr(dv), *tail)
    else:
        _launch(name, "flash_attention_bwd_dq", q.device, _ptr(q), _ptr(k),
                _ptr(v), _ptr(do), _ptr(lse), _ptr(delta), _ptr(dq), *tail)
