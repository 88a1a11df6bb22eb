"""Build the CUDA kernels and count their launches.

Each source in ``csrc/`` is compiled by its own ``nvcc`` process, all
started together, into a shared library with a plain C interface for
``sm_90a`` and loaded with ctypes: no PyTorch headers, so a build takes
seconds. Libraries are cached in ``build/kernels/`` at the root of the
checkout under a hash of their source and flags, and built at first use.

Every kernel's C entry point returns ``cudaGetLastError()`` after its
launches; :func:`check` raises on a non-zero code. :data:`LAUNCHES`
holds one plain integer per kernel, which its wrapper raises by one each
time it launches the kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("center_knn", "candidate_assign", "segmented_scan",
           "candidate_assign_int8", "distance_argmin",
           "candidate_assign_rowwise", "cluster_attend", "exact_round",
           "segment_sum")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

LAUNCHES = {"center_sqdist": 0, "candidate_assign_tiled": 0,
            "segmented_scan": 0, "candidate_assign_int8_tiled": 0,
            "distance_argmin": 0, "candidate_assign_rowwise": 0,
            "cluster_attend": 0, "exact_sqnorm": 0, "exact_cross": 0,
            "exact_rowdot": 0,
            "segment_sum_blocks": 0}

_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[tuple[str, str], ctypes._CFuncPtr] = {}
_lock = threading.Lock()


def count(name: str) -> None:
    LAUNCHES[name] += 1


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launches() -> dict:
    return dict(LAUNCHES)


def nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (pathlib.Path(root) / "bin" / "nvcc").exists():
            return str(pathlib.Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _target(name: str) -> pathlib.Path:
    h = hashlib.sha1()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build_all() -> dict:
    """Compile every kernel library that is not built yet, one ``nvcc``
    per source in parallel. Returns {name: seconds} for the sources it
    compiled (empty when all were cached)."""
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        todo = [n for n in SOURCES if not _target(n).exists()]
        t0 = time.perf_counter()
        procs = {}
        for name in todo:
            tmp = _target(name).with_suffix(f".tmp{os.getpid()}.so")
            log = open(BUILD_DIR / f"{name}.log", "w")
            cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=log,
                                            stderr=subprocess.STDOUT),
                           tmp, log)
        took, failed = {}, []
        for name, (proc, tmp, log) in procs.items():
            rc = proc.wait()
            log.close()
            took[name] = time.perf_counter() - t0
            if rc != 0:
                failed.append(name)
            else:
                os.replace(tmp, _target(name))
        if failed:
            logs = "\n".join((BUILD_DIR / f"{n}.log").read_text()
                             for n in failed)
            raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
        return took


def build_log(name: str) -> str:
    """The compiler's output of the last build of ``name`` (ptxas
    registers, shared memory and spills), or '' when it came from cache."""
    p = BUILD_DIR / f"{name}.log"
    return p.read_text() if p.exists() else ""


def function(lib: str, symbol: str, argtypes: list):
    """The C entry point ``symbol`` of library ``lib``, built and loaded
    on first use; returns int (a cudaError_t)."""
    key = (lib, symbol)
    if key not in _fns:
        if lib not in _libs:
            build_all()
            _libs[lib] = ctypes.CDLL(str(_target(lib)))
        fn = getattr(_libs[lib], symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[key] = fn
    return _fns[key]


def require(kernel: str, name: str, t, dtype, shape) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` and
    ``shape``, the only layout a kernel takes."""
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous() or t.device.type != "cuda":
        raise ValueError(f"{kernel}: {name} must be a "
                         f"contiguous CUDA {dtype} tensor of shape "
                         f"{tuple(shape)}, got {t.dtype} {tuple(t.shape)} "
                         f"on {t.device}")


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
