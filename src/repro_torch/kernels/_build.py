"""Build the CUDA kernels and count their launches.

Each source in ``csrc/`` is compiled by its own ``nvcc`` process, all
started together, into a shared library with a plain C interface for
``sm_90a`` and loaded with ctypes: no PyTorch headers, so a build takes
seconds. Libraries are cached in ``build/kernels/`` at the root of the
checkout under a hash of their source and flags, and built at first use,
under a file lock, so processes that start together build once.

Every kernel's C entry point returns ``cudaGetLastError()`` after its
launches; :func:`check` raises on a non-zero code. :data:`LAUNCHES`
holds one plain integer per kernel, which its wrapper raises by one each
time it launches the kernel.

Each library also exports, for each kernel, the host-only plan its
launcher launches by (``k2_plan_<kernel>``, read by :func:`plan`), its
instantiations (``k2_variants_<kernel>``) and their attributes on the
card (``k2_attrs_<kernel>``, read by :func:`attrs`); ``csrc/common.cuh``
describes the plan's fields. The compiler's log of each build (ptxas
registers, shared memory and spills) is kept beside the library under
its hashed name (:func:`build_log`).
"""
from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import threading
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("center_knn", "candidate_assign", "segmented_scan",
           "candidate_assign_int8", "distance_argmin",
           "candidate_assign_rowwise", "cluster_attend", "exact_round",
           "segment_sum", "ssm_scan")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

LAUNCHES = {"center_sqdist": 0, "candidate_assign_tiled": 0,
            "segmented_scan": 0, "candidate_assign_int8_tiled": 0,
            "distance_argmin": 0, "candidate_assign_rowwise": 0,
            "cluster_attend": 0, "exact_sqnorm": 0,
            "exact_split_sqnorms": 0, "exact_cross": 0, "exact_rowdot": 0,
            "segment_sum_blocks": 0, "wkv6_scan": 0, "ssd_scan": 0,
            "wkv6_scan_bwd": 0, "ssd_scan_bwd": 0}

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


@contextlib.contextmanager
def _file_lock():
    """One build at a time across processes (the ranks of a mesh reach
    their first launch together); the lock goes with its process."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        yield


def build_all() -> dict:
    """Compile every kernel library that is not built yet, one ``nvcc``
    per source in parallel. Returns {name: seconds} for the sources it
    compiled (empty when all were cached)."""
    with _lock, _file_lock():
        todo = [n for n in SOURCES if not _target(n).exists()]
        t0 = time.perf_counter()
        procs = {}
        for name in todo:
            tmp = _target(name).with_suffix(f".tmp{os.getpid()}.so")
            log = open(_log_path(name), "w")
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
            logs = "\n".join(_log_path(n).read_text() for n in failed)
            raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
        return took


def _log_path(name: str) -> pathlib.Path:
    """The compiler's log of the library ``_target(name)``: same hash, so
    a build of other sources or flags never overwrites it."""
    return _target(name).with_suffix(".log")


def build_log(name: str) -> str:
    """The compiler's output of the build of ``name`` from the current
    sources and flags (ptxas registers, shared memory and spills), kept
    with the cached library; '' when no such build left a log."""
    p = _log_path(name)
    return p.read_text() if p.exists() else ""


_PLAN_FIELDS: tuple | None = None


def _library(lib: str) -> ctypes.CDLL:
    if lib not in _libs:
        build_all()
        _libs[lib] = ctypes.CDLL(str(_target(lib)))
    return _libs[lib]


def plan(lib: str, kernel: str, argtypes: list, *args) -> dict:
    """The launch plan ``k2_plan_<kernel>`` of library ``lib`` computes for
    the shape arguments ``args`` (of C types ``argtypes``, before the
    output pointer), the one its launcher launches by:
    {field: int} in the fields ``k2_plan_fields`` names, with ``kernel``,
    ``lib`` and the launched instantiation's name (``variant_name``)."""
    global _PLAN_FIELDS
    if _PLAN_FIELDS is None:
        names = function(lib, "k2_plan_fields", [])
        names.restype = ctypes.c_char_p
        _PLAN_FIELDS = tuple(names().decode().split(","))
    out = (ctypes.c_longlong * len(_PLAN_FIELDS))()
    fn = function(lib, f"k2_plan_{kernel}",
                  list(argtypes) + [ctypes.POINTER(ctypes.c_longlong)])
    check(fn(*args, out), f"k2_plan_{kernel}")
    rec = dict(zip(_PLAN_FIELDS, (int(v) for v in out)))
    rec.update(kernel=kernel, lib=lib,
               variant_name=variants(lib, kernel)[rec["variant"]])
    return rec


def variants(lib: str, kernel: str) -> list:
    """The instantiations of ``kernel`` its launcher picks from, in
    variant order."""
    fn = function(lib, f"k2_variants_{kernel}", [])
    fn.restype = ctypes.c_char_p
    return fn().decode().split(",")


def attrs(lib: str, kernel: str, variant: int, threads: int,
          smem: int) -> dict:
    """``cudaFuncGetAttributes`` of one instantiation and its resident
    blocks an SM at ``threads`` and ``smem`` bytes of dynamic shared
    memory, on the current card."""
    out = (ctypes.c_longlong * 6)()
    fn = function(lib, f"k2_attrs_{kernel}",
                  [ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                   ctypes.POINTER(ctypes.c_longlong)])
    check(fn(variant, threads, smem, out), f"k2_attrs_{kernel}")
    return dict(zip(("registers", "local_bytes", "static_smem",
                     "max_dynamic_smem", "blocks_per_sm", "max_threads"),
                    (int(v) for v in out)))


def device_limits() -> dict:
    """The current card's opt-in shared memory a block, SMs, shared memory
    an SM and what the runtime reserves a block (``common.cuh``'s query,
    which every library carries)."""
    out = (ctypes.c_longlong * 4)()
    fn = function("exact_round", "k2_device_limits",
                  [ctypes.POINTER(ctypes.c_longlong)])
    check(fn(out), "k2_device_limits")
    return dict(zip(("smem_optin", "sms", "smem_per_sm", "smem_reserved"),
                    (int(v) for v in out)))


_SPILL = re.compile(r"Function properties for (\S+)\s*\n\s*(\d+) bytes stack "
                    r"frame, (\d+) bytes spill stores, (\d+) bytes spill "
                    r"loads")


def spills(lib: str) -> dict:
    """{mangled function: (stack bytes, spill store bytes, spill load
    bytes)} from ``lib``'s ptxas log ({} when no log is kept)."""
    return {m.group(1): tuple(int(m.group(i)) for i in (2, 3, 4))
            for m in _SPILL.finditer(build_log(lib))}


def function(lib: str, symbol: str, argtypes: list):
    """The C entry point ``symbol`` of library ``lib``, built and loaded
    on first use; returns int (a cudaError_t)."""
    key = (lib, symbol)
    if key not in _fns:
        fn = getattr(_library(lib), symbol)
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
