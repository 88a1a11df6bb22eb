#!/usr/bin/env python3
"""Probe what bounds K3 (segmented_scan) and K5 (distance_argmin) on one
CUDA card, at chip_smoke.py's shapes (n=60000, d=784, k=1000; bn=32).

Run from the root of the repository on a machine with one CUDA card:

    python3 scripts/probe_kernels.py

Each kernel is timed beside variants of its source built by text
substitution, and K5 beside cuBLAS's f64 GEMM of the same product (with
the names of the kernels cuBLAS runs for it). Some
variants give wrong answers on purpose (K5's MMAs fed constants, its f32
values reinterpreted instead of widened, its MMAs dropped): only their
times mean anything. A variant is compiled from a copy of
``src/repro_torch/kernels/csrc`` under ``build/probe/`` and loaded in
place of the kernel's library; the script fails when a substitution no
longer matches the source. The last line is one JSON object of the times in ms.
"""
from __future__ import annotations

import json
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

_LOADS = """        af[i][0] = p[0];
        af[i][1] = p[8 * LD];
        af[i][2] = p[4];
        af[i][3] = p[8 * LD + 4];"""
_BFRAG = "        const double bf[2] = {p[0], p[4]};"
_MMA = "        for (int i = 0; i < 2; ++i) dmma(acc[i][j], af[i], bf);"


def _bits(a: str, b: str) -> str:
    return f"__hiloint2double(__float_as_int({a}), __float_as_int({b}))"


VARIANTS = {
    "distance_argmin": {
        "MMAs fed constants": {
            _LOADS: "\n".join(f"        af[i][{e}] = {e + 1}.0;"
                              for e in range(4)),
            _BFRAG: "        const double bf[2] = {1.0, 2.0};"},
        "f32 values reinterpreted, not widened": {
            _LOADS: "\n".join(
                f"        af[i][{e}] = {_bits(u, v)};" for e, (u, v) in
                enumerate((("p[0]", "p[4]"), ("p[8 * LD]", "p[0]"),
                           ("p[4]", "p[8 * LD + 4]"),
                           ("p[8 * LD + 4]", "p[8 * LD]")))),
            _BFRAG: "        const double bf[2] = {"
                    f"{_bits('p[0]', 'p[4]')}, {_bits('p[4]', 'p[0]')}}};"},
        "no MMAs (f64 adds keep the loads)": {
            _MMA: "        for (int i = 0; i < 2; ++i) {"
                  " acc[i][j][0] += af[i][0] + af[i][1];"
                  " acc[i][j][1] += af[i][2] + af[i][3];"
                  " acc[i][j][2] += bf[0]; acc[i][j][3] += bf[1]; }"},
    },
    "segmented_scan": {
        "50 KB tiles": {"TILE_BYTES = 100 * 1024": "TILE_BYTES = 50 * 1024"},
    },
}


def _use_sources(build, csrc: pathlib.Path, build_dir: pathlib.Path) -> None:
    """Load the kernels from ``csrc``, built into ``build_dir`` on first
    use, from now on."""
    build.CSRC, build.BUILD_DIR = csrc, build_dir
    build._libs.clear()
    build._fns.clear()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("probe_kernels: no CUDA device available", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import time_ms
    from repro_torch.data import gmm_blobs
    from repro_torch.kernels import _build
    from repro_torch.kernels.distance_argmin import distance_argmin
    from repro_torch.kernels.ops import group_by_cluster_device
    from repro_torch.kernels.segmented_scan import segmented_scan

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0] if smi else "nvidia-smi: no output")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    x = gmm_blobs(60000, 784, 128, generator=gen, device=dev)
    c = x[torch.randperm(60000, generator=gen, device=dev)[:1000]] \
        + 0.1 * torch.randn(1000, 784, generator=gen, device=dev)
    layouts = {}
    for label, a in (("1000 segments", distance_argmin(x, c)[0]),
                     ("one segment", torch.zeros(60000, dtype=torch.int32,
                                                 device=dev))):
        perm, b2s = group_by_cluster_device(a, int(a.max()) + 1, 32)
        layouts[label] = (x[perm.clamp(min=0).long()].contiguous(),
                          (perm >= 0).to(torch.float32), b2s)

    def k5():
        return time_ms(lambda: distance_argmin(x, c), torch, reps=20)

    def k3():
        return {label: time_ms(lambda: segmented_scan(*v, bn=32), torch,
                               reps=20) for label, v in layouts.items()}

    xd, cd = x.double(), c.double()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        xd @ cd.T
        torch.cuda.synchronize()
    out = {"cuBLAS f64 GEMM x @ c.T": time_ms(lambda: xd @ cd.T, torch),
           "its kernels": sorted({e.key for e in prof.key_averages()
                                  if "gemm" in e.key.lower()}),
           "K5": k5(), "K3": k3()}
    orig = _build.CSRC, _build.BUILD_DIR
    try:
        for name, variants in VARIANTS.items():
            for label, subs in variants.items():
                vdir = ROOT / "build" / "probe" / f"{name}-{len(out)}"
                shutil.rmtree(vdir, ignore_errors=True)
                shutil.copytree(orig[0], vdir)
                src = vdir / f"{name}.cu"
                text = src.read_text()
                for old, new in subs.items():
                    if old not in text:
                        raise RuntimeError(f"{name}: '{label}' no longer "
                                           f"matches the source")
                    text = text.replace(old, new)
                src.write_text(text)
                _use_sources(_build, vdir, vdir / "build")
                out[f"{name}: {label}"] = (k5() if name == "distance_argmin"
                                           else k3())
    finally:
        _use_sources(_build, *orig)
    for key, val in out.items():
        print(f"{key}: {val}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
