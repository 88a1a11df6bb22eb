"""The time loops of RWKV6 and Mamba2, each one kernel launch over a
whole sequence (``csrc/ssm_scan.cu``).

Not a port of a TPU kernel: the reference runs both recurrences as
``jax.lax.scan`` over time (``repro.models.ssm``). The prefill runs the
whole loop of a layer in one launch; a decode step runs the same kernel
at S = 1 on the cache's state. CUDA tensors go through the kernel, which
counts its launches; CPU tensors through the plain versions
``ref.wkv6_scan_ref`` and ``ref.ssd_scan_ref``, the reference's
``scan`` bodies step by step. Kernel and plain version agree to a
tolerance, not bit for bit: the state updates round as the plain
version's do, but the output sums run in another order.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import ssd_scan_ref, wkv6_scan_ref

_WKV_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_SSD_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def wkv6_scan(r, k, v, w, u, state):
    """RWKV6's recurrence over S steps: out_t = r_t · (S + u ⊙ k_t v_tᵀ),
    then S <- w_t ⊙ S + k_t v_tᵀ, per (batch, head).

    r, k, v, w: (B, S, H, dh) f32; u: (H, dh) f32; state: (B, H, dh, dh)
    f32, the initial state, overwritten with the final one. Returns out
    (B, S, H, dh) f32."""
    B, S, H, dh = r.shape
    if any(t.shape != r.shape for t in (k, v, w)) \
            or tuple(u.shape) != (H, dh) \
            or tuple(state.shape) != (B, H, dh, dh):
        raise ValueError(f"wkv6_scan: r, k, v, w must be (B, S, H, dh), u "
                         f"(H, dh) and state (B, H, dh, dh); got "
                         f"{[tuple(t.shape) for t in (r, k, v, w, u, state)]}")
    if r.device.type == "cpu":
        return wkv6_scan_ref(r, k, v, w, u, state)
    name = "wkv6_scan"
    f32 = torch.float32
    if dh > 64:
        raise ValueError(f"{name}: dh must be <= 64, got {dh}")
    for n, t in (("r", r), ("k", k), ("v", v), ("w", w)):
        _build.require(name, n, t, f32, (B, S, H, dh))
    _build.require(name, "u", u, f32, (H, dh))
    _build.require(name, "state", state, f32, (B, H, dh, dh))
    out = torch.empty((B, S, H, dh), dtype=f32, device=r.device)
    p = _build.ptr
    fn = _build.function("ssm_scan", "k2_wkv6_scan", _WKV_ARGS)
    _build.check(fn(p(r), p(k), p(v), p(w), p(u), p(state), p(out), B, S, H,
                    dh, _build.stream_ptr(r.device)), name)
    _build.count(name)
    return out


def ssd_scan(x, Bm, Cm, decay, dt, D, state):
    """Mamba2's recurrence over S steps with its D skip: S <- decay_t S +
    (dt_t x_t) B_tᵀ, then y_t = S C_t + D x_t, per (batch, head).

    x: (B, S, H, P); Bm, Cm: (B, S, N); decay, dt: (B, S, H); D: (H,);
    state: (B, H, P, N), the initial state, overwritten with the final one;
    all f32. Returns y (B, S, H, P) f32."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    if tuple(Bm.shape) != (B, S, N) or Cm.shape != Bm.shape \
            or tuple(decay.shape) != (B, S, H) or dt.shape != decay.shape \
            or tuple(D.shape) != (H,) or tuple(state.shape) != (B, H, P, N):
        raise ValueError(
            f"ssd_scan: x must be (B, S, H, P), Bm and Cm (B, S, N), decay "
            f"and dt (B, S, H), D (H,) and state (B, H, P, N); got "
            f"{[tuple(t.shape) for t in (x, Bm, Cm, decay, dt, D, state)]}")
    if x.device.type == "cpu":
        return ssd_scan_ref(x, Bm, Cm, decay, dt, D, state)
    name = "ssd_scan"
    f32 = torch.float32
    if P > 256 or N > 64:
        raise ValueError(f"{name}: P must be <= 256 and N <= 64, got "
                         f"P={P}, N={N}")
    _build.require(name, "x", x, f32, (B, S, H, P))
    for n, t in (("Bm", Bm), ("Cm", Cm)):
        _build.require(name, n, t, f32, (B, S, N))
    for n, t in (("decay", decay), ("dt", dt)):
        _build.require(name, n, t, f32, (B, S, H))
    _build.require(name, "D", D, f32, (H,))
    _build.require(name, "state", state, f32, (B, H, P, N))
    y = torch.empty((B, S, H, P), dtype=f32, device=x.device)
    p = _build.ptr
    fn = _build.function("ssm_scan", "k2_ssd_scan", _SSD_ARGS)
    _build.check(fn(p(x), p(Bm), p(Cm), p(decay), p(dt), p(D), p(state),
                    p(y), B, S, H, P, N, _build.stream_ptr(x.device)), name)
    _build.count(name)
    return y
