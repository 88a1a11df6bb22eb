"""The time loops of RWKV6 and Mamba2, each one kernel launch over a
whole sequence (``csrc/ssm_scan.cu``), and their gradients.

Not a port of a TPU kernel: the reference runs both recurrences as
``jax.lax.scan`` over time (``repro.models.ssm``) and trains through
them by ``jax.grad``. The prefill runs the whole loop of a layer in one
launch; a decode step runs the same kernel at S = 1 on the cache's state.
CUDA tensors go through the kernel, which counts its launches; CPU
tensors through the plain versions ``ref.wkv6_scan_ref`` and
``ref.ssd_scan_ref``, the reference's ``scan`` bodies step by step, out
of place, so autograd through them is the gradient oracle. Kernel and
plain version agree to a tolerance, not bit for bit: the state updates
round as the plain version's do, but the output sums run in another
order.

Training: when autograd records the call (grad mode on and an input
that requires grad), a CUDA call goes through a
``torch.autograd.Function`` whose forward is the same kernel, which
also saves the state before every ``CKPT_EVERY``-th step, and whose
backward is a hand-written kernel (``wkv6_scan_bwd``, ``ssd_scan_bwd``):
chunk by chunk from the last, it recomputes the chunk's states from its
checkpoint and runs the reverse-time recurrence of dState, writing the
gradient of every input and of the initial state. There is no path on
which the card differentiates through the plain version. Inference and
decode (nothing to record) take the kernel as before, in place.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import (ssd_scan_ref, ssd_scan_states_ref, wkv6_scan_ref,
                  wkv6_scan_states_ref)

CKPT_EVERY = 64        # steps between the forward's saved states
_P, _I = ctypes.c_void_p, ctypes.c_int
_WKV_ARGS = [_P] * 8 + [_I] * 5 + [_P]
_SSD_ARGS = [_P] * 9 + [_I] * 6 + [_P]
_WKV_BWD_ARGS = [_P] * 15 + [_I] * 5 + [_P]
_SSD_BWD_ARGS = [_P] * 17 + [_I] * 6 + [_P]
_NULL = ctypes.c_void_p(None)


def plan_wkv6_scan(B: int, S: int, H: int, dh: int) -> dict:
    """The launch plan of the forward wkv6 kernel (``_build.plan``)."""
    return _build.plan("ssm_scan", "wkv6_scan", [_I] * 4, B, S, H, dh)


def plan_ssd_scan(B: int, S: int, H: int, P: int, N: int) -> dict:
    """The launch plan of the forward ssd kernel."""
    return _build.plan("ssm_scan", "ssd_scan", [_I] * 5, B, S, H, P, N)


def plan_wkv6_scan_bwd(B: int, S: int, H: int, dh: int,
                       C: int = CKPT_EVERY) -> dict:
    """The launch plan of :func:`wkv6_scan_bwd`."""
    return _build.plan("ssm_scan", "wkv6_scan_bwd", [_I] * 5, B, S, H, dh, C)


def plan_ssd_scan_bwd(B: int, S: int, H: int, P: int, N: int,
                      C: int = CKPT_EVERY) -> dict:
    """The launch plan of :func:`ssd_scan_bwd`."""
    return _build.plan("ssm_scan", "ssd_scan_bwd", [_I] * 6, B, S, H, P, N,
                       C)


def _recorded(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _wkv6_check(r, k, v, w, u, state):
    B, S, H, dh = r.shape
    if any(t.shape != r.shape for t in (k, v, w)) \
            or tuple(u.shape) != (H, dh) \
            or tuple(state.shape) != (B, H, dh, dh):
        raise ValueError(f"wkv6_scan: r, k, v, w must be (B, S, H, dh), u "
                         f"(H, dh) and state (B, H, dh, dh); got "
                         f"{[tuple(t.shape) for t in (r, k, v, w, u, state)]}")


def _wkv6_require(name, r, k, v, w, u, state=None):
    B, S, H, dh = r.shape
    if dh > 64:
        raise ValueError(f"{name}: dh must be <= 64, got {dh}")
    f32 = torch.float32
    for n, t in (("r", r), ("k", k), ("v", v), ("w", w)):
        _build.require(name, n, t, f32, (B, S, H, dh))
    _build.require(name, "u", u, f32, (H, dh))
    if state is not None:
        _build.require(name, "state", state, f32, (B, H, dh, dh))


def _wkv6_launch(r, k, v, w, u, state, ckpt=None):
    """One launch of the forward kernel: ``state`` overwritten with the
    final state; ``ckpt`` (B, H, ceil(S / CKPT_EVERY), dh, dh), when
    given, takes the checkpoints. Returns out."""
    B, S, H, dh = r.shape
    _wkv6_require("wkv6_scan", r, k, v, w, u, state)
    out = torch.empty((B, S, H, dh), dtype=torch.float32, device=r.device)
    p = _build.ptr
    fn = _build.function("ssm_scan", "k2_wkv6_scan", _WKV_ARGS)
    _build.check(fn(p(r), p(k), p(v), p(w), p(u), p(state), p(out),
                    _NULL if ckpt is None else p(ckpt), B, S, H, dh,
                    CKPT_EVERY, _build.stream_ptr(r.device)), "wkv6_scan")
    _build.count("wkv6_scan")
    return out


def wkv6_scan_saving(r, k, v, w, u, state0):
    """The forward kernel from ``state0`` (left as it is), saving the
    state before every ``CKPT_EVERY``-th step: (out, final state,
    checkpoints (B, H, ceil(S / CKPT_EVERY), dh, dh))."""
    B, S, H, dh = r.shape
    final = state0.detach().clone()
    ckpt = torch.empty((B, H, -(-S // CKPT_EVERY), dh, dh),
                       dtype=torch.float32, device=r.device)
    return _wkv6_launch(r, k, v, w, u, final, ckpt), final, ckpt


def wkv6_scan_bwd(r, k, v, w, u, ckpt, dout, dfinal=None):
    """The gradients of :func:`wkv6_scan_saving`'s outputs, one launch of
    the backward kernel over its checkpoints: (dr, dk, dv, dw, du (H, dh),
    dstate0). ``dout`` (B, S, H, dh); ``dfinal`` (B, H, dh, dh) or None
    (zero)."""
    B, S, H, dh = r.shape
    name = "wkv6_scan_bwd"
    _wkv6_require(name, r, k, v, w, u)
    if S < 1:
        raise ValueError(f"{name}: needs S >= 1 steps")
    _build.require(name, "ckpt", ckpt, torch.float32,
                   (B, H, -(-S // CKPT_EVERY), dh, dh))
    dout = dout.contiguous()
    _build.require(name, "dout", dout, torch.float32, (B, S, H, dh))
    if dfinal is not None:
        dfinal = dfinal.contiguous()
        _build.require(name, "dfinal", dfinal, torch.float32, (B, H, dh, dh))
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du = torch.empty((B, H, dh), dtype=torch.float32, device=r.device)
    dstate0 = torch.empty((B, H, dh, dh), dtype=torch.float32,
                          device=r.device)
    scratch = torch.empty((B * H, CKPT_EVERY, dh, dh), dtype=torch.float32,
                          device=r.device)
    p = _build.ptr
    fn = _build.function("ssm_scan", "k2_wkv6_scan_bwd", _WKV_BWD_ARGS)
    _build.check(fn(p(r), p(k), p(v), p(w), p(u), p(ckpt), p(dout),
                    _NULL if dfinal is None else p(dfinal), p(scratch),
                    p(dr), p(dk), p(dv), p(dw), p(du), p(dstate0), B, S, H,
                    dh, CKPT_EVERY, _build.stream_ptr(r.device)), name)
    _build.count(name)
    return dr, dk, dv, dw, du.sum(0), dstate0


class _Wkv6Scan(torch.autograd.Function):
    """(r, k, v, w, u, state0) -> (out, final state): the forward kernel
    saving its checkpoints, and ``wkv6_scan_bwd``."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state0):
        out, final, ckpt = wkv6_scan_saving(r, k, v, w, u, state0)
        ctx.save_for_backward(r, k, v, w, u, ckpt)
        return out, final

    @staticmethod
    def backward(ctx, dout, dfinal):
        r, k, v, w, u, ckpt = ctx.saved_tensors
        if dout is None:
            dout = torch.zeros_like(r)
        return wkv6_scan_bwd(r, k, v, w, u, ckpt, dout, dfinal)


def wkv6_scan_states(r, k, v, w, u, state0):
    """The differentiable scan, out of place: (out, final state), ``state0``
    left as it is. CPU tensors: autograd through the plain version
    (``ref.wkv6_scan_states_ref``); CUDA: the kernels."""
    _wkv6_check(r, k, v, w, u, state0)
    if r.device.type == "cpu":
        return wkv6_scan_states_ref(r, k, v, w, u, state0)
    _wkv6_require("wkv6_scan", r, k, v, w, u, state0)
    if r.shape[1] == 0:
        raise ValueError("wkv6_scan: a recorded call needs S >= 1 steps")
    return _Wkv6Scan.apply(r, k, v, w, u, state0)


def wkv6_scan(r, k, v, w, u, state):
    """RWKV6's recurrence over S steps: out_t = r_t · (S + u ⊙ k_t v_tᵀ),
    then S <- w_t ⊙ S + k_t v_tᵀ, per (batch, head).

    r, k, v, w: (B, S, H, dh) f32; u: (H, dh) f32; state: (B, H, dh, dh)
    f32, the initial state, overwritten with the final one (outside the
    autograd graph). Returns out (B, S, H, dh) f32, differentiable in r,
    k, v, w, u and the initial state."""
    _wkv6_check(r, k, v, w, u, state)
    if r.device.type == "cpu":
        return wkv6_scan_ref(r, k, v, w, u, state)
    if not _recorded(r, k, v, w, u, state):
        return _wkv6_launch(r, k, v, w, u, state)
    out, final = wkv6_scan_states(r, k, v, w, u, state)
    with torch.no_grad():
        state.copy_(final)
    return out


def _ssd_check(x, Bm, Cm, decay, dt, D, state):
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    if tuple(Bm.shape) != (B, S, N) or Cm.shape != Bm.shape \
            or tuple(decay.shape) != (B, S, H) or dt.shape != decay.shape \
            or tuple(D.shape) != (H,) or tuple(state.shape) != (B, H, P, N):
        raise ValueError(
            f"ssd_scan: x must be (B, S, H, P), Bm and Cm (B, S, N), decay "
            f"and dt (B, S, H), D (H,) and state (B, H, P, N); got "
            f"{[tuple(t.shape) for t in (x, Bm, Cm, decay, dt, D, state)]}")


def _ssd_require(name, x, Bm, Cm, decay, dt, D, state=None):
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    if P > 256 or N > 64:
        raise ValueError(f"{name}: P must be <= 256 and N <= 64, got "
                         f"P={P}, N={N}")
    f32 = torch.float32
    _build.require(name, "x", x, f32, (B, S, H, P))
    for n, t in (("Bm", Bm), ("Cm", Cm)):
        _build.require(name, n, t, f32, (B, S, N))
    for n, t in (("decay", decay), ("dt", dt)):
        _build.require(name, n, t, f32, (B, S, H))
    _build.require(name, "D", D, f32, (H,))
    if state is not None:
        _build.require(name, "state", state, f32, (B, H, P, N))


def _ssd_launch(x, Bm, Cm, decay, dt, D, state, ckpt=None):
    """One launch of the forward kernel, as :func:`_wkv6_launch`."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    _ssd_require("ssd_scan", x, Bm, Cm, decay, dt, D, state)
    y = torch.empty((B, S, H, P), dtype=torch.float32, device=x.device)
    p = _build.ptr
    fn = _build.function("ssm_scan", "k2_ssd_scan", _SSD_ARGS)
    _build.check(fn(p(x), p(Bm), p(Cm), p(decay), p(dt), p(D), p(state),
                    p(y), _NULL if ckpt is None else p(ckpt), B, S, H, P, N,
                    CKPT_EVERY, _build.stream_ptr(x.device)), "ssd_scan")
    _build.count("ssd_scan")
    return y


def ssd_scan_saving(x, Bm, Cm, decay, dt, D, state0):
    """As :func:`wkv6_scan_saving`: (y, final state, checkpoints (B, H,
    ceil(S / CKPT_EVERY), P, N))."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    final = state0.detach().clone()
    ckpt = torch.empty((B, H, -(-S // CKPT_EVERY), P, N),
                       dtype=torch.float32, device=x.device)
    return (_ssd_launch(x, Bm, Cm, decay, dt, D, final, ckpt), final,
            ckpt)


def ssd_scan_bwd(x, Bm, Cm, decay, dt, D, ckpt, dy, dfinal=None):
    """The gradients of :func:`ssd_scan_saving`'s outputs, one launch of
    the backward kernel: (dx, dBm, dCm, ddecay, ddt, dD, dstate0)."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    name = "ssd_scan_bwd"
    f32 = torch.float32
    dev = x.device
    _ssd_require(name, x, Bm, Cm, decay, dt, D)
    if S < 1:
        raise ValueError(f"{name}: needs S >= 1 steps")
    _build.require(name, "ckpt", ckpt, f32, (B, H, -(-S // CKPT_EVERY), P, N))
    dy = dy.contiguous()
    _build.require(name, "dy", dy, f32, (B, S, H, P))
    if dfinal is not None:
        dfinal = dfinal.contiguous()
        _build.require(name, "dfinal", dfinal, f32, (B, H, P, N))
    dx = torch.empty_like(x)
    dB, dC = (torch.empty((B, H, S, N), dtype=f32, device=dev)
              for _ in range(2))
    ddecay, ddt = torch.empty_like(decay), torch.empty_like(dt)
    dD = torch.empty((B, H), dtype=f32, device=dev)
    dstate0 = torch.empty((B, H, P, N), dtype=f32, device=dev)
    scratch = torch.empty((B * H, CKPT_EVERY + 1, N, P), dtype=f32,
                          device=dev)
    p = _build.ptr
    fn = _build.function("ssm_scan", "k2_ssd_scan_bwd", _SSD_BWD_ARGS)
    _build.check(fn(p(x), p(Bm), p(Cm), p(decay), p(dt), p(D), p(ckpt),
                    p(dy), _NULL if dfinal is None else p(dfinal),
                    p(scratch), p(dx), p(dB), p(dC), p(ddecay), p(ddt),
                    p(dD), p(dstate0), B, S, H, P, N, CKPT_EVERY,
                    _build.stream_ptr(dev)), name)
    _build.count(name)
    return dx, dB.sum(1), dC.sum(1), ddecay, ddt, dD.sum(0), dstate0


class _SsdScan(torch.autograd.Function):
    """(x, Bm, Cm, decay, dt, D, state0) -> (y, final state): the forward
    kernel saving its checkpoints, and ``ssd_scan_bwd``."""

    @staticmethod
    def forward(ctx, x, Bm, Cm, decay, dt, D, state0):
        y, final, ckpt = ssd_scan_saving(x, Bm, Cm, decay, dt, D, state0)
        ctx.save_for_backward(x, Bm, Cm, decay, dt, D, ckpt)
        return y, final

    @staticmethod
    def backward(ctx, dy, dfinal):
        x, Bm, Cm, decay, dt, D, ckpt = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        return ssd_scan_bwd(x, Bm, Cm, decay, dt, D, ckpt, dy, dfinal)


def ssd_scan_states(x, Bm, Cm, decay, dt, D, state0):
    """The differentiable SSD scan, out of place: (y, final state), as
    :func:`wkv6_scan_states`."""
    _ssd_check(x, Bm, Cm, decay, dt, D, state0)
    if x.device.type == "cpu":
        return ssd_scan_states_ref(x, Bm, Cm, decay, dt, D, state0)
    _ssd_require("ssd_scan", x, Bm, Cm, decay, dt, D, state0)
    if x.shape[1] == 0:
        raise ValueError("ssd_scan: a recorded call needs S >= 1 steps")
    return _SsdScan.apply(x, Bm, Cm, decay, dt, D, state0)


def ssd_scan(x, Bm, Cm, decay, dt, D, state):
    """Mamba2's recurrence over S steps with its D skip: S <- decay_t S +
    (dt_t x_t) B_tᵀ, then y_t = S C_t + D x_t, per (batch, head).

    x: (B, S, H, P); Bm, Cm: (B, S, N); decay, dt: (B, S, H); D: (H,);
    state: (B, H, P, N), the initial state, overwritten with the final one
    (outside the autograd graph); all f32. Returns y (B, S, H, P) f32,
    differentiable in every input and the initial state."""
    _ssd_check(x, Bm, Cm, decay, dt, D, state)
    if x.device.type == "cpu":
        return ssd_scan_ref(x, Bm, Cm, decay, dt, D, state)
    if not _recorded(x, Bm, Cm, decay, dt, D, state):
        return _ssd_launch(x, Bm, Cm, decay, dt, D, state)
    y, final = ssd_scan_states(x, Bm, Cm, decay, dt, D, state)
    with torch.no_grad():
        state.copy_(final)
    return y
