"""Attention-free mixers: RWKV6 ("Finch", data-dependent decay) and Mamba2
(the SSD recurrence) (port of ``repro.models.ssm``). Each has a prefill
path over a whole sequence and an O(1) one-token decode path over its
recurrent state.

The time loop of each is one kernel launch (``kernels.ssm_scan``:
``wkv6_scan``, ``ssd_scan``) where the reference runs ``jax.lax.scan``;
the decode step runs the same kernel at S = 1 and updates the cache's
state in place, where the reference returns a new one. The prefill
paths also return what the decode cache keeps: the final state and, for
RWKV6, the last position's input (the reference's decode keeps that
input as ``xprev``). The reference's casts are kept: the token-shift
lerp in f32 cast back to the input's type, the decays in f32, the scans
in f32 with their outputs cast to the input's type before the
``rmsnorm``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.ssm_scan import ssd_scan, wkv6_scan
from .layers import allocator, dense, dense_init, rmsnorm, rmsnorm_init


# --------------------------------------------------------------------------
# RWKV6 time mixing
# --------------------------------------------------------------------------

def rwkv6_init(gen: torch.Generator, d: int, n_heads: int, lora: int = 64,
               dtype=torch.bfloat16, new=None) -> dict:
    dh = d // n_heads
    alloc = allocator(gen.device, new)
    f32 = torch.float32

    def draw(shape, dtype_, fn):
        w = alloc(shape, dtype_)
        if w.is_meta:                  # model.param_shapes: no draws
            return w
        return w.copy_(fn(torch.empty(shape, dtype=f32, device=gen.device)))
    return {
        "mu": draw((5, d), dtype, lambda t: t.uniform_(generator=gen)),
        "wr": dense_init(gen, d, d, dtype, new),
        "wk": dense_init(gen, d, d, dtype, new),
        "wv": dense_init(gen, d, d, dtype, new),
        "wg": dense_init(gen, d, d, dtype, new),
        "wo": dense_init(gen, d, d, dtype, new),
        "w0": draw((d,), f32, lambda t: t.normal_(generator=gen).mul_(
            0.1).sub_(6.0)),                     # decay bias (slow decay)
        "w1": dense_init(gen, d, lora, dtype, new),
        "w2": dense_init(gen, lora, d, dtype, new),
        "u": draw((n_heads, dh), f32, lambda t: t.normal_(
            generator=gen).mul_(0.1)),           # bonus for the current token
        "ln": rmsnorm_init(d, dtype, gen.device, new),
    }


def _rwkv6_inputs(p, xt, x_prev, n_heads: int):
    """Per-token projections with the data-dependent token shift: r, k,
    v (..., H, dh) in xt's type, the decay w (..., H, dh) f32 and the
    gate g (..., d)."""
    d = xt.shape[-1]
    dh = d // n_heads
    mu = p["mu"].float()
    xf, pf = xt.float(), x_prev.float()
    xr, xk, xv, xw, xg = [(pf + mu[i] * (xf - pf)).to(xt.dtype)
                          for i in range(5)]
    r = dense(p["wr"], xr)
    k = dense(p["wk"], xk)
    v = dense(p["wv"], xv)
    g = F.silu(dense(p["wg"], xg))
    # data-dependent decay (Finch): w = exp(-exp(w0 + tanh(xw W1) W2))
    w = torch.exp(-torch.exp(p["w0"] + dense(
        p["w2"], torch.tanh(dense(p["w1"], xw))).float()))
    shp = xt.shape[:-1] + (n_heads, dh)
    return r.reshape(shp), k.reshape(shp), v.reshape(shp), w.reshape(shp), g


def _rwkv6_out(p, out, g, dtype):
    """The scan's output (..., H, dh) f32 -> the layer's output."""
    out = out.reshape(*out.shape[:-2], -1).to(dtype)
    return dense(p["wo"], rmsnorm(p["ln"], out) * g)


def rwkv6_apply(p, x, *, n_heads: int):
    """Prefill path. x: (B, S, d) -> (out (B, S, d), state (B, H, dh, dh)
    f32 after the last position, x[:, -1:], the next step's
    ``x_prev``). The scan is ``wkv6_scan`` from a zero state."""
    B, S, d = x.shape
    dh = d // n_heads
    x_prev = F.pad(x, (0, 0, 1, 0))[:, :-1]
    r, k, v, w, g = _rwkv6_inputs(p, x, x_prev, n_heads)
    state = torch.zeros((B, n_heads, dh, dh), dtype=torch.float32,
                        device=x.device)
    out = wkv6_scan(r.float().contiguous(), k.float().contiguous(),
                    v.float().contiguous(), w.contiguous(), p["u"], state)
    return _rwkv6_out(p, out, g, x.dtype), state, x[:, -1:]


def rwkv6_decode(p, xt, x_prev, state, *, n_heads: int):
    """O(1) decode. xt, x_prev: (B, 1, d); state: (B, H, dh, dh) f32,
    updated in place (``wkv6_scan`` at S = 1). Returns (out (B, 1, d),
    state, xt as the next ``x_prev``)."""
    r, k, v, w, g = _rwkv6_inputs(p, xt, x_prev, n_heads)
    out = wkv6_scan(r.float().contiguous(), k.float().contiguous(),
                    v.float().contiguous(), w.contiguous(), p["u"], state)
    return _rwkv6_out(p, out, g, xt.dtype), state, xt


# --------------------------------------------------------------------------
# Mamba2 (SSD): a scalar decay per head, a (P x N) state
# --------------------------------------------------------------------------

def mamba2_init(gen: torch.Generator, d: int, n_heads: int, d_state: int,
                expand: int = 2, dtype=torch.bfloat16, new=None) -> dict:
    d_in = expand * d
    alloc = allocator(gen.device, new)
    f32 = torch.float32
    return {
        "in_proj": dense_init(gen, d, 2 * d_in + 2 * d_state + n_heads,
                              dtype, new),
        "out_proj": dense_init(gen, d_in, d, dtype, new),
        "A_log": alloc((n_heads,), f32).zero_(),
        "D": alloc((n_heads,), f32).fill_(1),
        "dt_bias": alloc((n_heads,), f32).zero_(),
        "ln": rmsnorm_init(d_in, dtype, gen.device, new),
    }


def _mamba2_dims(p, n_heads: int):
    """(d_in, P, N) from the param shapes."""
    d_in = p["out_proj"]["w"].shape[0]
    total = p["in_proj"]["w"].shape[1]
    N = (total - 2 * d_in - n_heads) // 2
    return d_in, d_in // n_heads, N


def _mamba2_inputs(p, x, n_heads: int):
    """z, x_in (in x's type), B, C (f32) and dt (f32, after the softplus)
    of x's in-projection."""
    d_in, _, N = _mamba2_dims(p, n_heads)
    zxbcdt = dense(p["in_proj"], x)
    z = zxbcdt[..., :d_in]
    xin = zxbcdt[..., d_in:2 * d_in]
    Bm = zxbcdt[..., 2 * d_in:2 * d_in + N].float()
    Cm = zxbcdt[..., 2 * d_in + N:2 * d_in + 2 * N].float()
    dt = F.softplus(zxbcdt[..., 2 * d_in + 2 * N:].float() + p["dt_bias"])
    return z, xin, Bm, Cm, dt


def _mamba2_scan(p, x, state, n_heads: int):
    """The SSD scan of x (B, S, d) from ``state`` (updated in place): the
    layer's output (B, S, d)."""
    B, S, _ = x.shape
    d_in, P, _ = _mamba2_dims(p, n_heads)
    z, xin, Bm, Cm, dt = _mamba2_inputs(p, x, n_heads)
    xh = xin.reshape(B, S, n_heads, P).float().contiguous()
    decay = torch.exp(-torch.exp(p["A_log"]) * dt)             # (B, S, H)
    y = ssd_scan(xh, Bm.contiguous(), Cm.contiguous(), decay, dt, p["D"],
                 state)
    y = y.reshape(B, S, d_in).to(x.dtype)
    return dense(p["out_proj"], rmsnorm(p["ln"], y) * F.silu(z))


def mamba2_apply(p, x, *, n_heads: int):
    """Prefill path. x: (B, S, d) -> (out (B, S, d), state (B, H, P, N)
    f32 after the last position). The scan is ``ssd_scan`` from a zero
    state."""
    B = x.shape[0]
    _, P, N = _mamba2_dims(p, n_heads)
    state = torch.zeros((B, n_heads, P, N), dtype=torch.float32,
                        device=x.device)
    return _mamba2_scan(p, x, state, n_heads), state


def mamba2_decode(p, xt, state, *, n_heads: int):
    """O(1) decode. xt: (B, 1, d); state: (B, H, P, N) f32, updated in
    place (``ssd_scan`` at S = 1). Returns (out (B, 1, d), state)."""
    return _mamba2_scan(p, xt, state, n_heads), state
