"""Mixture-of-Experts with sort-based capacity dispatch (port of
``repro.models.moe``).

Tokens are sorted by expert, so dispatch is a gather into (E, C, d)
capacity buffers and no (T, E, C) one-hot tensor is made. Shared experts
(DeepSeek-V2) and a parallel dense residual branch (Arctic) are added
after the experts, in the reference's order. GDI, the paper's
initializer, can seed the router (:func:`gdi_router_init`).

The reference's orders are kept where they decide the result:
- the router's logits in f32 (TF32 is off, ``device.resolve``), top-k
  over the softmax probabilities with ties to the lower expert id
  (``lax.top_k``; ``torch.topk`` promises no tie order);
- a stable sort of the (token, k) pairs by expert (``jnp.argsort`` is
  stable), so the pairs an expert keeps within its capacity C are its
  lowest token ids;
- the combine adds each token's kept expert outputs in ascending expert
  id in the outputs' type, the order of the reference's sequential
  scatter-add, with gathers and no atomics: two runs on the card are
  bit-identical (``index_add_`` on CUDA adds in no fixed order).

The expert SwiGLU runs over the capacity buffers with batched matrix
products, as the reference's ``einsum``, in place on the serving path
and out of place, with the same arithmetic, where autograd records
(``layers.recorded``): the load-balance ``aux`` and the gates then carry
gradients to the router as the reference's do. The serve prefill takes
:func:`moe_apply_stepped`, which routes each position's tokens as a
decode step does and runs each expert over its own rows; it alone reads
the device to the host (the experts' row counts). The reference's
expert-parallel sharding hint does nothing on one device and is left
out.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.distance import bottom_k
from .layers import allocator, normal_into, recorded, swiglu, swiglu_init


def moe_init(gen: torch.Generator, d: int, f: int, n_experts: int,
             n_shared: int, dtype=torch.bfloat16, new=None) -> dict:
    """Router (d, E) f32, experts ``wi``/``wg`` (E, d, f) and ``wo`` (E,
    f, d) in ``dtype``, and the shared experts' SwiGLU when ``n_shared``.
    Each expert's block is drawn in f32 and cast into its slot, so the
    init holds one f32 block at a time beside the params."""
    new = allocator(gen.device, new)
    scale = (2.0 / (d + f)) ** 0.5
    p = {"router": {"w": normal_into(new((d, n_experts), torch.float32),
                                     gen, d ** -0.5)}}
    for name, shape in (("wi", (d, f)), ("wg", (d, f)), ("wo", (f, d))):
        w = new((n_experts,) + shape, dtype)
        for e in range(n_experts):
            normal_into(w[e], gen, scale)
        p[name] = w
    if n_shared > 0:
        p["shared"] = swiglu_init(gen, d, f * n_shared, dtype, new)
    return p


def capacity(T: int, n_experts: int, top_k: int,
             capacity_factor: float = 1.25) -> int:
    """Slots per expert: the reference's Python float expression, at
    least 8 and padded to a multiple of 8."""
    C = int(capacity_factor * top_k * T / n_experts + 0.5)
    return max(8, -(-C // 8) * 8)


def _gate(w: torch.Tensor, xf: torch.Tensor, top_k: int):
    """Softmax probabilities (T, E) of the f32 router logits, each
    token's top-k experts ``eidx`` (T, K) int64 in descending probability
    (ties to the lower id) and their renormalised ``gates`` (T, K)."""
    probs = torch.softmax(xf.float() @ w, dim=-1)
    eidx = bottom_k(-probs, top_k).long()
    gates = torch.gather(probs, 1, eidx)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return probs, gates, eidx


def _aux(probs: torch.Tensor, eidx: torch.Tensor, E: int) -> torch.Tensor:
    """The Switch-style load-balance loss over the leading axes."""
    me = probs.mean(0)
    ce = F.one_hot(eidx[..., 0], E).float().mean(0)
    return E * torch.sum(me * ce, -1)


def route(w: torch.Tensor, xf: torch.Tensor, *, top_k: int,
          capacity_factor: float = 1.25) -> dict:
    """The router and the dispatch plan of tokens ``xf`` (T, d) under
    router weights ``w`` (d, E).

    Returns ``gates`` (T, K) renormalised and ``eidx`` (T, K) int64 in
    descending probability, ``aux`` (the Switch-style load-balance loss,
    0-d f32), the capacity ``C``, ``slot_tok`` (E, C) int64 (T where a
    slot is empty), ``slot_gate`` (E, C) f32, ``pair_slot`` (T, K) int64:
    each token's kept pairs as flat slots e * C + c in ascending expert
    id, E * C for a pair dropped by capacity, and ``kept`` (T*K,) bool
    per sorted pair."""
    T = xf.shape[0]
    E = w.shape[1]
    probs, gates, eidx = _gate(w, xf, top_k)
    aux = _aux(probs, eidx, E)

    C = capacity(T, E, top_k, capacity_factor)
    dev = xf.device
    e_flat = eidx.reshape(-1)
    order = torch.argsort(e_flat, stable=True)
    e_s = e_flat[order]
    t_s = torch.div(order, top_k, rounding_mode="floor")
    g_s = gates.reshape(-1)[order]
    pos = torch.arange(T * top_k, device=dev) - torch.searchsorted(
        e_s, e_s, side="left")
    keep = pos < C
    row = torch.where(keep, e_s, E)                 # overflow -> row E
    col = torch.where(keep, pos, 0)
    slot_tok = torch.full((E + 1, C), T, dtype=torch.int64, device=dev)
    slot_tok[row, col] = t_s
    slot_gate = torch.zeros((E + 1, C), dtype=torch.float32, device=dev)
    slot_gate[row, col] = g_s
    pair = torch.empty_like(order)
    pair[order] = torch.where(keep, e_s * C + pos, E * C)
    pair = torch.gather(pair.reshape(T, top_k), 1,
                        torch.argsort(eidx, dim=1))
    return dict(gates=gates, eidx=eidx, aux=aux, C=C,
                slot_tok=slot_tok[:E], slot_gate=slot_gate[:E],
                pair_slot=pair, kept=keep)


def moe_apply(p: dict, x: torch.Tensor, *, top_k: int,
              capacity_factor: float = 1.25, dense_residual_fn=None):
    """x: (B, S, d) -> (y (B, S, d), aux (0-d f32))."""
    B, S, d = x.shape
    E = p["wi"].shape[0]
    T = B * S
    xf = x.reshape(T, d)
    r = route(p["router"]["w"], xf, top_k=top_k,
              capacity_factor=capacity_factor)
    C = r["C"]
    slot_tok = r["slot_tok"]
    valid = slot_tok < T
    xe = xf[torch.clamp(slot_tok, max=T - 1)]              # (E, C, d)
    gate = r["slot_gate"][..., None]
    if recorded(xe, gate, p["wi"], p["wg"], p["wo"]):
        h = _expert_swiglu(p, xe * valid[..., None].to(xe.dtype))
        ye = torch.bmm(h, p["wo"]) * gate.to(h.dtype)
    else:
        xe.mul_(valid[..., None].to(xe.dtype))
        h = _expert_swiglu(p, xe)
        del xe
        ye = torch.bmm(h, p["wo"])                          # (E, C, d)
        del h
        ye.mul_(gate.to(ye.dtype))
    y = _combine(ye.reshape(E * C, d), r["pair_slot"])
    return _tail(p, xf, y, dense_residual_fn).reshape(B, S, d), r["aux"]


def moe_apply_stepped(p: dict, x: torch.Tensor, *, top_k: int,
                      capacity_factor: float = 1.25,
                      dense_residual_fn=None):
    """x: (B, S, d) -> (y (B, S, d), aux): what S calls of
    :func:`moe_apply`, one for each position's B tokens, compute (the
    reference's serve prefill steps its decode over the prompt), in one
    pass. Each position's pairs are kept as its own call keeps them: in
    the call's pair order (batch row, then k), at most C(B) an expert
    (:func:`capacity`, at least 8, so with B <= 8 no pair is dropped).
    The kept pairs are sorted by expert and each expert's SwiGLU runs
    over its own rows: no (E, C, d) buffers and no empty slots. ``aux``
    is the mean of the calls' load-balance losses. One host read: the
    experts' row counts."""
    B, S, d = x.shape
    E = p["wi"].shape[0]
    T = B * S
    dev = x.device
    xf = x.reshape(T, d)
    probs, gates, eidx = _gate(p["router"]["w"], xf, top_k)
    aux = _aux(probs.reshape(B, S, E), eidx.reshape(B, S, top_k), E).mean()

    # a pair's place among its position's pairs to the same expert
    C = capacity(B, E, top_k, capacity_factor)
    e_flat = eidx.reshape(-1)
    pairs = torch.arange(T * top_k, device=dev)
    tok = torch.div(pairs, top_k, rounding_mode="floor")    # b * S + s
    key = (tok % S) * E + e_flat
    order = torch.argsort(key, stable=True)
    k_s = key[order]
    keep = torch.empty_like(e_flat, dtype=torch.bool)
    keep[order] = pairs - torch.searchsorted(k_s, k_s, side="left") < C

    # the kept pairs by expert; each expert over its own rows
    e_kept = torch.where(keep, e_flat, E)
    order = torch.argsort(e_kept, stable=True)
    counts = torch.bincount(e_kept, minlength=E + 1)[:E].tolist()
    n = sum(counts)
    order = order[:n]
    rows, g = tok[order], gates.reshape(-1)[order]
    ye = torch.empty((n, d), dtype=x.dtype, device=dev)
    lo = 0
    for e, m in enumerate(counts):
        if m:
            xe = xf[rows[lo:lo + m]]
            h = _expert_swiglu(p, xe, e)
            ye[lo:lo + m] = (h @ p["wo"][e]) * g[lo:lo + m, None].to(
                ye.dtype)
            lo += m
    slot = torch.full((T * top_k,), n, dtype=torch.int64, device=dev)
    slot[order] = torch.arange(n, device=dev)
    slot = torch.gather(slot.reshape(T, top_k), 1,
                        torch.argsort(eidx, dim=1))
    y = _combine(ye, slot)
    return _tail(p, xf, y, dense_residual_fn).reshape(B, S, d), aux


def _expert_swiglu(p: dict, xe: torch.Tensor, e: int | None = None):
    """silu(xe wg) * (xe wi) over the capacity buffers (E, C, d), or
    expert ``e``'s rows (m, d): in place, or out of place where autograd
    records."""
    wg, wi = (p["wg"], p["wi"]) if e is None else (p["wg"][e], p["wi"][e])
    if recorded(xe, wg, wi):
        return F.silu(torch.matmul(xe, wg)) * torch.matmul(xe, wi)
    h = F.silu(torch.matmul(xe, wg), inplace=True)
    return h.mul_(torch.matmul(xe, wi))


def _combine(ye: torch.Tensor, pair_slot: torch.Tensor) -> torch.Tensor:
    """Each token's kept expert outputs, rows of ``ye`` (n, d) named by
    ``pair_slot`` (T, K) in ascending expert id (n for a dropped pair),
    added in that order in ``ye``'s type: (T, d)."""
    n = ye.shape[0]
    y = torch.zeros((pair_slot.shape[0], ye.shape[1]), dtype=ye.dtype,
                    device=ye.device)
    for s in pair_slot.T:
        live = (s < n)[:, None]
        y = torch.where(live, y + ye[torch.clamp(s, max=n - 1)], y)
    return y


def _tail(p: dict, xf: torch.Tensor, y: torch.Tensor, dense_residual_fn):
    """The shared experts and the dense residual, in the reference's
    order."""
    if "shared" in p:
        y = y + swiglu(p["shared"], xf)
    if dense_residual_fn is not None:
        y = y + dense_residual_fn(xf)
    return y


def gdi_router_init(x: torch.Tensor, n_experts: int, *,
                    generator: torch.Generator | None = None, draws=None,
                    device=None) -> torch.Tensor:
    """Router weights (d, E) f32 from GDI cluster centroids of token
    embeddings ``x`` (T, d): ``core.gdi.gdi_parallel_init``'s centers on
    ``device`` (the card by default), each scaled to unit norm (floor
    1e-6), so the experts start as balanced regions of the embedding
    space. ``generator`` and ``draws`` are ``gdi_parallel_init``'s. The
    norms are correctly rounded, so the card gives the CPU's bits."""
    from ..core.gdi import gdi_parallel_init
    from ..kernels.exact_round import exact_sqnorm
    from ..kernels.ref import sqrt_rn
    centers, _ = gdi_parallel_init(x, n_experts, generator=generator,
                                   draws=draws, device=device)
    norm = sqrt_rn(exact_sqnorm(centers))
    centers = centers / torch.clamp(norm, min=1e-6)[:, None]
    return centers.T.contiguous()
