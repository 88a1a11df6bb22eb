"""K6: decode attention over the selected blocks of a cluster-major KV
cache (k²-attention), with the cache's pack and the cluster selection.

Port of ``repro.kernels.cluster_attend``. The cache stores each
(batch, kv-head)'s keys and values sorted by k²-means cluster, padded to
a fixed capacity: the cache IS the (kc, cap, dh) member table, so "attend
to the top-p clusters" reads p contiguous blocks.

CUDA tensors go through the hand-written kernel ``csrc/cluster_attend.cu``
(:func:`cluster_attend_partial`, which counts its launches); CPU tensors
through the plain version ``ref.cluster_attend_ref``. The kernel returns
the online-softmax state (m, l, acc) that the TPU kernel keeps in
scratch, so the decode path can merge the recent-token ring and the
token being decoded into it (``models.attention``);
:func:`cluster_attend` keeps the TPU kernel's contract and divides as
its ``_flush`` does. Validity comes as the TPU kernel's (rows, cap) mask
or as per-cluster sizes (slot < size is valid): the decode path passes
sizes, since validity in the cluster-major cache is always a prefix and
a (rows, cap) mask would be rebuilt every step.
"""
from __future__ import annotations

import ctypes

import torch

from ..device import host_input
from . import _build
from .ref import cluster_attend_ref

_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 6
         + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p])
_TABLE_TYPES = {torch.bfloat16: 1, torch.float32: 0}
_TICKETS: dict[tuple, torch.Tensor] = {}


def _tickets(device: torch.device, stream: int, bh: int) -> torch.Tensor:
    """The per-row tickets of the kernel's split combine: zero between
    launches (the last block of each row resets its own), so they are
    made once per device and stream and reused by the launches that run
    there in order."""
    key = (device.index, stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < bh:
        t = torch.zeros((max(bh, 256),), dtype=torch.int32, device=device)
        _TICKETS[key] = t
    return t


def cluster_attend_partial(q: torch.Tensor, k_table: torch.Tensor,
                           v_table: torch.Tensor, sel: torch.Tensor, *,
                           valid: torch.Tensor | None = None,
                           sizes: torch.Tensor | None = None):
    """Online-softmax state of each query row over its selected blocks.

    q: (BH, dh), one row per (batch, q-head); k_table/v_table: (rows, cap,
    dh) bf16 or f32; sel: (BH, p) int32 table rows, an id outside
    [0, rows) selecting nothing (the sharded decode's clusters that
    another shard holds); exactly one of valid (rows, cap) int32 (> 0 is
    valid) or sizes (rows,) int32 (slots below the size are valid).
    Returns (m (BH,), l (BH,), acc (BH, dh)), f32, at scale dh^-0.5: m
    the largest valid logit, l = sum exp(logit - m), acc = sum exp(logit
    - m) v; a row whose blocks are all empty gives (-inf, 0, 0)."""
    if (valid is None) == (sizes is None):
        raise ValueError("cluster_attend: pass exactly one of valid, sizes")
    if q.dim() != 2 or k_table.dim() != 3 or sel.dim() != 2 \
            or k_table.shape[2] != q.shape[1] \
            or v_table.shape != k_table.shape or sel.shape[0] != q.shape[0]:
        raise ValueError(f"cluster_attend: q {tuple(q.shape)}, tables "
                         f"{tuple(k_table.shape)}/{tuple(v_table.shape)} and "
                         f"sel {tuple(sel.shape)} must be (BH, dh), "
                         f"(rows, cap, dh) and (BH, p)")
    if q.device.type == "cpu":
        return cluster_attend_ref(q, k_table, v_table, sel, valid=valid,
                                  sizes=sizes)
    bh, dh = q.shape
    rows, cap, _ = k_table.shape
    p = sel.shape[1]
    if k_table.dtype not in _TABLE_TYPES or dh > 256:
        raise ValueError(f"cluster_attend: tables must be bf16 or f32 with "
                         f"dh <= 256, got {k_table.dtype}, dh={dh}")
    name = "cluster_attend"
    qf = q.float().contiguous()
    _build.require(name, "q", qf, torch.float32, (bh, dh))
    _build.require(name, "k_table", k_table, k_table.dtype, (rows, cap, dh))
    _build.require(name, "v_table", v_table, k_table.dtype, (rows, cap, dh))
    _build.require(name, "sel", sel, torch.int32, (bh, p))
    if sizes is not None:
        _build.require(name, "sizes", sizes, torch.int32, (rows,))
        vs = sizes
    else:
        _build.require(name, "valid", valid, torch.int32, (rows, cap))
        vs = valid
    m = torch.empty((bh,), dtype=torch.float32, device=q.device)
    l = torch.empty((bh,), dtype=torch.float32, device=q.device)
    acc = torch.empty((bh, dh), dtype=torch.float32, device=q.device)
    splits = _build.function("cluster_attend", "k2_cluster_attend_splits",
                             [ctypes.c_int])(p)
    ws = torch.empty((bh, splits, dh + 2), dtype=torch.float32,
                     device=q.device)
    stream = _build.stream_ptr(q.device)
    fn = _build.function("cluster_attend", "k2_cluster_attend", _ARGS)
    ptr = _build.ptr
    _build.check(fn(ptr(qf), ptr(k_table), ptr(v_table), ptr(vs),
                    int(sizes is not None), ptr(sel), ptr(m), ptr(l),
                    ptr(acc), ptr(ws), ptr(_tickets(q.device, stream, bh)),
                    bh, rows, cap, dh, p, _TABLE_TYPES[k_table.dtype],
                    dh ** -0.5, stream), name)
    _build.count("cluster_attend")
    return m, l, acc


def cluster_attend(q, k_table, v_table, valid, sel, *, device=None):
    """The TPU kernel's contract. q: (BH, dh); k_table/v_table:
    (BHkv*kc, cap, dh) cluster-major cache; valid: (BHkv*kc, cap) int32;
    sel: (BH, p) int32 flat cluster ids (already offset by kv-head).
    Returns (BH, dh) attention outputs in q's type. Tensors are used
    where they lie; host arrays go to ``device`` (the card by default)."""
    q, k_table, v_table, valid, sel = (host_input(t, device) for t in (
        q, k_table, v_table, valid, sel))
    _, l, acc = cluster_attend_partial(q, k_table, v_table, sel,
                                       valid=valid)
    return (acc / torch.clamp(l, min=1e-30)[:, None]).to(q.dtype)


def cluster_major_pack(k, v, members, member_mask):
    """Repack a flat (B, Hkv, S, dh) cache into the cluster-major layout:
    (B*Hkv*kc, cap, dh) tables + (B*Hkv*kc, cap) int32 validity."""
    B, Hkv, S, dh = k.shape
    kc, cap = members.shape[2], members.shape[3]
    idx = members.reshape(B, Hkv, kc * cap, 1).long().expand(-1, -1, -1, dh)
    mask = member_mask.reshape(B, Hkv, kc * cap, 1).to(k.dtype)
    kt = (torch.gather(k, 2, idx) * mask).reshape(B * Hkv * kc, cap, dh)
    vt = (torch.gather(v, 2, idx) * mask).reshape(B * Hkv * kc, cap, dh)
    return kt, vt, member_mask.reshape(B * Hkv * kc, cap).to(torch.int32)


def select_clusters(q, centroids, top_p: int):
    """Per-q-head top-p nearest clusters, flattened to table row ids, ties
    to the lower id. q: (B, H, dh); centroids: (B, Hkv, kc, dh) ->
    (B*H, p) int32."""
    from ..core.distance import bottom_k
    B, H, dh = q.shape
    Hkv, kc = centroids.shape[1], centroids.shape[2]
    qr = q.reshape(B, Hkv, H // Hkv, dh)
    d2 = (torch.sum(qr * qr, -1)[..., None]
          - 2.0 * torch.einsum("bhgd,bhkd->bhgk", qr, centroids)
          + torch.sum(centroids * centroids, -1)[:, :, None, :])
    top = bottom_k(d2.reshape(-1, kc), top_p).reshape(B, Hkv, -1, top_p)
    base = (torch.arange(B, device=q.device)[:, None, None] * Hkv
            + torch.arange(Hkv, device=q.device)[None, :, None]) * kc
    return (top + base[..., None]).reshape(B * H, top_p).to(torch.int32)
