"""k²-means over the KV cache (port of ``repro.models.kv_cluster``): the
paper's technique as a serving feature.

``build_kv_clusters`` runs at the prefill -> decode transition with a
fixed iteration budget: strided-sample init, two Lloyd sweeps, then
k_n-restricted k²-means sweeps (the paper's Algorithm 1).
``cluster_append`` keeps its member lists over the flat cache as tokens
decode. The cluster-major functions keep the cache sorted by cluster and
fold the recent-token ring into it as tokens decode.

Where the port differs from the reference, and why:
- the segment means are a segment sum in f64 that adds each segment's
  rows in row order (``ops.segment_sum_f64``), rounded once to f32, where
  the reference multiplies by a (..., S, kc) one-hot (8.6 GB at
  Qwen3-8B's KV width and a 65,536-token prompt): the card gives the
  CPU's sums, in every run;
- the (..., S, kc) distances and the (..., S, k_n, d) candidate centers
  are formed in chunks of tokens (:data:`CHUNK_ELEMS` values), so one
  layer's clustering holds about a gigabyte of temporaries; every value
  is computed as the reference computes it;
- ties go to the lower index everywhere, as in the reference: ``argmin``
  takes the first minimum, the k_n graph is the stable
  ``core.distance.bottom_k`` and the member sort ``argsort(stable=True)``
  (empty clusters all sit at centroid 0, so exact ties happen);
- the strided init truncates ``jnp.linspace`` as XLA folds it
  (:func:`strided_ids`);
- ``cluster_append`` and the ring folds update the tables, member
  lists, centroids, sizes and counts in place
  and stop after the ring's live rows (the reference scans all R slots
  and masks the rest): the caller names how many are live, or one host
  read finds out.
"""
from __future__ import annotations

import torch

from ..core.distance import bottom_k
from ..device import host_input
from ..kernels.ops import segment_sum, segment_sum_f64
from .layers import scale

# values in one chunk of the (..., tokens, kc) distances or of the
# (..., tokens, k_n, d) candidate centers
CHUNK_ELEMS = 1 << 28


def _sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., m, d) x (..., k, d) -> (..., m, k): ``max(|a|^2 - 2 a.b +
    |b|^2, 0)`` in the inputs' type, built in place in the product."""
    out = torch.einsum("...md,...kd->...mk", a, b).mul_(-2.0)
    out.add_(torch.sum(a * a, -1)[..., :, None])
    out.add_(torch.sum(b * b, -1)[..., None, :])
    return out.clamp_(min=0.0)


def _nearest(kf: torch.Tensor, cent: torch.Tensor) -> torch.Tensor:
    """First nearest centroid of every token: (B, H, S, d) x (B, H, kc, d)
    -> (B, H, S) int64, in chunks of tokens."""
    B, H, S, _ = kf.shape
    step = max(1, CHUNK_ELEMS // (B * H * cent.shape[2]))
    return torch.cat([torch.argmin(_sqdist(kf[:, :, s:s + step], cent), -1)
                      for s in range(0, S, step)], dim=2)


def _update(keys: torch.Tensor, a: torch.Tensor, kc: int):
    """Segment means of keys (B, H, S, d) by cluster a (B, H, S) ->
    (centroids (B, H, kc, d), counts (B, H, kc)); an empty cluster's
    centroid is 0. Sums in f64, rounded once to the keys' type."""
    B, H, S, d = keys.shape
    row = torch.arange(B * H, device=keys.device).reshape(B, H, 1) * kc
    seg = (a.long() + row).reshape(-1)
    sums = segment_sum_f64(keys.reshape(-1, d), seg, B * H * kc)
    counts = segment_sum(torch.ones_like(seg, dtype=keys.dtype), seg,
                         B * H * kc).reshape(B, H, kc)
    cent = sums.reshape(B, H, kc, d)
    return cent / torch.clamp(counts[..., None], min=1.0), counts


def strided_ids(S: int, kc: int) -> torch.Tensor:
    """``jnp.linspace(0, S - 1, kc).astype(int32)`` as the reference
    computes it: XLA folds ``(S - 1) * (i / (kc - 1))`` into ``i * c``
    with ``c = (S - 1) * (1 / (kc - 1))`` rounded twice in f32; the
    endpoint is exact and the cast truncates (``core.model._strided_ids``
    rounds instead)."""
    if kc == 1:
        return torch.zeros((1,), dtype=torch.int64)
    c = (S - 1) * (torch.tensor(1.0) / (kc - 1))
    v = torch.cat([torch.arange(kc - 1, dtype=torch.float32) * c,
                   torch.tensor([S - 1.0])])
    return v.long()


def build_kv_clusters(keys, kc: int, cap: int, lloyd_iters: int = 2,
                      k2_iters: int = 4, kn: int = 8, *, device=None):
    """keys: (B, Hkv, S, d) -> (centroids (B, Hkv, kc, d) in the keys'
    type, members (B, Hkv, kc, cap) int32, member_mask bool, sizes
    (B, Hkv, kc) int32). Members of a cluster are listed in token order;
    a cluster's tokens past ``cap`` are dropped. A tensor is clustered
    where it lies; a host array goes to ``device`` (the card by
    default)."""
    keys = host_input(keys, device)
    B, H, S, d = keys.shape
    dev = keys.device
    kf = keys.float()
    cent = kf[:, :, strided_ids(S, kc).to(dev)]                # (B,H,kc,d)
    a = _nearest(kf, cent)
    for _ in range(lloyd_iters):
        cent, _ = _update(kf, a, kc)
        a = _nearest(kf, cent)
    # k²-means refinement: k_n-restricted assignment sweeps
    knn = min(kn, kc)
    bh = torch.arange(B * H, device=dev).reshape(B, H, 1, 1) * kc
    ksq = torch.sum(kf * kf, -1)                               # (B,H,S)
    step = max(1, CHUNK_ELEMS // (B * H * knn * d))
    for _ in range(k2_iters):
        nb = bottom_k(_sqdist(cent, cent).reshape(-1, kc), knn)
        nb = nb.reshape(B, H, kc, knn).long()
        flat_cent = cent.reshape(B * H * kc, d)
        csq = torch.sum(cent * cent, -1).reshape(-1)
        new = torch.empty_like(a)
        for s in range(0, S, step):
            part = a[:, :, s:s + step]
            cand = torch.gather(nb, 2, part[..., None].expand(-1, -1, -1,
                                                              knn))
            gid = (cand + bh).reshape(-1)
            cand_cent = flat_cent[gid].reshape(*cand.shape, d)
            dist = torch.einsum("bhsd,bhskd->bhsk", kf[:, :, s:s + step],
                                cand_cent).mul_(-2.0)
            dist.add_(ksq[:, :, s:s + step, None])
            dist.add_(csq[gid].reshape(cand.shape)).clamp_(min=0.0)
            loc = torch.argmin(dist, -1, keepdim=True)
            new[:, :, s:s + step] = torch.gather(cand, -1, loc)[..., 0]
        a = new
        cent, _ = _update(kf, a, kc)
    # member table: sort token ids by cluster, scatter positions < cap
    order = torch.argsort(a, dim=-1, stable=True)             # (B,H,S)
    a_s = torch.gather(a, -1, order)
    first = torch.searchsorted(a_s, a_s, side="left")
    pos = torch.arange(S, device=dev) - first
    keep = pos < cap
    row = torch.where(keep, a_s, kc)
    col = torch.where(keep, pos, 0)
    bi = torch.arange(B, device=dev)[:, None, None]
    hi = torch.arange(H, device=dev)[None, :, None]
    members = torch.zeros((B, H, kc + 1, cap), dtype=torch.int32, device=dev)
    mask = torch.zeros((B, H, kc + 1, cap), dtype=torch.bool, device=dev)
    members[bi, hi, row, col] = order.to(torch.int32)
    mask[bi, hi, row, col] = True
    members = members[:, :, :kc].contiguous()
    mask = mask[:, :, :kc].contiguous()
    sizes = torch.sum(mask, -1, dtype=torch.int32)
    return cent.to(keys.dtype), members, mask, sizes


def build_cluster_major(keys: torch.Tensor, values: torch.Tensor, kc: int,
                        cap: int, out=None, clusters=None, **kw):
    """Cluster-major KV tables: run k²-means over the keys and repack the
    cache so each cluster's members are contiguous. keys/values:
    (B, Hkv, S, d) -> (kt (B, Hkv, kc, cap, d), vt same, centroids
    (B, Hkv, kc, d), sizes (B, Hkv, kc) int32); slots past a cluster's
    size are 0. ``out``: optional (kt, vt) contiguous tensors to fill.
    ``clusters``: optional (lo, hi), pack only clusters lo..hi-1 (a
    shard's, under ``launch.sharding.cache_specs``): kt, vt and sizes
    then hold those clusters, the centroids all kc."""
    cent, members, mask, sizes = build_kv_clusters(keys, kc, cap, **kw)
    if clusters is not None:
        lo, hi = clusters
        members, mask = members[:, :, lo:hi], mask[:, :, lo:hi]
        sizes, kc = sizes[:, :, lo:hi].contiguous(), hi - lo
    B, H, S, d = keys.shape
    row = torch.arange(B * H, device=keys.device).reshape(B, H, 1, 1) * S
    idx = (members.long() + row).reshape(-1)
    if out is None:
        out = (torch.empty((B, H, kc, cap, d), dtype=keys.dtype,
                           device=keys.device),
               torch.empty((B, H, kc, cap, d), dtype=values.dtype,
                           device=values.device))
    live = mask[..., None]
    for src, dst in zip((keys, values), out):
        torch.index_select(src.reshape(B * H * S, d), 0, idx,
                           out=dst.view(-1, d))
        dst.mul_(live.to(dst.dtype))
    return out[0], out[1], cent, sizes


def _ring_fold(kt, vt, centroids, sizes, extra, ring_k, ring_v, fill,
               centroid_rule, n_live: int | None):
    """Shared ring absorb behind :func:`recluster_ring` and
    :func:`kv_partial_fit`: each live ring row appends to its nearest
    cluster's table (a full cluster drops the row), then
    ``centroid_rule(cent, extra, bi, hi, c, krow, ok, sizes)`` applies
    the caller's drift policy (``sizes`` after the insert, ``ok`` the
    rows that landed). Rows are taken in ring order; the first
    ``n_live`` = min(fill, R) are live (read from ``fill`` when None).
    Updates in place; returns the tables, centroids, sizes and ``extra``
    with the ring and fill reset to 0."""
    B, H, kc, cap, d = kt.shape
    R = ring_k.shape[2]
    if n_live is None:
        n_live = int(torch.clamp(fill, max=R))
    bi = torch.arange(B, device=kt.device)[:, None]
    hi = torch.arange(H, device=kt.device)[None, :]
    for r in range(min(n_live, R)):
        krow, vrow = ring_k[:, :, r], ring_v[:, :, r]          # (B, H, d)
        # in the centroids' type: the reference promotes a bf16 ring
        # against the f32 centroids of an f32 cache
        c = torch.argmin(_sqdist(krow[:, :, None].to(centroids.dtype),
                                 centroids)[:, :, 0], -1)
        sz = sizes[bi, hi, c]
        slot = torch.clamp(sz, max=cap - 1)
        ok = sz < cap
        kt[bi, hi, c, slot] = torch.where(ok[..., None], krow.to(kt.dtype),
                                          kt[bi, hi, c, slot])
        vt[bi, hi, c, slot] = torch.where(ok[..., None], vrow.to(vt.dtype),
                                          vt[bi, hi, c, slot])
        sizes[bi, hi, c] = sz + ok.to(sizes.dtype)
        centroid_rule(centroids, extra, bi, hi, c, krow, ok, sizes)
    ring_k.zero_()
    ring_v.zero_()
    fill.zero_()
    return kt, vt, centroids, sizes, extra, ring_k, ring_v, fill


def recluster_ring(kt, vt, centroids, sizes, ring_k, ring_v, fill, *,
                   n_live: int | None = None):
    """Maintenance op: absorb the recent-token ring into the cluster-major
    tables: each ring row appends to its nearest cluster, the centroid
    drifts by the running mean over table rows, and the ring resets.
    Returns (kt, vt, centroids, sizes, ring_k, ring_v, fill)."""

    def rule(cent, extra, bi, hi, c, krow, ok, sizes):
        n = sizes[bi, hi, c].float()[..., None]
        old = cent[bi, hi, c]
        cent[bi, hi, c] = torch.where(
            ok[..., None],
            old + (krow.to(cent.dtype) - old)
            / torch.clamp(n, min=1.0).to(cent.dtype), old)

    kt, vt, centroids, sizes, _, rk, rv, f = _ring_fold(
        kt, vt, centroids, sizes, None, ring_k, ring_v, fill, rule, n_live)
    return kt, vt, centroids, sizes, rk, rv, f


def kv_partial_fit(kt, vt, centroids, sizes, counts, ring_k, ring_v, fill,
                   *, n_live: int | None = None):
    """Streaming ``partial_fit`` over the cluster-major KV tables: fold
    the live ring rows into (kt, vt) by nearest-centroid append, moving
    each winning centroid by the Sculley rate ``eta = 1 / counts``.
    ``counts`` (B, H, kc) f32 keeps growing past ``cap`` even when a full
    table drops the row. Returns (kt, vt, centroids, sizes, counts,
    ring_k, ring_v, fill) with the ring reset."""

    def rule(cent, counts, bi, hi, c, krow, ok, sizes):
        counts[bi, hi, c] = counts[bi, hi, c] + 1.0
        eta = 1.0 / torch.clamp(counts[bi, hi, c], min=1.0)
        old = cent[bi, hi, c]
        cent[bi, hi, c] = old + eta[..., None].to(cent.dtype) \
            * (krow.to(cent.dtype) - old)

    return _ring_fold(kt, vt, centroids, sizes, counts, ring_k, ring_v,
                      fill, rule, n_live)


def cluster_major_append(kt, vt, centroids, sizes, k_new, v_new,
                         ema: float = 0.05):
    """Online insert into the cluster-major tables: the decoded token's
    K/V row is written at (nearest cluster, its size); a full cluster
    drops the insert; the winning centroid moves by ``ema``. In place;
    returns (kt, vt, centroids, sizes)."""
    B, H, kc, cap, d = kt.shape
    c = torch.argmin(_sqdist(k_new[:, :, None], centroids)[:, :, 0], -1)
    bi = torch.arange(B, device=kt.device)[:, None]
    hi = torch.arange(H, device=kt.device)[None, :]
    sz = sizes[bi, hi, c]
    slot = torch.clamp(sz, max=cap - 1)
    ok = sz < cap
    kt[bi, hi, c, slot] = torch.where(ok[..., None], k_new.to(kt.dtype),
                                      kt[bi, hi, c, slot])
    vt[bi, hi, c, slot] = torch.where(ok[..., None], v_new.to(vt.dtype),
                                      vt[bi, hi, c, slot])
    sizes[bi, hi, c] = sz + ok.to(sizes.dtype)
    old = centroids[bi, hi, c]
    centroids[bi, hi, c] = old + scale(k_new.to(centroids.dtype) - old, ema)
    return kt, vt, centroids, sizes


def cluster_append(centroids, members, member_mask, sizes, k_new, pos: int,
                   ema: float = 0.05):
    """Online insert of one decoded token's key into the cluster structure
    over the flat cache: slot ``pos`` joins its nearest cluster's member
    list (a full cluster drops the insert; the token stays in the flat
    cache) and the winning centroid moves toward the key by ``ema``.
    centroids (B, H, kc, d); members/member_mask (B, H, kc, cap); sizes
    (B, H, kc); k_new (B, H, d); pos a host int. In place, with no host
    read; returns (centroids, members, member_mask, sizes)."""
    B, H, kc, cap = members.shape
    c = torch.argmin(_sqdist(k_new[:, :, None], centroids)[:, :, 0], -1)
    bi = torch.arange(B, device=members.device)[:, None]
    hi = torch.arange(H, device=members.device)[None, :]
    sz = sizes[bi, hi, c]
    slot = torch.clamp(sz, max=cap - 1)
    ok = sz < cap
    members[bi, hi, c, slot] = members[bi, hi, c, slot].masked_fill(ok, pos)
    member_mask[bi, hi, c, slot] = member_mask[bi, hi, c, slot] | ok
    sizes[bi, hi, c] = sz + ok.to(sizes.dtype)
    old = centroids[bi, hi, c]
    centroids[bi, hi, c] = old + scale(k_new.to(centroids.dtype) - old, ema)
    return centroids, members, member_mask, sizes
