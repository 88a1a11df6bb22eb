"""Attention variants (port of ``repro.models.attention``): GQA with
cluster-major and flat-cache k²-attention decode, and MLA (DeepSeek-V2).

Prefill attention is query-chunked, so no (S, Skv) logit tensor is ever
held; a chunk's logits are (B, Hkv, g, qc, Skv) f32 at most. Under the
causal mask the keys after a chunk's last query get weight exactly 0,
so each chunk reads only the keys up to its last query (the reference
masks them), and one-token decode reads only the filled slots of the
flat cache and of MLA's latent cache (the reference masks the rest).
Non-causal attention (Whisper's encoder, its decoder's cross attention
over the encoder's keys) reads every key.

k²-attention decode over the cluster-major cache selects each q-head's
top-p clusters (``kernels.cluster_attend.select_clusters``, the
reference's ``_select_top_clusters`` turned into table row ids; ties to
the lower cluster id, as ``lax.top_k``), then K6
(``kernels.cluster_attend``) gives the online-softmax state over those
blocks, where the reference computes the same state in jnp
(``_cm_partial``); the recent-token ring and the token being decoded are
merged into it in plain torch, exactly as the reference merges them.
Under a mesh whose data size divides kc (``mesh=``, the reference's
``shard_map`` branch), each rank holds its kc / P clusters' tables
(``launch.sharding.cache_specs``) and the replicated centroids: the
selection is replicated, K6 runs once over the rank's own tables (a
cluster another rank holds is selected as table row -1, which selects
nothing), and one gather of every rank's (m, l, acc) lets each rank
merge them as the reference's ``pmax``/``psum`` do, adding in shard
order. The flat-cache variant (:func:`clustered_decode_attention`)
selects the same way and gathers the chosen clusters' member rows from
the flat cache, in plain torch as the reference does: it reaches no
kernel.

MLA decode reads the latent cache with the key up-projection absorbed
into the query, in f32 as the reference; it converts only the live
slots to f32 (the reference converts the whole cache every step) and
takes the scores over the latent and the rope part in one product.

Decode writes the caches in place (the flat cache's slot ``cur_pos``;
the latent cache's; the ring's next slot and its fill count), where the
reference returns new arrays: the tables are never copied.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels.cluster_attend import cluster_attend_partial, select_clusters
from ..launch.mesh import dp_size
from .layers import (apply_rope, dense, dense_init, head_spec, recorded,
                     rmsnorm, rmsnorm_init, scale, shard)


def _softmax(logits: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` over the last axis: exp(x - max) / sum, in
    place, or out of place with the same arithmetic where autograd
    records (the max then held constant, as ``jax.nn.softmax`` holds
    it)."""
    if recorded(logits):
        e = torch.exp(logits - torch.amax(logits.detach(), dim=-1,
                                          keepdim=True))
        return e / torch.sum(e, dim=-1, keepdim=True)
    logits.sub_(torch.amax(logits, dim=-1, keepdim=True)).exp_()
    return logits.div_(torch.sum(logits, dim=-1, keepdim=True))


# --------------------------------------------------------------------------
# chunked causal attention core
# --------------------------------------------------------------------------

def causal_attention(q, k, v, *, causal: bool = True,
                     q_chunk: int = 512) -> torch.Tensor:
    """q: (B, S, H, dh); k, v: (B, Skv, Hkv, dh) -> (B, S, H, dh).

    Grouped-query: H = g * Hkv. Logits in f32 from the bf16-scaled
    queries, softmax weights cast to v's type for the value product, as
    the reference. A last chunk shorter than ``q_chunk`` is allowed (the
    reference asserts S % q_chunk == 0, which Whisper's 1500 frames at
    512 fail). ``causal=False`` is bidirectional or cross attention
    (Whisper's encoder, the decoder's cross attention): each chunk reads
    all Skv keys, unmasked. Causal, Skv = S and each chunk reads the keys
    up to its last query."""
    B, S, H, dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    qr = scale(q, dh ** -0.5).reshape(B, S, Hkv, g, dh)
    kt = k.float().permute(0, 2, 3, 1)                 # (B, Hkv, dh, Skv)
    vr = v.permute(0, 2, 1, 3)                         # (B, Hkv, Skv, dh)
    train = recorded(q, k, v)
    out = [] if train else torch.empty((B, S, Hkv, g, v.shape[-1]),
                                       dtype=v.dtype, device=q.device)
    for lo in range(0, S, q_chunk):
        hi = min(S, lo + q_chunk)
        ke = hi if causal else Skv     # causal: keys up to the last query
        n = hi - lo
        qb = qr[:, lo:hi].float().permute(0, 2, 3, 1, 4)   # (B,Hkv,g,n,dh)
        logits = torch.matmul(qb.reshape(B, Hkv, g * n, dh), kt[..., :ke])
        if causal:
            pos = torch.arange(lo, hi, device=q.device)
            late = pos[:, None] < pos[None, :]             # (n, n)
            if train:       # out of place: the product's output is saved
                late = torch.cat([late.new_zeros((n, lo)), late], 1)
                logits = logits.view(B, Hkv, g, n, ke).masked_fill(
                    late, -torch.inf).view(B, Hkv, g * n, ke)
            else:
                logits.view(B, Hkv, g, n, ke)[..., lo:].masked_fill_(
                    late, -torch.inf)
        w = _softmax(logits).to(v.dtype)
        o = torch.matmul(w, vr[:, :, :ke])                 # (B,Hkv,g*n,dh)
        o = o.reshape(B, Hkv, g, n, -1).permute(0, 3, 1, 2, 4)
        if train:
            out.append(o)
        else:
            out[:, lo:hi] = o
        del logits, w, o           # before the next chunk's are allocated
    if train:
        out = torch.cat(out, 1)
    return out.reshape(B, S, H, v.shape[-1])


def decode_attention(q, k, v) -> torch.Tensor:
    """One-token decode: q (B, H, dh) against every slot of k/v in the
    decode-native layout (B, Hkv, S, dh) (the caller passes the live
    slots; the reference masks the others). The decoder's cross
    attention reads all enc_len slots of ``xk``/``xv``."""
    B, H, dh = q.shape
    Hkv = k.shape[1]
    g = H // Hkv
    qr = scale(q.reshape(B, Hkv, g, dh), dh ** -0.5)
    w = _softmax(torch.einsum("bhgd,bhsd->bhgs", qr.float(), k.float()))
    out = torch.einsum("bhgs,bhsd->bhgd", w.to(v.dtype), v)
    return out.reshape(B, H, dh)


def clustered_decode_attention(q, k, v, centroids, members, member_mask,
                               top_p: int, self_kv=None) -> torch.Tensor:
    """k²-attention over the flat cache: attend only to the members of
    each q-head's top-p nearest KV clusters.

    q: (B, H, dh); k, v: (B, Hkv, S, dh) decode-native layout;
    centroids: (B, Hkv, kc, dh); members: (B, Hkv, kc, cap) int32 token
    slots; member_mask: bool, same shape. self_kv: optional (k_new,
    v_new), each (B, Hkv, dh), the token being decoded, which joins the
    softmax exactly. The member rows are gathered by flat index, a
    (B, Hkv, g, top_p * cap (+1), dh) copy of the chosen rows."""
    B, H, dh = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    cap = members.shape[3]
    g = H // Hkv
    m = top_p * cap
    sel = select_clusters(q, centroids, top_p).long()          # (B*H, p)
    tok = members.reshape(-1, cap)[sel].reshape(B, Hkv, g, m)
    live = member_mask.reshape(-1, cap)[sel].reshape(B, Hkv, g, m)
    base = torch.arange(B * Hkv, device=q.device).reshape(B, Hkv, 1, 1) * S
    idx = (tok.long() + base).reshape(-1)
    kk = k.reshape(-1, dh)[idx].reshape(B, Hkv, g, m, dh)
    vv = v.reshape(-1, dh)[idx].reshape(B, Hkv, g, m, dh)
    if self_kv is not None:
        k_new, v_new = self_kv
        kk = torch.cat([kk, k_new[:, :, None, None].to(kk.dtype).expand(
            B, Hkv, g, 1, dh)], dim=3)
        vv = torch.cat([vv, v_new[:, :, None, None].to(vv.dtype).expand(
            B, Hkv, g, 1, dh)], dim=3)
        live = torch.cat([live, live.new_ones((B, Hkv, g, 1))], dim=3)
    qr = q.reshape(B, Hkv, g, dh)
    logits = torch.einsum("bhgd,bhgmd->bhgm", qr.float(),
                          kk.float()) * dh ** -0.5
    w = _softmax(logits.masked_fill_(~live, -torch.inf))
    w = w.masked_fill_(~live, 0.0).to(vv.dtype)
    out = torch.einsum("bhgm,bhgmd->bhgd", w, vv)
    return out.reshape(B, H, dh)


# --------------------------------------------------------------------------
# k²-attention over the cluster-major cache
# --------------------------------------------------------------------------

def _merge_shards(mesh, m, l, acc):
    """The reference's ``pmax``/``psum`` merge of the shards' softmax
    states, from one gather of every rank's (m, l, acc) (f32, (BH,),
    (BH,), (BH, dh)): gm = max m, corr = exp(m - gm) (0 where m is not
    finite), l and acc the shard-order sums of l·corr and acc·corr. The
    same bits on every rank."""
    g = mesh.gather(torch.cat([m[:, None], l[:, None], acc], dim=1))
    ms = g[:, :, 0]
    gm = torch.amax(ms, dim=0)
    gm_safe = torch.where(torch.isfinite(gm), gm, 0.0)
    corr = torch.where(torch.isfinite(ms), torch.exp(ms - gm_safe), 0.0)
    l_out = g[0, :, 1] * corr[0]
    acc_out = g[0, :, 2:] * corr[0][:, None]
    for j in range(1, g.shape[0]):
        l_out = l_out + g[j, :, 1] * corr[j]
        acc_out = acc_out + g[j, :, 2:] * corr[j][:, None]
    return gm, l_out, acc_out


def cluster_major_decode_attention(q, kt, vt, centroids, sizes, top_p: int,
                                   self_kv=None, ring=None,
                                   mesh=None) -> torch.Tensor:
    """k²-attention over the cluster-major KV cache.

    q: (B, H, dh); kt/vt: (B, Hkv, kc, cap, dh) contiguous, the cache
    sorted by k²-means cluster; centroids: (B, Hkv, kc, dh); sizes:
    (B, Hkv, kc) int32. ring: optional (ring_k, ring_v, fill), the exact
    recent-token buffer ((B, Hkv, R, dh) x2 and a 0-d fill count);
    self_kv: optional (k_new, v_new), each (B, Hkv, dh), the token being
    decoded, which joins the softmax exactly. One K6 launch per call.
    ``mesh``: a mesh whose data size P divides kc: kt, vt and sizes then
    hold this rank's clusters only, (B, Hkv, kc / P, ...), shard i's the
    clusters i·kc/P .. (i+1)·kc/P - 1, and the ranks' partial states are
    merged (one gather); every rank returns the same output."""
    B, H, dh = q.shape
    Hkv, kc, cap = centroids.shape[1], centroids.shape[2], kt.shape[3]
    g = H // Hkv
    qr = q.reshape(B, Hkv, g, dh)
    sel = select_clusters(q, centroids, top_p)            # replicated
    dsz = dp_size(mesh) if mesh is not None else 1
    sharded = dsz > 1 and kc % dsz == 0
    kc_loc = kc // dsz if sharded else kc
    if kt.shape[2] != kc_loc or sizes.shape[2] != kc_loc:
        raise ValueError(f"cluster_major_decode_attention: tables of "
                         f"{kt.shape[2]} clusters for kc {kc} over "
                         f"{dsz if sharded else 1} shard(s)")
    if sharded:     # global ids -> this shard's table rows, -1 elsewhere
        c = sel % kc - mesh.index * kc_loc
        here = (c >= 0) & (c < kc_loc)
        sel = torch.where(here, sel // kc * kc_loc + c, -1).to(torch.int32)
    m, l, acc = cluster_attend_partial(
        qr.reshape(B * H, dh), kt.reshape(B * Hkv * kc_loc, cap, dh),
        vt.reshape(B * Hkv * kc_loc, cap, dh), sel,
        sizes=sizes.reshape(-1))
    if sharded:
        m, l, acc = _merge_shards(mesh, m, l, acc)
    m, l = m.reshape(B, Hkv, g), l.reshape(B, Hkv, g)
    acc = acc.reshape(B, Hkv, g, dh)
    qf = qr.float()
    if ring is not None:
        ring_k, ring_v, fill = ring                            # (B,Hkv,R,dh)
        R = ring_k.shape[2]
        r_log = torch.einsum("bhgd,bhrd->bhgr", qf,
                             ring_k.float()) * dh ** -0.5
        live = torch.arange(R, device=q.device) < torch.clamp(fill, max=R)
        r_log = torch.where(live, r_log, -torch.inf)
        m_new = torch.maximum(m, torch.amax(r_log, dim=-1))
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        w_r = torch.where(live, torch.exp(r_log - m_safe[..., None]), 0.0)
        l = l * corr + torch.sum(w_r, dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhgr,bhrd->bhgd", w_r, ring_v.float())
        m = m_new
    if self_kv is not None:
        k_new, v_new = self_kv                                 # (B,Hkv,dh)
        s_log = torch.einsum("bhgd,bhd->bhg", qf,
                             k_new.float()) * dh ** -0.5
        m_new = torch.maximum(m, s_log)
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        w_self = torch.exp(s_log - m_safe)
        l = l * corr + w_self
        acc = acc * corr[..., None] + w_self[..., None] \
            * v_new[:, :, None].float()
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(B, H, dh).to(q.dtype)


# --------------------------------------------------------------------------
# GQA block
# --------------------------------------------------------------------------

def gqa_init(gen: torch.Generator, d: int, n_heads: int, n_kv: int,
             d_head: int, qk_norm: bool, dtype=torch.bfloat16,
             new=None) -> dict:
    p = {"wq": dense_init(gen, d, n_heads * d_head, dtype, new),
         "wk": dense_init(gen, d, n_kv * d_head, dtype, new),
         "wv": dense_init(gen, d, n_kv * d_head, dtype, new),
         "wo": dense_init(gen, n_heads * d_head, d, dtype, new)}
    if qk_norm:
        p["qn"] = rmsnorm_init(d_head, dtype, gen.device, new)
        p["kn"] = rmsnorm_init(d_head, dtype, gen.device, new)
    return p


def gqa_project(p, x, n_heads: int, n_kv: int, d_head: int, positions,
                rope_theta: float, qk_norm: bool):
    B = x.shape[0]
    q = dense(p["wq"], x).reshape(B, -1, n_heads, d_head)
    k = dense(p["wk"], x).reshape(B, -1, n_kv, d_head)
    v = dense(p["wv"], x).reshape(B, -1, n_kv, d_head)
    if qk_norm:
        q = rmsnorm(p["qn"], q)
        k = rmsnorm(p["kn"], k)
    q = shard(apply_rope(q, positions, rope_theta), head_spec(n_heads))
    k = shard(apply_rope(k, positions, rope_theta), head_spec(n_kv))
    return q, k, v


def gqa_apply(p, x, *, n_heads, n_kv, d_head, rope_theta=1e4, qk_norm=False,
              q_chunk=512):
    """Training/prefill self-attention. x: (B, S, d) -> (out, (k, v)),
    k and v (B, S, Hkv, dh): the prefill keeps them for the cache."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = gqa_project(p, x, n_heads, n_kv, d_head, positions,
                          rope_theta, qk_norm)
    out = causal_attention(q, k, v, q_chunk=q_chunk)
    return dense(p["wo"], out.reshape(B, S, n_heads * d_head)), (k, v)


def gqa_decode_cluster_major(p, x, cache_l, cur_pos: int, *, n_heads, n_kv,
                             d_head, rope_theta=1e4, qk_norm=False,
                             top_p: int = 16, mesh=None):
    """One-token decode against a cluster-major cache. cache_l: {"kt",
    "vt", "cent", "sizes", "ring_k", "ring_v", "ring_fill"}. Attention =
    top-p clusters + exact recent ring + self token; the fresh K/V is
    written into the ring's next slot and the fill count raised, in
    place; the tables are read-only. ``mesh``: the tables are this
    rank's clusters (:func:`cluster_major_decode_attention`). Returns
    (out, ring fields)."""
    B = x.shape[0]
    positions = torch.full((B, 1), cur_pos, device=x.device)
    q, k_new, v_new = gqa_project(p, x, n_heads, n_kv, d_head, positions,
                                  rope_theta, qk_norm)
    k1, v1 = k_new[:, 0], v_new[:, 0]                 # (B, n_kv, dh)
    ring_k, ring_v, fill = (cache_l["ring_k"], cache_l["ring_v"],
                            cache_l["ring_fill"])
    out = cluster_major_decode_attention(
        q[:, 0], cache_l["kt"], cache_l["vt"], cache_l["cent"],
        cache_l["sizes"], top_p, self_kv=(k1, v1), ring=(ring_k, ring_v, fill),
        mesh=mesh)
    slot = torch.remainder(fill, ring_k.shape[2]).reshape(1).long()
    ring_k.index_copy_(2, slot, k1[:, :, None].to(ring_k.dtype))
    ring_v.index_copy_(2, slot, v1[:, :, None].to(ring_v.dtype))
    fill.add_(1)
    return (dense(p["wo"], out.reshape(B, 1, n_heads * d_head)),
            {"ring_k": ring_k, "ring_v": ring_v, "ring_fill": fill})


def gqa_decode(p, x, cache_k, cache_v, cur_pos: int, *, n_heads, n_kv,
               d_head, rope_theta=1e4, qk_norm=False, clusters=None,
               top_p: int = 16):
    """One-token decode with a positional KV cache (B, n_kv, S, d_head):
    the new K/V is written at slot ``cur_pos`` in place and attention
    reads slots <= cur_pos. clusters: optional (centroids, members,
    member_mask) over the flat cache: k²-attention over the top-p
    clusters' members and the token itself. Returns (out (B, 1, d),
    cache_k, cache_v, k_new (B, n_kv, dh))."""
    B = x.shape[0]
    positions = torch.full((B, 1), cur_pos, device=x.device)
    q, k_new, v_new = gqa_project(p, x, n_heads, n_kv, d_head, positions,
                                  rope_theta, qk_norm)
    cache_k[:, :, cur_pos] = k_new[:, 0].to(cache_k.dtype)
    cache_v[:, :, cur_pos] = v_new[:, 0].to(cache_v.dtype)
    if clusters is None:
        out = decode_attention(q[:, 0], cache_k[:, :, :cur_pos + 1],
                               cache_v[:, :, :cur_pos + 1])
    else:
        centroids, members, member_mask = clusters
        out = clustered_decode_attention(
            q[:, 0], cache_k, cache_v, centroids, members, member_mask,
            top_p, self_kv=(k_new[:, 0], v_new[:, 0]))
    return (dense(p["wo"], out.reshape(B, 1, n_heads * d_head)),
            cache_k, cache_v, k_new[:, 0])


# --------------------------------------------------------------------------
# MLA (Multi-head Latent Attention, DeepSeek-V2): caches only the latent
# --------------------------------------------------------------------------

class MLADims(NamedTuple):
    kv_lora: int
    nope: int
    rope: int
    v_dim: int


def mla_init(gen: torch.Generator, d: int, n_heads: int, dims: MLADims,
             dtype=torch.bfloat16, new=None) -> dict:
    return {
        "wq": dense_init(gen, d, n_heads * (dims.nope + dims.rope), dtype,
                         new),
        "wdkv": dense_init(gen, d, dims.kv_lora, dtype, new),
        "wkpe": dense_init(gen, d, dims.rope, dtype, new),
        "wuk": dense_init(gen, dims.kv_lora, n_heads * dims.nope, dtype, new),
        "wuv": dense_init(gen, dims.kv_lora, n_heads * dims.v_dim, dtype,
                          new),
        "wo": dense_init(gen, n_heads * dims.v_dim, d, dtype, new),
        "kvn": rmsnorm_init(dims.kv_lora, dtype, gen.device, new),
    }


def _mla_project(p, x, positions, n_heads: int, dims: MLADims,
                 rope_theta: float):
    """Queries (q_nope, q_pe) (B, S, H, ·) and the latent [c_kv, k_pe]
    (B, S, r + rope) of x, the rope part rotated at ``positions``."""
    B, S, _ = x.shape
    q = dense(p["wq"], x).reshape(B, S, n_heads, dims.nope + dims.rope)
    q_pe = apply_rope(q[..., dims.nope:], positions, rope_theta)
    c_kv = rmsnorm(p["kvn"], dense(p["wdkv"], x))               # (B, S, r)
    k_pe = apply_rope(dense(p["wkpe"], x)[:, :, None], positions,
                      rope_theta)[:, :, 0]                      # (B, S, rope)
    return q[..., :dims.nope], q_pe, torch.cat([c_kv, k_pe], -1)


def mla_apply(p, x, *, n_heads: int, dims: MLADims, rope_theta=1e4,
              q_chunk=512):
    """Training/prefill MLA: keys and values are up-projected from the
    latent and attended as GQA with one query per kv-head (value head
    ``v_dim`` beside the query head ``nope + rope``). x: (B, S, d) ->
    (out, latent (B, S, r + rope)), the latent for the cache."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :]
    q_nope, q_pe, latent = _mla_project(p, x, positions, n_heads, dims,
                                        rope_theta)
    c_kv, k_pe = latent[..., :dims.kv_lora], latent[..., dims.kv_lora:]
    k_nope = dense(p["wuk"], c_kv).reshape(B, S, n_heads, dims.nope)
    v = dense(p["wuv"], c_kv).reshape(B, S, n_heads, dims.v_dim)
    kf = torch.cat([k_nope, k_pe[:, :, None].expand(B, S, n_heads,
                                                    dims.rope)], -1)
    out = causal_attention(torch.cat([q_nope, q_pe], -1), kf, v,
                           q_chunk=q_chunk)
    return dense(p["wo"], out.reshape(B, S, -1)), latent


def mla_decode(p, x, latent_cache, cur_pos: int, *, n_heads: int,
               dims: MLADims, rope_theta=1e4):
    """One-token MLA decode against the latent cache (B, S, r + rope):
    the token's latent is written at slot ``cur_pos`` in place, and the
    live slots <= cur_pos are read once in f32. Absorbed attention: the
    score is (q_nope W_uk^T) . c + q_pe . k_pe, one product of [q_abs,
    q_pe] with the latent rows, scaled by (nope + rope) ** -0.5; the
    context over the latent goes through W_uv in f32. Returns (out
    (B, 1, d), latent_cache)."""
    B = x.shape[0]
    r = dims.kv_lora
    positions = torch.full((B, 1), cur_pos, device=x.device)
    q_nope, q_pe, latent_new = _mla_project(p, x, positions, n_heads, dims,
                                            rope_theta)
    latent_cache[:, cur_pos] = latent_new[:, 0].to(latent_cache.dtype)
    live = latent_cache[:, :cur_pos + 1].float()           # (B, n, r + rope)
    wuk = p["wuk"]["w"].reshape(r, n_heads, dims.nope).float()
    q_abs = torch.einsum("bhn,rhn->bhr", q_nope[:, 0].float(), wuk)
    qc = torch.cat([q_abs, q_pe[:, 0].float()], -1)        # (B, H, r + rope)
    logits = torch.bmm(qc, live.transpose(1, 2)) * (dims.nope
                                                     + dims.rope) ** -0.5
    ctx = torch.bmm(_softmax(logits), live)[..., :r]          # (B, H, r)
    wuv = p["wuv"]["w"].reshape(r, n_heads, dims.v_dim).float()
    out = torch.einsum("bhr,rhv->bhv", ctx, wuv)
    out = out.to(x.dtype).reshape(B, 1, n_heads * dims.v_dim)
    return dense(p["wo"], out), latent_cache
