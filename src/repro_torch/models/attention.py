"""GQA attention with cluster-major k²-attention decode (port of the GQA
part of ``repro.models.attention``).

Prefill attention is query-chunked, so no (S, S) logit tensor is ever
held; a chunk's logits are (B, Hkv, g, qc, S) f32 at most. Under the
causal mask the keys after a chunk's last query get weight exactly 0,
so each chunk reads only the keys up to its last query (the reference
masks them), and one-token decode reads only the filled slots of the
flat cache (the reference masks the rest).

k²-attention decode over the cluster-major cache selects each q-head's
top-p clusters (``kernels.cluster_attend.select_clusters``, the
reference's ``_select_top_clusters`` turned into table row ids; ties to
the lower cluster id, as ``lax.top_k``), then K6
(``kernels.cluster_attend``) gives the online-softmax state over those
blocks, where the reference computes the same state in jnp
(``_cm_partial``); the recent-token ring and the token being decoded are
merged into it in plain torch, exactly as the reference merges them.
The reference's ``shard_map`` branch (cluster shards over a mesh), MLA
and the flat-cache clustered variant (``clustered_decode_attention``)
wait for ROADMAP §1 item 13.

Decode writes the caches in place (the flat cache's slot ``cur_pos``;
the ring's next slot and its fill count), where the reference returns
new arrays: the tables are never copied.
"""
from __future__ import annotations

import torch

from ..kernels.cluster_attend import cluster_attend_partial, select_clusters
from .layers import apply_rope, dense, dense_init, rmsnorm, rmsnorm_init, scale


def _softmax(logits: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` over the last axis, in place: exp(x - max) /
    sum."""
    logits.sub_(torch.amax(logits, dim=-1, keepdim=True)).exp_()
    return logits.div_(torch.sum(logits, dim=-1, keepdim=True))


# --------------------------------------------------------------------------
# chunked causal attention core
# --------------------------------------------------------------------------

def causal_attention(q, k, v, *, q_chunk: int = 512) -> torch.Tensor:
    """q: (B, S, H, dh); k, v: (B, S, Hkv, dh) -> (B, S, H, dh).

    Grouped-query: H = g * Hkv. Logits in f32 from the bf16-scaled
    queries, softmax weights cast to v's type for the value product, as
    the reference. A last chunk shorter than ``q_chunk`` is allowed (the
    reference asserts S % q_chunk == 0)."""
    B, S, H, dh = q.shape
    Hkv = k.shape[2]
    g = H // Hkv
    qr = scale(q, dh ** -0.5).reshape(B, S, Hkv, g, dh)
    kt = k.float().permute(0, 2, 3, 1)                 # (B, Hkv, dh, S)
    vr = v.permute(0, 2, 1, 3)                         # (B, Hkv, S, dh)
    out = torch.empty((B, S, Hkv, g, v.shape[-1]), dtype=v.dtype,
                      device=q.device)
    for lo in range(0, S, q_chunk):
        ke = min(S, lo + q_chunk)          # keys up to the chunk's last query
        n = ke - lo
        qb = qr[:, lo:ke].float().permute(0, 2, 3, 1, 4)   # (B,Hkv,g,n,dh)
        logits = torch.matmul(qb.reshape(B, Hkv, g * n, dh), kt[..., :ke])
        pos = torch.arange(lo, ke, device=q.device)
        late = pos[:, None] < pos[None, :]                 # (n, n)
        logits.view(B, Hkv, g, n, ke)[..., lo:].masked_fill_(late,
                                                             -torch.inf)
        w = _softmax(logits).to(v.dtype)
        o = torch.matmul(w, vr[:, :, :ke])                 # (B,Hkv,g*n,dh)
        out[:, lo:ke] = o.reshape(B, Hkv, g, n, -1).permute(0, 3, 1, 2, 4)
        del logits, w, o           # before the next chunk's are allocated
    return out.reshape(B, S, H, v.shape[-1])


def decode_attention(q, k, v) -> torch.Tensor:
    """One-token decode: q (B, H, dh) against every slot of k/v in the
    decode-native layout (B, Hkv, S, dh) (the caller passes the live
    slots; the reference masks the others)."""
    B, H, dh = q.shape
    Hkv = k.shape[1]
    g = H // Hkv
    qr = scale(q.reshape(B, Hkv, g, dh), dh ** -0.5)
    w = _softmax(torch.einsum("bhgd,bhsd->bhgs", qr.float(), k.float()))
    out = torch.einsum("bhgs,bhsd->bhgd", w.to(v.dtype), v)
    return out.reshape(B, H, dh)


# --------------------------------------------------------------------------
# k²-attention over the cluster-major cache
# --------------------------------------------------------------------------

def cluster_major_decode_attention(q, kt, vt, centroids, sizes, top_p: int,
                                   self_kv=None, ring=None) -> torch.Tensor:
    """k²-attention over the cluster-major KV cache.

    q: (B, H, dh); kt/vt: (B, Hkv, kc, cap, dh) contiguous, the cache
    sorted by k²-means cluster; centroids: (B, Hkv, kc, dh); sizes:
    (B, Hkv, kc) int32. ring: optional (ring_k, ring_v, fill), the exact
    recent-token buffer ((B, Hkv, R, dh) x2 and a 0-d fill count);
    self_kv: optional (k_new, v_new), each (B, Hkv, dh), the token being
    decoded, which joins the softmax exactly. One K6 launch per call."""
    B, H, dh = q.shape
    Hkv, kc, cap = centroids.shape[1], centroids.shape[2], kt.shape[3]
    g = H // Hkv
    qr = q.reshape(B, Hkv, g, dh)
    m, l, acc = cluster_attend_partial(
        qr.reshape(B * H, dh), kt.reshape(B * Hkv * kc, cap, dh),
        vt.reshape(B * Hkv * kc, cap, dh),
        select_clusters(q, centroids, top_p), sizes=sizes.reshape(-1))
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
    return (apply_rope(q, positions, rope_theta),
            apply_rope(k, positions, rope_theta), v)


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
                             top_p: int = 16):
    """One-token decode against a cluster-major cache. cache_l: {"kt",
    "vt", "cent", "sizes", "ring_k", "ring_v", "ring_fill"}. Attention =
    top-p clusters + exact recent ring + self token; the fresh K/V is
    written into the ring's next slot and the fill count raised, in
    place; the tables are read-only. Returns (out, ring fields)."""
    B = x.shape[0]
    positions = torch.full((B, 1), cur_pos, device=x.device)
    q, k_new, v_new = gqa_project(p, x, n_heads, n_kv, d_head, positions,
                                  rope_theta, qk_norm)
    k1, v1 = k_new[:, 0], v_new[:, 0]                 # (B, n_kv, dh)
    ring_k, ring_v, fill = (cache_l["ring_k"], cache_l["ring_v"],
                            cache_l["ring_fill"])
    out = cluster_major_decode_attention(
        q[:, 0], cache_l["kt"], cache_l["vt"], cache_l["cent"],
        cache_l["sizes"], top_p, self_kv=(k1, v1), ring=(ring_k, ring_v, fill))
    slot = torch.remainder(fill, ring_k.shape[2]).reshape(1).long()
    ring_k.index_copy_(2, slot, k1[:, :, None].to(ring_k.dtype))
    ring_v.index_copy_(2, slot, v1[:, :, None].to(ring_v.dtype))
    fill.add_(1)
    return (dense(p["wo"], out.reshape(B, 1, n_heads * d_head)),
            {"ring_k": ring_k, "ring_v": ring_v, "ring_fill": fill})


def gqa_decode(p, x, cache_k, cache_v, cur_pos: int, *, n_heads, n_kv,
               d_head, rope_theta=1e4, qk_norm=False):
    """One-token decode with a positional KV cache (B, n_kv, S, d_head):
    the new K/V is written at slot ``cur_pos`` in place and attention
    reads slots <= cur_pos. Returns (out (B, 1, d), cache_k, cache_v,
    k_new (B, n_kv, dh))."""
    B = x.shape[0]
    positions = torch.full((B, 1), cur_pos, device=x.device)
    q, k_new, v_new = gqa_project(p, x, n_heads, n_kv, d_head, positions,
                                  rope_theta, qk_norm)
    cache_k[:, :, cur_pos] = k_new[:, 0].to(cache_k.dtype)
    cache_v[:, :, cur_pos] = v_new[:, 0].to(cache_v.dtype)
    out = decode_attention(q[:, 0], cache_k[:, :, :cur_pos + 1],
                           cache_v[:, :, :cur_pos + 1])
    return (dense(p["wo"], out.reshape(B, 1, n_heads * d_head)),
            cache_k, cache_v, k_new[:, 0])
