"""Serving loop: prefill -> k²-means KV clustering -> batched decode
(port of ``repro.launch.serve``).

CPU-scale demo:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \
        --smoke --device cpu
On a card (the default device), ``run`` takes any config, for example
Qwen3-8B's cut in depth with ``dataclasses.replace(cfg, n_layers=4)``
(as ``chip_smoke.py`` does). The MoE family (``--arch arctic-480b``)
runs through the same code: only the layers' MLP differs. An MLA config
(``--arch deepseek-v2-lite-16b``) caches the latent, which k²-attention
does not cluster: ``run`` prefills, decodes with full attention, says
so and stops, as the reference stops for attention-free SSMs (the
reference's own serve raises ``KeyError: 'k'`` in ``attach_clusters``).
An attention-free SSM config (``--arch rwkv6-3b``) decodes its recurrent
state and prints the reference's two lines. A hybrid (``--arch
zamba2-7b``) clusters its shared attention block's cache, one
cluster-major table set for each application of the block, and decodes
with k²-attention without folds (the reference's ``fold_ring`` reads
only the stack), so its decode may not outrun the ring; the reference's
own serve raises ``KeyError: 'k'`` there (ROADMAP §3 entry 25). A VLM
(``--arch internvl2-76b``) is a dense LLM whose prompt's first
``n_patches`` positions take patch embeddings, drawn from the run's
generator (the vision tower is stubbed), and serves as the dense family
does. Whisper (``--arch whisper-base``) encodes ``enc_len`` frames drawn
from the generator (the conv frontend is stubbed; 8 by default, as the
reference's serve sizes its cache), writes every decoder layer's cross
keys and values ``xk``/``xv`` into the cache, then prefills, clusters and
decodes its decoder's self-attention cache as the other families do;
the cross attention reads all enc_len slots at every step.

Two facts of the reference shape the audio path (ROADMAP §3 entry 26).
Its ``forward_prefill`` on an audio config runs the cross layers as plain
decoder layers: it never runs the encoder and skips every layer's
``lnx``/``xattn``, so it is no oracle for the audio prefill; the
reference's chunked encoder-decoder is ``encoder_layer_fwd`` then
``cross_layer_fwd``, and its stepped counterpart is ``serve_step``
through ``cross_layer_decode``, which reads ``xk``/``xv`` from the cache.
And its serve never fills that cross K/V cache (zeros at ``enc_len=8``),
so there its cross attention adds exactly 0. The port computes ``xk``/
``xv`` as ``cross_layer_fwd`` does, ``dense(xattn.wk|wv, enc_out)`` of
the normed encoder output, in the layout ``cross_layer_decode`` reads.

Compares full-attention decode with k²-attention (cluster-major KV)
decode and reports token agreement and the attention reads saved. The
clustered decode streams: decode steps append fresh K/V to the exact
recent-token ring (the tables are read-only in a step), and every
``--fold-every`` steps the loop folds the ring into the tables with
``kv_partial_fit``. Each decode step reads one thing back to the host,
the greedy token.

The clustered decode and fold loop rides the serving executor (DESIGN.md
§12): ``decode_step`` and ``fold_ring`` are registered ops submitted
through :meth:`repro_torch.serve.ServeExecutor.call`, so the KV workload
shares the bounded admission queue, the transient-retry envelope
(``ft.retry_transient``, budget ``--retries``; chaos ``fail_calls=
{"decode_step"|"fold_ring": ...}`` exercises it) and the counted-op
accounting of the predict/partial_fit traffic; the end-of-run lines
print the queue and the fault counters.

Under a mesh (``run(mesh=)``, ``--mesh data=4`` under
``torch.distributed.run``: one rank a card, NCCL), the cache is placed
as ``launch.sharding.cache_specs`` says and decoded by the reference's
``shard_map`` branch of the k²-attention. Every rank runs the prefill,
the full decode and the k²-means clustering of the keys (bit-identical
run to run, so every rank gets the same clusters), then packs only its
own kc / P clusters' tables (the whole tables of a layer are never
allocated on a rank); the centroids, the ring and the params stay
replicated. A clustered step merges the ranks' attention states with one
gather a layer (``attention.cluster_major_decode_attention``). The
reference never folds a sharded cache (its serve runs on one device), so
neither does the port: under a mesh ``fold_every`` must be 0 and the
decode stays within ``cluster_ring`` steps.

Difference from the reference: the prompt fills the cache from one
chunked prefill forward (the reference steps ``serve_step`` over the
prompt, which 65,536 tokens make too slow); an SSM layer's recurrence
runs there as one kernel launch (``kernels.ssm_scan``).
"""
from __future__ import annotations

import argparse
import time

import torch

from ..configs.base import get_config, get_smoke_config
from ..device import resolve
from ..kernels import _build
from .mesh import dp_size, mesh_from_env
from ..models.kv_cluster import (build_cluster_major, build_kv_clusters,
                                 kv_partial_fit)
from ..models.model import (encode, forward_prefill, init_cache,
                            init_params, serve_step)
from ..serve import ServeConfig, ServeExecutor


def _cache_sink(part: dict, S: int):
    """A prefill sink that writes a layer's cache fields into the stacked
    cache ``part`` at layer i: keys and values (B, S, Hkv, dh) into the
    flat cache (B, Hkv, S, dh) and MLA's latent (B, S, r + rope) at slots
    < S, an SSM layer's ``state`` and ``xprev`` whole."""
    def sink(i, fields):
        for f, t in fields.items():
            if f in ("k", "v"):
                part[f][i, :, :, :S] = t.transpose(1, 2)
            elif f == "lat":
                part[f][i, :, :S] = t
            else:
                part[f][i] = t
    return sink


def _shared_sink(part: dict, S: int):
    """A prefill sink that writes the shared block's keys and values
    (B, S, Hkv, dh) at application ``app`` into its flat cache ``part``
    (napps, B, Hkv, S, dh), at slots < S."""
    def sink(app, k, v):
        part["k"][app, :, :, :S] = k.transpose(1, 2)
        part["v"][app, :, :, :S] = v.transpose(1, 2)
    return sink


def prefill_into_cache(cfg, params, cache, tokens, *, q_chunk: int = 512,
                       frames=None, patches=None, cross=None):
    """Fill the cache's first S slots from the prompt (B, S) and return
    (logits after the prompt (B, vocab), cache): the contract of the
    reference's stepped prefill, from one chunked forward whose layers
    hand their cache fields to the cache (keys and values, MLA latents,
    an SSM layer's state and last input, the dense prefix's and the
    shared block's keys and values). In the MoE family each position's B
    tokens are routed as the reference's decode step routes them
    (``moe.moe_apply_stepped``: with B <= 8 no pair is dropped), not as
    one call over the B·S tokens of the chunked forward, whose capacity
    would drop pairs the stepped prefill keeps. A VLM's ``patches``
    (B, n_patches, d) take the first positions. An audio config encodes
    ``frames`` (B, enc_len, d) (or takes ``cross``, ``model.encode``'s
    keys and values), writes the cross keys and values into the cache's
    ``xk``/``xv`` and runs the decoder over them."""
    S = tokens.shape[1]
    prefix, shared = cache.get("prefix"), cache.get("shared")
    if cfg.family == "audio":
        st = cache["stack"]
        if cross is None:
            if frames is None:
                raise ValueError(f"{cfg.name}: an audio prefill needs "
                                 f"frames= (B, enc_len, d) or cross=")
            cross = encode(cfg, params, frames, q_chunk=q_chunk)[1]
        if cross["xk"].shape != st["xk"].shape:
            raise ValueError(f"{cfg.name}: cross keys "
                             f"{tuple(cross['xk'].shape)} for a cache of "
                             f"{tuple(st['xk'].shape)}: the frames must fill "
                             f"its enc_len")
        st["xk"].copy_(cross["xk"])
        st["xv"].copy_(cross["xv"])
        cross = {"xk": st["xk"], "xv": st["xv"]}   # as the decode reads them
    logits = forward_prefill(
        cfg, params, tokens, q_chunk=q_chunk,
        kv_sink=_cache_sink(cache["stack"], S),
        prefix_sink=_cache_sink(prefix, S) if prefix is not None else None,
        shared_sink=_shared_sink(shared, S) if shared is not None else None,
        moe_stepped=True, patches=patches, cross=cross)
    return logits, cache


def shard_clusters(cfg, mesh) -> tuple | None:
    """This rank's cluster range (lo, hi) under ``mesh`` (the cluster
    axis of ``cache_specs`` over the data axes), or None for the whole
    table: no mesh, or a data size that does not divide kc."""
    dsz = dp_size(mesh) if mesh is not None else 1
    if dsz <= 1 or cfg.kv_clusters % dsz:
        return None
    n = cfg.kv_clusters // dsz
    return mesh.index * n, (mesh.index + 1) * n


def _cluster_part(cfg, part: dict, length: int | None,
                  clusters=None) -> dict:
    """``part``'s flat k/v (L, B, Hkv, S, dh) repacked cluster-major, one
    slice of the leading axis at a time: a new dict without ``k``/``v``,
    with the member tables and an empty ring in the cache's type.
    ``clusters``: (lo, hi), the tables and sizes of those clusters only
    (the centroids of all)."""
    keys, vals = part["k"], part["v"]
    if length is not None:
        keys, vals = keys[:, :, :, :length], vals[:, :, :, :length]
    L, B, Hkv, _, dh = keys.shape
    kc, cap, R = cfg.kv_clusters, cfg.cluster_cap, cfg.cluster_ring
    n = kc if clusters is None else clusters[1] - clusters[0]
    dev = keys.device
    kt = torch.empty((L, B, Hkv, n, cap, dh), dtype=keys.dtype, device=dev)
    vt = torch.empty_like(kt)
    cent = torch.empty((L, B, Hkv, kc, dh), dtype=keys.dtype, device=dev)
    sizes = torch.empty((L, B, Hkv, n), dtype=torch.int32, device=dev)
    for i in range(L):
        _, _, cent[i], sizes[i] = build_cluster_major(
            keys[i], vals[i], kc, cap, out=(kt[i], vt[i]),
            clusters=clusters)
    new = {f: v for f, v in part.items() if f not in ("k", "v")}
    new.update(
        kt=kt, vt=vt, cent=cent, sizes=sizes,
        ring_k=torch.zeros((L, B, Hkv, R, dh), dtype=keys.dtype, device=dev),
        ring_v=torch.zeros((L, B, Hkv, R, dh), dtype=keys.dtype, device=dev),
        ring_fill=torch.zeros((L,), dtype=torch.int32, device=dev))
    return new


def attach_clusters(cfg, cache, length: int | None = None, mesh=None):
    """Run k²-means over the cached keys of every layer (one layer at a
    time) and repack the cache cluster-major: the flat K/V is replaced by
    the member tables, and an empty ring in the cache's type (bf16 in the
    model) is added. A hybrid's stack holds no keys: its shared block's
    cache is repacked instead, one application at a time, into the
    reference's clustered layout (a leading applications axis, a ring
    fill per application). ``length``: number of filled slots (unfilled
    zero rows must not be clustered). ``mesh``: pack this rank's
    clusters only (:func:`shard_clusters`)."""
    parts = [p for p in ("stack", "shared") if "k" in cache.get(p, {})]
    if not parts:
        raise ValueError(f"{cfg.name}: the cache holds no flat keys to "
                         f"cluster (fields {sorted(cache['stack'])})")
    new = dict(cache)
    for part in parts:
        new[part] = _cluster_part(cfg, cache[part], length,
                                  shard_clusters(cfg, mesh))
    return new


def attach_member_lists(cfg, cache, length: int | None = None):
    """Run k²-means over the cached keys of every layer (one layer at a
    time) and keep the clustering beside the flat cache as member lists,
    the structure of the flat-cache k²-attention variant: returns a new
    cache whose stack adds ``cent``, ``mem``, ``mmask`` and ``sizes`` and
    shares the flat ``k``/``v`` with ``cache``. ``length``: number of
    filled slots. Decode then attends to the top-p clusters' members and
    files each new token with ``kv_cluster.cluster_append``."""
    st = cache["stack"]
    keys = st["k"] if length is None else st["k"][:, :, :, :length]
    parts = [build_kv_clusters(keys[i], cfg.kv_clusters, cfg.cluster_cap)
             for i in range(keys.shape[0])]
    new = dict(cache)
    new["stack"] = dict(st, **{f: torch.stack([p[j] for p in parts])
                               for j, f in enumerate(("cent", "mem", "mmask",
                                                      "sizes"))})
    return new


def fold_ring(cache, counts):
    """Fold every layer's ring into its cluster-major tables with
    ``kv_partial_fit``, in place. ``counts`` (L, B, Hkv, kc) f32 is the
    per-center Sculley state carried by the serve loop. One host read
    (the ring fills). Returns (cache, counts, slots_folded): live ring
    slots summed over layers; each slot holds one K/V row per (batch, kv
    head)."""
    st = cache["stack"]
    R = st["ring_k"].shape[3]
    fills = torch.clamp(st["ring_fill"], max=R).tolist()
    for i, n in enumerate(fills):
        kv_partial_fit(st["kt"][i], st["vt"][i], st["cent"][i],
                       st["sizes"][i], counts[i], st["ring_k"][i],
                       st["ring_v"][i], st["ring_fill"][i], n_live=n)
    return cache, counts, sum(fills)


def serve_executor(cfg, params, retries: int = 3,
                   mesh=None) -> ServeExecutor:
    """A bare :class:`ServeExecutor` with the KV workload's two ops
    registered: ``decode_step`` (payload ``{"cache", "tok", "i"}`` ->
    ``(logits, cache)``, over this rank's clusters under ``mesh``) and
    ``fold_ring`` (``{"cache", "counts"}`` -> ``(cache, counts, slots
    folded)``)."""
    ex = ServeExecutor(config=ServeConfig(queue_bound=8, retries=retries))
    ex.register("decode_step", lambda p: serve_step(
        cfg, params, p["cache"], p["tok"], p["i"], mesh=mesh))
    ex.register("fold_ring", lambda p: fold_ring(p["cache"], p["counts"]))
    return ex


def _guarded(ex: ServeExecutor, op: str, payload):
    """``ex.call`` that raises unless the request was answered ``ok``."""
    resp = ex.call(op, payload)
    if not resp.ok:
        raise RuntimeError(f"{op} request {resp.rid}: {resp.status} "
                           f"({resp.reason})")
    return resp.result


def decode(cfg, params, cache, tok, start: int, n: int, *,
           fold_every: int = 0, counts=None, executor=None, mesh=None):
    """Greedy-decode ``n`` tokens after ``tok`` (B, 1), the first at slot
    ``start``. One host read per step (the token); with ``fold_every``,
    the ring folds into the tables every that many steps. With
    ``executor`` (:func:`serve_executor`) every step and fold is a
    request through its ``call``. ``mesh``: the cache's tables are this
    rank's clusters; no folds then (the reference never folds a sharded
    cache), so ``fold_every`` must be 0. Returns (tokens: list of (B,)
    int arrays, last logits, cache, counts, slots folded)."""
    if mesh is not None and fold_every:
        raise ValueError(f"decode: fold_every {fold_every} under a mesh: "
                         f"a sharded cache is not folded (ROADMAP §1 item "
                         f"16)")
    if executor is None:
        step = lambda c, t, i: serve_step(  # noqa: E731
            cfg, params, c, t, i, mesh=mesh)
        fold = fold_ring
    else:
        step = lambda c, t, i: _guarded(  # noqa: E731
            executor, "decode_step", {"cache": c, "tok": t, "i": i})
        fold = lambda c, n_: _guarded(  # noqa: E731
            executor, "fold_ring", {"cache": c, "counts": n_})
    toks, folded, logits = [], 0, None
    for i in range(n):
        logits, cache = step(cache, tok, start + i)
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
        toks.append(tok[:, 0].cpu().numpy())
        if fold_every and (i + 1) % fold_every == 0:
            cache, counts, f = fold(cache, counts)
            folded += f
    return toks, logits, cache, counts, folded


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(cfg, *, batch: int = 2, prompt_len: int = 48, decode_len: int = 16,
        fold_every: int = 0, device=None, seed: int = 0, retries: int = 3,
        enc_len: int = 8, echo=print, mesh=None) -> dict:
    """Prefill a random prompt, decode with full attention, cluster the
    cache, decode again with k²-attention through the serving executor
    (folding the ring every ``fold_every`` steps, default the ring size;
    ``retries`` transient failures absorbed a call) and report. Returns
    the measurements, the params, both caches and the executor. An MLA
    config stops after the full decode (two lines): its latent cache is
    not clustered, and the clustered fields are ``None``; so does an
    attention-free SSM config, with the reference's two lines. A hybrid
    clusters its shared block's cache and decodes without folds, so it
    raises when ``decode_len`` exceeds ``cluster_ring`` or ``fold_every``
    is set. A VLM's prompt takes patch rows (B, n_patches, d), normal
    draws times d^-0.5 (an embedding's scale), at its first positions;
    an audio config encodes ``enc_len`` frames (B, enc_len, d), standard
    normal draws, first (``t_encode``). Both are drawn from the run's
    generator after the prompt, in bf16. ``mesh``: every rank runs this
    with the same arguments on its own device (the mesh's); the tables
    are packed per rank (:func:`attach_clusters`) and the clustered
    decode is sharded, without folds."""
    if (cfg.attn_every or mesh is not None) and (
            decode_len > cfg.cluster_ring or fold_every):
        raise ValueError(
            f"{cfg.name}: decode_len {decode_len} (cluster_ring "
            f"{cfg.cluster_ring}), fold_every {fold_every}: "
            + ("a sharded cache is not folded (the reference never folds "
               "one)" if mesh is not None else "the shared block's ring is "
               "not folded (the reference's fold_ring reads only the "
               "stack)") + ", so a decode may not outrun the ring")
    dev = resolve(device) if mesh is None else mesh.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    params = init_params(cfg, gen, device=dev)
    _sync(dev)
    t_init = time.perf_counter() - t0
    S_total = prompt_len + decode_len + 1
    prompt = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=gen,
                           device=dev, dtype=torch.int32)
    frames = patches = cross = None
    d = cfg.d_model
    if cfg.family == "audio":
        frames = torch.randn((batch, enc_len, d), generator=gen, device=dev,
                             dtype=torch.float32).to(torch.bfloat16)
    elif cfg.n_patches:
        patches = (torch.randn((batch, cfg.n_patches, d), generator=gen,
                               device=dev, dtype=torch.float32)
                   * d ** -0.5).to(torch.bfloat16)

    # full-attention path
    cache = init_cache(cfg, batch, S_total, clustered=False, enc_len=enc_len,
                       device=dev)
    _sync(dev)
    t_encode = None
    if frames is not None:
        t0 = time.perf_counter()
        cross = encode(cfg, params, frames)[1]
        _sync(dev)
        t_encode = time.perf_counter() - t0
    t0 = time.perf_counter()
    prefill_logits, cache = prefill_into_cache(cfg, params, cache, prompt,
                                               patches=patches, cross=cross)
    del cross
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    t0 = time.perf_counter()
    full_toks, full_logits, cache, _, _ = decode(
        cfg, params, cache, prompt[:, -1:], prompt_len, decode_len)
    t_full = time.perf_counter() - t0
    recurrent = bool(cfg.ssm) and not cfg.attn_every
    if cfg.mla or recurrent:
        if recurrent:
            echo(f"{cfg.name}: attention-free — k²-attention inapplicable "
                 f"(native O(1) state); running plain decode")
            echo(f"decoded {decode_len} tokens in {t_full:.2f}s (recurrent)")
        else:
            echo(f"decoded {decode_len} tokens: full={t_full:.2f}s")
            echo(f"{cfg.name}: k²-attention does not apply to the MLA "
                 f"latent cache; decoded with full attention only")
        return dict(
            params=params, cache=None, flat_cache=cache, counts=None,
            prompt=prompt, frames=frames, patches=patches,
            prefill_logits=prefill_logits,
            full_logits=full_logits, clus_logits=None, full_toks=full_toks,
            clus_toks=None, t_init=t_init, t_encode=t_encode,
            t_prefill=t_prefill,
            t_attach=None, t_full=t_full, t_clus=None, t_clus_loop=None,
            agreement=None, folded=None, sizes0=None, sizes1=None,
            dropped=None, reads_full=S_total, reads_clus=None,
            launches=None, fold_every=None, executor=None)

    # k²-attention path: cluster the prefilled keys (the full decode wrote
    # only slots past the prompt), then decode against the clusters; a
    # hybrid's keys are its shared block's, and its ring is not folded
    part = "shared" if cfg.attn_every else "stack"
    t0 = time.perf_counter()
    cache2 = attach_clusters(cfg, cache, length=prompt_len, mesh=mesh)
    _sync(dev)
    t_attach = time.perf_counter() - t0
    counts = cache2[part]["sizes"].float()
    if not cfg.attn_every and mesh is None:
        fold_every = fold_every or cfg.cluster_ring
    sizes0 = int(torch.sum(cache2[part]["sizes"]))
    if mesh is not None:            # every rank's clusters
        sizes0 = int(mesh.sum(torch.tensor(sizes0, dtype=torch.int64,
                                           device=dev)))
    ex = serve_executor(cfg, params, retries, mesh=mesh)
    sent0 = mesh.sent_bytes if mesh is not None else 0
    before = _build.launches()
    t0 = time.perf_counter()
    clus_toks, clus_logits, cache2, counts, folded = decode(
        cfg, params, cache2, prompt[:, -1:], prompt_len, decode_len,
        fold_every=fold_every, counts=counts, executor=ex, mesh=mesh)
    t_loop = time.perf_counter() - t0
    if fold_every:
        cache2, counts, tail = _guarded(                   # drain the tail
            ex, "fold_ring", {"cache": cache2, "counts": counts})
        folded += tail
    _sync(dev)
    t_clus = time.perf_counter() - t0
    launched = {k: v - before[k] for k, v in _build.launches().items()}
    sizes1 = sizes0 if mesh is not None else int(torch.sum(
        cache2[part]["sizes"]))

    agree = float(sum((a == b).mean() for a, b in zip(full_toks, clus_toks))
                  / max(len(full_toks), 1))
    reads_full = S_total
    reads_clus = cfg.kv_clusters + cfg.cluster_top_p * cfg.cluster_cap
    n_layers = cache2[part]["ring_fill"].shape[0]
    echo(f"decoded {decode_len} tokens: full={t_full:.2f}s "
         f"clustered={t_clus:.2f}s  token agreement={agree:.2f}")
    if mesh is not None:
        echo(f"sharded k²-attention: kc {cfg.kv_clusters} over {mesh.size} "
             f"ranks, no folds ({sizes0} member rows); this rank sent "
             f"{mesh.sent_bytes - sent0} bytes in the clustered decode")
    elif fold_every:
        echo(f"partial_fit folds: {folded} ring slots "
             f"({folded // max(n_layers, 1)} tokens x {n_layers} "
             f"layers) absorbed into the cluster tables "
             f"({sizes1 - sizes0} member rows, {sizes0} -> {sizes1}), "
             f"fold every {fold_every} steps")
    else:
        echo(f"no folds: the {decode_len} decoded tokens stay in the ring "
             f"of each of the {n_layers} shared-block applications "
             f"({sizes0} member rows)")
    echo(f"attention reads/token: full={reads_full} "
         f"clustered={reads_clus} ({reads_full / reads_clus:.1f}x fewer)")
    # the queue and the healing counters: nothing the execution layer
    # absorbed stays invisible
    st = ex.stats()
    prof = ex.counter.profile()
    echo(f"serve queue: admitted={st['admitted']} "
         f"rejected={st['rejected']} "
         f"max_depth={st['max_queue_depth']}/{st['queue_bound']}")
    echo(f"ft counters: retries={int(prof['retries'])} "
         f"(budget {retries}/call) repairs={st['repairs']} "
         f"degraded_folds={st['degraded_folds']} "
         f"evicted_rows={st['evicted_rows']} "
         f"sanitized_rows={st['sanitized_rows']} "
         f"sheds={prof['degrades']['shed']}")
    return dict(
        params=params, cache=cache2, flat_cache=cache, counts=counts,
        prompt=prompt, frames=frames, patches=patches,
        prefill_logits=prefill_logits, full_logits=full_logits,
        clus_logits=clus_logits, full_toks=full_toks, clus_toks=clus_toks,
        t_init=t_init, t_encode=t_encode, t_prefill=t_prefill,
        t_attach=t_attach, t_full=t_full,
        t_clus=t_clus, t_clus_loop=t_loop, agreement=agree, folded=folded,
        sizes0=sizes0, sizes1=sizes1,
        dropped=prompt_len * batch * cfg.n_kv_heads * n_layers - sizes0,
        reads_full=reads_full, reads_clus=reads_clus, launches=launched,
        fold_every=fold_every, executor=ex)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--decode", type=int, default=16)
    ap.add_argument("--fold-every", type=int, default=0,
                    help="decode steps between partial_fit folds of the "
                         "ring into the cluster tables (0: the ring "
                         "size, i.e. fold just before it would wrap)")
    ap.add_argument("--retries", type=int, default=3,
                    help="transient-failure retry budget per decode/fold "
                         "call (ft.retry_transient)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--enc-len", type=int, default=8,
                    help="an audio config's encoder frames (the "
                         "reference's serve sizes its cross cache to 8)")
    ap.add_argument("--mesh", default=None,
                    help="e.g. data=4: under torch.distributed.run, one "
                         "rank a card (NCCL; gloo with --device cpu), the "
                         "cluster axis of the cache sharded")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    mesh = mesh_from_env(args.mesh, device=args.device) if args.mesh \
        else None
    try:
        run(cfg, batch=args.batch, prompt_len=args.prompt_len,
            decode_len=args.decode, fold_every=args.fold_every,
            device=args.device, retries=args.retries, enc_len=args.enc_len,
            mesh=mesh, echo=print if mesh is None or mesh.index == 0
            else (lambda *a: None))
    finally:
        if mesh is not None:
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
