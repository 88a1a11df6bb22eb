"""Rank programs of the LM placement tests (``test_torch_lm_mesh.py``):
each runs on every rank of a ``launch.mesh.run_local`` world, imports
only the port, and returns numpy arrays and plain values."""
import dataclasses

import torch

from repro_torch.configs.base import get_smoke_config
from repro_torch.launch import serve, train
from repro_torch.launch.sharding import P, Sharded
from repro_torch.models.attention import cluster_major_decode_attention
from repro_torch.models.model import init_cache, init_params, serve_step
from repro_torch.optim import tree_leaves, tree_map

ARCH = "qwen3-8b"
B, PROMPT, DECODE = 2, 40, 4              # the model-level decode
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 16, 3   # global batch, 1 a rank


def zero_config():
    """The smoke config with its vocab raised to 16,384, so the tied
    embedding (16,384 x 128 = 2^21 elements) reaches the FSDP threshold:
    its moments split over the ranks (d_model over "data") and its
    gradient is reduce-scattered, the other leaves stay whole."""
    return dataclasses.replace(get_smoke_config(ARCH), vocab=16384)


def _np(t):
    return t.detach().float().cpu().numpy()


def f32_model(cfg):
    """Seed-0 params in f32 (the serving copy included) and a prompt."""
    gen = torch.Generator().manual_seed(0)
    params = tree_map(lambda t: t.float(), init_params(cfg, gen,
                                                       device="cpu"))
    prompt = torch.randint(0, cfg.vocab, (B, PROMPT), generator=gen,
                           dtype=torch.int32)
    return params, prompt


def f32_cache(cfg, params, prompt, mesh=None):
    """The prompt prefilled into an f32 flat cache, then clustered (this
    rank's clusters under ``mesh``)."""
    cache = init_cache(cfg, B, PROMPT + DECODE + 1, clustered=False,
                       device="cpu")
    cache = tree_map(lambda t: t.float() if t.is_floating_point() else t,
                     cache)
    _, cache = serve.prefill_into_cache(cfg, params, cache, prompt)
    return serve.attach_clusters(cfg, cache, length=PROMPT, mesh=mesh)


def decode_steps(cfg, params, cache, tokens, mesh=None):
    """``serve_step`` teacher-forced over ``tokens`` (steps, B): each
    step's logits."""
    out = []
    for i, tok in enumerate(tokens):
        logits, cache = serve_step(cfg, params, cache,
                                   torch.as_tensor(tok)[:, None], PROMPT + i,
                                   device="cpu", mesh=mesh)
        out.append(_np(logits))
    return out


def zero_run(cfg, mesh, compress):
    """TRAIN_STEPS ZeRO steps from seed-0 params cast to f32: each step's
    (loss, gradient norm), the final params by path, and this rank's
    bytes sent a step."""
    params, opt = train.init_state(cfg, seed=0, device="cpu", mesh=mesh)
    state = (tree_map(lambda t: t.float(), params), opt)
    batcher = train.batcher_for(cfg, TRAIN_BATCH, TRAIN_SEQ, mesh=mesh)
    step = train.make_train_step(cfg, q_chunk=TRAIN_SEQ, compress=compress,
                                 mesh=mesh)
    hist, sent = [], []
    for s in range(TRAIN_STEPS):
        before = mesh.sent_bytes
        state, m = step(state, batcher.batch_at(s))
        sent.append(mesh.sent_bytes - before)
        hist.append((float(m["loss"]), float(m["grad_norm"])))
    return {"hist": hist, "sent": sent,
            "params": [_np(t) for t in tree_leaves(state[0])],
            "m": [_np(t) for t in tree_leaves(state[1]["m"])]}


def _collectives(mesh):
    """reduce_scatter, max, gather_blocks and Sharded on small tensors
    made from the rank's index."""
    r = mesh.index
    t = torch.arange(32, dtype=torch.float32).reshape(4, 8) * (r + 1)
    x = torch.arange(16.).reshape(2, 8)
    sh = Sharded(P(None, "data"), mesh)
    return {"rs0": _np(mesh.reduce_scatter(t, dim=0)),
            "rs1": _np(mesh.reduce_scatter(t, dim=1)),
            "rs_bf16": _np(mesh.reduce_scatter(t.to(torch.bfloat16), dim=1)),
            "max": _np(mesh.max(torch.tensor([float(r), -float(r)]))),
            "blocks": _np(mesh.gather_blocks(torch.full((2, 3), float(r)),
                                             dim=1)),
            "placed": _np(sh.place(x)), "joined": _np(sh.gather(sh.place(x)))}


def lm_world(mesh, attn_inputs):
    """Every case of the four-rank world: the sharded attention on the
    rank's clusters of ``attn_inputs`` (twice), the model-level sharded
    decode of the smoke config in f32, the ZeRO step with and without
    compression (twice without), and the collectives."""
    out = {"index": mesh.index}
    a = attn_inputs
    kc = a["kt"].shape[2]
    lo, hi = mesh.index * kc // mesh.size, (mesh.index + 1) * kc // mesh.size
    T = torch.from_numpy
    runs = []
    for _ in range(2):
        before = mesh.sent_bytes
        o = cluster_major_decode_attention(
            T(a["q"]), T(a["kt"][:, :, lo:hi]).contiguous(),
            T(a["vt"][:, :, lo:hi]).contiguous(), T(a["cent"]),
            T(a["sizes"][:, :, lo:hi]).contiguous(), int(a["top_p"]),
            self_kv=(T(a["k_new"]), T(a["v_new"])),
            ring=(T(a["ring_k"]), T(a["ring_v"]), T(a["fill"])), mesh=mesh)
        runs.append(_np(o))
        out["attn_sent"] = mesh.sent_bytes - before
    out["attn"] = runs

    cfg = get_smoke_config(ARCH)
    params, prompt = f32_model(cfg)
    cache = f32_cache(cfg, params, prompt, mesh)
    out["kt_shape"] = tuple(cache["stack"]["kt"].shape)
    before = mesh.sent_bytes
    out["decode"] = decode_steps(cfg, params, cache, a["tokens"], mesh)
    out["decode_sent"] = (mesh.sent_bytes - before) // len(a["tokens"])

    zc = zero_config()
    out["zero"] = [zero_run(zc, mesh, False), zero_run(zc, mesh, False)]
    out["zero_c"] = zero_run(zc, mesh, True)
    out["coll"] = _collectives(mesh)
    return out
