"""The dry run (port of ``repro.launch.dryrun``): every (arch x shape x
mesh) cell placed and counted on meta tensors and stand-in meshes, with
no card and no process group.

The reference compiles each cell on 512 forced host devices and reads
XLA's cost and memory analyses and the collectives of the compiled HLO
(``collective_bytes``). The port has no compiled program to read, so it
counts from shapes and placements instead. For each cell
(:func:`run_cell`) it gives:
- each device's bytes of params, optimizer state, cache and batch under
  the specs of ``launch.sharding`` (the reference's, spec for spec) on
  the reference's production mesh (16 x 16 ("data", "model"), or 2 x 16
  x 16 with "pod"), with FSDP as the reference's ``fsdp`` rule says;
- the step's operations (:func:`step_flops`): the matrix products from
  the shapes, in bf16 and in f32 (attention's scores, the unembedding),
  the backward's two products a product in a train step;
- the bytes each rank sends a step under the placement the port
  executes, on a data-only mesh of the cell's data size
  (:func:`zero_step_bytes` for a train step, :func:`decode_merge_bytes`
  for a clustered decode step; a prefill runs replicated and sends
  nothing);
- compute, memory and collective terms at an H100's data-sheet figures
  (989 TFLOP/s bf16, 67 TFLOP/s f32, 3.35 TB/s, NVLink 450 GB/s each
  way), the operations split evenly over the chips and the memory term
  one read of each device's bytes. The TPU v5e constants of the
  reference are not carried over.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \
        --shape all --both-meshes
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch

from ..configs.base import ARCH_IDS, SHAPES, get_config
from ..models.model import cache_shapes, n_shared_apps, param_shapes
from ..optim import init_opt_shapes, tree_leaves
from . import sharding as shr
from .mesh import MeshShape, dp_size, make_production_mesh

# one H100 SXM (NVIDIA's data sheet, dense rates)
PEAK_FLOPS_BF16 = 989e12
PEAK_FLOPS_F32 = 67e12
HBM_BW = 3.35e12
NVLINK_BW = 450e9               # bytes/s each way, all to all


def _meta(tree):
    """A tree of (shape, dtype) pairs as meta tensors."""
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    shape, dtype = tree
    return torch.empty(shape, dtype=dtype, device="meta")


def clustered_decode(cfg, S: int) -> bool:
    """The reference's rule: k²-attention from ``long_context_threshold``
    on, never for an SSM config (a hybrid keeps its flat cache)."""
    return S >= cfg.long_context_threshold and not cfg.ssm


def input_specs(cfg, shape_name: str) -> dict:
    """Meta tensors for every model input of the cell, the reference's
    ``ShapeDtypeStruct``s: a train or prefill cell's batch (tokens,
    labels; an audio config's frames, a VLM's patches), a decode cell's
    cache (clustered as :func:`clustered_decode` says), tokens and
    position."""
    sh = SHAPES[shape_name]
    B, S = sh["global_batch"], sh["seq_len"]
    i32 = torch.int32
    if sh["kind"] in ("train", "prefill"):
        batch = {"tokens": ((B, S), i32), "labels": ((B, S), i32)}
        if cfg.family == "audio":
            batch["frames"] = ((B, S, cfg.d_model), torch.bfloat16)
        if cfg.n_patches:
            batch["patches"] = ((B, cfg.n_patches, cfg.d_model),
                                torch.bfloat16)
        return _meta(batch)
    return _meta({"cache": cache_shapes(cfg, B, S,
                                        clustered=clustered_decode(cfg, S)),
                  "tokens": ((B, 1), i32), "pos": ((), i32)})


def _pairs(S: int, q_chunk: int, causal: bool = True) -> int:
    """(query, key) pairs the chunked attention scores: each query chunk
    against the keys up to its last query (causal) or all S."""
    return sum((min(S, lo + q_chunk) - lo) * (min(S, lo + q_chunk)
                                              if causal else S)
               for lo in range(0, S, q_chunk))


def _attn_params(cfg) -> int:
    d = cfg.d_model
    return d * cfg.d_q + 2 * d * cfg.n_kv_heads * cfg.d_head + cfg.d_q * d


def step_flops(cfg, kind: str, B: int, S: int, q_chunk: int = 512,
               clustered: bool | None = None) -> dict:
    """One step's operations from the shapes: {"bf16", "f32",
    "unembed", "total"}. The matrix products over the per-token active
    params (``active_params_estimate`` less the embedding; a hybrid's
    shared block once an application, an audio decoder's cross
    attention, its encoder over S frames) in bf16; attention's scores in
    f32 and its value product in bf16 (each query chunk against the keys
    up to its last query; MLA at its score and value widths; the
    k²-attention decode over kc centroids and top_p·cap rows); the
    unembedding in f32, at every position in a train step and the last in
    a prefill. A train step counts 3 products a product (the forward and
    the backward's two); the recomputation under remat "dots" repeats
    none. The SSM scans' own operations are not counted. A dense GQA
    config's count is the product-by-product one that ``chip_smoke.py``'s
    training phase prints."""
    d, V, L = cfg.d_model, cfg.vocab, cfg.n_layers
    H = cfg.n_heads
    if clustered is None:
        clustered = kind == "decode" and clustered_decode(cfg, S)
    if cfg.ssm and cfg.attn_every:
        napps = n_shared_apps(cfg)
        mm = L * cfg._mamba2_params() + napps * (_attn_params(cfg)
                                                 + 3 * d * cfg.d_ff)
        n_attn = napps
    elif cfg.ssm:
        mm, n_attn = cfg.params_estimate() - V * d, 0
    else:
        mm, n_attn = cfg.active_params_estimate() - V * d, L
        if cfg.family == "audio":       # the encoder runs over the frames
            mm -= cfg.encoder_layers * (_attn_params(cfg) + 3 * d * cfg.d_ff)
            mm += L * _attn_params(cfg)             # the cross attention
    if cfg.mla:
        dk, dv = cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim
    else:
        dk = dv = cfg.d_head
    if kind == "decode":
        T = B
        if cfg.mla:         # absorbed: scores and context over the latent
            dk = dv = cfg.kv_lora + cfg.qk_rope_dim
        if clustered and not cfg.mla:
            rows = cfg.kv_clusters + cfg.cluster_top_p * cfg.cluster_cap
            att_s = 2 * B * H * rows * dk
            att_v = 2 * B * H * cfg.cluster_top_p * cfg.cluster_cap * dv
        else:
            att_s, att_v = 2 * B * H * S * dk, 2 * B * H * S * dv
        if cfg.family == "audio":
            att_s, att_v = att_s + 2 * B * H * 1500 * dk, \
                att_v + 2 * B * H * 1500 * dv
        un = 2 * B * d * V
        bf16 = 2 * T * mm + n_attn * att_v
        f32 = n_attn * att_s + un
        return {"bf16": bf16, "f32": f32, "unembed": un,
                "total": bf16 + f32}
    T = B * S
    pairs = _pairs(S, q_chunk)
    att_s, att_v = 2 * B * H * pairs * dk, 2 * B * H * pairs * dv
    enc = 0
    if cfg.family == "audio":
        full = _pairs(S, q_chunk, causal=False)
        att_s += 2 * B * H * full * dk         # the cross attention
        att_v += 2 * B * H * full * dv
        enc_mm = cfg.encoder_layers * (_attn_params(cfg) + 3 * d * cfg.d_ff)
        enc = 2 * T * enc_mm + cfg.encoder_layers * 2 * 2 * B * H * full * dk
    un = 2 * (T if kind == "train" else B) * d * V
    bf16 = 2 * T * mm + n_attn * att_v + enc
    f32 = n_attn * att_s + un
    mult = 3 if kind == "train" else 1
    return {"bf16": mult * bf16, "f32": mult * f32, "unembed": mult * un,
            "total": mult * (bf16 + f32)}


def train_flops(cfg, B: int, S: int, q_chunk: int = 512) -> dict:
    """A training step's operations (:func:`step_flops`)."""
    return step_flops(cfg, "train", B, S, q_chunk)


def zero_step_bytes(cfg, P: int, params_shape=None) -> int:
    """The bytes each rank hands to the collectives of one ZeRO-1 train
    step (``launch.train.make_train_step(mesh=)``) on a data-only mesh
    of P ranks: each leaf that ``opt_specs`` splits its gradient's
    reduce-scatter input (the whole leaf) and its updated param block's
    gather; the leaves it keeps whole in one ``Mesh.sum``; one gather of
    the leaves' sums of squares and the loss (f32). ``params_shape``: the
    params' tree (their types; ``param_shapes(cfg)``, bf16, by default)."""
    if P <= 1:
        return 0
    mesh = MeshShape({"data": P})
    ps = params_shape if params_shape is not None else param_shapes(cfg)
    specs = shr.opt_specs(cfg, ps, mesh)["m"]
    total, n = 0, 0
    for t, s in zip(tree_leaves(ps), tree_leaves(specs)):
        nbytes = t.numel() * t.element_size()
        split = "data" in s
        total += nbytes + (nbytes // P if split else 0)
        n += 1
    return total + 4 * (n + 1)


def decode_merge_bytes(cfg, B: int, P: int,
                       n_layers: int | None = None) -> int:
    """The bytes each rank hands to the sharded k²-attention's merge a
    decoded token: one gather of (m, l, acc), B·H·(dh + 2) f32, a
    clustered attention layer (0 when P does not divide kc)."""
    if P <= 1 or cfg.kv_clusters % P:
        return 0
    L = n_layers if n_layers is not None else (
        n_shared_apps(cfg) if cfg.attn_every else cfg.n_layers)
    return L * B * cfg.n_heads * (cfg.d_head + 2) * 4


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             remat: str = "dots", q_chunk: int = 512, fsdp="auto",
             verbose: bool = True) -> dict:
    """One cell's record: per-device bytes under the specs, the step's
    operations, the port's collective bytes a rank and the roofline
    terms (the module's docstring). ``fsdp="auto"``: the reference's
    rule, FSDP off for a prefill whose bf16 weights over the TP axis fit
    12 GB."""
    t0 = time.time()
    cfg = get_config(arch)
    sh = SHAPES[shape_name]
    kind, B, S = sh["kind"], sh["global_batch"], sh["seq_len"]
    mesh = make_production_mesh(multi_pod=multi_pod)
    chips, dsz = mesh.size, dp_size(mesh)
    if fsdp == "auto":
        fits = cfg.params_estimate() * 2 / mesh.shape["model"] < 12e9
        fsdp = not (kind == "prefill" and fits)
    ps = param_shapes(cfg)
    per = {"params": shr.local_bytes(ps, shr.param_specs(
        cfg, ps, mesh, fsdp=fsdp), mesh), "opt": 0, "cache": 0, "batch": 0}
    inputs = input_specs(cfg, shape_name)
    if kind == "decode":
        per["cache"] = shr.local_bytes(inputs["cache"], shr.cache_specs(
            cfg, inputs["cache"], mesh, B), mesh)
        per["batch"] = sum(inputs[k].numel() * inputs[k].element_size()
                           for k in ("tokens", "pos"))      # replicated
        clustered = clustered_decode(cfg, S) and not cfg.mla
        coll = decode_merge_bytes(cfg, B, dsz) if clustered else 0
    else:
        per["batch"] = shr.local_bytes(inputs, shr.batch_specs(
            cfg, mesh, kind), mesh)
        coll = zero_step_bytes(cfg, dsz) if kind == "train" else 0
    if kind == "train":
        per["opt"] = shr.local_bytes(init_opt_shapes(ps), shr.opt_specs(
            cfg, ps, mesh), mesh)
    fl = step_flops(cfg, kind, B, S, q_chunk)
    t_compute = (fl["bf16"] / PEAK_FLOPS_BF16 + fl["f32"] / PEAK_FLOPS_F32) \
        / chips
    t_memory = sum(per.values()) / HBM_BW
    t_coll = coll / NVLINK_BW
    rec = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16", "chips": chips,
        "kind": kind, "bytes_per_device": per,
        "flops_global": fl["total"], "flops_bf16": fl["bf16"],
        "flops_f32": fl["f32"], "flops_per_device": fl["total"] / chips,
        "collective_bytes_per_rank": coll,
        "collective_mesh": f"data={dsz}",
        "t_compute_s": t_compute, "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "bottleneck": max([("compute", t_compute), ("memory", t_memory),
                           ("collective", t_coll)], key=lambda kv: kv[1])[0],
        "fsdp": fsdp, "remat": remat, "q_chunk": q_chunk,
        "dryrun_s": round(time.time() - t0, 3),
    }
    if verbose:
        print(json.dumps(rec))
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--remat", default="dots",
                    help="recorded: the operation count is the same under "
                         "every policy")
    ap.add_argument("--q-chunk", type=int, default=512)
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--fsdp-auto", action="store_true",
                    help="train: FSDP on; inference: off when weights fit")
    ap.add_argument("--out", default=os.path.join("build", "dryrun.jsonl"))
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    ok = fail = 0
    with open(args.out, "a") as f:
        for arch in archs:
            for shape in shapes:
                for mp in meshes:
                    try:
                        rec = run_cell(arch, shape, multi_pod=mp,
                                       remat=args.remat,
                                       q_chunk=args.q_chunk,
                                       fsdp=("auto" if args.fsdp_auto
                                             else not args.no_fsdp))
                        f.write(json.dumps(rec) + "\n")
                        ok += 1
                    except Exception:    # one cell's failure, reported
                        fail += 1
                        print(f"FAIL {arch} {shape} multi_pod={mp}")
                        traceback.print_exc()
    print(f"dry-run cells: {ok} ok, {fail} failed")
    return 1 if fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
