"""Carry a fitted state across packages: the reference's (JAX) centers
and assignment, its whole served model, or an LM's params and AdamW
state, read as numpy arrays, become the port's tensors, so both packages
can start from one state."""
from __future__ import annotations

import numpy as np
import torch


def from_reference(centers_np, assignment_np, *, device):
    """(k, d) centers and (n,) assignment (numpy) -> (f32, int32) tensors
    on ``device``."""
    c = torch.tensor(np.asarray(centers_np, np.float32), device=device)
    a = torch.tensor(np.asarray(assignment_np, np.int32), device=device)
    return c, a


def model_from_reference(model, *, device):
    """The reference's ``KMeansModel`` -> the port's, on ``device``.

    Reads every array through ``numpy.asarray`` (so this module imports
    nothing of the reference): centers, graph and ``nb_dist``, the five
    ``Router`` fields, sums and counts, the arena's slot arrays, the
    insertion-order mirrors with the epoch clock ``e_pts``, the motion
    clock ``c_motion``, the drift guard's EWMA state when it has one, and
    the static config and stream counters."""
    from .core.engine import ResidentState
    from .core.model import KMeansModel, Router
    from .ft.invariants import DriftGuard

    def t(v, dtype=torch.float32):
        return torch.tensor(np.asarray(v), dtype=dtype, device=device)

    i32 = torch.int32
    st = model.state
    state = ResidentState(
        c=t(st.c), prev_nb=t(st.prev_nb, i32), sums=t(st.sums),
        counts=t(st.counts), it=int(np.asarray(st.it)),
        first=bool(np.asarray(st.first)), xg=t(st.xg), pid=t(st.pid, i32),
        ug=t(st.ug), lo_g=t(st.lo_g), wg=t(st.wg), b2c=t(st.b2c, i32),
        fill=t(st.fill, i32), openb=t(st.openb, i32))
    rt = model.router
    router = Router(t(rt.gc), t(rt.members, i32), t(rt.mdist),
                    t(rt.mowner, i32), t(rt.modist))
    dg = model._dg
    if dg is not None:
        dg = DriftGuard(t(dg.cnt_ewma), t(dg.en_ewma), int(np.asarray(dg.it)))
    return KMeansModel(
        state=state, router=router, nb_dist=t(model.nb_dist),
        x_pts=t(model.x_pts), a_pts=t(model.a_pts, i32), w_pts=t(model.w_pts),
        kn=model.kn, bn=model.bn,
        backend="kernels" if model.backend == "pallas" else model.backend,
        bkn=model.bkn,
        route_probes=model.route_probes, router_iters=model.router_iters,
        refresh_every=model.refresh_every, decay=model.decay,
        precision=model.precision, n_rows=model.n_rows,
        batches_seen=model.batches_seen,
        degraded_folds=model.degraded_folds, window=model.window,
        half_life=model.half_life, count_floor=model.count_floor,
        drift_guard=model.drift_guard, rows_streamed=model.rows_streamed,
        evicted_rows=model.evicted_rows,
        repaired_centers=model.repaired_centers,
        e_pts=t(model.e_pts, i32), c_motion=t(model.c_motion), _dg=dg)


def _tensor_from_numpy(v, device):
    """A numpy array (bfloat16 included, read through its bits) -> a
    tensor of the same type on ``device``."""
    a = np.array(v)                        # a writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def _tree(v, device):
    if isinstance(v, dict):
        return {k: _tree(x, device) for k, x in v.items()}
    return _tensor_from_numpy(v, device)


_LAYER_KEYS = {"ln1", "attn", "ln2", "mlp", "dense_mlp", "mix"}
_CROSS_KEYS = {"lnx", "xattn"}            # an audio config's decoder layers
_GQA_KEYS = {"wq", "wk", "wv", "wo", "qn", "kn"}
_MLA_KEYS = {"wq", "wdkv", "wkpe", "wuk", "wuv", "wo", "kvn"}
_MOE_KEYS = {"router", "wi", "wg", "wo", "shared"}
_MIX_KEYS = {"rwkv6": {"mu", "wr", "wk", "wv", "wg", "wo", "w0", "w1", "w2",
                       "u", "ln"},
             "mamba2": {"in_proj", "out_proj", "A_log", "D", "dt_bias", "ln"}}


def params_from_reference(params_np, cfg, *, device,
                          unembed_table: bool = True):
    """The reference's LM params (a nested dict of arrays, layers stacked
    on a leading axis) -> the port's, same paths and types, on
    ``device``, with the f32 copy of the embedding that ``unembed``
    reads when ``unembed_table`` (a training state goes without it).
    Every family: an MoE layer's router (f32), its stacked experts
    ``wi``/``wg``/``wo`` (L, E, d, f), its shared experts and Arctic's
    ``dense_mlp`` come across as they are, and so do MLA's attention
    keys, DeepSeek's dense ``prefix`` stack, an SSM layer's ``mix``
    (RWKV6's or Mamba2's keys, with their f32 ``w0``, ``u``, ``A_log``,
    ``D`` and ``dt_bias``), Zamba2's top-level ``shared`` block, and
    Whisper's encoder stack ``enc``, its ``enc_norm`` and its decoder
    layers' cross attention ``lnx``/``xattn``; any other key raises."""
    from .models.model import with_unembed_table
    from .models.transformer import FAMILIES
    audio = cfg.family == "audio"
    stack = params_np.get("stack", {})
    dense_parts = [params_np.get(k, {}) for k in ("prefix", "shared", "enc")]
    unknown = (set(params_np) - {"embed", "out_norm", "stack", "prefix",
                                 "shared"}
               - ({"enc", "enc_norm"} if audio else set())) \
        | (set(stack) - _LAYER_KEYS - (_CROSS_KEYS if audio else set())) \
        | (set(stack.get("attn", {})) - (_MLA_KEYS if cfg.mla
                                         else _GQA_KEYS)) \
        | (set(stack.get("xattn", {})) - _GQA_KEYS) \
        | (set(stack.get("mix", {})) - _MIX_KEYS.get(cfg.ssm, set()))
    for part in dense_parts:
        unknown |= (set(part) - _LAYER_KEYS) \
            | (set(part.get("attn", {})) - _GQA_KEYS)
    if cfg.moe:
        unknown |= set(stack.get("mlp", {})) - _MOE_KEYS
    if cfg.family not in FAMILIES or unknown:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r}, unknown keys "
            f"{sorted(unknown)}: the port carries the reference's families "
            f"{FAMILIES} and their keys; what ROADMAP §1 item 13 leaves is "
            f"its slice g (LM placement)")
    params = _tree(params_np, device)
    return with_unembed_table(params) if unembed_table else params


def opt_state_from_reference(opt_np, *, device):
    """The reference's AdamW state ({"m", "v"}: f32 trees of the params'
    paths, "step": an int32 scalar) -> the port's on ``device``, same
    paths and types."""
    return {"m": _tree(opt_np["m"], device), "v": _tree(opt_np["v"], device),
            "step": torch.tensor(int(np.asarray(opt_np["step"])),
                                 dtype=torch.int32, device=device)}


def cache_from_reference(cache_np, *, device):
    """The reference's decode cache, flat (``k``, ``v``, with member
    lists ``cent``, ``mem``, ``mmask``, ``sizes`` or without; an audio
    config's cross-attention ``xk``, ``xv`` beside them), MLA's
    latent ``lat``, an SSM layer's ``state`` and ``xprev``, the dense
    ``prefix``'s, Zamba2's ``shared`` block's (flat or cluster-major,
    over its applications), or cluster-major (``kt``, ``vt``, ``cent``,
    ``sizes``, ring), as nested dicts of arrays -> the port's tensors on
    ``device``, same fields and types."""
    return _tree(cache_np, device)
