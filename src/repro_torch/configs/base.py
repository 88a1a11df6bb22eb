"""Architecture config schema and registry (port of
``repro.configs.base``): the port's own copy of ``ArchConfig``, with its
fields and defaults as the reference has them, and the registry of the
architectures, one module each: every architecture of the reference is
ported, and the reference's shape cells ``SHAPES``."""
from __future__ import annotations

import dataclasses
import importlib


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 128
    qk_norm: bool = False
    rope_theta: float = 1e4
    # --- MoE ---
    moe: bool = False
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    dense_residual: bool = False
    first_dense: int = 0
    # --- MLA ---
    mla: bool = False
    kv_lora: int = 0
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    # --- SSM / hybrid ---
    ssm: str = ""
    ssm_state: int = 64
    ssm_expand: int = 2
    attn_every: int = 0
    # --- enc-dec (audio) ---
    encoder_layers: int = 0
    frontend_stub: bool = False
    # --- vlm ---
    n_patches: int = 0
    # --- k²-attention (clustered KV) defaults for long-context decode ---
    kv_clusters: int = 2048
    cluster_cap: int = 512
    cluster_top_p: int = 16
    cluster_ring: int = 256      # exact recent-token buffer (read-write)
    long_context_threshold: int = 65536   # S >= this -> clustered decode

    @property
    def d_q(self) -> int:
        return self.n_heads * self.d_head

    def params_estimate(self) -> float:
        """The reference's rough total param count: the embedding and
        ``n_layers`` layers of attention (GQA or MLA) and MLP (SwiGLU, or
        the MoE's routed and shared experts and dense residual), and an
        audio config's ``encoder_layers`` dense encoder layers; a pure
        SSM's mixers (RWKV6's six d x d matrices and its SwiGLU, or
        Mamba2's projections); a hybrid's Mamba2 mixers and one shared
        attention + MLP block. As the reference, it leaves out the
        routers, norms, RWKV6's decay LoRA and the decoder's cross
        attention, and counts a ``first_dense`` layer as the stack's."""
        d, L = self.d_model, self.n_layers
        emb = self.vocab * d
        if self.ssm and self.attn_every == 0:        # pure SSM
            if self.ssm == "rwkv6":
                mix = L * (6 * d * d)
            else:
                mix = L * self._mamba2_params()
            ffn = L * 3 * d * self.d_ff if self.ssm == "rwkv6" else 0
            return emb + mix + ffn
        attn = d * self.d_q + 2 * d * self.n_kv_heads * self.d_head \
            + self.d_q * d
        if self.mla:
            r = self.kv_lora
            attn = (d * self.n_heads * (self.qk_nope_dim + self.qk_rope_dim)
                    + d * r + d * self.qk_rope_dim
                    + r * self.n_heads * (self.qk_nope_dim + self.v_head_dim)
                    + self.n_heads * self.v_head_dim * d)
        if self.ssm and self.attn_every:         # hybrid: one shared block
            return emb + L * self._mamba2_params() + attn + 3 * d * self.d_ff
        if self.moe:
            ffn = 3 * d * self.moe_d_ff * (self.n_experts
                                           + self.n_shared_experts)
            if self.dense_residual:
                ffn += 3 * d * self.d_ff
        else:
            ffn = 3 * d * self.d_ff
        enc = self.encoder_layers * (attn + 3 * d * self.d_ff)
        return emb + L * (attn + ffn) + enc

    def active_params_estimate(self) -> float:
        """Active (per-token) params, the reference's: an MoE config
        counts top_k of its n_experts."""
        if not self.moe:
            return self.params_estimate()
        d, L = self.d_model, self.n_layers
        all_experts = L * 3 * d * self.moe_d_ff * self.n_experts
        active = L * 3 * d * self.moe_d_ff * self.top_k
        return self.params_estimate() - all_experts + active

    def _mamba2_params(self) -> int:
        """A Mamba2 mixer's in and out projections, as the reference
        counts them."""
        d = self.d_model
        d_in = self.ssm_expand * d
        return d * (2 * d_in + 2 * self.ssm_state + self.n_heads) + d_in * d


# the shape cells, the reference's (identical across the LM archs): what
# the dry run (``launch.dryrun``) places and counts
SHAPES = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, global_batch=128),
    "long_500k": dict(kind="decode", seq_len=524288, global_batch=1),
}

# the architectures, the reference's list: dense GQA, with and without
# qk-norm; the MoE family with its dense residual (Arctic) or with MLA,
# shared experts and a dense first layer (DeepSeek); RWKV6; the VLM
# (InternVL2: dense GQA with a patch prefix); the Mamba2 hybrid with a
# shared attention block (Zamba2); the audio encoder-decoder (Whisper)
ARCH_IDS = ["arctic-480b", "deepseek-v2-lite-16b", "granite-8b", "qwen3-8b",
            "qwen3-14b", "minitron-4b", "rwkv6-3b", "internvl2-76b",
            "zamba2-7b", "whisper-base"]


def _module(arch_id: str):
    if arch_id not in ARCH_IDS:
        raise NotImplementedError(
            f"{arch_id}: not an architecture of the reference; the port "
            f"has {ARCH_IDS}")
    return importlib.import_module(
        f"{__package__}.{arch_id.replace('-', '_')}")


def get_config(arch_id: str) -> ArchConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ArchConfig:
    return _module(arch_id).SMOKE
