"""DeepSeek-V2-Lite 16B: MLA (kv_lora 512) and a 64-expert top-6 MoE with
2 shared experts; the first layer is dense. [arXiv:2405.04434;
hf:deepseek-ai/DeepSeek-V2-Lite]

The dense first layer follows the reference (``repro.models.model``),
which builds it with ``transformer.dense_layer_init`` under ``moe=False,
mla=False``: GQA attention with 16 kv-heads of 128 and a SwiGLU of
``d_ff`` = 1408. Hugging Face's first layer is an MLA layer with a
10,944-wide MLP; the port keeps the reference's, its oracle."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b", family="moe", n_layers=27, d_model=2048,
    n_heads=16, n_kv_heads=16, d_head=128, d_ff=1408, vocab=102400,
    moe=True, n_experts=64, top_k=6, n_shared_experts=2, moe_d_ff=1408,
    first_dense=1,
    mla=True, kv_lora=512, qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128)

SMOKE = ArchConfig(
    name="deepseek-smoke", family="moe", n_layers=3, d_model=96, n_heads=4,
    n_kv_heads=4, d_head=24, d_ff=64, vocab=512,
    moe=True, n_experts=8, top_k=3, n_shared_experts=1, moe_d_ff=64,
    first_dense=1,
    mla=True, kv_lora=32, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
    kv_clusters=8, cluster_cap=16, cluster_top_p=2,
    long_context_threshold=128)
