"""Snowflake Arctic 480B: 128-expert top-2 MoE + parallel dense residual.
[hf:Snowflake/snowflake-arctic-base; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="arctic-480b", family="moe", n_layers=35, d_model=7168, n_heads=56,
    n_kv_heads=8, d_head=128, d_ff=4864, vocab=32000,
    moe=True, n_experts=128, top_k=2, moe_d_ff=4864, dense_residual=True)

SMOKE = ArchConfig(
    name="arctic-smoke", family="moe", n_layers=2, d_model=128, n_heads=8,
    n_kv_heads=2, d_head=16, d_ff=96, vocab=512,
    moe=True, n_experts=8, top_k=2, moe_d_ff=96, dense_residual=True,
    kv_clusters=8, cluster_cap=16, cluster_top_p=2,
    long_context_threshold=128)
