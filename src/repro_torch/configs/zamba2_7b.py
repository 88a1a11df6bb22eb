"""Zamba2 7B: a Mamba2 backbone and one shared attention block applied
every 6 layers. [arXiv:2411.15242; unverified]  d_head = 3584/32 = 112."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b", family="hybrid", n_layers=81, d_model=3584, n_heads=32,
    n_kv_heads=32, d_head=112, d_ff=14336, vocab=32000,
    ssm="mamba2", ssm_state=64, ssm_expand=2, attn_every=6)

SMOKE = ArchConfig(
    name="zamba2-smoke", family="hybrid", n_layers=4, d_model=64, n_heads=4,
    n_kv_heads=4, d_head=16, d_ff=128, vocab=512,
    ssm="mamba2", ssm_state=8, ssm_expand=2, attn_every=2,
    kv_clusters=8, cluster_cap=16, cluster_top_p=2,
    long_context_threshold=128)
