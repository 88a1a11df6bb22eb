"""Qwen3 8B: dense GQA with qk-norm. [hf:Qwen/Qwen3-8B; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-8b", family="dense", n_layers=36, d_model=4096, n_heads=32,
    n_kv_heads=8, d_head=128, d_ff=12288, vocab=151936, qk_norm=True)

SMOKE = ArchConfig(
    name="qwen3-8b-smoke", family="dense", n_layers=2, d_model=128,
    n_heads=8, n_kv_heads=2, d_head=16, d_ff=256, vocab=512, qk_norm=True,
    kv_clusters=8, cluster_cap=16, cluster_top_p=2,
    long_context_threshold=128)
