"""Qwen3 14B: dense GQA with qk-norm. [hf:Qwen/Qwen3-14B; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-14b", family="dense", n_layers=40, d_model=5120, n_heads=40,
    n_kv_heads=8, d_head=128, d_ff=17408, vocab=151936, qk_norm=True)

SMOKE = ArchConfig(
    name="qwen3-14b-smoke", family="dense", n_layers=2, d_model=128,
    n_heads=4, n_kv_heads=2, d_head=32, d_ff=256, vocab=512, qk_norm=True,
    kv_clusters=8, cluster_cap=16, cluster_top_p=2,
    long_context_threshold=128)
