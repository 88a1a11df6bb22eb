"""Minitron 4B: width/depth-pruned Nemotron. [arXiv:2407.14679; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="minitron-4b", family="dense", n_layers=32, d_model=3072,
    n_heads=24, n_kv_heads=8, d_head=128, d_ff=9216, vocab=256000)

SMOKE = ArchConfig(
    name="minitron-smoke", family="dense", n_layers=2, d_model=96,
    n_heads=6, n_kv_heads=2, d_head=16, d_ff=192, vocab=512,
    kv_clusters=8, cluster_cap=16, cluster_top_p=2,
    long_context_threshold=128)
