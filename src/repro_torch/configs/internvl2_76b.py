"""InternVL2 76B: an 80-layer dense GQA LLM whose first ``n_patches``
positions take the vision tower's patch embeddings (the InternViT
frontend is stubbed by precomputed patches). [arXiv:2404.16821;
unverified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-76b", family="vlm", n_layers=80, d_model=8192,
    n_heads=64, n_kv_heads=8, d_head=128, d_ff=28672, vocab=128256,
    n_patches=256)

SMOKE = ArchConfig(
    name="internvl2-smoke", family="vlm", n_layers=2, d_model=128,
    n_heads=8, n_kv_heads=2, d_head=16, d_ff=256, vocab=512, n_patches=8,
    kv_clusters=8, cluster_cap=16, cluster_top_p=2,
    long_context_threshold=128)
