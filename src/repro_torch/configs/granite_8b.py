"""IBM Granite 8B (code): llama-arch dense GQA. [arXiv:2405.04324; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite-8b", family="dense", n_layers=36, d_model=4096, n_heads=32,
    n_kv_heads=8, d_head=128, d_ff=14336, vocab=49152)

SMOKE = ArchConfig(
    name="granite-smoke", family="dense", n_layers=2, d_model=128, n_heads=8,
    n_kv_heads=2, d_head=16, d_ff=256, vocab=512,
    kv_clusters=8, cluster_cap=16, cluster_top_p=2,
    long_context_threshold=128)
