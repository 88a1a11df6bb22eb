"""Whisper base: a 6-layer encoder and a 6-layer decoder with cross
attention; the conv frontend is stubbed by precomputed frame embeddings
(B, enc_len, d_model). [arXiv:2212.04356; unverified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base", family="audio", n_layers=6, d_model=512, n_heads=8,
    n_kv_heads=8, d_head=64, d_ff=2048, vocab=51865, encoder_layers=6,
    frontend_stub=True)

SMOKE = ArchConfig(
    name="whisper-smoke", family="audio", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_head=16, d_ff=128, vocab=512, encoder_layers=2,
    frontend_stub=True,
    kv_clusters=8, cluster_cap=16, cluster_top_p=2,
    long_context_threshold=128)
