"""RWKV6 "Finch" 3B: attention-free, data-dependent decay.
[arXiv:2404.05892; hf]  head_size=64 -> 40 heads at d_model=2560.
k²-attention does not apply to the mixing layer (it keeps a recurrent
state, not a KV cache); decode runs the native O(1) recurrence."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-3b", family="ssm", n_layers=32, d_model=2560, n_heads=40,
    n_kv_heads=40, d_head=64, d_ff=8960, vocab=65536, ssm="rwkv6")

SMOKE = ArchConfig(
    name="rwkv6-smoke", family="ssm", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_head=16, d_ff=128, vocab=512, ssm="rwkv6")
