from .adamw import (adamw_init, adamw_update, clip_by_global_norm,
                    cosine_schedule, init_opt_shapes, tree_leaves, tree_map)
from .compress import compress_int8, compressed_grads, decompress_int8

__all__ = ["adamw_init", "adamw_update", "clip_by_global_norm",
           "compress_int8", "compressed_grads", "cosine_schedule",
           "decompress_int8", "init_opt_shapes", "tree_leaves", "tree_map"]
