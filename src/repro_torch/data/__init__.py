from .pipeline import ShardedBatcher, generator_at, token_batches
from .synthetic import DATASET_SHAPES, gmm_blobs, rounding_fixture

__all__ = ["DATASET_SHAPES", "ShardedBatcher", "generator_at", "gmm_blobs",
           "rounding_fixture", "token_batches"]
