from .synthetic import DATASET_SHAPES, gmm_blobs

__all__ = ["DATASET_SHAPES", "gmm_blobs"]
