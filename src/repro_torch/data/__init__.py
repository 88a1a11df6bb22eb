from .synthetic import DATASET_SHAPES, gmm_blobs, rounding_fixture

__all__ = ["DATASET_SHAPES", "gmm_blobs", "rounding_fixture"]
