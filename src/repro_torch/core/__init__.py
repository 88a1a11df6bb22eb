"""k²-means core library (PyTorch port): the single-device f32 fit and
the served model's predict."""
from .api import INITS, METHODS, fit, initialize
from .distance import clustering_energy, pairwise_sqdist, sqnorm
from .engine import (K2State, K2Step, ResidentState, StepStats,
                     center_knn_graph, init_resident_state, init_state,
                     k2_iteration, k2_resident_iteration,
                     resident_assignment)
from .gdi import gdi_device_init, gdi_round_step, segmented_split_sweep
from .k2means import fit_k2means
from .kmeanspp import assign_nearest, random_init
from .lloyd import KMeansResult
from .model import KMeansModel, Router
from .opcount import OpCounter, charge_iteration

__all__ = ["INITS", "METHODS", "K2State", "K2Step", "KMeansModel",
           "KMeansResult", "OpCounter", "ResidentState", "Router",
           "StepStats", "assign_nearest",
           "center_knn_graph", "charge_iteration", "clustering_energy",
           "fit", "fit_k2means", "gdi_device_init", "gdi_round_step",
           "init_resident_state", "init_state", "initialize",
           "k2_iteration", "k2_resident_iteration", "pairwise_sqdist",
           "random_init", "resident_assignment", "segmented_split_sweep",
           "sqnorm"]
