"""k²-means core library (PyTorch port): the single-device fit
(k²-means on an f32 or int8 arena, Lloyd, Elkan; random, k-means++ and
GDI inits) and the served model's predict and streaming partial_fit."""
from .api import INITS, METHODS, fit, initialize
from .distance import clustering_energy, sqnorm
from .elkan import elkan_step, fit_elkan
from .engine import (K2State, K2Step, ResidentState, StepStats,
                     center_knn_graph, init_resident_state, init_state,
                     k2_iteration, k2_resident_iteration,
                     resident_assignment)
from .gdi import gdi_device_init, gdi_round_step, segmented_split_sweep
from .k2means import fit_k2means
from .kmeanspp import assign_nearest, kmeanspp_init, random_init
from .lloyd import KMeansResult, fit_lloyd, lloyd_step, update_centers
from .model import KMeansModel, Router
from .opcount import OpCounter, charge_iteration

__all__ = ["INITS", "METHODS", "K2State", "K2Step", "KMeansModel",
           "KMeansResult", "OpCounter", "ResidentState", "Router",
           "StepStats", "assign_nearest", "center_knn_graph",
           "charge_iteration", "clustering_energy", "elkan_step", "fit",
           "fit_elkan", "fit_k2means", "fit_lloyd", "gdi_device_init",
           "gdi_round_step", "init_resident_state", "init_state",
           "initialize", "k2_iteration", "k2_resident_iteration",
           "kmeanspp_init", "lloyd_step", "random_init",
           "resident_assignment", "segmented_split_sweep", "sqnorm",
           "update_centers"]
