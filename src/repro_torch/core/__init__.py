"""k²-means core library (PyTorch port): the single-device fit
(k²-means on the kernels or the ungrouped xla backend, over an f32 or
int8 arena; Lloyd, Elkan, MiniBatch and AKM; random, k-means++ and the
three GDI inits) and the served model's predict and streaming
partial_fit."""
from .akm import fit_akm
from .api import INITS, METHODS, fit, initialize
from .distance import (chunked_argmin_sqdist, chunked_candidate_argmin,
                       chunked_candidate_top2, clustering_energy,
                       gather_candidate_sqdist, pairwise_sqdist, sqnorm)
from .elkan import elkan_step, fit_elkan
from .engine import (K2State, K2Step, ResidentState, StepStats,
                     center_knn_graph, init_resident_state, init_state,
                     k2_iteration, k2_resident_iteration,
                     resident_assignment)
from .gdi import (gdi_device_init, gdi_init, gdi_parallel_init,
                  gdi_round_step, projective_split, segmented_split_sweep)
from .k2means import fit_k2means
from .kmeanspp import assign_nearest, kmeanspp_init, random_init
from .lloyd import KMeansResult, fit_lloyd, lloyd_step, update_centers
from .minibatch import fit_minibatch
from .model import KMeansModel, Router
from .opcount import OpCounter, charge_iteration

__all__ = ["INITS", "METHODS", "K2State", "K2Step", "KMeansModel",
           "KMeansResult", "OpCounter", "ResidentState", "Router",
           "StepStats", "assign_nearest", "center_knn_graph",
           "charge_iteration", "chunked_argmin_sqdist",
           "chunked_candidate_argmin", "chunked_candidate_top2",
           "clustering_energy", "elkan_step", "fit", "fit_akm",
           "fit_elkan", "fit_k2means", "fit_lloyd", "fit_minibatch",
           "gather_candidate_sqdist", "gdi_device_init", "gdi_init",
           "gdi_parallel_init", "gdi_round_step", "init_resident_state",
           "init_state", "initialize", "k2_iteration",
           "k2_resident_iteration", "kmeanspp_init", "lloyd_step",
           "pairwise_sqdist", "projective_split", "random_init",
           "resident_assignment", "segmented_split_sweep", "sqnorm",
           "update_centers"]
