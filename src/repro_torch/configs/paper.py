"""Clustering benchmark configurations from the paper's experiments (§3):
dataset stand-ins, k grid, parameter grids for AKM's m and k²-means' k_n."""
K_GRID = [50, 200, 1000]
K_GRID_INIT = [100, 200, 500]
PARAM_GRID = [3, 5, 10, 20, 30, 50, 100, 200]   # m (AKM) and k_n (k²-means)
REFERENCE_LEVELS = [0.0, 0.005, 0.01, 0.02]
MAX_ITERS = 100
MINIBATCH_B = 100
PROJECTIVE_SPLIT_ITERS = 2
SEEDS = 3
