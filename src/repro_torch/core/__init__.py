"""repro_torch.core — exact k-means on the port's kernels.

Public API:
  KMeans, KMeansConfig, KMeansState     — the composable module
  lloyd_stats / lloyd_step / make_kmeans_fn
  KernelPlanner / KernelPlan            — the planning layer every kernel
                                          dispatch goes through
  default_planner / detect_hardware     — per-device planner + hw mapping
  choose_blocks / Hardware / H100       — closed-form heuristic internals
  init_centroids / kmeans_plus_plus / random_init
  state_from_numpy / state_to_numpy     — carry a state across packages
"""
from repro_torch.core.bridge import state_from_numpy, state_to_numpy
from repro_torch.core.heuristics import H100, Hardware, choose_blocks
from repro_torch.core.init import init_centroids, kmeans_plus_plus, random_init
from repro_torch.core.kmeans import (KMeans, KMeansConfig, KMeansState,
                                     lloyd_stats, lloyd_step, make_kmeans_fn)
from repro_torch.core.plan import (KernelPlan, KernelPlanner, default_planner,
                                   detect_hardware, set_default_planner)

__all__ = [
    "KMeans", "KMeansConfig", "KMeansState", "lloyd_stats", "lloyd_step",
    "make_kmeans_fn",
    "KernelPlan", "KernelPlanner", "default_planner", "detect_hardware",
    "set_default_planner",
    "choose_blocks", "Hardware", "H100", "init_centroids",
    "kmeans_plus_plus", "random_init", "state_from_numpy", "state_to_numpy",
]
