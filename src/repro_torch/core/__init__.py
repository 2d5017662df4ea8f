"""repro_torch.core — exact k-means on the port's kernels.

Public API:
  KMeans, KMeansConfig, KMeansState     — the composable module
  lloyd_stats / lloyd_step / make_kmeans_fn
  ParallelContext / build_mesh          — the one SPMD execution layer on
                                          torch.distributed device meshes +
                                          the one mesh helper
  make_distributed_kmeans / shard_points — multi-rank adapter over it
  ChunkedKMeans / ChunkedStats          — out-of-core driver (copy stream,
                                          pinned staging) + its telemetry
  StreamingKMeans / partial_fit_step    — online / mini-batch driver
  SufficientStats                       — the drivers' reduction type
  KernelPlanner / KernelPlan            — the planning layer every kernel
                                          dispatch goes through
  default_planner / detect_hardware     — per-device planner + hw mapping
  choose_blocks / Hardware / H100       — closed-form heuristic internals
  init_centroids / kmeans_plus_plus / random_init
  state_from_numpy / state_to_numpy     — carry a state across packages
  stream_from_numpy / stream_to_numpy   — the same for a StreamingKMeans
"""
from repro_torch.core.bridge import (state_from_numpy, state_to_numpy,
                                     stream_from_numpy, stream_to_numpy)
from repro_torch.core.chunked import ChunkedKMeans, ChunkedStats
from repro_torch.core.distributed import make_distributed_kmeans, shard_points
from repro_torch.core.heuristics import H100, Hardware, choose_blocks
from repro_torch.core.init import init_centroids, kmeans_plus_plus, random_init
from repro_torch.core.kmeans import (KMeans, KMeansConfig, KMeansState,
                                     lloyd_stats, lloyd_step, make_kmeans_fn)
from repro_torch.core.parallel import (ParallelContext, build_mesh,
                                       make_host_mesh, make_production_mesh,
                                       parse_mesh_flag)
from repro_torch.core.plan import (KernelPlan, KernelPlanner, default_planner,
                                   detect_hardware, set_default_planner)
from repro_torch.core.streaming import (StreamingKMeans, SufficientStats,
                                        partial_fit_step)

__all__ = [
    "KMeans", "KMeansConfig", "KMeansState", "lloyd_stats", "lloyd_step",
    "make_kmeans_fn", "ChunkedKMeans", "ChunkedStats",
    "make_distributed_kmeans", "shard_points",
    "ParallelContext", "build_mesh", "make_host_mesh", "make_production_mesh",
    "parse_mesh_flag",
    "StreamingKMeans", "SufficientStats", "partial_fit_step",
    "KernelPlan", "KernelPlanner", "default_planner", "detect_hardware",
    "set_default_planner",
    "choose_blocks", "Hardware", "H100", "init_centroids",
    "kmeans_plus_plus", "random_init", "state_from_numpy", "state_to_numpy",
    "stream_from_numpy", "stream_to_numpy",
]
