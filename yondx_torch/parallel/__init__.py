"""Parallelism over torch.distributed (port of yondx/parallel/).

- data parallelism: the AWGN trainer wraps its net in
  DistributedDataParallel over a 1-D mesh of ranks (train/trainer.py);
  each rank takes its rows of the global batch;
- spatial sharding: one full-resolution frame's rows split over the
  ranks, with a halo exchange for the NLE windows and the net's
  receptive field (spatial.py) and the whole iterated pipeline on top
  (product.py);
- ranks: one process a rank, each on its own card under NCCL, or on the
  CPU under gloo (mesh.py: make_mesh, spawn, init_multihost).
"""
from .mesh import Mesh, make_mesh, replicate, shard_batch, spawn
from .product import iter_denoise_frame_sharded
from .spatial import (sharded_box_stats, sharded_mad_self_estimate,
                      sharded_self_nlf_robust, spatial_denoise_sharded,
                      spatial_denoise_sharded_pair)

__all__ = ["make_mesh", "shard_batch", "replicate",
           "sharded_box_stats", "spatial_denoise_sharded",
           "spatial_denoise_sharded_pair", "iter_denoise_frame_sharded",
           "sharded_mad_self_estimate", "sharded_self_nlf_robust",
           "Mesh", "spawn"]
