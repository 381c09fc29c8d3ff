"""dstdgcn_tpu — a spatiotemporal graph-convolution framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of the reference
DSTD-GCN repository (Jaakk0F/DSTD-GCN): dynamic spatiotemporal decomposed
graph convolutions for human-motion prediction on Human3.6M / CMU Mocap /
3DPW, with a sparse-aware SpMM/SDDMM op surface, a sharded ``jax.Array``
input pipeline, a jitted training engine, and mesh-parallel execution via
``jax.sharding`` + ``shard_map``; it runs on NVIDIA GPUs.
"""

__version__ = "0.1.0"
