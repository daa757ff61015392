"""saccot — point-cloud registration and SLAM engine in JAX.

A JAX/XLA framework with the capabilities of the reference
``ytuhzq/SAC-COT`` (official code of *SAC-COT: Sample Consensus by Sampling
Compatibility Triangles in Graphs for 3-D Point Cloud Registration*,
/root/reference/README.md:1-2). The reference is single-process C++/PCL
research code; this framework re-designs the same pipeline for an
accelerator (an NVIDIA H100 today; the CPU runs every path too):

- correspondence generation as batched matmul + top-k
- the O(N^2) rigidity-compatibility degrees as one Triton kernel on CUDA
  GPUs (plain XLA elsewhere)
- compatibility-triangle (COT) ranking/sampling with static shapes
- batched 3-point SVD hypothesis generation + einsum inlier scoring
- multi-scan pose-graph optimization and Schur-complement bundle
  adjustment sharded over a `jax.sharding.Mesh` with XLA collectives.

Subpackages
-----------
- ``oracle``     NumPy reference implementation (the CPU baseline)
- ``engine``     jitted SAC-COT estimator (the API centerpiece)
- ``kernels``    the Pallas (Triton) degree kernel for CUDA GPUs
- ``features``   ISS keypoints, SHOT/FPFH descriptors, normals, voxel grid
- ``match``      descriptor matching (GEMM + top-k)
- ``dist``       mesh setup, shard_map wrappers, multi-host init
- ``slam``       pose-graph Gauss-Newton + distributed bundle adjustment
- ``evaluation`` recall/RMSE/ATE metrics + benchmark harness
- ``io``         PLY/PCD/KITTI loaders, ground-truth parsers, bucketing
- ``cli``        driver entry points for the benchmark configs
"""

__version__ = "0.1.0"

from saccot.utils.params import SacCotParams  # noqa: F401
