"""PyTorch port of the FedSR reproduction, for NVIDIA Hopper GPUs.

A package beside the JAX reference (``src/repro``), mirroring it module by
module. It imports torch and numpy, never JAX and nothing of the JAX
package. Entry points run on the GPU unless the caller passes
``device="cpu"``; the momentum update runs as a hand-written CUDA kernel
(``kernels.fused_sgd``) when ``FLConfig.use_fused_sgd`` is set.
"""
