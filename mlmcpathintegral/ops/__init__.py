"""Fused kernels of the quenched Schwinger model: plain-JAX references
(``schwinger``, ``schwinger_twolevel``), the counter RNG they share
(``counter_rng``) and the CUDA build that runs them on the GPU
(``cuda_kernels``)."""
