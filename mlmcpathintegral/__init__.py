"""mlmcpathintegral — batched multilevel MCMC for lattice path integrals.

A JAX/XLA framework, with CUDA kernels for its hot loop, with the capabilities of
eikehmueller/mlmcpathintegral (C++/Eigen/GSL/MPI): multilevel Markov chain
Monte Carlo for 1-D quantum mechanics (harmonic / quartic double-well
oscillators, topological rotor) and 2-D lattice QFT (Gaussian free field,
quenched Schwinger model, O(3) nonlinear sigma model).

Design (batched, not a port):
  * states are batched arrays ``[n_chains, ndof]``; every kernel is written
    batched and jit-compiled, chains shard over a ``jax.sharding.Mesh``
  * actions are pure functions; forces come from ``jax.grad`` (the reference's
    hand-written forces become correctness tests)
  * samplers are pure kernels ``(key, state) -> (state, info)`` composed with
    ``lax.scan``; adaptive outer loops run on the host around fixed-size
    jitted chunks
  * statistics (mean / variance / autocorrelation / tau_int) are on-device
    batched accumulators aggregated across chains exactly the way the
    reference aggregates across MPI ranks
"""

__version__ = "0.1.0"
