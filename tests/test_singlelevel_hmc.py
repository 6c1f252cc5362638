"""End-to-end integration test: single-level MC with HMC on the harmonic
oscillator against the exact <X^2> oracle — the pytest version of the
reference's driver-level consistency check (driver_qm.cc:411-425).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mlmcpathintegral.lattice import Lattice1D
from mlmcpathintegral.mc import MonteCarloSingleLevel
from mlmcpathintegral.models import HarmonicOscillatorAction, RotorAction
from mlmcpathintegral.qoi import qoi_susceptibility, qoi_x_squared
from mlmcpathintegral.samplers import HMCSampler


def test_hmc_harmonic_xsquared_matches_oracle():
    lat = Lattice1D(M_lat=16, T_final=4.0)
    action = HarmonicOscillatorAction(lat, m0=1.0, mu2=1.0)
    sampler = HMCSampler(action, nt=20, dt=0.1, n_burnin=20)
    qoi = qoi_x_squared(lat)
    mc = MonteCarloSingleLevel(action, qoi, sampler,
                               n_burnin=200, n_samples=4000,
                               chunk_size=200)
    sstate, stats = mc.evaluate(jax.random.PRNGKey(0), n_chains=32,
                                dtype=jnp.float64)
    result = mc.numerical_result(stats)
    err = mc.statistical_error(stats)
    oracle = action.Xsquared_analytical()
    assert err < 0.05
    assert abs(result - oracle) < 4.0 * err, \
        f"result={result} oracle={oracle} err={err}"


def test_hmc_autotuned_acceptance_near_target():
    lat = Lattice1D(M_lat=16, T_final=4.0)
    action = HarmonicOscillatorAction(lat, m0=1.0, mu2=1.0)
    sampler = HMCSampler(action, nt=20, dt=0.5, n_burnin=20)
    state = sampler.prepare(jax.random.PRNGKey(1), n_chains=64,
                            dtype=jnp.float64)
    # measure acceptance at the tuned dt
    n_acc = 0
    key = jax.random.PRNGKey(2)
    state2 = state
    for i in range(50):
        key, sub = jax.random.split(key)
        state2, acc = sampler.draw(sub, state2)
        n_acc += int(jnp.sum(acc))
    p = n_acc / (50 * 64)
    assert 0.7 < p <= 0.95, f"tuned acceptance {p} not near 0.8"


def test_hmc_rotor_susceptibility_matches_oracle():
    lat = Lattice1D(M_lat=16, T_final=4.0)
    action = RotorAction(lat, m0=1.0)
    sampler = HMCSampler(action, nt=20, dt=0.2, n_burnin=20)
    qoi = qoi_susceptibility(lat)
    mc = MonteCarloSingleLevel(action, qoi, sampler,
                               n_burnin=200, n_samples=8000,
                               n_autocorr_window=50, chunk_size=200)
    sstate, stats = mc.evaluate(jax.random.PRNGKey(3), n_chains=32,
                                dtype=jnp.float64)
    result = mc.numerical_result(stats)
    err = mc.statistical_error(stats)
    oracle = action.chit_exact()
    assert abs(result - oracle) < 4.0 * err, \
        f"result={result} oracle={oracle} err={err}"


def test_adaptive_target_mode_reaches_tolerance():
    lat = Lattice1D(M_lat=8, T_final=2.0)
    action = HarmonicOscillatorAction(lat, m0=1.0, mu2=1.0)
    sampler = HMCSampler(action, nt=10, dt=0.1, n_burnin=10)
    qoi = qoi_x_squared(lat)
    eps = 0.02
    mc = MonteCarloSingleLevel(action, qoi, sampler,
                               n_burnin=100, n_samples=0, epsilon=eps,
                               chunk_size=100)
    _, stats = mc.evaluate(jax.random.PRNGKey(4), n_chains=16,
                           dtype=jnp.float64)
    # the adaptive loop targets err ~ eps/sqrt(2)
    assert mc.statistical_error(stats) < eps
