"""Native statistics engine tests: C++ engine vs the JAX/Python
implementations on identical streams."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
from scipy import special as ssp

from mlmcpathintegral.utils import statistics as stats_mod
from mlmcpathintegral.utils.native import (
    analyze_samples, binning_analysis, fast_i0_scaled_native,
    native_available,
)
from mlmcpathintegral.utils.statistics import Statistics


def test_native_library_builds_and_loads():
    assert native_available(), "native/libmlmc_stats.so failed to build"


def test_native_matches_jax_statistics():
    rng = np.random.default_rng(0)
    # AR(1) stream
    rho, T = 0.5, 5000
    x = np.empty(T)
    x[0] = rng.normal()
    for t in range(1, T):
        x[t] = rho * x[t - 1] + math.sqrt(1 - rho * rho) * rng.normal()
    k_max = 20

    res = analyze_samples(x, k_max)
    assert res["native"]

    stats = Statistics("Q", k_max)
    st = stats.init(1, jnp.float64)
    st = stats_mod.record_many(st, jnp.asarray(x)[:, None])
    assert res["avg"] == pytest.approx(stats.average(st), rel=1e-12)
    assert res["variance"] == pytest.approx(stats.variance(st), rel=1e-10)
    assert res["tau_int"] == pytest.approx(stats.tau_int(st), rel=1e-10)
    assert res["error"] == pytest.approx(stats.error(st), rel=1e-10)
    np.testing.assert_allclose(res["autocorr"],
                               stats.auto_corr(st), rtol=1e-8)


def test_binning_plateau_matches_tau_error():
    rng = np.random.default_rng(1)
    rho, T = 0.6, 200_000
    e = rng.normal(size=T) * math.sqrt(1 - rho * rho)
    x = np.empty(T)
    x[0] = rng.normal()
    for t in range(1, T):
        x[t] = rho * x[t - 1] + e[t]
    errs = binning_analysis(x, n_levels=12)
    res = analyze_samples(x, k_max=60)
    # binning plateau ~ tau-corrected error
    assert errs[8] == pytest.approx(res["error"], rel=0.15)
    # and clearly above the naive (uncorrected) error
    assert errs[8] > 1.5 * errs[0]


def test_native_fast_i0_scaled():
    for z in [0.1, 1.0, 10.0, 14.9, 15.1, 100.0, 1000.0]:
        assert fast_i0_scaled_native(z) == pytest.approx(
            float(ssp.ive(0, z)), rel=1e-9), z
