"""Round-2 parity-gap fixes:
hard_reset, window-cap warning + binning cross-check, SAVE_STATES dumps,
random_order key handling."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mlmcpathintegral.utils import statistics as stats_mod
from mlmcpathintegral.utils.statistics import Statistics


def test_hard_reset_clears_everything():
    st = Statistics("Q", 8)
    s = st.init(4, jnp.float32)
    for k in range(20):
        s = stats_mod.record(s, jnp.full((4,), float(k)))
    s_soft = stats_mod.soft_reset(s)
    assert int(s_soft.n) == 0 and int(s_soft.n_lt) == 20
    assert float(np.abs(np.asarray(s_soft.S_k)).sum()) > 0
    s_hard = stats_mod.hard_reset(s)
    assert int(s_hard.n) == 0 and int(s_hard.n_lt) == 0
    for leaf in s_hard:
        assert float(np.abs(np.asarray(leaf)).sum()) == 0.0


def test_window_cap_warning_and_binning_tau():
    """A strongly-autocorrelated series whose tau exceeds the window must
    set window_capped and emit one warning; the binning estimate must
    exceed the (deflated) windowed value."""
    from mlmcpathintegral.utils.native import binning_analysis

    rng = np.random.default_rng(0)
    n, rho = 8000, 0.995                      # tau_true ~ 400
    x = np.empty(n)
    x[0] = rng.standard_normal()
    eps = rng.standard_normal(n) * np.sqrt(1 - rho * rho)
    for i in range(1, n):
        x[i] = rho * x[i - 1] + eps[i]

    st = Statistics("Q", 20)
    s = st.init(1, jnp.float64)
    s = stats_mod.record_many(s, jnp.asarray(x)[:, None])
    assert st.window_capped(s)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        tau_win = st.tau_int(s)
        assert any("window" in str(wi.message) for wi in w)
    errs = binning_analysis(x, n_levels=10)
    tau_bin = (errs.max() / errs[0]) ** 2
    assert tau_bin > 2 * tau_win, (tau_bin, tau_win)

    # an uncorrelated series must NOT be flagged
    st2 = Statistics("Q2", 20)
    s2 = st2.init(1, jnp.float64)
    s2 = stats_mod.record_many(
        s2, jnp.asarray(rng.standard_normal(2000))[:, None])
    assert not st2.window_capped(s2)


def test_save_states_dump(tmp_path):
    from mlmcpathintegral.lattice import Lattice1D
    from mlmcpathintegral.mc import MonteCarloSingleLevel
    from mlmcpathintegral.models import HarmonicOscillatorAction
    from mlmcpathintegral.qoi import qoi_x_squared
    from mlmcpathintegral.samplers import HMCSampler

    lat = Lattice1D(M_lat=8, T_final=4.0)
    act = HarmonicOscillatorAction(lat, m0=1.0, mu2=1.0)
    out = tmp_path / "states"
    mc = MonteCarloSingleLevel(
        act, qoi_x_squared(lat), HMCSampler(act, nt=4, dt=0.1, n_burnin=5),
        n_burnin=10, n_samples=40, chunk_size=16,
        save_states_path=str(out))
    mc.evaluate(jax.random.PRNGKey(0), n_chains=8, dtype=jnp.float32)
    files = sorted(out.glob("states_*.npz"))
    assert files, "no state dumps written"
    total = sum(np.load(f)["x"].shape[0] for f in files)
    # ceil(40/8)=5 recorded steps, chunked 16 -> one chunk of 5 states
    assert total == 5
    x = np.load(files[0])["x"]
    assert x.shape[1:] == (8, 8)              # [n, n_chains, ndof]


def test_random_order_key_warns():
    from mlmcpathintegral.drivers.common import make_sampler_factory
    config = {"heatbath": {"n_sweep_heatbath": 1, "n_sweep_overrelax": 1,
                           "n_burnin": 10, "random_order": True}}
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        make_sampler_factory("heatbath", config)
        assert any("random_order" in str(wi.message) for wi in w)
    # not mentioned -> no warning
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        make_sampler_factory("heatbath", {"heatbath": {}})
        assert not any("random_order" in str(wi.message) for wi in w)
    # a non-bool value must be rejected
    bad = {"heatbath": {"random_order": 3}}
    with pytest.raises(TypeError):
        make_sampler_factory("heatbath", bad)
