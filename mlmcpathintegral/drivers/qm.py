"""Quantum-mechanics driver: the analog of the reference's ``driver_qm``
executable (src/driver_qm.cc:98-429).

Usage: ``python driver_qm.py parameters.in`` with a reference-format
parameter file; runs the selected method (singlelevel / twolevel /
multilevel) on the selected 1-D action, prints the statistics and the
|numerical - analytical| comparison in units of the statistical error.
"""

from __future__ import annotations

import sys

import jax

from mlmcpathintegral.conditioned import make_conditioned_fine_action
from mlmcpathintegral.drivers.common import (
    SAMPLER_CHOICES, make_sampler_factory, parallel_setup,
)
from mlmcpathintegral.lattice import Lattice1D
from mlmcpathintegral.mc import (
    MonteCarloMultiLevel, MonteCarloSingleLevel, MonteCarloTwoLevel,
)
from mlmcpathintegral.models import (
    HarmonicOscillatorAction, QuarticOscillatorAction, RenormalisationType,
    RotorAction,
)
from mlmcpathintegral.qoi import qoi_susceptibility, qoi_x_squared
from mlmcpathintegral.utils.config import Section, read_parameter_file

RENORM = {"none": RenormalisationType.NONE,
          "perturbative": RenormalisationType.PERTURBATIVE,
          "nonperturbative": RenormalisationType.NONPERTURBATIVE}


def build_action(config, lattice):
    """driver_qm.cc:226-268: construct the QM action from its section."""
    qm = Section(config, "quantummechanics", defaults={"action": "rotor"})
    name = qm.get_string("action", {"harmonicoscillator",
                                    "quarticoscillator", "rotor"})
    if name == "harmonicoscillator":
        sec = Section(config, "harmonicoscillator",
                      defaults={"m0": 1.0, "mu2": 1.0,
                                "renormalisation": "none"})
        return HarmonicOscillatorAction(
            lattice, RENORM[sec.get_string("renormalisation")],
            m0=sec.get_float("m0", positive=True),
            mu2=sec.get_float("mu2"))
    if name == "quarticoscillator":
        sec = Section(config, "quarticoscillator",
                      defaults={"m0": 1.0, "mu2": 1.0, "lambda": 1.0,
                                "x0": 0.0, "renormalisation": "none"})
        return QuarticOscillatorAction(
            lattice, RENORM[sec.get_string("renormalisation")],
            m0=sec.get_float("m0", positive=True),
            mu2=sec.get_float("mu2"), lam=sec.get_float("lambda"),
            x0=sec.get_float("x0"))
    sec = Section(config, "rotor",
                  defaults={"m0": 0.25, "renormalisation": "none"})
    return RotorAction(lattice, RENORM[sec.get_string("renormalisation")],
                       m0=sec.get_float("m0", positive=True))


def analytical_results(action):
    """Exact / perturbative values for the model's QoI
    (driver_qm.cc:273-311)."""
    if isinstance(action, HarmonicOscillatorAction):
        return {"analytical": action.Xsquared_analytical(),
                "continuum": action.Xsquared_analytical_continuum()}
    if isinstance(action, RotorAction):
        return {"analytical": action.chit_exact(),
                "perturbative": action.chit_perturbative(),
                "continuum": action.chit_continuum()}
    return {}


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 1:
        print("Usage: python driver_qm.py <parameters.in>")
        return 1
    config = read_parameter_file(argv[0])
    n_chains, dtype = parallel_setup(config)

    general = Section(config, "general", defaults={"method": "singlelevel"})
    method = general.get_string("method",
                                {"singlelevel", "twolevel", "multilevel"})
    lat_sec = Section(config, "lattice",
                      defaults={"M_lat": 32, "T_final": 4.0})
    lattice = Lattice1D(lat_sec.get_int("M_lat", positive=True),
                        lat_sec.get_float("T_final", positive=True))
    stats_sec = Section(config, "statistics",
                        defaults={"n_autocorr_window": 20,
                                  "n_min_samples_qoi": 100})
    n_autocorr = stats_sec.get_int("n_autocorr_window", positive=True)
    n_min_samples = stats_sec.get_int("n_min_samples_qoi", positive=True)

    action = build_action(config, lattice)
    is_rotor = isinstance(action, RotorAction)
    qoi_factory = qoi_susceptibility if is_rotor else qoi_x_squared
    qoi_name = "chi_t" if is_rotor else "<x^2>"

    print("+--------------------------------+")
    print("! batched multilevel MCMC (JAX)  !")
    print("+--------------------------------+")
    print(f"action  : {action.info_string()}")
    print(f"method  : {method}")
    print(f"chains  : {n_chains}  dtype: {dtype.__name__}")
    print()

    key = jax.random.PRNGKey(0)
    if method == "singlelevel":
        sec = Section(config, "singlelevelmc",
                      defaults={"n_burnin": 100, "n_samples": 0,
                                "epsilon": 1e-2, "sampler": "HMC"})
        sampler_factory = make_sampler_factory(
            sec.get_string("sampler", SAMPLER_CHOICES), config,
            cond_factory=make_conditioned_fine_action,
            qoi_factory=qoi_factory)
        mc = MonteCarloSingleLevel(
            action, qoi_factory(action), sampler_factory(action),
            n_burnin=sec.get_int("n_burnin", positive=True),
            n_samples=sec.get_int("n_samples", non_negative=True),
            epsilon=sec.get_float("epsilon", positive=True),
            n_autocorr_window=n_autocorr,
            n_min_samples_qoi=n_min_samples,
            qoi_log_path=config.get("singlelevelmc", {}).get(
                "qoi_log_path"),
            save_states_path=config.get("singlelevelmc", {}).get(
                "save_states_path"))
        sstate, stats = mc.evaluate(key, n_chains, dtype, verbose=True)
        mc.show_statistics(stats)
        print(f" sampler acceptance p = {mc.p_accept:.5f}")
        if hasattr(mc.sampler, "show_stats"):
            # per-level acceptance of the hierarchical/multilevel sampler
            # (hierarchicalsampler.cc:90-117)
            print("=== Per-level sampler statistics ===")
            mc.sampler.show_stats(sstate)
        numerical, stat_err = mc.numerical_result(stats), \
            mc.statistical_error(stats)
    elif method == "twolevel":
        sec = Section(config, "twolevelmc",
                      defaults={"n_burnin": 100, "n_samples": 1000,
                                "sampler": "HMC"})
        sampler_factory = make_sampler_factory(
            sec.get_string("sampler", SAMPLER_CHOICES), config,
            cond_factory=make_conditioned_fine_action,
            qoi_factory=qoi_factory)
        mc = MonteCarloTwoLevel(
            action, qoi_factory, sampler_factory,
            make_conditioned_fine_action,
            n_burnin=sec.get_int("n_burnin", positive=True),
            n_samples=sec.get_int("n_samples", positive=True),
            n_autocorr_window=n_autocorr)
        stats = mc.evaluate_difference(key, n_chains, dtype, verbose=True)
        mc.show_statistics(stats)
        numerical = mc.stats_fine.average(stats["fine"])
        stat_err = mc.stats_fine.error(stats["fine"])
    else:
        sec = Section(config, "multilevelmc",
                      defaults={"n_level": 3, "n_burnin": 100,
                                "epsilon": 1.0, "n_samples": 0,
                                "show_detailed_stats": False,
                                "sampler": "hierarchical"})
        coarse_factory = make_sampler_factory(
            Section(config, "hierarchical",
                    defaults={"coarsesampler": "HMC",
                              "n_max_level": 3}).get_string(
                "coarsesampler", SAMPLER_CHOICES),
            config, cond_factory=make_conditioned_fine_action,
            qoi_factory=qoi_factory)
        mc = MonteCarloMultiLevel(
            action, qoi_factory, coarse_factory,
            make_conditioned_fine_action,
            n_level=sec.get_int("n_level", positive=True),
            epsilon=sec.get_float("epsilon", positive=True),
            n_burnin=sec.get_int("n_burnin", positive=True),
            n_samples=sec.get_int("n_samples", non_negative=True),
            n_autocorr_window=n_autocorr,
            n_min_samples_qoi=n_min_samples)
        mc.evaluate(key, n_chains, dtype, verbose=True)
        mc.show_statistics()
        if sec.get_bool("show_detailed_stats"):
            mc.show_detailed_statistics()
        numerical, stat_err = mc.numerical_result(), mc.statistical_error()

    # analytic comparison (driver_qm.cc:411-425)
    print()
    for label, value in analytical_results(action).items():
        print(f" {qoi_name} [{label}]  = {value:.6f}")
    ana = analytical_results(action).get("analytical")
    if ana is not None:
        print(f" |numerical - analytical| = {abs(numerical - ana):.6f}"
              f" = {abs(numerical - ana) / stat_err:.2f} * statistical error")
    return 0


if __name__ == "__main__":
    sys.exit(main())
