"""QFT driver: the analog of the reference's ``driver_qft`` executable
(src/driver_qft.cc:100-459).

Usage: ``python driver_qft.py parameters.in``.  Supports the quenched
Schwinger model, the Gaussian Free Field and the O(3) nonlinear sigma
model; multilevel is blocked for the sigma model exactly as in the
reference (driver_qft.cc:406-411).
"""

from __future__ import annotations

import sys

import jax

from mlmcpathintegral.conditioned.gff import GFFConditionedFineAction
from mlmcpathintegral.conditioned.schwinger import (
    make_schwinger_conditioned_fine_action,
)
from mlmcpathintegral.conditioned.sigma import (
    NonlinearSigmaConditionedFineAction,
)
from mlmcpathintegral.drivers.common import (
    SAMPLER_CHOICES, make_sampler_factory, parallel_setup,
)
from mlmcpathintegral.lattice2d import CoarseningType, Lattice2D
from mlmcpathintegral.mc import (
    MonteCarloMultiLevel, MonteCarloSingleLevel, MonteCarloTwoLevel,
)
from mlmcpathintegral.models.base import RenormalisationType
from mlmcpathintegral.models.qft import GFFAction
from mlmcpathintegral.models.qft.nonlinearsigma import (
    NonlinearSigmaAction, qoi_magnetic_susceptibility,
)
from mlmcpathintegral.models.qft.schwinger import (
    QuenchedSchwingerAction, chit_perturbative, chit_var_continuum,
)
from mlmcpathintegral.qoi import (
    qoi_2d_phi_squared, qoi_2d_susceptibility, qoi_avg_plaquette,
)
from mlmcpathintegral.samplers.schwingercluster import (
    QuenchedSchwingerClusterSampler,
)
from mlmcpathintegral.utils.config import Section, read_parameter_file

RENORM = {"none": RenormalisationType.NONE,
          "perturbative": RenormalisationType.PERTURBATIVE,
          "nonperturbative": RenormalisationType.NONPERTURBATIVE}

COARSEN = {"both": CoarseningType.BOTH, "temporal": CoarseningType.TEMPORAL,
           "spatial": CoarseningType.SPATIAL,
           "alternate": CoarseningType.ALTERNATE,
           "rotate": CoarseningType.ROTATE}


def build_action(config, lattice):
    qft = Section(config, "quantumfieldtheory",
                  defaults={"action": "quenchedschwinger"})
    name = qft.get_string("action", {"quenchedschwinger", "nonlinearsigma",
                                     "gff"})
    if name == "quenchedschwinger":
        sec = Section(config, "schwinger",
                      defaults={"beta": 1.0, "renormalisation": "none"})
        return QuenchedSchwingerAction(
            lattice, beta=sec.get_float("beta", positive=True),
            renormalisation=RENORM[sec.get_string("renormalisation")])
    if name == "gff":
        sec = Section(config, "gff",
                      defaults={"mass": 1.0, "renormalisation": "none"})
        return GFFAction(lattice, mass=sec.get_float("mass", positive=True))
    sec = Section(config, "nonlinearsigma",
                  defaults={"beta": 1.0, "renormalisation": "none"})
    return NonlinearSigmaAction(
        lattice, beta=sec.get_float("beta", positive=True),
        renormalisation=RENORM[sec.get_string("renormalisation")])


def select_qoi(action):
    if isinstance(action, QuenchedSchwingerAction):
        return qoi_2d_susceptibility, "V chi_t"
    if isinstance(action, GFFAction):
        return qoi_2d_phi_squared, "<phi^2>"
    return qoi_magnetic_susceptibility, "chi_m"


def select_cond_factory(action):
    if isinstance(action, QuenchedSchwingerAction):
        return make_schwinger_conditioned_fine_action
    if isinstance(action, GFFAction):
        return GFFConditionedFineAction
    return NonlinearSigmaConditionedFineAction


def analytical_results(action):
    """driver_qft.cc:280-316."""
    if isinstance(action, QuenchedSchwingerAction):
        return {"analytical": action.chit_exact(),
                "perturbative": action.chit_perturbative(),
                "continuum variance": action.chit_continuum_variance()}
    if isinstance(action, GFFAction):
        return {"analytical": action.phi_squared_analytical()}
    return {}


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 1:
        print("Usage: python driver_qft.py <parameters.in>")
        return 1
    config = read_parameter_file(argv[0])
    n_chains, dtype = parallel_setup(config)

    general = Section(config, "general", defaults={"method": "singlelevel"})
    method = general.get_string("method",
                                {"singlelevel", "twolevel", "multilevel"})
    lat_sec = Section(config, "lattice",
                      defaults={"Mt_lat": 16, "Mx_lat": 16,
                                "coarsening": "both"})
    lattice = Lattice2D(lat_sec.get_int("Mt_lat", positive=True),
                        lat_sec.get_int("Mx_lat", positive=True),
                        COARSEN[lat_sec.get_string("coarsening")])
    stats_sec = Section(config, "statistics",
                        defaults={"n_autocorr_window": 20,
                                  "n_min_samples_qoi": 100})
    n_autocorr = stats_sec.get_int("n_autocorr_window", positive=True)
    n_min_samples = stats_sec.get_int("n_min_samples_qoi", positive=True)

    action = build_action(config, lattice)
    qoi_factory, qoi_name = select_qoi(action)
    cond_factory = select_cond_factory(action)
    is_schwinger = isinstance(action, QuenchedSchwingerAction)
    cluster_cls = (QuenchedSchwingerClusterSampler if is_schwinger
                   else None)
    if isinstance(action, NonlinearSigmaAction) and method == "multilevel":
        print("ERROR: multilevel method not supported for the nonlinear "
              "sigma model (matches driver_qft.cc:406-411)")
        return 1

    def sampler_factory_by(name):
        kwargs = {"cond_factory": cond_factory,
                  "qoi_factory": qoi_factory}
        if cluster_cls is not None:
            kwargs["cluster_cls"] = cluster_cls
        return make_sampler_factory(name, config, **kwargs)

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
                                "epsilon": 1e-2, "sampler": "heatbath"})
        factory = sampler_factory_by(sec.get_string("sampler",
                                                    SAMPLER_CHOICES))
        mc = MonteCarloSingleLevel(
            action, qoi_factory(action), factory(action),
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
        if is_schwinger:
            _report_plaquette(action, key, factory, n_chains, dtype)
    elif method == "twolevel":
        sec = Section(config, "twolevelmc",
                      defaults={"n_burnin": 100, "n_samples": 1000,
                                "sampler": "heatbath",
                                "n_coarse_autocorr_window": 20,
                                "n_fine_autocorr_window": 20,
                                "n_delta_autocorr_window": 20})
        factory = sampler_factory_by(sec.get_string("sampler",
                                                    SAMPLER_CHOICES))
        mc = MonteCarloTwoLevel(
            action, qoi_factory, factory, cond_factory,
            n_burnin=sec.get_int("n_burnin", positive=True),
            n_samples=sec.get_int("n_samples", positive=True),
            n_autocorr_window=n_autocorr,
            n_coarse_autocorr_window=sec.get_int(
                "n_coarse_autocorr_window", positive=True),
            n_fine_autocorr_window=sec.get_int(
                "n_fine_autocorr_window", positive=True),
            n_delta_autocorr_window=sec.get_int(
                "n_delta_autocorr_window", positive=True))
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
        coarse_name = Section(
            config, "hierarchical",
            defaults={"coarsesampler": "heatbath",
                      "n_max_level": 3}).get_string("coarsesampler",
                                                    SAMPLER_CHOICES)
        coarse_factory = sampler_factory_by(coarse_name)
        mc = MonteCarloMultiLevel(
            action, qoi_factory, coarse_factory, cond_factory,
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

    print()
    for label, value in analytical_results(action).items():
        print(f" {qoi_name} [{label}]  = {value:.6f}")
    ana = analytical_results(action).get("analytical")
    if ana is not None:
        print(f" |numerical - analytical| = {abs(numerical - ana):.6f}"
              f" = {abs(numerical - ana) / stat_err:.2f} * statistical error")
    return 0


def _report_plaquette(action, key, factory, n_chains, dtype):
    """Short extra average-plaquette measurement for the Schwinger model
    (the reference driver reports both QoIs)."""
    from mlmcpathintegral.utils import statistics as stats_mod
    from mlmcpathintegral.utils.statistics import Statistics
    import jax as _jax

    sampler = factory(action)
    qoi = qoi_avg_plaquette(action)
    state = sampler.prepare(key, n_chains, dtype)
    stats = Statistics("plaq", 20)
    st = stats.init(n_chains, dtype)

    @_jax.jit
    def run(key, state, st):
        def body(carry, k):
            state, st = carry
            state, _ = sampler.draw(k, state)
            st = stats_mod.record(st, qoi(sampler.x_of(state)))
            return (state, st), None
        keys = _jax.random.split(key, 200)
        (state, st), _ = _jax.lax.scan(body, (state, st), keys)
        return st
    st = run(_jax.random.fold_in(key, 1), state, st)
    print(f" avg plaquette = {stats.average(st):.6f} "
          f"+/- {stats.error(st):.6f}")


if __name__ == "__main__":
    sys.exit(main())
