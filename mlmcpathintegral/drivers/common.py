"""Shared driver wiring: sampler factories, parallel setup.

The analog of ``construct_sampler_factory`` in the reference drivers
(driver_qm.cc:37-95) — builds per-action sampler factories from the parsed
config sections so that the multilevel algorithms can instantiate samplers
on any level.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from mlmcpathintegral.samplers.cluster import ClusterSampler
from mlmcpathintegral.samplers.exact import ExactSampler
from mlmcpathintegral.samplers.heatbath import OverrelaxedHeatBathSampler
from mlmcpathintegral.samplers.hierarchical import HierarchicalSampler
from mlmcpathintegral.samplers.hmc import HMCSampler
from mlmcpathintegral.utils.config import Section

SAMPLER_CHOICES = {"HMC", "heatbath", "cluster", "exact", "hierarchical",
                   "multilevel"}


def parallel_setup(config):
    """Optional section of this port: number of chains and dtype (the
    analogue of choosing the number of MPI ranks)."""
    sec = Section(config, "parallel",
                  defaults={"n_chains": 128, "dtype": "float32",
                            "x64": False})
    dtype_name = sec.get_string("dtype", {"float32", "float64"})
    if dtype_name == "float64":
        jax.config.update("jax_enable_x64", True)
    n_chains = sec.get_int("n_chains", positive=True)
    return n_chains, jnp.float64 if dtype_name == "float64" else jnp.float32


def _refuse_removed(config, section: str, instead: str) -> None:
    """``use_pallas`` was the old switch for the samplers' fused kernels;
    a file that still sets it is refused rather than silently run on
    another path."""
    if "use_pallas" in config.get(section, {}):
        raise ValueError(f"{section}.use_pallas was removed: {instead}")


def make_sampler_factory(name: str, config, cond_factory=None,
                         cluster_cls=ClusterSampler, qoi_factory=None):
    """Return ``factory(action) -> Sampler`` for the named sampler type.

    ``cond_factory`` (needed for the hierarchical/multilevel samplers)
    builds the conditioned fine action per level; ``cluster_cls`` lets the
    QFT driver substitute the Schwinger cluster sampler; ``qoi_factory``
    supplies the per-level QoI the multilevel sampler's tau-adaptive walk
    tracks."""
    if name == "HMC":
        _refuse_removed(config, "hmc", "the HMC sampler runs on the XLA "
                        "path only; delete the key")
        sec = Section(config, "hmc",
                      defaults={"nt": 100, "dt": 0.1, "n_rep": 1,
                                "n_burnin": 100})
        return lambda action: HMCSampler(
            action, nt=sec.get_int("nt", positive=True),
            dt=sec.get_float("dt", positive=True),
            n_rep=sec.get_int("n_rep", positive=True),
            n_burnin=sec.get_int("n_burnin", positive=True))
    if name == "heatbath":
        _refuse_removed(config, "heatbath", "set heatbath.fused = cuda "
                        "for the fused sweep of the quenched Schwinger "
                        "model (float32, GPU); other models run on the XLA "
                        "path only")
        sec = Section(config, "heatbath",
                      defaults={"n_sweep_heatbath": 1,
                                "n_sweep_overrelax": 1,
                                "n_burnin": 100, "random_order": True,
                                "fused": "none"})
        fused = sec.get_string("fused", {"none", "cuda", "reference"})
        # the reference's random_order shuffles its sequential site loop
        # (overrelaxedheatbathsampler.cc:8-31); the sweep here is
        # checkerboard-coloured instead (all conflict-free sites update
        # simultaneously), which supersedes any site ordering — honour the
        # key by validating it and telling the user it has no effect here
        if "random_order" in config.get("heatbath", {}):
            sec.get_bool("random_order")
            import warnings
            warnings.warn(
                "heatbath.random_order has no effect: the sweep is "
                "checkerboard-coloured (samplers/heatbath.py), which "
                "replaces the reference's sequential site ordering",
                stacklevel=2)
        return lambda action: OverrelaxedHeatBathSampler(
            action,
            n_sweep_heatbath=sec.get_int("n_sweep_heatbath", positive=True),
            n_sweep_overrelax=sec.get_int("n_sweep_overrelax",
                                          positive=True),
            n_burnin=sec.get_int("n_burnin", positive=True),
            fused=None if fused == "none" else fused)
    if name == "cluster":
        sec = Section(config, "clusteralgorithm",
                      defaults={"n_burnin": 100, "n_updates": 10})
        return lambda action: cluster_cls(
            action, n_burnin=sec.get_int("n_burnin", positive=True),
            n_updates=sec.get_int("n_updates", positive=True))
    if name == "exact":
        return ExactSampler
    if name == "hierarchical":
        sec = Section(config, "hierarchical",
                      defaults={"n_max_level": 3, "coarsesampler": "HMC"})
        coarse_name = sec.get_string("coarsesampler", SAMPLER_CHOICES)
        coarse_factory = make_sampler_factory(coarse_name, config,
                                              cond_factory, cluster_cls,
                                              qoi_factory)
        if cond_factory is None:
            raise ValueError("hierarchical sampler needs a conditioned "
                             "fine action factory")
        return lambda action: HierarchicalSampler(
            action, coarse_factory, cond_factory,
            n_max_level=sec.get_int("n_max_level", positive=True))
    if name == "multilevel":
        from mlmcpathintegral.samplers.multilevel import MultilevelSampler
        sec = Section(config, "hierarchical",
                      defaults={"n_max_level": 3, "coarsesampler": "HMC"})
        coarse_name = sec.get_string("coarsesampler", SAMPLER_CHOICES)
        coarse_factory = make_sampler_factory(coarse_name, config,
                                              cond_factory, cluster_cls,
                                              qoi_factory)
        if cond_factory is None or qoi_factory is None:
            raise ValueError("multilevel sampler needs conditioned fine "
                             "action and QoI factories")
        return lambda action: MultilevelSampler(
            action, qoi_factory, coarse_factory, cond_factory,
            n_max_level=sec.get_int("n_max_level", positive=True))
    raise ValueError(f"unknown sampler '{name}'")
