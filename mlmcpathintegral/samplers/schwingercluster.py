"""Exact cluster sampler for the quenched Schwinger model.

Reference parity: src/sampler/quenchedschwingerclustersampler.{hh,cc}.
Exploits the equivalence plaquettes <-> 1-D rotor increments: the joint
distribution of the Mt*Mx plaquette angles equals that of the increments of
a topological rotor with M = Mt*Mx sites and I = beta * a (a = 1/M).  A
1-D Wolff cluster sampler generates the rotor path; links are reconstructed
in a fixed gauge (integrate the increments into vertical links column-wise,
close the last row horizontally) and a random gauge transformation restores
gauge invariance (quenchedschwingerclustersampler.cc:40-86).

Batched design: the sequential link integrations become cumulative sums over the
grid; the gauge transformation is a roll stencil.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp

from mlmcpathintegral.lattice import Lattice1D
from mlmcpathintegral.models.base import RenormalisationType
from mlmcpathintegral.models.rotor import RotorAction
from mlmcpathintegral.samplers.base import Sampler, default_dtype
from mlmcpathintegral.samplers.cluster import ClusterSampler, ClusterState
from mlmcpathintegral.utils.special import mod_2pi


class SchwingerClusterState(NamedTuple):
    x: jnp.ndarray            # [C, 2*Mt*Mx] current link state
    psi: jnp.ndarray          # [C, Mt*Mx] rotor path


class QuenchedSchwingerClusterSampler(Sampler):
    """Hybrid exact sampler: Wolff clusters on the equivalent rotor path
    move the TOPOLOGICAL sector in O(1) updates, then ``n_mix_sweeps``
    overrelaxation + heat-bath sweeps on the reconstructed links move the
    SMOOTH plaquette modes (which near-global clusters barely touch — a
    whole-ring flip is close to an exact symmetry).  Both kernels
    preserve the same equilibrium (the plaquette joint equals the rotor
    increment joint, verified to 3e-15), so the composition does too, and
    every mode decorrelates in a few draws.

    This matters for delayed acceptance: subsampling the coarse chain by
    the QoI's tau_int assumes the QoI is the SLOWEST mode.  For the pure
    cluster chain topology is the fastest mode and the smooth
    configuration the slowest, so tau(chi_t)-based subsampling left
    proposals correlated and measurably biased the screened fine chain
    (+0.6% / 6 sigma at 8x8 beta=4, -2% at 32x32 beta=16 — the
    reference's subsampling rule, montecarlotwolevel.cc:82-94, shares
    this blind spot with its own cluster sampler).  With the mixing
    sweeps (default 1) the bias is gone at the same cost scale; the
    subsample clock additionally watches the plaquette energy
    (``subsample_observable``).
    """

    def __init__(self, action, n_burnin: int = 100, n_updates: int = 10,
                 n_mix_sweeps: int = 1):
        super().__init__(action)
        lat = action.lattice
        M = lat.Mt_lat * lat.Mx_lat
        lattice1d = Lattice1D(M, 1.0)
        self.rotor_action = RotorAction(lattice1d, RenormalisationType.NONE,
                                        m0=action.beta * lattice1d.a_lat)
        self.cluster = ClusterSampler(self.rotor_action, n_burnin=n_burnin,
                                      n_updates=n_updates)
        self.n_mix_sweeps = int(n_mix_sweeps)

    def init(self, key, n_chains, dtype=None):
        dtype = dtype or default_dtype()
        k1, k2 = jax.random.split(key)
        psi = self.rotor_action.initialise_state(k1, n_chains, dtype)
        x = self._reconstruct(k2, psi)
        return SchwingerClusterState(x=x, psi=psi)

    def prepare(self, key, n_chains, dtype=None):
        k1, k2 = jax.random.split(key)
        cs = self.cluster.prepare(k1, n_chains, dtype)
        x = self._reconstruct(k2, cs.x)
        return SchwingerClusterState(x=x, psi=cs.x)

    def subsample_observable(self, x):
        """Slow-mode clock for tau-based coarse subsampling: the average
        plaquette energy (the smooth modes are the slowest under cluster
        updates; chi_t is the fastest and underestimates tau)."""
        return jnp.mean(jnp.cos(self.action.plaquette_angles(x)),
                        axis=(-2, -1))

    def _psi_from_links(self, key, x):
        """Rebuild the rotor path from the links' plaquette angles:
        d[i*Mx+j] = P[j,i] (verified exact round trip), psi = cumsum with
        a uniform global rotation (the rotor measure is uniform in it)."""
        lat = self.action.lattice
        C = x.shape[0]
        P = self.action.plaquette_angles(x)          # [C, Mx, Mt]
        d = jnp.swapaxes(P, -1, -2).reshape(C, -1)   # walk order
        psi = jnp.cumsum(d, axis=-1)
        psi = jnp.concatenate(
            [jnp.zeros((C, 1), x.dtype), psi[:, :-1]], axis=-1)
        c = jax.random.uniform(key, (C, 1), x.dtype, -math.pi, math.pi)
        return mod_2pi(psi + c)

    def draw(self, key, state: SchwingerClusterState):
        k1, k2, k3, k4 = jax.random.split(key, 4)
        cs, _ = self.cluster.draw(k1, ClusterState(x=state.psi))
        psi = cs.x
        x = self._reconstruct(k2, psi)
        if self.n_mix_sweeps > 0:
            act = self.action
            for i in range(self.n_mix_sweeps):
                x = act.overrelaxation_sweep(x)
                x = act.heatbath_sweep(jax.random.fold_in(k3, i), x)
            psi = self._psi_from_links(k4, x)
        accept = jnp.ones(x.shape[:-1], bool)
        return SchwingerClusterState(x=x, psi=psi), accept

    # -- link reconstruction (quenchedschwingerclustersampler.cc:40-86) --------

    def _reconstruct(self, key, psi):
        lat = self.action.lattice
        Mt, Mx = lat.Mt_lat, lat.Mx_lat
        C = psi.shape[0]
        dtype = psi.dtype
        # increments d[l] = psi[l+1] - psi[l] on the linear index
        # l = i * Mx + j (i = temporal row of the walk)
        d = jnp.roll(psi, -1, axis=-1) - psi     # [C, Mt*Mx]
        dg = d.reshape(C, Mt, Mx)                # [C, i, j]

        # vertical links: X(i, j) = sum_{k < i} d[k, j], X(0, j) = 0
        X_it = jnp.cumsum(dg, axis=-2)           # partial sums over i
        X_it = jnp.concatenate(
            [jnp.zeros((C, 1, Mx), dtype), X_it[:, :-1, :]], axis=-2)
        # X_it[i, j] with i the temporal index; grid layout is [j, i]
        X = jnp.swapaxes(X_it, -1, -2)           # [C, Mx, Mt] = [j, i]

        # horizontal links: all zero except the last temporal row i = Mt-1:
        # T(Mt-1, j+1) = T(Mt-1, j) - X(Mt-1, j) - d[(Mt-1)*Mx + j]
        inc = -(X_it[:, Mt - 1, :] + dg[:, Mt - 1, :])      # [C, Mx] over j
        T_last = jnp.cumsum(inc, axis=-1)
        T_last = jnp.concatenate(
            [jnp.zeros((C, 1), dtype), T_last[:, :-1]], axis=-1)  # T(.,0)=0
        T = jnp.zeros((C, Mx, Mt), dtype)
        T = T.at[:, :, Mt - 1].set(T_last)

        # random gauge transformation: theta(i, j) per site;
        # T(i,j) += theta(i,j) - theta(i+1,j); X(i,j) += theta(i,j) - theta(i,j+1)
        k_th, k_ph = jax.random.split(key)
        th = jax.random.uniform(k_th, (C, Mx, Mt), dtype, -math.pi, math.pi)
        T = mod_2pi(T + th - jnp.roll(th, -1, axis=-1))
        X = mod_2pi(X + th - jnp.roll(th, -1, axis=-2))

        # randomise the two torus Wilson-line phases: the link measure
        # factorises as (plaquettes) x (gauge orbit) x (2 global phases,
        # uniform); the reconstruction pins the phases to functions of
        # the rotor path and gauge transformations cannot move them
        # (periodic theta telescopes to zero around a cycle).  Plaquette
        # observables are blind to this, but as a COARSE PROPOSAL inside
        # the delayed-acceptance screen the pinned phases make the
        # proposal density differ from exp(-S_c) d(links), biasing the
        # screened fine chain (measured: chi_t 3 sigma low at 32x32
        # beta=16).  A uniform shift u/Mt on every temporal link (and
        # u'/Mx on every spatial link) leaves all plaquettes unchanged
        # and makes the phases uniform.  The reference omits this
        # (quenchedschwingerclustersampler.cc:70-82).
        u = jax.random.uniform(k_ph, (C, 1, 1, 2), dtype,
                               -math.pi, math.pi)
        T = mod_2pi(T + u[..., 0] / Mt)
        X = mod_2pi(X + u[..., 1] / Mx)

        g = jnp.stack([T, X], axis=-1)           # [C, Mx, Mt, 2]
        return g.reshape(C, 2 * Mt * Mx)
