"""Conditioned fine actions for the quenched Schwinger model.

Reference parity: src/action/qft/quenchedschwingerconditionedfineaction.{hh,cc}
— the most intricate fill-in logic in the reference.  Given coarse links
prolongated onto the fine lattice (each coarse angle split evenly over its
two fine halves), the fill-in runs in three vectorised steps
(cc:7-78; the reference loops cells sequentially but all cells are
conditionally independent given the coarse data):

  STEP 1: randomise the perimeter split — add +-u (uniform) to the two fine
          halves of every coarse link (leaves the coarse sums invariant).
  STEP 2: draw the *sum* of the two interior vertical links of each coarse
          cell from the BesselProduct distribution (beta <= 8) or its
          large-beta Gaussian-mixture approximation, then split uniformly.
  STEP 3: draw every interior horizontal link from ExpCos given the two
          adjacent (now fixed) plaquette staples.

The matching ``evaluate`` forms (cc:212-290) include the exact series
normalisation log Z(Phi) of the BesselProduct — the term whose mismatch
would silently bias the delayed-acceptance chain (SURVEY.md §7).

Semi-coarsened lattices (temporal/spatial/alternate) use the two-step
ExpCos variant (cc:136-209).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from mlmcpathintegral.conditioned.base import ConditionedFineAction
from mlmcpathintegral.distributions.approxbesselproduct import (
    ApproximateBesselProductDistribution,
)
from mlmcpathintegral.distributions.besselproduct import (
    BesselProductDistribution,
)
from mlmcpathintegral.distributions.expcos import ExpCosDistribution
from mlmcpathintegral.lattice2d import CoarseningType
from mlmcpathintegral.utils.special import mod_2pi

PI = math.pi


def _cell(A, a_i, b_j):
    """A(2i + a_i, 2j + b_j) over all coarse cells; A: [..., Mx, Mt] ->
    [..., Mx/2, Mt/2]."""
    out = A
    if a_i:
        out = jnp.roll(out, -a_i, axis=-1)
    if b_j:
        out = jnp.roll(out, -b_j, axis=-2)
    return out[..., ::2, ::2]


def _rowcell(A, a_i, b_j):
    """A(i + a_i, 2j + b_j) over all i and coarse rows; -> [..., Mx/2, Mt]."""
    out = A
    if a_i:
        out = jnp.roll(out, -a_i, axis=-1)
    if b_j:
        out = jnp.roll(out, -b_j, axis=-2)
    return out[..., ::2, :]


class QuenchedSchwingerConditionedFineAction(ConditionedFineAction):
    """Full (both-direction) coarsening fill-in."""

    def __init__(self, action):
        super().__init__(action)
        self.beta = action.beta
        if self.beta > 8.0:
            self.bessel = None
            self.approx = ApproximateBesselProductDistribution(self.beta)
        else:
            self.bessel = BesselProductDistribution(self.beta)
            self.approx = None

    # -- fill (cc:7-78) --------------------------------------------------------

    def fill_fine_points(self, key, theta):
        act = self.action
        lat = act.lattice
        Mt, Mx = lat.Mt_lat, lat.Mx_lat
        k1, k2, k3, k4, k5 = jax.random.split(key, 5)
        g = act._grid(theta)
        T, X = g[..., 0], g[..., 1]
        cshape = (*T.shape[:-2], Mx // 2, Mt // 2)
        dtype = T.dtype

        # STEP 1: perimeter randomisation
        u_t = jax.random.uniform(k1, cshape, dtype, -PI, PI)
        u_x = jax.random.uniform(k2, cshape, dtype, -PI, PI)
        T = T.at[..., ::2, ::2].set(mod_2pi(T[..., ::2, ::2] + u_t))
        T = T.at[..., ::2, 1::2].set(mod_2pi(T[..., ::2, 1::2] - u_t))
        X = X.at[..., ::2, ::2].set(mod_2pi(X[..., ::2, ::2] + u_x))
        X = X.at[..., 1::2, ::2].set(mod_2pi(X[..., 1::2, ::2] - u_x))

        # STEP 2: interior vertical links (sum from BesselProduct, split
        # uniformly)
        theta_p = mod_2pi(_cell(T, 1, 0) + _cell(X, 2, 0)
                          + _cell(X, 2, 1) - _cell(T, 1, 2))
        theta_m = mod_2pi(_cell(X, 0, 0) + _cell(X, 0, 1)
                          + _cell(T, 0, 2) - _cell(T, 0, 0))
        if self.bessel is not None:
            theta_tilde = self.bessel.draw(k3, theta_p, theta_m)
        else:
            theta_tilde = self.approx.draw(k3, theta_p, theta_m)
        u = jax.random.uniform(k4, cshape, dtype, -PI, PI)
        X = X.at[..., ::2, 1::2].set(mod_2pi(0.5 * theta_tilde + u))
        X = X.at[..., 1::2, 1::2].set(mod_2pi(0.5 * theta_tilde - u))

        # STEP 3: interior horizontal links from ExpCos
        tp = mod_2pi(_rowcell(T, 0, 0) + _rowcell(X, 1, 0)
                     - _rowcell(X, 0, 0))
        tm = mod_2pi(_rowcell(X, 0, 1) + _rowcell(T, 0, 2)
                     - _rowcell(X, 1, 1))
        new_T = ExpCosDistribution.draw(k5, self.beta, tp, tm)
        T = T.at[..., 1::2, :].set(new_T)

        return act._flat(jnp.stack([T, X], axis=-1))

    # -- evaluate (cc:212-290) -------------------------------------------------

    def evaluate(self, theta):
        act = self.action
        g = act._grid(theta)
        T, X = g[..., 0], g[..., 1]
        if self.bessel is not None:
            phi_12 = _cell(X, 0, 1) + _cell(T, 0, 2)
            phi_23 = _cell(T, 1, 2) - _cell(X, 2, 1)
            phi_34 = -_cell(T, 1, 0) - _cell(X, 2, 0)
            phi_41 = -_cell(T, 0, 0) + _cell(X, 0, 0)
            th_1 = _cell(T, 0, 1)
            th_2 = -_cell(X, 1, 1)
            th_3 = -_cell(T, 1, 1)
            th_4 = _cell(X, 1, 0)
            Phi = phi_12 + phi_23 + phi_34 + phi_41
            S = -self.beta * jnp.sum(
                jnp.cos(th_1 - th_2 - phi_12) + jnp.cos(th_2 - th_3 - phi_23)
                + jnp.cos(th_3 - th_4 - phi_34)
                + jnp.cos(th_4 - th_1 - phi_41), axis=(-2, -1))
            S = S - jnp.sum(self.bessel.log_Znorm_inv(Phi, rescaled=True),
                            axis=(-2, -1))
            return S
        # large-beta branch: vertical-sum density + horizontal ExpCos terms
        phi_p = mod_2pi(_cell(T, 1, 0) + _cell(X, 2, 0)
                        + _cell(X, 2, 1) - _cell(T, 1, 2))
        phi_m = mod_2pi(-_cell(T, 0, 0) + _cell(X, 0, 0)
                        + _cell(X, 0, 1) + _cell(T, 0, 2))
        th = mod_2pi(_cell(X, 1, 0) + _cell(X, 1, 1))
        S = -jnp.sum(self.approx.log_evaluate(th, phi_p, phi_m),
                     axis=(-2, -1))
        tp = mod_2pi(-_rowcell(X, 0, 0) + _rowcell(T, 0, 0)
                     + _rowcell(X, 1, 0))
        tm = mod_2pi(_rowcell(X, 0, 1) + _rowcell(T, 0, 2)
                     - _rowcell(X, 1, 1))
        th_h = mod_2pi(_rowcell(T, 0, 1))
        S = S - jnp.sum(ExpCosDistribution.log_evaluate(
            th_h, self.beta, tp, tm), axis=(-2, -1))
        return S


class QuenchedSchwingerGaussianConditionedFineAction(ConditionedFineAction):
    """Gaussian-approximation variant: all four interior links of each
    coarse cell drawn at once from the 4-D GaussianFillinDistribution
    (cc:81-133, 293-326)."""

    def __init__(self, action):
        super().__init__(action)
        from mlmcpathintegral.distributions.gaussianfillin import (
            GaussianFillinDistribution,
        )
        self.beta = action.beta
        self.gaussian = GaussianFillinDistribution(self.beta,
                                                   add_gaussian_noise=True)

    def _cell_phis(self, T, X):
        phi_12 = mod_2pi(_cell(X, 0, 1) + _cell(T, 0, 2))
        phi_23 = mod_2pi(_cell(T, 1, 2) - _cell(X, 2, 1))
        phi_34 = mod_2pi(-_cell(X, 2, 0) - _cell(T, 1, 0))
        phi_41 = mod_2pi(-_cell(T, 0, 0) + _cell(X, 0, 0))
        return phi_12, phi_23, phi_34, phi_41

    def fill_fine_points(self, key, theta):
        act = self.action
        lat = act.lattice
        Mt, Mx = lat.Mt_lat, lat.Mx_lat
        k1, k2, k3 = jax.random.split(key, 3)
        g = act._grid(theta)
        T, X = g[..., 0], g[..., 1]
        cshape = (*T.shape[:-2], Mx // 2, Mt // 2)
        dtype = T.dtype

        # STEP 1: perimeter randomisation (identical to the exact variant)
        u_t = jax.random.uniform(k1, cshape, dtype, -PI, PI)
        u_x = jax.random.uniform(k2, cshape, dtype, -PI, PI)
        T = T.at[..., ::2, ::2].set(mod_2pi(T[..., ::2, ::2] + u_t))
        T = T.at[..., ::2, 1::2].set(mod_2pi(T[..., ::2, 1::2] - u_t))
        X = X.at[..., ::2, ::2].set(mod_2pi(X[..., ::2, ::2] + u_x))
        X = X.at[..., 1::2, ::2].set(mod_2pi(X[..., 1::2, ::2] - u_x))

        # STEP 2+3: joint interior fill from the 4-D Gaussian approximation
        phi_12, phi_23, phi_34, phi_41 = self._cell_phis(T, X)
        th1, th2, th3, th4 = self.gaussian.draw(k3, phi_12, phi_23,
                                                phi_34, phi_41)
        T = T.at[..., 1::2, ::2].set(th1)        # T(2i, 2j+1)   = +theta_1
        X = X.at[..., 1::2, 1::2].set(-th2)      # X(2i+1, 2j+1) = -theta_2
        T = T.at[..., 1::2, 1::2].set(-th3)      # T(2i+1, 2j+1) = -theta_3
        X = X.at[..., ::2, 1::2].set(th4)        # X(2i+1, 2j)   = +theta_4
        return act._flat(jnp.stack([T, X], axis=-1))

    def evaluate(self, theta):
        act = self.action
        g = act._grid(theta)
        T, X = g[..., 0], g[..., 1]
        phi_12, phi_23, phi_34, phi_41 = self._cell_phis(T, X)
        th1 = mod_2pi(_cell(T, 0, 1))
        th2 = mod_2pi(-_cell(X, 1, 1))
        th3 = mod_2pi(-_cell(T, 1, 1))
        th4 = mod_2pi(_cell(X, 1, 0))
        return -jnp.sum(self.gaussian.log_evaluate(
            th1, th2, th3, th4, phi_12, phi_23, phi_34, phi_41),
            axis=(-2, -1))


class QuenchedSchwingerSemiConditionedFineAction(ConditionedFineAction):
    """Fill-in for temporal- or spatial-only coarsening (cc:136-209)."""

    def __init__(self, action):
        super().__init__(action)
        self.beta = action.beta
        self.case = action._coarsen_case()
        if self.case not in ("temporal", "spatial"):
            raise ValueError("semi fill-in needs temporal/spatial coarsening")

    def fill_fine_points(self, key, theta):
        act = self.action
        lat = act.lattice
        Mt, Mx = lat.Mt_lat, lat.Mx_lat
        k1, k2 = jax.random.split(key)
        g = act._grid(theta)
        T, X = g[..., 0], g[..., 1]
        dtype = T.dtype
        if self.case == "temporal":
            # randomise the split of every coarse temporal link
            u = jax.random.uniform(k1, (*T.shape[:-2], Mx, Mt // 2), dtype,
                                   -PI, PI)
            T = T.at[..., :, ::2].set(mod_2pi(T[..., :, ::2] + u))
            T = T.at[..., :, 1::2].set(mod_2pi(T[..., :, 1::2] - u))
            # interior spatial links X(2i+1, j) from ExpCos

            def colcell(A, a_i, b_j):
                """A(2i + a_i, j + b_j): [..., Mx, Mt/2]."""
                out = A
                if a_i:
                    out = jnp.roll(out, -a_i, axis=-1)
                if b_j:
                    out = jnp.roll(out, -b_j, axis=-2)
                return out[..., :, ::2]

            tp = mod_2pi(colcell(X, 0, 0) + colcell(T, 0, 1)
                         - colcell(T, 0, 0))
            tm = mod_2pi(colcell(T, 1, 0) + colcell(X, 2, 0)
                         - colcell(T, 1, 1))
            new_X = ExpCosDistribution.draw(k2, self.beta, tp, tm)
            X = X.at[..., :, 1::2].set(new_X)
        else:  # spatial
            u = jax.random.uniform(k1, (*X.shape[:-2], Mx // 2, Mt), dtype,
                                   -PI, PI)
            X = X.at[..., ::2, :].set(mod_2pi(X[..., ::2, :] + u))
            X = X.at[..., 1::2, :].set(mod_2pi(X[..., 1::2, :] - u))
            # interior temporal links T(i, 2j+1) from ExpCos
            tp = mod_2pi(_rowcell(T, 0, 0) + _rowcell(X, 1, 0)
                         - _rowcell(X, 0, 0))
            tm = mod_2pi(_rowcell(X, 0, 1) + _rowcell(T, 0, 2)
                         - _rowcell(X, 1, 1))
            new_T = ExpCosDistribution.draw(k2, self.beta, tp, tm)
            T = T.at[..., 1::2, :].set(new_T)
        return act._flat(jnp.stack([T, X], axis=-1))

    def evaluate(self, theta):
        act = self.action
        g = act._grid(theta)
        T, X = g[..., 0], g[..., 1]
        if self.case == "temporal":
            def colcell(A, a_i, b_j):
                out = A
                if a_i:
                    out = jnp.roll(out, -a_i, axis=-1)
                if b_j:
                    out = jnp.roll(out, -b_j, axis=-2)
                return out[..., :, ::2]

            phi_p = mod_2pi(-colcell(T, 0, 0) + colcell(X, 0, 0)
                            + colcell(T, 0, 1))
            phi_m = mod_2pi(colcell(T, 1, 0) + colcell(X, 2, 0)
                            - colcell(T, 1, 1))
            th = mod_2pi(colcell(X, 1, 0))
            return -jnp.sum(ExpCosDistribution.log_evaluate(
                th, self.beta, phi_p, phi_m), axis=(-2, -1))
        phi_p = mod_2pi(-_rowcell(X, 0, 0) + _rowcell(T, 0, 0)
                        + _rowcell(X, 1, 0))
        phi_m = mod_2pi(_rowcell(X, 0, 1) + _rowcell(T, 0, 2)
                        - _rowcell(X, 1, 1))
        th = mod_2pi(_rowcell(T, 0, 1))
        return -jnp.sum(ExpCosDistribution.log_evaluate(
            th, self.beta, phi_p, phi_m), axis=(-2, -1))


def make_schwinger_conditioned_fine_action(action) -> ConditionedFineAction:
    """Factory by coarsening type
    (quenchedschwingerconditionedfineaction.hh:215-238)."""
    if action.lattice.coarsening_type is CoarseningType.BOTH:
        return QuenchedSchwingerConditionedFineAction(action)
    return QuenchedSchwingerSemiConditionedFineAction(action)
