"""Quenched Schwinger model: compact U(1) gauge theory on a 2-D lattice.

S[theta] = beta sum_P (1 - cos theta_P), with plaquette angle
theta_P(i,j) = theta_0(i,j) + theta_1(i+1,j) - theta_0(i,j+1) - theta_1(i,j)
(reference: src/action/qft/quenchedschwingeraction.{hh,cc}, evaluate
cc:6-22).

Batched layout: link states are flat [C, 2*Mt*Mx] arrays in the
reference's linear layout ell = 2*Mt*j + 2*i + mu (lattice2d.hh:348-365),
reshaped internally to a [C, Mx, Mt, 2] grid so plaquettes, forces, staples
and the 4-colour heat-bath sweeps are pure jnp.roll stencils — no gathers.

The link heat bath / overrelaxation updates one (mu, parity) group at a
time: temporal links theta_0(i,j) of rows with equal j-parity share no
plaquette, spatial links theta_1(i,j) of columns with equal i-parity share
no plaquette, so each quarter-sweep is an exact product of independent
conditional ExpCos draws (cf. quenchedschwingeraction.cc:25-66, which
sweeps links sequentially).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from mlmcpathintegral.distributions.expcos import ExpCosDistribution
from mlmcpathintegral.lattice2d import CoarseningType, Lattice2D
from mlmcpathintegral.models.base import Action, RenormalisationType
from mlmcpathintegral.utils.special import (
    Phi_chit, Phi_chit_perturbative, Sigma_hat, mod_2pi,
)


class QuenchedSchwingerAction(Action):

    def __init__(self, lattice: Lattice2D, beta: float,
                 renormalisation: RenormalisationType =
                 RenormalisationType.NONE):
        if lattice.rotated:
            raise ValueError("gauge links need an unrotated lattice "
                             "(lattice2d.hh:348-351)")
        self.lattice = lattice
        self.beta = float(beta)
        self.renormalisation = renormalisation

    @property
    def ndof(self) -> int:
        return self.lattice.nedges

    @property
    def n_plaq(self) -> int:
        return self.lattice.Mt_lat * self.lattice.Mx_lat

    # -- layout helpers --------------------------------------------------------

    def _grid(self, theta):
        """[..., 2*Mt*Mx] -> [..., Mx, Mt, 2] with [..., j, i, mu]."""
        Mt, Mx = self.lattice.Mt_lat, self.lattice.Mx_lat
        return theta.reshape(*theta.shape[:-1], Mx, Mt, 2)

    def _flat(self, grid):
        Mt, Mx = self.lattice.Mt_lat, self.lattice.Mx_lat
        return grid.reshape(*grid.shape[:-3], 2 * Mt * Mx)

    def plaquette_angles(self, theta):
        """theta_P on the [..., Mx, Mt] plaquette grid."""
        g = self._grid(theta)
        T, X = g[..., 0], g[..., 1]
        # theta_1(i+1, j): shift i by +1 -> roll -1 along the i axis (-1)
        # theta_0(i, j+1): shift j by +1 -> roll -1 along the j axis (-2)
        return (T + jnp.roll(X, -1, axis=-1)
                - jnp.roll(T, -1, axis=-2) - X)

    # -- action ----------------------------------------------------------------

    def evaluate(self, theta):
        plaq = self.plaquette_angles(theta)
        return self.beta * jnp.sum(1.0 - jnp.cos(plaq), axis=(-2, -1))

    def force(self, theta):
        """dS/dtheta via the plaquette membership pattern
        (quenchedschwingeraction.cc:69-91); equals grad(evaluate)."""
        s = self.beta * jnp.sin(self.plaquette_angles(theta))
        # F_T(i,j) = s(i,j) - s(i,j-1);  F_X(i,j) = s(i-1,j) - s(i,j)
        F_T = s - jnp.roll(s, 1, axis=-2)
        F_X = jnp.roll(s, 1, axis=-1) - s
        return self._flat(jnp.stack([F_T, F_X], axis=-1))

    def initialise_state(self, key, n_chains, dtype=None):
        if dtype is None:
            dtype = jnp.zeros(0).dtype
        return jax.random.uniform(key, (n_chains, self.ndof), dtype,
                                  -math.pi, math.pi)

    # -- staples and link sweeps -----------------------------------------------

    @staticmethod
    def _sh(A, di, dj):
        """A(i+di, j+dj) on the grid [..., j, i]."""
        out = A
        if di:
            out = jnp.roll(out, -di, axis=-1)
        if dj:
            out = jnp.roll(out, -dj, axis=-2)
        return out

    def staple_angles_mu(self, theta, mu: int):
        """(theta_p, theta_m) for the links of one direction only, shape
        [..., Mx, Mt] — half the work of :meth:`staple_angles` when a sweep
        only updates one orientation."""
        g = self._grid(theta)
        T, X = g[..., 0], g[..., 1]
        sh = self._sh
        if mu == 0:   # temporal link at (i, j)
            tp = mod_2pi(sh(T, 0, 1) + X - sh(X, 1, 0))
            tm = mod_2pi(sh(T, 0, -1) + sh(X, 1, -1) - sh(X, 0, -1))
        else:         # spatial link at (i, j)
            tp = mod_2pi(T + sh(X, 1, 0) - sh(T, 0, 1))
            tm = mod_2pi(sh(T, -1, 1) + sh(X, -1, 0) - sh(T, -1, 0))
        return tp, tm

    def staple_angles(self, theta):
        """(theta_p, theta_m) for every link, each of shape
        [..., Mx, Mt, 2] (quenchedschwingeraction.cc:25-44)."""
        tp0, tm0 = self.staple_angles_mu(theta, 0)
        tp1, tm1 = self.staple_angles_mu(theta, 1)
        theta_p = jnp.stack([tp0, tp1], axis=-1)
        theta_m = jnp.stack([tm0, tm1], axis=-1)
        return theta_p, theta_m

    def _link_groups(self):
        """Four conflict-free (mu, parity) groups for the sweeps."""
        return [(0, 0), (0, 1), (1, 0), (1, 1)]

    @staticmethod
    def _group_sel(mu: int, parity: int):
        """Selector into a [..., Mx, Mt] per-direction grid for one of the
        4 conflict-free (mu, parity) groups."""
        if mu == 0:   # temporal links grouped by j parity (axis -2)
            return (Ellipsis, slice(parity, None, 2), slice(None))
        return (Ellipsis, slice(None), slice(parity, None, 2))

    def heatbath_sweep(self, key, theta):
        """One full heat-bath sweep over all links, in 4 conflict-free
        quarter-sweeps of batched ExpCos draws.  The rejection loop is
        truncated (stragglers keep the current link — exact identity
        mixture), and only the active direction's staples are computed."""
        keys = jax.random.split(key, 4)
        for (mu, parity), k in zip(self._link_groups(), keys):
            g = self._grid(theta)
            theta_p, theta_m = self.staple_angles_mu(theta, mu)
            sel = self._group_sel(mu, parity)
            tp, tm = theta_p[sel], theta_m[sel]
            cur = g[sel + (mu,)]
            new = ExpCosDistribution.draw(k, self.beta, tp, tm,
                                          fallback=cur, max_iter=6)
            g = g.at[sel + (mu,)].set(new)
            theta = self._flat(g)
        return theta

    def overrelaxation_sweep(self, theta):
        """theta -> mod_2pi(theta_p + theta_m - theta) per link
        (quenchedschwingeraction.cc:57-66), in the same 4 groups."""
        for (mu, parity) in self._link_groups():
            g = self._grid(theta)
            theta_p, theta_m = self.staple_angles_mu(theta, mu)
            sel = self._group_sel(mu, parity)
            new = mod_2pi(theta_p[sel] + theta_m[sel] - g[sel + (mu,)])
            g = g.at[sel + (mu,)].set(new)
            theta = self._flat(g)
        return theta

    # -- multigrid transfer (quenchedschwingeraction.cc:92-195) ----------------

    def _coarsen_case(self):
        lat = self.lattice
        clat = lat.coarse_lattice()
        if clat.Mt_lat == lat.Mt_lat // 2 and clat.Mx_lat == lat.Mx_lat // 2:
            return "both"
        if clat.Mt_lat == lat.Mt_lat // 2 and clat.Mx_lat == lat.Mx_lat:
            return "temporal"
        if clat.Mt_lat == lat.Mt_lat and clat.Mx_lat == lat.Mx_lat // 2:
            return "spatial"
        raise ValueError("cannot map links between these lattices")

    def prolongate(self, theta_coarse, theta_fine):
        """Split each coarse link angle over the two fine links it covers
        (in halved directions) or inject it (in kept directions)."""
        case = self._coarsen_case()
        lat = self.lattice
        clat = lat.coarse_lattice()
        gc = theta_coarse.reshape(*theta_coarse.shape[:-1],
                                  clat.Mx_lat, clat.Mt_lat, 2)
        gf = self._grid(theta_fine)
        Tc, Xc = gc[..., 0], gc[..., 1]
        if case == "both":
            half_T = 0.5 * Tc
            gf = gf.at[..., ::2, ::2, 0].set(half_T)
            gf = gf.at[..., ::2, 1::2, 0].set(half_T)
            half_X = 0.5 * Xc
            gf = gf.at[..., ::2, ::2, 1].set(half_X)
            gf = gf.at[..., 1::2, ::2, 1].set(half_X)
        elif case == "temporal":
            half_T = 0.5 * Tc
            gf = gf.at[..., :, ::2, 0].set(half_T)
            gf = gf.at[..., :, 1::2, 0].set(half_T)
            gf = gf.at[..., :, ::2, 1].set(Xc)
        else:  # spatial
            gf = gf.at[..., ::2, :, 0].set(Tc)
            half_X = 0.5 * Xc
            gf = gf.at[..., ::2, :, 1].set(half_X)
            gf = gf.at[..., 1::2, :, 1].set(half_X)
        return self._flat(gf)

    def restrict(self, theta_fine):
        """Sum fine link pairs along halved directions, mod 2 pi
        (quenchedschwingeraction.cc:148-195)."""
        case = self._coarsen_case()
        gf = self._grid(theta_fine)
        T, X = gf[..., 0], gf[..., 1]
        if case == "both":
            Tc = mod_2pi(T[..., ::2, ::2] + T[..., ::2, 1::2])
            Xc = mod_2pi(X[..., ::2, ::2] + X[..., 1::2, ::2])
        elif case == "temporal":
            Tc = mod_2pi(T[..., :, ::2] + T[..., :, 1::2])
            Xc = mod_2pi(X[..., :, ::2])
        else:  # spatial
            Tc = mod_2pi(T[..., ::2, :])
            Xc = mod_2pi(X[..., ::2, :] + X[..., 1::2, :])
        out = jnp.stack([Tc, Xc], axis=-1)
        return out.reshape(*out.shape[:-3], -1)

    # -- renormalisation (quenchedschwingerrenormalisation.{hh,cc}) ------------

    def coarse_action(self) -> "QuenchedSchwingerAction":
        return QuenchedSchwingerAction(self.lattice.coarse_lattice(),
                                       self.beta_coarse(),
                                       self.renormalisation)

    def beta_coarse(self) -> float:
        ct = self.lattice.coarsening_type
        if ct not in (CoarseningType.BOTH, CoarseningType.TEMPORAL,
                      CoarseningType.SPATIAL, CoarseningType.ALTERNATE):
            raise ValueError("invalid coarsening type for gauge "
                             "renormalisation")
        both = self._coarsen_case() == "both"
        rho = 0.25 if both else 0.5
        raw = rho * self.beta
        # reference parity: both renormalised rules fall back to the raw
        # coupling for beta <= 4 (quenchedschwingerrenormalisation.hh:68-80)
        if (self.renormalisation is RenormalisationType.NONE
                or self.beta <= 4.0):
            return raw
        if self.renormalisation is RenormalisationType.PERTURBATIVE:
            delta = 1.5 if both else 0.5
            return rho * (1.0 + delta / self.beta) * self.beta
        # nonperturbative: match V chi_t across levels by bisection
        # (quenchedschwingerrenormalisation.cc:7-64; scipy replaces GSL)
        from scipy import optimize
        rho_refine = 4 if both else 2
        P = self.n_plaq

        def f_root(x):
            return (chit_analytical(x * self.beta, P // rho_refine)
                    - chit_analytical(self.beta, P))

        # robust bracketing: scan a log grid for a sign change instead of
        # testing only the extreme endpoints (the reference tests only
        # x=0.01 and x=2, quenchedschwingerrenormalisation.cc:26-40);
        # Phi_chit's quadrature is noisy at x*beta << 1, so an endpoint
        # test can miss an interior root and silently fall back
        import numpy as _np
        xs = _np.geomspace(0.02, 2.0, 49)
        fs = [f_root(x) for x in xs]
        x = None
        for i in range(len(xs) - 1, 0, -1):   # prefer the root nearest 2
            if fs[i - 1] == 0.0:
                x = xs[i - 1]
                break
            if fs[i - 1] * fs[i] < 0:
                x = optimize.bisect(f_root, xs[i - 1], xs[i], rtol=1e-12,
                                    maxiter=100)
                break
        if x is None:
            x = 0.25 if both else 0.5         # raw-coupling fallback
        return x * self.beta

    # -- analytics (qoi2dsusceptibility.cc:30-50) ------------------------------

    def chit_exact(self) -> float:
        return chit_analytical(self.beta, self.n_plaq)

    def chit_perturbative(self) -> float:
        return chit_perturbative(self.beta, self.n_plaq)

    def chit_continuum_variance(self) -> float:
        return chit_var_continuum(self.beta, self.n_plaq)

    def info_string(self):
        return f"QuenchedSchwinger({self.lattice}, beta={self.beta})"


def chit_analytical(beta: float, n_plaq: int) -> float:
    """V chi_t = (P/beta) Phi(beta, P) (qoi2dsusceptibility.cc:30-34)."""
    return n_plaq / beta * Phi_chit(beta, n_plaq)


def chit_perturbative(beta: float, n_plaq: int) -> float:
    return n_plaq / beta * Phi_chit_perturbative(beta, n_plaq)


def chit_var_continuum(beta: float, n_plaq: int) -> float:
    """Continuum variance of V chi_t (qoi2dsusceptibility.cc:43-50)."""
    zeta = 4.0 * math.pi**2 * beta / n_plaq
    S2 = Sigma_hat(zeta, 2)
    S4 = Sigma_hat(zeta, 4)
    return S4 - S2 * S2
