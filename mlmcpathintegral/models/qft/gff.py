"""Gaussian Free Field on a 2-D periodic lattice.

S[phi] = 1/2 phi^T Q phi with the 5-point stencil Q = (4+mu2) I - sum of
nearest-neighbour shifts, mu2 = a^2 m^2 and a = 1/Mt (unrotated) or
sqrt(2)/Mt (rotated) — reference: src/action/qft/gffaction.{hh,cc}
(stencil gffaction.cc:7-29, a_lat rule gffaction.hh:174-180).

Batched exact sampler: the reference draws by sparse-Cholesky triangular
solve (gffaction.cc:133-213).  Here the unrotated draw is *spectral*:
phi = Re[ifft2(fft2(z) / sqrt(lambda))] with lambda the stencil symbol —
exact for this translation-invariant periodic operator, O(N log N), batched
over chains, all dense device work.  Rotated lattices (whose vertex set is not
an axis-aligned torus) use a dense host-precomputed inverse Cholesky factor
applied as one [C,N]x[N,N] matmul — dense and exact.

Gibbs-smoothed effective coarse action (gffaction.cc:45-65, 133-174): the
reference smooths exact draws with *lexicographic* SOR-Gibbs sweeps w.r.t.
a 9-point effective action and evaluates with the matching smoothed
precision matrix Q_hat.  A lexicographic sweep is sequential poison on
SIMD hardware, so this implementation uses *red/black* SOR-Gibbs sweeps —
any linear-Gaussian sweep whose stationary law is N(0, Q_eff^-1) yields
phi ~ N(0, Sigma_eff + G^k (Sigma - Sigma_eff) G^k^T) for its own iteration
matrix G, so Q_hat is computed (dense, host-side, once) for the red/black
ordering and draw/evaluate stay exactly consistent.
"""

from __future__ import annotations

import math
from functools import cached_property

import jax
import jax.numpy as jnp
import numpy as np

from mlmcpathintegral.lattice2d import CoarseningType, Lattice2D
from mlmcpathintegral.models.base import Action, RenormalisationType


class GFFAction(Action):

    def __init__(self, lattice: Lattice2D, mass: float,
                 n_gibbs_smooth: int = 0, omega: float = 1.0):
        self.lattice = lattice
        self.mass = float(mass)
        self.n_gibbs_smooth = int(n_gibbs_smooth)
        self.omega = float(omega)
        self.renormalisation = RenormalisationType.NONE
        if self.n_gibbs_smooth > 0 and lattice.nvertices > 4096:
            import warnings
            warnings.warn(
                f"GFFAction: n_gibbs_smooth={n_gibbs_smooth} on a "
                f"{lattice.nvertices}-vertex lattice — the smoothed Q_hat "
                f"is dense, so heat-bath/overrelaxation sweeps become an "
                f"O(N^2) sequential Gibbs scan (_dense_gibbs_sweep).  The "
                f"smoothed action is intended for COARSE levels "
                f"(gffaction.hh:201-208); use n_gibbs_smooth=0 on fine "
                f"lattices.", stacklevel=2)
        if lattice.rotated:
            self.a_lat = math.sqrt(2.0) / lattice.Mt_lat
        else:
            self.a_lat = 1.0 / lattice.Mt_lat
        self.mu2 = self.a_lat * self.a_lat * self.mass * self.mass

    @property
    def ndof(self) -> int:
        return self.lattice.nvertices

    # -- index helpers ---------------------------------------------------------

    @cached_property
    def _nn(self) -> np.ndarray:
        """[N, 4] nearest-neighbour gather indices."""
        return self.lattice.neighbour_vertices[:, :4]

    @cached_property
    def _nn8(self) -> np.ndarray:
        return self.lattice.neighbour_vertices

    @cached_property
    def _colour_masks(self):
        """Red/black split such that all 4 nearest neighbours of a site have
        the other colour: (i+j)%2 on unrotated lattices, i%2 on rotated."""
        ell = np.arange(self.lattice.nvertices)
        i, j = self.lattice.vertex_lin2cart(ell)
        if self.lattice.rotated:
            red = (i % 2 == 0)
        else:
            red = ((i + j) % 2 == 0)
        return np.flatnonzero(red), np.flatnonzero(~red)

    def _nbsum(self, phi):
        """Sum of the 4 nearest neighbours, [..., N].

        Unrotated lattices use a gather-free grid form (reshape to
        [..., Mx, Mt] + four periodic rolls): the neighbour-table gather
        materialises a [..., N, 4] tensor, which on the batched
        two-level screen's [S, C, N] proposals is gigabytes of HBM
        traffic per chunk and dominated the whole GFF two-level run
        (measured ~160 ms/chunk vs ~3 ms for the stencil form)."""
        lat = self.lattice
        if not lat.rotated:
            Mt, Mx = lat.Mt_lat, lat.Mx_lat
            g = phi.reshape(phi.shape[:-1] + (Mx, Mt))
            s = (jnp.roll(g, 1, -1) + jnp.roll(g, -1, -1)
                 + jnp.roll(g, 1, -2) + jnp.roll(g, -1, -2))
            return s.reshape(phi.shape)
        return jnp.sum(phi[..., self._nn], axis=-1)

    # -- action ----------------------------------------------------------------

    def evaluate(self, phi):
        """1/2 phi^T Q phi (5-point stencil) or 1/2 phi^T Q_hat phi when
        Gibbs-smoothed (gffaction.cc:7-29)."""
        if self.n_gibbs_smooth > 0:
            Qhat = jnp.asarray(self._Q_hat, phi.dtype)
            # HIGHEST: reduced-precision matmul passes for f32 operands
            # (TF32 on GPUs) bias the acceptance ratio (a bf16 einsum
            # here biased the screened chain ~9 sigma)
            return 0.5 * jnp.einsum("...i,ij,...j->...", phi, Qhat, phi,
                                    precision=jax.lax.Precision.HIGHEST)
        kappa = 4.0 + self.mu2
        return 0.5 * jnp.sum(phi * (kappa * phi - self._nbsum(phi)), axis=-1)

    def force(self, phi):
        """Q phi (gffaction.cc:80-96); equals grad(evaluate) for the
        unsmoothed action."""
        if self.n_gibbs_smooth > 0:
            Qhat = jnp.asarray(self._Q_hat, phi.dtype)
            return jnp.matmul(phi, Qhat,
                              precision=jax.lax.Precision.HIGHEST)
        return (4.0 + self.mu2) * phi - self._nbsum(phi)

    def initialise_state(self, key, n_chains, dtype=None):
        if dtype is None:
            dtype = jnp.zeros(0).dtype
        return self.exact_draw(key, n_chains, dtype)

    # -- heat bath / overrelaxation (checkerboard) -----------------------------

    def heatbath_sweep(self, key, phi):
        """One heat-bath sweep.  Unsmoothed: red/black on the 5-point
        stencil, phi_ell ~ N(Delta/(4+mu2), 1/(4+mu2)) (gffaction.cc:33-42).
        Gibbs-smoothed (the coarse level): the smoothed precision Q_hat is
        dense, so the sweep is a sequential single-site Gibbs scan w.r.t.
        Q_hat — the reference sweeps the PLAIN stencil here too
        (gffaction.cc:33-42 has no smoothed branch), which samples a
        different distribution than the smoothed ``evaluate`` used in the
        two-level acceptance ratio and measurably biases the screened fine
        chain (its own gff_twolevel baseline log shows fine <phi^2> =
        0.302 vs its printed analytical 0.338); the Q_hat sweep keeps
        draw and evaluate consistent, so the two-level estimator stays
        unbiased."""
        if self.n_gibbs_smooth > 0:
            return self._dense_gibbs_sweep(key, phi, overrelax=False)
        kappa = 4.0 + self.mu2
        sigma = 1.0 / math.sqrt(kappa)
        for colour, k in zip(self._colour_masks, jax.random.split(key)):
            delta = self._nbsum(phi)[..., colour]
            xi = jax.random.normal(k, delta.shape, phi.dtype)
            phi = phi.at[..., colour].set(delta / kappa + sigma * xi)
        return phi

    def overrelaxation_sweep(self, phi):
        """phi_ell -> 2 Delta/(4+mu2) - phi_ell (gffaction.cc:68-78);
        smoothed actions reflect around the Q_hat conditional mean (see
        heatbath_sweep)."""
        if self.n_gibbs_smooth > 0:
            return self._dense_gibbs_sweep(None, phi, overrelax=True)
        kappa = 4.0 + self.mu2
        for colour in self._colour_masks:
            delta = self._nbsum(phi)[..., colour]
            phi = phi.at[..., colour].set(2.0 * delta / kappa
                                          - phi[..., colour])
        return phi

    def _dense_gibbs_sweep(self, key, phi, *, overrelax: bool):
        """Sequential site-by-site Gibbs (or overrelaxation) sweep for the
        dense smoothed precision Q_hat: phi_i | rest ~
        N(-sum_{j!=i} Qhat_ij phi_j / Qhat_ii, 1/Qhat_ii).  A lax.scan of
        N rank-1 updates on the [chains, N] field — the coarse lattice is
        small, so this stays cheap next to the fine-level kernels."""
        Qhat = jnp.asarray(self._Q_hat, phi.dtype)
        diag = jnp.diagonal(Qhat)
        N = phi.shape[-1]
        if overrelax:
            xs = jnp.arange(N)
        else:
            noise = jax.random.normal(key, (N,) + phi.shape[:-1], phi.dtype)
            xs = (jnp.arange(N), noise)

        def body(phi, inp):
            if overrelax:
                i = inp
            else:
                i, xi = inp
            row = Qhat[i]
            qii = diag[i]
            delta = jnp.tensordot(phi, row, axes=(-1, 0),
                                  precision=jax.lax.Precision.HIGHEST) \
                - phi[..., i] * qii
            mean = -delta / qii
            if overrelax:
                new = 2.0 * mean - phi[..., i]
            else:
                new = mean + xi / jnp.sqrt(qii)
            return phi.at[..., i].set(new), None

        phi, _ = jax.lax.scan(body, phi, xs)
        return phi

    # -- multigrid transfer ----------------------------------------------------

    def prolongate(self, phi_coarse, phi_fine):
        """Inject coarse dofs at the coarse vertices (gffaction.cc:99-108)."""
        lat = self.lattice
        return phi_fine.at[..., lat.coarse_vertices].set(
            phi_coarse[..., lat.fine2coarse])

    def restrict(self, phi_fine):
        """Extract the coarse dofs (gffaction.cc:111-119)."""
        lat = self.lattice
        coarse_lat = lat.coarse_lattice()
        inv = np.empty(coarse_lat.nvertices, dtype=np.int64)
        inv[lat.fine2coarse] = lat.coarse_vertices
        return phi_fine[..., inv]

    def coarse_action(self) -> "GFFAction":
        """Coarse level always uses 2 Gibbs smoothing steps with omega=1
        (gffaction.hh:201-208)."""
        return GFFAction(self.lattice.coarse_lattice(), self.mass,
                         n_gibbs_smooth=2, omega=1.0)

    # -- dense matrices (host, built once; only when needed) -------------------

    def _build_Q(self, stencil) -> np.ndarray:
        """Dense precision matrix from a stencil [diag, nn, (diag-nn)]
        with duplicate-index accumulation (gffaction.cc:178-199)."""
        N = self.lattice.nvertices
        Q = np.zeros((N, N))
        Q[np.arange(N), np.arange(N)] = stencil[0]
        nb = self._nn8
        for j, coeff in enumerate(stencil[1:]):
            for k in range(4):
                np.add.at(Q, (np.arange(N), nb[:, 4 * j + k]), coeff)
        return Q

    @cached_property
    def _Q_precision(self) -> np.ndarray:
        return self._build_Q([4.0 + self.mu2, -1.0])

    @cached_property
    def _Q_eff(self) -> np.ndarray:
        """9-point effective action stencil (gffaction.cc:143-147)."""
        c = 4.0 + 0.5 * self.mu2
        return self._build_Q([c - 4.0 / c, -2.0 / c, -1.0 / c])

    @cached_property
    def _eff_colour_groups(self):
        """Greedy graph colouring of the Q_eff adjacency: sites of one
        colour never couple through Q_eff, so updating a whole colour
        simultaneously is an exact sequential Gibbs step (the 9-point
        stencil couples diagonal neighbours, so plain red/black is NOT
        conflict-free — 4 colours typically result)."""
        Q = self._Q_eff
        N = Q.shape[0]
        adj = (np.abs(Q) > 1e-14) & ~np.eye(N, dtype=bool)
        colour = np.full(N, -1)
        for v in range(N):
            used = set(colour[adj[v]]) - {-1}
            c = 0
            while c in used:
                c += 1
            colour[v] = c
        return [np.flatnonzero(colour == c)
                for c in range(int(colour.max()) + 1)]

    @cached_property
    def _smoother_matrices(self):
        """G^k for the coloured SOR-Gibbs smoother of Q_eff:
        G = I - M^-1 Q_eff with M = D/omega + (couplings from
        earlier-updated colours) — the exact splitting of the device sweep
        in gibbs_sweep_eff, so Q_hat and the draw stay consistent."""
        Q = self._Q_eff
        N = Q.shape[0]
        D = np.diag(Q).copy()
        order = np.empty(N, dtype=np.int64)
        for rank, grp in enumerate(self._eff_colour_groups):
            order[grp] = rank
        M = np.diag(D / self.omega)
        earlier = order[:, None] > order[None, :]
        M[earlier] = Q[earlier]
        G1 = np.eye(N) - np.linalg.solve(M, Q)
        Gk = np.linalg.matrix_power(G1, self.n_gibbs_smooth)
        return Gk

    @cached_property
    def _Q_hat(self) -> np.ndarray:
        """Precision of the k-times-smoothed exact draw:
        Q_hat = (Sigma_eff + G^k (Sigma - Sigma_eff) G^k^T)^-1
        (gffaction.cc:133-174, with our red/black G)."""
        Sigma = np.linalg.inv(self._Q_precision)
        Sigma_eff = np.linalg.inv(self._Q_eff)
        Gk = self._smoother_matrices
        cov = Sigma_eff + Gk @ (Sigma - Sigma_eff) @ Gk.T
        return np.linalg.inv(cov)

    # -- exact sampling --------------------------------------------------------

    @cached_property
    def _spectral_sqrt_inv(self) -> np.ndarray:
        """1/sqrt(lambda) on the (Mx, Mt) FFT grid for the unrotated
        5-point stencil."""
        Mt, Mx = self.lattice.Mt_lat, self.lattice.Mx_lat
        ki = 2.0 * math.pi * np.arange(Mt) / Mt
        kj = 2.0 * math.pi * np.arange(Mx) / Mx
        lam = (4.0 + self.mu2 - 2.0 * np.cos(ki)[None, :]
               - 2.0 * np.cos(kj)[:, None])
        return 1.0 / np.sqrt(lam)

    @cached_property
    def _dense_sqrt_cov(self) -> np.ndarray:
        """L^-1 with Q = L L^T, for rotated lattices (row-vector form:
        phi = z @ L_inv has covariance Q^-1)."""
        L = np.linalg.cholesky(self._Q_precision)
        return np.linalg.inv(L)

    def _draw_unsmoothed(self, key, n_chains, dtype):
        lat = self.lattice
        z = jax.random.normal(key, (n_chains, lat.nvertices), dtype)
        if lat.rotated:
            Li = jnp.asarray(self._dense_sqrt_cov, dtype)
            return jnp.matmul(z, Li,
                              precision=jax.lax.Precision.HIGHEST)
        Mt, Mx = lat.Mt_lat, lat.Mx_lat
        zg = z.reshape(n_chains, Mx, Mt)
        filt = jnp.asarray(self._spectral_sqrt_inv)
        phig = jnp.fft.ifft2(jnp.fft.fft2(zg) * filt).real
        return phig.reshape(n_chains, lat.nvertices).astype(dtype)

    def gibbs_sweep_eff(self, key, phi):
        """One coloured SOR-Gibbs sweep w.r.t. Q_eff, exactly matching the
        iteration matrix used for Q_hat (cf. gffaction.cc:45-65; colour
        groups are conflict-free so each group update is an exact Gibbs
        step)."""
        Q_eff = self._Q_eff
        D = np.diag(Q_eff)
        om = self.omega
        gamma = math.sqrt(om * (2.0 - om))
        groups = self._eff_colour_groups
        for colour, k in zip(groups, jax.random.split(key, len(groups))):
            # off-diagonal row sums for this colour, from current phi
            Q_rows = jnp.asarray(Q_eff[colour], phi.dtype)
            d = jnp.asarray(D[colour], phi.dtype)
            off = jnp.matmul(phi, Q_rows.T,
                             precision=jax.lax.Precision.HIGHEST) \
                - phi[..., colour] * d
            mu = -off / d
            xi = jax.random.normal(k, mu.shape, phi.dtype)
            new = ((1.0 - om) * phi[..., colour] + om * mu
                   + gamma * xi / jnp.sqrt(d))
            phi = phi.at[..., colour].set(new)
        return phi

    @cached_property
    def _dense_sqrt_cov_hat(self) -> np.ndarray:
        """L^-1 with Q_hat = L L^T — the closed-form factor of the
        Gibbs-smoothed covariance.  The constructive draw (unsmoothed
        exact + k coloured Gibbs sweeps) has covariance exactly
        Q_hat^-1 (see _Q_hat), so one dense matmul samples the same
        distribution; on the batched two-level screen the per-draw
        sweeps' row-matmuls + colour scatters dominated the whole chunk
        (~100 ms of [S*C, N] dynamic-update-slices per chunk)."""
        L = np.linalg.cholesky(self._Q_hat)
        return np.linalg.inv(L)

    def exact_draw(self, key, n_chains, dtype=None):
        """Exact sample of the (possibly Gibbs-smoothed) action
        (gffaction.cc:200-213)."""
        if dtype is None:
            dtype = jnp.zeros(0).dtype
        if self.n_gibbs_smooth == 0:
            return self._draw_unsmoothed(key, n_chains, dtype)
        if self.lattice.nvertices <= 4096:
            # dense closed-form factor of the smoothed covariance: one
            # matrix product instead of k Gibbs sweeps per draw
            z = jax.random.normal(key, (n_chains, self.lattice.nvertices),
                                  dtype)
            Li = jnp.asarray(self._dense_sqrt_cov_hat, dtype)
            return jnp.matmul(z, Li, precision=jax.lax.Precision.HIGHEST)
        k0, *ks = jax.random.split(key, self.n_gibbs_smooth + 1)
        phi = self._draw_unsmoothed(k0, n_chains, dtype)
        for k in ks:
            phi = self.gibbs_sweep_eff(k, phi)
        return phi

    def exact_draw_with_action(self, key, n_chains, dtype=None):
        """(x, S(x)) for exact draws.  For the dense Gaussian factor
        x = z L^-1 the action is 1/2 x^T Q x = 1/2 sum z^2 in closed
        form from the driving normals — no [n, N] @ [N, N] evaluate
        matmul (the batched two-level screen's second-largest op)."""
        if dtype is None:
            dtype = jnp.zeros(0).dtype
        lat = self.lattice
        dense_ok = lat.nvertices <= 4096 and (
            self.n_gibbs_smooth > 0 or lat.rotated)
        if dense_ok:
            z = jax.random.normal(key, (n_chains, lat.nvertices), dtype)
            Li = (self._dense_sqrt_cov_hat if self.n_gibbs_smooth > 0
                  else self._dense_sqrt_cov)
            x = jnp.matmul(z, jnp.asarray(Li, dtype),
                           precision=jax.lax.Precision.HIGHEST)
            return x, 0.5 * jnp.sum(z * z, axis=-1)
        x = self.exact_draw(key, n_chains, dtype)
        return x, self.evaluate(x)

    # -- analytics -------------------------------------------------------------

    def phi_squared_analytical(self) -> float:
        """Spectral sum for <phi^2> (src/common/auxilliary.cc:197-209)."""
        from mlmcpathintegral.utils.special import (
            gff_phi_squared_analytical,
        )
        lat = self.lattice
        if lat.rotated:
            # rotated lattice: exact sum over its own spectrum via the dense
            # precision matrix (small lattices only)
            Sigma = np.linalg.inv(self._Q_precision)
            return float(np.trace(Sigma) / lat.nvertices)
        # unrotated: mu2 = m^2/Mt^2; auxilliary.cc uses m^2/(Mt*Mx)
        mass_eff = self.mass * math.sqrt(lat.Mx_lat / lat.Mt_lat)
        return gff_phi_squared_analytical(mass_eff, lat.Mt_lat, lat.Mx_lat)

    def info_string(self):
        return (f"GFF({self.lattice}, mass={self.mass}, mu2={self.mu2:.6f}, "
                f"n_gibbs={self.n_gibbs_smooth})")
