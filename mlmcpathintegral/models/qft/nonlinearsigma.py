"""O(3) non-linear sigma model on a 2-D lattice.

S[sigma] = -beta/2 sum_n sigma_n . Delta_n, where Delta_n is the sum of the
4 nearest-neighbour unit spins; states store the spherical angles
(theta, phi) per vertex as a flat [C, 2*N] array.

Reference parity: src/action/qft/nonlinearsigmaaction.{hh,cc},
nonlinearsigmarenormalisation.hh, qoi2dmagneticsusceptibility.cc.
Requires the CoarsenRotate hierarchy (nonlinearsigmaaction.hh:143-151);
multilevel is not supported for this model, matching driver_qft.cc:406-411.

Batched design: the heat-bath/overrelaxation updates are vectorised over
red/black vertex colour groups (each spin's conditional depends only on its
4 nearest neighbours, which always have the opposite colour on both the
rotated and unrotated members of the rotate hierarchy); the Eigen vector
geometry (perpendicular-vector choice, axis-angle rotation) becomes batched
3-vector algebra with a Rodrigues rotation.
"""

from __future__ import annotations

import math
from functools import cached_property

import jax
import jax.numpy as jnp
import numpy as np

from mlmcpathintegral.distributions.compactexp import CompactExpDistribution
from mlmcpathintegral.lattice2d import CoarseningType, Lattice2D
from mlmcpathintegral.models.base import Action, RenormalisationType


def angles_to_vec(state):
    """[..., 2N] (theta, phi) pairs -> [..., N, 3] unit vectors."""
    ang = state.reshape(*state.shape[:-1], -1, 2)
    theta, phi = ang[..., 0], ang[..., 1]
    st = jnp.sin(theta)
    return jnp.stack([st * jnp.cos(phi), st * jnp.sin(phi),
                      jnp.cos(theta)], axis=-1)


def vec_to_angles(vec):
    """[..., N, 3] -> [..., 2N] (theta, phi); matches the reference's
    atan2-based conversion (nonlinearsigmaaction.cc:69-72)."""
    phi = jnp.arctan2(vec[..., 1], vec[..., 0])
    theta = jnp.arctan2(
        jnp.sqrt(vec[..., 0] ** 2 + vec[..., 1] ** 2), vec[..., 2])
    out = jnp.stack([theta, phi], axis=-1)
    return out.reshape(*out.shape[:-2], -1)


class NonlinearSigmaAction(Action):

    def __init__(self, lattice: Lattice2D, beta: float,
                 renormalisation: RenormalisationType =
                 RenormalisationType.NONE):
        if lattice.coarsening_type is not CoarseningType.ROTATE:
            raise ValueError("sigma model needs CoarsenRotate "
                             "(nonlinearsigmaaction.hh:143-151)")
        self.lattice = lattice
        self.beta = float(beta)
        self.renormalisation = renormalisation

    @property
    def ndof(self) -> int:
        return 2 * self.lattice.nvertices

    # -- geometry helpers ------------------------------------------------------

    @cached_property
    def _nn(self) -> np.ndarray:
        return self.lattice.neighbour_vertices[:, :4]

    @cached_property
    def _colour_masks(self):
        ell = np.arange(self.lattice.nvertices)
        i, j = self.lattice.vertex_lin2cart(ell)
        red = (i % 2 == 0) if self.lattice.rotated else ((i + j) % 2 == 0)
        return np.flatnonzero(red), np.flatnonzero(~red)

    def delta_neighbours(self, vec):
        """Sum of the 4 nearest-neighbour spins: [..., N, 3]."""
        return jnp.sum(vec[..., self._nn, :], axis=-2)

    # -- action ----------------------------------------------------------------

    def evaluate(self, state):
        vec = angles_to_vec(state)
        delta = self.delta_neighbours(vec)
        return -0.5 * self.beta * jnp.sum(vec * delta, axis=(-2, -1))

    def force(self, state):
        """dS/d(theta, phi) (nonlinearsigmaaction.cc:96-116); equals
        grad(evaluate)."""
        ang = state.reshape(*state.shape[:-1], -1, 2)
        theta, phi = ang[..., 0], ang[..., 1]
        delta = self.delta_neighbours(angles_to_vec(state))
        ct, st = jnp.cos(theta), jnp.sin(theta)
        cp, sp = jnp.cos(phi), jnp.sin(phi)
        dS_dtheta = -self.beta * ((delta[..., 0] * cp
                                   + delta[..., 1] * sp) * ct
                                  - delta[..., 2] * st)
        dS_dphi = -self.beta * (-delta[..., 0] * sp
                                + delta[..., 1] * cp) * st
        out = jnp.stack([dS_dtheta, dS_dphi], axis=-1)
        return out.reshape(*state.shape)

    def initialise_state(self, key, n_chains, dtype=None):
        """Random unit spins (the reference draws uniformly in a shell then
        normalises through the angle conversion,
        nonlinearsigmaaction.cc:142-163; a direct Gaussian-normalised draw
        gives the same uniform distribution on the sphere)."""
        if dtype is None:
            dtype = jnp.zeros(0).dtype
        N = self.lattice.nvertices
        v = jax.random.normal(key, (n_chains, N, 3), dtype)
        v = v / jnp.linalg.norm(v, axis=-1, keepdims=True)
        return vec_to_angles(v)

    # -- heat bath / overrelaxation --------------------------------------------

    @staticmethod
    def _perp(delta_hat):
        """Batched 'best perpendicular' unit vector
        (nonlinearsigmaaction.cc:36-59): zero the absolutely-smallest
        component and rotate the other two."""
        a = jnp.abs(delta_hat)
        idx = jnp.argmin(a, axis=-1)
        amin = jnp.take_along_axis(a, idx[..., None], axis=-1)[..., 0]
        rho_inv = 1.0 / jnp.sqrt(jnp.maximum(1.0 - amin * amin, 1e-30))
        d0, d1, d2 = delta_hat[..., 0], delta_hat[..., 1], delta_hat[..., 2]
        z = jnp.zeros_like(d0)
        p0 = jnp.stack([z, -d2 * rho_inv, +d1 * rho_inv], axis=-1)
        p1 = jnp.stack([-d2 * rho_inv, z, +d0 * rho_inv], axis=-1)
        p2 = jnp.stack([+d1 * rho_inv, -d0 * rho_inv, z], axis=-1)
        sel = jax.nn.one_hot(idx, 3, dtype=delta_hat.dtype)
        return (sel[..., 0:1] * p0 + sel[..., 1:2] * p1
                + sel[..., 2:3] * p2)

    @staticmethod
    def _rodrigues(v, axis, angle):
        """Rotate v around the unit vector axis by angle."""
        c = jnp.cos(angle)[..., None]
        s = jnp.sin(angle)[..., None]
        dot = jnp.sum(axis * v, axis=-1, keepdims=True)
        return v * c + jnp.cross(axis, v) * s + axis * dot * (1.0 - c)

    def _heatbath_colour(self, key, vec, colour):
        """Exact conditional redraw of the spins of one colour group
        (nonlinearsigmaaction.cc:24-73)."""
        delta = self.delta_neighbours(vec)[..., colour, :]
        nrm = jnp.linalg.norm(delta, axis=-1)
        delta_hat = delta / jnp.maximum(nrm, 1e-30)[..., None]
        k1, k2 = jax.random.split(key)
        sig_par = CompactExpDistribution.draw(k1, self.beta * nrm)
        sig_perp = jnp.sqrt(jnp.maximum(1.0 - sig_par * sig_par, 0.0))
        perp = self._perp(delta_hat)
        new = sig_par[..., None] * delta_hat + sig_perp[..., None] * perp
        az = jax.random.uniform(k2, nrm.shape, vec.dtype,
                                -math.pi, math.pi)
        new = self._rodrigues(new, delta_hat, az)
        return vec.at[..., colour, :].set(new)

    def heatbath_sweep(self, key, state):
        vec = angles_to_vec(state)
        for colour, k in zip(self._colour_masks, jax.random.split(key)):
            vec = self._heatbath_colour(k, vec, colour)
        return vec_to_angles(vec)

    # -- grid fast path (unrotated lattices) -----------------------------------
    #
    # The gather/scatter form above indexes vec[..., nn, :] per colour; on
    # an accelerator those lower to slow gathers and materialise a [C, N, 4, 3]
    # intermediate.  On the *unrotated* members of the rotate hierarchy the
    # vertex order is lin = Mt*j + i, so the state reshapes to a
    # [C, Mx, Mt, 3] grid whose 4-point stencil is four jnp.rolls and whose
    # colour update is a checkerboard jnp.where — no gathers, and the whole
    # overrelax+heat-bath block runs in vector form with a single
    # angles<->vec conversion at entry/exit (the per-sweep atan2/sin/cos
    # round trip is pure overhead; cf. the reference's per-site update,
    # nonlinearsigmaaction.cc:24-94, which has no such conversion either).

    @cached_property
    def _grid_red_mask(self):
        # numpy (not jnp): a cached device array created inside a trace
        # would leak a tracer; as a numpy constant it is embedded per jit.
        Mt, Mx = self.lattice.Mt_lat, self.lattice.Mx_lat
        i = np.arange(Mt)[None, :]
        j = np.arange(Mx)[:, None]
        return ((i + j) % 2 == 0)[..., None]   # [Mx, Mt, 1] bool

    @staticmethod
    def _grid_delta_soa(gx, gy, gz):
        """4-nearest-neighbour spin sum, one [Mx, Mt, C] plane per
        component (i = axis 1, j = axis 0)."""
        def nn(g):
            return (jnp.roll(g, 1, axis=0) + jnp.roll(g, -1, axis=0)
                    + jnp.roll(g, 1, axis=1) + jnp.roll(g, -1, axis=1))
        return nn(gx), nn(gy), nn(gz)

    def _grid_unit_delta(self, gx, gy, gz):
        dx, dy, dz = self._grid_delta_soa(gx, gy, gz)
        nrm = jnp.sqrt(dx * dx + dy * dy + dz * dz)
        r = 1.0 / jnp.maximum(nrm, 1e-30)
        return dx * r, dy * r, dz * r, nrm

    def _grid_heatbath_colour(self, key, g, mask):
        gx, gy, gz = g
        hx, hy, hz, nrm = self._grid_unit_delta(gx, gy, gz)
        k1, k2 = jax.random.split(key)
        sig_par = CompactExpDistribution.draw(k1, self.beta * nrm)
        sig_perp = jnp.sqrt(jnp.maximum(1.0 - sig_par * sig_par, 0.0))
        # 'best perpendicular' (same selection rule as _perp): zero the
        # absolutely-smallest component of delta_hat, rotate the other two
        a0, a1, a2 = jnp.abs(hx), jnp.abs(hy), jnp.abs(hz)
        m0 = (a0 <= a1) & (a0 <= a2)
        m1 = (~m0) & (a1 <= a2)
        amin = jnp.where(m0, a0, jnp.where(m1, a1, a2))
        rho_inv = 1.0 / jnp.sqrt(jnp.maximum(1.0 - amin * amin, 1e-30))
        zero = jnp.zeros_like(hx)
        px = jnp.where(m0, zero, jnp.where(m1, -hz, hy)) * rho_inv
        py = jnp.where(m0, -hz, jnp.where(m1, zero, -hx)) * rho_inv
        pz = jnp.where(m0, hy, jnp.where(m1, hx, zero)) * rho_inv
        nx = sig_par * hx + sig_perp * px
        ny = sig_par * hy + sig_perp * py
        nz = sig_par * hz + sig_perp * pz
        # Rodrigues rotation of (nx,ny,nz) about (hx,hy,hz) by the azimuth
        az = jax.random.uniform(k2, nrm.shape, gx.dtype, -math.pi, math.pi)
        c, s = jnp.cos(az), jnp.sin(az)
        dot = hx * nx + hy * ny + hz * nz
        cx = hy * nz - hz * ny
        cy = hz * nx - hx * nz
        cz = hx * ny - hy * nx
        d1c = dot * (1.0 - c)
        nx = nx * c + cx * s + hx * d1c
        ny = ny * c + cy * s + hy * d1c
        nz = nz * c + cz * s + hz * d1c
        return (jnp.where(mask, nx, gx), jnp.where(mask, ny, gy),
                jnp.where(mask, nz, gz))

    def _grid_overrelax_colour(self, g, mask):
        gx, gy, gz = g
        hx, hy, hz, _ = self._grid_unit_delta(gx, gy, gz)
        dot2 = 2.0 * (gx * hx + gy * hy + gz * hz)
        return (jnp.where(mask, dot2 * hx - gx, gx),
                jnp.where(mask, dot2 * hy - gy, gy),
                jnp.where(mask, dot2 * hz - gz, gz))

    def combined_sweeps(self, key, state, n_overrelax, n_heatbath):
        """All overrelaxation then heat-bath sweeps of one draw in a single
        vector-form pass; exact same conditional updates as the sweep
        methods above (rolls reproduce _nn on unrotated lattices), only the
        RNG stream layout differs.  Rotated lattices (and unbatched states)
        fall back to the gather form.

        Batched layout: chains ride the minor axis ([Mx, Mt, C]
        planes, one per spin component) — the natural [..., N, 3] layout
        puts a length-3 axis minor and ran ~2x *slower* than the gather
        form; structure-of-arrays with every op
        elementwise over [Mx, Mt, C] is what the vector units want."""
        if self.lattice.rotated or state.ndim != 2:
            for _ in range(n_overrelax):
                state = self.overrelaxation_sweep(state)
            for _ in range(n_heatbath):
                key, sub = jax.random.split(key)
                state = self.heatbath_sweep(sub, state)
            return state
        Mt, Mx = self.lattice.Mt_lat, self.lattice.Mx_lat
        C = state.shape[0]
        # angles -> SoA planes without the padded [C, N, 3] intermediate
        # (same formulas as angles_to_vec / vec_to_angles)
        ang = state.reshape(C, -1, 2)
        theta, phi = ang[..., 0], ang[..., 1]           # [C, N]
        st, ct = jnp.sin(theta), jnp.cos(theta)

        def to_grid(p):                                 # [C, N] -> [Mx,Mt,C]
            return jnp.moveaxis(p.reshape(C, Mx, Mt), 0, -1)

        g = (to_grid(st * jnp.cos(phi)), to_grid(st * jnp.sin(phi)),
             to_grid(ct))
        red = self._grid_red_mask
        black = ~red
        for _ in range(n_overrelax):
            g = self._grid_overrelax_colour(g, red)
            g = self._grid_overrelax_colour(g, black)
        for _ in range(n_heatbath):
            key, k1, k2 = jax.random.split(key, 3)
            g = self._grid_heatbath_colour(k1, g, red)
            g = self._grid_heatbath_colour(k2, g, black)
        gx, gy, gz = g
        phi = jnp.arctan2(gy, gx)                       # [Mx, Mt, C]
        theta = jnp.arctan2(jnp.sqrt(gx * gx + gy * gy), gz)

        def to_flat(p):                                 # [Mx,Mt,C] -> [C, N]
            return jnp.moveaxis(p, -1, 0).reshape(C, -1)

        out = jnp.stack([to_flat(theta), to_flat(phi)], axis=-1)
        return out.reshape(C, -1)

    def overrelaxation_sweep(self, state):
        """Reflect each spin about the neighbour-sum direction
        (nonlinearsigmaaction.cc:76-94)."""
        vec = angles_to_vec(state)
        for colour in self._colour_masks:
            delta = self.delta_neighbours(vec)[..., colour, :]
            delta_hat = delta / jnp.maximum(
                jnp.linalg.norm(delta, axis=-1), 1e-30)[..., None]
            s = vec[..., colour, :]
            dot = jnp.sum(s * delta_hat, axis=-1, keepdims=True)
            vec = vec.at[..., colour, :].set(2.0 * dot * delta_hat - s)
        return vec_to_angles(vec)

    # -- cluster hooks (nonlinearsigmaaction.cc:166-210) -----------------------

    @staticmethod
    def new_reflection(key, n_chains, dtype=None):
        """Uniform random unit reflection vector per chain: [C, 3]."""
        if dtype is None:
            dtype = jnp.zeros(0).dtype
        v = jax.random.normal(key, (n_chains, 3), dtype)
        return v / jnp.linalg.norm(v, axis=-1, keepdims=True)

    def S_ell_vec(self, vec_i, vec_j, r):
        """Bond energy -2 beta (r.sigma_i)(r.sigma_j); r: [..., 3]."""
        return (-2.0 * self.beta * jnp.sum(r * vec_i, axis=-1)
                * jnp.sum(r * vec_j, axis=-1))

    @staticmethod
    def flip_vec(vec, r):
        """sigma -> sigma - 2 (sigma.r) r."""
        return vec - 2.0 * jnp.sum(vec * r, axis=-1, keepdims=True) * r

    # -- multigrid -------------------------------------------------------------

    def _dof_map(self, vertex_idx):
        """(theta, phi) dof indices of the given vertices."""
        return np.stack([2 * vertex_idx, 2 * vertex_idx + 1],
                        axis=-1).reshape(-1)

    def prolongate(self, state_coarse, state_fine):
        lat = self.lattice
        src = self._dof_map(lat.fine2coarse)
        dst = self._dof_map(lat.coarse_vertices)
        return state_fine.at[..., dst].set(state_coarse[..., src])

    def restrict(self, state_fine):
        lat = self.lattice
        clat = lat.coarse_lattice()
        inv = np.empty(clat.nvertices, dtype=np.int64)
        inv[lat.fine2coarse] = lat.coarse_vertices
        return state_fine[..., self._dof_map(inv)]

    def coarse_action(self) -> "NonlinearSigmaAction":
        """beta^c = beta - log(2)/(4 pi) for perturbative renormalisation
        (nonlinearsigmarenormalisation.hh:58-76)."""
        if self.renormalisation is RenormalisationType.PERTURBATIVE:
            beta_c = self.beta - 0.5 * math.log(2.0) / (2.0 * math.pi)
        elif self.renormalisation is RenormalisationType.NONPERTURBATIVE:
            raise NotImplementedError(
                "nonperturbative renormalisation not implemented for the "
                "sigma model (matches reference)")
        else:
            beta_c = self.beta
        return NonlinearSigmaAction(self.lattice.coarse_lattice(), beta_c,
                                    self.renormalisation)

    def info_string(self):
        return f"NonlinearSigma({self.lattice}, beta={self.beta})"


def qoi_magnetic_susceptibility(action):
    """|sum_n sigma_n|^2 / N (qoi2dmagneticsusceptibility.cc:6-21).

    Computed from the angle planes directly (sums of st*cp, st*sp, ct over
    the vertex/lane axis) — the [..., N, 3] vector intermediate (a length-3
    minor axis) dominated the recording cost once
    the sweeps moved to the SoA fast path."""
    def evaluate(state):
        ang = state.reshape(*state.shape[:-1], -1, 2)
        theta, phi = ang[..., 0], ang[..., 1]         # [..., N]
        st = jnp.sin(theta)
        mx = jnp.sum(st * jnp.cos(phi), axis=-1)
        my = jnp.sum(st * jnp.sin(phi), axis=-1)
        mz = jnp.sum(jnp.cos(theta), axis=-1)
        return (mx * mx + my * my + mz * mz) / action.lattice.nvertices
    return evaluate
