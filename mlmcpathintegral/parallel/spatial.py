"""Spatial (lattice-axis) sharding with halo exchange — scaling beyond the
reference.

The reference never decomposes the lattice across ranks (SURVEY.md §2.1);
its scaling axes are independent chains and the multigrid hierarchy.  The
5-point-stencil sweeps shard naturally: the spatial rows of a
[C, Mx, Mt] field are distributed over a 1-D ``space`` mesh axis with
``shard_map``, and each red/black half-sweep exchanges one halo row with
each neighbouring device via ``jax.lax.ppermute``.

This module implements the sharded GFF checkerboard heat-bath sweep.  The
update is *bit-identical* to the single-device sweep given the same noise
(tested on the virtual CPU mesh), because the checkerboard sweep only ever
reads frozen opposite-colour values — the decomposition changes data
movement, not math.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def gff_heatbath_sweep_noise(action, phi, xi):
    """Single-device reference: red/black heat-bath sweep of the 5-point
    stencil driven by externally supplied noise xi [C, N] (same math as
    GFFAction.heatbath_sweep, deterministic given xi)."""
    kappa = 4.0 + action.mu2
    sigma = 1.0 / math.sqrt(kappa)
    for colour in action._colour_masks:
        delta = action._nbsum(phi)[..., colour]
        phi = phi.at[..., colour].set(delta / kappa
                                      + sigma * xi[..., colour])
    return phi


def make_sharded_gff_sweep(action, mesh: Mesh, axis: str = "space",
                           chain_axis: str | None = None):
    """Build a jitted sharded sweep: phi [C, N] with the spatial rows
    sharded over ``axis`` (and, if ``chain_axis`` is given, the chain axis
    sharded over that mesh axis too — a 2-D dp x sp layout).  Requires an
    unrotated lattice whose Mx is a multiple of 2 * mesh size (even rows
    per shard keep the global checkerboard parity aligned across shards)."""
    lat = action.lattice
    if lat.rotated:
        raise ValueError("spatial sharding needs an unrotated lattice")
    Mt, Mx = lat.Mt_lat, lat.Mx_lat
    n_dev = mesh.shape[axis]
    if Mx % (2 * n_dev):
        raise ValueError(f"Mx={Mx} must be a multiple of 2*{n_dev}")
    kappa = 4.0 + action.mu2
    sigma = 1.0 / math.sqrt(kappa)
    fwd = [(i, (i + 1) % n_dev) for i in range(n_dev)]
    bwd = [(i, (i - 1) % n_dev) for i in range(n_dev)]

    def local_sweep(phi_loc, xi_loc):
        """phi_loc, xi_loc: [C, Mx_loc, Mt] local row blocks."""
        for parity in (0, 1):
            # halo rows from the neighbouring shards (ppermute)
            top = jax.lax.ppermute(phi_loc[:, -1:, :], axis, fwd)
            bot = jax.lax.ppermute(phi_loc[:, :1, :], axis, bwd)
            ext = jnp.concatenate([top, phi_loc, bot], axis=1)
            up = ext[:, :-2, :]       # row j-1
            down = ext[:, 2:, :]      # row j+1
            left = jnp.roll(phi_loc, 1, axis=-1)
            right = jnp.roll(phi_loc, -1, axis=-1)
            delta = up + down + left + right
            new = delta / kappa + sigma * xi_loc
            # global checkerboard: colour = (i + j_global) % 2; the shard
            # offset is even (Mx_loc even), so local j parity is global
            i_idx = jax.lax.broadcasted_iota(jnp.int32, phi_loc.shape[1:],
                                             1)
            j_idx = jax.lax.broadcasted_iota(jnp.int32, phi_loc.shape[1:],
                                             0)
            mask = ((i_idx + j_idx) % 2 == parity)[None, :, :]
            phi_loc = jnp.where(mask, new, phi_loc)
        return phi_loc

    spec = P(chain_axis, axis, None)
    sweep = jax.shard_map(local_sweep, mesh=mesh,
                          in_specs=(spec, spec), out_specs=spec)

    @jax.jit
    def sharded_sweep(phi, xi):
        """phi, xi: [C, N] flat states; returns the swept [C, N]."""
        C = phi.shape[0]
        phi_g = phi.reshape(C, Mx, Mt)
        xi_g = xi.reshape(C, Mx, Mt)
        out = sweep(phi_g, xi_g)
        return out.reshape(C, Mx * Mt)

    return sharded_sweep


# -- Schwinger link sweeps -------------------------------
#
# The quenched Schwinger heat-bath sweep (quenchedschwingeraction.cc:25-66)
# updates links in 4 conflict-free (direction, parity) groups; every staple
# reaches at most one row in +-j, so sharding the Mx (row) axis needs a
# one-row halo of BOTH link orientations per quarter-sweep.  The rejection
# draw is driven by externally-supplied noise rounds so the sharded and
# unsharded sweeps are bit-identical given the same noise (the same
# equality contract as the GFF sweep above); the keyed production variant
# generates the noise per shard from a fold_in of the mesh axis index.

def _expcos_draw_noise(nz, beta, x_p, x_m, fallback):
    """First-accept rejection draw from ExpCos(beta; x_p, x_m) driven by
    pre-drawn noise rounds nz = (x_uni[R,...], x_gauss[R,...], u[R,...])
    (x_uni ~ U[-pi, pi), x_gauss ~ N(0,1), u ~ U[0,1)).  Same envelope and
    acceptance logic as distributions.ExpCosDistribution.draw; unaccepted
    lanes return ``fallback`` (exact identity-mixture truncation)."""
    xu_r, xg_r, uu_r = nz
    dtype = x_p.dtype
    pi = jnp.asarray(math.pi, dtype)
    dx = x_m - x_p
    tau = 2.0 * beta * jnp.abs(jnp.cos(0.5 * dx))
    use_uni = tau < 0.45
    sigma = 0.5 * pi / jnp.sqrt(jnp.maximum(tau, 1e-12))
    x = jnp.zeros_like(x_p)
    acc = jnp.zeros(x_p.shape, bool)
    for r in range(xu_r.shape[0]):
        xx = jnp.where(use_uni, xu_r[r], sigma * xg_r[r])
        log_ratio = tau * (jnp.cos(xx) - 1.0) + jnp.where(
            use_uni, 0.0, 2.0 * tau * xx * xx / (math.pi ** 2))
        ok = jnp.logical_and(
            jnp.logical_and(-pi <= xx, xx < pi),
            jnp.log(uu_r[r]) <= log_ratio)
        x = jnp.where(acc, x, xx)
        acc = jnp.logical_or(acc, ok)
    from mlmcpathintegral.utils.special import mod_2pi
    shift = 0.5 * (x_p + x_m) + jnp.where(jnp.abs(dx) > pi, pi, 0.0)
    out = mod_2pi(x + shift)
    return jnp.where(acc, out, fallback)


def schwinger_group_shapes(action, n_chains: int):
    """Global noise shapes of the 4 (mu, parity) sweep groups."""
    lat = action.lattice
    Mt, Mx = lat.Mt_lat, lat.Mx_lat
    return [(n_chains, Mx // 2, Mt), (n_chains, Mx // 2, Mt),
            (n_chains, Mx, Mt // 2), (n_chains, Mx, Mt // 2)]


def make_schwinger_sweep_noise(key, action, n_chains: int,
                               max_iter: int = 6, dtype=jnp.float64):
    """Draw the full noise pytree for one noise-driven heat-bath sweep:
    a list of 4 per-group tuples (x_uni, x_gauss, u), each [R, C, .., ..]."""
    out = []
    for g, shape in enumerate(schwinger_group_shapes(action, n_chains)):
        kg = jax.random.fold_in(key, g)
        k1, k2, k3 = jax.random.split(kg, 3)
        out.append((
            jax.random.uniform(k1, (max_iter,) + shape, dtype,
                               -math.pi, math.pi),
            jax.random.normal(k2, (max_iter,) + shape, dtype),
            jax.random.uniform(k3, (max_iter,) + shape, dtype)))
    return out


def schwinger_heatbath_sweep_noise(action, theta, noise):
    """Single-device reference: one full heat-bath sweep driven by the
    supplied noise (deterministic; same group order and staple math as
    QuenchedSchwingerAction.heatbath_sweep)."""
    for (mu, parity), nz in zip(action._link_groups(), noise):
        g = action._grid(theta)
        theta_p, theta_m = action.staple_angles_mu(theta, mu)
        sel = action._group_sel(mu, parity)
        tp, tm = theta_p[sel], theta_m[sel]
        cur = g[sel + (mu,)]
        new = _expcos_draw_noise(nz, action.beta, tp, tm, cur)
        g = g.at[sel + (mu,)].set(new)
        theta = action._flat(g)
    return theta


def _sharded_staples_mu(ext, mu, Mx_loc):
    """(theta_p, theta_m) [C, Mx_loc, Mt] for direction ``mu`` from an
    extended local grid ext [C, Mx_loc+2, Mt, 2] carrying one halo row on
    each side (same formulas as staple_angles_mu; j-shifts become row
    slices of ext, i-shifts stay periodic local rolls)."""
    from mlmcpathintegral.utils.special import mod_2pi
    T, X = ext[..., 0], ext[..., 1]

    def sh(A, di, dj):
        out = A
        if di:
            out = jnp.roll(out, -di, axis=-1)
        return out[:, 1 + dj:1 + dj + Mx_loc, :]

    def c(A):
        return A[:, 1:1 + Mx_loc, :]

    if mu == 0:
        tp = mod_2pi(sh(T, 0, 1) + c(X) - sh(X, 1, 0))
        tm = mod_2pi(sh(T, 0, -1) + sh(X, 1, -1) - sh(X, 0, -1))
    else:
        tp = mod_2pi(c(T) + sh(X, 1, 0) - sh(T, 0, 1))
        tm = mod_2pi(sh(T, -1, 1) + sh(X, -1, 0) - sh(T, -1, 0))
    return tp, tm


def make_sharded_schwinger_sweep(action, mesh: Mesh, axis: str = "space",
                                 chain_axis: str | None = None,
                                 max_iter: int = 6):
    """Build a jitted noise-driven sharded heat-bath sweep: theta [C, ndof]
    with the Mx rows of the [C, Mx, Mt, 2] link grid sharded over ``axis``
    (and optionally chains over ``chain_axis``).  Bit-identical to
    :func:`schwinger_heatbath_sweep_noise` given the same noise.  Requires
    Mx to be a multiple of 2 * mesh size (even rows per shard keep the
    global j-parity of the temporal-link groups aligned)."""
    lat = action.lattice
    Mt, Mx = lat.Mt_lat, lat.Mx_lat
    n_dev = mesh.shape[axis]
    if Mx % (2 * n_dev):
        raise ValueError(f"Mx={Mx} must be a multiple of 2*{n_dev}")
    Mx_loc = Mx // n_dev
    beta = action.beta
    fwd = [(i, (i + 1) % n_dev) for i in range(n_dev)]
    bwd = [(i, (i - 1) % n_dev) for i in range(n_dev)]
    from mlmcpathintegral.utils.special import mod_2pi  # noqa: F401

    def local_sweep(g_loc, *noise_flat):
        """g_loc: [C, Mx_loc, Mt, 2] local row block of the link grid."""
        noise = [tuple(noise_flat[3 * i:3 * i + 3]) for i in range(4)]
        for (mu, parity), nz in zip(
                [(0, 0), (0, 1), (1, 0), (1, 1)], noise):
            top = jax.lax.ppermute(g_loc[:, -1:], axis, fwd)
            bot = jax.lax.ppermute(g_loc[:, :1], axis, bwd)
            ext = jnp.concatenate([top, g_loc, bot], axis=1)
            tp, tm = _sharded_staples_mu(ext, mu, Mx_loc)
            if mu == 0:   # rows of one global-j parity (Mx_loc even)
                sel = (slice(None), slice(parity, None, 2), slice(None))
            else:         # columns of one i parity (Mt fully local)
                sel = (slice(None), slice(None), slice(parity, None, 2))
            cur = g_loc[..., mu][sel]
            new = _expcos_draw_noise(nz, beta, tp[sel], tm[sel], cur)
            g_loc = g_loc.at[sel + (mu,)].set(new)
        return g_loc

    gspec = P(chain_axis, axis, None, None)
    nspec_j = P(None, chain_axis, axis, None)   # [R, C, Mx(/2), Mt(..)]
    nspecs = []
    for g in range(4):
        nspecs.extend([nspec_j] * 3)
    sweep = jax.shard_map(local_sweep, mesh=mesh,
                          in_specs=(gspec,) + tuple(nspecs),
                          out_specs=gspec)

    @jax.jit
    def sharded_sweep(theta, noise):
        C = theta.shape[0]
        g = theta.reshape(C, Mx, Mt, 2)
        flat = [a for nz in noise for a in nz]
        out = sweep(g, *flat)
        return out.reshape(C, Mx * Mt * 2)

    return sharded_sweep


def make_sharded_schwinger_heatbath(action, mesh: Mesh,
                                    axis: str = "space",
                                    chain_axis: str | None = None,
                                    max_iter: int = 6):
    """Keyed production variant: draws the rejection noise per shard from
    a fold_in of the mesh position (one independent stream per (space,
    chain) shard) and runs the same halo-exchange sweep.  Returns
    jitted ``sweep(key, theta [C, ndof]) -> theta``."""
    lat = action.lattice
    Mt, Mx = lat.Mt_lat, lat.Mx_lat
    n_dev = mesh.shape[axis]
    if Mx % (2 * n_dev):
        raise ValueError(f"Mx={Mx} must be a multiple of 2*{n_dev}")
    Mx_loc = Mx // n_dev
    beta = action.beta
    fwd = [(i, (i + 1) % n_dev) for i in range(n_dev)]
    bwd = [(i, (i - 1) % n_dev) for i in range(n_dev)]

    def local_sweep(key, g_loc):
        C = g_loc.shape[0]
        key = jax.random.fold_in(key, jax.lax.axis_index(axis))
        if chain_axis is not None:
            key = jax.random.fold_in(key, jax.lax.axis_index(chain_axis))
        dtype = g_loc.dtype
        shapes = [(C, Mx_loc // 2, Mt), (C, Mx_loc // 2, Mt),
                  (C, Mx_loc, Mt // 2), (C, Mx_loc, Mt // 2)]
        for gidx, (mu, parity) in enumerate(
                [(0, 0), (0, 1), (1, 0), (1, 1)]):
            kg = jax.random.fold_in(key, gidx)
            k1, k2, k3 = jax.random.split(kg, 3)
            shape = (max_iter,) + shapes[gidx]
            nz = (jax.random.uniform(k1, shape, dtype,
                                     -math.pi, math.pi),
                  jax.random.normal(k2, shape, dtype),
                  jax.random.uniform(k3, shape, dtype))
            top = jax.lax.ppermute(g_loc[:, -1:], axis, fwd)
            bot = jax.lax.ppermute(g_loc[:, :1], axis, bwd)
            ext = jnp.concatenate([top, g_loc, bot], axis=1)
            tp, tm = _sharded_staples_mu(ext, mu, Mx_loc)
            if mu == 0:
                sel = (slice(None), slice(parity, None, 2), slice(None))
            else:
                sel = (slice(None), slice(None), slice(parity, None, 2))
            cur = g_loc[..., mu][sel]
            new = _expcos_draw_noise(nz, beta, tp[sel], tm[sel], cur)
            g_loc = g_loc.at[sel + (mu,)].set(new)
        return g_loc

    gspec = P(chain_axis, axis, None, None)
    sweep = jax.shard_map(local_sweep, mesh=mesh,
                          in_specs=(P(), gspec), out_specs=gspec)

    @jax.jit
    def sharded_heatbath(key, theta):
        C = theta.shape[0]
        out = sweep(key, theta.reshape(C, Mx, Mt, 2))
        return out.reshape(C, Mx * Mt * 2)

    return sharded_heatbath
