"""Spatially-sharded GFF sweep with halo exchange vs the dense sweep."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mlmcpathintegral.lattice2d import CoarseningType, Lattice2D
from mlmcpathintegral.models.qft import GFFAction
from mlmcpathintegral.parallel import chain_mesh
from mlmcpathintegral.parallel.spatial import (
    gff_heatbath_sweep_noise, make_sharded_gff_sweep,
)


def _mesh(n):
    devices = jax.local_devices(backend="cpu")
    if len(devices) < n:
        pytest.skip(f"needs {n} virtual CPU devices")
    return chain_mesh(n, devices=devices, axis_name="space")


def test_sharded_sweep_matches_dense():
    lat = Lattice2D(8, 8, CoarseningType.BOTH)
    act = GFFAction(lat, mass=2.0)
    mesh = _mesh(4)
    sweep = make_sharded_gff_sweep(act, mesh, axis="space")
    key = jax.random.PRNGKey(0)
    k1, k2 = jax.random.split(key)
    phi = jax.random.normal(k1, (6, lat.nvertices), jnp.float64)
    xi = jax.random.normal(k2, (6, lat.nvertices), jnp.float64)
    dense = gff_heatbath_sweep_noise(act, phi, xi)
    sharded = sweep(phi, xi)
    np.testing.assert_allclose(np.asarray(sharded), np.asarray(dense),
                               rtol=1e-13, atol=1e-13)


def test_sharded_sweep_preserves_distribution():
    lat = Lattice2D(8, 16, CoarseningType.BOTH)
    act = GFFAction(lat, mass=2.0)
    mesh = _mesh(8)
    sweep = make_sharded_gff_sweep(act, mesh, axis="space")
    key = jax.random.PRNGKey(1)
    phi = act.exact_draw(key, 20_000, jnp.float64)
    for i in range(3):
        xi = jax.random.normal(jax.random.fold_in(key, i), phi.shape,
                               jnp.float64)
        phi = sweep(phi, xi)
    phi2 = float(jnp.mean(phi * phi))
    assert phi2 == pytest.approx(act.phi_squared_analytical(), rel=2e-2)


def test_invalid_configs():
    lat = Lattice2D(8, 8, CoarseningType.ROTATE, coarsening_level=1)
    act = GFFAction(lat, mass=1.0)
    with pytest.raises(ValueError, match="unrotated"):
        make_sharded_gff_sweep(act, _mesh(2), axis="space")
    lat2 = Lattice2D(8, 6, CoarseningType.BOTH)
    with pytest.raises(ValueError, match="multiple"):
        make_sharded_gff_sweep(GFFAction(lat2, mass=1.0), _mesh(4),
                               axis="space")


# -- Schwinger link sweeps -------------------------------

from mlmcpathintegral.models.base import RenormalisationType
from mlmcpathintegral.models.qft.schwinger import (
    QuenchedSchwingerAction,
)
from mlmcpathintegral.parallel.spatial import (
    make_schwinger_sweep_noise, make_sharded_schwinger_heatbath,
    make_sharded_schwinger_sweep, schwinger_heatbath_sweep_noise,
)


def _schwinger(Mt=8, Mx=8, beta=2.0):
    lat = Lattice2D(Mt, Mx, CoarseningType.BOTH)
    return QuenchedSchwingerAction(lat, beta=beta,
                                   renormalisation=RenormalisationType.NONE)


@pytest.mark.parametrize("n_dev", [2, 4])
def test_sharded_schwinger_sweep_matches_dense(n_dev):
    """Same noise -> bit-identical link fields, sharded vs dense."""
    act = _schwinger(8, 8, beta=2.0)
    mesh = _mesh(n_dev)
    sweep = make_sharded_schwinger_sweep(act, mesh, axis="space")
    key = jax.random.PRNGKey(3)
    k1, k2, k3 = jax.random.split(key, 3)
    theta = act.initialise_state(k1, 6, jnp.float64)
    for k in (k2, k3):   # two sweeps: the second starts from real staples
        noise = make_schwinger_sweep_noise(k, act, 6, max_iter=6)
        dense = schwinger_heatbath_sweep_noise(act, theta, noise)
        sharded = sweep(theta, noise)
        np.testing.assert_allclose(np.asarray(sharded), np.asarray(dense),
                                   rtol=1e-12, atol=1e-12)
        theta = dense


def test_sharded_schwinger_dp_sp_mesh():
    """2-D dp x sp layout: chains and rows sharded simultaneously."""
    devices = np.array(jax.local_devices(backend="cpu")[:8]).reshape(2, 4)
    if devices.size < 8:
        pytest.skip("needs 8 virtual CPU devices")
    from jax.sharding import Mesh
    mesh = Mesh(devices, ("chains", "space"))
    act = _schwinger(8, 8, beta=2.0)
    sweep = make_sharded_schwinger_sweep(act, mesh, axis="space",
                                         chain_axis="chains")
    key = jax.random.PRNGKey(4)
    k1, k2 = jax.random.split(key)
    theta = act.initialise_state(k1, 8, jnp.float64)
    noise = make_schwinger_sweep_noise(k2, act, 8, max_iter=6)
    dense = schwinger_heatbath_sweep_noise(act, theta, noise)
    sharded = sweep(theta, noise)
    np.testing.assert_allclose(np.asarray(sharded), np.asarray(dense),
                               rtol=1e-12, atol=1e-12)


def test_sharded_schwinger_keyed_heatbath_plaquette():
    """The keyed per-shard-stream variant equilibrates to the analytic
    mean plaquette <cos theta_P> = I1(beta)/I0(beta)."""
    from scipy.special import i0e, i1e
    act = _schwinger(8, 8, beta=1.0)
    mesh = _mesh(4)
    sweep = make_sharded_schwinger_heatbath(act, mesh, axis="space")
    key = jax.random.PRNGKey(5)
    theta = act.initialise_state(key, 2048, jnp.float64)
    for i in range(40):
        theta = sweep(jax.random.fold_in(key, i), theta)
    cosp = float(jnp.mean(jnp.cos(act.plaquette_angles(theta))))
    expect = i1e(1.0) / i0e(1.0)
    assert cosp == pytest.approx(expect, abs=5e-3)
