"""Lattice2D index-map tests (reference: src/lattice/lattice2d.{hh,cc})."""

import numpy as np
import pytest

from mlmcpathintegral.lattice2d import CoarseningType, Lattice2D


@pytest.mark.parametrize("ct", list(CoarseningType))
def test_lin2cart_roundtrip(ct):
    lat = Lattice2D(8, 8, ct)
    ell = np.arange(lat.nvertices)
    i, j = lat.vertex_lin2cart(ell)
    np.testing.assert_array_equal(lat.vertex_cart2lin(i, j), ell)


def test_rotated_roundtrip():
    lat = Lattice2D(8, 8, CoarseningType.ROTATE, coarsening_level=1)
    assert lat.rotated
    assert lat.nvertices == 32
    ell = np.arange(lat.nvertices)
    i, j = lat.vertex_lin2cart(ell)
    assert np.all((i + j) % 2 == 0)
    np.testing.assert_array_equal(lat.vertex_cart2lin(i, j), ell)


def test_neighbours_unrotated():
    lat = Lattice2D(4, 4, CoarseningType.BOTH)
    nb = lat.neighbour_vertices
    assert nb.shape == (16, 8)
    # vertex (0,0)=0: nearest neighbours (1,0),( -1,0),(0,1),(0,-1)
    assert set(nb[0, :4]) == {lat.vertex_cart2lin(1, 0),
                              lat.vertex_cart2lin(3, 0),
                              lat.vertex_cart2lin(0, 1),
                              lat.vertex_cart2lin(0, 3)}


def test_neighbours_rotated_are_diagonal_parents():
    lat = Lattice2D(8, 8, CoarseningType.ROTATE, coarsening_level=1)
    nb = lat.neighbour_vertices
    ell = np.arange(lat.nvertices)
    i, j = lat.vertex_lin2cart(ell)
    # nearest neighbours of a rotated vertex sit at (+-1, +-1)
    for k, (di, dj) in enumerate([(1, 1), (1, -1), (-1, 1), (-1, -1)]):
        np.testing.assert_array_equal(
            nb[:, k], lat.vertex_cart2lin((i + di) % 8, (j + dj) % 8))


@pytest.mark.parametrize("ct,expected_shapes", [
    (CoarseningType.BOTH, [(8, 8), (4, 4), (2, 2)]),
    (CoarseningType.TEMPORAL, [(8, 8), (4, 8), (2, 8)]),
    (CoarseningType.SPATIAL, [(8, 8), (8, 4), (8, 2)]),
    (CoarseningType.ALTERNATE, [(8, 8), (4, 8), (4, 4), (2, 4), (2, 2)]),
])
def test_coarsening_chains(ct, expected_shapes):
    lat = Lattice2D(8, 8, ct)
    shapes = [(lat.Mt_lat, lat.Mx_lat)]
    while lat.can_coarsen():
        lat = lat.coarse_lattice()
        shapes.append((lat.Mt_lat, lat.Mx_lat))
    assert shapes == expected_shapes


def test_rotate_chain_alternates_and_halves():
    lat = Lattice2D(8, 8, CoarseningType.ROTATE)
    sizes = [lat.nvertices]
    rotations = [lat.rotated]
    while lat.can_coarsen():
        lat = lat.coarse_lattice()
        sizes.append(lat.nvertices)
        rotations.append(lat.rotated)
    # each rotate-coarsening halves the number of vertices; the chain ends
    # at rotated(2,2) because the unrotated->rotated step keeps (Mt, Mx)
    # and the reference only requires Mt, Mx > 1 (lattice2d.cc:49-80)
    assert sizes == [64, 32, 16, 8, 4, 2]
    assert rotations == [False, True, False, True, False, True]


@pytest.mark.parametrize("ct,level", [
    (CoarseningType.BOTH, 0), (CoarseningType.ROTATE, 0),
    (CoarseningType.ROTATE, 1), (CoarseningType.TEMPORAL, 0),
])
def test_coarse_fine_partition(ct, level):
    lat = Lattice2D(8, 8, ct, coarsening_level=level)
    cv, fv, f2c = (lat.coarse_vertices, lat.fineonly_vertices,
                   lat.fine2coarse)
    assert len(cv) + len(fv) == lat.nvertices
    assert len(set(cv) | set(fv)) == lat.nvertices
    coarse_lat = lat.coarse_lattice()
    assert len(cv) == coarse_lat.nvertices
    # fine2coarse is a bijection onto the coarse lattice
    assert len(set(f2c.tolist())) == coarse_lat.nvertices
