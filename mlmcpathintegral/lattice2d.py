"""2-D lattice metadata: shapes, coarsening state machine, index maps.

Reference parity: src/lattice/lattice2d.{hh,cc}.  A periodic Mt x Mx lattice
(i = temporal index, j = spatial index, linear vertex index
ell = Mt*j + i, lattice2d.hh:230-245) with five coarsening modes
(lattice2d.hh:18-26) including the 45-degree-rotated mode where a "rotated"
lattice keeps only the (i+j)-even vertices of its parent grid
(lattice2d.hh:100-118).

Batched design: all index sets (neighbour lists, coarse/fine-only vertices,
fine-to-coarse maps, link maps) are precomputed *numpy* arrays baked into
jitted programs as gather/scatter constants; states are flat [C, ndof]
arrays in the reference's linear layout so that those constants transfer
1:1, while unrotated actions may reshape to [C, Mx, Mt] and use jnp.roll
stencils (the fast path on an accelerator).
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from functools import cached_property

import numpy as np


class CoarseningType(Enum):
    """lattice2d.hh:18-26."""
    BOTH = "both"
    TEMPORAL = "temporal"
    SPATIAL = "spatial"
    ALTERNATE = "alternate"
    ROTATE = "rotate"


@dataclass(frozen=True)
class Lattice2D:
    Mt_lat: int
    Mx_lat: int
    coarsening_type: CoarseningType = CoarseningType.BOTH
    coarsening_level: int = 0

    # -- basic geometry --------------------------------------------------------

    @property
    def rotated(self) -> bool:
        """Rotated representation: CoarsenRotate at odd levels
        (lattice2d.cc:10-11)."""
        return (self.coarsening_type is CoarseningType.ROTATE
                and self.coarsening_level % 2 == 1)

    def __post_init__(self):
        if self.rotated and (self.Mt_lat % 2 or self.Mx_lat % 2):
            raise ValueError("rotated lattices need even Mt_lat and Mx_lat")

    @property
    def nvertices(self) -> int:
        if self.rotated:
            return self.Mt_lat * self.Mx_lat // 2
        return self.Mt_lat * self.Mx_lat

    @property
    def nedges(self) -> int:
        if self.rotated:
            return self.Mt_lat * self.Mx_lat
        return 2 * self.Mt_lat * self.Mx_lat

    @property
    def ncells(self) -> int:
        return self.nvertices

    @property
    def ndof(self) -> int:
        """Vertex dof count (field theories); gauge theories use nedges."""
        return self.nvertices

    # -- coarsening ------------------------------------------------------------

    def _coarsening_factors(self):
        """(rho_t, rho_x) for this level (lattice2d.cc:20-61)."""
        ct = self.coarsening_type
        if ct is CoarseningType.BOTH:
            return 2, 2
        if ct is CoarseningType.TEMPORAL:
            return 2, 1
        if ct is CoarseningType.SPATIAL:
            return 1, 2
        if ct is CoarseningType.ALTERNATE:
            return (2, 1) if self.coarsening_level % 2 == 0 else (1, 2)
        # ROTATE: unrotated -> rotated keeps Mt,Mx; rotated -> unrotated halves
        if self.rotated:
            return 2, 2
        return 1, 1

    def can_coarsen(self) -> bool:
        rho_t, rho_x = self._coarsening_factors()
        if self.rotated and (self.Mt_lat % 2 or self.Mx_lat % 2):
            return False
        if rho_t > 1 and self.Mt_lat % rho_t:
            return False
        if rho_x > 1 and self.Mx_lat % rho_x:
            return False
        return (self.Mt_lat // rho_t > 1) and (self.Mx_lat // rho_x > 1)

    def coarse_lattice(self) -> "Lattice2D":
        if not self.can_coarsen():
            raise ValueError(f"cannot coarsen {self}")
        rho_t, rho_x = self._coarsening_factors()
        return Lattice2D(self.Mt_lat // rho_t, self.Mx_lat // rho_x,
                         self.coarsening_type, self.coarsening_level + 1)

    # -- index maps (vectorised over numpy arrays) -----------------------------

    def vertex_cart2lin(self, i, j):
        """(i, j) -> linear index (lattice2d.hh:230-245)."""
        i = np.asarray(i)
        j = np.asarray(j)
        Mt, Mx = self.Mt_lat, self.Mx_lat
        if self.rotated:
            assert np.all((i + j) % 2 == 0)
            Mt_half, Mx_half = Mt // 2, Mx // 2
            i_shift = ((i + Mt) - (i & 1)) // 2
            j_shift = ((j + Mx) - (j & 1)) // 2
            offset = (Mt * Mx // 4) * (i & 1)
            return (Mt_half * (j_shift % Mx_half) + i_shift % Mt_half
                    + offset)
        return Mt * ((j + Mx) % Mx) + ((i + Mt) % Mt)

    def vertex_lin2cart(self, ell):
        """linear index -> (i, j) (lattice2d.hh:255-268)."""
        ell = np.asarray(ell)
        Mt, Mx = self.Mt_lat, self.Mx_lat
        if self.rotated:
            Mt_half = Mt // 2
            parity = ell // (Mt * Mx // 4)
            ell_half = ell - (Mt * Mx // 4) * parity
            j_half = ell_half // Mt_half
            j = 2 * j_half + parity
            i = 2 * (ell_half - Mt_half * j_half) + parity
            return i, j
        j = ell // Mt
        i = ell - Mt * j
        return i, j

    def link_cart2lin(self, i, j, mu):
        """Link (i, j, mu) -> linear index ell = 2 Mt j + 2 i + mu;
        mu=0 temporal, mu=1 spatial (lattice2d.hh:348-365)."""
        assert not self.rotated
        Mt, Mx = self.Mt_lat, self.Mx_lat
        i = np.asarray(i); j = np.asarray(j); mu = np.asarray(mu)
        return 2 * Mt * ((j + Mx) % Mx) + 2 * ((i + Mt) % Mt) + mu

    def link_lin2cart(self, ell):
        assert not self.rotated
        Mt = self.Mt_lat
        ell = np.asarray(ell)
        mu = ell % 2
        rest = ell // 2
        j = rest // Mt
        i = rest - Mt * j
        return i, j, mu

    # -- precomputed index arrays ----------------------------------------------

    @cached_property
    def neighbour_vertices(self) -> np.ndarray:
        """[nvertices, 8] neighbour linear indices: 4 nearest then 4
        diagonal; rotated offsets differ (lattice2d.cc:135-155)."""
        if self.rotated:
            off_i = np.array([+1, +1, -1, -1, +2, -2, 0, 0])
            off_j = np.array([+1, -1, +1, -1, 0, 0, +2, -2])
        else:
            off_i = np.array([+1, -1, 0, 0, +1, +1, -1, -1])
            off_j = np.array([0, 0, +1, -1, +1, -1, +1, -1])
        ell = np.arange(self.nvertices)
        i, j = self.vertex_lin2cart(ell)
        Mt, Mx = self.Mt_lat, self.Mx_lat
        ii = (i[:, None] + off_i[None, :] + Mt) % Mt
        jj = (j[:, None] + off_j[None, :] + Mx) % Mx
        return self.vertex_cart2lin(ii, jj)

    @cached_property
    def _coarse_fine_split(self):
        """(coarse_vertices, fineonly_vertices, fine2coarse) sorted linear
        index arrays (lattice2d.cc:82-131); fine2coarse[k] is the coarse
        linear index of coarse_vertices[k]."""
        if not self.can_coarsen():
            raise ValueError(f"{self} cannot be coarsened")
        rho_t, rho_x = self._coarsening_factors()
        coarse_lat = self.coarse_lattice()
        ell = np.arange(self.nvertices)
        i, j = self.vertex_lin2cart(ell)
        if self.coarsening_type is CoarseningType.ROTATE:
            if self.rotated:
                is_coarse = (i % 2 == 0) & (j % 2 == 0)
            else:
                is_coarse = (i + j) % 2 == 0
        else:
            is_coarse = (i % rho_t == 0) & (j % rho_x == 0)
        coarse_vertices = np.sort(ell[is_coarse])
        fineonly_vertices = np.sort(ell[~is_coarse])
        ci, cj = self.vertex_lin2cart(coarse_vertices)
        if self.coarsening_type is CoarseningType.ROTATE and not self.rotated:
            # fine (i+j even) -> rotated coarse keeps the same (i, j)
            fine2coarse = coarse_lat.vertex_cart2lin(ci, cj)
        else:
            fine2coarse = coarse_lat.vertex_cart2lin(ci // rho_t, cj // rho_x)
        return coarse_vertices, fineonly_vertices, fine2coarse

    @property
    def coarse_vertices(self) -> np.ndarray:
        return self._coarse_fine_split[0]

    @property
    def fineonly_vertices(self) -> np.ndarray:
        return self._coarse_fine_split[1]

    @property
    def fine2coarse(self) -> np.ndarray:
        return self._coarse_fine_split[2]

    def __str__(self):
        return (f"Lattice2D(Mt={self.Mt_lat}, Mx={self.Mx_lat}, "
                f"coarsen={self.coarsening_type.value}, "
                f"level={self.coarsening_level}, rotated={self.rotated})")
