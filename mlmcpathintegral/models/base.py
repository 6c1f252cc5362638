"""Action interfaces (functional, batched).

The reference's OO ``Action`` hierarchy (src/action/action.hh:28-163) becomes
a family of frozen Python objects whose methods are pure, batched jnp
functions: states are arrays ``[..., ndof]`` with all leading axes treated as
chain batch dimensions.  Parameters (m0, mu2, beta, ...) are static Python
floats baked into the jitted program per multigrid level — exactly how the
reference instantiates one Action object per level via ``coarse_action()``.

Forces default to ``jax.grad`` of the action (the reference's hand-derived
force expressions, e.g. harmonicoscillatoraction.cc:21-35, become *tests*
of this gradient rather than code).
"""

from __future__ import annotations

import abc
from enum import Enum

import jax
import jax.numpy as jnp

from mlmcpathintegral.lattice import Lattice1D


class RenormalisationType(Enum):
    """Parameter renormalisation between multigrid levels
    (src/action/renormalisation.hh:17-41)."""
    NONE = "none"
    PERTURBATIVE = "perturbative"
    NONPERTURBATIVE = "nonperturbative"


class Action(abc.ABC):
    """Abstract action over batched states ``x: [..., ndof]``."""

    #: lattice descriptor (static metadata)
    lattice = None

    @property
    def ndof(self) -> int:
        """Number of degrees of freedom (action/action.hh sample_size)."""
        return self.lattice.ndof

    @property
    def evaluation_cost(self) -> int:
        return self.ndof

    @abc.abstractmethod
    def evaluate(self, x: jnp.ndarray) -> jnp.ndarray:
        """S[x] for batched states: [..., ndof] -> [...]."""

    def force(self, x: jnp.ndarray) -> jnp.ndarray:
        """dS/dx, batched. Default: autodiff of evaluate."""
        return jax.grad(lambda y: jnp.sum(self.evaluate(y)))(x)

    @abc.abstractmethod
    def coarse_action(self) -> "Action":
        """Action on the next-coarser lattice with renormalised parameters."""

    @abc.abstractmethod
    def initialise_state(self, key, n_chains: int, dtype) -> jnp.ndarray:
        """Fresh batched initial states [n_chains, ndof]."""

    # -- multigrid transfer (pure slicing) ---------------------------------

    @abc.abstractmethod
    def prolongate(self, x_coarse: jnp.ndarray,
                   x_fine: jnp.ndarray) -> jnp.ndarray:
        """Inject coarse dofs into a fine state (copy_from_coarse)."""

    @abc.abstractmethod
    def restrict(self, x_fine: jnp.ndarray) -> jnp.ndarray:
        """Restrict a fine state to the coarse lattice (copy_from_fine)."""

    def info_string(self) -> str:
        return f"lattice = {self.ndof}"


class QMAction(Action):
    """Base for 1-D quantum-mechanics actions on ``Lattice1D``.

    Adds the single-site conditioned-action geometry W (minimum + curvature
    given the two neighbours; action/qmaction.hh:79-215) used by heat-bath
    updates and the conditioned fine-action fill-in, and even-site
    injection/restriction (qmaction.cc:7-24).
    """

    def __init__(self, lattice: Lattice1D, renormalisation: RenormalisationType,
                 m0: float):
        self.lattice = lattice
        self.renormalisation = renormalisation
        self.m0 = float(m0)

    @property
    def a_lat(self) -> float:
        return self.lattice.a_lat

    @property
    def M_lat(self) -> int:
        return self.lattice.M_lat

    # -- site-conditioned action geometry ----------------------------------

    @abc.abstractmethod
    def getWminimum(self, x_m, x_p):
        """Minimum of the single-site conditioned action W_{x-,x+}(x),
        elementwise over arrays."""

    @abc.abstractmethod
    def getWcurvature(self, x_m, x_p):
        """Curvature W'' at the minimum, elementwise over arrays."""

    def heatbath_site(self, key, x_m, x_p, x_cur=None):
        """Draw new site values from the conditional distribution given the
        neighbours.  Default: Gaussian N(Wmin, 1/Wcurvature) — exact for
        actions quadratic in a single site (harmonic oscillator); quartic
        uses the same Gaussian approximation as the reference
        (qmaction.hh:150-170).  ``x_cur`` (the current site values) lets
        rejection-based implementations truncate their loops exactly; the
        direct Gaussian draw ignores it."""
        mean = self.getWminimum(x_m, x_p)
        curv = self.getWcurvature(x_m, x_p)
        xi = jax.random.normal(key, jnp.shape(mean), dtype=jnp.result_type(x_m))
        return mean + xi / jnp.sqrt(curv)

    def overrelax_site(self, x, x_m, x_p):
        """Deterministic overrelaxation reflection about the W minimum."""
        return 2.0 * self.getWminimum(x_m, x_p) - x

    # -- multigrid transfer -------------------------------------------------

    def prolongate(self, x_coarse, x_fine):
        """x_fine[..., 2j] = x_coarse[..., j] (qmaction.cc:7-15)."""
        return x_fine.at[..., ::2].set(x_coarse)

    def restrict(self, x_fine):
        """x_coarse[..., j] = x_fine[..., 2j] (qmaction.cc:17-24)."""
        return x_fine[..., ::2]

    def initialise_state(self, key, n_chains, dtype=jnp.float32):
        return jnp.zeros((n_chains, self.M_lat), dtype)
