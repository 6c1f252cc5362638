"""Overrelaxed heat-bath sampler with checkerboard sweeps.

Reference parity: src/sampler/overrelaxedheatbathsampler.{hh,cc} —
n_sweep_overrelax overrelaxation sweeps followed by n_sweep_heatbath
heat-bath sweeps, delegating the per-site update to the action
(overrelaxedheatbathsampler.cc:8-31).

The reference sweeps sites sequentially in random or lexicographic order;
a sequential sweep is poison on data-parallel hardware.  Here a
sweep is *checkerboarded*: all even sites update simultaneously conditioned
on the odd sites, then all odd sites (each half-sweep is an exact product of
independent conditional draws, so the invariant distribution is unchanged —
only the deterministic site ordering differs from the reference; cf.
SURVEY.md §7.5).  Each half-sweep is one fused XLA kernel over
[n_chains, M/2] sites.

For actions whose per-vertex update spans several dofs (O(3) sigma model),
the action supplies its own colouring via ``heatbath_colour_groups``.

For the quenched Schwinger action, ``fused="cuda"`` runs the draws on the
fused CUDA sweep chain of ops/schwinger.py (float32, on a GPU; one launch
per ``draw_chain``), and ``fused="reference"`` on its plain-JAX reference.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from mlmcpathintegral.samplers.base import Sampler, default_dtype

FUSED_CHOICES = (None, "cuda", "reference")


class HeatBathState(NamedTuple):
    x: jnp.ndarray   # [C, ndof]


class OverrelaxedHeatBathSampler(Sampler):
    """1-D checkerboard overrelaxed heat bath for QM actions.

    The action must provide ``heatbath_site(key, x_m, x_p)`` and
    ``overrelax_site(x, x_m, x_p)`` (base.QMAction API).
    """

    def __init__(self, action, n_sweep_heatbath: int = 1,
                 n_sweep_overrelax: int = 1, n_burnin: int = 100,
                 fused: str | None = None):
        super().__init__(action)
        if fused not in FUSED_CHOICES:
            raise ValueError(f"fused must be one of {FUSED_CHOICES}, "
                             f"got {fused!r}")
        if fused is not None:
            from mlmcpathintegral.models.qft.schwinger import (
                QuenchedSchwingerAction,
            )
            if type(action) is not QuenchedSchwingerAction:
                raise ValueError("the fused heat-bath sweep runs the "
                                 "quenched Schwinger action only, got "
                                 f"{type(action).__name__}")
        self.fused = fused
        #: actions providing whole-lattice coloured sweeps (2-D QFT models)
        #: are used directly; otherwise the generic 1-D even/odd site sweep
        #: drives the action's heatbath_site/overrelax_site
        self._action_sweeps = hasattr(action, "heatbath_sweep")
        if not self._action_sweeps and action.lattice.M_lat % 2:
            raise ValueError("checkerboard sweep needs even M_lat")
        self.n_sweep_heatbath = int(n_sweep_heatbath)
        self.n_sweep_overrelax = int(n_sweep_overrelax)
        self.n_burnin = int(n_burnin)

    def init(self, key, n_chains, dtype=None):
        dtype = dtype or default_dtype()
        return HeatBathState(x=self.action.initialise_state(key, n_chains,
                                                            dtype))

    # -- half-sweeps -----------------------------------------------------------

    def _half_sweep_heatbath(self, key, x, parity: int):
        """Update all sites of one parity from their conditional
        distribution given the (frozen) other parity."""
        x_m = jnp.roll(x, 1, axis=-1)[..., parity::2]
        x_p = jnp.roll(x, -1, axis=-1)[..., parity::2]
        new = self.action.heatbath_site(key, x_m, x_p,
                                        x_cur=x[..., parity::2])
        return x.at[..., parity::2].set(new)

    def _half_sweep_overrelax(self, x, parity: int):
        x_m = jnp.roll(x, 1, axis=-1)[..., parity::2]
        x_p = jnp.roll(x, -1, axis=-1)[..., parity::2]
        new = self.action.overrelax_site(x[..., parity::2], x_m, x_p)
        return x.at[..., parity::2].set(new)

    # -- draw ------------------------------------------------------------------

    def _fused_chain(self, key, x, n_steps: int):
        """``n_steps`` draws in one launch of the fused sweep chain;
        returns (x', qsum)."""
        from mlmcpathintegral.ops.schwinger import schwinger_sweep_chain
        lat = self.action.lattice
        # two 32-bit words of per-launch entropy (ops/counter_rng.py)
        seed = jax.random.randint(key, (2,), -2**31, 2**31 - 1, jnp.int32)
        x, qsum, _ = schwinger_sweep_chain(
            x, seed, beta=self.action.beta, Mt=lat.Mt_lat, Mx=lat.Mx_lat,
            n_steps=n_steps, n_overrelax=self.n_sweep_overrelax,
            n_heatbath=self.n_sweep_heatbath,
            reference=self.fused == "reference")
        return x, qsum

    def draw(self, key, state: HeatBathState):
        x = state.x
        if self.fused is not None:
            x, _ = self._fused_chain(key, x, 1)
        elif self._action_sweeps:
            combined = getattr(self.action, "combined_sweeps", None)
            if combined is not None:
                x = combined(key, x, self.n_sweep_overrelax,
                             self.n_sweep_heatbath)
            else:
                for _ in range(self.n_sweep_overrelax):
                    x = self.action.overrelaxation_sweep(x)
                for _ in range(self.n_sweep_heatbath):
                    key, sub = jax.random.split(key)
                    x = self.action.heatbath_sweep(sub, x)
        else:
            for _ in range(self.n_sweep_overrelax):
                x = self._half_sweep_overrelax(x, 0)
                x = self._half_sweep_overrelax(x, 1)
            for _ in range(self.n_sweep_heatbath):
                k0, k1, key = jax.random.split(key, 3)
                x = self._half_sweep_heatbath(k0, x, 0)
                x = self._half_sweep_heatbath(k1, x, 1)
        accept = jnp.ones(x.shape[:-1], bool)   # heat bath always accepts
        return HeatBathState(x=x), accept

    def draw_chain(self, key, state: HeatBathState, n_steps: int):
        """``n_steps`` consecutive draws, returning ``(state', qsum)``
        with qsum[s, c] = sum_P mod_2pi(theta_P) after step s — the
        topological sum whose square / 4 pi^2 is the susceptibility QoI
        (qoi.qoi_2d_susceptibility); gauge actions only.  With ``fused``
        set this is ONE launch of the sweep chain: the link field stays
        on chip across all steps and only the [n_steps, C] trace leaves
        it; otherwise a scan of draw()."""
        from mlmcpathintegral.utils.special import mod_2pi

        if self.fused is not None:
            x, qsum = self._fused_chain(key, state.x, n_steps)
            return HeatBathState(x=x), qsum

        def body(ss, k):
            ss, _ = self.draw(k, ss)
            q = jnp.sum(mod_2pi(self.action.plaquette_angles(ss.x)),
                        axis=(-2, -1))
            return ss, q
        state, qsum = jax.lax.scan(body, state,
                                   jax.random.split(key, n_steps))
        return state, qsum

    def prepare(self, key, n_chains, dtype=None):
        return super().prepare(key, n_chains, dtype, self.n_burnin)
