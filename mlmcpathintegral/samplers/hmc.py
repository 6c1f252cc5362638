"""Hybrid Monte Carlo, batched over chains.

Reference parity: src/sampler/hmcsampler.{hh,cc}.  The integrator is the
reference's symplectic (leapfrog) scheme with half-steps at both ends
(hmcsampler.cc:22-69): nt+1 force evaluations per trajectory.  The step size
is auto-tuned to a target acceptance rate by bisection
(hmcsampler.cc:77-113); here each bisection iterate measures acceptance over
*all chains at once*, so far fewer sequential samples are needed for the
same estimator accuracy.

One trajectory for all chains is a single fused XLA
program (momentum draw, nt-step ``lax.scan`` of force/drift, batched
Metropolis accept).  ``dt`` lives in the sampler state as a traced scalar so
retuning never triggers recompilation.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from mlmcpathintegral.samplers.base import Sampler, default_dtype


class HMCState(NamedTuple):
    x: jnp.ndarray    # [C, ndof] current positions
    dt: jnp.ndarray   # scalar step size (traced; tuned once at startup)


class HMCSampler(Sampler):

    def __init__(self, action, nt: int = 100, dt: float = 0.1,
                 n_rep: int = 1, n_burnin: int = 100, unroll: int = 1):
        super().__init__(action)
        self.nt = int(nt)
        self.dt0 = float(dt)
        self.n_rep = int(n_rep)
        self.n_burnin = int(n_burnin)
        #: unroll factor for the leapfrog scan — unrolling lets XLA fuse
        #: several force/drift steps into one kernel, trading compile time
        #: for far fewer device-memory round trips
        self.unroll = int(unroll)

    # -- state -----------------------------------------------------------------

    def init(self, key, n_chains, dtype=None):
        dtype = dtype or default_dtype()
        x = self.action.initialise_state(key, n_chains, dtype)
        return HMCState(x=x, dt=jnp.asarray(self.dt0, dtype))

    # -- kernel ----------------------------------------------------------------

    def _single_step(self, key, x, dt):
        """One HMC trajectory + Metropolis test on all chains
        (hmcsampler.cc:22-69). Returns (x_new, accept[C])."""
        force = self.action.force
        k_mom, k_acc = jax.random.split(key)
        p = jax.random.normal(k_mom, x.shape, x.dtype)
        T_cur = 0.5 * jnp.sum(p * p, axis=-1)
        S_cur = self.action.evaluate(x)

        # leapfrog: half kick, (nt-1) x (drift + full kick), drift, half kick
        xt = x
        p = p - (0.5 * dt) * force(xt)
        xt = xt + dt * p

        def body(carry, _):
            xt, p = carry
            p = p - dt * force(xt)
            xt = xt + dt * p
            return (xt, p), None

        (xt, p), _ = jax.lax.scan(body, (xt, p), None, length=self.nt - 1,
                                  unroll=min(self.unroll, self.nt - 1)
                                  if self.nt > 1 else 1)
        p = p - (0.5 * dt) * force(xt)

        T_trial = 0.5 * jnp.sum(p * p, axis=-1)
        S_trial = self.action.evaluate(xt)
        dH = (S_trial - S_cur) + (T_trial - T_cur)
        u = jax.random.uniform(k_acc, dH.shape, dH.dtype)
        accept = jnp.logical_or(dH < 0.0, u < jnp.exp(-dH))
        x_new = jnp.where(accept[..., None], xt, x)
        return x_new, accept

    def draw(self, key, state: HMCState):
        """n_rep repetitions; accept = OR over repetitions
        (hmcsampler.cc:8-19)."""
        if self.n_rep == 1:
            x, accept = self._single_step(key, state.x, state.dt)
            return state._replace(x=x), accept

        def body(carry, k):
            x, acc = carry
            x, a = self._single_step(k, x, state.dt)
            return (x, jnp.logical_or(acc, a)), None

        keys = jax.random.split(key, self.n_rep)
        acc0 = jnp.zeros(state.x.shape[:-1], bool)
        (x, accept), _ = jax.lax.scan(body, (state.x, acc0), keys)
        return state._replace(x=x), accept

    # -- step-size autotuning (hmcsampler.cc:77-113) ---------------------------

    def autotune_stepsize(self, key, state: HMCState,
                          p_accept_target: float = 0.8,
                          n_iter: int = 30, n_tune_steps: int = 50,
                          tolerance: float = 1e-2, verbose: bool = False):
        """Bisect dt in [dt/2, 2 dt] to hit the target acceptance rate.

        Acceptance per iterate is measured over n_tune_steps x n_chains
        trajectories; with hundreds of chains this matches the reference's
        100 x 1000-sample tuning accuracy at a fraction of the sequential
        steps.  Returns the tuned state (dt reverts if not converged,
        mirroring hmcsampler.cc:103-109)."""

        @jax.jit
        def tune_chunk(key, x, dt):
            def body(carry, k):
                x, n_acc = carry
                x, a = self._single_step(k, x, dt)
                return (x, n_acc + jnp.sum(a, dtype=jnp.int32)), None
            keys = jax.random.split(key, n_tune_steps)
            (x, n_acc), _ = jax.lax.scan(body, (x, jnp.zeros((), jnp.int32)),
                                         keys)
            return x, n_acc / (n_tune_steps * x.shape[0])

        dt0 = float(state.dt)
        dt_min, dt_max = 0.5 * dt0, 2.0 * dt0
        x = state.x
        converged = False
        dt = dt0
        for k in range(n_iter):
            key, sub = jax.random.split(key)
            dt = 0.5 * (dt_min + dt_max)
            x, p_acc = tune_chunk(sub, x, jnp.asarray(dt, state.dt.dtype))
            p_acc = float(p_acc)
            if p_acc > p_accept_target:
                dt_min = dt
            else:
                dt_max = dt
            if abs(p_acc - p_accept_target) < tolerance:
                converged = True
            if verbose:
                print(f"  autotune iter {k}: dt={dt:.5f} p_acc={p_acc:.4f}")
        if not converged:
            dt = dt0
        return HMCState(x=x, dt=jnp.asarray(dt, state.dt.dtype))

    def prepare(self, key, n_chains, dtype=None, p_accept_target: float = 0.8):
        """init + burn-in + autotune, as the reference ctor does
        (hmcsampler.hh:84-109)."""
        k1, k2, k3 = jax.random.split(key, 3)
        state = self.init(k1, n_chains, dtype)
        if self.n_burnin > 0:
            @jax.jit
            def burn(key, state):
                def body(s, k):
                    s, _ = self.draw(k, s)
                    return s, None
                keys = jax.random.split(key, self.n_burnin)
                state_out, _ = jax.lax.scan(body, state, keys)
                return state_out
            state = burn(k2, state)
        return self.autotune_stepsize(k3, state, p_accept_target)
