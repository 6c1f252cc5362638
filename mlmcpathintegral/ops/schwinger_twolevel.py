"""Fused two-level (delayed-acceptance) MLMC chunk of the quenched
Schwinger model — the MLMC hot path.

One launch runs ``n_steps`` full level draws per chain:

  per step:  t_sub coarse heat-bath sweeps (the tau-subsampled coarse
             proposal, montecarlotwolevel.cc:82-94)
          -> prolongate + 3-step conditioned fill-in
             (quenchedschwingerconditionedfineaction.cc:7-78)
          -> the three dS terms + Metropolis accept
             (twolevelmetropolisstep.cc:35-89)
          -> emit Y = Q_fine - Q_coarse, coarse-QoI trace, accept bits

On the GPU this is the CUDA kernel of ops/cuda/schwinger.cu, with the
coarse field and the trial fine field resident in shared memory for the
whole launch.  This module holds its plain-JAX reference (chosen only by
``reference=True``) and the pieces both share.  The reference stores the
fine lattice as EIGHT parity components T_ab = T(j=2J+a, i=2I+b), X_ab
likewise, each [Mxc, Mtc, C] — the checkerboard decomposition by coarse
cell — so every stencil the screen needs (sub-plaquettes, fill-in cell
maps, restriction) is a roll of whole components.

Fill-in draws run the same Gaussian-envelope rejection samplers as
``distributions/{besselproduct,expcos}.py`` but truncated at a static
round count.  A lane whose rejection loop never accepts would bias the
proposal density, so instead the whole two-level move of that chain is
FORCE-REJECTED: conditioned on acceptance within k rounds a rejection
sample is still exactly q-distributed, and the failure event depends only
on the conditioning staples, so "fail -> stay" is an exact mixture of MH
kernels (same argument as distributions/rejection.py, applied at the
level of the move rather than the site).

Special functions in plain arithmetic (the same polynomials run in the
CUDA kernel): erf by Abramowitz-Stegun 7.1.26, log I0 by A&S 9.8.1/9.8.2 —
both accurate to ~2e-7, at the f32 round-off the kernels run in.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

from mlmcpathintegral.ops import cuda_kernels
from mlmcpathintegral.ops.counter_rng import (
    CounterRng, check_element_capacity, element_ids,
)
from mlmcpathintegral.ops.schwinger import (
    _expcos_rejection, _mod_2pi, _one_step, seed_words,
)

PI = math.pi
TWO_PI = 2.0 * math.pi
FOURPI2_INV = 1.0 / (4.0 * math.pi * math.pi)


# ---------------------------------------------------------------------------
# In-kernel special functions
# ---------------------------------------------------------------------------

_ERF_P = 0.3275911
_ERF_A = (0.254829592, -0.284496736, 1.421413741, -1.453152027, 1.061405429)


def kernel_erf(x):
    """Abramowitz & Stegun 7.1.26 (|err| < 1.5e-7) in plain vector ops."""
    s = jnp.sign(x)
    z = jnp.abs(x)
    t = 1.0 / (1.0 + _ERF_P * z)
    poly = jnp.zeros_like(t)
    for a in reversed(_ERF_A):
        poly = (poly + a) * t
    return s * (1.0 - poly * jnp.exp(-z * z))


_I0_SMALL = (1.0, 3.5156229, 3.0899424, 1.2067492, 0.2659732,
             0.0360768, 0.0045813)
_I0_LARGE = (0.39894228, 0.01328592, 0.00225319, -0.00157565, 0.00916281,
             -0.02057706, 0.02635537, -0.01647633, 0.00392377)


def kernel_log_i0(x):
    """log I0(x), A&S 9.8.1/9.8.2 (|rel err| < 2e-7), stable for large x."""
    z = jnp.abs(x)
    # small branch: I0 = poly((z/3.75)^2)
    t2 = (z / 3.75) ** 2
    ps = jnp.zeros_like(z)
    for a in reversed(_I0_SMALL):
        ps = ps * t2 + a
    # large branch: I0 = e^z/sqrt(z) poly(3.75/z)
    u = 3.75 / jnp.maximum(z, 3.75)
    pl_ = jnp.zeros_like(z)
    for a in reversed(_I0_LARGE):
        pl_ = pl_ * u + a
    zs = jnp.maximum(z, 3.75)
    large = zs - 0.5 * jnp.log(zs) + jnp.log(pl_)
    return jnp.where(z < 3.75, jnp.log(ps), large)


# ---------------------------------------------------------------------------
# Parity-component geometry.  Components: T_ab = T(j=2J+a, i=2I+b) on the
# [Mxc(J), Mtc(I), C] grid; ``sh(A, dj, di)`` returns A(J+dj, I+di).
# ---------------------------------------------------------------------------

def jnp_sh(A, dj, di):
    out = A
    if di:
        out = jnp.roll(out, -di, axis=1)
    if dj:
        out = jnp.roll(out, -dj, axis=0)
    return out


def split_parity(grid):
    """[C, Mx, Mt, 2] model grid -> [8, Mxc, Mtc, C] parity components
    (T00, T01, T10, T11, X00, X01, X10, X11)."""
    comps = []
    for mu in (0, 1):
        for a in (0, 1):          # j parity
            for b in (0, 1):      # i parity
                comps.append(grid[:, a::2, b::2, mu])
    return jnp.stack(comps, axis=0).transpose(0, 2, 3, 1)


def merge_parity(comps, dtype=None):
    """[8, Mxc, Mtc, C] -> [C, Mx, Mt, 2]."""
    _, Mxc, Mtc, C = comps.shape
    g = jnp.zeros((C, 2 * Mxc, 2 * Mtc, 2),
                  dtype or comps.dtype)
    k = 0
    for mu in (0, 1):
        for a in (0, 1):
            for b in (0, 1):
                g = g.at[:, a::2, b::2, mu].set(
                    comps[k].transpose(2, 0, 1))
                k += 1
    return g


def sub_plaquettes(f, sh):
    """The four fine plaquette parity grids P_ab = theta_P(j=2J+a, i=2I+b)
    (models/qft/schwinger.py plaquette_angles in components)."""
    T00, T01, T10, T11, X00, X01, X10, X11 = f
    P00 = T00 + X01 - T10 - X00
    P01 = T01 + sh(X00, 0, 1) - T11 - X01
    P10 = T10 + X11 - sh(T00, 1, 0) - X10
    P11 = T11 + sh(X10, 0, 1) - sh(T01, 1, 0) - X11
    return P00, P01, P10, P11


def s_fine(f, beta, sh):
    """beta sum_P (1 - cos theta_P) -> [C]."""
    acc = 0.0
    for P in sub_plaquettes(f, sh):
        acc = acc + jnp.sum(1.0 - jnp.cos(P), axis=(0, 1))
    return beta * acc


def q_topological(f, sh):
    """sum_P mod_2pi(theta_P) -> [C] (qoi2dsusceptibility.cc:6-28)."""
    acc = 0.0
    for P in sub_plaquettes(f, sh):
        acc = acc + jnp.sum(_mod_2pi(P), axis=(0, 1))
    return acc


def coarse_plaquettes(Tc, Xc, sh):
    return Tc + sh(Xc, 0, 1) - sh(Tc, 1, 0) - Xc


def s_coarse(Tc, Xc, beta_c, sh):
    P = coarse_plaquettes(Tc, Xc, sh)
    return beta_c * jnp.sum(1.0 - jnp.cos(P), axis=(0, 1))


def q_coarse(Tc, Xc, sh):
    P = coarse_plaquettes(Tc, Xc, sh)
    return jnp.sum(_mod_2pi(P), axis=(0, 1))


def restrict_comps(f):
    """Fine components -> coarse links, mod 2pi
    (quenchedschwingeraction.cc:148-163 'both' case)."""
    T00, T01, T10, T11, X00, X01, X10, X11 = f
    return _mod_2pi(T00 + T01), _mod_2pi(X00 + X10)


# ---------------------------------------------------------------------------
# Conditioned fill-in (quenchedschwingerconditionedfineaction.cc:7-78)
# ---------------------------------------------------------------------------

def _expcos_fill_draw(rng, tp, tm, beta, k_rej, dtype):
    """ExpCos rejection draw WITHOUT fallback: returns (x, ok).  Lanes with
    ok=False carry no valid sample and must force-reject the move."""
    dx = tm - tp
    tau = 2.0 * beta * jnp.abs(jnp.cos(0.5 * dx))
    shift = 0.5 * (tp + tm) + jnp.where(jnp.abs(dx) > PI, PI, 0.0)
    x, acc = _expcos_rejection(rng, tau, k_rej, dtype)
    return _mod_2pi(x + shift), acc


def _bessel_draw(rng, x_p, x_m, beta, log_i0_2beta, sigma_beta, k_rej,
                 dtype):
    """BesselProduct two-piece Gaussian-envelope rejection draw
    (distributions/besselproduct.py draw), truncated; returns (x, ok)."""
    sb = sigma_beta
    dx0 = x_m - x_p
    sign = jnp.where(dx0 < 0, -1.0, 1.0).astype(dtype)
    dx = jnp.abs(dx0)

    log_C_p = 2.0 * log_i0_2beta * (1.0 - dx * dx * FOURPI2_INV)
    log_C_m = 2.0 * log_i0_2beta * (1.0 - (dx - TWO_PI) ** 2 * FOURPI2_INV)
    # side choice ~ C_s ONLY (not C_s * erf-mass): proposals are from the
    # untruncated piece Gaussian with in-interval rejection, which already
    # pays the interval mass — see distributions/besselproduct.py draw
    d = jnp.clip(log_C_p - log_C_m, -60.0, 60.0)
    p_right = 1.0 / (1.0 + jnp.exp(-d))
    sigma = sb / math.sqrt(2.0)

    small_beta = 2.0 * log_i0_2beta <= 1.0   # static: flat-density regime

    def round_(r, carry):
        x, acc = carry
        if small_beta:
            # uniform envelope, global bound p~ <= I0(2 beta)^2 — the
            # piece Gaussians are wider than the circle here (see
            # distributions/besselproduct.py draw)
            prop = PI * (2.0 * r.uniform(dtype) - 1.0)
            log_rho = (kernel_log_i0(2.0 * beta * jnp.cos(0.5 * prop))
                       + kernel_log_i0(2.0 * beta
                                       * jnp.cos(0.5 * (prop - dx)))
                       - 2.0 * log_i0_2beta)
            in_interval = jnp.ones(dx.shape, jnp.bool_)
        else:
            right = r.uniform(dtype) < p_right
            mu = jnp.where(right, 0.5 * dx, 0.5 * dx - PI)
            a_min = jnp.where(right, -PI + dx, -PI)
            a_max = jnp.where(right, PI, -PI + dx)
            log_C = jnp.where(right, log_C_p, log_C_m)
            prop = mu + sigma * r.normal(dtype)
            in_interval = jnp.logical_and(prop >= a_min, prop < a_max)
            u = (prop - mu) / sb
            log_rho = (kernel_log_i0(2.0 * beta * jnp.cos(0.5 * prop))
                       + kernel_log_i0(2.0 * beta
                                       * jnp.cos(0.5 * (prop - dx)))
                       - log_C + u * u)
        xi = r.uniform(dtype)
        ok = jnp.logical_and(in_interval, jnp.log(xi) <= log_rho)
        x = jnp.where(jnp.logical_and(ok, ~acc), prop, x)
        return x, jnp.logical_or(acc, ok)

    x, acc = rng.rounds(k_rej, 2 if small_beta else 4, round_,
                        (jnp.zeros_like(dx), jnp.zeros(dx.shape, jnp.bool_)))
    return _mod_2pi(sign * x + x_p), acc


def _approx_fold(x0):
    """Map x_p - x_m to [0, pi] with sign bookkeeping
    (approximatebesselproductdistribution.cc:10-19)."""
    sign = jnp.where(x0 < 0, -1.0, 1.0)
    x0 = jnp.abs(x0)
    flip = x0 > PI
    sign = jnp.where(flip, -sign, sign)
    x0 = jnp.where(flip, TWO_PI - x0, x0)
    return x0, sign


def _approx_params(x0, beta):
    """(N_p, s2p, s2m) of the large-beta Gaussian mixture
    (approximatebesselproductdistribution.cc:39-55); the mixture weight
    is computed in log space (f32-safe for s2m -> 0)."""
    eps = 0.125 * PI
    s2p = jnp.where(x0 < eps, beta, beta * jnp.cos(0.25 * x0))
    s2m_raw = beta * jnp.sin(0.25 * x0)
    s2m_c = jnp.maximum(s2m_raw, 1e-20)
    log_rho = 1.5 * (jnp.log(s2p) - jnp.log(s2m_c)) \
        - 4.0 * (s2p - s2m_raw)
    N_p = jnp.where(x0 < eps, 1.0,
                    1.0 / (1.0 + jnp.exp(jnp.clip(log_rho, -60.0, 60.0))))
    s2m = jnp.where(x0 < eps, 0.0, s2m_raw)
    return N_p, s2p, s2m


def _approx_bessel_draw(rng, x_p, x_m, beta, dtype):
    """Large-beta Gaussian-mixture draw (distributions/
    approxbesselproduct.py draw) — direct, no rejection; ok always."""
    x0, sign = _approx_fold(x_p - x_m)
    N_p, s2p, s2m = _approx_params(x0, beta)
    main = rng.uniform(dtype) <= N_p
    sigma = jnp.where(main, jax.lax.rsqrt(s2p),
                      jax.lax.rsqrt(jnp.maximum(s2m, 1e-20)))
    xshift = jnp.where(main, 0.0, PI)
    x = sigma * rng.normal(dtype) + 0.5 * x0 - xshift
    return _mod_2pi(sign * x + x_m), jnp.ones(x.shape, jnp.bool_)


def _approx_log_eval(x, x_p, x_m, beta, kmax=4):
    """log of the mixture density with 2 kmax + 1 periodic copies
    (approximatebesselproductdistribution.cc:7-36 / distributions/
    approxbesselproduct.py evaluate)."""
    x0, sign = _approx_fold(x_p - x_m)
    z = sign * (x - x_m)
    N_p, s2p, s2m = _approx_params(x0, beta)
    s_p = jnp.zeros_like(z)
    s_m = jnp.zeros_like(z)
    for k in range(-kmax, kmax + 1):
        zs = z - 0.5 * x0 + 2.0 * k * PI
        s_p = s_p + jnp.sqrt(s2p) * jnp.exp(-0.5 * s2p * zs * zs)
        zs = zs + PI
        s_m = s_m + jnp.sqrt(jnp.maximum(s2m, 0.0)) * jnp.exp(
            -0.5 * s2m * zs * zs)
    dens = math.sqrt(0.5 / math.pi) * (N_p * s_p + (1.0 - N_p) * s_m)
    return jnp.log(jnp.maximum(dens, 1e-30))


def _expcos_log_eval(x, beta, tp, tm):
    """log p(x | tp, tm) of ExpCos, stable for large beta
    (distributions/expcos.py log_evaluate)."""
    sigma = 2.0 * beta * jnp.abs(jnp.cos(0.5 * (tp - tm)))
    s = beta * (jnp.cos(x - tp) + jnp.cos(x - tm))
    return s - math.log(TWO_PI) - kernel_log_i0(sigma)


def prolongate_fill(rng, Tc, Xc, beta, log_i0_2beta, sigma_beta,
                    k_rej, k_rej_bessel, sh, dtype, exact=True):
    """Trial fine state: prolongate the coarse links + 3-step fill-in.
    ``exact`` selects the BesselProduct STEP-2 branch (beta <= 8) vs the
    large-beta Gaussian-mixture approximation
    (quenchedschwingerconditionedfineaction.hh:37-44).
    Returns (components, fill_ok[C]) — fill_ok False where any cell's
    truncated rejection loop failed (-> force-reject that chain's move)."""
    # prolongate 'both' (quenchedschwingeraction.cc:92-146): each coarse
    # link splits evenly over its two fine halves
    T00 = 0.5 * Tc
    T01 = 0.5 * Tc
    X00 = 0.5 * Xc
    X10 = 0.5 * Xc

    # STEP 1: perimeter randomisation — +-u on the two halves
    u_t = PI * (2.0 * rng.uniform(dtype) - 1.0)
    u_x = PI * (2.0 * rng.uniform(dtype) - 1.0)
    T00 = _mod_2pi(T00 + u_t)
    T01 = _mod_2pi(T01 - u_t)
    X00 = _mod_2pi(X00 + u_x)
    X10 = _mod_2pi(X10 - u_x)

    # STEP 2: interior vertical links — sum from BesselProduct, uniform
    # split (conditioned/schwinger.py fill_fine_points STEP 2)
    theta_p = _mod_2pi(T01 + sh(X00, 0, 1) + sh(X10, 0, 1) - sh(T01, 1, 0))
    theta_m = _mod_2pi(X00 + X10 + sh(T00, 1, 0) - T00)
    if exact:
        theta_tilde, ok_b = _bessel_draw(rng, theta_p, theta_m, beta,
                                         log_i0_2beta, sigma_beta,
                                         k_rej_bessel, dtype)
    else:
        theta_tilde, ok_b = _approx_bessel_draw(rng, theta_p, theta_m,
                                                beta, dtype)
    u = PI * (2.0 * rng.uniform(dtype) - 1.0)
    X01 = _mod_2pi(0.5 * theta_tilde + u)
    X11 = _mod_2pi(0.5 * theta_tilde - u)

    # STEP 3: interior horizontal links (odd-j rows) from ExpCos, split by
    # i parity: T10 = T(2J+1, 2I), T11 = T(2J+1, 2I+1).  Staples of
    # T(2J+1, i):  tp = T(2J, i) + X(2J, i+1) - X(2J, i)  (plaquette above)
    #              tm = X(2J+1, i) + T(2J+2, i) - X(2J+1, i+1)  (below)
    tp_e = _mod_2pi(T00 + X01 - X00)
    tm_e = _mod_2pi(X10 + sh(T00, 1, 0) - X11)
    T10, ok_e = _expcos_fill_draw(rng, tp_e, tm_e, beta, k_rej, dtype)
    tp_o = _mod_2pi(T01 + sh(X00, 0, 1) - X01)
    tm_o = _mod_2pi(X11 + sh(T01, 1, 0) - sh(X10, 0, 1))
    T11, ok_o = _expcos_fill_draw(rng, tp_o, tm_o, beta, k_rej, dtype)

    ok = jnp.logical_and(jnp.logical_and(ok_b, ok_e), ok_o)
    fill_ok = jnp.min(ok.astype(jnp.int32), axis=(0, 1)) > 0   # [C]
    return (T00, T01, T10, T11, X00, X01, X10, X11), fill_ok


def s_cond(f, beta, alphas, sh):
    """Conditioned-action value of a filled fine state, exact beta <= 8
    branch (quenchedschwingerconditionedfineaction.cc:212-265 /
    conditioned/schwinger.py evaluate) -> [C]."""
    T00, T01, T10, T11, X00, X01, X10, X11 = f
    phi_12 = X10 + sh(T00, 1, 0)
    phi_23 = sh(T01, 1, 0) - sh(X10, 0, 1)
    phi_34 = -T01 - sh(X00, 0, 1)
    phi_41 = -T00 + X00
    th_1 = T10
    th_2 = -X11
    th_3 = -T11
    th_4 = X01
    Phi = phi_12 + phi_23 + phi_34 + phi_41
    S = -beta * jnp.sum(
        jnp.cos(th_1 - th_2 - phi_12) + jnp.cos(th_2 - th_3 - phi_23)
        + jnp.cos(th_3 - th_4 - phi_34) + jnp.cos(th_4 - th_1 - phi_41),
        axis=(0, 1))
    # -log Znorm_inv = +log(1 + sum_k alpha_k cos(k Phi)), rescaled series
    series = 1.0
    for k, a_k in enumerate(alphas, start=1):
        series = series + a_k * jnp.cos(float(k) * Phi)
    return S + jnp.sum(jnp.log(series), axis=(0, 1))


def s_cond_approx(f, beta, sh):
    """Conditioned-action value, large-beta branch: vertical-sum mixture
    density + horizontal ExpCos terms
    (quenchedschwingerconditionedfineaction.cc:267-290 /
    conditioned/schwinger.py evaluate beta > 8) -> [C]."""
    T00, T01, T10, T11, X00, X01, X10, X11 = f
    theta_p = _mod_2pi(T01 + sh(X00, 0, 1) + sh(X10, 0, 1)
                       - sh(T01, 1, 0))
    theta_m = _mod_2pi(X00 + X10 + sh(T00, 1, 0) - T00)
    th_v = _mod_2pi(X01 + X11)
    S = -jnp.sum(_approx_log_eval(th_v, theta_p, theta_m, beta),
                 axis=(0, 1))
    tp_e = _mod_2pi(T00 + X01 - X00)
    tm_e = _mod_2pi(X10 + sh(T00, 1, 0) - X11)
    tp_o = _mod_2pi(T01 + sh(X00, 0, 1) - X01)
    tm_o = _mod_2pi(X11 + sh(T01, 1, 0) - sh(X10, 0, 1))
    S = S - jnp.sum(_expcos_log_eval(T10, beta, tp_e, tm_e)
                    + _expcos_log_eval(T11, beta, tp_o, tm_o),
                    axis=(0, 1))
    return S


# ---------------------------------------------------------------------------
# The chunk: plain-JAX reference and CUDA call
# ---------------------------------------------------------------------------

def _twolevel_reference(theta_fine, theta_coarse, scache, seeds, *, beta,
                        beta_c, Mt, Mx, n_steps, t_sub, n_overrelax_c,
                        n_heatbath_c, k_rej, k_rej_fill, k_rej_bessel,
                        alphas, log_i0_2beta, sigma_beta, exact):
    sh = jnp_sh
    dtype = theta_fine.dtype
    C = theta_fine.shape[0]
    Mtc, Mxc = Mt // 2, Mx // 2
    fine = split_parity(theta_fine.reshape(C, Mx, Mt, 2))
    gc = theta_coarse.reshape(C, Mxc, Mtc, 2).transpose(3, 1, 2, 0)
    site, chain = element_ids((Mxc, Mtc, C), seeds[2])
    seed1 = seeds[0].astype(jnp.uint32)
    seed2 = seeds[1].astype(jnp.uint32)

    def body(carry, s):
        f, Tc, Xc, S_f, S_q = carry
        base = s * (t_sub + 1)

        # ---- t_sub coarse heat-bath sweeps (tau-subsampled proposal) ----
        def sweep_body(c2, t):
            Tc, Xc = c2
            rng_t = CounterRng(seed1, site, chain, seed2, step=base + t)
            Tc, Xc = _one_step(Tc, Xc, rng_t, beta=beta_c, Mt=Mtc,
                               n_overrelax=n_overrelax_c,
                               n_heatbath=n_heatbath_c,
                               k_rej=k_rej, dtype=dtype)
            # per-sweep traces: topological sum (QoI clock) AND plaquette
            # energy (the configuration's SLOW mode — the t_sub clock
            # takes max over both)
            P = coarse_plaquettes(Tc, Xc, sh)
            return (Tc, Xc), (jnp.sum(_mod_2pi(P), axis=(0, 1)),
                              jnp.sum(jnp.cos(P), axis=(0, 1)))

        (Tc, Xc), (qc_t, ec_t) = jax.lax.scan(
            sweep_body, (Tc, Xc), jnp.arange(t_sub, dtype=jnp.uint32))
        rng = CounterRng(seed1, site, chain, seed2, step=base + t_sub)

        # ---- trial: prolongate + conditioned fill ----
        trial, fill_ok = prolongate_fill(
            rng, Tc, Xc, beta, log_i0_2beta, sigma_beta,
            k_rej_fill, k_rej_bessel, sh, dtype, exact=exact)

        # ---- the three dS terms (twolevelmetropolisstep.cc:35-89) ----
        S_f_trial = s_fine(trial, beta, sh)
        Tc_r, Xc_r = restrict_comps(f)
        dS_coarse = (s_coarse(Tc_r, Xc_r, beta_c, sh)
                     - s_coarse(Tc, Xc, beta_c, sh))
        if exact:
            S_q_trial = s_cond(trial, beta, alphas, sh)
        else:
            S_q_trial = s_cond_approx(trial, beta, sh)
        dS = (S_f_trial - S_f) + dS_coarse + (S_q - S_q_trial)

        u_acc = rng.uniform(dtype)[0, 0]                       # [C]
        accept = jnp.logical_and(
            fill_ok, jnp.logical_or(dS < 0.0, u_acc < jnp.exp(-dS)))

        f = tuple(jnp.where(accept, t_new, t_old)
                  for t_new, t_old in zip(trial, f))
        S_f = jnp.where(accept, S_f_trial, S_f)
        S_q = jnp.where(accept, S_q_trial, S_q)

        # ---- emit Y = Q_fine - Q_coarse and accept bits ----
        qf = q_topological(f, sh)
        qc = q_coarse(Tc, Xc, sh)
        y = FOURPI2_INV * (qf * qf - qc * qc)
        return (f, Tc, Xc, S_f, S_q), (y, qc_t, ec_t, accept.astype(dtype))

    carry = (tuple(fine[k] for k in range(8)), gc[0], gc[1],
             scache[0], scache[1])
    (f, Tc, Xc, S_f, S_q), (y, qc, ec, acc) = jax.lax.scan(
        body, carry, jnp.arange(n_steps, dtype=jnp.uint32))
    theta_fine_out = merge_parity(jnp.stack(f)).reshape(C, 2 * Mt * Mx)
    theta_coarse_out = jnp.stack([Tc, Xc]).transpose(3, 1, 2, 0).reshape(
        C, 2 * Mtc * Mxc)
    return (theta_fine_out, theta_coarse_out, S_f, S_q, y,
            qc.reshape(n_steps * t_sub, C), ec.reshape(n_steps * t_sub, C),
            acc)


#: the CUDA kernel's static array of BesselProduct series coefficients
MAX_ALPHAS = 32


def _twolevel_cuda(theta_fine, theta_coarse, scache, seeds, *, beta,
                   beta_c, Mt, Mx, n_steps, t_sub, n_overrelax_c,
                   n_heatbath_c, k_rej, k_rej_fill, k_rej_bessel, alphas,
                   log_i0_2beta, sigma_beta, exact):
    cuda_kernels.require_gpu("schwinger_twolevel_chain")
    if theta_fine.dtype != jnp.float32:
        raise ValueError(f"the CUDA two-level chunk runs in float32, got "
                         f"{theta_fine.dtype}; float64 runs take the XLA "
                         f"path")
    if len(alphas) > MAX_ALPHAS:
        raise ValueError(f"at most {MAX_ALPHAS} BesselProduct "
                         f"coefficients, got {len(alphas)}")
    cuda_kernels.register()
    C, nf = theta_fine.shape
    cpc, tpc = twolevel_cta_shape(C, Mt, Mx)
    alpha_arr = np.zeros(MAX_ALPHAS, np.float32)
    alpha_arr[:len(alphas)] = alphas
    f32 = jnp.float32
    trace = jax.ShapeDtypeStruct((n_steps, C), f32)
    ctrace = jax.ShapeDtypeStruct((n_steps * t_sub, C), f32)
    outs = jax.ffi.ffi_call(
        "mlmcpi_schwinger_twolevel_chunk",
        (jax.ShapeDtypeStruct(theta_fine.shape, f32),
         jax.ShapeDtypeStruct(theta_coarse.shape, f32),
         jax.ShapeDtypeStruct((2, C), f32), trace, ctrace, ctrace, trace),
    )(seeds, theta_fine, theta_coarse, scache,
      Mx=np.int32(Mx), Mt=np.int32(Mt), n_steps=np.int32(n_steps),
      t_sub=np.int32(t_sub), n_overrelax_c=np.int32(n_overrelax_c),
      n_heatbath_c=np.int32(n_heatbath_c), k_rej=np.int32(k_rej),
      k_rej_fill=np.int32(k_rej_fill),
      k_rej_bessel=np.int32(k_rej_bessel), exact=np.int32(exact),
      small_beta=np.int32(2.0 * log_i0_2beta <= 1.0),
      beta=np.float32(beta), beta_c=np.float32(beta_c),
      log_i0_2beta=np.float32(log_i0_2beta),
      sigma_beta=np.float32(sigma_beta),
      sigma_half=np.float32(sigma_beta / math.sqrt(2.0)),
      alphas=alpha_arr, n_alpha=np.int32(len(alphas)),
      cpc=np.int32(cpc), tpc=np.int32(tpc))
    fine_o, coarse_o, scache_o, y, qc, ec, acc = outs
    return fine_o, coarse_o, scache_o[0], scache_o[1], y, qc, ec, acc


def twolevel_cta_shape(n_chains: int, Mt: int, Mx: int):
    """CTA shape of the CUDA chunk: shared memory holds the coarse field
    and the trial fine field of each chain; the threads of a chain split
    the coarse colour groups (cuda_kernels.cta_shape)."""
    nf = 2 * Mt * Mx
    return cuda_kernels.cta_shape(n_chains, 4 * (nf + nf // 4),
                                  (Mt // 2) * (Mx // 2) // 2)


@functools.partial(jax.jit, static_argnames=(
    "beta", "beta_c", "Mt", "Mx", "n_steps", "t_sub", "n_overrelax_c",
    "n_heatbath_c", "k_rej", "k_rej_fill", "k_rej_bessel", "reference"))
def schwinger_twolevel_chain(theta_fine, theta_coarse, s_fine_cache,
                             s_cond_cache, seed, *, beta, beta_c, Mt, Mx,
                             n_steps, t_sub=2, n_overrelax_c=1,
                             n_heatbath_c=1, k_rej=8, k_rej_fill=16,
                             k_rej_bessel=48, chain_offset=0,
                             reference=False):
    """``n_steps`` fused two-level MLMC draws in ONE launch.

    theta_fine: [C, 2*Mt*Mx] fine links; theta_coarse: [C, 2*(Mt/2)*(Mx/2)]
    coarse links; s_fine_cache/s_cond_cache: [C] cached action values of
    theta_fine (twolevelmetropolisstep.hh:104-108); ``chain_offset``: the
    global id of the first chain (non-zero for a shard).  Returns
    (theta_fine', theta_coarse', s_fine', s_cond', Y[n_steps, C],
    qc[n_steps*t_sub, C], ec[n_steps*t_sub, C], accept[n_steps, C])
    where Y is the per-draw telescoping sample
    V chi_t(fine) - V chi_t(coarse), qc the coarse topological-sum trace
    (for the coarse-sampler tau_int statistics) and ec the coarse
    per-sweep plaquette-energy trace sum_P cos(theta_P) — the
    configuration slow mode driving the t_sub clock.

    Requires both-direction coarsening.  beta <= 8 runs the exact
    BesselProduct fill branch (besselproductdistribution.hh:38-44);
    beta > 8 the large-beta Gaussian-mixture branch
    (quenchedschwingerconditionedfineaction.hh:37-44).

    Round counts: ``k_rej`` bounds the coarse heat-bath rejection (the
    stay-fallback there is an exact kernel mixture); the FILL rounds
    ``k_rej_fill``/``k_rej_bessel`` instead force-reject the whole
    two-level move on exhaustion, whose probability is weakly
    staple-dependent and therefore a bias source when non-negligible —
    measured -0.09% (3.2 sigma over 6 seeds) at 16x16 beta=8 with
    (8, 16) rounds at a 7% per-chain failure rate (docs/screen_bias.csv).
    The defaults (16, 48) push the per-chain failure below 1e-5 across
    beta <= 8.

    ``reference=True`` runs the plain-JAX reference on any backend;
    otherwise the CUDA kernel runs, on a GPU in float32 only.
    """
    exact = float(beta) <= 8.0
    if exact:
        from mlmcpathintegral.distributions.besselproduct import (
            BesselProductDistribution,
        )
        bp = BesselProductDistribution(float(beta))
        alphas = tuple(float(a) for a in bp.alphaZ[1:])
        log_i0_2beta = bp.log_I0_twobeta
        sigma_beta = bp.sigma_beta
    else:
        alphas = ()
        log_i0_2beta = 0.0
        sigma_beta = 1.0

    C = theta_fine.shape[0]
    if Mt % 2 or Mx % 2:
        raise ValueError(f"two-level chunk needs even Mt, Mx; got {Mt}, {Mx}")
    check_element_capacity((Mx // 2) * (Mt // 2), C)
    scache = jnp.stack([s_fine_cache, s_cond_cache],
                       axis=0).astype(theta_fine.dtype)
    kw = dict(beta=float(beta), beta_c=float(beta_c), Mt=int(Mt),
              Mx=int(Mx), n_steps=int(n_steps), t_sub=int(t_sub),
              n_overrelax_c=int(n_overrelax_c),
              n_heatbath_c=int(n_heatbath_c), k_rej=int(k_rej),
              k_rej_fill=int(k_rej_fill), k_rej_bessel=int(k_rej_bessel),
              alphas=alphas, log_i0_2beta=float(log_i0_2beta),
              sigma_beta=float(sigma_beta), exact=exact)
    seeds = seed_words(seed, chain_offset)
    if reference:
        return _twolevel_reference(theta_fine, theta_coarse, scache, seeds,
                                   **kw)
    return _twolevel_cuda(theta_fine, theta_coarse, scache, seeds, **kw)
