// Hopper kernels for the quenched Schwinger model, called through the XLA
// foreign function interface (jax.ffi):
//
//   SchwingerSweepChain    n_steps overrelaxed heat-bath draws of every chain
//                          with the link field resident in shared memory,
//                          emitting the per-step topological sum and
//                          plaquette energy of each chain;
//   SchwingerTwoLevelChunk n_steps two-level (delayed-acceptance) MLMC draws:
//                          t_sub coarse heat-bath sweeps, prolongation, the
//                          conditioned fill-in and the screen per draw.
//
// The plain-JAX references are ops/schwinger.py and ops/schwinger_twolevel.py;
// every arithmetic step below follows them operation for operation, and the
// random numbers come from the counter RNG of ops/counter_rng.py, bit for bit,
// keyed by the GLOBAL chain id (seeds[2] is the id of the first local chain),
// so a sharded run draws the same streams as an unsharded one.
//
// Layout: one thread block (CTA) owns `cpc` chains and holds their fields in
// shared memory for the whole launch, in the action's own order
// ((j * Mt + i) * 2 + mu).  `tpc` threads serve each chain; within a
// (mu, parity) colour group they split the group's links, and a
// __syncthreads() separates the four groups.  Per-chain sums are reduced in
// a fixed order (warp shuffles, then the warps of one chain in order), so a
// launch is deterministic.  Rejection loops run at most k_rej rounds; their
// counters are positional, so stopping at the first acceptance draws the same
// numbers as the reference's fixed rounds.

#include <cstdint>
#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

// float32 roundings of the double constants the references use
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;
constexpr float kHalfPi = 1.57079632679489661923f;
constexpr float kPiSq = 9.86960440108935861883f;
constexpr float kFourPiSqInv = 0.02533029591058444286f;
constexpr float kLogTwoPi = 1.83787706640934548356f;
constexpr float kSqrtHalfOverPi = 0.39894228040143267794f;
constexpr float kEighthPi = 0.39269908169872415481f;
constexpr int kMaxAlpha = 32;
constexpr int kRed = 8;  // values per chain in the two-level reduction

__device__ __forceinline__ float mod_2pi(float x) {
  return x - kTwoPi * floorf(0.5f * (x + kPi) / kPi);
}

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// ops/counter_rng.py CounterRng with a per-step index; `ctr` starts at 1.
struct Rng {
  uint32_t base_s, base_c;
  __device__ Rng(uint32_t seed1, uint32_t seed2, uint32_t site,
                 uint32_t chain, uint32_t step) {
    uint32_t bs = fmix32((site * 0x9E3779B9u) ^ seed1);
    base_s = fmix32(bs + step * 0x165667B1u);
    base_c = fmix32((chain * 0x85EBCA77u) ^ seed2);
  }
  __device__ uint32_t bits(uint32_t ctr) const {
    return fmix32(fmix32(base_s + ctr * 0xC2B2AE3Du) +
                  fmix32(base_c + ctr * 0x27D4EB2Fu));
  }
  __device__ float uniform(uint32_t ctr) const {  // (0, 1]
    return 2.0f - __uint_as_float((bits(ctr) >> 9) | 0x3F800000u);
  }
  __device__ float normal(uint32_t ctr) const {  // consumes ctr, ctr + 1
    float u1 = uniform(ctr);
    float u2 = uniform(ctr + 1);
    return sqrtf(-2.0f * logf(u1)) * cosf(kTwoPi * u2);
  }
};

// Periodic link field of one chain: T = mu 0, X = mu 1, j along Mx, i along Mt.
struct Grid {
  int Mx, Mt;
  __device__ int idx(int j, int i, int mu) const {
    j = j < 0 ? j + Mx : (j >= Mx ? j - Mx : j);
    i = i < 0 ? i + Mt : (i >= Mt ? i - Mt : i);
    return (j * Mt + i) * 2 + mu;
  }
  __device__ float T(const float* f, int j, int i) const {
    return f[idx(j, i, 0)];
  }
  __device__ float X(const float* f, int j, int i) const {
    return f[idx(j, i, 1)];
  }
  // plaquette angle theta_P(j, i), unwrapped
  __device__ float plaq(const float* f, int j, int i) const {
    return T(f, j, i) + X(f, j, i + 1) - T(f, j + 1, i) - X(f, j, i);
  }
};

// --------------------------------------------------------------------------
// Special functions (ops/schwinger_twolevel.py kernel_log_i0)
// --------------------------------------------------------------------------

__device__ float log_i0(float x) {
  const float z = fabsf(x);
  const float t = z / 3.75f;
  const float t2 = t * t;
  float ps = 0.0f;
  ps = ps * t2 + 0.0045813f;
  ps = ps * t2 + 0.0360768f;
  ps = ps * t2 + 0.2659732f;
  ps = ps * t2 + 1.2067492f;
  ps = ps * t2 + 3.0899424f;
  ps = ps * t2 + 3.5156229f;
  ps = ps * t2 + 1.0f;
  const float zs = fmaxf(z, 3.75f);
  const float u = 3.75f / zs;
  float pl = 0.0f;
  pl = pl * u + 0.00392377f;
  pl = pl * u + -0.01647633f;
  pl = pl * u + 0.02635537f;
  pl = pl * u + -0.02057706f;
  pl = pl * u + 0.00916281f;
  pl = pl * u + -0.00157565f;
  pl = pl * u + 0.00225319f;
  pl = pl * u + 0.01328592f;
  pl = pl * u + 0.39894228f;
  if (z < 3.75f) return logf(ps);
  return zs - 0.5f * logf(zs) + logf(pl);
}

// --------------------------------------------------------------------------
// Rejection draws (ops/schwinger.py _expcos_rejection / _expcos_draw)
// --------------------------------------------------------------------------

// x ~ exp(tau cos x) on [-pi, pi); 3 counters per round.  Returns whether a
// round accepted; *x is the first accepted proposal (0 otherwise).
__device__ bool expcos_rejection(const Rng& r, uint32_t ctr, float tau,
                                 int k_rej, float* x) {
  const bool use_uni = tau < 0.45f;
  const float sigma = kHalfPi / sqrtf(fmaxf(tau, 1e-12f));
  *x = 0.0f;
  for (int k = 0; k < k_rej; ++k, ctr += 3) {
    const float u1 = r.uniform(ctr);
    const float u2 = r.uniform(ctr + 1);
    const float prop =
        use_uni ? kPi * (2.0f * u2 - 1.0f)
                : sigma * (sqrtf(-2.0f * logf(u1)) * cosf(kTwoPi * u2));
    const float u = r.uniform(ctr + 2);
    const float log_ratio =
        tau * (cosf(prop) - 1.0f) +
        (use_uni ? 0.0f : 2.0f * tau * prop * prop / kPiSq);
    if (-kPi <= prop && prop < kPi && logf(u) <= log_ratio) {
      *x = prop;
      return true;
    }
  }
  return false;
}

// Draw from exp[beta (cos(x - tp) + cos(x - tm))]; *ok reports acceptance
// and the value is mod_2pi(x + shift) either way.
__device__ float expcos_fill(const Rng& r, uint32_t ctr, float tp, float tm,
                             float beta, int k_rej, bool* ok) {
  const float dx = tm - tp;
  const float tau = 2.0f * beta * fabsf(cosf(0.5f * dx));
  const float shift = 0.5f * (tp + tm) + (fabsf(dx) > kPi ? kPi : 0.0f);
  float x;
  *ok = expcos_rejection(r, ctr, tau, k_rej, &x);
  return mod_2pi(x + shift);
}

// --------------------------------------------------------------------------
// Block-level per-chain reduction
// --------------------------------------------------------------------------

// Sums v over the tpc threads of each chain; chain c's sums land in
// out[c * K + k].  Every thread of the block must call it.
template <int K>
__device__ void chain_reduce(float (&v)[K], float* scratch, float* out,
                             int tpc, int cpc) {
  const int tid = threadIdx.x;
  const int width = tpc < 32 ? tpc : 32;
  for (int off = width >> 1; off > 0; off >>= 1)
    for (int k = 0; k < K; ++k)
      v[k] += __shfl_xor_sync(0xffffffffu, v[k], off);
  if (tpc <= 32) {
    if (tid % tpc == 0 && tid / tpc < cpc)
      for (int k = 0; k < K; ++k) out[(tid / tpc) * K + k] = v[k];
  } else {
    if ((tid & 31) == 0)
      for (int k = 0; k < K; ++k) scratch[(tid >> 5) * K + k] = v[k];
    __syncthreads();
    if (tid % tpc == 0 && tid / tpc < cpc) {
      const int w0 = tid >> 5, nw = tpc >> 5;
      for (int k = 0; k < K; ++k) {
        float s = 0.0f;
        for (int w = 0; w < nw; ++w) s += scratch[(w0 + w) * K + k];
        out[(tid / tpc) * K + k] = s;
      }
    }
  }
  __syncthreads();
}

// --------------------------------------------------------------------------
// The overrelaxed heat-bath step (ops/schwinger.py _one_step)
// --------------------------------------------------------------------------

struct SweepParams {
  int n_or, n_hb, k_rej;
  float beta;
};

struct ChainCtx {
  uint32_t seed1, seed2, chain;  // chain: global chain id
  int lt, tpc;                   // thread's rank within its chain
  bool active;                   // false for padding threads
};

__device__ void sweep_group(float* f, const Grid& g, int mu, int parity,
                            bool heat, const SweepParams& p,
                            const ChainCtx& cx, uint32_t step, uint32_t ctr0) {
  const int ngroup = g.Mx * g.Mt / 2;
  const int half_t = g.Mt / 2;
  for (int l = cx.lt; l < ngroup; l += cx.tpc) {
    int j, i;
    if (mu == 0) {  // temporal links grouped by j parity
      j = 2 * (l / g.Mt) + parity;
      i = l % g.Mt;
    } else {  // spatial links grouped by i parity
      j = l / half_t;
      i = 2 * (l % half_t) + parity;
    }
    float tp, tm;
    if (mu == 0) {
      tp = mod_2pi(g.T(f, j + 1, i) + g.X(f, j, i) - g.X(f, j, i + 1));
      tm = mod_2pi(g.T(f, j - 1, i) + g.X(f, j - 1, i + 1) -
                   g.X(f, j - 1, i));
    } else {
      tp = mod_2pi(g.T(f, j, i) + g.X(f, j, i + 1) - g.T(f, j + 1, i));
      tm = mod_2pi(g.T(f, j + 1, i - 1) + g.X(f, j, i - 1) -
                   g.T(f, j, i - 1));
    }
    float* cur = f + (j * g.Mt + i) * 2 + mu;
    if (!heat) {
      *cur = mod_2pi(tp + tm - *cur);
    } else {
      const Rng r(cx.seed1, cx.seed2, j * g.Mt + i, cx.chain, step);
      bool ok;
      const float x = expcos_fill(r, ctr0, tp, tm, p.beta, p.k_rej, &ok);
      if (ok) *cur = x;  // stragglers keep their link (identity mixture)
    }
  }
}

__device__ void one_step(float* f, const Grid& g, const SweepParams& p,
                         const ChainCtx& cx, uint32_t step) {
  for (int h = 0; h < p.n_or; ++h)
    for (int grp = 0; grp < 4; ++grp) {
      if (cx.active)
        sweep_group(f, g, grp >> 1, grp & 1, false, p, cx, step, 0);
      __syncthreads();
    }
  for (int h = 0; h < p.n_hb; ++h)
    for (int grp = 0; grp < 4; ++grp) {
      if (cx.active)
        sweep_group(f, g, grp >> 1, grp & 1, true, p, cx, step,
                    1u + (uint32_t)((h * 4 + grp) * 3 * p.k_rej));
      __syncthreads();
    }
}

// (sum_P mod_2pi(theta_P), sum_P cos(theta_P)) partials of this thread;
// wrapped_cos selects cos of the wrapped (sweep chain) or the raw
// (two-level coarse trace) plaquette angle, as the references do.
__device__ void plaq_partials(const float* f, const Grid& g,
                              const ChainCtx& cx, bool wrapped_cos,
                              float (&v)[2]) {
  v[0] = v[1] = 0.0f;
  if (!cx.active) return;
  for (int q = cx.lt; q < g.Mx * g.Mt; q += cx.tpc) {
    const float P = g.plaq(f, q / g.Mt, q % g.Mt);
    const float Pw = mod_2pi(P);
    v[0] += Pw;
    v[1] += cosf(wrapped_cos ? Pw : P);
  }
}

__device__ ChainCtx make_ctx(const int32_t* seeds, int cpc, int tpc) {
  ChainCtx cx;
  const int c = threadIdx.x / tpc;
  cx.seed1 = (uint32_t)seeds[0];
  cx.seed2 = (uint32_t)seeds[1];
  cx.chain = (uint32_t)seeds[2] + (uint32_t)(blockIdx.x * cpc + c);
  cx.lt = threadIdx.x % tpc;
  cx.tpc = tpc;
  cx.active = c < cpc;
  return cx;
}

__global__ void sweep_chain_kernel(const int32_t* seeds,
                                   const float* theta_in, float* theta_out,
                                   float* qsum, float* esum, Grid g,
                                   SweepParams p, int n_steps,
                                   int step_offset, int n_chains, int cpc,
                                   int tpc) {
  extern __shared__ float smem[];
  const int ndof = 2 * g.Mx * g.Mt;
  const int nwarps = blockDim.x >> 5;
  float* scratch = smem + cpc * ndof;
  float* red = scratch + nwarps * 2;
  const size_t off = (size_t)blockIdx.x * cpc * ndof;
  for (int k = threadIdx.x; k < cpc * ndof; k += blockDim.x)
    smem[k] = theta_in[off + k];
  __syncthreads();

  const ChainCtx cx = make_ctx(seeds, cpc, tpc);
  const int c = threadIdx.x / tpc;
  const int gc = blockIdx.x * cpc + c;
  float* f = smem + (cx.active ? c : 0) * ndof;
  for (int s = 0; s < n_steps; ++s) {
    one_step(f, g, p, cx, (uint32_t)(step_offset + s));
    float v[2];
    plaq_partials(f, g, cx, true, v);
    chain_reduce<2>(v, scratch, red, tpc, cpc);
    if (cx.active && cx.lt == 0) {
      qsum[(size_t)s * n_chains + gc] = red[c * 2];
      esum[(size_t)s * n_chains + gc] = red[c * 2 + 1];
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < cpc * ndof; k += blockDim.x)
    theta_out[off + k] = smem[k];
}

// --------------------------------------------------------------------------
// Two-level chunk (ops/schwinger_twolevel.py)
// --------------------------------------------------------------------------

struct TwoLevelParams {
  int n_steps, t_sub, k_rej_fill, k_rej_bessel;
  int exact, small_beta, n_alpha;
  float beta, beta_c, log_i0_2beta, sigma_beta, sigma_half;
  float alphas[kMaxAlpha];
};

// Fine field viewed as parity components on the coarse-cell grid:
// comp(a, b, mu) at cell (J, I) is the link (j = 2J + a, i = 2I + b, mu).
struct Cells {
  Grid fine;  // Mx, Mt of the fine lattice
  int Mxc, Mtc;
  __device__ float get(const float* f, int J, int I, int a, int b,
                       int mu) const {
    J = J >= Mxc ? J - Mxc : J;
    I = I >= Mtc ? I - Mtc : I;
    return f[((2 * J + a) * fine.Mt + 2 * I + b) * 2 + mu];
  }
  __device__ void set(float* f, int J, int I, int a, int b, int mu,
                      float v) const {
    f[((2 * J + a) * fine.Mt + 2 * I + b) * 2 + mu] = v;
  }
};

// BesselProduct two-piece Gaussian-envelope draw (_bessel_draw).
__device__ bool bessel_draw(const Rng& r, uint32_t ctr, float x_p, float x_m,
                            const TwoLevelParams& p, float* out) {
  const float dx0 = x_m - x_p;
  const float sign = dx0 < 0.0f ? -1.0f : 1.0f;
  const float dx = fabsf(dx0);
  const float two_log_i0 = 2.0f * p.log_i0_2beta;
  const float two_beta = 2.0f * p.beta;
  const float log_C_p = two_log_i0 * (1.0f - dx * dx * kFourPiSqInv);
  const float dm = dx - kTwoPi;
  const float log_C_m = two_log_i0 * (1.0f - dm * dm * kFourPiSqInv);
  const float d = fminf(fmaxf(log_C_p - log_C_m, -60.0f), 60.0f);
  const float p_right = 1.0f / (1.0f + expf(-d));
  float x = 0.0f;
  bool acc = false;
  for (int k = 0; k < p.k_rej_bessel; ++k) {
    float prop, log_rho, xi;
    bool in_interval;
    if (p.small_beta) {
      prop = kPi * (2.0f * r.uniform(ctr) - 1.0f);
      log_rho = log_i0(two_beta * cosf(0.5f * prop)) +
                log_i0(two_beta * cosf(0.5f * (prop - dx))) - two_log_i0;
      in_interval = true;
      xi = r.uniform(ctr + 1);
      ctr += 2;
    } else {
      const bool right = r.uniform(ctr) < p_right;
      const float mu = right ? 0.5f * dx : 0.5f * dx - kPi;
      const float a_min = right ? -kPi + dx : -kPi;
      const float a_max = right ? kPi : -kPi + dx;
      const float log_C = right ? log_C_p : log_C_m;
      prop = mu + p.sigma_half * r.normal(ctr + 1);
      in_interval = prop >= a_min && prop < a_max;
      const float u = (prop - mu) / p.sigma_beta;
      log_rho = log_i0(two_beta * cosf(0.5f * prop)) +
                log_i0(two_beta * cosf(0.5f * (prop - dx))) - log_C + u * u;
      xi = r.uniform(ctr + 3);
      ctr += 4;
    }
    if (in_interval && logf(xi) <= log_rho) {
      x = prop;
      acc = true;
      break;
    }
  }
  *out = mod_2pi(sign * x + x_p);
  return acc;
}

__device__ void approx_fold(float x0, float* xf, float* sign) {
  float s = x0 < 0.0f ? -1.0f : 1.0f;
  x0 = fabsf(x0);
  if (x0 > kPi) {
    s = -s;
    x0 = kTwoPi - x0;
  }
  *xf = x0;
  *sign = s;
}

__device__ void approx_params(float x0, float beta, float* N_p, float* s2p,
                              float* s2m) {
  const bool near = x0 < kEighthPi;
  *s2p = near ? beta : beta * cosf(0.25f * x0);
  const float s2m_raw = beta * sinf(0.25f * x0);
  const float s2m_c = fmaxf(s2m_raw, 1e-20f);
  const float log_rho =
      1.5f * (logf(*s2p) - logf(s2m_c)) - 4.0f * (*s2p - s2m_raw);
  *N_p = near ? 1.0f
              : 1.0f / (1.0f + expf(fminf(fmaxf(log_rho, -60.0f), 60.0f)));
  *s2m = near ? 0.0f : s2m_raw;
}

// Large-beta Gaussian-mixture draw (_approx_bessel_draw); 3 counters.
__device__ float approx_bessel_draw(const Rng& r, uint32_t ctr, float x_p,
                                    float x_m, float beta) {
  float x0, sign, N_p, s2p, s2m;
  approx_fold(x_p - x_m, &x0, &sign);
  approx_params(x0, beta, &N_p, &s2p, &s2m);
  const bool main_piece = r.uniform(ctr) <= N_p;
  const float sigma = main_piece ? rsqrtf(s2p) : rsqrtf(fmaxf(s2m, 1e-20f));
  const float xshift = main_piece ? 0.0f : kPi;
  const float x = sigma * r.normal(ctr + 1) + 0.5f * x0 - xshift;
  return mod_2pi(sign * x + x_m);
}

__device__ float approx_log_eval(float x, float x_p, float x_m, float beta) {
  float x0, sign, N_p, s2p, s2m;
  approx_fold(x_p - x_m, &x0, &sign);
  const float z = sign * (x - x_m);
  approx_params(x0, beta, &N_p, &s2p, &s2m);
  float s_p = 0.0f, s_m = 0.0f;
  for (int k = -4; k <= 4; ++k) {
    float zs = z - 0.5f * x0 + (float)(2.0 * k * 3.14159265358979323846);
    s_p = s_p + sqrtf(s2p) * expf(-0.5f * s2p * zs * zs);
    zs = zs + kPi;
    s_m = s_m + sqrtf(fmaxf(s2m, 0.0f)) * expf(-0.5f * s2m * zs * zs);
  }
  const float dens = kSqrtHalfOverPi * (N_p * s_p + (1.0f - N_p) * s_m);
  return logf(fmaxf(dens, 1e-30f));
}

__device__ float expcos_log_eval(float x, float beta, float tp, float tm) {
  const float sigma = 2.0f * beta * fabsf(cosf(0.5f * (tp - tm)));
  const float s = beta * (cosf(x - tp) + cosf(x - tm));
  return s - kLogTwoPi - log_i0(sigma);
}

// Counters one fill consumes before the acceptance uniform.
__device__ uint32_t fill_counters(const TwoLevelParams& p) {
  const uint32_t bessel =
      p.exact ? (uint32_t)((p.small_beta ? 2 : 4) * p.k_rej_bessel) : 3u;
  return 2u + bessel + 1u + 6u * (uint32_t)p.k_rej_fill;
}

// Prolongation + STEP 1 of the fill (perimeter randomisation) for one cell.
__device__ void fill_step1(const float* cs, float* ft, const Cells& cl,
                           const Grid& cg, const Rng& r, int J, int I) {
  const float Tc = cg.T(cs, J, I);
  const float Xc = cg.X(cs, J, I);
  const float u_t = kPi * (2.0f * r.uniform(1) - 1.0f);
  const float u_x = kPi * (2.0f * r.uniform(2) - 1.0f);
  cl.set(ft, J, I, 0, 0, 0, mod_2pi(0.5f * Tc + u_t));
  cl.set(ft, J, I, 0, 1, 0, mod_2pi(0.5f * Tc - u_t));
  cl.set(ft, J, I, 0, 0, 1, mod_2pi(0.5f * Xc + u_x));
  cl.set(ft, J, I, 1, 0, 1, mod_2pi(0.5f * Xc - u_x));
}

// STEPS 2 and 3 of the fill for one cell; returns whether every truncated
// rejection loop of the cell accepted.
__device__ bool fill_step23(float* ft, const Cells& cl, const Rng& r,
                            const TwoLevelParams& p, int J, int I) {
  const float T00 = cl.get(ft, J, I, 0, 0, 0);
  const float T01 = cl.get(ft, J, I, 0, 1, 0);
  const float X00 = cl.get(ft, J, I, 0, 0, 1);
  const float X10 = cl.get(ft, J, I, 1, 0, 1);
  const float X00_i = cl.get(ft, J, I + 1, 0, 0, 1);
  const float X10_i = cl.get(ft, J, I + 1, 1, 0, 1);
  const float T00_j = cl.get(ft, J + 1, I, 0, 0, 0);
  const float T01_j = cl.get(ft, J + 1, I, 0, 1, 0);

  // STEP 2: interior vertical links — sum from BesselProduct, uniform split
  const float theta_p = mod_2pi(T01 + X00_i + X10_i - T01_j);
  const float theta_m = mod_2pi(X00 + X10 + T00_j - T00);
  uint32_t ctr = 3;
  float theta_tilde;
  bool ok_b = true;
  if (p.exact) {
    ok_b = bessel_draw(r, ctr, theta_p, theta_m, p, &theta_tilde);
    ctr += (uint32_t)((p.small_beta ? 2 : 4) * p.k_rej_bessel);
  } else {
    theta_tilde = approx_bessel_draw(r, ctr, theta_p, theta_m, p.beta);
    ctr += 3;
  }
  const float u = kPi * (2.0f * r.uniform(ctr) - 1.0f);
  ctr += 1;
  const float X01 = mod_2pi(0.5f * theta_tilde + u);
  const float X11 = mod_2pi(0.5f * theta_tilde - u);

  // STEP 3: interior horizontal links from ExpCos
  const float tp_e = mod_2pi(T00 + X01 - X00);
  const float tm_e = mod_2pi(X10 + T00_j - X11);
  bool ok_e, ok_o;
  const float T10 = expcos_fill(r, ctr, tp_e, tm_e, p.beta, p.k_rej_fill,
                                &ok_e);
  ctr += 3u * (uint32_t)p.k_rej_fill;
  const float tp_o = mod_2pi(T01 + X00_i - X01);
  const float tm_o = mod_2pi(X11 + T01_j - X10_i);
  const float T11 = expcos_fill(r, ctr, tp_o, tm_o, p.beta, p.k_rej_fill,
                                &ok_o);

  cl.set(ft, J, I, 0, 1, 1, X01);
  cl.set(ft, J, I, 1, 1, 1, X11);
  cl.set(ft, J, I, 1, 0, 0, T10);
  cl.set(ft, J, I, 1, 1, 0, T11);
  return ok_b && ok_e && ok_o;
}

// Per-cell partials of the screen: v[1] fine action / beta, v[2], v[3] the
// conditioned action's two sums, v[4] coarse action / beta_c of the coarse
// state, v[5] the same of the restricted fine state, v[6] fine topological
// sum, v[7] coarse topological sum (v[0] is the fill-failure count).
__device__ void cell_partials(const float* ft, const float* cs,
                              const Cells& cl, const Grid& cg,
                              const TwoLevelParams& p, int J, int I,
                              float (&v)[kRed]) {
  const float T00 = cl.get(ft, J, I, 0, 0, 0);
  const float T01 = cl.get(ft, J, I, 0, 1, 0);
  const float T10 = cl.get(ft, J, I, 1, 0, 0);
  const float T11 = cl.get(ft, J, I, 1, 1, 0);
  const float X00 = cl.get(ft, J, I, 0, 0, 1);
  const float X01 = cl.get(ft, J, I, 0, 1, 1);
  const float X10 = cl.get(ft, J, I, 1, 0, 1);
  const float X11 = cl.get(ft, J, I, 1, 1, 1);
  const float X00_i = cl.get(ft, J, I + 1, 0, 0, 1);
  const float X10_i = cl.get(ft, J, I + 1, 1, 0, 1);
  const float T00_j = cl.get(ft, J + 1, I, 0, 0, 0);
  const float T01_j = cl.get(ft, J + 1, I, 0, 1, 0);

  const float P00 = T00 + X01 - T10 - X00;
  const float P01 = T01 + X00_i - T11 - X01;
  const float P10 = T10 + X11 - T00_j - X10;
  const float P11 = T11 + X10_i - T01_j - X11;
  v[1] += (1.0f - cosf(P00)) + (1.0f - cosf(P01)) + (1.0f - cosf(P10)) +
          (1.0f - cosf(P11));
  v[6] += mod_2pi(P00) + mod_2pi(P01) + mod_2pi(P10) + mod_2pi(P11);

  if (p.exact) {
    const float phi_12 = X10 + T00_j;
    const float phi_23 = T01_j - X10_i;
    const float phi_34 = -T01 - X00_i;
    const float phi_41 = -T00 + X00;
    const float th_1 = T10, th_2 = -X11, th_3 = -T11, th_4 = X01;
    const float Phi = phi_12 + phi_23 + phi_34 + phi_41;
    v[2] += cosf(th_1 - th_2 - phi_12) + cosf(th_2 - th_3 - phi_23) +
            cosf(th_3 - th_4 - phi_34) + cosf(th_4 - th_1 - phi_41);
    float series = 1.0f;
    for (int k = 0; k < p.n_alpha; ++k)
      series = series + p.alphas[k] * cosf((float)(k + 1) * Phi);
    v[3] += logf(series);
  } else {
    const float theta_p = mod_2pi(T01 + X00_i + X10_i - T01_j);
    const float theta_m = mod_2pi(X00 + X10 + T00_j - T00);
    const float th_v = mod_2pi(X01 + X11);
    v[2] += approx_log_eval(th_v, theta_p, theta_m, p.beta);
    const float tp_e = mod_2pi(T00 + X01 - X00);
    const float tm_e = mod_2pi(X10 + T00_j - X11);
    const float tp_o = mod_2pi(T01 + X00_i - X01);
    const float tm_o = mod_2pi(X11 + T01_j - X10_i);
    v[3] += expcos_log_eval(T10, p.beta, tp_e, tm_e) +
            expcos_log_eval(T11, p.beta, tp_o, tm_o);
  }

  // coarse state's plaquette
  const float Pc = cg.plaq(cs, J, I);
  v[4] += 1.0f - cosf(Pc);
  v[7] += mod_2pi(Pc);
  // restricted fine state's plaquette
  const float Tr = mod_2pi(T00 + T01);
  const float Xr = mod_2pi(X00 + X10);
  const float Tr_j = mod_2pi(T00_j + T01_j);
  const float Xr_i = mod_2pi(X00_i + X10_i);
  v[5] += 1.0f - cosf(Tr + Xr_i - Tr_j - Xr);
}

__device__ void screen_partials(const float* ft, const float* cs,
                                const Cells& cl, const Grid& cg,
                                const TwoLevelParams& p, const ChainCtx& cx,
                                float (&v)[kRed]) {
  for (int k = 1; k < kRed; ++k) v[k] = 0.0f;
  if (!cx.active) return;
  for (int q = cx.lt; q < cl.Mxc * cl.Mtc; q += cx.tpc)
    cell_partials(ft, cs, cl, cg, p, q / cl.Mtc, q % cl.Mtc, v);
}

__global__ void twolevel_kernel(const int32_t* seeds, const float* fine_in,
                                const float* coarse_in,
                                const float* scache_in, float* fine_out,
                                float* coarse_out, float* scache_out,
                                float* y_out, float* qc_out, float* ec_out,
                                float* acc_out, Grid fg, SweepParams cp,
                                TwoLevelParams p, int n_chains, int cpc,
                                int tpc) {
  extern __shared__ float smem[];
  const Grid cg{fg.Mx / 2, fg.Mt / 2};
  const Cells cl{fg, cg.Mx, cg.Mt};
  const int nf = 2 * fg.Mx * fg.Mt, nc = 2 * cg.Mx * cg.Mt;
  const int nwarps = blockDim.x >> 5;
  float* coarse = smem;                      // [cpc][nc]
  float* trial = coarse + cpc * nc;          // [cpc][nf]
  float* scratch = trial + cpc * nf;         // [nwarps][kRed]
  float* red = scratch + nwarps * kRed;      // [cpc][kRed]
  float* state = red + cpc * kRed;           // [cpc][5]: S_f S_q S_cc Q_f acc

  const ChainCtx cx = make_ctx(seeds, cpc, tpc);
  const int c = threadIdx.x / tpc;
  const int gc = blockIdx.x * cpc + c;
  const size_t off_f = (size_t)blockIdx.x * cpc * nf;
  const size_t off_c = (size_t)blockIdx.x * cpc * nc;
  for (int k = threadIdx.x; k < cpc * nc; k += blockDim.x)
    coarse[k] = coarse_in[off_c + k];
  for (int k = threadIdx.x; k < cpc * nf; k += blockDim.x) {
    trial[k] = fine_in[off_f + k];
    fine_out[off_f + k] = trial[k];
  }
  __syncthreads();

  float* cs = coarse + (cx.active ? c : 0) * nc;
  float* ft = trial + (cx.active ? c : 0) * nf;
  float* st = state + (cx.active ? c : 0) * 5;
  const int ncells = cg.Mx * cg.Mt;

  // cached S_coarse(restrict(fine)) and Q_fine of the incoming fine state
  float v[kRed];
  v[0] = 0.0f;
  screen_partials(ft, cs, cl, cg, p, cx, v);
  chain_reduce<kRed>(v, scratch, red, tpc, cpc);
  if (cx.active && cx.lt == 0) {
    st[0] = scache_in[gc];
    st[1] = scache_in[n_chains + gc];
    st[2] = p.beta_c * red[c * kRed + 5];
    st[3] = red[c * kRed + 6];
  }
  __syncthreads();

  const uint32_t acc_ctr = fill_counters(p) + 1u;
  for (int s = 0; s < p.n_steps; ++s) {
    const uint32_t base = (uint32_t)(s * (p.t_sub + 1));
    // t_sub coarse heat-bath sweeps with per-sweep traces
    for (int t = 0; t < p.t_sub; ++t) {
      one_step(cs, cg, cp, cx, base + t);
      float w[2];
      plaq_partials(cs, cg, cx, false, w);
      chain_reduce<2>(w, scratch, red, tpc, cpc);
      if (cx.active && cx.lt == 0) {
        const size_t row = (size_t)(s * p.t_sub + t) * n_chains + gc;
        qc_out[row] = red[c * 2];
        ec_out[row] = red[c * 2 + 1];
      }
    }
    // trial: prolongate + conditioned fill
    const uint32_t step = base + (uint32_t)p.t_sub;
    if (cx.active)
      for (int q = cx.lt; q < ncells; q += cx.tpc) {
        const int J = q / cg.Mt, I = q % cg.Mt;
        fill_step1(cs, ft, cl, cg,
                   Rng(cx.seed1, cx.seed2, J * cg.Mt + I, cx.chain, step), J,
                   I);
      }
    __syncthreads();
    v[0] = 0.0f;
    if (cx.active)
      for (int q = cx.lt; q < ncells; q += cx.tpc) {
        const int J = q / cg.Mt, I = q % cg.Mt;
        const Rng r(cx.seed1, cx.seed2, J * cg.Mt + I, cx.chain, step);
        if (!fill_step23(ft, cl, r, p, J, I)) v[0] += 1.0f;
      }
    __syncthreads();
    // the three dS terms (twolevelmetropolisstep.cc:35-89) and the accept
    screen_partials(ft, cs, cl, cg, p, cx, v);
    chain_reduce<kRed>(v, scratch, red, tpc, cpc);
    if (cx.active && cx.lt == 0) {
      const float* rr = red + c * kRed;
      const float S_f_trial = p.beta * rr[1];
      const float S_q_trial =
          p.exact ? -p.beta * rr[2] + rr[3] : -rr[2] - rr[3];
      const float dS_coarse = st[2] - p.beta_c * rr[4];
      const float dS = (S_f_trial - st[0]) + dS_coarse + (st[1] - S_q_trial);
      const Rng r0(cx.seed1, cx.seed2, 0u, cx.chain, step);
      const float u_acc = r0.uniform(acc_ctr);
      const bool accept =
          rr[0] == 0.0f && (dS < 0.0f || u_acc < expf(-dS));
      if (accept) {
        st[0] = S_f_trial;
        st[1] = S_q_trial;
        st[2] = p.beta_c * rr[5];
        st[3] = rr[6];
      }
      st[4] = accept ? 1.0f : 0.0f;
      const float qf = st[3], qc = rr[7];
      y_out[(size_t)s * n_chains + gc] = kFourPiSqInv * (qf * qf - qc * qc);
      acc_out[(size_t)s * n_chains + gc] = st[4];
    }
    __syncthreads();
    if (cx.active && st[4] != 0.0f)
      for (int k = cx.lt; k < nf; k += cx.tpc)
        fine_out[(size_t)gc * nf + k] = ft[k];
    __syncthreads();
  }

  for (int k = threadIdx.x; k < cpc * nc; k += blockDim.x)
    coarse_out[off_c + k] = coarse[k];
  if (cx.active && cx.lt == 0) {
    scache_out[gc] = st[0];
    scache_out[n_chains + gc] = st[1];
  }
}

int block_threads(int cpc, int tpc) {
  const int n = cpc * tpc;
  return n < 32 ? 32 : n;
}

ffi::Error launch_status() {
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

ffi::Error SweepChainImpl(cudaStream_t stream, ffi::Buffer<ffi::S32> seeds,
                          ffi::Buffer<ffi::F32> theta,
                          ffi::ResultBuffer<ffi::F32> theta_out,
                          ffi::ResultBuffer<ffi::F32> qsum,
                          ffi::ResultBuffer<ffi::F32> esum, int32_t Mx,
                          int32_t Mt, int32_t n_steps, int32_t step_offset,
                          int32_t n_overrelax, int32_t n_heatbath,
                          int32_t k_rej, float beta, int32_t cpc,
                          int32_t tpc) {
  const auto dims = theta.dimensions();
  if (dims.size() != 2 || dims[1] != 2 * Mx * Mt)
    return ffi::Error::InvalidArgument("theta must be [C, 2*Mx*Mt]");
  const int n_chains = (int)dims[0];
  if (cpc <= 0 || n_chains % cpc)
    return ffi::Error::InvalidArgument("chains per CTA must divide C");
  const int threads = block_threads(cpc, tpc);
  const size_t smem =
      sizeof(float) * ((size_t)cpc * 2 * Mx * Mt + (threads / 32) * 2 + cpc * 2);
  cudaFuncSetAttribute(sweep_chain_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  sweep_chain_kernel<<<n_chains / cpc, threads, smem, stream>>>(
      seeds.typed_data(), theta.typed_data(), theta_out->typed_data(),
      qsum->typed_data(), esum->typed_data(), Grid{Mx, Mt},
      SweepParams{n_overrelax, n_heatbath, k_rej, beta}, n_steps,
      step_offset, n_chains, cpc, tpc);
  return launch_status();
}

ffi::Error TwoLevelImpl(
    cudaStream_t stream, ffi::Buffer<ffi::S32> seeds,
    ffi::Buffer<ffi::F32> fine, ffi::Buffer<ffi::F32> coarse,
    ffi::Buffer<ffi::F32> scache, ffi::ResultBuffer<ffi::F32> fine_out,
    ffi::ResultBuffer<ffi::F32> coarse_out,
    ffi::ResultBuffer<ffi::F32> scache_out, ffi::ResultBuffer<ffi::F32> y,
    ffi::ResultBuffer<ffi::F32> qc, ffi::ResultBuffer<ffi::F32> ec,
    ffi::ResultBuffer<ffi::F32> acc, int32_t Mx, int32_t Mt, int32_t n_steps,
    int32_t t_sub, int32_t n_overrelax_c, int32_t n_heatbath_c,
    int32_t k_rej, int32_t k_rej_fill, int32_t k_rej_bessel, int32_t exact,
    int32_t small_beta, float beta, float beta_c, float log_i0_2beta,
    float sigma_beta, float sigma_half, ffi::Span<const float> alphas,
    int32_t n_alpha, int32_t cpc, int32_t tpc) {
  const auto dims = fine.dimensions();
  if (dims.size() != 2 || dims[1] != 2 * Mx * Mt || Mx % 2 || Mt % 2)
    return ffi::Error::InvalidArgument("fine must be [C, 2*Mx*Mt], even M");
  const int n_chains = (int)dims[0];
  if (cpc <= 0 || n_chains % cpc)
    return ffi::Error::InvalidArgument("chains per CTA must divide C");
  if (n_alpha < 0 || n_alpha > kMaxAlpha || alphas.size() < (size_t)n_alpha)
    return ffi::Error::InvalidArgument("bad BesselProduct alphas");
  TwoLevelParams p{};
  p.n_steps = n_steps;
  p.t_sub = t_sub;
  p.k_rej_fill = k_rej_fill;
  p.k_rej_bessel = k_rej_bessel;
  p.exact = exact;
  p.small_beta = small_beta;
  p.n_alpha = n_alpha;
  p.beta = beta;
  p.beta_c = beta_c;
  p.log_i0_2beta = log_i0_2beta;
  p.sigma_beta = sigma_beta;
  p.sigma_half = sigma_half;
  for (int k = 0; k < n_alpha; ++k) p.alphas[k] = alphas[k];
  const int threads = block_threads(cpc, tpc);
  const int nf = 2 * Mx * Mt, nc = nf / 4;
  const size_t smem =
      sizeof(float) * ((size_t)cpc * (nf + nc) + (threads / 32) * kRed +
                       (size_t)cpc * (kRed + 5));
  cudaFuncSetAttribute(twolevel_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  twolevel_kernel<<<n_chains / cpc, threads, smem, stream>>>(
      seeds.typed_data(), fine.typed_data(), coarse.typed_data(),
      scache.typed_data(), fine_out->typed_data(), coarse_out->typed_data(),
      scache_out->typed_data(), y->typed_data(), qc->typed_data(),
      ec->typed_data(), acc->typed_data(), Grid{Mx, Mt},
      SweepParams{n_overrelax_c, n_heatbath_c, k_rej, beta_c}, p, n_chains,
      cpc, tpc);
  return launch_status();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(
    SchwingerSweepChain, SweepChainImpl,
    ffi::Ffi::Bind()
        .Ctx<ffi::PlatformStream<cudaStream_t>>()
        .Arg<ffi::Buffer<ffi::S32>>()
        .Arg<ffi::Buffer<ffi::F32>>()
        .Ret<ffi::Buffer<ffi::F32>>()
        .Ret<ffi::Buffer<ffi::F32>>()
        .Ret<ffi::Buffer<ffi::F32>>()
        .Attr<int32_t>("Mx")
        .Attr<int32_t>("Mt")
        .Attr<int32_t>("n_steps")
        .Attr<int32_t>("step_offset")
        .Attr<int32_t>("n_overrelax")
        .Attr<int32_t>("n_heatbath")
        .Attr<int32_t>("k_rej")
        .Attr<float>("beta")
        .Attr<int32_t>("cpc")
        .Attr<int32_t>("tpc"));

XLA_FFI_DEFINE_HANDLER_SYMBOL(
    SchwingerTwoLevelChunk, TwoLevelImpl,
    ffi::Ffi::Bind()
        .Ctx<ffi::PlatformStream<cudaStream_t>>()
        .Arg<ffi::Buffer<ffi::S32>>()
        .Arg<ffi::Buffer<ffi::F32>>()
        .Arg<ffi::Buffer<ffi::F32>>()
        .Arg<ffi::Buffer<ffi::F32>>()
        .Ret<ffi::Buffer<ffi::F32>>()
        .Ret<ffi::Buffer<ffi::F32>>()
        .Ret<ffi::Buffer<ffi::F32>>()
        .Ret<ffi::Buffer<ffi::F32>>()
        .Ret<ffi::Buffer<ffi::F32>>()
        .Ret<ffi::Buffer<ffi::F32>>()
        .Ret<ffi::Buffer<ffi::F32>>()
        .Attr<int32_t>("Mx")
        .Attr<int32_t>("Mt")
        .Attr<int32_t>("n_steps")
        .Attr<int32_t>("t_sub")
        .Attr<int32_t>("n_overrelax_c")
        .Attr<int32_t>("n_heatbath_c")
        .Attr<int32_t>("k_rej")
        .Attr<int32_t>("k_rej_fill")
        .Attr<int32_t>("k_rej_bessel")
        .Attr<int32_t>("exact")
        .Attr<int32_t>("small_beta")
        .Attr<float>("beta")
        .Attr<float>("beta_c")
        .Attr<float>("log_i0_2beta")
        .Attr<float>("sigma_beta")
        .Attr<float>("sigma_half")
        .Attr<ffi::Span<const float>>("alphas")
        .Attr<int32_t>("n_alpha")
        .Attr<int32_t>("cpc")
        .Attr<int32_t>("tpc"));
