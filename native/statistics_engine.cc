// Native streaming statistics engine for logged QoI sample streams.
//
// The device compute path produces per-sample QoI values at millions of
// samples/sec (the LOG_QOI analog of montecarlosinglelevel.cc:46-76 in the
// reference); analysing those logs (running moments, windowed
// autocorrelation S_k, tau_int, binning) is host-side streaming work that
// belongs in native code.  This library implements the reference's
// single-chain estimators (src/common/statistics.cc:4-98) exactly, single
// pass over the stream, plus a binning analysis, exported with a plain C
// ABI for ctypes.
//
// Build: make -C native   (produces libmlmc_stats.so)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Result layout (doubles):
// [0] n_samples  [1] avg  [2] variance  [3] variance_error
// [4] tau_int    [5] error(avg)
// [6 .. 6+k_max) autocorrelation function C(k)
// Returns 0 on success.
int mlmc_stats_process(const double* samples, int64_t n, int k_max,
                       double* out) {
  if (n < 2 || k_max < 1) return 1;
  // running long-term moments (statistics.cc:13-21)
  double avg = 0.0, avg2 = 0.0, avg3 = 0.0, avg4 = 0.0;
  std::vector<double> S_k(k_max, 0.0);
  std::vector<double> ring(k_max, 0.0);  // ring[j] = Q_{t-j}
  int64_t filled = 0;
  for (int64_t t = 0; t < n; ++t) {
    const double Q = samples[t];
    const double nt = (double)(t + 1);
    avg = ((nt - 1.0) * avg + Q) / nt;
    avg2 = ((nt - 1.0) * avg2 + Q * Q) / nt;
    avg3 = ((nt - 1.0) * avg3 + Q * Q * Q) / nt;
    avg4 = ((nt - 1.0) * avg4 + Q * Q * Q * Q) / nt;
    // shift ring; newest at index 0 (statistics.cc:7-12)
    const int64_t kmx = std::min<int64_t>(filled + 1, k_max);
    for (int64_t j = kmx - 1; j > 0; --j) ring[j] = ring[j - 1];
    ring[0] = Q;
    filled = std::min<int64_t>(filled + 1, k_max);
    // running lagged products S_k (statistics.cc:22-26)
    for (int64_t k = 0; k < filled; ++k) {
      const double N_k = nt - (double)k;
      S_k[k] = ((N_k - 1.0) * S_k[k] + ring[0] * ring[k]) / N_k;
    }
  }
  // estimators (statistics.cc:30-98)
  const double nD = (double)n;
  const double var = nD / (nD - 1.0) * (S_k[0] - avg * avg);
  const double var_err = std::sqrt(std::fmax(
      (avg4 - 4.0 * avg * avg3 + 8.0 * avg * avg * avg2 - avg2 * avg2 -
       4.0 * avg * avg * avg * avg) / nD, 0.0));
  double tsum = 0.0;
  for (int k = 1; k < k_max; ++k) {
    tsum += (1.0 - (double)k / nD) * (S_k[k] - avg * avg);
  }
  const double C0 = S_k[0] - avg * avg;
  const double tau = C0 > 0.0 ? std::fmax(1.0, 1.0 + 2.0 * tsum / C0) : 1.0;
  out[0] = nD;
  out[1] = avg;
  out[2] = var;
  out[3] = var_err;
  out[4] = tau;
  out[5] = std::sqrt(tau * std::fmax(var, 0.0) / nD);
  for (int k = 0; k < k_max; ++k) out[6 + k] = S_k[k] - avg * avg;
  return 0;
}

// Binning analysis: out_err[b] = naive error of bin-averaged series with
// bin size 2^b, for b = 0 .. n_bin_levels-1.  The plateau gives the true
// error (an independent cross-check of the tau_int-based estimate).
int mlmc_stats_binning(const double* samples, int64_t n, int n_bin_levels,
                       double* out_err) {
  if (n < 4 || n_bin_levels < 1) return 1;
  std::vector<double> buf(samples, samples + n);
  int64_t m = n;
  for (int b = 0; b < n_bin_levels; ++b) {
    if (m < 2) {
      out_err[b] = out_err[b > 0 ? b - 1 : 0];
      continue;
    }
    double mean = 0.0, sq = 0.0;
    for (int64_t i = 0; i < m; ++i) mean += buf[i];
    mean /= (double)m;
    for (int64_t i = 0; i < m; ++i) {
      const double d = buf[i] - mean;
      sq += d * d;
    }
    const double var = sq / (double)(m - 1);
    out_err[b] = std::sqrt(var / (double)m);
    // bin pairs
    const int64_t m2 = m / 2;
    for (int64_t i = 0; i < m2; ++i) {
      buf[i] = 0.5 * (buf[2 * i] + buf[2 * i + 1]);
    }
    m = m2;
  }
  return 0;
}

// fast scaled Bessel function e^{-z} I0(z): truncated asymptotic series
// a_k = ((2k-1)!!)^2 / (8^k k!) for large z (fastbessel.hh:26-50),
// series expansion of I0 for small z.
double mlmc_fast_i0_scaled(double z) {
  if (z < 15.0) {
    // power series I0(z) = sum (z^2/4)^k / (k!)^2, scaled by e^{-z}
    double term = 1.0, sum = 1.0;
    const double q = 0.25 * z * z;
    for (int k = 1; k < 64; ++k) {
      term *= q / ((double)k * (double)k);
      sum += term;
      if (term < 1e-18 * sum) break;
    }
    return sum * std::exp(-z);
  }
  static const int N = 10;
  double coeff[N];
  coeff[0] = 1.0;
  for (int k = 1; k < N; ++k) {
    const double dk = (double)k;
    // a_k = a_{k-1} * (2k-1)^2 / (8 k)
    coeff[k] = coeff[k - 1] * (2.0 * dk - 1.0) * (2.0 * dk - 1.0) /
               (8.0 * dk);
  }
  const double zi = 1.0 / z;
  double s = 0.0;
  for (int k = N - 1; k >= 0; --k) s = s * zi + coeff[k];
  return s / std::sqrt(2.0 * M_PI * z);
}

}  // extern "C"
