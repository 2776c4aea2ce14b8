// hw_native — C++ host runtime for hullwhite_tpu.
//
// The CUDA reference's host layer is native C++ (table precompute
// common.cuh:60-110, persistence common.cuh:144-176, report writers
// output.cuh, run statistics 2_option_pricing.cu:305-359).  This library is
// the TPU framework's equivalent: the L1 precompute layer (drift integral
// tables, shock-weight shapes, checkpoint-covariance Cholesky factors that
// feed the XLA/Pallas kernels), binary/CSV persistence, and the
// independent-run statistics.  All math is double precision — the tables
// are consumed as fp32 by the device but must be built wider (see
// models/hull_white.host_tables docstring).
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image).

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <algorithm>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// L1 precompute: drift integral tables (reference compute_drift_tables)
// ---------------------------------------------------------------------------
// base[i] = int_{s}^{t} e^{-a(t-u)} theta0(u) du  for the piecewise-linear
//           theta0(u) = alpha0 + beta0 u (u < t_break) else alpha1 + beta1 u
// psi[i]  = [1 + e^{-2at} - e^{-a dt} - e^{-a(t+s)}] / a^2
//           (calibration-shift kernel; drift(sigma) = base + (sigma^2 -
//            sigma0^2)/2 * psi, d drift/d sigma = sigma * psi)
void hw_drift_tables(double a, double dt, int n_steps,
                     double alpha0, double beta0, double alpha1, double beta1,
                     double t_break, double* base, double* psi) {
  const double E = std::exp(-a * dt);
  const double one_m = (1.0 - E) / a;
  for (int i = 0; i < n_steps; ++i) {
    const double s = i * dt;
    const double t = (i + 1) * dt;
    const double lin = (t - E * s) / a - one_m / a;
    if (s < t_break) {
      base[i] = beta0 * lin + alpha0 * one_m;
    } else {
      base[i] = beta1 * lin + alpha1 * one_m;
    }
    psi[i] = (1.0 + std::exp(-2.0 * a * t) - E - std::exp(-a * (t + s))) /
             (a * a);
  }
}

// ---------------------------------------------------------------------------
// Shock-weight shapes (engine_linear._shock_shapes): with m = n-1-i,
//   u[i] = E^m                       (dr_n/dG_i / sig_st)
//   w[i] = dt [ (1-E^m)/(1-E) + E^m/2 ]   (dI_n/dG_i / sig_st)
// ---------------------------------------------------------------------------
void hw_shock_shapes(double a, double dt, int n, double* u, double* w) {
  const double E = std::exp(-a * dt);
  const double logE = -a * dt;
  for (int i = 0; i < n; ++i) {
    const double m = (double)(n - 1 - i);
    const double Em = std::exp(logE * m);
    u[i] = Em;
    w[i] = dt * ((1.0 - Em) / (1.0 - E) + 0.5 * Em);
  }
}

// Full curve shape W[i, m] (engine_linear._curve_shape), row-major
// (n_steps, n_mat); column m corresponds to checkpoint step m*stride.
void hw_curve_shape(double a, double dt, int n_steps, int n_mat, int stride,
                    double* W) {
  const double E = std::exp(-a * dt);
  const double logE = -a * dt;
  for (int i = 0; i < n_steps; ++i) {
    for (int m = 0; m < n_mat; ++m) {
      const long n = (long)m * stride;
      if (i < n) {
        const double mm = (double)(n - 1 - i);
        const double Em = std::exp(logE * mm);
        W[(long)i * n_mat + m] = dt * ((1.0 - Em) / (1.0 - E) + 0.5 * Em);
      } else {
        W[(long)i * n_mat + m] = 0.0;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Cholesky of C = Ws^T Ws for the exact functional sampler
// (engine_exact.curve_chol).  In-place lower Cholesky, then transposed into
// LT (row-major (k, k), upper-triangular) for the z = x @ L^T matmul.
// Returns 0 on success, -1 if not positive definite.
// ---------------------------------------------------------------------------
int hw_curve_chol(double a, double dt, int n_steps, int n_mat, int stride,
                  double* LT) {
  const int k = n_mat - 1;
  std::vector<double> W((size_t)n_steps * n_mat);
  hw_curve_shape(a, dt, n_steps, n_mat, stride, W.data());
  std::vector<double> C((size_t)k * k, 0.0);
  for (int i = 0; i < n_steps; ++i) {
    const double* row = &W[(size_t)i * n_mat + 1];  // skip m=0 column
    for (int p = 0; p < k; ++p) {
      const double rp = row[p];
      if (rp == 0.0) continue;
      for (int q = p; q < k; ++q) {
        C[(size_t)p * k + q] += rp * row[q];
      }
    }
  }
  // lower Cholesky on the symmetric C (upper stored)
  std::vector<double> L((size_t)k * k, 0.0);
  for (int j = 0; j < k; ++j) {
    double d = C[(size_t)j * k + j];
    for (int p = 0; p < j; ++p) d -= L[(size_t)j * k + p] * L[(size_t)j * k + p];
    if (d <= 0.0) return -1;
    const double ljj = std::sqrt(d);
    L[(size_t)j * k + j] = ljj;
    for (int i = j + 1; i < k; ++i) {
      double s = C[(size_t)j * k + i];  // C[j][i] with j<=i (upper storage)
      for (int p = 0; p < j; ++p)
        s -= L[(size_t)i * k + p] * L[(size_t)j * k + p];
      L[(size_t)i * k + j] = s / ljj;
    }
  }
  for (int i = 0; i < k; ++i)
    for (int j = 0; j < k; ++j)
      LT[(size_t)i * k + j] = L[(size_t)j * k + i];
  return 0;
}

// 2x2 factor for (r(S1), I(S1)) (engine_exact.zbc_chol): out = {l11,l21,l22}
void hw_zbc_chol(double a, double dt, int n1, double* out) {
  std::vector<double> u(n1), w(n1);
  hw_shock_shapes(a, dt, n1, u.data(), w.data());
  double c_rr = 0.0, c_ri = 0.0, c_ii = 0.0;
  for (int i = 0; i < n1; ++i) {
    c_rr += u[i] * u[i];
    c_ri += u[i] * w[i];
    c_ii += w[i] * w[i];
  }
  const double l11 = std::sqrt(c_rr);
  const double l21 = c_ri / l11;
  out[0] = l11;
  out[1] = l21;
  out[2] = std::sqrt(c_ii - l21 * l21);
}

// ---------------------------------------------------------------------------
// Persistence & reporting (reference save_array / csv writers)
// ---------------------------------------------------------------------------
int hw_save_bin(const char* path, const float* data, long n) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  const size_t written = std::fwrite(data, sizeof(float), (size_t)n, f);
  std::fclose(f);
  return written == (size_t)n ? 0 : -1;
}

long hw_load_bin(const char* path, float* data, long n) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  const size_t got = std::fread(data, sizeof(float), (size_t)n, f);
  std::fclose(f);
  return (long)got;
}

int hw_csv_timeseries(const char* path, const char* header,
                      const float* data, long n, float spacing) {
  FILE* f = std::fopen(path, "w");
  if (!f) return -1;
  std::fprintf(f, "T,%s\n", header);
  for (long i = 0; i < n; ++i) {
    std::fprintf(f, "%.4f,%.8f\n", (double)(i * spacing), (double)data[i]);
  }
  std::fclose(f);
  return 0;
}

// ---------------------------------------------------------------------------
// Run statistics (reference 2_option_pricing.cu:305-359): out =
// [mean, std(ddof=1), std_error, min, q1, median, q3, max]
// ---------------------------------------------------------------------------
void hw_summarize(const double* samples, int n, double* out) {
  std::vector<double> x(samples, samples + n);
  double mean = 0.0;
  for (double v : x) mean += v;
  mean /= n;
  double var = 0.0;
  for (double v : x) var += (v - mean) * (v - mean);
  var = n > 1 ? var / (n - 1) : 0.0;
  std::sort(x.begin(), x.end());
  auto quant = [&](double q) {
    const double pos = q * (n - 1);
    const int lo = (int)pos;
    const int hi = std::min(lo + 1, n - 1);
    const double frac = pos - lo;
    return x[lo] * (1.0 - frac) + x[hi] * frac;
  };
  out[0] = mean;
  out[1] = std::sqrt(var);
  out[2] = std::sqrt(var / n);
  out[3] = x.front();
  out[4] = quant(0.25);
  out[5] = quant(0.5);
  out[6] = quant(0.75);
  out[7] = x.back();
}


// ---------------------------------------------------------------------------
// Bermudan DP backward step (bermudan.dp_oracle): one conditional
// expectation sweep, cont[i] = e^{-mI + vI/2} E[ V^(X) ],
// X ~ N(m_t(r_s_i) - ctI, vt), with V^ the piecewise-linear interpolant of
// (grid_t, V) and flat extrapolation.  The e^{-dI} exponential tilt is
// already folded into the mean shift -ctI and the e^{-mI + vI/2} factor
// (dI | r_s, r_t Gaussian).  Exact per segment via Phi/phi closed forms --
// Gauss-Hermite quadrature converges slowly on the kinked value function.
// O(ns * nt) doubles: the hot loop of the float64 oracle.
// ---------------------------------------------------------------------------
static inline double hw_phi_pdf(double x) {
  return std::exp(-0.5 * x * x) * 0.3989422804014327;
}
static inline double hw_phi_cdf(double x) {
  return 0.5 * std::erfc(-x * 0.7071067811865476);
}

void hw_dp_continuation(const double* grid_s, int ns, const double* grid_t,
                        const double* V, int nt, double rdet_s,
                        double rdet_t, double didet, double bt, double bI,
                        double vt, double vI, double ctI, double* cont) {
  const double s = std::sqrt(vt);
  std::vector<double> a(nt - 1), b(nt - 1);
  for (int j = 0; j + 1 < nt; ++j) {
    b[j] = (V[j + 1] - V[j]) / (grid_t[j + 1] - grid_t[j]);
    a[j] = V[j] - b[j] * grid_t[j];
  }
  for (int i = 0; i < ns; ++i) {
    const double dr = grid_s[i] - rdet_s;
    const double mI = didet + bI * dr;
    const double m = rdet_t + bt * dr - ctI;   // tilted conditional mean
    const double w0 = std::exp(-mI + 0.5 * vI);
    double t0 = (grid_t[0] - m) / s;
    double Phi0 = hw_phi_cdf(t0);
    double phi0 = hw_phi_pdf(t0);
    double acc = V[0] * Phi0;                  // flat left tail
    for (int j = 0; j + 1 < nt; ++j) {
      const double t1 = (grid_t[j + 1] - m) / s;
      const double Phi1 = hw_phi_cdf(t1);
      const double phi1 = hw_phi_pdf(t1);
      acc += (a[j] + b[j] * m) * (Phi1 - Phi0) - b[j] * s * (phi1 - phi0);
      Phi0 = Phi1;
      phi0 = phi1;
    }
    acc += V[nt - 1] * (1.0 - Phi0);           // flat right tail
    cont[i] = w0 * acc;
  }
}

// Cubic-Hermite variant (round 4, docs/MATH.md §38): the linear sweep
// plus the exact Gaussian-cell integral of the C1 Hermite correction
// d1 t + d2 t^2 + d3 t^3, t = (y - x_j)/h_j, killing the piecewise-
// linear interpolant's O(h^2) convexity bias on smooth stretches of V
// (the value kink from max(payoff, cont) lies mid-cell on these uniform
// grids, where any fixed-order interpolant is locally O(h^2); its
// Gaussian mass keeps the net contribution O(h^3)).  Node slopes are
// 3-point estimates, one-sided at the ends.  Round-5 (advisor): the
// same zero-width-cell break handling as the Python _kernel_avg /
// _hermite_slopes — cells narrower than 1e-4 * span/(nt-1) are treated
// as jump double nodes: no slope differences across them (adjacent
// nodes take the one-sided estimate from their own segment, a node
// between two breaks gets slope 0) and the Hermite correction is
// zeroed on the break cell (linear chord only).  The bermudan grids
// are uniform today, but a caller inserting kink/jump nodes no longer
// feeds near-infinite slopes into neighbor cells.
void hw_dp_continuation3(const double* grid_s, int ns, const double* grid_t,
                         const double* V, int nt, double rdet_s,
                         double rdet_t, double didet, double bt, double bI,
                         double vt, double vI, double ctI, double* cont) {
  const double s = std::sqrt(vt);
  const double span = grid_t[nt - 1] - grid_t[0];
  const double h_break = 1e-4 * span / (nt > 1 ? nt - 1 : 1);
  std::vector<char> brk(nt - 1);
  for (int j = 0; j + 1 < nt; ++j)
    brk[j] = (grid_t[j + 1] - grid_t[j]) <= h_break;
  std::vector<double> slope(nt);
  for (int j = 1; j + 1 < nt; ++j) {
    const double hl = grid_t[j] - grid_t[j - 1];
    const double hr = grid_t[j + 1] - grid_t[j];
    const double sl = (V[j] - V[j - 1]) / hl;
    const double sr = (V[j + 1] - V[j]) / hr;
    const bool bl = brk[j - 1], br = brk[j];
    slope[j] = (bl && br) ? 0.0 : bl ? sr : br ? sl
               : (hr * sl + hl * sr) / (hl + hr);
  }
  slope[0] = brk[0] ? 0.0 : (V[1] - V[0]) / (grid_t[1] - grid_t[0]);
  slope[nt - 1] = brk[nt - 2] ? 0.0
      : (V[nt - 1] - V[nt - 2]) / (grid_t[nt - 1] - grid_t[nt - 2]);
  std::vector<double> d1(nt - 1), d2(nt - 1), d3(nt - 1), hinv(nt - 1);
  for (int j = 0; j + 1 < nt; ++j) {
    if (brk[j]) {
      d1[j] = d2[j] = d3[j] = 0.0;
      hinv[j] = 0.0;               // alpha/beta unused: d's are zero
      continue;
    }
    const double h = grid_t[j + 1] - grid_t[j];
    const double dV = V[j + 1] - V[j];
    const double hma = h * slope[j], hmb = h * slope[j + 1];
    d1[j] = hma - dV;
    d2[j] = 3.0 * dV - 2.0 * hma - hmb;
    d3[j] = -2.0 * dV + hma + hmb;
    hinv[j] = 1.0 / h;
  }
  for (int i = 0; i < ns; ++i) {
    const double dr = grid_s[i] - rdet_s;
    const double mI = didet + bI * dr;
    const double m = rdet_t + bt * dr - ctI;
    const double w0 = std::exp(-mI + 0.5 * vI);
    double t0 = (grid_t[0] - m) / s;
    double Phi0 = hw_phi_cdf(t0);
    double phi0 = hw_phi_pdf(t0);
    double acc = V[0] * Phi0;
    for (int j = 0; j + 1 < nt; ++j) {
      const double t1 = (grid_t[j + 1] - m) / s;
      const double Phi1 = hw_phi_cdf(t1);
      const double phi1 = hw_phi_pdf(t1);
      const double E0 = Phi1 - Phi0;
      const double E1 = phi0 - phi1;                       // int z phi
      const double E2 = E0 - (t1 * phi1 - t0 * phi0);
      const double E3 = (t0 * t0 + 2.0) * phi0 - (t1 * t1 + 2.0) * phi1;
      const double alpha = (m - grid_t[j]) * hinv[j];
      const double beta = s * hinv[j];
      const double S1 = alpha * E0 + beta * E1;
      const double S2 = alpha * (alpha * E0 + 2.0 * beta * E1)
                        + beta * beta * E2;
      const double S3 = alpha * alpha * (alpha * E0 + 3.0 * beta * E1)
                        + beta * beta * (3.0 * alpha * E2 + beta * E3);
      // linear chord piece (same as hw_dp_continuation, cell form)
      acc += V[j] * E0 + (V[j + 1] - V[j]) * S1
             + d1[j] * S1 + d2[j] * S2 + d3[j] * S3;
      Phi0 = Phi1;
      phi0 = phi1;
      t0 = t1;
    }
    acc += V[nt - 1] * (1.0 - Phi0);
    cont[i] = w0 * acc;
  }
}

}  // extern "C"
