// fem_core — native (C++) setup engine for dealii-spirk-tpu.
//
// The reference implements its entire setup path in C++ (deal.II FE
// assembly, Octave-generated Butcher tables loaded by main.cc:599-656).
// This library is the framework's native counterpart: it computes, in
// long-double precision,
//
//   * quadrature rules (Gauss-Legendre, Gauss-Lobatto support points),
//   * reference-cell and global banded 1D FEM matrices (the data the
//     JAX operators consume; cf. reference operator.h),
//   * 1D prolongation matrices for the multigrid transfer,
//   * Radau IIA Butcher tables and their real LU-diagonalization
//     (cf. reference tables/irk_ev.m),
//
// exported through a plain C ABI for ctypes.  The Python layer falls back
// to an equivalent numpy implementation when the library is unavailable;
// tests assert both paths agree to ~1e-15.
//
// Build: make -C native   (g++ -O2 -shared -fPIC)

#include <algorithm>
#include <cmath>
#include <cstring>
#include <vector>

namespace {

using ld = long double;

// ---------------------------------------------------------------------------
// orthogonal polynomials and root finding
// ---------------------------------------------------------------------------

// Legendre P_n(x) and derivative on [-1, 1] by recurrence.
void legendre(int n, ld x, ld &p, ld &dp) {
  ld p0 = 1.0L, p1 = x;
  if (n == 0) {
    p = p0;
    dp = 0.0L;
    return;
  }
  for (int k = 2; k <= n; ++k) {
    ld p2 = ((2 * k - 1) * x * p1 - (k - 1) * p0) / k;
    p0 = p1;
    p1 = p2;
  }
  p = p1;
  dp = n * (x * p1 - p0) / (x * x - 1.0L);
}

// Jacobi P_n^{(a,b)}(x) by recurrence (needed for Radau / Lobatto nodes).
ld jacobi(int n, ld a, ld b, ld x) {
  if (n == 0) return 1.0L;
  ld p0 = 1.0L;
  ld p1 = 0.5L * (a - b + (a + b + 2.0L) * x);
  for (int k = 1; k < n; ++k) {
    ld k1 = k + 1, ab = a + b;
    ld c1 = 2.0L * k1 * (k1 + ab) * (2.0L * k + ab);
    ld c2 = (2.0L * k + ab + 1.0L) * (a * a - b * b);
    ld c3 = (2.0L * k + ab) * (2.0L * k + ab + 1.0L) * (2.0L * k + ab + 2.0L);
    ld c4 = 2.0L * (k + a) * (k + b) * (2.0L * k + ab + 2.0L);
    ld p2 = ((c2 + c3 * x) * p1 - c4 * p0) / c1;
    p0 = p1;
    p1 = p2;
  }
  return p1;
}

// All n roots of f on (lo, hi) by scan + bisection (robust for small n).
template <typename F>
int roots_by_bisection(F f, int n, ld lo, ld hi, ld *out) {
  const int kScan = 200000;
  int found = 0;
  ld x0 = lo, f0 = f(x0);
  for (int i = 1; i <= kScan && found < n; ++i) {
    ld x1 = lo + (hi - lo) * i / kScan;
    ld f1 = f(x1);
    if ((f0 < 0 && f1 >= 0) || (f0 > 0 && f1 <= 0)) {
      ld a = x0, b = x1;
      for (int it = 0; it < 200; ++it) {
        ld m = 0.5L * (a + b), fm = f(m);
        if ((f(a) < 0) == (fm < 0))
          a = m;
        else
          b = m;
      }
      out[found++] = 0.5L * (a + b);
    }
    x0 = x1;
    f0 = f1;
  }
  return found == n ? 0 : 1;
}

// Gauss-Legendre nodes/weights on [0, 1].
int gauss_legendre01(int n, ld *x, ld *w) {
  std::vector<ld> r(n);
  auto f = [n](ld t) {
    ld p, dp;
    legendre(n, t, p, dp);
    return p;
  };
  if (roots_by_bisection(f, n, -1.0L + 1e-12L, 1.0L - 1e-12L, r.data()))
    return 1;
  for (int i = 0; i < n; ++i) {
    ld p, dp;
    legendre(n, r[i], p, dp);
    x[i] = 0.5L * (r[i] + 1.0L);
    w[i] = 1.0L / ((1.0L - r[i] * r[i]) * dp * dp);
  }
  return 0;
}

// Gauss-Lobatto points on [0, 1]: endpoints + roots of P_{p-1}^{(1,1)}.
int gauss_lobatto01(int degree, ld *pts) {
  pts[0] = 0.0L;
  pts[degree] = 1.0L;
  if (degree < 2) return 0;
  std::vector<ld> r(degree - 1);
  auto f = [degree](ld t) { return jacobi(degree - 1, 1.0L, 1.0L, t); };
  if (roots_by_bisection(f, degree - 1, -1.0L, 1.0L, r.data())) return 1;
  for (int i = 0; i < degree - 1; ++i) pts[i + 1] = 0.5L * (r[i] + 1.0L);
  return 0;
}

// Lagrange basis value / derivative at x for the given nodes.
ld lagrange_val(const ld *nodes, int n, int j, ld x) {
  ld v = 1.0L;
  for (int k = 0; k < n; ++k)
    if (k != j) v *= (x - nodes[k]) / (nodes[j] - nodes[k]);
  return v;
}

ld lagrange_der(const ld *nodes, int n, int j, ld x) {
  ld s = 0.0L;
  for (int m = 0; m < n; ++m) {
    if (m == j) continue;
    ld t = 1.0L / (nodes[j] - nodes[m]);
    for (int k = 0; k < n; ++k)
      if (k != j && k != m) t *= (x - nodes[k]) / (nodes[j] - nodes[k]);
    s += t;
  }
  return s;
}

// Gauss-Jordan inverse (small systems).
int invert(std::vector<ld> &a, int n) {
  std::vector<ld> inv(n * n, 0.0L);
  for (int i = 0; i < n; ++i) inv[i * n + i] = 1.0L;
  for (int col = 0; col < n; ++col) {
    int piv = col;
    for (int r = col + 1; r < n; ++r)
      if (fabsl(a[r * n + col]) > fabsl(a[piv * n + col])) piv = r;
    if (a[piv * n + col] == 0.0L) return 1;
    if (piv != col)
      for (int k = 0; k < n; ++k) {
        std::swap(a[piv * n + k], a[col * n + k]);
        std::swap(inv[piv * n + k], inv[col * n + k]);
      }
    ld d = a[col * n + col];
    for (int k = 0; k < n; ++k) {
      a[col * n + k] /= d;
      inv[col * n + k] /= d;
    }
    for (int r = 0; r < n; ++r) {
      if (r == col) continue;
      ld m = a[r * n + col];
      if (m == 0.0L) continue;
      for (int k = 0; k < n; ++k) {
        a[r * n + k] -= m * a[col * n + k];
        inv[r * n + k] -= m * inv[col * n + k];
      }
    }
  }
  a = inv;
  return 0;
}

}  // namespace

extern "C" {

int spirk_gauss_legendre(int n, double *x, double *w) {
  std::vector<ld> xl(n), wl(n);
  if (gauss_legendre01(n, xl.data(), wl.data())) return 1;
  for (int i = 0; i < n; ++i) {
    x[i] = (double)xl[i];
    w[i] = (double)wl[i];
  }
  return 0;
}

int spirk_gauss_lobatto(int degree, double *pts) {
  std::vector<ld> p(degree + 1);
  if (gauss_lobatto01(degree, p.data())) return 1;
  for (int i = 0; i <= degree; ++i) pts[i] = (double)p[i];
  return 0;
}

// Reference-cell mass/stiffness on [0,1] with QGauss(degree+1), row-major
// (degree+1)^2 buffers (cf. reference operator.h cell integrals).
int spirk_local_matrices(int degree, double *mass, double *stiff) {
  int n = degree + 1, nq = degree + 1;
  std::vector<ld> nodes(n), xq(nq), wq(nq);
  if (gauss_lobatto01(degree, nodes.data())) return 1;
  if (gauss_legendre01(nq, xq.data(), wq.data())) return 1;
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < n; ++j) {
      ld m = 0.0L, k = 0.0L;
      for (int q = 0; q < nq; ++q) {
        m += wq[q] * lagrange_val(nodes.data(), n, i, xq[q]) *
             lagrange_val(nodes.data(), n, j, xq[q]);
        k += wq[q] * lagrange_der(nodes.data(), n, i, xq[q]) *
             lagrange_der(nodes.data(), n, j, xq[q]);
      }
      mass[i * n + j] = (double)m;
      stiff[i * n + j] = (double)k;
    }
  return 0;
}

// Global interior-node banded assembly: band[(p+k)*m + i] = Op[i, i+k],
// mirroring the Python layer's layout (assembly.py).
int spirk_assemble_band_1d(int n_cells, int degree, const double *local,
                           double scale, double *band) {
  int p = degree, n = n_cells * p + 1, m = n - 2, nb = 2 * p + 1;
  std::vector<ld> full((size_t)nb * n, 0.0L);
  for (int c = 0; c < n_cells; ++c)
    for (int i = 0; i <= p; ++i)
      for (int j = 0; j <= p; ++j) {
        int row = c * p + i, k = j - i;
        full[(size_t)(p + k) * n + row] += (ld)local[i * (p + 1) + j] * scale;
      }
  std::memset(band, 0, sizeof(double) * (size_t)nb * m);
  for (int k = -p; k <= p; ++k)
    for (int i = 0; i < m; ++i) {
      int col = i + 1 + k;
      if (col >= 1 && col <= n - 2)
        band[(size_t)(p + k) * m + i] = (double)full[(size_t)(p + k) * n + i + 1];
    }
  return 0;
}

// 1D interior prolongation coarse -> 2x refined (row-major m_f x m_c).
int spirk_prolongation_1d(int n_cells_coarse, int degree, double *P) {
  int p = degree, nf = 2 * n_cells_coarse;
  int n_fine = nf * p + 1, n_coarse = n_cells_coarse * p + 1;
  int mf = n_fine - 2, mc = n_coarse - 2;
  std::vector<ld> support(p + 1);
  if (gauss_lobatto01(p, support.data())) return 1;
  std::vector<ld> xf(n_fine);
  for (int c = 0; c < nf; ++c)
    for (int i = 0; i < p; ++i) xf[c * p + i] = (c + support[i]) / (ld)nf;
  xf[n_fine - 1] = 1.0L;
  ld hc = 1.0L / n_cells_coarse;
  std::memset(P, 0, sizeof(double) * (size_t)mf * mc);
  for (int i = 1; i < n_fine - 1; ++i) {
    int c = (int)(xf[i] / hc);
    if (c > n_cells_coarse - 1) c = n_cells_coarse - 1;
    ld xi = xf[i] / hc - c;
    for (int j = 0; j <= p; ++j) {
      int col = c * p + j;
      if (col >= 1 && col <= n_coarse - 2)
        P[(size_t)(i - 1) * mc + (col - 1)] =
            (double)lagrange_val(support.data(), p + 1, j, xi);
    }
  }
  return 0;
}

// Radau IIA tables: A, A_inv, b, c plus the real LU-diagonalization
// L = T diag(D) T^{-1} with A_inv = L U, U unit upper triangular
// (cf. reference tables/irk_ev.m).  All buffers row-major, size s resp s^2.
int spirk_radau_tables(int s, double *A, double *A_inv, double *b, double *c,
                       double *L, double *T, double *T_inv, double *D) {
  // nodes: interior roots of P_{s-1}^{(1,0)} mapped to (0,1), then 1
  std::vector<ld> cl(s);
  if (s > 1) {
    std::vector<ld> r(s - 1);
    auto f = [s](ld t) { return jacobi(s - 1, 1.0L, 0.0L, t); };
    if (roots_by_bisection(f, s - 1, -1.0L, 1.0L, r.data())) return 1;
    for (int i = 0; i < s - 1; ++i) cl[i] = 0.5L * (r[i] + 1.0L);
  }
  cl[s - 1] = 1.0L;

  // A[i][j] = int_0^{c_i} l_j  via GL(s+2) on [0, c_i]
  int nq = s + 2;
  std::vector<ld> xq(nq), wq(nq), Al((size_t)s * s);
  if (gauss_legendre01(nq, xq.data(), wq.data())) return 1;
  for (int i = 0; i < s; ++i)
    for (int j = 0; j < s; ++j) {
      ld acc = 0.0L;
      for (int q = 0; q < nq; ++q)
        acc += cl[i] * wq[q] *
               lagrange_val(cl.data(), s, j, cl[i] * xq[q]);
      Al[(size_t)i * s + j] = acc;
    }

  std::vector<ld> Ainv(Al);
  if (invert(Ainv, s)) return 1;

  // Crout LU of A_inv: A_inv = Lf * U, U unit upper
  std::vector<ld> Lf((size_t)s * s, 0.0L), U((size_t)s * s, 0.0L);
  for (int i = 0; i < s; ++i) U[(size_t)i * s + i] = 1.0L;
  for (int j = 0; j < s; ++j) {
    for (int i = j; i < s; ++i) {
      ld acc = Ainv[(size_t)i * s + j];
      for (int k = 0; k < j; ++k) acc -= Lf[(size_t)i * s + k] * U[(size_t)k * s + j];
      Lf[(size_t)i * s + j] = acc;
    }
    for (int k = j + 1; k < s; ++k) {
      ld acc = Ainv[(size_t)j * s + k];
      for (int t = 0; t < j; ++t) acc -= Lf[(size_t)j * s + t] * U[(size_t)t * s + k];
      U[(size_t)j * s + k] = acc / Lf[(size_t)j * s + j];
    }
  }

  // eigen-decomposition of lower-triangular Lf: eigenvalues = diagonal,
  // eigenvectors by forward substitution; sort descending
  std::vector<int> order(s);
  for (int i = 0; i < s; ++i) order[i] = i;
  for (int i = 0; i < s; ++i)
    for (int j = i + 1; j < s; ++j)
      if (Lf[(size_t)order[j] * s + order[j]] >
          Lf[(size_t)order[i] * s + order[i]])
        std::swap(order[i], order[j]);

  std::vector<ld> V((size_t)s * s, 0.0L);
  for (int col = 0; col < s; ++col) {
    int k = order[col];
    ld lam = Lf[(size_t)k * s + k];
    std::vector<ld> v(s, 0.0L);
    v[k] = 1.0L;
    for (int i = k + 1; i < s; ++i) {
      ld acc = 0.0L;
      for (int j = k; j < i; ++j) acc += Lf[(size_t)i * s + j] * v[j];
      v[i] = acc / (lam - Lf[(size_t)i * s + i]);
    }
    ld nrm = 0.0L;
    for (int i = 0; i < s; ++i) nrm += v[i] * v[i];
    nrm = sqrtl(nrm);
    for (int i = 0; i < s; ++i) V[(size_t)i * s + col] = v[i] / nrm;
    D[col] = (double)lam;
  }
  std::vector<ld> Vinv(V);
  if (invert(Vinv, s)) return 1;

  for (int i = 0; i < s; ++i) {
    c[i] = (double)cl[i];
    b[i] = (double)Al[(size_t)(s - 1) * s + i];
    for (int j = 0; j < s; ++j) {
      A[i * s + j] = (double)Al[(size_t)i * s + j];
      A_inv[i * s + j] = (double)Ainv[(size_t)i * s + j];
      L[i * s + j] = (double)Lf[(size_t)i * s + j];
      T[i * s + j] = (double)V[(size_t)i * s + j];
      T_inv[i * s + j] = (double)Vinv[(size_t)i * s + j];
    }
  }
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// complex eigendecomposition of small real matrices (Radau A^{-1})
// ---------------------------------------------------------------------------
//
// Native counterpart of the `[V,D] = eig(Ainv)` branch of the reference's
// Octave table generator (tables/irk_ev.m:52-72): Hessenberg reduction +
// Francis QR iteration for the eigenvalues, inverse iteration with complex
// LU for the eigenvectors.  Matrices are tiny (s <= 10), all arithmetic in
// long double complex.

#include <complex>

namespace {

using cld = std::complex<ld>;

// Hessenberg reduction by Householder reflections (in place).
void hessenberg(std::vector<ld> &A, int n) {
  for (int k = 0; k < n - 2; ++k) {
    ld norm = 0.0L;
    for (int i = k + 1; i < n; ++i) norm += A[(size_t)i * n + k] * A[(size_t)i * n + k];
    norm = sqrtl(norm);
    if (norm == 0.0L) continue;
    ld alpha = A[(size_t)(k + 1) * n + k] >= 0 ? -norm : norm;
    std::vector<ld> v(n, 0.0L);
    v[k + 1] = A[(size_t)(k + 1) * n + k] - alpha;
    for (int i = k + 2; i < n; ++i) v[i] = A[(size_t)i * n + k];
    ld vnorm2 = 0.0L;
    for (int i = k + 1; i < n; ++i) vnorm2 += v[i] * v[i];
    if (vnorm2 == 0.0L) continue;
    // A <- (I - 2vv^T/v^Tv) A (I - 2vv^T/v^Tv)
    for (int j = 0; j < n; ++j) {
      ld dot = 0.0L;
      for (int i = k + 1; i < n; ++i) dot += v[i] * A[(size_t)i * n + j];
      dot = 2.0L * dot / vnorm2;
      for (int i = k + 1; i < n; ++i) A[(size_t)i * n + j] -= dot * v[i];
    }
    for (int i = 0; i < n; ++i) {
      ld dot = 0.0L;
      for (int j = k + 1; j < n; ++j) dot += A[(size_t)i * n + j] * v[j];
      dot = 2.0L * dot / vnorm2;
      for (int j = k + 1; j < n; ++j) A[(size_t)i * n + j] -= dot * v[j];
    }
  }
}

// Eigenvalues of an upper-Hessenberg matrix by complex-shifted QR
// (complex Givens sweeps converge for conjugate pairs without the
// double-shift machinery; fine for the tiny matrices here).
int hessenberg_eigs(const std::vector<ld> &H_in, int n, std::vector<cld> &eigs) {
  std::vector<cld> H((size_t)n * n);
  for (int i = 0; i < n * n; ++i) H[i] = cld(H_in[i]);
  eigs.clear();
  int m = n;
  int iter_total = 0;
  while (m > 0) {
    if (m == 1) {
      eigs.push_back(H[0]);
      --m;
      continue;
    }
    // deflate the trailing subdiagonal when converged
    ld sub = std::abs(H[(size_t)(m - 1) * n + (m - 2)]);
    ld scale = std::abs(H[(size_t)(m - 1) * n + (m - 1)]) +
               std::abs(H[(size_t)(m - 2) * n + (m - 2)]);
    if (sub < 1e-24L * (scale > 0 ? scale : 1.0L)) {
      eigs.push_back(H[(size_t)(m - 1) * n + (m - 1)]);
      --m;
      continue;
    }
    if (++iter_total > 2000 * n) return 1;
    // Wilkinson shift from the trailing complex 2x2
    cld a = H[(size_t)(m - 2) * n + (m - 2)], b = H[(size_t)(m - 2) * n + (m - 1)];
    cld c = H[(size_t)(m - 1) * n + (m - 2)], d = H[(size_t)(m - 1) * n + (m - 1)];
    cld tr = a + d, det = a * d - b * c;
    cld disc = std::sqrt(tr * tr / cld(4) - det);
    cld r1 = tr / cld(2) + disc, r2 = tr / cld(2) - disc;
    cld mu = (std::abs(r1 - d) < std::abs(r2 - d)) ? r1 : r2;
    // shifted complex QR step on the active m x m block
    for (int i = 0; i < m; ++i) H[(size_t)i * n + i] -= mu;
    std::vector<cld> cs(m, cld(1)), sn(m, cld(0));
    for (int k = 0; k < m - 1; ++k) {
      cld x = H[(size_t)k * n + k], y = H[(size_t)(k + 1) * n + k];
      ld r = sqrtl(std::norm(x) + std::norm(y));
      if (r == 0.0L) { cs[k] = cld(1); sn[k] = cld(0); continue; }
      cs[k] = std::conj(x) / r;
      sn[k] = std::conj(y) / r;
      for (int j = k; j < m; ++j) {
        cld h1 = H[(size_t)k * n + j], h2 = H[(size_t)(k + 1) * n + j];
        H[(size_t)k * n + j] = cs[k] * h1 + sn[k] * h2;
        H[(size_t)(k + 1) * n + j] = -std::conj(sn[k]) * h1 + std::conj(cs[k]) * h2;
      }
    }
    // RQ: apply the conjugate rotations from the right
    for (int k = 0; k < m - 1; ++k) {
      int imax = (k + 2 < m) ? k + 2 : m - 1;
      for (int i = 0; i <= imax; ++i) {
        cld h1 = H[(size_t)i * n + k], h2 = H[(size_t)i * n + (k + 1)];
        H[(size_t)i * n + k] = h1 * std::conj(cs[k]) + h2 * std::conj(sn[k]);
        H[(size_t)i * n + (k + 1)] = -h1 * sn[k] + h2 * cs[k];
      }
    }
    for (int i = 0; i < m; ++i) H[(size_t)i * n + i] += mu;
  }
  return 0;
}

// Complex LU solve with partial pivoting (in place).
int csolve(std::vector<cld> M, std::vector<cld> &x, int n) {
  std::vector<int> piv(n);
  for (int i = 0; i < n; ++i) piv[i] = i;
  for (int col = 0; col < n; ++col) {
    int p = col;
    for (int r = col + 1; r < n; ++r)
      if (std::abs(M[(size_t)r * n + col]) > std::abs(M[(size_t)p * n + col]))
        p = r;
    if (p != col) {
      for (int k = 0; k < n; ++k) std::swap(M[(size_t)p * n + k], M[(size_t)col * n + k]);
      std::swap(x[p], x[col]);
    }
    cld d = M[(size_t)col * n + col];
    if (std::abs(d) < 1e-300L) d = cld(1e-300L);
    for (int r = col + 1; r < n; ++r) {
      cld f = M[(size_t)r * n + col] / d;
      if (f == cld(0)) continue;
      for (int k = col; k < n; ++k) M[(size_t)r * n + k] -= f * M[(size_t)col * n + k];
      x[r] -= f * x[col];
    }
  }
  for (int r = n - 1; r >= 0; --r) {
    cld acc = x[r];
    for (int k = r + 1; k < n; ++k) acc -= M[(size_t)r * n + k] * x[k];
    x[r] = acc / M[(size_t)r * n + r];
  }
  return 0;
}

int cinvert(std::vector<cld> &A, int n) {
  std::vector<cld> inv((size_t)n * n);
  for (int col = 0; col < n; ++col) {
    std::vector<cld> e(n, cld(0));
    e[col] = cld(1);
    std::vector<cld> x = e;
    if (csolve(A, x, n)) return 1;
    for (int r = 0; r < n; ++r) inv[(size_t)r * n + col] = x[r];
  }
  A = inv;
  return 0;
}

}  // namespace

extern "C" {

// Complex eigendecomposition of the s x s Radau A^{-1} with the reference's
// conventions (tables/irk_ev.m:52-72): eigenpairs sorted by descending
// |lambda|^2, conjugate pairs adjacent with +imag first, unit-norm columns,
// exact column conjugacy, V_inv = V^{-1}.
int spirk_complex_tables(int s, const double *A_inv_in, double *T_re,
                         double *T_im, double *T_inv_re, double *T_inv_im,
                         double *D_re, double *D_im) {
  int n = s;
  std::vector<ld> A((size_t)n * n);
  for (int i = 0; i < n * n; ++i) A[i] = (ld)A_inv_in[i];

  std::vector<ld> H(A);
  hessenberg(H, n);
  std::vector<cld> eigs;
  if (hessenberg_eigs(H, n, eigs)) return 1;
  if ((int)eigs.size() != n) return 1;

  // sort by descending |lambda|^2, then by descending imag (pairs adjacent,
  // +imag first)
  std::sort(eigs.begin(), eigs.end(), [](const cld &x, const cld &y) {
    ld mx = std::norm(x), my = std::norm(y);
    if (fabsl(mx - my) > 1e-12L * (mx + my)) return mx > my;
    return x.imag() > y.imag();
  });
  // canonicalize conjugate pairs exactly
  for (int i = 0; i + 1 < n; i += 2) {
    if (fabsl(eigs[i].imag()) > 1e-18L) {
      cld avg = (eigs[i] + std::conj(eigs[i + 1])) / cld(2);
      eigs[i] = avg;
      eigs[i + 1] = std::conj(avg);
    }
  }

  // eigenvectors by inverse iteration on (A - (1+eps) lambda I)
  std::vector<cld> V((size_t)n * n);
  for (int col = 0; col < n; ++col) {
    // conjugate partner: copy and conjugate
    if (col % 2 == 1 && fabsl(eigs[col].imag()) > 1e-18L) {
      for (int i = 0; i < n; ++i)
        V[(size_t)i * n + col] = std::conj(V[(size_t)i * n + (col - 1)]);
      continue;
    }
    cld lam = eigs[col] * cld(1.0L + 1e-22L) + cld(0.0L, 1e-25L);
    std::vector<cld> M((size_t)n * n);
    for (int i = 0; i < n; ++i)
      for (int j = 0; j < n; ++j)
        M[(size_t)i * n + j] = cld(A[(size_t)i * n + j]) - (i == j ? lam : cld(0));
    std::vector<cld> v(n, cld(1));
    for (int it = 0; it < 3; ++it) {
      if (csolve(M, v, n)) return 1;
      ld nrm = 0.0L;
      for (int i = 0; i < n; ++i) nrm += std::norm(v[i]);
      nrm = sqrtl(nrm);
      if (nrm == 0.0L) return 1;
      for (int i = 0; i < n; ++i) v[i] /= nrm;
    }
    // deterministic phase: make the largest-magnitude entry real-positive
    int imax = 0;
    for (int i = 1; i < n; ++i)
      if (std::abs(v[i]) > std::abs(v[imax])) imax = i;
    cld phase = v[imax] / std::abs(v[imax]);
    for (int i = 0; i < n; ++i) v[i] /= phase;
    for (int i = 0; i < n; ++i) V[(size_t)i * n + col] = v[i];
  }

  std::vector<cld> Vinv(V);
  if (cinvert(Vinv, n)) return 1;

  for (int i = 0; i < n; ++i) {
    D_re[i] = (double)eigs[i].real();
    D_im[i] = (double)eigs[i].imag();
    for (int j = 0; j < n; ++j) {
      T_re[i * n + j] = (double)V[(size_t)i * n + j].real();
      T_im[i * n + j] = (double)V[(size_t)i * n + j].imag();
      T_inv_re[i * n + j] = (double)Vinv[(size_t)i * n + j].real();
      T_inv_im[i * n + j] = (double)Vinv[(size_t)i * n + j].imag();
    }
  }
  return 0;
}

}  // extern "C"
