// Host-side NURBS geometry kernel (C++), the native replacement for the
// OpenCASCADE evaluation/projection routines the reference leans on
// (reference: GOLDFISH/cpiga2xi.py:346-375 OCC D0/D1 point evaluation;
// PENGoLINS OCCPreprocessing surface-surface intersection sampling).
//
// Scope: batched rational surface evaluation (value + 1st/2nd parametric
// derivatives, Piegl & Tiller A2.3/A3.6-style) and batched projected-
// Newton closest-point projection with a trust region - the hot loops of
// geometry/preprocessing.py. Exposed with a plain C ABI for ctypes.
//
// Build: g++ -O3 -march=native -shared -fPIC geometry_kernel.cpp
//        -o libgoldfish_geom.so      (see goldfish_jax/geometry/native.py)

#include <cmath>
#include <cstring>
#include <vector>

namespace {

struct Surface {
    const double* knots_u;
    int nku;
    const double* knots_v;
    int nkv;
    int p, q;
    const double* ctrl;  // homogeneous (n_u*n_v, 4), row-major i_u*n_v+i_v
    int n_u, n_v;
};

int find_span(const double* U, int nk, int p, int n_basis, double u) {
    // n_basis = nk - p - 1
    int n = n_basis - 1;
    if (u >= U[n + 1]) {
        int i = n;
        while (i > p && U[i] == U[i + 1]) --i;
        return i;
    }
    if (u <= U[p]) {
        int i = p;
        while (i < n && U[i] == U[i + 1]) ++i;
        return i;
    }
    int lo = p, hi = n + 1, mid = (lo + hi) / 2;
    while (u < U[mid] || u >= U[mid + 1]) {
        if (u < U[mid]) hi = mid; else lo = mid;
        mid = (lo + hi) / 2;
    }
    return mid;
}

// ders[k][j] = d^k N_{span-p+j}, k = 0..nd  (Piegl & Tiller A2.3)
void ders_basis(const double* U, int p, int span, double u, int nd,
                double* ders /* (nd+1) x (p+1) */) {
    const int pp = p + 1;
    std::vector<double> ndu(pp * pp), left(pp), right(pp), a(2 * pp);
    ndu[0] = 1.0;
    for (int j = 1; j <= p; ++j) {
        left[j] = u - U[span + 1 - j];
        right[j] = U[span + j] - u;
        double saved = 0.0;
        for (int r = 0; r < j; ++r) {
            ndu[j * pp + r] = right[r + 1] + left[j - r];
            double temp = ndu[r * pp + (j - 1)] / ndu[j * pp + r];
            ndu[r * pp + j] = saved + right[r + 1] * temp;
            saved = left[j - r] * temp;
        }
        ndu[j * pp + j] = saved;
    }
    for (int j = 0; j <= p; ++j) ders[j] = ndu[j * pp + p];
    for (int r = 0; r <= p; ++r) {
        int s1 = 0, s2 = 1;
        a[0] = 1.0;
        for (int k = 1; k <= nd; ++k) {
            double d = 0.0;
            int rk = r - k, pk = p - k;
            if (r >= k) {
                a[s2 * pp] = a[s1 * pp] / ndu[(pk + 1) * pp + rk];
                d = a[s2 * pp] * ndu[rk * pp + pk];
            }
            int j1 = (rk >= -1) ? 1 : -rk;
            int j2 = (r - 1 <= pk) ? (k - 1) : (p - r);
            for (int j = j1; j <= j2; ++j) {
                a[s2 * pp + j] =
                    (a[s1 * pp + j] - a[s1 * pp + j - 1]) /
                    ndu[(pk + 1) * pp + rk + j];
                d += a[s2 * pp + j] * ndu[(rk + j) * pp + pk];
            }
            if (r <= pk) {
                a[s2 * pp + k] = -a[s1 * pp + k - 1] / ndu[(pk + 1) * pp + r];
                d += a[s2 * pp + k] * ndu[r * pp + pk];
            }
            ders[k * pp + r] = d;
            int t = s1; s1 = s2; s2 = t;
        }
    }
    double rf = p;
    for (int k = 1; k <= nd; ++k) {
        for (int j = 0; j <= p; ++j) ders[k * pp + j] *= rf;
        rf *= (p - k);
    }
}

// rational surface value + derivatives up to total order nd (<=2);
// out layout: [S, Su, Sv, Suu, Suv, Svv] x 3 doubles (what's requested)
void surface_ders(const Surface& s, double u, double v, int nd,
                  double* out) {
    const int pp = s.p + 1, qq = s.q + 1;
    int su = find_span(s.knots_u, s.nku, s.p, s.nku - s.p - 1, u);
    int sv = find_span(s.knots_v, s.nkv, s.q, s.nkv - s.q - 1, v);
    std::vector<double> du((nd + 1) * pp), dv((nd + 1) * qq);
    ders_basis(s.knots_u, s.p, su, u, nd, du.data());
    ders_basis(s.knots_v, s.q, sv, v, nd, dv.data());

    // homogeneous derivatives A^{(a,b)} (4-vectors)
    double A[6][4];
    int nterms = (nd == 0) ? 1 : (nd == 1 ? 3 : 6);
    const int order_a[6] = {0, 1, 0, 2, 1, 0};
    const int order_b[6] = {0, 0, 1, 0, 1, 2};
    for (int t = 0; t < nterms; ++t) {
        int a = order_a[t], b = order_b[t];
        double acc[4] = {0, 0, 0, 0};
        for (int i = 0; i <= s.p; ++i) {
            int iu = su - s.p + i;
            for (int j = 0; j <= s.q; ++j) {
                int iv = sv - s.q + j;
                const double* cw = s.ctrl + (size_t)(iu * s.n_v + iv) * 4;
                double w = du[a * pp + i] * dv[b * qq + j];
                acc[0] += w * cw[0];
                acc[1] += w * cw[1];
                acc[2] += w * cw[2];
                acc[3] += w * cw[3];
            }
        }
        std::memcpy(A[t], acc, sizeof(acc));
    }
    // rational derivatives via quotient rule
    double W = A[0][3];
    double S[3] = {A[0][0] / W, A[0][1] / W, A[0][2] / W};
    std::memcpy(out, S, 3 * sizeof(double));
    if (nd >= 1) {
        double Su[3], Sv[3];
        for (int k = 0; k < 3; ++k) {
            Su[k] = (A[1][k] - S[k] * A[1][3]) / W;
            Sv[k] = (A[2][k] - S[k] * A[2][3]) / W;
        }
        std::memcpy(out + 3, Su, sizeof(Su));
        std::memcpy(out + 6, Sv, sizeof(Sv));
        if (nd >= 2) {
            for (int k = 0; k < 3; ++k) {
                out[9 + k] = (A[3][k] - 2 * A[1][3] * Su[k]
                              - A[3][3] * S[k]) / W;
                out[12 + k] = (A[4][k] - A[1][3] * Sv[k] - A[2][3] * Su[k]
                               - A[4][3] * S[k]) / W;
                out[15 + k] = (A[5][k] - 2 * A[2][3] * Sv[k]
                               - A[5][3] * S[k]) / W;
            }
        }
    }
}

}  // namespace

extern "C" {

// Batched evaluation: pts (m, 2) -> out (m, 18) [S,Su,Sv,Suu,Suv,Svv]
int gt_surface_eval(const double* knots_u, int nku, const double* knots_v,
                    int nkv, int p, int q, const double* ctrl, int n_u,
                    int n_v, const double* pts, int m, int nd,
                    double* out) {
    Surface s{knots_u, nku, knots_v, nkv, p, q, ctrl, n_u, n_v};
    int stride = (nd == 0) ? 3 : (nd == 1 ? 9 : 18);
    for (int i = 0; i < m; ++i) {
        surface_ders(s, pts[2 * i], pts[2 * i + 1], nd, out + i * stride);
    }
    return 0;
}

// Batched closest-point projection: X (m, 3) -> uv (m, 2), dist (m,)
int gt_closest_point(const double* knots_u, int nku, const double* knots_v,
                     int nkv, int p, int q, const double* ctrl, int n_u,
                     int n_v, const double* X, int m, int max_it,
                     double tol, double* uv, double* dist) {
    Surface s{knots_u, nku, knots_v, nkv, p, q, ctrl, n_u, n_v};
    const int NG = 9;
    double grid[NG];
    for (int i = 0; i < NG; ++i) grid[i] = (double)i / (NG - 1);
    double buf[18];

    for (int i = 0; i < m; ++i) {
        const double* x = X + 3 * i;
        // coarse seed
        double best = 1e300, bu = 0.5, bv = 0.5;
        for (int a = 0; a < NG; ++a) {
            for (int b = 0; b < NG; ++b) {
                surface_ders(s, grid[a], grid[b], 0, buf);
                double d2 = 0;
                for (int k = 0; k < 3; ++k) {
                    double t = buf[k] - x[k];
                    d2 += t * t;
                }
                if (d2 < best) { best = d2; bu = grid[a]; bv = grid[b]; }
            }
        }
        double u = bu, v = bv;
        for (int it = 0; it < max_it; ++it) {
            surface_ders(s, u, v, 2, buf);
            double r[3] = {buf[0] - x[0], buf[1] - x[1], buf[2] - x[2]};
            const double *Su = buf + 3, *Sv = buf + 6, *Suu = buf + 9,
                         *Suv = buf + 12, *Svv = buf + 15;
            double g1 = 0, g2 = 0, h11 = 0, h12 = 0, h22 = 0;
            for (int k = 0; k < 3; ++k) {
                g1 += r[k] * Su[k];
                g2 += r[k] * Sv[k];
                h11 += Su[k] * Su[k] + r[k] * Suu[k];
                h12 += Su[k] * Sv[k] + r[k] * Suv[k];
                h22 += Sv[k] * Sv[k] + r[k] * Svv[k];
            }
            double det = h11 * h22 - h12 * h12;
            if (std::fabs(det) < 1e-30) det = 1e-30;
            double du = -(h22 * g1 - h12 * g2) / det;
            double dv = -(-h12 * g1 + h11 * g2) / det;
            double ns = std::sqrt(du * du + dv * dv);
            if (ns > 0.25) { du *= 0.25 / ns; dv *= 0.25 / ns; }
            u += du; v += dv;
            if (u < 0) u = 0; if (u > 1) u = 1;
            if (v < 0) v = 0; if (v > 1) v = 1;
            if (std::fabs(du) < tol && std::fabs(dv) < tol) break;
        }
        surface_ders(s, u, v, 0, buf);
        double d2 = 0;
        for (int k = 0; k < 3; ++k) {
            double t = buf[k] - x[k];
            d2 += t * t;
        }
        uv[2 * i] = u;
        uv[2 * i + 1] = v;
        dist[i] = std::sqrt(d2);
    }
    return 0;
}

}  // extern "C"
