// L-BFGS-B: limited-memory BFGS with box constraints, reverse communication.
//
// Native optimizer component of grape_tpu_torch (the reference GRAPE.jl drives the
// classic Fortran L-BFGS-B 3.0 `setulb` through LBFGSB.jl at
// ext/GRAPELBFGSBExt.jl:70-143).  This is a from-scratch C++
// implementation of the algorithm of Byrd, Lu, Nocedal & Zhu,
// "A limited memory algorithm for bound constrained optimization" (1995):
//   - generalized Cauchy point along the projected steepest-descent path,
//   - subspace minimization over the free variables via the compact
//     limited-memory representation  B = theta*I - W K^{-1} W',
//     W = [Y, theta*S],  K = [[-D, L'], [L, theta*S'S]]  (direct primal
//     method with Sherman-Morrison-Woodbury),
//   - More-Thuente strong-Wolfe line search (MINPACK-2 dcsrch/dcstep
//     algorithm, reimplemented),
//   - reverse-communication task protocol (FG / NEW_X / CONVERGENCE / ...)
//     with the same factr/pgtol stopping semantics and task messages as the
//     Fortran code, so the GRAPE front end controls convergence
//     (ext/GRAPELBFGSBExt.jl:20-28).
//
// Exposed via a C API for ctypes.

#include <algorithm>
#include <cstdlib>
#include <cmath>
#include <cstring>
#include <cstdio>
#include <limits>
#include <string>
#include <vector>

namespace {

constexpr double EPSMCH = 2.220446049250313e-16;
constexpr double BIG = 1e10;

// ---------------------------------------------------------------------------
// Dense LU solve with partial pivoting for the small (2m x 2m) middle matrix.
// ---------------------------------------------------------------------------
struct LU {
    int n = 0;
    std::vector<double> a;   // n x n, row-major, factored in place
    std::vector<int> piv;
    bool ok = false;

    void factor(const std::vector<double>& mat, int nn) {
        n = nn;
        a = mat;
        piv.resize(n);
        ok = true;
        for (int k = 0; k < n; ++k) {
            int p = k;
            double amax = std::fabs(a[k * n + k]);
            for (int i = k + 1; i < n; ++i) {
                double v = std::fabs(a[i * n + k]);
                if (v > amax) { amax = v; p = i; }
            }
            piv[k] = p;
            if (amax < 1e-300) { ok = false; return; }
            if (p != k)
                for (int j = 0; j < n; ++j) std::swap(a[k * n + j], a[p * n + j]);
            const double pivv = a[k * n + k];
            for (int i = k + 1; i < n; ++i) {
                const double lik = a[i * n + k] / pivv;
                a[i * n + k] = lik;
                for (int j = k + 1; j < n; ++j) a[i * n + j] -= lik * a[k * n + j];
            }
        }
    }

    // solve in place.  The factorization swaps entire rows (LAPACK-style
    // storage), so ALL permutations must be applied to b before the clean
    // triangular solves — interleaving them with elimination would assume
    // LINPACK-style storage and silently corrupt the solution.
    void solve(double* b) const {
        for (int k = 0; k < n; ++k)
            if (piv[k] != k) std::swap(b[k], b[piv[k]]);
        for (int k = 0; k < n; ++k)
            for (int i = k + 1; i < n; ++i) b[i] -= a[i * n + k] * b[k];
        for (int k = n - 1; k >= 0; --k) {
            b[k] /= a[k * n + k];
            for (int i = 0; i < k; ++i) b[i] -= a[i * n + k] * b[k];
        }
    }
};

inline double dot(const double* x, const double* y, int n) {
    double s = 0.0;
    for (int i = 0; i < n; ++i) s += x[i] * y[i];
    return s;
}

// ---------------------------------------------------------------------------
// More-Thuente line search (MINPACK-2 dcsrch / dcstep algorithm).
// ---------------------------------------------------------------------------
struct Dcsrch {
    // options
    double ftol = 1e-3, gtol = 0.9, xtol = 0.1;
    double stpmin = 0.0, stpmax = BIG;
    // state
    int stage = 0;
    bool brackt = false;
    double finit = 0, ginit = 0, gtest = 0, width = 0, width1 = 0;
    double stx = 0, fx = 0, gx = 0, sty = 0, fy = 0, gy = 0;
    double stmin = 0, stmax = 0;
    std::string status;  // "", "FG", "CONV", "WARN:...", "ERROR:..."

    void start(double f0, double g0, double stp0) {
        if (g0 >= 0.0) { status = "ERROR: INITIAL G >= 0"; return; }
        brackt = false;
        stage = 1;
        finit = f0;
        ginit = g0;
        gtest = ftol * ginit;
        width = stpmax - stpmin;
        width1 = width / 0.5;
        stx = 0.0; fx = finit; gx = ginit;
        sty = 0.0; fy = finit; gy = ginit;
        stmin = 0.0;
        stmax = stp0 + 4.0 * stp0;
        status = "FG";
        (void)stp0;
    }

    // dcstep: trial-step update for the search interval (MINPACK-2).
    static void dcstep(double& stx, double& fx, double& dx, double& sty,
                       double& fy, double& dy, double& stp, double fp,
                       double dp, bool& brackt, double stpmin, double stpmax) {
        const double sgnd = dp * (dx / std::fabs(dx));
        double stpf;
        if (fp > fx) {
            // Case 1: higher function value -> minimum bracketed
            const double theta = 3.0 * (fx - fp) / (stp - stx) + dx + dp;
            const double s = std::max({std::fabs(theta), std::fabs(dx), std::fabs(dp)});
            double gamma = s * std::sqrt(std::max(0.0, (theta / s) * (theta / s) - (dx / s) * (dp / s)));
            if (stp < stx) gamma = -gamma;
            const double p = (gamma - dx) + theta;
            const double q = ((gamma - dx) + gamma) + dp;
            const double r = p / q;
            const double stpc = stx + r * (stp - stx);
            const double stpq = stx + ((dx / ((fx - fp) / (stp - stx) + dx)) / 2.0) * (stp - stx);
            if (std::fabs(stpc - stx) < std::fabs(stpq - stx))
                stpf = stpc;
            else
                stpf = stpc + (stpq - stpc) / 2.0;
            brackt = true;
        } else if (sgnd < 0.0) {
            // Case 2: lower value, opposite-sign derivative
            const double theta = 3.0 * (fx - fp) / (stp - stx) + dx + dp;
            const double s = std::max({std::fabs(theta), std::fabs(dx), std::fabs(dp)});
            double gamma = s * std::sqrt(std::max(0.0, (theta / s) * (theta / s) - (dx / s) * (dp / s)));
            if (stp > stx) gamma = -gamma;
            const double p = (gamma - dp) + theta;
            const double q = ((gamma - dp) + gamma) + dx;
            const double r = p / q;
            const double stpc = stp + r * (stx - stp);
            const double stpq = stp + (dp / (dp - dx)) * (stx - stp);
            if (std::fabs(stpc - stp) > std::fabs(stpq - stp))
                stpf = stpc;
            else
                stpf = stpq;
            brackt = true;
        } else if (std::fabs(dp) < std::fabs(dx)) {
            // Case 3: lower value, same sign, decreasing magnitude
            const double theta = 3.0 * (fx - fp) / (stp - stx) + dx + dp;
            const double s = std::max({std::fabs(theta), std::fabs(dx), std::fabs(dp)});
            double gamma = s * std::sqrt(std::max(0.0, (theta / s) * (theta / s) - (dx / s) * (dp / s)));
            if (stp > stx) gamma = -gamma;
            const double p = (gamma - dp) + theta;
            const double q = (gamma + (dx - dp)) + gamma;
            const double r = p / q;
            double stpc;
            if (r < 0.0 && gamma != 0.0)
                stpc = stp + r * (stx - stp);
            else if (stp > stx)
                stpc = stpmax;
            else
                stpc = stpmin;
            const double stpq = stp + (dp / (dp - dx)) * (stx - stp);
            if (brackt) {
                if (std::fabs(stpc - stp) < std::fabs(stpq - stp))
                    stpf = stpc;
                else
                    stpf = stpq;
                if (stp > stx)
                    stpf = std::min(stp + 0.66 * (sty - stp), stpf);
                else
                    stpf = std::max(stp + 0.66 * (sty - stp), stpf);
            } else {
                if (std::fabs(stpc - stp) > std::fabs(stpq - stp))
                    stpf = stpc;
                else
                    stpf = stpq;
                stpf = std::min(stpmax, stpf);
                stpf = std::max(stpmin, stpf);
            }
        } else {
            // Case 4: lower value, same sign, not decreasing
            if (brackt) {
                const double theta = 3.0 * (fp - fy) / (sty - stp) + dy + dp;
                const double s = std::max({std::fabs(theta), std::fabs(dy), std::fabs(dp)});
                double gamma = s * std::sqrt(std::max(0.0, (theta / s) * (theta / s) - (dy / s) * (dp / s)));
                if (stp > sty) gamma = -gamma;
                const double p = (gamma - dp) + theta;
                const double q = ((gamma - dp) + gamma) + dy;
                const double r = p / q;
                const double stpc = stp + r * (sty - stp);
                stpf = stpc;
            } else if (stp > stx) {
                stpf = stpmax;
            } else {
                stpf = stpmin;
            }
        }
        // Update the interval; the new step is stpf unclamped (MINPACK
        // dcstep clamps only in the non-bracketed case 3 above — the caller
        // applies the trust-window and user-bound safeguards).
        if (fp > fx) {
            sty = stp; fy = fp; dy = dp;
        } else {
            if (sgnd < 0.0) { sty = stx; fy = fx; dy = dx; }
            stx = stp; fx = fp; dx = dp;
        }
        stp = stpf;
    }

    // One reverse-communication round: given f, g at current stp, update stp.
    // status: "FG" -> evaluate at new stp; "CONV" -> done; "WARN:.." -> stop.
    void iterate(double& stp, double f, double g) {
        if (stage == 1 && f <= finit + stp * gtest && g >= 0.0) stage = 2;

        // convergence / warning tests
        if (brackt && (stp <= stmin || stp >= stmax)) {
            status = "WARN: ROUNDING ERRORS PREVENT PROGRESS";
            return;
        }
        if (brackt && stmax - stmin <= xtol * stmax) {
            status = "WARN: XTOL TEST SATISFIED";
            return;
        }
        if (stp == stpmax && f <= finit + stp * gtest && g <= gtest) {
            status = "WARN: STP = STPMAX";
            return;
        }
        if (stp == stpmin && (f > finit + stp * gtest || g >= gtest)) {
            status = "WARN: STP = STPMIN";
            return;
        }
        if (f <= finit + stp * gtest && std::fabs(g) <= gtol * (-ginit)) {
            status = "CONV";
            return;
        }

        // stage-1 modified function trick
        if (stage == 1 && f <= fx && f > finit + stp * gtest) {
            double fm = f - stp * gtest;
            double fxm = fx - stx * gtest;
            double fym = fy - sty * gtest;
            double gm = g - gtest;
            double gxm = gx - gtest;
            double gym = gy - gtest;
            dcstep(stx, fxm, gxm, sty, fym, gym, stp, fm, gm, brackt, stmin, stmax);
            fx = fxm + stx * gtest;
            fy = fym + sty * gtest;
            gx = gxm + gtest;
            gy = gym + gtest;
        } else {
            dcstep(stx, fx, gx, sty, fy, gy, stp, f, g, brackt, stmin, stmax);
        }

        if (brackt) {
            if (std::fabs(sty - stx) >= 0.66 * width1)
                stp = stx + 0.5 * (sty - stx);
            width1 = width;
            width = std::fabs(sty - stx);
            stmin = std::min(stx, sty);
            stmax = std::max(stx, sty);
        } else {
            stmin = stp + 1.1 * (stp - stx);
            stmax = stp + 4.0 * (stp - stx);
        }
        stp = std::max(stp, stpmin);
        stp = std::min(stp, stpmax);
        if ((brackt && (stp <= stmin || stp >= stmax)) ||
            (brackt && stmax - stmin <= xtol * stmax))
            stp = stx;
        status = "FG";
    }
};

}  // namespace

// ---------------------------------------------------------------------------
// Main solver state
// ---------------------------------------------------------------------------
struct LbfgsbState {
    int n = 0, m = 10;
    std::vector<double> l, u;
    std::vector<int> nbd;  // 0 none, 1 lower, 2 both, 3 upper

    // limited-memory data (most recent ncorr pairs, column i = order of age,
    // index 0 = oldest)
    int ncorr = 0;
    std::vector<std::vector<double>> Scols, Ycols;
    double theta = 1.0;
    std::vector<double> Kmat;  // (2c x 2c) middle matrix
    LU Klu;

    // iteration state
    int iter = 0;
    int phase = 0;  // 0=START, 1=EVAL0, 2=LNSRCH, 3=AFTER_NEWX
    std::vector<double> x_start, g_start, d, xcp, ccau, z;
    double f_start = 0;
    double stp = 1.0, stpmax_ls = BIG, dnorm = 0;
    std::vector<double> dbg_r, dbg_du, dbg_w, dbg_v1, dbg_v2, dbg_N;
    int ls_evals = 0;
    bool ls_retried = false;  // steepest-descent restart already attempted
    Dcsrch ls;
    double f_cur = 0;
    std::string msg = "START";
    double sbgnrm = 0;

    // trace counters (annotated iprint>=100 dump, the reference's
    // isave/dsave analog, ext/GRAPELBFGSBExt.jl:150-192)
    int cauchy_intervals = 0;        // intervals explored, current iter
    long cauchy_intervals_total = 0; // ... accumulated over the run
    int skipped_updates = 0;         // rejected weak-curvature BFGS pairs
    int n_free = 0;                  // free variables at the Cauchy point

    int c2() const { return 2 * ncorr; }

    // W row i as a 2c vector: [Y_0[i].. Y_{c-1}[i], theta*S_0[i]..]
    void wrow(int i, double* out) const {
        for (int j = 0; j < ncorr; ++j) {
            out[j] = Ycols[j][i];
            out[ncorr + j] = theta * Scols[j][i];
        }
    }

    void wtv(const double* v, double* out) const {  // out = W' v  (2c)
        for (int j = 0; j < ncorr; ++j) {
            out[j] = dot(Ycols[j].data(), v, n);
            out[ncorr + j] = theta * dot(Scols[j].data(), v, n);
        }
    }

    void form_K() {
        const int c = ncorr;
        Kmat.assign(4 * c * c, 0.0);
        const int dim = 2 * c;
        for (int i = 0; i < c; ++i) {
            for (int j = 0; j < c; ++j) {
                const double sy = dot(Scols[i].data(), Ycols[j].data(), n);
                const double ss = dot(Scols[i].data(), Scols[j].data(), n);
                if (i == j) Kmat[i * dim + j] = -sy;           // -D
                if (i > j) {
                    Kmat[(c + i) * dim + j] = sy;              // L
                    Kmat[j * dim + (c + i)] = sy;              // L'
                }
                Kmat[(c + i) * dim + (c + j)] = theta * ss;    // theta S'S
            }
        }
        Klu.factor(Kmat, dim);
    }

    void ksolve(double* v) const {  // v <- K^{-1} v (2c)
        if (ncorr > 0 && Klu.ok) Klu.solve(v);
    }

    double proj(double v, int i) const {
        if (nbd[i] == 1 || nbd[i] == 2) v = std::max(v, l[i]);
        if (nbd[i] == 2 || nbd[i] == 3) v = std::min(v, u[i]);
        return v;
    }

    double projgrad_norm(const double* x, const double* g) const {
        double nrm = 0.0;
        for (int i = 0; i < n; ++i) {
            const double pg = x[i] - proj(x[i] - g[i], i);
            nrm = std::max(nrm, std::fabs(pg));
        }
        return nrm;
    }

    // ---- generalized Cauchy point (Algorithm CP, Byrd et al. 1995 sec. 4)
    void cauchy(const double* x, const double* g) {
        const int c = ncorr, dim = 2 * c;
        xcp.assign(x, x + n);
        d.assign(n, 0.0);
        std::vector<double> t(n);
        std::vector<int> order;
        order.reserve(n);
        for (int i = 0; i < n; ++i) {
            double ti = BIG;
            if (g[i] < 0.0) {
                if (nbd[i] == 2 || nbd[i] == 3) ti = (x[i] - u[i]) / g[i];
            } else if (g[i] > 0.0) {
                if (nbd[i] == 1 || nbd[i] == 2) ti = (x[i] - l[i]) / g[i];
            }
            if (g[i] == 0.0) ti = BIG;
            t[i] = ti;
            if (ti > 0.0) d[i] = -g[i];
            // t_i == 0: the variable sits at a bound with the gradient
            // pushing outward; it stays fixed (xcp_i = x_i, d_i = 0) and is
            // NOT a breakpoint of the path (Fortran cauchy.f sets these
            // aside before the breakpoint loop).
            if (ti > 0.0 && ti < BIG) order.push_back(i);
        }
        std::sort(order.begin(), order.end(),
                  [&](int a, int b) { return t[a] < t[b]; });

        std::vector<double> p(dim, 0.0);
        ccau.assign(dim, 0.0);
        if (c > 0) wtv(d.data(), p.data());
        double f1 = -dot(d.data(), d.data(), n);
        double f2 = -theta * f1;
        const double f2_org = f2;
        if (c > 0) {
            std::vector<double> mp(p);
            ksolve(mp.data());
            f2 -= dot(p.data(), mp.data(), dim);
        }
        if (f1 >= 0.0) return;  // no descent: xcp = x
        double dtm = -f1 / std::max(f2, EPSMCH * std::fabs(f2_org) + 1e-300);
        double t_old = 0.0;
        size_t k = 0;
        std::vector<double> wb(dim), tmp(dim);
        while (k < order.size()) {
            const int b = order[k];
            const double tb = t[b];
            const double delt = tb - t_old;
            if (dtm < delt) break;
            // variable b hits its bound
            const double gb = g[b];
            const double xbcp = (d[b] > 0.0) ? u[b] : l[b];
            const double zb = xbcp - x[b];
            xcp[b] = xbcp;
            for (int j = 0; j < dim; ++j) ccau[j] += delt * p[j];
            if (c > 0) {
                wrow(b, wb.data());
                tmp = ccau; ksolve(tmp.data());
                const double wMc = dot(wb.data(), tmp.data(), dim);
                tmp = p; ksolve(tmp.data());
                const double wMp = dot(wb.data(), tmp.data(), dim);
                tmp = wb; ksolve(tmp.data());
                const double wMw = dot(wb.data(), tmp.data(), dim);
                f1 += delt * f2 + gb * gb + theta * gb * zb - gb * wMc;
                f2 += -theta * gb * gb - 2.0 * gb * wMp - gb * gb * wMw;
                for (int j = 0; j < dim; ++j) p[j] += gb * wb[j];
            } else {
                f1 += delt * f2 + gb * gb + theta * gb * zb;
                f2 += -theta * gb * gb;
            }
            f2 = std::max(f2, EPSMCH * std::fabs(f2_org) + 1e-300);
            d[b] = 0.0;
            dtm = -f1 / f2;
            t_old = tb;
            ++k;
            if (f1 >= 0.0) { dtm = 0.0; break; }
        }
        dtm = std::max(dtm, 0.0);
        cauchy_intervals = static_cast<int>(k) + 1;
        cauchy_intervals_total += cauchy_intervals;
        const double t_final = t_old + dtm;
        for (int i = 0; i < n; ++i)
            if (t[i] >= t_final && d[i] != 0.0) xcp[i] = x[i] + t_final * d[i];
        for (int i = 0; i < n; ++i) xcp[i] = proj(xcp[i], i);
        for (int j = 0; j < dim; ++j) ccau[j] += dtm * p[j];
    }

    // ---- subspace minimization (direct primal method, sec. 5.1)
    // On return, d holds the full search direction (xbar - x).
    void subspace(const double* x, const double* g) {
        const int c = ncorr, dim = 2 * c;
        std::vector<int> free;
        free.reserve(n);
        for (int i = 0; i < n; ++i) {
            bool at_lower = (nbd[i] == 1 || nbd[i] == 2) &&
                            std::fabs(xcp[i] - l[i]) < 1e-300;
            bool at_upper = (nbd[i] == 2 || nbd[i] == 3) &&
                            std::fabs(xcp[i] - u[i]) < 1e-300;
            if (!at_lower && !at_upper) free.push_back(i);
        }
        const int nf = (int)free.size();
        n_free = nf;
        // search direction starts as xcp - x
        for (int i = 0; i < n; ++i) d[i] = xcp[i] - x[i];
        if (nf == 0) return;

        // reduced gradient of the quadratic model at xcp:
        //   r = g + theta*(xcp - x) - W K^{-1} c
        std::vector<double> mc(ccau);
        ksolve(mc.data());
        std::vector<double> rhat(nf);
        std::vector<double> wb(dim);
        for (int a = 0; a < nf; ++a) {
            const int i = free[a];
            double wMc = 0.0;
            if (c > 0) {
                wrow(i, wb.data());
                wMc = dot(wb.data(), mc.data(), dim);
            }
            rhat[a] = g[i] + theta * (xcp[i] - x[i]) - wMc;
        }

        std::vector<double> du(nf);
        if (c == 0) {
            for (int a = 0; a < nf; ++a) du[a] = -rhat[a] / theta;
        } else {
            // v1 = W_F' rhat
            std::vector<double> v1(dim, 0.0);
            std::vector<double> WF((size_t)nf * dim);
            for (int a = 0; a < nf; ++a) wrow(free[a], &WF[(size_t)a * dim]);
            for (int a = 0; a < nf; ++a)
                for (int j = 0; j < dim; ++j) v1[j] += WF[(size_t)a * dim + j] * rhat[a];
            std::vector<double> v2(v1);
            ksolve(v2.data());
            // E = W_F' W_F (dim x dim)
            std::vector<double> E((size_t)dim * dim, 0.0);
            for (int a = 0; a < nf; ++a) {
                const double* w = &WF[(size_t)a * dim];
                for (int j = 0; j < dim; ++j)
                    for (int jj = 0; jj < dim; ++jj)
                        E[(size_t)j * dim + jj] += w[j] * w[jj];
            }
            // N = I - (1/theta) K^{-1} E ; solve N w = v2
            std::vector<double> Nmat((size_t)dim * dim, 0.0);
            // compute K^{-1} E column-by-column
            std::vector<double> col(dim);
            for (int jj = 0; jj < dim; ++jj) {
                for (int j = 0; j < dim; ++j) col[j] = E[(size_t)j * dim + jj];
                ksolve(col.data());
                for (int j = 0; j < dim; ++j)
                    Nmat[(size_t)j * dim + jj] =
                        (j == jj ? 1.0 : 0.0) - col[j] / theta;
            }
            LU nlu;
            nlu.factor(Nmat, dim);
            std::vector<double> w(v2);
            if (nlu.ok) nlu.solve(w.data());
            dbg_w = w; dbg_v1 = v1; dbg_v2 = v2; dbg_N = Nmat;
            // du = -( rhat/theta + W_F w / theta^2 )
            for (int a = 0; a < nf; ++a) {
                double wfw = dot(&WF[(size_t)a * dim], w.data(), dim);
                du[a] = -(rhat[a] / theta + wfw / (theta * theta));
            }
        }
        dbg_r.assign(n, 0.0); dbg_du.assign(n, 0.0);
        for (int a = 0; a < nf; ++a) { dbg_r[free[a]] = rhat[a]; dbg_du[free[a]] = du[a]; }
        // backtrack into the box: alpha* = max feasible alpha in (0, 1]
        double alpha = 1.0;
        for (int a = 0; a < nf; ++a) {
            const int i = free[a];
            const double dk = du[a];
            if (dk < 0.0 && (nbd[i] == 1 || nbd[i] == 2)) {
                const double room = l[i] - xcp[i];
                if (dk < room) alpha = std::min(alpha, room / dk);
            } else if (dk > 0.0 && (nbd[i] == 2 || nbd[i] == 3)) {
                const double room = u[i] - xcp[i];
                if (dk > room) alpha = std::min(alpha, room / dk);
            }
        }
        for (int a = 0; a < nf; ++a) {
            const int i = free[a];
            d[i] = (xcp[i] + alpha * du[a]) - x[i];
        }
    }

    double max_feasible_step(const double* x) const {
        double stpmx = BIG;
        for (int i = 0; i < n; ++i) {
            const double a1 = d[i];
            if (a1 < 0.0 && (nbd[i] == 1 || nbd[i] == 2)) {
                const double a2 = l[i] - x[i];
                if (a2 >= 0.0) return 0.0;
                stpmx = std::min(stpmx, a2 / a1);
            } else if (a1 > 0.0 && (nbd[i] == 2 || nbd[i] == 3)) {
                const double a2 = u[i] - x[i];
                if (a2 <= 0.0) return 0.0;
                stpmx = std::min(stpmx, a2 / a1);
            }
        }
        return stpmx;
    }

    void start_linesearch(double* x, double f, const double* g) {
        x_start.assign(x, x + n);
        g_start.assign(g, g + n);
        f_start = f;
        dnorm = std::sqrt(dot(d.data(), d.data(), n));
        stpmax_ls = max_feasible_step(x);
        double g0 = dot(g, d.data(), n);
        if (g0 >= 0.0 || dnorm == 0.0) {
            if (std::getenv("LBFGSB_DEBUG"))
                std::fprintf(stderr, "RESET: fallback g0=%.3g dnorm=%.3g\n", g0, dnorm);
            // fall back to projected steepest descent; the stored columns
            // must be cleared along with ncorr or later push_backs would be
            // misindexed against stale pairs
            ncorr = 0;
            Scols.clear();
            Ycols.clear();
            theta = 1.0;
            for (int i = 0; i < n; ++i) d[i] = proj(x[i] - g[i], i) - x[i];
            dnorm = std::sqrt(dot(d.data(), d.data(), n));
            stpmax_ls = max_feasible_step(x);
            g0 = dot(g, d.data(), n);
        }
        stp = (iter == 0) ? std::min(1.0 / std::max(dnorm, 1e-300), stpmax_ls)
                          : std::min(1.0, stpmax_ls);
        ls.stpmax = std::max(stpmax_ls, 1e-300);
        ls.stpmin = 0.0;
        ls.start(f, g0, stp);
        ls_evals = 0;
    }
};

// ---------------------------------------------------------------------------
// C API
// ---------------------------------------------------------------------------
extern "C" {

LbfgsbState* lbfgsb_create(int n, int m) {
    auto* st = new LbfgsbState();
    st->n = n;
    st->m = std::max(1, m);
    st->l.assign(n, 0.0);
    st->u.assign(n, 0.0);
    st->nbd.assign(n, 0);
    st->d.assign(n, 0.0);
    st->xcp.assign(n, 0.0);
    return st;
}

void lbfgsb_destroy(LbfgsbState* st) { delete st; }

void lbfgsb_set_bounds(LbfgsbState* st, const double* lower,
                       const double* upper, const int* nbd) {
    std::memcpy(st->l.data(), lower, st->n * sizeof(double));
    std::memcpy(st->u.data(), upper, st->n * sizeof(double));
    std::memcpy(st->nbd.data(), nbd, st->n * sizeof(int));
}

// Task codes: 0=FG (evaluate), 1=NEW_X, 2=CONVERGENCE, 3=STOP/ERROR
int lbfgsb_step(LbfgsbState* st, double* x, double f, const double* g,
                double factr, double pgtol) {
    const int n = st->n;
    const double tol = factr * EPSMCH;

    switch (st->phase) {
    case 0: {  // START: validate + project x into bounds, request first FG
        for (int i = 0; i < n; ++i) {
            if (st->nbd[i] == 2 && st->l[i] > st->u[i]) {
                st->msg = "ERROR: NO FEASIBLE SOLUTION";
                st->phase = 9;
                return 3;
            }
            x[i] = st->proj(x[i], i);
        }
        st->phase = 1;
        st->msg = "FG_START";
        return 0;
    }
    case 1: {  // EVAL0: first f,g available
        st->f_cur = f;
        st->sbgnrm = st->projgrad_norm(x, g);
        if (st->sbgnrm <= pgtol) {
            st->msg = "CONVERGENCE: NORM_OF_PROJECTED_GRADIENT_<=_PGTOL";
            st->phase = 9;
            return 2;
        }
        st->ls_retried = false;
        st->cauchy(x, g);
        st->subspace(x, g);
        st->start_linesearch(x, f, g);
        if (st->ls.status.rfind("ERROR", 0) == 0) {
            st->msg = "ABNORMAL_TERMINATION_IN_LNSRCH";
            st->phase = 9;
            return 3;
        }
        for (int i = 0; i < n; ++i) x[i] = st->x_start[i] + st->stp * st->d[i];
        st->phase = 2;
        st->msg = "FG_LNSRCH";
        return 0;
    }
    case 2: {  // LNSRCH: f,g at x = x_start + stp*d
        st->f_cur = f;
        const double gd = dot(g, st->d.data(), n);
        if (std::getenv("LBFGSB_DEBUG"))
            std::fprintf(stderr,
                "lnsrch: stp=%.6g f=%.12g gd=%.6g finit=%.12g ginit=%.6g\n",
                st->stp, f, gd, st->ls.finit, st->ls.ginit);
        st->ls.iterate(st->stp, f, gd);
        if (std::getenv("LBFGSB_DEBUG"))
            std::fprintf(stderr, "  -> status=%s stp=%.6g brackt=%d stage=%d\n",
                st->ls.status.c_str(), st->stp, (int)st->ls.brackt, st->ls.stage);
        ++st->ls_evals;
        // Fortran lnsrlb: dcsrch 'CONV' *and* 'WARN' both complete the line
        // search successfully (WARN covers hitting stpmax at an active
        // bound); only dcsrch errors or >= 20 evaluations are failures.
        const bool ls_failed = st->ls_evals >= 20 ||
                               st->ls.status.rfind("ERROR", 0) == 0;
        if (st->ls.status == "FG" && !ls_failed) {
            for (int i = 0; i < n; ++i)
                x[i] = st->x_start[i] + st->stp * st->d[i];
            st->msg = "FG_LNSRCH";
            return 0;
        }
        if (ls_failed) {
            // Fortran mainlb: on line-search failure, discard the memory and
            // retry the iteration with a steepest-descent direction; only a
            // second failure is abnormal.
            if (!st->ls_retried && st->ncorr > 0) {
                if (std::getenv("LBFGSB_DEBUG"))
                    std::fprintf(stderr, "RESET: ls failure retry (status=%s evals=%d)\n",
                                 st->ls.status.c_str(), st->ls_evals);
                st->ls_retried = true;
                st->ncorr = 0;
                st->theta = 1.0;
                st->Scols.clear();
                st->Ycols.clear();
                std::memcpy(x, st->x_start.data(), n * sizeof(double));
                st->cauchy(x, st->g_start.data());
                st->subspace(x, st->g_start.data());
                const int save_iter = st->iter;
                st->iter = 0;  // use the iteration-0 step-length heuristic
                st->start_linesearch(x, st->f_start, st->g_start.data());
                st->iter = save_iter;
                if (st->ls.status.rfind("ERROR", 0) != 0) {
                    for (int i = 0; i < n; ++i)
                        x[i] = st->x_start[i] + st->stp * st->d[i];
                    st->msg = "FG_LNSRCH";
                    return 0;
                }
            }
            st->msg = "ABNORMAL_TERMINATION_IN_LNSRCH";
            st->phase = 9;
            return 3;
        }
        // CONV / WARN: accept the iterate.  x already holds the last
        // evaluated trial point (matching f and g) — only re-project.
        for (int i = 0; i < n; ++i) x[i] = st->proj(x[i], i);
        st->iter += 1;
        st->phase = 3;
        st->msg = "NEW_X";
        return 1;
    }
    case 3: {  // AFTER_NEWX: convergence tests, memory update, next iter
        // (x may have been mutated by a callback; honored like the Fortran
        // reverse-communication protocol.)
        st->sbgnrm = st->projgrad_norm(x, g);
        if (st->sbgnrm <= pgtol) {
            st->msg = "CONVERGENCE: NORM_OF_PROJECTED_GRADIENT_<=_PGTOL";
            st->phase = 9;
            return 2;
        }
        const double ddum =
            std::max({std::fabs(st->f_start), std::fabs(f), 1.0});
        if (st->f_start - f <= tol * ddum) {
            st->msg = "CONVERGENCE: REL_REDUCTION_OF_F_<=_FACTR*EPSMCH";
            st->phase = 9;
            return 2;
        }
        // correction pair
        std::vector<double> s(n), yv(n);
        for (int i = 0; i < n; ++i) {
            s[i] = x[i] - st->x_start[i];
            yv[i] = g[i] - st->g_start[i];
        }
        const double sy = dot(s.data(), yv.data(), n);
        // Fortran mainlb curvature acceptance: dr > epsmch * ddum with
        // ddum = -gdold*stp (the directional-derivative scale).  This
        // rejects weak-curvature pairs that would make B near-singular.
        const double yy = dot(yv.data(), yv.data(), n);
        const double dd_scale = -st->ls.ginit * st->stp;
        const bool accept = sy > EPSMCH * dd_scale;
        if (std::getenv("LBFGSB_DEBUG"))
            std::fprintf(stderr, "pair: sy=%.3g scale=%.3g accept=%d\n", sy, dd_scale, (int)accept);
        if (accept) {
            if (st->ncorr == st->m) {
                st->Scols.erase(st->Scols.begin());
                st->Ycols.erase(st->Ycols.begin());
                --st->ncorr;
            }
            st->Scols.push_back(std::move(s));
            st->Ycols.push_back(std::move(yv));
            ++st->ncorr;
            st->theta = yy / sy;
            st->form_K();
            if (!st->Klu.ok && std::getenv("LBFGSB_DEBUG"))
                std::fprintf(stderr, "RESET: K singular\n");
            if (!st->Klu.ok) {  // numerically singular: reset memory
                st->Scols.clear();
                st->Ycols.clear();
                st->ncorr = 0;
                st->theta = 1.0;
            }
        } else {
            ++st->skipped_updates;
        }
        // next iteration
        st->ls_retried = false;
        st->cauchy(x, g);
        st->subspace(x, g);
        st->start_linesearch(x, f, g);
        if (st->ls.status.rfind("ERROR", 0) == 0) {
            st->msg = "ABNORMAL_TERMINATION_IN_LNSRCH";
            st->phase = 9;
            return 3;
        }
        for (int i = 0; i < n; ++i) x[i] = st->x_start[i] + st->stp * st->d[i];
        st->phase = 2;
        st->msg = "FG_LNSRCH";
        return 0;
    }
    default:
        return 3;
    }
}

const char* lbfgsb_task_msg(LbfgsbState* st) { return st->msg.c_str(); }

double lbfgsb_step_width(LbfgsbState* st) { return st->stp; }

void lbfgsb_search_direction(LbfgsbState* st, double* out) {
    std::memcpy(out, st->d.data(), st->n * sizeof(double));
}

int lbfgsb_n_iter(LbfgsbState* st) { return st->iter; }

// Annotated trace info (the reference's isave/dsave dump analog,
// ext/GRAPELBFGSBExt.jl:150-192).  Fills `out` (13 doubles):
// [0] iter                    [7] |proj g|_inf (sbgnrm)
// [1] ncorr (stored pairs)    [8] line-search f/g evals this iter
// [2] theta (B0 scale)        [9] free variables at the Cauchy point
// [3] f at iteration start    [10] active bound constraints
// [4] |d|_2 search direction  [11] Cauchy intervals, current iter
// [5] step length (relative)  [12] Cauchy intervals, total
// [6] skipped BFGS updates
void lbfgsb_trace_info(LbfgsbState* st, double* out) {
    out[0] = st->iter;
    out[1] = st->ncorr;
    out[2] = st->theta;
    out[3] = st->f_start;
    out[4] = st->dnorm;
    out[5] = st->stp;
    out[6] = st->skipped_updates;
    out[7] = st->sbgnrm;
    out[8] = st->ls_evals;
    out[9] = st->n_free;
    out[10] = st->n - st->n_free;
    out[11] = st->cauchy_intervals;
    out[12] = st->cauchy_intervals_total;
}

double lbfgsb_projgrad_norm(LbfgsbState* st) { return st->sbgnrm; }

// Test hook: compute the Cauchy point and search direction for a given
// state (x, g, correction pairs) without running the task loop.
void lbfgsb_test_direction(LbfgsbState* st, const double* x, const double* g,
                           const double* Spairs, const double* Ypairs,
                           int ncorr, double theta, double* d_out,
                           double* xcp_out) {
    st->ncorr = ncorr;
    st->theta = theta;
    st->Scols.clear();
    st->Ycols.clear();
    for (int j = 0; j < ncorr; ++j) {
        st->Scols.emplace_back(Spairs + (size_t)j * st->n,
                               Spairs + (size_t)(j + 1) * st->n);
        st->Ycols.emplace_back(Ypairs + (size_t)j * st->n,
                               Ypairs + (size_t)(j + 1) * st->n);
    }
    if (ncorr > 0) st->form_K();
    st->cauchy(x, g);
    st->subspace(x, g);
    std::memcpy(d_out, st->d.data(), st->n * sizeof(double));
    std::memcpy(xcp_out, st->xcp.data(), st->n * sizeof(double));
}

// Debug introspection: export the limited-memory state.
int lbfgsb_debug_ncorr(LbfgsbState* st) { return st->ncorr; }
void lbfgsb_debug_small(LbfgsbState* st, double* w, double* v1, double* v2,
                        double* Nm) {
    std::memcpy(w, st->dbg_w.data(), st->dbg_w.size() * sizeof(double));
    std::memcpy(v1, st->dbg_v1.data(), st->dbg_v1.size() * sizeof(double));
    std::memcpy(v2, st->dbg_v2.data(), st->dbg_v2.size() * sizeof(double));
    std::memcpy(Nm, st->dbg_N.data(), st->dbg_N.size() * sizeof(double));
}
void lbfgsb_debug_r(LbfgsbState* st, double* out) {
    std::memcpy(out, st->dbg_r.data(), st->n * sizeof(double));
}
void lbfgsb_debug_du(LbfgsbState* st, double* out) {
    std::memcpy(out, st->dbg_du.data(), st->n * sizeof(double));
}
void lbfgsb_debug_xcp(LbfgsbState* st, double* out) {
    std::memcpy(out, st->xcp.data(), st->n * sizeof(double));
}
void lbfgsb_debug_xstart(LbfgsbState* st, double* out) {
    std::memcpy(out, st->x_start.data(), st->n * sizeof(double));
}
double lbfgsb_debug_theta(LbfgsbState* st) { return st->theta; }
void lbfgsb_debug_pairs(LbfgsbState* st, double* S_out, double* Y_out) {
    for (int j = 0; j < st->ncorr; ++j) {
        std::memcpy(S_out + (size_t)j * st->n, st->Scols[j].data(),
                    st->n * sizeof(double));
        std::memcpy(Y_out + (size_t)j * st->n, st->Ycols[j].data(),
                    st->n * sizeof(double));
    }
}

}  // extern "C"
