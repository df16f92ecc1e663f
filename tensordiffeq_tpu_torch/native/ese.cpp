// Native ESE maximin-LHS optimizer (tensordiffeq_tpu_torch's own copy of
// the JAX package's native/ese.cpp: the same algorithm and C ABI).
//
// C++ implementation of the Enhanced Stochastic Evolutionary algorithm
// (Jin, Chen & Sudjianto 2005) used for the LHS 'ese' criterion — the
// capability the reference vendors from SMT (reference sampling.py:315-534).
// The annealing loop is O(outer * inner * J * n * nx) scalar work on the
// host; this native version exists because the pure-NumPy fallback in
// ../sampling.py is orders of magnitude slower at large point counts
// (N_f up to 500,000 in the reference's distributed config,
// examples/AC-dist-new.py:14).
//
// Algorithmically identical to sampling._maximin_ese (same proposal scheme,
// acceptance rule and temperature adaptation); RNG streams differ, so
// results are deterministic per seed but not bit-identical across the two
// implementations.
//
// C ABI only (consumed via ctypes — no pybind11 in this image).

#include <cmath>
#include <cstdint>
#include <random>
#include <vector>

namespace {

// Sum of d_ij^-p over all pairs (the "PhiP power sum"); phi = sum^(1/p).
double phi_p_pow_sum(const double* X, int n, int nx, double p) {
    double s = 0.0;
    for (int i = 0; i < n; ++i) {
        const double* xi = X + (std::size_t)i * nx;
        for (int j = i + 1; j < n; ++j) {
            const double* xj = X + (std::size_t)j * nx;
            double d2 = 0.0;
            for (int k = 0; k < nx; ++k) {
                double diff = xi[k] - xj[k];
                d2 += diff * diff;
            }
            s += std::pow(d2, -0.5 * p);
        }
    }
    return s;
}

// Change in the PhiP power sum if rows i1/i2 swapped their column-k values.
// O(n * nx): only distances involving rows i1 and i2 change.
double swap_delta(const double* X, int n, int nx, double p,
                  int k, int i1, int i2) {
    const double* a = X + (std::size_t)i1 * nx;
    const double* b = X + (std::size_t)i2 * nx;
    const double ak_new = b[k], bk_new = a[k];
    double delta = 0.0;
    for (int j = 0; j < n; ++j) {
        if (j == i1 || j == i2) continue;
        const double* xj = X + (std::size_t)j * nx;
        double d2a_old = 0.0, d2b_old = 0.0;
        for (int c = 0; c < nx; ++c) {
            double da = a[c] - xj[c];
            double db = b[c] - xj[c];
            d2a_old += da * da;
            d2b_old += db * db;
        }
        double da_k_old = a[k] - xj[k], db_k_old = b[k] - xj[k];
        double da_k_new = ak_new - xj[k], db_k_new = bk_new - xj[k];
        double d2a_new = d2a_old - da_k_old * da_k_old + da_k_new * da_k_new;
        double d2b_new = d2b_old - db_k_old * db_k_old + db_k_new * db_k_new;
        delta += std::pow(d2a_new, -0.5 * p) - std::pow(d2a_old, -0.5 * p)
               + std::pow(d2b_new, -0.5 * p) - std::pow(d2b_old, -0.5 * p);
    }
    // Distance between i1 and i2 themselves is invariant under the swap
    // (both coordinates exchange, preserving their difference's magnitude).
    return delta;
}

}  // namespace

extern "C" {

double tdq_phi_p(const double* X, int n, int nx, double p) {
    if (n < 2) return 0.0;
    return std::pow(phi_p_pow_sum(X, n, nx, p), 1.0 / p);
}

// In-place ESE optimization of an [n, nx] row-major unit-cube LHS design.
// Returns the best PhiP reached; X holds the best design on exit.
double tdq_ese_optimize(double* X, int n, int nx, double p,
                        int outer_loops, int inner_loops, int J,
                        uint64_t seed) {
    if (n < 3 || nx < 1) return tdq_phi_p(X, n, nx, p);

    std::mt19937_64 rng(seed);
    std::uniform_real_distribution<double> unif(0.0, 1.0);
    std::uniform_int_distribution<int> row(0, n - 1);

    double S = phi_p_pow_sum(X, n, nx, p);        // current power sum
    double phi = std::pow(S, 1.0 / p);
    double phi_best = phi;
    std::vector<double> X_best(X, X + (std::size_t)n * nx);
    double T = 0.005 * phi;

    for (int outer = 0; outer < outer_loops; ++outer) {
        int n_accept = 0, n_improve = 0;
        for (int inner = 0; inner < inner_loops; ++inner) {
            int k = inner % nx;
            // best of J random row-swap proposals in column k
            double best_delta = 0.0, best_phi = 0.0;
            int best_i1 = -1, best_i2 = -1;
            bool have = false;
            for (int t = 0; t < J; ++t) {
                int i1 = row(rng), i2 = row(rng);
                while (i2 == i1) i2 = row(rng);
                double delta = swap_delta(X, n, nx, p, k, i1, i2);
                double S_try = S + delta;
                if (S_try < 0.0) S_try = 0.0;
                double phi_try = std::pow(S_try, 1.0 / p);
                if (!have || phi_try < best_phi) {
                    have = true;
                    best_phi = phi_try;
                    best_delta = delta;
                    best_i1 = i1;
                    best_i2 = i2;
                }
            }
            if (best_phi - phi <= T * unif(rng)) {
                double* r1 = X + (std::size_t)best_i1 * nx;
                double* r2 = X + (std::size_t)best_i2 * nx;
                std::swap(r1[k], r2[k]);
                S += best_delta;
                if (S < 0.0) S = 0.0;
                phi = best_phi;
                ++n_accept;
                if (phi < phi_best) {
                    phi_best = phi;
                    X_best.assign(X, X + (std::size_t)n * nx);
                    ++n_improve;
                }
            }
        }
        // temperature adaptation (Jin et al. section 3.2)
        double acc = (double)n_accept / inner_loops;
        double imp = (double)n_improve / inner_loops;
        if (imp < 0.1) {
            T = (acc > 0.1) ? T * 0.8 : T / 0.7;
        } else {
            T = (acc > imp) ? T * 0.9 : T / 0.9;
        }
    }

    std::copy(X_best.begin(), X_best.end(), X);
    return phi_best;
}

}  // extern "C"
