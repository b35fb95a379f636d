// Cyclic (periodic) banded LU solver.
//
// The native direct-solve path of the framework: the role MUMPS
// parallel LU plays in the reference's stage solves (options84 PETSc
// block: -ksp_type preonly -pc_type lu) and the role the ksfdMat
// Cython extension plays in materializing the stencil-structured
// Jacobian (reference cython/ksfdMat/ksfdMat.pyx) — rebuilt for this
// framework as a host-side exact solver for 1D problems, where the
// W-operator (shift*I - J) of the interleaved-dof stencil system is a
// banded matrix with periodic corner blocks.
//
// Algorithm: split A = B + U C V^T where B is the banded core (LAPACK
// band storage, partial-pivot LU implemented here) and the periodic
// corners enter through the rank-r Sherman–Morrison–Woodbury update,
// r = kl + ku.  Factor once, solve many right-hand sides.
//
// C API (all row-major, double):
//   cbanded_factor(n, kl, ku, band, corner_rows, corner_cols, handle*)
//   cbanded_solve(handle, nrhs, b, x)
//   cbanded_free(handle)
// band: LAPACK-style band storage with room for fill-in:
//   ldab = 2*kl + ku + 1 rows, n cols; band[kl+ku+i-j][j] = A[i][j]
//   (the caller fills rows kl..2*kl+ku; the top kl rows are workspace)

#include <cstdlib>
#include <cstring>
#include <cmath>
#include <vector>

namespace {

struct BandLU {
    int n, kl, ku, ldab;
    std::vector<double> ab;   // factored band, ldab x n (col-major by column index)
    std::vector<int> ipiv;
    // SMW data for the periodic corners
    int r = 0;
    std::vector<double> Binv_U;   // n x r
    std::vector<double> Vt;       // r x n (sparse in theory; dense here)
    std::vector<double> S;        // r x r factored (I + V^T Binv_U)
    std::vector<int> Spiv;
};

// ab is stored column-major: entry (row_in_band, col) at ab[col*ldab + row].
inline double& AB(BandLU& f, int band_row, int col) {
    return f.ab[(size_t)col * f.ldab + band_row];
}

// Banded LU with partial pivoting (LAPACK dgbtrf semantics).
// Returns 0 on success, j+1 if pivot j is exactly zero.
int band_lu_factor(BandLU& f) {
    const int n = f.n, kl = f.kl, ku = f.ku;
    const int kv = kl + ku;  // superdiagonals incl. fill-in
    // zero the fill-in workspace rows
    for (int j = 0; j < n; ++j)
        for (int i = 0; i < kl; ++i) AB(f, i, j) = 0.0;
    f.ipiv.resize(n);
    for (int j = 0; j < n; ++j) {
        const int km = std::min(kl, n - 1 - j);  // subdiagonal count
        // find pivot among rows j..j+km (band rows kv..kv+km)
        int piv = 0;
        double amax = std::fabs(AB(f, kv, j));
        for (int i = 1; i <= km; ++i) {
            double a = std::fabs(AB(f, kv + i, j));
            if (a > amax) { amax = a; piv = i; }
        }
        f.ipiv[j] = j + piv;
        if (amax == 0.0) return j + 1;
        const int ju = std::min(j + ku + kl, n - 1);  // last col touched
        if (piv != 0) {
            // swap rows j and j+piv across columns j..ju
            for (int c = j; c <= ju; ++c) {
                const int br1 = kv + j - c;      // band row of row j in col c
                const int br2 = br1 + piv;       // band row of row j+piv
                if (br1 < 0) continue;
                std::swap(AB(f, br1, c), AB(f, br2, c));
            }
        }
        const double pivval = AB(f, kv, j);
        for (int i = 1; i <= km; ++i) {
            const double m = AB(f, kv + i, j) / pivval;
            AB(f, kv + i, j) = m;  // store multiplier
            for (int c = j + 1; c <= ju; ++c) {
                const int br_i = kv + (j + i) - c;
                const int br_j = kv + j - c;
                if (br_j < 0) continue;
                AB(f, br_i, c) -= m * AB(f, br_j, c);
            }
        }
    }
    return 0;
}

// Solve with the factored band, one RHS in place.
void band_lu_solve(const BandLU& f, double* b) {
    const int n = f.n, kl = f.kl, ku = f.ku;
    const int kv = kl + ku;
    BandLU& fm = const_cast<BandLU&>(f);
    // forward: apply pivots and L
    for (int j = 0; j < n; ++j) {
        const int p = f.ipiv[j];
        if (p != j) std::swap(b[j], b[p]);
        const int km = std::min(kl, n - 1 - j);
        for (int i = 1; i <= km; ++i)
            b[j + i] -= AB(fm, kv + i, j) * b[j];
    }
    // back substitution with U (bandwidth kv)
    for (int j = n - 1; j >= 0; --j) {
        const int last = std::min(j + kv, n - 1);
        double s = b[j];
        for (int c = j + 1; c <= last; ++c)
            s -= AB(fm, kv + j - c, c) * b[c];
        b[j] = s / AB(fm, kv, j);
    }
}

// Dense LU with partial pivoting, LAPACK dgetrf semantics: row
// interchanges swap FULL rows (including already-stored L
// multipliers), so the stored L reflects the FINAL row ordering.
// Returns 0 on success, j+1 if pivot j is exactly zero.
int dense_lu_factor(std::vector<double>& A, std::vector<int>& piv, int r) {
    piv.resize(r);
    for (int j = 0; j < r; ++j) {
        int p = j;
        double amax = std::fabs(A[(size_t)j * r + j]);
        for (int i = j + 1; i < r; ++i) {
            double a = std::fabs(A[(size_t)i * r + j]);
            if (a > amax) { amax = a; p = i; }
        }
        piv[j] = p;
        if (p != j)
            for (int c = 0; c < r; ++c)
                std::swap(A[(size_t)j * r + c], A[(size_t)p * r + c]);
        const double pv = A[(size_t)j * r + j];
        if (pv == 0.0) return j + 1;
        for (int i = j + 1; i < r; ++i) {
            const double m = A[(size_t)i * r + j] / pv;
            A[(size_t)i * r + j] = m;
            for (int c = j + 1; c < r; ++c)
                A[(size_t)i * r + c] -= m * A[(size_t)j * r + c];
        }
    }
    return 0;
}

void dense_lu_solve(const std::vector<double>& A, const std::vector<int>& piv,
                    int r, double* b) {
    // Apply ALL row interchanges first (dgetrs/laswp order): the
    // factorization swapped FULL rows, so L's rows are in the final
    // permuted ordering and interleaving pivot application with the
    // forward substitution computes a different (wrong) result
    // whenever the pivot order is nontrivial.  (The BANDED solve
    // above interleaves correctly because dgbtrf-style factorization
    // never swaps stored multipliers.)
    for (int j = 0; j < r; ++j)
        if (piv[j] != j) std::swap(b[j], b[piv[j]]);
    for (int j = 0; j < r; ++j)
        for (int i = j + 1; i < r; ++i) b[i] -= A[(size_t)i * r + j] * b[j];
    for (int j = r - 1; j >= 0; --j) {
        for (int c = j + 1; c < r; ++c) b[j] -= A[(size_t)j * r + c] * b[c];
        b[j] /= A[(size_t)j * r + j];
    }
}

}  // namespace

extern "C" {

// corner_rows: (kl x ku ... ) — we take the corners as two dense blocks:
//   top-right block  T (kl+ku rows? no): see Python wrapper.  We accept
//   the general rank-r update A = B + U * W^T with U (n x r), W (n x r)
//   supplied dense by the caller (r is small: kl+ku).
void* cbanded_factor(int n, int kl, int ku, const double* band,
                     int r, const double* U, const double* W) {
    BandLU* f = new BandLU();
    f->n = n; f->kl = kl; f->ku = ku; f->ldab = 2 * kl + ku + 1;
    f->ab.resize((size_t)f->ldab * n);
    // caller supplies rows kl..2kl+ku (LAPACK layout), column-major cols
    for (int j = 0; j < n; ++j)
        for (int i = 0; i < f->ldab; ++i)
            f->ab[(size_t)j * f->ldab + i] = band[(size_t)j * f->ldab + i];
    if (band_lu_factor(*f) != 0) { delete f; return nullptr; }
    f->r = r;
    if (r > 0) {
        f->Binv_U.assign(U, U + (size_t)n * r);
        // solve B X = U column by column (columns are strided)
        std::vector<double> col(n);
        for (int c = 0; c < r; ++c) {
            for (int i = 0; i < n; ++i) col[i] = U[(size_t)i * r + c];
            band_lu_solve(*f, col.data());
            for (int i = 0; i < n; ++i) f->Binv_U[(size_t)i * r + c] = col[i];
        }
        // S = I + W^T Binv_U  (r x r)
        f->S.assign((size_t)r * r, 0.0);
        for (int a = 0; a < r; ++a)
            for (int c = 0; c < r; ++c) {
                double s = (a == c) ? 1.0 : 0.0;
                for (int i = 0; i < n; ++i)
                    s += W[(size_t)i * r + a] * f->Binv_U[(size_t)i * r + c];
                f->S[(size_t)a * r + c] = s;
            }
        if (dense_lu_factor(f->S, f->Spiv, r) != 0) {
            // singular capacitance matrix: the cyclic matrix itself
            // is singular even though the banded core factored
            delete f;
            return nullptr;
        }
        f->Vt.assign(W, W + (size_t)n * r);
    }
    return f;
}

void cbanded_solve(void* handle, int nrhs, const double* b, double* x) {
    BandLU* f = static_cast<BandLU*>(handle);
    const int n = f->n, r = f->r;
    std::vector<double> y(n), wtb(r);
    for (int k = 0; k < nrhs; ++k) {
        std::memcpy(y.data(), b + (size_t)k * n, n * sizeof(double));
        band_lu_solve(*f, y.data());
        if (r > 0) {
            for (int a = 0; a < r; ++a) {
                double s = 0.0;
                for (int i = 0; i < n; ++i)
                    s += f->Vt[(size_t)i * r + a] * y[i];
                wtb[a] = s;
            }
            dense_lu_solve(f->S, f->Spiv, r, wtb.data());
            for (int i = 0; i < n; ++i) {
                double corr = 0.0;
                for (int a = 0; a < r; ++a)
                    corr += f->Binv_U[(size_t)i * r + a] * wtb[a];
                y[i] -= corr;
            }
        }
        std::memcpy(x + (size_t)k * n, y.data(), n * sizeof(double));
    }
}

void cbanded_free(void* handle) {
    delete static_cast<BandLU*>(handle);
}

}  // extern "C"
