// Bridson AINV factorizations — native host runtime component.
//
// Rebuild of the reference's host-side factorization loops
// (cusp/precond/detail/ainv.inl: std::map-row outer-product (bi)conjugation
// with drop_tolerance / per-row nnz caps / lin_dropping).  The algorithm is
// inherently sequential, so it belongs in native host code; the resulting
// factors are applied on the device as CSR SpMVs.
//
// C ABI, called from Python via ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <map>
#include <vector>

namespace {

using Row = std::map<int32_t, double>;

void drop(Row& vec, double drop_tol, int row_count, int32_t keep) {
    if (drop_tol > 0) {
        for (auto it = vec.begin(); it != vec.end();) {
            if (it->first != keep && std::fabs(it->second) < drop_tol)
                it = vec.erase(it);
            else
                ++it;
        }
    }
    if (row_count > 0 && (int)vec.size() > row_count) {
        std::vector<std::pair<double, int32_t>> mags;
        mags.reserve(vec.size());
        for (auto& kv : vec) mags.push_back({std::fabs(kv.second), kv.first});
        // place the row_count-th largest magnitude at its sorted position;
        // everything before it is >= cut
        std::nth_element(mags.begin(), mags.begin() + (row_count - 1),
                         mags.end(),
                         [](auto& a, auto& b) { return a.first > b.first; });
        double cut = mags[row_count - 1].first;
        bool has_keep = vec.count(keep) != 0;
        double keep_val = has_keep ? vec[keep] : 0.0;
        Row kept;
        int taken = 0;
        for (auto& kv : vec) {
            if (taken >= row_count) break;
            if (std::fabs(kv.second) >= cut) {
                kept.insert(kv);
                ++taken;
            }
        }
        if (has_keep) kept[keep] = keep_val;
        vec.swap(kept);
    }
}

void axpy_drop(Row& target, double alpha, const Row& source, double drop_tol,
               int row_count, int32_t keep) {
    for (auto& kv : source) target[kv.first] += alpha * kv.second;
    drop(target, drop_tol, row_count, keep);
}

// out = B^T * vec where B is given by CSR rows (combine rows of B).
void matvec_t(const int32_t* indptr, const int32_t* col, const double* val,
              const Row& vec, Row& out) {
    out.clear();
    for (auto& kv : vec) {
        const int32_t j = kv.first;
        const double w = kv.second;
        for (int32_t p = indptr[j]; p < indptr[j + 1]; ++p)
            out[col[p]] += val[p] * w;
    }
}

double dot(const Row& a, const Row& b) {
    // iterate the smaller map
    const Row& s = a.size() <= b.size() ? a : b;
    const Row& l = a.size() <= b.size() ? b : a;
    double acc = 0.0;
    for (auto& kv : s) {
        auto it = l.find(kv.first);
        if (it != l.end()) acc += kv.second * it->second;
    }
    return acc;
}

int row_cap(int nonzero_per_row, int lin_dropping, int lin_param,
            int a_row_nnz) {
    if (lin_dropping) {
        int rc = lin_param + a_row_nnz;
        return rc < 1 ? 1 : rc;
    }
    return nonzero_per_row;
}

// emit columns as COO triplets; returns nnz or -1 if capacity exceeded
int64_t emit(const std::vector<Row>& cols, int32_t* out_row, int32_t* out_col,
             double* out_val, int64_t cap) {
    int64_t k = 0;
    for (int32_t j = 0; j < (int32_t)cols.size(); ++j) {
        for (auto& kv : cols[j]) {
            if (k >= cap) return -1;
            out_row[k] = kv.first;
            out_col[k] = j;
            out_val[k] = kv.second;
            ++k;
        }
    }
    return k;
}

}  // namespace

extern "C" {

// SPD variants. scaled != 0 -> columns scaled by 1/sqrt(p) (M = W W^T),
// else diagonals returned separately (M = W D^-1 W^T).
// Returns W nnz, or -1 if w_cap insufficient.
int64_t ainv_spd(int32_t n, const int32_t* indptr, const int32_t* col,
                 const double* val, double drop_tol, int nonzero_per_row,
                 int lin_dropping, int lin_param, int scaled, int32_t* w_row,
                 int32_t* w_col, double* w_val, int64_t w_cap, double* diag) {
    std::vector<Row> w(n);
    for (int32_t i = 0; i < n; ++i) w[i][i] = 1.0;
    Row u;
    for (int32_t j = 0; j < n; ++j) {
        matvec_t(indptr, col, val, w[j], u);  // A symmetric: A w_j
        double p = dot(w[j], u);
        if (scaled) {
            double s = p != 0 ? 1.0 / std::sqrt(std::fabs(p)) : 1.0;
            for (auto& kv : u) kv.second *= s;
            for (auto& kv : w[j]) kv.second *= s;
            diag[j] = 1.0;
        } else {
            diag[j] = p != 0 ? p : 1.0;
        }
        const double denom = scaled ? 1.0 : diag[j];
        for (auto it = u.upper_bound(j); it != u.end(); ++it) {
            const int32_t i = it->first;
            if (it->second == 0.0) continue;
            int rc = row_cap(nonzero_per_row, lin_dropping, lin_param,
                             indptr[i + 1] - indptr[i]);
            axpy_drop(w[i], -it->second / denom, w[j], drop_tol, rc, i);
        }
    }
    return emit(w, w_row, w_col, w_val, w_cap);
}

// Nonsymmetric biconjugation: factors Z and W with M = Z D^-1 W^T.
// at_* arrays are the CSR of A^T.  Returns -1 on capacity failure; nnz
// counts returned through z_nnz/w_nnz.
int64_t ainv_nonsym(int32_t n, const int32_t* indptr, const int32_t* col,
                    const double* val, const int32_t* at_indptr,
                    const int32_t* at_col, const double* at_val,
                    double drop_tol, int nonzero_per_row, int lin_dropping,
                    int lin_param, int32_t* z_row, int32_t* z_col,
                    double* z_val, int64_t z_cap, int32_t* w_row,
                    int32_t* w_col, double* w_val, int64_t w_cap,
                    double* diag, int64_t* z_nnz, int64_t* w_nnz) {
    std::vector<Row> zf(n), wf(n);
    for (int32_t i = 0; i < n; ++i) {
        zf[i][i] = 1.0;
        wf[i][i] = 1.0;
    }
    Row u, l;
    for (int32_t j = 0; j < n; ++j) {
        matvec_t(at_indptr, at_col, at_val, zf[j], u);  // u = A z_j
        matvec_t(indptr, col, val, wf[j], l);           // l = A^T w_j
        double p = dot(wf[j], u);
        diag[j] = p != 0 ? p : 1.0;
        for (auto it = u.upper_bound(j); it != u.end(); ++it) {
            const int32_t i = it->first;
            if (it->second == 0.0) continue;
            int rc = row_cap(nonzero_per_row, lin_dropping, lin_param,
                             indptr[i + 1] - indptr[i]);
            axpy_drop(zf[i], -it->second / diag[j], zf[j], drop_tol, rc, i);
        }
        for (auto it = l.upper_bound(j); it != l.end(); ++it) {
            const int32_t i = it->first;
            if (it->second == 0.0) continue;
            int rc = row_cap(nonzero_per_row, lin_dropping, lin_param,
                             indptr[i + 1] - indptr[i]);
            axpy_drop(wf[i], -it->second / diag[j], wf[j], drop_tol, rc, i);
        }
    }
    *z_nnz = emit(zf, z_row, z_col, z_val, z_cap);
    *w_nnz = emit(wf, w_row, w_col, w_val, w_cap);
    return (*z_nnz < 0 || *w_nnz < 0) ? -1 : 0;
}

}  // extern "C"
