// Native host-side spatial/sparse kernels for gprf_tpu.
//
// Replacement for the reference's external C++ dependencies:
//   * treegp cover-tree fixed-radius queries
//     (VectorTree.sparse_training_kernel_matrix, reference gprf.py:407,
//     synthetic.py:125) -> kd-tree range pair enumeration (range_pairs)
//   * CHOLMOD sparse Cholesky (scikits.sparse.cholmod, reference
//     gprf.py:420-438, synthetic.py:130-135) -> reverse-Cuthill-McKee
//     ordering (rcm_order) + up-looking simplicial sparse Cholesky with
//     elimination-tree reach (sparse_chol_*), plus triangular solves and
//     log-determinant.
//
// Exposed as a flat C ABI consumed via ctypes (no pybind11 in this image).
// Build: csrc/Makefile -> build/libgprf_native.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <queue>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// kd-tree fixed-radius pair enumeration
// ---------------------------------------------------------------------------

namespace {

struct KDTree {
  // implicit median-split kd-tree over points stored in a permutation array
  const double* pts;  // [n, dim] row-major
  int n, dim;
  std::vector<int> perm;
  struct Node {
    int lo, hi;        // range in perm
    int axis;          // split axis (-1 for leaf)
    double split;      // split coordinate
    int left, right;   // child node ids
    double bmin[3], bmax[3];
  };
  std::vector<Node> nodes;
  static const int LEAF = 16;

  int build(int lo, int hi) {
    Node nd;
    nd.lo = lo;
    nd.hi = hi;
    for (int d = 0; d < dim; d++) {
      double mn = 1e300, mx = -1e300;
      for (int i = lo; i < hi; i++) {
        double v = pts[perm[i] * dim + d];
        mn = std::min(mn, v);
        mx = std::max(mx, v);
      }
      nd.bmin[d] = mn;
      nd.bmax[d] = mx;
    }
    int id = (int)nodes.size();
    nodes.push_back(nd);
    if (hi - lo <= LEAF) {
      nodes[id].axis = -1;
      nodes[id].left = nodes[id].right = -1;
      return id;
    }
    // widest axis
    int axis = 0;
    double wbest = -1;
    for (int d = 0; d < dim; d++) {
      double w = nd.bmax[d] - nd.bmin[d];
      if (w > wbest) {
        wbest = w;
        axis = d;
      }
    }
    int mid = (lo + hi) / 2;
    std::nth_element(perm.begin() + lo, perm.begin() + mid, perm.begin() + hi,
                     [&](int a, int b) { return pts[a * dim + axis] < pts[b * dim + axis]; });
    nodes[id].axis = axis;
    nodes[id].split = pts[perm[mid] * dim + axis];
    int l = build(lo, mid);
    int r = build(mid, hi);
    nodes[id].left = l;
    nodes[id].right = r;
    return id;
  }

  void init(const double* p, int n_, int dim_) {
    pts = p;
    n = n_;
    dim = dim_;
    perm.resize(n);
    for (int i = 0; i < n; i++) perm[i] = i;
    nodes.reserve(2 * n / LEAF + 4);
    if (n > 0) build(0, n);
  }

  double dist2_to_box(const Node& nd, const double* q) const {
    double d2 = 0;
    for (int d = 0; d < dim; d++) {
      double v = q[d];
      if (v < nd.bmin[d]) {
        double t = nd.bmin[d] - v;
        d2 += t * t;
      } else if (v > nd.bmax[d]) {
        double t = v - nd.bmax[d];
        d2 += t * t;
      }
    }
    return d2;
  }

  // collect all j with ||x_j - q|| <= r (euclidean in the stored coords)
  void query(const double* q, double r, std::vector<int>& out) const {
    double r2 = r * r;
    std::vector<int> stack;
    stack.push_back(0);
    while (!stack.empty()) {
      int id = stack.back();
      stack.pop_back();
      const Node& nd = nodes[id];
      if (dist2_to_box(nd, q) > r2) continue;
      if (nd.axis < 0) {
        for (int i = nd.lo; i < nd.hi; i++) {
          int j = perm[i];
          double d2 = 0;
          for (int d = 0; d < dim; d++) {
            double t = pts[j * dim + d] - q[d];
            d2 += t * t;
          }
          if (d2 <= r2) out.push_back(j);
        }
      } else {
        stack.push_back(nd.left);
        stack.push_back(nd.right);
      }
    }
  }
};

}  // namespace

// Enumerate pairs (i, j) with i >= j and euclidean distance <= radius.
// Two-phase contract so the caller can allocate exactly: pass rows=nullptr
// to count, then call again with buffers of that size.
// Returns the number of pairs (or -1 on overflow of the caller's buffer).
int64_t range_pairs(const double* pts, int n, int dim, double radius,
                    int32_t* rows, int32_t* cols, int64_t cap) {
  if (dim < 1 || dim > 3) return -2;
  KDTree tree;
  tree.init(pts, n, dim);
  int64_t count = 0;
  std::vector<int> hits;
  for (int i = 0; i < n; i++) {
    hits.clear();
    tree.query(pts + (size_t)i * dim, radius, hits);
    for (int j : hits) {
      if (j > i) continue;  // emit lower triangle incl. diagonal
      if (rows != nullptr) {
        if (count >= cap) return -1;
        rows[count] = i;
        cols[count] = j;
      }
      count++;
    }
  }
  return count;
}

// ---------------------------------------------------------------------------
// Reverse Cuthill-McKee ordering on a symmetric pattern (CSC/CSR identical)
// ---------------------------------------------------------------------------

// colptr/rowidx describe the full symmetric pattern (both triangles).
// Writes perm such that new_label = position in perm (perm[k] = old index).
void rcm_order(int n, const int64_t* colptr, const int32_t* rowidx, int32_t* perm) {
  std::vector<int> degree(n), order;
  order.reserve(n);
  for (int i = 0; i < n; i++) degree[i] = (int)(colptr[i + 1] - colptr[i]);
  std::vector<char> visited(n, 0);
  std::vector<int> cand;
  for (int start = 0; start < n; start++) {
    if (visited[start]) continue;
    // find min-degree unvisited node in this component's seed position
    int seed = start;
    for (int i = start; i < n; i++)
      if (!visited[i] && degree[i] < degree[seed]) seed = i;
    std::queue<int> q;
    q.push(seed);
    visited[seed] = 1;
    while (!q.empty()) {
      int u = q.front();
      q.pop();
      order.push_back(u);
      cand.clear();
      for (int64_t p = colptr[u]; p < colptr[u + 1]; p++) {
        int v = rowidx[p];
        if (!visited[v]) {
          visited[v] = 1;
          cand.push_back(v);
        }
      }
      std::sort(cand.begin(), cand.end(),
                [&](int a, int b) { return degree[a] < degree[b]; });
      for (int v : cand) q.push(v);
    }
  }
  // reverse
  for (int i = 0; i < n; i++) perm[i] = order[n - 1 - i];
}

// ---------------------------------------------------------------------------
// Up-looking simplicial sparse Cholesky
// ---------------------------------------------------------------------------

namespace {

struct CholFactor {
  int n = 0;
  std::vector<int64_t> Lp;   // column pointers [n+1]
  std::vector<int32_t> Li;   // row indices (per column, ascending)
  std::vector<double> Lx;    // values
  double logdet = 0.0;
  bool ok = false;
};

// Factor A (SPD, given as CSC of the *lower* triangle incl. diagonal,
// row indices ascending within each column) into L L^T.
// Classic up-looking algorithm with elimination-tree reach (after
// T. Davis, "Direct Methods for Sparse Linear Systems", re-derived here).
bool chol_uplooking(int n, const int64_t* Ap, const int32_t* Ai, const double* Ax,
                    CholFactor& F) {
  // access pattern: we need row k of the lower triangle = column k of the
  // upper triangle. Build CSR of the lower triangle (rows) first.
  std::vector<int64_t> Rp(n + 1, 0);
  int64_t nzA = Ap[n];
  for (int64_t p = 0; p < nzA; p++) Rp[Ai[p] + 1]++;
  for (int i = 0; i < n; i++) Rp[i + 1] += Rp[i];
  std::vector<int32_t> Rj(nzA);
  std::vector<double> Rx(nzA);
  {
    std::vector<int64_t> w(Rp.begin(), Rp.end() - 1);
    for (int j = 0; j < n; j++)
      for (int64_t p = Ap[j]; p < Ap[j + 1]; p++) {
        int i = Ai[p];
        int64_t q = w[i]++;
        Rj[q] = j;  // column (<= i)
        Rx[q] = Ax[p];
      }
  }

  F.n = n;
  // L stored by *rows* during construction (row k has pattern = ereach(k)),
  // but we also need column access for the sparse triangular solve.
  // Use per-column dynamic arrays: Lcols[j] = list of (row, value).
  std::vector<std::vector<int32_t>> Lci(n);
  std::vector<std::vector<double>> Lcx(n);
  std::vector<double> diag(n, 0.0);
  std::vector<int32_t> parent(n, -1);
  std::vector<int32_t> flag(n, -1);
  std::vector<int32_t> pattern(n);
  std::vector<double> x(n, 0.0);
  F.logdet = 0.0;

  for (int k = 0; k < n; k++) {
    // ----- ereach: pattern of row k of L --------------------------------
    int top = n;
    flag[k] = k;
    double akk = 0.0;
    for (int64_t p = Rp[k]; p < Rp[k + 1]; p++) {
      int j = Rj[p];  // column index j <= k in row k of A's lower triangle
      if (j == k) {
        akk = Rx[p];
        continue;
      }
      x[j] = Rx[p];
      // walk up the etree from j until hitting a flagged node
      int len = 0;
      std::vector<int32_t>& pat = pattern;
      int32_t pathbuf[64];
      std::vector<int32_t> longpath;
      int ji = j;
      while (flag[ji] != k) {
        flag[ji] = k;
        if (len < 64)
          pathbuf[len++] = ji;
        else
          longpath.push_back(ji);
        ji = parent[ji];
        if (ji == -1) break;  // shouldn't happen before k, but be safe
        if (ji >= k) break;
      }
      // push path onto pattern stack in reverse (topological) order
      for (int t = (int)longpath.size() - 1; t >= 0; t--) pat[--top] = longpath[t];
      for (int t = len - 1; t >= 0; t--) pat[--top] = pathbuf[t];
    }
    // pattern[top..n-1] holds the row pattern in topological order
    // ----- sparse triangular solve L[0:k,0:k] y = A[0:k,k] --------------
    double dk = akk;
    for (int t = top; t < n; t++) {
      int j = pattern[t];
      double xj = x[j];
      // x[i] -= L(i,j) * xj for i in col j below j (only those in pattern
      // or future: we subtract into x for all stored entries with row < k,
      // and accumulate the row-k entry)
      const std::vector<int32_t>& ci = Lci[j];
      const std::vector<double>& cx = Lcx[j];
      double lkj = xj / diag[j];
      for (size_t p = 0; p < ci.size(); p++) {
        int i = ci[p];
        if (i < k)
          x[i] -= cx[p] * lkj * 1.0;  // note: cx holds L(i,j); see below
        else if (i == k)
          ;  // handled via x[j] path
      }
      x[j] = lkj;
      dk -= lkj * lkj;
      // update x entries: for rows i>j in column j pattern with i<k
      // (the loop above already did x[i] -= L(i,j)*lkj)
      // set parent in etree
      if (parent[j] == -1 && j < k) parent[j] = k;
    }
    if (dk <= 0.0) {
      F.ok = false;
      return false;
    }
    double lkk = std::sqrt(dk);
    diag[k] = lkk;
    F.logdet += 2.0 * std::log(lkk);
    // store row k entries into column structures: L(k, j) = x[j]
    for (int t = top; t < n; t++) {
      int j = pattern[t];
      Lci[j].push_back(k);
      Lcx[j].push_back(x[j]);
      x[j] = 0.0;
    }
    // clear any scatter residue (x entries outside pattern were only set
    // for pattern members, so nothing else to clear)
  }

  // assemble CSC with diagonal first in each column
  F.Lp.assign(n + 1, 0);
  for (int j = 0; j < n; j++) F.Lp[j + 1] = F.Lp[j] + 1 + (int64_t)Lci[j].size();
  F.Li.resize(F.Lp[n]);
  F.Lx.resize(F.Lp[n]);
  for (int j = 0; j < n; j++) {
    int64_t p = F.Lp[j];
    F.Li[p] = j;
    F.Lx[p] = diag[j];
    p++;
    for (size_t t = 0; t < Lci[j].size(); t++, p++) {
      F.Li[p] = Lci[j][t];
      F.Lx[p] = Lcx[j][t];
    }
  }
  F.ok = true;
  return true;
}

}  // namespace

// Opaque-handle API ---------------------------------------------------------

void* sparse_chol_factor(int n, const int64_t* Ap, const int32_t* Ai, const double* Ax) {
  CholFactor* F = new CholFactor();
  if (!chol_uplooking(n, Ap, Ai, Ax, *F)) {
    delete F;
    return nullptr;
  }
  return (void*)F;
}

double sparse_chol_logdet(void* handle) {
  return ((CholFactor*)handle)->logdet;
}

int64_t sparse_chol_nnz(void* handle) { return ((CholFactor*)handle)->Lp.back(); }

// Export L in CSC (diag-first within column as stored).
void sparse_chol_export(void* handle, int64_t* Lp, int32_t* Li, double* Lx) {
  CholFactor* F = (CholFactor*)handle;
  std::memcpy(Lp, F->Lp.data(), sizeof(int64_t) * (F->n + 1));
  std::memcpy(Li, F->Li.data(), sizeof(int32_t) * F->Lp.back());
  std::memcpy(Lx, F->Lx.data(), sizeof(double) * F->Lp.back());
}

// Solve A x = b for nrhs right-hand sides: L z = b, L^T x = z. In-place on b.
void sparse_chol_solve(void* handle, double* b, int nrhs) {
  CholFactor* F = (CholFactor*)handle;
  int n = F->n;
  for (int r = 0; r < nrhs; r++) {
    double* v = b + (size_t)r * n;
    // forward: columns ascending
    for (int j = 0; j < n; j++) {
      int64_t p0 = F->Lp[j];
      double zj = v[j] / F->Lx[p0];
      v[j] = zj;
      for (int64_t p = p0 + 1; p < F->Lp[j + 1]; p++) v[F->Li[p]] -= F->Lx[p] * zj;
    }
    // backward: columns descending (L^T x = z)
    for (int j = n - 1; j >= 0; j--) {
      int64_t p0 = F->Lp[j];
      double s = v[j];
      for (int64_t p = p0 + 1; p < F->Lp[j + 1]; p++) s -= F->Lx[p] * v[F->Li[p]];
      v[j] = s / F->Lx[p0];
    }
  }
}

// y = L z (for prior sampling). z: [n, nrhs] column-major per rhs. In place.
void sparse_chol_lmult(void* handle, double* z, int nrhs) {
  CholFactor* F = (CholFactor*)handle;
  int n = F->n;
  std::vector<double> out(n);
  for (int r = 0; r < nrhs; r++) {
    double* v = z + (size_t)r * n;
    std::fill(out.begin(), out.end(), 0.0);
    for (int j = 0; j < n; j++) {
      double zj = v[j];
      for (int64_t p = F->Lp[j]; p < F->Lp[j + 1]; p++) out[F->Li[p]] += F->Lx[p] * zj;
    }
    std::memcpy(v, out.data(), sizeof(double) * n);
  }
}

// Selected inverse (Takahashi / Erisman-Tinney): entries of A^-1 on the
// pattern of L, written aligned with the factor's CSC layout (diag-first
// per column).  This is what the reference consumes from CHOLMOD's
// ``factor.inv()`` — every use multiplies the inverse elementwise against
// a sparse matrix sharing K's pattern (gprf.py:452,489), so only the
// pattern subset is ever needed.
//
// With A = L D L1^T (L1 = unit lower triangular, D = diag(L)^2):
//   Z_jj = 1/D_j - sum_{k in col j, k>j} L1_kj Z_kj
//   Z_ij = -sum_{k in col j, k>j} L1_kj Z_(k,i)    (i > j in col j pattern)
// processed for j = n-1 .. 0, rows of each column in descending order.
void sparse_chol_selected_inv(void* handle, double* Zx) {
  CholFactor* F = (CholFactor*)handle;
  int n = F->n;
  const int64_t* Lp = F->Lp.data();
  const int32_t* Li = F->Li.data();
  const double* Lx = F->Lx.data();

  // Z lookup: Z entry at (i, j), i >= j, stored at the factor's position.
  // Columns store diag first then ascending rows -> binary search.
  auto zfind = [&](int i, int j) -> double {
    if (i == j) return Zx[Lp[j]];
    int64_t lo = Lp[j] + 1, hi = Lp[j + 1];
    while (lo < hi) {
      int64_t mid = (lo + hi) / 2;
      if (Li[mid] < i)
        lo = mid + 1;
      else
        hi = mid;
    }
    if (lo < Lp[j + 1] && Li[lo] == i) return Zx[lo];
    return 0.0;  // outside pattern: treated as zero (exact on chol pattern)
  };

  for (int j = n - 1; j >= 0; j--) {
    double dj = Lx[Lp[j]];        // L_jj
    double Dj = dj * dj;
    int64_t p0 = Lp[j], p1 = Lp[j + 1];
    // rows descending: iterate from the end of the column
    for (int64_t p = p1 - 1; p >= p0; p--) {
      int i = Li[p];
      double acc = 0.0;
      for (int64_t q = p0 + 1; q < p1; q++) {
        int k = Li[q];
        double l1 = Lx[q] / dj;  // L1_kj
        double zk;
        if (i == j)
          zk = Zx[q];  // Z_kj currently being filled in this column (k > j)
        else
          zk = (k >= i) ? zfind(k, i) : zfind(i, k);
        acc += l1 * zk;
      }
      if (i == j)
        Zx[p] = 1.0 / Dj - acc;
      else
        Zx[p] = -acc;
    }
  }
}

void sparse_chol_free(void* handle) { delete (CholFactor*)handle; }

}  // extern "C"
