// Rectangular linear assignment via shortest augmenting paths.
//
// Host-side native matching backend (N5 of SURVEY.md §2.4): the reference
// calls scipy's C++ solver from Python per decoder layer
// (hungarian_assigner_3d.py:117-121).  This is the same algorithm
// (Jonker–Volgenant / Crouse variant, as in scipy's rectangular_lsap),
// exposed with a C ABI for ctypes, plus a batched entry point that solves
// B problems without Python round-trips.
//
// Build: native/__init__.py at first use, through native/Makefile
// (g++ -O3 -shared -fPIC).

#include <cfloat>
#include <cstring>
#include <vector>

namespace {

// Solve min-cost assignment for cost[n_rows][n_cols], n_rows <= n_cols.
// col4row[r] = assigned column for each row.  Returns 0 on success.
int lapjv_internal(const float* cost, int nr, int nc, int* col4row) {
  std::vector<double> u(nr, 0.0), v(nc, 0.0);
  std::vector<double> shortest(nc);
  std::vector<int> path(nc), row4col(nc, -1);
  std::vector<char> sr(nr), sc(nc);
  for (int r = 0; r < nr; ++r) col4row[r] = -1;

  for (int cur_row = 0; cur_row < nr; ++cur_row) {
    std::fill(shortest.begin(), shortest.end(), DBL_MAX);
    std::fill(path.begin(), path.end(), -1);
    std::fill(sr.begin(), sr.end(), 0);
    std::fill(sc.begin(), sc.end(), 0);

    int sink = -1, i = cur_row;
    double min_val = 0.0;
    while (sink == -1) {
      sr[i] = 1;
      int jmin = -1;
      double lowest = DBL_MAX;
      const float* crow = cost + static_cast<long>(i) * nc;
      for (int j = 0; j < nc; ++j) {
        if (sc[j]) continue;
        double r = min_val + static_cast<double>(crow[j]) - u[i] - v[j];
        if (r < shortest[j]) {
          shortest[j] = r;
          path[j] = i;
        }
        if (shortest[j] < lowest ||
            (shortest[j] == lowest && row4col[j] == -1)) {
          lowest = shortest[j];
          jmin = j;
        }
      }
      if (jmin == -1 || lowest == DBL_MAX) return -1;  // infeasible
      min_val = lowest;
      sc[jmin] = 1;
      if (row4col[jmin] == -1) {
        sink = jmin;
      } else {
        i = row4col[jmin];
      }
    }

    u[cur_row] += min_val;
    for (int r = 0; r < nr; ++r) {
      if (sr[r] && r != cur_row) u[r] += min_val - shortest[col4row[r]];
    }
    for (int j = 0; j < nc; ++j) {
      if (sc[j]) v[j] -= min_val - shortest[j];
    }

    int j = sink;
    while (true) {
      int r = path[j];
      row4col[j] = r;
      int tmp = col4row[r];
      col4row[r] = j;
      if (r == cur_row) break;
      j = tmp;
    }
  }
  return 0;
}

}  // namespace

extern "C" {

// Single problem: cost is row-major [n_rows, n_cols] with n_rows <= n_cols.
int lapjv_solve(const float* cost, int n_rows, int n_cols, int* col4row) {
  if (n_rows <= 0) return 0;
  if (n_rows > n_cols) return -2;
  return lapjv_internal(cost, n_rows, n_cols, col4row);
}

// Batched: costs [batch, n_rows, n_cols]; n_rows_per[b] gives the real row
// count of each problem (rows beyond it are ignored; their col4row = -1).
int lapjv_solve_batched(const float* costs, const int* n_rows_per,
                        int batch, int max_rows, int n_cols, int* col4row) {
  for (int b = 0; b < batch; ++b) {
    const float* c = costs + static_cast<long>(b) * max_rows * n_cols;
    int* out = col4row + static_cast<long>(b) * max_rows;
    for (int r = 0; r < max_rows; ++r) out[r] = -1;
    int rc = lapjv_solve(c, n_rows_per[b], n_cols, out);
    if (rc != 0) return rc;
  }
  return 0;
}

}  // extern "C"
