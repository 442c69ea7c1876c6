// tpufem native host library: mesh generation + adjacency/ELL precompute.
//
// The CUDA reference implements its host layer in C++ (mesh classes,
// RectangleMesh::generate the CUDA reference's fea_test.cu:86-132, neighbor-list
// builder Mesh::getNeighborNodesList
// the CUDA reference's fea_test_sm_sym_sparse2.cu:72-100, SoA packing loops).
// This library provides the same host logic as a C-ABI shared object loaded
// via ctypes; the pure-numpy implementations in tpufem.mesh remain as a
// fallback and as the executable specification both are tested against.
//
// A copy of the JAX package's tpufem/native/meshgen.cpp, its code unchanged.
// Build: tpufem_torch.native.build_native() (g++ into tpufem_torch/_build/).

#include <algorithm>
#include <cstdint>
#include <vector>

extern "C" {

// Structured rectangle mesh: (nrow+1)*(ncol+1) nodes, 2 triangles per cell,
// exact reference numbering/flags/split (fea_test.cu:86-132).
void tpufem_rectangle_mesh(double x0, double x1, double y0, double y1,
                           int64_t nrow, int64_t ncol,
                           double* coords,   // [NN*2]
                           int32_t* conn,    // [NE*3]
                           int32_t* flags) { // [NN]
  const int64_t nc1 = ncol + 1, nr1 = nrow + 1;
  const double stepx = (x1 - x0) / ncol;
  const double stepy = (y1 - y0) / nrow;
  for (int64_t i = 0; i < nr1; ++i) {
    for (int64_t j = 0; j < nc1; ++j) {
      const int64_t n = i * nc1 + j;
      coords[2 * n] = x0 + j * stepx;
      coords[2 * n + 1] = y0 + i * stepy;
      flags[n] = (i == 0 || i == nrow || j == 0 || j == ncol) ? 1 : 0;
    }
  }
  int64_t e = 0;
  for (int64_t i = 0; i < nrow; ++i) {
    for (int64_t j = 0; j < ncol; ++j) {
      const int32_t n = static_cast<int32_t>(i * nc1 + j);
      const int32_t nc1i = static_cast<int32_t>(nc1);
      conn[3 * e] = n; conn[3 * e + 1] = n + 1; conn[3 * e + 2] = n + nc1i;
      ++e;
      conn[3 * e] = n + 1; conn[3 * e + 1] = n + nc1i + 1;
      conn[3 * e + 2] = n + nc1i;
      ++e;
    }
  }
}

// Structured box mesh: 6 Kuhn tets per cube (tpufem.mesh.box semantics).
void tpufem_box_mesh(double x0, double x1, double y0, double y1,
                     double z0, double z1,
                     int64_t nx, int64_t ny, int64_t nz,
                     double* coords,   // [NN*3]
                     int32_t* conn,    // [NE*4]
                     int32_t* flags) { // [NN]
  const int64_t nx1 = nx + 1, ny1 = ny + 1, nz1 = nz + 1;
  const double dx = (x1 - x0) / nx, dy = (y1 - y0) / ny, dz = (z1 - z0) / nz;
  for (int64_t i = 0; i < nz1; ++i)
    for (int64_t j = 0; j < ny1; ++j)
      for (int64_t k = 0; k < nx1; ++k) {
        const int64_t n = (i * ny1 + j) * nx1 + k;
        coords[3 * n] = x0 + k * dx;
        coords[3 * n + 1] = y0 + j * dy;
        coords[3 * n + 2] = z0 + i * dz;
        flags[n] = (i == 0 || i == nz || j == 0 || j == ny ||
                    k == 0 || k == nx) ? 1 : 0;
      }
  // 6 Kuhn tets: axis-order permutations of the path v000 -> v111.
  static const int perms[6][3] = {{0, 1, 2}, {0, 2, 1}, {1, 0, 2},
                                  {1, 2, 0}, {2, 0, 1}, {2, 1, 0}};
  int64_t e = 0;
  for (int64_t i = 0; i < nz; ++i)
    for (int64_t j = 0; j < ny; ++j)
      for (int64_t k = 0; k < nx; ++k)
        for (int t = 0; t < 6; ++t) {
          int64_t c[3] = {i, j, k};
          conn[4 * e] = static_cast<int32_t>((c[0] * ny1 + c[1]) * nx1 + c[2]);
          for (int v = 0; v < 3; ++v) {
            c[perms[t][v]] += 1;
            conn[4 * e + 1 + v] =
                static_cast<int32_t>((c[0] * ny1 + c[1]) * nx1 + c[2]);
          }
          ++e;
        }
}

namespace {

// Sorted unique (row, col) pairs of the FEM sparsity pattern.
void unique_pairs(const int32_t* conn, int64_t ne, int32_t npe, int64_t nn,
                  std::vector<int64_t>& keys_out) {
  keys_out.clear();
  keys_out.reserve(static_cast<size_t>(ne) * npe * npe);
  for (int64_t e = 0; e < ne; ++e)
    for (int32_t a = 0; a < npe; ++a)
      for (int32_t b = 0; b < npe; ++b)
        keys_out.push_back(
            static_cast<int64_t>(conn[e * npe + a]) * nn + conn[e * npe + b]);
  std::sort(keys_out.begin(), keys_out.end());
  keys_out.erase(std::unique(keys_out.begin(), keys_out.end()),
                 keys_out.end());
}

}  // namespace

// Per-node neighbor lists (incl. self, sorted), fixed width; padding = own
// index.  Parity: getNeighborNodesList
// (the CUDA reference's fea_test_sm_sym_sparse2.cu:72-100).
// Returns the max row degree; if max_len < max degree, nothing is written.
int32_t tpufem_node_adjacency(const int32_t* conn, int64_t ne, int32_t npe,
                              int64_t nn, int32_t max_len,
                              int32_t* lengths,   // [NN]
                              int32_t* indices) { // [NN * max_len] or null
  std::vector<int64_t> keys;
  unique_pairs(conn, ne, npe, nn, keys);
  std::vector<int32_t> deg(static_cast<size_t>(nn), 0);
  for (int64_t k : keys) ++deg[static_cast<size_t>(k / nn)];
  int32_t maxdeg = 0;
  for (int64_t i = 0; i < nn; ++i) maxdeg = std::max(maxdeg, deg[i]);
  if (indices == nullptr || max_len < maxdeg) {
    for (int64_t i = 0; i < nn; ++i) lengths[i] = deg[i];
    return maxdeg;
  }
  for (int64_t i = 0; i < nn; ++i) {
    lengths[i] = deg[i];
    for (int32_t s = 0; s < max_len; ++s)
      indices[i * max_len + s] = static_cast<int32_t>(i);
  }
  int64_t pos = 0;
  for (int64_t idx = 0; idx < static_cast<int64_t>(keys.size()); ++idx) {
    const int64_t row = keys[idx] / nn, col = keys[idx] % nn;
    if (idx > 0 && keys[idx - 1] / nn == row) ++pos; else pos = 0;
    indices[row * max_len + pos] = static_cast<int32_t>(col);
  }
  return maxdeg;
}

// ELL pattern + per-entry slots (replaces the reference's per-entry linear
// search, fea_test_sm_sym_sparse2.cu:277-281).  cols [NN*K] (padding = own
// row), diag_pos [NN], slots [NE*npe*npe] flat (row*K + within-row pos).
// Returns nnz, or -1 if K is smaller than the max row degree.
int64_t tpufem_ell_pattern(const int32_t* conn, int64_t ne, int32_t npe,
                           int64_t nn, int32_t K,
                           int32_t* cols, int32_t* diag_pos, int32_t* slots) {
  std::vector<int64_t> keys;
  unique_pairs(conn, ne, npe, nn, keys);
  std::vector<int64_t> row_start(static_cast<size_t>(nn) + 1, 0);
  for (int64_t k : keys) ++row_start[static_cast<size_t>(k / nn) + 1];
  for (int64_t i = 0; i < nn; ++i) {
    if (row_start[i + 1] > K) return -1;
    row_start[i + 1] += row_start[i];
  }
  for (int64_t i = 0; i < nn; ++i)
    for (int32_t s = 0; s < K; ++s)
      cols[i * K + s] = static_cast<int32_t>(i);
  for (int64_t idx = 0; idx < static_cast<int64_t>(keys.size()); ++idx) {
    const int64_t row = keys[idx] / nn, col = keys[idx] % nn;
    const int64_t pos = idx - row_start[row];
    cols[row * K + pos] = static_cast<int32_t>(col);
    if (row == col) diag_pos[row] = static_cast<int32_t>(pos);
  }
  for (int64_t e = 0; e < ne; ++e)
    for (int32_t a = 0; a < npe; ++a)
      for (int32_t b = 0; b < npe; ++b) {
        const int64_t row = conn[e * npe + a];
        const int64_t key = row * nn + conn[e * npe + b];
        const int64_t u = static_cast<int64_t>(
            std::lower_bound(keys.begin(), keys.end(), key) - keys.begin());
        slots[(e * npe + a) * npe + b] =
            static_cast<int32_t>(row * K + (u - row_start[row]));
      }
  return static_cast<int64_t>(keys.size());
}

// Level-set reverse Cuthill-McKee from an ELL cols array.
// Exact behavioral parity with tpufem.mesh.adjacency.reverse_cuthill_mckee
// (pseudo-peripheral start, level ordering by (first-parent rank, degree,
// node id), components by min-degree unvisited node) — the numpy version
// is the executable specification and both are cross-tested.
void tpufem_rcm(const int32_t* cols, int64_t n, int32_t K, int64_t* perm) {
  // CSR with self/padding entries dropped; row-major edge order preserved
  std::vector<int64_t> deg(n, 0);
  for (int64_t i = 0; i < n; ++i)
    for (int32_t k = 0; k < K; ++k)
      if (cols[i * K + k] != i) deg[i]++;
  std::vector<int64_t> row_start(n + 1, 0);
  for (int64_t i = 0; i < n; ++i) row_start[i + 1] = row_start[i] + deg[i];
  std::vector<int64_t> adj(row_start[n]);
  {
    std::vector<int64_t> cur(row_start.begin(), row_start.end() - 1);
    for (int64_t i = 0; i < n; ++i)
      for (int32_t k = 0; k < K; ++k) {
        int64_t c = cols[i * K + k];
        if (c != i) adj[cur[i]++] = c;
      }
  }

  const int64_t BIG = INT64_MAX;
  std::vector<int64_t> rank(n, BIG);
  std::vector<int64_t> out;
  out.reserve(n);

  // one component BFS; appends ordered levels to `levels`
  auto bfs_levels = [&](int64_t start, std::vector<char>& vis,
                        std::vector<std::vector<int64_t>>& levels) {
    std::vector<int64_t> frontier{start};
    vis[start] = 1;
    while (!frontier.empty()) {
      levels.push_back(frontier);
      std::vector<int64_t> cand;
      for (int64_t fi = 0; fi < (int64_t)frontier.size(); ++fi) {
        int64_t f = frontier[fi];
        for (int64_t e = row_start[f]; e < row_start[f + 1]; ++e) {
          int64_t nb = adj[e];
          if (vis[nb]) continue;
          if (rank[nb] == BIG) cand.push_back(nb);
          if (fi < rank[nb]) rank[nb] = fi;
        }
      }
      if (cand.empty()) break;
      std::sort(cand.begin(), cand.end(), [&](int64_t a, int64_t b) {
        if (rank[a] != rank[b]) return rank[a] < rank[b];
        if (deg[a] != deg[b]) return deg[a] < deg[b];
        return a < b;
      });
      for (int64_t nb : cand) { vis[nb] = 1; rank[nb] = BIG; }
      frontier.swap(cand);
    }
  };

  std::vector<char> visited(n, 0);
  int64_t filled = 0;
  while (filled < n) {
    // component start: unvisited node of minimum degree (first on ties)
    int64_t start = -1, best = BIG;
    for (int64_t i = 0; i < n; ++i)
      if (!visited[i] && deg[i] < best) { best = deg[i]; start = i; }
    // pseudo-peripheral (George-Liu) iteration on a visited copy
    int64_t depth = -1;
    for (int it = 0; it < 4; ++it) {
      std::vector<char> vcopy(visited);
      std::vector<std::vector<int64_t>> levels;
      bfs_levels(start, vcopy, levels);
      if ((int64_t)levels.size() <= depth) break;
      depth = (int64_t)levels.size();
      const auto& last = levels.back();
      int64_t s2 = last[0];
      for (int64_t v : last)
        if (deg[v] < deg[s2]) s2 = v;
      start = s2;
    }
    std::vector<std::vector<int64_t>> levels;
    bfs_levels(start, visited, levels);
    for (const auto& lvl : levels)
      for (int64_t v : lvl) { out.push_back(v); ++filled; }
  }
  for (int64_t i = 0; i < n; ++i) perm[i] = out[n - 1 - i];
}

// Two-pass greedy aggregation (Vanek/Mandel/Brezina smoothed aggregation)
// over an ELL adjacency pattern; self/padding entries (cols == row) are
// ignored.  Returns the aggregate count; ids are in creation order —
// callers normalize by first-member renumbering, so only the PARTITION
// must match tpufem.solve.amg.greedy_aggregate (the executable spec):
// same seeding order, same most-frequent-neighbor attach with ties to the
// smallest id, same singleton fallback.
int64_t tpufem_greedy_aggregate(const int32_t* cols, int64_t n, int32_t K,
                                int64_t* agg) {
  for (int64_t i = 0; i < n; ++i) agg[i] = -1;
  int64_t na = 0;
  for (int64_t i = 0; i < n; ++i) {      // pass 1: free-neighborhood seeds
    if (agg[i] != -1) continue;
    bool free_nb = true;
    for (int32_t k = 0; k < K; ++k) {
      int32_t c = cols[i * K + k];
      if (c != i && agg[c] != -1) { free_nb = false; break; }
    }
    if (!free_nb) continue;
    agg[i] = na;
    for (int32_t k = 0; k < K; ++k) {
      int32_t c = cols[i * K + k];
      if (c != i) agg[c] = na;
    }
    ++na;
  }
  std::vector<int64_t> pass1(agg, agg + n);
  for (int64_t i = 0; i < n; ++i) {      // pass 2 (reads pass-1 state)
    if (agg[i] != -1) continue;
    int64_t best = -1, best_cnt = 0;
    for (int32_t k = 0; k < K; ++k) {
      int32_t c = cols[i * K + k];
      if (c == i) continue;
      int64_t a = pass1[c];
      if (a < 0) continue;
      int64_t cnt = 0;
      for (int32_t k2 = 0; k2 < K; ++k2) {
        int32_t c2 = cols[i * K + k2];
        if (c2 != i && pass1[c2] == a) ++cnt;
      }
      if (best < 0 || cnt > best_cnt || (cnt == best_cnt && a < best)) {
        best = a;
        best_cnt = cnt;
      }
    }
    agg[i] = (best >= 0) ? best : na++;  // isolated: singleton
  }
  return na;
}

// ELL pattern + scatter slots via row counting sort + per-row dedup.
// The numpy path (tpufem.mesh.adjacency.ell_pattern) argsorts all
// ne*npe*npe flat keys globally — ~160 s at the reference's 20M-element
// scale (fea_test_sm_sym_sparse.cu:14-19).  Bucketing entries by row
// first (one counting-sort pass) turns the sort into ne-row-local sorts
// of <= valence*npe entries each: O(nnz) passes, cache-resident sorts.
//
// conn [ne, npe] -> cols [nn, K] (pad col = own row), lengths [nn],
// diag_pos [nn], slots [ne*npe*npe] (flat slot per local-matrix entry).
// Returns the required width; rows written only when K >= required
// (same retry protocol as tpufem_galerkin_ell).
int64_t tpufem_ell_pattern2(const int32_t* conn, int64_t ne, int32_t npe,
                            int64_t nn, int32_t K,
                            int32_t* cols, int32_t* lengths,
                            int32_t* diag_pos, int32_t* slots) {
  const int64_t total = ne * npe * npe;
  if (total > INT32_MAX) return -1;     // entry ids are packed as int32
  // bucket (col, entry-id) by row — one counting-sort pass
  std::vector<int64_t> row_start(nn + 1, 0);
  for (int64_t e = 0; e < ne; ++e)
    for (int32_t a = 0; a < npe; ++a)
      row_start[conn[e * npe + a] + 1] += npe;
  for (int64_t i = 0; i < nn; ++i) row_start[i + 1] += row_start[i];
  // pack (col, entry-id) into one int64 so the per-row insertion sort
  // moves a single word: key = col * 2^32 + idx (idx < 2^31 checked)
  std::vector<int64_t> bucket(total);
  {
    std::vector<int64_t> cur(row_start.begin(), row_start.end() - 1);
    for (int64_t e = 0; e < ne; ++e)
      for (int32_t a = 0; a < npe; ++a) {
        const int64_t row = conn[e * npe + a];
        int64_t c = cur[row];
        const int64_t base = (e * npe + a) * npe;
        for (int32_t b = 0; b < npe; ++b)
          bucket[c++] = (static_cast<int64_t>(conn[e * npe + b]) << 32)
                        | static_cast<int64_t>(base + b);
        cur[row] = c;
      }
  }
  // per-row: insertion-sort the packed pairs (rows are tiny — valence *
  // npe entries), dedup into the ELL row, point every entry at its slot
  int64_t needed = 1;
  for (int64_t i = 0; i < nn; ++i) {
    int64_t* beg = bucket.data() + row_start[i];
    const int64_t m = row_start[i + 1] - row_start[i];
    for (int64_t s = 1; s < m; ++s) {     // insertion sort
      const int64_t v = beg[s];
      int64_t t = s - 1;
      while (t >= 0 && beg[t] > v) {
        beg[t + 1] = beg[t];
        --t;
      }
      beg[t + 1] = v;
    }
    const bool write = (K > 0);
    int32_t w = 0;
    for (int64_t s = 0; s < m;) {
      const int32_t col = static_cast<int32_t>(beg[s] >> 32);
      int64_t e = s;
      while (e < m && static_cast<int32_t>(beg[e] >> 32) == col) ++e;
      if (write && w < K) {
        cols[i * K + w] = col;
        if (col == static_cast<int32_t>(i)) diag_pos[i] = w;
        const int32_t slot = static_cast<int32_t>(i * K + w);
        for (int64_t t = s; t < e; ++t)
          slots[beg[t] & 0x7fffffff] = slot;
      }
      ++w;
      s = e;
    }
    if (write) {
      lengths[i] = w;
      for (int32_t k = w; k < K; ++k)
        cols[i * K + k] = static_cast<int32_t>(i);
      if (w == 0) diag_pos[i] = 0;
    }
    if (w > needed) needed = w;
  }
  return needed;
}

// Galerkin triple product A_c = P^T A P over zero-padded ELL operands —
// the AMG setup hot loop (tpufem/solve/amg.py builds P; the chunked
// vectorized-numpy product there is the executable specification, but its
// big intermediate arrays are memory-traffic-bound on one core: 80 s at
// 1M rows.  This single-pass version dedups per row in a small scratch
// buffer instead: O(nnz) with cache-resident working sets).
//
// a: [n, K] data+cols (pad col = own row, val 0); p: [n, Kp] data+cols
// with coarse column ids < nc.  Outputs c_data/c_cols [nc, Wc] in the
// same padding convention.  Returns the REQUIRED width; rows are only
// written when Wc >= required — call once with a guess, retry bigger on
// shortfall (same protocol as tpufem_ell_pattern).
int64_t tpufem_galerkin_ell(const double* a_data, const int32_t* a_cols,
                            int64_t n, int32_t K,
                            const double* p_data, const int32_t* p_cols,
                            int32_t Kp, int64_t nc,
                            int32_t Wc, double* c_data, int32_t* c_cols) {
  using Entry = std::pair<int64_t, double>;
  // ---- C = A @ P, deduped per fine row, stored CSR-style ----
  std::vector<int64_t> c_ptr(n + 1, 0);
  std::vector<int64_t> ccol;
  std::vector<double> cval;
  ccol.reserve(static_cast<size_t>(n) * (K + 4));
  cval.reserve(static_cast<size_t>(n) * (K + 4));
  std::vector<Entry> scratch;
  scratch.reserve(static_cast<size_t>(K) * Kp);
  for (int64_t i = 0; i < n; ++i) {
    scratch.clear();
    for (int32_t k = 0; k < K; ++k) {
      const double a = a_data[i * K + k];
      if (a == 0.0) continue;
      const int64_t j = a_cols[i * K + k];
      for (int32_t kp = 0; kp < Kp; ++kp) {
        const double v = a * p_data[j * Kp + kp];
        if (v != 0.0) scratch.emplace_back(p_cols[j * Kp + kp], v);
      }
    }
    std::sort(scratch.begin(), scratch.end(),
              [](const Entry& x, const Entry& y) {
                return x.first < y.first;
              });
    for (size_t s = 0; s < scratch.size();) {
      double acc = scratch[s].second;
      size_t e = s + 1;
      while (e < scratch.size() && scratch[e].first == scratch[s].first) {
        acc += scratch[e].second;
        ++e;
      }
      ccol.push_back(scratch[s].first);
      cval.push_back(acc);
      s = e;
    }
    c_ptr[i + 1] = static_cast<int64_t>(ccol.size());
  }

  // ---- transpose P (bucket by coarse column; fine order preserved) ----
  std::vector<int64_t> t_ptr(nc + 1, 0);
  for (int64_t i = 0; i < n; ++i)
    for (int32_t kp = 0; kp < Kp; ++kp)
      if (p_data[i * Kp + kp] != 0.0) ++t_ptr[p_cols[i * Kp + kp] + 1];
  for (int64_t c = 0; c < nc; ++c) t_ptr[c + 1] += t_ptr[c];
  std::vector<int64_t> t_row(t_ptr[nc]);
  std::vector<double> t_val(t_ptr[nc]);
  {
    std::vector<int64_t> cur(t_ptr.begin(), t_ptr.end() - 1);
    for (int64_t i = 0; i < n; ++i)
      for (int32_t kp = 0; kp < Kp; ++kp) {
        const double v = p_data[i * Kp + kp];
        if (v == 0.0) continue;
        const int64_t c = p_cols[i * Kp + kp];
        t_row[cur[c]] = i;
        t_val[cur[c]] = v;
        ++cur[c];
      }
  }

  // ---- A_c rows: P^T C, deduped per coarse row ----
  int64_t needed = 1;
  for (int64_t c = 0; c < nc; ++c) {
    scratch.clear();
    for (int64_t t = t_ptr[c]; t < t_ptr[c + 1]; ++t) {
      const int64_t i = t_row[t];
      const double pv = t_val[t];
      for (int64_t s = c_ptr[i]; s < c_ptr[i + 1]; ++s)
        scratch.emplace_back(ccol[s], pv * cval[s]);
    }
    std::sort(scratch.begin(), scratch.end(),
              [](const Entry& x, const Entry& y) {
                return x.first < y.first;
              });
    int64_t w = 0;
    const bool write = (Wc > 0 && c_data != nullptr);
    for (size_t s = 0; s < scratch.size();) {
      double acc = scratch[s].second;
      size_t e = s + 1;
      while (e < scratch.size() && scratch[e].first == scratch[s].first) {
        acc += scratch[e].second;
        ++e;
      }
      if (acc != 0.0 || scratch[s].first == c) {
        if (write && w < Wc) {
          c_data[c * Wc + w] = acc;
          c_cols[c * Wc + w] = static_cast<int32_t>(scratch[s].first);
        }
        ++w;
      }
      s = e;
    }
    if (w == 0) {                       // keep every row alive (diagonal)
      if (write) {
        c_data[c * Wc] = 0.0;
        c_cols[c * Wc] = static_cast<int32_t>(c);
      }
      w = 1;
    }
    if (write)
      for (int64_t k = w; k < Wc; ++k) {
        c_data[c * Wc + k] = 0.0;
        c_cols[c * Wc + k] = static_cast<int32_t>(c);
      }
    if (w > needed) needed = w;
  }
  return needed;
}

namespace {

// Scratch accumulator for blocked sparse products: (column, block) pairs
// collected per output row, then sorted by column and merged.  Blocks are
// kept out-of-line in a flat buffer so the sort moves 12 bytes per entry.
struct BlockScratch {
  std::vector<std::pair<int64_t, int32_t>> keys;  // (col, block index)
  std::vector<double> blocks;                     // flat [count * bm]
  int32_t bm = 0;

  void reset(int32_t block_elems) {
    keys.clear();
    blocks.clear();
    bm = block_elems;
  }
  double* push(int64_t col) {
    keys.emplace_back(col, static_cast<int32_t>(keys.size()));
    blocks.resize(blocks.size() + bm, 0.0);
    return blocks.data() + blocks.size() - bm;
  }
};

inline bool block_nonzero(const double* v, int32_t len) {
  for (int32_t t = 0; t < len; ++t)
    if (v[t] != 0.0) return true;
  return false;
}

// Merge sorted-by-column scratch into an ELL row of width Wc (pad col =
// `pad`, zero blocks), keeping the diagonal entry `diag_col` alive even
// when it sums to zero.  Returns the required width; writes only when
// `write` and the entry fits.
int64_t merge_row(BlockScratch& sc, int64_t row_base, int32_t Wc, bool write,
                  int64_t diag_col, int64_t pad, double* out_data,
                  int32_t* out_cols) {
  std::sort(sc.keys.begin(), sc.keys.end());
  const int32_t bm = sc.bm;
  std::vector<double> acc(bm);
  int64_t w = 0;
  for (size_t s = 0; s < sc.keys.size();) {
    const int64_t col = sc.keys[s].first;
    std::fill(acc.begin(), acc.end(), 0.0);
    size_t e = s;
    while (e < sc.keys.size() && sc.keys[e].first == col) {
      const double* src = sc.blocks.data() +
                          static_cast<size_t>(sc.keys[e].second) * bm;
      for (int32_t t = 0; t < bm; ++t) acc[t] += src[t];
      ++e;
    }
    if (block_nonzero(acc.data(), bm) || col == diag_col) {
      if (write && w < Wc) {
        double* dst = out_data + (row_base + w) * bm;
        for (int32_t t = 0; t < bm; ++t) dst[t] = acc[t];
        out_cols[row_base + w] = static_cast<int32_t>(col);
      }
      ++w;
    }
    s = e;
  }
  if (w == 0) {                  // keep the row alive (zero diagonal)
    if (write && Wc > 0) {
      double* dst = out_data + row_base * bm;
      for (int32_t t = 0; t < bm; ++t) dst[t] = 0.0;
      out_cols[row_base] = static_cast<int32_t>(
          diag_col >= 0 ? diag_col : pad);
    }
    w = 1;
  }
  if (write)
    for (int64_t k = w; k < Wc; ++k) {
      double* dst = out_data + (row_base + k) * bm;
      for (int32_t t = 0; t < bm; ++t) dst[t] = 0.0;
      out_cols[row_base + k] = static_cast<int32_t>(pad);
    }
  return w;
}

}  // namespace

// Blocked SpMM C = A @ P over zero-padded block-ELL operands — the
// smoothed-prolongator step of block smoothed aggregation
// (tpufem/solve/amg_block.py:_bspmm is the executable numpy spec; its
// fancy-indexed [rows, K, Kp, b, m] intermediates are what made the
// 982k-DOF setup cost ~1047 s, BENCH_NOTES r4b phase 6b/7b).
// a_data [n, K, b, b] / a_cols [n, K] (pad col = own row, zero block);
// p_data [n, Kp, b, m] / p_cols [n, Kp] with coarse ids < nc.
// Output block-ELL c_data [n, Wc, b, m] / c_cols [n, Wc] (pad col 0, rows
// have no forced diagonal — C is rectangular).  Returns required width.
int64_t tpufem_bspmm_bell(const double* a_data, const int32_t* a_cols,
                          int64_t n, int32_t K, int32_t b,
                          const double* p_data, const int32_t* p_cols,
                          int32_t Kp, int32_t m, int64_t nc,
                          int32_t Wc, double* c_data, int32_t* c_cols) {
  (void)nc;
  const int32_t bb = b * b, bm = b * m;
  BlockScratch sc;
  int64_t needed = 1;
  const bool write = (Wc > 0 && c_data != nullptr);
  for (int64_t i = 0; i < n; ++i) {
    sc.reset(bm);
    for (int32_t k = 0; k < K; ++k) {
      const double* Ab = a_data + (i * K + k) * bb;
      if (!block_nonzero(Ab, bb)) continue;
      const int64_t j = a_cols[i * K + k];
      for (int32_t kp = 0; kp < Kp; ++kp) {
        const double* Pb = p_data + (j * Kp + kp) * bm;
        if (!block_nonzero(Pb, bm)) continue;
        double* V = sc.push(p_cols[j * Kp + kp]);
        for (int32_t x = 0; x < b; ++x)
          for (int32_t z = 0; z < b; ++z) {
            const double a = Ab[x * b + z];
            if (a == 0.0) continue;
            for (int32_t y = 0; y < m; ++y)
              V[x * m + y] += a * Pb[z * m + y];
          }
      }
    }
    const int64_t w = merge_row(sc, i * static_cast<int64_t>(Wc), Wc, write,
                                /*diag_col=*/-1, /*pad=*/0, c_data, c_cols);
    if (w > needed) needed = w;
  }
  return needed;
}

// Blocked Galerkin triple product A_c = P^T A P — the block analogue of
// tpufem_galerkin_ell above (the scalar version closed the round-3 AMG
// setup wall; VERDICT r4 item 5 asks for the same for BCSR hierarchies).
// Operands as in tpufem_bspmm_bell; output c_data [nc, Wc, m, m] /
// c_cols [nc, Wc] (pad col = own coarse row).  Returns required width.
int64_t tpufem_galerkin_bell(const double* a_data, const int32_t* a_cols,
                             int64_t n, int32_t K, int32_t b,
                             const double* p_data, const int32_t* p_cols,
                             int32_t Kp, int32_t m, int64_t nc,
                             int32_t Wc, double* c_data, int32_t* c_cols) {
  const int32_t bb = b * b, bm = b * m, mm = m * m;
  // ---- stage 1: C = A @ P, deduped per fine row, CSR-style ----
  std::vector<int64_t> c_ptr(n + 1, 0);
  std::vector<int64_t> ccol;
  std::vector<double> cval;
  ccol.reserve(static_cast<size_t>(n) * (K + 4));
  cval.reserve(static_cast<size_t>(n) * (K + 4) * bm);
  BlockScratch sc;
  std::vector<double> acc(bm);
  for (int64_t i = 0; i < n; ++i) {
    sc.reset(bm);
    for (int32_t k = 0; k < K; ++k) {
      const double* Ab = a_data + (i * K + k) * bb;
      if (!block_nonzero(Ab, bb)) continue;
      const int64_t j = a_cols[i * K + k];
      for (int32_t kp = 0; kp < Kp; ++kp) {
        const double* Pb = p_data + (j * Kp + kp) * bm;
        if (!block_nonzero(Pb, bm)) continue;
        double* V = sc.push(p_cols[j * Kp + kp]);
        for (int32_t x = 0; x < b; ++x)
          for (int32_t z = 0; z < b; ++z) {
            const double a = Ab[x * b + z];
            if (a == 0.0) continue;
            for (int32_t y = 0; y < m; ++y)
              V[x * m + y] += a * Pb[z * m + y];
          }
      }
    }
    std::sort(sc.keys.begin(), sc.keys.end());
    for (size_t s = 0; s < sc.keys.size();) {
      const int64_t col = sc.keys[s].first;
      std::fill(acc.begin(), acc.end(), 0.0);
      size_t e = s;
      while (e < sc.keys.size() && sc.keys[e].first == col) {
        const double* src = sc.blocks.data() +
                            static_cast<size_t>(sc.keys[e].second) * bm;
        for (int32_t t = 0; t < bm; ++t) acc[t] += src[t];
        ++e;
      }
      if (block_nonzero(acc.data(), bm)) {
        ccol.push_back(col);
        cval.insert(cval.end(), acc.begin(), acc.end());
      }
      s = e;
    }
    c_ptr[i + 1] = static_cast<int64_t>(ccol.size());
  }

  // ---- stage 2: transpose P (bucket by coarse column) ----
  std::vector<int64_t> t_ptr(nc + 1, 0);
  for (int64_t i = 0; i < n; ++i)
    for (int32_t kp = 0; kp < Kp; ++kp)
      if (block_nonzero(p_data + (i * Kp + kp) * bm, bm))
        ++t_ptr[p_cols[i * Kp + kp] + 1];
  for (int64_t c = 0; c < nc; ++c) t_ptr[c + 1] += t_ptr[c];
  std::vector<int64_t> t_row(t_ptr[nc]);
  std::vector<int64_t> t_off(t_ptr[nc]);   // block offset into p_data
  {
    std::vector<int64_t> cur(t_ptr.begin(), t_ptr.end() - 1);
    for (int64_t i = 0; i < n; ++i)
      for (int32_t kp = 0; kp < Kp; ++kp) {
        const int64_t off = (i * Kp + kp) * static_cast<int64_t>(bm);
        if (!block_nonzero(p_data + off, bm)) continue;
        const int64_t c = p_cols[i * Kp + kp];
        t_row[cur[c]] = i;
        t_off[cur[c]] = off;
        ++cur[c];
      }
  }

  // ---- stage 3: A_c rows = P^T C, deduped per coarse row ----
  int64_t needed = 1;
  const bool write = (Wc > 0 && c_data != nullptr);
  for (int64_t c = 0; c < nc; ++c) {
    sc.reset(mm);
    for (int64_t t = t_ptr[c]; t < t_ptr[c + 1]; ++t) {
      const int64_t i = t_row[t];
      const double* Pb = p_data + t_off[t];          // [b, m]
      for (int64_t s = c_ptr[i]; s < c_ptr[i + 1]; ++s) {
        const double* Cv = cval.data() + s * bm;     // [b, m]
        double* V = sc.push(ccol[s]);                // [m, m] += Pb^T Cv
        for (int32_t z = 0; z < b; ++z)
          for (int32_t x = 0; x < m; ++x) {
            const double p = Pb[z * m + x];
            if (p == 0.0) continue;
            for (int32_t y = 0; y < m; ++y)
              V[x * m + y] += p * Cv[z * m + y];
          }
      }
    }
    const int64_t w = merge_row(sc, c * static_cast<int64_t>(Wc), Wc, write,
                                /*diag_col=*/c, /*pad=*/c, c_data, c_cols);
    if (w > needed) needed = w;
  }
  return needed;
}

}  // extern "C"
