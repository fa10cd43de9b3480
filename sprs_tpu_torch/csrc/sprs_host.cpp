// Native host-side symbolic analysis for sprs_tpu_torch.
//
// The port's own copy of the JAX package's host library: the graph
// algorithms that feed the device kernels — elimination trees, LDL
// symbolic analysis, RCM, AMD and nested-dissection orderings,
// triangular level scheduling, supernode amalgamation, and the host
// numerics of LU, ILU(0), IC(0) and a Gauss–Seidel sweep — are
// sequential pointer-chasing, so they run as optimized C++ on the host
// while the solves run on the device.  Bound into Python with ctypes by
// sprs_tpu_torch/native; every entry point has a numpy fallback in
// sprs_tpu_torch.linalg, so the library is a fast path, never a
// requirement.  Built with -ffp-contract=off so that the numeric entry
// points are bit-identical to their numpy fallbacks.
//
// All index arrays are int32, sizes int64.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <queue>
#include <vector>

#ifndef INT64_MAX
#define INT64_MAX std::numeric_limits<int64_t>::max()
#endif

extern "C" {

// Elimination tree of a symmetric pattern (Liu's algorithm with path
// compression).  parent[k] = -1 for roots.
void sprs_etree(const int32_t* indptr, const int32_t* indices, int64_t n,
                int32_t* parent) {
  std::vector<int32_t> ancestor(static_cast<size_t>(n), -1);
  for (int64_t k = 0; k < n; ++k) parent[k] = -1;
  for (int64_t k = 0; k < n; ++k) {
    for (int32_t p = indptr[k]; p < indptr[k + 1]; ++p) {
      int32_t j = indices[p];
      if (j >= k) continue;
      while (true) {
        int32_t a = ancestor[j];
        ancestor[j] = static_cast<int32_t>(k);
        if (a == -1) {
          if (parent[j] == -1 && j != k) parent[j] = static_cast<int32_t>(k);
          break;
        }
        if (a == static_cast<int32_t>(k)) break;
        j = a;
      }
    }
  }
}

// LDL symbolic: etree + per-column sub-diagonal counts in one pass
// (Davis's ldl_symbolic schema).  Returns total sub-diagonal nnz of L.
// row_cols: the (permuted) upper-row pattern, CSR-like via row_ptr.
int64_t sprs_ldl_symbolic(const int32_t* row_ptr, const int32_t* row_cols,
                          int64_t n, int32_t* parent, int32_t* col_count,
                          int32_t* row_count) {
  std::vector<int32_t> flag(static_cast<size_t>(n), -1);
  for (int64_t k = 0; k < n; ++k) {
    parent[k] = -1;
    col_count[k] = 0;
    row_count[k] = 0;
  }
  int64_t total = 0;
  for (int64_t k = 0; k < n; ++k) {
    flag[k] = static_cast<int32_t>(k);
    for (int32_t p = row_ptr[k]; p < row_ptr[k + 1]; ++p) {
      int32_t j = row_cols[p];
      if (j >= k) continue;
      while (flag[j] != static_cast<int32_t>(k)) {
        if (parent[j] == -1) parent[j] = static_cast<int32_t>(k);
        ++col_count[j];
        ++row_count[k];
        ++total;
        flag[j] = static_cast<int32_t>(k);
        j = parent[j];
      }
    }
  }
  return total;
}

// Per-row topological patterns of L for the same input; row_pattern is
// (n, wl) padded with n; insert_pos receives the absolute slot of
// L[k, j] given l_indptr (diag-first CSC layout).  Also fills
// l_indices.  Must be called with wl >= max row pattern length (as
// returned via col counts from sprs_ldl_symbolic).
void sprs_ldl_pattern(const int32_t* row_ptr, const int32_t* row_cols,
                      int64_t n, const int32_t* parent,
                      const int64_t* l_indptr, int64_t wl,
                      int32_t* row_pattern, int64_t* insert_pos,
                      int32_t* l_indices) {
  std::vector<int32_t> flag(static_cast<size_t>(n), -1);
  std::vector<int64_t> fill(static_cast<size_t>(n));
  std::vector<int32_t> pat;
  for (int64_t j = 0; j < n; ++j) {
    fill[j] = l_indptr[j] + 1;  // slot after the unit diagonal
    l_indices[l_indptr[j]] = static_cast<int32_t>(j);
  }
  for (int64_t k = 0; k < n; ++k) {
    flag[k] = static_cast<int32_t>(k);
    pat.clear();
    for (int32_t p = row_ptr[k]; p < row_ptr[k + 1]; ++p) {
      int32_t j = row_cols[p];
      if (j >= k) continue;
      while (flag[j] != static_cast<int32_t>(k)) {
        pat.push_back(j);
        flag[j] = static_cast<int32_t>(k);
        j = parent[j];
      }
    }
    std::sort(pat.begin(), pat.end());
    for (size_t t = 0; t < static_cast<size_t>(wl); ++t) {
      if (t < pat.size()) {
        int32_t j = pat[t];
        row_pattern[k * wl + t] = j;
        insert_pos[k * wl + t] = fill[j];
        l_indices[fill[j]] = static_cast<int32_t>(k);
        ++fill[j];
      } else {
        row_pattern[k * wl + t] = static_cast<int32_t>(n);
        insert_pos[k * wl + t] = 0;
      }
    }
  }
}

// Postorder of an elimination tree (parent[k] > k or -1 for roots).
// Writes post (new -> old): post[i] is the i-th node visited in a DFS
// that exhausts each child subtree before its parent, children in
// ascending order.  Postordering is a fill-invariant relabeling of the
// factor (Liu); it makes every etree subtree a contiguous column range,
// which is what lets supernode amalgamation merge bushy (AMD-ordered)
// trees into wide panels.
void sprs_etree_postorder(const int32_t* parent, int64_t n, int32_t* post) {
  // child lists via counting sort (ascending child order preserved)
  std::vector<int64_t> head(static_cast<size_t>(n) + 1, 0);
  for (int64_t k = 0; k < n; ++k) {
    int64_t p = parent[k] >= 0 ? parent[k] : n;  // roots under slot n
    ++head[p];
  }
  std::vector<int64_t> offs(static_cast<size_t>(n) + 2, 0);
  for (int64_t i = 0; i <= n; ++i) offs[i + 1] = offs[i] + head[i];
  std::vector<int32_t> child(static_cast<size_t>(n));
  std::vector<int64_t> fill(offs.begin(), offs.end() - 1);
  for (int64_t k = 0; k < n; ++k) {
    int64_t p = parent[k] >= 0 ? parent[k] : n;
    child[fill[p]++] = static_cast<int32_t>(k);
  }
  // iterative DFS; stack entry = (node, next-child cursor)
  std::vector<int64_t> stack_node, stack_cur;
  stack_node.reserve(64);
  stack_cur.reserve(64);
  int64_t out = 0;
  for (int64_t r = offs[n]; r < offs[n + 1]; ++r) {
    stack_node.push_back(child[r]);
    stack_cur.push_back(offs[child[r]]);
    while (!stack_node.empty()) {
      int64_t v = stack_node.back();
      int64_t& cur = stack_cur.back();
      if (cur < offs[v + 1]) {
        int32_t c = child[cur++];
        stack_node.push_back(c);
        stack_cur.push_back(offs[c]);
      } else {
        post[out++] = static_cast<int32_t>(v);
        stack_node.pop_back();
        stack_cur.pop_back();
      }
    }
  }
}

// Compact variant of sprs_ldl_pattern: each row k's topological update
// list and insert slots are written at rp_indptr[k] (flat O(lnz)
// output) instead of a padded (n, wl) grid.  The padded grid is
// O(n*wl) and wl reaches the trailing dense-block width under
// fill-reducing orderings (~sqrt(n) on 2-D meshes), which is tens of
// GB at 10^6 rows; the flat form is the at-scale path and the padded
// one is derived lazily only for the sequential scan numeric.
// rp_indptr = exclusive prefix sum of row_count from sprs_ldl_symbolic.
void sprs_ldl_pattern_flat(const int32_t* row_ptr, const int32_t* row_cols,
                           int64_t n, const int32_t* parent,
                           const int64_t* l_indptr,
                           const int64_t* rp_indptr, int32_t* rp_cols,
                           int64_t* rp_slots, int32_t* l_indices) {
  std::vector<int32_t> flag(static_cast<size_t>(n), -1);
  std::vector<int64_t> fill(static_cast<size_t>(n));
  std::vector<int32_t> pat;
  for (int64_t j = 0; j < n; ++j) {
    fill[j] = l_indptr[j] + 1;  // slot after the unit diagonal
    l_indices[l_indptr[j]] = static_cast<int32_t>(j);
  }
  for (int64_t k = 0; k < n; ++k) {
    flag[k] = static_cast<int32_t>(k);
    pat.clear();
    for (int32_t p = row_ptr[k]; p < row_ptr[k + 1]; ++p) {
      int32_t j = row_cols[p];
      if (j >= k) continue;
      while (flag[j] != static_cast<int32_t>(k)) {
        pat.push_back(j);
        flag[j] = static_cast<int32_t>(k);
        j = parent[j];
      }
    }
    std::sort(pat.begin(), pat.end());
    int64_t base = rp_indptr[k];
    for (size_t t = 0; t < pat.size(); ++t) {
      int32_t j = pat[t];
      rp_cols[base + static_cast<int64_t>(t)] = j;
      rp_slots[base + static_cast<int64_t>(t)] = fill[j];
      l_indices[fill[j]] = static_cast<int32_t>(k);
      ++fill[j];
    }
  }
}

// Union-structure relaxed amalgamation (supernodes.amalgamate_union's
// fast path).  Inputs: L's CSC pattern, the strip starts ptr0 (S0+1;
// fundamentals already split to max_width by the caller), colcount
// prefix ccum (n+1).  Greedy left-merge passes until fixpoint: merge
// the running block [a0, c1) with the next strip [c1, c2) when the
// merged width stays <= max_width and the explicit zeros (panel
// entries minus true entries) pass the absolute-or-relative budget.
// Outputs: out_ptr (<= S0+1 entries; returns the block count), per-
// block sorted below-row unions packed into out_flat at out_bptr.
// out_flat capacity must be >= sum of the strips' initial row counts
// (unions only shrink under merging).
int64_t sprs_amalgamate_union(const int64_t* l_indptr,
                              const int64_t* l_indices, int64_t n,
                              const int64_t* ptr0, int64_t S0,
                              int64_t max_width, int64_t max_zeros,
                              double rel_zeros, int64_t* out_ptr,
                              int64_t* out_bptr, int64_t* out_flat) {
  struct Blk {
    int64_t c0, c1, tn;
    std::vector<int64_t> rows;
  };
  std::vector<Blk> blocks;
  blocks.reserve(static_cast<size_t>(S0));
  // colcount prefix on the fly: tn = l_indptr[c1] - l_indptr[c0]
  for (int64_t s = 0; s < S0; ++s) {
    const int64_t c0 = ptr0[s], c1 = ptr0[s + 1];
    Blk b;
    b.c0 = c0;
    b.c1 = c1;
    b.tn = l_indptr[c1] - l_indptr[c0];
    // struct(first col) below the diagonal, restricted to >= c1
    for (int64_t p = l_indptr[c0] + 1; p < l_indptr[c0 + 1]; ++p) {
      if (l_indices[p] >= c1) b.rows.push_back(l_indices[p]);
    }
    blocks.push_back(std::move(b));
  }
  std::vector<int64_t> merged;
  for (int pass = 0; pass < 4; ++pass) {
    bool changed = false;
    std::vector<Blk> out;
    out.reserve(blocks.size());
    for (auto& b : blocks) {
      if (out.empty()) {
        out.push_back(std::move(b));
        continue;
      }
      Blk& a = out.back();
      const int64_t w_new = b.c1 - a.c0;
      if (w_new <= max_width) {
        // union of (a.rows >= b.c1) with b.rows (both sorted)
        merged.clear();
        size_t i = 0;
        while (i < a.rows.size() && a.rows[i] < b.c1) ++i;
        size_t j = 0;
        while (i < a.rows.size() || j < b.rows.size()) {
          int64_t v;
          if (j >= b.rows.size() ||
              (i < a.rows.size() && a.rows[i] <= b.rows[j])) {
            v = a.rows[i++];
            if (j < b.rows.size() && b.rows[j] == v) ++j;
          } else {
            v = b.rows[j++];
          }
          merged.push_back(v);
        }
        const int64_t tn = a.tn + b.tn;
        const int64_t ent =
            w_new * (w_new + 1) / 2 +
            w_new * static_cast<int64_t>(merged.size());
        const int64_t zeros = ent - tn;
        if (zeros <= max_zeros ||
            static_cast<double>(zeros) <= rel_zeros * ent) {
          a.c1 = b.c1;
          a.tn = tn;
          a.rows = merged;
          changed = true;
          continue;
        }
      }
      out.push_back(std::move(b));
    }
    blocks.swap(out);
    if (!changed) break;
  }
  const int64_t S = static_cast<int64_t>(blocks.size());
  int64_t fp = 0;
  out_bptr[0] = 0;
  for (int64_t s = 0; s < S; ++s) {
    out_ptr[s] = blocks[s].c0;
    for (int64_t r : blocks[s].rows) out_flat[fp++] = r;
    out_bptr[s + 1] = fp;
  }
  out_ptr[S] = n;
  return S;
}

// Per-update-pair row map for the supernodal LDL numeric: for pair p
// (descendant d -> target t), rmap[p*MR + slot] is the row index inside
// d's panel holding the same global row as target panel slot `slot`, or
// MR (the zero-pad row) when the target row is not in d's below
// structure.  Target panel rows are the diagonal block [c0[t], c0[t]+
// w[t]) followed by below_flat[below_ptr[t]:below_ptr[t+1]] — both
// ascending, diag < below — so one two-pointer merge of d's below list
// against the target row list fills the row in O(|below(d)| + rows[t])
// (the numpy fallback broadcasts (T, MR) membership queries instead:
// measured 32 s vs <1 s at 262k rows).
void sprs_super_rmap(const int64_t* pair_d, const int64_t* pair_t,
                     int64_t npairs, const int64_t* c0, const int64_t* w,
                     const int64_t* below_ptr, const int64_t* below_flat,
                     int64_t MR, int32_t* rmap) {
  for (int64_t p = 0; p < npairs; ++p) {
    const int64_t d = pair_d[p], t = pair_t[p];
    int32_t* out = rmap + p * MR;
    for (int64_t s = 0; s < MR; ++s) out[s] = static_cast<int32_t>(MR);
    const int64_t* db = below_flat + below_ptr[d];
    const int64_t dn = below_ptr[d + 1] - below_ptr[d];
    const int64_t wd = w[d];
    const int64_t tw = w[t];
    const int64_t tb0 = below_ptr[t];
    const int64_t tn = below_ptr[t + 1] - tb0;
    int64_t i = 0;  // cursor into d's below list
    // diagonal-block slots: global rows c0[t] .. c0[t]+tw-1, ascending
    for (int64_t s = 0; s < tw && i < dn; ++s) {
      const int64_t g = c0[t] + s;
      while (i < dn && db[i] < g) ++i;
      if (i < dn && db[i] == g) out[s] = static_cast<int32_t>(wd + i);
    }
    // below slots: ascending rows >= c1[t] > any diag row
    for (int64_t s = 0; s < tn && i < dn; ++s) {
      const int64_t g = below_flat[tb0 + s];
      while (i < dn && db[i] < g) ++i;
      if (i < dn && db[i] == g)
        out[tw + s] = static_cast<int32_t>(wd + i);
    }
  }
}

// Reverse Cuthill–McKee with George–Liu pseudo-peripheral starts.
// Writes the permutation (new -> old) and component delimiters; returns
// the number of connected components.  parts must have room for n+1.
int64_t sprs_rcm(const int32_t* indptr, const int32_t* indices, int64_t n,
                 int32_t* perm, int64_t* parts, int32_t reversed) {
  std::vector<int64_t> deg(static_cast<size_t>(n), 0);
  for (int64_t i = 0; i < n; ++i) {
    for (int32_t p = indptr[i]; p < indptr[i + 1]; ++p)
      if (indices[p] != i) ++deg[i];
  }
  std::vector<uint8_t> visited(static_cast<size_t>(n), 0);
  std::vector<int32_t> levels_buf;
  std::vector<int32_t> frontier, next;

  // BFS depth from root over unvisited vertices; returns eccentricity and
  // leaves the last level in `frontier`.
  auto rls = [&](int32_t root, std::vector<uint8_t>& seen) -> int64_t {
    std::fill(seen.begin(), seen.end(), 0);
    frontier.assign(1, root);
    seen[root] = 1;
    int64_t depth = 0;
    while (true) {
      next.clear();
      for (int32_t v : frontier) {
        for (int32_t p = indptr[v]; p < indptr[v + 1]; ++p) {
          int32_t u = indices[p];
          if (!seen[u] && !visited[u]) {
            seen[u] = 1;
            next.push_back(u);
          }
        }
      }
      if (next.empty()) return depth;
      frontier.swap(next);
      ++depth;
    }
  };

  std::vector<uint8_t> seen(static_cast<size_t>(n), 0);
  int64_t pos = 0;
  int64_t ncomp = 0;
  parts[0] = 0;
  for (int64_t seed = 0; seed < n; ++seed) {
    if (visited[seed]) continue;
    // pseudo-peripheral start
    int32_t x = static_cast<int32_t>(seed);
    int64_t ecc = rls(x, seen);
    while (true) {
      int32_t y = frontier[0];
      for (int32_t v : frontier)
        if (deg[v] < deg[y]) y = v;
      int64_t ecc_y = rls(y, seen);
      if (ecc_y <= ecc) {
        x = y;
        break;
      }
      x = y;
      ecc = ecc_y;
    }
    // Cuthill–McKee BFS with degree-sorted neighbor insertion
    std::queue<int32_t> q;
    q.push(x);
    visited[x] = 1;
    std::vector<int32_t> nbrs;
    while (!q.empty()) {
      int32_t v = q.front();
      q.pop();
      perm[pos++] = v;
      nbrs.clear();
      for (int32_t p = indptr[v]; p < indptr[v + 1]; ++p) {
        int32_t u = indices[p];
        if (!visited[u]) nbrs.push_back(u);
      }
      std::sort(nbrs.begin(), nbrs.end(),
                [&](int32_t a, int32_t b) { return deg[a] < deg[b]; });
      for (int32_t u : nbrs) {
        visited[u] = 1;
        q.push(u);
      }
    }
    ++ncomp;
    parts[ncomp] = pos;
  }
  if (reversed) {
    std::reverse(perm, perm + n);
    for (int64_t c = 0; c <= ncomp; ++c) parts[c] = n - parts[c];
    std::reverse(parts, parts + ncomp + 1);
  }
  return ncomp;
}

// Triangular dependency levels: level[i] = 1 + max(level of in-row deps).
// lower != 0: deps are indices < i scanned ascending; else indices > i
// scanned descending.  Returns the number of levels.
int64_t sprs_tri_levels(const int32_t* indptr, const int32_t* indices,
                        int64_t n, int32_t lower, int64_t* level) {
  int64_t max_level = 0;
  if (lower) {
    for (int64_t i = 0; i < n; ++i) {
      int64_t lv = 0;
      for (int32_t p = indptr[i]; p < indptr[i + 1]; ++p) {
        int32_t j = indices[p];
        if (j < i && level[j] + 1 > lv) lv = level[j] + 1;
      }
      level[i] = lv;
      if (lv > max_level) max_level = lv;
    }
  } else {
    for (int64_t i = n - 1; i >= 0; --i) {
      int64_t lv = 0;
      for (int32_t p = indptr[i]; p < indptr[i + 1]; ++p) {
        int32_t j = indices[p];
        if (j > i && level[j] + 1 > lv) lv = level[j] + 1;
      }
      level[i] = lv;
      if (lv > max_level) max_level = lv;
    }
  }
  return max_level + 1;
}

// Gauss–Seidel sweeps on CSR until ||Ax-b||_2 <= tol or max_iter.
// Returns iterations used; writes final residual to *residual.
int64_t sprs_gauss_seidel(const int32_t* indptr, const int32_t* indices,
                          const double* data, const double* b, double* x,
                          int64_t n, double tol, int64_t max_iter,
                          double* residual) {
  int64_t it = 0;
  double res = 0.0;
  auto compute_res = [&]() {
    double acc = 0.0;
    for (int64_t i = 0; i < n; ++i) {
      double yi = 0.0;
      for (int32_t p = indptr[i]; p < indptr[i + 1]; ++p)
        yi += data[p] * x[indices[p]];
      double d = yi - b[i];
      acc += d * d;
    }
    return std::sqrt(acc);
  };
  res = compute_res();
  while (res > tol && it < max_iter) {
    for (int64_t i = 0; i < n; ++i) {
      double sigma = 0.0, diag = 0.0;
      for (int32_t p = indptr[i]; p < indptr[i + 1]; ++p) {
        int32_t j = indices[p];
        if (j == i)
          diag = data[p];
        else
          sigma += data[p] * x[j];
      }
      x[i] = (b[i] - sigma) / diag;
    }
    ++it;
    res = compute_res();
  }
  *residual = res;
  return it;
}

// Approximate Minimum Degree ordering (quotient-graph AMD, simplified:
// plain minimum-degree with supervariable-free elimination on an
// explicit adjacency that caps fill tracking).  Good enough to serve the
// reference's CAMD role (an *optional* better-than-RCM ordering,
// sprs-ldl/src/lib.rs:148-161); not a full Amestoy–Davis–Duff AMD.
void sprs_min_degree(const int32_t* indptr, const int32_t* indices, int64_t n,
                     int32_t* perm) {
  std::vector<std::vector<int32_t>> adj(static_cast<size_t>(n));
  for (int64_t i = 0; i < n; ++i) {
    for (int32_t p = indptr[i]; p < indptr[i + 1]; ++p) {
      int32_t j = indices[p];
      if (j != i) adj[i].push_back(j);
    }
    std::sort(adj[i].begin(), adj[i].end());
    adj[i].erase(std::unique(adj[i].begin(), adj[i].end()), adj[i].end());
  }
  std::vector<uint8_t> eliminated(static_cast<size_t>(n), 0);
  std::vector<int32_t> tmp;
  for (int64_t step = 0; step < n; ++step) {
    // pick min-degree uneliminated vertex
    int64_t best = -1, best_deg = INT64_MAX;
    for (int64_t v = 0; v < n; ++v) {
      if (eliminated[v]) continue;
      int64_t d = 0;
      for (int32_t u : adj[v])
        if (!eliminated[u]) ++d;
      if (d < best_deg) {
        best_deg = d;
        best = v;
      }
    }
    perm[step] = static_cast<int32_t>(best);
    eliminated[best] = 1;
    // connect the (uneliminated) neighborhood into a clique
    tmp.clear();
    for (int32_t u : adj[best])
      if (!eliminated[u]) tmp.push_back(u);
    for (size_t a = 0; a < tmp.size(); ++a) {
      for (size_t bdx = a + 1; bdx < tmp.size(); ++bdx) {
        int32_t u = tmp[a], w = tmp[bdx];
        if (!std::binary_search(adj[u].begin(), adj[u].end(), w)) {
          adj[u].insert(
              std::lower_bound(adj[u].begin(), adj[u].end(), w), w);
          adj[w].insert(
              std::lower_bound(adj[w].begin(), adj[w].end(), u), u);
        }
      }
    }
  }
}

// Approximate minimum degree ordering (AMD-class).  Clean-room
// implementation of the Amestoy–Davis–Duff algorithm family: quotient
// graph elimination with element absorption, APPROXIMATE external
// degrees (the two-bound formula), supervariable detection by adjacency
// hashing, aggressive element absorption and mass elimination.
// Near-linear in nnz in practice — replaces the exact O(n²+fill)
// sprs_min_degree for the CAMD role (the reference binds SuiteSparse
// CAMD, sprs_suitesparse_camd/src/lib.rs:22-60).
//
// Input: symmetric pattern CSR (diagonal ignored; caller symmetrizes).
// Output: perm[k] = original index eliminated k-th.
void sprs_amd(const int32_t* indptr, const int32_t* indices, int64_t n,
              int32_t* perm) {
  if (n <= 0) return;
  const int64_t N = n;
  // Node state machine: 0 = live variable (supervariable rep),
  // 1 = live element, 2 = absorbed variable, 3 = absorbed element.
  std::vector<std::vector<int32_t>> elist(static_cast<size_t>(n));
  std::vector<std::vector<int32_t>> vlist(static_cast<size_t>(n));
  std::vector<int32_t> nv(static_cast<size_t>(n), 1);
  std::vector<int64_t> deg(static_cast<size_t>(n));
  std::vector<int8_t> state(static_cast<size_t>(n), 0);
  std::vector<int32_t> par(static_cast<size_t>(n), -1);
  std::vector<int64_t> w(static_cast<size_t>(n), -1);    // |Le \ Lp| scratch
  std::vector<int64_t> mark(static_cast<size_t>(n), 0);  // tag scratch
  std::vector<int64_t> elim_step(static_cast<size_t>(n), -1);
  int64_t tag = 0;

  // degree buckets (doubly linked): head[d] for d in [0, N]
  std::vector<int32_t> head(static_cast<size_t>(N + 1), -1);
  std::vector<int32_t> nxt(static_cast<size_t>(n), -1);
  std::vector<int32_t> prv(static_cast<size_t>(n), -1);
  auto bucket_of = [&](int64_t d) {
    return static_cast<size_t>(d < 0 ? 0 : (d > N ? N : d));
  };
  auto deg_insert = [&](int32_t i, int64_t d) {
    size_t h = bucket_of(d);
    nxt[static_cast<size_t>(i)] = head[h];
    prv[static_cast<size_t>(i)] = -1;
    if (head[h] != -1) prv[static_cast<size_t>(head[h])] = i;
    head[h] = i;
  };
  auto deg_remove = [&](int32_t i, int64_t d) {
    size_t h = bucket_of(d);
    int32_t pi = prv[static_cast<size_t>(i)], ni = nxt[static_cast<size_t>(i)];
    if (pi != -1) nxt[static_cast<size_t>(pi)] = ni;
    else head[h] = ni;
    if (ni != -1) prv[static_cast<size_t>(ni)] = pi;
  };

  for (int64_t i = 0; i < n; ++i) {
    auto& vl = vlist[static_cast<size_t>(i)];
    for (int32_t p = indptr[i]; p < indptr[i + 1]; ++p) {
      int32_t j = indices[p];
      if (j != static_cast<int32_t>(i)) vl.push_back(j);
    }
    std::sort(vl.begin(), vl.end());
    vl.erase(std::unique(vl.begin(), vl.end()), vl.end());
    deg[static_cast<size_t>(i)] = static_cast<int64_t>(vl.size());
    deg_insert(static_cast<int32_t>(i), deg[static_cast<size_t>(i)]);
  }

  std::vector<int32_t> Lp, touched, hashed, masseliminated;
  std::vector<int32_t> hash_head(static_cast<size_t>(n), -1);
  std::vector<int32_t> hash_next(static_cast<size_t>(n), -1);

  int64_t mind = 0;
  int64_t k = 0;     // original columns eliminated
  int64_t step = 0;  // pivot count
  while (k < n) {
    while (mind <= N && head[static_cast<size_t>(mind)] == -1) ++mind;
    int32_t p = head[static_cast<size_t>(mind)];
    deg_remove(p, deg[static_cast<size_t>(p)]);

    // ---- form the boundary Lp of the new element p ----
    Lp.clear();
    ++tag;
    mark[static_cast<size_t>(p)] = tag;
    for (int32_t j : vlist[static_cast<size_t>(p)]) {
      if (state[static_cast<size_t>(j)] != 0 || nv[static_cast<size_t>(j)] == 0)
        continue;
      if (mark[static_cast<size_t>(j)] != tag) {
        mark[static_cast<size_t>(j)] = tag;
        Lp.push_back(j);
      }
    }
    for (int32_t e : elist[static_cast<size_t>(p)]) {
      if (state[static_cast<size_t>(e)] != 1) continue;
      for (int32_t j : elist[static_cast<size_t>(e)]) {
        if (state[static_cast<size_t>(j)] != 0 ||
            nv[static_cast<size_t>(j)] == 0)
          continue;
        if (mark[static_cast<size_t>(j)] != tag) {
          mark[static_cast<size_t>(j)] = tag;
          Lp.push_back(j);
        }
      }
      state[static_cast<size_t>(e)] = 3;  // absorbed into p
      std::vector<int32_t>().swap(elist[static_cast<size_t>(e)]);
    }
    state[static_cast<size_t>(p)] = 1;
    std::vector<int32_t>().swap(vlist[static_cast<size_t>(p)]);
    elim_step[static_cast<size_t>(p)] = step;
    int64_t lp_weight = 0;
    for (int32_t j : Lp) lp_weight += nv[static_cast<size_t>(j)];
    int64_t npiv = nv[static_cast<size_t>(p)];

    // ---- w[e] = |Le \ Lp| (weighted) for every element touching Lp;
    //      first touch also compacts Le to live members ----
    touched.clear();
    const int64_t lp_tag = tag;  // Lp membership marker
    for (int32_t i : Lp) {
      for (int32_t e : elist[static_cast<size_t>(i)]) {
        if (state[static_cast<size_t>(e)] != 1) continue;
        if (w[static_cast<size_t>(e)] < 0) {
          auto& le = elist[static_cast<size_t>(e)];
          size_t m = 0;
          int64_t s = 0;
          for (int32_t j : le) {
            if (state[static_cast<size_t>(j)] == 0 &&
                nv[static_cast<size_t>(j)] > 0) {
              le[m++] = j;
              s += nv[static_cast<size_t>(j)];
            }
          }
          le.resize(m);
          w[static_cast<size_t>(e)] = s;
          touched.push_back(e);
        }
        w[static_cast<size_t>(e)] -= nv[static_cast<size_t>(i)];
      }
    }

    // ---- per-member update: prune lists, approximate degree ----
    hashed.clear();
    masseliminated.clear();
    for (int32_t i : Lp) {
      size_t si = static_cast<size_t>(i);
      deg_remove(i, deg[si]);
      // prune vlist: keep live vars outside Lp (inside-Lp adjacency is
      // now represented by element p)
      auto& vl = vlist[si];
      size_t m = 0;
      int64_t avl = 0;
      for (int32_t j : vl) {
        size_t sj = static_cast<size_t>(j);
        if (state[sj] != 0 || nv[sj] == 0) continue;
        if (mark[sj] == lp_tag || j == p) continue;
        vl[m++] = j;
        avl += nv[sj];
      }
      vl.resize(m);
      // prune elist: drop absorbed; aggressive absorption when Le ⊆ Lp
      auto& el = elist[si];
      size_t me = 0;
      int64_t esum = 0;
      for (int32_t e : el) {
        size_t se = static_cast<size_t>(e);
        if (state[se] != 1 || e == p) continue;
        if (w[se] == 0) {
          state[se] = 3;
          std::vector<int32_t>().swap(elist[se]);
          continue;
        }
        el[me++] = e;
        esum += w[se];
      }
      el.resize(me);
      el.push_back(p);
      // Amestoy–Davis–Duff two-bound approximate external degree
      int64_t ext = lp_weight - nv[si];
      int64_t d = deg[si] + ext;              // bound 1: old + new clique
      int64_t d2 = avl + ext + esum;          // bound 2: exact-ish sum
      if (d2 < d) d = d2;
      int64_t cap = n - k - nv[si];
      if (cap < d) d = cap;
      if (d < 0) d = 0;
      deg[si] = d;
      if (d == 0) {
        // mass elimination: i has no connections outside the pivot
        // block — eliminate with p
        state[si] = 2;
        par[si] = p;
        npiv += nv[si];
        masseliminated.push_back(i);
        continue;
      }
      // hash for supervariable detection: sum of pruned adjacency
      uint64_t h = 0;
      for (int32_t e : el) h += static_cast<uint64_t>(e);
      for (int32_t j : vl) h += static_cast<uint64_t>(j);
      int32_t slot = static_cast<int32_t>(h % static_cast<uint64_t>(n));
      hash_next[si] = hash_head[static_cast<size_t>(slot)];
      hash_head[static_cast<size_t>(slot)] = i;
      hashed.push_back(slot);
    }
    for (int32_t i : masseliminated) nv[static_cast<size_t>(i)] = 0;

    // ---- supervariable detection within hash buckets ----
    for (int32_t slot : hashed) {
      size_t ss = static_cast<size_t>(slot);
      int32_t i = hash_head[ss];
      if (i == -1) continue;  // bucket already drained
      while (i != -1) {
        size_t si = static_cast<size_t>(i);
        if (state[si] != 0 || nv[si] == 0) {
          i = hash_next[si];
          continue;
        }
        // mark i's adjacency
        ++tag;
        for (int32_t e : elist[si]) mark[static_cast<size_t>(e)] = tag;
        for (int32_t j : vlist[si]) mark[static_cast<size_t>(j)] = tag;
        int32_t j = hash_next[si];
        while (j != -1) {
          size_t sj = static_cast<size_t>(j);
          int32_t j_next = hash_next[sj];
          if (state[sj] == 0 && nv[sj] > 0 &&
              elist[sj].size() == elist[si].size() &&
              vlist[sj].size() == vlist[si].size()) {
            bool same = true;
            for (int32_t e : elist[sj])
              if (mark[static_cast<size_t>(e)] != tag) {
                same = false;
                break;
              }
            if (same)
              for (int32_t v2 : vlist[sj])
                if (mark[static_cast<size_t>(v2)] != tag) {
                  same = false;
                  break;
                }
            if (same) {
              // merge supervariable j into i; j was external to i and
              // counted in i's approximate degree — remove its weight.
              // (No deg_remove: every Lp member is out of the buckets
              // during this phase; finalize re-inserts survivors only.)
              int32_t nvj = nv[sj];
              nv[si] += nvj;
              nv[sj] = 0;
              state[sj] = 2;
              par[sj] = i;
              deg[si] -= nvj;
            }
          }
          j = j_next;
        }
        i = hash_next[si];
      }
      hash_head[ss] = -1;
    }

    // ---- finalize: rebuild Le(p), re-bucket surviving members ----
    auto& lep = elist[static_cast<size_t>(p)];
    lep.clear();
    for (int32_t i : Lp) {
      size_t si = static_cast<size_t>(i);
      if (state[si] != 0 || nv[si] == 0) continue;
      lep.push_back(i);
      // degree can only have shrunk via merges; clamp and insert
      int64_t d = deg[si];
      int64_t cap = n - k - npiv - nv[si];
      if (cap < d) d = cap;
      if (d < 0) d = 0;
      deg[si] = d;
      deg_insert(i, d);
      if (d < mind) mind = d;
    }
    for (int32_t e : touched) w[static_cast<size_t>(e)] = -1;
    k += npiv;
    nv[static_cast<size_t>(p)] = static_cast<int32_t>(npiv);
    ++step;
  }

  // ---- expand the absorption forest into the final ordering ----
  std::vector<int32_t> root(static_cast<size_t>(n));
  for (int64_t i = 0; i < n; ++i) {
    int32_t r = static_cast<int32_t>(i);
    while (par[static_cast<size_t>(r)] != -1) r = par[static_cast<size_t>(r)];
    // path-compress
    int32_t c = static_cast<int32_t>(i);
    while (par[static_cast<size_t>(c)] != -1) {
      int32_t nx2 = par[static_cast<size_t>(c)];
      par[static_cast<size_t>(c)] = (r == c) ? -1 : r;
      c = nx2;
    }
    root[static_cast<size_t>(i)] = r;
  }
  // stable counting sort by elimination step of the root
  std::vector<int64_t> cnt(static_cast<size_t>(step + 1), 0);
  for (int64_t i = 0; i < n; ++i)
    ++cnt[static_cast<size_t>(elim_step[static_cast<size_t>(
        root[static_cast<size_t>(i)])])];
  std::vector<int64_t> pos(static_cast<size_t>(step + 1), 0);
  for (int64_t s = 1; s <= step; ++s)
    pos[static_cast<size_t>(s)] =
        pos[static_cast<size_t>(s - 1)] + cnt[static_cast<size_t>(s - 1)];
  for (int64_t i = 0; i < n; ++i) {
    int64_t s = elim_step[static_cast<size_t>(root[static_cast<size_t>(i)])];
    perm[pos[static_cast<size_t>(s)]++] = static_cast<int32_t>(i);
  }
}

// Sparse LU with threshold partial pivoting (left-looking
// Gilbert–Peierls).  Native twin of the Python reference in
// sprs_tpu_torch/linalg/lu.py (which mirrors the role of the reference's
// UMFPACK binding, sprs_suitesparse_umfpack/src/lib.rs:48-120).
//
// Input: CSC (indptr/indices/data), n, pivot threshold in [0,1]
// (1 = strict partial pivoting; <1 prefers the diagonal when within
// threshold*colmax).  Output: L CSC with unit diagonal stored first per
// column and off-diagonal rows in pivot-position space; U CSC with rows
// sorted ascending, diagonal last.  perm_r[k] = original row pivoted to
// position k.  cap bounds each of L and U; returns 0 on success, -1 if
// cap is insufficient (caller re-runs with a larger cap), -2 on a
// singular column (err_col set).
int64_t sprs_lu(const int32_t* indptr, const int32_t* indices,
                const double* data, int64_t n, double pivot_threshold,
                int64_t cap, int64_t* l_indptr, int32_t* l_indices,
                double* l_data, int64_t* u_indptr, int32_t* u_indices,
                double* u_data, int32_t* perm_r, int64_t* err_col) {
  std::vector<int64_t> pinv(n, -1);
  std::vector<double> x(n, 0.0);
  std::vector<char> visited(n, 0);
  std::vector<int32_t> topo;
  topo.reserve(n);
  // DFS work stacks (iterative, like the reference's DStack trisolve,
  // trisolve.rs:286-358)
  std::vector<int32_t> st_node;
  std::vector<int64_t> st_it;
  std::vector<std::pair<int64_t, double>> ucol;

  l_indptr[0] = 0;
  u_indptr[0] = 0;
  int64_t lpos = 0, upos = 0;

  for (int64_t k = 0; k < n; ++k) {
    topo.clear();
    // --- symbolic: reach of A[:,k] through pivoted L columns ---------
    for (int64_t p = indptr[k]; p < indptr[k + 1]; ++p) {
      int32_t s = indices[p];
      if (visited[s]) continue;
      visited[s] = 1;
      st_node.assign(1, s);
      st_it.assign(1, 0);
      while (!st_node.empty()) {
        int32_t node = st_node.back();
        int64_t it = st_it.back();
        int64_t j = pinv[node];
        bool pushed = false;
        if (j >= 0) {
          // off-diag entries of L column j (skip stored unit diag)
          int64_t lo = l_indptr[j] + 1, hi = l_indptr[j + 1];
          while (lo + it < hi) {
            int32_t nxt = l_indices[lo + it];
            ++it;
            if (!visited[nxt]) {
              visited[nxt] = 1;
              st_it.back() = it;
              st_node.push_back(nxt);
              st_it.push_back(0);
              pushed = true;
              break;
            }
          }
        }
        if (!pushed) {
          topo.push_back(node);
          st_node.pop_back();
          st_it.pop_back();
        }
      }
    }
    // topo is in reverse topological order; iterate from the back.

    // --- numeric: x = A[:,k]; eliminate pivoted nodes in topo order --
    for (int64_t p = indptr[k]; p < indptr[k + 1]; ++p)
      x[indices[p]] = data[p];
    for (int64_t t = (int64_t)topo.size() - 1; t >= 0; --t) {
      int32_t node = topo[t];
      int64_t j = pinv[node];
      if (j < 0) continue;
      double xj = x[node];
      if (xj == 0.0) continue;
      int64_t lo = l_indptr[j] + 1, hi = l_indptr[j + 1];
      for (int64_t q = lo; q < hi; ++q) x[l_indices[q]] -= l_data[q] * xj;
    }

    // --- pivot selection --------------------------------------------
    double max_abs = 0.0;
    int32_t pivot = -1;
    for (int64_t t = (int64_t)topo.size() - 1; t >= 0; --t) {
      int32_t node = topo[t];
      if (pinv[node] >= 0) continue;
      double a = std::fabs(x[node]);
      if (a > max_abs) {
        max_abs = a;
        pivot = node;
      }
    }
    if (pivot < 0 || max_abs == 0.0) {
      *err_col = k;
      return -2;
    }
    if (pivot_threshold < 1.0 && k < n && pinv[k] < 0 && visited[k] &&
        std::fabs(x[k]) >= pivot_threshold * max_abs)
      pivot = (int32_t)k;
    double pv = x[pivot];
    pinv[pivot] = k;
    perm_r[k] = pivot;

    // --- emit U column (pivoted rows, sorted; diag last) and L column
    ucol.clear();
    int64_t l_start = lpos;
    if (lpos >= cap) return -1;
    l_indices[lpos] = pivot;  // unit diag placeholder (renumbered later)
    l_data[lpos] = 1.0;
    ++lpos;
    for (int64_t t = (int64_t)topo.size() - 1; t >= 0; --t) {
      int32_t node = topo[t];
      visited[node] = 0;
      double v = x[node];
      x[node] = 0.0;
      if (node == pivot || v == 0.0) continue;
      int64_t j = pinv[node];
      if (j >= 0 && j < k) {
        ucol.emplace_back(j, v);
      } else if (j < 0) {
        if (lpos >= cap) {
          // clear remaining marks before bailing
          while (t > 0) {
            --t;
            visited[topo[t]] = 0;
            x[topo[t]] = 0.0;
          }
          return -1;
        }
        l_indices[lpos] = node;  // original row id; renumbered later
        l_data[lpos] = v / pv;
        ++lpos;
      }
    }
    std::sort(ucol.begin(), ucol.end());
    if (upos + (int64_t)ucol.size() + 1 > cap) return -1;
    for (auto& rv : ucol) {
      u_indices[upos] = (int32_t)rv.first;
      u_data[upos] = rv.second;
      ++upos;
    }
    u_indices[upos] = (int32_t)k;
    u_data[upos] = pv;
    ++upos;
    (void)l_start;
    l_indptr[k + 1] = lpos;
    u_indptr[k + 1] = upos;
  }

  // Renumber L's off-diagonal rows into pivot-position space and sort
  // each column's (row, value) pairs (all rows are pivoted by now).
  {
    std::vector<std::pair<int32_t, double>> buf;
    for (int64_t k = 0; k < n; ++k) {
      int64_t lo = l_indptr[k] + 1, hi = l_indptr[k + 1];
      buf.clear();
      for (int64_t q = lo; q < hi; ++q)
        buf.emplace_back((int32_t)pinv[l_indices[q]], l_data[q]);
      std::sort(buf.begin(), buf.end());
      for (int64_t q = lo; q < hi; ++q) {
        l_indices[q] = buf[q - lo].first;
        l_data[q] = buf[q - lo].second;
      }
      l_indices[l_indptr[k]] = (int32_t)k;  // unit diag in pivot space
    }
  }
  return 0;
}


// ILU(0): IKJ incomplete LU restricted to A's own pattern (Saad,
// Iterative Methods 10.3).  CSR with sorted indices; vals updated in
// place to the combined factor (L strictly-lower with implicit unit
// diagonal, U upper incl diagonal).  Returns 0 on success, -1 with
// *bad_row set when a diagonal entry is structurally missing or a
// pivot is exactly zero.
int32_t sprs_ilu0(const int32_t* indptr, const int32_t* indices,
                  double* vals, int64_t n, int64_t* bad_row) {
  std::vector<int64_t> diag(static_cast<size_t>(n), -1);
  for (int64_t i = 0; i < n; ++i) {
    for (int32_t p = indptr[i]; p < indptr[i + 1]; ++p)
      if (indices[p] == i) {
        diag[i] = p;
        break;
      }
    if (diag[i] < 0) {
      *bad_row = i;
      return -1;
    }
  }
  std::vector<int64_t> pos(static_cast<size_t>(n), -1);
  for (int64_t i = 0; i < n; ++i) {
    int32_t lo = indptr[i], hi = indptr[i + 1];
    for (int32_t p = lo; p < hi; ++p) pos[indices[p]] = p;
    for (int32_t p = lo; p < hi; ++p) {
      int32_t k = indices[p];
      if (k >= i) break;
      double ukk = vals[diag[k]];
      if (ukk == 0.0) {
        *bad_row = k;
        return -1;
      }
      double lik = vals[p] / ukk;
      vals[p] = lik;
      for (int64_t s = diag[k] + 1; s < indptr[k + 1]; ++s) {
        int64_t q = pos[indices[s]];
        if (q >= 0) vals[q] -= lik * vals[s];
      }
    }
    for (int32_t p = lo; p < hi; ++p) pos[indices[p]] = -1;
  }
  return 0;
}

// IC(0): zero-fill incomplete Cholesky on the LOWER-triangle pattern
// (CSR lower incl diagonal, sorted, diagonal last per row); vals
// updated in place to L.  Returns 0 on success, -1 with *bad_row set
// on a missing diagonal or non-positive pivot.
int32_t sprs_ic0(const int32_t* indptr, const int32_t* indices,
                 double* vals, int64_t n, int64_t* bad_row) {
  std::vector<int64_t> pos(static_cast<size_t>(n), -1);
  for (int64_t i = 0; i < n; ++i) {
    int32_t lo = indptr[i], hi = indptr[i + 1];
    if (hi == lo || indices[hi - 1] != i) {
      *bad_row = i;
      return -1;
    }
    for (int32_t p = lo; p < hi - 1; ++p) pos[indices[p]] = p;
    for (int32_t p = lo; p < hi - 1; ++p) {
      int32_t k = indices[p];
      double s = 0.0;
      for (int64_t q = indptr[k]; q < indptr[k + 1] - 1; ++q) {
        int64_t r = pos[indices[q]];
        if (r >= 0 && r < p) s += vals[r] * vals[q];
      }
      vals[p] = (vals[p] - s) / vals[indptr[k + 1] - 1];
    }
    double d = vals[hi - 1];
    for (int32_t p = lo; p < hi - 1; ++p) d -= vals[p] * vals[p];
    if (d <= 0.0) {
      *bad_row = i;
      return -1;
    }
    vals[hi - 1] = std::sqrt(d);
    for (int32_t p = lo; p < hi - 1; ++p) pos[indices[p]] = -1;
  }
  return 0;
}

// Gustavson CSR SpGEMM, two-phase (symbolic count + numeric with a
// dense accumulator row) — the same algorithm family as Eigen's
// SparseMatrix product and the reference's SMMP
// (/root/reference/sprs/src/sparse/smmp.rs:81-189).  Serves as the
// second, Eigen-class external baseline in benches/spgemm_bench.py
// (the reference benches against BOTH scipy and Eigen,
// sprs-benches/src/main.rs:27-82).

// Phase 1: per-row output nnz; fills c_indptr (n_rows+1), returns nnz(C).
int64_t sprs_spgemm_count(const int32_t* a_indptr, const int32_t* a_indices,
                          int64_t n_rows, const int32_t* b_indptr,
                          const int32_t* b_indices, int64_t n_cols,
                          int32_t* c_indptr) {
  std::vector<int32_t> mark(static_cast<size_t>(n_cols), -1);
  int64_t nnz = 0;
  c_indptr[0] = 0;
  for (int64_t i = 0; i < n_rows; ++i) {
    int64_t row_nnz = 0;
    for (int32_t p = a_indptr[i]; p < a_indptr[i + 1]; ++p) {
      int32_t k = a_indices[p];
      for (int32_t q = b_indptr[k]; q < b_indptr[k + 1]; ++q) {
        int32_t j = b_indices[q];
        if (mark[j] != static_cast<int32_t>(i)) {
          mark[j] = static_cast<int32_t>(i);
          ++row_nnz;
        }
      }
    }
    nnz += row_nnz;
    c_indptr[i + 1] = static_cast<int32_t>(nnz);
  }
  return nnz;
}

// Phase 2: numeric pass; c_indptr from phase 1, writes sorted column
// indices + values per row.
void sprs_spgemm(const int32_t* a_indptr, const int32_t* a_indices,
                 const double* a_vals, int64_t n_rows,
                 const int32_t* b_indptr, const int32_t* b_indices,
                 const double* b_vals, int64_t n_cols,
                 const int32_t* c_indptr, int32_t* c_indices,
                 double* c_vals) {
  std::vector<double> acc(static_cast<size_t>(n_cols), 0.0);
  std::vector<int32_t> mark(static_cast<size_t>(n_cols), -1);
  std::vector<int32_t> cols;
  cols.reserve(256);
  for (int64_t i = 0; i < n_rows; ++i) {
    cols.clear();
    for (int32_t p = a_indptr[i]; p < a_indptr[i + 1]; ++p) {
      int32_t k = a_indices[p];
      double av = a_vals[p];
      for (int32_t q = b_indptr[k]; q < b_indptr[k + 1]; ++q) {
        int32_t j = b_indices[q];
        if (mark[j] != static_cast<int32_t>(i)) {
          mark[j] = static_cast<int32_t>(i);
          acc[j] = av * b_vals[q];
          cols.push_back(j);
        } else {
          acc[j] += av * b_vals[q];
        }
      }
    }
    std::sort(cols.begin(), cols.end());
    int32_t out = c_indptr[i];
    for (int32_t j : cols) {
      c_indices[out] = j;
      c_vals[out] = acc[j];
      ++out;
    }
  }
}

// Nested-dissection ordering by recursive BFS bisection.  Mirrors
// sprs_tpu_torch/linalg/nd.py::nd_order step for step (sorted/deduped BFS
// level sets = np.unique order, two-sweep pseudo-peripheral start,
// thinnest-separator search in a window around the median level,
// separators emitted post-visit), so the permutation is bit-identical
// to the numpy fallback.  Input must be a symmetric pattern (caller
// symmetrizes).  Writes the order (position -> old index) into
// order_out; returns the number of vertices emitted (== n on success).
int64_t sprs_nd_order(const int32_t* indptr, const int32_t* indices,
                      int64_t n, int64_t leaf_size, double balance_window,
                      int32_t* order_out) {
  if (n <= 0) return 0;
  std::vector<int64_t> level(static_cast<size_t>(n), -1);
  std::vector<uint8_t> in_sub(static_cast<size_t>(n), 0);
  std::vector<uint8_t> mark(static_cast<size_t>(n), 0);
  struct Item {
    int tag;  // 0 = visit, 1 = emit
    std::vector<int32_t> verts;
  };
  std::vector<Item> stack;
  {
    std::vector<int32_t> all(static_cast<size_t>(n));
    for (int64_t i = 0; i < n; ++i) all[i] = static_cast<int32_t>(i);
    stack.push_back({0, std::move(all)});
  }
  int64_t out_pos = 0;

  std::vector<std::vector<int32_t>> levels;
  std::vector<int32_t> front, nxt;
  auto bfs = [&](int32_t seed) {
    levels.clear();
    front.assign(1, seed);
    level[seed] = 0;
    int64_t ln = 0;
    while (!front.empty()) {
      levels.push_back(front);
      nxt.clear();
      for (int32_t v : front) {
        for (int32_t p = indptr[v]; p < indptr[v + 1]; ++p) {
          int32_t u = indices[p];
          if (in_sub[u] && level[u] < 0) {
            level[u] = ln + 1;
            nxt.push_back(u);
          }
        }
      }
      std::sort(nxt.begin(), nxt.end());
      ++ln;
      front.swap(nxt);
    }
  };
  auto reset_levels = [&]() {
    for (auto& lv : levels)
      for (int32_t v : lv) level[v] = -1;
  };

  while (!stack.empty()) {
    Item it = std::move(stack.back());
    stack.pop_back();
    std::vector<int32_t>& verts = it.verts;
    const int64_t m = static_cast<int64_t>(verts.size());
    if (it.tag == 1 || m <= leaf_size) {
      std::copy(verts.begin(), verts.end(), order_out + out_pos);
      out_pos += m;
      continue;
    }
    for (int32_t v : verts) in_sub[v] = 1;
    // two-sweep pseudo-peripheral BFS
    bfs(verts[0]);
    int32_t far = levels.back()[0];
    reset_levels();
    bfs(far);
    int64_t visited = 0;
    for (auto& lv : levels) visited += static_cast<int64_t>(lv.size());
    reset_levels();
    if (visited < m) {
      // disconnected: component splits off with an empty separator
      std::vector<int32_t> comp;
      comp.reserve(static_cast<size_t>(visited));
      for (auto& lv : levels)
        for (int32_t v : lv) {
          comp.push_back(v);
          mark[v] = 1;
        }
      std::vector<int32_t> rest;
      rest.reserve(static_cast<size_t>(m - visited));
      for (int32_t v : verts) {
        if (!mark[v]) rest.push_back(v);
        in_sub[v] = 0;
      }
      for (int32_t v : comp) mark[v] = 0;
      stack.push_back({0, std::move(rest)});
      stack.push_back({0, std::move(comp)});
      continue;
    }
    for (int32_t v : verts) in_sub[v] = 0;
    const int64_t L = static_cast<int64_t>(levels.size());
    if (L < 3) {
      // ball-shaped (diameter < 2): no useful separator
      std::copy(verts.begin(), verts.end(), order_out + out_pos);
      out_pos += m;
      continue;
    }
    std::vector<int64_t> csize(static_cast<size_t>(L));
    int64_t run = 0;
    for (int64_t i = 0; i < L; ++i) {
      run += static_cast<int64_t>(levels[i].size());
      csize[i] = run;
    }
    // np.searchsorted side='left': first i with csize[i] >= x
    auto searchsorted = [&](int64_t x) -> int64_t {
      return static_cast<int64_t>(
          std::lower_bound(csize.begin(), csize.end(), x) - csize.begin());
    };
    const int64_t half = m / 2;
    const int64_t lmed = searchsorted(half);
    const int64_t win =
        std::max<int64_t>(1, static_cast<int64_t>(m * balance_window));
    int64_t lo = searchsorted(std::max<int64_t>(half - win, 1));
    int64_t hi = searchsorted(std::min<int64_t>(half + win, m - 1));
    lo = std::max<int64_t>(lo, 1);
    hi = std::min(std::max(hi, lo), L - 2);
    int64_t cut;
    if (hi >= lo) {
      int64_t best = lo;
      for (int64_t i = lo + 1; i <= hi; ++i)
        if (static_cast<int64_t>(levels[i].size()) <
            static_cast<int64_t>(levels[best].size()))
          best = i;
      cut = best;
    } else {
      cut = lmed;
    }
    cut = std::min(std::max<int64_t>(cut, 1), L - 2);
    std::vector<int32_t> a, b;
    for (int64_t i = 0; i < cut; ++i)
      a.insert(a.end(), levels[i].begin(), levels[i].end());
    for (int64_t i = cut + 1; i < L; ++i)
      b.insert(b.end(), levels[i].begin(), levels[i].end());
    stack.push_back({1, std::move(levels[static_cast<size_t>(cut)])});
    stack.push_back({0, std::move(b)});
    stack.push_back({0, std::move(a)});
  }
  return out_pos;
}

}  // extern "C"
