// Native multilevel k-way graph partitioner.
//
// TPU-native replacement for the METIS C library the reference reaches
// through its customized DGL fork (reference helper/utils.py:132-144,
// README.md:62 — the fork exists only to pass objtype='vol'|'cut' through
// to METIS). Same role, same objective surface:
//
//   objective = 0 ('cut')  minimize edges crossing partitions
//   objective = 1 ('vol')  minimize communication volume: distinct
//                          (node, foreign-partition) halo pairs — the
//                          quantity PipeGCN-style training exchanges
//                          every layer.
//
// Classic multilevel scheme (Karypis & Kumar style, independent
// implementation):
//   1. coarsen by randomized heavy-edge matching, accumulating edge and
//      node weights, until the graph is small;
//   2. initial k-way partition on the coarsest graph: BFS-grown
//      contiguous blocks balanced by node weight;
//   3. uncoarsen, at every level running boundary FM-style refinement:
//      greedy positive-gain moves under a node-weight balance cap, with
//      the gain formula matching the requested objective.
//
// Deterministic for a fixed seed. Single-threaded C++17, no deps.
//
// C API (ctypes-friendly): pgt_partition() at the bottom.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <numeric>
#include <queue>
#include <random>
#include <tuple>
#include <vector>

namespace {

// Non-owning CSR view: the finest level aliases the CALLER's arrays
// (no 12.8 GB indices copy at papers100M scale) with IMPLICIT unit
// edge/node weights (null pointers — no 25.6 GB all-ones ewgt).
// Coarse levels own int32 weights (a merged weight is bounded by the
// fine edges merged into it, far below 2^31 in practice; saturated on
// overflow in coarsen()).
struct CsrView {
  int64_t n = 0;
  const int64_t* indptr = nullptr;   // [n+1]
  const int32_t* indices = nullptr;  // [m]
  const int32_t* ewgt = nullptr;     // [m]; null => all edges weight 1
  const int32_t* nwgt = nullptr;     // [n]; null => all nodes weight 1
  int64_t m() const { return indptr[n]; }
};

inline int64_t ew(const CsrView& g, int64_t e) {
  return g.ewgt ? (int64_t)g.ewgt[e] : 1;
}
inline int64_t nw(const CsrView& g, int64_t u) {
  return g.nwgt ? (int64_t)g.nwgt[u] : 1;
}

struct Csr {
  int64_t n = 0;
  std::vector<int64_t> indptr;   // [n+1]
  std::vector<int32_t> indices;  // [m] neighbor ids
  std::vector<int32_t> ewgt;     // [m] edge weights
  std::vector<int32_t> nwgt;     // [n] node weights

  CsrView view() const {
    return {n, indptr.data(), indices.data(), ewgt.data(), nwgt.data()};
  }
};

// ---------------------------------------------------------------------
// Coarsening: randomized heavy-edge matching.

// Build the coarse graph induced by a fine->coarse map: aggregate
// parallel edges, drop (coarse) self loops. Shared by incremental
// coarsening AND the uncoarsening-time rebuild of unstored levels
// (contract(level0, composed map) reproduces level i exactly — edge
// weights aggregate additively along map composition).
Csr contract(const CsrView& g, const int32_t* map, int64_t nc) {
  const int64_t n = g.n;
  Csr c;
  c.n = nc;
  c.nwgt.assign(nc, 0);
  for (int64_t u = 0; u < n; ++u) {
    int64_t w = (int64_t)c.nwgt[map[u]] + nw(g, u);
    c.nwgt[map[u]] = (int32_t)std::min<int64_t>(w, INT32_MAX);
  }

  // count then fill, merging duplicates with a per-node scratch table
  std::vector<int64_t> scratch_w(nc, 0);
  std::vector<int32_t> scratch_nbr;
  scratch_nbr.reserve(256);

  // two passes over fine edges grouped by coarse node; build fine-node
  // lists per coarse node first
  std::vector<int64_t> cstart(nc + 1, 0);
  for (int64_t u = 0; u < n; ++u) cstart[map[u] + 1]++;
  for (int64_t i = 0; i < nc; ++i) cstart[i + 1] += cstart[i];
  std::vector<int32_t> members(n);
  {
    std::vector<int64_t> cur(cstart.begin(), cstart.end() - 1);
    for (int64_t u = 0; u < n; ++u) members[cur[map[u]]++] = (int32_t)u;
  }

  c.indptr.assign(nc + 1, 0);
  // pass 1: count distinct coarse neighbors
  for (int64_t cu = 0; cu < nc; ++cu) {
    scratch_nbr.clear();
    for (int64_t mi = cstart[cu]; mi < cstart[cu + 1]; ++mi) {
      int32_t u = members[mi];
      for (int64_t e = g.indptr[u]; e < g.indptr[u + 1]; ++e) {
        int32_t cv = map[g.indices[e]];
        if (cv == cu) continue;
        if (scratch_w[cv] == 0) scratch_nbr.push_back(cv);
        scratch_w[cv] += ew(g, e);
      }
    }
    c.indptr[cu + 1] = c.indptr[cu] + (int64_t)scratch_nbr.size();
    for (int32_t cv : scratch_nbr) scratch_w[cv] = 0;
  }
  c.indices.resize(c.indptr[nc]);
  c.ewgt.resize(c.indptr[nc]);
  // pass 2: fill
  for (int64_t cu = 0; cu < nc; ++cu) {
    scratch_nbr.clear();
    for (int64_t mi = cstart[cu]; mi < cstart[cu + 1]; ++mi) {
      int32_t u = members[mi];
      for (int64_t e = g.indptr[u]; e < g.indptr[u + 1]; ++e) {
        int32_t cv = map[g.indices[e]];
        if (cv == cu) continue;
        if (scratch_w[cv] == 0) scratch_nbr.push_back(cv);
        scratch_w[cv] += ew(g, e);
      }
    }
    int64_t pos = c.indptr[cu];
    for (int32_t cv : scratch_nbr) {
      c.indices[pos] = cv;
      c.ewgt[pos] =
          (int32_t)std::min<int64_t>(scratch_w[cv], INT32_MAX);
      scratch_w[cv] = 0;
      ++pos;
    }
  }
  return c;
}

// Returns coarse graph + mapping fine node -> coarse node.
Csr coarsen(const CsrView& g, std::mt19937_64& rng,
            std::vector<int32_t>& map) {
  const int64_t n = g.n;
  map.assign(n, -1);
  std::vector<int32_t> order(n);
  std::iota(order.begin(), order.end(), 0);
  std::shuffle(order.begin(), order.end(), rng);

  // heavy-edge matching: visit nodes in random order, match each
  // unmatched node with its unmatched neighbor of max edge weight
  int32_t nc = 0;
  std::vector<int32_t> match(n, -1);
  for (int64_t i = 0; i < n; ++i) {
    int32_t u = order[i];
    if (match[u] != -1) continue;
    int32_t best = -1;
    int64_t best_w = -1;
    for (int64_t e = g.indptr[u]; e < g.indptr[u + 1]; ++e) {
      int32_t v = g.indices[e];
      if (v == u || match[v] != -1) continue;
      if (ew(g, e) > best_w) { best_w = ew(g, e); best = v; }
    }
    match[u] = (best == -1) ? u : best;
    if (best != -1) match[best] = u;
    map[u] = nc;
    if (best != -1) map[best] = nc;
    ++nc;
  }

  // Cluster pass (HEM* — what METIS does when plain HEM stalls): on
  // hub-heavy graphs most of a hub's neighbors are already matched by
  // the time the sweep reaches them, leaving singleton coarse nodes
  // and a ~0.75 shrink per level, i.e. ~2x the levels and ~2x the
  // refinement work and hierarchy RAM. Let leftover singletons join a
  // neighbor's coarse node (heaviest edge) up to 4 fine members, which
  // restores ~0.5 shrink. Renumber coarse ids densely afterwards.
  {
    std::vector<int32_t> csize(nc, 0);
    for (int64_t u = 0; u < n; ++u) csize[map[u]]++;
    for (int64_t i = 0; i < n; ++i) {
      int32_t u = order[i];
      if (match[u] != u || csize[map[u]] != 1) continue;  // not singleton
      int32_t best = -1;
      int64_t best_w = -1;
      for (int64_t e = g.indptr[u]; e < g.indptr[u + 1]; ++e) {
        int32_t v = g.indices[e];
        if (v == u || map[v] == map[u] || csize[map[v]] >= 4) continue;
        if (ew(g, e) > best_w) { best_w = ew(g, e); best = v; }
      }
      if (best != -1) {
        csize[map[u]]--;
        map[u] = map[best];
        csize[map[u]]++;
      }
    }
    std::vector<int32_t> renum(nc, -1);
    int32_t dense = 0;
    for (int64_t u = 0; u < n; ++u) {
      if (renum[map[u]] == -1) renum[map[u]] = dense++;
      map[u] = renum[map[u]];
    }
    nc = dense;
  }

  return contract(g, map.data(), nc);
}

// ---------------------------------------------------------------------
// Initial partition on the coarsest graph: BFS order, contiguous blocks
// balanced by node weight.

void initial_partition(const CsrView& g, int32_t k, std::mt19937_64& rng,
                       std::vector<int32_t>& parts) {
  const int64_t n = g.n;
  parts.assign(n, 0);
  std::vector<int32_t> order;
  order.reserve(n);
  std::vector<char> visited(n, 0);
  std::vector<int32_t> restart(n);
  std::iota(restart.begin(), restart.end(), 0);
  std::shuffle(restart.begin(), restart.end(), rng);
  int64_t cursor = 0;
  std::vector<int32_t> queue;
  while ((int64_t)order.size() < n) {
    while (cursor < n && visited[restart[cursor]]) ++cursor;
    int32_t s = restart[cursor];
    visited[s] = 1;
    queue.assign(1, s);
    size_t qh = 0;
    order.push_back(s);
    while (qh < queue.size()) {
      int32_t u = queue[qh++];
      for (int64_t e = g.indptr[u]; e < g.indptr[u + 1]; ++e) {
        int32_t v = g.indices[e];
        if (!visited[v]) {
          visited[v] = 1;
          queue.push_back(v);
          order.push_back(v);
        }
      }
    }
  }
  int64_t total_w = 0;
  for (int64_t u = 0; u < n; ++u) total_w += nw(g, u);
  // walk the BFS order filling part 0, then 1, ... by weight quota
  int64_t acc = 0;
  for (int64_t i = 0; i < n; ++i) {
    int32_t p = (int32_t)std::min<int64_t>((acc * k) / std::max<int64_t>(total_w, 1),
                                           k - 1);
    parts[order[i]] = p;
    acc += nw(g, order[i]);
  }
}

// ---------------------------------------------------------------------
// Refinement: FM-style greedy boundary passes.
//
// For 'cut', gain(u, p) = w(u->p) - w(u->own).
// For 'vol', add the change in distinct halo pairs: moving u to p removes
// the (u, p) pair, creates a (u, own) pair if u keeps neighbors there —
// approximated (as in the Python refiner) with indicator terms
// [w(u->p) > 0] - [w(u->own) > 0]; neighbor-side pair changes are second
// order and ignored.

// One definition of the balance cap and the per-move gain, shared by
// the greedy and FM phases — two copies would let them silently
// enforce different caps/objectives in the same refinement loop.
int64_t balance_cap(const CsrView& g, int32_t k, double imbalance) {
  int64_t total_w = 0;
  for (int64_t u = 0; u < g.n; ++u) total_w += nw(g, u);
  return (int64_t)(imbalance * (double)((total_w + k - 1) / k)) + 1;
}

inline int64_t move_gain(int64_t conn_p, int64_t conn_own, int objective) {
  int64_t gain = conn_p - conn_own;
  if (objective == 1)
    gain += (conn_p > 0 ? 1 : 0) - (conn_own > 0 ? 1 : 0);
  return gain;
}

void refine(const CsrView& g, int32_t k, int objective, int iters,
            double imbalance, std::vector<int32_t>& parts,
            std::mt19937_64& rng) {
  const int64_t n = g.n;
  const int64_t cap = balance_cap(g, k, imbalance);

  std::vector<int64_t> psize(k, 0);
  for (int64_t u = 0; u < n; ++u) psize[parts[u]] += nw(g, u);

  std::vector<int64_t> conn(k, 0);  // edge weight to each part, per node
  std::vector<int32_t> touched;
  touched.reserve(64);
  std::vector<int32_t> order(n);
  std::iota(order.begin(), order.end(), 0);

  for (int it = 0; it < iters; ++it) {
    std::shuffle(order.begin(), order.end(), rng);
    int64_t moved = 0;
    for (int64_t i = 0; i < n; ++i) {
      int32_t u = order[i];
      int32_t pu = parts[u];
      if (psize[pu] - nw(g, u) <= 0) continue;  // never drain a part
      touched.clear();
      bool boundary = false;
      for (int64_t e = g.indptr[u]; e < g.indptr[u + 1]; ++e) {
        int32_t pv = parts[g.indices[e]];
        if (conn[pv] == 0) touched.push_back(pv);
        conn[pv] += ew(g, e);
        if (pv != pu) boundary = true;
      }
      if (boundary) {
        int64_t own = conn[pu];
        int64_t best_gain = 0;
        int32_t best_p = -1;
        for (int32_t p : touched) {
          if (p == pu || psize[p] + nw(g, u) > cap) continue;
          int64_t gain = move_gain(conn[p], own, objective);
          if (gain > best_gain ||
              (gain == best_gain && best_p != -1 && psize[p] < psize[best_p])) {
            best_gain = gain;
            best_p = p;
          }
        }
        if (best_p != -1 && best_gain > 0) {
          psize[pu] -= nw(g, u);
          psize[best_p] += nw(g, u);
          parts[u] = best_p;
          ++moved;
        }
      }
      for (int32_t p : touched) conn[p] = 0;
    }
    if (moved == 0) break;
  }
}

// True objective value of a partition: 'cut' counts each crossing edge
// twice (symmetric CSR) — consistent for comparisons; 'vol' counts
// distinct (node, foreign-part) halo pairs.
int64_t eval_objective(const CsrView& g, int32_t k, int objective,
                       const std::vector<int32_t>& parts) {
  int64_t obj = 0;
  std::vector<char> seen(k, 0);
  std::vector<int32_t> touched;
  touched.reserve(64);
  for (int64_t u = 0; u < g.n; ++u) {
    int32_t pu = parts[u];
    for (int64_t e = g.indptr[u]; e < g.indptr[u + 1]; ++e) {
      int32_t pv = parts[g.indices[e]];
      if (pv == pu) continue;
      if (objective == 0) {
        obj += ew(g, e);
      } else if (!seen[pv]) {
        seen[pv] = 1;
        touched.push_back(pv);
        ++obj;
      }
    }
    for (int32_t p : touched) seen[p] = 0;
    touched.clear();
  }
  return obj;
}

// ---------------------------------------------------------------------
// FM-style hill climbing: unlike the greedy pass, moves may have
// NEGATIVE gain — the pass tracks the cumulative objective delta,
// remembers the best prefix of the move sequence, and rolls back
// everything after it. This is what lets the partition escape the
// local minima the greedy pass terminates in (the classic
// Fiduccia–Mattheyses ingredient METIS-grade refinement relies on).
// Lazy max-heap with per-node version stamps; moved nodes lock for the
// pass. Returns true if the pass improved the objective.

bool fm_pass(const CsrView& g, int32_t k, int objective, int64_t cap,
             std::vector<int64_t>& psize, std::vector<int32_t>& parts,
             bool eager) {
  const int64_t n = g.n;
  // consecutive non-improving moves tolerated before the pass stops —
  // bounds both wasted work and rollback length
  const int max_drift = 512;

  std::vector<int64_t> conn(k, 0);
  std::vector<int32_t> touched;
  touched.reserve(64);

  // best (gain, target) for u under the balance cap; target -1 if none
  auto best_move = [&](int32_t u, int64_t& gain_out) -> int32_t {
    int32_t pu = parts[u];
    if (psize[pu] - nw(g, u) <= 0) return -1;
    touched.clear();
    for (int64_t e = g.indptr[u]; e < g.indptr[u + 1]; ++e) {
      int32_t pv = parts[g.indices[e]];
      if (conn[pv] == 0) touched.push_back(pv);
      conn[pv] += ew(g, e);
    }
    int64_t own = conn[pu];
    int64_t best_gain = INT64_MIN;
    int32_t best_p = -1;
    for (int32_t p : touched) {
      if (p == pu || psize[p] + nw(g, u) > cap) continue;
      int64_t gain = move_gain(conn[p], own, objective);
      if (gain > best_gain) {
        best_gain = gain;
        best_p = p;
      }
    }
    for (int32_t p : touched) conn[p] = 0;
    gain_out = best_gain;
    return best_p;
  };

  // heap entries: (gain, node, target, version). Stale entries are
  // skipped on pop via the version stamp; gains are CACHED per node
  // (last_gain/last_p) so a neighbor invalidation is an O(log) push of
  // the stale value, not an O(deg) recompute — the true gain is
  // recomputed lazily only when the entry surfaces at the top.
  using Entry = std::tuple<int64_t, int32_t, int32_t, uint32_t>;
  std::priority_queue<Entry> heap;
  std::vector<uint32_t> ver(n, 0);
  std::vector<char> locked(n, 0);
  std::vector<int64_t> last_gain(n, INT64_MIN);
  std::vector<int32_t> last_p(n, -1);

  for (int64_t u = 0; u < n; ++u) {
    bool boundary = false;
    int32_t pu = parts[u];
    for (int64_t e = g.indptr[u]; e < g.indptr[u + 1] && !boundary; ++e)
      boundary = parts[g.indices[e]] != pu;
    if (!boundary) continue;
    int64_t gain;
    int32_t p = best_move((int32_t)u, gain);
    if (p != -1) {
      last_gain[u] = gain;
      last_p[u] = p;
      heap.emplace(gain, (int32_t)u, p, 0u);
    }
  }

  std::vector<std::pair<int32_t, int32_t>> moves;  // (node, from)
  int64_t cum = 0, best_cum = 0;
  size_t best_len = 0;
  int drift = 0;

  while (!heap.empty() && drift < max_drift) {
    auto [gain, u, p, stamp] = heap.top();
    heap.pop();
    if (locked[u] || stamp != ver[u]) continue;
    // entry may predate neighbor moves: recompute before trusting it
    int64_t fresh_gain;
    int32_t fresh_p = best_move(u, fresh_gain);
    if (fresh_p == -1) continue;
    if (fresh_gain != gain || fresh_p != p) {
      last_gain[u] = fresh_gain;
      last_p[u] = fresh_p;
      heap.emplace(fresh_gain, u, fresh_p, ver[u]);
      continue;
    }
    int32_t pu = parts[u];
    psize[pu] -= nw(g, u);
    psize[p] += nw(g, u);
    parts[u] = p;
    locked[u] = 1;
    moves.emplace_back(u, pu);
    cum += fresh_gain;
    if (cum > best_cum) {
      best_cum = cum;
      best_len = moves.size();
      drift = 0;
    } else {
      ++drift;
    }
    for (int64_t e = g.indptr[u]; e < g.indptr[u + 1]; ++e) {
      int32_t v = g.indices[e];
      if (locked[v]) continue;
      ++ver[v];
      if (eager) {
        // exact gains keep the hill-climb chains honest — measurably
        // better on mesh-like graphs, O(deg) per neighbor
        int64_t vg;
        int32_t vp = best_move(v, vg);
        if (vp != -1) {
          last_gain[v] = vg;
          last_p[v] = vp;
          heap.emplace(vg, v, vp, ver[v]);
        }
        continue;
      }
      // stale cached gain; corrected lazily on pop. A node never seen
      // on the boundary enters with its neighbor-count as an optimistic
      // upper bound so it gets examined once.
      int64_t vg = last_gain[v] != INT64_MIN
                       ? last_gain[v]
                       : g.indptr[v + 1] - g.indptr[v];
      int32_t vp = last_p[v] != -1 ? last_p[v] : parts[u];
      heap.emplace(vg, v, vp, ver[v]);
    }
  }

  // roll back everything after the best prefix
  for (size_t i = moves.size(); i > best_len; --i) {
    auto [u, from] = moves[i - 1];
    psize[parts[u]] -= nw(g, u);
    psize[from] += nw(g, u);
    parts[u] = from;
  }
  return best_cum > 0;
}

void fm_refine(const CsrView& g, int32_t k, int objective, double imbalance,
               std::vector<int32_t>& parts, int max_passes = 8) {
  // Cost/quality ladder by level size: exact (eager) neighbor gains on
  // small graphs, lazy cached gains in the mid range, and no FM at all
  // on billion-edge levels — there the greedy passes carry refinement
  // and the quality-critical decisions were already made on the
  // coarser levels (where FM did run).
  const int64_t m = g.m();
  const int64_t eager_edge_cap = 1'000'000;
  const int64_t fm_edge_cap = 200'000'000;
  if (m > fm_edge_cap) return;
  // eager neighbor updates cost O(deg^2) per move — only worth it on
  // sparse mesh-like graphs, where exact gains measurably improve the
  // hill-climb (grid probe: 1.07x vs 1.72x of the optimal bisection)
  const bool eager = m <= eager_edge_cap && m <= 16 * g.n;
  const int64_t cap = balance_cap(g, k, imbalance);
  std::vector<int64_t> psize(k, 0);
  for (int64_t u = 0; u < g.n; ++u) psize[parts[u]] += nw(g, u);
  for (int pass = 0; pass < max_passes; ++pass)
    if (!fm_pass(g, k, objective, cap, psize, parts, eager)) break;
}

void ensure_nonempty(const CsrView& g, int32_t k, std::vector<int32_t>& parts) {
  std::vector<int64_t> count(k, 0);
  for (int64_t u = 0; u < g.n; ++u) count[parts[u]]++;
  for (int32_t p = 0; p < k; ++p) {
    if (count[p] > 0) continue;
    int32_t donor =
        (int32_t)(std::max_element(count.begin(), count.end()) - count.begin());
    for (int64_t u = 0; u < g.n; ++u) {
      if (parts[u] == donor) {
        parts[u] = p;
        count[donor]--;
        count[p]++;
        break;
      }
    }
  }
}

}  // namespace

extern "C" {

// Partition a symmetric CSR graph (no self loops required; they are
// ignored) into n_parts. Writes int32 partition ids to out_parts[n].
// Returns 0 on success.
int pgt_partition(int64_t n, const int64_t* indptr, const int32_t* indices,
                  int32_t n_parts, int objective, uint64_t seed,
                  double imbalance, int refine_iters, int32_t* out_parts) {
  if (n <= 0 || n_parts <= 0) return 1;
  if (n_parts == 1) {
    std::memset(out_parts, 0, sizeof(int32_t) * (size_t)n);
    return 0;
  }
  std::mt19937_64 rng(seed);

  // the FINEST level is a zero-copy view of the caller's arrays with
  // implicit unit weights — at papers100M scale the old copy +
  // materialized all-ones int64 weights cost ~40 GB by themselves.
  const CsrView fine_view{n, indptr, indices, nullptr, nullptr};

  // The hierarchy is NOT kept in RAM wholesale: on low-locality graphs
  // coarse edge counts barely shrink for many levels (~2.6 GB/level at
  // 1/10-papers scale, 30+ GB total — the measured round-4 peak).
  // Instead, only levels at or below SPILL_EDGES are stored; a larger
  // level keeps just its composed level0->level map (n int32) and is
  // REBUILT by contract(level0, composed map) when uncoarsening
  // reaches it — exact reconstruction, O(E0) per rebuilt level.
  const int64_t SPILL_EDGES = 50'000'000;
  struct LevelInfo {
    std::vector<int32_t> map;   // level i-1 node -> level i node
    Csr graph;                  // owned iff stored
    bool stored = false;
    std::vector<int32_t> cmap;  // level 0 -> level i (iff !stored)
    int64_t n = 0;
  };
  std::vector<LevelInfo> levels;  // levels[i] describes level i+1

  const int64_t target = std::max<int64_t>((int64_t)n_parts * 16, 512);
  const bool verbose = std::getenv("PIPEGCN_PART_VERBOSE") != nullptr;
  // `current` holds the working graph ONLY while levels are unstored;
  // once a level fits SPILL_EDGES its graph moves into the hierarchy
  // (coarse edge counts are non-increasing, so every deeper level is
  // stored too and the level0->level composition can stop)
  Csr current;
  std::vector<int32_t> cur_cmap;
  while ((levels.empty() ? n : levels.back().n) > target) {
    const CsrView gv =
        levels.empty() ? fine_view
        : (levels.back().stored ? levels.back().graph.view()
                                : current.view());
    std::vector<int32_t> map;
    Csr c = coarsen(gv, rng, map);
    if (c.n > (int64_t)(0.95 * (double)gv.n)) break;  // stalled
    LevelInfo li;
    li.n = c.n;
    li.stored = c.indptr[c.n] <= SPILL_EDGES;
    if (!li.stored) {
      if (levels.empty()) {
        cur_cmap = map;
      } else {
        for (int64_t u = 0; u < n; ++u) cur_cmap[u] = map[cur_cmap[u]];
      }
      li.cmap = cur_cmap;
    } else {
      std::vector<int32_t>().swap(cur_cmap);  // composition is done
    }
    li.map = std::move(map);
    if (verbose)
      std::fprintf(stderr,
                   "# level %zu: n=%lld m=%lld (%.2f GB, %s)\n",
                   levels.size() + 1, (long long)c.n,
                   (long long)c.indptr[c.n],
                   (double)(c.indptr[c.n] * 8 + c.n * 16) / 1e9,
                   li.stored ? "stored" : "rebuilt on demand");
    if (li.stored) {
      li.graph = std::move(c);
      current = Csr();
      levels.push_back(std::move(li));
    } else {
      levels.push_back(std::move(li));
      current = std::move(c);  // frees the previous working graph
    }
  }

  // initial partition at the coarsest level: the coarse graph is tiny,
  // so run several independent BFS-seeded attempts (METIS-style
  // multi-start) and keep the best refined one by the true objective
  std::vector<int32_t> parts;
  {
    const CsrView coarsest =
        levels.empty() ? fine_view
        : (levels.back().stored ? levels.back().graph.view()
                                : current.view());
    // multi-start assumes a TINY coarsest graph; when coarsening
    // stalls early (low-locality graphs), each try still sweeps the
    // full edge set through refine — scale the tries down with size
    // so initial partitioning stays a minor phase
    const int64_t cm = coarsest.m();
    const int tries = cm > 1'000'000'000 ? 2
                      : cm > 100'000'000 ? 4 : 8;
    int64_t best_obj = INT64_MAX;
    std::vector<int32_t> cand;
    for (int t = 0; t < tries; ++t) {
      initial_partition(coarsest, n_parts, rng, cand);
      refine(coarsest, n_parts, objective, refine_iters, imbalance,
             cand, rng);
      fm_refine(coarsest, n_parts, objective, imbalance, cand);
      int64_t obj = eval_objective(coarsest, n_parts, objective, cand);
      if (obj < best_obj) {
        best_obj = obj;
        parts = cand;
      }
    }
  }
  current = Csr();  // coarsest graph is done; free before uncoarsening

  // uncoarsen with refinement at every level: greedy positive-gain
  // passes first (cheap, bulk moves), then FM hill-climbing to escape
  // the greedy local minimum. `j` is the level being refined; its
  // graph is the fine view (j==0), the stored copy, or an on-demand
  // exact rebuild — at most ONE big level is live at any moment.
  for (int64_t j = (int64_t)levels.size() - 1; j >= 0; --j) {
    {
      const std::vector<int32_t>& map = levels[j].map;
      std::vector<int32_t> fine((int64_t)map.size());
      for (int64_t u = 0; u < (int64_t)map.size(); ++u)
        fine[u] = parts[map[u]];
      parts = std::move(fine);
    }
    // everything describing level j+1 is consumed: free the
    // projection map (and its graph below) before refining the
    // bigger, finer level
    std::vector<int32_t>().swap(levels[j].map);
    Csr rebuilt;
    CsrView gv;
    if (j == 0) {
      gv = fine_view;
    } else if (levels[j - 1].stored) {
      gv = levels[j - 1].graph.view();
    } else {
      rebuilt = contract(fine_view, levels[j - 1].cmap.data(),
                         levels[j - 1].n);
      std::vector<int32_t>().swap(levels[j - 1].cmap);
      gv = rebuilt.view();
    }
    refine(gv, n_parts, objective, refine_iters, imbalance, parts, rng);
    fm_refine(gv, n_parts, objective, imbalance, parts);
    if (j > 0) levels[j - 1].graph = Csr();  // consumed
  }

  ensure_nonempty(fine_view, n_parts, parts);
  std::memcpy(out_parts, parts.data(), sizeof(int32_t) * (size_t)n);
  return 0;
}

}  // extern "C"
