// Host graph-construction routines of ggad_tpu_torch, bound with ctypes by
// ggad_tpu_torch/native.py (the port's own copy of the JAX package's
// native/graphbuild.cpp; the arithmetic and the generators are the same,
// so both give equal arrays and equal partitions).
//
// The host-side steps that dominate graph preparation at DGraph scale
// (73M edges) and in the halo path's partitioner:
//
//   * gg_sort_coo     — lexicographic (row, col) edge sort (stable)
//   * gg_symmetrize   — A := max(A, A^T) union-symmetrization (dedup)
//   * gg_coalesce     — sum duplicate (row, col) entries
//   * gg_build_indptr — CSR row pointers from sorted rows
//   * gg_sym_normalize— D^-1/2 A D^-1/2 edge values
//   * gg_bcsr_count / gg_bcsr_fill — 128x128 tile-COO construction for
//     the BCSR SpMM kernel
//   * gg_sample_neighbors — fixed-fanout uniform neighbor sampling into
//     a padded int32 buffer
//   * gg_partition_refine / gg_hem_match — capacity-bounded label
//     propagation and heavy-edge matching (datasets/partition.py)
//
// Plain C ABI for ctypes. Built by ggad_tpu_torch/ops/_build.py::build_host
// at first use, without -march=native. Unlike JAX's copy, gg_sort_coo and
// gg_symmetrize sort by counting (see each); their outputs are the same.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <cmath>
#include <numeric>
#include <random>
#include <vector>

extern "C" {

// The stable order of m edges by (row, col): two counting-sort passes
// (by column, then stably by row), O(m + n) for ids in [0, n). JAX's copy
// of this file sorts with std::stable_sort, which gives the same order
// (and so the same outputs) in O(m log m) with random access; at DGraph
// scale that sort was several times slower than scipy's symmetrization.
static std::vector<int64_t> stable_row_col_order(int64_t m,
                                                 const int32_t* rows,
                                                 const int32_t* cols) {
    int32_t n = 0;
    for (int64_t i = 0; i < m; ++i)
        n = std::max(n, std::max(rows[i], cols[i]) + 1);
    std::vector<int64_t> pos(static_cast<size_t>(n) + 1);
    std::vector<int64_t> by_col(m), order(m);
    for (int64_t i = 0; i < m; ++i) pos[cols[i] + 1]++;
    std::partial_sum(pos.begin(), pos.end(), pos.begin());
    for (int64_t i = 0; i < m; ++i) by_col[pos[cols[i]]++] = i;
    std::fill(pos.begin(), pos.end(), 0);
    for (int64_t i = 0; i < m; ++i) pos[rows[i] + 1]++;
    std::partial_sum(pos.begin(), pos.end(), pos.begin());
    for (int64_t k = 0; k < m; ++k) {
        int64_t i = by_col[k];
        order[pos[rows[i]]++] = i;
    }
    return order;
}

// Sort COO edges lexicographically by (row, col), stably, permuting vals
// along. Buffers are modified in place. Returns 0 on success.
int gg_sort_coo(int64_t n_edges, int32_t* rows, int32_t* cols,
                float* vals) {
    std::vector<int64_t> order = stable_row_col_order(n_edges, rows, cols);
    std::vector<int32_t> tmp_i(n_edges);
    std::vector<float> tmp_f(n_edges);
    for (int64_t i = 0; i < n_edges; ++i) tmp_i[i] = rows[order[i]];
    std::memcpy(rows, tmp_i.data(), n_edges * sizeof(int32_t));
    for (int64_t i = 0; i < n_edges; ++i) tmp_i[i] = cols[order[i]];
    std::memcpy(cols, tmp_i.data(), n_edges * sizeof(int32_t));
    if (vals) {
        for (int64_t i = 0; i < n_edges; ++i) tmp_f[i] = vals[order[i]];
        std::memcpy(vals, tmp_f.data(), n_edges * sizeof(float));
    }
    return 0;
}

// Union-symmetrize: emit edges of max(A, A^T) with duplicates removed.
// Inputs need not be sorted. Output buffers must hold 2*n_edges entries;
// returns the number of output edges (sorted by (row, col)). Each edge and
// its mirror are bucketed by row (a counting sort), each row's bucket is
// sorted by column, and duplicates keep their largest value; max does not
// depend on the order, so the output is that of JAX's copy (one
// std::stable_sort of all 2*n_edges entries, several times slower).
int64_t gg_symmetrize(int64_t n_edges, const int32_t* rows,
                      const int32_t* cols, const float* vals,
                      int32_t* out_rows, int32_t* out_cols,
                      float* out_vals) {
    struct Entry {
        int32_t col;
        float val;
    };
    int32_t n = 0;
    for (int64_t i = 0; i < n_edges; ++i)
        n = std::max(n, std::max(rows[i], cols[i]) + 1);
    std::vector<int64_t> pos(static_cast<size_t>(n) + 1);
    for (int64_t i = 0; i < n_edges; ++i) {
        pos[rows[i] + 1]++;
        pos[cols[i] + 1]++;
    }
    std::partial_sum(pos.begin(), pos.end(), pos.begin());
    std::vector<int64_t> fill(pos.begin(), pos.end() - 1);
    std::vector<Entry> buf(2 * n_edges);
    for (int64_t i = 0; i < n_edges; ++i) {
        float val = vals ? vals[i] : 1.0f;
        buf[fill[rows[i]]++] = {cols[i], val};
        buf[fill[cols[i]]++] = {rows[i], val};
    }
    int64_t out = 0;
    for (int32_t u = 0; u < n; ++u) {
        Entry* b = buf.data() + pos[u];
        Entry* e = buf.data() + pos[u + 1];
        std::sort(b, e, [](const Entry& x, const Entry& y) {
            return x.col < y.col;
        });
        int64_t first = out;
        for (Entry* x = b; x < e; ++x) {
            if (out > first && out_cols[out - 1] == x->col) {
                out_vals[out - 1] = std::max(out_vals[out - 1], x->val);
            } else {
                out_rows[out] = u;
                out_cols[out] = x->col;
                out_vals[out] = x->val;
                ++out;
            }
        }
    }
    return out;
}

// Sum duplicate (row, col) entries of a SORTED edge list in place.
// Returns the deduplicated edge count.
int64_t gg_coalesce(int64_t n_edges, int32_t* rows, int32_t* cols,
                    float* vals) {
    if (n_edges == 0) return 0;
    int64_t out = 0;
    for (int64_t i = 0; i < n_edges; ++i) {
        if (out > 0 && rows[out - 1] == rows[i]
            && cols[out - 1] == cols[i]) {
            vals[out - 1] += vals[i];
        } else {
            rows[out] = rows[i];
            cols[out] = cols[i];
            vals[out] = vals[i];
            ++out;
        }
    }
    return out;
}

// CSR indptr from sorted rows. indptr must hold n_nodes+1 entries.
int gg_build_indptr(int64_t n_edges, int32_t n_nodes, const int32_t* rows,
                    int32_t* indptr) {
    std::vector<int64_t> counts(n_nodes, 0);
    for (int64_t i = 0; i < n_edges; ++i) counts[rows[i]]++;
    indptr[0] = 0;
    for (int32_t i = 0; i < n_nodes; ++i)
        indptr[i + 1] = indptr[i] + static_cast<int32_t>(counts[i]);
    return 0;
}

// In-place symmetric normalization: val_e *= d^-1/2[row_e] * d^-1/2[col_e]
// with weighted row-sum degrees (reference utils.py:47-54 semantics).
int gg_sym_normalize(int64_t n_edges, int32_t n_nodes, const int32_t* rows,
                     const int32_t* cols, float* vals) {
    std::vector<double> deg(n_nodes, 0.0);
    for (int64_t i = 0; i < n_edges; ++i) deg[rows[i]] += vals[i];
    std::vector<float> dinv(n_nodes);
    for (int32_t i = 0; i < n_nodes; ++i)
        dinv[i] = deg[i] > 0 ? static_cast<float>(1.0 / std::sqrt(deg[i]))
                             : 0.0f;
    for (int64_t i = 0; i < n_edges; ++i)
        vals[i] *= dinv[rows[i]] * dinv[cols[i]];
    return 0;
}

// --- BCSR tile construction (tile = 128) ---------------------------------

static const int TILE = 128;

// Count occupied tiles of a sorted edge list. tile_ids must hold n_edges.
int64_t gg_bcsr_count(int64_t n_edges, int32_t n_pad_tiles,
                      const int32_t* rows, const int32_t* cols,
                      int64_t* tile_ids) {
    int64_t n_tiles = 0;
    int64_t prev = -1;
    for (int64_t i = 0; i < n_edges; ++i) {
        int64_t t = static_cast<int64_t>(rows[i] / TILE) * n_pad_tiles
                    + cols[i] / TILE;
        tile_ids[i] = t;
        // rows sorted => tile ids non-decreasing within a row band but not
        // globally; count via sort below in gg_bcsr_fill. Here just fill.
        (void)prev;
    }
    std::vector<int64_t> sorted(tile_ids, tile_ids + n_edges);
    std::sort(sorted.begin(), sorted.end());
    for (int64_t i = 0; i < n_edges; ++i)
        if (i == 0 || sorted[i] != sorted[i - 1]) ++n_tiles;
    return n_tiles;
}

// Fill tile-COO arrays. tile_ids from gg_bcsr_count. values must be
// zero-initialized [n_tiles, 128, 128]; tile_rows/tile_cols [n_tiles].
int gg_bcsr_fill(int64_t n_edges, int32_t n_pad_tiles, int64_t n_tiles,
                 const int32_t* rows, const int32_t* cols,
                 const float* vals, const int64_t* tile_ids,
                 int32_t* tile_rows, int32_t* tile_cols, float* values) {
    std::vector<int64_t> uniq(tile_ids, tile_ids + n_edges);
    std::sort(uniq.begin(), uniq.end());
    uniq.erase(std::unique(uniq.begin(), uniq.end()), uniq.end());
    if (static_cast<int64_t>(uniq.size()) != n_tiles) return 1;
    for (int64_t t = 0; t < n_tiles; ++t) {
        tile_rows[t] = static_cast<int32_t>(uniq[t] / n_pad_tiles);
        tile_cols[t] = static_cast<int32_t>(uniq[t] % n_pad_tiles);
    }
    for (int64_t i = 0; i < n_edges; ++i) {
        int64_t t = std::lower_bound(uniq.begin(), uniq.end(), tile_ids[i])
                    - uniq.begin();
        int64_t off = t * TILE * TILE
                      + static_cast<int64_t>(rows[i] % TILE) * TILE
                      + cols[i] % TILE;
        values[off] += vals ? vals[i] : 1.0f;
    }
    return 0;
}

// --- Host-side neighbor sampling ----------------------------------------

// Uniform with-replacement fixed-fanout sampling from CSR into padded
// [n_query, fanout] buffers; mask 0 for zero-degree nodes (which get
// themselves), matching ggad_tpu/sampler/neighbor.py semantics.
int gg_sample_neighbors(int64_t n_query, const int32_t* query,
                        const int32_t* indptr, const int32_t* indices,
                        int32_t fanout, uint64_t seed, int32_t* out_neigh,
                        float* out_mask) {
    std::mt19937_64 gen(seed);
    for (int64_t q = 0; q < n_query; ++q) {
        int32_t v = query[q];
        int32_t start = indptr[v];
        int32_t deg = indptr[v + 1] - start;
        for (int32_t k = 0; k < fanout; ++k) {
            int64_t idx = q * fanout + k;
            if (deg <= 0) {
                out_neigh[idx] = v;
                out_mask[idx] = 0.0f;
            } else {
                out_neigh[idx] = indices[start + gen() % deg];
                out_mask[idx] = 1.0f;
            }
        }
    }
    return 0;
}

// --- Balanced partition refinement ---------------------------------------

// Asynchronous label propagation with a hard per-part NODE-WEIGHT
// capacity: each node moves to the partition holding the (edge-weighted)
// majority of its neighbors when that strictly reduces its weighted cut
// and the destination has room. weights/node_w may be null (= all 1).
// Visit order reshuffles each round (xorshift). Returns total moves.
int64_t gg_partition_refine(int32_t n, int32_t n_parts, int64_t cap,
                            const int32_t* indptr, const int32_t* indices,
                            const float* weights, const int32_t* node_w,
                            int32_t* part, int32_t rounds, uint64_t seed) {
    std::vector<int64_t> sizes(n_parts, 0);
    for (int32_t i = 0; i < n; ++i)
        sizes[part[i]] += node_w ? node_w[i] : 1;
    std::vector<float> counts(n_parts, 0.0f);
    std::vector<int32_t> touched;
    touched.reserve(64);
    std::vector<int32_t> order(n);
    for (int32_t i = 0; i < n; ++i) order[i] = i;
    uint64_t s = seed ? seed : 0x9e3779b97f4a7c15ull;
    auto next = [&s]() {
        s ^= s << 13; s ^= s >> 7; s ^= s << 17;
        return s;
    };
    int64_t total_moved = 0;
    for (int32_t r = 0; r < rounds; ++r) {
        for (int32_t i = n - 1; i > 0; --i)
            std::swap(order[i], order[next() % (i + 1)]);
        int64_t moved = 0;
        for (int32_t k = 0; k < n; ++k) {
            int32_t i = order[k];
            int32_t p = part[i];
            int32_t w_i = node_w ? node_w[i] : 1;
            touched.clear();
            for (int32_t e = indptr[i]; e < indptr[i + 1]; ++e) {
                int32_t q = part[indices[e]];
                if (counts[q] == 0.0f) touched.push_back(q);
                counts[q] += weights ? weights[e] : 1.0f;
            }
            int32_t best = p;
            float best_c = counts[p];
            for (int32_t q : touched) {
                if (q != p && counts[q] > best_c && sizes[q] + w_i <= cap) {
                    best = q;
                    best_c = counts[q];
                }
            }
            for (int32_t q : touched) counts[q] = 0.0f;
            if (best != p) {
                part[i] = best;
                sizes[p] -= w_i;
                sizes[best] += w_i;
                moved++;
            }
        }
        total_moved += moved;
        if (moved == 0) break;
    }
    return total_moved;
}

// --- Heavy-edge matching (multilevel coarsening) --------------------------

// Visit nodes in random order; match each unmatched node with its
// heaviest-edge unmatched neighbor. partner[i] = matched peer (or i).
// Returns the number of matched pairs.
int64_t gg_hem_match(int32_t n, const int32_t* indptr,
                     const int32_t* indices, const float* weights,
                     uint64_t seed, int32_t* partner) {
    for (int32_t i = 0; i < n; ++i) partner[i] = -1;
    std::vector<int32_t> order(n);
    for (int32_t i = 0; i < n; ++i) order[i] = i;
    uint64_t s = seed ? seed : 0x9e3779b97f4a7c15ull;
    auto next = [&s]() {
        s ^= s << 13; s ^= s >> 7; s ^= s << 17;
        return s;
    };
    for (int32_t i = n - 1; i > 0; --i)
        std::swap(order[i], order[next() % (i + 1)]);
    int64_t pairs = 0;
    for (int32_t k = 0; k < n; ++k) {
        int32_t i = order[k];
        if (partner[i] != -1) continue;
        int32_t best = -1;
        float best_w = -1.0f;
        for (int32_t e = indptr[i]; e < indptr[i + 1]; ++e) {
            int32_t j = indices[e];
            if (j == i || partner[j] != -1) continue;
            float w = weights ? weights[e] : 1.0f;
            if (w > best_w) {
                best_w = w;
                best = j;
            }
        }
        if (best != -1) {
            partner[i] = best;
            partner[best] = i;
            pairs++;
        } else {
            partner[i] = i;
        }
    }
    return pairs;
}

}  // extern "C"
