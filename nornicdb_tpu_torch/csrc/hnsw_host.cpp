// Host HNSW build and query kernels: wave layer-search + connect phase
// (diversity-select + link + back-link prune). A copy of the JAX
// package's native/nornichnsw.cpp, kept byte-for-byte in its code so
// that both packages build the same graph from the same inputs.
//
// The wave build (nornicdb_tpu_torch/search/hnsw.py) runs each wave's
// beam searches here (hnsw_wave_search, also the query path with every
// query at level 0) and links the wave at each level (hnsw_connect).
// Semantics mirror the Python path of hnsw.py exactly:
//
// - _select_neighbors: keep a candidate (distance order) only if it is
//   closer to the query than to every already-kept neighbor; backfill
//   with the closest rejects if fewer than m survive; candidate list
//   capped at 4m.
// - _add_link: append a back-link while the row has slack; on overflow
//   re-select over (existing row + new link) by distance to the row
//   owner and rewrite the row.
//
// Equivalence with the Python path, and with the JAX package's build,
// is pinned by tests/test_torch_hnsw.py.
//
// Build: c++ -O3 -march=native -std=c++17 -shared -fPIC, at first use,
// by nornicdb_tpu_torch/ops/_build.py (host_library).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <limits>
#include <queue>
#include <vector>

namespace {

inline float dot(const float* a, const float* b, int64_t d) {
    // 16 independent accumulator lanes: strict-FP compilers can only
    // vectorize up to the manual unroll width (reassociation is not
    // allowed), so 4 lanes capped the loop at 128-bit SSE — 16 maps
    // onto two AVX2 registers (or one AVX-512) with -march=native
    float acc[16] = {0.f};
    int64_t i = 0;
    for (; i + 16 <= d; i += 16) {
        for (int k = 0; k < 16; ++k) acc[k] += a[i + k] * b[i + k];
    }
    float s = 0.f;
    for (int k = 0; k < 16; ++k) s += acc[k];
    for (; i < d; ++i) s += a[i] * b[i];
    return s;
}

// greedy diversity selection over candidates sorted by distance;
// returns number kept, writing kept slots into `out` (size >= m)
int64_t select_neighbors(const float* vectors, int64_t dims,
                         const int64_t* cslots, const float* cdists,
                         int64_t n_cand, int64_t m, int64_t* out) {
    n_cand = std::min(n_cand, 4 * m);
    if (n_cand <= m) {
        for (int64_t i = 0; i < n_cand; ++i) out[i] = cslots[i];
        return n_cand;
    }
    std::vector<char> taken(n_cand, 0);
    int64_t kept = 0;
    for (int64_t i = 0; i < n_cand && kept < m; ++i) {
        const float* vi = vectors + cslots[i] * dims;
        bool ok = true;
        for (int64_t k = 0; k < kept; ++k) {
            const float* vk = vectors + out[k] * dims;
            // closer to an already-kept neighbor than to the query
            if (cdists[i] >= 1.0f - dot(vi, vk, dims)) { ok = false; break; }
        }
        if (ok) {
            out[kept++] = cslots[i];
            taken[i] = 1;
        }
    }
    // backfill with the closest rejects (Python parity)
    for (int64_t i = 0; i < n_cand && kept < m; ++i) {
        if (!taken[i]) {
            out[kept++] = cslots[i];
            taken[i] = 1;
        }
    }
    return kept;
}

void set_row(int32_t* nbr, int32_t* cnt, int64_t width, int64_t row,
             const int64_t* slots, int64_t n) {
    n = std::min(n, width);
    int32_t* r = nbr + row * width;
    for (int64_t i = 0; i < n; ++i) r[i] = static_cast<int32_t>(slots[i]);
    for (int64_t i = n; i < width; ++i) r[i] = -1;
    cnt[row] = static_cast<int32_t>(n);
}

void add_link(const float* vectors, int64_t dims, int32_t* nbr,
              int32_t* cnt, int64_t width, int64_t level_cap,
              int64_t c, int64_t slot) {
    int32_t n = cnt[c];
    if (n < width) {
        nbr[c * width + n] = static_cast<int32_t>(slot);
        cnt[c] = n + 1;
        return;
    }
    // overflow: re-select over (existing row + new) by distance to c
    std::vector<std::pair<float, int64_t>> merged;
    merged.reserve(width + 1);
    const float* vc = vectors + c * dims;
    const int32_t* row = nbr + c * width;
    for (int64_t i = 0; i < width; ++i) {
        int64_t s = row[i];
        merged.emplace_back(1.0f - dot(vectors + s * dims, vc, dims), s);
    }
    merged.emplace_back(1.0f - dot(vectors + slot * dims, vc, dims), slot);
    std::sort(merged.begin(), merged.end());
    std::vector<int64_t> cs(merged.size());
    std::vector<float> cd(merged.size());
    for (size_t i = 0; i < merged.size(); ++i) {
        cd[i] = merged[i].first;
        cs[i] = merged[i].second;
    }
    std::vector<int64_t> out(level_cap);
    int64_t kept = select_neighbors(vectors, dims, cs.data(), cd.data(),
                                    static_cast<int64_t>(cs.size()),
                                    level_cap, out.data());
    set_row(nbr, cnt, width, c, out.data(), kept);
}

using DistSlot = std::pair<float, int64_t>;

// Classic HNSW layer search (searchLayer of the paper; the wave
// builder's per-query form). Entries seed both heaps; every candidate
// expansion is bounded by the current worst result once the result set
// is full. Results land in `out`, ascending by distance.
void search_layer_classic(const float* vectors, int64_t dims,
                          const float* q, const int32_t* nbr,
                          const int32_t* cnt, int64_t width,
                          const std::vector<DistSlot>& entries, int64_t ef,
                          std::vector<int32_t>& visited, int32_t genv,
                          std::vector<DistSlot>& out) {
    std::priority_queue<DistSlot> result;  // max-heap: top = worst kept
    std::priority_queue<DistSlot, std::vector<DistSlot>,
                        std::greater<DistSlot>> cands;  // min-heap
    for (const auto& e : entries) {
        visited[e.second] = genv;
        result.push(e);
        cands.push(e);
    }
    while (result.size() > static_cast<size_t>(ef)) result.pop();
    while (!cands.empty()) {
        DistSlot c = cands.top();
        if (result.size() >= static_cast<size_t>(ef) &&
            c.first > result.top().first)
            break;
        cands.pop();
        const int32_t* row = nbr + c.second * width;
        int32_t n = cnt[c.second];
        // the search is memory-latency-bound on the 1KB vector rows:
        // prefetch every unexpanded neighbor's row head before the
        // distance loop touches the first one
        for (int32_t i = 0; i < n; ++i) {
            __builtin_prefetch(vectors + row[i] * dims, 0, 1);
            __builtin_prefetch(visited.data() + row[i], 0, 1);
        }
        for (int32_t i = 0; i < n; ++i) {
            int64_t s = row[i];
            if (visited[s] == genv) continue;
            visited[s] = genv;
            float d = 1.0f - dot(q, vectors + s * dims, dims);
            if (result.size() < static_cast<size_t>(ef) ||
                d < result.top().first) {
                cands.emplace(d, s);
                result.emplace(d, s);
                if (result.size() > static_cast<size_t>(ef)) result.pop();
            }
        }
    }
    out.resize(result.size());
    for (int64_t i = static_cast<int64_t>(result.size()) - 1; i >= 0; --i) {
        out[i] = result.top();
        result.pop();
    }
}

}  // namespace

extern "C" {

// Wave layer-search for the bulk build: for each of B queries, greedy-
// descend from the global entry through levels above the query's level,
// then collect an ef-beam at every level from min(query_level, top)
// down to 0. Outputs land in [B, n_levels, ef] arrays (slot -1 / dist
// +inf padded), ascending by distance per (query, level) — exactly the
// per-level candidate lists hnsw.py's connect phase consumes.
//
// The graph traversed is the PRE-WAVE adjacency (wave slots exist in
// `vectors` but have no links yet), matching the Python wave builder.
void hnsw_wave_search(const float* vectors, int64_t dims,
                      const int32_t* const* nbrs,
                      const int32_t* const* cnts, const int64_t* widths,
                      int64_t n_levels, const float* queries, int64_t B,
                      const int64_t* query_levels, int64_t entry_slot,
                      int64_t ef, int64_t capacity, int64_t* out_slots,
                      float* out_dists) {
    const float INF = std::numeric_limits<float>::infinity();
    std::vector<int32_t> visited(capacity, 0);
    int32_t gen = 0;
    std::vector<DistSlot> beam, next;
    std::fill(out_slots, out_slots + B * n_levels * ef, int64_t{-1});
    std::fill(out_dists, out_dists + B * n_levels * ef, INF);
    for (int64_t j = 0; j < B; ++j) {
        const float* q = queries + j * dims;
        beam.assign(
            1, {1.0f - dot(q, vectors + entry_slot * dims, dims),
                entry_slot});
        int64_t top = std::min(query_levels[j], n_levels - 1);
        for (int64_t lv = n_levels - 1; lv > top; --lv) {
            ++gen;
            search_layer_classic(vectors, dims, q, nbrs[lv], cnts[lv],
                                 widths[lv], beam, 1, visited, gen, next);
            beam.swap(next);
        }
        for (int64_t lv = top; lv >= 0; --lv) {
            ++gen;
            search_layer_classic(vectors, dims, q, nbrs[lv], cnts[lv],
                                 widths[lv], beam, ef, visited, gen, next);
            beam.swap(next);
            int64_t* os = out_slots + (j * n_levels + lv) * ef;
            float* od = out_dists + (j * n_levels + lv) * ef;
            int64_t k = std::min<int64_t>(beam.size(), ef);
            for (int64_t i = 0; i < k; ++i) {
                od[i] = beam[i].first;
                os[i] = beam[i].second;
            }
        }
    }
}

// Connect a wave's nodes at ONE level. Candidates arrive flattened:
// node i's sorted-by-distance candidates are
// cand_slots[cand_off[i] : cand_off[i+1]] (+ parallel cand_dists).
// m_forward: forward-link selection size (the index's m at every
// level); level_cap: back-link prune cap (m0 at level 0, m above) —
// mirrors _link_from_cands(select m) + _add_link(prune to level cap).
void hnsw_connect(const float* vectors, int64_t dims, int32_t* nbr,
                  int32_t* cnt, int64_t width, int64_t m_forward,
                  int64_t level_cap,
                  const int64_t* wave_slots, const int64_t* cand_off,
                  const int64_t* cand_slots, const float* cand_dists,
                  int64_t n_wave) {
    std::vector<int64_t> out(std::max(m_forward, level_cap));
    for (int64_t i = 0; i < n_wave; ++i) {
        int64_t lo = cand_off[i], hi = cand_off[i + 1];
        int64_t kept = select_neighbors(
            vectors, dims, cand_slots + lo, cand_dists + lo, hi - lo,
            m_forward, out.data());
        int64_t slot = wave_slots[i];
        set_row(nbr, cnt, width, slot, out.data(), kept);
        for (int64_t k = 0; k < kept; ++k) {
            add_link(vectors, dims, nbr, cnt, width, level_cap, out[k],
                     slot);
        }
    }
}

}  // extern "C"
