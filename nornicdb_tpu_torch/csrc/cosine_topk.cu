// Fused exact cosine top-k for Hopper (sm_90a).
//
// Replaces: nornicdb_tpu/ops/pallas_topk.py, `_fused_cosine_topk_impl`
// (pl.pallas_call over `_block_topk_kernel`) and its global lax.top_k merge.
//
// What it computes: for L2-normalized queries [B, D] against a
// capacity-padded matrix [C, D] with a validity mask [C], the k best rows
// per query by dot product, masked rows scoring -1e30, ties resolved to
// the LOWER row index. The [B, C] score matrix is never written to device
// memory. Any B, any D, any C, 1 <= k <= 256. The answer is the unique
// top-k under (score desc, index asc), so it is bitwise the same from run
// to run whatever order the blocks finish in.
//
// What bounds it on the H100: it reads the matrix, C*D*4 bytes, and does
// 2*B*C*D float32 FLOPs. Exact float32 rules out the tensor cores (TF32
// keeps ~3 digits), so the compute roof is the 67 TFLOP/s of the float32
// FMA units and the memory roof 3.35 TB/s: below B ~ 10 the kernel is
// bound by bytes, at B = 64 by operations.
//
// What the design does about it:
//  - B <= 4 (bytes): `scan_kernel`, a persistent grid of (resident blocks
//    per SM) x SMs blocks, each scanning one contiguous row range. A row's
//    D floats are spread over a group of L lanes (8 up to D = 256, 32 up
//    to D = 1024) that read it with 16-byte read-only loads straight into
//    registers, two rows per group in flight; each lane keeps its slice of
//    every query in registers, and the group's partial sums reduce with
//    __shfl_xor_sync in a fixed tree. No shared-memory staging: each
//    matrix element is used at most four times. The warps meet at a
//    barrier only every 128 rows, to check whether a fold is due, so one
//    warp's loads overlap another's arithmetic. D % 4 != 0, D > 1024 or a
//    misaligned base take a scalar variant (one warp per row).
//  - B >= 5 (operations): `tile_kernel`, 64-row tiles staged in shared
//    memory in 128-column chunks, 32 queries per block, 8 per thread.
//    Its register-tiled redesign is later work.
//  - Selection: each query keeps a sorted best list of W >= k entries and
//    a candidate buffer of W slots in shared memory. A score enters the
//    buffer only if it is >= the query's shared threshold and strictly
//    better than the block's own k-th best; a warp's passing lanes take
//    their slots with one atomic. The shared threshold is one 32-bit key
//    per query in device memory, the order-preserving map of the best
//    k-th score any block has published: a block raises it with atomicMax
//    after each fold and reads it back. Any block's k-th best is a lower
//    bound on the global k-th best, so the filter drops no answer in any
//    order of arrival; ties at the threshold are kept.
//  - Folds: the B <= 4 kernels fold by ranking (`fold_rank`), whose cost
//    grows with the candidates waiting, so they fold as soon as k have
//    arrived and the block's threshold is real early; the B >= 5 kernels
//    keep a block-wide bitonic sort (`fold`).
//  - Merge: `merge_kernel` reads the G*k winners per query rank by rank
//    across the blocks' sorted lists, drops every winner below the final
//    shared threshold before buffering, stops once a whole rank after the
//    last winner taken has been refused, and writes int64 indices.
//  - Host: function attributes, SM count and occupancy are read once per
//    process and device; outputs and scratch are one allocation of the
//    caller's.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>
#include <map>
#include <mutex>
#include <utility>

namespace {

constexpr int kThreads = 256;
constexpr int kTileRows = 64;  // rows (or candidates) per tile
constexpr int kChunk = 128;    // D-columns staged per step (tile kernel)
constexpr int kMaxW = 256;     // widest best list / candidate buffer (k <= 256)
constexpr int kScanV = 8;      // float4 per lane per row in the scan kernel
constexpr float kMasked = -1e30f;
constexpr int kNoIndex = 0x7fffffff;

// (sa, ia) ranks before (sb, ib): higher score, then lower index.
__device__ __forceinline__ bool better(float sa, int ia, float sb, int ib) {
  return sa > sb || (sa == sb && ia < ib);
}

// Order-preserving map of a float onto unsigned keys (-0 and +0 map
// alike, as they compare equal); 0 is below every score (what
// cudaMemsetAsync leaves).
__device__ __forceinline__ unsigned key_of(float s) {
  const unsigned u = __float_as_uint(s == 0.f ? 0.f : s);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

struct Sel {
  float* s;         // [QB][2W] scores: best in [0, W), candidates in [W, 2W)
  int* i;           // [QB][2W] indices
  int* count;       // [QB] candidates buffered
  float* thr_s;     // [QB] current k-th best score
  int* thr_i;       // [QB] current k-th best index
  unsigned* key;    // [QB] shared threshold as last read
};

__host__ __device__ size_t sel_bytes(int qb, int w) {
  return (size_t)qb * 2 * w * (sizeof(float) + sizeof(int)) +
         (size_t)qb * (3 * sizeof(int) + sizeof(float));
}

__device__ Sel carve(unsigned char* smem, int qb, int w) {
  Sel sel;
  sel.s = reinterpret_cast<float*>(smem);
  sel.i = reinterpret_cast<int*>(sel.s + qb * 2 * w);
  sel.count = sel.i + qb * 2 * w;
  sel.thr_s = reinterpret_cast<float*>(sel.count + qb);
  sel.thr_i = reinterpret_cast<int*>(sel.thr_s + qb);
  sel.key = reinterpret_cast<unsigned*>(sel.thr_i + qb);
  return sel;
}

// Block-wide: empty best lists and buffers; the shared threshold of
// queries q_base.. as the keys hold it now.
__device__ void init_sel(Sel sel, int qb, int w, const unsigned* keys, int q_base, int B) {
  for (int p = threadIdx.x; p < qb * 2 * w; p += blockDim.x) {
    sel.s[p] = -CUDART_INF_F;
    sel.i[p] = kNoIndex;
  }
  for (int q = threadIdx.x; q < qb; q += blockDim.x) {
    sel.count[q] = 0;
    sel.thr_s[q] = -CUDART_INF_F;
    sel.thr_i[q] = kNoIndex;
    sel.key[q] = q_base + q < B ? keys[q_base + q] : 0u;
  }
  __syncthreads();
}

// Block-wide: fold the candidates of queries [0, qb) into their best lists
// by a bitonic sort of both halves on (score desc, index asc). w is a
// power of two, so every index below is a shift or a mask.
__device__ void fold(Sel sel, int qb, int w, int k) {
  const int n = 2 * w;
  const int lw = __ffs(w) - 1;
  for (int p = threadIdx.x; p < qb * w; p += blockDim.x) {
    const int q = p >> lw, j = p & (w - 1);
    if (j >= sel.count[q]) {
      sel.s[q * n + w + j] = -CUDART_INF_F;
      sel.i[q * n + w + j] = kNoIndex;
    }
  }
  __syncthreads();
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int p = threadIdx.x; p < qb * w; p += blockDim.x) {
        const int q = p >> lw, j = p & (w - 1);
        const int a = ((j & ~(stride - 1)) << 1) | (j & (stride - 1));
        const int b = a + stride;
        float* rs = sel.s + q * n;
        int* ri = sel.i + q * n;
        const float sa = rs[a], sb = rs[b];
        const int ia = ri[a], ib = ri[b];
        const bool best_first = (a & size) == 0;
        const bool swap = best_first ? better(sb, ib, sa, ia) : better(sa, ia, sb, ib);
        if (swap) {
          rs[a] = sb; rs[b] = sa;
          ri[a] = ib; ri[b] = ia;
        }
      }
      __syncthreads();
    }
  }
  for (int q = threadIdx.x; q < qb; q += blockDim.x) {
    sel.count[q] = 0;
    sel.thr_s[q] = sel.s[q * n + k - 1];
    sel.thr_i[q] = sel.i[q * n + k - 1];
  }
  __syncthreads();
}

constexpr int kRankP = 4;  // entries per thread and half in fold_rank

// Block-wide, for qb * w <= kRankP * blockDim.x: the same fold by ranking,
// in five barriers whatever w is. Each candidate counts the candidates
// that rank before it (ties by slot) and moves to its place; then every
// entry of either sorted half finds its place in the union by binary
// search in the other half, and the first w places are the new best list.
// Its cost grows with the candidates buffered, so folding often is cheap.
__device__ void fold_rank(Sel sel, int qb, int w, int k) {
  const int n = 2 * w;
  const int lw = __ffs(w) - 1;
  float cs[kRankP], bs[kRankP];
  int ci[kRankP], bi[kRankP], cpos[kRankP], bpos[kRankP];
#pragma unroll
  for (int u = 0; u < kRankP; ++u) {
    const int p = threadIdx.x + u * blockDim.x;
    cpos[u] = -1;
    if (p < qb * w) {
      const int q = p >> lw, j = p & (w - 1), cnt = sel.count[q];
      const float* rs = sel.s + q * n + w;
      const int* ri = sel.i + q * n + w;
      if (j < cnt) {
        cs[u] = rs[j];
        ci[u] = ri[j];
        int r = 0;
        for (int j2 = 0; j2 < cnt; ++j2)
          r += better(rs[j2], ri[j2], cs[u], ci[u]) ||
               (rs[j2] == cs[u] && ri[j2] == ci[u] && j2 < j);
        cpos[u] = r;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kRankP; ++u) {
    if (cpos[u] >= 0) {
      const int q = (threadIdx.x + u * blockDim.x) >> lw;
      sel.s[q * n + w + cpos[u]] = cs[u];
      sel.i[q * n + w + cpos[u]] = ci[u];
    }
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kRankP; ++u) {
    const int p = threadIdx.x + u * blockDim.x;
    bpos[u] = cpos[u] = -1;
    if (p < qb * w) {
      const int q = p >> lw, j = p & (w - 1), cnt = sel.count[q];
      const float* rs = sel.s + q * n;
      const int* ri = sel.i + q * n;
      // best entry j: after the candidates strictly better than it
      bs[u] = rs[j];
      bi[u] = ri[j];
      int lo = 0, hi = cnt;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (better(rs[w + mid], ri[w + mid], bs[u], bi[u])) lo = mid + 1; else hi = mid;
      }
      bpos[u] = j + lo;
      // candidate j: after the best entries not worse than it
      if (j < cnt) {
        cs[u] = rs[w + j];
        ci[u] = ri[w + j];
        lo = 0;
        hi = w;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (!better(cs[u], ci[u], rs[mid], ri[mid])) lo = mid + 1; else hi = mid;
        }
        cpos[u] = j + lo;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kRankP; ++u) {
    const int q = (threadIdx.x + u * blockDim.x) >> lw;
    if (bpos[u] >= 0 && bpos[u] < w) {
      sel.s[q * n + bpos[u]] = bs[u];
      sel.i[q * n + bpos[u]] = bi[u];
    }
    if (cpos[u] >= 0 && cpos[u] < w) {
      sel.s[q * n + cpos[u]] = cs[u];
      sel.i[q * n + cpos[u]] = ci[u];
    }
  }
  __syncthreads();
  for (int q = threadIdx.x; q < qb; q += blockDim.x) {
    sel.count[q] = 0;
    sel.thr_s[q] = sel.s[q * n + k - 1];
    sel.thr_i[q] = sel.i[q * n + k - 1];
  }
  __syncthreads();
}

template <bool RANK>
__device__ __forceinline__ void fold_any(Sel sel, int qb, int w, int k) {
  if constexpr (RANK) fold_rank(sel, qb, w, k); else fold(sel, qb, w, k);
}

// Block-wide: fold, then publish each query's k-th best score to the
// shared threshold and read the threshold back.
template <bool RANK>
__device__ void fold_and_share(Sel sel, int qb, int w, int k, unsigned* keys, int q_base) {
  fold_any<RANK>(sel, qb, w, k);
  for (int q = threadIdx.x; q < qb; q += blockDim.x) {
    const unsigned mine = key_of(sel.thr_s[q]);
    sel.key[q] = max(atomicMax(&keys[q_base + q], mine), mine);
  }
  __syncthreads();
}

// Block-wide: has any query more than `limit` candidates buffered? A
// barrier first, so every offer made so far is counted; every thread reads
// the counts, then a barrier, so no thread's next offer can change what
// another thread reads.
__device__ __forceinline__ bool need_fold(Sel sel, int qb, int limit) {
  __syncthreads();
  bool full = false;
  for (int q = 0; q < qb; ++q) full |= sel.count[q] > limit;
  __syncthreads();
  return full;
}

// Offer (s, idx) as a candidate of query q. Every active lane of the warp
// offers for the same q; the lanes that pass take their slots with one
// atomic. Returns the highest lane whose offer was taken, or -1.
__device__ __forceinline__ int offer(Sel sel, int w, int q, float s, int idx) {
  const bool pass = key_of(s) >= sel.key[q] && better(s, idx, sel.thr_s[q], sel.thr_i[q]);
  const unsigned act = __activemask();
  const unsigned ball = __ballot_sync(act, pass);
  if (ball == 0) return -1;
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(ball) - 1;
  int slot = 0;
  if (lane == leader) slot = atomicAdd(&sel.count[q], __popc(ball));
  slot = __shfl_sync(act, slot, leader) + __popc(ball & ((1u << lane) - 1u));
  if (pass) {
    sel.s[q * 2 * w + w + slot] = s;
    sel.i[q * 2 * w + w + slot] = idx;
  }
  return 31 - __clz(ball);
}

// Block-wide: the block's k best of queries [0, qb) to out [n_blocks][B][k].
__device__ void write_part(Sel sel, int qb, int w, int k, float* out_s, int* out_i,
                           int B, int q_base) {
  for (int p = threadIdx.x; p < qb * k; p += blockDim.x) {
    const int ql = p / k, j = p % k;
    const size_t off = ((size_t)blockIdx.x * B + q_base + ql) * k + j;
    out_s[off] = sel.s[ql * 2 * w + j];
    out_i[off] = sel.i[ql * 2 * w + j];
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// Sum over the L lanes of a group (L a power of two, groups aligned), in
// a fixed butterfly: every lane of the group ends with the same bits.
template <int L>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Stage 1 for B = NQ <= 4. VEC: rows read as float4 by groups of L lanes
// (D % 4 == 0, D <= 32 * L, 16-byte aligned bases); otherwise one warp
// per row with scalar loads (L = 32).
template <int NQ, int L, bool VEC>
__global__ void __launch_bounds__(kThreads, NQ == 1 ? 2 : 1)
scan_kernel(const float* __restrict__ queries, const float* __restrict__ matrix,
            const unsigned char* __restrict__ valid, float* __restrict__ part_s,
            int* __restrict__ part_i, unsigned* __restrict__ keys, int C, int D, int k) {
  constexpr int kGroups = kThreads / L;
  constexpr int kStep = 2 * kGroups;  // rows per step, two per group
  // Steps between fold checks. Between two checks the warps run without a
  // barrier, so one warp's loads overlap another's dots and offers.
  constexpr int kCheck = 128 / kStep;
  constexpr int w = kMaxW;
  extern __shared__ __align__(16) unsigned char smem[];
  const Sel sel = carve(smem, NQ, w);
  // rank folds are cheap while few candidates wait: fold once k have
  // arrived (the first fold sets a real threshold), and always early
  // enough that kCheck steps of candidates still fit
  const int limit = min(w - kCheck * kStep, max(k, kStep));
  init_sel(sel, NQ, w, keys, 0, NQ);

  const int lane = threadIdx.x % L;
  const int grp = threadIdx.x / L;
  const int per_block = (C + gridDim.x - 1) / gridDim.x;
  const int r0 = blockIdx.x * per_block;
  const int r1 = min(C, r0 + per_block);
  const int D4 = D / 4;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const auto* q4 = reinterpret_cast<const float4*>(queries);
  const auto* m4 = reinterpret_cast<const float4*>(matrix);

  float4 qv[NQ][VEC ? kScanV : 1];
  if constexpr (VEC) {
#pragma unroll
    for (int qq = 0; qq < NQ; ++qq)
#pragma unroll
      for (int v = 0; v < kScanV; ++v) {
        const int j = v * L + lane;
        qv[qq][v] = j < D4 ? __ldg(q4 + (size_t)qq * D4 + j) : zero;
      }
  }

  for (int base = r0, step = 0; base < r1; base += kStep, ++step) {
    const int ra = base + grp, rb = ra + kGroups;
    const bool check = step % kCheck == 0;
    float sa[NQ], sb[NQ];
#pragma unroll
    for (int qq = 0; qq < NQ; ++qq) sa[qq] = sb[qq] = 0.f;
    bool full;
    if constexpr (VEC) {
      float4 xa[kScanV], xb[kScanV];  // both rows in flight across the barrier
#pragma unroll
      for (int v = 0; v < kScanV; ++v) {
        const int j = v * L + lane;
        xa[v] = (ra < r1 && j < D4) ? __ldg(m4 + (size_t)ra * D4 + j) : zero;
        xb[v] = (rb < r1 && j < D4) ? __ldg(m4 + (size_t)rb * D4 + j) : zero;
      }
      full = check && need_fold(sel, NQ, limit);
#pragma unroll
      for (int v = 0; v < kScanV; ++v)
#pragma unroll
        for (int qq = 0; qq < NQ; ++qq) {
          sa[qq] = dot4(qv[qq][v], xa[v], sa[qq]);
          sb[qq] = dot4(qv[qq][v], xb[v], sb[qq]);
        }
    } else {
      full = check && need_fold(sel, NQ, limit);
      for (int c = lane; c < D; c += L) {
        const float ma = ra < r1 ? __ldg(matrix + (size_t)ra * D + c) : 0.f;
        const float mb = rb < r1 ? __ldg(matrix + (size_t)rb * D + c) : 0.f;
#pragma unroll
        for (int qq = 0; qq < NQ; ++qq) {
          const float qc = __ldg(queries + (size_t)qq * D + c);
          sa[qq] = fmaf(qc, ma, sa[qq]);
          sb[qq] = fmaf(qc, mb, sb[qq]);
        }
      }
    }
#pragma unroll
    for (int qq = 0; qq < NQ; ++qq) {
      sa[qq] = group_sum<L>(sa[qq]);
      sb[qq] = group_sum<L>(sb[qq]);
    }
    // the fold comes after the dots, when the rows' registers are free
    if (full) fold_and_share<true>(sel, NQ, w, k, keys, 0);
#pragma unroll
    for (int qq = 0; qq < NQ; ++qq) {
      if (lane == qq) {  // lane qq of the group offers query qq
        if (ra < r1) offer(sel, w, qq, valid[ra] ? sa[qq] : kMasked, ra);
        if (rb < r1) offer(sel, w, qq, valid[rb] ? sb[qq] : kMasked, rb);
      }
    }
  }
  __syncthreads();
  fold_and_share<true>(sel, NQ, w, k, keys, 0);
  write_part(sel, NQ, w, k, part_s, part_i, NQ, 0);
}

// Stage 1 for B >= 5: 64-row tiles staged in shared memory, QB = 4 * QPT
// queries per block (grid.y groups), each thread scoring one tile row
// against QPT queries.
template <int QPT>
__global__ void __launch_bounds__(kThreads)
tile_kernel(const float* __restrict__ queries, const float* __restrict__ matrix,
            const unsigned char* __restrict__ valid, float* __restrict__ part_s,
            int* __restrict__ part_i, unsigned* __restrict__ keys,
            int B, int C, int D, int k, int w) {
  constexpr int QB = 4 * QPT;
  extern __shared__ __align__(16) unsigned char smem[];
  const Sel sel = carve(smem, QB, w);
  float* q_s = reinterpret_cast<float*>(smem + sel_bytes(QB, w));  // [QB][kChunk]
  float* m_s = q_s + QB * kChunk;                                  // [64][kChunk+1]

  const int t = threadIdx.x;
  const int r = t % kTileRows;   // tile row this thread scores
  const int qg = t / kTileRows;  // its group of QPT queries
  const int q_base = blockIdx.y * QB;
  const int nq = min(QB, B - q_base);
  init_sel(sel, QB, w, keys, q_base, B);

  const int n_tiles = (C + kTileRows - 1) / kTileRows;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    if (need_fold(sel, nq, w - kTileRows)) fold_and_share<false>(sel, nq, w, k, keys, q_base);
    float acc[QPT];
#pragma unroll
    for (int j = 0; j < QPT; ++j) acc[j] = 0.f;
    for (int c0 = 0; c0 < D; c0 += kChunk) {
      for (int e = t; e < QB * kChunk; e += kThreads) {
        const int qq = e / kChunk, c = e % kChunk;
        const int gq = q_base + qq, gc = c0 + c;
        q_s[e] = (gq < B && gc < D) ? queries[(size_t)gq * D + gc] : 0.f;
      }
      for (int e = t; e < kTileRows * kChunk; e += kThreads) {
        const int rr = e / kChunk, c = e % kChunk;
        const int grow = tile * kTileRows + rr, gc = c0 + c;
        m_s[rr * (kChunk + 1) + c] = (grow < C && gc < D) ? matrix[(size_t)grow * D + gc] : 0.f;
      }
      __syncthreads();
      const int cn = min(kChunk, D - c0);
      for (int c = 0; c < cn; ++c) {
        const float mv = m_s[r * (kChunk + 1) + c];
#pragma unroll
        for (int j = 0; j < QPT; ++j)
          acc[j] = fmaf(q_s[(qg * QPT + j) * kChunk + c], mv, acc[j]);
      }
      __syncthreads();
    }
    const int item = tile * kTileRows + r;
    if (item < C) {
      const bool ok = valid[item] != 0;
#pragma unroll
      for (int j = 0; j < QPT; ++j) {
        const int ql = qg * QPT + j;
        if (ql < nq) offer(sel, w, ql, ok ? acc[j] : kMasked, item);
      }
    }
    __syncthreads();
  }
  fold_and_share<false>(sel, nq, w, k, keys, q_base);
  write_part(sel, nq, w, k, part_s, part_i, B, q_base);
}

// Stage 2: the n_parts * k winners per query of stage 1, [n_parts][B][k],
// to the final [B][k] with int64 indices. A block takes QPT * kThreads /
// STEP queries; each step offers STEP winners per query, rank by rank
// across the parts (all parts' best first), so the first fold already
// sets a strong threshold. Winners below the final shared threshold are
// dropped before they are buffered. Each part's list is sorted, so once a
// whole rank of parts after the last taken winner has been refused, every
// later winner would be refused too, and the block stops.
template <int STEP, int QPT, int W>
__global__ void __launch_bounds__(kThreads)
merge_kernel(const float* __restrict__ in_s, const int* __restrict__ in_i,
             unsigned* __restrict__ keys, float* __restrict__ out_s,
             long long* __restrict__ out_i, int B, int n_parts, int k) {
  constexpr int QB = kThreads / STEP * QPT;
  constexpr bool RANK = QB * W <= kRankP * kThreads;
  const int limit = RANK ? min(W - STEP, max(k, STEP)) : W - STEP;
  extern __shared__ __align__(16) unsigned char smem[];
  const Sel sel = carve(smem, QB, W);
  int* last = reinterpret_cast<int*>(smem + sel_bytes(QB, W));  // [QB] last item taken
  const int t = threadIdx.x;
  const int r = t % STEP;
  const int qg = t / STEP;
  const int q_base = blockIdx.x * QB;
  const int nq = min(QB, B - q_base);
  for (int q = t; q < QB; q += kThreads) last[q] = -1;
  init_sel(sel, QB, W, keys, q_base, B);

  const int n_items = n_parts * k;
  for (int base = 0; base < n_items; base += STEP) {
    const int item = base + r;
    const int part = item % n_parts, jj = item / n_parts;
    float s[QPT];
    int idx[QPT];
#pragma unroll
    for (int j = 0; j < QPT; ++j) {  // loads in flight across the barrier
      const int ql = qg * QPT + j;
      const size_t off = ((size_t)part * B + q_base + ql) * k + jj;
      const bool ok = item < n_items && ql < nq;
      s[j] = ok ? in_s[off] : -CUDART_INF_F;
      idx[j] = ok ? in_i[off] : kNoIndex;
    }
    bool full = false, done = true;
    for (int q = 0; q < nq; ++q) {
      full |= sel.count[q] > limit;
      done &= base > last[q] + n_parts;
    }
    __syncthreads();
    if (done) break;
    if (full) fold_any<RANK>(sel, nq, W, k);
#pragma unroll
    for (int j = 0; j < QPT; ++j) {
      const int ql = qg * QPT + j;
      if (ql < nq && item < n_items) {
        const int top = offer(sel, W, ql, s[j], idx[j]);
        if (top == (t & 31)) atomicMax(&last[ql], item);
      }
    }
    __syncthreads();
  }
  fold_any<RANK>(sel, nq, W, k);
  for (int p = t; p < nq * k; p += kThreads) {
    const int ql = p / k, j = p % k;
    const size_t off = (size_t)(q_base + ql) * k + j;
    out_s[off] = sel.s[ql * 2 * W + j];
    out_i[off] = sel.i[ql * 2 * W + j];
  }
}

// -- host side ---------------------------------------------------------------

// merge_kernel's shapes: B <= 4 in one block, 128 winners per query per
// step; B >= 5 in blocks of 32 queries, 64 winners per query per step.
constexpr int kSmallStep = 128, kSmallQpt = 2, kSmallW = kMaxW, kSmallQ = 4;
constexpr int kWideStep = 64, kWideQpt = 8, kWideW = kMaxW, kWideQ = 32;

size_t merge_smem(int qb, int w) { return sel_bytes(qb, w) + qb * sizeof(int); }

size_t tile_smem(int w) {
  return sel_bytes(32, w) + ((size_t)32 * kChunk + (size_t)kTileRows * (kChunk + 1)) * sizeof(float);
}

// Per process and device: each kernel's largest shared memory allowed
// once, and its resident blocks per SM, read once.
std::mutex g_mu;
std::map<std::pair<const void*, int>, int> g_occ;
std::map<int, int> g_sms;

cudaError_t prepare(const void* fn, size_t max_smem, int* occ) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(g_mu);
  const auto key = std::make_pair(fn, dev);
  auto it = g_occ.find(key);
  if (it == g_occ.end()) {
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)max_smem);
    if (e != cudaSuccess) return e;
    int n = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, kThreads, max_smem);
    if (e != cudaSuccess) return e;
    it = g_occ.emplace(key, n).first;
  }
  *occ = it->second;
  return cudaSuccess;
}

cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(g_mu);
  auto it = g_sms.find(dev);
  if (it == g_sms.end()) {
    int n = 0;
    e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    it = g_sms.emplace(dev, n).first;
  }
  *sms = it->second;
  return cudaSuccess;
}

using ScanFn = void (*)(const float*, const float*, const unsigned char*, float*, int*,
                        unsigned*, int, int, int);

// The scan's lanes per row: 8 up to D = 256, 32 up to D = 1024, and 0 for
// the scalar variant (D % 4 != 0, D > 1024 or a base not 16-byte aligned).
int scan_lanes(const void* q, const void* m, int D) {
  const bool vec = D % 4 == 0 && D <= 4 * 32 * kScanV &&
                   reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(m) % 16 == 0;
  return !vec ? 0 : D <= 4 * 8 * kScanV ? 8 : 32;
}

template <int NQ>
ScanFn scan_for(int lanes) {
  if (lanes == 8) return scan_kernel<NQ, 8, true>;
  if (lanes == 32) return scan_kernel<NQ, 32, true>;
  return scan_kernel<NQ, 32, false>;
}

ScanFn pick_scan(int B, int lanes) {
  switch (B) {
    case 1: return scan_for<1>(lanes);
    case 2: return scan_for<2>(lanes);
    case 3: return scan_for<3>(lanes);
    default: return scan_for<4>(lanes);
  }
}

// Stage-1 blocks for this call, or a negative CUDA error code.
int grid_for(const void* q, const void* m, int B, int C, int D, int k) {
  int sms = 0;
  cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return -(int)e;
  if (B <= 4) {
    int occ = 0;
    const int lanes = scan_lanes(q, m, D);
    e = prepare(reinterpret_cast<const void*>(pick_scan(B, lanes)), sel_bytes(4, kMaxW), &occ);
    if (e != cudaSuccess) return -(int)e;
    const int rows_per_step = 2 * kThreads / (lanes == 8 ? 8 : 32);
    const int steps = (C + rows_per_step - 1) / rows_per_step;
    return max(1, min(steps, max(1, occ) * sms));
  }
  const int groups = (B + 31) / 32;
  const int n_tiles = (C + kTileRows - 1) / kTileRows;
  return max(1, min(n_tiles, (2 * sms + groups - 1) / groups));
}

}  // namespace

extern "C" {

// Blocks of stage 1 for these inputs (the wrapper sizes the scratch from
// it), or a negative CUDA error code.
int nornic_cosine_topk_grid(const void* queries, const void* matrix, int B, int C, int D,
                            int k) {
  return grid_for(queries, matrix, B, C, D, k);
}

// queries [B, D] f32, matrix [C, D] f32, valid [C] bool (1 byte each),
// scratch: [G, B, k] f32 scores, [G, B, k] i32 indices, [B] u32 keys, in
// that order; out_s [B, k] f32, out_i [B, k] int64. Launches on `stream`,
// does not synchronise, returns the first CUDA error.
int nornic_cosine_topk(const void* queries, const void* matrix, const void* valid,
                       void* scratch, void* out_s, void* out_i,
                       int B, int C, int D, int k, int G, void* stream) {
  if (B < 1 || C < 1 || D < 1 || k < 1 || k > kMaxW || k > C || G < 1)
    return cudaErrorInvalidValue;
  if (G != grid_for(queries, matrix, B, C, D, k)) return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* q = static_cast<const float*>(queries);
  const auto* m = static_cast<const float*>(matrix);
  const auto* v = static_cast<const unsigned char*>(valid);
  auto* ps = static_cast<float*>(scratch);
  auto* pi = reinterpret_cast<int*>(ps + (size_t)G * B * k);
  auto* keys = reinterpret_cast<unsigned*>(pi + (size_t)G * B * k);
  auto* os = static_cast<float*>(out_s);
  auto* oi = static_cast<long long*>(out_i);
  cudaError_t e = cudaMemsetAsync(keys, 0, (size_t)B * sizeof(unsigned), st);
  if (e != cudaSuccess) return e;
  int occ = 0;
  if (B <= 4) {
    const ScanFn scan = pick_scan(B, scan_lanes(queries, matrix, D));
    scan<<<G, kThreads, sel_bytes(B, kMaxW), st>>>(q, m, v, ps, pi, keys, C, D, k);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    auto merge = merge_kernel<kSmallStep, kSmallQpt, kSmallW>;
    const size_t sm = merge_smem(kSmallQ, kSmallW);
    e = prepare(reinterpret_cast<const void*>(merge), sm, &occ);
    if (e != cudaSuccess) return e;
    merge<<<1, kThreads, sm, st>>>(ps, pi, keys, os, oi, B, G, k);
    return cudaGetLastError();
  }
  int w = 64;
  while (w < k) w <<= 1;
  auto tile = tile_kernel<8>;
  e = prepare(reinterpret_cast<const void*>(tile), tile_smem(kMaxW), &occ);
  if (e != cudaSuccess) return e;
  tile<<<dim3(G, (B + 31) / 32), kThreads, tile_smem(w), st>>>(q, m, v, ps, pi, keys, B, C, D, k, w);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  auto merge = merge_kernel<kWideStep, kWideQpt, kWideW>;
  const size_t sm = merge_smem(kWideQ, kWideW);
  e = prepare(reinterpret_cast<const void*>(merge), sm, &occ);
  if (e != cudaSuccess) return e;
  merge<<<(B + kWideQ - 1) / kWideQ, kThreads, sm, st>>>(ps, pi, keys, os, oi, B, G, k);
  return cudaGetLastError();
}

const char* nornic_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
