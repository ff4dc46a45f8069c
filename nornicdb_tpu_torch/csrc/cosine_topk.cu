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
// keeps ~3 digits, and split-TF32 sums are not exact), so the compute roof
// is the 67 TFLOP/s of the float32 FMA units and the memory roof 3.35 TB/s:
// the two times, 4*C*D / 3.35e12 and 2*B*C*D / 67e12, are equal at B = 40.
// Below it the call is bound by bytes, above it by operations.
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
//  - B >= 5: `rtile_kernel`, one wave of blocks (one per SM), each
//    holding up to QB queries (16, 32 or 64, the smallest that holds B)
//    against one contiguous row range, so the matrix is read once per call
//    up to B = 64 (for k up to 49; wider k takes a
//    narrower QB, `tile_qb`). On the bytes side (B < 40) the query tile
//    follows B, so the padded FMAs stay within QB / B of the needed ones,
//    and each row arrives in 128-byte depth chunks (32 columns) by 16-byte
//    cp.async into a two-stage ring while the chunk before is scored:
//    64-byte chunks cost 1.4x the time at B = 8 (PERF.md). On the
//    operations side each thread keeps a tile of TR rows by 8 queries
//    (16 x 8 at QB = 64) in registers and feeds it with 16-byte shared
//    loads, one per 32 FMAs at TR = 16. Every (query, row) sum runs over
//    the depth in order, so the scores are the same from call to call.
//    D % 4 != 0 or a misaligned base copy 4 bytes at a time; the tile
//    reads are the same.
//  - Selection: each query keeps a sorted best list and a buffer of
//    candidates in shared memory. A score enters the buffer only if it is
//    >= the query's shared threshold and strictly better than the block's
//    own k-th best. Where a warp's lanes offer for one query (the scan,
//    the merge) its passing lanes take their slots with one atomic; in the
//    batched kernel each passing lane takes its own, which is rare once
//    the threshold is real. The shared threshold is one 32-bit key per
//    query in device memory, the order-preserving map of the best k-th
//    score any block has published: a block raises it with atomicMax after
//    each fold and reads it back. Any block's k-th best is a lower bound on
//    the global k-th best, so the filter drops no answer in any order of
//    arrival; ties at the threshold are kept.
//  - Folds cost what the candidates cost, not what the list holds. The
//    scan and the merge fold by ranking (`fold_rank`, five barriers) as
//    soon as k candidates have arrived, so the block's threshold is real
//    early. The batched kernel (`tile_fold`) keeps two best lists of k and
//    merges the buffer into the other one in a single pass, each entry
//    finding its place alone; it offers a tile's scores one row slot at a
//    time (RT rows per query) into buffers of RT + kTileSlack slots, folds
//    when a buffer could not take the next slot, and also reads the shared
//    threshold at each tile. QB is chosen per call so that the selection
//    state and the ring fit one block's 227 KB (`tile_qb`, `tile_smem`).
//  - Merge: `merge_kernel`, four queries a block, reads the G*k winners
//    per query rank by rank across the blocks' sorted lists, drops every
//    winner below the final shared threshold before buffering, stops once
//    a whole rank after the last winner taken has been refused, and writes
//    int64 indices.
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

// Block-wide: fold, then publish each query's k-th best score to the
// shared threshold and read the threshold back.
__device__ void fold_and_share(Sel sel, int qb, int w, int k, unsigned* keys, int q_base) {
  fold_rank(sel, qb, w, k);
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
    if (full) fold_and_share(sel, NQ, w, k, keys, 0);
#pragma unroll
    for (int qq = 0; qq < NQ; ++qq) {
      if (lane == qq) {  // lane qq of the group offers query qq
        if (ra < r1) offer(sel, w, qq, valid[ra] ? sa[qq] : kMasked, ra);
        if (rb < r1) offer(sel, w, qq, valid[rb] ? sb[qq] : kMasked, rb);
      }
    }
  }
  __syncthreads();
  fold_and_share(sel, NQ, w, k, keys, 0);
  write_part(sel, NQ, w, k, part_s, part_i, NQ, 0);
}

// 16 or 4 bytes global -> shared; with full == false nothing is read and
// the bytes are zeroed.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(full ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The batched kernel's register tile: each thread scores TR rows against
// kTq queries. Depth chunks are kBk columns: each staged row is one
// 128-byte line of the matrix, read whole from memory, and laid out in
// shared memory with its eight 16-byte segments XOR-swizzled by the row's
// low three bits, so eight consecutive rows read at one depth hit eight
// different bank groups without padding.
constexpr int kTq = 8;
constexpr int kBk = 32;
// Candidate slots per query beyond the RT a round may fill: a fold is due
// once a query holds more than this many.
constexpr int kTileSlack = 32;
// Rows whose depth step is loaded together before it is summed: fewer
// live registers than the whole tile, so the next group's loads can be in
// flight during this group's FMAs.
constexpr int kTileGroup = 8;
__device__ __forceinline__ int swz(int row, int seg) { return ((seg ^ (row & 7)) << 2); }

// The batched kernel's selection state, per query: two best lists of k
// entries (the current one and the one the next fold writes) and a buffer
// of nc candidates; then the fold-due flags by round parity.
struct TileSel {
  float* bs[2];     // [qb][k] each
  int* bi[2];       // [qb][k] each
  float* cs;        // [qb][nc]
  int* ci;          // [qb][nc]
  int* count;       // [qb] candidates buffered
  float* thr_s;     // [qb] current k-th best score
  int* thr_i;       // [qb] current k-th best index
  unsigned* key;    // [qb] shared threshold as last read
  int* full;        // [4]: [0], [1] a fold is due after a round of that parity
};

__host__ __device__ size_t tile_sel_bytes(int qb, int k, int nc) {
  return (size_t)qb * (2 * k + nc) * (sizeof(float) + sizeof(int)) +
         (size_t)qb * (3 * sizeof(int) + sizeof(float)) + 4 * sizeof(int);
}

__device__ TileSel carve_tile(unsigned char* smem, int qb, int k, int nc) {
  TileSel sel;
  sel.bs[0] = reinterpret_cast<float*>(smem);
  sel.bs[1] = sel.bs[0] + qb * k;
  sel.bi[0] = reinterpret_cast<int*>(sel.bs[1] + qb * k);
  sel.bi[1] = sel.bi[0] + qb * k;
  sel.cs = reinterpret_cast<float*>(sel.bi[1] + qb * k);
  sel.ci = reinterpret_cast<int*>(sel.cs + qb * nc);
  sel.count = sel.ci + qb * nc;
  sel.thr_s = reinterpret_cast<float*>(sel.count + qb);
  sel.thr_i = sel.count + 2 * qb;
  sel.key = reinterpret_cast<unsigned*>(sel.count + 3 * qb);
  sel.full = sel.count + 4 * qb;
  return sel;
}

// Block-wide: merge the candidates of queries [0, qb) into best list
// `cur`, writing the k best to list cur ^ 1, then publish each query's new
// k-th best to the shared threshold. Every entry finds its place alone:
// a candidate after the best entries better than it (binary search) and
// the candidates better than it; a best entry j after j best entries and
// the candidates better than it. All (score, index) pairs differ (a row is
// offered once per query and block; the empty entries, all alike, lie
// below every candidate and keep their order), so the places are a
// permutation and the fold costs what the candidates cost: one barrier,
// and work in count * (count + k) per query. The atomicMax that publishes
// the new k-th best returns the best any block has published, which the
// block takes as its threshold from then on: after a few folds across the
// grid, a block admits little beyond its final candidates.
__device__ __noinline__ void tile_fold(TileSel sel, int qb, int k, int nc, int cur,
                                       unsigned* keys, int q_base) {
  const float* obs = sel.bs[cur];
  const int* obi = sel.bi[cur];
  float* nbs = sel.bs[cur ^ 1];
  int* nbi = sel.bi[cur ^ 1];
  const int per = nc + k;
  for (int p = threadIdx.x; p < qb * per; p += blockDim.x) {
    const int q = p / per, j = p % per, cnt = sel.count[q];
    const float* cs = sel.cs + q * nc;
    const int* ci = sel.ci + q * nc;
    float s;
    int i, pos;
    if (j < nc) {
      if (j >= cnt) continue;
      s = cs[j];
      i = ci[j];
      int lo = 0, hi = k;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (better(obs[q * k + mid], obi[q * k + mid], s, i)) lo = mid + 1; else hi = mid;
      }
      pos = lo;
    } else {
      pos = j - nc;
      s = obs[q * k + pos];
      i = obi[q * k + pos];
    }
    // candidates better than (s, i), four at a time by 16-byte loads (nc
    // and the buffers' offsets are multiples of 4), stopping once past k
    int j2 = 0;
    for (; j2 + 4 <= cnt && pos < k; j2 += 4) {
      const float4 s4 = *reinterpret_cast<const float4*>(cs + j2);
      const int4 i4 = *reinterpret_cast<const int4*>(ci + j2);
      pos += better(s4.x, i4.x, s, i) + better(s4.y, i4.y, s, i) + better(s4.z, i4.z, s, i) +
             better(s4.w, i4.w, s, i);
    }
    for (; j2 < cnt && pos < k; ++j2) pos += better(cs[j2], ci[j2], s, i);
    if (pos < k) {
      nbs[q * k + pos] = s;
      nbi[q * k + pos] = i;
    }
  }
  __syncthreads();
  for (int q = threadIdx.x; q < qb; q += blockDim.x) {
    sel.count[q] = 0;
    sel.thr_s[q] = nbs[q * k + k - 1];
    sel.thr_i[q] = nbi[q * k + k - 1];
    const unsigned mine = key_of(sel.thr_s[q]);
    sel.key[q] = max(max(atomicMax(&keys[q_base + q], mine), mine), sel.key[q]);
  }
  __syncthreads();
}

// Stage 1 for B >= 5. A block takes QB queries (grid.y groups) and one
// contiguous row range (grid.x ranges), walked in tiles of BM rows. Each
// depth chunk of BK columns of the tile's rows and of the block's queries
// arrives by cp.async in a ring of STAGES buffers, [row][BK] floats
// (swizzled), while the chunk before it is scored: thread (rt, qt) keeps
// rows rt + RT*i (i < TR) against queries qt + NQT*j (j < kTq) in
// registers, and reads four depth columns of each with one 16-byte shared
// load: TR + 8 loads per 32 * TR FMAs. Every (query, row) sum runs over
// the depth in order. When a tile's last chunk is scored, its scores are
// offered row slot by row slot (RT rows per query each) into buffers of
// RT + kTileSlack slots, with a fold whenever a buffer could not take the
// next slot. VEC copies 16 bytes at a time (D % 4 == 0, 16-byte aligned
// bases); otherwise 4.
template <int QB, int TR, int STAGES, bool VEC>
__global__ void __launch_bounds__(kThreads, 1)
rtile_kernel(const float* __restrict__ queries, const float* __restrict__ matrix,
             const unsigned char* __restrict__ valid, float* __restrict__ part_s,
             int* __restrict__ part_i, unsigned* __restrict__ keys,
             int B, int C, int D, int k) {
  constexpr int NQT = QB / kTq;       // threads along the queries
  constexpr int RT = kThreads / NQT;  // threads along the rows
  constexpr int NC = RT + kTileSlack;  // candidate slots per query
  static_assert(NC % 4 == 0, "tile_fold reads the candidates by fours");
  constexpr int BM = TR * RT;         // rows per tile
  constexpr int BK = kBk;
  constexpr int STAGE = (BM + QB) * BK;
  static_assert(RT % 8 == 0 && BK == 32, "the swizzle needs 8 segments and rows by eights");
  extern __shared__ __align__(16) unsigned char smem[];
  const TileSel sel = carve_tile(smem, QB, k, NC);
  float* ring = reinterpret_cast<float*>(smem + tile_sel_bytes(QB, k, NC));
  unsigned char* vbuf = reinterpret_cast<unsigned char*>(ring + STAGES * STAGE);  // [BM]

  const int t = threadIdx.x;
  const int qt = t % NQT, rt = t / NQT;
  const int q_base = blockIdx.y * QB;
  const int nq = min(QB, B - q_base);
  const int per_block = (C + gridDim.x - 1) / gridDim.x;
  const int r0 = min(C, blockIdx.x * per_block);
  const int r1 = min(C, r0 + per_block);
  const int kc = (D + BK - 1) / BK;
  const int n_chunks = (r1 - r0 + BM - 1) / BM * kc;
  for (int p = t; p < 2 * QB * k; p += kThreads) {  // both lists, one run of memory
    sel.bs[0][p] = -CUDART_INF_F;
    sel.bi[0][p] = kNoIndex;
  }
  if (t < QB) {
    sel.count[t] = 0;
    sel.thr_s[t] = -CUDART_INF_F;
    sel.thr_i[t] = kNoIndex;
    sel.key[t] = t < nq ? keys[q_base + t] : 0u;
  }
  if (t < 2) sel.full[t] = 0;
  __syncthreads();

  // chunk c: depth columns (c % kc) * BK.. of tile c / kc, and of the
  // queries, into buffer c % STAGES; past the last chunk an empty group
  auto load = [&](int c) {
    if (c < n_chunks) {
      float* dst = ring + (c % STAGES) * STAGE;
      const int tr0 = r0 + c / kc * BM, c0 = c % kc * BK;
      constexpr int PER = VEC ? 4 : 1;  // floats per copy
      for (int e = t; e < (BM + QB) * (BK / PER); e += kThreads) {
        const int row = e / (BK / PER), col = e % (BK / PER) * PER;
        const bool is_row = row < BM;
        const int g = is_row ? tr0 + row : q_base + row - BM;
        const bool ok = (is_row ? g < r1 : g < B) && c0 + col < D;
        const float* src = ok ? (is_row ? matrix : queries) + (size_t)g * D + c0 + col : matrix;
        float* at = dst + row * BK + swz(row, col >> 2) + (col & 3);
        if constexpr (VEC) cp_async16(at, src, ok);
        else cp_async4(at, src, ok);
      }
    }
    cp_async_commit();
  };

  float acc[TR][kTq];
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int j = 0; j < kTq; ++j) acc[i][j] = 0.f;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) load(s);
  int round = 0, cur = 0;
  unsigned shared_key = 0;
  for (int c = 0; c < n_chunks; ++c) {
    const int tr0 = r0 + c / kc * BM;
    // at a tile's first chunk: its rows' validity to shared memory, and
    // the shared threshold, taken in before its offers, so the load's
    // latency hides behind the tile
    if (c % kc == 0)
      for (int r = t; r < BM; r += kThreads) vbuf[r] = tr0 + r < r1 ? valid[tr0 + r] : 0;
    if (t < nq) {
      if (c % kc == 0) shared_key = __ldcg(keys + q_base + t);
      if (c % kc == kc - 1) sel.key[t] = max(sel.key[t], shared_key);
    }
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // chunk c has landed; every thread is done with c - 1
    load(c + STAGES - 1);
    const float* st = ring + (c % STAGES) * STAGE;
    constexpr int H = TR < kTileGroup ? TR : kTileGroup;  // rows per group of loads
    // the chunk's eight 4-column steps are not unrolled, so the loop body
    // stays in the instruction cache
#pragma unroll 1
    for (int kk = 0; kk < BK / 4; ++kk) {
      float4 b[kTq];
#pragma unroll
      for (int j = 0; j < kTq; ++j) {
        const int row = BM + qt + NQT * j;
        b[j] = *reinterpret_cast<const float4*>(st + row * BK + swz(row, kk));
      }
#pragma unroll
      for (int h = 0; h < TR; h += H) {
        if (tr0 + RT * h >= r1) break;  // the rest of the tile lies past the block's rows
        float4 a[H];
#pragma unroll
        for (int i = 0; i < H; ++i)  // RT % 8 == 0: every row of this thread swizzles alike
          a[i] = *reinterpret_cast<const float4*>(st + (rt + RT * (h + i)) * BK + swz(rt, kk));
        // one depth column at a time over the whole tile: each FMA's
        // neighbours are independent, and every sum still runs in depth order
#pragma unroll
        for (int i = 0; i < H; ++i)
#pragma unroll
          for (int j = 0; j < kTq; ++j) acc[h + i][j] = fmaf(b[j].x, a[i].x, acc[h + i][j]);
#pragma unroll
        for (int i = 0; i < H; ++i)
#pragma unroll
          for (int j = 0; j < kTq; ++j) acc[h + i][j] = fmaf(b[j].y, a[i].y, acc[h + i][j]);
#pragma unroll
        for (int i = 0; i < H; ++i)
#pragma unroll
          for (int j = 0; j < kTq; ++j) acc[h + i][j] = fmaf(b[j].z, a[i].z, acc[h + i][j]);
#pragma unroll
        for (int i = 0; i < H; ++i)
#pragma unroll
          for (int j = 0; j < kTq; ++j) acc[h + i][j] = fmaf(b[j].w, a[i].w, acc[h + i][j]);
      }
    }
    if (c % kc != kc - 1) continue;
    // the tile is scored: offer row slot i of every thread (RT rows per
    // query), then fold if a query's buffer could not take another slot
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int row = tr0 + rt + RT * i;
      if (row < r1) {
        const bool ok = vbuf[rt + RT * i] != 0;
#pragma unroll
        for (int j = 0; j < kTq; ++j) {
          const int q = qt + NQT * j;
          const float s = ok ? acc[i][j] : kMasked;
          if (q < nq && key_of(s) >= sel.key[q] && better(s, row, sel.thr_s[q], sel.thr_i[q])) {
            const int slot = atomicAdd(&sel.count[q], 1);
            sel.cs[q * NC + slot] = s;
            sel.ci[q * NC + slot] = row;
            if (slot >= NC - RT) sel.full[round & 1] = 1;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kTq; ++j) acc[i][j] = 0.f;
      // one barrier a round: round r sets full[r & 1], which no thread
      // reads again before every thread has passed round r + 1's barrier
      __syncthreads();
      if (sel.full[round & 1]) {
        tile_fold(sel, nq, k, NC, cur, keys, q_base);
        cur ^= 1;
        if (t == 0) sel.full[round & 1] = 0;
      }
      ++round;
    }
  }
  tile_fold(sel, nq, k, NC, cur, keys, q_base);
  cur ^= 1;
  for (int p = t; p < nq * k; p += kThreads) {
    const int ql = p / k, j = p % k;
    const size_t off = ((size_t)blockIdx.x * B + q_base + ql) * k + j;
    part_s[off] = sel.bs[cur][ql * k + j];
    part_i[off] = sel.bi[cur][ql * k + j];
  }
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
  static_assert(QB * W <= kRankP * kThreads, "the merge folds by ranking");
  const int limit = min(W - STEP, max(k, STEP));
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
    if (full) fold_rank(sel, nq, W, k);
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
  fold_rank(sel, nq, W, k);
  for (int p = t; p < nq * k; p += kThreads) {
    const int ql = p / k, j = p % k;
    const size_t off = (size_t)(q_base + ql) * k + j;
    out_s[off] = sel.s[ql * 2 * W + j];
    out_i[off] = sel.i[ql * 2 * W + j];
  }
}

// -- host side ---------------------------------------------------------------

// merge_kernel's shape: blocks of 4 queries, 128 winners per query per
// step, folds by ranking; B <= 4 in one block.
constexpr int kMergeStep = 128, kMergeQpt = 2, kMergeQ = 4;

size_t merge_smem(int qb, int w) { return sel_bytes(qb, w) + qb * sizeof(int); }

// The batched kernel's shape by query width QB: rows per thread (TR), so
// that a block covers TR * tile_rt(QB) = 512 rows at every QB, and two ring
// stages. QB = 16 must fit k = 256 (`tile_qb`).
constexpr int kTileStages = 2;
constexpr int tile_tr(int qb) { return qb / 4; }
// rows a round offers per query (threads along the rows)
constexpr int tile_rt(int qb) { return kThreads * kTq / qb; }

// A block's shared memory: 227 KB on the H100. The batched kernel asks for
// all of it, one block per SM, whatever the call needs.
constexpr size_t kSmemMax = 232448;

using TileFn = void (*)(const float*, const float*, const unsigned char*, float*, int*,
                        unsigned*, int, int, int, int);

template <int QB>
TileFn tile_for(bool vec) {
  if (vec) return rtile_kernel<QB, tile_tr(QB), kTileStages, true>;
  return rtile_kernel<QB, tile_tr(QB), kTileStages, false>;
}

size_t tile_smem(int qb, int k) {
  const int bm = tile_tr(qb) * tile_rt(qb);
  const size_t ring = (size_t)kTileStages * (bm + qb) * kBk * sizeof(float);
  return tile_sel_bytes(qb, k, tile_rt(qb) + kTileSlack) + ring + bm;
}

// Queries per block: the smallest of 16, 32 and 64 that holds B, so the
// matrix is read once up to B = 64, and up to B = 32 the padded FMAs (QB / B
// times the needed ones) stay under the byte time. The selection state
// grows with QB * k, so a wide k that would not fit takes a narrower QB and
// the matrix is read once per QB queries (k > 49 above B = 32 takes
// QB = 32, k > 131 takes 16).
int tile_qb(int B, int k) {
  int qb = B <= 16 ? 16 : B <= 32 ? 32 : 64;
  while (qb > 16 && tile_smem(qb, k) > kSmemMax) qb /= 2;
  return qb;
}

TileFn pick_tile(int qb, bool vec) {
  switch (qb) {
    case 16: return tile_for<16>(vec);
    case 32: return tile_for<32>(vec);
    default: return tile_for<64>(vec);
  }
}

bool aligned16(const void* q, const void* m, int D) {
  return D % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(m) % 16 == 0;
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
  const bool vec = aligned16(q, m, D) && D <= 4 * 32 * kScanV;
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
  // one wave of row ranges per query group, at least 64 rows each
  const int qb = tile_qb(B, k);
  int occ = 0;
  e = prepare(reinterpret_cast<const void*>(pick_tile(qb, aligned16(q, m, D))), kSmemMax,
              &occ);
  if (e != cudaSuccess) return -(int)e;
  const int groups = (B + qb - 1) / qb;
  const int wave = (max(1, occ) * sms + groups - 1) / groups;
  return max(1, min(wave, (C + 63) / 64));
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
  } else {
    const int qb = tile_qb(B, k);
    const size_t sm = tile_smem(qb, k);
    if (sm > kSmemMax) return cudaErrorInvalidConfiguration;
    const TileFn tile = pick_tile(qb, aligned16(queries, matrix, D));
    e = prepare(reinterpret_cast<const void*>(tile), kSmemMax, &occ);
    if (e != cudaSuccess) return e;
    tile<<<dim3(G, (B + qb - 1) / qb), kThreads, sm, st>>>(q, m, v, ps, pi, keys, B, C, D, k);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  auto merge = merge_kernel<kMergeStep, kMergeQpt, kMaxW>;
  const size_t sm = merge_smem(kMergeQ, kMaxW);
  e = prepare(reinterpret_cast<const void*>(merge), sm, &occ);
  if (e != cudaSuccess) return e;
  merge<<<(B + kMergeQ - 1) / kMergeQ, kThreads, sm, st>>>(ps, pi, keys, os, oi, B, G, k);
  return cudaGetLastError();
}

const char* nornic_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
