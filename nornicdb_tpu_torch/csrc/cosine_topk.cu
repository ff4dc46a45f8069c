// Fused exact cosine top-k for Hopper (sm_90a).
//
// Replaces: nornicdb_tpu/ops/pallas_topk.py, `_fused_cosine_topk_impl`
// (pl.pallas_call over `_block_topk_kernel`) and its global lax.top_k merge.
//
// What it computes: for L2-normalized queries [B, D] against a
// capacity-padded matrix [C, D] with a validity mask [C], the k best rows
// per query by dot product, masked rows scoring -1e30, ties resolved to
// the LOWER row index. The [B, C] score matrix is never written to device
// memory. Any B, any D, any C, 1 <= k <= 256.
//
// What bounds it on the H100: it streams the matrix once per query group,
// C*D*4 bytes, and does 2*B*C*D float32 FLOPs. Exact float32 rules out the
// tensor cores (TF32 keeps ~3 digits), so the compute roof is the 67
// TFLOP/s of the float32 FMA units; the memory roof is 3.35 TB/s. At B=1
// the kernel is bound by bytes, at B=64 by operations.
//
// What this simple design does about it:
//  - Stage 1: a grid of G blocks x ceil(B/QB) query groups. Each block
//    walks the 64-row tiles t = blockIdx.x, +G, ... in increasing row
//    order. A tile and the group's queries are staged in shared memory in
//    128-column chunks, and each thread accumulates QPT dot products with
//    sequential fmaf (exact float32, deterministic order). Each query keeps
//    a sorted best list of W >= k entries plus a candidate buffer of W
//    slots in shared memory; a score enters the buffer only if it beats
//    the query's current k-th best (so after a few tiles almost nothing
//    does), and when a buffer could overflow, a block-wide bitonic sort of
//    (best | candidates) by (score desc, index asc) folds it in.
//  - Stage 2: the same kernel in merge mode reads the G per-block winner
//    lists instead of computing dots, and writes the final [B, k].
// Fast versions (wgmma-free float32 tiling, TMA staging, register top-k)
// are later work; this one is right first.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileRows = 64;  // rows (or candidates) per tile
constexpr int kChunk = 128;    // D-columns staged per step
constexpr int kMaxW = 256;     // widest best list / candidate buffer (k <= 256)
constexpr float kMasked = -1e30f;
constexpr int kNoIndex = 0x7fffffff;

// (sa, ia) ranks before (sb, ib): higher score, then lower index.
__device__ __forceinline__ bool better(float sa, int ia, float sb, int ib) {
  return sa > sb || (sa == sb && ia < ib);
}

struct Sel {
  float* s;      // [QB][2W] scores: best in [0, W), candidates in [W, 2W)
  int* i;        // [QB][2W] indices
  int* count;    // [QB] candidates buffered
  float* thr_s;  // [QB] current k-th best score
  int* thr_i;    // [QB] current k-th best index
};

// Block-wide: fold every query's candidates into its best list.
__device__ void fold(Sel sel, int qb, int w, int k) {
  const int n = 2 * w;
  for (int p = threadIdx.x; p < qb * w; p += blockDim.x) {
    const int q = p / w, j = p % w;
    if (j >= sel.count[q]) {
      sel.s[q * n + w + j] = -CUDART_INF_F;
      sel.i[q * n + w + j] = kNoIndex;
    }
  }
  __syncthreads();
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int p = threadIdx.x; p < qb * w; p += blockDim.x) {
        const int q = p / w, j = p % w;
        const int a = 2 * stride * (j / stride) + (j % stride);
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

__device__ __forceinline__ void offer(Sel sel, int w, int q, float s, int idx) {
  if (better(s, idx, sel.thr_s[q], sel.thr_i[q])) {
    const int slot = atomicAdd(&sel.count[q], 1);
    sel.s[q * 2 * w + w + slot] = s;
    sel.i[q * 2 * w + w + slot] = idx;
  }
}

size_t smem_bytes(int qb, int w, bool merge) {
  size_t b = (size_t)qb * 2 * w * (sizeof(float) + sizeof(int)) +
             (size_t)qb * (2 * sizeof(int) + sizeof(float));
  if (!merge) b += ((size_t)qb * kChunk + (size_t)kTileRows * (kChunk + 1)) * sizeof(float);
  return b;
}

// MERGE=false: items are matrix rows (stage 1), output [gridDim.x][B][k].
// MERGE=true: items are the n_parts*k winners per query of stage 1, read
// from (in_s, in_i) laid out [n_parts][B][k]; output [B][k].
template <int QPT, bool MERGE>
__global__ void __launch_bounds__(kThreads)
topk_kernel(const float* __restrict__ queries, const float* __restrict__ matrix,
            const unsigned char* __restrict__ valid,
            const float* __restrict__ in_s, const int* __restrict__ in_i,
            float* __restrict__ out_s, int* __restrict__ out_i,
            int B, int n_items, int D, int k, int w) {
  constexpr int QB = 4 * QPT;
  extern __shared__ __align__(16) unsigned char smem[];
  const int n2 = 2 * w;
  Sel sel;
  sel.s = reinterpret_cast<float*>(smem);
  sel.i = reinterpret_cast<int*>(sel.s + QB * n2);
  sel.count = sel.i + QB * n2;
  sel.thr_s = reinterpret_cast<float*>(sel.count + QB);
  sel.thr_i = reinterpret_cast<int*>(sel.thr_s + QB);
  float* q_s = reinterpret_cast<float*>(sel.thr_i + QB);  // [QB][kChunk]
  float* m_s = q_s + QB * kChunk;                          // [64][kChunk+1]

  const int t = threadIdx.x;
  const int r = t % kTileRows;   // tile row this thread scores
  const int qg = t / kTileRows;  // its group of QPT queries
  const int q_base = blockIdx.y * QB;

  for (int p = t; p < QB * n2; p += kThreads) {
    sel.s[p] = -CUDART_INF_F;
    sel.i[p] = kNoIndex;
  }
  for (int q = t; q < QB; q += kThreads) {
    sel.count[q] = 0;
    sel.thr_s[q] = -CUDART_INF_F;
    sel.thr_i[q] = kNoIndex;
  }
  __syncthreads();

  const int n_tiles = (n_items + kTileRows - 1) / kTileRows;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    bool full = false;
    for (int q = 0; q < QB; ++q) full |= sel.count[q] > w - kTileRows;
    if (full) fold(sel, QB, w, k);  // uniform: every thread read the same counts

    const int item = tile * kTileRows + r;
    if (!MERGE) {
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
          m_s[rr * (kChunk + 1) + c] =
              (grow < n_items && gc < D) ? matrix[(size_t)grow * D + gc] : 0.f;
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
      if (item < n_items) {
        const bool ok = valid[item] != 0;
#pragma unroll
        for (int j = 0; j < QPT; ++j) {
          const int ql = qg * QPT + j;
          if (q_base + ql < B) offer(sel, w, ql, ok ? acc[j] : kMasked, item);
        }
      }
    } else if (item < n_items) {
      const int part = item / k, jj = item % k;
#pragma unroll
      for (int j = 0; j < QPT; ++j) {
        const int ql = qg * QPT + j;
        const int gq = q_base + ql;
        if (gq < B) {
          const size_t off = ((size_t)part * B + gq) * k + jj;
          offer(sel, w, ql, in_s[off], in_i[off]);
        }
      }
    }
    __syncthreads();
  }
  fold(sel, QB, w, k);

  for (int p = t; p < QB * k; p += kThreads) {
    const int ql = p / k, j = p % k;
    const int gq = q_base + ql;
    if (gq < B) {
      const size_t off = ((size_t)blockIdx.x * B + gq) * k + j;
      out_s[off] = sel.s[ql * n2 + j];
      out_i[off] = sel.i[ql * n2 + j];
    }
  }
}

template <int QPT>
int launch(const float* q, const float* m, const unsigned char* valid,
           float* part_s, int* part_i, float* out_s, int* out_i,
           int B, int C, int D, int k, int G, int w, cudaStream_t st) {
  constexpr int QB = 4 * QPT;
  // A wider candidate buffer means fewer folds (one per W - 64 buffered
  // candidates). It costs QB*2W*8 bytes of shared memory, cheap for a
  // 4-query group and for the single-block merge stage; 32-query stage-1
  // blocks keep W = max(64, k) so two of them fit on an SM.
  const int w1 = QPT == 1 ? kMaxW : w;
  const dim3 grid1(G, (B + QB - 1) / QB);
  const size_t sm1 = smem_bytes(QB, w1, false);
  cudaError_t e = cudaFuncSetAttribute(topk_kernel<QPT, false>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sm1);
  if (e != cudaSuccess) return e;
  topk_kernel<QPT, false><<<grid1, kThreads, sm1, st>>>(
      q, m, valid, nullptr, nullptr, part_s, part_i, B, C, D, k, w1);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 grid2(1, grid1.y);
  const size_t sm2 = smem_bytes(QB, kMaxW, true);
  e = cudaFuncSetAttribute(topk_kernel<QPT, true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sm2);
  if (e != cudaSuccess) return e;
  topk_kernel<QPT, true><<<grid2, kThreads, sm2, st>>>(
      nullptr, nullptr, nullptr, part_s, part_i, out_s, out_i, B, G * k, D, k, kMaxW);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// queries [B, D] f32, matrix [C, D] f32, valid [C] bool (1 byte each),
// part_s/part_i [G, B, k] scratch, out_s/out_i [B, k]. Launches on
// `stream`, does not synchronise, returns cudaGetLastError().
int nornic_cosine_topk(const void* queries, const void* matrix, const void* valid,
                       void* part_s, void* part_i, void* out_s, void* out_i,
                       int B, int C, int D, int k, int G, void* stream) {
  if (B < 1 || C < 1 || D < 1 || k < 1 || k > kMaxW || k > C || G < 1)
    return cudaErrorInvalidValue;
  int w = 64;
  while (w < k) w <<= 1;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* q = static_cast<const float*>(queries);
  const auto* m = static_cast<const float*>(matrix);
  const auto* v = static_cast<const unsigned char*>(valid);
  auto* ps = static_cast<float*>(part_s);
  auto* pi = static_cast<int*>(part_i);
  auto* os = static_cast<float*>(out_s);
  auto* oi = static_cast<int*>(out_i);
  if (B <= 4) return launch<1>(q, m, v, ps, pi, os, oi, B, C, D, k, G, w, st);
  return launch<8>(q, m, v, ps, pi, os, oi, B, C, D, k, G, w, st);
}

// Queries per block group for a batch of B (the wrapper sizes G from it).
int nornic_cosine_topk_group(int B) { return B <= 4 ? 4 : 32; }

const char* nornic_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
