// Exact (flash) softmax attention, forward only, for Hopper (sm_90a).
//
// Replaces: nornicdb_tpu/ops/pallas_attention.py, `flash_attention`
// (pl.pallas_call over `_flash_kernel`).
//
// What it computes: for q, k, v [B, S, H, Dh] and a key mask [B, S],
// out = softmax(q k^T * Dh^-0.5) v per (batch, head), masked keys at
// -1e30, with float32 scores, running max, running denominator and
// accumulator, rounded once to the input's type at the end. Keys past S
// are not part of the softmax, so a fully masked row averages uniformly
// over its S real keys, as `reference_attention` does. No backward: the
// JAX kernel has no vjp and the encoder uses it for inference only.
//
// Two kernels, chosen by the input's type:
//
// bfloat16 (the main path: the default encoder runs in bf16).
//   Bound on the H100: 4*B*H*S^2*Dh FLOPs on the bf16 tensor cores
//   (989 TFLOP/s) against 4*B*S*H*Dh*2 bytes at 3.35 TB/s; the roofs
//   cross near S = 590, so every width bucket up to the encoders' 512 is
//   bound by bytes, and at the short buckets (S = 16..64) by the launch
//   and the latency of one load.
//   Design: each warp owns 16 query rows of one (b, h); a block holds 4
//   such warps where that still leaves at least 128 blocks (about one per
//   SM), else 2. Q.K^T and P.V run as mma.sync m16n8k16 (bf16 in, f32 sums).
//   The Q.K^T depth is Dh padded with zeros to a multiple of 16; products
//   of bf16 values are exact, so the scores are f32 sums as in the
//   reference. The online softmax runs on the score fragments in
//   registers, with the row max shared by the four lanes of a row through
//   shuffles, and p = 2^((s - max) * c) with one MUFU.EX2 (c = scale *
//   log2(e)). p stays f32 in the reference, so each score fragment
//   pair becomes two A fragments, hi = bf16(p) and lo = bf16(p - hi), and
//   P.V is two MMAs: ~16 mantissa bits of p, against bf16's 8. K and V
//   tiles of 64 keys arrive by 16-byte cp.async (zero-filled past S) into
//   padded shared memory, two stages, so the next tile loads while this one
//   computes; ldmatrix reads the fragments (.trans for V, which is [keys,
//   Dh] row-major and serves as the column-major B operand). Each warp
//   turns the tile's mask into two ballot words. Keys past S in the last
//   tile score -inf: the running max starts at -1e30, so they get p = 0
//   even in a fully masked row, whose real keys score -1e30 and get p = 1.
//   No atomics, so two calls are bitwise equal.
//
// float32 (exact embeddings: `EncoderConfig.mini()` and the f32 embedder).
//   Exact f32 on the FMA units only: no TF32, no split products on the
//   tensor cores. Bound on the H100: 2*B*H*S^2*Dh FMAs at 67 TFLOP/s
//   against 4*B*S*H*Dh*4 bytes at 3.35 TB/s; the roofs cross at S = 80,
//   so the short buckets (S <= 64) are bound by bytes, and in practice by
//   the launch and the latency of one load, the long ones by the FMAs.
//   Design: a block holds QR = 64, 32 or 16 query rows of one (b, h); QR
//   is the widest that still leaves at least 128 blocks (about one per
//   SM), so the ingest shape (B*H = 64, S = 64) spreads over the card. Each
//   thread owns a 4 x 4 register tile of scores and reads Q and K from
//   shared memory as 16-byte vectors along the depth: 8 loads feed 64
//   FMAs, against one load per FMA in a thread-per-row kernel. Rows are
//   padded by 16 bytes, an odd number of 16-byte chunks, so the 16-byte
//   reads of consecutive rows fall on distinct banks. Each score is one
//   fmaf chain over the depth in order. The 16 (or 8) lanes that share a
//   row combine its max and sum by xor shuffles; p = 2^((s - max) * c)
//   with one MUFU.EX2 (relative error ~2^-22, as expf's), s unscaled, as
//   in the bf16 kernel. A warp owns the same rows in both products, so p
//   goes through shared memory, transposed ([key][row]), with only a warp
//   barrier: P.V reads several rows' p in one load beside one of V, each
//   thread owning an output tile of 1 x 4 to 4 x 8 and summing the tile's
//   keys in order. K and V tiles arrive by 16-byte cp.async, zero-filled
//   past S, two stages: the next tile is requested before this one is
//   summed. A thread's copy chunk is fixed and its rows step by a
//   constant: no division per element. 64-row blocks (long sequences)
//   stage 32 keys a tile, narrower ones 64, so that four 64-row blocks fit
//   an SM at Dh 40 and the long-document bucket runs in one wave. The next
//   tile's mask bytes are loaded into a register before the sums and
//   stored after them. One block barrier per tile; no atomics, so two
//   calls are bitwise equal.
//   Device ms per call (chip_smoke.py on an NVIDIA H100 80GB HBM3 at
//   700.00 W; B, S, H, Dh): 16, 64, 4, 40 0.0046 (the earlier
//   thread-per-row kernel 0.0236, SDPA 0.0138); 1, 16, 4, 40 0.0041;
//   16, 512, 4, 40 0.0852 (47% of the FMA roof); 8, 512, 16, 64 0.2515
//   (51%).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>
#include <set>
#include <utility>

namespace {

constexpr int kKeys = 64;  // keys per staged kv tile of the bf16 kernel
constexpr float kNegInf = -1e30f;
constexpr int kMinBlocks = 128;  // about one block per SM of the H100's 132

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with full == false nothing is read and the
// 16 bytes are zeroed.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 2^x in one MUFU.EX2 (relative error ~2^-22); 2^-inf = 0.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// -- float32: register tiles on the FMA units ------------------------------

constexpr int kPad = 4;  // floats of padding after each staged row

// Keys per staged kv tile of a block of QR query rows: 32 in 64-row
// blocks, so that four blocks fit an SM's shared memory at Dh 40 and the
// long-document bucket's 512 blocks run in one wave; 64 in narrower ones.
// Each thread owns a 4 x 4 tile of scores.
__host__ __device__ constexpr int f32_tile_keys(int qr) { return qr == 64 ? 32 : 64; }
__host__ __device__ constexpr int f32_threads(int qr) { return qr * f32_tile_keys(qr) / 16; }

constexpr size_t f32_smem_bytes(int dh, int qr) {
  return (size_t)(qr * (dh + kPad)                          // Q
                  + 4 * f32_tile_keys(qr) * (dh + kPad)     // K and V, two stages each
                  + f32_tile_keys(qr) * (qr + kPad)         // p, [key][row]
                  + 2 * qr) * sizeof(float)                 // rescale and denominator
         + 2 * f32_tile_keys(qr);                           // mask bytes, two stages
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// N consecutive floats from shared memory (aligned to 4 * N bytes) in one load.
template <int N>
__device__ __forceinline__ void rows_of(float (&x)[N], const float* p) {
  if constexpr (N == 4) {
    const float4 y = ld4(p);
    x[0] = y.x, x[1] = y.y, x[2] = y.z, x[3] = y.w;
  } else if constexpr (N == 2) {
    const float2 y = *reinterpret_cast<const float2*>(p);
    x[0] = y.x, x[1] = y.y;
  } else {
    x[0] = *p;
  }
}

// At most 128 registers a thread: four 128-thread blocks an SM.
template <int DH, int QR>
__global__ void __launch_bounds__(f32_threads(QR), 512 / f32_threads(QR))
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const unsigned char* __restrict__ mask,
                 float* __restrict__ out, int S, int H, float scale) {
  constexpr int kThreads = f32_threads(QR);
  constexpr int kTile = f32_tile_keys(QR);  // keys per staged kv tile
  constexpr int kLanes = kTile / 4;         // lanes that share a row: 8 or 16; a
                                            // thread's keys are kg + kLanes * j
  constexpr int kRowStep = 32 / kLanes;          // rows r0 + kRowStep * i of a thread
  constexpr int kWarpRows = 4 * kRowStep;        // rows of a warp: 16 or 8
  constexpr int kStride = DH + kPad;   // floats per staged Q, K or V row: an odd
                                       // number of 16-byte chunks
  constexpr int kPStride = QR + kPad;  // floats per key of p
  constexpr int kChunks = DH / 4;      // 16-byte chunks per head row
  // P.V: each thread owns an output tile of kPvRows rows by the columns
  // 4c + 32u..+3 (u < kQuads), at Dh 40 plus column 32 + c: 1 x 4, 2 x 4,
  // 2 x 5 or 4 x 4 in narrow blocks (Dh 16, 32, 40, 64), 2 x 4, 4 x 4,
  // 4 x 5 or 4 x 8 in 64-row ones.
  constexpr int kQuads = DH == 64 && kWarpRows == 16 ? 2 : 1;
  constexpr int kTail = DH == 40 ? 1 : 0;
  constexpr int kCols = DH == 40 ? 8 : DH / (4 * kQuads);  // column groups c
  constexpr int kPvRows = kWarpRows * kCols / 32;
  constexpr int kOut = 4 * kQuads + kTail;  // columns of a thread's output tile
  static_assert(DH == 16 || DH == 32 || DH == 40 || DH == 64, "head widths 16, 32, 40, 64");
  static_assert(4 * kCols * kQuads + kTail * kCols == DH, "the output tiles cover the row once");
  static_assert(QR % kWarpRows == 0 && kPvRows * 32 == kWarpRows * kCols,
                "a warp's output tiles cover its rows");
  static_assert(kThreads >= kTile, "a thread for each key's mask byte");

  extern __shared__ __align__(16) float sm[];
  float* q_s = sm;                          // [QR][kStride]
  float* k_s = q_s + QR * kStride;          // [2][kTile][kStride]
  float* v_s = k_s + 2 * kTile * kStride;   // [2][kTile][kStride]
  float* p_s = v_s + 2 * kTile * kStride;   // [kTile][kPStride]
  float* a_s = p_s + kTile * kPStride;      // [QR] this tile's rescale of each row
  float* l_s = a_s + QR;                    // [QR] each row's final denominator
  unsigned char* m_s = reinterpret_cast<unsigned char*>(l_s + QR);  // [2][kTile]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * QR;
  const float scale_log2 = scale * 1.4426950408889634f;
  const size_t pos_stride = (size_t)H * DH;          // elements between positions
  const size_t base = ((size_t)b * S * H + h) * DH;  // element (b, 0, h, 0)
  const unsigned char* mrow = mask + (size_t)b * S;

  // Rows [first, first + n) of src into rows of dst by 16-byte cp.async,
  // zeros past S. A row is copied as kCopyChunks chunks (at Dh 40 the
  // last 6 lanes of each 16 stay idle), so this thread's chunk is fixed
  // and its rows step by a constant: no division per element.
  constexpr int kCopyChunks = DH == 16 ? 4 : DH == 32 ? 8 : 16;
  constexpr int kCopyStep = kThreads / kCopyChunks;
  static_assert(QR % kCopyStep == 0 && kTile % kCopyStep == 0, "whole passes");
  const int c_part = tid % kCopyChunks, c_row = tid / kCopyChunks;
  auto stage = [&](float* dst, const float* src, int first, int n) {
    if (c_part >= kChunks) return;
#pragma unroll
    for (int r = c_row; r < n; r += kCopyStep) {
      const int s = first + r;
      cp_async16(dst + r * kStride + 4 * c_part,
                 src + base + (size_t)(s < S ? s : 0) * pos_stride + 4 * c_part, s < S);
    }
  };
  stage(q_s, q, q0, QR);
  stage(k_s, k, 0, kTile);
  stage(v_s, v, 0, kTile);
  cp_async_commit();
  if (tid < kTile) m_s[tid] = tid < S && mrow[tid];

  // A warp owns the same kWarpRows rows in both products, so p passes
  // from the scores to P.V within the warp.
  const int kg = lane % kLanes, r0 = kWarpRows * warp + lane / kLanes;
  float m_run[4], l_run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m_run[i] = kNegInf, l_run[i] = 0.f;
  const int pr = kWarpRows * warp + kPvRows * (lane / kCols), pc = 4 * (lane % kCols);
  float acc[kPvRows][kOut];
#pragma unroll
  for (int r = 0; r < kPvRows; ++r) {
#pragma unroll
    for (int c = 0; c < kOut; ++c) acc[r][c] = 0.f;
  }

  const int n_tiles = (S + kTile - 1) / kTile;
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1, kv0 = t * kTile;
    const float* ks = k_s + st * kTile * kStride;
    const float* vs = v_s + st * kTile * kStride;
    const unsigned char* ms = m_s + st * kTile;
    cp_async_wait<0>();
    __syncthreads();  // tile t has landed, and every thread is done with t - 1
    unsigned char m_next = 0;
    if (t + 1 < n_tiles) {
      stage(k_s + (st ^ 1) * kTile * kStride, k, kv0 + kTile, kTile);
      stage(v_s + (st ^ 1) * kTile * kStride, v, kv0 + kTile, kTile);
      cp_async_commit();
      if (tid < kTile && kv0 + kTile + tid < S) m_next = mrow[kv0 + kTile + tid];
    }

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    }
    const float* qp = q_s + r0 * kStride;
    const float* kp = ks + kg * kStride;
#pragma unroll
    for (int d = 0; d < DH; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = ld4(qp + kRowStep * i * kStride + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ld4(kp + kLanes * j * kStride + d);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sc[i][j] = fmaf(qv[i].x, kv[j].x, sc[i][j]);
          sc[i][j] = fmaf(qv[i].y, kv[j].y, sc[i][j]);
          sc[i][j] = fmaf(qv[i].z, kv[j].z, sc[i][j]);
          sc[i][j] = fmaf(qv[i].w, kv[j].w, sc[i][j]);
        }
      }
    }
    // Masked keys score -1e30, keys past S -inf: the running max starts
    // at -1e30 and never falls below it, so a key past S gets p = 0 even
    // in a fully masked row, whose real keys get p = 1. Scores stay
    // unscaled: scale > 0 commutes with the max and joins the exponent.
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = kg + kLanes * j;
      const float off = kv0 + key < S ? kNegInf : __int_as_float(0xff800000);
      const bool att = ms[key];
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[i][j] = att ? sc[i][j] : off;
    }
    // p = exp((s - max) * scale) = 2^((s - max) * c), c = scale * log2(e).
    // (Not fma(s, c, -max * c): at s = max = -1e30 that leaves the
    // rounding error of max * c, ~1e22, in the exponent.)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float tmax = sc[i][0];
#pragma unroll
      for (int j = 1; j < 4; ++j) tmax = fmaxf(tmax, sc[i][j]);
#pragma unroll
      for (int x = 1; x < kLanes; x <<= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, x));
      const float m_new = fmaxf(m_run[i], tmax);
      const float alpha = exp2_approx((m_run[i] - m_new) * scale_log2);
      m_run[i] = m_new;
      float lsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sc[i][j] = exp2_approx((sc[i][j] - m_new) * scale_log2);
        lsum += sc[i][j];
      }
#pragma unroll
      for (int x = 1; x < kLanes; x <<= 1) lsum += __shfl_xor_sync(0xffffffffu, lsum, x);
      l_run[i] = l_run[i] * alpha + lsum;
      const int row = r0 + kRowStep * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) p_s[(kg + kLanes * j) * kPStride + row] = sc[i][j];
      if (kg == 0) {
        a_s[row] = alpha;
        if (t + 1 == n_tiles) l_s[row] = l_run[i];
      }
    }
    __syncwarp();  // this warp's p and rescales are in shared memory

    float a[kPvRows];
    rows_of(a, a_s + pr);
#pragma unroll
    for (int r = 0; r < kPvRows; ++r) {
#pragma unroll
      for (int c = 0; c < kOut; ++c) acc[r][c] *= a[r];
    }
    const float* pp = p_s + pr;
    const float* vp = vs + pc;
#pragma unroll 16
    for (int j = 0; j < kTile; ++j) {
      float vv[kOut];
#pragma unroll
      for (int u = 0; u < kQuads; ++u) {
        const float4 v4 = ld4(vp + j * kStride + 32 * u);
        vv[4 * u] = v4.x, vv[4 * u + 1] = v4.y, vv[4 * u + 2] = v4.z, vv[4 * u + 3] = v4.w;
      }
      if constexpr (kTail > 0) vv[kOut - 1] = vs[j * kStride + 32 + pc / 4];
      float p[kPvRows];
      rows_of(p, pp + j * kPStride);
#pragma unroll
      for (int r = 0; r < kPvRows; ++r) {
#pragma unroll
        for (int c = 0; c < kOut; ++c) acc[r][c] = fmaf(p[r], vv[c], acc[r][c]);
      }
    }
    if (t + 1 < n_tiles && tid < kTile) m_s[(st ^ 1) * kTile + tid] = m_next;
  }

#pragma unroll
  for (int r = 0; r < kPvRows; ++r) {
    const int row = q0 + pr + r;
    if (row >= S) continue;
    const float l = fmaxf(l_s[pr + r], 1e-30f);
    float* o = out + base + (size_t)row * pos_stride;
#pragma unroll
    for (int u = 0; u < kQuads; ++u)
      *reinterpret_cast<float4*>(o + pc + 32 * u) = make_float4(
          acc[r][4 * u] / l, acc[r][4 * u + 1] / l, acc[r][4 * u + 2] / l, acc[r][4 * u + 3] / l);
    if constexpr (kTail > 0) o[32 + pc / 4] = acc[r][kOut - 1] / l;
  }
}

// -- bfloat16: warp tiles on the tensor cores ------------------------------

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// c += a . b for one 16x8x16 tile: a [16 x 16] bf16 row-major fragment,
// b [16 x 8] bf16 column-major fragment, c [16 x 8] f32.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<const uint32_t*>(&x);
}

// Two f32 values (lower column first) as bf16 pairs hi = bf16(x) and
// lo = bf16(x - hi): hi + lo keeps ~16 of x's 24 significant bits.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// At most 128 registers a thread (16 warps an SM), so at S = 512 a wave
// holds 528 blocks of 4 warps: the mini encoder's 512 in one.
template <int DH, int NW>
__global__ void __launch_bounds__(NW * 32, 16 / NW)
flash_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, const unsigned char* __restrict__ mask,
                  __nv_bfloat16* __restrict__ out, int S, int H, float scale) {
  constexpr int kDepth = (DH + 15) / 16 * 16;  // Q.K^T depth, zero padded
  constexpr int kStride = kDepth + 8;          // row stride: +16 bytes, so ldmatrix
                                               // rows fall in distinct banks
  constexpr int kChunks = DH / 8;              // 16-byte chunks per head row
  constexpr int kSteps = kDepth / 16;          // k16 steps of Q.K^T
  constexpr int kOut = DH / 8;                 // n8 tiles of the output
  constexpr int kRows = 16 * NW;               // query rows per block
  constexpr int kThreads = 32 * NW;

  __shared__ __align__(16) __nv_bfloat16 q_s[kRows * kStride];
  __shared__ __align__(16) __nv_bfloat16 k_s[2][kKeys * kStride];
  __shared__ __align__(16) __nv_bfloat16 v_s[2][kKeys * kStride];
  __shared__ unsigned char m_s[2][kKeys];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * kRows;
  const float scale_log2 = scale * 1.4426950408889634f;
  const size_t pos_stride = (size_t)H * DH;          // elements between positions
  const size_t base = ((size_t)b * S * H + h) * DH;  // element (b, 0, h, 0)

  if constexpr (kDepth > DH) {  // the zero depth padding of Q and K, once
    static_assert(kDepth - DH == 8, "one 16-byte chunk of padding");
    const uint4 zero = make_uint4(0, 0, 0, 0);
    for (int r = tid; r < kRows; r += kThreads)
      *reinterpret_cast<uint4*>(&q_s[r * kStride + DH]) = zero;
    for (int r = tid; r < 2 * kKeys; r += kThreads)
      *reinterpret_cast<uint4*>(&k_s[r / kKeys][(r % kKeys) * kStride + DH]) = zero;
  }
  for (int c = tid; c < kRows * kChunks; c += kThreads) {
    const int r = c / kChunks, part = c % kChunks, s = q0 + r;
    cp_async16(&q_s[r * kStride + part * 8],
               q + base + (size_t)(s < S ? s : 0) * pos_stride + part * 8, s < S);
  }
  auto load_kv = [&](int tile, int st) {
    const int kv0 = tile * kKeys;
    for (int c = tid; c < kKeys * kChunks; c += kThreads) {
      const int j = c / kChunks, part = c % kChunks, s = kv0 + j;
      const size_t off = base + (size_t)(s < S ? s : 0) * pos_stride + part * 8;
      cp_async16(&k_s[st][j * kStride + part * 8], k + off, s < S);
      cp_async16(&v_s[st][j * kStride + part * 8], v + off, s < S);
    }
    for (int j = tid; j < kKeys; j += kThreads)
      m_s[st][j] = kv0 + j < S && mask[(size_t)b * S + kv0 + j];
  };
  load_kv(0, 0);
  cp_async_commit();

  const int wr = warp * 16;  // this warp's first row in the block's tile
  const bool warp_live = q0 + wr < S;
  uint32_t qa[kSteps][4];  // Q's A fragments, read once
  float acc[kOut][4];      // rows lane/4 and lane/4 + 8 of P.V
#pragma unroll
  for (int j = 0; j < kOut; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};  // l: this lane's part

  const int n_tiles = (S + kKeys - 1) / kKeys;
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    if (t + 1 < n_tiles) {
      load_kv(t + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (warp_live) {
      if (t == 0) {
#pragma unroll
        for (int ks = 0; ks < kSteps; ++ks)
          ldsm_x4(qa[ks], &q_s[(wr + (lane & 7) + 8 * ((lane >> 3) & 1)) * kStride + 16 * ks +
                               8 * (lane >> 4)]);
      }
      // scores: 8 n8 tiles over the 64 keys of this tile
      float sc[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) {
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t kb[4];
          ldsm_x4(kb, &k_s[st][(16 * np + (lane & 7) + 8 * (lane >> 4)) * kStride + 16 * ks +
                              8 * ((lane >> 3) & 1)]);
          mma_bf16(sc[2 * np], qa[ks], kb[0], kb[1]);
          mma_bf16(sc[2 * np + 1], qa[ks], kb[2], kb[3]);
        }
      }
      // mask: masked keys score -1e30, keys past S -inf. The running max
      // starts at -1e30 and never falls below it, so a key past S gets
      // p = exp(-inf) = 0 even in a fully masked row, whose real keys get
      // exp(-1e30 - -1e30) = 1. Scores stay unscaled here: scale > 0
      // commutes with the max and joins the exponent below.
      const int lim = S - t * kKeys - 2 * (lane & 3);  // real iff 8n + (e & 1) < lim
      const uint32_t att[2] = {__ballot_sync(0xffffffffu, m_s[st][lane]) >> (2 * (lane & 3)),
                               __ballot_sync(0xffffffffu, m_s[st][32 + lane]) >> (2 * (lane & 3))};
      float tmax[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int bit = 8 * (n & 3) + (e & 1);
          const float s = (att[n >> 2] >> bit) & 1u ? sc[n][e]
                          : 8 * n + (e & 1) < lim ? kNegInf : __int_as_float(0xff800000);
          sc[n][e] = s;
          tmax[e >> 1] = fmaxf(tmax[e >> 1], s);
        }
      }
      // p = exp((s - max) * scale) = 2^((s - max) * c), c = scale * log2(e).
      // (Not fma(s, c, -max * c): at s = max = -1e30 that leaves the
      // rounding error of max * c, ~1e22, in the exponent.)
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
        tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
        const float m_new = fmaxf(m_run[r], tmax[r]);
        alpha[r] = exp2_approx((m_run[r] - m_new) * scale_log2);
        m_run[r] = m_new;
        l_run[r] *= alpha[r];
      }
#pragma unroll
      for (int j = 0; j < kOut; ++j) {
        acc[j][0] *= alpha[0];
        acc[j][1] *= alpha[0];
        acc[j][2] *= alpha[1];
        acc[j][3] *= alpha[1];
      }
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2_approx((sc[n][e] - m_run[e >> 1]) * scale_log2);
          sc[n][e] = p;
          l_run[e >> 1] += p;
        }
      }
      // P.V: score tiles 2kk and 2kk + 1 are the A fragment of k16 step kk
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t ph[4], pl[4];
        split_bf16(sc[2 * kk][0], sc[2 * kk][1], ph[0], pl[0]);
        split_bf16(sc[2 * kk][2], sc[2 * kk][3], ph[1], pl[1]);
        split_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1], ph[2], pl[2]);
        split_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3], ph[3], pl[3]);
        const int key = 16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
        for (int jp = 0; jp < kOut / 2; ++jp) {
          uint32_t vb[4];
          ldsm_x4_t(vb, &v_s[st][key * kStride + 16 * jp + 8 * (lane >> 4)]);
          mma_bf16(acc[2 * jp], ph, vb[0], vb[1]);
          mma_bf16(acc[2 * jp], pl, vb[0], vb[1]);
          mma_bf16(acc[2 * jp + 1], ph, vb[2], vb[3]);
          mma_bf16(acc[2 * jp + 1], pl, vb[2], vb[3]);
        }
        if constexpr (kOut % 2 == 1) {
          uint32_t vb[2];
          ldsm_x2_t(vb, &v_s[st][key * kStride + 8 * (kOut - 1)]);
          mma_bf16(acc[kOut - 1], ph, vb[0], vb[1]);
          mma_bf16(acc[kOut - 1], pl, vb[0], vb[1]);
        }
      }
    }
    __syncthreads();  // the next step's prefetch overwrites this stage
  }

  if (!warp_live) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    l_run[r] = fmaxf(l_run[r], 1e-30f);
  }
  const int r0 = q0 + wr + (lane >> 2);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= S) continue;
    __nv_bfloat16* o = out + base + (size_t)row * pos_stride + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < kOut; ++j)
      *reinterpret_cast<__nv_bfloat162*>(o + 8 * j) = __floats2bfloat162_rn(
          acc[j][2 * r] / l_run[r], acc[j][2 * r + 1] / l_run[r]);
  }
}

// -- host side ---------------------------------------------------------------

// Kernels whose shared memory exceeds the 48 KB default get their limit
// raised once per process and device.
std::mutex g_mu;
std::set<std::pair<const void*, int>> g_ready;

cudaError_t allow_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(g_mu);
  if (g_ready.count({fn, dev})) return cudaSuccess;
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) g_ready.insert({fn, dev});
  return e;
}

template <int DH, int QR>
int launch_f32_qr(const void* q, const void* k, const void* v, const unsigned char* mask,
                  void* out, int B, int S, int H, float scale, cudaStream_t st) {
  constexpr size_t sm = f32_smem_bytes(DH, QR);
  const cudaError_t e = allow_smem((const void*)flash_f32_kernel<DH, QR>, sm);
  if (e != cudaSuccess) return e;
  const dim3 grid((S + QR - 1) / QR, B * H);
  flash_f32_kernel<DH, QR><<<grid, f32_threads(QR), sm, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), mask, static_cast<float*>(out), S, H, scale);
  return cudaGetLastError();
}

// Query rows per block: 64 where that still gives kMinBlocks blocks, so
// long sequences share each staged kv tile among 64 rows; else 32, else
// 16, so short ones spread over the SMs.
template <int DH>
int launch_f32(const void* q, const void* k, const void* v, const unsigned char* mask,
               void* out, int B, int S, int H, float scale, cudaStream_t st) {
  const long bh = (long)B * H;
  if (bh * ((S + 63) / 64) >= kMinBlocks)
    return launch_f32_qr<DH, 64>(q, k, v, mask, out, B, S, H, scale, st);
  if (bh * ((S + 31) / 32) >= kMinBlocks)
    return launch_f32_qr<DH, 32>(q, k, v, mask, out, B, S, H, scale, st);
  return launch_f32_qr<DH, 16>(q, k, v, mask, out, B, S, H, scale, st);
}

template <int DH, int NW>
void launch_bf16_nw(const void* q, const void* k, const void* v, const unsigned char* mask,
                    void* out, int B, int S, int H, float scale, cudaStream_t st) {
  const dim3 grid((S + 16 * NW - 1) / (16 * NW), B * H);
  flash_bf16_kernel<DH, NW><<<grid, 32 * NW, 0, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), mask, static_cast<__nv_bfloat16*>(out), S, H,
      scale);
}

// Warps per block: 4 where that still gives kMinBlocks blocks, so long
// sequences share each staged kv tile among 64 query rows; else 2, so
// short ones spread over the SMs.
template <int DH>
int launch_bf16(const void* q, const void* k, const void* v, const unsigned char* mask,
                void* out, int B, int S, int H, float scale, cudaStream_t st) {
  if ((long)B * H * ((S + 63) / 64) >= kMinBlocks)
    launch_bf16_nw<DH, 4>(q, k, v, mask, out, B, S, H, scale, st);
  else
    launch_bf16_nw<DH, 2>(q, k, v, mask, out, B, S, H, scale, st);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, out [B, S, H, Dh] contiguous, float32 (is_bf16 = 0) or
// bfloat16 (is_bf16 = 1), each base 16-byte aligned; mask [B, S] bool
// (1 byte each). Dh in {16, 32, 40, 64}: the tiny encoder, MiniLM /
// bge-small heads, the mini encoder and bge-m3-like heads. Launches on `stream`, does not synchronise, returns
// cudaGetLastError().
int nornic_flash_attention(const void* q, const void* k, const void* v, const void* mask,
                           void* out, int B, int S, int H, int Dh, float scale,
                           int is_bf16, void* stream) {
  if (B < 1 || S < 1 || H < 1 || B * H > 65535) return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* m = static_cast<const unsigned char*>(mask);
  const auto addr = [](const void* p) { return reinterpret_cast<uintptr_t>(p); };
  if ((addr(q) | addr(k) | addr(v) | addr(out)) % 16 != 0) return cudaErrorMisalignedAddress;
  if (is_bf16) {
    switch (Dh) {
      case 16: return launch_bf16<16>(q, k, v, m, out, B, S, H, scale, st);
      case 32: return launch_bf16<32>(q, k, v, m, out, B, S, H, scale, st);
      case 40: return launch_bf16<40>(q, k, v, m, out, B, S, H, scale, st);
      case 64: return launch_bf16<64>(q, k, v, m, out, B, S, H, scale, st);
      default: return cudaErrorInvalidValue;
    }
  }
  switch (Dh) {
    case 16: return launch_f32<16>(q, k, v, m, out, B, S, H, scale, st);
    case 32: return launch_f32<32>(q, k, v, m, out, B, S, H, scale, st);
    case 40: return launch_f32<40>(q, k, v, m, out, B, S, H, scale, st);
    case 64: return launch_f32<64>(q, k, v, m, out, B, S, H, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

const char* nornic_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
