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
// float32 (exact embeddings; off the main path): a SIMT kernel, exact
//   f32 with no TF32. One block of 64 threads per (64-query tile,
//   batch*head); one thread owns one query row and keeps its q row and
//   accumulator in registers; kv tiles of 64 keys are staged in shared
//   memory as float32. Bound by the 67 TFLOP/s f32 FMA rate from S = 80.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>
#include <set>
#include <utility>

namespace {

constexpr int kKeys = 64;  // keys per staged kv tile, both kernels
constexpr float kNegInf = -1e30f;

// -- float32: one thread per query row -----------------------------------

constexpr int kBQ = 64;  // query rows per block (one per thread)

size_t f32_smem_bytes(int dh) {
  return (size_t)(2 * kKeys * dh + kBQ * (kKeys + 1) + kKeys) * sizeof(float);
}

template <int DH>
__global__ void __launch_bounds__(kBQ)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const unsigned char* __restrict__ mask,
                 float* __restrict__ out, int S, int H, float scale) {
  extern __shared__ __align__(16) float sm[];
  float* k_s = sm;                       // [kKeys][DH]
  float* v_s = k_s + kKeys * DH;         // [kKeys][DH]
  float* p_s = v_s + kKeys * DH;         // [kBQ][kKeys + 1] this row's logits
  float* mk_s = p_s + kBQ * (kKeys + 1);  // [kKeys] 1 = attend

  const int tid = threadIdx.x;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int row = blockIdx.x * kBQ + tid;
  const bool live = row < S;
  const size_t q_off = (((size_t)b * S + (live ? row : 0)) * H + h) * DH;

  float qr[DH], acc[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    qr[d] = live ? q[q_off + d] : 0.f;
    acc[d] = 0.f;
  }
  float m_run = kNegInf, l_run = 0.f;
  float* my_p = p_s + tid * (kKeys + 1);

  for (int kv0 = 0; kv0 < S; kv0 += kKeys) {
    const int nk = min(kKeys, S - kv0);
    for (int e = tid; e < nk * DH; e += kBQ) {
      const int j = e / DH, d = e % DH;
      const size_t off = (((size_t)b * S + kv0 + j) * H + h) * DH + d;
      k_s[j * DH + d] = k[off];
      v_s[j * DH + d] = v[off];
    }
    for (int j = tid; j < nk; j += kBQ) mk_s[j] = mask[(size_t)b * S + kv0 + j] ? 1.f : 0.f;
    __syncthreads();

    float tile_max = kNegInf;
    for (int j = 0; j < nk; ++j) {
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) s = fmaf(qr[d], k_s[j * DH + d], s);
      s = mk_s[j] != 0.f ? s * scale : kNegInf;
      my_p[j] = s;
      tile_max = fmaxf(tile_max, s);
    }
    const float m_new = fmaxf(m_run, tile_max);
    const float alpha = expf(m_run - m_new);
#pragma unroll
    for (int d = 0; d < DH; ++d) acc[d] *= alpha;
    float lsum = 0.f;
    for (int j = 0; j < nk; ++j) {
      const float p = expf(my_p[j] - m_new);
      lsum += p;
#pragma unroll
      for (int d = 0; d < DH; ++d) acc[d] = fmaf(p, v_s[j * DH + d], acc[d]);
    }
    l_run = l_run * alpha + lsum;
    m_run = m_new;
    __syncthreads();
  }
  if (live) {
    const float denom = fmaxf(l_run, 1e-30f);
#pragma unroll
    for (int d = 0; d < DH; ++d) out[q_off + d] = acc[d] / denom;
  }
}

// -- bfloat16: warp tiles on the tensor cores ------------------------------

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

// 2^x in one MUFU.EX2 (relative error ~2^-22); 2^-inf = 0.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two f32 values (lower column first) as bf16 pairs hi = bf16(x) and
// lo = bf16(x - hi): hi + lo keeps ~16 of x's 24 significant bits.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

constexpr int kMinBlocks = 128;  // about one block per SM of the H100's 132

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

template <int DH>
int launch_f32(const void* q, const void* k, const void* v, const unsigned char* mask,
               void* out, int B, int S, int H, float scale, cudaStream_t st) {
  const size_t sm = f32_smem_bytes(DH);
  const cudaError_t e = allow_smem((const void*)flash_f32_kernel<DH>, sm);
  if (e != cudaSuccess) return e;
  const dim3 grid((S + kBQ - 1) / kBQ, B * H);
  flash_f32_kernel<DH><<<grid, kBQ, sm, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), mask, static_cast<float*>(out), S, H, scale);
  return cudaGetLastError();
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
// bfloat16 (is_bf16 = 1, each base 16-byte aligned); mask [B, S] bool
// (1 byte each). Dh in {16, 40, 64}: the tiny, mini and bge-m3-like
// encoders. Launches on `stream`, does not synchronise, returns
// cudaGetLastError().
int nornic_flash_attention(const void* q, const void* k, const void* v, const void* mask,
                           void* out, int B, int S, int H, int Dh, float scale,
                           int is_bf16, void* stream) {
  if (B < 1 || S < 1 || H < 1 || B * H > 65535) return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* m = static_cast<const unsigned char*>(mask);
  if (is_bf16) {
    const auto addr = [](const void* p) { return reinterpret_cast<uintptr_t>(p); };
    if ((addr(q) | addr(k) | addr(v) | addr(out)) % 16 != 0) return cudaErrorMisalignedAddress;
    switch (Dh) {
      case 16: return launch_bf16<16>(q, k, v, m, out, B, S, H, scale, st);
      case 40: return launch_bf16<40>(q, k, v, m, out, B, S, H, scale, st);
      case 64: return launch_bf16<64>(q, k, v, m, out, B, S, H, scale, st);
      default: return cudaErrorInvalidValue;
    }
  }
  switch (Dh) {
    case 16: return launch_f32<16>(q, k, v, m, out, B, S, H, scale, st);
    case 40: return launch_f32<40>(q, k, v, m, out, B, S, H, scale, st);
    case 64: return launch_f32<64>(q, k, v, m, out, B, S, H, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

const char* nornic_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
