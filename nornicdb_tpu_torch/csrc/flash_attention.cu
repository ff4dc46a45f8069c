// Exact (flash) softmax attention, forward only, for Hopper (sm_90a).
//
// Replaces: nornicdb_tpu/ops/pallas_attention.py, `flash_attention`
// (pl.pallas_call over `_flash_kernel`).
//
// What it computes: for q, k, v [B, S, H, Dh] (float32, or bfloat16 read
// into float32) and a key mask [B, S], out = softmax(q k^T * Dh^-0.5) v per
// (batch, head), masked keys at -1e30, with float32 running max, running
// denominator and accumulator. Keys past S are not part of the softmax.
// Output [B, S, H, Dh] in the input's type. No backward: the JAX kernel has
// no vjp and the encoder uses it for inference only.
//
// What bounds it on the H100: 4*B*H*S^2*Dh FLOPs against 4 arrays of
// B*S*H*Dh float32 elements moved once. The two roofs (67 TFLOP/s float32
// FMA, since exactness in float32 keeps it off the tensor cores, and
// 3.35 TB/s HBM) cross at S = 80: the short width buckets the embed path
// mostly sees (S = 16..64) are bound by bytes, S = 128..512 by operations.
//
// What this simple design does about it: one block of 64 threads per
// (64-query tile, batch*head); one thread owns one query row and keeps its
// q row and accumulator in registers (Dh is a template parameter). The
// TPU's sequential kv grid axis becomes a loop over 64-key tiles staged in
// shared memory as float32; each thread scores its row against the tile,
// takes the tile max, rescales (alpha = exp(m_prev - m_new)) and adds
// p*v. The [S, S] logits never reach device memory. Tensor-core (wgmma)
// tiles and bf16 MMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;  // query rows per block (one per thread)
constexpr int kBK = 64;  // keys per staged tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

size_t smem_bytes(int dh) {
  return (size_t)(2 * kBK * dh + kBQ * (kBK + 1) + kBK) * sizeof(float);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kBQ)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const unsigned char* __restrict__ mask, T* __restrict__ out,
             int S, int H, float scale) {
  extern __shared__ __align__(16) float sm[];
  float* k_s = sm;                      // [kBK][DH]
  float* v_s = k_s + kBK * DH;          // [kBK][DH]
  float* p_s = v_s + kBK * DH;          // [kBQ][kBK + 1] this row's logits
  float* mk_s = p_s + kBQ * (kBK + 1);  // [kBK] 1 = attend

  const int tid = threadIdx.x;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int row = blockIdx.x * kBQ + tid;
  const bool live = row < S;
  const size_t q_off = (((size_t)b * S + (live ? row : 0)) * H + h) * DH;

  float qr[DH], acc[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    qr[d] = live ? to_f(q[q_off + d]) : 0.f;
    acc[d] = 0.f;
  }
  float m_run = kNegInf, l_run = 0.f;
  float* my_p = p_s + tid * (kBK + 1);

  for (int kv0 = 0; kv0 < S; kv0 += kBK) {
    const int nk = min(kBK, S - kv0);
    for (int e = tid; e < nk * DH; e += kBQ) {
      const int j = e / DH, d = e % DH;
      const size_t off = (((size_t)b * S + kv0 + j) * H + h) * DH + d;
      k_s[j * DH + d] = to_f(k[off]);
      v_s[j * DH + d] = to_f(v[off]);
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
    for (int d = 0; d < DH; ++d) out[q_off + d] = from_f<T>(acc[d] / denom);
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, const unsigned char* mask,
           void* out, int B, int S, int H, float scale, cudaStream_t st) {
  const size_t sm = smem_bytes(DH);
  cudaError_t e = cudaFuncSetAttribute(flash_kernel<T, DH>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sm);
  if (e != cudaSuccess) return e;
  const dim3 grid((S + kBQ - 1) / kBQ, B * H);
  flash_kernel<T, DH><<<grid, kBQ, sm, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), mask,
      static_cast<T*>(out), S, H, scale);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const unsigned char* mask,
             void* out, int B, int S, int H, int Dh, float scale, cudaStream_t st) {
  switch (Dh) {
    case 16: return launch<T, 16>(q, k, v, mask, out, B, S, H, scale, st);
    case 40: return launch<T, 40>(q, k, v, mask, out, B, S, H, scale, st);
    case 64: return launch<T, 64>(q, k, v, mask, out, B, S, H, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, k, v, out [B, S, H, Dh] contiguous, float32 (is_bf16 = 0) or
// bfloat16 (is_bf16 = 1); mask [B, S] bool (1 byte each). Dh in
// {16, 40, 64}: the tiny, mini and bge-m3-like encoders. Launches on `stream`, does not synchronise,
// returns cudaGetLastError().
int nornic_flash_attention(const void* q, const void* k, const void* v, const void* mask,
                           void* out, int B, int S, int H, int Dh, float scale,
                           int is_bf16, void* stream) {
  if (B < 1 || S < 1 || H < 1 || B * H > 65535) return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* m = static_cast<const unsigned char*>(mask);
  if (is_bf16) return dispatch<__nv_bfloat16>(q, k, v, m, out, B, S, H, Dh, scale, st);
  return dispatch<float>(q, k, v, m, out, B, S, H, Dh, scale, st);
}

const char* nornic_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
