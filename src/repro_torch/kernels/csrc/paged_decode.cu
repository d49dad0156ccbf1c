// Paged decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `paged_decode_attention` of
// src/repro/kernels/paged_attention.py (body `_kernel`): one query token per
// row attends over its pages of a pooled KV cache. q (B,H,hd); pages
// (P,page,K,hd); block_tables (B,MP); context_lens (B,). The G = H/K query
// heads of one kv head share its pages (q head kh*G+g). Pages are read only
// below context_lens[b] (and below MP pages); float32 online softmax across
// key chunks, optional softcap, and a row with context 0 gives zeros.
//
// What bounds it on the H100: every cached key and value of a row is read
// once and used for only G query heads (G = 4 on qwen3-8b), about
// 2*G multiply-adds per byte read, so it is bound by memory bandwidth. This
// first version keeps every load coalesced: one CTA of 128 threads per
// (batch row, kv head) walks the block table chunk by chunk (at most 128
// keys, never past the context); for the scores each warp takes one key at a
// time with its lanes splitting hd and reduces the G dot products with warp
// shuffles; for P @ V each thread owns one of the hd output columns and
// streams V rows. The known gaps to the bound are the grid (B*K CTAs, 64 on
// the serving path, fewer than the 132 SMs: split-KV would fill the card)
// and the lack of asynchronous copies ahead of use, left to a later change.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 128;
constexpr int NWARPS = NTHREADS / 32;
constexpr int CHUNK = 128;            // keys per online-softmax step
constexpr int MAXG = 16;              // query heads per kv head
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp, const int* __restrict__ bt,
                    const int* __restrict__ cl, T* __restrict__ o, int H,
                    int K, int page, int MP, float scale, float softcap) {
  constexpr int DJ = HD / 32;           // hd elements per lane in the scores
  __shared__ float q_s[MAXG][HD];
  __shared__ float p_s[MAXG][CHUNK];
  __shared__ int pid_s[CHUNK];
  __shared__ float alpha_s[MAXG];
  __shared__ float l_s[MAXG];
  __shared__ float m_s[MAXG];

  const int b = blockIdx.x;
  const int kh = blockIdx.y;
  const int G = H / K;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int idx = tid; idx < G * HD; idx += NTHREADS) {
    const int g = idx / HD, d = idx % HD;
    q_s[g][d] = to_f(q[((size_t)b * H + kh * G + g) * HD + d]);
  }
  if (tid < MAXG) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  float acc[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) acc[g] = 0.f;

  const int ctx = min(cl[b], MP * page);
  const size_t row_stride = (size_t)K * HD;   // between tokens of a page
  for (int c0 = 0; c0 < ctx; c0 += CHUNK) {
    const int n = min(CHUNK, ctx - c0);
    __syncthreads();                  // previous chunk fully consumed
    for (int i = tid; i < n; i += NTHREADS) {
      const int t = c0 + i;
      pid_s[i] = bt[(size_t)b * MP + t / page];
    }
    __syncthreads();

    // ---- scores: warp per key, lanes split hd ----
    for (int i = warp; i < n; i += NWARPS) {
      const int t = c0 + i;
      const T* krow = kp + ((size_t)pid_s[i] * page + t % page) * row_stride
                      + (size_t)kh * HD;
      float kv[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kv[j] = to_f(krow[lane + 32 * j]);
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g >= G) break;
        float part = 0.f;
#pragma unroll
        for (int j = 0; j < DJ; ++j) part = fmaf(q_s[g][lane + 32 * j], kv[j], part);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        if (lane == 0) {
          float x = part * scale;
          if (softcap > 0.f) x = softcap * tanhf(x / softcap);
          p_s[g][i] = x;
        }
      }
    }
    __syncthreads();

    // ---- online softmax per query head: warp per head ----
    for (int g = warp; g < G; g += NWARPS) {
      float mx = NEG_INF;
      for (int i = lane; i < n; i += 32) mx = fmaxf(mx, p_s[g][i]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int i = lane; i < n; i += 32) {
        const float p = expf(p_s[g][i] - m_new);
        p_s[g][i] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        alpha_s[g] = alpha;
        l_s[g] = alpha * l_s[g] + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // ---- acc = acc * alpha + P @ V: thread per output column ----
    if (tid < HD) {
#pragma unroll
      for (int g = 0; g < MAXG; ++g)
        if (g < G) acc[g] *= alpha_s[g];
      for (int i = 0; i < n; ++i) {
        const int t = c0 + i;
        const float vv = to_f(vp[((size_t)pid_s[i] * page + t % page) * row_stride
                                 + (size_t)kh * HD + tid]);
#pragma unroll
        for (int g = 0; g < MAXG; ++g)
          if (g < G) acc[g] = fmaf(p_s[g][i], vv, acc[g]);
      }
    }
  }
  __syncthreads();
  if (tid < HD) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= G) break;
      const float inv = 1.f / fmaxf(l_s[g], 1e-30f);
      o[((size_t)b * H + kh * G + g) * HD + tid] = from_f<T>(acc[g] * inv);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* kp, const void* vp, const void* bt,
           const void* cl, void* o, int B, int H, int K, int page, int MP,
           float softcap, cudaStream_t stream) {
  dim3 grid(B, K);
  paged_decode_kernel<T, HD><<<grid, NTHREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<const int*>(bt),
      static_cast<const int*>(cl), static_cast<T*>(o), H, K, page, MP,
      1.f / sqrtf((float)HD), softcap);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* kp, const void* vp,
                const void* bt, const void* cl, void* o, int B, int H, int K,
                int page, int MP, float softcap, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32>(q, kp, vp, bt, cl, o, B, H, K, page, MP, softcap, stream);
    case 64: return launch<T, 64>(q, kp, vp, bt, cl, o, B, H, K, page, MP, softcap, stream);
    case 128: return launch<T, 128>(q, kp, vp, bt, cl, o, B, H, K, page, MP, softcap, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. softcap <= 0 means "none". Returns the CUDA
// error code of the launch (0 on success).
extern "C" int paged_decode(const void* q, const void* kp, const void* vp,
                            const void* bt, const void* cl, void* o, int B,
                            int H, int K, int hd, int page, int MP, int dtype,
                            float softcap, void* stream) {
  if (K <= 0 || H % K != 0 || H / K > MAXG || B <= 0 || page <= 0 || MP <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(hd, q, kp, vp, bt, cl, o, B, H, K, page, MP, softcap, s);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(hd, q, kp, vp, bt, cl, o, B, H, K, page,
                                      MP, softcap, s);
  return (int)cudaErrorInvalidValue;
}
