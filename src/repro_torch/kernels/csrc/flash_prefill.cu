// Flash prefill attention for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `flash_attention` of
// src/repro/kernels/flash_prefill.py (body `_kernel`): blocked
// online-softmax GQA attention, q (B,Sq,H,hd) over k/v (B,Sk,K,hd) with the
// kv head of query head h at h / G, float32 accumulation, NEG_INF = -1e30,
// denominator floor 1e-30, optional softcap * tanh(s / softcap). Masks:
//   * implicit (no positions): iota causal / window with Sq == Sk, keys past
//     Sk masked, and fully masked k tiles skipped (as flash_prefill.py:60-65);
//   * segment ids: block-diagonal, q segments against k segments;
//   * explicit positions: q_pos / k_pos drive the causal and window terms,
//     Sq != Sk allowed, keys at POS_INVALID masked; no tile skip.
//
// What bounds it on the H100: a call needs 2*hd multiply-adds per query
// head for every unmasked (query, key) pair against one read of q/k/v and
// one write of the output. On the packed-prefill shape (T = 2048, 32 q
// heads, hd 128) with 8 segments of ~256 tokens the pairs are few and the
// bound is the bytes (~0.013 ms); with one 2048-token segment it is the
// arithmetic (~0.035 ms). This first version does that arithmetic with
// float32 FMAs on the CUDA cores (no tensor cores): one CTA of 256 threads
// per (64-row q tile, q head, batch row) stages the q tile and each 64-key
// k/v tile in shared memory as float32, each thread holds a 4 x 4 block of
// scores and a 4 x (hd/16) block of the output accumulator in registers,
// and rows are reduced with warp shuffles.
// Shared-memory rows of q and k are padded by one float so that the 16
// threads of a row group hit 16 different banks. The known gap to the
// bound is the tensor cores (wgmma) and TMA staging, left to a later change.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NTHREADS = 256;
constexpr float NEG_INF = -1e30f;
constexpr int POS_INVALID = 1 << 30;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * (HD + 1) + BK * (HD + 1) + BK * HD + BQ * (BK + 1))
       + sizeof(int) * (2 * BQ + 2 * BK);
}

template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     const int* __restrict__ seg_q, const int* __restrict__ seg_k,
                     const int* __restrict__ pos_q, const int* __restrict__ pos_k,
                     int Sq, int Sk, int H, int K, float scale, int causal,
                     int window, float softcap) {
  constexpr int CJ = HD / 16;           // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                     // [BQ][HD+1]
  float* Ks = Qs + BQ * (HD + 1);       // [BK][HD+1]
  float* Vs = Ks + BK * (HD + 1);       // [BK][HD]
  float* Ps = Vs + BK * HD;             // [BQ][BK+1]
  int* qpos_s = reinterpret_cast<int*>(Ps + BQ * (BK + 1));
  int* qseg_s = qpos_s + BQ;
  int* kpos_s = qseg_s + BQ;
  int* kseg_s = kpos_s + BK;

  const int tid = threadIdx.x;
  const int tx = tid & 15;              // column group
  const int ty = tid >> 4;              // row group: rows 4*ty .. 4*ty+3
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / K;
  const int kh = h / G;
  const bool has_pos = pos_q != nullptr;
  const bool has_seg = seg_q != nullptr;

  // ---- stage the q tile (rows past Sq are zero and never stored) ----
  for (int idx = tid; idx < BQ * HD; idx += NTHREADS) {
    const int r = idx / HD, d = idx % HD, gi = q0 + r;
    Qs[r * (HD + 1) + d] =
        gi < Sq ? to_f(q[((size_t)(b * Sq + gi) * H + h) * HD + d]) : 0.f;
  }
  for (int r = tid; r < BQ; r += NTHREADS) {
    const int gi = q0 + r;
    qpos_s[r] = has_pos ? (gi < Sq ? pos_q[(size_t)b * Sq + gi] : -1) : gi;
    qseg_s[r] = has_seg ? (gi < Sq ? seg_q[(size_t)b * Sq + gi] : -1) : 0;
  }

  float m[4], l[4], acc[4][CJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc[i][j] = 0.f;
  }

  const int nk = (Sk + BK - 1) / BK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    if (!has_pos) {
      // static skip of fully masked tiles: only valid when the iota is the
      // position (implicit mode)
      if (causal && k0 > q0 + BQ - 1) break;
      if (window > 0 && k0 + BK - 1 <= q0 - window) continue;
    }
    __syncthreads();                    // previous tile fully consumed
    for (int idx = tid; idx < BK * HD; idx += NTHREADS) {
      const int r = idx / HD, d = idx % HD, gj = k0 + r;
      const size_t off = ((size_t)(b * Sk + gj) * K + kh) * HD + d;
      Ks[r * (HD + 1) + d] = gj < Sk ? to_f(k[off]) : 0.f;
      Vs[r * HD + d] = gj < Sk ? to_f(v[off]) : 0.f;
    }
    for (int r = tid; r < BK; r += NTHREADS) {
      const int gj = k0 + r;
      kpos_s[r] = has_pos ? (gj < Sk ? pos_k[(size_t)b * Sk + gj] : POS_INVALID)
                          : gj;
      kseg_s[r] = has_seg ? (gj < Sk ? seg_k[(size_t)b * Sk + gj] : -2) : 0;
    }
    __syncthreads();

    // ---- scores: s[i][j] for rows 4*ty+i, key columns tx+16*j ----
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(4 * ty + i) * (HD + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * (HD + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
      const int ii = qpos_s[r];
      const int si = qseg_s[r];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int jj = kpos_s[c];
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        bool ok = has_pos ? (jj < POS_INVALID) : (k0 + c < Sk);
        if (causal) ok = ok && (jj <= ii);
        if (window > 0) ok = ok && (jj > ii - window);
        if (has_seg) ok = ok && (si == kseg_s[c]);
        x = ok ? x : NEG_INF;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[r * (BK + 1) + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      alpha[i] = expf(m[i] - m_new);
      l[i] = alpha[i] * l[i] + sum;
      m[i] = m_new;
    }
    __syncthreads();                    // P tile complete

    // ---- acc = acc * alpha + P @ V ----
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) acc[i][j] *= alpha[i];
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4], vv[CJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(4 * ty + i) * (BK + 1) + kk];
#pragma unroll
      for (int j = 0; j < CJ; ++j) vv[j] = Vs[kk * HD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gi = q0 + 4 * ty + i;
    if (gi >= Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* out = o + ((size_t)(b * Sq + gi) * H + h) * HD;
#pragma unroll
    for (int j = 0; j < CJ; ++j) out[tx + 16 * j] = from_f<T>(acc[i][j] * inv);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o,
           const void* seg_q, const void* seg_k, const void* pos_q,
           const void* pos_k, int B, int Sq, int Sk, int H, int K,
           int causal, int window, float softcap, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  auto kern = flash_prefill_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kern<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      static_cast<const int*>(seg_q), static_cast<const int*>(seg_k),
      static_cast<const int*>(pos_q), static_cast<const int*>(pos_k),
      Sq, Sk, H, K, 1.f / sqrtf((float)HD), causal, window, softcap);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, void* o,
                const void* seg_q, const void* seg_k, const void* pos_q,
                const void* pos_k, int B, int Sq, int Sk, int H, int K,
                int causal, int window, float softcap, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32>(q, k, v, o, seg_q, seg_k, pos_q, pos_k, B, Sq,
                                  Sk, H, K, causal, window, softcap, stream);
    case 64: return launch<T, 64>(q, k, v, o, seg_q, seg_k, pos_q, pos_k, B, Sq,
                                  Sk, H, K, causal, window, softcap, stream);
    case 128: return launch<T, 128>(q, k, v, o, seg_q, seg_k, pos_q, pos_k, B, Sq,
                                    Sk, H, K, causal, window, softcap, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. seg_q/seg_k and pos_q/pos_k may be null
// (in pairs). window <= 0 and softcap <= 0 mean "none". Returns the CUDA
// error code of the launch (0 on success).
extern "C" int flash_prefill(const void* q, const void* k, const void* v,
                             void* o, const void* seg_q, const void* seg_k,
                             const void* pos_q, const void* pos_k, int B,
                             int Sq, int Sk, int H, int K, int hd, int dtype,
                             int causal, int window, float softcap,
                             void* stream) {
  if (K <= 0 || H % K != 0 || B <= 0 || Sq <= 0 || Sk <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(hd, q, k, v, o, seg_q, seg_k, pos_q, pos_k, B, Sq,
                              Sk, H, K, causal, window, softcap, s);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, seg_q, seg_k, pos_q,
                                      pos_k, B, Sq, Sk, H, K, causal, window,
                                      softcap, s);
  return (int)cudaErrorInvalidValue;
}
