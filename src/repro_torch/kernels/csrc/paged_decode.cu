// Paged decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `paged_decode_attention` of
// src/repro/kernels/paged_attention.py (body `_kernel`): one query token per
// row attends over its pages of a pooled KV cache. q (B,H,hd); pages
// (P,page,K,hd); block_tables (B,MP) or null; context_lens (B,). The G = H/K
// query heads of one kv head share its pages (q head kh*G+g). Keys are read
// only below context_lens[b] (and below MP*page); float32 online softmax,
// optional softcap, NEG_INF = -1e30 with a 1e-30 denominator floor, and a
// row with context 0 gives zeros. A null block table addresses row b's key t
// at page b*MP + t/page: contiguous per-row caches need no table.
//
// What bounds it on the H100: every cached key and value of a row is read
// once and used by only G query heads (G = 4 on qwen3-8b), about 2*G
// multiply-adds per byte, far below the ~295 operations a byte at which
// arithmetic would set the pace. So the bound is the bytes: 2 * ctx * K * hd
// elements a row, over 3.35 TB/s. The design serves that bound:
//   * split-KV (flash-decoding): the grid is (n_split, K, B); each CTA owns
//     one key range of `split` keys of one (row, kv head). The split length
//     comes from shapes only (capacity MP*page, B*K and the SM count; the
//     wrapper's `plan_splits`), never from context_lens, so no host sync is
//     needed and the launch can be captured in a CUDA graph. At B*K = 64 and
//     capacity 2048 it is 256 keys, 8 splits, 512 CTAs for 132 SMs, so a
//     long row no longer runs on one SM while the others idle. A CTA whose
//     range starts at or past its row's context writes a neutral partial
//     (m = NEG_INF, l = 0) and exits.
//   * each CTA streams its range in 64-key tiles (32 for float32), K and V
//     staged in shared memory by 16-byte cp.async copies, double-buffered:
//     tile i+1 is in flight while tile i is scored and multiplied.
//   * bfloat16 runs on the tensor cores (mma.sync.m16n8k16, bf16 in,
//     float32 accumulate): the G query heads are rows of the 16-row A
//     operand, each warp takes 16 keys of a tile, and S = q K^T and
//     O += P V are 24 MMAs a warp a tile. The first version of this split
//     kernel did the same work as float32 FMAs on the CUDA cores, one
//     (key, head) dot product a thread, and read 0.0735 ms at the serving
//     shape, 14% of the bound: with G = 4 the FMAs and shared loads, not
//     the bytes, set its pace. On the tensor cores the pair of kernels
//     takes 0.0246 ms (PERF.md). P enters P V as bf16 hi + lo, which keeps
//     the float32 weights' precision (bf16 P alone missed the bf16
//     tolerance, scripts/kernel_variants.py); each warp keeps its own
//     online softmax (exp2, the scale folded in) and the 4 warps merge by
//     log-sum-exp at the end.
//   * float32 stays on the CUDA cores, exact (no TF32): scores are one
//     (key, head group) a thread, the softmax one warp a head, P V one column
//     pair a thread over a slice of the tile's keys. K rows are padded by
//     16 bytes, so the thread-per-key 16-byte reads hit no bank twice.
//   * a second kernel merges the float32 partials (m, l, acc) of the splits
//     by log-sum-exp in a fixed order, on the same stream, and writes the
//     output in q's dtype. No atomics: results are the same run to run.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 128;
constexpr int NWARPS = NTHREADS / 32;
constexpr int MAXG = 16;              // query heads per kv head
constexpr int SPLIT_ALIGN = 64;       // split lengths are multiples of this
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16 bytes global -> shared, asynchronously; zero-filled when !pred
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
// c += a * b, 16x8x16, bf16 inputs, float32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// a pair of float32 weights as bf16 hi + lo pairs (hi + lo carries ~16 bits)
__device__ __forceinline__ void split_pair(float x, float y, unsigned& hi, unsigned& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  __nv_bfloat162 r = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<unsigned*>(&h);
  lo = *reinterpret_cast<unsigned*>(&r);
}
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// one 16-byte chunk of shared memory as floats
__device__ __forceinline__ void load_chunk(const float* p, float (&f)[4]) {
  const float4 r = *reinterpret_cast<const float4*>(p);
  f[0] = r.x; f[1] = r.y; f[2] = r.z; f[3] = r.w;
}
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

template <typename T, int HD>
struct Cfg {
  static constexpr int TK = 128 / sizeof(T);        // keys a tile
  static constexpr int EPC = 16 / sizeof(T);        // elements a 16-byte chunk
  static constexpr int KROW = HD + EPC;             // padded K row (elements)
  static constexpr int CPR = HD / EPC;              // chunks a row
  static constexpr int NG = NTHREADS / TK;          // head groups in the scores
  static constexpr int GPT = MAXG / NG;             // heads a thread, at most
  static constexpr int NCP = HD / 2;                // column pairs in P.V
  // P.V threads a key group: NCP rounded up to a power of two that divides
  // NTHREADS (hd 96 and 112 give 64, hd 160 gives 128); threads at or past
  // NCP hold no column and sit the P.V loop out
  static constexpr int CPW = NCP <= 16 ? 16 : NCP <= 32 ? 32 : NCP <= 64 ? 64 : 128;
  static constexpr int NKG = NTHREADS / CPW;        // key groups in P.V
  static constexpr size_t KV_BYTES = sizeof(T) * 2 * TK * (KROW + HD);
  static_assert(NTHREADS % TK == 0 && NCP <= CPW && CPW <= NTHREADS
                && HD % EPC == 0, "tile shape");
  // the P.V group reduction aliases the K/V buffers after the loop
  static_assert(sizeof(float) * NKG * MAXG * HD <= KV_BYTES, "alias");
};

// float32 (CUDA cores). shared memory: K[2][TK][KROW] | V[2][TK][HD] |
// q[G][HD] f32 | s[G][TK] f32
//                | m, l, alpha [MAXG] f32 | pages [npg] int
template <typename T, int HD>
size_t smem_bytes(int G, int npg) {
  using C = Cfg<T, HD>;
  return C::KV_BYTES + sizeof(float) * (G * HD + G * C::TK + 3 * MAXG)
       + sizeof(int) * npg;
}

template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS)
paged_decode_split_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                          const T* __restrict__ vp, const int* __restrict__ bt,
                          const int* __restrict__ cl, float* __restrict__ part_m,
                          float* __restrict__ part_l, float* __restrict__ part_acc,
                          int H, int K, int page, int MP, int split, float scale,
                          float softcap) {
  using C = Cfg<T, HD>;
  constexpr int TK = C::TK, EPC = C::EPC, KROW = C::KROW, CPR = C::CPR;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);                 // [2][TK][KROW]
  T* Vs = Ks + 2 * TK * KROW;                             // [2][TK][HD]
  const int G = H / K;
  float* q_s = reinterpret_cast<float*>(Vs + 2 * TK * HD);  // [G][HD]
  float* s_s = q_s + G * HD;                              // [G][TK]
  float* m_s = s_s + G * TK;
  float* l_s = m_s + MAXG;
  float* alpha_s = l_s + MAXG;
  int* pages_s = reinterpret_cast<int*>(alpha_s + MAXG);

  const int sp = blockIdx.x;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int n_split = gridDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t pbase = (((size_t)b * K + kh) * n_split + sp) * G;

  const int ctx = max(0, min(cl[b], MP * page));
  const int t0 = sp * split;
  if (t0 >= ctx) {                      // neutral partial
    if (tid < G) {
      part_m[pbase + tid] = NEG_INF;
      part_l[pbase + tid] = 0.f;
    }
    return;
  }
  const int t1 = min(t0 + split, ctx);
  const int pg0 = t0 / page;
  if (bt != nullptr) {
    const int npg = (t1 - 1) / page - pg0 + 1;
    for (int i = tid; i < npg; i += NTHREADS)
      pages_s[i] = bt[(size_t)b * MP + pg0 + i];
  }
  for (int idx = tid; idx < G * HD; idx += NTHREADS) {
    const int g = idx / HD, d = idx % HD;
    q_s[idx] = to_f(q[((size_t)b * H + kh * G + g) * HD + d]);
  }
  if (tid < MAXG) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  __syncthreads();                      // pages_s ready for the copies

  const size_t row_stride = (size_t)K * HD;  // between tokens of a page
  auto load_tile = [&](int base, int buf) {
    for (int c = tid; c < TK * CPR; c += NTHREADS) {
      const int r = c / CPR, cc = c % CPR, t = base + r;
      const bool ok = t < t1;
      size_t off = 0;
      if (ok) {
        const int pid = bt != nullptr ? pages_s[t / page - pg0] : b * MP + t / page;
        off = ((size_t)pid * page + t % page) * row_stride + (size_t)kh * HD + cc * EPC;
      }
      cp_async16(Ks + (buf * TK + r) * KROW + cc * EPC, kp + off, ok);
      cp_async16(Vs + (buf * TK + r) * HD + cc * EPC, vp + off, ok);
    }
    cp_async_commit();
  };

  // P.V layout: column pair cp, key group kg
  const int cp = tid % C::CPW;
  const int kg = tid / C::CPW;
  float acc[MAXG][2];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) acc[g][0] = acc[g][1] = 0.f;

  const int ntiles = (t1 - t0 + TK - 1) / TK;
  load_tile(t0, 0);
  for (int it = 0; it < ntiles; ++it) {
    const int buf = it & 1;
    const int base = t0 + it * TK;
    if (it + 1 < ntiles) {
      load_tile(base + TK, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                    // tile `it` landed for every thread

    // ---- scores: thread per (key j, head group gg) ----
    {
      const int j = tid % TK;
      const int gg = tid / TK;
      float dot[C::GPT];
#pragma unroll
      for (int u = 0; u < C::GPT; ++u) dot[u] = 0.f;
      const T* krow = Ks + (buf * TK + j) * KROW;
#pragma unroll 4
      for (int c = 0; c < CPR; ++c) {
        float kf[EPC];
        load_chunk(krow + c * EPC, kf);
#pragma unroll
        for (int u = 0; u < C::GPT; ++u) {
          const int g = gg + u * C::NG;
          if (g < G) {
            const float* qq = q_s + g * HD + c * EPC;
#pragma unroll
            for (int e = 0; e < EPC; ++e) dot[u] = fmaf(qq[e], kf[e], dot[u]);
          }
        }
      }
      const bool valid = base + j < t1;
#pragma unroll
      for (int u = 0; u < C::GPT; ++u) {
        const int g = gg + u * C::NG;
        if (g < G) {
          float x = dot[u] * scale;
          if (softcap > 0.f) x = softcap * tanhf(x / softcap);
          s_s[g * TK + j] = valid ? x : -INFINITY;
        }
      }
    }
    __syncthreads();

    // ---- online softmax: warp per head ----
    for (int g = warp; g < G; g += NWARPS) {
      float mx = -INFINITY;
      for (int j = lane; j < TK; j += 32) mx = fmaxf(mx, s_s[g * TK + j]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);      // finite: m_prev >= NEG_INF
      float sum = 0.f;
      for (int j = lane; j < TK; j += 32) {
        const float p = expf(s_s[g * TK + j] - m_new);
        s_s[g * TK + j] = p;
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

    // ---- acc = acc * alpha + P @ V over this thread's keys ----
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g < G) {
        acc[g][0] *= alpha_s[g];
        acc[g][1] *= alpha_s[g];
      }
    }
    for (int j = kg; cp < C::NCP && j < TK; j += C::NKG) {
      const float2 vv = load_pair(Vs + (buf * TK + j) * HD + 2 * cp);
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g < G) {
          const float p = s_s[g * TK + j];
          acc[g][0] = fmaf(p, vv.x, acc[g][0]);
          acc[g][1] = fmaf(p, vv.y, acc[g][1]);
        }
      }
    }
    __syncthreads();                    // buffer `buf` and s_s free again
  }

  // ---- reduce the key groups and write the float32 partial ----
  float* red = reinterpret_cast<float*>(smem_raw);   // [NKG][G][HD]
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g < G && cp < C::NCP) {
      red[(kg * G + g) * HD + 2 * cp] = acc[g][0];
      red[(kg * G + g) * HD + 2 * cp + 1] = acc[g][1];
    }
  }
  __syncthreads();
  for (int idx = tid; idx < G * HD; idx += NTHREADS) {
    float a = 0.f;
#pragma unroll
    for (int k2 = 0; k2 < C::NKG; ++k2) a += red[k2 * G * HD + idx];
    part_acc[pbase * HD + idx] = a;
  }
  if (tid < G) {
    part_m[pbase + tid] = m_s[tid];
    part_l[pbase + tid] = l_s[tid];
  }
}

// --------------------------------------------------------------------------
// bfloat16: the same split on the tensor cores. The G query heads are rows
// 0..G-1 of the 16-row A operand (the rest zero); each warp owns 16 keys of
// every tile and keeps its own online softmax; the 4 warps' states are
// merged by log-sum-exp in shared memory at the end.
// --------------------------------------------------------------------------
template <int HD>
struct Bf16Cfg {
  static constexpr int TK = 64;                    // keys a tile, 16 a warp
  static constexpr int ROW = HD + 8;               // padded smem row (bf16)
  static constexpr int CPR = HD / 8;               // 16-byte chunks a row
  static constexpr size_t KV_BYTES = sizeof(__nv_bfloat16) * 4 * TK * ROW;
  static constexpr size_t MERGE_BYTES = sizeof(float) * NWARPS * MAXG * (HD + 2);
  static_assert(MERGE_BYTES <= KV_BYTES, "the merge aliases the K/V tiles");
};

template <int HD>
size_t bf16_smem_bytes(int npg) {
  using C = Bf16Cfg<HD>;
  return C::KV_BYTES + sizeof(__nv_bfloat16) * 16 * C::ROW + sizeof(int) * npg;
}

template <int HD>
__global__ void __launch_bounds__(NTHREADS)
paged_decode_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ kp,
                         const __nv_bfloat16* __restrict__ vp,
                         const int* __restrict__ bt, const int* __restrict__ cl,
                         float* __restrict__ part_m, float* __restrict__ part_l,
                         float* __restrict__ part_acc, int H, int K, int page,
                         int MP, int split, float scale, float softcap) {
  using C = Bf16Cfg<HD>;
  constexpr int TK = C::TK, ROW = C::ROW, CPR = C::CPR;
  constexpr int ND = HD / 8;                       // n tiles of the output
  constexpr float LOG2E = 1.4426950408889634f;
  typedef __nv_bfloat16 bf16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);    // [2][TK][ROW]
  bf16* Vs = Ks + 2 * TK * ROW;                    // [2][TK][ROW]
  bf16* Qs = Vs + 2 * TK * ROW;                    // [16][ROW]
  int* pages_s = reinterpret_cast<int*>(Qs + 16 * ROW);

  const int sp = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = H / K;
  const size_t pbase = (((size_t)b * K + kh) * n_split + sp) * G;

  const int ctx = max(0, min(cl[b], MP * page));
  const int t0 = sp * split;
  if (t0 >= ctx) {                      // neutral partial
    if (tid < G) {
      part_m[pbase + tid] = NEG_INF;
      part_l[pbase + tid] = 0.f;
    }
    return;
  }
  const int t1 = min(t0 + split, ctx);
  const int pg0 = t0 / page;
  if (bt != nullptr) {
    const int npg = (t1 - 1) / page - pg0 + 1;
    for (int i = tid; i < npg; i += NTHREADS)
      pages_s[i] = bt[(size_t)b * MP + pg0 + i];
  }
  // q rows 0..G-1 of the A operand, the rest zero
  for (int c = tid; c < 16 * CPR; c += NTHREADS) {
    const int r = c / CPR, cc = c % CPR;
    const bool ok = r < G;
    cp_async16(Qs + r * ROW + cc * 8,
               ok ? q + ((size_t)b * H + kh * G + r) * HD + cc * 8 : q, ok);
  }
  __syncthreads();                      // pages_s ready for the copies

  const size_t row_stride = (size_t)K * HD;
  auto load_tile = [&](int base, int buf) {
    for (int c = tid; c < TK * CPR; c += NTHREADS) {
      const int r = c / CPR, cc = c % CPR, t = base + r;
      const bool ok = t < t1;
      size_t off = 0;
      if (ok) {
        const int pid = bt != nullptr ? pages_s[t / page - pg0] : b * MP + t / page;
        off = ((size_t)pid * page + t % page) * row_stride + (size_t)kh * HD + cc * 8;
      }
      cp_async16(Ks + (buf * TK + r) * ROW + cc * 8, kp + off, ok);
      cp_async16(Vs + (buf * TK + r) * ROW + cc * 8, vp + off, ok);
    }
    cp_async_commit();
  };

  const int mi = lane >> 3, mr = lane & 7;         // ldmatrix: matrix, row
  const float sl = scale * LOG2E;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  unsigned qf[HD / 16][4];

  const int ntiles = (t1 - t0 + TK - 1) / TK;
  load_tile(t0, 0);                     // (the q copies join this group)
  for (int it = 0; it < ntiles; ++it) {
    const int buf = it & 1;
    const int base = t0 + it * TK;
    if (it + 1 < ntiles) {
      load_tile(base + TK, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        ldmatrix_x4(qf[kk], Qs + ((mi & 1) * 8 + mr) * ROW + kk * 16 + (mi >> 1) * 8);
    }
    const bf16* Kb = Ks + (buf * TK + warp * 16) * ROW;
    const bf16* Vb = Vs + (buf * TK + warp * 16) * ROW;

    // ---- scores of this warp's 16 keys: two 8-key n tiles ----
    float s[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      unsigned bb[4];
      ldmatrix_x4(bb, Kb + ((mi >> 1) * 8 + mr) * ROW + kk * 16 + (mi & 1) * 8);
      mma_bf16(s[0], qf[kk], bb[0], bb[1]);
      mma_bf16(s[1], qf[kk], bb[2], bb[3]);
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = base + warp * 16 + n * 8 + 2 * (lane & 3) + (e & 1);
        float x = s[n][e];
        if (softcap > 0.f) x = softcap * tanhf(x * scale / softcap) * LOG2E;
        else x *= sl;
        x = t < t1 ? x : -INFINITY;               // log2 units
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);     // finite: m >= NEG_INF
      alpha[i] = fast_exp2(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = fast_exp2(s[n][e] - m[e >> 1]);
        s[n][e] = p;
        l[e >> 1] += p;
      }
    }
    unsigned ph[4], pl[4];
    split_pair(s[0][0], s[0][1], ph[0], pl[0]);
    split_pair(s[0][2], s[0][3], ph[1], pl[1]);
    split_pair(s[1][0], s[1][1], ph[2], pl[2]);
    split_pair(s[1][2], s[1][3], ph[3], pl[3]);
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      acc[d][0] *= alpha[0];
      acc[d][1] *= alpha[0];
      acc[d][2] *= alpha[1];
      acc[d][3] *= alpha[1];
    }
#pragma unroll
    for (int np = 0; np < ND / 2; ++np) {
      unsigned bb[4];
      ldmatrix_x4_trans(bb, Vb + ((mi & 1) * 8 + mr) * ROW + np * 16 + (mi >> 1) * 8);
      mma_bf16(acc[2 * np], ph, bb[0], bb[1]);
      mma_bf16(acc[2 * np], pl, bb[0], bb[1]);
      mma_bf16(acc[2 * np + 1], ph, bb[2], bb[3]);
      mma_bf16(acc[2 * np + 1], pl, bb[2], bb[3]);
    }
    __syncthreads();                    // buffer `buf` free for tile it + 2
  }

  // ---- merge the 4 warps by log-sum-exp; write the float32 partial ----
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  float* mw = reinterpret_cast<float*>(smem_raw);  // [NWARPS][MAXG]
  float* lw = mw + NWARPS * MAXG;                  // [NWARPS][MAXG]
  float* aw = lw + NWARPS * MAXG;                  // [NWARPS][MAXG][HD]
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int g = (lane >> 2) + 8 * i;
    if (g < G) {
      if ((lane & 3) == 0) {
        mw[warp * MAXG + g] = m[i];
        lw[warp * MAXG + g] = l[i];
      }
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        const int c = d * 8 + 2 * (lane & 3);
        aw[(warp * MAXG + g) * HD + c] = acc[d][2 * i];
        aw[(warp * MAXG + g) * HD + c + 1] = acc[d][2 * i + 1];
      }
    }
  }
  __syncthreads();
  for (int idx = tid; idx < G * HD; idx += NTHREADS) {
    const int g = idx / HD, d = idx % HD;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) M = fmaxf(M, mw[w * MAXG + g]);
    float a = 0.f, L = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      const float f = fast_exp2(mw[w * MAXG + g] - M);
      a += aw[(w * MAXG + g) * HD + d] * f;
      L += lw[w * MAXG + g] * f;
    }
    part_acc[(pbase + g) * HD + d] = a;
    if (d == 0) {
      part_m[pbase + g] = M * 0.6931471805599453f;   // natural-log units
      part_l[pbase + g] = L;
    }
  }
}

// Merge the splits of one (row, kv head) by log-sum-exp; a split with l = 0
// (past the context) is skipped, so a row with context 0 gives zeros. The
// (m, l) of all splits are staged in shared memory first, so each output
// element's loads of the partial sums are independent of one another.
template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS)
paged_decode_combine_kernel(const float* __restrict__ part_m,
                            const float* __restrict__ part_l,
                            const float* __restrict__ part_acc, T* __restrict__ o,
                            int H, int K, int n_split) {
  extern __shared__ float comb_s[];     // w [n_split][G] | inv [G]
  const int bk = blockIdx.x;
  const int b = bk / K, kh = bk % K;
  const int G = H / K;
  const int tid = threadIdx.x;
  const size_t base = (size_t)bk * n_split * G;
  float* w_s = comb_s;
  float* inv_s = comb_s + n_split * G;
  for (int i = tid; i < n_split * G; i += NTHREADS)
    w_s[i] = part_l[base + i] > 0.f ? part_m[base + i] : NEG_INF;
  __syncthreads();
  if (tid < G) {
    float M = NEG_INF;
    for (int s = 0; s < n_split; ++s) M = fmaxf(M, w_s[s * G + tid]);
    float L = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float l = part_l[base + s * G + tid];
      const float w = l > 0.f ? expf(w_s[s * G + tid] - M) : 0.f;
      w_s[s * G + tid] = w;
      L += l * w;
    }
    inv_s[tid] = 1.f / fmaxf(L, 1e-30f);
  }
  __syncthreads();
  for (int idx = tid; idx < G * HD; idx += NTHREADS) {
    const int g = idx / HD;
    float a = 0.f;
#pragma unroll 4
    for (int s = 0; s < n_split; ++s) {
      const float w = w_s[s * G + g];
      if (w > 0.f) a += w * part_acc[(base + s * G) * HD + idx];
    }
    o[((size_t)b * H + kh * G) * HD + idx] = from_f<T>(a * inv_s[g]);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* kp, const void* vp, const void* bt,
           const void* cl, void* o, void* part, int B, int H, int K, int page,
           int MP, int split, int n_split, float softcap, cudaStream_t stream) {
  const int G = H / K;
  const int npg = split / page + 2;
  const size_t n = (size_t)B * K * n_split * G;
  float* pm = static_cast<float*>(part);
  float* pl = pm + n;
  float* pa = pl + n;
  const dim3 grid(n_split, K, B);
  const float scale = 1.f / sqrtf((float)HD);
  static size_t smem_set = 0;           // per instantiation
  if constexpr (sizeof(T) == 2) {
    auto kern = paged_decode_bf16_kernel<HD>;
    const size_t smem = bf16_smem_bytes<HD>(npg);
    if (smem > 232448) return (int)cudaErrorInvalidValue;
    if (smem > smem_set) {
      cudaError_t err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
      smem_set = smem;
    }
    kern<<<grid, NTHREADS, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(kp),
        static_cast<const __nv_bfloat16*>(vp), static_cast<const int*>(bt),
        static_cast<const int*>(cl), pm, pl, pa, H, K, page, MP, split, scale,
        softcap);
  } else {
    auto kern = paged_decode_split_kernel<T, HD>;
    const size_t smem = smem_bytes<T, HD>(G, npg);
    if (smem > 232448) return (int)cudaErrorInvalidValue;
    if (smem > smem_set) {
      cudaError_t err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
      smem_set = smem;
    }
    kern<<<grid, NTHREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(kp),
        static_cast<const T*>(vp), static_cast<const int*>(bt),
        static_cast<const int*>(cl), pm, pl, pa, H, K, page, MP, split, scale,
        softcap);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  paged_decode_combine_kernel<T, HD>
      <<<B * K, NTHREADS, sizeof(float) * (n_split + 1) * G, stream>>>(
          pm, pl, pa, static_cast<T*>(o), H, K, n_split);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* kp, const void* vp,
                const void* bt, const void* cl, void* o, void* part, int B,
                int H, int K, int page, int MP, int split, int n_split,
                float softcap, cudaStream_t s) {
  switch (hd) {
    case 32: return launch<T, 32>(q, kp, vp, bt, cl, o, part, B, H, K, page, MP, split, n_split, softcap, s);
    case 64: return launch<T, 64>(q, kp, vp, bt, cl, o, part, B, H, K, page, MP, split, n_split, softcap, s);
    case 96: return launch<T, 96>(q, kp, vp, bt, cl, o, part, B, H, K, page, MP, split, n_split, softcap, s);
    case 112: return launch<T, 112>(q, kp, vp, bt, cl, o, part, B, H, K, page, MP, split, n_split, softcap, s);
    case 128: return launch<T, 128>(q, kp, vp, bt, cl, o, part, B, H, K, page, MP, split, n_split, softcap, s);
    case 160: return launch<T, 160>(q, kp, vp, bt, cl, o, part, B, H, K, page, MP, split, n_split, softcap, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. bt may be null (row b's key t at page
// b*MP + t/page). part: float32 scratch of B*K*n_split*G*(hd + 2) values.
// split: keys a CTA, a multiple of 64 with split * n_split >= MP * page.
// softcap <= 0 means "none". Launches the split kernel and the combine
// kernel on `stream`; returns the CUDA error code (0 on success).
extern "C" int paged_decode(const void* q, const void* kp, const void* vp,
                            const void* bt, const void* cl, void* o, void* part,
                            int B, int H, int K, int hd, int page, int MP,
                            int split, int n_split, int dtype, float softcap,
                            void* stream) {
  if (K <= 0 || H % K != 0 || H / K > MAXG || B <= 0 || page <= 0 || MP <= 0
      || split <= 0 || split % SPLIT_ALIGN != 0 || n_split <= 0
      || (long long)split * n_split < (long long)MP * page
      || (long long)split * (n_split - 1) >= (long long)MP * page)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(hd, q, kp, vp, bt, cl, o, part, B, H, K, page,
                              MP, split, n_split, softcap, s);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(hd, q, kp, vp, bt, cl, o, part, B, H, K,
                                      page, MP, split, n_split, softcap, s);
  return (int)cudaErrorInvalidValue;
}
