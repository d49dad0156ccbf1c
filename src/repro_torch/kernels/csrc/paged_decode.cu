// Paged decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `paged_decode_attention` of
// src/repro/kernels/paged_attention.py (body `_kernel`): one query token per
// row attends over its pages of a pooled KV cache. q (B,H,hd); pages
// (P,page,K,hd); block_tables (B,MP) or null; context_lens (B,). The G = H/K
// query heads of one kv head share its pages (q head kh*G+g). Keys are read
// only below context_lens[b] (and below MP*page); float32 online softmax,
// optional softcap, NEG_INF = -1e30 with a 1e-30 denominator floor, and a
// row with context 0 gives zeros. A null block table (MP = 1) reads row b's
// keys from a contiguous (B, C = page, K, hd) cache: no table is built.
//
// What bounds it on the H100: every cached key and value of a row is read
// once and used by only G query heads (G = 4 on qwen3-8b), about 2*G
// multiply-adds per byte, far below the ~295 operations a byte at which
// arithmetic would set the pace. So the bound is the bytes: 2 * ctx * K * hd
// elements a row, over 3.35 TB/s. What kept the previous (mma.sync,
// cp.async) kernel at 50-72% of it: a split plan sized for 4 CTAs an SM
// when 3 fit (1.3-1.5 waves, the last one streaming at a fraction of the
// bandwidth), and one 32 KB tile in flight a CTA behind two block barriers
// per tile. The design:
//   * split-KV (flash-decoding): the grid is (n_split, K, B); each CTA owns
//     one key range of `split` keys of one (row, kv head). The split comes
//     from shapes only (`paged_attention.plan`: capacity, B*K, the CTAs
//     that really fit on an SM, the SM count), never from context_lens, so
//     no host sync is needed and the launch can be captured in a CUDA
//     graph; the grid fills whole waves of resident CTAs (256 CTAs at the
//     serving shapes, two an SM). A CTA whose range starts at or past its
//     row's context writes a neutral partial (m = NEG_INF, l = 0), or zeros
//     when it is the row's only split.
//   * bfloat16, warp-specialised on TMA + wgmma. One producer warp walks
//     the range in 64-key tiles and copies each tile's K and V by TMA
//     (cp.async.bulk.tensor over 4-d tensor maps of (rows or pages, slots,
//     kv heads, hd), boxes of 64 hd columns zero-filled past hd, 128-byte
//     swizzle) into a ring of 2-4 stages with a full and an empty mbarrier
//     each; under a block table a box never crosses a page (box rows =
//     gcd(page, 64); a tile over small pages is one box a page, all
//     completing on the tile's full barrier). Only the producer computes
//     K/V addresses. It needs few registers, so there is no setmaxnreg:
//     the CTA is 160 threads, two or three CTAs an SM, 6-12 tiles (192 KB)
//     in flight on each SM. One consumer warpgroup takes
//     the 64-key tile as the 64-row operand of two products: S^T = K Q^T
//     (SS, N = G padded to 8, Q^T swizzled into shared memory once), and
//     O^T += V^T [P_hi | P_lo]^T (SS, A = the V tile read MN-major, B = P
//     written to shared memory, hi and lo of each head as two of N = 2G
//     columns: one product where the previous kernel issued two). The
//     per-head max of a tile over its 64 keys is one exchange through
//     shared memory across the 4 warps (a named barrier, no block-wide
//     one); P's stores are fenced to the async proxy before a second named
//     barrier. P keeps float32 precision as hi + lo (bf16 P alone missed
//     the bf16 tolerance, scripts/kernel_variants.py).
//   * bfloat16 under a block table whose pages are not a multiple of 8
//     slots (`paged_attention.plan`'s "cp.async" copy): a 128-byte-swizzled
//     TMA box is a 1024-byte atom of 8 rows that has to land 1024-aligned,
//     so a box of fewer rows (a page of 1-7 slots, or gcd(page, 64) < 8)
//     cannot fill part of an atom, and an unswizzled box does not help,
//     since wgmma's core matrices are 8 rows of 16 bytes too. There the
//     producer warp copies each key row itself, 16-byte cp.async chunks
//     (each key's page looked up in the block table, columns past hd and
//     keys past the range zero-filled) to the byte offsets TMA's swizzle
//     would give, so the ring, the consumer and its wgmma descriptors stay
//     as they are. The stage's full barrier counts one arrival a lane
//     (cp.async.mbarrier.arrive.noinc: each lane's arrival fires when its
//     copies have landed). What bounds it is still the bytes, but one warp
//     issues every 16-byte copy (32-96 a lane a tile) where TMA took one
//     instruction a box, so it runs further from the bound. It is a
//     separate instance of the kernel (CPA), so pages of a multiple of 8
//     slots run the TMA instance, unchanged.
//   * float32 stays on the CUDA cores, exact (no TF32): scores are one
//     (key, head group) a thread, the softmax one warp a head, P V one column
//     pair a thread over a slice of the tile's keys. K rows are padded by
//     16 bytes, so the thread-per-key 16-byte reads hit no bank twice.
//   * the splits' float32 partials (m, l, acc) are merged by log-sum-exp in
//     split order by the last CTA of each (row, kv head) to finish, elected
//     by an atomic ticket on a counter that it puts back to zero
//     (`merge_if_last`, both dtypes; one kernel a call: a second merge
//     kernel cost 5-7 us a call at the serving shapes, PERF.md); a call of
//     one split writes its output directly. The ticket only elects the
//     merger; the merge order is fixed, so results are the same run to run.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

#include "tma.cuh"
#include "wgmma.cuh"

namespace {

using namespace tma;

constexpr int NTHREADS = 128;
constexpr int NWARPS = NTHREADS / 32;
constexpr int MAXG = 16;              // query heads per kv head
constexpr int SPLIT_ALIGN = 64;       // split lengths are multiples of this
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int MAX_SMEM = 232448;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
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
// 16 bytes global -> shared address `dst`; zero-filled when !pred
__device__ __forceinline__ void cp_async16_s(uint32_t dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(pred ? 16 : 0) : "memory");
}
// an arrival on `bar` once every cp.async this thread has issued has landed;
// .noinc: the arrival is one of the barrier's expected count
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
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

// The last CTA of a (row, kv head) to finish merges its splits' float32
// partials by log-sum-exp, in split order (a split with l = 0, past the
// context, weighs nothing), into `out` (the row and kv head's G x HD).
// `cnt` counts the (row, kv head)'s finished splits: each CTA fences its
// partial and takes a ticket; the one that takes the last merges
// and puts the count back to 0 for the next call on the stream. Every
// split's (m, l) is first staged in shared memory (`ws`: (2 n_split + 1) G
// floats over the K/V tiles, free by then) by loads that do not wait on one
// another, so the merge costs a few L2 round trips, not one a split. 128
// threads (the float32 CTA, or the bf16 consumer warpgroup), named
// barrier 1.
template <typename T, int HD>
__device__ void merge_if_last(const float* __restrict__ part_m, const float* __restrict__ part_l,
                              const float* __restrict__ part_acc, T* __restrict__ out,
                              int* __restrict__ cnt, int* flag_s, float* ws, size_t base,
                              int G, int n_split) {
  const int tid = threadIdx.x;
  __threadfence();                      // this CTA's partial, before its ticket
  named_sync(1, NTHREADS);
  if (tid == 0) *flag_s = atomicAdd(cnt, 1) == n_split - 1;
  named_sync(1, NTHREADS);
  if (!*flag_s) return;
  __threadfence();                      // the other CTAs' partials, after the tickets
  const int n = n_split * G;
  float* w_s = ws;                      // [n_split][G]: m, then the weight
  float* l_s = ws + n;                  // [n_split][G]
  float* inv_s = ws + 2 * n;            // [G]
  for (int i = tid; i < n; i += NTHREADS) {
    const float l = __ldcg(part_l + base + i);
    l_s[i] = l;
    w_s[i] = l > 0.f ? __ldcg(part_m + base + i) : NEG_INF;
  }
  named_sync(1, NTHREADS);
  if (tid < G) {
    float M = NEG_INF;
    for (int s = 0; s < n_split; ++s) M = fmaxf(M, w_s[s * G + tid]);
    float L = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float l = l_s[s * G + tid];
      const float w = l > 0.f ? expf(w_s[s * G + tid] - M) : 0.f;
      w_s[s * G + tid] = w;
      L += l * w;
    }
    inv_s[tid] = 1.f / fmaxf(L, 1e-30f);
  }
  named_sync(1, NTHREADS);
  for (int idx = tid; idx < G * HD; idx += NTHREADS) {
    const int g = idx / HD;
    float a = 0.f;
#pragma unroll 4
    for (int s = 0; s < n_split; ++s) {
      const float w = w_s[s * G + g];
      if (w > 0.f) a += w * __ldcg(part_acc + (base + s * G) * HD + idx);
    }
    out[idx] = from_f<T>(a * inv_s[g]);
  }
  if (tid == 0) *cnt = 0;
}

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
                          const int* __restrict__ cl, T* __restrict__ o,
                          float* __restrict__ part_m, float* __restrict__ part_l,
                          float* __restrict__ part_acc, int* __restrict__ cnt, int H,
                          int K, int page, int MP, int split, float scale,
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

  T* out = o + ((size_t)b * H + kh * G) * HD;
  cnt += (size_t)b * K + kh;
  int* flag_s = reinterpret_cast<int*>(alpha_s);      // after the loop
  const size_t base = ((size_t)b * K + kh) * n_split * G;

  const int ctx = max(0, min(cl[b], MP * page));
  const int t0 = sp * split;
  if (t0 >= ctx) {                      // zeros (ctx 0), or a neutral partial
    if (n_split == 1) {
      for (int i = tid; i < G * HD; i += NTHREADS) out[i] = from_f<T>(0.f);
      return;
    }
    if (tid < G) {
      part_m[pbase + tid] = NEG_INF;
      part_l[pbase + tid] = 0.f;
    }
    merge_if_last<T, HD>(part_m, part_l, part_acc, out, cnt, flag_s,
                         reinterpret_cast<float*>(smem_raw), base, G, n_split);
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
    // one split: the merge's arithmetic with its one weight, exp(0) = 1
    if (n_split == 1) out[idx] = from_f<T>(a * (1.f / fmaxf(l_s[idx / HD], 1e-30f)));
    else part_acc[pbase * HD + idx] = a;
  }
  if (n_split == 1) return;
  if (tid < G) {
    part_m[pbase + tid] = m_s[tid];
    part_l[pbase + tid] = l_s[tid];
  }
  merge_if_last<T, HD>(part_m, part_l, part_acc, out, cnt, flag_s,
                       reinterpret_cast<float*>(smem_raw), base, G, n_split);
}

// --------------------------------------------------------------------------
// bfloat16: TMA producer warp + one wgmma consumer warpgroup (see the top).
// HD in NB boxes of 64 columns; GB (4, 8 or 16) query heads a kv head at
// most, so S^T is N = NS wide (G padded to 8) and O^T N = NO = 2 GB wide.
// --------------------------------------------------------------------------
template <int HD, int GB>
struct DecCfg {
  static constexpr int TK = 64;                     // keys a tile
  static constexpr int NB = (HD + 63) / 64;         // 64-column boxes (and M blocks of O^T)
  static constexpr int NS = GB < 8 ? 8 : GB;        // N of S^T
  static constexpr int NO = 2 * GB;                 // N of O^T: hi, lo of each head
  static constexpr int NT = NTHREADS + 32;          // consumers + the producer warp
  static constexpr int BOX = TK * 128;              // one 64-column box of a tile
  static constexpr int KV_BYTES = NB * BOX;         // K or V of a stage
  static constexpr int Q_BYTES = NB * NS * 128;
  static constexpr int P_BYTES = NO * 128;
  static constexpr int RED_BYTES = 2 * NWARPS * MAXG * 4;   // tile max, sums
  // dynamic shared memory: alignment slack, the ring (K and V a stage), Q^T,
  // P, the exchange, two barriers a stage (`paged_attention.plan` repeats it)
  static size_t bytes(int stages) {
    return 1024 + (size_t)stages * 2 * KV_BYTES + Q_BYTES + P_BYTES + RED_BYTES + 16 * stages;
  }
};

// CPA: the producer copies K and V by cp.async (pages not a multiple of 8
// slots; kp and vp are read, the tensor maps are not), else by TMA (the
// tensor maps; kp and vp are not read)
template <int HD, int GB, bool CPA>
__global__ void __launch_bounds__(DecCfg<HD, GB>::NT, 2)
paged_decode_bf16_kernel(const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const bf16* __restrict__ q, const int* __restrict__ bt,
                         const int* __restrict__ cl, bf16* __restrict__ o,
                         float* __restrict__ part_m, float* __restrict__ part_l,
                         float* __restrict__ part_acc, int* __restrict__ cnt, int H, int K,
                         int page, int MP, int split, int box, int stages, float scale,
                         float softcap, const bf16* __restrict__ kp,
                         const bf16* __restrict__ vp) {
  using C = DecCfg<HD, GB>;
  constexpr int TK = C::TK, NB = C::NB, NS = C::NS, NO = C::NO;
  constexpr int SJ = NS / 8, OJ = NO / 8;           // 8-column blocks of S^T, O^T
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* KVs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* Qs = KVs + (size_t)stages * 2 * C::KV_BYTES;   // [NB][NS][64]
  unsigned char* Ps = Qs + C::Q_BYTES;                          // [NO][TK]
  float* red_m = reinterpret_cast<float*>(Ps + C::P_BYTES);     // [NWARPS][MAXG]
  float* red_l = red_m + NWARPS * MAXG;                         // [NWARPS][MAXG]
  uint64_t* bars = reinterpret_cast<uint64_t*>(red_l + NWARPS * MAXG);

  const int sp = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x;
  const int tid = threadIdx.x;
  const int G = H / K;
  const size_t base = ((size_t)b * K + kh) * n_split * G;   // split 0's partial
  const size_t pbase = base + (size_t)sp * G;
  bf16* out = o + ((size_t)b * H + kh * G) * HD;
  cnt += (size_t)b * K + kh;
  int* flag_s = reinterpret_cast<int*>(red_m);                  // after the loop

  const int ctx = max(0, min(cl[b], MP * page));
  const int t0 = sp * split;
  if (t0 >= ctx) {                      // zeros (ctx 0), or a neutral partial
    if (n_split == 1) {
      for (int i = tid; i < G * HD; i += C::NT) out[i] = __float2bfloat16(0.f);
      return;
    }
    if (tid >= NTHREADS) return;        // the producer warp
    if (tid < G) {
      part_m[pbase + tid] = NEG_INF;
      part_l[pbase + tid] = 0.f;
    }
    merge_if_last<bf16, HD>(part_m, part_l, part_acc, out, cnt, flag_s,
                      reinterpret_cast<float*>(KVs), base, G, n_split);
    return;
  }
  const int t1 = min(t0 + split, ctx);
  const int ntiles = (t1 - t0 + TK - 1) / TK;
  // + 8 * stage: the stage's K and V arrived; read by every consumer warp
  const uint32_t full = smem_u32(bars), empty = full + 8 * stages;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      // TMA: one arrival (with the stage's bytes); cp.async: one a lane
      mbar_init(full + 8 * s, CPA ? 32 : 1);
      mbar_init(empty + 8 * s, NWARPS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // the warp, uniform to the compiler (lane 0's, by a shuffle): no warp
  // diverges across the role branch, so the consumers' wgmma is never in
  // divergent code
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0), lane = tid & 31;
  if (warp == NWARPS && CPA) {
    // ---- producer by cp.async: one warp, 16-byte chunks of the tile's key
    //      rows (hd in NB boxes of 64 columns, 8 chunks a box row, zero
    //      past hd and past the range), to the bytes TMA's 128-byte swizzle
    //      would write ----
    constexpr int CPR = NB * 8;                 // chunks a key row of a stage
    for (int it = 0; it < ntiles; ++it) {
      const int s = it % stages;
      mbar_wait(empty + 8 * s, ((it / stages) & 1) ^ 1);
      // the consumers' wgmma reads of this stage (async proxy), which they
      // retired before their arrivals, ordered before this lane's writes
      fence_proxy_async();
      // the cache rows (page * slots + slot) of the tile's keys lane and
      // lane + 32, -1 past the range; each chunk takes its key's by shuffle
      int ri[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = t0 + it * TK + lane + 32 * h;
        ri[h] = -1;
        if (t < t1) ri[h] = bt[(size_t)b * MP + t / page] * page + t % page;
      }
      const uint32_t kb = smem_u32(KVs) + (uint32_t)s * 2 * C::KV_BYTES;
#pragma unroll 4
      for (int i = lane; i < TK * CPR; i += 32) {  // 2 CPR chunks a lane
        const int r = i / CPR, c = i % CPR;      // key of the tile, chunk of its row
        const int r0v = __shfl_sync(0xffffffffu, ri[0], r & 31);
        const int r1v = __shfl_sync(0xffffffffu, ri[1], r & 31);
        const int row = r < 32 ? r0v : r1v;
        const bool ok = row >= 0 && c * 8 < HD;
        const size_t off = ok ? ((size_t)row * K + kh) * HD + c * 8 : 0;
        const uint32_t dst = kb + (c >> 3) * C::BOX + sw128_offset(r, c & 7);
        cp_async16_s(dst, kp + off, ok);
        cp_async16_s(dst + C::KV_BYTES, vp + off, ok);
      }
      cp_async_arrive(full + 8 * s);
    }
    cp_async_wait<0>();                         // none in flight at exit
    return;
  }
  if (warp == NWARPS) {
    // ---- producer by TMA: one warp, a lane a box of the tile ----
    const int nbox = TK / box;
    for (int it = 0; it < ntiles; ++it) {
      const int s = it % stages;
      mbar_wait(empty + 8 * s, ((it / stages) & 1) ^ 1);
      if (lane == 0) mbar_expect_tx(full + 8 * s, 2 * C::KV_BYTES);
      __syncwarp();
      if (lane < nbox) {
        int t = t0 + it * TK + lane * box;
        // a box wholly past the context loads the last box that holds a
        // key again (its keys are masked), so every box reads a mapped page
        if (t >= t1) t = (t1 - 1) / box * box;
        const int pid = bt != nullptr ? bt[(size_t)b * MP + t / page] : b;
        const int row = bt != nullptr ? t % page : t;
        const uint32_t kb = smem_u32(KVs) + (uint32_t)s * 2 * C::KV_BYTES + lane * box * 128;
#pragma unroll
        for (int bx = 0; bx < NB; ++bx) {
          tma_load(kb + bx * C::BOX, &tm_k, full + 8 * s, bx * 64, kh, row, pid);
          tma_load(kb + C::KV_BYTES + bx * C::BOX, &tm_v, full + 8 * s, bx * 64, kh, row, pid);
        }
      }
      __syncwarp();
    }
    return;
  }

  // ---- consumer warpgroup: accumulator rows 16 warp + r0 (+ 8), columns
  //      8 j + c2 (+ 1); S^T's rows are keys and columns query heads, O^T's
  //      rows hd and columns (head, hi | lo) ----
  const int r0 = lane >> 2, c2 = 2 * (lane & 3);
  // Q^T, the B operand of S^T: NS rows (query heads, zero past G) of hd in
  // 64-column boxes, swizzled as TMA would write them; P zeroed once
  for (int c = tid; c < NB * NS * 8; c += NTHREADS) {
    const int bx = c / (NS * 8), n = (c / 8) % NS, ch = c % 8;
    const int d = bx * 64 + ch * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (n < G && d < HD)
      v = *reinterpret_cast<const uint4*>(q + ((size_t)b * H + kh * G + n) * HD + d);
    *reinterpret_cast<uint4*>(Qs + bx * NS * 128 + sw128_offset(n, ch)) = v;
  }
  for (int i = tid; i < C::P_BYTES / 16; i += NTHREADS)
    reinterpret_cast<uint4*>(Ps)[i] = make_uint4(0u, 0u, 0u, 0u);
  fence_proxy_async();
  named_sync(1, NTHREADS);

  const float sl = scale * LOG2E;
  // running max and sum of this thread's heads of S^T (2 a column block),
  // running max of its heads of O^T (4 j + lane % 4)
  float mS[2 * SJ], lS[2 * SJ], mO[OJ];
#pragma unroll
  for (int i = 0; i < 2 * SJ; ++i) {
    mS[i] = NEG_INF;
    lS[i] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < OJ; ++j) mO[j] = NEG_INF;
  float sc[NS / 2], oacc[NB][NO / 2];
#pragma unroll
  for (int i = 0; i < NS / 2; ++i) sc[i] = 0.f;
#pragma unroll
  for (int mb = 0; mb < NB; ++mb)
#pragma unroll
    for (int i = 0; i < NO / 2; ++i) oacc[mb][i] = 0.f;
  const uint32_t q_base = smem_u32(Qs), p_base = smem_u32(Ps);

  for (int it = 0; it < ntiles; ++it) {
    const int s = it % stages;
    const int base = t0 + it * TK;
    const uint32_t k_base = smem_u32(KVs) + (uint32_t)s * 2 * C::KV_BYTES;
    const uint32_t v_base = k_base + C::KV_BYTES;

    // ---- S^T = K Q^T: A the K tile, B Q^T, both K-major ----
    mbar_wait(full + 8 * s, (it / stages) & 1);
    // cp.async writes the stage through the generic proxy and wgmma reads
    // it through the async proxy. The barrier's phase completes only when
    // every lane's copies have landed, and this thread's wait observes it;
    // the proxy fence, after the wait and before the first wgmma of the
    // tile, orders those observed writes before this thread's async-proxy
    // reads. Each consumer thread fences, so every wgmma issuer is covered.
    if (CPA) fence_proxy_async();
    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma::SS<NS>::template mma<0>(
          sc, sw128_desc(k_base + (kk >> 2) * C::BOX + (kk & 3) * 32, 0),
          sw128_desc(q_base + (kk >> 2) * NS * 128 + (kk & 3) * 32, 0), kk > 0);
    wgmma::commit();
    wgmma::wait();
    wgmma::hold(sc);

    // ---- scores in log2 units, keys past the range masked; the tile's
    //      max of each head: this thread's two keys, its warp's 16, then
    //      the 4 warps' through shared memory ----
#pragma unroll
    for (int i = 0; i < NS / 2; ++i) {
      const int key = base + 16 * warp + r0 + 8 * ((i >> 1) & 1);
      const float x = softcap > 0.f ? softcap * tanhf(sc[i] * scale / softcap) * LOG2E
                                    : sc[i] * sl;
      sc[i] = key < t1 ? x : -INFINITY;
    }
#pragma unroll
    for (int j = 0; j < SJ; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float mx = fmaxf(sc[4 * j + e], sc[4 * j + 2 + e]);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
        if (r0 == 0) red_m[warp * MAXG + 8 * j + c2 + e] = mx;
      }
    }
    named_sync(1, NTHREADS);
#pragma unroll
    for (int j = 0; j < SJ; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int h = 8 * j + c2 + e;
        float mx = red_m[h];
#pragma unroll
        for (int w = 1; w < NWARPS; ++w) mx = fmaxf(mx, red_m[w * MAXG + h]);
        const float m_new = fmaxf(mS[2 * j + e], mx);   // finite: m >= NEG_INF
        lS[2 * j + e] *= fast_exp2(mS[2 * j + e] - m_new);
        mS[2 * j + e] = m_new;
      }
    }
    float alpha[OJ];
#pragma unroll
    for (int j = 0; j < OJ; ++j) {
      const int h = 4 * j + (lane & 3);
      float mx = red_m[h];
#pragma unroll
      for (int w = 1; w < NWARPS; ++w) mx = fmaxf(mx, red_m[w * MAXG + h]);
      const float m_new = fmaxf(mO[j], mx);
      alpha[j] = fast_exp2(mO[j] - m_new);
      mO[j] = m_new;
    }

    // ---- P = exp2(s - m) into shared memory, K-major rows of the tile's
    //      64 keys: row 2h holds head h's bf16 hi, row 2h + 1 its lo ----
#pragma unroll
    for (int i = 0; i < NS / 2; ++i) {
      const int j = i >> 2, e = i & 1, h = 8 * j + c2 + e;
      const float p = fast_exp2(sc[i] - mS[2 * j + e]);
      lS[2 * j + e] += p;
      const int key = 16 * warp + r0 + 8 * ((i >> 1) & 1);
      if (2 * h < NO) {
        const bf16 hi = __float2bfloat16(p);
        const bf16 lo = __float2bfloat16(p - __bfloat162float(hi));
        *reinterpret_cast<bf16*>(Ps + sw128_offset(2 * h, key >> 3) + 2 * (key & 7)) = hi;
        *reinterpret_cast<bf16*>(Ps + sw128_offset(2 * h + 1, key >> 3) + 2 * (key & 7)) = lo;
      }
    }
    fence_proxy_async();
    named_sync(1, NTHREADS);

    // ---- O^T += V^T P^T: A the V tile MN-major, one 64-row block of hd
    //      at a time; B P, K-major ----
#pragma unroll
    for (int mb = 0; mb < NB; ++mb)
#pragma unroll
      for (int i = 0; i < NO / 2; ++i) oacc[mb][i] *= alpha[i >> 2];
    wgmma::fence();
#pragma unroll
    for (int mb = 0; mb < NB; ++mb)
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk)
        wgmma::SS<NO>::template mma<1>(oacc[mb],
                                       sw128_desc(v_base + mb * C::BOX + kk * 16 * 128, C::BOX),
                                       sw128_desc(p_base + kk * 32, 0), 1);
    wgmma::commit();
    wgmma::wait();
#pragma unroll
    for (int mb = 0; mb < NB; ++mb) wgmma::hold(oacc[mb]);
    if (lane == 0) mbar_arrive(empty + 8 * s);   // this warp's reads of the stage done
  }

  // ---- the sums: this thread's keys, its warp's, then the 4 warps' in a
  //      fixed order; write the output (one split) or the float32 partial
  //      (m in natural-log units) ----
#pragma unroll
  for (int j = 0; j < SJ; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float l = lS[2 * j + e];
      l += __shfl_xor_sync(0xffffffffu, l, 4);
      l += __shfl_xor_sync(0xffffffffu, l, 8);
      l += __shfl_xor_sync(0xffffffffu, l, 16);
      if (r0 == 0) red_l[warp * MAXG + 8 * j + c2 + e] = l;
    }
  }
  named_sync(1, NTHREADS);
#pragma unroll
  for (int j = 0; j < OJ; ++j) {
    const int g = 4 * j + (lane & 3);
    if (g >= G) continue;
    float L = red_l[g];
#pragma unroll
    for (int w = 1; w < NWARPS; ++w) L += red_l[w * MAXG + g];
    const float inv = 1.f / fmaxf(L, 1e-30f);
#pragma unroll
    for (int mb = 0; mb < NB; ++mb) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int d = mb * 64 + 16 * warp + r0 + 8 * r;
        if (d >= HD) continue;
        const float a = oacc[mb][4 * j + 2 * r] + oacc[mb][4 * j + 2 * r + 1];
        if (n_split == 1) out[g * HD + d] = __float2bfloat16(a * inv);
        else part_acc[(pbase + g) * HD + d] = a;
      }
    }
    if (n_split > 1 && warp == 0 && r0 == 0) {
      part_m[pbase + g] = mO[j] * 0.6931471805599453f;
      part_l[pbase + g] = L;
    }
  }
  if (n_split > 1)
    merge_if_last<bf16, HD>(part_m, part_l, part_acc, out, cnt, flag_s,
                      reinterpret_cast<float*>(KVs), base, G, n_split);
}

template <typename Kern>
int set_smem(Kern kern, size_t smem, size_t& smem_set) {
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  if (smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  return 0;
}

// The tensor map of a cache, from a per-thread cache keyed by everything
// the map encodes (base, shape, box rows): the engine calls each layer's
// cache every decode step, and the host is what bounds serving.
int cached_map(CUtensorMap* out, const void* ptr, int hd, int heads, int S, int B, int rows) {
  struct Entry {
    CUtensorMap map;
    const void* ptr;
    int hd, heads, S, B, rows;
  };
  static thread_local Entry cache[64];
  const size_t h = ((reinterpret_cast<uintptr_t>(ptr) >> 8) ^ (size_t)S * 31 ^ (size_t)rows) & 63;
  Entry& e = cache[h];
  if (e.ptr != ptr || e.hd != hd || e.heads != heads || e.S != S || e.B != B
      || e.rows != rows) {
    e.ptr = nullptr;
    if (int err = tensor_map(&e.map, ptr, hd, heads, S, B, rows)) return err;
    e.ptr = ptr;
    e.hd = hd; e.heads = heads; e.S = S; e.B = B; e.rows = rows;
  }
  *out = e.map;
  return 0;
}

struct Args {
  const void *q, *kp, *vp, *bt, *cl;
  void *o, *part;
  int* cnt;
  int B, H, K, page, MP, P, split, n_split, stages, box;
  float softcap;
  cudaStream_t stream;
};

template <int HD>
int launch_f32(const Args& a) {
  const int G = a.H / a.K;
  const int npg = a.split / a.page + 2;
  const size_t smem = smem_bytes<float, HD>(G, npg);
  if ((a.n_split > 1 && (a.part == nullptr || a.cnt == nullptr))
      // the merge stages (m, l) of every split over the K/V tiles
      || (size_t)(2 * a.n_split + 1) * G * 4 > Cfg<float, HD>::KV_BYTES)
    return (int)cudaErrorInvalidValue;
  const size_t n = (size_t)a.B * a.K * a.n_split * G;
  float* pm = static_cast<float*>(a.part);
  float* pl = pm + n;
  float* pa = pl + n;
  auto kern = paged_decode_split_kernel<float, HD>;
  static size_t smem_set = 0;
  if (int e = set_smem(kern, smem, smem_set)) return e;
  kern<<<dim3(a.n_split, a.K, a.B), NTHREADS, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.kp),
      static_cast<const float*>(a.vp), static_cast<const int*>(a.bt),
      static_cast<const int*>(a.cl), static_cast<float*>(a.o), pm, pl, pa, a.cnt, a.H,
      a.K, a.page, a.MP, a.split, 1.f / sqrtf((float)HD), a.softcap);
  return (int)cudaGetLastError();
}

template <int HD, int GB, bool CPA>
int launch_bf16_as(const Args& a) {
  using C = DecCfg<HD, GB>;
  // TMA: a tile is whole boxes, and under a block table a box stays inside
  // a page; cp.async (box 0) reads pages under a block table
  if (a.stages < 2 || a.stages > 8
      || (!CPA && (a.box < 8 || C::TK % a.box || (a.bt != nullptr && a.MP > 1 && a.page % a.box)))
      || (CPA && a.bt == nullptr)
      || (a.n_split > 1 && (a.part == nullptr || a.cnt == nullptr))
      // the merge stages (m, l) of every split in the K/V ring
      || (size_t)(2 * a.n_split + 1) * (a.H / a.K) * 4 > (size_t)a.stages * 2 * C::KV_BYTES)
    return (int)cudaErrorInvalidValue;
  auto kern = paged_decode_bf16_kernel<HD, GB, CPA>;
  static size_t smem_set = 0;
  const size_t smem = C::bytes(a.stages);
  if (int e = set_smem(kern, smem, smem_set)) return e;
  CUtensorMap tk, tv;
  if (!CPA) {
    // pages (P, page, K, hd) under a table, else rows (B, C = page, K, hd)
    const int S = a.page, N = a.bt != nullptr ? a.P : a.B;
    if (int e = cached_map(&tk, a.kp, HD, a.K, S, N, a.box)) return e;
    if (int e = cached_map(&tv, a.vp, HD, a.K, S, N, a.box)) return e;
  } else {
    memset(&tk, 0, sizeof(tk));
    memset(&tv, 0, sizeof(tv));
  }
  const size_t n = (size_t)a.B * a.K * a.n_split * (a.H / a.K);
  float* pm = static_cast<float*>(a.part);
  float* pl = pm + n;
  float* pa = pl + n;
  kern<<<dim3(a.n_split, a.K, a.B), C::NT, smem, a.stream>>>(
      tk, tv, static_cast<const bf16*>(a.q), static_cast<const int*>(a.bt),
      static_cast<const int*>(a.cl), static_cast<bf16*>(a.o), pm, pl, pa, a.cnt, a.H, a.K,
      a.page, a.MP, a.split, a.box, a.stages, 1.f / sqrtf((float)HD), a.softcap,
      static_cast<const bf16*>(a.kp), static_cast<const bf16*>(a.vp));
  return (int)cudaGetLastError();
}

template <int HD, int GB>
int launch_bf16(const Args& a) {
  return a.box == 0 ? launch_bf16_as<HD, GB, true>(a) : launch_bf16_as<HD, GB, false>(a);
}

template <int HD>
int launch(const Args& a, int dtype) {
  if (dtype == 0) return launch_f32<HD>(a);
  const int G = a.H / a.K;
  if (G <= 4) return launch_bf16<HD, 4>(a);
  if (G <= 8) return launch_bf16<HD, 8>(a);
  return launch_bf16<HD, 16>(a);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. bt null: contiguous rows (B, page, K, hd),
// MP = 1; else pages (P, page, K, hd) under bt (B, MP). part: float32
// scratch of B*K*n_split*G*(hd + 2) values (unused by a call of one split).
// cnt: B*K int32 split counters, zero before the call and left zero after
// it (unused by one split); calls that share it must be ordered (one
// stream). split: keys a CTA, a multiple of 64 with split * n_split >=
// MP * page > split * (n_split - 1). stages (2-8) and box are the bf16
// kernel's (`paged_attention.plan`); float32 ignores them. box: the TMA
// box's rows (8-64, dividing 64, and the page when MP > 1), or 0 for the
// cp.async copy (pages under bt of any size). softcap <= 0 means "none".
// Launches one kernel on `stream`; returns the CUDA error code (0 on
// success), or 1001 when the driver has no cuTensorMapEncodeTiled, 1002
// when it refuses a tensor map.
extern "C" int paged_decode(const void* q, const void* kp, const void* vp,
                            const void* bt, const void* cl, void* o, void* part,
                            void* cnt, int B, int H, int K, int hd, int page, int MP, int P,
                            int split, int n_split, int stages, int box, int dtype,
                            float softcap, void* stream) {
  if (K <= 0 || H % K != 0 || H / K > MAXG || B <= 0 || page <= 0 || MP <= 0
      || (bt == nullptr && MP != 1) || B > 65535 || K > 65535
      || split <= 0 || split % SPLIT_ALIGN != 0 || n_split <= 0
      || (long long)split * n_split < (long long)MP * page
      || (long long)split * (n_split - 1) >= (long long)MP * page)
    return (int)cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q; a.kp = kp; a.vp = vp; a.bt = bt; a.cl = cl; a.o = o; a.part = part;
  a.cnt = static_cast<int*>(cnt);
  a.B = B; a.H = H; a.K = K; a.page = page; a.MP = MP; a.P = P;
  a.split = split; a.n_split = n_split; a.stages = stages; a.box = box;
  a.softcap = softcap;
  a.stream = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: return launch<32>(a, dtype);
    case 64: return launch<64>(a, dtype);
    case 96: return launch<96>(a, dtype);
    case 112: return launch<112>(a, dtype);
    case 128: return launch<128>(a, dtype);
    case 160: return launch<160>(a, dtype);
    default: return (int)cudaErrorInvalidValue;
  }
}
