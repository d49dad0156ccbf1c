// Flash prefill attention for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `flash_attention` of
// src/repro/kernels/flash_prefill.py (body `_kernel`): blocked
// online-softmax GQA attention, q (B,Sq,H,hd) over k/v (B,Sk,K,hd) with the
// kv head of query head h at h / G, float32 accumulation, NEG_INF = -1e30,
// denominator floor 1e-30, optional softcap * tanh(s / softcap). Masks:
//   * implicit (no positions): iota causal / window with Sq == Sk, keys past
//     Sk masked;
//   * segment ids: block-diagonal, q segments against k segments;
//   * explicit positions: q_pos / k_pos drive the causal and window terms,
//     Sq != Sk allowed, keys at POS_INVALID masked.
//
// What bounds it on the H100: a call needs 2*hd multiply-adds a query head
// for every unmasked (query, key) pair against one read of q/k/v and one
// write of the output. The serving path's calls are small (packed prefill
// of 2048 tokens in ragged segments, chunks over a cache prefix), so their
// bound is a few hundredths of a millisecond either way, and what kept the
// first version 100-500x away from it was work that is not in the bound:
// float32 FMAs instead of tensor cores, and, worst, masked tiles computed
// in full. The design:
//   * exact tile skipping in every mode. A pre-pass kernel (once a call,
//     shared by all q tiles and heads) reduces each 64-key tile to its
//     [min, max] valid position and segment (no valid key: min > max) and
//     whether all its keys are valid, and each 64-row q tile to the same
//     over its rows. A CTA keeps a k tile
//     only if it has a valid key and, against its q tile, it is not wholly
//     above the causal diagonal (least key position > greatest q position),
//     not wholly before the window of the least q position, and its segment
//     range meets the q tile's. Each of those makes every (query, key) pair
//     of the tile masked, so skipping is exact. The CTA compacts the kept
//     tile indices into shared memory before its first K/V copy starts:
//     a skipped tile's bytes are never loaded.
//   * bfloat16 on the tensor cores: mma.sync.m16n8k16 (bf16 in, float32
//     accumulate) with ldmatrix fragments. One CTA of 4 warps a (64-row q
//     tile, q head); each warp owns 16 rows. S = Q K^T and O += P V both
//     run on the tensor cores; the softmax runs on the C fragments in
//     registers, in log2 units with the scale folded into one multiply and
//     ex2.approx for the exponentials; a FULL tile (the pre-pass says no
//     pair in it is masked) skips the mask code. K/V tiles stay bf16 in
//     shared memory, rows padded by 16 bytes so that ldmatrix hits no bank
//     twice, and arrive by 16-byte cp.async copies, double-buffered: the
//     next kept tile is in flight while the current one is computed.
//     mma.sync rather than wgmma: it takes every serving shape below
//     PyTorch's SDPA on the same inputs (PERF.md), with far simpler code;
//     wgmma is the next step for the long chunk calls, where this kernel
//     is bound by the tensor cores' mma.sync rate.
//   * P keeps float32 precision in P V: P is split into hi = bf16(p) and
//     lo = bf16(p - hi) and multiplied twice, so the product carries ~16
//     bits of p, as the plain version's float32 weights. Rounding p to bf16
//     alone (one MMA) was measured at 2.4x the bf16 tolerance of the checks
//     on the card (scripts/kernel_variants.py), so the second MMA stays.
//   * float32 inputs stay on the CUDA cores (no TF32: float32 parity needs
//     full precision): a 4 x 4 register block of scores and a 4 x (hd/16)
//     block of the output a thread, with the same tile list.
//   * one CTA a (q tile, q head): the G q heads of one kv head read the
//     same K/V tiles, from L2 after the first. Stacking the G heads as rows
//     of one CTA reads each tile once from L2 instead of G times, but moves
//     the same bytes from device memory and does the same MMAs; left as is.
// Rows with no valid key: the plain version gives such a row the uniform
// mean of V over all Sk keys (every logit is NEG_INF). Skipping cannot
// change a row that has a valid key (its key's tile is kept), so a row
// whose running max is still NEG_INF at the end saw no valid key: the CTA
// then computes the mean of V over all Sk keys of its kv head and writes
// that row from it. The serving path never has such a row (every chunk
// row sees its own key).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <limits.h>

namespace {

constexpr int BQ = 64;                  // q rows a tile
constexpr int BK = 64;                  // keys a tile
constexpr int NTHREADS = 128;           // both main kernels
constexpr int NTHREADS_F32 = 256;
constexpr float NEG_INF = -1e30f;
constexpr int POS_INVALID = 1 << 30;
constexpr int MAX_SMEM = 232448;
constexpr int FULL = 1 << 30;           // tile-list flag: no pair is masked
constexpr float LOG2E = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16 bytes (or 4) global -> shared, asynchronously; zero-filled when !pred
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(pred ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
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
__device__ __forceinline__ unsigned pack_bf16(float lo_elem, float hi_elem) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo_elem, hi_elem);
  return *reinterpret_cast<unsigned*>(&h);
}
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
// p as hi + lo, both bf16 pairs
__device__ __forceinline__ void split_pair(float x, float y, unsigned& hi, unsigned& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<unsigned*>(&h);
  lo = pack_bf16(x - hf.x, y - hf.y);
}

// --------------------------------------------------------------------------
// pre-pass: [min, max] of valid positions and segments of each k tile and
// each q tile, int4 {min pos, max pos, min seg, max seg} (a k tile with no
// valid key has min pos > max pos), and whether all keys of a k tile are
// valid.
// --------------------------------------------------------------------------
__device__ __forceinline__ void block_minmax64(int (&v)[4], int (*sh)[4]) {
  // 64 threads: warp shuffles, then the two warps through shared memory
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v[0] = min(v[0], __shfl_xor_sync(0xffffffffu, v[0], off));
    v[1] = max(v[1], __shfl_xor_sync(0xffffffffu, v[1], off));
    v[2] = min(v[2], __shfl_xor_sync(0xffffffffu, v[2], off));
    v[3] = max(v[3], __shfl_xor_sync(0xffffffffu, v[3], off));
  }
  const int w = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) sh[w][i] = v[i];
  }
  __syncthreads();
  v[0] = min(sh[0][0], sh[1][0]);
  v[1] = max(sh[0][1], sh[1][1]);
  v[2] = min(sh[0][2], sh[1][2]);
  v[3] = max(sh[0][3], sh[1][3]);
  __syncthreads();
}

__global__ void __launch_bounds__(64)
flash_tile_summary_kernel(const int* __restrict__ seg_q, const int* __restrict__ seg_k,
                          const int* __restrict__ pos_q, const int* __restrict__ pos_k,
                          int4* __restrict__ qsum, int4* __restrict__ ksum,
                          int* __restrict__ kall, int Sq, int Sk, int nq, int nk) {
  __shared__ int sh[2][4];
  const int x = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  if (x < nk) {
    const int j = x * BK + tid;
    bool valid = j < Sk;
    const int p = valid ? (pos_k != nullptr ? pos_k[(size_t)b * Sk + j] : j) : POS_INVALID;
    valid = valid && p < POS_INVALID;
    const int s = valid && seg_k != nullptr ? seg_k[(size_t)b * Sk + j] : 0;
    int v[4] = {valid ? p : INT_MAX, valid ? p : INT_MIN, valid ? s : INT_MAX,
                valid ? s : INT_MIN};
    const int all = __syncthreads_and(valid);
    block_minmax64(v, sh);
    if (tid == 0) {
      ksum[(size_t)b * nk + x] = make_int4(v[0], v[1], v[2], v[3]);
      kall[(size_t)b * nk + x] = all;
    }
  }
  if (x < nq) {
    const int i = x * BQ + tid;
    const bool valid = i < Sq;
    const int p = valid ? (pos_q != nullptr ? pos_q[(size_t)b * Sq + i] : i) : 0;
    const int s = valid && seg_q != nullptr ? seg_q[(size_t)b * Sq + i] : 0;
    int v[4] = {valid ? p : INT_MAX, valid ? p : INT_MIN, valid ? s : INT_MAX,
                valid ? s : INT_MIN};
    block_minmax64(v, sh);
    if (tid == 0) qsum[(size_t)b * nq + x] = make_int4(v[0], v[1], v[2], v[3]);
  }
}

// Compact the k tiles that the masks do not wholly hide from q tile `qt`
// into list_s, ascending, with FULL set where the masks hide no pair of the
// tile (every key valid, below every q position, inside every window, one
// segment on both sides); returns their count. Ends with __syncthreads.
template <int NT>
__device__ int build_tile_list(const int4* __restrict__ qsum,
                               const int4* __restrict__ ksum,
                               const int* __restrict__ kall, int* list_s,
                               int* wcount_s, int b, int qt, int nq, int nk,
                               int causal, int window, bool has_seg) {
  constexpr int NW = NT / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int4 qs = qsum[(size_t)b * nq + qt];
  int total = 0;
  for (int base = 0; base < nk; base += NT) {
    const int kt = base + tid;
    bool keep = false, full = false;
    if (kt < nk) {
      const int4 ks = ksum[(size_t)b * nk + kt];
      keep = ks.x <= ks.y                                  // a valid key
             && !(causal && ks.x > qs.y)                   // above the diagonal
             && !(window > 0 && ks.y <= qs.x - window)     // before the window
             && !(has_seg && (ks.w < qs.z || ks.z > qs.w));  // other segments
      full = keep && kall[(size_t)b * nk + kt]
             && (!causal || ks.y <= qs.x)
             && (window <= 0 || ks.x > qs.y - window)
             && (!has_seg || (ks.z == ks.w && qs.z == qs.w && ks.z == qs.z));
    }
    const unsigned bal = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) wcount_s[warp] = __popc(bal);
    __syncthreads();
    int off = total, all = 0;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      if (w < warp) off += wcount_s[w];
      all += wcount_s[w];
    }
    if (keep) list_s[off + __popc(bal & ((1u << lane) - 1u))] = kt | (full ? FULL : 0);
    total += all;
    __syncthreads();
  }
  return total;
}

// --------------------------------------------------------------------------
// bfloat16: tensor cores
// --------------------------------------------------------------------------
template <int HD>
struct Bf16Cfg {
  static constexpr int ROW = HD + 8;    // padded smem row, bf16 elements
  static constexpr int CPR = HD / 8;    // 16-byte chunks a row
  static constexpr size_t BYTES =
      sizeof(bf16) * (BQ * ROW + 4 * BK * ROW) + sizeof(int) * (4 * BK + 8);
};

template <int HD>
__global__ void __launch_bounds__(NTHREADS, 2)
flash_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ o,
                  const int* __restrict__ seg_q, const int* __restrict__ seg_k,
                  const int* __restrict__ pos_q, const int* __restrict__ pos_k,
                  const int4* __restrict__ qsum, const int4* __restrict__ ksum,
                  const int* __restrict__ kall, int Sq, int Sk, int H, int K,
                  float scale, int causal, int window, float softcap) {
  using C = Bf16Cfg<HD>;
  constexpr int ROW = C::ROW, CPR = C::CPR;
  constexpr int NT = BK / 8;            // n tiles of S
  constexpr int ND = HD / 8;            // n tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);        // [BQ][ROW]
  bf16* Ks = Qs + BQ * ROW;                            // [2][BK][ROW]
  bf16* Vs = Ks + 2 * BK * ROW;                        // [2][BK][ROW]
  int* kpos_s = reinterpret_cast<int*>(Vs + 2 * BK * ROW);  // [2][BK]
  int* kseg_s = kpos_s + 2 * BK;                       // [2][BK]
  int* wcount_s = kseg_s + 2 * BK;                     // [8]
  int* list_s = wcount_s + 8;                          // [nk]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nq = gridDim.x, nk = (Sk + BK - 1) / BK;
  const int G = H / K, kh = h / G;
  const int q0 = qt * BQ;
  const bool has_pos = pos_q != nullptr;
  const bool has_seg = seg_q != nullptr;

  // ---- the q tile, asynchronously (rows past Sq zero) ----
  for (int c = tid; c < BQ * CPR; c += NTHREADS) {
    const int r = c / CPR, cc = c % CPR, gi = q0 + r;
    const bool ok = gi < Sq;
    const bf16* src = ok ? q + (((size_t)b * Sq + gi) * H + h) * HD + cc * 8 : q;
    cp_async16(Qs + r * ROW + cc * 8, src, ok);
  }
  cp_async_commit();

  const int n_act = build_tile_list<NTHREADS>(qsum, ksum, kall, list_s, wcount_s,
                                              b, qt, nq, nk, causal, window, has_seg);

  auto load_tile = [&](int kt, int buf) {
    const int k0 = (kt & (FULL - 1)) * BK;
    for (int c = tid; c < BK * CPR; c += NTHREADS) {
      const int r = c / CPR, cc = c % CPR, gj = k0 + r;
      const bool ok = gj < Sk;
      const size_t off = ok ? (((size_t)b * Sk + gj) * K + kh) * HD + cc * 8 : 0;
      cp_async16(Ks + (buf * BK + r) * ROW + cc * 8, k + off, ok);
      cp_async16(Vs + (buf * BK + r) * ROW + cc * 8, v + off, ok);
    }
    if (tid < BK) {
      const int gj = k0 + tid;
      if (has_pos)
        cp_async4(kpos_s + buf * BK + tid, pos_k + (gj < Sk ? (size_t)b * Sk + gj : 0), gj < Sk);
    } else if (has_seg) {
      const int gj = k0 + tid - BK;
      cp_async4(kseg_s + buf * BK + tid - BK,
                seg_k + (gj < Sk ? (size_t)b * Sk + gj : 0), gj < Sk);
    }
    cp_async_commit();
  };

  // this thread's two rows of the warp's 16
  const int rr[2] = {warp * 16 + (lane >> 2), warp * 16 + (lane >> 2) + 8};
  int qp[2], qg[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int gi = q0 + rr[i];
    const bool ok = gi < Sq;
    qp[i] = has_pos ? (ok ? pos_q[(size_t)b * Sq + gi] : 0) : gi;
    qg[i] = has_seg ? (ok ? seg_q[(size_t)b * Sq + gi] : 0) : 0;
  }

  const float sl = scale * LOG2E;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  unsigned qf[HD / 16][4];

  if (n_act > 0) load_tile(list_s[0], 0);
  const int mi = lane >> 3, mr = lane & 7;   // ldmatrix: matrix, row
  for (int it = 0; it < n_act; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_act) {
      load_tile(list_s[it + 1], buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        ldmatrix_x4(qf[kk], Qs + (warp * 16 + (mi & 1) * 8 + mr) * ROW + kk * 16 + (mi >> 1) * 8);
    }
    const int k0 = (list_s[it] & (FULL - 1)) * BK;
    const bool full = list_s[it] & FULL;
    const bf16* Kb = Ks + buf * BK * ROW;
    const bf16* Vb = Vs + buf * BK * ROW;

    // ---- S = Q K^T on the tensor cores ----
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        unsigned bb[4];
        ldmatrix_x4(bb, Kb + (np * 16 + (mi >> 1) * 8 + mr) * ROW + kk * 16 + (mi & 1) * 8);
        mma_bf16(s[2 * np], qf[kk], bb[0], bb[1]);
        mma_bf16(s[2 * np + 1], qf[kk], bb[2], bb[3]);
      }
    }

    // ---- scores in log2 units, masks (none on a FULL tile), online
    //      softmax on the fragments ----
    if (softcap > 0.f) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[n][e] = softcap * tanhf(s[n][e] * scale / softcap) * LOG2E;
    } else {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] *= sl;
    }
    if (!full) {
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = n * 8 + 2 * (lane & 3) + (e & 1);
          const int i = e >> 1;
          const int kj = k0 + c;
          const int jp = has_pos ? kpos_s[buf * BK + c] : kj;
          bool ok = kj < Sk && jp < POS_INVALID;
          if (causal) ok = ok && jp <= qp[i];
          if (window > 0) ok = ok && jp > qp[i] - window;
          if (has_seg) ok = ok && kseg_s[buf * BK + c] == qg[i];
          if (!ok) s[n][e] = -INFINITY;
        }
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);   // finite: m >= NEG_INF
      alpha[i] = fast_exp2(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const float p = fast_exp2(s[n][e] - m[i]);
        s[n][e] = p;
        l[i] += p;
      }
    }
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      acc[d][0] *= alpha[0];
      acc[d][1] *= alpha[0];
      acc[d][2] *= alpha[1];
      acc[d][3] *= alpha[1];
    }

    // ---- O += P V on the tensor cores, P as bf16 hi + lo ----
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      unsigned ph[4], pl[4];
      split_pair(s[2 * j][0], s[2 * j][1], ph[0], pl[0]);
      split_pair(s[2 * j][2], s[2 * j][3], ph[1], pl[1]);
      split_pair(s[2 * j + 1][0], s[2 * j + 1][1], ph[2], pl[2]);
      split_pair(s[2 * j + 1][2], s[2 * j + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int np = 0; np < ND / 2; ++np) {
        unsigned bb[4];
        ldmatrix_x4_trans(bb, Vb + (j * 16 + (mi & 1) * 8 + mr) * ROW + np * 16 + (mi >> 1) * 8);
        mma_bf16(acc[2 * np], ph, bb[0], bb[1]);
        mma_bf16(acc[2 * np], pl, bb[0], bb[1]);
        mma_bf16(acc[2 * np + 1], ph, bb[2], bb[3]);
        mma_bf16(acc[2 * np + 1], pl, bb[2], bb[3]);
      }
    }
    __syncthreads();                    // buffer `buf` free for tile it + 2
  }
  cp_async_wait<0>();                   // the q tile, when no tile was kept

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  bool rescue[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) rescue[i] = q0 + rr[i] < Sq && m[i] <= NEG_INF;
  float* vmean = reinterpret_cast<float*>(Ks);       // [HD], rare path
  if (__syncthreads_or(rescue[0] || rescue[1])) {
    for (int d = tid; d < HD; d += NTHREADS) {
      float a = 0.f;
      for (int j = 0; j < Sk; ++j) a += __bfloat162float(v[(((size_t)b * Sk + j) * K + kh) * HD + d]);
      vmean[d] = a / (float)Sk;
    }
    __syncthreads();
  }

  // ---- write O ----
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int gi = q0 + rr[i];
    if (gi >= Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    bf16* out = o + (((size_t)b * Sq + gi) * H + h) * HD;
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      const int c = d * 8 + 2 * (lane & 3);
      const float x = rescue[i] ? vmean[c] : acc[d][2 * i] * inv;
      const float y = rescue[i] ? vmean[c + 1] : acc[d][2 * i + 1] * inv;
      *reinterpret_cast<unsigned*>(out + c) = pack_bf16(x, y);
    }
  }
}

// --------------------------------------------------------------------------
// float32: CUDA cores, same tile list
// --------------------------------------------------------------------------
template <int HD>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) * (BQ * (HD + 1) + BK * (HD + 1) + BK * HD + BQ * (BK + 1))
       + sizeof(int) * (2 * BQ + 2 * BK + 8);
}

template <int HD>
__global__ void __launch_bounds__(NTHREADS_F32)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 const int* __restrict__ seg_q, const int* __restrict__ seg_k,
                 const int* __restrict__ pos_q, const int* __restrict__ pos_k,
                 const int4* __restrict__ qsum, const int4* __restrict__ ksum,
                 const int* __restrict__ kall, int Sq, int Sk, int H, int K,
                 float scale, int causal, int window, float softcap) {
  constexpr int CJ = HD / 16;           // output columns a thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);  // [BQ][HD+1]
  float* Ks = Qs + BQ * (HD + 1);       // [BK][HD+1]
  float* Vs = Ks + BK * (HD + 1);       // [BK][HD]
  float* Ps = Vs + BK * HD;             // [BQ][BK+1]
  int* qpos_s = reinterpret_cast<int*>(Ps + BQ * (BK + 1));
  int* qseg_s = qpos_s + BQ;
  int* kpos_s = qseg_s + BQ;
  int* kseg_s = kpos_s + BK;
  int* wcount_s = kseg_s + BK;          // [8]
  int* list_s = wcount_s + 8;           // [nk]

  const int tid = threadIdx.x;
  const int tx = tid & 15;              // column group
  const int ty = tid >> 4;              // row group: rows 4*ty .. 4*ty+3
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nq = gridDim.x, nk = (Sk + BK - 1) / BK;
  const int q0 = qt * BQ;
  const int G = H / K;
  const int kh = h / G;
  const bool has_pos = pos_q != nullptr;
  const bool has_seg = seg_q != nullptr;

  for (int idx = tid; idx < BQ * HD; idx += NTHREADS_F32) {
    const int r = idx / HD, d = idx % HD, gi = q0 + r;
    Qs[r * (HD + 1) + d] = gi < Sq ? q[((size_t)(b * Sq + gi) * H + h) * HD + d] : 0.f;
  }
  for (int r = tid; r < BQ; r += NTHREADS_F32) {
    const int gi = q0 + r;
    qpos_s[r] = has_pos ? (gi < Sq ? pos_q[(size_t)b * Sq + gi] : 0) : gi;
    qseg_s[r] = has_seg ? (gi < Sq ? seg_q[(size_t)b * Sq + gi] : 0) : 0;
  }
  const int n_act = build_tile_list<NTHREADS_F32>(qsum, ksum, kall, list_s,
                                                  wcount_s, b, qt, nq, nk, causal,
                                                  window, has_seg);

  float m[4], l[4], acc[4][CJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc[i][j] = 0.f;
  }

  for (int it = 0; it < n_act; ++it) {
    const int k0 = (list_s[it] & (FULL - 1)) * BK;
    __syncthreads();                    // previous tile fully consumed
    for (int idx = tid; idx < BK * HD; idx += NTHREADS_F32) {
      const int r = idx / HD, d = idx % HD, gj = k0 + r;
      const size_t off = ((size_t)(b * Sk + gj) * K + kh) * HD + d;
      Ks[r * (HD + 1) + d] = gj < Sk ? k[off] : 0.f;
      Vs[r * HD + d] = gj < Sk ? v[off] : 0.f;
    }
    for (int r = tid; r < BK; r += NTHREADS_F32) {
      const int gj = k0 + r;
      kpos_s[r] = gj < Sk ? (has_pos ? pos_k[(size_t)b * Sk + gj] : gj) : POS_INVALID;
      kseg_s[r] = has_seg && gj < Sk ? seg_k[(size_t)b * Sk + gj] : 0;
    }
    __syncthreads();

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
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int jj = kpos_s[c];
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        bool ok = jj < POS_INVALID;
        if (causal) ok = ok && (jj <= ii);
        if (window > 0) ok = ok && (jj > ii - window);
        if (has_seg) ok = ok && (si == kseg_s[c]);
        x = ok ? x : -INFINITY;
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

  bool rescue[4], any = false;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    rescue[i] = q0 + 4 * ty + i < Sq && m[i] <= NEG_INF;
    any = any || rescue[i];
  }
  __syncthreads();                      // Vs free
  float* vmean = Vs;                    // [HD], rare path
  if (__syncthreads_or(any)) {
    for (int d = tid; d < HD; d += NTHREADS_F32) {
      float a = 0.f;
      for (int j = 0; j < Sk; ++j) a += v[(((size_t)b * Sk + j) * K + kh) * HD + d];
      vmean[d] = a / (float)Sk;
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gi = q0 + 4 * ty + i;
    if (gi >= Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    float* out = o + ((size_t)(b * Sq + gi) * H + h) * HD;
#pragma unroll
    for (int j = 0; j < CJ; ++j)
      out[tx + 16 * j] = rescue[i] ? vmean[tx + 16 * j] : acc[i][j] * inv;
  }
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

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o,
           const void* seg_q, const void* seg_k, const void* pos_q,
           const void* pos_k, void* tiles, int B, int Sq, int Sk, int H, int K,
           int causal, int window, float softcap, cudaStream_t stream) {
  const int nq = (Sq + BQ - 1) / BQ, nk = (Sk + BK - 1) / BK;
  int4* qsum = static_cast<int4*>(tiles);
  int4* ksum = qsum + (size_t)B * nq;
  int* kall = reinterpret_cast<int*>(ksum + (size_t)B * nk);
  const int* sq = static_cast<const int*>(seg_q);
  const int* sk = static_cast<const int*>(seg_k);
  const int* pq = static_cast<const int*>(pos_q);
  const int* pk = static_cast<const int*>(pos_k);
  flash_tile_summary_kernel<<<dim3(nq > nk ? nq : nk, B), 64, 0, stream>>>(
      sq, sk, pq, pk, qsum, ksum, kall, Sq, Sk, nq, nk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const float scale = 1.f / sqrtf((float)HD);
  const dim3 grid(nq, H, B);
  if constexpr (sizeof(T) == 2) {
    auto kern = flash_bf16_kernel<HD>;
    static size_t smem_set = 0;
    const size_t smem = Bf16Cfg<HD>::BYTES + sizeof(int) * nk;
    if (int e = set_smem(kern, smem, smem_set)) return e;
    kern<<<grid, NTHREADS, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(o), sq, sk, pq, pk,
        qsum, ksum, kall, Sq, Sk, H, K, scale, causal, window, softcap);
  } else {
    auto kern = flash_f32_kernel<HD>;
    static size_t smem_set = 0;
    const size_t smem = f32_smem_bytes<HD>() + sizeof(int) * nk;
    if (int e = set_smem(kern, smem, smem_set)) return e;
    kern<<<grid, NTHREADS_F32, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), sq, sk, pq, pk,
        qsum, ksum, kall, Sq, Sk, H, K, scale, causal, window, softcap);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, void* o,
                const void* seg_q, const void* seg_k, const void* pos_q,
                const void* pos_k, void* tiles, int B, int Sq, int Sk, int H,
                int K, int causal, int window, float softcap, cudaStream_t s) {
  switch (hd) {
    case 32: return launch<T, 32>(q, k, v, o, seg_q, seg_k, pos_q, pos_k, tiles, B,
                                  Sq, Sk, H, K, causal, window, softcap, s);
    case 64: return launch<T, 64>(q, k, v, o, seg_q, seg_k, pos_q, pos_k, tiles, B,
                                  Sq, Sk, H, K, causal, window, softcap, s);
    case 96: return launch<T, 96>(q, k, v, o, seg_q, seg_k, pos_q, pos_k, tiles, B,
                                  Sq, Sk, H, K, causal, window, softcap, s);
    case 112: return launch<T, 112>(q, k, v, o, seg_q, seg_k, pos_q, pos_k, tiles, B,
                                    Sq, Sk, H, K, causal, window, softcap, s);
    case 128: return launch<T, 128>(q, k, v, o, seg_q, seg_k, pos_q, pos_k, tiles, B,
                                    Sq, Sk, H, K, causal, window, softcap, s);
    case 160: return launch<T, 160>(q, k, v, o, seg_q, seg_k, pos_q, pos_k, tiles, B,
                                    Sq, Sk, H, K, causal, window, softcap, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. seg_q/seg_k and pos_q/pos_k may be null
// (in pairs). tiles: int32 scratch of B * (4 * ceil(Sq/64) + 5 * ceil(Sk/64))
// values for the pre-pass. window <= 0 and softcap <= 0 mean "none".
// Launches the pre-pass and the attention kernel on `stream`; returns the
// CUDA error code (0 on success).
extern "C" int flash_prefill(const void* q, const void* k, const void* v,
                             void* o, const void* seg_q, const void* seg_k,
                             const void* pos_q, const void* pos_k, void* tiles,
                             int B, int Sq, int Sk, int H, int K, int hd,
                             int dtype, int causal, int window, float softcap,
                             void* stream) {
  if (K <= 0 || H % K != 0 || B <= 0 || Sq <= 0 || Sk <= 0 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(hd, q, k, v, o, seg_q, seg_k, pos_q, pos_k, tiles,
                              B, Sq, Sk, H, K, causal, window, softcap, s);
  if (dtype == 1)
    return dispatch_hd<bf16>(hd, q, k, v, o, seg_q, seg_k, pos_q, pos_k, tiles,
                             B, Sq, Sk, H, K, causal, window, softcap, s);
  return (int)cudaErrorInvalidValue;
}
