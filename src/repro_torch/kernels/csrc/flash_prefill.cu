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
// write of the output. Long prefills are bound by operations: qwen3's
// causal 32768-token prefill needs 8.8 TFLOP (8.9 ms at 989 TFLOP/s),
// mistral-nemo's 10240 tokens under the 8192 window 0.82 TFLOP. The
// serving path's short calls (packed prefill of 2048 tokens in ragged
// segments, 512-token chunks over a cache prefix) are bound by bytes, a
// few hundredths of a millisecond, and in practice by latency. The design:
//   * exact tile skipping in every mode. A pre-pass kernel (once a call,
//     shared by all q tiles and heads) reduces each 64-key tile to its
//     [min, max] valid position and segment (no valid key: min > max) and
//     whether all its keys are valid, and each 64-row q tile to the same
//     over its rows. A k tile (one or two of those 64-key tiles) is kept
//     for a CTA only if, against one of its 64-row q tiles, it has a valid
//     key, is not wholly above the causal diagonal (least key position >
//     greatest q position), not wholly before the window of the least q
//     position, and its segment range meets the q tile's. Each of those
//     makes every (query, key) pair of the tile masked, so skipping is
//     exact. The CTA compacts the kept k tiles into shared memory before
//     its first copy starts: a skipped tile's bytes are never loaded. Each
//     entry says, for each 64-row q tile, whether no pair of it is masked
//     (FULL: that consumer skips the mask code).
//   * bfloat16 on Hopper's hardware, warp-specialised. One CTA a (q tile,
//     q head) with one or two consumer warpgroups of 64 q rows and a
//     producer warpgroup of which one warp works, its registers lowered to
//     24 by setmaxnreg and the consumers' raised. The producer walks the
//     kept list and copies Q once and each kept K and V tile by TMA
//     (cp.async.bulk.tensor over 4-d tensor maps of the (B, S, heads, hd)
//     layout, 128-byte swizzle, boxes of 64 hd columns; TMA zero-fills
//     keys past Sk and the columns of hd 96, 112 and 160's last box) into
//     a ring of 2-4 stages; K and V of a stage have their own full and
//     empty mbarriers, so the next K is in flight while a consumer still
//     reads V. For the position and segment modes the producer also copies
//     each tile's key positions and segments. A consumer waits on K, runs
//     S = Q K^T as wgmma with both operands in shared memory (K-major, the
//     contraction stepped 16 at a time up to hd), the online softmax on
//     the accumulator fragments in registers (log2 units, the scale folded
//     into one multiply, ex2.approx; a FULL tile skips the mask code),
//     frees K, waits on V and runs O += P V as wgmma with P from registers
//     (the accumulator layout of S is the A fragment layout, so P never
//     touches shared memory) and V as an MN-major operand, then frees V.
//     Two consumers share each K/V tile and overlap each other's softmax
//     with their products.
//   * tile sizes are template parameters; `flash_prefill.plan` picks them.
//     Long calls (at least 8 waves of 128-row tiles) take two consumers,
//     128 q rows and 128 keys a tile, and 3 stages where shared memory
//     holds them; short calls one consumer, 64 rows and 64 keys, 2 stages,
//     two CTAs an SM; hd 160 two consumers and 64 keys. Registers bound
//     the rest: ptxas compiles a consumer within the registers a thread
//     has at launch (168 for 384 threads, 128 for two CTAs of 256),
//     whatever setmaxnreg raises them to at run time, so a consumer holds
//     S (BN/2 floats), O (hd/2) and P's hi and lo (BN/4 each) and no more:
//     issuing the next tile's S while P V runs (FlashAttention-3's
//     overlap) needs a second S and spilled, and ptxas serialised the
//     wgmma (warning C7512); so did one consumer at hd 160.
//   * P keeps float32 precision in P V: P is split into hi = bf16(p) and
//     lo = bf16(p - hi) and multiplied twice, so the product carries ~16
//     bits of p, as the plain version's float32 weights. Rounding p to bf16
//     alone (one product) fails the bf16 tolerance of the checks on the
//     card (scripts/kernel_variants.py), so the second product stays: the
//     kernel issues 1.5x the operations of the bound.
//   * the grid runs the heavy causal q tiles first (q tiles in reverse
//     order) and the H heads of one q tile side by side, so that the G q
//     heads of one kv head read its K/V tiles from L2 at about one time.
//   * float32 inputs stay on the CUDA cores (no TF32: float32 parity needs
//     full precision): a 4 x 4 register block of scores and a 4 x (hd/16)
//     block of the output a thread, over 64-row, 64-key tiles with the
//     same skipping rule.
// Rows with no valid key: the plain version gives such a row the uniform
// mean of V over all Sk keys (every logit is NEG_INF). Skipping cannot
// change a row that has a valid key (its key's tile is kept), so a row
// whose running max is still NEG_INF at the end saw no valid key: its
// warpgroup (or CTA) then computes the mean of V over all Sk keys of its
// kv head and writes that row from it. The serving path never has such a
// row (every chunk row sees its own key).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <limits.h>

#include "tma.cuh"
#include "wgmma.cuh"

namespace {

using namespace tma;

constexpr int BQ = 64;                  // q rows a pre-pass tile (and f32 tile)
constexpr int BK = 64;                  // keys a pre-pass tile (and f32 tile)
constexpr int NTHREADS_F32 = 256;
constexpr float NEG_INF = -1e30f;
constexpr int POS_INVALID = 1 << 30;
constexpr int MAX_SMEM = 232448;
constexpr float LOG2E = 1.4426950408889634f;
// tile-list entry: bits 0-28 the k tile; FULL_W(w): no pair of the tile
// is masked for the rows of q tile w of the CTA (a consumer warpgroup's;
// the f32 kernel has one)
constexpr int TILE_MASK = (1 << 29) - 1;
constexpr int FULL = 1 << 30;
__host__ __device__ constexpr int FULL_W(int w) { return FULL >> w; }

typedef __nv_bfloat16 bf16;

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
__device__ __forceinline__ void split_pair(float x, float y, uint32_t& hi, uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<uint32_t*>(&h);
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

// Compact the k tiles (KT pre-pass tiles each) that the masks do not wholly
// hide from every one of the NQ 64-row q tiles qt0 .. qt0 + NQ - 1 into
// list_s, ascending, flagged per q tile w with FULL_W(w) where they hide
// no pair of it from that q tile (every key valid, below every q position,
// inside every window, one segment on both sides); returns their count.
// Ends with __syncthreads.
template <int NT, int KT, int NQ>
__device__ int build_tile_list(const int4* __restrict__ qsum,
                               const int4* __restrict__ ksum,
                               const int* __restrict__ kall, int* list_s,
                               int* wcount_s, int b, int qt0, int nq, int nk,
                               int causal, int window, bool has_seg) {
  constexpr int NW = NT / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nkt = (nk + KT - 1) / KT;
  int4 qs[NQ];
  bool qv[NQ];
#pragma unroll
  for (int w = 0; w < NQ; ++w) {
    qv[w] = qt0 + w < nq;
    qs[w] = qv[w] ? qsum[(size_t)b * nq + qt0 + w] : make_int4(0, 0, 0, 0);
  }
  int total = 0;
  for (int base = 0; base < nkt; base += NT) {
    const int kt = base + tid;
    bool keep = false;
    int flags = 0;
    if (kt < nkt) {
      int4 ks = make_int4(INT_MAX, INT_MIN, INT_MAX, INT_MIN);
      bool all = kt * KT + KT <= nk;    // a 64-key tile past Sk: keys missing
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        const int t = kt * KT + j;
        if (t < nk) {
          const int4 x = ksum[(size_t)b * nk + t];
          ks = make_int4(min(ks.x, x.x), max(ks.y, x.y), min(ks.z, x.z), max(ks.w, x.w));
          all = all && kall[(size_t)b * nk + t];
        }
      }
#pragma unroll
      for (int w = 0; w < NQ; ++w) {
        const int4 q = qs[w];
        const bool kw = qv[w] && ks.x <= ks.y                // a valid key
                        && !(causal && ks.x > q.y)           // above the diagonal
                        && !(window > 0 && ks.y <= q.x - window)   // before the window
                        && !(has_seg && (ks.w < q.z || ks.z > q.w));  // other segments
        const bool fw = kw && all
                        && (!causal || ks.y <= q.x)
                        && (window <= 0 || ks.x > q.y - window)
                        && (!has_seg || (ks.z == ks.w && q.z == q.w && ks.z == q.z));
        keep = keep || kw;
        flags |= fw ? FULL_W(w) : 0;
      }
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
    if (keep) list_s[off + __popc(bal & ((1u << lane) - 1u))] = kt | flags;
    total += all;
    __syncthreads();
  }
  return total;
}

// --------------------------------------------------------------------------
// bfloat16: TMA + wgmma, warp-specialised (helpers in tma.cuh, wgmma.cuh)
// --------------------------------------------------------------------------
// NC consumer warpgroups of 64 q rows, BN keys a tile, hd HD (boxes of 64)
template <int HD, int NC, int BN>
struct WgCfg {
  static constexpr int BM = 64 * NC;
  static constexpr int NB = (HD + 63) / 64;
  static constexpr int NT = 128 * (NC + 1);           // + the producer group
  static constexpr int Q_BYTES = NB * BM * 128;
  static constexpr int KV_BYTES = NB * BN * 128;      // K or V of a stage
  static constexpr int MIN_CTAS = NC == 1 ? 2 : 1;    // CTAs an SM
  // registers a thread at launch, as __launch_bounds__ allows (168, 128)
  static constexpr int ENTRY_REGS = 65536 / (NT * MIN_CTAS) / 8 * 8;
  static constexpr int P_REGS = 24;                   // a producer thread's
  // a consumer thread's: the rest of the CTA's registers (240, 232)
  static constexpr int REGS = (ENTRY_REGS * NT - 128 * P_REGS) / (128 * NC) / 8 * 8;
  // dynamic shared memory: alignment slack, Q, the ring (K and V a stage),
  // each stage's key positions and segments (in those modes only), the
  // barriers (Q; K full, V full, K empty, V empty a stage), warp counts,
  // flags, the list
  static size_t bytes(int stages, int nkb, bool pos, bool seg) {
    return 1024 + Q_BYTES + (size_t)stages * (2 * KV_BYTES + 4 * BN * (pos + seg) + 32)
         + 8 + 4 * (16 + NC + nkb);
  }
};

template <int HD, int NC, int BN>
__global__ void __launch_bounds__(WgCfg<HD, NC, BN>::NT, WgCfg<HD, NC, BN>::MIN_CTAS)
flash_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v,
                  const bf16* __restrict__ v, bf16* __restrict__ o,
                  const int* __restrict__ seg_q, const int* __restrict__ seg_k,
                  const int* __restrict__ pos_q, const int* __restrict__ pos_k,
                  const int4* __restrict__ qsum, const int4* __restrict__ ksum,
                  const int* __restrict__ kall, int Sq, int Sk, int H, int K,
                  float scale, int causal, int window, float softcap, int stages) {
  using C = WgCfg<HD, NC, BN>;
  constexpr int BM = C::BM, NB = C::NB;
  const bool has_pos = pos_q != nullptr;
  const bool has_seg = seg_q != nullptr;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* Qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* KVs = Qs + C::Q_BYTES;                      // [stages][K | V]
  int* kpos_s = reinterpret_cast<int*>(KVs + (size_t)stages * 2 * C::KV_BYTES);
  int* kseg_s = kpos_s + (has_pos ? stages * BN : 0);        // [stages][BN] each
  uint64_t* bars = reinterpret_cast<uint64_t*>(kseg_s + (has_seg ? stages * BN : 0));
  int* wcount_s = reinterpret_cast<int*>(bars + 1 + 4 * stages);  // [16]
  int* flag_s = wcount_s + 16;                               // [NC]
  int* list_s = flag_s + NC;                                 // [nkb]

  const int tid = threadIdx.x;
  const int h = blockIdx.x, qt = gridDim.y - 1 - blockIdx.y, b = blockIdx.z;
  const int nq = (Sq + BQ - 1) / BQ, nk = (Sk + BK - 1) / BK;
  const int G = H / K, kh = h / G;
  const int q0 = qt * BM;
  const uint32_t bar_q = smem_u32(bars);
  // + 8 * stage: K and V arrived; K and V read by every consumer warp
  const uint32_t k_full = bar_q + 8, v_full = k_full + 8 * stages,
                 k_empty = v_full + 8 * stages, v_empty = k_empty + 8 * stages;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < stages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, 4 * NC);
      mbar_init(v_empty + 8 * s, 4 * NC);
    }
    mbar_init_fence();
  }
  if (tid < NC) flag_s[tid] = 0;
  __syncthreads();
  const int n_act = build_tile_list<C::NT, BN / BK, NC>(
      qsum, ksum, kall, list_s, wcount_s, b, qt * NC, nq, nk, causal, window, has_seg);

  // the warpgroup, warp-uniform to the compiler (lane 0's, by a shuffle):
  // no warp diverges across the role branch or its setmaxnreg
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  if (wg == NC) {
    // ---- producer: one warp issues every copy ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(C::P_REGS) : "memory");
    const int lane = tid & 31;
    if ((tid & 127) < 32 && n_act > 0) {
      if (lane == 0) {
        mbar_expect_tx(bar_q, C::Q_BYTES);
#pragma unroll
        for (int bx = 0; bx < NB; ++bx)
          tma_load(smem_u32(Qs + bx * BM * 128), &tm_q, bar_q, bx * 64, h, q0, b);
      }
      for (int it = 0; it < n_act; ++it) {
        const int s = it % stages;
        const int k0 = (list_s[it] & TILE_MASK) * BN;
        const int free = ((it / stages) & 1) ^ 1;
        mbar_wait(k_empty + 8 * s, free);
        if (has_pos || has_seg) {
          for (int j = lane; j < BN; j += 32) {
            const int gj = k0 + j;
            const bool ok = gj < Sk;
            if (has_pos) kpos_s[s * BN + j] = ok ? pos_k[(size_t)b * Sk + gj] : POS_INVALID;
            if (has_seg) kseg_s[s * BN + j] = ok ? seg_k[(size_t)b * Sk + gj] : 0;
          }
          __syncwarp();                 // the lanes' stores before lane 0's arrive
        }
        if (lane == 0) {
          const uint32_t kb = smem_u32(KVs + (size_t)s * 2 * C::KV_BYTES);
          mbar_expect_tx(k_full + 8 * s, C::KV_BYTES);
#pragma unroll
          for (int bx = 0; bx < NB; ++bx)
            tma_load(kb + bx * BN * 128, &tm_k, k_full + 8 * s, bx * 64, kh, k0, b);
        }
        mbar_wait(v_empty + 8 * s, free);
        if (lane == 0) {
          const uint32_t kb = smem_u32(KVs + (size_t)s * 2 * C::KV_BYTES);
          mbar_expect_tx(v_full + 8 * s, C::KV_BYTES);
#pragma unroll
          for (int bx = 0; bx < NB; ++bx)
            tma_load(kb + C::KV_BYTES + bx * BN * 128, &tm_v, v_full + 8 * s, bx * 64, kh,
                     k0, b);
        }
        __syncwarp();
      }
    }
  } else {
    // ---- consumer warpgroup wg: q rows wg*64 .. wg*64+63 of the tile ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::REGS) : "memory");
    const int t = tid & 127, warp = t >> 5, lane = t & 31;
    const int c2 = 2 * (lane & 3);
    // this thread's two rows: r0 and r0 + 8 of its warp's 16
    const int r0 = q0 + wg * 64 + warp * 16 + (lane >> 2);
    int qp[2], qg[2];
    bool rv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int gi = r0 + 8 * i;
      rv[i] = gi < Sq;
      qp[i] = has_pos ? (rv[i] ? pos_q[(size_t)b * Sq + gi] : 0) : gi;
      qg[i] = has_seg ? (rv[i] ? seg_q[(size_t)b * Sq + gi] : 0) : 0;
    }
    const float sl = scale * LOG2E;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    float acc[HD / 2], sc[BN / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) sc[i] = 0.f;
    const uint32_t q_base = smem_u32(Qs) + wg * 64 * 128;

    if (n_act > 0) mbar_wait(bar_q, 0);
    for (int it = 0; it < n_act; ++it) {
      const int s = it % stages, parity = (it / stages) & 1;
      const int e = list_s[it];
      const int k0 = (e & TILE_MASK) * BN;
      const uint32_t k_base = smem_u32(KVs + (size_t)s * 2 * C::KV_BYTES);
      const uint32_t v_base = k_base + C::KV_BYTES;

      // ---- S = Q K^T: both operands K-major in shared memory ----
      mbar_wait(k_full + 8 * s, parity);
      wgmma::fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma::SS<BN>::mma(sc, sw128_desc(q_base + (kk >> 2) * BM * 128 + (kk & 3) * 32, 0),
                           sw128_desc(k_base + (kk >> 2) * BN * 128 + (kk & 3) * 32, 0),
                           kk > 0);
      wgmma::commit();
      wgmma::wait();
      wgmma::hold(sc);

      // ---- scores in log2 units, masks (none on a FULL tile), online
      //      softmax on the fragments: sc[4j + e] is row r0 + 8 (e >> 1),
      //      column 8 j + c2 + (e & 1) ----
      if (softcap > 0.f) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) sc[i] = softcap * tanhf(sc[i] * scale / softcap) * LOG2E;
      } else {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) sc[i] *= sl;
      }
      if (!(e & FULL_W(wg))) {
        const int* kp = kpos_s + s * BN;
        const int* kg = kseg_s + s * BN;
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
          const int c = 8 * (i >> 2) + c2 + (i & 1);
          const int r = (i >> 1) & 1;
          const int kj = k0 + c;
          const int jp = has_pos ? kp[c] : kj;
          bool ok = kj < Sk && jp < POS_INVALID;
          if (causal) ok = ok && jp <= qp[r];
          if (window > 0) ok = ok && jp > qp[r] - window;
          if (has_seg) ok = ok && kg[c] == qg[r];
          if (!ok) sc[i] = -INFINITY;
        }
      }
      if (lane == 0) mbar_arrive(k_empty + 8 * s);   // this warp's K reads done
      float mx[2] = {-INFINITY, -INFINITY}, alpha[2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);   // finite: m >= NEG_INF
        alpha[r] = fast_exp2(m[r] - m_new);
        m[r] = m_new;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int r = (i >> 1) & 1;
        sc[i] = fast_exp2(sc[i] - m[r]);
        l[r] += sc[i];
      }
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

      // ---- O += P V: P from registers as bf16 hi + lo, V MN-major ----
      uint32_t ph[BN / 4], pl[BN / 4];
#pragma unroll
      for (int i = 0; i < BN / 4; ++i) split_pair(sc[2 * i], sc[2 * i + 1], ph[i], pl[i]);
      mbar_wait(v_full + 8 * s, parity);
      wgmma::fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        const uint64_t dv = sw128_desc(v_base + kk * 16 * 128, BN * 128);
        const uint32_t ah[4] = {ph[4 * kk], ph[4 * kk + 1], ph[4 * kk + 2], ph[4 * kk + 3]};
        const uint32_t al[4] = {pl[4 * kk], pl[4 * kk + 1], pl[4 * kk + 2], pl[4 * kk + 3]};
        wgmma::RS<HD>::mma(acc, ah, dv, 1);
        wgmma::RS<HD>::mma(acc, al, dv, 1);
      }
      wgmma::commit();
      wgmma::wait();
      wgmma::hold(acc);
      wgmma::hold(ph);
      wgmma::hold(pl);
      if (lane == 0) mbar_arrive(v_empty + 8 * s);   // this warp's V reads done
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    bool rescue[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) rescue[r] = rv[r] && m[r] <= NEG_INF;
    if (rescue[0] || rescue[1]) flag_s[wg] = 1;
    named_sync(1 + wg, 128);
    float* vmean = reinterpret_cast<float*>(Qs + wg * 64 * 128);  // [HD], rare path
    if (flag_s[wg]) {
      for (int d = t; d < HD; d += 128) {
        float a = 0.f;
        for (int j = 0; j < Sk; ++j) a += __bfloat162float(v[(((size_t)b * Sk + j) * K + kh) * HD + d]);
        vmean[d] = a / (float)Sk;
      }
      named_sync(1 + wg, 128);
    }

    // ---- write O ----
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (!rv[r]) continue;
      const float inv = 1.f / fmaxf(l[r], 1e-30f);
      bf16* out = o + (((size_t)b * Sq + r0 + 8 * r) * H + h) * HD;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        const int c = 8 * j + c2;
        const float x = rescue[r] ? vmean[c] : acc[4 * j + 2 * r] * inv;
        const float y = rescue[r] ? vmean[c + 1] : acc[4 * j + 2 * r + 1] * inv;
        *reinterpret_cast<unsigned*>(out + c) = pack_bf16(x, y);
      }
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
  const int n_act = build_tile_list<NTHREADS_F32, 1, 1>(qsum, ksum, kall, list_s,
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

struct Args {
  const void *q, *k, *v;
  void* o;
  const int *sq, *sk, *pq, *pk;
  const int4 *qsum, *ksum;
  const int* kall;
  int B, Sq, Sk, H, K, causal, window;
  float softcap;
  int stages;
  cudaStream_t stream;
};

template <int HD, int NC, int BN>
int launch_bf16(const Args& a) {
  using C = WgCfg<HD, NC, BN>;
  if (a.stages < 2 || a.stages > 8) return (int)cudaErrorInvalidValue;
  const size_t smem = C::bytes(a.stages, (a.Sk + BN - 1) / BN, a.pq != nullptr,
                               a.sq != nullptr);
  auto kern = flash_bf16_kernel<HD, NC, BN>;
  static size_t smem_set = 0;
  if (int e = set_smem(kern, smem, smem_set)) return e;
  CUtensorMap tq, tk, tv;
  if (int e = tensor_map(&tq, a.q, HD, a.H, a.Sq, a.B, C::BM)) return e;
  if (int e = tensor_map(&tk, a.k, HD, a.K, a.Sk, a.B, BN)) return e;
  if (int e = tensor_map(&tv, a.v, HD, a.K, a.Sk, a.B, BN)) return e;
  const float scale = 1.f / sqrtf((float)HD);
  const dim3 grid(a.H, (a.Sq + C::BM - 1) / C::BM, a.B);
  kern<<<grid, C::NT, smem, a.stream>>>(
      tq, tk, tv, static_cast<const bf16*>(a.v), static_cast<bf16*>(a.o), a.sq, a.sk, a.pq,
      a.pk, a.qsum, a.ksum, a.kall, a.Sq, a.Sk, a.H, a.K, scale, a.causal, a.window,
      a.softcap, a.stages);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_f32(const Args& a) {
  auto kern = flash_f32_kernel<HD>;
  static size_t smem_set = 0;
  const size_t smem = f32_smem_bytes<HD>() + sizeof(int) * ((a.Sk + BK - 1) / BK);
  if (int e = set_smem(kern, smem, smem_set)) return e;
  const float scale = 1.f / sqrtf((float)HD);
  kern<<<dim3((a.Sq + BQ - 1) / BQ, a.H, a.B), NTHREADS_F32, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.sq, a.sk, a.pq, a.pk,
      a.qsum, a.ksum, a.kall, a.Sq, a.Sk, a.H, a.K, scale, a.causal, a.window, a.softcap);
  return (int)cudaGetLastError();
}

// bf16 (the pairs `flash_prefill.plan` gives): 128 q rows (two consumers)
// and 128 keys a tile, or 64 q rows (one consumer) and 64 keys; at hd 160
// 128 q rows and 64 keys only
template <int HD>
int launch(const Args& a, int dtype, int block_q, int block_k) {
  if (dtype == 0) return launch_f32<HD>(a);
  if constexpr (HD <= 128) {
    if (block_q == 128 && block_k == 128) return launch_bf16<HD, 2, 128>(a);
    if (block_q == 64 && block_k == 64) return launch_bf16<HD, 1, 64>(a);
  } else {
    if (block_q == 128 && block_k == 64) return launch_bf16<HD, 2, 64>(a);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. seg_q/seg_k and pos_q/pos_k may be null
// (in pairs). tiles: int32 scratch of B * (4 * ceil(Sq/64) + 5 * ceil(Sk/64))
// values for the pre-pass. window <= 0 and softcap <= 0 mean "none".
// block_q (64 or 128 q rows a CTA), block_k (64 or 128 keys a tile) and
// stages (2-8 K/V stages) are the bf16 kernel's launch plan
// (`flash_prefill.plan`); float32 ignores them.
// Launches the pre-pass and the attention kernel on `stream`; returns the
// CUDA error code (0 on success), or 1001 when the driver has no
// cuTensorMapEncodeTiled, 1002 when it refuses a tensor map.
extern "C" int flash_prefill(const void* q, const void* k, const void* v,
                             void* o, const void* seg_q, const void* seg_k,
                             const void* pos_q, const void* pos_k, void* tiles,
                             int B, int Sq, int Sk, int H, int K, int hd,
                             int dtype, int causal, int window, float softcap,
                             void* stream, int block_q, int block_k, int stages) {
  if (K <= 0 || H % K != 0 || B <= 0 || Sq <= 0 || Sk <= 0 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (hd != 32 && hd != 64 && hd != 96 && hd != 112 && hd != 128 && hd != 160)
    return (int)cudaErrorInvalidValue;
  const int nq = (Sq + BQ - 1) / BQ, nk = (Sk + BK - 1) / BK;
  Args a;
  a.q = q; a.k = k; a.v = v; a.o = o;
  a.sq = static_cast<const int*>(seg_q);
  a.sk = static_cast<const int*>(seg_k);
  a.pq = static_cast<const int*>(pos_q);
  a.pk = static_cast<const int*>(pos_k);
  a.qsum = static_cast<int4*>(tiles);
  a.ksum = a.qsum + (size_t)B * nq;
  a.kall = reinterpret_cast<const int*>(a.ksum + (size_t)B * nk);
  a.B = B; a.Sq = Sq; a.Sk = Sk; a.H = H; a.K = K;
  a.causal = causal; a.window = window; a.softcap = softcap;
  a.stages = stages;
  a.stream = static_cast<cudaStream_t>(stream);
  flash_tile_summary_kernel<<<dim3(nq > nk ? nq : nk, B), 64, 0, a.stream>>>(
      a.sq, a.sk, a.pq, a.pk, const_cast<int4*>(a.qsum), const_cast<int4*>(a.ksum),
      const_cast<int*>(a.kall), Sq, Sk, nq, nk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  switch (hd) {
    case 32: return launch<32>(a, dtype, block_q, block_k);
    case 64: return launch<64>(a, dtype, block_q, block_k);
    case 96: return launch<96>(a, dtype, block_q, block_k);
    case 112: return launch<112>(a, dtype, block_q, block_k);
    case 128: return launch<128>(a, dtype, block_q, block_k);
    case 160: return launch<160>(a, dtype, block_q, block_k);
    default: return (int)cudaErrorInvalidValue;
  }
}
