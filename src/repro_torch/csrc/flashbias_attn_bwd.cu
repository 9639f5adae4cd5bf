// Flash-attention backward with an additive FlashBias bias, for Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package has no backward kernel: its
// custom VJP recomputes the attention through XLA, which the TPU fuses. The
// port's counterpart of that recompute (ops._recompute_grads: float32
// scores rebuilt in 2 GiB query blocks and differentiated by autograd) ran
// at 0.39% of its bound at the PDE solver's training shape, 96% of the
// training step, so this kernel takes its place for bf16 inputs.
//
// Function: the gradients of  o = softmax(s) v,  s = q.k^T * scale + bias
// (bias phi_q.phi_k^T, ALiBi slope * (k_pos - q_pos), or none; masks none /
// causal / local(window) and kv_len), given the forward's row log-sum-exp
// (lse, natural log, written by kernel 1):
//   P  = exp(s - lse),  dP = dO.v^T,  Delta = rowsum(P * dP),  dS = P * (dP - Delta),
//   dv = P^T.dO,  dk = scale * dS^T.q,  dq = scale * dS.k,
//   dphi_k = dS^T.phi_q,  dphi_q = dS.phi_k.
// GQA: dk and dv sum the heads of each kv head's group inside the block, in
// head order.
//
// Delta is rowsum(P * dP) of this kernel's own P and dP (the delta pass),
// not rowsum(dO * o) of the bf16 output: the two agree only to the output's
// rounding (2^-9), and sum_k dS = Delta_exact - Delta then leaves the
// gradient of a shift shared by every key's factor (which the softmax
// ignores: the Pairformer's phi_k bias) at ~1e-6 of the largest leaf,
// where float32 gives ~1e-10. The delta pass costs a third recompute of s
// and P, without the gradients' products.
//
// Determinism (the same inputs give the same bits): three passes, each
// result accumulated in registers by the one block that owns its rows, in
// a fixed tile order; no atomics.
//  - delta (DL): a block owns 128 queries of one head and streams the key
//    tiles: Delta;
//  - key-major (KM): a block owns 128 keys of one kv head and streams every
//    query tile of each head of the group: dk, dv, dphi_k;
//  - query-major (QM): as DL: dq, dphi_q.
// Each recomputes s and P (the exponential three times, ~3 x 2.1 ms at the
// PDE shape) where one pass with per-segment partial dq would write ~0.9 GB
// and add a reduction.
//
// What bounds it on the H100. At the PDE training shape (B 1, H 8, N = M =
// 32186, D 16, R 9 padded to 16, no mask) the 8.3e9 logits of a pass each
// take one ex2 (the SFU's 16 a clock per SM: 2.1 ms a pass), a few float32
// operations and, on the tensor cores, 40 (DL) / 56 (KM) / 72 (QM)
// m16n8k16 products per 16 x 64 tile and warp, while the bytes are ~0.1 GB.
// The roofline bound of the two gradients' products (twice the forward's
// FLOPs) is 1.374 ms a call; the exponentials alone are 3 x 2.1 ms. Issue
// slots bound it: a first version's loop held ~1570 instructions a tile
// (SASS; generic copy loops with 64-bit address arithmetic, and a branch per
// element for the ALiBi and the mask) against 40 HMMA and 32 MUFU, at 31.5
// ms a call; with each thread's copy slots fixed per head and the ALiBi and
// the mask behind one branch a tile, 21.0 ms (delta 4.9, KM 7.7, QM 8.3).
// Neither the exponentials (1.1 ms less without them) nor two thirds of the
// bias products (0.6 ms a pass less) nor the ring's depth set the pace.
//
// Design. 8 warps a block, each owning 16 of the block's 128 rows (the
// m16 rows of mma.sync.m16n8k16, bf16 operands, float32 accumulators). The
// block's own rows (q, dO, phi_q or k, v, phi_k) sit in shared memory for
// the whole pass; the other side streams through a ring of cp.async loads
// (ring_stages), the next tiles' loads in flight during the current one's
// math, one block barrier a tile. Rows are padded by 8 bf16 so that every
// ldmatrix of 8 rows hits 8 distinct bank groups. Widths D, Dv and R are
// zero-padded (by the wrapper) to one P in {16, 32, 64, 96, 128}; the
// streamed tile is 64 rows for P <= 32, 32 for 64, 16 above, so that the
// accumulators stay in registers. P, and P's register use, is the shape
// limit: P <= 96 with factors, <= 128 without (the wrapper sends wider
// shapes to the plain recompute).
//
// Precision: as the forward. Products on bf16 operands with float32
// accumulators; P and dS rounded to bf16 only as mma operands (A from the
// accumulator registers, as the forward's P.V). The float32 factors enter as
// bf16 hi + lo (split by the wrapper) with hi.hi + hi.lo + lo.hi, where s is
// recomputed and in dphi = dS.phi, where dS is split into hi + lo too: the
// squared-distance factors of the PDE solver cancel, and a single bf16 pass
// would lose their float32 accuracy. exp is ex2.approx on s * log2(e) - lse
// * log2(e), as the forward's.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

#include "flashbias_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kWarps * 16;   // a block's own rows

// rows of a streamed tile at width P
constexpr int stream_rows(int P) { return P <= 32 ? 64 : P <= 64 ? 32 : 16; }
// stages of the ring of streamed tiles (measured, PDE shape: 2 stages 21.0
// ms a call, 4 stages 21.6; the Pairformer and Swin shapes 2-4% faster
// with 4)
constexpr int ring_stages(int P) { return P <= 16 ? 2 : 4; }

struct BwdArgs {
  const bf16* q;       // (B, H, N, P)
  const bf16* k;       // (B, KVH, M, P)
  const bf16* v;       // (B, KVH, M, P)
  const bf16* dout;    // (B, H, N, P)
  const bf16* pq_hi;   // (B, H, N, P) or null (no factors)
  const bf16* pq_lo;
  const bf16* pk_hi;   // (B, H, M, P) or null
  const bf16* pk_lo;
  const float* lse2;   // (B, H, Np) lse * log2(e), +inf past N
  float* delta;        // (B, H, Np) rowsum(P * dP): the delta pass writes
                       // the rows < N (0 past N), the others read it
  const float* slopes; // (H,) or null
  bf16* dq;            // (B, H, N, P) or null: no query-major pass
  bf16* dk;            // (B, KVH, M, P) or null: no key-major pass (dv too)
  bf16* dv;            // (B, KVH, M, P)
  float* dpq;          // (B, H, N, P) or null
  float* dpk;          // (B, H, M, P) or null
  int B, H, KVH, N, M, Np;
  float scale;
  int mask_kind, window, kv_len;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes where !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// volatile (kept in order with the cp.async waits and barriers), without a
// memory clobber, so that the scalar shared-memory loads schedule around it
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += A.B, A 16 x 16 (row), B 16 x 8 (col), bf16 in, float32 out
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment: rows row0..+15, columns col0..+15 of a row-major tile
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* s, int ld, int row0,
                                       int col0, int lane) {
  ldsm_x4(a, s + (row0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + col0 + (lane >> 4) * 8);
}

// B fragments of two n8 tiles from a tile stored n-major (row n, column k):
// rows n0..+15, columns k0..+15; {b[0], b[1]} the first tile, {b[2], b[3]}
// the second
__device__ __forceinline__ void frag_b(uint32_t (&b)[4], const bf16* s, int ld, int n0, int k0,
                                       int lane) {
  const int j = lane >> 3;
  ldsm_x4(b, s + (n0 + (lane & 7) + (j >> 1) * 8) * ld + k0 + (j & 1) * 8);
}

// The same from a tile stored k-major (row k, column n): rows k0..+15,
// columns n0..+15, transposed by ldmatrix
__device__ __forceinline__ void frag_bt(uint32_t (&b)[4], const bf16* s, int ld, int k0, int n0,
                                        int lane) {
  const int j = lane >> 3;
  ldsm_x4_t(b, s + (k0 + (lane & 7) + (j & 1) * 8) * ld + n0 + (j >> 1) * 8);
}

// rows [r0, r0 + ROWS) of a (rows, P) bf16 plane into a padded tile; rows
// at or past `limit` are zero-filled
template <int ROWS, int P>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* plane, int r0, int limit,
                                          int tid) {
  constexpr int CH = P / 8;   // 16-byte chunks a row
  for (int i = tid; i < ROWS * CH; i += kThreads) {
    const int r = i / CH, c = (i - r * CH) * 8;
    const bool ok = r0 + r < limit;
    cp_async16(dst + r * (P + 8) + c, plane + (size_t)(ok ? r0 + r : 0) * P + c, ok);
  }
}

// the passes
constexpr int kKeyMajor = 0, kQueryMajor = 1, kDelta = 2;

template <int P, bool PHI, bool KM>
struct Geom {
  static constexpr int BS = stream_rows(P);   // streamed rows a tile
  static constexpr int S = ring_stages(P);
  static constexpr int LD = P + 8;            // padded row, bf16 elements
  static constexpr int NOPS = PHI ? 4 : 2;    // tiles a side: 2 + factor hi, lo
  static constexpr int STAT = NOPS * kRows * LD;     // bf16 elements
  static constexpr int STAGE = NOPS * BS * LD;       // bf16 elements
  // KM streams each query tile's lse2 and delta (2 x BS floats a stage)
  static constexpr size_t BYTES =
      (size_t)(STAT + S * STAGE) * 2 + (KM ? S * 2 * BS * 4 : 0);
};

// One pass. KM: blockIdx = (128-key block, kv head, batch); the block's own
// rows are k, v and (per head) phi_k; it streams q, dO, phi_q, lse2 and
// delta of each head of the group. QM and DL: blockIdx = (128-query block,
// head, batch); own rows q, dO, phi_q, lse2 (QM: delta); streams k, v,
// phi_k.
// Element i of a warp's accumulator tile nt is own row 16*warp + g + 8*(i>>1)
// and streamed column 8*nt + 2*tig + (i&1) (g = lane/4, tig = lane%4).
// At P 16 two blocks share an SM (128 registers a thread, no spill): 16
// warps hide the mma and exponential latencies better than 8 (measured, the
// PDE shape: 22.3 against 26.1 ms a call). Wider tiles keep their registers.
template <int P, bool PHI, int PASS>
__global__ void __launch_bounds__(kThreads, P <= 16 ? 2 : 1) attn_bwd(const BwdArgs a) {
  constexpr bool KM = PASS == kKeyMajor, DL = PASS == kDelta;
  using Gm = Geom<P, PHI, KM>;
  constexpr int BS = Gm::BS, LD = Gm::LD, NOPS = Gm::NOPS, kStages = Gm::S;
  constexpr int NT = BS / 8;    // n8 tiles of a streamed tile
  constexpr int PT = P / 8;     // n8 tiles of an output row
  constexpr int KS = P / 16;    // k-steps over the width
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* own = reinterpret_cast<bf16*>(smem_raw);   // NOPS x kRows x LD
  bf16* ring = own + Gm::STAT;                     // S stages x NOPS x BS x LD
  float* ring_f = reinterpret_cast<float*>(ring + kStages * Gm::STAGE);  // KM: lse2, delta

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int b = blockIdx.z;
  const int G = a.H / a.KVH;
  const int r0 = blockIdx.x * kRows;
  const int wr = warp * 16;                        // the warp's first own row
  const float sc = a.scale;

  // own row ranges and the streamed side's extent
  const int own_n = KM ? a.M : a.N;
  const int str_n = KM ? a.N : a.M;

  bf16* own1 = own;                       // KM: k   QM: q
  bf16* own2 = own + kRows * LD;          // KM: v   QM: dO
  bf16* own3h = own + 2 * kRows * LD;     // factor hi / lo (PHI)
  bf16* own3l = own + 3 * kRows * LD;

  float acc1[PT][4];   // KM: dk   QM: dq
  float accv[KM ? PT : 1][4];   // KM: dv
  float accp[PHI ? PT : 1][4];  // dphi_k / dphi_q
#pragma unroll
  for (int j = 0; j < PT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc1[j][i] = 0.f;
#pragma unroll
  for (int j = 0; j < (KM ? PT : 1); ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) accv[j][i] = 0.f;

  const bool need_p = KM ? a.dpk != nullptr : a.dpq != nullptr;
  // own rows' lse2 and delta (QM), the two rows g and g + 8 of the warp
  float lse_r[2] = {0.f, 0.f}, del_r[2] = {0.f, 0.f};

  const int kvh = KM ? blockIdx.y : blockIdx.y / G;
  const int heads = KM ? G : 1;
  const size_t plane_kv = (size_t)b * a.KVH + kvh;
  if (KM) {
    load_rows<kRows, P>(own1, a.k + plane_kv * a.M * P, r0, a.M, tid);
    load_rows<kRows, P>(own2, a.v + plane_kv * a.M * P, r0, a.M, tid);
  }

  for (int hg = 0; hg < heads; ++hg) {
    const int h = KM ? kvh * G + hg : blockIdx.y;
    const size_t plane = (size_t)b * a.H + h;
    const float slope = a.slopes ? a.slopes[h] : 0.f;
    if (hg > 0) __syncthreads();   // the previous head's tiles are consumed
    if (KM) {
      if (PHI) {
        load_rows<kRows, P>(own3h, a.pk_hi + plane * a.M * P, r0, a.M, tid);
        load_rows<kRows, P>(own3l, a.pk_lo + plane * a.M * P, r0, a.M, tid);
      }
    } else {
      load_rows<kRows, P>(own1, a.q + plane * a.N * P, r0, a.N, tid);
      load_rows<kRows, P>(own2, a.dout + plane * a.N * P, r0, a.N, tid);
      if (PHI) {
        load_rows<kRows, P>(own3h, a.pq_hi + plane * a.N * P, r0, a.N, tid);
        load_rows<kRows, P>(own3l, a.pq_lo + plane * a.N * P, r0, a.N, tid);
      }
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int row = r0 + wr + g + 8 * hi;   // < Np: Np is a multiple of 128
        lse_r[hi] = a.lse2[plane * a.Np + row];
        if (!DL) del_r[hi] = a.delta[plane * a.Np + row];
      }
    }
#pragma unroll
    for (int j = 0; j < (PHI ? PT : 1); ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) accp[j][i] = 0.f;

    // the streamed tiles this block's rows can meet
    int lo = 0, hi_end = str_n;
    const int own_last = min(own_n, r0 + kRows) - 1;
    if (KM) {
      // queries that see keys [r0, own_last]
      if (r0 >= a.kv_len) hi_end = 0;
      if (a.mask_kind != 0) lo = r0;
      if (a.mask_kind == 2) hi_end = min(hi_end, own_last + a.window);
    } else {
      hi_end = min(a.kv_len, a.M);
      if (a.mask_kind != 0) hi_end = min(hi_end, own_last + 1);
      if (a.mask_kind == 2) lo = max(0, r0 - (a.window - 1));
    }
    lo = (lo / BS) * BS;
    const int n_tiles = hi_end > lo ? (hi_end - lo + BS - 1) / BS : 0;

    // The streamed tiles' 16-byte copies: a thread's slots (operand, row,
    // column) fixed for the head, so that a tile's issue is an address and
    // a bound check a slot. KM also copies lse2 and delta (4 floats a copy).
    constexpr int CH = P / 8, TILE_CH = BS * CH, NCH = NOPS * TILE_CH;
    constexpr int SLOTS = (NCH + kThreads - 1) / kThreads;
    const size_t str_plane = (KM ? plane * a.N : (size_t)plane_kv * a.M) * P;
    const size_t fac_plane = plane * (KM ? a.N : a.M) * P;
    const bf16* base1 = (KM ? a.q : a.k) + str_plane;
    const bf16* base2 = (KM ? a.dout : a.v) + str_plane;
    const bf16* base3h = PHI ? (KM ? a.pq_hi : a.pk_hi) + fac_plane : base1;
    const bf16* base3l = PHI ? (KM ? a.pq_lo : a.pk_lo) + fac_plane : base1;
    const bf16* slot_src[SLOTS];
    int slot_dst[SLOTS], slot_row[SLOTS];
#pragma unroll
    for (int sl = 0; sl < SLOTS; ++sl) {
      const int i = min(tid + sl * kThreads, NCH - 1);
      const int op = i / TILE_CH, rem = i - op * TILE_CH, r = rem / CH;
      const int c = (rem - r * CH) * 8;
      const bf16* b0 = op == 0 ? base1 : op == 1 ? base2 : op == 2 ? base3h : base3l;
      slot_src[sl] = b0 + r * P + c;
      slot_dst[sl] = op * BS * LD + r * LD + c;
      slot_row[sl] = tid + sl * kThreads < NCH ? r : str_n;   // str_n: no copy
    }
    const float* f_src = tid < BS / 4 ? a.lse2 + plane * a.Np + 4 * tid
                                      : a.delta + plane * a.Np + 4 * (tid - BS / 4);
    auto issue = [&](int t) {   // tile t's loads, or an empty group past the end
      if (t < n_tiles) {
        bf16* st = ring + (t % kStages) * Gm::STAGE;
        const int c0 = lo + t * BS;
#pragma unroll
        for (int sl = 0; sl < SLOTS; ++sl) {
          if (slot_row[sl] < str_n) {
            const bool ok = c0 + slot_row[sl] < str_n;
            cp_async16(st + slot_dst[sl], slot_src[sl] + (ok ? (size_t)c0 * P : 0), ok);
          }
        }
        if (KM && tid < BS / 2)
          cp_async16(ring_f + (t % kStages) * 2 * BS + 4 * tid, f_src + c0, true);
      }
      cp_async_commit();
    };

    // kStages - 1 tiles in flight: tile t's group (the first one with the
    // own rows') is complete once at most kStages - 2 newer ones are not
    for (int t = 0; t < kStages - 1; ++t) issue(t);
    for (int t = 0; t < n_tiles; ++t) {
      cp_async_wait<kStages - 2>();
      __syncthreads();   // tile t is in; tile t - 1's stage is consumed
      issue(t + kStages - 1);
      const bf16* st = ring + (t % kStages) * Gm::STAGE;
      const bf16* str1 = st;                 // KM: q    QM: k
      const bf16* str2 = st + BS * LD;       // KM: dO   QM: v
      const bf16* str3h = st + 2 * BS * LD;  // factor hi / lo of the streamed side
      const bf16* str3l = st + 3 * BS * LD;
      const int c0 = lo + t * BS;
      // the streamed columns' lse2 and delta (KM), 2 a tile of the thread
      float lse_c[KM ? NT : 1][2], del_c[KM ? NT : 1][2];
      if constexpr (KM) {
        const float* s_lse = ring_f + (t % kStages) * 2 * BS;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const float2 l2 = *reinterpret_cast<const float2*>(s_lse + 8 * j + 2 * tig);
          const float2 d2 = *reinterpret_cast<const float2*>(s_lse + BS + 8 * j + 2 * tig);
          lse_c[j][0] = l2.x, lse_c[j][1] = l2.y, del_c[j][0] = d2.x, del_c[j][1] = d2.y;
        }
      }

      // s = own1 . str1^T * scale (+ own3 . str3^T)
      float s[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t af[4];
        frag_a(af, own1, LD, wr, ks * 16, lane);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t bf[4];
          frag_b(bf, str1, LD, np * 16, ks * 16, lane);
          mma(s[2 * np], af, bf[0], bf[1]);
          mma(s[2 * np + 1], af, bf[2], bf[3]);
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[j][i] *= sc;
      if constexpr (PHI) {
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          uint32_t ah[4], al[4];
          frag_a(ah, own3h, LD, wr, ks * 16, lane);
          frag_a(al, own3l, LD, wr, ks * 16, lane);
#pragma unroll
          for (int np = 0; np < NT / 2; ++np) {
            uint32_t bh[4], bl[4];
            frag_b(bh, str3h, LD, np * 16, ks * 16, lane);
            frag_b(bl, str3l, LD, np * 16, ks * 16, lane);
#pragma unroll
            for (int x = 0; x < 2; ++x) {
              mma(s[2 * np + x], ah, bh[2 * x], bh[2 * x + 1]);
              mma(s[2 * np + x], ah, bl[2 * x], bl[2 * x + 1]);
              mma(s[2 * np + x], al, bh[2 * x], bh[2 * x + 1]);
            }
          }
        }
      }

      // P = exp(s - lse); ALiBi, and the mask on edge tiles, in passes of
      // their own ahead of the exponentials, each behind a branch taken
      // once a tile
      const int c_last = c0 + BS - 1;
      bool edge;
      if (KM)   // keys [r0, r0 + 127] against queries [c0, c_last]
        edge = r0 + kRows > a.kv_len || (a.mask_kind != 0 && r0 + kRows - 1 > c0) ||
               (a.mask_kind == 2 && c_last - r0 >= a.window);
      else      // queries [r0, r0 + 127] against keys [c0, c_last]
        edge = c0 + BS > a.kv_len || (a.mask_kind != 0 && c_last > r0) ||
               (a.mask_kind == 2 && r0 + kRows - 1 - c0 >= a.window);
      // element (j, i): own row r0 + wr + g + 8 * (i >> 1), streamed column
      // c0 + 8 * j + 2 * tig + (i & 1)
      const int row_g = r0 + wr + g, col_t = c0 + 2 * tig;
      if (a.slopes) {   // slope * (k_pos - q_pos), the distance's varying part exact
        const float base = slope * (float)(KM ? row_g - col_t : col_t - row_g);
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int d = 8 * (i >> 1) - 8 * j - (i & 1);   // KM: row - col offset
            s[j][i] += fmaf(slope, (float)(KM ? d : -d), base);
          }
      }
      if (edge) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int row = row_g + 8 * (i >> 1), col = col_t + 8 * j + (i & 1);
            if (!fb::mask_ok(KM ? col : row, KM ? row : col, a.kv_len, a.mask_kind, a.window))
              s[j][i] = -CUDART_INF_F;
          }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float l2 = KM ? lse_c[KM ? j : 0][i & 1] : lse_r[i >> 1];
          s[j][i] = fb::ex2(fmaf(s[j][i], fb::kLog2e, -l2));
        }

      // dP = own2 . str2^T
      float dp[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) dp[j][i] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t af[4];
        frag_a(af, own2, LD, wr, ks * 16, lane);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t bf[4];
          frag_b(bf, str2, LD, np * 16, ks * 16, lane);
          mma(dp[2 * np], af, bf[0], bf[1]);
          mma(dp[2 * np + 1], af, bf[2], bf[3]);
        }
      }

      // DL: the rows' sums of P * dP, the gradients' passes skipped
      if constexpr (DL) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) del_r[i >> 1] = fmaf(s[j][i], dp[j][i], del_r[i >> 1]);
        continue;
      }

      // KM: dv += P^T . dO (A = P from registers, the dO tile transposed)
      if constexpr (KM) {
#pragma unroll
        for (int kk = 0; kk < NT / 2; ++kk) {
          uint32_t pa[4] = {fb::pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                            fb::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                            fb::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                            fb::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
          for (int np = 0; np < PT / 2; ++np) {
            uint32_t bt[4];
            frag_bt(bt, str2, LD, kk * 16, np * 16, lane);
            mma(accv[2 * np], pa, bt[0], bt[1]);
            mma(accv[2 * np + 1], pa, bt[2], bt[3]);
          }
        }
      }

      // dS = P * (dP - delta), kept in dp
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float d = KM ? del_c[KM ? j : 0][i & 1] : del_r[i >> 1];
          dp[j][i] = s[j][i] * (dp[j][i] - d);
        }

      // acc1 += dS . str1 (KM: dk from q; QM: dq from k), and the factors'
      // gradient dS . str3 with dS and the factor each split hi + lo
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk) {
        uint32_t dh[4];
#pragma unroll
        for (int x = 0; x < 2; ++x)
#pragma unroll
          for (int rr = 0; rr < 2; ++rr)
            dh[2 * x + rr] = fb::pack_bf16(dp[2 * kk + x][2 * rr], dp[2 * kk + x][2 * rr + 1]);
#pragma unroll
        for (int np = 0; np < PT / 2; ++np) {
          uint32_t bt[4];
          frag_bt(bt, str1, LD, kk * 16, np * 16, lane);
          mma(acc1[2 * np], dh, bt[0], bt[1]);
          mma(acc1[2 * np + 1], dh, bt[2], bt[3]);
        }
        if constexpr (PHI) {
          if (need_p) {
            uint32_t dl[4];   // dS - hi, rounded
#pragma unroll
            for (int x = 0; x < 2; ++x)
#pragma unroll
              for (int rr = 0; rr < 2; ++rr) {
                const float2 hf = __bfloat1622float2(
                    *reinterpret_cast<const __nv_bfloat162*>(&dh[2 * x + rr]));
                dl[2 * x + rr] = fb::pack_bf16(dp[2 * kk + x][2 * rr] - hf.x,
                                               dp[2 * kk + x][2 * rr + 1] - hf.y);
              }
#pragma unroll
            for (int np = 0; np < PT / 2; ++np) {
              uint32_t bh[4], bl[4];
              frag_bt(bh, str3h, LD, kk * 16, np * 16, lane);
              frag_bt(bl, str3l, LD, kk * 16, np * 16, lane);
#pragma unroll
              for (int x = 0; x < 2; ++x) {
                const int o = 2 * np + x;
                mma(accp[o], dh, bh[2 * x], bh[2 * x + 1]);
                mma(accp[o], dh, bl[2 * x], bl[2 * x + 1]);
                mma(accp[o], dl, bh[2 * x], bh[2 * x + 1]);
              }
            }
          }
        }
      }
    }
    cp_async_wait<0>();   // nothing left in flight (a head with no tile)

    if constexpr (DL) {   // the quad's four partial sums, in a fixed order
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        float d = del_r[hi];
        d += __shfl_xor_sync(0xffffffffu, d, 1);
        d += __shfl_xor_sync(0xffffffffu, d, 2);
        const int row = r0 + wr + g + 8 * hi;
        if (tig == 0 && row < a.N) a.delta[plane * a.Np + row] = d;
      }
      return;
    }

    // the factors' gradient of this head's own rows
    if constexpr (PHI) {
      if (need_p) {
        float* out = KM ? a.dpk + plane * a.M * P : a.dpq + plane * a.N * P;
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int row = r0 + wr + g + 8 * hi;
          if (row < own_n)
#pragma unroll
            for (int j = 0; j < PT; ++j)
              *reinterpret_cast<float2*>(out + (size_t)row * P + 8 * j + 2 * tig) =
                  make_float2(accp[j][2 * hi], accp[j][2 * hi + 1]);
        }
      }
    }
  }

  // dk (scaled) and dv, or dq (scaled)
  bf16* out1 = KM ? a.dk + plane_kv * a.M * P
                  : a.dq + ((size_t)b * a.H + blockIdx.y) * a.N * P;
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int row = r0 + wr + g + 8 * hi;
    if (row < own_n) {
#pragma unroll
      for (int j = 0; j < PT; ++j) {
        const size_t at = (size_t)row * P + 8 * j + 2 * tig;
        *reinterpret_cast<__nv_bfloat162*>(out1 + at) =
            __floats2bfloat162_rn(acc1[j][2 * hi] * sc, acc1[j][2 * hi + 1] * sc);
        if constexpr (KM)
          *reinterpret_cast<__nv_bfloat162*>(a.dv + plane_kv * a.M * P + at) =
              __floats2bfloat162_rn(accv[j][2 * hi], accv[j][2 * hi + 1]);
      }
    }
  }
}

template <int P, bool PHI, int PASS>
cudaError_t launch_pass(const BwdArgs& a, cudaStream_t stream) {
  constexpr bool KM = PASS == kKeyMajor;
  using Gm = Geom<P, PHI, KM>;
  const auto kernel = attn_bwd<P, PHI, PASS>;
  if (Gm::BYTES > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Gm::BYTES);
    if (e != cudaSuccess) return e;
  }
  const int rows = KM ? a.M : a.N;
  dim3 grid((rows + kRows - 1) / kRows, KM ? a.KVH : a.H, a.B);
  kernel<<<grid, kThreads, Gm::BYTES, stream>>>(a);
  return cudaGetLastError();
}

// the delta pass, then the key-major and the query-major pass
template <int P, bool PHI>
cudaError_t launch_all(const BwdArgs& a, cudaStream_t stream) {
  cudaError_t e = launch_pass<P, PHI, kDelta>(a, stream);
  if (e == cudaSuccess && a.dk) e = launch_pass<P, PHI, kKeyMajor>(a, stream);
  if (e == cudaSuccess && a.dq) e = launch_pass<P, PHI, kQueryMajor>(a, stream);
  return e;
}

}  // namespace

// The passes' launches on `stream`: delta, then key-major (unless dk is
// null) and query-major (unless dq is null). Every bf16 array has rows of P
// columns (P in {16, 32, 64, 96, 128}, at most 96 with factors),
// zero-padded by the caller; lse2 and delta have Np (a multiple of 128)
// entries a row, lse2 padded with +inf, delta zeroed by the caller.
// Returns the cudaError_t of the launches.
extern "C" int flashbias_attn_bwd(const void* q, const void* k, const void* v,
                                  const void* dout, const void* pq_hi, const void* pq_lo,
                                  const void* pk_hi, const void* pk_lo, const void* lse2,
                                  void* delta, const void* slopes, void* dq, void* dk,
                                  void* dv, void* dpq, void* dpk, int B, int H, int KVH, int N,
                                  int M, int Np, int P, float scale, int mask_kind,
                                  int window, int kv_len, void* stream) {
  BwdArgs a{static_cast<const bf16*>(q),      static_cast<const bf16*>(k),
            static_cast<const bf16*>(v),      static_cast<const bf16*>(dout),
            static_cast<const bf16*>(pq_hi),  static_cast<const bf16*>(pq_lo),
            static_cast<const bf16*>(pk_hi),  static_cast<const bf16*>(pk_lo),
            static_cast<const float*>(lse2),  static_cast<float*>(delta),
            static_cast<const float*>(slopes), static_cast<bf16*>(dq),
            static_cast<bf16*>(dk),           static_cast<bf16*>(dv),
            static_cast<float*>(dpq),         static_cast<float*>(dpk),
            B, H, KVH, N, M, Np, scale, mask_kind, window, kv_len};
  if (B == 0 || H == 0 || N == 0 || M == 0 || Np % kRows) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool phi = pq_hi != nullptr;
  switch (P) {
    case 16: return phi ? launch_all<16, true>(a, s) : launch_all<16, false>(a, s);
    case 32: return phi ? launch_all<32, true>(a, s) : launch_all<32, false>(a, s);
    case 64: return phi ? launch_all<64, true>(a, s) : launch_all<64, false>(a, s);
    case 96: return phi ? launch_all<96, true>(a, s) : launch_all<96, false>(a, s);
    case 128: return phi ? cudaErrorInvalidValue : launch_all<128, false>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

// The row block of a pass: Np above is a multiple of it (the wrapper pads lse2
// and delta to one).
extern "C" int flashbias_attn_bwd_rows() { return kRows; }
