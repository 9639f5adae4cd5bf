// Flash-attention forward with an additive FlashBias bias, for Hopper (sm_90a).
//
// Replaces: repro/kernels/flashbias_attn.py::flashbias_attention_fwd (body
// _attn_kernel), the Pallas TPU kernel that prefill reaches through
// ops.flash_attention, and its ragged variant _attn_kernel_ragged, which the
// Pairformer serve path reaches through ops.flash_attention(lengths=). The
// TPU's ragged kernel is the static body with a traced bound, and so is this
// one: a null `lengths` bounds every row by the static kv_len
// (flashbias_attn_fwd), a pointer bounds row b by lengths[b]
// (flashbias_attn_ragged_fwd), read by the block itself in place of the
// TPU's scalar prefetch and clamped into [0, M], so that a row skips the kv
// tiles past its length. Same function: per (b, h) an online float32 softmax
// over kv tiles of  s = q.k^T * scale + bias,  where the bias is
//   phi   : phi_q . phi_k^T           (rank-R factors, float32)
//   alibi : slope[h] * (k_pos - q_pos) (generated in the kernel, no bias IO)
//   none
// and the mask (none / causal / local(window), plus kv_len) is computed from
// positions. Masked logits take -0.7*FLT_MAX (not -inf), m starts at -inf, and
// a row whose sum l stays 0 writes 0, as the TPU kernel does; the bf16 body
// also writes 0 where every key it visited was masked, as the plain version
// does.
//
// What bounds it on the H100: at the prefill shape of GPT-2-ALiBi-1.5B
// (B=4, H=64, N=M=512, D=32, bf16, causal) the bytes that must move are
// q, k, v and o once (~34 MB, ~10 us at 3.35 TB/s); the causal work is
// ~4.3 GFLOP (~4.4 us on the bf16 tensor cores), and the exp of the ~38 M
// logits of the visited tiles ~9 us on the SFUs. At the Pairformer's pair
// shape (B=4 slots, H=4, N=M=384, D=Dv=R=96, bf16 q/k/v, float32 factors)
// the bytes of the live rows are ~8 MB (~2.4 us). Both are bound by bytes.
// Measured, the bf16 body at the prefill shape spends most of its time in
// the per-tile chain of waits (TMA arrival, wgmma, warpgroup barriers),
// not in the exp or the bytes: a copy with every product and the whole
// softmax taken out still ran ~70% as long (PERF.md).
//
// Two bodies, chosen by dtype in run():
//
// bf16 (every serving path): attn_fwd_tc, on the tensor cores, one
// warpgroup (128 threads) per (b, h, 64-row q tile), or two where the grid
// has fewer blocks than twice the SMs (the pair shape's 96): the two share
// the q tile and split its kv tiles, even and odd, and merge their partial
// softmaxes (m, l, o) through shared memory at the end.
//  - Loads: TMA tiled loads (3-d maps over (B*heads, rows, dim), encoded on
//    the host through cudaGetDriverEntryPoint, passed as __grid_constant__)
//    into a ring of 2 stages of k, v and float32 phi_k tiles, one mbarrier
//    each, issued by one thread of the warpgroup that owns the tile: tile
//    t+2 goes into a stage's k (v, phi_k) buffer as soon as tile t is done
//    with it. The zero fill of out-of-bounds boxes pads N, M, D to 16, Dv
//    to 32 and R to 16.
//  - S = q.k^T: wgmma m64n64k16 from shared memory, q and k K-major in
//    panels of 16, 32 or 64 columns with the 32, 64 or 128-byte swizzle the
//    descriptors name; the float32 accumulator is multiplied by `scale`
//    (q is not pre-scaled: q*scale rounded to bf16 would move the result).
//  - phi: each float32 factor x is split into bf16 hi = bf16(x) and
//    lo = bf16(x - hi), written by the threads to shared memory (phi_k from
//    its TMA-staged tile, whose 128-byte swizzle keeps the reads free of
//    bank conflicts), and hi.hi + hi.lo + lo.hi goes into a second m64n64
//    accumulator. The parts left out (lo.lo, and lo's own rounding) are
//    < 2^-16 relative to each product, float32-level accuracy for the bias;
//    single-pass bf16 factors (2^-9) would move logits of ~30 by ~0.03.
//  - Masks from positions, applied only on edge tiles; the kv loop visits
//    only the tiles the mask can reach (causal: k_start <= q_end; local:
//    also k_end >= q_start - (window-1); none: k_start < kv_len).
//  - Online softmax in registers, in the log2 domain (ex2.approx): row max
//    over the 4 threads that share a row of the accumulator (quad
//    shuffles), row sums per thread until the end. P never goes to shared
//    memory: it is rounded to bf16 in registers and is the register A
//    operand of wgmma m64nDvk16 (Dv padded to 32), with v the MN-major B
//    operand. Rounding P costs at most 2^-9 relative per weight (l sums the
//    unrounded p), inside the bf16 output tolerance of 2^-6 x the output's
//    scale.
// float32 (the parity tools: 1e-4 against the plain version): attn_fwd, the
// CUDA-core body. One block of 8 warps per (b, h, 64-row q tile); q, one
// 64-key k/v tile and the phi tiles staged as float32 in shared memory; a
// lane computes the logits of 2 keys, the warp reduces max and sum with
// shuffles and each lane accumulates output dims lane, lane+32, ...

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "sm90_wgmma.cuh"

namespace {

constexpr float kMaskValue = -0.7f * 3.4028234663852886e38f;
constexpr int kBQ = 64;                      // q rows per block
constexpr int kBK = 64;                      // keys per kv tile
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kBQ / kWarps;   // 8
constexpr int kKeysPerLane = kBK / 32;       // 2

struct AttnArgs {
  const void* q;        // (B, H, N, D)
  const void* k;        // (B, KVH, M, D)
  const void* v;        // (B, KVH, M, Dv)
  const float* phi_q;   // (B, H, N, R) or null
  const float* phi_k;   // (B, H, M, R) or null
  const float* slopes;  // (H,) or null
  void* out;            // (B, H, N, Dv)
  int B, H, KVH, N, M, D, Dv, R;
  float scale;
  int mask_kind;        // 0 none, 1 causal, 2 local
  int window;
  int kv_len;           // static key bound, when lengths is null
  const int* lengths;   // (B,) per-row key bound (ragged), or null
};

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

size_t smem_floats(const AttnArgs& a) {
  size_t n = (size_t)kBQ * a.D + (size_t)kBK * (a.D + 1) + (size_t)kBK * a.Dv +
             (size_t)kWarps * kBK;
  if (a.R) n += (size_t)kBQ * a.R + (size_t)kBK * (a.R + 1);
  return n;
}

template <typename T, int DC>
__global__ void __launch_bounds__(kThreads) attn_fwd(AttnArgs a) {
  extern __shared__ float smem[];
  const int D = a.D, Dv = a.Dv, R = a.R, N = a.N, M = a.M;
  const int D1 = D + 1, R1 = R + 1;
  float* sQ = smem;                       // kBQ x D
  float* sK = sQ + kBQ * D;               // kBK x (D + 1)
  float* sV = sK + kBK * D1;              // kBK x Dv
  float* sP = sV + kBK * Dv;              // kWarps x kBK
  float* sPQ = sP + kWarps * kBK;         // kBQ x R
  float* sPK = sPQ + kBQ * R;             // kBK x (R + 1)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.KVH);
  const int q0 = blockIdx.x * kBQ;
  const int q_rows = min(kBQ, N - q0);
  const size_t bh = (size_t)b * a.H + h, bkv = (size_t)b * a.KVH + kvh;

  const T* qb = static_cast<const T*>(a.q) + (bh * N + q0) * D;
  const T* kb = static_cast<const T*>(a.k) + bkv * M * D;
  const T* vb = static_cast<const T*>(a.v) + bkv * M * Dv;
  const float* pqb = R ? a.phi_q + (bh * N + q0) * R : nullptr;
  const float* pkb = R ? a.phi_k + bh * M * R : nullptr;
  const float slope = a.slopes ? a.slopes[h] : 0.f;
  const int kv_len = a.lengths ? min(max(a.lengths[b], 0), M) : a.kv_len;

  for (int i = tid; i < kBQ * D; i += kThreads)
    sQ[i] = (i / D) < q_rows ? load_f32(qb + i) : 0.f;
  for (int i = tid; i < kBQ * R; i += kThreads)
    sPQ[i] = (i / R) < q_rows ? pqb[i] : 0.f;

  // The kv tiles this q tile can see (replaces pl.when block pruning).
  const int q_last = q0 + q_rows - 1;
  int k_hi = min(kv_len, M);
  int k_lo = 0;
  if (a.mask_kind != 0) k_hi = min(k_hi, q_last + 1);
  if (a.mask_kind == 2) k_lo = max(0, q0 - (a.window - 1));
  k_lo = (k_lo / kBK) * kBK;

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DC];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m[rr] = -CUDART_INF_F;
    l[rr] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[rr][c] = 0.f;
  }

  for (int k0 = k_lo; k0 < k_hi; k0 += kBK) {
    const int k_rows = min(kBK, M - k0);
    __syncthreads();  // the previous tile is consumed (and sQ is written)
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int j = i / D, d = i - j * D;
      sK[j * D1 + d] = j < k_rows ? load_f32(kb + (size_t)k0 * D + i) : 0.f;
    }
    for (int i = tid; i < kBK * Dv; i += kThreads)
      sV[i] = (i / Dv) < k_rows ? load_f32(vb + (size_t)k0 * Dv + i) : 0.f;
    for (int i = tid; i < kBK * R; i += kThreads) {
      const int j = i / R, c = i - j * R;
      sPK[j * R1 + c] = j < k_rows ? pkb[(size_t)k0 * R + i] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      if (r < q_rows) {  // uniform across the warp
        const int q_pos = q0 + r;
        const float* qr = sQ + r * D;
        float s[kKeysPerLane];
        float mx = -CUDART_INF_F;
#pragma unroll
        for (int t = 0; t < kKeysPerLane; ++t) {
          const int j = lane + 32 * t;
          const int k_pos = k0 + j;
          const float* kr = sK + j * D1;
          float dot = 0.f;
          for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
          float x = dot * a.scale;
          if (R) {
            float bias = 0.f;
            for (int c = 0; c < R; ++c) bias = fmaf(sPQ[r * R + c], sPK[j * R1 + c], bias);
            x += bias;
          }
          if (a.slopes) x += slope * (float)(k_pos - q_pos);
          bool ok = k_pos < kv_len;
          if (a.mask_kind != 0) ok = ok && q_pos >= k_pos;
          if (a.mask_kind == 2) ok = ok && (q_pos - k_pos) < a.window;
          s[t] = ok ? x : kMaskValue;
          mx = fmaxf(mx, s[t]);
        }
        mx = warp_max(mx);
        const float m_new = fmaxf(m[rr], mx);
        const float corr = expf(m[rr] - m_new);
        float psum = 0.f;
        float* pw = sP + warp * kBK;
#pragma unroll
        for (int t = 0; t < kKeysPerLane; ++t) {
          const float p = expf(s[t] - m_new);
          pw[lane + 32 * t] = p;
          psum += p;
        }
        psum = warp_sum(psum);
        l[rr] = l[rr] * corr + psum;
        m[rr] = m_new;
        __syncwarp();
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[rr][c] *= corr;
        // keys past M carry v = 0, so the full tile is summed; a partial
        // unroll keeps the loads in flight without spilling acc
#pragma unroll 4
        for (int j = 0; j < kBK; ++j) {
          const float p = pw[j];
          const float* vr = sV + j * Dv;
#pragma unroll
          for (int c = 0; c < DC; ++c) {
            const int d = lane + 32 * c;
            if (d < Dv) acc[rr][c] = fmaf(p, vr[d], acc[rr][c]);
          }
        }
        __syncwarp();  // pw is rewritten by the next row
      }
    }
  }

  T* ob = static_cast<T*>(a.out) + (bh * N + q0) * Dv;
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = warp * kRowsPerWarp + rr;
    if (r < q_rows) {
      const float inv = 1.f / (l[rr] == 0.f ? 1.f : l[rr]);
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int d = lane + 32 * c;
        if (d < Dv) store_f32(ob + (size_t)r * Dv + d, acc[rr][c] * inv);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 body on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kTcThreads = 128;              // one warpgroup
constexpr float kLog2e = 1.4426950408889634f;

// Shared-memory layout of attn_fwd_tc, computed once on the host. Offsets
// are bytes from a 1024-aligned base; every tile starts on 1024. A ring of
// two stages: stage t % 2 holds the k, v and phi_k tiles of kv tile t. The
// merge of two warpgroups' partial results overlays stage 1, which only
// warpgroup 1 uses then.
struct TcGeom {
  int pw, npq, lay_qk;   // q / k: K-major panels of pw columns, layout
  int pwv, npv, lay_v;   // v: MN-major panels of pwv columns, layout
  int dk;                // k-steps of q.k^T: ceil(D / 16)
  int r16, npk;          // R rounded up to 16 (0 without phi); phi_k panels
  unsigned off_pqh, off_pql, off_stage, stage;   // q at 0, stage i at off_stage + i*stage
  unsigned k_at, v_at, pkf_at, pkh_at, pkl_at;          // offsets inside a stage
  unsigned bytes_q, bytes_k, bytes_v, bytes_pkf, off_bar, bytes;
};

unsigned round_up(unsigned x, unsigned m) { return (x + m - 1) / m * m; }

int swizzle_layout(int pw) {
  return pw == 16 ? sm90::kSw32 : pw == 32 ? sm90::kSw64 : sm90::kSw128;
}

constexpr int kPkPanel = 32;                 // float32 phi_k columns per TMA box
constexpr int kStages = 2;                   // the k / v / phi_k ring

// D and Dv are multiples of 8 and R of 4 (the wrapper pads them): TMA
// strides are multiples of 16 bytes.
TcGeom tc_geom(int D, int Dv, int R) {
  TcGeom g{};
  const int dp = (int)round_up(D, 16);
  g.pw = dp <= 16 ? 16 : dp <= 32 ? 32 : 64;
  g.npq = (dp + g.pw - 1) / g.pw;
  g.lay_qk = swizzle_layout(g.pw);
  const int dvp = (int)round_up(Dv, 32);
  g.pwv = dvp % 64 == 0 ? 64 : 32;     // an MN-major atom must not be cut
  g.npv = dvp / g.pwv;
  g.lay_v = swizzle_layout(g.pwv);
  g.dk = dp / 16;
  g.r16 = R ? (int)round_up(R, 16) : 0;
  g.npk = (R + kPkPanel - 1) / kPkPanel;
  g.bytes_q = (unsigned)(g.npq * kBQ * g.pw * 2);
  g.bytes_k = g.bytes_q;
  g.bytes_v = (unsigned)(kBK * dvp * 2);
  g.bytes_pkf = (unsigned)(g.npk * kBK * kPkPanel * 4);
  const unsigned split = (unsigned)(kBQ * g.r16 * 2);
  g.off_pqh = g.bytes_q;
  g.off_pql = g.off_pqh + split;
  g.off_stage = g.off_pql + split;
  g.k_at = 0;
  g.v_at = g.bytes_k;
  g.pkf_at = g.v_at + g.bytes_v;
  g.pkh_at = g.pkf_at + g.bytes_pkf;
  g.pkl_at = g.pkh_at + split;
  g.stage = g.pkl_at + split;
  // the merge: per thread of warpgroup 1, m and l of 2 rows and Dv/2 outputs
  const unsigned merge = (unsigned)(128 * (dvp / 2 + 4) * 4);
  const unsigned last = g.off_stage + (kStages - 1) * g.stage;
  g.off_bar = round_up(last + (merge > g.stage ? merge : g.stage), 8);
  g.bytes = g.off_bar + (3 * kStages + 1) * 8 + 1024;  // mbarriers, alignment slack
  return g;
}

// Byte offset of element (row, c) of a 64-row bf16 factor tile in the
// K-major interleaved layout: 8x8 core matrices of 128 contiguous bytes,
// 8-row groups 128 bytes apart (SBO), 8-column chunks 1024 apart (LBO).
__device__ __forceinline__ unsigned split_off(int row, int c) {
  return (unsigned)((c >> 3) * 1024 + (row >> 3) * 128 + (row & 7) * 16 + (c & 7) * 2);
}

// Byte offset of element (row, c) of the float32 phi_k tile as TMA's
// 128-byte swizzle lays out its 32-column boxes.
__device__ __forceinline__ unsigned pkf_off(int row, int c) {
  return (unsigned)((c >> 5) * (kBK * 128) + row * 128 +
                    ((((c & 31) >> 2) ^ (row & 7)) << 4) + (c & 3) * 4);
}

// Splits x (two adjacent columns) into bf16 hi + lo and stores both parts.
__device__ __forceinline__ void store_split(uint8_t* hi, uint8_t* lo, unsigned off,
                                            float2 x) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x.x, x.y);
  const float2 hf = __bfloat1622float2(h);
  *reinterpret_cast<__nv_bfloat162*>(hi + off) = h;
  *reinterpret_cast<__nv_bfloat162*>(lo + off) =
      __floats2bfloat162_rn(x.x - hf.x, x.y - hf.y);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Barrier of the 128 threads of warpgroup w (ids 1 and 2; 0 is the block's).
__device__ __forceinline__ void wg_sync(int w) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(w + 1) : "memory");
}

// The logits of one tile in the log2 domain, x * log2(e), with the bias of
// MODE (0 none, 1 phi, 2 alibi) and, on an edge tile (EDGE), the mask;
// element i of the accumulator is row row0 + 8*((i>>1)&1) and key col0 +
// 8*(i>>2) + (i&1). Updates the row maxima mx.
template <int MODE, bool EDGE>
__device__ __forceinline__ void logits(float (&s)[32], const float (&sb)[32], float sc2,
                                       float sl2, int row0, int col0, const AttnArgs& a,
                                       int kv_len, float (&mx)[2]) {
  // alibi: sl2 * (key - row) = base[hi] + sl2 * (8*(i>>2) + (i&1))
  const float base[2] = {sl2 * (float)(col0 - row0), sl2 * (float)(col0 - row0 - 8)};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int hi = (i >> 1) & 1, off = 8 * (i >> 2) + (i & 1);
    float x = s[i] * sc2;
    if (MODE == 1) x = fmaf(sb[i], kLog2e, x);
    if (MODE == 2) x += fmaf(sl2, (float)off, base[hi]);
    if (EDGE) {
      const int row = row0 + 8 * hi, col = col0 + off;
      bool ok = col < kv_len;
      if (a.mask_kind != 0) ok = ok && row >= col;
      if (a.mask_kind == 2) ok = ok && (row - col) < a.window;
      x = ok ? x : kMaskValue;
    }
    s[i] = x;
    mx[hi] = fmaxf(mx[hi], x);
  }
}

template <bool PHI, bool EDGE>
__device__ __forceinline__ void logits_of(float (&s)[32], const float (&sb)[32], float sc2,
                                          float sl2, int row0, int col0, const AttnArgs& a,
                                          int kv_len, float (&mx)[2]) {
  if (PHI)
    logits<1, EDGE>(s, sb, sc2, sl2, row0, col0, a, kv_len, mx);
  else if (a.slopes)
    logits<2, EDGE>(s, sb, sc2, sl2, row0, col0, a, kv_len, mx);
  else
    logits<0, EDGE>(s, sb, sc2, sl2, row0, col0, a, kv_len, mx);
}

// One or two warpgroups (blockDim.x / 128) per (b, h, 64-row q tile); the
// host takes two for a grid too small to fill the card. Two share the q
// tile and the phi_q split, warpgroup w takes the kv tiles t = w, w + 2,
// ..., and warpgroup 0 merges the two partial softmaxes at the end (kv
// split). Kv tile t goes through stage t % 2, whose next tile t + 2 is
// loaded as soon as each of its buffers is free. PHI: the bias is phi
// (R > 0), whose accumulator only that instantiation holds.
template <int DVP, bool PHI>
__global__ void __launch_bounds__(2 * kTcThreads, !PHI && DVP <= 64 ? 2 : 1)
    attn_fwd_tc(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                const __grid_constant__ CUtensorMap tm_pk, const AttnArgs a,
                const TcGeom g) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  // barriers: k, v, phi_k of each stage, then q
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + g.off_bar);

  const int tid = threadIdx.x, w = tid >> 7, wt = tid & 127;
  const int nwg = blockDim.x / kTcThreads;
  const bool kv_split = nwg == 2;
  const int lane = tid & 31, warp = wt >> 5;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.KVH);
  const int q0 = blockIdx.x * kBQ;
  const int q_rows = min(kBQ, a.N - q0);
  const int bh = b * a.H + h, bkv = b * a.KVH + kvh;
  const int R = a.R;
  const float slope = a.slopes ? a.slopes[h] : 0.f;
  const int kv_len = a.lengths ? min(max(a.lengths[b], 0), a.M) : a.kv_len;

  // The kv tiles this q tile can see (replaces pl.when block pruning).
  const int q_last = q0 + q_rows - 1;
  int k_hi = min(kv_len, a.M);
  int k_lo = 0;
  if (a.mask_kind != 0) k_hi = min(k_hi, q_last + 1);
  if (a.mask_kind == 2) k_lo = max(0, q0 - (a.window - 1));
  k_lo = (k_lo / kBK) * kBK;
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + kBK - 1) / kBK : 0;

  const unsigned panel_qk = (unsigned)(kBQ * g.pw * 2);
  const unsigned panel_v = (unsigned)(kBK * g.pwv * 2);
  // the k, v and phi_k loads of kv tile t into its stage, each on its own
  // mbarrier of the stage (3 * stage + 0, 1, 2), issued by one thread of
  // the warpgroup that takes the tile
  constexpr int nst = kStages, qbar = 3 * nst;
  const bool loader = wt == 0;
  auto stage_of = [&](int t) { return sm + g.off_stage + (t & (nst - 1)) * g.stage; };
  auto load_k = [&](int t) {
    uint64_t* bk = &bar[3 * (t & (nst - 1))];
    sm90::mbar_expect_tx(bk, g.bytes_k);
    for (int p = 0; p < g.npq; ++p)
      sm90::tma_load_3d(stage_of(t) + g.k_at + p * panel_qk, &tm_k, bk, p * g.pw,
                        k_lo + t * kBK, bkv);
  };
  auto load_v = [&](int t) {
    uint64_t* bv = &bar[3 * (t & (nst - 1)) + 1];
    sm90::mbar_expect_tx(bv, g.bytes_v);
    for (int p = 0; p < g.npv; ++p)
      sm90::tma_load_3d(stage_of(t) + g.v_at + p * panel_v, &tm_v, bv, p * g.pwv,
                        k_lo + t * kBK, bkv);
  };
  auto load_pk = [&](int t) {
    uint64_t* bp = &bar[3 * (t & (nst - 1)) + 2];
    sm90::mbar_expect_tx(bp, g.bytes_pkf);
    for (int p = 0; p < g.npk; ++p)
      sm90::tma_load_3d(stage_of(t) + g.pkf_at + p * (kBK * kPkPanel * 4), &tm_pk, bp,
                        p * kPkPanel, k_lo + t * kBK, bh);
  };

  if (tid == 0) {
    for (int i = 0; i <= qbar; ++i) sm90::mbar_init(&bar[i], 1);
    sm90::fence_mbar_init();
  }
  __syncthreads();
  if (tid == 0) {
    sm90::mbar_expect_tx(&bar[qbar], g.bytes_q);
    for (int p = 0; p < g.npq; ++p)
      sm90::tma_load_3d(sm + p * panel_qk, &tm_q, &bar[qbar], p * g.pw, q0, bh);
  }
  if (loader) {
    for (int t = 0; t < min(n_tiles, nst); ++t) {  // the first tile of each stage
      if (!kv_split || t % 2 == w) {
        if (PHI) load_pk(t);
        load_k(t);
        load_v(t);
      }
    }
  }

  // the bf16 split of phi_q, by both warpgroups; a warp writes 8 rows x 16
  // bytes of one column chunk, 128 contiguous bytes
  uint8_t* pqh = sm + g.off_pqh;
  uint8_t* pql = sm + g.off_pql;
  const int n_pairs = kBQ * g.r16 / 2;
  if (PHI) {
    const float* pq = a.phi_q + ((size_t)bh * a.N + q0) * R;
    for (int i = tid; i < n_pairs; i += nwg * kTcThreads) {
      const int row = (i >> 2) & 63, c = (i >> 8) * 8 + (i & 3) * 2;
      float2 x = make_float2(0.f, 0.f);
      if (row < q_rows && c < R) x = make_float2(pq[row * R + c], pq[row * R + c + 1]);
      store_split(pqh, pql, split_off(row, c), x);
    }
    sm90::fence_proxy_async();
  }
  __syncthreads();
  sm90::mbar_wait(&bar[qbar], 0);

  const uint32_t a_q = sm90::smem_addr(sm);
  const uint32_t a_pqh = sm90::smem_addr(pqh), a_pql = sm90::smem_addr(pql);
  const uint32_t sbo_qk = 8 * g.pw * 2;
  // the K-major byte offset of k-step ks inside a panelled q / k tile
  auto qk_step = [&](int ks) {
    const int c = ks * 16;
    return (uint32_t)((c / g.pw) * panel_qk + (c % g.pw) * 2);
  };
  const float sc2 = a.scale * kLog2e, sl2 = slope * kLog2e;

  const int row0 = q0 + warp * 16 + (lane >> 2);   // rows row0, row0 + 8
  const int colq = 2 * (lane & 3);
  float o[DVP / 2], s[32], sb[32];
#pragma unroll
  for (int i = 0; i < DVP / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = sb[i] = 0.f;
  float m_r[2] = {-CUDART_INF_F, -CUDART_INF_F}, l_r[2] = {0.f, 0.f};

  for (int t = kv_split ? w : 0; t < n_tiles; t += kv_split ? 2 : 1) {
    const int k0 = k_lo + t * kBK;
    uint8_t* stage = stage_of(t);
    uint64_t* bk = &bar[3 * (t & (nst - 1))];
    const uint32_t parity = (t / nst) & 1;
    const bool more = loader && t + nst < n_tiles;
    uint8_t* pkh = stage + g.pkh_at;
    uint8_t* pkl = stage + g.pkl_at;
    if (PHI) {
      sm90::mbar_wait(bk + 2, parity);
      const uint8_t* pkf = stage + g.pkf_at;
#pragma unroll 4
      for (int i = wt; i < n_pairs; i += kTcThreads) {
        const int row = (i >> 2) & 63, c = (i >> 8) * 8 + (i & 3) * 2;
        store_split(pkh, pkl, split_off(row, c),
                    *reinterpret_cast<const float2*>(pkf + pkf_off(row, c)));
      }
      sm90::fence_proxy_async();
      wg_sync(w);
      if (more) load_pk(t + nst);
      sm90::fence_regs(sb);
    }

    // S = q.k^T and, with phi, B = phi_q.phi_k^T = hi.hi + hi.lo + lo.hi
    const uint32_t a_k = sm90::smem_addr(stage + g.k_at);
    const uint32_t a_pkh = sm90::smem_addr(pkh), a_pkl = sm90::smem_addr(pkl);
    sm90::mbar_wait(bk, parity);
    sm90::fence_regs(s);
    sm90::wgmma_fence();
    for (int ks = 0; ks < g.dk; ++ks)
      sm90::wgmma_ss_n64(s, sm90::make_desc(a_q + qk_step(ks), 16, sbo_qk, g.lay_qk),
                         sm90::make_desc(a_k + qk_step(ks), 16, sbo_qk, g.lay_qk), ks > 0);
    if (PHI) {
      const uint32_t part_a[3] = {a_pqh, a_pqh, a_pql};
      const uint32_t part_b[3] = {a_pkh, a_pkl, a_pkh};
#pragma unroll
      for (int part = 0; part < 3; ++part)
        for (int ks = 0; ks < g.r16 / 16; ++ks)
          sm90::wgmma_ss_n64(
              sb, sm90::make_desc(part_a[part] + ks * 2048, 1024, 128, sm90::kInterleave),
              sm90::make_desc(part_b[part] + ks * 2048, 1024, 128, sm90::kInterleave),
              part > 0 || ks > 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::fence_regs(s);
    if (PHI) sm90::fence_regs(sb);
    wg_sync(w);
    if (more) load_k(t + nst);

    // logits (masks on edge tiles only) and the online softmax, log2 domain
    const bool edge = k0 + kBK > kv_len || (a.mask_kind != 0 && k0 + kBK - 1 > q0) ||
                      (a.mask_kind == 2 && q_last - k0 >= a.window);
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
    if (edge)
      logits_of<PHI, true>(s, sb, sc2, sl2, row0, k0 + colq, a, kv_len, mx);
    else
      logits_of<PHI, false>(s, sb, sc2, sl2, row0, k0 + colq, a, kv_len, mx);
    float corr[2];
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      mx[hi] = fmaxf(mx[hi], __shfl_xor_sync(0xffffffffu, mx[hi], 1));
      mx[hi] = fmaxf(mx[hi], __shfl_xor_sync(0xffffffffu, mx[hi], 2));
      const float m_new = fmaxf(m_r[hi], mx[hi]);
      corr[hi] = ex2(m_r[hi] - m_new);
      m_r[hi] = m_new;
      l_r[hi] *= corr[hi];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hi = (i >> 1) & 1;
      s[i] = ex2(s[i] - m_r[hi]);
      l_r[hi] += s[i];
    }
#pragma unroll
    for (int i = 0; i < DVP / 2; ++i) o[i] *= corr[(i >> 1) & 1];
    uint32_t p[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        p[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);

    // O += P.V: P from registers, v MN-major, 16 keys a step
    const uint32_t a_v = sm90::smem_addr(stage + g.v_at);
    sm90::mbar_wait(bk + 1, parity);
    sm90::fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) sm90::fence_regs(p[kk]);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      sm90::WgmmaRS<DVP>::run(
          o, p[kk],
          sm90::make_desc(a_v + kk * 16 * g.pwv * 2, panel_v, 8 * g.pwv * 2, g.lay_v), 1);
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::fence_regs(o);
    wg_sync(w);
    if (more) load_v(t + nst);
  }

#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    l_r[hi] += __shfl_xor_sync(0xffffffffu, l_r[hi], 1);
    l_r[hi] += __shfl_xor_sync(0xffffffffu, l_r[hi], 2);
  }
  // under the kv split, warpgroup 1 hands its partial result (o, m, l of
  // the same rows and columns as its twin thread's) to warpgroup 0 through
  // the last stage, whose tiles it has consumed
  float* merge = reinterpret_cast<float*>(sm + g.off_stage + (nst - 1) * g.stage);
  auto merged = [&](int i) { return kv_split ? merge[i * kTcThreads + wt] : 0.f; };
  if (kv_split && w == 1) {
#pragma unroll
    for (int i = 0; i < DVP / 2; ++i) merge[i * kTcThreads + wt] = o[i];
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      merge[(DVP / 2 + hi) * kTcThreads + wt] = m_r[hi];
      merge[(DVP / 2 + 2 + hi) * kTcThreads + wt] = l_r[hi];
    }
  }
  if (kv_split) {
    __syncthreads();
    if (w == 1) return;
  }
  float scale0[2], scale1[2], inv[2];
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const float m1 = kv_split ? merge[(DVP / 2 + hi) * kTcThreads + wt] : -CUDART_INF_F;
    const float l1 = merged(DVP / 2 + 2 + hi);
    const float m = fmaxf(m_r[hi], m1);
    const bool empty = m == -CUDART_INF_F;      // no tile seen
    scale0[hi] = empty ? 0.f : ex2(m_r[hi] - m);
    scale1[hi] = empty ? 0.f : ex2(m1 - m);
    const float l = l_r[hi] * scale0[hi] + l1 * scale1[hi];
    // no allowed key: no tile visited (l = 0) or every logit masked
    inv[hi] = (l == 0.f || m == kMaskValue) ? 0.f : 1.f / l;
  }
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(a.out) + (size_t)bh * a.N * a.Dv;
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int row = row0 + 8 * hi;
    if (row < a.N) {
#pragma unroll
      for (int j = 0; j < DVP / 8; ++j) {
        const int col = 8 * j + colq;
        const int i0 = 4 * j + 2 * hi, i1 = i0 + 1;
        const float o0 = (o[i0] * scale0[hi] + merged(i0) * scale1[hi]) * inv[hi];
        const float o1 = (o[i1] * scale0[hi] + merged(i1) * scale1[hi]) * inv[hi];
        if (col < a.Dv)
          *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row * a.Dv + col) =
              __floats2bfloat162_rn(o0, o1);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime: the library
// links no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

CUtensorMapSwizzle tma_swizzle(int row_bytes) {
  return row_bytes == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
       : row_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B;
}

// A 3-d map over a contiguous (planes, rows, dim) array; a box is `box_dim`
// columns of 64 rows of one plane, stored with the swizzle of its row width.
bool map_3d(CUtensorMap* map, const void* base, bool bf16, int dim, int rows, int planes,
            int box_dim) {
  const int esize = bf16 ? 2 : 4;
  const cuuint64_t dims[3] = {(cuuint64_t)dim, (cuuint64_t)rows, (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)dim * esize, (cuuint64_t)dim * rows * esize};
  const cuuint32_t box[3] = {(cuuint32_t)box_dim, 64u, 1u};
  const cuuint32_t elem[3] = {1u, 1u, 1u};
  EncodeTiled fn = encode_tiled();
  return fn && fn(map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                  3, const_cast<void*>(base), dims, strides, box, elem,
                  CU_TENSOR_MAP_INTERLEAVE_NONE,
                  tma_swizzle(box_dim * esize),
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int sm_count() {
  static int n = 0;
  if (!n) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n = 132;
  }
  return n;
}

template <int DVP>
cudaError_t launch_tc(const AttnArgs& a, const TcGeom& g, cudaStream_t stream) {
  const auto kernel = a.R ? attn_fwd_tc<DVP, true> : attn_fwd_tc<DVP, false>;
  CUtensorMap tq{}, tk{}, tv{}, tp{};
  if (!map_3d(&tq, a.q, true, a.D, a.N, a.B * a.H, g.pw) ||
      !map_3d(&tk, a.k, true, a.D, a.M, a.B * a.KVH, g.pw) ||
      !map_3d(&tv, a.v, true, a.Dv, a.M, a.B * a.KVH, g.pwv) ||
      (a.R && !map_3d(&tp, a.phi_k, false, a.R, a.M, a.B * a.H, kPkPanel)))
    return cudaErrorInvalidValue;
  if (g.bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)g.bytes);
    if (e != cudaSuccess) return e;
  }
  // a grid too small to give every SM two blocks splits each block's kv
  // tiles over two warpgroups
  dim3 grid((a.N + kBQ - 1) / kBQ, a.H, a.B);
  const int nwg = (long long)grid.x * grid.y * grid.z < 2LL * sm_count() ? 2 : 1;
  kernel<<<grid, nwg * kTcThreads, g.bytes, stream>>>(tq, tk, tv, tp, a, g);
  return cudaGetLastError();
}

cudaError_t dispatch_tc(const AttnArgs& a, cudaStream_t stream) {
  if (a.D % 8 || a.Dv % 8 || a.R % 4 || a.R > 256) return cudaErrorInvalidValue;
  const TcGeom g = tc_geom(a.D, a.Dv, a.R);
  switch (g.npv * g.pwv) {
    case 32: return launch_tc<32>(a, g, stream);
    case 64: return launch_tc<64>(a, g, stream);
    case 96: return launch_tc<96>(a, g, stream);
    case 128: return launch_tc<128>(a, g, stream);
    case 160: return launch_tc<160>(a, g, stream);
    case 192: return launch_tc<192>(a, g, stream);
    case 224: return launch_tc<224>(a, g, stream);
    case 256: return launch_tc<256>(a, g, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// float32 body's launch
// ---------------------------------------------------------------------------

template <typename T, int DC>
cudaError_t launch(const AttnArgs& a, cudaStream_t stream) {
  const size_t smem = smem_floats(a) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        attn_fwd<T, DC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((a.N + kBQ - 1) / kBQ, a.H, a.B);
  attn_fwd<T, DC><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const AttnArgs& a, cudaStream_t stream) {
  switch ((a.Dv + 31) / 32) {
    case 1: return launch<T, 1>(a, stream);
    case 2: return launch<T, 2>(a, stream);
    case 3: return launch<T, 3>(a, stream);
    case 4: return launch<T, 4>(a, stream);
    case 5: return launch<T, 5>(a, stream);
    case 6: return launch<T, 6>(a, stream);
    case 7: return launch<T, 7>(a, stream);
    case 8: return launch<T, 8>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The body each dtype takes: bf16 the tensor cores, float32 the CUDA cores.
int run(const AttnArgs& a, int dtype, void* stream) {
  if (a.B == 0 || a.H == 0 || a.N == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(a, s);
  if (dtype == 1) return dispatch_tc(a, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. Returns the cudaError_t of the launch.
extern "C" int flashbias_attn_fwd(const void* q, const void* k, const void* v,
                                  const void* phi_q, const void* phi_k,
                                  const void* slopes, void* out, int dtype, int B,
                                  int H, int KVH, int N, int M, int D, int Dv, int R,
                                  float scale, int mask_kind, int window, int kv_len,
                                  void* stream) {
  AttnArgs a{q, k, v, static_cast<const float*>(phi_q),
             static_cast<const float*>(phi_k), static_cast<const float*>(slopes),
             out, B, H, KVH, N, M, D, Dv, R, scale, mask_kind, window, kv_len,
             nullptr};
  return run(a, dtype, stream);
}

// The ragged kernel: lengths is a (B,) int32 device array, row b's key bound.
extern "C" int flashbias_attn_ragged_fwd(const void* q, const void* k, const void* v,
                                         const void* phi_q, const void* phi_k,
                                         const void* slopes, const void* lengths,
                                         void* out, int dtype, int B, int H, int KVH,
                                         int N, int M, int D, int Dv, int R, float scale,
                                         int mask_kind, int window, void* stream) {
  AttnArgs a{q, k, v, static_cast<const float*>(phi_q),
             static_cast<const float*>(phi_k), static_cast<const float*>(slopes),
             out, B, H, KVH, N, M, D, Dv, R, scale, mask_kind, window, M,
             static_cast<const int*>(lengths)};
  return run(a, dtype, stream);
}

// 1 when run() sends `dtype` to the tensor-core body, else 0.
extern "C" int flashbias_attn_tensor_core(int dtype) { return dtype == 1; }

// Dynamic shared memory one launch of `dtype` needs, for the wrapper's size
// check (bf16: D, Dv multiples of 8 and R of 4, as the wrapper pads them).
extern "C" long long flashbias_attn_smem_bytes(int D, int Dv, int R, int dtype) {
  if (dtype == 1) return (long long)tc_geom(D, Dv, R).bytes;
  AttnArgs a{};
  a.D = D;
  a.Dv = Dv;
  a.R = R;
  return (long long)(smem_floats(a) * sizeof(float));
}
