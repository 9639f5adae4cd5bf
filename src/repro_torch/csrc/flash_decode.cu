// Single-token flash-decoding against a contiguous or a paged KV cache, split
// across blocks along the key axis (split-KV), for Hopper (sm_90a).
//
// Replaces: repro/kernels/flash_decode.py::flash_decode_fwd (body
// _decode_kernel) and ::flash_decode_paged_fwd (the same body behind index
// maps that resolve pages), the Pallas TPU kernels that decode reaches
// through ops.flash_decode. Same function: the G q-heads of one kv head
// attend to that head's cache rows 0 .. lengths[b]-1 with a float32 softmax
// of
//   s = q.k^T * scale + bias,
// the bias being phi (phi_q . phi_k^T, read as float32), ALiBi
// slope * (k_pos - (lengths[b] - 1)) generated in the kernel, or none. Keys
// at or past lengths[b] take no part (the TPU kernel's -0.7*FLT_MAX logits,
// whose weights are exactly 0), and a row with length 0 writes 0.
//
// Paged: the caches are a shared pool (KVH, n_pages, ps, D|Dv) and the phi
// factors a slab (1|KVH, n_pages, ps, R); row b's logical key j lives on page
// page_table[b, min(j / ps, last)] (last = (len-1) / ps), clipped into
// [0, n_pages), at offset j % ps. A slab with a leading 1 is shared by every
// kv head (head stride 0).
//
// The new token's row. Given k_new / v_new (B, KVH, D|Dv), the call first
// writes row b's new key and value, as the reference's scatter before its
// kernel does: only rows with lengths[b] > 0, at position lengths[b]-1 —
// contiguous, dropped past the cache; paged, on page
// page_table[b, min((len-1) / ps, P-1)] at offset (len-1) % ps, dropped
// unless that page lies in [0, n_pages). It then attends to what the cache
// holds after the write: a staged key whose cache row is the written one
// takes the new values (where the write was dropped, the old row is read).
// Only the block of the row's last split stores the row to the cache.
// Rows must not share the page they write (the serve engine's pages each
// belong to one row).
//
// What bounds it on the H100: memory, and at the GPT-2 decode shape the
// latency of reaching it. Every live cache row is read once and feeds only G
// multiply-adds per channel, far below the ~295 operations per byte the card
// needs before arithmetic is the limit. At B=4 slots, KVH=64, G=1, head_dim
// 32, bf16 the live rows are ~10 MB, ~3 us at 3.35 TB/s, so the time is
// set by how many of those bytes are in flight at once.
//
// Design:
// - The split plan depends on the row alone: its live keys are cut into
//   spans of `span` keys (the wrapper's split_span, a function of D, Dv, R
//   and the dtype), so row b has ceil(len_b / span) splits, and block
//   (h, b, z) takes splits z, z + grid_z, ... The grid's split axis is the
//   splits of the longest view the cache allows (S, or P * ps paged), or
//   fewer where the card cannot hold that many blocks at once (see
//   launch); a block past its row's splits exits at once. Nothing depends
//   on another row's length, so a request's output is the same alone or
//   batched with others.
// - A block stages its span in shared memory with every copy in flight
//   (k and v rows as 16-byte cp.async where rows are 16-byte aligned,
//   element loads where not; phi rows as 4-byte cp.async; paged, the page
//   of each key resolved first) and waits once.
// - Logits from shared memory (a group of lanes per key, one 16-byte chunk
//   of its row each, reduced by shuffles), the span's softmax, then P.V by
//   a thread per (16-byte chunk of v, key group), reduced by shuffles and
//   across warps in a fixed order. No tensor cores: at G <= 16 the
//   products are matrix-vector.
// - Splits combine deterministically: a row with one split writes its
//   output directly. Otherwise each split writes (m, l, acc) to a float32
//   scratch; the last block of (b, h) to arrive (an int32 counter per
//   (b, h), counted by an acq_rel atomic) merges them by log-sum-exp in
//   split order and resets the counter for the next call. No float
//   atomics: the same inputs give bit-identical outputs on every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 16;                    // q heads per kv head
constexpr int kMaxSpan = 256;                // keys per split
constexpr int kGridSplits = 0;               // > 0: a fixed split axis

struct DecodeArgs {
  const void* q;          // (B, KVH, G, D)
  void* k;                // (B, KVH, S, D) | pool (KVH, n_pages, ps, D)
  void* v;                // (B, KVH, S, Dv) | pool (KVH, n_pages, ps, Dv)
  const int* lengths;     // (B,)
  const float* phi_q;     // (B, KVH, G, R) or null
  const float* phi_k;     // (B, KVH, S, R) | slab (1|KVH, n_pages, ps, R)
  const float* slopes;    // (KVH, G) or null
  const void* k_new;      // (B, KVH, D) or null: the row to write
  const void* v_new;      // (B, KVH, Dv)
  void* out;              // (B, KVH, G, Dv)
  float* part;            // (B, KVH, Z, G, Dv + 2) split partials
  int* arrivals;          // (B * KVH,) zeros between calls
  const int* page_table;  // paged: (B, P)
  int B, KVH, G, S, D, Dv, R;  // paged: S = P * ps, the longest view
  int P, n_pages, ps;          // paged only
  int phi_heads;               // paged only: 1 (shared slab) or KVH
  int span, Z;                 // keys per split; splits of the longest view
  int vec_k, vec_v;            // rows copied 16 bytes at a time
  float scale;
};

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

// Shared-memory layout, in bytes. The k / v tile is reused by the merge.
struct Layout {
  int Ds, Dvs;            // row lengths in the tile, padded to 16 bytes
  size_t v, row, phi, q, pq, s, ml, red, flag, total, region;
};

template <typename T>
__host__ __device__ inline Layout make_layout(int span, int G, int D, int Dv,
                                              int R) {
  constexpr int E = 16 / sizeof(T);
  Layout L;
  L.Ds = (D + E - 1) / E * E;
  L.Dvs = (Dv + E - 1) / E * E;
  const size_t tile = (size_t)span * (L.Ds + L.Dvs) * sizeof(T);
  const size_t merge = (size_t)G * (Dv + 2) * sizeof(float);
  L.region = tile > merge ? tile : merge;
  L.v = (size_t)span * L.Ds * sizeof(T);
  size_t o = align16(L.region);
  L.row = o;   o = align16(o + (size_t)span * sizeof(int));
  L.phi = o;   o = align16(o + (size_t)span * R * sizeof(float));
  L.q = o;     o = align16(o + (size_t)G * L.Ds * sizeof(float));
  L.pq = o;    o = align16(o + (size_t)G * R * sizeof(float));
  L.s = o;     o = align16(o + (size_t)G * span * sizeof(float));
  L.ml = o;    o = align16(o + 2 * kMaxG * sizeof(float));
  L.red = o;   o = align16(o + (size_t)kWarps * G * L.Dvs * sizeof(float));
  L.flag = o;  o += 16;
  L.total = o;
  return L;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16 bytes of T (shared memory, 16-byte aligned) as float32.
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// atomicAdd(p, 1) with release and acquire semantics at device scope.
__device__ __forceinline__ int arrive_acq_rel(int* p) {
  int prev;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
               : "=r"(prev) : "l"(p) : "memory");
  return prev;
}

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

// Copy the rows of the span's nk keys (row(j): the cache row of key j) into
// the tile `dst` (rows of Ds values): a key whose row is `w_row` takes
// `fresh` instead. 16-byte cp.async where the rows allow it, else element
// loads with the row's pad zeroed.
template <typename T, typename RowFn>
__device__ __forceinline__ void stage_rows(T* dst, const T* src,
                                           const T* fresh, int D, int Ds,
                                           bool vec, int nk, int w_row,
                                           RowFn row) {
  constexpr int E = 16 / sizeof(T);
  if (vec) {
    const int C = D / E;
    for (int i = threadIdx.x; i < nk * C; i += kThreads) {
      const int j = i / C, c = i - j * C;
      const int r = row(j);
      cp_async16(dst + i * E, r == w_row ? fresh + c * E
                                         : src + (size_t)r * D + c * E);
    }
  } else {
    for (int i = threadIdx.x; i < nk * Ds; i += kThreads) {
      const int j = i / Ds, d = i - j * Ds;
      const int r = row(j);
      dst[i] = d >= D ? from_f32<T>(0.f)
                      : (r == w_row ? fresh[d] : src[(size_t)r * D + d]);
    }
  }
}

// MG: the q heads per kv head rounded up to 1, 2, 4, 8 or 16 (register
// arrays of MG rows; at 16 the P.V accumulators alone take 128 registers a
// thread). DK: 0, or D = Dv = DK known at compile time (the LM path's
// 32), which turns the index arithmetic into shifts. That body at G = 1 (the
// LM path) asks for 8 resident blocks per SM, at most 64 registers a thread:
// the path's live splits then fit on the card at once.
template <typename T, int MG, bool PAGED, int DK>
__global__ void __launch_bounds__(kThreads, MG == 1 && DK ? 8 : 1)
    decode_split(DecodeArgs a) {
  constexpr int E = 16 / sizeof(T);          // values per 16 bytes
  constexpr int kMaxCh = 8 / E;              // v chunks per lane (f32: 2)
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = a.G, R = a.R, span = a.span;
  const int D = DK ? DK : a.D, Dv = DK ? DK : a.Dv;
  const Layout L = make_layout<T>(span, G, D, Dv, R);
  const int Ds = L.Ds, Dvs = L.Dvs;
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = reinterpret_cast<T*>(smem + L.v);
  float* sMerge = reinterpret_cast<float*>(smem);
  int* sRow = reinterpret_cast<int*>(smem + L.row);
  float* sPhi = reinterpret_cast<float*>(smem + L.phi);
  float* sQ = reinterpret_cast<float*>(smem + L.q);
  float* sPQ = reinterpret_cast<float*>(smem + L.pq);
  float* sS = reinterpret_cast<float*>(smem + L.s);
  float* sM = reinterpret_cast<float*>(smem + L.ml);
  float* sL = sM + kMaxG;
  float* sRed = reinterpret_cast<float*>(smem + L.red);
  int* sFlag = reinterpret_cast<int*>(smem + L.flag);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.x, b = blockIdx.y;
  const size_t bh = (size_t)b * a.KVH + h;
  // paged: the first split's page ids, loaded beside the length (for a live
  // key j, min(j / ps, last) is j / ps: no length needed). Both reads of
  // the span's ids take a key below S = P * ps, so key / ps < P, and the
  // page is clamped into the pool where sRow takes it.
  int page0 = 0;
  if (PAGED) {
    const int key = blockIdx.z * span + tid;
    if (tid < span && key < a.S)
      page0 = a.page_table[(size_t)b * a.P + key / a.ps];  // statcheck: allow(page-table-clamp)
  }
  const int len_raw = a.lengths[b];
  const int len = min(max(len_raw, 0), a.S);
  const int nsplit = max(1, (len + span - 1) / span);
  if ((int)blockIdx.z >= nsplit) return;
  T* ob = static_cast<T*>(a.out) + bh * G * Dv;
  if (len == 0) {                  // no key, and no row to write
    for (int i = tid; i < G * Dv; i += kThreads) ob[i] = from_f32<T>(0.f);
    return;
  }

  // this (b, h)'s rows: contiguous, the row's keys; paged, the head's pool
  T* kh = static_cast<T*>(a.k);
  T* vh = static_cast<T*>(a.v);
  const float* phih = a.phi_k;
  if (!PAGED) {
    kh += bh * a.S * D;
    vh += bh * a.S * Dv;
    if (R) phih += bh * a.S * R;
  } else {
    const size_t rows = (size_t)a.n_pages * a.ps;
    kh += h * rows * D;
    vh += h * rows * Dv;
    if (R && a.phi_heads != 1) phih += h * rows * R;
  }
  const T* kn = a.k_new ? static_cast<const T*>(a.k_new) + bh * D : nullptr;
  const T* vn = a.v_new ? static_cast<const T*>(a.v_new) + bh * Dv : nullptr;
  // the cache row the new token's k/v land on, or -1 (no write, or dropped)
  int w_row = -1;
  if (kn != nullptr) {
    const int pos = len_raw - 1;
    if (!PAGED) {
      if (pos < a.S) w_row = pos;
    } else {
      const int page = a.page_table[(size_t)b * a.P + min(pos / a.ps, a.P - 1)];
      if (page >= 0 && page < a.n_pages) w_row = page * a.ps + pos % a.ps;
    }
  }
  float slope[MG];
#pragma unroll
  for (int g = 0; g < MG; ++g)
    slope[g] = (a.slopes && g < G) ? a.slopes[h * G + g] : 0.f;

  for (int split = blockIdx.z; split < nsplit; split += gridDim.z) {
    const int j0 = split * span, nk = min(span, len - j0);
    if (PAGED) {
      for (int j = tid; j < nk; j += kThreads) {
        const int key = j0 + j;
        int page = split == (int)blockIdx.z && j < kThreads
                       ? page0 : a.page_table[(size_t)b * a.P + key / a.ps];  // statcheck: allow(page-table-clamp)
        page = min(max(page, 0), a.n_pages - 1);
        sRow[j] = page * a.ps + key % a.ps;
      }
      __syncthreads();
    }
    auto row = [&](int j) { return PAGED ? sRow[j] : j0 + j; };

    // ---- stage the span: every copy issued, then one wait
    stage_rows<T>(sK, kh, kn, D, Ds, a.vec_k, nk, w_row, row);
    stage_rows<T>(sV, vh, vn, Dv, Dvs, a.vec_v, nk, w_row, row);
    for (int j = tid; j < nk && R; j += kThreads) {
      const float* src = phih + (size_t)row(j) * R;
      for (int c = 0; c < R; ++c) cp_async4(sPhi + j * R + c, src + c);
    }
    if (split == nsplit - 1 && w_row >= 0) {   // the row's one writer
      for (int i = tid; i < D; i += kThreads) kh[(size_t)w_row * D + i] = kn[i];
      for (int i = tid; i < Dv; i += kThreads)
        vh[(size_t)w_row * Dv + i] = vn[i];
    }
    if (split == (int)blockIdx.z) {
      const T* qb = static_cast<const T*>(a.q) + bh * G * D;
      for (int i = tid; i < G * Ds; i += kThreads) {
        const int g = i / Ds, d = i - g * Ds;
        sQ[i] = d < D ? to_f32(qb[g * D + d]) : 0.f;
      }
      for (int i = tid; i < G * R; i += kThreads)
        sPQ[i] = a.phi_q[bh * G * R + i];
    }
    cp_async_wait_all();
    __syncthreads();

    // ---- logits: Lk lanes per key, one 16-byte chunk of its row each
    {
      const int C = Ds / E;
      int Lk = 1;
      while (Lk < C && Lk < 32) Lk <<= 1;
      const int per = kThreads / Lk, grp = tid / Lk, li = tid % Lk;
      for (int jb = 0; jb < nk; jb += per) {
        const int j = jb + grp;
        float s[MG];
#pragma unroll
        for (int g = 0; g < MG; ++g) s[g] = 0.f;
        if (j < nk) {
          for (int c = li; c < C; c += Lk) {
            float kv[E];
            load16(sK + j * Ds + c * E, kv);
#pragma unroll
            for (int e = 0; e < E; ++e)
#pragma unroll
              for (int g = 0; g < MG; ++g)
                if (g < G) s[g] = fmaf(sQ[g * Ds + c * E + e], kv[e], s[g]);
          }
        }
#pragma unroll
        for (int g = 0; g < MG; ++g)
          for (int o = Lk >> 1; o > 0; o >>= 1)
            s[g] += __shfl_xor_sync(0xffffffffu, s[g], o);
        if (j < nk && li == 0) {
#pragma unroll
          for (int g = 0; g < MG; ++g) {
            if (g < G) {
              float x = s[g] * a.scale;
              if (R) {
                float bias = 0.f;
                for (int c = 0; c < R; ++c)
                  bias = fmaf(sPQ[g * R + c], sPhi[j * R + c], bias);
                x += bias;
              }
              if (a.slopes) x += slope[g] * (float)(j0 + j - (len - 1));
              sS[g * span + j] = x;
            }
          }
        }
      }
    }
    __syncthreads();

    // ---- the span's softmax, one warp per q row
    for (int g = warp; g < G; g += kWarps) {
      float* sg = sS + g * span;
      float m = -CUDART_INF_F;
      for (int j = lane; j < nk; j += 32) m = fmaxf(m, sg[j]);
      m = warp_max(m);
      float l = 0.f;
      for (int j = lane; j < nk; j += 32) {
        const float p = expf(sg[j] - m);
        sg[j] = p;
        l += p;
      }
      l = warp_sum(l);
      if (lane == 0) {
        sM[g] = m;
        sL[g] = l;
      }
    }
    __syncthreads();

    // ---- P.V: lane (key group, 16-byte chunk of v); groups reduced by
    // shuffles, then the warps' sums in warp order
    {
      const int C = Dvs / E;
      int Cp = 1;
      while (Cp < C) Cp <<= 1;
      const int lanes = Cp < 32 ? Cp : 32;       // lanes per key
      const int kpw = 32 / lanes;                // keys per warp
      const int c0 = lane % lanes;
      const int nch = Cp > 32 ? Cp / 32 : 1;     // chunks per lane
      float acc[MG][8];
#pragma unroll
      for (int g = 0; g < MG; ++g)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
      for (int j = warp * kpw + lane / lanes; j < nk; j += kWarps * kpw) {
        float p[MG];
#pragma unroll
        for (int g = 0; g < MG; ++g) p[g] = g < G ? sS[g * span + j] : 0.f;
#pragma unroll
        for (int i = 0; i < kMaxCh; ++i) {
          const int c = c0 + 32 * i;
          if (i < nch && c < C) {
            float vv[E];
            load16(sV + j * Dvs + c * E, vv);
#pragma unroll
            for (int g = 0; g < MG; ++g)
#pragma unroll
              for (int e = 0; e < E; ++e)
                acc[g][i * E + e] = fmaf(p[g], vv[e], acc[g][i * E + e]);
          }
        }
      }
      for (int o = lanes; o < 32; o <<= 1)
#pragma unroll
        for (int g = 0; g < MG; ++g)
#pragma unroll
          for (int e = 0; e < kMaxCh * E; ++e)
            acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], o);
      if (lane < lanes) {
#pragma unroll
        for (int i = 0; i < kMaxCh; ++i) {
          const int c = c0 + 32 * i;
          if (i < nch && c < C) {
#pragma unroll
            for (int g = 0; g < MG; ++g)
              if (g < G)
#pragma unroll
                for (int e = 0; e < E; ++e)
                  sRed[(warp * G + g) * Dvs + c * E + e] = acc[g][i * E + e];
          }
        }
      }
    }
    __syncthreads();

    // ---- one split: the output; several: the partial, then the merge
    const int per = G * (Dv + 2);
    float* pp = a.part + (bh * a.Z + split) * per;
    for (int i = tid; i < G * Dv; i += kThreads) {
      const int g = i / Dv, d = i - g * Dv;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += sRed[(w * G + g) * Dvs + d];
      if (nsplit == 1) ob[i] = from_f32<T>(sum / sL[g]);
      else pp[g * (Dv + 2) + d] = sum;
    }
    if (nsplit > 1) {
      if (tid < G) {
        pp[tid * (Dv + 2) + Dv] = sM[tid];
        pp[tid * (Dv + 2) + Dv + 1] = sL[tid];
      }
      // the partial written (barrier), one thread counts the arrival with
      // release and acquire semantics at device scope: the last block to
      // arrive then sees every split's partial after the next barrier
      __syncthreads();
      if (tid == 0)
        *sFlag = arrive_acq_rel(a.arrivals + bh) == nsplit - 1;
      __syncthreads();
      if (*sFlag) {
        // the last split to arrive: log-sum-exp over the splits in order,
        // staged zc at a time in the k / v tile
        const float* base = a.part + bh * a.Z * per;
        const int zc = max(1, (int)(L.region / (per * sizeof(float))));
        for (int e0 = 0; e0 < G * Dv; e0 += kThreads) {
          const int i = e0 + tid;
          const int g = i / Dv, d = i - g * Dv;
          float M = -CUDART_INF_F, Ls = 0.f, O = 0.f;
          for (int z0 = 0; z0 < nsplit; z0 += zc) {
            const int n = min(zc, nsplit - z0);
            if (e0 == 0 || nsplit > zc) {
              __syncthreads();
              for (int t = tid; t < n * per; t += kThreads)
                sMerge[t] = __ldcg(base + (size_t)z0 * per + t);
              __syncthreads();
            }
            if (i < G * Dv) {
              for (int z = 0; z < n; ++z) {
                const float* pz = sMerge + z * per + g * (Dv + 2);
                const float mz = pz[Dv];
                const float mn = fmaxf(M, mz);
                const float cm = expf(M - mn), cz = expf(mz - mn);
                Ls = Ls * cm + pz[Dv + 1] * cz;
                O = O * cm + pz[d] * cz;
                M = mn;
              }
            }
          }
          if (i < G * Dv) ob[i] = from_f32<T>(O / Ls);
        }
        if (tid == 0) a.arrivals[bh] = 0;
      }
    }
    __syncthreads();
  }
}

// Blocks of one instantiation the card holds at once (SMs x resident blocks
// per SM at this shared-memory size), cached for the last device and size.
template <typename T, int MG, bool PAGED, int DK>
cudaError_t resident_blocks(size_t smem, int* out) {
  static int cached_dev = -1, cached = 0;
  static size_t cached_smem = 0;
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev != cached_dev || smem != cached_smem) {
    int sms, per_sm;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, decode_split<T, MG, PAGED, DK>, kThreads, smem);
    if (e != cudaSuccess) return e;
    cached = sms * (per_sm > 0 ? per_sm : 1);
    cached_dev = dev;
    cached_smem = smem;
  }
  *out = cached;
  return cudaSuccess;
}

// The grid's split axis: every split of the longest view (Z) where the card
// holds that many blocks, else as many as it holds per (b, h), the blocks
// walking splits z, z + grid_z, ... The outputs do not depend on it.
template <typename T, int MG, bool PAGED, int DK>
cudaError_t launch(const DecodeArgs& a, cudaStream_t stream) {
  const size_t smem = make_layout<T>(a.span, a.G, a.D, a.Dv, a.R).total;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_split<T, MG, PAGED, DK>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  int held;
  cudaError_t e = resident_blocks<T, MG, PAGED, DK>(smem, &held);
  if (e != cudaSuccess) return e;
  const long long rows = (long long)a.B * a.KVH;
  int grid_z = (int)((held + rows - 1) / rows);
  if (kGridSplits > 0) grid_z = kGridSplits;
  grid_z = grid_z < a.Z ? grid_z : a.Z;
  if (grid_z > 65535) return cudaErrorInvalidValue;
  dim3 grid(a.KVH, a.B, grid_z);
  decode_split<T, MG, PAGED, DK><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, bool PAGED, int DK>
cudaError_t dispatch_g(const DecodeArgs& a, cudaStream_t stream) {
  if (a.G == 1) return launch<T, 1, PAGED, DK>(a, stream);
  if (a.G == 2) return launch<T, 2, PAGED, DK>(a, stream);
  if (a.G <= 4) return launch<T, 4, PAGED, DK>(a, stream);
  if (a.G <= 8) return launch<T, 8, PAGED, DK>(a, stream);
  return launch<T, 16, PAGED, DK>(a, stream);
}

template <typename T, bool PAGED>
cudaError_t dispatch(const DecodeArgs& a, cudaStream_t stream) {
  if (a.D == 32 && a.Dv == 32) return dispatch_g<T, PAGED, 32>(a, stream);
  return dispatch_g<T, PAGED, 0>(a, stream);
}

bool aligned16(const void* p) {
  return p == nullptr || reinterpret_cast<size_t>(p) % 16 == 0;
}

template <bool PAGED>
int run(DecodeArgs& a, int dtype, void* stream) {
  if (a.B == 0 || a.KVH == 0) return cudaSuccess;
  if (a.G < 1 || a.G > kMaxG || a.span < 1 || a.span > kMaxSpan || a.S < 1 ||
      (a.k_new == nullptr) != (a.v_new == nullptr))
    return cudaErrorInvalidValue;
  a.Z = (a.S + a.span - 1) / a.span;
  if (a.B > 65535 || (a.Z > 1 && (a.part == nullptr || a.arrivals == nullptr)))
    return cudaErrorInvalidValue;
  const size_t esz = dtype == 0 ? 4 : 2;
  a.vec_k = (a.D * esz) % 16 == 0 && aligned16(a.k) && aligned16(a.k_new);
  a.vec_v = (a.Dv * esz) % 16 == 0 && aligned16(a.v) && aligned16(a.v_new);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float, PAGED>(a, s);
  if (dtype == 1) return dispatch<__nv_bfloat16, PAGED>(a, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. k_new / v_new null: no row is written.
// part: (B, KVH, ceil(S / span), G, Dv + 2) float32 (unused when S <= span);
// arrivals: B * KVH int32 zeros, left zero. Returns the cudaError_t of the
// launch.
extern "C" int flash_decode_fwd(const void* q, void* k, void* v,
                                const void* lengths, const void* phi_q,
                                const void* phi_k, const void* slopes,
                                const void* k_new, const void* v_new,
                                void* out, void* part, void* arrivals,
                                int dtype, int B, int KVH, int G, int S, int D,
                                int Dv, int R, int span, float scale,
                                void* stream) {
  DecodeArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.lengths = static_cast<const int*>(lengths);
  a.phi_q = static_cast<const float*>(phi_q);
  a.phi_k = static_cast<const float*>(phi_k);
  a.slopes = static_cast<const float*>(slopes);
  a.k_new = k_new;
  a.v_new = v_new;
  a.out = out;
  a.part = static_cast<float*>(part);
  a.arrivals = static_cast<int*>(arrivals);
  a.B = B;
  a.KVH = KVH;
  a.G = G;
  a.S = S;
  a.D = D;
  a.Dv = Dv;
  a.R = R;
  a.span = span;
  a.scale = scale;
  return run<false>(a, dtype, stream);
}

// Paged decode: pools (KVH, n_pages, ps, D|Dv), page_table (B, P) int32,
// phi slab (phi_heads, n_pages, ps, R) with phi_heads 1 or KVH; part sized
// from S = P * ps.
extern "C" int flash_decode_paged_fwd(
    const void* q, void* k_pages, void* v_pages, const void* lengths,
    const void* page_table, const void* phi_q, const void* phi_pages,
    const void* slopes, const void* k_new, const void* v_new, void* out,
    void* part, void* arrivals, int dtype, int B, int KVH, int G, int P,
    int n_pages, int ps, int D, int Dv, int R, int phi_heads, int span,
    float scale, void* stream) {
  DecodeArgs a{};
  a.q = q;
  a.k = k_pages;
  a.v = v_pages;
  a.lengths = static_cast<const int*>(lengths);
  a.phi_q = static_cast<const float*>(phi_q);
  a.phi_k = static_cast<const float*>(phi_pages);
  a.slopes = static_cast<const float*>(slopes);
  a.k_new = k_new;
  a.v_new = v_new;
  a.out = out;
  a.part = static_cast<float*>(part);
  a.arrivals = static_cast<int*>(arrivals);
  a.page_table = static_cast<const int*>(page_table);
  a.B = B;
  a.KVH = KVH;
  a.G = G;
  a.S = P * ps;
  a.D = D;
  a.Dv = Dv;
  a.R = R;
  a.P = P;
  a.n_pages = n_pages;
  a.ps = ps;
  a.phi_heads = phi_heads;
  a.span = span;
  a.scale = scale;
  if (P < 1 || n_pages < 1 || ps < 1) return cudaErrorInvalidValue;
  return run<true>(a, dtype, stream);
}

// Dynamic shared memory one launch needs, for the wrappers' size check.
extern "C" long long flash_decode_smem_bytes(int G, int D, int Dv, int R,
                                             int span, int dtype) {
  const Layout L = dtype == 0 ? make_layout<float>(span, G, D, Dv, R)
                              : make_layout<__nv_bfloat16>(span, G, D, Dv, R);
  return (long long)L.total;
}
