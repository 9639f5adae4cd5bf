// Single-token flash-decoding against a contiguous or a paged KV cache, for
// Hopper (sm_90a).
//
// Replaces: repro/kernels/flash_decode.py::flash_decode_fwd (body
// _decode_kernel) and ::flash_decode_paged_fwd (the same body behind index
// maps that resolve pages), the Pallas TPU kernels that decode reaches
// through ops.flash_decode. Same function: the G q-heads of one kv head
// attend to that head's cache rows 0 .. lengths[b]-1 with an online float32
// softmax of
//   s = q.k^T * scale + bias,
// the bias being phi (phi_q . phi_k^T, read as float32), ALiBi
// slope * (k_pos - (lengths[b] - 1)) generated in the kernel, or none. Masked
// logits take -0.7*FLT_MAX, and a row with length 0 writes 0, as on the TPU.
//
// Paged: the caches are a shared pool (KVH, n_pages, ps, D|Dv) and the phi
// factors a slab (1|KVH, n_pages, ps, R); row b's logical key j lives on page
// page_table[b, min(j / ps, last)] (last = (max(len-1, 0)) / ps), clipped
// into [0, n_pages), at offset j % ps. A slab with a leading 1 is shared by
// every kv head (head stride 0). As on the TPU, the two modes share one body
// and differ only in how a key's row is found (key_rows below); a lane
// resolves its own key's row once, and the v loop takes other keys' rows
// from their lanes by shuffle.
//
// What bounds it on the H100: memory. Every live cache row is read once
// (k and v, D + Dv values each) and each row feeds only G multiply-adds per
// channel, far below the ~295 operations per byte the card needs before its
// arithmetic is the limit. At the GPT-2-ALiBi-1.5B decode shape (B=4 slots,
// KVH=64, G=1, head_dim 32, bf16) the bytes are ~128 B per live position per
// head (plus 8 B of slab per position when paged), so the least time is the
// live cache size over 3.35 TB/s.
//
// Design, simple first: one block of 8 warps per (b, kv head), so GPT-2 runs
// B*KVH = 256 blocks. The block walks only the live rows (keys at or past
// lengths[b] are never read, which replaces the TPU kernel's pl.when block
// skipping); warp w takes the 32-key chunks w, w+8, ..., a lane owns one key
// of a chunk (a chunk may span several pages, or part of one), reads its k
// row with 16-byte loads where the row is aligned, and computes its logit
// for each of the G rows from q staged in shared memory; the warp reduces
// max and sum with shuffles and accumulates the output dims lane, lane+32,
// ... from coalesced v rows, eight keys' loads in flight at a time (a decode
// step is latency-bound: few blocks, so each warp must keep several loads
// outstanding). The eight warps' partial (m, l, acc) are merged by
// log-sum-exp in shared memory at the end. Splitting the cache across
// blocks (split-KV) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr float kMaskValue = -0.7f * 3.4028234663852886e38f;
constexpr int kWarps = 8;
constexpr int kVBatch = 8;                   // v rows loaded per batch
constexpr int kThreads = kWarps * 32;
constexpr int kMaxG = 8;                     // q heads per kv head

struct DecodeArgs {
  const void* q;          // (B, KVH, G, D)
  const void* k;          // (B, KVH, S, D) | pool (KVH, n_pages, ps, D)
  const void* v;          // (B, KVH, S, Dv) | pool (KVH, n_pages, ps, Dv)
  const int* lengths;     // (B,)
  const float* phi_q;     // (B, KVH, G, R) or null
  const float* phi_k;     // (B, KVH, S, R) | slab (1|KVH, n_pages, ps, R)
  const float* slopes;    // (KVH, G) or null
  void* out;              // (B, KVH, G, Dv)
  const int* page_table;  // paged: (B, P)
  int B, KVH, G, S, D, Dv, R;  // paged: S = P * ps, the longest view
  int P, n_pages, ps;          // paged only
  int phi_heads;               // paged only: 1 (shared slab) or KVH
  float scale;
};

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
// 16 bytes of T as float32: 4 floats or 8 bfloat16s (p 16-byte aligned).
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

__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
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

// Rows of key j of (b, h): kv indexes the k/v arrays in rows of D (Dv)
// values, phi the phi_k array in rows of R. `last` is the last in-length
// logical block (paged only).
template <bool PAGED>
__device__ __forceinline__ void key_rows(const DecodeArgs& a, int b, int h,
                                         int j, int last, long long& kv,
                                         long long& phi) {
  if (!PAGED) {
    kv = ((long long)b * a.KVH + h) * a.S + j;
    phi = kv;
  } else {
    int page = a.page_table[(long long)b * a.P + min(j / a.ps, last)];
    page = min(max(page, 0), a.n_pages - 1);
    const long long in_pool = (long long)page * a.ps + j % a.ps;
    const long long head = (long long)a.n_pages * a.ps;
    kv = h * head + in_pool;
    phi = (a.phi_heads == 1 ? 0 : h * head) + in_pool;
  }
}

size_t smem_floats(const DecodeArgs& a) {
  return (size_t)a.G * a.D + (size_t)a.G * a.R + 2 * kWarps * kMaxG +
         (size_t)kWarps * a.G * a.Dv;
}

template <typename T, int DC, bool PAGED>
__global__ void __launch_bounds__(kThreads) decode_fwd(DecodeArgs a) {
  extern __shared__ float smem[];
  const int G = a.G, D = a.D, Dv = a.Dv, R = a.R;
  float* sQ = smem;                       // G x D
  float* sPQ = sQ + G * D;                // G x R
  float* sM = sPQ + G * R;                // kWarps x kMaxG
  float* sL = sM + kWarps * kMaxG;        // kWarps x kMaxG
  float* sAcc = sL + kWarps * kMaxG;      // kWarps x G x Dv

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.x, b = blockIdx.y;
  const size_t bh = (size_t)b * a.KVH + h;
  const T* qb = static_cast<const T*>(a.q) + bh * G * D;
  const T* kp = static_cast<const T*>(a.k);
  const T* vp = static_cast<const T*>(a.v);
  const int len = min(max(a.lengths[b], 0), a.S);
  const int last = PAGED ? max(len - 1, 0) / a.ps : 0;

  for (int i = tid; i < G * D; i += kThreads) sQ[i] = load_f32(qb + i);
  for (int i = tid; i < G * R; i += kThreads) sPQ[i] = a.phi_q[bh * G * R + i];
  __syncthreads();

  float m[kMaxG], l[kMaxG], acc[kMaxG][DC];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    m[g] = -CUDART_INF_F;
    l[g] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[g][c] = 0.f;
  }

  constexpr int kVec = 16 / sizeof(T);
  const bool vec_k = (D % kVec) == 0 &&
                     (reinterpret_cast<size_t>(kp) % 16) == 0;
  for (int base = warp * 32; base < len; base += kWarps * 32) {
    const int j = base + lane;
    const bool valid = j < len;
    long long row, phi_row;                 // lanes past len read `base`
    key_rows<PAGED>(a, b, h, valid ? j : base, last, row, phi_row);
    const T* kr = kp + row * D;
    float s[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) s[g] = 0.f;
    if (vec_k) {
#pragma unroll 4
      for (int d = 0; d < D; d += kVec) {
        float kv[kVec];
        load16(kr + d, kv);
#pragma unroll
        for (int e = 0; e < kVec; ++e)
#pragma unroll
          for (int g = 0; g < kMaxG; ++g)
            if (g < G) s[g] = fmaf(sQ[g * D + d + e], kv[e], s[g]);
      }
    } else {
      for (int d = 0; d < D; ++d) {
        const float kd = load_f32(kr + d);
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
          if (g < G) s[g] = fmaf(sQ[g * D + d], kd, s[g]);
      }
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < G) {  // uniform across the warp
        float x = s[g] * a.scale;
        if (R) {
          const float* pk = a.phi_k + phi_row * R;
          float bias = 0.f;
          for (int c = 0; c < R; ++c) bias = fmaf(sPQ[g * R + c], pk[c], bias);
          x += bias;
        }
        if (a.slopes) x += a.slopes[h * G + g] * (float)(j - (len - 1));
        x = valid ? x : kMaskValue;
        const float m_new = fmaxf(m[g], warp_max(x));
        const float corr = expf(m[g] - m_new);
        const float p = expf(x - m_new);
        l[g] = l[g] * corr + warp_sum(p);
        m[g] = m_new;
        s[g] = p;  // rows at or past len have p = 0
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[g][c] *= corr;
      }
    }
    const int n_keys = min(32, len - base);
    for (int j0 = 0; j0 < n_keys; j0 += kVBatch) {
      float vd[kVBatch][DC];
#pragma unroll
      for (int u = 0; u < kVBatch; ++u) {
        const long long vrow = __shfl_sync(0xffffffffu, row, j0 + u);
        const T* vr = vp + vrow * Dv;
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const int d = lane + 32 * c;
          vd[u][c] = (j0 + u < n_keys && d < Dv) ? load_f32(vr + d) : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kVBatch; ++u) {
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) {
          if (g < G) {
            const float pg = __shfl_sync(0xffffffffu, s[g], j0 + u);
#pragma unroll
            for (int c = 0; c < DC; ++c) acc[g][c] = fmaf(pg, vd[u][c], acc[g][c]);
          }
        }
      }
    }
  }

  // merge the warps' partial softmax states (log-sum-exp)
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g < G) {
      if (lane == 0) {
        sM[warp * kMaxG + g] = m[g];
        sL[warp * kMaxG + g] = l[g];
      }
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int d = lane + 32 * c;
        if (d < Dv) sAcc[((size_t)warp * G + g) * Dv + d] = acc[g][c];
      }
    }
  }
  __syncthreads();
  T* ob = static_cast<T*>(a.out) + bh * G * Dv;
  for (int i = tid; i < G * Dv; i += kThreads) {
    const int g = i / Dv, d = i - g * Dv;
    float mx = -CUDART_INF_F;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sM[w * kMaxG + g]);
    float lsum = 0.f, asum = 0.f;
    if (mx != -CUDART_INF_F) {
      for (int w = 0; w < kWarps; ++w) {
        const float wt = expf(sM[w * kMaxG + g] - mx);
        lsum = fmaf(sL[w * kMaxG + g], wt, lsum);
        asum = fmaf(sAcc[((size_t)w * G + g) * Dv + d], wt, asum);
      }
    }
    store_f32(ob + i, lsum == 0.f ? 0.f : asum / lsum);
  }
}

template <typename T, int DC, bool PAGED>
cudaError_t launch(const DecodeArgs& a, cudaStream_t stream) {
  const size_t smem = smem_floats(a) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_fwd<T, DC, PAGED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid(a.KVH, a.B);
  decode_fwd<T, DC, PAGED><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, bool PAGED>
cudaError_t dispatch(const DecodeArgs& a, cudaStream_t stream) {
  switch ((a.Dv + 31) / 32) {
    case 1: return launch<T, 1, PAGED>(a, stream);
    case 2: return launch<T, 2, PAGED>(a, stream);
    case 3: return launch<T, 3, PAGED>(a, stream);
    case 4: return launch<T, 4, PAGED>(a, stream);
    case 5: return launch<T, 5, PAGED>(a, stream);
    case 6: return launch<T, 6, PAGED>(a, stream);
    case 7: return launch<T, 7, PAGED>(a, stream);
    case 8: return launch<T, 8, PAGED>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <bool PAGED>
int run(const DecodeArgs& a, int dtype, void* stream) {
  if (a.B == 0 || a.KVH == 0) return cudaSuccess;
  if (a.G < 1 || a.G > kMaxG) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float, PAGED>(a, s);
  if (dtype == 1) return dispatch<__nv_bfloat16, PAGED>(a, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. Returns the cudaError_t of the launch.
extern "C" int flash_decode_fwd(const void* q, const void* k, const void* v,
                                const void* lengths, const void* phi_q,
                                const void* phi_k, const void* slopes, void* out,
                                int dtype, int B, int KVH, int G, int S, int D,
                                int Dv, int R, float scale, void* stream) {
  DecodeArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.lengths = static_cast<const int*>(lengths);
  a.phi_q = static_cast<const float*>(phi_q);
  a.phi_k = static_cast<const float*>(phi_k);
  a.slopes = static_cast<const float*>(slopes);
  a.out = out;
  a.B = B;
  a.KVH = KVH;
  a.G = G;
  a.S = S;
  a.D = D;
  a.Dv = Dv;
  a.R = R;
  a.scale = scale;
  return run<false>(a, dtype, stream);
}

// Paged decode: pools (KVH, n_pages, ps, D|Dv), page_table (B, P) int32,
// phi slab (phi_heads, n_pages, ps, R) with phi_heads 1 or KVH.
extern "C" int flash_decode_paged_fwd(
    const void* q, const void* k_pages, const void* v_pages,
    const void* lengths, const void* page_table, const void* phi_q,
    const void* phi_pages, const void* slopes, void* out, int dtype, int B,
    int KVH, int G, int P, int n_pages, int ps, int D, int Dv, int R,
    int phi_heads, float scale, void* stream) {
  DecodeArgs a{};
  a.q = q;
  a.k = k_pages;
  a.v = v_pages;
  a.lengths = static_cast<const int*>(lengths);
  a.phi_q = static_cast<const float*>(phi_q);
  a.phi_k = static_cast<const float*>(phi_pages);
  a.slopes = static_cast<const float*>(slopes);
  a.out = out;
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
  a.scale = scale;
  if (P < 1 || n_pages < 1 || ps < 1) return cudaErrorInvalidValue;
  return run<true>(a, dtype, stream);
}

// Dynamic shared memory one launch needs, for the wrappers' size check.
extern "C" long long flash_decode_smem_bytes(int G, int D, int Dv, int R) {
  DecodeArgs a{};
  a.G = G;
  a.D = D;
  a.Dv = Dv;
  a.R = R;
  return (long long)(smem_floats(a) * sizeof(float));
}
