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
//   phi   : phi_q . phi_k^T           (rank-R factors, read as float32)
//   alibi : slope[h] * (k_pos - q_pos) (generated in the kernel, no bias IO)
//   none
// and the mask (none / causal / local(window), plus kv_len) is computed from
// positions. Masked logits take -0.7*FLT_MAX (not -inf), m starts at -inf, and
// a row whose sum l stays 0 writes 0, exactly as the TPU kernel does.
//
// What bounds it on the H100: at the prefill shape of GPT-2-ALiBi-1.5B
// (B=4, H=64, N=M=512, D=32, bf16, causal) the bytes that must move are
// q, k, v and o once (~34 MB, ~10 us at 3.35 TB/s), and the causal work is
// ~4.3 GFLOP (~4.4 us on the bf16 tensor cores). At the Pairformer's pair
// shape (B=4 slots, H=4, N=M=384, D=Dv=R=96, bf16 q/k/v, float32 factors)
// the bytes are ~4.7 MB (~1.4 us) and the work of the live rows a few
// GFLOP. Both bounds are tiny; this kernel is instead bound by its own
// arithmetic: it runs on the float32 FMA units from shared memory, without
// tensor cores, and at the pair shape on 96 blocks, fewer than the 132 SMs.
//
// Design, simple first: one block of 8 warps per (b, h, 64-row q tile). The
// q tile, one 64-key k/v tile (and the phi tiles) are staged in shared memory
// as float32; k rows are padded by one word so the lanes of a warp, each on
// its own key, read distinct banks. Each warp owns 8 q rows: a lane computes
// the logits of 2 keys, the warp reduces max and sum with shuffles, writes
// the 64 probabilities to shared memory, and each lane accumulates the output
// dims lane, lane+32, ... in registers (DC = ceil(Dv/32), a template
// parameter, so head_dim 32 and 160 both run, with masked edges). The kv loop
// of a q tile only visits tiles the mask can reach (causal: k_start <= q_end;
// local: also k_end >= q_start - (window-1); none: k_start < kv_len), which
// replaces the TPU kernel's pl.when block pruning. wgmma, TMA and pipelining
// are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

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
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
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

int run(const AttnArgs& a, int dtype, void* stream) {
  if (a.B == 0 || a.H == 0 || a.N == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(a, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(a, s);
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

// Dynamic shared memory one launch needs, for the wrapper's size check.
extern "C" long long flashbias_attn_smem_bytes(int D, int Dv, int R) {
  AttnArgs a{};
  a.D = D;
  a.Dv = Dv;
  a.R = R;
  return (long long)(smem_floats(a) * sizeof(float));
}
