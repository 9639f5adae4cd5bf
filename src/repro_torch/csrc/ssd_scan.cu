// Mamba2 SSD chunk scan forward, for Hopper (sm_90a).
//
// Replaces: repro/kernels/ssd_scan.py::ssd_scan_fwd (body _ssd_kernel), the
// Pallas TPU kernel that keeps the intra-chunk decay and weight tensors on
// chip and carries the (P, N) state in scratch across the sequential chunk
// axis. Same function, per (b, h), for chunks of Q positions in order:
//   cum   = cumsum(dt * a)                          inclusive, within the chunk
//   y_i   = sum_{j<=i} (c_i . b_j) exp(cum_i - cum_j) dt_j x_j
//           + exp(cum_i) (c_i . h^T)                h: the state BEFORE the chunk
//   h     = exp(cum_last) h + sum_j exp(cum_last - cum_j) dt_j x_j (x) b_j
// It also takes an optional h0 (the TPU kernel starts its scratch at zero)
// and writes the final state h_fin, which the model's prefill caches. S
// need not be a multiple of Q: the last chunk is bounded by its length L,
// and rows past L read as zeros (dt = 0 there), so they change neither y
// nor h_fin.
//
// What bounds it on the H100: at the SSM prefill shape of mamba2-130m (B=4,
// H=32, S=4096, P=64, N=128, float32, one b/c group) the bytes that must
// move are x and y (134 MB each), b and c (17 MB), dt, h_fin: ~0.29 GB,
// ~0.087 ms at 3.35 TB/s; the causal work is ~43 GFLOP, ~0.044 ms at the
// tensor cores' 989 TFLOP/s. So the function is bound by bytes.
//
// Two bodies, chosen in run() by shape:
//
// Tensor cores (P and N multiples of 16 up to 128 and 256, Q a multiple of
// 64, the path's shape among them): the SSD paper's own decomposition (Dao
// & Gu, arXiv:2405.21060), chunk-parallel. The TPU's sequential chunk axis
// is broken into four kernels on the caller's stream, which hand each
// other float32 scratch and operand tiles already split for the tensor
// cores:
//  1. ssd_cb (one b/c group only), one warpgroup per (b, chunk, 64 x 64
//     tile at or below the diagonal): C B^T once for every head, into a
//     (B, nc, nt, nt, 64 x 64) scratch in the accumulator's own register
//     order, so that writer and reader move whole float4 rows; it also
//     stores the split C tiles (for the scan) and B^T tiles (for 2.).
//  2. ssd_states, one warpgroup per (b, h, chunk, 64 p x 128 n panel): the
//     chunk's cumsum and S_c = (exp(cum_last - cum) dt X)^T B, a product of
//     depth <= Q, into (B, H, nc, P, N); exp(cum_last) into (B, H, nc);
//     and the split X^T tiles, for the scan.
//  3. ssd_state_pass, one thread per four (b, h, p, n): the short walk over
//     the nc chunk states, h = exp(cum_last) h + S_c from h0 on, storing
//     the state before each chunk, split, for the scan, and h_fin.
//  4. ssd_chunk_scan, one warpgroup per (b, h, chunk, 64-row query tile):
//     Y = exp(cum_i) (C h_prev^T), then per key tile j <= i the weights
//     W = (C B^T) . exp(cum_i - cum_j) . dt_j, exp taken only under the
//     mask (above the diagonal cum_i - cum_j > 0 may overflow and inf * 0
//     is NaN), and Y += W X. With per-head b / c the scan splits C and B
//     and computes C B^T itself, and ssd_states splits B^T.
// Products: wgmma m64n64k16 on bf16 operands with float32 accumulators.
// Each float32 operand v is split into hi = bf16(v) and lo = bf16(v - hi),
// and a product is hi.hi + hi.lo + lo.hi (lo.lo and lo's own rounding,
// < 2^-16 relative per term, are left out), kernel 2's method: float32-
// level accuracy, where one bf16 pass (2^-9 per term) would not meet the
// float32 tolerance of 1e-4 at the output's scale. bf16 x has no lo part.
// Every operand tile is stored split in the K-major interleaved layout (8 x
// 8 core matrices of 128 contiguous bytes), by the kernel that first reads
// the data; a kernel that uses it again takes each tile into shared memory
// with one bulk copy (cp.async.bulk on an mbarrier). W never leaves
// registers: it is split there into the A fragments of register-sourced
// wgmma, with X^T as the K-major B operand. The lane-to-element maps of
// every tile store give each warp 32 distinct banks.
// At the path shape the four kernels take 0.44 ms on an H100 (80GB HBM3,
// 700 W; PERF.md), 5x the bytes bound: the design moves ~0.9 GB through
// device memory, and the scan's blocks, each a chain of copies and
// products, are latency-bound (none of its loads alone costs over 5%).
//
// CUDA cores (every other shape): ssd_fwd, one block of 8 warps per (b, h)
// walks the chunks in order and keeps the state h (P x N float32) in
// shared memory for the whole sequence, tiled in 64-row query and key
// tiles (j <= i only), with the four products as register-tiled float32
// FMAs from shared memory. Only after every query tile of a chunk has read
// the old state is it decayed and the chunk's update added.
//
// x and y are read and written through their strides (the model's
// (B, S, H, P) layout, no transposes) by both bodies, and a single b / c
// group is read by every head, never broadcast in memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include "sm90_wgmma.cuh"

namespace {

// ---------------------------------------------------------------------------
// CUDA-core body (and the arguments both bodies take)
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kTQ = 64;  // query rows per tile
constexpr int kTK = 64;  // key rows per tile

struct ScanArgs {
  const void* x;       // (B, H, S, P) through strides, float32 or bfloat16
  const float* dt;     // (B, H, S) through strides
  const float* a;      // (H,)
  const float* b;      // (B, G, S, N) through strides, G = 1 or H
  const float* c;      // (B, G, S, N) through strides
  const float* h0;     // (B, H, P, N) contiguous, or null (zeros)
  void* y;             // (B, H, S, P) through strides, x's dtype
  float* h_fin;        // (B, H, P, N) contiguous
  int B, H, S, P, N, G, Q;
  long long xs_b, xs_h, xs_s;
  long long ds_b, ds_h, ds_s;
  long long bs_b, bs_h, bs_s;
  long long cs_b, cs_h, cs_s;
  long long ys_b, ys_h, ys_s;
};

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// The chunk arrays are padded to whole 64-row tiles.
__host__ __device__ inline int padded_chunk(int Q) { return (Q + kTQ - 1) / kTQ * kTQ; }

size_t smem_floats(int P, int N, int Q) {
  const size_t N1 = N + 1, P1 = P + 1, K1 = kTK + 1;
  return (size_t)P * N1 + (size_t)(kTQ + kTK) * N1 + (size_t)kTK * P1 +
         (size_t)kTQ * K1 + (size_t)kTQ * P1 + 2 * (size_t)padded_chunk(Q);
}

// out (M x Nc, leading dim ldo) = [out +] A (M x K) @ B (K x Nc), all in
// shared memory, A(i, k) = A[i * a_si + k * a_sk], B(k, j) = B[k * b_sk +
// j * b_sj]. M and Nc are multiples of 4; a thread owns rows ti + r * M/4 and
// columns tj + c * Nc/4 (r, c < 4).
template <bool kAcc>
__device__ __forceinline__ void mm(float* out, int ldo, int M, int Nc, int K,
                                   const float* A, int a_si, int a_sk,
                                   const float* Bm, int b_sk, int b_sj) {
  const int gm = M >> 2, gn = Nc >> 2;
  for (int t = threadIdx.x; t < gm * gn; t += kThreads) {
    const int ti = t / gn, tj = t - ti * gn;
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
    const float* ap = A + ti * a_si;
    const float* bp = Bm + tj * b_sj;
    const int ar = gm * a_si, bc = gn * b_sj;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) av[r] = ap[r * ar + k * a_sk];
#pragma unroll
      for (int c = 0; c < 4; ++c) bv[c] = bp[k * b_sk + c * bc];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float* o = out + (ti + r * gm) * ldo + tj + c * gn;
        *o = kAcc ? *o + acc[r][c] : acc[r][c];
      }
  }
}

// rows [row0, row0 + rows) of a (S, width) slab with unit column stride into
// a tile of tile_rows rows (leading dim ld); rows past `rows` are zero.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src,
                                          long long row_stride, int row0,
                                          int rows, int tile_rows, int width) {
  for (int i = threadIdx.x; i < tile_rows * width; i += kThreads) {
    const int r = i / width, col = i - r * width;
    dst[r * ld + col] =
        r < rows ? load_f32(src + (long long)(row0 + r) * row_stride + col) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_fwd(ScanArgs a) {
  extern __shared__ float smem[];
  const int P = a.P, N = a.N, Q = a.Q, Qp = padded_chunk(a.Q);
  const int N1 = N + 1, P1 = P + 1, K1 = kTK + 1;
  float* sH = smem;              // P x (N + 1)     the carried state
  float* sC = sH + P * N1;       // kTQ x (N + 1)   c rows of the query tile
  float* sB = sC + kTQ * N1;     // kTK x (N + 1)   b rows of the key tile
  float* sX = sB + kTK * N1;     // kTK x (P + 1)   x rows of the key tile
  float* sW = sX + kTK * P1;     // kTQ x (kTK + 1) logits, then weights
  float* sY = sW + kTQ * K1;     // kTQ x (P + 1)   y rows of the query tile
  float* sDt = sY + kTQ * P1;    // Qp              dt of the chunk
  float* sCum = sDt + Qp;        // Qp              inclusive cumsum of dt * a

  const int tid = threadIdx.x;
  const int h = blockIdx.x, bi = blockIdx.y;
  const int g = a.G == 1 ? 0 : h;
  const T* xb = static_cast<const T*>(a.x) + bi * a.xs_b + h * a.xs_h;
  const float* db = a.dt + bi * a.ds_b + h * a.ds_h;
  const float* bb = a.b + bi * a.bs_b + g * a.bs_h;
  const float* cb = a.c + bi * a.cs_b + g * a.cs_h;
  T* yb = static_cast<T*>(a.y) + bi * a.ys_b + h * a.ys_h;
  const float rate = a.a[h];
  const size_t hoff = ((size_t)bi * a.H + h) * P * N;

  for (int i = tid; i < P * N; i += kThreads) {
    const int p = i / N, n = i - p * N;
    sH[p * N1 + n] = a.h0 ? a.h0[hoff + i] : 0.f;
  }

  for (int s0 = 0; s0 < a.S; s0 += Q) {
    const int L = min(Q, a.S - s0);
    __syncthreads();  // the previous chunk's readers of sDt, sCum, sB, sX are done
    for (int j = tid; j < Qp; j += kThreads)
      sDt[j] = j < L ? db[(long long)(s0 + j) * a.ds_s] : 0.f;
    __syncthreads();
    if (tid < 32) {  // one warp: a serial run per lane, then a shuffle scan
      const int per = Qp / 32, base = tid * per;
      float run = 0.f;
      for (int k = 0; k < per; ++k) {
        run += sDt[base + k] * rate;
        sCum[base + k] = run;
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, incl, o);
        if (tid >= o) incl += t;
      }
      const float excl = incl - run;
      for (int k = 0; k < per; ++k) sCum[base + k] += excl;
    }
    __syncthreads();
    const float cum_last = sCum[L - 1];

    const int n_tiles = (L + kTQ - 1) / kTQ;
    for (int qt = 0; qt < n_tiles; ++qt) {
      const int q0 = qt * kTQ, q_rows = min(kTQ, L - q0);
      load_rows(sC, N1, cb, a.cs_s, s0 + q0, q_rows, kTQ, N);
      __syncthreads();  // sC written; the last tile's y rows are stored
      mm<false>(sY, P1, kTQ, P, N, sC, N1, 1, sH, 1, N1);  // C h^T
      __syncthreads();
      for (int i = tid; i < kTQ * P; i += kThreads) {
        const int r = i / P, col = i - r * P;
        sY[r * P1 + col] *= expf(sCum[q0 + r]);
      }
      for (int kt = 0; kt <= qt; ++kt) {
        const int k0 = kt * kTK, k_rows = min(kTK, L - k0);
        load_rows(sB, N1, bb, a.bs_s, s0 + k0, k_rows, kTK, N);
        load_rows(sX, P1, xb, a.xs_s, s0 + k0, k_rows, kTK, P);
        __syncthreads();
        mm<false>(sW, K1, kTQ, kTK, N, sC, N1, 1, sB, 1, N1);  // C B^T
        __syncthreads();
        for (int i = tid; i < kTQ * kTK; i += kThreads) {
          const int r = i / kTK, j = i - r * kTK;
          const int gi = q0 + r, gj = k0 + j;
          float w = 0.f;
          if (gj <= gi && gj < L)  // exp only under the mask
            w = sW[r * K1 + j] * expf(sCum[gi] - sCum[gj]) * sDt[gj];
          sW[r * K1 + j] = w;
        }
        __syncthreads();
        mm<true>(sY, P1, kTQ, P, kTK, sW, K1, 1, sX, P1, 1);  // Y += W X
        __syncthreads();
      }
      for (int i = tid; i < q_rows * P; i += kThreads) {
        const int r = i / P, col = i - r * P;
        store_f32(yb + (long long)(s0 + q0 + r) * a.ys_s + col, sY[r * P1 + col]);
      }
    }

    // every query tile has read the state before the chunk: now advance it
    const float decay = expf(cum_last);
    for (int i = tid; i < P * N; i += kThreads) {
      const int p = i / N, n = i - p * N;
      sH[p * N1 + n] *= decay;
    }
    for (int k0 = 0; k0 < L; k0 += kTK) {
      const int k_rows = min(kTK, L - k0);
      __syncthreads();  // the previous key tile's product is done
      load_rows(sB, N1, bb, a.bs_s, s0 + k0, k_rows, kTK, N);
      for (int i = tid; i < kTK * P; i += kThreads) {
        const int r = i / P, col = i - r * P;
        float v = 0.f;
        if (r < k_rows) {
          const float sdec = expf(cum_last - sCum[k0 + r]) * sDt[k0 + r];
          v = sdec * load_f32(xb + (long long)(s0 + k0 + r) * a.xs_s + col);
        }
        sX[r * P1 + col] = v;
      }
      __syncthreads();
      mm<true>(sH, N1, P, N, kTK, sX, 1, P1, sB, N1, 1);  // h += X^T (sdec B)
    }
  }

  __syncthreads();
  for (int i = tid; i < P * N; i += kThreads) {
    const int p = i / N, n = i - p * N;
    a.h_fin[hoff + i] = sH[p * N1 + n];
  }
}

template <typename T>
cudaError_t launch(const ScanArgs& a, cudaStream_t stream) {
  const size_t smem = smem_floats(a.P, a.N, a.Q) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        ssd_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid(a.H, a.B);
  ssd_fwd<T><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// tensor-core body
// ---------------------------------------------------------------------------

constexpr int kT = 64;            // rows of a tensor-core tile
constexpr int kWg = 128;          // one warpgroup per block
constexpr int kNPanel = 128;      // state columns (n) per block of ssd_states
constexpr int kNH = kNPanel / 64;  // its m64n64 accumulators
constexpr int kTileFloats = kT * kT;
// With one b/c group, ssd_cb makes C B^T and the split C and B^T tiles once
// per (b, chunk) for every head; otherwise (per-head b / c) the states and
// scan kernels split B and C and compute C B^T themselves.
constexpr bool kCbScratch = true;

// The scratch arrays, in ssd_scan_plan's order. A split tile holds its bf16
// hi part, then its lo part, each in the K-major layout of kmaj_off.
struct TcArgs {
  ScanArgs s;
  float* states;    // (B, H, nc, P, N): the chunk states
  float* decay;     // (B, H, nc): exp(cum_last) of each chunk
  uint8_t* hprev;   // (B, H, nc) split tiles (dp p x N): the state before each chunk
  uint8_t* xsplit;  // (B, H, nc, nt, dp / 64) split tiles (64 p x 64 j): X^T
  float* cb;        // (B, nc, nt, nt, 64 x 64) C B^T tiles in register order; or null
  uint8_t* csplit;  // (B, nc, nt) split tiles (64 q x N): C; with cb
  uint8_t* bsplit;  // (B, nc, nt, npan) split tiles (128 n x 64 j): B^T; with cb
  int nc, nt, n16;  // chunks, 64-row tiles per chunk, N rounded up to 16 (= N)
  int dp, npan;     // P rounded up to 64; 128-column panels of N
};
constexpr int kScratch = 7;

// Bytes of a split tile: h (dp x N), C (64 x N), X^T (64 x 64), B^T (128 x 64).
__host__ __device__ inline size_t h_tile_bytes(int dp, int n16) { return (size_t)dp * n16 * 4; }
__host__ __device__ inline size_t c_tile_bytes(int n16) { return (size_t)kT * n16 * 4; }
constexpr int kXTile = kT * kT * 4;
constexpr int kBTile = kNPanel * kT * 4;

__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                    ~(uintptr_t)1023);
}

// Byte offset of element (r, k) of an R-row bf16 operand tile in the K-major
// interleaved layout: 8 x 8 core matrices of 128 contiguous bytes, 8-row
// groups 128 bytes apart (SBO), 8-column groups R * 16 apart (LBO).
template <int R>
__device__ __forceinline__ unsigned kmaj_off(int r, int k) {
  return (unsigned)((k >> 3) * (R * 16) + (r >> 3) * 128 + (r & 7) * 16 + (k & 7) * 2);
}

// Splits two adjacent elements into bf16 hi + lo and stores both parts.
__device__ __forceinline__ void store_split(uint8_t* hi, uint8_t* lo, unsigned off,
                                            float2 v) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
  const float2 hf = __bfloat1622float2(h);
  *reinterpret_cast<__nv_bfloat162*>(hi + off) = h;
  *reinterpret_cast<__nv_bfloat162*>(lo + off) =
      __floats2bfloat162_rn(v.x - hf.x, v.y - hf.y);
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ float2 load_f32x2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ void store_f32x2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_f32x2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// dt of rows [0, rows) of the chunk at s0 (0 past L) into sDt and the
// inclusive cumsum of dt * rate into sCum; rows is a multiple of 64. Ends
// with a block barrier.
__device__ void chunk_cum(float* sDt, float* sCum, const float* db, long long ds_s,
                          int s0, int L, int rows, float rate) {
  const int tid = threadIdx.x;
  for (int j = tid; j < rows; j += blockDim.x)
    sDt[j] = j < L ? db[(long long)(s0 + j) * ds_s] : 0.f;
  __syncthreads();
  if (tid < 32) {  // one warp: a serial run per lane, then a shuffle scan
    const int per = rows / 32, base = tid * per;
    float run = 0.f;
    for (int k = 0; k < per; ++k) {
      run += sDt[base + k] * rate;
      sCum[base + k] = run;
    }
    float incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float t = __shfl_up_sync(0xffffffffu, incl, o);
      if (tid >= o) incl += t;
    }
    const float excl = incl - run;
    for (int k = 0; k < per; ++k) sCum[base + k] += excl;
  }
  __syncthreads();
}

// The tile loaders below issue kBatch loads per thread before storing any of
// them, so that a thread has kBatch loads in flight, not one: loads waited
// for one at a time made a first version of this body 2x slower at the path
// shape (PERF.md).
constexpr int kBatch = 16;

// An R-row K-major tile (K16 columns) from a float32 slab whose rows are
// row_stride apart with unit column stride: rows past rows_valid and
// columns past K are zero. A warp writes 8 rows x 16 bytes of one column
// group, 128 contiguous bytes.
template <int R>
__device__ __forceinline__ void load_kmajor(uint8_t* hi, uint8_t* lo, const float* src,
                                            long long row_stride, int rows_valid,
                                            int K, int K16) {
  const int total = R * K16 / 2;
  for (int i0 = threadIdx.x; i0 < total; i0 += kWg * kBatch) {
    float2 v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kWg;
      const int r = (i >> 2) & (R - 1), k = (i >> 2) / R * 8 + (i & 3) * 2;
      v[u] = make_float2(0.f, 0.f);
      if (i < total && r < rows_valid && k < K)
        v[u] = load_f32x2(src + (long long)r * row_stride + k);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kWg;
      const int r = (i >> 2) & (R - 1), k = (i >> 2) / R * 8 + (i & 3) * 2;
      if (i < total) store_split(hi, lo, kmaj_off<R>(r, k), v[u]);
    }
  }
}

// The transposed R-row K-major tile of a (64 positions x R) slab: element
// (r, j) = src[j * row_stride + r] * scale[j] (scale null: 1), zero for
// j >= j_valid or r >= r_valid; hi and lo may be shared or global memory.
// With ex_hi non-null the unscaled tile is also stored there (and its lo
// part at ex_lo). A warp writes 8 rows x 4 column pairs, 128 contiguous
// bytes, distinct banks; it reads 8 consecutive r of 4 positions per load.
template <int R, typename T>
__device__ __forceinline__ void load_kmajor_t(uint8_t* hi, uint8_t* lo, const T* src,
                                              long long row_stride, int j_valid,
                                              int r_valid, const float* scale,
                                              uint8_t* ex_hi = nullptr,
                                              uint8_t* ex_lo = nullptr) {
  static_assert(R * kT / 2 % (kWg * kBatch / 2) == 0, "whole batches");
  for (int i0 = threadIdx.x; i0 < R * kT / 2; i0 += kWg * kBatch / 2) {
    float2 v[kBatch / 2];
#pragma unroll
    for (int u = 0; u < kBatch / 2; ++u) {
      const int i = i0 + u * kWg, rest = i >> 5;
      const int r = (rest & (R / 8 - 1)) * 8 + ((i >> 2) & 7);
      const int j = rest / (R / 8) * 8 + (i & 3) * 2;
      v[u] = make_float2(0.f, 0.f);
      if (r < r_valid) {
        if (j < j_valid) v[u].x = load_f32(src + (long long)j * row_stride + r);
        if (j + 1 < j_valid) v[u].y = load_f32(src + (long long)(j + 1) * row_stride + r);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch / 2; ++u) {
      const int i = i0 + u * kWg, rest = i >> 5;
      const int r = (rest & (R / 8 - 1)) * 8 + ((i >> 2) & 7);
      const int j = rest / (R / 8) * 8 + (i & 3) * 2;
      if (ex_hi) store_split(ex_hi, ex_lo, kmaj_off<R>(r, j), v[u]);
      if (scale) {
        v[u].x *= scale[j];
        v[u].y *= scale[j + 1];
      }
      store_split(hi, lo, kmaj_off<R>(r, j), v[u]);
    }
  }
}

__device__ __forceinline__ uint64_t kdesc(uint32_t addr, int rows) {
  return sm90::make_desc(addr, rows * 16, 128, sm90::kInterleave);
}

// acc (64 x 64) = A.B^T over K16 columns, A and B 64-row K-major split
// tiles: hi.hi + hi.lo + lo.hi, 3 * K16 / 16 wgmma m64n64k16.
__device__ __forceinline__ void product_64x64(float (&acc)[32], const uint8_t* aHi,
                                              const uint8_t* aLo, const uint8_t* bHi,
                                              const uint8_t* bLo, int K16) {
  const uint32_t pa[3] = {sm90::smem_addr(aHi), sm90::smem_addr(aHi), sm90::smem_addr(aLo)};
  const uint32_t pb[3] = {sm90::smem_addr(bHi), sm90::smem_addr(bLo), sm90::smem_addr(bHi)};
  sm90::fence_regs(acc);
  sm90::wgmma_fence();
  for (int ks = 0; ks < K16 / 16; ++ks)
#pragma unroll
    for (int part = 0; part < 3; ++part)
      sm90::wgmma_ss_n64(acc, kdesc(pa[part] + ks * 2 * (kT * 16), kT),
                         kdesc(pb[part] + ks * 2 * (kT * 16), kT), ks > 0 || part > 0);
  sm90::wgmma_commit();
  sm90::wgmma_wait_all();
  sm90::fence_regs(acc);
}

// 1. Chunk states: S_c = (sdec . X)^T B for one (b, h, chunk) and a panel of
// 64 p x 128 n, sdec_j = exp(cum_last - cum_j) dt_j, over 64-position tiles.
// X^T is split here from x (and the blocks of the first n panel export it
// unscaled, for the scan); B^T comes from ssd_cb's split tiles by bulk copy
// (BS) or is split here.
template <typename T, bool BS>
__global__ void __launch_bounds__(kWg) ssd_states(const TcArgs t) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_1024(smem_raw);
  const ScanArgs& a = t.s;
  uint8_t* aHi = sm;                         // X^T: 64 p x 64 j
  uint8_t* aLo = aHi + kXTile / 2;
  uint8_t* bHi = aLo + kXTile / 2;           // B^T: 128 n x 64 j
  uint8_t* bLo = bHi + kBTile / 2;
  float* sDt = reinterpret_cast<float*>(bLo + kBTile / 2);  // dt, then sdec
  float* sCum = sDt + a.Q;
  uint64_t* bar = reinterpret_cast<uint64_t*>(sCum + a.Q);

  const int c = blockIdx.x, bi = blockIdx.z;
  const int ppan = t.dp / kT;
  const int h = blockIdx.y / (t.npan * ppan), pan = blockIdx.y % (t.npan * ppan);
  const int pp = pan / t.npan, np = pan % t.npan;
  const int p0 = pp * kT, n0 = np * kNPanel;
  const int g = a.G == 1 ? 0 : h;
  const int s0 = c * a.Q, L = min(a.Q, a.S - s0);
  const T* xb = static_cast<const T*>(a.x) + bi * a.xs_b + h * a.xs_h;
  const float* bb = a.b + bi * a.bs_b + g * a.bs_h;
  const float rate = a.a[h];

  if (BS && threadIdx.x == 0) {
    sm90::mbar_init(bar, 1);
    sm90::fence_mbar_init();
  }
  chunk_cum(sDt, sCum, a.dt + bi * a.ds_b + h * a.ds_h, a.ds_s, s0, L,
            (L + kT - 1) / kT * kT, rate);
  const float cum_last = sCum[L - 1];
  for (int j = threadIdx.x; j < L; j += kWg) sDt[j] *= expf(cum_last - sCum[j]);
  if (threadIdx.x == 0 && pan == 0)
    t.decay[((size_t)bi * a.H + h) * t.nc + c] = expf(cum_last);
  __syncthreads();

  float acc[kNH][32];
  const uint32_t pa[3] = {sm90::smem_addr(aHi), sm90::smem_addr(aHi), sm90::smem_addr(aLo)};
  const uint32_t pb[3] = {sm90::smem_addr(bHi), sm90::smem_addr(bLo), sm90::smem_addr(bHi)};
  for (int kt = 0; kt * kT < L; ++kt) {
    const int k0 = kt * kT;
    if (kt) __syncthreads();  // the previous tile's products are done
    if (BS && threadIdx.x == 0) {
      sm90::mbar_expect_tx(bar, kBTile);
      sm90::bulk_load(bHi, t.bsplit + ((((size_t)bi * t.nc + c) * t.nt + kt) * t.npan + np) * kBTile,
                      kBTile, bar);
    }
    uint8_t* ex = np == 0 ? t.xsplit + (((((size_t)bi * a.H + h) * t.nc + c) * t.nt + kt) *
                                            ppan + pp) * kXTile
                          : nullptr;
    load_kmajor_t<kT>(aHi, aLo, xb + (long long)(s0 + k0) * a.xs_s + p0, a.xs_s, L - k0,
                      a.P - p0, sDt + k0, ex, ex ? ex + kXTile / 2 : nullptr);
    if (!BS)
      load_kmajor_t<kNPanel>(bHi, bLo, bb + (long long)(s0 + k0) * a.bs_s + n0, a.bs_s,
                             L - k0, a.N - n0, nullptr);
    sm90::fence_proxy_async();
    __syncthreads();
    if (BS) sm90::mbar_wait(bar, kt & 1);
#pragma unroll
    for (int hh = 0; hh < kNH; ++hh) sm90::fence_regs(acc[hh]);
    sm90::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kT / 16; ++ks)
#pragma unroll
      for (int part = 0; part < 3; ++part)
#pragma unroll
        for (int hh = 0; hh < kNH; ++hh)
          sm90::wgmma_ss_n64(acc[hh], kdesc(pa[part] + ks * 2 * (kT * 16), kT),
                             kdesc(pb[part] + hh * 1024 + ks * 2 * (kNPanel * 16), kNPanel),
                             k0 > 0 || ks > 0 || part > 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
#pragma unroll
    for (int hh = 0; hh < kNH; ++hh) sm90::fence_regs(acc[hh]);
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = warp * 16 + (lane >> 2), colq = 2 * (lane & 3);
  float* st = t.states + (((size_t)bi * a.H + h) * t.nc + c) * a.P * a.N;
#pragma unroll
  for (int hh = 0; hh < kNH; ++hh)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int p = p0 + row0 + 8 * ((i >> 1) & 1);
      const int n = n0 + hh * 64 + 8 * (i >> 2) + colq;
      if (p < a.P && n < a.N) store_f32x2(st + (size_t)p * a.N + n, acc[hh][i], acc[hh][i + 1]);
    }
}

// 2. C B^T of one (b, chunk, query tile qt, key tile kt <= qt), one b/c
// group, into the scratch tile in register order: float4 v of thread t is
// accumulator elements 4v..4v+3. The blocks with kt = 0 also store their
// split C tile, which every head's scan then copies as it is, and the
// blocks with kt = qt the split B^T tiles of key tile kt, which every
// head's ssd_states copies.
__global__ void __launch_bounds__(kWg) ssd_cb(const TcArgs t) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_1024(smem_raw);
  const ScanArgs& a = t.s;
  const int tile = kT * t.n16 * 2;
  uint8_t* cHi = sm;
  uint8_t* cLo = cHi + tile;
  uint8_t* bHi = cLo + tile;
  uint8_t* bLo = bHi + tile;
  int qt = 0, rest = blockIdx.x;             // blockIdx.x enumerates kt <= qt
  while (rest > qt) rest -= ++qt;
  const int kt = rest, c = blockIdx.y, bi = blockIdx.z;
  const int s0 = c * a.Q, L = min(a.Q, a.S - s0);
  const int q0 = qt * kT, k0 = kt * kT;
  if (q0 >= L) return;
  load_kmajor<kT>(cHi, cLo, a.c + bi * a.cs_b + (long long)(s0 + q0) * a.cs_s, a.cs_s,
                  L - q0, a.N, t.n16);
  load_kmajor<kT>(bHi, bLo, a.b + bi * a.bs_b + (long long)(s0 + k0) * a.bs_s, a.bs_s,
                  L - k0, a.N, t.n16);
  sm90::fence_proxy_async();
  __syncthreads();
  float s[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  product_64x64(s, cHi, cLo, bHi, bLo, t.n16);
  if (kt == 0) {  // the split C tile, for every head's scan
    const uint4* src = reinterpret_cast<const uint4*>(cHi);
    uint4* out = reinterpret_cast<uint4*>(
        t.csplit + (((size_t)bi * t.nc + c) * t.nt + qt) * c_tile_bytes(t.n16));
    for (int i = threadIdx.x; i < (int)(c_tile_bytes(t.n16) / 16); i += kWg) out[i] = src[i];
  }
  float4* dst = reinterpret_cast<float4*>(
      t.cb + ((((size_t)bi * t.nc + c) * t.nt + qt) * t.nt + kt) * kTileFloats);
#pragma unroll
  for (int v = 0; v < 8; ++v)
    dst[v * kWg + threadIdx.x] = make_float4(s[4 * v], s[4 * v + 1], s[4 * v + 2], s[4 * v + 3]);
  if (kt == qt)
    for (int np = 0; np < t.npan; ++np) {
      uint8_t* out = t.bsplit + ((((size_t)bi * t.nc + c) * t.nt + kt) * t.npan + np) * kBTile;
      load_kmajor_t<kNPanel>(out, out + kBTile / 2,
                             a.b + bi * a.bs_b + (long long)(s0 + k0) * a.bs_s + np * kNPanel,
                             a.bs_s, L - k0, a.N - np * kNPanel, (const float*)nullptr);
    }
}

// 3. The state pass over the chunks, one thread per four adjacent (p, n)
// of a (b, h): h = exp(cum_last) h + S_c from h0 on, and before each chunk
// the state h is written split into bf16 hi + lo, in the scan's K-major
// tile layout (dp x N, zero rows past P), to hprev; the last h to h_fin.
// Thread q of a (b, h) owns bytes [8q, 8q + 8) of a tile's hi part and of
// its lo part, so a warp writes 256 contiguous bytes of each.
__global__ void __launch_bounds__(256) ssd_state_pass(const TcArgs t) {
  const ScanArgs& a = t.s;
  const int q = blockIdx.x * 256 + threadIdx.x;
  if (q >= t.dp * a.N / 4) return;
  const int groups = t.dp / 8, rest = q >> 4;
  const int p = rest % groups * 8 + ((q >> 1) & 7), n = rest / groups * 8 + (q & 1) * 4;
  const bool live = p < a.P;
  const size_t bh = blockIdx.y, pn = (size_t)a.P * a.N, e = (size_t)p * a.N + n;
  const size_t tile = h_tile_bytes(t.dp, t.n16);
  float4 hc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (live && a.h0) hc = *reinterpret_cast<const float4*>(a.h0 + bh * pn + e);
  const float* st = t.states + bh * t.nc * pn + e;
  uint8_t* hp = t.hprev + bh * t.nc * tile + (size_t)q * 8;
  const float* dec = t.decay + bh * t.nc;
  constexpr int kAhead = 8;                   // chunk states loaded ahead
  for (int c0 = 0; c0 < t.nc; c0 += kAhead) {
    float4 v[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      v[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (live && c0 + k < t.nc) v[k] = *reinterpret_cast<const float4*>(st + (c0 + k) * pn);
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      if (c0 + k < t.nc) {
        const __nv_bfloat162 h01 = __floats2bfloat162_rn(hc.x, hc.y);
        const __nv_bfloat162 h23 = __floats2bfloat162_rn(hc.z, hc.w);
        const float2 f01 = __bfloat1622float2(h01), f23 = __bfloat1622float2(h23);
        const __nv_bfloat162 l01 = __floats2bfloat162_rn(hc.x - f01.x, hc.y - f01.y);
        const __nv_bfloat162 l23 = __floats2bfloat162_rn(hc.z - f23.x, hc.w - f23.y);
        uint8_t* out = hp + (c0 + k) * tile;
        *reinterpret_cast<uint2*>(out) = make_uint2(
            *reinterpret_cast<const uint32_t*>(&h01), *reinterpret_cast<const uint32_t*>(&h23));
        *reinterpret_cast<uint2*>(out + tile / 2) = make_uint2(
            *reinterpret_cast<const uint32_t*>(&l01), *reinterpret_cast<const uint32_t*>(&l23));
        const float d = dec[c0 + k];
        hc = make_float4(fmaf(hc.x, d, v[k].x), fmaf(hc.y, d, v[k].y),
                         fmaf(hc.z, d, v[k].z), fmaf(hc.w, d, v[k].w));
      }
    }
  }
  if (live) *reinterpret_cast<float4*>(a.h_fin + bh * pn + e) = hc;
}

// 4. The scan of one (b, h, chunk, 64-row query tile). PP: 64-column panels
// of P; CB: C B^T from ssd_cb's scratch, else computed here. h_prev, the X^T
// tiles and (CB) the C tile arrive split, by bulk copy. C h^T runs over
// chunks of 64 state columns through one 32 KB region (a chunk of C and of
// h_prev), which the ring of two X^T buffers then takes over, the next but
// one tile in flight while a tile is used: 36 KB of shared memory, so that
// four blocks share an SM. A block's chain of copies and products is
// latency-bound, and blocks in flight hide it: on an H100 (80GB HBM3,
// 700 W) at the path shape, whole C and h_prev tiles (three blocks per SM)
// took 0.214 ms and a ring apart from them (two) 0.256 ms, this 0.200 ms.
template <typename T, int PP, bool CB>
__global__ void __launch_bounds__(kWg, PP == 1 ? 4 : 1) ssd_chunk_scan(const TcArgs t) {
  constexpr int DP = kT * PP;
  constexpr uint32_t kXBytes = PP * kXTile;   // one X^T buffer: PP split tiles
  constexpr int kKC = 64;                     // state columns per chunk of C h^T
  constexpr uint32_t kCPart = kT * kKC * 2, kHPart = DP * kKC * 2;  // a hi (or lo) part
  constexpr uint32_t kRegion = 2 * (kCPart + kHPart) > 2 * kXBytes ? 2 * (kCPart + kHPart)
                                                                   : 2 * kXBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_1024(smem_raw);
  const ScanArgs& a = t.s;
  const int n16 = t.n16;
  const size_t cbytes = c_tile_bytes(n16), hbytes = h_tile_bytes(DP, n16);
  uint8_t* rg = sm;                   // C chunk hi, lo; h_prev chunk hi, lo; then the ring
  uint8_t* cHi = sm + kRegion;        // without CB: C, 64 q x n16, split here
  uint8_t* cLo = cHi + cbytes / 2;
  uint8_t* bHi = cLo + cbytes / 2;    // without CB: B, 64 j x n16
  uint8_t* bLo = bHi + cbytes / 2;
  float* sDt = reinterpret_cast<float*>(CB ? sm + kRegion : bLo + cbytes / 2);
  float* sCum = sDt + a.Q;
  uint64_t* bar = reinterpret_cast<uint64_t*>(sCum + a.Q);  // C h^T chunks; X^T ring

  const int bi = blockIdx.z, h = blockIdx.y;
  const int c = blockIdx.x / t.nt, qt = t.nt - 1 - blockIdx.x % t.nt;  // longest first
  const int g = a.G == 1 ? 0 : h;
  const int s0 = c * a.Q, L = min(a.Q, a.S - s0), q0 = qt * kT;
  if (q0 >= L) return;
  const float* bb = a.b + bi * a.bs_b + g * a.bs_h;
  const float* cbp = a.c + bi * a.cs_b + g * a.cs_h;
  const size_t bhc = ((size_t)bi * a.H + h) * t.nc + c;
  const int nk = (n16 + kKC - 1) / kKC;
  float4 cb_next[8];  // the C B^T tile of the next key tile, in register order
  auto load_cb = [&](int kt) {
    const float4* src = reinterpret_cast<const float4*>(
        t.cb + ((((size_t)bi * t.nc + c) * t.nt + qt) * t.nt + kt) * kTileFloats);
#pragma unroll
    for (int v = 0; v < 8; ++v) cb_next[v] = src[v * kWg + threadIdx.x];
  };
  auto load_chunk = [&](int k) {  // state columns [64k, 64k + 64) of h_prev (and C)
    const uint32_t groups = (uint32_t)min(kKC, n16 - k * kKC) / 8;
    const uint32_t cpart = groups * kT * 16, hpart = groups * DP * 16;
    sm90::mbar_expect_tx(bar, 2 * hpart + (CB ? 2 * cpart : 0));
    const uint8_t* hs = t.hprev + bhc * hbytes + (size_t)k * (kKC / 8) * DP * 16;
    sm90::bulk_load(rg + 2 * kCPart, hs, hpart, bar);
    sm90::bulk_load(rg + 2 * kCPart + kHPart, hs + hbytes / 2, hpart, bar);
    if (CB) {
      const uint8_t* cs = t.csplit + (((size_t)bi * t.nc + c) * t.nt + qt) * cbytes +
                          (size_t)k * (kKC / 8) * kT * 16;
      sm90::bulk_load(rg, cs, cpart, bar);
      sm90::bulk_load(rg + kCPart, cs + cbytes / 2, cpart, bar);
    }
  };
  auto load_x = [&](int kt) {  // X^T tile kt into ring buffer kt % 2
    uint64_t* bx = &bar[1 + (kt & 1)];
    sm90::mbar_expect_tx(bx, kXBytes);
    sm90::bulk_load(rg + (kt & 1) * kXBytes, t.xsplit + (bhc * t.nt + kt) * kXBytes, kXBytes,
                    bx);
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < 3; ++i) sm90::mbar_init(&bar[i], 1);
    sm90::fence_mbar_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) load_chunk(0);
  if (CB) load_cb(0);
  chunk_cum(sDt, sCum, a.dt + bi * a.ds_b + h * a.ds_h, a.ds_s, s0, L, q0 + kT, a.a[h]);
  if (!CB) {
    load_kmajor<kT>(cHi, cLo, cbp + (long long)(s0 + q0) * a.cs_s, a.cs_s, L - q0, a.N, n16);
    sm90::fence_proxy_async();
    __syncthreads();
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = warp * 16 + (lane >> 2), colq = 2 * (lane & 3);

  // Y = exp(cum_i) (C h_prev^T), one chunk of 64 state columns at a time
  float y[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) y[i] = 0.f;
  const uint32_t a_rg = sm90::smem_addr(rg);
  for (int k = 0; k < nk; ++k) {
    if (k > 0) {
      __syncthreads();  // every thread's products on the last chunk are done
      if (threadIdx.x == 0) load_chunk(k);
    }
    sm90::mbar_wait(bar, k & 1);
    const uint32_t chi = CB ? a_rg : sm90::smem_addr(cHi) + k * (kKC / 8) * kT * 16;
    const uint32_t clo = CB ? a_rg + kCPart : sm90::smem_addr(cLo) + k * (kKC / 8) * kT * 16;
    const uint32_t a_c[3] = {chi, chi, clo};
    const uint32_t a_h[3] = {a_rg + 2 * kCPart, a_rg + 2 * kCPart + kHPart, a_rg + 2 * kCPart};
    sm90::fence_regs(y);
    sm90::wgmma_fence();
    for (int ks = 0; ks < min(kKC, n16 - k * kKC) / 16; ++ks)
#pragma unroll
      for (int part = 0; part < 3; ++part)
#pragma unroll
        for (int pp = 0; pp < PP; ++pp)
          sm90::wgmma_ss_n64(*reinterpret_cast<float(*)[32]>(y + 32 * pp),
                             kdesc(a_c[part] + ks * 2 * (kT * 16), kT),
                             kdesc(a_h[part] + pp * 1024 + ks * 2 * (DP * 16), DP),
                             k > 0 || ks > 0 || part > 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::fence_regs(y);
  }
  const float e_row[2] = {expf(sCum[q0 + row0]), expf(sCum[q0 + row0 + 8])};
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) y[i] *= e_row[(i >> 1) & 1];
  __syncthreads();  // every thread's C h^T is done: the ring takes the region
  if (threadIdx.x == 0) {
    load_x(0);
    if (qt > 0) load_x(1);
  }

  const uint32_t a_x = a_rg;
  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * kT;
    float s[32];
    if (CB) {
#pragma unroll
      for (int v = 0; v < 8; ++v) {
        s[4 * v] = cb_next[v].x;
        s[4 * v + 1] = cb_next[v].y;
        s[4 * v + 2] = cb_next[v].z;
        s[4 * v + 3] = cb_next[v].w;
      }
      if (kt < qt) load_cb(kt + 1);  // in flight during this tile's work
    } else {
      if (kt) __syncthreads();  // every thread's C B^T of the last tile is done
      load_kmajor<kT>(bHi, bLo, bb + (long long)(s0 + k0) * a.bs_s, a.bs_s, L - k0, a.N, n16);
      sm90::fence_proxy_async();
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
      product_64x64(s, cHi, cLo, bHi, bLo, n16);
    }

    // W = (C B^T) . exp(cum_i - cum_j) . dt_j for j <= i, split into the
    // hi and lo A fragments of 4 k-steps of 16 keys
    uint32_t w_hi[4][4], w_lo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float w[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 8 * kk + 2 * r + e;
          const int gi = q0 + row0 + 8 * ((i >> 1) & 1);
          const int gj = k0 + 8 * (i >> 2) + colq + (i & 1);
          w[e] = gj <= gi ? s[i] * expf(sCum[gi] - sCum[gj]) * sDt[gj] : 0.f;
        }
        const __nv_bfloat162 hi = __floats2bfloat162_rn(w[0], w[1]);
        const float2 hf = __bfloat1622float2(hi);
        w_hi[kk][r] = *reinterpret_cast<const uint32_t*>(&hi);
        w_lo[kk][r] = pack_bf16(w[0] - hf.x, w[1] - hf.y);
      }

    // Y += W_hi X_hi + W_hi X_lo + W_lo X_hi (bf16 x: X_lo is 0, skipped),
    // X^T K-major: one m64n64 product per 64-column panel of P
    constexpr bool kXLo = !std::is_same<T, __nv_bfloat16>::value;
    sm90::mbar_wait(&bar[1 + (kt & 1)], (kt >> 1) & 1);
    const uint32_t xbuf = a_x + (kt & 1) * kXBytes;
    sm90::fence_regs(y);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      sm90::fence_regs(w_hi[kk]);
      sm90::fence_regs(w_lo[kk]);
    }
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int pp = 0; pp < PP; ++pp) {
        float(&yp)[32] = *reinterpret_cast<float(*)[32]>(y + 32 * pp);
        const uint32_t tile = xbuf + pp * kXTile + kk * 2 * (kT * 16);
        sm90::wgmma_rs_n64_kmajor(yp, w_hi[kk], kdesc(tile, kT), 1);
        if (kXLo) sm90::wgmma_rs_n64_kmajor(yp, w_hi[kk], kdesc(tile + kXTile / 2, kT), 1);
        sm90::wgmma_rs_n64_kmajor(yp, w_lo[kk], kdesc(tile, kT), 1);
      }
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::fence_regs(y);
    if (kt + 2 <= qt) {
      __syncthreads();  // every thread's product on this buffer is done
      if (threadIdx.x == 0) load_x(kt + 2);
    }
  }

  T* yb = static_cast<T*>(a.y) + bi * a.ys_b + h * a.ys_h;
#pragma unroll
  for (int i = 0; i < DP / 2; i += 2) {
    const int r = q0 + row0 + 8 * ((i >> 1) & 1), col = 8 * (i >> 2) + colq;
    if (r < L && col < a.P)
      store_f32x2(yb + (long long)(s0 + r) * a.ys_s + col, y[i], y[i + 1]);
  }
}

// Shared memory of each tensor-core kernel (bytes, with the alignment slack).
size_t states_smem(int Q) { return 1024 + kXTile + kBTile + 2 * (size_t)Q * 4 + 8; }
size_t cb_smem(int n16) { return 1024 + 4 * (size_t)kT * n16 * 2; }
int round64(int n) { return (n + kT - 1) / kT * kT; }
size_t scan_smem(int P, int n16, int Q, bool cb) {
  const size_t dp = round64(P), chunk = 2 * (kT + dp) * 64 * 2, ring = 2 * dp / kT * kXTile;
  return 1024 + std::max(chunk, ring) + (cb ? 0 : 2 * c_tile_bytes(n16)) + 2 * (size_t)Q * 4 +
         3 * 8;
}
constexpr size_t kSmemLimit = 227 * 1024;

int round16(int n) { return (n + 15) / 16 * 16; }

// The shapes the tensor-core body takes (cb: with ssd_cb, one b/c group).
bool tensor_core_shape(int P, int N, int Q, bool cb) {
  return P > 0 && N > 0 && Q > 0 && P % 16 == 0 && N % 16 == 0 && Q % kT == 0 &&
         P <= 2 * kT && N <= 256 && states_smem(Q) <= kSmemLimit &&
         (!cb || cb_smem(round16(N)) <= kSmemLimit) &&
         scan_smem(P, round16(N), Q, cb) <= kSmemLimit;
}

using TcKernel = void (*)(const TcArgs);

// One launch on the stream, its error checked; counts it in *launched.
cudaError_t launch_one(TcKernel kernel, dim3 grid, int threads, size_t smem,
                       cudaStream_t st, const TcArgs& t, int* launched) {
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, threads, smem, st>>>(t);
  const cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess) ++*launched;
  return e;
}

// C B^T with the split C and B^T tiles (one b/c group), the states, the
// pass, the scan; a sequence shorter than one position has no chunk, and
// the pass alone writes h_fin = h0.
template <typename T, int PP>
cudaError_t launch_tc(const TcArgs& t, cudaStream_t st, int* launched) {
  const ScanArgs& a = t.s;
  const bool cb = t.cb != nullptr;
  cudaError_t e = cudaSuccess;
  if (t.nc > 0 && cb)
    e = launch_one(ssd_cb, dim3(t.nt * (t.nt + 1) / 2, t.nc, a.B), kWg, cb_smem(t.n16), st, t,
                   launched);
  if (e == cudaSuccess && t.nc > 0)
    e = launch_one(cb ? ssd_states<T, true> : ssd_states<T, false>,
                   dim3(t.nc, a.H * PP * t.npan, a.B), kWg, states_smem(a.Q), st, t, launched);
  if (e == cudaSuccess)
    e = launch_one(ssd_state_pass, dim3((t.dp * a.N / 4 + 255) / 256, a.B * a.H), 256, 0, st, t,
                   launched);
  if (e == cudaSuccess && t.nc > 0)
    e = launch_one(cb ? ssd_chunk_scan<T, PP, true> : ssd_chunk_scan<T, PP, false>,
                   dim3(t.nc * t.nt, a.H, a.B), kWg, scan_smem(a.P, t.n16, a.Q, cb), st, t,
                   launched);
  return e;
}

template <typename T>
cudaError_t dispatch_tc(const TcArgs& t, cudaStream_t st, int* launched) {
  return t.s.P <= kT ? launch_tc<T, 1>(t, st, launched) : launch_tc<T, 2>(t, st, launched);
}

}  // namespace

// dims: B, H, S, P, N, G, Q. Returns 1 when ssd_scan_fwd takes the
// tensor-core body at these dims, else 0, and fills the sizes (in 4-byte
// words) of the kScratch scratch arrays that body needs, in TcArgs's order:
// states, decay, hprev, xsplit, cb, csplit, bsplit (0 where unused; all 0
// for the CUDA-core body).
extern "C" int ssd_scan_plan(const int* dims, long long* sizes) {
  const int B = dims[0], H = dims[1], S = dims[2], P = dims[3], N = dims[4];
  const int G = dims[5], Q = dims[6];
  for (int i = 0; i < kScratch; ++i) sizes[i] = 0;
  const bool cb = kCbScratch && G == 1;
  if (!tensor_core_shape(P, N, Q, cb)) return 0;
  const long long nc = S > 0 ? (S + Q - 1) / Q : 0, nt = Q / kT;
  const long long bhc = (long long)B * H * nc, bc = (long long)B * nc;
  const long long npan = (N + kNPanel - 1) / kNPanel, ppan = round64(P) / kT;
  sizes[0] = bhc * P * N;
  sizes[1] = bhc;
  sizes[2] = bhc * (long long)(h_tile_bytes(round64(P), N) / 4);
  sizes[3] = bhc * nt * ppan * (kXTile / 4);
  sizes[4] = cb ? bc * nt * nt * kTileFloats : 0;
  sizes[5] = cb ? bc * nt * (long long)(c_tile_bytes(N) / 4) : 0;
  sizes[6] = cb ? bc * nt * npan * (kBTile / 4) : 0;
  return 1;
}

// dtype (of x and y): 0 float32, 1 bfloat16. dims: B, H, S, P, N, G, Q.
// strides (in elements): x, dt, b, c, y, each (batch, head, position).
// scratch: the kScratch arrays of the sizes ssd_scan_plan gives, in its
// order (unused by the CUDA-core body). Adds the number of device kernels it
// launched to *launched. Returns the cudaError_t of the first launch that
// failed, else cudaSuccess.
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* a,
                            const void* b, const void* c, const void* h0,
                            void* y, void* h_fin, int dtype, const int* dims,
                            const long long* strides, void* const* scratch,
                            int* launched, void* stream) {
  ScanArgs s{x,
             static_cast<const float*>(dt),
             static_cast<const float*>(a),
             static_cast<const float*>(b),
             static_cast<const float*>(c),
             static_cast<const float*>(h0),
             y,
             static_cast<float*>(h_fin),
             dims[0], dims[1], dims[2], dims[3], dims[4], dims[5], dims[6],
             strides[0], strides[1], strides[2],
             strides[3], strides[4], strides[5],
             strides[6], strides[7], strides[8],
             strides[9], strides[10], strides[11],
             strides[12], strides[13], strides[14]};
  if (s.B == 0 || s.H == 0) return cudaSuccess;
  if (s.Q < 1 || s.P % 4 || s.N % 4 || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool cb = s.G == 1 && kCbScratch;
  if (tensor_core_shape(s.P, s.N, s.Q, cb)) {
    TcArgs t{s,
             static_cast<float*>(scratch[0]),
             static_cast<float*>(scratch[1]),
             static_cast<uint8_t*>(scratch[2]),
             static_cast<uint8_t*>(scratch[3]),
             cb ? static_cast<float*>(scratch[4]) : nullptr,
             cb ? static_cast<uint8_t*>(scratch[5]) : nullptr,
             cb ? static_cast<uint8_t*>(scratch[6]) : nullptr,
             s.S > 0 ? (s.S + s.Q - 1) / s.Q : 0,
             s.Q / kT,
             round16(s.N),
             round64(s.P),
             (s.N + kNPanel - 1) / kNPanel};
    if (t.nc > 0 && (!t.states || !t.decay || !t.hprev || !t.xsplit ||
                     (cb && (!t.cb || !t.csplit || !t.bsplit))))
      return cudaErrorInvalidValue;
    return dtype == 0 ? dispatch_tc<float>(t, st, launched)
                      : dispatch_tc<__nv_bfloat16>(t, st, launched);
  }
  const cudaError_t e = dtype == 0 ? launch<float>(s, st) : launch<__nv_bfloat16>(s, st);
  if (e == cudaSuccess) ++*launched;
  return e;
}
