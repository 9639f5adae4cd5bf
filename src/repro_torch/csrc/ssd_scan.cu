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
// and writes the final state h_fin, which the model's prefill caches: the
// same function with the scratch seeded and stored, in one pass. S need not
// be a multiple of Q: the last chunk is bounded by its length L, and rows
// past L read as zeros (dt = 0 there), so they change neither y nor h_fin.
//
// What bounds it on the H100: at the SSM prefill shape of mamba2-130m (B=4,
// H=32, S=4096, P=64, N=128, float32, one b/c group) the bytes that must
// move are x and y (134 MB each), b and c (17 MB), dt, h_fin: ~0.29 GB,
// ~0.087 ms at 3.35 TB/s; the causal work is ~43 GFLOP, ~0.044 ms at the
// tensor cores' 989 TFLOP/s. So the function is bound by bytes. This kernel
// does the work as float32 FMAs from shared memory, whose 67 TFLOP/s alone
// would take ~0.64 ms, on one block per (b, h) (128 blocks on 132 SMs at
// that shape), since the chunks of one (b, h) run in order.
//
// Design, simple first. One block of 8 warps per (b, h) walks the chunks in
// order and keeps the state h (P x N float32) in shared memory for the whole
// sequence. A chunk at Q=256, N=128, P=64 (x 64 KB, b and c 128 KB each,
// state 32 KB) does not fit a block's 227 KB, so it is tiled: the chunk's dt
// and inclusive cumsum (Q floats each) first, then 64-row query tiles, each
// against the 64-row key tiles at or before it (j <= i only). Per query tile:
// the inter-chunk term C h^T, scaled by exp(cum_i); then per key tile the
// logits C B^T, the decay and dt applied in place, exp evaluated only where
// j <= i (above the diagonal cum_i - cum_j > 0 and exp may overflow; inf * 0
// would be NaN), and Y += W X. Only after every query tile of the chunk has
// read the old state is it decayed and the chunk's update X^T (sdec . B)
// added, so y always sees the state before its chunk. The four products run
// through one register-tiled routine: each thread holds a 4 x 4 tile of the
// output whose rows and columns are strided by a quarter of the tile, and
// every shared row has an odd length, so the lanes of a warp read distinct
// banks or one broadcast word. x and y are read and written through their
// strides (the model's (B, S, H, P) layout, no transposes), and a single b/c
// group is read by every head, never broadcast in memory.
// tf32/bf16 wgmma for the four products, TMA loads, the (c . b^T) product
// shared by every head of a (b, chunk), and chunk-parallel states are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

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

}  // namespace

// dtype (of x and y): 0 float32, 1 bfloat16. dims: B, H, S, P, N, G, Q.
// strides (in elements): x, dt, b, c, y, each (batch, head, position).
// Returns the cudaError_t of the launch.
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* a,
                            const void* b, const void* c, const void* h0,
                            void* y, void* h_fin, int dtype, const int* dims,
                            const long long* strides, void* stream) {
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
  if (s.Q < 1 || s.P % 4 || s.N % 4) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(s, st);
  if (dtype == 1) return launch<__nv_bfloat16>(s, st);
  return cudaErrorInvalidValue;
}
