// Pieces the FlashBias attention forward (flashbias_attn.cu) and backward
// (flashbias_attn_bwd.cu) share: the masked-logit value, the log2-domain
// exponential, bf16 packing and the mask predicate.
#pragma once

#include <cuda_bf16.h>
#include <cstdint>

namespace fb {

// Masked logits take this value (not -inf), as the TPU kernel does.
constexpr float kMaskValue = -0.7f * 3.4028234663852886e38f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two floats rounded to a bf16 pair, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// Whether query position `row` may see key position `col`: keys at or past
// kv_len are masked, and mask_kind 1 (causal) / 2 (local, `window` keys
// back) mask keys after the query.
__device__ __forceinline__ bool mask_ok(int row, int col, int kv_len, int mask_kind,
                                        int window) {
  bool ok = col < kv_len;
  if (mask_kind != 0) ok = ok && row >= col;
  if (mask_kind == 2) ok = ok && (row - col) < window;
  return ok;
}

}  // namespace fb
