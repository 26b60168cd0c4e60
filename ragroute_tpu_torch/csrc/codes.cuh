// Quantized codes to bf16 on the card, exactly: shared by the kernels that
// turn int8 or packed int4 codes into bf16 wgmma operands (fused_topk.cu's
// scan, grouped_pair_topk.cu's pair scan, int4_matmul.cu's prefill kernel).
// Every int8 code (-128 .. 127) and every int4 code (-8 .. 7) is a bf16
// value, so no conversion here rounds.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace codes {

// Two nibbles (bits 0-3 and 16-19 of t) as a bf16x2 of their signed codes:
// (nibble ^ 8) under a bf16 exponent of 128 reads 128 + (code + 8); minus
// 136 leaves the code, exactly. ((t ^ 8) & 0xF) | 0x4300 in each half is
// (t & 0xF) ^ 0x4308: one three-input logic op.
__device__ __forceinline__ uint32_t nibbles_bf16x2(uint32_t t) {
  uint32_t v = (t & 0x000F000Fu) ^ 0x43084308u;
  __nv_bfloat162 b = *reinterpret_cast<__nv_bfloat162*>(&v);
  b = __hsub2(b, __floats2bfloat162_rn(136.0f, 136.0f));
  return *reinterpret_cast<uint32_t*>(&b);
}

// The low (high = false) or high nibbles of the four bytes of w, byte j
// holding code j, as two bf16x2 words: codes 0, 1 and codes 2, 3.
__device__ __forceinline__ uint2 nibbles4_bf16(uint32_t w, bool high) {
  uint32_t a = __byte_perm(w, 0u, 0x4140), b = __byte_perm(w, 0u, 0x4342);
  if (high) { a >>= 4; b >>= 4; }
  return make_uint2(nibbles_bf16x2(a), nibbles_bf16x2(b));
}

// Byte `sel` (0..3) of a word whose bytes are int8 codes + 128 (the word ^
// 0x80808080) as an f32: under the exponent of 2^23 it reads 2^23 + code +
// 128, and 2^23 + 128 less is the code, exactly.
__device__ __forceinline__ float biased_byte_f32(uint32_t biased, int sel) {
  return __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7650 + sel)) -
         8388736.0f;
}

// Two f32 values that are bf16 values as one bf16x2 word (lo in bits 0-15).
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 b = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&b);
}

// Four int8 codes (byte j of w holds code j) as two bf16x2 words: codes 0, 1
// and codes 2, 3.
__device__ __forceinline__ uint2 int8x4_bf16(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;
  return make_uint2(pack_bf16x2(biased_byte_f32(u, 0), biased_byte_f32(u, 1)),
                    pack_bf16x2(biased_byte_f32(u, 2), biased_byte_f32(u, 3)));
}

// bf16x2 word w times the bf16 s, each half rounded to bf16 once (the exact
// product rounded to nearest, as bf16(code) * bf16(scale) in PyTorch).
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t w, __nv_bfloat16 s) {
  __nv_bfloat162 b = *reinterpret_cast<__nv_bfloat162*>(&w);
  b = __hmul2(b, __halves2bfloat162(s, s));
  return *reinterpret_cast<uint32_t*>(&b);
}

}  // namespace codes
