// The exact three-way bf16 split of f32 values, in registers, shared by the
// tensor-core bodies: csrc/band_mma.cu (K7 over the f32 band) and
// csrc/fused_forward.cu (K1, K2).
//
// An f32 value x splits into hi = rn(x), mid = rn(x - hi), lo = x - hi - mid
// (round to nearest even), so hi + mid + lo == x for every finite x up to
// bf16's largest finite value and down to about 2^-110 in magnitude (and 0).
// A product x * y of two split values is then the nine bf16 products of the
// terms; the kernels take six of them (ops/band_mma.py SPLIT_PRODUCTS) and
// leave out mid*lo, lo*mid and lo*lo, each under 2^-24 of the product.

#pragma once

#include <cstdint>

namespace {

// Two f32 values rounded to bf16x2 (round to nearest even), lo in the low
// half.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t out;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(out) : "f"(hi), "f"(lo));
  return out;
}

// Two f32 values (x first, in the low halves) split exactly into three
// bf16x2: hi = rn(v), mid = rn(v - hi), lo = v - hi - mid.  Both
// subtractions are exact in f32, and lo has at most 8 significant bits, so
// its rounding is exact too.
__device__ __forceinline__ void split3(float2 v, uint32_t& hi, uint32_t& mid, uint32_t& lo) {
  hi = pack_bf16x2(v.x, v.y);
  float r0 = __fsub_rn(v.x, __uint_as_float(hi << 16));
  float r1 = __fsub_rn(v.y, __uint_as_float(hi & 0xFFFF0000u));
  mid = pack_bf16x2(r0, r1);
  r0 = __fsub_rn(r0, __uint_as_float(mid << 16));
  r1 = __fsub_rn(r1, __uint_as_float(mid & 0xFFFF0000u));
  lo = pack_bf16x2(r0, r1);
}

}  // namespace
