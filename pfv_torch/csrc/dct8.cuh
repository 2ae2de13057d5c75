// The integer 8-point DCTs of the PFV reference: the inverse (dct.rs idct),
// shared by K1 (step_kernel.cu) and K5 (idct_kernel.cu), and the forward
// (dct.rs fdct), used by K6 (fdct_kernel.cu).
//
// Values are uint32 so that adds and multiplies wrap as the reference's
// release build does (defined behaviour in C++); divisions by powers of two
// reinterpret as int32 and truncate toward zero (quirk Q3), which is not an
// arithmetic shift.

#pragma once

#include <cstdint>

namespace pfv {

typedef uint32_t u32;

// Rust `x / (1 << k)` on int32: truncating, via bias + arithmetic shift.
__device__ __forceinline__ u32 tdiv(u32 x, int k) {
  const u32 bias = (u32)(((int)x >> 31) & ((1 << k) - 1));
  return (u32)((int)(x + bias) >> k);
}

// Forward 1-D transform of p[0], p[s], ..., p[7s] in place, output
// permutation included.
__device__ __forceinline__ void fdct8(u32* p, int s) {
  const u32 i0 = p[0], i1 = p[s], i2 = p[2 * s], i3 = p[3 * s];
  const u32 i4 = p[4 * s], i5 = p[5 * s], i6 = p[6 * s], i7 = p[7 * s];
  const u32 a0 = i0 + i7, a1 = i1 + i6, a2 = i2 + i5, a3 = i3 + i4;
  const u32 a4 = i0 - i7, a5 = i1 - i6, a6 = i2 - i5, a7 = i3 - i4;
  const u32 b0 = a0 + a3, b1 = a1 + a2, b2 = a0 - a3, b3 = a1 - a2;
  const u32 c0 = b0 + b1, c1 = b0 - b1;
  const u32 c2 = b2 + tdiv(b2, 2) + tdiv(b3, 1);
  const u32 c3 = tdiv(b2, 1) - b3 - tdiv(b3, 2);
  const u32 b4 = tdiv(a7, 2) + a4 + tdiv(a4, 2) - tdiv(a4, 4);
  const u32 b7 = tdiv(a4, 2) - a7 - tdiv(a7, 2) + tdiv(a7, 4);
  const u32 b5 = a5 + a6 - tdiv(a6, 2) - tdiv(a6, 4);
  const u32 b6 = a6 - a5 + tdiv(a5, 2) + tdiv(a5, 4);
  const u32 c4 = b4 + b5, c5 = b4 - b5, c6 = b6 + b7, c7 = b6 - b7;
  p[0] = c0;
  p[s] = c4;
  p[2 * s] = c2;
  p[3 * s] = c5 - c7;
  p[4 * s] = c1;
  p[5 * s] = c5 + c7;
  p[6 * s] = c3;
  p[7 * s] = c6;
}

// Inverse 1-D transform of p[0], p[s], ..., p[7s] in place.
__device__ __forceinline__ void idct8(u32* p, int s) {
  const u32 c0 = p[0], d4 = p[s], c2 = p[2 * s], d6 = p[3 * s];
  const u32 c1 = p[4 * s], d5 = p[5 * s], c3 = p[6 * s], d7 = p[7 * s];
  const u32 c4 = d4, c5 = d5 + d6, c7 = d5 - d6, c6 = d7;
  const u32 b4 = c4 + c5, b5 = c4 - c5, b6 = c6 + c7, b7 = c6 - c7;
  const u32 b0 = c0 + c1, b1 = c0 - c1;
  const u32 b2 = c2 + tdiv(c2, 2) + tdiv(c3, 1);
  const u32 b3 = tdiv(c2, 1) - c3 - tdiv(c3, 2);
  const u32 a4 = tdiv(b7, 2) + b4 + tdiv(b4, 2) - tdiv(b4, 4);
  const u32 a7 = tdiv(b4, 2) - b7 - tdiv(b7, 2) + tdiv(b7, 4);
  const u32 a5 = b5 - b6 + tdiv(b6, 2) + tdiv(b6, 4);
  const u32 a6 = b6 + b5 - tdiv(b5, 2) - tdiv(b5, 4);
  const u32 a0 = b0 + b2, a1 = b1 + b3, a2 = b1 - b3, a3 = b0 - b2;
  p[0] = a0 + a4;
  p[s] = a1 + a5;
  p[2 * s] = a2 + a6;
  p[3 * s] = a3 + a7;
  p[4 * s] = a3 - a7;
  p[5 * s] = a2 - a6;
  p[6 * s] = a1 - a5;
  p[7 * s] = a0 - a4;
}

// 2-D inverse transform of a row-major 8x8 block in registers: columns,
// then rows (common.rs:315-316), then (m >> 8) + 128 clamped to 0..255.
__device__ __forceinline__ void idct8x8_clamp(u32 (&v)[64], uint8_t (&px)[64]) {
#pragma unroll
  for (int j = 0; j < 8; j++) idct8(v + j, 8);
#pragma unroll
  for (int i = 0; i < 8; i++) idct8(v + 8 * i, 1);
#pragma unroll
  for (int r = 0; r < 64; r++) {
    const int x = ((int)v[r] >> 8) + 128;
    px[r] = (uint8_t)min(max(x, 0), 255);
  }
}

}  // namespace pfv
