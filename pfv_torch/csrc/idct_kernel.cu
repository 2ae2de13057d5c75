// K5, block iDCT: (N, 4, 64) int16 zigzag coefficients and a (64,) int32
// q-table -> (N, 16, 16) u8 macroblocks, one subblock per thread.
//
// Replaces: pfv_tpu/ops/pallas/idct_kernel.py, _idct_kernel (built by
// idct_clamp_packed, fed by decode_blocks_pallas). Same arithmetic, with the
// dequantization fused in; the TPU's (64, X) lane-packed transpose and its
// 512-lane padding are not carried over.
//
// A CTA of 128 threads takes 128 consecutive subblocks (32 macroblocks):
//   1. loads their 8192 coefficients coalesced, dequantizes coefficient k
//      of a subblock by SCALE[k] * q[k] (both indexed by the zigzag slot,
//      quirk Q1) in wrapping uint32, and stores it at its row-major place
//      ZIGZAG[k] of the subblock's row in shared memory;
//   2. each thread reads its subblock's 64 values into registers, runs the
//      integer iDCT (dct8.cuh: columns, then rows) and clamps
//      (m >> 8) + 128 to 0..255;
//   3. writes pixel (i, j) of subblock q = 2*sr + sc to row 8*sr + i,
//      column 8*sc + j of its macroblock, eight bytes per store.
//
// What bounds it on this card: device-memory bytes, 2 B of coefficients in
// and 1 B of pixels out per pixel, plus about 200 integer operations per
// pixel in the butterflies. Design: coalesced loads through shared memory
// (rows padded to 65 words, so the per-thread reads hit 32 distinct banks),
// the transform in registers, 8-byte stores.

#include <cstdint>
#include <cuda_runtime.h>

#include "dct8.cuh"

namespace {

using pfv::u32;

constexpr int kThreads = 128;  // subblocks per CTA, one per thread

// ZIGZAG_TABLE[k] = row-major position of zigzag slot k.
__constant__ int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// DCT_SCALE_FACTOR, indexed by the zigzag slot at decode (quirk Q1).
__constant__ int kScale[64] = {
    32, 37, 34, 26, 32, 26, 34, 37, 37, 43, 39, 31, 37, 31, 39, 43,
    34, 39, 35, 28, 34, 28, 35, 39, 26, 31, 28, 22, 26, 22, 28, 31,
    32, 37, 34, 26, 32, 26, 34, 37, 26, 31, 28, 22, 26, 22, 28, 31,
    34, 39, 35, 28, 34, 28, 35, 39, 37, 43, 39, 31, 37, 31, 39, 43};

__global__ void __launch_bounds__(kThreads)
idct_blocks_kernel(const int16_t* __restrict__ coeffs, const int* __restrict__ q,
                   uint8_t* __restrict__ out, int n_sub) {
  __shared__ u32 m[kThreads][65];
  __shared__ u32 mul[64];

  const int tid = threadIdx.x;
  const int s0 = blockIdx.x * kThreads;
  if (tid < 64) mul[tid] = (u32)kScale[tid] * (u32)q[tid];
  __syncthreads();

  const int count = min(kThreads, n_sub - s0) * 64;
  const int16_t* src = coeffs + (size_t)s0 * 64;
  for (int i = tid; i < kThreads * 64; i += kThreads) {
    const int k = i & 63;
    const u32 val = i < count ? (u32)(int)src[i] : 0u;
    m[i >> 6][kZigzag[k]] = val * mul[k];
  }
  __syncthreads();

  const int sb = s0 + tid;
  if (sb >= n_sub) return;
  u32 v[64];
  uint8_t px[64];
#pragma unroll
  for (int r = 0; r < 64; r++) v[r] = m[tid][r];
  pfv::idct8x8_clamp(v, px);

  const int qd = sb & 3;
  uint8_t* dst = out + (size_t)(sb >> 2) * 256 + (qd >> 1) * 128 + (qd & 1) * 8;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint2 w;
    w.x = px[8 * i] | px[8 * i + 1] << 8 | px[8 * i + 2] << 16 | (u32)px[8 * i + 3] << 24;
    w.y = px[8 * i + 4] | px[8 * i + 5] << 8 | px[8 * i + 6] << 16 | (u32)px[8 * i + 7] << 24;
    *reinterpret_cast<uint2*>(dst + 16 * i) = w;
  }
}

}  // namespace

// coeffs (n_sub / 4, 4, 64) i16, q (64) i32 -> out (n_sub / 4, 16, 16) u8
// on `stream`; returns cudaGetLastError(). out must be 8-byte aligned.
extern "C" int pfv_idct_blocks(const void* coeffs, const void* q, void* out,
                               int n_sub, void* stream) {
  const int grid = (n_sub + kThreads - 1) / kThreads;
  idct_blocks_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int16_t*)coeffs, (const int*)q, (uint8_t*)out, n_sub);
  return (int)cudaGetLastError();
}
