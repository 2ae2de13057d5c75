// K6, forward DCT + quantization: (N, 16, 16) u8 macroblocks and a (64,)
// int32 q-table -> (N, 4, 64) int16 zigzag coefficients, one 8x8 subblock
// per thread. Two entries:
//   intra: m = (px - 128) << 8;
//   delta: m = tdiv(clamp(cur - win, -255, 255), 1) << 8, win being the
//          motion search's winning window of each block;
// then the 2-D forward DCT (dct8.cuh: rows, then columns) and
//   out[INV_ZIGZAG[r]] = ((m[r] * SCALE[r]) >> 16) / q[r]
// for each row-major position r: quantize indexes SCALE and q by the
// row-major position (quirk Q1), the shift floors, the division truncates.
//
// Replaces: pfv_tpu/ops/pallas/dct_kernel.py, _fdct_kernel (built by
// fdct_packed, fed by encode_blocks_pallas), with the quantization that
// stays in XLA there fused in, and the delta encode of ops/pframe.py
// (calc_residuals, encode_delta_blocks), which is XLA there. The TPU's
// (64, X) lane-packed transpose and its 512-lane padding are not carried
// over.
//
// A CTA of 128 threads takes 32 macroblocks (128 subblocks):
//   1. loads their pixels (and windows) coalesced, 4 bytes per thread, and
//      stores each word at its subblock's place in shared memory, 16 words
//      per subblock plus one of padding, so that step 2 reads hit 32
//      distinct banks;
//   2. each thread unpacks its subblock into 64 registers, runs the
//      transform, quantizes in row-major order (every thread at the same
//      position at once: the tables are read as broadcasts) and writes
//      each value to its zigzag slot of its row in shared memory;
//   3. the CTA stores its 16 KiB of coefficients coalesced, 4 bytes per
//      thread.
// Arithmetic is uint32, so adds and multiplies wrap (defined in C++), as
// the reference's release build and XLA's int32 do.
//
// What bounds it on this card: about 1 B of pixels in (2 B for the delta
// entry) and 2 B of coefficients out per pixel, against ~200 integer
// operations and one integer division per coefficient; at 1080p (3.1 MB of
// pixels per frame) the bytes take ~3 us, so the instruction count, the
// division most, sets the time. Design: the transform in registers, the
// divisions by a q-table held in shared memory, coalesced loads and stores
// through shared memory.

#include <cstdint>
#include <cuda_runtime.h>

#include "dct8.cuh"

namespace {

using pfv::u32;

constexpr int kThreads = 128;        // subblocks per CTA, one per thread
constexpr int kBlocks = kThreads / 4;  // macroblocks per CTA
constexpr int kPixRow = 17;          // words per subblock of pixels, padded
constexpr int kOutRow = 33;          // words per subblock of coefficients, padded

// INV_ZIGZAG_TABLE[r] = zigzag slot of row-major position r.
__constant__ int kInvZigzag[64] = {
    0,  1,  5,  6,  14, 15, 27, 28, 2,  4,  7,  13, 16, 26, 29, 42,
    3,  8,  12, 17, 25, 30, 41, 43, 9,  11, 18, 24, 31, 40, 44, 53,
    10, 19, 23, 32, 39, 45, 52, 54, 20, 22, 33, 38, 46, 51, 55, 60,
    21, 34, 37, 47, 50, 56, 59, 61, 35, 36, 48, 49, 57, 58, 62, 63};

// DCT_SCALE_FACTOR, indexed by the row-major position at encode (quirk Q1).
__constant__ int kScale[64] = {
    32, 37, 34, 26, 32, 26, 34, 37, 37, 43, 39, 31, 37, 31, 39, 43,
    34, 39, 35, 28, 34, 28, 35, 39, 26, 31, 28, 22, 26, 22, 28, 31,
    32, 37, 34, 26, 32, 26, 34, 37, 26, 31, 28, 22, 26, 22, 28, 31,
    34, 39, 35, 28, 34, 28, 35, 39, 37, 43, 39, 31, 37, 31, 39, 43};

// Word i of a CTA's pixels (macroblock i / 64, row (i / 4) % 16, columns
// 4 * (i % 4) ..) -> its word in the subblock-major shared layout.
__device__ __forceinline__ int pixel_slot(int i) {
  const int mb = i >> 6, r = (i >> 2) & 15, c = i & 3;
  return (mb * 4 + (r >> 3) * 2 + (c >> 1)) * kPixRow + (r & 7) * 2 + (c & 1);
}

template <bool kDelta>
__global__ void __launch_bounds__(kThreads)
fdct_kernel(const uint8_t* __restrict__ cur, const uint8_t* __restrict__ win,
            const int* __restrict__ q, int16_t* __restrict__ out, int n_mb) {
  constexpr int kWin = kDelta ? 1 : 0;  // index of the windows in px
  __shared__ u32 px[kWin + 1][kThreads * kPixRow];
  __shared__ u32 co[kThreads * kOutRow];
  __shared__ int qs[64];

  const int tid = threadIdx.x;
  const int mb0 = blockIdx.x * kBlocks;
  if (tid < 64) qs[tid] = q[tid];

  const int words = min(kBlocks, n_mb - mb0) * 64;
  const u32* src = reinterpret_cast<const u32*>(cur + (size_t)mb0 * 256);
  const u32* wsrc = kDelta ? reinterpret_cast<const u32*>(win + (size_t)mb0 * 256)
                           : nullptr;
  for (int i = tid; i < kBlocks * 64; i += kThreads) {
    const int d = pixel_slot(i);
    px[0][d] = i < words ? src[i] : 0u;
    if (kDelta) px[kWin][d] = i < words ? wsrc[i] : 0u;
  }
  __syncthreads();

  u32 v[64];
#pragma unroll
  for (int k = 0; k < 16; k++) {
    const u32 a = px[0][tid * kPixRow + k];
    const u32 b = kDelta ? px[kWin][tid * kPixRow + k] : 0u;
#pragma unroll
    for (int e = 0; e < 4; e++) {
      const int x = (int)((a >> (8 * e)) & 255u);
      int m;
      if (kDelta) {
        const int d = min(max(x - (int)((b >> (8 * e)) & 255u), -255), 255);
        m = d / 2;  // truncating, as tdiv_pow2(d, 1)
      } else {
        m = x - 128;
      }
      v[4 * k + e] = (u32)m << 8;
    }
  }
#pragma unroll
  for (int i = 0; i < 8; i++) pfv::fdct8(v + 8 * i, 1);  // rows first
#pragma unroll
  for (int j = 0; j < 8; j++) pfv::fdct8(v + j, 8);      // then columns

  int16_t* row = reinterpret_cast<int16_t*>(co + tid * kOutRow);
#pragma unroll
  for (int r = 0; r < 64; r++) {
    const int n = (int)(v[r] * (u32)kScale[r]) >> 16;
    row[kInvZigzag[r]] = (int16_t)(n / qs[r]);
  }
  __syncthreads();

  const int out_words = min(kThreads, 4 * (n_mb - mb0)) * 32;
  u32* dst = reinterpret_cast<u32*>(out + (size_t)mb0 * 256);
  for (int i = tid; i < out_words; i += kThreads) {
    dst[i] = co[(i >> 5) * kOutRow + (i & 31)];
  }
}

}  // namespace

// cur (and win, unless null: the intra entry) (n_mb, 16, 16) u8, q (64) i32
// -> out (n_mb, 4, 64) i16 on `stream`; returns cudaGetLastError(). cur,
// win and out must be 4-byte aligned.
extern "C" int pfv_fdct_blocks(const void* cur, const void* win, const void* q,
                               void* out, int n_mb, void* stream) {
  const int grid = (n_mb + kBlocks - 1) / kBlocks;
  cudaStream_t s = (cudaStream_t)stream;
  if (win) {
    fdct_kernel<true><<<grid, kThreads, 0, s>>>(
        (const uint8_t*)cur, (const uint8_t*)win, (const int*)q, (int16_t*)out, n_mb);
  } else {
    fdct_kernel<false><<<grid, kThreads, 0, s>>>(
        (const uint8_t*)cur, nullptr, (const int*)q, (int16_t*)out, n_mb);
  }
  return (int)cudaGetLastError();
}
