// K2, canvas -> packed RGBA8888: one thread per run of 8 pixels of two
// output rows that share a chroma row.
//
// Replaces: pfv_tpu/ops/pallas/rgb_kernel.py, _rgba_kernel (built by
// make_canvas_rgba). Same math; the TPU's one-hot expand matrices, lane
// chunking and width % 128 gate are not needed here.
//
// Pixel (f, y, x) reads Y = canvas[f][y][x], U = canvas[f][ly0 + y/2][x/2]
// and V = canvas[f][ly0 + y/2][lc1 + x/2] (point-sampled 4:2:0, quirk Q11),
// centres U and V by 128, and computes in float32 with the reference's op
// order R = Y + 1.402 V, G = (Y - 0.344136 U) - 0.714136 V, B = Y + 1.772 U,
// each saturated like Rust's `as u8` (clamp to [0, 255], truncate). The
// word is R | G << 8 | B << 16 | 0xFF << 24 (bytes R, G, B, A).
//
// Exactness: every product and sum is a separately rounded
// __fmul_rn/__fadd_rn/__fsub_rn, which nvcc never contracts into an FMA
// (the build also passes -fmad=false). The four products of a chroma
// sample are computed once and used by the 2x2 pixels that share it: the
// same operations on the same operands, so the same bits.
//
// What bounds it on this card: device-memory bytes, about 1.5 B of canvas
// in and 4 B out per pixel; the output of a clip is many times the L2 and
// nothing reads it back here. Design: a thread takes pixels [8c, 8c + 8) of
// rows 2p and 2p + 1: two 8-byte Y loads, one 4-byte U and one 4-byte V
// load (each chroma byte is fetched once), four 16-byte streaming stores
// (__stcs), so a warp's loads cover whole 128-byte lines of each row and
// its stores 1 KiB of each output row. A block is 64 chunks by 4 row pairs,
// the grid (chunk blocks, row-pair blocks, frames): no division per thread.
// The vector path needs width % 4 == 0 (16-byte aligned output rows),
// cw % 8 == 0, lc1 % 4 == 0 and aligned pointers, decided once per launch;
// without them, and in the last chunk of a row when width % 8 != 0, the
// thread takes its pixels one by one. The last row of an odd height has no
// partner.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 8;     // pixels per thread and row
constexpr int kChunksX = 64;  // blockDim.x: chunks of a row
constexpr int kPairsY = 4;    // blockDim.y: row pairs
constexpr unsigned kMaxGridZ = 65535;

__device__ __forceinline__ uint32_t sat_u8(float x) {
  return (uint32_t)(int)fminf(fmaxf(x, 0.0f), 255.0f);
}

// The chroma terms of one (U, V) sample, each product rounded on its own.
struct Chroma {
  float rv, gu, gv, bu;
};

__device__ __forceinline__ Chroma chroma_terms(uint32_t u, uint32_t v) {
  const float U = __fsub_rn((float)u, 128.0f), V = __fsub_rn((float)v, 128.0f);
  return {__fmul_rn(1.402f, V), __fmul_rn(0.344136f, U), __fmul_rn(0.714136f, V),
          __fmul_rn(1.772f, U)};
}

__device__ __forceinline__ uint32_t rgba_word(uint32_t y, const Chroma& c) {
  const float Y = (float)y;
  const float r = __fadd_rn(Y, c.rv);
  const float g = __fsub_rn(__fsub_rn(Y, c.gu), c.gv);
  const float b = __fadd_rn(Y, c.bu);
  return sat_u8(r) | (sat_u8(g) << 8) | (sat_u8(b) << 16) | 0xFF000000u;
}

__device__ __forceinline__ uint32_t byte_of(uint32_t w, int k) {
  return (w >> (8 * k)) & 255u;
}

__global__ void __launch_bounds__(kChunksX * kPairsY)
canvas_rgba_kernel(const uint8_t* __restrict__ canvas, uint32_t* __restrict__ out,
                   int frames, int chh, int cw, int height, int width, int ly0, int lc1,
                   int vec) {
  const int x0 = kChunk * (blockIdx.x * kChunksX + threadIdx.x);
  const int y0 = 2 * (blockIdx.y * kPairsY + threadIdx.y);
  if (x0 >= width || y0 >= height) return;
  const int rows = min(2, height - y0);
  for (int f = blockIdx.z; f < frames; f += gridDim.z) {
    const uint8_t* cv = canvas + (size_t)f * chh * cw;
    const uint8_t* yrow = cv + (size_t)y0 * cw + x0;
    const uint8_t* crow = cv + (size_t)(ly0 + (y0 >> 1)) * cw + (x0 >> 1);
    uint32_t* orow = out + ((size_t)f * height + y0) * width + x0;
    if (vec && x0 + kChunk <= width) {
      const uint32_t u = *reinterpret_cast<const uint32_t*>(crow);
      const uint32_t v = *reinterpret_cast<const uint32_t*>(crow + lc1);
      Chroma c[kChunk / 2];
#pragma unroll
      for (int k = 0; k < kChunk / 2; k++) c[k] = chroma_terms(byte_of(u, k), byte_of(v, k));
      for (int r = 0; r < rows; r++) {
        const uint2 y = *reinterpret_cast<const uint2*>(yrow + (size_t)r * cw);
        uint4* o = reinterpret_cast<uint4*>(orow + (size_t)r * width);
        __stcs(o, make_uint4(rgba_word(byte_of(y.x, 0), c[0]), rgba_word(byte_of(y.x, 1), c[0]),
                             rgba_word(byte_of(y.x, 2), c[1]), rgba_word(byte_of(y.x, 3), c[1])));
        __stcs(o + 1, make_uint4(rgba_word(byte_of(y.y, 0), c[2]), rgba_word(byte_of(y.y, 1), c[2]),
                                 rgba_word(byte_of(y.y, 2), c[3]), rgba_word(byte_of(y.y, 3), c[3])));
      }
    } else {
      const int n = min(kChunk, width - x0);
      for (int k = 0; k < n; k++) {
        const Chroma c = chroma_terms(crow[k >> 1], crow[lc1 + (k >> 1)]);
        for (int r = 0; r < rows; r++)
          orow[(size_t)r * width + k] = rgba_word(yrow[(size_t)r * cw + k], c);
      }
    }
  }
}

}  // namespace

// canvas (F, chh, cw) u8 -> out (F, height, width) u32 on `stream`;
// returns cudaGetLastError().
extern "C" int pfv_canvas_rgba(const void* canvas, void* out, int frames,
                               int chh, int cw, int height, int width, int ly0,
                               int lc1, void* stream) {
  const int chunks = (width + kChunk - 1) / kChunk, pairs = (height + 1) / 2;
  const dim3 block(kChunksX, kPairsY);
  const dim3 grid((chunks + kChunksX - 1) / kChunksX, (pairs + kPairsY - 1) / kPairsY,
                  (unsigned)frames < kMaxGridZ ? (unsigned)frames : kMaxGridZ);
  const int vec = width % 4 == 0 && cw % 8 == 0 && lc1 % 4 == 0 &&
                  (uintptr_t)canvas % 8 == 0 && (uintptr_t)out % 16 == 0;
  canvas_rgba_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)canvas, (uint32_t*)out, frames, chh, cw, height, width, ly0, lc1,
      vec);
  return (int)cudaGetLastError();
}
