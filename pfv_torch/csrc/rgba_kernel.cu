// K2, canvas -> packed RGBA8888: one thread per output pixel.
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
// (the build also passes -fmad=false).
//
// What bounds it on this card: device-memory bytes, about 1 B of canvas in
// and 4 B out per pixel. Design: a block covers 256 consecutive pixels of
// one output row, so loads and 4-byte stores are coalesced; chroma rows are
// shared by neighbouring threads through L1.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t sat_u8(float x) {
  return (uint32_t)(int)fminf(fmaxf(x, 0.0f), 255.0f);
}

__global__ void __launch_bounds__(kThreads)
canvas_rgba_kernel(const uint8_t* __restrict__ canvas, uint32_t* __restrict__ out,
                   int chh, int cw, int height, int width, int ly0, int lc1) {
  const int x = blockIdx.y * kThreads + threadIdx.x;
  if (x >= width) return;
  const int f = blockIdx.x / height, y = blockIdx.x % height;
  const uint8_t* cv = canvas + (size_t)f * chh * cw;
  const uint8_t* crow = cv + (size_t)(ly0 + (y >> 1)) * cw;
  const float Y = (float)cv[(size_t)y * cw + x];
  const float U = __fsub_rn((float)crow[x >> 1], 128.0f);
  const float V = __fsub_rn((float)crow[lc1 + (x >> 1)], 128.0f);
  const float r = __fadd_rn(Y, __fmul_rn(1.402f, V));
  const float g = __fsub_rn(__fsub_rn(Y, __fmul_rn(0.344136f, U)), __fmul_rn(0.714136f, V));
  const float b = __fadd_rn(Y, __fmul_rn(1.772f, U));
  out[((size_t)f * height + y) * width + x] =
      sat_u8(r) | (sat_u8(g) << 8) | (sat_u8(b) << 16) | 0xFF000000u;
}

}  // namespace

// canvas (F, chh, cw) u8 -> out (F, height, width) u32 on `stream`;
// returns cudaGetLastError().
extern "C" int pfv_canvas_rgba(const void* canvas, void* out, int frames,
                               int chh, int cw, int height, int width, int ly0,
                               int lc1, void* stream) {
  const dim3 grid((unsigned)frames * (unsigned)height, (width + kThreads - 1) / kThreads);
  canvas_rgba_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)canvas, (uint32_t*)out, chh, cw, height, width, ly0, lc1);
  return (int)cudaGetLastError();
}
