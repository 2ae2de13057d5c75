// K7, motion-compensated reconstruction: one CTA per 16x16 macroblock, one
// thread per pixel.
//
// Replaces: pfv_tpu/ops/pallas/mc_kernel.py, _mc_kernel (built by
// mc_reconstruct_pallas), and with it the tail of ops/pframe.py
// decode_delta_blocks (gather_predictions, apply_residuals, where). The
// TPU's scalar-prefetched window starts and 64-block tiles are not carried
// over; unlike the Pallas kernel, this one writes each block straight into
// the output plane at its origin, through a row stride, so the output may
// be a view of a fused canvas.
//
// Block b at origin (by, bx) with motion (mvy, mvx) (int8, widened to int32
// before the add) reads the window of `ref` at
//   sy = start(by + mvy, h), sx = start(bx + mvx, w),
//   start(s, n) = clamp(s < 0 ? s + n : s, 0, n - 16)
// (lax.dynamic_slice's rule, so it agrees with the JAX package's gather on
// any input: the decoders reject vectors that leave the plane, and the
// clamp keeps every read in bounds whatever the input),
// then writes, by mode: intra -> res; coded (hc != 0) ->
// clamp(win + (res - 128) * 2, 0, 255); skip -> win. `ref` and `out` never
// overlap (the wrapper checks): a window may cover other blocks' outputs.
//
// What bounds it on this card: device-memory bytes, about 1 B of res, 1 B
// of window and 1 B of output per pixel. Design: res is read and the window
// rows are read 16 contiguous bytes at a time by neighbouring threads;
// writes are 16-byte rows. Origins outside the output plane write nothing.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int window_start(int s, int n) {
  return min(max(s < 0 ? s + n : s, 0), n - 16);
}

__global__ void __launch_bounds__(256)
mc_kernel(const uint8_t* __restrict__ res, const uint8_t* __restrict__ ref,
          int ref_stride, int h, int w, const int* __restrict__ by,
          const int* __restrict__ bx, const int8_t* __restrict__ mvy,
          const int8_t* __restrict__ mvx, const uint8_t* __restrict__ hc,
          int intra, uint8_t* __restrict__ out, int out_stride) {
  const int b = blockIdx.x;
  const int i = threadIdx.x >> 4, j = threadIdx.x & 15;
  const int oy = by[b], ox = bx[b];
  if ((unsigned)oy > (unsigned)(h - 16) || (unsigned)ox > (unsigned)(w - 16)) return;
  const int r = res[(size_t)b * 256 + threadIdx.x];
  int o = r;
  if (!intra) {
    const int sy = window_start(oy + (int)mvy[b], h);
    const int sx = window_start(ox + (int)mvx[b], w);
    const int win = ref[(size_t)(sy + i) * ref_stride + sx + j];
    o = hc[b] ? min(max(win + (r - 128) * 2, 0), 255) : win;
  }
  out[(size_t)(oy + i) * out_stride + ox + j] = (uint8_t)o;
}

}  // namespace

// res (n, 16, 16) u8; ref and out (h, w) u8 planes with row strides
// ref_stride and out_stride; by, bx (n) i32; mvy, mvx (n) i8; hc (n) u8.
// Launches on `stream`; returns cudaGetLastError().
extern "C" int pfv_mc_reconstruct(const void* res, const void* ref,
                                  int ref_stride, int h, int w, const void* by,
                                  const void* bx, const void* mvy,
                                  const void* mvx, const void* hc, int intra,
                                  void* out, int out_stride, int n,
                                  void* stream) {
  mc_kernel<<<n, 256, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)res, (const uint8_t*)ref, ref_stride, h, w,
      (const int*)by, (const int*)bx, (const int8_t*)mvy, (const int8_t*)mvx,
      (const uint8_t*)hc, intra, (uint8_t*)out, out_stride);
  return (int)cudaGetLastError();
}
