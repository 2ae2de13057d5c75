// K1, the frame-step kernel: one launch decodes one frame of the fused
// Y|UV canvas from the tile demux's coefficient units; one host call
// (pfv_step_clip) launches every frame of a clip.
//
// Replaces: pfv_tpu/ops/pallas/step_kernel.py, _seq_kernel_units (built by
// make_step_seq_units). What it computes is the same; the TPU structure
// (band DMA and its write-before-prefetch ordering, 33-way motion select
// ladders, one-hot MXU densify and merge, stripes per grid step) is not
// carried over.
//
// For frame f, stripe s (16 canvas rows) and a block of 128 coefficient
// lanes (32 macroblocks, 512 canvas columns), one CTA densifies the units
// of tile t = f*gch + s (chunks coff[t]..coff[t+1] of `units`; word =
// idx << 16 | (u16)(i16)val, idx = r << 10 | lane) into the 64 x 128 int32
// shared tile with atomicAdd, which is exact in any order (a coefficient
// may span several units); the dequantize, iDCT, merge, prediction and
// select are step_common.cuh's, shared with K3/K4; the dequantization takes
// frame f's own multipliers for each subblock's plane. The prediction reads
// frame f-1 of the output itself, after the grid-dependency wait, and
// frame 0 reads the starting canvas `prev` (zeros without one). A P-frame
// CTA without a coded block skips the densify and the iDCT.
//
// Its least time is the bytes' (0.12 ms per 1080p clip; the integer
// operations take less at the card's issue rate). Design: eight threads
// per subblock (a short dependency chain per thread, 256 threads per
// CTA), 16-byte canvas rows, programmatic
// dependent launch so a frame's densify and iDCT overlap the previous
// frame's store, and one host call per clip. Each of the CTAs of a stripe
// still reads all of that tile's units and keeps its own lanes: lanes are
// split across CTAs so the accumulator stays 32 KiB of static shared
// memory (a whole 1080p stripe would need 128 KiB). Integer adds and
// multiplies run on uint32 so wrapping is defined.

#include <cstdint>
#include <cuda_runtime.h>

#include "step_common.cuh"

namespace {

using pfv::kLanes;
using pfv::kMbs;
using pfv::kThreads;
using pfv::u32;

__global__ void __launch_bounds__(kThreads, 4)
step_frame_kernel(const u32* __restrict__ units, const int* __restrict__ coff,
                  const int8_t* __restrict__ dy, const int8_t* __restrict__ dx,
                  const uint8_t* __restrict__ hc, const int* __restrict__ ftype,
                  const int* __restrict__ qmul, const uint8_t* __restrict__ prev,
                  uint8_t* __restrict__ out, int f, int chh, int cw, int gly, int guw,
                  int chunk) {
  __shared__ __align__(16) pfv::Tile tile;
  pfv::launch_dependents();

  const int s = blockIdx.x;
  const int lb = blockIdx.y;
  const int tid = threadIdx.x;
  const int gch = chh >> 4, gcw = cw >> 4;
  const int gc0 = lb * kMbs;
  const bool intra = ftype[f] == 1;
  const size_t plane = (size_t)chh * cw;
  const size_t maps = ((size_t)f * gch + s) * gcw;

  if (pfv::mark_needed(tile, intra, hc + maps, gc0, gcw)) {
    int4* acc4 = reinterpret_cast<int4*>(&tile.acc[0][0]);
    for (int i = tid; i < 64 * kLanes / 4; i += kThreads) acc4[i] = make_int4(0, 0, 0, 0);
    __syncthreads();
    const int t = f * gch + s;
    const long long w1 = (long long)coff[t + 1] * chunk;
    for (long long w = (long long)coff[t] * chunk + tid; w < w1; w += kThreads) {
      const u32 word = units[w];
      const int val = (int)(int16_t)(word & 0xFFFFu);
      if (val == 0) continue;
      const int idx = (int)(word >> 16);
      const int lane = (idx & 1023) - lb * kLanes;
      if ((unsigned)lane < (unsigned)kLanes) atomicAdd(&tile.acc[idx >> 10][lane], val);
    }
    __syncthreads();
    pfv::plane_residual(tile, qmul + (size_t)f * 192, s < gly, guw, gc0);
  }

  pfv::wait_previous_grid();
  pfv::store_tile(tile, intra, dy + maps, dx + maps, hc + maps,
                  f > 0 ? out + (size_t)(f - 1) * plane : prev,
                  out + (size_t)f * plane, s, lb * pfv::kCols, chh, cw);
}

}  // namespace

// Launches frames 0 .. frames-1 of the clip on `stream`, the first as an
// ordinary launch and the others with programmatic stream serialization;
// returns the first launch's error (cudaGetLastError() after each), else 0.
// units (NC, chunk) u32, coff (F*gch + 1) i32, dy/dx (F, gch, gcw) i8,
// hc (F, gch, gcw) u8, ftype (F) i32, qmul (F, 3, 64) i32 (frame f's
// multipliers of Y, U and V), prev (chh, cw) u8 or null (zeros), out
// (F, chh, cw) u8, canvases 16-byte aligned; guw: U's block columns in a
// chroma stripe (V's start there). The first launch being an ordinary one,
// `prev` may be written by the work before the call on the stream.
extern "C" int pfv_step_clip(const void* units, const void* coff,
                             const void* dy, const void* dx, const void* hc,
                             const void* ftype, const void* qmul, const void* prev,
                             void* out, int frames, int chh, int cw, int gly, int guw,
                             int chunk, void* stream) {
  const dim3 grid = pfv::grid_of(chh, cw, 1);
  for (int f = 0; f < frames; f++) {
    const cudaError_t e = pfv::launch(
        step_frame_kernel, grid, (cudaStream_t)stream, f > 0, (const u32*)units,
        (const int*)coff, (const int8_t*)dy, (const int8_t*)dx,
        (const uint8_t*)hc, (const int*)ftype, (const int*)qmul,
        (const uint8_t*)prev, (uint8_t*)out, f, chh, cw, gly, guw, chunk);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}
