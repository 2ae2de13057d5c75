// K1, the frame-step kernel: one launch decodes one frame of the fused
// Y|UV canvas from the tile demux's coefficient units.
//
// Replaces: pfv_tpu/ops/pallas/step_kernel.py, _seq_kernel_units (built by
// make_step_seq_units). What it computes is the same; the TPU structure
// (band DMA and its write-before-prefetch ordering, 33-way motion select
// ladders, one-hot MXU densify and merge, stripes per grid step) is not
// carried over.
//
// For frame f, stripe s (16 canvas rows) and a block of 128 coefficient
// lanes (32 macroblocks, 512 canvas columns), one CTA:
//   1. densifies the units of tile t = f*gch + s (chunks coff[t]..coff[t+1]
//      of `units`; word = idx << 16 | (u16)(i16)val, idx = r << 10 | lane)
//      into a 64 x 128 int32 shared-memory accumulator with atomicAdd,
//      which is exact in any order (a coefficient may span several units);
//   2. dequantizes with qmul[I/P][luma/chroma][r] in wrapping int32 (Q1);
//   3. runs the integer 8x8 iDCT (dct8.cuh), columns then rows, one
//      thread per lane, and clamps (m >> 8) + 128 to 0..255;
//   4. merges lane l = 4*gc + 2*sr + sc, pixel (i, j) to stripe row
//      8*sr + i, column 16*gc + 8*sc + j (lanes past the canvas drop out);
//   5. for P frames predicts pred[r][c] = prev[16*s + r + dy][c + dx] with
//      the destination block's vector, 0 where the read would leave the
//      canvas; prev is frame f-1 of the output itself (stream order);
//   6. selects: intra takes the residual pixels, a coded P block
//      clamp(pred + (res - 128) * 2), an uncoded one pred.
// A P-frame CTA without a coded block skips steps 1-4.
//
// What bounds it on this card: the unit scan (each of the CTAs of a stripe
// reads all of that tile's units and keeps its own lanes) and the canvas
// bytes (one byte written per pixel, one read per P-frame pixel). Design:
// lanes are split across CTAs so the accumulator is 32 KiB of static shared
// memory (a whole 1080p stripe would need 128 KiB), units are read
// coalesced, zero words are skipped, and stores are byte-coalesced rows.
// Integer adds and multiplies run on uint32 so wrapping is defined.

#include <cstdint>
#include <cuda_runtime.h>

#include "dct8.cuh"

namespace {

constexpr int kLanes = 128;             // coefficient lanes per CTA
constexpr int kCols = kLanes * 4;       // canvas columns per CTA
constexpr int kThreads = kLanes;        // one thread per lane in the iDCT

using pfv::u32;

__global__ void __launch_bounds__(kThreads)
step_frame_kernel(const u32* __restrict__ units, const int* __restrict__ coff,
                  const int8_t* __restrict__ dy, const int8_t* __restrict__ dx,
                  const uint8_t* __restrict__ hc, const int* __restrict__ ftype,
                  const int* __restrict__ qmul, uint8_t* __restrict__ out,
                  int f, int chh, int cw, int gly, int chunk) {
  __shared__ int acc[64][kLanes];
  __shared__ uint8_t res[16][kCols];

  const int s = blockIdx.x;
  const int lb = blockIdx.y;
  const int tid = threadIdx.x;
  const int gch = chh >> 4, gcw = cw >> 4;
  const int gc0 = lb * (kCols / 16);
  const int c0 = lb * kCols;
  const bool intra = ftype[f] == 1;
  const size_t plane = (size_t)chh * cw;
  const size_t maps = ((size_t)f * gch + s) * gcw;

  int need = intra;
  if (!intra && tid < kCols / 16 && gc0 + tid < gcw) need = hc[maps + gc0 + tid] != 0;
  need = __syncthreads_or(need);

  if (need) {
    for (int i = tid; i < 64 * kLanes; i += kThreads) (&acc[0][0])[i] = 0;
    __syncthreads();
    const int t = f * gch + s;
    const long long w1 = (long long)coff[t + 1] * chunk;
    for (long long w = (long long)coff[t] * chunk + tid; w < w1; w += kThreads) {
      const u32 word = units[w];
      const int val = (int)(int16_t)(word & 0xFFFFu);
      if (val == 0) continue;
      const int idx = (int)(word >> 16);
      const int lane = (idx & 1023) - lb * kLanes;
      if ((unsigned)lane < (unsigned)kLanes) atomicAdd(&acc[idx >> 10][lane], val);
    }
    __syncthreads();

    const int l = tid;
    if (gc0 + (l >> 2) < gcw) {
      const int* q = qmul + ((intra ? 0 : 2) + (s < gly ? 0 : 1)) * 64;
      u32 v[64];
      uint8_t px[64];
#pragma unroll
      for (int r = 0; r < 64; r++) v[r] = (u32)acc[r][l] * (u32)q[r];
      pfv::idct8x8_clamp(v, px);
      const int row0 = 8 * ((l >> 1) & 1);
      const int col0 = 16 * (l >> 2) + 8 * (l & 1);
#pragma unroll
      for (int i = 0; i < 8; i++) {
#pragma unroll
        for (int j = 0; j < 8; j++) res[row0 + i][col0 + j] = px[8 * i + j];
      }
    }
    __syncthreads();
  }

  const int ncols = min(kCols, cw - c0);
  uint8_t* dst = out + (size_t)f * plane + (size_t)s * 16 * cw + c0;
  const uint8_t* prev = f > 0 ? out + (size_t)(f - 1) * plane : nullptr;
  for (int p = tid; p < 16 * kCols; p += kThreads) {
    const int r = p / kCols, cl = p % kCols;
    if (cl >= ncols) continue;
    int o;
    if (intra) {
      o = res[r][cl];
    } else {
      const int c = c0 + cl;
      const size_t b = maps + (c >> 4);
      const int sy = s * 16 + r + dy[b], sx = c + dx[b];
      int pred = 0;
      if (prev && sy >= 0 && sy < chh && sx >= 0 && sx < cw) pred = prev[(size_t)sy * cw + sx];
      o = hc[b] ? min(max(pred + (res[r][cl] - 128) * 2, 0), 255) : pred;
    }
    dst[(size_t)r * cw + cl] = (uint8_t)o;
  }
}

}  // namespace

// Launches frame f of the clip on `stream`; returns cudaGetLastError().
// units (NC, chunk) u32, coff (F*gch + 1) i32, dy/dx (F, gch, gcw) i8,
// hc (F, gch, gcw) u8, ftype (F) i32, qmul (2, 2, 64) i32,
// out (F, chh, cw) u8.
extern "C" int pfv_step_frame(const void* units, const void* coff,
                              const void* dy, const void* dx, const void* hc,
                              const void* ftype, const void* qmul, void* out,
                              int f, int chh, int cw, int gly, int chunk,
                              void* stream) {
  const dim3 grid(chh / 16, (cw / 16 + kCols / 16 - 1) / (kCols / 16));
  step_frame_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const u32*)units, (const int*)coff, (const int8_t*)dy,
      (const int8_t*)dx, (const uint8_t*)hc, (const int*)ftype,
      (const int*)qmul, (uint8_t*)out, f, chh, cw, gly, chunk);
  return (int)cudaGetLastError();
}
