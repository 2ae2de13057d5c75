// K3 and K4, the dense-input frame steps: one kernel, two entries.
//
// Replaces: pfv_tpu/ops/pallas/step_kernel.py, _seq_kernel (K3, the
// whole-clip decode, built by make_step_seq) and _step_kernel (K4, one
// frame step from an explicit previous canvas, built by make_step, run in a
// lax.scan or under vmap over GOPs). They compute what K1 computes, fed by
// dense coefficients (F, 64, row_span) i16 instead of the tile demux's
// units: row r is the row-major (unzigzagged) slot, column
// s*2*scp + l the lane l = 4*gc + 2*sr + sc of stripe s, row_span =
// gch*2*scp. That tensor is what a device scatter of the pstep unit stream
// gives (dataloader.densify_pstep), for widths whose lanes do not fit the
// units' 10-bit lane field (2*scp > 1024, wider than ~4K).
//
// One CTA: frame b of the batch, stripe s, 128 lanes (512 columns). Thread
// l reads its lane's 64 coefficients, coalesced across the CTA (64 rows x
// 128 lanes x 2 B = 16 KiB), then step_common.cuh's dequantize, iDCT,
// merge, prediction and select, as in K1. A P-frame CTA without a coded
// block reads no coefficient and runs no iDCT.
//
// The two entries: pfv_dense_seq_frame launches frame f of a clip, its
// prediction read from frame f-1 of the output itself (stream order), one
// launch per frame as K1; pfv_dense_step_batch launches one step for a
// batch of B frames with their own previous canvases (the GOPs of one
// stream side by side), grid (stripes, lane blocks, B), each batch axis
// with its own stride so that the frames of step l of every GOP are read
// and written in place in (G, L, ...) tensors.
//
// Not carried over from the TPU: the band DMA and its gch/sb >= 4 ordering
// bound (a kernel boundary per frame orders the reads), the 33-way select
// ladders and the per-stripe gating table (an indexed load), the MXU lane
// merge (a direct store), stripes per grid step, and the GOP width-concat
// (the batch axis of the grid). Neither |mv| <= 16 nor cw % 128 == 0 is
// needed, and any width with row_span < 2^24 works.
//
// What bounds it on this card: device-memory bytes. Per frame it reads the
// dense coefficients (2 B per coefficient slot, 2*64*row_span B: 106 MB
// at 8K) and writes the canvas (1 B per pixel), reading the previous canvas
// once more for P frames; the iDCT is ~30 integer operations per
// coefficient, under the byte time. Design: coalesced coefficient rows, no
// shared-memory accumulator (8 KiB of shared memory per CTA against K1's
// 40 KiB), coded-block skipping, byte-coalesced stores.

#include <cstdint>
#include <cuda_runtime.h>

#include "step_common.cuh"

namespace {

using pfv::kCols;
using pfv::kLanes;
using pfv::kThreads;

__global__ void __launch_bounds__(kThreads)
dense_step_kernel(const int16_t* __restrict__ coeffs, long long cstride,
                  const int8_t* __restrict__ dy, const int8_t* __restrict__ dx,
                  const uint8_t* __restrict__ hc, long long mstride,
                  const int* __restrict__ ftype, long long fstride,
                  const int* __restrict__ qmul,
                  const uint8_t* __restrict__ prev, long long pstride,
                  uint8_t* __restrict__ out, long long ostride, int chh, int cw,
                  int gly, int row_span) {
  __shared__ uint8_t res[16][kCols];

  const int s = blockIdx.x;
  const int lb = blockIdx.y;
  const long long b = blockIdx.z;
  const int tid = threadIdx.x;
  const int gch = chh >> 4, gcw = cw >> 4;
  const int gc0 = lb * (kCols / 16);
  const bool intra = ftype[b * fstride] == 1;
  const long long maps = b * mstride + (long long)s * gcw;

  if (pfv::cta_needs_residual(intra, hc + maps, gc0, gcw)) {
    if (gc0 + (tid >> 2) < gcw) {
      const int16_t* src = coeffs + b * cstride
          + (long long)s * (row_span / gch) + lb * kLanes + tid;
      const int* q = qmul + ((intra ? 0 : 2) + (s < gly ? 0 : 1)) * 64;
      pfv::lane_residual([&](int r) { return (int)src[(long long)r * row_span]; },
                         q, tid, res);
    }
    __syncthreads();
  }

  pfv::store_tile(res, intra, dy + maps, dx + maps, hc + maps,
                  prev ? prev + b * pstride : nullptr, out + b * ostride, s,
                  lb * kCols, chh, cw);
}

dim3 grid_of(int chh, int cw, int batch) {
  return dim3(chh / 16, (cw / 16 + kCols / 16 - 1) / (kCols / 16), batch);
}

}  // namespace

// K3: launches frame f of the clip on `stream`; returns cudaGetLastError().
// coeffs (F, 64, row_span) i16, dy/dx (F, gch, gcw) i8, hc (F, gch, gcw)
// u8, ftype (F) i32, qmul (2, 2, 64) i32, out (F, chh, cw) u8.
extern "C" int pfv_dense_seq_frame(const void* coeffs, const void* dy,
                                   const void* dx, const void* hc,
                                   const void* ftype, const void* qmul,
                                   void* out, int f, int chh, int cw, int gly,
                                   int row_span, void* stream) {
  const long long plane = (long long)chh * cw;
  const long long maps = (long long)(chh / 16) * (cw / 16);
  const long long fr = f;
  dense_step_kernel<<<grid_of(chh, cw, 1), kThreads, 0, (cudaStream_t)stream>>>(
      (const int16_t*)coeffs + fr * 64 * row_span, 0,
      (const int8_t*)dy + fr * maps, (const int8_t*)dx + fr * maps,
      (const uint8_t*)hc + fr * maps, 0, (const int*)ftype + fr, 0,
      (const int*)qmul, f > 0 ? (const uint8_t*)out + (fr - 1) * plane : nullptr,
      0, (uint8_t*)out + fr * plane, 0, chh, cw, gly, row_span);
  return (int)cudaGetLastError();
}

// K4: launches one step for a batch of B frames on `stream`; returns
// cudaGetLastError(). Item b of each argument starts b * (its stride)
// elements after its pointer: prev and out (chh, cw) u8, coeffs
// (64, row_span) i16, dy/dx/hc (gch, gcw) i8/i8/u8 (one stride), ftype one
// i32; qmul (2, 2, 64) i32 is shared.
extern "C" int pfv_dense_step_batch(const void* prev, long long pstride,
                                    const void* coeffs, long long cstride,
                                    const void* dy, const void* dx,
                                    const void* hc, long long mstride,
                                    const void* ftype, long long fstride,
                                    const void* qmul, void* out,
                                    long long ostride, int batch, int chh,
                                    int cw, int gly, int row_span,
                                    void* stream) {
  dense_step_kernel<<<grid_of(chh, cw, batch), kThreads, 0, (cudaStream_t)stream>>>(
      (const int16_t*)coeffs, cstride, (const int8_t*)dy, (const int8_t*)dx,
      (const uint8_t*)hc, mstride, (const int*)ftype, fstride,
      (const int*)qmul, (const uint8_t*)prev, pstride, (uint8_t*)out, ostride,
      chh, cw, gly, row_span);
  return (int)cudaGetLastError();
}
