// K3 and K4, the dense-input frame steps: one kernel, two entries, each one
// host call that launches a whole clip (K3) or the L steps of a batch of
// GOPs (K4).
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
// One CTA: frame b of the batch, stripe s, 128 lanes (512 columns). Its
// threads load the 64 rows x 128 lanes of coefficients with 16-byte loads
// (8 lanes, two macroblocks, each), skipping those of macroblocks without
// a coded block, widen them to int32 in shared memory, then run
// step_common.cuh's cooperative iDCT, prediction and select, as K1 does. A
// P-frame CTA without a coded block reads no coefficient and runs no iDCT.
//
// Every frame dequantizes with its own (3, 64) multipliers, by the plane of
// each subblock (step_common.cuh's plane_residual).
//
// The two entries: pfv_dense_seq_clip launches the frames of a clip (or of
// one chunk of a clip), frame f predicting from frame f-1 of the output
// itself and frame 0 from `prev` (zeros without one); pfv_dense_gops
// launches L steps for a batch of G GOPs, grid (stripes, lane blocks, G):
// step l decodes frame l of every GOP from frame l-1 of the same GOP (from
// `prev`, or zeros, for step 0). Each tensor has a stride per GOP and per
// step, so the GOPs are read and written in place in (G, L, ...) tensors.
// In both, every launch but the first uses programmatic stream
// serialization (step_common.cuh says why the order is safe).
//
// Not carried over from the TPU: the band DMA and its gch/sb >= 4 ordering
// bound (a kernel boundary per frame orders the reads), the 33-way select
// ladders and the per-stripe gating table (an indexed load), the MXU lane
// merge (a direct store), stripes per grid step, and the GOP width-concat
// (the batch axis of the grid). Neither |mv| <= 16 nor cw % 128 == 0 is
// needed, and any width with row_span < 2^24 works.
//
// Its least time is the bytes': per frame it reads the coefficients of
// decoded blocks (512 B each) and writes the canvas (1 B per pixel),
// reading the previous canvas once more for P frames; the iDCT's integer
// operations (~26 per decoded coefficient) take less at the card's issue
// rate, also at 8K. Design: eight threads per subblock, 16-byte
// coefficient loads and canvas rows, coded-block skipping, and the
// previous frame's store overlapped with this frame's iDCT.

#include <cstdint>
#include <cuda_runtime.h>

#include "step_common.cuh"

namespace {

using pfv::kLanes;
using pfv::kMbs;
using pfv::kThreads;

__global__ void __launch_bounds__(kThreads, 4)
dense_step_kernel(const int16_t* __restrict__ coeffs, long long cstride,
                  const int8_t* __restrict__ dy, const int8_t* __restrict__ dx,
                  const uint8_t* __restrict__ hc, long long mstride,
                  const int* __restrict__ ftype, long long fstride,
                  const int* __restrict__ qmul, long long qstride,
                  const uint8_t* __restrict__ prev, long long pstride,
                  uint8_t* __restrict__ out, long long ostride, int chh, int cw,
                  int gly, int guw, int row_span) {
  __shared__ __align__(16) pfv::Tile tile;
  pfv::launch_dependents();

  const int s = blockIdx.x;
  const int lb = blockIdx.y;
  const long long b = blockIdx.z;
  const int tid = threadIdx.x;
  const int gch = chh >> 4, gcw = cw >> 4;
  const bool intra = ftype[b * fstride] == 1;
  const long long maps = b * mstride + (long long)s * gcw;

  if (pfv::mark_needed(tile, intra, hc + maps, lb * kMbs, gcw)) {
    const int16_t* src = coeffs + b * cstride + (long long)s * (row_span / gch)
        + lb * kLanes;
    constexpr int kChunks = kLanes / 8;  // 16-byte chunks per row
    for (int p = tid; p < 64 * kChunks; p += kThreads) {
      const int r = p / kChunks, c = p % kChunks;
      if (!(tile.need[2 * c] | tile.need[2 * c + 1])) continue;
      const int4 v = __ldcs(reinterpret_cast<const int4*>(src + (long long)r * row_span) + c);
      int4* dst = reinterpret_cast<int4*>(&tile.acc[r][8 * c]);
      dst[0] = make_int4((int16_t)(v.x & 0xFFFF), v.x >> 16, (int16_t)(v.y & 0xFFFF), v.y >> 16);
      dst[1] = make_int4((int16_t)(v.z & 0xFFFF), v.z >> 16, (int16_t)(v.w & 0xFFFF), v.w >> 16);
    }
    __syncthreads();
    pfv::plane_residual(tile, qmul + b * qstride, s < gly, guw, lb * kMbs);
  }

  pfv::wait_previous_grid();
  pfv::store_tile(tile, intra, dy + maps, dx + maps, hc + maps,
                  prev ? prev + b * pstride : nullptr, out + b * ostride, s,
                  lb * pfv::kCols, chh, cw);
}

}  // namespace

// K3: launches frames 0 .. frames-1 of the clip on `stream`; returns the
// first launch's error (cudaGetLastError() after each), else 0.
// coeffs (F, 64, row_span) i16, dy/dx (F, gch, gcw) i8, hc (F, gch, gcw)
// u8, ftype (F) i32, qmul (F, 3, 64) i32, prev (chh, cw) u8 or null for
// zeros, out (F, chh, cw) u8; coeffs and canvases 16-byte aligned; guw: U's
// block columns in a chroma stripe. The first launch is an ordinary one, so
// `prev` may be the last canvas of the call before on the stream.
extern "C" int pfv_dense_seq_clip(const void* coeffs, const void* dy,
                                  const void* dx, const void* hc,
                                  const void* ftype, const void* qmul,
                                  const void* prev, void* out, int frames, int chh,
                                  int cw, int gly, int guw, int row_span,
                                  void* stream) {
  const long long plane = (long long)chh * cw;
  const long long maps = (long long)(chh / 16) * (cw / 16);
  const dim3 grid = pfv::grid_of(chh, cw, 1);
  for (int f = 0; f < frames; f++) {
    const long long fr = f;
    const cudaError_t e = pfv::launch(
        dense_step_kernel, grid, (cudaStream_t)stream, f > 0,
        (const int16_t*)coeffs + fr * 64 * row_span, 0LL,
        (const int8_t*)dy + fr * maps, (const int8_t*)dx + fr * maps,
        (const uint8_t*)hc + fr * maps, 0LL, (const int*)ftype + fr, 0LL,
        (const int*)qmul + fr * 192, 0LL,
        f > 0 ? (const uint8_t*)out + (fr - 1) * plane : (const uint8_t*)prev,
        0LL, (uint8_t*)out + fr * plane, 0LL, chh, cw, gly, guw, row_span);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

// K4: launches the `steps` steps of a batch of `gops` GOPs on `stream`;
// returns the first launch's error (cudaGetLastError() after each), else
// 0. Frame (g, l) of each argument starts g * (its GOP stride) + l * (its
// step stride) elements after its pointer: coeffs (64, row_span) i16,
// dy/dx/hc (gch, gcw) i8/i8/u8 (one pair of strides), ftype one i32, qmul
// (3, 64) i32 (the frame's multipliers of Y, U and V), out (chh, cw) u8.
// prev: GOP g's (chh, cw) u8 canvas before step 0 at g * pstride, or null
// for zeros. Canvases and coeffs 16-byte aligned; guw: U's block columns
// in a chroma stripe.
extern "C" int pfv_dense_gops(const void* prev, long long pstride,
                              const void* coeffs, long long cs_g, long long cs_l,
                              const void* dy, const void* dx, const void* hc,
                              long long ms_g, long long ms_l, const void* ftype,
                              long long fs_g, long long fs_l, const void* qmul,
                              long long qs_g, long long qs_l, void* out,
                              long long os_g, long long os_l, int gops, int steps,
                              int chh, int cw, int gly, int guw, int row_span,
                              void* stream) {
  const dim3 grid = pfv::grid_of(chh, cw, gops);
  for (int l = 0; l < steps; l++) {
    const long long m = l * ms_l;
    const cudaError_t e = pfv::launch(
        dense_step_kernel, grid, (cudaStream_t)stream, l > 0,
        (const int16_t*)coeffs + l * cs_l, cs_g, (const int8_t*)dy + m,
        (const int8_t*)dx + m, (const uint8_t*)hc + m, ms_g,
        (const int*)ftype + l * fs_l, fs_g, (const int*)qmul + l * qs_l, qs_g,
        l > 0 ? (const uint8_t*)out + (l - 1) * os_l : (const uint8_t*)prev,
        l > 0 ? os_g : pstride, (uint8_t*)out + l * os_l, os_g, chh, cw, gly, guw,
        row_span);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}
