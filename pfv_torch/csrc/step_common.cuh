// The device code that the frame steps share: K1 (step_kernel.cu, fed by
// the tile demux's units) and K3/K4 (dense_step_kernel.cu, fed by dense
// coefficients), and their launch; the per-plane frame step of the
// streaming decoder and the encoder (frame_step_kernel.cu) takes the tile,
// mark_needed, residual, window_start, window16 and inter4; the encoder's
// frame-encode step (fdct_kernel.cu) the tile, mark_needed, window_start and
// window16. One CTA of kThreads threads
// reconstructs a 16-row stripe s of the fused Y|UV canvas over kCols
// columns: kLanes coefficient lanes, kMbs macroblocks. Its stages:
//
//   A (the kernel's own): the CTA's 64 x kLanes coefficients into the
//     shared int32 tile `acc` (row-major slot r, lane l);
//   B residual: eight threads per 8x8 subblock. Thread t takes column
//     i = t / 32 of the lanes l = 32p + lane_of(t % 32), p = 0..3: it
//     dequantizes the column with the 64 multipliers of the subblock's
//     plane (plane_residual: the frame's Y row in a luma stripe; in a
//     chroma stripe its U row left of block column guw, its V row from
//     there) in wrapping uint32 (Q1), runs the 8-point iDCT (dct8.cuh) and
//     writes the column back into the same eight words of `acc`; after a
//     barrier it takes row i of the same lanes, runs the iDCT, clamps
//     (m >> 8) + 128 to 0..255 and stores the row's 8 pixels with one
//     8-byte store into `res`:
//     lane l = 4*gc + 2*sr + sc, pixel (i, j) -> stripe row 8*sr + i,
//     column 16*gc + 8*sc + j. In every warp the 32 threads share i and
//     read 32 different lanes of one `acc` row (no bank conflict); each
//     half-warp shares sr, so its 8-byte stores fill one 128-byte run;
//   C store_tile: one thread per 16-pixel macroblock row. Intra rows take
//     the residual; P rows predict pred[c] = prev[16*s + r + dy][c + dx]
//     with the block's vector, 0 where the read leaves the canvas (or where
//     there is no prev), and a coded block takes clamp(pred + (res-128)*2)
//     in per-byte saturating SIMD, an uncoded one pred. The 16 prediction
//     bytes come from five aligned 4-byte loads and funnel shifts; only a
//     window that leaves the canvas on the left or right reads byte by
//     byte. Each row is written with one 16-byte store (cw % 16 == 0 and
//     16-byte aligned canvases, which the wrappers check).
//
// Programmatic dependent launch (Hopper): a clip's frames (or a GOP's
// steps) are launched back to back, each but the first with programmatic
// stream serialization. Every CTA first lets the next grid launch
// (launch_dependents), runs stages A and B, which read only its own
// frame's inputs (units or coefficients, maps, ftype, qmul: nothing a
// frame step writes), then waits for the previous grid to complete and
// flush its writes (wait_previous_grid) before stage C reads prev or
// writes the canvas. So frame f+1's densify and iDCT overlap frame f's
// prediction and store. Intra frames wait too, so that the canvases are
// written in stream order. The first launch of a call is an ordinary one:
// it waits for all earlier work on the stream, such as the copies and ops
// that made its inputs, and the later frames start only after it has.
// A P-frame CTA without a coded block skips stages A and B.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "dct8.cuh"

namespace pfv {

constexpr int kLanes = 128;        // coefficient lanes per CTA
constexpr int kCols = kLanes * 4;  // canvas columns per CTA
constexpr int kMbs = kCols / 16;   // macroblocks per CTA
constexpr int kThreads = 256;      // 8 threads per subblock, 4 passes

// The shared tile of a CTA: 40 KiB, static.
struct Tile {
  int acc[64][kLanes];         // coefficients; the column pass in place
  uint8_t res[16][kCols];      // residual pixels of the stripe
  uint8_t need[kMbs];          // the macroblock needs the residual
};

// cudaTriggerProgrammaticLaunchCompletion and cudaGridDependencySynchronize,
// as the PTX they stand for (sm_90); both are no-ops in a grid that was not
// launched with programmatic stream serialization.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}
__device__ __forceinline__ void wait_previous_grid() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// Fills t.need for the CTA's macroblocks from gc0 and returns, on every
// thread, whether any needs the residual: all of an intra frame's, the
// coded ones of a P frame's. hc_row: the stripe's (gcw,) coded flags.
__device__ __forceinline__ bool mark_needed(Tile& t, bool intra,
                                            const uint8_t* hc_row, int gc0,
                                            int gcw) {
  const int m = threadIdx.x;
  int need = 0;
  if (m < kMbs) {
    need = gc0 + m < gcw && (intra || hc_row[gc0 + m] != 0);
    t.need[m] = (uint8_t)need;
  }
  return __syncthreads_or(need);
}

// Stage B: the residual of the CTA's kLanes lanes from t.acc into t.res;
// qa: the 64 row-major multipliers of the CTA's macroblocks before `split`
// (counted from the CTA's first), qb: those of the macroblocks from it on.
// Ends in a barrier.
__device__ __forceinline__ void residual(Tile& t, const int* __restrict__ qa,
                                         const int* __restrict__ qb, int split) {
  const int i = threadIdx.x >> 5, w = threadIdx.x & 31;
  const int sr = w >> 4, gcl = (w & 15) >> 1, sc = w & 1;
  const int l0 = 4 * gcl + 2 * sr + sc;
#pragma unroll
  for (int p = 0; p < 4; p++) {
    const int l = 32 * p + l0;
    const int* __restrict__ q = 8 * p + gcl < split ? qa : qb;
    u32 qc[8];
#pragma unroll
    for (int k = 0; k < 8; k++) qc[k] = (u32)q[8 * k + i];
    u32 v[8];
#pragma unroll
    for (int k = 0; k < 8; k++) v[k] = (u32)t.acc[8 * k + i][l] * qc[k];
    idct8(v, 1);
#pragma unroll
    for (int k = 0; k < 8; k++) t.acc[8 * k + i][l] = (int)v[k];
  }
  __syncthreads();
#pragma unroll
  for (int p = 0; p < 4; p++) {
    const int l = 32 * p + l0;
    u32 v[8];
#pragma unroll
    for (int j = 0; j < 8; j++) v[j] = (u32)t.acc[8 * i + j][l];
    idct8(v, 1);
    u32 px[2] = {0, 0};
#pragma unroll
    for (int j = 0; j < 8; j++) {
      const int x = min(max(((int)v[j] >> 8) + 128, 0), 255);
      px[j >> 2] |= (u32)x << (8 * (j & 3));
    }
    *reinterpret_cast<uint2*>(&t.res[8 * sr + i][16 * (8 * p + gcl) + 8 * sc]) =
        make_uint2(px[0], px[1]);
  }
  __syncthreads();
}

// Stage B with one table q for every macroblock.
__device__ __forceinline__ void residual(Tile& t, const int* __restrict__ q) {
  residual(t, q, q, kMbs);
}

// Stage B of the fused canvas: qf, the frame's (3, 64) multipliers (rows
// Y, U, V); a luma stripe takes row Y, a chroma stripe row U for its block
// columns below guw (the U plane's) and row V from there; gc0: the CTA's
// first block column.
__device__ __forceinline__ void plane_residual(Tile& t, const int* __restrict__ qf,
                                               bool luma, int guw, int gc0) {
  if (luma) {
    residual(t, qf);
  } else {
    residual(t, qf + 64, qf + 128, guw - gc0);
  }
}

// Where a 16-pixel window whose start is s lies on an axis of n pixels, for
// any int8 vector: a negative start counts from the end of the axis, then
// the start clamps to [0, n - 16] (lax.dynamic_slice's rule, which the plain
// versions follow in ops/motion.py gather_predictions).
__device__ __forceinline__ int window_start(int s, int n) {
  return min(max(s < 0 ? s + n : s, 0), n - 16);
}

// The 16 bytes row[sx .. sx+15] as four little-endian words, from aligned
// 4-byte loads and funnel shifts: bytes [a, a + 20), a = sx & ~3, hold the
// window, and the fifth word is read only when sx % 4 != 0. row must be
// 4-byte aligned; in a row of a multiple of 16 bytes that holds the window,
// a + 19 lies inside the row whenever the fifth word is read.
__device__ __forceinline__ uint4 window16(const uint8_t* __restrict__ row, int sx) {
  const int a = sx & ~3, sh = 8 * (sx & 3);
  const u32* w = reinterpret_cast<const u32*>(row + a);
  const u32 w0 = w[0], w1 = w[1], w2 = w[2], w3 = w[3];
  const u32 w4 = sh ? w[4] : 0u;
  return make_uint4(__funnelshift_r(w0, w1, sh), __funnelshift_r(w1, w2, sh),
                    __funnelshift_r(w2, w3, sh), __funnelshift_r(w3, w4, sh));
}

// The 16 prediction bytes prev[sy][sx .. sx+15] as four little-endian
// words, 0 for every byte outside the (chh, cw) canvas or without prev.
__device__ __forceinline__ uint4 predict16(const uint8_t* __restrict__ prev,
                                           int sy, int sx, int chh, int cw) {
  uint4 o = make_uint4(0, 0, 0, 0);
  if (prev == nullptr || sy < 0 || sy >= chh) return o;
  const uint8_t* row = prev + (size_t)sy * cw;
  if (sx >= 0 && sx + 16 <= cw) return window16(row, sx);
  u32 b[4] = {0, 0, 0, 0};
#pragma unroll
  for (int k = 0; k < 16; k++) {
    const int x = sx + k;
    if (x >= 0 && x < cw) b[k >> 2] |= (u32)row[x] << (8 * (k & 3));
  }
  return make_uint4(b[0], b[1], b[2], b[3]);
}

// clamp(p + (r - 128) * 2, 0, 255) per byte: r >= 128 adds r - 128 twice
// with unsigned saturation, r < 128 subtracts 128 - r twice (the other
// term is 0 in each byte).
__device__ __forceinline__ u32 inter4(u32 p, u32 r) {
  const u32 up = __vsubus4(r, 0x80808080u), dn = __vsubus4(0x80808080u, r);
  return __vsubus4(__vsubus4(__vaddus4(__vaddus4(p, up), up), dn), dn);
}

// Stage C: predict, select and store the CTA's tile of stripe s from
// column c0. dy_row/dx_row/hc_row: the stripe's (gcw,) maps; prev: the
// previous (chh, cw) canvas or nullptr; dst_frame: the (chh, cw) output.
__device__ __forceinline__ void store_tile(const Tile& t, bool intra,
                                           const int8_t* __restrict__ dy_row,
                                           const int8_t* __restrict__ dx_row,
                                           const uint8_t* __restrict__ hc_row,
                                           const uint8_t* __restrict__ prev,
                                           uint8_t* __restrict__ dst_frame,
                                           int s, int c0, int chh, int cw) {
  for (int p = threadIdx.x; p < 16 * kMbs; p += kThreads) {
    const int r = p / kMbs, m = p % kMbs;
    const int c = c0 + 16 * m;
    if (c >= cw) continue;
    const int y = 16 * s + r;
    uint4 o;
    if (intra) {
      o = *reinterpret_cast<const uint4*>(&t.res[r][16 * m]);
    } else {
      const int b = c >> 4;
      o = predict16(prev, y + dy_row[b], c + dx_row[b], chh, cw);
      if (hc_row[b]) {
        const uint4 rv = *reinterpret_cast<const uint4*>(&t.res[r][16 * m]);
        o = make_uint4(inter4(o.x, rv.x), inter4(o.y, rv.y), inter4(o.z, rv.z),
                       inter4(o.w, rv.w));
      }
    }
    *reinterpret_cast<uint4*>(dst_frame + (size_t)y * cw + c) = o;
  }
}

inline dim3 grid_of(int chh, int cw, int batch) {
  return dim3(chh / 16, (cw / 16 + kMbs - 1) / kMbs, batch);
}

// Launches `kernel` on `stream`, with programmatic stream serialization
// when `after_first` (every launch of a call but its first); returns the
// launch's error, else cudaGetLastError().
template <class... Exp, class... Act>
inline cudaError_t launch(void (*kernel)(Exp...), dim3 grid, cudaStream_t stream,
                          bool after_first, Act... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = after_first ? 1 : 0;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e == cudaSuccess) e = cudaGetLastError();
  return e;
}

}  // namespace pfv
