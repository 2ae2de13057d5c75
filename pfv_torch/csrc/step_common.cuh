// The device code that the frame steps share: K1 (step_kernel.cu, fed by
// the tile demux's units) and K3/K4 (dense_step_kernel.cu, fed by dense
// coefficients). One CTA reconstructs a 16-row stripe s of the fused Y|UV
// canvas over kCols columns: kLanes coefficient lanes, 32 macroblocks.
//
//   lane_residual: thread l dequantizes its lane's 64 coefficients with
//     qmul[I/P][luma/chroma][r] in wrapping int32 (Q1), runs the integer
//     8x8 iDCT (dct8.cuh), columns then rows, clamps (m >> 8) + 128 to
//     0..255, and merges lane l = 4*gc + 2*sr + sc, pixel (i, j) to stripe
//     row 8*sr + i, column 16*gc + 8*sc + j of the shared tile `res`;
//   store_tile: predicts pred[r][c] = prev[16*s + r + dy][c + dx] with the
//     destination block's vector, 0 where the read would leave the canvas
//     (or where there is no prev), and selects: intra takes the residual
//     pixels, a coded P block clamp(pred + (res - 128) * 2), an uncoded one
//     pred; stores are byte-coalesced rows.
// A P-frame CTA without a coded block (cta_needs_residual false) skips the
// coefficient load and lane_residual: store_tile then never reads `res`.

#pragma once

#include <cstdint>

#include "dct8.cuh"

namespace pfv {

constexpr int kLanes = 128;        // coefficient lanes per CTA
constexpr int kCols = kLanes * 4;  // canvas columns per CTA
constexpr int kThreads = kLanes;   // one thread per lane in the iDCT

// True on every thread of the CTA when the stripe's columns [gc0*16,
// gc0*16 + kCols) need the residual: always for intra, for a P frame when
// one of its blocks is coded. hc_row: the stripe's (gcw,) coded flags.
__device__ __forceinline__ bool cta_needs_residual(bool intra,
                                                   const uint8_t* hc_row,
                                                   int gc0, int gcw) {
  const int t = threadIdx.x;
  int need = intra;
  if (!intra && t < kCols / 16 && gc0 + t < gcw) need = hc_row[gc0 + t] != 0;
  return __syncthreads_or(need);
}

// Lane l's subblock into res; coef(r) gives its coefficient in row-major
// slot r, q the 64 multipliers of the frame type and region.
template <class Coef>
__device__ __forceinline__ void lane_residual(Coef coef, const int* q, int l,
                                              uint8_t (&res)[16][kCols]) {
  u32 v[64];
  uint8_t px[64];
#pragma unroll
  for (int r = 0; r < 64; r++) v[r] = (u32)coef(r) * (u32)q[r];
  idct8x8_clamp(v, px);
  const int row0 = 8 * ((l >> 1) & 1);
  const int col0 = 16 * (l >> 2) + 8 * (l & 1);
#pragma unroll
  for (int i = 0; i < 8; i++) {
#pragma unroll
    for (int j = 0; j < 8; j++) res[row0 + i][col0 + j] = px[8 * i + j];
  }
}

// Predict, select and store the CTA's tile of stripe s from column c0.
// dy_row/dx_row/hc_row: the stripe's (gcw,) maps; prev: the previous
// (chh, cw) canvas or nullptr; dst_frame: the (chh, cw) output canvas.
__device__ __forceinline__ void store_tile(const uint8_t (&res)[16][kCols],
                                           bool intra, const int8_t* dy_row,
                                           const int8_t* dx_row,
                                           const uint8_t* hc_row,
                                           const uint8_t* prev,
                                           uint8_t* dst_frame, int s, int c0,
                                           int chh, int cw) {
  const int ncols = min(kCols, cw - c0);
  uint8_t* dst = dst_frame + (size_t)s * 16 * cw + c0;
  for (int p = threadIdx.x; p < 16 * kCols; p += kThreads) {
    const int r = p / kCols, cl = p % kCols;
    if (cl >= ncols) continue;
    int o;
    if (intra) {
      o = res[r][cl];
    } else {
      const int c = c0 + cl;
      const int b = c >> 4;
      const int sy = s * 16 + r + dy_row[b], sx = c + dx_row[b];
      int pred = 0;
      if (prev && sy >= 0 && sy < chh && sx >= 0 && sx < cw) pred = prev[(size_t)sy * cw + sx];
      o = hc_row[b] ? min(max(pred + (res[r][cl] - 128) * 2, 0), 255) : pred;
    }
    dst[(size_t)r * cw + cl] = (uint8_t)o;
  }
}

}  // namespace pfv
