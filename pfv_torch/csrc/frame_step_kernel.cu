// The frame step of the streaming decoder, the per-frame fallback and the
// encoder's in-loop reconstruction: K5 (dequantize + iDCT + clamp) and K7
// (prediction and select) as one kernel, one launch for one to three planes
// of a frame.
//
// Replaces: pfv_tpu/ops/pallas/idct_kernel.py, _idct_kernel (built by
// idct_clamp_packed, fed by decode_blocks_pallas) followed by
// pfv_tpu/ops/pallas/mc_kernel.py, _mc_kernel (built by
// mc_reconstruct_pallas): what pfv_tpu/dec.py iframe_decode_plane /
// pframe_decode_plane compute for each plane. The blocks never go through
// device memory between the two, and the skipped blocks of a P-frame are
// not inverse-transformed at all.
//
// Inputs: the frame's (nb, 256) i16 zigzag coefficients (four subblocks per
// macroblock, as the entropy decoder writes them), for a P-frame its three
// (nb,) block-header rows mvy, mvx (i8) and has_coeff (u8), and per plane a
// descriptor: its first block, its blocks per row and block rows (blocks in
// raster order, block b at (16*(b / nbx), 16*(b % nbx))), its row of the
// (nq, 64) i32 multiplier table (SCALE and q indexed by the zigzag slot,
// placed at the row-major position: quirk Q1), and the origin and row
// stride of the plane in `prev` and in `out`, so that a plane may be a view
// of a fused canvas.
//
// One CTA of 256 threads takes 32 macroblocks of one block row of one plane
// (the grid is flat: the planes' CTAs one after the other). Stages:
//   A: the 512 bytes of each block that needs its residual (every block of
//      an I-frame, the coded ones of a P-frame) with 32-byte loads, one
//      thread per 16 zigzag slots of a subblock; slot k of subblock q of
//      block m goes to acc[ZIGZAG[k]][4*m + q] (all 32 threads of a warp on
//      one row, 32 lanes: no bank conflict);
//   B: step_common.cuh's cooperative iDCT (eight threads per subblock);
//   C: one thread per 16-pixel block row, one 16-byte store. A P row takes
//      the window of the plane at start(16*by + mvy) + r, start(16*bx +
//      mvx), start(s, n) = clamp(s < 0 ? s + n : s, 0, n - 16) (K7's rule,
//      lax.dynamic_slice's, so the kernel agrees with its plain version on
//      any int8 vector; the decoders refuse vectors that leave the plane),
//      with window16 (the clamp keeps every byte it reads in the plane: with
//      w % 16 == 0 and sx % 4 != 0, sx & ~3 <= w - 20), then the select with
//      inter4. A CTA without a block that needs its residual skips A and B.
//
// What bounds it on this card: device-memory bytes (512 B of coefficients
// per decoded block, 1 B per pixel of prediction window and of output,
// 3 B of header per block); the iDCT's integer operations take less at the
// card's issue rate. Design: coefficients only of decoded blocks, 32-byte
// loads, the residual kept in shared memory, 16-byte rows; one launch per
// frame and one host call with pointers and q indices.

#include <cstdint>
#include <cuda_runtime.h>

#include "step_common.cuh"

namespace {

using pfv::kLanes;
using pfv::kMbs;
using pfv::kThreads;
using pfv::window_start;

constexpr int kMaxPlanes = 3;

// ZIGZAG_TABLE[k] = row-major position of zigzag slot k.
__constant__ int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

struct Plane {
  const int* mul;        // its 64 row-major multipliers
  const uint8_t* prev;   // its (0, 0) in the previous frame (null: intra)
  uint8_t* out;          // its (0, 0) in the output
  long long prev_stride, out_stride;
  int first;             // its first block in coeffs and the header rows
  int nbx, nby;          // blocks per row, block rows
  int lbs;               // CTAs per block row
  int cta0;              // its first CTA
};

struct Planes {
  Plane p[kMaxPlanes];
  int n;
};

__global__ void __launch_bounds__(kThreads, 4)
frame_step_kernel(const int16_t* __restrict__ coeffs, const int8_t* __restrict__ mvy,
                  const int8_t* __restrict__ mvx, const uint8_t* __restrict__ hc,
                  int intra, const Planes planes) {
  __shared__ __align__(16) pfv::Tile tile;

  Plane P = planes.p[0];
#pragma unroll
  for (int k = 1; k < kMaxPlanes; k++)
    if (k < planes.n && (int)blockIdx.x >= planes.p[k].cta0) P = planes.p[k];
  const int local = blockIdx.x - P.cta0;
  const int br = local / P.lbs, gc0 = (local % P.lbs) * kMbs;
  const long long row = P.first + (long long)br * P.nbx;  // block (br, 0)

  if (pfv::mark_needed(tile, intra, intra ? nullptr : hc + row, gc0, P.nbx)) {
    const int16_t* src = coeffs + (row + gc0) * 256;
    for (int p = threadIdx.x; p < 4 * kLanes; p += kThreads) {
      const int s = p / kLanes, l = p % kLanes;  // s is one per warp
      if (!tile.need[l >> 2]) continue;
      const int4* v = reinterpret_cast<const int4*>(src + l * 64 + s * 16);
      const int4 a = __ldcs(v), b = __ldcs(v + 1);
      const int pairs[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
      for (int j = 0; j < 8; j++) {  // slots 2j and 2j+1, little-endian
        tile.acc[kZigzag[16 * s + 2 * j]][l] = (int16_t)(pairs[j] & 0xFFFF);
        tile.acc[kZigzag[16 * s + 2 * j + 1]][l] = pairs[j] >> 16;
      }
    }
    __syncthreads();
    pfv::residual(tile, P.mul);
  }

  const int h = 16 * P.nby, w = 16 * P.nbx;
  for (int p = threadIdx.x; p < 16 * kMbs; p += kThreads) {
    const int r = p / kMbs, m = p % kMbs, gc = gc0 + m;
    if (gc >= P.nbx) continue;
    const long long b = row + gc;
    uint4 o = *reinterpret_cast<const uint4*>(&tile.res[r][16 * m]);
    if (!intra) {
      const int sy = window_start(16 * br + mvy[b], h) + r;
      const int sx = window_start(16 * gc + mvx[b], w);
      const uint4 pred = pfv::window16(P.prev + sy * P.prev_stride, sx);
      o = hc[b] ? make_uint4(pfv::inter4(pred.x, o.x), pfv::inter4(pred.y, o.y),
                             pfv::inter4(pred.z, o.z), pfv::inter4(pred.w, o.w))
                : pred;
    }
    *reinterpret_cast<uint4*>(P.out + (16LL * br + r) * P.out_stride + 16 * gc) = o;
  }
}

}  // namespace

// One frame step on `stream`; returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a plane count outside 1..3).
// coeffs (nb, 256) i16, 16-byte aligned; mvy, mvx (nb) i8 and hc (nb) u8,
// or all null for an I-frame (intra != 0); mul (nq, 64) i32; q0..q2 each
// plane's row of it. prev and out: the canvases (row strides prev_stride,
// out_stride; 16-byte aligned rows, prev null for an I-frame); layout: n
// descriptors of five int64 (first block, row and column of the plane's
// origin in the canvases, its height and width, multiples of 16).
extern "C" int pfv_frame_step(const void* coeffs, const void* mvy, const void* mvx,
                              const void* hc, int intra, const void* mul, int q0,
                              int q1, int q2, const void* prev, long long prev_stride,
                              void* out, long long out_stride, const long long* layout,
                              int n, void* stream) {
  if (n < 1 || n > kMaxPlanes) return (int)cudaErrorInvalidValue;
  const int q[kMaxPlanes] = {q0, q1, q2};
  Planes ps = {};
  ps.n = n;
  int ctas = 0;
  for (int k = 0; k < n; k++) {
    const long long* d = layout + 5 * k;
    Plane& p = ps.p[k];
    p.mul = (const int*)mul + 64 * q[k];
    p.prev = prev ? (const uint8_t*)prev + d[1] * prev_stride + d[2] : nullptr;
    p.out = (uint8_t*)out + d[1] * out_stride + d[2];
    p.prev_stride = prev_stride;
    p.out_stride = out_stride;
    p.first = (int)d[0];
    p.nby = (int)(d[3] / 16);
    p.nbx = (int)(d[4] / 16);
    p.lbs = (p.nbx + kMbs - 1) / kMbs;
    p.cta0 = ctas;
    ctas += p.nby * p.lbs;
  }
  if (ctas == 0) return 0;
  frame_step_kernel<<<ctas, kThreads, 0, (cudaStream_t)stream>>>(
      (const int16_t*)coeffs, (const int8_t*)mvy, (const int8_t*)mvx,
      (const uint8_t*)hc, intra, ps);
  return (int)cudaGetLastError();
}
