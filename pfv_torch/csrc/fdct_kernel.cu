// K6, the frame-encode step: the forward DCT and quantization of every
// macroblock of a frame, one launch for one to three planes.
//
// Replaces: pfv_tpu/ops/pallas/dct_kernel.py, _fdct_kernel (built by
// fdct_packed, fed by encode_blocks_pallas), with what stays in XLA beside
// it there fused in: the quantization (ops/quant.py quantize) and, for a
// P-frame, the prediction window and the residual (ops/motion.py
// gather_predictions, ops/pframe.py calc_residuals, encode_delta_blocks).
// The TPU's (64, X) lane-packed transpose and its 512-lane padding are not
// carried over.
//
// Inputs: per plane a descriptor: the padded source plane (origin and row
// stride; the planes may be three tensors), its first block in the frame's
// raster-order blocks, its blocks per row and block rows, its row of the
// (nq, 64) u32 reciprocal table, and for a P-frame its origin in the
// previous reconstruction canvas; for a P-frame the frame's (nb,) rows mvy,
// mvx (i8) and has_coeff (u8). Output: the frame's (nb, 256) i16 zigzag
// coefficients (four subblocks per macroblock, as the entropy coder reads
// them), zero for a block without coefficients.
//
// Per 8x8 subblock: m = (px - 128) << 8 (intra) or tdiv(clamp(cur - win,
// -255, 255), 1) << 8 (P; win the window of the previous plane at
// window_start(16*by + mvy), window_start(16*bx + mvx), the frame step's
// rule), the 2-D forward DCT (dct8.cuh: rows first, then columns), and for
// each row-major position r
//   out[INV_ZIGZAG[r]] = ((m[r] * SCALE[r]) >> 16) / q[r]:
// SCALE and q are indexed by the row-major position (quirk Q1), the shift
// floors, the division truncates. The numerator n of the division is an
// int32 shifted right by 16, so -32768 <= n <= 32767, and for 1 <= q <=
// 65535 trunc(n / q) = sign(n) * ((2|n| * R) >> 32) with R = ceil(2^31 / q)
// (R <= 2^31 fits 32 bits; the error of n * R / 2^31 against n / q is below
// 2^-16 < 1 / q): one __umulhi, no division. The host makes R
// (ops/quant.py reciprocals); tests/test_torch_fdct.py holds the scheme to
// the truncating division for every numerator. Arithmetic is uint32, so
// adds and multiplies wrap (defined in C++), as the reference's release
// build and XLA's int32 do.
//
// One CTA of 256 threads takes 32 macroblocks of one block row of one plane
// (the grid is flat: the planes' CTAs one after the other). Stages:
//   A: one thread per 16-pixel row of each block that has coefficients
//      (every block of an I-frame, the coded ones of a P-frame): a 16-byte
//      load of the source row, for P the window row from five aligned loads
//      (window16), the 16 values px - 128 or trunc((cur - win) / 2), each
//      an int8, by byte-wise SIMD, one 16-byte store into the shared tile;
//   B: the cooperative transform, eight threads per subblock, the mirror of
//      step_common.cuh's residual: a thread takes row i of a subblock of
//      each of its lanes, widens it, runs fdct8 and writes it into the
//      int32 tile (32 threads of a warp on 32 lanes of one row: no bank
//      conflict); after a barrier it takes column i, runs fdct8, scales,
//      shifts and quantizes, and writes the column back in place;
//   C: one thread per 8 zigzag slots of a subblock gathers them from the
//      tile and stores 16 bytes, a warp 512 contiguous bytes; the tile's
//      lanes are swizzled by the chunk a position goes to, so that this
//      gather hits 32 banks too; a block without coefficients gets zeros.
// A CTA without a coded block writes zeros and does nothing else; within a
// CTA the lanes of blocks without coefficients are not transformed.
//
// What bounds it on this card: device-memory bytes (1 B per source pixel,
// 2 B per coefficient written, zeros included, 1 B per pixel of window and
// 3 B of header for a P-block). The transform's ~32 integer operations per
// coefficient of a coded block come level with the bytes at the card's
// instruction rate when every block is coded (an I-frame), far below them
// on a P-frame, most of whose blocks are skipped. Design: rows and windows
// read in place (no block copy, no window gather), only coded blocks
// transformed, the transform in shared memory at 8 threads per subblock, no
// division, 16-byte loads, every warp's stores on 512 contiguous bytes, one
// launch and one host call per frame.

#include <cstdint>
#include <cuda_runtime.h>

#include "step_common.cuh"

namespace {

using pfv::kLanes;
using pfv::kMbs;
using pfv::kThreads;
using pfv::u32;

constexpr int kMaxPlanes = 3;

// ZIGZAG_TABLE[k] = row-major position of zigzag slot k.
__constant__ int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// INV_ZIGZAG_TABLE[r] = zigzag slot of row-major position r.
__constant__ int kInvZigzag[64] = {
    0,  1,  5,  6,  14, 15, 27, 28, 2,  4,  7,  13, 16, 26, 29, 42,
    3,  8,  12, 17, 25, 30, 41, 43, 9,  11, 18, 24, 31, 40, 44, 53,
    10, 19, 23, 32, 39, 45, 52, 54, 20, 22, 33, 38, 46, 51, 55, 60,
    21, 34, 37, 47, 50, 56, 59, 61, 35, 36, 48, 49, 57, 58, 62, 63};

// DCT_SCALE_FACTOR, indexed by the row-major position at encode (quirk Q1).
__constant__ u32 kScale[64] = {
    32, 37, 34, 26, 32, 26, 34, 37, 37, 43, 39, 31, 37, 31, 39, 43,
    34, 39, 35, 28, 34, 28, 35, 39, 26, 31, 28, 22, 26, 22, 28, 31,
    32, 37, 34, 26, 32, 26, 34, 37, 26, 31, 28, 22, 26, 22, 28, 31,
    34, 39, 35, 28, 34, 28, 35, 39, 37, 43, 39, 31, 37, 31, 39, 43};

struct Plane {
  const uint8_t* src;   // its (0, 0) in the source
  const uint8_t* prev;  // its (0, 0) in the previous reconstruction (null: intra)
  const u32* recip;     // its 64 reciprocals, by row-major position
  long long src_stride, prev_stride;
  int first;            // its first block in the header rows and in out
  int nbx, nby;         // blocks per row, block rows
  int lbs;              // CTAs per block row
  int cta0;             // its first CTA
};

struct Planes {
  Plane p[kMaxPlanes];
  int n;
};

// Where lane l of row-major position r lives in a row of the tile's acc:
// the lane's bits 2..4 are xored with the 16-byte chunk (zigzag slot / 8) the
// position is stored to. A warp of stage B works on one position and 32
// lanes that differ in their low five bits, a warp of stage C on 4 lanes
// and 8 chunks: both touch 32 different banks.
__device__ __forceinline__ int swizzled(int l, int chunk) { return l ^ (4 * chunk); }

// trunc((c - w) / 2) of four u8 pairs, each result an int8 in its byte.
__device__ __forceinline__ u32 half_diff4(u32 c, u32 w) {
  const u32 half = (__vabsdiffu4(c, w) >> 1) & 0x7F7F7F7Fu;
  const u32 neg = __vcmpltu4(c, w);  // 0xFF where the difference is negative
  return __vsub4(half ^ neg, neg);
}

// Stage B: tile.res holds the int8 values m >> 8 of the CTA's stripe; the
// quantized coefficients of every lane whose block is needed end up in
// tile.acc at their row-major position, lanes swizzled. Ends in a barrier.
__device__ __forceinline__ void forward(pfv::Tile& t, const u32* __restrict__ recip) {
  const int i = threadIdx.x >> 5, w = threadIdx.x & 31;
  const int sr = w >> 4, gcl = (w & 15) >> 1, sc = w & 1;
  const int l0 = 4 * gcl + 2 * sr + sc;
  int chunk[8];  // of the positions 8 * k + i
#pragma unroll
  for (int k = 0; k < 8; k++) chunk[k] = kInvZigzag[8 * k + i] >> 3;
#pragma unroll
  for (int p = 0; p < 4; p++) {  // rows first
    if (!t.need[8 * p + gcl]) continue;
    const int l = 32 * p + l0;
    const uint2 px =
        *reinterpret_cast<const uint2*>(&t.res[8 * sr + i][16 * (8 * p + gcl) + 8 * sc]);
    u32 v[8];
#pragma unroll
    for (int j = 0; j < 8; j++) {
      const u32 word = j < 4 ? px.x : px.y;
      v[j] = (u32)(int)(int8_t)(word >> (8 * (j & 3))) << 8;
    }
    pfv::fdct8(v, 1);
#pragma unroll
    for (int j = 0; j < 8; j++)
      t.acc[8 * i + j][swizzled(l, kInvZigzag[8 * i + j] >> 3)] = (int)v[j];
  }
  __syncthreads();
  u32 rc[8], scale[8];
#pragma unroll
  for (int k = 0; k < 8; k++) {
    rc[k] = recip[8 * k + i];
    scale[k] = kScale[8 * k + i];
  }
#pragma unroll
  for (int p = 0; p < 4; p++) {  // then columns
    if (!t.need[8 * p + gcl]) continue;
    const int l = 32 * p + l0;
    u32 v[8];
#pragma unroll
    for (int k = 0; k < 8; k++) v[k] = (u32)t.acc[8 * k + i][swizzled(l, chunk[k])];
    pfv::fdct8(v, 1);
#pragma unroll
    for (int k = 0; k < 8; k++) {
      const int n = (int)(v[k] * scale[k]) >> 16;
      const int mag = (int)__umulhi(2u * (u32)abs(n), rc[k]);
      t.acc[8 * k + i][swizzled(l, chunk[k])] = n < 0 ? -mag : mag;
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 4)
frame_encode_kernel(const int8_t* __restrict__ mvy, const int8_t* __restrict__ mvx,
                    const uint8_t* __restrict__ hc, int intra, int16_t* __restrict__ out,
                    const Planes planes) {
  __shared__ __align__(16) pfv::Tile tile;
  __shared__ uint8_t zigzag[64];  // kZigzag, for stage C's per-thread index

  if (threadIdx.x < 64) zigzag[threadIdx.x] = (uint8_t)kZigzag[threadIdx.x];
  Plane P = planes.p[0];
#pragma unroll
  for (int k = 1; k < kMaxPlanes; k++)
    if (k < planes.n && (int)blockIdx.x >= planes.p[k].cta0) P = planes.p[k];
  const int local = blockIdx.x - P.cta0;
  const int br = local / P.lbs, gc0 = (local % P.lbs) * kMbs;
  const long long row = P.first + (long long)br * P.nbx;  // block (br, 0)

  int16_t* dst = out + (row + gc0) * 256;
  const int mbs = min(kMbs, P.nbx - gc0);
  if (!pfv::mark_needed(tile, intra, intra ? nullptr : hc + row, gc0, P.nbx)) {
    // no coded block: zeros, a warp on 512 contiguous bytes
    int4* o = reinterpret_cast<int4*>(dst);
    for (int p = threadIdx.x; p < 32 * mbs; p += kThreads) o[p] = make_int4(0, 0, 0, 0);
    return;
  }

  const int h = 16 * P.nby, w = 16 * P.nbx;
  for (int p = threadIdx.x; p < 16 * kMbs; p += kThreads) {
    const int r = p / kMbs, m = p % kMbs, gc = gc0 + m;
    if (!tile.need[m]) continue;
    uint4 c = *reinterpret_cast<const uint4*>(P.src + (16LL * br + r) * P.src_stride +
                                              16 * gc);
    if (intra) {  // px - 128 as an int8
      c = make_uint4(c.x ^ 0x80808080u, c.y ^ 0x80808080u, c.z ^ 0x80808080u,
                     c.w ^ 0x80808080u);
    } else {
      const long long b = row + gc;
      const int sy = pfv::window_start(16 * br + mvy[b], h) + r;
      const int sx = pfv::window_start(16 * gc + mvx[b], w);
      const uint4 win = pfv::window16(P.prev + sy * P.prev_stride, sx);
      c = make_uint4(half_diff4(c.x, win.x), half_diff4(c.y, win.y),
                     half_diff4(c.z, win.z), half_diff4(c.w, win.w));
    }
    *reinterpret_cast<uint4*>(&tile.res[r][16 * m]) = c;
  }
  __syncthreads();
  forward(tile, P.recip);

  for (int p = threadIdx.x; p < 8 * kLanes; p += kThreads) {
    const int l = p >> 3, c = p & 7;  // chunk c of lane l: slots 8c .. 8c + 7
    if (l >= 4 * mbs) break;
    int4 o = make_int4(0, 0, 0, 0);
    if (tile.need[l >> 2]) {
      u32 pairs[4];
#pragma unroll
      for (int j = 0; j < 4; j++)  // slots 2j and 2j+1, little-endian
        pairs[j] = ((u32)tile.acc[zigzag[8 * c + 2 * j]][swizzled(l, c)] & 0xFFFFu) |
                   ((u32)tile.acc[zigzag[8 * c + 2 * j + 1]][swizzled(l, c)] << 16);
      o = make_int4((int)pairs[0], (int)pairs[1], (int)pairs[2], (int)pairs[3]);
    }
    reinterpret_cast<int4*>(dst)[p] = o;
  }
}

}  // namespace

// One frame-encode step on `stream`; returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for a plane count outside 1..3).
// src0..src2: each plane's padded u8 source (row strides stride0..stride2,
// 16-byte aligned rows); mvy, mvx (nb) i8 and hc (nb) u8, or all null for
// an I-frame (intra != 0); recip (nq, 64) u32, q0..q2 each plane's row of
// it; prev: the previous reconstruction canvas (row stride prev_stride,
// 4-byte aligned rows; null for an I-frame); out (nb, 256) i16, 16-byte
// aligned; layout: n descriptors of five int64 (first block, row and column
// of the plane's origin in prev, its height and width, multiples of 16).
extern "C" int pfv_frame_encode(const void* src0, const void* src1, const void* src2,
                                long long stride0, long long stride1, long long stride2,
                                const void* mvy, const void* mvx, const void* hc,
                                int intra, const void* recip, int q0, int q1, int q2,
                                const void* prev, long long prev_stride, void* out,
                                const long long* layout, int n, void* stream) {
  if (n < 1 || n > kMaxPlanes) return (int)cudaErrorInvalidValue;
  const void* src[kMaxPlanes] = {src0, src1, src2};
  const long long stride[kMaxPlanes] = {stride0, stride1, stride2};
  const int q[kMaxPlanes] = {q0, q1, q2};
  Planes ps = {};
  ps.n = n;
  int ctas = 0;
  for (int k = 0; k < n; k++) {
    const long long* d = layout + 5 * k;
    Plane& p = ps.p[k];
    p.src = (const uint8_t*)src[k];
    p.prev = prev ? (const uint8_t*)prev + d[1] * prev_stride + d[2] : nullptr;
    p.recip = (const u32*)recip + 64 * q[k];
    p.src_stride = stride[k];
    p.prev_stride = prev_stride;
    p.first = (int)d[0];
    p.nby = (int)(d[3] / 16);
    p.nbx = (int)(d[4] / 16);
    p.lbs = (p.nbx + kMbs - 1) / kMbs;
    p.cta0 = ctas;
    ctas += p.nby * p.lbs;
  }
  if (ctas == 0) return 0;
  frame_encode_kernel<<<ctas, kThreads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)mvy, (const int8_t*)mvx, (const uint8_t*)hc, intra, (int16_t*)out,
      ps);
  return (int)cudaGetLastError();
}
