// K8, the encoder's motion search: the four-step search of every macroblock
// of a P-frame, one launch for one to three planes.
//
// Replaces: pfv_tpu/ops/motion.py, motion_search (no Pallas kernel there:
// XLA compiles it into the whole-clip encode program, pfv_tpu/encoding.py
// encode_scan), and with it the comparison against the skip threshold that
// follows it in pfv_tpu/ops/pframe.py encode_plane_delta. The one-hot matrix
// products that pick the windows on the TPU are not carried over: a window
// is a run of bytes in shared memory.
//
// Inputs: per plane a descriptor: the padded source plane (origin and row
// stride; the planes may be three tensors), its origin in the previous
// reconstruction canvas (a plane may be a view of a fused canvas), its first
// block in the frame's raster-order blocks, its blocks per row and block
// rows; the skip threshold min_err (float32). Output: the frame's (nb,) rows
// mvy, mvx (i8) and has_coeff (u8).
//
// Per 16x16 block at (y0, x0) of an (h, w) plane: the centre starts at the
// block's origin; for step = 8, 4, 2, 1 the nine candidates centre + step *
// (mx, my), the centre first (priority 0) and then the ring with my outer
// and mx inner (priorities 1..8); a candidate whose window leaves the plane
// (x < 0, x > w - 16, y < 0, y > h - 16) is skipped, never clamped; a
// candidate's error is the sum of the 256 squared u8 differences (< 2^24,
// exact in int32); the smallest err * 16 + priority wins, so the first of
// equals does, and becomes the next centre. The centre of steps 4, 2 and 1
// is the winner before it, whose error is carried and not summed again.
// Then mvx = x - x0, mvy = y - y0 (|v| <= 15) and has_coeff = float(err) >
// min_err.
//
// One CTA of 8 warps takes 8 neighbouring blocks of one block row of one
// plane (the grid is flat: the planes' CTAs one after the other), a warp a
// block. The CTA stages the part of the previous plane its searches can
// reach, rows y0 - 15 .. y0 + 30 and columns x0 - 16 .. x0 + 143 clipped to
// the plane (so no byte outside the plane's view is read: a window that
// leaves U to the right is refused and V is never touched), with 16-byte
// loads into a shared tile of 46 rows. A lane keeps one 16-pixel row of the
// source block in four registers for the whole walk (row lane % 16); the two
// half-warps take two candidates of a step at a time, priorities 2t + 1 and
// 2t + 2 in turn t, so a step is four turns. Per turn a lane reads the 24
// aligned bytes that hold its 16 window pixels with three 8-byte loads,
// lines them up with funnel shifts, takes |c - w| of four pixels at a time
// (__vabsdiffu4) and their squares' sum (__dp4a), and the warp adds each
// half-warp's 16 partial sums with one redux (__reduce_add_sync, the other
// half's lanes adding 0), which leaves both errors on every lane. A candidate off
// the plane is summed at the centre's place (a place that is in the tile)
// and its score is the largest int. After the four turns the halves swap
// their best scores with one shuffle; every lane then holds the step's
// winner, so the walk has no divergent branch. The tile's pitch of 168
// bytes = 21 8-byte words, an odd number, puts the 16 rows of a half-warp's
// window on 16 different 8-byte bank pairs: no bank conflict.
//
// What bounds it on this card: the bytes, 1 B per pixel of source and of
// previous plane and 3 B of header per block; the search itself needs only
// the eight byte-wise SIMD operations and one add per 16 pixels of a
// candidate (33 candidates per block away from the plane's edges), a little
// less time than the bytes at 1080p. The body runs about five times those
// operations (positions, edge tests, addresses, shared loads, word selects,
// funnel shifts, the redux, the score), and that is where its time goes.
// Design: the reachable region staged once per 8 blocks (each byte of the
// previous plane is read from device memory or L2 about 4 times instead of
// 33), the source in registers, 16 pixels per lane and candidate so that the
// address, the edge tests, the redux and the score are paid once per 16
// pixels, byte-wise SIMD, no atomics, no divergent branch, one launch per
// frame and one host call.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

using u32 = unsigned int;

constexpr int kMaxPlanes = 3;
constexpr int kWarps = 8;                 // blocks per CTA
constexpr int kThreads = 32 * kWarps;
constexpr int kReach = 15;                // 8 + 4 + 2 + 1
constexpr int kRows = 16 + 2 * kReach;    // rows a block's searches can reach
constexpr int kCols = 16 * kWarps + 32;   // a margin of 16 on each side: aligned loads
constexpr int kPitch = kCols + 8;         // 168 B: see the note on banks above

struct Plane {
  const uint8_t* src;   // its (0, 0) in the source
  const uint8_t* prev;  // its (0, 0) in the previous reconstruction
  long long src_stride, prev_stride;
  int first;            // its first block in the header rows
  int nbx, nby;         // blocks per row, block rows
  int lbs;              // CTAs per block row
  int cta0;             // its first CTA
};

struct Planes {
  Plane p[kMaxPlanes];
  int n;
};

// The offset (mx or my) of the ring's candidate of priority k = 1..8: the
// 3x3 neighbourhood in raster order, the centre left out.
__device__ __forceinline__ int ring_x(int k) { return (k - 1 + (k > 4)) % 3 - 1; }
__device__ __forceinline__ int ring_y(int k) { return (k - 1 + (k > 4)) / 3 - 1; }

__global__ void __launch_bounds__(kThreads)
motion_search_kernel(int8_t* __restrict__ mvy, int8_t* __restrict__ mvx,
                     uint8_t* __restrict__ hc, float min_err, const Planes planes) {
  // 16 bytes more: a lane's third 8-byte load may lie past its window
  __shared__ __align__(16) uint8_t tile[kRows * kPitch + 16];

  Plane P = planes.p[0];
#pragma unroll
  for (int k = 1; k < kMaxPlanes; k++)
    if (k < planes.n && (int)blockIdx.x >= planes.p[k].cta0) P = planes.p[k];
  const int local = blockIdx.x - P.cta0;
  const int br = local / P.lbs, gc0 = (local % P.lbs) * kWarps;
  const int h = 16 * P.nby, w = 16 * P.nbx;
  const int y0 = 16 * br, x0 = 16 * gc0;

  // the region of the previous plane this CTA's searches can reach
  const int ry0 = max(y0 - kReach, 0), ry1 = min(y0 + 16 + kReach, h);
  const int xlo = max(x0 - 16, 0), xhi = min(x0 + 16 * kWarps + 16, w);
  const int chunks = (xhi - xlo) >> 4;
  for (int p = threadIdx.x; p < (ry1 - ry0) * chunks; p += kThreads) {
    const int r = p / chunks, c = p % chunks;
    const uint4 v = *reinterpret_cast<const uint4*>(
        P.prev + (long long)(ry0 + r) * P.prev_stride + xlo + 16 * c);
    uint2* dst = reinterpret_cast<uint2*>(&tile[r * kPitch + 16 * c]);
    dst[0] = make_uint2(v.x, v.y);
    dst[1] = make_uint2(v.z, v.w);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gc = gc0 + warp;
  if (gc >= P.nbx) return;  // whole warps leave: the shuffles below are over full warps
  const int r = lane & 15, half = lane >> 4;
  const int bx = 16 * gc;
  const uint4 cur =
      *reinterpret_cast<const uint4*>(P.src + (long long)(y0 + r) * P.src_stride + bx);
  // the tile offset of this lane's row of the window at plane (0, 0)
  const int lane_off = (r - ry0) * kPitch - xlo;

  // The squared error of the window at plane (y, x), on every lane of the
  // half-warp; the two half-warps may ask for different windows.
  auto ssd = [&](int x, int y) -> int {
    const int a = lane_off + y * kPitch + x;
    const uint2* q = reinterpret_cast<const uint2*>(tile + (a & ~7));
    const uint2 q0 = q[0], q1 = q[1], q2 = q[2];
    const bool up = (a & 4) != 0;
    const int sh = 8 * (a & 3);
    const u32 a0 = up ? q0.y : q0.x, a1 = up ? q1.x : q0.y, a2 = up ? q1.y : q1.x,
              a3 = up ? q2.x : q1.y, a4 = up ? q2.y : q2.x;
    const u32 d0 = __vabsdiffu4(cur.x, __funnelshift_r(a0, a1, sh));
    const u32 d1 = __vabsdiffu4(cur.y, __funnelshift_r(a1, a2, sh));
    const u32 d2 = __vabsdiffu4(cur.z, __funnelshift_r(a2, a3, sh));
    const u32 d3 = __vabsdiffu4(cur.w, __funnelshift_r(a3, a4, sh));
    const u32 s = __dp4a(d3, d3, __dp4a(d2, d2, __dp4a(d1, d1, __dp4a(d0, d0, 0u))));
    // one sum per half-warp, each a redux over the full warp: a redux over a
    // half-warp's own mask is compiled into one pass per mask
    const u32 lo = __reduce_add_sync(0xFFFFFFFFu, half ? 0u : s);
    const u32 hi = __reduce_add_sync(0xFFFFFFFFu, half ? s : 0u);
    return (int)(half ? hi : lo);
  };

  int cx = bx, cy = y0;
  int best = ssd(cx, cy) << 4;  // err * 16 + priority; the centre's priority is 0
#pragma unroll
  for (int step = 8; step >= 1; step >>= 1) {
    int cand = INT_MAX;  // the best of this half-warp's four candidates
#pragma unroll
    for (int t = 0; t < 4; t++) {
      const int k = 2 * t + 1 + half;
      const int x = cx + ring_x(k) * step, y = cy + ring_y(k) * step;
      const bool valid = x >= 0 && x <= w - 16 && y >= 0 && y <= h - 16;
      const int err = ssd(valid ? x : cx, valid ? y : cy);
      cand = min(cand, valid ? (err << 4) + k : INT_MAX);
    }
    cand = min(cand, __shfl_xor_sync(0xFFFFFFFFu, cand, 16));
    if (cand < best) {  // the same on every lane
      const int k = cand & 15;
      cx += ring_x(k) * step;
      cy += ring_y(k) * step;
      best = cand & ~15;  // the winner is the next step's centre, priority 0
    }
  }
  if (lane == 0) {
    const long long b = P.first + (long long)br * P.nbx + gc;
    mvx[b] = (int8_t)(cx - bx);
    mvy[b] = (int8_t)(cy - y0);
    hc[b] = (float)(best >> 4) > min_err ? 1 : 0;
  }
}

}  // namespace

// One motion search on `stream`; returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a plane count outside 1..3).
// src0..src2: each plane's padded u8 source (row strides stride0..stride2,
// 16-byte aligned rows); prev: the previous reconstruction canvas (row stride
// prev_stride, 16-byte aligned rows); mvy, mvx (nb) i8 and hc (nb) u8: the
// output; min_err: the skip threshold; layout: n descriptors of five int64
// (first block, row and column of the plane's origin in prev, a multiple of
// 16, its height and width, multiples of 16).
extern "C" int pfv_motion_search(const void* src0, const void* src1, const void* src2,
                                 long long stride0, long long stride1, long long stride2,
                                 const void* prev, long long prev_stride, void* mvy,
                                 void* mvx, void* hc, float min_err,
                                 const long long* layout, int n, void* stream) {
  if (n < 1 || n > kMaxPlanes) return (int)cudaErrorInvalidValue;
  const void* src[kMaxPlanes] = {src0, src1, src2};
  const long long stride[kMaxPlanes] = {stride0, stride1, stride2};
  Planes ps = {};
  ps.n = n;
  int ctas = 0;
  for (int k = 0; k < n; k++) {
    const long long* d = layout + 5 * k;
    Plane& p = ps.p[k];
    p.src = (const uint8_t*)src[k];
    p.prev = (const uint8_t*)prev + d[1] * prev_stride + d[2];
    p.src_stride = stride[k];
    p.prev_stride = prev_stride;
    p.first = (int)d[0];
    p.nby = (int)(d[3] / 16);
    p.nbx = (int)(d[4] / 16);
    p.lbs = (p.nbx + kWarps - 1) / kWarps;
    p.cta0 = ctas;
    ctas += p.nby * p.lbs;
  }
  if (ctas == 0) return 0;
  motion_search_kernel<<<ctas, kThreads, 0, (cudaStream_t)stream>>>(
      (int8_t*)mvy, (int8_t*)mvx, (uint8_t*)hc, min_err, ps);
  return (int)cudaGetLastError();
}
