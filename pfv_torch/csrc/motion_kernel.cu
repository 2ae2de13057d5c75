// K8, the encoder's motion search: the four-step search of every macroblock
// of a P-frame, one launch for one to three planes.
//
// Replaces: pfv_tpu/ops/motion.py, motion_search (no Pallas kernel there:
// XLA compiles it into the whole-clip encode program, pfv_tpu/encoding.py
// encode_scan), and with it the comparison against the skip threshold that
// follows it in pfv_tpu/ops/pframe.py encode_plane_delta. The one-hot matrix
// products that pick the windows on the TPU are not carried over: a window
// is a run of words in shared memory.
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
// One CTA of 16 warps takes 2 x 8 blocks of one plane (kBlockRows block
// rows of kBlocks blocks; the grid is flat: the planes' CTAs one after the
// other), a warp a block. It stages the part of the previous plane its
// searches can reach, rows y0 - 15 .. y0 + 32 + 14 and columns x0 - 16 ..
// x0 + 16 kBlocks + 15 clipped to the plane (so no byte outside the plane's
// view is read: a window that leaves U to the right is refused and V is
// never touched), with 16-byte loads, in four copies: copy s holds at word i
// the four bytes from column 4 i + s of the staged region. A window that
// starts at column c is then, in each of its rows, the four whole words c /
// 4 .. c / 4 + 3 of copy c % 4: no word selects, no funnel shifts. The
// CTA's 16 source blocks are staged beside it with the same loads, so that
// the region and the sources are one wait, not two.
//
// A block takes five rounds: the centre, then one per step with its eight
// ring candidates in flight at once. In a step, lane l takes the candidate
// of priority l / 4 + 1 and the block's rows q, q + 4, q + 8, q + 12 (q = l
// % 4; the source rows stay in 16 registers for the whole walk): 16 shared
// loads, each pixel's |c - w| by byte-wise SIMD (__vabsdiffu4) and the
// squares' sum (__dp4a), two shuffles (xor 1, 2) add the candidate's four
// partial sums, one redux takes the smallest score of the eight and two
// shuffles fetch the winner's place from its first lane, so every lane
// holds the step's winner and the walk has no divergent branch. The address
// and the edge test are paid once per lane and candidate; the rows lie at
// constant offsets of the pitch. A candidate off the plane is summed at the
// centre's place (in the tile) and scored the largest int. The centre round
// spreads the one window over the warp (lane l: row l % 16, eight bytes)
// and adds it with one redux.
//
// Banks: a step's 32 lanes read 32 words per load. Rows q + 4 r (not 4 q +
// r) and a row pitch of kPitch = 47 words (15 mod 32), the copies kCopy
// words apart (20 mod 32), put those words on 32 different banks in steps 2
// and 1 and at most two to a bank in steps 8 and 4 (all eight candidates
// there are in one copy): 1.5 wavefronts per load on average over the four
// steps and the four column phases, where 4 q + r rows or another pitch
// give 1.75 or more.
//
// Occupancy: 40 registers and 51,520 bytes of dynamic shared memory a CTA of
// 512 threads: 3 CTAs (48 warps) an SM, registers bound; a 1080p frame's
// 782 CTAs are 1.97 waves on 132 SMs. Of the CTA shapes measured on an
// H100 (PERF.md §6), two block rows of 8 was the fastest; one row of 8
// (6 CTAs an SM) and two rows of 4 were 5-9 % slower, and a persistent grid that fetched the next
// tile with cp.async while it searched one needed 64 registers, so 2 CTAs
// an SM, and was slower still.
//
// What bounds it on this card: the bytes, 1 B per pixel of source and of
// previous plane and 3 B of header per block; the search itself needs only
// the eight byte-wise SIMD operations and one add per 16 pixels of a
// candidate (33 candidates per block away from the plane's edges), a little
// less time than the bytes at 1080p. The body runs about 18 SASS
// instructions per 16 pixels of a candidate (48 in a form with a candidate
// per half-warp), but a warp spends most of its cycles waiting for its
// CTA's region and sources, not in the four steps (PERF.md §6): the
// kernel is bound by the latency of its loads, not by its arithmetic.
//
// Row strides are ints in the kernel: the wrapper and the entry refuse a
// stride of kMaxStride bytes or more, so that a staged row's offset, below
// kRows strides, stays below 2^31.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

using u32 = unsigned int;

constexpr int kMaxPlanes = 3;
constexpr int kMaxDevices = 64;
constexpr int kBlocks = 8;                  // blocks per CTA row
constexpr int kBlockRows = 2;               // block rows per CTA
constexpr int kThreads = 32 * kBlocks * kBlockRows;  // a warp a block
constexpr int kReach = 15;                  // 8 + 4 + 2 + 1
constexpr int kRows = 16 * kBlockRows + 2 * kReach;  // rows the CTA's searches can reach
constexpr int kChunks = kBlocks + 2;        // 16-byte chunks of a staged row, at most
constexpr int kItems = (kRows * kChunks + kThreads - 1) / kThreads;  // chunks per thread
// words per row of a copy and per copy: see the note on banks above
constexpr int kPitch = 47;  // 15 mod 32
constexpr int kCopy = kRows * kPitch + (20 - kRows * kPitch % 32 + 32) % 32;  // 20 mod 32
constexpr int kSrcPitch = 16 * kBlocks + 16;  // bytes per source row: 16 apart in banks
constexpr int kSmem = 16 * kCopy + 16 * kBlockRows * kSrcPitch;  // bytes
static_assert(kPitch >= 4 * kChunks && kCopy >= kRows * kPitch, "the tile is too small");
constexpr long long kMaxStride = 1ll << 25;  // bytes; kRows * kMaxStride < 2^31

struct Plane {
  const uint8_t* src;   // its (0, 0) in the source
  const uint8_t* prev;  // its (0, 0) in the previous reconstruction
  int src_stride, prev_stride;
  int first;            // its first block in the header rows
  int nbx, nby;         // blocks per row, block rows
  int lbs;              // CTAs per block row
  float inv_lbs;        // 1 / lbs
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

// The squared error of 4 pixels, added to s.
__device__ __forceinline__ u32 sq4(u32 c, u32 w, u32 s) {
  const u32 d = __vabsdiffu4(c, w);
  return __dp4a(d, d, s);
}

__global__ void __launch_bounds__(kThreads)
motion_search_kernel(int8_t* __restrict__ mvy, int8_t* __restrict__ mvx,
                     uint8_t* __restrict__ hc, float min_err, const Planes planes) {
  extern __shared__ __align__(16) u32 smem[];
  u32* tile = smem;  // the four copies
  // the CTA's source blocks
  auto blocks = reinterpret_cast<uint8_t (*)[kSrcPitch]>(smem + 4 * kCopy);

  Plane P = planes.p[0];
#pragma unroll
  for (int k = 1; k < kMaxPlanes; k++)
    if (k < planes.n && (int)blockIdx.x >= planes.p[k].cta0) P = planes.p[k];
  const int local = blockIdx.x - P.cta0;
  const int cr = (int)((local + 0.5f) * P.inv_lbs);  // local / lbs: exact below 2^22
  const int gc0 = (local - cr * P.lbs) * kBlocks;
  const int h = 16 * P.nby, w = 16 * P.nbx;
  const int y0 = 16 * kBlockRows * cr, x0 = 16 * gc0;

  // the region of the previous plane the CTA's searches can reach, in four
  // copies shifted by 0..3 bytes
  const int ry0 = max(y0 - kReach, 0), rows = min(y0 + 16 * kBlockRows + kReach, h) - ry0;
  const int xlo = max(x0 - 16, 0), chunks = (min(x0 + 16 * kBlocks + 16, w) - xlo) >> 4;
  const uint8_t* region = P.prev + (long long)ry0 * P.prev_stride + xlo;
  const int lane = threadIdx.x & 31;
  uint4 v[kItems];
  u32 last[kItems];
#pragma unroll
  for (int it = 0; it < kItems; it++) {  // every load in flight before the first store
    const int p = threadIdx.x + it * kThreads, r = p / kChunks, c = p - r * kChunks;
    v[it] = make_uint4(0u, 0u, 0u, 0u);
    last[it] = 0u;
    if (r < rows && c < chunks) {
      const uint8_t* g = region + (r * P.prev_stride + 16 * c);
      v[it] = *reinterpret_cast<const uint4*>(g);
      // the next chunk's first word: lane 31 loads it, the others take it
      // from the next lane below; past the region no window reads it
      if (lane == 31 && c + 1 < chunks) last[it] = *reinterpret_cast<const u32*>(g + 16);
    }
  }
  // and the CTA's source blocks, a 16-byte chunk a thread
  const int sr = threadIdx.x / kBlocks, sc = threadIdx.x - sr * kBlocks;
  const bool source = sr < 16 * kBlockRows && y0 + sr < h && gc0 + sc < P.nbx;
  uint4 sv = make_uint4(0u, 0u, 0u, 0u);
  if (source)
    sv = *reinterpret_cast<const uint4*>(P.src + (long long)(y0 + sr) * P.src_stride + x0 +
                                         16 * sc);
#pragma unroll
  for (int it = 0; it < kItems; it++) {
    const int p = threadIdx.x + it * kThreads, r = p / kChunks, c = p - r * kChunks;
    const u32 below = __shfl_down_sync(0xFFFFFFFFu, v[it].x, 1);
    if (r < rows && c < chunks) {
      const u32 a[5] = {v[it].x, v[it].y, v[it].z, v[it].w,
                        lane == 31 ? last[it] : c + 1 < chunks ? below : 0u};
      u32* dst = tile + r * kPitch + 4 * c;
#pragma unroll
      for (int s = 0; s < 4; s++)
#pragma unroll
        for (int t = 0; t < 4; t++)
          dst[s * kCopy + t] = __funnelshift_r(a[t], a[t + 1], 8 * s);
    }
  }
  if (source) *reinterpret_cast<uint4*>(&blocks[sr][16 * sc]) = sv;
  __syncthreads();

  const int warp = threadIdx.x >> 5, wr = warp / kBlocks, wc = warp - wr * kBlocks;
  const int gc = gc0 + wc, by = y0 + 16 * wr;
  // whole warps leave: the shuffles below are over full warps
  if (gc >= P.nbx || by >= h) return;
  const int bx = 16 * gc;
  const int k = (lane >> 2) + 1, q = lane & 3;  // the lane's candidate and rows
  const int mx = ring_x(k), my = ring_y(k);
  uint4 cur[4];  // source rows q + 4 r
#pragma unroll
  for (int r = 0; r < 4; r++)
    cur[r] = *reinterpret_cast<const uint4*>(&blocks[16 * wr + q + 4 * r][16 * wc]);
  // the centre: lane l sums row l % 16, bytes 8 (l / 16) .. 8 (l / 16) + 7
  const uint2 own = *reinterpret_cast<const uint2*>(
      &blocks[16 * wr + (lane & 15)][16 * wc + 8 * (lane >> 4)]);

  // tile + base + word(x, y) holds the first pixel of row y + q of the
  // window at plane (x, y): word x / 4 of copy x % 4, as xlo is a multiple of 16
  const int base = (q - ry0) * kPitch - (xlo >> 2);
  auto word = [&](int x, int y) { return (x & 3) * kCopy + (x >> 2) + y * kPitch; };

  const u32* c0 = tile + base - q * kPitch + word(bx, by + (lane & 15)) + 2 * (lane >> 4);
  int best = (int)__reduce_add_sync(0xFFFFFFFFu, sq4(own.y, c0[1], sq4(own.x, c0[0], 0u)))
             << 4;  // err * 16 + priority; the centre's priority is 0
  int cx = bx, cy = by;
#pragma unroll
  for (int step = 8; step >= 1; step >>= 1) {
    const int x = cx + mx * step, y = cy + my * step;
    const bool valid = (unsigned)x <= (unsigned)(w - 16) && (unsigned)y <= (unsigned)(h - 16);
    const u32* win = tile + base + word(valid ? x : cx, valid ? y : cy);
    u32 s0 = 0u, s1 = 0u;
#pragma unroll
    for (int r = 0; r < 4; r++) {
      const u32* row = win + 4 * r * kPitch;
      s0 = sq4(cur[r].x, row[0], s0);
      s1 = sq4(cur[r].y, row[1], s1);
      s0 = sq4(cur[r].z, row[2], s0);
      s1 = sq4(cur[r].w, row[3], s1);
    }
    int err = (int)(s0 + s1);
    err += __shfl_xor_sync(0xFFFFFFFFu, err, 1);
    err += __shfl_xor_sync(0xFFFFFFFFu, err, 2);
    // the smallest score of the eight, on every lane
    const int ring = __reduce_min_sync(0xFFFFFFFFu, valid ? (err << 4) + k : INT_MAX);
    // the winner's place, from its first lane; the centre stays where the ring loses
    const int from = 4 * (ring & 15) - 4;
    const int wx = __shfl_sync(0xFFFFFFFFu, x, from), wy = __shfl_sync(0xFFFFFFFFu, y, from);
    if (ring < best) {  // the same on every lane
      cx = wx;
      cy = wy;
      best = ring & ~15;  // the winner is the next step's centre, priority 0
    }
  }
  if (lane == 0) {
    const long long b = P.first + (long long)(by >> 4) * P.nbx + gc;
    mvx[b] = (int8_t)(cx - bx);
    mvy[b] = (int8_t)(cy - by);
    hc[b] = (float)(best >> 4) > min_err ? 1 : 0;
  }
}

// Lets the kernel take kSmem bytes of dynamic shared memory on the current
// device, once per device; returns a CUDA error code.
int allow_smem() {
  static bool done[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e) return (int)e;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!done[dev]) {
    e = cudaFuncSetAttribute(motion_search_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmem);
    if (e) return (int)e;
    done[dev] = true;
  }
  return 0;
}

}  // namespace

// One motion search on `stream`; returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a plane count outside 1..3 or a row stride of
// kMaxStride bytes or more).
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
  if (n < 1 || n > kMaxPlanes || prev_stride >= kMaxStride) return (int)cudaErrorInvalidValue;
  const void* src[kMaxPlanes] = {src0, src1, src2};
  const long long stride[kMaxPlanes] = {stride0, stride1, stride2};
  for (int k = 0; k < n; k++)
    if (stride[k] >= kMaxStride) return (int)cudaErrorInvalidValue;
  Planes ps = {};
  ps.n = n;
  int ctas = 0;
  for (int k = 0; k < n; k++) {
    const long long* d = layout + 5 * k;
    Plane& p = ps.p[k];
    p.src = (const uint8_t*)src[k];
    p.prev = (const uint8_t*)prev + d[1] * prev_stride + d[2];
    p.src_stride = (int)stride[k];
    p.prev_stride = (int)prev_stride;
    p.first = (int)d[0];
    p.nby = (int)(d[3] / 16);
    p.nbx = (int)(d[4] / 16);
    p.lbs = (p.nbx + kBlocks - 1) / kBlocks;
    p.inv_lbs = 1.0f / (float)p.lbs;
    p.cta0 = ctas;
    ctas += (p.nby + kBlockRows - 1) / kBlockRows * p.lbs;
  }
  if (ctas == 0) return 0;
  if (const int e = allow_smem()) return e;
  motion_search_kernel<<<ctas, kThreads, kSmem, (cudaStream_t)stream>>>(
      (int8_t*)mvy, (int8_t*)mvx, (uint8_t*)hc, min_err, ps);
  return (int)cudaGetLastError();
}
