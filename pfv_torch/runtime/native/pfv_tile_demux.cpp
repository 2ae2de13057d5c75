// The port's own demux contexts: persistent native state that keeps its
// workers and its output buffers from one call to the next, for the tile
// demux (K1's route) and the pstep demux (the dense route, and K4's input).
//
// pfv_bitstream.cpp stays the JAX package's copy, unchanged; this file
// includes it and reuses its entropy passes (decode_payload_tiles and its
// TileBuckets sink, tiles_emit_frame; decode_payload_pstep and its
// PstepBuckets sink, pstep_emit_frame, sparse_tail; widen_mv_bounds) as
// they are. Its own entries pfv_demux_file_sparse_tiles and
// pfv_demux_file_sparse_pstep start fresh threads on every call and ask
// for a worst-case scratch (69 units per payload byte: about 1.2 GB of
// address space for a 128-frame 1080p clip, 3.3 GB for 24 frames of 8K)
// that they fault in and free again; a context instead
//  - keeps a pool of workers that sleep on a condition variable between
//    calls (rebuilt when the process id changes: a forked child has none of
//    its parent's threads), and
//  - keeps one slot per frame whose buffers hold their capacity, so the
//    memory it holds is the high-water mark of what the streams it served
//    really produced; the per-frame unit bound stays the overflow guard
//    and is never allocated.
// A call is two entries: decode (the packet scan and the entropy pass of
// every frame into its slot; returns the exact output size) and splice
// (the slots copied into the caller's arrays of exactly that size). A
// context serves one call at a time.
#include "pfv_bitstream.cpp"

#include <condition_variable>
#include <functional>
#include <mutex>
#include <new>
#include <system_error>

#include <unistd.h>

namespace {

// Workers 1..n-1 sleep between jobs; run(k, fn) calls fn(w) on workers
// 0..k-1, the caller being worker 0, and returns when all k are done.
class WorkerPool {
 public:
  explicit WorkerPool(int n) : pid_(getpid()) {
    for (int w = 1; w < n; w++) {
      try {
        threads_.emplace_back([this, w] { loop(w); });
      } catch (const std::system_error&) {
        break;  // run on the workers the system gave
      }
    }
  }

  ~WorkerPool() {
    {
      std::lock_guard<std::mutex> g(m_);
      stop_ = true;
    }
    wake_.notify_all();
    for (auto& t : threads_) t.join();
  }

  int size() const { return (int)threads_.size() + 1; }
  pid_t pid() const { return pid_; }

  void run(int k, const std::function<void(int)>& fn) {
    k = std::min(k, size());
    if (k <= 1) {
      fn(0);
      return;
    }
    {
      std::lock_guard<std::mutex> g(m_);
      job_ = &fn;
      want_ = k;
      pending_ = k - 1;
      gen_++;
    }
    wake_.notify_all();
    fn(0);
    std::unique_lock<std::mutex> lk(m_);
    done_.wait(lk, [this] { return pending_ == 0; });
    job_ = nullptr;
  }

 private:
  void loop(int w) {
    uint64_t seen = 0;
    std::unique_lock<std::mutex> lk(m_);
    for (;;) {
      wake_.wait(lk, [&] { return stop_ || gen_ != seen; });
      if (stop_) return;
      seen = gen_;
      if (w >= want_) continue;
      const std::function<void(int)>* job = job_;
      lk.unlock();
      (*job)(w);
      lk.lock();
      if (--pending_ == 0) done_.notify_one();
    }
  }

  pid_t pid_;
  std::vector<std::thread> threads_;
  std::mutex m_;
  std::condition_variable wake_, done_;
  const std::function<void(int)>* job_ = nullptr;
  uint64_t gen_ = 0;
  int want_ = 0;
  int pending_ = 0;
  bool stop_ = false;
};

struct Packet {
  const uint8_t* payload;
  uint32_t plen;
  uint8_t ptype;
};

struct FrameSlot {
  TileBuckets bkt;
  int64_t rc = 0;
  int64_t chunks = 0;
  int64_t base = 0;
  int64_t grown = 0;  // bytes of tile capacity this call added
  int16_t mvmax = 0;
};

// What both contexts share: the workers, and the packets of the call.
struct Context {
  int nthreads = 1;
  std::unique_ptr<WorkerPool> pool;
  std::vector<Packet> pkts;

  WorkerPool& workers() {
    if (pool && pool->pid() != getpid()) {
      // a forked child: its parent's threads are not here to join
      (void)pool.release();
    }
    if (!pool) pool.reset(new WorkerPool(nthreads));
    return *pool;
  }

  // The frame packets after header_off, at most max_frames: 0, or -4
  // where a packet runs past the end.
  int64_t scan(const uint8_t* file, int64_t len, int64_t header_off,
               int64_t max_frames) {
    pkts.clear();
    int64_t off = header_off;
    while (off + 5 <= len) {
      uint8_t pt = file[off];
      uint32_t plen = (uint32_t)file[off + 1] | (uint32_t)file[off + 2] << 8 |
                      (uint32_t)file[off + 3] << 16 |
                      (uint32_t)file[off + 4] << 24;
      if (off + 5 + (int64_t)plen > len) return -4;
      const uint8_t* payload = file + off + 5;
      off += 5 + plen;
      if (pt == 0) break;
      if ((pt == 1 && plen > 0) || pt == 2) pkts.push_back({payload, plen, pt});
      if ((int64_t)pkts.size() >= max_frames) break;
    }
    return 0;
  }
};

template <class T>
void* new_context(int32_t num_threads) {
  auto* ctx = new (std::nothrow) T;
  if (!ctx) return nullptr;
  ctx->nthreads = num_threads > 0 ? num_threads
                                  : (int)std::thread::hardware_concurrency();
  ctx->nthreads = std::max(1, ctx->nthreads);
  return ctx;
}

template <class T>
void free_context(void* handle) {
  auto* ctx = static_cast<T*>(handle);
  if (ctx && ctx->pool && ctx->pool->pid() != getpid()) (void)ctx->pool.release();
  delete ctx;
}

struct TileDemux : Context {
  std::vector<FrameSlot> slots;  // grow-only: slot f serves frame f
  int64_t frames = 0, chunk = 0, gch = 0, total = -1;
};

// TileBuckets::reset, but a stream with fewer stripes keeps the vectors of
// the rest, with their capacity, for the next wider one.
void reset_keeping_stripes(TileBuckets& bkt, int64_t gch, int64_t cap) {
  if ((int64_t)bkt.tiles.size() < gch) bkt.tiles.resize((size_t)gch);
  for (auto& t : bkt.tiles) t.clear();
  bkt.n = 0;
  bkt.cap = cap;
  bkt.overflow = false;
}

int64_t tile_capacity_bytes(const TileBuckets& bkt) {
  int64_t n = 0;
  for (const auto& t : bkt.tiles) n += (int64_t)t.capacity();
  return n * (int64_t)sizeof(uint32_t);
}

// The body of pfv_tile_demux_decode, which maps a refused allocation to -6.
int64_t decode_file(TileDemux* ctx, const uint8_t* file, int64_t len,
                    int64_t header_off, int64_t total_blocks,
                    int64_t max_frames, uint16_t* bh_out,
                    const int32_t* mv_bounds, uint8_t* ftype, uint8_t* qidx,
                    int64_t chunk, int16_t* mv_absmax_out,
                    const int32_t* stripe_of_b, const int32_t* lanebase_of_b,
                    const int32_t* r_of_zz, int64_t gch, int64_t* grown_out) {
  if (ctx->scan(file, len, header_off, max_frames) != 0) return -4;
  const auto& pkts = ctx->pkts;
  const int64_t frames = (int64_t)pkts.size();
  if ((int64_t)ctx->slots.size() < frames) ctx->slots.resize((size_t)frames);

  MvBounds16 bounds16;
  if (mv_bounds) widen_mv_bounds(mv_bounds, total_blocks, &bounds16);
  const MvBounds16* b16 = mv_bounds ? &bounds16 : nullptr;

  std::atomic<int64_t> next(0);
  std::atomic<bool> failed(false);
  auto decode = [&](int) {
    // after a failure no frame is claimed, but every frame before the
    // first failing one already was: the reported error is deterministic
    while (!failed.load(std::memory_order_relaxed)) {
      const int64_t f = next.fetch_add(1);
      if (f >= frames) return;
      FrameSlot& s = ctx->slots[(size_t)f];
      const Packet& p = pkts[(size_t)f];
      ftype[f] = p.ptype;
      s.mvmax = 0;
      s.chunks = 0;
      s.grown = 0;
      try {
        const int64_t cap0 = tile_capacity_bytes(s.bkt);
        reset_keeping_stripes(s.bkt, gch, std::min(69 * (int64_t)p.plen + 8,
                                                   129 * total_blocks * 256));
        s.rc = decode_payload_tiles(p.payload, p.plen, p.ptype, total_blocks,
                                    bh_out + f * total_blocks, b16, qidx + f * 3,
                                    stripe_of_b, lanebase_of_b, r_of_zz, s.bkt,
                                    &s.mvmax);
        s.grown = tile_capacity_bytes(s.bkt) - cap0;
      } catch (const std::bad_alloc&) {
        s.rc = -6;
      }
      if (s.rc != 0) {
        failed.store(true);
        continue;
      }
      for (int64_t t = 0; t < gch; t++)
        s.chunks += ((int64_t)s.bkt.tiles[(size_t)t].size() + chunk - 1) / chunk;
    }
  };
  ctx->workers().run((int)std::min<int64_t>(ctx->nthreads, frames), decode);
  const int64_t claimed = std::min(next.load(), frames);
  int64_t total = 0, grown = 0;
  int16_t mvmax = 0;
  for (int64_t f = 0; f < claimed; f++) {
    FrameSlot& s = ctx->slots[(size_t)f];
    if (s.rc != 0) return s.rc;
    grown += s.grown;
    s.base = total;
    total += s.chunks;
    mvmax = std::max(mvmax, s.mvmax);
  }
  *grown_out = grown;
  if (total > INT32_MAX) return -6;
  if (mv_absmax_out) *mv_absmax_out = mvmax;
  ctx->frames = frames;
  ctx->chunk = chunk;
  ctx->gch = gch;
  ctx->total = total;
  return total;
}

}  // namespace

extern "C" {

// A context with num_threads workers (0: one per hardware thread), or null.
void* pfv_tile_demux_new(int32_t num_threads) {
  return new_context<TileDemux>(num_threads);
}

// Joins the context's workers and frees what it holds.
void pfv_tile_demux_free(void* handle) { free_context<TileDemux>(handle); }

// Scans the packets and entropy-decodes every frame into the context's
// slots; writes bh, ftype, qidx and *mv_absmax_out as
// pfv_demux_file_sparse_tiles does, and *grown_out the bytes of unit
// buffers this call added to the context. Returns the exact total chunk
// count (the rows splice writes), or that entry's negative codes: -4 a
// truncated packet, -2/-3 a corrupt or overflowing payload (the first
// failing frame's), -8 a motion vector out of bounds, -6 a count past
// int32 or memory refused.
int64_t pfv_tile_demux_decode(
    void* handle, const uint8_t* file, int64_t len, int64_t header_off,
    int64_t total_blocks, int64_t max_frames, uint16_t* bh_out,
    const int32_t* mv_bounds, uint8_t* ftype, uint8_t* qidx, int64_t chunk,
    int16_t* mv_absmax_out, const int32_t* stripe_of_b,
    const int32_t* lanebase_of_b, const int32_t* r_of_zz, int64_t gch,
    int64_t* grown_out) {
  auto* ctx = static_cast<TileDemux*>(handle);
  ctx->total = -1;
  *grown_out = 0;
  try {
    return decode_file(ctx, file, len, header_off, total_blocks, max_frames,
                       bh_out, mv_bounds, ftype, qidx, chunk, mv_absmax_out,
                       stripe_of_b, lanebase_of_b, r_of_zz, gch, grown_out);
  } catch (const std::bad_alloc&) {
    return -6;
  }
}

// Writes the decoded frames' units into units_out (n_chunks x chunk u32,
// n_chunks the count decode returned) and coff_out (frames*gch + 1
// cumulative chunk offsets). Returns 0, or -6 where n_chunks is not that
// count or no decode preceded.
int64_t pfv_tile_demux_splice(void* handle, uint32_t* units_out,
                              int64_t n_chunks, int32_t* coff_out) {
  auto* ctx = static_cast<TileDemux*>(handle);
  if (ctx->total < 0 || n_chunks != ctx->total) return -6;
  coff_out[0] = 0;
  std::atomic<int64_t> next(0);
  std::atomic<bool> bad(false);
  auto splice = [&](int) {
    for (;;) {
      const int64_t f = next.fetch_add(1);
      if (f >= ctx->frames) return;
      FrameSlot& s = ctx->slots[(size_t)f];
      int64_t cpos = s.base;
      if (!tiles_emit_frame(s.bkt, ctx->gch, ctx->chunk, units_out, n_chunks,
                            coff_out + f * ctx->gch, &cpos))
        bad.store(true);
    }
  };
  try {
    ctx->workers().run((int)std::min<int64_t>(ctx->nthreads, ctx->frames), splice);
  } catch (const std::bad_alloc&) {
    return -6;
  }
  ctx->total = -1;
  return bad.load() ? -6 : 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// The pstep demux's context: pfv_demux_file_sparse_pstep's output, the
// stream cut into chunks of whole frames, in one pool run for the whole
// stream. A frame's chain does not depend on where the frame lies: its
// deltas run from its own base and its tail parks at the next frame's,
// span = 64 * row_span further. So each frame is emitted from base 0 into
// its slot, and a chunk's output, its frames' chains one after the other,
// is what the per-call entry gives for that chunk's frames alone. The
// workers take the frames largest payload first: an I-frame's
// one-threaded pass starts at once and the P-frames of every chunk fill
// the other workers around it.
// ---------------------------------------------------------------------------

namespace {

int64_t pad16(int64_t x) { return x + (16 - x % 16) % 16; }

// The dense coefficient layout of pfv_torch's step kernels for one frame
// size (dataloader.pstep_tables and runtime._mv_bounds_packed): per stream
// block its base stripe * 2 * scp + 4 * gc in a row, the row of each
// zigzag slot and the per-block motion bounds.
struct PstepGeometry {
  int64_t width = -1, height = -1;
  int64_t total_blocks = 0, vstart_block = 0;
  std::vector<int32_t> off_of_b;
  int32_t r_of_zz[64];
  MvBounds16 bounds;
};

// 2 * scp: the coefficient lanes of one 16-row stripe of a canvas cw
// wide, 4 per macroblock padded to a multiple of 256.
int64_t lanes_per_stripe(int64_t cw) {
  return 2 * ((2 * (cw / 16) + 127) / 128 * 128);
}

// The row length of the dense coefficients of a width x height frame:
// every 16-row stripe of the canvas (padded luma above the two chroma
// planes side by side) times its lanes.
int64_t pstep_row_span(int64_t width, int64_t height) {
  const int64_t cw = std::max(pad16(width), 2 * pad16(width / 2));
  return (pad16(height) + pad16(height / 2)) / 16 * lanes_per_stripe(cw);
}

void load_pstep_geometry(PstepGeometry& g, int64_t width, int64_t height) {
  g.width = g.height = -1;  // unset until the tables are whole
  const int64_t ly0 = pad16(height), lyw = pad16(width);
  const int64_t lc0 = pad16(height / 2), lcw = pad16(width / 2);
  const int64_t gly = ly0 / 16, gyw = lyw / 16, gchc = lc0 / 16, guw = lcw / 16;
  const int64_t yb = gly * gyw, cb = gchc * guw;
  const int64_t rs = lanes_per_stripe(std::max(lyw, 2 * lcw));
  g.total_blocks = yb + 2 * cb;
  g.vstart_block = yb + cb;
  g.off_of_b.resize((size_t)g.total_blocks);
  for (int64_t b = 0; b < yb; b++)
    g.off_of_b[(size_t)b] = (int32_t)(b / gyw * rs + 4 * (b % gyw));
  for (int64_t k = 0; k < cb; k++) {
    const int64_t row = (gly + k / guw) * rs, col = 4 * (k % guw);
    g.off_of_b[(size_t)(yb + k)] = (int32_t)(row + col);
    g.off_of_b[(size_t)(yb + cb + k)] = (int32_t)(row + 4 * guw + col);
  }
  for (int i = 0; i < 64; i++) g.r_of_zz[INV_ZIGZAG[i]] = i;
  // motion bounds: a vector keeps its 16x16 window inside the padded
  // plane; clipped into the 7-bit range a stream can carry
  std::vector<int32_t> packed((size_t)g.total_blocks);
  auto clip8 = [](int64_t v) {
    return (uint32_t)(uint8_t)(int8_t)std::min<int64_t>(63, std::max<int64_t>(-64, v));
  };
  int64_t b0 = 0;
  const int64_t planes[3][2] = {{ly0, lyw}, {lc0, lcw}, {lc0, lcw}};
  for (const auto& pl : planes) {
    const int64_t ph = pl[0], pw = pl[1], nbx = pw / 16, n = ph / 16 * nbx;
    for (int64_t b = 0; b < n; b++) {
      const int64_t by = b / nbx * 16, bx = b % nbx * 16;
      packed[(size_t)(b0 + b)] =
          (int32_t)(clip8(-bx) | clip8(pw - 16 - bx) << 8 |
                    clip8(-by) << 16 | clip8(ph - 16 - by) << 24);
    }
    b0 += n;
  }
  widen_mv_bounds(packed.data(), g.total_blocks, &g.bounds);
  g.width = width;
  g.height = height;
}

// A buffer that only grows and is never initialised: what the frames
// served so far needed at most.
template <class T>
struct KeptArray {
  std::unique_ptr<T[]> data;
  int64_t size = 0;

  void ensure(int64_t n) {
    if (n <= size) return;
    data.reset();
    size = 0;
    data.reset(new T[(size_t)n]);
    size = n;
  }
};

struct PstepSlot {
  PstepBuckets bkt;
  KeptArray<uint16_t> deltas;  // the frame's emitted chain
  KeptArray<int8_t> vals;
  int64_t rc = 0;
  int64_t n = 0;      // units of the chain
  int64_t base = 0;   // its offset in its chunk's output
  int64_t grown = 0;  // bytes this call added to the slot
  int16_t mvmax = 0;

  int64_t bytes() const {
    int64_t n4 = 0;
    for (const auto& r : bkt.rows) n4 += (int64_t)r.capacity();
    return 4 * n4 + 2 * deltas.size + vals.size;
  }
};

struct PstepDemux : Context {
  PstepGeometry geo;
  std::vector<PstepSlot> slots;  // grow-only: slot f serves frame f
  std::vector<int64_t> order;    // the frames, largest payload first
  std::vector<int64_t> units;    // per chunk, of the last decode
  int64_t frames = 0, chunk = 0;
  bool decoded = false;
};

// The body of pfv_pstep_demux_decode, which maps a refused allocation to -6.
int64_t pstep_decode_file(PstepDemux* ctx, const uint8_t* file, int64_t len,
                          int64_t header_off, int64_t width, int64_t height,
                          int64_t max_frames, int64_t chunk,
                          const uint64_t* meta_out, int64_t* units_out,
                          int16_t* mv_absmax_out, int64_t* grown_out) {
  if (ctx->scan(file, len, header_off, max_frames) != 0) return -4;
  const auto& pkts = ctx->pkts;
  const int64_t frames = (int64_t)pkts.size();
  if (chunk <= 0) chunk = std::max<int64_t>(frames, 1);
  const int64_t row_span = pstep_row_span(width, height);
  const int64_t span = 64 * row_span;
  if (std::min(chunk, frames) * span >= ((int64_t)1 << 31)) return -9;
  if (row_span >= (1 << 24)) return -10;
  PstepGeometry& geo = ctx->geo;
  if (geo.width != width || geo.height != height)
    load_pstep_geometry(geo, width, height);
  if ((int64_t)ctx->slots.size() < frames) ctx->slots.resize((size_t)frames);
  auto& order = ctx->order;
  order.resize((size_t)frames);
  for (int64_t f = 0; f < frames; f++) order[(size_t)f] = f;
  std::stable_sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
    return pkts[(size_t)a].plen > pkts[(size_t)b].plen;
  });

  const int64_t nb = geo.total_blocks;
  const int64_t tail_bound = span / 65535 + 1;
  std::atomic<int64_t> next(0);
  // every frame is decoded, failing or not, so the error reported (the
  // first failing frame's) does not depend on the workers' timing
  auto decode = [&](int) {
    for (;;) {
      const int64_t k = next.fetch_add(1);
      if (k >= frames) return;
      const int64_t f = order[(size_t)k];
      PstepSlot& s = ctx->slots[(size_t)f];
      const Packet& p = pkts[(size_t)f];
      // chunk c's meta: [bh (fc, nb) | ftype (fc) | qidx (fc, 3)], u16
      const int64_t c = f / chunk, fl = f % chunk;
      const int64_t fc = std::min(chunk, frames - c * chunk);
      uint16_t* meta = reinterpret_cast<uint16_t*>(meta_out[c]);
      uint8_t q[3] = {0, 0, 0};
      s.mvmax = 0;
      s.n = 0;
      s.grown = 0;
      try {
        const int64_t before = s.bytes();
        const int64_t bound =
            std::min(69 * (int64_t)p.plen + 8, 129 * span) + tail_bound;
        s.bkt.reset(bound);
        s.rc = decode_payload_pstep(
            p.payload, p.plen, p.ptype, nb, meta + fl * nb, &geo.bounds, q,
            geo.off_of_b.data(), geo.r_of_zz, geo.vstart_block, s.bkt,
            &s.mvmax);
        if (s.rc == 0) {
          // past the units: escapes over gaps and the tail, together at
          // most tail_bound, so the chain overflows only past `bound`
          const int64_t room = std::min(bound, s.bkt.n + 2 * tail_bound);
          s.deltas.ensure(room);
          s.vals.ensure(room);
          SparseOut out;
          out.deltas = s.deltas.data.get();
          out.vals = s.vals.data.get();
          out.cap = room;
          if (!pstep_emit_frame(s.bkt, 0, row_span, out) ||
              !sparse_tail(out, span))
            s.rc = -3;
          s.n = out.n;
        }
        s.grown = s.bytes() - before;
      } catch (const std::bad_alloc&) {
        s.rc = -6;
      }
      meta[fc * nb + fl] = p.ptype;
      for (int i = 0; i < 3; i++) meta[fc * nb + fc + 3 * fl + i] = q[i];
    }
  };
  ctx->workers().run((int)std::min<int64_t>(ctx->nthreads, frames), decode);
  int64_t total = 0, grown = 0;
  for (int64_t f = 0; f < frames; f++) grown += ctx->slots[(size_t)f].grown;
  *grown_out = grown;
  const int64_t n_chunks = std::max<int64_t>(1, (frames + chunk - 1) / chunk);
  auto& units = ctx->units;
  units.assign((size_t)n_chunks, 0);
  std::fill(mv_absmax_out, mv_absmax_out + n_chunks, 0);
  for (int64_t f = 0; f < frames; f++) {
    PstepSlot& s = ctx->slots[(size_t)f];
    if (s.rc != 0) return s.rc;
    s.base = units[(size_t)(f / chunk)];
    units[(size_t)(f / chunk)] += s.n;
    total += s.n;
    mv_absmax_out[f / chunk] = std::max(mv_absmax_out[f / chunk], s.mvmax);
  }
  std::copy(units.begin(), units.end(), units_out);
  ctx->frames = frames;
  ctx->chunk = chunk;
  ctx->decoded = true;
  return total;
}

}  // namespace

extern "C" {

// A pstep context with num_threads workers (0: one per hardware thread),
// or null.
void* pfv_pstep_demux_new(int32_t num_threads) {
  return new_context<PstepDemux>(num_threads);
}

// Joins the context's workers and frees what it holds.
void pfv_pstep_demux_free(void* handle) { free_context<PstepDemux>(handle); }

// Scans the packets of a width x height stream and entropy-decodes every
// frame into the context's slots, in chunks of `chunk` frames (0: one
// chunk), n_chunks = max(1, ceil(frames / chunk)). meta_out[c] points at
// chunk c's meta, fc * (B + 4) u16 for its fc frames: their block headers
// (fc, B) as pfv_demux_file_sparse_pstep writes bh, their frame types (fc)
// and their q-table indices (fc, 3). Writes per chunk its unit count
// units_out[c] and its largest motion component mv_absmax_out[c], and
// *grown_out the slot bytes this call added to the context. Returns the
// total unit count, or that entry's negative codes: -4 a truncated packet,
// -2/-3 a corrupt or overflowing payload (the first failing frame's), -8 a
// motion vector out of bounds, -6 memory refused; and -9 where a chunk's
// positions pass int32, -10 where a row does not fit 24 bits.
int64_t pfv_pstep_demux_decode(void* handle, const uint8_t* file, int64_t len,
                               int64_t header_off, int64_t width,
                               int64_t height, int64_t max_frames,
                               int64_t chunk, const uint64_t* meta_out,
                               int64_t* units_out, int16_t* mv_absmax_out,
                               int64_t* grown_out) {
  auto* ctx = static_cast<PstepDemux*>(handle);
  ctx->decoded = false;
  *grown_out = 0;
  try {
    return pstep_decode_file(ctx, file, len, header_off, width, height,
                             max_frames, chunk, meta_out, units_out,
                             mv_absmax_out, grown_out);
  } catch (const std::bad_alloc&) {
    return -6;
  }
}

// Copies the decoded frames' chains into each chunk's deltas_out[c] and
// vals_out[c] (units[c] each, the counts decode wrote; n_chunks of them),
// each frame at its offset, by the workers. Returns 0, or -6 where the
// counts are not those or no decode preceded.
int64_t pfv_pstep_demux_splice(void* handle, const uint64_t* deltas_out,
                               const uint64_t* vals_out, const int64_t* units,
                               int64_t n_chunks) {
  auto* ctx = static_cast<PstepDemux*>(handle);
  if (!ctx->decoded || n_chunks != (int64_t)ctx->units.size() ||
      !std::equal(ctx->units.begin(), ctx->units.end(), units))
    return -6;
  std::atomic<int64_t> next(0);
  auto splice = [&](int) {
    for (;;) {
      const int64_t k = next.fetch_add(1);
      if (k >= ctx->frames) return;
      const int64_t f = ctx->order[(size_t)k], c = f / ctx->chunk;
      const PstepSlot& s = ctx->slots[(size_t)f];
      std::memcpy(reinterpret_cast<uint16_t*>(deltas_out[c]) + s.base,
                  s.deltas.data.get(), s.n * sizeof(uint16_t));
      std::memcpy(reinterpret_cast<int8_t*>(vals_out[c]) + s.base,
                  s.vals.data.get(), s.n);
    }
  };
  try {
    ctx->workers().run((int)std::min<int64_t>(ctx->nthreads, ctx->frames), splice);
  } catch (const std::bad_alloc&) {
    return -6;
  }
  ctx->decoded = false;
  return 0;
}

}  // extern "C"
