// The port's own tile demux: a persistent context that keeps
// its workers and its unit buffers from one call to the next.
//
// pfv_bitstream.cpp stays the JAX package's copy, unchanged; this file
// includes it and reuses its entropy pass (decode_payload_tiles, its
// TileBuckets sink, tiles_emit_frame, widen_mv_bounds) as it is. Its own
// entry pfv_demux_file_sparse_tiles starts fresh threads on every call and
// asks for a worst-case scratch (69 units per payload byte, about 1.2 GB of
// address space for a 128-frame 1080p clip) that it faults in and frees
// again; a context instead
//  - keeps a pool of workers that sleep on a condition variable between
//    calls (rebuilt when the process id changes: a forked child has none of
//    its parent's threads), and
//  - keeps one TileBuckets per frame slot, whose tile vectors hold their
//    capacity, so the memory it holds is the high-water mark of what the
//    streams it served really produced; the per-frame unit bound stays the
//    buckets' overflow guard and is never allocated.
// A call is two entries: decode (the packet scan and the entropy pass of
// every frame into its slot; returns the exact chunk count) and splice
// (each slot's buckets padded into the caller's units array of exactly that
// many rows, and coff). A context serves one call at a time.

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

struct TileDemux {
  int nthreads = 1;
  std::unique_ptr<WorkerPool> pool;
  std::vector<Packet> pkts;
  std::vector<FrameSlot> slots;  // grow-only: slot f serves frame f
  int64_t frames = 0, chunk = 0, gch = 0, total = -1;

  WorkerPool& workers() {
    if (pool && pool->pid() != getpid()) {
      // a forked child: its parent's threads are not here to join
      (void)pool.release();
    }
    if (!pool) pool.reset(new WorkerPool(nthreads));
    return *pool;
  }
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
  auto& pkts = ctx->pkts;
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
  auto* ctx = new (std::nothrow) TileDemux;
  if (!ctx) return nullptr;
  ctx->nthreads = num_threads > 0 ? num_threads
                                  : (int)std::thread::hardware_concurrency();
  ctx->nthreads = std::max(1, ctx->nthreads);
  return ctx;
}

// Joins the context's workers and frees what it holds.
void pfv_tile_demux_free(void* handle) {
  auto* ctx = static_cast<TileDemux*>(handle);
  if (ctx && ctx->pool && ctx->pool->pid() != getpid()) (void)ctx->pool.release();
  delete ctx;
}

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
