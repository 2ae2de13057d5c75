// The encoder's mux context (included by pfv_tile_demux.cpp, after the
// demux contexts whose pool and kept buffers it reuses): every frame of a
// clip entropy-coded in one call, by workers that sleep between calls.
//
// No frame's payload depends on another's (each builds its Huffman table
// from its own counts), so a worker codes one frame at a time through the
// copy's own pfv_encode_iframe_payload_sparse or
// pfv_encode_pframe_payload_sparse, and the bytes are theirs by
// construction. Each frame's payload goes into its slot, a buffer that
// keeps its capacity from one call to the next; the first capacity is the
// estimate runtime._grow starts from (8 bytes a nonzero, 48 a block, 1024),
// doubled while the coder returns -1. The workers take the frames largest
// nonzero count first through a shared index, so an I-frame's pass starts
// at once and the P-frames fill the other workers around it. A call is two
// entries, as the demuxes' are: encode (every frame into its slot; returns
// the exact byte count of the packets) and splice (the packets, each its
// type byte, u32 length and payload, in frame order, into the caller's
// buffer of exactly that size). A context serves one call at a time.

#include <chrono>

namespace {

struct MuxSlot {
  KeptArray<uint8_t> buf;
  int64_t n = 0;       // payload bytes, or the coder's negative code
  int64_t base = 0;    // the packet's offset in the output
  double seconds = 0;  // the worker's time on the frame
  uint8_t ptype = 0;
};

struct Mux : Pooled {
  std::vector<MuxSlot> slots;  // grow-only: slot f serves frame f
  std::vector<int64_t> first;  // per frame, the offset of its nonzeros
  std::vector<int64_t> order;  // the frames, most nonzeros first
  int64_t frames = 0, total = -1;
};

// The body of pfv_mux_encode, which maps a refused allocation to -6.
int64_t mux_encode(Mux* ctx, const int32_t* idx, const int16_t* val,
                   int64_t nnz, const int64_t* counts, const int8_t* mvx,
                   const int8_t* mvy, const uint8_t* has_coeff,
                   const uint8_t* is_key, int64_t frames, int64_t nb,
                   const uint8_t* intra_q, const uint8_t* inter_q,
                   double* worker_s_out) {
  auto& first = ctx->first;
  first.resize((size_t)frames);
  int64_t at = 0;
  for (int64_t f = 0; f < frames; f++) {
    if (counts[f] < 0 || counts[f] > nnz - at) return -5;
    first[(size_t)f] = at;
    at += counts[f];
  }
  if ((int64_t)ctx->slots.size() < frames) ctx->slots.resize((size_t)frames);
  auto& order = ctx->order;
  order.resize((size_t)frames);
  for (int64_t f = 0; f < frames; f++) order[(size_t)f] = f;
  std::stable_sort(order.begin(), order.end(),
                   [&](int64_t a, int64_t b) { return counts[a] > counts[b]; });

  std::atomic<int64_t> next(0);
  // every frame is coded, failing or not, so the error reported (the
  // first failing frame's) does not depend on the workers' timing
  auto code = [&](int) {
    for (;;) {
      const int64_t k = next.fetch_add(1);
      if (k >= frames) return;
      const int64_t f = order[(size_t)k];
      MuxSlot& s = ctx->slots[(size_t)f];
      const auto t0 = std::chrono::steady_clock::now();
      const int32_t* fi = idx + first[(size_t)f];
      const int16_t* fv = val + first[(size_t)f];
      const int64_t c = counts[f];
      s.ptype = is_key[f] ? 1 : 2;
      try {
        s.buf.ensure(c * 8 + nb * 48 + 1024);
        for (;;) {
          uint8_t* out = s.buf.data.get();
          s.n = is_key[f]
                    ? pfv_encode_iframe_payload_sparse(fi, fv, c, nb, intra_q,
                                                       out, s.buf.size)
                    : pfv_encode_pframe_payload_sparse(
                          fi, fv, c, mvx + f * nb, mvy + f * nb,
                          has_coeff + f * nb, nb, inter_q, out, s.buf.size);
          if (s.n != -1) break;
          s.buf.ensure(2 * s.buf.size);  // deep Huffman codes
        }
      } catch (const std::bad_alloc&) {
        s.n = -6;
      }
      s.seconds = std::chrono::duration<double>(
                      std::chrono::steady_clock::now() - t0)
                      .count();
    }
  };
  ctx->workers().run((int)std::min<int64_t>(ctx->nthreads, frames), code);
  int64_t total = 0;
  double seconds = 0;
  for (int64_t f = 0; f < frames; f++) {
    MuxSlot& s = ctx->slots[(size_t)f];
    if (s.n < 0) return s.n;
    s.base = total;
    total += 5 + s.n;
    seconds += s.seconds;
  }
  *worker_s_out = seconds;
  ctx->frames = frames;
  ctx->total = total;
  return total;
}

}  // namespace

extern "C" {

// A mux context with num_threads workers (0: one per hardware thread), or
// null.
void* pfv_mux_new(int32_t num_threads) { return new_context<Mux>(num_threads); }

// Joins the context's workers and frees what it holds.
void pfv_mux_free(void* handle) { free_context<Mux>(handle); }

// Codes each of `frames` frames into the context's slots: frame f's
// counts[f] nonzeros (sorted frame-local flat indices idx, values val),
// after those of the frames before it (nnz in all); a keyframe (is_key[f])
// with q-table indices intra_q, else a P-frame with its block headers mvx,
// mvy, has_coeff (frames x nb each) and inter_q. Uses min(num_threads,
// frames) workers, the caller one of them. Writes *worker_s_out, the
// workers' summed seconds on the frames. Returns the exact byte count of
// the packets, or the first failing frame's negative code: -7
// unencodable coefficients, -6 memory refused; -5 where the counts pass
// nnz.
int64_t pfv_mux_encode(void* handle, const int32_t* idx, const int16_t* val,
                       int64_t nnz, const int64_t* counts, const int8_t* mvx,
                       const int8_t* mvy, const uint8_t* has_coeff,
                       const uint8_t* is_key, int64_t frames, int64_t nb,
                       const uint8_t* intra_q, const uint8_t* inter_q,
                       double* worker_s_out) {
  auto* ctx = static_cast<Mux*>(handle);
  ctx->total = -1;
  *worker_s_out = 0;
  try {
    return mux_encode(ctx, idx, val, nnz, counts, mvx, mvy, has_coeff, is_key,
                      frames, nb, intra_q, inter_q, worker_s_out);
  } catch (const std::bad_alloc&) {
    return -6;
  }
}

// Writes the coded frames' packets into out (`total` bytes, the count
// encode returned), by the workers. Returns 0, or -6 where total is not
// that count or no encode preceded.
int64_t pfv_mux_splice(void* handle, uint8_t* out, int64_t total) {
  auto* ctx = static_cast<Mux*>(handle);
  if (ctx->total < 0 || total != ctx->total) return -6;
  std::atomic<int64_t> next(0);
  auto splice = [&](int) {
    for (;;) {
      const int64_t k = next.fetch_add(1);
      if (k >= ctx->frames) return;
      const MuxSlot& s = ctx->slots[(size_t)ctx->order[(size_t)k]];
      uint8_t* p = out + s.base;
      p[0] = s.ptype;
      for (int i = 0; i < 4; i++) p[1 + i] = (uint8_t)((uint64_t)s.n >> (8 * i));
      std::memcpy(p + 5, s.buf.data.get(), (size_t)s.n);
    }
  };
  try {
    ctx->workers().run((int)std::min<int64_t>(ctx->nthreads, ctx->frames), splice);
  } catch (const std::bad_alloc&) {
    return -6;
  }
  ctx->total = -1;
  return 0;
}

}  // extern "C"
