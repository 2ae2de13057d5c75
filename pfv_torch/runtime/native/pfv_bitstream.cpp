// PFV v2.1.1 bitstream runtime: RLE + Huffman entropy coding, payload
// mux/demux, and a single-core scalar reference decoder.
//
// This is the host-side, inherently-serial half of the TPU rebuild (the
// reference implements it in Rust: src/rle.rs, src/huffman.rs, and the
// payload halves of src/enc.rs and src/dec.rs).
// Everything numeric/parallel lives on the TPU in JAX/Pallas; this library
// only converts between payload bytes and dense coefficient tensors.
//
// Bit-exactness contract (SURVEY.md quirks):
//  Q2  Huffman construction: stable sort descending by frequency (ties keep
//      ascending symbol order), pop two lowest, merged node inserted before
//      the first strictly-smaller entry; left=0/right=1; codes accumulate
//      LSB-first (huffman.rs:30-32, 61-99, 204-217).
//  Q5  num_zeroes and coeff_size share one 16-symbol histogram and tree;
//      the serialized table is the normalized-u8 table (rle.rs:41-66).
//  Q6  RLE runs never span blocks: each 256-coefficient block flushes its
//      trailing zero run (rle.rs:31-38, enc.rs:246-257).
//  Q10 All bit I/O is LSB-first within bytes (bitstream-io LittleEndian);
//      signed fields are written as (len-1) low magnitude bits then a sign
//      bit, two's-complement semantics.
//
// Exposed C ABI (ctypes): see the extern "C" block at the bottom.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Bit I/O, LSB-first within bytes (bitstream-io LittleEndian convention).
// ---------------------------------------------------------------------------

struct BitWriter {
  std::vector<uint8_t> buf;
  uint64_t acc = 0;
  int n = 0;

  inline void write(int nbits, uint32_t v) {
    if (nbits == 0) return;
    uint64_t mask = (nbits >= 32) ? 0xffffffffull : ((1ull << nbits) - 1);
    acc |= (uint64_t)(v & mask) << n;
    n += nbits;
    while (n >= 8) {
      buf.push_back((uint8_t)(acc & 0xff));
      acc >>= 8;
      n -= 8;
    }
  }

  inline void write_bit(bool b) { write(1, b ? 1u : 0u); }

  // Two's-complement signed write: low (nbits-1) magnitude bits, then sign.
  inline void write_signed(int nbits, int32_t v) {
    uint32_t mask = (1u << (nbits - 1)) - 1;
    write(nbits - 1, (uint32_t)v & mask);
    write_bit(v < 0);
  }

  inline void byte_align() {
    if (n > 0) {
      buf.push_back((uint8_t)(acc & 0xff));
      acc = 0;
      n = 0;
    }
  }
};

struct BitReader {
  const uint8_t* data;
  uint64_t nbytes;
  uint64_t total_bits;
  uint64_t pos = 0;
  bool error = false;

  BitReader(const uint8_t* d, uint64_t len)
      : data(d), nbytes(len), total_bits(len * 8) {}

  // Peek up to 32 bits (zero-filled past end of buffer), LSB-first.
  inline uint64_t peek(int nbits) {
    uint64_t byte = pos >> 3;
    int off = (int)(pos & 7);
    uint64_t acc = 0;
    if (byte + 8 <= nbytes) {
      std::memcpy(&acc, data + byte, 8);  // little-endian host
    } else {
      for (uint64_t i = 0; byte + i < nbytes; i++)
        acc |= (uint64_t)data[byte + i] << (8 * i);
    }
    acc >>= off;
    uint64_t mask = (nbits >= 64) ? ~0ull : ((1ull << nbits) - 1);
    return acc & mask;
  }

  inline uint32_t read(int nbits) {
    if (pos + nbits > total_bits) {
      error = true;
      return 0;
    }
    uint32_t v = (uint32_t)peek(nbits);
    pos += nbits;
    return v;
  }

  inline bool read_bit() { return read(1) != 0; }

  inline int32_t read_signed(int nbits) {
    uint32_t u = read(nbits - 1);
    bool sign = read_bit();
    return sign ? (int32_t)u - (1 << (nbits - 1)) : (int32_t)u;
  }
};

// ---------------------------------------------------------------------------
// Huffman tree over the shared 16-symbol alphabet.
// ---------------------------------------------------------------------------

struct HuffTree {
  uint32_t code_val[16];
  uint8_t code_len[16];
  uint8_t table[16];  // normalized frequency table (serialized form)
  // fast decode: 8-bit lookahead -> symbol/length (len 0 => slow path)
  uint8_t fast_sym[256];
  uint8_t fast_len[256];
  // node arena for the slow path (<=16 leaves + <=15 internal)
  int16_t left[32];
  int16_t right[32];
  int16_t sym[32];  // >=0 leaf symbol, -1 internal
  int root = -1;
  int nnodes = 0;
};

void assign_codes(HuffTree* t, int node, uint32_t val, uint32_t len) {
  if (t->sym[node] >= 0) {
    t->code_val[t->sym[node]] = val;
    t->code_len[t->sym[node]] = (uint8_t)len;
    return;
  }
  if (t->left[node] >= 0) assign_codes(t, t->left[node], val, len + 1);
  if (t->right[node] >= 0)
    assign_codes(t, t->right[node], val | (1u << len), len + 1);
}

// Build from the normalized u8 frequency table with the reference's exact
// tie-breaking (quirk Q2).
void huff_from_table(const uint8_t table[16], HuffTree* t) {
  std::memset(t->code_val, 0, sizeof(t->code_val));
  std::memset(t->code_len, 0, sizeof(t->code_len));
  std::memcpy(t->table, table, 16);
  t->nnodes = 0;
  t->root = -1;

  uint32_t freq[32];
  std::vector<int> p;
  for (int ch = 0; ch < 16; ch++) {
    if (table[ch] > 0) {
      int i = t->nnodes++;
      t->left[i] = t->right[i] = -1;
      t->sym[i] = (int16_t)ch;
      freq[i] = table[ch];
      p.push_back(i);
    }
  }
  // stable sort descending by frequency; ties keep ascending-symbol order
  std::stable_sort(p.begin(), p.end(),
                   [&](int a, int b) { return freq[a] > freq[b]; });

  while (p.size() > 1) {
    int a = p.back();
    p.pop_back();
    int b = p.back();
    p.pop_back();
    int c = t->nnodes++;
    t->left[c] = (int16_t)a;
    t->right[c] = (int16_t)b;
    t->sym[c] = -1;
    freq[c] = freq[a] + freq[b];
    size_t ins = p.size();
    for (size_t i = 0; i < p.size(); i++) {
      if (freq[c] > freq[p[i]]) {
        ins = i;
        break;
      }
    }
    p.insert(p.begin() + ins, c);
  }

  std::memset(t->fast_sym, 0, sizeof(t->fast_sym));
  std::memset(t->fast_len, 0, sizeof(t->fast_len));
  if (p.empty()) return;  // empty tree (huffman.rs:95-97)
  t->root = p.back();
  assign_codes(t, t->root, 0, 0);

  for (int val = 0; val < 256; val++) {
    for (int ch = 0; ch < 16; ch++) {
      uint32_t len = t->code_len[ch];
      if (len > 0 && len <= 8 &&
          ((uint32_t)val & ((1u << len) - 1)) == t->code_val[ch]) {
        t->fast_sym[val] = (uint8_t)ch;
        t->fast_len[val] = (uint8_t)len;
        break;
      }
    }
  }
}

// Decode one symbol (huffman.rs:125-197): fast 8-bit table with end guard,
// slow bit-by-bit tree walk fallback.
inline int huff_read(const HuffTree* t, BitReader& br) {
  uint64_t remaining = br.pos < br.total_bits ? br.total_bits - br.pos : 0;
  int rb = remaining < 8 ? (int)remaining : 8;
  uint32_t cur = (uint32_t)br.peek(rb);
  int len = t->fast_len[cur];
  // Near end-of-stream a code matched against zero-filled lookahead could
  // consume phantom bits; fall back to the bounds-checked tree walk there.
  if (len > 0 && (uint64_t)len <= remaining) {
    br.pos += len;
    return t->fast_sym[cur];
  }
  // slow tree walk
  int node = t->root;
  if (node < 0) {
    br.error = true;
    return -1;
  }
  while (t->sym[node] < 0) {
    bool bit = br.read_bit();
    if (br.error) return -1;
    node = bit ? t->right[node] : t->left[node];
    if (node < 0) {
      br.error = true;
      return -1;
    }
  }
  return t->sym[node];
}

// ---------------------------------------------------------------------------
// RLE (rle.rs:1-66).
// ---------------------------------------------------------------------------

struct RleSeq {
  uint8_t num_zeroes;
  uint8_t coeff_size;
  int16_t coeff;
};

// Returns false when a coefficient's magnitude exceeds the format's 15-bit
// limit (coeff_size would index past the 16-symbol alphabet; the reference
// panics on the same input). Not reachable from the real quantizer, but the
// exported C ABI accepts arbitrary int16 coefficients.
bool rle_encode_block(const int16_t* d, int len, std::vector<RleSeq>& out) {
  uint32_t run = 0;
  for (int i = 0; i < len; i++) {
    int16_t v = d[i];
    if (v == 0) {
      run++;
    } else {
      while (run > 15) {
        out.push_back({15, 0, 0});
        run -= 15;
      }
      uint32_t c = (uint32_t)(v < 0 ? -(int32_t)v : (int32_t)v);
      if (c >= 16384) return false;  // coeff_size would be > 15
      int numbits = (16 - (__builtin_clz(c) - 16)) + 1;
      out.push_back({(uint8_t)run, (uint8_t)numbits, v});
      run = 0;
    }
  }
  while (run > 15) {
    out.push_back({15, 0, 0});
    run -= 15;
  }
  if (run > 0) out.push_back({(uint8_t)run, 0, 0});
  return true;
}

// Sparse twin of rle_encode_block: build one block's RLE sequences from
// its sorted (flat idx, value) entries — O(nonzeros) instead of O(256).
// idx are absolute; `base` is the block's first slot. Zero values (legal
// in a sparse stream, e.g. from a cancelled scatter) merge into the
// surrounding zero run, matching what the dense walk would produce.
bool rle_encode_block_sparse(const int32_t* idx, const int16_t* val,
                             int64_t n, int32_t base,
                             std::vector<RleSeq>& out) {
  int32_t cur = 0;
  for (int64_t i = 0; i < n; i++) {
    int16_t v = val[i];
    if (v == 0) continue;
    // Reject misuse through the C ABI: a duplicate/decreasing/out-of-block
    // index would underflow `run` to ~2^32 and OOM the filler loop below.
    if (idx[i] - base < cur || idx[i] - base > 255) return false;
    uint32_t run = (uint32_t)(idx[i] - base - cur);
    while (run > 15) {
      out.push_back({15, 0, 0});
      run -= 15;
    }
    uint32_t c = (uint32_t)(v < 0 ? -(int32_t)v : (int32_t)v);
    if (c >= 16384) return false;  // coeff_size would be > 15
    int numbits = (16 - (__builtin_clz(c) - 16)) + 1;
    out.push_back({(uint8_t)run, (uint8_t)numbits, v});
    cur = idx[i] - base + 1;
  }
  uint32_t run = (uint32_t)(256 - cur);
  while (run > 15) {
    out.push_back({15, 0, 0});
    run -= 15;
  }
  if (run > 0) out.push_back({(uint8_t)run, 0, 0});
  return true;
}

// Normalize counts to u8 (rle.rs:49-66): x>0 -> max(1, x*255/max), else 0.
void normalize_table(const int64_t counts[16], uint8_t out[16]) {
  int64_t mx = 0;
  for (int i = 0; i < 16; i++) mx = std::max(mx, counts[i]);
  for (int i = 0; i < 16; i++) {
    if (counts[i] > 0) {
      int64_t v = counts[i] * 255 / mx;
      out[i] = (uint8_t)(v < 1 ? 1 : v);
    } else {
      out[i] = 0;
    }
  }
}

// Write one RLE sequence's symbols + coefficient (enc.rs:301-315).
inline void write_seq(BitWriter& bw, const HuffTree& t, const RleSeq& s) {
  bw.write(t.code_len[s.num_zeroes], t.code_val[s.num_zeroes]);
  bw.write(t.code_len[s.coeff_size], t.code_val[s.coeff_size]);
  if (s.coeff_size > 0) bw.write_signed(s.coeff_size, s.coeff);
}

// Fused (zero-run, coeff-size) symbol-pair table over a 12-bit lookahead.
// A hit is always a true double prefix match (the code tree is prefix-free
// and the 12 window bits are real stream bits); misses (either code > 8
// bits or the pair > 12 bits) fall back to the per-symbol path.
struct PairTable {
  // packed 64-bit entry (0 => fall back), fully precomputed so the decode
  // loop is branch-free:
  //   bits  0..7   nz        zero-run length
  //   bits  8..15  used      total bits consumed (pair + coefficient)
  //   bits 16..23  l12       pair code length (coefficient bit offset)
  //   bits 24..31  sshift    window shift of the coefficient sign bit
  //   bits 32..47  magmask   (1 << (coeff_size-1)) - 1
  //   bit  48      inc       1 if the sequence emits a coefficient
  uint64_t packed[4096];
  // bulk path for the (15, 0) filler pair that paves long zero runs
  // (rle.rs:18-20): up to 4 repetitions matched in one compare (longer
  // reps measure slower: they drain the 57-bit window below the refill
  // threshold every match and miss sub-rep runs)
  struct FillerTier {
    uint64_t rep = 0;
    uint64_t mask = 0;
    uint32_t len = 0;  // 0 => tier disabled
    uint32_t zeros = 0;
  } filler;
};

void build_pair_table(const HuffTree& t, PairTable* pt) {
  // Stride-fill: enumerate symbol pairs (<= 256) instead of the 4096
  // windows — each pair's entry lands at every window whose low bits spell
  // code1 then code2, i.e. base + k * 2^(l1+l2).
  std::memset(pt->packed, 0, sizeof(pt->packed));
  for (int s1 = 0; s1 < 16; s1++) {
    uint32_t l1 = t.code_len[s1];
    if (!l1 || l1 > 8) continue;
    for (int s2 = 0; s2 < 16; s2++) {
      uint32_t l2 = t.code_len[s2];
      if (!l2 || l2 > 8 || l1 + l2 > 12) continue;
      uint64_t nz = (uint64_t)s1;
      uint64_t sz = (uint64_t)s2;
      uint64_t l12 = (uint64_t)(l1 + l2);
      uint64_t used = l12 + sz;
      uint64_t inc = sz > 0 ? 1 : 0;
      // sign sits at window bit l12+sz-1; for sz==0 point it at a dead
      // bit (the mask is 0 and inc is 0, so the lanes are inert)
      uint64_t sshift = sz > 0 ? l12 + sz - 1 : 63;
      uint64_t magmask = sz > 0 ? (1ull << (sz - 1)) - 1 : 0;
      uint64_t entry = nz | (used << 8) | (l12 << 16) | (sshift << 24) |
                       (magmask << 32) | (inc << 48);
      uint32_t base = t.code_val[s1] | (t.code_val[s2] << l1);
      uint32_t stride = 1u << l12;
      for (uint32_t w = base; w < 4096; w += stride) pt->packed[w] = entry;
    }
  }
  pt->filler = {};
  uint32_t l15 = t.code_len[15], l0 = t.code_len[0];
  if (l15 > 0 && l0 > 0) {  // max pair length 30 bits (codes are <= 15)
    uint64_t pat = (uint64_t)t.code_val[15] |
                   ((uint64_t)t.code_val[0] << l15);
    uint32_t lp = l15 + l0;
    uint32_t reps = std::min<uint32_t>(std::max<uint32_t>(56 / lp, 1), 4);
    PairTable::FillerTier tr;
    for (uint32_t r = 0; r < reps; r++) tr.rep |= pat << (r * lp);
    tr.mask = (1ull << (reps * lp)) - 1;
    tr.len = reps * lp;
    tr.zeros = reps * 15;
    pt->filler = tr;
  }
}

// Decode a coefficient stream of `total` entries, emitting nonzeros via
// emit(position, value, inc) (dec.rs:258-296 / 381-415). `inc` is 1 when
// the sequence carries a coefficient and 0 for pure zero-run sequences;
// emit with inc==0 MAY write scratch to its current slot but must not
// advance (positions passed are always < total).
//
// Hot path: a register-resident 57-bit window refilled when it drops below
// 27 bits (worst-case fused sequence: 12-bit symbol pair + 15-bit
// coefficient); the per-sequence body is branch-free — one 64-bit table
// entry supplies the zero-run, bit count, magnitude mask, sign position
// and emit increment, and the store happens unconditionally.
template <typename Emit>
inline bool decode_coeff_entries(const HuffTree& t, const PairTable& pt,
                                 BitReader& br, int64_t total, Emit&& emit) {
  const uint64_t total_bits = br.total_bits;
  int64_t out_idx = 0;
  uint64_t pos = br.pos;
  uint64_t w = br.peek(57);
  int avail = (int)std::min<uint64_t>(57, total_bits - pos);
  const auto& ft = pt.filler;
  while (out_idx < total) {
    if (avail >= 27) {
      // bulk filler runs: N x (15 zeroes, no coeff) sequences per compare
      if (ft.len && (int)ft.len <= avail && ((w ^ ft.rep) & ft.mask) == 0 &&
          out_idx + ft.zeros <= total) {
        out_idx += ft.zeros;
        pos += ft.len;
        w >>= ft.len;
        avail -= ft.len;
        continue;
      }
      uint64_t e = pt.packed[w & 4095];
      if (e) {
        out_idx += (int)(e & 255);
        int used = (int)(e >> 8) & 255;
        int l12 = (int)(e >> 16) & 255;
        int sshift = (int)(e >> 24) & 255;
        int32_t magmask = (int32_t)((e >> 32) & 0xffff);
        int inc = (int)(e >> 48) & 1;
        int32_t mag = (int32_t)(w >> l12) & magmask;
        int32_t sign = (int32_t)(w >> sshift) & 1;
        int32_t c = mag - ((-sign) & (magmask + 1));
        if (out_idx >= total) {
          if (inc) return false;  // coefficient past the end: corrupt
          pos += used;
          break;  // trailing zero-run, stream exactly consumed
        }
        emit(out_idx, (int16_t)c, inc);
        out_idx += inc;
        pos += used;
        w >>= used;
        avail -= used;
        continue;
      }
    } else if (pos + (uint64_t)avail < total_bits) {
      // window ran low mid-stream: refill and retry the fast path
      br.pos = pos;
      w = br.peek(57);
      avail = (int)std::min<uint64_t>(57, total_bits - pos);
      continue;
    }
    // slow path: long codes or near end-of-stream
    br.pos = pos;
    uint64_t pos0 = br.pos;
    int nz = huff_read(&t, br);
    if (br.error || nz < 0) return false;
    out_idx += nz;
    int nbits = huff_read(&t, br);
    if (br.error || nbits < 0) return false;
    if (nbits > 0) {
      int32_t c = br.read_signed(nbits);
      if (br.error) return false;
      if (out_idx >= total) return false;
      emit(out_idx, (int16_t)c, 1);
      out_idx++;
    } else if (nz == 0 && br.pos == pos0) {
      // Degenerate single-leaf tree whose only symbol is 0: huff_read
      // consumes no bits and nothing advances — a hostile stream would
      // spin forever. Reject as corrupt.
      return false;
    }
    pos = br.pos;
    w = br.peek(57);
    avail = (int)std::min<uint64_t>(57, total_bits - pos);
  }
  br.pos = pos;
  return true;
}

// Dense form: write into a pre-zeroed buffer. inc==0 writes a zero to an
// untouched (still-zero) slot — a harmless scratch store that keeps the
// hot loop branch-free.
inline bool decode_coeff_stream(const HuffTree& t, const PairTable& pt,
                                BitReader& br, int16_t* coeffs,
                                int64_t total) {
  return decode_coeff_entries(
      t, pt, br, total, [&](int64_t i, int16_t v, int inc) {
        coeffs[i] = (int16_t)(v & -inc);
      });
}

// Sparse form: record only nonzero positions as split unit streams
//   deltas[k] (u16): position delta of unit k in the flat coefficient
//                    space (reconstructed on device by a cumsum)
//   vals[k]   (i8):  the unit's addend
// — 3 bytes per unit instead of a fused 4-byte pair (the H2D upload is
// CPU-bound on this host, so wire bytes are host milliseconds).
// Scatter-ADD semantics make zero-value units no-ops and let one nonzero
// span several units: a coefficient with |v| > 127 is emitted as
// ceil(|v|/127) units at the same position (delta 0) whose addends sum to
// v — ~3% of nonzeros at q2, so the unit stream stays ~nonzero-sized.
// RLE already enumerates nonzeros, so this touches no dense memory — the
// fast path for the TPU dataloader. Gaps over 65535 emit zero-value
// escape units; per-frame tails (sparse_tail) park the running sum
// exactly at the next frame's base so frames decode independently across
// threads.
struct SparseOut {
  uint16_t* deltas;
  int8_t* vals;
  int64_t n = 0;
  int64_t cap = 0;       // hard bound on n (hostile-stream guard)
  int64_t prev = 0;      // running flat position of the delta chain
  bool overflow = false;
};

// Append zero-value units advancing the delta chain to `target`.
inline bool sparse_tail(SparseOut& out, int64_t target) {
  int64_t d = target - out.prev;
  while (d > 0) {
    int64_t step = d > 65535 ? 65535 : d;
    if (out.n >= out.cap) {
      out.overflow = true;
      return false;
    }
    out.deltas[out.n] = (uint16_t)step;
    out.vals[out.n] = 0;
    out.n++;
    out.prev += step;
    d -= step;
  }
  return true;
}

// Emit one coefficient as split units at delta d (cold path for |v|>127:
// several same-position units whose i8 addends sum to v).
inline void sparse_emit_value(SparseOut& out, int64_t d, int32_t v, int inc) {
  if (__builtin_expect(v >= -127 && v <= 127, 1)) {
    out.deltas[out.n] = (uint16_t)d;
    out.vals[out.n] = (int8_t)v;
    out.n += inc;
    return;
  }
  // |v| > 127 implies a real coefficient (inc == 1; inc == 0 units always
  // carry value 0)
  int32_t step = v > 0 ? 127 : -127;
  for (;;) {
    out.deltas[out.n] = (uint16_t)d;
    d = 0;
    if (v >= -127 && v <= 127) {
      out.vals[out.n++] = (int8_t)v;
      return;
    }
    out.vals[out.n++] = (int8_t)step;
    v -= step;
    if (out.n >= out.cap) {
      out.overflow = true;
      return;
    }
  }
}

inline bool decode_coeff_stream_sparse(const HuffTree& t, const PairTable& pt,
                                       BitReader& br, int64_t base,
                                       int64_t total, SparseOut& out) {
  // inc==0 stores scratch at the current slot without advancing (it is
  // overwritten by the next real emit or ignored past the final count);
  // the capacity guard runs before every store, so even hostile streams
  // cannot write past the region.
  bool ok = decode_coeff_entries(
      t, pt, br, total, [&](int64_t i, int16_t v, int inc) {
        int64_t key = base + i;
        int64_t d = key - out.prev;
        if (__builtin_expect(d > 65535, 0)) {
          // escape units (zero value => scatter-add no-ops) advance the
          // chain; consistent even for inc==0 scratch stores
          do {
            if (out.n >= out.cap) {
              out.overflow = true;
              return;
            }
            out.deltas[out.n] = 65535u;
            out.vals[out.n] = 0;
            out.n++;
            out.prev += 65535;
            d -= 65535;
          } while (d > 65535);
        }
        if (out.n >= out.cap) {
          out.overflow = true;
          return;
        }
        sparse_emit_value(out, d, v, inc);
        out.prev += (key - out.prev) & -(int64_t)inc;  // = key when inc
      });
  return ok && !out.overflow;
}

// Fused P-frame form: decode the concatenated coefficient streams of all
// `nc` coded blocks (clist ascending, from read_block_headers_packed) in
// ONE decode_coeff_entries pass — entry i maps to block clist[i >> 8],
// offset i & 255. Valid because RLE flushes per block (Q6): an
// encoder-legal stream's sequences never span blocks, so concatenated
// entry counting is equivalent to per-block counting, and it kills the
// per-block loop restart (window reload + state spill per coded block,
// ~10% of demux time at 1080p). Corrupt streams may decode differently
// than the per-block path, but the emit-time capacity caps still hold.
inline bool decode_coeff_blocks_sparse(const HuffTree& t, const PairTable& pt,
                                       BitReader& br, int64_t frame_base,
                                       const int32_t* clist, int64_t nc,
                                       SparseOut& out) {
  bool ok = decode_coeff_entries(
      t, pt, br, nc * 256, [&](int64_t i, int16_t v, int inc) {
        int64_t key =
            frame_base + (int64_t)clist[i >> 8] * 256 + (i & 255);
        int64_t d = key - out.prev;
        if (__builtin_expect(d > 65535, 0)) {
          do {
            if (out.n >= out.cap) {
              out.overflow = true;
              return;
            }
            out.deltas[out.n] = 65535u;
            out.vals[out.n] = 0;
            out.n++;
            out.prev += 65535;
            d -= 65535;
          } while (d > 65535);
        }
        if (out.n >= out.cap) {
          out.overflow = true;
          return;
        }
        sparse_emit_value(out, d, v, inc);
        out.prev += (key - out.prev) & -(int64_t)inc;  // = key when inc
      });
  return ok && !out.overflow;
}

// Vectorized motion-bounds validation over packed block headers: decodes
// the 7-bit two's-complement lanes and checks them against per-block i16
// bounds (lox/hix/loy/hiy, widened once per demux call). Blocks without a
// motion vector carry zero lanes, and mv 0 is always legal (the block's
// own window), so validating every block unconditionally is correct.
// Returns nonzero if any vector escapes the padded plane (the reference
// panics on such streams via slice indexing; we reject with -8).
__attribute__((optimize("O3", "tree-vectorize"))) int validate_mv_lanes(
    const uint16_t* bh, int64_t n, const int16_t* lox, const int16_t* hix,
    const int16_t* loy, const int16_t* hiy, int16_t* absmax) {
  int bad = 0;
  int16_t mx_max = 0;
  for (int64_t b = 0; b < n; b++) {
    int16_t mx = (int16_t)(((bh[b] & 127) ^ 64) - 64);
    int16_t my = (int16_t)((((bh[b] >> 7) & 127) ^ 64) - 64);
    bad |= (mx < lox[b]) | (mx > hix[b]) | (my < loy[b]) | (my > hiy[b]);
    int16_t ax = mx < 0 ? (int16_t)-mx : mx;
    int16_t ay = my < 0 ? (int16_t)-my : my;
    int16_t m = ax > ay ? ax : ay;
    mx_max = m > mx_max ? m : mx_max;
  }
  if (absmax && mx_max > *absmax) *absmax = mx_max;
  return bad;
}

// Widen the packed per-block i8 bound lanes (lox | hix<<8 | loy<<16 |
// hiy<<24) into four i16 arrays for the SIMD validator.
struct MvBounds16 {
  std::vector<int16_t> lox, hix, loy, hiy;
};

void widen_mv_bounds(const int32_t* mv_bounds, int64_t n, MvBounds16* out) {
  out->lox.resize(n);
  out->hix.resize(n);
  out->loy.resize(n);
  out->hiy.resize(n);
  for (int64_t b = 0; b < n; b++) {
    int32_t bd = mv_bounds[b];
    out->lox[b] = (int16_t)(int8_t)bd;
    out->hix[b] = (int16_t)(int8_t)(bd >> 8);
    out->loy[b] = (int16_t)(int8_t)(bd >> 16);
    out->hiy[b] = (int16_t)(int8_t)(bd >> 24);
  }
}

// Windowed P-frame block-header parse into the packed per-block form
//   bh = (mvx & 127) | (mvy & 127) << 7 | has_coeff << 14
// (7-bit two's-complement motion lanes). One u16 store per block instead
// of three byte stores, and the block-header buffer uploads to the device
// as-is. Motion bounds are NOT checked here — validate_mv_lanes runs as a
// separate vectorized pass after the parse (a per-header check in this
// loop costs ~1.5 ms/clip at 1080p; the SIMD post-pass is ~0.1 ms).
// A register-resident 57-bit window (refilled when below 16 bits, the
// worst-case header) decodes several block headers per unaligned load.
// `coeff_list`/`n_coeff` (optional, together) collect the indices of
// blocks that carry coefficients, so the caller's coefficient loop skips
// straight to them instead of re-scanning every block header.
// Returns 0 or -2 (truncated).
inline int read_block_headers_packed(BitReader& br, int64_t total_blocks,
                                     uint16_t* bh,
                                     int32_t* coeff_list = nullptr,
                                     int64_t* n_coeff = nullptr) {
  const uint64_t total_bits = br.total_bits;
  int64_t b = 0;
  int64_t nc = 0;
  uint64_t w = br.peek(57);
  int avail = (int)std::min<uint64_t>(57, total_bits - br.pos);
  while (b < total_blocks) {
    if (avail < 16) {
      if ((uint64_t)avail < total_bits - br.pos) {
        w = br.peek(57);
        avail = (int)std::min<uint64_t>(57, total_bits - br.pos);
        continue;
      }
      // true end-of-stream: decode remaining headers bit-exactly with
      // per-field bounds checks
      if ((w & 3) == 0 || !(w & 1)) {
        if (br.pos + 2 > total_bits) {
          br.error = true;
          return -2;
        }
        bh[b] = (uint16_t)(((w >> 1) & 1) << 14);
        if (coeff_list && (w & 2)) coeff_list[nc++] = (int32_t)b;
        b++;
        br.pos += 2;
        w >>= 2;
        avail -= 2;
        continue;
      }
      br.error = true;  // mvec header needs 16 bits; stream is truncated
      return -2;
    }
    if ((w & 3) == 0) {
      // skip block (no mvec, no coeff). If the whole 16-bit window is
      // zero, it's 8 consecutive skip headers — bulk them (static regions)
      if ((w & 0xffff) == 0 && b + 8 <= total_blocks) {
        std::memset(bh + b, 0, 8 * sizeof(uint16_t));
        b += 8;
        br.pos += 16;
        w >>= 16;
        avail -= 16;
        continue;
      }
      bh[b] = 0;
      b++;
      br.pos += 2;
      w >>= 2;
      avail -= 2;
      continue;
    }
    bool has_mvec = w & 1;
    // paired fast case: two consecutive 16-bit mvec headers decoded from
    // one window (mvec-dense frames: ~2x fewer loop iterations)
    if (has_mvec && avail >= 32 && (w >> 16) & 1 && b + 2 <= total_blocks) {
      uint32_t hc0 = (uint32_t)(w >> 1) & 1;
      uint32_t hc1 = (uint32_t)(w >> 17) & 1;
      uint32_t h0 = (uint32_t)((w >> 2) & 0x3fff) | (hc0 << 14);
      uint32_t h1 = (uint32_t)((w >> 18) & 0x3fff) | (hc1 << 14);
      uint32_t both = h0 | (h1 << 16);
      std::memcpy(bh + b, &both, 4);  // little-endian host
      if (coeff_list) {
        coeff_list[nc] = (int32_t)b;
        nc += hc0;
        coeff_list[nc] = (int32_t)(b + 1);
        nc += hc1;
      }
      b += 2;
      br.pos += 32;
      w >>= 32;
      avail -= 32;
      continue;
    }
    uint16_t hc = (uint16_t)((w >> 1) & 1) << 14;
    if (coeff_list && hc) coeff_list[nc++] = (int32_t)b;
    if (has_mvec) {
      // the stream's 7-bit two's-complement lanes are stored verbatim
      uint16_t lanes = (uint16_t)((w >> 2) & 0x3fff);
      bh[b] = lanes | hc;
      br.pos += 16;
      w >>= 16;
      avail -= 16;
    } else {
      bh[b] = hc;
      br.pos += 2;
      w >>= 2;
      avail -= 2;
    }
    b++;
  }
  if (n_coeff) *n_coeff = nc;
  return 0;
}

// Unpack the packed block headers into separate int8/int8/u8 arrays
// (dense-demux and scalar-decoder form).
inline void unpack_block_headers(const uint16_t* bh, int64_t n, int8_t* mvx,
                                 int8_t* mvy, uint8_t* has_coeff) {
  for (int64_t b = 0; b < n; b++) {
    uint16_t m = bh[b];
    mvx[b] = (int8_t)((int32_t)((m & 127) ^ 64) - 64);
    mvy[b] = (int8_t)((int32_t)(((m >> 7) & 127) ^ 64) - 64);
    has_coeff[b] = (uint8_t)((m >> 14) & 1);
  }
}

// Legacy three-array form (dense demux + scalar decoder path).
inline bool read_block_headers(BitReader& br, int64_t total_blocks,
                               int8_t* mvx, int8_t* mvy, uint8_t* has_coeff) {
  const uint64_t total_bits = br.total_bits;
  int64_t b = 0;
  uint64_t w = br.peek(57);
  int avail = (int)std::min<uint64_t>(57, total_bits - br.pos);
  while (b < total_blocks) {
    if (avail < 16) {
      if ((uint64_t)avail < total_bits - br.pos) {
        w = br.peek(57);
        avail = (int)std::min<uint64_t>(57, total_bits - br.pos);
        continue;
      }
      // true end-of-stream: decode remaining headers bit-exactly with
      // per-field bounds checks
      if ((w & 3) == 0 || !(w & 1)) {
        if (br.pos + 2 > total_bits) {
          br.error = true;
          return false;
        }
        mvx[b] = 0;
        mvy[b] = 0;
        has_coeff[b] = (uint8_t)((w >> 1) & 1);
        b++;
        br.pos += 2;
        w >>= 2;
        avail -= 2;
        continue;
      }
      br.error = true;  // mvec header needs 16 bits; stream is truncated
      return false;
    }
    if ((w & 3) == 0) {
      // skip block (no mvec, no coeff). If the whole 16-bit window is
      // zero, it's 8 consecutive skip headers — bulk them (static regions)
      if ((w & 0xffff) == 0 && b + 8 <= total_blocks) {
        std::memset(mvx + b, 0, 8);
        std::memset(mvy + b, 0, 8);
        std::memset(has_coeff + b, 0, 8);
        b += 8;
        br.pos += 16;
        w >>= 16;
        avail -= 16;
        continue;
      }
      mvx[b] = 0;
      mvy[b] = 0;
      has_coeff[b] = 0;
      b++;
      br.pos += 2;
      w >>= 2;
      avail -= 2;
      continue;
    }
    bool has_mvec = w & 1;
    has_coeff[b] = (w >> 1) & 1;
    if (has_mvec) {
      uint32_t m1 = (uint32_t)(w >> 2) & 63;
      mvx[b] = (int8_t)(((w >> 8) & 1) ? (int32_t)m1 - 64 : (int32_t)m1);
      uint32_t m2 = (uint32_t)(w >> 9) & 63;
      mvy[b] = (int8_t)(((w >> 15) & 1) ? (int32_t)m2 - 64 : (int32_t)m2);
      br.pos += 16;
      w >>= 16;
      avail -= 16;
    } else {
      mvx[b] = 0;
      mvy[b] = 0;
      br.pos += 2;
      w >>= 2;
      avail -= 2;
    }
    b++;
  }
  return true;
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

// Encode an I-frame payload. coeffs: int16[total_blocks*256], all planes'
// blocks concatenated Y,U,V in raster order, each block = 4 subblocks x 64
// zigzag coefficients (enc.rs:237-330). Returns payload length, or -1 if
// out_cap is too small.
int64_t pfv_encode_iframe_payload(const int16_t* coeffs, int64_t total_blocks,
                                  const uint8_t* qidx, uint8_t* out,
                                  int64_t out_cap) {
  std::vector<std::vector<RleSeq>> block_seqs(total_blocks);
  int64_t counts[16] = {0};
  for (int64_t b = 0; b < total_blocks; b++) {
    if (!rle_encode_block(coeffs + b * 256, 256, block_seqs[b]))
      return -7;  // coefficient magnitude exceeds the 15-bit format limit
    for (const RleSeq& s : block_seqs[b]) {
      counts[s.num_zeroes]++;
      counts[s.coeff_size]++;
    }
  }
  uint8_t table[16];
  normalize_table(counts, table);
  HuffTree tree;
  huff_from_table(table, &tree);

  BitWriter bw;
  for (int i = 0; i < 16; i++) bw.write(8, table[i]);
  for (int i = 0; i < 3; i++) bw.write(8, qidx[i]);
  for (int64_t b = 0; b < total_blocks; b++)
    for (const RleSeq& s : block_seqs[b]) write_seq(bw, tree, s);
  bw.byte_align();

  if ((int64_t)bw.buf.size() > out_cap) return -1;
  std::memcpy(out, bw.buf.data(), bw.buf.size());
  return (int64_t)bw.buf.size();
}

// Sparse-input twin of pfv_encode_iframe_payload: takes the frame's
// nonzeros as sorted frame-local flat positions (block * 256 + slot) +
// values instead of a dense tensor — O(nonzeros) host work, no densify.
// Byte-identical output to the dense entry point on equivalent input.
int64_t pfv_encode_iframe_payload_sparse(const int32_t* idx,
                                         const int16_t* val, int64_t nnz,
                                         int64_t total_blocks,
                                         const uint8_t* qidx, uint8_t* out,
                                         int64_t out_cap) {
  std::vector<std::vector<RleSeq>> block_seqs(total_blocks);
  int64_t counts[16] = {0};
  int64_t i = 0;
  for (int64_t b = 0; b < total_blocks; b++) {
    int32_t hi = (int32_t)((b + 1) * 256);
    int64_t j = i;
    while (j < nnz && idx[j] < hi) j++;
    if (!rle_encode_block_sparse(idx + i, val + i, j - i, hi - 256,
                                 block_seqs[b]))
      return -7;
    for (const RleSeq& s : block_seqs[b]) {
      counts[s.num_zeroes]++;
      counts[s.coeff_size]++;
    }
    i = j;
  }
  uint8_t table[16];
  normalize_table(counts, table);
  HuffTree tree;
  huff_from_table(table, &tree);

  BitWriter bw;
  for (int k = 0; k < 16; k++) bw.write(8, table[k]);
  for (int k = 0; k < 3; k++) bw.write(8, qidx[k]);
  for (int64_t b = 0; b < total_blocks; b++)
    for (const RleSeq& s : block_seqs[b]) write_seq(bw, tree, s);
  bw.byte_align();

  if ((int64_t)bw.buf.size() > out_cap) return -1;
  std::memcpy(out, bw.buf.data(), bw.buf.size());
  return (int64_t)bw.buf.size();
}

// Decode an I-frame payload into dense coefficients
// (int16[total_subblocks*64], zigzag order) + 3 q-table indices.
// Returns 0 on success, negative on error.
int64_t pfv_decode_iframe_payload(const uint8_t* payload, int64_t len,
                                  int64_t total_subblocks, int16_t* coeffs_out,
                                  uint8_t* qidx_out) {
  BitReader br(payload, (uint64_t)len);
  uint8_t table[16];
  for (int i = 0; i < 16; i++) table[i] = (uint8_t)br.read(8);
  HuffTree tree;
  huff_from_table(table, &tree);
  PairTable pt;
  build_pair_table(tree, &pt);
  for (int i = 0; i < 3; i++) qidx_out[i] = (uint8_t)br.read(8);
  if (br.error) return -2;
  int64_t total = total_subblocks * 64;
  std::memset(coeffs_out, 0, total * sizeof(int16_t));
  if (!decode_coeff_stream(tree, pt, br, coeffs_out, total)) return -3;
  return 0;
}

// Encode a P-frame payload (enc.rs:332-481). Per block: mvx/mvy (int8),
// has_coeff flag; coeffs as in the I-frame layout (dense; skipped blocks'
// entries are ignored). Returns payload length, or -1 if out_cap too small.
int64_t pfv_encode_pframe_payload(const int16_t* coeffs, const int8_t* mvx,
                                  const int8_t* mvy, const uint8_t* has_coeff,
                                  int64_t total_blocks, const uint8_t* qidx,
                                  uint8_t* out, int64_t out_cap) {
  std::vector<std::vector<RleSeq>> block_seqs;
  block_seqs.reserve(total_blocks);
  int64_t counts[16] = {0};
  for (int64_t b = 0; b < total_blocks; b++) {
    if (!has_coeff[b]) continue;
    block_seqs.emplace_back();
    if (!rle_encode_block(coeffs + b * 256, 256, block_seqs.back()))
      return -7;  // coefficient magnitude exceeds the 15-bit format limit
    for (const RleSeq& s : block_seqs.back()) {
      counts[s.num_zeroes]++;
      counts[s.coeff_size]++;
    }
  }
  uint8_t table[16];
  normalize_table(counts, table);
  HuffTree tree;
  huff_from_table(table, &tree);

  BitWriter bw;
  for (int i = 0; i < 16; i++) bw.write(8, table[i]);
  for (int i = 0; i < 3; i++) bw.write(8, qidx[i]);
  for (int64_t b = 0; b < total_blocks; b++) {
    bool has_mvec = mvx[b] != 0 || mvy[b] != 0;
    bw.write_bit(has_mvec);
    bw.write_bit(has_coeff[b] != 0);
    if (has_mvec) {
      bw.write_signed(7, mvx[b]);
      bw.write_signed(7, mvy[b]);
    }
  }
  for (const auto& seqs : block_seqs)
    for (const RleSeq& s : seqs) write_seq(bw, tree, s);
  bw.byte_align();

  if ((int64_t)bw.buf.size() > out_cap) return -1;
  std::memcpy(out, bw.buf.data(), bw.buf.size());
  return (int64_t)bw.buf.size();
}

// Sparse-input twin of pfv_encode_pframe_payload. Entries landing in
// skipped blocks (has_coeff == 0) are ignored, matching the dense
// encoder's behavior of never reading those blocks' coefficients.
int64_t pfv_encode_pframe_payload_sparse(
    const int32_t* idx, const int16_t* val, int64_t nnz, const int8_t* mvx,
    const int8_t* mvy, const uint8_t* has_coeff, int64_t total_blocks,
    const uint8_t* qidx, uint8_t* out, int64_t out_cap) {
  std::vector<std::vector<RleSeq>> block_seqs;
  block_seqs.reserve(total_blocks);
  int64_t counts[16] = {0};
  int64_t i = 0;
  for (int64_t b = 0; b < total_blocks; b++) {
    int32_t hi = (int32_t)((b + 1) * 256);
    int64_t j = i;
    while (j < nnz && idx[j] < hi) j++;
    if (has_coeff[b]) {
      block_seqs.emplace_back();
      if (!rle_encode_block_sparse(idx + i, val + i, j - i, hi - 256,
                                   block_seqs.back()))
        return -7;
      for (const RleSeq& s : block_seqs.back()) {
        counts[s.num_zeroes]++;
        counts[s.coeff_size]++;
      }
    }
    i = j;
  }
  uint8_t table[16];
  normalize_table(counts, table);
  HuffTree tree;
  huff_from_table(table, &tree);

  BitWriter bw;
  for (int k = 0; k < 16; k++) bw.write(8, table[k]);
  for (int k = 0; k < 3; k++) bw.write(8, qidx[k]);
  for (int64_t b = 0; b < total_blocks; b++) {
    bool has_mvec = mvx[b] != 0 || mvy[b] != 0;
    bw.write_bit(has_mvec);
    bw.write_bit(has_coeff[b] != 0);
    if (has_mvec) {
      bw.write_signed(7, mvx[b]);
      bw.write_signed(7, mvy[b]);
    }
  }
  for (const auto& seqs : block_seqs)
    for (const RleSeq& s : seqs) write_seq(bw, tree, s);
  bw.byte_align();

  if ((int64_t)bw.buf.size() > out_cap) return -1;
  std::memcpy(out, bw.buf.data(), bw.buf.size());
  return (int64_t)bw.buf.size();
}

// Decode a P-frame payload (dec.rs:328-448): block headers + dense
// coefficients (zeros for skipped blocks). Returns 0 or negative error.
int64_t pfv_decode_pframe_payload(const uint8_t* payload, int64_t len,
                                  int64_t total_blocks, int16_t* coeffs_out,
                                  int8_t* mvx_out, int8_t* mvy_out,
                                  uint8_t* has_coeff_out, uint8_t* qidx_out) {
  BitReader br(payload, (uint64_t)len);
  uint8_t table[16];
  for (int i = 0; i < 16; i++) table[i] = (uint8_t)br.read(8);
  HuffTree tree;
  huff_from_table(table, &tree);
  PairTable pt;
  build_pair_table(tree, &pt);
  for (int i = 0; i < 3; i++) qidx_out[i] = (uint8_t)br.read(8);
  if (br.error) return -2;

  if (!read_block_headers(br, total_blocks, mvx_out, mvy_out, has_coeff_out))
    return -2;

  std::memset(coeffs_out, 0, total_blocks * 256 * sizeof(int16_t));
  for (int64_t b = 0; b < total_blocks; b++) {
    if (!has_coeff_out[b]) continue;
    if (!decode_coeff_stream(tree, pt, br, coeffs_out + b * 256, 256))
      return -3;
  }
  return 0;
}

namespace {

// Sparse payload decode shared by pfv_demux_file_sparse. Block headers land
// in the packed u16 form (see read_block_headers_packed); motion bounds are
// validated by a vectorized post-pass (bounds16, optional).
int64_t decode_payload_sparse(const uint8_t* payload, int64_t len,
                              uint8_t ptype, int64_t total_blocks,
                              int64_t frame_base, uint16_t* bh,
                              const MvBounds16* bounds16, uint8_t* qidx,
                              SparseOut& out, int16_t* mv_absmax) {
  BitReader br(payload, (uint64_t)len);
  uint8_t table[16];
  for (int i = 0; i < 16; i++) table[i] = (uint8_t)br.read(8);
  HuffTree tree;
  huff_from_table(table, &tree);
  PairTable pt;
  build_pair_table(tree, &pt);
  for (int i = 0; i < 3; i++) qidx[i] = (uint8_t)br.read(8);
  if (br.error) return -2;

  if (ptype == 1) {
    for (int64_t b = 0; b < total_blocks; b++) bh[b] = 1u << 14;
    if (!decode_coeff_stream_sparse(tree, pt, br, frame_base,
                                    total_blocks * 256, out))
      return -3;
    return 0;
  }
  std::vector<int32_t> clist(total_blocks);
  int64_t ncoeff = 0;
  int rc = read_block_headers_packed(br, total_blocks, bh, clist.data(),
                                     &ncoeff);
  if (rc != 0) return rc;
  if (bounds16 &&
      validate_mv_lanes(bh, total_blocks, bounds16->lox.data(),
                        bounds16->hix.data(), bounds16->loy.data(),
                        bounds16->hiy.data(), mv_absmax))
    return -8;
  if (!decode_coeff_blocks_sparse(tree, pt, br, frame_base, clist.data(),
                                  ncoeff, out))
    return -3;
  return 0;
}

// ---------------------------------------------------------------------------
// pstep-layout sparse demux (v2): units bucketed by dense ROW so the device
// scatter lands directly in the fused step kernel's coefficient layout
//   (frame, row r, stripe s, lane)  with  lane = 4*gc + 2*sr + sc
// flat key = frame*64*row_span + r*row_span + off_of_b[block] + subblock,
// where r already applies the unzigzag permutation (the kernel then needs
// no row shuffle) and off_of_b = s*row_span_stride... (precomputed by the
// Python caller: s*2*scp + 4*gc in canvas geometry). Within a frame the
// stream visits blocks in [Y | U | V] order; Y and U rows ascend together
// (U stripes sit below all Y stripes) but V blocks revisit the chroma
// stripes, so each row bucket is two ascending runs (Y+U, then V) merged
// at emission. Delta/escape/tail semantics are identical to the v1 form
// (see pfv_demux_file_sparse).
// ---------------------------------------------------------------------------

struct PstepBuckets {
  // per dense row: packed entries (pos_in_row << 8 | (uint8_t)val_i8);
  // pos_in_row < row_span (caller guarantees row_span < 2^24)
  std::vector<uint32_t> rows[64];
  size_t vstart[64];  // index where the V run begins (SIZE_MAX: no V yet)
  int64_t n = 0;      // units appended (shares the per-frame cap analysis)
  int64_t cap = 0;
  bool overflow = false;

  void reset(int64_t cap_) {
    for (auto& r : rows) r.clear();
    for (auto& v : vstart) v = SIZE_MAX;
    n = 0;
    cap = cap_;
    overflow = false;
  }

  // Append coefficient v at (row r, pos), splitting |v| > 127 into i8
  // units exactly like sparse_emit_value.
  inline void add(int r, uint32_t pos, int32_t v, bool in_v) {
    auto& bkt = rows[r];
    if (in_v && vstart[r] == SIZE_MAX) vstart[r] = bkt.size();
    int32_t step = v > 0 ? 127 : -127;
    for (;;) {
      if (n >= cap) {
        overflow = true;
        return;
      }
      if (v >= -127 && v <= 127) {
        bkt.push_back((pos << 8) | (uint8_t)(int8_t)v);
        n++;
        return;
      }
      bkt.push_back((pos << 8) | (uint8_t)(int8_t)step);
      n++;
      v -= step;
    }
  }
};

// Walk the buckets in row order, merge each row's two ascending runs, and
// append the delta/escape chain to `out` (keys ascend strictly within and
// across rows). frame_base = f * 64 * row_span.
inline bool pstep_emit_frame(PstepBuckets& bkt, int64_t frame_base,
                             int64_t row_span, SparseOut& out) {
  for (int r = 0; r < 64; r++) {
    const auto& a = bkt.rows[r];
    const size_t nr = a.size();
    const size_t vs = bkt.vstart[r] == SIZE_MAX ? nr : bkt.vstart[r];
    const int64_t row_base = frame_base + (int64_t)r * row_span;
    size_t i = 0, j = vs;
    while (i < vs || j < nr) {
      uint32_t e;
      // lanes of the Y+U and V runs are disjoint, so ties cannot occur
      if (i < vs && (j >= nr || (a[i] >> 8) < (a[j] >> 8))) {
        e = a[i++];
      } else {
        e = a[j++];
      }
      int64_t key = row_base + (int64_t)(e >> 8);
      int64_t d = key - out.prev;
      while (d > 65535) {
        if (out.n >= out.cap) {
          out.overflow = true;
          return false;
        }
        out.deltas[out.n] = 65535u;
        out.vals[out.n] = 0;
        out.n++;
        out.prev += 65535;
        d -= 65535;
      }
      if (out.n >= out.cap) {
        out.overflow = true;
        return false;
      }
      out.deltas[out.n] = (uint16_t)d;
      out.vals[out.n] = (int8_t)(uint8_t)(e & 0xff);
      out.n++;
      out.prev = key;
    }
  }
  return true;
}

// Payload decode into pstep buckets: same entropy pass as
// decode_payload_sparse, different sink. off_of_b maps a stream block to
// s*2*scp + 4*gc; r_of_zz maps a zigzag slot to its dense (row-major,
// unzigzagged) row; vstart_block marks the first V-region block.
int64_t decode_payload_pstep(const uint8_t* payload, int64_t len,
                             uint8_t ptype, int64_t total_blocks,
                             uint16_t* bh, const MvBounds16* bounds16,
                             uint8_t* qidx, const int32_t* off_of_b,
                             const int32_t* r_of_zz, int64_t vstart_block,
                             PstepBuckets& bkt, int16_t* mv_absmax) {
  BitReader br(payload, (uint64_t)len);
  uint8_t table[16];
  for (int i = 0; i < 16; i++) table[i] = (uint8_t)br.read(8);
  HuffTree tree;
  huff_from_table(table, &tree);
  PairTable pt;
  build_pair_table(tree, &pt);
  for (int i = 0; i < 3; i++) qidx[i] = (uint8_t)br.read(8);
  if (br.error) return -2;

  auto sink = [&](int64_t block, int64_t i, int16_t v, int inc) {
    if (!inc) return;
    int p = (int)(i & 255);
    bkt.add(r_of_zz[p & 63],
            (uint32_t)(off_of_b[block] + (p >> 6)), v,
            block >= vstart_block);
  };

  if (ptype == 1) {
    for (int64_t b = 0; b < total_blocks; b++) bh[b] = 1u << 14;
    if (!decode_coeff_entries(tree, pt, br, total_blocks * 256,
                              [&](int64_t i, int16_t v, int inc) {
                                sink(i >> 8, i, v, inc);
                              }) ||
        bkt.overflow)
      return -3;
    return 0;
  }
  std::vector<int32_t> clist(total_blocks);
  int64_t ncoeff = 0;
  int rc = read_block_headers_packed(br, total_blocks, bh, clist.data(),
                                     &ncoeff);
  if (rc != 0) return rc;
  if (bounds16 &&
      validate_mv_lanes(bh, total_blocks, bounds16->lox.data(),
                        bounds16->hix.data(), bounds16->loy.data(),
                        bounds16->hiy.data(), mv_absmax))
    return -8;
  if (!decode_coeff_entries(tree, pt, br, ncoeff * 256,
                            [&](int64_t i, int16_t v, int inc) {
                              sink(clist[i >> 8], i, v, inc);
                            }) ||
      bkt.overflow)
    return -3;
  return 0;
}

}  // namespace

extern "C" {

// pstep-layout sparse whole-file demux (v2): like pfv_demux_file_sparse
// but unit positions chain through the fused step kernel's coefficient
// space — flat key = (frame*64 + r) * row_span + off_of_b[block] + sub,
// r = r_of_zz[zigzag slot] (unzigzag applied at demux time). Each frame's
// tail parks at (f+1)*64*row_span; the final unit parks at
// frames*64*row_span, the densify scatter's sacrificial slot. Caller must
// guarantee row_span < 2^24 and frames*64*row_span < 2^31.
int64_t pfv_demux_file_sparse_pstep(
    const uint8_t* file, int64_t len, int64_t header_off,
    int64_t total_blocks, int64_t max_frames, uint16_t* bh_out,
    const int32_t* mv_bounds, uint8_t* ftype, uint8_t* qidx,
    uint16_t* deltas_out, int8_t* vals_out, int64_t out_cap,
    int16_t* mv_absmax_out, int32_t num_threads, const int32_t* off_of_b,
    const int32_t* r_of_zz, int64_t row_span, int64_t vstart_block) {
  struct Packet {
    const uint8_t* payload;
    uint32_t plen;
    uint8_t ptype;
  };
  std::vector<Packet> pkts;
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
  int64_t frames = (int64_t)pkts.size();
  const int64_t span = (int64_t)64 * row_span;

  // Same per-frame unit-count analysis as v1 (the unit count is layout-
  // independent); the escape bound grows with the padded span.
  const int64_t tail_bound = span / 65535 + 1;
  auto frame_bound = [&](int64_t f) {
    return std::min(69 * (int64_t)pkts[f].plen + 8, 129 * span) + tail_bound;
  };

  int nthreads = num_threads > 0 ? num_threads
                                 : (int)std::thread::hardware_concurrency();
  nthreads = std::max(1, std::min<int>(nthreads, frames > 0 ? (int)frames : 1));

  MvBounds16 bounds16;
  if (mv_bounds) widen_mv_bounds(mv_bounds, total_blocks, &bounds16);
  const MvBounds16* b16 = mv_bounds ? &bounds16 : nullptr;

  std::vector<int16_t> mvmax(std::max<int64_t>(frames, 1), 0);
  auto decode_frame = [&](int64_t f, PstepBuckets& bkt,
                          SparseOut& out) -> int64_t {
    const Packet& p = pkts[f];
    ftype[f] = p.ptype;
    bkt.reset(frame_bound(f));
    out.n = 0;
    out.prev = f * span;
    out.overflow = false;
    int64_t rc = decode_payload_pstep(
        p.payload, p.plen, p.ptype, total_blocks, bh_out + f * total_blocks,
        b16, qidx + f * 3, off_of_b, r_of_zz, vstart_block, bkt, &mvmax[f]);
    if (rc == 0 && !pstep_emit_frame(bkt, f * span, row_span, out)) rc = -3;
    if (rc == 0 && !sparse_tail(out, (f + 1) * span)) rc = -3;
    return rc;
  };

  auto report_mvmax = [&]() {
    if (!mv_absmax_out) return;
    int16_t m = 0;
    for (int64_t f = 0; f < frames; f++) m = std::max(m, mvmax[f]);
    *mv_absmax_out = m;
  };

  if (nthreads <= 1 && deltas_out != nullptr) {
    PstepBuckets bkt;
    SparseOut out;
    int64_t pos = 0;
    for (int64_t f = 0; f < frames; f++) {
      out.deltas = deltas_out + pos;
      out.vals = vals_out + pos;
      out.cap = std::min(frame_bound(f), out_cap - pos);
      int64_t rc = decode_frame(f, bkt, out);
      if (rc != 0) return out.overflow && pos + frame_bound(f) > out_cap
                              ? (int64_t)-6
                              : rc;
      pos += out.n;
    }
    report_mvmax();
    return pos;
  }

  std::vector<int64_t> fcap(frames + 1, 0);
  for (int64_t f = 0; f < frames; f++)
    fcap[f + 1] = fcap[f] + frame_bound(f);
  std::unique_ptr<uint16_t[]> delta_scratch(new uint16_t[fcap[frames]]);
  std::unique_ptr<int8_t[]> val_scratch(new int8_t[fcap[frames]]);
  std::vector<SparseOut> fout(frames);
  std::atomic<int64_t> next(0);
  std::atomic<int64_t> err(0);
  auto worker = [&]() {
    PstepBuckets bkt;
    for (;;) {
      int64_t f = next.fetch_add(1);
      if (f >= frames) return;
      fout[f].deltas = delta_scratch.get() + fcap[f];
      fout[f].vals = val_scratch.get() + fcap[f];
      fout[f].cap = fcap[f + 1] - fcap[f];
      int64_t rc = decode_frame(f, bkt, fout[f]);
      if (rc != 0) err.store(rc);
    }
  };
  if (nthreads <= 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    for (int i = 0; i < nthreads; i++) pool.emplace_back(worker);
    for (auto& t : pool) t.join();
  }
  if (err.load() != 0) return err.load();

  int64_t nunits = 0;
  for (auto& o : fout) nunits += o.n;
  report_mvmax();
  if (deltas_out == nullptr) return nunits;
  if (nunits > out_cap) return -6;
  int64_t pos = 0;
  for (int64_t f = 0; f < frames; f++) {
    std::memcpy(deltas_out + pos, fout[f].deltas, fout[f].n * 2);
    std::memcpy(vals_out + pos, fout[f].vals, fout[f].n);
    pos += fout[f].n;
  }
  return nunits;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// tile-bucketed unit demux (v3): units grouped per (frame, stripe) TILE in
// fixed-size chunks of `chunk` units, for the seq kernel's IN-KERNEL densify
// (ops/pallas/step_kernel.py units variant). Per unit one u32 word:
// idx << 16 | (uint16_t)(int16_t)val, where idx packs the tile-local
// coefficient position (dense row r << 10 | lane, lane < 1024 = 2*scp) and
// val (i8, sign-extended into the low half) the addend (|v| > 127 spans
// several same-position units, exactly like the v1/v2 sparse forms — the
// kernel's one-hot matmul accumulation sums them). The single-u32 form is
// Mosaic-driven: 32-bit VMEM tiles have no sublane packing, so the kernel's
// dynamic per-chunk DMA slice (units.at[k], a (1, 1, chunk) slab) is always
// tile-aligned, and one array means one DMA per chunk. Unlike v1/v2 there is
// NO delta chain and NO bookkeeping units: order within a tile is irrelevant
// to a matmul accumulation, zero-value coefficients contribute nothing and
// are dropped. Chunk k of tile t lives at rows coff[t] <= k < coff[t+1] of
// the (n_chunks, chunk) output array; short final chunks are zero-padded
// (val 0 = no-op).
// ---------------------------------------------------------------------------

namespace {

struct TileBuckets {
  std::vector<std::vector<uint32_t>> tiles;  // (idx16 << 8) | (uint8_t)val
  int64_t n = 0;  // units appended (shares the per-frame cap analysis)
  int64_t cap = 0;
  bool overflow = false;

  void reset(int64_t gch, int64_t cap_) {
    tiles.resize((size_t)gch);
    for (auto& t : tiles) t.clear();
    n = 0;
    cap = cap_;
    overflow = false;
  }

  inline void add(int stripe, uint32_t idx, int32_t v) {
    if (v == 0) return;  // no delta chain: zeros contribute nothing
    auto& b = tiles[(size_t)stripe];
    int32_t step = v > 0 ? 127 : -127;
    for (;;) {
      if (n >= cap) {
        overflow = true;
        return;
      }
      if (v >= -127 && v <= 127) {
        b.push_back((idx << 8) | (uint8_t)(int8_t)v);
        n++;
        return;
      }
      b.push_back((idx << 8) | (uint8_t)(int8_t)step);
      n++;
      v -= step;
    }
  }
};

// Same entropy pass as decode_payload_pstep, tile-bucket sink.
int64_t decode_payload_tiles(const uint8_t* payload, int64_t len,
                             uint8_t ptype, int64_t total_blocks,
                             uint16_t* bh, const MvBounds16* bounds16,
                             uint8_t* qidx, const int32_t* stripe_of_b,
                             const int32_t* lanebase_of_b,
                             const int32_t* r_of_zz, TileBuckets& bkt,
                             int16_t* mv_absmax) {
  BitReader br(payload, (uint64_t)len);
  uint8_t table[16];
  for (int i = 0; i < 16; i++) table[i] = (uint8_t)br.read(8);
  HuffTree tree;
  huff_from_table(table, &tree);
  PairTable pt;
  build_pair_table(tree, &pt);
  for (int i = 0; i < 3; i++) qidx[i] = (uint8_t)br.read(8);
  if (br.error) return -2;

  auto sink = [&](int64_t block, int64_t i, int16_t v, int inc) {
    if (!inc) return;
    int p = (int)(i & 255);
    uint32_t idx = ((uint32_t)r_of_zz[p & 63] << 10) |
                   (uint32_t)(lanebase_of_b[block] + (p >> 6));
    bkt.add(stripe_of_b[block], idx, v);
  };

  if (ptype == 1) {
    for (int64_t b = 0; b < total_blocks; b++) bh[b] = 1u << 14;
    if (!decode_coeff_entries(tree, pt, br, total_blocks * 256,
                              [&](int64_t i, int16_t v, int inc) {
                                sink(i >> 8, i, v, inc);
                              }) ||
        bkt.overflow)
      return -3;
    return 0;
  }
  std::vector<int32_t> clist(total_blocks);
  int64_t ncoeff = 0;
  int rc = read_block_headers_packed(br, total_blocks, bh, clist.data(),
                                     &ncoeff);
  if (rc != 0) return rc;
  if (bounds16 &&
      validate_mv_lanes(bh, total_blocks, bounds16->lox.data(),
                        bounds16->hix.data(), bounds16->loy.data(),
                        bounds16->hiy.data(), mv_absmax))
    return -8;
  if (!decode_coeff_entries(tree, pt, br, ncoeff * 256,
                            [&](int64_t i, int16_t v, int inc) {
                              sink(clist[i >> 8], i, v, inc);
                            }) ||
      bkt.overflow)
    return -3;
  return 0;
}

// Emit one frame's buckets as zero-padded chunks; advances *chunk_pos and
// fills coff_out[f*gch+1 .. f*gch+gch] with cumulative chunk offsets.
inline bool tiles_emit_frame(TileBuckets& bkt, int64_t gch, int64_t chunk,
                             uint32_t* units_out, int64_t cap_chunks,
                             int32_t* coff_out, int64_t* chunk_pos) {
  int64_t cpos = *chunk_pos;
  for (int64_t s = 0; s < gch; s++) {
    const auto& b = bkt.tiles[(size_t)s];
    const int64_t cnt = (int64_t)b.size();
    const int64_t nch = (cnt + chunk - 1) / chunk;
    if (cpos + nch > cap_chunks) return false;
    uint32_t* du = units_out + cpos * chunk;
    for (int64_t k = 0; k < cnt; k++) {
      const uint32_t w = b[(size_t)k];
      du[k] = ((w >> 8) << 16) |
              (uint32_t)(uint16_t)(int16_t)(int8_t)(uint8_t)(w & 0xff);
    }
    const int64_t pad = nch * chunk - cnt;
    if (pad) std::memset(du + cnt, 0, (size_t)pad * 4);
    cpos += nch;
    coff_out[s + 1] = (int32_t)cpos;
  }
  *chunk_pos = cpos;
  return true;
}

}  // namespace

extern "C" {

// Whole-file tile demux. Outputs: units (cap_chunks x chunk) u32 words
// (idx << 16 | (u16)(i16)val — see tiles_emit_frame), coff_out
// (frames*gch + 1) cumulative chunk offsets (coff_out[0] = 0 set
// here). Returns total chunks, or negative error (-6 = capacity).
// Threading mirrors pfv_demux_file_sparse_pstep: per-frame workers into
// per-frame scratch, then a single-threaded splice (which also rebases
// the per-frame coff segments).
int64_t pfv_demux_file_sparse_tiles(
    const uint8_t* file, int64_t len, int64_t header_off,
    int64_t total_blocks, int64_t max_frames, uint16_t* bh_out,
    const int32_t* mv_bounds, uint8_t* ftype, uint8_t* qidx,
    uint32_t* units_out, int64_t cap_chunks,
    int32_t* coff_out, int64_t chunk, int16_t* mv_absmax_out,
    int32_t num_threads, const int32_t* stripe_of_b,
    const int32_t* lanebase_of_b, const int32_t* r_of_zz, int64_t gch) {
  struct Packet {
    const uint8_t* payload;
    uint32_t plen;
    uint8_t ptype;
  };
  std::vector<Packet> pkts;
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

  // per-frame unit bound (layout-independent, see v1); chunk bound adds one
  // short chunk per stripe
  auto unit_bound = [&](int64_t f) {
    return std::min(69 * (int64_t)pkts[f].plen + 8,
                    129 * total_blocks * 256);
  };
  auto chunk_bound = [&](int64_t f) {
    return unit_bound(f) / chunk + gch + 1;
  };

  int nthreads = num_threads > 0 ? num_threads
                                 : (int)std::thread::hardware_concurrency();
  nthreads = std::max(1, std::min<int>(nthreads, frames > 0 ? (int)frames : 1));

  MvBounds16 bounds16;
  if (mv_bounds) widen_mv_bounds(mv_bounds, total_blocks, &bounds16);
  const MvBounds16* b16 = mv_bounds ? &bounds16 : nullptr;

  std::vector<int16_t> mvmax(std::max<int64_t>(frames, 1), 0);
  coff_out[0] = 0;

  auto report_mvmax = [&]() {
    if (!mv_absmax_out) return;
    int16_t m = 0;
    for (int64_t f = 0; f < frames; f++) m = std::max(m, mvmax[f]);
    *mv_absmax_out = m;
  };

  if (nthreads <= 1) {
    TileBuckets bkt;
    int64_t cpos = 0;
    for (int64_t f = 0; f < frames; f++) {
      ftype[f] = pkts[f].ptype;
      bkt.reset(gch, unit_bound(f));
      int64_t rc = decode_payload_tiles(
          pkts[f].payload, pkts[f].plen, pkts[f].ptype, total_blocks,
          bh_out + f * total_blocks, b16, qidx + f * 3, stripe_of_b,
          lanebase_of_b, r_of_zz, bkt, &mvmax[f]);
      if (rc != 0) return rc;
      if (!tiles_emit_frame(bkt, gch, chunk, units_out, cap_chunks,
                            coff_out + f * gch, &cpos))
        return -6;
    }
    report_mvmax();
    return cpos;
  }

  std::vector<int64_t> fcap(frames + 1, 0);
  for (int64_t f = 0; f < frames; f++)
    fcap[f + 1] = fcap[f] + chunk_bound(f);
  std::unique_ptr<uint32_t[]> unit_scratch(new uint32_t[fcap[frames] * chunk]);
  std::vector<std::vector<int32_t>> fcoff(frames);
  std::vector<int64_t> fchunks(frames, 0);
  std::atomic<int64_t> next(0);
  std::atomic<int64_t> err(0);
  auto worker = [&]() {
    TileBuckets bkt;
    for (;;) {
      int64_t f = next.fetch_add(1);
      if (f >= frames) return;
      ftype[f] = pkts[f].ptype;
      bkt.reset(gch, unit_bound(f));
      int64_t rc = decode_payload_tiles(
          pkts[f].payload, pkts[f].plen, pkts[f].ptype, total_blocks,
          bh_out + f * total_blocks, b16, qidx + f * 3, stripe_of_b,
          lanebase_of_b, r_of_zz, bkt, &mvmax[f]);
      if (rc == 0) {
        fcoff[f].assign((size_t)gch + 1, 0);
        int64_t cpos = 0;
        if (!tiles_emit_frame(bkt, gch, chunk,
                              unit_scratch.get() + fcap[f] * chunk,
                              fcap[f + 1] - fcap[f], fcoff[f].data(), &cpos))
          rc = -6;
        fchunks[f] = cpos;
      }
      if (rc != 0) err.store(rc);
    }
  };
  std::vector<std::thread> pool;
  for (int i = 0; i < nthreads; i++) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
  if (err.load() != 0) return err.load();

  int64_t total_chunks = 0;
  for (int64_t f = 0; f < frames; f++) total_chunks += fchunks[f];
  report_mvmax();
  if (total_chunks > cap_chunks) return -6;
  int64_t cpos = 0;
  for (int64_t f = 0; f < frames; f++) {
    std::memcpy(units_out + cpos * chunk, unit_scratch.get() + fcap[f] * chunk,
                (size_t)(fchunks[f] * chunk) * 4);
    for (int64_t s = 0; s < gch; s++)
      coff_out[f * gch + s + 1] = (int32_t)(cpos + fcoff[f][(size_t)s + 1]);
    cpos += fchunks[f];
  }
  return total_chunks;
}

}  // extern "C"

extern "C" {

// Sparse whole-file demux: like pfv_demux_file but coefficients come back
// as split unit streams, deltas_out (u16) + vals_out (i8), 3 bytes per
// unit — flat position of unit k = sum of deltas[0..k] over
// (frame * total_blocks + block) * 256 + pos space, reconstructed on
// device by a cumsum; the dense value at a position is the scatter-ADD of
// all its units (|v| > 127 spans several same-position units; zero-value
// units — gap escapes, per-frame tails — are no-ops). Each frame's chain
// starts at its frame base and its tail parks the running sum exactly at
// the next frame's base, so frames decode independently across threads
// and the final unit parks at frames*total_blocks*256 (the densify
// scatter's sacrificial slot) for bucket padding. Block headers come in
// the packed u16 form (bh_out, F * total_blocks entries; uploadable
// as-is). Requires frames * total_blocks * 256 < 2^31. mv_bounds
// (optional): per-block packed int8 motion bounds, validated by a
// vectorized pass after each header parse (error -8).
//
// Two-call protocol: pass deltas_out == NULL to get the required unit count
// (frame metadata is still written); then call again with buffers of that
// size. Returns the unit count, or negative error.
int64_t pfv_demux_file_sparse(const uint8_t* file, int64_t len,
                              int64_t header_off, int64_t total_blocks,
                              int64_t max_frames, uint16_t* bh_out,
                              const int32_t* mv_bounds, uint8_t* ftype,
                              uint8_t* qidx, uint16_t* deltas_out,
                              int8_t* vals_out, int64_t out_cap,
                              int16_t* mv_absmax_out, int32_t num_threads) {
  struct Packet {
    const uint8_t* payload;
    uint32_t plen;
    uint8_t ptype;
  };
  std::vector<Packet> pkts;
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
  int64_t frames = (int64_t)pkts.size();

  const int64_t span = total_blocks * 256;

  // Per-frame unit bound: a coefficient of size s bits costs >= s bits of
  // payload (plus its two symbol codes, >= 0 bits each under a degenerate
  // zero-length-code tree) and emits <= ceil(2^(s-1)/127) units, which
  // peaks at s = 15: 129 units / 15 bits < 8.6 units per payload bit, so
  // units <= 69 * payload bytes; also bounded by 129 units per coefficient
  // slot. Escape + tail units add at most span/65535 + 1 per frame.
  // decode_coeff_*_sparse and sparse_tail additionally enforce the region
  // cap at emit time, so even a stream violating this analysis cannot
  // write out of bounds.
  const int64_t tail_bound = span / 65535 + 1;
  auto frame_bound = [&](int64_t f) {
    return std::min(69 * (int64_t)pkts[f].plen + 8, 129 * span) + tail_bound;
  };

  int nthreads = num_threads > 0 ? num_threads
                                 : (int)std::thread::hardware_concurrency();
  nthreads = std::max(1, std::min<int>(nthreads, frames > 0 ? (int)frames : 1));

  MvBounds16 bounds16;
  if (mv_bounds) widen_mv_bounds(mv_bounds, total_blocks, &bounds16);
  const MvBounds16* b16 = mv_bounds ? &bounds16 : nullptr;

  std::vector<int16_t> mvmax(std::max<int64_t>(frames, 1), 0);
  auto decode_frame = [&](int64_t f, SparseOut& out) -> int64_t {
    const Packet& p = pkts[f];
    ftype[f] = p.ptype;
    out.n = 0;
    out.prev = f * span;
    out.overflow = false;
    int64_t rc = decode_payload_sparse(p.payload, p.plen, p.ptype,
                                       total_blocks, f * span,
                                       bh_out + f * total_blocks, b16,
                                       qidx + f * 3, out, &mvmax[f]);
    if (rc == 0 && !sparse_tail(out, (f + 1) * span)) rc = -3;
    return rc;
  };

  auto report_mvmax = [&]() {
    if (!mv_absmax_out) return;
    int16_t m = 0;
    for (int64_t f = 0; f < frames; f++) m = std::max(m, mvmax[f]);
    *mv_absmax_out = m;
  };

  if (nthreads <= 1 && deltas_out != nullptr) {
    // Sequential fast path: decode each frame directly into the caller's
    // buffers at the running position — no scratch, no zeroing, no copies.
    SparseOut out;
    int64_t pos = 0;
    for (int64_t f = 0; f < frames; f++) {
      out.deltas = deltas_out + pos;
      out.vals = vals_out + pos;
      out.cap = std::min(frame_bound(f), out_cap - pos);
      int64_t rc = decode_frame(f, out);
      if (rc != 0) return out.overflow && pos + frame_bound(f) > out_cap
                              ? (int64_t)-6
                              : rc;
      pos += out.n;
    }
    report_mvmax();
    return pos;
  }

  // Threaded (or count-only) path: per-frame regions carved from one
  // uninitialized allocation, compacted into the output afterwards.
  std::vector<int64_t> fcap(frames + 1, 0);
  for (int64_t f = 0; f < frames; f++)
    fcap[f + 1] = fcap[f] + frame_bound(f);
  std::unique_ptr<uint16_t[]> delta_scratch(new uint16_t[fcap[frames]]);
  std::unique_ptr<int8_t[]> val_scratch(new int8_t[fcap[frames]]);
  std::vector<SparseOut> fout(frames);
  std::atomic<int64_t> next(0);
  std::atomic<int64_t> err(0);
  auto worker = [&]() {
    for (;;) {
      int64_t f = next.fetch_add(1);
      if (f >= frames) return;
      fout[f].deltas = delta_scratch.get() + fcap[f];
      fout[f].vals = val_scratch.get() + fcap[f];
      fout[f].cap = fcap[f + 1] - fcap[f];
      int64_t rc = decode_frame(f, fout[f]);
      if (rc != 0) err.store(rc);
    }
  };
  if (nthreads <= 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    for (int i = 0; i < nthreads; i++) pool.emplace_back(worker);
    for (auto& t : pool) t.join();
  }
  if (err.load() != 0) return err.load();

  int64_t nunits = 0;
  for (auto& o : fout) nunits += o.n;
  report_mvmax();
  if (deltas_out == nullptr) return nunits;
  if (nunits > out_cap) return -6;
  int64_t pos = 0;
  for (int64_t f = 0; f < frames; f++) {
    std::memcpy(deltas_out + pos, fout[f].deltas, fout[f].n * 2);
    std::memcpy(vals_out + pos, fout[f].vals, fout[f].n);
    pos += fout[f].n;
  }
  return nunits;
}

// Expand packed u16 block headers to the three-array form.
void pfv_unpack_block_headers(const uint16_t* bh, int64_t n, int8_t* mvx,
                              int8_t* mvy, uint8_t* has_coeff) {
  unpack_block_headers(bh, n, mvx, mvy, has_coeff);
}

}  // extern "C"

extern "C"
// Count the frames a file will emit (I-frames with payload + P-frames;
// drop frames and unknown packets emit nothing). Returns count or <0.
int64_t pfv_count_frames(const uint8_t* file, int64_t len, int64_t header_off) {
  int64_t off = header_off;
  int64_t frames = 0;
  while (off + 5 <= len) {
    uint8_t ptype = file[off];
    uint32_t plen = (uint32_t)file[off + 1] | (uint32_t)file[off + 2] << 8 |
                    (uint32_t)file[off + 3] << 16 | (uint32_t)file[off + 4] << 24;
    off += 5 + plen;
    if (off > len) return -4;
    if (ptype == 0) break;
    if ((ptype == 1 && plen > 0) || ptype == 2) frames++;
  }
  return frames;
}

// Demux a whole file into dense per-frame tensors, entropy-decoding frame
// payloads in parallel across host threads (each frame owns its Huffman
// table and byte-aligned payload, so frames are independent for entropy —
// the pipelining lever the reference leaves on the table, SURVEY.md §7).
//
// Outputs (caller-allocated, F = frame count from pfv_count_frames):
//   coeffs:    int16[F * total_blocks * 256]
//   mvx, mvy:  int8[F * total_blocks]       (0 for I-frames)
//   has_coeff: uint8[F * total_blocks]      (1 everywhere for I-frames)
//   ftype:     uint8[F]                     (1 = I, 2 = P)
//   qidx:      uint8[F * 3]
// Returns the number of frames demuxed, or negative error.
int64_t pfv_demux_file(const uint8_t* file, int64_t len, int64_t header_off,
                       int64_t total_blocks, int64_t max_frames,
                       int16_t* coeffs, int8_t* mvx, int8_t* mvy,
                       uint8_t* has_coeff, uint8_t* ftype, uint8_t* qidx,
                       int32_t num_threads) {
  struct Packet {
    const uint8_t* payload;
    uint32_t plen;
    uint8_t ptype;
  };
  std::vector<Packet> pkts;
  int64_t off = header_off;
  while (off + 5 <= len) {
    uint8_t pt = file[off];
    uint32_t plen = (uint32_t)file[off + 1] | (uint32_t)file[off + 2] << 8 |
                    (uint32_t)file[off + 3] << 16 | (uint32_t)file[off + 4] << 24;
    if (off + 5 + (int64_t)plen > len) return -4;
    const uint8_t* payload = file + off + 5;
    off += 5 + plen;
    if (pt == 0) break;
    if ((pt == 1 && plen > 0) || pt == 2) pkts.push_back({payload, plen, pt});
    if ((int64_t)pkts.size() >= max_frames) break;
  }
  int64_t frames = (int64_t)pkts.size();

  std::atomic<int64_t> next(0);
  std::atomic<int64_t> err(0);
  auto worker = [&]() {
    for (;;) {
      int64_t f = next.fetch_add(1);
      if (f >= frames) return;
      const Packet& p = pkts[f];
      int16_t* c = coeffs + f * total_blocks * 256;
      int8_t* mx = mvx + f * total_blocks;
      int8_t* my = mvy + f * total_blocks;
      uint8_t* hc = has_coeff + f * total_blocks;
      uint8_t* qi = qidx + f * 3;
      int64_t rc;
      if (p.ptype == 1) {
        ftype[f] = 1;
        std::memset(mx, 0, total_blocks);
        std::memset(my, 0, total_blocks);
        std::memset(hc, 1, total_blocks);
        rc = pfv_decode_iframe_payload(p.payload, p.plen, total_blocks * 4, c, qi);
      } else {
        ftype[f] = 2;
        rc = pfv_decode_pframe_payload(p.payload, p.plen, total_blocks, c, mx,
                                       my, hc, qi);
      }
      if (rc != 0) err.store(rc);
    }
  };

  int nthreads = num_threads > 0 ? num_threads
                                 : (int)std::thread::hardware_concurrency();
  nthreads = std::max(1, std::min<int>(nthreads, (int)frames > 0 ? (int)frames : 1));
  if (nthreads <= 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    for (int i = 0; i < nthreads; i++) pool.emplace_back(worker);
    for (auto& t : pool) t.join();
  }
  if (err.load() != 0) return err.load();
  return frames;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Scalar single-core reference decoder (baseline + differential oracle).
//
// A faithful, independent reimplementation of the reference decode path
// (dec.rs + common.rs + dct.rs) in plain C++, single-threaded. Used to
// (a) anchor the "reference single-core FPS" baseline on this machine (the
// Rust toolchain is unavailable; this mirrors the libpfvdec companion) and
// (b) cross-check the TPU pipeline pixel-for-pixel.
// ---------------------------------------------------------------------------

namespace {

const int32_t DCT_SCALE[64] = {
    32, 37, 34, 26, 32, 26, 34, 37, 37, 43, 39, 31, 37, 31, 39, 43,
    34, 39, 35, 28, 34, 28, 35, 39, 26, 31, 28, 22, 26, 22, 28, 31,
    32, 37, 34, 26, 32, 26, 34, 37, 26, 31, 28, 22, 26, 22, 28, 31,
    34, 39, 35, 28, 34, 28, 35, 39, 37, 43, 39, 31, 37, 31, 39, 43,
};

const int32_t INV_ZIGZAG[64] = {
    0,  1,  5,  6,  14, 15, 27, 28, 2,  4,  7,  13, 16, 26, 29, 42,
    3,  8,  12, 17, 25, 30, 41, 43, 9,  11, 18, 24, 31, 40, 44, 53,
    10, 19, 23, 32, 39, 45, 52, 54, 20, 22, 33, 38, 46, 51, 55, 60,
    21, 34, 37, 47, 50, 56, 59, 61, 35, 36, 48, 49, 57, 58, 62, 63,
};

inline void idct8(int32_t* v, int stride) {
  int32_t c0 = v[0 * stride], d4 = v[1 * stride], c2 = v[2 * stride],
          d6 = v[3 * stride], c1 = v[4 * stride], d5 = v[5 * stride],
          c3 = v[6 * stride], d7 = v[7 * stride];
  int32_t c4 = d4, c5 = d5 + d6, c7 = d5 - d6, c6 = d7;
  int32_t b4 = c4 + c5, b5 = c4 - c5, b6 = c6 + c7, b7 = c6 - c7;
  int32_t b0 = c0 + c1, b1 = c0 - c1;
  int32_t b2 = c2 + c2 / 4 + c3 / 2, b3 = c2 / 2 - c3 - c3 / 4;
  int32_t a4 = b7 / 4 + b4 + b4 / 4 - b4 / 16;
  int32_t a7 = b4 / 4 - b7 - b7 / 4 + b7 / 16;
  int32_t a5 = b5 - b6 + b6 / 4 + b6 / 16;
  int32_t a6 = b6 + b5 - b5 / 4 - b5 / 16;
  int32_t a0 = b0 + b2, a1 = b1 + b3, a2 = b1 - b3, a3 = b0 - b2;
  v[0 * stride] = a0 + a4;
  v[1 * stride] = a1 + a5;
  v[2 * stride] = a2 + a6;
  v[3 * stride] = a3 + a7;
  v[4 * stride] = a3 - a7;
  v[5 * stride] = a2 - a6;
  v[6 * stride] = a1 - a5;
  v[7 * stride] = a0 - a4;
}

// Decode one 8x8 subblock: dequantize (quirk Q1: scale and q indexed by the
// zigzag slot), iDCT columns then rows, (x>>8)+128 clamp (common.rs:313-325).
inline void decode_subblock(const int16_t* zz, const int32_t* q, uint8_t* dst,
                            int dst_stride) {
  int32_t m[64];
  for (int i = 0; i < 64; i++) {
    int32_t idx = INV_ZIGZAG[i];
    m[i] = (int32_t)zz[idx] * DCT_SCALE[idx] * q[idx];
  }
  for (int c = 0; c < 8; c++) idct8(m + c, 8);
  for (int r = 0; r < 8; r++) idct8(m + r * 8, 1);
  for (int r = 0; r < 8; r++)
    for (int c = 0; c < 8; c++) {
      int32_t px = (m[r * 8 + c] >> 8) + 128;
      dst[r * dst_stride + c] = (uint8_t)(px < 0 ? 0 : (px > 255 ? 255 : px));
    }
}

struct RefPlane {
  int w = 0, h = 0;
  std::vector<uint8_t> px;
  void init(int w_, int h_, uint8_t fill) {
    w = w_;
    h = h_;
    px.assign((size_t)w * h, fill);
  }
};

inline int pad16(int x) { return x + (16 - (x % 16)) % 16; }

inline uint16_t rd_u16(const uint8_t* p) { return (uint16_t)(p[0] | p[1] << 8); }
inline uint32_t rd_u32(const uint8_t* p) {
  return (uint32_t)p[0] | (uint32_t)p[1] << 8 | (uint32_t)p[2] << 16 |
         (uint32_t)p[3] << 24;
}

void decode_plane_intra(RefPlane& plane, const int16_t* coeffs,
                        const int32_t* q) {
  int bw = plane.w / 16, bh = plane.h / 16;
  for (int byi = 0; byi < bh; byi++)
    for (int bxi = 0; bxi < bw; bxi++) {
      const int16_t* bc = coeffs + ((size_t)(byi * bw + bxi)) * 256;
      uint8_t* base = plane.px.data() + (size_t)byi * 16 * plane.w + bxi * 16;
      decode_subblock(bc + 0, q, base, plane.w);
      decode_subblock(bc + 64, q, base + 8, plane.w);
      decode_subblock(bc + 128, q, base + 8 * plane.w, plane.w);
      decode_subblock(bc + 192, q, base + 8 * plane.w + 8, plane.w);
    }
}

// Returns false when a stream-supplied motion vector points the 16x16
// prediction window outside the padded plane (the reference panics on the
// same input: Rust slice indexing in common.rs; a C++ read there would be
// an out-of-bounds heap access).
bool decode_plane_delta(RefPlane& plane, const int16_t* coeffs,
                        const int8_t* mvx, const int8_t* mvy,
                        const uint8_t* has_coeff, const int32_t* q,
                        std::vector<uint8_t>& prev_copy) {
  prev_copy.assign(plane.px.begin(), plane.px.end());
  const uint8_t* prev = prev_copy.data();
  int bw = plane.w / 16, bh = plane.h / 16;
  for (int byi = 0; byi < bh; byi++)
    for (int bxi = 0; bxi < bw; bxi++) {
      int b = byi * bw + bxi;
      int sy = byi * 16 + mvy[b];
      int sx = bxi * 16 + mvx[b];
      if (sy < 0 || sy + 16 > plane.h || sx < 0 || sx + 16 > plane.w)
        return false;
      const uint8_t* pred = prev + (size_t)sy * plane.w + sx;
      uint8_t* dst = plane.px.data() + (size_t)byi * 16 * plane.w + bxi * 16;
      if (has_coeff[b]) {
        const int16_t* bc = coeffs + (size_t)b * 256;
        uint8_t res[256];
        decode_subblock(bc + 0, q, res, 16);
        decode_subblock(bc + 64, q, res + 8, 16);
        decode_subblock(bc + 128, q, res + 8 * 16, 16);
        decode_subblock(bc + 192, q, res + 8 * 16 + 8, 16);
        for (int r = 0; r < 16; r++)
          for (int c = 0; c < 16; c++) {
            int32_t d = ((int32_t)res[r * 16 + c] - 128) * 2;
            int32_t p = pred[r * plane.w + c] + d;
            dst[r * plane.w + c] =
                (uint8_t)(p < 0 ? 0 : (p > 255 ? 255 : p));
          }
      } else {
        for (int r = 0; r < 16; r++)
          std::memcpy(dst + (size_t)r * plane.w, pred + (size_t)r * plane.w,
                      16);
      }
    }
  return true;
}

}  // namespace

extern "C" {

// Parse the PFV header. dims_out: [width, height, framerate, num_qtables].
// qtables_out (optional): int32[num_qtables*64] capacity via qtables_cap.
// Returns byte offset of the first packet, or negative error.
int64_t pfv_parse_header(const uint8_t* file, int64_t len, int32_t* dims_out,
                         int32_t* qtables_out, int64_t qtables_cap) {
  static const uint8_t MAGIC[8] = {'P', 'F', 'V', 'I', 'D', 'E', 'O', 0};
  if (len < 8 + 4 + 6 + 2) return -1;
  if (std::memcmp(file, MAGIC, 8) != 0) return -1;
  if (rd_u32(file + 8) != 211) return -2;
  int w = rd_u16(file + 12), h = rd_u16(file + 14), fps = rd_u16(file + 16);
  int nq = rd_u16(file + 18);
  int64_t off = 20;
  if (len < off + (int64_t)nq * 128) return -1;
  dims_out[0] = w;
  dims_out[1] = h;
  dims_out[2] = fps;
  dims_out[3] = nq;
  if (qtables_out) {
    if (qtables_cap < (int64_t)nq * 64) return -3;
    for (int t = 0; t < nq; t++)
      for (int i = 0; i < 64; i++)
        qtables_out[t * 64 + i] = rd_u16(file + off + t * 128 + i * 2);
  }
  return off + (int64_t)nq * 128;
}

// Full single-threaded scalar decode of a .pfv byte buffer. If y/u/v out
// pointers are non-null, each emitted frame's unpadded planes are written
// sequentially (Y: w*h bytes, U/V: (w/2)*(h/2) bytes per frame, up to
// max_frames). Returns the number of frames emitted, or negative error.
int64_t pfv_ref_decode(const uint8_t* file, int64_t len, uint8_t* y_out,
                       uint8_t* u_out, uint8_t* v_out, int64_t max_frames,
                       int32_t* dims_out) {
  int32_t dims[4];
  // size the q-table buffer from the stream's u16 count (dec.rs:96-111
  // keeps them all; no arbitrary cap)
  int64_t off = pfv_parse_header(file, len, dims, nullptr, 0);
  if (off < 0) return off;
  std::vector<int32_t> qtables((size_t)dims[3] * 64);
  off = pfv_parse_header(file, len, dims, qtables.data(),
                         (int64_t)qtables.size());
  if (off < 0) return off;
  int w = dims[0], h = dims[1];
  if (dims_out) std::memcpy(dims_out, dims, sizeof(dims));

  int cw = w / 2, ch = h / 2;
  RefPlane py, pu, pv;
  py.init(pad16(w), pad16(h), 0);
  pu.init(pad16(cw), pad16(ch), 128);
  pv.init(pad16(cw), pad16(ch), 128);

  int yb = (py.w / 16) * (py.h / 16);
  int cb = (pu.w / 16) * (pu.h / 16);
  int64_t total_blocks = yb + 2 * cb;

  std::vector<int16_t> coeffs(total_blocks * 256);
  std::vector<int8_t> mvx(total_blocks), mvy(total_blocks);
  std::vector<uint8_t> has_coeff(total_blocks);
  std::vector<uint8_t> scratch;
  uint8_t qidx[3];

  int64_t frames = 0;
  while (off + 5 <= len) {
    uint8_t ptype = file[off];
    int64_t plen = rd_u32(file + off + 1);
    off += 5;
    if (off + plen > len) return -4;
    const uint8_t* payload = file + off;
    off += plen;

    if (ptype == 0) break;  // EOF
    if (ptype == 1 && plen > 0) {
      if (pfv_decode_iframe_payload(payload, plen, total_blocks * 4,
                                    coeffs.data(), qidx) != 0)
        return -5;
      if (qidx[0] >= dims[3] || qidx[1] >= dims[3] || qidx[2] >= dims[3])
        return -5;
      decode_plane_intra(py, coeffs.data(), &qtables[qidx[0] * 64]);
      decode_plane_intra(pu, coeffs.data() + (size_t)yb * 256,
                         &qtables[qidx[1] * 64]);
      decode_plane_intra(pv, coeffs.data() + (size_t)(yb + cb) * 256,
                         &qtables[qidx[2] * 64]);
    } else if (ptype == 2) {
      if (pfv_decode_pframe_payload(payload, plen, total_blocks,
                                    coeffs.data(), mvx.data(), mvy.data(),
                                    has_coeff.data(), qidx) != 0)
        return -5;
      if (qidx[0] >= dims[3] || qidx[1] >= dims[3] || qidx[2] >= dims[3])
        return -5;
      if (!decode_plane_delta(py, coeffs.data(), mvx.data(), mvy.data(),
                              has_coeff.data(), &qtables[qidx[0] * 64],
                              scratch) ||
          !decode_plane_delta(pu, coeffs.data() + (size_t)yb * 256,
                              mvx.data() + yb, mvy.data() + yb,
                              has_coeff.data() + yb, &qtables[qidx[1] * 64],
                              scratch) ||
          !decode_plane_delta(pv, coeffs.data() + (size_t)(yb + cb) * 256,
                              mvx.data() + yb + cb, mvy.data() + yb + cb,
                              has_coeff.data() + yb + cb,
                              &qtables[qidx[2] * 64], scratch))
        return -5;
    } else if (ptype == 1) {
      // drop frame: keep displaying previous frame, no emit (quirk Q8)
      continue;
    } else {
      continue;  // unknown packet type: skip (dec.rs:216-219)
    }

    if (frames < max_frames && y_out) {
      uint8_t* yo = y_out + (size_t)frames * w * h;
      uint8_t* uo = u_out + (size_t)frames * cw * ch;
      uint8_t* vo = v_out + (size_t)frames * cw * ch;
      for (int r = 0; r < h; r++)
        std::memcpy(yo + (size_t)r * w, py.px.data() + (size_t)r * py.w, w);
      for (int r = 0; r < ch; r++) {
        std::memcpy(uo + (size_t)r * cw, pu.px.data() + (size_t)r * pu.w, cw);
        std::memcpy(vo + (size_t)r * cw, pv.px.data() + (size_t)r * pv.w, cw);
      }
    }
    frames++;
  }
  return frames;
}

}  // extern "C"
