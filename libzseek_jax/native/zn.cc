// libzseek_jax native host runtime.
//
// The reference is a C library end-to-end (SURVEY.md §2: every component is
// native).  Here the *compute* path (match finding, entropy bit-work) runs
// on the accelerator; this module implements the host-side runtime
// work that sits between device calls and the container format, where
// Python-per-block overhead would cap the pipeline:
//
//   * per-block Huffman code construction (length-limited package-merge,
//     zstd canonical value assignment — RFC 8878 §4.2.1)
//   * Huffman tree-description serialization: direct 4-bit weights and
//     FSE-compressed weights, whichever is smaller (§4.2.1.2)
//   * FSE normalized-count computation + table-description serialization
//     (§4.1.1), used by the weight compressor
//   * zstd seekable seek-table (de)serialization
//     (skippable frame 0x184D2A5E, footer magic 0x8F92EAB1 — same layout
//     the reference vendors in /root/reference/src/seek_table.c)
//
// Exposed as a C ABI consumed via ctypes (no pybind11 in this image); the
// Python layer falls back to its own implementations when the .so is absent.
//
// Build: make -C libzseek_jax/native

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// bit writer (LSB-first, BIT_addBits/BIT_closeCStream semantics)
// ---------------------------------------------------------------------------
struct BitWriter {
  std::vector<uint8_t> out;
  uint64_t acc = 0;
  int nacc = 0;
  void add(uint32_t v, int nb) {
    acc |= (uint64_t)(v & ((1u << nb) - 1)) << nacc;
    nacc += nb;
    while (nacc >= 8) {
      out.push_back((uint8_t)acc);
      acc >>= 8;
      nacc -= 8;
    }
  }
  void close_with_sentinel() {
    acc |= (uint64_t)1 << nacc;
    nacc += 1;
    while (nacc > 0) {
      out.push_back((uint8_t)acc);
      acc >>= 8;
      nacc -= 8;
    }
  }
  void flush_partial() {  // byte-align without sentinel
    if (nacc) {
      out.push_back((uint8_t)acc);
      acc = 0;
      nacc = 0;
    }
  }
};

int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

// ---------------------------------------------------------------------------
// package-merge length-limited Huffman (exact optimal under max_bits)
// ---------------------------------------------------------------------------
void package_merge(const uint32_t* hist, int n_sym, int max_bits,
                   int32_t* lengths /*256*/) {
  std::memset(lengths, 0, 256 * sizeof(int32_t));
  std::vector<int> syms;
  for (int s = 0; s < n_sym; ++s)
    if (hist[s]) syms.push_back(s);
  int n = (int)syms.size();
  if (n == 0) return;
  if (n == 1) {
    lengths[syms[0]] = 1;
    return;
  }
  // item = (weight, bitmask-of-symbol-counts) — track per-symbol inclusion
  // counts via a flat count array per item (n small: <=256)
  struct Item {
    uint64_t w;
    std::vector<uint16_t> cnt;  // per-symbol multiplicity
  };
  auto cmp = [](const Item& a, const Item& b) { return a.w < b.w; };
  std::vector<Item> base(n);
  for (int i = 0; i < n; ++i) {
    base[i].w = hist[syms[i]];
    base[i].cnt.assign(n, 0);
    base[i].cnt[i] = 1;
  }
  std::sort(base.begin(), base.end(), cmp);
  // package-merge (Larmore-Hirschberg): list_1 = base; list_j =
  // merge(base, package(list_{j-1})); select 2n-2 cheapest of
  // list_max_bits.  Exactly max_bits-1 package steps — one more would
  // admit codes of length max_bits+1.
  std::vector<Item> lst(base);
  for (int it = 0; it < max_bits - 1; ++it) {
    std::vector<Item> packaged;
    for (size_t k = 0; k + 1 < lst.size(); k += 2) {
      Item x;
      x.w = lst[k].w + lst[k + 1].w;
      x.cnt.assign(n, 0);
      for (int i = 0; i < n; ++i)
        x.cnt[i] = lst[k].cnt[i] + lst[k + 1].cnt[i];
      packaged.push_back(std::move(x));
    }
    std::vector<Item> merged;
    merged.reserve(packaged.size() + base.size());
    std::merge(packaged.begin(), packaged.end(), base.begin(), base.end(),
               std::back_inserter(merged), cmp);
    lst = std::move(merged);
  }
  int take = std::min<int>(2 * (n - 1), (int)lst.size());
  std::vector<uint32_t> lcount(n, 0);
  for (int k = 0; k < take; ++k)
    for (int i = 0; i < n; ++i) lcount[i] += lst[k].cnt[i];
  for (int i = 0; i < n; ++i) lengths[syms[i]] = (int32_t)lcount[i];
}

// zstd canonical code values: longest first, symbol order within a length
void canonical_codes(const int32_t* lengths, int32_t* codes /*256*/,
                     int* max_used_out) {
  int max_used = 0;
  for (int s = 0; s < 256; ++s) max_used = std::max(max_used, (int)lengths[s]);
  std::vector<int> nb_per_rank(max_used + 2, 0);
  for (int s = 0; s < 256; ++s)
    if (lengths[s] > 0) nb_per_rank[lengths[s]]++;
  std::vector<int64_t> val_per_rank(max_used + 2, 0);
  int64_t mn = 0;
  for (int nb = max_used; nb > 0; --nb) {
    val_per_rank[nb] = mn;
    mn += nb_per_rank[nb];
    mn >>= 1;
  }
  std::vector<int64_t> cursor(val_per_rank);
  for (int s = 0; s < 256; ++s) {
    codes[s] = lengths[s] > 0 ? (int32_t)cursor[lengths[s]]++ : 0;
  }
  *max_used_out = max_used;
}

// ---------------------------------------------------------------------------
// FSE (RFC 8878 §4.1): normalization, table build, ncount serialization
// ---------------------------------------------------------------------------
bool normalize_counts(const uint32_t* counts, int n, int table_log,
                      uint64_t total, int32_t* norm) {
  int table_size = 1 << table_log;
  if (total == 0) return false;
  int64_t ssum = 0, n_low = 0;
  for (int i = 0; i < n; ++i) {
    if (!counts[i]) {
      norm[i] = 0;
      continue;
    }
    double scaled = (double)counts[i] * table_size / (double)total;
    int64_t v = std::max<int64_t>(1, (int64_t)(scaled + 0.5));
    bool low = (uint64_t)counts[i] * 3 < (total * 2) / table_size + 1;
    norm[i] = (low && v <= 1) ? -1 : (int32_t)v;
    if (norm[i] > 0) ssum += norm[i];
    else n_low++;
  }
  int64_t diff = table_size - (ssum + n_low);
  if (diff != 0) {
    // adjust the largest entry
    int best = -1;
    for (int i = 0; i < n; ++i)
      if (norm[i] > 0 && (best < 0 || norm[i] > norm[best])) best = i;
    if (best < 0 || norm[best] + diff < 1) return false;
    norm[best] += (int32_t)diff;
  }
  return true;
}

struct FseEnc {
  int table_log;
  std::vector<int32_t> state_table, delta_nb, delta_fs;
};

bool spread_symbols(const int32_t* norm, int n, int table_log,
                    std::vector<int32_t>& table) {
  int table_size = 1 << table_log;
  table.assign(table_size, 0);
  int high = table_size - 1;
  for (int s = 0; s < n; ++s)
    if (norm[s] == -1) table[high--] = s;
  int step = (table_size >> 1) + (table_size >> 3) + 3;
  int mask = table_size - 1;
  int pos = 0;
  for (int s = 0; s < n; ++s) {
    for (int c = 0; c < norm[s]; ++c) {
      table[pos] = s;
      pos = (pos + step) & mask;
      while (pos > high) pos = (pos + step) & mask;
    }
  }
  return pos == 0;
}

bool build_fse_enc(const int32_t* norm, int n, int table_log, FseEnc& et) {
  int table_size = 1 << table_log;
  std::vector<int32_t> spread;
  if (!spread_symbols(norm, n, table_log, spread)) return false;
  std::vector<int32_t> cumul(n + 1, 0);
  int acc = 0;
  for (int s = 0; s < n; ++s) {
    cumul[s] = acc;
    acc += norm[s] == -1 ? 1 : std::max(0, (int)norm[s]);
  }
  cumul[n] = acc;
  et.table_log = table_log;
  et.state_table.assign(table_size, 0);
  std::vector<int32_t> cursor(cumul);
  for (int u = 0; u < table_size; ++u)
    et.state_table[cursor[spread[u]]++] = table_size + u;
  et.delta_nb.assign(n, 0);
  et.delta_fs.assign(n, 0);
  int total = 0;
  for (int s = 0; s < n; ++s) {
    int c = norm[s];
    if (c == 0) {
      et.delta_nb[s] = ((table_log + 1) << 16) - table_size;
      et.delta_fs[s] = 0;
    } else if (c == -1 || c == 1) {
      et.delta_nb[s] = (table_log << 16) - table_size;
      et.delta_fs[s] = total - 1;
      total += 1;
    } else {
      int max_bits_out = table_log - highbit(c - 1);
      int min_state_plus = c << max_bits_out;
      et.delta_nb[s] = (max_bits_out << 16) - min_state_plus;
      et.delta_fs[s] = total - c;
      total += c;
    }
  }
  return true;
}

int fse_init_state(const FseEnc& et, int sym) {
  int nb = (et.delta_nb[sym] + (1 << 15)) >> 16;
  int v = (nb << 16) - et.delta_nb[sym];
  return et.state_table[(v >> nb) + et.delta_fs[sym]];
}

void write_ncount(const int32_t* norm, int n, int table_log, BitWriter& bw) {
  bw.add(table_log - 5, 4);
  int remaining = (1 << table_log) + 1;
  int i = 0;
  while (remaining > 1 && i < n) {
    int c = norm[i++];
    int threshold = 1 << highbit(remaining);
    int nb = highbit(remaining) + 1;
    int mx = (1 << nb) - 1 - remaining;
    int value = c + 1;
    if (value >= threshold) value += mx;
    bw.add(value, value < mx ? nb - 1 : nb);
    remaining -= c == -1 ? 1 : (c < 0 ? -c : c);
    if (c == 0) {
      int zeros = 0;
      while (i + zeros < n && norm[i + zeros] == 0) zeros++;
      while (zeros >= 3) {
        bw.add(3, 2);
        zeros -= 3;
        i += 3;
      }
      bw.add(zeros, 2);
      i += zeros;
    }
  }
}

// FSE-compressed huffman weights (2 interleaved states, encoded backward)
bool write_weights_fse(const uint8_t* weights, int n,
                       std::vector<uint8_t>& out) {
  if (n < 2) return false;
  uint32_t counts[16] = {0};
  int max_sym = 0;
  for (int i = 0; i < n; ++i) {
    counts[weights[i]]++;
    max_sym = std::max(max_sym, (int)weights[i]);
  }
  int nz = 0;
  for (int v = 0; v <= max_sym; ++v) nz += counts[v] != 0;
  if (nz < 2) return false;
  int table_log = std::min(6, std::max(1, highbit((uint32_t)std::max(2, n)) +
                                              ((n & (n - 1)) ? 1 : 0)));
  int32_t norm[16];
  if (!normalize_counts(counts, max_sym + 1, table_log, n, norm)) return false;
  FseEnc et;
  if (!build_fse_enc(norm, max_sym + 1, table_log, et)) return false;
  BitWriter desc;
  write_ncount(norm, max_sym + 1, table_log, desc);
  desc.flush_partial();
  BitWriter bw;
  // symbol k decodes from state1 iff k is even; encoding runs backward from
  // k = n-3, so the state inits and starting turn depend on n's parity
  int s1, s2, turn;
  if (n % 2) {
    s1 = fse_init_state(et, weights[n - 1]);
    s2 = fse_init_state(et, weights[n - 2]);
    turn = 0;
  } else {
    s2 = fse_init_state(et, weights[n - 1]);
    s1 = fse_init_state(et, weights[n - 2]);
    turn = 1;
  }
  for (int i = n - 3; i >= 0; --i) {
    int sym = weights[i];
    int& st = turn == 0 ? s1 : s2;
    int nb = (st + et.delta_nb[sym]) >> 16;
    bw.add(st & ((1 << nb) - 1), nb);
    st = et.state_table[(st >> nb) + et.delta_fs[sym]];
    turn ^= 1;
  }
  int ts = 1 << table_log;
  bw.add(s2 >= ts ? s2 - ts : s2, table_log);
  bw.add(s1 >= ts ? s1 - ts : s1, table_log);
  bw.close_with_sentinel();
  size_t total = desc.out.size() + bw.out.size();
  if (total >= 128) return false;
  out.clear();
  out.push_back((uint8_t)total);
  out.insert(out.end(), desc.out.begin(), desc.out.end());
  out.insert(out.end(), bw.out.begin(), bw.out.end());
  return true;
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------
extern "C" {

// Build the zstd literal Huffman table for one histogram.
//   hist:      uint32[256]
//   lengths:   int32[256]   out (0 = unused)
//   codes:     int32[256]   out (canonical values)
//   tree:      uint8[200]   out (serialized tree description)
//   tree_len:  int32*       out
// Returns max_bits (>0) on success, 0 if the table is degenerate (<2 syms),
// -1 if the tree description cannot be serialized.
int zn_huf_build(const uint32_t* hist, int32_t* lengths, int32_t* codes,
                 uint8_t* tree, int32_t* tree_len) {
  package_merge(hist, 256, 11, lengths);
  int n_used = 0, last = -1;
  for (int s = 0; s < 256; ++s)
    if (lengths[s] > 0) {
      n_used++;
      last = s;
    }
  if (n_used < 2) return 0;
  int max_bits = 0;
  canonical_codes(lengths, codes, &max_bits);
  // weights: maxBits + 1 - length, last symbol implied
  std::vector<uint8_t> weights(last);
  for (int s = 0; s < last; ++s)
    weights[s] = lengths[s] > 0 ? (uint8_t)(max_bits + 1 - lengths[s]) : 0;
  std::vector<uint8_t> fsec;
  bool have_fse = write_weights_fse(weights.data(), (int)weights.size(), fsec);
  // direct: header 127+num, 4-bit nibbles
  std::vector<uint8_t> direct;
  if ((int)weights.size() <= 127) {
    direct.push_back((uint8_t)(127 + weights.size()));
    for (size_t i = 0; i < weights.size(); i += 2) {
      uint8_t hi = weights[i] << 4;
      uint8_t lo = i + 1 < weights.size() ? weights[i + 1] : 0;
      direct.push_back(hi | lo);
    }
  }
  const std::vector<uint8_t>* best = nullptr;
  if (have_fse && (!direct.size() || fsec.size() < direct.size()))
    best = &fsec;
  else if (direct.size())
    best = &direct;
  if (!best) return -1;
  if (best->size() > 200) return -1;
  std::memcpy(tree, best->data(), best->size());
  *tree_len = (int32_t)best->size();
  return max_bits;
}

// Batched variant: nh histograms in a row-major (nh, 256) array.
// outputs: lengths/codes (nh, 256), trees (nh, 200), tree_lens (nh),
// max_bits (nh).  Hot path of ZstdCodec._finish_blocks.
void zn_huf_build_batch(const uint32_t* hists, int nh, int32_t* lengths,
                        int32_t* codes, uint8_t* trees, int32_t* tree_lens,
                        int32_t* max_bits) {
  for (int i = 0; i < nh; ++i) {
    max_bits[i] = zn_huf_build(hists + 256 * i, lengths + 256 * i,
                               codes + 256 * i, trees + 200 * i,
                               tree_lens + i);
  }
}

// XXH64 (zstd seekable per-frame checksum = low 32 bits over the
// uncompressed frame; also zstd's optional content checksum)
uint64_t zn_xxh64(const uint8_t* p, int64_t n, uint64_t seed) {
  const uint64_t P1 = 0x9E3779B185EBCA87ULL, P2 = 0xC2B2AE3D27D4EB4FULL,
                 P3 = 0x165667B19E3779F9ULL, P4 = 0x85EBCA77C2B2AE63ULL,
                 P5 = 0x27D4EB2F165667C5ULL;
  auto rotl = [](uint64_t x, int r) { return (x << r) | (x >> (64 - r)); };
  auto rd64 = [](const uint8_t* q) {
    uint64_t v;
    std::memcpy(&v, q, 8);
    return v;
  };
  auto round = [&](uint64_t acc, uint64_t lane) {
    return rotl(acc + lane * P2, 31) * P1;
  };
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    const uint8_t* lim = end - 32;
    do {
      v1 = round(v1, rd64(p));
      v2 = round(v2, rd64(p + 8));
      v3 = round(v3, rd64(p + 16));
      v4 = round(v4, rd64(p + 24));
      p += 32;
    } while (p <= lim);
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = (h ^ round(0, v1)) * P1 + P4;
    h = (h ^ round(0, v2)) * P1 + P4;
    h = (h ^ round(0, v3)) * P1 + P4;
    h = (h ^ round(0, v4)) * P1 + P4;
  } else {
    h = seed + P5;
  }
  h += (uint64_t)n;
  while (p + 8 <= end) {
    h = rotl(h ^ round(0, rd64(p)), 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    uint32_t v;
    std::memcpy(&v, p, 4);
    h = rotl(h ^ ((uint64_t)v * P1), 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h = rotl(h ^ ((uint64_t)*p * P5), 11) * P1;
    ++p;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// ---------------------------------------------------------------------------
// zstd seekable seek table (layout per /root/reference/src/seek_table.c)
// ---------------------------------------------------------------------------

// Serialize: entries (n, 2) uint32 row-major (c_size, d_size) -> out buffer.
// Returns bytes written.  out must hold 8 + 8n + 9 bytes (no checksums).
int64_t zn_seektable_serialize(const uint32_t* entries, int64_t n,
                               uint8_t* out) {
  uint8_t* p = out;
  uint32_t magic = 0x184D2A5E;
  uint32_t frame_size = (uint32_t)(n * 8 + 9);
  std::memcpy(p, &magic, 4);
  p += 4;
  std::memcpy(p, &frame_size, 4);
  p += 4;
  for (int64_t i = 0; i < n; ++i) {
    std::memcpy(p, entries + 2 * i, 8);
    p += 8;
  }
  uint32_t nf = (uint32_t)n;
  std::memcpy(p, &nf, 4);
  p += 4;
  *p++ = 0;  // seek-table descriptor: no checksums
  uint32_t foot = 0x8F92EAB1;
  std::memcpy(p, &foot, 4);
  p += 4;
  return p - out;
}

// Parse: buf = last (9 + 8n [+4n]) bytes ending at the footer.  Fills
// cum (n+1, 2) int64 cumulative (c_off, d_off) pairs.  Returns n or -1.
int64_t zn_seektable_parse(const uint8_t* table_frame, int64_t frame_bytes,
                           int64_t* cum) {
  if (frame_bytes < 17) return -1;
  const uint8_t* foot = table_frame + frame_bytes - 9;
  uint32_t magic;
  std::memcpy(&magic, foot + 5, 4);
  if (magic != 0x8F92EAB1) return -1;
  uint32_t nf;
  std::memcpy(&nf, foot, 4);
  uint8_t desc = foot[4];
  if (desc & 0x7C) return -1;  // reserved bits
  int entry = (desc & 0x80) ? 12 : 8;
  if (frame_bytes < 8 + (int64_t)entry * nf + 9) return -1;
  const uint8_t* e = table_frame + 8;
  int64_t c = 0, d = 0;
  for (uint32_t i = 0; i < nf; ++i) {
    cum[2 * i] = c;
    cum[2 * i + 1] = d;
    uint32_t cs, ds;
    std::memcpy(&cs, e, 4);
    std::memcpy(&ds, e + 4, 4);
    e += entry;
    c += cs;
    d += ds;
  }
  cum[2 * nf] = c;
  cum[2 * nf + 1] = d;
  return nf;
}

// ---------------------------------------------------------------------------
// LZ4 block decode into a frame buffer (linked-block window: matches may
// reach back to byte `lo` of `out`, i.e. the frame start for linked
// frames or the block start for independent ones).  LZ4 has no entropy
// stage — decode is pure token-driven memcpy, so the host-side expansion
// of the compressed bytes (which the host already holds) beats any
// device round trip; the device decoder remains the device-resident path.
// Returns decompressed size or -1 on corrupt input.
int64_t zn_lz4_decode(const uint8_t* src, int64_t n, uint8_t* out,
                      int64_t out_cap, int64_t base, int64_t lo) {
  int64_t ip = 0, op = base;
  while (ip < n) {
    uint8_t tok = src[ip++];
    int64_t ll = tok >> 4;
    if (ll == 15) {
      uint8_t b;
      do {
        if (ip >= n) return -1;
        b = src[ip++];
        ll += b;
      } while (b == 255);
    }
    if (ip + ll > n || op + ll > out_cap) return -1;
    std::memcpy(out + op, src + ip, (size_t)ll);
    ip += ll;
    op += ll;
    if (ip >= n) break;  // final literal run
    if (ip + 2 > n) return -1;
    int64_t off = src[ip] | ((int64_t)src[ip + 1] << 8);
    ip += 2;
    if (off < 1 || off > op - lo) return -1;
    int64_t ml = (tok & 15) + 4;
    if ((tok & 15) == 15) {
      uint8_t b;
      do {
        if (ip >= n) return -1;
        b = src[ip++];
        ml += b;
      } while (b == 255);
    }
    if (op + ml > out_cap) return -1;
    int64_t seed = off < ml ? off : ml;
    std::memcpy(out + op, out + op - off, (size_t)seed);
    int64_t c = seed;
    while (c < ml) {
      int64_t k = c < ml - c ? c : ml - c;
      std::memcpy(out + op + c, out + op, (size_t)k);
      c += k;
    }
    op += ml;
  }
  return op - base;
}

// ---------------------------------------------------------------------------
// Long-distance match scan (the zstd --long / LDM analog).  The device
// parse sees only its own 128 KiB block; this host pass
// finds WHOLE-BLOCK matches at larger distances within a batch: rolling
// 32-byte window hashes at stride 8 feed a last-occurrence table, then
// per-block candidate distances are verified with exact memcmp — a hit
// means block b is byte-identical to the bytes `dist` before it.
// Covered blocks compress to a single long-match sequence and skip the
// device parse entirely.  x = the batch's blocks concatenated at bsize
// stride; frame_base[b] = byte offset of b's frame start (-1 = exclude).
// Returns the number of covered blocks.
int64_t zn_ldm_scan(const uint8_t* x, int64_t nblocks, int64_t bsize,
                    const int64_t* frame_base, const int32_t* lens,
                    int64_t min_dist, int64_t* out_dist) {
  const int LOG = 20;
  const uint64_t MUL = 0x9E3779B185EBCA87ull;
  std::vector<int64_t> table((size_t)1 << LOG, -1);
  // second, always-overwrite table: surfaces SMALL distances (below
  // min_dist) for whole-block coverage of short-period content.  The
  // device parse would find those matches itself, but each one costs a
  // ~block-length scalar extend on the core; covering the block here
  // (and skipping its parse) emits the identical single sequence free.
  std::vector<int64_t> table2((size_t)1 << LOG, -1);
  const int CAND = 4;
  std::vector<int64_t> cand((size_t)nblocks * CAND, 0);
  std::vector<int64_t> cand2((size_t)nblocks, 0);
  // rolling polynomial hash over a 32-byte window; CONTENT-DEFINED
  // anchors (hash-selected 1-in-64 positions) so repeated content anchors
  // at the same content offsets regardless of block alignment — a fixed
  // sampling stride could only ever find distances divisible by it
  const uint64_t C = 6364136223846793005ull;
  uint64_t C32 = 1;
  for (int i = 0; i < 32; ++i) C32 *= C;
  for (int64_t b = 0; b < nblocks; ++b) {
    out_dist[b] = 0;
    int64_t base = b * bsize;
    int64_t len = lens[b];
    if (len < 32) continue;
    uint64_t h = 0;
    for (int k = 0; k < 32; ++k) h = h * C + x[base + k];
    for (int64_t off = 0; off + 32 <= len; ++off) {
      int64_t p = base + off;
      uint64_t mixed = h * MUL;
      if ((mixed >> 58) == 0) {  // anchor (rate 1/64)
        size_t bucket = (size_t)(mixed >> 30) & (((size_t)1 << LOG) - 1);
        int64_t c = table[bucket];
        // age-gated overwrite: keep an entry until it is >= min_dist old,
        // otherwise content with a repeat period below min_dist keeps
        // refreshing the bucket and multi-period distances (the ones the
        // block parse cannot see) never surface
        if (c < 0 || p - c >= min_dist) table[bucket] = p;
        int64_t c2 = table2[bucket];
        table2[bucket] = p;
        if (c2 >= 0 && frame_base[b] >= 0 && cand2[b] == 0) {
          int64_t d2 = p - c2;
          if (d2 >= 1 && d2 < min_dist && c2 >= frame_base[b])
            cand2[b] = d2;
        }
        if (c >= 0 && frame_base[b] >= 0) {
          int64_t d = p - c;
          if (d >= min_dist && d <= ((int64_t)1 << 28) - 1 &&
              c >= frame_base[b]) {
            for (int k = 0; k < CAND; ++k) {
              if (cand[b * CAND + k] == d) break;
              if (cand[b * CAND + k] == 0) {
                cand[b * CAND + k] = d;
                break;
              }
            }
          }
        }
      }
      if (off + 33 <= len) h = h * C + x[p + 32] - C32 * x[p];
    }
  }
  // verify: out_dist is (nblocks, 3) rows [dist, span_start, span_end).
  // Full-block hits get [d, 0, bsize); otherwise the longest contiguous
  // matching run at distance d is accepted when it covers >= 1/4 of the
  // block (partial coverage: the boundary blocks of unaligned repeat
  // periods), with the head/tail bytes left as literals.
  int64_t hits = 0;
  for (int64_t b = 0; b < nblocks; ++b) {
    out_dist[3 * b] = 0;
    out_dist[3 * b + 1] = 0;
    out_dist[3 * b + 2] = 0;
    if (frame_base[b] < 0) continue;
    int64_t base = b * bsize;
    int64_t blen = lens[b];
    int64_t best_len = bsize / 4, best_d = 0, best_s = 0, best_e = 0;
    // small-distance whole-block coverage (short-period content): the
    // parse would emit the same single sequence, at ~block-length scalar
    // extend cost on the device.  Also applies to a frame's shorter
    // FINAL block (lens < bsize), which the distance-gated path below
    // never covers.
    if (cand2[b] > 0 && blen >= 512) {
      int64_t d = cand2[b];
      int64_t lo = frame_base[b] + d - base;
      if (lo <= 0 && std::memcmp(x + base, x + base - d, 256) == 0 &&
          std::memcmp(x + base, x + base - d, (size_t)blen) == 0) {
        out_dist[3 * b] = d;
        out_dist[3 * b + 1] = 0;
        out_dist[3 * b + 2] = blen;
        ++hits;
        continue;
      }
    }
    if (blen != bsize) continue;
    for (int k = 0; k < CAND && cand[b * CAND + k]; ++k) {
      int64_t d = cand[b * CAND + k];
      int64_t lo = frame_base[b] + d - base;  // first in-frame src posn
      if (lo < 0) lo = 0;
      if (lo >= bsize) continue;
      if (lo == 0 && std::memcmp(x + base, x + base - d, 256) == 0 &&
          std::memcmp(x + base, x + base - d, (size_t)bsize) == 0) {
        best_d = d;
        best_s = 0;
        best_e = bsize;
        break;
      }
      // PARTIAL spans only for distances beyond the block parse's whole
      // window (prev block + current = 2*bsize): closer matches are
      // found fine-grained by the parse itself, and replacing its output
      // with span-head/tail literals would LOSE ratio
      if (d < 2 * bsize) continue;
      // longest matching run [s, e) at distance d
      int64_t run = 0;
      for (int64_t i = lo; i < bsize; ++i) {
        if (x[base + i] == x[base + i - d]) {
          ++run;
          if (run > best_len) {
            best_len = run;
            best_d = d;
            best_s = i + 1 - run;
            best_e = i + 1;
          }
        } else {
          run = 0;
        }
      }
    }
    if (best_d) {
      out_dist[3 * b] = best_d;
      out_dist[3 * b + 1] = best_s;
      out_dist[3 * b + 2] = best_e;
      ++hits;
    }
  }
  return hits;
}

}  // extern "C"
