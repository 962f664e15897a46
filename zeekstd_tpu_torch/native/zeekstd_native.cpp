// zeekstd_tpu native runtime: zstd frame codec + XXH64 + threaded frame pool.
//
// This is the host-native execution backend of the framework (the reference
// delegates the same role to libzstd, SURVEY §2.3; here it is implemented
// from scratch against RFC 8878). The seekable framing layer stays in
// Python; this library provides per-frame compress/decompress with a C ABI
// plus multi-threaded whole-stream helpers that exploit the seekable
// format's frame independence.
//
// Algorithms intentionally mirror zeekstd_tpu/codec/*.py (the bit-exact
// reference implementation tested against libzstd); both are validated by
// the same oracle test suite.
//
// Build: g++ -O3 -march=native -shared -fPIC -pthread -o libzeekstd_native.so

#include <cstdio>
#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <vector>
#include <thread>
#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstddef>

typedef uint8_t u8;
typedef uint16_t u16;
typedef uint32_t u32;
typedef uint64_t u64;
typedef int32_t i32;
typedef int64_t i64;
typedef int16_t i16;

static inline int highbit(u32 v) { return 31 - __builtin_clz(v); }

// ---------------------------------------------------------------- XXH64 ---

static const u64 P1 = 0x9E3779B185EBCA87ULL, P2 = 0xC2B2AE3D27D4EB4FULL,
                 P3 = 0x165667B19E3779F9ULL, P4 = 0x85EBCA77C2B2AE63ULL,
                 P5 = 0x27D4EB2F165667C5ULL;

static inline u64 rotl64(u64 x, int r) { return (x << r) | (x >> (64 - r)); }
static inline u64 xxh_round(u64 acc, u64 lane) {
  return rotl64(acc + lane * P2, 31) * P1;
}
static inline u64 xxh_merge(u64 acc, u64 val) {
  return (acc ^ xxh_round(0, val)) * P1 + P4;
}
static inline u64 read64(const u8* p) { u64 v; memcpy(&v, p, 8); return v; }
static inline u32 read32(const u8* p) { u32 v; memcpy(&v, p, 4); return v; }

extern "C" u64 zn_xxh64(const void* data, size_t len, u64 seed) {
  const u8* p = (const u8*)data;
  const u8* end = p + len;
  u64 acc;
  if (len >= 32) {
    u64 a1 = seed + P1 + P2, a2 = seed + P2, a3 = seed, a4 = seed - P1;
    const u8* limit = end - 32;
    do {
      a1 = xxh_round(a1, read64(p));
      a2 = xxh_round(a2, read64(p + 8));
      a3 = xxh_round(a3, read64(p + 16));
      a4 = xxh_round(a4, read64(p + 24));
      p += 32;
    } while (p <= limit);
    acc = rotl64(a1, 1) + rotl64(a2, 7) + rotl64(a3, 12) + rotl64(a4, 18);
    acc = xxh_merge(acc, a1); acc = xxh_merge(acc, a2);
    acc = xxh_merge(acc, a3); acc = xxh_merge(acc, a4);
  } else {
    acc = seed + P5;
  }
  acc += (u64)len;
  while (p + 8 <= end) {
    acc ^= xxh_round(0, read64(p));
    acc = rotl64(acc, 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    acc ^= (u64)read32(p) * P1;
    acc = rotl64(acc, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    acc ^= (u64)(*p++) * P5;
    acc = rotl64(acc, 11) * P1;
  }
  acc ^= acc >> 33; acc *= P2; acc ^= acc >> 29; acc *= P3; acc ^= acc >> 32;
  return acc;
}

// ----------------------------------------------------------- bitstreams ---

struct BitWriter {
  u64 acc = 0;
  int nbits = 0;
  std::vector<u8>* out;
  explicit BitWriter(std::vector<u8>* o) : out(o) {}
  inline void add(u32 value, int n) {
    acc |= ((u64)value & ((n >= 32) ? 0xFFFFFFFFULL : ((1ULL << n) - 1))) << nbits;
    nbits += n;
    if (nbits >= 32) {  // flush four bytes at once
      size_t pos = out->size();
      out->resize(pos + 4);
      u32 lo = (u32)acc;
      memcpy(out->data() + pos, &lo, 4);
      acc >>= 32;
      nbits -= 32;
    }
  }
  inline void flush_bytes() {
    while (nbits >= 8) { out->push_back((u8)acc); acc >>= 8; nbits -= 8; }
  }
  // fused write of up to 63 bits (value already masked by caller). Split
  // into two <=32-bit adds: a single `acc |= value << nbits` would drop
  // high bits whenever n + nbits > 64 (seen with large ll+ml+offset
  // extras fused into one 40+ bit write).
  inline void add_wide(u64 value, int n) {
    if (n <= 32) { add((u32)value, n); return; }
    add((u32)value, 32);
    add((u32)(value >> 32), n - 32);
  }
  inline void finish() {  // sentinel + byte align
    add(1, 1);
    flush_bytes();
    if (nbits) { out->push_back((u8)acc); acc = 0; nbits = 0; }
  }
  inline void align_no_sentinel() {
    flush_bytes();
    if (nbits) { out->push_back((u8)acc); acc = 0; nbits = 0; }
  }
};

// Raw-pointer bit writer for the hot emit loops: the caller reserves
// worst-case capacity once, so flushes are a plain 4-byte store instead
// of a vector resize per 32 bits (measured ~15% of L1 encode time).
struct RawBitWriter {
  u64 acc = 0;
  int nbits = 0;
  u8* p;
  explicit RawBitWriter(u8* dst) : p(dst) {}
  inline void add(u32 value, int n) {
    acc |= ((u64)value & ((n >= 32) ? 0xFFFFFFFFULL : ((1ULL << n) - 1)))
           << nbits;
    nbits += n;
    if (nbits >= 32) {
      u32 lo = (u32)acc;
      memcpy(p, &lo, 4);
      p += 4;
      acc >>= 32;
      nbits -= 32;
    }
  }
  inline void add_wide(u64 value, int n) {
    if (n <= 32) { add((u32)value, n); return; }
    add((u32)value, 32);
    add((u32)(value >> 32), n - 32);
  }
  inline u8* finish() {  // sentinel + byte align; returns one-past-end
    add(1, 1);
    while (nbits > 0) { *p++ = (u8)acc; acc >>= 8; nbits -= 8; }
    return p;
  }
};

// Backward bit reader over [start, end): last byte holds the sentinel.
struct BitReaderBack {
  const u8* start;
  size_t len;
  i64 rem;  // payload bits remaining
  bool ok = true;
  BitReaderBack(const u8* s, size_t n) : start(s), len(n) {
    if (!n || s[n - 1] == 0) { ok = false; rem = 0; return; }
    rem = (i64)(n - 1) * 8 + highbit(s[n - 1]);
  }
  // 8-byte little-endian window at byte offset, clamped to the slice: the
  // stream may sit at the very end of the caller's buffer, so an
  // unconditional 8-byte load could read past it.
  inline u64 window_at(size_t byt) const {
    u64 w = 0;
    size_t take = len - byt;
    if (take >= 8) { memcpy(&w, start + byt, 8); }
    else { memcpy(&w, start + byt, take); }
    return w;
  }
  inline u32 read(int n) {
    rem -= n;
    if (n == 0) return 0;
    i64 lo = rem;
    if (lo >= 0) {
      u64 window = window_at((size_t)(lo >> 3));
      return (u32)((window >> (lo & 7)) & ((n >= 32) ? 0xFFFFFFFFULL : ((1ULL << n) - 1)));
    }
    i64 avail = n + lo;
    if (avail <= 0) return 0;
    u64 window = window_at(0);
    return (u32)((window & ((1ULL << avail) - 1)) << (-lo));
  }
  // One load for a group of consecutive reads (n <= 56); first-read value
  // lands in the TOP bits, matching sequential read() order.
  inline u64 read_wide(int n) {
    rem -= n;
    if (n == 0) return 0;
    i64 lo = rem;
    if (lo >= 0) {
      u64 window = window_at((size_t)(lo >> 3));
      return (window >> (lo & 7)) & ((1ULL << n) - 1);
    }
    i64 avail = n + lo;
    if (avail <= 0) return 0;
    u64 window = window_at(0);
    return (window & ((1ULL << avail) - 1)) << (-lo);
  }
};

// Forward LSB-first reader (FSE table descriptions).
struct BitReaderFwd {
  const u8* data;
  size_t len;
  size_t bitpos = 0;
  BitReaderFwd(const u8* d, size_t l) : data(d), len(l) {}
  inline u32 peek(int n) {
    u64 window = 0;
    size_t byte0 = bitpos >> 3;
    size_t take = len - byte0 < 8 ? len - byte0 : 8;
    if (byte0 < len) memcpy(&window, data + byte0, take);
    return (u32)((window >> (bitpos & 7)) & ((1ULL << n) - 1));
  }
  inline u32 read(int n) { u32 v = peek(n); bitpos += n; return v; }
  size_t bytes_consumed() const { return (bitpos + 7) >> 3; }
};

// ------------------------------------------------------------------ FSE ---

struct FseDecTable {
  int log = 0;
  u8 symbol[512];
  u8 nbits[512];
  u16 baseline[512];
  // Hot-loop form: symbol | nbits<<8 | baseline<<16 in one load.
  u32 packed[512];
  // Sequence-decode form (ll/ml tables only; filled by fill_packed2):
  // value_base | extra_bits<<20 | state_bits<<26 | state_base<<34.
  // One load replaces packed + the LL_BB/ML_BB indirection.
  u64 packed2[512];
};

struct FseEncTable {
  int log = 0;
  i32 delta_nb[64];
  i32 delta_fs[64];
  u16 state_table[512];
  i16 norm[64];
  int max_sym = 0;
};

static bool fse_build_dec(const i16* norm, int nsym, int log, FseDecTable* t) {
  int size = 1 << log;
  if (size > 512) return false;
  t->log = log;
  i32 sym_next[64];
  int high = size - 1;
  for (int s = 0; s < nsym; s++) {
    if (norm[s] == -1) { t->symbol[high--] = (u8)s; sym_next[s] = 1; }
    else sym_next[s] = norm[s];
  }
  int step = (size >> 1) + (size >> 3) + 3, mask = size - 1, pos = 0;
  for (int s = 0; s < nsym; s++) {
    for (int i = 0; i < norm[s]; i++) {
      t->symbol[pos] = (u8)s;
      pos = (pos + step) & mask;
      while (pos > high) pos = (pos + step) & mask;
    }
  }
  if (pos != 0) return false;
  for (int u = 0; u < size; u++) {
    int s = t->symbol[u];
    int next = sym_next[s]++;
    int bits = log - highbit((u32)next);
    t->nbits[u] = (u8)bits;
    t->baseline[u] = (u16)((next << bits) - size);
    t->packed[u] = (u32)s | ((u32)bits << 8) | ((u32)t->baseline[u] << 16);
  }
  return true;
}

static bool fse_build_enc(const i16* norm, int nsym, int log, FseEncTable* t) {
  int size = 1 << log;
  if (size > 512 || nsym > 64) return false;
  t->log = log; t->max_sym = nsym - 1;
  memcpy(t->norm, norm, nsym * sizeof(i16));
  u8 table_symbol[512];
  int high = size - 1;
  for (int s = 0; s < nsym; s++)
    if (norm[s] == -1) table_symbol[high--] = (u8)s;
  int step = (size >> 1) + (size >> 3) + 3, mask = size - 1, pos = 0;
  for (int s = 0; s < nsym; s++)
    for (int i = 0; i < norm[s]; i++) {
      table_symbol[pos] = (u8)s;
      pos = (pos + step) & mask;
      while (pos > high) pos = (pos + step) & mask;
    }
  if (pos != 0) return false;
  int cumul[65];
  cumul[0] = 0;
  for (int s = 0; s < nsym; s++)
    cumul[s + 1] = cumul[s] + (norm[s] == -1 ? 1 : norm[s]);
  int fill[64];
  memcpy(fill, cumul, nsym * sizeof(int));
  for (int position = 0; position < size; position++) {
    int s = table_symbol[position];
    t->state_table[fill[s]++] = (u16)(position + size);
  }
  int total = 0;
  for (int s = 0; s < nsym; s++) {
    if (norm[s] == 0) {
      t->delta_nb[s] = ((log + 1) << 16) - size;
    } else if (norm[s] == 1 || norm[s] == -1) {
      t->delta_nb[s] = (log << 16) - size;
      t->delta_fs[s] = total - 1;
      total += 1;
    } else {
      int max_bits = log - highbit((u32)(norm[s] - 1));
      int min_state_plus = norm[s] << max_bits;
      t->delta_nb[s] = (max_bits << 16) - min_state_plus;
      t->delta_fs[s] = total - norm[s];
      total += norm[s];
    }
  }
  return true;
}

struct FseEncState {
  i32 state;
  const FseEncTable* t;
  inline void init(const FseEncTable* tab, int sym) {
    t = tab;
    int nb = (t->delta_nb[sym] + (1 << 15)) >> 16;
    i32 value = (nb << 16) - t->delta_nb[sym];
    state = t->state_table[(value >> nb) + t->delta_fs[sym]];
  }
  inline void encode(BitWriter& bw, int sym) {
    int nb = (state + t->delta_nb[sym]) >> 16;
    bw.add((u32)state, nb);
    state = t->state_table[(state >> nb) + t->delta_fs[sym]];
  }
  // Compute this step's (bits, nbits) without writing (lets the caller
  // fuse several streams' state bits into one wide write).
  inline u64 step(int sym, int* nb_out) {
    int nb = (state + t->delta_nb[sym]) >> 16;
    u64 bits = (u64)(u32)state & ((1ULL << nb) - 1);
    state = t->state_table[(state >> nb) + t->delta_fs[sym]];
    *nb_out = nb;
    return bits;
  }
  inline void flush(BitWriter& bw) { bw.add((u32)state, t->log); }
  inline u64 flush_bits(int* nb_out) {
    *nb_out = t->log;
    return (u64)(u32)state & ((1ULL << t->log) - 1);
  }
};

// Parse an FSE table description; returns bytes consumed or 0 on error.
static size_t fse_read_ncount(const u8* data, size_t len, int max_sym,
                              int max_log, i16* norm, int* nsym_out,
                              int* log_out) {
  BitReaderFwd br(data, len);
  int log = (int)br.read(4) + 5;
  if (log > max_log) return 0;
  int size = 1 << log;
  int remaining = size + 1, threshold = size, nb = log + 1;
  int i = 0;
  while (remaining > 1) {
    if (i > max_sym) return 0;
    int maxv = (2 * threshold - 1) - remaining;
    u32 val = br.peek(nb);
    int count;
    int small = (int)(val & (threshold - 1));
    if (small < maxv) { count = small; br.bitpos += nb - 1; }
    else {
      count = (int)(val & (2 * threshold - 1));
      if (count >= threshold) count -= maxv;
      br.bitpos += nb;
    }
    count -= 1;
    remaining -= count < 0 ? -count : count;
    norm[i++] = (i16)count;
    if (count == 0 && remaining > 1) {
      for (;;) {
        u32 rep = br.read(2);
        for (u32 r = 0; r < rep; r++) {
          if (i > max_sym) return 0;
          norm[i++] = 0;
        }
        if (rep != 3) break;
      }
    }
    while (remaining < threshold) { nb--; threshold >>= 1; }
  }
  if (remaining != 1) return 0;
  size_t consumed = br.bytes_consumed();
  if (consumed > len) return 0;
  *nsym_out = i;
  *log_out = log;
  return consumed;
}

// Serialize normalized counts (inverse of fse_read_ncount).
static void fse_write_ncount(BitWriter& bw, const i16* norm, int nsym, int log) {
  bw.add(log - 5, 4);
  int size = 1 << log;
  int remaining = size + 1, threshold = size, nb = log + 1;
  int i = 0;
  while (remaining > 1) {
    int count = norm[i];
    int stored = count + 1;
    int maxv = (2 * threshold - 1) - remaining;
    if (stored < maxv) bw.add((u32)stored, nb - 1);
    else {
      int val = stored < threshold ? stored : stored + maxv;
      bw.add((u32)val, nb);
    }
    remaining -= count < 0 ? -count : count;
    i++;
    if (count == 0 && remaining > 1) {
      int run = 0;
      while (i + run < nsym && norm[i + run] == 0) run++;
      i += run;
      while (run >= 3) { bw.add(3, 2); run -= 3; }
      bw.add((u32)run, 2);
    }
    while (remaining < threshold) { nb--; threshold >>= 1; }
  }
}

// Normalize histogram to sum 2^log (largest-remainder; -1 for rare symbols).
static void fse_normalize(const u32* count, int nsym, u32 total, int log,
                          i16* norm) {
  int size = 1 << log;
  u32 low = total >> log;
  int distributed = 0;
  u64 rest = 0;
  for (int s = 0; s < nsym; s++) {
    norm[s] = 0;
    if (!count[s]) continue;
    if (count[s] <= low) { norm[s] = -1; distributed++; }
    else rest += count[s];
  }
  int slots = size - distributed;
  if (slots <= 0 || rest == 0) {
    // Degenerate: one slot each, biggest gets the rest.
    int big = -1, nfill = 0;
    for (int s = 0; s < nsym; s++)
      if (count[s]) {
        norm[s] = 1; nfill++;
        if (big < 0 || count[s] > count[big]) big = s;
      }
    if (big >= 0) norm[big] += (i16)(size - nfill);
    return;
  }
  int assigned = 0;
  double best_frac[64]; int order[64]; int m = 0;
  for (int s = 0; s < nsym; s++) {
    if (norm[s] == -1 || !count[s]) continue;
    double exact = (double)count[s] * slots / (double)rest;
    int base = (int)exact; if (base < 1) base = 1;
    norm[s] = (i16)base;
    assigned += base;
    best_frac[m] = exact - base; order[m] = s; m++;
  }
  int leftover = slots - assigned;
  // Distribute (or strip) leftovers by largest remainder / smallest count.
  while (leftover > 0) {
    int bi = 0;
    for (int j = 1; j < m; j++) if (best_frac[j] > best_frac[bi]) bi = j;
    norm[order[bi]]++; best_frac[bi] -= 1.0; leftover--;
  }
  while (leftover < 0) {
    int bi = -1;
    for (int j = 0; j < m; j++)
      if (norm[order[j]] > 1 && (bi < 0 || count[order[j]] < count[order[bi]])) bi = j;
    if (bi < 0) break;
    norm[order[bi]]--; leftover++;
  }
}

// -------------------------------------------------------------- Huffman ---

static const int HUF_MAX_BITS = 11;

struct HufDecTable {
  int max_bits = 0;
  u8 symbol[1 << HUF_MAX_BITS];
  u8 nbits[1 << HUF_MAX_BITS];
};

// Build decode table from explicit weights (last weight already included).
static bool huf_build_dec(const u8* weights, int nsym, HufDecTable* t) {
  u32 total = 0;
  for (int s = 0; s < nsym; s++) total += weights[s] ? (1u << (weights[s] - 1)) : 0;
  if (!total || (total & (total - 1))) return false;
  int max_bits = highbit(total);
  if (max_bits > HUF_MAX_BITS) return false;
  t->max_bits = max_bits;
  int size = 1 << max_bits;
  int rank_start[HUF_MAX_BITS + 2] = {0};
  int rank_count[HUF_MAX_BITS + 2] = {0};
  for (int s = 0; s < nsym; s++) rank_count[weights[s]]++;
  int pos = 0;
  for (int w = 1; w <= max_bits + 1; w++) { rank_start[w] = pos; pos += rank_count[w] << (w - 1); }
  if (pos != size) return false;
  for (int s = 0; s < nsym; s++) {
    int w = weights[s];
    if (!w) continue;
    int len = 1 << (w - 1);
    int st = rank_start[w];
    memset(t->symbol + st, s, len);
    memset(t->nbits + st, max_bits + 1 - w, len);
    rank_start[w] += len;
  }
  return true;
}

// Length-limited Huffman code lengths: two-queue Huffman build (counting
// sort by frequency) + greedy max-height adjustment (the zstd approach).
static int huf_lengths(const u32* freqs, u8* lengths /*256*/, int max_len) {
  int syms[256], nsym = 0;
  for (int s = 0; s < 256; s++) { lengths[s] = 0; if (freqs[s]) syms[nsym++] = s; }
  if (nsym == 0) return 0;
  if (nsym == 1) { lengths[syms[0]] = 1; return 1; }
  // sort present symbols by (freq, symbol)
  std::sort(syms, syms + nsym, [&](int a, int b) {
    return freqs[a] != freqs[b] ? freqs[a] < freqs[b] : a < b;
  });
  // two-queue huffman: leaves queue (sorted) + internal-nodes queue (FIFO,
  // produced in nondecreasing order)
  struct Node { u64 w; int l, r; int sym; u8 depth; };
  static thread_local std::vector<Node> nodes;
  nodes.clear();
  nodes.reserve(2 * nsym);
  for (int i = 0; i < nsym; i++) nodes.push_back({freqs[syms[i]], -1, -1, syms[i], 0});
  size_t leaf_i = 0, int_i = nodes.size();
  size_t int_end = nodes.size();
  auto take = [&]() -> int {
    bool leaf_ok = leaf_i < (size_t)nsym;
    bool int_ok = int_i < int_end;
    if (leaf_ok && (!int_ok || nodes[leaf_i].w <= nodes[int_i].w)) return (int)leaf_i++;
    return (int)int_i++;
  };
  int root = -1;
  for (int k = 0; k < nsym - 1; k++) {
    int a = take();
    int b = take();
    nodes.push_back({nodes[a].w + nodes[b].w, a, b, -1, 0});
    int_end = nodes.size();
    root = (int)nodes.size() - 1;
  }
  if (root < 0) return 0;
  // depths via reverse traversal (children precede parents)
  nodes[root].depth = 0;
  for (int i = root; i >= 0; i--) {
    if (nodes[i].l >= 0) {
      nodes[nodes[i].l].depth = (u8)(nodes[i].depth + 1);
      nodes[nodes[i].r].depth = (u8)(nodes[i].depth + 1);
    }
  }
  int maxl = 0;
  for (int i = 0; i < nsym; i++) {
    lengths[nodes[i].sym] = nodes[i].depth;
    if (nodes[i].depth > maxl) maxl = nodes[i].depth;
  }
  if (maxl <= max_len) return maxl;
  // clamp + repay Kraft debt: K (in units of 2^-max_len) must equal 2^max_len
  i64 K = 0;
  for (int s = 0; s < 256; s++) {
    if (!lengths[s]) continue;
    if (lengths[s] > max_len) lengths[s] = (u8)max_len;
    K += 1LL << (max_len - lengths[s]);
  }
  i64 target = 1LL << max_len;
  // demote cheapest symbols (rarest first = start of syms) until K fits
  for (int i = 0; i < nsym && K > target; i++) {
    int sft = syms[i];
    while (K > target && lengths[sft] < max_len) {
      K -= 1LL << (max_len - lengths[sft] - 1);
      lengths[sft]++;
    }
  }
  if (K > target) return 0;  // cannot fit (should not happen for nsym<=2^max_len)
  // promote most frequent symbols to absorb remaining slack
  for (int i = nsym - 1; i >= 0 && K < target; i--) {
    int sft = syms[i];
    while (lengths[sft] > 1 && K + (1LL << (max_len - lengths[sft])) <= target) {
      K += 1LL << (max_len - lengths[sft]);
      lengths[sft]--;
    }
  }
  if (K != target) {
    // final fill with single-step demotions on rarest symbols
    for (int i = 0; i < nsym && K != target; i++) {
      int sft = syms[i];
      while (K > target && lengths[sft] < max_len) {
        K -= 1LL << (max_len - lengths[sft] - 1);
        lengths[sft]++;
      }
    }
    if (K != target) return 0;
  }
  maxl = 0;
  for (int s = 0; s < 256; s++) if (lengths[s] > maxl) maxl = lengths[s];
  return maxl;
}

struct HufEncTable {
  u16 codes[256];
  u8 nbits[256];
  u8 weights[256];  // by symbol
  int max_bits = 0;
  int last_sym = 0;
};

static bool huf_build_enc(const u32* freqs, HufEncTable* t) {
  u8 lengths[256];
  int maxl = huf_lengths(freqs, lengths, HUF_MAX_BITS);
  if (maxl == 0) return false;
  memset(t->weights, 0, 256);
  memset(t->nbits, 0, 256);
  int last = 0;
  for (int s = 0; s < 256; s++)
    if (lengths[s]) { t->weights[s] = (u8)(maxl + 1 - lengths[s]); last = s; }
  t->last_sym = last;
  t->max_bits = maxl;
  // canonical codes: rank positions by weight ascending
  int rank_start[HUF_MAX_BITS + 2] = {0};
  int rank_count[HUF_MAX_BITS + 2] = {0};
  for (int s = 0; s < 256; s++) rank_count[t->weights[s]]++;
  rank_count[0] = 0;
  int pos = 0;
  for (int w = 1; w <= maxl + 1; w++) { rank_start[w] = pos; pos += rank_count[w] << (w - 1); }
  if (pos != (1 << maxl)) return false;
  for (int s = 0; s < 256; s++) {
    int w = t->weights[s];
    if (!w) continue;
    t->codes[s] = (u16)(rank_start[w] >> (w - 1));
    t->nbits[s] = (u8)(maxl + 1 - w);
    rank_start[w] += 1 << (w - 1);
  }
  return true;
}

// Serialize weights: FSE-compressed when it pays, else direct nibbles.
// Returns false if not serializable.
static bool huf_write_weights(std::vector<u8>& out, const HufEncTable* t) {
  int n = t->last_sym;  // weights for symbols 0..last-1; last is implied
  // Try FSE compression of the weight stream (max symbol 15, log <= 6).
  if (n > 1) {
    u32 wfreq[16] = {0};
    int distinct = 0;
    for (int s = 0; s < n; s++) wfreq[t->weights[s]]++;
    for (int v = 0; v < 16; v++) if (wfreq[v]) distinct++;
    if (distinct >= 2) {
      int log = 6;
      while (log > 5 && (1 << (log - 1)) >= n) log--;  // small inputs: smaller table
      i16 norm[16];
      int max_sym = 0;
      for (int v = 0; v < 16; v++) if (wfreq[v]) max_sym = v;
      fse_normalize(wfreq, max_sym + 1, (u32)n, log, norm);
      FseEncTable ft;
      if (fse_build_enc(norm, max_sym + 1, log, &ft)) {
        std::vector<u8> payload;
        BitWriter bw(&payload);
        fse_write_ncount(bw, norm, max_sym + 1, log);
        bw.align_no_sentinel();
        // two interleaved chains (see codec/fse.py fse_compress)
        const u8* w = t->weights;
        int m1 = (n + 1) / 2, m2 = n / 2;
        FseEncState s1, s2;
        int top;
        if (n & 1) {
          s1.init(&ft, w[2 * (m1 - 1)]);
          s2.init(&ft, w[2 * (m2 - 1) + 1]);
          s1.encode(bw, w[2 * (m1 - 2)]);
          top = m2 - 1;
        } else {
          s2.init(&ft, w[2 * (m2 - 1) + 1]);
          s1.init(&ft, w[2 * (m1 - 1)]);
          top = m1 - 1;
        }
        for (int r = top - 1; r >= 0; r--) {
          s2.encode(bw, w[2 * r + 1]);
          s1.encode(bw, w[2 * r]);
        }
        s2.flush(bw);
        s1.flush(bw);
        bw.finish();
        if ((int)payload.size() < 128 && (int)payload.size() < (n + 1) / 2 + 1) {
          // Self-check: decode back (the stream-implied length must match).
          // Cheap: decode with two states.
          i16 norm2[16]; int ns2, log2;
          size_t c = fse_read_ncount(payload.data(), payload.size(), 15, 6, norm2, &ns2, &log2);
          bool okw = c > 0;
          if (okw) {
            FseDecTable dt;
            okw = fse_build_dec(norm2, ns2, log2, &dt);
            if (okw) {
              BitReaderBack br(payload.data() + c, payload.size() - c);
              int st1 = (int)br.read(dt.log), st2 = (int)br.read(dt.log);
              u8 back[256]; int k = 0;
              bool done = false;
              while (!done && k < 255) {
                back[k++] = dt.symbol[st1];
                st1 = dt.baseline[st1] + (int)br.read(dt.nbits[st1]);
                if (br.rem < 0) { back[k++] = dt.symbol[st2]; break; }
                back[k++] = dt.symbol[st2];
                st2 = dt.baseline[st2] + (int)br.read(dt.nbits[st2]);
                if (br.rem < 0) { back[k++] = dt.symbol[st1]; break; }
              }
              okw = (k == n) && !memcmp(back, t->weights, n);
            }
          }
          if (okw) {
            out.push_back((u8)payload.size());
            out.insert(out.end(), payload.begin(), payload.end());
            return true;
          }
        }
      }
    }
  }
  if (n > 128) return false;  // direct header caps at 127 + 128
  out.push_back((u8)(127 + n));
  for (int i = 0; i < n; i += 2) {
    u8 hi = (u8)(t->weights[i] << 4);
    u8 lo = (i + 1 < n) ? t->weights[i + 1] : 0;
    out.push_back(hi | lo);
  }
  return true;
}

static inline void huf_encode_stream(std::vector<u8>& out, const u8* src,
                                     size_t n, const HufEncTable* t) {
  BitWriter bw(&out);
  size_t i = n;
  while (i >= 2) {
    u8 a = src[i - 1], b = src[i - 2];
    int na = t->nbits[a], nb2 = t->nbits[b];
    bw.add_wide((u64)t->codes[a] | ((u64)t->codes[b] << na), na + nb2);
    i -= 2;
  }
  if (i) bw.add(t->codes[src[0]], t->nbits[src[0]]);
  bw.finish();
}

// ------------------------------------------------- sequence code tables ---

static const u32 LL_BASE[36] = {
    0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
    16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024, 2048,
    4096, 8192, 16384, 32768, 65536};
static const u8 LL_BITS[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                               1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11,
                               12, 13, 14, 15, 16};
static const u32 ML_BASE[53] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16, 17, 18,
    19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34,
    35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027,
    2051, 4099, 8195, 16387, 32771, 65539};
static const u8 ML_BITS[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                               0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                               1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10,
                               11, 12, 13, 14, 15, 16};

// Fused (base << 6 | extra_bits) per code: one load instead of two in the
// decoder's hot loop (largest base 65539 needs 17 bits; 23 bits total).
static u32 LL_BB[36], ML_BB[53];
static const bool g_bb_init = [] {
  for (int c = 0; c < 36; c++) LL_BB[c] = (LL_BASE[c] << 6) | LL_BITS[c];
  for (int c = 0; c < 53; c++) ML_BB[c] = (ML_BASE[c] << 6) | ML_BITS[c];
  return true;
}();

static const i16 LL_DEF_NORM[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1,
                                    2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1,
                                    -1, -1, -1, -1};
static const i16 ML_DEF_NORM[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1,
                                    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1,
                                    -1, -1, -1, -1, -1};
static const i16 OF_DEF_NORM[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1,
                                    1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

static u8 g_ll_lut[64], g_ml_lut[128];
static void build_code_luts() {
  for (u32 v = 0; v < 64; v++) {
    int lo = 16, hi = 35;
    if (v < 16) { g_ll_lut[v] = (u8)v; continue; }
    while (lo < hi) { int mid = (lo + hi + 1) >> 1; if (LL_BASE[mid] <= v) lo = mid; else hi = mid - 1; }
    g_ll_lut[v] = (u8)lo;
  }
  for (u32 mb = 0; mb < 128; mb++) {  // mb = ml - 3
    u32 ml = mb + 3;
    if (ml < 35) { g_ml_lut[mb] = (u8)mb; continue; }
    int lo = 32, hi = 52;
    while (lo < hi) { int mid = (lo + hi + 1) >> 1; if (ML_BASE[mid] <= ml) lo = mid; else hi = mid - 1; }
    g_ml_lut[mb] = (u8)lo;
  }
}
static inline int ll_code(u32 ll) {
  if (ll < 64) return g_ll_lut[ll];
  return 19 + highbit(ll);  // codes 25..35: baseline 2^k, k = 6..16
}
static inline int ml_code(u32 ml) {
  u32 mb = ml - 3;
  if (mb < 128) return g_ml_lut[mb];
  return 36 + highbit(mb);  // codes 43..52: baseline-3 = 2^k, k = 7..16
}

// Global predefined encode/decode tables (built once).
static FseEncTable g_ll_def_enc, g_ml_def_enc, g_of_def_enc;
static FseDecTable g_ll_def_dec, g_ml_def_dec, g_of_def_dec;
// Fill the fused sequence-decode entries for a ll (max_code 35) or ml
// (52) table; of tables (31) keep the code-form packed entry (the code is
// the shift count the offset computation needs).
static void fill_packed2(FseDecTable* t, int max_code) {
  if (max_code != 35 && max_code != 52) return;
  const u32* vb = max_code == 35 ? LL_BASE : ML_BASE;
  const u8* vbits = max_code == 35 ? LL_BITS : ML_BITS;
  int size = 1 << t->log;
  for (int u = 0; u < size; u++) {
    int sym = t->symbol[u];
    t->packed2[u] = (u64)vb[sym] | ((u64)vbits[sym] << 20) |
                    ((u64)t->nbits[u] << 26) | ((u64)t->baseline[u] << 34);
  }
}

static bool g_defaults_ready = false;
static void ensure_defaults() {
  if (g_defaults_ready) return;
  build_code_luts();
  fse_build_enc(LL_DEF_NORM, 36, 6, &g_ll_def_enc);
  fse_build_enc(ML_DEF_NORM, 53, 6, &g_ml_def_enc);
  fse_build_enc(OF_DEF_NORM, 29, 5, &g_of_def_enc);
  fse_build_dec(LL_DEF_NORM, 36, 6, &g_ll_def_dec);
  fse_build_dec(ML_DEF_NORM, 53, 6, &g_ml_def_dec);
  fse_build_dec(OF_DEF_NORM, 29, 5, &g_of_def_dec);
  fill_packed2(&g_ll_def_dec, 35);
  fill_packed2(&g_ml_def_dec, 52);
  g_defaults_ready = true;
}

// ------------------------------------------------------------- encoder ----

// ov = offset_value (repcodes 1..3 or off+3); llc/mlc/ofc are the FSE
// symbol codes, filled at store time so the emit path never recomputes.
struct Seq { u32 ll, ml, ov; u8 llc, mlc, ofc, pad; };
static inline Seq mk_seq(u32 ll, u32 ml, u32 ov) {
  return {ll, ml, ov, (u8)ll_code(ll), (u8)ml_code(ml), (u8)highbit(ov), 0};
}

// Greedy fast matcher: 6-byte-hash table (depth 1) + rep check + backward
// extension (the native twin of codec/match.py's fast levels).
struct Matcher {
  std::vector<i32> table;   // 1 << HASHLOG
  std::vector<i32> table2;  // long-hash table (16 bytes sampled)
  std::vector<i32> chain;   // per-position previous same-hash (levels 13+)
  std::vector<i32> table3;  // 3-byte hash (optimal parser: near short matches)
  std::vector<i32> table4;  // 4-byte hash (lazy levels: near short matches)
  // Binary-tree matchfinder (optimal parser): per 4-byte-hash bucket, a
  // tree of earlier positions sorted by suffix; search+insert costs
  // O(nb_compares) with amortized length extension.
  std::vector<i32> btree;   // 2*window: left/right child per position
  std::vector<i32> btroot;  // 1 << HASHLOG: most recent position per bucket
  static const int HASHLOG = 17;
  static const int HASHLOG3 = 15;
  Matcher() : table(1 << HASHLOG, -1), table2(1 << HASHLOG, -1),
              table3(1 << HASHLOG3, -1), table4(1 << HASHLOG3, -1) {}
  void reset() {
    std::fill(table.begin(), table.end(), -1);
    std::fill(table2.begin(), table2.end(), -1);
    std::fill(table3.begin(), table3.end(), -1);
    std::fill(table4.begin(), table4.end(), -1);
  }
  void enable_chain(size_t window) { chain.assign(window, -1); }
  bool bt3 = false;  // tree buckets hash 3 bytes (min-match 3, deepest level)
  void enable_bt(size_t window, bool use3) {
    btree.assign(2 * window, -1);
    btroot.assign(1 << HASHLOG, -1);
    bt3 = use3;
  }
  static inline u32 hash4(const u8* p) {
    return (read32(p) * 2654435761u) >> (32 - HASHLOG);
  }
  static inline u32 hash3w(const u8* p) {
    return ((read32(p) & 0xFFFFFF) * 2654435761u) >> (32 - HASHLOG);
  }
  static inline u32 hash6(const u8* p) {
    u64 v = read64(p) & 0xFFFFFFFFFFFFULL;
    return (u32)((v * 0xCF1BBCDCB7A56463ULL) >> (64 - HASHLOG));
  }
  // 4-byte hash into the small table3 (the optimal parser hashes 3 bytes
  // into the same table; different levels, never the same frame). The
  // lazy levels probe it for near short matches: structured data like
  // numeric logs lives on 4-5 byte matches that a 6-byte hash never
  // buckets together.
  static inline u32 hash4n(const u8* p) {
    return (read32(p) * 2654435761u) >> (32 - HASHLOG3);
  }
  bool probe4 = false;  // lazy levels: 4-byte near probe on table3
  inline u32 hash_short(const u8* p) const { return hash6(p); }
  static inline u32 hash3(const u8* p) {
    u32 v = read32(p) & 0xFFFFFF;
    return (v * 2654435761u) >> (32 - HASHLOG3);
  }
  static inline u32 hash16(const u8* p) {
    u64 v = read64(p) * 0x9E3779B185EBCA87ULL ^ read64(p + 8) * 0xC2B2AE3D27D4EB4FULL;
    return (u32)((v * 0x2545F4914F6CDD1DULL) >> (64 - HASHLOG));
  }

  // Long-distance matcher: 32-byte-window hashes over the whole window,
  // keeping the first AND most recent position per bucket. The first
  // reaches across an arbitrarily large patch prefix even after nearer
  // data has overwritten the short-hash tables (libzstd's
  // EnableLongDistanceMatching analog; driven by the CLI patch mode,
  // reference cli/src/compress.rs:31-37).
  static const int LDMLOG = 20;
  static const u32 LDM_MIN = 32;
  std::vector<i32> ldm_first, ldm_last;
  bool ldm = false;
  void enable_ldm() {
    ldm = true;
    ldm_first.assign(1 << LDMLOG, -1);
    ldm_last.assign(1 << LDMLOG, -1);
  }
  static inline u32 hash32w(const u8* p) {
    u64 v = read64(p) * 0x9E3779B185EBCA87ULL;
    v = (v ^ (read64(p + 8) * 0xC2B2AE3D27D4EB4FULL)) * 0x2545F4914F6CDD1DULL;
    v = (v ^ (read64(p + 16) * 0x165667B19E3779F9ULL)) * 0x2545F4914F6CDD1DULL;
    v = (v ^ (read64(p + 24) * 0x27D4EB2F165667C5ULL)) * 0x2545F4914F6CDD1DULL;
    return (u32)(v >> (64 - LDMLOG));
  }
  inline void ldm_insert(const u8* base, const u8* p, const u8* wend) {
    if (!ldm || wend - p < 32) return;
    u32 h = hash32w(p);
    i32 cur = (i32)(p - base);
    if (ldm_first[h] < 0) ldm_first[h] = cur;
    ldm_last[h] = cur;
  }
};

static inline u32 match_len(const u8* a, const u8* b, const u8* limit) {
  const u8* start = a;
  while (a + 8 <= limit) {
    u64 d = read64(a) ^ read64(b);
    if (d) return (u32)(a - start) + (__builtin_ctzll(d) >> 3);
    a += 8; b += 8;
  }
  while (a < limit && *a == *b) { a++; b++; }
  return (u32)(a - start);
}

// Offset-cost-aware candidate score; repeat-offset matches are scored by
// the callers as 4*len + 2 (no offset cost).
static inline int cand_score(u32 len, u32 off) {
  return 4 * (int)len - highbit(off | 1);
}

// Best (length, offset) candidate at ip given both hash tables + rep probe.
// ``depth`` > 0 additionally walks the per-position hash chain (levels 13+).
static inline u32 probe_best(const u8* base, const u8* ip, const u8* mlimit,
                             Matcher& M, u32 rep1, u32* off_out,
                             int depth = 0) {
  // Candidates compete on an offset-cost-aware score (4*len - log2(off),
  // rep matches free of offset cost): raw longest-match selection breaks
  // profitable repeat-offset chains on structured data.
  u32 best_len = 0, best_off = 0;
  int best_score = -1000;
  size_t cur = (size_t)(ip - base);
  if (cur >= rep1 && read32(ip) == read32(ip - rep1)) {
    best_len = match_len(ip, ip - rep1, mlimit);
    best_off = rep1;
    best_score = 4 * (int)best_len + 2;
  }
  u32 h = M.hash_short(ip);
  i32 cand = M.table[h];
  if (!M.chain.empty()) M.chain[cur] = cand;
  M.table[h] = (i32)cur;
  if (cand >= 0 && read32(base + cand) == read32(ip)) {
    u32 l = match_len(ip, base + cand, mlimit);
    u32 o = (u32)(cur - cand);
    int sc = cand_score(l, o);
    if (sc > best_score) { best_len = l; best_off = o; best_score = sc; }
  }
  if (M.probe4) {
    u32 h4 = Matcher::hash4n(ip);
    i32 c4 = M.table4[h4];
    M.table4[h4] = (i32)cur;
    if (c4 >= 0 && c4 != cand && read32(base + c4) == read32(ip)) {
      u32 l = match_len(ip, base + c4, mlimit);
      u32 o = (u32)(cur - (size_t)c4);
      int sc = cand_score(l, o);
      if (sc > best_score) { best_len = l; best_off = o; best_score = sc; }
    }
  }
  if (depth > 0 && cand >= 0 && !M.chain.empty()) {
    i32 c = M.chain[cand];
    for (int t = 0; t < depth && c >= 0; t++) {
      if (read32(base + c) == read32(ip)) {
        u32 l = match_len(ip, base + c, mlimit);
        u32 o = (u32)(cur - (size_t)c);
        int sc = cand_score(l, o);
        if (sc > best_score) { best_len = l; best_off = o; best_score = sc; }
      }
      c = M.chain[c];
    }
  }
  if (mlimit - ip < 16) { *off_out = best_off; return best_len; }
  u32 h2 = Matcher::hash16(ip);
  i32 cand2 = M.table2[h2];
  M.table2[h2] = (i32)cur;
  if (best_len < 16 && cand2 >= 0 && cand2 != cand &&
      read32(base + cand2) == read32(ip)) {
    u32 l = match_len(ip, base + cand2, mlimit);
    if (l > best_len) { best_len = l; best_off = (u32)(cur - cand2); }
  }
  if (M.ldm && best_len < 64 && mlimit - ip >= (ptrdiff_t)Matcher::LDM_MIN) {
    u32 h3 = Matcher::hash32w(ip);
    i32 lc[2] = {M.ldm_first[h3], M.ldm_last[h3]};
    for (int t = 0; t < 2; t++) {
      i32 c = lc[t];
      if (c >= 0 && (size_t)c < cur && read64(base + c) == read64(ip)) {
        u32 l = match_len(ip, base + c, mlimit);
        if (l >= Matcher::LDM_MIN && l > best_len) {
          best_len = l;
          best_off = (u32)(cur - c);
        }
      }
    }
    M.ldm_insert(base, ip, mlimit);
  }
  *off_out = best_off;
  return best_len;
}

// Parse one block [src+pos, src+pos+len) with history src[0..pos+len).
// reps in/out mirror the decoder. Appends to seqs/lits. ``lazy``: 0 greedy,
// 1-2 lazy evaluation steps (higher levels trade speed for ratio).
static void parse_block_opt(const u8* src, size_t pos, size_t len, Matcher& M,
                            u32 reps[3], std::vector<Seq>& seqs,
                            std::vector<u8>& lits, int depth);
struct OptCand { u32 len, off; };
static int bt_insert_search(const u8* base, const u8* ip, const u8* iend,
                            Matcher& M, int nb_compares, OptCand* out,
                            bool collect, u32 rec_cap);

#ifdef ZN_ENCPROF
#include <x86intrin.h>
static thread_local unsigned long long zn_encprof[8];
extern "C" void zn_encprof_get(unsigned long long* out8) {
  for (int i = 0; i < 8; i++) { out8[i] = zn_encprof[i]; zn_encprof[i] = 0; }
}
#endif

// Experiment knobs for the L1 loop (mirrors the Pallas match kernel's
// design space; used by tools/native_prof.cpp grid searches).
static int l1_hb() {
  static int v = [] { const char* e = getenv("ZN_L1_HB"); return e ? atoi(e) : 17; }();
  return v;
}
static int l1_winlog() {
  static int v = [] { const char* e = getenv("ZN_L1_WINLOG"); return e ? atoi(e) : 30; }();
  return v;
}
static int l1_lazy() {
  static int v = [] { const char* e = getenv("ZN_L1_LAZY"); return e ? atoi(e) : 0; }();
  return v;
}
static int l1_p4() {
  static int v = [] { const char* e = getenv("ZN_L1_P4"); return e ? atoi(e) : 0; }();
  return v;
}
static int l1_stride() {
  static int v = [] { const char* e = getenv("ZN_L1_STRIDE"); return e ? atoi(e) : 2; }();
  return v;
}
static int zn_opt_entry() {
  static int v = [] { const char* e = getenv("ZN_OPT_ENTRY"); return e ? atoi(e) : 15; }();
  return v;
}
// Sequence-density knobs: every emitted sequence costs the TPU decode
// ring kernel ~400 serial cycles and the FSE stages a table walk, so
// fewer/longer sequences trade a little ratio for large decode wins.
// REPMIN = minimum accepted rep-match length; GATE = extra slack added
// to the hash-match cost gate 6*ml >= 15 + highbit(off) + GATE.
static int l1_repmin() {
  static int v = [] { const char* e = getenv("ZN_L1_REPMIN"); return e ? atoi(e) : 4; }();
  return v;
}
static int l1_gate() {
  static int v = [] { const char* e = getenv("ZN_L1_GATE"); return e ? atoi(e) : 0; }();
  return v;
}
static u64 l1_hmask() {
  static u64 v = [] {
    const char* e = getenv("ZN_L1_MLS");
    int mls = e ? atoi(e) : 6;
    return (u64)-1 >> (64 - 8 * mls);
  }();
  return v;
}
static const int L1_HASHLOG = 17;
static inline u32 l1_hash6(const u8* p) {
  u64 v = read64(p) & 0xFFFFFFFFFFFFULL;
  return (u32)((v * 0xCF1BBCDCB7A56463ULL) >> (64 - L1_HASHLOG));
}
static void parse_block_l1(const u8* src, size_t pos, size_t len, Matcher& M,
                           u32 reps[3], std::vector<Seq>& seqs,
                           std::vector<u8>& lits) {
  const int HB = l1_hb(), LAZY = l1_lazy(), P4 = l1_p4(), STRIDE = l1_stride();
  const int REPMIN = l1_repmin(), GATE = l1_gate();
  const u32 wcap = l1_winlog() >= 30 ? 0x7FFFFFFFu : (1u << l1_winlog());
  const u64 HMASK = l1_hmask();
  const u8* base = src;
  const u8* ip = src + pos;
  const u8* iend = ip + len;
  const u8* anchor = ip;
  const u8* mlimit = iend;
  if (len < 16) { lits.insert(lits.end(), ip, iend); return; }
  const u8* search_end = iend - 8;
  // Raw literal emission: reserve once, wildcopy 16 B at a time, trim at
  // return (vector::insert's growth check + memmove per run measured ~8%
  // of the block parse).
  size_t lit0 = lits.size();
  lits.resize(lit0 + len + 32);
  u8* lp = lits.data() + lit0;

  // One probe at p: rep1 first (taken unconditionally, ZSTD_fast\'s
  // repcode-favoring rule), then the 6-byte table, then an optional
  // 4-byte near table (the kernel design space: ZN_L1_HB/P4/LAZY/...).
  auto probe = [&](const u8* p, u32 r1, u32* off_out) -> u32 {
#ifdef ZN_ENCPROF
    zn_encprof[5]++;
#endif
    size_t cur = (size_t)(p - base);
    u64 w8 = read64(p);
    u32 h = (u32)(((w8 & HMASK) * 0xCF1BBCDCB7A56463ULL) >> (64 - HB));
    i32 cand = M.table[h];
    M.table[h] = (i32)cur;
    if (cur >= r1 && (u32)w8 == read32(p - r1)) {
      u32 rl = 4 + match_len(p + 4, p - r1 + 4, mlimit);
      if ((int)rl >= REPMIN) {
        *off_out = r1;
        return rl;
      }
    }
    u32 bl = 0, bo = 1;
    if (cand >= 0 && cur - cand <= wcap && read32(base + cand) == (u32)w8) {
      bl = 4 + match_len(p + 4, base + cand + 4, mlimit);
      bo = (u32)(cur - cand);
    }
    if (P4) {
      u32 h4 = ((u32)w8 * 2654435761u) >> (32 - P4);
      i32 c4 = M.table4[h4];
      M.table4[h4] = (i32)cur;
      if (c4 >= 0 && c4 != cand && cur - c4 <= wcap &&
          read32(base + c4) == (u32)w8) {
        u32 l4 = 4 + match_len(p + 4, base + c4 + 4, mlimit);
        if (cand_score(l4, (u32)(cur - c4)) > cand_score(bl, bo)) {
          bl = l4;
          bo = (u32)(cur - c4);
        }
      }
    }
    if (bl >= 4 && 6 * (int)bl >= 14 + highbit(bo) + 1 + GATE) {
      *off_out = bo;
      return bl;
    }
    return 0;
  };

  while (ip < search_end - 1) {
    u32 best_off;
    u32 best_len = probe(ip, reps[0], &best_off);
    if (!best_len) {
      ip += 1 + ((size_t)(ip - anchor) >> 8);
      continue;
    }
    if (LAZY && best_off != reps[0] && ip + 1 < search_end - 1 &&
        best_len < 128) {
      // 1-step lazy race with the cost-aware gain rule (parse_block\'s):
      // the deferred byte costs a literal, rep matches keep their
      // no-offset-cost bonus.
      u32 off2;
      u32 len2 = probe(ip + 1, reps[0], &off2);
      if (len2 >= 4) {
        int sc1 = cand_score(best_len, best_off);
        int sc2 = off2 == reps[0] ? 4 * (int)len2 + 2 : cand_score(len2, off2);
        if (sc2 > sc1 + 1) {
          ip++;
          best_len = len2;
          best_off = off2;
        }
      }
    }
    while (ip > anchor && (size_t)(ip - base) > best_off &&
           ip[-1] == *(ip - best_off - 1)) {
      ip--; best_len++;
    }
    u32 ll = (u32)(ip - anchor);
    // Wildcopy: the lits buffer has 32 spare bytes; the 16 B source
    // overread stays inside the caller\'s buffer except near the block
    // end, where an exact copy guards against reading past it.
    if (anchor + ll + 16 <= iend) {
      for (u32 c = 0; c < ll; c += 16) memcpy(lp + c, anchor + c, 16);
    } else {
      memcpy(lp, anchor, ll);
    }
    lp += ll;
    // Two-outcome offset coding (ZSTD_fast): rep1 or literal offset.
    // r2/r3 code opportunities are rare at this level; their compare
    // chain mispredicts once per sequence.
    u32 ov;
    if (best_off == reps[0] && ll != 0) {
      ov = 1;
    } else {
      ov = best_off + 3;
      reps[2] = reps[1]; reps[1] = reps[0]; reps[0] = best_off;
    }
    seqs.push_back(mk_seq(ll, best_len, ov));
    const u8* mend = ip + best_len;
    // The next probe position is known now: prefetch its hash-table row
    // and rep-check byte so their ~L2/L3 latency overlaps the insert
    // loop below (the probe's dependent-load chain dominates parse time).
    if (mend + 8 <= iend) {
      u64 nw = read64(mend);
      __builtin_prefetch(
          &M.table[(u32)(((nw & HMASK) * 0xCF1BBCDCB7A56463ULL) >> (64 - HB))],
          1);
      __builtin_prefetch(mend - reps[0], 0);
    }
    // Strided in-match insertion: dense (stride-1) insertion costs a
    // hash+table write per covered byte (~3x the probe count); stride 2
    // keeps nearly all of its ratio at half the cost.
    const u8* stop = mend < search_end ? mend : search_end;
    // Long-match interiors are redundant content (the source interval
    // already populated the table); cap inserts per match so they cover
    // short matches fully but stop refreshing deep interiors.
    if (stop > ip + 1 + 2 * STRIDE * 4) stop = ip + 1 + 2 * STRIDE * 4;
    for (const u8* q = ip + 1; q < stop; q += STRIDE) {
#ifdef ZN_ENCPROF
      zn_encprof[6]++;
#endif
      u64 qw = read64(q);
      M.table[(u32)(((qw & HMASK) * 0xCF1BBCDCB7A56463ULL) >> (64 - HB))] =
          (i32)(q - base);
      if (P4) M.table4[((u32)qw * 2654435761u) >> (32 - P4)] = (i32)(q - base);
    }
    ip = mend;
    anchor = ip;
  }
  memcpy(lp, anchor, (size_t)(iend - anchor));
  lp += iend - anchor;
  lits.resize((size_t)(lp - lits.data()));
}

static void parse_block(const u8* src, size_t pos, size_t len, Matcher& M,
                        u32 reps[3], std::vector<Seq>& seqs,
                        std::vector<u8>& lits, int lazy, int depth) {
  const u8* base = src;
  const u8* ip = src + pos;
  const u8* iend = ip + len;
  const u8* anchor = ip;
  const u8* mlimit = iend;
  if (len < 16) { lits.insert(lits.end(), ip, iend); return; }
  const u8* search_end = iend - 8;

  while (ip < search_end) {
    u32 best_off;
    u32 best_len = probe_best(base, ip, mlimit, M, reps[0], &best_off, depth);
    if (best_len < 4 ||
        (best_off != reps[0] && 6 * (int)best_len < 14 + highbit(best_off) + 1)) {
      // Miss acceleration: long literal runs step faster (ZSTD_fast-style),
      // which makes incompressible stretches near-free.
      ip += 1 + ((size_t)(ip - anchor) >> 8);
      continue;
    }
    // Lazy evaluation: the match one byte later wins only on a cost-aware
    // gain comparison (rep matches keep their no-offset-cost bonus, and
    // the deferred byte costs a literal). A pure longer-wins rule here
    // breaks profitable repeat-offset chains on digit-periodic data: a
    // 6-byte far match would displace a 5-byte rep match every few
    // sequences, scattering the offset histogram (zstd's lazy_generic
    // makes the same gain comparison).
    for (int step = 0; step < lazy && ip + 1 < search_end && best_len < 128; step++) {
      u32 off2;
      u32 len2 = probe_best(base, ip + 1, mlimit, M, reps[0], &off2, depth);
      int sc1 = best_off == reps[0] ? 4 * (int)best_len + 2
                                    : cand_score(best_len, best_off);
      int sc2 = off2 == reps[0] ? 4 * (int)len2 + 2
                                : cand_score(len2, off2);
      if (len2 >= 4 && sc2 > sc1 + 1 &&
          !(off2 != reps[0] && 6 * (int)len2 < 14 + highbit(off2) + 1)) {
        ip++;
        best_len = len2;
        best_off = off2;
      } else {
        break;
      }
    }
    // backward extension
    while (ip > anchor && (size_t)(ip - base) > best_off &&
           ip[-1] == *(ip - best_off - 1)) {
      ip--; best_len++;
    }
    u32 ll = (u32)(ip - anchor);
    lits.insert(lits.end(), anchor, ip);
    // offset_value + rep update (encoder mirror of the decoder rules)
    u32 ov;
    u32 r2 = reps[1], r3 = reps[2];
    if (ll != 0) {
      if (best_off == reps[0]) ov = 1;
      else if (best_off == r2) { ov = 2; reps[1] = reps[0]; reps[0] = best_off; }
      else if (best_off == r3) { ov = 3; reps[2] = r2; reps[1] = reps[0]; reps[0] = best_off; }
      else { ov = best_off + 3; reps[2] = r2; reps[1] = reps[0]; reps[0] = best_off; }
    } else {
      if (best_off == r2) { ov = 1; reps[1] = reps[0]; reps[0] = best_off; }
      else if (best_off == r3) { ov = 2; reps[2] = r2; reps[1] = reps[0]; reps[0] = best_off; }
      else if (best_off + 1 == reps[0] && best_off != 0) { ov = 3; reps[2] = r2; reps[1] = reps[0]; reps[0] = best_off; }
      else { ov = best_off + 3; reps[2] = r2; reps[1] = reps[0]; reps[0] = best_off; }
    }
    seqs.push_back(mk_seq(ll, best_len, ov));
    // index interior sparsely
    const u8* mend = ip + best_len;
    const u8* stop = mend < search_end ? mend : search_end;
    int stride = best_len < 64 ? 1 : 2;
    for (const u8* q = ip + 1; q < stop; q += stride) {
      size_t qo = (size_t)(q - base);
      u32 hq = M.hash_short(q);
      if (!M.chain.empty()) M.chain[qo] = M.table[hq];
      M.table[hq] = (i32)qo;
      if (M.probe4) M.table4[Matcher::hash4n(q)] = (i32)qo;
      if (iend - q >= 16) M.table2[Matcher::hash16(q)] = (i32)qo;
    }
    ip = mend;
    anchor = ip;
  }
  lits.insert(lits.end(), anchor, iend);
}

// ------------------------------------------------- block/frame assembly ---

// Cost of coding `hist` with table norm/log (predefined) vs dedicated.
static double fse_cost_bits(const u32* hist, int nsym, const i16* norm,
                            int norm_n, int log, bool* usable) {
  double bits = 0;
  *usable = true;
  for (int s = 0; s < nsym; s++) {
    if (!hist[s]) continue;
    if (s >= norm_n || norm[s] == 0) { *usable = false; return 0; }
    double p = norm[s] > 0 ? (double)norm[s] : 0.5;
    bits += hist[s] * (log - log2(p));
  }
  return bits;
}

struct CatChoice {
  int mode;  // 0 predef, 1 rle, 2 fse
  FseEncTable dedicated;
  const FseEncTable* table;
  u8 rle_sym;
  std::vector<u8> desc;
};

static void choose_table(const u32* hist, size_t n, int max_code,
                         const i16* def_norm, int def_n, int def_log,
                         const FseEncTable* def_table, int max_log,
                         CatChoice* out) {
  int distinct = 0, only = 0, max_present = 0;
  for (int s = 0; s <= max_code; s++)
    if (hist[s]) { distinct++; only = s; max_present = s; }
  if (distinct == 1) {
    out->mode = 1;
    out->rle_sym = (u8)only;
    out->desc.assign(1, (u8)only);
    static FseEncTable rle_tab;  // per-call rebuild below (cheap)
    i16 norm[64] = {0};
    norm[only] = 1;
    fse_build_enc(norm, only + 1, 0, &out->dedicated);
    out->table = &out->dedicated;
    return;
  }
  bool pred_ok;
  double pred_bits = fse_cost_bits(hist, max_code + 1, def_norm, def_n, def_log, &pred_ok);
  // dedicated table
  int log = max_log;
  while (log > 5 && (u32)(1 << (log - 1)) > n) log--;
  i16 norm[64];
  fse_normalize(hist, max_present + 1, (u32)n, log, norm);
  std::vector<u8> desc;
  BitWriter bw(&desc);
  fse_write_ncount(bw, norm, max_present + 1, log);
  bw.align_no_sentinel();
  bool ded_ok;
  double ded_bits = fse_cost_bits(hist, max_present + 1, norm, max_present + 1, log, &ded_ok) +
                    8.0 * desc.size();
  if (pred_ok && (!ded_ok || pred_bits <= ded_bits)) {
    out->mode = 0;
    out->table = def_table;
    out->desc.clear();
    return;
  }
  out->mode = 2;
  fse_build_enc(norm, max_present + 1, log, &out->dedicated);
  out->table = &out->dedicated;
  out->desc = std::move(desc);
}

static void write_literals_section(std::vector<u8>& out, const u8* lits, size_t n) {
  auto raw_header = [&](size_t sz) {
    if (sz < 32) out.push_back((u8)(0 | (sz << 3)));
    else if (sz < (1u << 12)) {
      u32 v = 0 | (1u << 2) | ((u32)sz << 4);
      out.push_back((u8)v); out.push_back((u8)(v >> 8));
    } else {
      u32 v = 0 | (3u << 2) | ((u32)sz << 4);
      out.push_back((u8)v); out.push_back((u8)(v >> 8)); out.push_back((u8)(v >> 16));
    }
  };
  if (n == 0) { raw_header(0); return; }
  bool all_same = true;
  for (size_t i = 1; i < n && all_same; i++) all_same = lits[i] == lits[0];
  if (all_same) {
    size_t sz = n;
    if (sz < 32) out.push_back((u8)(1 | (sz << 3)));
    else if (sz < (1u << 12)) {
      u32 v = 1 | (1u << 2) | ((u32)sz << 4);
      out.push_back((u8)v); out.push_back((u8)(v >> 8));
    } else {
      u32 v = 1 | (3u << 2) | ((u32)sz << 4);
      out.push_back((u8)v); out.push_back((u8)(v >> 8)); out.push_back((u8)(v >> 16));
    }
    out.push_back(lits[0]);
    return;
  }
  if (n >= 64) {
    u32 freqs[256] = {0};
    for (size_t i = 0; i < n; i++) freqs[lits[i]]++;
    HufEncTable t;
    if (huf_build_enc(freqs, &t)) {
      std::vector<u8> payload;
      if (huf_write_weights(payload, &t)) {
        bool four = n >= 256;
        if (four) {
          size_t seg = (n + 3) / 4;
          std::vector<u8> s1, s2, s3, s4;
          huf_encode_stream(s1, lits, seg, &t);
          huf_encode_stream(s2, lits + seg, seg, &t);
          huf_encode_stream(s3, lits + 2 * seg, seg, &t);
          huf_encode_stream(s4, lits + 3 * seg, n - 3 * seg, &t);
          if (s1.size() <= 0xFFFF && s2.size() <= 0xFFFF && s3.size() <= 0xFFFF) {
            payload.push_back((u8)s1.size()); payload.push_back((u8)(s1.size() >> 8));
            payload.push_back((u8)s2.size()); payload.push_back((u8)(s2.size() >> 8));
            payload.push_back((u8)s3.size()); payload.push_back((u8)(s3.size() >> 8));
            payload.insert(payload.end(), s1.begin(), s1.end());
            payload.insert(payload.end(), s2.begin(), s2.end());
            payload.insert(payload.end(), s3.begin(), s3.end());
            payload.insert(payload.end(), s4.begin(), s4.end());
          } else four = false;
        }
        if (!four) {
          huf_encode_stream(payload, lits, n, &t);
        }
        size_t comp = payload.size();
        // header size formats for Compressed_Literals (type 2)
        size_t hdr_len;
        u64 v;
        if (!four && n < (1u << 10) && comp < (1u << 10)) {
          v = 2 | (0u << 2) | ((u64)n << 4) | ((u64)comp << 14); hdr_len = 3;
        } else if (four && n < (1u << 10) && comp < (1u << 10)) {
          v = 2 | (1u << 2) | ((u64)n << 4) | ((u64)comp << 14); hdr_len = 3;
        } else if (four && n < (1u << 14) && comp < (1u << 14)) {
          v = 2 | (2u << 2) | ((u64)n << 4) | ((u64)comp << 18); hdr_len = 4;
        } else if (four && n < (1u << 18) && comp < (1u << 18)) {
          v = 2 | (3u << 2) | ((u64)n << 4) | ((u64)comp << 22); hdr_len = 5;
        } else {
          hdr_len = 0;
        }
        if (hdr_len && hdr_len + comp < n + (n < 32 ? 1 : (n < 4096 ? 2 : 3))) {
          for (size_t i = 0; i < hdr_len; i++) out.push_back((u8)(v >> (8 * i)));
          out.insert(out.end(), payload.begin(), payload.end());
          return;
        }
      }
    }
  }
  raw_header(n);
  out.insert(out.end(), lits, lits + n);
}

static void write_sequences_section(std::vector<u8>& out,
                                    const std::vector<Seq>& seqs) {
  ensure_defaults();
  size_t n = seqs.size();
  if (n < 128) out.push_back((u8)n);
  else if (n < 0x7F00) { out.push_back((u8)((n >> 8) + 128)); out.push_back((u8)n); }
  else {
    size_t v = n - 0x7F00;
    out.push_back(255); out.push_back((u8)v); out.push_back((u8)(v >> 8));
  }
  if (n == 0) return;

  u32 llh[64] = {0}, mlh[64] = {0}, ofh[64] = {0};
  for (size_t i = 0; i < n; i++) {
    llh[seqs[i].llc]++;
    mlh[seqs[i].mlc]++;
    ofh[seqs[i].ofc]++;
  }
  CatChoice ll, of, ml;
  choose_table(llh, n, 35, LL_DEF_NORM, 36, 6, &g_ll_def_enc, 9, &ll);
  choose_table(ofh, n, 31, OF_DEF_NORM, 29, 5, &g_of_def_enc, 8, &of);
  choose_table(mlh, n, 52, ML_DEF_NORM, 53, 6, &g_ml_def_enc, 9, &ml);
  out.push_back((u8)((ll.mode == 2 ? 2 : ll.mode == 1 ? 1 : 0) << 6 |
                     (of.mode == 2 ? 2 : of.mode == 1 ? 1 : 0) << 4 |
                     (ml.mode == 2 ? 2 : ml.mode == 1 ? 1 : 0) << 2));
  out.insert(out.end(), ll.desc.begin(), ll.desc.end());
  out.insert(out.end(), of.desc.begin(), of.desc.end());
  out.insert(out.end(), ml.desc.begin(), ml.desc.end());

  // Emit through the raw-pointer writer into a reused scratch buffer
  // (state writes <= 26 bits + extras <= 63 bits < 12 bytes/seq), then
  // one memcpy into out — vector resize per 32-bit flush was ~15% of L1
  // encode, and resizing out directly zero-fills the worst-case bound.
  static thread_local std::vector<u8> bwbuf;
  if (bwbuf.size() < 12 * n + 16) bwbuf.resize(12 * n + 16);
  RawBitWriter bw(bwbuf.data());
  size_t last = n - 1;
  FseEncState mls_, ofs_, lls_;
  mls_.init(ml.table, seqs[last].mlc);
  ofs_.init(of.table, seqs[last].ofc);
  lls_.init(ll.table, seqs[last].llc);
  auto add_extras = [&](size_t i) {
    // write order ll, ml, of fused into one container push
    int lb = LL_BITS[seqs[i].llc], mb = ML_BITS[seqs[i].mlc], ob = seqs[i].ofc;
    u64 v = (u64)(seqs[i].ll - LL_BASE[seqs[i].llc]);
    v |= (u64)(seqs[i].ml - ML_BASE[seqs[i].mlc]) << lb;
    v |= (u64)(seqs[i].ov - (1u << ob)) << (lb + mb);
    bw.add_wide(v, lb + mb + ob);
  };
  add_extras(last);
  for (size_t i = n - 1; i-- > 0;) {
    // Fuse the three interleaved state writes (<= 26 bits) and, when the
    // sequence's extra bits fit, the extras too — one wide write per
    // sequence for the common case.
    const Seq& s = seqs[i];
    int ob, mb, lb;
    u64 ofb = ofs_.step(s.ofc, &ob);
    u64 mlb = mls_.step(s.mlc, &mb);
    u64 llb = lls_.step(s.llc, &lb);
    u64 st = ofb | (mlb << ob) | (llb << (ob + mb));
    int sb = ob + mb + lb;
    int elb = LL_BITS[s.llc], emb = ML_BITS[s.mlc], eob = s.ofc;
    int eb = elb + emb + eob;
    if (sb + eb <= 63) {
      u64 ev = (u64)(s.ll - LL_BASE[s.llc]);
      ev |= (u64)(s.ml - ML_BASE[s.mlc]) << elb;
      ev |= (u64)(s.ov - (1u << eob)) << (elb + emb);
      bw.add_wide(st | (ev << sb), sb + eb);
    } else {
      bw.add_wide(st, sb);
      add_extras(i);
    }
  }
  int stb;
  u64 stv = mls_.flush_bits(&stb);
  int stb2;
  u64 stv2 = ofs_.flush_bits(&stb2);
  stv |= stv2 << stb; stb += stb2;
  stv |= lls_.flush_bits(&stb2) << stb; stb += stb2;
  bw.add_wide(stv, stb);
  u8* end = bw.finish();
  out.insert(out.end(), bwbuf.data(), end);
}

// Frame header writer: window descriptor + 1-8 byte FCS (mirrors
// codec/frame.py write_frame_header, non-single-segment form).
static void write_frame_header(std::vector<u8>& out, u64 content_size,
                               u64 window_size, bool checksum) {
  out.push_back(0x28); out.push_back(0xB5); out.push_back(0x2F); out.push_back(0xFD);
  u8 fhd = checksum ? 0x04 : 0x00;
  int exponent = highbit((u32)(window_size >> 10)) + 10;
  if ((1ULL << exponent) > window_size) exponent--;
  u64 base = 1ULL << exponent;
  int mantissa = 0;
  if (base < window_size) {
    mantissa = (int)(((window_size - base) * 8 + base - 1) / base);
    if (mantissa > 7) { exponent++; mantissa = 0; }
  }
  int fcs_flag; int fcs_bytes;
  u64 fcs_val = content_size;
  if (content_size >= 256 && content_size <= 0xFFFFULL + 256) {
    fcs_flag = 1; fcs_bytes = 2; fcs_val = content_size - 256;
  } else if (content_size <= 0xFFFFFFFFULL) {
    fcs_flag = 2; fcs_bytes = 4;
  } else { fcs_flag = 3; fcs_bytes = 8; }
  fhd |= (u8)(fcs_flag << 6);
  out.push_back(fhd);
  out.push_back((u8)(((exponent - 10) << 3) | mantissa));
  for (int i = 0; i < fcs_bytes; i++) out.push_back((u8)(fcs_val >> (8 * i)));
}

static const size_t BLOCK_MAX = 1 << 17;

static int g_ldm = 0;
extern "C" void zn_set_ldm(int flag) { g_ldm = flag; }

extern "C" size_t zn_compress_frame(const u8* src, size_t n, u8* dst,
                                    size_t cap, int level, int checksum,
                                    const u8* prefix, size_t prefix_n) {
  ensure_defaults();
  std::vector<u8> out;
  out.reserve(n / 2 + 256);
  u64 window = n + prefix_n; if (window < 1024) window = 1024;
  write_frame_header(out, n, window, checksum != 0);

  // Concatenate prefix + data as the match window.
  std::vector<u8> buf;
  const u8* base;
  if (prefix_n) {
    buf.resize(prefix_n + n);
    memcpy(buf.data(), prefix, prefix_n);
    memcpy(buf.data() + prefix_n, src, n);
    base = buf.data();
  } else {
    base = src;
  }

  Matcher M;
  // Lazy/chain levels add the 4-byte near probe; the optimal levels keep
  // it on for their per-block lazy fallback race (L1 stays single-probe
  // for speed). ZN_OPT_ENTRY lowers the DP parser's entry level
  // (ratio experiments; default 15).
  const int opt_e = zn_opt_entry();
  if (level >= 2) M.probe4 = true;
  int depth = level >= 19 ? 512 : level >= 17 ? 64 : (level >= 15 ? 24 : (level >= 13 ? 12 : (level >= 9 ? 8 : (level >= 3 ? 4 : 0))));
  { const char* e = getenv("ZN_DEPTH"); if (e) depth = atoi(e); }
  if (depth) M.enable_chain(prefix_n + n);
  if (level >= opt_e) M.enable_bt(prefix_n + n, false);
  if (g_ldm && level < 15) M.enable_ldm();
  if (prefix_n) {
    // Index the prefix so matches can reach into it.
    const u8* p = base;
    const u8* pe = base + (prefix_n > 8 ? prefix_n - 8 : 0);
    OptCand dummy[1];
    const u8* hend = base + prefix_n + n;  // buffer holds prefix + data
    for (; p < pe; p++) {
      size_t po = (size_t)(p - base);
      u32 hp = M.hash_short(p);
      if (depth) M.chain[po] = M.table[hp];
      M.table[hp] = (i32)po;
      if (M.probe4) M.table4[Matcher::hash4n(p)] = (i32)po;
      if (hend - p >= 16) M.table2[Matcher::hash16(p)] = (i32)po;
      M.ldm_insert(base, p, hend);
      if (!M.btree.empty()) {
        M.table3[Matcher::hash3(p)] = (i32)po;
        bt_insert_search(base, p, base + prefix_n, M, 24, dummy, false, 4096);
      }
    }
  }
  u32 reps[3] = {1, 4, 8};
  std::vector<Seq> seqs;
  std::vector<u8> lits;
  size_t pos = 0;
  size_t nblocks = n ? (n + BLOCK_MAX - 1) / BLOCK_MAX : 1;
  for (size_t b = 0; b < nblocks; b++) {
    size_t blen = std::min(BLOCK_MAX, n - pos);
    bool last = b == nblocks - 1;
    const u8* bp = src + pos;
    // RLE block?
    bool rle = blen > 0;
    for (size_t i = 1; i < blen && rle; i++) rle = bp[i] == bp[0];
    if (rle && blen > 1) {
      u32 h = (u32)((blen << 3) | (1u << 1) | (last ? 1 : 0));
      out.push_back((u8)h); out.push_back((u8)(h >> 8)); out.push_back((u8)(h >> 16));
      out.push_back(bp[0]);
      pos += blen;
      continue;
    }
    seqs.clear();
    lits.clear();
    u32 reps_in[3] = {reps[0], reps[1], reps[2]};
    int lazy = level >= 13 ? 3 : (level >= 10 ? 2 : (level >= 3 ? 1 : 0));
    { const char* e = getenv("ZN_LAZY"); if (e) lazy = atoi(e); }
#ifdef ZN_ENCPROF
    unsigned long long _pt0 = __rdtsc();
#endif
    if (level >= opt_e)
      parse_block_opt(base, prefix_n + pos, blen, M, reps, seqs, lits, depth);
    else if (level <= 1 && !prefix_n)
      parse_block_l1(base, prefix_n + pos, blen, M, reps, seqs, lits);
    else
      parse_block(base, prefix_n + pos, blen, M, reps, seqs, lits, lazy, depth);
#ifdef ZN_ENCPROF
    zn_encprof[0] += __rdtsc() - _pt0; zn_encprof[3] += seqs.size();
    zn_encprof[4] += lits.size(); _pt0 = __rdtsc();
#endif
    static thread_local std::vector<u8> body;
    body.clear();
    write_literals_section(body, lits.data(), lits.size());
#ifdef ZN_ENCPROF
    zn_encprof[1] += __rdtsc() - _pt0; _pt0 = __rdtsc();
#endif
    write_sequences_section(body, seqs);
#ifdef ZN_ENCPROF
    zn_encprof[2] += __rdtsc() - _pt0;
#endif
    if (level >= opt_e) {
      // Price-seeded DP can settle into a degenerate all-literal fixed
      // point on data whose matches are short (numeric/structured text:
      // entropy-coded digits price close to short-match costs). Race the
      // lazy parser per block and keep the smaller ACTUAL encoding — the
      // optimal parser is then never worse than the lazy levels.
      static thread_local std::vector<Seq> seqs2;
      static thread_local std::vector<u8> lits2;
      seqs2.clear();
      lits2.clear();
      u32 reps2[3] = {reps_in[0], reps_in[1], reps_in[2]};
      parse_block(base, prefix_n + pos, blen, M, reps2, seqs2, lits2, 3, 0);
      std::vector<u8> body2;
      write_literals_section(body2, lits2.data(), lits2.size());
      write_sequences_section(body2, seqs2);
      if (body2.size() < body.size()) {
        body.swap(body2);
        reps[0] = reps2[0]; reps[1] = reps2[1]; reps[2] = reps2[2];
      }
    }
    if (body.size() >= blen || body.size() >= (1u << 21)) {
      // raw fallback; repeat history must not advance
      reps[0] = reps_in[0]; reps[1] = reps_in[1]; reps[2] = reps_in[2];
      u32 h = (u32)((blen << 3) | (0u << 1) | (last ? 1 : 0));
      out.push_back((u8)h); out.push_back((u8)(h >> 8)); out.push_back((u8)(h >> 16));
      out.insert(out.end(), bp, bp + blen);
    } else {
      u32 h = (u32)((body.size() << 3) | (2u << 1) | (last ? 1 : 0));
      out.push_back((u8)h); out.push_back((u8)(h >> 8)); out.push_back((u8)(h >> 16));
      out.insert(out.end(), body.begin(), body.end());
    }
    pos += blen;
  }
  if (checksum) {
    u32 c = (u32)zn_xxh64(src, n, 0);
    out.push_back((u8)c); out.push_back((u8)(c >> 8));
    out.push_back((u8)(c >> 16)); out.push_back((u8)(c >> 24));
  }
  if (out.size() > cap) return (size_t)-1;
  memcpy(dst, out.data(), out.size());
  return out.size();
}

// Host-decision accelerators for the TPU archive pipeline: build one
// Huffman tree (package-merge lengths + canonical codes + serialized
// weights) or one dedicated FSE encode table from a histogram, through
// ctypes — the Python twins dominated the pipeline\'s host phase
// (~0.35 s + ~0.13 s per 10 MiB archive).
extern "C" i64 zn_huf_table(const u32* hist, u8* tree_out, size_t tree_cap,
                            u32* codes_out, u8* nb_out) {
  ensure_defaults();
  HufEncTable t;
  if (!huf_build_enc(hist, &t)) return -1;
  std::vector<u8> tree;
  if (!huf_write_weights(tree, &t)) return -1;
  if (tree.size() > tree_cap) return -1;
  memcpy(tree_out, tree.data(), tree.size());
  for (int s = 0; s < 256; s++) codes_out[s] = t.codes[s];
  memcpy(nb_out, t.nbits, 256);
  return (i64)tree.size();
}

// One Huffman-coded literal stream, decoded with a caller-provided
// direct table (symbol/nbits arrays of size 1<<max_bits, the layout the
// Python codec's build_decode_table produces). Serves the TPU decode
// pipeline: decoding the literal pool host-side (~us per stream) beats
// the device round trip by orders of magnitude on this link, and the
// assembled pool uploads once. Returns 0, or -1 on a malformed stream.
extern "C" int zn_huf_stream_decode(const u8* stream, size_t sn,
                                    const u8* sym, const u8* nbt,
                                    int max_bits, u8* out, size_t on) {
  if (max_bits < 1 || max_bits > HUF_MAX_BITS) return -1;
  BitReaderBack br(stream, sn);
  if (!br.ok) return -1;
  const int mb = max_bits;
  size_t i = 0;
  // Fast path: one 8-byte load serves up to 4 symbols (<= 44 bits).
  while (i + 4 <= on && br.rem >= 57) {
    i64 lo = br.rem - 57;
    u64 w;
    memcpy(&w, stream + (lo >> 3), 8);
    w >>= (lo & 7);
    int cur = 57;
    for (int k = 0; k < 4; k++) {
      u32 idx = (u32)((w >> (cur - mb)) & ((1u << mb) - 1));
      out[i + k] = sym[idx];
      cur -= nbt[idx];
    }
    br.rem -= 57 - cur;
    i += 4;
  }
  for (; i < on; i++) {
    u32 idx = br.read(mb);
    br.rem += mb - nbt[idx];
    out[i] = sym[idx];
  }
  return br.rem == 0 ? 0 : -1;
}

extern "C" int zn_fse_enc_table(const short* norm, int nsym, int log,
                                int* dnb_out, int* dfs_out,
                                unsigned short* stt_out) {
  ensure_defaults();
  FseEncTable t;
  i16 n16[64];
  for (int i = 0; i < nsym && i < 64; i++) n16[i] = (i16)norm[i];
  if (!fse_build_enc(n16, nsym, log, &t)) return -1;
  memcpy(dnb_out, t.delta_nb, 64 * sizeof(int));
  memcpy(dfs_out, t.delta_fs, 64 * sizeof(int));
  memcpy(stt_out, t.state_table, 512 * sizeof(unsigned short));
  return 0;
}

// Streaming frame context: one compressed BLOCK per call, so the
// caller can watch the frame\'s compressed size grow and cut when the
// FrameSizePolicy::Compressed threshold is reached — the reference
// checks after each compress_stream2 chunk (lib/src/encode.rs:15-39,
// 537-544); here the granularity is one 128 KiB block. The header
// declares no content size (unknown until the cut) and a fixed 16 MiB
// window; the caller must cut the frame at 16 MiB of input so every
// match offset stays inside the declared window.
struct ZnStream {
  Matcher M;
  int level = 1;
  int checksum = 0;
  int depth = 0;
  u32 reps[3] = {1, 4, 8};
  std::vector<u8> hist;  // frame input so far (the match window)
};

static const u64 ZN_STREAM_DCAP = 1ull << 24;

extern "C" void* zn_stream_new(int level, int checksum) {
  ensure_defaults();
  ZnStream* s = new ZnStream();
  s->level = level;
  s->checksum = checksum;
  if (level >= 2) s->M.probe4 = true;
  s->depth = level >= 19 ? 512 : level >= 17 ? 64 : (level >= 15 ? 24 : (level >= 13 ? 12 : (level >= 9 ? 8 : (level >= 3 ? 4 : 0))));
  if (s->depth) s->M.enable_chain(ZN_STREAM_DCAP);
  if (level >= 15) s->M.enable_bt(ZN_STREAM_DCAP, false);
  s->hist.reserve(1 << 20);
  return s;
}

extern "C" void zn_stream_free(void* h) { delete (ZnStream*)h; }

extern "C" i64 zn_stream_header(void* h, u8* dst, size_t cap) {
  ZnStream* s = (ZnStream*)h;
  if (cap < 6) return -1;
  dst[0] = 0x28; dst[1] = 0xB5; dst[2] = 0x2F; dst[3] = 0xFD;
  dst[4] = s->checksum ? 0x04 : 0x00;  // FCS absent, not single-segment
  dst[5] = (u8)((24 - 10) << 3);       // window descriptor: 2^24
  return 6;
}

extern "C" i64 zn_stream_block(void* h, const u8* src, size_t n, u8* dst,
                               size_t cap) {
  ZnStream* s = (ZnStream*)h;
  if (n == 0 || n > BLOCK_MAX) return -1;
  if (s->hist.size() + n > ZN_STREAM_DCAP) return -1;
  size_t pos = s->hist.size();
  s->hist.insert(s->hist.end(), src, src + n);
  const u8* base = s->hist.data();
  const u8* bp = base + pos;
  std::vector<u8> out;
  bool rle = n > 1;
  for (size_t i = 1; i < n && rle; i++) rle = bp[i] == bp[0];
  if (rle) {
    u32 hd = (u32)((n << 3) | (1u << 1));
    out.push_back((u8)hd); out.push_back((u8)(hd >> 8)); out.push_back((u8)(hd >> 16));
    out.push_back(bp[0]);
  } else {
    static thread_local std::vector<Seq> seqs;
    static thread_local std::vector<u8> lits;
    seqs.clear();
    lits.clear();
    u32 reps_in[3] = {s->reps[0], s->reps[1], s->reps[2]};
    int lazy = s->level >= 13 ? 3 : (s->level >= 10 ? 2 : (s->level >= 3 ? 1 : 0));
    if (s->level >= 15)
      parse_block_opt(base, pos, n, s->M, s->reps, seqs, lits, s->depth);
    else if (s->level <= 1)
      parse_block_l1(base, pos, n, s->M, s->reps, seqs, lits);
    else
      parse_block(base, pos, n, s->M, s->reps, seqs, lits, lazy, s->depth);
    static thread_local std::vector<u8> body;
    body.clear();
    write_literals_section(body, lits.data(), lits.size());
    write_sequences_section(body, seqs);
    if (body.size() >= n || body.size() >= (1u << 21)) {
      // raw fallback; repeat history must not advance
      s->reps[0] = reps_in[0]; s->reps[1] = reps_in[1]; s->reps[2] = reps_in[2];
      u32 hd = (u32)((n << 3) | (0u << 1));
      out.push_back((u8)hd); out.push_back((u8)(hd >> 8)); out.push_back((u8)(hd >> 16));
      out.insert(out.end(), bp, bp + n);
    } else {
      u32 hd = (u32)((body.size() << 3) | (2u << 1));
      out.push_back((u8)hd); out.push_back((u8)(hd >> 8)); out.push_back((u8)(hd >> 16));
      out.insert(out.end(), body.begin(), body.end());
    }
  }
  if (out.size() > cap) return -1;
  memcpy(dst, out.data(), out.size());
  return (i64)out.size();
}

extern "C" i64 zn_stream_end(void* h, u8* dst, size_t cap) {
  // Empty raw Last_Block + optional content checksum over the frame.
  ZnStream* s = (ZnStream*)h;
  size_t need = 3 + (s->checksum ? 4 : 0);
  if (cap < need) return -1;
  dst[0] = 1; dst[1] = 0; dst[2] = 0;
  if (s->checksum) {
    u32 c = (u32)zn_xxh64(s->hist.data(), s->hist.size(), 0);
    dst[3] = (u8)c; dst[4] = (u8)(c >> 8);
    dst[5] = (u8)(c >> 16); dst[6] = (u8)(c >> 24);
  }
  return (i64)need;
}

// ------------------------------------------------------------- decoder ----

#ifdef ZN_PROF
#include <x86intrin.h>
static thread_local unsigned long long zn_prof_lit = 0, zn_prof_seq = 0,
                                       zn_prof_hdr = 0, zn_prof_sum = 0;
extern "C" void zn_prof_get(unsigned long long* out4) {
  out4[0] = zn_prof_lit; out4[1] = zn_prof_seq;
  out4[2] = zn_prof_hdr; out4[3] = zn_prof_sum;
}
extern "C" void zn_prof_reset() {
  zn_prof_lit = zn_prof_seq = zn_prof_hdr = zn_prof_sum = 0;
}
#define ZN_TSC(var, expr) do { unsigned long long _t0 = __rdtsc(); expr; var += __rdtsc() - _t0; } while (0)
#else
#define ZN_TSC(var, expr) expr
#endif

struct DecCtx {
  FseDecTable ll, of, ml;
  bool ll_ok = false, of_ok = false, ml_ok = false;
  HufDecTable huf;
  bool huf_ok = false;
};

// Reads one symbol table per its mode; returns bytes consumed or -1.
static ptrdiff_t read_symbol_table(const u8* p, size_t len, int mode,
                                   int max_code, int max_log,
                                   const FseDecTable* def, FseDecTable* slot,
                                   bool* have, const FseDecTable** out) {
  if (mode == 0) { *out = def; return 0; }
  if (mode == 1) {
    if (!len) return -1;
    int sym = p[0];
    if (sym > max_code) return -1;
    slot->log = 0;
    slot->symbol[0] = (u8)sym;
    slot->nbits[0] = 0;
    slot->baseline[0] = 0;
    slot->packed[0] = (u32)sym;
    fill_packed2(slot, max_code);
    *have = true;
    *out = slot;
    return 1;
  }
  if (mode == 2) {
    i16 norm[64]; int nsym, log;
    size_t c = fse_read_ncount(p, len, max_code, max_log, norm, &nsym, &log);
    if (!c) return -1;
    if (!fse_build_dec(norm, nsym, log, slot)) return -1;
    fill_packed2(slot, max_code);
    *have = true;
    *out = slot;
    return (ptrdiff_t)c;
  }
  if (!*have) return -1;
  *out = slot;
  return 0;
}

// Decompress one frame at src; returns output size or -1; *consumed set.
extern "C" i64 zn_decompress_frame(const u8* src, size_t n, u8* dst,
                                   size_t cap, const u8* prefix,
                                   size_t prefix_n, size_t* consumed) {
  ensure_defaults();
  if (n < 4) return -1;
  u32 magic = read32(src);
  if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {  // skippable
    if (n < 8) return -1;
    u32 sz = read32(src + 4);
    if (8 + (u64)sz > n) return -1;
    *consumed = 8 + sz;
    return 0;
  }
  if (magic != 0xFD2FB528u) return -1;
  if (n < 6) return -1;
  u8 fhd = src[4];
  size_t pos = 5;
  bool single = fhd & 0x20;
  if (fhd & 0x08) return -1;
  bool has_checksum = fhd & 0x04;
  int did_bytes_tab[4] = {0, 1, 2, 4};
  int did_bytes = did_bytes_tab[fhd & 3];
  int fcs_flag = fhd >> 6;
  if (!single) {
    if (pos >= n) return -1;
    pos++;  // window descriptor (we use the declared content size instead)
  }
  pos += did_bytes;
  int fcs_bytes_tab[4] = {0, 2, 4, 8};
  int fcs_bytes = fcs_bytes_tab[fcs_flag];
  if (fcs_flag == 0 && single) fcs_bytes = 1;
  u64 content_size = (u64)-1;
  if (fcs_bytes) {
    if (pos + fcs_bytes > n) return -1;
    content_size = 0;
    for (int i = 0; i < fcs_bytes; i++) content_size |= (u64)src[pos + i] << (8 * i);
    if (fcs_bytes == 2) content_size += 256;
    pos += fcs_bytes;
  }

  // Output placement: when there is no prefix and the content size is
  // declared and fits the caller's buffer, decode IN PLACE into dst --
  // wild copies switch to an exact tail path near the end. Otherwise use
  // a scratch window (prefix support / unknown size) and copy out at the
  // end. In-place saves two full passes over the output (zeroing +
  // copy-out), the decoder's main bandwidth overhead vs. libzstd.
  // A declared size beyond the caller's buffer can only fail; reject it
  // before sizing any allocation by it (corrupt headers must not drive
  // multi-GB resizes).
  if (content_size != (u64)-1 && content_size > cap) return -1;
  u64 est = content_size != (u64)-1 ? content_size : (u64)n * 16 + (1u << 20);
  if (est > cap) est = cap;
  bool in_place = prefix_n == 0 && content_size != (u64)-1 && content_size <= cap;
  std::vector<u8> win;
  u8* wp;
  u8* wlimit;   // exact end of writable output
  const u8* wbase;
  if (in_place) {
    wp = dst;
    wlimit = dst + content_size;
    wbase = dst;
  } else {
    win.resize(prefix_n + est + 64);
    if (prefix_n) memcpy(win.data(), prefix, prefix_n);
    wp = win.data() + prefix_n;          // write head
    wlimit = win.data() + win.size() - 64;
    wbase = win.data();
  }

  DecCtx ctx;
  u32 reps[3] = {1, 4, 8};
  std::vector<u8> lits;
#ifdef ZN_PROF
  unsigned long long _ft0 = __rdtsc();
#endif
  for (;;) {
    if (pos + 3 > n) return -1;
    u32 bh = src[pos] | (src[pos + 1] << 8) | ((u32)src[pos + 2] << 16);
    pos += 3;
    bool last = bh & 1;
    int btype = (bh >> 1) & 3;
    size_t bsize = bh >> 3;
    if (btype == 3) return -1;
    if (btype == 0) {
      if (pos + bsize > n || wp + bsize > wlimit) return -1;
      memcpy(wp, src + pos, bsize);
      wp += bsize;
      pos += bsize;
    } else if (btype == 1) {
      if (pos >= n || wp + bsize > wlimit) return -1;
      memset(wp, src[pos], bsize);
      wp += bsize;
      pos++;
    } else {
      if (pos + bsize > n || bsize > BLOCK_MAX + 32) return -1;
      const u8* bp = src + pos;
      size_t blen = bsize;
      pos += bsize;
      // literals section
      if (!blen) return -1;
      int lit_type = bp[0] & 3;
      int size_format = (bp[0] >> 2) & 3;
      size_t regen, compsz = 0, hlen;
      bool four = false;
      if (lit_type <= 1) {
        if (size_format == 0 || size_format == 2) { regen = bp[0] >> 3; hlen = 1; }
        else if (size_format == 1) {
          if (blen < 2) return -1;
          regen = (bp[0] >> 4) | ((size_t)bp[1] << 4); hlen = 2;
        } else {
          if (blen < 3) return -1;
          regen = (bp[0] >> 4) | ((size_t)bp[1] << 4) | ((size_t)bp[2] << 12); hlen = 3;
        }
      } else {
        u64 v = 0;
        if (size_format == 0) { hlen = 3; }
        else if (size_format == 1) { hlen = 3; four = true; }
        else if (size_format == 2) { hlen = 4; four = true; }
        else { hlen = 5; four = true; }
        if (blen < hlen) return -1;
        for (size_t i = 0; i < hlen; i++) v |= (u64)bp[i] << (8 * i);
        if (hlen == 3) { regen = (v >> 4) & 0x3FF; compsz = (v >> 14) & 0x3FF; }
        else if (hlen == 4) { regen = (v >> 4) & 0x3FFF; compsz = (v >> 18) & 0x3FFF; }
        else { regen = (v >> 4) & 0x3FFFF; compsz = (v >> 22) & 0x3FFFF; }
      }
      const u8* lp = bp + hlen;
      size_t lrem = blen - hlen;
      size_t lit_n = regen;
      const u8* litp;  // literal bytes + 32B readable slack for wild copies
      if (lit_type == 0) {
        if (lrem < regen) return -1;
        if (lp + regen + 32 <= src + n) {
          litp = lp;  // zero-copy: sequences execute straight from src
        } else {
          lits.assign(lp, lp + regen);
          lits.resize(regen + 32);
          litp = lits.data();
        }
        lp += regen; lrem -= regen;
      } else if (lit_type == 1) {
        if (lrem < 1) return -1;
        lits.assign(regen + 32, lp[0]);
        litp = lits.data();
        lp += 1; lrem -= 1;
      } else {
        if (lrem < compsz) return -1;
        const u8* payload = lp;
        size_t prem = compsz;
        lp += compsz; lrem -= compsz;
        if (lit_type == 2) {
          // Huffman tree description
          if (!prem) return -1;
          u8 hb = payload[0];
          if (hb >= 128) {
            int nw = hb - 127;
            size_t nb = (nw + 1) / 2;
            if (prem < 1 + nb) return -1;
            u8 weights[256];
            for (int i = 0; i < nw; i++) {
              u8 byte = payload[1 + i / 2];
              weights[i] = (i & 1) ? (byte & 0xF) : (byte >> 4);
            }
            // implied last weight
            u32 total = 0;
            for (int i = 0; i < nw; i++) total += weights[i] ? 1u << (weights[i] - 1) : 0;
            if (!total) return -1;
            // Next power of two STRICTLY above total (the implied weight is >= 1).
            int mb = highbit(total) + 1;
            u32 left = (1u << mb) - total;
            if (!left || (left & (left - 1))) return -1;
            weights[nw] = (u8)(highbit(left) + 1);
            if (!huf_build_dec(weights, nw + 1, &ctx.huf)) return -1;
            ctx.huf_ok = true;
            payload += 1 + nb; prem -= 1 + nb;
          } else {
            // FSE-compressed weights
            if (prem < 1u + hb) return -1;
            i16 norm[16]; int nsym, log;
            size_t c = fse_read_ncount(payload + 1, hb, 15, 6, norm, &nsym, &log);
            if (!c) return -1;
            FseDecTable wt;
            if (!fse_build_dec(norm, nsym, log, &wt)) return -1;
            BitReaderBack br(payload + 1 + c, hb - c);
            if (!br.ok) return -1;
            int s1 = (int)br.read(wt.log), s2 = (int)br.read(wt.log);
            if (br.rem < 0) return -1;
            u8 weights[257]; int k = 0;
            for (;;) {
              if (k > 254) return -1;
              weights[k++] = wt.symbol[s1];
              s1 = wt.baseline[s1] + (int)br.read(wt.nbits[s1]);
              if (br.rem < 0) { weights[k++] = wt.symbol[s2]; break; }
              weights[k++] = wt.symbol[s2];
              s2 = wt.baseline[s2] + (int)br.read(wt.nbits[s2]);
              if (br.rem < 0) { weights[k++] = wt.symbol[s1]; break; }
            }
            u32 total = 0;
            for (int i = 0; i < k; i++) total += weights[i] ? 1u << (weights[i] - 1) : 0;
            if (!total) return -1;
            int mb = highbit(total) + 1;
            u32 left = (1u << mb) - total;
            if (!left || (left & (left - 1))) return -1;
            weights[k] = (u8)(highbit(left) + 1);
            if (!huf_build_dec(weights, k + 1, &ctx.huf)) return -1;
            ctx.huf_ok = true;
            payload += 1 + hb; prem -= 1 + hb;
          }
        }
        if (!ctx.huf_ok) return -1;
        // streams
        lits.resize(regen + 32);
        litp = lits.data();
        auto dec_stream = [&](const u8* sp, size_t sn, u8* op, size_t on) -> bool {
          BitReaderBack br(sp, sn);
          if (!br.ok) return false;
          const int mb = ctx.huf.max_bits;
          const u8* sym = ctx.huf.symbol;
          const u8* nbt = ctx.huf.nbits;
          size_t i = 0;
          // Fast path: one 8-byte load serves up to 4 symbols (<= 44 bits).
          while (i + 4 <= on && br.rem >= 57) {
            i64 lo = br.rem - 57;
            u64 w;
            memcpy(&w, sp + (lo >> 3), 8);
            w >>= (lo & 7);
            int cur = 57;
            for (int k = 0; k < 4; k++) {
              u32 idx = (u32)((w >> (cur - mb)) & ((1u << mb) - 1));
              op[i + k] = sym[idx];
              cur -= nbt[idx];
            }
            br.rem -= 57 - cur;
            i += 4;
          }
          for (; i < on; i++) {
            u32 idx = br.read(mb);
            br.rem += mb - nbt[idx];
            op[i] = sym[idx];
          }
          return br.rem == 0;
        };
#ifdef ZN_PROF
        unsigned long long _lt0 = __rdtsc();
#endif
        if (four) {
          if (prem < 6) return -1;
          size_t s1 = payload[0] | (payload[1] << 8);
          size_t s2 = payload[2] | (payload[3] << 8);
          size_t s3 = payload[4] | (payload[5] << 8);
          if (6 + s1 + s2 + s3 > prem) return -1;
          size_t s4 = prem - 6 - s1 - s2 - s3;
          size_t seg = (regen + 3) / 4;
          if (3 * seg > regen) {
            if (regen < 3) return -1;
          }
          const u8* q = payload + 6;
          if (!dec_stream(q, s1, lits.data(), seg)) return -1;
          if (!dec_stream(q + s1, s2, lits.data() + seg, seg)) return -1;
          if (!dec_stream(q + s1 + s2, s3, lits.data() + 2 * seg, seg)) return -1;
          if (!dec_stream(q + s1 + s2 + s3, s4, lits.data() + 3 * seg, regen - 3 * seg)) return -1;
        } else {
          if (!dec_stream(payload, prem, lits.data(), regen)) return -1;
        }
#ifdef ZN_PROF
        zn_prof_lit += __rdtsc() - _lt0;
#endif
      }
      // sequences
      if (!lrem) return -1;
      size_t nseq;
      if (lp[0] < 128) { nseq = lp[0]; lp++; lrem--; }
      else if (lp[0] < 255) {
        if (lrem < 2) return -1;
        nseq = ((size_t)(lp[0] - 128) << 8) + lp[1]; lp += 2; lrem -= 2;
      } else {
        if (lrem < 3) return -1;
        nseq = lp[1] + ((size_t)lp[2] << 8) + 0x7F00; lp += 3; lrem -= 3;
      }
      if (nseq == 0) {
        if (wp + lit_n > wlimit) return -1;
        memcpy(wp, litp, lit_n);
        wp += lit_n;
      } else {
        if (!lrem) return -1;
        u8 modes = lp[0];
        if (modes & 3) return -1;
        lp++; lrem--;
        const FseDecTable *llt, *oft, *mlt;
        ptrdiff_t c;
        c = read_symbol_table(lp, lrem, (modes >> 6) & 3, 35, 9, &g_ll_def_dec, &ctx.ll, &ctx.ll_ok, &llt);
        if (c < 0) return -1; lp += c; lrem -= c;
        c = read_symbol_table(lp, lrem, (modes >> 4) & 3, 31, 8, &g_of_def_dec, &ctx.of, &ctx.of_ok, &oft);
        if (c < 0) return -1; lp += c; lrem -= c;
        c = read_symbol_table(lp, lrem, (modes >> 2) & 3, 52, 9, &g_ml_def_dec, &ctx.ml, &ctx.ml_ok, &mlt);
        if (c < 0) return -1; lp += c; lrem -= c;

#ifdef ZN_PROF
        unsigned long long _st0 = __rdtsc();
#endif
        BitReaderBack br(lp, lrem);
        if (!br.ok) return -1;
        int ll_s = (int)br.read(llt->log);
        int of_s = (int)br.read(oft->log);
        int ml_s = (int)br.read(mlt->log);
        if (br.rem < 0) return -1;
        size_t lit_pos = 0;
        size_t i = 0;
        // Fast path: while at least one more sequence follows and >=57
        // payload bits remain, a single unaligned 8-byte window usually
        // covers this sequence's extra bits AND the three state updates
        // (one load instead of two bounds-checked read_wides). Rep-offset
        // history updates are branchless (cmov-friendly selects) because
        // rep-vs-real alternates unpredictably on text.
        {
          const u8* bs = br.start;
          const size_t bl = br.len;
          while (i + 1 < nseq && br.rem >= 57) {
            u32 ofe = oft->packed[of_s];
            u64 mle2 = mlt->packed2[ml_s];
            u64 lle2 = llt->packed2[ll_s];
            // Codes from decode tables are range-validated at build time, so
            // no per-sequence bounds check is needed here (slow path keeps
            // one as a safety net). The fused packed2 entries carry
            // (value_base, extra_bits, state_bits, state_base) in one load.
            int of_code = ofe & 0xFF;
            int mlb = (int)((mle2 >> 20) & 63), llb = (int)((lle2 >> 20) & 63);
            int eb = of_code + mlb + llb;
            int lb = (int)((lle2 >> 26) & 0xFF), mb2 = (int)((mle2 >> 26) & 0xFF), ob = (ofe >> 8) & 0xFF;
            int ub = lb + mb2 + ob;
            if (eb + ub > 57) break;  // rare giant offset: slow path finishes
            i64 lo = br.rem - 57;
            u64 w;
            memcpy(&w, bs + (lo >> 3), 8);
            w >>= (lo & 7);  // bits [br.rem-57, br.rem) in the top 57
            u64 extras = (w >> (57 - eb)) & ((1ULL << eb) - 1);
            u64 upd = (w >> (57 - eb - ub)) & ((1ULL << ub) - 1);
            u32 ofv = (1u << of_code) + (u32)(extras >> (mlb + llb));
            u32 mlv = (u32)(mle2 & 0xFFFFF) + (u32)((extras >> llb) & ((1u << mlb) - 1));
            u32 llv = (u32)(lle2 & 0xFFFFF) + (u32)(extras & ((1u << llb) - 1));
            // Leave all state untouched before this break: the slow loop
            // below re-decodes this sequence from the same bit position.
            if (wp + llv + mlv + 32 > wlimit) break;  // near the end: exact path
            br.rem -= eb + ub;
            ll_s = (int)((lle2 >> 34) & 0xFFFF) + (int)(upd >> (mb2 + ob));
            ml_s = (int)((mle2 >> 34) & 0xFFFF) + (int)((upd >> ob) & ((1u << mb2) - 1));
            of_s = (int)(ofe >> 16) + (int)(upd & ((1u << ob) - 1));
            // Branchy repeat-offset resolution (predictable on rep-heavy
            // own streams).
            u32 off;
            if (ofv > 3) {
              off = ofv - 3;
              reps[2] = reps[1]; reps[1] = reps[0]; reps[0] = off;
            } else {
              u32 idx2 = ofv + (llv == 0 ? 1u : 0u);
              if (idx2 == 1) off = reps[0];
              else if (idx2 == 2) { off = reps[1]; reps[1] = reps[0]; reps[0] = off; }
              else if (idx2 == 3) { off = reps[2]; reps[2] = reps[1]; reps[1] = reps[0]; reps[0] = off; }
              else { off = reps[0] - 1; reps[2] = reps[1]; reps[1] = reps[0]; reps[0] = off; }
            }
            if (!off) return -1;
            if (lit_pos + llv > lit_n) return -1;
            {
              const u8* q = litp + lit_pos;
              u8* o = wp;
              memcpy(o, q, 16);
              if (llv > 16) {
                memcpy(o + 16, q + 16, 16);
                for (size_t k = 32; k < llv; k += 32) {
                  memcpy(o + k, q + k, 16);
                  memcpy(o + k + 16, q + k + 16, 16);
                }
              }
              wp += llv;
              lit_pos += llv;
            }
            if (mlv) {
              if ((size_t)(wp - wbase) < off) return -1;
              const u8* q = wp - off;
              u8* o = wp;
              wp += mlv;
              if (off >= 16) {
                memcpy(o, q, 16);
                if (mlv > 16) {
                  memcpy(o + 16, q + 16, 16);
                  for (u32 k = 32; k < mlv; k += 32) {
                    memcpy(o + k, q + k, 16);
                    memcpy(o + k + 16, q + k + 16, 16);
                  }
                }
              } else if (off >= 8) {
                memcpy(o, q, 8);
                for (u32 k = 8; k < mlv; k += 8) memcpy(o + k, q + k, 8);
              } else {
                // Overlapping copy: write the first 8 bytes with byte/4-byte
                // copies (shifted source keeps the 4-byte copy overlap-free),
                // then continue at distance D = off*ceil(8/off) >= 8, which
                // preserves the period while allowing 8-byte steps.
                static const int sft4[8] = {0, 1, 2, 1, 4, 4, 4, 4};
                static const u32 DT[8] = {8, 8, 8, 9, 8, 10, 12, 14};
                o[0] = q[0]; o[1] = q[1]; o[2] = q[2]; o[3] = q[3];
                memcpy(o + 4, q + sft4[off], 4);
                const u8* q2 = o + 8 - DT[off];
                for (u32 k = 8; k < mlv; k += 8) memcpy(o + k, q2 + k - 8, 8);
              }
            }
            i++;
          }
          (void)bl;
        }
        for (; i < nseq; i++) {
          u32 ofe = oft->packed[of_s];
          u32 mle = mlt->packed[ml_s];
          u32 lle = llt->packed[ll_s];
          int of_code = ofe & 0xFF;
          int ml_code = mle & 0xFF;
          int ll_code = lle & 0xFF;
          if (of_code > 31 || ml_code > 52 || ll_code > 35) return -1;
          int mlb = ML_BITS[ml_code], llb = LL_BITS[ll_code];
          u64 extras = br.read_wide(of_code + mlb + llb);
          u32 ofv = (1u << of_code) + (u32)(extras >> (mlb + llb));
          u32 mlv = ML_BASE[ml_code] + (u32)((extras >> llb) & ((1u << mlb) - 1));
          u32 llv = LL_BASE[ll_code] + (u32)(extras & ((1u << llb) - 1));
          u32 off;
          if (ofv > 3) {
            off = ofv - 3;
            reps[2] = reps[1]; reps[1] = reps[0]; reps[0] = off;
          } else {
            u32 idx2 = ofv + (llv == 0 ? 1 : 0);
            if (idx2 == 1) off = reps[0];
            else if (idx2 == 2) { off = reps[1]; reps[1] = reps[0]; reps[0] = off; }
            else if (idx2 == 3) { off = reps[2]; reps[2] = reps[1]; reps[1] = reps[0]; reps[0] = off; }
            else {
              off = reps[0] - 1;
              if (!off) return -1;
              reps[2] = reps[1]; reps[1] = reps[0]; reps[0] = off;
            }
          }
          if (i + 1 < nseq) {
            int lb = (lle >> 8) & 0xFF, mb2 = (mle >> 8) & 0xFF, ob = (ofe >> 8) & 0xFF;
            u64 upd = br.read_wide(lb + mb2 + ob);
            ll_s = (int)(lle >> 16) + (int)(upd >> (mb2 + ob));
            ml_s = (int)(mle >> 16) + (int)((upd >> ob) & ((1u << mb2) - 1));
            of_s = (int)(ofe >> 16) + (int)(upd & ((1u << ob) - 1));
          }
          // execute: wild 8-byte copies while >=32 bytes from the output
          // end, exact copies for the final stretch (in-place mode has no
          // slack past wlimit).
          if (lit_pos + llv > lit_n) return -1;
          if (wp + llv + mlv > wlimit) return -1;
          bool wild = wp + llv + mlv + 32 <= wlimit;
          {
            const u8* q = litp + lit_pos;
            u8* o = wp;
            if (wild) {
              // llv is usually tiny: one 16-byte store covers it.
              memcpy(o, q, 16);
              for (size_t k = 16; k < llv; k += 16) memcpy(o + k, q + k, 16);
            } else {
              memcpy(o, q, llv);
            }
            wp += llv;
            lit_pos += llv;
          }
          if (mlv) {
            if ((size_t)(wp - wbase) < off) return -1;
            const u8* q = wp - off;
            u8* o = wp;
            wp += mlv;
            if (wild && off >= 16) {
              memcpy(o, q, 16);
              for (u32 k = 16; k < mlv; k += 16) memcpy(o + k, q + k, 16);
            } else if (wild && off >= 8) {
              for (u32 k = 0; k < mlv; k += 8) memcpy(o + k, q + k, 8);
            } else {
              for (u32 k = 0; k < mlv; k++) o[k] = q[k];
            }
          }
        }
        if (br.rem != 0) return -1;
        if (lit_pos < lit_n) {
          size_t rest = lit_n - lit_pos;
          if (wp + rest > wlimit) return -1;
          memcpy(wp, litp + lit_pos, rest);
          wp += rest;
        }
#ifdef ZN_PROF
        zn_prof_seq += __rdtsc() - _st0;
#endif
      }
    }
    if (last) break;
  }
#ifdef ZN_PROF
  zn_prof_hdr += __rdtsc() - _ft0;
#endif
  const u8* out_start = in_place ? dst : win.data() + prefix_n;
  size_t out_n = (size_t)(wp - out_start);
  if (has_checksum) {
    if (pos + 4 > n) return -1;
    u32 stored = read32(src + pos);
    pos += 4;
    u32 calc;
    ZN_TSC(zn_prof_sum, calc = (u32)zn_xxh64(out_start, out_n, 0));
    if (stored != calc) return -2;
  }
  if (content_size != (u64)-1 && out_n != content_size) return -1;
  if (out_n > cap) return -1;
  if (!in_place) memcpy(dst, out_start, out_n);
  *consumed = pos;
  return (i64)out_n;
}

// -------------------------------------------- multi-threaded stream API ---

static int g_mt_level = 1;
extern "C" void zn_set_mt_level(int level) { g_mt_level = level; }

extern "C" i64 zn_compress_stream_mt(const u8* src, size_t n, u8* dst,
                                     size_t cap, size_t frame_size,
                                     int checksum, int nthreads,
                                     u32* frame_csizes /* per frame out */) {
  size_t nframes = n ? (n + frame_size - 1) / frame_size : 0;
  std::vector<std::vector<u8>> results(nframes);
  std::vector<size_t> starts(nframes);
  for (size_t i = 0; i < nframes; i++) starts[i] = i * frame_size;
  std::atomic_size_t next{0};
  auto worker = [&]() {
    for (;;) {
      size_t i = next.fetch_add(1);
      if (i >= nframes) break;
      size_t fn = std::min(frame_size, n - starts[i]);
      results[i].resize(fn + fn / 2 + 512);
      size_t r = zn_compress_frame(src + starts[i], fn, results[i].data(),
                                   results[i].size(), g_mt_level, checksum, nullptr, 0);
      if (r == (size_t)-1) { results[i].clear(); }
      else results[i].resize(r);
    }
  };
  int nt = nthreads > 0 ? nthreads : (int)std::thread::hardware_concurrency();
  if (nt < 1) nt = 1;
  std::vector<std::thread> pool;
  for (int t = 1; t < nt; t++) pool.emplace_back(worker);
  worker();
  for (auto& th : pool) th.join();
  size_t total = 0;
  for (size_t i = 0; i < nframes; i++) {
    if (results[i].empty() && std::min(frame_size, n - starts[i]) != 0) return -1;
    if (total + results[i].size() > cap) return -1;
    memcpy(dst + total, results[i].data(), results[i].size());
    if (frame_csizes) frame_csizes[i] = (u32)results[i].size();
    total += results[i].size();
  }
  return (i64)total;
}

extern "C" i64 zn_decompress_stream_mt(const u8* src, size_t n, u8* dst,
                                       size_t cap, const u64* frame_offsets,
                                       const u64* frame_dst_offsets,
                                       size_t nframes, int nthreads) {
  std::atomic_size_t next{0};
  std::atomic_bool failed{false};
  auto worker = [&]() {
    for (;;) {
      size_t i = next.fetch_add(1);
      if (i >= nframes || failed.load()) break;
      size_t fstart = frame_offsets[i];
      size_t fend = frame_offsets[i + 1];
      size_t dstart = frame_dst_offsets[i];
      size_t dend = frame_dst_offsets[i + 1];
      size_t consumed = 0;
      i64 r = zn_decompress_frame(src + fstart, fend - fstart, dst + dstart,
                                  dend - dstart, nullptr, 0, &consumed);
      if (r < 0 || (size_t)r != dend - dstart) failed.store(true);
    }
  };
  int nt = nthreads > 0 ? nthreads : (int)std::thread::hardware_concurrency();
  if (nt < 1) nt = 1;
  std::vector<std::thread> pool;
  for (int t = 1; t < nt; t++) pool.emplace_back(worker);
  worker();
  for (auto& th : pool) th.join();
  if (failed.load()) return -1;
  return (i64)(frame_dst_offsets[nframes]);
}

// ------------------------------------------- optimal parser (levels 15+) ---
//
// Forward dynamic program over block positions with entropy-estimated
// prices (libzstd's btopt idea, rebuilt): literals priced from the block
// histogram, each sequence priced as LL-code + ML-code + OF-code bits with
// the repeat-offset rules applied exactly as the sequence writer will
// (reference zeekstd delegates this to libzstd's ZSTD_opt.c). The DP
// tracks, per position on the best path, the full repeat-offset triple and
// the pending literal-run length, so rep matches and literal-length codes
// are priced truthfully. Candidates: 3-byte hash (near short matches),
// 6-byte hash chain, 16-byte long table, plus all three reps at every
// position. Prices refine between passes from the previous parse's actual
// code statistics (2 passes; 3 at the deepest search level).


// Insert ip into the suffix tree of its 4-byte bucket and (optionally)
// collect strictly-lengthening candidates along the walk. The tree keeps
// earlier same-bucket positions sorted by suffix, so each of the
// ``nb_compares`` steps halves the candidate set and byte comparisons
// resume from the shorter of the two boundary prefixes (amortized O(1)
// per step). Giant or end-reaching suffixes cannot be ordered and
// terminate the walk (their subtree is dropped — bounded worst case).
static int bt_insert_search(const u8* base, const u8* ip, const u8* iend,
                            Matcher& M, int nb_compares, OptCand* out,
                            bool collect, u32 rec_cap) {
  size_t cur = (size_t)(ip - base);
  u32 h = M.bt3 ? Matcher::hash3w(ip) : Matcher::hash4(ip);
  i32 prev = M.btroot[h];
  M.btroot[h] = (i32)cur;
  i32* leftP = &M.btree[2 * cur];
  i32* rightP = &M.btree[2 * cur + 1];
  u32 commonL = 0, commonR = 0;
  int n = 0;
  // min-match 3 trees record len-3 candidates too; 4-byte trees leave
  // len 3 to the near hash3 probe.
  u32 best = M.bt3 ? 2 : 3;
  while (prev >= 0 && nb_compares-- > 0) {
    const u8* pp = base + prev;
    u32 ml = commonL < commonR ? commonL : commonR;
    u32 l = ml + match_len(ip + ml, pp + ml, iend);
    if (collect && l > best && n < 20) {
      out[n++] = {l > rec_cap ? rec_cap : l, (u32)(cur - prev)};
      best = l;
    }
    if (ip + l >= iend || l > 4096) {
      *leftP = -1;
      *rightP = -1;
      return n;
    }
    if (pp[l] < ip[l]) {
      // prev's suffix sorts below cur: attach on the left, descend into
      // prev's right (larger) subtree.
      *leftP = prev;
      i32 nxt = M.btree[2 * prev + 1];
      leftP = &M.btree[2 * prev + 1];
      commonL = l;
      prev = nxt;
    } else {
      *rightP = prev;
      i32 nxt = M.btree[2 * prev];
      rightP = &M.btree[2 * prev];
      commonR = l;
      prev = nxt;
    }
  }
  *leftP = -1;
  *rightP = -1;
  return n;
}

static int gather_cands(const u8* base, const u8* ip, const u8* mlimit,
                        Matcher& M, int depth, OptCand* out,
                        bool probe = true) {
  int n = 0;
  size_t cur = (size_t)(ip - base);
  u32 h3 = Matcher::hash3(ip);
  if (!M.btree.empty()) {
    // Binary-tree path: 3-byte near probe + suffix-tree search. Insert-only
    // walks still thread the tree (cheaper: fewer compares).
    if (probe) {
      i32 c3 = M.table3[h3];
      M.table3[h3] = (i32)cur;
      if (c3 >= 0 && (size_t)c3 < cur && cur - c3 <= 1024 &&
          ((read32(base + c3) ^ read32(ip)) & 0xFFFFFF) == 0) {
        u32 l = match_len(ip, base + c3, mlimit);
        if (l >= 3) out[n++] = {l > 4096 ? 4096 : l, (u32)(cur - c3)};
      }
    } else {
      M.table3[h3] = (i32)cur;
    }
    n += bt_insert_search(base, ip, mlimit, M, probe ? depth * 8 : depth,
                          out + n, probe, 4096);
    return n;
  }
  u32 h = M.hash_short(ip);
  bool can16 = mlimit - ip >= 16;
  if (!probe) {
    // Insert-only fast path (interior of a long match): keep the tables
    // populated so later positions still find their candidates.
    if (!M.chain.empty() && (size_t)M.chain.size() > cur) M.chain[cur] = M.table[h];
    M.table[h] = (i32)cur;
    if (can16) M.table2[Matcher::hash16(ip)] = (i32)cur;
    M.table3[h3] = (i32)cur;
    return 0;
  }
  // Cap per-candidate scan: without this, overlapping giant matches make
  // the DP O(n*L). Long runs simply split into capped sequences.
  if (mlimit - ip > 4096) mlimit = ip + 4096;
  // 3-byte probe: only worth keeping when near (short matches only pay
  // off against small offset codes).
  i32 c3 = M.table3[h3];
  M.table3[h3] = (i32)cur;
  if (c3 >= 0 && (size_t)c3 < cur && cur - c3 <= 1024 &&
      ((read32(base + c3) ^ read32(ip)) & 0xFFFFFF) == 0) {
    u32 l = match_len(ip, base + c3, mlimit);
    if (l >= 3) out[n++] = {l, (u32)(cur - c3)};
  }
  i32 cand = M.table[h];
  if (!M.chain.empty() && (size_t)M.chain.size() > cur) M.chain[cur] = cand;
  M.table[h] = (i32)cur;
  u32 best_near = n ? out[0].len : 0;
  for (int t = 0; t <= depth && cand >= 0 && n < 14; t++) {
    if ((size_t)cand >= cur) {  // re-visit (multi-pass): skip self/future
      cand = M.chain.empty() ? -1 : M.chain[cand];
      continue;
    }
    if (read32(base + cand) == read32(ip)) {
      u32 l = match_len(ip, base + cand, mlimit);
      if (l >= 4 && l > best_near) {
        out[n++] = {l, (u32)(cur - cand)};
        best_near = l;
      }
    }
    cand = M.chain.empty() ? -1 : M.chain[cand];
  }
  if (can16) {
    u32 h2 = Matcher::hash16(ip);
    i32 c2 = M.table2[h2];
    M.table2[h2] = (i32)cur;
    if (c2 >= 0 && (size_t)c2 < cur && read32(base + c2) == read32(ip)) {
      u32 l = match_len(ip, base + c2, mlimit);
      if (l >= 4 && l > best_near) out[n++] = {l, (u32)(cur - c2)};
    }
  }
  return n;
}

// Repeat-offset triple update, mirroring the sequence writer exactly
// (which itself mirrors RFC 8878's decoder-side rules).
static inline void rep_transition(const u32 R[3], u32 O, u32 ll, u32 out[3]) {
  if (ll) {
    if (O == R[0]) { out[0] = R[0]; out[1] = R[1]; out[2] = R[2]; return; }
    if (O == R[1]) { out[0] = O; out[1] = R[0]; out[2] = R[2]; return; }
    out[0] = O; out[1] = R[0]; out[2] = R[1]; return;
  }
  if (O == R[1]) { out[0] = O; out[1] = R[0]; out[2] = R[2]; return; }
  out[0] = O; out[1] = R[0]; out[2] = R[1];
}

// Offset-code price of O given pending literal run ll and rep triple R:
// repcodes ride OF codes 0/1; everything else pays its offset bits.
static inline u32 off_price_of(u32 O, u32 ll, const u32 R[3],
                               const u16 of_price[32]) {
  if (ll) {
    if (O == R[0]) return of_price[0];
    if (O == R[1] || O == R[2]) return of_price[1];
  } else {
    if (O == R[1]) return of_price[0];
    if (O == R[2] || O + 1 == R[0]) return of_price[1];
  }
  return of_price[highbit(O + 3)];
}

// Parse one block optimally; appends to seqs/lits like parse_block.
static void parse_block_opt(const u8* src, size_t pos, size_t len, Matcher& M,
                            u32 reps[3], std::vector<Seq>& seqs,
                            std::vector<u8>& lits, int depth) {
  const u8* base = src;
  const u8* bp = src + pos;
  if (len < 32) {
    lits.insert(lits.end(), bp, bp + len);
    return;
  }
  const size_t n = len;
  // Literal prices (1/16-bit fixpoint) from the block histogram.
  u32 hist[256] = {0};
  for (size_t i = 0; i < n; i++) hist[bp[i]]++;
  u16 lit_price[256];
  double logn = log2((double)n);
  // At the deepest level, bias pass-0 literal prices upward: the refine
  // loop is a fixed-point iteration and the match-heavy basin (fewer
  // literals -> cheaper literal section AND denser ll=0 codes) is the
  // better optimum on most data; unbiased seeds converge literal-heavy.
  double lit_bias = 2.0;
  for (int b = 0; b < 256; b++) {
    double bits = hist[b] ? (logn - log2((double)hist[b])) + lit_bias : 12.0;
    if (bits < 1.0) bits = 1.0;
    if (bits > 14.0) bits = 14.0;
    lit_price[b] = (u16)(bits * 16);
  }
  u32 SEQ_OVERHEAD = 2 * 16;  // per-sequence state-update slack
  u16 ll_price[36];
  u16 ml_price[53];
  u16 of_price[32];
  for (int k = 0; k < 36; k++) ll_price[k] = (u16)((LL_BITS[k] + 4) * 16);
  for (int k = 0; k < 53; k++) ml_price[k] = (u16)((ML_BITS[k] + 4) * 16);
  for (int k = 0; k < 32; k++) of_price[k] = (u16)((k + 4) * 16);

  const u64 INF = ~0ULL;
  static thread_local std::vector<u64> price;
  static thread_local std::vector<u32> from_len, from_off;
  // Full rep triple + pending literal-run length along the best path.
  static thread_local std::vector<u32> rep0, rep1v, rep2v;
  static thread_local std::vector<u16> llrun;
  // Pass-1 table candidates are recorded and replayed in later passes (the
  // hash tables cannot be re-walked once fully populated). Rep candidates
  // are path-dependent so they are re-probed fresh every pass.
  static thread_local std::vector<OptCand> cand_store;
  static thread_local std::vector<u16> cand_cnt;
  cand_store.clear();
  cand_cnt.assign(n, 0);
  static thread_local std::vector<u32> cand_off_idx;
  cand_off_idx.assign(n, 0);
  static thread_local std::vector<u32> bt_len, bt_off;

  const int passes = depth >= 128 ? 6 : (depth >= 64 ? 3 : 2);
  size_t skip_gather_until = 0;
  for (int pass = 0; pass < passes; pass++) {
    price.assign(n + 1, INF);
    from_len.assign(n + 1, 0);
    from_off.assign(n + 1, 0);
    rep0.assign(n + 1, reps[0]);
    rep1v.assign(n + 1, reps[1]);
    rep2v.assign(n + 1, reps[2]);
    llrun.assign(n + 1, 0);
    price[0] = 0;

    const u8* mlimit = bp + n;
    const u8* search_end = n > 8 ? mlimit - 8 : bp;
    OptCand cands[24];
    for (size_t i = 0; i < n; i++) {
      u64 p = price[i];
      u32 R[3] = {rep0[i], rep1v[i], rep2v[i]};
      u32 llv = llrun[i];
      // literal step (keeps every position reachable)
      u64 lp = p + lit_price[bp[i]];
      if (lp < price[i + 1]) {
        price[i + 1] = lp;
        from_len[i + 1] = 0;
        rep0[i + 1] = R[0]; rep1v[i + 1] = R[1]; rep2v[i + 1] = R[2];
        llrun[i + 1] = (u16)(llv < 60000 ? llv + 1 : llv);
      }
      if (bp + i >= search_end) continue;
      size_t cur_g = (size_t)(bp + i - base);
      const u8* ip = bp + i;
      const u8* scan_lim = (mlimit - ip > 4096) ? ip + 4096 : mlimit;
      // Rep probes: every position, every pass (cheap, path-dependent).
      int nc = 0;
      for (int j = 0; j < 3; j++) {
        u32 r = R[j];
        if (!r || r > cur_g) continue;
        if (j && (r == R[0] || (j == 2 && r == R[1]))) continue;
        if (((read32(ip) ^ read32(ip - r)) & 0xFFFFFF) != 0) continue;
        u32 l = match_len(ip, ip - r, scan_lim);
        if (l >= 3) cands[nc++] = {l, r};
      }
      bool skipping = i < skip_gather_until && (i & 15);
      if (pass == 0) {
        if (skipping) {
          gather_cands(base, ip, mlimit, M, depth, cands + nc, false);
        } else {
          int tn = gather_cands(base, ip, mlimit, M, depth, cands + nc);
          cand_off_idx[i] = (u32)cand_store.size();
          cand_cnt[i] = (u16)tn;
          for (int c = 0; c < tn; c++) cand_store.push_back(cands[nc + c]);
          for (int c = 0; c < tn; c++)
            if (cands[nc + c].len >= 1024 &&
                i + cands[nc + c].len - 64 > skip_gather_until)
              skip_gather_until = i + cands[nc + c].len - 64;
          nc += tn;
        }
      } else {
        int tn = cand_cnt[i];
        for (int c = 0; c < tn; c++) cands[nc + c] = cand_store[cand_off_idx[i] + c];
        nc += tn;
      }
      u32 llc_cost = ll_price[ll_code(llv)];
      for (int c = 0; c < nc; c++) {
        u32 L = cands[c].len, O = cands[c].off;
        u32 oprice = off_price_of(O, llv, R, of_price);
        u64 base_p = p + SEQ_OVERHEAD + llc_cost + oprice;
        u32 NR[3];
        rep_transition(R, O, llv, NR);
        auto relax = [&](u32 l) {
          u64 mp = base_p + ml_price[ml_code(l)];
          if (mp < price[i + l]) {
            price[i + l] = mp;
            from_len[i + l] = l;
            from_off[i + l] = O;
            rep0[i + l] = NR[0]; rep1v[i + l] = NR[1]; rep2v[i + l] = NR[2];
            llrun[i + l] = 0;
          }
        };
        // Dense lengths up to 64; beyond that only ml-code boundaries and L
        // itself matter (price is constant within a code bucket).
        u32 dense = L < 64 ? L : 64;
        for (u32 l = 3; l <= dense; l++) relax(l);
        if (L > 64) {
          for (int mc = 0; mc < 53; mc++) {
            u32 b = ML_BASE[mc];
            if (b > 64 && b <= L) relax(b);
          }
          relax(L);
        }
      }
    }

    // Backtrack this pass's best path.
    bt_len.clear(); bt_off.clear();
    size_t at = n;
    while (at > 0) {
      u32 fl = from_len[at];
      bt_len.push_back(fl ? fl : 1);
      bt_off.push_back(fl ? from_off[at] : 0);
      at -= fl ? fl : 1;
    }

    if (pass + 1 < passes) {
      // Refine prices from this parse's actual code statistics: forward
      // replay with the real rep rules so OF codes histogram truthfully.
      u32 mh[53] = {0}, oh[32] = {0}, lh[256] = {0}, llh[36] = {0};
      u32 nseq = 0, nlit = 0;
      u32 RR[3] = {reps[0], reps[1], reps[2]};
      size_t cursor = 0, anchor = 0;
      for (size_t k = bt_len.size(); k-- > 0;) {
        u32 l = bt_len[k], o = bt_off[k];
        if (o == 0) { cursor += l; continue; }
        u32 ll = (u32)(cursor - anchor);
        for (size_t q = anchor; q < cursor; q++) lh[bp[q]]++;
        nlit += ll;
        u32 ov;
        if (ll != 0) {
          if (o == RR[0]) ov = 1;
          else if (o == RR[1]) { ov = 2; RR[1] = RR[0]; RR[0] = o; }
          else if (o == RR[2]) { ov = 3; RR[2] = RR[1]; RR[1] = RR[0]; RR[0] = o; }
          else { ov = o + 3; RR[2] = RR[1]; RR[1] = RR[0]; RR[0] = o; }
        } else {
          if (o == RR[1]) { ov = 1; RR[1] = RR[0]; RR[0] = o; }
          else if (o == RR[2]) { ov = 2; RR[2] = RR[1]; RR[1] = RR[0]; RR[0] = o; }
          else if (o + 1 == RR[0] && o != 0) { ov = 3; RR[2] = RR[1]; RR[1] = RR[0]; RR[0] = o; }
          else { ov = o + 3; RR[2] = RR[1]; RR[1] = RR[0]; RR[0] = o; }
        }
        llh[ll_code(ll)]++;
        mh[ml_code(l)]++;
        oh[highbit(ov)]++;
        nseq++;
        cursor += l;
        anchor = cursor;
      }
      for (size_t q = anchor; q < n; q++) lh[bp[q]]++;
      nlit += (u32)(n - anchor);
      if (nseq < 16) break;  // nothing to refine
      double ls = log2((double)(nseq + 16));
      for (int k = 0; k < 53; k++) {
        double bits = mh[k] ? ls - log2((double)mh[k]) : ls;
        ml_price[k] = (u16)((bits + ML_BITS[k]) * 16);
      }
      for (int k = 0; k < 32; k++) {
        double bits = oh[k] ? ls - log2((double)oh[k]) : ls;
        of_price[k] = (u16)((bits + k) * 16);
      }
      for (int k = 0; k < 36; k++) {
        double bits = llh[k] ? ls - log2((double)llh[k]) : ls;
        ll_price[k] = (u16)((bits + LL_BITS[k]) * 16);
      }
      if (nlit > 64) {
        double ln2 = log2((double)nlit);
        // Amortize the literals-section fixed cost (Huffman tree
        // description + headers, ~70 bytes/block) over the literal count:
        // sparse literal sets pay real per-byte overhead the entropy
        // estimate alone misses.
        double amort = 8.0 * 70.0 / (double)nlit;
        if (amort > 4.0) amort = 4.0;
        for (int b = 0; b < 256; b++) {
          double bits = lh[b] ? (ln2 - log2((double)lh[b])) + amort : 13.0;
          if (bits < 1.0) bits = 1.0;
          if (bits > 14.0) bits = 14.0;
          lit_price[b] = (u16)(bits * 16);
        }
      }
      SEQ_OVERHEAD = 1 * 16;
    }
  }  // passes

  // Emit the final pass's path forward as (ll, ml, ov) + literals.
  const u8* anchor = bp;
  size_t cursor = 0;
  for (size_t k = bt_len.size(); k-- > 0;) {
    u32 l = bt_len[k], o = bt_off[k];
    if (o == 0) { cursor += l; continue; }
    u32 ll = (u32)((bp + cursor) - anchor);
    lits.insert(lits.end(), anchor, bp + cursor);
    u32 ov;
    u32 r1 = reps[0], r2 = reps[1], r3 = reps[2];
    if (ll != 0) {
      if (o == r1) ov = 1;
      else if (o == r2) { ov = 2; reps[1] = r1; reps[0] = o; }
      else if (o == r3) { ov = 3; reps[2] = r2; reps[1] = r1; reps[0] = o; }
      else { ov = o + 3; reps[2] = r2; reps[1] = r1; reps[0] = o; }
    } else {
      if (o == r2) { ov = 1; reps[1] = r1; reps[0] = o; }
      else if (o == r3) { ov = 2; reps[2] = r2; reps[1] = r1; reps[0] = o; }
      else if (o + 1 == r1 && o != 0) { ov = 3; reps[2] = r2; reps[1] = r1; reps[0] = o; }
      else { ov = o + 3; reps[2] = r2; reps[1] = r1; reps[0] = o; }
    }
    seqs.push_back(mk_seq(ll, l, ov));
#ifdef ZN_DEBUG_VERIFY
    {
      const u8* mstart = bp + cursor;
      if ((size_t)(mstart - base) < o || memcmp(mstart, mstart - o, l > o ? o : l) != 0)
        fprintf(stderr, "BAD EMIT pos=%zu ll=%u ml=%u off=%u\n",
                (size_t)(mstart - bp), ll, l, o);
    }
#endif
    cursor += l;
    anchor = bp + cursor;
  }
  lits.insert(lits.end(), anchor, bp + n);
}
