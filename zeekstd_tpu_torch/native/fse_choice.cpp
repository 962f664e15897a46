// The archive encoder's sequence-table choice for a batch of blocks.
//
// For every block and each of the literal-length, offset and match-length
// codes this picks what codec/seq_encode._choose_table picks from the
// block's code histogram: RLE, the predefined table, a new FSE_Compressed
// table, or the previous block's table of the same frame (Repeat_Mode),
// whichever prices cheapest. A new table comes with its normalised counts
// (codec/fse.normalize_counts), its description bytes (fse.write_ncount)
// and its encode table (fse.build_encode_table), each step mirroring the
// Python function line by line.
//
// Prices are sums of count x (log - log2 p) in float64. numpy sums them in
// its BLAS's order, this file in symbol order, so the two may differ in
// the last bits. Where two candidates price within 1e-9 of each other the
// order could decide the choice, so the call leaves the block's whole
// frame to the Python function (``deferred``): every choice it does make
// is the Python function's. Prices whose every term is a whole number (all
// probabilities powers of two) are exact in any order and tie exactly. A
// Repeat table that is the predefined table, or equal to it in value,
// prices exactly as the predefined one in Python too, and the predefined
// mode wins that tie there; it is never a candidate here.
//
// Plain C interface, loaded through ctypes (native/fse_choice.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

constexpr int kSym = 64;        // alphabet bound of every category (53 codes)
constexpr int kStates = 512;    // 1 << the largest accuracy log (9)
constexpr int kDesc = 128;      // description bytes bound (log 9, 53 symbols)
constexpr int kModePredefined = 0, kModeRle = 1, kModeFse = 2, kModeRepeat = 3;

int bit_length(uint64_t x) { return x ? 64 - __builtin_clzll(x) : 0; }

// fse.optimal_table_log
int optimal_table_log(int max_log, int64_t total, int max_symbol) {
  int log = total > 1 ? bit_length(uint64_t(total - 1)) - 2 : 1;
  int min_bits_symbols = bit_length(uint64_t(max_symbol + 1)) + 1;
  log = std::max(log, 5);
  log = std::min(log, max_log);
  log = std::max(log, std::min(min_bits_symbols, max_log));
  return std::max(log, 5);
}

struct Share {
  double rem;
  int s;
};

// fse.normalize_counts over counts[0..max_symbol]; false where its strip
// loop would give up (Python raises there).
bool normalize(const int64_t* counts, int table_log, int64_t total, int max_symbol,
               int16_t* norm) {
  const int64_t size = int64_t(1) << table_log;
  std::memset(norm, 0, sizeof(int16_t) * (max_symbol + 1));
  const int64_t low_threshold = total >> table_log;
  int64_t distributed = 0, rest_total = 0;
  for (int s = 0; s <= max_symbol; ++s) {
    const int64_t c = counts[s];
    if (c == 0) continue;
    if (c <= low_threshold) {
      norm[s] = -1;
      ++distributed;
    } else {
      rest_total += c;
    }
  }
  const int64_t remaining_slots = size - distributed;
  if (remaining_slots <= 0 || rest_total == 0) {
    // Degenerate: every present symbol one slot, the first largest the rest.
    std::memset(norm, 0, sizeof(int16_t) * (max_symbol + 1));
    int n_present = 0, largest = -1;
    for (int s = 0; s <= max_symbol; ++s) {
      if (counts[s] <= 0) continue;
      norm[s] = 1;
      ++n_present;
      if (largest < 0 || counts[s] > counts[largest]) largest = s;
    }
    if (largest < 0) return false;
    norm[largest] = int16_t(norm[largest] + size - n_present);
    return true;
  }
  Share shares[kSym];
  int n_shares = 0;
  int64_t assigned = 0;
  for (int s = 0; s <= max_symbol; ++s) {
    if (norm[s] == -1 || counts[s] == 0) continue;
    // numpy: int64 product, then true division of the two as float64.
    const double exact = double(counts[s] * remaining_slots) / double(rest_total);
    const int64_t base = std::max<int64_t>(int64_t(exact), 1);
    shares[n_shares++] = {exact - double(base), s};
    norm[s] = int16_t(base);
    assigned += base;
  }
  int64_t leftover = remaining_slots - assigned;
  if (leftover > 0) {
    // sorted((rem, s), reverse=True): larger remainder first, then larger s.
    std::sort(shares, shares + n_shares, [](const Share& a, const Share& b) {
      return a.rem > b.rem || (a.rem == b.rem && a.s > b.s);
    });
    for (int i = 0; leftover > 0; ++i, --leftover) ++norm[shares[i % n_shares].s];
  } else if (leftover < 0) {
    int order[kSym];
    for (int i = 0; i < n_shares; ++i) order[i] = shares[i].s;
    std::stable_sort(order, order + n_shares,
                     [counts](int a, int b) { return counts[a] < counts[b]; });
    for (int i = 0, guard = 0; leftover < 0; ++i) {
      const int s = order[i % n_shares];
      if (norm[s] > 1) {
        --norm[s];
        ++leftover;
      }
      if (++guard > 10000) return false;
    }
  }
  return true;
}

struct BitWriter {
  uint8_t* out;
  int cap, len = 0, nbits = 0;
  uint64_t acc = 0;
  bool overflow = false;
  void add(uint64_t value, int n) {
    acc |= (value & ((uint64_t(1) << n) - 1)) << nbits;
    nbits += n;
    while (nbits >= 8) put(uint8_t(acc));
  }
  void put(uint8_t byte) {
    if (len < cap) out[len++] = byte; else overflow = true;
    acc >>= 8;
    nbits -= 8;
  }
  int bytes_no_finish() {
    if (nbits > 0) put(uint8_t(acc));
    return overflow ? -1 : len;
  }
};

// fse.write_ncount: the description's length, or -1.
int write_ncount(const int16_t* norm, int n, int log, uint8_t* out, int cap) {
  BitWriter bw{out, cap};
  bw.add(uint64_t(log - 5), 4);
  int64_t remaining = (int64_t(1) << log) + 1, threshold = int64_t(1) << log;
  int nb_bits = log + 1, i = 0;
  while (remaining > 1) {
    if (i >= n) return -1;
    const int64_t count = norm[i], stored = count + 1;
    const int64_t maxv = (2 * threshold - 1) - remaining;
    if (stored < maxv) {
      bw.add(uint64_t(stored), nb_bits - 1);
    } else {
      bw.add(uint64_t(stored < threshold ? stored : stored + maxv), nb_bits);
    }
    remaining -= count < 0 ? -count : count;
    ++i;
    if (count == 0 && remaining > 1) {
      int run = 0;
      while (i + run < n && norm[i + run] == 0) ++run;
      i += run;
      for (; run >= 3; run -= 3) bw.add(3, 2);
      bw.add(uint64_t(run), 2);
    }
    while (remaining < threshold) {
      --nb_bits;
      threshold >>= 1;
    }
  }
  if (remaining != 1) return -1;
  return bw.bytes_no_finish();
}

// fse.build_encode_table; false where Python raises (spread != size).
bool build_encode_table(const int16_t* norm, int nsym, int log, int64_t* delta_nb,
                        int64_t* delta_fs, uint16_t* state_table) {
  const int size = 1 << log;
  int n_neg = 0, total_spread = 0;
  for (int s = 0; s < nsym; ++s) {
    if (norm[s] == -1) ++n_neg;
    else if (norm[s] > 0) total_spread += norm[s];
  }
  const int high = size - 1 - n_neg;
  if (total_spread != size - n_neg) return false;
  int16_t symbol[kStates];
  int top = size - 1;  // -1 symbols take the top cells, the lowest highest
  for (int s = 0; s < nsym; ++s)
    if (norm[s] == -1) symbol[top--] = int16_t(s);
  const int step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  int pos = 0;
  for (int s = 0; s < nsym; ++s) {
    for (int k = 0; k < norm[s]; ++k) {
      symbol[pos] = int16_t(s);
      do pos = (pos + step) & mask; while (pos > high);
    }
  }
  // Stable argsort of the cells by symbol: each symbol's cells in order,
  // its slots starting at the exclusive prefix of the cell counts.
  int cumul[kSym + 1];
  cumul[0] = 0;
  for (int s = 0; s < nsym; ++s) {
    const int c = norm[s] == -1 ? 1 : std::max<int>(norm[s], 0);
    cumul[s + 1] = cumul[s] + c;
  }
  int next[kSym];
  std::memcpy(next, cumul, sizeof(int) * nsym);
  for (int u = 0; u < size; ++u) state_table[next[symbol[u]]++] = uint16_t(u + size);
  for (int s = 0; s < nsym; ++s) {
    const int64_t c = norm[s] == -1 ? 1 : std::max<int64_t>(norm[s], 0);
    if (c == 0) {
      delta_nb[s] = (int64_t(log + 1) << 16) - size;
      delta_fs[s] = 0;
    } else {
      const int64_t mbo = log - (bit_length(uint64_t(std::max<int64_t>(c - 1, 1))) - 1);
      delta_nb[s] = (mbo << 16) - (c << mbo);
      delta_fs[s] = cumul[s] - c;
    }
  }
  return true;
}

struct Tab {
  const int16_t* norm;  // nullptr: no table
  int len, log;
  bool predefined;
};

// seq_encode._choose_table's _table_bits: the price of coding the present
// symbols with a table, or NaN where one lies out of the table's reach.
// ``exact``: every present symbol's price is a whole number, so every term
// and partial sum is too, and any order of summing gives this sum.
struct Bits {
  double bits;
  bool exact;
};

Bits table_bits(const double* hc, int width, const Tab& t, const double* log2tab) {
  const int m = std::min(t.len, width);
  for (int s = m; s < width; ++s)
    if (hc[s] > 0) return {NAN, false};
  double sum = 0.0;
  bool exact = true;
  for (int s = 0; s < m; ++s) {
    if (hc[s] == 0) continue;
    if (t.norm[s] == 0) return {NAN, false};
    const double price = double(t.log) - log2tab[t.norm[s] > 0 ? t.norm[s] : 0];
    exact = exact && price == std::floor(price);
    sum += hc[s] * price;
  }
  return {sum, exact};
}

// Two prices whose order numpy's summation could decide otherwise.
bool near(const Bits& a, const Bits& b) {
  return !(a.exact && b.exact) && std::fabs(a.bits - b.bits) <= 1e-9 * std::max(a.bits, b.bits);
}

}  // namespace

extern "C" {

// One call per batch. ``hist`` [nblk][3][64] int64: the ll, of and ml code
// histograms of each block (width params[c][2] + 1), in the encoder's block
// order; ``frame`` [nblk] each block's frame (a Repeat chain runs inside one
// frame). ``params`` [3][4]: predefined norm length and log, max code, max
// log; ``def_norm`` [3][64]; ``log2tab`` [513]: numpy's log2(0.5) then of
// 1..512. Out, per block and category: ``mode``, ``tab`` (the new table's
// pool index, or -1) and ``cost``; per block ``deferred`` (1: the block's
// frame is left to the Python function). The pool (capacity 3 * nblk) holds
// each new RLE or FSE table: log, symbol count, normalised counts, encode
// table, description. Returns the pool's size, or -1 for bad arguments.
int64_t zk_fse_choose(int64_t nblk, const int32_t* frame, const int64_t* hist,
                      const int32_t* params, const int16_t* def_norm, const double* log2tab,
                      int32_t* mode, int32_t* tab, double* cost, int32_t* deferred,
                      int32_t* t_log, int32_t* t_nsym, int16_t* t_norm, int64_t* t_dnb,
                      int64_t* t_dfs, uint16_t* t_stt, uint8_t* t_desc, int32_t* t_desc_len) {
  for (int c = 0; c < 3; ++c) {
    const int32_t* p = params + 4 * c;
    if (p[0] < 1 || p[0] > kSym || p[1] < 5 || p[1] > 9 || p[2] < 1 || p[2] >= kSym ||
        p[3] < 5 || p[3] > 9)
      return -1;
  }
  int64_t pool = 0;
  int64_t j0 = 0;
  while (j0 < nblk) {
    int64_t j1 = j0 + 1;
    while (j1 < nblk && frame[j1] == frame[j0]) ++j1;
    const int64_t pool0 = pool;
    bool defer = false;
    for (int c = 0; c < 3 && !defer; ++c) {
      const int32_t* p = params + 4 * c;
      const int width = p[2] + 1, max_log = p[3];
      const Tab pred{def_norm + kSym * c, p[0], p[1], true};
      Tab prev{nullptr, 0, 0, false};
      for (int64_t j = j0; j < j1; ++j) {
        const int64_t* h = hist + (j * 3 + c) * kSym;
        const int64_t slot = j * 3 + c;
        int nz = 0, sym = -1;
        int64_t n = 0;
        double hc[kSym];
        for (int s = 0; s < width; ++s) {
          if (h[s] < 0) return -1;
          if (h[s]) { ++nz; sym = s; }
          n += h[s];
          hc[s] = double(h[s]);
        }
        if (nz == 0) { defer = true; break; }  // Python raises here
        if (nz == 1) {  // RLE: build_encode_table([0] * sym + [1], 0)
          int16_t* norm = t_norm + pool * kSym;
          std::memset(norm, 0, sizeof(int16_t) * (sym + 1));
          norm[sym] = 1;
          build_encode_table(norm, sym + 1, 0, t_dnb + pool * kSym, t_dfs + pool * kSym,
                             t_stt + pool * kStates);
          t_log[pool] = 0;
          t_nsym[pool] = sym + 1;
          t_desc[pool * kDesc] = uint8_t(sym);
          t_desc_len[pool] = 1;
          mode[slot] = kModeRle;
          tab[slot] = int32_t(pool);
          cost[slot] = 0.0;
          prev = Tab{norm, sym + 1, 0, false};
          ++pool;
          continue;
        }
        const Bits pred_bits = table_bits(hc, width, pred, log2tab);
        const int log = optimal_table_log(max_log, n, p[2]);
        const int nsym = sym + 1;  // max_present + 1
        int16_t* norm = t_norm + pool * kSym;
        if (!normalize(h, log, n, sym, norm)) { defer = true; break; }
        const int dlen = write_ncount(norm, nsym, log, t_desc + pool * kDesc, kDesc);
        const Tab ded{norm, nsym, log, false};
        const Bits ded_bits = table_bits(hc, width, ded, log2tab);
        if (dlen < 0 || std::isnan(ded_bits.bits)) { defer = true; break; }
        const Bits fse_bits{double(8 * dlen) + ded_bits.bits, ded_bits.exact};
        Bits rep_bits{NAN, false};
        if (prev.norm != nullptr && prev.log > 0 && !prev.predefined)
          rep_bits = table_bits(hc, width, prev, log2tab);
        // min over (bits, mode): predefined, then FSE, then Repeat on ties.
        const Bits cand[3] = {pred_bits, fse_bits, rep_bits};
        const int modes[3] = {kModePredefined, kModeFse, kModeRepeat};
        int best = 1;
        for (int k : {0, 2})
          if (!std::isnan(cand[k].bits) &&
              (cand[k].bits < cand[best].bits ||
               (cand[k].bits == cand[best].bits && modes[k] < modes[best])))
            best = k;
        for (int k = 0; k < 3; ++k)
          if (k != best && !std::isnan(cand[k].bits) && near(cand[k], cand[best])) defer = true;
        if (defer) break;
        mode[slot] = modes[best];
        cost[slot] = cand[best].bits;
        tab[slot] = -1;
        if (best == 0) {
          prev = pred;
        } else if (best == 1) {
          if (!build_encode_table(norm, nsym, log, t_dnb + pool * kSym, t_dfs + pool * kSym,
                                  t_stt + pool * kStates)) {
            defer = true;
            break;
          }
          t_log[pool] = log;
          t_nsym[pool] = nsym;
          t_desc_len[pool] = dlen;
          tab[slot] = int32_t(pool);
          // A table equal in value to the predefined one prices exactly as
          // it in Python too, where the predefined mode wins the tie.
          prev = Tab{norm, nsym, log,
                     nsym == pred.len && log == pred.log &&
                         std::memcmp(norm, pred.norm, sizeof(int16_t) * nsym) == 0};
          ++pool;
        }
      }
    }
    for (int64_t j = j0; j < j1; ++j) deferred[j] = defer;
    if (defer) pool = pool0;
    j0 = j1;
  }
  return pool;
}

// fse.normalize_counts alone (for tests): 0, or -1 where Python raises.
int zk_fse_normalize(const int64_t* counts, int max_symbol, int table_log, int64_t total,
                     int16_t* norm) {
  if (max_symbol < 0 || max_symbol >= kSym || table_log < 0 || table_log > 9) return -1;
  return normalize(counts, table_log, total, max_symbol, norm) ? 0 : -1;
}

}  // extern "C"
