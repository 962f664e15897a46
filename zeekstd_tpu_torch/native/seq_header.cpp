// The sequences-section header of one compressed block, for the decode
// planner (plan._plan_frame): the number of sequences as
// codec/sequences.parse_num_sequences reads it, the symbol-compression
// modes byte, and each of the literal-length, offset and match-length
// table descriptions as codec/sequences.read_symbol_table reads it, the
// FSE_Compressed ones by codec/fse.read_ncount, statement for statement.
//
// Where a Python function raises, the call returns 1 and the caller runs
// the Python functions on the block, so errors keep their class, message
// and order. The checks are those functions' checks and no others: a
// truncated count, an accuracy log above the category's maximum, too many
// symbols, a zero run past the symbols, counts that do not sum to the
// table size, a truncated description, an RLE symbol above the category's
// largest code, and a block that ends before its modes byte. Repeat_Mode
// needs the previous block's table, which only the caller holds, so the
// call reads no bytes for it and checks nothing there.
//
// Plain C interface, loaded through ctypes (native/seq_header.py).

#include <cstdint>
#include <cstring>

namespace {

constexpr int kSym = 64;  // alphabet bound of every category (53 codes)
constexpr int kModeRle = 1, kModeFse = 2;
// Per category (ll, of, ml): sequences.MAX_*_CODE and *_MAX_LOG.
constexpr int kMaxCode[3] = {35, 31, 52};
constexpr int kMaxLog[3] = {9, 8, 9};

// codec/bitstream.ForwardBitReader over data[0, len): bits past the end
// read as zero, as its slice of the bytes past the end is empty.
struct ForwardBits {
  const uint8_t* data;
  int64_t len;
  int64_t bitpos;

  uint64_t peek(int n) const {
    const int64_t byte0 = bitpos >> 3;
    uint64_t window = 0;
    if (byte0 + 8 <= len) {
      std::memcpy(&window, data + byte0, 8);  // little-endian host
    } else {
      for (int64_t i = byte0; i < len; ++i) window |= uint64_t(data[i]) << (8 * (i - byte0));
    }
    return (window >> (bitpos & 7)) & ((uint64_t(1) << n) - 1);
  }
  uint64_t read(int n) {
    const uint64_t v = peek(n);
    bitpos += n;
    return v;
  }
};

// fse.read_ncount(data[0, len), max_symbol, max_accuracy_log): false where
// it raises; else the counts in norm[0, *nsym), the log and the bytes
// consumed.
bool read_ncount(const uint8_t* data, int64_t len, int max_symbol, int max_accuracy_log,
                 int16_t* norm, int64_t* nsym, int64_t* log, int64_t* consumed) {
  ForwardBits br{data, len, 0};
  const int accuracy_log = int(br.read(4)) + 5;
  if (accuracy_log > max_accuracy_log) return false;
  const int64_t size = int64_t(1) << accuracy_log;
  int64_t remaining = size + 1;
  int64_t threshold = size;
  int nb_bits = accuracy_log + 1;
  int n = 0;
  bool previous0 = false;

  while (remaining > 1) {
    if (n > max_symbol) return false;  // too many symbols
    if (previous0) {
      while (true) {
        const int rep = int(br.read(2));
        if (n + rep > max_symbol + 1) return false;  // zero run overflows
        for (int k = 0; k < rep; ++k) norm[n++] = 0;
        if (rep != 3) break;
      }
      previous0 = false;
      continue;
    }
    const int64_t maxv = (2 * threshold - 1) - remaining;
    const int64_t val = int64_t(br.peek(nb_bits));
    const int64_t small = val & (threshold - 1);
    int64_t count;
    if (small < maxv) {
      count = small;
      br.bitpos += nb_bits - 1;
    } else {
      count = val & (2 * threshold - 1);
      if (count >= threshold) count -= maxv;
      br.bitpos += nb_bits;
    }
    count -= 1;
    remaining -= count < 0 ? -count : count;
    norm[n++] = int16_t(count);
    previous0 = count == 0;
    while (remaining < threshold) {
      nb_bits -= 1;
      threshold >>= 1;
    }
  }

  if (remaining != 1) return false;  // counts do not sum to the table size
  const int64_t used = (br.bitpos + 7) >> 3;
  if (used > len) return false;  // description truncated
  *nsym = n;
  *log = accuracy_log;
  *consumed = used;
  return true;
}

}  // namespace

// The header of the sequences section at block[off] of block[0, len).
// out[0] the number of sequences; out[1] the modes byte (0 without
// sequences); for category c (ll, of, ml) out[2 + 4c ...] its mode, the
// bytes its description takes, the accuracy log (FSE_Compressed) or the
// symbol (RLE), and the number of counts, which go to norms[64c ...];
// out[14] the offset of the FSE bitstream. Returns 0, or 1 where the
// Python functions raise (out is then partly written).
extern "C" int zk_seq_header(const uint8_t* block, int64_t len, int64_t off, int64_t* out,
                             int16_t* norms) {
  std::memset(out, 0, 15 * sizeof(int64_t));
  // sequences.parse_num_sequences(block[off:])
  if (off >= len) return 1;  // empty sequences section
  const uint8_t b0 = block[off];
  int64_t nseq;
  if (b0 < 128) {
    nseq = b0;
    off += 1;
  } else if (b0 < 255) {
    if (len - off < 2) return 1;  // truncated sequence count
    nseq = (int64_t(b0 - 128) << 8) + block[off + 1];
    off += 2;
  } else {
    if (len - off < 3) return 1;
    nseq = block[off + 1] + (int64_t(block[off + 2]) << 8) + 0x7F00;
    off += 3;
  }
  out[0] = nseq;
  if (nseq > 0) {
    if (off >= len) return 1;  // no modes byte
    const int modes = block[off];
    off += 1;
    out[1] = modes;
    for (int c = 0; c < 3; ++c) {
      int64_t* f = out + 2 + 4 * c;
      const int mode = (modes >> (6 - 2 * c)) & 3;
      f[0] = mode;
      if (mode == kModeRle) {
        if (off >= len) return 1;  // truncated RLE symbol
        const int sym = block[off];
        if (sym > kMaxCode[c]) return 1;  // RLE symbol out of range
        f[1] = 1;
        f[2] = sym;
      } else if (mode == kModeFse) {
        if (!read_ncount(block + off, len - off, kMaxCode[c], kMaxLog[c], norms + kSym * c,
                         &f[3], &f[2], &f[1]))
          return 1;
      }  // Predefined and Repeat read no bytes
      off += f[1];
    }
  }
  out[14] = off;
  return 0;
}
