// Fused FSE decode and sequence execution for Hopper, for the three
// contracts of the reference, behind launchers that run in order on one
// stream:
//
//   wide (ops/decode_kernel.py::wide_stages): zk_wide_fse_launch,
//     zk_wide_scan_launch, zk_wide_resolve_launch. Replaces
//     zeekstd_tpu/ops/decode_kernel.py (_build / get_decode_kernel, the
//     pallas_call at decode_kernel.py:388): literals one int32 per byte in,
//     bytes out, any window. Plain version: ops/decode_kernel.py::wide_plain.
//   ring (ops/ring_kernel.py::ring_stages): zk_ring_fse_launch,
//     zk_ring_scan_launch, zk_ring_resolve_launch. Replaces
//     zeekstd_tpu/ops/ring_kernel.py (_build / get_ring_kernel, the
//     pallas_call at ring_kernel.py:541): literal pools as LE words in, LE
//     words out, windows <= 512 KiB. Plain version:
//     ops/ring_kernel.py::ring_plain.
//   exec (ops/exec_kernel.py::exec_stages): zk_exec_scan_launch, then
//     zk_wide_resolve_launch. Replaces zeekstd_tpu/ops/exec_kernel.py
//     (_build / get_exec_kernel, the pallas_call at exec_kernel.py:372):
//     executes sequences the fse_decode kernel already decoded, so it has
//     no FSE stage; literals one int32 per byte in, bytes out. Plain
//     version: ops/exec_kernel.py::exec_plain.
//
// meta_out row f holds (total, bad flag, literals used) for all three.
//
// The TPU kernels walk the records in order on one core, decoding each FSE
// stream and copying each sequence's bytes as it goes. On this card that walk
// is a chain of dependent loads per frame, and each match copy waits for the
// bytes the frame stored just before. The work is split in three stages,
// each a template on the contract:
//
//   1. fse - one thread per KIND_SEQ record, 32 records per warp. Each
//      thread decodes its block's sequences to raw (ll, ml, offset value)
//      at the record's sequence offset (an exclusive sum of M_NSEQ that the
//      wrapper computes on the card) and the bits left at the end. Bound by
//      latency: each FSE state depends on the bits the previous sequence
//      consumed; 32 chains per warp issue their loads together. Wide and
//      ring only.
//   2. scan - one warp per frame walks the frame's records in order. It
//      loads 32 decoded sequences at a time (one coalesced load per lane,
//      the next 32 in flight) and hands them out by shuffles, threads the
//      position, the literal cursor, the repeat offsets and the bad flag,
//      and applies every clamp of the reference. Instead of copying bytes
//      it writes one int32 descriptor per output byte: a terminal (a
//      literal's index in the pool, an RLE byte, or 0) or the position of
//      the byte a match byte copies. No descriptor depends on another, so
//      the scan never reads what it wrote. Bound by the latency of its
//      scalar chain, so the chain only computes where each of 32 sequences
//      goes; the lanes then write those 32 sequences' descriptors at once,
//      one sequence each (put_sequences).
//   3. resolve - pointer jumping over all F x OUTB descriptors, grid-wide,
//      between two buffers: exactly ceil(log2(OUTB)) rounds that replace a
//      pointer with its target's descriptor, then one gather that writes
//      the terminals' bytes. Exact: a match byte points before its match,
//      and every byte before it was written by then, so every chain ends at
//      a terminal within OUTB hops; bytes past a frame's total keep the
//      terminal 0 the wrapper fills the first buffer with. Bound by
//      gathers; at 10 x 1 MiB frames each buffer is 40 MiB, within the
//      50 MB L2. The exec contract's pools are the wide contract's, so it
//      runs the wide instance.
//
// Scratch, all allocated by the wrappers: 2 x 4 x F x OUTB bytes of
// descriptors, 12 bytes per sequence and 8 per record (80 MiB + about 4 MiB
// for 10 frames of 1 MiB; the exec contract has no sequence or record
// scratch). The kernels allocate nothing.
//
// The arithmetic is the TPU kernels', hostile input included: a meta row
// index outside the table reads the last row; decode-table entries are
// indexed & 511 and codes & 63; the offset value is (1 << min(code, 31)) +
// bits; the state-update bits after a block's last sequence are not
// consumed; bit reads mask at most 31 bits. The wide and ring contracts
// differ in four places:
//   - bit reads: the wide contract reads every field from the two words
//     around it (the word index clipped to [0, WB - 2]); the ring contract
//     reads a sequence's fields and state updates from the four words at
//     bw = clamp((rem >> 5) - 3, 0, WB - 4), rem the stream position at the
//     sequence's start, and a field below them reads from their floor
//     (RingBits). The three initial states use the two-word read in both.
//   - the literal clamp: the wide contract's window is LITB + 128 bytes
//     from the 128-byte row holding the record's first literal, for
//     sequences, trailing literals and literal records alike; the ring
//     contract clamps a sequence's literals at its block's budget and
//     trailing literals and literal records by the output only.
//   - the offset check: the ring contract also marks an offset over 512 KiB
//     bad and copies from at most 512 KiB back.
//   - the pools: int32 per byte (wide) or bytes of LE words (ring); the
//     ring output is the same bytes, returned as LE words by the wrapper.
// The exec contract is the wide scan with three differences:
//   - its records: 8 meta columns; a KIND_SEQ record is a slice of at most
//     SBd sequences of one block, at row clamp(M_ROW, 0, nrows - 1) of the
//     (nrows, SBd) sequence arrays, its count clamped to [0, SBd];
//   - its trailing literals: only on a block's last slice (F_BLOCK_END),
//     what the block's budget leaves after every slice, counted from the
//     literal cursor at its first slice (F_BLOCK_START);
//   - no remaining-bits check (the sequences come decoded).
//
// Precondition (build_records): a frame's F_FRAME_START, if any, is on its
// first record, so the scan writes each output position at most once; the
// M_LITN of a KIND_LIT or KIND_RLE record is not negative.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int LANES = 32;
constexpr unsigned FULL = 0xFFFFFFFFu;

enum class Contract { wide, ring, exec };

// Meta columns; the exec contract's rows hold the first seven, with M_ROW
// (its sequence row) in place of M_WROW.
constexpr int META_COLS = 16, EXEC_META_COLS = 8;
constexpr int M_FRAME = 0, M_KIND = 1, M_WROW = 2, M_NSEQ = 3, M_LITN = 4,
              M_FLAGS = 5, M_RLEBYTE = 6, M_TLL = 7, M_TOF = 8, M_TML = 9,
              M_LOGS = 10, M_STARTBIT = 11;
constexpr int M_ROW = M_WROW;
constexpr int KIND_SEQ = 0, KIND_LIT = 1, KIND_RLE = 2, KIND_NOP = 3;
constexpr int F_FRAME_START = 1, F_FRAME_END = 2, F_BLOCK_START = 4, F_BLOCK_END = 8;
// Shuffle lanes of the per-record row the scan loads (lanes 0-15: meta).
constexpr int COL_SEQ_OFF = 16, COL_REM = 17;

// Descriptors: d >= 0 points at byte d of the frame's row; d < 0 is the
// terminal t = -1 - d: the byte t for t < 256, else literal t - 256.
constexpr int D_ZERO = -1;
__device__ __forceinline__ int d_byte(int b) { return -1 - b; }
__device__ __forceinline__ int d_lit(int i) { return -257 - i; }

constexpr int RING = 1 << 19;  // the ring contract's window limit (512 KiB)

// n bits ending at bit `rem` of the backward stream w[0, WB) (n in [0, 31]).
__device__ __forceinline__ uint32_t read_bits(const uint32_t* __restrict__ w, int WB,
                                              int rem, int n) {
  if (n <= 0) return 0u;
  const int lo = rem - n;
  const int wi = min(max(lo >> 5, 0), WB - 2);
  const int sh = lo & 31;
  const uint32_t hi = sh == 0 ? 0u : __ldg(w + wi + 1) << (32 - sh);
  return ((__ldg(w + wi) >> sh) | hi) & zk_low_mask(n);
}

// A sequence's bit reads on the wide contract: each field from the whole
// row.
struct WideBits {
  const uint32_t* w;
  int WB;
  __device__ __forceinline__ WideBits(const uint32_t* w_, int WB_, int) : w(w_), WB(WB_) {}
  __device__ __forceinline__ uint32_t operator()(int rm, int n) const {
    return read_bits(w, WB, rm, n);
  }
};

// A sequence's bit reads on the ring contract: every field from the four
// words loaded at the sequence's start (`rem`); a field reaching below
// them reads from their floor.
struct RingBits {
  uint32_t w0, w1, w2, w3;
  int wbase;
  __device__ __forceinline__ RingBits(const uint32_t* w, int WB, int rem) {
    const int bw = min(max((int)((unsigned)rem >> 5) - 3, 0), WB - 4);
    w0 = __ldg(w + bw);
    w1 = __ldg(w + bw + 1);
    w2 = __ldg(w + bw + 2);
    w3 = __ldg(w + bw + 3);
    wbase = bw * 32;
  }
  __device__ __forceinline__ uint32_t operator()(int rm, int n) const {
    if (n <= 0) return 0u;
    const int lo = max(rm - n - wbase, 0);
    const int ws = lo >> 5, sh = lo & 31;
    const uint32_t x = ws == 0 ? w0 : ws == 1 ? w1 : ws == 2 ? w2 : w3;
    const uint32_t y = ws == 0 ? w1 : ws == 1 ? w2 : ws == 2 ? w3 : 0u;
    const uint32_t v = sh == 0 ? x : (x >> sh) | (y << (32 - sh));
    return v & zk_low_mask(n);
  }
};

// ---- stage 1: FSE decode, one thread per record ------------------------

struct FseArgs {
  const int* consts;  // (4, 64): LL_BASE, LL_BITS, ML_BASE, ML_BITS
  const int* meta;    // (nrecp, META_COLS)
  int nrecp;
  const uint32_t* words;  // (nw, WB)
  int nw, WB;
  const int* tables;  // (ntables, 512): symbol | nb_bits << 8 | baseline << 16
  int ntables;
  const int* seq_off;        // (nrecp,) first sequence of each record
  int *lls, *mls, *ofvs;     // (total sequences,)
  int* rems;                 // (nrecp,) bits left after each KIND_SEQ record
};

template <Contract C>
__global__ void __launch_bounds__(LANES) fse_kernel(FseArgs a) {
  constexpr bool IS_RING = C == Contract::ring;
  using Bits = typename std::conditional<IS_RING, RingBits, WideBits>::type;
  const int r = blockIdx.x * LANES + threadIdx.x;
  if (r >= a.nrecp) return;
  const int* m = a.meta + (long long)r * META_COLS;
  if (m[M_KIND] != KIND_SEQ) return;
  const uint32_t* w = a.words + (long long)zk_clamp_row(m[M_WROW], a.nw) * a.WB;
  const int* tll = a.tables + (long long)zk_clamp_row(m[M_TLL], a.ntables) * 512;
  const int* tof = a.tables + (long long)zk_clamp_row(m[M_TOF], a.ntables) * 512;
  const int* tml = a.tables + (long long)zk_clamp_row(m[M_TML], a.ntables) * 512;
  const int* c = a.consts;
  const int WB = a.WB;
  const int logs = m[M_LOGS];
  const int ll_log = logs & 31, of_log = (logs >> 5) & 31, ml_log = (logs >> 10) & 31;
  int rem = m[M_STARTBIT];
  int ll_s = (int)read_bits(w, WB, rem, ll_log);
  rem -= ll_log;
  int of_s = (int)read_bits(w, WB, rem, of_log);
  rem -= of_log;
  int ml_s = (int)read_bits(w, WB, rem, ml_log);
  rem -= ml_log;
  const int nseq = m[M_NSEQ];
  const long long base = a.seq_off[r];
  for (int j = 0; j < nseq; ++j) {
    const int of_e = __ldg(tof + (of_s & 511));
    const int ml_e = __ldg(tml + (ml_s & 511));
    const int ll_e = __ldg(tll + (ll_s & 511));
    const Bits rd(w, WB, rem);
    const int of_code = of_e & 0xFF;
    const int ofv = (int)((1u << min(of_code, 31)) + rd(rem, of_code));
    rem -= of_code;
    const int ml_code = ml_e & 0xFF & 63;
    const int mlb = __ldg(c + 192 + ml_code);
    const int ml = __ldg(c + 128 + ml_code) + (int)rd(rem, mlb);
    rem -= mlb;
    const int ll_code = ll_e & 0xFF & 63;
    const int llb = __ldg(c + 64 + ll_code);
    const int ll = __ldg(c + ll_code) + (int)rd(rem, llb);
    rem -= llb;
    // FSE state updates; the bits after the block's last sequence are read
    // but not consumed.
    const bool upd = j + 1 < nseq;
    {
      const int nb = (ll_e >> 8) & 0xFF;
      const int s2 = (ll_e >> 16) + (int)rd(rem, nb);
      if (upd) { rem -= nb; ll_s = s2; }
    }
    {
      const int nb = (ml_e >> 8) & 0xFF;
      const int s2 = (ml_e >> 16) + (int)rd(rem, nb);
      if (upd) { rem -= nb; ml_s = s2; }
    }
    {
      const int nb = (of_e >> 8) & 0xFF;
      const int s2 = (of_e >> 16) + (int)rd(rem, nb);
      if (upd) { rem -= nb; of_s = s2; }
    }
    a.lls[base + j] = ll;
    a.mls[base + j] = ml;
    a.ofvs[base + j] = ofv;
  }
  a.rems[r] = rem;
}

// ---- stage 2: the per-frame scan, one warp per frame -------------------

struct ScanArgs {
  const int* meta;
  int nrecp;
  const int* seq_off;  // wide and ring: (nrecp,); exec: unused
  const int* rems;     // wide and ring: (nrecp,); exec: unused
  const int *lls, *mls, *ofvs;  // wide and ring: (total,); exec: (nrows, SBd)
  int nrows, SBd;               // exec only
  int OUTB;
  int LITB, LROWS;  // the wide and exec contracts' literal window
  int nlit;         // literal pool bytes per frame; reads past it are 0
  int* desc;        // (F, OUTB)
  int* meta_out;  // (F, 128)
};

struct FrameState {
  int pos, r1, r2, r3, bad, litcur, blit;  // blit: exec only
};

// One sequence after the clamps: where its literals and match go.
struct SeqSpan {
  int pos, litcur, ll_w, ml_w, off;
};

// Literal bytes litcur + k of the pool at pos + k, for k in [from, n), the
// lanes side by side; a literal outside the pool reads 0.
__device__ __forceinline__ void put_lits(int* d, int pos, int litcur, int from, int n,
                                         int nlit) {
  for (int k = from + (int)threadIdx.x; k < n; k += LANES) {
    const int i = litcur + k;
    d[pos + k] = i < nlit ? d_lit(i) : D_ZERO;
  }
}

// Match byte mpos + k copies byte mpos - off + (k mod off), for k in
// [from, n), the lanes side by side; a source before the row reads 0
// (only when mpos == 0).
__device__ __forceinline__ void put_match(int* d, int mpos, int off, int from, int n) {
  const int src = mpos - off;
  if (n <= off) {  // no overlap (the common case): no division
    for (int k = from + (int)threadIdx.x; k < n; k += LANES) {
      d[mpos + k] = src + k >= 0 ? src + k : D_ZERO;
    }
    return;
  }
  for (int k = from + (int)threadIdx.x; k < n; k += LANES) {
    const int s = src + (k < off ? k : k % off);
    d[mpos + k] = s >= 0 ? s : D_ZERO;
  }
}

// Lane q holds sequence q of 32. Each lane writes the first SHORT literal
// and match bytes of its own sequence (no shuffle per sequence, no division:
// the match source steps through its period); then the warp writes the
// rest of each longer sequence with its lanes side by side.
constexpr int SHORT = 32;

__device__ __forceinline__ void put_sequences(int* d, const SeqSpan& q, int nlit) {
  const int nl = min(q.ll_w, SHORT);
  for (int k = 0; k < nl; ++k) {
    const int i = q.litcur + k;
    d[q.pos + k] = i < nlit ? d_lit(i) : D_ZERO;
  }
  const int mpos = q.pos + q.ll_w, src = mpos - q.off;
  const int nm = min(q.ml_w, SHORT);
  for (int k = 0, s = src; k < nm; ++k) {
    d[mpos + k] = s >= 0 ? s : D_ZERO;
    if (++s == mpos) s = src;
  }
  unsigned longer = __ballot_sync(FULL, q.ll_w > SHORT || q.ml_w > SHORT);
  while (longer) {
    const int l = __ffs(longer) - 1;
    longer &= longer - 1;
    const int pos = __shfl_sync(FULL, q.pos, l);
    const int ll_w = __shfl_sync(FULL, q.ll_w, l);
    put_lits(d, pos, __shfl_sync(FULL, q.litcur, l), SHORT, ll_w, nlit);
    put_match(d, pos + ll_w, __shfl_sync(FULL, q.off, l), SHORT, __shfl_sync(FULL, q.ml_w, l));
  }
}

// One sequence of a KIND_SEQ record, with the reference's repeat-offset
// rules (RFC 8878 3.1.1.3.2.1.1) and hostile-input clamps: advances the
// frame state and returns where the sequence's bytes go.
template <Contract C>
__device__ __forceinline__ SeqSpan scan_sequence(const ScanArgs& a, int lit_lim,
                                                 FrameState& s, int ll, int ml, int ofv) {
  constexpr bool IS_RING = C == Contract::ring;
  const int ridx = ofv > 3 ? 0 : ofv + (ll == 0 ? 1 : 0);
  const int off = ofv > 3 ? ofv - 3
                  : ridx == 1 ? s.r1 : ridx == 2 ? s.r2 : ridx == 3 ? s.r3 : s.r1 - 1;
  const bool moved = ofv > 3 || ridx != 1;
  const int nr3 = ridx == 2 ? s.r3 : (moved ? s.r2 : s.r3);
  const int nr2 = moved ? s.r1 : s.r2;
  const int nr1 = moved ? off : s.r1;
  s.r1 = nr1; s.r2 = nr2; s.r3 = nr3;
  const int ll_w = min(min(ll, a.OUTB - s.pos), max(lit_lim - s.litcur, 0));
  const int mpos = s.pos + ll_w;
  const int ml_w = min(ml, a.OUTB - mpos);
  if (IS_RING) {
    s.bad |= ll_w != ll || (ml > 0 && (off <= 0 || off > mpos || off > RING)) || ml_w != ml;
  } else {
    s.bad |= ll_w != ll || (ml > 0 && (off <= 0 || off > mpos)) || ml_w != ml;
  }
  const int reach = IS_RING ? min(mpos, RING) : mpos;
  const SeqSpan q{s.pos, s.litcur, ll_w, ml_w, min(max(off, 1), max(reach, 1))};
  s.pos = mpos + ml_w;
  s.litcur += ll_w;
  return q;
}

template <Contract C>
__global__ void __launch_bounds__(LANES) scan_kernel(ScanArgs a) {
  constexpr bool IS_RING = C == Contract::ring;
  constexpr int MC = C == Contract::exec ? EXEC_META_COLS : META_COLS;
  const int f = blockIdx.x;
  const int lane = threadIdx.x;
  int* d = a.desc + (long long)f * a.OUTB;
  const int nlit = a.nlit;
  const int lrws = a.LITB / 128 + 1;
  FrameState s{0, 1, 4, 8, 0, 0, 0};
  for (int r0 = 0; r0 < a.nrecp; r0 += LANES) {
    // The records of this frame among the next 32, in order.
    const int rr = r0 + lane;
    const int* mr = a.meta + (long long)rr * MC;
    unsigned hits = __ballot_sync(
        FULL, rr < a.nrecp && mr[M_KIND] != KIND_NOP && mr[M_FRAME] == f);
    while (hits) {
      const int r = r0 + __ffs(hits) - 1;
      hits &= hits - 1;
      int v;
      if constexpr (C == Contract::exec) {
        v = lane < MC ? a.meta[(long long)r * MC + lane] : 0;
      } else {
        v = lane < MC ? a.meta[(long long)r * MC + lane]
            : lane == COL_SEQ_OFF ? a.seq_off[r]
            : lane == COL_REM ? a.rems[r] : 0;
      }
      const int kind = __shfl_sync(FULL, v, M_KIND);
      const int flags = __shfl_sync(FULL, v, M_FLAGS);
      const int litn = __shfl_sync(FULL, v, M_LITN);
      if (flags & F_FRAME_START) s = FrameState{0, 1, 4, 8, 0, 0, 0};
      if constexpr (C == Contract::exec) {
        if (flags & F_BLOCK_START) s.blit = s.litcur;
      }
      const int litcur0 = s.litcur;
      // The record's literal limit, fixed where it starts: the block's
      // budget (ring), or LITB + 128 bytes from the 128-byte row holding its
      // first literal (wide, exec).
      const int lit_lim = IS_RING ? litcur0 + litn
                                  : min(litcur0 / 128, a.LROWS - lrws) * 128 + a.LITB + 128;
      if (kind == KIND_SEQ) {
        int nseq, rem = 0;
        long long base;
        if constexpr (C == Contract::exec) {
          nseq = min(max(__shfl_sync(FULL, v, M_NSEQ), 0), a.SBd);
          base = (long long)min(max(__shfl_sync(FULL, v, M_ROW), 0), a.nrows - 1) * a.SBd;
        } else {
          nseq = __shfl_sync(FULL, v, M_NSEQ);
          base = __shfl_sync(FULL, v, COL_SEQ_OFF);
          rem = __shfl_sync(FULL, v, COL_REM);
        }
        int nx_ll = 0, nx_ml = 0, nx_ofv = 0;
        if (lane < nseq) {
          nx_ll = a.lls[base + lane];
          nx_ml = a.mls[base + lane];
          nx_ofv = a.ofvs[base + lane];
        }
        for (int j0 = 0; j0 < nseq; j0 += LANES) {
          const int my_ll = nx_ll, my_ml = nx_ml, my_ofv = nx_ofv;
          const int jn = j0 + LANES + lane;
          if (jn < nseq) {
            nx_ll = a.lls[base + jn];
            nx_ml = a.mls[base + jn];
            nx_ofv = a.ofvs[base + jn];
          }
          const int cnt = min(LANES, nseq - j0);
          SeqSpan mine{0, 0, 0, 0, 1};
          for (int q = 0; q < cnt; ++q) {
            const SeqSpan o = scan_sequence<C>(a, lit_lim, s, __shfl_sync(FULL, my_ll, q),
                                               __shfl_sync(FULL, my_ml, q),
                                               __shfl_sync(FULL, my_ofv, q));
            if (lane == q) mine = o;
          }
          put_sequences(d, mine, nlit);
        }
        if constexpr (C == Contract::exec) {
          // After a block's last slice, what the block's literal budget
          // leaves after every slice trails them.
          const int trail = (flags & F_BLOCK_END) ? litn - (s.litcur - s.blit) : 0;
          s.bad |= trail < 0;
          const int trail_c =
              min(min(max(trail, 0), a.OUTB - s.pos), max(lit_lim - s.litcur, 0));
          s.bad |= trail_c != max(trail, 0);
          put_lits(d, s.pos, s.litcur, 0, trail_c, nlit);
          s.pos += trail_c;
          s.litcur += trail_c;
        } else {
          // The stream must land on exactly zero remaining bits; what the
          // block's literal budget leaves after its sequences trails them.
          s.bad |= rem != 0;
          const int trail = litn - (s.litcur - litcur0);
          s.bad |= trail < 0;
          int trail_c = min(max(trail, 0), a.OUTB - s.pos);
          if (!IS_RING) trail_c = min(trail_c, max(lit_lim - s.litcur, 0));
          s.bad |= trail_c != max(trail, 0);
          put_lits(d, s.pos, s.litcur, 0, trail_c, nlit);
          s.pos += trail_c;
          s.litcur += trail_c;
        }
      } else if (kind == KIND_LIT) {
        int litn_w = min(litn, a.OUTB - s.pos);
        if (!IS_RING) litn_w = min(litn_w, max(lit_lim - litcur0, 0));
        s.bad |= litn_w != litn;
        put_lits(d, s.pos, litcur0, 0, litn_w, nlit);
        s.pos += litn_w;
        s.litcur = litcur0 + litn_w;
      } else if (kind == KIND_RLE) {
        const int litn_w = min(litn, a.OUTB - s.pos);
        s.bad |= litn_w != litn;
        const int byte = d_byte(__shfl_sync(FULL, v, M_RLEBYTE) & 0xFF);
        for (int k = lane; k < litn_w; k += LANES) d[s.pos + k] = byte;
        s.pos += litn_w;
      }
      if ((flags & F_FRAME_END) && lane == 0) {
        int* mo = a.meta_out + (long long)f * 128;
        mo[0] = s.pos;
        mo[1] = s.bad;
        mo[2] = s.litcur;
      }
    }
  }
}

// ---- stage 3: pointer jumping and the byte gather ----------------------

constexpr int RESOLVE_THREADS = 256;
constexpr int MAX_GRID_Y = 65535;

// dst = src with every pointer replaced by its target's descriptor; four
// descriptors per thread (OUTB is a multiple of 4).
__global__ void __launch_bounds__(RESOLVE_THREADS)
jump_kernel(const int* __restrict__ src, int* __restrict__ dst, int F, int OUTB) {
  for (int f = blockIdx.y; f < F; f += gridDim.y) {
    const int* s = src + (long long)f * OUTB;
    int* t = dst + (long long)f * OUTB;
    for (int i = (blockIdx.x * RESOLVE_THREADS + threadIdx.x) * 4; i < OUTB;
         i += gridDim.x * RESOLVE_THREADS * 4) {
      int4 v = *reinterpret_cast<const int4*>(s + i);
      if (v.x >= 0) v.x = __ldg(s + v.x);
      if (v.y >= 0) v.y = __ldg(s + v.y);
      if (v.z >= 0) v.z = __ldg(s + v.z);
      if (v.w >= 0) v.w = __ldg(s + v.w);
      *reinterpret_cast<int4*>(t + i) = v;
    }
  }
}

// A terminal's byte: t < 256 is the byte t, else literal t - 256 of the
// frame's pool (int32 per byte on the wide contract, bytes on the ring).
template <typename Lit>
__device__ __forceinline__ uint32_t terminal_byte(int dv, const Lit* __restrict__ lit) {
  const int t = -1 - dv;
  return t < 256 ? (uint32_t)t : (uint32_t)(__ldg(lit + (t - 256)) & 0xFF);
}

template <typename Lit>
__global__ void __launch_bounds__(RESOLVE_THREADS)
gather_kernel(const int* __restrict__ desc, const Lit* __restrict__ lits,
              long long lrow, uint8_t* __restrict__ out, int F, int OUTB) {
  for (int f = blockIdx.y; f < F; f += gridDim.y) {
    const int* s = desc + (long long)f * OUTB;
    const Lit* lit = lits + f * lrow;
    uint8_t* o = out + (long long)f * OUTB;
    for (int i = (blockIdx.x * RESOLVE_THREADS + threadIdx.x) * 4; i < OUTB;
         i += gridDim.x * RESOLVE_THREADS * 4) {
      const int4 v = *reinterpret_cast<const int4*>(s + i);
      *reinterpret_cast<uint32_t*>(o + i) =
          terminal_byte(v.x, lit) | terminal_byte(v.y, lit) << 8 |
          terminal_byte(v.z, lit) << 16 | terminal_byte(v.w, lit) << 24;
    }
  }
}

template <Contract C>
int fse_launch(const void* consts, const void* meta, int nrecp, const void* words, int nw,
               int WB, const void* tables, int ntables, const void* seq_off, void* lls,
               void* mls, void* ofvs, void* rems, void* stream) {
  const FseArgs a{(const int*)consts, (const int*)meta, nrecp, (const uint32_t*)words, nw,
                  WB, (const int*)tables, ntables, (const int*)seq_off, (int*)lls,
                  (int*)mls, (int*)ofvs, (int*)rems};
  if (nrecp > 0) {
    fse_kernel<C>
        <<<(nrecp + LANES - 1) / LANES, LANES, 0, (cudaStream_t)stream>>>(a);
  }
  return zk_last_error();
}

template <Contract C>
int scan_launch(const void* meta, int nrecp, const void* seq_off, const void* rems,
                const void* lls, const void* mls, const void* ofvs, int nrows, int SBd, int F,
                int OUTB, int LITB, int LROWS, int nlit, void* desc, void* meta_out,
                void* stream) {
  const ScanArgs a{(const int*)meta, nrecp, (const int*)seq_off, (const int*)rems,
                   (const int*)lls, (const int*)mls, (const int*)ofvs, nrows, SBd, OUTB, LITB,
                   LROWS, nlit, (int*)desc, (int*)meta_out};
  if (F > 0) scan_kernel<C><<<F, LANES, 0, (cudaStream_t)stream>>>(a);
  return zk_last_error();
}

// Runs ceil(log2(OUTB)) jump rounds from desc_a (desc_b is the other
// buffer), then the gather of each frame's pool row of `lrow` elements
// into out.
template <typename Lit>
int resolve_launch(void* desc_a, void* desc_b, const Lit* lits, long long lrow, int F,
                   int OUTB, void* out, void* stream) {
  if (F <= 0 || OUTB <= 0) return zk_last_error();
  const cudaStream_t st = (cudaStream_t)stream;
  const int per_block = RESOLVE_THREADS * 4;
  const dim3 grid((OUTB + per_block - 1) / per_block, F < MAX_GRID_Y ? F : MAX_GRID_Y);
  int* cur = (int*)desc_a;
  int* nxt = (int*)desc_b;
  for (long long span = 1; span < OUTB; span <<= 1) {
    jump_kernel<<<grid, RESOLVE_THREADS, 0, st>>>(cur, nxt, F, OUTB);
    if (int e = zk_last_error()) return e;
    int* t = cur;
    cur = nxt;
    nxt = t;
  }
  gather_kernel<Lit><<<grid, RESOLVE_THREADS, 0, st>>>(cur, lits, lrow, (uint8_t*)out, F, OUTB);
  return zk_last_error();
}

}  // namespace

// Wide contract: lits int32[F, LROWS, 128], out uint8[F, OUTB] (OUTB a
// multiple of 128).
extern "C" int zk_wide_fse_launch(const void* consts, const void* meta, int nrecp,
                                  const void* words, int nw, int WB, const void* tables,
                                  int ntables, const void* seq_off, void* lls, void* mls,
                                  void* ofvs, void* rems, void* stream) {
  return fse_launch<Contract::wide>(consts, meta, nrecp, words, nw, WB, tables, ntables, seq_off, lls,
                           mls, ofvs, rems, stream);
}

extern "C" int zk_wide_scan_launch(const void* meta, int nrecp, const void* seq_off,
                                   const void* rems, const void* lls, const void* mls,
                                   const void* ofvs, int F, int OUTB, int LITB, int LROWS,
                                   void* desc, void* meta_out, void* stream) {
  return scan_launch<Contract::wide>(meta, nrecp, seq_off, rems, lls, mls, ofvs, 0, 0, F, OUTB, LITB,
                           LROWS, LROWS * 128, desc, meta_out, stream);
}

extern "C" int zk_wide_resolve_launch(void* desc_a, void* desc_b, const void* lits, int F,
                                      int LROWS, int OUTB, void* out, void* stream) {
  return resolve_launch((void*)desc_a, desc_b, (const int*)lits, (long long)LROWS * 128, F,
                        OUTB, out, stream);
}

// Ring contract: lit_words int32[F, LW] read as LW * 4 bytes per frame,
// out the bytes of int32[F, OUTB / 4] (OUTB a multiple of 4), WB >= 4.
extern "C" int zk_ring_fse_launch(const void* consts, const void* meta, int nrecp,
                                  const void* words, int nw, int WB, const void* tables,
                                  int ntables, const void* seq_off, void* lls, void* mls,
                                  void* ofvs, void* rems, void* stream) {
  return fse_launch<Contract::ring>(consts, meta, nrecp, words, nw, WB, tables, ntables, seq_off, lls,
                          mls, ofvs, rems, stream);
}

extern "C" int zk_ring_scan_launch(const void* meta, int nrecp, const void* seq_off,
                                   const void* rems, const void* lls, const void* mls,
                                   const void* ofvs, int F, int OUTB, int LW, void* desc,
                                   void* meta_out, void* stream) {
  return scan_launch<Contract::ring>(meta, nrecp, seq_off, rems, lls, mls, ofvs, 0, 0, F, OUTB, 0, 0,
                           LW * 4, desc, meta_out, stream);
}

extern "C" int zk_ring_resolve_launch(void* desc_a, void* desc_b, const void* lit_words,
                                      int F, int LW, int OUTB, void* out, void* stream) {
  return resolve_launch(desc_a, desc_b, (const uint8_t*)lit_words, (long long)LW * 4, F, OUTB,
                        out, stream);
}

// Exec contract: meta int32[nrecp, 8], lls/mls/ofvs int32[nrows, SBd]
// (nrows >= 1), the wide contract's pools int32[F, LROWS, 128] and output
// uint8[F, OUTB]; the resolve is zk_wide_resolve_launch. A literal index
// never exceeds the position it is written to, so the descriptors hold any
// OUTB below 2^31 - 256 and the pool size passes clipped to int.
extern "C" int zk_exec_scan_launch(const void* meta, int nrecp, const void* lls,
                                   const void* mls, const void* ofvs, int nrows, int SBd, int F,
                                   int OUTB, int LITB, int LROWS, void* desc, void* meta_out,
                                   void* stream) {
  const long long nlit = (long long)LROWS * 128;
  return scan_launch<Contract::exec>(meta, nrecp, nullptr, nullptr, lls, mls, ofvs, nrows, SBd, F, OUTB,
                           LITB, LROWS, nlit < 0x7FFFFFFF ? (int)nlit : 0x7FFFFFFF, desc,
                           meta_out, stream);
}
