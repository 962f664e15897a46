// FSE sequence decode for Hopper, behind zk_fse_seq_decode_launch.
//
// Replaces an XLA scan, not a Pallas kernel: fse_decode_sequences of
// zeekstd_tpu/ops/entropy.py:199, vmapped over blocks by
// zeekstd_tpu/tpu_codec.py::_get_fse_decode_packed_fn (the device FSE
// dispatch of the serial and pointer-doubling decode routes). Per block:
// read the three initial states (ll, of, ml), then per sequence the extra
// bits of of, ml and ll, resolve the repeat offset against a fresh
// (1, 4, 8) history, and update the states (ll, ml, of; skipped after the
// block's last sequence). Outputs lls, mls, offs (resolved offsets), ofvs
// (raw offset values), padded past n_seq with (0, 0, 1, 4); the final
// repeat history; and hasrep, whether any sequence uses a repeat form that
// could depend on an earlier block. The plain version is
// ops/entropy.py::fse_decode_plain.
//
// The arithmetic is the reference's to the bit, hostile streams included:
// bit reads clip each of the two word indices and mask all 32 bits for
// n >= 32 (n <= 0 reads 0); 1 << of_code is 0 for of_code >= 32 (an XLA
// shift) and wraps in int32 below; a table index counts from the end when
// negative and is then clamped (JAX's gather); an offset index outside
// 1..4 resolves to 0 and moves nothing.
//
// What bounds it on this card: latency. Each state depends on the bits the
// previous sequence consumed, so a block is a serial chain: a table load,
// the bit position its entries give, the word loads at that position, the
// next state. Blocks are independent. The bytes are few (the bound is
// about 11 us at the level-3 serial shapes), so the time is the longest
// block's chain, one dependent instruction after another.
//
// What the design does about it:
// - One thread block (one warp) per stream row, over all rows: the real
//   blocks spread over every SM. Rows past their n_seq get only their
//   padding, written coalesced before the walk starts.
// - The warp stages what the chain reads in shared memory: the three table
//   rows (ll and ml at 512 entries, of at 256), each entry with the bits a
//   step takes for it (extra bits plus state bits) and its baseline as a
//   byte offset, so a step takes one shared load per stream; and a window
//   of the row's bitstream words. A valid walk only reads words below
//   (start_bits >> 5) + 2 and its position never rises, so the window is
//   the top stage_words words under that, slid down as the walk passes
//   below it (rows longer than the budget: libzstd's 128 KiB blocks). A
//   read whose clipped word index lies outside the window goes to global
//   memory, so results never depend on where a word came from.
// - Only the state walk is serial, and it is kept short. All 32 lanes run
//   the same walk (the loads are broadcasts). On rows whose every table
//   entry is safe (as in every valid zstd table: next states stay in the
//   row, at most 10 state bits), a state is its entry's byte offset, and
//   on a batch whose positions provably stay in the window a step is: the
//   three entries, the position below the step's bits, one shared pair of
//   words holding all three state reads, the next offsets - no clamps and
//   no checks. Other rows and batches take the checked walks, which follow
//   the reference's clamps and clips to the bit.
// - Lane L keeps the records (position and entries) of sequences 2L and
//   2L + 1 of a batch of 64. Then each lane decodes its two sequences'
//   ofv, ml and ll, the warp resolves the repeat offsets with a scan (a
//   sequence maps the history (r1, r2, r3) to slots that are an old slot
//   plus a constant or a constant, and such maps compose), and the lanes
//   store the four rows coalesced, in pairs.
// - Measured and left out (tools/torch_fse_decode_steps.py splits the
//   step's cycles and times other versions of this file in turns): a
//   second warp decoding behind the walk (the walk's step grew by about a
//   third), and loading a step's candidate words before its entries (the
//   compiler moved the loads back under the selects that pick them).

#include "common.cuh"

namespace {

constexpr int WARP = 32;
constexpr int BATCH = 2 * WARP;  // sequences per batch: lane L decodes 2L and 2L + 1
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int LL_CODES = 36, ML_CODES = 53;
// Slide the window once the walk's position is within this many words of
// its bottom: more than a batch of valid sequences reads (at most 89 bits
// each, 178 words).
constexpr int SLIDE_MARGIN = 256;
// Staged table rows: per entry an int4 of the packed entry, the bits a
// step takes for it (extra bits plus state bits) and its baseline times
// 16, the byte offset of the next state's entry when the row is checked
// safe. Byte offsets of the ll, ml and of rows, the constants (int) and
// the window.
constexpr int LL_OFF = 0, ML_OFF = 512 * 16, OF_OFF = 2 * 512 * 16;
constexpr int C_OFF = OF_OFF + 256 * 16;
constexpr int TABLE_BYTES = C_OFF + 256 * 4;
// Repeat-history maps: slot s of the new history is old slot k_s plus v_s
// (mod 2^32), or the constant v_s when k_s == 3. The k_s pack 2 bits each.
constexpr int K_IDENT = 0 | 1 << 2 | 2 << 4;
constexpr int K_PUSH = 3 | 0 << 2 | 1 << 4;  // (v, r1, r2)
constexpr int K_REP2 = 1 | 0 << 2 | 2 << 4;  // (r2, r1, r3)
constexpr int K_REP3 = 2 | 0 << 2 | 1 << 4;  // (r3, r1, r2)
constexpr int K_DEC1 = 0 | 0 << 2 | 1 << 4;  // (r1 - 1, r1, r2), with v_0 = -1

struct HMap {
  int k;
  uint32_t v[3];
};

__device__ __forceinline__ HMap compose(const HMap& first, const HMap& then) {
  HMap out{0, {0, 0, 0}};
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    const int k = (then.k >> (2 * s)) & 3;
    const uint32_t fv = k == 0 ? first.v[0] : k == 1 ? first.v[1] : first.v[2];
    out.k |= (k == 3 ? 3 : (first.k >> (2 * k)) & 3) << (2 * s);
    out.v[s] = k == 3 ? then.v[s] : fv + then.v[s];
  }
  return out;
}

__device__ __forceinline__ uint32_t apply_slot(const HMap& m, int s, uint32_t h1, uint32_t h2,
                                               uint32_t h3) {
  const int k = (m.k >> (2 * s)) & 3;
  return k == 3 ? m.v[s] : (k == 0 ? h1 : k == 1 ? h2 : h3) + m.v[s];
}

__device__ __forceinline__ HMap shfl_up(const HMap& m, int d) {
  return {__shfl_up_sync(FULL, m.k, d),
          {__shfl_up_sync(FULL, m.v[0], d), __shfl_up_sync(FULL, m.v[1], d),
           __shfl_up_sync(FULL, m.v[2], d)}};
}

// A sequence's record: its position and its three entries' byte offsets.
struct Rec {
  int rem, l, m, o;
};

// A decoded sequence: its values, its map of the repeat history, whether
// its offset is the history's new r1 (else 0), and whether it uses a
// repeat form that may depend on an earlier block.
struct Seq {
  int ll, ml, ofv;
  HMap map;
  bool uses, flag;
};

struct FseArgs {
  const uint32_t* words;  // (B, WB)
  int WB;
  const int* start_bits;  // (B,)
  const int* nseq;        // (B,)
  const int* tidx;        // (B, 3): ll, of, ml table rows
  const int* tables;      // (ntables, 512): symbol | nb_bits << 8 | baseline << 16
  int ntables;
  const int* logs;    // (ntables,) accuracy logs
  const int* consts;  // (4, 64): LL_BASE, LL_BITS, ML_BASE, ML_BITS
  int B, SB;
  int stage_words;  // window size in words
  bool vec;         // rows and window are 16-byte aligned: stage with uint4
  int *lls, *mls, *offs, *ofvs;  // (B, SB)
  int* reps;                     // (B, 3)
  int* hasrep;                   // (B,)
};

__device__ __forceinline__ int take_idx(int i, int size) {
  if (i < 0) i += size;
  return min(max(i, 0), size - 1);
}

__device__ __forceinline__ uint32_t bit_mask(int n) {
  return n >= 32 ? FULL : (1u << (n & 31)) - 1u;
}

__device__ __forceinline__ int4 entry_at(const unsigned char* smem, int byte_off) {
  return *reinterpret_cast<const int4*>(smem + byte_off);
}

// A row's bitstream: words [base, top) staged in s, the rest read from g.
struct Stream {
  const uint32_t* g;
  uint32_t* s;
  int WB, base, top;
  int last;  // the last shared index a pair of words may start at

  __device__ __forceinline__ uint32_t word(int i) const {
    i = min(max(i, 0), WB - 1);
    const int k = i - base;
    return (unsigned)k < (unsigned)(top - base) ? s[k] : __ldg(g + i);
  }

  // n bits of the backward stream ending at bit rem (the reference's read).
  __device__ __forceinline__ uint32_t read(int rem, int n) const {
    const int lo = rem - n;
    const int wi = lo >> 5;
    const int k = wi - base;
    uint32_t w0, w1;
    if (k >= 0 && k + 1 < top - base) {  // both words staged, no clip
      w0 = s[k];
      w1 = s[k + 1];
    } else {
      w0 = word(wi);
      w1 = word(wi + 1);
    }
    const uint32_t both = __funnelshift_r(w0, w1, (unsigned)lo & 31u);
    return n <= 0 ? 0u : both & bit_mask(n);
  }

  // n bits at bit lo from the shared pair at word lo >> 5, at an index
  // clamped into the buffer: right when both words are staged.
  __device__ __forceinline__ uint32_t staged_bits(int lo, int n) const {
    const int k = min(max((lo >> 5) - base, 0), last);
    const uint32_t both = __funnelshift_r(s[k], s[k + 1], (unsigned)lo & 31u);
    return n <= 0 ? 0u : both & bit_mask(n);
  }

  // A step's three state reads, of bits [q, q + no), ml bits above them
  // and ll bits above those (the reference reads them top down): one
  // shared pair when the bits fit 32 and the pair is staged, else read().
  __device__ __forceinline__ void read_states(int q, int nl, int nm, int no, uint32_t& bl,
                                              uint32_t& bm, uint32_t& bo) const {
    const int k = (q >> 5) - base;
    const int kc = (int)min((unsigned)k, (unsigned)last);
    const uint32_t x = __funnelshift_r(s[kc], s[kc + 1], (unsigned)q & 31u);
    bo = x & bit_mask(no);
    bm = __funnelshift_rc(x, 0u, no) & bit_mask(nm);
    bl = __funnelshift_rc(x, 0u, no + nm) & bit_mask(nl);
    if (nl + nm + no > 32 || (unsigned)k >= (unsigned)(top - base - 1)) {
      const int q1 = (int)((unsigned)q + no), q2 = (int)((unsigned)q1 + nm);
      bl = read((int)((unsigned)q2 + nl), nl);
      bm = read(q2, nm);
      bo = read(q1, no);
    }
  }

  // Three reads down from bit pos, in the reference's order: n1 bits
  // ending at pos, n2 bits below them, n3 below those. The shared loads
  // issue first; one check then sends a step that touches any word outside
  // the window (or a clipped index) to read(). Returns the position below.
  __device__ __forceinline__ int read3(int pos, int n1, int n2, int n3, uint32_t& b1,
                                       uint32_t& b2, uint32_t& b3) const {
    const int lo1 = pos - n1, lo2 = lo1 - n2, lo3 = lo2 - n3;
    b1 = staged_bits(lo1, n1);
    b2 = staged_bits(lo2, n2);
    b3 = staged_bits(lo3, n3);
    const int lo_min = min(lo1, min(lo2, lo3)), lo_max = max(lo1, max(lo2, lo3));
    if ((lo_min >> 5) < base || (lo_max >> 5) + 1 >= top) {
      b1 = read(pos, n1);
      b2 = read(lo1, n2);
      b3 = read(lo2, n3);
    }
    return lo3;
  }

  // Place the window under bit position rem (the top word a read below rem
  // touches is (rem >> 5) + 1) and load it; base stays a multiple of 4.
  __device__ __forceinline__ void load(int rem, int size, bool vec, int lane) {
    top = min(max((rem >> 5) + 2, 1), WB);
    base = max(0, (top - size + 3) & ~3);
    const int n = top - base;
    if (vec) {
      const uint4* g4 = reinterpret_cast<const uint4*>(g + base);
      uint4* s4 = reinterpret_cast<uint4*>(s);
#pragma unroll 4
      for (int q = lane; q < (n + 3) >> 2; q += WARP) s4[q] = __ldg(g4 + q);
    } else {
      for (int q = lane; q < n; q += WARP) s[q] = __ldg(g + base + q);
    }
  }
};

// Stage one entry of a table row: the packed entry, the bits a step takes
// for it and its baseline as a byte offset. Returns whether the entry is
// safe: every next state it gives (baseline plus fewer than 2^nb bits)
// lies in the row, nb <= 10 (a step's three state reads fit 32 bits) and
// 0 <= extra bits <= 31, as in every valid zstd table; sets step to the
// bits a step takes for it.
__device__ __forceinline__ bool stage_entry(unsigned char* smem, int row_off, int k, int e,
                                            uint32_t extra, int size, int& step) {
  const int nb = (e >> 8) & 0xFF, baseline = e >> 16;
  step = (int)(extra + nb);
  *reinterpret_cast<int4*>(smem + row_off + k * 16) = make_int4(e, step, baseline * 16, 0);
  return baseline >= 0 && nb <= 10 && baseline + (1 << nb) <= size && extra <= 31u;
}

// How a batch walks: ANY row (the reference's states, clamped as JAX's
// gather does, each read checked against the window); SAFE rows (every
// entry safe and the initial states below their rows' sizes: a state is
// its entry's byte offset, reads still checked); and IN_WINDOW batches of
// safe rows, whose every position provably stays in the window (it never
// rises, and falls at most cnt times the largest step), so a step's state
// reads are one shared pair with no check.
enum Walk { ANY, SAFE, IN_WINDOW };

// The walk of one batch of cnt sequences from (rem, ll, ml, of): every
// lane the same chain; lane L keeps the records of sequences 2L (ra) and
// 2L + 1 (rb). A step: the three entries, the position below the step's
// bits, the state bits, the next states.
template <Walk W>
__device__ __forceinline__ void walk(const unsigned char* smem, const Stream& st, int& rem,
                                     int& sl, int& sm, int& so, int cnt, int lane, Rec& ra,
                                     Rec& rb) {
#pragma unroll 4
  for (int j = 0; j < cnt; ++j) {
    const int ol = W != ANY ? sl : take_idx(sl, 512) * 16;
    const int om = W != ANY ? sm : take_idx(sm, 512) * 16;
    const int oo = W != ANY ? so : take_idx(so, 256) * 16;
    if (lane == j >> 1) {
      if (j & 1) {
        rb = {rem, ol, om, oo};
      } else {
        ra = {rem, ol, om, oo};
      }
    }
    const int4 el = entry_at(smem + LL_OFF, ol);
    const int4 em = entry_at(smem + ML_OFF, om);
    const int4 eo = entry_at(smem + OF_OFF, oo);
    // The reference skips the state update after a block's last sequence;
    // nothing reads the states after it, so every step updates.
    rem = (int)((uint32_t)rem - el.y - em.y - eo.y);
    const int nl = (el.x >> 8) & 0xFF, nm = (em.x >> 8) & 0xFF, no = (eo.x >> 8) & 0xFF;
    uint32_t bl, bm, bo;
    if (W == IN_WINDOW) {
      const int k = (rem >> 5) - st.base;
      const uint32_t x = __funnelshift_r(st.s[k], st.s[k + 1], (unsigned)rem & 31u);
      bo = x & ((1u << no) - 1u);
      bm = (x >> no) & ((1u << nm) - 1u);
      bl = (x >> (no + nm)) & ((1u << nl) - 1u);
    } else {
      st.read_states(rem, nl, nm, no, bl, bm, bo);
    }
    if (W != ANY) {
      sl = el.z + (int)(bl << 4);
      sm = em.z + (int)(bm << 4);
      so = eo.z + (int)(bo << 4);
    } else {
      sl = (int)((uint32_t)(el.x >> 16) + bl);
      sm = (int)((uint32_t)(em.x >> 16) + bm);
      so = (int)((uint32_t)(eo.x >> 16) + bo);
    }
  }
}

// Sequence i's values from its record, as the reference reads them: ofv,
// then ml, then ll, down from the record's position.
__device__ __forceinline__ Seq decode_seq(const unsigned char* smem, const Stream& st,
                                          const Rec& r, bool live, int i) {
  const int* s_c = reinterpret_cast<const int*>(smem + C_OFF);
  const int4 el = entry_at(smem + LL_OFF, r.l);
  const int4 em = entry_at(smem + ML_OFF, r.m);
  const int4 eo = entry_at(smem + OF_OFF, r.o);
  const int of_code = eo.x & 0xFF;
  uint32_t bo, bm, bl;
  st.read3(r.rem, of_code, (int)((uint32_t)em.y - ((em.x >> 8) & 0xFF)),
           (int)((uint32_t)el.y - ((el.x >> 8) & 0xFF)), bo, bm, bl);
  Seq q;
  q.ofv = (int)((of_code >= 32 ? 0u : 1u << of_code) + bo);
  q.ml = (int)((uint32_t)s_c[128 + min(em.x & 0xFF, ML_CODES - 1)] + bm);
  q.ll = (int)((uint32_t)s_c[min(el.x & 0xFF, LL_CODES - 1)] + bl);
  // Repeat-offset resolution (RFC 8878 3.1.1.3.2.1.1), as the reference
  // selects it: an index outside 1..4 resolves to 0 and moves nothing.
  const int idx = q.ofv <= 3 ? q.ofv + (q.ll == 0 ? 1 : 0) : 0;
  q.uses = q.ofv > 3 || (idx >= 1 && idx <= 4);
  q.flag = live && q.ofv <= 3 && !(q.ofv == 1 && q.ll > 0 && i >= 1);
  q.map = {K_IDENT, {0, 0, 0}};
  if (live) {
    if (q.ofv > 3) {
      q.map = {K_PUSH, {(uint32_t)q.ofv - 3u, 0, 0}};
    } else if (idx == 2) {
      q.map.k = K_REP2;
    } else if (idx == 3) {
      q.map.k = K_REP3;
    } else if (idx == 4) {
      q.map = {K_DEC1, {FULL, 0, 0}};
    }
  }
  return q;
}

__global__ void __launch_bounds__(WARP) fse_decode_kernel(FseArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* s_w = reinterpret_cast<uint32_t*>(smem + TABLE_BYTES);

  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const int SB = a.SB;
  const long long row = (long long)b * SB;
  const int n = a.nseq[b];
  const int nn = min(max(n, 0), SB);
  for (int i = nn + lane; i < SB; i += WARP) {
    a.lls[row + i] = 0;
    a.mls[row + i] = 0;
    a.offs[row + i] = 1;
    a.ofvs[row + i] = 4;
  }
  uint32_t h1 = 1, h2 = 4, h3 = 8;  // the repeat history
  bool rep = false;
  if (nn > 0) {
    const int* t3 = a.tidx + (long long)b * 3;
    const int tl = take_idx(t3[0], a.ntables);
    const int to = take_idx(t3[1], a.ntables);
    const int tm = take_idx(t3[2], a.ntables);
    const int ll_log = __ldg(a.logs + tl), of_log = __ldg(a.logs + to),
              ml_log = __ldg(a.logs + tm);
    const int* c = a.consts;
    bool safe = (unsigned)ll_log <= 9u && (unsigned)ml_log <= 9u && (unsigned)of_log <= 8u;
    int max_l = 0, max_m = 0, max_o = 0, step;
    for (int k = lane; k < 256; k += WARP) {
      reinterpret_cast<int*>(smem + C_OFF)[k] = __ldg(c + k);
      const int eo = __ldg(a.tables + (long long)to * 512 + k);
      safe &= stage_entry(smem, OF_OFF, k, eo, eo & 0xFF, 256, step);
      max_o = max(max_o, step);
    }
    for (int k = lane; k < 512; k += WARP) {
      const int el = __ldg(a.tables + (long long)tl * 512 + k);
      const int em = __ldg(a.tables + (long long)tm * 512 + k);
      safe &= stage_entry(smem, LL_OFF, k, el, __ldg(c + 64 + min(el & 0xFF, LL_CODES - 1)), 512,
                          step);
      max_l = max(max_l, step);
      safe &= stage_entry(smem, ML_OFF, k, em, __ldg(c + 192 + min(em & 0xFF, ML_CODES - 1)),
                          512, step);
      max_m = max(max_m, step);
    }
    safe = __all_sync(FULL, safe);
    // The most bits a step of a safe row takes (each term at most 41).
    const int max_step = __reduce_max_sync(FULL, max_l) + __reduce_max_sync(FULL, max_m) +
                         __reduce_max_sync(FULL, max_o);
    Stream st{a.words + (long long)b * a.WB, s_w, a.WB, 0, 0, max(a.stage_words - 2, 0)};
    int rem = a.start_bits[b];
    st.load(rem, a.stage_words, a.vec, lane);
    __syncwarp();

    uint32_t b_ll, b_of, b_ml;
    rem = st.read3(rem, ll_log, of_log, ml_log, b_ll, b_of, b_ml);
    int sl = (int)b_ll, so = (int)b_of, sm = (int)b_ml;
    if (safe) {  // initial states below 2^log fit their rows
      sl <<= 4;
      sm <<= 4;
      so <<= 4;
    }

    const bool pairs = SB % 2 == 0;  // rows 8-byte aligned: store pairs as int2
    for (int i0 = 0; i0 < nn; i0 += BATCH) {
      if (st.base > 0 && (rem >> 5) - SLIDE_MARGIN < st.base) {
        __syncwarp();
        st.load(rem, a.stage_words, a.vec, lane);
        __syncwarp();
      }
      const int cnt = min(BATCH, nn - i0);
      Rec ra{0, 0, 0, 0}, rb{0, 0, 0, 0};
      if (!safe) {
        walk<ANY>(smem, st, rem, sl, sm, so, cnt, lane, ra, rb);
      } else if ((long long)rem - (long long)cnt * max_step >= 32LL * st.base &&
                 (rem >> 5) + 1 < st.top) {
        walk<IN_WINDOW>(smem, st, rem, sl, sm, so, cnt, lane, ra, rb);
      } else {
        walk<SAFE>(smem, st, rem, sl, sm, so, cnt, lane, ra, rb);
      }

      // Lane L decodes sequences 2L and 2L + 1 of the batch from their
      // records; an inclusive scan of the pairs' composed history maps
      // gives each lane the history after its pair, and the lane before
      // gives the history before it.
      const int ia = i0 + 2 * lane;
      const bool live_a = 2 * lane < cnt, live_b = 2 * lane + 1 < cnt;
      const Seq qa = decode_seq(smem, st, ra, live_a, ia);
      const Seq qb = decode_seq(smem, st, rb, live_b, ia + 1);
      HMap m = compose(qa.map, qb.map);
#pragma unroll
      for (int d = 1; d < WARP; d <<= 1) {
        const HMap p = shfl_up(m, d);
        if (lane >= d) m = compose(p, m);
      }
      const uint32_t g1 = apply_slot(m, 0, h1, h2, h3), g2 = apply_slot(m, 1, h1, h2, h3),
                     g3 = apply_slot(m, 2, h1, h2, h3);
      uint32_t f1 = __shfl_up_sync(FULL, g1, 1), f2 = __shfl_up_sync(FULL, g2, 1),
               f3 = __shfl_up_sync(FULL, g3, 1);
      if (lane == 0) {
        f1 = h1;
        f2 = h2;
        f3 = h3;
      }
      const int off_a = qa.uses ? (int)apply_slot(qa.map, 0, f1, f2, f3) : 0;
      const int off_b = qb.uses ? (int)g1 : 0;
      h1 = __shfl_sync(FULL, g1, WARP - 1);
      h2 = __shfl_sync(FULL, g2, WARP - 1);
      h3 = __shfl_sync(FULL, g3, WARP - 1);
      rep |= __any_sync(FULL, qa.flag || qb.flag);
      const long long at = row + ia;
      if (pairs && live_b) {
        *reinterpret_cast<int2*>(a.lls + at) = make_int2(qa.ll, qb.ll);
        *reinterpret_cast<int2*>(a.mls + at) = make_int2(qa.ml, qb.ml);
        *reinterpret_cast<int2*>(a.offs + at) = make_int2(off_a, off_b);
        *reinterpret_cast<int2*>(a.ofvs + at) = make_int2(qa.ofv, qb.ofv);
      } else {
        if (live_a) {
          a.lls[at] = qa.ll;
          a.mls[at] = qa.ml;
          a.offs[at] = off_a;
          a.ofvs[at] = qa.ofv;
        }
        if (live_b) {
          a.lls[at + 1] = qb.ll;
          a.mls[at + 1] = qb.ml;
          a.offs[at + 1] = off_b;
          a.ofvs[at + 1] = qb.ofv;
        }
      }
    }
  }
  if (lane == 0) {
    a.reps[(long long)b * 3 + 0] = (int)h1;
    a.reps[(long long)b * 3 + 1] = (int)h2;
    a.reps[(long long)b * 3 + 2] = (int)h3;
    a.hasrep[b] = rep;
  }
}

}  // namespace

extern "C" int zk_fse_seq_decode_launch(const void* words, int WB, const void* start_bits,
                                        const void* nseq, const void* tidx, const void* tables,
                                        int ntables, const void* logs, const void* consts,
                                        int B, int SB, int stage_words, void* lls, void* mls,
                                        void* offs, void* ofvs, void* reps, void* hasrep,
                                        void* stream) {
  const bool vec = WB % 4 == 0 && stage_words % 4 == 0 && (uintptr_t)words % 16 == 0;
  const FseArgs a{(const uint32_t*)words, WB, (const int*)start_bits, (const int*)nseq,
                  (const int*)tidx, (const int*)tables, ntables, (const int*)logs,
                  (const int*)consts, B, SB, stage_words, vec, (int*)lls, (int*)mls,
                  (int*)offs, (int*)ofvs, (int*)reps, (int*)hasrep};
  if (B > 0) {
    const int shared = TABLE_BYTES + max(stage_words, 2) * 4;
    if (shared > (48 << 10)) {
      cudaFuncSetAttribute(fse_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           shared);
    }
    fse_decode_kernel<<<B, WARP, shared, (cudaStream_t)stream>>>(a);
  }
  return zk_last_error();
}
