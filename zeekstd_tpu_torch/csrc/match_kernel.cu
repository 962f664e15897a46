// Level-1 LZ77 match finder for Hopper.
//
// Replaces the TPU kernel zeekstd_tpu/ops/match_kernel.py (_build /
// get_match_kernel, the pallas_call at match_kernel.py:512): one record per
// (frame, block), frame-major, each emitting (ll << 16 | ml) and
// repeat-coded offset rows, the block's literal bytes and a 512-slot stat
// row (counters + ll/ml/of/literal histograms). Blocks above 32 KiB (the
// WIDE instance, chosen by the caller passing `ml`; ZEEKSTD_TPU_BLOCK up
// to 128 KiB) write ll and ml in rows of their own, since either may pass
// 16 bits there. The plain version is
// ops/match_kernel.py::match_plain; the rows equal it exactly.
//
// What bounds it on this card: the parse is serial within a frame (every
// position's probe depends on the hash table and repeat history the
// previous one left), so it is bound by the latency of each sequence's
// step, not by bytes or operations; the card's other SMs only help through
// frame-level parallelism. With one warp on its SM, that latency is the
// step's instructions one after another plus its memory round trips.
//
// What the design does about it: one thread block per FRAME, frames in
// parallel, each frame's records in the reference's order. One warp carries
// the parse: the state (anchor, repeat offsets, position, counters) is
// warp-uniform and the control flow is the serial code's, while the lanes
// take the data-parallel parts of each step:
//   - both probes at once: the hash words of p and p + 1, both table reads,
//     then one round of 32 lanes that compares, 8 lanes each, the byte
//     below and 31 bytes of p's rep1 and hash candidates and of p + 1's
//     (the byte below starts the backward extension, the first 4 bytes
//     are the rep1 check, the rest the forward extension); the first
//     mismatch of each comes back by __ballot_sync and one __shfl_sync.
//     The lazy probe sees the table as the serial order leaves it: when
//     its slot is p's, its candidate is p itself. The decisions are
//     straight-line code, with one rare branch for a match past the round;
//   - such a match extends 128 bytes a round, one word a lane; a backward
//     extension past the round's byte compares 32 bytes a round;
//   - the lanes copy each literal run between them;
//   - the step's inserts: p's (lane 0), p + 1's when the serial code probes
//     it (lane 1: a hit that is not rep1, with ml < 32), then the strided
//     interior positions, one a lane (lanes 2-9), after a __syncwarp so
//     they land last; interior positions that share a slot are rare, and
//     the lanes that lost rewrite until the highest position stays, as the
//     serial loop leaves it.
// The bytes the parse reads at its own position (hash words, insert words,
// literals, the position side of every comparison) come from the current
// block, staged in shared memory with cp.async while the previous block
// parses (double-buffered). Candidate and repeat sources read the staged
// block when they fall inside it, and global memory through the read-only
// path otherwise (the input fits in L2). Reads past the words array
// return zero, in both views.
//
// Shared memory per block (BLK = 32 KiB): the 2^14 x (tagged position,
// word) hash table, 128 KiB; two staging buffers of 16 + BLK + 192 (+ 16)
// bytes, 64.4 KiB; the stat row and counters, 2 KiB: about 195 KiB of the
// 227 KiB a block may use. A per-frame table gives the TPU's results because a hit
// is only accepted when its tag is at least frame_base + window_low, which
// no earlier frame's entry can be. The whole block clears the table at each
// frame start, stages blocks and builds the code and literal histograms
// from the emitted rows.
//
// A block above 32 KiB does not fit twice beside the table (two buffers
// of a 128 KiB block would take 384 KiB), and the table is semantic: its
// 2^14 slots and what they hold decide the parse. So the WIDE instance
// stages the block in windows of STAGE_W = 32 KiB (+ HEAD + TAIL) in the
// same two buffers, the parsing warp prefetching window k + 1 with
// cp.async while it parses window k, and switching when the position
// crosses into the next window (a match that jumps past it stages the
// window it lands in). Its hot path (hash words, the probe round's
// position side) stays in the window; the reads that can reach behind the
// window or past it (literal copies, the backward extension, inserts
// after a backward extension, a long forward extension) check the window
// and go through the read-only global path outside it. Shared memory is
// then what it is at 32 KiB, for every block size.

#include <algorithm>
#include <climits>

#include "common.cuh"

namespace {

constexpr int META_COLS = 8;
constexpr int M_FRAME = 0, M_BS = 1, M_BLEN = 2, M_FLAGS = 3, M_WOFF = 4,
              M_FBASE = 6;
constexpr int F_FRAME_START = 1;
constexpr int ST_NSEQ = 0, ST_MLSUM = 1, ST_LITCNT = 2, ST_EXTREP = 3,
              ST_OVERFLOW = 4, ST_LLHIST = 5, ST_MLHIST = 41, ST_OFHIST = 94,
              ST_LITHIST = 128, ST_TRASH = 508;
constexpr int HB = 14, HSIZE = 1 << HB, WIN_LOG = 19, INS_CAP = 16,
              LAZY_ML_MAX = 32;
constexpr int THREADS = 256;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr uint32_t M1 = 2654435761u, M2 = 0x85EBCA77u;
// Staged bytes before a block (the probe round reads the byte below p) and
// past its end (a comparison at position a < bend reads at most 127 + 4
// bytes past it); 16 more bytes of buffer keep an unaligned read at the
// last offset inside it.
constexpr int HEAD = 16, TAIL = 192;
// The WIDE instance's window, and the largest block of the packed one.
constexpr int STAGE_W = 32 << 10;

__device__ __forceinline__ uint32_t slot(uint32_t w, uint32_t w2) {
  return ((w * M1) ^ ((w2 & 0xFFFFu) * M2)) >> (32 - HB);
}

// The bytes of one frame: frame word j is word j of wf, inside the words
// array for j in [jlo, jhi) and zero elsewhere; positions
// [bs - HEAD, bs + slen) are also staged in shared memory at offset q - bs.
struct Frame {
  const uint32_t* wf;
  int jlo, jhi;
  const uint32_t* s;
  int bs, slen;

  // Staged reads by offset (the parse's own position side).
  __device__ __forceinline__ uint32_t srd32(int o) const {
    return __funnelshift_r(s[o >> 2], s[(o >> 2) + 1], (o & 3) * 8);
  }
  __device__ __forceinline__ uint32_t srd8(int o) const {
    return (s[o >> 2] >> ((o & 3) * 8)) & 0xFFu;
  }
  // Reads at any frame position (candidate and repeat sources): staged
  // when inside the block, else global.
  __device__ __forceinline__ uint32_t rd32(int q) const {
    const int o = q - bs;
    const bool in = (unsigned)(o + HEAD) <= (unsigned)(slen - 4 + HEAD);
    const int oc = in ? o : 0, j = q >> 2;
    const uint32_t a = in ? s[oc >> 2] : (j >= jlo && j < jhi ? __ldg(wf + j) : 0u);
    const uint32_t b = in ? s[(oc >> 2) + 1] : (j + 1 >= jlo && j + 1 < jhi ? __ldg(wf + j + 1) : 0u);
    return __funnelshift_r(a, b, (q & 3) * 8);
  }
  __device__ __forceinline__ uint32_t rd8(int q) const {
    const int o = q - bs;
    if ((unsigned)(o + HEAD) < (unsigned)(slen + HEAD)) return srd8(o);
    const int j = q >> 2;
    return j >= jlo && j < jhi ? (__ldg(wf + j) >> ((q & 3) * 8)) & 0xFFu : 0u;
  }
};

// First mismatch at or after k between frame positions a + . (the parse's
// side: staged in the packed instance, checked against a WIDE window) and
// b + ., capped at maxl (k < maxl): 32 lanes compare 128 bytes a round.
template <bool WIDE>
__device__ int extend_warp(const Frame& fr, int a, int b, int k, int maxl, int lane) {
  while (k < maxl) {
    const int qa = a + k + 4 * lane;
    const uint32_t x = (WIDE ? fr.rd32(qa) : fr.srd32(qa - fr.bs)) ^ fr.rd32(b + k + 4 * lane);
    const unsigned mm = __ballot_sync(FULL, x != 0);
    if (mm) {
      const int l = __ffs((int)mm) - 1;
      const int bi = x ? (__ffs((int)x) - 1) >> 3 : 0;
      k += 4 * l + __shfl_sync(FULL, bi, l);
      break;
    }
    k += 128;
  }
  return k < maxl ? k : maxl;
}

// Stage bytes [4 * wstart, 4 * wstart + nbytes) of the words array into
// dst with 16-byte cp.async copies (zero-filled outside the array); thread
// t of nt issues its share (the whole block, or the parsing warp).
__device__ void stage_block(uint32_t* dst, const uint32_t* words, long long nw,
                            long long wstart, int nbytes, int t, int nt) {
  for (int c = t; c < nbytes / 16; c += nt) {
    const long long j = wstart + 4LL * c;
    const long long avail = nw - j;
    const int bytes = j < 0 ? 0 : avail >= 4 ? 16 : avail > 0 ? (int)avail * 4 : 0;
    const uint32_t* src = bytes ? words + j : words;
    const unsigned saddr = (unsigned)__cvta_generic_to_shared(dst + 4 * c);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(saddr), "l"(src),
                 "r"(bytes)
                 : "memory");
  }
}

__device__ __forceinline__ void commit_group() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void wait_prior_group() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void wait_all_groups() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The WIDE instance's staging: two buffers of buf_words words, and the
// block's first word in the words array.
struct Windows {
  uint32_t* buf0;
  int buf_words;
  const uint32_t* words;
  long long nw, bw;
  int BLK;

  __device__ __forceinline__ int len(int k) const { return min(STAGE_W, BLK - k * STAGE_W); }
  // The parsing warp stages window k of the block into buffer b.
  __device__ __forceinline__ void stage(int k, int b, int lane) const {
    stage_block(buf0 + b * buf_words, words, nw, bw + (long long)k * (STAGE_W / 4) - HEAD / 4,
                HEAD + len(k) + TAIL, lane, 32);
    commit_group();
  }
  __device__ __forceinline__ void show(Frame& fr, int k, int b, int bs) const {
    fr.s = buf0 + b * buf_words + HEAD / 4;
    fr.bs = bs + k * STAGE_W;
    fr.slen = len(k) + TAIL;
  }
};

// The backward extension's scan past the round's byte below: 32 bytes a
// round from back = 1, the parse's side read staged (STAGED: the whole
// block is staged) or checked against the window.
template <bool STAGED>
__device__ __forceinline__ int back_scan(const Frame& fr, int m_pos, int src, int max_back,
                                         int lane) {
  int back = 1;
  while (back < max_back) {
    const int j = back + lane;
    const bool stop = j >= max_back || (STAGED ? fr.srd8(m_pos - fr.bs - j - 1)
                                               : fr.rd8(m_pos - j - 1)) != fr.rd8(src - j - 1);
    const unsigned sm = __ballot_sync(FULL, stop);
    if (sm) {
      back += __ffs((int)sm) - 1;
      break;
    }
    back += 32;
  }
  return back;
}

struct CrossBlock {
  int anchor, r1, r2, r3;
};

// One record, by one warp; every lane returns the same state. Writes the
// lm/ofv rows (WIDE: ll in lm, and ml_row) and the literal bytes; lane 0
// stores the counters in `cnt`: nseq, mlsum, litcnt, extrep, trash. The
// table holds (tagged position, word) pairs. The packed instance reads its
// block staged whole by the caller (`fr0`); the WIDE one stages its
// windows itself (`win`).
template <bool WIDE>
__device__ void parse_record(const Frame& fr0, const Windows& win, uint2* tab, int fbase,
                             const int* m, CrossBlock& st, int SBd, int* lm_row, int* ml_row,
                             int* ofv_row, uint8_t* lit_row, int* cnt, int lane) {
  const int bs = m[M_BS], blen = m[M_BLEN];
  const int bend = bs + blen;
  const int lo_win = max(bend - (1 << WIN_LOG), 0);
  const int limit = blen - 12;
  const int tag_lo = fbase + lo_win;
  // The lane's part of the probe round: group g = lane / 8 takes p's rep1
  // (0) or hash (1) candidate, or p + 1's (2, 3); lane i = lane % 8
  // compares the 4 bytes from 4 * i - 1 on: the byte below the position
  // (the first of the backward extension), then bytes 0-30.
  const int grp = lane >> 3, gi = lane & 7, gw = 4 * gi - 1;
  int anchor = st.anchor, r1 = st.r1, r2 = st.r2, r3 = st.r3;
  int nseq = 0, mlsum = 0, litdst = 0, repm = 0, ext_rep = 0, trash = 0;
  int p = 0;
  Frame fr = fr0;
  // The staged window: block offset wofs (0 and the whole block in the
  // packed instance), buffer cur; the window prefetched into the other
  // buffer (-1 if none).
  int wofs = 0, cur = 0, pre = -1;
  if constexpr (WIDE) {
    __syncwarp();  // the previous record's reads of both buffers are done
    win.stage(0, 0, lane);
    if (limit > STAGE_W) {
      win.stage(1, 1, lane);
      pre = 1;
      wait_prior_group();
    } else {
      wait_all_groups();
    }
    __syncwarp();
    win.show(fr, 0, 0, bs);
  }
  while (p < limit) {
    if constexpr (WIDE) {
      if (p - wofs >= STAGE_W) {
        // The position crossed into a later window: the prefetched one, or
        // (after a long match) the one it landed in, staged now.
        const int k = p / STAGE_W;
        wait_all_groups();
        __syncwarp();
        if (k != pre) {
          win.stage(k, cur ^ 1, lane);
          wait_all_groups();
          __syncwarp();
        }
        cur ^= 1;
        wofs = k * STAGE_W;
        win.show(fr, k, cur, bs);
        pre = -1;
        if (wofs + STAGE_W < limit) {
          win.stage(k + 1, cur ^ 1, lane);
          pre = k + 1;
        }
      }
    }
    const int abs_p = bs + p;
    // Hash words of p and p + 1 from three staged words; both table reads.
    const uint32_t* sw = fr.s + ((p - wofs) >> 2);
    const unsigned sh = (p & 3) * 8;
    const uint64_t lo = sw[0] | (uint64_t)sw[1] << 32, hi = sw[1] | (uint64_t)sw[2] << 32;
    const uint32_t wA = (uint32_t)(lo >> sh), wB = (uint32_t)(lo >> (sh + 8));
    const uint32_t hA = slot(wA, (uint32_t)(hi >> sh));
    const uint32_t hB = slot(wB, (uint32_t)(hi >> (sh + 8)));
    const uint2 eA = tab[hA];
    uint2 eB = tab[hB];
    if (hB == hA) eB = make_uint2((unsigned)(fbase + abs_p), wA);  // p's insert comes first
    const int rA = abs_p - r1;
    const bool hashA = (int)eA.x >= tag_lo && eA.y == wA;
    const bool hashB = (int)eB.x >= tag_lo && eB.y == wB;
    const int hsA = hashA ? (int)eA.x - fbase : abs_p;
    const int hsB = hashB ? (int)eB.x - fbase : abs_p + 1;
    // One round over the four candidates.
    const int gsrc = grp == 0 ? rA : grp == 1 ? hsA : grp == 2 ? rA + 1 : hsB;
    const uint32_t x = fr.srd32(p - wofs + (grp >> 1) + gw) ^ fr.rd32(gsrc + gw);
    const uint32_t xf = gi == 0 ? x & 0xFFFFFF00u : x;
    const unsigned mm = __ballot_sync(FULL, xf != 0);
    const unsigned below = __ballot_sync(FULL, gi == 0 && (x & 0xFFu));
    const int bi = xf ? gw + ((__ffs((int)xf) - 1) >> 3) : 31;
    // Per group: the first mismatch from byte 0 on (31 when none).
    const unsigned m0 = mm & 0xFFu, m1 = (mm >> 8) & 0xFFu, m2 = (mm >> 16) & 0xFFu,
                   m3 = mm >> 24;
    const int f0 = __shfl_sync(FULL, bi, m0 ? __ffs((int)m0) - 1 : 0);
    const int f1 = __shfl_sync(FULL, bi, m1 ? 7 + __ffs((int)m1) : 8);
    const int f2 = __shfl_sync(FULL, bi, m2 ? 15 + __ffs((int)m2) : 16);
    const int f3 = __shfl_sync(FULL, bi, m3 ? 23 + __ffs((int)m3) : 24);
    // rep1 checks the first 4 bytes; a hash hit has them by its tag word.
    const bool repA = rA >= lo_win && f0 >= 4;
    const bool repB = rA + 1 >= lo_win && f2 >= 4;

    // Probe p: rep1 first (taken unconditionally), then the hash candidate
    // with the cost gate; then the 1-step lazy race (cost-aware) at p + 1,
    // for short non-rep matches only.
    const int srcA = repA ? rA : hsA, srcB = repB ? rA + 1 : hsB;
    const int fA = repA ? f0 : f1, fB = repB ? f2 : f3;
    const int capA = bend - abs_p, capB = capA - 1;
    const int offA = abs_p - srcA, offB = abs_p + 1 - srcB;
    const int hbA = zk_highbit(offA), hbB = zk_highbit(offB);
    const bool anyB = repB || hashB;
    int mlA = min(fA, capA), mlB = min(fB, capB);
    const bool hit = (repA || hashA) && (repA || 6 * mlA >= 14 + hbA + 1);
    const bool lazy_ok = p + 1 < limit;
    bool lazy = hit && !repA && mlA < LAZY_ML_MAX && lazy_ok;
    bool hitB = anyB && (repB || 6 * mlB >= 14 + hbB + 1);
    if (hit && ((fA == 31 && capA > 31) || (anyB && fB == 31 && capB > 31))) {
      // A match past the round's 31 bytes (rare) extends on.
      if (fA == 31 && capA > 31) mlA = extend_warp<WIDE>(fr, abs_p, srcA, 31, capA, lane);
      lazy = !repA && mlA < LAZY_ML_MAX && lazy_ok;
      if (lazy && anyB && fB == 31 && capB > 31)
        mlB = extend_warp<WIDE>(fr, abs_p + 1, srcB, 31, capB, lane);
      hitB = anyB && (repB || 6 * mlB >= 14 + hbB + 1);
    }
    const int sc1 = 4 * mlA - hbA;
    const int sc2 = repB ? 4 * mlB + 2 : 4 * mlB - hbB;
    const bool takeB = lazy && hitB && sc2 > sc1 + 1;
    int m_pos = takeB ? abs_p + 1 : abs_p;
    int src = takeB ? srcB : srcA;
    int ml = takeB ? mlB : mlA;
    const int off = takeB ? offB : offA;
    // Backward extension over the pending literal run: the round's byte
    // below, then 32 bytes a round. The packed instance reads its side of
    // it, and of the literal copy and the inserts below, staged; the WIDE
    // one checks the window at every read (a run can begin before it),
    // which measured faster than a warp-uniform test of the run's start.
    const int lstart = max(anchor, bs);
    const int max_back = hit ? min(m_pos - lstart, src - lo_win) : 0;
    const int gsel = takeB ? (repB ? 16 : 24) : (repA ? 0 : 8);
    if (max_back > 0 && !((below >> gsel) & 1u)) {
      const int back = back_scan<!WIDE>(fr, m_pos, src, max_back, lane);
      m_pos -= back;
      src -= back;
      ml += back;
    }
    const int ll = m_pos - anchor;
    const int ll_w = min(ll, m_pos - bs);
    // At SBd sequences the rows are full: stop emitting (the stat row
    // flags the overflow).
    const bool emit = hit && nseq < SBd;
    const int stop = emit ? min(min(m_pos + ml, bs + limit), m_pos + 1 + INS_CAP) : 0;
    const int q = m_pos - 3 + 2 * lane;  // lanes 2-9: the interior positions
    if (emit) {
      // Repeat-offset value (RFC 8878 3.1.1.3.2.1.1, encoder side).
      const int isz = ll_w == 0 ? 1 : 0;
      const int o1 = isz ? r2 : r1, o2 = isz ? r3 : r2, o3 = isz ? r1 - 1 : r3;
      const int ofv = off == o1 ? 1 : off == o2 ? 2 : off == o3 ? 3 : off + 3;
      const int ridx = ofv + isz;
      const int b1 = repm & 1, b2 = (repm >> 1) & 1, b3 = (repm >> 2) & 1;
      const int rbit = ridx == 2 ? b2 : ridx == 3 ? b3 : b1;
      if (ofv <= 3 && rbit == 0) ext_rep = 1;
      const bool moved = ofv > 3 || ridx != 1;
      const int nr3 = ridx == 2 ? r3 : (moved ? r2 : r3);
      const int nr2 = moved ? r1 : r2;
      // (not moved means off == r1)
      const int nb3 = ridx == 2 ? b3 : (moved ? b2 : b3);
      const int nb2 = moved ? b1 : b2;
      repm = 1 | (nb2 << 1) | (nb3 << 2);
      r1 = off;
      r2 = nr2;
      r3 = nr3;
      if constexpr (WIDE) {
        for (int k = lane; k < ll_w; k += 32) lit_row[litdst + k] = (uint8_t)fr.rd8(lstart + k);
      } else {
        for (int k = lane; k < ll_w; k += 32)
          lit_row[litdst + k] = (uint8_t)fr.srd8(lstart - fr.bs + k);
      }
      trash += -ll_w & 3;
      if (lane == 0) {
        if constexpr (WIDE) {
          lm_row[nseq] = ll_w;
          ml_row[nseq] = ml;
        } else {
          lm_row[nseq] = (ll_w << 16) | ml;
        }
        ofv_row[nseq] = ofv;
      }
      p = m_pos + ml - bs;
      anchor = m_pos + ml;
      ++nseq;
      mlsum += ml;
      litdst += ll_w;
    } else {
      p = p + 1 + (int)((unsigned)ll >> 8);
    }
    // The step's inserts in the serial order: p (lane 0; p + 1 replaces it
    // when they share a slot), p + 1 when the lazy probe ran (lane 1), then
    // the strided interior positions (stride 2, capped reach; lanes 2-9).
    if (lane == 0 && !(lazy && hB == hA)) tab[hA] = make_uint2((unsigned)(fbase + abs_p), wA);
    if (lane == 1 && lazy) tab[hB] = make_uint2((unsigned)(fbase + abs_p + 1), wB);
    const bool ins = lane >= 2 && q < stop;
    // Lanes without an insert read a staged word.
    uint32_t qw, qw4;
    if constexpr (WIDE) {
      const int qq = ins ? q : fr.bs;
      qw = fr.rd32(qq);
      qw4 = fr.rd32(qq + 4);
    } else {
      const int oq = (ins ? q : fr.bs) - fr.bs;
      qw = fr.srd32(oq);
      qw4 = fr.srd32(oq + 4);
    }
    const uint32_t key = slot(qw, qw4);
    __syncwarp();
    if (ins) tab[key] = make_uint2((unsigned)(fbase + q), qw);
    __syncwarp();
    // Interior positions that share a slot: the highest one stays.
    bool lost = ins && (int)tab[key].x < fbase + q;
    while (__any_sync(FULL, lost)) {
      if (lost) tab[key] = make_uint2((unsigned)(fbase + q), qw);
      __syncwarp();
      lost = ins && (int)tab[key].x < fbase + q;
    }
  }
  // Block-trailing literals.
  const int lstart = max(anchor, bs);
  const int trail = max(bend - lstart, 0);
  for (int k = lane; k < trail; k += 32)
    lit_row[litdst + k] = (uint8_t)(WIDE ? fr.rd8(lstart + k) : fr.srd8(lstart - fr.bs + k));
  trash += -trail & 3;
  if constexpr (WIDE) wait_all_groups();  // a prefetch the parse did not reach
  st = {anchor, r1, r2, r3};
  if (lane == 0) {
    cnt[0] = nseq;
    cnt[1] = mlsum;
    cnt[2] = litdst + trail;
    cnt[3] = ext_rep;
    cnt[4] = trash;
  }
}

// The next record of frame f after record r (nrecp if none), found by each
// warp 32 rows at a time; every thread returns the same index.
__device__ int next_record(const int* meta, int nrecp, int f, int r, int lane) {
  for (int b = r + 1; b < nrecp; b += 32) {
    const int j = b + lane;
    const unsigned hit = __ballot_sync(FULL, j < nrecp && meta[(long long)j * META_COLS + M_FRAME] == f);
    if (hit) return b + __ffs((int)hit) - 1;
  }
  return nrecp;
}

template <bool WIDE>
__global__ void __launch_bounds__(THREADS)
match_kernel(const int* __restrict__ consts, const int* __restrict__ meta,
             const uint32_t* __restrict__ words, long long nw, int nrecp,
             int BLK, int SBd, int* __restrict__ lm, int* __restrict__ mlw,
             int* __restrict__ ofv, int* __restrict__ litw, int* __restrict__ stat) {
  extern __shared__ __align__(16) uint32_t dyn[];
  __shared__ int sstat[512];
  __shared__ int cnt[5];
  const int f = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  uint2* tab = (uint2*)dyn;
  // The packed instance stages whole blocks, the WIDE one windows of at
  // most STAGE_W bytes (the packed one takes BLK <= STAGE_W).
  const int stage_bytes = HEAD + min(BLK, STAGE_W) + TAIL;
  const int buf_words = stage_bytes / 4 + 4;
  uint32_t* const buf0 = dyn + 2 * HSIZE;
  CrossBlock st{0, 1, 4, 8};
  bool fresh = true;
  int r = next_record(meta, nrecp, f, -1, lane);
  if constexpr (!WIDE) {
    if (r < nrecp) {
      stage_block(buf0, words, nw,
                  (long long)meta[(long long)r * META_COLS + M_WOFF] * 1024 - HEAD / 4,
                  stage_bytes, tid, THREADS);
    }
    commit_group();
  }
  int cur = 0;
  while (r < nrecp) {
    const int* m = meta + (long long)r * META_COLS;
    // Stage the frame's next block while this one parses.
    const int rn = next_record(meta, nrecp, f, r, lane);
    if constexpr (!WIDE) {
      if (rn < nrecp) {
        stage_block(buf0 + (cur ^ 1) * buf_words, words, nw,
                    (long long)meta[(long long)rn * META_COLS + M_WOFF] * 1024 - HEAD / 4,
                    stage_bytes, tid, THREADS);
      }
      commit_group();
    }
    if ((m[M_FLAGS] & F_FRAME_START) || fresh) {
      for (int h = tid; h < HSIZE; h += THREADS) tab[h] = make_uint2((unsigned)-(1 << 30), 0u);
      st = {0, 1, 4, 8};
      fresh = false;
    }
    for (int i = tid; i < 512; i += THREADS) sstat[i] = 0;
    if constexpr (!WIDE) wait_prior_group();
    __syncthreads();
    int* lm_row = lm + (long long)r * SBd;
    int* ml_row = WIDE ? mlw + (long long)r * SBd : nullptr;
    int* ofv_row = ofv + (long long)r * SBd;
    uint8_t* lit_row = (uint8_t*)(litw + (long long)r * (BLK / 4));
    if (tid < 32) {
      // The block's and the frame's first words in the words array (frames
      // start on 4 KiB).
      const long long bw = (long long)m[M_WOFF] * 1024, fw = bw - m[M_BS] / 4;
      const Frame fr{words + fw, (int)max(-fw, (long long)INT_MIN),
                     (int)min(nw - fw, (long long)INT_MAX),
                     buf0 + cur * buf_words + HEAD / 4, m[M_BS], BLK + TAIL};
      const Windows win{buf0, buf_words, words, nw, bw, BLK};
      parse_record<WIDE>(fr, win, tab, m[M_FBASE], m, st, SBd, lm_row, ml_row, ofv_row,
                         lit_row, cnt, lane);
    }
    __syncthreads();
    // Code histograms from the emitted rows (formulas of the FSE kernel)
    // and the literal histogram from the emitted bytes.
    const int nseq = cnt[0], litcnt = cnt[2];
    for (int j = tid; j < nseq; j += THREADS) {
      int ll, ml;
      if constexpr (WIDE) {
        ll = lm_row[j];
        ml = ml_row[j];
      } else {
        const int lmv = lm_row[j];
        ll = (int)((unsigned)lmv >> 16);
        ml = lmv & 0xFFFF;
      }
      const int llc = ll < 64 ? consts[256 + ll] : 19 + zk_highbit(ll);
      const int mlb = ml - 3;
      const int mlc = mlb < 128 ? consts[320 + max(mlb, 0)] : 36 + zk_highbit(mlb);
      atomicAdd(&sstat[ST_LLHIST + llc], 1);
      atomicAdd(&sstat[ST_MLHIST + mlc], 1);
      atomicAdd(&sstat[ST_OFHIST + zk_highbit(ofv_row[j])], 1);
    }
    for (int i = tid; i < litcnt; i += THREADS) atomicAdd(&sstat[ST_LITHIST + lit_row[i]], 1);
    __syncthreads();
    if (tid == 0) {
      sstat[ST_NSEQ] = nseq;
      sstat[ST_MLSUM] = cnt[1];
      sstat[ST_LITCNT] = litcnt;
      sstat[ST_EXTREP] = cnt[3];
      sstat[ST_OVERFLOW] = nseq >= SBd ? 1 : 0;
      sstat[ST_TRASH] += cnt[4];
    }
    __syncthreads();
    for (int i = tid; i < 512; i += THREADS) stat[(long long)r * 512 + i] = sstat[i];
    r = rn;
    cur ^= 1;
  }
}

// Dynamic shared memory of one block: the hash table and two staging
// buffers of HEAD + min(BLK, STAGE_W) + TAIL bytes (+ 16), as the kernel's
// stage_bytes: 197,056 bytes at 32 KiB and above.
int smem_bytes(int BLK) {
  return HSIZE * (int)sizeof(uint2) + 2 * ((HEAD + std::min(BLK, STAGE_W) + TAIL) + 16);
}

template <bool WIDE>
int launch(const void* consts, const void* meta, const void* words, long long nw, int nrecp,
           int nframes, int BLK, int SBd, void* lm, void* ml, void* ofv, void* litw,
           void* stat, void* stream) {
  const int smem = smem_bytes(BLK);
  cudaError_t e = cudaFuncSetAttribute(
      match_kernel<WIDE>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  if (nframes > 0) {
    match_kernel<WIDE><<<nframes, THREADS, smem, (cudaStream_t)stream>>>(
        (const int*)consts, (const int*)meta, (const uint32_t*)words, nw, nrecp, BLK, SBd,
        (int*)lm, (int*)ml, (int*)ofv, (int*)litw, (int*)stat);
  }
  return zk_last_error();
}

}  // namespace

// `ml` selects the instance, as the caller's rule (ops/match_kernel.py,
// wide_rows) gives it: null, the packed instance, which stages whole
// blocks and so takes BLK up to STAGE_W (32 KiB); else the WIDE instance,
// at any BLK up to the format's 128 KiB, which writes ll into `lm` and ml
// into `ml`.
extern "C" int zk_match_launch(const void* consts, const void* meta,
                               const void* words, long long nw, int nrecp,
                               int nframes, int BLK, int SBd, void* lm, void* ml,
                               void* ofv, void* litw, void* stat, void* stream) {
  if (BLK <= 0 || BLK % 4096 != 0 || BLK > (128 << 10)) return (int)cudaErrorInvalidValue;
  if (ml != nullptr)
    return launch<true>(consts, meta, words, nw, nrecp, nframes, BLK, SBd, lm, ml, ofv, litw,
                        stat, stream);
  if (BLK > STAGE_W) return (int)cudaErrorInvalidValue;
  return launch<false>(consts, meta, words, nw, nrecp, nframes, BLK, SBd, lm, ml, ofv, litw,
                       stat, stream);
}

// The dynamic shared memory zk_match_launch asks for at block size BLK.
extern "C" int zk_match_smem_bytes(int BLK) { return smem_bytes(BLK); }

extern "C" const char* zk_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
