// Level-1 LZ77 match finder for Hopper.
//
// Replaces the TPU kernel zeekstd_tpu/ops/match_kernel.py (_build /
// get_match_kernel, the pallas_call at match_kernel.py:512): one record per
// (frame, block), frame-major, each emitting (ll << 16 | ml) and
// repeat-coded offset rows, the block's literal bytes and a 512-slot stat
// row (counters + ll/ml/of/literal histograms). The plain version is
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

// First mismatch at or after k between frame positions a + . (staged) and
// b + ., capped at maxl (k < maxl): 32 lanes compare 128 bytes a round.
__device__ int extend_warp(const Frame& fr, int a, int b, int k, int maxl, int lane) {
  while (k < maxl) {
    const uint32_t x = fr.srd32(a - fr.bs + k + 4 * lane) ^ fr.rd32(b + k + 4 * lane);
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

struct CrossBlock {
  int anchor, r1, r2, r3;
};

// One record, by one warp; every lane returns the same state. Writes the
// lm/ofv rows and the literal bytes; lane 0 stores the counters in `cnt`:
// nseq, mlsum, litcnt, extrep, trash. The table holds (tagged position,
// word) pairs.
__device__ void parse_record(const Frame& fr, uint2* tab, int fbase, const int* m,
                             CrossBlock& st, int SBd, int* lm_row, int* ofv_row,
                             uint8_t* lit_row, int* cnt, int lane) {
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
  while (p < limit) {
    const int abs_p = bs + p;
    // Hash words of p and p + 1 from three staged words; both table reads.
    const uint32_t* sw = fr.s + (p >> 2);
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
    const uint32_t x = fr.srd32(p + (grp >> 1) + gw) ^ fr.rd32(gsrc + gw);
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
      if (fA == 31 && capA > 31) mlA = extend_warp(fr, abs_p, srcA, 31, capA, lane);
      lazy = !repA && mlA < LAZY_ML_MAX && lazy_ok;
      if (lazy && anyB && fB == 31 && capB > 31)
        mlB = extend_warp(fr, abs_p + 1, srcB, 31, capB, lane);
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
    // below, then 32 bytes a round.
    const int lstart = max(anchor, bs);
    const int max_back = hit ? min(m_pos - lstart, src - lo_win) : 0;
    const int gsel = takeB ? (repB ? 16 : 24) : (repA ? 0 : 8);
    if (max_back > 0 && !((below >> gsel) & 1u)) {
      int back = 1;
      while (back < max_back) {
        const int j = back + lane;
        const bool stop =
            j >= max_back || fr.srd8(m_pos - bs - j - 1) != fr.rd8(src - j - 1);
        const unsigned sm = __ballot_sync(FULL, stop);
        if (sm) {
          back += __ffs((int)sm) - 1;
          break;
        }
        back += 32;
      }
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
      for (int k = lane; k < ll_w; k += 32) lit_row[litdst + k] = (uint8_t)fr.srd8(lstart - bs + k);
      trash += -ll_w & 3;
      if (lane == 0) {
        lm_row[nseq] = (ll_w << 16) | ml;
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
    const int oq = ins ? q - bs : 0;
    const uint32_t qw = fr.srd32(oq);
    const uint32_t key = slot(qw, fr.srd32(oq + 4));
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
  for (int k = lane; k < trail; k += 32) lit_row[litdst + k] = (uint8_t)fr.srd8(lstart - bs + k);
  trash += -trail & 3;
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

// Stage bytes [4 * wstart, 4 * wstart + nbytes) of the words array into
// dst with 16-byte cp.async copies (zero-filled outside the array); every
// thread of the block issues its share and commits one group.
__device__ void stage_block(uint32_t* dst, const uint32_t* words, long long nw,
                            long long wstart, int nbytes, int tid) {
  for (int c = tid; c < nbytes / 16; c += THREADS) {
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

__global__ void __launch_bounds__(THREADS)
match_kernel(const int* __restrict__ consts, const int* __restrict__ meta,
             const uint32_t* __restrict__ words, long long nw, int nrecp,
             int BLK, int SBd, int* __restrict__ lm, int* __restrict__ ofv,
             int* __restrict__ litw, int* __restrict__ stat) {
  extern __shared__ __align__(16) uint32_t dyn[];
  __shared__ int sstat[512];
  __shared__ int cnt[5];
  const int f = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  uint2* tab = (uint2*)dyn;
  const int stage_bytes = HEAD + BLK + TAIL;
  const int buf_words = stage_bytes / 4 + 4;
  uint32_t* const buf0 = dyn + 2 * HSIZE;
  CrossBlock st{0, 1, 4, 8};
  bool fresh = true;
  int r = next_record(meta, nrecp, f, -1, lane);
  if (r < nrecp) {
    stage_block(buf0, words, nw,
                (long long)meta[(long long)r * META_COLS + M_WOFF] * 1024 - HEAD / 4,
                stage_bytes, tid);
  }
  commit_group();
  int cur = 0;
  while (r < nrecp) {
    const int* m = meta + (long long)r * META_COLS;
    // Stage the frame's next block while this one parses.
    const int rn = next_record(meta, nrecp, f, r, lane);
    if (rn < nrecp) {
      stage_block(buf0 + (cur ^ 1) * buf_words, words, nw,
                  (long long)meta[(long long)rn * META_COLS + M_WOFF] * 1024 - HEAD / 4,
                  stage_bytes, tid);
    }
    commit_group();
    if ((m[M_FLAGS] & F_FRAME_START) || fresh) {
      for (int h = tid; h < HSIZE; h += THREADS) tab[h] = make_uint2((unsigned)-(1 << 30), 0u);
      st = {0, 1, 4, 8};
      fresh = false;
    }
    for (int i = tid; i < 512; i += THREADS) sstat[i] = 0;
    wait_prior_group();
    __syncthreads();
    int* lm_row = lm + (long long)r * SBd;
    int* ofv_row = ofv + (long long)r * SBd;
    uint8_t* lit_row = (uint8_t*)(litw + (long long)r * (BLK / 4));
    if (tid < 32) {
      // The frame's first word in the words array (frames start on 4 KiB).
      const long long fw = (long long)m[M_WOFF] * 1024 - m[M_BS] / 4;
      const Frame fr{words + fw, (int)max(-fw, (long long)INT_MIN),
                     (int)min(nw - fw, (long long)INT_MAX),
                     buf0 + cur * buf_words + HEAD / 4, m[M_BS], BLK + TAIL};
      parse_record(fr, tab, m[M_FBASE], m, st, SBd, lm_row, ofv_row, lit_row, cnt, lane);
    }
    __syncthreads();
    // Code histograms from the emitted rows (formulas of the FSE kernel)
    // and the literal histogram from the emitted bytes.
    const int nseq = cnt[0], litcnt = cnt[2];
    for (int j = tid; j < nseq; j += THREADS) {
      const int lmv = lm_row[j];
      const int ll = (int)((unsigned)lmv >> 16), ml = lmv & 0xFFFF;
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

}  // namespace

// Dynamic shared memory of one block: the hash table and two staging
// buffers of HEAD + BLK + TAIL bytes (+ 16).
static int match_smem_bytes(int BLK) {
  return HSIZE * (int)sizeof(uint2) + 2 * ((HEAD + BLK + TAIL) + 16);
}

extern "C" int zk_match_launch(const void* consts, const void* meta,
                               const void* words, long long nw, int nrecp,
                               int nframes, int BLK, int SBd, void* lm,
                               void* ofv, void* litw, void* stat, void* stream) {
  if (BLK <= 0 || BLK % 4096 != 0) return (int)cudaErrorInvalidValue;
  const int smem = match_smem_bytes(BLK);
  cudaError_t e = cudaFuncSetAttribute(
      match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  if (nframes > 0) {
    match_kernel<<<nframes, THREADS, smem, (cudaStream_t)stream>>>(
        (const int*)consts, (const int*)meta, (const uint32_t*)words, nw,
        nrecp, BLK, SBd, (int*)lm, (int*)ofv, (int*)litw, (int*)stat);
  }
  return zk_last_error();
}

extern "C" const char* zk_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
