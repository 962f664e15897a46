// Fused FSE decode + sequence execution for Hopper, behind
// zk_ring_decode_launch, which keeps the ring contract of
// zeekstd_tpu/ops/ring_kernel.py (_build / get_ring_kernel, the pallas_call
// at ring_kernel.py:541): literal pools as LE words in, LE words out;
// windows <= 512 KiB. (The wide contract has its own staged decoder,
// wide_decode.cu.)
//
// decode_frame below walks the records of a frame in order: FSE decode with
// three states, repeat offsets threaded across blocks, execution of literal,
// match (any offset, overlapping included), RLE and raw records. The
// reference's rules: a literal run may not exceed its block's literal
// budget, an offset over 512 KiB marks the frame bad, and each sequence's
// bits are read from the four words below the stream position at its start.
// The plain version is ops/decode_kernel.py::decode_plain (ring=True).
//
// What bounds it on this card: the walk over a frame's sequences is serial
// (each FSE state and repeat offset depends on the previous sequence), and
// each copy reads bytes the frame wrote just before, so a frame is bound by
// the latency of that chain; frames decode side by side.
//
// What the design does about it: one warp per frame. All 32 lanes decode
// the FSE stream redundantly (uniform control flow, no broadcasts) from the
// block's bitstream words and its three decode-table rows staged in shared
// memory; the lanes then split every copy. The output goes straight into
// the frame's row in global memory (no ring: the TPU ring existed because
// its scalar memory held 512 KiB). A match copy of length L at offset o
// reads byte k from src + (k mod o), which always lies before the copy's
// destination, so the lanes copy in parallel even when o < L; __syncwarp
// orders each copy after the bytes it reads.

#include "copy.cuh"

namespace {

constexpr int META_COLS = 16;
constexpr int M_FRAME = 0, M_KIND = 1, M_WROW = 2, M_NSEQ = 3, M_LITN = 4,
              M_FLAGS = 5, M_RLEBYTE = 6, M_TLL = 7, M_TOF = 8, M_TML = 9,
              M_LOGS = 10, M_STARTBIT = 11;
constexpr int KIND_SEQ = 0, KIND_LIT = 1, KIND_RLE = 2, KIND_NOP = 3;
constexpr int F_FRAME_START = 1, F_FRAME_END = 2;
constexpr int RING = 1 << 19;
constexpr int STAGE_WORDS = 16384;  // bitstream words staged per block (64 KiB)

struct DecArgs {
  const int* consts;  // (4, 64): LL_BASE, LL_BITS, ML_BASE, ML_BITS
  const int* meta;
  int nrecp;
  const uint32_t* words;  // (nw, WB)
  int nw, WB;
  const int* tables;  // (Tp, 512): symbol | nb_bits << 8 | baseline << 16
  int ntables;
  int OUTB;
  int* meta_out;  // (F, 128)
};

// The literal source: packed LE words. Reads outside the pool return 0.
struct RingLits {
  const uint8_t* p;
  long long n;
  __device__ __forceinline__ uint8_t operator()(long long i) const {
    return (i >= 0 && i < n) ? p[i] : 0;
  }
};

__device__ void decode_frame(const DecArgs& a, int f, uint8_t* out,
                             const RingLits& lit, uint32_t* sw, int* stab) {
  const int lane = threadIdx.x;
  const int* c = a.consts;
  int pos = 0, r1 = 1, r2 = 4, r3 = 8, bad = 0, litcur = 0;
  for (int r = 0; r < a.nrecp; ++r) {
    const int* m = a.meta + (long long)r * META_COLS;
    const int kind = m[M_KIND];
    if (kind == KIND_NOP || m[M_FRAME] != f) continue;
    const int flags = m[M_FLAGS];
    if (flags & F_FRAME_START) {
      pos = 0; r1 = 1; r2 = 4; r3 = 8; bad = 0; litcur = 0;
    }
    const int litn = m[M_LITN];
    const int litcur0 = litcur;
    const int lit_lim = litcur0 + litn;
    if (kind == KIND_SEQ) {
      const uint32_t* grow = a.words + (long long)zk_clamp_row(m[M_WROW], a.nw) * a.WB;
      const int startbit = m[M_STARTBIT];
      const int nstage = min(min(a.WB, STAGE_WORDS),
                             (int)((unsigned)max(startbit, 0) >> 5) + 2);
      const int trow[3] = {m[M_TLL], m[M_TOF], m[M_TML]};
      __syncwarp();
      for (int i = lane; i < nstage; i += LANES) sw[i] = grow[i];
      for (int k = 0; k < 3; ++k) {
        const int* src = a.tables + (long long)zk_clamp_row(trow[k], a.ntables) * 512;
        for (int i = lane; i < 512; i += LANES) stab[k * 512 + i] = src[i];
      }
      __syncwarp();
      auto W = [&](int i) -> uint32_t { return i < nstage ? sw[i] : grow[i]; };
      // n bits ending at bit `rem` of the backward stream (n in [0, 31]).
      auto read_bits = [&](int rem, int n) -> uint32_t {
        if (n <= 0) return 0u;
        const int lo = rem - n;
        const int w = min(max(lo >> 5, 0), a.WB - 2);
        const int sh = lo & 31;
        const uint32_t hi = sh == 0 ? 0u : W(w + 1) << (32 - sh);
        return ((W(w) >> sh) | hi) & zk_low_mask(n);
      };
      const int logs = m[M_LOGS];
      const int ll_log = logs & 31, of_log = (logs >> 5) & 31, ml_log = (logs >> 10) & 31;
      int rem = startbit;
      int ll_s = (int)read_bits(rem, ll_log);
      rem -= ll_log;
      int of_s = (int)read_bits(rem, of_log);
      rem -= of_log;
      int ml_s = (int)read_bits(rem, ml_log);
      rem -= ml_log;
      const int nseq = m[M_NSEQ];
      for (int j = 0; j < nseq; ++j) {
        const int of_e = stab[512 + (of_s & 511)];
        const int ml_e = stab[1024 + (ml_s & 511)];
        const int ll_e = stab[ll_s & 511];
        // Every field of a sequence comes from the four words below `rem`
        // at the sequence start.
        const int bw = min(max((int)((unsigned)rem >> 5) - 3, 0), a.WB - 4);
        const uint32_t w0 = W(bw), w1 = W(bw + 1), w2 = W(bw + 2), w3 = W(bw + 3);
        const int wbase = bw * 32;
        auto rd = [&](int rm, int n) -> uint32_t {
          if (n <= 0) return 0u;
          const int lo = max(rm - n - wbase, 0);
          const int ws = lo >> 5, sh = lo & 31;
          const uint32_t x = ws == 0 ? w0 : ws == 1 ? w1 : ws == 2 ? w2 : w3;
          const uint32_t y = ws == 0 ? w1 : ws == 1 ? w2 : ws == 2 ? w3 : 0u;
          const uint32_t v = sh == 0 ? x : (x >> sh) | (y << (32 - sh));
          return v & zk_low_mask(n);
        };
        const int of_code = of_e & 0xFF;
        const int ofv = (int)((1u << min(of_code, 31)) + rd(rem, of_code));
        rem -= of_code;
        const int ml_code = ml_e & 0xFF & 63;
        const int mlb = c[192 + ml_code];
        const int ml = c[128 + ml_code] + (int)rd(rem, mlb);
        rem -= mlb;
        const int ll_code = ll_e & 0xFF & 63;
        const int llb = c[64 + ll_code];
        const int ll = c[ll_code] + (int)rd(rem, llb);
        rem -= llb;
        // Repeat-offset resolution (RFC 8878 3.1.1.3.2.1.1).
        const int ridx = ofv > 3 ? 0 : ofv + (ll == 0 ? 1 : 0);
        const int off = ofv > 3 ? ofv - 3
                        : ridx == 1 ? r1 : ridx == 2 ? r2 : ridx == 3 ? r3 : r1 - 1;
        const bool moved = ofv > 3 || ridx != 1;
        const int nr3 = ridx == 2 ? r3 : (moved ? r2 : r3);
        const int nr2 = moved ? r1 : r2;
        const int nr1 = moved ? off : r1;
        r1 = nr1; r2 = nr2; r3 = nr3;
        // FSE state updates (skipped after the block's last sequence).
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
        // Hostile-input clamps, as in the reference kernels.
        const int ll_w = min(min(ll, a.OUTB - pos), max(lit_lim - litcur, 0));
        bad |= ll_w != ll;
        copy_lits(out, pos, lit, litcur, ll_w);
        const int mpos = pos + ll_w;
        const int ml_w = min(ml, a.OUTB - mpos);
        bad |= ((ml > 0 && (off <= 0 || off > mpos || off > RING)) || ml_w != ml);
        const int safe_off = min(max(off, 1), max(min(mpos, RING), 1));
        __syncwarp();
        copy_match(out, mpos, safe_off, ml_w);
        __syncwarp();
        pos = mpos + ml_w;
        litcur += ll_w;
      }
      // The stream must land on exactly zero remaining bits.
      bad |= rem != 0;
      const int trail = litn - (litcur - litcur0);
      bad |= trail < 0;
      const int trail_c = min(max(trail, 0), a.OUTB - pos);
      bad |= trail_c != max(trail, 0);
      copy_lits(out, pos, lit, litcur, trail_c);
      __syncwarp();
      pos += trail_c;
      litcur += trail_c;
    } else if (kind == KIND_LIT) {
      const int litn_w = min(litn, a.OUTB - pos);
      bad |= litn_w != litn;
      copy_lits(out, pos, lit, litcur0, litn_w);
      __syncwarp();
      pos += litn_w;
      litcur = litcur0 + litn_w;
    } else if (kind == KIND_RLE) {
      const int litn_w = min(litn, a.OUTB - pos);
      bad |= litn_w != litn;
      const uint8_t byte = (uint8_t)m[M_RLEBYTE];
      for (int k = lane; k < litn_w; k += LANES) out[pos + k] = byte;
      __syncwarp();
      pos += litn_w;
    }
    if ((flags & F_FRAME_END) && lane == 0) {
      int* mo = a.meta_out + (long long)f * 128;
      mo[0] = pos;
      mo[1] = bad;
      mo[2] = litcur;
    }
  }
}

__global__ void __launch_bounds__(LANES)
ring_decode_kernel(DecArgs a, const uint8_t* __restrict__ lit_bytes, int LW,
                   uint32_t* __restrict__ out) {
  extern __shared__ uint32_t sw[];
  __shared__ int stab[3 * 512];
  const int f = blockIdx.x;
  const RingLits lit{lit_bytes + (long long)f * LW * 4, (long long)LW * 4};
  decode_frame(a, f, (uint8_t*)(out + (long long)f * (a.OUTB / 4)), lit, sw, stab);
}

template <typename K>
int set_smem(K kernel) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   STAGE_WORDS * (int)sizeof(uint32_t));
}

}  // namespace

extern "C" int zk_ring_decode_launch(const void* consts, const void* meta,
                                     int nrecp, const void* words, int nw,
                                     int WB, const void* tables, int ntables,
                                     const void* lit_words, int F, int LW,
                                     int OUTB, void* out, void* meta_out,
                                     void* stream) {
  const DecArgs a{(const int*)consts, (const int*)meta, nrecp,
                  (const uint32_t*)words, nw, WB, (const int*)tables, ntables,
                  OUTB, (int*)meta_out};
  if (int e = set_smem(ring_decode_kernel)) return e;
  if (F > 0) {
    ring_decode_kernel<<<F, LANES, STAGE_WORDS * sizeof(uint32_t), (cudaStream_t)stream>>>(
        a, (const uint8_t*)lit_words, LW, (uint32_t*)out);
  }
  return zk_last_error();
}
