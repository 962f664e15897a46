// Serial sequence executor for Hopper, behind zk_exec_launch.
//
// Replaces zeekstd_tpu/ops/exec_kernel.py (_build / get_exec_kernel, the
// pallas_call at exec_kernel.py:372): executes pre-decoded (ll, ml, raw
// offset value) rows record by record. Records are frame-major: sequence
// slices of a block (at most SBd sequences each, with the block's
// trailing literals after its last slice), literal runs, RLE runs and
// padding. Repeat offsets resolve with libzstd's rules, the history
// threaded across the blocks of a frame; the literal window of a record is
// fixed where the record starts (LITB + 128 bytes from the 128-byte row
// holding its first literal), and every clamp raises the frame's bad flag,
// as in the reference. Per frame, meta_out row f holds (total, bad flag,
// literals consumed) in lanes 0-2. The plain version is
// ops/exec_kernel.py::exec_plain.
//
// What bounds it on this card: latency. Each sequence's repeat offset
// depends on the one before, and each match reads bytes the frame wrote
// just before, so a frame is a serial chain; frames run side by side.
//
// What the design does about it: one warp per frame (the design the ring
// decoder had before it moved onto wide_decode.cu's stages). The warp loads
// 32 sequences at a time with one coalesced load per lane and hands them
// out with shuffles; the 32 lanes then split each literal run and match
// copy (copy.cuh). The output goes straight into the frame's row.

#include "copy.cuh"

namespace {

constexpr int META_COLS = 8;
constexpr int M_FRAME = 0, M_KIND = 1, M_ROW = 2, M_NSEQ = 3, M_LITN = 4, M_FLAGS = 5,
              M_RLEBYTE = 6;
constexpr int KIND_SEQ = 0, KIND_LIT = 1, KIND_RLE = 2, KIND_NOP = 3;
constexpr int F_FRAME_START = 1, F_FRAME_END = 2, F_BLOCK_START = 4, F_BLOCK_END = 8;
constexpr unsigned FULL = 0xFFFFFFFFu;

struct ExecArgs {
  const int* meta;  // (nrecp, META_COLS)
  int nrecp;
  const int* lls;  // (nrows, SBd) each
  const int* mls;
  const int* ofvs;
  int nrows, SBd;
  const int* lits;  // (F, LROWS * 128), one int32 per byte
  int LROWS, LITB, OUTB;
  uint8_t* out;   // (F, OUTB)
  int* meta_out;  // (F, 128)
};

__global__ void __launch_bounds__(LANES) exec_kernel(ExecArgs a) {
  const int f = blockIdx.x;
  const int lane = threadIdx.x;
  uint8_t* out = a.out + (long long)f * a.OUTB;
  const long long lrow = (long long)a.LROWS * 128;
  const WideLits lit{a.lits + f * lrow, lrow};
  const int lrws = a.LITB / 128 + 1;
  int pos = 0, r1 = 1, r2 = 4, r3 = 8, bad = 0, litcur = 0, blit = 0;
  for (int r = 0; r < a.nrecp; ++r) {
    const int* m = a.meta + (long long)r * META_COLS;
    const int kind = m[M_KIND];
    if (kind == KIND_NOP || m[M_FRAME] != f) continue;
    const int flags = m[M_FLAGS];
    if (flags & F_FRAME_START) {
      pos = 0; r1 = 1; r2 = 4; r3 = 8; bad = 0; litcur = 0; blit = 0;
    }
    if (flags & F_BLOCK_START) blit = litcur;
    const int litn = m[M_LITN];
    const int litcur0 = litcur;
    const int lit_lim = min(litcur0 / 128, a.LROWS - lrws) * 128 + a.LITB + 128;
    if (kind == KIND_SEQ) {
      const long long row = min(max(m[M_ROW], 0), a.nrows - 1);
      const int* rl = a.lls + row * a.SBd;
      const int* rm = a.mls + row * a.SBd;
      const int* ro = a.ofvs + row * a.SBd;
      const int nseq = min(max(m[M_NSEQ], 0), a.SBd);
      for (int j0 = 0; j0 < nseq; j0 += LANES) {
        const int j = j0 + lane;
        const int my_ll = j < nseq ? rl[j] : 0;
        const int my_ml = j < nseq ? rm[j] : 0;
        const int my_ofv = j < nseq ? ro[j] : 0;
        const int cnt = min(LANES, nseq - j0);
        for (int q = 0; q < cnt; ++q) {
          const int ll = __shfl_sync(FULL, my_ll, q);
          const int ml = __shfl_sync(FULL, my_ml, q);
          const int ofv = __shfl_sync(FULL, my_ofv, q);
          // Repeat-offset resolution (RFC 8878 3.1.1.3.2.1.1).
          const int ridx = ofv > 3 ? 0 : ofv + (ll == 0 ? 1 : 0);
          const int off = ofv > 3 ? ofv - 3
                          : ridx == 1 ? r1 : ridx == 2 ? r2 : ridx == 3 ? r3 : r1 - 1;
          const bool moved = ofv > 3 || ridx != 1;
          const int nr3 = ridx == 2 ? r3 : (moved ? r2 : r3);
          const int nr2 = moved ? r1 : r2;
          const int nr1 = moved ? off : r1;
          r1 = nr1; r2 = nr2; r3 = nr3;
          // Hostile-input clamps: never write past OUTB, never read past
          // the record's literal window.
          const int ll_w = min(min(ll, a.OUTB - pos), max(lit_lim - litcur, 0));
          bad |= ll_w != ll;
          if (ll_w > 0) copy_lits(out, pos, lit, litcur, ll_w);
          const int mpos = pos + ll_w;
          const int ml_w = min(ml, a.OUTB - mpos);
          bad |= (ml > 0 && (off <= 0 || off > mpos)) || ml_w != ml;
          const int safe_off = min(max(off, 1), max(mpos, 1));
          __syncwarp();
          if (ml_w > 0) copy_match(out, mpos, safe_off, ml_w);
          __syncwarp();
          pos = mpos + ml_w;
          litcur += ll_w;
        }
      }
      // Trailing literals at block end: what the block's literal budget
      // leaves after every slice of its sequences.
      const int trail = (flags & F_BLOCK_END) ? litn - (litcur - blit) : 0;
      bad |= trail < 0;
      const int trail_c = min(min(max(trail, 0), a.OUTB - pos), max(lit_lim - litcur, 0));
      bad |= trail_c != max(trail, 0);
      if (trail_c > 0) copy_lits(out, pos, lit, litcur, trail_c);
      __syncwarp();
      pos += trail_c;
      litcur += trail_c;
    } else if (kind == KIND_LIT) {
      const int litn_w = min(min(litn, a.OUTB - pos), max(lit_lim - litcur0, 0));
      bad |= litn_w != litn;
      if (litn_w > 0) copy_lits(out, pos, lit, litcur0, litn_w);
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

}  // namespace

extern "C" int zk_exec_launch(const void* meta, int nrecp, const void* lls, const void* mls,
                              const void* ofvs, int nrows, int SBd, const void* lits, int F,
                              int LROWS, int LITB, int OUTB, void* out, void* meta_out,
                              void* stream) {
  const ExecArgs a{(const int*)meta, nrecp, (const int*)lls, (const int*)mls,
                   (const int*)ofvs, nrows, SBd, (const int*)lits, LROWS, LITB, OUTB,
                   (uint8_t*)out, (int*)meta_out};
  if (F > 0) {  // the wrapper guarantees nrows >= 1
    exec_kernel<<<F, LANES, 0, (cudaStream_t)stream>>>(a);
  }
  return zk_last_error();
}
