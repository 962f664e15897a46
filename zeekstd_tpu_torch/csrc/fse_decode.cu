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
// bit reads clip the word index and mask all 32 bits for n >= 32;
// 1 << of_code is 0 for of_code >= 32 (an XLA shift) and wraps in int32
// below; a table index counts from the end when negative and is then
// clamped (JAX's gather).
//
// What bounds it on this card: latency. Each state depends on the bits the
// previous sequence consumed, so a block is a serial chain of dependent
// loads; blocks are independent.
//
// What the design does about it: one thread per block, 32 blocks per warp,
// so a warp issues 32 chains' loads together. The bitstream words and the
// block's three 512-entry table rows are read through the read-only cache.

#include "common.cuh"

namespace {

constexpr int THREADS = 32;
constexpr int LL_CODES = 36, ML_CODES = 53;

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
  int *lls, *mls, *offs, *ofvs;  // (B, SB)
  int* reps;                     // (B, 3)
  int* hasrep;                   // (B,)
};

__device__ __forceinline__ int take_idx(int i, int size) {
  if (i < 0) i += size;
  return min(max(i, 0), size - 1);
}

__global__ void __launch_bounds__(THREADS) fse_decode_kernel(FseArgs a) {
  const int b = blockIdx.x * THREADS + threadIdx.x;
  if (b >= a.B) return;
  const uint32_t* w = a.words + (long long)b * a.WB;
  auto read_at = [&](int rem, int n) -> int {
    if (n <= 0) return 0;
    const int lo = rem - n;
    const int wi = lo >> 5;
    const int sh = lo & 31;
    const uint32_t w0 = __ldg(w + min(max(wi, 0), a.WB - 1));
    const uint32_t w1 = __ldg(w + min(max(wi + 1, 0), a.WB - 1));
    const uint32_t both = (w0 >> sh) | (sh == 0 ? 0u : w1 << (32 - sh));
    const uint32_t mask = n >= 32 ? 0xFFFFFFFFu : (1u << n) - 1u;
    return (int)(both & mask);
  };
  const int* t3 = a.tidx + (long long)b * 3;
  const int* tll = a.tables + (long long)take_idx(t3[0], a.ntables) * 512;
  const int* tof = a.tables + (long long)take_idx(t3[1], a.ntables) * 512;
  const int* tml = a.tables + (long long)take_idx(t3[2], a.ntables) * 512;
  const int ll_log = __ldg(a.logs + take_idx(t3[0], a.ntables));
  const int of_log = __ldg(a.logs + take_idx(t3[1], a.ntables));
  const int ml_log = __ldg(a.logs + take_idx(t3[2], a.ntables));
  const int* c = a.consts;

  int rem = a.start_bits[b];
  int ll_s = read_at(rem, ll_log);
  rem -= ll_log;
  int of_s = read_at(rem, of_log);
  rem -= of_log;
  int ml_s = read_at(rem, ml_log);
  rem -= ml_log;

  int r1 = 1, r2 = 4, r3 = 8, rep = 0;
  const int n = a.nseq[b];
  const int nn = min(max(n, 0), a.SB);
  const long long row = (long long)b * a.SB;
  for (int i = 0; i < nn; ++i) {
    const int of_e = __ldg(tof + take_idx(of_s, 256));
    const int ml_e = __ldg(tml + take_idx(ml_s, 512));
    const int ll_e = __ldg(tll + take_idx(ll_s, 512));
    const int of_code = of_e & 0xFF;
    const uint32_t pw = of_code >= 32 ? 0u : 1u << of_code;
    const int ofv = (int)(pw + (uint32_t)read_at(rem, of_code));
    rem -= of_code;
    const int mc = take_idx(ml_e & 0xFF, ML_CODES);
    const int mlb = c[192 + mc];
    const int ml = (int)((uint32_t)c[128 + mc] + (uint32_t)read_at(rem, mlb));
    rem -= mlb;
    const int lc = take_idx(ll_e & 0xFF, LL_CODES);
    const int llb = c[64 + lc];
    const int ll = (int)((uint32_t)c[lc] + (uint32_t)read_at(rem, llb));
    rem -= llb;

    // Repeat-offset resolution (RFC 8878 3.1.1.3.2.1.1), as the reference
    // selects it: an index outside 1..4 resolves to 0 and moves nothing.
    const int idx = ofv + (ll == 0 ? 1 : 0);
    const int off_rep = idx == 1 ? r1 : idx == 2 ? r2 : idx == 3 ? r3
                        : idx == 4 ? (int)((uint32_t)r1 - 1u) : 0;
    const int off = ofv > 3 ? (int)((uint32_t)ofv - 3u) : off_rep;
    const bool mv12 = ofv > 3 || idx >= 2;
    const bool mv3 = ofv > 3 || idx == 3 || idx == 4;
    const int nr1 = mv12 ? off : r1;
    const int nr2 = mv12 ? r1 : r2;
    const int nr3 = mv3 ? r2 : r3;
    r1 = nr1; r2 = nr2; r3 = nr3;

    // State updates, skipped after the block's last sequence.
    const bool upd = i + 1 < n;
    {
      const int nb = (ll_e >> 8) & 0xFF;
      const int s2 = (int)((uint32_t)(ll_e >> 16) + (uint32_t)read_at(rem, nb));
      if (upd) { rem -= nb; ll_s = s2; }
    }
    {
      const int nb = (ml_e >> 8) & 0xFF;
      const int s2 = (int)((uint32_t)(ml_e >> 16) + (uint32_t)read_at(rem, nb));
      if (upd) { rem -= nb; ml_s = s2; }
    }
    {
      const int nb = (of_e >> 8) & 0xFF;
      const int s2 = (int)((uint32_t)(of_e >> 16) + (uint32_t)read_at(rem, nb));
      if (upd) { rem -= nb; of_s = s2; }
    }
    a.lls[row + i] = ll;
    a.mls[row + i] = ml;
    a.offs[row + i] = off;
    a.ofvs[row + i] = ofv;
    const bool safe = ofv == 1 && ll > 0 && i >= 1;
    rep |= ofv <= 3 && !safe;
  }
  for (int i = nn; i < a.SB; ++i) {
    a.lls[row + i] = 0;
    a.mls[row + i] = 0;
    a.offs[row + i] = 1;
    a.ofvs[row + i] = 4;
  }
  a.reps[(long long)b * 3 + 0] = r1;
  a.reps[(long long)b * 3 + 1] = r2;
  a.reps[(long long)b * 3 + 2] = r3;
  a.hasrep[b] = rep;
}

}  // namespace

extern "C" int zk_fse_seq_decode_launch(const void* words, int WB, const void* start_bits,
                                        const void* nseq, const void* tidx, const void* tables,
                                        int ntables, const void* logs, const void* consts,
                                        int B, int SB, void* lls, void* mls, void* offs,
                                        void* ofvs, void* reps, void* hasrep, void* stream) {
  const FseArgs a{(const uint32_t*)words, WB, (const int*)start_bits, (const int*)nseq,
                  (const int*)tidx, (const int*)tables, ntables, (const int*)logs,
                  (const int*)consts, B, SB, (int*)lls, (int*)mls, (int*)offs, (int*)ofvs,
                  (int*)reps, (int*)hasrep};
  if (B > 0) {
    fse_decode_kernel<<<(B + THREADS - 1) / THREADS, THREADS, 0, (cudaStream_t)stream>>>(a);
  }
  return zk_last_error();
}
