// FSE sequence-bitstream encoder for Hopper.
//
// Replaces the TPU kernel zeekstd_tpu/ops/fse_kernel.py (_build /
// get_fse_kernel, the pallas_call at fse_kernel.py:280): one job per
// sequence-bearing block walks the match kernel's lm/ofv rows backward,
// derives the LL/ML/OF codes, keeps the three interleaved FSE states and
// packs the bitstream LSB-first into 32-bit words. The plain version is
// ops/fse_kernel.py::fse_plain.
//
// Stream item order: head = the last sequence's ll, ml, of extras; per
// sequence i = n-2..0 the state bits (of, ml, ll; of lowest) then the ll,
// ml, of extras; tail = the final ml, of, ll states at their accuracy
// logs. Words at index >= WBo are never written, but the bit count still
// counts them. Word bits // 32 is always written (the finalizer reads the
// sentinel byte there), word 0 also for a job without sequences.
//
// Two layouts of a sequence's lengths: packed (the archive pipeline's
// 32 KiB blocks), lm = ll << 16 | ml; and wide (the per-frame encoder's
// 128 KiB blocks, where a literal run or a match reaches 2^17), the full
// ll in lm and the full ml in a row of its own. The layout is a template
// argument, so the packed instance is the code it was.
//
// What bounds it on this card: latency. Each state depends on the one
// before it (a table load indexed by the state and its symbol), so a job
// is a serial chain; the bytes are few (about 4 us at the 10 MiB level-1
// shapes). The time is the longest job's chain.
//
// What the design does about it: only the chain stays serial.
// - One thread block (256 threads) per job; jobs spread over every SM.
//   The block stages its three table rows and the code constants in
//   shared memory and walks its sequences in chunks of K, from the last
//   one down.
// - Phase A, every thread: the chunk's lm/ofv (read coalesced, issued one
//   chunk ahead), each sequence's three codes, extras and extra-bit
//   counts, and per sequence and stream the symbol's (delta_nb_bits,
//   delta_find_state) pair in shared memory: all a state step reads that
//   does not depend on the state.
// - Phase B, three lanes of warp 0, one stream each: per sequence record
//   the state, then step it. The step is nb = (state + dnb) >> 16 and
//   state = the table entry at ((state >> nb) + dfs + 128) & 1023; the walk
//   keeps states times 4 (so the shifted state is a byte offset), computes
//   both candidate shifts (nb is k or k + 1, by one compare), selects, adds
//   and masks, and ORs the offset into its row's 4 KiB-aligned address:
//   four dependent integer operations and one shared load per step, the
//   next pair loaded off the chain. This is exact while states stay below
//   2^16 and entries below 2^23 in magnitude, as in every table the
//   encoder builds (states below 2^10); on other tables it may differ
//   from the plain version, but no read leaves the row.
// - Phase C, every thread: each sequence's state bits from the recorded
//   states, its bit count, a block-wide exclusive scan in stream order
//   (higher index first) from the bit carried out of the chunk before,
//   each item ORed into a zeroed word buffer in shared memory (an item is
//   at most 31 bits, so it spans at most two words), then the chunk's
//   full words stored coalesced; the partial last word carries on.
// Each item's bit count is clamped to [0, 31] (a no-op on valid tables),
// so the buffer holds any chunk and no input reaches outside it.
//
// Measured and left out (tools/torch_fse_encode_steps.py times other
// versions of this file in turns with this one): the step as zstd writes
// it (shift by the computed nb, mask, scale, add the row: seven dependent
// operations, 10% slower); the select left to the compiler (it selects
// the shift amount first: 20% slower); a warp that only walks while the
// other seven prepare the next chunk and pack the last one (1-2% slower:
// the walk's step grew by as much as the overlap saved); the chain's load
// issued before the record store and the next pair's load (6% slower).

#include "common.cuh"

namespace {

constexpr int JMETA_COLS = 8;
constexpr int J_REC = 0, J_NSEQ = 1, J_TLL = 2, J_TOF = 3, J_TML = 4, J_LOGS = 5;
constexpr int C_LLBASE = 0, C_LLBITS = 64, C_MLBASE = 128, C_MLBITS = 192,
              C_LLLUT = 256, C_MLLUT = 320;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xFFFFFFFFu;
// Streams in the order of the fused state bits: of lowest, then ml, ll.
constexpr int S_OF = 0, S_ML = 1, S_LL = 2;
constexpr int ITEM_BITS = 31;           // an item's bits at most (after the clamp)
constexpr int SEQ_ITEMS = 6;            // three state items, three extras

// In dynamic shared memory, placed at a 4 KiB boundary (ALIGN bytes of
// slack), so each table row (4 KiB) starts on one: the walk ORs an entry's
// byte offset into its row's address.
constexpr int ALIGN = 4096;
extern __shared__ __align__(16) unsigned char zk_fse_smem[];

template <int K>
struct Smem {
  static constexpr int SPT = (K + THREADS - 1) / THREADS;  // sequences per thread
  // Words of a chunk: the carried bits, K sequences, the tail, and the
  // word after the last item's first.
  static constexpr int BUFW = (31 + K * SEQ_ITEMS * ITEM_BITS + 3 * ITEM_BITS) / 32 + 2;
  int tab[3][1024];   // table rows of, ml, ll, times 4: [0:64] dnb, [64:128] dfs, [128:640] states
  int c[512];
  int2 dd[K][3];      // per sequence and stream: its symbol's step (see pair_of)
  int rs[K][3];       // per sequence and stream: the state its step starts from, times 4
  uint32_t buf[BUFW]; // the chunk's words; buf[0] starts with the carried bits
  int wsum[SPT * WARPS];
  int init[3];        // the states after the head sequence
  int fin[3];         // the final states
};

struct Code {
  int llc, mlc, ofc, lle, llb, mle, mlb, ofe;
};

template <bool WIDE>
__device__ __forceinline__ Code code_of(const int* c, int lm, int mlv, int ofv) {
  const int ll = WIDE ? lm : (int)((unsigned)lm >> 16), ml = WIDE ? mlv : lm & 0xFFFF;
  const int llc = ll < 64 ? c[C_LLLUT + ll] : 19 + zk_highbit(ll);
  const int mb = ml - 3;
  const int mlc = mb < 128 ? c[C_MLLUT + max(mb, 0)] : 36 + zk_highbit(mb);
  const int ofc = zk_highbit(ofv);
  return {llc, mlc, ofc, ll - c[C_LLBASE + llc], c[C_LLBITS + llc],
          ml - c[C_MLBASE + mlc], c[C_MLBITS + mlc], ofv - (1 << ofc)};
}

// t: a staged row (entries times 4); returns the state times 4.
__device__ __forceinline__ int init_state(const int* t, int sym) {
  const int dnb = t[sym] >> 2;
  const int nb = (dnb + (1 << 15)) >> 16;
  const int value = (nb << 16) - dnb;
  return t[(128 + (int)((unsigned)value >> nb) + (t[64 + sym] >> 2)) & 1023];
}

// A symbol's state step for the walk, from its dnb and dfs. For a state st
// in [0, 2^16) (every valid table's), nb = (st + dnb) >> 16 is k = dnb >> 16
// plus one where st >= thr = 2^16 - (dnb & 0xFFFF). The walk keeps S = 4 st,
// so the next state's byte offset in the staged row is
// ((S >> nb) + 4 (dfs + 128)) & 4092: the same entry as
// ((st >> nb) + dfs + 128) & 1023. Returns (4 thr | k << 24, 4 (dfs + 128)).
__device__ __forceinline__ int2 pair_of(int dnb, int dfs) {
  const int thr = (1 << 16) - (dnb & 0xFFFF);
  return make_int2((thr << 2) | (int)((unsigned)(dnb >> 16) << 24),
                   (int)((unsigned)(dfs + 128) << 2));
}

__device__ __forceinline__ int clamp_bits(int nb) { return min(max(nb, 0), ITEM_BITS); }

__device__ __forceinline__ uint32_t low_bits(int v, int nb) {
  return (uint32_t)v & ((1u << nb) - 1u);
}

// OR an item of at most 31 bits (already masked) into the buffer at bit pos.
__device__ __forceinline__ void put(uint32_t* buf, uint32_t v, int pos) {
  if (v == 0) return;
  const int w = pos >> 5, sh = pos & 31;
  atomicOr(&buf[w], v << sh);
  if (sh != 0 && (v >> (32 - sh)) != 0) atomicOr(&buf[w + 1], v >> (32 - sh));
}

template <int K, bool WIDE>
__global__ void __launch_bounds__(THREADS, 3)
fse_kernel(const int* __restrict__ consts, const int* __restrict__ meta,
           const int* __restrict__ lm, const int* __restrict__ mlw, const int* __restrict__ ofv,
           const int* __restrict__ tables, int ntables, int SBd, int WBo,
           uint32_t* __restrict__ words, int* __restrict__ bits) {
  using S = Smem<K>;
  constexpr int SPT = S::SPT;
  const unsigned smem = (unsigned)__cvta_generic_to_shared(zk_fse_smem);
  S& s = *reinterpret_cast<S*>(zk_fse_smem + ((ALIGN - (smem & (ALIGN - 1))) & (ALIGN - 1)));
  const int j = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int* m = meta + (long long)j * JMETA_COLS;
  const int nseq = min(m[J_NSEQ], SBd);
  uint32_t* out = words + (long long)j * WBo;
  if (nseq <= 0) {
    if (tid == 0) {
      if (WBo > 0) out[0] = 0;
      bits[j] = 0;
    }
    return;
  }
  const int rows[3] = {m[J_TOF], m[J_TML], m[J_TLL]};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int* src = tables + (long long)min(max(rows[k], 0), ntables - 1) * 1024;
    for (int i = tid; i < 1024; i += THREADS) s.tab[k][i] = (int)((unsigned)src[i] << 2);
  }
  for (int i = tid; i < 512; i += THREADS) s.c[i] = consts[i];
  for (int i = tid; i < S::BUFW; i += THREADS) s.buf[i] = 0;
  const int logs = m[J_LOGS];
  const int* lmr = lm + (long long)m[J_REC] * SBd;
  const int* ofr = ofv + (long long)m[J_REC] * SBd;
  const int* mlr = WIDE ? mlw + (long long)m[J_REC] * SBd : nullptr;
  int nlm[SPT], nml[SPT], nof[SPT];  // the next chunk's rows, loaded a chunk ahead
#pragma unroll
  for (int q = 0; q < SPT; ++q) {
    const int p = q * THREADS + tid;
    nlm[q] = p < K && p < nseq ? lmr[nseq - 1 - p] : 0;
    nml[q] = WIDE && p < K && p < nseq ? mlr[nseq - 1 - p] : 0;
    nof[q] = p < K && p < nseq ? ofr[nseq - 1 - p] : 0;
  }
  __syncthreads();  // staged

  int st = 0;               // lanes 0-2 of warp 0: the state of stream `lane`, times 4
  int carry = 0, gw = 0;    // bits carried in buf[0]; words stored before it
  for (int top = nseq - 1; top >= 0; top -= K) {
    const int cnt = min(K, top + 1);
    const bool last = top < K;
    // --- phase A: codes, extras and table pairs --------------------------
    int dnb[SPT][3], xv[SPT][3], xb[SPT][3];
#pragma unroll
    for (int q = 0; q < SPT; ++q) {
      const int p = q * THREADS + tid;
      const int lmv = nlm[q], mlv = nml[q], ofvv = nof[q];
      const int pn = p + K;  // the same slot of the next chunk
      nlm[q] = p < K && top - pn >= 0 ? lmr[top - pn] : 0;
      nml[q] = WIDE && p < K && top - pn >= 0 ? mlr[top - pn] : 0;
      nof[q] = p < K && top - pn >= 0 ? ofr[top - pn] : 0;
      if (p < cnt) {
        const Code cd = code_of<WIDE>(s.c, lmv, mlv, ofvv);
        const int sym[3] = {cd.ofc, cd.mlc, cd.llc};
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          dnb[q][k] = s.tab[k][sym[k]] >> 2;
          s.dd[p][k] = pair_of(dnb[q][k], s.tab[k][64 + sym[k]] >> 2);
        }
        xv[q][0] = cd.lle, xb[q][0] = clamp_bits(cd.llb);
        xv[q][1] = cd.mle, xb[q][1] = clamp_bits(cd.mlb);
        xv[q][2] = cd.ofe, xb[q][2] = clamp_bits(cd.ofc);
        if (top - p == nseq - 1) {
#pragma unroll
          for (int k = 0; k < 3; ++k) s.init[k] = init_state(s.tab[k], sym[k]);
        }
      } else {
#pragma unroll
        for (int k = 0; k < 3; ++k) dnb[q][k] = xv[q][k] = xb[q][k] = 0;
      }
    }
    __syncthreads();  // phase A done
    // --- phase B: the state walk, one lane per stream --------------------
    if (tid < 3) {
      const int p0 = top == nseq - 1 ? 1 : 0;  // the head sequence takes no step
      if (p0 == 1) st = s.init[tid];
      const unsigned row = (unsigned)__cvta_generic_to_shared(s.tab[tid]);
      if (p0 < cnt) {
        int2 e = s.dd[p0][tid];
        for (int p = p0; p < cnt; ++p) {
          const int2 en = s.dd[min(p + 1, K - 1)][tid];
          s.rs[p][tid] = st;
          // Both shifts, then a select of the two values (written as two
          // PTX shifts, so the compiler does not select the shift amount
          // first and lengthen the chain); PTX shifts by 32 or more give 0.
          const int k = e.x >> 24;
          unsigned a, b, next;
          asm("shr.b32 %0, %1, %2;" : "=r"(a) : "r"(st), "r"(k));
          asm("shr.b32 %0, %1, %2;" : "=r"(b) : "r"(st), "r"(k + 1));
          const unsigned v = st >= (e.x & 0xFFFFFF) ? b : a;
          asm volatile("ld.shared.b32 %0, [%1];" : "=r"(next) : "r"(((v + e.y) & 4092u) | row));
          st = (int)next;
          e = en;
        }
      }
      s.fin[tid] = st;
    }
    __syncthreads();  // walk done
    // --- phase C: state bits, bit positions, pack -------------------------
    int sv[SPT][3], sb[SPT][3], n[SPT], incl[SPT];
#pragma unroll
    for (int q = 0; q < SPT; ++q) {
      const int p = q * THREADS + tid;
      const bool stepped = p < cnt && top - p < nseq - 1;
      n[q] = xb[q][0] + xb[q][1] + xb[q][2];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int r = stepped ? s.rs[p][k] >> 2 : 0;
        sb[q][k] = stepped ? clamp_bits((r + dnb[q][k]) >> 16) : 0;
        sv[q][k] = (int)low_bits(r, sb[q][k]);
        n[q] += sb[q][k];
      }
      int x = n[q];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(FULL, x, o);
        if (lane >= o) x += y;
      }
      incl[q] = x;
      if (lane == 31) s.wsum[q * WARPS + warp] = x;
    }
    __syncthreads();  // warp sums
    int base[SPT], chunk_bits = 0;
#pragma unroll
    for (int e = 0; e < SPT * WARPS; ++e) {
#pragma unroll
      for (int q = 0; q < SPT; ++q)
        if (e == q * WARPS + warp) base[q] = chunk_bits;
      chunk_bits += s.wsum[e];
    }
#pragma unroll
    for (int q = 0; q < SPT; ++q) {
      if (q * THREADS + tid >= cnt) continue;
      int pos = carry + base[q] + incl[q] - n[q];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        put(s.buf, (uint32_t)sv[q][k], pos);
        pos += sb[q][k];
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        put(s.buf, low_bits(xv[q][k], xb[q][k]), pos);
        pos += xb[q][k];
      }
    }
    const int ml_log = (logs >> 10) & 31, of_log = (logs >> 5) & 31, ll_log = logs & 31;
    int total = carry + chunk_bits;
    if (last) {
      if (tid == 0) {
        int pos = total;
        put(s.buf, low_bits(s.fin[S_ML] >> 2, ml_log), pos);
        pos += ml_log;
        put(s.buf, low_bits(s.fin[S_OF] >> 2, of_log), pos);
        pos += of_log;
        put(s.buf, low_bits(s.fin[S_LL] >> 2, ll_log), pos);
      }
      total += ml_log + of_log + ll_log;
    }
    __syncthreads();  // packed
    // --- flush: full words out, the partial word carried -----------------
    const int nfull = total >> 5;
    for (int w = tid; w < nfull; w += THREADS) {
      if (gw + w < WBo) out[gw + w] = s.buf[w];
      s.buf[w] = 0;
    }
    if (tid == 0) {
      const uint32_t part = s.buf[nfull];
      if (nfull > 0) s.buf[nfull] = 0;
      s.buf[0] = part;
      if (last) {
        if (gw + nfull < WBo) out[gw + nfull] = part;
        bits[j] = gw * 32 + total;
      }
    }
    gw += nfull;
    carry = total & 31;
  }
}

template <int K, bool WIDE>
int launch(const int* consts, const int* meta, const int* lm, const int* mlw, const int* ofv,
           const int* tables, int ntables, int njobs, int SBd, int WBo, uint32_t* words,
           int* bits, cudaStream_t stream) {
  constexpr int bytes = (int)sizeof(Smem<K>) + ALIGN;
  static bool sized = false;  // more than 48 KiB must be asked for, once
  if (!sized) {
    cudaFuncSetAttribute(fse_kernel<K, WIDE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         bytes);
    sized = true;
  }
  fse_kernel<K, WIDE><<<njobs, THREADS, bytes, stream>>>(consts, meta, lm, mlw, ofv, tables,
                                                         ntables, SBd, WBo, words, bits);
  return zk_last_error();
}

}  // namespace

// chunk: sequences per chunk, 512 (the pipeline's) or 32 (tests: every job
// crosses chunk boundaries); any other value returns cudaErrorInvalidValue.
extern "C" int zk_fse_launch(const void* consts, const void* meta,
                             const void* lm, const void* ofv,
                             const void* tables, int ntables, int njobs,
                             int SBd, int WBo, int chunk, void* words, void* bits,
                             void* stream) {
  decltype(&launch<512, false>) run;
  switch (chunk) {
    case 512: run = launch<512, false>; break;
    case 32: run = launch<32, false>; break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (njobs <= 0) return zk_last_error();
  return run((const int*)consts, (const int*)meta, (const int*)lm, nullptr, (const int*)ofv,
             (const int*)tables, ntables, njobs, SBd, WBo, (uint32_t*)words, (int*)bits,
             (cudaStream_t)stream);
}

// The wide layout: ll and ml rows of their own (the per-frame encoder).
extern "C" int zk_fse_wide_launch(const void* consts, const void* meta,
                                  const void* ll, const void* ml, const void* ofv,
                                  const void* tables, int ntables, int njobs,
                                  int SBd, int WBo, int chunk, void* words, void* bits,
                                  void* stream) {
  decltype(&launch<512, true>) run;
  switch (chunk) {
    case 512: run = launch<512, true>; break;
    case 32: run = launch<32, true>; break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (njobs <= 0) return zk_last_error();
  return run((const int*)consts, (const int*)meta, (const int*)ll, (const int*)ml,
             (const int*)ofv, (const int*)tables, ntables, njobs, SBd, WBo, (uint32_t*)words,
             (int*)bits, (cudaStream_t)stream);
}
