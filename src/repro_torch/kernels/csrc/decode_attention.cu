// One-token GQA decode attention for Hopper (sm_90a), contiguous and paged,
// split over the sequence (split-K) with a merge pass.
//
// Replaces the TPU kernels in src/repro/kernels/decode_attention.py:
//   decode_attention        (_dec_kernel, pallas_call at :127)
//   paged_decode_attention  (_paged_dec_kernel, pallas_call at :249)
//
// What it computes: for each row b and query head, softmax attention of the
// single query (sitting at position lengths[b]-1) over the positions
// pos < lengths[b] with lengths[b]-1-pos < window; scores, softmax and sums
// in float32, output in q's dtype; a row with nothing live gives zeros.
// Contiguous K/V are (B, S, Hkv, D) slot stripes; paged K/V are
// (NB, bs, Hkv, D) block pools read through tables (B, MB), with an
// optional int8 mode whose per-position float32 scales (NB, bs) are applied
// per position (to the score for K, to the probability for V).  Both
// layouts are read in place.
//
// Bound on the H100: bytes.  Each live K/V element feeds 2G multiply-adds
// (G = H / Hkv = 2 for internlm2), far below the ~295 operations per byte
// where the tensor cores would bound.  The bytes it must move: the live K
// and V once (live positions x Hkv x D x 2 x the element size, plus 8 bytes
// of scales per live position for int8), q and the output once, the live
// table entries and the lengths.  At internlm2's serving shape (8 rows,
// lengths 1-1024, Hkv 8, D 128, bf16) that is 14.1 MB, 4.2 us at 3.35 TB/s;
// at the long shape (lengths up to 4096) 52.5 MB, 15.7 us; at gemma3-4b's
// (8 rows, lengths 1-2048, Hkv 4, D 256) 30.0 MB, 9.0 us, and 23.8 MB,
// 7.1 us, in its 1024 window.
//
// What the first design lost: one CTA per (row, KV head) walked its whole
// row, so a step had 64 CTAs on 132 SMs and the longest row set the time;
// each 32-position tile went through five barriers (stage, scores, softmax,
// p V) with 2-byte loads, about 16 KB in flight per CTA and none of the
// next tile while the current one was computed.  It took 0.305 ms at the
// serving shape, 7x SDPA, and at the long shape was slower than its own
// plain PyTorch version.
//
// This design:
//   * Split-K.  The grid is (B * Hkv) x n_split; CTA (b, h, s) takes
//     positions [s * chunk, (s + 1) * chunk) of row b clipped to the live
//     window.  chunk and n_split come from the stripe length S (or MB * bs)
//     alone, never from lengths (the wrapper's split_plan): reading lengths
//     on the host would cost a sync per layer.  A CTA whose range is empty
//     skips the loop and writes an empty partial (l = 0).  At S 1024, chunk
//     128: 512 CTAs, 240 of them live at the serving shape.
//   * Bytes in flight, not barriers.  A position's D elements are covered
//     by a group of lanes with one 16-byte load each (16 lanes of 8 bf16,
//     32 lanes of 4 float32; int8: 16 lanes of 8, 8-byte loads), so a warp
//     reads 2 (bf16, int8) or 1 (float32) positions at a time.  Each group
//     issues the K and V loads of U positions (U = 8 for G <= 2) before it
//     uses any: 32 KB in flight per CTA of 128 threads at bf16, 3 CTAs per
//     SM.  q for the G heads sits in registers, pre-scaled by D^-1/2 log2 e
//     and loaded beside lengths[b]; a score is summed across its group's
//     lanes with shuffles; each group keeps its own online softmax (m, l,
//     acc) in registers, one rescale per U positions.  The groups are
//     combined once, at the end of the CTA, through shared memory: the
//     CTA's only barrier on the contiguous path.  The paged path stages the
//     row offsets of 128 positions (and the int8 scales) in shared memory
//     per 128 positions: table and scale loads once per CTA, not per lane.
//   * Merge.  Each CTA writes float32 partials (m in base 2, l, acc[D] per
//     query head; acc only when l > 0) to a workspace the wrapper
//     allocates; a second kernel, one CTA per (row, query head), weighs
//     split i by exp2(m_i - M) and divides by the weighed sum of l.  Its acc
//     loads are issued 16 splits at a time before their weights are read,
//     and a select (not a branch) drops empty splits, whose acc was never
//     written.  A plan of one split (S <= 128, which no served shape has)
//     goes through the merge too: one output path.
//   * The same code, split boundaries and summation order for both layouts,
//     so a paged run agrees with a contiguous one token for token.
//   * Masked positions get p = 0 explicitly; empty groups and splits are
//     skipped by their l = 0, never weighed, so garbage and -inf never meet.
//   * Head dims up to 256, in two instances on the head dim DM.  DM 128
//     (every D up to 128: internlm2's 128, zamba2's 80) is the design
//     above.  DM 256 (gemma3-4b's D 256, G 2) keeps the lane groups and
//     gives each lane two loads a position, 128 elements apart, so that a
//     warp's loads still cover whole 256-byte rows; its q and acc double
//     to 2 x 16 floats a lane at G 2, and it keeps half the positions in
//     flight (U 4), the same bytes in flight as DM 128.  It serves G <= 2
//     only: acc_s[NPAR][MAXG][DM] of the G 8 sizing would double the
//     shared memory and the registers of a case no served model has.
//     A D that is not a multiple of the load width, or a pool not aligned
//     to it, takes the same loop with element loads.
//   * Two register sizings at DM 128: MAXG 2 (G 1-2, internlm2's G, 8
//     positions in flight per group) and MAXG 8 (G 3-8, 2 positions in
//     flight, so that q, the scores and acc of 8 heads fit the registers).
//
// What is left (numbers in PERF.md, from chip_smoke.py and profile_step.py):
//   * The split pass loads about 2.2 TB/s on full rows and less on ragged
//     ones (empty CTAs, a dependent prologue per CTA, the last wave).
//     Variants built while designing it (a cp.async ring holding a CTA's
//     whole chunk in shared memory, U 2/4/16, chunk 64/256, 4 CTAs per
//     SM) did no better, and a copy that loads the same bytes with no
//     arithmetic only a little better: the CTA structure, not the loads
//     or the arithmetic, sets the pace.  Persistent CTAs that walk the live
//     chunks (the lengths read on the device) and prefetch the next
//     chunk's K/V while computing one are the next step.
//   * The merge is a second launch.  Merging in the last CTA of each
//     (row, KV head) to finish (an atomic counter) was tried: it put the
//     merge on the split pass's tail and added device time, so the two
//     passes stay.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kSub = 128;         // positions per staged sub-chunk (paged)
constexpr int kMaxG = 8;          // query heads per KV head
constexpr int kMaxD = 256;        // head dim (DM 256 instance: G <= 2)
constexpr int kSmallD = 128;      // head dims of the DM 128 instances
constexpr int kMaxSplits = 64;    // split_plan's MAX_SPLITS: merge weights
constexpr float kNegInf = -1.0e30f;
constexpr float kLog2e = 1.4426950408889634f;

// 2^x as one MUFU.EX2 (flush-to-zero: no denormal fix-up around it)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's cast
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// One lane's load of a position: N elements of type KT in one load of T;
// LANES lanes cover 128 elements (a head dim up to 128 in one load a lane,
// 256 in two).  R is the raw element for element loads.
template <typename KT> struct Pack;
template <> struct Pack<__nv_bfloat16> {
  using T = uint4;
  using R = uint16_t;
  static constexpr int N = 8, LANES = 16;
  __device__ static void unpack(const T& r, float* f) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // bf16 is the high half of a float32
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};
template <> struct Pack<float> {
  using T = uint4;
  using R = uint32_t;
  static constexpr int N = 4, LANES = 32;
  __device__ static void unpack(const T& r, float* f) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
};
template <> struct Pack<int8_t> {
  using T = uint2;
  using R = uint8_t;
  static constexpr int N = 8, LANES = 16;
  __device__ static void unpack(const T& r, float* f) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[i] = static_cast<float>(static_cast<int8_t>((r.x >> (8 * i)) & 0xff));
      f[4 + i] =
          static_cast<float>(static_cast<int8_t>((r.y >> (8 * i)) & 0xff));
    }
  }
};

// Elements [d0, d0 + N) of the row at p (zeros past D): one vector load when
// vec (D a multiple of N, the pool aligned), else element loads.
template <typename KT>
__device__ __forceinline__ typename Pack<KT>::T load_pack(const KT* p, int d0,
                                                          int D, bool vec) {
  using P = Pack<KT>;
  union {
    typename P::T v;
    typename P::R e[P::N];
  } u;
  u.v = typename P::T{};
  if (vec) {
    if (d0 < D) u.v = __ldg(reinterpret_cast<const typename P::T*>(p + d0));
  } else {
    const typename P::R* r = reinterpret_cast<const typename P::R*>(p);
#pragma unroll
    for (int e = 0; e < P::N; ++e)
      if (d0 + e < D) u.e[e] = __ldg(r + d0 + e);
  }
  return u.v;
}

struct Args {
  const void* q;          // (B, H, D)
  const void* k;          // contiguous (B, S, Hkv, D) | paged (NB, bs, Hkv, D)
  const void* v;
  const float* k_scale;   // paged int8 only: (NB, bs)
  const float* v_scale;
  const int32_t* tables;  // paged only: (B, MB)
  const int32_t* lengths; // (B,)
  void* out;              // (B, H, D), q's dtype
  float* part;            // m (B*H, n) | l (B*H, n) | acc (B*H, n, D)
  int B, H, Hkv, D;
  int S;                  // contiguous: stripe length; paged: block size bs
  int MB;                 // paged: table width
  int window;
  int chunk, n_split;     // positions per CTA, CTAs per (row, KV head)
  float scale;
  bool vec;               // 16-byte (int8: 8-byte) loads
};

// CTA (b * Hkv + h, split): the partial softmax of its chunk for the G query
// heads of KV head h.  QT: query/output type; KT: stored K/V type; MAXG: a
// bound on G that sizes the registers; DM: a bound on D (128 or 256).
template <typename QT, typename KT, bool PAGED, int MAXG, int DM>
__global__ void __launch_bounds__(kThreads) decode_split_kernel(Args a) {
  using P = Pack<KT>;
  constexpr bool QUANT = std::is_same<KT, int8_t>::value;
  constexpr int N = P::N, LANES = P::LANES;
  constexpr int NV = DM / (N * LANES);  // loads a lane makes per position
  constexpr int E = NV * N;             // elements a lane holds
  constexpr int PPW = 32 / LANES;       // positions per warp at a time
  constexpr int NPAR = kWarps * PPW;    // lane groups (positions) per CTA
  constexpr int U = MAXG >= 8 ? 2 : 8 / NV;  // positions' loads in flight
  constexpr int STEP = NPAR * U;        // positions per batch
  static_assert(DM % (N * LANES) == 0, "a lane's loads must tile DM");
  static_assert(kSub % STEP == 0, "a batch must not straddle a sub-chunk");

  const int b = blockIdx.x / a.Hkv, h = blockIdx.x % a.Hkv;
  const int split = blockIdx.y;
  const int G = a.H / a.Hkv, D = a.D;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = warp * PPW + lane / LANES;  // this lane's group
  const int d0 = (lane % LANES) * N;  // its first element (load j: + j N LANES)

  // q of the G heads, this lane's elements, scaled so that scores are in
  // base 2: exp(x * scale) = exp2(x * scale * log2 e).  Loaded before the
  // chunk's range is known, so its latency overlaps that of lengths[b].
  const long long row0 = (long long)b * a.H + h * G;  // first query head row
  const QT* q = static_cast<const QT*>(a.q) + row0 * D;
  float qf[MAXG][E];
#pragma unroll
  for (int g = 0; g < MAXG; ++g)
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const int d = d0 + j * N * LANES + e;
        qf[g][j * N + e] =
            (g < G && d < D) ? to_f32(q[g * D + d]) * (a.scale * kLog2e)
                             : 0.f;
      }

  const int len = a.lengths[b];
  const int limit = PAGED ? a.MB * a.S : a.S;  // positions that exist
  const int lo = a.window < len ? len - a.window : 0;  // first in window
  const int c_lo = max(split * a.chunk, lo);
  const int c_hi = min((split + 1) * a.chunk, min(len, limit));

  float m[MAXG], l[MAXG], acc[MAXG][E];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }

  const KT* kp = static_cast<const KT*>(a.k);
  const KT* vp = static_cast<const KT*>(a.v);
  __shared__ long long row_s[PAGED ? kSub : 1];  // element offset of (pos, h)
  __shared__ float ks_s[QUANT ? kSub : 1], vs_s[QUANT ? kSub : 1];

  // an empty range (nothing live in this chunk) skips the loop: l = 0
  for (int c0 = split * a.chunk; c0 < c_hi; c0 += kSub) {
    if (c0 + kSub <= c_lo) continue;
    if (PAGED) {  // where each position of the sub-chunk lives
      __syncthreads();  // the previous sub-chunk's readers are done
      for (int t = tid; t < kSub; t += kThreads) {
        const int pos = c0 + t;
        long long row = 0;
        float ks = 0.f, vs = 0.f;
        if (pos >= c_lo && pos < c_hi) {
          const int pid = a.tables[(long long)b * a.MB + pos / a.S];
          const long long slot = (long long)pid * a.S + pos % a.S;
          row = (slot * a.Hkv + h) * D;
          if (QUANT) {
            ks = a.k_scale[slot];
            vs = a.v_scale[slot];
          }
        }
        row_s[t] = row;
        if (QUANT) {
          ks_s[t] = ks;
          vs_s[t] = vs;
        }
      }
      __syncthreads();
    }
    for (int i0 = 0; i0 < kSub; i0 += STEP) {
      const int base = c0 + i0;
      if (base + STEP <= c_lo) continue;
      if (base >= c_hi) break;
      // (a) the K and V loads of U positions, all issued before any use
      typename P::T kr[U][NV], vr[U][NV];
      bool ok[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int t = i0 + u * NPAR + grp;
        const int pos = c0 + t;
        ok[u] = pos >= c_lo && pos < c_hi;
        const long long row =
            PAGED ? row_s[t]
                  : (((long long)b * a.S + pos) * a.Hkv + h) * D;
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          kr[u][j] = typename P::T{};
          vr[u][j] = typename P::T{};
          if (ok[u]) {
            kr[u][j] = load_pack(kp + row, d0 + j * N * LANES, D, a.vec);
            vr[u][j] = load_pack(vp + row, d0 + j * N * LANES, D, a.vec);
          }
        }
      }
      // (b) scores: a partial dot product per lane, summed over the group
      float s[U][MAXG];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float kf[E];
#pragma unroll
        for (int j = 0; j < NV; ++j) P::unpack(kr[u][j], kf + j * N);
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
          float x = 0.f;
#pragma unroll
          for (int e = 0; e < E; ++e) x = fmaf(qf[g][e], kf[e], x);
#pragma unroll
          for (int o = LANES / 2; o > 0; o >>= 1)
            x += __shfl_xor_sync(0xffffffffu, x, o);
          const float ksc = QUANT ? ks_s[i0 + u * NPAR + grp] : 1.f;
          s[u][g] = ok[u] ? x * ksc : kNegInf;
        }
      }
      // (c) online softmax: one rescale per batch, masked positions p = 0
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        float mb = m[g];
#pragma unroll
        for (int u = 0; u < U; ++u) mb = fmaxf(mb, s[u][g]);
        const float corr = ex2(m[g] - mb);
        m[g] = mb;
        l[g] *= corr;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] *= corr;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float vf[E];
#pragma unroll
        for (int j = 0; j < NV; ++j) P::unpack(vr[u][j], vf + j * N);
        const float vsc = QUANT ? vs_s[i0 + u * NPAR + grp] : 1.f;
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
          const float p = ok[u] ? ex2(s[u][g] - m[g]) : 0.f;
          l[g] += p;
          const float pv = p * vsc;
#pragma unroll
          for (int e = 0; e < E; ++e) acc[g][e] = fmaf(pv, vf[e], acc[g][e]);
        }
      }
    }
  }

  // combine the NPAR groups once, through shared memory
  __shared__ float m_s[NPAR][MAXG], l_s[NPAR][MAXG];
  __shared__ float acc_s[NPAR][MAXG][DM];
  if (lane % LANES == 0) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      m_s[grp][g] = m[g];
      l_s[grp][g] = l[g];
    }
  }
#pragma unroll
  for (int g = 0; g < MAXG; ++g)
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int e = 0; e < N; ++e)
        acc_s[grp][g][d0 + j * N * LANES + e] = acc[g][j * N + e];
  __syncthreads();
  const long long BHn = (long long)a.B * a.H * a.n_split;  // partials' stride
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    float M = kNegInf;
#pragma unroll
    for (int j = 0; j < NPAR; ++j)
      if (l_s[j][g] > 0.f) M = fmaxf(M, m_s[j][g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int j = 0; j < NPAR; ++j) {
      if (l_s[j][g] > 0.f) {  // a group that saw no live position is skipped
        const float w = ex2(m_s[j][g] - M);
        L = fmaf(w, l_s[j][g], L);
        A = fmaf(w, acc_s[j][g][d], A);
      }
    }
    const long long r = (row0 + g) * a.n_split + split;
    if (L > 0.f) a.part[2 * BHn + r * D + d] = A;  // empty: never read
    if (d == 0) {
      a.part[r] = M;
      a.part[BHn + r] = L;
    }
  }
}

// CTA r = (row, query head): the n_split partials weighed by exp2(m_i - M),
// empty splits (l = 0) skipped; a row with none live gives zeros.  Each
// thread issues the acc loads of kBatch splits before it reads their
// weights (the first batch's overlap warp 0's weights), and drops an empty
// split's unwritten acc with a select, not a branch.  A thread owns
// columns tid + c kThreads, c < DM / kThreads.
template <typename QT, int DM>
__global__ void __launch_bounds__(kThreads)
    decode_merge_kernel(const float* part, void* out, int rows, int D,
                        int n_split) {
  constexpr int kBatch = 16;
  constexpr int COLS = DM / kThreads;
  const int r = blockIdx.x, tid = threadIdx.x;
  const long long n = (long long)rows * n_split;
  const float* m = part + (long long)r * n_split;
  const float* l = m + n;
  const float* acc = part + 2 * n + (long long)r * n_split * D;
  __shared__ float w_s[kMaxSplits];
  __shared__ float L_s;
  float A[COLS];
#pragma unroll
  for (int c = 0; c < COLS; ++c) A[c] = 0.f;
  for (int i0 = 0; i0 < n_split; i0 += kBatch) {
    float x[COLS][kBatch];
#pragma unroll
    for (int c = 0; c < COLS; ++c)
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int d = tid + c * kThreads;
        x[c][j] = d < D && i0 + j < n_split
                      ? acc[(long long)(i0 + j) * D + d]
                      : 0.f;
      }
    if (i0 == 0) {
      if (tid < 32) {  // warp 0: the largest live m, the weights, sum l
        float M = kNegInf;
        for (int i = tid; i < n_split; i += 32) {
          const float li = l[i], mi = m[i];
          M = li > 0.f ? fmaxf(M, mi) : M;
        }
        M = warp_max(M);
        float L = 0.f;
        for (int i = tid; i < n_split; i += 32) {
          const float li = l[i], mi = m[i];
          const float w = li > 0.f ? ex2(mi - M) : 0.f;
          w_s[i] = w;
          L = fmaf(w, li, L);
        }
        L = warp_sum(L);
        if (tid == 0) L_s = L;
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const float w = i0 + j < n_split ? w_s[i0 + j] : 0.f;
#pragma unroll
      for (int c = 0; c < COLS; ++c)
        A[c] = w > 0.f ? fmaf(w, x[c][j], A[c]) : A[c];
    }
  }
  const float L = L_s;
#pragma unroll
  for (int c = 0; c < COLS; ++c) {
    const int d = tid + c * kThreads;
    if (d < D)
      store(static_cast<QT*>(out) + (long long)r * D + d,
            L > 0.f ? A[c] / L : 0.f);
  }
}

// dtype codes shared with the Python wrapper
enum { kF32 = 0, kBF16 = 1, kI8 = 2 };

template <typename QT, int DM>
int launch_merge(const Args& a, cudaStream_t stream) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_merge_kernel<QT, DM><<<a.B * a.H, kThreads, 0, stream>>>(
      a.part, a.out, a.B * a.H, a.D, a.n_split);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT, typename KT, bool PAGED>
int launch_typed(const Args& a, cudaStream_t stream) {
  const dim3 grid(a.B * a.Hkv, a.n_split), block(kThreads);
  const int G = a.H / a.Hkv;
  if (a.D > kSmallD) {  // launch() admits G <= 2 only here
    decode_split_kernel<QT, KT, PAGED, 2, kMaxD>
        <<<grid, block, 0, stream>>>(a);
    return launch_merge<QT, kMaxD>(a, stream);
  }
  if (G <= 2)
    decode_split_kernel<QT, KT, PAGED, 2, kSmallD>
        <<<grid, block, 0, stream>>>(a);
  else
    decode_split_kernel<QT, KT, PAGED, 8, kSmallD>
        <<<grid, block, 0, stream>>>(a);
  return launch_merge<QT, kSmallD>(a, stream);
}

template <bool PAGED>
int launch(Args a, int q_dtype, int kv_dtype, cudaStream_t stream) {
  if (a.H % a.Hkv || a.H / a.Hkv > kMaxG || a.D > kMaxD || a.D < 1 ||
      (a.D > kSmallD && a.H / a.Hkv > 2) ||
      a.chunk < 1 || a.n_split < 1 || a.n_split > kMaxSplits ||
      (long long)a.chunk * a.n_split < (PAGED ? (long long)a.MB * a.S : a.S) ||
      a.part == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.B == 0) return 0;
  const int width = kv_dtype == kI8 ? 8 : 16;      // bytes of one load
  const int elem = kv_dtype == kI8 ? 1 : (kv_dtype == kF32 ? 4 : 2);
  a.vec = (a.D * elem) % width == 0 &&
          reinterpret_cast<uintptr_t>(a.k) % width == 0 &&
          reinterpret_cast<uintptr_t>(a.v) % width == 0;
  if (q_dtype == kBF16 && kv_dtype == kBF16)
    return launch_typed<__nv_bfloat16, __nv_bfloat16, PAGED>(a, stream);
  if (q_dtype == kF32 && kv_dtype == kF32)
    return launch_typed<float, float, PAGED>(a, stream);
  if (PAGED && q_dtype == kBF16 && kv_dtype == kI8)
    return launch_typed<__nv_bfloat16, int8_t, PAGED>(a, stream);
  if (PAGED && q_dtype == kF32 && kv_dtype == kI8)
    return launch_typed<float, int8_t, PAGED>(a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

int decode_attention_contiguous(const void* q, const void* k, const void* v,
                                const int32_t* lengths, void* out,
                                float* workspace, int B, int H, int Hkv,
                                int D, int S, int window, int chunk,
                                int n_split, float scale, int q_dtype,
                                int kv_dtype, void* stream) {
  Args a{q,     k,   v, nullptr, nullptr, nullptr, lengths, out, workspace,
         B,     H,   Hkv, D, S, 0, window, chunk, n_split, scale, false};
  return launch<false>(a, q_dtype, kv_dtype,
                       static_cast<cudaStream_t>(stream));
}

int decode_attention_paged(const void* q, const void* k_pool,
                           const void* v_pool, const float* k_scale,
                           const float* v_scale, const int32_t* tables,
                           const int32_t* lengths, void* out,
                           float* workspace, int B, int H, int Hkv, int D,
                           int bs, int MB, int window, int chunk, int n_split,
                           float scale, int q_dtype, int kv_dtype,
                           void* stream) {
  Args a{q, k_pool, v_pool, k_scale, v_scale, tables, lengths, out, workspace,
         B, H,      Hkv,    D,       bs,      MB,     window,  chunk, n_split,
         scale, false};
  return launch<true>(a, q_dtype, kv_dtype,
                      static_cast<cudaStream_t>(stream));
}

const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
