// Causal GQA flash attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel in src/repro/kernels/flash_attention.py:
//   flash_attention  (_fa_kernel at :24, wrapper at :68, pallas_call at :91)
//
// What it computes: for q (B, S, H, D), k (B, S, Hkv, D) and v (B, S, Hkv,
// Dv) with H % Hkv == 0, softmax attention of query position i of head h over key
// positions j of KV head h / (H / Hkv) with j < S and, when causal,
// j <= i and i - j < window; scores, softmax and the output sums in
// float32, the output (B, S, H, Dv) cast to q's dtype, with the score
// scale the caller gives (D ** -0.5).  It also writes the per-row
// log-sum-exp (B, H, S) float32 of the scaled, masked scores, which the
// backward pass uses to recompute the probabilities.  A row with no live
// key gets p = 0 everywhere (zeros out), not exp(NEG_INF - NEG_INF).
// Head dims (Dv = D) that are multiples of 16 up to 128, and 256
// (gemma3-4b); and D 192 with Dv 128, deepseek-v2's MLA prefill (per-head
// K of 128 expanded columns and 64 rope ones, V of 128).
//
// Bound on the H100 (each input read once, each output written once; the
// causal products 4 B H D S (S + 1) / 2 at 989 TFLOP/s bf16):
//   * training shape (16 rows, S 143, H 16, Hkv 8, D 128): 28.3 MB, 8.4 us
//     at 3.35 TB/s, against 1.35 GFLOP, 1.4 us: bytes bound, 0.0084 ms;
//   * zamba2's shared attention (1 row, S 512, H = Hkv = 32, D 80): 10.6 MB,
//     3.1 us, against 1.35 GFLOP, 1.4 us: bytes bound, 0.0031 ms;
//   * long (2 rows, S 4096, H 16, Hkv 8, D 128): 137.5 GFLOP, 0.139 ms,
//     against 100.7 MB, 0.030 ms: operations bound, 0.139 ms;
//   * gemma3-4b's prefill (1 row, S 1900, H 8, Hkv 4, D 256): 14.8 GFLOP,
//     0.0150 ms, against 23.4 MB, 0.0070 ms: operations bound, 0.0150 ms
//     (a 1024 window: 11.6 GFLOP, 0.0117 ms);
//   * deepseek-v2's MLA prefill (1 row, S 512, H = Hkv = 128, D 192, Dv
//     128; 2 B H (D + Dv) S (S + 1) / 2 operations): 83.9 MB, 0.0250 ms,
//     against 10.8 GFLOP, 0.0109 ms: bytes bound, 0.0250 ms.
//
// The bf16 path (every served and trained model's) has two kernels, picked
// by shape in launch_bf16:
//
// flash_fwd_bf16, mma.sync tiles (every D below S 1024, D != 128 above):
//   * one CTA of 4 warps per (query head, row, 64-row query tile); each
//     warp owns 16 query rows.  Its Q fragments load once into registers
//     (ldmatrix); S = Q K^T and P V run as mma.sync.m16n8k16 bf16 -> f32
//     fed by ldmatrix (V by ldmatrix.trans).  S (16 floats a thread per 32
//     keys) and the O accumulator (16 x D: 64 floats a thread at D 128)
//     stay in registers; O is rescaled there and written to device memory
//     once, at the end.  Nothing of S, P or O goes through shared memory;
//   * P is rounded to bf16 in registers and used directly as the A operand
//     of P V: the accumulator layout of m16n8k16 is its A-fragment layout
//     (P rounds to bf16 before the second product, as the JAX direct path
//     casts its weights to v's dtype);
//   * K/V tiles are staged by 16-byte cp.async (cg, zero-filled past S)
//     into a 2-stage ring with rows padded by 16 bytes, which keeps
//     ldmatrix free of bank conflicts at every D that is a multiple of 16.
//     Tile t + 1 is in flight while tile t computes; one barrier per tile;
//   * 32-key tiles below S 256 (a short sequence's CTAs walk few tiles:
//     smaller ones waste less of the diagonal), 64-key tiles above.
//   Occupancy (nvcc -Xptxas -v): D 128 at 32-key tiles (the training
//   shape) 52 KB and 167 registers, D 80 at 64-key tiles (zamba2) 55 KB
//   and 168 registers: 3 CTAs, 12 warps, per SM, set by the registers.
//   D 192 / Dv 128 (deepseek-v2's MLA): K tiles 192 columns wide and V
//   tiles 128, each in its own padded ring; O is Dv wide (64 floats a
//   lane, as at D 128), S as at D 128, and Q's 12 fragments (48 registers
//   a lane) stay in shared memory as at D 256, loaded where each is used.
//   Zero-padding V to 192 would read 1.5x its bytes and write a 192-wide
//   output; this instance reads and writes each once at its own width.
//   nvcc -Xptxas -v: 218 registers at 64-key tiles (S >= 256) and 163 at
//   32-key ones, no spill; 111,616 and 68,608 bytes of shared memory: 2
//   CTAs per SM at 64-key tiles (registers and shared memory alike), 3 at
//   32.  Its float32 path (16 query rows a warp, Dv 128): 164 registers,
//   206,848 bytes, one CTA per SM.
//   D 256 (gemma3-4b): the O accumulator of a warp's 16 rows is 128 floats
//   a lane, and Q's fragments would be 64 registers more; so at D 256 Q
//   stays in shared memory and each 16-column step's fragment is loaded
//   (ldmatrix) where it is used, and the key tiles are 32 wide at every S
//   (S: 16 floats a lane).  99 KB of shared memory (Q, a 2-stage ring of
//   32-key K/V tiles): 2 CTAs per SM.
//
// flash_fwd_wgmma, warpgroup MMA (D 128 from S 1024):
//   * one CTA of 2 warpgroups per (query head, row, 128-row query tile),
//     each warpgroup 64 rows; Q and 64-key K/V tiles in shared memory in
//     the 128-byte-swizzled layout wgmma reads (two 64-column halves);
//   * S = Q K^T as 8 wgmma.m64n64k16 with both operands in shared memory;
//     P V as 4 wgmma.m64n128k16 with P from registers (the accumulator
//     layout of S is the A-fragment layout again) and V read MN-major;
//   * the same 2-stage cp.async ring and one barrier per tile, and a
//     fence.proxy.async before wgmma reads what cp.async wrote;
//   * 128 registers a thread (the launch bound asks for 2 CTAs per SM) and
//     97 KB of shared memory: 2 CTAs, 4 warpgroups, per SM.
//
// Common to both:
//   * the online softmax runs in registers: a row's max reduces over the 4
//     lanes that share it in 2 shuffles, its sum stays a per-lane partial
//     until the end; the max is over raw scores and scale * log2(e) enters
//     through the FFMA before each ex2.approx.ftz; O is rescaled only when
//     a row's max moved; the mask arithmetic runs only on tiles that
//     straddle the diagonal, the window's edge or S;
//   * the CTA walks key tiles from the first inside the window of its
//     first row to the last at or below the diagonal of its last row, and
//     a warp (warpgroup) skips the arithmetic of a tile wholly masked for
//     its rows; q, k, v and the output are read and written in their
//     (B, S, H, D) layouts through strides;
//   * the grid's slowest axis is the query tile, longest tiles first, so
//     the last wave holds the short ones.
//
// The float32 path (chip_smoke's float32 prefill-vs-decode runs) is a
// scalar full-float32 FMA path with its tiles in shared memory; it is a
// check of numbers, not a timing target.  At D 256 its CTA takes 32 query
// rows (8 a warp) instead of 64, so that Q, K, V and O fit in 220 KB.
//
// Later work: warp specialisation (a producer warp or TMA, consumer
// warpgroups that overlap one tile's softmax with another's products),
// which the card needs to go past about 40 % of its bf16 rate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxD = 256;            // gemma3-4b's; below it D <= kSmallD
constexpr int kSmallD = 128;
constexpr int kMlaD = 192, kMlaDv = 128;  // deepseek-v2's MLA prefill
constexpr float kNegInf = -1.0e30f;   // log-sum-exp of a row with no key
constexpr int kShortS = 256;          // below: 32-key mma.sync tiles
constexpr int kLongS = 1024;          // from here on at D 128: wgmma

struct Args {
  const void* q;   // (B, S, H, D)
  const void* k;   // (B, S, Hkv, D)
  const void* v;   // (B, S, Hkv, Dv)
  void* out;       // (B, S, H, Dv), q's dtype
  float* lse;      // (B, H, S) contiguous
  long long q_sb, q_ss, q_sh;  // element strides (batch, position, head)
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int S, H, Hkv, D, Dv;
  int causal, window;
  float scale;
};

// ---------------------------------------------------------------------------
// bf16: register-resident mma.sync tiles over a cp.async K/V ring
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; zeros when !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c[16 x 8] += a[16 x 16] b[16 x 8], bf16 in, float32 accumulate
__device__ __forceinline__ void mma16816(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x as one MUFU.EX2 (ex2(-inf) = 0); no denormal fix-up
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// two floats as a bf16x2 register, lo in the low half (round to nearest
// even, as torch's cast)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// One online-softmax step over a key tile held as m16n8 accumulator
// blocks: s[j][e] is key 8 j + 2 tig + (e & 1) of row row0 + 8 (e >> 1),
// the layout of mma.sync's and wgmma's accumulators.  Masks the tile when
// `masked` (keys at or past S, above the diagonal, before the window),
// updates each row's max m (over raw scores) and this lane's partial sum l,
// turns s into p = 2^(s scale log2(e) - m scale log2(e)) with the scale
// folded into the FFMA, and sets corr to the factor O must be scaled by.
// Returns whether a max moved.
template <int kNB>
__device__ __forceinline__ bool softmax_tile(
    float (&s)[kNB][4], float (&m)[2], float (&l)[2], float (&corr)[2],
    bool masked, int t0, int row0, int tig, int S, int causal, int window,
    float sl2) {
  bool moved = false;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 8 * hh;
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kNB; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (masked) {
          const int key = t0 + 8 * j + 2 * tig + e;
          const bool ok = key < S && (!causal || (key <= row &&
                                                  row - key < window));
          if (!ok) s[j][2 * hh + e] = -INFINITY;
        }
        mx = fmaxf(mx, s[j][2 * hh + e]);
      }
    // the 4 lanes of a quad share a row
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[hh], mx);
    const float m_sc = (m_new == -INFINITY ? 0.f : m_new) * sl2;
    corr[hh] = ex2(fmaf(m[hh], sl2, -m_sc));
    moved |= m_new != m[hh];
    m[hh] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kNB; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = ex2(fmaf(s[j][2 * hh + e], sl2, -m_sc));
        s[j][2 * hh + e] = p;
        sum += p;
      }
    l[hh] = l[hh] * corr[hh] + sum;
  }
  return moved;
}

// P of 16 keys (accumulator blocks a and b) as an m16n8k16 A fragment in
// bf16: the accumulator layout is the A-fragment layout
__device__ __forceinline__ void p_fragment(const float (&a)[4],
                                           const float (&b)[4],
                                           uint32_t (&pa)[4]) {
  pa[0] = pack_bf16(a[0], a[1]);
  pa[1] = pack_bf16(a[2], a[3]);
  pa[2] = pack_bf16(b[0], b[1]);
  pa[3] = pack_bf16(b[2], b[3]);
}

// Normalises and stores this lane's two rows (row0, row0 + 8) of O,
// o[j][e] as in softmax_tile, and their log-sum-exp (B, H, S).
template <int kDB>
__device__ __forceinline__ void store_rows(const Args& a, int b, int h,
                                           const float (&o)[kDB][4],
                                           const float (&m)[2],
                                           const float (&l)[2], int row0,
                                           int tig) {
  bf16* out = static_cast<bf16*>(a.out) + b * a.o_sb + h * a.o_sh;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float sum = l[hh];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int row = row0 + 8 * hh;
    if (row >= a.S) continue;
    const float inv = sum > 0.f ? 1.f / sum : 0.f;
    bf16* orow = out + row * a.o_ss + 2 * tig;
#pragma unroll
    for (int j = 0; j < kDB; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(o[j][2 * hh] * inv, o[j][2 * hh + 1] * inv);
    if (tig == 0)
      a.lse[((long long)b * a.H + h) * a.S + row] =
          sum > 0.f ? m[hh] * a.scale + logf(sum) : kNegInf;
  }
}

template <int D, int DV, int kBk_>
struct Tile {
  static constexpr int kThreads = 128;  // 4 warps of 16 query rows
  static constexpr int kBq = 64;        // query rows per CTA
  static constexpr int kBk = kBk_;      // keys per K/V tile
  static constexpr int kLd = D + 8;     // padded Q/K row, elements
  static constexpr int kLdV = DV + 8;   // padded V row, elements
  static constexpr int kQElems = kBq * kLd;
  static constexpr int kKElems = kBk * kLd;
  static constexpr int kVElems = kBk * kLdV;
  static constexpr int kStage = kKElems + kVElems;  // K, then V
  static constexpr size_t kSmem =             // Q and a 2-stage K/V ring
      (size_t)(kQElems + 2 * kStage) * sizeof(bf16);
};

// Rows [pos0, pos0 + kRows) of one head into a padded shared tile by
// 16-byte cp.async; rows at or past S are zero-filled (from row 0's
// address, which always exists).
template <int D, int kRows, int kThreads>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src,
                                           long long ss, int pos0, int S,
                                           int tid) {
  constexpr int kVpr = D / 8;  // 16-byte vectors per row
  constexpr int kVecs = kRows * kVpr;
  const uint32_t base = smem_u32(dst);
#pragma unroll
  for (int n = 0; n < (kVecs + kThreads - 1) / kThreads; ++n) {
    const int i = tid + n * kThreads;
    if (kVecs % kThreads != 0 && i >= kVecs) break;
    const int r = i / kVpr, c = i - (i / kVpr) * kVpr;
    const int pos = pos0 + r;
    const bool ok = pos < S;
    const bf16* g = src + (ok ? (long long)pos * ss : 0LL) + c * 8;
    cp_async16(base + (uint32_t)((r * (D + 8) + c * 8) * sizeof(bf16)), g,
               ok);
  }
}

template <int D, int DV, int kBk_>
__global__ void __launch_bounds__(Tile<D, DV, kBk_>::kThreads)
    flash_fwd_bf16(Args a) {
  using T = Tile<D, DV, kBk_>;
  constexpr int kBk = T::kBk, kLd = T::kLd, kLdV = T::kLdV;
  constexpr int kThreads = T::kThreads;
  constexpr int kKS = D / 16;    // 16-column steps of Q K^T
  constexpr int kNB = kBk / 8;   // 8-key blocks of S
  constexpr int kDB = DV / 8;    // 8-column blocks of O
  // Q's fragments stay in registers up to D 128; above it (D 192: 48
  // registers beside O's 64 and S's 32; D 256: 64 beside O's 128) each is
  // loaded where it is used
  constexpr bool kQReg = D <= kSmallD;
  constexpr float kLog2e = 1.4426950408889634f;

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ring = qs + T::kQElems;  // stage s: K at s kStage, V after it

  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;  // longest query tiles first
  const int hk = h / (a.H / a.Hkv);
  const int S = a.S, causal = a.causal, window = a.window;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int q0 = qt * T::kBq;
  const bf16* qg = static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const bf16* kg = static_cast<const bf16*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const bf16* vg = static_cast<const bf16*>(a.v) + b * a.v_sb + hk * a.v_sh;

  // key tiles: from the first inside the window of the tile's first row to
  // the last at or below the diagonal of its last row
  const int q_last = min(q0 + T::kBq, S) - 1;
  const int k_end = causal ? q_last + 1 : S;
  const int k_lo = causal ? max(q0 - window + 1, 0) : 0;
  const int t_first = k_lo / kBk;
  const int n_tiles = (k_end + kBk - 1) / kBk - t_first;

  stage_rows<D, T::kBq, kThreads>(qs, qg, a.q_ss, q0, S, tid);
  stage_rows<D, kBk, kThreads>(ring, kg, a.k_ss, t_first * kBk, S, tid);
  stage_rows<DV, kBk, kThreads>(ring + T::kKElems, vg, a.v_ss,
                                t_first * kBk, S, tid);
  cp_async_commit();

  // this warp's rows [wf, wl]; this lane's rows wf + g and wf + g + 8
  const int wf = q0 + warp * 16;
  const int wl = min(wf + 16, S) - 1;
  const float sl2 = a.scale * kLog2e;

  // per-lane ldmatrix offsets, in elements: A fragments and V (.trans)
  // take row (lane & 7) + 8 ((lane >> 3) & 1), column 8 (lane >> 4); K (a
  // col-major B operand) row (lane & 7) + 8 (lane >> 4), column
  // 8 ((lane >> 3) & 1); V's rows are kLdV apart
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_off = a_row * kLd + (lane >> 4) * 8;
  const int v_off = a_row * kLdV + (lane >> 4) * 8;
  const int k_off = ((lane & 7) + (lane >> 4) * 8) * kLd +
                    ((lane >> 3) & 1) * 8;

  uint32_t qf[kKS][4];  // this warp's Q fragments (kQReg: loaded once)
  const uint32_t q_warp = smem_u32(qs + warp * 16 * kLd + a_off);
  float o[kDB][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < kDB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = (t_first + it) * kBk;
    cp_async_wait_all();
    __syncthreads();  // tile it landed; every warp is done with tile it - 1
    if (it + 1 < n_tiles) {
      bf16* nk = ring + ((it + 1) & 1) * T::kStage;
      stage_rows<D, kBk, kThreads>(nk, kg, a.k_ss, t0 + kBk, S, tid);
      stage_rows<DV, kBk, kThreads>(nk + T::kKElems, vg, a.v_ss, t0 + kBk,
                                    S, tid);
    }
    cp_async_commit();
    if (kQReg && it == 0) {
#pragma unroll
      for (int ks = 0; ks < kKS; ++ks)
        ldsm_x4(q_warp + ks * 16 * sizeof(bf16), qf[ks]);
    }
    // a tile wholly above the diagonal or before the window for every row
    // of this warp changes nothing: skip its arithmetic
    if (wf >= S || (causal && (t0 > wl || t0 + kBk - 1 <= wf - window)))
      continue;
    const bf16* kt = ring + (it & 1) * T::kStage;
    const uint32_t k_base = smem_u32(kt + k_off);
    const uint32_t v_base = smem_u32(kt + T::kKElems + v_off);

    // S = Q K^T
    float s[kNB][4];
#pragma unroll
    for (int j = 0; j < kNB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks) {
      if (!kQReg) ldsm_x4(q_warp + ks * 16 * sizeof(bf16), qf[ks]);
#pragma unroll
      for (int n2 = 0; n2 < kNB / 2; ++n2) {
        uint32_t bk[4];
        ldsm_x4(k_base + (n2 * 16 * kLd + ks * 16) * sizeof(bf16), bk);
        mma16816(s[2 * n2], qf[ks], bk[0], bk[1]);
        mma16816(s[2 * n2 + 1], qf[ks], bk[2], bk[3]);
      }
    }

    // online softmax in registers; O is rescaled only when a row's max
    // moved
    const bool masked = t0 + kBk > S ||
                        (causal && (t0 + kBk - 1 > wf || wl - t0 >= window));
    float corr[2];
    if (__any_sync(0xffffffffu,
                   softmax_tile(s, m, l, corr, masked, t0, wf + g, tig, S,
                                causal, window, sl2))) {
#pragma unroll
      for (int j = 0; j < kDB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[j][e] *= corr[e >> 1];
    }

    // O += P V, P from the S registers as bf16 A fragments
#pragma unroll
    for (int kk = 0; kk < kBk / 16; ++kk) {
      uint32_t pa[4];
      p_fragment(s[2 * kk], s[2 * kk + 1], pa);
#pragma unroll
      for (int d2 = 0; d2 < DV / 16; ++d2) {
        uint32_t bv[4];
        ldsm_x4_trans(v_base + (kk * 16 * kLdV + d2 * 16) * sizeof(bf16),
                      bv);
        mma16816(o[2 * d2], pa, bv[0], bv[1]);
        mma16816(o[2 * d2 + 1], pa, bv[2], bv[3]);
      }
    }
  }

  store_rows(a, b, h, o, m, l, wf + g, tig);
}

template <int D, int DV, int kBk>
int run_bf16(const Args& a, int B, cudaStream_t stream) {
  using T = Tile<D, DV, kBk>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16<D, DV, kBk>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(T::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.H, B, (a.S + T::kBq - 1) / T::kBq);
  flash_fwd_bf16<D, DV, kBk><<<grid, T::kThreads, T::kSmem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16 at D 128 and long S: warpgroup MMA (wgmma) on 128-byte-swizzled tiles
// ---------------------------------------------------------------------------
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// makes this thread's finished cp.async writes visible to wgmma's reads
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// orders later reads of wgmma's accumulators after its wait
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// shared-memory matrix descriptor with the 128-byte swizzle: start address,
// leading and stride byte offsets, each in 16-byte units
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// d[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 128] += A[64 x 16] B[16 x 128], A from registers, B MN-major in
// shared memory
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Tiles are stored as two 64-column halves of [rows x 128 B]; 16-byte chunk
// c of row r sits at chunk c ^ (r & 7) of its row, the 128-byte swizzle
// wgmma reads.  The CTA is kGroups warpgroups of 64 query rows each.
struct Wg {
  static constexpr int D = 128;
  static constexpr int kGroups = 2;
  static constexpr int kThreads = 128 * kGroups;
  static constexpr int kBq = 64 * kGroups;
  static constexpr int kBk = 64;
  static constexpr uint32_t kQBytes = kBq * D * 2;
  static constexpr uint32_t kKVBytes = kBk * D * 2;  // one of K, V
  static constexpr uint32_t kSmem = kQBytes + 2 * 2 * kKVBytes + 1024;
};

// Rows [pos0, pos0 + kRows) of one head (D 128) into a swizzled tile at
// shared address dst by 16-byte cp.async; rows at or past S zero-filled.
template <int kRows, int kThreads>
__device__ __forceinline__ void stage_sw128(uint32_t dst, const bf16* src,
                                            long long ss, int pos0, int S,
                                            int tid) {
  static_assert(kRows * 16 % kThreads == 0, "whole passes");
#pragma unroll
  for (int n = 0; n < kRows * 16 / kThreads; ++n) {
    const int i = tid + n * kThreads;
    const int r = i >> 4, c = i & 15;
    const int pos = pos0 + r;
    const bool ok = pos < S;
    const bf16* g = src + (ok ? (long long)pos * ss : 0LL) + c * 8;
    cp_async16(dst + (c >> 3) * (kRows * 128) + r * 128 +
                   (((c & 7) ^ (r & 7)) << 4),
               g, ok);
  }
}

__global__ void __launch_bounds__(Wg::kThreads, 2) flash_fwd_wgmma(Args a) {
  constexpr int D = Wg::D, kBk = Wg::kBk, kNB = kBk / 8, kDB = D / 8;
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t qs = (smem_u32(smem) + 1023u) & ~1023u;
  const uint32_t ring = qs + Wg::kQBytes;  // stage s: K, then V

  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;  // longest query tiles first
  const int hk = h / (a.H / a.Hkv);
  const int S = a.S, causal = a.causal, window = a.window;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int q0 = qt * Wg::kBq;
  const bf16* qg = static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const bf16* kg = static_cast<const bf16*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const bf16* vg = static_cast<const bf16*>(a.v) + b * a.v_sb + hk * a.v_sh;

  const int q_last = min(q0 + Wg::kBq, S) - 1;
  const int k_end = causal ? q_last + 1 : S;
  const int k_lo = causal ? max(q0 - window + 1, 0) : 0;
  const int t_first = k_lo / kBk;
  const int n_tiles = (k_end + kBk - 1) / kBk - t_first;

  stage_sw128<Wg::kBq, Wg::kThreads>(qs, qg, a.q_ss, q0, S, tid);
  stage_sw128<kBk, Wg::kThreads>(ring, kg, a.k_ss, t_first * kBk, S, tid);
  stage_sw128<kBk, Wg::kThreads>(ring + Wg::kKVBytes, vg, a.v_ss,
                                 t_first * kBk, S, tid);
  cp_async_commit();

  // this warpgroup's rows [gf, gl]; this thread's rows r0 and r0 + 8
  const int gf = q0 + (warp >> 2) * 64;
  const int gl = min(gf + 64, S) - 1;
  const int r0 = gf + (warp & 3) * 16 + g;
  const float sl2 = a.scale * kLog2e;
  const uint64_t dq = sw128_desc(qs + (warp >> 2) * 64 * 128, 16, 1024);

  // accumulators as m16n8 blocks (softmax_tile's layout), and the flat
  // register lists wgmma's operands take
  float o[kDB][4];
  float s[kNB][4];
  auto& o_regs = reinterpret_cast<float(&)[kDB * 4]>(o);
  auto& s_regs = reinterpret_cast<float(&)[kNB * 4]>(s);
#pragma unroll
  for (int i = 0; i < kDB * 4; ++i) o_regs[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = (t_first + it) * kBk;
    cp_async_wait_all();
    fence_async_shared();
    __syncthreads();  // tile it landed; every group is done with tile it - 1
    if (it + 1 < n_tiles) {
      const uint32_t nk = ring + ((it + 1) & 1) * 2 * Wg::kKVBytes;
      stage_sw128<kBk, Wg::kThreads>(nk, kg, a.k_ss, t0 + kBk, S, tid);
      stage_sw128<kBk, Wg::kThreads>(nk + Wg::kKVBytes, vg, a.v_ss,
                                     t0 + kBk, S, tid);
    }
    cp_async_commit();
    if (gf >= S || (causal && (t0 > gl || t0 + kBk - 1 <= gf - window)))
      continue;
    const uint32_t kt = ring + (it & 1) * 2 * Wg::kKVBytes;
    const uint32_t vt = kt + Wg::kKVBytes;

    // S = Q K^T over 8 steps of 16 columns of D
#pragma unroll
    for (int i = 0; i < kNB * 4; ++i) s_regs[i] = 0.f;
    // (a descriptor's address field is in 16-byte units: a step of 16
    // columns is 32 bytes inside a row, or the next 64-column half)
    const uint64_t dk = sw128_desc(kt, 16, 1024);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const uint32_t off = (ks & 3) * 2;
      wgmma_ss_n64(s_regs, dq + (ks >> 2) * (Wg::kBq * 128 / 16) + off,
                   dk + (ks >> 2) * (kBk * 128 / 16) + off, ks > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(s_regs);

    // online softmax in registers, as in flash_fwd_bf16
    const bool masked = t0 + kBk > S ||
                        (causal && (t0 + kBk - 1 > gf || gl - t0 >= window));
    float corr[2];
    if (__any_sync(0xffffffffu,
                   softmax_tile(s, m, l, corr, masked, t0, r0, tig, S, causal,
                                window, sl2))) {
#pragma unroll
      for (int j = 0; j < kDB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[j][e] *= corr[e >> 1];
    }

    // O += P V: P from the S registers as bf16 A fragments, V read
    // MN-major (its two 64-column halves lbo apart, 8-key groups sbo apart)
    uint32_t pa[kBk / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBk / 16; ++kk)
      p_fragment(s[2 * kk], s[2 * kk + 1], pa[kk]);
    const uint64_t dv = sw128_desc(vt, kBk * 128, 1024);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBk / 16; ++kk)
      wgmma_rs_n128(o_regs, pa[kk], dv + kk * (16 * 128 / 16));
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(o_regs);
  }

  store_rows(a, b, h, o, m, l, r0, tig);
}

int run_wgmma(const Args& a, int B, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Wg::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.H, B, (a.S + Wg::kBq - 1) / Wg::kBq);
  flash_fwd_wgmma<<<grid, Wg::kThreads, Wg::kSmem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 path by shape: warpgroup MMA at D = Dv = 128 from S kLongS on;
// otherwise mma.sync tiles, with 32-key tiles below S kShortS (a short
// sequence's CTAs walk few tiles: smaller ones waste less of the diagonal
// and fit more CTAs on an SM) and 64-key tiles above (D 192 / Dv 128 too:
// its O and S take the registers D 128's do); at D 256 32-key tiles at
// every S (the registers).
template <int D, int DV = D>
int launch_bf16(const Args& a, int B, cudaStream_t stream) {
  if constexpr (D == kMaxD) {
    return run_bf16<D, DV, 32>(a, B, stream);
  } else {
    if (D == 128 && DV == 128 && a.S >= kLongS) return run_wgmma(a, B, stream);
    return a.S < kShortS ? run_bf16<D, DV, 32>(a, B, stream)
                         : run_bf16<D, DV, 64>(a, B, stream);
  }
}

// ---------------------------------------------------------------------------
// float32: scalar FMAs in full float32, tiles in shared memory
// ---------------------------------------------------------------------------
constexpr int kF32Threads = 128;
constexpr int kF32Bk = 64;                           // keys per tile
constexpr int kF32LdS = kF32Bk + 4;
constexpr int kF32LdP = kF32Bk + 8;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Shared-memory layout of one CTA of Bq query rows, in bytes.
struct SmemF32 {
  int ld, ldv, ldo;                  // Q/K, V and output row strides
  size_t q, k, v, s, p, o, total;    // offsets
  __host__ __device__ SmemF32(int D, int Dv, int Bq) {
    ld = D + 8;
    ldv = Dv + 8;
    ldo = Dv + 4;
    q = 0;
    k = q + (size_t)Bq * ld * sizeof(float);
    v = k + (size_t)kF32Bk * ld * sizeof(float);
    s = v + (size_t)kF32Bk * ldv * sizeof(float);
    p = s + (size_t)Bq * kF32LdS * sizeof(float);
    o = p + (size_t)Bq * kF32LdP * sizeof(float);
    total = o + (size_t)Bq * ldo * sizeof(float);
  }
};

// Rows [pos0, pos0 + rows) of one head into a padded shared tile (rows at or
// past S are zeros), 16-byte loads.
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              long long ss, int ld, int pos0,
                                              int nvalid, int rows, int D,
                                              int tid) {
  const int vpr = D / 4;
  for (int i = tid; i < rows * vpr; i += kF32Threads) {
    const int row = i / vpr, c = i - (i / vpr) * vpr;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < nvalid)
      x = __ldg(reinterpret_cast<const float4*>(
                    src + (long long)(pos0 + row) * ss) + c);
    reinterpret_cast<float4*>(dst + row * ld)[c] = x;
  }
}

// ROWS query rows a warp (16; 8 at Dv 256, for the shared memory); COLS
// output columns a lane (Dv up to 32 COLS)
template <int ROWS, int COLS>
__global__ void __launch_bounds__(kF32Threads) flash_fwd_f32(Args a) {
  constexpr int kF32Rows = ROWS;
  constexpr int kF32Bq = kF32Threads / 32 * ROWS;  // query rows per CTA
  extern __shared__ __align__(128) unsigned char smem[];
  const SmemF32 L(a.D, a.Dv, kF32Bq);
  float* qs = reinterpret_cast<float*>(smem + L.q);
  float* ks = reinterpret_cast<float*>(smem + L.k);
  float* vs = reinterpret_cast<float*>(smem + L.v);
  float* ss = reinterpret_cast<float*>(smem + L.s);
  float* ps = reinterpret_cast<float*>(smem + L.p);
  float* os = reinterpret_cast<float*>(smem + L.o);

  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;  // longest query tiles first
  const int hk = h / (a.H / a.Hkv);
  const int S = a.S, D = a.D, Dv = a.Dv, ld = L.ld, ldv = L.ldv,
            ldo = L.ldo;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = qt * kF32Bq;
  const float* qg = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* kg = static_cast<const float*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const float* vg = static_cast<const float*>(a.v) + b * a.v_sb + hk * a.v_sh;

  load_tile_f32(qs, qg, a.q_ss, ld, q0, S - q0, kF32Bq, D, tid);
  for (int i = tid; i < kF32Bq * ldo; i += kF32Threads) os[i] = 0.f;

  // this warp's rows
  const float* qw = qs + warp * kF32Rows * ld;
  float* sw = ss + warp * kF32Rows * kF32LdS;
  float* pw = ps + warp * kF32Rows * kF32LdP;
  float* ow = os + warp * kF32Rows * ldo;
  float m_r[kF32Rows], l_r[kF32Rows];
#pragma unroll
  for (int r = 0; r < kF32Rows; ++r) {
    m_r[r] = kNegInf;
    l_r[r] = 0.f;
  }

  const int q_last = min(q0 + kF32Bq, S) - 1;
  const int k_end = a.causal ? q_last + 1 : S;
  int k_begin = 0;
  if (a.causal && q0 - a.window + 1 > 0) k_begin = q0 - a.window + 1;
  for (int t0 = (k_begin / kF32Bk) * kF32Bk; t0 < k_end; t0 += kF32Bk) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile_f32(ks, kg, a.k_ss, ld, t0, S - t0, kF32Bk, D, tid);
    load_tile_f32(vs, vg, a.v_ss, ldv, t0, S - t0, kF32Bk, Dv, tid);
    __syncthreads();

    // S[16 x 64] = Q K^T for the warp's rows; lane l holds keys l, l + 32
    {
      float acc[kF32Rows][2];
#pragma unroll
      for (int r = 0; r < kF32Rows; ++r) acc[r][0] = acc[r][1] = 0.f;
      for (int d = 0; d < D; ++d) {
        const float k0 = ks[lane * ld + d], k1 = ks[(lane + 32) * ld + d];
#pragma unroll
        for (int r = 0; r < kF32Rows; ++r) {
          const float qv = qw[r * ld + d];
          acc[r][0] = fmaf(qv, k0, acc[r][0]);
          acc[r][1] = fmaf(qv, k1, acc[r][1]);
        }
      }
#pragma unroll
      for (int r = 0; r < kF32Rows; ++r) {
        sw[r * kF32LdS + lane] = acc[r][0];
        sw[r * kF32LdS + lane + 32] = acc[r][1];
      }
    }
    __syncwarp();

    // online softmax over the tile, one row at a time across the warp
#pragma unroll
    for (int r = 0; r < kF32Rows; ++r) {
      const int qpos = q0 + warp * kF32Rows + r;
      const int kp0 = t0 + lane, kp1 = kp0 + 32;
      const bool ok0 = kp0 < S && (!a.causal ||
                                   (kp0 <= qpos && qpos - kp0 < a.window));
      const bool ok1 = kp1 < S && (!a.causal ||
                                   (kp1 <= qpos && qpos - kp1 < a.window));
      const float s0 = sw[r * kF32LdS + lane] * a.scale;
      const float s1 = sw[r * kF32LdS + lane + 32] * a.scale;
      const float mx = warp_max(fmaxf(ok0 ? s0 : kNegInf, ok1 ? s1 : kNegInf));
      const float m_new = fmaxf(m_r[r], mx);
      const float p0 = ok0 ? expf(s0 - m_new) : 0.f;
      const float p1 = ok1 ? expf(s1 - m_new) : 0.f;
      const float corr = expf(m_r[r] - m_new);
      l_r[r] = l_r[r] * corr + warp_sum(p0 + p1);
      m_r[r] = m_new;
      pw[r * kF32LdP + lane] = p0;
      pw[r * kF32LdP + lane + 32] = p1;
      for (int d = lane; d < Dv; d += 32) ow[r * ldo + d] *= corr;
    }
    __syncwarp();

    // O[16 x Dv] += P V; lane l holds output columns l + 32 j
    {
      constexpr int kCols = COLS;
      float acc[kF32Rows][kCols];
#pragma unroll
      for (int r = 0; r < kF32Rows; ++r)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const int d = lane + 32 * j;
          acc[r][j] = d < Dv ? ow[r * ldo + d] : 0.f;
        }
      for (int c = 0; c < kF32Bk; ++c) {
        float vv[kCols];
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const int d = lane + 32 * j;
          vv[j] = d < Dv ? vs[c * ldv + d] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < kF32Rows; ++r) {
          const float p = pw[r * kF32LdP + c];
#pragma unroll
          for (int j = 0; j < kCols; ++j) acc[r][j] = fmaf(p, vv[j], acc[r][j]);
        }
      }
#pragma unroll
      for (int r = 0; r < kF32Rows; ++r)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const int d = lane + 32 * j;
          if (d < Dv) ow[r * ldo + d] = acc[r][j];
        }
    }
    __syncwarp();
  }

  // normalise and store the warp's rows; the log-sum-exp beside them
  float* out = static_cast<float*>(a.out) + b * a.o_sb + h * a.o_sh;
#pragma unroll
  for (int r = 0; r < kF32Rows; ++r) {
    const int qpos = q0 + warp * kF32Rows + r;
    if (qpos >= S) break;
    const float inv = 1.f / fmaxf(l_r[r], 1e-30f);
    for (int d = lane; d < Dv; d += 32)
      out[qpos * a.o_ss + d] = ow[r * ldo + d] * inv;
    if (lane == 0)
      a.lse[((long long)b * a.H + h) * S + qpos] =
          l_r[r] > 0.f ? m_r[r] + logf(l_r[r]) : kNegInf;
  }
}

template <int ROWS, int COLS>
int run_f32(const Args& a, int B, cudaStream_t stream) {
  constexpr int kBq = kF32Threads / 32 * ROWS;
  const SmemF32 L(a.D, a.Dv, kBq);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32<ROWS, COLS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L.total));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.H, B, (a.S + kBq - 1) / kBq);
  flash_fwd_f32<ROWS, COLS><<<grid, kF32Threads, L.total, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// D 192 / Dv 128 at 16 rows a warp: 202 KB of shared memory
int launch_f32(const Args& a, int B, cudaStream_t stream) {
  return a.Dv > kSmallD ? run_f32<8, kMaxD / 32>(a, B, stream)
                        : run_f32<16, kSmallD / 32>(a, B, stream);
}

// dtype codes shared with the Python wrapper
enum { kF32 = 0, kBF16 = 1 };

}  // namespace

extern "C" {

int flash_attention_forward(
    const void* q, const void* k, const void* v, void* out, float* lse,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long o_sb, long long o_ss, long long o_sh, int B,
    int S, int H, int Hkv, int D, int Dv, int causal, int window,
    float scale, int dtype, void* stream) {
  // head dims: Dv = D, a multiple of 16 up to 128, or 256; or D 192, Dv 128
  const bool dims = Dv == D ? (D % 16 == 0 && D >= 16 &&
                               (D <= kSmallD || D == kMaxD))
                            : (D == kMlaD && Dv == kMlaDv);
  if (B < 1 || S < 1 || Hkv < 1 || H % Hkv || !dims || B > 65535 ||
      (S + 31) / 32 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q, k, v, out, lse, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
         v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, S, H, Hkv, D, Dv,
         causal, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return launch_f32(a, B, s);
  if (dtype != kBF16) return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 16: return launch_bf16<16>(a, B, s);
    case 32: return launch_bf16<32>(a, B, s);
    case 48: return launch_bf16<48>(a, B, s);
    case 64: return launch_bf16<64>(a, B, s);
    case 80: return launch_bf16<80>(a, B, s);
    case 96: return launch_bf16<96>(a, B, s);
    case 112: return launch_bf16<112>(a, B, s);
    case 128: return launch_bf16<128>(a, B, s);
    case kMlaD: return launch_bf16<kMlaD, kMlaDv>(a, B, s);
    default: return launch_bf16<256>(a, B, s);
  }
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
