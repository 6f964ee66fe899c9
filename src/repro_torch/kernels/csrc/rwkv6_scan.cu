// RWKV6 (Finch) chunked WKV scan for Hopper (sm_90a): chunk-parallel, on
// the tensor cores.
//
// Replaces the TPU kernel in src/repro/kernels/rwkv6_scan.py:
//   rwkv6_scan  (_rwkv_kernel at :22, wrapper at :70, pallas_call at :87)
//
// What it computes, per batch row b and head h, from a zero (Dk, Dv) state:
//   y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T),
//   S_t = diag(exp(log_w_t)) S_{t-1} + k_t v_t^T,
// for r, k, log_w (B, S, H, Dk), v (B, S, H, Dv) and u (H, Dk); y (B, S, H,
// Dv) in v's dtype and the final state (B, H, Dk, Dv) float32.
//
// The decomposition is the chunked form of models/linear_scan.py over
// 64-position chunks, with the chunks in parallel.  With cl the running sum
// of log_w inside a chunk and e_t = cl_{t-1} (0 at the chunk's start):
//   dS_c    = (k o exp(cl_last - cl))^T v       (the chunk's own state),
//   S_in,c+1 = diag(exp(cl_last,c)) S_in,c + dS_c,
//   y       = (r o exp(e)) S_in + A v,
//   A[t, s] = sum_d r_t k_s exp(e_t - cl_s) for s < t,
//   A[t, t] = sum_d r_t u k_t.
// Unlike the SSD scan (csrc/mamba2_scan.cu, whose structure this follows)
// the decay is a vector over Dk, so A is no product R K^T scaled by a
// matrix of scalars.  It is one inside a window of bounded decay: A is
// taken in 16-row sub-blocks, and below the diagonal sub-block (i, j), i >
// j, is the product R~_i K~_j^T with the reference b = cl at the last row
// of sub-block j, r~_t = r_t exp(e_t - b), k~_s = k_s exp(b - cl_s).  Both
// exponents are <= 0 (cl does not increase, and s <= 16 j + 15 <= t - 1),
// so nothing overflows, and a factor underflows only where the weight
// exp(e_t - cl_s), their product, is smaller still.  The four diagonal
// 16 x 16 sub-blocks take one exponential per (t, s < t, d) term on the CUDA
// cores, with the u diagonal: 480 of the chunk's 2016 terms per channel.
// exp(e_t - cl_s) is never factored into exp(e_t) * exp(-cl_s), which
// overflows at strong decays.
//
// Three launches on the caller's stream, the second and third started
// early (programmatic dependent launch) and waiting where they read what
// the launch before wrote:
//   1. wkv_states, one CTA of 8 warps per (chunk, h, b): every chunk's dS
//      and its decay exp(cl_last), to a float32 scratch;
//   2. wkv_pass, one thread per 4 state entries of a (b, h): walks the
//      chunks (8 elementwise steps at S 512) and writes S_in,c over dS_c in
//      place; the last state is the returned one;
//   3. wkv_output, one CTA of 8 warps per (chunk, h, b): A (warps 0-5 the
//      tiles below the diagonal inside the diagonal sub-blocks, warps 6-7
//      the tiles on it; then warps 2-7 one off-diagonal sub-block product
//      each) and r o exp(e), all before it waits for launch 2; then y, 16
//      rows by half the columns a warp.
// The running sum of log_w is taken by 4 (at Dk <= 64) or 2 threads a
// channel, each adding 16 or 32 rows in order, so inside a diagonal
// sub-block e_t - cl_s <= 0 holds exactly; across sub-blocks it holds up to
// the rounding of the partial sums, and those exponents are clamped at 0.
//
// Products on the tensor cores, mma.sync.m16n8k8 tf32 with float32 sums:
// R~ K~^T, A V, (r o exp(e)) S_in and K~^T V.  Their operands are float32
// (the decayed factors, A, S_in, v), so each is split into two tf32 parts,
// hi + lo, rounded to nearest (about 22 of float32's 24 bits), and a
// product takes three tf32 products, lo hi + hi lo + hi hi (3xTF32; two
// against bf16 v, exact in hi).  One part (11 bits) misses the 1e-3 the
// smoke holds y to many times over where the state carries across all
// chunks (the model's weak decays); 3xTF32 holds it with a margin: the
// CPU mirror in tests/test_torch_rwkv6_greedy_design.py shows both.  The
// tensor cores truncate when they add into an accumulator, so each 8-term
// block is summed from zero and the blocks are added in float32.
// Operands are kept in shared memory in float32 and split in registers as
// each fragment is loaded: two roundings and a subtraction, where the
// three-part bf16 split of the SSD scan takes several conversions and a
// packing, which every warp that shares a fragment would repeat.  Rows
// read along a fragment's rows are kD + 4 floats apart, rows read along
// its columns kD + 8, so neither read has bank conflicts.
//
// r, k, v, log_w and y are read and written in their (B, S, H, D) layouts
// through strides (16-byte loads where the rows allow, element loads
// otherwise): no moveaxis and no padding copy.  Positions past S read as
// zeros (log_w 0 and k 0 leave the state unchanged) and their y is not
// written; head dims below 64 (or between 64 and 128) are zero-padded.
//
// Bound on the H100, at the serving path's largest prefill (B 1, S 512, H
// 64, Dk = Dv = 64, r/k/v bf16): the inputs and outputs are about 26 MB,
// 7.8 us at 3.35 TB/s; the products, every tf32 product counted at the
// tf32 rate, are about 1.8 GFLOP (3.7 us) and the diagonal sub-blocks,
// exponentials and scalings on the CUDA cores about 0.1 GFLOP (1.5 us at
// the float32 rate): bytes bound (chip_smoke.py wkv_ops).
//
// Known limits, later work: launches 1 and 3 each run 512 CTAs two an SM
// (launch 3 holds 104 KB of shared memory; launch 1 ran no faster at four
// an SM), so each runs in two waves; a CTA loads its chunk, then computes
// in phases behind barriers with no load in flight, so the loads of a wave
// contend for the memory while its compute phases leave it idle.  The
// diagonal sub-blocks' exponentials keep the MUFU busy through most of
// A.  k, log_w and v are read by launches 1 and 3 both; dS and S_in go
// through the scratch.  Head dims up to 128; r, k, v all float32 or all
// bfloat16, log_w and u float32; log_w <= 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kC = 64;                 // positions per chunk
constexpr int kSub = 16;               // rows of A's sub-blocks
constexpr int kMaxD = 128;
constexpr int kThreads = 256;          // launches 1 and 3: 8 warps
constexpr int kPassThreads = 256;
constexpr int kLdA = kC + 4;           // row stride of A
constexpr float kLog2e = 1.4426950408889634f;

static_assert(kC == 4 * kSub, "four sub-blocks a chunk");

// whether an operand of this type is exact in one tf32 part (bf16: 8 of
// tf32's 11 significant bits), so its lo part is zero
template <typename T> struct ExactTf32 { static constexpr bool v = false; };
template <> struct ExactTf32<bf16> { static constexpr bool v = true; };

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float to_f32<bf16>(bf16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// e^x as one MUFU.EX2: ex2.approx.ftz of x log2(e), relative error about
// 2^-22.  Without -ftz, expf and __expf wrap each exponential in a denormal
// fix-up that serialises independent exponentials at the MUFU's latency.
// Results below 2^-126 flush to 0; the terms they scale are negligible
// beside the sums they join.
__device__ __forceinline__ float exp_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * kLog2e));
  return y;
}

// x = hi + lo, each rounded to tf32 (11 significant bits, to nearest):
// about 22 of float32's 24 bits
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

// c += a (16x8, row) * b (8x8, col), tf32 in, float32 sum
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc += A B over one 8-term block in 3xTF32: lo hi + hi lo + hi hi (lo
// lo, below 2^-22 of the product, dropped; no hi lo when B is exact in
// tf32), summed from zero on the tensor cores, the small terms first, and
// the block added here in float32 (the tensor cores truncate when they add
// into an accumulator)
template <bool kExactB>
__device__ __forceinline__ void mma_block(float (&acc)[4],
                                          const uint32_t (&af)[2][4],
                                          const uint32_t (&bf)[2][2]) {
  float part[4] = {0.f, 0.f, 0.f, 0.f};
  mma(part, af[1], bf[0][0], bf[0][1]);
  if (!kExactB) mma(part, af[0], bf[1][0], bf[1][1]);
  mma(part, af[0], bf[0][0], bf[0][1]);
#pragma unroll
  for (int x = 0; x < 4; ++x) acc[x] += part[x];
}

// the A fragment (rows t0 + g, t0 + g + 8; columns k0 + t4, k0 + t4 + 4)
// of a row-major float32 tile in shared memory, split hi / lo
__device__ __forceinline__ void a_frag(uint32_t (&af)[2][4], const float* m,
                                       int ld, int t0, int k0, int lane) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int reg = 0; reg < 4; ++reg)     // a0 (g, k), a1 (g+8, k), a2, a3 +4
    split_tf32(m[(t0 + g + 8 * (reg & 1)) * ld + k0 + t4 + 4 * (reg >> 1)],
               af[0][reg], af[1][reg]);
}

// the B fragment (rows k0 + t4, k0 + t4 + 4; column n0 + g) of a
// row-major (k, n) float32 tile in shared memory, split hi / lo
__device__ __forceinline__ void b_frag(uint32_t (&bf)[2][2], const float* m,
                                       int ld, int k0, int n0, int lane) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int reg = 0; reg < 2; ++reg)
    split_tf32(m[(k0 + t4 + 4 * reg) * ld + n0 + g], bf[0][reg], bf[1][reg]);
}

// 16 bytes global -> shared, zeros when !ok (src must stay valid)
__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// programmatic dependent launch: the next launch may start its CTAs now;
// wait until the launch before this one has finished and its writes show
__device__ __forceinline__ void let_next_launch_start() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void wait_for_previous_launch() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

struct Args {
  const void* r;       // (B, S, H, Dk)
  const void* k;       // (B, S, H, Dk)
  const void* v;       // (B, S, H, Dv)
  const float* lw;     // (B, S, H, Dk), <= 0
  const float* u;      // (H, Dk) contiguous
  void* y;             // (B, S, H, Dv), v's dtype
  float* state;        // (B, H, Dk, Dv) contiguous
  float* ds;           // (B, nC, H, D, D): dS_c, then S_in,c in place
  float* decay;        // (B, nC, H, D): exp(cl_last) of each chunk
  long long r_sb, r_ss, r_sh;  // element strides (batch, position, head)
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long w_sb, w_ss, w_sh;
  long long y_sb, y_ss, y_sh;
  int S, H, Dk, Dv, nC;
  int vec_rk, vec_v, vec_w;    // 16-byte loads allowed for r/k, v, log_w
  int vec_y;                   // two-column stores allowed for y
};

// ---------------------------------------------------------------------------
// Loads and the running sum, shared by launches 1 and 3
// ---------------------------------------------------------------------------

// rows [c0, c0 + 64) of one (b, h)'s (S, n) slice, row stride ss, columns
// [0, kD), as float32 rows ld apart: zeros past S and past n.  issue()
// only loads (16-byte loads: n a multiple of 16 bytes, rows aligned), so
// several slices' loads are in flight together; store() converts and
// writes them to shared memory.
template <int kD, typename T>
struct ChunkLoad {
  static constexpr int kEl = 16 / sizeof(T), kPer = kD / kEl;
  static constexpr int kIt = kC * kPer / kThreads;
  uint4 raw[kIt];

  __device__ __forceinline__ void issue(const T* src, long long ss,
                                        long long c0, int S, int n) {
    const int tid = threadIdx.x;
#pragma unroll
    for (int it = 0; it < kIt; ++it) {
      const int i = it * kThreads + tid, t = i / kPer, d = (i % kPer) * kEl;
      const bool ok = c0 + t < S && d < n;
      raw[it] = ok ? __ldg(reinterpret_cast<const uint4*>(
                         src + (c0 + t) * ss + d))
                   : make_uint4(0u, 0u, 0u, 0u);
    }
  }

  __device__ __forceinline__ void store(float* dst, int ld) const {
    const int tid = threadIdx.x;
#pragma unroll
    for (int it = 0; it < kIt; ++it) {
      const int i = it * kThreads + tid, t = i / kPer, d = (i % kPer) * kEl;
      float4* o = reinterpret_cast<float4*>(dst + t * ld + d);
      if constexpr (sizeof(T) == 4) {
        o[0] = *reinterpret_cast<const float4*>(&raw[it]);
      } else {
        const __nv_bfloat162* h =
            reinterpret_cast<const __nv_bfloat162*>(&raw[it]);
        const float2 f0 = __bfloat1622float2(h[0]),
                     f1 = __bfloat1622float2(h[1]),
                     f2 = __bfloat1622float2(h[2]),
                     f3 = __bfloat1622float2(h[3]);
        o[0] = make_float4(f0.x, f0.y, f1.x, f1.y);
        o[1] = make_float4(f2.x, f2.y, f3.x, f3.y);
      }
    }
  }
};

// the same with element loads, for rows the 16-byte loads cannot take
template <int kD, typename T>
__device__ __forceinline__ void load_elements(float* dst, int ld,
                                              const T* src, long long ss,
                                              long long c0, int S, int n) {
  constexpr int kIt = kC * kD / kThreads;
  const int tid = threadIdx.x;
  T raw[kIt];
#pragma unroll
  for (int it = 0; it < kIt; ++it) {
    const int i = it * kThreads + tid, t = i / kD, d = i % kD;
    const bool ok = c0 + t < S && d < n;
    raw[it] = ok ? src[(c0 + t) * ss + d] : from_f32<T>(0.f);
  }
#pragma unroll
  for (int it = 0; it < kIt; ++it) {
    const int i = it * kThreads + tid;
    dst[(i / kD) * ld + i % kD] = to_f32(raw[it]);
  }
}

// a chunk of this (b, h)'s k, log_w and v (and r when rs), as float32
// rows: k and log_w (and r) kL apart, v kLV apart.  With 16-byte loads
// for all of them every load is issued before the first store.
template <int kD, typename T>
__device__ __forceinline__ void load_chunk(const Args& a, int b, int h,
                                           long long c0, float* rs,
                                           float* ks, float* ws, float* vs,
                                           int kL, int kLV) {
  const T* r = static_cast<const T*>(a.r) + b * a.r_sb + h * a.r_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;
  const float* lw = a.lw + b * a.w_sb + h * a.w_sh;
  if (a.vec_rk && a.vec_w && a.vec_v) {
    ChunkLoad<kD, T> lr, lk, lv;
    ChunkLoad<kD, float> lws;
    if (rs) lr.issue(r, a.r_ss, c0, a.S, a.Dk);
    lk.issue(k, a.k_ss, c0, a.S, a.Dk);
    lws.issue(lw, a.w_ss, c0, a.S, a.Dk);
    lv.issue(v, a.v_ss, c0, a.S, a.Dv);
    if (rs) lr.store(rs, kL);
    lk.store(ks, kL);
    lws.store(ws, kL);
    lv.store(vs, kLV);
  } else {
    if (rs) load_elements<kD>(rs, kL, r, a.r_ss, c0, a.S, a.Dk);
    load_elements<kD>(ks, kL, k, a.k_ss, c0, a.S, a.Dk);
    load_elements<kD>(ws, kL, lw, a.w_ss, c0, a.S, a.Dk);
    load_elements<kD>(vs, kLV, v, a.v_ss, c0, a.S, a.Dv);
  }
}

// cl = the running sum of log_w over the chunk, in place in cs (rows ld
// apart), and, if es, e_t = cl_{t-1} (0 at t = 0).  Thread (q, d) adds
// rows q kRows .. q kRows + kRows - 1 of channel d in order, after the sums
// of the row groups before it; tot holds kThreads floats.  Ends behind a
// barrier.
template <int kD>
__device__ __forceinline__ void chunk_cumsum(float* cs, float* es, int ld,
                                             float* tot) {
  constexpr int kQ = kThreads / kD, kRows = kC / kQ;
  static_assert(kRows % kSub == 0, "a sub-block lies in one row group");
  const int tid = threadIdx.x, q = tid / kD, d = tid % kD;
  float* col = cs + q * kRows * ld + d;
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kRows; ++i) sum += col[i * ld];
  tot[q * kD + d] = sum;
  __syncthreads();
  float c = 0.f;
  for (int p = 0; p < q; ++p) c += tot[p * kD + d];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    c += col[i * ld];
    col[i * ld] = c;
  }
  __syncthreads();
  if (es) {
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int t = q * kRows + i;
      es[t * ld + d] = t ? cs[(t - 1) * ld + d] : 0.f;
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// Launch 1: each chunk's own state dS = K~^T V and its decay
// ---------------------------------------------------------------------------
template <int kD>
constexpr size_t states_smem() {
  return ((size_t)3 * kC * (kD + 8) + kThreads) * sizeof(float);
}

template <int kD, typename T>
__global__ void __launch_bounds__(kThreads, kD == 64 ? 2 : 1)
    wkv_states(const Args a) {
  constexpr int kL = kD + 8;             // every read here is along columns
  extern __shared__ __align__(16) float sm[];
  float* ks = sm;                        // (kC, kL): k, then k~
  float* cs = ks + kC * kL;              // (kC, kL): log_w, then cl
  float* vs = cs + kC * kL;              // (kC, kL): v
  float* tot = vs + kC * kL;

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const long long c0 = (long long)c * kC;
  let_next_launch_start();    // launch 2 waits for all of this one

  load_chunk<kD, T>(a, b, h, c0, nullptr, ks, cs, vs, kL, kL);
  __syncthreads();
  chunk_cumsum<kD>(cs, nullptr, kL, tot);

  // k~ = k exp(cl_last - cl) in place (the exponent clamped at 0 against
  // the rounding of the partial sums), and the chunk's decay
  const long long idx = ((long long)b * a.nC + c) * a.H + h;
#pragma unroll
  for (int i = tid; i < kC * kD; i += kThreads) {
    const int t = i / kD, d = i % kD;
    ks[t * kL + d] *=
        exp_ftz(fminf(cs[(kC - 1) * kL + d] - cs[t * kL + d], 0.f));
  }
  if (tid < kD) a.decay[idx * kD + tid] = exp_ftz(cs[(kC - 1) * kL + tid]);
  __syncthreads();

  // dS (kD x kD): warp w takes rows (channels of k) 16 rb .. 16 rb + 15
  // and kW columns from j0; A = K~^T, read along columns of ks
  constexpr int kRB = kD / 16, kW = kD * kRB / 8, kNT = kW / 8;
  const int rb = w % kRB, j0 = (w / kRB) * kW;
  const int g = lane >> 2, t4 = lane & 3;
  float acc[kNT][4] = {};
#pragma unroll
  for (int sb = 0; sb < kC / 8; ++sb) {
    uint32_t af[2][4];
#pragma unroll
    for (int reg = 0; reg < 4; ++reg)  // A[m = d][k = s] = K~[s][d]
      split_tf32(ks[(8 * sb + t4 + 4 * (reg >> 1)) * kL + 16 * rb + g +
                    8 * (reg & 1)],
                 af[0][reg], af[1][reg]);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      uint32_t bf[2][2];
      b_frag(bf, vs, kL, 8 * sb, j0 + 8 * nt, lane);
      mma_block<ExactTf32<T>::v>(acc[nt], af, bf);
    }
  }
  float* out = a.ds + idx * kD * kD;
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    const int n = 16 * rb + g, j = j0 + 8 * nt + 2 * t4;
    store2(out + n * kD + j, acc[nt][0], acc[nt][1]);
    store2(out + (n + 8) * kD + j, acc[nt][2], acc[nt][3]);
  }
}

// ---------------------------------------------------------------------------
// Launch 2: S_in,c = diag(exp(cl_last,c-1)) S_in,c-1 + dS_c-1 over dS_c in
// place, and the final state
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kPassThreads)
    wkv_pass(const Args a, int D) {
  wait_for_previous_launch();
  let_next_launch_start();    // launch 3 waits for all of this one
  const long long per = (long long)D * D / 4;
  const long long i = (long long)blockIdx.x * kPassThreads + threadIdx.x;
  if (i >= (long long)a.H * per) return;
  const int b = blockIdx.y, h = (int)(i / per), e = (int)(i % per) * 4;
  const int n = e / D, j = e % D;          // state row (channel of k)
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  constexpr int kAhead = 8;           // chunks whose loads are in flight
  for (int c0 = 0; c0 < a.nC; c0 += kAhead) {
    float4 d[kAhead];
    float dec[kAhead];
#pragma unroll
    for (int q = 0; q < kAhead; ++q) {
      const long long idx = ((long long)b * a.nC + c0 + q) * a.H + h;
      if (c0 + q < a.nC) {
        d[q] = *reinterpret_cast<const float4*>(a.ds + idx * D * D + e);
        dec[q] = a.decay[idx * D + n];
      }
    }
#pragma unroll
    for (int q = 0; q < kAhead; ++q) {
      const int c = c0 + q;
      if (c >= a.nC) break;
      const long long idx = ((long long)b * a.nC + c) * a.H + h;
      if (c > 0) *reinterpret_cast<float4*>(a.ds + idx * D * D + e) = s;
      s.x = dec[q] * s.x + d[q].x;
      s.y = dec[q] * s.y + d[q].y;
      s.z = dec[q] * s.z + d[q].z;
      s.w = dec[q] * s.w + d[q].w;
    }
  }
  if (n >= a.Dk) return;
  float* st = a.state + (((long long)b * a.H + h) * a.Dk + n) * a.Dv;
  const float sv[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (j + q < a.Dv) st[j + q] = sv[q];
}

// ---------------------------------------------------------------------------
// Launch 3: A, then y = (r o exp(e)) S_in + A v
// ---------------------------------------------------------------------------
template <int kD>
constexpr size_t output_smem() {
  return ((size_t)4 * kC * (kD + 4)      // r, k, cl, e
          + (size_t)kC * (kD + 8)        // v
          + (size_t)kC * kLdA            // A
          + kD + kThreads)               // u, the running sum's totals
         * sizeof(float);
}

// the 4x4 tiles of the diagonal sub-blocks, on the CUDA cores.  Warps 0-5:
// the 24 tiles strictly below the tiles on the diagonal, 8 lanes a tile
// (channels split 8 ways, the order rotated per tile to spread a warp's
// reads over the banks); each also zeroes its mirror tile above the
// diagonal.  Warps 6-7: the 16 tiles on the diagonal with the u diagonal,
// 4 lanes a tile.  e_t - cl_s <= 0 exactly here (one row group's sum).
template <int kD>
__device__ __forceinline__ void diagonal_tiles(const float* rs,
                                               const float* ks,
                                               const float* cs,
                                               const float* es,
                                               const float* us, float* As,
                                               int w, int lane) {
  constexpr int kL = kD + 4;
  if (w < 6) {
    constexpr int kM = kD / 8;
    const int f = 4 * w + (lane >> 3), sg = lane & 7, rot = lane >> 3;
    const int bi = f / 6, p = f % 6;
    const int ti = p < 1 ? 1 : (p < 3 ? 2 : 3), si = p - ti * (ti - 1) / 2;
    const int t0 = kSub * bi + 4 * ti, s0 = kSub * bi + 4 * si;
    float acc[4][4] = {};
#pragma unroll 4
    for (int m = 0; m < kM; ++m) {
      const int d = sg + 8 * ((m + rot) & (kM - 1));
      float rv[4], ev[4], kv[4], cv[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        rv[x] = rs[(t0 + x) * kL + d];
        ev[x] = es[(t0 + x) * kL + d];
        kv[x] = ks[(s0 + x) * kL + d];
        cv[x] = cs[(s0 + x) * kL + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] += rv[i] * kv[j] * exp_ftz(ev[i] - cv[j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int o = 1; o < 8; o <<= 1)
          acc[i][j] += __shfl_xor_sync(0xffffffffu, acc[i][j], o);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if ((4 * i + j) >> 1 == sg) {
          As[(t0 + i) * kLdA + s0 + j] = acc[i][j];
          As[(s0 + i) * kLdA + t0 + j] = 0.f;
        }
  } else {
    constexpr int kM = kD / 4;
    const int f = 8 * (w - 6) + (lane >> 2), sg = lane & 3, rot = lane >> 2;
    const int t0 = 4 * f;                 // sub-block f / 4, tile f % 4
    float acc[4][4] = {};                 // [i][j]: j < i, and j = i for u
#pragma unroll 4
    for (int m = 0; m < kM; ++m) {
      const int d = sg + 4 * ((m + rot) & (kM - 1));
      float rv[4], ev[4], kv[4], cv[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        rv[x] = rs[(t0 + x) * kL + d];
        ev[x] = es[(t0 + x) * kL + d];
        kv[x] = ks[(t0 + x) * kL + d];
        cv[x] = cs[(t0 + x) * kL + d];
      }
      const float ud = us[d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][i] += rv[i] * ud * kv[i];
#pragma unroll
        for (int j = 0; j < i; ++j)   // s < t only: nothing past it
          acc[i][j] += rv[i] * kv[j] * exp_ftz(ev[i] - cv[j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j <= i; ++j)
#pragma unroll
        for (int o = 1; o < 4; o <<= 1)
          acc[i][j] += __shfl_xor_sync(0xffffffffu, acc[i][j], o);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (i == sg) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          As[(t0 + i) * kLdA + t0 + j] = j <= i ? acc[i][j] : 0.f;
      }
  }
}

// A's sub-block (i, j), i > j, on the tensor cores: R~_i K~_j^T with
// r~_t = r_t exp(e_t - b), k~_s = k_s exp(b - cl_s), b = cl at row
// 16 j + 15; both exponents <= 0 up to the rounding of the running sum's
// partial sums, and clamped at 0 against it
template <int kD>
__device__ __forceinline__ void offdiagonal_block(const float* rs,
                                                  const float* ks,
                                                  const float* cs,
                                                  const float* es, float* As,
                                                  int i, int j, int lane) {
  constexpr int kL = kD + 4;
  const int g = lane >> 2, t4 = lane & 3;
  const float* bref = cs + (kSub * j + kSub - 1) * kL;
  float acc[2][4] = {};
#pragma unroll
  for (int kk = 0; kk < kD / 8; ++kk) {
    uint32_t af[2][4];
#pragma unroll
    for (int reg = 0; reg < 4; ++reg) {
      const int t = kSub * i + g + 8 * (reg & 1);
      const int d = 8 * kk + t4 + 4 * (reg >> 1);
      split_tf32(rs[t * kL + d] *
                     exp_ftz(fminf(es[t * kL + d] - bref[d], 0.f)),
                 af[0][reg], af[1][reg]);
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int s = kSub * j + 8 * nt + g;
      uint32_t bf[2][2];
#pragma unroll
      for (int reg = 0; reg < 2; ++reg) {   // B[k = d][n = s] = K~[s][d]
        const int d = 8 * kk + t4 + 4 * reg;
        split_tf32(ks[s * kL + d] *
                       exp_ftz(fminf(bref[d] - cs[s * kL + d], 0.f)),
                   bf[0][reg], bf[1][reg]);
      }
      mma_block<false>(acc[nt], af, bf);
    }
  }
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    const int t = kSub * i + g, s = kSub * j + 8 * nt + 2 * t4;
    store2(As + t * kLdA + s, acc[nt][0], acc[nt][1]);
    store2(As + (t + 8) * kLdA + s, acc[nt][2], acc[nt][3]);
  }
}

template <int kD, typename T>
__global__ void __launch_bounds__(kThreads, kD == 64 ? 2 : 1)
    wkv_output(const Args a) {
  constexpr int kL = kD + 4, kLB = kD + 8;
  static_assert((size_t)kD * kLB <= (size_t)3 * kC * kL,
                "S_in fits in the space of k, cl and e");
  extern __shared__ __align__(16) float sm[];
  float* rs = sm;                  // (kC, kL): r, then r o exp(e)
  float* ks = rs + kC * kL;        // (kC, kL): k
  float* cs = ks + kC * kL;        // (kC, kL): log_w, then cl
  float* es = cs + kC * kL;        // (kC, kL): e
  float* vs = es + kC * kL;        // (kC, kLB): v
  float* As = vs + kC * kLB;       // (kC, kLdA): A
  float* us = As + kC * kLdA;      // (kD,): u of this head
  float* tot = us + kD;
  float* s_in = ks;                // (kD, kLB): S_in, once A and r o exp(e)
                                   // are done

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const long long c0 = (long long)c * kC;

  load_chunk<kD, T>(a, b, h, c0, rs, ks, cs, vs, kL, kLB);
  if (tid < kD) us[tid] = tid < a.Dk ? __ldg(a.u + h * a.Dk + tid) : 0.f;
  __syncthreads();
  chunk_cumsum<kD>(cs, es, kL, tot);

  // A: the diagonal sub-blocks on the CUDA cores, then the six sub-blocks
  // below them on the tensor cores, one a warp (warps 2-7)
  diagonal_tiles<kD>(rs, ks, cs, es, us, As, w, lane);
  if (w >= 2) {
    const int u = w - 2;                     // (1,0) (2,0) (2,1) (3,0) ...
    const int i = u < 1 ? 1 : (u < 3 ? 2 : 3), j = u - i * (i - 1) / 2;
    offdiagonal_block<kD>(rs, ks, cs, es, As, i, j, lane);
  }
  __syncthreads();
  // r o exp(e), the decayed read of S_in, in place (e <= 0)
  if (c > 0)
#pragma unroll 4
    for (int i = tid; i < kC * kD; i += kThreads) {
      const int t = i / kD, d = i % kD;
      rs[t * kL + d] *= exp_ftz(es[t * kL + d]);
    }
  __syncthreads();           // k, cl and e are dead: S_in takes their place

  wait_for_previous_launch();                // S_in is complete
  if (c > 0) {
    const float* src = a.ds + (((long long)b * a.nC + c) * a.H + h) * kD * kD;
    constexpr int kPer = kD / 4;
    for (int i = tid; i < kD * kPer; i += kThreads) {
      const int n = i / kPer, e = (i % kPer) * 4;
      cp16(s_in + n * kLB + e, src + n * kD + e, true);
    }
  }
  cp_commit();
  cp_wait_all();
  __syncthreads();

  // y rows 16 rt .. 16 rt + 15, kD / 2 columns from jh
  constexpr int kNT = kD / 16;
  const int rt = w & 3, jh = (w >> 2) * (kD / 2);
  float acc[kNT][4] = {};
  if (c > 0) {
#pragma unroll
    for (int kk = 0; kk < kD / 8; ++kk) {
      uint32_t af[2][4];
      a_frag(af, rs, kL, kSub * rt, 8 * kk, lane);
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        uint32_t bf[2][2];
        b_frag(bf, s_in, kLB, 8 * kk, jh + 8 * nt, lane);
        mma_block<false>(acc[nt], af, bf);
      }
    }
  }
#pragma unroll
  for (int sb = 0; sb < 8; ++sb) {      // A v over the key blocks s <= t
    if (sb > 2 * rt + 1) break;
    uint32_t af[2][4];
    a_frag(af, As, kLdA, kSub * rt, 8 * sb, lane);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      uint32_t bf[2][2];
      b_frag(bf, vs, kLB, 8 * sb, jh + 8 * nt, lane);
      mma_block<ExactTf32<T>::v>(acc[nt], af, bf);
    }
  }

  T* yh = static_cast<T*>(a.y) + b * a.y_sb + h * a.y_sh;
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    const int j = jh + 8 * nt + 2 * t4;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const long long pos = c0 + kSub * rt + g + 8 * rr;
      if (pos >= a.S || j >= a.Dv) continue;
      T* yp = yh + pos * a.y_ss + j;
      if (j + 1 < a.Dv && a.vec_y)      // both columns in one store
        store2(yp, acc[nt][2 * rr], acc[nt][2 * rr + 1]);
      else {
        yp[0] = from_f32<T>(acc[nt][2 * rr]);
        if (j + 1 < a.Dv) yp[1] = from_f32<T>(acc[nt][2 * rr + 1]);
      }
    }
  }
}

// dtype codes shared with the Python wrapper
enum { kF32 = 0, kBF16 = 1 };

bool aligned16(const void* p, long long sb, long long ss, long long sh,
               size_t el) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (sb * el) % 16 == 0 &&
         (ss * el) % 16 == 0 && (sh * el) % 16 == 0;
}

// a launch that may start while the one before it on the stream finishes
// (programmatic dependent launch; the kernel waits where it reads that
// launch's output)
template <typename... Params, typename... Vals>
cudaError_t launch_after(void (*kernel)(Params...), dim3 grid, int threads,
                         size_t smem, cudaStream_t stream, Vals... vals) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, vals...);
}

// the kernel's dynamic shared memory, and the largest carveout so that
// two CTAs of launch 3 share an SM
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <int kD, typename T>
int launch(const Args& a, int B, cudaStream_t stream) {
  const size_t s1 = states_smem<kD>(), s3 = output_smem<kD>();
  cudaError_t err = allow_smem(wkv_states<kD, T>, s1);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = allow_smem(wkv_output<kD, T>, s3);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.nC, a.H, B);
  wkv_states<kD, T><<<grid, kThreads, s1, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n4 = (long long)a.H * kD * kD / 4;
  err = launch_after(
      wkv_pass, dim3((unsigned)((n4 + kPassThreads - 1) / kPassThreads), B),
      kPassThreads, 0, stream, a, kD);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      launch_after(wkv_output<kD, T>, grid, kThreads, s3, stream, a));
}

}  // namespace

extern "C" {

int rwkv6_scan_forward(const void* r, const void* k, const void* v,
                       const float* lw, const float* u, void* y,
                       float* state, void* scratch, long long scratch_bytes,
                       long long r_sb, long long r_ss, long long r_sh,
                       long long k_sb, long long k_ss, long long k_sh,
                       long long v_sb, long long v_ss, long long v_sh,
                       long long w_sb, long long w_ss, long long w_sh,
                       long long y_sb, long long y_ss, long long y_sh, int B,
                       int S, int H, int Dk, int Dv, int dtype, void* stream) {
  // scratch: float32 (B, nC, H, D, D) chunk states, then (B, nC, H, D)
  // decays, with nC = ceil(S / 64) and D = 64, or 128 when Dk or Dv is
  // above 64
  const int D = (Dk > 64 || Dv > 64) ? 128 : 64;
  const int nC = (S + kC - 1) / kC;
  if (B < 1 || S < 1 || H < 1 || Dk < 1 || Dv < 1 || Dk > kMaxD ||
      Dv > kMaxD || B > 65535 || H > 65535 ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0 ||
      scratch_bytes < (long long)B * nC * H * D * (D + 1) * 4 ||
      (dtype != kF32 && dtype != kBF16))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.r = r; a.k = k; a.v = v; a.lw = lw; a.u = u; a.y = y; a.state = state;
  a.nC = nC;
  a.ds = static_cast<float*>(scratch);
  a.decay = a.ds + (long long)B * nC * H * D * D;
  a.r_sb = r_sb; a.r_ss = r_ss; a.r_sh = r_sh;
  a.k_sb = k_sb; a.k_ss = k_ss; a.k_sh = k_sh;
  a.v_sb = v_sb; a.v_ss = v_ss; a.v_sh = v_sh;
  a.w_sb = w_sb; a.w_ss = w_ss; a.w_sh = w_sh;
  a.y_sb = y_sb; a.y_ss = y_ss; a.y_sh = y_sh;
  a.S = S; a.H = H; a.Dk = Dk; a.Dv = Dv;
  const size_t el = dtype == kBF16 ? 2 : 4;
  const int per16 = static_cast<int>(16 / el);
  a.vec_rk = Dk % per16 == 0 && aligned16(r, r_sb, r_ss, r_sh, el) &&
             aligned16(k, k_sb, k_ss, k_sh, el);
  a.vec_v = Dv % per16 == 0 && aligned16(v, v_sb, v_ss, v_sh, el);
  a.vec_w = Dk % 4 == 0 && aligned16(lw, w_sb, w_ss, w_sh, 4);
  a.vec_y = reinterpret_cast<uintptr_t>(y) % (2 * el) == 0 &&
            y_sb % 2 == 0 && y_ss % 2 == 0 && y_sh % 2 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return dtype == kBF16 ? launch<64, bf16>(a, B, s)
                          : launch<64, float>(a, B, s);
  return dtype == kBF16 ? launch<128, bf16>(a, B, s)
                        : launch<128, float>(a, B, s);
}

const char* rwkv6_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
