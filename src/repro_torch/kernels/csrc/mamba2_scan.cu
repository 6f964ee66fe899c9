// Mamba2 (SSD) chunked scan for Hopper (sm_90a): chunk-parallel, on the
// tensor cores.
//
// Replaces the TPU kernel in src/repro/kernels/mamba2_scan.py:
//   mamba2_scan  (_ssd_kernel at :20, wrapper at :63, pallas_call at :80)
//
// What it computes, per batch row b and head h, from a zero (N, hd) state,
// with one decay w_t = exp(log_w_t) per (position, head):
//   y_t = r_t^T (w_t S_{t-1} + k_t v_t^T),
//   S_t = w_t S_{t-1} + k_t v_t^T,
// for r, k (B, S, H, N), v (B, S, H, hd) and log_w (B, S, H, 1); y (B, S,
// H, hd) in v's dtype and the final state (B, H, N, hd) float32.
//
// The decomposition is the chunked SSD algorithm of the Mamba2 paper
// (arXiv:2405.21060, section 6) over 64-position chunks.  With cl the
// *inclusive* running sum of log_w inside a chunk (position t already sees
// its own w_t, so the diagonal s = t belongs to the intra-chunk part):
//   G      = R K^T                                (once per chunk and row),
//   dS     = sum_s exp(cl_last - cl_s) k_s v_s^T  (the chunk's own state),
//   S_in,c = exp(cl_last,c-1) S_in,c-1 + dS_c-1   (the state before it),
//   y      = (G o L) V + exp(cl) (R S_in),  L[t, s] = exp(cl_t - cl_s) for
//                                           s <= t, else 0.
// Three launches on the caller's stream, the second and third started
// early (programmatic dependent launch) and waiting where they read what
// the launch before wrote:
//   1. mamba2_ssd_states, one CTA per (chunk, group of heads, b), 4 warps
//      of 16 state rows: every chunk's dS and decay exp(cl_last), to a
//      float32 scratch;
//   2. mamba2_ssd_pass, one thread per 4 state entries of a (b, h): walks
//      the chunks (8 elementwise steps at S 512) and writes S_in,c over
//      dS_c in place; the last state is the returned one;
//   3. mamba2_ssd_output, one CTA per (chunk, group of heads, b), 8 warps
//      of 16 rows x 32 columns: y, 64 columns at a time; R, K and G are
//      loaded and computed before it waits for launch 2.
// Only differences cl_t - cl_s <= 0, cl_last - cl_s <= 0 and cl_t <= 0 are
// exponentiated (ex2.approx.ftz with log2(e) folded in), so strong decays
// (cl near -700 inside a chunk) underflow to 0 and never overflow; nothing
// is factored into exp(cl_t) * exp(-cl_s).
//
// Products on the tensor cores, mma.sync.m16n8k16 bf16 with float32 sums;
// each 16-term block is summed from zero and added in float32, since the
// tensor cores truncate when they add into an accumulator.  bf16 r and k
// are exact, so G costs one product.  A float32 operand (r, k, v, dk v,
// S_in, G o L) is split into three bf16 parts, hi + mid + lo, which hold
// its 24 bits exactly, and a product keeps the part products down to 2^-16
// of it (parts i + j <= 2 of 0..2): R S_in and K^T (dk V) take three,
// (G o L) V six (three for bf16 v).  Two parts (hi + lo, 16 bits) were not
// enough: where the state carries (weak decays) y cancels to near 0 and
// missed the 1e-3 the smoke holds it to.  Operands sit in shared memory
// as bf16 planes with padded rows (ldmatrix, no bank conflicts); G stays
// in registers, and its accumulator layout is the A-operand layout of
// (G o L) V; K's planes are dead once G is computed and S_in's take their
// place.  A CTA takes a group of heads (3 in launch 3, 2 in launch 1):
// when r and k are broadcasts over the heads (head stride 0, as the model's
// are) it loads R and K (and computes G) once for the group; the next
// head's v, log_w and S_in are in flight (16-byte cp.async) while the
// current head computes.
//
// Bound on the H100, at zamba2-2.7b's longest prefill in the smoke (B 1,
// S 512, H 80, N = hd = 64, r/k bf16 broadcasts, v float32): the bytes (v
// and y float32, 10.5 MB each, the 1.3 MB state, r, k and log_w) are about
// 22.5 MB, 6.7 us at 3.35 TB/s; the products at the rates they run (G once
// per chunk, every part product counted at the bf16 rate) are about 2.9
// GFLOP, 2.9 us, and the exponentials, scalings and the passing of the
// state on the CUDA cores about 0.2 us: bytes bound.
//
// What still holds it back: about 74 MB of traffic against the bound's
// 22.5 (v is read by launches 1 and 3, dS and S_in go through the
// scratch); each CTA's chain of loads, conversions into bf16 parts and
// products, with only the next head's loads in flight.  A copy of launch 3
// without its products was not much faster: the chain, not the tensor
// cores, sets its pace.  One launch with a decoupled look-back over the
// chunks (v read once) was slower: the look-back's fences and L2 round
// trips lengthen every CTA's chain.
// N and hd up to 128 (at 128 the state is read in 64-column blocks); r and
// k float32 or bfloat16 (one dtype), v float32 or bfloat16, log_w float32,
// any strides with the last dim contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kC = 64;                 // positions per chunk
constexpr int kMaxD = 128;
constexpr int kPassThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kHeadGroup = 3;          // heads per CTA of launch 3
constexpr int kStateGroup = 2;         // heads per CTA of launch 1

// bf16 parts an operand is held in: a bf16 one is exact in one, a float32
// one in three
template <typename T> struct Planes { static constexpr int n = 3; };
template <> struct Planes<bf16> { static constexpr int n = 1; };

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float to_f32<bf16>(bf16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// x = hi + mid + lo exactly (8 + 8 + 8 of float32's 24 bits)
__device__ __forceinline__ void split3(float x, bf16& hi, bf16& mid,
                                       bf16& lo) {
  hi = __float2bfloat16(x);
  const float r1 = x - __bfloat162float(hi);
  mid = __float2bfloat16(r1);
  lo = __float2bfloat16(r1 - __bfloat162float(mid));
}

__device__ __forceinline__ uint32_t pack(bf16 a, bf16 b) {
  return (uint32_t)__bfloat16_as_ushort(a) |
         ((uint32_t)__bfloat16_as_ushort(b) << 16);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, float32 sum
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc += part, rounded to nearest: the tensor cores truncate when they add
// into an accumulator, so each 16-term block is summed from zero and added
// here
__device__ __forceinline__ void add_parts(float (&a0)[4], float (&a1)[4],
                                          const float (&part)[2][4]) {
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    a0[x] += part[0][x];
    a1[x] += part[1][x];
  }
}

// 16 bytes (or 4) global -> shared, zeros when !ok (src must stay valid)
__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
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
  const void* r;       // (B, S, H, N)
  const void* k;       // (B, S, H, N)
  const void* v;       // (B, S, H, hd)
  const float* lw;     // (B, S, H, 1), <= 0
  void* y;             // (B, S, H, hd), v's dtype
  float* state;        // (B, H, N, hd) contiguous
  float* ds;           // (B, nC, H, D, D): dS_c, then S_in,c in place
  float* decay;        // (B, nC, H): exp(cl_last) of each chunk
  long long r_sb, r_ss, r_sh;  // element strides (batch, position, head)
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long w_sb, w_ss, w_sh;
  long long y_sb, y_ss, y_sh;
  int S, H, N, hd, nC;
  int hg1, hg;                 // heads per CTA of launches 1 and 3
  int vec_rk, vec_v;           // 16-byte loads allowed for r/k, for v
  int vec_y;                   // two-column stores allowed for y
};

// ---------------------------------------------------------------------------
// Loads and conversions shared by launches 1 and 3
// ---------------------------------------------------------------------------

// the chunk's rows of r or k into bf16 planes [p][t][kD + 8]: zeros past S
// and past N; 16-byte cp.async straight into plane 0 when TR is bf16 and
// the rows are aligned, else element loads (split into parts for float)
template <int kD, int kThreads, typename TR>
__device__ __forceinline__ void load_rk(bf16* planes, const TR* src,
                                        long long ss, long long c0,
                                        const Args& a) {
  constexpr int kLd = kD + 8;
  const int tid = threadIdx.x;
  constexpr int kP = Planes<TR>::n;
  if constexpr (kP == 1) {
    if (a.vec_rk) {
      constexpr int kPer = kD / 8;            // 16-byte pieces per row
      for (int i = tid; i < kC * kPer; i += kThreads) {
        const int t = i / kPer, e = (i % kPer) * 8;
        const bool ok = c0 + t < a.S && e < a.N;
        cp16(planes + t * kLd + e, src + (ok ? (c0 + t) * ss + e : 0), ok);
      }
      return;
    }
  }
  for (int i = tid; i < kC * kD; i += kThreads) {
    const int t = i / kD, d = i % kD;
    const bool ok = c0 + t < a.S && d < a.N;
    const float x = ok ? to_f32(src[(c0 + t) * ss + d]) : 0.f;
    bf16 p[3];
    split3(x, p[0], p[1], p[2]);
#pragma unroll
    for (int q = 0; q < kP; ++q) planes[q * kC * kLd + t * kLd + d] = p[q];
  }
}

// columns [j0, j0 + kW) of the chunk's rows of v (zeros past S and hd)
// into raw rows of kW; cp.async when aligned, else element loads
template <int kW, int kThreads, typename TV>
__device__ __forceinline__ void load_v(TV* vraw, const TV* v, int j0,
                                       long long c0, const Args& a) {
  const int tid = threadIdx.x;
  if (a.vec_v) {
    constexpr int kEl = 16 / sizeof(TV), kPer = kW / kEl;
    for (int i = tid; i < kC * kPer; i += kThreads) {
      const int t = i / kPer, e = (i % kPer) * kEl;
      const bool ok = c0 + t < a.S && j0 + e < a.hd;
      cp16(vraw + t * kW + e, v + (ok ? (c0 + t) * a.v_ss + j0 + e : 0),
           ok);
    }
  } else {
    for (int i = tid; i < kC * kW; i += kThreads) {
      const int t = i / kW, j = j0 + i % kW;
      const bool ok = c0 + t < a.S && j < a.hd;
      vraw[i] = ok ? v[(c0 + t) * a.v_ss + j] : from_f32<TV>(0.f);
    }
  }
}

// the chunk's log_w (zeros past S)
__device__ __forceinline__ void load_lw(float* lws, const float* lw,
                                       long long c0, const Args& a) {
  const int tid = threadIdx.x;
  if (tid < kC) {
    const bool ok = c0 + tid < a.S;
    cp4(lws + tid, lw + (ok ? (c0 + tid) * a.w_ss : 0), ok);
  }
}

// the running sum of log_w over the chunk, one warp: lane l returns the
// inclusive sums at positions 2l and 2l + 1, and the chunk's total
__device__ __forceinline__ void chunk_cumsum(const float* lws, int lane,
                                            float& c0, float& c1,
                                            float& last) {
  const float x0 = lws[2 * lane], x1 = lws[2 * lane + 1];
  float sc = x0 + x1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, sc, o);
    if (lane >= o) sc += up;
  }
  c0 = sc - x1;
  c1 = sc;
  last = __shfl_sync(0xffffffffu, sc, 31);
}

// raw rows [t0, t0 + rows) of kW values, each scaled by scale[t] (or 1),
// into the first kPlanes of its bf16 parts hi, mid, lo (1: the value,
// exact for bf16; 3: all of it) in planes of rows kLd apart, pstride
// apart; one warp, four values a lane
template <int kW, int kLd, int kPlanes, typename T>
__device__ __forceinline__ void convert_rows(bf16* planes, int pstride,
                                             const T* raw,
                                             const float* scale, int t0,
                                             int rows, int lane) {
  constexpr int kLanesPerRow = kW / 4, kRowsPerStep = 32 / kLanesPerRow;
  const int j = (lane % kLanesPerRow) * 4;
  for (int t = t0 + lane / kLanesPerRow; t < t0 + rows; t += kRowsPerStep) {
    float x[4];
    if constexpr (sizeof(T) == 4) {
      const float4 f = *reinterpret_cast<const float4*>(raw + t * kW + j);
      x[0] = f.x; x[1] = f.y; x[2] = f.z; x[3] = f.w;
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) x[q] = to_f32(raw[t * kW + j + q]);
    }
    const float s = scale ? scale[t] : 1.f;
    bf16 p[3][4];
#pragma unroll
    for (int q = 0; q < 4; ++q) split3(x[q] * s, p[0][q], p[1][q], p[2][q]);
#pragma unroll
    for (int pl = 0; pl < kPlanes; ++pl)
      *reinterpret_cast<uint2*>(planes + pl * pstride + t * kLd + j) =
          make_uint2(pack(p[pl][0], p[pl][1]), pack(p[pl][2], p[pl][3]));
  }
}

// ---------------------------------------------------------------------------
// Launch 1: each chunk's own state dS = K^T diag(dk) V and its decay
// ---------------------------------------------------------------------------
__host__ __device__ constexpr int states_threads(int kD) {
  return 32 * (kD / 16);
}

template <int kD, typename TR, typename TV>
constexpr size_t states_smem() {
  return (size_t)Planes<TR>::n * kC * (kD + 8) * 2       // K planes
         + (size_t)3 * kC * (kD + 8) * 2             // dk V planes
         + (size_t)kC * kD * sizeof(TV)              // v staging
         + 2 * kC * sizeof(float);                   // log_w, dk
}

template <int kD, typename TR, typename TV>
__global__ void __launch_bounds__(32 * (kD / 16))
    mamba2_ssd_states(const Args a) {
  constexpr int kThreads = states_threads(kD), kWarps = kThreads / 32;
  constexpr int kLd = kD + 8, kPR = Planes<TR>::n, kRows = kC / kWarps;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* kp = reinterpret_cast<bf16*>(smem);           // [kPR][kC][kLd]
  bf16* vq = kp + kPR * kC * kLd;                     // [3][kC][kLd]
  TV* vraw = reinterpret_cast<TV*>(vq + 3 * kC * kLd);
  float* lws = reinterpret_cast<float*>(vraw + kC * kD);
  float* dk = lws + kC;

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int c = blockIdx.x, b = blockIdx.z;
  const int h0 = blockIdx.y * a.hg1, nh = min(a.hg1, a.H - h0);
  const long long c0 = (long long)c * kC;
  const TV* v = static_cast<const TV*>(a.v) + b * a.v_sb;
  const float* lw = a.lw + b * a.w_sb;
  let_next_launch_start();    // launch 2 waits for all of this one

  load_v<kD, kThreads>(vraw, v + h0 * a.v_sh, 0, c0, a);
  load_lw(lws, lw + h0 * a.w_sh, c0, a);
  load_rk<kD, kThreads>(
      kp, static_cast<const TR*>(a.k) + b * a.k_sb + h0 * a.k_sh, a.k_ss, c0,
      a);
  cp_commit();

  for (int i = 0; i < nh; ++i) {
    const int h = h0 + i;
    cp_wait_all();
    __syncthreads();
    {   // dk[s] = exp(cl_last - cl_s) for this warp's rows, then dk v
      float cl0, cl1, last;
      chunk_cumsum(lws, lane, cl0, cl1, last);
      if (2 * lane >= w * kRows && 2 * lane < (w + 1) * kRows) {
        dk[2 * lane] = ex2((last - cl0) * kLog2e);
        dk[2 * lane + 1] = ex2((last - cl1) * kLog2e);
      }
      if (tid == 0)
        a.decay[((long long)b * a.nC + c) * a.H + h] = ex2(last * kLog2e);
      __syncwarp();
      convert_rows<kD, kLd, 3>(vq, kC * kLd, vraw, dk, w * kRows, kRows,
                               lane);
    }
    __syncthreads();
    if (i + 1 < nh) {
      load_v<kD, kThreads>(vraw, v + (h + 1) * a.v_sh, 0, c0, a);
      load_lw(lws, lw + (h + 1) * a.w_sh, c0, a);
    }
    cp_commit();

    // dS rows 16 w .. 16 w + 15 (state dim), every column; A = K^T from
    // the K planes by ldmatrix.trans, B = the dk v planes by ldmatrix.trans
    float acc[kD / 8][4] = {};
#pragma unroll
    for (int ks = 0; ks < kC / 16; ++ks) {
#pragma unroll
      for (int p = 0; p < kPR; ++p) {
        uint32_t af[4];
        ldsm4_t(af, kp + p * kC * kLd +
                        (16 * ks + (lane & 7) + 8 * (lane >> 4)) * kLd +
                        16 * w + 8 * ((lane >> 3) & 1));
#pragma unroll
        for (int jp = 0; jp < kD / 16; ++jp) {
          float part[2][4] = {};
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            if (p + q > 2) continue;   // parts below 2^-24 of the product
            uint32_t bf[4];
            ldsm4_t(bf, vq + q * kC * kLd +
                            (16 * ks + (lane & 7) + 8 * ((lane >> 3) & 1)) *
                                kLd +
                            16 * jp + 8 * (lane >> 4));
            mma(part[0], af, bf[0], bf[1]);
            mma(part[1], af, bf[2], bf[3]);
          }
          add_parts(acc[2 * jp], acc[2 * jp + 1], part);
        }
      }
    }
    float* out = a.ds + (((long long)b * a.nC + c) * a.H + h) * kD * kD;
#pragma unroll
    for (int nt = 0; nt < kD / 8; ++nt) {
      const int n = 16 * w + g, j = 8 * nt + 2 * t4;
      *reinterpret_cast<float2*>(out + n * kD + j) =
          make_float2(acc[nt][0], acc[nt][1]);
      *reinterpret_cast<float2*>(out + (n + 8) * kD + j) =
          make_float2(acc[nt][2], acc[nt][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// Launch 2: S_in,c = exp(cl_last,c-1) S_in,c-1 + dS_c-1 over dS_c in place,
// and the final state
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kPassThreads)
    mamba2_ssd_pass(const Args a, int D) {
  wait_for_previous_launch();
  let_next_launch_start();    // launch 3 waits for all of this one
  const long long per = (long long)D * D / 4;
  const long long i = (long long)blockIdx.x * kPassThreads + threadIdx.x;
  if (i >= (long long)a.H * per) return;
  const int b = blockIdx.y, h = (int)(i / per), e = (int)(i % per) * 4;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  constexpr int kAhead = 4;           // chunks whose loads are in flight
  for (int c0 = 0; c0 < a.nC; c0 += kAhead) {
    float4 d[kAhead];
    float dec[kAhead];
#pragma unroll
    for (int q = 0; q < kAhead; ++q) {
      const long long idx = ((long long)b * a.nC + c0 + q) * a.H + h;
      if (c0 + q < a.nC) {
        d[q] = *reinterpret_cast<const float4*>(a.ds + idx * D * D + e);
        dec[q] = a.decay[idx];
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
  const int n = e / D, j = e % D;
  if (n >= a.N) return;
  float* st = a.state + (((long long)b * a.H + h) * a.N + n) * a.hd;
  const float sv[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (j + q < a.hd) st[j + q] = sv[q];
}

// ---------------------------------------------------------------------------
// Launch 3: y = (G o L) V + exp(cl) (R S_in), 64 columns of y at a time
// ---------------------------------------------------------------------------
constexpr int kOutThreads = 256;     // 8 warps: 16 rows x 32 columns each
constexpr int kBw = 64;              // columns of y (and v, S_in) a unit
constexpr int kBld = kBw + 8;

template <int kD, typename TR, typename TV>
constexpr size_t output_smem() {
  return (size_t)Planes<TR>::n * kC * (kD + 8) * 2   // R planes
         + (size_t)Planes<TV>::n * kC * kBld * 2     // v planes
         + (size_t)kC * kBw * sizeof(TV)             // v staging
         + 3 * kC * sizeof(float)                    // log_w, cl, er
         + (size_t)3 * kD * kBld * 2                 // S_in planes (K's)
         + (size_t)kD * kBw * sizeof(float);         // S_in staging
}

// columns [j0, j0 + kBw) of S_in (rows D, in the scratch) into its staging
template <int kD>
__device__ __forceinline__ void load_sin(float* dst, const float* src,
                                         int j0) {
  constexpr int kPer = kBw / 4;
  for (int i = threadIdx.x; i < kD * kPer; i += kOutThreads) {
    const int n = i / kPer, e = (i % kPer) * 4;
    cp16(dst + n * kBw + e, src + n * kD + j0 + e, true);
  }
}

template <int kD, typename TR, typename TV>
__global__ void __launch_bounds__(kOutThreads, 2)
    mamba2_ssd_output(const Args a) {
  constexpr int kLd = kD + 8, kPR = Planes<TR>::n, kPV = Planes<TV>::n;
  constexpr int kWarps = kOutThreads / 32;
  static_assert(kPR * kC * kLd <= 3 * kD * kBld, "K's planes fit S_in's");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* rp = reinterpret_cast<bf16*>(smem);           // [kPR][kC][kLd]
  bf16* vp = rp + kPR * kC * kLd;                     // [kPV][kC][kBld]
  TV* vraw = reinterpret_cast<TV*>(vp + kPV * kC * kBld);
  float* lws = reinterpret_cast<float*>(vraw + kC * kBw);
  float* cl = lws + kC;
  float* er = cl + kC;                                // exp(cl)
  // K is read only for G, before the first barrier of the loop over the
  // heads, after which S_in's planes are written over it
  bf16* sp = reinterpret_cast<bf16*>(er + kC);        // [3][kD][kBld]
  bf16* kp = sp;                                      // [kPR][kC][kLd]
  float* sraw = reinterpret_cast<float*>(sp + 3 * kD * kBld);

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int rt = w & 3, jh = 32 * (w >> 2);   // rows 16 rt .., columns jh ..
  const int c = blockIdx.x, b = blockIdx.z;
  const int h0 = blockIdx.y * a.hg, nh = min(a.hg, a.H - h0);
  const int ncb = (a.hd + kBw - 1) / kBw;             // column blocks
  const long long c0 = (long long)c * kC;
  const TV* v = static_cast<const TV*>(a.v) + b * a.v_sb;
  const float* lw = a.lw + b * a.w_sb;
  TV* y = static_cast<TV*>(a.y) + b * a.y_sb;
  const float* sin_c = a.ds + ((long long)b * a.nC + c) * a.H * kD * kD;

  load_v<kBw, kOutThreads>(vraw, v + h0 * a.v_sh, 0, c0, a);
  load_lw(lws, lw + h0 * a.w_sh, c0, a);
  load_rk<kD, kOutThreads>(
      rp, static_cast<const TR*>(a.r) + b * a.r_sb + h0 * a.r_sh, a.r_ss, c0,
      a);
  load_rk<kD, kOutThreads>(
      kp, static_cast<const TR*>(a.k) + b * a.k_sb + h0 * a.k_sh, a.k_ss, c0,
      a);
  cp_commit();

  const int t0 = 16 * rt + g, t1 = t0 + 8;   // this thread's two rows
  float G[8][4] = {};                        // R K^T, rows t0/t1, s < 64
  cp_wait_all();
  __syncthreads();
  // G = R K^T for s <= 16 rt + 15, once for the group, while launch 2 runs
#pragma unroll
  for (int ks = 0; ks < kD / 16; ++ks) {
#pragma unroll
    for (int p = 0; p < kPR; ++p) {
      uint32_t af[4];
      ldsm4(af, rp + p * kC * kLd +
                    (16 * rt + (lane & 7) + 8 * ((lane >> 3) & 1)) * kLd +
                    16 * ks + 8 * (lane >> 4));
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        if (np > rt) continue;
        float part[2][4] = {};
#pragma unroll
        for (int q = 0; q < kPR; ++q) {
          if (p + q > 2) continue;
          uint32_t bf[4];
          ldsm4(bf, kp + q * kC * kLd +
                        (16 * np + (lane & 7) + 8 * (lane >> 4)) * kLd +
                        16 * ks + 8 * ((lane >> 3) & 1));
          mma(part[0], af, bf[0], bf[1]);
          mma(part[1], af, bf[2], bf[3]);
        }
        add_parts(G[2 * np], G[2 * np + 1], part);
      }
    }
  }
  wait_for_previous_launch();               // S_in is complete
  if (c > 0) load_sin<kD>(sraw, sin_c + (long long)h0 * kD * kD, 0);
  cp_commit();

  constexpr int kRows = kC / kWarps;          // rows each warp converts
  for (int u = 0; u < nh * ncb; ++u) {
    const int h = h0 + u / ncb, cb = u % ncb;
    cp_wait_all();
    __syncthreads();
    if (cb == 0) {
      float cl0, cl1, last;
      chunk_cumsum(lws, lane, cl0, cl1, last);
      if (2 * lane >= kRows * w && 2 * lane < kRows * (w + 1)) {
        cl[2 * lane] = cl0;
        cl[2 * lane + 1] = cl1;
        er[2 * lane] = ex2(cl0 * kLog2e);
        er[2 * lane + 1] = ex2(cl1 * kLog2e);
      }
    }
    convert_rows<kBw, kBld, kPV>(vp, kC * kBld, vraw, nullptr, kRows * w,
                                 kRows, lane);
    if (c > 0)
      convert_rows<kBw, kBld, 3>(sp, kD * kBld, sraw, nullptr,
                                 w * (kD / kWarps), kD / kWarps, lane);
    __syncthreads();
    if (u + 1 < nh * ncb) {
      const int hn = h0 + (u + 1) / ncb, jn = ((u + 1) % ncb) * kBw;
      load_v<kBw, kOutThreads>(vraw, v + hn * a.v_sh, jn, c0, a);
      if (jn == 0) load_lw(lws, lw + hn * a.w_sh, c0, a);
      if (c > 0) load_sin<kD>(sraw, sin_c + (long long)hn * kD * kD, jn);
    }
    cp_commit();

    float acc[4][4] = {};
    if (c > 0) {    // exp(cl_t) (R S_in): S_in exact in three parts
#pragma unroll
      for (int ks = 0; ks < kD / 16; ++ks) {
#pragma unroll
        for (int p = 0; p < kPR; ++p) {
          uint32_t af[4];
          ldsm4(af, rp + p * kC * kLd +
                        (16 * rt + (lane & 7) + 8 * ((lane >> 3) & 1)) *
                            kLd +
                        16 * ks + 8 * (lane >> 4));
#pragma unroll
          for (int jp = 0; jp < 2; ++jp) {
            float part[2][4] = {};
#pragma unroll
            for (int q = 0; q < 3; ++q) {
              if (p + q > 2) continue;
              uint32_t bf[4];
              ldsm4_t(bf, sp + q * kD * kBld +
                              (16 * ks + (lane & 7) +
                               8 * ((lane >> 3) & 1)) * kBld +
                              jh + 16 * jp + 8 * (lane >> 4));
              mma(part[0], af, bf[0], bf[1]);
              mma(part[1], af, bf[2], bf[3]);
            }
            add_parts(acc[2 * jp], acc[2 * jp + 1], part);
          }
        }
      }
      const float e0 = er[t0], e1 = er[t1];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        acc[nt][0] *= e0; acc[nt][1] *= e0;
        acc[nt][2] *= e1; acc[nt][3] *= e1;
      }
    }

    // (G o L) V over the key blocks s < 16 (rt + 1): G's accumulators are
    // the A operand's layout, weighted and split in registers
    const float ct0 = cl[t0], ct1 = cl[t1];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      if (ks > rt) continue;
      uint32_t af[3][4];               // G o L in three exact parts
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float* gt = G[2 * ks + half];
        const int s = 16 * ks + 8 * half + 2 * t4;
        const float cs0 = cl[s], cs1 = cl[s + 1];
        const float x[4] = {
            s <= t0 ? gt[0] * ex2((ct0 - cs0) * kLog2e) : 0.f,
            s + 1 <= t0 ? gt[1] * ex2((ct0 - cs1) * kLog2e) : 0.f,
            s <= t1 ? gt[2] * ex2((ct1 - cs0) * kLog2e) : 0.f,
            s + 1 <= t1 ? gt[3] * ex2((ct1 - cs1) * kLog2e) : 0.f};
        bf16 p[3][4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split3(x[e], p[0][e], p[1][e], p[2][e]);
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          af[q][2 * half] = pack(p[q][0], p[q][1]);       // row t0
          af[q][2 * half + 1] = pack(p[q][2], p[q][3]);   // row t1
        }
      }
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        float part[2][4] = {};
#pragma unroll
        for (int q = 0; q < kPV; ++q) {
          uint32_t bf[4];
          ldsm4_t(bf, vp + q * kC * kBld +
                          (16 * ks + (lane & 7) + 8 * ((lane >> 3) & 1)) *
                              kBld +
                          jh + 16 * jp + 8 * (lane >> 4));
#pragma unroll
          for (int p = 0; p + q <= 2; ++p) {
            mma(part[0], af[p], bf[0], bf[1]);
            mma(part[1], af[p], bf[2], bf[3]);
          }
        }
        add_parts(acc[2 * jp], acc[2 * jp + 1], part);
      }
    }

    TV* yh = y + h * a.y_sh;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int j = cb * kBw + jh + 8 * nt + 2 * t4;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const long long pos = c0 + (rr ? t1 : t0);
        if (pos >= a.S || j >= a.hd) continue;
        TV* yp = yh + pos * a.y_ss + j;
        if (j + 1 < a.hd && a.vec_y)      // both columns in one store
          store2(yp, acc[nt][2 * rr], acc[nt][2 * rr + 1]);
        else {
          yp[0] = from_f32<TV>(acc[nt][2 * rr]);
          if (j + 1 < a.hd) yp[1] = from_f32<TV>(acc[nt][2 * rr + 1]);
        }
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

template <int kD, typename TR, typename TV>
int launch(const Args& a, int B, cudaStream_t stream) {
  const size_t s1 = states_smem<kD, TR, TV>(), s3 = output_smem<kD, TR, TV>();
  cudaError_t err = cudaFuncSetAttribute(
      mamba2_ssd_states<kD, TR, TV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(s1));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(mamba2_ssd_output<kD, TR, TV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(s3));
  if (err != cudaSuccess) return static_cast<int>(err);
  mamba2_ssd_states<kD, TR, TV>
      <<<dim3(a.nC, (a.H + a.hg1 - 1) / a.hg1, B), states_threads(kD), s1,
         stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n4 = (long long)a.H * kD * kD / 4;
  err = launch_after(
      mamba2_ssd_pass,
      dim3((unsigned)((n4 + kPassThreads - 1) / kPassThreads), B),
      kPassThreads, 0, stream, a, kD);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_after(
      mamba2_ssd_output<kD, TR, TV>, dim3(a.nC, (a.H + a.hg - 1) / a.hg, B),
      kOutThreads, s3, stream, a));
}

template <int kD, typename TR>
int launch(const Args& a, int B, int v_dtype, cudaStream_t stream) {
  if (v_dtype == kF32) return launch<kD, TR, float>(a, B, stream);
  if (v_dtype == kBF16) return launch<kD, TR, bf16>(a, B, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int kD>
int launch(const Args& a, int B, int rk_dtype, int v_dtype,
           cudaStream_t stream) {
  if (rk_dtype == kBF16) return launch<kD, bf16>(a, B, v_dtype, stream);
  if (rk_dtype == kF32) return launch<kD, float>(a, B, v_dtype, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

int mamba2_scan_forward(const void* r, const void* k, const void* v,
                        const float* lw, void* y, float* state,
                        void* scratch, long long scratch_bytes,
                        long long r_sb, long long r_ss,
                        long long r_sh, long long k_sb, long long k_ss,
                        long long k_sh, long long v_sb, long long v_ss,
                        long long v_sh, long long w_sb, long long w_ss,
                        long long w_sh, long long y_sb, long long y_ss,
                        long long y_sh, int B, int S, int H, int N, int hd,
                        int rk_dtype, int v_dtype, void* stream) {
  // scratch: float32 (B, nC, H, D, D) chunk states, then (B, nC, H) decays,
  // with nC = ceil(S / 64) and D = 64, or 128 when N or hd is above 64
  const int D = (N > 64 || hd > 64) ? 128 : 64;
  const int nC = (S + kC - 1) / kC;
  if (B < 1 || S < 1 || H < 1 || N < 1 || hd < 1 || N > kMaxD ||
      hd > kMaxD || B > 65535 || H > 65535 ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0 ||
      scratch_bytes < (long long)B * nC * H * (D * D + 1) * 4)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.r = r; a.k = k; a.v = v; a.lw = lw; a.y = y; a.state = state;
  a.nC = nC;
  a.ds = static_cast<float*>(scratch);
  a.decay = a.ds + (long long)B * a.nC * H * D * D;
  a.r_sb = r_sb; a.r_ss = r_ss; a.r_sh = r_sh;
  a.k_sb = k_sb; a.k_ss = k_ss; a.k_sh = k_sh;
  a.v_sb = v_sb; a.v_ss = v_ss; a.v_sh = v_sh;
  a.w_sb = w_sb; a.w_ss = w_ss; a.w_sh = w_sh;
  a.y_sb = y_sb; a.y_ss = y_ss; a.y_sh = y_sh;
  a.S = S; a.H = H; a.N = N; a.hd = hd;
  // a group shares R, K and G only when they are the same for its heads
  a.hg = (r_sh == 0 && k_sh == 0) ? min(kHeadGroup, H) : 1;
  a.hg1 = k_sh == 0 ? min(kStateGroup, H) : 1;
  const size_t rk_el = rk_dtype == kBF16 ? 2 : 4;
  const size_t v_el = v_dtype == kBF16 ? 2 : 4;
  a.vec_rk = rk_dtype == kBF16 && N % 8 == 0 &&
             aligned16(r, r_sb, r_ss, r_sh, rk_el) &&
             aligned16(k, k_sb, k_ss, k_sh, rk_el);
  a.vec_v = (hd * v_el) % 16 == 0 && aligned16(v, v_sb, v_ss, v_sh, v_el);
  a.vec_y = reinterpret_cast<uintptr_t>(y) % (2 * v_el) == 0 &&
            y_sb % 2 == 0 && y_ss % 2 == 0 && y_sh % 2 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch<64>(a, B, rk_dtype, v_dtype, s);
  return launch<128>(a, B, rk_dtype, v_dtype, s);
}

const char* mamba2_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
