// RWKV6 (Finch) chunked WKV scan for Hopper (sm_90a).
//
// Replaces the TPU kernel in src/repro/kernels/rwkv6_scan.py:
//   rwkv6_scan  (_rwkv_kernel at :22, wrapper at :70, pallas_call at :87)
//
// What it computes, per batch row b and head h, from a zero (Dk, Dv) state:
//   y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T),
//   S_t = diag(exp(log_w_t)) S_{t-1} + k_t v_t^T,
// for r, k, log_w (B, S, H, Dk), v (B, S, H, Dv) and u (H, Dk); y (B, S, H,
// Dv) in v's dtype and the final state (B, H, Dk, Dv) float32.  It runs the
// chunked form of models/linear_scan.py over 64-position chunks in float32:
// with cl the running sum of log_w inside the chunk and e = cl - log_w,
//   y       = (r * exp(e)) S + A v,
//   A[t, s] = sum_d r_t k_s exp(e_t - cl_s) for s < t,
//   A[t, t] = sum_d r_t u k_t,
//   S      <- exp(cl_last) * S + (k * exp(cl_last - cl))^T v.
// exp(e_t - cl_s) is the exponential of the difference, which is <= 0 for
// s < t; it is never factored into exp(e_t) * exp(-cl_s), which overflows at
// strong decays.  Entries with s >= t are never computed (the TPU kernel
// computes and masks them, and its exponential there can be inf).
//
// Bound on the H100, at the serving path's largest prefill (B 1, S 512, H 64,
// Dk = Dv = 64, r/k/v bf16): the inputs and outputs are 26 MB, 7.8 us at
// 3.35 TB/s; the chunked arithmetic is about 0.94 GFLOP, 14 us at the 67
// TFLOP/s float32 rate: operations bound.  Half of it is the intra-chunk
// weights, one exponential per (t, s < t, d) term.  The design:
//   * one CTA of 8 warps per (b, h, 32-column slice of v).  It walks the
//     chunks in order (the loop takes the place of the TPU's sequential
//     grid axis) and keeps its (Dk, 32) slice of the state in shared memory
//     for the whole walk.  Columns of the state are independent, so the
//     split puts 128 CTAs on the card for one prefill at Dv = 64 instead of
//     64; each slice recomputes the chunk's A;
//   * r, k, v, log_w and y are read and written in their (B, S, H, D)
//     layouts through strides: no moveaxis and no padding copy.  Positions
//     past S load as zeros (log_w 0 and k 0 leave the state unchanged, as
//     the TPU kernel's padding does);
//   * every load is unconditional, from a clamped address, with the zero a
//     select after it, so no load waits on a branch; the next chunk's loads
//     are issued after A and stored at the end of the chunk;
//   * a thread loads 16 consecutive positions of one channel, so the
//     running sum of log_w is taken in registers, with the sums of the four
//     row quarters passed through shared memory;
//   * A is computed in 4x4 register tiles: the 120 tiles strictly below the
//     diagonal tiles each by two threads over one half of the channels (two
//     partial A buffers that the y phase adds), so all eight warps share
//     the work; the 16 diagonal tiles and the u diagonal by the last 16
//     threads.  Each exponential is one MUFU.EX2 (see exp_ftz);
//   * y and the state update run in 2x4 register tiles; each warp takes
//     row pairs from both ends of the chunk, so the A v loops even out;
//   * the (position, channel) tiles have an odd row stride, Dk | 1, so the
//     column reads of A's tiles are free of bank conflicts.
// Head dims up to 128; any r/k/v dtype of float32 or bfloat16, log_w and u
// float32.
//
// Known limits, later work: CUDA cores only (the inter-chunk read, A v and
// the state update are products a tensor-core kernel would take); A runs at
// about twice the MUFU's rate bound; the next chunk's loads overlap only
// part of the chunk (a barrier waits for loads still in flight, so staging
// through cp.async into spare shared memory is the way to hide them); A is
// recomputed per Dv slice, which only adds work once B * H fills the card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kC = 64;                 // positions per chunk
constexpr int kVs = 32;                // value columns per CTA
constexpr int kMaxD = 128;
constexpr int kLdA = kC + 1;           // row stride of A
constexpr int kLanes = 64;             // channels a load pass covers
constexpr int kRowsPer = kC / (kThreads / kLanes);   // 16 rows per thread
constexpr int kOffTiles = 120;         // 4x4 tiles strictly below A's diagonal
constexpr int kDiag0 = 2 * kOffTiles;  // first thread of the diagonal tiles
constexpr int kPerV = kC * kVs / kThreads;

static_assert(kThreads == 8 * (kC / 2), "y tiles: 32 row pairs x 8 quads");
static_assert(kDiag0 + kC / 4 == kThreads, "A: two channel halves per "
              "off-diagonal tile, one thread per diagonal tile");

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

// e^x as one MUFU.EX2: ex2.approx.ftz of x log2(e), relative error about
// 2^-22.  Without -ftz, expf and __expf wrap each exponential in a denormal
// fix-up (a compare and two predicated multiplies on one predicate
// register), which serialises a tile's sixteen independent exponentials at
// the MUFU's latency.  Results below 2^-126 flush to 0 here; the terms they
// scale are negligible beside the sums they join.
__device__ __forceinline__ float exp_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

struct Args {
  const void* r;       // (B, S, H, Dk)
  const void* k;       // (B, S, H, Dk)
  const void* v;       // (B, S, H, Dv)
  const float* lw;     // (B, S, H, Dk), <= 0
  const float* u;      // (H, Dk) contiguous
  void* y;             // (B, S, H, Dv), v's dtype
  float* state;        // (B, H, Dk, Dv) contiguous
  long long r_sb, r_ss, r_sh;  // element strides (batch, position, head)
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long w_sb, w_ss, w_sh;
  long long y_sb, y_ss, y_sh;
  int S, H, Dk, Dv;
};

inline size_t smem_floats(int Dk) {
  const int dks = Dk | 1;
  return (size_t)4 * kC * dks + (size_t)2 * kC * kLdA + (size_t)kC * kVs +
         (size_t)Dk * kVs + Dk + (size_t)(kThreads / kLanes) * kMaxD;
}

// kDj: channel passes of kLanes (1 for Dk <= 64, 2 up to 128)
template <typename T, int kDj>
__global__ void __launch_bounds__(kThreads)
    rwkv6_scan_kernel(const Args a) {
  extern __shared__ __align__(16) float sm[];
  const int Dk = a.Dk, dks = a.Dk | 1, S = a.S;
  float* rs = sm;                  // (kC, dks): r, then r * exp(e)
  float* ks = rs + kC * dks;       // (kC, dks): k
  float* cs = ks + kC * dks;       // (kC, dks): cl
  float* es = cs + kC * dks;       // (kC, dks): e, then k * exp(cl_last - cl)
  float* As = es + kC * dks;       // (kC, kLdA): A over channels [0, Dk/2)
  float* A2 = As + kC * kLdA;      // (kC, kLdA): A over [Dk/2, Dk)
  float* vs = A2 + kC * kLdA;      // (kC, kVs): this CTA's columns of v
  float* Ss = vs + kC * kVs;       // (Dk, kVs): its columns of the state
  float* us = Ss + Dk * kVs;       // (Dk,): u of this head
  float* tot = us + Dk;            // (4, kMaxD): log_w sums of row quarters

  const int tid = threadIdx.x;
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int j0 = blockIdx.y * kVs;
  const int nv = min(kVs, a.Dv - j0);          // live columns of the slice
  const T* r = static_cast<const T*>(a.r) + b * a.r_sb + h * a.r_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh + j0;
  const float* lw = a.lw + b * a.w_sb + h * a.w_sh;
  T* y = static_cast<T*>(a.y) + b * a.y_sb + h * a.y_sh + j0;

  for (int i = tid; i < Dk * kVs; i += kThreads) Ss[i] = 0.f;
  for (int i = tid; i < Dk; i += kThreads) us[i] = __ldg(a.u + h * Dk + i);

  // Loads: thread (quarter q, lane dl) holds rows 16 q .. 16 q + 15 of
  // channels dl + 64 j, so it can scan its rows of log_w in registers.
  // issue() only loads, each from a clamped address with no branch; the
  // conversions and the zeros past S wait for commit().
  const int q = tid / kLanes, dl = tid % kLanes;
  T rr[kDj][kRowsPer], kk[kDj][kRowsPer], vv[kPerV];
  float ww[kDj][kRowsPer];
  auto issue = [&](long long c0) {
#pragma unroll
    for (int i = 0; i < kPerV; ++i) {
      const int idx = i * kThreads + tid, t = idx / kVs, j = idx % kVs;
      const long long tc = min(c0 + t, (long long)S - 1);
      vv[i] = __ldg(v + tc * a.v_ss + min(j, nv - 1));
    }
#pragma unroll
    for (int jd = 0; jd < kDj; ++jd)
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i) {
        const long long tc = min(c0 + q * kRowsPer + i, (long long)S - 1);
        const int dc = min(dl + jd * kLanes, Dk - 1);
        rr[jd][i] = __ldg(r + tc * a.r_ss + dc);
        kk[jd][i] = __ldg(k + tc * a.k_ss + dc);
        ww[jd][i] = __ldg(lw + tc * a.w_ss + dc);
      }
  };
  // Store the chunk at c0 (zeros past S); cl = running sum of log_w and
  // e = cl - log_w.  Ends with the chunk in shared memory behind a barrier.
  auto commit = [&](long long c0) {
#pragma unroll
    for (int i = 0; i < kPerV; ++i) {
      const int idx = i * kThreads + tid, t = idx / kVs, j = idx % kVs;
      vs[idx] = (c0 + t < S && j < nv) ? to_f32(vv[i]) : 0.f;
    }
#pragma unroll
    for (int jd = 0; jd < kDj; ++jd) {
      const int d = dl + jd * kLanes;
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i) {
        const bool ok = c0 + q * kRowsPer + i < S && d < Dk;
        ww[jd][i] = ok ? ww[jd][i] : 0.f;
        acc += ww[jd][i];
      }
      if (d < Dk) {
        tot[q * kMaxD + d] = acc;
#pragma unroll
        for (int i = 0; i < kRowsPer; ++i) {
          const bool ok = c0 + q * kRowsPer + i < S;
          const int o = (q * kRowsPer + i) * dks + d;
          rs[o] = ok ? to_f32(rr[jd][i]) : 0.f;
          ks[o] = ok ? to_f32(kk[jd][i]) : 0.f;
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int jd = 0; jd < kDj; ++jd) {
      const int d = dl + jd * kLanes;
      if (d >= Dk) continue;
      float cl = 0.f;                // the sums of the quarters before
      for (int p = 0; p < q; ++p) cl += tot[p * kMaxD + d];
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i) {
        const int o = (q * kRowsPer + i) * dks + d;
        cl += ww[jd][i];
        cs[o] = cl;
        es[o] = cl - ww[jd][i];
      }
    }
    __syncthreads();
  };

  // this thread's 4x4 tile (ti, si < ti) of A and channel half, for
  // tid < kDiag0
  const int half = tid / kOffTiles;
  int ti = 1, si = tid % kOffTiles;
  while (si >= ti) si -= ti++;
  // its 2x4 tile of y and of the state update: a pair of rows (channels)
  // from each end of the chunk per warp, so the A v loops even out
  const int pr = tid >> 3, jq = 4 * (tid & 7);
  const int yt0 = 2 * ((pr & 1) ? (kC / 2 - 1 - (pr >> 1)) : (pr >> 1));
  const int st0 = 2 * pr;
  const int n_chunks = (S + kC - 1) / kC;

  issue(0);
  commit(0);
  for (int ci = 0; ci < n_chunks; ++ci) {
    const long long c0 = (long long)ci * kC;

    // 1. intra-chunk weights: the strictly lower 4x4 tiles, each as two
    //    halves of the channels in two threads (all eight warps busy), and
    //    the diagonal tiles with the u diagonal
    if (tid < kDiag0) {
      const int t0 = 4 * ti, s0 = 4 * si;
      const int d_lo = half ? Dk / 2 : 0, d_hi = half ? Dk : Dk / 2;
      float acc[4][4] = {};
#pragma unroll 2
      for (int d = d_lo; d < d_hi; ++d) {
        float rv[4], ev[4], kv[4], cv[4];
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          rv[x] = rs[(t0 + x) * dks + d];
          ev[x] = es[(t0 + x) * dks + d];
          kv[x] = ks[(s0 + x) * dks + d];
          cv[x] = cs[(s0 + x) * dks + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] += rv[i] * kv[j] * exp_ftz(ev[i] - cv[j]);
      }
      float* Ah = half ? A2 : As;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) Ah[(t0 + i) * kLdA + s0 + j] = acc[i][j];
    } else {
      const int t0 = 4 * (tid - kDiag0);
      float acc[4][4] = {};            // [i][j]: j < i, and j = i for u
      for (int d = 0; d < Dk; ++d) {
        float rv[4], ev[4], kv[4], cv[4];
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          rv[x] = rs[(t0 + x) * dks + d];
          ev[x] = es[(t0 + x) * dks + d];
          kv[x] = ks[(t0 + x) * dks + d];
          cv[x] = cs[(t0 + x) * dks + d];
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
        for (int j = 0; j < 4; ++j) {
          As[(t0 + i) * kLdA + t0 + j] = j <= i ? acc[i][j] : 0.f;
          A2[(t0 + i) * kLdA + t0 + j] = 0.f;
        }
    }
    __syncthreads();

    // the next chunk's loads, landing while phases 2-4 compute
    if (ci + 1 < n_chunks) issue(c0 + kC);

    // 2. r <- r * exp(e) (the decayed read of the state); e <- the keys
    //    decayed to the chunk's end, k * exp(cl_last - cl)
#pragma unroll
    for (int jd = 0; jd < kDj; ++jd) {
      const int d = dl + jd * kLanes;
      if (d >= Dk) continue;
      const float cl_last = cs[(kC - 1) * dks + d];
      for (int i = 0; i < kRowsPer; ++i) {
        const int o = (q * kRowsPer + i) * dks + d;
        rs[o] *= exp_ftz(es[o]);
        es[o] = ks[o] * exp_ftz(cl_last - cs[o]);
      }
    }
    __syncthreads();

    // 3. y = (r * exp(e)) S + A v for rows yt0, yt0 + 1
    {
      float acc[2][4] = {};
#pragma unroll 4
      for (int d = 0; d < Dk; ++d) {
        const float4 s4 = *reinterpret_cast<const float4*>(Ss + d * kVs + jq);
        const float r0 = rs[yt0 * dks + d], r1 = rs[(yt0 + 1) * dks + d];
        acc[0][0] += r0 * s4.x; acc[0][1] += r0 * s4.y;
        acc[0][2] += r0 * s4.z; acc[0][3] += r0 * s4.w;
        acc[1][0] += r1 * s4.x; acc[1][1] += r1 * s4.y;
        acc[1][2] += r1 * s4.z; acc[1][3] += r1 * s4.w;
      }
      // A[yt0, yt0 + 1] is 0: both rows lie in one diagonal tile of A
#pragma unroll 4
      for (int s = 0; s <= yt0 + 1; ++s) {
        const float4 v4 = *reinterpret_cast<const float4*>(vs + s * kVs + jq);
        const float a0 = As[yt0 * kLdA + s] + A2[yt0 * kLdA + s];
        const float a1 = As[(yt0 + 1) * kLdA + s] + A2[(yt0 + 1) * kLdA + s];
        acc[0][0] += a0 * v4.x; acc[0][1] += a0 * v4.y;
        acc[0][2] += a0 * v4.z; acc[0][3] += a0 * v4.w;
        acc[1][0] += a1 * v4.x; acc[1][1] += a1 * v4.y;
        acc[1][2] += a1 * v4.z; acc[1][3] += a1 * v4.w;
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const long long pos = c0 + yt0 + i;
        if (pos >= S) break;
#pragma unroll
        for (int x = 0; x < 4; ++x)
          if (jq + x < nv) y[pos * a.y_ss + jq + x] = from_f32<T>(acc[i][x]);
      }
    }
    __syncthreads();   // every read of the state precedes its update

    // 4. S <- exp(cl_last) * S + (k * exp(cl_last - cl))^T v, channel pairs
    for (int d0 = st0; d0 < Dk; d0 += kC) {
      const int d1 = min(d0 + 1, Dk - 1);   // a lone last channel repeats
      const float f0 = exp_ftz(cs[(kC - 1) * dks + d0]);
      const float f1 = exp_ftz(cs[(kC - 1) * dks + d1]);
      const float4 p0 = *reinterpret_cast<const float4*>(Ss + d0 * kVs + jq);
      const float4 p1 = *reinterpret_cast<const float4*>(Ss + d1 * kVs + jq);
      float acc[2][4] = {{f0 * p0.x, f0 * p0.y, f0 * p0.z, f0 * p0.w},
                         {f1 * p1.x, f1 * p1.y, f1 * p1.z, f1 * p1.w}};
#pragma unroll 4
      for (int s = 0; s < kC; ++s) {
        const float4 v4 = *reinterpret_cast<const float4*>(vs + s * kVs + jq);
        const float k0 = es[s * dks + d0], k1 = es[s * dks + d1];
        acc[0][0] += k0 * v4.x; acc[0][1] += k0 * v4.y;
        acc[0][2] += k0 * v4.z; acc[0][3] += k0 * v4.w;
        acc[1][0] += k1 * v4.x; acc[1][1] += k1 * v4.y;
        acc[1][2] += k1 * v4.z; acc[1][3] += k1 * v4.w;
      }
      *reinterpret_cast<float4*>(Ss + d0 * kVs + jq) =
          make_float4(acc[0][0], acc[0][1], acc[0][2], acc[0][3]);
      if (d1 != d0)
        *reinterpret_cast<float4*>(Ss + d1 * kVs + jq) =
            make_float4(acc[1][0], acc[1][1], acc[1][2], acc[1][3]);
    }
    __syncthreads();   // the next chunk's stores overwrite this one's tiles

    if (ci + 1 < n_chunks) commit(c0 + kC);
  }

  float* st = a.state + ((long long)b * a.H + h) * Dk * a.Dv + j0;
  for (int i = tid; i < Dk * kVs; i += kThreads) {
    const int d = i / kVs, j = i % kVs;
    if (j < nv) st[(long long)d * a.Dv + j] = Ss[i];
  }
}

// dtype codes shared with the Python wrapper
enum { kF32 = 0, kBF16 = 1 };

template <typename T, int kDj>
int launch(const Args& a, int B, cudaStream_t stream) {
  const size_t bytes = smem_floats(a.Dk) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      rwkv6_scan_kernel<T, kDj>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * a.H, (a.Dv + kVs - 1) / kVs), block(kThreads);
  rwkv6_scan_kernel<T, kDj><<<grid, block, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const Args& a, int B, cudaStream_t stream) {
  return a.Dk <= kLanes ? launch<T, 1>(a, B, stream)
                        : launch<T, 2>(a, B, stream);
}

}  // namespace

extern "C" {

int rwkv6_scan_forward(const void* r, const void* k, const void* v,
                       const float* lw, const float* u, void* y,
                       float* state, long long r_sb, long long r_ss,
                       long long r_sh, long long k_sb, long long k_ss,
                       long long k_sh, long long v_sb, long long v_ss,
                       long long v_sh, long long w_sb, long long w_ss,
                       long long w_sh, long long y_sb, long long y_ss,
                       long long y_sh, int B, int S, int H, int Dk, int Dv,
                       int dtype, void* stream) {
  if (B < 1 || S < 1 || H < 1 || Dk < 1 || Dv < 1 || Dk > kMaxD ||
      Dv > kMaxD || (long long)B * H > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{r, k, v, lw, u, y, state, r_sb, r_ss, r_sh, k_sb, k_ss, k_sh,
         v_sb, v_ss, v_sh, w_sb, w_ss, w_sh, y_sb, y_ss, y_sh, S, H, Dk, Dv};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) return launch<bf16>(a, B, s);
  if (dtype == kF32) return launch<float>(a, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* rwkv6_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
